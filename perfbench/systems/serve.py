"""The served model: ``repro_torch``'s serving runtime
(``runtime/serve.py``) on the shortcut KV route.  ``make_prefill_step``
prefills a batch and lays its caches out as the per-sequence view of
``s_cap`` positions; ``make_serve_step`` decodes one greedy token a
sequence over that view, writing the new rows and the SSM state in place.

``build(config, device)`` returns a :class:`Server`; ``load(weights,
traffic)`` hands it the benchmark's weights as they are (the program's own
layout) and makes the decode step; a prefill step is made for each view
length the traffic asks for, at the traffic's dtype.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.runtime import serve as rt

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def arch(config: dict) -> ArchConfig:
    """The program's configuration of ``config["model"]``."""
    m = dict(config["model"])
    m["global_layers"] = tuple(m.get("global_layers", ()))
    names = {f.name for f in dataclasses.fields(ArchConfig)}
    unknown = set(m) - names
    if unknown:
        raise KeyError(f"model keys the program does not take: {unknown}")
    return ArchConfig(**m)


class Server:
    def __init__(self, config: dict, device):
        self.cfg = arch(config)
        self.device = device
        self.params = None

    def load(self, weights: dict, traffic: dict) -> None:
        self.params = weights
        self.dtype = DTYPES[traffic["dtype"]]
        self._prefill = {}
        self._step = rt.make_serve_step(self.cfg)

    def prefill(self, tokens: torch.Tensor, s_cap: int):
        """(B, S) prompts -> (the first greedy token (B,) int32, the decode
        state, a view of ``s_cap`` positions a sequence)."""
        if s_cap not in self._prefill:
            self._prefill[s_cap] = rt.make_prefill_step(self.cfg, s_cap,
                                                        self.dtype)
        logits, state = self._prefill[s_cap](self.params, {"tokens": tokens})
        return torch.argmax(logits, dim=-1).to(torch.int32), state

    def step(self, state, token: torch.Tensor):
        """One greedy token a sequence: (next token (B,) int32, state)."""
        return self._step(self.params, state, token)

    def close(self) -> None:
        self.params = None


def build(config: dict, device) -> Server:
    return Server(config, device)
