"""Deterministic, shardable synthetic LM data (twin of
``repro/data/pipeline.py``).

Every batch is a pure function of ``(seed, step, shard)``: the draws come
from a numpy ``Generator`` seeded by ``SeedSequence((seed, step, shard))``
on the host, so a restart recomputes any step's batch, and a restart with
another data-parallel degree re-partitions the stream by its shard indices.
The stream is the reference's in law, not in its bits (``jax.random``'s
stream has no numpy twin): a Zipf unigram over a 4096-symbol active set
with short-range repeats (each token a copy of the one 8 back with
probability ``markov_repeat``), so that the loss falls during a run.

The modality-stub architectures get their embeddings as the reference
draws them: musicgen's frame embeddings, paligemma's patch embeddings in
front of its tokens (normal x 0.02, float32).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2          # unigram skew
    markov_repeat: float = 0.35  # P(copy token from 8 positions back)


class SyntheticLM:
    """Stateless batch factory: ``batch(step, shard, num_shards)`` on
    ``device`` (default ``"cuda"``)."""

    def __init__(self, cfg: ArchConfig, data: DataConfig, *, device=None):
        self.cfg = cfg
        self.data = data
        self.device = resolve_device(device)
        active = min(cfg.vocab_size, 4096)
        probs = np.arange(1, active + 1, dtype=np.float64) ** -data.zipf_a
        self._probs = probs / probs.sum()

    def _tokens(self, rng: np.random.Generator, batch: int,
                seq: int) -> np.ndarray:
        base = rng.choice(len(self._probs), (batch, seq), p=self._probs)
        # short-range repeats give learnable structure
        copy = rng.random((batch, seq)) < self.data.markov_repeat
        toks = np.where(copy, np.roll(base, 8, axis=1), base)
        return toks.astype(np.int32)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def batch(self, step: int, shard: int = 0, num_shards: int = 1) -> dict:
        """One data-parallel shard's batch: int32 ``tokens`` and ``labels``
        (the next tokens), float32 ``embeddings`` or ``prefix_embeddings``
        for the stub architectures."""
        d, cfg = self.data, self.cfg
        if d.global_batch % num_shards:
            raise ValueError(f"global_batch {d.global_batch} not divisible "
                             f"by {num_shards} shards")
        b = d.global_batch // num_shards
        rng = np.random.default_rng(np.random.SeedSequence(
            (d.seed, step, shard)))
        S = d.seq_len
        out: dict = {}
        if cfg.input_mode == "tokens":
            toks = self._tokens(rng, b, S + 1)
            out["tokens"], out["labels"] = toks[:, :-1], toks[:, 1:]
        elif cfg.input_mode == "embeddings":
            out["embeddings"] = (rng.standard_normal(
                (b, S, cfg.d_model), dtype=np.float32) * 0.02)
            out["labels"] = self._tokens(rng, b, S)
        elif cfg.input_mode == "prefix_embeddings":
            out["prefix_embeddings"] = (rng.standard_normal(
                (b, cfg.prefix_len, cfg.d_model), dtype=np.float32) * 0.02)
            toks = self._tokens(rng, b, S - cfg.prefix_len + 1)
            out["tokens"], out["labels"] = toks[:, :-1], toks[:, 1:]
        else:
            raise ValueError(cfg.input_mode)
        return {k: self._tensor(v) for k, v in out.items()}


def make_batch_specs(cfg: ArchConfig, seq_len: int,
                     global_batch: int) -> dict:
    """(shape, dtype) of each member of one *global* training batch, the
    reference's dry-run contract without JAX's ``ShapeDtypeStruct``."""
    B, S = global_batch, seq_len
    if cfg.input_mode == "tokens":
        return {"tokens": ((B, S), torch.int32),
                "labels": ((B, S), torch.int32)}
    if cfg.input_mode == "embeddings":
        return {"embeddings": ((B, S, cfg.d_model), torch.float32),
                "labels": ((B, S), torch.int32)}
    if cfg.input_mode == "prefix_embeddings":
        s_text = S - cfg.prefix_len
        return {"prefix_embeddings": ((B, cfg.prefix_len, cfg.d_model),
                                      torch.float32),
                "tokens": ((B, s_text), torch.int32),
                "labels": ((B, s_text), torch.int32)}
    raise ValueError(cfg.input_mode)
