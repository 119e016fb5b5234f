"""The assigned input shapes and the dry run's input stand-ins (twin of
``repro/launch/shapes.py``).

Every (arch x shape) cell resolves here to a step kind and its inputs as
meta tensors, which hold no storage: ``decode_*`` and ``long_*`` run the
serve step (one new token against a ``seq_len`` cache), ``prefill_32k`` the
prefill step, ``train_4k`` the train step.  ``long_500k`` needs a
sub-quadratic decode: a model with full attention is skipped (``SKIP``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.runtime.serve import decode_state_struct

SKIP = "skip"


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_status(cfg: ArchConfig, shape: str) -> str:
    """``"ok"``, or ``SKIP`` for ``long_500k`` on a model with full
    attention."""
    if SHAPES[shape].name == "long_500k" and not cfg.is_subquadratic:
        return SKIP
    return "ok"


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: str, *,
                dtype=torch.bfloat16) -> dict:
    """Meta-tensor stand-ins for every model input of the cell:

    train   -> {"batch": {...}}
    prefill -> {"batch": {...}}  (no labels)
    decode  -> {"state": meta DecodeState, "token": (B,) int32}
    """
    spec = SHAPES[shape]
    B, S = spec.global_batch, spec.seq_len
    if spec.kind in ("train", "prefill"):
        batch = {k: _meta(*v) for k, v in make_batch_specs(cfg, S, B).items()}
        if spec.kind == "prefill":
            batch.pop("labels", None)
        return {"batch": batch}
    return {"state": decode_state_struct(cfg, B, S, dtype),
            "token": _meta((B,), torch.int32)}
