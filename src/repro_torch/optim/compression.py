"""Int8 gradient compression with error feedback (twin of
``repro/optim/compression.py``): each block of 256 elements quantized to
int8 with its own float32 scale, the quantization residual kept to be added
back next step.

The reference's ``compressed_psum`` (the quantize -> all-reduce ->
dequantize round trip over a data-parallel mesh axis) is not imitated: one
card has no data-parallel axis to reduce over."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_BLOCK = 256  # elements per scale block


def compress_int8(g: torch.Tensor, err: Optional[torch.Tensor] = None):
    """Quantize ``g (+ err)`` to int8 blocks.  Returns (q int8 (nblocks,
    BLOCK), scales float32 (nblocks, 1), new_err of g's shape: the residual
    to feed back next step)."""
    g32 = g.float()
    if err is not None:
        g32 = g32 + err
    n = g32.numel()
    blocks = F.pad(g32.reshape(-1), (0, (-n) % _BLOCK)).reshape(-1, _BLOCK)
    scale = (blocks.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    resid = (blocks - q.float() * scale).reshape(-1)[:n].reshape(g.shape)
    return q, scale, resid


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    return (q.float() * scale).reshape(-1)[:n].reshape(tuple(shape)).to(dtype)
