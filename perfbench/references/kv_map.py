"""The plain reference of an exact key-value map: after a sequence of
inserts, a lookup returns the value of the key's last insert and the MISS
pattern for a key never inserted.

It works every answer out again from the keys and values the benchmark
generated: one stable sort of the inserted keys, then a binary search per
probe.  Plain PyTorch on int64 (or NumPy-free) tensors; it imports nothing
of the program and takes nothing the program made.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
MISS_BITS = -1
#: probes answered per block
BLOCK = 1 << 24


class KVMap:
    """``keys``/``values``: (n,) int32 bit patterns in insert order."""

    def __init__(self, keys: torch.Tensor, values: torch.Tensor):
        k = keys.to(torch.int64) & MASK32
        self.keys, order = torch.sort(k, stable=True)
        self.values = values[order]

    def lookup(self, probes: torch.Tensor) -> torch.Tensor:
        """Answers (int32 bit patterns) for ``probes`` (int32 bit patterns),
        block by block.  Of equal keys the last inserted wins: the stable
        sort keeps insert order, and the search takes the rightmost."""
        out = torch.empty(probes.shape, dtype=torch.int32,
                          device=probes.device)
        n = self.keys.numel()
        for i in range(0, probes.numel(), BLOCK):
            p = probes[i:i + BLOCK].to(torch.int64) & MASK32
            if n == 0:
                out[i:i + BLOCK] = MISS_BITS
                continue
            pos = torch.searchsorted(self.keys, p, right=True) - 1
            safe = pos.clamp(min=0)
            hit = (pos >= 0) & (self.keys[safe] == p)
            out[i:i + BLOCK] = torch.where(hit, self.values[safe], MISS_BITS)
        return out
