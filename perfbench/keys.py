"""Keys and values of a run, made on the device from ``--seed``.

A copy of ``chip_smoke.make_keys``'s key generator: distinct uint32 keys as
MurmurHash3's finalizer (``fmix32``, a bijection on uint32) of a counter
that starts at a base drawn from the seed, never the EMPTY pattern.  Here
the arithmetic runs on int64 tensors, each 32-bit product split in 16-bit
halves so that nothing overflows, in blocks so that the temporaries stay
small.  Values are drawn below the MISS pattern by a ``torch.Generator`` on
the keys' device.  Keys and values are returned as int32 bit patterns.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
MISS = 0xFFFFFFFF
#: keys made per block (bounds the int64 temporaries to a few hundred MB)
BLOCK = 1 << 24


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in ``[0, 2**32)``."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & MASK32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's finalizer on int64 values in ``[0, 2**32)``."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def as_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` as int32 bit patterns."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def counter_base(seed: int) -> int:
    return (seed * 0x9E3779B9 + 0x7F4A7C15) & MASK32


def make_keys(n: int, seed: int, device) -> torch.Tensor:
    """``n`` distinct keys (int32 bit patterns) from ``seed``: fmix32 of the
    counter ``base, base + 1, ...`` (mod 2**32) with the one EMPTY pattern
    left out, as ``chip_smoke.make_keys`` orders them."""
    base = counter_base(seed)
    out = torch.empty(n, dtype=torch.int32, device=device)
    done, start = 0, 0
    while done < n:
        m = min(BLOCK, n - done + 1)
        ctr = (torch.arange(start, start + m, dtype=torch.int64,
                            device=device) + base) & MASK32
        k = fmix32(ctr)
        k = k[k != MISS][:n - done]
        out[done:done + k.numel()] = as_bits(k)
        done += k.numel()
        start += m
    return out


def make_values(n: int, seed: int, device) -> torch.Tensor:
    """``n`` values below the MISS pattern (int32 bit patterns)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed & (2 ** 63 - 1))
    out = torch.empty(n, dtype=torch.int32, device=device)
    for i in range(0, n, BLOCK):
        m = min(BLOCK, n - i)
        v = torch.randint(0, MISS, (m,), generator=g, dtype=torch.int64,
                          device=device)
        out[i:i + m] = as_bits(v)
    return out
