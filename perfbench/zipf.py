"""YCSB's ``ScrambledZipfianGenerator`` on the device.

github.com/brianfrankcooper/YCSB, ``core/.../generator/``: a
``ZipfianGenerator`` over ``ITEM_COUNT`` = 10^10 items with the zipfian
constant 0.99 and its precomputed ``ZETAN``, each rank then scrambled by
``Utils.fnvhash64`` modulo the item count.  ``rank`` follows
``ZipfianGenerator.nextLong``'s closed form (Gray et al., "Quickly
generating billion-record synthetic databases"); the 64-bit FNV arithmetic
runs on two 32-bit limbs held in int64 tensors, so it wraps as Java's
``long`` does without overflowing.  One departure: Java's
``Math.abs(Long.MIN_VALUE)`` stays negative and its ``%`` then yields a
negative item; here that hash (one in 2**64) maps to ``2**63 mod items``.
"""
from __future__ import annotations

import torch

ZIPFIAN_CONSTANT = 0.99
ITEM_COUNT = 10_000_000_000
ZETAN = 26.46902820178302          # zeta(ITEM_COUNT + 1, 0.99), from YCSB
FNV_OFFSET_BASIS_64 = 0xCBF29CE484222325
FNV_PRIME_LO = 0x1B3               # FNV_PRIME_64 = 2**40 + 0x1B3
MASK32 = 0xFFFFFFFF


class ZipfParams:
    """``ZipfianGenerator(0, items - 1, theta, zetan)``'s constants."""

    def __init__(self, items: int = ITEM_COUNT + 1,
                 theta: float = ZIPFIAN_CONSTANT, zetan: float = ZETAN):
        self.items = items
        self.theta = theta
        self.zetan = zetan
        self.alpha = 1.0 / (1.0 - theta)
        zeta2 = 1.0 + 0.5 ** theta
        self.half_pow = 0.5 ** theta
        self.eta = ((1.0 - (2.0 / items) ** (1.0 - theta))
                    / (1.0 - zeta2 / zetan))


def zipf_ranks(n: int, p: ZipfParams, generator, device) -> torch.Tensor:
    """``n`` ranks (int64) of ``ZipfianGenerator.nextValue()``."""
    u = torch.rand(n, generator=generator, dtype=torch.float64,
                   device=device)
    uz = u * p.zetan
    tail = torch.floor(p.items * torch.pow(p.eta * u - p.eta + 1.0, p.alpha))
    r = torch.where(uz < 1.0 + p.half_pow, 1.0, tail)
    r = torch.where(uz < 1.0, 0.0, r)
    return r.to(torch.int64)


def _mul_prime(hi: torch.Tensor, lo: torch.Tensor):
    """(hi, lo) * FNV_PRIME_64 mod 2**64, limbs in [0, 2**32)."""
    p = lo * FNV_PRIME_LO
    new_lo = p & MASK32
    new_hi = (hi * FNV_PRIME_LO + (p >> 32) + ((lo << 8) & MASK32)) & MASK32
    return new_hi, new_lo


def fnvhash64_mod(val: torch.Tensor, items: int) -> torch.Tensor:
    """``Utils.fnvhash64(val) % items`` for int64 ``val`` >= 0."""
    hi = torch.full_like(val, FNV_OFFSET_BASIS_64 >> 32)
    lo = torch.full_like(val, FNV_OFFSET_BASIS_64 & MASK32)
    v = val
    for _ in range(8):
        lo = lo ^ (v & 0xFF)
        v = v >> 8
        hi, lo = _mul_prime(hi, lo)
    # Math.abs: a negative long (top bit set) is negated in two's complement
    neg = hi >= 1 << 31
    nlo = (-lo) & MASK32
    nhi = ((hi ^ MASK32) + (lo == 0).to(torch.int64)) & MASK32
    hi = torch.where(neg, nhi, hi)
    lo = torch.where(neg, nlo, lo)
    return ((hi % items) * ((1 << 32) % items) + lo) % items


def scrambled_zipfian(n: int, items: int, generator, device,
                      p: ZipfParams | None = None) -> torch.Tensor:
    """``n`` draws of ``ScrambledZipfianGenerator(0, items - 1)`` (int64
    item numbers in ``[0, items)``)."""
    p = p or ZipfParams()
    return fnvhash64_mod(zipf_ranks(n, p, generator, device), items)
