"""Hashing and probing primitives of the port (twin of ``repro/core/hashing.py``).

The same pair of multiplicative hashes on uint32 (Knuth's golden-ratio
constants) and the same *first-empty-slot-terminates* linear probe.  The
CUDA kernels carry their own copy of the constants in
``kernels/csrc/common.cuh``; the tests hold both to the JAX package.

Representation.  PyTorch's ``uint32`` supports little more than copies,
views and ``==`` (no ``>>``, ``%``, ``argmax``, ``index_select`` or
``index_put`` on the CPU), so:

  * stored uint32 data (keys, values, bucket pages) keeps dtype
    ``torch.uint32`` at the public boundary, and every operation on it
    runs on its int32 *bit view* (:func:`bits`, EMPTY is ``-1`` there);
  * hash arithmetic runs on int64 holding values in ``[0, 2**32)``
    (:func:`u32`), with every product kept under ``2**63``.
"""
from __future__ import annotations

import numpy as np
import torch

HASH_C1: int = 2654435761          # Knuth multiplicative (directory hash)
HASH_C2: int = 0x9E3779B1          # golden-ratio variant (bucket-slot hash)
EMPTY_SENTINEL: int = 0xFFFFFFFF   # slot unused
MISS_SENTINEL: int = 0xFFFFFFFF    # lookup miss marker
MASK32: int = 0xFFFFFFFF
#: EMPTY_SENTINEL and MISS_SENTINEL as int32 bit patterns
EMPTY_BITS: int = -1
MISS_BITS: int = -1


# -- representation ------------------------------------------------------------

def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (two's complement)."""
    return (((x + (1 << 31)) & MASK32) - (1 << 31)).to(torch.int32)


def bits(x, device=None) -> torch.Tensor:
    """uint32 values ``x`` (tensor, numpy array or ints) as an int32 tensor
    of the same bit pattern; int64 input is taken modulo ``2**32``."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            t = x.view(torch.int32)
        elif x.dtype == torch.int32:
            t = x
        else:
            t = _wrap_i32(x.to(torch.int64))
    else:
        a = np.asarray(x)
        if a.dtype != np.uint32:
            a = a.astype(np.int64).astype(np.uint32)
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
    return t if device is None else t.to(device)


def from_bits(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns back to ``torch.uint32`` (a view, no copy)."""
    return t.view(torch.uint32)


def u32(x) -> torch.Tensor:
    """uint32 values ``x`` as int64 in ``[0, 2**32)`` for arithmetic."""
    return bits(x).to(torch.int64) & MASK32


_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
           torch.uint64: torch.int64}


def storage_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` viewed with a dtype PyTorch can gather, scatter and clone on
    every device (unsigned types as the signed type of their width)."""
    signed = _SIGNED.get(t.dtype)
    return t if signed is None else t.view(signed)


def clone(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` in its own dtype."""
    return storage_view(t).clone().view(t.dtype)


def full(shape, fill: int, dtype, device) -> torch.Tensor:
    """``torch.full`` that also takes the unsigned dtypes (``fill`` given
    as the unsigned value)."""
    signed = _SIGNED.get(dtype)
    if signed is None:
        return torch.full(shape, fill, dtype=dtype, device=device)
    width = torch.iinfo(signed).bits
    pattern = fill - (1 << width) if fill >= 1 << (width - 1) else fill
    return torch.full(shape, pattern, dtype=signed, device=device).view(dtype)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in ``[0, 2**32)``: the constant is
    split into 16-bit halves so that no product reaches ``2**63``."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


# -- hashes --------------------------------------------------------------------

def hash_dir(key) -> torch.Tensor:
    """Primary multiplicative hash; directories use its most significant
    bits (the precondition for contiguous fan-in ranges)."""
    return _mul32(u32(key), HASH_C1)


def hash_bucket(key) -> torch.Tensor:
    """Secondary hash for the slot within a bucket page."""
    k = _mul32(u32(key), HASH_C2)
    return k ^ (k >> 16)


def shard_of_keys(keys, shard_bits: int) -> torch.Tensor:
    """Shard index per key (int64, on the keys' device): the top
    ``shard_bits`` of the directory hash (0 bits: shard 0)."""
    k = bits(keys)
    if shard_bits == 0:
        return torch.zeros(k.shape, dtype=torch.int64, device=k.device)
    return hash_dir(k) >> (32 - shard_bits)


def hash_dir_host(key: int) -> int:
    """Host-side twin of :func:`hash_dir` on a Python int."""
    return (int(key) * HASH_C1) & MASK32


def hash_bucket_host(key: int) -> int:
    """Host-side twin of :func:`hash_bucket` on a Python int."""
    k = (int(key) * HASH_C2) & MASK32
    return k ^ (k >> 16)


def dir_slot(h: torch.Tensor, depth) -> torch.Tensor:
    """Most-significant-bit slot of hash ``h`` in a table of ``2**depth``
    entries; depth 0 => slot 0 (a uint32 shift by 32 is undefined, so the
    kernels guard it and so does this).  int32, wrapping like the JAX
    package's cast at depth 32."""
    d = torch.as_tensor(depth, dtype=torch.int64, device=h.device)
    return _wrap_i32(torch.where(d == 0, 0, h >> (32 - d)))


# -- probe-sequence generators -------------------------------------------------

def probe_positions(key, slots: int) -> torch.Tensor:
    """Cyclic probe sequence ``(..., slots)`` over a bucket row, starting
    at the secondary hash of each key."""
    start = hash_bucket(key) % slots
    ar = torch.arange(slots, dtype=torch.int64, device=start.device)
    return (start.unsqueeze(-1) + ar) % slots


def window_positions(h: torch.Tensor, size_log2, window: int) -> torch.Tensor:
    """Linear probe window ``(..., window)`` from the home slot of hash
    ``h`` in an active table prefix of ``2**size_log2`` entries."""
    size = 1 << int(size_log2)
    home = dir_slot(h, size_log2).to(torch.int64)
    ar = torch.arange(window, dtype=torch.int64, device=h.device)
    return (home.unsqueeze(-1) + ar) % size


# -- masked probes -------------------------------------------------------------

def probe_hit(probed: torch.Tensor, key):
    """Find ``key`` in each probed key sequence (last axis).

    Returns ``(found, idx)``, ``idx`` indexing *into the probe sequence*;
    a hit after the first EMPTY slot is ignored (linear probing terminates
    at the first empty slot)."""
    p = bits(probed)
    hit = p == bits(key).unsqueeze(-1)
    empties = (p == EMPTY_BITS).to(torch.int32)
    before = torch.cumsum(empties, dim=-1) - empties
    live = hit & (before == 0)
    return live.any(dim=-1), live.to(torch.int32).argmax(dim=-1)


def probe_slot(probed: torch.Tensor, key):
    """Insert slot for ``key``: the first position that holds ``key``
    (overwrite) or is EMPTY.  Returns ``(ok, idx)``; ``ok`` is False when
    the probed window is full and the key absent."""
    p = bits(probed)
    usable = (p == bits(key).unsqueeze(-1)) | (p == EMPTY_BITS)
    return usable.any(dim=-1), usable.to(torch.int32).argmax(dim=-1)
