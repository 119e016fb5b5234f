"""The baselines' batch lookups (HT, HTI, CH) as CUDA kernels.

The JAX package looks up with jitted ``vmap``s (``repro/core/baselines.py``:
``ht_lookup_many``, ``hti_lookup_many``, ``ch_lookup_many``), which XLA
compiles into one device program each.  On CUDA (``csrc/baselines_lookup.cu``)
each batch is one kernel launch: ``open_lookup_kernel<false>`` for HT,
``open_lookup_kernel<true>`` for HTI (the fuller table first, the other on a
MISS), ``ch_lookup_kernel`` for CH (the chain walk, stopping at the first
hit).  The kernels read the state's scalars from device memory, so a lookup
makes no host sync.  Their plain versions are the vectorised lookups of
``core/baselines.py`` (``*_lookup_plain``), which the CPU path runs; these
wrappers take CUDA tensors only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import hashing
from repro_torch.kernels import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "open_lookup_launch": [_I, _P, _P, _L] + [_P] * 8 + [_P],
    "ch_lookup_launch": [_P, _P, _L, _P, _P, _P, _P, _I, _I, _I, _P],
}


def _lib():
    return _build.load("baselines_lookup", _SIGNATURES)


def _check_table(name: str, keys: torch.Tensor, vals: torch.Tensor,
                 *scalars: torch.Tensor) -> None:
    """An open table: keys and values (2**max_log2,) 32-bit, max_log2 < 32;
    its scalars 0-d int32."""
    for t in (keys, vals):
        if t.dtype not in (torch.uint32, torch.int32):
            raise TypeError(f"{name}: table arrays must be uint32, got "
                            f"{t.dtype}")
    cap = keys.numel()
    if keys.dim() != 1 or vals.shape != keys.shape or cap & (cap - 1) \
            or not 0 < cap < 1 << 32:
        raise ValueError(f"{name}: table arrays {tuple(keys.shape)} / "
                         f"{tuple(vals.shape)}, expected (2**k,) each")
    for s in scalars:
        if s.dtype != torch.int32 or s.numel() != 1:
            raise ValueError(f"{name}: state scalars must be 0-d int32")


def _run(name: str, arrays, keys, launch) -> torch.Tensor:
    """``launch(lib, keys, out, stream)`` on ``keys`` (any uint32 input,
    moved to the card of the state ``arrays``); returns the (n,) uint32
    results.  One counted launch unless there are no keys."""
    dev = _build.require_cuda(name, *arrays)
    k = hashing.bits(keys, device=dev).reshape(-1).contiguous()
    out = torch.empty_like(k)
    if k.numel():
        _build.check(launch(_lib(), k, out, _build.stream(dev)), name)
        _build.count_launch(name)
    return hashing.from_bits(out)


def _ptrs(arrays) -> list:
    return [a.data_ptr() for a in arrays]


def ht_lookup(st, keys) -> torch.Tensor:
    """The values of ``keys`` in the CUDA ``HTState`` ``st`` (MISS where
    absent), one launch of ``open_lookup_kernel<false>``."""
    table = (st.keys, st.vals, st.size_log2)
    _check_table("ht_lookup", *table)
    return _run("ht_lookup", table, keys, lambda lib, k, out, s:
                lib.open_lookup_launch(0, k.data_ptr(), out.data_ptr(),
                                       k.numel(), *_ptrs(table), None, None,
                                       None, None, None, s))


def hti_lookup(st, keys) -> torch.Tensor:
    """The values of ``keys`` in the CUDA ``HTIState`` ``st``: the fuller
    table first (new when ``new_count >= old_count``), the other on a MISS;
    one launch of ``open_lookup_kernel<true>``."""
    tables = (st.new_keys, st.new_vals, st.new_log2, st.new_count,
              st.old_keys, st.old_vals, st.old_log2, st.old_count)
    _check_table("hti_lookup", *tables[:4])
    _check_table("hti_lookup", *tables[4:])
    return _run("hti_lookup", tables, keys, lambda lib, k, out, s:
                lib.open_lookup_launch(1, k.data_ptr(), out.data_ptr(),
                                       k.numel(), *_ptrs(tables), s))


def ch_lookup(st, keys) -> torch.Tensor:
    """The values of ``keys`` in the CUDA ``CHState`` ``st``: each key's
    chain walked to its first hit (MISS at its end); one launch of
    ``ch_lookup_kernel``."""
    bk, bv = st.bucket_keys, st.bucket_vals
    for t in (bk, bv):
        if t.dtype not in (torch.uint32, torch.int32):
            raise TypeError(f"ch_lookup: bucket arrays must be uint32, got "
                            f"{t.dtype}")
    if bk.dim() != 2 or bv.shape != bk.shape:
        raise ValueError(f"ch_lookup: bucket arrays {tuple(bk.shape)} / "
                         f"{tuple(bv.shape)}, expected (C, S) each")
    C, S = bk.shape
    T = max(st.heads.numel().bit_length() - 1, 0)
    if st.heads.shape != (1 << T,) or st.next_bucket.shape != (C,) \
            or st.heads.dtype != torch.int32 \
            or st.next_bucket.dtype != torch.int32 or T > 31 \
            or not (0 < S and C < 1 << 31):
        raise ValueError(f"ch_lookup: heads {tuple(st.heads.shape)}, "
                         f"next_bucket {tuple(st.next_bucket.shape)} for "
                         f"({C}, {S}) buckets")
    arrays = (st.heads, bk, bv, st.next_bucket)
    return _run("ch_lookup", arrays, keys, lambda lib, k, out, s:
                lib.ch_lookup_launch(k.data_ptr(), out.data_ptr(), k.numel(),
                                     *_ptrs(arrays), T, C, S, s))
