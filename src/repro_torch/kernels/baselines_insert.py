"""The baselines' batch inserts (HT, HTI, CH) as CUDA kernels.

The JAX package inserts with per-key ``lax.scan``s on the device
(``repro/core/baselines.py``: ``ht_insert_many``, ``hti_insert_many``,
``ch_insert_many``); on CUDA each batch is one single-block kernel launch
(``csrc/baselines_insert.cu``), plus HT's doubling passes and HTI's
migration starts, which the launcher runs between launches of the insert
and which count as launches of the same kernel.  Their plain versions are
the per-key loops of ``core/baselines.py``, which the CPU path runs.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LAUNCHES = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "ht_insert_launch": [_P, _P, _I] + [_P] * 5 + [_I, _F] + [_P] * 3
                        + [_I, _P, _LAUNCHES, _P],
    "hti_insert_launch": [_P, _P, _I] + [_P] * 11 + [_I, _F, _I, _P,
                                                     _LAUNCHES, _P],
    "ch_insert_launch": [_P, _P, _I] + [_P] * 7 + [_I, _I, _I, _P],
}


def _check_batch(name: str, keys: torch.Tensor, values: torch.Tensor) -> None:
    if keys.dtype not in (torch.uint32, torch.int32) or \
            values.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"{name}: keys and values must be uint32 bit patterns")
    if keys.shape != values.shape or keys.dim() != 1:
        raise ValueError(f"{name}: keys {tuple(keys.shape)} vs values "
                         f"{tuple(values.shape)}")
    if keys.numel() >= 1 << 31:
        raise ValueError(f"{name}: {keys.numel()} keys, at most 2**31 - 1")


def _check_shapes(name: str, want: tuple, *arrays: torch.Tensor) -> None:
    """The arrays a kernel indexes together must have the shape ``want``."""
    for a in arrays:
        if tuple(a.shape) != want:
            raise ValueError(f"{name}: state array of shape {tuple(a.shape)}"
                             f", expected {want}")


def _ptrs(arrays) -> list:
    return [a.data_ptr() for a in arrays]


def _largest_doubling(size_log2: int, count: int, n: int, max_log2: int,
                      load_threshold: float) -> int:
    """log2 of the largest table a batch of ``n`` keys may double from
    (-1: none): the reference's float32 load test ``f32(count) + 1 >
    f32(threshold) * 2**L`` made on ``count + n``, more than the count any
    key of the batch sees (``count`` never falls), so never too small."""
    c = np.float32(count + n) + np.float32(1.0)
    thr = np.float32(load_threshold)
    largest = -1
    for L in range(size_log2, max_log2):
        if c > thr * np.float32(1 << L):
            largest = L
    return largest


def ht_insert_(st, keys: torch.Tensor, values: torch.Tensor,
               load_threshold: float) -> None:
    """Insert ``keys``/``values`` ((n,) uint32 or int32 bit patterns) into
    the CUDA ``HTState`` ``st`` in place, in order.  The doubling's work
    space (9 bytes an old slot) is allocated only for a batch that may
    double, and only as large as the largest table it may double from."""
    _check_batch("ht_insert", keys, values)
    _check_shapes("ht_insert", (1 << st.max_size_log2,), st.keys, st.vals)
    dev = _build.require_cuda("ht_insert", keys, values, *st)
    if keys.numel() == 0:
        return
    size_log2, count = torch.stack([st.size_log2, st.count]).tolist()
    work_log2 = _largest_doubling(size_log2, count, keys.numel(),
                                  st.max_size_log2, load_threshold)
    work = 1 << work_log2 if work_log2 >= 0 else 0
    old_k = torch.empty(work, dtype=torch.int32, device=dev)
    old_v = torch.empty(work, dtype=torch.int32, device=dev)
    cand = torch.empty(work, dtype=torch.uint8, device=dev)
    status = torch.zeros(4, dtype=torch.int32, device=dev)
    launches = (ctypes.c_int * 2)()
    lib = _build.load("baselines_insert", _SIGNATURES)
    err = lib.ht_insert_launch(
        keys.data_ptr(), values.data_ptr(), keys.numel(), *_ptrs(st),
        st.max_size_log2, float(load_threshold), old_k.data_ptr(),
        old_v.data_ptr(), cand.data_ptr(), work_log2, status.data_ptr(),
        launches, _build.stream(dev))
    _build.check(err, "ht_insert")
    _build.count_launch("ht_insert", launches[0] + launches[1])


def hti_insert_(st, keys: torch.Tensor, values: torch.Tensor,
                load_threshold: float, migrate_batch: int) -> None:
    """Insert into the CUDA ``HTIState`` ``st`` in place, in order, each
    insert first migrating ``migrate_batch`` old slots."""
    _check_batch("hti_insert", keys, values)
    if not 1 <= migrate_batch < 1 << 31:
        raise ValueError(f"hti_insert: migrate_batch {migrate_batch}")
    _check_shapes("hti_insert", (1 << st.max_size_log2,), *st[:4])
    dev = _build.require_cuda("hti_insert", keys, values, *st)
    if keys.numel() == 0:
        return
    status = torch.zeros(4, dtype=torch.int32, device=dev)
    launches = (ctypes.c_int * 2)()
    lib = _build.load("baselines_insert", _SIGNATURES)
    err = lib.hti_insert_launch(
        keys.data_ptr(), values.data_ptr(), keys.numel(), *_ptrs(st),
        st.max_size_log2, float(load_threshold), migrate_batch,
        status.data_ptr(), launches, _build.stream(dev))
    _build.check(err, "hti_insert")
    _build.count_launch("hti_insert", launches[0] + launches[1])


def ch_insert_(st, keys: torch.Tensor, values: torch.Tensor) -> None:
    """Insert into the CUDA ``CHState`` ``st`` in place, in order."""
    _check_batch("ch_insert", keys, values)
    C, S = st.bucket_keys.shape
    _check_shapes("ch_insert", (1 << st.table_log2,), st.heads)
    _check_shapes("ch_insert", (C, S), st.bucket_vals)
    _check_shapes("ch_insert", (C,), st.next_bucket, st.counts)
    dev = _build.require_cuda("ch_insert", keys, values, *st)
    if keys.numel() == 0:
        return
    lib = _build.load("baselines_insert", _SIGNATURES)
    err = lib.ch_insert_launch(
        keys.data_ptr(), values.data_ptr(), keys.numel(), *_ptrs(st),
        st.table_log2, C, S, _build.stream(dev))
    _build.check(err, "ch_insert")
    _build.count_launch("ch_insert")
