"""The baselines' batch inserts (HT, HTI, CH) as CUDA kernels.

The JAX package inserts with per-key ``lax.scan``s on the device
(``repro/core/baselines.py``: ``ht_insert_many``, ``hti_insert_many``,
``ch_insert_many``).  On CUDA (``csrc/baselines_insert.cu``) HT's and HTI's
batch is one cooperative kernel launch over the whole card, which places the
insert stream by claim rounds, HT's doublings and HTI's migration starts
included; CH's batch is one cooperative launch too, which places every key
by prefix counts (its chain's keys grouped by a radix sort of their chain
slots, its new bucket numbered in key order).  Their plain versions are the
per-key loops of ``core/baselines.py``, which the CPU path runs.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from repro_torch.kernels import _build

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_STATS = ctypes.c_int * 7
_CH_STATS = ctypes.c_int * 7
_SIGNATURES = {
    "ht_insert_launch": [_P, _P, _I] + [_P] * 5 + [_I, _F, _P, _L, _I, _I,
                                                   _STATS, _P],
    "hti_insert_launch": [_P, _P, _I] + [_P] * 11 + [_I, _F, _I, _P, _L, _I,
                                                     _STATS, _P],
    "ch_insert_launch": [_P, _P, _I] + [_P] * 7 + [_I, _I, _I, _P, _CH_STATS,
                                                    _P],
    "open_work_bytes": [_L, _I, _I],
    "ch_work_bytes": [_L, _I],
}
#: the open tables' kernel statistics, as the launcher reports them: kernel
#: launches, segments (each a records and map pass and a write pass),
#: prefix-count passes (a segment end where a load test may fire), claim
#: rounds, the most rounds one segment took, events (HT's doublings, HTI's
#: migration starts), the grid's threads
PASS_FIELDS = ("launches", "segments", "count_passes", "rounds",
               "most_rounds", "events", "grid_threads")
#: CH's: kernel launches, radix passes, chain groups (chains the batch
#: touches), the largest group (a chain's keys in one batch), the longest
#: walk to a chain's tail (links followed), new buckets opened, the grid's
#: threads
CH_FIELDS = ("launches", "radix_passes", "groups", "largest_group",
             "longest_walk", "opened", "grid_threads")
_LARGEST = ("most_rounds", "largest_group", "longest_walk", "grid_threads")
_passes: dict = {}
_passes_lock = threading.Lock()


def passes() -> dict:
    """``{kernel: {field: value}}`` summed over the calls since
    :func:`reset_passes` (``most_rounds``, ``largest_group``,
    ``longest_walk`` and ``grid_threads``: the largest)."""
    with _passes_lock:
        return {k: dict(v) for k, v in _passes.items()}


def reset_passes() -> None:
    with _passes_lock:
        _passes.clear()


def _record(name: str, stats, fields=PASS_FIELDS) -> None:
    with _passes_lock:
        acc = _passes.setdefault(name, dict.fromkeys(fields, 0))
        for field, x in zip(fields, stats):
            acc[field] = max(acc[field], x) if field in _LARGEST \
                else acc[field] + x
    _build.count_launch(name, stats[0])


def _lib():
    lib = _build.load("baselines_insert", _SIGNATURES)
    lib.open_work_bytes.restype = ctypes.c_longlong
    lib.ch_work_bytes.restype = ctypes.c_longlong
    return lib


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


def _largest_doubling(log2: int, count: int, n: int, max_log2: int,
                      load_threshold: float) -> int:
    """log2 of the largest table a batch of ``n`` keys may double (HT) or
    start a migration (HTI) from (-1: none): the reference's float32 load
    test ``f32(count) + 1 > f32(threshold) * 2**L`` made on ``count + n``,
    more than the count any key of the batch sees (each key adds at most
    one), so never too small."""
    c = np.float32(count + n) + np.float32(1.0)
    thr = np.float32(load_threshold)
    largest = -1
    for L in range(log2, max_log2):
        if c > thr * np.float32(1 << L):
            largest = L
    return largest


def _check_positions(name: str, n: int, max_log2: int) -> None:
    """A stream position (a key, or an old slot a doubling or a migration
    moves) is a claim's priority, an int32."""
    if n + 1 + (1 << max(max_log2 - 1, 0)) >= 1 << 31:
        raise ValueError(f"{name}: {n} keys and an old table of "
                         f"2**{max_log2 - 1} slots pass 2**31 positions")


def _work(lib, dev, positions: int, owner_log2: int,
          stage_log2: int) -> torch.Tensor:
    return torch.empty(lib.open_work_bytes(positions, owner_log2, stage_log2),
                       dtype=torch.uint8, device=dev)


def ht_insert_(st, keys: torch.Tensor, values: torch.Tensor,
               load_threshold: float) -> None:
    """Insert ``keys``/``values`` ((n,) uint32 or int32 bit patterns) into
    the CUDA ``HTState`` ``st`` in place, in order.  The work space is
    sized from the batch: the claims' owner array (4 bytes a slot) covers
    the largest table the batch may reach, and the doubling's stage (8
    bytes an old slot) the largest it may double from."""
    _check_batch("ht_insert", keys, values)
    _check_shapes("ht_insert", (1 << st.max_size_log2,), st.keys, st.vals)
    dev = _build.require_cuda("ht_insert", keys, values, *st)
    n = keys.numel()
    if n == 0:
        return
    _check_positions("ht_insert", n, st.max_size_log2)
    size_log2, count = torch.stack([st.size_log2, st.count]).tolist()
    stage_log2 = _largest_doubling(size_log2, count, n, st.max_size_log2,
                                   load_threshold)
    positions = max(n, 1 << stage_log2 if stage_log2 >= 0 else 0)
    owner_log2 = max(size_log2, stage_log2 + 1)
    lib = _lib()
    work = _work(lib, dev, positions, owner_log2, stage_log2)
    stats = _STATS()
    err = lib.ht_insert_launch(
        keys.data_ptr(), values.data_ptr(), n, *_ptrs(st),
        st.max_size_log2, float(load_threshold), work.data_ptr(), positions,
        owner_log2, stage_log2, stats, _build.stream(dev))
    _build.check(err, "ht_insert")
    _record("ht_insert", stats)


def hti_insert_(st, keys: torch.Tensor, values: torch.Tensor,
                load_threshold: float, migrate_batch: int) -> None:
    """Insert into the CUDA ``HTIState`` ``st`` in place, in order, each
    insert first migrating ``migrate_batch`` old slots.  The work space is
    sized from the batch: its stream's longest run (the keys and the old
    slots of the migration running, or of the largest one the batch may
    start) and the largest new table it may reach (the owner array, 4
    bytes a slot)."""
    _check_batch("hti_insert", keys, values)
    if not 1 <= migrate_batch < 1 << 31:
        raise ValueError(f"hti_insert: migrate_batch {migrate_batch}")
    _check_shapes("hti_insert", (1 << st.max_size_log2,), *st[:4])
    dev = _build.require_cuda("hti_insert", keys, values, *st)
    n = keys.numel()
    if n == 0:
        return
    _check_positions("hti_insert", n, st.max_size_log2)
    old_log2, new_log2, old_count, new_count, ptr, migrating = torch.stack(
        [st.old_log2, st.new_log2, st.old_count, st.new_count,
         st.migrate_ptr, st.migrating.to(torch.int32)]).tolist()
    flip_log2 = _largest_doubling(new_log2, old_count + new_count, n,
                                  st.max_size_log2, load_threshold)
    old_slots = max((1 << old_log2) - ptr if migrating else 0,
                    1 << flip_log2 if flip_log2 >= 0 else 0)
    positions = n + 1 + min(migrate_batch * n, old_slots)
    owner_log2 = max(new_log2, flip_log2 + 1)
    lib = _lib()
    work = _work(lib, dev, positions, owner_log2, -1)
    stats = _STATS()
    err = lib.hti_insert_launch(
        keys.data_ptr(), values.data_ptr(), n, *_ptrs(st),
        st.max_size_log2, float(load_threshold), migrate_batch,
        work.data_ptr(), positions, owner_log2, stats, _build.stream(dev))
    _build.check(err, "hti_insert")
    _record("hti_insert", stats)


def ch_insert_(st, keys: torch.Tensor, values: torch.Tensor) -> None:
    """Insert into the CUDA ``CHState`` ``st`` in place, in order.  The work
    space (about 28 bytes a key) is sized from the batch."""
    _check_batch("ch_insert", keys, values)
    C, S = st.bucket_keys.shape
    _check_shapes("ch_insert", (1 << st.table_log2,), st.heads)
    _check_shapes("ch_insert", (C, S), st.bucket_vals)
    _check_shapes("ch_insert", (C,), st.next_bucket, st.counts)
    dev = _build.require_cuda("ch_insert", keys, values, *st)
    n = keys.numel()
    if n == 0:
        return
    if max(C, S) + n >= 1 << 31:
        raise ValueError(f"ch_insert: {n} keys past a capacity of {C} "
                         f"buckets of {S} slots pass 2**31")
    lib = _lib()
    work = torch.empty(lib.ch_work_bytes(n, st.table_log2),
                       dtype=torch.uint8, device=dev)
    stats = _CH_STATS()
    err = lib.ch_insert_launch(
        keys.data_ptr(), values.data_ptr(), n, *_ptrs(st), st.table_log2, C,
        S, work.data_ptr(), stats, _build.stream(dev))
    _build.check(err, "ch_insert")
    _record("ch_insert", stats, CH_FIELDS)
