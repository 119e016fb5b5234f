"""Extendible hashing (Fagin et al.) on PyTorch tensors — the paper's
showcase index (twin of ``repro/core/extendible_hashing.py``).

Layout (all arrays statically sized, validity tracked by scalars):

  * ``directory``    -- (max_dir,) int32; the first ``2**global_depth`` slots
                        are valid and hold bucket ids, indexed by the *most
                        significant* ``global_depth`` bits of the hash, so the
                        slots of one bucket form a contiguous range.
  * ``bucket_keys``/``bucket_vals`` -- (capacity, bucket_slots) uint32; a
                        bucket is a 4 KB page analogue, linear probing inside.
  * ``local_depth``  -- (capacity,) int32 per-bucket depth.
  * ``counts``       -- (capacity,) int32 live entries per bucket.
  * ``num_buckets``  -- () int32 bump-allocator high-water mark.

Every mutating op returns a new state and leaves its argument as it was
(copy-on-write, as JAX arrays are immutable): the maintenance runtime hands
the replays a snapshot that a later insert must not change under them.

The batch insert is order-dependent (the key order, and the slot order of a
split's redistribution), and must leave all eight arrays bit-identical to
the JAX package.  On CUDA it is one kernel launch per batch
(``kernels/eh_insert.py``); on the CPU it is the per-key loop below, which
is also the kernel's plain version.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.core.hashing import (EMPTY_SENTINEL,  # noqa: F401
                                      dir_slot, hash_bucket, hash_dir)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.eh_insert import eh_insert_


class EHState(NamedTuple):
    directory: torch.Tensor     # (max_dir,) int32 bucket ids
    bucket_keys: torch.Tensor   # (capacity, bucket_slots) uint32
    bucket_vals: torch.Tensor   # (capacity, bucket_slots) uint32
    counts: torch.Tensor        # (capacity,) int32
    local_depth: torch.Tensor   # (capacity,) int32
    global_depth: torch.Tensor  # () int32
    num_buckets: torch.Tensor   # () int32
    dropped: torch.Tensor       # () int32  inserts refused (capacity exhausted)

    @property
    def max_global_depth(self) -> int:
        return int(self.directory.shape[0]).bit_length() - 1

    @property
    def capacity(self) -> int:
        return self.bucket_keys.shape[0]

    @property
    def bucket_slots(self) -> int:
        return self.bucket_keys.shape[1]


def eh_create(max_global_depth: int, bucket_slots: int, capacity: int, *,
              device=None) -> EHState:
    """One empty bucket, one directory slot (the paper's 4 KB start state)."""
    if capacity < 1:
        raise ValueError("capacity must be at least 1")
    dev = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    return EHState(
        directory=torch.zeros((1 << max_global_depth,), **i32),
        bucket_keys=hashing.full((capacity, bucket_slots), EMPTY_SENTINEL,
                                 torch.uint32, dev),
        bucket_vals=hashing.full((capacity, bucket_slots), 0, torch.uint32,
                                 dev),
        counts=torch.zeros((capacity,), **i32),
        local_depth=torch.zeros((capacity,), **i32),
        global_depth=torch.zeros((), **i32),
        num_buckets=torch.ones((), **i32),
        dropped=torch.zeros((), **i32),
    )


def clone_state(st: EHState) -> EHState:
    return EHState(*(hashing.clone(a) for a in st))


# ---------------------------------------------------------------------------
# The per-key insert loop (plain version of the insert kernel).  It works on
# numpy views of the CPU tensors, in place, with Python ints per key.
# ---------------------------------------------------------------------------

def _slot(h: int, g: int) -> int:
    return h >> (32 - g) if g else 0


def bucket_find(keys_row: np.ndarray, key: int) -> int:
    """Probe a bucket row; slot index of ``key`` or -1 (a hit after the
    first EMPTY slot does not count)."""
    S = keys_row.shape[0]
    start = hashing.hash_bucket_host(key) % S
    for j in range(S):
        p = (start + j) % S
        k = int(keys_row[p])
        if k == key:
            return p
        if k == EMPTY_SENTINEL:
            return -1
    return -1


def bucket_put(keys_row: np.ndarray, vals_row: np.ndarray, key: int,
               value: int) -> tuple[int, bool]:
    """Insert/overwrite (key, value) in a bucket row, in place.

    Returns ``(inserted_new, ok)``: ``inserted_new`` is 1 if a fresh slot
    was consumed (the count must grow); ``ok`` is False if the row was full
    and the key absent."""
    S = keys_row.shape[0]
    start = hashing.hash_bucket_host(key) % S
    for j in range(S):
        p = (start + j) % S
        k = int(keys_row[p])
        if k == key or k == EMPTY_SENTINEL:
            keys_row[p] = key
            vals_row[p] = value
            return int(k == EMPTY_SENTINEL), True
    return 0, False


def _double_directory(d: np.ndarray, g: int) -> None:
    """MSB indexing: each valid slot i fans out to slots 2i, 2i+1."""
    n = 1 << (g + 1)
    d[:n] = d[np.arange(n) >> 1]


def _split_bucket(a: dict, g: int, nb: int, h: int) -> int:
    """Split the bucket addressed by hash ``h``; returns the global depth."""
    d, bk, bv, ld = a["directory"], a["bucket_keys"], a["bucket_vals"], \
        a["local_depth"]
    if ld[d[_slot(h, g)]] == g:
        _double_directory(d, g)
        g += 1
    slot = _slot(h, g)
    b = int(d[slot])
    l = int(ld[b])
    b2 = nb                                   # bump allocation
    S = bk.shape[1]
    # redistribute b's entries in slot order on hash bit l+1 from the top
    rows = [(np.full(S, EMPTY_SENTINEL, np.uint32), np.zeros(S, np.uint32))
            for _ in range(2)]
    c = [0, 0]
    for key, val in zip(bk[b].tolist(), bv[b].tolist()):
        if key == EMPTY_SENTINEL:
            continue
        side = (hashing.hash_dir_host(key) >> (31 - l)) & 1
        c[side] += bucket_put(rows[side][0], rows[side][1], key, val)[0]
    (bk[b], bv[b]), (bk[b2], bv[b2]) = rows
    a["counts"][b], a["counts"][b2] = c
    ld[b] = ld[b2] = l + 1
    # directory range [start, start + 2^(g-l)) pointed at b; upper half -> b2
    shift = g - l
    start = (slot >> shift) << shift
    length = 1 << shift
    d[start + length // 2:start + length] = b2
    return g


def _insert_host(st: EHState, keys: np.ndarray, values: np.ndarray) -> None:
    """Insert in order into the CPU state ``st``, in place (splits, possibly
    cascading, handled in-line, as the reference's ``eh_insert``)."""
    a = {f: getattr(st, f).numpy() for f in
         ("directory", "bucket_keys", "bucket_vals", "counts", "local_depth")}
    d, bk, bv, counts, ld = (a[f] for f in (
        "directory", "bucket_keys", "bucket_vals", "counts", "local_depth"))
    g, nb, dropped = int(st.global_depth), int(st.num_buckets), \
        int(st.dropped)
    C, S = bk.shape
    maxg = st.max_global_depth
    for key, value in zip(keys.tolist(), values.tolist()):
        h = hashing.hash_dir_host(key)
        while True:
            b = int(d[_slot(h, g)])
            if (counts[b] >= S and bucket_find(bk[b], key) < 0 and nb < C
                    and (ld[b] < g or g < maxg)):
                g = _split_bucket(a, g, nb, h)
                nb += 1
                continue
            break
        inserted_new, ok = bucket_put(bk[b], bv[b], key, value)
        counts[b] += inserted_new
        dropped += int(not ok)
    st.global_depth.fill_(g)
    st.num_buckets.fill_(nb)
    st.dropped.fill_(dropped)


# ---------------------------------------------------------------------------
# Public ops.
# ---------------------------------------------------------------------------

def eh_insert_many(st: EHState, keys, values) -> EHState:
    """Sequential batch insert (splits serialize inserts by nature).
    Returns the new state; ``st`` is left as it was."""
    dev = st.directory.device
    k = hashing.bits(keys, device=dev).reshape(-1).contiguous()
    v = hashing.bits(values, device=dev).reshape(-1).contiguous()
    if k.shape != v.shape:
        raise ValueError(f"{k.numel()} keys vs {v.numel()} values")
    out = clone_state(st)
    if dev.type == "cuda":
        eh_insert_(out, k, v)
    else:
        _insert_host(out, k.numpy().view(np.uint32), v.numpy().view(np.uint32))
    return out


def eh_insert(st: EHState, key, value) -> EHState:
    """Insert (key, value); splits (possibly cascading) handled in-line."""
    return eh_insert_many(st, [int(key)], [int(value)])


def eh_lookup_many(st: EHState, keys) -> torch.Tensor:
    """Traditional path: directory gather -> bucket gather -> probe."""
    return ops.eh_lookup_op(keys, st)


def eh_lookup(st: EHState, key) -> torch.Tensor:
    return eh_lookup_many(st, [int(key)])[0]


# ---------------------------------------------------------------------------
# Shortcut path: lookups against a pre-composed view (``rewiring.compose`` of
# the bucket pages by the directory).  One indirection instead of two.
# ---------------------------------------------------------------------------

def shortcut_lookup_many(view_keys, view_vals, global_depth,
                         keys) -> torch.Tensor:
    return ops.shortcut_lookup_op(keys, view_keys, view_vals, global_depth)


def shortcut_lookup(view_keys, view_vals, global_depth, key) -> torch.Tensor:
    """Lookup through the composed view: slot arithmetic + one gather."""
    return shortcut_lookup_many(view_keys, view_vals, global_depth,
                                [int(key)])[0]


def compose_shortcut(st: EHState, view_slots: int):
    """Create-request replay: materialize (view_keys, view_vals) for the
    first ``view_slots`` directory slots (a power of two >=
    ``2**global_depth``); slots past ``2**global_depth`` show bucket 0.

    The expensive one-shot 'mmap loop' of the paper's step (2); the
    ShortcutEH wrapper runs it asynchronously.  A plain gather, as in the
    JAX package (no kernel there either)."""
    idx = torch.arange(view_slots, device=st.directory.device)
    valid = (idx >> st.global_depth) == 0
    src = torch.where(valid, st.directory[:view_slots], 0).long()
    return (hashing.from_bits(hashing.bits(st.bucket_keys)[src]),
            hashing.from_bits(hashing.bits(st.bucket_vals)[src]))


# ---------------------------------------------------------------------------
# Introspection used by routing and tests.
# ---------------------------------------------------------------------------

def avg_fan_in(st: EHState) -> torch.Tensor:
    """Average number of directory slots per bucket = 2^g / #buckets."""
    return torch.pow(2.0, st.global_depth.to(torch.float32)) \
        / st.num_buckets.to(torch.float32)


def eh_num_entries(st: EHState) -> torch.Tensor:
    return st.counts.sum()


def check_invariants(st: EHState) -> dict:
    """Host-side invariant checks (the JAX package's, same verdicts and
    messages; I4 vectorized for full-size states).

    I1: every valid directory slot points to an allocated bucket.
    I2: bucket b with local depth l is referenced by exactly 2^(g-l)
        *contiguous* slots whose top-l hash bits are constant.
    I3: local_depth <= global_depth for all allocated buckets.
    I4: every live key is stored in the bucket its hash addresses.
    I5: counts match the number of non-empty slots.
    """
    g = int(st.global_depth)
    nd = 1 << g
    directory = st.directory[:nd].cpu().numpy()
    nb = int(st.num_buckets)
    out = {"ok": True, "errors": []}

    def fail(msg):
        out["ok"] = False
        out["errors"].append(msg)

    if not ((directory >= 0) & (directory < nb)).all():
        fail("I1: dangling directory slot")
    ld = st.local_depth[:nb].cpu().numpy()
    if (ld > g).any():
        fail("I3: local depth exceeds global depth")
    ref_counts = {}
    for slot, b in enumerate(directory.tolist()):
        ref_counts.setdefault(b, []).append(slot)
    for b, slots in ref_counts.items():
        expect = 1 << (g - int(ld[b]))
        if len(slots) != expect:
            fail(f"I2: bucket {b} referenced {len(slots)}x, expect {expect}")
        if slots != list(range(slots[0], slots[0] + len(slots))):
            fail(f"I2: bucket {b} slots not contiguous")
    keys = st.bucket_keys[:nb].cpu().numpy()
    counts = st.counts[:nb].cpu().numpy()
    live = keys != np.uint32(EMPTY_SENTINEL)
    if not (live.sum(axis=1) == counts).all():
        fail("I5: counts mismatch")
    bucket, col = np.nonzero(live)            # row-major: bucket, then slot
    k = keys[bucket, col]
    h = (k.astype(np.uint64) * np.uint64(hashing.HASH_C1)) \
        & np.uint64(hashing.MASK32)
    slot = h >> np.uint64(32 - g) if g > 0 else np.zeros_like(h)
    for i in np.nonzero(directory[slot] != bucket)[0].tolist():
        fail(f"I4: key {k[i]} misplaced (bucket {bucket[i]}, "
             f"slot {slot[i]})")
    return out
