"""The paper's §4.2 baselines on PyTorch tensors (twin of
``repro/core/baselines.py``).

  * :class:`HTState`  -- Hash Table (HT): one open-addressing table with a
    32-slot linear-probe window, doubled and fully rehashed when the load
    factor crosses a threshold.
  * :class:`HTIState` -- Hash Table Incremental (HTI, Redis-style): as HT,
    but each insert first moves ``migrate_batch`` *slots* of the old table
    into the new one while both tables co-exist; lookups probe the fuller
    table first.
  * :class:`CHState`  -- Chained Hashing (CH): a fixed table of chain heads
    over fixed buckets; a full tail bucket gets a new bucket linked behind
    it.

The same multiplicative hash as the EH index (``core/hashing.py``).  The
batch inserts are order-dependent and must leave every state array
bit-identical to the JAX package, including its quirks, which the port
keeps:

  * HT: a re-insert overwrites; an entry whose window is full when a
    doubling re-inserts it is lost without a count;
  * HTI: a key re-inserted while its old copy waits in the old table goes
    to the new table; when the migration reaches the old copy it finds the
    key there and overwrites it with the *old* value.  A migrated slot's
    key becomes EMPTY and its value stays;
  * CH: an insert appends without looking for the key, so a re-insert
    leaves the first copy, which the lookup finds.

Each ``*_insert_many`` copies the state and inserts in place.  On CUDA it
is one kernel launch per batch (``kernels/baselines_insert.py``; HT's and
HTI's place the batch by claim rounds over the whole card, doublings and
migration starts included); on the CPU it is the per-key loop below,
which is also the kernels' plain version.  Each ``*_lookup_many`` is one
kernel launch on CUDA (``kernels/baselines_lookup.py``, which reads the
state's scalars on the card: no host sync; the JAX package's are jitted
``vmap``s, no Pallas kernel); on the CPU it is vectorised PyTorch in chunks
of ``2**20`` keys (``*_lookup_plain``, the kernels' plain version, which
runs on either device).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.core.hashing import (EMPTY_SENTINEL, MISS_BITS, dir_slot,
                                      hash_dir)
from repro_torch.device import resolve_device
from repro_torch.kernels import baselines_insert as kern
from repro_torch.kernels import baselines_lookup as look

PROBE_WINDOW = 32  # static linear-probe window; ample for load <= 0.35
LOOKUP_CHUNK = 1 << 20


def _i32(value: int, dev) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.int32, device=dev)


def _clone(st):
    return type(st)(*(hashing.clone(a) for a in st))


def _batch(keys, values, dev):
    k = hashing.bits(keys, device=dev).reshape(-1).contiguous()
    v = hashing.bits(values, device=dev).reshape(-1).contiguous()
    if k.shape != v.shape:
        raise ValueError(f"{k.numel()} keys vs {v.numel()} values")
    return k, v


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _over_threshold(count: int, size_log2: int, load_threshold) -> bool:
    """The reference's load test, in float32 as it computes it:
    ``f32(count) + 1 > f32(load_threshold) * 2**size_log2``."""
    return bool(np.float32(count) + np.float32(1.0)
                > np.float32(load_threshold) * np.float32(1 << size_log2))


# ---------------------------------------------------------------------------
# The probe of the open-addressing tables, on numpy rows in place (plain
# version of the insert kernels) and vectorised (plain version of the lookup
# kernel).
# ---------------------------------------------------------------------------

def probe_put(keys: np.ndarray, vals: np.ndarray, key: int, value: int,
              size_log2: int) -> tuple[int, bool]:
    """Insert/overwrite in the window of ``key`` in the prefix
    ``[0, 2**size_log2)``: the first slot that holds the key or is EMPTY.
    Returns ``(inserted_new, ok)``; ``ok`` is False for a full window."""
    size = 1 << size_log2
    h = hashing.hash_dir_host(key)
    home = h >> (32 - size_log2) if size_log2 else 0
    for j in range(PROBE_WINDOW):
        p = (home + j) % size
        k = int(keys[p])
        if k == key or k == EMPTY_SENTINEL:
            keys[p] = key
            vals[p] = value
            return int(k == EMPTY_SENTINEL), True
    return 0, False


def _probe_find(keys: torch.Tensor, vals: torch.Tensor, q: torch.Tensor,
                size_log2: int) -> torch.Tensor:
    """int32 bit patterns of the values of keys ``q`` (int32 bits), MISS
    where absent."""
    pos = hashing.window_positions(hash_dir(q), size_log2, PROBE_WINDOW)
    found, j = hashing.probe_hit(hashing.bits(keys)[pos], q)
    got = hashing.bits(vals)[pos.gather(1, j.unsqueeze(1).long()).squeeze(1)]
    return torch.where(found, got, MISS_BITS)


def _chunked(fn, keys, dev) -> torch.Tensor:
    q = hashing.bits(keys, device=dev).reshape(-1)
    out = torch.cat([fn(q[i:i + LOOKUP_CHUNK])
                     for i in range(0, q.numel(), LOOKUP_CHUNK)]) \
        if q.numel() else q.clone()
    return hashing.from_bits(out)


# ---------------------------------------------------------------------------
# HT: full-stop rehash.
# ---------------------------------------------------------------------------

class HTState(NamedTuple):
    keys: torch.Tensor       # (max_cap,) uint32
    vals: torch.Tensor       # (max_cap,) uint32
    size_log2: torch.Tensor  # () int32
    count: torch.Tensor      # () int32
    dropped: torch.Tensor    # () int32

    @property
    def max_size_log2(self) -> int:
        return int(self.keys.shape[0]).bit_length() - 1


def ht_create(max_size_log2: int, initial_size_log2: int = 9, *,
              device=None) -> HTState:
    dev = resolve_device(device)
    cap = 1 << max_size_log2
    return HTState(
        keys=hashing.full((cap,), EMPTY_SENTINEL, torch.uint32, dev),
        vals=hashing.full((cap,), 0, torch.uint32, dev),
        size_log2=_i32(initial_size_log2, dev),
        count=_i32(0, dev), dropped=_i32(0, dev))


def _ht_insert_host(st: HTState, keys: np.ndarray, values: np.ndarray,
                    load_threshold: float) -> None:
    tk, tv = _u32(st.keys), _u32(st.vals)
    L, count, dropped = int(st.size_log2), int(st.count), int(st.dropped)
    maxL = st.max_size_log2
    for key, value in zip(keys.tolist(), values.tolist()):
        if _over_threshold(count, L, load_threshold) and L < maxL:
            # double: every live entry in old-slot order into an empty
            # table of twice the size; a full window loses the entry
            live = np.nonzero(tk[:1 << L] != EMPTY_SENTINEL)[0]
            old_k, old_v = tk[live].copy(), tv[live].copy()
            tk[:2 << L] = EMPTY_SENTINEL
            tv[:2 << L] = 0
            L += 1
            for k, v in zip(old_k.tolist(), old_v.tolist()):
                probe_put(tk, tv, k, v, L)
        inew, ok = probe_put(tk, tv, key, value, L)
        count += inew
        dropped += int(not ok)
    st.size_log2.fill_(L)
    st.count.fill_(count)
    st.dropped.fill_(dropped)


def ht_insert_many(st: HTState, keys, values,
                   load_threshold: float = 0.35) -> HTState:
    """Sequential batch insert; returns the new state, ``st`` unchanged."""
    dev = st.keys.device
    k, v = _batch(keys, values, dev)
    out = _clone(st)
    if dev.type == "cuda":
        kern.ht_insert_(out, k, v, load_threshold)
    else:
        _ht_insert_host(out, _u32(k), _u32(v), load_threshold)
    return out


def ht_insert(st: HTState, key, value,
              load_threshold: float = 0.35) -> HTState:
    return ht_insert_many(st, [int(key)], [int(value)], load_threshold)


def ht_lookup_plain(st: HTState, keys) -> torch.Tensor:
    """The kernel's plain version, on the state's device."""
    L = int(st.size_log2)
    return _chunked(lambda q: _probe_find(st.keys, st.vals, q, L), keys,
                    st.keys.device)


def ht_lookup_many(st: HTState, keys) -> torch.Tensor:
    if st.keys.device.type == "cuda":
        return look.ht_lookup(st, keys)
    return ht_lookup_plain(st, keys)


def ht_lookup(st: HTState, key) -> torch.Tensor:
    return ht_lookup_many(st, [int(key)])[0]


# ---------------------------------------------------------------------------
# HTI: Redis-style incremental rehash.
# ---------------------------------------------------------------------------

class HTIState(NamedTuple):
    old_keys: torch.Tensor     # (max_cap,) uint32
    old_vals: torch.Tensor
    new_keys: torch.Tensor
    new_vals: torch.Tensor
    old_log2: torch.Tensor     # () int32
    new_log2: torch.Tensor
    old_count: torch.Tensor
    new_count: torch.Tensor
    migrate_ptr: torch.Tensor  # () int32; == 2**old_log2 when drained
    migrating: torch.Tensor    # () bool
    dropped: torch.Tensor

    @property
    def max_size_log2(self) -> int:
        return int(self.new_keys.shape[0]).bit_length() - 1


def hti_create(max_size_log2: int, initial_size_log2: int = 9, *,
               device=None) -> HTIState:
    dev = resolve_device(device)
    cap = 1 << max_size_log2

    def keys():
        return hashing.full((cap,), EMPTY_SENTINEL, torch.uint32, dev)

    def vals():
        return hashing.full((cap,), 0, torch.uint32, dev)

    return HTIState(
        old_keys=keys(), old_vals=vals(), new_keys=keys(), new_vals=vals(),
        old_log2=_i32(initial_size_log2, dev),
        new_log2=_i32(initial_size_log2, dev),
        old_count=_i32(0, dev), new_count=_i32(0, dev),
        migrate_ptr=_i32(1 << initial_size_log2, dev),
        migrating=torch.zeros((), dtype=torch.bool, device=dev),
        dropped=_i32(0, dev))


def _hti_insert_host(st: HTIState, keys: np.ndarray, values: np.ndarray,
                     load_threshold: float, migrate_batch: int) -> None:
    ok_, ov, nk, nv = (_u32(a) for a in st[:4])
    oL, nL = int(st.old_log2), int(st.new_log2)
    oc, nc = int(st.old_count), int(st.new_count)
    ptr, migrating, dropped = (int(st.migrate_ptr), bool(st.migrating),
                               int(st.dropped))
    maxL = st.max_size_log2
    for key, value in zip(keys.tolist(), values.tolist()):
        # one rehash step: migrate_batch slots, live ones into the new table
        end = min(ptr + migrate_batch, 1 << oL) if migrating else ptr
        for i in range(ptr, end):
            k = int(ok_[i])
            if k != EMPTY_SENTINEL:
                nc += probe_put(nk, nv, k, int(ov[i]), nL)[0]
                ok_[i] = EMPTY_SENTINEL
                oc -= 1
        ptr = end
        migrating = migrating and ptr < (1 << oL)
        if (_over_threshold(nc + oc, nL, load_threshold) and not migrating
                and nL < maxL):
            # start a migration: the new table becomes the old one
            ok_[:1 << nL], ov[:1 << nL] = nk[:1 << nL], nv[:1 << nL]
            nk[:1 << nL], nv[:1 << nL] = EMPTY_SENTINEL, 0
            oL, nL, oc, nc, ptr, migrating = nL, nL + 1, nc, 0, 0, True
        inew, ok = probe_put(nk, nv, key, value, nL)
        nc += inew
        dropped += int(not ok)
    for t, x in ((st.old_log2, oL), (st.new_log2, nL), (st.old_count, oc),
                 (st.new_count, nc), (st.migrate_ptr, ptr),
                 (st.migrating, migrating), (st.dropped, dropped)):
        t.fill_(x)


def hti_insert_many(st: HTIState, keys, values, migrate_batch: int = 64,
                    load_threshold: float = 0.35) -> HTIState:
    """Sequential batch insert; returns the new state, ``st`` unchanged."""
    if migrate_batch < 1:
        raise ValueError("migrate_batch must be at least 1")
    dev = st.new_keys.device
    k, v = _batch(keys, values, dev)
    out = _clone(st)
    if dev.type == "cuda":
        kern.hti_insert_(out, k, v, load_threshold, migrate_batch)
    else:
        _hti_insert_host(out, _u32(k), _u32(v), load_threshold,
                         migrate_batch)
    return out


def hti_insert(st: HTIState, key, value, load_threshold: float = 0.35,
               migrate_batch: int = 64) -> HTIState:
    return hti_insert_many(st, [int(key)], [int(value)], migrate_batch,
                           load_threshold)


def _hti_find(st: HTIState, q: torch.Tensor, old_log2: int, new_log2: int,
              new_first: bool) -> torch.Tensor:
    from_new = _probe_find(st.new_keys, st.new_vals, q, new_log2)
    from_old = _probe_find(st.old_keys, st.old_vals, q, old_log2)
    first, second = (from_new, from_old) if new_first else (from_old,
                                                            from_new)
    return torch.where(first != MISS_BITS, first, second)


def hti_lookup_plain(st: HTIState, keys) -> torch.Tensor:
    """The kernel's plain version, on the state's device."""
    oL, nL = int(st.old_log2), int(st.new_log2)
    new_first = int(st.new_count) >= int(st.old_count)
    return _chunked(lambda q: _hti_find(st, q, oL, nL, new_first), keys,
                    st.new_keys.device)


def hti_lookup_many(st: HTIState, keys) -> torch.Tensor:
    """Probe the fuller table first, then the other (paper §4.2)."""
    if st.new_keys.device.type == "cuda":
        return look.hti_lookup(st, keys)
    return hti_lookup_plain(st, keys)


def hti_lookup(st: HTIState, key) -> torch.Tensor:
    return hti_lookup_many(st, [int(key)])[0]


# ---------------------------------------------------------------------------
# CH: chained hashing over fixed buckets.
# ---------------------------------------------------------------------------

class CHState(NamedTuple):
    heads: torch.Tensor        # (table_size,) int32 chain head bucket or -1
    bucket_keys: torch.Tensor  # (capacity, bucket_slots) uint32
    bucket_vals: torch.Tensor  # (capacity, bucket_slots) uint32
    next_bucket: torch.Tensor  # (capacity,) int32 link or -1
    counts: torch.Tensor       # (capacity,) int32
    num_buckets: torch.Tensor  # () int32
    dropped: torch.Tensor      # () int32

    @property
    def table_log2(self) -> int:
        return int(self.heads.shape[0]).bit_length() - 1


def ch_create(table_log2: int, capacity: int, bucket_slots: int = 16, *,
              device=None) -> CHState:
    dev = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    return CHState(
        heads=torch.full((1 << table_log2,), -1, **i32),
        bucket_keys=hashing.full((capacity, bucket_slots), EMPTY_SENTINEL,
                                 torch.uint32, dev),
        bucket_vals=hashing.full((capacity, bucket_slots), 0, torch.uint32,
                                 dev),
        next_bucket=torch.full((capacity,), -1, **i32),
        counts=torch.zeros((capacity,), **i32),
        num_buckets=_i32(0, dev), dropped=_i32(0, dev))


def _ch_insert_host(st: CHState, keys: np.ndarray,
                    values: np.ndarray) -> None:
    heads, nxt, counts = (a.numpy() for a in (st.heads, st.next_bucket,
                                              st.counts))
    bk, bv = _u32(st.bucket_keys), _u32(st.bucket_vals)
    C, S = bk.shape
    T = st.table_log2
    nb, dropped = int(st.num_buckets), int(st.dropped)
    for key, value in zip(keys.tolist(), values.tolist()):
        h = hashing.hash_dir_host(key)
        slot = h >> (32 - T) if T else 0
        tail = int(heads[slot])
        while tail >= 0 and nxt[tail] >= 0:
            tail = int(nxt[tail])
        if tail >= 0 and counts[tail] < S:     # append, no duplicate check
            bk[tail, counts[tail]] = key
            bv[tail, counts[tail]] = value
            counts[tail] += 1
        elif nb < C:                           # a new bucket, linked in
            bk[nb, 0], bv[nb, 0], counts[nb] = key, value, 1
            if tail < 0:
                heads[slot] = nb
            else:
                nxt[tail] = nb
            nb += 1
        else:
            dropped += 1
    st.num_buckets.fill_(nb)
    st.dropped.fill_(dropped)


def ch_insert_many(st: CHState, keys, values) -> CHState:
    """Sequential batch insert; returns the new state, ``st`` unchanged."""
    dev = st.heads.device
    k, v = _batch(keys, values, dev)
    out = _clone(st)
    if dev.type == "cuda":
        kern.ch_insert_(out, k, v)
    else:
        _ch_insert_host(out, _u32(k), _u32(v))
    return out


def ch_insert(st: CHState, key, value) -> CHState:
    return ch_insert_many(st, [int(key)], [int(value)])


def _ch_find(st: CHState, q: torch.Tensor) -> torch.Tensor:
    """Walk every chain at once until each key has hit or reached -1.  A
    bucket row is searched whole (no probe order): the first slot equal to
    the key wins, so the EMPTY pattern finds an unused slot.  A key stops
    at its first hit (the reference's loop would not end on a stored value
    equal to MISS)."""
    bk, bv = hashing.bits(st.bucket_keys), hashing.bits(st.bucket_vals)
    slot = dir_slot(hash_dir(q), st.table_log2).long()
    cur = st.heads[slot].long()
    val = torch.full_like(q, MISS_BITS)
    live = cur >= 0
    while bool(live.any()):
        idx = live.nonzero().squeeze(1)
        b = cur[idx]
        hit = bk[b] == q[idx].unsqueeze(1)
        found = hit.any(1)
        j = hit.to(torch.int32).argmax(1)
        val[idx[found]] = bv[b[found], j[found]]
        cur[idx] = torch.where(found, b, st.next_bucket[b].long())
        live[idx] = ~found & (cur[idx] >= 0)
    return val


def ch_lookup_plain(st: CHState, keys) -> torch.Tensor:
    """The kernel's plain version, on the state's device."""
    return _chunked(lambda q: _ch_find(st, q), keys, st.heads.device)


def ch_lookup_many(st: CHState, keys) -> torch.Tensor:
    if st.heads.device.type == "cuda":
        return look.ch_lookup(st, keys)
    return ch_lookup_plain(st, keys)


def ch_lookup(st: CHState, key) -> torch.Tensor:
    return ch_lookup_many(st, [int(key)])[0]

