"""Sharded shortcut runtime: a group of independent mappers (twin of
``repro/runtime/shard_group.py``).

:class:`MapperGroup` owns N :class:`~repro_torch.runtime.mapper.ShortcutMapper`
instances with **independent** queues, versions, routing policies, locks and
(in async mode) threads, plus:

  * a **key → shard router** (client-supplied; Sharded-EH routes on the top
    bits of the directory hash);
  * an optional :class:`ShardViewRegistry` — per-shard atomically swapped
    view tuples, standalone or as a facade of a stacked operand cache;
  * **aggregated** :class:`~repro_torch.runtime.mapper.MaintenanceStats` and
    route counters across the group; batch-level route decisions that span
    shards land on a **group-level** counter;
  * group-wide ``pump()`` / ``wait_in_sync()`` / ``close()`` and the sharded
    version gate :meth:`MapperGroup.in_sync` / :meth:`MapperGroup.gate`,
    keyed by ``{shard: view keys}``.

The members share no state: one shard's create can never collapse, gate or
serialize behind another shard's updates.

This module also owns the **cross-shard batching** helpers every sharded
client shares (:func:`shard_order`, :func:`partition_by_shard`,
:func:`pad_batch`): one stable sort bucketizes a batch per shard, each
shard's sub-batch is padded to a capacity from a bounded size set, and the
returned permutation scatters per-shard results back to input order.  They
work on tensors on the index's device; the order is numpy's stable argsort.
"""
from __future__ import annotations

import time
from dataclasses import fields
from typing import (Callable, Dict, Hashable, Iterable, List, Optional,
                    Sequence)

import torch

from repro_torch.core import hashing
from repro_torch.runtime.mapper import MaintenanceStats, ShortcutMapper

#: ``{shard index: view keys}``; ``None`` values mean "all keys of that shard"
KeysByShard = Dict[int, Optional[Iterable[Hashable]]]

#: Static per-shard batch capacities, as in the JAX package (where the
#: bounded set bounds the number of jit variants)
_BATCH_SIZES = (64, 256, 1024, 4096, 16384, 65536, 262144)


def pad_batch(n: int) -> int:
    """Smallest capacity from :data:`_BATCH_SIZES` holding ``n`` (multiples
    of the largest beyond it)."""
    for c in _BATCH_SIZES:
        if n <= c:
            return c
    return -(-n // _BATCH_SIZES[-1]) * _BATCH_SIZES[-1]


def shard_order(sid, num_shards: int):
    """The one stable sort every batched operation shares: returns
    ``(order, counts, starts)`` as int64 tensors on ``sid``'s device —
    shard-sort permutation, per-shard key counts, and each shard's offset
    in the sorted order."""
    sid = torch.as_tensor(sid).to(torch.int64)
    order = torch.sort(sid, stable=True).indices
    counts = torch.bincount(sid, minlength=num_shards)
    starts = torch.zeros(num_shards, dtype=torch.int64, device=sid.device)
    starts[1:] = torch.cumsum(counts[:-1], 0)
    return order, counts, starts


def partition_by_shard(keys: torch.Tensor, sid, num_shards: int, cap: int,
                       fill: int = 0, *, order=None, counts=None,
                       starts=None):
    """Bucketize ``keys`` per shard (via :func:`shard_order`, reused when the
    caller already ran it to size ``cap``).

    Returns ``(padded, counts, order, rank)``: ``padded`` is
    ``(num_shards, cap)`` of ``keys``' dtype with shard s's keys in
    ``padded[s, :counts[s]]`` and ``fill`` elsewhere; input element
    ``order[i]`` sits at ``padded[sid[order][i], rank[i]]``, so per-shard
    results scatter back with ``out[order] = results[sid[order], rank]``.
    """
    sid = torch.as_tensor(sid).to(torch.int64)
    if order is None or counts is None or starts is None:
        order, counts, starts = shard_order(sid, num_shards)
    sid_sorted = sid[order]
    rank = torch.arange(keys.numel(), dtype=torch.int64,
                        device=keys.device) - starts[sid_sorted]
    padded = hashing.full((num_shards, cap), fill, keys.dtype, keys.device)
    hashing.storage_view(padded)[sid_sorted, rank] = \
        hashing.storage_view(keys)[order]
    return padded, counts, order, rank


class ShardViewRegistry:
    """Per-shard, atomically published shortcut view tuples.

    **Standalone** (``cache=None``): each slot holds ONE tuple of tensors (or
    ``None`` before the first publication).  :meth:`publish` is a single
    list-item store and :meth:`snapshot` a single list-item load — both
    atomic under the GIL — so a reader never pairs tensors from two
    publications of the same shard.

    **Cache-backed** (``cache=`` a
    :class:`~repro_torch.runtime.operand_cache.StackedOperandCache`): the
    registry owns no tensors and is a per-shard facade of one stacked
    family — :meth:`publish` writes the shard's slice into the stack at the
    caller's client epoch and :meth:`snapshot` returns the cache's memoized
    slice.  A slice tuple is drawn from ONE atomically swapped stacked tuple.

    One writer per slot (the shard's mapper thread or the ``pump()``
    caller, serialized by the mapper's replay mutex); no cross-shard lock.
    """

    def __init__(self, num_shards: int, *, cache=None,
                 family: str = "kv_view"):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self._n = num_shards
        self._cache = cache
        self._family = family
        if cache is None:
            self._views: List[Optional[tuple]] = [None] * num_shards
            # bumped AFTER the tuple store: a reader that reads the epoch
            # first and snapshots second can at worst record a newer tuple
            # under an older epoch (a redundant refresh, never stale)
            self._epochs: List[int] = [0] * num_shards
        elif cache.num_shards != num_shards:
            raise ValueError(f"cache has {cache.num_shards} shards, "
                             f"registry asked for {num_shards}")

    def __len__(self) -> int:
        return self._n

    def publish(self, shard: int, arrays: Iterable, *,
                epoch: Optional[int] = None) -> None:
        """Publish shard ``shard``'s view tuple.  Standalone: atomic tuple
        swap, then bump the internal epoch (``epoch`` is ignored).
        Cache-backed: one publish into the stacked family at the client
        ``epoch`` (required)."""
        if self._cache is not None:
            if epoch is None:
                raise ValueError("cache-backed registry publications "
                                 "must carry the client epoch")
            self._cache.publish(self._family, shard, tuple(arrays),
                                epoch=epoch)
            return
        self._views[shard] = tuple(arrays)
        self._epochs[shard] += 1

    def epoch(self, shard: int) -> int:
        """Shard's publish epoch; read BEFORE :meth:`snapshot`."""
        return self.epochs()[shard]

    def epochs(self) -> List[int]:
        """All shards' publish epochs (copied; read before snapshots)."""
        if self._cache is not None:
            eps = self._cache.epochs(self._family)
            return [0] * self._n if eps is None else eps
        return list(self._epochs)

    def snapshot(self, shard: int) -> Optional[tuple]:
        """One consistent view tuple (or None).  Cache-backed: the memoized
        slice of the stack."""
        if self._cache is not None:
            return self._cache.slice_of(self._family, shard)
        return self._views[shard]

    def snapshot_all(self) -> list:
        """Per-shard snapshots, each internally consistent."""
        return [self.snapshot(s) for s in range(self._n)]

    def arrays(self, shard: int) -> tuple:
        """Population target for the runtime's ``view_arrays`` hook: the
        shard's current tensors, or () before the first publication.
        Cache-backed: the stacked family itself."""
        if self._cache is not None:
            return self._cache.handle(self._family) or ()
        v = self._views[shard]
        return () if v is None else v


class MapperGroup:
    """N independent shortcut mappers + a router, presented as one unit.

    ``mappers`` are the members, one per shard, in shard order (the group
    takes ownership: ``close()`` closes all).  ``router`` is ``f(key) ->
    shard`` for single keys (optional; :meth:`route` raises without it).
    ``views`` is an optional :class:`ShardViewRegistry` of the members'
    replays.
    """

    def __init__(self, mappers: Sequence[ShortcutMapper], *,
                 router: Optional[Callable[[Hashable], int]] = None,
                 views: Optional[ShardViewRegistry] = None):
        if not mappers:
            raise ValueError("MapperGroup needs at least one mapper")
        if views is not None and len(views) != len(mappers):
            raise ValueError(
                f"view registry has {len(views)} slots for "
                f"{len(mappers)} mappers")
        self.mappers = list(mappers)
        self._router = router
        self.views = views
        # batch-level decisions spanning shards (shard=None in count_route)
        # land here, not on an arbitrary member
        self._routed_shortcut_group = 0
        self._routed_fallback_group = 0

    # -- container protocol --------------------------------------------------

    def __len__(self) -> int:
        return len(self.mappers)

    def __getitem__(self, shard: int) -> ShortcutMapper:
        return self.mappers[shard]

    def __iter__(self):
        return iter(self.mappers)

    # -- routing -------------------------------------------------------------

    def route(self, key: Hashable) -> int:
        """Shard index owning ``key`` (via the client's router)."""
        if self._router is None:
            raise ValueError("MapperGroup was built without a router")
        shard = int(self._router(key))
        if not 0 <= shard < len(self.mappers):
            raise IndexError(f"router sent key {key!r} to shard {shard} "
                             f"of {len(self.mappers)}")
        return shard

    def mapper_for(self, key: Hashable) -> ShortcutMapper:
        return self.mappers[self.route(key)]

    # -- aggregated bookkeeping ----------------------------------------------

    @property
    def stats(self) -> MaintenanceStats:
        """Sum of all members' stats (a fresh object; mutate the per-shard
        ``group[i].stats`` instances, never this one)."""
        agg = MaintenanceStats()
        for m in self.mappers:
            for f in fields(MaintenanceStats):
                setattr(agg, f.name,
                        getattr(agg, f.name) + getattr(m.stats, f.name))
        return agg

    def per_shard_stats(self) -> list:
        return [m.stats for m in self.mappers]

    @property
    def routed_shortcut(self) -> int:
        return self._routed_shortcut_group + \
            sum(m.routed_shortcut for m in self.mappers)

    @property
    def routed_fallback(self) -> int:
        return self._routed_fallback_group + \
            sum(m.routed_fallback for m in self.mappers)

    def count_route(self, used_shortcut: bool,
                    shard: Optional[int] = None) -> None:
        """Count one routed batch: on ``shard`` when the decision belongs to
        one shard, else (``shard=None``) on the group-level counter."""
        if shard is None:
            if used_shortcut:
                self._routed_shortcut_group += 1
            else:
                self._routed_fallback_group += 1
        else:
            self.mappers[shard].count_route(used_shortcut)

    # -- sharded version gate ------------------------------------------------

    def in_sync(self, keys_by_shard: Optional[KeysByShard] = None) -> bool:
        """True when every involved shard's views are caught up
        (``None``: all keys of all shards)."""
        if keys_by_shard is None:
            return all(m.in_sync() for m in self.mappers)
        return all(self.mappers[s].in_sync(keys)
                   for s, keys in keys_by_shard.items())

    def gate(self, metric: float,
             keys_by_shard: Optional[KeysByShard] = None) -> bool:
        """Version gate across the involved shards AND every involved
        shard's routing policy accepting ``metric``.  Distinct policy
        *objects* each decide exactly once, without short-circuiting: a
        policy shared by several shards sees one state transition per gate."""
        shards = (range(len(self.mappers)) if keys_by_shard is None
                  else sorted(keys_by_shard))
        if not self.in_sync(keys_by_shard):
            return False
        policies, seen = [], set()
        for s in shards:
            p = self.mappers[s].routing
            if id(p) not in seen:
                seen.add(id(p))
                policies.append(p)
        decisions = [bool(p.decide(metric)) for p in policies]
        return all(decisions)

    # -- group-wide maintenance ----------------------------------------------

    def pump(self, max_requests: int = 1 << 30) -> int:
        """Synchronously drain every shard's queue (mapper surrogate)."""
        return sum(m.pump(max_requests) for m in self.mappers)

    def wait_in_sync(self, keys_by_shard: Optional[KeysByShard] = None,
                     timeout: float = 30.0) -> bool:
        """Block until the involved shards caught up; one shared deadline
        across the group (not ``timeout`` per shard)."""
        deadline = time.monotonic() + timeout
        shards = (range(len(self.mappers)) if keys_by_shard is None
                  else sorted(keys_by_shard))
        ok = True
        for s in shards:
            keys = None if keys_by_shard is None else keys_by_shard[s]
            left = deadline - time.monotonic()
            ok &= self.mappers[s].wait_in_sync(keys, max(0.0, left))
        return ok

    def close(self) -> None:
        for m in self.mappers:
            m.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
