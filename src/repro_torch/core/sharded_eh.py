"""Sharded Shortcut-EH: the paper's index partitioned for scale (twin of
``repro/core/sharded_eh.py``).

The key space is partitioned by the **top ``log2(N)`` bits of the directory
hash** into N shards, each a full :class:`~repro_torch.core.shortcut_eh.ShortcutEH`
(own bucket pool, directory, composed view and mapper) in a
:class:`~repro_torch.runtime.shard_group.MapperGroup`.  As the directory
uses MSB indexing, the shard-local directories are the N contiguous slices
of the one directory a flat index would build, so a sharded index answers
every lookup exactly as a flat one over the same trace.

  * **Shard-local maintenance**: splits, doublings, replays, version gates
    and route decisions touch one shard's mapper.
  * **One-launch batched lookup** (:meth:`ShardedShortcutEH.lookup_batched`):
    a key batch is bucketized per shard by one stable sort on the device,
    padded to a per-shard capacity from a bounded set, resolved by one
    kernel launch over all shards, and scattered back to input order.  The
    stacked operands live in a :class:`StackedOperandCache`: replays publish
    each shard's view slice into the "eh_view" stack before its
    ``sc_version`` moves, and the "eh_trad" stack is built by the first
    traditional lookup and kept warm by inserts.  All-shortcut batches take
    ``sharded_shortcut_lookup``, all-traditional ones ``sharded_eh_lookup``,
    and mixed ones ``sharded_routed_lookup``: a shard whose gate refuses no
    longer demotes the others.

``num_shards=1`` degenerates to the flat index, and ``lookup`` delegates to
the one :class:`ShortcutEH`.

Skew: within shard s every key shares its top ``shard_bits`` hash bits, so
the first ``shard_bits`` doublings of a shard's directory are degenerate.
Budget ``max_global_depth`` per shard as the flat depth (so each shard's
fan-in is about N times the flat one's).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import extendible_hashing as eh
from repro_torch.core import hashing
from repro_torch.core.shortcut_eh import ShortcutEH
from repro_torch.device import resolve_device
from repro_torch.kernels.eh_lookup import (sharded_eh_lookup,
                                           sharded_routed_lookup,
                                           sharded_shortcut_lookup)
from repro_torch.runtime.mapper import GLOBAL_VIEW, MaintenanceStats
from repro_torch.runtime.operand_cache import StackedOperandCache
from repro_torch.runtime.shard_group import (MapperGroup, pad_batch,
                                             partition_by_shard, shard_order)

__all__ = ["ShardedShortcutEH", "partition_by_shard", "shard_of_keys",
           "shard_order"]


def shard_of_keys(keys, shard_bits: int) -> torch.Tensor:
    """Shard index per key (int64, on the keys' device): the top
    ``shard_bits`` of the directory hash."""
    k = hashing.bits(keys)
    if shard_bits == 0:
        return torch.zeros(k.shape, dtype=torch.int64, device=k.device)
    return hashing.hash_dir(k) >> (32 - shard_bits)


def _trad_parts(states):
    """Operand-cache parts of the traditional family: one shard's
    ``(directory, bucket_keys, bucket_vals, global_depth)`` from the
    consistent per-shard state snapshots.  Shapes are static (the directory
    is allocated at ``max_global_depth``), so this family never re-stacks
    after its first build."""
    def parts(s):
        st = states[s]
        return (st.directory, st.bucket_keys, st.bucket_vals,
                st.global_depth)
    return parts


class ShardedShortcutEH:
    """N-way partitioned Shortcut-EH behind the flat index's API.

    Each shard's ``capacity``/``max_global_depth``/``bucket_slots`` are the
    constructor's (capacity is per shard, so the sharded index drops no key
    the flat one keeps).  ``device`` defaults to ``"cuda"``.
    """

    def __init__(self, max_global_depth: int, bucket_slots: int,
                 capacity: int, *, num_shards: int = 1,
                 fan_in_threshold: float = 8.0,
                 poll_interval: float = 0.025, async_mapper: bool = False,
                 routing_factory=None, device=None):
        if num_shards < 1 or num_shards & (num_shards - 1):
            raise ValueError(f"num_shards must be a power of two, "
                             f"got {num_shards}")
        self.device = resolve_device(device)
        self.num_shards = num_shards
        self.shard_bits = num_shards.bit_length() - 1
        self.shards = [
            ShortcutEH(max_global_depth, bucket_slots, capacity,
                       fan_in_threshold=fan_in_threshold,
                       poll_interval=poll_interval,
                       async_mapper=async_mapper,
                       routing=(routing_factory(i) if routing_factory
                                else None),
                       device=self.device)
            for i in range(num_shards)]
        self.group = MapperGroup(
            [s.mapper for s in self.shards],
            router=lambda key: int(shard_of_keys([key], self.shard_bits)[0]))
        # primary storage of the stacked lookup operands ("eh_view",
        # "eh_trad"): replays publish their shard's slice at publish time,
        # so the batched lookup is an epoch check + handle return
        self.operands = StackedOperandCache(num_shards)
        for i, s in enumerate(self.shards):
            s.bind_operand_cache(self.operands, i)

    # -- routing -------------------------------------------------------------

    def shard_of(self, keys) -> torch.Tensor:
        """Vectorized key -> shard index (top hash bits)."""
        return shard_of_keys(hashing.bits(keys, device=self.device),
                             self.shard_bits)

    def _empty(self) -> torch.Tensor:
        return hashing.full((0,), 0, torch.uint32, self.device)

    def _partition(self, keys: torch.Tensor):
        """One stable sort on the device and one host read (the counts):
        ``(padded, sid, order, rank, counts)``, ``counts`` a host list."""
        sid = shard_of_keys(keys, self.shard_bits)
        order, counts, starts = shard_order(sid, self.num_shards)
        counts_host = counts.tolist()
        padded, _, order, rank = partition_by_shard(
            keys, sid, self.num_shards, pad_batch(max(counts_host)),
            order=order, counts=counts, starts=starts)
        return padded, sid, order, rank, counts_host

    @staticmethod
    def _scatter_back(res: torch.Tensor, sid, order, rank) -> torch.Tensor:
        """``out[order] = res[sid[order], rank]`` on int32 bit views."""
        out = torch.empty(order.numel(), dtype=torch.int32,
                          device=res.device)
        out[order] = hashing.bits(res)[sid[order], rank]
        return hashing.from_bits(out)

    # -- main-thread API ----------------------------------------------------

    def insert(self, keys, values) -> None:
        """Partition the batch and insert into each owning shard, in input
        order within a shard.  Strictly shard-local: each sub-insert takes
        only its shard's lock, version and queue."""
        keys = hashing.bits(keys, device=self.device).reshape(-1)
        values = hashing.bits(values, device=self.device).reshape(-1)
        if self.num_shards == 1:
            self.shards[0].insert(keys, values)
            return
        sid = shard_of_keys(keys, self.shard_bits)
        order, counts, starts = shard_order(sid, self.num_shards)
        for s, (c, b) in enumerate(zip(counts.tolist(), starts.tolist())):
            if c:
                idx = order[b:b + c]
                self.shards[s].insert(keys[idx], values[idx])

    def lookup(self, keys) -> torch.Tensor:
        """Routed lookup in input order: each shard takes its shortcut
        (the stacked kernel) or its traditional path per its own gate."""
        keys = hashing.bits(keys, device=self.device).reshape(-1)
        if keys.numel() == 0:
            return self._empty()
        if self.num_shards == 1:
            return self.shards[0].lookup(keys)
        padded, sid, order, rank, counts = self._partition(keys)
        results = torch.empty(padded.shape, dtype=torch.int32,
                              device=self.device)
        for s in range(self.num_shards):
            if counts[s]:
                results[s] = hashing.bits(self.shards[s].lookup(padded[s]))
        return self._scatter_back(results, sid, order, rank)

    def lookup_batched(self, keys, *, tile: int = 256) -> torch.Tensor:
        """Fused cross-shard lookup: ONE kernel launch for all shards, fed
        from the stacked operand cache.  Returns values in input order.

        Each shard routes independently (its own gate, its own view): an
        all-shortcut batch takes the shortcut kernel, an all-traditional one
        the traditional kernel, a mixed one the per-shard routed kernel."""
        keys = hashing.bits(keys, device=self.device).reshape(-1)
        if keys.numel() == 0:
            # no padding, no operand refresh, no launch, no route counters
            return self._empty()
        padded, sid, order, rank, counts = self._partition(keys)
        # Gate every shard FIRST (each policy decides exactly once), then
        # read the publish epochs, then the states: replays publish into
        # the stack BEFORE bumping view_epoch and BEFORE sc_version, so any
        # view a gate certifies is already resident at a covering epoch and
        # get("eh_view", epochs) is a pure epoch check.  The traditional
        # family stays pull-mode, built from state snapshots read AFTER the
        # epochs (an epoch can only under-describe its snapshot).
        gates = [s.mapper.gate(s.avg_fan_in(), [GLOBAL_VIEW])
                 for s in self.shards]
        view_epochs = [s.view_epoch for s in self.shards]
        state_epochs = [s.state_epoch for s in self.shards]
        states = [s.state for s in self.shards]
        pub = self.operands.published("eh_view")
        shortcut_ok = [g and pub is not None and pub[i]
                       for i, g in enumerate(gates)]
        involved = [s for s, c in enumerate(counts) if c]
        for s in involved:
            self.group.count_route(shortcut_ok[s], shard=s)
        n_sc = sum(1 for s in involved if shortcut_ok[s])
        if n_sc:
            view_ops = self.operands.get("eh_view", view_epochs)
        if n_sc < len(involved):
            trad_ops = self.operands.get(
                "eh_trad", state_epochs, _trad_parts(states))
        if n_sc == len(involved):
            res = sharded_shortcut_lookup(padded, *view_ops, tile=tile)
        elif n_sc == 0:
            res = sharded_eh_lookup(padded, *trad_ops, tile=tile)
        else:
            flags = torch.tensor([0 if ok else 1 for ok in shortcut_ok],
                                 dtype=torch.int32, device=self.device)
            res = sharded_routed_lookup(padded, *trad_ops, *view_ops, flags,
                                        tile=tile)
        return self._scatter_back(res, sid, order, rank)

    # -- aggregated bookkeeping ----------------------------------------------

    @property
    def stats(self) -> MaintenanceStats:
        return self.group.stats

    def per_shard_stats(self) -> list:
        return self.group.per_shard_stats()

    @property
    def routed_shortcut(self) -> int:
        return self.group.routed_shortcut

    @property
    def routed_traditional(self) -> int:
        return self.group.routed_fallback

    def num_entries(self) -> int:
        return sum(int(eh.eh_num_entries(s.state)) for s in self.shards)

    def avg_fan_in(self) -> float:
        return float(np.mean([s.avg_fan_in() for s in self.shards]))

    def in_sync(self) -> bool:
        return all(s.in_sync() for s in self.shards)

    def pump(self, max_requests: int = 1 << 30) -> int:
        return self.group.pump(max_requests)

    def wait_in_sync(self, timeout: float = 30.0) -> bool:
        return self.group.wait_in_sync(timeout=timeout)

    def close(self) -> None:
        self.group.close()

    # -- verification --------------------------------------------------------

    def check_invariants(self) -> dict:
        """Per-shard structural invariants I1–I5 plus the cross-shard S1:
        every live key is stored in the shard its hash routes to."""
        out = {"ok": True, "errors": [], "shards": []}
        for s, shard in enumerate(self.shards):
            st = shard.state
            rep = eh.check_invariants(st)
            out["shards"].append(rep)
            if not rep["ok"]:
                out["ok"] = False
                out["errors"] += [f"shard {s}: {e}" for e in rep["errors"]]
            bk = hashing.bits(st.bucket_keys[:int(st.num_buckets)])
            live = bk[bk != hashing.EMPTY_BITS]
            if live.numel():
                owners = shard_of_keys(live, self.shard_bits)
                if not bool((owners == s).all()):
                    foreign = hashing.u32(live[owners != s][:4]).tolist()
                    out["ok"] = False
                    out["errors"].append(
                        f"S1: shard {s} holds foreign keys {foreign}")
        return out

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
