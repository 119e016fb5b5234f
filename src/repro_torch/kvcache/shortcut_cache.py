"""Shortcut KV view: the paper's technique applied to the serving layer (twin
of ``repro/kvcache/shortcut_cache.py``).

The paged cache reads through *two* indirections (block table, then block
gather).  The shortcut view pre-composes that mapping into a contiguous
per-sequence layout, ``view[l, s, t] = pool[l, table[s, t // bs], t % bs]``,
so a decode step reads it with address arithmetic alone.  This is
``rewiring.compose`` at the KV granularity, maintained by the same runtime
as Shortcut-EH: the paged cache stays authoritative and synchronous; the
view is replayed from a FIFO of *update* (append a token row) and *create*
(re-linearize a sequence) requests, populated before publication,
version-gated per sequence, and a fragmentation statistic decides routing
(:class:`~repro_torch.runtime.mapper.FragmentationRouting`).

**Sharded mode** (``num_shards > 1``): sequences partition across a
:class:`~repro_torch.runtime.shard_group.MapperGroup` by ``seq_id % N``;
shard ``s`` owns the view rows of its sequences (shard-local row
``seq_id // N``).  The primary storage is one stacked ``(N, L,
seqs_per_shard, S_cap, KV, hd)`` k/v pair held by a
:class:`~repro_torch.runtime.operand_cache.StackedOperandCache` (family
"kv_view"), whose publish is copy-on-write: an installed stack is never
written, so a reader's handle never changes under it.

**Replays write in place into one private clone.**  The JAX replay chains
the functional :func:`compose_seq` / :func:`append_to_view`, each of which
makes a new view.  Here a replay clones its shard's slice once, writes every
request of its batch into that clone in place, and publishes it (the
publish clones the stack once more).  The functional entry points stay, and
each clones the view it is given.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kvcache import paged_cache as pc
from repro_torch.runtime.mapper import FragmentationRouting, ShortcutMapper
from repro_torch.runtime.operand_cache import StackedOperandCache
from repro_torch.runtime.shard_group import MapperGroup, ShardViewRegistry


# -- functional core ---------------------------------------------------------

def _compose_into(cache: pc.PagedKVCache, view_k: torch.Tensor,
                  view_v: torch.Tensor, seq_id: int, row: int) -> None:
    """Linearize sequence ``seq_id`` into ``view_*[:, row]``, in place.

    Positions at or past the sequence's length are written as zeros, not
    whatever the pool holds there (unset table entries read block 0, and a
    partial last block holds stale rows), so the composed row is a function
    of the sequence's content alone."""
    cap = view_k.shape[2]
    bs = cache.block_size
    table = cache.block_tables[seq_id].clamp_min(0).long()
    table = table[:-(-cap // bs)]                 # the blocks the view holds
    L, kv_shape = cache.num_layers, cache.k_pool.shape[3:]
    live = (torch.arange(cap, device=view_k.device)
            < cache.seq_lens[seq_id])[:, None, None]
    for view, pool in ((view_k, cache.k_pool), (view_v, cache.v_pool)):
        lin = pool[:, table].reshape(L, -1, *kv_shape)[:, :cap]
        view[:, row] = torch.where(live, lin, torch.zeros((), dtype=lin.dtype,
                                                          device=lin.device))


def _append_into(view_k: torch.Tensor, view_v: torch.Tensor, rows,
                 positions, new_k: torch.Tensor, new_v: torch.Tensor) -> None:
    """Write one token row per sequence at (rows, positions), in place."""
    dev = view_k.device
    rows = torch.as_tensor(rows, device=dev).long()
    positions = torch.as_tensor(positions, device=dev).long()
    view_k[:, rows, positions] = new_k.to(view_k.dtype)
    view_v[:, rows, positions] = new_v.to(view_v.dtype)


def compose_seq(cache: pc.PagedKVCache, view_k: torch.Tensor,
                view_v: torch.Tensor, seq_id: int, row: int):
    """Create-request replay: linearize one sequence into its shard's view.

    view_k/view_v: (L, rows_per_shard, S_cap, KV, hd); ``seq_id`` indexes
    the authoritative cache, ``row`` the shard-local view row owning it
    (``seq_id // num_shards``).  Returns new views; positions at or past the
    sequence's length are zeros."""
    view_k, view_v = view_k.clone(), view_v.clone()
    _compose_into(cache, view_k, view_v, int(seq_id), int(row))
    return view_k, view_v


def append_to_view(view_k: torch.Tensor, view_v: torch.Tensor, rows,
                   positions, new_k: torch.Tensor, new_v: torch.Tensor):
    """Update-request replay: write one token row per sequence at the given
    shard-local rows.  new_k/new_v: (L, B, KV, hd).  Returns new views."""
    view_k, view_v = view_k.clone(), view_v.clone()
    _append_into(view_k, view_v, rows, positions, new_k, new_v)
    return view_k, view_v


def slice_context(view_k: torch.Tensor, view_v: torch.Tensor, rows):
    """The shortcut access path: a gather on the *row* axis only.
    Returns (L, B, KV, S, hd)."""
    rows = torch.as_tensor(rows, device=view_k.device).long()
    return (view_k[:, rows].permute(0, 1, 3, 2, 4),
            view_v[:, rows].permute(0, 1, 3, 2, 4))


def stacked_context(stack_k: torch.Tensor, stack_v: torch.Tensor, sid,
                    rows):
    """:func:`slice_context` on the stacked primary ``(N, L, rows, S_cap,
    KV, hd)``: one two-axis gather in input order.  Returns (L, B, KV, S,
    hd)."""
    dev = stack_k.device
    sid = torch.as_tensor(sid, device=dev).long()
    rows = torch.as_tensor(rows, device=dev).long()
    return (stack_k[sid, :, rows].permute(1, 0, 3, 2, 4),
            stack_v[sid, :, rows].permute(1, 0, 3, 2, 4))


# -- host orchestration ------------------------------------------------------

class ShortcutKVManager:
    """Maintains the shortcut view alongside an authoritative paged cache, a
    thin client of the (sharded) shortcut-maintenance runtime.

    A read routes through the shortcut only when every sequence in the
    batch is in sync *and* the batch fragmentation is at least
    ``frag_threshold``.  ``num_shards`` partitions sequences across
    independent mappers and view slices (``seq_id % num_shards``, row
    ``seq_id // num_shards``).  ``device`` (default ``"cuda"``) must be the
    cache's.
    """

    def __init__(self, cache: pc.PagedKVCache, seq_capacity: int, *,
                 frag_threshold: float = 0.25, poll_interval: float = 0.025,
                 async_mapper: bool = False, routing=None,
                 num_shards: int = 1, device=None):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        dev = resolve_device(device)
        if cache.device.type != dev.type:
            raise ValueError(f"cache on {cache.device}, manager on {dev}")
        L, _, bs, KV, hd = cache.k_pool.shape
        max_seqs = cache.block_tables.shape[0]
        self.cache = cache
        self.num_shards = num_shards
        self.seqs_per_shard = -(-max_seqs // num_shards)
        self.operands = StackedOperandCache(num_shards)
        self.views = ShardViewRegistry(num_shards, cache=self.operands,
                                       family="kv_view")
        zero = torch.zeros((L, self.seqs_per_shard, seq_capacity, KV, hd),
                           dtype=cache.k_pool.dtype, device=cache.device)
        # every shard seeded published-at-zero: the all-zero view is a valid
        # (empty) publication, so first replays take the update path
        self.operands.seed("kv_view", [(zero, zero)] * num_shards)
        self._view_shape = tuple(zero.shape)
        del zero
        self.group = MapperGroup(
            [ShortcutMapper(
                replay_create=lambda snap, reqs, shard=i:
                    self._replay_create(snap, reqs, shard),
                replay_update=lambda snap, reqs, shard=i:
                    self._replay_update(snap, reqs, shard),
                snapshot=lambda: self.cache,
                view_arrays=lambda shard=i: self.views.arrays(shard),
                routing=routing or FragmentationRouting(float(frag_threshold)),
                poll_interval=poll_interval, async_mapper=async_mapper,
                name=f"kv-mapper-{i}")
             for i in range(num_shards)],
            router=lambda seq_id: int(seq_id) % num_shards,
            views=self.views)

    # -- delegated bookkeeping -----------------------------------------------

    @property
    def mapper(self) -> ShortcutMapper:
        """The first (with ``num_shards=1``: the only) mapper."""
        return self.group[0]

    @property
    def routed_shortcut(self) -> int:
        return self.group.routed_shortcut

    @property
    def routed_paged(self) -> int:
        return self.group.routed_fallback

    @property
    def frag_threshold(self):
        return self.group[0].threshold

    @frag_threshold.setter
    def frag_threshold(self, value: float) -> None:
        for m in self.group:
            m.threshold = value

    @property
    def stats(self):
        return self.group.stats

    # -- sharding helpers ----------------------------------------------------

    def _by_shard(self, seq_ids) -> dict:
        """{shard: [seq ids]} preserving batch order within each shard."""
        out: dict = {}
        for s in np.asarray(seq_ids).tolist():
            out.setdefault(self.group.route(int(s)), []).append(int(s))
        return out

    @contextlib.contextmanager
    def _shard_locks(self, shards):
        """Hold the involved shards' runtime locks in ascending order (the
        lock hierarchy that keeps multi-shard mutations deadlock-free);
        main-thread mutations only."""
        with contextlib.ExitStack() as stack:
            for r in sorted(shards):
                stack.enter_context(self.group[r].lock)
            yield

    # -- main-thread (serving) API -----------------------------------------

    def prefill(self, seq_ids, k: torch.Tensor, v: torch.Tensor):
        """Synchronous paged write + a create request per sequence on its
        owning shard."""
        seq_ids = np.asarray(seq_ids)
        by_shard = self._by_shard(seq_ids)
        with self._shard_locks(by_shard):
            self.cache = pc.write_prefill(self.cache, seq_ids, k, v)
            # submitted under the locks that assigned the versions, so each
            # shard's FIFO holds its requests in version order
            for r, keys in by_shard.items():
                self.group[r].submit_create(keys, self.group[r].record(keys),
                                            payload=np.asarray(keys))

    def append(self, seq_ids, new_k: torch.Tensor, new_v: torch.Tensor):
        """Synchronous paged append + a view-row update request on each
        sequence's owning shard (payload sliced per shard)."""
        seq_ids = np.asarray(seq_ids)
        shard_of = np.asarray([self.group.route(int(s)) for s in seq_ids])
        by_shard = {r: [int(s) for s in seq_ids[shard_of == r]]
                    for r in sorted(set(shard_of.tolist()))}
        with self._shard_locks(by_shard):
            # positions are read under the locks, atomically with the
            # append, or two racing appends would share a position
            positions = self.cache.seq_lens.cpu().numpy()[seq_ids]
            self.cache = pc.append_tokens(self.cache, seq_ids, new_k, new_v)
            for r, keys in by_shard.items():
                idx = np.nonzero(shard_of == r)[0]
                sel = torch.as_tensor(idx, device=new_k.device)
                self.group[r].submit_update(
                    keys, self.group[r].record(keys),
                    payload=(seq_ids[idx], positions[idx], new_k[:, sel],
                             new_v[:, sel]))

    def release(self, seq_ids):
        """Synchronous release; the sequences' views stay stale until the
        next prefill recreates them."""
        by_shard = self._by_shard(seq_ids)
        with self._shard_locks(by_shard):
            self.cache = pc.release_seqs(self.cache, np.asarray(seq_ids))
            for r, keys in by_shard.items():
                self.group[r].invalidate(keys)

    def in_sync(self, seq_ids) -> bool:
        return self.group.in_sync(self._by_shard(seq_ids))

    def fragmentation(self, seq_ids) -> float:
        return float(pc.fragmentation(self.cache, np.asarray(seq_ids)))

    def route(self, seq_ids) -> str:
        """'shortcut' | 'paged': version gate (across the involved shards)
        and the fragmentation cost model."""
        if self.group.gate(self.fragmentation(seq_ids),
                           self._by_shard(seq_ids)):
            return "shortcut"
        return "paged"

    def get_context(self, seq_ids, route: Optional[str] = None):
        """Materialized (k_ctx, v_ctx), each (L, B, KV, S, hd), and the route
        taken.  The shortcut path gathers rows of the stacked view in input
        order; the paged path gathers through the block tables."""
        seq_ids = np.asarray(seq_ids)
        if seq_ids.size == 0:
            # empty batch: no statistic, no gather, no route counters
            L, _, S, KV, hd = self._view_shape
            empty = torch.zeros((L, 0, KV, S, hd),
                                dtype=self.cache.k_pool.dtype,
                                device=self.cache.device)
            return empty, empty, route or "paged"
        route = route or self.route(seq_ids)
        # batch-level decision -> group-level counter
        self.group.count_route(route == "shortcut")
        if route == "shortcut":
            k, v = self._shortcut_context(seq_ids)
        else:
            k, v = pc.gather_context(self.cache, seq_ids)
        return k, v, route

    def view_stack(self):
        """The installed ``(N, L, seqs_per_shard, S_cap, KV, hd)`` k/v stack
        pair, current to every shard's published view (an epoch check and a
        handle return; the stack is never written again).  Sequence ``s``
        is at ``[s % N, :, s // N]``; a decode reads a layer of it in
        place."""
        epochs = [m.view_epoch for m in self.group]     # before the handle
        return self.operands.get("kv_view", epochs)

    def _shortcut_context(self, seq_ids: np.ndarray):
        stack_k, stack_v = self.view_stack()
        return stacked_context(stack_k, stack_v, seq_ids % self.num_shards,
                               seq_ids // self.num_shards)

    def seq_lens(self, seq_ids) -> np.ndarray:
        return self.cache.seq_lens.cpu().numpy()[np.asarray(seq_ids)]

    # -- maintenance (delegated to the runtime) ------------------------------

    def pump(self) -> int:
        return self.group.pump()

    def wait_in_sync(self, seq_ids, timeout: float = 30.0):
        return self.group.wait_in_sync(self._by_shard(seq_ids), timeout)

    def close(self):
        self.group.close()

    # -- replay callables ----------------------------------------------------
    #
    # Each runs on its shard's single mapper (thread or pump caller), clones
    # its shard's slice of the stack once, writes its batch into the clone in
    # place, and publishes the clone into the stack at the mapper's
    # next_view_epoch, before sc_version moves.  No other shard's slice is
    # read or written.

    def _private_slice(self, shard: int):
        vk, vv = self.views.snapshot(shard)
        return vk.clone(), vv.clone()

    def _replay_create(self, cache: pc.PagedKVCache, requests,
                       shard: int = 0) -> None:
        vk, vv = self._private_slice(shard)
        for r in requests:
            for s in np.asarray(r.payload).tolist():
                _compose_into(cache, vk, vv, int(s), int(s) // self.num_shards)
            self.group[shard].stats.slots_remapped += len(r.versions)
        self.views.publish(shard, (vk, vv),
                           epoch=self.group[shard].next_view_epoch)

    def _replay_update(self, cache: pc.PagedKVCache, requests,
                       shard: int = 0) -> None:
        vk, vv = self._private_slice(shard)
        for r in requests:
            seq_ids, positions, new_k, new_v = r.payload
            _append_into(vk, vv, np.asarray(seq_ids) // self.num_shards,
                         positions, new_k, new_v)
            self.group[shard].stats.slots_remapped += len(r.versions)
        self.views.publish(shard, (vk, vv),
                           epoch=self.group[shard].next_view_epoch)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
