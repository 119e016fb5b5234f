"""Shortcut-EH: extendible hashing accompanied by an asynchronously
maintained shortcut directory (paper §4.1; twin of the standalone mode of
``repro/core/shortcut_eh.py``).

  * The *traditional* directory (``EHState``) is authoritative; every insert
    is applied to it synchronously (one insert kernel per batch on CUDA)
    and bumps the traditional version.
  * Maintenance — the FIFO, the polling mapper thread (paper: 25 ms) or
    synchronous ``pump()``, create-collapses-older-updates batching, eager
    population, version gating and fan-in routing — is the generic runtime
    (``runtime/mapper.ShortcutMapper``).  This class supplies the replays:
      - ``update`` replay remaps the view slots of touched buckets
        (``rewiring.remap_slots``: the ragged-copy kernel on CUDA);
      - ``create`` replay rebuilds the whole view after a directory
        doubling (``extendible_hashing.compose_shortcut``).
  * Lookups route through the shortcut only when it is in sync *and* the
    average fan-in is at most ``fan_in_threshold`` (paper: 8); both paths
    are the lookup kernel on CUDA (traditional and shortcut mode).
  * Profiler spans (``runtime/spans.py``) on the caller's thread: ``eh.lookup``
    holding ``eh.gate`` and ``eh.launch``; ``eh.insert`` holding
    ``eh.insert.kernel`` (the kernel and the state's copy-on-write clones)
    and ``eh.insert.touched`` (the touched buckets read to the host).

As in the JAX package the view is a replica, not shared pages, so every
insert batch enqueues maintenance for the touched buckets.  Inserts and
replays are copy-on-write: a published state or view tuple never changes,
so a reader (or a replay) holding one sees one consistent version.

Bound to a stacked operand cache (:meth:`ShortcutEH.bind_operand_cache`, as
``core/sharded_eh.py`` binds every shard), the cache's stack owns the view:
replays publish the shard's slice into it, per-shard reads are memoized
slices of it, and a shortcut lookup reads the shard's block of the stack
(the stacked lookup kernel on CUDA).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import extendible_hashing as eh
from repro_torch.core import hashing, rewiring
from repro_torch.device import resolve_device
from repro_torch.kernels.eh_lookup import stacked_shortcut_lookup
from repro_torch.runtime.mapper import (GLOBAL_VIEW, FanInRouting,
                                        MaintenanceStats, ShortcutMapper)
from repro_torch.runtime.spans import span

__all__ = ["ShortcutEH", "MaintenanceStats"]


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


# Padded replay-chunk sizes, as in the JAX package (where they bound the
# number of jit variants); past the last one, whole multiples of it.
_CHUNK_SIZES = (64, 256, 1024, 4096, 16384, 65536)


def _pad_chunk(n: int) -> int:
    for c in _CHUNK_SIZES:
        if n <= c:
            return c
    last = _CHUNK_SIZES[-1]
    return -(-n // last) * last


class ShortcutEH:
    """Thin client of the shortcut-maintenance runtime for the EH index.

    ``async_mapper=True`` runs the paper's mapper thread; tests and
    deterministic benchmarks use ``async_mapper=False`` + :meth:`pump`.
    A custom ``routing`` policy may replace the default fan-in rule.
    """

    def __init__(self, max_global_depth: int, bucket_slots: int,
                 capacity: int, *, fan_in_threshold: float = 8.0,
                 poll_interval: float = 0.025, async_mapper: bool = False,
                 routing=None, device=None):
        self.device = resolve_device(device)
        self.state = eh.eh_create(max_global_depth, bucket_slots, capacity,
                                  device=self.device)
        # The composed view is ONE atomically swapped tuple
        # (view_keys, view_vals, view_log2): replays publish a fully built
        # tuple and readers snapshot it once, so a reader racing an async
        # replay can never pair new keys with old vals.  When bound to a
        # StackedOperandCache the stack owns the view instead, and _view
        # stays None.
        self._view: Optional[tuple] = None
        self._cache = None                  # StackedOperandCache or None
        self._shard = 0
        self._vfam = "eh_view"
        self._tfam = "eh_trad"
        self._bound_memo = None
        self.mapper = ShortcutMapper(
            replay_create=self._replay_create,
            replay_update=self._replay_update,
            snapshot=lambda: self.state,
            view_arrays=self._view_arrays,
            routing=routing or FanInRouting(float(fan_in_threshold)),
            poll_interval=poll_interval, async_mapper=async_mapper,
            name="eh-mapper")

    # -- delegated bookkeeping ------------------------------------------------

    @property
    def stats(self) -> MaintenanceStats:
        return self.mapper.stats

    @property
    def routed_shortcut(self) -> int:
        return self.mapper.routed_shortcut

    @property
    def routed_traditional(self) -> int:
        return self.mapper.routed_fallback

    @property
    def trad_version(self) -> int:
        return self.mapper.trad_version(GLOBAL_VIEW)

    @property
    def sc_version(self) -> int:
        return self.mapper.sc_version(GLOBAL_VIEW)

    @property
    def fan_in_threshold(self):
        return self.mapper.threshold

    @fan_in_threshold.setter
    def fan_in_threshold(self, value: float) -> None:
        self.mapper.threshold = value

    @property
    def poll_interval(self) -> float:
        return self.mapper.poll_interval

    # -- publish epochs (operand-cache keys; runtime/operand_cache.py) -------
    #
    # state_epoch moves with every ``self.state`` reassignment (insert stores
    # the new state, then ``record()`` bumps under the same lock); view_epoch
    # with every replay-batch publication (bumped by the runtime before
    # sc_version).  Read the epoch BEFORE snapshotting the arrays.

    @property
    def state_epoch(self) -> int:
        return self.mapper.trad_epoch

    @property
    def view_epoch(self) -> int:
        return self.mapper.view_epoch

    # -- operand-cache binding -------------------------------------------------

    def bind_operand_cache(self, cache, shard: int, *,
                           view_family: str = "eh_view",
                           trad_family: str = "eh_trad") -> None:
        """Hand view ownership to a stacked operand cache.

        After binding, replays publish into the shard's slice of the stacked
        ``view_family`` (at the mapper's ``next_view_epoch``, before
        ``sc_version`` moves), inserts keep ``trad_family`` warm once a
        lookup built it, and every per-shard view read is a memoized slice
        of the stack.  Bind before any maintenance is enqueued."""
        self._cache = cache
        self._shard = int(shard)
        self._vfam = view_family
        self._tfam = trad_family
        self._view = None        # the stack is the primary storage now
        self._bound_memo = None

    def _bound_view(self) -> Optional[tuple]:
        """(view_keys, view_vals, view_log2) slices of the stack, or None
        before this shard's first publication.  view_keys/vals are padded to
        the stacked extent; rows past ``2**view_log2`` are never indexed.
        Memoized on the cache's slice identity, so the device->host read of
        ``view_log2`` happens once per publish, not per lookup."""
        pub = self._cache.published(self._vfam)
        if pub is None or not pub[self._shard]:
            return None
        sl = self._cache.slice_of(self._vfam, self._shard)
        memo = self._bound_memo
        if memo is not None and memo[0] is sl:
            return memo[1]
        view = (sl[0], sl[1], int(sl[2]))
        self._bound_memo = (sl, view)
        return view

    # -- view snapshot (atomic read; see _view comment in __init__) ----------

    def view_snapshot(self) -> Optional[tuple]:
        """One consistent (view_keys, view_vals, view_log2) or None."""
        if self._cache is not None:
            return self._bound_view()
        return self._view

    @property
    def view_keys(self) -> Optional[torch.Tensor]:
        v = self.view_snapshot()
        return None if v is None else v[0]

    @property
    def view_vals(self) -> Optional[torch.Tensor]:
        v = self.view_snapshot()
        return None if v is None else v[1]

    @property
    def view_log2(self) -> int:
        v = self.view_snapshot()
        return -1 if v is None else v[2]

    # -- main-thread API ----------------------------------------------------

    def insert(self, keys, values) -> None:
        """Synchronous insert into the traditional index + enqueue
        maintenance (the paper's main-thread behaviour)."""
        with span("eh.insert"):
            self._insert(keys, values)

    def _insert(self, keys, values) -> None:
        keys = hashing.bits(keys, device=self.device)
        values = hashing.bits(values, device=self.device)
        old_g = int(self.state.global_depth)
        with self.mapper.lock:
            with span("eh.insert.kernel"):
                self.state = eh.eh_insert_many(self.state, keys, values)
            new_g = int(self.state.global_depth)
            versions = self.mapper.record([GLOBAL_VIEW])
            if self._cache is not None:
                # keep the stacked traditional family warm at write time,
                # but only once a lookup built it: a shortcut-routed steady
                # state never pays for (or holds) the traditional stack
                st = self.state
                self._cache.publish_if_present(
                    self._tfam, self._shard,
                    lambda: (st.directory, st.bucket_keys, st.bucket_vals,
                             st.global_depth),
                    epoch=self.mapper.trad_epoch)
        if new_g != old_g:
            # doubling: the runtime pops outdated updates before the create
            self.mapper.submit_create([GLOBAL_VIEW], versions)
        else:
            with span("eh.insert.touched"):
                slots = eh.dir_slot(eh.hash_dir(keys), new_g).long()
                touched = torch.unique(self.state.directory[slots])
                touched = touched.cpu().numpy()
            self.mapper.submit_update([GLOBAL_VIEW], versions,
                                      payload=touched)

    def lookup(self, keys) -> torch.Tensor:
        """Route through the shortcut when in sync and fan-in permits."""
        with span("eh.lookup"):
            keys = hashing.bits(keys, device=self.device)
            # gate FIRST, snapshot after: a replay landing in between
            # publishes a strictly newer view, which the gate's verdict
            # still covers; snapshotting first would let the gate certify
            # a stale tuple
            with span("eh.gate"):
                use = self.mapper.gate(self.avg_fan_in(), [GLOBAL_VIEW])
            view = self.view_snapshot()   # single read: the swap is atomic
            use = use and view is not None
            self.mapper.count_route(use)
            with span("eh.launch"):
                if not use:
                    return eh.eh_lookup_many(self.state, keys)
                if self._cache is not None:
                    # straight off the stack: the kernel reads this shard's
                    # block and its view log2 in place, no slice is copied
                    ops = self._cache.handle(self._vfam)
                    return stacked_shortcut_lookup(keys, *ops, self._shard)
                # the tuple's own view_log2, never the live global_depth: a
                # doubling after the snapshot would index past the view
                return eh.shortcut_lookup_many(view[0], view[1], view[2],
                                               keys)

    def use_shortcut(self) -> bool:
        return (self.view_snapshot() is not None
                and self.mapper.gate(self.avg_fan_in(), [GLOBAL_VIEW]))

    def in_sync(self) -> bool:
        return self.mapper.in_sync([GLOBAL_VIEW])

    def avg_fan_in(self) -> float:
        st = self.state
        return float((1 << int(st.global_depth))
                     / max(1, int(st.num_buckets)))

    def versions(self) -> tuple:
        return self.mapper.versions(GLOBAL_VIEW)

    def pump(self, max_requests: int = 1 << 30) -> int:
        """Synchronously process pending maintenance (mapper surrogate)."""
        return self.mapper.pump(max_requests)

    def wait_in_sync(self, timeout: float = 30.0) -> bool:
        """Block until the shortcut caught up (async mode)."""
        return self.mapper.wait_in_sync([GLOBAL_VIEW], timeout)

    def close(self) -> None:
        self.mapper.close()

    # -- replay callables (the only EH-specific maintenance code) ------------

    def _view_arrays(self):
        if self._cache is not None:
            # the stacked family IS the published object readers get
            return self._cache.handle(self._vfam) or ()
        view = self._view
        return () if view is None else view[:2]

    def _publish_view(self, vk, vv, vlog2: int) -> None:
        """Publish one replayed view: bound mode writes the shard's slice of
        the stack at the mapper's ``next_view_epoch`` (on the mapper thread,
        before ``sc_version`` moves); standalone mode swaps the tuple."""
        if self._cache is not None:
            self._cache.publish(
                self._vfam, self._shard,
                (vk, vv, torch.tensor(vlog2, dtype=torch.int32,
                                      device=self.device)),
                epoch=self.mapper.next_view_epoch)
            return
        self._view = (vk, vv, vlog2)

    def _replay_create(self, st: eh.EHState, requests) -> None:
        g = int(st.global_depth)
        view_slots = _next_pow2(1 << g)
        vk, vv = eh.compose_shortcut(st, view_slots)
        self._publish_view(vk, vv, view_slots.bit_length() - 1)
        self.mapper.stats.slots_remapped += view_slots

    def _replay_update(self, st: eh.EHState, requests) -> None:
        """Remap every view slot whose bucket is in the merged touched set.

        Host-side slot discovery (the mapper owns this cost, per §3.3),
        then a padded device copy — ``rewiring.remap_slots`` is the
        per-slot ``mmap(MAP_SHARED|MAP_FIXED)`` replay; padding remaps slot
        0 onto its own current bucket (a no-op).
        """
        view = self.view_snapshot()
        if view is None:
            # the composed view already reflects the snapshot (and thus
            # these updates); remapping on top would be duplicate work
            self._replay_create(st, requests)
            return
        vk, vv, vlog2 = view
        touched = np.unique(np.concatenate([r.payload for r in requests]))
        g = int(st.global_depth)
        dir_np = st.directory[: 1 << g].cpu().numpy()
        slots = np.nonzero(np.isin(dir_np, touched))[0].astype(np.int32)
        if slots.size == 0:
            if self._cache is not None:
                # no stale slots, but this batch's _process bumps view_epoch
                # and publishes sc versions: the reader is owed the epoch
                self._cache.touch(self._vfam, self._shard,
                                  epoch=self.mapper.next_view_epoch)
            return
        # A doubling that landed after this batch was drained gives the
        # snapshot slots past the view; the create it queued rebuilds the
        # view, and the JAX package's scatter drops such writes too.
        live = slots[slots < vk.shape[0]]
        pad = _pad_chunk(live.size) - live.size
        slots_p = np.concatenate([live, np.zeros(pad, np.int32)])
        offsets_p = dir_np[slots_p].astype(np.int32)
        slots_t = torch.from_numpy(slots_p).to(self.device)
        offsets_t = torch.from_numpy(offsets_p).to(self.device)
        vk = rewiring.remap_slots(vk, st.bucket_keys, slots_t, offsets_t)
        vv = rewiring.remap_slots(vv, st.bucket_vals, slots_t, offsets_t)
        self._publish_view(vk, vv, vlog2)
        self.mapper.stats.slots_remapped += int(slots.size)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
