"""Publish-owned stacked lookup operands (twin of
``repro/runtime/operand_cache.py``): pay the patch at publish time.

The batched cross-shard kernels (``kernels/eh_lookup.sharded_*``) read the
per-shard structures stacked on a leading shard axis: ``(N, ...)``
directories, bucket pools, composed views.  This cache keeps those stacks as
the **primary** storage:

  * Writers (mapper replays) call :meth:`StackedOperandCache.publish` on the
    mapper thread at publish time, **before** the shard's ``sc_version`` is
    published.
  * The lookup path (:meth:`get` with no ``parts``) is an epoch comparison
    plus a handle return: no device work in steady state.
  * Per-shard reads (``view_snapshot``, a replay's read-modify-write) go
    through :meth:`slice_of`, a memoized slice of the stack.
  * A part that outgrows the stacked extent makes the publishing thread
    re-stack: the old stack is copied into a larger zeroed one, which is
    swapped in whole.

**Copy-on-write.**  The JAX package's publish builds a new stacked buffer
(``dynamic_update_slice`` without donation), so a handle or slice a reader
holds never changes.  A PyTorch ``copy_`` into the live stack would break
that twice over: a reader's lookup enqueued between the write of the keys
part and that of the vals part reads a torn view, and a slice taken as a
view (``a[shard]``) changes under its holder.  So with ``donate=False`` (the
default) a publish and a pull refresh clone the stack, write the shard's
slice into the clone, and only then swap in the new tuple.  A stack, once
installed, is never written again, so :meth:`slice_of` returns views of it.
The price is one clone of each stacked part per publish (``PERF.md``).

Epoch protocol (client-domain epochs): each entry records, per shard, the
highest client epoch published into it (``ShortcutMapper``'s ``view_epoch``
/ ``trad_epoch``).  A reader passes the epochs it read **before** the call;
the entry is clean for shard ``s`` when ``entry.epochs[s] >=
reader_epochs[s]``.  A publish landing between the reader's epoch read and
its ``get`` makes the entry newer than asked (a hit, and correct, because
arrays are stored before epochs and both before ``sc_version``).  A
push-owned family that *lags* the reader's epochs is a writer-order
violation and raises.

Pull-mode families (operands whose authoritative state lives client-side,
the "eh_trad" bucket arrays): ``get`` with a ``parts`` callable patches
dirty shards on the read path (``lookup_refreshes``), and the client may
keep the family warm with :meth:`publish_if_present` at mutation time.

The cache takes its device from the parts it is given.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import hashing

__all__ = ["StackedOperandCache", "OperandCacheStats"]


def _zeros(shape, like: torch.Tensor) -> torch.Tensor:
    return hashing.full(tuple(shape), 0, like.dtype, like.device)


def _stack(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack([hashing.storage_view(p) for p in parts]).view(
        parts[0].dtype)


def _embed(dst: torch.Tensor, src: torch.Tensor, lead: tuple = ()) -> None:
    """Write ``src`` at the origin of ``dst[lead]``, in place."""
    region = lead + tuple(slice(0, d) for d in src.shape)
    hashing.storage_view(dst)[region] = hashing.storage_view(src)


@dataclass
class OperandCacheStats:
    hits: int = 0                # get() served from the stack (no device work)
    publish_refreshes: int = 0   # slices written at publish time (writer side)
    lookup_refreshes: int = 0    # slices written on the lookup path (pull mode)
    rebuilds: int = 0            # full (re)stacks: first build / shape growth
    resident: Dict[str, int] = field(default_factory=dict)  # bytes per family

    @property
    def slice_refreshes(self) -> int:
        """Total slice writes, either side."""
        return self.publish_refreshes + self.lookup_refreshes

    def snapshot(self) -> "OperandCacheStats":
        return OperandCacheStats(self.hits, self.publish_refreshes,
                                 self.lookup_refreshes, self.rebuilds,
                                 dict(self.resident))


@dataclass
class _Entry:
    epochs: List[int]                    # per-shard client epoch of each slice
    arrays: Tuple[torch.Tensor, ...]     # the stacked (N, ...) tensors
    part_shapes: Tuple[tuple, ...]       # per-shard extents (without N axis)
    part_dtypes: Tuple = field(default_factory=tuple)
    published: List[bool] = field(default_factory=list)  # shard has real data


class StackedOperandCache:
    """Primary storage of stacked ``(N, ...)`` lookup operands.

    Push-owned families ("eh_view"): writers call :meth:`publish` per shard
    from the mapper thread before the shard's ``sc_version`` moves; the
    lookup path calls ``get(family, epochs)`` with no parts and receives the
    stacked handle after a pure epoch check.  Pull-mode families
    ("eh_trad"): ``get(family, epochs, parts)`` patches dirty shards on the
    read path, and mutators may keep the stack warm with
    :meth:`publish_if_present`.

    Thread safety: one lock serializes all mutation (publish, pull refresh,
    re-stack); the push-mode ``get`` and :meth:`slice_of` are lock-free —
    they read the entry's epoch list before its arrays tuple, the writer
    stores arrays before epochs, and both stores are atomic under the GIL.

    ``donate=True`` writes a publish or a pull refresh into the live stack
    in place, and only for CUDA tensors (on the CPU it is copy-on-write, as
    the JAX package never donates there).  It saves the clone, but every
    handle and slice is then a **loan** that the next publish overwrites,
    and a lookup enqueued between the writes of two parts reads a torn
    view: single-reader callers only, which must not run a lookup while a
    replay publishes.
    """

    def __init__(self, num_shards: int, *, donate: bool = False):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.num_shards = num_shards
        self.donate = bool(donate)
        self.stats = OperandCacheStats()
        self._entries: Dict[str, _Entry] = {}
        # identity-keyed per-(family, shard) slice memo
        self._slices: Dict[tuple, tuple] = {}
        self._lock = threading.Lock()

    # -- the lookup path -----------------------------------------------------

    def get(self, family: str, epochs: Sequence[int],
            parts: Optional[Callable[[int], Tuple[torch.Tensor, ...]]] = None
            ) -> Tuple[torch.Tensor, ...]:
        """Stacked operand tuple for ``family``, current to ``epochs``.

        Without ``parts`` (push-owned family): epoch comparison + handle
        return, lock-free; a lagging entry is a writer-order violation and
        raises.  With ``parts`` (pull mode) dirty shards are patched here
        and counted as ``lookup_refreshes``."""
        epochs = [int(e) for e in epochs]
        if len(epochs) != self.num_shards:
            raise ValueError(f"{len(epochs)} epochs for "
                             f"{self.num_shards} shards")
        ent = self._entries.get(family)
        if ent is not None:
            eps = ent.epochs              # epochs BEFORE arrays (class doc)
            if all(eps[s] >= epochs[s] for s in range(self.num_shards)):
                self.stats.hits += 1
                return ent.arrays
        if parts is None:
            lag = ([] if ent is None else
                   [s for s in range(self.num_shards)
                    if ent.epochs[s] < epochs[s]])
            raise RuntimeError(
                f"operand family {family!r} is publish-owned but "
                f"{'was never published' if ent is None else f'lags the reader on shards {lag}'}"
                f": publish() must run on the mapper thread before "
                f"sc_version is published (writer-order violation)")
        with self._lock:
            ent = self._entries.get(family)
            if ent is None:
                return self._rebuild(family, epochs, parts)
            dirty = [s for s in range(self.num_shards)
                     if epochs[s] > ent.epochs[s]]
            if not dirty:
                self.stats.hits += 1
                return ent.arrays
            arrays = list(ent.arrays)
            fresh = [False] * len(arrays)     # cloned by this refresh yet
            new_epochs = list(ent.epochs)
            try:
                for s in dirty:
                    p = tuple(parts(s))
                    if (tuple(tuple(a.shape) for a in p) != ent.part_shapes
                            or tuple(a.dtype for a in p)
                            != ent.part_dtypes):
                        # shape changed (e.g. directory growth): restack
                        return self._rebuild(family, epochs, parts,
                                             prebuilt={s: p})
                    for j, a in enumerate(p):
                        if not (fresh[j] or self._in_place(arrays[j])):
                            arrays[j] = hashing.clone(arrays[j])
                            fresh[j] = True
                        _embed(arrays[j], a, (s,))
                    new_epochs[s] = max(new_epochs[s], epochs[s])
                    self.stats.lookup_refreshes += 1
            except BaseException:
                if any(self._in_place(a) for a in arrays):
                    # the live stack may be half written: drop the entry
                    # so the next get rebuilds from scratch
                    self._drop(family)
                raise
            # commit arrays before epochs, only once every dirty slice was
            # written: a parts() exception mid-loop must not leave the
            # entry claiming freshness over the old arrays
            for s in dirty:
                ent.published[s] = True
            ent.arrays = tuple(arrays)
            ent.epochs = new_epochs
            return ent.arrays

    # -- the publish path (writer side, mapper thread) -----------------------

    def publish(self, family: str, shard: int,
                parts: Sequence[torch.Tensor], *, epoch: int) -> None:
        """Write one shard's operand tuple into the stack.

        Called from the shard's mapper thread (or the ``pump()`` caller)
        **before** the shard's ``sc_version`` is published, carrying the
        client epoch of the publication (the mapper's ``next_view_epoch``
        during a replay).  Creates the family on first publish (other shards
        start zeroed and unpublished); re-stacks when the part outgrew the
        extent; pads a smaller part up to the extent (rows past a shard's
        own logical size are never indexed)."""
        parts = tuple(parts)
        if not 0 <= shard < self.num_shards:
            raise ValueError(f"shard {shard} of {self.num_shards}")
        if not parts:
            raise ValueError(f"family {family!r}: empty part tuple")
        with self._lock:
            ent = self._entries.get(family)
            if ent is None:
                ent = self._create_zeroed(family, parts)
            if len(parts) != len(ent.arrays):
                raise ValueError(
                    f"family {family!r}: {len(parts)} parts for a "
                    f"{len(ent.arrays)}-part family")
            if tuple(a.dtype for a in parts) != ent.part_dtypes:
                raise ValueError(f"family {family!r}: part dtypes changed")
            shapes = tuple(tuple(a.shape) for a in parts)
            if any(len(s) != len(e)
                   for s, e in zip(shapes, ent.part_shapes)):
                raise ValueError(f"family {family!r}: part ranks changed")
            if any(d > e for sh, ext in zip(shapes, ent.part_shapes)
                   for d, e in zip(sh, ext)):
                self._restack_grow(family, ent, shapes)
            parts = tuple(self._pad_to_extent(a, ext)
                          for a, ext in zip(parts, ent.part_shapes))
            arrays = list(ent.arrays)
            try:
                for j, a in enumerate(parts):
                    if not self._in_place(arrays[j]):
                        arrays[j] = hashing.clone(arrays[j])
                    _embed(arrays[j], a, (shard,))
            except BaseException:
                if any(self._in_place(a) for a in arrays):
                    self._drop(family)
                raise
            ent.arrays = tuple(arrays)     # arrays first, then epoch
            ent.published[shard] = True
            ent.epochs[shard] = max(ent.epochs[shard], int(epoch))
            self.stats.publish_refreshes += 1

    def publish_if_present(self, family: str, shard: int,
                           parts: Callable[[], Tuple[torch.Tensor, ...]], *,
                           epoch: int) -> None:
        """Keep a pull-built family warm from the mutation path: publish only
        when the family already exists (a lookup built it)."""
        if family in self._entries:
            self.publish(family, shard, tuple(parts()), epoch=epoch)

    def touch(self, family: str, shard: int, *, epoch: int) -> None:
        """Advance a shard's epoch without new data: a replay whose merged
        work was empty still owes the reader an epoch."""
        with self._lock:
            ent = self._entries.get(family)
            if ent is not None:
                ent.epochs[shard] = max(ent.epochs[shard], int(epoch))

    def seed(self, family: str, per_shard_parts: Sequence[Sequence], *,
             epoch: int = 0) -> None:
        """Build a family in one shot from uniform per-shard part tuples;
        every shard is marked published at ``epoch``."""
        per = [tuple(p) for p in per_shard_parts]
        if len(per) != self.num_shards:
            raise ValueError(f"{len(per)} part tuples for "
                             f"{self.num_shards} shards")
        with self._lock:
            widths = {len(p) for p in per}
            if len(widths) != 1:
                raise ValueError(f"family {family!r}: ragged part tuples "
                                 f"{sorted(widths)}")
            stacked = tuple(_stack([p[j] for p in per])
                            for j in range(widths.pop()))
            self._install(family, _Entry(
                epochs=[int(epoch)] * self.num_shards, arrays=stacked,
                part_shapes=tuple(tuple(a.shape) for a in per[0]),
                part_dtypes=tuple(a.dtype for a in per[0]),
                published=[True] * self.num_shards))

    # -- per-shard views of the stack ---------------------------------------

    def handle(self, family: str) -> Optional[Tuple[torch.Tensor, ...]]:
        """The stacked tuple itself (or None), with no epoch check."""
        ent = self._entries.get(family)
        return None if ent is None else ent.arrays

    def slice_of(self, family: str, shard: int
                 ) -> Optional[Tuple[torch.Tensor, ...]]:
        """One shard's operand tuple as views of the stack (never written
        again unless ``donate``).  Memoized on the stacked tuple's identity,
        and internally consistent: every tensor comes from ONE tuple."""
        ent = self._entries.get(family)
        if ent is None:
            return None
        arrays = ent.arrays                      # single read: swap is atomic
        key = (family, shard)
        memo = self._slices.get(key)
        if memo is not None and memo[0] is arrays:
            return memo[1]
        sl = tuple(a[shard] for a in arrays)
        self._slices[key] = (arrays, sl)
        return sl

    def published(self, family: str) -> Optional[List[bool]]:
        """Per-shard "holds real data" flags; None before the family
        exists."""
        ent = self._entries.get(family)
        return None if ent is None else list(ent.published)

    # -- bookkeeping ---------------------------------------------------------

    def epochs(self, family: str) -> Optional[List[int]]:
        """The per-shard client epochs the stacked slices are current to;
        None before the family exists."""
        ent = self._entries.get(family)
        return None if ent is None else list(ent.epochs)

    def resident_bytes(self) -> Dict[str, int]:
        """Device bytes resident per family (the stacks; memoized slices
        are views and add nothing)."""
        return dict(self.stats.resident)

    def invalidate(self, family: Optional[str] = None) -> None:
        """Drop one family (or all).  A push-owned family's shards read as
        unpublished until their next create replay; a pull family rebuilds
        on the next get."""
        with self._lock:
            for fam in ([family] if family is not None
                        else list(self._entries)):
                self._drop(fam)

    def __contains__(self, family: str) -> bool:
        return family in self._entries

    # -- internals (call with self._lock held) -------------------------------

    def _in_place(self, stacked: torch.Tensor) -> bool:
        return self.donate and stacked.is_cuda

    def _install(self, family: str, ent: _Entry) -> None:
        self._entries[family] = ent
        self.stats.rebuilds += 1
        self.stats.resident[family] = sum(a.nbytes for a in ent.arrays)

    def _drop(self, family: str) -> None:
        self._entries.pop(family, None)
        self.stats.resident.pop(family, None)
        for s in range(self.num_shards):
            self._slices.pop((family, s), None)

    def _create_zeroed(self, family: str, parts: Tuple) -> _Entry:
        stacked = tuple(_zeros((self.num_shards,) + tuple(a.shape), a)
                        for a in parts)
        ent = _Entry(
            epochs=[0] * self.num_shards, arrays=stacked,
            part_shapes=tuple(tuple(a.shape) for a in parts),
            part_dtypes=tuple(a.dtype for a in parts),
            published=[False] * self.num_shards)
        self._install(family, ent)
        return ent

    def _restack_grow(self, family: str, ent: _Entry,
                      shapes: Tuple[tuple, ...]) -> None:
        """Re-stack on growth: copy the old stack into a larger zeroed one
        (elementwise-max extents) and swap it in.  Readers holding the old
        handle are never blocked and never see a torn stack."""
        new_ext = tuple(tuple(max(d, e) for d, e in zip(sh, ext))
                        for sh, ext in zip(shapes, ent.part_shapes))
        grown = []
        for old, ext in zip(ent.arrays, new_ext):
            if tuple(old.shape[1:]) == ext:
                grown.append(old)
                continue
            dst = _zeros((self.num_shards,) + ext, old)
            _embed(dst, old)
            grown.append(dst)
        ent.arrays = tuple(grown)
        ent.part_shapes = new_ext
        self.stats.rebuilds += 1
        self.stats.resident[family] = sum(a.nbytes for a in grown)

    @staticmethod
    def _pad_to_extent(a: torch.Tensor, ext: tuple) -> torch.Tensor:
        if tuple(a.shape) == tuple(ext):
            return a
        out = _zeros(ext, a)
        _embed(out, a)
        return out

    def _rebuild(self, family: str, epochs: List[int],
                 parts: Callable[[int], Tuple[torch.Tensor, ...]],
                 prebuilt: Optional[dict] = None
                 ) -> Tuple[torch.Tensor, ...]:
        """Pull-mode full (re)stack: first build of a pull family, or a shape
        change found on the read path."""
        prebuilt = prebuilt or {}
        per_shard = [tuple(prebuilt.get(s) or parts(s))
                     for s in range(self.num_shards)]
        width = {len(p) for p in per_shard}
        if len(width) != 1:
            raise ValueError(f"family {family!r}: ragged part tuples "
                             f"{sorted(width)}")
        stacked = tuple(_stack([p[j] for p in per_shard])
                        for j in range(width.pop()))
        self._install(family, _Entry(
            epochs=list(epochs), arrays=stacked,
            part_shapes=tuple(tuple(a.shape) for a in per_shard[0]),
            part_dtypes=tuple(a.dtype for a in per_shard[0]),
            published=[True] * self.num_shards))
        return stacked
