"""Generic shortcut-maintenance runtime (twin of ``repro/runtime/mapper.py``).

The paper's mechanism is one pattern instantiated per structure: an
authoritative ("traditional") structure is modified synchronously by the
main thread, while a *shortcut view* of it is rewired asynchronously by a
mapper thread that polls a FIFO of maintenance requests —

  * ``update`` requests replay small, incremental rewirings (the per-slot
    ``mmap(MAP_SHARED|MAP_FIXED)`` calls of §3.3);
  * ``create`` requests rebuild a view from scratch (the ``mmap`` loop of
    step (2)) and make any *older* pending updates for the same view
    redundant — the runtime collapses them;
  * the view is eagerly *populated* before its version is published: here
    a CUDA event recorded on the current stream after the replays, and
    waited for (a no-op for CPU tensors);
  * the view's lag: each request is stamped on the host clock when it is
    submitted, and the publish that covers it adds its age to
    :class:`MaintenanceStats` (``published``, ``lag_seconds``); the replays
    and the population run inside the profiler spans ``mapper.replay`` and
    ``mapper.populate`` (``runtime/spans.py``);
  * reads route through the shortcut only when it is **in sync** (version
    gate) *and* a structure-specific cost statistic says the shortcut pays
    (fan-in for EH §3.2) — a pluggable :class:`RoutingPolicy`;
  * publish epochs (``trad_epoch``, ``view_epoch``) key the stacked
    operand cache of the sharded index (``runtime/operand_cache.py``).

The module is pure Python apart from population; it is a copy of the JAX
package's, so that the port runs without JAX.  Every replay runs on the
thread's current CUDA stream, which is the device's default stream for the
mapper thread and the main thread alike, so replays and lookups are ordered
on the device.

Versioning model: the runtime keeps ``trad_version[key]`` and
``sc_version[key]`` per *view key*.  A structure with one global view
(Shortcut-EH) uses the single key :data:`GLOBAL_VIEW`.  ``trad_version``
starts at 0 and is bumped under the runtime's lock together with the
authoritative mutation; ``sc_version`` starts at -1 ("never populated") and
is published monotonically after replay + population.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Hashable, Iterable, Optional, Sequence

import torch

from repro_torch.runtime.spans import span

#: View key for clients that maintain a single, global shortcut view.
GLOBAL_VIEW: Hashable = "__global__"

CREATE = "create"
UPDATE = "update"


@dataclass
class Request:
    """One maintenance request in the FIFO.

    ``versions`` maps each view key the request touches to the
    ``trad_version`` that replaying it brings the shortcut to.  ``stamp``
    is the host time (``time.perf_counter``) of its submission;
    ``absorbed`` holds the stamps of the requests a create made redundant
    at enqueue, whose publish is this request's."""
    kind: str                      # CREATE | UPDATE
    versions: dict                 # view key -> target trad_version
    payload: Any = None            # client data (touched buckets, rows, ...)
    stamp: float = field(default_factory=time.perf_counter)
    absorbed: tuple = ()


@dataclass
class MaintenanceStats:
    creates: int = 0               # create replay batches
    updates: int = 0               # update replay batches
    collapsed: int = 0             # update requests made redundant by creates
    slots_remapped: int = 0        # client-reported rewired slots/rows
    published: int = 0             # requests whose versions were published
    lag_seconds: float = 0.0       # summed submit-to-publish host time


# ---------------------------------------------------------------------------
# Routing policies: the structure-specific "is the shortcut worth it" law.
# ---------------------------------------------------------------------------

@dataclass
class FanInRouting:
    """EH's law (§3.2): route shortcut while the average directory fan-in
    is at most ``threshold`` (paper: 8).  Above it the shortcut's virtual
    footprint (2^g pages vs 2^g pointers + m pages) thrashes the TLB
    analogue and the traditional path is cheaper."""
    threshold: float = 8.0

    def decide(self, metric: float) -> bool:
        return metric <= self.threshold


@dataclass
class FragmentationRouting:
    """The KV cache's law: route shortcut once batch fragmentation is at
    least ``threshold`` — below it the paged gather streams
    nearly-contiguous blocks anyway and maintenance is pure overhead."""
    threshold: float = 0.25

    def decide(self, metric: float) -> bool:
        return metric >= self.threshold


class HysteresisRouting:
    """Sticky wrapper: flip to the shortcut only when ``enter`` fires,
    flip back only when ``exit`` stops firing; hold in between.

    Prevents route flapping when the metric oscillates around a single
    threshold (e.g. fan-in bouncing across 8.0 as splits land): configure
    ``enter`` stricter than ``exit`` — say ``FanInRouting(6)`` to enter
    and ``FanInRouting(10)`` to stay.
    """

    def __init__(self, enter, exit_):
        self.enter = enter
        self.exit = exit_
        self.engaged = False

    def decide(self, metric: float) -> bool:
        self.engaged = (self.exit.decide(metric) if self.engaged
                        else self.enter.decide(metric))
        return self.engaged


# ---------------------------------------------------------------------------
# The runtime.
# ---------------------------------------------------------------------------

class ShortcutMapper:
    """Owns queue, mapper thread, versioning, routing and stats for one
    shortcut view family.

    Parameters
    ----------
    replay_create / replay_update:
        ``f(snapshot, requests)`` — replay a FIFO-ordered run of same-kind
        requests against the client's view.  ``snapshot`` is whatever
        ``snapshot()`` returned under the runtime lock at batch start.
    snapshot:
        ``f()`` — return a consistent reference to the authoritative
        structure; called under :attr:`lock`.
    view_arrays:
        ``f()`` — iterable of device arrays to eagerly populate
        (population) before versions are published.
    routing:
        a :class:`RoutingPolicy` (``decide(metric) -> bool``).
    async_mapper:
        run the paper's polling mapper thread; otherwise callers drive
        maintenance synchronously via :meth:`pump`.
    """

    def __init__(self, *, replay_create: Callable[[Any, list], None],
                 replay_update: Callable[[Any, list], None],
                 snapshot: Callable[[], Any],
                 view_arrays: Callable[[], Iterable],
                 routing, poll_interval: float = 0.025,
                 async_mapper: bool = False, name: str = "shortcut-mapper"):
        self._replay_create = replay_create
        self._replay_update = replay_update
        self._snapshot = snapshot
        self._view_arrays = view_arrays
        self.routing = routing
        self.poll_interval = float(poll_interval)
        self.stats = MaintenanceStats()
        self.routed_shortcut = 0
        self.routed_fallback = 0
        self.lock = threading.Lock()
        # serializes _process between the mapper thread and pump()
        # callers: replay callables do unguarded read-modify-writes of
        # their view slots (single-writer protocol), so two concurrent
        # _process calls on the SAME mapper would silently lose the
        # earlier publication.  Per-mapper only — shards never share it.
        self._replay_mutex = threading.Lock()
        self._trad: dict = {}
        self._sc: dict = {}
        # publish epochs for the stacked operand cache
        # (runtime/operand_cache.py): trad_epoch moves with every
        # authoritative mutation (record/invalidate), view_epoch with every
        # replay-batch publication.  Writer order is always "publish
        # operands, then bump": replay callables publish into the cache at
        # :attr:`next_view_epoch` while the replay runs, and view_epoch
        # catches up to it before sc_version is published, so any view a
        # version gate certifies is already in the stack at a covering epoch.
        self.trad_epoch = 0
        self.view_epoch = 0
        self._queue: "queue.SimpleQueue[Request]" = queue.SimpleQueue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if async_mapper:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name=name)
            self._thread.start()

    # -- version bookkeeping (main-thread side) -----------------------------

    def record(self, keys: Sequence[Hashable]) -> list:
        """Bump ``trad_version`` for ``keys``; **caller must hold
        :attr:`lock`** together with the authoritative mutation.  Returns
        the new versions, to be carried by the maintenance request."""
        out = []
        for k in keys:
            v = self._trad.get(k, 0) + 1
            self._trad[k] = v
            out.append(v)
        # after the client stored its mutated state (callers reassign the
        # state first, then record under the same lock): a cache reader
        # that sees the new epoch is sure to snapshot the new state
        self.trad_epoch += 1
        return out

    def invalidate(self, keys: Sequence[Hashable]) -> None:
        """Mark views stale with no replay planned (e.g. sequence release):
        bumps ``trad_version`` and resets ``sc_version`` to -1.  Caller
        must hold :attr:`lock`."""
        for k in keys:
            self._trad[k] = self._trad.get(k, 0) + 1
            self._sc[k] = -1
        self.trad_epoch += 1

    @property
    def next_view_epoch(self) -> int:
        """The epoch the in-flight replay's publications carry.

        Meaningful only on the replay path (mapper thread or ``pump()``
        caller, under ``_replay_mutex``): replay callables publish into the
        stacked cache at this epoch, and ``_process`` bumps ``view_epoch``
        to exactly it before publishing ``sc_version``."""
        return self.view_epoch + 1

    def trad_version(self, key: Hashable = GLOBAL_VIEW) -> int:
        return self._trad.get(key, 0)

    def sc_version(self, key: Hashable = GLOBAL_VIEW) -> int:
        return self._sc.get(key, -1)

    def versions(self, key: Hashable = GLOBAL_VIEW) -> tuple:
        return self.trad_version(key), self.sc_version(key)

    def in_sync(self, keys: Optional[Iterable[Hashable]] = None) -> bool:
        if keys is None:
            keys = list(self._trad)
        return all(self.sc_version(k) >= self.trad_version(k) for k in keys)

    # -- request submission --------------------------------------------------

    def submit_update(self, keys: Sequence[Hashable], versions: Sequence[int],
                      payload: Any = None) -> None:
        self._queue.put(Request(UPDATE, dict(zip(keys, versions)), payload))

    def submit_create(self, keys: Sequence[Hashable], versions: Sequence[int],
                      payload: Any = None) -> None:
        """Enqueue a view (re)build.  Pending updates it makes redundant
        are popped as outdated *now* (the paper pops them at enqueue time
        after a directory doubling); the batch-side collapse in
        :meth:`_process` catches any that race past this."""
        req = Request(CREATE, dict(zip(keys, versions)), payload)
        pending = self._drain()
        kept, dropped = [], []
        for r in pending:
            (dropped if _subsumed(r, req.versions) else kept).append(r)
        self.stats.collapsed += len(dropped)
        req.absorbed = tuple(s for r in dropped
                             for s in (r.stamp, *r.absorbed))
        for r in kept:
            self._queue.put(r)
        self._queue.put(req)

    # -- routing -------------------------------------------------------------

    @property
    def threshold(self):
        """Scalar threshold of the routing policy, or None for policies
        without one (e.g. :class:`HysteresisRouting`)."""
        return getattr(self.routing, "threshold", None)

    @threshold.setter
    def threshold(self, value: float) -> None:
        if not hasattr(self.routing, "threshold"):
            raise AttributeError(
                f"routing policy {type(self.routing).__name__} has no "
                "scalar threshold; set its fields directly")
        self.routing.threshold = float(value)

    def gate(self, metric: float,
             keys: Optional[Iterable[Hashable]] = None) -> bool:
        """Pure decision: version gate AND routing policy."""
        return self.in_sync(keys) and bool(self.routing.decide(metric))

    def count_route(self, used_shortcut: bool) -> None:
        if used_shortcut:
            self.routed_shortcut += 1
        else:
            self.routed_fallback += 1

    # -- mapper side ---------------------------------------------------------

    def pump(self, max_requests: int = 1 << 30) -> int:
        """Synchronously process pending maintenance (mapper surrogate
        for deterministic tests/benchmarks)."""
        done = 0
        while done < max_requests:
            batch = self._drain()
            if not batch:
                break
            with self._replay_mutex:
                self._process(batch)
            done += len(batch)
        return done

    def wait_in_sync(self, keys: Optional[Iterable[Hashable]] = None,
                     timeout: float = 30.0) -> bool:
        """Block until the tracked views caught up (async mode); in sync
        mode this simply pumps."""
        keys = None if keys is None else list(keys)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.in_sync(keys) and self._queue.empty():
                return True
            if self._thread is None:
                self.pump()
            else:
                time.sleep(self.poll_interval / 4)
        return self.in_sync(keys)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _drain(self) -> list:
        out = []
        while True:
            try:
                out.append(self._queue.get_nowait())
            except queue.Empty:
                return out

    def _loop(self) -> None:
        """The paper's mapper thread: poll at a fixed frequency, replay."""
        while not self._stop.is_set():
            batch = self._drain()
            if batch:
                with self._replay_mutex:
                    self._process(batch)
            else:
                time.sleep(self.poll_interval)

    def _process(self, batch: list) -> None:
        """Replay one drained batch.

        1. collapse: drop updates whose every view key has a later (or
           equal) create in the batch — the create rebuilds from the
           authoritative structure, which already contains their effect;
        2. replay survivors in FIFO order, handing the client contiguous
           runs of same-kind requests (so e.g. EH merges one update batch
           and the KV cache composes creates before later appends); replay
           callables publish into the stacked cache at
           :attr:`next_view_epoch`;
        3. eagerly populate the view arrays (§3.1);
        4. bump ``view_epoch`` to the epoch the replays published at, then
           publish ``sc_version`` monotonically, and count every request of
           the batch (collapsed ones and those absorbed at enqueue too) as
           published, with its age.
        """
        with self.lock:
            snap = self._snapshot()

        last_create: dict = {}
        for r in batch:
            if r.kind == CREATE:
                for k, v in r.versions.items():
                    last_create[k] = max(last_create.get(k, -1), v)
        kept = []
        for r in batch:
            if r.kind == UPDATE and _subsumed(r, last_create):
                self.stats.collapsed += 1
                continue
            kept.append(r)

        with span("mapper.replay"):
            i = 0
            while i < len(kept):
                j = i
                while j < len(kept) and kept[j].kind == kept[i].kind:
                    j += 1
                run = kept[i:j]
                if kept[i].kind == CREATE:
                    self._replay_create(snap, run)
                    self.stats.creates += 1
                else:
                    self._replay_update(snap, run)
                    self.stats.updates += 1
                i = j
        with span("mapper.populate"):
            _populate(self._view_arrays())

        # catch up to next_view_epoch BEFORE publishing sc versions: once a
        # gate certifies these versions, the stacked cache already holds
        # the published operands at a covering epoch
        self.view_epoch += 1

        now = time.perf_counter()
        for r in batch:
            for k, v in r.versions.items():
                self._sc[k] = max(self._sc.get(k, -1), v)
            stamps = (r.stamp, *r.absorbed)
            self.stats.published += len(stamps)
            self.stats.lag_seconds += sum(now - s for s in stamps)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _populate(arrays: Iterable) -> None:
    """Wait until the device has finished writing ``arrays`` (the paper's
    eager page-table population): an event recorded on each CUDA device's
    current stream, synchronized."""
    for dev in {a.device for a in arrays if a.is_cuda}:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        event.synchronize()


def _subsumed(r: Request, create_versions: dict) -> bool:
    """True when every view key of update ``r`` is covered by a create at
    the same or a later version (replaying ``r`` would be redundant)."""
    return bool(r.versions) and all(
        create_versions.get(k, -1) >= v for k, v in r.versions.items())
