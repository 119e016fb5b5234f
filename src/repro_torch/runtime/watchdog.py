"""Fault-tolerance runtime pieces: heartbeat watchdog, straggler detection,
and the restartable step loop (a copy of ``repro/runtime/
watchdog.py``: plain Python, no tensor).

On a multi-host deployment every host runs this agent; here the same code
paths are exercised single-process (tests inject failures).

  * :class:`Heartbeat` — worker-side: stamp a monotonic beat per step.
  * :class:`Watchdog` — controller-side thread: if any worker's beat goes
    stale past ``deadline_s``, fire the registered callback (the launcher's
    callback checkpoints-and-reconfigures: shrink the mesh, restore the
    latest step, continue — elastic scaling down; scale-up is the same path
    on join).
  * :class:`StragglerMonitor` — per-step duration EWMA; a step slower than
    ``threshold x`` median flags the host so the scheduler can re-slice data
    skew or evict the host.  (Across hosts real stragglers surface as slow
    collectives; detection still lives host-side on step timing.)
  * :func:`run_restartable` — the crash loop: run -> on failure
    restore latest checkpoint -> resume, up to ``max_restarts``.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional


class Heartbeat:
    def __init__(self, worker_id: int = 0):
        self.worker_id = worker_id
        self._last = time.monotonic()
        self._step = -1
        self._lock = threading.Lock()

    def beat(self, step: int) -> None:
        with self._lock:
            self._last = time.monotonic()
            self._step = step

    def age(self) -> float:
        with self._lock:
            return time.monotonic() - self._last

    @property
    def step(self) -> int:
        with self._lock:
            return self._step


class Watchdog:
    """Fires ``on_dead(worker_ids)`` when beats go stale."""

    def __init__(self, heartbeats: list, deadline_s: float,
                 on_dead: Callable[[list], None],
                 poll_s: float = 0.05):
        self.heartbeats = heartbeats
        self.deadline_s = deadline_s
        self.on_dead = on_dead
        self.poll_s = poll_s
        self._stop = threading.Event()
        self._fired: set = set()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="watchdog")
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.is_set():
            dead = [hb.worker_id for hb in self.heartbeats
                    if hb.age() > self.deadline_s
                    and hb.worker_id not in self._fired]
            if dead:
                self._fired.update(dead)
                self.on_dead(dead)
            time.sleep(self.poll_s)

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


@dataclass
class StragglerMonitor:
    """EWMA + windowed-median step timing; flags outlier steps/hosts."""
    threshold: float = 2.0
    window: int = 64
    _times: deque = field(default_factory=lambda: deque(maxlen=64))
    ewma: float = 0.0
    flagged: int = 0

    def record(self, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        self._times.append(seconds)
        self.ewma = seconds if self.ewma == 0.0 \
            else 0.9 * self.ewma + 0.1 * seconds
        med = sorted(self._times)[len(self._times) // 2]
        is_straggler = len(self._times) >= 8 and seconds > self.threshold * med
        if is_straggler:
            self.flagged += 1
        return is_straggler

    def median(self) -> float:
        return sorted(self._times)[len(self._times) // 2] \
            if self._times else 0.0


def run_restartable(body: Callable[[int], int], *,
                    restore: Callable[[], int],
                    max_restarts: int = 3) -> int:
    """The crash loop.

    ``body(start_step)`` runs the training loop and returns the final step
    (raising on simulated/real failure); ``restore()`` reloads the latest
    checkpoint and returns the step to resume from.
    """
    restarts = 0
    start = restore()
    while True:
        try:
            return body(start)
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
            start = restore()
