"""The profiler's trace of a stretch of the window, reduced to what the
per-layer readers and the breakdown need.

``Tracer`` runs ``torch.profiler`` over host and device activity, opens the
span ``bench.window`` over the traced stretch, writes the Chrome trace to a
temporary file (``TMPDIR``), reads it back, deletes it and logs its size.
``TraceView`` holds the device operations (kernels, copies, sets) and the
host events of the harness's thread inside the ``bench.window`` span, all
in microseconds of one clock.  Each device operation keeps its
``correlation`` id, and each runtime call of the harness's thread that
launched one its time, so that a reader can sum the device time launched
while a span of that thread was open (:meth:`TraceView.launched_seconds`).
"""
from __future__ import annotations

import bisect
import json
import os
import sys
import tempfile
import warnings
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW_SPAN = "bench.window"
#: entries of each breakdown list
TOP = 10


def union(intervals) -> list:
    """Sorted, merged ``[start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


@dataclass
class TraceView:
    t0: float                      # the traced window, us
    t1: float
    device_ops: list = field(default_factory=list)   # (name, start, end)
    host: list = field(default_factory=list)         # (name, cat, start, end)
    #: each device operation's correlation id (None: not known), parallel
    #: to ``device_ops``
    device_corr: list = field(default_factory=list)
    #: correlation id -> start of the harness thread's runtime call that
    #: launched it
    launches: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> list:
        return union((s, e) for _, s, e in self.device_ops)

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def device_seconds(self, match) -> float:
        """Summed time of the device operations whose name ``match``es."""
        return sum(e - s for n, s, e in self.device_ops if match(n)) * 1e-6

    def _opened(self, span: str) -> tuple:
        """The host spans named ``span``: (their starts, (start, end)s)."""
        iv = sorted((s, e) for n, c, s, e in self.host
                    if c == "user_annotation" and n == span)
        return [s for s, _ in iv], iv

    def _launches(self):
        """(name, start, end, launch time) of each device operation whose
        launch is known."""
        for (n, s, e), corr in zip(self.device_ops, self.device_corr):
            ts = self.launches.get(corr)
            if ts is not None:
                yield n, s, e, ts

    def launched_seconds(self, *spans: str, match=None) -> float:
        """Summed time of the device operations (whose name ``match``es,
        if given) launched while a span of each name in ``spans`` was open
        on the harness's thread."""
        opened = [self._opened(name) for name in spans]
        return sum(e - s for n, s, e, ts in self._launches()
                   if (match is None or match(n))
                   and all(_within(ts, *o) >= 0 for o in opened)) * 1e-6

    def spans(self, name: str) -> list:
        """Durations (s) of the host spans called ``name``."""
        return [(e - s) * 1e-6 for n, c, s, e in self.host
                if c == "user_annotation" and n == name]

    def top_device_ops(self) -> list:
        by = {}
        for n, s, e in self.device_ops:
            by[n] = by.get(n, 0.0) + (e - s) * 1e-6
        return [[n[:160], v] for n, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]

    def gaps(self) -> list:
        """Idle stretches of the device in the window: (start, end)."""
        out, t = [], self.t0
        for s, e in self.busy_intervals():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def host_at(self, t: float) -> str:
        """What the harness's thread was doing at ``t``: the innermost
        ``bench.`` span open then, and the outermost and innermost program
        events in it."""
        open_ = sorted((s, n, c) for n, c, s, e in self.host if s <= t < e)
        bench = [n for s, n, c in open_ if n.startswith("bench.")
                 and n != WINDOW_SPAN]
        other = [n for s, n, c in open_ if not n.startswith("bench.")]
        name = bench[-1] if bench else "no_span"
        if other:
            name += ": " + other[0]
            if len(other) > 1:
                name += " > " + other[-1]
        return name[:160]

    def top_gaps(self) -> list:
        """The longest idle gaps, each named by what the host was doing at
        its middle."""
        longest = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:TOP]
        return [[self.host_at((s + e) / 2), (e - s) * 1e-6]
                for s, e in longest]


def _within(ts: float, starts: list, intervals: list) -> int:
    """The index of the interval (sorted, not overlapping) holding ``ts``,
    or -1."""
    j = bisect.bisect_right(starts, ts) - 1
    return j if j >= 0 and ts < intervals[j][1] else -1


def _correlation(event: dict):
    return event.get("args", {}).get("correlation")


def parse(events: list) -> TraceView:
    """A ``TraceView`` of a Chrome trace's ``traceEvents``."""
    win = [e for e in events if e.get("ph") == "X"
           and e.get("name") == WINDOW_SPAN
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError(f"no {WINDOW_SPAN} span in the trace")
    t0 = float(win[0]["ts"])
    t1 = t0 + float(win[0]["dur"])
    tid = win[0].get("tid")
    view = TraceView(t0, t1)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        end = s + float(e["dur"])
        s, end = max(s, t0), min(end, t1)
        if end <= s:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            view.device_ops.append((e.get("name", "?"), s, end))
            view.device_corr.append(_correlation(e))
        elif cat in HOST_CATS and e.get("tid") == tid:
            view.host.append((e.get("name", "?"), cat, s, end))
            if cat in LAUNCH_CATS and _correlation(e) is not None:
                view.launches[_correlation(e)] = float(e["ts"])
    return view


class Tracer:
    """``start()`` ... ``stop() -> TraceView``; host and device activity."""

    def __init__(self, torch, device_activity: bool = True):
        self.torch = torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device_activity:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.span = None

    def start(self) -> None:
        with warnings.catch_warnings():
            # "Profiler clears events at the end of each cycle": there is
            # one cycle
            warnings.simplefilter("ignore", UserWarning)
            self.prof.__enter__()
        self.span = self.torch.profiler.record_function(WINDOW_SPAN)
        self.span.__enter__()

    def stop(self) -> TraceView:
        self.span.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(prefix="perfbench-", suffix=".json")
        os.close(fd)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                self.prof.__exit__(None, None, None)
                self.prof.export_chrome_trace(path)
            size = os.path.getsize(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        print(f"trace: {size} bytes, {len(events)} events", file=sys.stderr,
              flush=True)
        return parse(events)
