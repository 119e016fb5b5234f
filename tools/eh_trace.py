"""Every thread of one benchmark cell in one trace: the program's spans on
the caller's thread and on the mapper threads, and each device operation
tied to the thread and the span that launched it.

    python3 tools/eh_trace.py --workload sharded4_100m.read_zipf \\
        --seed 7 --seconds 51 --out build/eh_trace.json

It runs the cell's set-up and window as ``perfbench/run.py --trace 1``
does (same traffic, same seed, same traced stretch), with two differences:
the profiler records every thread (``profile_all_threads``), and each
device operation keeps the ``correlation`` it shares with its launch
(``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...), so it is charged to the
launching thread and to the innermost ``eh.`` / ``mapper.`` span
(``repro_torch/runtime/spans.py``) open at the launch.  The benchmark's
own reader (``perfbench/trace_read.py``) keeps the harness thread's host
events only.  The plain reference's check is not run.

It prints one JSON object (also written to ``--out``):

  * ``metrics``: the cell's per-layer readers on the harness thread's view,
    and ``partition_device_ms`` (device time launched under
    ``eh.partition`` / ``eh.scatter_back``, per traced lookup call; 0.0
    where no such span opened, as ``partition_spans``, their count, says:
    the sharded lookup routes its keys inside the kernel),
    ``lookup_slots_per_key`` (the sharded index's ``lookup_slots /
    lookup_keys``: 1.0 without padding), ``view_lag_ms`` (``1000 *
    lag_seconds / published``) and ``replay_device_ms`` (device time
    launched from other threads under ``mapper.*`` spans, per insert batch
    of the window);
  * ``one_clock``: the share of linked device operations that start no
    earlier than their launch (less ``LAUNCH_SLACK_US``), and
    ``lead_by_bin``: the least lead of an operation over its launch in
    each 5 s of the window;
  * ``device_by_span``: device seconds by launching thread and innermost
    program span, and ``eh_share`` / ``mapper_share`` of the device time;
  * ``idle_gaps``: the longest idle stretches, each named by the harness
    thread as the benchmark names it, then ``| <thread>: <outermost program
    span> > <innermost event>`` for every other thread with a program span
    open at the gap's middle;
  * ``span_cost_us``: a ``span`` with no profiler running, a
    ``record_function`` with none, and a ``span`` under this profiler.

Needs a CUDA card; the tests run :func:`run` on the CPU through the
benchmark's stand-in (``perfbench/tests/stand_in.py``) at test size.
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import sys
import tempfile
import threading
import time
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple, Optional

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from perfbench import harness, spec, trace_read  # noqa: E402
from perfbench.kinds.common import closed, collect  # noqa: E402

PROGRAM = ("eh.", "mapper.")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: how far before its launch event a device operation may seem to start
LAUNCH_SLACK_US = 5.0
TOP = 10


def is_program(name: str) -> bool:
    return name.startswith(PROGRAM)


class Op(NamedTuple):
    name: str
    s: float                  # clipped to the window, us
    e: float
    tid: object               # launching thread, None when unlinked
    span: Optional[str]       # innermost program span open at the launch
    launch: Optional[float]   # the launch event's start, us
    start: float              # the operation's own start, unclipped


def innermost(spans: list, points: list) -> list:
    """The innermost of one thread's nested ``(start, end, name)`` spans
    open at each of the sorted ``points``, or None."""
    spans = sorted(spans, key=lambda x: (x[0], -x[1]))
    out, stack, i = [], [], 0
    for t in points:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


@dataclass
class ThreadsView:
    """One traced stretch, every thread, in microseconds of one clock."""
    view: object          # trace_read.TraceView: the harness thread alone
    harness_tid: object
    names: dict           # tid -> thread name
    host: dict            # tid -> [(name, cat, start, end)] in the window
    ops: list             # [Op] in the window
    relinked: int = 0     # launches given a span of another thread

    def thread(self, tid) -> str:
        return self.names.get(tid, f"thread {tid}")

    def device_s(self, keep) -> float:
        return sum(o.e - o.s for o in self.ops if keep(o)) * 1e-6

    def one_clock(self) -> Optional[float]:
        linked = [o for o in self.ops if o.launch is not None]
        if not linked:
            return None
        ok = sum(o.start >= o.launch - LAUNCH_SLACK_US for o in linked)
        return ok / len(linked)

    def lead_by_bin(self, bin_s: float = 5.0) -> list:
        """``[bin start (s), least start - launch (us), operations]`` per
        ``bin_s`` of the window, by launch time: how far the device's
        timestamps drift against the host's."""
        by = {}
        for o in self.ops:
            if o.launch is not None:
                b = int((o.launch - self.view.t0) * 1e-6 // bin_s)
                lead, n = by.get(b, (float("inf"), 0))
                by[b] = (min(lead, o.start - o.launch), n + 1)
        return [[b * bin_s, lead, n] for b, (lead, n) in sorted(by.items())]

    def device_by_span(self) -> list:
        by = {}
        for o in self.ops:
            who = ("unlinked" if o.tid is None else "caller"
                   if o.tid == self.harness_tid else "other thread")
            k = f"{who}: {o.span or 'no program span'}"
            by[k] = by.get(k, 0.0) + (o.e - o.s) * 1e-6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])

    def copies_by_span(self) -> list:
        by = {}
        for o in self.ops:
            if "DtoD" in o.name:
                k = o.span or "no program span"
                by[k] = by.get(k, 0.0) + (o.e - o.s) * 1e-6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])

    def others_at(self, t: float) -> str:
        """`` | <thread>: <outermost span> > <innermost event>`` for each
        other thread with a program span open at ``t``."""
        out = ""
        for tid in sorted(self.host, key=str):
            if tid == self.harness_tid:
                continue
            open_ = sorted((s, n) for n, c, s, e in self.host[tid]
                           if s <= t < e)
            spans = [n for _, n in open_ if is_program(n)]
            if spans:
                out += f" | {self.thread(tid)}: {spans[0]}"
                if open_[-1][1] != spans[0]:
                    out += f" > {open_[-1][1]}"
        return out

    def top_gaps(self, n: int = TOP) -> list:
        longest = sorted(self.view.gaps(), key=lambda g: g[0] - g[1])[:n]
        return [[self.view.host_at((s + e) / 2) + self.others_at((s + e) / 2),
                 (e - s) * 1e-6] for s, e in longest]


def parse_threads(events: list, names: Optional[dict] = None) -> ThreadsView:
    """A ``ThreadsView`` of a Chrome trace's ``traceEvents``; ``names``
    (tid -> name) overrides the trace's ``thread_name`` metadata."""
    view = trace_read.parse(events)
    win = [e for e in events if e.get("ph") == "X"
           and e.get("name") == trace_read.WINDOW_SPAN
           and e.get("cat") == "user_annotation"]
    tid0 = win[0].get("tid")
    tnames = {e.get("tid"): e["args"]["name"] for e in events
              if e.get("ph") == "M" and e.get("name") == "thread_name"}
    tnames.update(names or {})
    tnames[tid0] = "caller"
    host, spans, launches = {}, {}, {}
    device = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name, tid = e.get("cat", ""), e.get("name", "?"), e.get("tid")
        s = float(e["ts"])
        end = s + float(e["dur"])
        corr = (e.get("args") or {}).get("correlation")
        if cat in trace_read.DEVICE_CATS:
            device.append((name, s, end, corr))
            continue
        if cat not in trace_read.HOST_CATS:
            continue
        if cat == "user_annotation" and is_program(name):
            spans.setdefault(tid, []).append((s, end, name))
        if cat in LAUNCH_CATS and corr is not None:
            launches[corr] = (tid, s)
        cs, ce = max(s, view.t0), min(end, view.t1)
        if ce > cs:
            host.setdefault(tid, []).append((name, cat, cs, ce))
    by_tid = {}
    for name, s, end, corr in device:
        cs, ce = max(s, view.t0), min(end, view.t1)
        if ce <= cs:
            continue
        tid, ts = launches.get(corr, (None, None))
        by_tid.setdefault(tid, []).append((ts, name, cs, ce, s))
    ops = []
    for tid, rows in by_tid.items():
        if tid is None:
            ops += [Op(n, cs, ce, None, None, None, s)
                    for _, n, cs, ce, s in rows]
            continue
        rows.sort(key=lambda r: r[0])
        inner = innermost(spans.get(tid, []), [r[0] for r in rows])
        ops += [Op(n, cs, ce, tid, sp, ts, s)
                for (ts, n, cs, ce, s), sp in zip(rows, inner)]
    # The profiler caches a thread's system id by its pthread handle, which
    # the C library hands to the next thread once one has ended: the launch
    # events of a later mapper thread can carry an ended one's id.  A launch
    # outside every program span of its thread takes the innermost program
    # span open at its time on another thread than the caller's.
    lost = sorted((i for i, o in enumerate(ops)
                   if o.tid not in (None, tid0) and o.span is None),
                  key=lambda i: ops[i].launch)
    found = [None] * len(lost)
    for tid, sp in spans.items():
        if tid != tid0:
            inner = innermost(sp, [ops[i].launch for i in lost])
            found = [f or n for f, n in zip(found, inner)]
    for i, name in zip(lost, found):
        ops[i] = ops[i]._replace(span=name)
    ops.sort(key=lambda o: o.s)
    return ThreadsView(view=view, harness_tid=tid0, names=tnames, host=host,
                       ops=ops, relinked=sum(f is not None for f in found))


PARTITION_SPANS = ("eh.partition", "eh.scatter_back")


def new_metrics(tv: ThreadsView, counters: dict) -> dict:
    """The four per-layer numbers the harness thread's view cannot give
    (None where the trace or the counters hold nothing to read)."""
    out = {}
    calls = len(tv.view.spans("bench.lookup_call"))
    # spans of a partition around the sharded launch (sort, pad, scatter
    # back); a program that routes each key inside the kernel opens none,
    # and its partition_device_ms reads 0.0: no partition ran
    ran = sum(len(tv.view.spans(n)) for n in PARTITION_SPANS)
    part = tv.device_s(lambda o: o.tid == tv.harness_tid
                       and o.span in PARTITION_SPANS)
    out["partition_spans"] = ran
    out["partition_device_ms"] = (None if not calls else
                                  1e3 * part / calls if ran else 0.0)
    keys = counters.get("lookup_keys", 0)
    out["lookup_slots_per_key"] = (counters.get("lookup_slots", 0) / keys
                                   if keys else None)
    n = counters.get("published", 0)
    out["view_lag_ms"] = 1e3 * counters.get("lag_seconds", 0.0) / n \
        if n else None
    batches = len(tv.view.spans("bench.insert_call"))
    replay = tv.device_s(lambda o: o.tid not in (None, tv.harness_tid)
                         and (o.span or "").startswith("mapper."))
    out["replay_device_ms"] = 1e3 * replay / batches if batches and replay \
        else None
    return out


class ThreadsTracer(trace_read.Tracer):
    """``trace_read.Tracer`` over every thread; ``stop()`` gives a
    ``ThreadsView``.  ``names`` (native thread id -> name) is read at the
    stop, beside the live threads' own names."""

    def __init__(self, torch, device_activity: bool, names: dict,
                 keep: Optional[Path] = None):
        self.torch = torch
        self.keep = keep
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device_activity:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        self.prof = torch.profiler.profile(activities=acts,
                                           experimental_config=cfg)
        self.span = None
        self.names = names

    def stop(self) -> ThreadsView:
        self.span.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(prefix="eh-trace-", suffix=".json")
        os.close(fd)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                self.prof.__exit__(None, None, None)
                self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            if self.keep:
                with open(path, "rb") as f, gzip.open(self.keep, "wb") as g:
                    shutil.copyfileobj(f, g)
        finally:
            os.unlink(path)
        names = {t.native_id: t.name for t in threading.enumerate()}
        names.update(self.names)
        return parse_threads(events, names)


class Counting:
    """The cell's index adapter with the program's own counters beside its
    three: ``published``, ``lag_seconds`` (``MaintenanceStats``) and, on the
    sharded index, ``lookup_keys``, ``lookup_slots``; each summed over the
    live index and every index closed so far.  Records each mapper
    thread's name by its native id."""

    KEYS = ("published", "lag_seconds", "lookup_keys", "lookup_slots")

    def __init__(self, system):
        self.system = system
        self.closed = dict.fromkeys(self.KEYS, 0)
        self.names = {}

    def build(self, config: dict, device):
        return _Counted(self, self.system.build(config, device))

    def totals(self, ix=None) -> dict:
        return ix.counters() if ix is not None else dict(self.closed)


class _Counted:
    def __init__(self, owner: Counting, inner):
        self.owner, self.inner, self.ix = owner, inner, inner.ix
        group = getattr(self.ix, "group", None)
        mappers = group.mappers if group else [self.ix.mapper]
        for i, m in enumerate(mappers):
            if m._thread is not None:
                owner.names[m._thread.native_id] = f"{m._thread.name} {i}"

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def program(self) -> dict:
        st = self.ix.stats
        return {"published": st.published, "lag_seconds": st.lag_seconds,
                "lookup_keys": getattr(self.ix, "lookup_keys", 0),
                "lookup_slots": getattr(self.ix, "lookup_slots", 0)}

    def counters(self) -> dict:
        c = dict(self.inner.counters())
        for k, v in self.program().items():
            c[k] = v + self.owner.closed[k]
        return c

    def close(self) -> None:
        for k, v in self.program().items():
            self.owner.closed[k] += v
        self.inner.close()


@dataclass
class ThreadsEnv(harness.Env):
    """The harness's ``Env`` whose tracer records every thread (and writes
    the raw trace, gzipped, to ``keep``); its ``system`` is a
    :class:`Counting`."""
    keep: Optional[Path] = None

    def tracer(self):
        return ThreadsTracer(self.torch, self.device.type == "cuda",
                             self.system.names, self.keep)


def span_cost(torch, n: int = 200_000) -> dict:
    """Microseconds a span costs with no profiler, a ``record_function``
    with none, and a span under an every-thread profiler."""
    from repro_torch.runtime.spans import span

    def per(f, k):
        t = time.perf_counter()
        for _ in range(k):
            with f("eh.cost"):
                pass
        return (time.perf_counter() - t) / k * 1e6

    off = per(span, n)
    rf = per(torch.profiler.record_function, n // 10)
    tr = ThreadsTracer(torch, torch.cuda.is_available(), {})
    tr.start()
    on = per(span, n // 10)
    tr.stop()
    return {"span_off": off, "record_function_off": rf, "span_on": on}


def run(cell, args, *, dev, device) -> dict:
    import torch
    counting = Counting(cell.system)
    env = ThreadsEnv(torch=torch, device=device, dev=dev, seed=args.seed,
                     seconds=args.seconds, trace=True, config=cell.config,
                     traffic=cell.traffic, system=counting,
                     reference=cell.reference, keep=args.keep_trace)
    cost = span_cost(torch, args.cost_reps)
    kind = cell.kind
    st = kind.prepare(env)
    kind.start(env, st)
    dev.synchronize()
    c0 = counting.totals(st.get("index"))
    w = kind.window(env, st)
    dev.synchronize()
    ix = st.pop("index")
    c1 = counting.totals(ix)
    counters = dict(w.counters)
    counters.update({k: c1[k] - c0[k] for k in Counting.KEYS})
    tv = w.trace
    ctx = harness.ReadCtx(trace=tv.view, counters=counters,
                          traced_probes=w.traced_probes, memory={})
    metrics = {m["name"]: reader.read(ctx) for m, reader in cell.per_layer}
    metrics.update(new_metrics(tv, counters))
    busy = sum(o.e - o.s for o in tv.ops) * 1e-6
    out = {
        "workload": cell.name, "seed": args.seed, "device": dev.name(),
        "power_limit": dev.power_limit(), "end_to_end": w.end_to_end,
        "metrics": metrics,
        "counters": {k: counters[k] for k in Counting.KEYS},
        "one_clock": tv.one_clock(),
        "lead_by_bin": tv.lead_by_bin(),
        "relinked": tv.relinked,
        "linked_ops": sum(o.launch is not None for o in tv.ops),
        "ops": len(tv.ops),
        "busy_s": tv.view.busy_s(), "window_s": tv.view.window_s,
        "eh_share": (tv.device_s(lambda o: (o.span or "").startswith("eh."))
                     / busy if busy else None),
        "mapper_share": (tv.device_s(
            lambda o: (o.span or "").startswith("mapper.")) / busy
            if busy else None),
        "device_by_span": tv.device_by_span()[:TOP],
        "copies_by_span": tv.copies_by_span(),
        "idle_gaps": tv.top_gaps(),
        "threads": sorted({tv.thread(t) for t in tv.host}),
        "span_cost_us": cost,
    }
    program = closed(ix)
    del ix
    collect(program)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", type=Path)
    p.add_argument("--cost-reps", type=int, default=200_000)
    p.add_argument("--keep-trace", type=Path,
                   help="also write the raw Chrome trace here, gzipped")
    args = p.parse_args(argv)
    import torch

    from perfbench.device import Cuda
    cell = spec.resolve(spec.load_spec(ROOT), args.workload,
                        ROOT / "perfbench")
    dev = Cuda(torch, int(cell.workload["chips"]))
    out = run(cell, args, dev=dev, device=dev.device)
    line = json.dumps(out)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
