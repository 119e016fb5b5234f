"""``tools/eh_trace.py`` on made-up traces and, at test size on the CPU,
through the benchmark's stand-in: each device operation is tied to its
launch's thread and span by ``correlation``, an idle gap is named with
another thread's span, and the new per-layer numbers read what the
program's spans and counters hold."""
import argparse
import importlib.util
import sys
from pathlib import Path

import pytest
import torch

from perfbench import spec
from perfbench.tests import stand_in

ROOT = Path(__file__).resolve().parents[1]


def _tool():
    s = importlib.util.spec_from_file_location(
        "eh_trace", ROOT / "tools" / "eh_trace.py")
    mod = importlib.util.module_from_spec(s)
    sys.modules[s.name] = mod           # dataclasses look their module up
    s.loader.exec_module(mod)
    return mod


T = _tool()


def _x(name, cat, ts, dur, tid, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    {"ph": "M", "name": "thread_name", "tid": 2,
     "args": {"name": "thread 2 (python)"}},
    _x("bench.window", "user_annotation", 0, 300, 1),
    _x("bench.lookup_call", "user_annotation", 5, 120, 1),
    _x("eh.lookup", "user_annotation", 10, 100, 1),
    _x("eh.partition", "user_annotation", 12, 20, 1),
    _x("cudaLaunchKernel", "cuda_runtime", 15, 3, 1, corr=5),
    _x("eh.launch", "user_annotation", 40, 10, 1),
    _x("cudaLaunchKernel", "cuda_runtime", 42, 3, 1, corr=7),
    _x("mapper.replay", "user_annotation", 20, 200, 2),
    _x("cudaMemcpyAsync", "cuda_runtime", 50, 2, 2, corr=6),
    _x("aten::copy_", "cpu_op", 150, 30, 2),
    _x("sort_kernel", "kernel", 40, 10, 9, corr=5),
    _x("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 60, 20, 9, corr=6),
    _x("lookup_kernel", "kernel", 90, 10, 9, corr=7),
    _x("stray", "kernel", 250, 10, 9, corr=99),
]


def test_innermost_span_at_each_point():
    spans = [(0, 100, "a"), (10, 20, "b"), (12, 15, "c"), (30, 40, "d")]
    assert T.innermost(spans, [5, 13, 16, 25, 35, 100, 200]) == [
        "a", "c", "b", "a", "d", None, None]


def test_ops_tied_to_their_launch_by_correlation():
    tv = T.parse_threads(EVENTS, {2: "eh-mapper 0"})
    got = {o.name: (o.tid, o.span, o.launch) for o in tv.ops}
    assert got == {"sort_kernel": (1, "eh.partition", 15.0),
                   "Memcpy DtoD (Device -> Device)": (2, "mapper.replay",
                                                      50.0),
                   "lookup_kernel": (1, "eh.launch", 42.0),
                   "stray": (None, None, None)}
    assert tv.one_clock() == 1.0
    assert tv.thread(2) == "eh-mapper 0" and tv.thread(1) == "caller"
    assert tv.copies_by_span() == [["mapper.replay", pytest.approx(20e-6)]]
    m = T.new_metrics(tv, {"published": 4, "lag_seconds": 0.2,
                           "lookup_keys": 100, "lookup_slots": 256})
    assert m["partition_device_ms"] == pytest.approx(0.01)
    assert m["partition_spans"] == 1
    assert m["view_lag_ms"] == pytest.approx(50.0)
    assert m["lookup_slots_per_key"] == pytest.approx(2.56)
    assert m["replay_device_ms"] is None          # no insert call traced
    # an operation that seems to start before its launch breaks one clock
    early = [dict(e) for e in EVENTS]
    early[-2]["ts"] = 30
    assert T.parse_threads(early).one_clock() == pytest.approx(2 / 3)


def test_no_partition_span_reads_zero():
    """A sharded lookup that routes its keys inside the kernel opens no
    partition span: partition_device_ms says no partition ran (0.0) and
    divides by nothing; with no lookup call traced it reads None."""
    ev = [e for e in EVENTS if e["name"] != "eh.partition"]
    m = T.new_metrics(T.parse_threads(ev), {"lookup_keys": 100,
                                            "lookup_slots": 100})
    assert m["partition_device_ms"] == 0.0 and m["partition_spans"] == 0
    assert m["lookup_slots_per_key"] == 1.0
    ev = [e for e in ev if e["name"] != "bench.lookup_call"]
    assert T.new_metrics(T.parse_threads(ev), {})["partition_device_ms"] \
        is None


def test_launch_on_a_reused_thread_id_takes_the_open_mapper_span():
    # thread 3's launch event carries ended thread 2's id
    ev = EVENTS + [_x("mapper.replay", "user_annotation", 260, 30, 3),
                   _x("cudaMemcpyAsync", "cuda_runtime", 270, 2, 2, corr=8),
                   _x("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 275,
                      10, 9, corr=8)]
    tv = T.parse_threads(ev)
    late = [o for o in tv.ops if o.launch == 270.0]
    assert [(o.tid, o.span) for o in late] == [(2, "mapper.replay")]
    assert tv.relinked == 1
    assert tv.lead_by_bin(100e-6) == [[0.0, 10.0, 3],
                                      [pytest.approx(200e-6), 5.0, 1]]


def test_gap_named_with_the_other_threads_span():
    tv = T.parse_threads(EVENTS, {2: "eh-mapper 0"})
    (name, secs), *_ = tv.top_gaps()
    # the longest gap, 100-250: the caller in nothing, the mapper copying
    assert secs == pytest.approx(150e-6)
    assert name == "no_span | eh-mapper 0: mapper.replay > aten::copy_"
    names = [n for n, _ in tv.top_gaps()]
    assert "bench.lookup_call: eh.lookup > eh.launch" not in names
    assert tv.view.host_at(45) == "bench.lookup_call: eh.lookup > eh.launch"


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return stand_in.tiny_copy(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", ["sharded4_100m.read_zipf",
                                  "fig7_100m.ingest"])
def test_run_on_the_stand_in(tiny, cell):
    c = spec.resolve(spec.load_spec(tiny), cell, tiny / "perfbench")
    args = argparse.Namespace(seed=2**33 + 5, seconds=0.4, cost_reps=2000,
                              keep_trace=None)
    out = T.run(c, args, dev=stand_in.CpuStandIn(),
                device=torch.device("cpu"))
    m, n = out["metrics"], out["counters"]
    assert out["ops"] == 0                  # no device activity on the CPU
    assert set(out["span_cost_us"]) == {"span_off", "record_function_off",
                                        "span_on"}
    if cell.endswith("read_zipf"):
        assert m["lookup_gate_ms"] > 0
        # one slot a key, and no partition around the launch
        assert m["lookup_slots_per_key"] == 1.0
        assert n["lookup_slots"] == n["lookup_keys"] > 0
        assert m["partition_device_ms"] == 0.0
    else:
        # the window's mappers replay; a read window's sleep
        assert any(t.startswith("eh-mapper") for t in out["threads"])
        assert n["published"] > 0 and m["view_lag_ms"] > 0
        assert n["lookup_keys"] == 0
