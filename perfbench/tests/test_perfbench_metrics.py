"""The yardstick of the kernel metrics on the CPU: the lookup bytes are the
same for the same probes on both routes of both configurations, and the
readers return nothing where they find nothing to read."""
import importlib.util
import json

import pytest
import torch

from perfbench import keys as keygen
from perfbench import trace_read
from perfbench.harness import ReadCtx
from perfbench.references.kv_map import KVMap
from perfbench.tests import stand_in
from repro_torch.core.sharded_eh import ShardedShortcutEH
from repro_torch.core.shortcut_eh import ShortcutEH

METRICS = stand_in.REPO / "perfbench" / "metrics"
BENCH_PER_LAYER = json.loads(
    (stand_in.REPO / "BENCHMARK.json").read_text())["per_layer"]


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lookup_bytes_do_not_depend_on_route_or_structure():
    lb = _reader("lookup_kernel_roofline_pct").lookup_bytes
    n = 3000
    both = keygen.make_keys(n + 1000, 5, "cpu")
    keys, absent = both[:n], both[n:]
    vals = keygen.make_values(n, 5, "cpu")
    g = torch.Generator().manual_seed(1)
    probes = torch.cat([keys[torch.randint(0, n, (4000,), generator=g)],
                        absent])
    want = lb(probes, KVMap(keys, vals).lookup(probes) != -1)
    counts = []
    for ix, look in ((ShortcutEH(10, 16, 1024, device="cpu"), "lookup"),
                     (ShardedShortcutEH(10, 16, 512, num_shards=4,
                                        device="cpu"), "lookup_batched")):
        for i in range(0, n, 750):
            ix.insert(keys[i:i + 750], vals[i:i + 750])
        for _ in ("traditional", "shortcut"):
            ans = getattr(ix, look)(probes).view(torch.int32)
            counts.append(lb(probes, ans != -1))
            ix.pump()
        assert ix.routed_traditional >= 1 and ix.routed_shortcut >= 1
        ix.close()
    assert counts == [want] * 4
    distinct = torch.unique(probes[:4000]).numel()
    assert want == 8 * probes.numel() + 8 * distinct


def _view(ops, host=(), t0=0.0, t1=1000.0):
    return trace_read.TraceView(t0, t1, device_ops=list(ops),
                                host=list(host))


def test_trace_union_gaps_and_names():
    v = _view([("k_a", 100, 300), ("k_b", 200, 400), ("copy", 600, 700)],
              host=[("bench.lookup_call", "user_annotation", 0, 550),
                    ("aten::item", "cpu_op", 420, 540),
                    ("cudaStreamSynchronize", "cuda_runtime", 430, 530)])
    assert v.busy_intervals() == [[100, 400], [600, 700]]
    assert abs(v.busy_s() - 400e-6) < 1e-12
    assert v.gaps() == [(0.0, 100), (400, 600), (700, 1000.0)]
    top = v.top_gaps()
    assert [round(s * 1e6) for _, s in top] == [300, 200, 100]
    assert top[1][0] == ("bench.lookup_call: aten::item > "
                         "cudaStreamSynchronize")
    assert top[0][0] == "no_span"
    assert v.top_device_ops()[0] == ["k_a", pytest.approx(200e-6)]


def test_parse_keeps_the_window_and_the_harness_thread():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window",
           "ts": 10, "dur": 100, "tid": 1},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 5, "dur": 20,
           "tid": 7},
          {"ph": "X", "cat": "cpu_op", "name": "mine", "ts": 20, "dur": 5,
           "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "mapper", "ts": 20, "dur": 5,
           "tid": 2},
          {"ph": "X", "cat": "kernel", "name": "late", "ts": 200, "dur": 5,
           "tid": 7}]
    v = trace_read.parse(ev)
    assert (v.t0, v.t1) == (10.0, 110.0)
    assert v.device_ops == [("k", 10.0, 25.0)]
    assert [h[0] for h in v.host] == ["bench.window", "mine"]


def test_readers_return_nothing_without_data():
    empty = ReadCtx(trace=_view([]), counters={}, traced_probes=[],
                    memory={"peak": 0, "harness": 0, "records": 1})
    none = ReadCtx(trace=None, counters={}, traced_probes=[], memory={})
    for p in METRICS.glob("*.py"):
        r = _reader(p.stem)
        assert r.read(empty) is None and r.read(none) is None, p.stem


def test_roofline_readers_on_a_made_up_trace():
    ops = [("void eh_lookup_kernel<false>(...)", 0, 500),
           ("eh_insert_kernel(...)", 500, 900)]
    probes = torch.arange(1000, dtype=torch.int32)
    ctx = ReadCtx(trace=_view(ops), counters={"keys_inserted_traced": 10**6},
                  traced_probes=[(probes, None)] * 3, memory={})
    bw = 3.35e12
    want = 100 * 3 * 16000 / bw / 500e-6
    got = _reader("lookup_kernel_roofline_pct").read(ctx)
    assert got == pytest.approx(want)
    got = _reader("insert_kernel_roofline_pct").read(ctx)
    assert got == pytest.approx(100 * 16e6 / bw / 400e-6)
    assert _reader("device_idle_pct.lookup").read(ctx) == pytest.approx(10.0)


def _parse_before(events: list):
    """``trace_read.parse`` as it was before it kept correlations: the
    window span, the device operations and the harness thread's host
    events."""
    win = [e for e in events if e.get("ph") == "X"
           and e.get("name") == trace_read.WINDOW_SPAN
           and e.get("cat") == "user_annotation"][0]
    t0, t1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    ops, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, end = max(float(e["ts"]), t0), min(float(e["ts"]) + e["dur"], t1)
        if end <= s:
            continue
        cat = e.get("cat", "")
        if cat in trace_read.DEVICE_CATS:
            ops.append((e.get("name", "?"), s, end))
        elif cat in trace_read.HOST_CATS and e.get("tid") == win.get("tid"):
            host.append((e.get("name", "?"), cat, s, end))
    return trace_read.TraceView(t0, t1, device_ops=ops, host=host)


@pytest.mark.parametrize("cell", ["fig7_100m.read_uniform",
                                  "sharded4_100m.read_zipf",
                                  "fig7_100m.ingest"])
def test_index_readers_unchanged_by_correlations(tmp_path, cell,
                                                 monkeypatch):
    """A stand-in run's trace, with device operations and their launches
    added, read by the index cells' readers through ``parse`` (which now
    keeps correlations) and through the parse before it: the same values,
    and the same operations and host events."""
    root = stand_in.tiny_copy(tmp_path)
    seen = []
    parse = trace_read.parse

    def keep(events):
        tid = [e for e in events if e.get("name") == trace_read.WINDOW_SPAN
               ][0].get("tid")
        calls = sorted(e["ts"] for e in events if e.get("ph") == "X"
                       and e.get("tid") == tid and e.get("cat") == "cpu_op")
        for i, ts in enumerate(calls[:200]):
            name = ("void eh_lookup_kernel<false>(...)", "eh_insert_kernel",
                    "Memcpy DtoH")[i % 3]
            events.append({"ph": "X", "cat": "cuda_runtime", "tid": tid,
                           "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
                           "args": {"correlation": i}})
            events.append({"ph": "X", "cat": "kernel" if i % 3 < 2 else
                           "gpu_memcpy", "tid": 99, "name": name,
                           "ts": ts + 2, "dur": 3 + i % 5,
                           "args": {"correlation": i}})
        seen.append(events)
        return parse(events)

    monkeypatch.setattr(trace_read, "parse", keep)
    rc, res = stand_in.run(root, cell, trace=1, seconds=0.3)
    assert rc == 0 and seen
    new, old = parse(seen[0]), _parse_before(seen[0])
    assert new.device_ops == old.device_ops and new.host == old.host
    assert new.device_ops and new.launches
    probes = [(torch.arange(100, dtype=torch.int32), None)]
    for m in BENCH_PER_LAYER:
        if cell not in m["workloads"]:
            continue
        r = _reader(m["name"])
        got = [r.read(ReadCtx(trace=v, counters={"keys_inserted_traced": 9,
                                                 "routed_shortcut": 3},
                              traced_probes=probes,
                              memory={"peak": 8, "harness": 1,
                                      "records": 2}))
               for v in (new, old)]
        assert got[0] == got[1], m["name"]
