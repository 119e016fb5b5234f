"""The port's own spans and counters on the EH path: ``runtime/spans.py``
costs a flag test with no profiler running, its spans land on the thread
that opened them (the caller's and the mapper thread's), the view's lag
counts each maintenance request once at the publish that covers it, and
the sharded lookup counts its padding."""
import json
import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.core.sharded_eh import ShardedShortcutEH
from repro_torch.core.shortcut_eh import ShortcutEH
from repro_torch.runtime import mapper as M
from repro_torch.runtime import spans


def _keys(rng, n):
    return (rng.choice(2**31 - 2, n, replace=False) + 1).astype(np.uint32)


def _refuse(name):
    raise AssertionError(f"record_function({name!r}) with no profiler")


def test_span_off_is_one_shared_noop():
    with mock.patch.object(torch.profiler, "record_function", _refuse):
        a, b = spans.span("eh.a"), spans.span("mapper.b")
        assert a is b is spans._OFF
        with a, spans.span("eh.c"):
            pass


def _all_threads_trace(tmp_path, body) -> list:
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            experimental_config=cfg) as prof:
        assert isinstance(spans.span("eh.x"),
                          torch.profiler.record_function)
        body()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def test_async_insert_spans_on_caller_and_mapper_thread(tmp_path):
    rng = np.random.default_rng(3)
    keys = _keys(rng, 600)
    with ShortcutEH(8, 16, 512, poll_interval=0.002, async_mapper=True,
                    device="cpu") as ix:
        mapper_tid = ix.mapper._thread.native_id
        assert ix.mapper._thread.name == "eh-mapper"

        def body():
            for i in range(0, 600, 200):
                ix.insert(keys[i:i + 200], keys[i:i + 200])
            assert ix.wait_in_sync(30)

        ev = _all_threads_trace(tmp_path, body)
        assert ix.stats.published == 3
    by = {}
    for e in ev:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            by.setdefault(e["name"], set()).add(e["tid"])
    me = threading.get_native_id()
    assert by["eh.insert"] == {me}
    assert by["eh.insert.kernel"] == {me}
    assert by["mapper.replay"] == {mapper_tid}
    assert by["mapper.populate"] == {mapper_tid}


def test_lookup_spans_nest_on_the_caller(tmp_path):
    rng = np.random.default_rng(4)
    keys = _keys(rng, 400)
    flat = ShortcutEH(8, 16, 512, device="cpu")
    sharded = ShardedShortcutEH(8, 16, 256, num_shards=4, device="cpu")
    for ix in (flat, sharded):
        ix.insert(keys, keys)
        ix.pump()

    def body():
        flat.lookup(keys)
        sharded.lookup_batched(keys)

    ev = _all_threads_trace(tmp_path, body)
    names = [e["name"] for e in sorted(
        (e for e in ev if e.get("ph") == "X"
         and e.get("cat") == "user_annotation"
         and e["name"].startswith("eh.")), key=lambda e: e["ts"])]
    # the sharded lookup sorts, pads and scatters nothing: its keys go to
    # the launch as they come
    assert names == ["eh.lookup", "eh.gate", "eh.launch",
                     "eh.lookup", "eh.gate", "eh.operands", "eh.launch"]
    flat.close()
    sharded.close()


class _Toy:
    """A client of the runtime whose replays do nothing."""

    def __init__(self):
        self.m = M.ShortcutMapper(replay_create=lambda s, r: None,
                                  replay_update=lambda s, r: None,
                                  snapshot=lambda: None, view_arrays=tuple,
                                  routing=M.FanInRouting(8.0))

    def put(self, kind="update"):
        with self.m.lock:
            v = self.m.record([M.GLOBAL_VIEW])
        if kind == "create":
            self.m.submit_create([M.GLOBAL_VIEW], v)
        else:
            self.m.submit_update([M.GLOBAL_VIEW], v)


WAIT = 0.05


def _lag_bounds(t0, t1, t2, n):
    """Each of n requests submitted in [t0, t1] and published in
    [t1 + WAIT, t2] is WAIT to (t2 - t0) old."""
    return n * WAIT, n * (t2 - t0)


def test_lag_counts_each_request_once_collapsed_at_enqueue():
    t = _Toy()
    t0 = time.perf_counter()
    t.put()
    t.put()
    t.put("create")
    t1 = time.perf_counter()
    assert t.m.stats.collapsed == 2
    time.sleep(WAIT)
    t.m.pump()
    t2 = time.perf_counter()
    lo, hi = _lag_bounds(t0, t1, t2, 3)
    assert t.m.stats.published == 3
    assert lo <= t.m.stats.lag_seconds <= hi


def test_lag_counts_each_request_once_collapsed_in_batch():
    t = _Toy()
    t0 = time.perf_counter()
    with t.m.lock:
        (v1,) = t.m.record([M.GLOBAL_VIEW])
        (v2,) = t.m.record([M.GLOBAL_VIEW])
    t.m.submit_update([M.GLOBAL_VIEW], [v1])
    # past the enqueue-time collapse, as a race with the mapper thread
    t.m._queue.put(M.Request(M.CREATE, {M.GLOBAL_VIEW: v2}))
    t.put()
    t1 = time.perf_counter()
    time.sleep(WAIT)
    t.m.pump()
    t2 = time.perf_counter()
    assert t.m.stats.collapsed == 1
    lo, hi = _lag_bounds(t0, t1, t2, 3)
    assert t.m.stats.published == 3
    assert lo <= t.m.stats.lag_seconds <= hi
    # a create that is itself made redundant hands on what it absorbed
    t.put()
    t.put("create")
    t.put("create")
    t.m.pump()
    assert t.m.stats.published == 6 and t.m.stats.collapsed == 3


def test_sharded_counters_sum_over_shards():
    rng = np.random.default_rng(5)
    keys = _keys(rng, 2000)
    ix = ShardedShortcutEH(10, 16, 1024, num_shards=4, device="cpu")
    for i in range(0, 2000, 500):
        ix.insert(keys[i:i + 500], keys[i:i + 500])
    ix.pump()
    per = [s.published for s in ix.per_shard_stats()]
    assert per == [4] * 4
    assert ix.stats.published == 16
    assert ix.stats.lag_seconds == pytest.approx(
        sum(s.lag_seconds for s in ix.per_shard_stats()))
    probes = torch.from_numpy(keys[:777].view(np.int32))
    ix.lookup_batched(probes)
    ix.lookup_batched(probes[:0])
    # one slot a key: the kernel takes the keys unpadded
    assert ix.lookup_keys == 777
    assert ix.lookup_slots == ix.lookup_keys
    ix.close()
