"""Port parity for the slice as a whole: ``repro_torch.core.shortcut_eh``
against ``repro.core.shortcut_eh`` on the same insert/pump/lookup trace,
synchronous and with the mapper thread.  Lookups, versions, route counters,
maintenance stats and the composed view must all be identical."""
import numpy as np
import pytest
import torch

from repro.core import extendible_hashing as jeh
from repro.core.shortcut_eh import ShortcutEH as JEH
from repro.runtime.mapper import FanInRouting as JFan
from repro.runtime.mapper import HysteresisRouting as JHyst
from repro_torch.convert import state_to_numpy
from repro_torch.core import extendible_hashing as teh
from repro_torch.core.shortcut_eh import ShortcutEH as TEH
from repro_torch.core.shortcut_eh import _pad_chunk
from repro_torch.runtime.mapper import FanInRouting as TFan
from repro_torch.runtime.mapper import HysteresisRouting as THyst

from conftest import unique_keys


def observe(sc):
    s = sc.stats
    return (sc.versions(), sc.in_sync(), sc.use_shortcut(),
            sc.routed_shortcut, sc.routed_traditional,
            (s.creates, s.updates, s.collapsed, s.slots_remapped),
            sc.view_log2, sc.avg_fan_in())


def assert_same(j, t, *, settled=True):
    """Same state; and, once no mapper thread can be mid-replay
    (``settled``), the same routes, versions, stats and view."""
    got = state_to_numpy(t.state)
    for f in jeh.EHState._fields:
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(j.state, f)))
    if not settled:
        return
    assert observe(t) == observe(j)
    if j.view_keys is None:
        assert t.view_keys is None
    else:
        np.testing.assert_array_equal(t.view_keys.numpy(),
                                      np.asarray(j.view_keys))
        np.testing.assert_array_equal(t.view_vals.numpy(),
                                      np.asarray(j.view_vals))


def run_pair(kw, steps, j_kw=None, t_kw=None):
    """Drive both through ``steps`` of (op, arg); compare after each."""
    j = JEH(**kw, **(j_kw or {}))
    t = TEH(**kw, **(t_kw or {}), device="cpu")
    try:
        inserted = []
        for op, arg in steps:
            if op == "insert":
                keys, vals = arg
                j.insert(keys, vals)
                t.insert(keys, vals)
                inserted.append(keys)
            elif op == "pump":
                assert t.pump(arg) == j.pump(arg)
            elif op == "wait":
                assert j.wait_in_sync(30.0) and t.wait_in_sync(30.0)
            elif op == "threshold":
                j.fan_in_threshold = arg
                t.fan_in_threshold = arg
            elif op == "lookup":
                probe = np.concatenate(inserted + [arg])
                np.testing.assert_array_equal(t.lookup(probe).numpy(),
                                              np.asarray(j.lookup(probe)))
            assert_same(j, t, settled=not (op == "insert" and
                                           kw.get("async_mapper")))
        return j, t
    finally:
        j.close()
        t.close()


def trace(rng, n, batch, *, pump_every, absent=50):
    keys = unique_keys(rng, n)
    vals = rng.integers(0, 2**32 - 1, n, dtype=np.uint32)
    miss = unique_keys(rng, absent, lo=2**31, hi=2**32 - 2)
    steps = []
    for b, i in enumerate(range(0, n, batch)):
        steps += [("insert", (keys[i:i + batch], vals[i:i + batch])),
                  ("lookup", miss)]
        if b % pump_every == pump_every - 1:
            steps += [("pump", 1 << 30), ("lookup", miss)]
    return steps + [("pump", 1 << 30), ("lookup", miss)]


@pytest.mark.parametrize("n,batch,pump_every,slots", [
    (600, 50, 3, 8),        # splits + doublings: creates collapse updates
    (400, 100, 1, 16),      # pumped after every batch
    (500, 125, 2, 4),       # small buckets, deep directory
])
def test_sync_trace(rng, n, batch, pump_every, slots):
    j, t = run_pair(dict(max_global_depth=9, bucket_slots=slots,
                         capacity=1024),
                    trace(rng, n, batch, pump_every=pump_every))
    assert t.stats.creates >= 1 and t.stats.updates >= 1
    assert t.routed_shortcut >= 1 and t.routed_traditional >= 1
    assert teh.check_invariants(t.state)["ok"]


def test_partial_pump_and_threshold(rng):
    steps = trace(rng, 300, 60, pump_every=2)
    steps.insert(5, ("pump", 1))
    steps += [("threshold", 0.5), ("lookup", np.array([7], np.uint32)),
              ("threshold", 8.0), ("lookup", np.array([7], np.uint32))]
    run_pair(dict(max_global_depth=8, bucket_slots=16, capacity=256), steps)


def test_custom_routing(rng):
    keys = unique_keys(rng, 50)
    steps = [("insert", (keys, np.arange(50, dtype=np.uint32))),
             ("pump", 1 << 30), ("lookup", np.array([3], np.uint32))]
    j, t = run_pair(dict(max_global_depth=8, bucket_slots=64, capacity=128),
                    steps,
                    j_kw=dict(routing=JHyst(JFan(6.0), JFan(10.0))),
                    t_kw=dict(routing=THyst(TFan(6.0), TFan(10.0))))
    assert t.fan_in_threshold is None
    with pytest.raises(AttributeError):
        t.fan_in_threshold = 4.0


def test_async_trace(rng):
    """With the mapper thread: each batch is replayed before the next, so
    batches, stats and routes are deterministic on both sides."""
    keys = unique_keys(rng, 400)
    vals = np.arange(400, dtype=np.uint32)
    miss = unique_keys(rng, 30, lo=2**31, hi=2**32 - 2)
    steps = []
    for i in range(0, 400, 80):
        steps += [("insert", (keys[i:i + 80], vals[i:i + 80])), ("wait", None),
                  ("lookup", miss)]
    j, t = run_pair(dict(max_global_depth=8, bucket_slots=16, capacity=512,
                         poll_interval=0.003, async_mapper=True), steps)
    assert t.routed_shortcut == 5 and t.stats.published == 5


def test_async_lookups_race_replays(rng):
    """Lookups racing the mapper thread are always right (routes vary)."""
    keys = unique_keys(rng, 500)
    vals = np.arange(500, dtype=np.uint32)
    with TEH(8, 16, 512, poll_interval=0.001, async_mapper=True,
             device="cpu") as sc:
        for i in range(0, 500, 50):
            sc.insert(keys[i:i + 50], vals[i:i + 50])
            for _ in range(3):
                np.testing.assert_array_equal(
                    sc.lookup(keys[:i + 50]).numpy(), vals[:i + 50])
        assert sc.wait_in_sync(30.0)
        np.testing.assert_array_equal(sc.lookup(keys).numpy(), vals)
        assert sc.routed_traditional >= 1


def test_pad_chunk():
    assert [_pad_chunk(n) for n in (1, 64, 65, 65536)] == \
        [64, 64, 256, 65536]
    assert _pad_chunk(65537) == 131072 and _pad_chunk(200000) == 262144


def test_update_replay_past_65536_stale_slots():
    """A directory of 2**17 slots on one bucket: the second insert's update
    replay remaps all 131072 slots.  (The JAX package's replay pads its
    chunk to at most 65536 and fails here with a negative pad.)"""
    sc = TEH(max_global_depth=17, bucket_slots=64, capacity=4,
             fan_in_threshold=1e9, device="cpu")
    sc.state = sc.state._replace(global_depth=torch.tensor(17,
                                                           dtype=torch.int32))
    sc.insert(np.array([11, 12], np.uint32), np.array([1, 2], np.uint32))
    sc.pump()                           # first replay composes the view
    sc.insert(np.array([13], np.uint32), np.array([3], np.uint32))
    assert sc.pump() == 1
    assert sc.stats.updates == 2 and sc.stats.creates == 0
    assert sc.stats.slots_remapped == 2 * (1 << 17)
    assert sc.view_keys.shape[0] == 1 << 17
    out = sc.lookup(np.array([11, 12, 13, 14], np.uint32)).numpy()
    np.testing.assert_array_equal(out, [1, 2, 3, 0xFFFFFFFF])
    assert sc.routed_shortcut == 1
    assert teh.check_invariants(sc.state)["ok"]


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TEH(max_global_depth=4, bucket_slots=4, capacity=8)


def test_merged_pump_serves_stale_view_like_the_reference():
    """A reference-side fault the port keeps for parity (ROADMAP section 3):
    an update replay against a snapshot newer than its request remaps only
    the request's touched buckets, so keys that a later insert's split moved
    into a bucket no later payload names are missing from the view.  After
    one pump() of two inserts the gate reports in sync, yet the shortcut
    returns MISS for present keys; both packages give the same answers, and
    the traditional route finds the keys."""
    rng = np.random.default_rng(0)
    keys = (rng.choice(2**31 - 1, 4096, replace=False)[:640]
            + 1).astype(np.uint32)
    vals = np.arange(640, dtype=np.uint32)
    kw = dict(max_global_depth=12, bucket_slots=8, capacity=2048,
              fan_in_threshold=1e9)
    j, t = JEH(**kw), TEH(**kw, device="cpu")
    for i in range(0, 640, 64):
        j.insert(keys[i:i + 64], vals[i:i + 64])
        t.insert(keys[i:i + 64], vals[i:i + 64])
        if i // 64 % 2 == 1:
            assert t.pump() == j.pump()
    assert t.in_sync() and t.use_shortcut()
    assert_same(j, t)
    got = t.lookup(keys).numpy()
    np.testing.assert_array_equal(got, np.asarray(j.lookup(keys)))
    stale = got != vals
    assert 0 < stale.sum() < 16 and (got[stale] == 0xFFFFFFFF).all()
    np.testing.assert_array_equal(
        teh.eh_lookup_many(t.state, keys[stale]).numpy(), vals[stale])
    j.close()
    t.close()
