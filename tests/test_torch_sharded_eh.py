"""Port parity for the sharded slice as a whole: ``repro_torch.core.sharded_eh``
against ``repro.core.sharded_eh`` on the same insert/pump/lookup trace, for
1, 2 and 4 shards.  Per-shard states and views, ``lookup`` and
``lookup_batched`` answers (all three dispatch arms), route counters,
maintenance stats, operand-cache stats, epochs and published flags must all
be identical.  The async test races lookups against the mapper threads'
copy-on-write publishes."""
import threading

import numpy as np
import pytest
import torch

from repro.core.sharded_eh import ShardedShortcutEH as JSharded
from repro.core.sharded_eh import shard_of_keys as j_shard_of_keys
from repro_torch.convert import state_to_numpy
from repro_torch.core import sharded_eh as tsh
from repro_torch.core.sharded_eh import ShardedShortcutEH as TSharded

MISS = 0xFFFFFFFF


def distinct_keys(rng, n, lo=1, hi=2**31):
    return (rng.choice(hi - lo, n, replace=False) + lo).astype(np.uint32)


def observe(idx):
    """Everything a caller can read off a sharded index, as plain values."""
    st = idx.operands.stats
    per = [(s.creates, s.updates, s.collapsed, s.slots_remapped)
           for s in idx.per_shard_stats()]
    return dict(
        routes=(idx.routed_shortcut, idx.routed_traditional,
                [(m.routed_shortcut, m.routed_fallback) for m in idx.group]),
        stats=per, in_sync=idx.in_sync(), entries=idx.num_entries(),
        fan_in=idx.avg_fan_in(),
        shard_epochs=[(s.state_epoch, s.view_epoch, s.versions())
                      for s in idx.shards],
        cache=(st.hits, st.publish_refreshes, st.lookup_refreshes,
               st.rebuilds, dict(st.resident)),
        families={f: (idx.operands.epochs(f), idx.operands.published(f))
                  for f in ("eh_view", "eh_trad")},
        view_log2=[s.view_log2 for s in idx.shards])


def assert_same(j, t):
    for js, ts in zip(j.shards, t.shards):
        got = state_to_numpy(ts.state)
        for f, a in zip(got._fields, got):
            np.testing.assert_array_equal(a, np.asarray(getattr(js.state, f)),
                                          err_msg=f)
        if js.view_keys is None:
            assert ts.view_keys is None
        else:
            np.testing.assert_array_equal(
                ts.view_keys.view(torch.int32).numpy().view(np.uint32),
                np.asarray(js.view_keys))
            np.testing.assert_array_equal(
                ts.view_vals.view(torch.int32).numpy().view(np.uint32),
                np.asarray(js.view_vals))
    assert observe(t) == observe(j)
    rep_t, rep_j = t.check_invariants(), j.check_invariants()
    assert rep_t["ok"] and rep_j["ok"] and rep_t == rep_j


def u32(t):
    return t.view(torch.int32).numpy().view(np.uint32)


@pytest.fixture
def arms(monkeypatch):
    """Calls of the three batched kernels from ``lookup_batched``."""
    calls = {"trad": 0, "shortcut": 0, "routed": 0}
    for name, attr in (("trad", "sharded_eh_lookup"),
                       ("shortcut", "sharded_shortcut_lookup"),
                       ("routed", "sharded_routed_lookup")):
        orig = getattr(tsh, attr)

        def wrapper(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(tsh, attr, wrapper)
    return calls


@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_trace_matches_reference(num_shards, arms):
    rng = np.random.default_rng(num_shards)
    keys = distinct_keys(rng, 800)
    vals = rng.integers(0, MISS, 800, dtype=np.uint32)
    misses = distinct_keys(rng, 100, lo=2**31, hi=2**32 - 2)
    # each shard keeps the flat depth, so its fan-in is about N times the
    # flat one's: a threshold above it keeps the routes known
    j = JSharded(12, 8, 2048, num_shards=num_shards, fan_in_threshold=64.0)
    t = TSharded(12, 8, 2048, num_shards=num_shards, fan_in_threshold=64.0,
                 device="cpu")
    try:
        for i in range(0, 800, 400):
            j.insert(keys[i:i + 400], vals[i:i + 400])
            t.insert(keys[i:i + 400], vals[i:i + 400])
            probe = np.concatenate([keys[:i + 400], misses])
            want = np.concatenate([vals[:i + 400], np.full(100, MISS,
                                                           np.uint32)])
            for fn in ("lookup", "lookup_batched"):   # out of sync
                got = u32(getattr(t, fn)(probe))
                np.testing.assert_array_equal(got, want)
                np.testing.assert_array_equal(
                    got, np.asarray(getattr(j, fn)(probe)))
            assert t.pump() == j.pump()
            for fn in ("lookup", "lookup_batched"):   # in sync
                got = u32(getattr(t, fn)(probe))
                np.testing.assert_array_equal(got, want)
                np.testing.assert_array_equal(
                    got, np.asarray(getattr(j, fn)(probe)))
            assert_same(j, t)
        assert arms == {"trad": 2, "shortcut": 2, "routed": 0}

        # mixed arm: a batch for the low shards only, not pumped, and (with
        # 4 shards) shards 1 and 2 refusing the shortcut by threshold
        low = distinct_keys(rng, 3000, lo=2**31, hi=2**32 - 2)
        low = low[j_shard_of_keys(low, j.shard_bits) < max(1, num_shards
                                                           // 2)][:60]
        low_vals = np.arange(60, dtype=np.uint32) + np.uint32(7_000)
        j.insert(low, low_vals)
        t.insert(low, low_vals)
        if num_shards == 4:
            for idx in (j, t):
                idx.shards[1].fan_in_threshold = -1.0
                idx.shards[2].fan_in_threshold = -1.0
        probe = np.concatenate([keys, low, misses])
        want = np.concatenate([vals, low_vals, np.full(100, MISS,
                                                       np.uint32)])
        got = u32(t.lookup_batched(probe))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got,
                                      np.asarray(j.lookup_batched(probe)))
        np.testing.assert_array_equal(u32(t.lookup(probe)),
                                      np.asarray(j.lookup(probe)))
        mixed = 1 if num_shards > 1 else 0
        assert arms == {"trad": 3 - mixed, "shortcut": 2, "routed": mixed}
        assert_same(j, t)
        assert t.pump() == j.pump()
        for fn in ("lookup", "lookup_batched"):
            np.testing.assert_array_equal(u32(getattr(t, fn)(probe)),
                                          np.asarray(getattr(j, fn)(probe)))
        assert_same(j, t)
        # an empty batch: no launch, no counters, no cache work
        before = (dict(arms), observe(t))
        for fn in ("lookup", "lookup_batched"):
            out = getattr(t, fn)(np.empty(0, np.uint32))
            assert out.shape == (0,) and out.dtype == torch.uint32
        assert (dict(arms), observe(t)) == before
    finally:
        j.close()
        t.close()


def test_bound_lookup_reads_the_stack(monkeypatch):
    """A bound shard's shortcut lookup goes through the stacked kernel's
    wrapper with the cache's own handle and its shard index."""
    from repro_torch.core import shortcut_eh
    rng = np.random.default_rng(5)
    keys = distinct_keys(rng, 300)
    seen = []
    orig = shortcut_eh.stacked_shortcut_lookup

    def spy(k, vk, vv, vl, shard, **kw):
        seen.append((vk, shard))
        return orig(k, vk, vv, vl, shard, **kw)

    monkeypatch.setattr(shortcut_eh, "stacked_shortcut_lookup", spy)
    with TSharded(12, 8, 2048, num_shards=2, device="cpu") as t:
        t.insert(keys, np.arange(300, dtype=np.uint32))
        t.pump()
        np.testing.assert_array_equal(u32(t.lookup(keys)), np.arange(300))
        handle = t.operands.handle("eh_view")
        assert [s for _, s in seen] == [0, 1]
        assert all(vk is handle[0] for vk, _ in seen)


@pytest.mark.parametrize("num_shards", [2, 4])
def test_async_readers_race_publishes(num_shards):
    """Mapper threads replay and publish copy-on-write into the stack while
    the main thread and a reader thread look up: every answer is right at
    every step, and the final states equal the reference's."""
    rng = np.random.default_rng(10 + num_shards)
    keys = distinct_keys(rng, 900)
    vals = np.arange(900, dtype=np.uint32)
    misses = distinct_keys(rng, 120, lo=2**31, hi=2**32 - 2)
    done = [0]
    errors = []
    stop = threading.Event()
    t = TSharded(12, 8, 2048, num_shards=num_shards, async_mapper=True,
                 poll_interval=0.001, device="cpu")

    def reader():
        r = np.random.default_rng(1)
        try:
            while not stop.is_set():
                n = done[0]
                if not n:
                    continue
                probe = r.choice(keys[:n], 64)
                got = u32(t.lookup_batched(probe))
                np.testing.assert_array_equal(
                    got, vals[sorter[np.searchsorted(keys_sorted, probe)]])
        except Exception as e:                  # pragma: no cover
            errors.append(e)

    sorter = np.argsort(keys)
    keys_sorted = keys[sorter]
    th = threading.Thread(target=reader)
    th.start()
    try:
        for i in range(0, 900, 90):
            t.insert(keys[i:i + 90], vals[i:i + 90])
            done[0] = i + 90
            probe = np.concatenate([keys[:i + 90], misses])
            perm = rng.permutation(probe.size)
            want = np.concatenate([vals[:i + 90],
                                   np.full(120, MISS, np.uint32)])[perm]
            for _ in range(3):                  # replays race these
                np.testing.assert_array_equal(
                    u32(t.lookup_batched(probe[perm])), want)
                np.testing.assert_array_equal(u32(t.lookup(probe[perm])),
                                              want)
        assert t.wait_in_sync(timeout=60.0)
        np.testing.assert_array_equal(u32(t.lookup_batched(keys)), vals)
        h0 = t.operands.stats.hits
        np.testing.assert_array_equal(u32(t.lookup_batched(keys)), vals)
        assert t.operands.stats.hits > h0
        assert t.routed_shortcut > 0 and t.check_invariants()["ok"]
    finally:
        stop.set()
        th.join(timeout=60.0)
        t.close()
    assert not errors, errors
    # the insert is sequential per key, so one batch builds the same states
    j = JSharded(12, 8, 2048, num_shards=num_shards)
    j.insert(keys, vals)
    for js, ts in zip(j.shards, t.shards):
        for a, b in zip(state_to_numpy(ts.state), js.state):
            np.testing.assert_array_equal(a, np.asarray(b))
    j.close()


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSharded(4, 4, 8, num_shards=2)
    with pytest.raises(ValueError, match="power of two"):
        TSharded(4, 4, 8, num_shards=3, device="cpu")
