"""Port parity: ``repro_torch.runtime.shard_group`` against
``repro.runtime.shard_group`` — the cross-shard batching helpers on the same
keys, ``MapperGroup`` driven through the same toy maintenance trace, and
``ShardViewRegistry`` in both storage modes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sharded_eh import shard_of_keys as j_shard_of_keys
from repro.runtime import mapper as jm
from repro.runtime import shard_group as jsg
from repro.runtime.operand_cache import StackedOperandCache as JCache
from repro_torch.core.sharded_eh import shard_of_keys as t_shard_of_keys
from repro_torch.runtime import mapper as tm
from repro_torch.runtime import shard_group as tsg
from repro_torch.runtime.operand_cache import StackedOperandCache as TCache

PKGS = {"jax": (jm, jsg), "torch": (tm, tsg)}


def distinct_keys(rng, n, lo=1, hi=2**31):
    return (rng.choice(hi - lo, n, replace=False) + lo).astype(np.uint32)


def test_pad_batch():
    for n in [0, 1, 63, 64, 65, 4096, 70_000, 262_144, 262_145, 1_000_000]:
        assert tsg.pad_batch(n) == jsg.pad_batch(n)


@pytest.mark.parametrize("bits", [0, 1, 2, 3])
def test_shard_of_keys(rng, bits):
    keys = np.concatenate([distinct_keys(rng, 500),
                           np.asarray([0, 1, 0xFFFFFFFE], np.uint32)])
    got = t_shard_of_keys(torch.from_numpy(keys.view(np.int32)), bits)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), j_shard_of_keys(keys, bits))


@pytest.mark.parametrize("num_shards,cap_extra", [(1, 0), (4, 0), (8, 37)])
def test_partition_round_trip(rng, num_shards, cap_extra):
    """Same order (numpy's stable argsort), counts, starts, padded rows and
    ranks as the reference; and scatter-back restores the input."""
    keys = distinct_keys(rng, 700)
    sid = j_shard_of_keys(keys, num_shards.bit_length() - 1)
    order, counts, starts = jsg.shard_order(sid, num_shards)
    t_order, t_counts, t_starts = tsg.shard_order(torch.from_numpy(sid),
                                                  num_shards)
    np.testing.assert_array_equal(t_order.numpy(), order)
    np.testing.assert_array_equal(t_counts.numpy(), counts)
    np.testing.assert_array_equal(t_starts.numpy(), starts)
    cap = int(counts.max()) + cap_extra
    want = jsg.partition_by_shard(keys, sid, num_shards, cap, fill=5)
    tkeys = torch.from_numpy(keys.view(np.int32)).view(torch.uint32)
    got = tsg.partition_by_shard(tkeys, torch.from_numpy(sid), num_shards,
                                 cap, fill=5)
    assert got[0].dtype == torch.uint32
    np.testing.assert_array_equal(got[0].view(torch.int32).numpy()
                                  .view(np.uint32), want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), w)
    padded, _, t_order, rank = got
    out = torch.empty_like(tkeys.view(torch.int32))
    out[t_order] = padded.view(torch.int32)[torch.from_numpy(sid)[t_order],
                                            rank]
    np.testing.assert_array_equal(out.numpy().view(np.uint32), keys)


class _Toy:
    """Minimal per-shard runtime client of either package's mapper."""

    def __init__(self, m):
        self.m = m
        self.data, self.view = {}, {}
        self.mapper = m.ShortcutMapper(
            replay_create=lambda snap, reqs: self.view.update(snap),
            replay_update=self._replay_update,
            snapshot=lambda: dict(self.data),
            view_arrays=tuple, routing=m.FanInRouting(8.0))

    def _replay_update(self, snap, requests):
        for r in requests:
            k, v = r.payload
            self.view[k] = v

    def put(self, key, val, kind="update"):
        with self.mapper.lock:
            self.data[key] = val
            versions = self.mapper.record([self.m.GLOBAL_VIEW])
        if kind == "create":
            self.mapper.submit_create([self.m.GLOBAL_VIEW], versions)
        else:
            self.mapper.submit_update([self.m.GLOBAL_VIEW], versions,
                                      payload=(key, val))


def _group_trace(pkg):
    """One trace through a 3-shard group; everything observable, in order."""
    m, sg = PKGS[pkg]
    toys = [_Toy(m) for _ in range(3)]
    group = sg.MapperGroup([t.mapper for t in toys],
                           router=lambda k: int(k) % 3)
    seen = []
    toys[1].put(3, "b")
    toys[0].put(0, "a", kind="create")
    seen.append([g.stats.collapsed for g in group])
    group[1].pump()
    seen.append((group.in_sync({1: [m.GLOBAL_VIEW]}),
                 group.in_sync({0: [m.GLOBAL_VIEW]}), group.in_sync()))
    for i in range(6):
        toys[i % 3].put(i, i)
    seen.append(group.pump())
    agg = group.stats
    seen.append((agg.creates, agg.updates, agg.collapsed,
                 [(s.creates, s.updates) for s in group.per_shard_stats()]))
    group.count_route(True)
    group.count_route(False, shard=2)
    group.count_route(True, shard=0)
    seen.append((group.routed_shortcut, group.routed_fallback,
                 [(g.routed_shortcut, g.routed_fallback) for g in group]))
    seen.append((group.route(7), group.mapper_for(5) is group[2],
                 [t.view for t in toys], len(group)))
    seen.append(group.wait_in_sync({0: None, 2: [m.GLOBAL_VIEW]},
                                   timeout=1.0))
    group[1].threshold = 0.5
    seen.append((group.gate(1.0, {0: [m.GLOBAL_VIEW]}),
                 group.gate(1.0, {0: [m.GLOBAL_VIEW], 1: [m.GLOBAL_VIEW]}),
                 group.gate(1.0)))
    with pytest.raises(IndexError):
        sg.MapperGroup([toys[0].mapper], router=lambda k: 5).route("x")
    with pytest.raises(ValueError):
        sg.MapperGroup([])
    with pytest.raises(ValueError):
        sg.MapperGroup([toys[0].mapper]).route("x")
    group.close()
    return seen


def test_mapper_group_trace():
    """Collapse stays per shard, aggregated stats, group-level vs shard
    route counters, the router, the shared deadline and the gate: the same
    observations from both packages."""
    assert _group_trace("torch") == _group_trace("jax")


class _Counting:
    def __init__(self, accept):
        self.accept, self.calls = accept, 0

    def decide(self, metric):
        self.calls += 1
        return self.accept


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_gate_decides_each_policy_once(pkg):
    """A policy object shared by several shards decides once per gate, and
    every distinct policy decides even after one refused (no
    short-circuit)."""
    m, sg = PKGS[pkg]
    shared, refuse, last = _Counting(True), _Counting(False), _Counting(True)
    policies = [shared, shared, refuse, last, shared]
    mappers = [m.ShortcutMapper(
        replay_create=lambda s, r: None, replay_update=lambda s, r: None,
        snapshot=dict, view_arrays=tuple, routing=p) for p in policies]
    group = sg.MapperGroup(mappers)
    assert group.gate(1.0) is False
    assert (shared.calls, refuse.calls, last.calls) == (1, 1, 1)
    assert group.gate(1.0, {0: None, 1: None, 4: None}) is True
    assert (shared.calls, refuse.calls, last.calls) == (2, 1, 1)
    with mappers[3].lock:
        mappers[3].record([m.GLOBAL_VIEW])       # shard 3 out of sync
    assert group.gate(1.0) is False              # the version gate first
    assert (shared.calls, refuse.calls, last.calls) == (2, 1, 1)


def _registry_trace(pkg):
    """Standalone and cache-backed registries through one publication
    sequence; returns what a reader sees, as numpy."""
    _, sg = PKGS[pkg]
    if pkg == "jax":
        arr, cache_cls = (lambda a: jnp.asarray(a)), JCache
    else:
        arr, cache_cls = torch.from_numpy, TCache
    npy = np.asarray if pkg == "jax" else (lambda t: t.numpy())
    seen = []
    reg = sg.ShardViewRegistry(2)
    seen.append((len(reg), reg.snapshot(0), reg.arrays(1), reg.epochs()))
    reg.publish(1, [arr(np.arange(4, dtype=np.int32)),
                    arr(np.ones(4, np.int32))])
    reg.publish(1, [arr(np.full(4, 3, np.int32)),
                    arr(np.zeros(4, np.int32))], epoch=99)   # ignored
    seen.append((reg.epoch(1), reg.epochs(), reg.snapshot(0),
                 [npy(a).tolist() for a in reg.snapshot(1)],
                 [npy(a).tolist() for a in reg.arrays(1)],
                 [x is None for x in reg.snapshot_all()]))

    cache = cache_cls(2)
    reg = sg.ShardViewRegistry(2, cache=cache, family="v")
    seen.append((reg.epochs(), reg.snapshot(0), reg.arrays(0)))
    with pytest.raises(ValueError, match="client epoch"):
        reg.publish(0, [arr(np.ones((2, 3), np.int32))])
    reg.publish(0, [arr(np.ones((2, 3), np.int32))], epoch=4)
    reg.publish(1, [arr(np.full((3, 3), 2, np.int32))], epoch=2)
    snap = reg.snapshot(0)
    seen.append((reg.epochs(), reg.epoch(1),
                 [npy(a).tolist() for a in snap],
                 reg.snapshot(0) is snap,
                 [npy(a).tolist() for a in reg.arrays(1)],
                 npy(reg.snapshot_all()[1][0]).tolist(),
                 cache.published("v"), cache.stats.rebuilds,
                 cache.stats.publish_refreshes))
    with pytest.raises(ValueError, match="shards"):
        sg.ShardViewRegistry(3, cache=cache)
    with pytest.raises(ValueError):
        sg.ShardViewRegistry(0)
    return seen


def test_view_registry_both_modes():
    assert _registry_trace("torch") == _registry_trace("jax")
