"""Port parity: the scenarios of ``tests/test_mapper.py`` driven through
both maintenance runtimes, ``repro.runtime.mapper`` and
``repro_torch.runtime.mapper``; every observable must be identical."""
import numpy as np
import pytest

from repro.runtime import mapper as jmapper
from repro_torch.runtime import mapper as tmapper

from conftest import unique_keys


class ToyClient:
    """Minimal runtime client: authoritative dict, dict-replica view."""

    def __init__(self, m, **kw):
        self.m = m
        self.data = {}
        self.view = {}
        self.create_calls = 0
        self.update_keys = []
        self.mapper = m.ShortcutMapper(
            replay_create=self._replay_create,
            replay_update=self._replay_update,
            snapshot=lambda: dict(self.data), view_arrays=tuple,
            routing=kw.pop("routing", m.FanInRouting(8.0)), **kw)

    def put(self, key, val, kind="update"):
        with self.mapper.lock:
            self.data[key] = val
            versions = self.mapper.record([self.m.GLOBAL_VIEW])
        if kind == "create":
            self.mapper.submit_create([self.m.GLOBAL_VIEW], versions)
        else:
            self.mapper.submit_update([self.m.GLOBAL_VIEW], versions,
                                      payload=(key, val))

    def _replay_create(self, snap, requests):
        self.create_calls += 1
        self.view = dict(snap)

    def _replay_update(self, snap, requests):
        for r in requests:
            key, val = r.payload
            self.view[key] = val
            self.update_keys.append(key)

    def observe(self, *keys):
        s = self.mapper.stats
        keys = keys or (self.m.GLOBAL_VIEW,)
        return {"view": dict(self.view), "creates": self.create_calls,
                "update_keys": list(self.update_keys),
                "versions": [self.mapper.versions(k) for k in keys],
                "in_sync": self.mapper.in_sync(list(keys)),
                "stats": (s.creates, s.updates, s.collapsed,
                          s.slots_remapped)}


def monotone_and_gated(m):
    t, seen = ToyClient(m), []
    for i in range(3):
        t.put(f"k{i}", i)
        seen.append((t.mapper.versions(m.GLOBAL_VIEW), t.mapper.in_sync()))
        t.mapper.pump()
        seen.append((t.mapper.versions(m.GLOBAL_VIEW), t.mapper.in_sync()))
    return seen, t.observe()


def publish_never_decreases(m):
    t = ToyClient(m)
    t.put("a", 1)
    t.put("b", 2)
    t.mapper.pump()
    t.mapper.submit_update([m.GLOBAL_VIEW], [1], payload=("a", 1))
    t.mapper.pump()
    return t.observe()


def invalidate_desyncs(m):
    t = ToyClient(m)
    t.put("a", 1)
    t.mapper.pump()
    with t.mapper.lock:
        t.mapper.invalidate([m.GLOBAL_VIEW])
    return t.observe()


def create_collapses_at_enqueue(m):
    t = ToyClient(m)
    t.put("a", 1)
    t.put("b", 2)
    t.put("c", 3, kind="create")
    before = t.mapper.stats.collapsed
    t.mapper.pump()
    return before, t.observe()


def batch_side_collapse(m):
    t = ToyClient(m)
    with t.mapper.lock:
        (v1,) = t.mapper.record([m.GLOBAL_VIEW])
        t.data["x"] = 1
        (v2,) = t.mapper.record([m.GLOBAL_VIEW])
        t.data["y"] = 2
    t.mapper._queue.put(m.Request(m.CREATE, {m.GLOBAL_VIEW: v2}))
    t.mapper.submit_update([m.GLOBAL_VIEW], [v1], payload=("x", 1))
    t.mapper.pump()
    return t.observe()


def newer_update_survives_create(m):
    t = ToyClient(m)
    t.put("a", 1, kind="create")
    t.put("b", 2)
    t.mapper.pump()
    return t.observe()


def per_key_collapse_is_not_global(m):
    t = ToyClient(m)
    with t.mapper.lock:
        (vs0,) = t.mapper.record(["seq0"])
        (vs1,) = t.mapper.record(["seq1"])
    t.mapper.submit_update(["seq1"], [vs1], payload=("s1", 1))
    t.mapper.submit_create(["seq0"], [vs0])
    before = t.mapper.stats.collapsed
    t.mapper.pump()
    return before, t.observe("seq0", "seq1")


def routing_policies(m):
    fan = m.FanInRouting(8.0)
    frag = m.FragmentationRouting(0.25)
    hyst = m.HysteresisRouting(m.FanInRouting(6.0), m.FanInRouting(10.0))
    return ([fan.decide(x) for x in (8.0, 1.0, 8.0 + 1e-9)],
            [frag.decide(x) for x in (0.25, 1.0, 0.25 - 1e-9)],
            [hyst.decide(x) for x in (7.0, 5.0, 9.0, 11.0, 9.0)])


def gate_requires_sync_and_policy(m):
    t = ToyClient(m, routing=m.FanInRouting(8.0))
    t.put("a", 1)
    out = [t.mapper.gate(1.0, [m.GLOBAL_VIEW])]
    t.mapper.pump()
    out += [t.mapper.gate(1.0, [m.GLOBAL_VIEW]),
            t.mapper.gate(9.0, [m.GLOBAL_VIEW])]
    for used in (True, False, False):
        t.mapper.count_route(used)
    t.mapper.threshold = 0.5
    return out, t.mapper.threshold, (t.mapper.routed_shortcut,
                                     t.mapper.routed_fallback)


def async_thread_converges(m):
    t = ToyClient(m, poll_interval=0.002, async_mapper=True)
    try:
        for i in range(5):
            t.put(f"k{i}", i, kind="create" if i == 2 else "update")
            assert t.mapper.wait_in_sync(timeout=30.0)
        return t.view, t.mapper.versions(m.GLOBAL_VIEW)
    finally:
        t.mapper.close()


def publish_epochs(m):
    """trad_epoch moves with record/invalidate; a replay publishes at
    next_view_epoch, and view_epoch reaches it before sc_version moves."""
    t, seen = ToyClient(m), []
    during = []
    replay = t._replay_update

    def spy(snap, requests):
        during.append((t.mapper.next_view_epoch, t.mapper.view_epoch,
                       t.mapper.sc_version(m.GLOBAL_VIEW)))
        replay(snap, requests)

    t.mapper._replay_update = spy
    for i in range(3):
        t.put(f"k{i}", i)
        seen.append((t.mapper.trad_epoch, t.mapper.view_epoch))
    t.mapper.pump()
    with t.mapper.lock:
        t.mapper.invalidate([m.GLOBAL_VIEW])
    seen.append((t.mapper.trad_epoch, t.mapper.view_epoch,
                 t.mapper.next_view_epoch))
    t.put("k9", 9, kind="create")
    t.mapper.pump()
    seen.append((t.mapper.trad_epoch, t.mapper.view_epoch))
    return seen, during


SCENARIOS = [monotone_and_gated, publish_never_decreases, invalidate_desyncs,
             create_collapses_at_enqueue, batch_side_collapse,
             newer_update_survives_create, per_key_collapse_is_not_global,
             routing_policies, gate_requires_sync_and_policy,
             async_thread_converges, publish_epochs]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_parity(scenario):
    assert scenario(tmapper) == scenario(jmapper)


def test_populate_is_a_noop_for_cpu_tensors():
    import torch
    tmapper._populate([torch.zeros(3), torch.ones(2)])
    tmapper._populate(())


@pytest.mark.parametrize("mode", ["pump", "async"])
def test_eh_client_parity(rng, mode):
    """The EH client over both runtimes: same views, versions, stats."""
    from repro.core.shortcut_eh import ShortcutEH as JEH
    from repro_torch.core.shortcut_eh import ShortcutEH as TEH
    keys = unique_keys(rng, 300)
    vals = np.arange(300, dtype=np.uint32)
    out = []
    for make in (lambda **k: JEH(**k), lambda **k: TEH(device="cpu", **k)):
        with make(max_global_depth=8, bucket_slots=16, capacity=512,
                  poll_interval=0.003, async_mapper=(mode == "async")) as sc:
            for i in range(0, 300, 60):
                sc.insert(keys[i:i + 60], vals[i:i + 60])
                assert sc.wait_in_sync(timeout=30.0)
            s = sc.stats
            out.append((np.array(sc.view_keys), np.array(sc.view_vals),
                        sc.versions(), (s.creates, s.updates, s.collapsed,
                                        s.slots_remapped)))
    np.testing.assert_array_equal(out[1][0], out[0][0])
    np.testing.assert_array_equal(out[1][1], out[0][1])
    assert out[1][2:] == out[0][2:]
