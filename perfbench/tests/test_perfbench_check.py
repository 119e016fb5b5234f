"""The check that decides ``correct``, driven through the rest of a run on
the CPU at test size (the harness's look for a card skipped): sound runs
come out correct; the control (the reference one insert batch stale) and
each fault planted in the timed path underneath come out not correct.

Faults, each in the cell's own timed path: an insert that returns the
state unchanged; half of each batch left out (of a lookup's answers, or of
an insert's keys); one answer altered where it is produced (a lookup
kernel's output, or a value as an insert stores it).  The exchange between
chips has no fault to plant: every cell runs on one card.
"""
import json

import pytest
import torch

from perfbench import control, spec
from perfbench.tests import stand_in
from repro_torch.core import extendible_hashing as eh
from repro_torch.core.sharded_eh import ShardedShortcutEH
from repro_torch.core.shortcut_eh import ShortcutEH
from repro_torch.kernels import eh_lookup

BENCH = json.loads((stand_in.REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
READS = {w["name"] for w in BENCH["workloads"]
         if w["traffic"].startswith("read")}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return stand_in.tiny_copy(tmp_path_factory.mktemp("tiny"))


def _half_lookup(orig):
    """The lookup answers the first half of the batch; the rest is left
    out (MISS)."""
    def half(self, keys, *a, **kw):
        keys = torch.as_tensor(keys).reshape(-1)
        out = torch.full(keys.shape, -1, dtype=torch.int32,
                         device=keys.device)
        n = keys.numel() // 2
        out[:n] = orig(self, keys[:n], *a, **kw).view(torch.int32)
        return out.view(torch.uint32)
    return half


def _plant(monkeypatch, fault: str, cell: str) -> None:
    insert, run = eh.eh_insert_many, eh_lookup._run
    if fault == "state_unchanged":
        monkeypatch.setattr(eh, "eh_insert_many",
                            lambda st, k, v: eh.clone_state(st))
    elif fault == "half_batch" and cell in READS:
        for cls, name in ((ShortcutEH, "lookup"),
                          (ShardedShortcutEH, "lookup_batched")):
            monkeypatch.setattr(cls, name, _half_lookup(getattr(cls, name)))
    elif fault == "half_batch":
        monkeypatch.setattr(
            eh, "eh_insert_many",
            lambda st, k, v: insert(st, k[:k.numel() // 2],
                                    v[:v.numel() // 2]))
    elif fault == "answer_altered" and cell in READS:
        def altered(*a, **kw):
            out = run(*a, **kw).view(torch.int32).clone()
            out.view(-1)[0] ^= 1
            return out.view(torch.uint32)
        monkeypatch.setattr(eh_lookup, "_run", altered)
    elif fault == "answer_altered":
        def altered_insert(st, k, v):
            v = v.clone()
            v[0] ^= 1
            return insert(st, k, v)
        monkeypatch.setattr(eh, "eh_insert_many", altered_insert)
    else:
        raise ValueError(fault)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(tiny, cell):
    for seed in (3, 2**32 + 3):
        rc, res = stand_in.run(tiny, cell, seed=seed, seconds=0.3)
        assert rc == 0 and res["correct"]
        assert res["checks"]["wrong"] == {"value": 0, "limit": 0}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny, cell):
    ref = spec.resolve(json.loads((tiny / "BENCHMARK.json").read_text()),
                       cell, tiny / "perfbench").reference
    rc, res = stand_in.run(tiny, cell, seconds=0.3,
                           system=control.StaleSystem(ref))
    assert rc == 0 and not res["correct"]
    assert res["checks"]["wrong"]["value"] > 0


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(tiny, cell, fault, monkeypatch):
    _plant(monkeypatch, fault, cell)
    rc, res = stand_in.run(tiny, cell, seconds=0.3)
    assert rc == 0 and not res["correct"], res
    assert res["checks"]["wrong"]["value"] > 0


@pytest.mark.parametrize("system", sorted(stand_in.TINY_CONFIGS))
def test_a_closed_index_is_freed(system):
    """What the ingest episodes rely on: once the harness drops a closed
    index, ``collect`` leaves nothing of the program's index alive."""
    import importlib

    from perfbench.kinds.common import closed, collect
    cfg = dict(stand_in.TINY_CONFIGS[system], fan_in_threshold=8,
               poll_interval=0.002, async_mapper=True)
    mod = importlib.import_module(f"perfbench.systems.{system}")
    ix = mod.build(cfg, "cpu")
    keys = torch.arange(1, 200, dtype=torch.int32)
    ix.insert(keys, keys)
    assert ix.wait_in_sync(30)
    program = closed(ix)
    del ix
    collect(program)
    assert program() is None
