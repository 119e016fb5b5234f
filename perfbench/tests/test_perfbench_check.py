"""The check that decides ``correct``, driven through the rest of a run on
the CPU at test size (the harness's look for a card skipped): sound runs
come out correct; the control (an index cell's: the reference one insert
batch stale; a served model's: the reference in float8) and each fault
planted in the timed path underneath come out not correct.

Faults, each in the cell's own timed path: an insert, or a decode step
(``control.FAULTS``' own), that returns the state unchanged; half of each
batch left out (of a lookup's answers, of an insert's keys, or of a decode
step's sequences, the rest's tokens standing in for them); one answer
altered where it is produced (a lookup kernel's output, a value as an
insert stores it, or a decode step's token).  A served model's cells
also hold the wrong decodes of ``control.FAULTS``.  The exchange between
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
from repro_torch.runtime import serve as rt

BENCH = json.loads((stand_in.REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
READS = {w["name"] for w in BENCH["workloads"]
         if w["traffic"].startswith("read")}
SERVES = {w["name"] for w in BENCH["workloads"] if json.loads(
    (stand_in.REPO / "perfbench" / "traffic" / f"{w['traffic']}.json")
    .read_text())["kind"] == "serve"}


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


def _serve_step(monkeypatch, wrong) -> None:
    """The program's serving step replaced by ``wrong(step, params, state,
    token)``, where ``step`` is the sound one."""
    make = rt.make_serve_step

    def made(cfg):
        step = make(cfg)
        return lambda params, state, token: wrong(step, params, state, token)
    monkeypatch.setattr(rt, "make_serve_step", made)


def _half(step, params, state, token):
    """The first half of the sequences decoded; their tokens stand in for
    the rest's."""
    tok, state = step(params, state, token)
    out = tok.clone()
    n = (tok.numel() + 1) // 2
    out[n:] = tok[:tok.numel() - n]
    return out, state


def _altered(step, params, state, token):
    """The first sequence's token moved to the next id."""
    tok, state = step(params, state, token)
    out = tok.clone()
    out[0] += 1
    return out, state


def _plant(monkeypatch, fault: str, cell: str) -> None:
    insert, run = eh.eh_insert_many, eh_lookup._run
    if cell in SERVES and fault == "state_unchanged":
        module, attr, wrong = control.FAULTS[fault]()
        monkeypatch.setattr(module, attr, wrong)
    elif cell in SERVES:
        _serve_step(monkeypatch, {"half_batch": _half,
                                  "answer_altered": _altered}[fault])
    elif fault == "state_unchanged":
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


def _past(res) -> bool:
    """Some number the check compared lies past its limit."""
    return any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(tiny, cell):
    for seed in (3, 2**32 + 3):
        rc, res = stand_in.run(tiny, cell, seed=seed, seconds=0.3)
        assert rc == 0 and res["correct"]
        if cell in SERVES:
            assert set(res["checks"]) == set(stand_in.TINY_LIMITS)
            assert not _past(res)
        else:
            assert res["checks"]["wrong"] == {"value": 0, "limit": 0}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny, cell):
    c = spec.resolve(json.loads((tiny / "BENCHMARK.json").read_text()),
                     cell, tiny / "perfbench")
    system = control.LowPrecision(c.system) if cell in SERVES else \
        control.StaleSystem(c.reference)
    rc, res = stand_in.run(tiny, cell, seconds=0.3, system=system)
    assert rc == 0 and not res["correct"]
    assert _past(res)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(tiny, cell, fault, monkeypatch):
    _plant(monkeypatch, fault, cell)
    # a served cell's window serves a few requests, as the card's does
    rc, res = stand_in.run(tiny, cell, seconds=1.5 if cell in SERVES
                           else 0.3)
    assert rc == 0 and not res["correct"], res
    assert _past(res)


#: the wrong decodes of ``control.FAULTS`` (besides the state handed back
#: unchanged, above) that move a greedy token at test size.  The rotary
#: position off by one and a zeroed SSM state move none there; PERF.md §2
#: has their readings on the card
WRONG_DECODES = [("qwen2_moe_a2_7b.azure_code", "topk_not_renormalized")]


@pytest.mark.parametrize("cell, fault", WRONG_DECODES)
def test_wrong_decode_is_not_correct(tiny, cell, fault):
    with control.planted(fault):
        rc, res = stand_in.run(tiny, cell, seconds=0.3)
    assert rc == 0 and not res["correct"], res
    assert _past(res)


def test_a_check_that_compares_nothing_is_not_correct():
    """The harness takes a run whose check compared no number as not
    correct, whatever the kind returns."""
    import argparse
    import types

    from perfbench import harness
    from perfbench.kinds.common import Window
    kind = types.SimpleNamespace(
        LIMITS={}, prepare=lambda env: {}, start=lambda env, st: None,
        window=lambda env, st: Window(attempted=1, failed=0,
                                      end_to_end={"x": 1.0}),
        check=lambda env, st: ({}, 0))
    cell = types.SimpleNamespace(
        config={"limits": {}}, traffic={"kind": "stub"}, system=None,
        reference=None, kind=kind, per_layer=[], name="stub",
        end_to_end=[{"name": "x", "unit": "1"},
                    {"name": "setup_s", "unit": "s"}])
    args = argparse.Namespace(seed=1, seconds=0.1, trace=0)
    res, _ = harness.run_cell(cell, args, dev=stand_in.CpuStandIn(),
                              device=torch.device("cpu"), t_start=0.0)
    assert res["checks"] == {} and res["correct"] is False


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
