"""Ingest traffic: episodes of a whole load, one after the other.

An episode builds an empty index of the configuration, inserts the
``config["records"]`` keys in ``episode_batches`` batches through the
index's own ``insert`` with its mapper running, and waits until the
shortcut has caught up.  Every episode inserts the same records (made once
from the seed; each is new to the episode's empty index).  The window runs
episodes until its time is up; the keys of a partial episode count.
Set-up warms the path on a throwaway index: the first batch inserted
twice, each time caught up, then the close.  New keys split buckets and
double the directory, which the mapper replays by composing the view
anew; the same keys again split nothing, which it replays by remapping the
touched slots (the ragged-copy kernel, built and loaded at its first
use).  An episode's later batches take one of those two paths.  A
traced run traces the whole window, so that its idle share covers whole
episodes; the tracer logs the trace's size.
"""
from __future__ import annotations

import torch

from perfbench import keys as keygen
from perfbench.kinds.common import Window, closed, collect

#: the limit of each number the check compares (an exact comparison)
LIMITS = {"wrong": 0}

#: probes answered per lookup call of the check
CHECK_BLOCK = 1 << 24


def prepare(env) -> dict:
    t, n, dev = env.traffic, env.config["records"], env.device
    both = keygen.make_keys(n + t["absent_check_keys"], env.seed, dev)
    return {"keys": both[:n], "absent": both[n:],
            "vals": keygen.make_values(n, env.seed, dev)}


def _batch(st: dict, env, b: int):
    E = env.traffic["episode_batches"]
    step = -(-st["keys"].numel() // E)
    return (st["keys"][b * step:(b + 1) * step],
            st["vals"][b * step:(b + 1) * step])


def start(env, st: dict) -> None:
    ix = env.build_index()
    for _ in range(2):
        ix.insert(*_batch(st, env, 0))
        if not ix.wait_in_sync(env.traffic["catch_up_timeout_s"]):
            raise RuntimeError("the shortcut did not catch up in the "
                               "warm-up")
    program = closed(ix)
    del ix
    collect(program)


def window(env, st: dict) -> Window:
    t = env.traffic
    E = t["episode_batches"]
    ix, inserted, batches, slots, done = None, 0, 0, 0, 0
    tracer = env.tracer() if env.trace else None
    if tracer:
        tracer.start()
    t0 = env.clock()
    deadline = t0 + env.seconds
    while True:
        with env.span("bench.episode_reset"):
            if ix is not None:
                slots += ix.counters()["slots_remapped"]
                program, ix = closed(ix), None
                collect(program)
            ix = env.build_index()
        done = 0
        for b in range(E):
            keys, vals = _batch(st, env, b)
            with env.span("bench.insert_call"):
                ix.insert(keys, vals)
            inserted += keys.numel()
            done += 1
            batches += 1
            if env.clock() >= deadline:
                break
        else:
            with env.span("bench.catch_up"):
                if not ix.wait_in_sync(t["catch_up_timeout_s"]):
                    raise RuntimeError("the shortcut did not catch up")
        if env.clock() >= deadline:
            break
    window_s = env.clock() - t0
    view = tracer.stop() if tracer else None
    slots += ix.counters()["slots_remapped"]
    st["index"], st["final_batches"] = ix, done
    return Window(
        attempted=batches, failed=0,
        end_to_end={"insert_rate": inserted / window_s / 1e6},
        counters={"keys_inserted": inserted, "slots_remapped": slots,
                  "keys_inserted_traced": inserted if view else 0},
        trace=view)


def _lookup_all(ix, probes: torch.Tensor) -> torch.Tensor:
    return torch.cat([ix.lookup(probes[i:i + CHECK_BLOCK]).view(torch.int32)
                      for i in range(0, probes.numel(), CHECK_BLOCK)])


def check(env, st: dict) -> tuple:
    """The last episode's index read back once it has caught up: every key
    it was given and ``absent_check_keys`` it was not, on the route the
    gate picks and on the traditional route, against the reference."""
    ix = st.pop("index")
    n_in = sum(_batch(st, env, b)[0].numel()
               for b in range(st["final_batches"]))
    ix.wait_in_sync(env.traffic["catch_up_timeout_s"])
    present, absent = st["keys"][:n_in], st["absent"]
    got = [(_lookup_all(ix, present), _lookup_all(ix, absent))]
    ix.route_traditional()
    got.append((_lookup_all(ix, present), _lookup_all(ix, absent)))
    program = closed(ix)
    del ix
    collect(program)
    ref = env.reference.KVMap(present, st["vals"][:n_in])
    want = (ref.lookup(present), ref.lookup(absent))
    wrong, compared = 0, 0
    for pair in got:
        for g, w in zip(pair, want):
            wrong += int((g != w).sum())
            compared += w.numel()
    return {"wrong": wrong}, compared
