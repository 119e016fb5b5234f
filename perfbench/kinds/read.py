"""Read traffic: one client in a closed loop of lookup requests.

Set-up makes the records (``config["records"]`` keys and values from the
seed), loads them through the index's own ``insert`` in
``load_batches`` batches, waits until the shortcut has caught up, and
draws ``pool_requests`` requests of ``request_keys`` present keys each
(``distribution``: ``uniform``, or YCSB's ``scrambled_zipfian`` over the
records) on the device.  The index's resident bytes are read once it
has caught up and been warmed.  The window sends request after request
(pool row ``i mod pool_requests``), each timed from its issue until its
completion event has synchronised, on the device's clock.  A reservoir
drawn from the seed keeps ``retain_requests`` of the window's answers for
the check.  A traced run traces the window's first ``trace_seconds``.
"""
from __future__ import annotations

import random
import time

import numpy as np
import torch

from perfbench import keys as keygen
from perfbench import zipf
from perfbench.kinds.common import Window, closed, collect, seed_for

#: the limit of each number the check compares (an exact comparison)
LIMITS = {"wrong": 0}


def _items(t: dict, n: int, size: int, g, device) -> torch.Tensor:
    dist = t["distribution"]
    if dist == "uniform":
        return torch.randint(0, n, (size,), generator=g, device=device)
    if dist == "scrambled_zipfian":
        p = zipf.ZipfParams(items=t["zipf_items"],
                            theta=t["zipfian_constant"], zetan=t["zetan"])
        return zipf.scrambled_zipfian(size, n, g, device, p)
    raise ValueError(f"unknown distribution {dist!r}")


def resident_bytes(env) -> int:
    """Device bytes allocated once the mapper threads have gone idle: read
    two polling intervals after the caller saw the views caught up, so that
    a mapper thread that has just published has also dropped the snapshot
    and the old view it replayed from."""
    time.sleep(2 * float(env.config["poll_interval"]))
    env.dev.synchronize()
    return env.dev.memory_allocated()


def prepare(env) -> dict:
    t, n, dev = env.traffic, env.config["records"], env.device
    B, P = t["request_keys"], t["pool_requests"]
    keys = keygen.make_keys(n, env.seed, dev)
    vals = keygen.make_values(n, env.seed, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed_for(env.seed, "pool"))
    pool = torch.empty((P, B), dtype=torch.int32, device=dev)
    for r in range(P):
        pool[r] = keys[_items(t, n, B, g, dev)]
    K = t["retain_requests"]
    return {"keys": keys, "vals": vals, "pool": pool,
            "retain": torch.empty((K, B), dtype=torch.int32, device=dev),
            "retain_rows": []}


def start(env, st: dict) -> None:
    t, n = env.traffic, env.config["records"]
    keys, vals = st["keys"], st["vals"]
    ix = env.build_index()
    step = -(-n // t["load_batches"])
    for i in range(0, n, step):
        ix.insert(keys[i:i + step], vals[i:i + step])
    if not ix.wait_in_sync(t["catch_up_timeout_s"]):
        raise RuntimeError("the shortcut did not catch up after the load")
    for r in range(min(2, st["pool"].shape[0])):
        ix.lookup(st["pool"][r])
    st["resident_bytes"] = resident_bytes(env)
    st["index"] = ix


def window(env, st: dict) -> Window:
    t = env.traffic
    ix, pool, retain = st["index"], st["pool"], st["retain"]
    P, B = pool.shape
    K = retain.shape[0]
    rows = st["retain_rows"]
    rng = random.Random(seed_for(env.seed, "retain"))
    c0 = ix.counters()
    ev0, ev1 = env.dev.event(), env.dev.event()
    lat, traced_rows = [], []
    view, n_req = None, 0
    tracer = env.tracer() if env.trace else None
    if tracer:
        tracer.start()
    t0 = env.clock()
    deadline = t0 + env.seconds
    trace_end = t0 + min(env.seconds, t["trace_seconds"])
    while True:
        row = n_req % P
        with env.span("bench.lookup_call"):
            ev0.record()
            out = ix.lookup(pool[row])
        ev1.record()
        ev1.synchronize()
        with env.span("bench.harness"):
            lat.append(ev0.elapsed_time(ev1))
            slot = n_req if n_req < K else rng.randrange(n_req + 1)
            if slot < K:
                retain[slot].copy_(out.view(torch.int32))
                if slot == len(rows):
                    rows.append(row)
                else:
                    rows[slot] = row
            if tracer:
                traced_rows.append(row)
            n_req += 1
            now = env.clock()
        if tracer and now >= trace_end:
            view, tracer = tracer.stop(), None
        if now >= deadline:
            break
    window_s = now - t0
    c1 = ix.counters()
    counters = {k: c1[k] - c0[k] for k in c1}
    return Window(
        attempted=n_req, failed=0,
        end_to_end={"lookup_rate": n_req * B / window_s / 1e6,
                    "lookup_p95_ms": float(np.percentile(lat, 95))},
        counters=counters, trace=view,
        traced_probes=[(pool[r], None) for r in traced_rows])


def check(env, st: dict) -> tuple:
    """Every retained answer of the window against the reference's."""
    ix = st.pop("index")
    program = closed(ix)
    del ix
    collect(program)
    ref = env.reference.KVMap(st["keys"], st["vals"])
    wrong, compared = 0, 0
    for j, row in enumerate(st["retain_rows"]):
        want = ref.lookup(st["pool"][row])
        wrong += int((st["retain"][j] != want).sum())
        compared += want.numel()
    return {"wrong": wrong}, compared
