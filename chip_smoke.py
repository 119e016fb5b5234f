#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--log2-keys 24]

Phases, each of which raises on failure (exit code 1):

  (a) device: the card's name, and its name and power limit as
      ``nvidia-smi --query-gpu=name,power.limit`` reports them;
  (b) build: every CUDA source of the port with ``nvcc`` (all at once);
  (c) each kernel against its plain PyTorch version, bit for bit, on the
      card: the lookup (traditional and shortcut, N=1 and N=4 shards, key
      counts off the tile, absent keys), the routed lookup (four flag
      patterns, V != C), the stacked lookup (every shard of a 4-shard
      stack), the ragged copy (duplicate slots; uint32, float32 and
      bfloat16 rows) and the insert (a 20k-key trace with 8-slot buckets:
      cascading splits and doublings);
  (d) the flat path at full width: ``ShortcutEH(max_global_depth=16,
      bucket_slots=512, capacity=65536)`` takes 2**log2_keys unique keys
      in 16 batches, then lookups of every key and of 2**20 absent keys,
      out of sync (traditional route) and after ``pump()`` (shortcut
      route), then an async-mapper phase (25 ms poll) with lookups racing
      the replays; launch counts are read around this phase;
  (e) times of the flat path: insert, maintenance, ns/lookup per route (CUDA
      events), peak device memory, and per kernel its time, its plain
      version's time and its bound at the path's shapes;
  (f) the sharded path at the same widths: ``ShardedShortcutEH(16, 512,
      65536, num_shards=4)`` takes the same keys; ``lookup_batched`` takes
      its all-traditional arm before ``pump()``, its all-shortcut arm
      after, and its mixed arm (one routed launch) after a batch to shards
      0 and 1 only; per-shard ``lookup`` takes the stacked kernel; then an
      async phase of 2**22 keys races lookups against the copy-on-write
      publishes; launch counts are read around this phase, and then the
      same times as (e) for it and its two kernels, and the cost of one
      publish.

The flat index is dropped before (f), so each path reports its own peak
memory.  The last three lines of standard output are the ``{"kernels": [...]}``
JSON, the ``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.
Without CUDA, or without ``src/repro_torch`` beside it, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (NVIDIA data sheet)
MISS = 0xFFFFFFFF
N_EXTRA = 1 << 14                # keys beyond the absent ones, for (f)


def log(*a) -> None:
    print(*a, flush=True)


def fmix32(x):
    """MurmurHash3's finalizer: a bijection on uint32 (numpy arrays)."""
    import numpy as np
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


def make_keys(n_present: int, n_absent: int, seed: int):
    """Distinct uint32 keys (never the EMPTY pattern) from ``seed``: a
    bijection of a counter, so distinct by construction; and values below
    the MISS pattern."""
    import numpy as np
    n = n_present + n_absent + 1
    base = np.uint32((seed * 0x9E3779B9 + 0x7F4A7C15) & 0xFFFFFFFF)
    keys = fmix32(np.arange(n, dtype=np.uint32) + base)
    keys = keys[keys != np.uint32(MISS)][:n_present + n_absent]
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, MISS, n_present, dtype=np.uint32)
    return keys[:n_present], vals, keys[n_present:]


class Timer:
    """CUDA-event time of ``fn`` in ms, mean over ``reps`` after ``warmup``
    calls, and ``fn``'s last result.  Only the newest result is kept alive,
    so after two warm-up calls every output ``fn`` allocates comes from the
    caching allocator, and no ``cudaMalloc`` lands inside the timed calls."""

    def __init__(self, torch):
        self.torch = torch

    def __call__(self, fn, reps: int = 3, warmup: int = 2):
        torch = self.torch
        last = None
        for _ in range(warmup):
            last = fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            last = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps, last


def phase_device(torch) -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"(a) device: {name} | count {torch.cuda.device_count()} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"(a) nvidia-smi: {smi}")
    return smi


def phase_build(_build) -> None:
    t0 = time.perf_counter()
    report = _build.build()
    for name, (secs, out) in sorted(report.items()):
        log(f"(b) built {name}.cu in {secs:.1f} s")
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"(b)   {line.strip()}")
    log(f"(b) build wall time {time.perf_counter() - t0:.1f} s "
        f"({len(report)} sources compiled)")


def equal_bits(a, b) -> bool:
    from repro_torch.core import hashing
    return a.shape == b.shape and bool(
        (hashing.storage_view(a) == hashing.storage_view(b)).all())


def phase_kernels(torch, np, seed: int) -> None:
    """(c): every kernel against its plain version on the same inputs."""
    from repro_torch.core import extendible_hashing as eh
    from repro_torch.core import hashing
    from repro_torch.kernels import eh_lookup as lk
    from repro_torch.kernels import ragged_copy as rc
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)

    # -- insert: 20k keys, 8-slot buckets, batch by batch -------------------
    keys, vals, _ = make_keys(20_000, 0, seed + 1)
    cu = eh.eh_create(16, 8, 8192, device=dev)
    host = eh.eh_create(16, 8, 8192, device="cpu")
    for i in range(0, keys.size, 2_500):
        cu = eh.eh_insert_many(cu, keys[i:i + 2_500], vals[i:i + 2_500])
        host = eh.eh_insert_many(host, keys[i:i + 2_500], vals[i:i + 2_500])
        for f in eh.EHState._fields:
            if not equal_bits(getattr(cu, f).cpu(), getattr(host, f)):
                raise AssertionError(f"(c) insert: {f} differs after "
                                     f"{i + 2_500} keys")
    log(f"(c) insert kernel == plain, 8 arrays x 8 batches: 20000 keys, "
        f"global_depth {int(cu.global_depth)}, buckets "
        f"{int(cu.num_buckets)}, dropped {int(cu.dropped)}")

    # -- lookups: N=1 and N=4 shards, traditional and shortcut --------------
    states, probes = [], []
    for s in range(4):
        k, v, absent = make_keys(3_000 + 700 * s, 333, seed + 10 + s)
        st = eh.eh_insert_many(eh.eh_create(12, 16, 2048, device=dev), k, v)
        assert int(st.dropped) == 0
        states.append(st)
        probes.append(np.concatenate([k, absent]))
    for st, p in zip(states[:1], probes[:1]):
        pk = torch.from_numpy(p.view(np.int32)).to(dev)
        got = lk.eh_lookup(pk, st.directory, st.bucket_keys, st.bucket_vals,
                           st.global_depth)
        want = ref.eh_lookup_ref(pk, st.directory, st.bucket_keys,
                                 st.bucket_vals, st.global_depth)
        assert equal_bits(got, want), "(c) eh_lookup N=1 differs"
        g = int(st.global_depth)
        vk, vv = eh.compose_shortcut(st, 1 << g)
        got = lk.shortcut_lookup(pk, vk, vv, g)
        want = ref.shortcut_lookup_ref(pk, vk, vv, g)
        assert equal_bits(got, want), "(c) shortcut_lookup N=1 differs"
    K = max(p.size for p in probes)
    padded = np.zeros((4, K), np.uint32)
    for s, p in enumerate(probes):
        padded[s, :p.size] = p
    pk = torch.from_numpy(padded.view(np.int32)).to(dev)
    depths = torch.stack([st.global_depth for st in states])
    got = lk.sharded_eh_lookup(
        pk, torch.stack([st.directory for st in states]),
        torch.stack([hashing.bits(st.bucket_keys) for st in states]),
        torch.stack([hashing.bits(st.bucket_vals) for st in states]),
        depths, tile=64)
    V = 1 << int(depths.max())
    views = [eh.compose_shortcut(st, V) for st in states]
    got_sc = lk.sharded_shortcut_lookup(
        pk, torch.stack([hashing.bits(v[0]) for v in views]),
        torch.stack([hashing.bits(v[1]) for v in views]), depths, tile=64)
    for s, st in enumerate(states):
        want = ref.eh_lookup_ref(pk[s], st.directory, st.bucket_keys,
                                 st.bucket_vals, st.global_depth)
        assert equal_bits(got[s], want), f"(c) sharded eh_lookup shard {s}"
        want = ref.shortcut_lookup_ref(pk[s], *views[s], st.global_depth)
        assert equal_bits(got_sc[s], want), f"(c) sharded shortcut shard {s}"
        n_hit = int((got[s][:probes[s].size].view(torch.int32) != -1).sum())
        assert n_hit == probes[s].size - 333, f"(c) shard {s} hits {n_hit}"
    log(f"(c) lookup kernel == plain: N=1 ({probes[0].size} keys, tile 256) "
        f"and N=4 ({K} keys/shard, tile 64), traditional and shortcut, "
        f"333 absent keys per shard all MISS")

    # -- routed and stacked lookups over the same 4 shards ------------------
    dirs = torch.stack([st.directory for st in states])
    bks = torch.stack([hashing.bits(st.bucket_keys) for st in states])
    bvs = torch.stack([hashing.bits(st.bucket_vals) for st in states])
    vks = torch.stack([hashing.bits(v[0]) for v in views])
    vvs = torch.stack([hashing.bits(v[1]) for v in views])
    C = states[0].capacity
    assert V != C, "(c) the routed check needs V != C"
    for flags in ([1, 1, 1, 1], [0, 0, 0, 0], [1, 0, 0, 1], [0, 1, 1, 0]):
        f = torch.tensor(flags, dtype=torch.int32, device=dev)
        routed = lk.sharded_routed_lookup(pk, dirs, bks, bvs, depths, vks,
                                          vvs, depths, f)
        want = ref.routed_lookup_ref(pk, dirs, bks, bvs, depths, vks, vvs,
                                     depths, f)
        assert equal_bits(routed, want), f"(c) routed lookup {flags} differs"
        assert equal_bits(routed, got), f"(c) routed {flags} != traditional"
    for s, p in enumerate(probes):
        pkey = torch.from_numpy(p.view(np.int32)).to(dev)
        stacked = lk.stacked_shortcut_lookup(pkey, vks, vvs, depths, s)
        want = ref.stacked_shortcut_lookup_ref(pkey, vks, vvs, depths, s)
        assert equal_bits(stacked, want), f"(c) stacked lookup shard {s}"
        n_miss = int((stacked.view(torch.int32) == -1).sum())
        assert n_miss == 333, f"(c) stacked shard {s}: {n_miss} misses"
    log(f"(c) routed lookup kernel == plain: flags 1111, 0000, 1001, 0110, "
        f"N=4, {K} keys/shard (tile 256), V={V} != C={C}; stacked lookup "
        f"kernel == plain for shards 0-3, 333 absent keys each all MISS")

    # -- ragged copy: duplicate slots, three dtypes -------------------------
    cases = [((1000, 512), (4000, 512), torch.uint32, 3000),
             ((100, 4, 6), (300, 4, 6), torch.float32, 250),
             ((257, 3), (600, 3), torch.bfloat16, 700)]
    for vshape, pshape, dtype, M in cases:
        def rand(shape):
            if dtype == torch.uint32:
                return torch.from_numpy(rng.integers(
                    0, 1 << 32, shape, dtype=np.uint32).view(np.int32)).to(
                        dev).view(torch.uint32)
            return torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(dev).to(dtype)
        view, pool = rand(vshape), rand(pshape)
        slots = torch.from_numpy(rng.integers(0, vshape[0], M).astype(
            np.int32)).to(dev)
        offs = torch.from_numpy(rng.integers(0, pshape[0], M).astype(
            np.int32)).to(dev)
        assert int(torch.unique(slots).numel()) < M, "no duplicate slots"
        got = rc.ragged_copy(hashing.clone(view), pool, slots, offs)
        want = ref.ragged_copy_ref(hashing.clone(view), pool, slots, offs)
        assert equal_bits(got, want), f"(c) ragged_copy {dtype} differs"
        log(f"(c) ragged_copy kernel == plain: {dtype} view "
            f"{tuple(vshape)}, {M} slots with duplicates")
    torch.cuda.synchronize()


def lookup_bytes(keys, directory, table_keys, table_vals, depth) -> int:
    """Bytes a lookup of ``keys`` must move: each key read and each value
    written, the directory entry (traditional route), the probed key slots
    up to the stopping one, and the stored value on a hit."""
    from repro_torch.core import hashing
    from repro_torch.kernels import ref
    vals, probed = ref.lookup_ref(keys, directory, table_keys, table_vals,
                                  depth, count_probed=True)
    hits = int((hashing.bits(vals) != hashing.MISS_BITS).sum())
    dir_reads = 0 if directory is None else 4 * keys.numel()
    return 8 * keys.numel() + dir_reads + 4 * int(probed.sum()) + 4 * hits


def insert_bytes(before, after, keys, vals) -> int:
    """Bytes the batch insert of ``keys`` (all new to ``before``) must move
    to turn ``before`` into ``after``.  Per key: its key and value read, its
    directory entry read, the key slots its probe reads, and the 8-byte slot
    write.  A key's probe length is read from ``after``: with no deletes,
    the slots before a key's own were full when it was placed there.  Per
    changed bucket: its count read and written.  Per split: the old row
    read, both rows written whole, and the two local depths.  Per changed
    directory entry: its write, plus the old half read on a doubling."""
    from repro_torch.kernels import ref
    found, probed = ref.lookup_ref(keys, after.directory, after.bucket_keys,
                                   after.bucket_vals, after.global_depth,
                                   count_probed=True)
    assert equal_bits(found, vals), "(e) inserted keys not found"
    S = after.bucket_slots
    splits = int(after.num_buckets) - int(before.num_buckets)
    g0, g1 = int(before.global_depth), int(after.global_depth)
    changed_counts = int((after.counts != before.counts).sum())
    changed_dir = int((after.directory != before.directory).sum())
    return (20 * keys.numel() + 4 * int(probed.sum()) + 8 * changed_counts
            + splits * (3 * S * 8 + 12) + 4 * changed_dir
            + (4 << g0 if g1 > g0 else 0))


def phase_main(torch, np, args, timer):
    """(d): the main path at full width; returns what (e) reports."""
    from repro_torch.core import extendible_hashing as eh
    from repro_torch.core.shortcut_eh import ShortcutEH
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    n = 1 << args.log2_keys
    n_absent = 1 << 20
    keys_np, vals_np, rest_np = make_keys(n, n_absent + N_EXTRA, args.seed)
    absent_np = rest_np[:n_absent]
    keys = torch.from_numpy(keys_np.view(np.int32)).to(dev)
    vals = torch.from_numpy(vals_np.view(np.int32)).to(dev)
    probe = torch.cat([keys, torch.from_numpy(absent_np.view(np.int32)).to(dev)])
    want = torch.cat([vals, torch.full((n_absent,), -1, dtype=torch.int32,
                                       device=dev)])
    batch = n // 16
    res = {"n_keys": n, "n_absent": n_absent}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()

    sc = ShortcutEH(max_global_depth=16, bucket_slots=512, capacity=65536,
                    device=dev)
    t_insert = 0.0
    for i in range(0, n, batch):
        if i == n - batch:
            res["last_batch_state"] = sc.state      # kernel timing input
        t0 = time.perf_counter()
        sc.insert(keys[i:i + batch], vals[i:i + batch])
        torch.cuda.synchronize()
        t_insert += time.perf_counter() - t0
    st = sc.state
    res["insert_s"] = t_insert
    log(f"(d) inserted {n} keys in 16 batches: {t_insert:.3f} s; "
        f"global_depth {int(st.global_depth)}, buckets "
        f"{int(st.num_buckets)}, fan-in {sc.avg_fan_in():.3f}, dropped "
        f"{int(st.dropped)}")
    assert int(st.dropped) == 0, "(d) inserts dropped"
    assert not sc.in_sync()

    def lookup_all(route: str, reps: int = 3) -> float:
        """ms per warm ``sc.lookup(probe)`` call on ``route`` (the mean of
        ``reps``); the first call and the last must answer right."""
        before = (sc.routed_traditional, sc.routed_shortcut)
        first = sc.lookup(probe)
        assert torch.equal(first.view(torch.int32), want), \
            f"(d) {route} lookups wrong"
        del first
        ms, last = timer(lambda: sc.lookup(probe), reps=reps)
        assert torch.equal(last.view(torch.int32), want), \
            f"(d) {route} lookups wrong"
        moved = (sc.routed_traditional - before[0],
                 sc.routed_shortcut - before[1])
        calls = 1 + 2 + reps
        assert moved == ((calls, 0) if route == "traditional"
                         else (0, calls)), \
            f"(d) expected the {route} route, counters moved {moved}"
        return ms

    res["trad_ms"] = lookup_all("traditional")
    t0 = time.perf_counter()
    sc.pump()
    torch.cuda.synchronize()
    res["maint_s"] = time.perf_counter() - t0
    assert sc.in_sync() and sc.use_shortcut()
    res["sc_ms"] = lookup_all("shortcut")
    log(f"(d) every key found, every absent key MISS, on both routes; "
        f"maintenance {res['maint_s']:.3f} s ({sc.stats})")
    inv = eh.check_invariants(st)
    assert inv["ok"], inv["errors"][:5]
    log("(d) invariants I1-I5 hold")
    res["sc"] = sc

    # -- async mapper: lookups race the replays -----------------------------
    n_async = min(n, 1 << 22)
    a_batch = n_async // 16
    t0 = time.perf_counter()
    with ShortcutEH(max_global_depth=16, bucket_slots=512, capacity=65536,
                    async_mapper=True, poll_interval=0.025,
                    device=dev) as asc:
        for i in range(0, n_async, a_batch):
            asc.insert(keys[i:i + a_batch], vals[i:i + a_batch])
            got = asc.lookup(keys[:i + a_batch]).view(torch.int32)
            assert torch.equal(got, vals[:i + a_batch]), \
                f"(d) async lookups wrong after {i + a_batch} keys"
        assert asc.wait_in_sync(timeout=120.0), "(d) async mapper stuck"
        got = asc.lookup(probe[:n_async]).view(torch.int32)
        assert torch.equal(got, vals[:n_async])
        assert asc.routed_shortcut >= 1 and asc.routed_traditional >= 1
        log(f"(d) async mapper: {n_async} keys in 16 batches, lookups after "
            f"each; routes shortcut {asc.routed_shortcut} / traditional "
            f"{asc.routed_traditional}; {asc.stats}; "
            f"{time.perf_counter() - t0:.3f} s")
    torch.cuda.synchronize()
    res["launches"] = _build.launches()
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"(d) kernel launches on the main path: {res['launches']}")
    for k in ("eh_insert", "eh_lookup", "shortcut_lookup", "ragged_copy"):
        assert res["launches"].get(k, 0) >= 1, f"(d) {k} never launched"
    res.update(probe=probe, keys=keys, vals=vals, batch=batch, want=want,
               extra=torch.from_numpy(rest_np[n_absent:].view(np.int32)).to(
                   dev))
    return res


def err(a, b) -> int:
    """Largest |a - b| of two uint32 tensors, as unsigned values."""
    from repro_torch.core import hashing
    return int((hashing.u32(a) - hashing.u32(b)).abs().max())


def _row(name, source, replaces, launches, ms, plain_ms, bytes_,
         max_err) -> dict:
    """One entry of the ``{"kernels": [...]}`` line; the bound is the bytes
    the function must move over the card's memory rate."""
    bound = bytes_ / HBM_BYTES_PER_S * 1e3
    log(f"(e) {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({bytes_} B), max |err| {max_err}, launches "
        f"{launches.get(name, 0)}")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches.get(name, 0),
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None}


def measure_kernels(torch, np, res, timer) -> list:
    """Per kernel at the main path's shapes: its time, its plain version's
    time on the same inputs, the largest difference, and its bound."""
    from repro_torch.core import extendible_hashing as eh
    from repro_torch.core import hashing
    from repro_torch.kernels import eh_insert as ins
    from repro_torch.kernels import eh_lookup as lk
    from repro_torch.kernels import ragged_copy as rc
    from repro_torch.kernels import ref
    sc, probe = res["sc"], res["probe"]
    st = sc.state
    vk, vv, vlog2 = sc.view_snapshot()
    rows = []

    def entry(name, source, replaces, ms, plain_ms, bytes_, max_err):
        rows.append(_row(name, source, replaces, res["launches"], ms,
                         plain_ms, bytes_, max_err))

    D = 1 << st.max_global_depth
    args = (probe, st.directory[:D], st.bucket_keys, st.bucket_vals,
            st.global_depth)
    ms, got = timer(lambda: lk.eh_lookup(*args))
    plain_ms, want = timer(lambda: ref.eh_lookup_ref(*args), reps=1,
                           warmup=0)
    entry("eh_lookup", "src/repro_torch/kernels/csrc/eh_lookup.cu",
          "src/repro/kernels/eh_lookup.py:171", ms, plain_ms,
          lookup_bytes(*args), err(got, want))

    ms, got = timer(lambda: lk.shortcut_lookup(probe, vk, vv, vlog2))
    plain_ms, want = timer(lambda: ref.shortcut_lookup_ref(
        probe, vk, vv, vlog2), reps=1, warmup=0)
    entry("shortcut_lookup", "src/repro_torch/kernels/csrc/eh_lookup.cu",
          "src/repro/kernels/eh_lookup.py:171", ms, plain_ms,
          lookup_bytes(probe, None, vk, vv, vlog2), err(got, want))

    # an update replay of every slot, padded with duplicates of slot 0 as
    # the replay pads its chunk
    g = int(st.global_depth)
    slots = torch.arange(1 << g, dtype=torch.int32, device=probe.device)
    slots = torch.cat([slots, torch.zeros(100, dtype=torch.int32,
                                          device=probe.device)])
    offs = st.directory[slots.long()].contiguous()
    row_bytes = vk.shape[1] * 4
    base = hashing.clone(vk)
    ms, _ = timer(lambda: rc.ragged_copy(base, st.bucket_keys, slots, offs))
    got = rc.ragged_copy(hashing.clone(vk), st.bucket_keys, slots, offs)
    plain_base = hashing.clone(vk)
    plain_ms, want = timer(lambda: ref.ragged_copy_ref(
        plain_base, st.bucket_keys, slots, offs), reps=1, warmup=0)
    winners = int(torch.unique(slots).numel())
    entry("ragged_copy", "src/repro_torch/kernels/csrc/ragged_copy.cu",
          "src/repro/kernels/ragged_copy.py:53", ms, plain_ms,
          8 * slots.numel() + 2 * winners * row_bytes, err(got, want))

    # the main path's last insert batch, on the state it was given
    st0 = res["last_batch_state"]
    kb = res["keys"][-res["batch"]:]
    vb = res["vals"][-res["batch"]:]
    work = eh.clone_state(st0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ins.eh_insert_(work, kb, vb)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    host = eh.EHState(*(a.cpu() for a in st0))
    t0 = time.perf_counter()
    host = eh.eh_insert_many(host, kb.cpu(), vb.cpu())
    plain_ms = (time.perf_counter() - t0) * 1e3
    max_err = max(err(getattr(work, f).cpu(), getattr(host, f))
                  for f in eh.EHState._fields)
    log(f"(e) eh_insert last batch: "
        f"{int(work.num_buckets) - int(st0.num_buckets)} splits, global "
        f"depth {int(st0.global_depth)} -> {int(work.global_depth)}")
    entry("eh_insert", "src/repro_torch/kernels/csrc/eh_insert.cu",
          "src/repro/core/extendible_hashing.py:221", ms, plain_ms,
          insert_bytes(st0, work, kb, vb), max_err)
    return rows


def phase_sharded(torch, np, timer, data) -> dict:
    """(f): the sharded path at the flat path's widths, 4 shards; returns
    what its part of (e) reports."""
    from repro_torch.core.sharded_eh import ShardedShortcutEH, shard_of_keys
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    keys, vals, probe, want = (data[k] for k in ("keys", "vals", "probe",
                                                 "want"))
    n, n_absent = keys.numel(), probe.numel() - keys.numel()
    batch = n // 16
    res = {"n_keys": n, "n_absent": n_absent}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()

    idx = ShardedShortcutEH(max_global_depth=16, bucket_slots=512,
                            capacity=65536, num_shards=4, device=dev)
    t_insert = 0.0
    for i in range(0, n, batch):
        t0 = time.perf_counter()
        idx.insert(keys[i:i + batch], vals[i:i + batch])
        torch.cuda.synchronize()
        t_insert += time.perf_counter() - t0
    res["insert_s"] = t_insert
    fan = [sh.avg_fan_in() for sh in idx.shards]
    res["fan_in"] = fan
    log(f"(f) inserted {n} keys into 4 shards in 16 batches: {t_insert:.3f} "
        f"s; per shard: global_depth "
        f"{[int(sh.state.global_depth) for sh in idx.shards]}, buckets "
        f"{[int(sh.state.num_buckets) for sh in idx.shards]}, fan-in "
        f"{[round(f, 4) for f in fan]}, dropped "
        f"{[int(sh.state.dropped) for sh in idx.shards]}")
    assert all(int(sh.state.dropped) == 0 for sh in idx.shards), \
        "(f) inserts dropped"
    assert not any(sh.in_sync() for sh in idx.shards)

    def run(label, fn, probe_keys, expect, kernel, per_call, routes):
        """ms per warm ``fn(probe_keys)`` (the mean of 3 after 2 warm-up
        calls, after one checked call); every answer checked, and the
        kernel launches and route counters moved as this arm must."""
        l0 = _build.launches().get(kernel, 0)
        r0 = (idx.routed_traditional, idx.routed_shortcut)
        first = fn(probe_keys)
        assert torch.equal(first.view(torch.int32), expect), \
            f"(f) {label}: wrong answers"
        del first
        ms, last = timer(lambda: fn(probe_keys))
        assert torch.equal(last.view(torch.int32), expect), \
            f"(f) {label}: wrong answers"
        calls = 1 + 2 + 3
        moved = _build.launches().get(kernel, 0) - l0
        assert moved == per_call * calls, \
            f"(f) {label}: {kernel} launched {moved} times in {calls} calls"
        got = (idx.routed_traditional - r0[0], idx.routed_shortcut - r0[1])
        assert got == (routes[0] * calls, routes[1] * calls), \
            f"(f) {label}: route counters moved {got}"
        log(f"(f) {label}: every answer right; {kernel} x{moved}; "
            f"{ms:.4f} ms per call")
        return ms

    # 1. out of sync: the all-traditional arm builds the eh_trad stack
    res["trad_ms"] = run("lookup_batched, all-traditional arm",
                         idx.lookup_batched, probe, want, "eh_lookup", 1,
                         (4, 0))
    assert "eh_trad" in idx.operands
    # 2. pump: the all-shortcut arm, with no refresh on the lookup path
    t0 = time.perf_counter()
    idx.pump()
    torch.cuda.synchronize()
    res["maint_s"] = time.perf_counter() - t0
    assert idx.in_sync() and all(f <= 8.0 for f in fan)
    refreshes = idx.operands.stats.lookup_refreshes
    res["sc_ms"] = run("lookup_batched, all-shortcut arm",
                       idx.lookup_batched, probe, want, "shortcut_lookup", 1,
                       (0, 4))
    assert idx.operands.stats.lookup_refreshes == refreshes == 0, \
        "(f) the all-shortcut arm refreshed the stack on the lookup path"
    log(f"(f) maintenance (one pump) {res['maint_s']:.3f} s ({idx.stats}); "
        f"lookup_refreshes {idx.operands.stats.lookup_refreshes}")
    # 3. a batch to shards 0 and 1 only, not pumped: the mixed arm
    extra = data["extra"]
    extra = extra[shard_of_keys(extra, 2) < 2][:4096]
    extra_vals = torch.arange(extra.numel(), dtype=torch.int32, device=dev)
    idx.insert(extra, extra_vals)
    assert [sh.in_sync() for sh in idx.shards] == [False, False, True, True]
    mixed_probe = torch.cat([probe, extra])
    mixed_want = torch.cat([want, extra_vals])
    res["mixed_ms"] = run("lookup_batched, mixed arm", idx.lookup_batched,
                          mixed_probe, mixed_want, "sharded_routed_lookup", 1,
                          (2, 2))
    padded = idx._partition(mixed_probe)[0]      # the kernels' key layout
    res["routed_args"] = (padded, *idx.operands.handle("eh_trad"),
                          *idx.operands.handle("eh_view"),
                          torch.tensor([1, 1, 0, 0], dtype=torch.int32,
                                       device=dev))
    # 4. pump again; per-shard lookup: the stacked kernel on every shard
    idx.pump()
    assert idx.in_sync()
    res["stacked_ms"] = run("lookup (per shard)", idx.lookup, mixed_probe,
                            mixed_want, "stacked_shortcut_lookup", 4, (0, 4))
    res["stacked_args"] = (padded[0], *idx.operands.handle("eh_view"), 0)
    res["n_lookups"] = mixed_probe.numel()
    res["mixed_probe"] = mixed_probe
    inv = idx.check_invariants()
    assert inv["ok"], inv["errors"][:5]
    log("(f) invariants I1-I5 hold on every shard, and S1")
    res["cache_stats"] = idx.operands.stats.snapshot()
    res["resident"] = idx.operands.resident_bytes()
    log(f"(f) {res['cache_stats']}; resident_bytes {res['resident']}")
    res["idx"] = idx

    # -- async mappers: lookups race the copy-on-write publishes -----------
    n_async = min(n, 1 << 22)
    a_batch = n_async // 16
    t0 = time.perf_counter()
    with ShardedShortcutEH(max_global_depth=16, bucket_slots=512,
                           capacity=65536, num_shards=4, async_mapper=True,
                           poll_interval=0.025, device=dev) as aidx:
        for i in range(0, n_async, a_batch):
            aidx.insert(keys[i:i + a_batch], vals[i:i + a_batch])
            got = aidx.lookup_batched(keys[:i + a_batch]).view(torch.int32)
            assert torch.equal(got, vals[:i + a_batch]), \
                f"(f) async lookups wrong after {i + a_batch} keys"
        assert aidx.wait_in_sync(timeout=120.0), "(f) async mappers stuck"
        got = aidx.lookup_batched(probe[:n_async]).view(torch.int32)
        assert torch.equal(got, vals[:n_async])
        assert aidx.routed_shortcut >= 1 and aidx.routed_traditional >= 1
        log(f"(f) async mappers: {n_async} keys in 16 batches, "
            f"lookup_batched after each; routes shortcut "
            f"{aidx.routed_shortcut} / traditional "
            f"{aidx.routed_traditional}; {aidx.stats}; "
            f"{aidx.operands.stats}; {time.perf_counter() - t0:.3f} s")
    torch.cuda.synchronize()
    res["launches"] = _build.launches()
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"(f) kernel launches on the sharded path: {res['launches']}")
    for k in ("eh_insert", "eh_lookup", "shortcut_lookup", "ragged_copy",
              "sharded_routed_lookup", "stacked_shortcut_lookup"):
        assert res["launches"].get(k, 0) >= 1, f"(f) {k} never launched"
    return res


def measure_sharded(torch, np, res, timer, rows) -> None:
    """The sharded path's two kernels at its shapes (the mixed arm's routed
    launch, shard 0's stacked launch), as ``measure_kernels`` does for the
    flat path; and the time of one copy-on-write publish."""
    from repro_torch.kernels import eh_lookup as lk
    from repro_torch.kernels import ref
    args = res["routed_args"]
    ms, got = timer(lambda: lk.sharded_routed_lookup(*args))
    plain_ms, want = timer(lambda: ref.routed_lookup_ref(*args), reps=1,
                           warmup=0)
    keys, dirs, bks, bvs, gds, vks, vvs, vls, flags = args
    moved = sum(
        lookup_bytes(keys[s], dirs[s], bks[s], bvs[s], gds[s]) if f else
        lookup_bytes(keys[s], None, vks[s], vvs[s], vls[s])
        for s, f in enumerate(flags.tolist()))
    rows.append(_row("sharded_routed_lookup",
                     "src/repro_torch/kernels/csrc/eh_lookup.cu",
                     "src/repro/kernels/eh_lookup.py:334",
                     res["launches"], ms, plain_ms, moved, err(got, want)))
    args = res["stacked_args"]
    ms, got = timer(lambda: lk.stacked_shortcut_lookup(*args))
    plain_ms, want = timer(lambda: ref.stacked_shortcut_lookup_ref(*args),
                           reps=1, warmup=0)
    keys, vks, vvs, vls, s = args
    rows.append(_row("stacked_shortcut_lookup",
                     "src/repro_torch/kernels/csrc/eh_lookup.cu",
                     "src/repro/kernels/eh_lookup.py:279",
                     res["launches"], ms, plain_ms,
                     lookup_bytes(keys, None, vks[s], vvs[s], vls[s]),
                     err(got, want)))

    # where an arm's time goes: its kernel alone, and the partition (one
    # stable sort, one host read of the counts, the pad)
    keys, dirs, bks, bvs, gds, vks, vvs, vls, _ = res["routed_args"]
    trad_ms, _ = timer(lambda: lk.sharded_eh_lookup(keys, dirs, bks, bvs,
                                                    gds))
    sc_ms, _ = timer(lambda: lk.sharded_shortcut_lookup(keys, vks, vvs, vls))
    part_ms, _ = timer(lambda: res["idx"]._partition(res["mixed_probe"]))
    res["breakdown"] = (trad_ms, sc_ms, part_ms)
    log(f"(e) on the mixed probe's layout {tuple(keys.shape)}: "
        f"sharded_eh_lookup {trad_ms:.4f} ms, sharded_shortcut_lookup "
        f"{sc_ms:.4f} ms, partition {part_ms:.4f} ms")

    # one publish of shard 0's own view into the eh_view stack: the clone
    # of each stacked part plus the slice write (same data, same epoch)
    cache = res["idx"].operands
    sl = cache.slice_of("eh_view", 0)
    epoch = cache.epochs("eh_view")[0]
    stack_bytes = res["resident"]["eh_view"]
    ms, _ = timer(lambda: cache.publish("eh_view", 0, sl, epoch=epoch))
    res["publish_ms"] = ms
    log(f"(e) copy-on-write publish of one shard's view at N=4: {ms:.4f} ms "
        f"(clones the {stack_bytes} B eh_view stack, bound "
        f"{2 * stack_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms to read and "
        f"write it once)")
    bad = [r["name"] for r in rows if r["max_abs_err"] != 0]
    assert not bad, f"(e) kernels differ from their plain versions: {bad}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log2-keys", type=int, default=24,
                    help="keys the main path inserts (2**N, N >= 20)")
    args = ap.parse_args()
    if args.log2_keys < 20:
        ap.error("--log2-keys must be at least 20")
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {ROOT}; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build

    t_all = time.perf_counter()
    timer = Timer(torch)
    smi = phase_device(torch)
    phase_build(_build)
    phase_kernels(torch, np, args.seed)
    res = phase_main(torch, np, args, timer)
    n = res["n_keys"] + res["n_absent"]
    log(f"(e) insert {res['insert_s']:.6f} s for {res['n_keys']} keys; "
        f"maintenance {res['maint_s']:.6f} s; lookup traditional "
        f"{res['trad_ms'] * 1e6 / n:.4f} ns/lookup, shortcut "
        f"{res['sc_ms'] * 1e6 / n:.4f} ns/lookup ({n} lookups, "
        f"{res['n_absent']} absent); max_memory_allocated "
        f"{res['peak_bytes']} B; card {smi}")
    kernels = measure_kernels(torch, np, res, timer)
    res["sc"].close()
    data = {k: res[k] for k in ("keys", "vals", "probe", "want", "extra")}
    del res                      # drop the flat index: (f) has its own peak
    gc.collect()
    torch.cuda.empty_cache()

    sres = phase_sharded(torch, np, timer, data)
    n = sres["n_keys"] + sres["n_absent"]
    log(f"(f) insert {sres['insert_s']:.6f} s for {sres['n_keys']} keys "
        f"(4 shards); maintenance {sres['maint_s']:.6f} s; card {smi}")
    log(f"(f) lookup_batched ns/lookup: all-traditional "
        f"{sres['trad_ms'] * 1e6 / n:.4f}, all-shortcut "
        f"{sres['sc_ms'] * 1e6 / n:.4f} ({n} lookups); mixed "
        f"{sres['mixed_ms'] * 1e6 / sres['n_lookups']:.4f} "
        f"({sres['n_lookups']} lookups)")
    log(f"(f) per-shard lookup (stacked kernel) ns/lookup "
        f"{sres['stacked_ms'] * 1e6 / sres['n_lookups']:.4f} "
        f"({sres['n_lookups']} lookups)")
    log(f"(f) per-shard fan-in {sres['fan_in']} (default threshold 8.0)")
    log(f"(f) {sres['cache_stats']}")
    log(f"(f) resident_bytes {sres['resident']}")
    log(f"(f) max_memory_allocated {sres['peak_bytes']} B")
    measure_sharded(torch, np, sres, timer, kernels)
    sres["idx"].close()
    log(f"(e) total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
