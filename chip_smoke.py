#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--log2-keys 24]

Phases, each of which raises on failure (exit code 1):

  (a) device: the card's name, and its name and power limit as
      ``nvidia-smi --query-gpu=name,power.limit`` reports them;
  (b) build: every CUDA source of the port with ``nvcc`` (all at once),
      and each kernel's registers, spills and shared memory from ptxas;
  (c) each kernel against its plain PyTorch version on the card: bit for
      bit, the lookup (traditional and shortcut, N=1 and N=4 shards, key
      counts off the tile, absent keys), the routed lookup (four flag
      patterns, V != C), the stacked lookup (every shard of a 4-shard
      stack), the ragged copy (duplicate slots; uint32, float32 and
      bfloat16 rows) and the insert (a 20k-key trace with 8-slot buckets:
      cascading splits and doublings; and, all eight arrays after every
      batch against the plain host loop: 2**16 keys into an empty S=512
      index, capacity exhausted, maximum depth reached, duplicates and
      re-inserts inside one window, the keys 0, 0xFFFFFFFE and 0xFFFFFFFF,
      S=4, and the largest S the block's shared memory holds); the three
      baseline inserts (HT, HTI, CH) against their plain host loops, every
      state array after every batch: HT doubled from 2^4 to its maximum
      2^10 and then dropping, a doubling that loses entries (a fabricated
      state), a fabricated crowded HT table whose batch drops keys ahead of
      the key that doubles it, HTI at migrate_batch 16 with migrations over
      several batches, re-inserts of keys still in the old table and a
      drain, HTI at migrate_batch 4 re-inserting keys its batch migrates
      and the EMPTY pattern, CH with 16
      chains until its capacity runs out, duplicate keys (inside one batch
      too), the keys 0, 0xFFFFFFFE and 0xFFFFFFFF, one chain of 2^16 keys
      (its ms per batch grow with the walk to its tail, logged, not with
      its keys), its capacity running out inside a batch, 2^17 chains
      (three radix passes), and 2^16 keys into each table; the four lookup entry points (traditional, shortcut, stacked,
      routed) at S = 4, 8, 16 and 512 (the probe's scalar path at 4 and
      8), on indexes whose capacity ran out, absent keys and the EMPTY
      pattern among the probes; within 2e-5 (1 + |want|) in float32 and 2^-7 |want| + 2^-8 max |want| in
      bfloat16 (one bfloat16 step of the element, half a step of the
      largest), the shortcut and
      paged decode attention at qwen3_4b's and gemma2_27b's KV widths
      (softcap 50, window 4096 over an 8192 context, on both routes), at
      G = 3, hd 64 and at the split kernel's edges (contexts of SPLIT - 1,
      SPLIT, SPLIT + 1 and S_cap): contexts off the tile, 0 and S_cap, a -1
      table entry and an all -1 row, strided (as ``ops.decode_*`` pass
      them) and contiguous inputs, the self row (the current token's K/V)
      folded in, and the shortcut route bitwise equal to the paged route
      over the same rows in shuffled blocks; at each shape the plain
      versions of wrong kernels (the last token dropped, a 64-token chunk
      skipped, the window edge moved by one, the self row left out) are
      shown to go past that limit; the flash kernel in float32 and bfloat16
      at tests/test_kernels.py's shapes (causal sweep, windows 16, 33 and
      100, softcap 20, q shorter than the keys, ragged tails) and head_dim
      256, contiguous and in the model layout through ``ops.mha_forward``,
      then in bfloat16 at qwen3_4b's prefill layer shape (8 x 2048 tokens),
      at gemma2_27b's widths (window 4096, softcap 50, 8192 tokens), at
      hymba_1_5b's (G 5, hd 64, window 1024 over 1500 tokens) and at
      musicgen_medium's (G 1, hd 64, 1000 tokens), each beside the plain
      versions of wrong kernels (the diagonal token dropped, q_offset off
      by one, the window edge moved by one); each flash line names the
      kernel that ran: ``tensor-core`` (bfloat16 at hd 64, 128, 256) or
      ``simt`` (float32, and bfloat16 at hd 16 and 32);
  (d) the flat path at full width: ``ShortcutEH(max_global_depth=16,
      bucket_slots=512, capacity=65536)`` takes 2**log2_keys unique keys
      in 16 batches, then lookups of every key and of 2**20 absent keys,
      out of sync (traditional route) and after ``pump()`` (shortcut
      route), then an async-mapper phase (25 ms poll) with lookups racing
      the replays; launch counts are read around this phase; the seconds
      of each insert batch;
  (e) times of the flat path: insert, maintenance, ns/lookup per route (CUDA
      events), peak device memory, and per kernel its time, its plain
      version's time and its bound at the path's shapes; and the card's
      random reads as the lookups' yardstick: ``torch.take`` of as many
      random int32 of the key pool as the probe has keys, and of the key
      and value pools;
  (f) the sharded path at the same widths: ``ShardedShortcutEH(16, 512,
      65536, num_shards=4)`` takes the same keys; ``lookup_batched`` takes
      its all-traditional arm before ``pump()``, its all-shortcut arm
      after, and its mixed arm (one routed launch) after a batch to shards
      0 and 1 only; per-shard ``lookup`` takes the stacked kernel; then an
      async phase of 2**22 keys races lookups against the copy-on-write
      publishes; launch counts are read around this phase, and then the
      same times as (e) for it and its two kernels, the seconds of each
      insert batch, and the cost of one publish;
  (g) the KV serving layer at qwen3_4b's KV widths (36 layers, 32 query
      heads over 8 KV heads, head_dim 128, bfloat16): a paged cache of 5120
      16-token blocks and a ``ShortcutKVManager`` over 16 sequences of up to
      4096 tokens.  Prefill in 4 groups (seeded lengths in 2048-4000),
      permute the physical blocks (content unchanged, fragmentation near
      1), check the composed view against ``gather_context``, then 64
      decode steps: append, 36 layers through ``ops.decode_paged``
      (out of sync), ``pump()``, 36 layers through ``ops.decode_shortcut``
      on the installed view, the routes equal bit for bit and held to the
      plain version; part-way a release (both kernels decode it to zeros, the
      gate goes paged) and a re-prefill (the create replay brings it back);
      ``get_context`` on both routes against per-sequence gathers; an async
      phase (2 shards, 8 sequences of 1024 tokens) with decodes racing the
      publishes; a ``PrefixCacheIndex`` over the 16 prompts.  Reports ms
      per decode step per route, append and replay + publish ms per step,
      create replay ms per sequence, peak memory, the kernels' |err| over
      the bfloat16 limit beside the wrong kernels' at the path's shapes, and
      both kernels' rows (device time: a sleep queued ahead of the timed
      calls, so the host's time to issue them is left out; with the time of
      ``scaled_dot_product_attention`` on the same view as the shortcut
      kernel's yardstick), each kernel at SPLIT 256 and 512, and the split
      kernel's and the combine's device time from a profiler trace;
  (h) the model on the card: qwen3_4b at its full width in bfloat16
      (36 layers, d 2560, 32/8 heads x 128, d_ff 9728, vocab 151936; 4.02 B
      parameters drawn from --seed on the card), a small server answering 8
      requests: ``make_prefill_step`` on 8 prompts of 2048 seeded tokens
      (36 flash launches per prefill), 32 greedy decode steps on the
      shortcut route (``make_serve_step``) and on the paged route
      (``make_paged_serve_step``, 16-token blocks, S_cap 2112 on both).
      Each decode layer attends through the decode kernels (the view, or
      the pools through the block tables, the current token folded in).
      Checks: 72 launches of the route's decode kernel per step and no
      other kernel of the port, no context gathered, the routes' tokens
      identical and their last-step logits equal bit for bit, each route's
      last-step logits within ``LOGIT_LIMIT`` (relative RMS) of a full
      forward over prompt + fed tokens, a decode with the rope position off
      by one past it.  Reports prefill ms and tokens/s, decode ms per step
      (host clock and CUDA events: mean, median, min and max of steps 3-32)
      and tokens/s per route, each with the device's busy time from one
      ``torch.profiler`` trace (the decode-attention kernels apart), peak
      memory, the flash row: its time at the prefill layer shape against
      its bound (with the share of the bound), its plain version and
      ``scaled_dot_product_attention(is_causal, enable_gqa)``; and both
      decode kernels at the decode layer shape (8 x 8 kv heads x 2064
      tokens and the self row): device time, plain, bound, SDPA, both
      split lengths;
  (i) Fig. 7 on the card: HT, HTI and CH (``core/baselines.py``) take
      (d)'s 2**log2_keys keys in 16 batches at ``bench_fig7.py``'s settings
      (HT and HTI from 2^9 to 2^ceil(log2(n / 0.30)), CH with 2^(that - 4)
      chains of 16-slot buckets) but CH's capacity, 2^23 buckets (1 GiB),
      where the bench's n // 8 drops keys; CH must drop none.  Reports the
      insert seconds per batch (7a's resize staircases), the insert call's
      time on the last and the largest batch, ns/lookup of (d)'s probes
      (plain PyTorch lookups: every key not lost returns its value, every
      absent key MISS, and 2^16 sampled lookups equal those on a CPU copy),
      peak memory per table, each insert kernel's time on the last batch
      (one call on a copy of the state before it; two more calls are
      logged beside it) against its plain loop on the same state (HT's
      and HTI's one cooperative launch a batch, with its passes: segments,
      prefix counts, claim rounds and the most in one segment, events, the
      grid; CH's, with its radix passes, chain groups and the largest,
      buckets opened, the grid), and HT's batch 1, HTI's batch 3 and CH's
      batch 1 held to the plain loop too; and
      Fig. 7's five rows, EH and Shortcut-EH from (d) and (e).

Each phase's wall seconds go on a line of their own.  The flat index is
dropped before (f), the sharded one before (g), the KV layer before (h)
and each table of (i) before the next, so each path reports its own peak
memory.  The last three lines of standard output are the ``{"kernels":
[...]}`` JSON (twelve kernels), the
``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.  Without CUDA, or without
``src/repro_torch`` beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import gc
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (NVIDIA data sheet)
PEAK_BF16 = 989e12               # H100 SXM dense bfloat16 tensor cores (same)
MISS = 0xFFFFFFFF
N_EXTRA = 1 << 14                # keys beyond the absent ones, for (f)
# (g): the KV widths of qwen3_4b (src/repro/configs/qwen3_4b.py: 36 layers,
# 32 query heads over 8 KV heads, head_dim 128) in bfloat16, at a cache one
# card holds in a deployment: 16 sequences of up to 4096 tokens in 16-token
# blocks (vLLM's default), a pool of 1.25 x the blocks they can fill
KV_CONFIG = dict(layers=36, q_heads=32, kv_heads=8, head_dim=128, block=16,
                 seqs=16, seq_capacity=4096, prompt_lens=(2048, 4000),
                 prefill_group=4, decode_steps=64, async_seqs=8,
                 async_len=1024, async_steps=16, system_prompt=1024,
                 vocab=151936)
# (h): qwen3_4b (src/repro_torch/configs/qwen3_4b.py) at its full width in
# bfloat16, weights drawn from --seed on the card; a small server answering
# 8 requests of a realistic prompt length: 8 prompts of 2048 seeded tokens,
# 32 greedy tokens on each route, S_cap 2112 = 132 blocks of 16 tokens so
# that both routes attend over contexts of the same length
MODEL_CONFIG = dict(arch="qwen3_4b", batch=8, prompt=2048, steps=32,
                    block=16, s_cap=2112)
# (h): the largest relative RMS error ||got - want|| / ||want|| of a
# sequence's last-step decode logits against the full forward's (PERF.md
# derives it): bfloat16 rounds each stored activation by up to 2^-9, the two
# computations round at different points, about 10 per layer over 36
# layers, which gives about sqrt(360) x 2^-9 / sqrt(3) = 0.021; the limit is
# three times that.  A decode with the rope position off by one goes past it
LOGIT_LIMIT = 0.06


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


class DeviceTimer(Timer):
    """A ``Timer`` whose calls are all issued before the card starts them:
    a ``torch.cuda._sleep`` of ``sleep_cycles`` (about 10 ms) goes ahead of
    the start event, so the events measure the device's time for ``reps``
    back-to-back calls and not the host's time to issue them, which at
    small kernels is the larger (the decode kernels' wrapper)."""

    def __call__(self, fn, reps: int = 20, warmup: int = 2,
                 sleep_cycles: int = 20_000_000):
        torch = self.torch
        last = None
        for _ in range(warmup):
            last = fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(reps):
            last = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps, last


class PhaseClock:
    """Logs each phase's wall seconds on a line of its own."""

    def __init__(self):
        self.t = time.perf_counter()

    def lap(self, phase: str) -> None:
        now = time.perf_counter()
        log(f"({phase}) phase seconds {now - self.t:.1f}")
        self.t = now


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


def ptxas_summary(out: str) -> list:
    """One line per kernel of ``nvcc -Xptxas -v`` output: its name
    (demangled when ``c++filt`` is there), registers, spills and stack, and
    any ptxas note that a wgmma was serialized or a wait injected."""
    rows, notes, name = [], [], None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif "spill" in line and name:
            rows.append([name, line.strip()])
        elif "Used" in line and "registers" in line and rows:
            rows[-1].append(line.split("info    :")[-1].strip())
        elif "serialized" in line or "injected" in line:
            notes.append(line.strip())
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True).stdout
        for r, n in zip(rows, names.splitlines()):
            n = n.replace("(anonymous namespace)::", "").split("(")[0]
            r[0] = n.removeprefix("void ")
    return [" | ".join(r) for r in rows] + notes


def phase_build(_build) -> None:
    t0 = time.perf_counter()
    report = _build.build()
    for name, (secs, out) in sorted(report.items()):
        log(f"(b) built {name}.cu in {secs:.1f} s")
        for line in ptxas_summary(out):
            log(f"(b)   {line}")
    log(f"(b) build wall time {time.perf_counter() - t0:.1f} s "
        f"({len(report)} sources compiled)")
    from repro_torch.kernels.flash_attention import TC_HEAD_DIMS, tc_smem_bytes
    log("(b) flash_tc_kernel dynamic shared memory per CTA: " + ", ".join(
        f"hd {hd} {tc_smem_bytes(hd)} B" for hd in TC_HEAD_DIMS))


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
    insert_traces(torch, np, seed)
    baseline_traces(torch, np, seed)
    lookup_shapes(torch, np, seed)


def insert_traces(torch, np, seed: int) -> None:
    """(c): the insert kernel against the plain host loop on traces that
    reach its edges, all eight arrays bit for bit after every batch."""
    from repro_torch.core import extendible_hashing as eh
    from repro_torch.kernels import eh_insert as ins
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 100)

    def keys_of(n, s):
        return make_keys(n, 0, seed + s)[0]

    def run(label, create, batches, check=None):
        cu = eh.eh_create(*create, device=dev)
        host = eh.eh_create(*create, device="cpu")
        ms = []
        for kb, vb in batches:
            k = torch.from_numpy(kb.view(np.int32)).to(dev)
            v = torch.from_numpy(vb.view(np.int32)).to(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cu = eh.eh_insert_many(cu, k, v)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            host = eh.eh_insert_many(host, kb, vb)
            for f in eh.EHState._fields:
                if not equal_bits(getattr(cu, f).cpu(), getattr(host, f)):
                    raise AssertionError(f"(c) insert {label}: {f} differs "
                                         f"from the host loop")
        if check is not None:
            assert check(host), f"(c) insert {label}: the trace missed its case"
        log(f"(c) insert kernel == plain, {label}: {sum(k.size for k, _ in batches)}"
            f" keys in {len(batches)} batches, S {create[1]}, global_depth "
            f"{int(host.global_depth)}, buckets {int(host.num_buckets)}, "
            f"dropped {int(host.dropped)}; kernel ms per batch "
            f"{[round(x, 3) for x in ms]}")

    def vals_of(n):
        return rng.integers(0, MISS, n, dtype=np.uint32)

    def split(k, n):
        return [(k[i:i + n], vals_of(k[i:i + n].size))
                for i in range(0, k.size, n)]

    k = keys_of(1 << 16, 200)
    run("S=512, 2^16 keys into an empty index", (16, 512, 4096),
        [(k, vals_of(k.size))])
    run("capacity exhausted", (16, 8, 64), split(keys_of(2000, 201), 500),
        lambda st: int(st.dropped) > 0 and int(st.num_buckets) == 64)
    run("max depth reached", (4, 8, 4096), split(keys_of(600, 202), 200),
        lambda st: int(st.global_depth) == 4 and int(st.dropped) > 0
        and int(st.num_buckets) < 4096)
    base = keys_of(3000, 203)
    dup = np.repeat(base[:1000], 3)[rng.permutation(3000)]
    run("duplicates and re-inserts inside one window", (16, 16, 8192),
        [(base, vals_of(3000)), (dup, vals_of(3000)),
         (np.concatenate([base[::2], base[::2]]), vals_of(3000))])
    edge = np.array([0, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)
    k = keys_of(900, 204)
    mixed = np.concatenate([k[:300], edge, k[300:600], edge, k[600:], edge])
    run("keys 0, 0xFFFFFFFE, 0xFFFFFFFF", (12, 8, 1024),
        [(mixed, vals_of(mixed.size)), (edge[::-1].copy(), vals_of(3))])
    run("S=4", (16, 4, 8192), split(keys_of(5000, 205), 1000))
    top = max(S for S in range(512, 1 << 16)
              if ins.shared_bytes(S) <= ins.MAX_SHARED_BYTES)
    run(f"S={top}, the largest the block's shared memory holds",
        (8, top, 16), split(keys_of(30000, 206), 15000),
        lambda st: int(st.num_buckets) > 2)


def same_home_keys(np, rng, n: int, log2: int, home: int):
    """Distinct keys whose home slot in a table of ``2**log2`` is ``home``
    (the hash inverted: ``key = h * C1**-1 mod 2**32``)."""
    inv = pow(2654435761, -1, 2**32)
    low = rng.choice(1 << (32 - log2), n, replace=False).astype(np.uint64)
    h = (np.uint64(home) << np.uint64(32 - log2)) | low
    return ((h * np.uint64(inv)) & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def crowded_ht_state(np, rng, keys):
    """HT state arrays of 2^10 slots (capacity 2^12) holding ``keys`` placed
    by the plain loop, then slots 600..639 overwritten with 40 new
    keys (a fabricated crowd; the count takes the slots that were EMPTY),
    and 10 keys whose home is slot 600, whose window the crowd fills."""
    from repro_torch.core import baselines as bl
    st = bl.ht_insert_many(bl.ht_create(12, 10, device="cpu"), keys,
                           rng.integers(0, MISS, keys.size, dtype=np.uint32))
    tk = st.keys.numpy().view(np.uint32).copy()
    tv = st.vals.numpy().view(np.uint32).copy()
    count = int(st.count) + int((tk[600:640] == MISS).sum())
    tk[600:640] = make_keys(40, 0, int(rng.integers(1 << 30)))[0]
    tv[600:640] = np.arange(1, 41, dtype=np.uint32)
    crowd = same_home_keys(np, rng, 10, 10, 600)
    return (tk, tv, np.int32(10), np.int32(count), np.int32(0)), crowd


def baseline_traces(torch, np, seed: int) -> None:
    """(c): the three baseline insert kernels against their plain host
    loops on traces that reach their edges, every state array bit for bit
    after every batch."""
    from repro_torch import convert
    from repro_torch.core import baselines as bl
    from repro_torch.kernels import baselines_insert as kern
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 300)
    edge = np.array([0, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)

    def keys_of(n, s):
        return make_keys(n, 0, seed + s)[0]

    def vals_of(n):
        return rng.integers(0, MISS, n, dtype=np.uint32)

    def split(k, n, **kw):
        return [(k[i:i + n], vals_of(k[i:i + n].size), kw)
                for i in range(0, k.size, n)]

    def run(label, create, insert, batches, check=None):
        cu, host = create(dev), create("cpu")
        seen, ms = [], []
        kern.reset_passes()
        for kb, vb, kw in batches:
            k = torch.from_numpy(kb.view(np.int32)).to(dev)
            v = torch.from_numpy(vb.view(np.int32)).to(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cu = insert(cu, k, v, **kw)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            host = insert(host, kb, vb, **kw)
            for f in type(cu)._fields:
                if not equal_bits(getattr(cu, f).cpu(), getattr(host, f)):
                    raise AssertionError(f"(c) {label}: {f} differs from the "
                                         f"host loop")
            seen.append(host)
        if check is not None:
            assert check(seen), f"(c) {label}: the trace missed its case"
        scalars = {f: getattr(host, f).item() for f in type(host)._fields
                   if getattr(host, f).dim() == 0}
        passes = kern.passes().get("ch_insert")
        log(f"(c) {label}: kernel == plain, {len(type(host)._fields)} "
            f"arrays x {len(batches)} batches "
            f"({sum(b[0].size for b in batches)} keys); {scalars}; kernel "
            f"ms per batch {[round(x, 3) for x in ms]}"
            + (f"; {ch_pass_line(passes)}" if passes else ""))

    # HT: doublings from 2^4 to its maximum 2^10, then full windows drop;
    # re-inserts and duplicates inside one window; the edge keys
    k = keys_of(2500, 301)
    dup = np.repeat(k[:200], 2)[rng.permutation(400)]
    k = np.concatenate([k[:900], edge, dup, k[900:], edge, k[:300], edge])
    run("ht_insert, 2^4 doubled to 2^10, then drops",
        lambda d: bl.ht_create(10, 4, device=d), bl.ht_insert_many,
        split(k, 400), lambda s: int(s[-1].size_log2) == 10
        and int(s[-1].dropped) > 0)
    # a doubling that meets a full window (a fabricated state: 40 keys of
    # one home in the doubled table) loses entries without a count
    lossy = np.full(1 << 10, MISS, np.uint32), np.zeros(1 << 10, np.uint32)
    lossy[0][3:43] = same_home_keys(np, rng, 40, 7, 5)
    lossy[1][3:43] = np.arange(1, 41, dtype=np.uint32)
    arrays = (*lossy, np.int32(6), np.int32(22), np.int32(0))
    run("ht_insert, a doubling that loses 8 entries",
        lambda d: convert.ht_state_from_numpy(arrays, device=d),
        bl.ht_insert_many, split(keys_of(10, 302), 10),
        lambda s: int(np.isin(lossy[0][3:43],
                              s[-1].keys.numpy()).sum()) == 32)
    # a fabricated crowded table (40 slots filled from one home on, so keys
    # of that home find their 32-slot window full) about 30 entries short of
    # its load test: the batch's first 10 keys drop, then fresh keys, so
    # the prefix count that takes every key as fresh ends a segment where
    # the exact count does not fire; the doubling comes about 10 keys later
    arrays, crowd = crowded_ht_state(np, rng, keys_of(300, 308))
    fresh = keys_of(600, 309)
    run("ht_insert, drops ahead of a doubling in one batch (fabricated)",
        lambda d: convert.ht_state_from_numpy(arrays, device=d),
        bl.ht_insert_many,
        split(np.concatenate([crowd, fresh[:200]]), 210)
        + split(fresh[200:], 200),
        lambda s: int(s[0].size_log2) == 11 and int(s[0].dropped) >= 10)
    k = keys_of(1 << 16, 303)
    run("ht_insert, 2^16 keys from 2^9",
        lambda d: bl.ht_create(20, 9, device=d), bl.ht_insert_many,
        split(k, 1 << 14))

    # HTI: migrate_batch 16, migrations over several batches, re-inserts of
    # keys still in the old table, then one insert of batch 2^14 drains it
    k = keys_of(3000, 304)
    k = np.concatenate([k[:1200], edge, k[300:700], k[1200:2100], edge,
                        k[1500:1800], k[2100:], edge])
    run("hti_insert, migrate_batch 16, stale re-inserts, drained",
        lambda d: bl.hti_create(14, 4, device=d), bl.hti_insert_many,
        split(k, 100, migrate_batch=16)
        + [(k[:1], vals_of(1), dict(migrate_batch=1 << 14))],
        lambda s: sum(bool(x.migrating) for x in s) >= 3
        and not bool(s[-1].migrating))
    # migrate_batch 4: each batch re-inserts keys of the batch before it,
    # most still in the old table and migrated later in the same batch (the
    # stale overwrite), some migrated already, and the EMPTY pattern five
    # times (values left in EMPTY slots, slots taken later)
    k = keys_of(2400, 310)
    batches = []
    for i in range(0, k.size, 300):
        b = np.concatenate([k[i:i + 300], k[max(i - 300, 0):i][::3],
                            np.full(5, MISS, np.uint32)])
        batches.append(b[rng.permutation(b.size)])
    run("hti_insert, re-inserts of migrating keys and the EMPTY pattern",
        lambda d: bl.hti_create(14, 6, device=d), bl.hti_insert_many,
        [(b, vals_of(b.size), dict(migrate_batch=4)) for b in batches],
        lambda s: sum(bool(x.migrating) for x in s) >= 4)
    k = keys_of(1 << 16, 305)
    run("hti_insert, 2^16 keys from 2^9",
        lambda d: bl.hti_create(20, 9, device=d), bl.hti_insert_many,
        split(k, 1 << 14))

    # CH: table_log2 4 (chains of several buckets) until capacity, then
    # dropped; duplicate appends; the edge keys
    k = keys_of(6000, 306)
    k = np.concatenate([k[:2000], edge, k[:500], np.repeat(k[2000:2300], 2),
                        k[2300:], edge])
    run("ch_insert, 16 chains until capacity, duplicates",
        lambda d: bl.ch_create(4, 600, 8, device=d), bl.ch_insert_many,
        split(k, 1500), lambda s: int(s[-1].dropped) > 0
        and int(s[-1].num_buckets) == 600)
    k = keys_of(1 << 16, 307)
    run("ch_insert, 2^16 keys, 2^12 chains",
        lambda d: bl.ch_create(12, 8192, 16, device=d), bl.ch_insert_many,
        split(k, 1 << 14))
    # one chain (T 2, every key of slot 0) takes 2^14 keys a batch: 1024 new
    # buckets a batch over the whole grid; its ms per batch grow only with
    # the walk to the tail (1024 links more a batch), not with its keys
    k = same_home_keys(np, rng, 1 << 16, 2, 0)
    run("ch_insert, one chain of 2^16 keys",
        lambda d: bl.ch_create(2, 8192, 16, device=d), bl.ch_insert_many,
        split(k, 1 << 14), lambda s: int(s[-1].num_buckets) == 4096)
    # 2^12 chains, room for 3000 buckets: the first batch opens about 4096
    k = keys_of(1 << 15, 311)
    run("ch_insert, capacity out inside the first batch",
        lambda d: bl.ch_create(12, 3000, 16, device=d), bl.ch_insert_many,
        split(k, 1 << 14), lambda s: int(s[0].num_buckets) == 3000
        and int(s[0].dropped) > 0)
    # 2^17 chains: three radix passes, the last over one bit
    k = keys_of(1 << 16, 312)
    run("ch_insert, 2^17 chains",
        lambda d: bl.ch_create(17, 1 << 17, 16, device=d), bl.ch_insert_many,
        split(k, 1 << 14))


def lookup_shapes(torch, np, seed: int) -> None:
    """(c): all four lookup entry points against their plain versions at
    S in {4, 8, 16, 512} (the probe's scalar path at 4 and 8, its vector
    path at 16 and 512), on an index whose capacity ran out (full rows that absent keys walk whole),
    with absent keys and the EMPTY pattern among the probes."""
    from repro_torch.core import extendible_hashing as eh
    from repro_torch.core import hashing
    from repro_torch.kernels import eh_lookup as lk
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 300)
    for S, n in ((4, 3000), (8, 5000), (16, 8000), (512, 200_000)):
        k, _, absent = make_keys(n, 2000, seed + 300 + S)
        v = rng.integers(0, MISS, n, dtype=np.uint32)
        C = max(4, int(n / S * 0.8))
        st = eh.eh_insert_many(eh.eh_create(12, S, C, device=dev),
                               torch.from_numpy(k.view(np.int32)).to(dev),
                               torch.from_numpy(v.view(np.int32)).to(dev))
        assert int(st.dropped) > 0, f"(c) lookup S={S}: no row ran full"
        probe = np.concatenate([k, absent, np.array([MISS, 0], np.uint32)])
        pk = torch.from_numpy(probe.view(np.int32)).to(dev)
        g = int(st.global_depth)
        vk, vv = eh.compose_shortcut(st, 1 << g)
        two = lambda t: torch.stack([hashing.bits(t)] * 2)  # noqa: E731
        dirs, bks, bvs, vks, vvs = (two(st.directory), two(st.bucket_keys),
                                    two(st.bucket_vals), two(vk), two(vv))
        gds = torch.tensor([g, g], dtype=torch.int32, device=dev)
        flags = torch.tensor([1, 0], dtype=torch.int32, device=dev)
        pk2 = torch.stack([pk, pk])
        want_t = ref.eh_lookup_ref(pk, st.directory, st.bucket_keys,
                                   st.bucket_vals, g)
        want_s = ref.shortcut_lookup_ref(pk, vk, vv, g)
        want_r = ref.routed_lookup_ref(pk2, dirs, bks, bvs, gds, vks, vvs,
                                       gds, flags)
        want_k = ref.stacked_shortcut_lookup_ref(pk, vks, vvs, gds, 1)
        hits = int((hashing.bits(want_t) != -1).sum())
        got = {
            "traditional": lk.eh_lookup(pk, st.directory, st.bucket_keys,
                                        st.bucket_vals, g),
            "shortcut": lk.shortcut_lookup(pk, vk, vv, g),
            "stacked": lk.stacked_shortcut_lookup(pk, vks, vvs, gds, 1),
            "routed": lk.sharded_routed_lookup(pk2, dirs, bks, bvs, gds, vks,
                                               vvs, gds, flags)}
        for name, want in (("traditional", want_t), ("shortcut", want_s),
                           ("stacked", want_k), ("routed", want_r)):
            assert equal_bits(got[name], want), \
                f"(c) {name} lookup S={S} differs"
        path = "scalar" if S % 4 or S < 16 else "vector"
        log(f"(c) lookup kernels == plain at S={S} (traditional, shortcut, "
            f"stacked, routed): {probe.size} keys, {hits} hits, "
            f"{int(st.dropped)} dropped at capacity {C}; the {path} path")
    torch.cuda.synchronize()


BF16_STEP = 2.0 ** -7            # bfloat16's relative step (8-bit significand)


def attn_limit(torch, want):
    """The largest |got - want| a sound decode kernel may show, element by
    element.  float32: ``tests/test_kernels.py``'s 2e-5 (1 + |want|) (sums in
    another order).  bfloat16: both sides sum in float32 and round once to
    bfloat16, so they differ by one bfloat16 step of the element at most
    (2^-7 |want|), plus what float32 sums in another order move, which stays
    under half a step of the output's scale (2^-8 max |want|).  A kernel that
    drops a token, skips a chunk or moves the window edge goes past it:
    ``wrong_variants`` shows that at each shape checked."""
    w = want.float().abs()
    if want.dtype == torch.bfloat16:
        return BF16_STEP * w + BF16_STEP / 2 * w.max()
    return 2e-5 * (1 + w)


def err_ratio(torch, got, want) -> tuple:
    """(largest |got - want| over ``attn_limit``, largest |got - want|)."""
    if got.shape != want.shape:
        raise AssertionError(f"shapes {tuple(got.shape)}, {tuple(want.shape)}")
    diff = (got.float() - want.float()).abs()
    ratio = torch.where(diff > 0, diff / attn_limit(torch, want), 0.0)
    return float(ratio.max()), float(diff.max())


def close(torch, got, want) -> tuple:
    """(largest |got - want| over its limit, largest |got - want|); raises
    unless every element of ``got`` is within ``attn_limit`` of ``want``."""
    ratio, err = err_ratio(torch, got, want)
    if not ratio <= 1:
        raise AssertionError(f"max |err| {err} over the limit ({want.dtype}):"
                             f" |err| / limit up to {ratio}")
    return ratio, err


def wrong_variants(torch, want, q, k, v, ctx, window=None, softcap=None):
    """The plain version of three wrong kernels on the same inputs (q (B, KV,
    G, hd), k/v (B, KV, S, hd)): the last live token dropped, the middle
    64-token chunk of each context skipped, and (with ``window``) the window
    edge moved out by one token.  Each must go past ``attn_limit`` of
    ``want``, or the check could not tell it from a sound kernel; returns
    each one's |err| / limit, the smallest of which is the check's margin."""
    from repro_torch.kernels import ref
    S = k.shape[2]
    ctx = ctx.long()[:, None]
    pos = torch.arange(S, device=q.device)[None]
    first = (ctx - window).clamp_min(0) if window is not None else 0 * ctx
    live = (pos < ctx) & (pos >= first)
    mid = (first + ctx) // 2 // 64 * 64
    masks = {"last token dropped": live & (pos != ctx - 1),
             "a 64-token chunk skipped": live & ((pos < mid) | (pos >= mid + 64))}
    if window is not None:
        masks["window edge moved by one"] = live | ((pos == first - 1)
                                                    & (pos >= 0))
    out = {}
    for name, m in masks.items():
        bad = ref._decode_live(q, k, v, m, softcap)
        ratio, _ = err_ratio(torch, bad.reshape(want.shape), want)
        if not ratio > 1:
            raise AssertionError(f"a wrong kernel ({name}) is within the "
                                 f"limit: |err| / limit {ratio}")
        out[name] = ratio
    return out


def phase_attention(torch, np, seed: int) -> None:
    """(c), the decode kernels: each against its plain version, float32 and
    bfloat16, through ``ops`` (transposed views and pools, read in place)
    and on contiguous inputs; contexts off the tile, 0 and S_cap; a -1
    table entry inside the context and an all -1 row; the widths of
    qwen3_4b (KV 8, G 4) and of gemma2_27b (KV 16, G 2, softcap 50.0,
    window 4096 cutting an 8192 context, on both routes), G = 3 at hd 64,
    and contexts at the split kernel's edges (SPLIT - 1, SPLIT, SPLIT + 1,
    S_cap); at each shape the self-row fold (the current token's K/V row as
    the last live position) against its plain version on both routes, and
    the shortcut route bitwise equal to the paged route over the same rows
    in shuffled blocks."""
    from repro_torch.kernels import _decode, ops, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.shortcut_attention import shortcut_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 100)
    rng = np.random.default_rng(seed + 100)
    bs, sp = 16, _decode.SPLIT
    cases = [  # name, B, KV, G, hd, S_cap, ctx, window, softcap
        ("qwen3_4b widths", 3, 8, 4, 128, 200, [0, 77, 200], None, None),
        ("gemma2_27b widths", 2, 16, 2, 128, 8192, [8192, 5001], 4096, 50.0),
        ("G=3, hd=64", 2, 1, 3, 64, 130, [130, 1], None, 7.0),
        ("split edges", 4, 8, 4, 128, 3 * sp + 40,
         [sp - 1, sp, sp + 1, 3 * sp + 40], None, None)]
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, KV, G, hd, S, ctx, window, softcap in cases:
            def randn(*shape):
                return torch.randn(shape, generator=gen, device=dev).to(dtype)
            H, MB = KV * G, -(-S // bs)
            q = randn(B, H, hd)
            vk, vv = randn(B, S, KV, hd), randn(B, S, KV, hd)
            kn, vn = randn(B, KV, hd), randn(B, KV, hd)
            lens = torch.tensor(ctx, dtype=torch.int32, device=dev)
            qk = q.reshape(B, KV, G, hd)
            want = ref.decode_attention_ref(
                qk, vk.transpose(1, 2), vv.transpose(1, 2), lens,
                window=window, softcap=softcap).reshape(B, H, hd)
            got = ops.decode_shortcut(q, vk, vv, lens, window=window,
                                      softcap=softcap)
            checks = [close(torch, got, want)]
            margins = wrong_variants(
                torch, want, qk, vk.transpose(1, 2), vv.transpose(1, 2),
                lens, window, softcap)
            short = got
            got = shortcut_attention(qk, vk.transpose(1, 2).contiguous(),
                                     vv.transpose(1, 2).contiguous(), lens,
                                     window=window, softcap=softcap)
            checks.append(close(torch, got.reshape(B, H, hd), want))
            for b, c in enumerate(ctx):
                if c == 0:
                    assert not got[b].any(), f"(c) {name}: ctx 0 not zeros"
            want_self = ref.decode_attention_ref(
                qk, vk.transpose(1, 2), vv.transpose(1, 2), lens,
                window=window, softcap=softcap, k_new=kn,
                v_new=vn).reshape(B, H, hd)
            short_self = ops.decode_shortcut(q, vk, vv, lens, window=window,
                                             softcap=softcap, k_new=kn,
                                             v_new=vn)
            checks.append(close(torch, short_self, want_self))
            # a kernel that left the self row out must go past the limit
            self_margin, _ = err_ratio(torch, want, want_self)
            assert self_margin > 1, \
                f"(c) {name}: the self row left out is within the limit"
            # the same contexts in a shuffled pool (cache layout), one -1
            # entry inside the context of the last sequence, and the first
            # sequence's row all -1 (zeros whatever its length)
            blocks = torch.from_numpy(rng.permutation(B * MB)).to(dev)
            tables = blocks.reshape(B, MB).to(torch.int32)
            kp = torch.zeros((B * MB * bs, KV, hd), dtype=dtype, device=dev)
            vp = torch.zeros_like(kp)
            pos = (tables.long()[:, :, None] * bs
                   + torch.arange(bs, device=dev)).reshape(B, MB * bs)[:, :S]
            kp[pos] = vk
            vp[pos] = vv
            kp, vp = kp.reshape(-1, bs, KV, hd), vp.reshape(-1, bs, KV, hd)
            got = ops.decode_paged(q, kp, vp, tables, lens, softcap=softcap,
                                   window=window)
            checks.append(close(torch, got, want))
            assert torch.equal(got, short), \
                f"(c) {name}: shortcut and paged routes differ in bits"
            got = ops.decode_paged(q, kp, vp, tables, lens, softcap=softcap,
                                   window=window, k_new=kn, v_new=vn)
            checks.append(close(torch, got, want_self))
            assert torch.equal(got, short_self), \
                f"(c) {name}: routes differ in bits with the self row"
            tables[-1, (ctx[-1] - 1) // bs // 2] = -1
            tables[0] = -1
            want = ref.paged_attention_ref(
                qk, kp.transpose(1, 2), vp.transpose(1, 2), tables,
                lens, softcap=softcap, window=window).reshape(B, H, hd)
            got = ops.decode_paged(q, kp, vp, tables, lens, softcap=softcap,
                                   window=window)
            checks.append(close(torch, got, want))
            if window is None:
                got = paged_attention(qk, kp.transpose(1, 2).contiguous(),
                                      vp.transpose(1, 2).contiguous(), tables,
                                      lens, softcap=softcap)
            else:
                got = pa.attend(qk, kp.transpose(1, 2).contiguous(),
                                vp.transpose(1, 2).contiguous(), tables,
                                lens, softcap=softcap, window=window)
            checks.append(close(torch, got.reshape(B, H, hd), want))
            assert not got[0].any(), f"(c) {name}: all -1 row not zeros"
            ratio, err = map(max, zip(*checks))
            log(f"(c) decode kernels == plain ({str(dtype)[6:]}, {name}: B "
                f"{B}, KV {KV}, G {G}, hd {hd}, S_cap {S}, ctx {ctx}, window "
                f"{window}, softcap {softcap}; strided and contiguous; both "
                f"routes with the window; the self row; a -1 entry and an all "
                f"-1 row): max |err| {err:.3g}, |err| / limit {ratio:.3g}; "
                f"shortcut == paged bit for bit (with and without the self "
                f"row); wrong kernels' |err| / limit "
                + ", ".join(f"{k} {r:.3g}" for k, r in margins.items())
                + f"; the self row left out {self_margin:.3g}")
    torch.cuda.synchronize()


# (c), flash attention: name, q shape (B, KV, G, Sq, hd), Skv, window,
# softcap, input scale.  tests/test_kernels.py's cases (the causal sweep, its
# ragged 96-token case, windows 16, 33 and 100, softcap 20, q shorter than
# the keys), q shorter with a ragged tail and a window under a tile, and
# PaliGemma's head_dim 256 with 8 query heads over one kv head
FLASH_CASES = [
    ("sweep 1", (1, 1, 1, 64, 16), 64, None, None, 1.0),
    ("sweep 2", (2, 2, 4, 128, 32), 128, None, None, 1.0),
    ("sweep 3, ragged", (1, 4, 2, 96, 64), 96, None, None, 1.0),
    ("sweep 4", (2, 1, 8, 128, 128), 128, None, None, 1.0),
    ("window 16", (1, 2, 2, 128, 32), 128, 16, None, 1.0),
    ("window 33", (1, 2, 2, 128, 32), 128, 33, None, 1.0),
    ("window 100", (1, 2, 2, 128, 32), 128, 100, None, 1.0),
    ("softcap 20", (1, 1, 2, 64, 32), 64, None, 20.0, 3.0),
    ("Sq < Skv", (1, 2, 2, 32, 32), 128, None, None, 1.0),
    ("Sq < Skv, ragged, window 33", (2, 1, 3, 20, 16), 100, 33, None, 1.0),
    ("hd 256, G 8", (1, 1, 8, 300, 256), 300, None, None, 1.0),
]
# (c), flash attention in bfloat16 at the model widths: name, q shape, Skv,
# window, softcap, sequences held to the plain version (None: all).
# hymba_1_5b: 25 query heads over 5 KV heads (G 5, which does not divide a
# 64-row warpgroup) x 64, its 1024-token window over a ragged 1500 tokens;
# musicgen_medium: 24 heads x 64 without GQA (G 1) over a ragged 1000
FLASH_MODEL_CASES = [
    ("qwen3_4b prefill layer", (8, 8, 4, 2048, 128), 2048, None, None, 2),
    ("gemma2_27b widths", (1, 16, 2, 8192, 128), 8192, 4096, 50.0, None),
    ("hymba_1_5b widths", (1, 5, 5, 1500, 64), 1500, 1024, None, None),
    ("musicgen_medium widths", (2, 24, 1, 1000, 64), 1000, None, None, None),
]


def flash_wrong_variants(torch, want, q, k, v, window=None, softcap=None):
    """The plain version of three wrong flash kernels on the same inputs (q
    (B, KV, G, Sq, hd), k/v (B, KV, Skv, hd)): the diagonal token dropped,
    q_offset off by one, and (with ``window``) the window edge moved out by
    one.  Each must go past ``attn_limit`` of ``want``; returns each one's
    |err| / limit."""
    from repro_torch.kernels import ref
    Sq, Skv, dev = q.shape[3], k.shape[2], q.device
    mask = ref.flash_mask(Sq, Skv, window=window, device=dev)
    diag = (torch.arange(Sq, device=dev)[:, None] + Skv - Sq
            == torch.arange(Skv, device=dev)[None, :])
    masks = {"diagonal token dropped": mask & ~diag,
             "q_offset off by one": ref.flash_mask(
                 Sq, Skv, window=window, q_offset=Skv - Sq - 1, device=dev)}
    if window is not None:
        masks["window edge moved by one"] = ref.flash_mask(
            Sq, Skv, window=window + 1, device=dev)
    out = {}
    for name, m in masks.items():
        bad = ref.flash_attention_masked(q, k, v, m, softcap)
        ratio, _ = err_ratio(torch, bad, want)
        del bad
        if not ratio > 1:
            raise AssertionError(f"a wrong flash kernel ({name}) is within "
                                 f"the limit: |err| / limit {ratio}")
        out[name] = ratio
    return out


def phase_flash(torch, seed: int) -> None:
    """(c), the flash kernel against its plain version: float32 and bfloat16
    at ``FLASH_CASES`` (contiguous operands, and the model layout through
    ``ops.mha_forward``: strided views in, (B, S, H, hd) out), then bfloat16
    at qwen3_4b's prefill layer shape (8 x 2048 tokens, 32 query heads over
    8 KV heads, hd 128; the plain version on 2 of the sequences), at
    gemma2_27b's widths (16 KV heads, G 2, hd 128) with window 4096 and
    softcap 50 over 8192 tokens, at hymba_1_5b's (KV 5, G 5, hd 64, window
    1024 over 1500 tokens) and at musicgen_medium's (24 heads, G 1, hd 64,
    1000 tokens); each line names the kernel that ran (``tensor-core`` or
    ``simt``); at each shape the wrong kernels' plain versions go past the
    limit."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention, kernel_path
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 200)

    def model_layout(shape, skv, dtype, scale):
        B, KV, G, Sq, hd = shape
        def randn(*s):
            return (torch.randn(s, generator=gen, device=dev)
                    * scale).to(dtype)
        qm, km = randn(B, Sq, KV * G, hd), randn(B, skv, KV, hd)
        vm = (torch.randn((B, skv, KV, hd), generator=gen,
                          device=dev)).to(dtype)
        q = qm.reshape(B, Sq, KV, G, hd).permute(0, 2, 3, 1, 4)
        return qm, km, vm, q, km.transpose(1, 2), vm.transpose(1, 2)

    def check(name, shape, skv, window, softcap, dtype, scale, n_plain=None):
        qm, km, vm, q, k, v = model_layout(shape, skv, dtype, scale)
        B, KV, G, Sq, hd = shape
        n = B if n_plain is None else n_plain
        want = ref.flash_attention_ref(q[:n], k[:n], v[:n], causal=True,
                                       window=window, softcap=softcap)
        got = ops.mha_forward(qm, km, vm, window=window, softcap=softcap)
        got = got.reshape(B, Sq, KV, G, hd).permute(0, 2, 3, 1, 4)
        checks = [close(torch, got[:n], want)]
        del got
        if n_plain is None:
            got = flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), window=window,
                                  softcap=softcap)
            checks.append(close(torch, got, want))
            del got
        margins = flash_wrong_variants(torch, want, q[:n], k[:n], v[:n],
                                       window, softcap)
        ratio, err = map(max, zip(*checks))
        log(f"(c) flash kernel ({kernel_path(dtype, hd)}) == plain "
            f"({str(dtype)[6:]}, {name}: q "
            f"{tuple(shape)}, Skv {skv}, window {window}, softcap {softcap}"
            f"{'' if n_plain is None else f'; plain on {n} of {B} sequences'}"
            f"): max |err| {err:.3g}, |err| / limit {ratio:.3g}; wrong "
            "kernels' |err| / limit "
            + ", ".join(f"{k} {r:.3g}" for k, r in margins.items()))

    for dtype in (torch.float32, torch.bfloat16):
        for name, shape, skv, window, softcap, scale in FLASH_CASES:
            check(name, shape, skv, window, softcap, dtype, scale)
    for name, shape, skv, window, softcap, n_plain in FLASH_MODEL_CASES:
        check(name, shape, skv, window, softcap, torch.bfloat16, 1.0,
              n_plain=n_plain)
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
    batch_s = []
    for i in range(0, n, batch):
        if i == n - batch:
            res["last_batch_state"] = sc.state      # kernel timing input
        t0 = time.perf_counter()
        sc.insert(keys[i:i + batch], vals[i:i + batch])
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
    st = sc.state
    res["resident"] = sum(a.nbytes for a in st)
    t_insert = sum(batch_s)
    res["insert_s"] = t_insert
    res["batch_s"] = batch_s
    log(f"(d) inserted {n} keys in 16 batches: {t_insert:.3f} s; "
        f"global_depth {int(st.global_depth)}, buckets "
        f"{int(st.num_buckets)}, fan-in {sc.avg_fan_in():.3f}, dropped "
        f"{int(st.dropped)}")
    log(f"(d) insert seconds per batch (host clock + sync): "
        f"{[round(x, 6) for x in batch_s]}")
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
         max_err, library_ms=None, phase="e", flops=0) -> dict:
    """One entry of the ``{"kernels": [...]}`` line; the bound is the larger
    of the bytes the function must move over the card's memory rate and its
    ``flops`` over the bfloat16 tensor-core peak."""
    by_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_BF16 * 1e3
    bound = max(by_bytes, by_ops)
    bound_by = "operations" if by_ops > by_bytes else "bytes"
    log(f"({phase}) {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({bytes_} B, {flops} flops: {bound_by}), library "
        f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}, max "
        f"|err| {max_err}, launches {launches.get(name, 0)}")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches.get(name, 0),
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": library_ms}


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

    # a yardstick of the card's random reads, which a lookup needs two of
    # (its row, then its value): torch.take of as many random int32 of the
    # key pool as the probe has keys, and of the key and the value pool
    nb = int(st.num_buckets)
    pools = [hashing.bits(t)[:nb].reshape(-1) for t in (st.bucket_keys,
                                                        st.bucket_vals)]
    gen = torch.Generator(device=probe.device)
    gen.manual_seed(0)
    pos = [torch.randint(0, pools[0].numel(), (probe.numel(),),
                         device=probe.device, generator=gen) for _ in pools]
    one_ms, _ = timer(lambda: torch.take(pools[0], pos[0]))
    two_ms, _ = timer(lambda: [torch.take(t, q) for t, q in zip(pools, pos)])
    log(f"(e) random reads: torch.take of {probe.numel()} random int32 of "
        f"the {pools[0].numel() * 4} B key pool {one_ms:.4f} ms; of the key "
        f"and of the value pool {two_ms:.4f} ms")
    del pools, pos

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
    batch_s = []
    for i in range(0, n, batch):
        t0 = time.perf_counter()
        idx.insert(keys[i:i + batch], vals[i:i + batch])
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
    t_insert = sum(batch_s)
    res["insert_s"] = t_insert
    log(f"(f) insert seconds per batch (host clock + sync): "
        f"{[round(x, 6) for x in batch_s]}")
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


def phase_kv(torch, np, args, timer) -> dict:
    """(g): the KV serving layer at qwen3_4b's KV widths; returns what its
    report and kernel rows need.  Launch counts cover steps 1-8 (the
    per-kernel timings run between the sync and the async part, outside
    the counts)."""
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kvcache import paged_cache as pc
    from repro_torch.kvcache.prefix_index import PrefixCacheIndex
    from repro_torch.kvcache.shortcut_cache import ShortcutKVManager
    dev = torch.device("cuda")
    c = KV_CONFIG
    L, H, KV, hd = c["layers"], c["q_heads"], c["kv_heads"], c["head_dim"]
    bs = c["block"]
    B, cap, group = c["seqs"], c["seq_capacity"], c["prefill_group"]
    MB = cap // bs
    nblocks = 5 * B * MB // 4
    G = H // KV
    rng = np.random.default_rng(args.seed + 7)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 7)
    bf16 = torch.bfloat16
    ids = np.arange(B)
    ids_t = torch.from_numpy(ids).to(dev)
    res = {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=bf16)

    def prompt_len():
        lo, hi = c["prompt_lens"]
        return bs * int(rng.integers(lo // bs, hi // bs + 1))

    def decode(route, q, mgr, check_layers=()):
        """The 36 layers' attention of one step on ``route``; each checked
        layer held to the plain version."""
        cache = mgr.cache
        lens = cache.seq_lens[ids_t]
        if route == "paged":
            tables = cache.block_tables[ids_t]
            outs = [ops.decode_paged(q, cache.k_pool[l], cache.v_pool[l],
                                     tables, lens) for l in range(L)]
        else:
            sk, sv = mgr.view_stack()
            outs = [ops.decode_shortcut(q, sk[0, l], sv[0, l], lens)
                    for l in range(L)]
        for l in check_layers:
            want = ref.paged_attention_ref(
                q.reshape(B, KV, G, hd), cache.k_pool[l].transpose(1, 2),
                cache.v_pool[l].transpose(1, 2), cache.block_tables[ids_t],
                lens).reshape(B, H, hd)
            close(torch, outs[l], want)
        return outs

    def sync_ms(fn):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t_phase = time.perf_counter()

    # 1. prefill, 4 groups of 4 sequences, one length per group
    mgr = ShortcutKVManager(
        pc.cache_create(L, nblocks, bs, KV, hd, B, MB, bf16, device=dev),
        cap, num_shards=1, device=dev)
    lens0 = []
    for g0 in range(0, B, group):
        S = prompt_len()
        k, v = randn(L, group, S, KV, hd), randn(L, group, S, KV, hd)
        mgr.prefill(ids[g0:g0 + group], k, v)
        lens0 += [S] * group
        del k, v
    assert mgr.seq_lens(ids).tolist() == lens0
    log(f"(g) prefilled {B} sequences of {sorted(set(lens0))} tokens in "
        f"groups of {group}: L {L}, KV {KV}, hd {hd}, block {bs}, "
        f"{nblocks} blocks; pools {2 * mgr.cache.k_pool.nbytes} B, view "
        f"stack {sum(a.nbytes for a in mgr.view_stack())} B")

    # 2. fragment: permute the physical blocks (pool rows, tables and free
    # ring together, so the content is unchanged), as after evictions
    perm = torch.from_numpy(rng.permutation(nblocks)).to(dev)
    inv = torch.argsort(perm)
    with mgr.group[0].lock:
        old = mgr.cache
        mgr.cache = old._replace(
            k_pool=old.k_pool[:, inv], v_pool=old.v_pool[:, inv],
            block_tables=torch.where(
                old.block_tables >= 0,
                perm[old.block_tables.clamp_min(0).long()].to(torch.int32),
                old.block_tables),
            free_ring=perm[old.free_ring.long()].to(torch.int32))
        del old
    frag = mgr.fragmentation(ids)
    assert frag > 0.9 and mgr.route(ids) == "paged", (frag, mgr.route(ids))
    res["create_ms"] = sync_ms(mgr.pump) / B
    assert mgr.in_sync(ids) and mgr.route(ids) == "shortcut"
    log(f"(g) fragmentation {frag:.4f}; create replay of {B} sequences: "
        f"{res['create_ms']:.3f} ms per sequence; route shortcut")
    tables0 = mgr.cache.block_tables.cpu().numpy()

    # 3. the view against the paged gather, sequence by sequence: equal
    # below seq_len, zeros past it
    sk, sv = mgr.view_stack()
    for s in ids.tolist():
        n = lens0[s]
        gk, gv = pc.gather_context(mgr.cache, [s])
        for view, g in ((sk, gk), (sv, gv)):
            row = view[0, :, s].transpose(1, 2)        # (L, KV, cap, hd)
            assert equal_bits(row[:, :, :n], g[:, 0, :, :n]), f"(g) seq {s}"
            assert not row[:, :, n:].any(), f"(g) seq {s}: nonzero tail"
    del sk, sv, gk, gv, row
    log(f"(g) composed view == gather_context bit for bit for all {B} "
        "sequences, zeros past seq_len")

    # 4-5. decode steps; a release and re-prefill part-way
    victim = int(rng.integers(B))
    others = np.delete(ids, victim)
    res["append_ms"], res["pump_ms"] = [], []
    for step in range(c["decode_steps"]):
        if step == c["decode_steps"] // 2:
            mgr.release([victim])
            assert mgr.route(ids) == "paged"
            assert mgr.route(others) == "shortcut"
            q = randn(B, H, hd)
            for route in ("paged", "shortcut"):
                outs = decode(route, q, mgr, check_layers=(0,))
                assert not any(o[victim].any() for o in outs), \
                    f"(g) {route}: a released sequence did not decode to 0"
            S = prompt_len()
            mgr.prefill([victim], randn(L, 1, S, KV, hd),
                        randn(L, 1, S, KV, hd))
            assert mgr.route(ids) == "paged"
            res["recreate_ms"] = sync_ms(mgr.pump)
            assert mgr.route(ids) == "shortcut"
            log(f"(g) step {step}: released sequence {victim} (both kernels "
                f"decode it to zeros, route paged), re-prefilled {S} "
                f"tokens, create replay {res['recreate_ms']:.3f} ms, route "
                "shortcut")
        q = randn(B, H, hd)
        nk, nv = randn(L, B, KV, hd), randn(L, B, KV, hd)
        res["append_ms"].append(sync_ms(lambda: mgr.append(ids, nk, nv)))
        assert mgr.route(ids) == "paged"
        check = (0, L - 1) if step % 8 == 0 else ()
        paged = decode("paged", q, mgr, check)
        res["pump_ms"].append(sync_ms(mgr.pump))
        assert mgr.route(ids) == "shortcut"
        short = decode("shortcut", q, mgr, check)
        ratio, err = map(max, zip(*(close(torch, a, b)
                                    for a, b in zip(paged, short))))
        assert all(torch.equal(a, b) for a, b in zip(paged, short)), \
            f"(g) step {step}: the routes differ in bits"
    del paged, short
    res["lens"] = mgr.seq_lens(ids)
    log(f"(g) {c['decode_steps']} decode steps x {L} layers on both routes: "
        f"routes equal bit for bit at every step and layer (last step max "
        f"|err| {err:.3g}, |err| / limit {ratio:.3g}); plain "
        f"checks on layers 0 and {L - 1} every 8 steps; lengths now "
        f"{res['lens'].min()}..{res['lens'].max()}")

    # 6. get_context once on each route, against per-sequence gathers
    for route in ("paged", "shortcut"):
        before = (mgr.routed_paged, mgr.routed_shortcut)
        k, v, got = mgr.get_context(ids, route=route)
        assert got == route
        for s in ids.tolist():
            n = int(res["lens"][s])
            gk, gv = pc.gather_context(mgr.cache, [s])
            for a, g in ((k, gk), (v, gv)):
                assert equal_bits(a[:, s, :, :n], g[:, 0, :, :n]), \
                    f"(g) get_context {route} seq {s}"
                if route == "shortcut":
                    assert not a[:, s, :, n:].any()
        del k, v, gk, gv
        moved = (mgr.routed_paged - before[0], mgr.routed_shortcut - before[1])
        assert moved == ((1, 0) if route == "paged" else (0, 1)), moved
    log("(g) get_context on each route == per-sequence gather_context bit "
        "for bit (shortcut zeros past seq_len); route counters moved by 1")
    torch.cuda.synchronize()
    res["launches"] = _build.launches()
    res["sync_peak"] = torch.cuda.max_memory_allocated()

    # timings at the full batch (outside the launch counts)
    res.update(measure_kv(torch, mgr, timer, ids_t, randn(B, H, hd)))
    res["stats"] = mgr.stats
    mgr.close()
    del mgr
    gc.collect()
    torch.cuda.empty_cache()
    _build.reset_launches()

    # 7. async mappers, 2 shards: decodes race the publishes
    aB, alen = c["async_seqs"], c["async_len"]
    acap = 2 * alen
    aids = np.arange(aB)
    aids_t = torch.from_numpy(aids).to(dev)
    t0 = time.perf_counter()
    amgr = ShortcutKVManager(
        pc.cache_create(L, aB * acap // bs, bs, KV, hd, aB, acap // bs, bf16,
                        device=dev),
        acap, num_shards=2, async_mapper=True, poll_interval=0.025,
        frag_threshold=0.0, device=dev)
    with amgr:
        amgr.prefill(aids, randn(L, aB, alen, KV, hd),
                     randn(L, aB, alen, KV, hd))
        routes = {"paged": 0, "shortcut": 0}
        for step in range(c["async_steps"]):
            amgr.append(aids, randn(L, aB, KV, hd), randn(L, aB, KV, hd))
            if step % 2:
                assert amgr.wait_in_sync(aids, timeout=60.0)
            q = randn(aB, H, hd)
            route = amgr.route(aids)
            cache = amgr.cache        # the main thread is the only writer
            lens = cache.seq_lens[aids_t]
            routes[route] += 1
            if route == "paged":
                tables = cache.block_tables[aids_t]
                outs = [ops.decode_paged(q, cache.k_pool[l], cache.v_pool[l],
                                         tables, lens) for l in range(L)]
            else:
                sk, sv = amgr.view_stack()
                outs = [torch.empty_like(q) for _ in range(L)]
                for s in range(2):            # each shard's rows in place
                    sel = aids_t[s::2]
                    for l in range(L):
                        outs[l][sel] = ops.decode_shortcut(
                            q[sel], sk[s, l], sv[s, l], lens[sel])
            gk, gv = pc.gather_context(cache, aids)
            for l in range(L):
                want = ref.decode_attention_ref(
                    q.reshape(aB, KV, G, hd), gk[l], gv[l],
                    lens).reshape(aB, H, hd)
                close(torch, outs[l], want)
            del gk, gv
        assert routes["paged"] >= 1 and routes["shortcut"] >= 1, routes
        log(f"(g) async mappers (2 shards, 25 ms poll): {aB} sequences of "
            f"{alen} tokens, {c['async_steps']} decode steps racing the "
            f"publishes, every layer held to the plain version over "
            f"gather_context; routes {routes}; {amgr.stats}; "
            f"{time.perf_counter() - t0:.3f} s")
    del amgr

    # 8. prefix index over the 16 prompts: a shared system prompt, then
    # each prompt's own tokens; prompt i > 0 reuses prompt 0's shared blocks
    sys_len = c["system_prompt"]
    vocab = c["vocab"]
    system = rng.integers(0, vocab, sys_len).tolist()
    prompts = [system + rng.integers(0, vocab, n - sys_len).tolist()
               for n in lens0]
    own = [tables0[s, :lens0[s] // bs].tolist() for s in ids.tolist()]
    idx = PrefixCacheIndex(bs, device=dev)
    registered = []
    for s, toks in enumerate(prompts):
        n, shared = idx.match_prefix(toks)
        assert n == (0 if s == 0 else sys_len), (s, n)
        blocks = shared + own[s][len(shared):]
        idx.insert_prefix(toks, blocks)
        registered.append(blocks)
        idx.pump()
    for toks, blocks in zip(prompts, registered):
        assert idx.match_prefix(toks) == (len(toks), blocks)
    diverging = system + rng.integers(0, vocab, 512).tolist()
    assert idx.match_prefix(diverging) == (sys_len,
                                           registered[0][:sys_len // bs])
    st = idx.stats()
    assert st["in_sync"] and st["prefix_routed_shortcut"] >= B, st
    idx.close()
    log(f"(g) prefix index: {B} prompts ({sys_len}-token system prompt) "
        f"registered, each matched to all its blocks, a diverging prompt to "
        f"the {sys_len // bs} shared ones; {st}")
    torch.cuda.synchronize()
    for k, n in _build.launches().items():
        res["launches"][k] = res["launches"].get(k, 0) + n
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    res["seconds"] = time.perf_counter() - t_phase
    log(f"(g) kernel launches on the KV path: {res['launches']}")
    for k in ("shortcut_attention", "paged_attention", "eh_lookup",
              "eh_insert"):
        assert res["launches"].get(k, 0) >= 1, f"(g) {k} never launched"
    return res


def measure_kv(torch, mgr, timer, ids_t, q) -> dict:
    """Per-route decode step (36 layer calls) and per-kernel times on
    layer 0 at the full batch, with plain and library times and bounds."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    c = KV_CONFIG
    L, KV, hd, bs = c["layers"], c["kv_heads"], c["head_dim"], c["block"]
    B, H = q.shape[:2]
    G = H // KV
    cache = mgr.cache
    lens = cache.seq_lens[ids_t]
    tables = cache.block_tables[ids_t]
    sk, sv = mgr.view_stack()
    out = {}
    out["paged_step_ms"], _ = timer(lambda: [
        ops.decode_paged(q, cache.k_pool[l], cache.v_pool[l], tables, lens)
        for l in range(L)])
    out["shortcut_step_ms"], _ = timer(lambda: [
        ops.decode_shortcut(q, sk[0, l], sv[0, l], lens) for l in range(L)])
    # the copy-on-write part of an append: one clone of each pool
    out["pool_clone_ms"], _ = timer(lambda: [
        cache.k_pool.clone(), cache.v_pool.clone()] and None)
    live = int(lens.sum())
    nblk = int(((lens + bs - 1) // bs).sum())
    io = live * KV * hd * 2 * 2 + 2 * q.nbytes      # K, V rows; q and out
    qk = q.reshape(B, KV, G, hd)
    rows = []
    timer = DeviceTimer(torch)      # the kernel rows: device time
    # paged, layer 0
    kp, vp = cache.k_pool[0], cache.v_pool[0]
    ms, got = timer(lambda: ops.decode_paged(q, kp, vp, tables, lens))
    plain_ms, want = timer(lambda: ref.paged_attention_ref(
        qk, kp.transpose(1, 2), vp.transpose(1, 2), tables, lens).reshape(
            B, H, hd), reps=3, warmup=1)
    ratio, err = close(torch, got, want)
    out["limit_ratio"] = {"paged_attention": ratio}
    rows.append(("paged_attention", "src/repro/kernels/paged_attention.py:112",
                 ms, plain_ms, io + 4 * nblk + 4 * B, err, None))
    # shortcut, layer 0, read in place from the installed stack
    vk, vv = sk[0, 0], sv[0, 0]
    ms, got = timer(lambda: ops.decode_shortcut(q, vk, vv, lens))
    plain_ms, want = timer(lambda: ref.decode_attention_ref(
        qk, vk.transpose(1, 2), vv.transpose(1, 2), lens).reshape(B, H, hd),
        reps=3, warmup=1)
    mask = (torch.arange(vk.shape[1], device=q.device)[None]
            < lens[:, None].long())[:, None, None, :]
    lib_ms, lib = timer(lambda: F.scaled_dot_product_attention(
        q[:, :, None], vk.transpose(1, 2), vv.transpose(1, 2),
        attn_mask=mask, enable_gqa=True))
    out["library_err"] = err_ratio(torch, lib[:, :, 0], want)
    ratio, err = close(torch, got, want)
    out["limit_ratio"]["shortcut_attention"] = ratio
    out["wrong_variants"] = wrong_variants(
        torch, want, qk, vk.transpose(1, 2), vv.transpose(1, 2), lens)
    rows.append(("shortcut_attention",
                 "src/repro/kernels/shortcut_attention.py:114", ms, plain_ms,
                 io + 4 * B, err, lib_ms))
    out["rows"] = rows
    out["live_tokens"] = live
    assert torch.equal(ops.decode_paged(q, kp, vp, tables, lens),
                       ops.decode_shortcut(q, vk, vv, lens)), \
        "(g) layer 0: the routes differ in bits on the installed view"
    out["device"] = {
        "shortcut_attention": device_ms(
            torch, lambda: ops.decode_shortcut(q, vk, vv, lens)),
        "paged_attention": device_ms(
            torch, lambda: ops.decode_paged(q, kp, vp, tables, lens))}
    out["splits"] = split_times(torch, timer, qk, vk.transpose(1, 2),
                                vv.transpose(1, 2), kp.transpose(1, 2),
                                vp.transpose(1, 2), tables, lens)
    return out


def split_times(torch, timer, q, k_view, v_view, k_pool, v_pool, tables,
                lens, k_new=None, v_new=None) -> dict:
    """The two decode kernels at ``SPLIT`` and at the other split length
    tried (256 and 512 tokens), timed in turns (a, b, b, a) on the same
    operands; ms per (route, split), the mean of the two turns."""
    from repro_torch.kernels import _decode
    S = k_view.shape[2]
    calls = {
        "shortcut": lambda: _decode.launch(
            "split_timing", q, k_view, v_view, lens, None, S, None, None,
            k_new, v_new),
        "paged": lambda: _decode.launch(
            "split_timing", q, k_pool, v_pool, lens, tables, k_pool.shape[2],
            None, None, k_new, v_new)}
    committed, out = _decode.SPLIT, {}
    try:
        for route, fn in calls.items():
            for sp in (256, 512, 512, 256):
                _decode.SPLIT = sp
                ms, _ = timer(fn)
                out[(route, sp)] = out.get((route, sp), 0.0) + ms / 2
    finally:
        _decode.SPLIT = committed
    return out


def device_ms(torch, fn, reps: int = 10) -> tuple:
    """The decode kernels' device time per call of ``fn`` from one
    ``torch.profiler`` trace of ``reps`` warm calls: (split kernel ms,
    combine ms), or (None, None) when the trace holds no device events.
    Unlike CUDA events around the calls, it leaves out the host's time to
    issue them, which dominates at small shapes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):          # a trace now and then holds no device events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if dev:
            break
    if not dev:
        return None, None
    return tuple(sum(e.time_range.elapsed_us() for e in dev if k in e.name)
                 / reps / 1e3 for k in DECODE_KERNELS)


def device_line(name, split_ms, combine_ms) -> str:
    if split_ms is None:
        return f"{name} device time not measured (no device events)"
    return (f"{name} device {split_ms + combine_ms:.4f} ms (split kernel "
            f"{split_ms:.4f}, combine {combine_ms:.4f})")


def split_line(splits) -> str:
    return "; ".join(f"{route} split {sp}: {ms:.4f} ms"
                     for (route, sp), ms in sorted(splits.items()))


def report_kv(kres, smi, kernels) -> None:
    """(g)'s report lines, and its two rows of the kernels line."""
    c = KV_CONFIG
    log(f"(g) decode step ({c['layers']} layer calls, {c['seqs']} sequences, "
        f"{kres['live_tokens']} live tokens, mean of 3 warm steps): paged "
        f"{kres['paged_step_ms']:.4f} ms, shortcut "
        f"{kres['shortcut_step_ms']:.4f} ms; card {smi}")
    app, pump = kres["append_ms"], kres["pump_ms"]
    log(f"(g) per decode step, mean of {len(app)} (host clock + sync): "
        f"append {sum(app) / len(app):.4f} ms (of which cloning both pools "
        f"{kres['pool_clone_ms']:.4f} ms, CUDA events), update replay + "
        f"publish (pump) {sum(pump) / len(pump):.4f} ms (min {min(pump):.4f}, "
        f"max {max(pump):.4f})")
    log(f"(g) create replay {kres['create_ms']:.4f} ms per sequence "
        f"({c['seqs']} in one pump); one re-prefilled sequence "
        f"{kres['recreate_ms']:.4f} ms")
    log(f"(g) max_memory_allocated {kres['peak_bytes']} B over (g) "
        f"({kres['sync_peak']} B over its sync part); {kres['seconds']:.1f} s")
    lib_ratio, lib_err = kres["library_err"]
    log(f"(g) {kres['stats']}; library (scaled_dot_product_attention) max "
        f"|err| vs plain {lib_err:.3g} (|err| / limit {lib_ratio:.3g})")
    log("(g) layer 0, full batch: |err| / limit (2^-7 |want| + 2^-8 max "
        "|want|) of the kernels "
        + ", ".join(f"{k} {r:.3g}" for k, r in kres["limit_ratio"].items())
        + "; of wrong kernels' plain versions "
        + ", ".join(f"{k} {r:.3g}" for k, r in kres["wrong_variants"].items()))
    log("(g) layer 0, full batch, split kernel + combine at each split "
        "length (CUDA events, turns a b b a): " + split_line(kres["splits"])
        + "; the routes equal bit for bit on the installed view; profiler: "
        + "; ".join(device_line(k, *v) for k, v in kres["device"].items()))
    for name, replaces, ms, plain_ms, bytes_, max_err, lib_ms in kres["rows"]:
        kernels.append(_row(
            name, "src/repro_torch/kernels/csrc/decode_attention.cu",
            replaces, kres["launches"], ms, plain_ms, bytes_, max_err,
            library_ms=lib_ms, phase="g"))


#: names of the decode kernels' ``__global__`` functions in a trace
DECODE_KERNELS = ("split_kernel", "combine_kernel")


def profiled(torch, fn) -> tuple:
    """``fn()`` once under ``torch.profiler``: its result, the device's busy
    ms (the summed durations of the kernels and copies it ran, which one
    stream runs one at a time), their count, and the ms of those that are
    decode-attention kernels (``DECODE_KERNELS``); (result, None, 0, None)
    when the trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    attn = sum(e.time_range.elapsed_us() for e in dev
               if any(k in e.name for k in DECODE_KERNELS)) / 1e3
    return out, (busy if dev else None), len(dev), (attn if dev else None)


def rel_rms(torch, got, want) -> float:
    """The largest, over sequences, of ||got - want|| / ||want|| along the
    last axis (float32)."""
    got, want = got.float(), want.float()
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())


def phase_model(torch, args, timer) -> dict:
    """(h): qwen3_4b at its full width, bfloat16, through the serving entry
    points: ``make_prefill_step`` twice (the second timed) on 8 seeded
    prompts of 2048 tokens, 32 greedy decode steps on the shortcut route
    (``make_serve_step``) and on the paged route (``make_paged_serve_step``
    over a cache written from the same prefill); then the checks: the routes'
    tokens identical, each route's last-step decode logits within
    ``LOGIT_LIMIT`` of a full forward over prompt + fed tokens (and a decode
    with the rope position off by one past it), and 36 flash launches per
    prefill.  Returns what its report and the flash row need."""
    from repro_torch.configs import get
    from repro_torch.kernels import _build, _decode
    from repro_torch.kvcache import paged_cache as pc
    from repro_torch.models import attention as attn
    from repro_torch.models import model as M
    from repro_torch.runtime import serve
    dev = torch.device("cuda")
    c = MODEL_CONFIG
    cfg = get(c["arch"])
    B, P, steps, bs, s_cap = (c[k] for k in ("batch", "prompt", "steps",
                                             "block", "s_cap"))
    res = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, args.seed, torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    res["init_s"] = time.perf_counter() - t0
    res["n_params"] = sum(t.numel() for t in _leaves(params))
    gen = torch.Generator(device=dev).manual_seed(args.seed + 8)
    toks = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                         device=dev)
    log(f"(h) {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads} x {cfg.resolved_head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}; {res['n_params']} parameters "
        f"(bfloat16) drawn on the card in {res['init_s']:.3f} s")

    # prefill three times: the first warms up, the second is timed, the
    # third traced; all are counted
    prefill = serve.make_prefill_step(cfg, s_cap, torch.bfloat16)
    _build.reset_launches()
    times = []
    for i in range(3):
        state = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 2:
            (logits, state), *res["prefill_trace"] = profiled(
                torch, lambda: prefill(params, {"tokens": toks}))
        else:
            logits, state = prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    res["prefill_s"] = times
    launches = _build.launches()
    res["launches"] = launches
    assert launches.get("flash_attention", 0) == 3 * cfg.num_layers, \
        f"(h) flash launches {launches}, expected {cfg.num_layers} per prefill"
    assert set(launches) == {"flash_attention"}, launches
    assert torch.isfinite(logits.float()).all(), "(h) prefill logits"
    assert logits.shape == (B, cfg.vocab_size)
    assert state.view_k.shape == (cfg.num_layers, B, cfg.num_kv_heads,
                                  s_cap, cfg.resolved_head_dim)
    tok0 = torch.argmax(logits, dim=-1).to(torch.int32)

    # the paged cache, written from the prefill's keys and values
    MB = s_cap // bs
    cache = pc.cache_create(cfg.num_layers, B * MB, bs, cfg.num_kv_heads,
                            cfg.resolved_head_dim, B, MB, torch.bfloat16,
                            device=dev)
    ids = torch.arange(B, device=dev)
    cache = pc.write_prefill(cache, ids, state.view_k[:, :, :, :P]
                             .transpose(2, 3), state.view_v[:, :, :, :P]
                             .transpose(2, 3))

    def last_logits(route, tok, ctx_state, positions=None):
        """What the step consumes at the last step, and its logits: the
        route's context through ``decode_step``, as the step computes it."""
        if route == "shortcut":
            ctx = M.LayerCache(k=ctx_state.view_k, v=ctx_state.view_v)
            inc = ctx_state.ctx_len + 1
        else:
            ctx = M.PagedContext(k_pool=ctx_state.k_pool,
                                 v_pool=ctx_state.v_pool,
                                 block_tables=ctx_state.block_tables[ids])
            inc = ctx_state.seq_lens[ids] + 1
        if positions is not None:
            positions = inc - 1 + positions
        return M.decode_step(params, cfg, tok, ctx, inc,
                             positions=positions)[0]

    routes = {}
    step_fns = {"shortcut": serve.make_serve_step(cfg),
                "paged": serve.make_paged_serve_step(cfg)}
    # the steps must not materialize a context: count gathers while they run
    gathers = {"n": 0}

    def spy(fn):
        def counted(*a, **k):
            gathers["n"] += 1
            return fn(*a, **k)
        return counted
    spied = [(pc, "gather_context"), (attn, "gather_paged")]
    originals = [getattr(mod, name) for mod, name in spied]
    for mod, name in spied:
        setattr(mod, name, spy(getattr(mod, name)))
    per_call = _decode.KERNELS_PER_CALL * cfg.num_layers
    for route, step in step_fns.items():
        st = state if route == "shortcut" else cache
        kernel = route + "_attention"
        tok, fed, secs, ev_ms = tok0, [tok0], [], []
        for i in range(steps):
            if i == steps - 1:
                routes[route + "_logits"] = last_logits(route, tok, st)
                if route == "shortcut":
                    routes["wrong_logits"] = last_logits(route, tok, st, 1)
            def run():
                if route == "shortcut":
                    return step(params, st, tok)
                return step(params, st, tok, ids)
            torch.cuda.synchronize()
            _build.reset_launches()
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            ev0.record()
            if i == 1:      # one step traced (left out of the timed mean)
                (tok, st), *res[route + "_trace"] = profiled(torch, run)
            else:
                tok, st = run()
            ev1.record()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            ev_ms.append(ev0.elapsed_time(ev1))
            got = _build.launches()
            assert got == {kernel: per_call}, \
                f"(h) {route} step {i}: launches {got}, expected " \
                f"{{{kernel!r}: {per_call}}}"
            fed.append(tok)
        assert torch.equal(
            tok, torch.argmax(routes[route + "_logits"], dim=-1).to(tok.dtype)
        ), f"(h) {route}: the step's token is not its logits' argmax"
        routes[route] = torch.stack(fed, dim=1)
        res[route + "_step_s"] = secs
        res[route + "_step_ev"] = ev_ms
        if route == "paged":
            cache = st
        del st
    for (mod, name), fn in zip(spied, originals):
        setattr(mod, name, fn)
    assert gathers["n"] == 0, \
        f"(h) the decode steps gathered a context {gathers['n']} times"
    res["decode_launches"] = per_call
    assert torch.equal(routes["shortcut"], routes["paged"]), \
        "(h) the routes decoded different tokens"
    assert torch.equal(routes["shortcut_logits"], routes["paged_logits"]), \
        "(h) the routes' last-step logits differ in bits"
    assert int(cache.seq_lens.min()) == P + steps
    res["route_logit_diff"] = float((routes["shortcut_logits"].float()
                                     - routes["paged_logits"].float())
                                    .abs().max())
    res["tokens"] = routes["shortcut"]
    torch.cuda.synchronize()
    res["peak_bytes"] = torch.cuda.max_memory_allocated()

    # decode against the full forward over prompt + the fed tokens
    del state, cache
    full = torch.cat([toks, routes["shortcut"][:, :steps].long()], dim=1)
    want, _ = M.prefill_forward(params, cfg, {"tokens": full})
    res["errors"] = {k: rel_rms(torch, routes[k + "_logits"], want)
                     for k in ("shortcut", "paged", "wrong")}
    res["want_rms"] = float(want.float().square().mean().sqrt())
    for k in ("shortcut", "paged"):
        if not res["errors"][k] <= LOGIT_LIMIT:
            raise AssertionError(
                f"(h) {k} decode logits off the full forward by "
                f"{res['errors'][k]} (relative RMS) > {LOGIT_LIMIT}")
    if not res["errors"]["wrong"] > LOGIT_LIMIT:
        raise AssertionError(
            f"(h) a decode with the rope position off by one is within the "
            f"limit: {res['errors']['wrong']} <= {LOGIT_LIMIT}")
    res["params"], res["cfg"] = params, cfg
    return res


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def measure_flash(torch, mres, timer) -> tuple:
    """The flash kernel at (h)'s prefill layer shape, on seeded bfloat16
    operands in the model layout: its time, the plain version's and
    ``scaled_dot_product_attention``'s (causal, GQA) on the same tensors,
    the largest difference from plain, and its bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import kernel_path
    cfg = mres["cfg"]
    B, S = MODEL_CONFIG["batch"], MODEL_CONFIG["prompt"]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    qm, km, vm = (torch.randn((B, S, n, hd), generator=gen, device=dev)
                  .to(torch.bfloat16) for n in (H, KV, KV))
    ms, got = timer(lambda: ops.mha_forward(qm, km, vm))
    q = qm.reshape(B, S, KV, H // KV, hd).permute(0, 2, 3, 1, 4)
    plain_ms, want = timer(lambda: ref.flash_attention_ref(
        q, km.transpose(1, 2), vm.transpose(1, 2)), reps=1, warmup=1)
    got = got.reshape(B, S, KV, H // KV, hd).permute(0, 2, 3, 1, 4)
    ratio, err = close(torch, got, want)
    lib_ms, lib = timer(lambda: F.scaled_dot_product_attention(
        qm.transpose(1, 2), km.transpose(1, 2), vm.transpose(1, 2),
        is_causal=True, enable_gqa=True))
    lib = lib.reshape(B, KV, H // KV, S, hd)
    lib_ratio, lib_err = err_ratio(torch, lib, want)
    flops = 4 * B * H * hd * S * (S + 1) // 2
    bytes_ = 2 * (qm.nbytes + km.nbytes)        # q, k, v read; out written
    bound = max(flops / PEAK_BF16, bytes_ / HBM_BYTES_PER_S) * 1e3
    log(f"(h) flash kernel ({kernel_path(qm.dtype, hd)}) at the prefill "
        f"layer shape (q {tuple(qm.shape)}, "
        f"k/v {tuple(km.shape)}, bfloat16): {ms:.4f} ms per layer call; "
        f"plain {plain_ms:.4f} ms; scaled_dot_product_attention(is_causal, "
        f"enable_gqa) {lib_ms:.4f} ms (|err| vs plain {lib_err:.3g}, / limit "
        f"{lib_ratio:.3g}); bound {bound:.4f} ms "
        f"({flops} flops at 989 TFLOP/s, {bytes_} B at 3.35 TB/s); kernel "
        f"|err| vs plain {err:.3g} (/ limit {ratio:.3g}); "
        f"{flops / ms / 1e9:.1f} TFLOP/s achieved, "
        f"{100 * bound / ms:.1f}% of the bound")
    return ("flash_attention", "src/repro/kernels/flash_attention.py:122",
            ms, plain_ms, bytes_, err, lib_ms, flops)


def measure_decode(torch, mres, timer) -> None:
    """The two decode kernels at (h)'s decode layer shape, on seeded
    bfloat16 operands: 8 sequences x 8 kv heads (G 4, hd 128) of
    prompt + steps/2 old tokens in an S_cap-2112 view and, for the paged
    kernel, the same rows in shuffled 16-token blocks, the self row folded
    in.  Logs each kernel's time, its plain version's, its bound and, for
    the shortcut kernel, ``scaled_dot_product_attention`` over the view with
    the self row written in (a copy); the routes bitwise equal; and both
    split lengths."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    cfg, c = mres["cfg"], MODEL_CONFIG
    B, s_cap, bs = c["batch"], c["s_cap"], c["block"]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    G, MB = H // KV, s_cap // bs
    n_old = c["prompt"] + c["steps"] // 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)
    q, kn, vn = randn(B, H, hd), randn(B, KV, hd), randn(B, KV, hd)
    vk, vv = randn(B, s_cap, KV, hd), randn(B, s_cap, KV, hd)
    lens = torch.full((B,), n_old, dtype=torch.int32, device=dev)
    timer = DeviceTimer(torch)
    tables = torch.randperm(B * MB, generator=gen, device=dev).reshape(
        B, MB).to(torch.int32)
    kp = torch.empty((B * MB, bs, KV, hd), dtype=torch.bfloat16, device=dev)
    vp = torch.empty_like(kp)
    kp[tables.long()] = vk.reshape(B, MB, bs, KV, hd)
    vp[tables.long()] = vv.reshape(B, MB, bs, KV, hd)
    qk = q.reshape(B, KV, G, hd)
    new = dict(k_new=kn, v_new=vn)
    ms_s, short = timer(lambda: ops.decode_shortcut(q, vk, vv, lens, **new))
    ms_p, paged = timer(lambda: ops.decode_paged(q, kp, vp, tables, lens,
                                                 **new))
    assert torch.equal(short, paged), "(h) decode layer: routes differ"
    plain_s, want = timer(lambda: ref.decode_attention_ref(
        qk, vk.transpose(1, 2), vv.transpose(1, 2), lens, **new).reshape(
            B, H, hd), reps=3, warmup=1)
    plain_p, want_p = timer(lambda: ref.paged_attention_ref(
        qk, kp.transpose(1, 2), vp.transpose(1, 2), tables, lens,
        **new).reshape(B, H, hd), reps=3, warmup=1)
    _, err_s = close(torch, short, want)
    _, err_p = close(torch, paged, want_p)
    lk, lv = vk.clone(), vv.clone()
    lk[:, n_old], lv[:, n_old] = kn, vn
    mask = (torch.arange(s_cap, device=dev) <= n_old)[None, None, None, :]
    lib_ms, lib = timer(lambda: F.scaled_dot_product_attention(
        q[:, :, None], lk.transpose(1, 2), lv.transpose(1, 2),
        attn_mask=mask, enable_gqa=True))
    lib_ratio, _ = err_ratio(torch, lib[:, :, 0], want)
    live = B * (n_old + 1)
    io = live * KV * hd * 2 * 2 + 2 * q.nbytes       # K, V rows; q and out
    nblk = B * -(-n_old // bs)
    launches = {k: mres["decode_launches"] * c["steps"]
                for k in ("shortcut_attention", "paged_attention")}
    log(f"(h) decode kernels at the decode layer shape (q {tuple(q.shape)}, "
        f"{n_old} old tokens + the self row per sequence, S_cap {s_cap}, "
        f"block {bs}; launches: the {c['steps']} decode steps): shortcut == "
        f"paged bit for bit; scaled_dot_product_attention |err| / limit "
        f"{lib_ratio:.3g}")
    _row("shortcut_attention", "", "", launches, ms_s, plain_s, io + 4 * B,
         err_s, library_ms=lib_ms, phase="h")
    _row("paged_attention", "", "", launches, ms_p, plain_p,
         io + 4 * nblk + 4 * B, err_p, phase="h")
    log("(h) decode layer shape, profiler: " + "; ".join((
        device_line("shortcut_attention", *device_ms(
            torch, lambda: ops.decode_shortcut(q, vk, vv, lens, **new))),
        device_line("paged_attention", *device_ms(
            torch, lambda: ops.decode_paged(q, kp, vp, tables, lens,
                                            **new))))))
    log("(h) decode layer shape, split kernel + combine at each split length "
        "(CUDA events, turns a b b a): " + split_line(split_times(
            torch, timer, qk, vk.transpose(1, 2), vv.transpose(1, 2),
            kp.transpose(1, 2), vp.transpose(1, 2), tables, lens, kn, vn)))


def median(xs) -> float:
    ys = sorted(xs)
    n = len(ys)
    return ys[n // 2] if n % 2 else (ys[n // 2 - 1] + ys[n // 2]) / 2


def traced(busy, n, attn, wall_ms) -> str:
    """A trace's device time against the untraced wall time of the same
    work (tracing itself costs seconds of host time), with the part in the
    decode-attention kernels."""
    if busy is None:
        return "no device events in the trace (device time not measured)"
    return (f"device busy {busy:.4f} ms ({attn:.4f} ms in the decode-"
            f"attention kernels, {busy - attn:.4f} ms in the rest), {n} "
            f"kernels and copies; {100 * (1 - busy / wall_ms):.1f}% idle "
            f"against the untraced {wall_ms:.4f} ms")


def report_model(mres, smi, kernels, row) -> None:
    """(h)'s report lines, and the flash row of the kernels line."""
    c = MODEL_CONFIG
    B, P = c["batch"], c["prompt"]
    pre = mres["prefill_s"][1]
    log(f"(h) prefill ({B} x {P} tokens, warm): {pre * 1e3:.4f} ms, "
        f"{B * P / pre:.1f} tokens/s (first call "
        f"{mres['prefill_s'][0] * 1e3:.4f} ms); flash launches "
        f"{mres['launches']['flash_attention'] // 3} per prefill; card {smi}")
    log("(h) third prefill traced: " + traced(*mres["prefill_trace"],
                                              pre * 1e3))
    for route in ("shortcut", "paged"):
        secs = mres[route + "_step_s"][2:]
        ev = mres[route + "_step_ev"][2:]
        mean = sum(secs) / len(secs)
        log(f"(h) decode, {route} route: {mean * 1e3:.4f} ms per step "
            f"(mean of steps 3-{c['steps']}, host clock + sync; median "
            f"{median(secs) * 1e3:.4f}, min {min(secs) * 1e3:.4f}, max "
            f"{max(secs) * 1e3:.4f}; CUDA events around the step: median "
            f"{median(ev):.4f}, min {min(ev):.4f}, max {max(ev):.4f}), "
            f"{B / mean:.1f} tokens/s; {mres['decode_launches']} "
            f"{route}_attention launches per step, no other kernel of the "
            f"port, no gathered context; step 2 traced: "
            + traced(*mres[route + "_trace"], mean * 1e3))
    e = mres["errors"]
    log(f"(h) tokens identical across routes ({B} x {c['steps'] + 1}); "
        f"last-step logits equal bit for bit (max difference "
        f"{mres['route_logit_diff']:.3g}); relative RMS off the full forward "
        f"(logit RMS {mres['want_rms']:.4f}): shortcut {e['shortcut']:.4g}, "
        f"paged {e['paged']:.4g}, limit {LOGIT_LIMIT}; rope position off by "
        f"one {e['wrong']:.4g}")
    log(f"(h) max_memory_allocated {mres['peak_bytes']} B over prefill and "
        f"decode")
    name, replaces, ms, plain_ms, bytes_, err, lib_ms, flops = row
    kernels.append(_row(name, "src/repro_torch/kernels/csrc/flash_attention.cu",
                        replaces, mres["launches"], ms, plain_ms, bytes_, err,
                        library_ms=lib_ms, phase="h", flops=flops))


# (i): Fig. 7's baselines (benchmarks/bench_fig7.py's settings at (d)'s
# keys): the open tables grow from 2^9 to 2^ceil(log2(n / 0.30)); CH has
# 2^(that - 4) chains of 16-slot (128-byte) buckets and 2^23 buckets (1 GiB,
# the paper's 1 GB CH table) where the bench's n // 8 drops keys
FIG7_INITIAL_LOG2 = 9
FIG7_CH_SLOTS = 16
FIG7_CH_CAPACITY = 1 << 23
FIG7_SOURCES = {
    "ht_insert": "src/repro/core/baselines.py:113",
    "hti_insert": "src/repro/core/baselines.py:219",
    "ch_insert": "src/repro/core/baselines.py:323"}
# (i): besides the last batch, the batch each table's kernel is held to its
# plain loop on, one whose grid passes sweep more items than the kernel's
# grid has threads (the grid the launcher reports, as many blocks as fit on
# the card at once), so its grid-stride loops go round more than once: HT's
# batch 1 doubles 13 times, 2^9 to 2^22 slots; HTI's batch 3 starts a
# migration from 2^23 slots and drains it; CH's batch 1 (every chain empty,
# every key opens a bucket) places its keys.
FIG7_CHECK = {"HT": 1, "HTI": 3, "CH": 1}
# (i): the insert kernel rows' calls, each on a fresh copy of the state; the
# row is the first, the others are logged beside it
FIG7_KERNEL_CALLS = 3


def open_probed(torch, table_keys, log2: int, q) -> int:
    """Slots the probes of keys ``q`` (int32 bits) read in an open table of
    ``2**log2`` slots: up to the key's slot, or the whole window."""
    from repro_torch.core import hashing
    pos = hashing.window_positions(hashing.hash_dir(q), log2, 32)
    found, j = hashing.probe_hit(hashing.bits(table_keys)[pos], q)
    return int(torch.where(found, j + 1, 32).sum())


def baseline_bytes(torch, name, before, after, keys) -> int:
    """Bytes the batch insert of ``keys`` must move to turn ``before`` into
    ``after``.  Per key: its key and value read, and for the open tables
    the slots its probe reads (from ``after``: with no deletes, the slots
    before a key's own were taken when it was placed) and its 8-byte slot
    write; for CH the head and the tail's count read, the slot written and
    the count written.  HT's doubling: the old table read and the doubled
    one written; HTI's migration: the old slots scanned, each moved entry's
    slot written and its old key cleared, a migration start's copy and
    clear; CH's new bucket: its link and count."""
    n = keys.numel()
    if name == "ch_insert":
        new = int(after.num_buckets) - int(before.num_buckets)
        return 28 * n + 8 * new
    if name == "ht_insert":
        L0, L1 = int(before.size_log2), int(after.size_log2)
        grow = sum(8 * (1 << L) + 16 * (1 << L) for L in range(L0, L1))
        return 16 * n + 4 * open_probed(torch, after.keys, L1, keys) + grow
    L1 = int(after.new_log2)
    moved = 0
    if int(after.old_log2) == int(before.old_log2):
        scanned = int(after.migrate_ptr) - int(before.migrate_ptr)
        moved = 8 * scanned + 12 * (int(before.old_count)
                                    - int(after.old_count))
    else:
        moved = 16 * (1 << int(after.old_log2))
    return 16 * n + 4 * open_probed(torch, after.new_keys, L1, keys) + moved


def ch_pass_line(p) -> str:
    """CH's kernel statistics (``baselines_insert.CH_FIELDS``) as a line."""
    return (f"launches {p['launches']}; radix passes {p['radix_passes']}; "
            f"chain groups {p['groups']} (largest {p['largest_group']} "
            f"keys); longest walk {p['longest_walk']} links; buckets "
            f"opened {p['opened']}; grid {p['grid_threads']} threads")


def state_err(torch, a, b) -> int:
    """Largest difference of two states' arrays (bit views as int64)."""
    from repro_torch.core import hashing

    def as64(t):
        return hashing.storage_view(t.cpu()).to(torch.int64)

    return max(int((as64(x) - as64(y)).abs().max()) if x.numel() else 0
               for x, y in zip(a, b))


def phase_fig7(torch, np, args, timer, smi) -> tuple:
    """(i): HT, HTI and CH take (d)'s keys in 16 batches through the
    users' entry points; returns the per-table results and the three
    kernel rows (launches from this phase)."""
    from repro_torch.core import baselines as bl
    from repro_torch.core import hashing
    from repro_torch.kernels import _build
    from repro_torch.kernels import baselines_insert as kern
    dev = torch.device("cuda")
    n = 1 << args.log2_keys
    n_absent = 1 << 20
    keys_np, vals_np, absent_np = make_keys(n, n_absent, args.seed)
    keys = torch.from_numpy(keys_np.view(np.int32)).to(dev)
    vals = torch.from_numpy(vals_np.view(np.int32)).to(dev)
    probe = torch.cat([keys, torch.from_numpy(absent_np.view(np.int32)).to(
        dev)])
    max_log2 = int(np.ceil(np.log2(n / 0.30)))
    batch = n // 16

    def live_open(*tables):
        return int(sum((hashing.bits(t) != -1).sum() for t in tables))

    # name, kernel, create, insert, lookup, the kernel alone, live entries
    # (slots that hold a key), the entries the state's own counts say it
    # holds, and the items a batch's grid passes sweep (HT: its largest
    # doubling's old slots; HTI: those of a migration it started, which it
    # also drains here; CH: the batch's keys)
    tables = [
        ("HT", "ht_insert",
         lambda: bl.ht_create(max_log2, FIG7_INITIAL_LOG2, device=dev),
         bl.ht_insert_many, bl.ht_lookup_many,
         lambda st, k, v: kern.ht_insert_(st, k, v, 0.35),
         lambda st: live_open(st.keys),
         lambda st: int(st.count),
         lambda a, b: ((1 << (int(b.size_log2) - 1))
                       if int(b.size_log2) > int(a.size_log2) else 0)),
        ("HTI", "hti_insert",
         lambda: bl.hti_create(max_log2, FIG7_INITIAL_LOG2, device=dev),
         bl.hti_insert_many, bl.hti_lookup_many,
         lambda st, k, v: kern.hti_insert_(st, k, v, 0.35, 64),
         lambda st: live_open(st.new_keys, st.old_keys),
         lambda st: int(st.new_count) + int(st.old_count),
         lambda a, b: ((1 << int(b.old_log2))
                       if int(b.old_log2) > int(a.old_log2) else 0)),
        ("CH", "ch_insert",
         lambda: bl.ch_create(max_log2 - 4, FIG7_CH_CAPACITY, FIG7_CH_SLOTS,
                              device=dev),
         bl.ch_insert_many, bl.ch_lookup_many,
         lambda st, k, v: kern.ch_insert_(st, k, v),
         lambda st: int(st.counts.sum()),
         lambda st: n - int(st.dropped),
         lambda a, b: batch),
    ]

    def hold(insert, before, after, kb, vb) -> tuple:
        """The plain loop on a CPU copy of ``before`` and the batch: the
        largest difference from the card's ``after`` on any array, and the
        loop's ms."""
        host = type(before)(*(a.cpu() for a in before))
        t0 = time.perf_counter()
        host = insert(host, kb.cpu(), vb.cpu())
        return state_err(torch, after, host), (time.perf_counter() - t0) * 1e3

    def pass_line(p) -> str:
        if "radix_passes" in p:
            return ch_pass_line(p)
        return (f"launches {p['launches']}; segments {p['segments']} (a "
                f"records pass, a map pass and a write pass each); prefix "
                f"counts {p['count_passes']}; claim rounds {p['rounds']} (a "
                f"claim and a check pass each; most in one segment "
                f"{p['most_rounds']}); events {p['events']}; grid "
                f"{p['grid_threads']} threads")

    results, rows = {}, []
    for (name, kname, create, insert, lookup, kernel, live_of, count_of,
         grid_work) in tables:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        kern.reset_passes()
        st = create()
        batch_s, batch_ms, held = [], [], []
        for b, i in enumerate(range(0, n, batch), 1):
            prev = st
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            st = insert(prev, keys[i:i + batch], vals[i:i + batch])
            end.record()
            torch.cuda.synchronize()
            batch_s.append(time.perf_counter() - t0)
            batch_ms.append(start.elapsed_time(end))
            if b == FIG7_CHECK.get(name):
                swept = grid_work(prev, st)
                grid = kern.passes()[kname]["grid_threads"]
                assert swept > grid > 0, \
                    f"(i) {name} batch {b} sweeps {swept} items, grid {grid}"
                e, h_ms = hold(insert, prev, st, keys[i:i + batch],
                               vals[i:i + batch])
                held.append(e)
                log(f"(i) {name} batch {b} (grid passes over {swept} items) "
                    f"against the plain loop on the state before it: max "
                    f"|err| {e} over every array ({h_ms:.1f} ms on the host)")
            if i == n - batch:
                before_last = prev
            del prev
        launches = _build.launches()
        assert launches.get(kname, 0) >= 16, \
            f"(i) {kname} launched {launches} times"
        if kname in kern.passes():
            log(f"(i) {kname} over the 16 batches: "
                f"{pass_line(kern.passes()[kname])}")
        scalars = {f: getattr(st, f).item() for f in type(st)._fields
                   if getattr(st, f).dim() == 0}
        log(f"(i) {name}: inserted {n} keys in 16 batches: "
            f"{sum(batch_s):.6f} s; {scalars}; launches {launches}")
        log(f"(i) {name} insert seconds per batch (host clock + sync): "
            f"{[round(x, 6) for x in batch_s]}")
        big = int(np.argmax(batch_ms))
        log(f"(i) {name} insert ms per batch (CUDA events around the call, "
            f"the state copy included): last {batch_ms[-1]:.4f}, largest "
            f"{batch_ms[big]:.4f} (batch {big + 1})")
        if name == "CH":
            assert int(st.dropped) == 0, "(i) CH dropped keys"

        # lookups: every present key not lost returns its value, every
        # absent key MISS, and a sample equals the lookup on a CPU copy
        ms, got = timer(lambda: lookup(st, probe))
        gi = got.view(torch.int32)
        present = gi[:n]
        miss = int((present == -1).sum())
        wrong = int(((present != vals) & (present != -1)).sum())
        assert wrong == 0, f"(i) {name}: {wrong} keys with a wrong value"
        assert bool((gi[n:] == -1).all()), f"(i) {name}: absent keys found"
        live = live_of(st)
        assert live == count_of(st), \
            f"(i) {name}: {live} entries stored, its counts say {count_of(st)}"
        assert miss == n - live, \
            f"(i) {name}: {miss} present keys MISS, {n - live} not stored"
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed)
        idx = torch.randint(0, probe.numel(), (1 << 16,), device=dev,
                            generator=gen)
        host_st = type(st)(*(a.cpu() for a in st))
        plain = lookup(host_st, probe[idx].cpu())
        assert equal_bits(gi[idx].cpu(), hashing.bits(plain)), \
            f"(i) {name}: card lookups differ from the CPU's"
        peak = torch.cuda.max_memory_allocated()
        resident = sum(a.nbytes for a in st)
        ns = ms * 1e6 / probe.numel()
        log(f"(i) {name} lookup (plain PyTorch) {ns:.4f} ns/lookup "
            f"({probe.numel()} lookups, {n_absent} absent; {ms:.4f} ms); "
            f"present keys MISS {miss} (not stored: dropped "
            f"{int(st.dropped)}); stored entries == the state's counts; "
            f"2^16 sampled lookups == the CPU's; state {resident} B "
            f"resident; max_memory_allocated {peak} B over the table's run "
            f"(the state, its copy-on-write clone, the doubling's work "
            f"space, keys, probes, lookup chunks); card {smi}")
        del got, gi, present, plain, host_st

        # the kernel row: the last batch again on the state before it, one
        # call on a fresh copy; FIG7_KERNEL_CALLS - 1 more calls, each on a
        # fresh copy, are logged beside it with the cudaMalloc segments and
        # allocation retries of PyTorch's caching allocator in each call
        kb, vb = keys[n - batch:], vals[n - batch:]
        call_ms, mallocs = [], []
        for c in range(FIG7_KERNEL_CALLS):
            if c:
                del work
            work = type(before_last)(*(hashing.clone(a) for a in before_last))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            kern.reset_passes()
            torch.cuda.synchronize()
            m0 = torch.cuda.memory_stats()
            start.record()
            kernel(work, kb, vb)
            end.record()
            end.synchronize()
            m1 = torch.cuda.memory_stats()
            call_ms.append(start.elapsed_time(end))
            mallocs.append(tuple(m1.get(k, 0) - m0.get(k, 0) for k in (
                "segment.all.allocated", "num_alloc_retries")))
            if not c:
                first = kern.passes().get(kname)
        k_ms = call_ms[0]
        if first is not None:
            log(f"(i) {kname} batch 16 alone: {pass_line(first)}")
        log(f"(i) {name} kernel row: {k_ms:.4f} ms, one call; all "
            f"{FIG7_KERNEL_CALLS} calls {[round(x, 4) for x in call_ms]} ms "
            f"(mean {sum(call_ms) / len(call_ms):.4f}); cudaMalloc segments "
            f"and allocation retries per call {mallocs}")
        e, plain_ms = hold(insert, before_last, work, kb, vb)
        log(f"(i) {name} batch 16 again (the kernel alone, its last call) "
            f"against the plain loop: max |err| {e} over every array")
        held.append(e)
        rows.append(_row(kname,
                         "src/repro_torch/kernels/csrc/baselines_insert.cu",
                         FIG7_SOURCES[kname], launches, k_ms, plain_ms,
                         baseline_bytes(torch, kname, before_last, work, kb),
                         max(held), phase="i"))
        results[name] = dict(insert_s=sum(batch_s), batch_s=batch_s,
                             last_ms=batch_ms[-1], big_ms=batch_ms[big],
                             big=big + 1, ns=ns, peak=peak, resident=resident,
                             dropped=int(st.dropped), miss=miss)
        del st, before_last, work
    bad = [r["name"] for r in rows if r["max_abs_err"] != 0]
    assert not bad, f"(i) kernels differ from their plain loops: {bad}"
    return results, rows


def report_fig7(res, eh, smi) -> None:
    """(i): Fig. 7's five rows on one card: 7a insert seconds (the per-batch
    staircase), 7b ns/lookup; EH and Shortcut-EH from (d)/(e)."""
    log(f"(i) Fig. 7 on {smi} ({eh['n_keys']} keys in 16 batches; lookups of "
        f"them and {eh['n_absent']} absent keys; the baselines' lookups are "
        f"plain PyTorch, EH's and Shortcut-EH's the CUDA kernels):")
    for name, r in res.items():
        log(f"(i)   {name:12s} insert {r['insert_s']:.6f} s, per batch "
            f"{[round(x, 4) for x in r['batch_s']]}; lookup "
            f"{r['ns']:.4f} ns/lookup; state {r['resident']} B resident, "
            f"peak {r['peak']} B over its run; dropped {r['dropped']}")
    log(f"(i)   {'EH':12s} insert {eh['insert_s']:.6f} s (ShortcutEH.insert: "
        f"the EH insert and the replay queue), per batch "
        f"{[round(x, 4) for x in eh['batch_s']]}; lookup "
        f"{eh['trad_ns']:.4f} ns/lookup (traditional route); state "
        f"{eh['resident']} B resident, peak {eh['peak']} B (the whole of "
        f"(d))")
    log(f"(i)   {'Shortcut-EH':12s} the same inserts, then pump() "
        f"{eh['maint_s']:.6f} s; lookup {eh['sc_ns']:.4f} ns/lookup "
        f"(shortcut route)")


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
    clock = PhaseClock()
    timer = Timer(torch)
    smi = phase_device(torch)
    clock.lap("a")
    phase_build(_build)
    clock.lap("b")
    phase_kernels(torch, np, args.seed)
    phase_attention(torch, np, args.seed)
    phase_flash(torch, args.seed)
    clock.lap("c")
    res = phase_main(torch, np, args, timer)
    clock.lap("d")
    n = res["n_keys"] + res["n_absent"]
    log(f"(e) insert {res['insert_s']:.6f} s for {res['n_keys']} keys; "
        f"maintenance {res['maint_s']:.6f} s; lookup traditional "
        f"{res['trad_ms'] * 1e6 / n:.4f} ns/lookup, shortcut "
        f"{res['sc_ms'] * 1e6 / n:.4f} ns/lookup ({n} lookups, "
        f"{res['n_absent']} absent); max_memory_allocated "
        f"{res['peak_bytes']} B; card {smi}")
    kernels = measure_kernels(torch, np, res, timer)
    eh7 = dict(n_keys=res["n_keys"], n_absent=res["n_absent"],
               insert_s=res["insert_s"], batch_s=res["batch_s"],
               trad_ns=res["trad_ms"] * 1e6 / n, sc_ns=res["sc_ms"] * 1e6 / n,
               maint_s=res["maint_s"], peak=res["peak_bytes"],
               resident=res["resident"])
    res["sc"].close()
    data = {k: res[k] for k in ("keys", "vals", "probe", "want", "extra")}
    del res                      # drop the flat index: (f) has its own peak
    gc.collect()
    torch.cuda.empty_cache()
    clock.lap("e")

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
    del sres, data               # drop the sharded index: (g) has its own peak
    gc.collect()
    torch.cuda.empty_cache()
    clock.lap("f")

    report_kv(phase_kv(torch, np, args, timer), smi, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    clock.lap("g")

    mres = phase_model(torch, args, timer)
    report_model(mres, smi, kernels, measure_flash(torch, mres, timer))
    measure_decode(torch, mres, timer)
    del mres
    gc.collect()
    torch.cuda.empty_cache()
    clock.lap("h")

    fig7, rows = phase_fig7(torch, np, args, timer, smi)
    kernels.extend(rows)
    report_fig7(fig7, eh7, smi)
    clock.lap("i")
    log(f"(e) total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
