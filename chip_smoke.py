#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--log2-keys 24]

Phases, each of which raises on failure (exit code 1):

  (a) device: the card's name, and its name and power limit as
      ``nvidia-smi --query-gpu=name,power.limit`` reports them;
  (b) build: every CUDA source of the port with ``nvcc`` (all at once),
      and each kernel's registers, spills and shared memory from ptxas;
      beside them four wrong lookup kernels for (c) (``LOOKUP_WRONG``);
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
      (three radix passes), and 2^16 keys into each table, the three
      baseline lookup kernels held to their plain versions after every
      batch of those traces; the baseline lookups on states that reach
      their edges (``lookup_edge_states``: HT at 2^4 slots all taken, so a
      miss wraps the window over the table twice, at 2^0, a crowded table's
      full windows, keys behind an EMPTY slot, probes that run from a
      sector's last slot into the next, hits at home + 8, 2^2 and 2^3
      slots with keys past 2^L in the arrays, probe counts off the 256-key
      block and a single probe; HTI mid-migration with the
      old and with the new table first, a key in both, migrated slots'
      values left behind, drained; CH chains of several buckets, heads -1,
      duplicate appends, values equal to MISS, 5- and 6-slot rows, 16-slot
      rows with hits in every 16-byte quarter, 20-slot rows (two chunks),
      capacity out; the keys 0, 0xFFFFFFFE and 0xFFFFFFFF among the
      probes), bit for bit, each beside wrong kernels that must differ (a
      probe past the first EMPTY, the new table always first, a walk that
      stops after the head bucket, a value from the wrong 16-byte quarter
      of its row); the four lookup entry points (traditional, shortcut,
      stacked, routed) at S = 4, 8, 16 and 512 (the probe's scalar path at 4 and
      8), on indexes whose capacity ran out, absent keys and the EMPTY
      pattern among the probes; within 2e-5 (1 + |want|) in float32 and 2^-7 |want| + 2^-8 max |want| in
      bfloat16 (one bfloat16 step of the element, half a step of the
      largest), the shortcut and
      paged decode attention at qwen3_4b's and gemma2_27b's KV widths
      (softcap 50, window 4096 over an 8192 context, on both routes), at
      G = 3, hd 64 and at the split kernel's edges (contexts of SPLIT - 1,
      SPLIT, SPLIT + 1 and S_cap), at (j)'s decode layers (hymba_1_5b:
      G 5, hd 64, window 1024 and a global layer; qwen2_moe_a2_7b: 16 KV
      heads, G 1, hd 128; paligemma_3b: 1 KV head, G 8, hd 256, 8
      sequences; S_cap 2112) and at (m1)'s decode layer (4 sequences,
      S_cap 2088): contexts off the tile, 0 and
      S_cap, a -1 table entry and an all -1 row, strided (as
      ``ops.decode_*`` pass them) and contiguous inputs, the self row
      (the current token's K/V) folded in, and the shortcut route bitwise
      equal to the paged route over the same rows in shuffled blocks; at
      each shape the plain
      versions of wrong kernels (the last token dropped, a 64-token chunk
      skipped, the window edge moved by one, the self row left out) are
      shown to go past that limit; the flash kernel in float32 and bfloat16
      at tests/test_kernels.py's shapes (causal sweep, windows 16, 33 and
      100, softcap 20, q shorter than the keys, ragged tails) and head_dim
      256, contiguous and in the model layout through ``ops.mha_forward``,
      then in bfloat16 at qwen3_4b's prefill layer shape (8 x 2048 tokens),
      at gemma2_27b's widths (window 4096, softcap 50, 8192 tokens), at
      hymba_1_5b's (G 5, hd 64, window 1024 over 1500 tokens, and its
      global layers), at musicgen_medium's (G 1, hd 64, 1000 tokens) and at
      qwen2_moe_a2_7b's prefill layer (16 heads, G 1, hd 128, 8 x 2048
      tokens), in float32 at (m1)'s prefill layer (qwen3_4b, 4 x 2048
      tokens), then with PaliGemma's bidirectional prefix in float32 and
      bfloat16 (1 KV head, G 16 with its padding, hd 256: prefixes of 1, 7,
      64 and 100 over 96 and 300 positions, with a window of 16 and a
      softcap of 20) and at its prefill layer (bfloat16, 8 x 2048
      positions, prefix 256), each beside the plain
      versions of wrong kernels (the diagonal token dropped, q_offset off
      by one, the window edge moved by one; with a prefix also the prefix
      dropped, the prefix keys past the causal tile range skipped and the
      prefix's window term left out, where each differs from the sound
      mask at that shape); each flash line names the
      kernel that ran: ``tensor-core`` (bfloat16 at hd 64, 128, 256),
      ``3xtf32`` (float32 at hd 64, 128, 256) or ``simt`` (hd 16 and 32);
      each float32 check also holds one TF32 pass (the plain version with
      q, k, v and p rounded to TF32) past the limit; then the float32
      kernel is timed at (m1)'s prefill layer beside the plain version,
      float32 ``scaled_dot_product_attention`` and its 3xTF32 bound (the
      ``flash_attention_f32`` row of the kernels line, with (m1)'s
      launches);
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
      0 and 1 only, each a flat-key launch (the keys in input order, each
      finding its shard in the kernel); the three flat-key arms bit for
      bit against the padded kernels plus the scatter-back, and with each
      key's shard from one bit too few, wrong; per-shard ``lookup`` takes
      the stacked kernel; then an
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
      insert seconds per batch (7a's resize staircases) with each batch's
      host time before the launch, in it and in the sync after it and the
      allocator's new segments, allocation retries and peak growth, the
      insert call's time on the last and the largest batch, ns/lookup of
      (d)'s probes through the lookup kernels (5 launches a table,
      asserted: every key not lost returns its value, every absent key
      MISS, and 2^16 sampled lookups equal those on a CPU copy) beside the
      plain version's on the card on the same state (equal bit for bit),
      each lookup's byte bound beside its sector floor (the random 64-byte
      fetches its probes must touch at the card's measured random-read
      rate; the hits in each of HTI's tables),
      peak memory per table, each insert kernel's time on the last batch
      (one call on a copy of the state before it; two more calls are
      logged beside it) against its plain loop on the same state (HT's
      and HTI's one cooperative launch a batch, with its passes: segments,
      prefix counts, claim rounds and the most in one segment, events, the
      grid; CH's, with its radix passes, chain groups and the largest,
      buckets opened, the grid), and HT's batch 1, HTI's batch 3 and CH's
      batch 1 held to the plain loop too; and
      Fig. 7's five rows, EH and Shortcut-EH from (d) and (e);
  (j) the MoE, SSM and hybrid families at full width and depth in
      bfloat16, weights drawn from --seed on the card, each served as (h)
      serves qwen3_4b (8 prompts of 2048 seeded tokens, 32 greedy steps,
      S_cap 2112): qwen2_moe_a2_7b (24 layers, 60 experts top-4 x 1408 and
      4 shared, 14.3 B parameters) on the shortcut and paged routes,
      hymba_1_5b (32 layers, attention G 5 x 64 with a 1024 window but
      layers 0, 15 and 31, and an SSM in parallel) and mamba2_370m (48 SSM
      layers, no attention) on the shortcut route.  Checks: flash launches
      per prefill and decode-kernel launches per step 24 / 48, 32 / 64 and
      0 / 0 and no other kernel of the port; qwen2_moe's routes give
      identical tokens and last-step logits equal bit for bit.  Then a
      float32 run of the same path (weights drawn from --seed in float32;
      qwen2_moe on 2 prompts) holds its last-step decode logits within
      each model's ``family_limit`` (relative RMS) of a float32 full
      forward over prompt + fed tokens, and wrong decodes past it (the
      rope position off by one; a zeroed SSM state; the MoE's top-k
      weights left un-renormalized): in bfloat16 these random-weight
      models move their logits under one rounding about as much as under
      a wrong decode (logged).  qwen2_moe is served at its published
      capacity factor 1.25, whose full forward at 2080 tokens can drop
      pairs, so its checks run at capacity factor E / top_k (no pair
      drops), the full forward taking the experts the prefill and the
      steps chose; the run prints the pairs the served prefill dropped and
      the top-k choices that differ between the decode steps and the full
      forward (float32, and bfloat16 ties in an untimed bfloat16 run at
      that capacity).  Reports per
      model prefill ms and tokens/s, decode ms per step per route (host
      clock and CUDA events), one profiler trace of a prefill and of a step
      (device busy, idle share, the MoE or SSM span's share), peak memory,
      and the flash and decode kernels at the model's layer shapes;
      paligemma_3b (18 layers, d 2048, 8 heads over 1 KV head x 256
      padded to 16 q-groups, gelu MLP 16384, vocab 257216, tied
      embedding) is served the same way on both routes, each prompt 256
      seeded patch embeddings and 1792 tokens (18 flash launches a
      prefill, 36 decode launches a step); its float32 run also holds the
      prefill's logits to a forward whose attention is the plain version
      with the prefix, and shows that forward with the prefix dropped past
      the same limit;
  (k) the port's example twins (``examples/quickstart_torch.py``,
      ``mixed_workload_torch.py``, ``serve_paged_torch.py``) at their own
      defaults on the card, each held to the kernels it must launch; the
      serving twin must print "outputs identical across paths"; the
      training twin (``train_small_torch.py``: qwen3_100m, 300 float32
      steps of 8 x 256 tokens, a checkpoint every 100) into a fresh
      directory: its last logged loss below its first, no kernel of the
      port launched, and a second call that resumes from step 300;
  (l) training on the card, which launches no kernel of the port (the
      model attends through ``attention.loop_attention`` under autograd):
      (l1) qwen3_4b at full width and depth in bfloat16 (4.02 B parameters
      drawn from --seed on the card, float32 AdamW moments), 8 steps of
      ``make_train_step`` on ``SyntheticLM`` batches of 4 x 2048 tokens
      with remat and ``wsd_schedule(3e-4, 2 warmup steps, 8 steps)``:
      ms per step (median of steps 3-8, host clock and CUDA events),
      tokens/s, model TFLOP/s against 989 (6 N T plus the loop's attention,
      the recompute not counted), peak memory against its reckoning, and
      one profiler trace of a further step split into forward, backward
      (with the recompute), optimizer and the attention loop's share, with
      the idle share; checks: every loss and gradient norm finite, step 0's
      loss bit for bit a ``torch.no_grad()`` ``train_forward``'s, every
      parameter changed, no kernel launched.  (l2) one step with
      grad_accum 2 and clipping engaged, in float32, on the card against
      the CPU at the reduced qwen3_4b, hymba_1_5b and paligemma_3b: the
      loss within 1e-5 relative, each gradient leaf and updated parameter
      within a relative RMS of 2^-8, and wrong steps past those limits (the
      prefix's positions kept in paligemma's loss, the causal mask off by
      one); one qwen2_moe_a2_7b MoE layer at full width (float32, 2 x 2048
      tokens, capacity factor 1.25 and 1.0): the gradients through the
      three ``autograd.Function`` gathers within 1e-5 of autograd's through
      the plain gathers, and two wrong backward passes past it.  (l3)
      qwen3_100m in bfloat16, 8 x 256 tokens, grad_accum 2: 6 steps
      straight against 3, a checkpoint, a restore into fresh tensors and 3
      more, every parameter and moment bit for bit;
  (m) the launch tools: (m1) the serve CLI (``repro_torch.launch.serve``,
      float32 weights drawn from --seed) in-process at qwen3_4b's full
      width and depth, 4 prompts of 2048 tokens and 32 greedy tokens, on
      the shortcut and then the paged route: its four lines (prefill and
      decode ms and tokens/s, the sample tokens), the flash kernel
      launched once a layer and the route's decode kernels in every step,
      and the two routes' sample tokens equal (both routes share the
      prefill, so (c) holds the float32 kernels to their plain versions at
      (m1)'s shapes); (m2) the one-card dry run
      (``repro_torch.launch.dryrun.main``) on the meta device: in this
      process the paged path's decode cells of every assigned arch and
      qwen3_4b's prefill (no kernel launched, the card's allocated and
      peak memory unchanged), then every arch at every shape on the
      shortcut path in child processes that cannot see the card; every
      cell ``ok`` or ``SKIP`` as ``cell_status`` says, one line a cell
      (flops, bytes, memory, the roofline terms, ``fits``); (m3)
      ``launch.op_cost.analyze`` of the reduced qwen3_4b prefill and train
      step run for real in bfloat16 against the same steps on the meta
      device, flops and bytes equal (the kernels' recorded costs
      included), and the dry run's qwen3_4b decode memory term at (h)'s
      shape and train-step memory at (l1)'s shape logged beside (h)'s
      device-busy step and (l1)'s peak.

Each phase's wall seconds go on a line of their own.  The flat index is
dropped before (f), the sharded one before (g), the KV layer before (h),
each table of (i) before the next and each model of (j) before the next,
so each path reports its own peak memory; (l) frees each of its parts
before the next.  The last three lines of
standard output are the ``{"kernels": [...]}`` JSON (nineteen kernels), the
``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.  Without CUDA,
or without ``src/repro_torch`` beside it, it exits non-zero and prints no
result.
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
PEAK_TF32 = 494.7e12             # ... dense TF32 tensor cores (same)
PEAK_F32 = 67e12                 # ... float32 on the CUDA cores (same)
# random reads of the memory, at most 34.18 G/s, each fetching 64 bytes (the
# L2's fetch granularity): tools/random_sector_peak.py on an NVIDIA H100
# 80GB HBM3 at 700 W (PERF.md §6); the baseline lookups' sector floor
RANDOM_READS_PER_S = 34.18e9
FETCH_BYTES = 64
# a float32 flash flop is three TF32 products on the tensor cores (3xTF32)
PEAK_F32_FLASH = PEAK_TF32 / 3
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


# (c): wrong lookup kernels that must fail on the edge states
# (``lookup_edge_states``): the sound source of ``baselines_lookup.cu`` with
# one line replaced, built beside the port's library and never into it; each
# name -> (the table whose states it is checked on, the line, its
# replacement, what the wrong kernel does).
LOOKUP_WRONG = {
    "ht": ("ht", "if (k == repro::kEmpty) return repro::kMiss;", "",
           "a probe that does not stop at the first EMPTY"),
    "hti": ("hti", "TWO_TABLES && __ldg(a.count[0]) < __ldg(a.count[1]);",
            "false;", "the new table always probed first"),
    "ch": ("ch", "cur = __ldcs(a.next + cur);", "cur = -1;",
           "a walk that stops after the head bucket"),
    "ch_quarter": ("ch", "return __ldcs(a.bv + row + c + j);",
                   "return __ldcs(a.bv + row + c + (j ^ 4));",
                   "a hit's value taken from the next 16-byte quarter of its "
                   "row"),
}


def wrong_lookup_source(name: str, source: str) -> str:
    """``baselines_lookup.cu``'s ``source`` with ``LOOKUP_WRONG[name]``'s
    line replaced."""
    _, old, new, _ = LOOKUP_WRONG[name]
    assert source.count(old) == 1, f"the wrong {name} lookup's line moved"
    return source.replace(old, new)


def start_wrong_lookups(_build) -> dict:
    """One ``nvcc`` per wrong lookup kernel, started at once; returns
    ``{name: (process, library path)}``."""
    out = _build.BUILD_DIR / "wrong_lookup"
    out.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "baselines_lookup.cu").read_text()
    started = {}
    for name in LOOKUP_WRONG:
        src, lib = out / f"{name}.cu", out / f"lib{name}.so"
        src.write_text(wrong_lookup_source(name, source))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(lib), str(src)]
        started[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), lib)
    return started


def phase_build(_build) -> dict:
    """(b); returns the wrong lookup kernels' libraries, by name."""
    t0 = time.perf_counter()
    wrong = start_wrong_lookups(_build)
    try:
        report = _build.build()
    except BaseException:
        for proc, _ in wrong.values():
            proc.kill()
            proc.wait()
        raise
    for name, (secs, out) in sorted(report.items()):
        log(f"(b) built {name}.cu in {secs:.1f} s")
        for line in ptxas_summary(out):
            log(f"(b)   {line}")
    libs = {}
    for name, (proc, lib) in wrong.items():
        out, _ = proc.communicate()
        assert proc.returncode == 0, f"(b) wrong {name} lookup:\n{out}"
        libs[name] = lib
    log(f"(b) build wall time {time.perf_counter() - t0:.1f} s "
        f"({len(report)} sources compiled, and {len(libs)} wrong lookup "
        f"kernels for (c))")
    import torch
    from repro_torch.kernels.flash_attention import TC_HEAD_DIMS, tc_smem_bytes
    for kernel, dtype in (("flash_tc_kernel", torch.bfloat16),
                          ("flash_tf32x3_kernel", torch.float32)):
        log(f"(b) {kernel} dynamic shared memory per CTA: " + ", ".join(
            f"hd {hd} {tc_smem_bytes(hd, dtype)} B" for hd in TC_HEAD_DIMS))
    return libs


def equal_bits(a, b) -> bool:
    from repro_torch.core import hashing
    return a.shape == b.shape and bool(
        (hashing.storage_view(a) == hashing.storage_view(b)).all())


def phase_kernels(torch, np, seed: int, wrong_lookups: dict) -> None:
    """(c): every kernel against its plain version on the same inputs;
    ``wrong_lookups``: the wrong lookup kernels' libraries (``phase_build``)."""
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
    baseline_lookups(torch, np, seed, wrong_lookups)
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

    lookups = {bl.HTState: (bl.ht_lookup_many, bl.ht_lookup_plain),
               bl.HTIState: (bl.hti_lookup_many, bl.hti_lookup_plain),
               bl.CHState: (bl.ch_lookup_many, bl.ch_lookup_plain)}
    absent = keys_of(256, 399)

    def run(label, create, insert, batches, check=None):
        cu, host = create(dev), create("cpu")
        lookup, plain = lookups[type(cu)]
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
            q = torch.from_numpy(np.concatenate([kb, absent, edge]).view(
                np.int32)).to(dev)
            assert equal_bits(lookup(cu, q), plain(cu, q)), \
                f"(c) {label}: the lookup kernel differs after batch " \
                f"{len(seen) + 1}"
            seen.append(host)
        if check is not None:
            assert check(seen), f"(c) {label}: the trace missed its case"
        scalars = {f: getattr(host, f).item() for f in type(host)._fields
                   if getattr(host, f).dim() == 0}
        passes = kern.passes().get("ch_insert")
        log(f"(c) {label}: kernel == plain, {len(type(host)._fields)} "
            f"arrays x {len(batches)} batches, and the lookup kernel == "
            f"plain after each (the batch, 256 absent keys, the edge keys) "
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


def lookup_edge_states(np, seed: int) -> list:
    """(c) and ``tests/test_torch_baselines_lookup_mock.py``: baseline states
    that reach the lookups' edges, built on the CPU, each ``(label, table,
    arrays, probes)``: the state's arrays in field order (numpy) and its
    probes (uint32; the keys 0, 0xFFFFFFFE and 0xFFFFFFFF among them)."""
    from repro_torch import convert
    from repro_torch.core import baselines as bl
    from repro_torch.core import hashing
    rng = np.random.default_rng(seed + 500)
    edge = np.array([0, 0xFFFFFFFE, MISS], np.uint32)
    states = []

    def keys_of(n, s):
        return make_keys(n, 0, seed + s)[0]

    def vals_of(n):
        return rng.integers(1, MISS, n, dtype=np.uint32)

    def add(label, table, st, probes, case, with_edge=True):
        assert case, f"lookup edge state {label!r} missed its case"
        arrays = tuple(np.array(a.numpy()) for a in st)
        probes = np.asarray(probes, np.uint32)
        if with_edge:
            probes = np.concatenate([probes, edge])
        states.append((label, table, arrays, probes))

    def ht_arrays(tk, tv, L):
        return convert.ht_state_from_numpy(
            (tk, tv, np.int32(L), np.int32((tk[:1 << L] != MISS).sum()),
             np.int32(0)), device="cpu")

    # HT: 2^4 slots all taken (fabricated), so a probe wraps the table twice
    tk = np.full(1 << 10, MISS, np.uint32)
    tv = np.zeros(1 << 10, np.uint32)
    tk[:16], tv[:16] = keys_of(16, 501), vals_of(16)
    add("HT 2^4 full (fabricated): every miss wraps the table twice", "ht",
        ht_arrays(tk, tv, 4), np.concatenate([tk[:16], keys_of(32, 502)]),
        True)
    k = np.append(keys_of(4, 503), np.uint32(MISS))
    st = bl.ht_insert_many(bl.ht_create(10, 4, device="cpu"), k, vals_of(5))
    add("HT 2^4 by inserts, the EMPTY pattern stored", "ht", st,
        np.concatenate([k, keys_of(40, 504)]),
        int(st.size_log2) == 4 and int(st.count) == 5)
    st = bl.ht_create(4, 0, device="cpu")
    add("HT 2^0, empty", "ht", st, keys_of(8, 505), int(st.size_log2) == 0)
    arrays, crowd = crowded_ht_state(np, rng, keys_of(300, 506))
    add("HT crowded (fabricated): full windows", "ht",
        convert.ht_state_from_numpy(arrays, device="cpu"),
        np.concatenate([crowd, arrays[0][600:640], keys_of(300, 506)]),
        bool((arrays[0][600:632] != MISS).all()))
    # keys placed past the first EMPTY slot of their window (fabricated): the
    # probe stops at the EMPTY slot and does not find them
    L = 8
    tk = np.full(1 << 10, MISS, np.uint32)
    tv = np.zeros(1 << 10, np.uint32)
    base = keys_of(60, 507)
    for key, v in zip(base.tolist(), vals_of(60).tolist()):
        bl.probe_put(tk, tv, key, v, L)
    hidden = []
    for key in keys_of(400, 508).tolist():
        home = hashing.hash_dir_host(key) >> (32 - L)
        window = [(home + j) % (1 << L) for j in range(32)]
        empty = [j for j, p in enumerate(window) if tk[p] == MISS]
        if len(empty) >= 2 and len(hidden) < 10:
            tk[window[empty[1]]], tv[window[empty[1]]] = key, vals_of(1)[0]
            hidden.append(key)
    st = ht_arrays(tk, tv, L)
    lost = bl.ht_lookup_plain(st, hidden).numpy().view(np.uint32)
    add("HT keys behind an EMPTY slot (fabricated)", "ht", st,
        np.concatenate([base, hidden, keys_of(64, 509)]),
        int((lost == MISS).sum()) >= 5)

    # sector edges (fabricated): keys placed d slots past their home behind
    # d filler keys; homes at a sector's last slot with d 1..3 run into the
    # next sector, d 8 lands on home + 8 (the next sector's same offset) from
    # every offset, d 12 and 20 run over two and three sectors
    L = 10
    tk = np.full(1 << 11, MISS, np.uint32)
    tv = np.zeros(1 << 11, np.uint32)
    fill = iter(keys_of(1200, 517).tolist())
    pool = keys_of(4000, 518).tolist()
    plan = ([(7, d) for d in (1, 2, 3)] * 2 + [(o, 8) for o in range(8)]
            + [(o, d) for o in (0, 3, 7) for d in (12, 20)])
    placed = []
    for o, d in plan:
        for key in pool:
            home = hashing.hash_dir_host(key) >> (32 - L)
            span = [(home + j) % (1 << L) for j in range(d + 1)]
            if home % 8 == o and (tk[span] == MISS).all():
                break
        else:
            raise AssertionError(f"no key with its home at offset {o} and "
                                 f"{d + 1} free slots")
        pool.remove(key)
        for q in span[:-1]:
            tk[q], tv[q] = next(fill), vals_of(1)[0]
        tk[span[-1]], tv[span[-1]] = key, vals_of(1)[0]
        placed.append(key)
    st = ht_arrays(tk, tv, L)
    found = bl.ht_lookup_plain(st, placed).numpy().view(np.uint32)
    fillers = tk[(tk != MISS) & ~np.isin(tk, placed)]
    add("HT sector edges (fabricated): probes from a sector's last slot "
        "into the next, hits at home + 8 from every offset, at + 12, + 20",
        "ht", st, np.concatenate([placed, fillers[:40], keys_of(64, 519)]),
        bool((found != MISS).all()))
    # tables of 2^2 and 2^3 slots (under and at one sector) whose arrays
    # hold keys past 2^L, which no probe may read
    for L, n_in in ((2, 3), (3, 7)):
        tk = np.full(1 << 5, MISS, np.uint32)
        tv = np.zeros(1 << 5, np.uint32)
        inside = keys_of(n_in, 520 + L)
        for key, v in zip(inside.tolist(), vals_of(n_in).tolist()):
            bl.probe_put(tk, tv, key, v, L)
        past = keys_of(16, 522 + L)
        tk[1 << L:(1 << L) + 16], tv[1 << L:(1 << L) + 16] = past, vals_of(16)
        st = ht_arrays(tk, tv, L)
        got = bl.ht_lookup_plain(st, np.concatenate([inside, past]))
        got = got.numpy().view(np.uint32)
        add(f"HT 2^{L} slots, {n_in} taken, keys past 2^{L} in the arrays "
            f"(fabricated)", "ht", st,
            np.concatenate([inside, past, keys_of(16, 524 + L)]),
            bool((got[:n_in] != MISS).all() and (got[n_in:] == MISS).all()))
    k = keys_of(600, 527)
    st = bl.ht_insert_many(bl.ht_create(12, 4, device="cpu"), k, vals_of(600))
    probes = np.concatenate([k, keys_of(940, 528)])
    add("HT 1543 probes (counts off the 256-key block)", "ht", st, probes,
        probes.size + edge.size == 1543)
    add("HT one probe", "ht", st, k[:1], True, with_edge=False)

    # HTI: migrate_batch 1 from 2^6 slots; the EMPTY pattern inserted first
    # (never migrated); 5 inserts into the migration: the old table fuller
    k = keys_of(200, 510)
    st = bl.hti_create(12, 6, device="cpu")
    st = bl.hti_insert_many(st, np.append(np.uint32(MISS), k[:27]),
                            vals_of(28), migrate_batch=1)

    def stale(st, avoid):
        """Re-insert a key still waiting in the old table (past the next
        slot the migration moves) with a new value: it is then in both."""
        ptr = int(st.migrate_ptr)
        old = st.old_keys.numpy().view(np.uint32)
        key = next(int(x) for x in old[ptr + 1:1 << int(st.old_log2)]
                   if x != MISS and int(x) not in avoid)
        return bl.hti_insert_many(st, [key], vals_of(1), migrate_batch=1), key

    def in_both(st, key):
        return key in st.old_keys.numpy().view(np.uint32) \
            and key in st.new_keys.numpy().view(np.uint32)

    st, w1 = stale(st, ())
    ok_, ov = (a.numpy().view(np.uint32) for a in (st.old_keys, st.old_vals))
    ptr = int(st.migrate_ptr)
    probes = np.concatenate([k[:60], keys_of(64, 511)])
    add("HTI mid-migration, the old table first: a key in both tables, "
        "migrated slots' values left behind", "hti", st, probes,
        bool(st.migrating) and int(st.new_count) < int(st.old_count)
        and in_both(st, w1) and bool(((ok_[:ptr] == MISS)
                                      & (ov[:ptr] != 0)).any()))
    i = 27
    while int(st.new_count) < int(st.old_count):
        st = bl.hti_insert_many(st, k[i:i + 1], vals_of(1), migrate_batch=1)
        i += 1
    st, w2 = stale(st, (w1,))
    add("HTI mid-migration, the new table first: a key in both tables",
        "hti", st, probes, bool(st.migrating) and in_both(st, w2)
        and int(st.new_count) >= int(st.old_count))
    st = bl.hti_insert_many(st, k[i:i + 1], vals_of(1), migrate_batch=4096)
    add("HTI drained (the EMPTY pattern left in the old table)", "hti", st,
        probes, not bool(st.migrating) and int(st.old_count) == 1)
    add("HTI one probe", "hti", st, k[:1], True, with_edge=False)

    # CH: 64 chains of 4-slot buckets: one chain of 4 buckets, others of
    # one, most heads -1; the EMPTY pattern stored; duplicate appends (the
    # first copy wins); stored values equal to MISS (the walk stops there)
    chain = same_home_keys(np, rng, 14, 6, 0)
    other = keys_of(20, 512)
    k = np.concatenate([chain[:7], other[:10], [MISS], chain[7:], other[10:],
                        chain[[1, 9, 13]]]).astype(np.uint32)
    v = vals_of(k.size)
    v[[2, 20]] = MISS
    st = bl.ch_insert_many(bl.ch_create(6, 64, 4, device="cpu"), k, v)
    heads, nxt = st.heads.numpy(), st.next_bucket.numpy()
    walk, cur = 0, int(heads[0])
    while cur >= 0:
        walk, cur = walk + 1, int(nxt[cur])
    add("CH chains of several buckets, heads -1, duplicate appends, values "
        "equal to MISS", "ch", st, np.concatenate([k, keys_of(64, 513)]),
        walk == 5 and int((heads == -1).sum()) > 0 and k[20] == chain[9])
    k = np.append(keys_of(29, 514), np.uint32(MISS))
    st = bl.ch_insert_many(bl.ch_create(0, 16, 5, device="cpu"), k,
                           vals_of(30))
    add("CH one chain (T 0) of 5-slot rows (the slot-by-slot search)", "ch",
        st, np.concatenate([k, keys_of(32, 515)]),
        int(st.num_buckets) == 6)
    k = keys_of(60, 516)
    st = bl.ch_insert_many(bl.ch_create(3, 8, 4, device="cpu"), k,
                           vals_of(60))
    add("CH capacity out (dropped keys)", "ch", st, k, int(st.dropped) > 0)
    # Fig. 7's 16-slot rows (one chunk: four 16-byte quarters), chains of
    # several buckets with a hit in every quarter; 20-slot rows (a second
    # chunk of one quarter); 6-slot rows (slot by slot)
    for T, S, n_k in ((2, 16, 200), (3, 20, 150), (3, 6, 100)):
        k = keys_of(n_k, 530 + S)
        st = bl.ch_insert_many(bl.ch_create(T, 64, S, device="cpu"), k,
                               vals_of(n_k))
        bk = st.bucket_keys.numpy().view(np.uint32)
        stored = np.isin(bk, k)
        case = {16: all(stored[:, 4 * q:4 * q + 4].any() for q in range(4)),
                20: bool(stored[:, 16:].any()),
                6: int(st.num_buckets) > 1 << T}[S]
        add(f"CH {1 << T} chains of {S}-slot rows", "ch", st,
            np.concatenate([k, keys_of(64, 540 + S)]),
            case and int(st.dropped) == 0)
    add("CH one probe", "ch", st, k[:1], True, with_edge=False)
    return states


def baseline_lookups(torch, np, seed: int, wrong: dict) -> None:
    """(c): the three lookup kernels against their plain versions on the
    card, bit for bit, on ``lookup_edge_states``; each wrong kernel
    (``wrong``: name -> its library, ``LOOKUP_WRONG``) must differ from the
    plain version on a state of its table."""
    import ctypes

    from repro_torch import convert
    from repro_torch.core import baselines as bl
    from repro_torch.core import hashing
    from repro_torch.kernels import _build
    from repro_torch.kernels import baselines_lookup as look
    dev = torch.device("cuda")
    kinds = {"ht": (convert.ht_state_from_numpy, bl.ht_lookup_many,
                    bl.ht_lookup_plain, "ht_lookup"),
             "hti": (convert.hti_state_from_numpy, bl.hti_lookup_many,
                     bl.hti_lookup_plain, "hti_lookup"),
             "ch": (convert.ch_state_from_numpy, bl.ch_lookup_many,
                    bl.ch_lookup_plain, "ch_lookup")}
    libs = {}
    for wname, path in wrong.items():
        libs[wname] = ctypes.CDLL(str(path))
        for fn, argtypes in look._SIGNATURES.items():
            getattr(libs[wname], fn).argtypes = argtypes
            getattr(libs[wname], fn).restype = ctypes.c_int
    sound = look._lib()
    differ = dict.fromkeys(wrong, 0)
    for label, table, arrays, probes in lookup_edge_states(np, seed):
        make, lookup, plain, name = kinds[table]
        st = make(arrays, device=dev)
        q = torch.from_numpy(probes.view(np.int32)).to(dev)
        before = _build.launches().get(name, 0)
        got, want = lookup(st, q), plain(st, q)
        assert _build.launches().get(name, 0) == before + 1, \
            f"(c) {label}: {name} did not launch"
        assert equal_bits(got, want), f"(c) {label}: {name} differs"
        bad_counts = []
        for wname in wrong:
            if LOOKUP_WRONG[wname][0] != table:
                continue
            _build._libs["baselines_lookup"] = libs[wname]
            try:
                bad = lookup(st, q)
            finally:
                _build._libs["baselines_lookup"] = sound
            n_bad = int((hashing.bits(bad) != hashing.bits(want)).sum())
            differ[wname] += n_bad
            bad_counts.append(f"{wname} ({LOOKUP_WRONG[wname][3]}) on "
                              f"{n_bad}")
        hits = int((hashing.bits(want) != -1).sum())
        log(f"(c) {name} kernel == plain, {label}: {probes.size} probes, "
            f"{hits} not MISS; the wrong kernels differ: "
            + "; ".join(bad_counts))
    for wname, n in differ.items():
        assert n > 0, f"(c) the wrong {wname} lookup agrees on every state"


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
    contexts at the split kernel's edges (SPLIT - 1, SPLIT, SPLIT + 1,
    S_cap), and (m1)'s decode layer (4 sequences, S_cap 2088); at each shape the self-row fold (the current token's K/V row as
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
         [sp - 1, sp, sp + 1, 3 * sp + 40], None, None),
        # (j)'s decode layers: hymba_1_5b (25 query heads over 5 KV heads x
        # 64; window 1024 but layers 0, 15 and 31) and qwen2_moe_a2_7b (16
        # heads, no GQA, x 128), at (j)'s S_cap
        ("hymba_1_5b widths, window 1024", 2, 5, 5, 64, 2112, [2080, 700],
         1024, None),
        ("hymba_1_5b widths, global layer", 2, 5, 5, 64, 2112, [2080, 1],
         None, None),
        ("qwen2_moe_a2_7b widths", 2, 16, 1, 128, 2112, [2080, 1500], None,
         None),
        # paligemma_3b's decode layer (8 query heads over 1 KV head x 256;
        # decode tokens sit past the prefix, so no prefix term): 8
        # sequences at (j)'s S_cap on both routes
        ("paligemma_3b widths", 8, 1, 8, 256, 2112,
         [2080, 1500, 2112, 2064, 0, 1, 700, 2047], None, None),
        # (m1)'s decode layer: the serve CLI's 4 sequences at qwen3_4b's
        # widths, 2048 prompt tokens + up to 31 generated in an S_cap-2088
        # view
        ("qwen3_4b, serve CLI decode layer", 4, 8, 4, 128, 2088,
         [2048, 2063, 2079, 2087], None, None)]
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
    # (j)'s prefill layers: hymba_1_5b's global layers (0, 15, 31) and
    # qwen2_moe_a2_7b's (16 heads x 128 without GQA, 8 x 2048 tokens)
    ("hymba_1_5b global layer", (1, 5, 5, 1500, 64), 1500, None, None, None),
    ("qwen2_moe_a2_7b prefill layer", (8, 16, 1, 2048, 128), 2048, None, None,
     2),
]
# (c), flash attention in float32 at (m1)'s prefill layer shape: the serve
# CLI's float32 parameters run the 3xTF32 kernel at qwen3_4b's widths over
# its 4 x 2048 prompt (the plain version on all four sequences); also timed
FLASH_SERVE_CASE = ("qwen3_4b prefill layer, serve CLI", (4, 8, 4, 2048, 128),
                    2048, None, None, None)
# (c), flash attention in float32 at the 3xTF32 kernel's other shapes: name,
# q shape, Skv, window, prefix_len.  (j)'s float32 prefill layers:
# qwen2_moe_a2_7b on 2 prompts (16 heads x 128, no GQA), hymba_1_5b's local
# layers (G 5, hd 64, window 1024, so a CTA past key 1024 skips the tiles
# below its window) and global ones on 8, paligemma_3b on 8 (one KV head, G
# 16 with its padding, hd 256, 256 prefix positions); then q shorter than a
# ragged Skv at hd 128 and 64, each with a window that skips tiles.  The
# plain version runs on every sequence.  tools/flash_ab.py times these too.
FLASH_F32_CASES = [
    ("qwen2_moe_a2_7b prefill layer", (2, 16, 1, 2048, 128), 2048, None, 0),
    ("hymba_1_5b local layer", (8, 5, 5, 2048, 64), 2048, 1024, 0),
    ("hymba_1_5b global layer", (8, 5, 5, 2048, 64), 2048, None, 0),
    ("paligemma_3b prefill layer", (8, 1, 16, 2048, 256), 2048, None, 256),
    ("Sq < Skv, hd 128, window 300", (1, 8, 4, 200, 128), 777, 300, 0),
    ("Sq < Skv, hd 64, window 100", (2, 5, 5, 100, 64), 1000, 100, 0),
]


# (c), flash attention with PaliGemma's bidirectional prefix: name, q shape,
# Skv (= Sq), prefix_len, window, softcap, input scale, sequences held to the
# plain version (None: all).  PaliGemma's layout (one KV head, G 16 with its
# padding, hd 256): a tensor-core CTA (either dtype) covers 8 positions and
# a SIMT one 4, so prefixes of 1, 7 and 100 end inside a CTA, and 100
# reaches past the first 64-key tile (16-key for the 3xTF32 kernel);
# windows of 16 and a softcap of 20 beside the prefix;
# then PaliGemma's prefill layer (8 x 2048 positions, prefix 256)
FLASH_PREFIX_CASES = [
    (f"prefix {P}, S {S}", (2, 1, 16, S, 256), S, P, None, None, 1.0, None)
    for P in (1, 7, 64, 100) for S in (96, 300)] + [
    ("prefix 100, window 16", (2, 1, 16, 300, 256), 300, 100, 16, None, 1.0,
     None),
    ("prefix 7, window 16", (2, 1, 16, 96, 256), 96, 7, 16, None, 1.0, None),
    ("prefix 64, softcap 20", (2, 1, 16, 300, 256), 300, 64, None, 20.0, 3.0,
     None),
    ("prefix 100, window 16, softcap 20", (2, 1, 16, 300, 256), 300, 100, 16,
     20.0, 3.0, None)]
FLASH_PALIGEMMA_CASE = ("paligemma_3b prefill layer", (8, 1, 16, 2048, 256),
                        2048, 256, None, None, 1.0, 2)


def flash_wrong_variants(torch, want, q, k, v, window=None, softcap=None,
                         prefix_len=0):
    """The plain version of three wrong flash kernels on the same inputs (q
    (B, KV, G, Sq, hd), k/v (B, KV, Skv, hd)): the diagonal token dropped,
    q_offset off by one, and (with ``window``) the window edge moved out by
    one, each with the call's prefix.  Each must go past ``attn_limit`` of
    ``want``; returns each one's |err| / limit.  One whose mask equals the
    sound one is no wrong kernel at this shape and is left out (q_offset
    off by one where a prefix covers every position)."""
    from repro_torch.kernels import ref
    Sq, Skv, dev = q.shape[3], k.shape[2], q.device
    kw = dict(prefix_len=prefix_len, device=dev)
    mask = ref.flash_mask(Sq, Skv, window=window, **kw)
    diag = (torch.arange(Sq, device=dev)[:, None] + Skv - Sq
            == torch.arange(Skv, device=dev)[None, :])
    masks = {"diagonal token dropped": mask & ~diag,
             "q_offset off by one": ref.flash_mask(
                 Sq, Skv, window=window, q_offset=Skv - Sq - 1, **kw)}
    if window is not None:
        masks["window edge moved by one"] = ref.flash_mask(
            Sq, Skv, window=window + 1, **kw)
    return held_apart(torch, want, q, k, v, {
        name: m for name, m in masks.items() if not torch.equal(m, mask)},
        softcap)


def prefix_wrong_masks(torch, Sq, Skv, G, hd, kernel, prefix_len,
                       window=None, device=None) -> dict:
    """The masks of three wrong prefix kernels: the prefix dropped (the mask
    plain causal), the prefix keys past the causal tile range skipped (the
    ``kernel``'s tile range left unwidened, at its ``flash_attention.tiles``),
    and (with ``window``) the prefix's window term left out.  Those equal to
    the sound mask at this shape are left out: they are no wrong kernel
    here."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import tiles
    P, off = prefix_len, Skv - Sq
    rows, bk = tiles(kernel, hd)
    assert rows % G == 0, "a CTA must hold whole positions"
    mask = ref.flash_mask(Sq, Skv, window=window, prefix_len=P,
                          device=device)
    qpos = torch.arange(Sq, device=device) + off
    kpos = torch.arange(Skv, device=device)
    cta = torch.arange(Sq, device=device) * G // rows
    q_lo = cta * rows // G + off
    q_hi = (torch.clamp((cta + 1) * rows, max=Sq * G) - 1) // G + off
    t_hi = torch.clamp(q_hi // bk + 1, max=-(-Skv // bk))
    t_lo = (torch.clamp(q_lo - window + 1, min=0) // bk if window is not None
            else torch.zeros_like(q_lo))
    in_range = ((kpos[None, :] >= (t_lo * bk)[:, None])
                & (kpos[None, :] < (t_hi * bk)[:, None]))
    masks = {"prefix dropped": ref.flash_mask(Sq, Skv, window=window,
                                              device=device),
             "prefix keys past the causal tile range skipped":
                 mask & in_range}
    if window is not None:
        causal = ref.flash_mask(Sq, Skv, prefix_len=P, device=device)
        masks["the prefix's window term left out"] = causal & (
            kpos[None, :] > qpos[:, None] - window)
    return {name: m for name, m in masks.items() if not torch.equal(m, mask)}


def held_apart(torch, want, q, k, v, masks, softcap) -> dict:
    """Each wrong kernel's plain version (``masks``: name -> its (Sq, Skv)
    mask) on the inputs of ``want``: each must go past ``attn_limit`` of
    ``want``; returns each one's |err| / limit."""
    from repro_torch.kernels import ref
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


def tf32_round_(torch, x):
    """float32 ``x`` rounded in place to TF32 (to nearest, ties away from
    zero, on the float32 bits, as the 3xTF32 kernel rounds); returns x."""
    bits = x.view(torch.int32)
    bits.add_(0x1000).bitwise_and_(-0x2000)
    return x


def flash_one_pass_tf32(torch, q, k, v, mask, softcap=None):
    """A wrong float32 flash kernel: the plain version
    (``ref.flash_attention_masked``) with q, k, v and p rounded to TF32 in
    its products, as one TF32 pass on the tensor cores takes them (11
    significant bits of each operand), the sums in float32."""
    hd = q.shape[-1]
    s = torch.einsum("bkgqd,bksd->bkgqs", tf32_round_(torch, q.clone()),
                     tf32_round_(torch, k.clone()))
    s.mul_(hd ** -0.5)
    if softcap is not None:
        s.div_(softcap).tanh_().mul_(softcap)
    s.masked_fill_(~mask, -1e30)
    s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    s.div_(s.sum(dim=-1, keepdim=True))
    return torch.einsum("bkgqs,bksd->bkgqd", tf32_round_(torch, s),
                        tf32_round_(torch, v.clone()))


def one_pass_margin(torch, want, q, k, v, window, softcap, prefix_len):
    """|err| / limit of ``flash_one_pass_tf32`` against ``want``, the plain
    version's float32 answer; raises unless it goes past the limit."""
    from repro_torch.kernels import ref
    mask = ref.flash_mask(q.shape[3], k.shape[2], window=window,
                          prefix_len=prefix_len, device=q.device)
    bad = flash_one_pass_tf32(torch, q, k, v, mask, softcap)
    ratio, _ = err_ratio(torch, bad, want)
    if not ratio > 1:
        raise AssertionError(f"one TF32 pass is within the float32 limit: "
                             f"|err| / limit {ratio}")
    return ratio


def flash_bound(q, k, prefix_len=0, window=None) -> tuple:
    """(flops, bytes, bound ms, its term) of one causal flash call (the
    wrapper's ``cost``): bfloat16 at the tensor cores' 989 TFLOP/s, float32
    at 3xTF32's three TF32 products a flop at 494.7 TFLOP/s; the larger of
    that and the bytes at 3.35 TB/s."""
    from repro_torch.kernels import flash_attention as flash
    flops, bytes_ = flash.cost(q, k, window=window, prefix_len=prefix_len)
    peak = PEAK_BF16 if q.element_size() == 2 else PEAK_F32_FLASH
    by_ops, by_bytes = flops / peak * 1e3, bytes_ / HBM_BYTES_PER_S * 1e3
    return (flops, bytes_, max(by_ops, by_bytes),
            "operations" if by_ops > by_bytes else "bytes")


def sdpa_f32(torch, q, k, v, **kw) -> list:
    """``scaled_dot_product_attention`` on float32 q (B, H, Sq, hd) over k/v
    (B, KV, Skv, hd) with TF32 off, two ways: with ``enable_gqa``, and,
    with GQA (KV < H), on k and v expanded to all H heads before the call.
    Each runs the memory-efficient backend, or the math one where that
    refuses the call (as it refuses ``enable_gqa`` in float32).  Returns
    [(how, a function making the call)]."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def call(backend, k, v, gqa):
        def run():
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(q, k, v,
                                                      enable_gqa=gqa, **kw)
        return run

    def way(how, k, v, gqa):
        try:
            call(SDPBackend.EFFICIENT_ATTENTION, k, v, gqa)()
            return (f"memory-efficient backend, {how}",
                    call(SDPBackend.EFFICIENT_ATTENTION, k, v, gqa))
        except RuntimeError:
            return f"math backend, {how}", call(SDPBackend.MATH, k, v, gqa)
    assert not torch.backends.cuda.matmul.allow_tf32
    ways = [way("enable_gqa", k, v, True)]
    G = q.shape[1] // k.shape[1]
    if G > 1:
        ke, ve = (t.repeat_interleave(G, dim=1) for t in (k, v))
        ways.append(way("k and v expanded to every query head beforehand",
                        ke, ve, False))
    return ways


def time_sdpa_f32(torch, timer, q, k, v, want, reps: int = 10,
                  **kw) -> tuple:
    """Each of ``sdpa_f32``'s calls timed (CUDA events, mean of ``reps``
    after 3 warm-up calls) and held to ``want`` (the plain version's (B, KV,
    G, Sq, hd) answer).  Returns (the fastest call's ms, a log text naming
    every call's ms, its |err| / limit and which one is the fastest)."""
    B, KV, G, Sq, hd = want.shape
    runs = []
    for how, fn in sdpa_f32(torch, q, k, v, **kw):
        ms, lib = timer(fn, reps=reps, warmup=3)
        ratio, _ = err_ratio(torch, lib.reshape(B, KV, G, Sq, hd), want)
        del lib
        runs.append((ms, how, ratio))
    best = min(runs)
    return best[0], "scaled_dot_product_attention (float32, TF32 off): " + \
        "; ".join(f"{how} {ms:.4f} ms (/ limit {r:.3g})"
                  for ms, how, r in runs) + f"; the fastest: {best[1]}"


def measure_flash_f32(torch, seed: int, timer) -> tuple:
    """(c), the float32 flash kernel at ``FLASH_SERVE_CASE`` ((m1)'s prefill
    layer: qwen3_4b's widths, 4 x 2048 tokens), causal, on seeded operands
    in the model layout as ``ops.mha_forward`` passes them: its time (CUDA
    events, mean of 10 calls after 3 warm-up calls), the plain version's,
    ``scaled_dot_product_attention``'s in float32 (``time_sdpa_f32``: both
    ways are logged, the faster is the row's library time), the largest
    difference from the plain version, and the bound (``flash_bound``, with
    the CUDA cores' 67 TFLOP/s term beside it).  Returns the kernels line's
    row but its launches."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import kernel_path
    name, (B, KV, G, S, hd), skv, _, _, _ = FLASH_SERVE_CASE
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 201)
    qm, km, vm = (torch.randn((B, S, n, hd), generator=gen, device=dev)
                  for n in (KV * G, KV, KV))
    ms, got = timer(lambda: ops.mha_forward(qm, km, vm), reps=10, warmup=3)
    q = qm.reshape(B, S, KV, G, hd).permute(0, 2, 3, 1, 4)
    k, v = km.transpose(1, 2), vm.transpose(1, 2)
    plain_ms, want = timer(lambda: ref.flash_attention_ref(q, k, v), reps=1,
                           warmup=1)
    got = got.reshape(B, S, KV, G, hd).permute(0, 2, 3, 1, 4)
    ratio, err = close(torch, got, want)
    del got
    lib_ms, lib_text = time_sdpa_f32(torch, timer, qm.transpose(1, 2), k, v,
                                     want, is_causal=True)
    flops, bytes_, bound, by = flash_bound(q, k)
    log(f"(c) flash kernel ({kernel_path(q.dtype, hd)}) timed at {name} (q "
        f"{tuple(qm.shape)}, k/v {tuple(km.shape)}, float32): {ms:.4f} ms a "
        f"call (CUDA events, mean of 10 after 3 warm-up calls); plain "
        f"{plain_ms:.4f} ms; {lib_text} (the row's library_ms); bound "
        f"{bound:.4f} ms ({by}: {flops} flops as 3 TF32 products each at "
        f"494.7 TFLOP/s, {bytes_} B at 3.35 TB/s; on the CUDA cores' 67 "
        f"TFLOP/s {flops / PEAK_F32 * 1e3:.4f} ms); kernel |err| vs plain "
        f"{err:.3g} (/ limit {ratio:.3g}); {flops / ms / 1e9:.1f} TFLOP/s "
        f"achieved, {100 * bound / ms:.1f}% of the bound")
    return ("flash_attention_f32", "src/repro/kernels/flash_attention.py:122",
            ms, plain_ms, bytes_, err, lib_ms, flops)


def phase_flash(torch, seed: int, timer) -> tuple:
    """(c), the flash kernel against its plain version: float32 and bfloat16
    at ``FLASH_CASES`` (contiguous operands, and the model layout through
    ``ops.mha_forward``: strided views in, (B, S, H, hd) out), then bfloat16
    at qwen3_4b's prefill layer shape (8 x 2048 tokens, 32 query heads over
    8 KV heads, hd 128; the plain version on 2 of the sequences), at
    gemma2_27b's widths (16 KV heads, G 2, hd 128) with window 4096 and
    softcap 50 over 8192 tokens, at hymba_1_5b's (KV 5, G 5, hd 64, window
    1024 over 1500 tokens) and at musicgen_medium's (24 heads, G 1, hd 64,
    1000 tokens); float32 at ``FLASH_SERVE_CASE`` ((m1)'s prefill layer,
    4 x 2048 tokens at qwen3_4b's widths); then float32 and bfloat16 at ``FLASH_PREFIX_CASES``
    (PaliGemma's bidirectional prefix) and bfloat16 at PaliGemma's prefill
    layer; float32 at ``FLASH_F32_CASES`` ((j)'s float32 prefill layers,
    and q shorter than the keys at hd 64 and 128 with windows that skip
    tiles); each line names the kernel that ran (``tensor-core``,
    ``3xtf32`` or ``simt``); at each shape the wrong kernels' plain
    versions go past the limit (with a prefix, also those of
    ``prefix_wrong_masks``; in float32, also one TF32 pass,
    ``flash_one_pass_tf32``).  Then the float32 kernel timed at
    ``FLASH_SERVE_CASE`` (``measure_flash_f32``, whose row it returns)."""
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

    def check(name, shape, skv, window, softcap, dtype, scale, n_plain=None,
              prefix_len=0):
        qm, km, vm, q, k, v = model_layout(shape, skv, dtype, scale)
        B, KV, G, Sq, hd = shape
        n = B if n_plain is None else n_plain
        kw = dict(window=window, softcap=softcap, prefix_len=prefix_len)
        want = ref.flash_attention_ref(q[:n], k[:n], v[:n], causal=True,
                                       **kw)
        got = ops.mha_forward(qm, km, vm, **kw)
        got = got.reshape(B, Sq, KV, G, hd).permute(0, 2, 3, 1, 4)
        checks = [close(torch, got[:n], want)]
        del got
        if n_plain is None:
            got = flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), **kw)
            checks.append(close(torch, got, want))
            del got
        margins = flash_wrong_variants(torch, want, q[:n], k[:n], v[:n],
                                       window, softcap, prefix_len)
        prefix = ""
        if prefix_len:
            masks = prefix_wrong_masks(torch, Sq, skv, G, hd,
                                       kernel_path(dtype, hd), prefix_len,
                                       window, dev)
            margins.update(held_apart(torch, want, q[:n], k[:n], v[:n],
                                      masks, softcap))
            prefix = f", prefix {prefix_len}"
        if dtype == torch.float32:
            margins["one-pass TF32"] = one_pass_margin(
                torch, want, q[:n], k[:n], v[:n], window, softcap,
                prefix_len)
        ratio, err = map(max, zip(*checks))
        log(f"(c) flash kernel ({kernel_path(dtype, hd)}) == plain "
            f"({str(dtype)[6:]}, {name}: q "
            f"{tuple(shape)}, Skv {skv}, window {window}, softcap {softcap}"
            f"{prefix}"
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
    name, shape, skv, window, softcap, n_plain = FLASH_SERVE_CASE
    check(name, shape, skv, window, softcap, torch.float32, 1.0,
          n_plain=n_plain)
    for name, shape, skv, window, P in FLASH_F32_CASES:
        check(name, shape, skv, window, None, torch.float32, 1.0,
              prefix_len=P)
    for dtype in (torch.float32, torch.bfloat16):
        for name, shape, skv, P, window, softcap, scale, n_plain in \
                FLASH_PREFIX_CASES:
            check(name, shape, skv, window, softcap, dtype, scale, n_plain,
                  prefix_len=P)
    name, shape, skv, P, window, softcap, scale, n_plain = \
        FLASH_PALIGEMMA_CASE
    check(name, shape, skv, window, softcap, torch.bfloat16, scale, n_plain,
          prefix_len=P)
    torch.cuda.synchronize()
    return measure_flash_f32(torch, seed, timer)


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
         max_err, library_ms=None, phase="e", flops=0,
         peak=PEAK_BF16) -> dict:
    """One entry of the ``{"kernels": [...]}`` line; the bound is the larger
    of the bytes the function must move over the card's memory rate and its
    ``flops`` over ``peak`` (the bfloat16 tensor cores'; a float32 flash
    kernel's ``PEAK_F32_FLASH``)."""
    by_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    by_ops = flops / peak * 1e3
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


def check_flat_keys(torch, idx, probe, trad, view, flags) -> None:
    """(f): the stacked lookups' flat-key mode (``lookup_batched``'s launch:
    the keys in input order, each finding its shard in the kernel) on
    every arm, bit for bit against the padded kernels on the same keys
    partitioned by shard and scattered back; the routed arm with the
    shards ``flags`` marks traditional.  The same launches with each key's
    shard taken from one bit too few of its hash must differ."""
    from repro_torch.kernels import eh_lookup as lk
    padded, sid, order, rank, _ = idx._partition(probe)
    arms = {"shortcut": lambda k, **kw: lk.sharded_shortcut_lookup(
                k, *view, **kw),
            "traditional": lambda k, **kw: lk.sharded_eh_lookup(
                k, *trad, **kw),
            "routed": lambda k, **kw: lk.sharded_routed_lookup(
                k, *trad, *view, flags, **kw)}
    for name, fn in arms.items():
        want = idx._scatter_back(fn(padded), sid, order, rank)
        want = want.view(torch.int32)
        got = fn(probe, shard_bits=idx.shard_bits).view(torch.int32)
        assert torch.equal(got, want), \
            f"(f) flat-key {name} arm differs from padded + scatter-back"
        wrong = fn(probe, shard_bits=idx.shard_bits - 1).view(torch.int32)
        n_wrong = int((wrong != want).sum())
        assert n_wrong > 0, f"(f) flat-key {name} arm: one bit short passed"
        log(f"(f) flat-key {name} arm: {probe.numel()} keys equal to the "
            f"padded arm + scatter-back; one bit short: {n_wrong} wrong")


def measure_sharded(torch, np, res, timer, rows) -> None:
    """The sharded path's kernels at its shapes, as ``measure_kernels`` does
    for the flat path: ``lookup_batched``'s flat-key launch of each arm on
    the mixed probe (the main path's), the padded routed launch (the JAX
    package's layout) and shard 0's stacked launch; and the time of one
    copy-on-write publish.  It runs after (f)'s launches were counted, so
    its own launches, the checks' included, stay out of the kernels line."""
    from repro_torch.core.hashing import shard_of_keys
    from repro_torch.kernels import eh_lookup as lk
    from repro_torch.kernels import ref
    idx, probe = res["idx"], res["mixed_probe"]
    bits = idx.shard_bits
    args = res["routed_args"]
    keys, dirs, bks, bvs, gds, vks, vvs, vls, flags = args
    trad, view = (dirs, bks, bvs, gds), (vks, vvs, vls)
    check_flat_keys(torch, idx, probe, trad, view, flags)

    # the flat-key rows: (f) launches the three sharded wrappers only from
    # lookup_batched, whose launches all take flat keys, so (f)'s counts
    # under the wrappers' names are the flat kernels' own
    sid = shard_of_keys(probe, bits)
    of = [probe[sid == s] for s in range(len(dirs))]

    def trad_ref(s, ks):
        return ref.lookup_ref(ks, dirs[s], bks[s], bvs[s], gds[s])

    def view_ref(s, ks):
        return ref.lookup_ref(ks, None, vks[s], vvs[s], vls[s])

    def trad_bytes(s):
        return lookup_bytes(of[s], dirs[s], bks[s], bvs[s], gds[s])

    def view_bytes(s):
        return lookup_bytes(of[s], None, vks[s], vvs[s], vls[s])

    routed = flags.tolist()
    flat = (
        ("flat_eh_lookup", "eh_lookup", "src/repro/kernels/eh_lookup.py:171",
         lambda: lk.sharded_eh_lookup(probe, *trad, shard_bits=bits),
         trad_ref, trad_bytes),
        ("flat_shortcut_lookup", "shortcut_lookup",
         "src/repro/kernels/eh_lookup.py:171",
         lambda: lk.sharded_shortcut_lookup(probe, *view, shard_bits=bits),
         view_ref, view_bytes),
        ("flat_routed_lookup", "sharded_routed_lookup",
         "src/repro/kernels/eh_lookup.py:334",
         lambda: lk.sharded_routed_lookup(probe, *trad, *view, flags,
                                          shard_bits=bits),
         lambda s, ks: (trad_ref if routed[s] else view_ref)(s, ks),
         lambda s: (trad_bytes if routed[s] else view_bytes)(s)))
    for name, counted, replaces, fn, plain, bytes_of in flat:
        ms, got = timer(fn)
        plain_ms, want = timer(lambda: ref.flat_keys_ref(probe, bits, plain),
                               reps=1, warmup=0)
        rows.append(_row(name, "src/repro_torch/kernels/csrc/eh_lookup.cu",
                         replaces,
                         {name: res["launches"].get(counted, 0)}, ms,
                         plain_ms, sum(bytes_of(s) for s in range(len(of))),
                         err(got, want)))

    # the padded layout's kernels, which the main path no longer launches
    # (launches 0): the hand-written counterparts of the JAX package's
    ms, got = timer(lambda: lk.sharded_routed_lookup(*args))
    plain_ms, want = timer(lambda: ref.routed_lookup_ref(*args), reps=1,
                           warmup=0)
    moved = sum(
        lookup_bytes(keys[s], dirs[s], bks[s], bvs[s], gds[s]) if f else
        lookup_bytes(keys[s], None, vks[s], vvs[s], vls[s])
        for s, f in enumerate(routed))
    rows.append(_row("sharded_routed_lookup",
                     "src/repro_torch/kernels/csrc/eh_lookup.cu",
                     "src/repro/kernels/eh_lookup.py:334",
                     {}, ms, plain_ms, moved, err(got, want)))
    args = res["stacked_args"]
    ms, got = timer(lambda: lk.stacked_shortcut_lookup(*args))
    plain_ms, want = timer(lambda: ref.stacked_shortcut_lookup_ref(*args),
                           reps=1, warmup=0)
    skeys, svks, svvs, svls, s = args
    rows.append(_row("stacked_shortcut_lookup",
                     "src/repro_torch/kernels/csrc/eh_lookup.cu",
                     "src/repro/kernels/eh_lookup.py:279",
                     res["launches"], ms, plain_ms,
                     lookup_bytes(skeys, None, svks[s], svvs[s], svls[s]),
                     err(got, want)))

    # where an arm's time goes on the padded layout: its kernel alone, and
    # the partition that the layout needs (one stable sort, one host read
    # of the counts, the pad); and the flat kernels on the same keys in
    # shard order, which the padded layout's locality across the stack has
    trad_ms, _ = timer(lambda: lk.sharded_eh_lookup(keys, *trad))
    sc_ms, _ = timer(lambda: lk.sharded_shortcut_lookup(keys, *view))
    part_ms, _ = timer(lambda: idx._partition(probe))
    by_shard = probe[torch.argsort(sid, stable=True)]
    sorted_trad_ms, _ = timer(lambda: lk.sharded_eh_lookup(
        by_shard, *trad, shard_bits=bits))
    sorted_sc_ms, _ = timer(lambda: lk.sharded_shortcut_lookup(
        by_shard, *view, shard_bits=bits))
    log(f"(e) on the mixed probe's padded layout {tuple(keys.shape)}: "
        f"sharded_eh_lookup {trad_ms:.4f} ms, sharded_shortcut_lookup "
        f"{sc_ms:.4f} ms, partition {part_ms:.4f} ms; flat keys in shard "
        f"order: flat_eh_lookup {sorted_trad_ms:.4f} ms, "
        f"flat_shortcut_lookup {sorted_sc_ms:.4f} ms")
    del by_shard

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
    from repro_torch.kernels import _decode, ops, ref
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
    flops, bytes_ = _decode.cost(qk, kp.transpose(1, 2), lens, tables, bs,
                                 None, False)
    rows.append(("paged_attention", "src/repro/kernels/paged_attention.py:112",
                 ms, plain_ms, bytes_, err, None, flops))
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
    flops, bytes_ = _decode.cost(qk, vk.transpose(1, 2), lens, None,
                                 vk.shape[1], None, False)
    rows.append(("shortcut_attention",
                 "src/repro/kernels/shortcut_attention.py:114", ms, plain_ms,
                 bytes_, err, lib_ms, flops))
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
    for (name, replaces, ms, plain_ms, bytes_, max_err, lib_ms,
         flops) in kres["rows"]:
        kernels.append(_row(
            name, "src/repro_torch/kernels/csrc/decode_attention.cu",
            replaces, kres["launches"], ms, plain_ms, bytes_, max_err,
            library_ms=lib_ms, phase="g", flops=flops))


#: names of the decode kernels' ``__global__`` functions in a trace
DECODE_KERNELS = ("split_kernel", "combine_kernel")


def profiled(torch, fn, spans=()) -> tuple:
    """``fn()`` once under ``torch.profiler``: its result, the device's busy
    ms (the summed durations of the kernels and copies it ran, which one
    stream runs one at a time), their count, the ms of those that are
    decode-attention kernels (``DECODE_KERNELS``), and per name in
    ``spans`` (``record_function`` spans of the port, e.g. ``moe.SPAN``)
    the device ms of the kernels that ran inside the span's device-side
    annotations (each from the first to the last kernel of one range; one
    stream runs nothing else between them), 0 when the trace has none of
    them; (result, None, 0, None, {}) when the trace holds no device
    events."""
    import bisect
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = prof.events()
    # a span's own device-side annotation is no kernel: left out of busy
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and e.name not in spans
           and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    attn = sum(e.time_range.elapsed_us() for e in dev
               if any(k in e.name for k in DECODE_KERNELS)) / 1e3

    def inside_ms(name):
        marks = sorted((e.time_range.start, e.time_range.end) for e in events
                       if e.device_type == DeviceType.CUDA and e.name == name)
        starts = [m[0] for m in marks]
        us = 0
        for e in dev:
            i = bisect.bisect_right(starts, e.time_range.start) - 1
            if i >= 0 and e.time_range.end <= marks[i][1]:
                us += e.time_range.elapsed_us()
        return us / 1e3
    span_ms = {name: inside_ms(name) for name in spans}
    if not dev:
        return out, None, 0, None, {}
    return out, busy, len(dev), attn, span_ms


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
    from repro_torch.kernels import _decode
    from repro_torch.kvcache import paged_cache as pc
    from repro_torch.models import attention as attn
    from repro_torch.models import model as M
    dev = torch.device("cuda")
    c = MODEL_CONFIG
    cfg = get(c["arch"])
    B, P, steps = c["batch"], c["prompt"], c["steps"]
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

    # the steps must not materialize a context: count gathers while the
    # server runs
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
    try:
        served = serve_family(torch, cfg, params, toks, ("shortcut", "paged"),
                              (), torch.bfloat16, timed=True,
                              variants=("rope position off by one",), c=c)
    finally:
        for (mod, name), fn in zip(spied, originals):
            setattr(mod, name, fn)
    assert gathers["n"] == 0, \
        f"(h) the decode steps gathered a context {gathers['n']} times"
    assert served["prefill_launches"] == cfg.num_layers
    assert served["decode_launches"] == \
        _decode.KERNELS_PER_CALL * cfg.num_layers
    for k in ("prefill_s", "prefill_trace", "decode_launches",
              "shortcut_step_s", "shortcut_step_ev", "shortcut_trace",
              "paged_step_s", "paged_step_ev", "paged_trace"):
        res[k] = served[k]
    res["launches"] = {"flash_attention": 3 * served["prefill_launches"]}
    routes = {k: served[k] for k in ("shortcut", "paged", "shortcut_logits",
                                     "paged_logits")}
    routes["wrong_logits"] = served["wrong_logits"]["rope position off by one"]
    assert torch.equal(routes["shortcut"], routes["paged"]), \
        "(h) the routes decoded different tokens"
    assert torch.equal(routes["shortcut_logits"], routes["paged_logits"]), \
        "(h) the routes' last-step logits differ in bits"
    res["route_logit_diff"] = float((routes["shortcut_logits"].float()
                                     - routes["paged_logits"].float())
                                    .abs().max())
    res["tokens"] = routes["shortcut"]
    torch.cuda.synchronize()
    res["peak_bytes"] = torch.cuda.max_memory_allocated()

    # decode against the full forward over prompt + the fed tokens
    want, _ = full_forward(torch, cfg, params, toks,
                           routes["shortcut"][:, :steps])
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


def measure_flash(torch, mres, timer, phase="h", c=MODEL_CONFIG) -> tuple:
    """The flash kernel at the prefill layer shape of ``phase``'s model
    (``mres["cfg"]``; batch and prompt from ``c``; its padded heads, as the
    model calls it), causal without a window and with the model's prefix,
    on seeded bfloat16 operands in the model layout: its time, the plain
    version's and ``scaled_dot_product_attention``'s (causal, GQA; with a
    prefix, the plain version's boolean mask) on the same tensors, the
    largest difference from plain, and its bound; with padded heads, also
    the kernel's time on the live heads alone."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import kernel_path
    from repro_torch.models import attention as attn
    cfg = mres["cfg"]
    B, S = c["batch"], c["prompt"]
    P = cfg.prefix_len if cfg.input_mode == "prefix_embeddings" else 0
    _, G, KV, Gp = attn._padding(cfg)
    H, hd = KV * Gp, cfg.resolved_head_dim
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    qm, km, vm = (torch.randn((B, S, n, hd), generator=gen, device=dev)
                  .to(torch.bfloat16) for n in (H, KV, KV))
    ms, got = timer(lambda: ops.mha_forward(qm, km, vm, prefix_len=P))
    q = qm.reshape(B, S, KV, H // KV, hd).permute(0, 2, 3, 1, 4)
    plain_ms, want = timer(lambda: ref.flash_attention_ref(
        q, km.transpose(1, 2), vm.transpose(1, 2), prefix_len=P), reps=1,
        warmup=1)
    got = got.reshape(B, S, KV, H // KV, hd).permute(0, 2, 3, 1, 4)
    ratio, err = close(torch, got, want)
    sdpa = dict(is_causal=True)
    if P:
        sdpa = dict(attn_mask=ref.flash_mask(S, S, prefix_len=P, device=dev))
    lib_ms, lib = timer(lambda: F.scaled_dot_product_attention(
        qm.transpose(1, 2), km.transpose(1, 2), vm.transpose(1, 2),
        enable_gqa=True, **sdpa))
    lib = lib.reshape(B, KV, H // KV, S, hd)
    lib_ratio, lib_err = err_ratio(torch, lib, want)
    # the wrapper's own reckoning: 4 hd flops a query head for each visible
    # (query, key) pair; q, k, v read and the output written
    flops, bytes_, bound, _ = flash_bound(q, km.transpose(1, 2), P)
    padded = ""
    if Gp != G:
        live = qm.reshape(B, S, KV, Gp, hd)[:, :, :, :G].reshape(
            B, S, KV * G, hd).contiguous()
        live_ms, _ = timer(lambda: ops.mha_forward(live, km, vm,
                                                   prefix_len=P))
        padded = (f"; {Gp - G} of the {Gp} q-groups are padding (dead "
                  f"heads): the live {G} alone take {live_ms:.4f} ms")
    log(f"({phase}) flash kernel ({kernel_path(qm.dtype, hd)}) at the prefill "
        f"layer shape (q {tuple(qm.shape)}, "
        f"k/v {tuple(km.shape)}, prefix {P}, bfloat16): {ms:.4f} ms per "
        f"layer call; plain {plain_ms:.4f} ms; scaled_dot_product_attention("
        f"{'is_causal' if not P else 'the prefix mask'}, "
        f"enable_gqa) {lib_ms:.4f} ms (|err| vs plain {lib_err:.3g}, / limit "
        f"{lib_ratio:.3g}); bound {bound:.4f} ms "
        f"({flops} flops at 989 TFLOP/s, {bytes_} B at 3.35 TB/s); kernel "
        f"|err| vs plain {err:.3g} (/ limit {ratio:.3g}); "
        f"{flops / ms / 1e9:.1f} TFLOP/s achieved, "
        f"{100 * bound / ms:.1f}% of the bound" + padded)
    return ("flash_attention", "src/repro/kernels/flash_attention.py:122",
            ms, plain_ms, bytes_, err, lib_ms, flops)


def measure_decode(torch, mres, timer, phase="h", c=MODEL_CONFIG) -> None:
    """The two decode kernels at the decode layer shape of ``phase``'s
    model (``mres["cfg"]``; (h): 8 sequences x 8 kv heads, G 4, hd 128),
    without a window, on seeded bfloat16 operands: ``c``'s batch of
    prompt + steps/2 old tokens in an S_cap-2112 view and, for the paged
    kernel, the same rows in shuffled 16-token blocks, the self row folded
    in.  Logs each kernel's time, its plain version's, its bound and, for
    the shortcut kernel, ``scaled_dot_product_attention`` over the view with
    the self row written in (a copy); the routes bitwise equal; and both
    split lengths."""
    import torch.nn.functional as F
    from repro_torch.kernels import _decode, ops, ref
    cfg = mres["cfg"]
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
    assert torch.equal(short, paged), f"({phase}) decode layer: routes differ"
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
    cost_s = _decode.cost(qk, vk.transpose(1, 2), lens, None, s_cap, None,
                          True)
    cost_p = _decode.cost(qk, kp.transpose(1, 2), lens, tables, bs, None,
                          True)
    launches = {r + "_attention": mres["decode_launches"] * c["steps"]
                for r in mres.get("routes", ("shortcut", "paged"))}
    log(f"({phase}) decode kernels at the decode layer shape (q "
        f"{tuple(q.shape)}, "
        f"{n_old} old tokens + the self row per sequence, S_cap {s_cap}, "
        f"block {bs}; launches: the {c['steps']} decode steps): shortcut == "
        f"paged bit for bit; scaled_dot_product_attention |err| / limit "
        f"{lib_ratio:.3g}")
    _row("shortcut_attention", "", "", launches, ms_s, plain_s, cost_s[1],
         err_s, library_ms=lib_ms, phase=phase, flops=cost_s[0])
    _row("paged_attention", "", "", launches, ms_p, plain_p, cost_p[1],
         err_p, phase=phase, flops=cost_p[0])
    log(f"({phase}) decode layer shape, profiler: " + "; ".join((
        device_line("shortcut_attention", *device_ms(
            torch, lambda: ops.decode_shortcut(q, vk, vv, lens, **new))),
        device_line("paged_attention", *device_ms(
            torch, lambda: ops.decode_paged(q, kp, vp, tables, lens,
                                            **new))))))
    log(f"({phase}) decode layer shape, split kernel + combine at each "
        "split length (CUDA events, turns a b b a): " + split_line(split_times(
            torch, timer, qk, vk.transpose(1, 2), vv.transpose(1, 2),
            kp.transpose(1, 2), vp.transpose(1, 2), tables, lens, kn, vn)))


def median(xs) -> float:
    ys = sorted(xs)
    n = len(ys)
    return ys[n // 2] if n % 2 else (ys[n // 2 - 1] + ys[n // 2]) / 2


def traced(busy, n, attn, spans, wall_ms) -> str:
    """A trace's device time against the untraced wall time of the same
    work (tracing itself costs seconds of host time), with the part in the
    decode-attention kernels and in each span of ``profiled``."""
    if busy is None:
        return "no device events in the trace (device time not measured)"
    parts = "".join(
        f"; {name} {ms:.4f} ms ({100 * ms / busy:.1f}% of busy)" if ms
        else f"; {name} not measured (no device annotation of the span)"
        for name, ms in spans.items())
    return (f"device busy {busy:.4f} ms ({attn:.4f} ms in the decode-"
            f"attention kernels, {busy - attn:.4f} ms in the rest{parts}), "
            f"{n} kernels and copies; {100 * (1 - busy / wall_ms):.1f}% idle "
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


# (j): the MoE, SSM and hybrid families (src/repro_torch/configs/) at full
# width and depth, weights drawn from --seed on the card, each a small
# server answering 8 requests in bfloat16 as (h)'s: 8 prompts of 2048 seeded
# tokens, 32 greedy tokens, S_cap 2112.  Per model: its routes (the paged
# route serves attention-only models), the port's kernel launches per
# prefill (flash, one an attention layer) and per decode step (the decode
# kernels' two an attention layer; mamba2 has no attention, so no kernel of
# the port runs in it), and the prompts its float32 check run holds
# (qwen2_moe's float32 weights take 57 GB)
FAMILY_CONFIG = dict(batch=8, prompt=2048, steps=32, block=16, s_cap=2112)
FAMILY_MODELS = {
    "qwen2_moe_a2_7b": (("shortcut", "paged"), 24, 48, 2),
    "hymba_1_5b": (("shortcut",), 32, 64, 8),
    "mamba2_370m": (("shortcut",), 0, 0, 8),
    # PaliGemma's decoder (18 layers, d 2048, 8 heads over 1 KV head x 256,
    # gelu MLP 16384, vocab 257216): each prompt 256 seeded patch
    # embeddings and 1792 tokens, so the prefill has the same 8 x 2048
    # positions; both routes
    "paligemma_3b": (("shortcut", "paged"), 18, 36, 8),
}
# (j): bfloat16 decode logits cannot be held to a full forward at these
# depths with random weights: the models amplify a rounding, so that one
# bfloat16 ulp of the embedding moves their logits by about as much as the
# decode differs (the run measures both).  So the check holds a float32 run
# of the same path (prefill, the decode steps, the decode kernels) to a
# float32 full forward over prompt + fed tokens.  Its limit, as
# LOGIT_LIMIT's: a rounding moves an activation by 2^-24 / sqrt(3) (RMS),
# n of them about sqrt(n) times that, each amplified at most as a change of
# the embedding is (the run measures that gain, ``sensitivity``), and three
# times that.  Roundings a layer (PERF.md counts them): qwen2_moe 20
# (attention 6, the routed experts and the shared MLP 14), hymba 24
# (attention 6, SSM 12, MLP 4, the mix and the residual 2), mamba2 13 (SSM
# 12, the residual), paligemma 12 (attention 6, the gelu MLP 4, the two
# residual sums 2).  A decode with the rope position off by one, from a
# zeroed SSM state, or with the top-k weights left un-renormalized goes
# past it.  For paligemma the same limit also holds the float32 prefill's
# logits to those of a forward whose attention is the plain version with
# the prefix, and the same forward with the prefix dropped goes past it
FAMILY_ROUNDINGS = {"qwen2_moe_a2_7b": 20, "hymba_1_5b": 24,
                    "mamba2_370m": 13, "paligemma_3b": 12}
F32_ROUNDING = 2 ** -24 / 3 ** 0.5
# (j): the largest share of the float32 decode steps' top-k choices that
# may differ from the full forward's own at the same position: ties at
# float32 rounding flip far fewer (the run prints them); a decode router
# that reads other inputs or other weights flips most
FLIP_SHARE_LIMIT = 0.01


def family_limit(arch: str, layers: int, sensitivity: float,
                 rounding: float = F32_ROUNDING) -> float:
    return 3 * (FAMILY_ROUNDINGS[arch] * layers) ** 0.5 * rounding \
        * sensitivity


# a bfloat16 rounding (RMS), as LOGIT_LIMIT counts it: 2^-9 / sqrt(3)
BF16_ROUNDING = 2 ** -9 / 3 ** 0.5


class RouteLog:
    """While active, records the top-k choices (top_i) the port's MoE
    router (``moe.route``) makes at each call; with ``renormalize=False`` it
    hands the layer the top-k probabilities as they are (a wrong MoE); with
    ``force`` (one (B, S, K) tensor per call) the layer takes those experts
    instead, weighted by its own probabilities, renormalized."""

    def __init__(self, moe, renormalize: bool = True, force=None):
        self.moe, self.renormalize, self.force = moe, renormalize, force
        self.calls = []

    def __enter__(self):
        self.orig = self.moe.route
        self.moe.route = self.route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.orig

    def route(self, p, x, cfg):
        probs, top_w, top_i = self.orig(p, x, cfg)
        self.calls.append(top_i)
        if self.force is not None:
            top_i = self.force[len(self.calls) - 1]
            top_w = probs.gather(-1, top_i)
            top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
        elif not self.renormalize:
            top_w = probs.gather(-1, top_i)
        return probs, top_w, top_i


def dropped_pairs(torch, calls, E: int, C: int) -> list:
    """Per MoE call (a layer), the (token, choice) pairs past their expert's
    capacity ``C``, summed over the batch rows."""
    out = []
    for top_i in calls:
        flat = top_i.reshape(top_i.shape[0], -1)
        counts = torch.zeros((flat.shape[0], E), dtype=torch.int64,
                             device=flat.device)
        counts.scatter_add_(1, flat, torch.ones_like(flat))
        out.append(int((counts - C).clamp_min(0).sum()))
    return out


def routing_flips(a, b) -> int:
    """Choices in ``a`` (..., K) absent from the same row's ``b``."""
    return int((~(a[..., :, None] == b[..., None, :]).any(-1)).sum())


def fed_flips(step_routes, own, L: int, P: int, steps: int) -> int:
    """The decode steps' top-k choices (``step_routes``: a call a layer, a
    step after another) absent from a full forward's own (``own``: a
    (B, P + steps, K) call a layer) at the same position."""
    assert len(own) == L and len(step_routes) == steps * L
    return sum(routing_flips(step_routes[t * L + j][:, 0], own[j][:, P + t])
               for t in range(steps) for j in range(L))


def bumped_embed(torch, params, seed: int) -> float:
    """Moves half the embedding's entries (seeded) away from zero by one ulp
    of its dtype, in place; returns the relative size of the change."""
    e = params["embed"]
    gen = torch.Generator(device=e.device).manual_seed(seed)
    pick = torch.rand(e.shape, generator=gen, device=e.device) < 0.5
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[e.dtype]
    old = e.to(torch.float32, copy=True)
    e.view(ints).add_(pick.to(ints))
    return float((e.float() - old).norm() / old.norm())


def serve_family(torch, cfg, params, toks, routes, spans, dtype,
                 timed: bool, variants=(), log_routes: bool = False,
                 c=FAMILY_CONFIG, prefix=None) -> dict:
    """The server run of one model ((h), (j)): ``make_prefill_step`` (three
    calls when ``timed``: a warm-up, a timed one and a traced one; else
    one), then ``c``'s steps of greedy decode per route (timed: host clock
    and CUDA events a step, step 2 traced; the paged route over a cache
    written from the prefill).  Each prefill and each step is held to its
    launches of the port's kernels.  At the last step the route's logits
    as the step computes them, and on the shortcut route those of the wrong
    ``variants``.  With ``log_routes``, the MoE router's choices in the
    first prefill and in each route's steps.  ``prefix``: a prefix model's
    patch embeddings (B, prefix_len, D) in front of ``toks``."""
    from repro_torch.kernels import _build, _decode
    from repro_torch.kvcache import paged_cache as pc
    from repro_torch.models import model as M
    from repro_torch.models import moe, ssm
    from repro_torch.runtime import serve
    dev = toks.device
    steps, bs, s_cap = (c[k] for k in ("steps", "block", "s_cap"))
    batch = {"tokens": toks}
    if prefix is not None:
        batch["prefix_embeddings"] = prefix
    # positions in the context after prefill
    P = toks.shape[1] + (0 if prefix is None else prefix.shape[1])
    B, L = toks.shape[0], cfg.num_layers
    flash_n = L if cfg.has_attention else 0
    decode_n = _decode.KERNELS_PER_CALL * L if cfg.has_attention else 0
    out = {"prefill_s": [], "prefill_routes": []}
    prefill = serve.make_prefill_step(cfg, s_cap, dtype)
    calls = 3 if timed else 1
    _build.reset_launches()
    for i in range(calls):
        state = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 2:
            (logits, state), *out["prefill_trace"] = profiled(
                torch, lambda: prefill(params, batch), spans)
        elif i == 0 and log_routes:
            with RouteLog(moe) as rl:
                logits, state = prefill(params, batch)
            out["prefill_routes"] = rl.calls
        else:
            logits, state = prefill(params, batch)
        torch.cuda.synchronize()
        out["prefill_s"].append(time.perf_counter() - t0)
    want = {"flash_attention": calls * flash_n} if flash_n else {}
    got = _build.launches()
    assert got == want, f"(j) {cfg.name}: prefill launches {got}, " \
        f"expected {want}"
    out["prefill_launches"] = flash_n
    assert torch.isfinite(logits.float()).all(), f"(j) {cfg.name}: prefill"
    assert logits.shape == (B, cfg.vocab_size)
    assert state.ctx_len.tolist() == [P] * B
    out["prefill_logits"] = logits
    if cfg.has_attention:
        assert state.view_k.shape == (L, B, cfg.num_kv_heads, s_cap,
                                      cfg.resolved_head_dim)
    if cfg.has_ssm:
        assert state.ssm_state.dtype == torch.float32
        assert state.ssm_conv.shape == (L, B, cfg.ssm_conv - 1,
                                        cfg.ssm_d_inner + 2 * cfg.ssm_state)
    tok0 = torch.argmax(logits, dim=-1).to(torch.int32)
    ids = torch.arange(B, device=dev)
    cache = None
    if "paged" in routes:
        MB = s_cap // bs
        cache = pc.cache_create(L, B * MB, bs, cfg.num_kv_heads,
                                cfg.resolved_head_dim, B, MB, dtype,
                                device=dev)
        cache = pc.write_prefill(cache, ids, state.view_k[:, :, :, :P]
                                 .transpose(2, 3), state.view_v[:, :, :, :P]
                                 .transpose(2, 3))

    def last_logits(route, tok, st, variant=None):
        """The step's logits at its last step, as it computes them, or a
        wrong variant's on the same context."""
        if route == "shortcut":
            ssm_ctx = ssm.SSMCache(st.ssm_conv, st.ssm_state) \
                if cfg.has_ssm else ()
            if variant == "SSM state zeroed":
                ssm_ctx = ssm_ctx._replace(
                    state=torch.zeros_like(st.ssm_state))
            ctx = M.LayerCache(k=st.view_k, v=st.view_v, ssm=ssm_ctx)
            inc = st.ctx_len + 1
        else:
            ctx = M.PagedContext(k_pool=st.k_pool, v_pool=st.v_pool,
                                 block_tables=st.block_tables[ids])
            inc = st.seq_lens[ids] + 1
        positions = inc if variant == "rope position off by one" else None
        with RouteLog(moe, renormalize=variant != "top-k weights not "
                      "renormalized"):
            return M.decode_step(params, cfg, tok, ctx, inc,
                                 positions=positions)[0]

    step_fns = {"shortcut": serve.make_serve_step(cfg)}
    if "paged" in routes:
        step_fns["paged"] = serve.make_paged_serve_step(cfg)
    for route in routes:
        step = step_fns[route]
        st = state if route == "shortcut" else cache
        kernel = route + "_attention"
        tok, fed, secs, ev_ms = tok0, [tok0], [], []
        for i in range(steps):
            if i == steps - 1:
                out[route + "_logits"] = last_logits(route, tok, st)
                if route == "shortcut":
                    out["wrong_logits"] = {
                        v: last_logits(route, tok, st, v) for v in variants}

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
            with RouteLog(moe) as rl:
                if timed and i == 1:    # one step traced (not in the mean)
                    (tok, st), *out[route + "_trace"] = profiled(
                        torch, run, spans)
                else:
                    tok, st = run()
            ev1.record()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            ev_ms.append(ev0.elapsed_time(ev1))
            got = _build.launches()
            want = {kernel: decode_n} if decode_n else {}
            assert got == want, f"(j) {cfg.name} {route} step {i}: " \
                f"launches {got}, expected {want}"
            fed.append(tok)
            if log_routes:
                out.setdefault(route + "_routes", []).extend(rl.calls)
        assert torch.equal(
            tok, torch.argmax(out[route + "_logits"], dim=-1).to(tok.dtype)
        ), f"(j) {cfg.name} {route}: the step's token is not its argmax"
        out[route] = torch.stack(fed, dim=1)
        out[route + "_step_s"] = secs
        out[route + "_step_ev"] = ev_ms
        if route == "paged":
            assert int(st.seq_lens.min()) == P + steps
        del st
    out["decode_launches"] = decode_n
    return out


def full_forward(torch, cfg, params, toks, fed, force=None,
                 prefix=None) -> tuple:
    """The last-position logits of a full forward over (prefix +) prompt +
    the fed tokens (the steps' input), and the MoE router's own choices per
    layer; ``force``: the experts each layer takes instead (``RouteLog``)."""
    from repro_torch.models import model as M
    from repro_torch.models import moe
    batch = {"tokens": torch.cat([toks, fed.long()], dim=1)}
    if prefix is not None:
        batch["prefix_embeddings"] = prefix
    with RouteLog(moe, force=force) as rl:
        want, _ = M.prefill_forward(params, cfg, batch)
    return want, rl.calls


def plain_attention(prefix: int):
    """A stand-in for ``models.attention.blockwise_attention`` (same
    arguments) that attends through the flash kernel's plain version,
    ``ref.flash_attention_ref``, with a prefix of ``prefix`` positions (the
    call's own ``prefix_len`` is ignored): the yardstick of the prefix mask
    on the model path."""
    from repro_torch.kernels import ref

    def attend(q, k, v, *, chunk_q, chunk_kv, causal=True, window=None,
               attn_softcap=None, prefix_len=0):
        del chunk_q, chunk_kv, prefix_len
        B, S, H, hd = q.shape
        KV = k.shape[2]
        qk = q.reshape(B, S, KV, H // KV, hd).permute(0, 2, 3, 1, 4)
        o = ref.flash_attention_ref(qk, k.transpose(1, 2), v.transpose(1, 2),
                                    causal=causal, window=window,
                                    softcap=attn_softcap, prefix_len=prefix)
        return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)
    return attend


def forward_with_attention(cfg, params, batch, attention):
    """The prefill's last-position logits with every layer's prefill
    attention replaced by ``attention`` for this call only."""
    from repro_torch.models import attention as attn
    from repro_torch.models import model as M
    kernel = attn.blockwise_attention
    attn.blockwise_attention = attention
    try:
        return M.prefill_forward(params, cfg, batch)[0]
    finally:
        attn.blockwise_attention = kernel


def phase_family(torch, args, arch: str, timer) -> dict:
    """(j), one model.  Served in bfloat16 (timed) on its routes at its
    published capacity factor: the routes' tokens identical and their
    last-step logits equal bit for bit; the decode logits' distance from a
    full forward, and the full forward's own change under one bfloat16 ulp
    of the embedding, both logged.  Then the check run in float32 (weights
    drawn from --seed, its first prompts; for an MoE at capacity factor
    E / top_k, where no pair can drop): the last-step decode logits within
    ``family_limit`` of a float32 full forward over prompt + fed tokens (an
    MoE's routed to the experts the prefill and the steps chose, which
    differ from its own choices in at most ``FLIP_SHARE_LIMIT`` of them),
    each wrong variant past it.  Then the flash and decode kernels at the
    model's layer shapes."""
    import dataclasses
    from repro_torch.configs import get
    from repro_torch.models import model as M
    from repro_torch.models import moe, ssm
    dev = torch.device("cuda")
    c = FAMILY_CONFIG
    B, P, steps = c["batch"], c["prompt"], c["steps"]
    routes, flash_n, decode_n, n_check = FAMILY_MODELS[arch]
    cfg = get(arch)
    L = cfg.num_layers
    res = {"arch": arch, "cfg": cfg, "routes": routes, "n_check": n_check}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, args.seed, torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    res["init_s"] = time.perf_counter() - t0
    res["n_params"] = sum(t.numel() for t in _leaves(params))
    gen = torch.Generator(device=dev).manual_seed(args.seed + 8)
    # a prefix model's prompt: its patch embeddings (normal, times 0.02, as
    # repro/launch/serve.py draws them), then the tokens
    n_prefix = cfg.prefix_len if cfg.input_mode == "prefix_embeddings" else 0
    toks = torch.randint(0, cfg.vocab_size, (B, P - n_prefix), generator=gen,
                         device=dev)
    prefix = None
    if n_prefix:
        prefix = torch.randn((B, n_prefix, cfg.d_model), generator=gen,
                             device=dev) * 0.02
    log(f"(j) {arch}: {L} layers, d {cfg.d_model}, heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads} x {cfg.resolved_head_dim}, window "
        f"{cfg.sliding_window} (global layers {cfg.global_layers}), d_ff "
        f"{cfg.d_ff}, experts {cfg.num_experts} top {cfg.top_k} x "
        f"{cfg.moe_d_ff} + shared {cfg.shared_d_ff} (capacity factor "
        f"{cfg.capacity_factor}), SSM state {cfg.ssm_state} x heads "
        f"{cfg.ssm_heads if cfg.has_ssm else 0} x {cfg.ssm_head_dim} (chunk "
        f"{cfg.ssm_chunk}), vocab {cfg.vocab_size}, prefix {n_prefix} patch "
        f"embeddings + {P - n_prefix} tokens a prompt, q-groups padded to "
        f"{cfg.pad_q_groups or cfg.num_heads // max(cfg.num_kv_heads, 1)}; "
        f"{res['n_params']} parameters (bfloat16; router, A_log, D, dt_bias "
        f"float32) drawn on the card in {res['init_s']:.3f} s")
    spans = tuple(name for name, on in ((moe.SPAN, cfg.num_experts),
                                        (ssm.SPAN, cfg.has_ssm)) if on)
    variants = tuple(name for name, on in (
        ("rope position off by one", cfg.has_attention),
        ("SSM state zeroed", cfg.has_ssm),
        ("top-k weights not renormalized", cfg.num_experts)) if on)
    served = serve_family(torch, cfg, params, toks, routes, spans,
                          torch.bfloat16, timed=True,
                          log_routes=bool(cfg.num_experts), prefix=prefix)
    assert served["prefill_launches"] == flash_n
    assert served["decode_launches"] == decode_n
    if "paged" in routes:
        assert torch.equal(served["shortcut"], served["paged"]), \
            f"(j) {arch}: the routes decoded different tokens"
        assert torch.equal(served["shortcut_logits"],
                           served["paged_logits"]), \
            f"(j) {arch}: the routes' last-step logits differ in bits"
    torch.cuda.synchronize()
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    res["served"] = served
    if cfg.num_experts:
        res["served_C"] = moe.moe_capacity(cfg, P)
        res["dropped"] = dropped_pairs(
            torch, served["prefill_routes"], cfg.num_experts,
            res["served_C"])
        res["pairs"] = B * P * cfg.top_k
        del served["prefill_routes"]
    # the check runs' config: an MoE at capacity factor E / top_k, where no
    # pair drops (at 1.25 the full forward drops others than the steps)
    check_cfg = cfg
    if cfg.num_experts:
        check_cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.num_experts / cfg.top_k)
        res["check_C"] = (moe.moe_capacity(check_cfg, P),
                          moe.moe_capacity(check_cfg, 1),
                          moe.moe_capacity(check_cfg, P + steps))
    # bfloat16: the decode's distance from a full forward, the full
    # forward's change under one ulp of the embedding, and the top-k choices
    # that differ (ties); an MoE served again at the check's capacity
    bf = served
    if cfg.num_experts:
        bf = serve_family(torch, check_cfg, params, toks, ("shortcut",), (),
                          torch.bfloat16, timed=False, log_routes=True,
                          prefix=prefix)
    fed = bf["shortcut"][:, :steps]
    want, own = full_forward(torch, check_cfg, params, toks, fed,
                             prefix=prefix)
    res["bf16_error"] = rel_rms(torch, bf["shortcut_logits"], want)
    if cfg.num_experts:
        res["bf16_flips"] = fed_flips(bf["shortcut_routes"], own, L, P,
                                      steps)
        res["bf16_choices"] = steps * L * B * cfg.top_k
    res["bf16_bump"] = bumped_embed(torch, params, args.seed + 11)
    bumped, _ = full_forward(torch, check_cfg, params, toks, fed,
                             prefix=prefix)
    res["bf16_moved"] = rel_rms(torch, bumped, want)
    # LOGIT_LIMIT's count at this model's roundings and measured gain: where
    # it stays under LOGIT_LIMIT, the bfloat16 decode is held to
    # LOGIT_LIMIT as (h)'s is
    res["bf16_gain"] = res["bf16_moved"] / res["bf16_bump"]
    res["bf16_count"] = family_limit(arch, L, res["bf16_gain"],
                                     BF16_ROUNDING)
    del params, want, bumped, bf, own
    gc.collect()
    torch.cuda.empty_cache()

    # the check run in float32
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, args.seed, torch.float32, device=dev)
    ctoks = toks[:n_check]
    cprefix = None if prefix is None else prefix[:n_check]
    check = serve_family(torch, check_cfg, params, ctoks, ("shortcut",), (),
                         torch.float32, timed=False, variants=variants,
                         log_routes=bool(cfg.num_experts), prefix=cprefix)
    fed = check["shortcut"][:, :steps]
    force = None
    if cfg.num_experts:
        # each position routed as the served computation routed it: the
        # prompt by the prefill, each fed token by its step
        force = [torch.cat([check["prefill_routes"][j]] + [
            check["shortcut_routes"][t * L + j] for t in range(steps)],
            dim=1) for j in range(L)]
    want, own = full_forward(torch, check_cfg, params, ctoks, fed, force,
                             prefix=cprefix)
    if n_prefix:
        # the prefill through the kernels against a forward whose attention
        # is the plain version with the prefix, and the same forward with
        # the prefix dropped
        batch = {"tokens": ctoks, "prefix_embeddings": cprefix}
        yard = forward_with_attention(check_cfg, params, batch,
                                      plain_attention(n_prefix))
        dropped = forward_with_attention(check_cfg, params, batch,
                                         plain_attention(0))
        res["prefix"] = {
            "kernels": rel_rms(torch, check["prefill_logits"], yard),
            "prefix dropped": rel_rms(torch, dropped, yard)}
        del yard, dropped
    bump = bumped_embed(torch, params, args.seed + 11)
    bumped, _ = full_forward(torch, check_cfg, params, ctoks, fed, force,
                             prefix=cprefix)
    res["f32_bump"] = bump
    res["f32_moved"] = rel_rms(torch, bumped, want)
    res["sensitivity"] = res["f32_moved"] / bump
    res["limit"] = family_limit(arch, L, res["sensitivity"])
    del bumped
    if cfg.num_experts:
        res["flips_fed"] = fed_flips(check["shortcut_routes"], own, L, P,
                                     steps)
        res["flips_prompt"] = sum(
            routing_flips(check["prefill_routes"][j], own[j][:, :P])
            for j in range(L))
        res["flips_last"] = [
            routing_flips(check["shortcut_routes"][(steps - 1) * L + j][:, 0],
                          own[j][:, P + steps - 1]) for j in range(L)]
        res["choices"] = (steps * L * n_check * cfg.top_k,
                          L * n_check * P * cfg.top_k)
    res["errors"] = {"shortcut": rel_rms(torch, check["shortcut_logits"],
                                         want)}
    res["wrong"] = {v: rel_rms(torch, lg, want)
                    for v, lg in check["wrong_logits"].items()}
    res["want_rms"] = float(want.float().square().mean().sqrt())
    res["check_peak_bytes"] = torch.cuda.max_memory_allocated()
    log_family_checks(res)
    for r, e in res["errors"].items():
        if not e <= res["limit"]:
            raise AssertionError(
                f"(j) {arch} {r} float32 decode logits off the full forward "
                f"by {e} (relative RMS) > {res['limit']}")
    for v, e in res["wrong"].items():
        if not e > res["limit"]:
            raise AssertionError(
                f"(j) {arch}: a float32 decode with the {v} is within the "
                f"limit: {e} <= {res['limit']}")
    assert set(res["wrong"]) == set(variants), res["wrong"]
    if res["bf16_count"] <= LOGIT_LIMIT and \
            not res["bf16_error"] <= LOGIT_LIMIT:
        raise AssertionError(
            f"(j) {arch}: bfloat16 decode logits off the full forward by "
            f"{res['bf16_error']} (relative RMS) > {LOGIT_LIMIT}")
    if n_prefix:
        if not res["prefix"]["kernels"] <= res["limit"]:
            raise AssertionError(
                f"(j) {arch}: float32 prefill logits off the plain-attention "
                f"forward by {res['prefix']['kernels']} > {res['limit']}")
        if not res["prefix"]["prefix dropped"] > res["limit"]:
            raise AssertionError(
                f"(j) {arch}: the plain-attention forward with the prefix "
                f"dropped is within the limit: "
                f"{res['prefix']['prefix dropped']} <= {res['limit']}")
    if cfg.num_experts:
        share = res["flips_fed"] / res["choices"][0]
        if not share <= FLIP_SHARE_LIMIT:
            raise AssertionError(
                f"(j) {arch}: {res['flips_fed']} of the float32 decode "
                f"steps' {res['choices'][0]} top-k choices differ from the "
                f"full forward's (> {FLIP_SHARE_LIMIT})")
    del params, want, check, own, force
    gc.collect()
    torch.cuda.empty_cache()
    if cfg.has_attention:
        kres = {"cfg": cfg, "decode_launches": decode_n, "routes": routes}
        measure_flash(torch, kres, timer, "j", FAMILY_CONFIG)
        measure_decode(torch, kres, timer, "j", FAMILY_CONFIG)
    return res


def log_family_checks(res) -> None:
    """(j)'s check lines for one model, logged before its asserts so that a
    failing run shows every number."""
    arch, cfg, n = res["arch"], res["cfg"], res["n_check"]
    if "dropped" in res:
        d, (cp, cd, cf) = res["dropped"], res["check_C"]
        log(f"(j) {arch}: the served prefill (capacity factor "
            f"{cfg.capacity_factor}, C {res['served_C']} a row) dropped "
            f"{sum(d)} of {res['pairs'] * len(d)} (token, choice) pairs over "
            f"{len(d)} layers (most in a layer {max(d)}); the float32 check "
            f"run at capacity factor {cfg.num_experts / cfg.top_k} (C {cp} at "
            f"prefill, {cd} a decode step, {cf} in the full forward: no pair "
            f"drops): its decode steps' top-k choices absent from the full "
            f"forward's own at the same position {res['flips_fed']} of "
            f"{res['choices'][0]} (limit {FLIP_SHARE_LIMIT} of them; the "
            f"last step, per layer: {res['flips_last']}), its prefill's "
            f"{res['flips_prompt']} of {res['choices'][1]}; the full forward "
            f"takes the prefill's and the steps' choices")
    flips = "" if "bf16_flips" not in res else (
        f"; its decode steps' top-k choices absent from the full forward's "
        f"at the same position: {res['bf16_flips']} of "
        f"{res['bf16_choices']} (bfloat16 ties)")
    run = "served run" if "bf16_flips" not in res else (
        f"run at capacity factor {cfg.num_experts / cfg.top_k}")
    held = ("under it: the bfloat16 decode is held to LOGIT_LIMIT"
            if res["bf16_count"] <= LOGIT_LIMIT else
            "past it: the float32 run below is the check")
    log(f"(j) {arch}: bfloat16 {run}, last-step logits off a bfloat16 "
        f"full forward by {res['bf16_error']:.4g} (relative RMS); the full "
        f"forward itself moves by {res['bf16_moved']:.4g} when one ulp of "
        f"the embedding moves ({res['bf16_bump']:.3g} of it): gain "
        f"{res['bf16_gain']:.4g}, so LOGIT_LIMIT's count at this model's "
        f"roundings is {res['bf16_count']:.4g} against LOGIT_LIMIT "
        f"{LOGIT_LIMIT}, {held}" + flips)
    log(f"(j) {arch}: float32 check run ({n} of the prompts), last-step "
        f"logits off the float32 full forward (logit RMS "
        f"{res['want_rms']:.4f}): "
        + ", ".join(f"{r} {v:.4g}" for r, v in res["errors"].items())
        + f"; limit {res['limit']:.4g} (gain {res['sensitivity']:.4g}: the "
        f"full forward moves by {res['f32_moved']:.3g} when one ulp of the "
        f"embedding moves, {res['f32_bump']:.3g} of it); wrong variants "
        + ", ".join(f"{v} {x:.4g}" for v, x in res["wrong"].items()))
    if "prefix" in res:
        log(f"(j) {arch}: float32 prefill's last-position logits off a "
            f"forward whose attention is the plain version with the prefix "
            f"({cfg.prefix_len}): {res['prefix']['kernels']:.4g}; that "
            f"forward with the prefix dropped: "
            f"{res['prefix']['prefix dropped']:.4g}; limit "
            f"{res['limit']:.4g}")


def report_family(res, smi) -> None:
    """(j)'s report lines for one model."""
    c = FAMILY_CONFIG
    B, P, steps = c["batch"], c["prompt"], c["steps"]
    arch, sv = res["arch"], res["served"]
    pre = sv["prefill_s"][1]
    log(f"(j) {arch} prefill ({B} x {P} tokens, warm): {pre * 1e3:.4f} ms, "
        f"{B * P / pre:.1f} tokens/s (first call "
        f"{sv['prefill_s'][0] * 1e3:.4f} ms); flash launches "
        f"{sv['prefill_launches']} per prefill; card {smi}; third prefill "
        "traced: " + traced(*sv["prefill_trace"], pre * 1e3))
    for route in res["routes"]:
        secs = sv[route + "_step_s"][2:]
        ev = sv[route + "_step_ev"][2:]
        mean = sum(secs) / len(secs)
        log(f"(j) {arch} decode, {route} route: {mean * 1e3:.4f} ms per step "
            f"(mean of steps 3-{steps}, host clock + sync; median "
            f"{median(secs) * 1e3:.4f}, min {min(secs) * 1e3:.4f}, max "
            f"{max(secs) * 1e3:.4f}; CUDA events around the step: median "
            f"{median(ev):.4f}, min {min(ev):.4f}, max {max(ev):.4f}), "
            f"{B / mean:.1f} tokens/s; {sv['decode_launches']} "
            f"{route}_attention launches per step"
            + (" (no attention layer: no kernel of the port runs)"
               if not sv["decode_launches"] else "")
            + "; step 2 traced: " + traced(*sv[route + "_trace"], mean * 1e3))
    if "paged" in res["routes"]:
        log(f"(j) {arch}: tokens identical across routes ({B} x "
            f"{steps + 1}); last-step logits equal bit for bit")
    log(f"(j) {arch}: max_memory_allocated {res['peak_bytes']} B over init, "
        f"prefill and decode (bfloat16); {res['check_peak_bytes']} B in the "
        f"float32 check run")


# (k): the port's example twins (examples/*_torch.py), each run at its own
# defaults through its main() on the card, and the kernels each must have
# launched: the index twins insert and look up through the shortcut (the
# mixed workload's waves replay updates), the serving twin prefills and
# decodes on both routes
TWINS = {"quickstart_torch": ("eh_insert", "shortcut_lookup"),
         "mixed_workload_torch": ("eh_insert", "ragged_copy"),
         "serve_paged_torch": ("flash_attention", "shortcut_attention",
                               "paged_attention")}


def run_twin(torch, name: str, argv: list) -> tuple:
    """``examples/<name>.py``'s ``main(argv)`` with the launch counts set to
    0 just before it and read just after: (its standard output, its wall
    seconds, the launch counts); each printed line logged."""
    import contextlib
    import importlib.util
    import io
    from repro_torch.kernels import _build
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        mod.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = _build.launches()
    for line in buf.getvalue().splitlines():
        log(f"(k) {name}: {line}")
    log(f"(k) {name}: {secs:.3f} s; launches {got}")
    return buf.getvalue(), secs, got


def phase_twins(torch) -> None:
    """(k): each twin of ``TWINS`` at its defaults; the serving twin must
    print that its two access paths gave identical outputs."""
    for name, kernels in TWINS.items():
        out, _, got = run_twin(torch, name, [])
        missing = [k for k in kernels if not got.get(k)]
        assert not missing, f"(k) {name}: no launch of {missing}"
        if name == "serve_paged_torch":
            assert "outputs identical across paths" in out, \
                f"(k) {name}: no 'outputs identical across paths' line"


def phase_train_twin(torch) -> None:
    """(k): ``examples/train_small_torch.py`` at its defaults (qwen3_100m,
    300 steps of 8 x 256 tokens, float32) into a fresh checkpoint
    directory: its last logged loss below its first, and no kernel of the
    port launched (training attends through the loop); then a second call
    on the same directory, which must resume from step 300."""
    import tempfile
    name = "train_small_torch"
    tmp = tempfile.mkdtemp(prefix="repro_train_small_")
    try:
        out, _, got = run_twin(torch, name, ["--ckpt-dir", tmp])
        losses = [float(x) for x in re.findall(
            r"\[train\] step +\d+ loss +(\S+)", out)]
        log(f"(k) {name}: first logged loss {losses[0]}, last "
            f"{losses[-1]} ({len(losses)} logged)")
        assert losses[-1] < losses[0], f"(k) {name}: the loss did not fall"
        assert not got, f"(k) {name}: launched {got}"
        out, _, _ = run_twin(torch, name, ["--ckpt-dir", tmp])
        assert "resumed from step 300" in out, \
            f"(k) {name}: no 'resumed from step 300' line"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_families(torch, args, timer, smi) -> None:
    """(j): each model of ``FAMILY_MODELS`` in turn, each freed before the
    next, so that each reports its own peak memory."""
    for arch in FAMILY_MODELS:
        res = phase_family(torch, args, arch, timer)
        report_family(res, smi)
        del res
        gc.collect()
        torch.cuda.empty_cache()


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
    "ch_insert": "src/repro/core/baselines.py:323",
    "ht_lookup": "src/repro/core/baselines.py:122",
    "hti_lookup": "src/repro/core/baselines.py:240",
    "ch_lookup": "src/repro/core/baselines.py:351"}
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
# (i): the timed lookups, each through the kernel (the Timer's warm-up and
# timed calls), and so the lookup kernel's launches in a table's run
FIG7_LOOKUP_WARMUP, FIG7_LOOKUP_REPS = 2, 3
# (i): the allocator's statistics logged around each insert batch
FIG7_MEMORY_STATS = ("segment.all.allocated", "num_alloc_retries",
                     "allocated_bytes.all.peak")


def open_windows(torch, table_keys, log2: int, q, chunk: int = 1 << 20):
    """Per chunk of ``q`` (int32 bits): each key's 32 window positions in an
    open table of ``2**log2`` slots, the slots its probe reads (up to the
    first slot that holds the key or is EMPTY, else the whole window) and
    whether it stopped on the key."""
    from repro_torch.core import hashing
    for i in range(0, max(q.numel(), 1), chunk):
        c = q[i:i + chunk]
        pos = hashing.window_positions(hashing.hash_dir(c), log2, 32)
        probed = hashing.bits(table_keys)[pos]
        ok, j = hashing.probe_slot(probed, c)
        at = probed.gather(1, j.long().unsqueeze(1)).squeeze(1)
        yield pos, torch.where(ok, j + 1, 32), ok & (at == c)


def open_probes(torch, table_keys, log2: int, q):
    """Per key of ``q``, the slots its probe reads in an open table and
    whether it stopped on the key (``open_windows``)."""
    lens, hits = [], []
    for _, n_read, hit in open_windows(torch, table_keys, log2, q):
        lens.append(n_read)
        hits.append(hit)
    return torch.cat(lens), torch.cat(hits)


def open_fetches(torch, table_keys, log2: int, q):
    """Per key of ``q``, the distinct ``FETCH_BYTES`` blocks of an open
    table's keys that the slots its probe reads lie in, and whether it
    stopped on the key (``open_windows``)."""
    shift = (FETCH_BYTES // 4).bit_length() - 1
    ar = torch.arange(32, device=q.device)
    blocks, hits = [], []
    for pos, n_read, hit in open_windows(torch, table_keys, log2, q):
        b = torch.where(ar < n_read.unsqueeze(1), pos >> shift, -1)
        b = b.sort(dim=1).values
        blocks.append((b[:, 0] >= 0).long()
                      + ((b[:, 1:] != b[:, :-1]) & (b[:, 1:] >= 0)).sum(1))
        hits.append(hit)
    return torch.cat(blocks), torch.cat(hits)


def open_probed(torch, table_keys, log2: int, q) -> int:
    """Slots the probes of keys ``q`` read in an open table (``open_probes``;
    for a key the table holds, up to its slot)."""
    return int(open_probes(torch, table_keys, log2, q)[0].sum())


def ch_walks(torch, st, q, chunk: int = 1 << 20):
    """Per key of ``q`` (int32 bits), the bucket rows CH's lookup reads
    (its chain to the first hit, or whole), whether it hit, and the
    ``FETCH_BYTES`` blocks of the key rows it must read (each row whole, the
    hit row up to the hit slot)."""
    from repro_torch.core import hashing
    bk = hashing.bits(st.bucket_keys)
    S = bk.shape[1]
    rows, hits, fetches = [], [], []
    for i in range(0, q.numel(), chunk):
        c = q[i:i + chunk]
        cur = st.heads[hashing.dir_slot(hashing.hash_dir(c),
                                        st.table_log2).long()].long()
        n_rows = torch.zeros_like(cur)
        n_fetch = torch.zeros_like(cur)
        hit = torch.zeros_like(cur, dtype=torch.bool)
        live = cur >= 0
        while bool(live.any()):
            idx = live.nonzero().squeeze(1)
            b = cur[idx]
            eq = bk[b] == c[idx].unsqueeze(1)
            found = eq.any(1)
            end = 4 * (b * S + torch.where(found, eq.int().argmax(1) + 1, S))
            n_fetch[idx] += ((end - 1) // FETCH_BYTES
                             - 4 * b * S // FETCH_BYTES + 1)
            n_rows[idx] += 1
            hit[idx] = found
            cur[idx] = torch.where(found, -1, st.next_bucket[b].long())
            live[idx] = cur[idx] >= 0
        rows.append(n_rows)
        hits.append(hit)
        fetches.append(n_fetch)
    return torch.cat(rows), torch.cat(hits), torch.cat(fetches)


def lookup_bytes_baseline(torch, name, st, q) -> int:
    """Bytes the lookup of keys ``q`` in the baseline state ``st`` must
    move: each key read and each result written; for the open tables the
    probed key slots up to the stopping one (``open_probes``) and the value
    on a hit, HTI's second table only for the keys its first misses; for CH
    the chain's head, each bucket row read (whole), each link followed and
    the value on a hit."""
    n = q.numel()
    if name == "ch_lookup":
        rows, hits, _ = ch_walks(torch, st, q)
        S = st.bucket_keys.shape[1]
        return (12 * n + 4 * S * int(rows.sum())
                + 4 * int((rows - hits.long()).sum()) + 4 * int(hits.sum()))
    total = 8 * n
    for keys, log2 in open_tables(name, st):
        lens, hits = open_probes(torch, keys, log2, q)
        total += 4 * int(lens.sum()) + 4 * int(hits.sum())
        q = q[~hits]
    return total


def open_tables(name, st) -> list:
    """The open tables a lookup of ``name`` probes, in order: HT's one;
    HTI's fuller table first (new when ``new_count >= old_count``)."""
    if name == "ht_lookup":
        return [(st.keys, int(st.size_log2))]
    tables = [(st.new_keys, int(st.new_log2)), (st.old_keys, int(st.old_log2))]
    if int(st.new_count) < int(st.old_count):
        tables.reverse()
    return tables


def lookup_sectors_baseline(torch, name, st, q) -> tuple:
    """The random ``FETCH_BYTES``-byte blocks the lookup of keys ``q`` in
    the baseline state ``st`` must fetch from the memory, summed over the
    keys, and per table the keys it finds there.  A block, not a 32-byte
    sector: on a miss the L2 fetches 64 bytes from the memory (the card's
    L2 fetch granularity, which ``tools/random_sector_peak.py`` reads; CH
    ran past a floor counted in sectors).
    Per key: for the open tables the distinct key blocks its probe reads up
    to the stopping slot and the value's block on a hit, HTI's second table
    only for the keys its first misses; for CH the key rows' blocks
    (``ch_walks``), one block for each link followed and the value's on a
    hit, and the heads' blocks the batch reads, each once (the heads, 16 MiB
    at Fig. 7's size, fit in L2; the tables do not).  The keys read and
    results written are a stream, not counted here (``sector_floor_ms``)."""
    if name == "ch_lookup":
        from repro_torch.core import hashing
        rows, hits, row_fetches = ch_walks(torch, st, q)
        links = int((rows - hits.long()).sum())
        shift = (FETCH_BYTES // 4).bit_length() - 1
        heads = hashing.dir_slot(hashing.hash_dir(q), st.table_log2) >> shift
        return (int(heads.unique().numel()) + int(row_fetches.sum()) + links
                + int(hits.sum()), [int(hits.sum())])
    total, found = 0, []
    for keys, log2 in open_tables(name, st):
        blocks, hits = open_fetches(torch, keys, log2, q)
        total += int(blocks.sum()) + int(hits.sum())
        found.append(int(hits.sum()))
        q = q[~hits]
    return total, found


def sector_floor_ms(fetches: int, n: int) -> float:
    """The least time for a lookup of ``n`` keys whose probes touch
    ``fetches`` random 64-byte blocks (``lookup_sectors_baseline``): those
    at the card's measured random-read rate
    (``RANDOM_READS_PER_S``), and the keys read and results written (8
    bytes a key) at its memory rate."""
    return (fetches / RANDOM_READS_PER_S + 8 * n / HBM_BYTES_PER_S) * 1e3


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


class LaunchClock:
    """The host clock at entry to and exit from the insert launchers of
    ``kernels/baselines_insert.py`` (its library's ``*_insert_launch``),
    so that (i) can split a batch's host time into before the launch, the
    launch and the sync after it.  It wraps the library the module loads
    (``baselines_insert._lib``) and changes nothing the call does."""

    def __init__(self, kern):
        self.kern, self.lib_of = kern, kern._lib
        self.start = self.end = None
        kern._lib = lambda: self

    def __getattr__(self, fn):
        f = getattr(self.lib_of(), fn)
        if not fn.endswith("_insert_launch"):
            return f

        def call(*a):
            self.start = time.perf_counter()
            try:
                return f(*a)
            finally:
                self.end = time.perf_counter()
        return call

    def close(self) -> None:
        self.kern._lib = self.lib_of


def phase_fig7(torch, np, args, timer, smi) -> tuple:
    """(i): HT, HTI and CH take (d)'s keys in 16 batches through the
    users' entry points; returns the per-table results and the six kernel
    rows, three inserts and three lookups (launches from this phase)."""
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

    # name, kernel, create, insert, lookup (the kernel) and its plain
    # version, the insert kernel alone, live entries (slots that hold a
    # key), the entries the state's own counts say it holds, and the items a
    # batch's grid passes sweep (HT: its largest doubling's old slots; HTI:
    # those of a migration it started, which it also drains here; CH: the
    # batch's keys)
    tables = [
        ("HT", "ht_insert",
         lambda: bl.ht_create(max_log2, FIG7_INITIAL_LOG2, device=dev),
         bl.ht_insert_many, bl.ht_lookup_many, bl.ht_lookup_plain,
         lambda st, k, v: kern.ht_insert_(st, k, v, 0.35),
         lambda st: live_open(st.keys),
         lambda st: int(st.count),
         lambda a, b: ((1 << (int(b.size_log2) - 1))
                       if int(b.size_log2) > int(a.size_log2) else 0)),
        ("HTI", "hti_insert",
         lambda: bl.hti_create(max_log2, FIG7_INITIAL_LOG2, device=dev),
         bl.hti_insert_many, bl.hti_lookup_many, bl.hti_lookup_plain,
         lambda st, k, v: kern.hti_insert_(st, k, v, 0.35, 64),
         lambda st: live_open(st.new_keys, st.old_keys),
         lambda st: int(st.new_count) + int(st.old_count),
         lambda a, b: ((1 << int(b.old_log2))
                       if int(b.old_log2) > int(a.old_log2) else 0)),
        ("CH", "ch_insert",
         lambda: bl.ch_create(max_log2 - 4, FIG7_CH_CAPACITY, FIG7_CH_SLOTS,
                              device=dev),
         bl.ch_insert_many, bl.ch_lookup_many, bl.ch_lookup_plain,
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
    clock = LaunchClock(kern)
    for (name, kname, create, insert, lookup, plain_lookup, kernel, live_of,
         count_of, grid_work) in tables:
        lname = kname.replace("insert", "lookup")
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
            m0 = torch.cuda.memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            st = insert(prev, keys[i:i + batch], vals[i:i + batch])
            end.record()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            batch_s.append(t1 - t0)
            batch_ms.append(start.elapsed_time(end))
            m1 = torch.cuda.memory_stats()
            log(f"(i) {name} batch {b} host ms: before the launch "
                f"{(clock.start - t0) * 1e3:.4f}, in the launch "
                f"{(clock.end - clock.start) * 1e3:.4f}, in the sync "
                f"{(t1 - clock.end) * 1e3:.4f}; allocator deltas " + ", ".join(
                    f"{k} {m1.get(k, 0) - m0.get(k, 0)}"
                    for k in FIG7_MEMORY_STATS))
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

        # lookups through the kernel: every present key not lost returns its
        # value, every absent key MISS, and a sample equals the lookup on a
        # CPU copy; then the plain version on the card, on the same state
        ms, got = timer(lambda: lookup(st, probe), reps=FIG7_LOOKUP_REPS,
                        warmup=FIG7_LOOKUP_WARMUP)
        look_launches = _build.launches()
        calls = FIG7_LOOKUP_WARMUP + FIG7_LOOKUP_REPS
        assert look_launches.get(lname, 0) == calls, \
            f"(i) {lname} launched {look_launches.get(lname, 0)} times in " \
            f"{calls} lookups"
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
        plain_ms, want = timer(lambda: plain_lookup(st, probe))
        assert _build.launches().get(lname, 0) == calls, \
            f"(i) {name}: the plain lookup launched {lname}"
        look_err = err(got, want)
        peak = torch.cuda.max_memory_allocated()
        resident = sum(a.nbytes for a in st)
        ns = ms * 1e6 / probe.numel()
        plain_ns = plain_ms * 1e6 / probe.numel()
        log(f"(i) {name} lookup (kernel {lname}) {ns:.4f} ns/lookup "
            f"({probe.numel()} lookups, {n_absent} absent; {ms:.4f} ms; "
            f"{calls} launches); plain (vectorised PyTorch on the card, the "
            f"same state) {plain_ns:.4f} ns/lookup ({plain_ms:.4f} ms), max "
            f"|err| {look_err}; present keys MISS {miss} (not stored: "
            f"dropped {int(st.dropped)}); stored entries == the state's "
            f"counts; 2^16 sampled lookups == the CPU's; state {resident} B "
            f"resident; max_memory_allocated {peak} B over the table's run "
            f"(the state, its copy-on-write clone, the doubling's work "
            f"space, keys, probes, the plain lookup's chunks); card {smi}")
        look_bytes = lookup_bytes_baseline(torch, lname, st, probe)
        rows.append(_row(lname,
                         "src/repro_torch/kernels/csrc/baselines_lookup.cu",
                         FIG7_SOURCES[lname], look_launches, ms, plain_ms,
                         look_bytes, look_err, phase="i"))
        fetches, found = lookup_sectors_baseline(torch, lname, st, probe)
        floor = sector_floor_ms(fetches, probe.numel())
        log(f"(i) {lname}: byte bound {look_bytes / HBM_BYTES_PER_S * 1e3:.4f}"
            f" ms; {fetches} random {FETCH_BYTES}-byte fetches; sector floor {floor:.4f} ms (the "
            f"fetches at {RANDOM_READS_PER_S / 1e9:.2f} G/s, "
            f"tools/random_sector_peak.py, and {8 * probe.numel()} B of keys "
            f"and results at 3.35 TB/s); the kernel at "
            f"{100 * floor / ms:.1f}% of the floor; hits by table probed "
            f"{found}")
        del got, gi, present, plain, host_st, want

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
                             big=big + 1, ns=ns, plain_ns=plain_ns, peak=peak,
                             resident=resident, dropped=int(st.dropped),
                             miss=miss)
        del st, before_last, work
    clock.close()
    bad = [r["name"] for r in rows if r["max_abs_err"] != 0]
    assert not bad, f"(i) kernels differ from their plain loops: {bad}"
    return results, rows


def report_fig7(res, eh, smi) -> None:
    """(i): Fig. 7's five rows on one card: 7a insert seconds (the per-batch
    staircase), 7b ns/lookup; EH and Shortcut-EH from (d)/(e)."""
    log(f"(i) Fig. 7 on {smi} ({eh['n_keys']} keys in 16 batches; lookups of "
        f"them and {eh['n_absent']} absent keys; every lookup a CUDA kernel, "
        f"the baselines' plain versions beside them):")
    for name, r in res.items():
        log(f"(i)   {name:12s} insert {r['insert_s']:.6f} s, per batch "
            f"{[round(x, 4) for x in r['batch_s']]}; lookup "
            f"{r['ns']:.4f} ns/lookup (plain {r['plain_ns']:.4f}); state "
            f"{r['resident']} B resident, peak {r['peak']} B over its run; "
            f"dropped {r['dropped']}")
    log(f"(i)   {'EH':12s} insert {eh['insert_s']:.6f} s (ShortcutEH.insert: "
        f"the EH insert and the replay queue), per batch "
        f"{[round(x, 4) for x in eh['batch_s']]}; lookup "
        f"{eh['trad_ns']:.4f} ns/lookup (traditional route); state "
        f"{eh['resident']} B resident, peak {eh['peak']} B (the whole of "
        f"(d))")
    log(f"(i)   {'Shortcut-EH':12s} the same inserts, then pump() "
        f"{eh['maint_s']:.6f} s; lookup {eh['sc_ns']:.4f} ns/lookup "
        f"(shortcut route)")


# (l): training on the card.  (l1) qwen3_4b at full width and depth in
# bfloat16, trained through the port's entry points: SyntheticLM batches of
# 4 x 2048 tokens, remat, grad_accum 1, wsd_schedule(3e-4, 2 warmup steps,
# 8 steps), 8 steps
TRAIN_CONFIG = dict(arch="qwen3_4b", batch=4, seq=2048, steps=8,
                    peak_lr=3e-4, warmup=2)
# (l1): the steps the medians are taken over (steps 3-8)
TRAIN_TIMED = slice(2, None)
BF16_PEAK_TFLOPS = 989.0      # H100 SXM dense bfloat16 (NVIDIA data sheet)
# (l2): the card against the CPU in float32 at these reduced configs, one
# step of make_train_step with grad_accum 2 and clipping engaged (clip_norm
# 0.1 under gradient norms near 2).  Limits: the loss within 1e-5 relative;
# each gradient leaf and each updated parameter within a relative RMS of
# 2^-8, because grad_bf16 rounds the branch cotangents to bfloat16 and a
# rounding that flips moves an element by one bfloat16 step.  The step
# starts from a warm AdamW state (v = warm_v everywhere, m = 0): from a
# fresh one Adam's first update is g / (|g| + eps), the sign of each
# gradient element, so a zero-initialized parameter (the norms' scales,
# conv_b, dt_bias) becomes -lr sign(g) and an element whose gradient is
# near zero flips under any rounding (on the CPU a 1e-7 relative
# perturbation of the parameters moved hymba's conv_b by 3.4 times the
# limit); with v warm the update is a smooth function of the gradient
TRAIN_CHECK_ARCHS = ("qwen3_4b", "hymba_1_5b", "paligemma_3b")
TRAIN_CHECK = dict(batch=4, seq=64, grad_accum=2, clip_norm=0.1,
                   peak_lr=1e-2, warm_v=1e-6)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_REL_RMS = 2.0 ** -8
# (l2): the MoE backward at one qwen2_moe_a2_7b layer's full width, float32,
# 2 x 2048 tokens: the three autograd.Functions against autograd of the
# plain take_along_dim forwards, relative RMS per gradient leaf
MOE_GRAD_TOKENS = (2, 2048)
MOE_GRAD_LIMIT = 1e-5
# (l3): examples/train_small_torch.py's qwen3_100m in bfloat16, 8 x 256
# tokens, grad_accum 2: 6 steps straight against 3, a checkpoint, a restore
# into fresh tensors and 3 more
RESTORE_CONFIG = dict(batch=8, seq=256, grad_accum=2, steps=6, crash=3,
                      peak_lr=1e-3)


def rel_norm(torch, got, want) -> float:
    """||got - want|| / ||want|| over a whole tensor in float64, on
    ``got``'s device (||got - want|| where ``want`` is zero)."""
    want = want.to(got.device).double()
    diff = float((got.double() - want).norm())
    norm = float(want.norm())
    return diff / norm if norm else diff


def loop_pairs(cfg, S: int) -> int:
    """(query, key) pairs ``attention.loop_attention`` computes in one head
    of a global layer over S positions: each query tile of chunk_q rows
    against every key tile its causal footprint touches, in full."""
    cq = cfg.attn_chunk_q if S % cfg.attn_chunk_q == 0 else S
    ckv = cfg.attn_chunk_kv if S % cfg.attn_chunk_kv == 0 else S
    pairs = 0
    for i in range(S // cq):
        hi = -(-min(S, (i + 1) * cq) // ckv) * ckv
        pairs += cq * hi
    return pairs


def trace_split(cpu, dev, windows) -> dict:
    """A training step's device time in ms by where it ran, from a
    ``torch.profiler`` trace: ``cpu``, its CPU events; ``dev``, its kernels
    and copies as (start us, duration us, the id of the CPU operation that
    launched it); ``windows``, the device time ranges of the spans'
    device-side annotations by span name (a span's first to last kernel).
    One stream runs the step in order, so the phases are time windows:
    ``forward`` (``train.FORWARD_SPAN``: the layers, the loss),
    ``optimizer`` (``train.OPTIMIZER_SPAN``), ``backward`` between them
    (with the layers' recompute), ``other``.  ``attention`` is the work of
    ``attention.loop_attention``: its span's windows (the forward and the
    recompute) and the kernels of the backward nodes of the operations it
    ran (a node carries its forward operation's thread and sequence
    number), of which ``attention_backward``.  Two threads can give one
    operation id, so a backward kernel takes the candidate launcher under a
    backward node."""
    import bisect
    from repro_torch.models.attention import LOOP_SPAN
    from repro_torch.runtime import train as T

    def chain(e):
        while e is not None:
            yield e
            e = e.cpu_parent

    def node(e):
        """The outermost backward node above ``e`` (on CUDA the engine's
        device thread runs it), or None."""
        return next((a for a in reversed(list(chain(e))) if a.name.startswith(
            "autograd::engine::evaluate_function")), None)

    def within(t, spans):
        i = bisect.bisect_right(spans, (t, float("inf"))) - 1
        return i >= 0 and t <= spans[i][1]

    loop_ops = {(e.thread, e.sequence_nr) for e in cpu
                if e.sequence_nr >= 0
                and any(a.name == LOOP_SPAN for a in chain(e))}
    by_id: dict = {}
    for e in cpu:
        by_id.setdefault(e.id, []).append(e)
    fwd = sorted(windows.get(T.FORWARD_SPAN, []))
    opt = sorted(windows.get(T.OPTIMIZER_SPAN, []))
    loop = sorted(windows.get(LOOP_SPAN, []))
    fwd_end = max((b for _, b in fwd), default=float("inf"))
    opt_start = min((a for a, _ in opt), default=float("inf"))
    out = dict(forward=0.0, backward=0.0, optimizer=0.0, other=0.0,
               attention=0.0, attention_backward=0.0)
    for t, us, link in dev:
        phase = ("forward" if within(t, fwd) else
                 "optimizer" if within(t, opt) else
                 "backward" if fwd_end <= t <= opt_start else "other")
        out[phase] += us / 1e3
        if within(t, loop):
            out["attention"] += us / 1e3
        elif phase == "backward":
            nodes = [n for n in map(node, by_id.get(link, ()))
                     if n is not None]
            if nodes and (nodes[-1].fwd_thread,
                          nodes[-1].sequence_nr) in loop_ops:
                out["attention"] += us / 1e3
                out["attention_backward"] += us / 1e3
    return out


def train_trace(torch, fn):
    """``fn()`` (one training step) once under ``torch.profiler``: the
    device's busy ms (the summed durations of its kernels and copies), their
    count and :func:`trace_split` of their time; None when the trace holds
    no device events.  The device events are read from the profiler's
    Kineto results, which carry each kernel's launcher id."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import moe, ssm
    from repro_torch.models.attention import LOOP_SPAN
    from repro_torch.runtime import train as T
    spans = {LOOP_SPAN, T.FORWARD_SPAN, T.BACKWARD_SPAN, T.OPTIMIZER_SPAN,
             moe.SPAN, ssm.SPAN}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = [k for k in prof.profiler.kineto_results.events()
            if k.device_type() == DeviceType.CUDA]
    # a span's device-side annotation is no kernel: left out of busy
    dev = [(k.start_ns() / 1e3, k.duration_ns() / 1e3,
            k.linked_correlation_id()) for k in cuda
           if k.name() not in spans]
    if not dev:
        return None
    windows: dict = {}
    for k in cuda:
        if k.name() in spans:
            windows.setdefault(k.name(), []).append(
                (k.start_ns() / 1e3, (k.start_ns() + k.duration_ns()) / 1e3))
    split = trace_split([e for e in prof.events() if e.device_type
                         == DeviceType.CPU], dev, windows)
    split["busy"] = sum(us for _, us, _ in dev) / 1e3
    split["n"] = len(dev)
    return split


def sample(t):
    """A strided copy of at most 4096 of a tensor's elements."""
    flat = t.detach().reshape(-1)
    return flat[::max(1, flat.numel() // 4096)][:4096].clone()


def train_full(torch, args) -> dict:
    """(l1): ``TRAIN_CONFIG``'s model trained for its steps through
    ``runtime.train.make_train_step``; each step timed by the host clock
    and by CUDA events, the launch counts set to 0 before the steps and
    read after, the peak memory over the steps, one profiler trace of a
    further step; step 0's loss against a ``torch.no_grad()``
    ``train_forward`` of the same batch and parameters."""
    from repro_torch.configs import get
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import _build
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import adamw_init, tree_leaves
    from repro_torch.optim.schedule import wsd_schedule
    from repro_torch.runtime import train as T
    c = TRAIN_CONFIG
    cfg = get(c["arch"])
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, args.seed, torch.bfloat16, device=dev)
    opt = adamw_init(params)
    leaves = tree_leaves(params)
    pipe = SyntheticLM(cfg, DataConfig(c["seq"], c["batch"], seed=args.seed),
                       device=dev)
    step_fn = T.make_train_step(
        cfg, lr_fn=lambda s: wsd_schedule(
            s, peak_lr=c["peak_lr"], warmup_steps=c["warmup"],
            total_steps=c["steps"]), grad_accum=1, remat=True).fn
    batches = [pipe.batch(i) for i in range(c["steps"] + 1)]
    with torch.no_grad():
        want0 = M.train_forward(params, cfg, batches[0])
    before = [sample(p) for p in leaves]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    res = dict(cfg=cfg, n_params=sum(p.numel() for p in leaves),
               param_bytes=sum(p.numel() * p.element_size() for p in leaves),
               opt_bytes=sum(t.numel() * t.element_size() for t in
                             tree_leaves(opt.m) + tree_leaves(opt.v)),
               host_ms=[], dev_ms=[], loss=[], gnorm=[], lr=[])
    for i in range(c["steps"]):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        params, opt, m = step_fn(params, opt, batches[i])
        end.record()
        torch.cuda.synchronize()
        res["host_ms"].append((time.perf_counter() - t0) * 1e3)
        res["dev_ms"].append(start.elapsed_time(end))
        if i == 0:
            res["loss0_equal"] = bool(torch.equal(m["loss"], want0))
            res["loss0"], res["want0"] = float(m["loss"]), float(want0)
        for k in ("loss", "lr"):
            res[k].append(float(m[k]))
        res["gnorm"].append(float(m["grad_norm"]))
    res["launches"] = _build.launches()
    res["peak"] = torch.cuda.max_memory_allocated()
    res["total_memory"] = torch.cuda.get_device_properties(0).total_memory
    res["unchanged"] = [i for i, (p, b) in enumerate(zip(leaves, before))
                        if torch.equal(sample(p), b)]
    res["trace"] = train_trace(
        torch, lambda: step_fn(params, opt, batches[c["steps"]]))
    return res


def report_train_full(res, smi) -> None:
    """(l1)'s report lines and checks."""
    import math
    c, cfg = TRAIN_CONFIG, res["cfg"]
    B, S, L = c["batch"], c["seq"], cfg.num_layers
    T_ = B * S
    host = median(res["host_ms"][TRAIN_TIMED])
    dev = median(res["dev_ms"][TRAIN_TIMED])
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    attn_fwd = 4 * B * H * hd * loop_pairs(cfg, S) * L
    flops = 6 * res["n_params"] * T_ + 3 * attn_fwd
    tflops = flops / (host / 1e3) / 1e12
    KV = cfg.num_kv_heads
    cq = cfg.attn_chunk_q if S % cfg.attn_chunk_q == 0 else S
    ckv = cfg.attn_chunk_kv if S % cfg.attn_chunk_kv == 0 else S
    tile = B * KV * (H // KV) * cq * ckv * 4
    chunk = min(cfg.loss_chunk, S)
    reckon = dict(state=2 * res["param_bytes"] + res["opt_bytes"],
                  saved_inputs=L * T_ * cfg.d_model * 2,
                  attention=3 * (loop_pairs(cfg, S) // (cq * ckv)) * tile,
                  logits=B * chunk * cfg.vocab_size * 4)
    log(f"(l1) {c['arch']} at full width and depth, bfloat16: "
        f"{res['n_params']} parameters ({res['param_bytes']} B), AdamW "
        f"moments float32 ({res['opt_bytes']} B); {B} x {S} tokens a step, "
        f"remat, grad_accum 1, wsd_schedule(peak {c['peak_lr']}, warmup "
        f"{c['warmup']}, {c['steps']} steps); card {smi}")
    for i in range(c["steps"]):
        log(f"(l1) step {i}: loss {res['loss'][i]:.6f} grad_norm "
            f"{res['gnorm'][i]:.6f} lr {res['lr'][i]:.6e}; "
            f"{res['host_ms'][i]:.4f} ms host clock, {res['dev_ms'][i]:.4f} "
            f"ms CUDA events")
    log(f"(l1) ms per step, median of steps 3-{c['steps']}: {host:.4f} "
        f"(host clock), {dev:.4f} (CUDA events); {T_ / (host / 1e3):.1f} "
        f"tokens/s; model {flops / 1e12:.2f} TFLOP a step (6 N T "
        f"{6 * res['n_params'] * T_ / 1e12:.2f} + the loop's attention, "
        f"forward and backward, {3 * attn_fwd / 1e12:.2f}; the recompute "
        f"not counted): {tflops:.2f} TFLOP/s, "
        f"{100 * tflops / BF16_PEAK_TFLOPS:.2f}% of {BF16_PEAK_TFLOPS:.0f}; "
        f"card {smi}")
    log(f"(l1) max_memory_allocated over the steps {res['peak']} B, "
        f"{100 * res['peak'] / res['total_memory']:.1f}% of the card's "
        f"{res['total_memory']} B; the reckoning: state (parameters, "
        f"gradients, m, v) {reckon['state']} B, saved layer inputs "
        f"{reckon['saved_inputs']} B, one layer's loop attention (3 float32 "
        f"tiles of {tile} B a key tile) {reckon['attention']} B, the loss "
        f"chunk's float32 logits {reckon['logits']} B: "
        f"{sum(reckon.values())} B")
    tr = res["trace"]
    if tr is None:
        log("(l1) trace: no device events (device time not measured)")
    else:
        busy = tr["busy"]
        parts = ", ".join(f"{k} {tr[k]:.4f} ms ({100 * tr[k] / busy:.1f}%)"
                          for k in ("forward", "backward", "optimizer",
                                    "other"))
        log(f"(l1) one traced step: device busy {busy:.4f} ms in {tr['n']} "
            f"kernels and copies, {100 * (1 - busy / host):.1f}% idle "
            f"against the untraced {host:.4f} ms; {parts}; the attention "
            f"loop {tr['attention']:.4f} ms "
            f"({100 * tr['attention'] / busy:.1f}% of busy; its backward "
            f"nodes {tr['attention_backward']:.4f} ms)")
    log(f"(l1) checks: step 0's loss {res['loss0']!r} against a no_grad "
        f"train_forward's {res['want0']!r} (bit for bit: "
        f"{res['loss0_equal']}); parameters unchanged after the steps "
        f"{res['unchanged']}; launches of the port's kernels "
        f"{res['launches']}")
    assert all(math.isfinite(x) for x in res["loss"] + res["gnorm"]), \
        "(l1) a non-finite loss or gradient norm"
    assert res["loss0_equal"], "(l1) step 0's loss differs from no_grad"
    assert not res["unchanged"], "(l1) parameters did not change"
    assert not res["launches"], "(l1) training launched a kernel"


def train_step_on(torch, cfg, params, batch, device) -> dict:
    """(l2): the gradients and one make_train_step step on ``device`` from
    copies of ``params`` and ``batch``: the loss, the gradient leaves, the
    updated parameter leaves (on the CPU) and the clip scale."""
    from repro_torch.optim.adamw import adamw_init, tree_leaves, tree_map
    from repro_torch.runtime import train as T
    c = TRAIN_CHECK
    params = tree_map(lambda t: t.to(device, copy=True), params)
    batch = {k: v.to(device) for k, v in batch.items()}
    loss, grads = T.loss_and_grads(cfg, params, batch,
                                   grad_accum=c["grad_accum"])
    step = T.make_train_step(
        cfg, lr_fn=lambda s: torch.tensor(c["peak_lr"]),
        grad_accum=c["grad_accum"], clip_norm=c["clip_norm"]).fn
    opt = adamw_init(params)
    opt = opt._replace(v=tree_map(lambda t: torch.full_like(
        t, c["warm_v"]), opt.v))
    params, _, m = step(params, opt, batch)
    return dict(loss=float(loss), clip=float(m["clip_scale"]),
                grads=[g.cpu() for g in tree_leaves(grads)],
                params=[p.cpu() for p in tree_leaves(params)],
                names=list(leaf_names(params)))


def leaf_names(tree, prefix=""):
    """The paths of a tree of nested dictionaries, in ``tree_leaves``'s
    order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaf_names(v, f"{prefix}{k}/")
        else:
            yield prefix + k


def train_ratio(torch, got, want) -> tuple:
    """(l2)'s errors over their limits: (the largest, the three largest as
    "what: ratio" strings) over the loss, each gradient leaf and each
    updated parameter."""
    rs = [(abs(got["loss"] - want["loss"]) / abs(want["loss"])
           / TRAIN_LOSS_RTOL, "loss")]
    for k in ("grads", "params"):
        for g, w, name in zip(got[k], want[k], want["names"]):
            rs.append((rel_norm(torch, g, w) / TRAIN_REL_RMS,
                       f"{k[:-1]} {name}"))
    rs.sort(reverse=True)
    return rs[0][0], ", ".join(f"{n}: {r:.4g}" for r, n in rs[:3])


def train_parity(torch, args) -> None:
    """(l2): ``TRAIN_CHECK_ARCHS``' reduced configs, one step on the card
    against the same step on the CPU (the path the CPU tests hold to the
    JAX package); and wrong steps, run on the CPU, against the card's:
    paligemma_3b's loss over the prefix's positions (its last positions
    dropped instead), and qwen3_4b with the causal mask off by one (each
    row sees the next key)."""
    import contextlib
    from repro_torch.configs import get
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import attention
    from repro_torch.models import model as M
    c = TRAIN_CHECK
    dev, cpu = torch.device("cuda"), torch.device("cpu")

    @contextlib.contextmanager
    def patched(mod, name, value):
        old = getattr(mod, name)
        setattr(mod, name, value)
        try:
            yield
        finally:
            setattr(mod, name, old)

    def prefix_kept(params, cfg, batch, *, remat=True):
        h, _, aux = M.forward_hidden(params, cfg, batch, remat=remat,
                                     train=True)
        labels = batch["labels"]
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=h.device)
        return M.chunked_softmax_xent(params, cfg, h[:, :labels.shape[1]],
                                      labels, mask) \
            + cfg.router_aux_weight * aux

    tile_mask = attention._tile_mask
    wrong = {"paligemma_3b": ("the prefix's positions kept in the loss",
                              M, "train_forward", prefix_kept),
             "qwen3_4b": ("the causal mask off by one", attention,
                          "_tile_mask", lambda q, k, *a: tile_mask(
                              q + 1, k, *a))}
    for arch in TRAIN_CHECK_ARCHS:
        cfg = get(arch).reduced()
        params = M.init_params(cfg, args.seed, torch.float32, device=cpu)
        batch = SyntheticLM(cfg, DataConfig(c["seq"], c["batch"],
                                            seed=args.seed),
                            device=cpu).batch(0)
        card = train_step_on(torch, cfg, params, batch, dev)
        host = train_step_on(torch, cfg, params, batch, cpu)
        r, worst = train_ratio(torch, card, host)
        line = (f"(l2) {arch} reduced, float32, grad_accum "
                f"{c['grad_accum']}: loss {card['loss']!r} on the card, "
                f"{host['loss']!r} on the CPU; clip scale {card['clip']:.4g}"
                f" / {host['clip']:.4g}; errors over their limits, the "
                f"largest: {worst}")
        if arch in wrong:
            what, mod, name, fn = wrong[arch]
            with patched(mod, name, fn):
                bad = train_step_on(torch, cfg, params, batch, cpu)
            rw, worst = train_ratio(torch, bad, card)
            line += f"; {what}: {worst} (must pass 1)"
            assert rw > 1, f"(l2) {arch}: {what} within the limits"
        log(line)
        assert card["clip"] < 1 and host["clip"] < 1, \
            f"(l2) {arch}: clipping not engaged"
        assert r <= 1, f"(l2) {arch}: the card's step off the CPU's"


def moe_backward_check(torch, args) -> None:
    """(l2): one qwen2_moe_a2_7b MoE layer at full width in float32 on
    ``MOE_GRAD_TOKENS``: the gradients of (out . r) + aux with respect to
    every parameter and x through the three autograd.Functions, against
    autograd of the plain take_along_dim forwards on the same card and
    routing, at the published capacity factor and at 1.0 (where more
    pairs drop); two wrong backward passes that must pass the limit
    (``_gather_tokens``' without its inverse permutation,
    ``_pairs_to_slots``' reading the next slot); and two that no gradient
    can see, logged: ``hit`` left out of ``_slots_to_pairs``' (an
    unfilled slot's buffer row is zero, and the bias-free gated expert
    maps it to zero with zero gradients) and ``keep`` left out of
    ``_pairs_to_slots``' (a dropped pair then reads the last slot's
    cotangent, zero for the same reason unless that slot is filled)."""
    import dataclasses
    from repro_torch.configs import get
    from repro_torch.models import moe
    from repro_torch.optim.adamw import tree_leaves, tree_unflatten

    take = torch.take_along_dim
    plain = {
        "_gather_tokens": lambda x, stok: take(x, stok[..., None], dim=1),
        "_pairs_to_slots": lambda xg, src, hit, slot, keep: take(
            xg, src[..., None], dim=1) * hit[..., None].to(xg.dtype),
        "_slots_to_pairs": lambda out, slot, keep, src, hit: take(
            out, slot.clamp(max=out.shape[1] - 1)[..., None], dim=1)
        * keep[..., None].to(out.dtype)}

    class NoHit(torch.autograd.Function):
        @staticmethod
        def forward(ctx, out, slot, keep, src, hit):
            ctx.save_for_backward(src)
            return plain["_slots_to_pairs"](out, slot, keep, src, hit)

        @staticmethod
        def backward(ctx, ct):
            src, = ctx.saved_tensors
            return take(ct, src[..., None], dim=1), None, None, None, None

    class NoKeep(torch.autograd.Function):
        @staticmethod
        def forward(ctx, xg, src, hit, slot, keep):
            ctx.save_for_backward(slot)
            return plain["_pairs_to_slots"](xg, src, hit, slot, keep)

        @staticmethod
        def backward(ctx, ct):
            slot, = ctx.saved_tensors
            safe = slot.clamp(max=ct.shape[1] - 1)
            return take(ct, safe[..., None], dim=1), None, None, None, None

    class NextSlot(torch.autograd.Function):
        @staticmethod
        def forward(ctx, xg, src, hit, slot, keep):
            ctx.save_for_backward(slot, keep)
            return plain["_pairs_to_slots"](xg, src, hit, slot, keep)

        @staticmethod
        def backward(ctx, ct):
            slot, keep = ctx.saved_tensors
            safe = (slot + 1).clamp(max=ct.shape[1] - 1)
            g = take(ct, safe[..., None], dim=1)
            return g * keep[..., None].to(g.dtype), None, None, None, None

    class NoInverse(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, stok):
            ctx.S = x.shape[1]
            return plain["_gather_tokens"](x, stok)

        @staticmethod
        def backward(ctx, ct):
            B, SK, D = ct.shape
            return ct.reshape(B, ctx.S, SK // ctx.S, D).sum(dim=2), None

    cfg0 = get("qwen2_moe_a2_7b")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = moe.moe_init(gen, cfg0, torch.float32, dev)
    x = torch.randn(MOE_GRAD_TOKENS + (cfg0.d_model,), generator=gen,
                    device=dev)
    r = torch.randn(x.shape, generator=gen, device=dev)

    def grads(cfg, **patch):
        saved = {k: getattr(moe, k) for k in patch}
        for k, v in patch.items():
            setattr(moe, k, v)
        try:
            leaves = [p.detach().requires_grad_()
                      for p in tree_leaves(params)]
            xr = x.detach().requires_grad_()
            out, aux = moe.moe_apply(tree_unflatten(params, leaves), xr, cfg)
            return torch.autograd.grad((out * r).sum() + aux, leaves + [xr])
        finally:
            for k, v in saved.items():
                setattr(moe, k, v)

    for cf in (cfg0.capacity_factor, 1.0):
        cfg = dataclasses.replace(cfg0, capacity_factor=cf)
        C = moe.moe_capacity(cfg, MOE_GRAD_TOKENS[1])
        with torch.no_grad():
            _, _, top_i = moe.route(params, x, cfg)
        load = torch.stack([torch.bincount(t.reshape(-1),
                                           minlength=cfg.num_experts)
                            for t in top_i])
        dropped = int((load - C).clamp_min(0).sum())
        want = grads(cfg, **plain)

        def err(got):
            return max(rel_norm(torch, g, w) for g, w in zip(got, want))
        sound = err(grads(cfg))
        # the two that must pass the limit, and the two no gradient can
        # see (logged): the one a zero buffer row hides, and keep, which
        # only moves a dropped pair onto the last slot's cotangent, zero
        # unless that slot is filled
        wrongs = {"_gather_tokens' backward without its inverse":
                  err(grads(cfg, _gather_tokens=NoInverse.apply)),
                  "_pairs_to_slots' backward reading the next slot":
                  err(grads(cfg, _pairs_to_slots=NextSlot.apply))}
        hidden = {"hit left out of _slots_to_pairs' backward":
                  err(grads(cfg, _slots_to_pairs=NoHit.apply)),
                  "keep left out of _pairs_to_slots' backward":
                  err(grads(cfg, _pairs_to_slots=NoKeep.apply))}
        del want
        log(f"(l2) qwen2_moe_a2_7b MoE layer, float32, "
            f"{MOE_GRAD_TOKENS[0]} x {MOE_GRAD_TOKENS[1]} tokens, capacity "
            f"factor {cf} (C {C}, {dropped} pairs dropped): the Functions' "
            f"gradients off autograd's of the plain gathers by {sound:.4g} "
            f"(relative RMS, the largest leaf; limit {MOE_GRAD_LIMIT}); "
            "wrong: " + "; ".join(f"{k}: {v:.4g}" for k, v in wrongs.items())
            + "; logged (a zero buffer row hides it): "
            + "; ".join(f"{k}: {v:.4g}" for k, v in hidden.items()))
        assert sound <= MOE_GRAD_LIMIT, "(l2) MoE backward off the plain"
        for k, v in wrongs.items():
            assert v > MOE_GRAD_LIMIT, f"(l2) {k} within the limit"


def restore_config():
    """examples/train_small_torch.py's qwen3_100m."""
    import dataclasses
    from repro_torch.configs import get
    return dataclasses.replace(
        get("qwen3_4b"), name="qwen3_100m", num_layers=8, d_model=512,
        num_heads=8, num_kv_heads=4, head_dim=64, d_ff=2048,
        vocab_size=32768)


def train_restore(torch, args) -> None:
    """(l3): ``RESTORE_CONFIG``: the steps straight, and the same steps
    cut by a checkpoint and a restore into fresh tensors; every parameter
    and moment must be equal bit for bit.  Then, logged: two straight runs
    whose embedding is read by indexing (``embed[tokens]``, whose backward
    is ``index_put_`` with accumulate) in place of ``F.embedding``, equal
    or not."""
    import tempfile
    from repro_torch.checkpoint.checkpointer import Checkpointer, latest_step
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import adamw_init, tree_leaves
    from repro_torch.optim.schedule import wsd_schedule
    from repro_torch.runtime import train as T
    c = RESTORE_CONFIG
    cfg = restore_config()
    dev = torch.device("cuda")
    pipe = SyntheticLM(cfg, DataConfig(c["seq"], c["batch"], seed=args.seed),
                       device=dev)
    step_fn = T.make_train_step(
        cfg, lr_fn=lambda s: wsd_schedule(s, peak_lr=c["peak_lr"],
                                          warmup_steps=2,
                                          total_steps=c["steps"]),
        grad_accum=c["grad_accum"]).fn

    def fresh():
        params = M.init_params(cfg, args.seed, torch.bfloat16, device=dev)
        return params, adamw_init(params)

    def run(params, opt, steps):
        for i in steps:
            params, opt, _ = step_fn(params, opt, pipe.batch(i))
        return params, opt

    def state(params, opt):
        return tree_leaves({"p": params, "m": opt.m, "v": opt.v})

    t0 = time.perf_counter()
    want = state(*run(*fresh(), range(c["steps"])))
    tmp = tempfile.mkdtemp(prefix="repro_restore_")
    try:
        ck = Checkpointer(tmp)
        params, opt = run(*fresh(), range(c["crash"]))
        ck.save(c["crash"], {"params": params, "opt": opt})
        del params, opt                               # the crash
        step = latest_step(tmp)
        params, opt = fresh()
        got = ck.restore(step, {"params": params, "opt": opt})
        params, opt = run(got["params"], got["opt"],
                          range(step, c["steps"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got = state(params, opt)
    differ = sum(not torch.equal(a, b) for a, b in zip(got, want))
    secs = time.perf_counter() - t0

    def by_index(params, tokens):
        tokens = torch.as_tensor(tokens, device=params["embed"].device)
        return params["embed"][tokens.long()]
    old = M._embed_tokens
    M._embed_tokens = by_index
    try:
        a = state(*run(*fresh(), range(c["crash"])))
        b = state(*run(*fresh(), range(c["crash"])))
    finally:
        M._embed_tokens = old
    idx_differ = sum(not torch.equal(x, y) for x, y in zip(a, b))
    log(f"(l3) qwen3_100m, bfloat16, {c['batch']} x {c['seq']} tokens, "
        f"grad_accum {c['grad_accum']}: {c['steps']} steps straight against "
        f"{c['crash']} + save + restore into fresh tensors + "
        f"{c['steps'] - c['crash']}: {differ} of {len(want)} parameter and "
        f"moment tensors differ (must be 0; {secs:.1f} s); with the "
        f"embedding read by indexing, two straight {c['crash']}-step runs "
        f"differ in {idx_differ} of {len(a)}")
    assert int(opt.step) == c["steps"]
    assert differ == 0, "(l3) the restored run is not bit-equal"


def phase_train(torch, args, smi) -> int:
    """(l): (l1) then (l2) then (l3), each freed before the next; returns
    (l1)'s peak memory."""
    gc.collect()
    torch.cuda.empty_cache()
    res = train_full(torch, args)
    report_train_full(res, smi)
    peak = res["peak"]
    del res
    gc.collect()
    torch.cuda.empty_cache()
    train_parity(torch, args)
    moe_backward_check(torch, args)
    gc.collect()
    torch.cuda.empty_cache()
    train_restore(torch, args)
    return peak


# (m1): the serve CLI (repro_torch.launch.serve, the reference's
# launch/serve.py: float32 weights drawn from --seed) at qwen3_4b's full
# width and depth on 4 prompts of 2048 tokens, 32 greedy tokens a route
LAUNCH_SERVE = ["--arch", "qwen3_4b", "--batch", "4", "--prompt-len", "2048",
                "--gen", "32"]
# (m2): the dry run's sweeps.  In this process, where the card is live, the
# paged path's cells that the path changes (the decode shapes: both decode
# kernels' meta branch) and one prefill (the flash kernel's); then every
# arch x shape on the shortcut path, one process an arch with the card
# hidden, as many at once as the host has cores (in one process the
# shortcut sweep took 99.7 s on the host of an H100 80GB HBM3 machine)
DRYRUN_IN_PROCESS = (("all", "decode_32k"), ("all", "long_500k"),
                     ("qwen3_4b", "prefill_32k"))
# (m3): the reduced qwen3_4b prefill and train step counted on the card and
# on the meta device (batch x tokens)
COUNT_CONFIG = dict(arch="qwen3_4b", batch=2, seq=64)


def run_main(fn, argv) -> tuple:
    """``fn(argv)`` with its standard output captured: (code, lines)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue().strip().splitlines()


def launch_serve(torch, smi) -> int:
    """(m1): ``launch.serve.main`` in-process on both routes: its four
    lines, the flash kernel launched once a layer in the prefill and the
    route's decode kernels in every step, the routes' sample tokens
    equal.  Returns the flash launches counted over both routes (the
    float32 kernel's)."""
    from repro_torch.configs import get
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    L = get("qwen3_4b").num_layers
    steps = int(LAUNCH_SERVE[LAUNCH_SERVE.index("--gen") + 1]) - 1
    tokens, flash_n = {}, 0
    for path in ("shortcut", "paged"):
        gc.collect()
        torch.cuda.empty_cache()
        _build.reset_launches()
        rc, lines = run_main(serve.main, LAUNCH_SERVE + ["--path", path])
        got = _build.launches()
        assert rc == 0 and len(lines) == 4, f"(m1) {path}: {rc} {lines}"
        for line in lines:
            log(f"(m1) {line.strip()}")
        log(f"(m1) {path}: launches {got}; card {smi}")
        want = {"flash_attention": L,
                f"{path}_attention": 2 * L * steps}
        assert got == want, f"(m1) {path}: launches {got}, want {want}"
        flash_n += got["flash_attention"]
        tokens[path] = lines[3].split(":", 1)[1].strip()
    assert tokens["shortcut"] == tokens["paged"], f"(m1) tokens {tokens}"
    return flash_n


def launch_dryrun(torch) -> None:
    """(m2): ``launch.dryrun.main`` over ``DRYRUN_IN_PROCESS`` on the paged
    path in this process (no kernel launched, the card's allocated and
    peak memory unchanged), then every arch x shape on the shortcut path in
    child processes that cannot see the card; every cell ``ok`` or
    ``SKIP`` as ``cell_status`` says, one JSON and one line a cell."""
    import concurrent.futures
    import os
    import tempfile
    from repro_torch.configs import get
    from repro_torch.configs.base import ASSIGNED
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import SHAPES, cell_status
    tmp = Path(tempfile.mkdtemp(prefix="repro_dryrun_"))
    try:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = (torch.cuda.memory_allocated(),
                  torch.cuda.max_memory_allocated())
        _build.reset_launches()
        t0 = time.perf_counter()
        cells = []
        for arch, shape in DRYRUN_IN_PROCESS:
            rc, lines = run_main(dryrun.main, [
                "--arch", arch, "--shape", shape, "--path", "paged",
                "--out", str(tmp / "paged")])
            for line in lines:
                log(f"(m2) {line}")
            assert rc == 0, f"(m2) paged {arch} {shape}: exit {rc}"
            cells += [("paged", a, shape) for a in
                      (ASSIGNED if arch == "all" else (arch,))]
        torch.cuda.synchronize()
        after = (torch.cuda.memory_allocated(),
                 torch.cuda.max_memory_allocated())
        log(f"(m2) paged path in this process: {len(cells)} cells in "
            f"{time.perf_counter() - t0:.1f} s; memory_allocated / "
            f"max_memory_allocated before {before}, after {after}; "
            f"launches {_build.launches()}")
        assert after == before, "(m2) the dry run touched device memory"
        assert not _build.launches(), "(m2) the dry run launched a kernel"

        t0 = time.perf_counter()
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=str(ROOT / "src"))

        def sweep(arch):
            return subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", "all", "--out", str(tmp / "shortcut")],
                env=env, capture_output=True, text=True, timeout=600)
        with concurrent.futures.ThreadPoolExecutor(os.cpu_count()) as ex:
            done = list(ex.map(sweep, ASSIGNED))
        for arch, out in zip(ASSIGNED, done):
            for line in out.stdout.splitlines():
                log(f"(m2) {line}")
            assert out.returncode == 0, \
                f"(m2) shortcut {arch}: exit {out.returncode}: " \
                f"{out.stderr[-2000:]}"
        cells += [("shortcut", a, sh) for a in ASSIGNED for sh in SHAPES]
        log(f"(m2) shortcut path, every arch x shape in {len(ASSIGNED)} "
            f"processes without the card ({os.cpu_count()} at once): "
            f"{len(ASSIGNED) * len(SHAPES)} cells in "
            f"{time.perf_counter() - t0:.1f} s")
        for path, arch, shape in cells:
            f = tmp / path / f"{arch}__{shape}__1-card__{path}.json"
            rec = json.loads(f.read_text())
            assert rec["status"] == cell_status(get(arch), shape), \
                f"(m2) {f.name}: {rec['status']}"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def count_inputs(torch, cfg, device, seed: int, batch: int, seq: int):
    """Parameters, AdamW state and a batch on ``device`` (meta: the dry
    run's structs)."""
    from repro_torch.models import model as M
    from repro_torch.runtime import train as T
    if device.type == "meta":
        params = T.param_struct(cfg, torch.bfloat16)
        toks = torch.empty((batch, seq + 1), dtype=torch.int32, device=device)
    else:
        params = M.init_params(cfg, seed, torch.bfloat16, device=device)
        gen = torch.Generator(device=device).manual_seed(seed)
        toks = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                             generator=gen, device=device, dtype=torch.int32)
    return params, T.opt_struct(params), {"tokens": toks[:, :-1],
                                          "labels": toks[:, 1:]}


def launch_counts(torch, args, smi, h_busy, l1_peak) -> None:
    """(m3): ``op_cost.analyze`` of the reduced qwen3_4b prefill and of one
    train step (remat), run for real in bfloat16 on the card and on the meta
    device: flops and bytes equal (every differing op logged).  Each step
    runs once on each device first (the rope frequencies are cached per
    device).  Then the dry run's reckoning beside (h)'s and (l1)'s
    measurements: qwen3_4b's decode memory term at (h)'s decode shape
    against (h)'s device-busy step time, and its train-step memory at
    (l1)'s shape against (l1)'s peak."""
    from repro_torch.configs import get
    from repro_torch.launch import dryrun, op_cost
    from repro_torch.optim.schedule import wsd_schedule
    from repro_torch.runtime import serve
    from repro_torch.runtime import train as T
    c = COUNT_CONFIG
    cfg = get(c["arch"]).reduced()

    def lr(s):
        return wsd_schedule(s, peak_lr=3e-4, warmup_steps=2, total_steps=8)
    prefill = serve.make_prefill_step(cfg, s_cap=c["seq"] + 16)
    step = T.make_train_step(cfg, lr_fn=lr, remat=True).fn
    runs = {"prefill": lambda p, o, b: prefill(p, {"tokens": b["tokens"]}),
            "train step": step}
    counts = {}
    for where in ("cuda", "meta"):
        p, o, b = count_inputs(torch, cfg, torch.device(where), args.seed,
                               c["batch"], c["seq"])
        for kind, fn in runs.items():
            fn(p, o, b)                                    # warm
            counts[kind, where] = op_cost.analyze(fn, p, o, b)
        torch.cuda.synchronize()
    for kind in runs:
        card, meta = counts[kind, "cuda"], counts[kind, "meta"]
        ops = sorted(set(card.by_op) | set(meta.by_op))
        diff = {n: (card.by_op.get(n), meta.by_op.get(n)) for n in ops
                if card.by_op.get(n) != meta.by_op.get(n)}
        calls = [sum(x.calls for x in t.by_op.values()) for t in (card, meta)]
        kernels = {n: x.calls for n, x in card.by_op.items() if ":" in n}
        log(f"(m3) {kind}, reduced {c['arch']} ({c['batch']} x {c['seq']} "
            f"tokens, bfloat16): card {card.flops:.0f} flops "
            f"{card.bytes:.0f} B in {calls[0]} ops; meta {meta.flops:.0f} "
            f"flops {meta.bytes:.0f} B in {calls[1]} ops; kernels {kernels}; "
            f"ops that differ: {diff or 'none'}")
        assert (card.flops, card.bytes) == (meta.flops, meta.bytes), \
            f"(m3) {kind}: the card's and the meta counts differ"
    full = get(c["arch"])
    mc = MODEL_CONFIG
    for route, path in (("shortcut", "shortcut"), ("paged", "paged")):
        p = T.param_struct(full, torch.bfloat16)
        tok = torch.empty((mc["batch"],), dtype=torch.int32, device="meta")
        if route == "paged":
            cache = dryrun.paged_cache_struct(full, mc["batch"], mc["s_cap"],
                                              mc["block"], torch.bfloat16)
            t = op_cost.analyze(serve.make_paged_serve_step(full), p, cache,
                                tok, tok)
        else:
            state = serve.decode_state_struct(full, mc["batch"], mc["s_cap"])
            t = op_cost.analyze(serve.make_serve_step(full), p, state, tok)
        terms = op_cost.roofline_terms(t.flops, t.bytes)
        busy = h_busy[route]
        log(f"(m3) dry run, {c['arch']} decode step at (h)'s shape "
            f"({mc['batch']} sequences, S_cap {mc['s_cap']}, every row "
            f"counted), {route} route: memory term "
            f"{terms['memory_s'] * 1e3:.4f} ms ({t.bytes:.0f} B at 3.35 "
            f"TB/s), compute term {terms['compute_s'] * 1e3:.4f} ms; (h) "
            f"measured a device-busy step of "
            + (f"{busy:.4f} ms" if busy is not None else "not measured")
            + f" ({smi})")
    tc = TRAIN_CONFIG
    p = T.param_struct(full, torch.bfloat16)
    toks = torch.empty((tc["batch"], tc["seq"]), dtype=torch.int32,
                       device="meta")
    t = op_cost.analyze(T.make_train_step(full, lr_fn=lr, remat=True).fn, p,
                        T.opt_struct(p), {"tokens": toks, "labels": toks})
    m = t.memory
    log(f"(m3) dry run, {tc['arch']} train step at (l1)'s shape "
        f"({tc['batch']} x {tc['seq']}, bfloat16, remat): peak of live "
        f"bytes {m['total_bytes']} B (arguments {m['argument_bytes']}, "
        f"outputs {m['output_bytes']}, temporaries {m['temp_bytes']}); "
        f"{t.flops:.6g} flops counted (the recompute included), "
        f"{t.bytes:.6g} B; (l1) measured a peak of {l1_peak} B ({smi})")


def phase_launch(torch, args, smi, h_busy, l1_peak) -> int:
    """(m): the serve CLI, the dry run, and the cost counter held to the
    card.  Returns (m1)'s flash launches."""
    t0 = time.perf_counter()
    flash_n = launch_serve(torch, smi)
    log(f"(m1) seconds {time.perf_counter() - t0:.1f}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launch_dryrun(torch)
    log(f"(m2) seconds {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    launch_counts(torch, args, smi, h_busy, l1_peak)
    log(f"(m3) seconds {time.perf_counter() - t0:.1f}")
    return flash_n


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
    wrong_lookups = phase_build(_build)
    clock.lap("b")
    phase_kernels(torch, np, args.seed, wrong_lookups)
    phase_attention(torch, np, args.seed)
    f32_flash = phase_flash(torch, args.seed, timer)
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
    h_busy = {r: mres[r + "_trace"][0] for r in ("shortcut", "paged")}
    del mres
    gc.collect()
    torch.cuda.empty_cache()
    clock.lap("h")

    fig7, rows = phase_fig7(torch, np, args, timer, smi)
    kernels.extend(rows)
    report_fig7(fig7, eh7, smi)
    del fig7, rows
    gc.collect()
    torch.cuda.empty_cache()
    clock.lap("i")

    phase_families(torch, args, timer, smi)
    clock.lap("j")

    phase_twins(torch)
    phase_train_twin(torch)
    clock.lap("k")

    l1_peak = phase_train(torch, args, smi)
    clock.lap("l")

    m1_flash = phase_launch(torch, args, smi, h_busy, l1_peak)
    name, replaces, ms, plain_ms, bytes_, err, lib_ms, flops = f32_flash
    kernels.append(_row(name, "src/repro_torch/kernels/csrc/flash_attention.cu",
                        replaces, {name: m1_flash}, ms, plain_ms, bytes_, err,
                        library_ms=lib_ms, phase="m1", flops=flops,
                        peak=PEAK_F32_FLASH))
    clock.lap("m")
    log(f"(e) total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
