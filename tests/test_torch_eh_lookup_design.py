"""The lookup kernels' lane-group probe (``csrc/common.cuh:group_probe`` as
``csrc/eh_lookup.cu:resolve_tile`` calls it), emulated on the CPU step by
step (a test aid, not the function's plain version), held to the Pallas
kernels of ``repro.kernels.eh_lookup`` run in interpret mode.

The emulation follows the kernel's arithmetic: G lanes a key; 16-byte
chunks of the row, the group reading G consecutive chunks of the cyclic
probe sequence a step; the chunk holding the start read twice when the
start is not 4-aligned (the slots before it masked at the first visit and
taken at the last); each lane's first stop (the key or EMPTY) in its
chunk, the group's answer the lowest lane's; the scalar path (one slot a
lane) where S is not a multiple of 4 or is smaller than 4G."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import eh_lookup as jk
from repro_torch.core import hashing
from repro_torch.kernels import eh_lookup as tk

EMPTY = 0xFFFFFFFF
MISS = 0xFFFFFFFF
GROUPS = (1, 2, 4, 8)


def vector_path(S: int, G: int) -> bool:
    return S % 4 == 0 and S >= 4 * G


def group_probe(row, key: int, start: int, G: int):
    """``(pos, at)`` as ``group_probe<G>`` returns them for one key: the
    first slot along the probe sequence from ``start`` holding ``key`` or
    EMPTY and its content, or ``(-1, 0)``."""
    S = row.size
    if vector_path(S, G):
        nc, c0, o = S // 4, start // 4, start % 4
        visits = nc + 1 if o else nc
        for t0 in range(0, visits, G):
            for r in range(G):                  # lanes, lowest first
                t = t0 + r
                if t >= visits:
                    break
                c = c0 + t if c0 + t < nc else c0 + t - nc
                chunk = row[4 * c:4 * c + 4]    # one 16-byte read
                jlo = o if t == 0 else 0
                jhi = o if t == nc else 4
                for j in range(jlo, jhi):
                    x = int(chunk[j])
                    if x == key or x == EMPTY:
                        return 4 * c + j, x
        return -1, 0
    for d0 in range(0, S, G):
        for r in range(G):
            d = d0 + r
            if d >= S:
                break
            p = start + d if start + d < S else start + d - S
            x = int(row[p])
            if x == key or x == EMPTY:
                return p, x
    return -1, 0


def emulate_lookup(keys, directory, rows_k, rows_v, g: int, G: int):
    """Values (uint32) the kernel returns: the directory's row (or the view
    row ``slot``), the lane-group probe, the value only on a hit."""
    out = np.empty(keys.size, np.uint32)
    for i, key in enumerate(keys.tolist()):
        h = hashing.hash_dir_host(key)
        slot = h >> (32 - g) if g else 0
        row = slot if directory is None else int(directory[slot])
        start = hashing.hash_bucket_host(key) % rows_k.shape[1]
        p, at = group_probe(rows_k[row], key, start, G)
        out[i] = rows_v[row, p] if p >= 0 and at == key else MISS
    return out


def make_tables(S: int, seed: int):
    """A depth-5 directory over 16 buckets (pairs of slots share one), rows
    filled by linear probing to mixed loads (some full), values random in
    every slot (EMPTY ones too, so a wrong position shows); and probe keys:
    the stored keys, absent keys, EMPTY and 0."""
    rng = np.random.default_rng(seed)
    g, C = 5, 16
    directory = (np.arange(1 << g) // 2).astype(np.int32)
    rows_k = np.full((C, S), EMPTY, np.uint32)
    rows_v = rng.integers(0, MISS, (C, S), dtype=np.uint32)
    fill = [S, S, S - 1, (9 * S) // 10, S // 2, 1, 0] * 3
    target = {b: min(S, fill[b]) for b in range(C)}
    stored = []
    cand = rng.choice(2**31 - 2, 80 * S * C, replace=False).astype(
        np.uint32) + 1
    for key in cand.tolist():
        slot = hashing.hash_dir_host(key) >> (32 - g)
        b = int(directory[slot])
        if target[b] == 0:
            continue
        p = hashing.hash_bucket_host(key) % S
        while rows_k[b, p] != EMPTY:
            p = (p + 1) % S
        rows_k[b, p] = key
        target[b] -= 1
        stored.append(key)
        if not any(target.values()):
            break
    assert not any(target.values())
    absent = rng.choice(2**31 - 2, 300, replace=False).astype(np.uint32) \
        + np.uint32(2**31)
    probe = np.concatenate([np.array(stored, np.uint32), absent,
                            np.array([EMPTY, 0], np.uint32)])
    return g, directory, rows_k, rows_v, probe


@functools.lru_cache(maxsize=None)
def jax_answers(S: int):
    """The tables at S and both Pallas lookups' answers (interpret mode)."""
    g, directory, rows_k, rows_v, probe = make_tables(S, seed=S)
    trad = np.asarray(jk.eh_lookup(
        jnp.asarray(probe), jnp.asarray(directory), jnp.asarray(rows_k),
        jnp.asarray(rows_v), jnp.int32(g), tile=256))
    view_k, view_v = rows_k[directory], rows_v[directory]
    short = np.asarray(jk.shortcut_lookup(
        jnp.asarray(probe), jnp.asarray(view_k), jnp.asarray(view_v),
        jnp.int32(g), tile=256))
    return g, directory, rows_k, rows_v, view_k, view_v, probe, trad, short


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("S", [4, 8, 16, 512])
def test_lane_group_probe_matches_pallas(S, G):
    g, directory, rows_k, rows_v, view_k, view_v, probe, trad, short = \
        jax_answers(S)
    got = emulate_lookup(probe, directory, rows_k, rows_v, g, G)
    np.testing.assert_array_equal(got, trad)
    got = emulate_lookup(probe, None, view_k, view_v, g, G)
    np.testing.assert_array_equal(got, short)
    # the port's plain version agrees too
    np.testing.assert_array_equal(
        tk.eh_lookup(probe, torch.from_numpy(directory),
                     torch.from_numpy(rows_k.view(np.int32)),
                     torch.from_numpy(rows_v.view(np.int32)), g).numpy(),
        trad)
    # the cases the trace must reach: a hit before its start (the wrap), a
    # full row walked whole by an absent key, the EMPTY pattern hitting
    wraps = full_walks = 0
    for key in probe.tolist():
        b = int(directory[hashing.hash_dir_host(key) >> (32 - g)])
        start = hashing.hash_bucket_host(key) % S
        p, at = group_probe(rows_k[b], key, start, G)
        wraps += p >= 0 and at == key and p < start
        full_walks += p < 0 and bool((rows_k[b] != EMPTY).all())
    assert wraps > 0 and full_walks > 0
    assert trad[-2] != MISS                     # EMPTY as a key: a hit


def test_absent_keys_and_full_rows_miss():
    """Every absent key misses, on every G and both routes."""
    g, directory, rows_k, rows_v, view_k, view_v, probe, trad, short = \
        jax_answers(8)
    absent = probe[-302:-2]
    for G in GROUPS:
        assert (emulate_lookup(absent, directory, rows_k, rows_v, g, G)
                == MISS).all()
        assert (emulate_lookup(absent, None, view_k, view_v, g, G)
                == MISS).all()
    assert (trad[-302:-2] == MISS).all() and (short[-302:-2] == MISS).all()


@pytest.mark.parametrize("G", GROUPS)
def test_unaligned_start_masks_then_wraps(G):
    """A 16-slot row whose probe starts mid-chunk: the slots before the
    start come last; a hit there is found only after the rest of the row
    holds neither the key nor EMPTY."""
    row = np.arange(100, 116, dtype=np.uint32)
    for start in range(16):
        for p in range(16):
            key = int(row[p])
            assert group_probe(row, key, start, G) == (p, key)
        assert group_probe(row, 7, start, G) == (-1, 0)     # full, absent
    row[[5, 12]] = EMPTY
    # from start 6 the sequence is 6..15, 0..5: the EMPTY at 12 stops it
    assert group_probe(row, int(row[2]), 6, G) == (12, EMPTY)
    assert group_probe(row, int(row[14]), 13, G) == (14, int(row[14]))
    assert group_probe(row, int(row[3]), 13, G) == (3, int(row[3]))
