"""``chip_smoke.lookup_sectors_baseline``: the random 64-byte fetches the
baselines' lookups must make (the sector floor of ``chip_smoke.py`` (i) and
``tools/lookup_ab.py``), held to a key-by-key walk of each probe on the
states of ``chip_smoke.lookup_edge_states`` (windows that wrap over tables
of 2^0 to 2^4 slots, full windows, probes across sector edges, HTI with
either table first, CH chains of 4- to 20-slot rows)."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
try:
    import chip_smoke
    from repro_torch import convert
    from repro_torch.core import hashing
finally:
    del sys.path[:2]

MISS = 0xFFFFFFFF
GRAIN = chip_smoke.FETCH_BYTES
STATES = chip_smoke.lookup_edge_states(np, 0)
MAKE = {"ht": convert.ht_state_from_numpy,
        "hti": convert.hti_state_from_numpy,
        "ch": convert.ch_state_from_numpy}
NAMES = {"ht": "ht_lookup", "hti": "hti_lookup", "ch": "ch_lookup"}


def u32(t) -> np.ndarray:
    return t.numpy().view(np.uint32)


def home(key: int, log2: int) -> int:
    return hashing.hash_dir_host(key) >> (32 - log2) if log2 else 0


def walk_open(tables, probes) -> tuple:
    """Key by key: each probe's distinct key blocks of ``GRAIN`` bytes up to
    its stopping slot and the value's on a hit; the second table for the
    first's misses."""
    total, found = 0, []
    for tk, log2 in tables:
        rest, hits = [], 0
        for key in probes:
            seen, hit = set(), False
            for j in range(32):
                p = (home(key, log2) + j) % (1 << log2)
                seen.add(4 * p // GRAIN)
                if tk[p] == key:
                    hit = True
                    break
                if tk[p] == MISS:
                    break
            total += len(seen) + hit
            hits += hit
            if not hit:
                rest.append(key)
        found.append(hits)
        probes = rest
    return total, found


def walk_ch(st, probes) -> tuple:
    """Key by key: each row's key blocks of ``GRAIN`` bytes (whole, the hit
    row up to its hit), each link followed and the value on a hit; and the
    heads' blocks the probes read, each once."""
    heads, nxt = st.heads.numpy(), st.next_bucket.numpy()
    bk = u32(st.bucket_keys)
    S = bk.shape[1]
    head_sectors = {4 * home(key, int(st.table_log2)) // GRAIN
                    for key in probes}
    total, hits = len(head_sectors), 0
    for key in probes:
        cur = int(heads[home(key, int(st.table_log2))])
        while cur >= 0:
            j = np.flatnonzero(bk[cur] == key)
            end = cur * S + (j[0] + 1 if j.size else S)
            total += (4 * end - 1) // GRAIN - 4 * cur * S // GRAIN + 2
            if j.size:
                hits += 1
                break
            cur = int(nxt[cur])
    return total, [hits]


@pytest.mark.parametrize("index", range(len(STATES)),
                         ids=[s[0] for s in STATES])
def test_sector_count_matches_a_walk(index):
    _, table, arrays, probes = STATES[index]
    st = MAKE[table](arrays, device="cpu")
    q = torch.from_numpy(probes.view(np.int32))
    got = chip_smoke.lookup_sectors_baseline(torch, NAMES[table], st, q)
    keys = [int(k) for k in probes]
    if table == "ch":
        want = walk_ch(st, keys)
    else:
        tables = [(u32(t), int(log2)) for t, log2 in
                  chip_smoke.open_tables(NAMES[table], st)]
        want = walk_open(tables, keys)
    assert got == want


def test_sector_floor_counts_the_stream():
    """The floor: the fetches at the measured random rate, the keys and
    results (8 bytes a key) at the memory rate."""
    rate = chip_smoke.RANDOM_READS_PER_S
    want = (1000 / rate + 8 * 10 / chip_smoke.HBM_BYTES_PER_S) * 1e3
    assert chip_smoke.sector_floor_ms(1000, 10) == pytest.approx(want)
