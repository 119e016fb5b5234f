"""The batch-insert kernel's protocol (``csrc/eh_insert.cu``), emulated on
the CPU (a test aid, not the function's plain version), held bit for bit to
the JAX package's sequential ``eh_insert_many`` on all eight state arrays.

The emulation follows the kernel: the keys go in windows of W; the records
of window k+1 (bucket, probe position and what it holds, count, local
depth) are taken from the state as it stood when window k's commit began;
before window k+1 commits, a record whose bucket is the record bucket of a
key of window k is taken again, and a record whose bucket an earlier key
of its own window shares is flagged `dup` (the written set); the commit
goes in key order, a dup key and the key a split was made for probed
again at the current state; a split places each side's keys by claim
rounds (every key claims slots from its home on, the key of the earliest
staged slot keeps a slot, the others move on).  Switched off, the written
set leaves stale records in use, and the conflict-heavy trace shows it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import extendible_hashing as jeh
from repro_torch.convert import state_to_numpy
from repro_torch.core import extendible_hashing as teh
from repro_torch.core import hashing

EMPTY = 0xFFFFFFFF


def unique_keys(rng, n):
    """Distinct uint32 keys in [1, 2**31), drawn without materializing the
    range."""
    return (rng.choice(2**31 - 1, n, replace=False) + 1).astype(np.uint32)


def _slot(h: int, g: int) -> int:
    return h >> (32 - g) if g else 0


def first_usable(row, key: int):
    """The probe of a record: first slot from the key's home holding the key
    or EMPTY, and what it holds; ``(-1, 0)`` for a full row without it."""
    S = row.size
    p = hashing.hash_bucket_host(key) % S
    for _ in range(S):
        x = int(row[p])
        if x == key or x == EMPTY:
            return p, x
        p = (p + 1) % S
    return -1, 0


def claim_rounds(old_k, old_v, l: int):
    """Both fresh rows of a split, by the kernel's claim rounds; and the
    live keys on each side."""
    S = old_k.size
    rows = [(np.full(S, EMPTY, np.uint32), np.zeros(S, np.uint32))
            for _ in range(2)]
    live = [j for j in range(S) if int(old_k[j]) != EMPTY]
    side = {j: (hashing.hash_dir_host(int(old_k[j])) >> (31 - l)) & 1
            for j in live}
    cand = {j: hashing.hash_bucket_host(int(old_k[j])) % S for j in live}
    owner = np.full((2, S), np.iinfo(np.int64).max, np.int64)
    while True:
        for j in live:                           # claims (atomicMin)
            owner[side[j], cand[j]] = min(owner[side[j], cand[j]], j)
        moved = False
        for j in live:                           # outbid: one slot on
            if owner[side[j], cand[j]] != j:
                cand[j] = (cand[j] + 1) % S
                moved = True
        if not moved:
            break
    for j in live:
        rows[side[j]][0][cand[j]] = old_k[j]
        rows[side[j]][1][cand[j]] = old_v[j]
    return rows, [sum(side[j] == s for j in live) for s in (0, 1)]


class Emulation:
    """The eight arrays as numpy copies, changed in place."""

    def __init__(self, st, *, written_set: bool = True):
        a = state_to_numpy(st)
        self.d, self.bk, self.bv = (np.array(x) for x in a[:3])
        self.counts, self.ld = np.array(a[3]), np.array(a[4])
        self.g, self.nb, self.dropped = int(a[5]), int(a[6]), int(a[7])
        self.C, self.S = self.bk.shape
        self.maxg = int(self.d.size).bit_length() - 1
        self.written_set = written_set

    def arrays(self):
        return (self.d, self.bk, self.bv, self.counts, self.ld,
                np.int32(self.g), np.int32(self.nb), np.int32(self.dropped))

    def record(self, key: int, val: int) -> dict:
        b = int(self.d[_slot(hashing.hash_dir_host(key), self.g)])
        idx, at = first_usable(self.bk[b], key)
        return dict(key=key, val=val, b=b, idx=idx, at=at,
                    cnt=int(self.counts[b]), ld=int(self.ld[b]))

    def split(self, h: int) -> None:
        d, ld = self.d, self.ld
        g = self.g
        if ld[d[_slot(h, g)]] == g:              # doubling, MSB indexing
            d[:2 << g] = d[np.arange(2 << g) >> 1]
            g += 1
        slot = _slot(h, g)
        b, b2 = int(d[slot]), self.nb
        l = int(ld[b])
        fresh, live = claim_rounds(self.bk[b], self.bv[b], l)
        (self.bk[b], self.bv[b]), (self.bk[b2], self.bv[b2]) = fresh
        self.counts[b], self.counts[b2] = live
        ld[b] = ld[b2] = l + 1
        start = (slot >> (g - l)) << (g - l)
        d[start + (1 << (g - l)) // 2:start + (1 << (g - l))] = b2
        self.g, self.nb = g, self.nb + 1

    def insert(self, keys, vals, W: int) -> None:
        keys, vals = keys.tolist(), vals.tolist()
        n = len(keys)
        wins = [(lo, min(lo + W, n)) for lo in range(0, n, W)]
        recs = [self.record(keys[i], vals[i]) for i in range(*wins[0])]
        prev = None
        for k, (lo, hi) in enumerate(wins):
            if prev is not None and self.written_set:   # resolve again
                written = {r["b"] for r in prev}
                recs = [self.record(r["key"], r["val"]) if r["b"] in written
                        else r for r in recs]
            dup = [self.written_set and any(recs[q]["b"] == recs[i]["b"]
                                            for q in range(i))
                   for i in range(len(recs))]
            # the lookahead: window k+1 from the state as window k begins
            nxt = ([self.record(keys[i], vals[i]) for i in range(*wins[k + 1])]
                   if k + 1 < len(wins) else None)
            i, again = lo, False
            while i < hi:
                r = recs[i - lo]
                if again or dup[i - lo]:
                    r = self.record(r["key"], r["val"])
                    again = False
                present = r["idx"] >= 0 and r["at"] == r["key"]
                if (r["cnt"] >= self.S and not present and self.nb < self.C
                        and (r["ld"] < self.g or self.g < self.maxg)):
                    self.split(hashing.hash_dir_host(r["key"]))
                    again = True
                    continue
                if r["idx"] >= 0:
                    self.bk[r["b"], r["idx"]] = r["key"]
                    self.bv[r["b"], r["idx"]] = r["val"]
                    if r["at"] == EMPTY:
                        self.counts[r["b"]] = r["cnt"] + 1
                else:
                    self.dropped += 1
                i += 1
            prev, recs = recs, nxt


def run(keys, vals, batch, *, depth, slots, capacity, W, written_set=True):
    """Whether the emulation stays bit-identical to JAX after every batch."""
    jst = jeh.eh_create(depth, slots, capacity)
    emu = Emulation(teh.eh_create(depth, slots, capacity, device="cpu"),
                    written_set=written_set)
    for i in range(0, keys.size, batch):
        jst = jeh.eh_insert_many(jst, jnp.asarray(keys[i:i + batch]),
                                 jnp.asarray(vals[i:i + batch]))
        emu.insert(keys[i:i + batch], vals[i:i + batch], W)
        for f, got in zip(jeh.EHState._fields, emu.arrays()):
            want = np.asarray(getattr(jst, f))
            if not np.array_equal(np.asarray(got, want.dtype), want):
                return False
    return True


# (n keys, batch, max depth, bucket slots, capacity): tests/
# test_torch_extendible_hashing.py's traces (cascading splits and doublings;
# a saturated directory; capacity exhausted)
TRACES = [(1500, 300, 10, 4, 1024),
          (800, 800, 9, 8, 256),
          (600, 150, 4, 8, 64),
          (900, 100, 8, 4, 40)]


@pytest.mark.parametrize("W", [8, 124])
@pytest.mark.parametrize("n,batch,depth,slots,capacity", TRACES)
def test_windowed_insert_matches_jax(rng, n, batch, depth, slots, capacity,
                                     W):
    keys = unique_keys(rng, n)
    vals = rng.integers(0, 2**32 - 1, n, dtype=np.uint32)
    assert run(keys, vals, batch, depth=depth, slots=slots,
               capacity=capacity, W=W)


@pytest.mark.parametrize("W", [8, 124])
def test_windowed_insert_overwrites_and_edge_keys(rng, W):
    keys = unique_keys(rng, 300)
    keys = np.concatenate([keys, keys[:60], np.array(
        [0, 0xFFFFFFFE, 0xFFFFFFFF, 0], np.uint32), keys[100:140]])
    vals = np.arange(keys.size, dtype=np.uint32)
    assert run(keys, vals, 64, depth=8, slots=8, capacity=256, W=W)


def conflict_heavy(rng):
    """Few buckets and a window far wider than their count: most records
    share a bucket with an earlier key of their window or the last."""
    keys = unique_keys(rng, 400)
    keys = np.concatenate([keys, keys[::3]])          # re-inserts too
    vals = rng.integers(0, 2**32 - 1, keys.size, dtype=np.uint32)
    return keys, vals, dict(depth=3, slots=8, capacity=8, W=64)


def test_conflict_heavy_trace_matches_jax(rng):
    keys, vals, kw = conflict_heavy(rng)
    assert run(keys, vals, keys.size, **kw)


def test_conflict_heavy_trace_needs_the_written_set(rng):
    keys, vals, kw = conflict_heavy(rng)
    assert not run(keys, vals, keys.size, written_set=False, **kw)


@pytest.mark.parametrize("S", [4, 8, 64, 512])
def test_claim_rounds_place_as_bucket_put(S):
    """A split's claim rounds give the rows of the reference's slot-order
    bucket_put (``core/extendible_hashing.py:_split_bucket``), from full
    and part-full staged rows."""
    rng = np.random.default_rng(S)
    for fill in (S, S - 1, S // 2, 1):
        old_k = np.full(S, EMPTY, np.uint32)
        old_v = rng.integers(0, 2**32 - 1, S, dtype=np.uint32)
        for key in unique_keys(rng, fill).tolist():
            p = hashing.hash_bucket_host(key) % S
            while old_k[p] != EMPTY:
                p = (p + 1) % S
            old_k[p] = key
        for l in (0, 3):
            rows, n = claim_rounds(old_k, old_v, l)
            want = [(np.full(S, EMPTY, np.uint32), np.zeros(S, np.uint32))
                    for _ in range(2)]
            c = [0, 0]
            for key, val in zip(old_k.tolist(), old_v.tolist()):
                if key == EMPTY:
                    continue
                side = (hashing.hash_dir_host(key) >> (31 - l)) & 1
                c[side] += teh.bucket_put(*want[side], key, val)[0]
            for s in (0, 1):
                np.testing.assert_array_equal(rows[s][0], want[s][0])
                np.testing.assert_array_equal(rows[s][1], want[s][1])
            assert n == c


def test_window_and_shared_memory_match_the_kernel_source():
    """The wrapper's window and shared-memory count are the kernel's."""
    import re
    from pathlib import Path

    from repro_torch.kernels import eh_insert as ins
    src = (Path(ins.__file__).with_name("csrc") / "eh_insert.cu").read_text()
    assert int(re.search(r"kWindow = (\d+);", src).group(1)) == ins.WINDOW
    per_slot = int(re.search(r"return \((\d+) \* static_cast<size_t>\(S\)",
                             src).group(1))
    static = int(re.search(r"sizeof\(Shared\) == (\d+)", src).group(1))
    assert int(re.search(r"kMaxShared = (\d+);", src).group(1)) == \
        ins.MAX_SHARED_BYTES
    assert ins.shared_bytes(512) == \
        per_slot * 512 + 2 * ins.WINDOW * 32 + static


def test_wrapper_refuses_rows_past_the_shared_memory_limit():
    """The largest row the block's shared memory holds passes the wrapper's
    check (and is refused only for lying on the CPU); one slot more is
    refused for its shared memory, as the launcher would refuse it."""
    from repro_torch.kernels import eh_insert as ins
    top = max(S for S in range(8000, 10000)
              if ins.shared_bytes(S) <= ins.MAX_SHARED_BYTES)
    assert top == 8632
    keys = torch.arange(3, dtype=torch.int32)
    for S, match in ((top, "CUDA device"), (top + 1, "shared memory")):
        st = teh.eh_create(2, S, 2, device="cpu")
        with pytest.raises(ValueError, match=match):
            ins.eh_insert_(st, keys, keys)
