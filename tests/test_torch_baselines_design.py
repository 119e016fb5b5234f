"""The baselines' insert kernels' protocol (``csrc/baselines_insert.cu``),
emulated on the CPU (a test aid, not the functions' plain versions), held
bit for bit to the JAX package's sequential inserts on every state array.

The emulation follows the kernels.  The open tables (HT, HTI) go in windows
of R stream items (HT: the keys; HTI: the live old slots each insert
migrates, then the key).  Each item's record holds its probe window as two
masks (EMPTY slots, slots holding the key) taken from the state as the
window begins.  The commit goes in key order, 32 items a step: an item is
stale when a slot its probe passes (home up to its choice) is in the shadow
of the slots the window wrote or is the choice of an item before it in the
step; the items before the first stale one, or before the first key whose
load test (on the exact count, a prefix count of the fresh slots) asks for a
doubling or a migration start, write at once; a stale item goes alone, its
window corrected from the shadow.  A doubling or a migration start ends the
launch; the launcher runs the grid pass (a doubling by claim rounds) and
starts again at that key.
CH's records hold each chain's tail and count; a key whose chain an earlier
key of its window has goes alone, at the chain as the window left it; new
buckets go in key order by a prefix count.  Switched off, the corrections
(the stale test and the shadow; CH's chain map) leave stale records in use,
and the conflict-heavy traces show it."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import baselines as jbl
from repro_torch.core import hashing

EMPTY = 0xFFFFFFFF
FREE = np.iinfo(np.int32).max
DONE, DOUBLE, MIGRATE = 0, 1, 2
EDGE = np.array([0, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)
KERNEL_WINDOW, KERNEL_STREAM = 1024, 2048   # HT and CH keys; HTI positions


def unique_keys(rng, n):
    return (rng.choice(2**31 - 1, n, replace=False) + 1).astype(np.uint32)


def home_of(key: int, L: int) -> int:
    return hashing.hash_dir_host(key) >> (32 - L) if L else 0


def stream_at(v, resume, B, D):
    """``csrc/baselines_insert.cu:stream_at``: ("key", k) or ("slot", d)."""
    if resume and v == 0:
        return "key", 0
    v -= resume
    kd = (D + B - 1) // B
    if kd == 0 or v > D + kd - 1:
        return "key", v - D + resume
    k1, r = divmod(v, B + 1)
    c = min(B, D - B * k1)
    return ("slot", B * k1 + r) if r < c else ("key", k1 + resume)


class OpenEmulation:
    """HT (``hti=False``) or HTI state as numpy arrays, changed in place."""

    def __init__(self, st, *, hti: bool, R: int, corrections: bool = True):
        self.a = {f: np.array(getattr(st, f)) for f in st._fields}
        self.hti, self.R, self.corrections = hti, R, corrections

    def arrays(self):
        return self.a

    # -- the launcher --------------------------------------------------------
    def insert(self, keys, vals, threshold=0.35, batch=1):
        start, resume = 0, 0
        while True:
            ev, at, L = self.launch(keys[start:], vals[start:], resume,
                                    threshold, batch)
            if ev == DONE:
                return
            if ev == DOUBLE:
                self.double(L)
            else:
                a = self.a
                n = 1 << L
                a["old_keys"][:n], a["old_vals"][:n] = (a["new_keys"][:n],
                                                        a["new_vals"][:n])
                a["new_keys"][:n], a["new_vals"][:n] = EMPTY, 0
            start, resume = start + at, 1

    def double(self, L):
        """The grid pass: claim rounds over the doubled table."""
        a = self.a
        keys, vals = a["keys"], a["vals"]
        size = 1 << L
        old_k, old_v = keys[:size].copy(), vals[:size].copy()
        owner = np.full(2 * size, FREE, np.int64)
        cand = np.zeros(size, np.int64)
        live = np.nonzero(old_k != EMPTY)[0]
        home = np.array([home_of(int(k), L + 1) for k in old_k[live]],
                        np.int64)
        win = 32 if L + 1 >= 5 else 2 << L
        while True:
            act = live[cand[live] < win]
            h = home[np.searchsorted(live, act)]
            pos = (h + cand[act]) & (2 * size - 1)
            np.minimum.at(owner, pos, act)
            lost = owner[pos] != act
            cand[act[lost]] += 1
            if not lost.any():
                break
        keys[:2 * size] = EMPTY
        vals[:2 * size] = 0
        held = owner != FREE
        keys[:2 * size][held] = old_k[owner[held]]
        vals[:2 * size][held] = old_v[owner[held]]
        a["size_log2"] = np.int32(L + 1)

    # -- one launch of the insert kernel -------------------------------------
    def launch(self, keys, vals, resume, threshold, B):
        a, hti, R = self.a, self.hti, self.R
        nk, nv = (a["new_keys"], a["new_vals"]) if hti else (a["keys"],
                                                             a["vals"])
        L = int(a["new_log2"] if hti else a["size_log2"])
        mask = (1 << L) - 1
        win = 32 if L >= 5 else 1 << L
        maxL = int(nk.size).bit_length() - 1
        can_grow = L < maxL
        thr = np.float32(threshold) * np.float32(1 << L)
        n = keys.size
        P = D = 0
        mig0 = False
        if hti:
            mig0 = bool(a["migrating"])
            P = int(a["migrate_ptr"])
            E = 1 << int(a["old_log2"])
            D = E - P if mig0 and P < E else 0
            kl = n - 1 - resume
            vtot = 1 if kl < 0 else resume + 1 + kl + (
                D if kl >= (D + B - 1) // B else min(B * (kl + 1), D))
        else:
            vtot = n
        c_new = int(a["new_count"] if hti else a["count"])
        c_old = int(a["old_count"]) if hti else 0
        dropped = int(a["dropped"])
        event, at = DONE, n
        for v0 in range(0, vtot, R):
            # items in stream order
            items = []
            for v in range(v0, min(v0 + R, vtot)):
                if hti:
                    kind, x = stream_at(v, resume, B, D)
                else:
                    kind, x = "key", v
                if kind == "key":
                    key = int(keys[x])
                    kp = x - resume
                    mig_after = hti and mig0 and B * (kp + 1) < D
                    can = (kp >= 0 and not mig_after and can_grow) if hti \
                        else (can_grow and not (resume and x == 0))
                    items.append(dict(key=key, val=int(vals[x]), src=-1 - x,
                                      can=can))
                else:
                    s = P + x
                    key = int(a["old_keys"][s])
                    if key != EMPTY:
                        items.append(dict(key=key, val=int(a["old_vals"][s]),
                                          src=s, can=False))
            for it in items:
                it["home"] = home_of(it["key"], L)
                row = [int(nk[(it["home"] + j) & mask]) for j in range(win)]
                it["emp"] = [x == EMPTY for x in row]
                it["hit"] = [x == it["key"] for x in row]
            shadow = {}
            m, i = len(items), 0

            def choose(emp, hit):
                for j in range(win):
                    if emp[j] or hit[j]:
                        return j, emp[j]
                return -1, False

            while i < m:
                group = items[i:i + 32]
                stop, trig_at = len(group), False
                before = c_new + c_old
                chosen = []                  # slots the lanes before choose
                for lane, it in enumerate(group):
                    j, fresh = choose(it["emp"], it["hit"])
                    span = j + 1 if j >= 0 else win
                    passed = {(it["home"] + d) & mask for d in range(span)}
                    stale = self.corrections and bool(
                        passed & (set(shadow) | set(chosen)))
                    trig = it["can"] and np.float32(before) + np.float32(1.0) \
                        > thr
                    if trig or stale:
                        stop, trig_at = lane, trig
                        break
                    before += int(fresh) - int(it["src"] >= 0)
                    if j >= 0:
                        chosen.append((it["home"] + j) & mask)
                for it in group[:stop]:               # the prefix, at once
                    j, fresh = choose(it["emp"], it["hit"])
                    self._commit(it, j, fresh, nk, nv, mask, shadow)
                    c_new += int(fresh)
                    if it["src"] >= 0:
                        c_old -= 1
                    elif j < 0:
                        dropped += 1
                if stop == len(group):
                    i += len(group)
                    continue
                i += stop
                it = items[i]
                if trig_at:
                    event = MIGRATE if hti else DOUBLE
                    at = -1 - it["src"]
                    break
                emp, hit = list(it["emp"]), list(it["hit"])  # alone
                for j in range(win):
                    p = (it["home"] + j) & mask
                    if p in shadow:
                        emp[j], hit[j] = shadow[p] == EMPTY, \
                            shadow[p] == it["key"]
                j, fresh = choose(emp, hit)
                self._commit(it, j, fresh, nk, nv, mask, shadow)
                c_new += int(fresh)
                if it["src"] >= 0:
                    c_old -= 1
                elif j < 0:
                    dropped += 1
                i += 1
            if event != DONE:
                break
        a["dropped"] = np.int32(dropped)
        if not hti:
            a["count"] = np.int32(c_new)
        elif event == MIGRATE:
            a.update(old_log2=np.int32(L), new_log2=np.int32(L + 1),
                     old_count=np.int32(c_new), new_count=np.int32(0),
                     migrate_ptr=np.int32(0), migrating=np.bool_(True))
        else:
            a["new_count"], a["old_count"] = np.int32(c_new), np.int32(c_old)
            if mig0:
                moved = B * (n - resume)
                a["migrate_ptr"] = np.int32(P + min(moved, D))
                a["migrating"] = np.bool_(moved < D)
        return event, at, L

    def _commit(self, it, j, fresh, nk, nv, mask, shadow):
        if j >= 0:
            p = (it["home"] + j) & mask
            nk[p], nv[p] = it["key"], it["val"]
            shadow[p] = it["key"]
        if it["src"] >= 0:
            self.a["old_keys"][it["src"]] = EMPTY


class CHEmulation:
    def __init__(self, st, *, W: int, corrections: bool = True):
        self.a = {f: np.array(getattr(st, f)) for f in st._fields}
        self.W, self.corrections = W, corrections

    def arrays(self):
        return self.a

    def insert(self, keys, vals):
        a = self.a
        heads, nxt, counts = a["heads"], a["next_bucket"], a["counts"]
        bk, bv = a["bucket_keys"], a["bucket_vals"]
        C, S = bk.shape
        T = int(heads.size).bit_length() - 1
        nb, dropped = int(a["num_buckets"]), int(a["dropped"])
        for base in range(0, keys.size, self.W):
            recs, first = [], {}
            for t in range(base, min(base + self.W, keys.size)):
                key = int(keys[t])
                slot = home_of(key, T)
                b = int(heads[slot])
                while b >= 0 and nxt[b] >= 0:
                    b = int(nxt[b])
                first.setdefault(slot, len(recs))
                recs.append(dict(key=key, val=int(vals[t]), slot=slot, tail=b,
                                 cnt=int(counts[b]) if b >= 0 else 0))
            chain = {}                       # the window map: tail, count
            for t, r in enumerate(recs):
                r["dup"] = self.corrections and first[r["slot"]] < t
                if first[r["slot"]] == t:
                    chain[r["slot"]] = (r["tail"], r["cnt"])

            def put(r, tail, cnt, nb):
                if tail >= 0 and cnt < S:
                    bk[tail, cnt], bv[tail, cnt] = r["key"], r["val"]
                    counts[tail] = cnt + 1
                    chain[r["slot"]] = (tail, cnt + 1)
                    return 0, 0
                if nb < C:
                    bk[nb, 0], bv[nb, 0], counts[nb] = r["key"], r["val"], 1
                    if tail < 0:
                        heads[r["slot"]] = nb
                    else:
                        nxt[tail] = nb
                    chain[r["slot"]] = (nb, 1)
                    return 1, 0
                return 0, 1

            i = 0
            while i < len(recs):
                group = recs[i:i + 32]
                stop = next((q for q, r in enumerate(group) if r["dup"]),
                            len(group))
                allocs = 0
                for r in group[:stop]:            # the prefix, at once
                    grew, lost = put(r, r["tail"], r["cnt"], nb + allocs)
                    room = r["tail"] >= 0 and r["cnt"] < S
                    allocs += int(not room)
                got = max(0, min(allocs, C - nb))
                nb, dropped = nb + got, dropped + allocs - got
                if stop == len(group):
                    i += len(group)
                    continue
                i += stop
                r = recs[i]                       # alone, at its chain now
                grew, lost = put(r, *chain[r["slot"]], nb)
                nb, dropped = nb + grew, dropped + lost
                i += 1
        a["num_buckets"], a["dropped"] = np.int32(nb), np.int32(dropped)


# -- running a trace against the JAX package ---------------------------------

def run_ht(keys, vals, batch, *, max_log2, init_log2, R, state=None,
           corrections=True):
    jst = jbl.ht_create(max_log2, init_log2) if state is None else state
    emu = OpenEmulation(jst, hti=False, R=R, corrections=corrections)
    for i in range(0, keys.size, batch):
        jst = jbl.ht_insert_many(jst, jnp.asarray(keys[i:i + batch]),
                                 jnp.asarray(vals[i:i + batch]))
        emu.insert(keys[i:i + batch], vals[i:i + batch])
        if not same(jst, emu):
            return False
    return True


def run_hti(keys, vals, batch, *, max_log2, init_log2, B, R,
            corrections=True):
    jst = jbl.hti_create(max_log2, init_log2)
    emu = OpenEmulation(jst, hti=True, R=R, corrections=corrections)
    for i in range(0, keys.size, batch):
        jst = jbl.hti_insert_many(jst, jnp.asarray(keys[i:i + batch]),
                                  jnp.asarray(vals[i:i + batch]),
                                  migrate_batch=B)
        emu.insert(keys[i:i + batch], vals[i:i + batch], batch=B)
        if not same(jst, emu):
            return False
    return True


def run_ch(keys, vals, batch, *, table_log2, capacity, slots, W,
           corrections=True):
    jst = jbl.ch_create(table_log2, capacity, slots)
    emu = CHEmulation(jst, W=W, corrections=corrections)
    for i in range(0, keys.size, batch):
        jst = jbl.ch_insert_many(jst, jnp.asarray(keys[i:i + batch]),
                                 jnp.asarray(vals[i:i + batch]))
        emu.insert(keys[i:i + batch], vals[i:i + batch])
        if not same(jst, emu):
            return False
    return True


def same(jst, emu) -> bool:
    got = emu.arrays()
    return all(np.array_equal(np.asarray(got[f]),
                              np.asarray(getattr(jst, f)))
               for f in jst._fields)


def with_edges(keys):
    third = keys.size // 3
    return np.concatenate([keys[:third], EDGE, keys[:third // 2],
                           keys[third:2 * third], EDGE, keys[2 * third:],
                           EDGE[::-1]])


@pytest.mark.parametrize("R", [8, KERNEL_WINDOW])
def test_ht_windows_match_jax(rng, R):
    """tests/test_baselines.py's rehash trace and a table filled to its
    maximum until it drops, with re-inserts and the edge keys."""
    keys = unique_keys(rng, 400)
    assert run_ht(keys, np.arange(400, dtype=np.uint32), 100, max_log2=12,
                  init_log2=4, R=R)
    keys = with_edges(unique_keys(rng, 120))
    keys = np.concatenate([keys, keys[:25]])
    assert run_ht(keys, np.arange(keys.size, dtype=np.uint32), 35,
                  max_log2=6, init_log2=4, R=R)


@pytest.mark.parametrize("R", [8, KERNEL_WINDOW])
def test_ht_claim_rounds_lose_as_the_reference(rng, R):
    """The doubling's claim rounds on a fabricated state whose doubled table
    has a full window (``test_torch_baselines.lossy_ht_state``)."""
    from test_torch_baselines import lossy_ht_state
    st = jbl.HTState(*(jnp.asarray(x) for x in lossy_ht_state(rng)))
    keys = unique_keys(rng, 10)
    assert run_ht(keys, np.arange(10, dtype=np.uint32), 10, max_log2=10,
                  init_log2=6, R=R, state=st)


@pytest.mark.parametrize("R", [8, KERNEL_STREAM])
def test_hti_windows_match_jax(rng, R):
    """tests/test_baselines.py's trace (60-key batches, migrate_batch 16),
    re-inserts of keys still in the old table, edge keys, and a drain."""
    keys = unique_keys(rng, 600)
    assert run_hti(keys, np.arange(600, dtype=np.uint32), 60, max_log2=13,
                   init_log2=4, B=16, R=R)
    keys = with_edges(unique_keys(rng, 150))
    keys = np.concatenate([keys, keys[::4]])
    assert run_hti(keys, np.arange(keys.size, dtype=np.uint32), 40,
                   max_log2=10, init_log2=4, B=8, R=R)


@pytest.mark.parametrize("W", [8, KERNEL_WINDOW])
def test_ch_windows_match_jax(rng, W):
    """tests/test_baselines.py's chains (table_log2 4, 8 slots), capacity
    running out, duplicate appends and the edge keys."""
    keys = unique_keys(rng, 500)
    assert run_ch(keys, np.arange(500, dtype=np.uint32), 125, table_log2=4,
                  capacity=256, slots=8, W=W)
    keys = with_edges(unique_keys(rng, 300))
    keys = np.concatenate([keys, keys[:60]])
    assert run_ch(keys, np.arange(keys.size, dtype=np.uint32), 90,
                  table_log2=3, capacity=40, slots=8, W=W)


def conflict_heavy(rng):
    """A window far wider than the table: most items have an earlier item
    of their window nearby (HT, HTI) or on their chain (CH)."""
    keys = unique_keys(rng, 300)
    return np.concatenate([keys, keys[::3]])


@pytest.mark.parametrize("corrections", [True, False])
def test_conflict_heavy_traces_need_the_corrections(rng, corrections):
    keys = conflict_heavy(rng)
    vals = rng.integers(0, 2**32 - 1, keys.size, dtype=np.uint32)
    results = [
        run_ht(keys, vals, keys.size, max_log2=10, init_log2=10,
               R=KERNEL_WINDOW, corrections=corrections),
        run_hti(keys, vals, keys.size // 4, max_log2=11, init_log2=4, B=32,
                R=KERNEL_STREAM, corrections=corrections),
        run_ch(keys, vals, keys.size, table_log2=3, capacity=128, slots=8,
               W=KERNEL_WINDOW, corrections=corrections)]
    assert results == [corrections] * 3


def test_stream_positions():
    """``stream_at`` lays each key's migrated slots before it, the last key
    of the migration short, and the keys after the drain alone; a resumed
    launch's first key migrates nothing."""
    for resume in (0, 1):
        B, D, n = 3, 8, 6
        seq = [stream_at(v, resume, B, D) for v in range(resume + D + n
                                                            - resume)]
        want = [("key", 0)] if resume else []
        d = 0
        for k in range(resume, n):
            for _ in range(min(B, D - d)):
                want.append(("slot", d))
                d += 1
            want.append(("key", k))
        assert seq == want


def test_windows_match_the_kernel_source():
    """The emulations' windows are the kernels' (``kWindowKeys``,
    ``kStream`` in the source)."""
    import re
    from pathlib import Path

    from repro_torch.kernels import baselines_insert as ins
    src = (Path(ins.__file__).with_name("csrc")
           / "baselines_insert.cu").read_text()
    assert int(re.search(r"kWindowKeys = (\d+);", src).group(1)) == \
        KERNEL_WINDOW
    assert int(re.search(r"kStream = (\d+);", src).group(1)) == \
        KERNEL_STREAM
