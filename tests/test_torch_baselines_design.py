"""The baselines' insert kernels' protocol (``csrc/baselines_insert.cu``),
emulated on the CPU (a test aid, not the functions' plain versions), held
bit for bit to the JAX package's sequential inserts on every state array.

The open tables (HT, HTI) place their insert stream (HT: the keys; HTI: the
live old slots each insert migrates, then the key; HT's doubling: the old
table's entries in old-slot order) by claim rounds, in segments of at most
R stream positions.  A segment's records hold each item's home and its
probe window as two masks (EMPTY slots, slots holding the key) read from
the table as the segment begins; a map keyed by key gives each key the
first and the last position among its items.  Only a key's first item
walks: it passes slots filled by other keys, stops at a slot that holds
its key (a hit), claims an EMPTY slot by ``atomicMin`` of its position (the
claims in any order; a loser moves on, a settled item outbid later moves
on again), and is dropped past its window.  The other items of the key
follow it, and the slot gets the last item's value.  The EMPTY pattern is
not grouped: each such key writes its value into the first slot still
EMPTY at its position and occupies nothing.  A segment ends before the
first key whose load test may fire, found from a prefix count that takes
every first item as fresh; after the placement an exact count decides
whether the test fires there (HT doubles, HTI starts a migration) or the
next segment begins.  Switched off, the key groups (or the last item's
value) leave duplicates or stale values, and the conflict-heavy traces
show it.
CH places a batch in closed form: the positions sorted stably by chain slot
(an LSD radix sort), each key at its chain's base (the tail's count as the
batch begins, S for an empty chain) plus its rank among the batch's keys of
its chain, and new buckets numbered in key order by a prefix count.
Switched off (buckets numbered chain by chain, or ranks in another order
than the keys'), the conflict-heavy trace shows it."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import baselines as jbl
from repro_torch.core import hashing

EMPTY = 0xFFFFFFFF
FREE = np.iinfo(np.int32).max
EDGE = np.array([0, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)
KERNEL_DIGIT_BITS = 8                # CH: the radix sort's digit
KERNEL_SEGMENT = 1 << 22             # open tables: positions a segment
PROBE = 32
NONE, KEY, OLD = 0, 1, 2             # record kinds (OLD: an old slot's entry)
WALK, SETTLED, HIT, DROPPED, FOUND = range(5)   # record states


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


def trigger_count(threshold, L) -> int:
    """The least count C whose load test ``f32(C) + 1 > f32(threshold) *
    2**L`` fires (a binary search, as the kernel's)."""
    thr = np.float32(threshold) * np.float32(1 << L)
    lo, hi = 0, FREE
    while lo < hi:
        mid = (lo + hi) // 2
        if np.float32(mid) + np.float32(1.0) > thr:
            hi = mid
        else:
            lo = mid + 1
    return lo


def fires(count, threshold, L) -> bool:
    return bool(np.float32(count) + np.float32(1.0)
                > np.float32(threshold) * np.float32(1 << L))


class OpenEmulation:
    """HT (``hti=False``) or HTI state as numpy arrays, changed in place.
    ``groups``: "last" (the kernel), "first" (the slot gets the first
    item's value) or "none" (every item walks on its own)."""

    def __init__(self, st, *, hti: bool, R: int, groups: str = "last",
                 seed: int = 0):
        self.a = {f: np.array(getattr(st, f)) for f in st._fields}
        self.hti, self.R, self.groups = hti, R, groups
        self.rng = np.random.default_rng(seed)
        self.max_rounds = self.outbid = 0

    def arrays(self):
        return self.a

    # -- the kernel: runs of the stream, each cut into segments -------------
    def insert(self, keys, vals, threshold=0.35, batch=1):
        a, hti = self.a, self.hti
        tk, tv = (a["new_keys"], a["new_vals"]) if hti else (a["keys"],
                                                             a["vals"])
        maxL = int(tk.size).bit_length() - 1
        L = int(a["new_log2"] if hti else a["size_log2"])
        oL = int(a["old_log2"]) if hti else 0
        c_new = int(a["new_count"] if hti else a["count"])
        c_old = int(a["old_count"]) if hti else 0
        dropped = int(a["dropped"])
        P = int(a["migrate_ptr"]) if hti else 0
        mig0 = bool(a["migrating"]) if hti else False
        B = batch if hti else 1
        owner = np.full(tk.size, FREE, np.int64)
        n = keys.size
        assert n + tk.size < 2**31          # positions fit an int32
        start, resume = 0, 0
        while True:
            nk = n - start
            E = 1 << oL
            D = E - P if hti and mig0 and P < E else 0
            kd = -(-D // B)
            kl = nk - 1 - resume
            vtot = nk if not hti else (1 if kl < 0 else resume + 1 + kl
                                       + min(B * (kl + 1), D))
            E0 = resume + max(kd - 1, 0) + D   # the first key that may fire

            def item(v):
                kind, x = stream_at(v, resume, B, D) if hti else ("key", v)
                if kind == "key":
                    return KEY, int(keys[start + x]), int(vals[start + x]), -1
                s = P + x
                if a["old_keys"][s] == EMPTY:
                    return None
                return OLD, int(a["old_keys"][s]), int(a["old_vals"][s]), s

            event, s0 = None, 0
            while s0 < vtot:
                s1 = min(s0 + self.R, vtot)
                recs = self.records(item, s0, s1, tk, L)
                first = {}
                for i, r in enumerate(recs):
                    if r is not None and r["key"] != EMPTY:
                        first.setdefault(r["key"], i)
                cand = None
                if L < maxL:
                    need = trigger_count(threshold, L) - (c_new + c_old)
                    if need <= 0:
                        cand = max(E0, s0)
                    else:                    # after the need-th +1 item
                        seen = 0
                        for i, r in enumerate(recs):
                            if r is not None and r["kind"] == KEY and (
                                    r["key"] == EMPTY or first[r["key"]] == i):
                                seen += 1
                                if seen == need:
                                    cand = max(s0 + i + 1, E0)
                                    break
                    if cand is not None and cand >= s1:
                        cand = None
                end = s1 if cand is None else cand
                d_new, d_old, d_drop = self.place(recs[:end - s0], s0, tk, tv,
                                                  L, owner, counting=True)
                c_new, c_old, dropped = (c_new + d_new, c_old - d_old,
                                         dropped + d_drop)
                if cand is not None and fires(c_new + c_old, threshold, L):
                    event = cand
                    break
                s0 = end
            if event is None:
                break
            size = 1 << L
            if hti:                          # start a migration (the flip)
                a["old_keys"][:size], a["old_vals"][:size] = tk[:size], \
                    tv[:size]
                tk[:size], tv[:size] = EMPTY, 0
                oL, L, c_old, c_new, P, mig0 = L, L + 1, c_new, 0, 0, True
                start += event - D
            else:                            # double: the same placement
                stage_k, stage_v = tk[:size].copy(), tv[:size].copy()
                tk[:2 * size], tv[:2 * size] = EMPTY, 0
                L += 1

                def staged(v):
                    if stage_k[v] == EMPTY:
                        return None
                    return OLD, int(stage_k[v]), int(stage_v[v]), -1

                for d0 in range(0, size, self.R):
                    d1 = min(d0 + self.R, size)
                    self.place(self.records(staged, d0, d1, tk, L), d0, tk,
                               tv, L, owner, counting=False)
                start += event
            resume = 1
        a["dropped"] = np.int32(dropped)
        if not hti:
            a["size_log2"], a["count"] = np.int32(L), np.int32(c_new)
            return
        a.update(old_log2=np.int32(oL), new_log2=np.int32(L),
                 old_count=np.int32(c_old), new_count=np.int32(c_new))
        if mig0:
            moved = B * (n - start - resume)
            a["migrate_ptr"] = np.int32(P + min(moved, D))
            a["migrating"] = np.bool_(moved < D)

    # -- a segment's records: the windows as the segment begins --------------
    def records(self, item, s0, s1, tk, L):
        mask, win = (1 << L) - 1, PROBE if L >= 5 else 1 << L
        recs = []
        for v in range(s0, s1):
            it = item(v)
            if it is None:
                recs.append(None)
                continue
            kind, key, val, src = it
            home = home_of(key, L)
            row = [int(tk[(home + j) & mask]) for j in range(win)]
            recs.append(dict(
                kind=kind, key=key, val=val, src=src, home=home,
                emp=sum(1 << j for j, x in enumerate(row) if x == EMPTY),
                hit=sum(1 << j for j, x in enumerate(row) if x == key)))
        return recs

    # -- one segment's placement ---------------------------------------------
    def place(self, recs, s0, tk, tv, L, owner, *, counting):
        """Claim rounds, the EMPTY pattern's pass, the writes; returns the
        new-table count's gain, the old count's loss and the drops."""
        mask, win = (1 << L) - 1, PROBE if L >= 5 else 1 << L
        wbits = (1 << win) - 1
        first, last = {}, {}
        for i, r in enumerate(recs):
            if r is None or r["key"] == EMPTY:
                continue
            k = r["key"] if self.groups != "none" else ("item", i)
            first.setdefault(k, i)
            last[k] = i
            r["group"] = k
        if self.groups == "first":
            last = first
        state, pos = {}, {}

        def slot(i):
            return (recs[i]["home"] + pos[i]) & mask

        active = [i for i, r in enumerate(recs) if r is not None
                  and r["key"] != EMPTY and first[r["group"]] == i]
        for i in active:
            state[i], pos[i] = WALK, 0
        rounds = 0
        while active:
            rounds += 1
            nxt, claimed = [], []
            for i in self.rng.permutation(active).tolist():   # any order
                r = recs[i]
                bits = (r["emp"] | r["hit"]) & wbits & ~((1 << pos[i]) - 1)
                if not bits:
                    state[i] = DROPPED
                    continue
                pos[i] = (bits & -bits).bit_length() - 1
                if (r["hit"] >> pos[i]) & 1:
                    state[i] = HIT
                    continue
                s, prio = slot(i), s0 + i
                old = int(owner[s])
                owner[s] = min(old, prio)
                if old != FREE and old > prio and state[old - s0] == SETTLED:
                    x = old - s0              # outbid after it settled
                    self.outbid += 1
                    state[x] = WALK
                    pos[x] += 1
                    nxt.append(x)
                claimed.append(i)
            for i in claimed:                 # the round's check
                if owner[slot(i)] == s0 + i:
                    state[i] = SETTLED
                else:
                    pos[i] += 1
                    nxt.append(i)
            active = nxt
        self.max_rounds = max(self.max_rounds, rounds)
        # the EMPTY pattern: the first slot still EMPTY at its position
        for i, r in enumerate(recs):
            if r is None or r["key"] != EMPTY:
                continue
            state[i], prio = DROPPED, s0 + i
            for j in range(win):
                if not (r["emp"] >> j) & 1:
                    continue
                s = (r["home"] + j) & mask
                o = int(owner[s])
                if o < 0 or o > prio:         # unclaimed, or claimed later
                    state[i], pos[i] = FOUND, j
                    if o == FREE or o < 0:    # the last such writer's value
                        owner[s] = min(o, -1 - prio)
                    break
        # the writes
        d_new = d_old = d_drop = 0
        for i, r in enumerate(recs):
            if r is None:
                continue
            if r["key"] == EMPTY:
                if state[i] == FOUND:
                    s = slot(i)
                    if owner[s] == -1 - (s0 + i):
                        tv[s] = r["val"]
                        owner[s] = FREE
                    d_new += 1
                else:
                    d_drop += 1
                continue
            f = first[r["group"]]
            st = state[f]
            if f == i and st in (SETTLED, HIT):
                s = slot(i)
                tk[s], tv[s] = r["key"], recs[last[r["group"]]]["val"]
                if st == SETTLED:
                    owner[s] = FREE
                    d_new += 1
            if r["kind"] == OLD and counting:
                self.a["old_keys"][r["src"]] = EMPTY
                d_old += 1
            elif r["kind"] == KEY and st == DROPPED:
                d_drop += 1
        assert (owner == FREE).all(), "a claim left behind"
        return (d_new, d_old, d_drop) if counting else (0, 0, 0)


class CHEmulation:
    """CH state as numpy arrays, changed in place by the kernel's closed
    form: the batch's positions sorted by chain slot (a stable LSD radix
    sort of ``digit_bits`` a pass, each a counting sort), chain groups, each
    chain's tail and count as the batch begins (an empty chain a full
    phantom bucket: base S), position base + rank in its chain, and new
    buckets numbered in key order.  ``order``: "key" (the kernel), "chain"
    (new buckets numbered group by group, as a prefix count over the sorted
    positions would) or "reversed" (a chain's ranks in reverse key order, as
    an unstable sort may leave them)."""

    def __init__(self, st, *, order: str = "key",
                 digit_bits: int = KERNEL_DIGIT_BITS):
        self.a = {f: np.array(getattr(st, f)) for f in st._fields}
        self.order, self.digit_bits = order, digit_bits
        self.radix_passes = 0

    def arrays(self):
        return self.a

    def sort(self, slot):
        """The positions stably sorted by ``slot`` (T bits), one counting
        sort a digit from the lowest."""
        T = int(self.a["heads"].size).bit_length() - 1
        perm = np.arange(slot.size)
        for shift in range(0, T, self.digit_bits):
            d = (slot[perm] >> shift) & ((1 << min(self.digit_bits,
                                                   T - shift)) - 1)
            at = np.concatenate([[0], np.cumsum(np.bincount(d))[:-1]])
            out = np.empty_like(perm)
            for k in range(perm.size):
                out[at[d[k]]] = perm[k]
                at[d[k]] += 1
            perm = out
            self.radix_passes += 1
        return perm

    def insert(self, keys, vals):
        a = self.a
        heads, nxt, counts = a["heads"], a["next_bucket"], a["counts"]
        bk, bv = a["bucket_keys"], a["bucket_vals"]
        C, S = bk.shape
        T = int(heads.size).bit_length() - 1
        n = keys.size
        nb0 = int(a["num_buckets"])
        slot = np.array([home_of(int(k), T) for k in keys], np.int64)
        perm = self.sort(slot)                  # sorted position -> key
        ss = slot[perm]
        head = np.ones(n, bool)
        head[1:] = ss[1:] != ss[:-1]
        gstart = np.flatnonzero(head)           # a group's first position
        grp = np.cumsum(head) - 1               # a sorted position's group
        size = np.diff(np.append(gstart, n))
        tail = np.empty(gstart.size, np.int64)  # one walk a group
        for g, k0 in enumerate(gstart):
            b = int(heads[ss[k0]])
            while b >= 0 and nxt[b] >= 0:
                b = int(nxt[b])
            tail[g] = b
        base = np.where(tail >= 0, counts[np.maximum(tail, 0)], S)
        old = tail >= 0                          # the old tails' new counts
        counts[tail[old]] = np.minimum(S, base[old] + size[old])
        rank = np.arange(n) - gstart[grp]
        if self.order == "reversed":
            rank = size[grp] - 1 - rank
        p = base[grp] + rank
        q, j = p // S, p % S
        opens = (q >= 1) & (j == 0)
        bucket = np.zeros(n, np.int64)          # an opener's new bucket
        if self.order == "chain":
            bucket[opens] = nb0 + np.arange(int(opens.sum()))
        else:                                   # a prefix count, key order
            at_key = np.zeros(n, np.int64)
            at_key[perm] = opens
            before = np.cumsum(at_key) - at_key
            bucket[opens] = nb0 + before[perm][opens]
        # sorted position of a key's opener (rank r - j), of the previous one
        opener = np.arange(n) - j
        if self.order == "reversed":
            opener = np.arange(n) + j
        drops = 0
        for k in range(n):
            i, g, t = perm[k], grp[k], tail[grp[k]]
            if q[k] == 0:
                bk[t, j[k]], bv[t, j[k]] = keys[i], vals[i]
                continue
            b = bucket[opener[k]]
            if b >= C:
                drops += 1
                continue
            bk[b, j[k]], bv[b, j[k]] = keys[i], vals[i]
            if j[k] == 0:
                counts[b] = min(S, base[g] + size[g] - q[k] * S)
                if q[k] > 1:
                    prev = k - S if self.order != "reversed" else k + S
                    nxt[bucket[prev]] = b
                elif t >= 0:
                    nxt[t] = b
                else:
                    heads[ss[k]] = b
        a["num_buckets"] = np.int32(nb0 + min(int(opens.sum()), C - nb0))
        a["dropped"] = np.int32(int(a["dropped"]) + drops)


# -- running a trace against the JAX package ---------------------------------

def run_ht(keys, vals, batch, *, max_log2, init_log2, R, state=None,
           groups="last", emu_out=None):
    jst = jbl.ht_create(max_log2, init_log2) if state is None else state
    emu = OpenEmulation(jst, hti=False, R=R, groups=groups)
    if emu_out is not None:
        emu_out.append(emu)
    for i in range(0, keys.size, batch):
        jst = jbl.ht_insert_many(jst, jnp.asarray(keys[i:i + batch]),
                                 jnp.asarray(vals[i:i + batch]))
        emu.insert(keys[i:i + batch], vals[i:i + batch])
        if not same(jst, emu):
            return False
    return True


def run_hti(keys, vals, batch, *, max_log2=None, init_log2=None, B, R,
            state=None, groups="last"):
    jst = jbl.hti_create(max_log2, init_log2) if state is None else state
    emu = OpenEmulation(jst, hti=True, R=R, groups=groups)
    for i in range(0, keys.size, batch):
        jst = jbl.hti_insert_many(jst, jnp.asarray(keys[i:i + batch]),
                                  jnp.asarray(vals[i:i + batch]),
                                  migrate_batch=B)
        emu.insert(keys[i:i + batch], vals[i:i + batch], batch=B)
        if not same(jst, emu):
            return False
    return True


def run_ch(keys, vals, batch, *, table_log2, capacity, slots, order="key",
           check=None):
    jst = jbl.ch_create(table_log2, capacity, slots)
    emu = CHEmulation(jst, order=order)
    for i in range(0, keys.size, batch):
        if check is not None and i == batch:
            check(jst, emu)
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


def ht_state(keys, vals, size_log2, count):
    return jbl.HTState(jnp.asarray(keys), jnp.asarray(vals),
                       jnp.int32(size_log2), jnp.int32(count), jnp.int32(0))


def same_home_keys(rng, n, log2, home):
    from test_torch_baselines import same_home_keys as keys_of_home
    return keys_of_home(rng, n, log2, home)


def other_home_keys(rng, n, log2, lo, hi):
    """Distinct keys whose probe window in a table of ``2**log2`` slots
    (cyclic) misses the slots ``[lo, hi)``."""
    size = 1 << log2
    avoid = {s % size for s in range(lo, hi)}
    out = []
    while len(out) < n:
        k = int(unique_keys(rng, 1)[0])
        h = home_of(k, log2)
        if k not in out and not avoid & {(h + j) % size
                                         for j in range(min(PROBE, size))}:
            out.append(k)
    return np.array(out, np.uint32)


# Segment caps R: 8 stream positions (many segments a batch) and a batch
# whole (the kernel's cap, 2^22, is past every trace here).

@pytest.mark.parametrize("R", [8, 1024])
def test_ht_windows_match_jax(rng, R):
    """tests/test_baselines.py's rehash trace and a table filled to its
    maximum until it drops, with re-inserts and the edge keys, by claim
    rounds."""
    keys = unique_keys(rng, 400)
    assert run_ht(keys, np.arange(400, dtype=np.uint32), 100, max_log2=12,
                  init_log2=4, R=R)
    keys = with_edges(unique_keys(rng, 120))
    keys = np.concatenate([keys, keys[:25]])
    assert run_ht(keys, np.arange(keys.size, dtype=np.uint32), 35,
                  max_log2=6, init_log2=4, R=R)


@pytest.mark.parametrize("R", [8, 1024])
def test_ht_claim_rounds_lose_as_the_reference(rng, R):
    """The doubling's claim rounds on a fabricated state whose doubled table
    has a full window (``test_torch_baselines.lossy_ht_state``)."""
    from test_torch_baselines import lossy_ht_state
    st = jbl.HTState(*(jnp.asarray(x) for x in lossy_ht_state(rng)))
    keys = unique_keys(rng, 10)
    assert run_ht(keys, np.arange(10, dtype=np.uint32), 10, max_log2=10,
                  init_log2=6, R=R, state=st)


@pytest.mark.parametrize("R", [8, 2048])
def test_hti_windows_match_jax(rng, R):
    """tests/test_baselines.py's trace (60-key batches, migrate_batch 16),
    re-inserts of keys still in the old table, edge keys, and a drain, by
    claim rounds."""
    keys = unique_keys(rng, 600)
    assert run_hti(keys, np.arange(600, dtype=np.uint32), 60, max_log2=13,
                   init_log2=4, B=16, R=R)
    keys = with_edges(unique_keys(rng, 150))
    keys = np.concatenate([keys, keys[::4]])
    assert run_hti(keys, np.arange(keys.size, dtype=np.uint32), 40,
                   max_log2=10, init_log2=4, B=8, R=R)


def ch_trace(rng, case):
    """(keys, batch, run_ch's settings, a check of the first batch's state)
    of one CH trace."""
    if case == "chains":           # tests/test_baselines.py's chains
        return unique_keys(rng, 500), 125, dict(
            table_log2=4, capacity=256, slots=8), None
    if case == "edge_keys":        # capacity out, duplicates, edge keys
        keys = with_edges(unique_keys(rng, 300))
        return np.concatenate([keys, keys[:60]]), 90, dict(
            table_log2=3, capacity=40, slots=8), None
    if case == "one_chain":        # test_torch_baselines.same_ch_chain_keys
        from test_torch_baselines import same_ch_chain_keys
        return same_ch_chain_keys(rng, 240, 3), 120, dict(
            table_log2=3, capacity=64, slots=4), \
            lambda jst, emu: int(jst.num_buckets) == 30
    if case == "capacity_mid_batch":   # 64 chains, 4-slot buckets, 100 room
        return unique_keys(rng, 900), 600, dict(
            table_log2=6, capacity=100, slots=4), \
            lambda jst, emu: int(jst.num_buckets) == 100 \
            and int(jst.dropped) > 0
    assert case == "t17"           # three radix passes, one bit the last
    return unique_keys(rng, 600), 300, dict(
        table_log2=17, capacity=1024, slots=16), \
        lambda jst, emu: emu.radix_passes == 3


@pytest.mark.parametrize("case", ["chains", "edge_keys", "one_chain",
                                  "capacity_mid_batch", "t17"])
def test_ch_placement_matches_jax(rng, case):
    """CH's closed-form placement on the chains of tests/test_baselines.py,
    capacity running out with duplicate appends and the edge keys, one chain
    taking whole batches, capacity running out inside a batch over many
    chains, and 2^17 chains, all arrays bit for bit after every batch."""
    keys, batch, kw, first = ch_trace(rng, case)
    seen = []
    assert run_ch(keys, np.arange(keys.size, dtype=np.uint32), batch,
                  check=lambda jst, emu: seen.append(
                      first is None or first(jst, emu)), **kw)
    assert seen == [True]


def conflict_heavy(rng):
    """One batch that re-inserts a third of its keys: in one segment (HT
    does not double; HTI starts one migration past the 358th key, which
    the batch drains) many keys have an earlier item of their own key
    (HTI: a re-insert before its old copy migrates too), and in CH (8
    chains) every chain takes many keys and opens buckets in turn with the
    others."""
    keys = unique_keys(rng, 300)
    return np.concatenate([keys, keys[::3]])


@pytest.mark.parametrize("corrections", [True, False])
def test_conflict_heavy_traces_need_the_corrections(rng, corrections):
    """Without key groups (every item walks alone) the open tables end
    with duplicate keys; CH's buckets numbered chain by chain, or its ranks
    in reverse key order, are not the reference's."""
    keys = conflict_heavy(rng)
    vals = rng.integers(0, 2**32 - 1, keys.size, dtype=np.uint32)
    groups = "last" if corrections else "none"
    emu = []
    results = [
        run_ht(keys, vals, keys.size, max_log2=10, init_log2=10,
               R=KERNEL_SEGMENT, groups=groups, emu_out=emu),
        run_hti(keys, vals, keys.size, max_log2=11, init_log2=10, B=32,
                R=KERNEL_SEGMENT, groups=groups)]
    results += [run_ch(keys, vals, keys.size, table_log2=3, capacity=128,
                       slots=8, order=order)
                for order in (["key"] if corrections else ["chain",
                                                           "reversed"])]
    assert results == [corrections] * len(results)
    assert emu[0].outbid > 0        # settled items outbid by a later claim


def test_conflict_heavy_traces_need_the_last_value(rng):
    """With key groups but the first item's value, a key inserted twice in
    one segment keeps its old value (HT), and a migrated entry no longer
    writes its old value over the newer one (HTI's stale overwrite)."""
    keys = conflict_heavy(rng)
    vals = rng.integers(0, 2**32 - 1, keys.size, dtype=np.uint32)
    for groups, want in (("first", False), ("last", True)):
        assert run_ht(keys, vals, keys.size, max_log2=10, init_log2=10,
                      R=KERNEL_SEGMENT, groups=groups) == want
        assert run_hti(keys, vals, keys.size, max_log2=11, init_log2=10,
                       B=32, R=KERNEL_SEGMENT, groups=groups) == want


@pytest.mark.parametrize("hti", [False, True])
@pytest.mark.parametrize("R", [2, 1024])
def test_empty_pattern_slot_taken_later(rng, hti, R):
    """EMPTY-pattern keys write their value into the first slot still EMPTY
    and occupy nothing: two of them into one slot (the last value stays
    until a key takes it), a key taking that slot, one more moved past it,
    a later key taking that one's slot, and one left standing."""
    L = 6
    he = home_of(EMPTY, L)
    x, y = (int(k) for k in same_home_keys(rng, 2, L, he))
    z = int(other_home_keys(rng, 1, L, he, he + 4)[0])
    keys = np.array([EMPTY, EMPTY, x, EMPTY, z, y, EMPTY, EMPTY], np.uint32)
    vals = np.arange(11, 19, dtype=np.uint32)
    if hti:
        assert run_hti(keys, vals, keys.size, max_log2=8, init_log2=L, B=4,
                       R=R)
        return
    emu = []
    assert run_ht(keys, vals, keys.size, max_log2=8, init_log2=L, R=R,
                  emu_out=emu)
    a = emu[0].a
    slots = [(he + j) % 64 for j in range(4)]
    assert a["keys"][slots].tolist() == [x, y, EMPTY, EMPTY]
    assert a["vals"][slots].tolist() == [13, 16, 18, 0]
    assert int(a["count"]) == 8


@pytest.mark.parametrize("R", [8, 1024])
def test_initial_copy_behind_an_empty_slot(rng, R):
    """A fabricated state with a key two slots past its EMPTY home (the
    slot between held by another key; no insert makes this): its first
    item claims the EMPTY home unless an earlier key takes it, and then
    hits the copy."""
    L = 6
    k = int(unique_keys(rng, 1)[0])
    h = home_of(k, L)
    x = int(same_home_keys(rng, 1, L, h)[0])
    y = int(unique_keys(rng, 1)[0])
    keys = np.full(1 << 8, EMPTY, np.uint32)
    vals = np.zeros(1 << 8, np.uint32)
    keys[(h + 1) % 64], keys[(h + 2) % 64] = y, k
    vals[(h + 1) % 64], vals[(h + 2) % 64] = 5, 6
    for batch, held in (([x, k], [x, y, k]), ([k, x], [k, y, k])):
        emu = []
        assert run_ht(np.array(batch, np.uint32), np.array([7, 8], np.uint32),
                      2, max_log2=8, init_log2=L, R=R,
                      state=ht_state(keys, vals, L, 2), emu_out=emu)
        got = emu[0].a["keys"][[(h + j) % 64 for j in range(3)]].tolist()
        assert got == held


@pytest.mark.parametrize("R", [3, 1024])
def test_drops_ahead_of_a_doubling_trigger(rng, R):
    """A fabricated crowded table (40 slots filled from one home on, so
    that keys of that home find their window full): the keys of one batch
    that drop come first, and the prefix count that takes them as fresh
    sets a segment end the exact count does not fire at; the doubling
    comes several keys later."""
    L = 7
    h = 40
    keys = np.full(1 << 9, EMPTY, np.uint32)
    vals = np.zeros(1 << 9, np.uint32)
    keys[h:h + 40] = unique_keys(rng, 40)
    vals[h:h + 40] = np.arange(1, 41, dtype=np.uint32)
    crowd = same_home_keys(rng, 6, L, h)
    fresh = other_home_keys(rng, 12, L, h, h + 40)
    batch = np.concatenate([crowd, fresh, crowd[:2]])
    bvals = np.arange(100, 100 + batch.size, dtype=np.uint32)
    st = ht_state(keys, vals, L, 40)
    assert run_ht(batch, bvals, batch.size, max_log2=9, init_log2=L, R=R,
                  state=st)
    want = jbl.ht_insert_many(st, jnp.asarray(batch), jnp.asarray(bvals))
    assert int(want.size_log2) == L + 1 and int(want.dropped) == 6


@pytest.mark.parametrize("R", [8, 1024])
def test_dropped_migration_reinserted(rng, R):
    """HTI mid-migration into a crowded new table (a fabricated state): an
    old entry whose window is full is dropped when the migration reaches it
    (without a count), and a later key of the batch re-inserts that key
    (dropped, counted); another key is inserted before its old copy
    migrates and drops."""
    oL, L = 6, 7
    h = 30
    crowd = same_home_keys(rng, 2, L, h)
    old_k = np.full(1 << 9, EMPTY, np.uint32)
    old_v = np.zeros(1 << 9, np.uint32)
    old_k[:8] = np.concatenate([crowd[:1], unique_keys(rng, 2), crowd[1:],
                                unique_keys(rng, 4)])
    old_v[:8] = np.arange(1, 9, dtype=np.uint32)
    new_k = np.full(1 << 9, EMPTY, np.uint32)
    new_v = np.zeros(1 << 9, np.uint32)
    new_k[h:h + 40] = unique_keys(rng, 40)
    new_v[h:h + 40] = np.arange(50, 90, dtype=np.uint32)
    st = jbl.HTIState(
        jnp.asarray(old_k), jnp.asarray(old_v), jnp.asarray(new_k),
        jnp.asarray(new_v), jnp.int32(oL), jnp.int32(L), jnp.int32(8),
        jnp.int32(40), jnp.int32(0), jnp.bool_(True), jnp.int32(0))
    fresh = other_home_keys(rng, 3, L, h, h + 40)
    batch = np.array([crowd[1], fresh[0], crowd[0], fresh[1], fresh[2]],
                     np.uint32)
    bvals = np.arange(200, 205, dtype=np.uint32)
    assert run_hti(batch, bvals, batch.size, B=1, R=R, state=st)
    want = jbl.hti_insert_many(st, jnp.asarray(batch), jnp.asarray(bvals),
                               migrate_batch=1)
    assert int(want.dropped) == 2 and int(want.old_count) == 3


@pytest.mark.parametrize("R", [8, 1024])
def test_tables_under_32_slots(rng, R):
    """HT from 1 slot and HTI from 2 slots up to 16: windows that wrap,
    duplicates, the edge keys and drops once the 16 slots are full."""
    keys = with_edges(unique_keys(rng, 18))
    keys = np.concatenate([keys, keys[:5]])
    vals = np.arange(keys.size, dtype=np.uint32)
    assert run_ht(keys, vals, 5, max_log2=4, init_log2=0, R=R)
    assert run_hti(keys, vals, 5, max_log2=4, init_log2=1, B=2, R=R)


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


def test_trigger_count_is_the_reference_test():
    """``trigger_count`` (the kernel's binary search) is the least count
    whose float32 load test fires, past float32's exact integers too."""
    for thr in (0.35, 0.3, 0.5):
        for L in (0, 3, 9, 20, 26, 30):
            c = trigger_count(thr, L)
            assert fires(c, thr, L) and (c == 0 or not fires(c - 1, thr, L))


def test_windows_match_the_kernel_source():
    """The constants the emulations mirror are the kernels' (in the
    source): CH's radix digit, the open tables' segment cap, probe window and
    free owner, and the record kinds and states."""
    import re
    from pathlib import Path

    from repro_torch.kernels import baselines_insert as ins
    src = (Path(ins.__file__).with_name("csrc")
           / "baselines_insert.cu").read_text()

    def const(name):
        m = re.search(rf"\b{name} = (\d+)(?:ll)?(?: << (\d+))?;", src)
        return int(m.group(1)) << int(m.group(2) or 0)

    assert const("kDigitBits") == KERNEL_DIGIT_BITS
    assert const("kSegment") == KERNEL_SEGMENT
    assert const("kProbe") == PROBE
    assert "kFree = INT_MAX" in src and FREE == 2**31 - 1
    kinds = re.search(r"enum Kind : uint8_t \{([^}]*)\}", src).group(1)
    assert [k.split("=")[0].strip() for k in kinds.split(",")] == \
        ["kNone", "kKey", "kOld"]
    states = re.search(r"enum State : uint8_t \{([^}]*)\}", src).group(1)
    assert [k.split("=")[0].strip() for k in states.split(",")] == \
        ["kWalk", "kSettled", "kHit", "kDropped", "kFound"]


@pytest.mark.parametrize("threshold", [0.35, 0.5])
@pytest.mark.parametrize("migrate_batch", [1, 64])
def test_hti_migration_work_space_bound(rng, migrate_batch, threshold):
    """The CUDA wrapper sizes HTI's owner array from the largest new table
    a batch may reach: the largest table the host loop starts a migration
    from, in a batch of any size up to 64 and a few large ones, from a
    state with a migration running or none, is never above the bound."""
    from repro_torch.core import baselines as tbl
    from repro_torch.kernels import baselines_insert as kern
    max_log2 = 12
    pre = unique_keys(rng, 3100)
    for n0 in (3, 40):
        st0 = tbl.hti_insert_many(
            tbl.hti_create(max_log2, 4, device="cpu"), pre[:n0], pre[:n0],
            migrate_batch, threshold)
        L0 = int(st0.new_log2)
        c0 = int(st0.new_count) + int(st0.old_count)
        assert bool(st0.migrating) == (n0 == 40 and migrate_batch == 1)
        for n in list(range(65)) + [179, 1000, 3000]:
            bound = kern._largest_doubling(L0, c0, n, max_log2, threshold)
            st = tbl.hti_insert_many(st0, pre[n0:n0 + n], pre[n0:n0 + n],
                                     migrate_batch, threshold)
            L1 = int(st.new_log2)
            largest = L1 - 1 if L1 > L0 else -1
            assert largest <= bound < max_log2, (n0, L0, c0, n, L1, bound)
