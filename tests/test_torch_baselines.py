"""Port parity: ``repro_torch.core.baselines`` against
``repro.core.baselines``.  After every batch of the same insert trace every
field of the HT (5), HTI (11) and CH (7) states must be identical, the
reference's quirks included (HT's silent loss in a doubling, HTI's stale
re-insert, CH's duplicate append), and so must the lookups."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbl
from repro.core import extendible_hashing as jeh
from repro_torch import convert
from repro_torch.core import baselines as tbl
from repro_torch.core import extendible_hashing as teh

MISS = 0xFFFFFFFF
EDGE = np.array([0, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def unique_keys(rng, n):
    """Distinct uint32 keys in [1, 2**31), drawn without materializing the
    range."""
    return (rng.choice(2**31 - 1, n, replace=False) + 1).astype(np.uint32)


def assert_equal(jst, tst, to_numpy):
    got = to_numpy(tst)
    for f in type(jst)._fields:
        want = np.asarray(getattr(jst, f))
        np.testing.assert_array_equal(getattr(got, f), want, err_msg=f)
        assert getattr(got, f).dtype == want.dtype, f


@functools.partial(jax.jit, static_argnames=("threshold",))
def _jax_ht_insert_many(st, keys, vals, threshold):
    """The reference's ``ht_insert_many`` at another load threshold (its
    batch insert fixes 0.35; ``ht_insert`` takes it)."""
    def body(s, kv):
        return jbl.ht_insert(s, kv[0], kv[1], threshold), None
    st, _ = jax.lax.scan(body, st, jnp.stack([keys, vals], axis=1))
    return st


# -- the three tables, each as (create, insert, lookup, to_numpy) ------------

def ht_trace(keys, vals, batch, max_log2, init_log2, threshold=0.35):
    jst = jbl.ht_create(max_log2, init_log2)
    tst = tbl.ht_create(max_log2, init_log2, device="cpu")
    for i in range(0, keys.size, batch):
        kb, vb = keys[i:i + batch], vals[i:i + batch]
        if threshold == 0.35:
            jst = jbl.ht_insert_many(jst, jnp.asarray(kb), jnp.asarray(vb))
        else:
            jst = _jax_ht_insert_many(jst, jnp.asarray(kb), jnp.asarray(vb),
                                      threshold)
        tst = tbl.ht_insert_many(tst, kb, vb, threshold)
        assert_equal(jst, tst, convert.ht_state_to_numpy)
    return jst, tst


def hti_trace(keys, vals, batch, max_log2, init_log2, migrate_batch,
              jst=None, tst=None):
    if jst is None:
        jst = jbl.hti_create(max_log2, init_log2)
        tst = tbl.hti_create(max_log2, init_log2, device="cpu")
    for i in range(0, keys.size, batch):
        kb, vb = keys[i:i + batch], vals[i:i + batch]
        jst = jbl.hti_insert_many(jst, jnp.asarray(kb), jnp.asarray(vb),
                                  migrate_batch=migrate_batch)
        tst = tbl.hti_insert_many(tst, kb, vb, migrate_batch)
        assert_equal(jst, tst, convert.hti_state_to_numpy)
    return jst, tst


def ch_trace(keys, vals, batch, table_log2, capacity, slots):
    jst = jbl.ch_create(table_log2, capacity, slots)
    tst = tbl.ch_create(table_log2, capacity, slots, device="cpu")
    for i in range(0, keys.size, batch):
        kb, vb = keys[i:i + batch], vals[i:i + batch]
        jst = jbl.ch_insert_many(jst, jnp.asarray(kb), jnp.asarray(vb))
        tst = tbl.ch_insert_many(tst, kb, vb)
        assert_equal(jst, tst, convert.ch_state_to_numpy)
    return jst, tst


def assert_lookups_equal(jlookup, tlookup, jst, tst, probe):
    want = np.asarray(jlookup(jst, jnp.asarray(probe)))
    got = tlookup(tst, probe).numpy()
    np.testing.assert_array_equal(got, want)
    return got


# -- HT ----------------------------------------------------------------------

def test_ht_rehash_trace(rng):
    """tests/test_baselines.py's trace (doublings from L = 4), batch by
    batch, then present and absent keys."""
    keys = unique_keys(rng, 500)
    vals = rng.integers(0, 2**32 - 1, 400, dtype=np.uint32)
    jst, tst = ht_trace(keys[:400], vals, 100, 12, 4)
    assert int(tst.size_log2) > 4 and int(tst.dropped) == 0
    got = assert_lookups_equal(jbl.ht_lookup_many, tbl.ht_lookup_many, jst,
                               tst, keys)
    np.testing.assert_array_equal(got[:400], vals)
    assert (got[400:] == MISS).all()


def test_ht_filled_to_max_until_it_drops(rng):
    """Doublings up to max_size_log2 = 6, then full windows refuse keys;
    re-inserts overwrite in place."""
    keys = unique_keys(rng, 120)
    keys = np.concatenate([keys, keys[:20]])
    vals = np.arange(keys.size, dtype=np.uint32)
    jst, tst = ht_trace(keys, vals, 35, 6, 4)
    assert int(tst.size_log2) == 6 and int(tst.dropped) > 0
    assert_lookups_equal(jbl.ht_lookup_many, tbl.ht_lookup_many, jst, tst,
                         keys)


def same_home_keys(rng, n, log2, home):
    """Distinct keys whose home slot in a table of ``2**log2`` is ``home``
    (the hash inverted: ``key = h * C1**-1 mod 2**32``)."""
    inv = pow(2654435761, -1, 2**32)
    low = rng.choice(1 << (32 - log2), n, replace=False).astype(np.uint64)
    h = (np.uint64(home) << np.uint64(32 - log2)) | low
    return ((h * np.uint64(inv)) & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def lossy_ht_state(rng):
    """A fabricated HT state (size 2**6) holding 40 keys of one home in the
    doubled table, one insert short of a doubling.  The inserts never make
    such a state: an old table packs at most 31 + k entries into the 32 + 2k
    slots of the doubled table that a loss needs; the reference's doubling
    still handles it, by losing the entries past a full window."""
    keys = np.full(1 << 10, MISS, np.uint32)
    vals = np.zeros(1 << 10, np.uint32)
    keys[3:43] = same_home_keys(rng, 40, 7, 5)
    vals[3:43] = np.arange(1, 41, dtype=np.uint32)
    return keys, vals, np.int32(6), np.int32(22), np.int32(0)


def test_ht_doubling_loses_entries_silently(rng):
    """A doubling that meets a full window drops the entry without a count,
    in both packages."""
    arrays = lossy_ht_state(rng)
    jst = jbl.HTState(*(jnp.asarray(a) for a in arrays))
    tst = convert.ht_state_from_numpy(arrays, device="cpu")
    keys = unique_keys(rng, 10)
    vals = np.arange(10, dtype=np.uint32)
    jst = jbl.ht_insert_many(jst, jnp.asarray(keys), jnp.asarray(vals))
    tst = tbl.ht_insert_many(tst, keys, vals)
    assert_equal(jst, tst, convert.ht_state_to_numpy)
    kept = np.isin(arrays[0][3:43], tst.keys.numpy()).sum()
    assert int(tst.size_log2) == 7 and kept == 32     # 8 lost, uncounted


def test_ht_edge_keys(rng):
    keys = unique_keys(rng, 90)
    keys = np.concatenate([keys[:30], EDGE, keys[30:60], EDGE, keys[60:],
                           EDGE[::-1]])
    vals = np.arange(keys.size, dtype=np.uint32)
    jst, tst = ht_trace(keys, vals, 33, 10, 4)
    assert_lookups_equal(jbl.ht_lookup_many, tbl.ht_lookup_many, jst, tst,
                         np.concatenate([keys, EDGE]))


# -- HTI ---------------------------------------------------------------------

def test_hti_migration_trace(rng):
    """tests/test_baselines.py's trace: 60-key batches at migrate_batch 16,
    migrations spanning several batches; lookups after every batch."""
    keys = unique_keys(rng, 600)
    vals = np.arange(600, dtype=np.uint32)
    jst = jbl.hti_create(13, 4)
    tst = tbl.hti_create(13, 4, device="cpu")
    spans = 0
    for i in range(0, 600, 60):
        jst, tst = hti_trace(keys[i:i + 60], vals[i:i + 60], 60, 13, 4, 16,
                             jst, tst)
        spans += bool(tst.migrating)
        got = assert_lookups_equal(jbl.hti_lookup_many, tbl.hti_lookup_many,
                                   jst, tst, keys[:i + 60])
        np.testing.assert_array_equal(got, vals[:i + 60])
    assert spans >= 2 and int(tst.dropped) == 0


def test_hti_drain(rng):
    """tests/test_baselines.py's drain: one insert of migrate_batch 4096
    ends the migration."""
    keys = unique_keys(rng, 300)
    jst, tst = hti_trace(keys, np.arange(300, dtype=np.uint32), 300, 12, 4,
                         64)
    jst, tst = hti_trace(keys[:1], np.zeros(1, np.uint32), 1, 12, 4, 4096,
                         jst, tst)
    assert not bool(tst.migrating) and int(tst.old_count) == 0


def test_hti_stale_reinsert(rng):
    """A key re-inserted while its old copy waits in the old table: the
    migration later finds it in the new table and writes the old value over
    the new one."""
    keys = unique_keys(rng, 200)
    vals = np.arange(200, dtype=np.uint32)
    jst, tst = hti_trace(keys, vals, 200, 12, 4, 4)
    assert bool(tst.migrating)
    ptr = int(tst.migrate_ptr)
    old = tst.old_keys.numpy()
    waiting = [k for k in keys.tolist() if k in set(old[ptr:].tolist())]
    key = np.array([waiting[-1]], np.uint32)
    old_val = int(vals[keys.tolist().index(waiting[-1])])
    jst, tst = hti_trace(key, np.array([999999], np.uint32), 1, 12, 4, 4,
                         jst, tst)
    assert 999999 in tst.new_vals.numpy().tolist()
    assert_lookups_equal(jbl.hti_lookup_many, tbl.hti_lookup_many, jst, tst,
                         key)
    jst, tst = hti_trace(keys[:1], np.zeros(1, np.uint32), 1, 12, 4, 4096,
                         jst, tst)
    assert not bool(tst.migrating)
    assert int(tbl.hti_lookup(tst, int(key[0]))) == old_val
    assert int(jbl.hti_lookup(jst, jnp.uint32(key[0]))) == old_val


def test_hti_edge_keys_and_reinserts(rng):
    keys = unique_keys(rng, 150)
    keys = np.concatenate([keys[:50], EDGE, keys[:20], keys[50:100], EDGE,
                           keys[100:], keys[60:90], EDGE[::-1]])
    vals = np.arange(keys.size, dtype=np.uint32)
    jst, tst = hti_trace(keys, vals, 40, 10, 4, 8)
    assert_lookups_equal(jbl.hti_lookup_many, tbl.hti_lookup_many, jst, tst,
                         np.concatenate([keys, EDGE]))


# -- CH ----------------------------------------------------------------------

def test_ch_chain_trace(rng):
    """tests/test_baselines.py's trace: table_log2 4, capacity 256, 8
    slots, chains of several buckets."""
    keys = unique_keys(rng, 600)
    vals = np.arange(500, dtype=np.uint32)
    jst, tst = ch_trace(keys[:500], vals, 125, 4, 256, 8)
    assert int(tst.dropped) == 0 and int(tst.num_buckets) > 16
    got = assert_lookups_equal(jbl.ch_lookup_many, tbl.ch_lookup_many, jst,
                               tst, keys)
    np.testing.assert_array_equal(got[:500], vals)
    assert (got[500:] == MISS).all()


def test_ch_until_capacity_and_duplicates(rng):
    """Capacity runs out (dropped > 0); a re-insert appends a second copy
    and the lookup finds the first."""
    keys = unique_keys(rng, 400)
    keys = np.concatenate([keys, keys[:50]])
    vals = np.arange(keys.size, dtype=np.uint32)
    jst, tst = ch_trace(keys, vals, 90, 3, 40, 8)
    assert int(tst.dropped) > 0 and int(tst.num_buckets) == 40
    assert_lookups_equal(jbl.ch_lookup_many, tbl.ch_lookup_many, jst, tst,
                         keys)
    # the duplicate append: 777 goes in, the old value reads back
    k = unique_keys(rng, 30)
    jst, tst = ch_trace(k, np.arange(30, dtype=np.uint32), 30, 3, 40, 8)
    jst = jbl.ch_insert_many(jst, jnp.asarray(k[:1]),
                             jnp.asarray([777], jnp.uint32))
    tst = tbl.ch_insert_many(tst, k[:1], [777])
    assert_equal(jst, tst, convert.ch_state_to_numpy)
    assert int(tbl.ch_lookup(tst, int(k[0]))) == 0


def test_ch_value_equal_to_miss(rng):
    """A stored value equal to the MISS pattern: the inserts still agree,
    and the port's lookup returns that value (the reference's lookup loop
    would never end on it; ROADMAP's deliberate differences)."""
    keys = same_ch_chain_keys(rng, 12, 3)
    vals = np.arange(12, dtype=np.uint32)
    vals[[0, 5, 11]] = MISS
    jst, tst = ch_trace(keys, vals, 12, 3, 16, 4)
    assert int(tst.num_buckets) == 3       # one chain of three buckets
    absent = unique_keys(rng, 4)
    got = tbl.ch_lookup_many(tst, np.concatenate([keys, absent])).numpy()
    np.testing.assert_array_equal(got[:12].view(np.uint32), vals)
    assert (got[12:].view(np.uint32) == MISS).all()
    assert int(tbl.ch_lookup(tst, int(keys[5]))) == MISS
    jval = jbl.ch_lookup(jst, jnp.uint32(keys[1]))
    assert int(jval) == 1


def same_ch_chain_keys(rng, n, table_log2):
    """n distinct keys whose chain slot is 0 in a table of 2**table_log2."""
    from repro_torch.core import hashing
    out = []
    while len(out) < n:
        k = unique_keys(rng, 64)
        out += [int(x) for x in k
                if hashing.hash_dir_host(int(x)) >> (32 - table_log2) == 0]
    return np.array(out[:n], np.uint32)


def test_ch_edge_keys(rng):
    keys = unique_keys(rng, 100)
    keys = np.concatenate([keys[:40], EDGE, keys[40:], EDGE, EDGE[::-1]])
    vals = np.arange(keys.size, dtype=np.uint32)
    jst, tst = ch_trace(keys, vals, 37, 4, 64, 8)
    assert_lookups_equal(jbl.ch_lookup_many, tbl.ch_lookup_many, jst, tst,
                         np.concatenate([keys, EDGE]))


# -- across packages ---------------------------------------------------------

def test_jax_states_continue_in_the_port(rng):
    """A JAX state of each table carried across with ``convert`` and
    continued in both packages."""
    keys = unique_keys(rng, 400)
    vals = np.arange(400, dtype=np.uint32)
    a, b = jnp.asarray(keys[:200]), jnp.asarray(vals[:200])
    cases = [
        (jbl.ht_insert_many(jbl.ht_create(11, 4), a, b),
         convert.ht_state_from_numpy, convert.ht_state_to_numpy,
         jbl.ht_insert_many, tbl.ht_insert_many),
        (jbl.hti_insert_many(jbl.hti_create(11, 4), a, b, migrate_batch=8),
         convert.hti_state_from_numpy, convert.hti_state_to_numpy,
         functools.partial(jbl.hti_insert_many, migrate_batch=8),
         functools.partial(tbl.hti_insert_many, migrate_batch=8)),
        (jbl.ch_insert_many(jbl.ch_create(4, 128, 8), a, b),
         convert.ch_state_from_numpy, convert.ch_state_to_numpy,
         jbl.ch_insert_many, tbl.ch_insert_many),
    ]
    for jst, to_port, to_numpy, jins, tins in cases:
        tst = to_port(jst, device="cpu")
        assert_equal(jst, tst, to_numpy)
        jst = jins(jst, jnp.asarray(keys[200:]), jnp.asarray(vals[200:]))
        tst = tins(tst, keys[200:], vals[200:])
        assert_equal(jst, tst, to_numpy)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_all_tables_agree(seed):
    """HT, HTI, CH and the port's EH answer identically for a key set
    (tests/test_baselines.py's cross-oracle)."""
    rng = np.random.default_rng(seed)
    keys = unique_keys(rng, 150)
    vals = np.arange(150, dtype=np.uint32)
    ht = tbl.ht_insert_many(tbl.ht_create(12, device="cpu"), keys, vals)
    hti = tbl.hti_insert_many(tbl.hti_create(12, device="cpu"), keys, vals)
    ch = tbl.ch_insert_many(tbl.ch_create(6, 512, device="cpu"), keys, vals)
    eh = teh.eh_insert_many(teh.eh_create(10, 8, 1024, device="cpu"), keys,
                            vals)
    for got in (tbl.ht_lookup_many(ht, keys), tbl.hti_lookup_many(hti, keys),
                tbl.ch_lookup_many(ch, keys), teh.eh_lookup_many(eh, keys)):
        np.testing.assert_array_equal(got.numpy(), vals)
    jht = jbl.ht_insert_many(jbl.ht_create(12), jnp.asarray(keys),
                             jnp.asarray(vals))
    assert_equal(jht, ht, convert.ht_state_to_numpy)


def test_states_are_left_as_they_were(rng):
    keys = unique_keys(rng, 50)
    st = tbl.ch_create(3, 16, 4, device="cpu")
    before = convert.ch_state_to_numpy(st)
    tbl.ch_insert_many(st, keys, keys)
    after = convert.ch_state_to_numpy(st)
    for f in tbl.CHState._fields:
        np.testing.assert_array_equal(getattr(after, f), getattr(before, f))


def test_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tbl.ht_create(8), lambda: tbl.hti_create(8),
                 lambda: tbl.ch_create(4, 16)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbl.ht_create(8, device="cuda")


def test_wrappers_refuse_cpu_tensors():
    """On a CPU state the kernel wrappers refuse (the CPU path runs the
    plain loop before ever reaching them)."""
    from repro_torch.kernels import baselines_insert as kern
    k = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        kern.ht_insert_(tbl.ht_create(6, 4, device="cpu"), k, k, 0.35)
    with pytest.raises(ValueError, match="CUDA device"):
        kern.hti_insert_(tbl.hti_create(6, 4, device="cpu"), k, k, 0.35, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        kern.ch_insert_(tbl.ch_create(2, 8, 4, device="cpu"), k, k)
    with pytest.raises(TypeError):
        kern.ch_insert_(tbl.ch_create(2, 8, 4, device="cpu"), k.float(),
                        k.float())
    ch = tbl.ch_create(2, 8, 4, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        kern.ch_insert_(ch._replace(counts=ch.counts[:5]), k, k)
    ht = tbl.ht_create(6, 4, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        kern.ht_insert_(ht._replace(vals=ht.vals[:10]), k, k, 0.35)


@pytest.mark.parametrize("threshold", [0.35, 0.5])
@pytest.mark.parametrize("init_log2", [4, 6, 9])
def test_ht_doubling_work_space_bound(rng, init_log2, threshold):
    """The CUDA wrapper sizes HT's doubling work space from the state's
    count before the batch: for every batch size up to 64 and a few large
    ones, the largest table the batch doubles from (the host loop's final
    size, halved) is never above the bound, and the bound is at most one
    step above it."""
    from repro_torch.kernels import baselines_insert as kern
    max_log2 = 12
    pre = unique_keys(rng, 3003)
    st0 = tbl.ht_insert_many(tbl.ht_create(max_log2, init_log2, device="cpu"),
                             pre[:3], pre[:3], threshold)
    L0, c0 = int(st0.size_log2), int(st0.count)
    for n in list(range(65)) + [179, 180, 1000, 3000]:
        bound = kern._largest_doubling(L0, c0, n, max_log2, threshold)
        st = tbl.ht_insert_many(st0, pre[3:3 + n], pre[3:3 + n], threshold)
        L1 = int(st.size_log2)
        largest = L1 - 1 if L1 > L0 else -1
        assert bound in (largest, L1), (L0, c0, n, L1, bound)
