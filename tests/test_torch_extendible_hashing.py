"""Port parity: ``repro_torch.core.extendible_hashing`` against
``repro.core.extendible_hashing``.  After the same insert trace all eight
``EHState`` arrays must be identical (placement depends on key order and
on the slot order of each split), and so must lookups and invariant
verdicts."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import extendible_hashing as jeh
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import extendible_hashing as teh
from repro_torch.core import hashing

from conftest import unique_keys


def assert_states_equal(jst, tst):
    got = state_to_numpy(tst)
    for f in jeh.EHState._fields:
        want = np.asarray(getattr(jst, f))
        np.testing.assert_array_equal(getattr(got, f), want, err_msg=f)
        assert getattr(got, f).dtype == want.dtype, f


def run_trace(keys, vals, batch, *, depth, slots, capacity):
    jst = jeh.eh_create(depth, slots, capacity)
    tst = teh.eh_create(depth, slots, capacity, device="cpu")
    for i in range(0, keys.size, batch):
        jst = jeh.eh_insert_many(jst, jnp.asarray(keys[i:i + batch]),
                                 jnp.asarray(vals[i:i + batch]))
        tst = teh.eh_insert_many(tst, keys[i:i + batch], vals[i:i + batch])
        assert_states_equal(jst, tst)
    return jst, tst


# (n keys, batch, max depth, bucket slots, capacity): cascading splits and
# doublings; a saturated directory; capacity exhausted (dropped > 0)
TRACES = [(1500, 300, 10, 4, 1024),
          (800, 800, 9, 8, 256),
          (600, 150, 4, 8, 64),
          (900, 100, 8, 4, 40)]


@pytest.mark.parametrize("n,batch,depth,slots,capacity", TRACES)
def test_insert_trace_bit_identical(rng, n, batch, depth, slots, capacity):
    keys = unique_keys(rng, n)
    vals = rng.integers(0, 2**32 - 1, n, dtype=np.uint32)
    jst, tst = run_trace(keys, vals, batch, depth=depth, slots=slots,
                         capacity=capacity)
    assert int(tst.num_buckets) > 1 and int(tst.global_depth) > 0
    if capacity <= 64:
        assert int(tst.dropped) > 0     # the exhausted-capacity case


def test_overwrites_and_edge_keys(rng):
    """Re-inserted keys overwrite in place; keys 0 and 0xFFFFFFFE (and the
    EMPTY pattern itself, which the reference stores oddly) follow the
    reference exactly."""
    keys = unique_keys(rng, 300)
    keys = np.concatenate([keys, keys[:60], np.array(
        [0, 0xFFFFFFFE, 0xFFFFFFFF, 0], np.uint32), keys[100:140]])
    vals = np.arange(keys.size, dtype=np.uint32)
    jst, tst = run_trace(keys, vals, 64, depth=8, slots=8, capacity=256)
    assert int(teh.eh_num_entries(tst)) == int(jeh.eh_num_entries(jst))


def test_single_key_ops_and_stats(rng):
    keys = unique_keys(rng, 12)
    jst = jeh.eh_create(6, 2, 64)
    tst = teh.eh_create(6, 2, 64, device="cpu")
    for k in keys[:8].tolist():
        jst = jeh.eh_insert(jst, jnp.uint32(k), jnp.uint32(k // 3))
        tst = teh.eh_insert(tst, k, k // 3)
    assert_states_equal(jst, tst)
    for k in keys[4:].tolist():
        assert int(teh.eh_lookup(tst, k)) == int(jeh.eh_lookup(jst,
                                                               jnp.uint32(k)))
    assert float(teh.avg_fan_in(tst)) == float(jeh.avg_fan_in(jst))
    assert int(teh.eh_num_entries(tst)) == int(jeh.eh_num_entries(jst))


@pytest.mark.parametrize("n", [50, 700])
def test_lookups_and_view(rng, n):
    keys = unique_keys(rng, n)
    vals = rng.integers(0, 2**32 - 1, n, dtype=np.uint32)
    jst, tst = run_trace(keys, vals, n, depth=10, slots=16, capacity=512)
    probe = np.concatenate([keys, unique_keys(rng, 100, lo=2**31,
                                              hi=2**32 - 2)])
    want = np.asarray(jeh.eh_lookup_many(jst, jnp.asarray(probe)))
    np.testing.assert_array_equal(teh.eh_lookup_many(tst, probe).numpy(),
                                  want)
    g = int(jst.global_depth)
    for view_slots in (1 << g, 2 << g):
        jv = jeh.compose_shortcut(jst, view_slots)
        tv = teh.compose_shortcut(tst, view_slots)
        for a, b in zip(jv, tv):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jv = jeh.compose_shortcut(jst, 1 << g)
    tv = teh.compose_shortcut(tst, 1 << g)
    want = np.asarray(jeh.shortcut_lookup_many(*jv, jst.global_depth,
                                               jnp.asarray(probe)))
    np.testing.assert_array_equal(
        teh.shortcut_lookup_many(*tv, g, probe).numpy(), want)
    np.testing.assert_array_equal(
        teh.shortcut_lookup_many(*tv, tst.global_depth, probe).numpy(), want)


def _corrupt(arrays, kind):
    a = [np.array(x) for x in arrays]
    nb = int(a[6])
    if kind == "dangling":
        a[0][0] = nb + 3
    elif kind == "counts":
        a[3][0] += 1
    elif kind == "misplaced":
        b0 = int(a[0][0])
        live = np.nonzero(a[1][b0] != np.uint32(0xFFFFFFFF))[0]
        other = int(a[0][(1 << int(a[5])) - 1])
        assert other != b0 and live.size
        j = int(np.nonzero(a[1][other] == np.uint32(0xFFFFFFFF))[0][0])
        a[1][other, j] = a[1][b0, live[0]]
        a[3][other] += 1
    elif kind == "depth":
        b = int(np.argmax(a[4][:nb]))
        a[4][b] -= 1          # now referenced twice as often as it should
    return a


@pytest.mark.parametrize("kind", ["valid", "counts", "misplaced", "depth"])
def test_check_invariants_verdicts(rng, kind):
    keys = unique_keys(rng, 400)
    jst, tst = run_trace(keys, np.arange(400, dtype=np.uint32), 400,
                         depth=9, slots=8, capacity=512)
    arrays = [np.asarray(x) for x in jst]
    if kind != "valid":
        arrays = _corrupt(arrays, kind)
    want = jeh.check_invariants(jeh.EHState(*map(jnp.asarray, arrays)))
    got = teh.check_invariants(state_from_numpy(arrays, device="cpu"))
    assert got == want
    assert got["ok"] == (kind == "valid")


def test_insert_leaves_its_argument_unchanged(rng):
    """Copy-on-write: a snapshot handed to a replay never changes."""
    keys = unique_keys(rng, 200)
    st0 = teh.eh_insert_many(teh.eh_create(8, 8, 256, device="cpu"),
                             keys[:100], np.arange(100, dtype=np.uint32))
    before = [hashing.clone(a) for a in st0]
    teh.eh_insert_many(st0, keys[100:], np.arange(100, dtype=np.uint32))
    for a, b in zip(before, st0):
        assert torch.equal(hashing.storage_view(a), hashing.storage_view(b))


def test_create_requires_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        teh.eh_create(4, 4, 8)
