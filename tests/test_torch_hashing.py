"""Port parity: ``repro_torch.core.hashing`` against ``repro.core.hashing``
on the same seeded inputs, compared exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as jh
from repro_torch.core import hashing as th

EDGE = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                np.uint32)


@pytest.fixture
def keys(rng):
    return np.concatenate([EDGE, rng.integers(0, 2**32, 500,
                                              dtype=np.uint32)])


def test_constants_match():
    assert (th.HASH_C1, th.HASH_C2) == (jh.HASH_C1, jh.HASH_C2)
    assert th.EMPTY_SENTINEL == jh.EMPTY_SENTINEL
    assert th.MISS_SENTINEL == jh.MISS_SENTINEL


@pytest.mark.parametrize("fn", ["hash_dir", "hash_bucket"])
def test_hashes(keys, fn):
    want = np.asarray(getattr(jh, fn)(jnp.asarray(keys)))
    got = getattr(th, fn)(keys).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    # every input form gives the same bits
    for form in (torch.from_numpy(keys.view(np.int32)),
                 torch.from_numpy(keys.astype(np.int64)),
                 torch.from_numpy(keys.view(np.int32)).view(torch.uint32)):
        np.testing.assert_array_equal(getattr(th, fn)(form).numpy(), got)


def test_host_hashes(keys):
    for k in keys.tolist():
        assert th.hash_dir_host(k) == jh.hash_dir_host(k)
        assert th.hash_bucket_host(k) == int(jh.hash_bucket(jnp.uint32(k)))


@pytest.mark.parametrize("depth", [0, 1, 5, 16, 31, 32])
def test_dir_slot(keys, depth):
    h = jh.hash_dir(jnp.asarray(keys))
    want = np.asarray(jh.dir_slot(h, jnp.int32(depth)))
    got = th.dir_slot(th.hash_dir(keys), depth)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # a 0-d depth tensor, as the state carries it
    np.testing.assert_array_equal(
        th.dir_slot(th.hash_dir(keys), torch.tensor(depth)).numpy(), want)


@pytest.mark.parametrize("slots", [1, 7, 64])
def test_probe_positions(keys, slots):
    want = np.asarray(jax.vmap(lambda k: jh.probe_positions(k, slots))(
        jnp.asarray(keys)))
    np.testing.assert_array_equal(th.probe_positions(keys, slots).numpy(),
                                  want)


@pytest.mark.parametrize("size_log2,window", [(0, 4), (6, 8), (12, 3)])
def test_window_positions(keys, size_log2, window):
    h = jh.hash_dir(jnp.asarray(keys))
    want = np.asarray(jax.vmap(
        lambda x: jh.window_positions(x, jnp.int32(size_log2), window))(h))
    got = th.window_positions(th.hash_dir(keys), size_log2, window)
    np.testing.assert_array_equal(got.numpy(), want)


def _probe_rows(rng, n, slots):
    """Rows of keys with EMPTY holes, and probe keys that hit before a
    hole, after a hole (a ghost), on the EMPTY key itself, or miss."""
    rows = rng.integers(0, 50, (n, slots), dtype=np.uint32)
    holes = rng.random((n, slots)) < 0.3
    rows[holes] = np.uint32(jh.EMPTY_SENTINEL)
    key = rng.integers(0, 50, n, dtype=np.uint32)
    key[::7] = np.uint32(jh.EMPTY_SENTINEL)
    return rows, key


@pytest.mark.parametrize("fn", ["probe_hit", "probe_slot"])
def test_masked_probes(rng, fn):
    rows, key = _probe_rows(rng, 400, 16)
    want_f, want_i = jax.vmap(getattr(jh, fn))(jnp.asarray(rows),
                                                jnp.asarray(key))
    got_f, got_i = getattr(th, fn)(torch.from_numpy(rows.view(np.int32)),
                                   key)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_bits_round_trip(keys):
    b = th.bits(keys)
    assert b.dtype == torch.int32
    np.testing.assert_array_equal(th.from_bits(b).numpy(), keys)
    np.testing.assert_array_equal(th.u32(keys).numpy(), keys.astype(np.int64))
    full = th.full((3,), 0xFFFFFFFF, torch.uint32, "cpu")
    np.testing.assert_array_equal(full.numpy(), np.full(3, 0xFFFFFFFF,
                                                        np.uint32))
