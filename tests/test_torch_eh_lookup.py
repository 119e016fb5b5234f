"""Port parity: ``repro_torch.kernels.eh_lookup`` (its plain version, on
CPU tensors) against the Pallas kernels of ``repro.kernels.eh_lookup`` run
in interpret mode, as ``tests/test_kernels.py`` runs them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import extendible_hashing as jeh
from repro.kernels import eh_lookup as jk
from repro_torch.convert import (stack_shards, state_from_numpy,
                                state_to_numpy, view_from_numpy,
                                view_to_numpy)
from repro_torch.core import extendible_hashing as teh
from repro_torch.kernels import eh_lookup as tk
from repro_torch.kernels import ops

from conftest import unique_keys


def build(rng, n, *, depth, slots, capacity):
    keys = unique_keys(rng, n)
    st = jeh.eh_insert_many(jeh.eh_create(depth, slots, capacity),
                            jnp.asarray(keys),
                            jnp.asarray(rng.integers(0, 2**32 - 1, n,
                                                     dtype=np.uint32)))
    probe = np.concatenate([keys, unique_keys(rng, 77, lo=2**31,
                                              hi=2**32 - 2)])
    return st, state_from_numpy(st, device="cpu"), probe


@pytest.mark.parametrize("n,slots,tile", [(200, 16, 64), (1000, 8, 256)])
def test_single_shard(rng, n, slots, tile):
    jst, tst, probe = build(rng, n, depth=9, slots=slots, capacity=1024)
    D = 1 << int(jst.global_depth)
    want = np.asarray(jk.eh_lookup(jnp.asarray(probe), jst.directory[:D],
                                   jst.bucket_keys, jst.bucket_vals,
                                   jst.global_depth, tile=tile))
    got = tk.eh_lookup(probe, tst.directory[:D], tst.bucket_keys,
                       tst.bucket_vals, tst.global_depth, tile=tile)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ops.eh_lookup_op(probe, tst).numpy(), want)
    assert (want[n:] == 0xFFFFFFFF).all()

    g = int(jst.global_depth)
    jv = jeh.compose_shortcut(jst, 1 << g)
    tv = view_from_numpy((*jv, g), device="cpu")
    want = np.asarray(jk.shortcut_lookup(jnp.asarray(probe), *jv,
                                         jst.global_depth, tile=tile))
    got = tk.shortcut_lookup(probe, tv[0], tv[1], g, tile=tile)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ops.shortcut_lookup_op(probe, *tv[:2], g).numpy(), want)


@pytest.mark.parametrize("N", [1, 4])
def test_sharded(rng, N):
    built = [build(rng, 150 + 40 * s, depth=8, slots=8, capacity=256)
             for s in range(N)]
    K = max(p.size for _, _, p in built)
    padded = np.zeros((N, K), np.uint32)
    for s, (_, _, p) in enumerate(built):
        padded[s, :p.size] = p
    depths = np.array([int(j.global_depth) for j, _, _ in built], np.int32)
    want = np.asarray(jk.sharded_eh_lookup(
        jnp.asarray(padded), jnp.stack([j.directory for j, _, _ in built]),
        jnp.stack([j.bucket_keys for j, _, _ in built]),
        jnp.stack([j.bucket_vals for j, _, _ in built]),
        jnp.asarray(depths), tile=64))
    got = tk.sharded_eh_lookup(
        padded, torch.stack([t.directory for _, t, _ in built]),
        torch.stack([t.bucket_keys.view(torch.int32) for _, t, _ in built]),
        torch.stack([t.bucket_vals.view(torch.int32) for _, t, _ in built]),
        depths, tile=64)
    np.testing.assert_array_equal(got.numpy(), want)

    V = 1 << int(depths.max())
    jviews = [jeh.compose_shortcut(j, V) for j, _, _ in built]
    want = np.asarray(jk.sharded_shortcut_lookup(
        jnp.asarray(padded), jnp.stack([v[0] for v in jviews]),
        jnp.stack([v[1] for v in jviews]), jnp.asarray(depths), tile=64))
    got = tk.sharded_shortcut_lookup(
        padded, torch.from_numpy(np.stack([np.asarray(v[0]) for v in jviews])
                                 .view(np.int32)),
        torch.from_numpy(np.stack([np.asarray(v[1]) for v in jviews])
                         .view(np.int32)), depths, tile=64)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("slots", [8, 16])
def test_probe_counts(rng, slots):
    """``lookup_ref(count_probed=True)``: the values of the plain lookup, and
    per key the slots read up to the key or the first EMPTY, walked here
    with the JAX package's hashes."""
    from repro.core import hashing as jh
    from repro_torch.kernels import ref
    jst, tst, probe = build(rng, 300, depth=8, slots=slots, capacity=512)
    g = int(jst.global_depth)
    vals, probed = ref.lookup_ref(probe, tst.directory, tst.bucket_keys,
                                  tst.bucket_vals, g, count_probed=True)
    np.testing.assert_array_equal(
        vals.view(torch.int32).numpy(),
        ref.lookup_ref(probe, tst.directory, tst.bucket_keys,
                       tst.bucket_vals, g).view(torch.int32).numpy())
    slot = np.asarray(jh.dir_slot(jh.hash_dir(jnp.asarray(probe)), g))
    rows = np.asarray(jst.directory)[slot]
    pos = np.asarray(jax.vmap(lambda k: jh.probe_positions(k, slots))(
        jnp.asarray(probe)))
    seen = np.asarray(jst.bucket_keys)[rows[:, None], pos]
    stop = (seen == probe[:, None]) | (seen == np.uint32(0xFFFFFFFF))
    want = np.where(stop.any(1), stop.argmax(1) + 1, slots)
    np.testing.assert_array_equal(probed.numpy(), want)
    assert probed.dtype == torch.int64


def test_rejects_bad_operands(rng):
    _, tst, probe = build(rng, 50, depth=6, slots=8, capacity=64)
    with pytest.raises(TypeError):
        tk.eh_lookup(probe, tst.directory, tst.bucket_keys.to(float),
                     tst.bucket_vals, tst.global_depth)
    with pytest.raises(ValueError):
        tk.eh_lookup(probe, tst.directory, tst.bucket_keys,
                     tst.bucket_vals, tst.global_depth, tile=0)


def distinct_keys(rng, n, lo=1, hi=2**31):
    """``n`` distinct uint32 keys in ``[lo, hi)``, drawn without building the
    whole range."""
    return (rng.choice(hi - lo, n, replace=False) + lo).astype(np.uint32)


@pytest.fixture(scope="module")
def stacked():
    """Four shards' states and composed views, stacked for both packages
    (views padded to the common extent, as the cache pads them), and 64
    present keys per shard.  The states are built by the port's insert,
    which ``test_torch_extendible_hashing.py`` holds to the JAX one."""
    rng = np.random.default_rng(7)
    states, views, probes = [], [], []
    for s in range(4):
        k = distinct_keys(rng, 160)
        v = np.arange(160, dtype=np.uint32) + np.uint32(s * 10_000)
        st = teh.eh_insert_many(teh.eh_create(8, 8, 256, device="cpu"), k, v)
        vs = max(1, 1 << int(st.global_depth))
        vk, vv = teh.compose_shortcut(st, vs)
        states.append(state_to_numpy(st))
        views.append(view_to_numpy((vk, vv, vs.bit_length() - 1)))
        probes.append(k[:64])
    trad, view = stack_shards(states, views, device="cpu")

    def to_jax(ops):
        return tuple(jnp.asarray(t.view(torch.int32).numpy()).view(jnp.uint32)
                     if t.dtype == torch.uint32 else jnp.asarray(t.numpy())
                     for t in ops)
    return np.stack(probes), trad, view, to_jax(trad), to_jax(view)


@pytest.mark.parametrize("flags", [[1, 1, 1, 1], [0, 0, 0, 0], [1, 0, 0, 1],
                                   [0, 1, 1, 0]])
def test_routed(rng, stacked, flags):
    """``sharded_routed_lookup`` against the JAX routed kernel, with V != C
    and key counts off the tile; every shard's answers are its route's."""
    keys, trad, view, jtrad, jview = stacked
    keys = np.concatenate([keys, np.stack([distinct_keys(
        rng, 13, lo=2**31, hi=2**32 - 2) for _ in range(4)])], axis=1)
    assert view[0].shape[1] != trad[1].shape[1]
    want = np.asarray(jk.sharded_routed_lookup(
        jnp.asarray(keys), *jtrad, *jview, jnp.asarray(flags, jnp.int32),
        tile=64))
    got = tk.sharded_routed_lookup(keys, *trad, *view,
                                   torch.tensor(flags, dtype=torch.int32),
                                   tile=64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, 64:] == 0xFFFFFFFF).all() and \
        (want[:, :64] != 0xFFFFFFFF).all()
    np.testing.assert_array_equal(
        want, np.asarray(jk.sharded_eh_lookup(jnp.asarray(keys), *jtrad,
                                              tile=64)))


def test_stacked(rng, stacked):
    """``stacked_shortcut_lookup`` for every shard of the stack, present and
    absent keys, against the JAX stacked kernel."""
    keys, _, view, _, jview = stacked
    for s in range(4):
        probe = np.concatenate([keys[s], distinct_keys(rng, 40, lo=2**31,
                                                     hi=2**32 - 2)])
        want = np.asarray(jk.stacked_shortcut_lookup(
            jnp.asarray(probe), *jview, s, tile=64))
        got = tk.stacked_shortcut_lookup(probe, *view, s, tile=64)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want[64:] == 0xFFFFFFFF).all()
    with pytest.raises(ValueError, match="shard 4"):
        tk.stacked_shortcut_lookup(keys[0], *view, 4)


def test_routed_rejects_slot_width_mismatch(stacked):
    keys, trad, view, jtrad, jview = stacked
    flags = np.zeros(4, np.int32)
    with pytest.raises(ValueError, match="slot widths"):
        jk.sharded_routed_lookup(jnp.asarray(keys), *jtrad,
                                 jview[0][:, :, :4], jview[1][:, :, :4],
                                 jview[2], jnp.asarray(flags), tile=64)
    with pytest.raises(ValueError, match="slot widths"):
        tk.sharded_routed_lookup(keys, *trad, view[0][:, :, :4],
                                 view[1][:, :, :4], view[2], flags, tile=64)
