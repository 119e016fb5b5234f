"""Port parity for ``repro_torch.kvcache.paged_cache`` against
``repro.kvcache.paged_cache``: the same prefill / append-across-block /
release / re-allocate trace, from the same seeded numpy inputs, leaves all
seven ``PagedKVCache`` arrays bit-equal, and ``gather_context`` and
``fragmentation`` agree exactly.  Includes an exhausted free ring (the -1
block id, whose rows both packages write into the last block)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kvcache import paged_cache as jpc
from repro_torch.convert import paged_cache_from_numpy, paged_cache_to_numpy
from repro_torch.kvcache import paged_cache as tpc

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
L, KV, HD = 2, 2, 8


def make(dtype, nb=24, bs=4, max_seqs=4, mbps=6):
    jd, td = DTYPES[dtype]
    return (jpc.cache_create(L, nb, bs, KV, HD, max_seqs, mbps, dtype=jd),
            tpc.cache_create(L, nb, bs, KV, HD, max_seqs, mbps, dtype=td,
                             device="cpu"))


def kv(rng, dtype, *shape):
    """One numpy draw handed to both packages (bf16-rounded for bf16)."""
    a = jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(
        DTYPES[dtype][0])
    return a, torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        DTYPES[dtype][1])


def assert_same(j, t):
    for f, a, b in zip(jpc.PagedKVCache._fields, j, paged_cache_to_numpy(t)):
        np.testing.assert_array_equal(np.asarray(a, dtype=b.dtype), b,
                                      err_msg=f)
        assert b.shape == np.asarray(a).shape, f
    assert t.block_tables.dtype == torch.int32 and t.free_head.dim() == 0


def run_trace(rng, dtype, j, t, steps):
    for op, ids, n in steps:
        if op == "prefill":
            (jk, tk), (jv, tv) = (kv(rng, dtype, L, len(ids), n, KV, HD)
                                  for _ in range(2))
            j = jpc.write_prefill(j, jnp.asarray(ids), jk, jv)
            t = tpc.write_prefill(t, np.asarray(ids), tk, tv)
        elif op == "append":
            for _ in range(n):
                (jk, tk), (jv, tv) = (kv(rng, dtype, L, len(ids), KV, HD)
                                      for _ in range(2))
                j = jpc.append_tokens(j, jnp.asarray(ids), jk, jv)
                t = tpc.append_tokens(t, np.asarray(ids), tk, tv)
        else:
            j = jpc.release_seqs(j, jnp.asarray(ids))
            t = tpc.release_seqs(t, np.asarray(ids))
        assert_same(j, t)
    return j, t


TRACE = [("prefill", [0, 1], 8), ("append", [0, 1, 2], 6),
         ("release", [1], 0), ("prefill", [3], 4), ("append", [0, 3], 5),
         ("release", [0, 2], 0), ("prefill", [1, 2], 12), ("append", [1], 3)]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_trace_bit_equal(dtype):
    rng = np.random.default_rng(0)
    j, t = make(dtype)
    j, t = run_trace(rng, dtype, j, t, TRACE)
    for ids in ([1, 2, 3], [3, 1], [0]):
        jk, jv = jpc.gather_context(j, jnp.asarray(ids))
        tk, tv = tpc.gather_context(t, np.asarray(ids))
        for a, b in ((jk, tk), (jv, tv)):
            np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)),
                                          b.float().numpy())
        fj = jpc.fragmentation(j, jnp.asarray(ids))
        ft = tpc.fragmentation(t, np.asarray(ids))
        assert ft.dtype == torch.float32 and float(ft) == float(fj)


def test_exhausted_ring_writes_the_last_block():
    rng = np.random.default_rng(1)
    j, t = make("float32", nb=5, mbps=4)
    j, t = run_trace(rng, "float32", j, t,
                     [("prefill", [0, 1], 8), ("append", [0, 1, 2], 2),
                      ("append", [2], 5), ("release", [1], 0),
                      ("append", [0, 2, 3], 3)])
    assert int(t.free_count) == int(j.free_count)
    assert (t.block_tables == -1).any()


def test_fragmentation_of_a_fresh_prefill_is_zero():
    rng = np.random.default_rng(2)
    j, t = make("float32", nb=32)
    j, t = run_trace(rng, "float32", j, t, [("prefill", [0], 16)])
    assert float(tpc.fragmentation(t, [0])) == 0.0


def test_numpy_round_trip():
    rng = np.random.default_rng(3)
    j, _ = make("bfloat16")
    j, _ = run_trace(rng, "bfloat16", j, make("bfloat16")[1],
                     [("prefill", [0, 2], 8)])
    t = paged_cache_from_numpy(j, device="cpu")
    assert t.k_pool.dtype == torch.bfloat16
    assert_same(j, t)


def test_append_past_capacity_matches_jax():
    """Five appends to two sequences of at most 2 blocks of 2 tokens: the
    fifth is past capacity.  JAX drops the table write, clamps the gather
    to the last entry (the row overwrites position 2), still takes two
    fresh blocks off the ring (they leak) and advances ``seq_lens``; the
    port gives the same state bit for bit."""
    rng = np.random.default_rng(4)
    j = jpc.cache_create(1, 8, 2, 1, 2, 2, 2, dtype=jnp.float32)
    t = tpc.cache_create(1, 8, 2, 1, 2, 2, 2, dtype=torch.float32,
                         device="cpu")
    ids = np.array([0, 1], np.int32)
    for _ in range(5):
        (jk, tk), (jv, tv) = (kv(rng, "float32", 1, 2, 1, 2)
                              for _ in range(2))
        j = jpc.append_tokens(j, jnp.asarray(ids), jk, jv)
        t = tpc.append_tokens(t, ids, tk, tv)
        assert_same(j, t)
    assert int(t.free_count) == 2 and t.seq_lens.tolist() == [5, 5]
    # the fifth row sits at (max_blocks - 1) * block + slot 0 = position 2
    last = t.block_tables[:, 1].long()
    np.testing.assert_array_equal(t.k_pool[0, last, 0].numpy(),
                                  tk[0].numpy())
