"""Port parity for the decode kernels: ``repro_torch.kernels``'
``shortcut_attention`` and ``paged_attention`` (their plain versions, which
the wrappers run on the CPU) against the JAX package's Pallas kernels in interpret mode, on the
shapes of ``tests/test_kernels.py``'s decode sweeps and the same seeded numpy
inputs.  Tolerances: that file's 2e-5 in float32; in bfloat16 one bfloat16
step of each element plus half a step of the largest (``assert_close``),
tighter than that file's 2e-2, which is about the size of a long context's
outputs.

Where the JAX package's ``decode_attention_ref`` / ``paged_attention_ref``
differ from its kernels (a row with no live position: the refs give the mean
of V, the kernels zeros; a -1 table entry below ``seq_lens``: the kernels
skip the block), the port follows the kernels, and the tests pin that."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention as j_paged
from repro.kernels.shortcut_attention import shortcut_attention as j_short
from repro_torch.kernels import ops, ref
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.shortcut_attention import shortcut_attention

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def pair(a, dtype):
    """The same values for both packages: a JAX array and a tensor."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(a).astype(jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def assert_close(t, j, dtype):
    """float32: within 2e-5 (rtol = atol).  bfloat16: within one bfloat16
    step of each element plus half a step of the largest (both sides sum in
    float32 and round once), far tighter than 2e-2 at these outputs."""
    got, want = t.float().numpy(), np.asarray(j.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        return
    limit = 2.0 ** -7 * np.abs(want) + 2.0 ** -8 * np.abs(want).max()
    assert got.shape == want.shape
    assert (np.abs(got - want) <= limit).all(), np.abs(got - want).max()


def paged_inputs(rng, B, KV, hd, bs, nb, MB, lens):
    tables = np.full((B, MB), -1, np.int32)
    pool = list(rng.permutation(nb))
    for b in range(B):
        for m in range(-(-int(lens[b]) // bs)):
            tables[b, m] = pool.pop()
    return tables


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,KV,G,hd,S,bs", [(2, 1, 4, 32, 64, 16),
                                            (3, 2, 2, 64, 96, 32),
                                            (1, 4, 1, 128, 128, 128)])
def test_shortcut_sweep(dtype, B, KV, G, hd, S, bs):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((B, KV, G, hd)).astype(np.float32)
    kv = rng.standard_normal((2, B, KV, S, hd)).astype(np.float32)
    ctx = rng.integers(1, S + 1, B).astype(np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (pair(a, dtype) for a in (q, kv[0], kv[1]))
    want = j_short(jq, jk, jv, jnp.asarray(ctx), bs=bs)
    got = shortcut_attention(tq, tk, tv, torch.from_numpy(ctx))
    assert got.dtype == tq.dtype and got.shape == (B, KV, G, hd)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("window,softcap", [(17, None), (None, 20.0),
                                            (40, 5.0)])
def test_shortcut_window_softcap(window, softcap):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 2, 2, 32)).astype(np.float32) * 3
    kv = rng.standard_normal((2, 2, 2, 96, 32)).astype(np.float32) * 3
    ctx = np.array([96, 41], np.int32)
    want = j_short(jnp.asarray(q), jnp.asarray(kv[0]), jnp.asarray(kv[1]),
                   jnp.asarray(ctx), bs=32, window=window, softcap=softcap)
    got = shortcut_attention(torch.from_numpy(q), torch.from_numpy(kv[0]),
                             torch.from_numpy(kv[1]), torch.from_numpy(ctx),
                             window=window, softcap=softcap)
    assert_close(got, want, "float32")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,KV,G,hd,bs,nb,MB", [(2, 2, 2, 32, 16, 24, 6),
                                                (3, 1, 4, 64, 8, 48, 8)])
def test_paged_sweep(dtype, B, KV, G, hd, bs, nb, MB):
    rng = np.random.default_rng(6)
    q = rng.standard_normal((B, KV, G, hd)).astype(np.float32)
    kp = rng.standard_normal((nb, KV, bs, hd)).astype(np.float32)
    vp = rng.standard_normal((nb, KV, bs, hd)).astype(np.float32)
    lens = rng.integers(1, MB * bs + 1, B).astype(np.int32)
    tables = paged_inputs(rng, B, KV, hd, bs, nb, MB, lens)
    (jq, tq), (jk, tk), (jv, tv) = (pair(a, dtype) for a in (q, kp, vp))
    want = j_paged(jq, jk, jv, jnp.asarray(tables), jnp.asarray(lens),
                   softcap=30.0)
    got = paged_attention(tq, tk, tv, torch.from_numpy(tables),
                          torch.from_numpy(lens), softcap=30.0)
    assert_close(got, want, dtype)


def test_paged_equals_shortcut_when_linear():
    """Identity block table: both paths agree (the paper's Figure 1
    equivalence), in the port as in the JAX kernels."""
    B, KV, G, hd, bs, MB = 2, 2, 2, 32, 8, 6
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((B, KV, G, hd)).astype(
        np.float32))
    kp = torch.from_numpy(rng.standard_normal((B * MB, KV, bs, hd)).astype(
        np.float32))
    vp = torch.from_numpy(rng.standard_normal((B * MB, KV, bs, hd)).astype(
        np.float32))
    tables = torch.arange(B * MB, dtype=torch.int32).reshape(B, MB)
    lens = torch.tensor([MB * bs, 3 * bs + 2], dtype=torch.int32)
    paged = paged_attention(q, kp, vp, tables, lens)

    def view(p):
        return p.reshape(B, MB, KV, bs, hd).permute(0, 2, 1, 3, 4).reshape(
            B, KV, MB * bs, hd)
    short = shortcut_attention(q, view(kp), view(vp), lens)
    np.testing.assert_allclose(paged.numpy(), short.numpy(), rtol=1e-6,
                               atol=1e-6)
    want = j_paged(jnp.asarray(q.numpy()), jnp.asarray(kp.numpy()),
                   jnp.asarray(vp.numpy()), jnp.asarray(tables.numpy()),
                   jnp.asarray(lens.numpy()))
    assert_close(paged, want, "float32")


def test_empty_rows_and_unset_entries_follow_the_kernels():
    """ctx == 0 and an all -1 row decode to zeros, as the JAX kernels give
    (its refs give the mean of V); a -1 entry inside the context is
    skipped, as the JAX paged kernel skips it."""
    B, KV, G, hd, bs, MB, S = 3, 2, 2, 32, 8, 4, 32
    rng = np.random.default_rng(8)
    q = rng.standard_normal((B, KV, G, hd)).astype(np.float32)
    kv = rng.standard_normal((2, B, KV, S, hd)).astype(np.float32)
    ctx = np.array([0, 19, 32], np.int32)
    want = j_short(*(jnp.asarray(a) for a in (q, kv[0], kv[1], ctx)), bs=8)
    got = shortcut_attention(*(torch.from_numpy(a) for a in (q, kv[0], kv[1],
                                                            ctx)))
    assert_close(got, want, "float32")
    assert not got[0].any() and not np.asarray(want[0]).any()
    jr = jref.decode_attention_ref(*(jnp.asarray(a)
                                     for a in (q, kv[0], kv[1], ctx)))
    np.testing.assert_allclose(np.asarray(jr[0]),
                               kv[1][0].mean(axis=1, keepdims=True)
                               .repeat(G, 1), rtol=1e-5, atol=1e-5)

    nb = 16
    kp = rng.standard_normal((nb, KV, bs, hd)).astype(np.float32)
    vp = rng.standard_normal((nb, KV, bs, hd)).astype(np.float32)
    tables = np.array([[-1, -1, -1, -1], [3, -1, 7, -1], [1, 2, 4, 5]],
                      np.int32)
    lens = np.array([20, 19, 32], np.int32)
    args = (q, kp, vp, tables, lens)
    want = j_paged(*(jnp.asarray(a) for a in args), softcap=10.0)
    got = paged_attention(*(torch.from_numpy(a) for a in args), softcap=10.0)
    assert_close(got, want, "float32")
    assert not got[0].any()
    jr = jref.paged_attention_ref(*(jnp.asarray(a) for a in args),
                                  softcap=10.0)
    assert np.abs(np.asarray(jr[1]) - got[1].numpy()).max() > 1e-3


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ops_serve_layout(dtype):
    """``ops.decode_shortcut`` / ``decode_paged`` on serve-layout views and
    cache-layout pools, against the JAX ops; the layout change is a view."""
    B, H, KV, hd, S, bs, nb, MB = 3, 8, 2, 32, 48, 8, 20, 6
    rng = np.random.default_rng(9)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    view = rng.standard_normal((2, B, S, KV, hd)).astype(np.float32)
    ctx = np.array([48, 5, 30], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (pair(a, dtype)
                                    for a in (q, view[0], view[1]))
    want = jops.decode_shortcut(jq, jk, jv, jnp.asarray(ctx), window=20,
                                softcap=8.0, bs=16)
    got = ops.decode_shortcut(tq, tk, tv, torch.from_numpy(ctx), window=20,
                              softcap=8.0)
    assert got.shape == (B, H, hd)
    assert_close(got, want, dtype)

    pools = rng.standard_normal((2, nb, bs, KV, hd)).astype(np.float32)
    tables = paged_inputs(rng, B, KV, hd, bs, nb, MB, ctx)
    (jk, tk), (jv, tv) = (pair(a, dtype) for a in (pools[0], pools[1]))
    want = jops.decode_paged(jq, jk, jv, jnp.asarray(tables),
                             jnp.asarray(ctx), softcap=8.0)
    seen = []
    orig = ref.paged_attention_ref

    def spy(q4, kp, vp, *a, **k):
        seen.append((kp.data_ptr() == tk.data_ptr(), kp.is_contiguous()))
        return orig(q4, kp, vp, *a, **k)
    ref.paged_attention_ref = spy
    try:
        got = ops.decode_paged(tq, tk, tv, torch.from_numpy(tables),
                               torch.from_numpy(ctx), softcap=8.0)
    finally:
        ref.paged_attention_ref = orig
    assert seen == [(True, False)], "the pool was copied, not viewed"
    assert_close(got, want, dtype)


def test_window_must_be_positive():
    q = torch.zeros((1, 1, 1, 8))
    kv = torch.zeros((1, 1, 4, 8))
    with pytest.raises(ValueError):
        shortcut_attention(q, kv, kv, torch.tensor([4]), window=0)
