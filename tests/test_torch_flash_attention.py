"""Port parity for flash attention: ``repro_torch.kernels.flash_attention``
(its plain version, which the wrapper runs on the CPU) and
``ops.mha_forward`` against the JAX package's Pallas ``flash_attention`` in
interpret mode and its ``flash_attention_ref``, on ``tests/test_kernels.py``'s
shapes and cases with the same seeded numpy inputs.  The Pallas kernel is
held at the edges where its tiling could show (q shorter than the keys,
ragged tails, windows under a tile).  Tolerances: float32 within 2e-5
(rtol = atol, sums in another order); bfloat16 within one bfloat16 step of
each element plus half a step of the largest (both sides sum in float32 and
round once).  The port's CPU ``blockwise_attention`` computes the same
function and is held to the plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.attention import blockwise_attention

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def pair(a, dtype="float32"):
    """The same values for both packages: a JAX array and a tensor."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(a).astype(jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def assert_close(t, j, dtype="float32"):
    got, want = t.float().numpy(), np.asarray(j.astype(jnp.float32))
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        return
    limit = 2.0 ** -7 * np.abs(want) + 2.0 ** -8 * np.abs(want).max()
    assert (np.abs(got - want) <= limit).all(), np.abs(got - want).max()


def inputs(seed, qshape, skv, dtype="float32", scale=1.0):
    rng = np.random.default_rng(seed)
    B, KV, G, Sq, hd = qshape
    q = rng.standard_normal(qshape).astype(np.float32) * scale
    k = rng.standard_normal((B, KV, skv, hd)).astype(np.float32) * scale
    v = rng.standard_normal((B, KV, skv, hd)).astype(np.float32)
    return [pair(a, dtype) for a in (q, k, v)]


def check(pairs, dtype="float32", bq=32, bkv=32, **kw):
    (jq, tq), (jk, tk), (jv, tv) = pairs
    got = flash_attention(tq, tk, tv, bq=bq, bkv=bkv, **kw)
    assert got.dtype == tq.dtype
    assert_close(got, j_flash(jq, jk, jv, bq=bq, bkv=bkv, interpret=True,
                              **kw), dtype)
    assert_close(got, jref.flash_attention_ref(jq, jk, jv, **kw), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize(
    "B,KV,G,Sq,hd,bq,bkv",
    [(1, 1, 1, 64, 16, 16, 32),
     (2, 2, 4, 128, 32, 32, 64),
     (1, 4, 2, 96, 64, 32, 32),    # ragged: 96 % 64 != 0
     (2, 1, 8, 128, 128, 64, 128)])
def test_causal_sweep(dtype, B, KV, G, Sq, hd, bq, bkv):
    check(inputs(0, (B, KV, G, Sq, hd), Sq, dtype), dtype, bq, bkv)


@pytest.mark.parametrize("window", [16, 33, 100])
def test_sliding_window(window):
    check(inputs(1, (1, 2, 2, 128, 32), 128), window=window)


def test_softcap():
    check(inputs(2, (1, 1, 2, 64, 32), 64, scale=3.0), softcap=20.0)


@pytest.mark.parametrize("window", [None, 16, 33])
def test_prefill_shorter_q(window):
    """Right-aligned q against a longer kv, a ragged key tail (100 % 32),
    and windows under a tile."""
    check(inputs(3, (1, 2, 2, 32, 32), 128), window=window)
    check(inputs(4, (2, 1, 3, 20, 16), 100), window=window)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("window,softcap", [(None, None), (24, 30.0)])
def test_mha_forward_model_layout(dtype, window, softcap):
    rng = np.random.default_rng(5)
    B, S, KV, G, hd = 2, 80, 2, 3, 32
    (jq, tq), (jk, tk), (jv, tv) = [pair(rng.standard_normal(s).astype(
        np.float32), dtype) for s in ((B, S, KV * G, hd), (B, S, KV, hd),
                                      (B, S, KV, hd))]
    got = ops.mha_forward(tq, tk, tv, window=window, softcap=softcap)
    assert got.shape == (B, S, KV * G, hd)
    assert_close(got, jops.mha_forward(jq, jk, jv, window=window,
                                       softcap=softcap, bq=32, bkv=32),
                 dtype)


@pytest.mark.parametrize("window,softcap,chunks", [
    (None, None, (32, 32)), (16, None, (32, 16)), (40, 50.0, (16, 32)),
    (None, 5.0, (96, 96))])
def test_blockwise_is_the_flash_function(window, softcap, chunks):
    """The model's CPU prefill attention against the kernel's plain version
    (prefix_len 0), float32."""
    rng = np.random.default_rng(6)
    B, S, KV, G, hd = 2, 96, 2, 4, 16
    q = torch.from_numpy(rng.standard_normal((B, S, KV * G, hd)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, KV, hd)).astype(
        np.float32)) for _ in range(2))
    got = blockwise_attention(q, k, v, chunk_q=chunks[0], chunk_kv=chunks[1],
                              window=window, attn_softcap=softcap)
    want = ops.mha_forward(q, k, v, window=window, softcap=softcap)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_plain_version_masks():
    """``flash_mask``: right-aligned causal, window edge, explicit offset."""
    m = ref.flash_mask(2, 4, window=2)
    assert m.tolist() == [[False, True, True, False],
                          [False, False, True, True]]
    assert ref.flash_mask(2, 4, causal=False).all()
    assert ref.flash_mask(3, 3, q_offset=-1)[0].sum() == 0


def test_wrapper_refuses():
    q = torch.zeros(1, 1, 1, 8, 16)
    k = torch.zeros(1, 1, 4, 16)
    with pytest.raises(ValueError, match="Sq 8 > Skv 4"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, q[:, :, 0], q[:, :, 0], window=0)
    with pytest.raises(ValueError, match="forward only"):
        flash_attention(q.requires_grad_(), q[:, :, 0].detach(),
                        q[:, :, 0].detach())
    with pytest.raises(ValueError, match="expected q"):
        flash_attention(k, k, k)
