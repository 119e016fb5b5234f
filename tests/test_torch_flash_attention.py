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
function and is held to the plain version.  On the card, head dims 64, 128
and 256 run on the tensor cores: bfloat16 with p rounded to bfloat16 for
the value product, float32 in 3xTF32 (each operand split into two TF32
parts, three products a step); ``tile_emulation`` rehearses both
arithmetics here against the Pallas kernel, under the bfloat16 limit and
within float32's 2e-5, and shows one TF32 pass going past the latter.

The bidirectional prefix (PaliGemma's ``prefix_len``) is the reference
model's mask, which the Pallas kernel lacks: the plain version, the model
layout and the port's CPU loop are held to the JAX model's
``blockwise_attention`` at ``chunk_q >= prefix_len``, where that loop's
tiles give the mask on absolute positions; below it the reference's tiles
hide prefix keys (pinned by ``test_reference_prefix_quirk``).
``tile_emulation`` rehearses the CUDA kernels' tile ranges and the
tensor-core kernels' edge test with the prefix."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models import attention as jattn
from repro_torch import configs
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (check_tma, flash_attention,
                                                 kernel_path, tiles)
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
    """``flash_mask``: right-aligned causal, window edge, explicit offset;
    with a prefix: its rows see the whole prefix and nothing past it, later
    rows see it past their window, and it follows the right alignment."""
    m = ref.flash_mask(2, 4, window=2)
    assert m.tolist() == [[False, True, True, False],
                          [False, False, True, True]]
    assert ref.flash_mask(2, 4, causal=False).all()
    assert ref.flash_mask(3, 3, q_offset=-1)[0].sum() == 0
    T, F = True, False
    assert ref.flash_mask(4, 4, prefix_len=2).tolist() == [
        [T, T, F, F], [T, T, F, F], [T, T, T, F], [T, T, T, T]]
    assert ref.flash_mask(4, 4, window=1, prefix_len=1).tolist() == [
        [T, F, F, F], [T, T, F, F], [T, F, T, F], [T, F, F, T]]
    # right-aligned: rows at positions 2 and 3 of 4, a prefix of 3
    assert ref.flash_mask(2, 4, prefix_len=3).tolist() == [
        [T, T, T, F], [T, T, T, T]]
    assert ref.flash_mask(2, 4, causal=False, window=1,
                          prefix_len=1).tolist() == [[T, F, T, T],
                                                     [T, F, F, T]]


def prefix_inputs(seed, S, KV=2, G=2, hd=16, dtype="float32"):
    """Model-layout q (B, S, KV*G, hd), k/v (B, S, KV, hd) for both
    packages."""
    rng = np.random.default_rng(seed)
    return [pair(rng.standard_normal(shape).astype(np.float32), dtype)
            for shape in ((2, S, KV * G, hd), (2, S, KV, hd),
                          (2, S, KV, hd))]


@pytest.mark.parametrize("window,softcap", [
    (None, None), (16, None), (None, 20.0), (16, 20.0)])
@pytest.mark.parametrize("prefix_len", [1, 7, 20])
def test_prefix_plain_version_matches_jax_blockwise(prefix_len, window,
                                                    softcap):
    """The plain version with the prefix (kernel layout), ``ops.mha_forward``
    (model layout; on the CPU the plain version) and the port's CPU
    ``blockwise_attention`` against the JAX model's ``blockwise_attention``
    at ``chunk_q`` 32 >= prefix_len, float32 within 2e-5."""
    (jq, tq), (jk, tk), (jv, tv) = prefix_inputs(11, 96)
    kw = dict(window=window, attn_softcap=softcap, prefix_len=prefix_len)
    want = jattn.blockwise_attention(jq, jk, jv, chunk_q=32, chunk_kv=16,
                                     **kw)
    assert_close(blockwise_attention(tq, tk, tv, chunk_q=32, chunk_kv=16,
                                     **kw), want)
    got = ops.mha_forward(tq, tk, tv, window=window, softcap=softcap,
                          prefix_len=prefix_len)
    assert_close(got, want)
    B, S, H, hd = tq.shape
    KV = tk.shape[2]
    qk = tq.reshape(B, S, KV, H // KV, hd).permute(0, 2, 3, 1, 4)
    got = ref.flash_attention_ref(qk, tk.transpose(1, 2), tv.transpose(1, 2),
                                  window=window, softcap=softcap,
                                  prefix_len=prefix_len)
    assert_close(got.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd), want)


def test_reference_prefix_quirk():
    """The reference model's prefix mask depends on its tiles: a query
    tile's key range ends at its own last row, rounded up to ``chunk_kv``,
    so at ``chunk_q`` 16 < prefix_len 20 the rows of the first tile (which
    ends before the prefix does) never see prefix keys 16-19.  The port's
    CPU loop copies that (equal to JAX within 2e-5); the plain version and
    the CUDA kernels take the mask on absolute positions, so both packages'
    loops differ from it on exactly rows 0-15."""
    (jq, tq), (jk, tk), (jv, tv) = prefix_inputs(12, 64)
    kw = dict(chunk_q=16, chunk_kv=16, prefix_len=20)
    want = jattn.blockwise_attention(jq, jk, jv, **kw)
    got = blockwise_attention(tq, tk, tv, **kw)
    assert_close(got, want)
    plain = ops.mha_forward(tq, tk, tv, prefix_len=20)
    for loop in (got, torch.from_numpy(np.array(want))):
        diff = (loop - plain).abs().amax(dim=(0, 2, 3))     # per row
        assert (diff[:16] > 1e-2).all(), diff[:16]
        assert (diff[16:] <= 2e-5).all(), diff[16:].max()


def _edge(k0, bk, Skv, q_lo, q_hi, causal, window, P, naive=False):
    """``flash_tc_kernel``'s test of whether a key tile needs its masks;
    ``naive``: a wrong one that trusts a CTA wholly inside the prefix to
    need no causal mask, even on a tile that crosses the prefix's end."""
    in_prefix = k0 + bk <= P
    if naive:
        in_prefix = True
    return (k0 + bk > Skv
            or (causal and k0 + bk - 1 > q_lo
                and not (in_prefix and q_hi < P))
            or (window is not None and k0 <= q_hi - window
                and not (k0 + bk <= P)))


LOG2E = 1.4426950408889634


def tf32(x):
    """float32 ``x`` rounded to TF32 as ``flash_tf32x3_kernel`` rounds: to
    nearest, ties away from zero, on the float32 bits ((bits + 0x1000) &
    ~0x1FFF, ``cvt.rna.tf32.f32``)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def matmul_3xtf32(a, b):
    """a @ b as the 3xTF32 kernel computes it: each operand split into big
    = tf32(x) and small = tf32(x - big), small*big + big*small + big*big
    summed in float32 (each product of two TF32 values is exact in
    float32)."""
    ab, bb = tf32(a), tf32(b)
    return (tf32(a - ab) @ bb + ab @ tf32(b - bb)) + ab @ bb


def matmul_1xtf32(a, b):
    """a @ b of one TF32 pass (a wrong float32 kernel): 11 significant bits
    of each operand."""
    return tf32(a) @ tf32(b)


def tile_emulation(q, k, v, **kw):
    """:func:`_tile_emulation` on one CPU thread: its per-tile products are
    small, and beside other test workers a thread pool only slows them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _tile_emulation(q, k, v, **kw)
    finally:
        torch.set_num_threads(threads)


def _tile_emulation(q, k, v, *, kernel="tensor-core", causal=True,
                    window=None, softcap=None, prefix_len=0, wrong=None):
    """The tiling and arithmetic of one of ``csrc/flash_attention.cu``'s
    kernels, on the CPU (a test aid, not the function's plain version):
    CTAs of flattened (position, head) rows (``tiles``), each over its
    own range of key tiles, widened by a prefix to key 0 and, for a CTA
    with a row below ``prefix_len``, to the prefix's last tile.  The two
    tensor-core kernels (``"tensor-core"``, bfloat16, and ``"3xtf32"``,
    float32) mask (as their two bounds a row) only the tiles their edge
    test marks, and run the online softmax in base 2 (scores times hd^-0.5
    log2 e); ``"tensor-core"`` takes S = q . k of the bfloat16 values in
    float32 and rounds p to bfloat16 for the value product only;
    ``"3xtf32"`` runs both products in 3xTF32 (:func:`matmul_3xtf32`).
    ``"simt"``: masks on every tile, base e, p in float32.  l sums the
    float32 p everywhere.  ``wrong``: ``"range"`` leaves the tile range
    unwidened (keys past the causal range skipped), ``"edge"`` takes the
    naive edge test, ``"one-pass"`` runs ``"3xtf32"``'s products in one
    TF32 pass (:func:`matmul_1xtf32`)."""
    B, KV, G, Sq, hd = q.shape
    Skv = k.shape[2]
    tc = kernel != "simt"
    rows_per_cta, bk = tiles(kernel, hd)
    mm = torch.matmul
    if kernel == "3xtf32":
        mm = matmul_1xtf32 if wrong == "one-pass" else matmul_3xtf32
    n, q_offset, scale = Sq * G, Skv - Sq, hd ** -0.5
    P = prefix_len
    rows = q.float().permute(0, 1, 3, 2, 4).reshape(B, KV, n, hd)
    pad = (0, 0, 0, -Skv % bk)
    kf = torch.nn.functional.pad(k.float(), pad)
    vf = torch.nn.functional.pad(v.float(), pad)
    out = torch.empty(B, KV, n, hd)
    for r0 in range(0, n, rows_per_cta):
        r1 = min(r0 + rows_per_cta, n)
        qpos = torch.arange(r0, r1) // G + q_offset
        q_lo, q_hi = int(qpos[0]), int(qpos[-1])
        ntiles = -(-Skv // bk)
        t_hi = min(ntiles, q_hi // bk + 1) if causal else ntiles
        t_lo = max(0, q_lo - window + 1) // bk if window else 0
        if P > 0 and wrong != "range":
            t_lo = 0
            if q_lo < P:
                t_hi = max(t_hi, min(ntiles, -(-P // bk)))
        m = torch.full((B, KV, r1 - r0), -1e30)
        l = torch.zeros(B, KV, r1 - r0)
        acc = torch.zeros(B, KV, r1 - r0, hd)
        for t in range(t_lo, t_hi):
            kpos = torch.arange(t * bk, (t + 1) * bk)
            kt, vt = kf[:, :, t * bk:(t + 1) * bk], vf[:, :, t * bk:(t + 1) * bk]
            s = mm(rows[:, :, r0:r1], kt.transpose(-1, -2))
            if tc:     # base 2, as tc::online_softmax
                if softcap is not None:
                    s = (softcap * LOG2E) * torch.tanh(s * (scale / softcap))
                else:
                    s = s * (scale * LOG2E)
            else:
                s = s * scale
                if softcap is not None:
                    s = softcap * torch.tanh(s / softcap)
            if tc and _edge(t * bk, bk, Skv, q_lo, q_hi, causal, window, P,
                            naive=wrong == "edge"):
                # the tensor-core kernels' two bounds a row (``Tile``)
                hi = (torch.clamp(torch.clamp(qpos, min=P - 1), max=Skv - 1)
                      if causal else torch.full_like(qpos, Skv - 1))
                lo = qpos - window if window else torch.full_like(qpos, -1)
                mask = ((kpos[None, :] <= hi[:, None])
                        & ((kpos[None, :] > lo[:, None])
                           | (kpos < P)[None, :]))
                s = torch.where(mask, s, -1e30)
            elif not tc:
                mask = (kpos < Skv)[None, :]
                in_prefix = (kpos < P)[None, :]
                if causal:
                    mask = mask & ((qpos[:, None] >= kpos[None, :])
                                   | ((qpos[:, None] < P) & in_prefix))
                if window is not None:
                    mask = mask & ((kpos[None, :] > qpos[:, None] - window)
                                   | in_prefix)
                s = torch.where(mask, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            exp = torch.exp2 if tc else torch.exp
            p = exp(s - m_new[..., None])
            corr = exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = p.to(torch.bfloat16).float() if kernel == "tensor-core" else p
            acc = acc * corr[..., None] + mm(pv, vt)
            m = m_new
        out[:, :, r0:r1] = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, KV, Sq, G, hd).permute(0, 1, 3, 2, 4).to(q.dtype)


def tensor_core_emulation(q, k, v, **kw):
    """``tile_emulation`` of the tensor-core kernel."""
    return tile_emulation(q, k, v, kernel="tensor-core", **kw)


# PaliGemma's flash layout (one KV head, G 16 with its padding, hd 256): a
# tensor-core CTA (either dtype) covers 8 positions, a SIMT one 4, so
# prefixes of 1, 7 and 100 end inside a CTA; 100 also reaches past the
# first key tile (64 keys; 16 for the 3xTF32 kernel)
PREFIX_TILE_CASES = [(1, 96, None, None), (7, 300, None, None),
                     (64, 96, None, None), (100, 300, None, None),
                     (100, 300, 16, None), (7, 96, 16, 20.0)]


@pytest.mark.parametrize("prefix_len,S,window,softcap", PREFIX_TILE_CASES)
@pytest.mark.parametrize("kernel", ["tensor-core", "3xtf32", "simt"])
def test_kernel_tiling_with_prefix(kernel, prefix_len, S, window, softcap):
    """Each kernel's tiling with the prefix (q (2, 1, 16, S, 256)) against
    the JAX model's ``blockwise_attention`` over one tile (its mask on
    absolute positions): the bfloat16 tensor-core kernel's under the
    bfloat16 limit, the 3xTF32 and SIMT kernels' in float32 within 2e-5.
    Where the prefix reaches past 64 keys (every kernel's first key tile),
    the tile range left unwidened goes past the limit, and so do the
    tensor-core kernels with the naive edge test (their CTAs wholly inside
    the prefix then leave the tile across the prefix's end unmasked)."""
    dtype = "bfloat16" if kernel == "tensor-core" else "float32"
    (jq, tq), (jk, tk), (jv, tv) = prefix_inputs(13, S, KV=1, G=16, hd=256,
                                                 dtype=dtype)
    want = jattn.blockwise_attention(jq, jk, jv, chunk_q=S, chunk_kv=S,
                                     window=window, attn_softcap=softcap,
                                     prefix_len=prefix_len)
    qk = tq.reshape(2, S, 1, 16, 256).permute(0, 2, 3, 1, 4)
    kk, vk = tk.transpose(1, 2), tv.transpose(1, 2)

    def run(wrong=None):
        got = tile_emulation(qk, kk, vk, kernel=kernel, window=window,
                             softcap=softcap, prefix_len=prefix_len,
                             wrong=wrong)
        return got.permute(0, 3, 1, 2, 4).reshape(2, S, 16, 256)
    assert_close(run(), want, dtype)
    wrongs = []
    if prefix_len > 64:
        wrongs = ["range"] if kernel == "simt" else ["range", "edge"]
    for wrong in wrongs:
        with pytest.raises(AssertionError):
            assert_close(run(wrong), want, dtype)


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


@pytest.mark.parametrize("qshape,skv,window,softcap", [
    ((1, 1, 4, 384, 128), 384, None, None),    # qwen3_4b: G 4, hd 128
    ((1, 2, 2, 256, 128), 256, 33, 50.0),      # gemma2: G 2, window, softcap
    ((1, 1, 5, 150, 64), 200, None, None)])    # hymba_1_5b: G 5, hd 64
def test_tensor_core_numerics(qshape, skv, window, softcap):
    """bfloat16 p in the value product stays within the bfloat16 limit of
    the Pallas kernel (which keeps p in float32)."""
    (jq, tq), (jk, tk), (jv, tv) = inputs(7, qshape, skv, "bfloat16")
    got = tensor_core_emulation(tq, tk, tv, window=window, softcap=softcap)
    assert_close(got, j_flash(jq, jk, jv, window=window, softcap=softcap,
                              bq=128, bkv=128, interpret=True), "bfloat16")


@pytest.mark.parametrize("qshape,skv,window,softcap", [
    ((1, 1, 4, 384, 128), 384, None, None),    # qwen3_4b: G 4, hd 128
    ((1, 2, 2, 256, 128), 256, 33, 50.0),      # gemma2: G 2, window, softcap
    ((1, 1, 5, 150, 64), 200, None, None)])    # hymba_1_5b: G 5, hd 64
def test_tf32x3_numerics(qshape, skv, window, softcap):
    """The 3xTF32 kernel's arithmetic (its tiles, both products split into
    TF32 parts, the base-2 softmax) in float32 within 2e-5 of the Pallas
    kernel; one TF32 pass on the same tiles goes past that limit."""
    (jq, tq), (jk, tk), (jv, tv) = inputs(7, qshape, skv)
    want = j_flash(jq, jk, jv, window=window, softcap=softcap, bq=128,
                   bkv=128, interpret=True)
    kw = dict(kernel="3xtf32", window=window, softcap=softcap)
    assert_close(tile_emulation(tq, tk, tv, **kw), want)
    with pytest.raises(AssertionError):
        assert_close(tile_emulation(tq, tk, tv, wrong="one-pass", **kw), want)


def test_tf32_rounding():
    """``tf32``: 13 low bits cleared, to nearest with ties away from zero
    on both signs; the 3xTF32 split keeps x within 2^-22 |x|, one TF32
    value only within 2^-11 |x|."""
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -(1.0 + 2 ** -11), 1.0 + 2 ** -12])
    assert tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9,
                                -(1.0 + 2 ** -10), 1.0]
    y = torch.from_numpy(np.random.default_rng(8).standard_normal(
        4096).astype(np.float32))
    big = tf32(y)
    assert ((big.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((y - big).abs() <= 2 ** -11 * y.abs()).all()
    split = big.double() + tf32(y - big).double()
    assert ((split - y.double()).abs() <= 2 ** -22 * y.abs().double()).all()


def test_every_attention_config_takes_the_tensor_cores():
    """Every head_dim of the port's attention configs goes to a tensor-core
    kernel in both dtypes: bfloat16 to ``flash_tc_kernel``, float32 to the
    3xTF32 kernel; hd 16 and 32 (the checks' shapes) stay on the SIMT
    kernel."""
    for name in configs.list_archs():
        cfg = configs.get(name)
        if cfg.num_heads:
            hd = cfg.resolved_head_dim
            assert kernel_path(torch.bfloat16, hd) == "tensor-core", name
            assert kernel_path(torch.float32, hd) == "3xtf32", name
    assert kernel_path(torch.bfloat16, 32) == "simt"
    assert kernel_path(torch.float32, 32) == "simt"


def _misaligned(case):
    flat = torch.zeros(2 * 8 * 72, dtype=torch.bfloat16)
    if case == "row stride":     # 68 elements = 136 bytes between keys
        return flat[:8 * 68].view(1, 1, 8, 68)[..., :64]
    return flat[1:1 + 8 * 64].view(1, 1, 8, 64)    # base 2 bytes off


@pytest.mark.parametrize("name", ["k", "v"])
@pytest.mark.parametrize("case,match", [
    ("row stride", "has stride 68 .136 bytes. on axis 2"),
    ("base offset", "starts at .*not 16-byte aligned")])
def test_tma_check_refuses(name, case, match):
    t = _misaligned(case)
    with pytest.raises(ValueError, match=f"{name} {match}"):
        check_tma(name, t.data_ptr(), t.shape, t.stride(), t.element_size())


def test_tma_check_takes_the_model_layout():
    """``ops.mha_forward``'s transposed views pass, and an axis of length 1
    may have any stride."""
    k = torch.zeros(2, 40, 3, 64, dtype=torch.bfloat16).transpose(1, 2)
    check_tma("k", k.data_ptr(), k.shape, k.stride(), k.element_size())
    q = torch.zeros(1, 5, 64, dtype=torch.bfloat16)[:, None]
    q = q.as_strided((1, 1, 5, 64), (7, 3, 64, 1))
    check_tma("q", q.data_ptr(), q.shape, q.stride(), q.element_size())
