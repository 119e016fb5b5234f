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
from repro_torch.kernels._decode import SPLIT
from repro_torch.kernels.paged_attention import attend as paged_attention_attend
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


@pytest.mark.parametrize("window,softcap", [(None, None), (6, None),
                                            (None, 4.0), (9, 7.0)])
def test_self_row_fold_matches_jax_decode_attention(window, softcap):
    """The plain version of the kernels' self-row fold (``k_new``/``v_new``
    as the last live position, ``ctx_len`` counting the old tokens, the
    window counting the self row) against the JAX model's
    ``decode_attention``, whose ``ctx_len`` counts the new token, in
    float32 within 2e-5; the paged plain version through a shuffled table
    gives the same."""
    from repro.models.attention import decode_attention as j_decode
    rng = np.random.default_rng(12)
    B, KV, G, hd, S, bs = 3, 2, 3, 16, 40, 8
    q = rng.standard_normal((B, KV * G, hd)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, KV, S, hd)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((B, KV, hd)).astype(np.float32)
              for _ in range(2))
    old = np.array([0, 17, 40], np.int32)
    want = j_decode(*map(jnp.asarray, (q, kc, vc, old + 1)),
                    k_new=jnp.asarray(kn), v_new=jnp.asarray(vn),
                    attn_softcap=softcap, window=window)
    tq = torch.from_numpy(q).reshape(B, KV, G, hd)
    got = ref.decode_attention_ref(
        tq, torch.from_numpy(kc), torch.from_numpy(vc), torch.from_numpy(old),
        window=window, softcap=softcap, k_new=torch.from_numpy(kn),
        v_new=torch.from_numpy(vn))
    assert_close(got.reshape(B, KV * G, hd), want, "float32")

    MB = S // bs
    tables = rng.permutation(B * MB).reshape(B, MB).astype(np.int32)
    pools = np.zeros((2, B * MB, KV, bs, hd), np.float32)
    for b in range(B):
        for m in range(MB):
            pools[0, tables[b, m]] = kc[b, :, m * bs:(m + 1) * bs]
            pools[1, tables[b, m]] = vc[b, :, m * bs:(m + 1) * bs]
    got = ref.paged_attention_ref(
        tq, torch.from_numpy(pools[0]), torch.from_numpy(pools[1]),
        torch.from_numpy(tables), torch.from_numpy(old), window=window,
        softcap=softcap, k_new=torch.from_numpy(kn),
        v_new=torch.from_numpy(vn))
    assert_close(got.reshape(B, KV * G, hd), want, "float32")


@pytest.mark.parametrize("window", [1, 13, 40])
def test_paged_window_matches_shortcut(window):
    """The paged plain version with a window (the TPU paged kernel has
    none; the model's local layers need it) against the shortcut kernel's
    on the same rows through a shuffled table, one -1 entry wholly before
    the window."""
    rng = np.random.default_rng(13)
    B, KV, G, hd, bs, MB = 2, 2, 2, 32, 8, 8
    q = rng.standard_normal((B, KV, G, hd)).astype(np.float32)
    view = rng.standard_normal((2, B, KV, MB * bs, hd)).astype(np.float32)
    lens = np.array([61, 37], np.int32)
    tables = rng.permutation(B * MB).reshape(B, MB).astype(np.int32)
    pools = np.zeros((2, B * MB, KV, bs, hd), np.float32)
    for b in range(B):
        for m in range(MB):
            pools[:, tables[b, m]] = view[:, b, :, m * bs:(m + 1) * bs]
    if window <= 13:
        tables[0, 0] = -1        # before the window: never read
    want = j_short(*(jnp.asarray(a) for a in (q, view[0], view[1], lens)),
                   bs=16, window=window, softcap=9.0)
    got = paged_attention_attend(
        torch.from_numpy(q), torch.from_numpy(pools[0]),
        torch.from_numpy(pools[1]), torch.from_numpy(tables),
        torch.from_numpy(lens), window=window, softcap=9.0)
    assert_close(got, want, "float32")
    short = shortcut_attention(*(torch.from_numpy(a) for a in
                                 (q, view[0], view[1], lens)),
                               window=window, softcap=9.0)
    np.testing.assert_allclose(got.numpy(), short.numpy(), rtol=1e-6,
                               atol=1e-6)


def split_k_emulation(q, rows, lens, *, window=None, softcap=None,
                      k_new=None, v_new=None, split=SPLIT, tile=64):
    """The arithmetic of ``csrc/decode_attention.cu`` on the CPU (a test
    aid, not the function's plain version): ``rows(b, lo, hi)`` gives the K
    and V rows (KV, hi - lo, hd) of positions [lo, hi) of sequence b and a
    (hi - lo,) live mask (the paged route's -1 entries), zeros where dead.
    Splits of ``split`` tokens, tiles of 64 at absolute multiples of 64;
    per tile f32 scores of the scaled q, base-2 exponentials, one max and
    one rescale per row, p kept in f32; partials (m, l, acc) per split;
    the combine in split order, empty splits skipped, then the self row."""
    B, KV, G, hd = q.shape
    qs = q.float() * hd ** -0.5
    log2e = 1.4426950408889634
    out = torch.zeros(B, KV, G, hd)
    for b in range(B):
        n = int(lens[b])
        has_self = k_new is not None
        lo = max(0, n + int(has_self) - window) if window else 0
        parts = []
        for s0 in range(0, n, split):
            s1 = min(s0 + split, n)
            first = max(s0, lo)
            if first >= s1:
                continue
            m = torch.full((KV, G), -1e30)
            l = torch.zeros(KV, G)
            acc = torch.zeros(KV, G, hd)
            for t0 in range(s0 + (first - s0) // tile * tile, s1, tile):
                kt, vt, ok = rows(b, t0, t0 + tile)
                pos = torch.arange(t0, t0 + tile)
                live = ok & (pos >= lo) & (pos < s1)
                s = torch.einsum("kgd,ktd->kgt", qs[b], kt.float())
                if softcap is not None:
                    s = softcap * torch.tanh(s / softcap)
                s = torch.where(live, s * log2e, float("-inf"))
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new[..., None])
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + torch.einsum(
                    "kgt,ktd->kgd", p, vt.float())
                m = m_new
            parts.append((m, l, acc))
        M = torch.full((KV, G), -1e30)
        if has_self:
            s_self = torch.einsum("kgd,kd->kg", qs[b], k_new[b].float())
            if softcap is not None:
                s_self = softcap * torch.tanh(s_self / softcap)
            s_self = s_self * log2e
            M = s_self
        for m, l, _ in parts:
            M = torch.where(l > 0, torch.maximum(M, m), M)
        L = torch.zeros(KV, G)
        o = torch.zeros(KV, G, hd)
        for m, l, acc in parts:
            w = torch.where(l > 0, torch.exp2(m - M), 0.0)
            L = L + l * w
            o = o + acc * w[..., None]
        if has_self:
            w = torch.exp2(s_self - M)
            L = L + w
            o = o + w[..., None] * v_new[b].float()[:, None]
        out[b] = o / L.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


def view_rows(k, v):
    """``rows`` for ``split_k_emulation`` over (B, KV, S, hd) views."""
    S = k.shape[2]

    def rows(b, lo, hi):
        pad = (0, 0, 0, max(0, hi - S))
        live = torch.arange(lo, hi) < S
        return (torch.nn.functional.pad(k[b, :, lo:hi], pad),
                torch.nn.functional.pad(v[b, :, lo:hi], pad), live)
    return rows


def pool_rows(kp, vp, tables):
    """``rows`` through block tables over (nblocks, KV, bs, hd) pools."""
    bs = kp.shape[2]

    def rows(b, lo, hi):
        pos = torch.arange(lo, hi)
        blk = pos // bs
        ok = blk < tables.shape[1]
        ent = torch.where(ok, tables[b, blk.clamp(max=tables.shape[1] - 1)],
                          -1)
        live = ent >= 0
        e, r = ent.clamp_min(0).long(), (pos % bs).long()
        z = live[None, :, None]
        return (torch.where(z, kp[e, :, r].transpose(0, 1), 0),
                torch.where(z, vp[e, :, r].transpose(0, 1), 0), live)
    return rows


@pytest.mark.parametrize("S,lens,window,softcap", [
    (320, [255, 256, 257], None, None),
    (608, [600, 1, 513], None, 30.0),
    (608, [599, 300, 64], 200, None)])
def test_split_k_emulation_matches_pallas(S, lens, window, softcap):
    """The kernel's split-and-combine order (splits of SPLIT tokens, contexts
    on and across their edges) against the JAX Pallas kernels in interpret
    mode, bfloat16 inputs, under the bfloat16 limit; the paged route through
    a shuffled table gives the same emulated output bit for bit, as the
    kernel's two routes must; and with the self row, against the plain
    version."""
    rng = np.random.default_rng(14)
    B, KV, G, hd, bs = 3, 2, 4, 32, 16
    q = rng.standard_normal((B, KV, G, hd)).astype(np.float32)
    kv = rng.standard_normal((2, B, KV, S, hd)).astype(np.float32)
    ctx = np.array(lens, np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (pair(a, "bfloat16")
                                    for a in (q, kv[0], kv[1]))
    got = split_k_emulation(tq, view_rows(tk, tv), ctx, window=window,
                            softcap=softcap)
    want = j_short(jq, jk, jv, jnp.asarray(ctx), bs=64, window=window,
                   softcap=softcap)
    assert_close(got, want, "bfloat16")

    MB = S // bs
    tables = torch.from_numpy(rng.permutation(B * MB).reshape(B, MB)
                              .astype(np.int32))
    kp = torch.zeros((B * MB, KV, bs, hd), dtype=torch.bfloat16)
    vp = torch.zeros_like(kp)
    for b in range(B):
        for m in range(MB):
            kp[tables[b, m]] = tk[b, :, m * bs:(m + 1) * bs]
            vp[tables[b, m]] = tv[b, :, m * bs:(m + 1) * bs]
    paged = split_k_emulation(tq, pool_rows(kp, vp, tables), ctx,
                              window=window, softcap=softcap)
    assert torch.equal(paged, got)
    if window is None:
        jwant = j_paged(jq, *(jnp.asarray(np.array(t.float()))
                              .astype(jnp.bfloat16) for t in (kp, vp)),
                        jnp.asarray(tables.numpy()), jnp.asarray(ctx),
                        softcap=softcap)
        assert_close(paged, jwant, "bfloat16")

    kn, vn = (torch.from_numpy(rng.standard_normal((B, KV, hd))
                               .astype(np.float32)).to(torch.bfloat16)
              for _ in range(2))
    got = split_k_emulation(tq, view_rows(tk, tv), ctx, window=window,
                            softcap=softcap, k_new=kn, v_new=vn)
    plain = ref.decode_attention_ref(tq, tk, tv, torch.from_numpy(ctx),
                                     window=window, softcap=softcap,
                                     k_new=kn, v_new=vn)
    limit = 2.0 ** -7 * plain.float().abs() + \
        2.0 ** -8 * plain.float().abs().max()
    assert ((got.float() - plain.float()).abs() <= limit).all()
