"""Port parity for the model stack: ``repro_torch.models`` (layers,
attention, model) against ``repro.models`` on the same parameters (the JAX
package's ``init_params`` carried across with ``convert.params_from_numpy``)
and the same tokens, in float32 on the CPU at ``.reduced()`` widths, for the
attention-only architectures, PaliGemma's prefix model (seeded patch
embeddings in front of the tokens) and the MoE, SSM and hybrid ones.  Tolerance
1e-5 (rtol = atol): the two sum in other orders, and rope's float32 cos and
sin may differ from XLA's by an ulp."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED as J_ASSIGNED
from repro.configs import get as jget
from repro.models import attention as jattn
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import ASSIGNED, get
from repro_torch.models import attention as attn
from repro_torch.models import model as M
from repro_torch.runtime import serve

B, S = 2, 64
ATTN_ARCHS = ["qwen3_4b", "internlm2_1_8b", "gemma2_27b",
              "command_r_plus_104b", "musicgen_medium"]
MOE_SSM_ARCHS = ["qwen2_moe_a2_7b", "arctic_480b", "mamba2_370m",
                 "hymba_1_5b"]
PREFIX_ARCHS = ["paligemma_3b"]
TOL = dict(rtol=1e-5, atol=1e-5)


def close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or TOL))


def setup(arch, seed=2, cfg_j=None):
    """Both configs, both parameter sets, and seeded tokens (B, S + 1); for
    a prefix model the tokens follow its ``prefix_len`` patch embeddings
    (``prefix_of``)."""
    cfg_j = cfg_j or jget(arch).reduced()
    cfg_t = get(arch).reduced()
    if cfg_j != jget(arch).reduced():
        cfg_t = dataclasses.replace(
            cfg_t, **{f.name: getattr(cfg_j, f.name)
                      for f in dataclasses.fields(cfg_j)})
    jp = JM.init_params(cfg_j, jax.random.PRNGKey(seed), jnp.float32)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    toks = np.random.default_rng(seed).integers(
        0, cfg_j.vocab_size, (B, S + 1)).astype(np.int32)
    return cfg_j, cfg_t, jp, tp, toks


def prefix_of(cfg, seed=2):
    """A prefix model's seeded patch embeddings (B, prefix_len, D), float32
    numpy, the same for both packages."""
    return np.random.default_rng(seed + 100).standard_normal(
        (B, cfg.prefix_len, cfg.d_model)).astype(np.float32)


def batches(cfg, params, toks, n, emb_of, as_array):
    """The model input of the first ``n`` tokens: tokens, (for embedding
    inputs) the embedding rows of the tokens, as the reference's decode
    test feeds them, or (a prefix model) the tokens behind
    :func:`prefix_of`'s embeddings."""
    if cfg.input_mode == "embeddings":
        return {"embeddings": emb_of(params["embed"], toks[:, :n])}
    if cfg.input_mode == "prefix_embeddings":
        return {"tokens": toks[:, :n],
                "prefix_embeddings": as_array(prefix_of(cfg))}
    return {"tokens": toks[:, :n]}


def jbatch(cfg, jp, toks, n):
    return batches(cfg, jp, jnp.asarray(toks), n, lambda e, t: e[t],
                   jnp.asarray)


def tbatch(cfg, tp, toks, n):
    return batches(cfg, tp, torch.from_numpy(toks).long(), n,
                   lambda e, t: e[t], torch.from_numpy)


def n_prefix(cfg):
    """Positions in front of the tokens: a prefix model's ``prefix_len``."""
    return cfg.prefix_len if cfg.input_mode == "prefix_embeddings" else 0


def decode_ctx_j(caches, pad=16):
    """The prefill's caches as the reference's decode context: the views
    (attention-native, padded) and the stacked SSM cache."""
    k = v = ()
    if not isinstance(caches.k, tuple):
        k, v = (jnp.pad(c.transpose(0, 1, 3, 2, 4),
                        ((0, 0), (0, 0), (0, 0), (0, pad), (0, 0)))
                for c in (caches.k, caches.v))
    return JM.LayerCache(k=k, v=v, ssm=caches.ssm)


def decode_ctx_t(caches, pad=16):
    k = v = ()
    if not isinstance(caches.k, tuple):
        k, v = (torch.nn.functional.pad(c.transpose(2, 3), (0, 0, 0, pad))
                for c in (caches.k, caches.v))
    return M.LayerCache(k=k, v=v, ssm=caches.ssm)


def close_caches(tc, jc):
    """Every member of two (prefill or decode) LayerCaches, () where the
    reference has ()."""
    for name in ("k", "v"):
        if isinstance(getattr(jc, name), tuple):
            assert getattr(tc, name) == ()
        else:
            close(getattr(tc, name), getattr(jc, name))
    if jc.ssm == ():
        assert tc.ssm == ()
    else:
        close(tc.ssm.conv, jc.ssm.conv)
        close(tc.ssm.state, jc.ssm.state)
        assert tc.ssm.state.dtype == torch.float32


@pytest.mark.parametrize("arch", ATTN_ARCHS + PREFIX_ARCHS + MOE_SSM_ARCHS)
def test_prefill_and_decode_match_jax(arch):
    cfg_j, cfg_t, jp, tp, toks = setup(arch)
    jl, jc = JM.prefill_forward(jp, cfg_j, jbatch(cfg_j, jp, toks, S))
    tl, tc = M.prefill_forward(tp, cfg_t, tbatch(cfg_t, tp, toks, S))
    assert tl.shape == (B, cfg_t.vocab_size)
    close(tl, jl)
    close_caches(tc, jc)

    ctx_len = np.full((B,), n_prefix(cfg_t) + S + 1, np.int32)
    jlog, jnew = JM.decode_step(jp, cfg_j, jnp.asarray(toks[:, S]),
                                decode_ctx_j(jc), jnp.asarray(ctx_len))
    tlog, tnew = M.decode_step(tp, cfg_t, torch.from_numpy(toks[:, S]),
                               decode_ctx_t(tc), torch.from_numpy(ctx_len))
    close(tlog, jlog)
    close_caches(tnew, jnew)


@pytest.mark.parametrize("arch", ATTN_ARCHS + PREFIX_ARCHS + MOE_SSM_ARCHS)
def test_decode_matches_full_forward(arch):
    """The reference's strongest cache check, on the port alone: prefill(S)
    + decode_step == the full forward's logits at position S (the reference
    test's 2e-4; the reduced MoE configs' capacity drops no pair; a prefix
    model's context counts its prefix)."""
    _, cfg, _, tp, toks = setup(arch)
    want, _ = M.prefill_forward(tp, cfg, tbatch(cfg, tp, toks, S + 1))
    _, caches = M.prefill_forward(tp, cfg, tbatch(cfg, tp, toks, S))
    ctx_len = torch.full((B,), n_prefix(cfg) + S + 1, dtype=torch.int32)
    got, new = M.decode_step(tp, cfg, torch.from_numpy(toks[:, S]),
                             decode_ctx_t(caches), ctx_len)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    if cfg.has_attention:
        assert new.k.shape == (cfg.num_layers, B, cfg.num_kv_heads,
                               cfg.resolved_head_dim)
        # a wrong rope position moves the logits past that tolerance
        bad, _ = M.decode_step(tp, cfg, torch.from_numpy(toks[:, S]),
                               decode_ctx_t(caches), ctx_len,
                               positions=ctx_len)
        assert (bad - want).abs().max() > 1e-2
    if cfg.has_ssm:
        assert new.ssm.state.shape == caches.ssm.state.shape
        # and so does a decode from a zeroed SSM state
        ctx = decode_ctx_t(caches)
        ctx = ctx._replace(ssm=ctx.ssm._replace(
            state=torch.zeros_like(ctx.ssm.state)))
        bad, _ = M.decode_step(tp, cfg, torch.from_numpy(toks[:, S]), ctx,
                               ctx_len)
        assert (bad - want).abs().max() > 1e-2


@pytest.mark.parametrize("arch", MOE_SSM_ARCHS + ["qwen3_4b"])
def test_forward_hidden_aux_matches_jax(arch):
    """``forward_hidden``'s third value, the router's auxiliary loss summed
    over the layers (0 without MoE)."""
    cfg_j, cfg_t, jp, tp, toks = setup(arch, seed=5)
    jh, _, jaux = JM.forward_hidden(jp, cfg_j, jbatch(cfg_j, jp, toks, S),
                                    want_cache=False, remat=False)
    th, caches, aux = M.forward_hidden(tp, cfg_t, tbatch(cfg_t, tp, toks, S))
    assert caches is None and aux.dtype == torch.float32 and aux.dim() == 0
    assert th.shape == jh.shape
    close(aux, jaux)
    assert (float(aux) > 0) == bool(cfg_t.num_experts)


def test_layer_kinds_and_runs_match_jax():
    assert ASSIGNED == J_ASSIGNED
    for arch in ASSIGNED:
        assert dataclasses.asdict(get(arch)) == \
            dataclasses.asdict(jget(arch)), arch
        assert M.layer_kinds(get(arch)) == JM.layer_kinds(jget(arch)), arch
        assert M.layer_runs(get(arch)) == JM.layer_runs(jget(arch)), arch
        assert M.layer_runs(get(arch).reduced()) == \
            JM.layer_runs(jget(arch).reduced()), arch


@pytest.mark.parametrize("pad_kv,pad_g", [(3, 0), (0, 4), (3, 3)])
def test_pad_unpad_heads_match_jax(pad_kv, pad_g):
    cfg_j = dataclasses.replace(jget("qwen3_4b").reduced(),
                                pad_kv_heads=pad_kv, pad_q_groups=pad_g)
    cfg_t = dataclasses.replace(get("qwen3_4b").reduced(),
                                pad_kv_heads=pad_kv, pad_q_groups=pad_g)
    rng = np.random.default_rng(7)
    H, KV, hd = cfg_j.num_heads, cfg_j.num_kv_heads, cfg_j.resolved_head_dim
    q, k, v = (rng.standard_normal((2, 5, n, hd)).astype(np.float32)
               for n in (H, KV, KV))
    jq, jk, jv, jn = jattn.pad_heads(*map(jnp.asarray, (q, k, v)), cfg_j)
    tq, tk, tv, tn = attn.pad_heads(*map(torch.from_numpy, (q, k, v)), cfg_t)
    assert tn == jn
    for t, j in ((tq, jq), (tk, jk), (tv, jv)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(
        attn.unpad_heads(tq, cfg_t).numpy(),
        np.asarray(jattn.unpad_heads(jq, cfg_j)))
    np.testing.assert_array_equal(attn.unpad_heads(tq, cfg_t).numpy(), q)


def test_padded_prefill_matches_jax():
    """A model with padded heads (dead q-groups and kv-heads): logits and
    the padded caches as the reference gives them."""
    cfg_j = dataclasses.replace(jget("qwen3_4b").reduced(), pad_kv_heads=3,
                                pad_q_groups=3)
    cfg_j, cfg_t, jp, tp, toks = setup("qwen3_4b", seed=3, cfg_j=cfg_j)
    jl, jc = JM.prefill_forward(jp, cfg_j, jbatch(cfg_j, jp, toks, S))
    tl, tc = M.prefill_forward(tp, cfg_t, tbatch(cfg_t, tp, toks, S))
    assert tc.k.shape[3] == 3
    close(tl, jl)
    close(tc.k, jc.k)


@pytest.mark.parametrize("prefix_len,window,softcap", [
    (8, None, None), (8, 24, None), (20, 16, 30.0)])
def test_blockwise_prefix_matches_jax(prefix_len, window, softcap):
    rng = np.random.default_rng(8)
    Bq, Sq, KV, G, hd = 2, 64, 2, 2, 16
    q = rng.standard_normal((Bq, Sq, KV * G, hd)).astype(np.float32)
    k, v = (rng.standard_normal((Bq, Sq, KV, hd)).astype(np.float32)
            for _ in range(2))
    kw = dict(chunk_q=16, chunk_kv=16, window=window, attn_softcap=softcap,
              prefix_len=prefix_len)
    want = jattn.blockwise_attention(*map(jnp.asarray, (q, k, v)), **kw)
    got = attn.blockwise_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    close(got, want)


@pytest.mark.parametrize("change", [
    {}, {"pad_q_groups": 8}, {"prefix_len": 20}])
def test_prefix_model_matches_jax(change):
    """PaliGemma's prefix model (reduced: 8 patch embeddings, 4 query heads
    over 1 KV head, gelu, tied embedding): the hidden states, the prefill
    logits and caches as the reference gives them; also with its q-groups
    padded to twice the heads, as the full config pads 8 to 16, and with a
    20-position prefix (under the reduced ``attn_chunk_q`` 32, where the
    reference's tiles give the mask on absolute positions)."""
    cfg_j = dataclasses.replace(jget("paligemma_3b").reduced(), **change)
    cfg_j, cfg_t, jp, tp, toks = setup("paligemma_3b", seed=4, cfg_j=cfg_j)
    assert "lm_head" not in tp and cfg_t.act == "gelu"
    jh, _, _ = JM.forward_hidden(jp, cfg_j, jbatch(cfg_j, jp, toks, S),
                                 want_cache=False, remat=False)
    th, _, _ = M.forward_hidden(tp, cfg_t, tbatch(cfg_t, tp, toks, S))
    assert th.shape == (B, cfg_t.prefix_len + S, cfg_t.d_model)
    close(th, jh)
    jl, jc = JM.prefill_forward(jp, cfg_j, jbatch(cfg_j, jp, toks, S))
    tl, tc = M.prefill_forward(tp, cfg_t, tbatch(cfg_t, tp, toks, S))
    assert tc.k.shape[2] == cfg_t.prefix_len + S
    close(tl, jl)
    close_caches(tc, jc)


def test_prefix_mask_moves_the_logits():
    """The same prefix model with its bidirectional mask dropped (the
    prefix embeddings still in front, attended causally) moves the prefill
    logits far past the parity tolerance: the tests above see the mask."""
    _, cfg, _, tp, toks = setup("paligemma_3b")
    batch = tbatch(cfg, tp, toks, S)
    want, _ = M.prefill_forward(tp, cfg, batch)
    bad, _ = M.prefill_forward(tp, dataclasses.replace(cfg, prefix_len=0),
                               batch)
    assert (bad - want).abs().max() > 1e-2


def test_prefix_params_convert():
    """PaliGemma's parameters cross from the JAX package as they are: a
    tied embedding and no ``lm_head``, the gelu MLP's three matrices, the
    reference's head padding kept as configuration (``pad_q_groups`` 16 in
    the full config: 8 query heads padded to 16 on the flash path); cast to
    bfloat16 and back unchanged."""
    full = get("paligemma_3b")
    assert (full.pad_q_groups, full.num_heads, full.num_kv_heads) == (16, 8, 1)
    assert full.tie_embeddings and full.act == "gelu"
    cfg_j = dataclasses.replace(jget("paligemma_3b").reduced(),
                                pad_q_groups=8)
    jp = JM.init_params(cfg_j, jax.random.PRNGKey(0), jnp.float32)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   dtype=torch.bfloat16, device="cpu")
    own = M.init_params(get("paligemma_3b").reduced(), 0, torch.bfloat16,
                        device="cpu")
    assert dict(_flatten(tp)).keys() == dict(_flatten(own)).keys()
    for name, t in _flatten(tp):
        assert t.dtype == torch.bfloat16, name
    back = convert.params_to_numpy(tp)
    for name, t in _flatten(back):
        want = np.asarray(dict(_flatten(jp))[name].astype(jnp.bfloat16),
                          np.float32)
        np.testing.assert_array_equal(t, want, err_msg=name)


@pytest.mark.parametrize("arch", ["qwen3_4b", "gemma2_27b"])
def test_decode_step_paged_context_equals_gathered(arch):
    """``decode_step`` over a ``PagedContext`` (pools and block tables, the
    paged route; blocks handed out in shuffled order) gives bit for bit what
    it gives over the ``LayerCache`` that ``paged_cache.gather_context``
    materializes from the same cache: on the CPU both attend through the
    plain ``decode_attention`` over the same gathered rows."""
    from repro_torch.kvcache import paged_cache as pc
    _, cfg, _, tp, toks = setup(arch)
    _, caches = M.prefill_forward(tp, cfg, tbatch(cfg, tp, toks, S))
    bs, MB = 8, S // 8 + 2
    cache = pc.cache_create(cfg.num_layers, 2 * B * MB, bs,
                            cfg.num_kv_heads, cfg.resolved_head_dim, B, MB,
                            torch.float32, device="cpu")
    perm = np.random.default_rng(3).permutation(2 * B * MB)
    cache = cache._replace(free_ring=torch.from_numpy(perm).to(torch.int32))
    ids = torch.arange(B)
    cache = pc.write_prefill(cache, ids, caches.k, caches.v)
    ctx_len = torch.full((B,), S + 1, dtype=torch.int32)
    tok = torch.from_numpy(toks[:, S])
    paged = M.PagedContext(k_pool=cache.k_pool, v_pool=cache.v_pool,
                           block_tables=cache.block_tables[ids])
    got, new = M.decode_step(tp, cfg, tok, paged, ctx_len)
    k_ctx, v_ctx = pc.gather_context(cache, ids)
    want, want_new = M.decode_step(tp, cfg, tok,
                                   M.LayerCache(k=k_ctx, v=v_ctx), ctx_len)
    assert torch.equal(got, want)
    assert torch.equal(new.k, want_new.k) and torch.equal(new.v, want_new.v)


@pytest.mark.parametrize("window,softcap", [(None, None), (5, 7.0)])
def test_decode_attention_matches_jax(window, softcap):
    rng = np.random.default_rng(9)
    Bd, KV, G, Sc, hd = 3, 2, 2, 24, 16
    q = rng.standard_normal((Bd, KV * G, hd)).astype(np.float32)
    kc, vc = (rng.standard_normal((Bd, KV, Sc, hd)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((Bd, KV, hd)).astype(np.float32)
              for _ in range(2))
    ctx = np.array([1, 9, 24], np.int32)
    for new in (False, True):
        kw = dict(attn_softcap=softcap, window=window)
        jkw, tkw = dict(kw), dict(kw)
        if new:
            jkw.update(k_new=jnp.asarray(kn), v_new=jnp.asarray(vn))
            tkw.update(k_new=torch.from_numpy(kn), v_new=torch.from_numpy(vn))
        want = jattn.decode_attention(*map(jnp.asarray, (q, kc, vc, ctx)),
                                      **jkw)
        got = attn.decode_attention(*map(torch.from_numpy, (q, kc, vc, ctx)),
                                    **tkw)
        close(got, want)


def bf16_logit_errors(layers, d_model, prompt, steps=8, batch=2):
    """The computation behind ``chip_smoke.LOGIT_LIMIT``, on the CPU: a
    qwen3-shaped model (8 heads over 2 KV heads x 64, d_ff 3 d_model,
    vocab 8192) in bfloat16 prefills ``prompt`` random tokens and serves
    ``steps`` greedy steps; returns the largest per-sequence relative RMS
    of the last step's decode logits against a full forward over prompt +
    fed tokens, and the same for a decode with the rope position off by
    one."""
    cfg = dataclasses.replace(
        get("qwen3_4b"), num_layers=layers, d_model=d_model, num_heads=8,
        num_kv_heads=2, head_dim=64, d_ff=3 * d_model, vocab_size=8192,
        attn_chunk_q=256, attn_chunk_kv=256)
    params = M.init_params(cfg, 0, torch.bfloat16, device="cpu")
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen)
    logits, state = serve.make_prefill_step(cfg, prompt + 2 * steps)(
        params, {"tokens": toks})
    tok = logits.argmax(-1).int()
    fed, step = [tok], serve.make_serve_step(cfg)
    for _ in range(steps - 1):
        tok, state = step(params, state, tok)
        fed.append(tok)
    ctx = M.LayerCache(k=state.view_k, v=state.view_v)
    inc = state.ctx_len + 1
    got, _ = M.decode_step(params, cfg, tok, ctx, inc)
    bad, _ = M.decode_step(params, cfg, tok, ctx, inc, positions=inc)
    full = torch.cat([toks, torch.stack(fed, 1).long()], 1)
    want, _ = M.prefill_forward(params, cfg, {"tokens": full})

    def rel(x):
        x, w = x.float(), want.float()
        return float(((x - w).norm(dim=-1) / w.norm(dim=-1)).max())
    return rel(got), rel(bad)


def test_bf16_decode_logit_limit():
    """chip_smoke.py's limit on bf16 decode logits against the full forward
    (0.06 relative RMS) holds a sound decode and refuses one with the rope
    position off by one, here at 12 layers of d 256."""
    sound, wrong = bf16_logit_errors(12, 256, 128)
    assert sound <= 0.06 < wrong, (sound, wrong)


@pytest.mark.parametrize("arch", MOE_SSM_ARCHS)
def test_moe_ssm_families_init(arch):
    """The four families' parameters: the reference's tree, shapes and
    dtypes at a bfloat16 model dtype (the router and the SSM's A_log, D and
    dt_bias float32)."""
    cfg = get(arch).reduced()
    params = M.init_params(cfg, 0, torch.bfloat16, device="cpu")
    jp = jax.eval_shape(lambda: JM.init_params(
        jget(arch).reduced(), jax.random.PRNGKey(0), jnp.bfloat16))
    flat_t = dict(_flatten(params))
    flat_j = dict(_flatten(jp))
    assert flat_t.keys() == flat_j.keys()
    for name, want in flat_j.items():
        got = flat_t[name]
        assert tuple(got.shape) == want.shape, name
        assert (got.dtype == torch.float32) == (want.dtype == jnp.float32), \
            name


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + k + "/")
        else:
            yield prefix + k, v


def test_convert_keeps_float32_members():
    """``convert.params_from_numpy`` under a bfloat16 ``dtype`` casts the
    model's tensors but keeps the router and the SSM's A_log, D and dt_bias
    float32; ``decode_state_from_numpy`` keeps ``ssm_state`` float32 and
    gives ``ssm_conv`` the model dtype."""
    from repro.runtime import serve as jserve
    for arch in ("qwen2_moe_a2_7b", "hymba_1_5b"):
        cfg_j = jget(arch).reduced()
        jp = JM.init_params(cfg_j, jax.random.PRNGKey(0), jnp.float32)
        tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                       dtype=torch.bfloat16, device="cpu")
        for name, t in _flatten(tp):
            leaf = name.rsplit("/", 1)[-1]
            want = torch.float32 if leaf in ("router", "A_log", "D",
                                             "dt_bias") else torch.bfloat16
            assert t.dtype == want, (arch, name, t.dtype)
        back = convert.params_to_numpy(tp)
        np.testing.assert_array_equal(back["layers"]["ln1"],
                                      np.asarray(jp["layers"]["ln1"]))
    jst = jserve.decode_state_init(jget("hymba_1_5b").reduced(), 2, 16,
                                   jnp.float32)
    st = convert.decode_state_from_numpy(jst, dtype=torch.bfloat16,
                                         device="cpu")
    assert st.view_k.dtype == torch.bfloat16
    assert st.ssm_conv.dtype == torch.bfloat16
    assert st.ssm_state.dtype == torch.float32
    assert st.ctx_len.dtype == torch.int32
