"""Port parity for the serving runtime: ``repro_torch.runtime.serve``'s
prefill, shortcut and paged serve steps against ``repro.runtime.serve`` on
the same parameters and tokens (``tests/test_serve_runtime.py``'s setup), in
float32 on the CPU.  The greedy tokens must be equal, token for token, on
both routes, to the JAX package's and to the no-cache ground truth; the
views and the SSM states within 1e-5.  qwen2_moe serves on both routes,
mamba2 and hymba (SSM state) on the shortcut route; the paged route refuses
an SSM.  PaliGemma's prefix model serves on both routes with its seeded
patch embeddings in front of the prompt (a context of prefix + prompt).  The per-shard decode states are held to the port's own whole-batch
step, since the reference's sharded test fails (ROADMAP section 3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.kvcache import paged_cache as jpc
from repro.models import model as JM
from repro.runtime import serve as jserve
from repro_torch import convert
from repro_torch.configs import get
from repro_torch.kvcache import paged_cache as pc
from repro_torch.models import model as M
from repro_torch.runtime import serve

B, S, S_CAP, STEPS, BS = 2, 32, 64, 4, 8


@pytest.fixture(scope="module", params=["qwen3_4b", "gemma2_27b",
                                        "qwen2_moe_a2_7b"])
def setup(request):
    arch = request.param
    cfg_j, cfg_t = jget(arch).reduced(), get(arch).reduced()
    jp = JM.init_params(cfg_j, jax.random.PRNGKey(0), jnp.float32)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0,
                                         cfg_j.vocab_size), np.int32)
    return cfg_j, cfg_t, jp, tp, toks


def ground_truth(cfg, params, toks, steps, prefix=None):
    """Greedy decode by re-running the port's full forward (no cache)."""
    cur, out = torch.tensor(toks).long(), []
    extra = {} if prefix is None else {
        "prefix_embeddings": torch.from_numpy(prefix)}
    for _ in range(steps):
        logits, _ = M.prefill_forward(params, cfg, {"tokens": cur, **extra})
        nxt = torch.argmax(logits, dim=-1)
        out.append(nxt)
        cur = torch.cat([cur, nxt[:, None]], dim=1)
    return torch.stack(out, dim=1).numpy()


def jax_shortcut(cfg, jp, toks, steps=STEPS, prefix=None):
    prefill = jserve.make_prefill_step(cfg, s_cap=S_CAP, dtype=jnp.float32)
    step = jax.jit(jserve.make_serve_step(cfg))
    extra = {} if prefix is None else {
        "prefix_embeddings": jnp.asarray(prefix)}
    logits, state = prefill(jp, {"tokens": jnp.asarray(toks), **extra})
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    got = [tok]
    for _ in range(steps - 1):
        tok, state = step(jp, state, tok)
        got.append(tok)
    return np.asarray(jnp.stack(got, axis=1)), state


def port_shortcut(cfg, tp, toks, steps=STEPS, prefix=None):
    prefill = serve.make_prefill_step(cfg, S_CAP, torch.float32)
    step = serve.make_serve_step(cfg)
    extra = {} if prefix is None else {
        "prefix_embeddings": torch.from_numpy(prefix)}
    logits, state = prefill(tp, {"tokens": torch.tensor(toks), **extra})
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    got = [tok]
    for _ in range(steps - 1):
        tok, state = step(tp, state, tok)
        got.append(tok)
    return torch.stack(got, dim=1).numpy(), state


def test_shortcut_serve_matches_jax_and_ground_truth(setup):
    cfg_j, cfg_t, jp, tp, toks = setup
    want, jstate = jax_shortcut(cfg_j, jp, toks)
    got, state = port_shortcut(cfg_t, tp, toks)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ground_truth(cfg_t, tp, toks, STEPS))
    tst = convert.decode_state_to_numpy(state)
    np.testing.assert_array_equal(tst.ctx_len, np.asarray(jstate.ctx_len))
    for got, want in ((tst.view_k, jstate.view_k),
                      (tst.view_v, jstate.view_v)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_paged_serve_matches_jax_and_ground_truth(setup):
    cfg_j, cfg_t, jp, tp, toks = setup
    dims = dict(num_blocks=32, block_size=BS, kv_heads=cfg_j.num_kv_heads,
                head_dim=cfg_j.resolved_head_dim, max_seqs=B,
                max_blocks_per_seq=S_CAP // BS)
    jcache = jpc.cache_create(cfg_j.num_layers, dtype=jnp.float32, **dims)
    jlog, jc = JM.prefill_forward(jp, cfg_j, {"tokens": jnp.asarray(toks)})
    jcache = jpc.write_prefill(jcache, jnp.arange(B), jc.k, jc.v)
    jstep = jax.jit(jserve.make_paged_serve_step(cfg_j))
    cache = pc.cache_create(cfg_t.num_layers, dtype=torch.float32,
                            device="cpu", **dims)
    logits, c = M.prefill_forward(tp, cfg_t, {"tokens": torch.tensor(toks)})
    cache = pc.write_prefill(cache, torch.arange(B), c.k, c.v)
    step = serve.make_paged_serve_step(cfg_t)
    jtok = jnp.argmax(jlog, axis=-1).astype(jnp.int32)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    want, got = [np.asarray(jtok)], [tok.numpy()]
    ids = torch.arange(B, dtype=torch.int32)
    for _ in range(STEPS - 1):
        jtok, jcache = jstep(jp, jcache, jtok, jnp.arange(B, dtype=jnp.int32))
        tok, cache = step(tp, cache, tok, ids)
        want.append(np.asarray(jtok))
        got.append(tok.numpy())
    got = np.stack(got, axis=1)
    np.testing.assert_array_equal(got, np.stack(want, axis=1))
    np.testing.assert_array_equal(got, ground_truth(cfg_t, tp, toks, STEPS))
    got_cache = convert.paged_cache_to_numpy(cache)
    np.testing.assert_array_equal(got_cache.block_tables,
                                  np.asarray(jcache.block_tables))
    np.testing.assert_allclose(got_cache.k_pool, np.asarray(jcache.k_pool),
                               rtol=1e-5, atol=1e-5)


def _marked_state(cfg, batch):
    st = serve.decode_state_init(cfg, batch, 16, torch.float32, device="cpu")
    rows = torch.arange(batch, dtype=torch.float32)[None, :, None, None, None]
    return st._replace(view_k=st.view_k + rows, view_v=st.view_v - rows,
                       ctx_len=torch.arange(batch, dtype=torch.int32) * 3)


@pytest.mark.parametrize("num_shards", [1, 2, 3])
def test_shard_merge_decode_state_roundtrip(num_shards):
    cfg = get("qwen3_4b").reduced()
    st = _marked_state(cfg, 5)
    parts = serve.shard_decode_state(st, num_shards)
    assert len(parts) == num_shards
    for s, p in enumerate(parts):
        assert p.ctx_len.tolist() == st.ctx_len[s::num_shards].tolist()
        assert p.view_k.shape[1] == len(range(s, 5, num_shards))
        assert p.ssm_conv == () and p.ssm_state == ()
    merged = serve.merge_decode_states(parts)
    for got, want in zip(merged, st):
        if isinstance(want, tuple):
            assert got == ()
        else:
            assert torch.equal(got, want)


@pytest.mark.parametrize("num_shards", [1, 2])
def test_sharded_decode_matches_whole_batch(setup, num_shards):
    """N per-shard decode loops, each stepping its own rows, give the
    port's whole-batch tokens, and its state within 1e-5 (a smaller batch
    sums its products in another order: about 2e-6 here)."""
    _, cfg, _, tp, toks = setup
    prefill = serve.make_prefill_step(cfg, S_CAP, torch.float32)
    step = serve.make_serve_step(cfg)
    logits, whole = prefill(tp, {"tokens": torch.tensor(toks)})
    tok0 = torch.argmax(logits, dim=-1).to(torch.int32)
    whole_toks, wtok = [], tok0
    for _ in range(3):
        wtok, whole = step(tp, whole, wtok)
        whole_toks.append(wtok)

    _, state = prefill(tp, {"tokens": torch.tensor(toks)})
    parts = serve.shard_decode_state(state, num_shards)
    shard_toks = []
    for s in range(num_shards):
        t, st = tok0[s::num_shards], parts[s]
        got = []
        for _ in range(3):
            t, st = step(tp, st, t)
            got.append(t)
        parts[s] = st
        shard_toks.append(got)
    for i, want in enumerate(whole_toks):
        merged = torch.empty_like(want)
        for s in range(num_shards):
            merged[s::num_shards] = shard_toks[s][i]
        assert torch.equal(merged, want)
    merged = serve.merge_decode_states(parts)
    assert torch.equal(merged.ctx_len, whole.ctx_len)
    torch.testing.assert_close(merged.view_k, whole.view_k, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(merged.view_v, whole.view_v, rtol=1e-5,
                               atol=1e-5)


def test_decode_state_numpy_roundtrip():
    cfg = jget("qwen3_4b").reduced()
    jst = jserve.decode_state_init(cfg, batch=3, s_cap=16, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    jst = jst._replace(
        view_k=jnp.asarray(rng.standard_normal(jst.view_k.shape), jnp.float32),
        view_v=jnp.asarray(rng.standard_normal(jst.view_v.shape),
                           jnp.bfloat16),
        ctx_len=jnp.asarray([3, 0, 16], jnp.int32))
    st = convert.decode_state_from_numpy(jst, device="cpu")
    assert st.view_k.dtype == torch.float32
    assert st.view_v.dtype == torch.bfloat16
    assert st.ctx_len.dtype == torch.int32 and st.ssm_conv == ()
    back = convert.decode_state_to_numpy(st)
    for got, want in zip(back, jst):
        if isinstance(want, tuple):
            assert got == ()
        else:
            np.testing.assert_array_equal(got, np.asarray(want, got.dtype))


def test_full_view_row_is_dropped_like_jax(setup):
    """A step on a view whose second row is full (S_cap 4, ``ctx_len`` [3,
    4]): the reference's ``put_along_axis`` drops that row's write and
    writes the other; ``ctx_len`` advances for both.  The port's step gives
    the same tokens, view and ``ctx_len``."""
    cfg_j, cfg_t, jp, tp, toks = setup
    rng = np.random.default_rng(11)
    shape = (cfg_j.num_layers, B, cfg_j.num_kv_heads, 4,
             cfg_j.resolved_head_dim)
    vk, vv = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    ctx = np.array([3, 4], np.int32)
    tok = toks[:, 0].copy()
    jstate = jserve.DecodeState(view_k=jnp.asarray(vk),
                                view_v=jnp.asarray(vv), ssm_conv=(),
                                ssm_state=(), ctx_len=jnp.asarray(ctx))
    jtok, jstate = jax.jit(jserve.make_serve_step(cfg_j))(
        jp, jstate, jnp.asarray(tok))
    state = serve.DecodeState(
        view_k=torch.from_numpy(vk.copy()), view_v=torch.from_numpy(vv.copy()),
        ssm_conv=(), ssm_state=(), ctx_len=torch.from_numpy(ctx))
    got, state = serve.make_serve_step(cfg_t)(tp, state, torch.from_numpy(tok))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(state.ctx_len.numpy(), [4, 5])
    np.testing.assert_array_equal(state.ctx_len.numpy(),
                                  np.asarray(jstate.ctx_len))
    for got_v, want_v, old in ((state.view_k, jstate.view_k, vk),
                               (state.view_v, jstate.view_v, vv)):
        np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got_v[:, 1].numpy(), old[:, 1])


SSM_ARCHS = ["mamba2_370m", "hymba_1_5b"]


def ssm_setup(arch):
    """``tests/test_serve_runtime.py::test_stateful_families_serve``'s
    parameters and tokens, in both packages."""
    cfg_j, cfg_t = jget(arch).reduced(), get(arch).reduced()
    jp = JM.init_params(cfg_j, jax.random.PRNGKey(2), jnp.float32)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (B, S), 0,
                                         cfg_j.vocab_size), np.int32)
    return cfg_j, cfg_t, jp, tp, toks


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_families_serve_match_jax_and_ground_truth(arch):
    """The twin of the reference's stateful-families serve test: greedy
    tokens equal to the JAX package's and to the no-cache ground truth, and
    the state (SSM conv windows and float32 states; hymba's views) within
    1e-5 of the JAX step's."""
    cfg_j, cfg_t, jp, tp, toks = ssm_setup(arch)
    want, jstate = jax_shortcut(cfg_j, jp, toks, steps=3)
    got, state = port_shortcut(cfg_t, tp, toks, steps=3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ground_truth(cfg_t, tp, toks, 3))
    tst = convert.decode_state_to_numpy(state)
    assert state.ssm_state.dtype == torch.float32
    np.testing.assert_array_equal(tst.ctx_len, np.asarray(jstate.ctx_len))
    for name in ("view_k", "view_v", "ssm_conv", "ssm_state"):
        want_m = getattr(jstate, name)
        if isinstance(want_m, tuple):
            assert getattr(tst, name) == (), name
        else:
            np.testing.assert_allclose(getattr(tst, name),
                                       np.asarray(want_m), rtol=1e-5,
                                       atol=1e-5, err_msg=name)


@pytest.mark.parametrize("arch", SSM_ARCHS + ["qwen2_moe_a2_7b"])
def test_decode_state_init_matches_jax(arch):
    cfg_j, cfg_t = jget(arch).reduced(), get(arch).reduced()
    jst = jserve.decode_state_init(cfg_j, batch=3, s_cap=16,
                                   dtype=jnp.bfloat16)
    st = serve.decode_state_init(cfg_t, 3, 16, torch.bfloat16, device="cpu")
    for got, want in zip(st, jst):
        if isinstance(want, tuple):
            assert got == ()
        else:
            assert tuple(got.shape) == want.shape
            assert (got.dtype == torch.float32) == (want.dtype == jnp.float32)
            assert not got.any()


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_paged_serve_step_refuses_ssm(arch):
    """The reference's paged step passes no SSM state (``ssm=()``), so its
    SSM decode cannot run; the port refuses the model up front."""
    with pytest.raises(NotImplementedError, match="attention-only"):
        serve.make_paged_serve_step(get(arch).reduced())


@pytest.mark.parametrize("num_shards", [1, 2, 3])
def test_shard_merge_decode_state_roundtrip_with_ssm(num_shards):
    """hymba: attention and SSM, so every member of the state is a tensor;
    rows marked by their index."""
    cfg = get("hymba_1_5b").reduced()
    st = serve.decode_state_init(cfg, 5, 16, torch.float32, device="cpu")
    st = serve.DecodeState(*(
        m + torch.arange(5, dtype=m.dtype).reshape(
            (1, 5) + (1,) * (m.dim() - 2)) if m.dim() > 1
        else torch.arange(5, dtype=m.dtype) * 3 for m in st))
    parts = serve.shard_decode_state(st, num_shards)
    for s, p in enumerate(parts):
        rows = list(range(s, 5, num_shards))
        assert p.ssm_state[:, :, 0, 0, 0].tolist() == [rows] * cfg.num_layers
        assert p.ssm_conv.shape[1] == len(rows)
    merged = serve.merge_decode_states(parts)
    for got, want in zip(merged, st):
        assert torch.equal(got, want)


def test_sharded_decode_with_ssm_matches_whole_batch():
    """hymba: two per-shard decode loops, each stepping its own rows in
    place (views and SSM members are strided views of the whole batch),
    give the whole-batch loop's tokens and, merged, its state within
    1e-5."""
    _, cfg, _, tp, toks = ssm_setup("hymba_1_5b")
    prefill = serve.make_prefill_step(cfg, S_CAP, torch.float32)
    step = serve.make_serve_step(cfg)
    logits, whole = prefill(tp, {"tokens": torch.tensor(toks)})
    tok0 = torch.argmax(logits, dim=-1).to(torch.int32)
    wtok, whole_toks = tok0, []
    for _ in range(3):
        wtok, whole = step(tp, whole, wtok)
        whole_toks.append(wtok)
    _, state = prefill(tp, {"tokens": torch.tensor(toks)})
    parts = serve.shard_decode_state(state, 2)
    for s in range(2):
        t, st = tok0[s::2], parts[s]
        for i in range(3):
            t, st = step(tp, st, t)
            assert torch.equal(t, whole_toks[i][s::2])
        parts[s] = st
    merged = serve.merge_decode_states(parts)
    assert torch.equal(merged.ctx_len, whole.ctx_len)
    for name in ("view_k", "ssm_conv", "ssm_state"):
        torch.testing.assert_close(getattr(merged, name),
                                   getattr(whole, name), rtol=1e-5,
                                   atol=1e-5)
    # the shards stepped the whole-batch state's tensors in place
    torch.testing.assert_close(state.ssm_state, whole.ssm_state, rtol=1e-5,
                               atol=1e-5)


def test_decode_state_numpy_roundtrip_with_ssm():
    cfg = jget("mamba2_370m").reduced()
    jst = jserve.decode_state_init(cfg, batch=3, s_cap=16,
                                   dtype=jnp.bfloat16)
    rng = np.random.default_rng(1)
    jst = jst._replace(
        ssm_conv=jnp.asarray(rng.standard_normal(jst.ssm_conv.shape),
                             jnp.bfloat16),
        ssm_state=jnp.asarray(rng.standard_normal(jst.ssm_state.shape),
                              jnp.float32),
        ctx_len=jnp.asarray([3, 0, 16], jnp.int32))
    st = convert.decode_state_from_numpy(jst, device="cpu")
    assert st.view_k == () and st.view_v == ()
    assert st.ssm_conv.dtype == torch.bfloat16
    assert st.ssm_state.dtype == torch.float32
    back = convert.decode_state_to_numpy(st)
    for got, want in zip(back, jst):
        if isinstance(want, tuple):
            assert got == ()
        else:
            np.testing.assert_array_equal(got, np.asarray(want, got.dtype))


def prefix_setup():
    """PaliGemma's prefix model (reduced: 8 patch embeddings) in both
    packages, seeded tokens (B, S) and patch embeddings (B, 8, D)."""
    cfg_j, cfg_t, jp, tp, toks = ssm_setup("paligemma_3b")
    prefix = np.random.default_rng(4).standard_normal(
        (B, cfg_j.prefix_len, cfg_j.d_model)).astype(np.float32)
    return cfg_j, cfg_t, jp, tp, toks, prefix


def test_prefix_model_shortcut_serve_matches_jax():
    """Prefill (a context of prefix + prompt, ``ctx_len`` P + S) and the
    shortcut decode: greedy tokens equal to the JAX package's and to the
    no-cache ground truth, the views within 1e-5 of the JAX step's."""
    cfg_j, cfg_t, jp, tp, toks, prefix = prefix_setup()
    want, jstate = jax_shortcut(cfg_j, jp, toks, prefix=prefix)
    got, state = port_shortcut(cfg_t, tp, toks, prefix=prefix)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, ground_truth(cfg_t, tp, toks, STEPS, prefix))
    tst = convert.decode_state_to_numpy(state)
    np.testing.assert_array_equal(tst.ctx_len, np.asarray(jstate.ctx_len))
    assert (tst.ctx_len == cfg_t.prefix_len + S + STEPS - 1).all()
    for got_v, want_v in ((tst.view_k, jstate.view_k),
                          (tst.view_v, jstate.view_v)):
        np.testing.assert_allclose(got_v, np.asarray(want_v), rtol=1e-5,
                                   atol=1e-5)


def test_prefix_model_paged_serve_matches_jax():
    """The paged route of the prefix model: ``write_prefill`` of the P + S
    positions (the same block tables and lengths as the JAX package's),
    then the paged steps' greedy tokens equal to JAX's and to the ground
    truth, the pools within 1e-5."""
    cfg_j, cfg_t, jp, tp, toks, prefix = prefix_setup()
    P = cfg_j.prefix_len
    dims = dict(num_blocks=32, block_size=BS, kv_heads=cfg_j.num_kv_heads,
                head_dim=cfg_j.resolved_head_dim, max_seqs=B,
                max_blocks_per_seq=S_CAP // BS)
    jcache = jpc.cache_create(cfg_j.num_layers, dtype=jnp.float32, **dims)
    jlog, jc = JM.prefill_forward(jp, cfg_j, {
        "tokens": jnp.asarray(toks), "prefix_embeddings": jnp.asarray(prefix)})
    jcache = jpc.write_prefill(jcache, jnp.arange(B), jc.k, jc.v)
    cache = pc.cache_create(cfg_t.num_layers, dtype=torch.float32,
                            device="cpu", **dims)
    logits, c = M.prefill_forward(tp, cfg_t, {
        "tokens": torch.tensor(toks),
        "prefix_embeddings": torch.from_numpy(prefix)})
    cache = pc.write_prefill(cache, torch.arange(B), c.k, c.v)
    assert cache.seq_lens.tolist() == [P + S] * B
    np.testing.assert_array_equal(cache.seq_lens.numpy(),
                                  np.asarray(jcache.seq_lens))
    np.testing.assert_array_equal(cache.block_tables.numpy(),
                                  np.asarray(jcache.block_tables))
    jstep = jax.jit(jserve.make_paged_serve_step(cfg_j))
    step = serve.make_paged_serve_step(cfg_t)
    jtok = jnp.argmax(jlog, axis=-1).astype(jnp.int32)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    want, got = [np.asarray(jtok)], [tok.numpy()]
    ids = torch.arange(B, dtype=torch.int32)
    for _ in range(STEPS - 1):
        jtok, jcache = jstep(jp, jcache, jtok, jnp.arange(B, dtype=jnp.int32))
        tok, cache = step(tp, cache, tok, ids)
        want.append(np.asarray(jtok))
        got.append(tok.numpy())
    got = np.stack(got, axis=1)
    np.testing.assert_array_equal(got, np.stack(want, axis=1))
    np.testing.assert_array_equal(
        got, ground_truth(cfg_t, tp, toks, STEPS, prefix))
    got_cache = convert.paged_cache_to_numpy(cache)
    np.testing.assert_array_equal(got_cache.seq_lens,
                                  np.asarray(jcache.seq_lens))
    np.testing.assert_allclose(got_cache.k_pool, np.asarray(jcache.k_pool),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch,want", [
    ("qwen3_4b", 5), ("musicgen_medium", 5), ("paligemma_3b", 8 + 5)])
def test_prompt_len_counts_the_prefix(arch, want):
    """``make_prefill_step``'s context length: the prompt's tokens or
    embeddings, and a prefix model's ``prefix_len`` in front (the
    reference's ``ctx_len``)."""
    cfg = get(arch).reduced()
    batch = {"tokens": torch.zeros((2, 5), dtype=torch.long),
             "embeddings": torch.zeros((2, 5, cfg.d_model)),
             "prefix_embeddings": torch.zeros((2, cfg.prefix_len,
                                               cfg.d_model))}
    assert serve._prompt_len(cfg, batch) == want
