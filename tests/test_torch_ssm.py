"""Port parity for the SSD mixer: ``repro_torch.models.ssm`` against
``repro.models.ssm`` on the same parameters (the JAX package's ``ssm_init``
carried across with ``convert.params_from_numpy``) and seeded inputs, in
float32 on the CPU at ``.reduced()`` widths (mamba2 and hymba): the chunked
SSD at a sequence that is not a multiple of the chunk, the full-sequence
pass and its decode cache, and several decode steps.  Tolerance 1e-5 (rtol
= atol): the products sum in other orders."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.configs import get
from repro_torch.models import ssm

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["mamba2_370m", "hymba_1_5b"]


def close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def setup(arch, seed=0):
    cfg_j, cfg_t = jget(arch).reduced(), get(arch).reduced()
    jp = jssm.ssm_init(jax.random.PRNGKey(seed), cfg_j, jnp.float32)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return cfg_j, cfg_t, jp, tp


@pytest.mark.parametrize("s,chunk", [(50, 16), (16, 16), (3, 8), (37, 64)])
def test_ssd_chunked_matches_jax(s, chunk):
    rng = np.random.default_rng(s)
    b, h, p, n = 2, 4, 8, 16
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((b, s, n)).astype(np.float32)
              for _ in range(2))
    D = rng.standard_normal(h).astype(np.float32)
    args = (x, dt, A, Bm, Cm, D)
    want_y, want_state = jssm.ssd_chunked(*map(jnp.asarray, args), chunk)
    y, state = ssm.ssd_chunked(*map(torch.from_numpy, args), chunk)
    assert y.shape == (b, s, h, p) and state.dtype == torch.float32
    close(y, want_y)
    close(state, want_state)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [40, 2])
def test_ssm_apply_matches_jax(arch, S):
    """The output and the decode cache: the last d_conv-1 pre-conv inputs
    (zero-padded when S is shorter) and the final state."""
    cfg_j, cfg_t, jp, tp = setup(arch)
    x = np.random.default_rng(1).standard_normal(
        (2, S, cfg_j.d_model)).astype(np.float32)
    want, wcache = jssm.ssm_apply(jp, jnp.asarray(x), cfg_j)
    got, cache = ssm.ssm_apply(tp, torch.from_numpy(x), cfg_t)
    close(got, want)
    close(cache.conv, wcache.conv)
    close(cache.state, wcache.state)
    assert cache.conv.shape == (2, cfg_t.ssm_conv - 1,
                                cfg_t.ssm_d_inner + 2 * cfg_t.ssm_state)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_decode_steps_match_jax(arch):
    """Five decode steps from the full pass's cache, the output and both
    cache members after each."""
    cfg_j, cfg_t, jp, tp = setup(arch, seed=2)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 24, cfg_j.d_model)).astype(np.float32)
    _, jc = jssm.ssm_apply(jp, jnp.asarray(x), cfg_j)
    _, tc = ssm.ssm_apply(tp, torch.from_numpy(x), cfg_t)
    for _ in range(5):
        xt = rng.standard_normal((3, cfg_j.d_model)).astype(np.float32)
        want, jc = jssm.ssm_decode(jp, jnp.asarray(xt), jc, cfg_j)
        got, tc = ssm.ssm_decode(tp, torch.from_numpy(xt), tc, cfg_t)
        close(got, want)
        close(tc.conv, jc.conv)
        close(tc.state, jc.state)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continues_the_full_pass(arch):
    """On the port alone: the full pass over S tokens then k decode steps
    give the full pass's outputs at the last k positions (2e-4: the chunked
    sums against the recurrence)."""
    _, cfg, _, tp = setup(arch, seed=3)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 37, cfg.d_model)).astype(np.float32))
    want, wcache = ssm.ssm_apply(tp, x, cfg)
    _, cache = ssm.ssm_apply(tp, x[:, :33], cfg)
    for t in range(33, 37):
        got, cache = ssm.ssm_decode(tp, x[:, t], cache, cfg)
        torch.testing.assert_close(got, want[:, t], rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(cache.state, wcache.state, rtol=2e-4,
                               atol=2e-4)
    torch.testing.assert_close(cache.conv, wcache.conv)


def test_init_and_cache_dtypes():
    cfg = get("hymba_1_5b").reduced()
    p = ssm.ssm_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                     "cpu")
    for name in ("A_log", "D", "dt_bias"):
        assert p[name].dtype == torch.float32, name
    for name in ("in_proj", "out_proj", "conv_w", "conv_b", "norm"):
        assert p[name].dtype == torch.bfloat16, name
    jp = jssm.ssm_init(jax.random.PRNGKey(0), jget("hymba_1_5b").reduced(),
                       jnp.bfloat16)
    for name, a in jp.items():
        assert p[name].shape == a.shape, name
    # linspace and log may differ from XLA's by an ulp
    np.testing.assert_allclose(p["A_log"].numpy(), np.asarray(jp["A_log"]),
                               rtol=1e-6)
    c = ssm.ssm_cache_init(cfg, 3, torch.bfloat16, "cpu")
    jc = jssm.ssm_cache_init(jget("hymba_1_5b").reduced(), 3, jnp.bfloat16)
    assert c.conv.shape == jc.conv.shape and c.conv.dtype == torch.bfloat16
    assert c.state.shape == jc.state.shape and c.state.dtype == torch.float32


def test_ssd_chunked_grads_match_jax():
    """Differentiable SSD: the gradients of (y, final state) with respect to
    x, dt, A, B, C and D against ``jax.vjp`` of the reference's, off the
    chunk (rtol = atol 1e-4: the chunk products' backward sums in other
    orders); and under ``torch.no_grad()`` the in-place products give the
    same y and state bit for bit."""
    rng = np.random.default_rng(11)
    b, s, h, p, n, chunk = 2, 37, 4, 8, 16, 16
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((b, s, n)).astype(np.float32)
              for _ in range(2))
    D = rng.standard_normal(h).astype(np.float32)
    args = (x, dt, A, Bm, Cm, D)
    cy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    cst = rng.standard_normal((b, h, p, n)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jssm.ssd_chunked(*a, chunk),
                     *map(jnp.asarray, args))
    want = vjp((jnp.asarray(cy), jnp.asarray(cst)))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    y, state = ssm.ssd_chunked(*targs, chunk)
    got = torch.autograd.grad((y, state), targs,
                              (torch.from_numpy(cy), torch.from_numpy(cst)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    with torch.no_grad():
        y0, state0 = ssm.ssd_chunked(*map(torch.from_numpy, args), chunk)
    assert torch.equal(y0, y.detach()) and torch.equal(state0, state.detach())


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_families_train_backward(arch):
    """A backward pass through the reduced model's ``forward_hidden`` (and
    ``train_forward``) of the SSM families, with and without remat: the
    SSD's products write out of place under autograd, so nothing it needs
    for its gradient is overwritten; every gradient finite and the SSM's
    parameters' nonzero."""
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import tree_leaves, tree_unflatten
    cfg = get(arch).reduced()
    params = M.init_params(cfg, 0, torch.float32, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 41)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for remat in (True, False):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        tree = tree_unflatten(params, leaves)
        loss = M.train_forward(tree, cfg, batch, remat=remat)
        grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
        assert all(bool(g.isfinite().all()) for g in tree_leaves(grads))
        for name in ("in_proj", "A_log", "dt_bias", "D"):
            assert float(grads["layers"]["ssm"][name].abs().sum()) > 0, name
