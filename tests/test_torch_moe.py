"""Port parity for the MoE layer: ``repro_torch.models.moe`` against
``repro.models.moe`` on the same parameters (the JAX package's
``moe_init`` carried across with ``convert.params_from_numpy``) and the same
seeded input, in float32 on the CPU at ``.reduced()`` widths: qwen2_moe
(shared experts) and arctic (the dense residual, in the model's ``_ffn``),
at the reduced configs' ample capacity and at capacity factor 1.0, where the
reference drops pairs.  Tolerance 1e-5 (rtol = atol): the expert products
sum in other orders."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.models import model as JM
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.configs import get
from repro_torch.models import model as M
from repro_torch.models import moe

B, S = 2, 64
TOL = dict(rtol=1e-5, atol=1e-5)


def configs(arch, **changes):
    cfg_j = dataclasses.replace(jget(arch).reduced(), **changes)
    cfg_t = dataclasses.replace(get(arch).reduced(), **changes)
    return cfg_j, cfg_t


def setup(arch, seed=0, **changes):
    cfg_j, cfg_t = configs(arch, **changes)
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), cfg_j, jnp.float32)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg_j.d_model)).astype(np.float32)
    return cfg_j, cfg_t, jp, tp, x


def dropped_pairs(cfg, top_i, capacity):
    """Pairs past their expert's capacity, per batch row, summed."""
    counts = np.stack([np.bincount(r.ravel(), minlength=cfg.num_experts)
                       for r in np.asarray(top_i)])
    return int(np.maximum(counts - capacity, 0).sum())


@pytest.mark.parametrize("arch,capacity_factor", [
    ("qwen2_moe_a2_7b", None), ("arctic_480b", None),
    ("qwen2_moe_a2_7b", 1.0), ("arctic_480b", 1.0)])
def test_moe_apply_matches_jax(arch, capacity_factor):
    changes = {} if capacity_factor is None else dict(
        capacity_factor=capacity_factor)
    cfg_j, cfg_t, jp, tp, x = setup(arch, **changes)
    want, want_aux = jmoe.moe_apply(jp, jnp.asarray(x), cfg_j)
    got, aux = moe.moe_apply(tp, torch.from_numpy(x), cfg_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), **TOL)
    assert ("shared" in tp) == (arch == "qwen2_moe_a2_7b")
    # the reference's own routing: capacity factor 1.0 drops pairs (so the
    # sort, the ranks and the capacity are held), the reduced configs' 8.0
    # none
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x), jp["router"])
    _, top_i = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg_j.top_k)
    drops = dropped_pairs(cfg_j, top_i, jmoe.moe_capacity(cfg_j, S))
    assert (drops > 0) == (capacity_factor == 1.0), drops


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "arctic_480b"])
def test_route_matches_jax(arch):
    cfg_j, cfg_t, jp, tp, x = setup(arch, seed=1)
    probs, top_w, top_i = moe.route(tp, torch.from_numpy(x), cfg_t)
    jprobs = jax.nn.softmax(
        jnp.einsum("bsd,de->bse", jnp.asarray(x), jp["router"]), axis=-1)
    jw, ji = jax.lax.top_k(jprobs, cfg_j.top_k)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), **TOL)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(
        top_w.numpy(), np.asarray(jw / jw.sum(-1, keepdims=True)), **TOL)
    np.testing.assert_allclose(top_w.sum(-1).numpy(), 1.0, **TOL)


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "arctic_480b"])
def test_ffn_with_dense_residual_matches_jax(arch):
    """The model's ``_ffn`` (MoE, plus arctic's parallel dense MLP) and its
    aux loss, on one layer of the JAX ``init_params``."""
    cfg_j, cfg_t = configs(arch)
    jp = JM.init_params(cfg_j, jax.random.PRNGKey(4), jnp.float32)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    jl = jax.tree.map(lambda a: a[1], jp["layers"])
    tl = M._layer(tp["layers"], 1)
    assert ("mlp" in tl) == (arch == "arctic_480b")
    h = np.random.default_rng(4).standard_normal(
        (B, S, cfg_j.d_model)).astype(np.float32)
    want, want_aux = JM._ffn(jl, jnp.asarray(h), cfg_j)
    got, aux = M._ffn(tl, torch.from_numpy(h), cfg_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), **TOL)


@pytest.mark.parametrize("tokens", [1, 7, 64, 2048, 2080])
def test_capacity_matches_jax(tokens):
    for arch in ("qwen2_moe_a2_7b", "arctic_480b"):
        for cf in (None, 1.0, 1.25, 15.0):
            changes = {} if cf is None else dict(capacity_factor=cf)
            cfg_j = dataclasses.replace(jget(arch), **changes)
            cfg_t = dataclasses.replace(get(arch), **changes)
            assert moe.moe_capacity(cfg_t, tokens) == \
                jmoe.moe_capacity(cfg_j, tokens)


def test_init_shapes_and_dtypes():
    cfg = get("qwen2_moe_a2_7b").reduced()
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                     "cpu")
    E, d, ff = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    assert p["router"].shape == (d, E) and p["router"].dtype == torch.float32
    assert p["wi"].shape == (E, d, 2 * ff) and p["wi"].dtype == torch.bfloat16
    assert p["wo"].shape == (E, ff, d) and p["wo"].dtype == torch.bfloat16
    assert p["shared"]["wi"].shape == (d, 2 * cfg.shared_d_ff)
    # the stacked parameters keep the router in float32
    params = M.init_params(cfg, 0, torch.bfloat16, device="cpu")
    assert params["layers"]["moe"]["router"].dtype == torch.float32
    assert params["layers"]["moe"]["wi"].dtype == torch.bfloat16
