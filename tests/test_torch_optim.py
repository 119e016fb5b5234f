"""The port's optimizer, schedules and gradient compression
(``repro_torch.optim``): the twins of tests/test_optim.py, each step of
``adamw_update`` against the reference's on the same arrays (float32,
1e-6 relative: the same arithmetic, pow and the norm's sum in other
orders), the slice-by-slice in-place update bit for bit equal to a
whole-leaf update, and the schedules and int8 blocks against the
reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.adamw import adamw_init as j_adamw_init
from repro.optim.adamw import adamw_update as j_adamw_update
from repro.optim.compression import compress_int8 as j_compress
from repro.optim.schedule import cosine_schedule as j_cosine
from repro.optim.schedule import wsd_schedule as j_wsd
from repro_torch import convert
from repro_torch.optim import adamw as A
from repro_torch.optim.adamw import adamw_init, adamw_update, global_norm
from repro_torch.optim.compression import compress_int8, decompress_int8
from repro_torch.optim.schedule import cosine_schedule, wsd_schedule


def test_adamw_converges_on_quadratic():
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    opt = adamw_init(params)
    target = torch.tensor([1.0, 2.0, -1.0])
    for _ in range(300):
        grads = {"w": 2 * (params["w"] - target)}
        params, opt, _ = adamw_update(grads, opt, params,
                                      lr=torch.tensor(0.05),
                                      weight_decay=0.0)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=1e-2)


def test_factored_second_moment_shapes():
    params = {"big": torch.zeros((256, 512)), "small": torch.zeros((64,)),
              "stack": torch.zeros((3, 128, 256))}
    opt = adamw_init(params, factored=True)
    assert isinstance(opt.v["big"], dict)
    assert opt.v["big"]["vr"].shape == (256,)
    assert opt.v["big"]["vc"].shape == (512,)
    assert opt.v["small"].shape == (64,)  # too small to factor
    assert opt.v["stack"]["vr"].shape == (3, 128)
    assert opt.v["stack"]["vc"].shape == (3, 256)
    assert opt.step.dtype == torch.int32 and int(opt.step) == 0


def test_factored_still_converges():
    params = {"w": torch.full((128, 128), 3.0)}
    opt = adamw_init(params, factored=True)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, opt, _ = adamw_update(grads, opt, params,
                                      lr=torch.tensor(0.05),
                                      weight_decay=0.0, factored=True)
    assert float(params["w"].abs().max()) < 0.15


def test_grad_clipping():
    params = {"w": torch.zeros((4,))}
    opt = adamw_init(params)
    grads = {"w": torch.full((4,), 100.0)}
    _, _, metrics = adamw_update(grads, opt, params, lr=torch.tensor(0.1),
                                 clip_norm=1.0)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)
    assert float(metrics["clip_scale"]) == pytest.approx(1 / 200.0,
                                                         rel=1e-4)
    _, _, metrics = adamw_update(grads, opt, params, lr=torch.tensor(0.1),
                                 clip_norm=None)
    assert float(metrics["clip_scale"]) == 1.0


def test_global_norm():
    tree = {"a": torch.tensor([3.0]), "b": {"c": torch.tensor([4.0])}}
    assert float(global_norm(tree)) == pytest.approx(5.0)


def test_wsd_schedule_shape():
    lr = [float(wsd_schedule(s, peak_lr=1.0, warmup_steps=10,
                             total_steps=100)) for s in range(101)]
    assert lr[0] == 0.0
    assert lr[10] == pytest.approx(1.0)
    assert lr[50] == pytest.approx(1.0)     # plateau
    assert lr[100] == pytest.approx(0.1)    # floor
    assert all(a >= b - 1e-6 for a, b in zip(lr[10:], lr[11:]))


def test_cosine_schedule_monotone_decay():
    lr = [float(cosine_schedule(s, peak_lr=1.0, warmup_steps=5,
                                total_steps=50)) for s in range(51)]
    assert lr[5] == pytest.approx(1.0)
    assert lr[50] == pytest.approx(0.1, rel=1e-3)


@pytest.mark.parametrize("fns,kw", [
    ((wsd_schedule, j_wsd), dict(peak_lr=3e-4, warmup_steps=2,
                                 total_steps=8)),
    ((wsd_schedule, j_wsd), dict(peak_lr=1.0, warmup_steps=20,
                                 total_steps=300, decay_frac=0.3)),
    ((cosine_schedule, j_cosine), dict(peak_lr=1e-3, warmup_steps=5,
                                       total_steps=50))])
def test_schedules_match_jax(fns, kw):
    """Every step, and a step given as an int32 tensor (the optimizer's
    counter), as the reference computes it in float32."""
    t_fn, j_fn = fns
    steps = np.arange(kw["total_steps"] + 3, dtype=np.int32)
    got = t_fn(torch.from_numpy(steps), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(j_fn(steps, **kw)),
                               rtol=1e-6, atol=0)


def tree_np(rng, shapes):
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"stack": (3, 128, 160), "embed": (400, 128), "norm": (3, 40),
          "bias": (7,)}


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("clip_norm", [None, 1.0, 1e3])
def test_adamw_update_matches_jax(factored, clip_norm):
    """Three updates of the same parameters with the same gradients and
    state as the reference's ``adamw_update``: the parameters, both
    moments (the factored statistics too) and the metrics."""
    rng = np.random.default_rng(0)
    params = tree_np(rng, SHAPES)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jo = j_adamw_init(jp, factored=factored)
    to = convert.opt_state_from_numpy(jax.tree.map(np.asarray, jo),
                                      device="cpu")
    for i in range(3):
        grads = tree_np(rng, SHAPES)
        lr = np.float32(1e-2 * (i + 1))
        jp, jo, jm = j_adamw_update({k: jnp.asarray(v) for k, v in
                                     grads.items()}, jo, jp, lr=lr,
                                    clip_norm=clip_norm, factored=factored)
        tp, to, tm = adamw_update({k: torch.from_numpy(v) for k, v in
                                   grads.items()}, to, tp,
                                  lr=torch.tensor(lr), clip_norm=clip_norm,
                                  factored=factored)
        for name in ("grad_norm", "clip_scale"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-6)
    want = convert.opt_state_to_numpy(to)
    assert int(want.step) == int(jo.step) == 3
    got_flat = {"p": tp, "m": to.m, "v": to.v}
    want_flat = jax.tree.map(np.asarray, {"p": jp, "m": jo.m, "v": jo.v})
    jleaves, jdef = jax.tree.flatten(want_flat)
    tleaves = jdef.flatten_up_to(jax.tree.map(
        lambda t: t, got_flat, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    for t, j in zip(tleaves, jleaves):
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, atol=1e-7)


def whole_leaf_update(p, g, m, v, *, lr, step, b1=0.9, b2=0.95, eps=1e-8,
                      weight_decay=0.1, scale=1.0):
    """The reference's per-leaf arithmetic on a whole leaf, out of place
    (the form the in-place slices replace)."""
    t = torch.tensor(float(step))
    bc1, bc2 = 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)
    g = g.float() * scale
    m = b1 * m + (1 - b1) * g
    if isinstance(v, dict):
        g2 = g.square() + 1e-30
        vr = b2 * v["vr"] + (1 - b2) * g2.mean(dim=-1)
        vc = b2 * v["vc"] + (1 - b2) * g2.mean(dim=-2)
        denom = vr.mean(dim=-1, keepdim=True).clamp_min(1e-30)
        vhat = (vr[..., None] * vc[..., None, :] / denom[..., None]) / bc2
        v = {"vr": vr, "vc": vc}
    else:
        v = b2 * v + (1 - b2) * g.square()
        vhat = v / bc2
    update = (m / bc1) / (vhat.sqrt() + eps)
    p32 = p.float()
    return (p32 - lr * (update + weight_decay * p32)).to(p.dtype), m, v


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sliced_update_equals_whole_leaf(monkeypatch, factored, dtype):
    """``adamw_update`` cut into slices of at most 2 x 128 x 160 elements
    (the stack a layer at a time, the embedding in pieces of rows, except
    a factored 2-D leaf, whole) writes bit for bit what a whole-leaf,
    out-of-place update gives, for parameters, ``m`` and ``v``."""
    monkeypatch.setattr(A, "SLICE_ELEMS", 2 * 128 * 160)
    rng = np.random.default_rng(1)
    params = {k: torch.from_numpy(v).to(dtype)
              for k, v in tree_np(rng, SHAPES).items()}
    opt = adamw_init(params, factored=factored)
    assert list(A._slices(params["stack"])) == [slice(0, 2), slice(2, 4)]
    assert len(list(A._slices(params["embed"]))) == 2
    for step in (1, 2):
        grads = {k: torch.from_numpy(v).to(dtype)
                 for k, v in tree_np(rng, SHAPES).items()}
        want = {k: whole_leaf_update(
            params[k], grads[k], opt.m[k],
            {n: x.clone() for n, x in opt.v[k].items()}
            if isinstance(opt.v[k], dict) else opt.v[k],
            lr=torch.tensor(0.01), step=step) for k in params}
        params, opt, metrics = adamw_update(grads, opt, params,
                                            lr=torch.tensor(0.01),
                                            clip_norm=None)
        for k, (p, m, v) in want.items():
            assert torch.equal(params[k], p), k
            assert torch.equal(opt.m[k], m), k
            if isinstance(v, dict):
                assert torch.equal(opt.v[k]["vr"], v["vr"]), k
                assert torch.equal(opt.v[k]["vc"], v["vc"]), k
            else:
                assert torch.equal(opt.v[k], v), k


class TestCompression:
    def test_roundtrip_error_bounded(self, rng):
        g = torch.from_numpy(rng.normal(size=(1000,)).astype(np.float32))
        q, scale, err = compress_int8(g)
        deq = decompress_int8(q, scale, g.shape, torch.float32)
        # per-block max/127 quantization error bound
        assert float((deq - g).abs().max()) <= \
            float(g.abs().max()) / 127.0 + 1e-6
        np.testing.assert_allclose((g - deq).numpy(), err.numpy(),
                                   atol=1e-6)

    @pytest.mark.parametrize("n,seed", [(1, 0), (255, 1), (256, 2),
                                        (1000, 3), (2000, 4)])
    def test_error_feedback_drives_bias_to_zero(self, n, seed):
        """With error feedback the accumulated transmitted signal tracks
        the accumulated true gradient (the bias does not grow)."""
        rng = np.random.default_rng(seed)
        g_true = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32))
        err = None
        sent_total = torch.zeros_like(g_true)
        for _ in range(8):
            q, scale, err = compress_int8(g_true, err)
            sent_total = sent_total + decompress_int8(
                q, scale, g_true.shape, torch.float32)
        resid = (sent_total + err - 8 * g_true).abs()
        assert float(resid.max()) < 1e-4

    def test_all_zero_gradient(self):
        g = torch.zeros((100,))
        q, scale, err = compress_int8(g)
        assert float(decompress_int8(q, scale, g.shape,
                                     torch.float32).abs().max()) == 0.0
        assert float(err.abs().max()) == 0.0

    @pytest.mark.parametrize("shape", [(1000,), (3, 300), (256,)])
    def test_matches_jax(self, shape):
        """The int8 blocks, scales and residual of the reference's, with an
        error fed back (bfloat16 gradients too)."""
        rng = np.random.default_rng(5)
        g = rng.normal(size=shape).astype(np.float32)
        e = (rng.normal(size=shape) * 0.01).astype(np.float32)
        jq, js, je = j_compress(jnp.asarray(g), jnp.asarray(e))
        q, s, err = compress_int8(torch.from_numpy(g), torch.from_numpy(e))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(err.numpy(), np.asarray(je))
        gb = torch.from_numpy(g).to(torch.bfloat16)
        jq, js, _ = j_compress(jnp.asarray(gb.float().numpy()).astype(
            jnp.bfloat16))
        q, s, _ = compress_int8(gb)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
