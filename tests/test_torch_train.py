"""Port parity for the training path: ``repro_torch.models.model.
train_forward`` and its gradients, ``grad_bf16``, the MoE dispatch's three
``autograd.Function``s and ``runtime.train.make_train_step`` against the
JAX package on the same parameters (carried across with
``convert.params_from_numpy``), the same seeded batches and the same
optimizer state, in float32 on the CPU at ``.reduced()`` widths.

Tolerances: the loss within 1e-5 relative; each gradient leaf, and each
parameter and moment after the train steps, within a relative RMS
(||got - want|| / ||want||) of 2^-8, because ``grad_bf16`` rounds the
branch cotangents to bfloat16 and a rounding that flips moves an element by
one bfloat16 step; ``grad_bf16`` itself bit for bit; the MoE backward passes
within 1e-6 (the same gathers, sums in another order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED
from repro.configs import get as jget
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.models.layers import grad_bf16 as j_grad_bf16
from repro.optim.adamw import adamw_init as j_adamw_init
from repro.optim.schedule import wsd_schedule as j_wsd
from repro.runtime.train import make_train_step as j_make_train_step
from repro_torch import convert
from repro_torch.configs import get
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.layers import grad_bf16
from repro_torch.optim.adamw import adamw_init, tree_leaves
from repro_torch.optim.schedule import wsd_schedule
from repro_torch.runtime import train as T

B, S = 2, 64
LOSS_RTOL = 1e-5
REL_RMS = 2.0 ** -8


def rel_rms(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    norm = np.linalg.norm(want)
    diff = np.linalg.norm(got - want)
    return diff / norm if norm else diff


def flat(tree, prefix=""):
    """{path: leaf} of a tree of nested dictionaries."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def batch_np(cfg, seed=0, b=B, s=S):
    """A seeded batch of numpy arrays in the config's input mode."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.input_mode == "embeddings":
        out["embeddings"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32) * 0.02
        out["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
        return out
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out["tokens"], out["labels"] = toks[:, :-1], toks[:, 1:]
    if cfg.input_mode == "prefix_embeddings":
        out["prefix_embeddings"] = rng.standard_normal(
            (b, cfg.prefix_len, cfg.d_model)).astype(np.float32) * 0.02
    return out


def setup(arch, seed=0, cfg_j=None):
    cfg_j = cfg_j or jget(arch).reduced()
    cfg_t = get(arch).reduced()
    cfg_t = dataclasses.replace(cfg_t, **{
        f.name: getattr(cfg_j, f.name) for f in dataclasses.fields(cfg_j)})
    jp = JM.init_params(cfg_j, jax.random.PRNGKey(seed), jnp.float32)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return cfg_j, cfg_t, jp, tp


def t_loss_and_grads(cfg, tp, batch, remat=True):
    leaves = [p.detach().requires_grad_() for p in tree_leaves(tp)]
    tree = T.tree_unflatten(tp, leaves)
    loss = M.train_forward(tree, cfg, {k: torch.from_numpy(v)
                                       for k, v in batch.items()},
                           remat=remat)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return loss.detach(), dict(zip(flat(tp), grads))


@pytest.mark.parametrize("arch", ASSIGNED)
def test_train_forward_and_grads_match_jax(arch):
    """Every assigned architecture's reduced config: the loss of
    ``train_forward`` and every gradient leaf against ``jax.value_and_grad``
    of the reference's (remat on in both); hymba_1_5b and mamba2_370m run
    the SSM's backward."""
    cfg_j, cfg_t, jp, tp = setup(arch)
    batch = batch_np(cfg_j)
    jl, jg = jax.value_and_grad(lambda p: JM.train_forward(
        p, cfg_j, {k: jnp.asarray(v) for k, v in batch.items()}))(jp)
    loss, grads = t_loss_and_grads(cfg_t, tp, batch)
    assert loss.dtype == torch.float32
    assert abs(float(loss) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    jflat = flat(jax.tree.map(np.asarray, jg))
    assert grads.keys() == jflat.keys()
    for name, g in grads.items():
        assert g.shape == jflat[name].shape, name
        assert rel_rms(g.numpy(), jflat[name]) <= REL_RMS, name


@pytest.mark.parametrize("arch", ["qwen3_4b", "qwen2_moe_a2_7b",
                                  "hymba_1_5b"])
def test_remat_on_and_off_bit_equal(arch):
    """The per-layer checkpoint recomputes the same values: loss and every
    gradient equal bit for bit with and without remat."""
    _, cfg, _, tp = setup(arch, seed=1)
    batch = batch_np(cfg, seed=1)
    l1, g1 = t_loss_and_grads(cfg, tp, batch, remat=True)
    l0, g0 = t_loss_and_grads(cfg, tp, batch, remat=False)
    assert torch.equal(l1, l0)
    for name in g1:
        assert torch.equal(g1[name], g0[name]), name


def test_no_grad_train_forward_equals_the_step_loss():
    """``train_forward`` under ``torch.no_grad()`` gives the loss the
    training step reports, bit for bit (chip_smoke.py (l1) checks the same
    on the card at full width)."""
    _, cfg, _, tp = setup("qwen3_4b", seed=2)
    batch = {k: torch.from_numpy(v) for k, v in batch_np(cfg, 2).items()}
    with torch.no_grad():
        want = M.train_forward(tp, cfg, batch)
    loss, _ = T.loss_and_grads(cfg, tp, batch)
    assert torch.equal(loss, want)


@pytest.mark.parametrize("loss_chunk,masked", [(16, False), (32, True),
                                               (48, True)])
def test_chunked_softmax_xent_matches_jax(loss_chunk, masked):
    """The loss over several chunks (48 does not divide 64: one chunk of
    all S, as in the reference), with a loss mask."""
    cfg_j = dataclasses.replace(jget("qwen3_4b").reduced(),
                                loss_chunk=loss_chunk)
    cfg_j, cfg_t, jp, tp = setup("qwen3_4b", cfg_j=cfg_j)
    rng = np.random.default_rng(3)
    h = rng.standard_normal((B, S, cfg_j.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg_j.vocab_size, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.float32) if masked \
        else np.ones((B, S), np.float32)
    want = JM.chunked_softmax_xent(jp, cfg_j, jnp.asarray(h),
                                   jnp.asarray(labels), jnp.asarray(mask))
    got = M.chunked_softmax_xent(tp, cfg_t, torch.from_numpy(h),
                                 torch.from_numpy(labels),
                                 torch.from_numpy(mask))
    assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_grad_bf16_matches_jax_bitwise(dtype):
    """The identity forward; the cotangent rounded to bfloat16 and back to
    its dtype, bit for bit as ``jax.vjp`` of the reference's."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 67)).astype(dtype)
    ct = (rng.standard_normal((5, 67)) * 10.0 ** rng.integers(
        -4, 4, (5, 67))).astype(dtype)
    out, vjp = jax.vjp(j_grad_bf16, jnp.asarray(x))
    want, = vjp(jnp.asarray(ct))
    tx = torch.from_numpy(x).requires_grad_()
    got = grad_bf16(tx)
    assert torch.equal(got.detach(), tx.detach())
    got_ct, = torch.autograd.grad(got, tx, torch.from_numpy(ct))
    np.testing.assert_array_equal(got_ct.numpy(), np.asarray(want))
    assert not np.array_equal(got_ct.numpy(), ct)  # it did round
    plain = torch.from_numpy(x)
    assert grad_bf16(plain) is plain  # nothing to record: x itself


def moe_dispatch(capacity_factor, seed=5):
    """The dispatch maps of a reduced qwen2_moe layer (numpy): x, stok and
    the slot maps, with the pairs past capacity dropped at
    ``capacity_factor``."""
    cfg = dataclasses.replace(get("qwen2_moe_a2_7b").reduced(),
                              capacity_factor=capacity_factor)
    rng = np.random.default_rng(seed)
    Bm, Sm, D = 2, 32, cfg.d_model
    E, K = cfg.num_experts, cfg.top_k
    C = moe.moe_capacity(cfg, Sm)
    x = rng.standard_normal((Bm, Sm, D)).astype(np.float32)
    top_i = torch.from_numpy(np.stack([
        np.stack([rng.choice(E, K, replace=False) for _ in range(Sm)])
        for _ in range(Bm)]))
    flat_e = top_i.reshape(Bm, Sm * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    stok = order // K
    seg_start = torch.searchsorted(se, se, side="left")
    rank = torch.arange(Sm * K)[None] - seg_start
    keep = rank < C
    slot = torch.where(keep, se * C + rank, E * C)
    ord2 = torch.argsort(slot, dim=-1, stable=True)
    sorted_slots = torch.gather(slot, 1, ord2)
    targets = torch.arange(E * C)[None].expand(Bm, E * C).contiguous()
    j = torch.searchsorted(sorted_slots, targets).clamp(max=Sm * K - 1)
    hit = torch.gather(sorted_slots, 1, j) == targets
    src = torch.gather(ord2, 1, j)
    return dict(x=x, stok=stok.numpy(), slot=slot.numpy(), keep=keep.numpy(),
                src=src.numpy(), hit=hit.numpy(), E=E, C=C, D=D)


@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
def test_moe_functions_backward_match_jax(capacity_factor):
    """Forward and backward of ``_gather_tokens``, ``_pairs_to_slots`` and
    ``_slots_to_pairs`` against ``jax.vjp`` of the reference's custom VJPs,
    at ample capacity and at 0.5, where pairs drop (so ``keep`` and ``hit``
    are not all true)."""
    d = moe_dispatch(capacity_factor)
    assert capacity_factor > 1 or not d["keep"].all()
    rng = np.random.default_rng(6)
    J = {k: jnp.asarray(v) for k, v in d.items() if isinstance(v, np.ndarray)}
    Tt = {k: torch.from_numpy(v) for k, v in d.items()
          if isinstance(v, np.ndarray)}
    Bm, SK = d["stok"].shape
    EC = d["E"] * d["C"]
    cases = [
        (jmoe._gather_tokens, moe._gather_tokens, d["x"],
         ("stok",), (Bm, SK, d["D"])),
        (jmoe._pairs_to_slots, moe._pairs_to_slots,
         rng.standard_normal((Bm, SK, d["D"])).astype(np.float32),
         ("src", "hit", "slot", "keep"), (Bm, EC, d["D"])),
        (jmoe._slots_to_pairs, moe._slots_to_pairs,
         rng.standard_normal((Bm, EC, d["D"])).astype(np.float32),
         ("slot", "keep", "src", "hit"), (Bm, SK, d["D"]))]
    for jfn, tfn, x, names, out_shape in cases:
        ct = rng.standard_normal(out_shape).astype(np.float32)
        jout, vjp = jax.vjp(lambda a: jfn(a, *(J[n] for n in names)),
                            jnp.asarray(x))
        jct, = vjp(jnp.asarray(ct))
        tx = torch.from_numpy(x).requires_grad_()
        tout = tfn(tx, *(Tt[n] for n in names))
        tct, = torch.autograd.grad(tout, tx, torch.from_numpy(ct))
        np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tct.numpy(), np.asarray(jct), rtol=1e-6,
                                   atol=1e-6)


class _SlotsToPairsNoHit(torch.autograd.Function):
    """``_slots_to_pairs`` whose backward leaves out ``hit``: an unfilled
    slot gets the cotangent of whichever pair its clamped search found."""

    @staticmethod
    def forward(ctx, out_flat, slot, keep, src, hit):
        ctx.save_for_backward(src)
        safe = slot.clamp(max=out_flat.shape[1] - 1)
        g = torch.take_along_dim(out_flat, safe[..., None], dim=1)
        return g * keep[..., None].to(g.dtype)

    @staticmethod
    def backward(ctx, ct):
        src, = ctx.saved_tensors
        return (torch.take_along_dim(ct, src[..., None], dim=1), None, None,
                None, None)


def test_moe_hitless_backward_leaves_the_gradients_unchanged(monkeypatch):
    """Leaving ``hit`` out of ``_slots_to_pairs``' backward puts garbage
    cotangents on the unfilled slots, but an unfilled slot's buffer row is
    zero, and a bias-free gated expert maps a zero row to zero with a zero
    gradient for every weight and for the row (act(0) * 0): the layer's
    gradients are unchanged, bit for bit.  So no check can see that
    variant; chip_smoke.py (l2) holds the Functions to wrong variants that
    do move the gradients."""
    cfg = dataclasses.replace(get("qwen2_moe_a2_7b").reduced(),
                              capacity_factor=0.5)
    params = moe.moe_init(torch.Generator().manual_seed(0), cfg,
                          torch.float32, "cpu")
    x = torch.randn((2, 32, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))

    def grads():
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        xr = x.clone().requires_grad_()
        out, aux = moe.moe_apply(T.tree_unflatten(params, leaves), xr, cfg)
        return torch.autograd.grad((out.square().sum() + aux), leaves + [xr])

    want = grads()
    monkeypatch.setattr(moe, "_slots_to_pairs", _SlotsToPairsNoHit.apply)
    got = grads()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_flash_wrapper_refuses_gradients():
    """The flash kernel has no backward pass: its wrapper refuses inputs
    that require a gradient, on every device, and training attends through
    the loop instead."""
    q = torch.randn(1, 1, 2, 8, 16, requires_grad=True)
    k = torch.randn(1, 1, 8, 16)
    with pytest.raises(ValueError, match="forward only"):
        flash_attention(q, k, k)
    assert flash_attention(q.detach(), k, k).shape == q.shape


def factored_cfg(arch="qwen3_4b"):
    """A reduced config wide enough (d 128, d_ff 128, vocab 256) that its
    embedding and its stacked matrices have factored second moments."""
    return dataclasses.replace(jget(arch).reduced(), d_model=128,
                               d_ff=128, num_heads=4, head_dim=32)


@pytest.mark.parametrize("grad_accum,factored", [
    (1, False), (2, False), (1, True), (2, True)])
def test_make_train_step_matches_jax(grad_accum, factored):
    """Three steps of ``make_train_step`` against the reference's jitted
    step from the same parameters, optimizer state and batches, with
    clipping engaged (clip_norm 0.1 under gradient norms near 2): the loss
    and lr of every step within 1e-5, its grad_norm and clip_scale within
    2^-8, then every parameter and every moment."""
    cfg_j = factored_cfg() if factored else jget("qwen3_4b").reduced()
    cfg_j, cfg_t, jp, tp = setup("qwen3_4b", seed=7, cfg_j=cfg_j)
    jo = j_adamw_init(jp, factored=factored)
    to = convert.opt_state_from_numpy(jax.tree.map(np.asarray, jo),
                                      device="cpu")
    if factored:
        assert isinstance(to.v["embed"], dict)
        assert isinstance(to.v["layers"]["mlp"]["wi"], dict)
    kw = dict(grad_accum=grad_accum, factored=factored, clip_norm=0.1,
              remat=True)
    jstep = jax.jit(j_make_train_step(cfg_j, lr_fn=lambda s: j_wsd(
        s, peak_lr=1e-2, warmup_steps=2, total_steps=10), **kw).fn)
    tstep = T.make_train_step(cfg_t, lr_fn=lambda s: wsd_schedule(
        s, peak_lr=1e-2, warmup_steps=2, total_steps=10), **kw).fn
    for i in range(3):
        batch = batch_np(cfg_j, seed=10 + i, b=4)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tp, to, tm = tstep(tp, to, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        # the gradient norm sums the gradients, whose bfloat16-rounded
        # cotangents give them the 2^-8 limit
        for name, rtol in (("loss", LOSS_RTOL), ("lr", LOSS_RTOL),
                           ("grad_norm", REL_RMS), ("clip_scale", REL_RMS)):
            assert abs(float(tm[name]) - float(jm[name])) <= \
                rtol * abs(float(jm[name])), (i, name)
        assert float(tm["clip_scale"]) < 1.0
    assert int(to.step) == int(jo.step) == 3
    want = flat(jax.tree.map(np.asarray, {"params": jp, "m": jo.m,
                                          "v": jo.v}))
    got = flat({"params": tp, "m": to.m, "v": to.v})
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert rel_rms(t.numpy(), want[name]) <= REL_RMS, name


def test_train_crash_restore_bitwise(tmp_path):
    """The twin of tests/test_system.py::test_train_crash_restore_bitwise:
    kill the loop after step 3, restore from the checkpoint into fresh
    tensors, resume, and land on the parameters and moments of an
    uninterrupted 6-step run, bit for bit (the pipeline is a pure function
    of the step, the checkpoint exact)."""
    from repro_torch.checkpoint.checkpointer import Checkpointer, latest_step
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    cfg = get("internlm2_1_8b").reduced()
    pipe = SyntheticLM(cfg, DataConfig(seq_len=32, global_batch=4),
                       device="cpu")
    step_fn = T.make_train_step(
        cfg, lr_fn=lambda s: wsd_schedule(s, peak_lr=1e-2, warmup_steps=2,
                                          total_steps=100),
        remat=False, grad_accum=2).fn

    def fresh():
        params = M.init_params(cfg, 0, torch.float32, device="cpu")
        return params, adamw_init(params)

    params, opt = fresh()
    for i in range(6):
        params, opt, _ = step_fn(params, opt, pipe.batch(i))
    want = flat({"params": params, "m": opt.m, "v": opt.v})

    ck = Checkpointer(str(tmp_path))
    params, opt = fresh()
    for i in range(3):
        params, opt, _ = step_fn(params, opt, pipe.batch(i))
    ck.save(3, {"params": params, "opt": opt})
    del params, opt                         # the crash

    step = latest_step(str(tmp_path))
    assert step == 3
    p0, o0 = fresh()
    restored = ck.restore(step, {"params": p0, "opt": o0})
    params, opt = restored["params"], restored["opt"]
    for i in range(step, 6):
        params, opt, _ = step_fn(params, opt, pipe.batch(i))
    got = flat({"params": params, "m": opt.m, "v": opt.v})
    assert int(opt.step) == 6
    for name, t in want.items():
        assert torch.equal(got[name], t), name


def test_train_step_splits_microbatches_and_refuses_a_remainder():
    _, cfg, _, tp = setup("qwen3_4b")
    opt = adamw_init(tp)
    step = T.make_train_step(cfg, lr_fn=lambda s: wsd_schedule(
        s, peak_lr=1e-2, warmup_steps=2, total_steps=10), grad_accum=3).fn
    batch = {k: torch.from_numpy(v) for k, v in batch_np(cfg, b=4).items()}
    with pytest.raises(ValueError, match="not divisible by grad_accum"):
        step(tp, opt, batch)
