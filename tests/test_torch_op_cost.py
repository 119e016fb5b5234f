"""``repro_torch.launch.op_cost``: the eager op counter against ground truth
and against the reference's trip-count-aware HLO counter.

The first five cases are the twins of ``tests/test_hlo_cost.py``'s (scan,
grad of scan, batched dot, update-slice in a loop, breakdown), written for
eager loops, which run every iteration through the counter.  Then: the
slice-write and memory rules; the flops of the port's ``train_forward`` on
the reduced qwen3_4b and qwen2_moe_a2_7b (parameters carried across from
the JAX package) against ``repro.launch.hlo_cost.analyze`` of the
reference's jitted forward compiled on the CPU, within 0.5%; the train step
with remat, whose gap to the reference is bounded (the reference also
rematerializes each query tile of its attention loop and the port does not,
so the port counts no more, and at most one attention-loop forward less);
and a meta run of a reduced prefill, which records the flash kernel's cost
and launches nothing."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.launch import hlo_cost
from repro.models import model as JM
from repro.optim.adamw import adamw_init as j_adamw_init
from repro.optim.schedule import wsd_schedule as j_wsd
from repro.runtime.train import make_train_step as j_make_train_step
from repro_torch import convert
from repro_torch.configs import get
from repro_torch.kernels import _build, _decode, ref
from repro_torch.kernels import flash_attention as flash
from repro_torch.launch import op_cost
from repro_torch.models import attention as attn
from repro_torch.models import model as M
from repro_torch.optim.adamw import adamw_init
from repro_torch.optim.schedule import wsd_schedule
from repro_torch.runtime import serve
from repro_torch.runtime.train import make_train_step, param_struct

M_ = 256
FLOP_RTOL = 0.005


def randn(*shape, requires_grad=False):
    rng = np.random.default_rng(sum(shape))
    return torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                        requires_grad=requires_grad)


def test_loop_flops_count_every_iteration():
    w, x = randn(8, M_, M_), randn(M_, M_)

    def looped(w, x):
        for i in range(8):
            x = x @ w[i]
        return x

    t = op_cost.analyze(looped, w, x)
    assert t.flops == 8 * 2 * M_ ** 3
    assert t.by_op["mm"].calls == 8


def test_grad_of_loop_counts_backward():
    w = randn(4, M_, M_, requires_grad=True)
    x = randn(M_, M_, requires_grad=True)

    def grad(w, x):
        h = x
        for i in range(4):
            h = h @ w[i]
        return torch.autograd.grad(h.sum(), (w, x))

    t = op_cost.analyze(grad, w, x)
    # forward 1 + backward 2 products per step
    assert t.flops == 3 * 4 * 2 * M_ ** 3


def test_batched_dot_flops():
    a, b = randn(4, 32, 64), randn(4, 64, 16)
    t = op_cost.analyze(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                        a, b)
    assert t.flops == 2 * 4 * 32 * 64 * 16


def test_row_writes_in_loop_not_charged_full_buffer():
    """Stacking one row per iteration costs the row, not the buffer."""
    x = randn(64, M_)

    def stack(x):
        out = torch.empty((64, M_), dtype=torch.bfloat16)
        for i in range(64):
            out[i] = (x[i] * 2).to(torch.bfloat16)
        return out

    t = op_cost.analyze(stack, x)
    buffer_bytes = 64 * M_ * 2
    assert t.bytes < 20 * buffer_bytes, t.bytes
    assert t.by_op["copy_"].bytes == 2 * buffer_bytes   # each row read+written
    assert t.by_op["copy_"].calls == 64


def test_breakdown_orders_by_cost():
    a = randn(512, 512)

    def f(a):
        big = a @ a
        small = a[None, :64, :64] @ a[None, :64, :64]
        return big.sum() + small.sum()

    bd = op_cost.analyze(f, a).breakdown(top=5)
    assert bd["flops"][0][0] > bd["flops"][-1][0]
    assert bd["flops"][0] == (2 * 512 ** 3, 1, "mm")
    assert bd["flops"][1] == (2 * 64 ** 3, 1, "bmm")
    assert [r[0] for r in bd["bytes"]] == sorted(
        (r[0] for r in bd["bytes"]), reverse=True)


def test_decode_view_write_charged_its_window():
    """``runtime/serve._write_row``'s ``index_put_`` into the (L, B, KV,
    S, hd) view moves the new rows, not the view."""
    L, B, KV, S, hd = 3, 4, 2, 64, 16
    view = torch.zeros((L, B, KV, S, hd))
    new = randn(L, B, KV, hd)
    idx = torch.tensor([0, 5, 63, 64], dtype=torch.int32)
    t = op_cost.analyze(serve._write_row, view, idx, new)
    rows = L * B * KV * hd * 4
    put = t.by_op["index_put_"]
    assert put.calls == 1
    assert put.bytes == 2 * rows + 2 * B * 8     # values + window, 2 indices
    assert t.bytes < view.numel() * 4


def test_memory_peak_of_live_storages():
    n = 1 << 16
    x = randn(n)

    def f(x):
        y = x * 2
        z = y + 1            # y and z live
        del y
        return z * 3         # z and the output live

    mem = op_cost.analyze(f, x).memory
    assert mem == {"argument_bytes": 4 * n, "output_bytes": 4 * n,
                   "temp_bytes": 4 * n, "total_bytes": 12 * n}


def test_views_and_allocations_are_free():
    x = randn(64, 64)
    t = op_cost.analyze(lambda x: (x.t().t().reshape(-1)[:10],
                                   x.expand(2, 64, 64).select(0, 1),
                                   torch.empty(100), x.unbind(0)), x)
    assert t.flops == 0 and t.bytes == 0
    # a reshape of a transposed tensor copies it
    t = op_cost.analyze(lambda x: x.t().reshape(-1), x)
    assert dict(t.by_op) == {"clone": op_cost.OpCost(1, 0.0, 2 * x.numel()
                                                     * 4)}


def test_visible_pairs_count_the_flash_mask():
    for Sq, Skv in ((1, 40), (17, 17), (33, 40)):
        for causal in (True, False):
            for window in (None, 1, 5, 64):
                for prefix in (0, 1, 9, 50):
                    want = int(ref.flash_mask(
                        Sq, Skv, causal=causal, window=window,
                        prefix_len=prefix).sum())
                    assert ref.visible_pairs(
                        Sq, Skv, causal=causal, window=window,
                        prefix_len=prefix) == want


def test_decode_cost_counts_live_rows():
    B, KV, G, hd, S = 3, 2, 4, 16, 64
    q, k = torch.zeros(B, KV, G, hd), torch.zeros(B, KV, S, hd)
    lens = torch.tensor([0, 10, 64], dtype=torch.int32)
    flops, nbytes = _decode.cost(q, k, lens, None, S, None, True)
    live = 1 + 11 + 65
    assert flops == 4 * KV * G * hd * live
    assert nbytes == 2 * live * KV * hd * 4 + 2 * q.numel() * 4 + 4 * B
    # a window counts only its rows; the meta device counts every row
    assert _decode.cost(q, k, lens, None, S, 8, True)[0] \
        == 4 * KV * G * hd * (1 + 8 + 8)
    assert _decode.cost(q, k, lens.to("meta"), None, S, None, False)[0] \
        == 4 * KV * G * hd * B * S


# -- parity with the reference's HLO counter ---------------------------------

B, S = 2, 64


def carried(arch):
    jcfg, cfg = jget(arch).reduced(), get(arch).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    p = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                  device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S + 1),
                                             dtype=np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.as_tensor(toks[:, :-1]),
          "labels": torch.as_tensor(toks[:, 1:])}
    return jcfg, cfg, jp, p, jb, tb


def loop_flops(monkeypatch, cfg, p, tb) -> float:
    """The flops of the attention loop in one forward pass."""
    total = []
    inner = attn.loop_attention

    def counted(*a, **k):
        t = op_cost.OpCounter()
        with t:
            out = inner(*a, **k)
        total.append(t.totals.flops)
        return out
    monkeypatch.setattr(attn, "loop_attention", counted)
    with torch.no_grad():
        M.train_forward(p, cfg, tb)
    monkeypatch.undo()
    return sum(total)


@pytest.mark.parametrize("arch", ["qwen3_4b", "qwen2_moe_a2_7b"])
def test_forward_and_train_step_flops_match_hlo_cost(monkeypatch, arch):
    jcfg, cfg, jp, p, jb, tb = carried(arch)
    hlo = jax.jit(lambda p, b: JM.train_forward(p, jcfg, b)).lower(
        jp, jb).compile().as_text()
    want = hlo_cost.analyze(hlo).flops
    with torch.no_grad():
        got = op_cost.analyze(M.train_forward, p, cfg, tb)
    assert got.flops == pytest.approx(want, rel=FLOP_RTOL)

    j_step = j_make_train_step(jcfg, lr_fn=lambda s: j_wsd(
        s, peak_lr=3e-4, warmup_steps=2, total_steps=10), remat=True).fn
    hlo = jax.jit(j_step).lower(jp, j_adamw_init(jp), jb).compile().as_text()
    want_step = hlo_cost.analyze(hlo).flops
    step = make_train_step(cfg, lr_fn=lambda s: wsd_schedule(
        s, peak_lr=3e-4, warmup_steps=2, total_steps=10), remat=True).fn
    got_step = op_cost.analyze(step, p, adamw_init(p), tb).flops
    gap = want_step - got_step
    # qwen3_4b 99090432 - 96468992 = 2621440 = 5/6 of the loop's forward;
    # qwen2_moe the same 2621440 (same attention widths)
    assert 0 <= gap <= loop_flops(monkeypatch, cfg, p, tb), (want_step,
                                                             got_step)


def test_meta_prefill_records_the_flash_kernel_and_launches_nothing():
    cfg = get("qwen3_4b").reduced()
    params = param_struct(cfg, torch.bfloat16)
    batch = {"tokens": torch.empty((2, 64), dtype=torch.int32,
                                   device="meta")}
    _build.reset_launches()
    t = op_cost.analyze(serve.make_prefill_step(cfg, s_cap=80), params,
                        batch)
    assert _build.launches() == {}
    k = t.by_op["kernel:flash_attention"]
    assert k.calls == cfg.num_layers
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = torch.empty((2, KV, H // KV, 64, hd), dtype=torch.bfloat16)
    kk = torch.empty((2, KV, 64, hd), dtype=torch.bfloat16)
    assert (k.flops, k.bytes) == tuple(cfg.num_layers * c
                                       for c in flash.cost(q, kk))
    assert k.flops == cfg.num_layers * 4 * 2 * H * hd * (64 * 65 // 2)
    # the CPU run of the same step computes the attention in plain ops
    cpu = op_cost.analyze(serve.make_prefill_step(cfg, s_cap=80),
                          M.init_params(cfg, 0, torch.bfloat16,
                                        device="cpu"),
                          {"tokens": torch.zeros((2, 64), dtype=torch.int32)})
    assert "kernel:flash_attention" not in cpu.by_op
    assert cpu.by_op["mm"].flops == t.by_op["mm"].flops


def test_cost_sinks_close():
    counter = op_cost.OpCounter()
    with counter:
        _build.record_cost("x", lambda: (3.0, 5.0))
    _build.record_cost("x", lambda: (1.0, 1.0))   # no counter: not charged
    assert (counter.totals.flops, counter.totals.bytes) == (3.0, 5.0)
    assert _build._cost_sink is None


def test_roofline_terms():
    t = op_cost.roofline_terms(989e12, 3.35e12 * 2)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(2.0)
    assert t["dominant"] == "memory_s"
    assert t["step_s_lower_bound"] == t["memory_s"]
