"""The served-model cells' yardstick on the CPU: each configuration keeps
its published widths; each plain reference agrees with the port's served
path (prefill, then greedy decode through the shortcut view) on the
benchmark's seeded float32 weights, capacity drops included, and its
float8 control does not; the model FLOPs and the decode attention bytes
against hand counts; the serving readers on a made-up trace; the length
schedule."""
import importlib.util
import json

import pytest
import torch

from perfbench import model_cost, model_weights, spec, trace_read
from perfbench.harness import ReadCtx
from perfbench.kinds import serve as kind
from perfbench.systems import serve as system
from perfbench.tests import stand_in
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.runtime import serve as rt

BENCH = json.loads((stand_in.REPO / "BENCHMARK.json").read_text())
MODELS = ["qwen2_moe_a2_7b", "hymba_1_5b"]

#: the port's name of each published key the configurations state
PUBLISHED = {"num_hidden_layers": "num_layers", "hidden_size": "d_model",
             "num_attention_heads": "num_heads",
             "num_key_value_heads": "num_kv_heads",
             "vocab_size": "vocab_size", "num_experts": "num_experts",
             "num_experts_per_tok": "top_k",
             "moe_intermediate_size": "moe_d_ff",
             "shared_expert_intermediate_size": "shared_d_ff",
             "mamba_d_state": "ssm_state", "mamba_expand": "ssm_expand",
             "mamba_d_conv": "ssm_conv", "sliding_window": "sliding_window",
             "global_attn_idx": "global_layers",
             "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
             "tie_word_embeddings": "tie_embeddings"}


def _config(name: str) -> dict:
    c = [c for c in BENCH["configs"] if c["name"] == name][0]
    return json.loads((stand_in.REPO / c["file"]).read_text())


@pytest.mark.parametrize("name", MODELS)
def test_configs_keep_the_published_widths(name):
    c = _config(name)
    assert c["reduced"] == [] and c["system"] == "serve"
    for key, ours in PUBLISHED.items():
        if key in c["published"]:
            assert c["model"][ours] == c["published"][key], key
    hd = c["model"]["head_dim"]
    assert hd * c["model"]["num_heads"] in (c["model"]["d_model"], 1600)
    # the program takes every model key, and the model is whole
    cfg = system.arch(c)
    assert cfg.num_layers == c["published"]["num_hidden_layers"]


def _tiny(name: str) -> dict:
    c = _config(name)
    return dict(c, model=stand_in.tiny_model(c))


def _served(cfg, params, prompts, steps):
    """The port's served path in float32: the prefill's logits, then each
    decode step's logits over the shortcut view, each step fed the
    greedy token; (logits (B, steps + 1, V), tokens (B, steps + 1))."""
    prefill = rt.make_prefill_step(cfg, prompts.shape[1] + steps + 4,
                                   torch.float32)
    step = rt.make_serve_step(cfg)
    logits, state = prefill(params, {"tokens": prompts})
    out, toks = [logits], [torch.argmax(logits, -1).to(torch.int32)]
    for _ in range(steps):
        ctx = M.LayerCache(k=state.view_k, v=state.view_v, ssm=(
            M.ssm_mod.SSMCache(state.ssm_conv, state.ssm_state)
            if cfg.has_ssm else ()))
        out.append(M.decode_step(params, cfg, toks[-1], ctx,
                                 state.ctx_len + 1)[0])
        tok, state = step(params, state, toks[-1])
        assert torch.equal(tok, torch.argmax(out[-1], -1).to(torch.int32))
        toks.append(tok)
    return torch.stack(out, 1), torch.stack(toks, 1)


@pytest.mark.parametrize("name", MODELS)
def test_reference_agrees_with_the_served_path(name):
    c = _tiny(name)
    cfg = system.arch(c)
    ref = spec._module(stand_in.REPO / "perfbench", "references", name)
    w = model_weights.make(c["model"], 11, "cpu", torch.float32)
    g = torch.Generator().manual_seed(5)
    S, steps = 64, 6
    prompts = torch.randint(0, cfg.vocab_size, (2, S), generator=g)
    calls = []
    route = moe.route
    if cfg.num_experts:
        moe.route = lambda p, x, cfg: calls.append(route(p, x, cfg)[2]) \
            or route(p, x, cfg)
    try:
        got, toks = _served(cfg, w, prompts, steps)
    finally:
        moe.route = route
    if cfg.num_experts:
        # the prefill dropped pairs past capacity: the reference follows
        C = moe.moe_capacity(cfg, S)
        counts = torch.nn.functional.one_hot(calls[0].reshape(2, -1),
                                             cfg.num_experts).sum(1)
        assert int((counts - C).clamp_min(0).sum()) > 0
    fed = torch.cat([prompts, toks[:, :-1].long()], 1)
    want = ref.logits(w, c, fed, S, S - 1)
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-4 * scale
    low = ref.logits(w, c, fed, S, S - 1, precision="fp8")
    assert (low - want).abs().max() > 100 * 1e-4 * scale
    assert kind.token_gaps(want, toks).max() < 1e-3


def test_model_cost_hand_counted():
    dense = dict(num_layers=2, d_model=4, num_heads=2, num_kv_heads=1,
                 head_dim=2, d_ff=3, vocab_size=5, sliding_window=2,
                 global_layers=[0])
    # per layer: q, o 2 x 4 x 4; k, v 2 x 4 x 2; MLP 3 x 4 x 3
    assert model_cost.layer_params(dense) == 48 + 36
    assert model_cost.attn_windows(dense) == [None, 2]
    # 3 positions: 1 + 2 + 3 pairs globally, 1 + 2 + 2 in a window of 2
    assert model_cost.prefill_pairs(3, None) == 6
    assert model_cost.prefill_pairs(3, 2) == 5
    # projections 2 x 3 x 2 x 84, attention 4 x 2 x 2 x (6 + 5), the head
    # 2 x 4 x 5 for the last position
    assert model_cost.prefill_flops(dense, 1, 3) == 1008 + 176 + 40
    assert model_cost.flash_flops(dense, 1, 3) == 176
    # a token at position 3: 4 keys on the global layer, 2 on the local
    assert model_cost.decode_flops(dense, 1, 3) == 336 + 96 + 40
    # K and V rows (2 x rows x 1 x 2 x 2 bytes), q and out (2 x 2 x 2 x 2),
    # the length (4): 52 on the global layer, 36 on the local
    assert model_cost.decode_attn_bytes(dense, 1, 3, 2) == 88
    # a batch of two: twice one sequence's
    assert model_cost.prefill_flops(dense, 2, 3) == 2 * 1224
    moe_m = dict(dense, d_ff=0, num_experts=4, top_k=2, moe_d_ff=3,
                 shared_d_ff=5)
    # router 4 x 4, two experts 2 x 3 x 4 x 3, the shared 3 x 4 x 5
    assert model_cost.layer_params(moe_m) == 48 + 16 + 72 + 60
    ssm_m = dict(num_layers=1, d_model=4, num_heads=0, d_ff=0, vocab_size=5,
                 ssm_state=2, ssm_expand=2, ssm_head_dim=4, ssm_conv=3)
    # in_proj 4 x (16 + 4 + 2), out_proj 8 x 4
    assert model_cost.layer_params(ssm_m) == 88 + 32
    # 6 x 8 x 2 for the recurrence, 2 x 12 x 3 for the conv
    assert model_cost.ssm_token_flops(ssm_m) == 96 + 72
    assert model_cost.decode_flops(ssm_m, 1, 9) == 2 * 120 + 168 + 40


def _reader(name: str):
    path = stand_in.REPO / "perfbench" / "metrics" / f"{name}.py"
    s = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"),
                                               path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def test_serving_readers_on_a_made_up_trace():
    """One request traced: a prefill (a flash kernel and a product) and two
    decode steps (an MoE span each, the decode kernels), each device
    operation tied to its launch by correlation."""
    ua = "user_annotation"
    host = [("bench.prefill", ua, 0, 100),
            ("bench.decode_step", ua, 300, 400),
            ("repro_torch.moe", ua, 320, 360),
            ("bench.decode_step", ua, 500, 600),
            ("repro_torch.moe", ua, 520, 560)]
    launches = {1: 10, 2: 20, 3: 310, 4: 330, 5: 510, 6: 530, 7: 540}
    ops = [("flash_tc_kernel<128>", 100, 250), ("gemm", 250, 290),
           ("split_kernel<bf16>", 400, 420), ("moe_gemm", 420, 460),
           ("combine_kernel<bf16>", 600, 610), ("moe_gemm", 610, 650),
           ("moe_gemm", 650, 700)]
    t = trace_read.TraceView(0.0, 800.0, device_ops=ops, host=host,
                             device_corr=[1, 2, 3, 4, 5, 6, 7],
                             launches=launches)
    m = dict(num_layers=1, d_model=4, num_heads=2, num_kv_heads=1,
             head_dim=2, d_ff=3, vocab_size=5)
    # one request of one sequence: a prompt of 3 tokens, two steps
    ctx = ReadCtx(trace=t, counters={"traced_requests": [[1, 3, 2]]},
                  traced_probes=[], memory={}, config={"model": m},
                  traffic={"dtype": "bfloat16"})
    read = {n: _reader(n).read(ctx) for n in (
        "decode_host_ms", "decode_host_ms.unbounded",
        "device_idle_pct.decode", "moe_device_pct.decode",
        "ssm_device_pct.decode", "decode_attn_roofline_pct",
        "flash_roofline_pct")}
    assert read["decode_host_ms"] == pytest.approx(0.1)
    assert read["decode_host_ms.unbounded"] == read["decode_host_ms"]
    # decode from 300 to 800: busy 400-460, 600-700
    assert read["device_idle_pct.decode"] == pytest.approx(
        100 * (1 - 160 / 500))
    # launched in the steps: 20 + 40 + 10 + 40 + 50 us, in MoE 130
    assert read["moe_device_pct.decode"] == pytest.approx(100 * 130 / 160)
    assert read["ssm_device_pct.decode"] is None
    nbytes = sum(model_cost.decode_attn_bytes(m, 1, 3 + i, 2)
                 for i in range(2))
    assert read["decode_attn_roofline_pct"] == pytest.approx(
        100 * nbytes / 3.35e12 / 30e-6)
    assert read["flash_roofline_pct"] == pytest.approx(
        100 * model_cost.flash_flops(m, 1, 3) / 989e12 / 150e-6)
    # nothing traced: the kernels' readers find nothing to read
    ctx.counters = {"traced_requests": []}
    assert _reader("decode_attn_roofline_pct").read(ctx) is None
    assert _reader("flash_roofline_pct").read(ctx) is None


def test_step_mfu_of_the_untraced_work():
    """The shares of the peak: the untraced prefills' and steps' model
    FLOPs over their CUDA-event milliseconds; nothing untraced, nothing
    read."""
    ctx = ReadCtx(trace=None, counters={
        "prefill_flops": 989e12, "prefill_ms": 2000.0,
        "decode_flops": 9.89e12, "decode_ms": 400.0}, traced_probes=[],
        memory={})
    assert _reader("step_mfu.prefill").read(ctx) == pytest.approx(50.0)
    assert _reader("step_mfu.decode").read(ctx) == pytest.approx(2.5)
    ctx.counters = dict(ctx.counters, decode_ms=0, prefill_ms=0)
    assert _reader("step_mfu.decode").read(ctx) is None
    assert _reader("step_mfu.prefill").read(ctx) is None


def test_rate_and_tail_of_the_untraced_work():
    """The rate and the step tail read per layer: the untraced requests'
    tokens over their CUDA-event seconds, and the 95th percentile of their
    steps; nothing untraced, nothing read."""
    ctx = ReadCtx(trace=None, counters={
        "prefill_ms": 1500.0, "decode_ms": 500.0, "tokens": 64,
        "step_ms": [float(x) for x in range(1, 101)]}, traced_probes=[],
        memory={})
    assert _reader("serve_tokens_per_s.unbounded").read(ctx) == \
        pytest.approx(32.0)
    assert _reader("decode_step_p95_ms.unbounded").read(ctx) == \
        pytest.approx(95.05)
    ctx.counters = dict(ctx.counters, prefill_ms=0, decode_ms=0, tokens=0,
                        step_ms=[])
    assert _reader("serve_tokens_per_s.unbounded").read(ctx) is None
    assert _reader("decode_step_p95_ms.unbounded").read(ctx) is None


def test_schedule_serves_each_length_class_once_a_cycle():
    """The lognormal's quantiles, rounded; in a cycle each prompt class and
    each output class once, in bit-reversed order from their offsets."""
    t = {"prompt_tokens": {"median": 1500, "sigma": 0.7},
         "output_tokens": {"median": 13, "sigma": 1.0}, "classes": 8,
         "prompt_round": 64, "prompt_offset": 1, "output_offset": 0}
    p = kind.lengths(t["prompt_tokens"], 8, 64)
    assert p == sorted(p) and all(x % 64 == 0 for x in p)
    # the middle quantiles lie on either side of the median
    assert p[3] <= 1536 and p[4] >= 1500
    assert [kind.bit_reversed(k, 8) for k in range(8)] == [
        0, 4, 2, 6, 1, 5, 3, 7]
    assert kind.bit_reversed(9, 8) == kind.bit_reversed(1, 8)
    cyc = kind.schedule(t)
    assert sorted(S for S, _ in cyc) == p
    assert sorted(G for _, G in cyc) == kind.lengths(t["output_tokens"], 8)
    # the first request is the class bit-reversed from the offset
    assert cyc[0][0] == p[4] and cyc[1][0] == p[2]
    with pytest.raises(ValueError):
        kind.schedule(dict(t, classes=6))


def test_token_gaps_in_standard_deviations():
    logits = torch.tensor([[[0.0, 1.0, 2.0, 3.0]]])
    sd = float(logits.std())
    gaps = kind.token_gaps(logits, torch.tensor([[1]]))
    assert float(gaps) == pytest.approx(2.0 / sd)
    assert float(kind.token_gaps(logits, torch.tensor([[3]]))) == 0.0
