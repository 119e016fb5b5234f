"""A served model's weights, made by the benchmark from the seed on the
device, in the layout the program takes them (``repro_torch``'s parameter
dictionary, each per-layer tensor stacked over the layers) and the type it
serves them in.  One draw a stacked tensor: a few large calls.

The draws follow the published initialization (``initializer_range``
0.02 for every matrix and the embedding, the norms' scales 1) and, for the
SSM, Mamba2's: A drawn uniform in [1, 16], D 1, dt log-uniform in [0.001,
0.1] behind an inverse softplus, the conv as PyTorch's ``Conv1d`` draws it
(uniform within 1 / sqrt(d_conv)).  The program derives nothing here: the
reference reads the same tensors.
"""
from __future__ import annotations

import math

import torch

INIT_STD = 0.02
DT_RANGE = (0.001, 0.1)
A_RANGE = (1.0, 16.0)


def make(m: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The weights of configuration ``m`` (its ``model`` sizes)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    f32 = torch.float32

    def normal(*shape, dt=dtype):
        return torch.randn(shape, generator=g, device=device,
                           dtype=dt).mul_(INIT_STD)

    def uniform(lo, hi, *shape):
        return torch.rand(shape, generator=g, device=device,
                          dtype=f32).mul_(hi - lo).add_(lo)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, device=device, dtype=dt)

    L, D, V = m["num_layers"], m["d_model"], m["vocab_size"]
    layers = {"ln1": zeros(L, D)}
    if m.get("num_heads"):
        hd, H, KV = m["head_dim"], m["num_heads"], m["num_kv_heads"]
        layers["attn"] = {"wq": normal(L, D, H * hd),
                          "wk": normal(L, D, KV * hd),
                          "wv": normal(L, D, KV * hd),
                          "wo": normal(L, H * hd, D)}
    if m.get("ssm_state"):
        di, N = m["ssm_expand"] * D, m["ssm_state"]
        nh, dc = di // m["ssm_head_dim"], m["ssm_conv"]
        dt = torch.exp(uniform(math.log(DT_RANGE[0]), math.log(DT_RANGE[1]),
                               L, nh))
        layers["ssm"] = {
            "in_proj": normal(L, D, 2 * di + 2 * N + nh),
            "out_proj": normal(L, di, D),
            "conv_w": uniform(-dc ** -0.5, dc ** -0.5, L, dc,
                              di + 2 * N).to(dtype),
            "conv_b": zeros(L, di + 2 * N),
            "A_log": torch.log(uniform(*A_RANGE, L, nh)),
            "D": torch.ones((L, nh), device=device, dtype=f32),
            "dt_bias": dt + torch.log(-torch.expm1(-dt)),
            "norm": zeros(L, di)}
    if m.get("d_ff") or m.get("num_experts"):
        layers["ln2"] = zeros(L, D)
    if m.get("d_ff"):
        layers["mlp"] = {"wi": normal(L, D, 2 * m["d_ff"]),
                         "wo": normal(L, m["d_ff"], D)}
    if m.get("num_experts"):
        E, ff = m["num_experts"], m["moe_d_ff"]
        layers["moe"] = {"router": normal(L, D, E, dt=f32),
                         "wi": normal(L, E, D, 2 * ff),
                         "wo": normal(L, E, ff, D)}
        if m.get("shared_d_ff"):
            sf = m["shared_d_ff"]
            layers["moe"]["shared"] = {"wi": normal(L, D, 2 * sf),
                                       "wo": normal(L, sf, D)}
    w = {"embed": normal(V, D), "layers": layers, "final_norm": zeros(D)}
    if not m.get("tie_embeddings"):
        w["lm_head"] = normal(D, V)
    return w
