"""Plain float32 reference of Hymba-1.5B (arXiv:2411.13676) as the
configuration serves it, in plain ``torch``.

A layer: x = rms(h); h += (attention(x) + ssm(x)) / 2; h += mlp(rms(h)).
Attention: grouped-query (25 heads over 5 KV heads), rotary embedding (half
split), causal softmax(q k^T / sqrt(hd)) v, on a local layer only the
``sliding_window`` latest keys (the token itself included); the layers in
``global_layers`` see every earlier key.  SSM (Mamba2 heads of
``ssm_head_dim`` channels, one B/C group): the input projection to z, x,
B, C and dt; a causal depthwise conv of width ``ssm_conv`` over x, B, C,
then SiLU; dt = softplus(dt + dt_bias); A = -exp(A_log); each head's
output y_t = sum_{s <= t} (C_t . B_s) exp(A sum_{r=s+1..t} dt_r) dt_s x_s
+ D x_t, computed in that closed (quadratic) form; y gated by SiLU(z), RMS
normed, the output projection.  MLP: SwiGLU.  The norms are RMS norms
whose scale is stored as (scale - 1).  Logits: the final norm, then the
embedding transposed (tied).

The configuration's departures from the published model (its
``departures``), followed here: no meta tokens; no cross-layer KV sharing;
the two mixers' outputs averaged as they are; Mamba2 heads.

It works one sequence at a time with no cache or state, each layer's
weights cast to float32 while that layer runs, with TF32 off (the decay's
cumulative sums and their differences in float64).  ``precision="fp8"``
is the check's control: every matrix product's operands rounded to float8
(e4m3, each row of the input and each column of the weight scaled to the
format's range) first.
Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3, scaled along ``dim`` to its range."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def matmul(precision: str):
    if precision == "float32":
        return torch.matmul
    if precision == "fp8":
        return lambda x, w: fp8(x, -1) @ fp8(w, -2)
    raise ValueError(precision)


def rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def rope(x, theta):
    """x (T, heads, hd): position t rotated by t theta^(-2i/hd)."""
    T, _, hd = x.shape
    freqs = theta ** -(torch.arange(0, hd, 2, dtype=torch.float32,
                                    device=x.device) / hd)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(x, w, m, mm, window=None):
    T = x.shape[0]
    H, KV, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    q = rope(mm(x, w["wq"]).view(T, H, hd), m["rope_theta"])
    k = rope(mm(x, w["wk"]).view(T, KV, hd), m["rope_theta"])
    v = mm(x, w["wv"]).view(T, KV, hd)
    k = k.repeat_interleave(H // KV, dim=1)
    v = v.repeat_interleave(H // KV, dim=1)
    s = torch.einsum("thd,shd->hts", q, k) / math.sqrt(hd)
    t = torch.arange(T, device=x.device)
    see = t[None, :] <= t[:, None]
    if window is not None:
        see &= t[None, :] > t[:, None] - window
    p = torch.softmax(s.masked_fill(~see, float("-inf")), dim=-1)
    o = torch.einsum("hts,shd->thd", p, v).reshape(T, H * hd)
    return mm(o, w["wo"])


def ssm(x, w, m, mm):
    T = x.shape[0]
    di = m["ssm_expand"] * m["d_model"]
    N, P, dc = m["ssm_state"], m["ssm_head_dim"], m["ssm_conv"]
    nh = di // P
    zxbcdt = mm(x, w["in_proj"])
    z, xbc, dt = zxbcdt.split([di, di + 2 * N, nh], dim=-1)
    # causal depthwise conv: out_t = sum_j xbc_{t-j} conv_w[dc-1-j]
    pad = F.pad(xbc, (0, 0, dc - 1, 0))
    conv = sum(pad[j:j + T] * w["conv_w"][j] for j in range(dc))
    xbc = F.silu(conv + w["conv_b"])
    xs = xbc[:, :di].view(T, nh, P)
    Bm, Cm = xbc[:, di:di + N], xbc[:, di + N:]
    dt = F.softplus(dt + w["dt_bias"])                      # (T, nh)
    A = -torch.exp(w["A_log"])
    cs = torch.cumsum((dt * A).double(), dim=0)             # (T, nh)
    t = torch.arange(T, device=x.device)
    causal = t[None, :] <= t[:, None]                       # (t, s)
    decay = torch.exp((cs[:, None, :] - cs[None, :, :]).float()
                      .masked_fill(~causal[..., None], float("-inf")))
    wts = decay * (Cm @ Bm.T)[..., None] * dt[None]          # (t, s, nh)
    y = torch.einsum("tsh,shp->thp", wts, xs) + w["D"][:, None] * xs
    y = y.reshape(T, di) * F.silu(z)
    return mm(rms(y, w["norm"], m["norm_eps"]), w["out_proj"])


def swiglu(x, wi, wo, mm):
    gate, up = mm(x, wi).chunk(2, dim=-1)
    return mm(F.silu(gate) * up, wo)


def windows(m) -> list:
    glob = set(m.get("global_layers", ()))
    w = m.get("sliding_window")
    return [None if (w is None or i in glob) else w
            for i in range(m["num_layers"])]


def _layer_f32(tree: dict, i: int) -> dict:
    return {k: _layer_f32(v, i) if isinstance(v, dict) else v[i].float()
            for k, v in tree.items()}


def logits(weights: dict, config: dict, tokens: torch.Tensor, n_prompt: int,
           first: int, precision: str = "float32") -> torch.Tensor:
    """(n, T) token ids -> float32 logits (n, T - first, V) at positions
    ``first`` .. T - 1 (``n_prompt``: the prompt's length, which this model
    does not need)."""
    back = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits(weights, config["model"], tokens, first,
                       matmul(precision))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = back


@torch.no_grad()
def _logits(weights, m, tokens, first, mm):
    eps = m["norm_eps"]
    wins = windows(m)
    h = weights["embed"][tokens.long()].float()
    for i in range(m["num_layers"]):
        w = _layer_f32(weights["layers"], i)
        for s in range(h.shape[0]):
            x = rms(h[s], w["ln1"], eps)
            mix = (attention(x, w["attn"], m, mm, wins[i])
                   + ssm(x, w["ssm"], m, mm)) * 0.5
            y = h[s] + mix
            h[s] = y + swiglu(rms(y, w["ln2"], eps), w["mlp"]["wi"],
                              w["mlp"]["wo"], mm)
        del w
    h = rms(h[:, first:], weights["final_norm"].float(), eps)
    return mm(h, weights["embed"].float().T)
