"""Plain float32 reference of Qwen1.5-MoE-A2.7B (hf:Qwen/Qwen1.5-MoE-A2.7B)
as the configuration serves it, in plain ``torch``.

A layer: h += attention(rms(h)); h += moe(rms(h)).  Attention: q, k, v
projections, rotary embedding (half split, theta from the configuration),
causal softmax(q k^T / sqrt(hd)) v over all heads, the output projection.
MoE: router softmax in float32, the top-k experts' SwiGLU MLPs weighted by
their probabilities, plus the shared expert's SwiGLU MLP.  The norms are
RMS norms whose scale is stored as (scale - 1).  Logits: the final norm,
then the output head.

The configuration's departures from the published model (its
``departures``), followed here: the top-k weights renormalized to sum 1;
no gate on the shared expert; no q/k/v bias; and the port's capacity rule:
within a prompt of ``n_prompt`` tokens, each expert keeps at most
``C = max(8, 8 ceil(int(n_prompt K cf / E) / 8))`` (token, choice) pairs,
the first in (token, choice) order, and a pair past it adds nothing; a
token after the prompt (a decode step) is never dropped.

It works one sequence at a time with no cache, each layer's weights cast
to float32 while that layer runs, with TF32 off.  ``precision="fp8"`` is
the check's control: every matrix product's operands rounded to float8
(e4m3, each row of the input and each column of the weight scaled to the
format's range) first.  Imports nothing of the program.
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


def swiglu(x, wi, wo, mm):
    gate, up = mm(x, wi).chunk(2, dim=-1)
    return mm(F.silu(gate) * up, wo)


def capacity(m, n_prompt: int) -> int:
    c = int(n_prompt * m["top_k"] * m["capacity_factor"]
            / m["num_experts"])
    return max(8, -(-c // 8) * 8)


def moe(x, w, m, mm, n_prompt: int):
    T = x.shape[0]
    E, K = m["num_experts"], m["top_k"]
    probs = torch.softmax(mm(x, w["router"]), dim=-1)
    top_w, top_i = torch.topk(probs, K, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    keep = torch.ones((T, K), dtype=torch.bool, device=x.device)
    P = min(n_prompt, T)
    if P:
        # a prompt pair's rank among its expert's pairs, in (token, choice)
        # order
        flat = top_i[:P].reshape(-1)
        seen = torch.cumsum(F.one_hot(flat, E), dim=0) - 1
        rank = seen.gather(1, flat[:, None])[:, 0]
        keep[:P] = (rank < capacity(m, n_prompt)).view(P, K)
    out = torch.zeros((T, K, x.shape[1]), dtype=x.dtype, device=x.device)
    for e in range(E):
        tok, choice = torch.nonzero((top_i == e) & keep, as_tuple=True)
        if tok.numel():
            y = swiglu(x[tok], w["wi"][e], w["wo"][e], mm)
            out[tok, choice] = y * top_w[tok, choice, None]
    sh = w["shared"]
    return out.sum(1) + swiglu(x, sh["wi"], sh["wo"], mm)


def _layer_f32(tree: dict, i: int) -> dict:
    return {k: _layer_f32(v, i) if isinstance(v, dict) else v[i].float()
            for k, v in tree.items()}


def logits(weights: dict, config: dict, tokens: torch.Tensor, n_prompt: int,
           first: int, precision: str = "float32") -> torch.Tensor:
    """(n, T) token ids, the first ``n_prompt`` of each row its prompt ->
    float32 logits (n, T - first, V) at positions ``first`` .. T - 1."""
    back = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits(weights, config["model"], tokens, n_prompt, first,
                       matmul(precision))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = back


@torch.no_grad()
def _logits(weights, m, tokens, n_prompt, first, mm):
    eps = m["norm_eps"]
    h = weights["embed"][tokens.long()].float()
    for i in range(m["num_layers"]):
        w = _layer_f32(weights["layers"], i)
        for s in range(h.shape[0]):
            x = h[s]
            x = x + attention(rms(x, w["ln1"], eps), w["attn"], m, mm)
            h[s] = x + moe(rms(x, w["ln2"], eps), w["moe"], m, mm, n_prompt)
        del w
    h = rms(h[:, first:], weights["final_norm"].float(), eps)
    return mm(h, weights["lm_head"].float())
