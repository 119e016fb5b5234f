"""Mixture-of-Experts layer (twin of ``repro/models/moe.py``): top-k routing
with sort-based capacity dispatch, forward only.

Dispatch, per batch row and batched over B:

  1. top-k expert choice per token, the router weights renormalized
     (:func:`route`);
  2. the (token, choice) pairs sorted stably by expert id;
  3. each expert segment keeps its first ``capacity`` pairs in (token,
     choice) order, gathered into a dense ``(E, C, D)`` buffer;
  4. two grouped products run the expert FFNs;
  5. the results gather back to their pairs, scaled by the router weights,
     and each token sums its K choices.

The reference writes every movement as a gather whose ``custom_vjp`` keeps
the backward a gather too (for GSPMD); here they are plain
``take_along_dim`` forwards, and its ``distributed.constrain`` pins have no
counterpart on one card.  The auxiliary loss is the switch-style
load-balancing loss (mean fraction x mean probability x E / K), computed
before dropping.

The layer's work runs inside a ``torch.profiler.record_function`` span
named :data:`SPAN`, so a profiler trace can attribute device time to it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (_dense_init, activation, mlp_apply,
                                       mlp_init)

#: the profiler span around :func:`moe_apply`
SPAN = "repro_torch.moe"


def moe_init(gen: torch.Generator, cfg, dtype, device) -> dict:
    """The router in float32 (d, E), whatever ``dtype``; ``wi`` (E, d, 2ff)
    and ``wo`` (E, ff, d) in ``dtype``; the shared experts' MLP when
    ``shared_d_ff``."""
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {
        "router": _dense_init(gen, (d, e), d, torch.float32, device),
        "wi": _dense_init(gen, (e, d, 2 * ff), d, dtype, device),
        "wo": _dense_init(gen, (e, ff, d), ff, dtype, device),
    }
    if cfg.shared_d_ff:
        p["shared"] = mlp_init(gen, d, cfg.shared_d_ff, dtype, device)
    return p


def moe_capacity(cfg, tokens: int) -> int:
    """Capacity per dispatch group (a batch row: ``tokens`` = seq_len)."""
    cap = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8, -(-cap // 8) * 8)  # round up to 8, as the reference


def route(p: dict, x: torch.Tensor, cfg):
    """The router on x (B, S, D): (probs (B, S, E) float32, top_w (B, S, K)
    renormalized to sum 1, top_i (B, S, K) int64), the choices in
    descending probability."""
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    top_w, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_w, top_i


def moe_apply(p: dict, x: torch.Tensor, cfg) -> tuple:
    """x: (B, S, D) -> (out (B, S, D) in x's dtype, aux loss () float32)."""
    with torch.profiler.record_function(SPAN):
        return _moe_apply(p, x, cfg)


def _moe_apply(p: dict, x: torch.Tensor, cfg) -> tuple:
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    C = moe_capacity(cfg, S)                                 # per row
    probs, top_w, top_i = route(p, x, cfg)

    # load-balancing aux loss (computed before dropping)
    frac = F.one_hot(top_i, E).float().sum(2).mean((0, 1))
    aux = E * torch.sum(frac * probs.mean((0, 1))) / K

    # per-row stable sort of the (token, choice) pairs by expert id: a
    # segment's first C pairs in (token, choice) order are the ones kept
    flat_e = top_i.reshape(B, S * K)
    flat_w = top_w.reshape(B, S * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    stok = order // K                                        # pair -> token
    sw = torch.gather(flat_w, 1, order)
    # rank within each expert segment; drop ranks >= capacity
    seg_start = torch.searchsorted(se, se, side="left")
    rank = torch.arange(S * K, device=x.device)[None] - seg_start
    keep = rank < C
    slot = torch.where(keep, se * C + rank, E * C)           # E*C = drop

    # the (E*C)-slot buffer by gathers: each target slot finds its source
    # pair in the pairs sorted by slot
    ord2 = torch.argsort(slot, dim=-1, stable=True)
    sorted_slots = torch.gather(slot, 1, ord2)
    targets = torch.arange(E * C, device=x.device)[None].expand(B, E * C)
    j = torch.searchsorted(sorted_slots, targets.contiguous())
    j = j.clamp(max=S * K - 1)
    hit = torch.gather(sorted_slots, 1, j) == targets
    src = torch.gather(ord2, 1, j)                           # source pair
    xg = torch.take_along_dim(x, stok[..., None], dim=1)     # (B, S*K, D)
    buf = torch.take_along_dim(xg, src[..., None], dim=1)
    buf = (buf * hit[..., None].to(buf.dtype)).reshape(B, E, C, D)

    h = torch.einsum("becd,edf->becf", buf, p["wi"])         # (B,E,C,2ff)
    gate, up = h.chunk(2, dim=-1)
    h = activation(gate, cfg.act) * up
    out_e = torch.einsum("becf,efd->becd", h, p["wo"])
    out_flat = out_e.reshape(B, E * C, D)

    safe = slot.clamp(max=E * C - 1)
    contrib = torch.take_along_dim(out_flat, safe[..., None], dim=1)
    contrib = contrib * keep[..., None].to(contrib.dtype)
    contrib = contrib * sw.to(x.dtype)[..., None]
    # un-sort through the inverse permutation; a token's K choices are then
    # adjacent and summed
    inv = torch.argsort(order, dim=-1)
    contrib = torch.take_along_dim(contrib, inv[..., None], dim=1)
    out = contrib.reshape(B, S, K, D).sum(dim=2)

    if "shared" in p:
        out = out + mlp_apply(p["shared"], x, cfg.act)
    return out, aux
