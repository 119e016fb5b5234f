"""Mixture-of-Experts layer (twin of ``repro/models/moe.py``): top-k routing
with sort-based capacity dispatch.

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
the backward a gather too (for GSPMD): each mapping is a permutation with a
known inverse.  Here the three are ``torch.autograd.Function``s with those
backward passes (:func:`_gather_tokens`, :func:`_pairs_to_slots`,
:func:`_slots_to_pairs`), so that the gradients are the reference's and no
backward sums by atomics; its ``distributed.constrain`` pins have no
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


class _GatherTokens(torch.autograd.Function):
    """(B,S,D),(B,S*K) -> (B,S*K,D): xg[b,j] = x[b, stok[b,j]].  ``stok``
    holds each token K times, and its stable argsort groups token t's K
    pairs at rows [t*K, (t+1)*K): the backward gathers the cotangent through
    it and sums over K."""

    @staticmethod
    def forward(ctx, x, stok):
        ctx.save_for_backward(stok)
        ctx.S = x.shape[1]
        return torch.take_along_dim(x, stok[..., None], dim=1)

    @staticmethod
    def backward(ctx, ct):
        stok, = ctx.saved_tensors
        B, SK, D = ct.shape
        inv = torch.argsort(stok, dim=-1, stable=True)
        g = torch.take_along_dim(ct, inv[..., None], dim=1)
        return g.reshape(B, ctx.S, SK // ctx.S, D).sum(dim=2), None


class _PairsToSlots(torch.autograd.Function):
    """(B,S*K,D) pairs -> (B,E*C,D) buffer rows: buf[t] = xg[src[t]] *
    hit[t].  Its inverse (slot, keep), pair p filling slot[p] iff keep[p],
    is the backward's gather."""

    @staticmethod
    def forward(ctx, xg, src, hit, slot, keep):
        ctx.save_for_backward(slot, keep)
        g = torch.take_along_dim(xg, src[..., None], dim=1)
        return g * hit[..., None].to(g.dtype)

    @staticmethod
    def backward(ctx, ct):
        slot, keep = ctx.saved_tensors
        safe = slot.clamp(max=ct.shape[1] - 1)
        g = torch.take_along_dim(ct, safe[..., None], dim=1)
        return g * keep[..., None].to(g.dtype), None, None, None, None


class _SlotsToPairs(torch.autograd.Function):
    """(B,E*C,D) buffer -> (B,S*K,D) pairs: y[p] = out[slot[p]] * keep[p],
    the inverse of :class:`_PairsToSlots`, whose mapping (src, hit) is the
    backward's gather."""

    @staticmethod
    def forward(ctx, out_flat, slot, keep, src, hit):
        ctx.save_for_backward(src, hit)
        safe = slot.clamp(max=out_flat.shape[1] - 1)
        g = torch.take_along_dim(out_flat, safe[..., None], dim=1)
        return g * keep[..., None].to(g.dtype)

    @staticmethod
    def backward(ctx, ct):
        src, hit = ctx.saved_tensors
        g = torch.take_along_dim(ct, src[..., None], dim=1)
        return g * hit[..., None].to(g.dtype), None, None, None, None


_gather_tokens = _GatherTokens.apply
_pairs_to_slots = _PairsToSlots.apply
_slots_to_pairs = _SlotsToPairs.apply


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
    xg = _gather_tokens(x, stok)                             # (B, S*K, D)
    buf = _pairs_to_slots(xg, src, hit, slot, keep).reshape(B, E, C, D)

    h = torch.einsum("becd,edf->becf", buf, p["wi"])         # (B,E,C,2ff)
    gate, up = h.chunk(2, dim=-1)
    h = activation(gate, cfg.act) * up
    out_e = torch.einsum("becf,efd->becd", h, p["wo"])
    out_flat = out_e.reshape(B, E * C, D)

    contrib = _slots_to_pairs(out_flat, slot, keep, src, hit)
    contrib = contrib * sw.to(x.dtype)[..., None]
    # un-sort through the inverse permutation; a token's K choices are then
    # adjacent and summed
    inv = torch.argsort(order, dim=-1)
    contrib = torch.take_along_dim(contrib, inv[..., None], dim=1)
    out = contrib.reshape(B, S, K, D).sum(dim=2)

    if "shared" in p:
        out = out + mlp_apply(p["shared"], x, cfg.act)
    return out, aux
