"""Grouped-query attention (twin of ``repro/models/attention.py``).

Prefill attention, :func:`blockwise_attention`, has two routes with one
function: on a CUDA tensor it is ``ops.mha_forward``, which launches the
hand-written flash kernel (``kernels/csrc/flash_attention.cu``); on a CPU
tensor it is :func:`loop_attention`, the port of the reference's
triangular-blockwise loop, an online softmax over only the key tiles each
query tile's causal (and window) footprint touches.  The reference calls
that loop the jnp oracle of its Pallas ``flash_attention``; both compute the
same function.

Training attends through :func:`loop_attention` on either device, under
autograd, as the reference differentiates its loop: the flash kernel has no
backward pass and refuses inputs that require a gradient.

Decode attention, :func:`context_attention`, also dispatches by device.  On
a CUDA tensor it is the split-K decode kernel (``kernels/csrc/
decode_attention.cu``): ``ops.decode_shortcut`` over the layer's view, or
``ops.decode_paged`` over its pools through the block tables, with the
current token's K/V row folded in by the kernel's combine.  On a CPU tensor
it is :func:`decode_attention`, the reference's XLA computation in plain
PyTorch, over the view or over the context gathered through the tables.

A meta tensor takes the CUDA branch of both: the kernel wrappers record
the call's cost for ``launch/op_cost`` and launch nothing (the dry run).

Supports GQA/MQA, rope, qk-norm (qwen3), the attention logit softcap
(gemma2), sliding windows, per-layer local/global switching and the
bidirectional prefix (PaliGemma, ``prefix_len > 0``).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import _dense_init, apply_rope, rms_norm, softcap

_NEG_INF = -1e30

#: the profiler span around :func:`loop_attention`
LOOP_SPAN = "repro_torch.attention.loop"


def attn_init(gen: torch.Generator, cfg, dtype, device) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": _dense_init(gen, (d, h * hd), d, dtype, device),
        "wk": _dense_init(gen, (d, kv * hd), d, dtype, device),
        "wv": _dense_init(gen, (d, kv * hd), d, dtype, device),
        "wo": _dense_init(gen, (h * hd, d), h * hd, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
    return p


def qkv_project(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,KV,hd), rope applied."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(B, S, cfg.num_heads, hd)
    k = (x @ p["wk"]).reshape(B, S, cfg.num_kv_heads, hd)
    v = (x @ p["wv"]).reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _padding(cfg):
    KV = cfg.num_kv_heads
    G = cfg.num_heads // KV
    return KV, G, cfg.pad_kv_heads or KV, cfg.pad_q_groups or G


def pad_heads(q, k, v, cfg):
    """Zero-pad q-groups / kv-heads to the configured counts.

    q: (B,S,H,hd) with H = KV*G -> (B,S,KVp*Gp,hd); k/v: (B,S,KV,hd) ->
    (B,S,KVp,hd).  Dead q-heads score zeros and their outputs are dropped by
    :func:`unpad_heads` before ``wo``; dead kv-heads form whole dead groups,
    so live outputs are unchanged."""
    KV, G, KVp, Gp = _padding(cfg)
    if (KVp, Gp) == (KV, G):
        return q, k, v, cfg.num_heads
    B, S, H, hd = q.shape
    qg = F.pad(q.reshape(B, S, KV, G, hd), (0, 0, 0, Gp - G, 0, KVp - KV))
    k = F.pad(k, (0, 0, 0, KVp - KV))
    v = F.pad(v, (0, 0, 0, KVp - KV))
    return qg.reshape(B, S, KVp * Gp, hd), k, v, KVp * Gp


def unpad_heads(o, cfg):
    """Drop dead heads: (B,S,KVp*Gp,hd) -> (B,S,H,hd)."""
    KV, G, KVp, Gp = _padding(cfg)
    if (KVp, Gp) == (KV, G):
        return o
    B, S, _, hd = o.shape
    og = o.reshape(B, S, KVp, Gp, hd)[:, :, :KV, :G]
    return og.reshape(B, S, KV * G, hd)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        chunk_q: int, chunk_kv: int, causal: bool = True,
                        window: Optional[int] = None,
                        attn_softcap: Optional[float] = None,
                        prefix_len: int = 0) -> torch.Tensor:
    """Flash-style attention.  q: (B,Sq,H,hd), k/v: (B,Skv,KV,hd) ->
    (B,Sq,H,hd) in q's dtype.

    ``prefix_len`` marks a bidirectional prefix (PaliGemma image tokens):
    positions < prefix_len attend to the whole prefix regardless of order.
    On CUDA this is the flash kernel, and ``chunk_q``/``chunk_kv`` (the
    reference's XLA tiles) do not apply: its prefix mask is the one above
    on absolute positions.  On the CPU it is :func:`loop_attention`, whose
    prefix mask is the reference's (see there); at ``chunk_q >= prefix_len``
    (PaliGemma's 2048 against 256) the two agree."""
    if q.device.type in ("cuda", "meta"):
        return ops.mha_forward(q, k, v, causal=causal, window=window,
                               softcap=attn_softcap, prefix_len=prefix_len)
    return loop_attention(q, k, v, chunk_q=chunk_q, chunk_kv=chunk_kv,
                          causal=causal, window=window,
                          attn_softcap=attn_softcap, prefix_len=prefix_len)


def _tile_mask(q_pos, kp, causal: bool, window: Optional[int],
               prefix_len: int) -> torch.Tensor:
    """(chunk_q, chunk_kv) bool: which keys at positions ``kp`` the queries
    at ``q_pos`` see."""
    mask = torch.ones((q_pos.shape[0], kp.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        cm = q_pos[:, None] >= kp[None, :]
        if prefix_len:
            cm = cm | ((q_pos[:, None] < prefix_len)
                       & (kp[None, :] < prefix_len))
        mask &= cm
    if window is not None:
        wm = kp[None, :] > (q_pos[:, None] - window)
        if prefix_len:
            wm = wm | (kp[None, :] < prefix_len)
        mask &= wm
    return mask


def loop_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   chunk_q: int, chunk_kv: int, causal: bool = True,
                   window: Optional[int] = None,
                   attn_softcap: Optional[float] = None,
                   prefix_len: int = 0) -> torch.Tensor:
    """The reference's triangular-blockwise loop in plain PyTorch, on any
    device and under autograd: q: (B,Sq,H,hd), k/v: (B,Skv,KV,hd) ->
    (B,Sq,H,hd) in q's dtype.

    Each query tile of ``chunk_q`` rows runs an online softmax over the key
    tiles of ``chunk_kv`` that its causal (and window) footprint touches,
    each tile computed in full and masked.  The arithmetic is the
    reference's: scores from float32 products of q (scaled in its own
    dtype) and k, and p rounded to v's dtype before P V in float32.  The
    reference also rematerializes each query tile in its backward; here the
    model's per-layer remat bounds the memory instead.

    The prefix mask is the reference's, which depends on the tiles: a query
    tile's key range ends at its own last row (rounded up to ``chunk_kv``),
    so with ``chunk_q < prefix_len`` the rows of a tile that ends before the
    prefix does miss the prefix keys past that range."""
    with torch.profiler.record_function(LOOP_SPAN):
        return _loop_attention(q, k, v, chunk_q, chunk_kv, causal, window,
                               attn_softcap, prefix_len)


def _loop_attention(q, k, v, chunk_q, chunk_kv, causal, window,
                    attn_softcap, prefix_len):
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    if Sq % chunk_q:
        chunk_q = Sq
    if Skv % chunk_kv:
        chunk_kv = Skv
    qg = q.reshape(B, Sq, KV, G, hd) * hd ** -0.5
    outs = []
    for i in range(Sq // chunk_q):
        q_blk = qg[:, i * chunk_q:(i + 1) * chunk_q].float()
        q_pos = i * chunk_q + torch.arange(chunk_q, device=q.device)
        hi = min(Skv, (i + 1) * chunk_q) if causal else Skv
        hi = math.ceil(hi / chunk_kv) * chunk_kv
        lo = 0
        if window is not None and causal:
            lo = max(0, (i * chunk_q - window)) // chunk_kv * chunk_kv
            if prefix_len:
                lo = 0  # the prefix is always visible
        m = torch.full((B, KV, G, chunk_q), _NEG_INF, device=q.device)
        l = torch.zeros((B, KV, G, chunk_q), device=q.device)
        acc = torch.zeros((B, KV, G, chunk_q, hd), device=q.device)
        for c0 in range(lo, hi, chunk_kv):
            kt, vt = k[:, c0:c0 + chunk_kv], v[:, c0:c0 + chunk_kv]
            kp = c0 + torch.arange(chunk_kv, device=q.device)
            s = torch.einsum("bqkgd,bckd->bkgqc", q_blk, kt.float())
            if attn_softcap is not None:
                s = softcap(s, attn_softcap)
            mask = _tile_mask(q_pos, kp, causal, window, prefix_len)
            s = torch.where(mask, s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            # p rounds to the value dtype first, as the reference's einsum
            # takes it
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqc,bckd->bkgqd", p.to(vt.dtype).float(), vt.float())
            m = m_new
        o = acc / l.clamp_min(1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, chunk_q, H, hd))
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention(q: torch.Tensor, k_ctx: torch.Tensor,
                     v_ctx: torch.Tensor, ctx_len: torch.Tensor, *,
                     k_new: Optional[torch.Tensor] = None,
                     v_new: Optional[torch.Tensor] = None,
                     attn_softcap: Optional[float] = None,
                     window: Optional[int] = None) -> torch.Tensor:
    """One-token attention over a materialized context, in plain PyTorch.

    q: (B, H, hd); k_ctx/v_ctx: (B, KV, S, hd) (attention-native layout)
    hold the *old* tokens at positions [0, ctx_len-1).  ``k_new``/``v_new``
    (B, KV, hd) are the current token's projections, folded in by a split
    softmax (``ctx_len`` counts the new token), which saves concatenating a
    copy of the context.  Products take float32 operands (exact for
    bfloat16), as the reference's ``preferred_element_type`` sums in
    float32.

    The float32 copies of the context are contiguous, so the products see
    one layout whatever the caller's strides: the paged route's gathered
    context is a strided view, the card sums a product of strided operands
    in another order, and the last bits that moves flip greedy tokens where
    two logits tie in bfloat16."""
    B, H, hd = q.shape
    KV, S = k_ctx.shape[1], k_ctx.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd) * hd ** -0.5
    pos = torch.arange(S, device=q.device)[None]            # (1, S)
    ctx_len = ctx_len.to(q.device).long()[:, None]
    n_old = ctx_len - (0 if k_new is None else 1)
    live = pos < n_old
    if window is not None:
        live &= pos > (ctx_len - 1 - window)
    v_dtype = v_ctx.dtype
    k_ctx, v_ctx = (c.to(torch.float32, memory_format=torch.contiguous_format)
                    for c in (k_ctx, v_ctx))
    s = torch.einsum("bkgd,bksd->bkgs", qg.float(), k_ctx)
    if attn_softcap is not None:
        s = softcap(s, attn_softcap)
    s = torch.where(live[:, None, None], s, _NEG_INF)
    if k_new is None:
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgs,bksd->bkgd", p.to(v_dtype).float(), v_ctx)
        return o.reshape(B, H, hd).to(q.dtype)
    s_self = torch.einsum("bkgd,bkd->bkg", qg.float(), k_new.float())
    if attn_softcap is not None:
        s_self = softcap(s_self, attn_softcap)
    m = torch.maximum(s.amax(dim=-1), s_self)               # (B, KV, G)
    p_ctx = torch.exp(s - m[..., None])
    p_self = torch.exp(s_self - m)
    denom = p_ctx.sum(dim=-1) + p_self
    o = torch.einsum("bkgs,bksd->bkgd", p_ctx.to(v_dtype).float(), v_ctx)
    o = (o + p_self[..., None] * v_new[:, :, None].float()) / denom[..., None]
    return o.reshape(B, H, hd).to(q.dtype)


class PagedContext(NamedTuple):
    """A decode context read through block tables, the paged route's: the
    cache's pools (L, nblocks, bs, KV, hd) and the (B, MB) int32 tables of
    the sequences being decoded (-1 unset).  The old tokens' count is the
    step's ``ctx_len - 1``."""
    k_pool: Any
    v_pool: Any
    block_tables: Any


def gather_paged(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """One layer's pool (nblocks, bs, KV, hd) gathered through ``tables``
    (B, MB) into the (B, KV, MB*bs, hd) context, -1 entries reading block 0,
    as ``paged_cache.gather_context`` gathers every layer."""
    x = pool[tables.clamp_min(0).long()]            # (B, MB, bs, KV, hd)
    B, MB, bs, KV, hd = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(B, KV, MB * bs, hd)


def context_attention(q: torch.Tensor, ctx, i: int, ctx_len: torch.Tensor,
                      old_len: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor, *,
                      attn_softcap: Optional[float] = None,
                      window: Optional[int] = None) -> torch.Tensor:
    """Layer ``i``'s one-token attention over the decode context ``ctx``:
    a ``LayerCache``-like pair of (L, B, KV, S, hd) views (the shortcut
    route) or a :class:`PagedContext` (the paged route).

    q: (B, H, hd); ``ctx_len`` (B,) counts the current token, ``old_len``
    (B,) int32 is ``ctx_len - 1``; k_new/v_new: (B, KV, hd), the current
    token's projections.  On CUDA the decode kernel reads the view or the
    pools in place and folds the current token in; on the CPU
    :func:`decode_attention` runs over the view or the gathered context."""
    paged = isinstance(ctx, PagedContext)
    if q.device.type in ("cuda", "meta"):
        if paged:
            return ops.decode_paged(
                q, ctx.k_pool[i], ctx.v_pool[i], ctx.block_tables, old_len,
                softcap=attn_softcap, window=window, k_new=k_new,
                v_new=v_new)
        return ops.decode_shortcut(
            q, ctx.k[i].transpose(1, 2), ctx.v[i].transpose(1, 2), old_len,
            window=window, softcap=attn_softcap, k_new=k_new, v_new=v_new)
    if paged:
        k_ctx = gather_paged(ctx.k_pool[i], ctx.block_tables)
        v_ctx = gather_paged(ctx.v_pool[i], ctx.block_tables)
    else:
        k_ctx, v_ctx = ctx.k[i], ctx.v[i]
    return decode_attention(q, k_ctx, v_ctx, ctx_len, k_new=k_new,
                            v_new=v_new, attn_softcap=attn_softcap,
                            window=window)
