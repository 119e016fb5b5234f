"""Decoder LM (twin of ``repro/models/model.py``) for every registered
family, with three entry points:

  * :func:`train_forward`  -- full-sequence forward + chunked cross-entropy
    loss, under autograd;
  * :func:`prefill_forward` -- full-sequence forward returning the per-layer
    KV (and SSM state) caches for the serving layer;
  * :func:`decode_step`    -- one-token forward over the decode context.

A layer holds attention and/or an SSM mixer (the hybrid averages the two),
then a dense MLP, or an MoE (with arctic's parallel dense residual).
Parameters keep the reference's layout, a dictionary whose per-layer
tensors are stacked over the layer axis (``params["layers"]["attn"]["wq"]``
is (L, D, H*hd)); a layer reads views of them with no copy.  The
reference's ``lax.scan`` over layer runs becomes a plain Python loop over
the same runs (:func:`layer_runs`), its ``jax.checkpoint(nothing_saveable)``
a per-layer ``torch.utils.checkpoint``, and its ``distributed.constrain``
sharding pins have no counterpart on one card.

The input is tokens, embeddings, or (PaliGemma) ``prefix_embeddings``
in front of the tokens, a bidirectional prefix of ``cfg.prefix_len``
positions in every attention layer.  Prefill attends through the flash
kernel on CUDA; training attends through ``attention.loop_attention`` on
either device (the kernel has no backward pass).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (embed_init, grad_bf16, mlp_apply,
                                       mlp_init, rms_norm, softcap)


# -- layer kinds / runs --------------------------------------------------------

def layer_kinds(cfg: ArchConfig) -> list[str]:
    """'global' (full causal) or 'local' (sliding window) per layer."""
    L = cfg.num_layers
    if cfg.sliding_window is None:
        return ["global"] * L
    if cfg.local_global_period:
        p = cfg.local_global_period
        return ["global" if i % p == p - 1 else "local" for i in range(L)]
    if cfg.global_layers:
        return ["global" if i in cfg.global_layers else "local"
                for i in range(L)]
    return ["local"] * L


def layer_runs(cfg: ArchConfig) -> list[tuple[int, int, tuple[str, ...]]]:
    """(start, length, kinds-per-step) segments, as the reference scans
    them; the port walks their layers in order."""
    kinds = layer_kinds(cfg)
    L = cfg.num_layers
    p = cfg.local_global_period
    if p and L % p == 0:
        return [(0, L, tuple(kinds[:p]))]
    runs: list[tuple[int, int, tuple[str, ...]]] = []
    i = 0
    while i < L:
        j = i
        while j < L and kinds[j] == kinds[i]:
            j += 1
        runs.append((i, j - i, (kinds[i],)))
        i = j
    return runs


def _layer_order(cfg: ArchConfig):
    """(layer index, kind) in execution order, segmented by the runs."""
    for start, length, kinds in layer_runs(cfg):
        for i in range(length):
            yield start + i, kinds[i % len(kinds)]


# -- init ----------------------------------------------------------------------

def layer_init(gen: torch.Generator, cfg: ArchConfig, dtype, device) -> dict:
    p: dict[str, Any] = {
        "ln1": torch.zeros((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.has_attention:
        p["attn"] = attn.attn_init(gen, cfg, dtype, device)
    if cfg.has_ssm:
        p["ssm"] = ssm_mod.ssm_init(gen, cfg, dtype, device)
    if cfg.d_ff or cfg.num_experts:
        p["ln2"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    if cfg.d_ff:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device)
    if cfg.num_experts:
        p["moe"] = moe_mod.moe_init(gen, cfg, dtype, device)
    return p


def _stack_into(dst: dict, i: int, src: dict, L: int) -> None:
    """Layer ``i``'s tensors into the (L, ...) stacks, each stack of its
    layer tensor's dtype (the float32 router and SSM members stay float32)."""
    for name, t in src.items():
        if isinstance(t, dict):
            _stack_into(dst.setdefault(name, {}), i, t, L)
            continue
        if name not in dst:
            dst[name] = torch.empty((L,) + tuple(t.shape), dtype=t.dtype,
                                    device=t.device)
        dst[name][i] = t


def init_params(cfg: ArchConfig, seed: int = 0, dtype=torch.bfloat16, *,
                device=None) -> dict:
    """Random parameters drawn from ``seed`` on ``device`` (default
    ``"cuda"``), one layer at a time into the stacked tensors, so that a
    full-width init holds one layer's float32 draws at a time."""
    dev = resolve_device(device)
    return build_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                        dtype, dev)


def build_params(cfg: ArchConfig, gen: Optional[torch.Generator], dtype,
                 device: torch.device) -> dict:
    """:func:`init_params`'s body on a resolved ``device``; with ``gen``
    None on the meta device it draws nothing and allocates nothing
    (``runtime/train.param_struct``)."""
    params: dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "layers": {},
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                  device=device),
    }
    for i in range(cfg.num_layers):
        _stack_into(params["layers"], i,
                    layer_init(gen, cfg, dtype, device), cfg.num_layers)
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, cfg.vocab_size, cfg.d_model,
                                       dtype, device).T.contiguous()
    return params


def _layer(layers: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views into the stacked tensors."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


def _unbind_layers(layers: dict, L: int) -> list:
    """Every layer's parameters as views into the stacked tensors, from one
    ``torch.unbind`` per stack.  Under autograd the unbind's backward writes
    each layer's slice of the stack's gradient once; a select ``v[i]`` per
    layer would write (and add) a zero-filled gradient the size of the
    whole stack for each layer."""
    out: list = [{} for _ in range(L)]
    for name, v in layers.items():
        parts = _unbind_layers(v, L) if isinstance(v, dict) else v.unbind(0)
        for i in range(L):
            out[i][name] = parts[i]
    return out


# -- sublayer bodies -------------------------------------------------------------

class LayerCache(NamedTuple):
    """Per-layer decode cache pieces (stacked over L by the caller).  Unused
    members are () placeholders, as in the reference."""
    k: Any = ()
    v: Any = ()
    ssm: Any = ()


#: the paged route's decode context (pools and block tables)
PagedContext = attn.PagedContext


def _mix(outs: list) -> torch.Tensor:
    """One mixer's output, or the hybrid's average of attention and SSM."""
    return outs[0] if len(outs) == 1 else (outs[0] + outs[1]) * 0.5


def _mixer(lp: dict, h: torch.Tensor, cfg: ArchConfig, kind: str,
           positions: torch.Tensor, train: bool):
    """Attention and/or SSM on pre-normed input (full sequence); returns the
    new residual stream and the layer's :class:`LayerCache`: the (padded)
    k, v with attention, the ``SSMCache`` with an SSM.  ``train`` attends
    through ``attention.loop_attention`` on every device."""
    x = rms_norm(h, lp["ln1"], cfg.norm_eps)
    B, S = x.shape[:2]
    outs = []
    cache = LayerCache()
    if cfg.has_attention:
        q, k, v = attn.qkv_project(lp["attn"], x, cfg, positions)
        q, k, v, _ = attn.pad_heads(q, k, v, cfg)
        window = cfg.sliding_window if kind == "local" else None
        attend = attn.loop_attention if train else attn.blockwise_attention
        o = attend(
            q, k, v, chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv,
            causal=True, window=window, attn_softcap=cfg.attn_softcap,
            prefix_len=cfg.prefix_len)
        o = attn.unpad_heads(o, cfg)
        outs.append(o.reshape(B, S, -1) @ lp["attn"]["wo"])
        cache = cache._replace(k=k, v=v)
    if cfg.has_ssm:
        o, ssm_cache = ssm_mod.ssm_apply(lp["ssm"], x, cfg)
        outs.append(o)
        cache = cache._replace(ssm=ssm_cache)
    return h + grad_bf16(_mix(outs)), cache


def _ffn(lp: dict, h: torch.Tensor, cfg: ArchConfig):
    """MLP or MoE (+ arctic's parallel dense residual); returns the new
    residual stream and the router's auxiliary loss (None without MoE)."""
    aux = None
    if not (cfg.d_ff or cfg.num_experts):
        return h, aux
    x = rms_norm(h, lp["ln2"], cfg.norm_eps)
    if cfg.num_experts:
        out, aux = moe_mod.moe_apply(lp["moe"], x, cfg)
        if cfg.dense_residual and cfg.d_ff:
            out = out + mlp_apply(lp["mlp"], x, cfg.act)
    else:
        out = mlp_apply(lp["mlp"], x, cfg.act)
    return h + grad_bf16(out), aux


def _sublayer(lp: dict, h: torch.Tensor, cfg: ArchConfig, kind: str,
              positions: torch.Tensor, train: bool):
    """One layer: (new residual stream, its LayerCache, its aux or None)."""
    h, cache = _mixer(lp, h, cfg, kind, positions, train)
    h, aux = _ffn(lp, h, cfg)
    return h, cache, aux


# -- full-sequence forward -------------------------------------------------------

def _embed_tokens(params, tokens) -> torch.Tensor:
    """The embedding rows of ``tokens``.  ``F.embedding``'s backward sums
    each row's cotangents in a fixed order on either device, so that
    training is reproducible bit for bit; an indexing gather's backward
    (``index_put_`` with accumulate) may sum in any order on the CPU."""
    tokens = torch.as_tensor(tokens, device=params["embed"].device)
    return F.embedding(tokens.long(), params["embed"])


def _embed_inputs(params, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    if cfg.input_mode == "tokens":
        return _embed_tokens(params, batch["tokens"])
    if cfg.input_mode == "embeddings":
        return batch["embeddings"].to(params["embed"].dtype)
    if cfg.input_mode == "prefix_embeddings":
        tok = _embed_tokens(params, batch["tokens"])
        prefix = torch.as_tensor(batch["prefix_embeddings"],
                                 device=tok.device).to(tok.dtype)
        return torch.cat([prefix, tok], dim=1)
    raise ValueError(cfg.input_mode)


def _stacked(t: torch.Tensor, L: int) -> torch.Tensor:
    return torch.empty((L,) + tuple(t.shape), dtype=t.dtype, device=t.device)


def forward_hidden(params, cfg: ArchConfig, batch: dict, *,
                   want_cache: bool = False, remat: bool = True,
                   train: bool = False):
    """Embed + all layers + final norm.  Returns (hidden (B,S,D), caches,
    aux_total): with ``want_cache`` a :class:`LayerCache` of (L, B, S, KVp,
    hd) k and v (with attention) and an ``SSMCache`` of (L, B, d_conv-1,
    conv_dim) conv windows and (L, B, H, P, N) float32 states (with an
    SSM), else None; ``aux_total`` the router's auxiliary loss summed over
    the layers, () float32.

    With ``remat``, where a gradient is recorded, each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant): the backward keeps only the
    layers' inputs and recomputes each layer, as the reference's
    ``jax.checkpoint(nothing_saveable)`` does.  ``train`` attends through
    ``attention.loop_attention`` (:func:`train_forward` sets it)."""
    h = _embed_inputs(params, cfg, batch)
    B, S = h.shape[:2]
    L = cfg.num_layers
    positions = torch.arange(S, device=h.device)[None]
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    caches = None
    layers = _unbind_layers(params["layers"], L)
    remat = remat and torch.is_grad_enabled()
    for i, kind in _layer_order(cfg):
        if remat:
            h, cache, aux = checkpoint(_sublayer, layers[i], h, cfg, kind,
                                       positions, train, use_reentrant=False)
        else:
            h, cache, aux = _sublayer(layers[i], h, cfg, kind, positions,
                                      train)
        if aux is not None:
            aux_total = aux_total + aux
        if want_cache:
            if caches is None:
                caches = LayerCache(
                    k=_stacked(cache.k, L) if cfg.has_attention else (),
                    v=_stacked(cache.v, L) if cfg.has_attention else (),
                    ssm=ssm_mod.SSMCache(*(_stacked(c, L) for c in cache.ssm))
                    if cfg.has_ssm else ())
            if cfg.has_attention:
                caches.k[i] = cache.k
                caches.v[i] = cache.v
            if cfg.has_ssm:
                caches.ssm.conv[i] = cache.ssm.conv
                caches.ssm.state[i] = cache.ssm.state
    return rms_norm(h, params["final_norm"], cfg.norm_eps), caches, aux_total


def _logits(params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    out = h @ head
    if cfg.final_softcap:
        out = softcap(out, cfg.final_softcap)
    return out


def chunked_softmax_xent(params, cfg: ArchConfig, h: torch.Tensor,
                         labels: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Cross-entropy without materializing (B, S, V) at once: a loop over
    ``cfg.loss_chunk`` positions (all S when it does not divide S), float32
    logits a chunk.  The gold logit is a gather, which equals the
    reference's masked sum over the vocabulary (the other terms are
    zeros)."""
    B, S, D = h.shape
    chunk = min(cfg.loss_chunk, S)
    if S % chunk:
        chunk = S
    labels = labels.long()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, chunk):
        logits = _logits(params, cfg, h[:, c0:c0 + chunk]).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[:, c0:c0 + chunk, None])[..., 0]
        nll = (lse - gold) * mask[:, c0:c0 + chunk]
        total = total + nll.sum()
    return total / mask.sum().clamp_min(1.0)


def train_forward(params, cfg: ArchConfig, batch: dict, *,
                  remat: bool = True) -> torch.Tensor:
    """The scalar float32 loss.  ``batch``: tokens, embeddings or tokens
    behind ``prefix_embeddings``; ``labels``; optional ``loss_mask``.  A
    prefix model's loss covers only the tokens after its prefix; the
    router's auxiliary loss adds with ``cfg.router_aux_weight``."""
    h, _, aux = forward_hidden(params, cfg, batch, remat=remat, train=True)
    labels = torch.as_tensor(batch["labels"], device=h.device)
    if cfg.input_mode == "prefix_embeddings":  # loss only on the suffix
        h = h[:, cfg.prefix_len:]
    mask = batch.get("loss_mask")
    mask = torch.ones(labels.shape, dtype=torch.float32, device=h.device) \
        if mask is None else torch.as_tensor(mask, device=h.device).float()
    loss = chunked_softmax_xent(params, cfg, h, labels, mask)
    return loss + cfg.router_aux_weight * aux


# -- prefill -----------------------------------------------------------------

@torch.no_grad()
def prefill_forward(params, cfg: ArchConfig, batch: dict):
    """Full forward returning (last-position logits, stacked caches)."""
    h, caches, _ = forward_hidden(params, cfg, batch, want_cache=True)
    return _logits(params, cfg, h[:, -1]), caches


# -- decode --------------------------------------------------------------------

@torch.no_grad()
def decode_step(params, cfg: ArchConfig, token: torch.Tensor,
                ctx, ctx_len: torch.Tensor, *,
                positions: Optional[torch.Tensor] = None):
    """One-token decode.

    token:   (B,) int current input token.
    ctx:     the old tokens' context, either a :class:`LayerCache` of
             stacked per-layer views k/v (L, B, KV, S_ctx, hd) (old tokens
             live in [0, ctx_len-1); the shortcut route) and, with an SSM,
             an ``SSMCache`` of the stacked conv windows and states; or a
             :class:`PagedContext` of the cache's pools and the sequences'
             block tables (the paged route, attention only).
    ctx_len: (B,) context length INCLUDING the new token.
    positions: (B,) rope position of the new token; default ``ctx_len - 1``
             (a caller passes another only to show that a wrong one moves
             the logits).

    On CUDA each attention layer attends through the decode kernel, which
    reads the views or the pools in place; on the CPU through the plain
    ``decode_attention`` (``attention.context_attention``).

    Returns (logits (B, V), LayerCache of the new token's (L, B, KV, hd)
    k/v rows (with attention) and the stacked new ``SSMCache`` (with an
    SSM); absent members ()).  The caller appends the rows into its pool
    (paged) or view (shortcut) and keeps the SSM cache.  With a prefix
    (PaliGemma) ``ctx_len`` counts it: a decode token sits past the prefix,
    so its attention is plain causal."""
    dev = params["embed"].device
    token = torch.as_tensor(token, device=dev).long()
    ctx_len = torch.as_tensor(ctx_len, device=dev)
    old_len = (ctx_len - 1).to(torch.int32)
    h = params["embed"][token][:, None]                     # (B, 1, D)
    if positions is None:
        positions = ctx_len - 1
    positions = torch.as_tensor(positions, device=dev)[:, None]
    kinds = layer_kinds(cfg)
    B, L = token.shape[0], cfg.num_layers
    new_k, new_v = [None] * L, [None] * L
    new_conv, new_state = [None] * L, [None] * L
    for i, _ in _layer_order(cfg):
        lp = _layer(params["layers"], i)
        x = rms_norm(h, lp["ln1"], cfg.norm_eps)
        outs = []
        if cfg.has_attention:
            q, k, v = attn.qkv_project(lp["attn"], x, cfg, positions)
            window = cfg.sliding_window if kinds[i] == "local" else None
            o = attn.context_attention(
                q[:, 0], ctx, i, ctx_len, old_len, k[:, 0], v[:, 0],
                attn_softcap=cfg.attn_softcap, window=window)
            outs.append((o.reshape(B, -1) @ lp["attn"]["wo"])[:, None])
            new_k[i], new_v[i] = k[:, 0], v[:, 0]
        if cfg.has_ssm:
            o, (new_conv[i], new_state[i]) = ssm_mod.ssm_decode(
                lp["ssm"], x[:, 0],
                ssm_mod.SSMCache(ctx.ssm.conv[i], ctx.ssm.state[i]), cfg)
            outs.append(o[:, None])
        h, _ = _ffn(lp, h + _mix(outs), cfg)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, h[:, 0])
    new = LayerCache()
    if cfg.has_attention:
        new = new._replace(k=torch.stack(new_k), v=torch.stack(new_v))
    if cfg.has_ssm:
        new = new._replace(ssm=ssm_mod.SSMCache(
            conv=torch.stack(new_conv), state=torch.stack(new_state)))
    return logits, new
