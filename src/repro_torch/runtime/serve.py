"""Serving runtime: prefill and decode steps over the shortcut view or the
paged cache (twin of ``repro/runtime/serve.py``).

Two decode paths, the paper's two access paths:

  * **shortcut** (:func:`make_serve_step`): decode over the contiguous
    per-sequence view ``(L, B, KV, S_cap, hd)``; a token's position is
    address arithmetic.
  * **paged** (:func:`make_paged_serve_step`): decode through the block
    table; on CUDA the decode kernel reads the pools in place, on the CPU
    each layer's context is gathered first.

Per-shard decode states (:func:`shard_decode_state` /
:func:`merge_decode_states`): row ``b`` belongs to shard ``b % N``, the
partition of ``ShortcutKVManager``.

The shortcut step writes the new token's K/V row into the state's view, and
the new SSM conv window and state into its SSM members, **in place** and
returns the same tensors: it consumes its input state, as the reference's
jitted step does with donated buffers, instead of cloning the whole view
each step.  The paged step serves attention-only models: the reference's
passes no SSM state (``ssm=()``), so its SSM decode cannot run there, and
the port raises instead.

:func:`decode_state_struct` gives the state as meta tensors (the dry run's
stand-in), :func:`decode_state_names` its logical dimension names and
:func:`decode_state_specs` their specs on a mesh shape
(``distributed/sharding.py``).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Sequence

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kvcache import paged_cache as pc
from repro_torch.models import model as M
from repro_torch.models import ssm as ssm_mod


class DecodeState(NamedTuple):
    """Decode-time state.  Unused members are () (no view_k for a pure SSM
    model, no ssm_* without an SSM)."""
    view_k: Any           # (L, B, KV, S_cap, hd) or ()
    view_v: Any
    ssm_conv: Any         # (L, B, d_conv-1, conv_dim) model dtype, or ()
    ssm_state: Any        # (L, B, H, P, N) float32, or ()
    ctx_len: torch.Tensor  # (B,) int32 tokens already in the cache


def decode_state_init(cfg: ArchConfig, batch: int, s_cap: int,
                      dtype=torch.bfloat16, *, device=None) -> DecodeState:
    """A zero state on ``device`` (default ``"cuda"``)."""
    return _decode_state(cfg, batch, s_cap, dtype, resolve_device(device))


def decode_state_struct(cfg: ArchConfig, batch: int, s_cap: int,
                        dtype=torch.bfloat16) -> DecodeState:
    """The state's shapes and dtypes as meta tensors, which hold no storage
    (the dry run's stand-in, the reference's ``ShapeDtypeStruct``s)."""
    return _decode_state(cfg, batch, s_cap, dtype, torch.device("meta"))


def decode_state_names(cfg: ArchConfig) -> DecodeState:
    """Logical dimension names parallel to :func:`decode_state_struct`
    (``distributed/sharding.py``)."""
    vk = vv = sc = ss = ()
    if cfg.has_attention:
        vk = vv = ["layer", "batch", "kv_heads", "ctx", "head_dim"]
    if cfg.has_ssm:
        sc = ["layer", "batch", None, "ssm_inner"]
        ss = ["layer", "batch", "ssm_heads", None, None]
    return DecodeState(view_k=vk, view_v=vv, ssm_conv=sc, ssm_state=ss,
                       ctx_len=["batch"])


def decode_state_specs(cfg: ArchConfig, struct: DecodeState, mesh,
                       rules=None) -> DecodeState:
    """The partition spec of each member of ``struct`` on ``mesh`` (axis
    name -> size), () for an unused member."""
    from repro_torch.distributed import sharding as shd
    return shd.shardings_for(struct, decode_state_names(cfg), mesh, rules)


def _decode_state(cfg: ArchConfig, batch: int, s_cap: int, dtype,
                  dev: torch.device) -> DecodeState:
    L = cfg.num_layers
    vk = vv = sc = ss = ()
    if cfg.has_attention:
        shape = (L, batch, cfg.num_kv_heads, s_cap, cfg.resolved_head_dim)
        vk = torch.zeros(shape, dtype=dtype, device=dev)
        vv = torch.zeros(shape, dtype=dtype, device=dev)
    if cfg.has_ssm:
        conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_state
        sc = torch.zeros((L, batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                         device=dev)
        ss = torch.zeros((L, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                          cfg.ssm_state), dtype=torch.float32, device=dev)
    return DecodeState(
        view_k=vk, view_v=vv, ssm_conv=sc, ssm_state=ss,
        ctx_len=torch.zeros((batch,), dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# Per-shard decode states.
# ---------------------------------------------------------------------------

def _take_rows(x, sl, axis: int):
    """Slice the batch axis of a state member (() stays ())."""
    if isinstance(x, tuple):
        return ()
    return x[(slice(None),) * axis + (sl,)]


def shard_decode_state(state: DecodeState,
                       num_shards: int) -> "list[DecodeState]":
    """Split a whole-batch state into ``num_shards`` states; shard ``s``
    owns rows ``s, s + N, s + 2N, ...`` (``ShortcutKVManager``'s
    ``seq_id % N``).  Each member is a strided view of the whole-batch
    tensor; an in-place serve step on a shard writes through to it."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    return [DecodeState(
        view_k=_take_rows(state.view_k, slice(s, None, num_shards), 1),
        view_v=_take_rows(state.view_v, slice(s, None, num_shards), 1),
        ssm_conv=_take_rows(state.ssm_conv, slice(s, None, num_shards), 1),
        ssm_state=_take_rows(state.ssm_state, slice(s, None, num_shards), 1),
        ctx_len=state.ctx_len[s::num_shards])
        for s in range(num_shards)]


def merge_decode_states(states: "Sequence[DecodeState]") -> DecodeState:
    """Inverse of :func:`shard_decode_state`: interleave the per-shard rows
    back into one whole-batch state (row ``b`` from shard ``b % N``), as new
    tensors."""
    num_shards = len(states)
    if num_shards == 1:
        return states[0]
    total = sum(int(st.ctx_len.shape[0]) for st in states)
    dev = states[0].ctx_len.device
    order = torch.cat([torch.arange(s, total, num_shards, device=dev)
                       for s in range(num_shards)])
    inv = torch.empty_like(order)
    inv[order] = torch.arange(total, device=dev)

    def merge(parts, axis):
        if isinstance(parts[0], tuple):
            return ()
        return torch.cat(list(parts), dim=axis).index_select(axis, inv)

    return DecodeState(
        view_k=merge([st.view_k for st in states], 1),
        view_v=merge([st.view_v for st in states], 1),
        ssm_conv=merge([st.ssm_conv for st in states], 1),
        ssm_state=merge([st.ssm_state for st in states], 1),
        ctx_len=merge([st.ctx_len for st in states], 0))


# ---------------------------------------------------------------------------
# Prefill.
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: ArchConfig, s_cap: int,
                      dtype=torch.bfloat16) -> Callable:
    """(params, batch) -> (last-position logits, DecodeState).

    Runs the full forward once, then lays the per-layer caches out as the
    S_cap-padded shortcut view (the serving layer's *create request*) and
    keeps the SSM conv windows (in ``dtype``) and float32 states.  The
    context counts a PaliGemma prefix: ``ctx_len`` is ``prefix_len`` + the
    prompt's tokens, as the reference's is."""

    def prefill(params, batch):
        logits, caches = M.prefill_forward(params, cfg, batch)
        B, S = logits.shape[0], _prompt_len(cfg, batch)
        if S > s_cap:
            raise ValueError(f"prompt of {S} tokens > s_cap {s_cap}")
        dev = logits.device
        views = [(), ()]
        if cfg.has_attention:
            L, _, _, KV, hd = caches.k.shape
            for j, c in enumerate((caches.k, caches.v)):
                views[j] = torch.zeros((L, B, KV, s_cap, hd), dtype=dtype,
                                       device=dev)
                views[j][:, :, :, :S] = c.transpose(2, 3)
        sc = ss = ()
        if cfg.has_ssm:
            sc, ss = caches.ssm.conv.to(dtype), caches.ssm.state
        ctx_len = torch.full((B,), S, dtype=torch.int32, device=dev)
        return logits, DecodeState(view_k=views[0], view_v=views[1],
                                   ssm_conv=sc, ssm_state=ss, ctx_len=ctx_len)
    return prefill


def _prompt_len(cfg: ArchConfig, batch: dict) -> int:
    """Positions in the context after prefill: the prompt's tokens or
    embeddings, and a prefix model's ``prefix_len`` in front of them."""
    if cfg.input_mode == "embeddings":
        return int(batch["embeddings"].shape[1])
    n = int(batch["tokens"].shape[1])
    return n + cfg.prefix_len if cfg.input_mode == "prefix_embeddings" else n


def _write_row(view: torch.Tensor, idx: torch.Tensor,
               new: torch.Tensor) -> None:
    """view (L,B,KV,S,hd)[:, b, :, idx[b]] <- new (L,B,KV,hd), in place.

    A row whose view is full (``idx[b] >= S``) is left as it is, as the
    reference's ``put_along_axis`` drops that write: the index is clamped
    and the old row written back, so no index leaves the view (on the card
    that would be a device-side assert) and nothing waits on the host."""
    S = view.shape[3]
    idx = idx.long()
    b = torch.arange(view.shape[1], device=view.device)
    safe = idx.clamp(max=S - 1)
    fits = (idx < S)[:, None, None, None]
    view[:, b, :, safe] = torch.where(
        fits, new.to(view.dtype).transpose(0, 1), view[:, b, :, safe])


# ---------------------------------------------------------------------------
# Decode: shortcut path.
# ---------------------------------------------------------------------------

def make_serve_step(cfg: ArchConfig) -> Callable:
    """(params, state, token (B,)) -> (next_token (B,) int32, state).

    The shortcut decode: attention reads the contiguous view, then the new
    token's K/V row goes into position ``ctx_len`` of each sequence, and
    the new SSM conv window and state over the old ones, in place: the
    returned state shares the input's tensors."""

    def serve_step(params, state: DecodeState, token: torch.Tensor):
        ssm = ssm_mod.SSMCache(conv=state.ssm_conv, state=state.ssm_state) \
            if cfg.has_ssm else ()
        ctx = M.LayerCache(k=state.view_k, v=state.view_v, ssm=ssm)
        ctx_len_inc = state.ctx_len + 1         # includes the current token
        logits, new = M.decode_step(params, cfg, token, ctx, ctx_len_inc)
        if cfg.has_attention:
            _write_row(state.view_k, state.ctx_len, new.k)
            _write_row(state.view_v, state.ctx_len, new.v)
        if cfg.has_ssm:
            state.ssm_conv.copy_(new.ssm.conv)
            state.ssm_state.copy_(new.ssm.state)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, state._replace(ctx_len=ctx_len_inc)
    return serve_step


# ---------------------------------------------------------------------------
# Decode: paged (traditional) path.
# ---------------------------------------------------------------------------

def make_paged_serve_step(cfg: ArchConfig) -> Callable:
    """(params, cache: PagedKVCache, token, seq_ids) -> (next_token, cache).

    Attention reads the pools through the sequences' block tables (on CUDA
    the decode kernel, in place; on the CPU a per-layer gather, which
    ``paged_cache.gather_context`` computes for all layers at once); the new
    rows are appended with ``paged_cache.append_tokens`` (copy-on-write, as
    everywhere in the paged cache).  Attention-only models: a model with an
    SSM raises ``NotImplementedError`` (the paged cache holds no SSM state;
    the reference's paged step passes none, and its SSM decode fails)."""
    if cfg.has_ssm:
        raise NotImplementedError(
            f"{cfg.name}: the paged route serves attention-only models; "
            "its SSM state has no place in the paged cache (serve it with "
            "make_serve_step)")

    def serve_step(params, cache: pc.PagedKVCache, token: torch.Tensor,
                   seq_ids: torch.Tensor):
        seq_ids = torch.as_tensor(seq_ids, device=cache.device).long()
        ctx = M.PagedContext(k_pool=cache.k_pool, v_pool=cache.v_pool,
                             block_tables=cache.block_tables[seq_ids])
        ctx_len_inc = cache.seq_lens[seq_ids] + 1
        logits, new = M.decode_step(params, cfg, token, ctx, ctx_len_inc)
        cache = pc.append_tokens(cache, seq_ids, new.k, new.v)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, cache
    return serve_step
