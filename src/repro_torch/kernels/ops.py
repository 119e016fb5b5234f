"""Entry points of the kernels in the layouts their callers use (twin of
``repro/kernels/ops.py``).  Each adapts model-layout tensors to the
kernel's layout with views only: the kernels take strides, so no pool, view
or activation is copied."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import paged_attention, shortcut_attention
from repro_torch.kernels.eh_lookup import eh_lookup, shortcut_lookup
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ragged_copy import ragged_copy


def mha_forward(q, k, v, *, causal: bool = True,
                window: Optional[int] = None,
                softcap: Optional[float] = None, prefix_len: int = 0,
                bq: int = 256, bkv: int = 512) -> torch.Tensor:
    """Model-layout flash attention.

    q: (B, S, H, hd); k/v: (B, S, KV, hd) -> (B, S, H, hd).  The kernel
    reads the transposed views in place and writes the model layout, so on
    CUDA no operand or result is copied.  ``prefix_len``: the bidirectional
    prefix (``flash_attention``)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qk = q.reshape(B, Sq, KV, H // KV, hd).permute(0, 2, 3, 1, 4)
    o = flash_attention(qk, k.transpose(1, 2), v.transpose(1, 2),
                        causal=causal, window=window, softcap=softcap,
                        prefix_len=prefix_len, bq=bq, bkv=bkv)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


def decode_shortcut(q, view_k, view_v, ctx_len, *,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    k_new=None, v_new=None) -> torch.Tensor:
    """Serve-layout shortcut decode.

    q: (B, H, hd); view_k/v: (B, S_cap, KV, hd); ctx_len: (B,).  With the
    self row ``k_new``/``v_new`` (B, KV, hd), the current token is folded
    in and ``ctx_len`` counts the old tokens only.  Returns (B, H, hd)."""
    B, H, hd = q.shape
    KV = view_k.shape[2]
    qk = q.reshape(B, KV, H // KV, hd)
    o = shortcut_attention.attend(
        qk, view_k.transpose(1, 2), view_v.transpose(1, 2), ctx_len,
        window=window, softcap=softcap, k_new=k_new, v_new=v_new)
    return o.reshape(B, H, hd)


def decode_paged(q, k_pool, v_pool, block_tables, seq_lens, *,
                 softcap: Optional[float] = None,
                 window: Optional[int] = None,
                 k_new=None, v_new=None) -> torch.Tensor:
    """Serve-layout paged decode.

    q: (B, H, hd); pools: (nblocks, bs, KV, hd) (cache layout);
    block_tables: (B, MB); seq_lens: (B,); ``window`` and the self row as in
    :func:`decode_shortcut`.  Returns (B, H, hd)."""
    B, H, hd = q.shape
    KV = k_pool.shape[2]
    qk = q.reshape(B, KV, H // KV, hd)
    o = paged_attention.attend(
        qk, k_pool.transpose(1, 2), v_pool.transpose(1, 2), block_tables,
        seq_lens, window=window, softcap=softcap, k_new=k_new, v_new=v_new)
    return o.reshape(B, H, hd)


def eh_lookup_op(keys, st, *, tile: int = 256) -> torch.Tensor:
    """Traditional fused lookup against an ``EHState``."""
    D = 1 << int(st.max_global_depth)
    return eh_lookup(keys, st.directory[:D], st.bucket_keys,
                     st.bucket_vals, st.global_depth, tile=tile)


def shortcut_lookup_op(keys, view_keys, view_vals, global_depth, *,
                       tile: int = 256) -> torch.Tensor:
    """Shortcut fused lookup against a composed view."""
    return shortcut_lookup(keys, view_keys, view_vals, global_depth,
                           tile=tile)


def remap_rows(view, pool, slots, offsets) -> torch.Tensor:
    """Maintenance replay: ``view[slots] = pool[offsets]`` in place (last
    wins); returns ``view``."""
    return ragged_copy(view, pool, slots, offsets)
