"""Decode attention over the contiguous shortcut view (twin of
``repro/kernels/shortcut_attention.py``): the "after" of the paper's
before/after.

The view is (B, KV, S_cap, hd): a token's row is address arithmetic, so the
kernel streams K/V rows with no index traffic and stops at ``ctx_len``.  On a
CUDA tensor it launches ``csrc/decode_attention.cu`` (the shortcut
instantiation of the split-K decode kernel and its combine); on a CPU tensor
it runs ``ref.decode_attention_ref``.  Both give the TPU kernel's answer,
zeros for a sequence with ``ctx_len == 0``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _decode, ref


def shortcut_attention(q, k_view, v_view, ctx_len, *,
                       window: Optional[int] = None,
                       softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, KV, G, hd); k_view/v_view: (B, KV, S_cap, hd), any strides with
    a contiguous last axis; ctx_len: (B,) live tokens, at most S_cap.
    Returns (B, KV, G, hd) in q's dtype.  The TPU kernel's ``bs`` (its tile
    length, which does not change the answer) has no counterpart: the CUDA
    kernel tiles by 64 tokens."""
    return attend(q, k_view, v_view, ctx_len, window=window, softcap=softcap)


def attend(q, k_view, v_view, ctx_len, *, window: Optional[int] = None,
           softcap: Optional[float] = None, k_new=None, v_new=None
           ) -> torch.Tensor:
    """:func:`shortcut_attention` with the self row: ``k_new``/``v_new``
    (B, KV, hd), the current token, not in the view, folded in as the last
    live position; ``ctx_len`` then counts the old tokens and the window
    counts the self row (``ref.decode_attention_ref``)."""
    _decode.check_shapes(q, k_view, v_view, "k_view")
    if k_view.shape[0] != q.shape[0]:
        raise ValueError(f"q {tuple(q.shape)} vs view {tuple(k_view.shape)}")
    ref._check_window(window)
    ctx_len = torch.as_tensor(ctx_len, device=q.device)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_view, v_view, ctx_len,
                                        window=window, softcap=softcap,
                                        k_new=k_new, v_new=v_new)
    return _decode.launch("shortcut_attention", q, k_view, v_view, ctx_len,
                          None, k_view.shape[2], window, softcap, k_new,
                          v_new)
