"""Decode attention through the block-table indirection (twin of
``repro/kernels/paged_attention.py``): the "traditional directory" path.

Each K/V row's address is data: ``pool[block_tables[b, t // bs]]``.  On a
CUDA tensor it launches ``csrc/decode_attention.cu`` (the paged
instantiation of the split-K decode kernel and its combine, which reads a
token's table entry and then its row, and skips entries of -1); on a CPU
tensor it runs ``ref.paged_attention_ref``.  Both give the TPU kernel's
answer.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _decode, ref


def paged_attention(q, k_pool, v_pool, block_tables, seq_lens, *,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, KV, G, hd); pools: (nblocks, KV, bs, hd), any strides with a
    contiguous last axis; block_tables: (B, MB) int32, -1 unset; seq_lens:
    (B,).  Returns (B, KV, G, hd) in q's dtype."""
    return attend(q, k_pool, v_pool, block_tables, seq_lens, softcap=softcap)


def attend(q, k_pool, v_pool, block_tables, seq_lens, *,
           window: Optional[int] = None, softcap: Optional[float] = None,
           k_new=None, v_new=None) -> torch.Tensor:
    """:func:`paged_attention` with a window (which the TPU kernel lacks;
    the model's local layers need it) and the self row ``k_new``/``v_new``
    (B, KV, hd), folded in as in ``shortcut_attention.attend``."""
    _decode.check_shapes(q, k_pool, v_pool, "k_pool")
    ref._check_window(window)
    block_tables = torch.as_tensor(block_tables, device=q.device)
    seq_lens = torch.as_tensor(seq_lens, device=q.device)
    if block_tables.dim() != 2 or block_tables.shape[0] != q.shape[0]:
        raise ValueError(f"block_tables {tuple(block_tables.shape)} for a "
                         f"batch of {q.shape[0]}")
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pool, v_pool, block_tables,
                                       seq_lens, softcap=softcap,
                                       window=window, k_new=k_new,
                                       v_new=v_new)
    return _decode.launch("paged_attention", q, k_pool, v_pool, seq_lens,
                          block_tables, k_pool.shape[2], window, softcap,
                          k_new, v_new)
