"""Plain PyTorch versions of the kernels (twin of ``repro/kernels/ref.py``).

The CPU path of every wrapper runs these, the tests hold the kernels to
them, and ``chip_smoke.py`` compares each kernel with its plain version on
the card.  Nothing on the CUDA path calls them.  They are vectorized
gathers, chunked over keys so that a full-size lookup stays within memory.
"""
from __future__ import annotations

import torch

from repro_torch.core import hashing

#: keys per chunk of the vectorized probe: (chunk, S) int64 temporaries
LOOKUP_CHUNK = 1 << 16


def lookup_ref(keys, directory, bucket_keys, bucket_vals, global_depth,
               count_probed: bool = False):
    """Hash -> (directory ->) bucket row -> first-empty-terminated probe.
    ``directory=None`` is the shortcut path (the slot is the row).

    With ``count_probed`` it also returns, per key, the number of slots its
    probe reads: up to and including the one it stops at (the key or the
    first EMPTY, :func:`hashing.probe_slot`), all S when neither occurs."""
    dev = bucket_keys.device
    k = hashing.bits(keys, device=dev).reshape(-1)
    bk = hashing.bits(bucket_keys)
    bv = hashing.bits(bucket_vals)
    S = bk.shape[1]
    out = torch.empty_like(k)
    probed = torch.empty(k.shape, dtype=torch.int64, device=dev) \
        if count_probed else None
    for c in range(0, k.numel(), LOOKUP_CHUNK):
        kc = k[c:c + LOOKUP_CHUNK]
        slot = hashing.dir_slot(hashing.hash_dir(kc), global_depth).long()
        rows = slot if directory is None else directory[slot].long()
        pos = hashing.probe_positions(kc, S)
        row = bk[rows.unsqueeze(-1), pos]
        found, j = hashing.probe_hit(row, kc)
        hit_pos = pos.gather(-1, j.long().unsqueeze(-1)).squeeze(-1)
        out[c:c + LOOKUP_CHUNK] = torch.where(
            found, bv[rows, hit_pos], hashing.MISS_BITS)
        if count_probed:
            stops, stop = hashing.probe_slot(row, kc)
            probed[c:c + LOOKUP_CHUNK] = torch.where(stops, stop.long() + 1, S)
    if count_probed:
        return hashing.from_bits(out), probed
    return hashing.from_bits(out)


def eh_lookup_ref(keys, directory, bucket_keys, bucket_vals,
                  global_depth) -> torch.Tensor:
    """Traditional lookup.  keys (n,); directory (D,) int32; bucket_keys/
    vals (C, S) uint32.  Returns (n,) uint32 values (0xFFFFFFFF on miss)."""
    return lookup_ref(keys, directory, bucket_keys, bucket_vals, global_depth)


def shortcut_lookup_ref(keys, view_keys, view_vals,
                        global_depth) -> torch.Tensor:
    """One-indirection variant: slot arithmetic + direct view probe."""
    return lookup_ref(keys, None, view_keys, view_vals, global_depth)


def stacked_shortcut_lookup_ref(keys, view_keys, view_vals, view_log2s,
                                shard: int) -> torch.Tensor:
    """Shortcut lookup against block ``shard`` of the stacked views
    ``(N, V, S)`` at that shard's view log2.  Returns (n,) uint32."""
    log2 = torch.as_tensor(view_log2s)[shard]
    return lookup_ref(keys, None, view_keys[shard], view_vals[shard], log2)


def routed_lookup_ref(keys, directories, bucket_keys, bucket_vals,
                      global_depths, view_keys, view_vals, view_log2s,
                      two_level) -> torch.Tensor:
    """Per-shard routed lookup over keys (N, K): shard s resolves through
    its directory and buckets at ``global_depths[s]`` when ``two_level[s]``
    is nonzero, else through its view at ``view_log2s[s]``.  (N, K) uint32."""
    k = hashing.bits(keys, device=bucket_keys.device)
    out = torch.empty_like(k)
    for s, flag in enumerate(torch.as_tensor(two_level).tolist()):
        if flag:
            got = lookup_ref(k[s], directories[s], bucket_keys[s],
                             bucket_vals[s], global_depths[s])
        else:
            got = lookup_ref(k[s], None, view_keys[s], view_vals[s],
                             view_log2s[s])
        out[s] = hashing.bits(got)
    return hashing.from_bits(out)


def flat_keys_ref(keys, shard_bits: int, lookup_shard) -> torch.Tensor:
    """The sharded lookups' flat-key mode: keys (K,) in input order, those
    of shard s (:func:`hashing.shard_of_keys`) resolved by
    ``lookup_shard(s, keys_of_s)``, each value at its key's index.
    Returns (K,) uint32."""
    k = hashing.bits(keys)
    sid = hashing.shard_of_keys(k, shard_bits)
    out = torch.empty_like(k)
    for s in torch.unique(sid).tolist():
        at = sid == s
        out[at] = hashing.bits(lookup_shard(s, k[at]))
    return hashing.from_bits(out)


def ragged_copy_ref(view, pool, slots, offsets) -> torch.Tensor:
    """``view[slots[i]] = pool[offsets[i]]`` in place, the last of duplicate
    slots winning (the sequential grid of the TPU kernel); returns view."""
    slots = torch.as_tensor(slots, device=view.device).long().reshape(-1)
    offsets = torch.as_tensor(offsets, device=view.device).long().reshape(-1)
    if slots.numel() == 0:
        return view
    # stable sort by slot: within a run of equal slots the original order
    # holds, so the run's last element is the last write
    order = torch.sort(slots, stable=True).indices
    s = slots[order]
    last = torch.ones_like(s, dtype=torch.bool)
    last[:-1] = s[1:] != s[:-1]
    keep = order[last]
    v = hashing.storage_view(view)
    v[slots[keep]] = hashing.storage_view(pool)[offsets[keep]]
    return view


# -- decode attention --------------------------------------------------------
#
# These follow the TPU kernels (``shortcut_attention.py``,
# ``paged_attention.py``) where they differ from the JAX package's
# ``decode_attention_ref`` and ``paged_attention_ref``: a row with no live
# position (``ctx_len == 0``, or every block of a paged row unset) is all
# **zeros**, as the kernels' clamp ``l = max(l, 1e-30)`` over an untouched
# accumulator gives, not the mean of V that a softmax over an all-masked row
# gives; and a paged block whose table entry is -1 is skipped even below
# ``seq_lens``.

def softcap_ref(x, cap):
    return cap * torch.tanh(x / cap)


def _decode_live(q, k_ctx, v_ctx, live, softcap, k_new=None, v_new=None):
    """Softmax attention of q (B, KV, G, hd) over the positions of k_ctx/v_ctx
    (B, KV, S, hd) where ``live`` (B, S) holds, and over the self row
    ``k_new``/``v_new`` (B, KV, hd) when given (always live, as one more
    position); f32 scores with q scaled by ``hd**-0.5`` first, as the
    kernels do; zeros where no position is live."""
    hd = q.shape[-1]
    if k_new is not None:
        k_ctx = torch.cat([k_ctx, k_new[:, :, None].to(k_ctx.dtype)], dim=2)
        v_ctx = torch.cat([v_ctx, v_new[:, :, None].to(v_ctx.dtype)], dim=2)
        live = torch.cat([live, torch.ones_like(live[:, :1])], dim=1)
    s = torch.einsum("bkgd,bksd->bkgs", q.float() * hd ** -0.5,
                     k_ctx.float())
    if softcap is not None:
        s = softcap_ref(s, softcap)
    live = live[:, None, None, :]
    s = torch.where(live, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(live, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bksd->bkgd", p, v_ctx.float())
    return (o / l.clamp_min(1e-30)).to(q.dtype)


def _check_window(window) -> None:
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def _live(S, lens, window, has_self, device):
    """(B, S) bool: positions ``< lens``, and with ``window`` those ``>
    n - 1 - window``, where n counts the self row when there is one (the
    window ends at the current token)."""
    _check_window(window)
    pos = torch.arange(S, device=device)[None]
    lens = torch.as_tensor(lens, device=device).long()[:, None]
    live = pos < lens
    if window is not None:
        live &= pos > lens + int(has_self) - 1 - window
    return live


def decode_attention_ref(q, k_ctx, v_ctx, ctx_len, *, window=None,
                         softcap=None, k_new=None, v_new=None
                         ) -> torch.Tensor:
    """Decode over a contiguous view.  q: (B, KV, G, hd); k_ctx/v_ctx:
    (B, KV, S, hd); ctx_len: (B,) live tokens (positions ``[0, ctx_len)``,
    and with ``window`` only those ``> ctx_len - 1 - window``).  With the
    self row ``k_new``/``v_new`` (B, KV, hd), the current token, which is
    not in the view, is folded in as the last live position: ``ctx_len``
    then counts the old tokens only, and the window counts the self row.
    Returns (B, KV, G, hd) in q's dtype."""
    live = _live(k_ctx.shape[2], ctx_len, window, k_new is not None,
                 q.device)
    return _decode_live(q, k_ctx, v_ctx, live, softcap, k_new, v_new)


def paged_attention_ref(q, k_pool, v_pool, block_tables, seq_lens, *,
                        softcap=None, window=None, k_new=None,
                        v_new=None) -> torch.Tensor:
    """Decode through the block table.  q: (B, KV, G, hd); pools: (nblocks,
    KV, bs, hd); block_tables: (B, MB) int32, -1 unset (skipped); seq_lens:
    (B,).  Gathers the context, then attends over its live positions;
    ``window`` and the self row as in :func:`decode_attention_ref`."""
    B, KV, _, hd = q.shape
    bs = k_pool.shape[2]
    tables = torch.as_tensor(block_tables, device=q.device).long()
    MB = tables.shape[1]
    safe = tables.clamp_min(0)

    def ctx(pool):             # (B, MB, KV, bs, hd) -> (B, KV, S, hd)
        return pool[safe].permute(0, 2, 1, 3, 4).reshape(B, KV, MB * bs, hd)

    live = _live(MB * bs, seq_lens, window, k_new is not None, q.device)
    live &= (tables >= 0).repeat_interleave(bs, dim=1)
    return _decode_live(q, ctx(k_pool), ctx(v_pool), live, softcap, k_new,
                        v_new)


# -- flash attention (prefill) ----------------------------------------------
#
# A copy of the JAX package's ``flash_attention_ref`` (``repro/kernels/
# ref.py:16-36``): the full score matrix in float32, masked with -1e30, a
# softmax, then the value product.  For every row with a visible key this is
# the TPU kernel's function (its -1e30 terms are corrected away exactly).
# ``prefix_len`` adds the reference model's bidirectional-prefix terms
# (``repro/models/attention.py:140-150``), which the TPU kernel has no
# argument for, on absolute positions: unlike that tiled loop, the mask does
# not depend on a tile size.

_NEG_INF = -1e30


def flash_mask(Sq: int, Skv: int, *, causal: bool = True, window=None,
               q_offset=None, prefix_len: int = 0,
               device=None) -> torch.Tensor:
    """(Sq, Skv) bool: query row i sits at position ``qpos = i + q_offset``
    (default ``Skv - Sq``, right-aligned) and sees key ``kpos`` when
    ``qpos >= kpos`` (causal) and ``kpos > qpos - window``.  A bidirectional
    prefix of ``prefix_len`` positions (PaliGemma's image tokens) widens
    both terms, as the reference model's ``blockwise_attention`` does: the
    causal one by ``qpos < prefix_len and kpos < prefix_len``, the window
    one by ``kpos < prefix_len``."""
    _check_window(window)
    off = Skv - Sq if q_offset is None else q_offset
    qpos = torch.arange(Sq, device=device)[:, None] + off
    kpos = torch.arange(Skv, device=device)[None, :]
    in_prefix = kpos < prefix_len
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= (qpos >= kpos) | ((qpos < prefix_len) & in_prefix)
    if window is not None:
        mask &= (kpos > qpos - window) | in_prefix
    return mask


def visible_pairs(Sq: int, Skv: int, *, causal: bool = True, window=None,
                  prefix_len: int = 0) -> int:
    """The True entries of :func:`flash_mask` (right-aligned rows), counted
    row by row without building the mask: the (query, key) pairs a flash
    call computes."""
    _check_window(window)
    p = torch.arange(Skv - Sq, Skv, dtype=torch.int64)   # row positions
    lo = (p - window + 1).clamp_min(0) if window is not None \
        else torch.zeros_like(p)
    if causal:
        n = p - lo + 1 + lo.clamp(max=prefix_len)
        n = torch.where(p < prefix_len, min(prefix_len, Skv), n)
    else:
        n = Skv - lo + lo.clamp(max=prefix_len)
    return int(n.sum())


def flash_attention_masked(q, k, v, mask, softcap=None) -> torch.Tensor:
    """Attention of q (B, KV, G, Sq, hd) over k/v (B, KV, Skv, hd) where
    ``mask`` (Sq, Skv) holds; float32 scores, the score matrix updated in
    place to keep one (B, KV, G, Sq, Skv) float32 buffer alive."""
    hd = q.shape[-1]
    s = torch.einsum("bkgqd,bksd->bkgqs", q.float(), k.float())
    s.mul_(hd ** -0.5)
    if softcap is not None:
        s.div_(softcap).tanh_().mul_(softcap)
    s.masked_fill_(~mask, _NEG_INF)
    s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    s.div_(s.sum(dim=-1, keepdim=True))
    o = torch.einsum("bkgqs,bksd->bkgqd", s, v.float())
    return o.to(q.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None,
                        softcap=None, prefix_len: int = 0) -> torch.Tensor:
    """q: (B, KV, G, Sq, hd); k/v: (B, KV, Skv, hd) -> (B, KV, G, Sq, hd)
    in q's dtype."""
    mask = flash_mask(q.shape[3], k.shape[2], causal=causal, window=window,
                      prefix_len=prefix_len, device=q.device)
    return flash_attention_masked(q, k, v, mask, softcap)
