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
