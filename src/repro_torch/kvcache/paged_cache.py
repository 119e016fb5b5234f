"""Paged KV cache: the serving layer's "traditional directory" (twin of
``repro/kvcache/paged_cache.py``).

  paper                         here
  -----                         ----
  physical page pool            (L, num_blocks, block, KV, hd) device pools
  traditional inner node        per-sequence block table (logical->physical)
  pointer dereference           block-table gather in :func:`gather_context`
  pool free-offset queue        ring-buffer allocator (as in rewiring.py)

Functional, as in the JAX package: every op returns a new
:class:`PagedKVCache`, and an array that it writes is cloned first
(copy-on-write), so that a cache tuple once handed out never changes.  The
shortcut manager's mapper reads the pools through such a tuple (its
snapshot) while the main thread appends, releases and re-allocates blocks.
The price is a clone of both pools per ``append_tokens`` and
``write_prefill`` (``PERF.md``).  The scalars ``free_head`` and
``free_count`` are 0-d int32 tensors on the cache's device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import resolve_device


class PagedKVCache(NamedTuple):
    k_pool: torch.Tensor        # (L, num_blocks, block_size, KV, hd)
    v_pool: torch.Tensor        # (L, num_blocks, block_size, KV, hd)
    block_tables: torch.Tensor  # (max_seqs, max_blocks) int32, -1 unset
    seq_lens: torch.Tensor      # (max_seqs,) int32 tokens stored
    free_ring: torch.Tensor     # (num_blocks,) int32 free physical block ids
    free_head: torch.Tensor     # () int32
    free_count: torch.Tensor    # () int32

    @property
    def num_layers(self) -> int:
        return self.k_pool.shape[0]

    @property
    def num_blocks(self) -> int:
        return self.k_pool.shape[1]

    @property
    def block_size(self) -> int:
        return self.k_pool.shape[2]

    @property
    def max_blocks_per_seq(self) -> int:
        return self.block_tables.shape[1]

    @property
    def device(self) -> torch.device:
        return self.k_pool.device


def cache_create(num_layers: int, num_blocks: int, block_size: int,
                 kv_heads: int, head_dim: int, max_seqs: int,
                 max_blocks_per_seq: int, dtype=torch.bfloat16, *,
                 device=None) -> PagedKVCache:
    dev = resolve_device(device)
    shape = (num_layers, num_blocks, block_size, kv_heads, head_dim)
    i32 = dict(dtype=torch.int32, device=dev)
    return PagedKVCache(
        k_pool=torch.zeros(shape, dtype=dtype, device=dev),
        v_pool=torch.zeros(shape, dtype=dtype, device=dev),
        block_tables=torch.full((max_seqs, max_blocks_per_seq), -1, **i32),
        seq_lens=torch.zeros((max_seqs,), **i32),
        free_ring=torch.arange(num_blocks, **i32),
        free_head=torch.zeros((), **i32),
        free_count=torch.full((), num_blocks, **i32),
    )


def _ids(seq_ids, cache: PagedKVCache) -> torch.Tensor:
    return torch.as_tensor(seq_ids, device=cache.device).long().reshape(-1)


def _alloc_blocks(cache: PagedKVCache, need: torch.Tensor):
    """Pop blocks for the entries with ``need[i]``, in order.

    Returns ``(cache, block_ids (B,))`` with -1 where not needed or where
    the ring ran out."""
    n = need.to(torch.int32)
    rank = torch.cumsum(n, 0, dtype=torch.int32) - n
    ring_pos = ((cache.free_head + rank) % cache.num_blocks).long()
    ids = torch.where(need & (rank < cache.free_count),
                      cache.free_ring[ring_pos],
                      torch.full_like(rank, -1))
    granted = (ids >= 0).sum(dtype=torch.int32)
    cache = cache._replace(
        free_head=(cache.free_head + granted) % cache.num_blocks,
        free_count=cache.free_count - granted)
    return cache, ids


def append_tokens(cache: PagedKVCache, seq_ids, new_k: torch.Tensor,
                  new_v: torch.Tensor) -> PagedKVCache:
    """Append one token per active sequence (the synchronous, authoritative
    update).  seq_ids: (B,) int; new_k/new_v: (L, B, KV, hd).

    A sequence that needs a block when the ring is empty gets table entry
    -1, and its row lands in the last physical block, as JAX's ``.at[-1]``
    writes there.  A sequence already at ``max_blocks`` blocks gets JAX's
    answer past capacity: its fresh block still leaves the ring (and leaks),
    the table write is dropped, and the row lands in the block of the last
    table entry, at position ``(max_blocks - 1) * block + slot``."""
    seq_ids = _ids(seq_ids, cache)
    bs = cache.block_size
    pos = cache.seq_lens[seq_ids].long()
    block_idx = pos // bs
    slot = pos % bs
    need_new = slot == 0
    cache, fresh = _alloc_blocks(cache, need_new)
    # JAX drops an out-of-range scatter and clamps an out-of-range gather:
    # clamp the index, and write the entry back unchanged where it is past
    # the table
    in_table = block_idx < cache.max_blocks_per_seq
    block_idx = block_idx.clamp(max=cache.max_blocks_per_seq - 1)
    tables = cache.block_tables.clone()
    tables[seq_ids, block_idx] = torch.where(
        need_new & in_table, fresh, tables[seq_ids, block_idx])
    phys = tables[seq_ids, block_idx].long()
    k_pool = cache.k_pool.clone()
    v_pool = cache.v_pool.clone()
    k_pool[:, phys, slot] = new_k.to(k_pool.dtype)
    v_pool[:, phys, slot] = new_v.to(v_pool.dtype)
    lens = cache.seq_lens.index_add(
        0, seq_ids, torch.ones_like(seq_ids, dtype=torch.int32))
    return cache._replace(k_pool=k_pool, v_pool=v_pool, block_tables=tables,
                          seq_lens=lens)


def write_prefill(cache: PagedKVCache, seq_ids, k: torch.Tensor,
                  v: torch.Tensor) -> PagedKVCache:
    """Bulk-write a prefill: k/v (L, B, S, KV, hd), S divisible by the
    block size."""
    seq_ids = _ids(seq_ids, cache)
    L, B, S = k.shape[:3]
    bs = cache.block_size
    nb = S // bs
    need = torch.ones((B * nb,), dtype=torch.bool, device=cache.device)
    cache, fresh = _alloc_blocks(cache, need)
    fresh = fresh.reshape(B, nb)
    tables = cache.block_tables.clone()
    tables[seq_ids[:, None],
           torch.arange(nb, device=cache.device)[None]] = fresh
    f = fresh.long()
    k_pool = cache.k_pool.clone()
    v_pool = cache.v_pool.clone()
    k_pool[:, f] = k.reshape(L, B, nb, bs, *k.shape[3:]).to(k_pool.dtype)
    v_pool[:, f] = v.reshape(L, B, nb, bs, *v.shape[3:]).to(v_pool.dtype)
    lens = cache.seq_lens.clone()
    lens[seq_ids] = S
    return cache._replace(k_pool=k_pool, v_pool=v_pool, block_tables=tables,
                          seq_lens=lens)


def release_seqs(cache: PagedKVCache, seq_ids) -> PagedKVCache:
    """Return all blocks of the given sequences to the free ring."""
    seq_ids = _ids(seq_ids, cache)
    flat = cache.block_tables[seq_ids].reshape(-1)
    live = flat >= 0
    n = live.to(torch.int32)
    rank = torch.cumsum(n, 0, dtype=torch.int32) - n
    tail = ((cache.free_head + cache.free_count + rank)
            % cache.num_blocks).long()
    ring = cache.free_ring.clone()
    # JAX scatters the dead entries to index num_blocks with mode="drop";
    # here they are masked out
    ring[tail[live]] = flat[live]
    tables = cache.block_tables.clone()
    tables[seq_ids] = -1
    lens = cache.seq_lens.clone()
    lens[seq_ids] = 0
    freed = n.sum(dtype=torch.int32)
    return cache._replace(free_ring=ring, free_count=cache.free_count + freed,
                          block_tables=tables, seq_lens=lens)


def gather_context(cache: PagedKVCache, seq_ids):
    """The *traditional* access path: two dependent indirections (block
    table load, then physical-block gather).

    Returns (k_ctx, v_ctx): (L, B, KV, max_blocks*block, hd)."""
    seq_ids = _ids(seq_ids, cache)
    safe = cache.block_tables[seq_ids].clamp_min(0).long()  # indirection 1

    def gather(pool):                                      # indirection 2
        x = pool[:, safe]                # (L, B, MB, bs, KV, hd)
        L, B, MB, bs, KV, hd = x.shape
        return x.permute(0, 1, 4, 2, 3, 5).reshape(L, B, KV, MB * bs, hd)

    return gather(cache.k_pool), gather(cache.v_pool)


def fragmentation(cache: PagedKVCache, seq_ids) -> torch.Tensor:
    """Routing statistic (the fan-in analogue): the fraction of logically
    adjacent block pairs that are physically non-adjacent, as a 0-d
    float32 tensor."""
    tables = cache.block_tables[_ids(seq_ids, cache)]
    a, b = tables[:, :-1], tables[:, 1:]
    live = (a >= 0) & (b >= 0)
    non_adj = live & (b != a + 1)
    return (non_adj.sum().to(torch.float32)
            / live.sum().clamp_min(1).to(torch.float32))
