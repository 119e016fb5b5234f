"""Memory-rewiring abstraction (twin of ``repro/core/rewiring.py``).

The paper builds shortcuts from a physical page pool (``memfd_create``
file plus a queue of free page offsets), virtual memory areas, and
per-page ``mmap(MAP_SHARED|MAP_FIXED)`` rewiring.  Device memory has none
of these, so the port keeps the *insight*, as the JAX package does:

  * :class:`PagePool`  -- a preallocated ``(capacity, *page)`` device tensor
    plus a ring-buffer free list (``alloc``/``free`` mirror the offset
    queue; the high-water mark mirrors the ``ftruncate`` size);
  * :func:`compose`    -- the composed view ``view = pages[directory]``,
    after which a lookup does address arithmetic and one read;
  * :func:`remap_slots`-- the per-slot ``mmap`` replay of update requests
    (the ragged-copy kernel on CUDA).

Every function returns new tensors and leaves its arguments as they were,
as the JAX functions do; readers holding an old view never see it change.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import hashing
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


class PagePool(NamedTuple):
    """A self-managed pool of physical pages (the ``memfd`` analogue).

    ``pages``     -- (capacity, *page) backing storage.
    ``free_ring`` -- ring buffer of free page offsets.
    ``free_head`` -- index of the next offset to pop.
    ``free_count``-- number of offsets currently in the ring.
    ``size``      -- high-water mark: pages [0, size) were handed out at
                     least once (the ``ftruncate`` file size).
    """

    pages: torch.Tensor       # (capacity, *page) payload
    free_ring: torch.Tensor   # (capacity,) int32 ring buffer of free offsets
    free_head: torch.Tensor   # () int32
    free_count: torch.Tensor  # () int32
    size: torch.Tensor        # () int32 high-water mark

    @property
    def capacity(self) -> int:
        return self.pages.shape[0]

    @property
    def page_shape(self) -> tuple:
        return tuple(self.pages.shape[1:])

    @property
    def page_slots(self) -> int:
        return self.pages.shape[1]


def _scalar(v: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=like.device)


def pool_create(capacity: int, page_slots, dtype=torch.int32, fill=0, *,
                device=None) -> PagePool:
    """An empty pool; ``fill`` initializes the pages (the sentinel for
    empty slots).  ``page_slots`` is an int (flat pages) or a tuple
    (structured pages, e.g. ``(block_size, kv_heads, head_dim)``)."""
    dev = resolve_device(device)
    shape = (page_slots,) if isinstance(page_slots, int) else tuple(page_slots)
    i32 = dict(dtype=torch.int32, device=dev)
    return PagePool(
        pages=hashing.full((capacity,) + shape, fill, dtype, dev),
        free_ring=torch.zeros((capacity,), **i32),
        free_head=torch.zeros((), **i32), free_count=torch.zeros((), **i32),
        size=torch.zeros((), **i32))


def pool_alloc(pool: PagePool) -> tuple:
    """Pop a free offset if available, else extend the high-water mark.

    Returns ``(pool, offset)``; ``offset == -1`` signals exhaustion (the
    caller decides whether that is a hard error)."""
    cap = pool.capacity
    if int(pool.free_count) > 0:
        head = int(pool.free_head)
        off = pool.free_ring[head % cap].clone()
        return pool._replace(
            free_head=_scalar((head + 1) % cap, pool.free_head),
            free_count=_scalar(int(pool.free_count) - 1, pool.free_count),
        ), off
    size = int(pool.size)
    off = _scalar(size if size < cap else -1, pool.size)
    return pool._replace(size=_scalar(min(size + 1, cap), pool.size)), off


def pool_free(pool: PagePool, offset, reset_fill=None) -> PagePool:
    """Return ``offset`` to the free ring; ``reset_fill`` optionally
    re-initializes the page payload."""
    count = int(pool.free_count)
    tail = (int(pool.free_head) + count) % pool.capacity
    ring = pool.free_ring.clone()
    ring[tail] = int(offset)
    pool = pool._replace(free_ring=ring,
                         free_count=_scalar(count + 1, pool.free_count))
    if reset_fill is not None:
        pool = pool_write(pool, offset, hashing.full(
            pool.page_shape, reset_fill, pool.pages.dtype, pool.pages.device))
    return pool


def pool_read(pool: PagePool, offset) -> torch.Tensor:
    return pool.pages[int(offset)]


def pool_write(pool: PagePool, offset, page) -> PagePool:
    pages = hashing.clone(pool.pages)
    hashing.storage_view(pages)[int(offset)] = hashing.storage_view(page)
    return pool._replace(pages=pages)


def pool_used_pages(pool: PagePool) -> torch.Tensor:
    """Number of live pages (handed out and not freed)."""
    return pool.size - pool.free_count


# ---------------------------------------------------------------------------
# Shortcut composition: the page-table remap analogue.
# ---------------------------------------------------------------------------

def compose(pool_pages: torch.Tensor, directory) -> torch.Tensor:
    """The composed view ``view[i] = pool_pages[directory[i]]``: the create
    request replay, one gather that plays the ``mmap`` loop of the paper's
    step (2)."""
    idx = torch.as_tensor(directory, device=pool_pages.device).long()
    return hashing.storage_view(pool_pages)[idx].view(pool_pages.dtype)


def remap_slots(view: torch.Tensor, pool_pages: torch.Tensor, slots,
                offsets) -> torch.Tensor:
    """Replay *update requests*: a new view with ``view[slots[j]] =
    pool_pages[offsets[j]]``; duplicate slots resolve to the last write
    (matching sequential ``mmap`` calls).  The copy is the ragged-copy
    kernel on CUDA."""
    return ops.remap_rows(hashing.clone(view), pool_pages, slots, offsets)


def remap_range(view: torch.Tensor, pool_pages: torch.Tensor, start,
                length: int, offset) -> torch.Tensor:
    """A new view with ``length`` *contiguous* slots from ``start`` pointing
    at pool page ``offset`` (the paper coalesces neighbouring remaps into
    one ``mmap``).  ``start`` is taken as ``dynamic_update_slice`` takes it
    in the JAX package: a negative start counts from the end, and the
    range is then clamped to fit."""
    s = int(start)
    s = min(max(s + view.shape[0] if s < 0 else s, 0), view.shape[0] - length)
    out = hashing.clone(view)
    hashing.storage_view(out)[s:s + length] = \
        hashing.storage_view(pool_pages)[int(offset)]
    return out
