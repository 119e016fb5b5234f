"""Prefix-cache index (twin of ``repro/kvcache/prefix_index.py``): the
paper's EH index used AS the serving lookup structure, completing the loop
between the two layers.

Prefix caching deduplicates KV blocks across requests that share a prompt
prefix (system prompts, few-shot headers).  The lookup structure maps
``hash(token-block content, parent-chain)`` -> physical KV block id: a
dynamic hash index with exactly the paper's profile — unknown final size,
lookup-heavy, bursty inserts when new prompts arrive — so it IS a
Shortcut-EH: synchronous traditional directory, async shortcut directory,
version gating, fan-in routing.  The per-block index is the port's
:class:`~repro_torch.core.shortcut_eh.ShortcutEH` on ``device`` (default
``"cuda"``); chain hashing and the prefix view stay on the host, on exact
Python ints and numpy arrays.

Chain hashing: block i's key folds its content hash into the parent's
key (a Merkle chain), so a hit at block i implies the whole prefix
[0, i] matches — single probe per block, no token re-comparison.

On top of the per-block EH index sits a *second* shortcut (DESIGN.md §4):
the **prefix → block-table shortcut**.  The authoritative path resolves a
request one chain key at a time (one probe per block).  The shortcut view
pre-composes ``final chain key -> whole block table`` into an
open-addressed device table, so a request whose full prefix is cached
resolves in ONE probe instead of ``n_blocks`` — the same
"skip the pointer chase" move, one level up.  It is maintained by its own
:class:`~repro_torch.runtime.mapper.ShortcutMapper` (the third client of the
generic runtime): inserts enqueue *update* requests (write one row),
occupancy-driven table growth enqueues *create* requests (rebuild), and
routing engages once the mean chain length makes the multi-probe walk
expensive enough to beat.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core import hashing
from repro_torch.core.shortcut_eh import ShortcutEH
from repro_torch.runtime.mapper import (GLOBAL_VIEW, FragmentationRouting,
                                        ShortcutMapper)

_MISS = 0xFFFFFFFF
_FNV_PRIME = 1099511628211
_FNV_OFF = 14695981039346656037
_MASK64 = (1 << 64) - 1


def _fnv1a(data: np.ndarray, seed: int) -> int:
    """FNV-1a over uint64 words with explicit masked Python-int arithmetic
    (numpy uint64 multiplies emit RuntimeWarning on the intended
    wraparound; Python ints make the mod-2^64 semantics explicit and
    warning-free)."""
    h = seed if seed else _FNV_OFF
    for b in np.asarray(data, np.uint64).tolist():
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


class PrefixCacheIndex:
    """Maps token-block prefixes to physical KV blocks via Shortcut-EH,
    plus a whole-prefix shortcut over the final chain key."""

    def __init__(self, block_size: int, *, max_global_depth: int = 16,
                 bucket_slots: int = 64, capacity: int = 4096,
                 async_mapper: bool = False, table_log2: int = 8,
                 chain_threshold: float = 2.0, device=None):
        self.block_size = block_size
        self.index = ShortcutEH(
            max_global_depth=max_global_depth, bucket_slots=bucket_slots,
            capacity=capacity, async_mapper=async_mapper, device=device)
        self.hits = 0
        self.misses = 0
        # -- prefix -> block-table shortcut (third runtime client) ----------
        # authoritative side: every registered chain, final key -> blocks
        self._chains: dict[int, tuple[int, ...]] = {}
        self._chain_len_total = 0        # running sum for O(1) mean length
        self._table_log2 = int(table_log2)
        self._max_chain = 1
        # The view is ONE atomically-swapped tuple (keys (T,) uint32,
        # blocks (T, max_chain) int32, lens (T,) int32, table_log2) of
        # host numpy arrays: replays publish a fully-built tuple and
        # readers snapshot it once, so the async mapper thread can never
        # expose torn state.  Host arrays because the view is only ever
        # probed host-side (one slot per lookup).
        self._view: Optional[tuple] = None
        self.prefix_mapper = ShortcutMapper(
            replay_create=self._replay_create,
            replay_update=self._replay_update,
            snapshot=lambda: (dict(self._chains), self._table_log2,
                              self._max_chain),
            view_arrays=self._view_arrays,
            routing=FragmentationRouting(float(chain_threshold)),
            async_mapper=async_mapper, name="prefix-mapper")

    # -- key derivation ------------------------------------------------------

    def chain_keys(self, tokens: Sequence[int]) -> np.ndarray:
        """uint32 keys for each complete block of ``tokens`` (Merkle
        chain: key_i commits to blocks [0, i])."""
        toks = np.asarray(tokens, np.uint64)
        n_blocks = len(toks) // self.block_size
        keys = np.empty((n_blocks,), np.uint32)
        h = 0
        for i in range(n_blocks):
            blk = toks[i * self.block_size:(i + 1) * self.block_size]
            h = _fnv1a(blk, h)
            # avoid the EMPTY/MISS sentinel
            k = h & 0xFFFFFFFF
            keys[i] = np.uint32(1) if k in (0, _MISS) else np.uint32(k)
        return keys

    # -- serving API ---------------------------------------------------------

    def match_prefix(self, tokens: Sequence[int]) -> tuple[int, list]:
        """Longest cached prefix of ``tokens``.

        Returns (num_cached_tokens, [physical block ids]) — the serving
        layer copies/aliases these blocks instead of re-prefilling.

        Fast path: when the prefix shortcut is in sync and routed, the
        *final* chain key is probed once against the composed
        prefix -> block-table view; a hit returns the whole table without
        walking the chain.  A miss (or an out-of-sync/unprofitable view)
        falls back to the authoritative per-block walk.
        """
        keys = self.chain_keys(tokens)
        if keys.size == 0:
            return 0, []
        if self.prefix_mapper.gate(self._mean_chain_len(), [GLOBAL_VIEW]):
            blocks = self._shortcut_match(int(keys[-1]))
            if blocks is not None:
                self.prefix_mapper.count_route(True)
                self.hits += 1
                return len(blocks) * self.block_size, list(blocks)
        self.prefix_mapper.count_route(False)
        vals = hashing.bits(self.index.lookup(keys)).cpu().numpy().view(
            np.uint32)
        blocks = []
        for v in vals:
            if int(v) == _MISS:
                break
            blocks.append(int(v))
        if blocks:
            self.hits += 1
        else:
            self.misses += 1
        return len(blocks) * self.block_size, blocks

    def insert_prefix(self, tokens: Sequence[int],
                      block_ids: Sequence[int]) -> int:
        """Register the (complete) blocks of a finished prefill.

        Returns the number of blocks registered.  Maintenance of both
        shortcut directories is asynchronous as always (``pump()`` or the
        mapper threads replay it)."""
        keys = self.chain_keys(tokens)
        n = min(len(keys), len(block_ids))
        if n == 0:
            return 0
        self.index.insert(keys[:n], np.asarray(block_ids[:n], np.uint32))
        # authoritative chain registry + shortcut maintenance requests:
        # every intermediate chain [0, i] is a valid full prefix.
        new_rows = []
        with self.prefix_mapper.lock:
            for i in range(n):
                key = int(keys[i])
                chain = tuple(int(b) for b in block_ids[:i + 1])
                old = self._chains.get(key)
                if old is not None:
                    self._chain_len_total -= len(old)
                self._chains[key] = chain
                self._chain_len_total += len(chain)
                new_rows.append((key, chain))
            self._max_chain = max(self._max_chain,
                                  max(len(c) for _, c in new_rows))
            grow = len(self._chains) * 2 > (1 << self._table_log2)
            while len(self._chains) * 2 > (1 << self._table_log2):
                self._table_log2 += 1    # bulk inserts may need > 1 doubling
            versions = self.prefix_mapper.record([GLOBAL_VIEW])
        view = self._view
        needs_create = (grow or view is None
                        or view[1].shape[1] < self._max_chain)
        if needs_create:
            self.prefix_mapper.submit_create([GLOBAL_VIEW], versions)
        else:
            self.prefix_mapper.submit_update([GLOBAL_VIEW], versions,
                                             payload=new_rows)
        return n

    def pump(self):
        self.index.pump()
        self.prefix_mapper.pump()

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "in_sync": self.index.in_sync(),
                "fan_in": self.index.avg_fan_in(),
                "routed_shortcut": self.index.routed_shortcut,
                "routed_traditional": self.index.routed_traditional,
                "prefix_in_sync": self.prefix_mapper.in_sync([GLOBAL_VIEW]),
                "prefix_routed_shortcut": self.prefix_mapper.routed_shortcut,
                "prefix_routed_walk": self.prefix_mapper.routed_fallback}

    def close(self):
        self.index.close()
        self.prefix_mapper.close()

    # -- prefix-shortcut internals -------------------------------------------

    def _mean_chain_len(self) -> float:
        if not self._chains:
            return 0.0
        return self._chain_len_total / len(self._chains)

    def _probe_seq(self, key: int, table_log2: int) -> np.ndarray:
        """Host-side linear probe window (same MSB home slot + window rule
        as ``core/hashing.py``; replays and lookups must agree)."""
        size = 1 << table_log2
        home = (hashing.hash_dir_host(key) >> (32 - table_log2)) \
            if table_log2 > 0 else 0
        return (home + np.arange(min(32, size))) % size

    def _insert_row(self, vk: np.ndarray, vb: np.ndarray, vl: np.ndarray,
                    table_log2: int, key: int, chain: tuple) -> int:
        """Probe-insert one (key, chain) row: first matching-or-empty slot.
        Shared by create and update replays so the probe rule cannot
        drift between them (and from :meth:`_shortcut_match`)."""
        for p in self._probe_seq(key, table_log2):
            if vk[p] == np.uint32(hashing.EMPTY_SENTINEL) \
                    or vk[p] == np.uint32(key):
                vk[p] = np.uint32(key)
                vb[p, :len(chain)] = chain
                vl[p] = len(chain)
                return 1
        return 0    # window full: row dropped, lookups fall back (miss)

    def _shortcut_match(self, key: int) -> Optional[tuple]:
        """One probe of the composed view; None on miss."""
        view = self._view      # single read: the replay swap is atomic
        if view is None:
            return None
        vk, vb, vl, table_log2 = view
        pos = self._probe_seq(key, table_log2)
        probed = vk[pos]
        hit = np.nonzero(probed == np.uint32(key))[0]
        stop = np.nonzero(probed == np.uint32(hashing.EMPTY_SENTINEL))[0]
        if hit.size == 0 or (stop.size and stop[0] < hit[0]):
            return None
        slot = int(pos[hit[0]])
        return tuple(int(b) for b in vb[slot, :int(vl[slot])])

    def _view_arrays(self):
        return ()   # host numpy view: resident by construction

    def _replay_create(self, snap, requests) -> None:
        """Rebuild the whole table from the authoritative chain registry
        (the create-request 'mmap loop'), then publish it atomically."""
        chains, table_log2, max_chain = snap
        size = 1 << table_log2
        vk = np.full((size,), hashing.EMPTY_SENTINEL, np.uint32)
        vb = np.full((size, max_chain), -1, np.int32)
        vl = np.zeros((size,), np.int32)
        for key, chain in chains.items():
            self._insert_row(vk, vb, vl, table_log2, key, chain)
        self._view = (vk, vb, vl, table_log2)
        self.prefix_mapper.stats.slots_remapped += len(chains)

    def _replay_update(self, snap, requests) -> None:
        """Write the new rows into a copy of the view (per-slot remap),
        then publish the copy atomically."""
        view = self._view
        if view is None:
            self._replay_create(snap, requests)
            return
        vk, vb, vl, table_log2 = (np.array(view[0]), np.array(view[1]),
                                  np.array(view[2]), view[3])
        n_rows = 0
        for r in requests:
            for key, chain in r.payload:
                n_rows += self._insert_row(vk, vb, vl, table_log2,
                                           key, chain)
        self._view = (vk, vb, vl, table_log2)
        self.prefix_mapper.stats.slots_remapped += n_rows

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
