"""Extendible-hashing lookups, traditional and shortcut (twin of
``repro/kernels/eh_lookup.py``).

  * :func:`eh_lookup` — the *traditional* path: hash -> directory ->
    bucket row -> probe.  Two data-dependent indirections.
  * :func:`shortcut_lookup` — the *shortcut* path: hash -> view row ->
    probe.  One indirection: the composed view pre-resolved the mapping.

Both also come in a sharded form over N stacked shards.  All four are thin
wrappers of one CUDA kernel (``csrc/eh_lookup.cu``) with a compile-time
``TWO_LEVEL`` flag and a (key tiles x shards) grid, as the TPU version is
one ``pallas_call``.

  * :func:`stacked_shortcut_lookup` — the bound single-shard path: a
    shortcut lookup against block ``shard`` of the stacked views of the
    operand cache (``runtime/operand_cache.py``), with no slice copied.
  * :func:`sharded_routed_lookup` — the mixed arm of the sharded lookup:
    per shard, the directory path or the view path, in one launch.

The three kernels share one per-tile body (``resolve_tile`` in the source,
after the TPU module's ``_resolve_tile``).  On a CUDA tensor every wrapper
launches its kernel; on a CPU tensor it runs the plain version
(``ref.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import hashing
from repro_torch.kernels import _build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "eh_lookup_launch": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _P],
    "stacked_lookup_launch": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P],
    "routed_lookup_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _I, _P],
}
#: most shards one launch takes (the shard is the grid's y dimension)
MAX_SHARDS = 65535


def _bits_of_table(t: torch.Tensor, what: str) -> torch.Tensor:
    if t.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"{what} must be uint32, got {t.dtype}")
    return hashing.bits(t)


def _check_tile(tile: int) -> None:
    if tile <= 0:
        raise ValueError(f"tile must be positive, got {tile}")


def _per_shard(x, N: int, dev, what: str) -> torch.Tensor:
    """A per-shard int32 vector (N,) on ``dev``."""
    t = torch.as_tensor(x, dtype=torch.int32, device=dev)
    if t.numel() != N:
        raise ValueError(f"{what} has {t.numel()} entries for {N} shards")
    return t.reshape(N)


def _run(keys, directory, bucket_keys, bucket_vals, depths, *,
         two_level: bool, tile: int) -> torch.Tensor:
    """keys (N, K); directory (N, D) int32 (None for the shortcut);
    bucket_keys/vals (N, C, S) uint32; depths (N,).  Returns (N, K) uint32."""
    bk = _bits_of_table(bucket_keys, "bucket_keys")
    bv = _bits_of_table(bucket_vals, "bucket_vals")
    dev = bk.device
    k = hashing.bits(keys, device=dev)
    N, K = k.shape
    if bk.dim() != 3 or bk.shape != bv.shape or bk.shape[0] != N:
        raise ValueError(f"bucket arrays {tuple(bk.shape)}/{tuple(bv.shape)} "
                         f"do not match keys {tuple(k.shape)}")
    if two_level and (directory.dtype != torch.int32 or directory.dim() != 2
                      or directory.shape[0] != N):
        raise ValueError("directory must be (N, D) int32")
    if N > MAX_SHARDS:
        raise ValueError(f"{N} shards, at most {MAX_SHARDS} per launch")
    _check_tile(tile)
    gd = torch.as_tensor(depths, dtype=torch.int32, device=dev).reshape(N)
    out = torch.empty((N, K), dtype=torch.int32, device=dev)
    if dev.type == "cpu":
        for s in range(N):
            out[s] = hashing.bits(ref.lookup_ref(
                k[s], directory[s] if two_level else None, bk[s], bv[s],
                gd[s]))
        return hashing.from_bits(out)
    k = k.contiguous()
    d = directory if two_level else None
    _build.require_cuda("eh_lookup", k, bk, bv, gd, *(() if d is None else (d,)))
    lib = _build.load("eh_lookup", _SIGNATURES)
    C, S = bk.shape[1:]
    err = lib.eh_lookup_launch(
        int(two_level), k.data_ptr(), None if d is None else d.data_ptr(),
        bk.data_ptr(), bv.data_ptr(), gd.data_ptr(), out.data_ptr(),
        N, K, 1 if d is None else d.shape[1], C, S, tile, _build.stream(dev))
    _build.check(err, "eh_lookup")
    _build.count_launch("eh_lookup" if two_level else "shortcut_lookup")
    return hashing.from_bits(out)


def eh_lookup(keys, directory, bucket_keys, bucket_vals, global_depth, *,
              tile: int = 256) -> torch.Tensor:
    """Traditional EH lookup: keys (n,) -> values (n,) uint32 (MISS on
    absent).  directory: (D,) int32; bucket_keys/vals: (C, S) uint32."""
    k = hashing.bits(keys, device=bucket_keys.device).reshape(1, -1)
    return _run(k, directory[None], bucket_keys[None], bucket_vals[None],
                global_depth, two_level=True, tile=tile)[0]


def shortcut_lookup(keys, view_keys, view_vals, global_depth, *,
                    tile: int = 256) -> torch.Tensor:
    """Shortcut lookup over the composed view ``(2^g_cap, S)``: one
    indirection fewer.  ``global_depth`` is the view's log2."""
    k = hashing.bits(keys, device=view_keys.device).reshape(1, -1)
    return _run(k, None, view_keys[None], view_vals[None], global_depth,
                two_level=False, tile=tile)[0]


def sharded_eh_lookup(keys, directories, bucket_keys, bucket_vals,
                      global_depths, *, tile: int = 256) -> torch.Tensor:
    """Traditional lookup across N stacked shards: keys (N, K) (pad lanes
    return whatever their key finds; callers drop them); directories
    (N, D); bucket_keys/vals (N, C, S); global_depths (N,).  (N, K) uint32."""
    return _run(keys, directories, bucket_keys, bucket_vals, global_depths,
                two_level=True, tile=tile)


def sharded_shortcut_lookup(keys, view_keys, view_vals, global_depths, *,
                            tile: int = 256) -> torch.Tensor:
    """Shortcut lookup across N stacked shards (views (N, V, S))."""
    return _run(keys, None, view_keys, view_vals, global_depths,
                two_level=False, tile=tile)


def stacked_shortcut_lookup(keys, view_keys, view_vals, view_log2s, shard, *,
                            tile: int = 256) -> torch.Tensor:
    """Single-shard shortcut lookup straight off the stacked views.

    keys (n,); view_keys/vals: the whole (N, V, S) stacks; view_log2s (N,);
    ``shard`` selects the block.  On CUDA the kernel reads
    ``view_log2s[shard]`` from device memory and offsets to the block, so
    the host never syncs.  Returns (n,) uint32."""
    vk = _bits_of_table(view_keys, "view_keys")
    vv = _bits_of_table(view_vals, "view_vals")
    if vk.dim() != 3 or vk.shape != vv.shape:
        raise ValueError(f"view stacks {tuple(vk.shape)}/{tuple(vv.shape)} "
                         "must both be (N, V, S)")
    N, V, S = vk.shape
    shard = int(shard)
    if not 0 <= shard < N:
        raise ValueError(f"shard {shard} outside [0, {N})")
    _check_tile(tile)
    dev = vk.device
    k = hashing.bits(keys, device=dev).reshape(-1).contiguous()
    vl = _per_shard(view_log2s, N, dev, "view_log2s")
    if dev.type == "cpu":
        return ref.stacked_shortcut_lookup_ref(k, view_keys, view_vals, vl,
                                               shard)
    _build.require_cuda("stacked_shortcut_lookup", k, vk, vv, vl)
    out = torch.empty_like(k)
    lib = _build.load("eh_lookup", _SIGNATURES)
    err = lib.stacked_lookup_launch(
        k.data_ptr(), vk.data_ptr(), vv.data_ptr(), vl.data_ptr(), shard,
        out.data_ptr(), k.numel(), V, S, tile, _build.stream(dev))
    _build.check(err, "stacked_shortcut_lookup")
    _build.count_launch("stacked_shortcut_lookup")
    return hashing.from_bits(out)


def sharded_routed_lookup(keys, directories, bucket_keys, bucket_vals,
                          global_depths, view_keys, view_vals, view_log2s,
                          two_level, *, tile: int = 256) -> torch.Tensor:
    """Per-shard routed lookup across N stacked shards, in one launch.

    ``two_level`` (N,): nonzero shards resolve through directories (N, D)
    and bucket pools (N, C, S) at ``global_depths``; zero shards through
    their views (N, V, S) at ``view_log2s`` (rows past ``2**view_log2s[s]``
    are pad and never indexed).  keys (N, K); returns (N, K) uint32 in the
    padded layout of :func:`sharded_eh_lookup`."""
    if bucket_keys.shape[-1] != view_keys.shape[-1]:
        raise ValueError(
            f"bucket/view slot widths differ: {bucket_keys.shape[-1]} "
            f"vs {view_keys.shape[-1]}")
    bk = _bits_of_table(bucket_keys, "bucket_keys")
    bv = _bits_of_table(bucket_vals, "bucket_vals")
    vk = _bits_of_table(view_keys, "view_keys")
    vv = _bits_of_table(view_vals, "view_vals")
    dev = bk.device
    k = hashing.bits(keys, device=dev).contiguous()
    if k.dim() != 2:
        raise ValueError(f"keys must be (N, K), got {tuple(k.shape)}")
    N, K = k.shape
    if bk.dim() != 3 or bk.shape != bv.shape or bk.shape[0] != N:
        raise ValueError(f"bucket arrays {tuple(bk.shape)}/{tuple(bv.shape)} "
                         f"do not match keys {tuple(k.shape)}")
    if vk.dim() != 3 or vk.shape != vv.shape or vk.shape[0] != N:
        raise ValueError(f"view arrays {tuple(vk.shape)}/{tuple(vv.shape)} "
                         f"do not match keys {tuple(k.shape)}")
    if (directories.dtype != torch.int32 or directories.dim() != 2
            or directories.shape[0] != N):
        raise ValueError("directories must be (N, D) int32")
    if N > MAX_SHARDS:
        raise ValueError(f"{N} shards, at most {MAX_SHARDS} per launch")
    _check_tile(tile)
    # the packed (3, N) block of the TPU kernel's scalar prefetch: flags,
    # traditional depths, view log2s
    sc = torch.stack([_per_shard(two_level, N, dev, "two_level"),
                      _per_shard(global_depths, N, dev, "global_depths"),
                      _per_shard(view_log2s, N, dev, "view_log2s")])
    if dev.type == "cpu":
        return ref.routed_lookup_ref(k, directories, bucket_keys,
                                     bucket_vals, sc[1], view_keys,
                                     view_vals, sc[2], sc[0])
    _build.require_cuda("sharded_routed_lookup", k, directories, bk, bv,
                        vk, vv, sc)
    out = torch.empty_like(k)
    C, S = bk.shape[1:]
    lib = _build.load("eh_lookup", _SIGNATURES)
    err = lib.routed_lookup_launch(
        k.data_ptr(), directories.data_ptr(), bk.data_ptr(), bv.data_ptr(),
        vk.data_ptr(), vv.data_ptr(), sc.data_ptr(), out.data_ptr(), N, K,
        directories.shape[1], C, vk.shape[1], S, tile, _build.stream(dev))
    _build.check(err, "sharded_routed_lookup")
    _build.count_launch("sharded_routed_lookup")
    return hashing.from_bits(out)
