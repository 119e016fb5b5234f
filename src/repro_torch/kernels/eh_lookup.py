"""Extendible-hashing lookups, traditional and shortcut (twin of
``repro/kernels/eh_lookup.py``).

  * :func:`eh_lookup` — the *traditional* path: hash -> directory ->
    bucket row -> probe.  Two data-dependent indirections.
  * :func:`shortcut_lookup` — the *shortcut* path: hash -> view row ->
    probe.  One indirection: the composed view pre-resolved the mapping.

Both also come in a sharded form over N stacked shards.  All four are thin
wrappers of one CUDA kernel (``csrc/eh_lookup.cu``) with a compile-time
``TWO_LEVEL`` flag and a (key tiles x shards) grid, as the TPU version is
one ``pallas_call``.  On a CUDA tensor they launch it; on a CPU tensor they
run the plain version (``ref.py``).

The stacked and per-shard-routed forms of the TPU module belong to the
sharded slice and are not here yet.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import hashing
from repro_torch.kernels import _build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"eh_lookup_launch": [_I, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _P]}


def _bits_of_table(t: torch.Tensor, what: str) -> torch.Tensor:
    if t.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"{what} must be uint32, got {t.dtype}")
    return hashing.bits(t)


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
    if tile <= 0:
        raise ValueError(f"tile must be positive, got {tile}")
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
