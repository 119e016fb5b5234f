"""Ragged row copy: the maintenance kernel (twin of
``repro/kernels/ragged_copy.py``).

``view[slots[i]] = pool[offsets[i]]`` for i in [0, M), in place, any row
shape and dtype; of duplicate slots the last one wins, as in the TPU
kernel's sequential grid (``ShortcutEH``'s update replay pads its slot list
with copies of slot 0).  This is the device half of the update-request
replay; on a CUDA tensor it launches ``csrc/ragged_copy.cu``, on a CPU
tensor it runs ``ref.ragged_copy_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"ragged_copy_launch": [_P, _P, _P, _P, _P, _I,
                                      ctypes.c_longlong, _I, _P]}
#: ``__global__`` kernels one ``ragged_copy_launch`` starts: reset_winner,
#: elect_winner, copy_rows
KERNELS_PER_CALL = 3


def _vec_bytes(row_bytes: int, *ptrs: int) -> int:
    """Widest load (16, 8, 4, 2 or 1 bytes) that the row width and every
    base pointer are aligned to."""
    for v in (16, 8, 4, 2):
        if row_bytes % v == 0 and all(p % v == 0 for p in ptrs):
            return v
    return 1


def ragged_copy(view: torch.Tensor, pool: torch.Tensor, slots,
                offsets) -> torch.Tensor:
    """view: (V, *row); pool: (P, *row) of the same dtype; slots/offsets:
    (M,) int32, in range.  Updates ``view`` in place and returns it."""
    if view.shape[1:] != pool.shape[1:] or view.dtype != pool.dtype:
        raise ValueError(f"row mismatch: view {tuple(view.shape)} "
                         f"{view.dtype} vs pool {tuple(pool.shape)} "
                         f"{pool.dtype}")
    dev = view.device
    slots = torch.as_tensor(slots, dtype=torch.int32, device=dev).reshape(-1)
    offsets = torch.as_tensor(offsets, dtype=torch.int32,
                              device=dev).reshape(-1)
    if slots.shape != offsets.shape:
        raise ValueError(f"{slots.numel()} slots vs {offsets.numel()} offsets")
    if dev.type == "cpu":
        return ref.ragged_copy_ref(view, pool, slots, offsets)
    slots, offsets = slots.contiguous(), offsets.contiguous()
    _build.require_cuda("ragged_copy", view, pool, slots, offsets)
    M = slots.numel()
    row_bytes = view[0].numel() * view.element_size() if view.shape[0] else 0
    if M == 0 or row_bytes == 0:
        return view
    winner = torch.empty(view.shape[0], dtype=torch.int32, device=dev)
    lib = _build.load("ragged_copy", _SIGNATURES)
    err = lib.ragged_copy_launch(
        view.data_ptr(), pool.data_ptr(), slots.data_ptr(),
        offsets.data_ptr(), winner.data_ptr(), M, row_bytes,
        _vec_bytes(row_bytes, view.data_ptr(), pool.data_ptr()),
        _build.stream(dev))
    _build.check(err, "ragged_copy")
    _build.count_launch("ragged_copy", KERNELS_PER_CALL)
    return view
