"""The launcher that ``shortcut_attention`` and ``paged_attention`` share:
both are ``csrc/decode_attention.cu``'s ``decode_attention_launch``, which
takes raw pointers and element strides, so transposed views are read in
place."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"decode_attention_launch": [
    _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _P, _I, _I, _I, _I, _I,
    _I, ctypes.c_float, ctypes.c_float, _P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_shapes(q, k, v, k_name: str) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, {k_name} {tuple(k.shape)} "
                         f"and {tuple(v.shape)}: expected 4-d q and equal "
                         "4-d k and v")
    if k.shape[1] != q.shape[1] or k.shape[3] != q.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and {k_name} "
                         f"{tuple(k.shape)} differ in kv heads or head_dim")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")


def _strides(name: str, t: torch.Tensor) -> ctypes.Array:
    """The first three element strides of a 4-d tensor whose rows (last
    axis, stride 1) start 16-byte aligned, as the kernel's vector loads
    need."""
    es = t.element_size()
    if (t.stride(3) != 1 or t.data_ptr() % 16
            or any(s * es % 16 for s in t.stride()[:3])):
        raise ValueError(f"decode attention: {name} with strides "
                         f"{t.stride()} is not row-contiguous with 16-byte "
                         "aligned rows")
    return (ctypes.c_longlong * 3)(*t.stride()[:3])


def launch(kernel: str, q, k, v, lens, tables, S: int, window, softcap
           ) -> torch.Tensor:
    """Launch the shortcut (``tables is None``) or paged kernel; returns the
    contiguous (B, KV, G, hd) output in q's dtype."""
    B, KV, G, hd = q.shape
    lanes = hd // 8
    if hd % 8 or lanes > 32 or lanes & (lanes - 1):
        raise ValueError(f"{kernel}: head_dim {hd} must be 8 x a power of "
                         "two, at most 256")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{kernel}: dtype {q.dtype} not float32/bfloat16")
    dev = q.device
    lens = lens.to(device=dev, dtype=torch.int32).contiguous()
    tensors = [k, v, lens]
    if tables is not None:
        tables = tables.to(device=dev, dtype=torch.int32)
        if tables.stride(1) != 1:
            tables = tables.contiguous()
        tensors.append(tables)
    for t in (q, *tensors):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{kernel}: tensors must share one CUDA device")
    out = torch.empty((B, KV, G, hd), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    qs, ks, vs = _strides("q", q), _strides("k", k), _strides("v", v)
    lib = _build.load("decode_attention", _SIGNATURES)
    err = lib.decode_attention_launch(
        int(tables is not None), _DTYPES[q.dtype], q.data_ptr(), qs,
        k.data_ptr(), ks, v.data_ptr(), vs, lens.data_ptr(),
        0 if tables is None else tables.data_ptr(),
        0 if tables is None else tables.stride(0),
        0 if tables is None else tables.shape[1], out.data_ptr(), B, KV, G,
        hd, S, -1 if window is None else int(window),
        -1.0 if softcap is None else float(softcap), hd ** -0.5,
        _build.stream(dev))
    _build.check(err, kernel)
    _build.count_launch(kernel)
    return out
