"""The launcher that ``shortcut_attention`` and ``paged_attention`` share:
both are ``csrc/decode_attention.cu``'s ``decode_attention_launch``, which
takes raw pointers and element strides, so transposed views are read in
place, and launches two ``__global__`` kernels: the split kernel (one CTA
per ``SPLIT`` tokens of one (b, kv head)) and the combine, which merges the
splits' f32 partials in split order and folds in the self row.  Each call
hands its flops and bytes (:func:`cost`) to the active cost counter
(``launch/op_cost``), if there is one: on CUDA beside the launch, and on
the meta device (the dry run) instead of it, returning an empty output."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
# one packed array of the 32 integer arguments (csrc's order), then the two
# floats and the stream: fewer ctypes conversions per call
_SIGNATURES = {"decode_attention_launch": [
    _P, ctypes.c_float, ctypes.c_float, _P]}
_ARGS = ctypes.c_longlong * 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: tokens of the context per CTA of the split kernel (a multiple of the
#: kernel's 64-token tile); chosen on the card against 512 (PERF.md), read
#: at each call
SPLIT = 256
#: head dims the kernel is built for; the most splits the combine takes
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_SPLITS = 12000
#: ``__global__`` kernels one call launches: the split kernel, the combine
KERNELS_PER_CALL = 2


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


def _strides(name: str, t: torch.Tensor) -> tuple:
    """The first three element strides of a 4-d tensor whose rows (last
    axis, stride 1) start 16-byte aligned, as the kernel's vector loads
    need."""
    es = t.element_size()
    st = t.stride()
    if (st[3] != 1 or t.data_ptr() % 16
            or st[0] * es % 16 or st[1] * es % 16 or st[2] * es % 16):
        raise ValueError(f"decode attention: {name} with strides "
                         f"{st} is not row-contiguous with 16-byte "
                         "aligned rows")
    return st[:3]


def cost(q, k, lens, tables, S: int, window, has_self: bool) -> tuple:
    """(flops, bytes) of one call (``chip_smoke.py``'s bound column for the
    decode kernels is computed by this function): each live K and V row
    read once (the self row counted; a window's rows only), q read and the
    output written, the lengths and, paged, the table entries of the live
    blocks; 4 hd flops a query head per live row.  Reads ``lens`` from the device; on the meta device it
    has no values and every sequence counts as full (``S`` rows, or every
    table entry)."""
    B, KV, G, hd = q.shape
    smax = S if tables is None else tables.shape[1] * S
    if lens.device.type == "meta":
        old = torch.full((B,), smax, dtype=torch.int64)
    else:
        old = lens.cpu().long().clamp(0, smax)
    n = old + int(has_self)
    if window is not None:
        n = n.clamp(max=int(window))
    live = int(n.sum())
    nbytes = (2 * live * KV * hd * k.element_size()
              + 2 * q.numel() * q.element_size() + 4 * B)
    if tables is not None:
        first = (old + int(has_self) - n).clamp_min(0)  # first live old row
        nbytes += 4 * int((-(-old // S) - first // S).clamp_min(0).sum())
    return 4 * KV * G * hd * live, nbytes


def launch(kernel: str, q, k, v, lens, tables, S: int, window, softcap,
           k_new=None, v_new=None) -> torch.Tensor:
    """Launch the shortcut (``tables is None``) or paged kernel; returns the
    contiguous (B, KV, G, hd) output in q's dtype.  ``k_new``/``v_new``
    (B, KV, hd): the self row, folded in as the last live position (``lens``
    then counts the old tokens only)."""
    B, KV, G, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"{kernel}: head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{kernel}: dtype {q.dtype} not float32/bfloat16")
    if (k_new is None) != (v_new is None):
        raise ValueError(f"{kernel}: k_new and v_new come together")
    dev = q.device
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"{kernel}: tensors must share one CUDA (or meta) "
                         "device")
    if lens.dtype != torch.int32 or lens.device != dev:
        lens = lens.to(device=dev, dtype=torch.int32)
    lens = lens.contiguous()
    tensors = [k, v, lens]
    if tables is not None:
        if tables.dtype != torch.int32 or tables.device != dev:
            tables = tables.to(device=dev, dtype=torch.int32)
        if tables.stride(1) != 1:
            tables = tables.contiguous()
        tensors.append(tables)
    if k_new is not None:
        if k_new.shape != (B, KV, hd) or v_new.shape != (B, KV, hd):
            raise ValueError(f"{kernel}: self rows {tuple(k_new.shape)}, "
                             f"{tuple(v_new.shape)}; expected {(B, KV, hd)}")
        if k_new.dtype != q.dtype or v_new.dtype != q.dtype:
            k_new, v_new = k_new.to(q.dtype), v_new.to(q.dtype)
        if k_new.stride() != v_new.stride() or k_new.stride(2) != 1:
            k_new, v_new = k_new.contiguous(), v_new.contiguous()
        tensors += [k_new, v_new]
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{kernel}: tensors must share one CUDA device")
    out = torch.empty((B, KV, G, hd), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    split = SPLIT
    MB = 0 if tables is None else tables.shape[1]
    smax = S if tables is None else MB * S
    nsplit = max(1, -(-smax // split))
    if nsplit > MAX_SPLITS:
        raise ValueError(f"{kernel}: {smax} tokens make {nsplit} splits of "
                         f"{split} > {MAX_SPLITS}")
    # the f32 partials in one buffer: m, l (B, KV, G, nsplit), then acc
    # (B, KV, G, nsplit, hd)
    part = torch.empty(B * KV * G * nsplit * (hd + 2), dtype=torch.float32,
                       device=dev)
    if dev.type == "meta":
        _build.record_cost(kernel, cost, q, k, lens, tables, S, window,
                           k_new is not None)
        return out
    args = _ARGS(
        int(tables is not None), _DTYPES[q.dtype],
        q.data_ptr(), *_strides("q", q), k.data_ptr(), *_strides("k", k),
        v.data_ptr(), *_strides("v", v), lens.data_ptr(),
        0 if tables is None else tables.data_ptr(),
        0 if tables is None else tables.stride(0), MB, out.data_ptr(),
        B, KV, G, hd, S, -1 if window is None else int(window),
        0 if k_new is None else k_new.data_ptr(),
        0 if v_new is None else v_new.data_ptr(),
        *(k_new.stride()[:2] if k_new is not None else (0, 0)),
        part.data_ptr(), split, nsplit)
    lib = _build.load("decode_attention", _SIGNATURES)
    err = lib.decode_attention_launch(
        args, -1.0 if softcap is None else float(softcap), hd ** -0.5,
        _build.stream(dev))
    _build.check(err, kernel)
    _build.count_launch(kernel, KERNELS_PER_CALL)
    _build.record_cost(kernel, cost, q, k, lens, tables, S, window,
                       k_new is not None)
    return out
