"""Flash attention, forward (prefill), twin of
``repro/kernels/flash_attention.py``.

Causal, windowed and softcapped attention of q (B, KV, G, Sq, hd) over k/v
(B, KV, Skv, hd), GQA folded into the query tile, q right-aligned against
the keys (``q_offset = Skv - Sq``), with an optional bidirectional prefix
(``prefix_len``: PaliGemma's image tokens, the reference model's mask; the
TPU kernel has no such argument).  On a CUDA tensor it launches
``csrc/flash_attention.cu``, whose launcher picks one of three kernels by
dtype and head_dim (:func:`kernel_path`): at ``TC_HEAD_DIMS`` both dtypes
run on the tensor cores, bfloat16 by ``wgmma`` over K/V tiles brought by
TMA, float32 in 3xTF32 (each operand split into two TF32 parts, three
``mma.sync`` products a step, accumulated in float32, which holds
float32's 2e-5 limit where one TF32 product does not); hd 16 and 32 run on
the CUDA cores.  On a CPU tensor it runs ``ref.flash_attention_ref``.
There is no backward kernel (the TPU kernel has none), so an input that
requires a gradient is refused.

Each call hands its flops and bytes (:func:`cost`) to the active cost
counter (``launch/op_cost``), if there is one: on CUDA beside the launch,
and on the meta device (the dry run) instead of it, returning an empty
output.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_LL4 = ctypes.c_longlong * 4
_SIGNATURES = {"flash_attention_launch": [
    _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
    ctypes.c_float, ctypes.c_float, _P], "flash_tc_smem_bytes": [_I],
    "flash_tf32x3_smem_bytes": [_I]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
#: head dims of the tensor-core kernels (both dtypes)
TC_HEAD_DIMS = (64, 128, 256)


def kernel_path(dtype: torch.dtype, hd: int) -> str:
    """The kernel the launcher runs for ``dtype`` and ``hd``:
    ``"tensor-core"`` (bfloat16, ``flash_tc_kernel``), ``"3xtf32"``
    (float32, ``flash_tf32x3_kernel``) or ``"simt"`` (``flash_kernel``, hd
    16 and 32)."""
    if hd not in TC_HEAD_DIMS:
        return "simt"
    return "tensor-core" if dtype == torch.bfloat16 else "3xtf32"


def tiles(path: str, hd: int) -> tuple:
    """(query rows a CTA, keys a K/V tile) of the kernel ``path`` at head
    dim ``hd``, as ``csrc/flash_attention.cu`` sets them: they decide which
    key tiles a CTA visits and masks (the checks emulate that tiling)."""
    if path == "tensor-core":
        return 128, 64 if hd == 256 else 128
    if path == "3xtf32":
        return 128, 4096 // hd
    return 64, 64


def tc_smem_bytes(hd: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory of one CTA of the tensor-core kernel for
    ``dtype`` at head_dim ``hd`` (builds the library on first use)."""
    lib = _build.load("flash_attention", _SIGNATURES)
    if dtype == torch.bfloat16:
        return lib.flash_tc_smem_bytes(hd)
    return lib.flash_tf32x3_smem_bytes(hd)


def check_tma(name: str, ptr: int, shape, strides, itemsize: int) -> None:
    """Raise ``ValueError`` naming ``name`` unless the tensor-core kernels
    can read the operand at address ``ptr`` with ``shape`` and element
    ``strides``: a 16-byte-aligned base and, for every axis but the last
    that is longer than 1, a stride that is a multiple of 16 bytes (what
    TMA needs of k and v, and the 16-byte loads of q's rows and, in
    float32, of every operand's)."""
    if ptr % 16:
        raise ValueError(f"flash_attention: {name} starts at {ptr:#x}, not "
                         "16-byte aligned (the tensor-core kernel reads it "
                         "in 16-byte units)")
    for axis, (n, st) in enumerate(zip(shape[:-1], strides[:-1])):
        if n > 1 and (st * itemsize) % 16:
            raise ValueError(f"flash_attention: {name} has stride {st} "
                             f"({st * itemsize} bytes) on axis {axis}, not "
                             "a multiple of 16 bytes (the tensor-core "
                             "kernel reads it in 16-byte units)")


def _check(q, k, v, causal: bool, prefix_len: int) -> None:
    if q.dim() != 5 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: expected q (B, KV, G, Sq, hd) "
                         "and equal k, v (B, KV, Skv, hd)")
    B, KV, _, Sq, hd = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, KV, hd):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch, kv heads or head_dim")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if causal and Sq > k.shape[2]:
        raise ValueError(f"causal with Sq {Sq} > Skv {k.shape[2]}: the "
                         "first rows would see no key")
    if prefix_len < 0:
        raise ValueError(f"prefix_len {prefix_len} < 0")
    if any(t.requires_grad for t in (q, k, v)):
        raise ValueError("flash_attention is forward only (no backward "
                         "kernel); call it under torch.no_grad()")


def cost(q, k, causal: bool = True, window: Optional[int] = None,
         prefix_len: int = 0) -> tuple:
    """(flops, bytes) of one call: 4 hd flops a query head for each
    visible (query, key) pair (Q K^T and P V), q, k and v read once and the
    output written once.  ``chip_smoke.py``'s bound column for this kernel
    is computed by this function."""
    B, KV, G, Sq, hd = q.shape
    pairs = ref.visible_pairs(Sq, k.shape[2], causal=causal, window=window,
                              prefix_len=prefix_len)
    return (4 * B * KV * G * hd * pairs,
            2 * (q.numel() + k.numel()) * q.element_size())


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None, prefix_len: int = 0,
                    bq: int = 256, bkv: int = 512) -> torch.Tensor:
    """q: (B, KV, G, Sq, hd); k/v: (B, KV, Skv, hd), any strides with a
    contiguous last axis -> (B, KV, G, Sq, hd) in q's dtype.  Query row i
    sits at position ``i + Skv - Sq``; with ``prefix_len`` the positions
    below it see the whole prefix (``ref.flash_mask``).

    On CUDA (and meta) the result is a view of a (B, Sq, KV, G, hd) buffer,
    the model layout, so that ``ops.mha_forward``'s transpose back costs no
    copy.
    ``bq`` and ``bkv`` are the TPU kernel's tile sizes, which do not change
    the answer; they are accepted and ignored (the CUDA kernels tile by
    their own sizes and do not pad the ragged tails).  The tensor-core
    kernels raise ``ValueError`` on operands :func:`check_tma` refuses."""
    del bq, bkv
    prefix_len = int(prefix_len)
    _check(q, k, v, causal, prefix_len)
    ref._check_window(window)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap, prefix_len=prefix_len)
    B, KV, G, Sq, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not "
                         "float32/bfloat16")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or dev.type not in ("cuda", "meta"):
            raise ValueError("flash_attention: tensors must share one CUDA "
                             "(or meta) device")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} with strides "
                             f"{t.stride()} has a strided last axis")
        if kernel_path(q.dtype, hd) != "simt":
            check_tma(name, t.data_ptr(), t.shape, t.stride(),
                      t.element_size())
    out = torch.empty((B, Sq, KV, G, hd), dtype=q.dtype,
                      device=dev).permute(0, 2, 3, 1, 4)
    if out.numel() == 0:
        return out
    if dev.type == "meta":
        _build.record_cost("flash_attention", cost, q, k, causal, window,
                           prefix_len)
        return out
    lib = _build.load("flash_attention", _SIGNATURES)
    err = lib.flash_attention_launch(
        _DTYPES[q.dtype], q.data_ptr(), _LL4(*q.stride()[:4]), k.data_ptr(),
        _LL4(*k.stride()[:3], 0), v.data_ptr(), _LL4(*v.stride()[:3], 0),
        out.data_ptr(), _LL4(*out.stride()[:4]), B, KV, G, Sq, k.shape[2],
        hd, int(causal), -1 if window is None else int(window), prefix_len,
        -1.0 if softcap is None else float(softcap), hd ** -0.5,
        _build.stream(dev))
    _build.check(err, "flash_attention")
    _build.count_launch("flash_attention")
    _build.record_cost("flash_attention", cost, q, k, causal, window,
                       prefix_len)
    return out
