"""The extendible-hashing batch insert as one CUDA kernel launch.

The JAX package inserts with a per-key ``lax.scan`` on the device
(``repro/core/extendible_hashing.py:eh_insert_many``); a per-key PyTorch
loop would launch dozens of kernels per key, so on CUDA the whole batch is
one single-block kernel (``csrc/eh_insert.cu``).  Its plain version is the
per-key loop of ``core/extendible_hashing.py``, which the CPU path runs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"eh_insert_launch": [_P, _P, _I] + [_P] * 8
                                   + [_I, _I, _I, _P]}
#: shared memory a block may use on Hopper; the kernel stages six rows
MAX_SHARED_BYTES = 232448


def eh_insert_(st, keys: torch.Tensor, values: torch.Tensor) -> None:
    """Insert ``keys``/``values`` ((n,) uint32 or int32 bit patterns) into
    the CUDA ``EHState`` ``st`` in place, in order."""
    arrays = (st.directory, st.bucket_keys, st.bucket_vals, st.counts,
              st.local_depth, st.global_depth, st.num_buckets, st.dropped)
    dev = _build.require_cuda("eh_insert", keys, values, *arrays)
    if keys.dtype not in (torch.uint32, torch.int32) or \
            values.dtype not in (torch.uint32, torch.int32):
        raise TypeError("keys and values must be uint32 bit patterns")
    if keys.shape != values.shape or keys.dim() != 1:
        raise ValueError(f"keys {tuple(keys.shape)} vs values "
                         f"{tuple(values.shape)}")
    C, S = st.bucket_keys.shape
    if 24 * S > MAX_SHARED_BYTES:
        raise ValueError(f"bucket_slots={S} needs {24 * S} bytes of shared "
                         f"memory, more than {MAX_SHARED_BYTES}")
    if keys.numel() == 0:
        return
    lib = _build.load("eh_insert", _SIGNATURES)
    err = lib.eh_insert_launch(
        keys.data_ptr(), values.data_ptr(), keys.numel(),
        *(a.data_ptr() for a in arrays), st.max_global_depth, C, S,
        _build.stream(dev))
    _build.check(err, "eh_insert")
    _build.count_launch("eh_insert")
