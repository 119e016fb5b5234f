"""numpy <-> port conversions for the index state and the composed view.

The JAX package's arrays cross over as numpy (``np.asarray`` of each field),
so that a test can start both packages from the same state and compare
their results field by field.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.extendible_hashing import EHState
from repro_torch.device import resolve_device

_INT32 = ("directory", "counts", "local_depth", "global_depth",
          "num_buckets", "dropped")


def _to_tensor(a, dtype: np.dtype, device) -> torch.Tensor:
    a = np.array(a, dtype=dtype, copy=True)
    if dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32)).to(device).view(torch.uint32)
    return torch.from_numpy(a).to(device)


def state_from_numpy(arrays, *, device=None) -> EHState:
    """An ``EHState`` of tensors from the eight arrays of an EH state in
    field order (a JAX ``EHState`` passes as it is)."""
    dev = resolve_device(device)
    fields = dict(zip(EHState._fields, arrays))
    if len(fields) != len(EHState._fields):
        raise ValueError(f"expected {len(EHState._fields)} arrays")
    return EHState(**{
        f: _to_tensor(a, np.int32 if f in _INT32 else np.uint32, dev)
        for f, a in fields.items()})


def state_to_numpy(st: EHState) -> EHState:
    """The same state with numpy arrays (uint32 and int32 as in the JAX
    package) in every field."""
    return EHState(*(a.cpu().numpy() for a in st))


def view_from_numpy(view, *, device=None) -> tuple:
    """``(view_keys, view_vals, view_log2)`` with uint32 tensors."""
    dev = resolve_device(device)
    vk, vv, log2 = view
    return (_to_tensor(vk, np.uint32, dev), _to_tensor(vv, np.uint32, dev),
            int(log2))


def view_to_numpy(view) -> tuple:
    vk, vv, log2 = view
    return vk.cpu().numpy(), vv.cpu().numpy(), int(log2)
