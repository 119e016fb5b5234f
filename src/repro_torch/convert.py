"""numpy <-> port conversions for the index state and the composed view.

The JAX package's arrays cross over as numpy (``np.asarray`` of each field),
so that a test can start both packages from the same state and compare
their results field by field.  :func:`stack_shards` turns per-shard states
and composed views into the stacked operands of the sharded lookups.
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


def stack_shards(states, views=None, *, device=None) -> tuple:
    """The stacked operands of N shards, as the operand cache holds them.

    ``states``: N EH states (eight arrays each, in field order; a JAX
    ``EHState`` passes as it is).  ``views``: N ``(view_keys, view_vals,
    view_log2)``, or None.  Returns ``(trad, view)``: ``trad`` is
    ``(directories (N, D) int32, bucket_keys (N, C, S) uint32, bucket_vals,
    global_depths (N,) int32)``; ``view`` is ``(view_keys (N, V, S) uint32,
    view_vals, view_log2s (N,) int32)`` with each view zero-padded to the
    largest V (rows past a shard's own ``2**view_log2`` are never read), or
    None without ``views``."""
    dev = resolve_device(device)
    sts = [dict(zip(EHState._fields, st)) for st in states]

    def stack(name, dtype):
        return _to_tensor(np.stack([np.asarray(st[name]) for st in sts]),
                          dtype, dev)

    trad = (stack("directory", np.int32), stack("bucket_keys", np.uint32),
            stack("bucket_vals", np.uint32), stack("global_depth", np.int32))
    if views is None:
        return trad, None
    views = [(np.asarray(vk), np.asarray(vv), int(log2))
             for vk, vv, log2 in views]
    V = max(vk.shape[0] for vk, _, _ in views)

    def padded(j):
        return _to_tensor(np.stack([
            np.pad(v[j], ((0, V - v[j].shape[0]), (0, 0))) for v in views]),
            np.uint32, dev)

    log2s = _to_tensor(np.asarray([v[2] for v in views]), np.int32, dev)
    return trad, (padded(0), padded(1), log2s)
