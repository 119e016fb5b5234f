"""numpy <-> port conversions for the index state, the baselines' states,
the composed view, the paged KV cache, the KV view pair, the model
parameters, the serve decode state and the AdamW optimizer state.

The JAX package's arrays cross over as numpy (``np.asarray`` of each field),
so that a test can start both packages from the same state and compare
their results field by field.  :func:`stack_shards` turns per-shard states
and composed views into the stacked operands of the sharded lookups.
bfloat16 crosses numpy as float32 (bf16 -> f32 -> bf16 is exact).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.baselines import CHState, HTIState, HTState
from repro_torch.core.extendible_hashing import EHState
from repro_torch.device import resolve_device
from repro_torch.kvcache.paged_cache import PagedKVCache
from repro_torch.optim.adamw import AdamWState
from repro_torch.runtime.serve import DecodeState

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


def _baseline_dtype(field: str) -> np.dtype:
    """uint32 for the tables' keys and values, bool for ``migrating``,
    int32 for the rest."""
    if field == "migrating":
        return np.bool_
    return np.uint32 if field.endswith(("keys", "vals")) else np.int32


def _baseline_from_numpy(cls, arrays, device):
    dev = resolve_device(device)
    fields = dict(zip(cls._fields, arrays))
    if len(fields) != len(cls._fields):
        raise ValueError(f"expected {len(cls._fields)} arrays")
    return cls(**{f: _to_tensor(a, _baseline_dtype(f), dev)
                  for f, a in fields.items()})


def ht_state_from_numpy(arrays, *, device=None) -> HTState:
    """An ``HTState`` of tensors from its five arrays in field order (a JAX
    ``HTState`` passes as it is)."""
    return _baseline_from_numpy(HTState, arrays, device)


def hti_state_from_numpy(arrays, *, device=None) -> HTIState:
    """An ``HTIState`` of tensors from its eleven arrays in field order."""
    return _baseline_from_numpy(HTIState, arrays, device)


def ch_state_from_numpy(arrays, *, device=None) -> CHState:
    """A ``CHState`` of tensors from its seven arrays in field order."""
    return _baseline_from_numpy(CHState, arrays, device)


def ht_state_to_numpy(st: HTState) -> HTState:
    """The same state with numpy arrays (uint32, int32 as in the JAX
    package)."""
    return HTState(*(a.cpu().numpy() for a in st))


def hti_state_to_numpy(st: HTIState) -> HTIState:
    return HTIState(*(a.cpu().numpy() for a in st))


def ch_state_to_numpy(st: CHState) -> CHState:
    return CHState(*(a.cpu().numpy() for a in st))


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


def _float_tensor(a, dtype, device) -> torch.Tensor:
    """A float array (bfloat16 too) as a tensor of ``dtype``, by default
    bfloat16 for a bfloat16 array and float32 otherwise."""
    a = np.asarray(a)
    if dtype is None:
        dtype = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=device, dtype=dtype)


def _float_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def paged_cache_from_numpy(arrays, *, dtype=None, device=None) -> PagedKVCache:
    """A ``PagedKVCache`` of tensors from its seven arrays in field order (a
    JAX ``PagedKVCache`` passes as it is); pools of ``dtype`` (default:
    bfloat16 for bfloat16 arrays, else float32), the rest int32."""
    dev = resolve_device(device)
    fields = dict(zip(PagedKVCache._fields, arrays))
    if len(fields) != len(PagedKVCache._fields):
        raise ValueError(f"expected {len(PagedKVCache._fields)} arrays")
    return PagedKVCache(**{
        f: (_float_tensor(a, dtype, dev) if f.endswith("_pool")
            else _to_tensor(a, np.int32, dev)) for f, a in fields.items()})


def paged_cache_to_numpy(cache: PagedKVCache) -> PagedKVCache:
    """The same cache with numpy arrays; bfloat16 pools as float32."""
    return PagedKVCache(*(_float_numpy(a) for a in cache))


def kv_view_from_numpy(view, *, dtype=None, device=None) -> tuple:
    """``(view_k, view_v)`` tensors from two float arrays."""
    dev = resolve_device(device)
    return tuple(_float_tensor(a, dtype, dev) for a in view)


def kv_view_to_numpy(view) -> tuple:
    """``(view_k, view_v)`` as numpy; bfloat16 as float32."""
    return tuple(_float_numpy(a) for a in view)


#: parameters the reference keeps in float32 whatever the model dtype: the
#: MoE router and the SSM's A_log, D and dt_bias
FLOAT32_PARAMS = ("router", "A_log", "D", "dt_bias")


def params_from_numpy(tree, *, dtype=None, device=None):
    """Model parameters as tensors from the JAX parameter pytree (a nested
    dict of arrays: ``embed``, ``layers`` with its stacked (L, ...) arrays,
    ``final_norm``, and ``lm_head`` when the embedding is not tied), each
    array of ``dtype`` (default: bfloat16 for bfloat16 arrays, else
    float32) on ``device``; the members named in :data:`FLOAT32_PARAMS`
    stay float32, as the reference's ``init_params`` makes them."""
    dev = resolve_device(device)

    def conv(x, name):
        if isinstance(x, dict):
            return {k: conv(v, k) for k, v in x.items()}
        return _float_tensor(
            x, torch.float32 if name in FLOAT32_PARAMS else dtype, dev)

    return conv(tree, None)


def params_to_numpy(tree):
    """The same nested dict with numpy arrays; bfloat16 as float32."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return _float_numpy(tree)


def decode_state_from_numpy(arrays, *, dtype=None, device=None):
    """A serve ``DecodeState`` of tensors from its five members in field
    order (a JAX ``DecodeState`` passes as it is); () members stay ().  The
    views and ``ssm_conv`` take ``dtype`` (default: bfloat16 for bfloat16
    arrays, else float32), ``ssm_state`` is float32 and ``ctx_len`` int32."""
    dev = resolve_device(device)
    fields = dict(zip(DecodeState._fields, arrays))
    if len(fields) != len(DecodeState._fields):
        raise ValueError(f"expected {len(DecodeState._fields)} members")
    return DecodeState(**{
        f: (() if isinstance(a, tuple) else
            _to_tensor(a, np.int32, dev) if f == "ctx_len" else
            _float_tensor(a, torch.float32 if f == "ssm_state" else dtype,
                          dev)) for f, a in fields.items()})


def decode_state_to_numpy(state):
    """The same state with numpy arrays (() stays ()); bfloat16 as
    float32."""
    return type(state)(*(() if isinstance(a, tuple) else _float_numpy(a)
                         for a in state))


def opt_state_from_numpy(state, *, device=None) -> AdamWState:
    """An ``AdamWState`` of tensors from the reference's (a JAX
    ``AdamWState`` passes as it is): the step int32, every moment float32,
    a factored entry's ``{"vr", "vc"}`` kept as its dictionary."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return _float_tensor(x, torch.float32, dev)

    step, m, v = state
    return AdamWState(step=_to_tensor(step, np.int32, dev), m=conv(m),
                      v=conv(v))


def opt_state_to_numpy(state: AdamWState) -> AdamWState:
    """The same state with numpy arrays."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return _float_numpy(x)

    return AdamWState(step=state.step.cpu().numpy(), m=conv(state.m),
                      v=conv(state.v))
