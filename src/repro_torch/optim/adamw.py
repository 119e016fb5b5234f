"""AdamW with an optionally factored second moment (Adafactor-style), plus
global-norm clipping (twin of ``repro/optim/adamw.py``).

States mirror the parameter tree (nested dictionaries of tensors): ``m``
float32 and parameter-shaped; ``v`` float32, parameter-shaped or, with
``factored=True`` for a leaf of at least two axes whose last two are at
least 128 long, the row and column statistics ``{"vr": ..., "vc": ...}``.

The reference updates each leaf whole in float32.  Here :func:`adamw_update`
updates ``m``, ``v`` and the parameters in place, slice by slice along the
leaf's first axis (a stack's layer axis), each slice at most
:data:`SLICE_ELEMS` elements, so that the float32 temporaries stay at about
one layer's size (a whole-leaf temporary of qwen3_4b's stacked MLP ``wi``
would be 7.2 GB).  The arithmetic of each element is the reference's, so
the slices give what a whole-leaf update gives.
"""
from __future__ import annotations

from typing import Any, Iterator, NamedTuple, Optional

import torch

#: the most elements of one slice of a leaf in :func:`adamw_update` (its
#: float32 temporaries are 256 MB each)
SLICE_ELEMS = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32, on the parameters' device
    m: Any               # first moment, parameter-shaped, float32
    v: Any               # second moment: parameter-shaped or {"vr", "vc"}


def tree_leaves(tree) -> list:
    """The tensors of a tree of nested dictionaries, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """``leaves`` (in :func:`tree_leaves`'s order) in the structure of
    ``like``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        return next(it)
    return build(like)


def tree_map(fn, tree) -> Any:
    return tree_unflatten(tree, [fn(t) for t in tree_leaves(tree)])


def _zip(params, *others) -> Iterator[tuple]:
    """(leaf, the matching subtree of each of ``others``) over ``params``'s
    leaves: a factored ``v`` entry comes as its dictionary."""
    if isinstance(params, dict):
        for k, p in params.items():
            yield from _zip(p, *(o[k] for o in others))
    else:
        yield (params, *others)


def _is_factored_leaf(p: torch.Tensor, factored: bool) -> bool:
    return factored and p.dim() >= 2 and p.shape[-1] >= 128 \
        and p.shape[-2] >= 128


def adamw_init(params, factored: bool = False) -> AdamWState:
    def v_init(p):
        if _is_factored_leaf(p, factored):
            return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                      device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=torch.float32, device=p.device)}
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    first = tree_leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params),
        v=tree_unflatten(params, [v_init(p) for p in tree_leaves(params)]))


def _slices(p: torch.Tensor, whole: bool = False) -> Iterator:
    """Index ranges along ``p``'s first axis, each of at most
    ``SLICE_ELEMS`` elements (one row at least); all of ``p`` for a scalar
    or with ``whole``."""
    if whole or p.dim() == 0:
        yield slice(None)
        return
    rows = max(1, SLICE_ELEMS // max(p[0].numel(), 1))
    for r0 in range(0, p.shape[0], rows):
        yield slice(r0, r0 + rows)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (summed slice
    by slice)."""
    total = None
    for g in tree_leaves(tree):
        for sl in _slices(g):
            s = g[sl].float().square().sum()
            total = s if total is None else total + s
    return total.sqrt()


def adamw_update(grads, state: AdamWState, params, *,
                 lr, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 clip_norm: Optional[float] = 1.0, factored: bool = False):
    """One AdamW step, in place: ``params``, ``state.m`` and ``state.v``
    are written and returned as (params, new state, metrics) with the step
    counter advanced.  ``lr``: a number or a () tensor.  ``factored`` is
    accepted for the reference's signature; the state's entries decide."""
    with torch.no_grad():
        gnorm = global_norm(grads)
        if clip_norm is None:
            scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
        else:
            clip = clip_norm or 1.0
            scale = torch.where(gnorm > clip, clip / gnorm.clamp_min(1e-12),
                                torch.ones_like(gnorm))
        step = state.step + 1
        bc1 = 1.0 - torch.pow(b1, step.float())
        bc2 = 1.0 - torch.pow(b2, step.float())
        for p, g, m, v in _zip(params, grads, state.m, state.v):
            fac = isinstance(v, dict)
            # a factored 2-D leaf's column statistic reduces over its rows
            for sl in _slices(p, whole=fac and p.dim() == 2):
                _update(p[sl], g[sl], m[sl],
                        {k: x[sl] for k, x in v.items()} if fac else v[sl],
                        scale=scale, lr=lr, b1=b1, b2=b2, eps=eps,
                        weight_decay=weight_decay, bc1=bc1, bc2=bc2)
    metrics = {"grad_norm": gnorm, "clip_scale": scale}
    return params, AdamWState(step=step, m=state.m, v=state.v), metrics


def _update(p, g, m, v, *, scale, lr, b1, b2, eps, weight_decay, bc1, bc2):
    """The reference's per-leaf arithmetic on one slice, written back into
    ``p``, ``m`` and ``v``."""
    g = g.float() * scale
    m_new = b1 * m + (1 - b1) * g
    if isinstance(v, dict):  # factored second moment
        g2 = g.square() + 1e-30
        vr = b2 * v["vr"] + (1 - b2) * g2.mean(dim=-1)
        vc = b2 * v["vc"] + (1 - b2) * g2.mean(dim=-2)
        # rank-1 reconstruction v ~= vr vc / mean(vr)
        denom = vr.mean(dim=-1, keepdim=True).clamp_min(1e-30)
        vhat = (vr[..., None] * vc[..., None, :] / denom[..., None]) / bc2
        v["vr"].copy_(vr)
        v["vc"].copy_(vc)
    else:
        v_new = b2 * v + (1 - b2) * g.square()
        vhat = v_new / bc2
        v.copy_(v_new)
    update = (m_new / bc1) / (vhat.sqrt() + eps)
    p32 = p.float()
    p.copy_(p32 - lr * (update + weight_decay * p32))
    m.copy_(m_new)
