"""The training step (twin of ``repro/runtime/train.py``).

``make_train_step`` builds a ``(params, opt, batch) -> (params, opt,
metrics)`` step with:

  * activation rematerialization (``remat``: a per-layer
    ``torch.utils.checkpoint`` inside the model's forward),
  * gradient accumulation over ``grad_accum`` microbatches (the batch's
    leading axis split; peak activation memory is one microbatch's), the
    microbatch gradients summed in float32 buffers as the reference's
    ``lax.scan`` sums them,
  * AdamW (optionally factored) with global-norm clipping, updating the
    parameters and the optimizer state in place, as the reference's jitted
    step does with donated buffers.

Training launches no hand-written kernel of the port: the model attends
through ``attention.loop_attention`` under autograd (the flash kernel has no
backward pass).  Each step's work runs inside ``torch.profiler``
``record_function`` spans: :data:`FORWARD_SPAN` around each microbatch's
forward, :data:`BACKWARD_SPAN` around its backward call (on CUDA the
backward's kernels run on the autograd engine's device thread, outside the
span; a trace finds them under its ``autograd::engine::evaluate_function``
events) and :data:`OPTIMIZER_SPAN` around the update.

:func:`param_struct` and :func:`opt_struct` give the parameters and the
optimizer state as meta tensors, which hold no storage (the dry run's
stand-ins).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     tree_leaves, tree_unflatten)

#: the profiler spans of a step
FORWARD_SPAN = "repro_torch.train.forward"
BACKWARD_SPAN = "repro_torch.train.backward"
OPTIMIZER_SPAN = "repro_torch.train.optimizer"


class TrainStep(NamedTuple):
    fn: Callable          # (params, opt, batch) -> (params, opt, metrics)
    grad_accum: int


def _split_microbatches(batch: dict, n: int, device) -> list:
    """(B, ...) -> n dictionaries of (B/n, ...) views, on ``device``."""
    out: list = [{} for _ in range(n)]
    for k, x in batch.items():
        x = torch.as_tensor(x, device=device)
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by grad_accum {n}")
        parts = x.reshape((n, b // n) + tuple(x.shape[1:]))
        for i in range(n):
            out[i][k] = parts[i]
    return out


def _grad(cfg: ArchConfig, params, batch: dict, remat: bool):
    """(loss, gradients in the parameters' dtypes, in ``tree_leaves``
    order) of one microbatch; an unused parameter's gradient is zeros."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.profiler.record_function(FORWARD_SPAN):
        loss = M.train_forward(tree_unflatten(params, leaves), cfg, batch,
                               remat=remat)
    with torch.profiler.record_function(BACKWARD_SPAN):
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return loss.detach(), grads


def loss_and_grads(cfg: ArchConfig, params, batch: dict, *,
                   grad_accum: int = 1, remat: bool = True):
    """The step's mean loss and gradient tree: with ``grad_accum`` 1 the
    gradients in the parameters' dtypes, else the float32 mean of the
    microbatches' gradients."""
    device = tree_leaves(params)[0].device
    micro = _split_microbatches(batch, grad_accum, device)
    if grad_accum == 1:
        loss, grads = _grad(cfg, params, micro[0], remat)
        return loss, tree_unflatten(params, grads)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in tree_leaves(params)]
    total = torch.zeros((), dtype=torch.float32, device=device)
    for mb in micro:
        loss, grads = _grad(cfg, params, mb, remat)
        for a, g in zip(acc, grads):
            a.add_(g)
        del grads
        total = total + loss
    for a in acc:
        a.div_(grad_accum)
    return total / grad_accum, tree_unflatten(params, acc)


def make_train_step(cfg: ArchConfig, *, lr_fn: Callable,
                    grad_accum: int = 1, remat: bool = True,
                    factored: bool = False,
                    weight_decay: float = 0.1,
                    clip_norm: Optional[float] = 1.0) -> TrainStep:
    """``lr_fn(step)``: the learning rate at the optimizer's step counter
    (a () int32 tensor), e.g. ``optim.schedule.wsd_schedule``.  The step
    returns the same ``params`` (updated in place), a new ``AdamWState``
    over the updated moments, and metrics of () tensors: ``loss``, ``lr``,
    ``grad_norm`` and ``clip_scale``."""

    def step(params, opt: AdamWState, batch: dict):
        loss, grads = loss_and_grads(cfg, params, batch,
                                     grad_accum=grad_accum, remat=remat)
        with torch.profiler.record_function(OPTIMIZER_SPAN):
            lr = lr_fn(opt.step)
            params, opt, om = adamw_update(
                grads, opt, params, lr=lr, weight_decay=weight_decay,
                clip_norm=clip_norm, factored=factored)
        return params, opt, {"loss": loss, "lr": lr, **om}

    return TrainStep(fn=step, grad_accum=grad_accum)


def param_struct(cfg: ArchConfig, dtype=torch.bfloat16) -> dict:
    """The parameters' shapes and dtypes as meta tensors: ``init_params``'s
    tree, nothing drawn or allocated."""
    return M.build_params(cfg, None, dtype, torch.device("meta"))


def opt_struct(params_struct, factored: bool = False) -> AdamWState:
    """``adamw_init`` over meta parameters: the optimizer state's shapes
    and dtypes on the meta device."""
    return adamw_init(params_struct, factored=factored)
