"""Shared neural-net building blocks (twin of ``repro/models/layers.py``):
pure functions over dictionaries of tensors.

Initializers take an explicit ``torch.Generator`` and ``device``; they draw
other numbers than ``jax.random`` from the same seed, so the tests carry the
JAX package's parameters across (``convert.params_from_numpy``).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap)


class _GradBF16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ct.to(torch.bfloat16).to(ct.dtype)


def grad_bf16(x: torch.Tensor) -> torch.Tensor:
    """Identity whose cotangent is rounded to bfloat16 (the reference's
    ``custom_vjp``), placed at the mixer and FFN branch outputs.  Without a
    gradient to record it returns ``x`` itself, so the serving paths pay
    nothing for it."""
    return _GradBF16.apply(x) if x.requires_grad else x


# -- rotary position embedding ------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) float32 frequencies ``theta ** -(2i/head_dim)``, made
    once per (head_dim, theta, device): building them from a host scalar on
    every call would copy it to the card, and that copy waits for all the
    work queued before it."""
    return _rope_freqs(head_dim, float(theta), torch.device(device or "cpu"))


@functools.lru_cache(maxsize=None)
def _rope_freqs(head_dim: int, theta: float,
                device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
    return freqs.to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  Half-split
    rotation with float32 angles."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)          # (hd/2,)
    angles = positions[..., None].float() * freqs           # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- MLP -----------------------------------------------------------------------

def mlp_apply(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """SwiGLU/GeGLU MLP; ``wi`` fuses gate and up projections."""
    h = x @ p["wi"]                                         # (..., 2*ff)
    gate, up = h.chunk(2, dim=-1)
    return (activation(gate, act) * up) @ p["wo"]


def _dense_init(gen: torch.Generator, shape, fan_in: int, dtype,
                device) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * fan_in ** -0.5).to(dtype)


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype,
             device) -> dict:
    return {
        "wi": _dense_init(gen, (d_model, 2 * d_ff), d_model, dtype, device),
        "wo": _dense_init(gen, (d_ff, d_model), d_ff, dtype, device),
    }


def embed_init(gen: torch.Generator, vocab: int, d_model: int, dtype,
               device) -> torch.Tensor:
    return (torch.randn((vocab, d_model), generator=gen, dtype=torch.float32,
                        device=device) * 0.02).to(dtype)
