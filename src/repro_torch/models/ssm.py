"""Mamba2 / SSD (state-space duality) mixer, arXiv:2405.21060 (twin of
``repro/models/ssm.py``).

Training and prefill run the chunked SSD algorithm: quadratic within fixed
chunks (the products), plus a linear recurrence over the chunks' states,
which the reference's ``lax.scan`` becomes a Python loop over the chunks.
Decode is the single-step selective-scan recurrence over the ``(B, H, P,
N)`` state plus a small causal-conv window.  ``A_log``, ``D``, ``dt_bias`` and the
state are float32 whatever the model dtype, and every product of the
recurrence takes float32 operands.

Single B/C group (n_groups=1), as in the released mamba2 configs.  The
layer's work runs inside a ``torch.profiler.record_function`` span named
:data:`SPAN`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _dense_init, rms_norm

#: the profiler span around :func:`ssm_apply` and :func:`ssm_decode`
SPAN = "repro_torch.ssm"


class SSMCache(NamedTuple):
    """Decode-time state for one layer (stacked over layers by the runtime)."""
    conv: torch.Tensor   # (B, d_conv-1, d_inner + 2*N) pre-conv window
    state: torch.Tensor  # (B, H, P, N) float32


def ssm_init(gen: torch.Generator, cfg, dtype, device) -> dict:
    d, di, n, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * n
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": _dense_init(gen, (d, 2 * di + 2 * n + h), d, dtype, device),
        "out_proj": _dense_init(gen, (di, d), di, dtype, device),
        "conv_w": _dense_init(gen, (cfg.ssm_conv, conv_dim), cfg.ssm_conv,
                              dtype, device),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "D": torch.ones((h,), **f32),
        "dt_bias": torch.zeros((h,), **f32),
        "norm": torch.zeros((di,), dtype=dtype, device=device),
    }


def _split_proj(cfg, zxbcdt: torch.Tensor):
    di, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + di + 2 * n]
    dt = zxbcdt[..., di + di + 2 * n:di + di + 2 * n + h]
    return z, xBC, dt


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via shifted adds (d_conv is small: 4), in the
    input's dtype as the reference computes it."""
    d_conv = w.shape[0]
    out = xBC * w[-1]
    for j in range(1, d_conv):
        shifted = F.pad(xBC, (0, 0, j, 0))[:, :-j]
        out = out + shifted * w[-1 - j]
    return F.silu(out + b)


def ssd_chunked(x, dt, A, B, C, D, chunk: int):
    """SSD forward.  x: (B,S,H,P); dt: (B,S,H) float32; A: (H,) negative;
    B,C: (B,S,N); D: (H,).  Returns (y (B,S,H,P) in x's dtype, final state
    (B,H,P,N) float32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    if pad:  # zero-pad: dt = 0 makes padded steps identity/no-contribution
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    s_padded = s + pad
    nc = s_padded // chunk
    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n).float()
    Cc = C.reshape(b, nc, chunk, n).float()

    dA = dtc * A                                       # (b,nc,q,h), negative
    cs = torch.cumsum(dA, dim=2)                       # cumulative in chunk

    # 1. intra-chunk (quadratic in chunk): Y_ij = C_i B_j^T L_ij dt_j x_j
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    # mask the exponent BEFORE exp, as the reference (exp of the positive
    # upper-triangular entries would be inf)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    delta = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # (b,nc,i,j,h)
    delta = torch.where(tri[None, None, :, :, None], delta, -1e30)
    # the reference's five-operand einsum as pairwise products, so that no
    # (..., j, h, p) intermediate is formed: L = exp(delta), then
    # L * scores * dt_j, then the product over j with x.  Without a gradient
    # to record the two products write into exp's output (a prefill's peak
    # holds one (b, nc, Q, Q, h) tensor); under autograd they cannot, since
    # exp's backward reads its output
    if delta.requires_grad or scores.requires_grad:
        w = delta.exp() * scores[..., None] * dtc[:, :, None]
    else:
        w = delta.exp_().mul_(scores[..., None]).mul_(dtc[:, :, None])
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", w, xc)
    del w, delta

    # 2. per-chunk input state contribution
    chunk_sum = cs[:, :, -1, :]                        # (b,nc,h)
    decay_to_end = torch.exp(chunk_sum[:, :, None, :] - cs)  # (b,nc,q,h)
    states = torch.einsum("bcqn,bcqhp->bchpn", Bc,
                          (dtc * decay_to_end)[..., None] * xc)

    # 3. inter-chunk recurrence: each chunk sees the state entering it
    decay = torch.exp(chunk_sum)                       # (b,nc,h)
    carry = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)             # (b,nc,h,p,n)

    # 4. state -> output within chunk
    y_off = torch.einsum("bcqn,bchpn->bcqhp", Cc, prev_states) \
        * torch.exp(cs)[..., None]
    y = (y_diag + y_off).reshape(b, s_padded, h, p) \
        + D[:, None] * x.float()
    return y[:, :s].to(x.dtype), carry


def ssm_apply(p: dict, x: torch.Tensor, cfg) -> tuple:
    """Full-sequence (training or prefill) pass.  x: (B, S, D) -> (out
    (B, S, D), SSMCache for decode)."""
    with torch.profiler.record_function(SPAN):
        return _ssm_apply(p, x, cfg)


def _ssm_apply(p: dict, x: torch.Tensor, cfg) -> tuple:
    Bsz, S, _ = x.shape
    di, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    z, xBC_raw, dt = _split_proj(cfg, x @ p["in_proj"])
    xBC = _causal_conv(xBC_raw, p["conv_w"], p["conv_b"])
    xs = xBC[..., :di].reshape(Bsz, S, h, cfg.ssm_head_dim)
    Bm = xBC[..., di:di + n]
    Cm = xBC[..., di + n:]
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, final = ssd_chunked(xs, dt, A, Bm, Cm, p["D"], cfg.ssm_chunk)
    y = y.reshape(Bsz, S, di) * F.silu(z.float()).to(y.dtype)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    # decode conv window = the last d_conv-1 *pre-conv* xBC inputs
    dc = cfg.ssm_conv
    conv_tail = F.pad(xBC_raw, (0, 0, dc - 1, 0))[:, S:, :]
    return out, SSMCache(conv=conv_tail, state=final)


def ssm_decode(p: dict, x: torch.Tensor, cache: SSMCache, cfg) -> tuple:
    """Single-token step.  x: (B, D) -> (out (B, D), new SSMCache)."""
    with torch.profiler.record_function(SPAN):
        return _ssm_decode(p, x, cache, cfg)


def _ssm_decode(p: dict, x: torch.Tensor, cache: SSMCache, cfg) -> tuple:
    Bsz = x.shape[0]
    di, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    z, xBC_t, dt = _split_proj(cfg, x @ p["in_proj"])
    window = torch.cat([cache.conv, xBC_t[:, None]], dim=1)  # (B, dc, .)
    conv_out = F.silu(
        torch.einsum("bjc,jc->bc", window.float(), p["conv_w"].float())
        + p["conv_b"].float()).to(x.dtype)
    xs = conv_out[..., :di].reshape(Bsz, h, cfg.ssm_head_dim).float()
    Bm = conv_out[..., di:di + n].float()
    Cm = conv_out[..., di + n:].float()
    dt = F.softplus(dt.float() + p["dt_bias"])                 # (B, h)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)                                     # (B, h)
    state = cache.state * dA[:, :, None, None] \
        + (xs * dt[..., None])[..., None] * Bm[:, None, None, :]
    y = torch.einsum("bn,bhpn->bhp", Cm, state) + p["D"][:, None] * xs
    y = y.reshape(Bsz, di).to(x.dtype) * F.silu(z.float()).to(x.dtype)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], SSMCache(conv=window[:, 1:], state=state)


def ssm_cache_init(cfg, batch: int, dtype, device) -> SSMCache:
    di, n = cfg.ssm_d_inner, cfg.ssm_state
    return SSMCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * n), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                           cfg.ssm_state), dtype=torch.float32,
                          device=device))
