"""Learning-rate schedules (twin of ``repro/optim/schedule.py``): pure
functions of the step, a number or a tensor, returning a float32 tensor on
the step's device."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def wsd_schedule(step, *, peak_lr: float, warmup_steps: int,
                 total_steps: int, decay_frac: float = 0.2,
                 floor: float = 0.1) -> torch.Tensor:
    """Warmup-Stable-Decay: linear warmup, flat plateau, linear decay to
    ``floor * peak`` over the last ``decay_frac`` of training."""
    step = _step(step)
    warm = step / max(warmup_steps, 1)
    decay_steps = max(int(total_steps * decay_frac), 1)
    decay_start = total_steps - decay_steps
    decay = 1.0 - (1.0 - floor) * torch.clamp(
        (step - decay_start) / decay_steps, 0.0, 1.0)
    return peak_lr * torch.minimum(warm.clamp(max=1.0), decay)


def cosine_schedule(step, *, peak_lr: float, warmup_steps: int,
                    total_steps: int, floor: float = 0.1) -> torch.Tensor:
    step = _step(step)
    warm = (step / max(warmup_steps, 1)).clamp(max=1.0)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return peak_lr * warm * cos
