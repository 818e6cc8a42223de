"""Learning-rate schedules (``repro.optim.schedules``'s counterpart).

Each returns a function of the step (an integer tensor or int) to a 0-d f32
tensor, computed in f32 as the reference computes it (Python doubles would
part from it in the last bit).
"""

from __future__ import annotations

import math

import torch


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine_decay(lr: float, steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(_f32(step) / steps, max=1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return torch.tensor(lr, dtype=torch.float32) * (
            final_frac + (1 - final_frac) * cos)
    return fn


def linear_warmup_cosine(lr: float, warmup: int, steps: int,
                         final_frac: float = 0.1):
    decay = cosine_decay(lr, max(steps - warmup, 1), final_frac)

    def fn(step):
        step = torch.as_tensor(step)
        warm = torch.tensor(lr, dtype=torch.float32) * _f32(step) \
            / max(warmup, 1)
        return torch.where(step < warmup, warm, decay(step - warmup))
    return fn
