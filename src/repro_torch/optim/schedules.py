"""Learning-rate schedules (the port of ``src/repro/optim/schedules.py``):
functions of the step (a Python int or an int tensor) returning a 0-d f32
tensor."""
from __future__ import annotations

import math

import torch


def constant(value: float):
    return lambda step: torch.tensor(value, dtype=torch.float32)


def cosine_decay(peak: float, decay_steps: int, floor: float = 0.0):
    def fn(step):
        t = torch.clamp(torch.as_tensor(step) / max(decay_steps, 1), 0.0, 1.0)
        return floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * t))

    return fn


def warmup_cosine(peak: float, warmup_steps: int, decay_steps: int, floor: float = 0.0):
    cos = cosine_decay(peak, max(decay_steps - warmup_steps, 1), floor)

    def fn(step):
        step = torch.as_tensor(step)
        warm = peak * step / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm, cos(step - warmup_steps))

    return fn
