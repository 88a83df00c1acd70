"""Learning-rate schedules (step -> lr), the port of
``repro.optim.schedules``.  Each takes the step as an integer tensor
(the optimizer state's device counter) or an int and evaluates in
float32 on the step's device, as the reference does, so the step never
waits for the host."""

from __future__ import annotations

import math

import torch


def _step_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    def fn(step):
        return torch.full_like(_step_f32(step), lr)
    return fn


def warmup_cosine(peak: float, warmup: int, total: int,
                  floor_frac: float = 0.1):
    def fn(step):
        s = _step_f32(step)
        warm = peak * s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor_frac + (1 - floor_frac)
                      * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup, warm, cos)
    return fn


def warmup_rsqrt(peak: float, warmup: int):
    def fn(step):
        s = torch.clamp(_step_f32(step), min=1.0)
        return peak * torch.minimum(s / max(warmup, 1),
                                    torch.sqrt(warmup / s))
    return fn
