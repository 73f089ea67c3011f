"""Learning-rate schedules (warmup-cosine / linear / rsqrt).

The JAX package's ``train/schedule.py`` on PyTorch: each schedule maps a
step (an int or a tensor, on any device) to a float32 tensor on the
step's device, in the reference's float32 arithmetic.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1):
    def fn(step):
        s = _f32(step)
        warm = s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps) /
                           max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return peak * torch.where(s < warmup_steps, warm, cos)
    return fn


def warmup_linear(peak: float, warmup_steps: int, total_steps: int):
    def fn(step):
        s = _f32(step)
        warm = s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps) /
                           max(total_steps - warmup_steps, 1), 0.0, 1.0)
        return peak * torch.where(s < warmup_steps, warm, 1.0 - prog)
    return fn


def warmup_rsqrt(peak: float, warmup_steps: int):
    def fn(step):
        s = torch.clamp(_f32(step), min=1.0)
        warm = s / max(warmup_steps, 1)
        return peak * torch.where(s < warmup_steps, warm,
                                  torch.sqrt(warmup_steps / s))
    return fn
