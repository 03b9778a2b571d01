"""LR / WD / momentum schedules (port of cmx/train/schedules.py):
float-valued functions of the step (an int or a 0-d tensor), returning 0-d
fp32 tensors; the optimizers call them with their own step count, as
optax's inject_hyperparams does."""

from __future__ import annotations

import math
from typing import Callable

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(peak: float, total_steps: int, warmup_steps: int,
                  final_ratio: float = 0.0) -> Callable:
    """Linear 0->peak over warmup, cosine peak->peak*final_ratio after."""
    floor = peak * final_ratio

    def fn(step):
        step = _step(step)
        warm = peak * step / max(warmup_steps, 1)
        t = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        t = torch.clamp(t, 0.0, 1.0)
        cos = floor + (peak - floor) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, cos)

    return fn


def cosine_anneal(start: float, end: float, total_steps: int) -> Callable:
    """start -> end over total_steps on a half-cosine."""

    def fn(step):
        t = torch.clamp(_step(step) / max(total_steps, 1), 0.0, 1.0)
        return end + (start - end) * 0.5 * (1 + torch.cos(math.pi * t))

    return fn


def scaled_base_lr(base_lr: float, global_batch: int, denom: int = 256) -> float:
    """The linear-scaling rule: lr = base * batch / denom."""
    return base_lr * global_batch / denom


def step_decay(base: float, step_size: int, gamma: float = 0.5) -> Callable:
    """StepLR: base * gamma^(step // step_size) (Genesis_Chest_CT.py:88-92)."""

    def fn(step):
        k = torch.floor(_step(step) / step_size)
        return base * torch.pow(torch.tensor(gamma, dtype=torch.float32), k)

    return fn


def constant(value: float) -> Callable:
    def fn(step):
        return torch.tensor(value, dtype=torch.float32)

    return fn


def ema_momentum_cosine(base: float, end: float, total_steps: int) -> Callable:
    """Cosine ramp of the EMA momentum base -> end
    (momentum_update_hook.py:29-40): m = end - (end - base) * (cos(pi t) + 1) / 2."""

    def fn(step):
        t = torch.clamp(_step(step) / max(total_steps, 1), 0.0, 1.0)
        return end - (end - base) * (torch.cos(math.pi * t) + 1) / 2

    return fn
