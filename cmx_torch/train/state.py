"""Train state (port of cmx/train/state.py).

cmx threads one immutable pytree through a jitted step; here the state
holds the live module (parameters and BN running stats), the optimizer
(with its state), the step counter and the task-owned `extra` (MoCo: the
key encoder module, its queue and pointer; None for SparK), and the step
updates them in place. Randomness is keyed by (seed, step) as cmx's
fold_in(rng, step).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable

import torch
import torch.nn as nn


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    opt: Any
    seed: int = 0
    extra: Any = None  # task-owned state: a dict of tensors and modules

    @classmethod
    def create(cls, *, model: nn.Module, tx: Any, seed: int = 0,
               extra: Any = None) -> "TrainState":
        return cls(step=0, model=model, opt=tx, seed=seed, extra=extra)

    def step_seed(self) -> int:
        """The seed of this step's draws, from (seed, step)."""
        return (self.seed * 1_000_003 + self.step) % (2 ** 63)

    def step_generator(self, device) -> torch.Generator:
        """A generator on `device` seeded from (seed, step): the step's
        draws do not depend on how many draws earlier steps made. (A
        generator re-seeded with `step_seed()` draws the same numbers:
        cmx_torch.train.graph keeps one for a run.)"""
        gen = torch.Generator(device=device)
        gen.manual_seed(self.step_seed())
        return gen


@torch.no_grad()
def ema_update(ema: Iterable[torch.Tensor], new: Iterable[torch.Tensor],
               momentum) -> None:
    """ema <- m * ema + (1 - m) * new, tensor by tensor, in place."""
    for e, p in zip(ema, new):
        e.copy_(momentum * e + (1.0 - momentum) * p)
