"""The train step (port of cmx/train/trainer.py:57-107).

A task is a `Task`: `loss_fn(model, batch, gen, draws)` returning
`(loss, metrics)`; BN running stats update in place during its forward.
The step: step-keyed randomness, loss and gradients, the global gradient
norm, the optimizer update, and the NaN guard, which keeps parameters,
optimizer state and BN running stats when the loss or the gradient norm is
not finite (decided on the device; no host synchronisation).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from cmx_torch.train.optim import global_grad_norm
from cmx_torch.train.state import TrainState


@dataclasses.dataclass
class Task:
    name: str
    loss_fn: Callable


def make_train_step(task: Task, tx) -> Callable:
    """step(state, batch, draws=None) -> metrics; updates `state` in place.

    Metrics: the task's (SparK: `recon`), `loss`, `grad_norm`, `nonfinite`
    (0-d device tensors)."""

    def step(state: TrainState, batch: torch.Tensor,
             draws: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, torch.Tensor]:
        model = state.model
        model.train()
        gen = state.step_generator(batch.device)
        buffers = list(model.buffers())
        old_buffers = [b.clone() for b in buffers]
        params = tx.params
        loss, metrics = task.loss_fn(model, batch, gen, draws)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        gnorm = global_grad_norm(grads)
        finite = torch.isfinite(loss) & torch.isfinite(gnorm)
        tx.step(grads, finite)
        with torch.no_grad():
            for b, old in zip(buffers, old_buffers):
                b.copy_(torch.where(finite, b, old))
        state.step += 1
        metrics = dict(metrics)
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = gnorm
        metrics["nonfinite"] = 1.0 - finite.float()
        return metrics

    return step
