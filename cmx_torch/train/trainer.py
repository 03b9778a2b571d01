"""The train step (port of cmx/train/trainer.py:36-107).

A task is a `Task`: `loss_fn(model, batch, gen, draws, extra)` returning
`(loss, TaskAux)`; BN running stats (the model's and those of modules in
`extra`) update in place during its forward. An optional
`post_update(state, aux)` refreshes the task state after the optimizer
update (MoCo: key-encoder EMA, queue): it returns `(target, new value)`
pairs, all computed before any is written. The step: step-keyed
randomness, loss and gradients, the global gradient norm, the optimizer
update, the post-update, and the NaN guard, which keeps parameters,
optimizer state, BN running stats and every tensor of `extra` when the loss
or the gradient norm is not finite (decided on the device; no host
synchronisation).

Under data parallel (cmx_torch.parallel.mesh) every rank runs the step on
its B/W rows of the global batch: the task's draws are made for the global
batch and sliced (`mesh.rank_slice`), its loss is the global loss on every
rank, and the gradients are summed over the ranks in one all-reduce before
the norm, so the guard, the update and the post-update are the same on
every rank and the replicas stay equal bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.nn as nn

from cmx_torch.parallel import mesh
from cmx_torch.train.optim import global_grad_norm
from cmx_torch.train.state import TrainState


@dataclasses.dataclass
class TaskAux:
    """What a task's loss_fn returns besides the loss."""

    metrics: Dict[str, torch.Tensor]
    updates: Any = None  # payload for post_update (MoCo: this step's keys)


@dataclasses.dataclass
class Task:
    name: str
    loss_fn: Callable
    post_update: Optional[Callable] = None
    init_extra: Optional[Callable] = None  # gen -> the task's `extra`


def extra_buffers(extra: Any) -> List[torch.Tensor]:
    """Buffers of the modules held in `extra` (updated in place by their
    forward, so the guard restores them from a copy)."""
    if not isinstance(extra, dict):
        return []
    return [b for v in extra.values() if isinstance(v, nn.Module)
            for b in v.buffers()]


def make_train_step(task: Task, tx) -> Callable:
    """step(state, batch, draws=None) -> metrics; updates `state` in place.

    Metrics: the task's (SparK: `recon`; MoCo: `acc1`, `acc5`; supervised:
    `dice_loss`, `cross_entropy_loss`, `iou_loss`), `loss`,
    `grad_norm`, `nonfinite` (0-d device tensors)."""

    def step(state: TrainState, batch: Any,
             draws: Optional[Dict[str, Any]] = None
             ) -> Dict[str, torch.Tensor]:
        model = state.model
        model.train()
        # a tensor (SparK, MoCo) or a tuple of tensors (supervised: images,
        # masks): the step's generator lives on the first one's device
        lead = batch[0] if isinstance(batch, (tuple, list)) else batch
        gen = state.step_generator(lead.device)
        buffers = list(model.buffers()) + extra_buffers(state.extra)
        old_buffers = [b.clone() for b in buffers]
        params = tx.params
        loss, aux = task.loss_fn(model, batch, gen, draws, state.extra)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = mesh.all_reduce_tensors(
            [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)])
        gnorm = global_grad_norm(grads)
        finite = torch.isfinite(loss) & torch.isfinite(gnorm)
        tx.step(grads, finite)
        with torch.no_grad():
            for b, old in zip(buffers, old_buffers):
                b.copy_(torch.where(finite, b, old))
            if task.post_update is not None:
                for target, new in task.post_update(state, aux):
                    target.copy_(torch.where(finite, new, target))
        state.step += 1
        metrics = dict(aux.metrics)
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = gnorm
        metrics["nonfinite"] = 1.0 - finite.float()
        return metrics

    return step
