"""The train step (port of cmx/train/trainer.py:36-107).

A task is a `Task`: `loss_fn(model, batch, gen, draws, extra)` returning
`(loss, TaskAux)`; BN running stats (the model's and those of modules in
`extra`) update in place during its forward. An optional
`post_update(state, aux)` refreshes the task state after the optimizer
update (MoCo: key-encoder EMA, queue): it returns `(target, new value)`
pairs, all computed before any is written. The step is the body -- loss
and gradients, the global gradient norm, the optimizer update, the
post-update, and the NaN guard, which keeps parameters, optimizer state, BN
running stats and every tensor of `extra` when the loss or the gradient
norm is not finite (decided on the device; no host synchronisation) --
with draws from a generator seeded from (seed, step), then the host's
bookkeeping: the step counter. A CUDA graph captures the body alone
(cmx_torch.train.graph).

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


def make_train_body(task: Task, tx) -> Callable:
    """body(state, batch, gen, draws=None) -> metrics: one step's device
    work with the step's draws from `gen`, state updated in place; the
    step counter is not advanced. It makes no host synchronisation, no
    copy from the host and no tensor of a data-dependent shape, so a CUDA
    graph can capture it (cmx_torch.train.graph); its metrics are tensors
    the caller can hold.

    Metrics: the task's (SparK: `recon`; MoCo: `acc1`, `acc5`; supervised:
    `dice_loss`, `cross_entropy_loss`, `iou_loss`), `loss`,
    `grad_norm`, `nonfinite` (0-d device tensors)."""

    def body(state: TrainState, batch: Any, gen: torch.Generator,
             draws: Optional[Dict[str, Any]] = None
             ) -> Dict[str, torch.Tensor]:
        model = state.model
        model.train()
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
        metrics = dict(aux.metrics)
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = gnorm
        metrics["nonfinite"] = 1.0 - finite.float()
        return metrics

    return body


def make_train_step(task: Task, tx) -> Callable:
    """step(state, batch, draws=None) -> metrics (`make_train_body`'s);
    updates `state` in place: the body with a generator seeded from
    (seed, step) (`TrainState.step_generator`), then the step counter.
    `step.body` is the body."""
    body = make_train_body(task, tx)

    def step(state: TrainState, batch: Any,
             draws: Optional[Dict[str, Any]] = None
             ) -> Dict[str, torch.Tensor]:
        # a tensor (SparK, MoCo) or a tuple of tensors (supervised: images,
        # masks): the step's generator lives on the first one's device
        lead = batch[0] if isinstance(batch, (tuple, list)) else batch
        metrics = body(state, batch, state.step_generator(lead.device), draws)
        state.step += 1
        return metrics

    step.body = body
    return step


class Trainer:
    """Thin host-side wrapper (cmx/train/trainer.py's `Trainer`): the step
    of `task` and `tx`, fed a global batch. Under data parallel
    `prepare_state` makes every rank's state rank 0's, and `run_step` runs
    the step on this rank's rows of the global batch (`mesh.rank_slice`:
    what cmx's shard_batch lays on a device), so every rank returns the
    global batch's metrics. Epoch semantics live in the harnesses."""

    def __init__(self, task: Task, tx):
        self.task = task
        self.tx = tx
        self.step_fn = make_train_step(task, tx)

    def prepare_state(self, state: TrainState) -> TrainState:
        mesh.replicate(state.model, state.opt.state_dict(), state.extra)
        return state

    def run_step(self, state: TrainState, batch: Any,
                 draws: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, torch.Tensor]:
        rows = (tuple(mesh.rank_slice(x) for x in batch)
                if isinstance(batch, (tuple, list)) else
                mesh.rank_slice(batch))
        return self.step_fn(state, rows, draws)
