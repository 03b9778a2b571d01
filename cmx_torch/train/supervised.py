"""The supervised segmentation task, the fine-tune regime (port of
cmx/train/supervised.py).

Finetuning/train.py's training semantics: UNet logits, the loss thresholded
Dice + CE (train.py:455), device metrics every step (458-465). The batch is
(images (B,H,W), one-hot masks (B,C,H,W)); the augmentation runs on the
device inside the step, from the step's generator.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from cmx_torch.eval.metrics import segmentation_loss, segmentation_metrics
from cmx_torch.models.unet import UNet
from cmx_torch.ops.augment import finetune_draws, finetune_train_aug
from cmx_torch.parallel import mesh
from cmx_torch.train.trainer import Task, TaskAux


def make_supervised_task(model: Optional[UNet] = None, augment: bool = True,
                         cheap_metrics: bool = True) -> Tuple[Task, UNet]:
    """The task: loss_fn(model, (imgs, masks), gen, draws) -> (loss, TaskAux).

    `draws` may inject the augmentation's draws (`finetune_draws`'s names);
    whatever is missing is drawn from `gen`, for the global batch under
    data parallel (each rank takes its rows; the loss and metrics are the
    global batch's, cmx_torch.eval.metrics). The step's metrics are the
    cheap set (dice / CE / IoU) unless cheap_metrics=False; soft_clDice runs
    at validation, as in cmx."""
    model = model or UNet(out_classes=2)

    def loss_fn(model: UNet, batch, gen: torch.Generator,
                draws: Optional[Dict[str, torch.Tensor]] = None, extra=None):
        imgs, masks = batch
        if augment:
            b, h, w = imgs.shape
            d = mesh.rank_slice_draws(finetune_draws(
                gen, mesh.global_batch(b), h, w, draws))
            imgs, masks = finetune_train_aug(imgs, masks, gen, d)
        logits = model(imgs)
        loss = segmentation_loss(logits, masks)
        metrics = {k: v.detach() for k, v in segmentation_metrics(
            logits, masks, cheap=cheap_metrics).items()}
        return loss, TaskAux(metrics=metrics)

    return Task(name="supervised", loss_fn=loss_fn), model


def make_eval_fn(model: UNet) -> Callable[[torch.Tensor], torch.Tensor]:
    """eval_fn(imgs) -> logits: the model in eval mode (BN from its running
    statistics; the fused DoubleConv never runs there, as in cmx) under
    torch.no_grad(). The model is left in eval mode; the train step sets
    train mode again."""

    def eval_fn(imgs: torch.Tensor) -> torch.Tensor:
        model.eval()
        with torch.no_grad():
            return model(imgs)

    return eval_fn
