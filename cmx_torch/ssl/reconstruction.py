"""Model Genesis and MAE pretraining on the shared UNet (port of
cmx/ssl/reconstruction.py).

Both train UNet(out_classes=1, fused=...) (with `fused`, down1, down2 and
up1 run K1/K2, as the fine-tune step does) with the full-image MSE of the
reference (Genesis_Chest_CT.py:122-125):
  * Model Genesis (generate_pair, Transformation_based/utils.py:209-253):
    input = the distortion chain of cmx_torch.ops.genesis on the device,
    target = the (possibly flipped) original;
  * MAE (utils.py:196-207): input = image * active patch mask (ratio 0.5,
    patch 16; per-sample masks, `shared_mask` restores the reference's
    mask[0] broadcast), target = the image; or the masked pixels only with
    `masked_loss_only`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cmx_torch.models.unet import UNet
from cmx_torch.ops.genesis import genesis_batch
from cmx_torch.ops.masking import random_patch_mask
from cmx_torch.train.trainer import Task, TaskAux


def make_genesis_task(model: Optional[UNet] = None, *,
                      flip_rate: float = 0.4, local_rate: float = 0.5,
                      nonlinear_rate: float = 0.9, paint_rate: float = 0.9,
                      inpaint_rate: float = 0.2) -> Tuple[Task, UNet]:
    """The Genesis task: loss_fn(model, imgs, gen, draws, extra) -> (loss,
    TaskAux). `draws` may hold the distorted pair ("x", "y") outright, or
    any of genesis_draws' raw draws; the rest are drawn from `gen`. Rates
    default to Transformation_based/config.py:24-31."""
    model = model or UNet(out_classes=1)
    rates = dict(flip_rate=flip_rate, local_rate=local_rate,
                 nonlinear_rate=nonlinear_rate, paint_rate=paint_rate,
                 inpaint_rate=inpaint_rate)

    def loss_fn(model: UNet, imgs: torch.Tensor,
                gen: Optional[torch.Generator],
                draws: Optional[dict] = None, extra=None):
        draws = draws or {}
        if "x" in draws:
            x, y = draws["x"].to(imgs.device), draws["y"].to(imgs.device)
        else:
            x, y = genesis_batch(imgs, gen, draws, **rates)
        pred = model(x)
        loss = torch.square(pred[:, 0].float() - y.float()).mean()
        return loss, TaskAux(metrics={"mse": loss.detach()})

    return Task(name="genesis", loss_fn=loss_fn), model


def make_mae_task(model: Optional[UNet] = None, *, mask_ratio: float = 0.5,
                  patch_size: int = 16, shared_mask: bool = False,
                  masked_loss_only: bool = False) -> Tuple[Task, UNet]:
    """The MAE task: loss_fn(model, imgs, gen, draws, extra) -> (loss,
    TaskAux). `draws` may inject "active" (B, H, W); else it is drawn from
    `gen`."""
    model = model or UNet(out_classes=1)

    def loss_fn(model: UNet, imgs: torch.Tensor,
                gen: Optional[torch.Generator],
                draws: Optional[dict] = None, extra=None):
        b, h, _ = imgs.shape
        active = (draws or {}).get("active")
        if active is None:
            active = random_patch_mask(gen, b, h, patch_size, mask_ratio,
                                       shared_mask)
        active = active.to(imgs.device).float()
        pred = model(imgs * active)
        err = torch.square(pred[:, 0].float() - imgs)
        if masked_loss_only:
            masked = 1.0 - active
            loss = (err * masked).sum() / torch.clamp(masked.sum(), min=1.0)
        else:
            loss = err.mean()
        return loss, TaskAux(metrics={"mse": loss.detach()})

    return Task(name="mae", loss_fn=loss_fn), model
