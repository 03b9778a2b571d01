"""MAE pretraining on the shared UNet (port of
cmx/ssl/reconstruction.py:67-100); Model Genesis waits (ROADMAP: Genesis).

MAE (Transformation_based/utils.py:196-207): input = image * active patch
mask (ratio 0.5, patch 16; per-sample masks, `shared_mask` restores the
reference's mask[0] broadcast), target = the image; full-image MSE as the
reference (Genesis_Chest_CT.py:122-125), or the masked pixels only with
`masked_loss_only`. The model is `UNet(out_classes=1, fused=...)`: with
`fused`, down1, down2 and up1 run K1/K2, as the fine-tune step does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cmx_torch.models.unet import UNet
from cmx_torch.ops.masking import random_patch_mask
from cmx_torch.train.trainer import Task, TaskAux


def make_genesis_task(*args, **kwargs):
    """Model Genesis's distortion chain (cmx/ops/genesis.py) is not ported
    yet."""
    raise NotImplementedError(
        "make_genesis_task is not ported yet (ROADMAP: Genesis)")


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
