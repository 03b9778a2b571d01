"""CM-UNet, the paper's combined masked-reconstruction + contrastive method
(port of cmx/ssl/cmunet.py).

  online:  masked UNetEncoder (patch 16, ratio 0.65 on the 224^2 view 1)
           -> pixel decoder (2 ch) -> masked MSE against the row-normalised
              view 1 (channel 1 of the prediction);
           -> feature decoder (2 ch) -> channel mean -> flatten (h, w)
              -> projector (view^2 -> 1536 -> 256) -> predictor
  target:  a copy of the whole online module (its BN buffers included) in
           `extra["target_model"]`, no gradient, in train mode (batch
           statistics; its running stats update in place and are not
           EMA'd): unmasked encoder on view 2 -> the fixed 1x1 reduce
           1024 -> 256 in fp32 -> flatten NHWC, (h, w, c) order ->
           projector
  losses:  loss_rc + loss_ct, loss_ct = 2T * CE(q t^T / T, arange(B)) on
           rows normalised with no epsilon, T 0.07
  EMA:     post_update, after the optimizer update: every target parameter
           <- m * target + (1 - m) * the updated online parameter, at
           `base_momentum` (the CLI passes task.ema_momentum). The reduce
           kernel (`extra["reduce_kernel"]`, HWIO (1, 1, 1024, 256) as cmx's)
           is drawn once and never changes.

cmx's deviations from the reference (per-sample masks, the reduce conv
drawn once, the head's broadcast fixed, the global-batch InfoNCE) are kept.
The encoder and decoders run in the step's dtype, unfused, as cmx builds
them; the necks in fp32. Under data parallel (cmx_torch.parallel.mesh) B is
the global batch, as in cmx: the draws are made for it and each rank takes
its rows; a rank's queries are scored against every rank's targets,
gathered in rank order, with labels arange(b) + rank * b (the reference's
concat_all_gather, cmunet_head.py:77-85); loss_rc's sums and loss_ct's mean
are the global batch's; every BN moment, the target's too, is global.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from cmx_torch.models.blocks import reset_parameters
from cmx_torch.models.necks import NonLinearNeck
from cmx_torch.models.unet import BOTTLENECK_WIDTH, UNetDecoder, UNetEncoder
from cmx_torch.ops.augment import cmunet_two_views_batch, cmunet_view_draws
from cmx_torch.ops.masking import random_patch_mask
from cmx_torch.parallel import mesh
from cmx_torch.train.trainer import Task, TaskAux

REDUCED_WIDTH = 256  # the target's 1x1 reduce: BOTTLENECK_WIDTH -> 256


class CMUNetOnline(nn.Module):
    """Online branch: encoder + pixel and feature decoders + projector +
    predictor, under cmx's attribute names. `view_size` fixes the
    projector's input width, view_size^2 (= (view/16)^2 * 256 for the
    target branch)."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 view_size: int = 224):
        super().__init__()
        self.encoder = UNetEncoder(dtype=dtype)
        self.pixel_decoder = UNetDecoder(out_classes=2, dtype=dtype)
        self.feature_decoder = UNetDecoder(out_classes=2, dtype=dtype)
        self.projector = NonLinearNeck(view_size * view_size)
        self.predictor = NonLinearNeck(self.projector.fc1.kernel.shape[1])

    def reset_parameters(self, gen: torch.Generator) -> None:
        """Random weights from `gen` (flax's initializers)."""
        reset_parameters(self, gen)

    def forward(self, img: torch.Tensor, active: torch.Tensor):
        """(pred_pixel (B,2,H,W) fp32, pred (B,256), proj (B,256))."""
        latent, skips = self.encoder(img, active)
        pred_pixel = self.pixel_decoder(latent, skips)
        pred_feature = self.feature_decoder(latent, skips)
        # channel mean, then flatten in (h, w) order
        feat = pred_feature.mean(dim=1).reshape(img.shape[0], -1)
        proj = self.projector(feat)
        return pred_pixel, self.predictor(proj), proj

    def encode_project(self, img: torch.Tensor,
                       reduce_kernel: torch.Tensor) -> torch.Tensor:
        """The target branch: encode unmasked, reduce 1024 -> 256 with the
        HWIO 1x1 kernel in fp32, flatten NHWC ((h, w, c) order, as cmx's
        reshape of its NHWC map), project."""
        latent, _ = self.encoder(img)
        red = torch.einsum("bchw,co->bhwo", latent.float(), reduce_kernel[0, 0])
        return self.projector(red.reshape(img.shape[0], -1))


def init_cmunet_extra(gen: torch.Generator,
                      model: CMUNetOnline) -> Dict[str, Any]:
    """extra = a target copy of `model` (parameters and BN buffers; no
    gradient) and the fixed reduce kernel N(0, 1) * sqrt(2/1024), HWIO,
    drawn from `gen`, on the model's device."""
    dev = next(model.parameters()).device
    target = copy.deepcopy(model)
    for p in target.parameters():
        p.requires_grad_(False)
    kernel = torch.randn((1, 1, BOTTLENECK_WIDTH, REDUCED_WIDTH),
                         generator=gen, device=gen.device)
    return {"target_model": target,
            "reduce_kernel": (kernel * math.sqrt(2.0 / BOTTLENECK_WIDTH)).to(dev)}


def _normalize_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def make_cmunet_task(model: Optional[CMUNetOnline] = None, *,
                     mask_ratio: float = 0.65, patch_size: int = 16,
                     temperature: float = 0.07, ct_weight: float = 1.0,
                     rc_weight: float = 1.0, base_momentum: float = 0.996,
                     view_size: int = 224, augment: bool = True,
                     crop_impl: Optional[str] = None
                     ) -> Tuple[Task, CMUNetOnline]:
    """The CM-UNet task: loss_fn(model, imgs, gen, draws, extra) -> (loss,
    TaskAux). `draws` may inject the step's random draws, as tests do with
    cmx's: "views" (the keys of augment.cmunet_view_draws) and "active"
    (B, view, view); whatever is missing is drawn from `gen`.
    `task.init_extra(gen)` makes the task's `extra`."""
    model = model or CMUNetOnline(view_size=view_size)

    def loss_fn(model: CMUNetOnline, imgs: torch.Tensor,
                gen: Optional[torch.Generator],
                draws: Optional[dict] = None,
                extra: Optional[Dict[str, Any]] = None):
        draws = draws or {}
        bg = mesh.global_batch(imgs.shape[0])
        if augment:
            d = mesh.rank_slice_draws(cmunet_view_draws(
                gen, bg, imgs.shape[1], imgs.shape[2], view_size, 31,
                draws.get("views")))
            v1, v2 = cmunet_two_views_batch(imgs, view_size, 31, crop_impl,
                                            gen, d)
        else:
            v1 = v2 = imgs[:, :view_size, :view_size]
        b, h, _ = v1.shape
        active = draws.get("active")
        if active is None:
            active = random_patch_mask(gen, bg, h, patch_size, mask_ratio)
        active = mesh.rank_slice(active).to(v1.device).float()

        pred_pixel, pred_s, _ = model(v1, active)
        target = extra["target_model"]
        target.train()
        with torch.no_grad():
            proj_t = target.encode_project(v2, extra["reduce_kernel"])

        # Reconstruction: each row of view 1 normalised over W (biased
        # variance), the error on the masked pixels (masked = 1 - active).
        tgt = v1.float()
        tgt = ((tgt - tgt.mean(-1, keepdim=True))
               / torch.sqrt(tgt.var(-1, unbiased=False, keepdim=True) + 1e-6))
        masked = 1.0 - active
        err = torch.square(pred_pixel[:, 1] - tgt)
        sums = mesh.all_reduce_shared(
            torch.stack([(err * masked).sum(), masked.sum()]))
        loss_rc = sums[0] / torch.clamp(sums[1], min=1.0)

        # Contrastive: InfoNCE over the global batch, a rank's queries
        # against every rank's targets.
        targets = mesh.all_gather_batch(_normalize_rows(proj_t))
        score = _normalize_rows(pred_s) @ targets.t()
        labels = (torch.arange(b, device=score.device)
                  + mesh.info()[0] * b)
        loss_ct = mesh.global_mean(
            2.0 * temperature * F.cross_entropy(score / temperature, labels))
        loss = ct_weight * loss_ct + rc_weight * loss_rc
        return loss, TaskAux(metrics={"loss_ct": loss_ct.detach(),
                                      "loss_rc": loss_rc.detach()})

    def post_update(state, aux: TaskAux):
        m = base_momentum
        return [(pt, m * pt + (1.0 - m) * p) for pt, p in
                zip(state.extra["target_model"].parameters(),
                    state.model.parameters())]

    def init_extra(gen: torch.Generator) -> Dict[str, Any]:
        return init_cmunet_extra(gen, model)

    return Task(name="cmunet", loss_fn=loss_fn, post_update=post_update,
                init_extra=init_extra), model
