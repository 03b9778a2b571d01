"""SparK sparse masked-convolution pretraining (port of cmx/ssl/spark.py:45-201).

Masked encoder + densify (masked BN, learned mask tokens) + full-UNet
decoder, the per-patch-normalized L2 loss on masked patches, and the task
that ties them to the augmentation and the mask draw. Sparsity is a dense
conv plus an active-mask multiply, as in cmx.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from cmx_torch.models.blocks import MaskedBatchNorm, reset_parameters
from cmx_torch.models.unet import (BOTTLENECK_WIDTH, DOWNSAMPLE_RATIO,
                                   ENCODER_WIDTHS, UNetDecoder, UNetEncoder)
from cmx_torch.ops.augment import spark_pretrain_aug
from cmx_torch.ops.masking import spark_active_mask, upsample_mask
from cmx_torch.train.trainer import Task


class SparKModel(nn.Module):
    """imgs (B,H,W), active_grid (B,f,f) with 1 = keep -> reconstruction
    (B,H,W) fp32. Only the full-UNet decoder (`full_unet=True`) is ported;
    cmx's LightDecoder waits (ROADMAP). `fused` applies to the encoder; the
    decoder stays unfused, as with cmx's default fused_decoder=False."""

    def __init__(self, mask_ratio: float = 0.6, full_unet: bool = True,
                 widths: Sequence[int] = ENCODER_WIDTHS,
                 bottleneck_width: int = BOTTLENECK_WIDTH,
                 dtype: torch.dtype = torch.bfloat16, fused: bool = False):
        super().__init__()
        if not full_unet:
            raise NotImplementedError(
                "SparKModel(full_unet=False) needs LightDecoder, not ported "
                "yet (ROADMAP: LightDecoder)")
        self.mask_ratio = mask_ratio
        self.widths = tuple(widths)
        self.bottleneck_width = bottleneck_width
        self.dtype = dtype
        self.encoder = UNetEncoder(widths, bottleneck_width, dtype, fused)
        feat_widths = [bottleneck_width] + list(reversed(widths))
        for i, cw in enumerate(feat_widths):
            self.add_module(f"densify_norm{i}", MaskedBatchNorm(cw, dtype))
            self.register_parameter(f"mask_token{i}",
                                    nn.Parameter(torch.zeros(1, cw, 1, 1)))
        self.n_feats = len(feat_widths)
        self.decoder = UNetDecoder(1, widths, bottleneck_width, dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """Random weights from `gen` (flax's initializers: lecun-normal
        kernels, zero biases, unit norms, mask tokens N(0, 0.02) truncated)."""
        reset_parameters(self, gen)
        with torch.no_grad():
            for i in range(self.n_feats):
                nn.init.trunc_normal_(getattr(self, f"mask_token{i}"), 0.0,
                                      0.02, -0.04, 0.04, generator=gen)

    def forward(self, imgs: torch.Tensor,
                active_grid: torch.Tensor) -> torch.Tensor:
        active_pix = upsample_mask(active_grid, DOWNSAMPLE_RATIO)
        bottleneck, skips = self.encoder(imgs, active_pix)
        feats = [bottleneck] + list(reversed(skips))
        to_dec = []
        cur = active_grid
        for i, f in enumerate(feats):
            m = cur[:, None]  # (B,1,s,s)
            f = getattr(self, f"densify_norm{i}")(f, m)
            token = getattr(self, f"mask_token{i}").to(f.dtype)
            to_dec.append(torch.where(m > 0, f, token))
            cur = upsample_mask(cur, 2)
        rec = self.decoder(to_dec[0], list(reversed(to_dec[1:])))
        return rec[:, 0]


def spark_loss(rec: torch.Tensor, imgs: torch.Tensor,
               active_grid: torch.Tensor) -> torch.Tensor:
    """Per-patch-normalized L2 on masked patches (two-pass variance)."""
    b, h, w = imgs.shape
    p = DOWNSAMPLE_RATIO
    fh, fw = h // p, w // p

    def patch(x):
        return x.reshape(b, fh, p, fw, p).permute(0, 1, 3, 2, 4).reshape(
            b, fh * fw, p * p)

    inp = patch(imgs.float())
    out = patch(rec.float())
    mean = inp.mean(-1, keepdim=True)
    std = torch.sqrt(inp.var(-1, keepdim=True, unbiased=False) + 1e-6)
    inp = ((inp - mean) / std).detach()
    l2 = ((out - inp) ** 2).mean(-1)
    non_active = 1.0 - active_grid.reshape(b, -1).float()
    return (l2 * non_active).sum() / (non_active.sum() + 1e-8)


def make_spark_task(model: Optional[SparKModel] = None, *,
                    mask_ratio: float = 0.6, augment: bool = True,
                    input_size: int = 256, pallas_loss: bool = False
                    ) -> Tuple[Task, SparKModel]:
    """The SparK task: loss_fn(model, imgs, gen, draws) -> (loss, metrics).

    `draws` may inject the step's random draws, as tests do with cmx's:
    "crop" (B,4) windows, "flip" (B,) bools, "active" (B,f,f); whatever is
    missing is drawn from `gen`. pallas_loss=True runs the loss through the
    K3 kernel with its closed-form backward."""
    model = model or SparKModel(mask_ratio=mask_ratio)

    def loss_fn(model: SparKModel, imgs: torch.Tensor, gen: torch.Generator,
                draws: Optional[Dict[str, torch.Tensor]] = None):
        draws = draws or {}
        if augment:
            imgs = spark_pretrain_aug(imgs, input_size, gen,
                                      crop=draws.get("crop"),
                                      flip=draws.get("flip"))
        f = imgs.shape[1] // DOWNSAMPLE_RATIO
        active = draws.get("active")
        if active is None:
            active = spark_active_mask(gen, imgs.shape[0], f, model.mask_ratio)
        active = active.to(imgs.device).float()
        rec = model(imgs, active)
        if pallas_loss:
            from cmx_torch.ops.pallas_ops import spark_loss_pallas_trainable

            loss = spark_loss_pallas_trainable(rec, imgs.detach(), active,
                                               DOWNSAMPLE_RATIO)
        else:
            loss = spark_loss(rec, imgs, active)
        return loss, {"recon": loss.detach()}

    return Task(name="spark", loss_fn=loss_fn), model
