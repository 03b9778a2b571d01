"""SparK sparse masked-convolution pretraining (port of cmx/ssl/spark.py:45-201).

Masked encoder + densify (masked BN, learned mask tokens) + decoder: the
full UNet decoder with skips (`full_unet=True`, the paper's), or
LightDecoder after per-scale projections to its widths; the
per-patch-normalized L2 loss on masked patches, and the task that ties them
to the augmentation and the mask draw. Sparsity is a dense conv plus an
active-mask multiply, as in cmx.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from cmx_torch.models.blocks import Conv, MaskedBatchNorm, reset_parameters
from cmx_torch.models.decoders import LightDecoder
from cmx_torch.models.unet import (BOTTLENECK_WIDTH, DOWNSAMPLE_RATIO,
                                   ENCODER_WIDTHS, UNetDecoder, UNetEncoder)
from cmx_torch.ops.augment import spark_aug_draws, spark_pretrain_aug
from cmx_torch.ops.masking import spark_active_mask, upsample_mask
from cmx_torch.parallel import mesh
from cmx_torch.train.trainer import Task, TaskAux
from cmx_torch.utils.profiling import span


class SparKModel(nn.Module):
    """imgs (B,H,W), active_grid (B,f,f) with 1 = keep -> reconstruction
    (B,H,W) fp32. `full_unet=True`: the UNet decoder on the densified
    features; False: each densified feature through `densify_proj{i}` (1x1
    at the bottleneck, else 3x3) to decoder_width / 2^i, then LightDecoder.
    `fused` applies to the encoder, and to the UNet decoder only with
    `fused_decoder` (cmx's default False), as cmx/ssl/spark.py:125 does;
    LightDecoder is never fused. `remat_levels` (cmx's names, see
    cmx_torch.models.unet) passes to the encoder and the UNet decoder;
    LightDecoder takes none, as in cmx."""

    def __init__(self, mask_ratio: float = 0.6, full_unet: bool = True,
                 decoder_width: int = 768,
                 widths: Sequence[int] = ENCODER_WIDTHS,
                 bottleneck_width: int = BOTTLENECK_WIDTH,
                 dtype: torch.dtype = torch.bfloat16, fused: bool = False,
                 fused_decoder: bool = False,
                 remat_levels: Sequence[str] = ()):
        super().__init__()
        self.mask_ratio = mask_ratio
        self.full_unet = full_unet
        self.widths = tuple(widths)
        self.bottleneck_width = bottleneck_width
        self.dtype = dtype
        self.encoder = UNetEncoder(widths, bottleneck_width, dtype, fused,
                                   remat_levels)
        feat_widths = [bottleneck_width] + list(reversed(widths))
        d_width = decoder_width
        for i, cw in enumerate(feat_widths):
            self.add_module(f"densify_norm{i}", MaskedBatchNorm(cw, dtype))
            self.register_parameter(f"mask_token{i}",
                                    nn.Parameter(torch.zeros(1, cw, 1, 1)))
            if not full_unet:
                self.add_module(f"densify_proj{i}",
                                Conv(cw, d_width, 1 if i == 0 else 3, dtype))
                d_width //= 2
        self.n_feats = len(feat_widths)
        if full_unet:
            self.decoder = UNetDecoder(1, widths, bottleneck_width, dtype,
                                       fused and fused_decoder,
                                       remat_levels=remat_levels)
        else:
            self.decoder = LightDecoder(DOWNSAMPLE_RATIO, decoder_width, dtype)

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
            f = torch.where(m > 0, f, token)
            if not self.full_unet:
                f = getattr(self, f"densify_proj{i}")(f)
            to_dec.append(f)
            cur = upsample_mask(cur, 2)
        if self.full_unet:
            rec = self.decoder(to_dec[0], list(reversed(to_dec[1:])))
        else:
            rec = self.decoder(to_dec)
        return rec[:, 0]


def spark_loss(rec: torch.Tensor, imgs: torch.Tensor,
               active_grid: torch.Tensor) -> torch.Tensor:
    """Per-patch-normalized L2 on masked patches (two-pass variance); its
    sums are over the global batch under data parallel."""
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
    sums = mesh.all_reduce_shared(
        torch.stack([(l2 * non_active).sum(), non_active.sum()]))
    return sums[0] / (sums[1] + 1e-8)


def make_spark_task(model: Optional[SparKModel] = None, *,
                    mask_ratio: float = 0.6, augment: bool = True,
                    input_size: int = 256, pallas_loss: bool = False
                    ) -> Tuple[Task, SparKModel]:
    """The SparK task: loss_fn(model, imgs, gen, draws) -> (loss, TaskAux).

    `draws` may inject the step's random draws, as tests do with cmx's:
    "crop" (B,4) windows, "flip" (B,) bools, "active" (B,f,f); whatever is
    missing is drawn from `gen`. Draws are for the global batch (B = the
    rank's batch times the world size) and each rank takes its rows.
    pallas_loss=True runs the loss through the K3 kernel with its
    closed-form backward."""
    model = model or SparKModel(mask_ratio=mask_ratio)

    def loss_fn(model: SparKModel, imgs: torch.Tensor, gen: torch.Generator,
                draws: Optional[Dict[str, torch.Tensor]] = None, extra=None):
        draws = draws or {}
        b, h, w = imgs.shape
        bg = mesh.global_batch(b)
        with span("views", imgs):
            if augment:
                d = mesh.rank_slice_draws(spark_aug_draws(
                    gen, bg, h, w, input_size,
                    {k: draws.get(k) for k in ("crop", "flip")}))
                imgs = spark_pretrain_aug(imgs, input_size, gen, **d)
            f = imgs.shape[1] // DOWNSAMPLE_RATIO
            active = draws.get("active")
            if active is None:
                active = spark_active_mask(gen, bg, f, model.mask_ratio)
            active = mesh.rank_slice(active).to(imgs.device).float()
        rec = model(imgs, active)
        with span("loss", rec) as sp:
            rec = sp.inputs(rec)
            if pallas_loss:
                from cmx_torch.ops.pallas_ops import \
                    spark_loss_pallas_trainable

                loss = spark_loss_pallas_trainable(rec, imgs.detach(), active,
                                                   DOWNSAMPLE_RATIO)
            else:
                loss = spark_loss(rec, imgs, active)
            loss = sp.outputs(loss)
        return loss, TaskAux(metrics={"recon": loss.detach()})

    return Task(name="spark", loss_fn=loss_fn), model


def spark_reconstruct(model: SparKModel, imgs: torch.Tensor,
                      active_grid: torch.Tensor):
    """Vis mode (spark.py:125-129), cmx's spark_reconstruct: the model in
    eval mode (its running statistics), the per-patch normalization undone
    on the reconstruction (the input's patch mean and sqrt(biased var +
    1e-6)). Returns (input, masked input, reconstruction-or-input): the
    visible patches keep the input, the masked ones get the
    reconstruction. The model's train/eval mode is put back."""
    b, h, w = imgs.shape
    p = DOWNSAMPLE_RATIO
    fh, fw = h // p, w // p
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            rec = model(imgs, active_grid)
    finally:
        model.train(was_training)

    def patch(x):
        return x.reshape(b, fh, p, fw, p).permute(0, 1, 3, 2, 4).reshape(
            b, fh * fw, p * p)

    def unpatch(x):
        return x.reshape(b, fh, fw, p, p).permute(0, 1, 3, 2, 4).reshape(
            b, h, w)

    inp_p = patch(imgs.float())
    mean = inp_p.mean(-1, keepdim=True)
    std = torch.sqrt(inp_p.var(-1, keepdim=True, unbiased=False) + 1e-6)
    rec_img = unpatch(patch(rec) * std + mean)
    active_pix = upsample_mask(active_grid, p)
    masked = imgs * active_pix
    return imgs, masked, torch.where(active_pix > 0, imgs, rec_img)
