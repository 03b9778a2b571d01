"""SparK pretraining augmentation (port of cmx/ops/augment.py:34-137,
444-445, 942-947), written over the batch.

The crop is torchvision's RandomResizedCrop window (continuous) resampled to
(out, out) by the separable weight-matrix map of `_resize_weight_mat`:
Keys cubic a=-0.5, antialias widening by 1/scale when downscaling,
half-pixel centres, per-column renormalization, out-of-range columns zeroed
(the map jax.image.scale_and_translate applies in cmx). It runs as two fp32
batched matmuls; TF32 is off on the port's path (cmx_torch.resolve_device).
This is not F.interpolate(mode="bicubic"), which uses a=-0.75 and no
antialias.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

_F32_EPS = float(torch.finfo(torch.float32).eps)


def _keys_cubic_kernel(x: torch.Tensor) -> torch.Tensor:
    """Keys cubic convolution kernel, a=-0.5, on |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weight_mat(in_size: int, out_size: int, scale: torch.Tensor,
                       translation: torch.Tensor, method: str = "linear",
                       antialias: bool = True) -> torch.Tensor:
    """(B, in_size, out_size) resampling weights for per-sample 1-D
    scale+translate; scale and translation are (B,) fp32."""
    dev = scale.device
    inv = 1.0 / scale
    kernel_scale = (torch.clamp(inv, min=1.0) if antialias
                    else torch.ones_like(inv))
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=dev)
                 + 0.5)[None, :] * inv[:, None]
                - translation[:, None] * inv[:, None] - 0.5)  # (B, out)
    x = torch.abs(sample_f[:, None, :]
                  - torch.arange(in_size, dtype=torch.float32,
                                 device=dev)[None, :, None]
                  ) / kernel_scale[:, None, None]  # (B, in, out)
    if method in ("linear", "triangle", "bilinear"):
        w = torch.clamp(1.0 - x, min=0.0)
    elif method in ("cubic", "bicubic"):
        w = _keys_cubic_kernel(x)
    else:
        raise ValueError(f"unsupported resize method {method!r}")
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _F32_EPS,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    valid = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(valid[:, None, :], w, torch.zeros_like(w))


def _crop_window_box(gen: torch.Generator, batch: int, h: int, w: int,
                     scale: Tuple[float, float], ratio: Tuple[float, float]):
    """torchvision RandomResizedCrop window draw (continuous), per sample.
    Returns (ch, y0, cw, x0), each (B,): the window [y0, y0+ch) x [x0, x0+cw)."""
    u = torch.rand((4, batch), generator=gen, device=gen.device)
    area = h * w * (scale[0] + (scale[1] - scale[0]) * u[0])
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    aspect = torch.exp(lo + (hi - lo) * u[1])
    cw = torch.clamp(torch.sqrt(area * aspect), 1.0, w)
    ch = torch.clamp(torch.sqrt(area / aspect), 1.0, h)
    y0 = u[2] * (h - ch)
    x0 = u[3] * (w - cw)
    return ch, y0, cw, x0


def _crop_window_params(gen: torch.Generator, batch: int, h: int, w: int,
                        out_size: int, scale: Tuple[float, float],
                        ratio: Tuple[float, float]) -> torch.Tensor:
    """(B, 4) scale_and_translate arguments (sy, ty, sx, tx) per sample."""
    ch, y0, cw, x0 = _crop_window_box(gen, batch, h, w, scale, ratio)
    sy = out_size / ch
    sx = out_size / cw
    return torch.stack([sy, -y0 * sy, sx, -x0 * sx], dim=1)


def resized_crop(imgs: torch.Tensor, params: torch.Tensor, out_size: int,
                 method: str = "linear") -> torch.Tensor:
    """Resample (B, H, W) images with per-sample (sy, ty, sx, tx) to
    (B, out, out) as two fp32 batched matmuls."""
    b, h, w = imgs.shape
    p = params.float()
    wy = _resize_weight_mat(h, out_size, p[:, 0], p[:, 1], method)  # (B,h,o)
    wx = _resize_weight_mat(w, out_size, p[:, 2], p[:, 3], method)  # (B,w,o)
    t = torch.bmm(wy.transpose(1, 2), imgs.float())  # (B, out, w)
    return torch.bmm(t, wx)  # (B, out, out)


def random_hflip(imgs: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Flip image i left-right where flip[i] is True."""
    return torch.where(flip[:, None, None], imgs.flip(-1), imgs)


def spark_pretrain_aug(imgs: torch.Tensor, out_size: int = 256,
                       gen: Optional[torch.Generator] = None,
                       crop: Optional[torch.Tensor] = None,
                       flip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SparK pretrain pipeline: RandomResizedCrop(out, scale (0.67, 1),
    bicubic) + HFlip (Spark/utils/dataset.py:34-45).

    `crop` (B, 4) windows as (sy, ty, sx, tx) and `flip` (B,) bools are
    drawn from `gen` unless given."""
    b, h, w = imgs.shape
    if crop is None:
        crop = _crop_window_params(gen, b, h, w, out_size, (0.67, 1.0),
                                   (3 / 4, 4 / 3))
    if flip is None:
        flip = torch.rand((b,), generator=gen, device=gen.device) < 0.5
    out = resized_crop(imgs, crop.to(imgs.device), out_size, method="cubic")
    return random_hflip(out, flip.to(imgs.device))
