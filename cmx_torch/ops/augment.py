"""SparK and MoCo pretraining augmentation (port of cmx/ops/augment.py:34-137,
444-449, 686-719, 757-799, 942-947, 986-1054), written over the batch.

The crop is torchvision's RandomResizedCrop window (continuous) resampled to
(out, out) by the separable weight-matrix map of `_resize_weight_mat`:
Keys cubic a=-0.5, antialias widening by 1/scale when downscaling,
half-pixel centres, per-column renormalization, out-of-range columns zeroed
(the map jax.image.scale_and_translate applies in cmx). It runs as two fp32
batched matmuls; TF32 is off on the port's path (cmx_torch.resolve_device).
This is not F.interpolate(mode="bicubic"), which uses a=-0.75 and no
antialias.

The MoCo view chain (`moco_view_aug_batch`) is cmx's batch-hoisted one:
nearest rotation as one flat gather over the batch, then the crop (K4
`crop_resize_pallas` for crop_impl="pallas", the plain weight-matrix map for
None / "scale_translate"), then a per-sample Gaussian blur, flips and
max/10 Gaussian noise. Every random draw may be injected (`draws`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

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


# ------------------------------------------------------------------- MoCo

MOCO_SCALE = (0.2, 1.0)
MOCO_RATIO = (3 / 4, 4 / 3)
_MOCO_CROP_IMPLS = ("scale_translate", "pallas")


def random_vflip(imgs: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Flip image i top-bottom where flip[i] is True."""
    return torch.where(flip[:, None, None], imgs.flip(-2), imgs)


def batch_rotate_nearest(imgs: torch.Tensor, angles: torch.Tensor,
                         apply: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour rotation of image i by angles[i] (radians) about
    its centre where apply[i], zero outside: one flat gather over the batch.
    round() is half-to-even, as jnp.round."""
    b, h, w = imgs.shape
    dev = imgs.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = (torch.arange(h, dtype=torch.float32, device=dev) - cy)[None, :, None]
    xx = (torch.arange(w, dtype=torch.float32, device=dev) - cx)[None, None, :]
    c = torch.cos(angles.float())[:, None, None]
    s = torch.sin(angles.float())[:, None, None]
    iy = torch.round(c * yy - s * xx + cy).long()
    ix = torch.round(s * yy + c * xx + cx).long()
    inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    base = (torch.arange(b, device=dev) * (h * w))[:, None, None]
    idx = base + iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
    rot = torch.take(imgs, idx)
    rot = torch.where(inside, rot, torch.zeros_like(rot)).float()
    return torch.where(apply[:, None, None], rot, imgs)


def _gaussian_kernel_1d(sigma: torch.Tensor, radius: int) -> torch.Tensor:
    """(B, 2r+1) normalized Gaussian taps for per-sample sigma (B,)."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=sigma.device)
    k = torch.exp(-0.5 * torch.square(
        x[None, :] / torch.clamp(sigma.float(), min=1e-3)[:, None]))
    return k / k.sum(1, keepdim=True)


def gaussian_blur(imgs: torch.Tensor, sigma: torch.Tensor,
                  apply: torch.Tensor, radius: int = 3) -> torch.Tensor:
    """Separable Gaussian blur of image i with sigma[i] where apply[i]:
    replicate padding, then the vertical and the horizontal 2r+1 taps, each
    a sum of shifted slices (cmx: two VALID depthwise convs)."""
    b, h, w = imgs.shape
    k = _gaussian_kernel_1d(sigma, radius)[:, :, None, None]  # (B,T,1,1)
    xp = F.pad(imgs.float()[:, None], (radius,) * 4, mode="replicate")[:, 0]
    y = k[:, 0] * xp[:, 0:h, :]
    for t in range(1, 2 * radius + 1):
        y = y + k[:, t] * xp[:, t:t + h, :]
    z = k[:, 0] * y[:, :, 0:w]
    for t in range(1, 2 * radius + 1):
        z = z + k[:, t] * y[:, :, t:t + w]
    return torch.where(apply[:, None, None], z, imgs)


def gaussian_noise_max10(imgs: torch.Tensor, noise: torch.Tensor,
                         apply: torch.Tensor) -> torch.Tensor:
    """imgs + (max(img)/10) * noise per image where apply[i]; `noise` is a
    standard normal field of the images' shape."""
    sigma = imgs.amax(dim=(1, 2)) / 10.0
    noisy = imgs + sigma[:, None, None] * noise
    return torch.where(apply[:, None, None], noisy, imgs)


def moco_view_draws(gen: torch.Generator, batch: int, h: int, w: int,
                    out_size: int, draws: Optional[dict] = None) -> dict:
    """The random draws of one MoCo view of a batch, from `gen`, except
    those given in `draws`:
      angle (B,) radians U(-pi, pi), rot_apply (B,) p 0.5;
      crop (B,4) RandomResizedCrop(scale (0.2, 1)) windows (sy, ty, sx, tx);
      blur_apply (B,) p 0.5, sigma (B,) U(0.1, 2);
      hflip, vflip (B,) p 0.5;
      noise_apply (B,) p 0.5, noise (B, out, out) standard normal."""
    d = dict(draws or {})
    dev = None if gen is None else gen.device

    def u(n=batch):
        return torch.rand((n,), generator=gen, device=dev)

    fill = {
        "angle": lambda: (u() * 2.0 - 1.0) * math.pi,
        "rot_apply": lambda: u() < 0.5,
        "crop": lambda: _crop_window_params(gen, batch, h, w, out_size,
                                            MOCO_SCALE, MOCO_RATIO),
        "blur_apply": lambda: u() < 0.5,
        "sigma": lambda: 0.1 + 1.9 * u(),
        "hflip": lambda: u() < 0.5,
        "vflip": lambda: u() < 0.5,
        "noise_apply": lambda: u() < 0.5,
        "noise": lambda: torch.randn((batch, out_size, out_size),
                                     generator=gen, device=dev),
    }
    for name, draw in fill.items():
        if name not in d:
            d[name] = draw()
    return d


def _moco_view_post_crop(imgs: torch.Tensor, d: dict) -> torch.Tensor:
    """After the crop: blur p 0.5 (sigma 0.1-2, radius 3) -> hflip -> vflip
    -> noise max/10 p 0.5."""
    dev = imgs.device
    imgs = gaussian_blur(imgs, d["sigma"].to(dev), d["blur_apply"].to(dev), 3)
    imgs = random_hflip(imgs, d["hflip"].to(dev))
    imgs = random_vflip(imgs, d["vflip"].to(dev))
    return gaussian_noise_max10(imgs, d["noise"].to(dev),
                                d["noise_apply"].to(dev))


def moco_view_aug_batch(imgs: torch.Tensor, out_size: int = 224,
                        rotation_method: Optional[str] = None,
                        crop_method: Optional[str] = None,
                        crop_impl: Optional[str] = None,
                        gen: Optional[torch.Generator] = None,
                        draws: Optional[dict] = None) -> torch.Tensor:
    """One MoCo v2 view of a (B, H, W) batch (moco_data_module.py:119-132):
    RandomRotation(180) p 0.5 (nearest) -> RandomResizedCrop(out, (0.2, 1))
    -> GaussianBlur p 0.5 -> HFlip -> VFlip -> GaussNoise(max/10) p 0.5.

    crop_impl "pallas" runs the crop through K4; None / "scale_translate"
    through the plain weight-matrix map (the same linear map). The draws of
    `moco_view_draws` are taken from `gen` unless given in `draws`."""
    method = rotation_method or "nearest"
    if method != "nearest":
        raise NotImplementedError(
            f"rotation_method {method!r} is not ported yet (ROADMAP: MoCo "
            "view-pipeline options)")
    impl = crop_impl or "scale_translate"
    if impl not in _MOCO_CROP_IMPLS:
        raise NotImplementedError(
            f"crop_impl {impl!r} is not ported yet (ROADMAP: MoCo "
            "view-pipeline options)")
    b, h, w = imgs.shape
    dev = imgs.device
    d = moco_view_draws(gen, b, h, w, out_size, draws)
    rot = batch_rotate_nearest(imgs.float(), d["angle"].to(dev),
                               d["rot_apply"].to(dev))
    params = d["crop"].to(dev)
    crop_method = crop_method or "linear"
    if impl == "pallas":
        from cmx_torch.ops.pallas_crop import crop_resize_pallas

        cropped = crop_resize_pallas(rot, params, out_size, crop_method)
    else:
        cropped = resized_crop(rot, params, out_size, crop_method)
    return _moco_view_post_crop(cropped, d)
