"""SparK, MoCo and CM-UNet pretraining augmentation and the supervised
fine-tune chain (port of cmx/ops/augment.py:34-137, 444-449, 686-744,
757-939, 942-947, 986-1110), written over the batch.

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

The CM-UNet views (`cmunet_two_views_batch`) are cmx's plain chain: the
shared cubic crop to 256^2 and flip, the centre and the shifted crops, and
noise on view 2; every draw may be injected (`cmunet_view_draws`).

The fine-tune chain (`finetune_train_aug`) is cmx's per-image one, applied
to every image of the batch with per-image draws (`finetune_draws`):
Gaussian noise, blur, brightness/contrast, a nearest down-and-up scale, and
a OneOf over hflip / vflip / rot90 / noise whose geometric branches move the
image and its one-hot mask together.
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


def spark_aug_draws(gen: Optional[torch.Generator], batch: int, h: int,
                    w: int, out_size: int = 256,
                    draws: Optional[dict] = None) -> dict:
    """The random draws of `spark_pretrain_aug` for a batch, from `gen`,
    except those given in `draws`: crop (B, 4) RandomResizedCrop(scale
    (0.67, 1)) windows (sy, ty, sx, tx), then flip (B,) p 0.5."""
    d = dict(draws or {})
    if d.get("crop") is None:
        d["crop"] = _crop_window_params(gen, batch, h, w, out_size,
                                        (0.67, 1.0), (3 / 4, 4 / 3))
    if d.get("flip") is None:
        d["flip"] = torch.rand((batch,), generator=gen,
                               device=gen.device) < 0.5
    return d


def spark_pretrain_aug(imgs: torch.Tensor, out_size: int = 256,
                       gen: Optional[torch.Generator] = None,
                       crop: Optional[torch.Tensor] = None,
                       flip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SparK pretrain pipeline: RandomResizedCrop(out, scale (0.67, 1),
    bicubic) + HFlip (Spark/utils/dataset.py:34-45).

    `crop` (B, 4) windows as (sy, ty, sx, tx) and `flip` (B,) bools are
    drawn from `gen` unless given."""
    b, h, w = imgs.shape
    d = spark_aug_draws(gen, b, h, w, out_size, {"crop": crop, "flip": flip})
    crop, flip = d["crop"], d["flip"]
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


# ------------------------------------------------------------------- CM-UNet

CMUNET_BASE = 256  # the shared RandomResizedCrop's output size
CMUNET_SCALE = (0.2, 1.0)
# crop_impl values that take cmx's plain vmapped chain for the CM-UNet views
# (cmx/ops/augment.py:1091-1093); "bank" and "bank_fused" are not ported.
_CMUNET_CHAIN_IMPLS = (None, "scale_translate", "einsum", "einsum_bf16",
                       "pallas")


def shift_pixel_crop(imgs: torch.Tensor, out_size: int = 224,
                     shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (out, out) centre crop of each (B, H, W) image, offset by
    shift[i] = (dy, dx) >= 0 and clipped to the image (CM-UNet's
    ShiftPixel, cmae/datasets/pipelines/processing.py:98-127); shift None
    is the plain centre crop."""
    b, h, w = imgs.shape
    y0, x0 = (h - out_size) // 2, (w - out_size) // 2
    if shift is None:
        return imgs[:, y0:y0 + out_size, x0:x0 + out_size]
    ar = torch.arange(out_size, device=imgs.device)
    rows = (y0 + shift[:, 0]).clamp(0, h - out_size)[:, None] + ar
    cols = (x0 + shift[:, 1]).clamp(0, w - out_size)[:, None] + ar
    idx = torch.arange(b, device=imgs.device)[:, None, None]
    return imgs[idx, rows[:, :, None], cols[:, None, :]]


def cmunet_view_draws(gen: Optional[torch.Generator], batch: int, h: int,
                      w: int, out_size: int = 224, shift: int = 31,
                      draws: Optional[dict] = None) -> dict:
    """The random draws of the CM-UNet views of a batch, from `gen`, except
    those given in `draws`:
      crop (B,4) RandomResizedCrop(256, scale (0.2, 1)) windows
      (sy, ty, sx, tx); flip (B,) p 0.5;
      shift (B,2) view 2's (dy, dx), integers in [0, shift];
      noise_apply (B,) p 0.5, noise (B, out, out) standard normal."""
    d = dict(draws or {})
    dev = None if gen is None else gen.device
    fill = {
        "crop": lambda: _crop_window_params(gen, batch, h, w, CMUNET_BASE,
                                            CMUNET_SCALE, MOCO_RATIO),
        "flip": lambda: torch.rand((batch,), generator=gen, device=dev) < 0.5,
        "shift": lambda: torch.randint(0, shift + 1, (batch, 2),
                                       generator=gen, device=dev),
        "noise_apply": lambda: torch.rand((batch,), generator=gen,
                                          device=dev) < 0.5,
        "noise": lambda: torch.randn((batch, out_size, out_size),
                                     generator=gen, device=dev),
    }
    for name, draw in fill.items():
        if name not in d:
            d[name] = draw()
    return d


def cmunet_two_views_batch(imgs: torch.Tensor, out_size: int = 224,
                           shift: int = 31, crop_impl: Optional[str] = None,
                           gen: Optional[torch.Generator] = None,
                           draws: Optional[dict] = None):
    """CM-UNet's two views of a (B, H, W) batch
    (cmae/datasets/cmunet_dataset.py:39-55): one shared cubic
    RandomResizedCrop to 256^2 (scale (0.2, 1)) and HFlip p 0.5, then view 1
    the centre out^2 crop and view 2 the crop offset by up to `shift`
    pixels with max/10 Gaussian noise p 0.5. crop_impl None,
    "scale_translate", "einsum", "einsum_bf16" and "pallas" all run this
    chain, as in cmx (its "pallas" too: no kernel). The draws of
    `cmunet_view_draws` come from `gen` unless given in `draws`."""
    if crop_impl not in _CMUNET_CHAIN_IMPLS:
        raise NotImplementedError(
            f"crop_impl {crop_impl!r} is not ported yet (ROADMAP: MoCo "
            "view-pipeline options)")
    b, h, w = imgs.shape
    dev = imgs.device
    d = {k: v.to(dev) for k, v in
         cmunet_view_draws(gen, b, h, w, out_size, shift, draws).items()}
    base = resized_crop(imgs, d["crop"], CMUNET_BASE, method="cubic")
    base = random_hflip(base, d["flip"])
    v1 = shift_pixel_crop(base, out_size)
    v2 = shift_pixel_crop(base, out_size, d["shift"])
    return v1, gaussian_noise_max10(v2, d["noise"], d["noise_apply"])


def cmunet_two_views(img: torch.Tensor, out_size: int = 224, shift: int = 31,
                     gen: Optional[torch.Generator] = None,
                     draws: Optional[dict] = None):
    """The two views of one (H, W) image: cmunet_two_views_batch of a batch
    of one."""
    v1, v2 = cmunet_two_views_batch(img[None], out_size, shift, None, gen,
                                    draws)
    return v1[0], v2[0]


# ------------------------------------------------------------------- fine-tune

FINETUNE_DOWN_LEVELS = 6  # downscale_random's static scale levels


def random_brightness_contrast(imgs: torch.Tensor, alpha: torch.Tensor,
                               beta: torch.Tensor,
                               apply: torch.Tensor) -> torch.Tensor:
    """albumentations RandomBrightnessContrast on float images:
    img * alpha + beta per image where apply[i] (alpha = 1 + contrast)."""
    out = imgs * alpha[:, None, None] + beta[:, None, None]
    return torch.where(apply[:, None, None], out, imgs)


def _down_up(imgs: torch.Tensor, scale: float) -> torch.Tensor:
    """Nearest resize of (B, H, W) images down by `scale`, then back up.
    mode="nearest-exact" (half-pixel centres) is jax.image.resize's
    "nearest"; torch's "nearest" is another map."""
    h, w = imgs.shape[1:]
    lh, lw = max(int(h * scale), 1), max(int(w * scale), 1)
    small = F.interpolate(imgs[:, None], size=(lh, lw), mode="nearest-exact")
    return F.interpolate(small, size=(h, w), mode="nearest-exact")[:, 0]


def downscale_random(imgs: torch.Tensor, level: torch.Tensor,
                     apply: torch.Tensor) -> torch.Tensor:
    """albumentations Downscale(0.5, 1.0) with the scale range quantized to
    FINETUNE_DOWN_LEVELS levels (cmx's deviation, kept): image i goes down
    to level[i]'s scale and back where apply[i]; the top level (scale 1) is
    the identity."""
    out = imgs
    for i in range(FINETUNE_DOWN_LEVELS - 1):
        s = 0.5 + 0.5 * i / (FINETUNE_DOWN_LEVELS - 1)
        pick = apply & (level == i)
        out = torch.where(pick[:, None, None], _down_up(imgs, s), out)
    return out


def finetune_draws(gen: Optional[torch.Generator], batch: int, h: int, w: int,
                   draws: Optional[dict] = None) -> dict:
    """The random draws of `finetune_train_aug` for a batch, from `gen`,
    except those given in `draws` (cmx's distributions, per image):
      noise_apply p 0.1, noise_var U(10, 50), noise (B, H, W) N(0, 1);
      blur_apply p 0.2, blur_sigma U(0.5, 1);
      bc_apply p 0.15, alpha 1 + U(-0.2, 0.2), beta U(-0.25, 0.25);
      down_apply p 0.25, down_level uniform in 0..5;
      oneof_apply p 0.75, oneof_branch uniform in 0..3 (hflip, vflip,
      rot90, noise), oneof_var U(10, 50), oneof_noise (B, H, W) N(0, 1)."""
    d = dict(draws or {})
    dev = None if gen is None else gen.device

    def u():
        return torch.rand((batch,), generator=gen, device=dev)

    def normal():
        return torch.randn((batch, h, w), generator=gen, device=dev)

    def randint(n):
        return torch.randint(0, n, (batch,), generator=gen, device=dev)

    fill = {
        "noise_apply": lambda: u() < 0.1,
        "noise_var": lambda: 10.0 + 40.0 * u(),
        "noise": normal,
        "blur_apply": lambda: u() < 0.2,
        "blur_sigma": lambda: 0.5 + 0.5 * u(),
        "bc_apply": lambda: u() < 0.15,
        "alpha": lambda: 1.0 + (0.4 * u() - 0.2),
        "beta": lambda: 0.5 * u() - 0.25,
        "down_apply": lambda: u() < 0.25,
        "down_level": lambda: randint(FINETUNE_DOWN_LEVELS),
        "oneof_apply": lambda: u() < 0.75,
        "oneof_branch": lambda: randint(4),
        "oneof_var": lambda: 10.0 + 40.0 * u(),
        "oneof_noise": normal,
    }
    for name, draw in fill.items():
        if name not in d:
            d[name] = draw()
    return d


def _gauss_noise(imgs: torch.Tensor, var: torch.Tensor, noise: torch.Tensor,
                 apply: torch.Tensor) -> torch.Tensor:
    """albumentations GaussNoise(var_limit): img + sqrt(var) * N(0, 1),
    added to the values as they are, where apply[i]."""
    noisy = imgs + torch.sqrt(var)[:, None, None] * noise
    return torch.where(apply[:, None, None], noisy, imgs)


def finetune_train_aug(imgs: torch.Tensor, masks: torch.Tensor,
                       gen: Optional[torch.Generator] = None,
                       draws: Optional[dict] = None):
    """The supervised fine-tune augmentation (Finetuning/dataset.py:134-163,
    cmx's finetune_train_aug) of (B, H, W) images and their (B, C, H, W)
    one-hot masks:
      GaussNoise(var (10, 50)) p 0.1 -> GaussianBlur(sigma (0.5, 1), radius
      5) p 0.2 -> RandomBrightnessContrast(0.25, 0.2) p 0.15 ->
      Downscale(0.5, 1) p 0.25 -> OneOf{HFlip, VFlip, Rotate90,
      GaussNoise(var (10, 50))} p 0.75.
    Intensity ops touch the image only; the geometric branches move image
    and mask together. The draws of `finetune_draws` come from `gen` unless
    given in `draws`. Returns (imgs fp32, masks)."""
    b, h, w = imgs.shape
    dev = imgs.device
    d = {k: v.to(dev) for k, v in
         finetune_draws(gen, b, h, w, draws).items()}
    x = _gauss_noise(imgs.float(), d["noise_var"], d["noise"],
                     d["noise_apply"])
    x = gaussian_blur(x, d["blur_sigma"], d["blur_apply"], radius=5)
    x = random_brightness_contrast(x, d["alpha"], d["beta"], d["bc_apply"])
    x = downscale_random(x, d["down_level"], d["down_apply"])

    branch = torch.where(d["oneof_apply"], d["oneof_branch"],
                         torch.full_like(d["oneof_branch"], -1))
    noisy = _gauss_noise(x, d["oneof_var"], d["oneof_noise"],
                         torch.ones_like(d["oneof_apply"]))
    out_x, out_m = x, masks
    for i, (xi, mi) in enumerate((
            (x.flip(-1), masks.flip(-1)),
            (x.flip(-2), masks.flip(-2)),
            (torch.rot90(x, 1, dims=(1, 2)), torch.rot90(masks, 1, dims=(2, 3))),
            (noisy, masks))):
        pick = branch == i
        out_x = torch.where(pick[:, None, None], xi, out_x)
        out_m = torch.where(pick[:, None, None, None], mi, out_m)
    return out_x, out_m
