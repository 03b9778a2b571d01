"""SparK, MoCo and CM-UNet pretraining augmentation and the supervised
fine-tune chain (port of cmx/ops/augment.py:34-366, 414-429, 444-449,
596-744, 757-939, 942-947, 986-1110), written over the batch.

The crop is torchvision's RandomResizedCrop window (continuous) resampled to
(out, out) by the separable weight-matrix map of `_resize_weight_mat`:
Keys cubic a=-0.5, antialias widening by 1/scale when downscaling,
half-pixel centres, per-column renormalization, out-of-range columns zeroed
(the map jax.image.scale_and_translate applies in cmx). It runs as two fp32
batched matmuls; TF32 is off on the port's path (cmx_torch.resolve_device).
This is not F.interpolate(mode="bicubic"), which uses a=-0.75 and no
antialias.

The MoCo view chain (`moco_view_aug_batch`) is cmx's: a rotation p 0.5
("nearest": one flat gather over the batch; "shear3": rot90 and three
integer row shears, each one gather; "bilinear": four corner gathers), the
crop, then a per-sample Gaussian blur, flips and max/10 Gaussian noise. The
crop by task.crop_impl: "pallas" is K4 (`crop_resize_pallas`);
"scale_translate" and "einsum" the plain weight-matrix map in fp32;
"einsum_bf16" the same map on bf16 operands; "bank" the integer window's
weights fetched by index from a bank built once on the host
(`bank_crop_batch`); "bank_fused" the bank crop, blur and flips composed
into two matrices per image, applied as two fp32 batched matmuls
(`moco_view_tail_matmul`). Every random draw may be injected (`draws`).

The CM-UNet views (`cmunet_two_views_batch`) are cmx's chain: the shared
cubic crop to 256^2 (the weight-matrix map, or the bank crop for "bank" /
"bank_fused") and flip, the centre and the shifted crops, and noise on
view 2; every draw may be injected (`cmunet_view_draws`).

The fine-tune chain (`finetune_train_aug`) is cmx's per-image one, applied
to every image of the batch with per-image draws (`finetune_draws`):
Gaussian noise, blur, brightness/contrast, a nearest down-and-up scale, and
a OneOf over hflip / vflip / rot90 / noise whose geometric branches move the
image and its one-hot mask together.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
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


def box_to_crop(box: torch.Tensor, out_size: int) -> torch.Tensor:
    """(B, 4) windows (ch, y0, cw, x0) -> the (B, 4) scale_and_translate
    arguments (sy, ty, sx, tx) that resample them to (out, out)."""
    ch, y0, cw, x0 = box.unbind(1)
    sy = out_size / ch
    sx = out_size / cw
    return torch.stack([sy, -y0 * sy, sx, -x0 * sx], dim=1)


def _crop_window_params(gen: torch.Generator, batch: int, h: int, w: int,
                        out_size: int, scale: Tuple[float, float],
                        ratio: Tuple[float, float]) -> torch.Tensor:
    """(B, 4) scale_and_translate arguments (sy, ty, sx, tx) per sample."""
    box = torch.stack(_crop_window_box(gen, batch, h, w, scale, ratio), 1)
    return box_to_crop(box, out_size)


def _separable(wy: torch.Tensor, imgs: torch.Tensor,
               wx: torch.Tensor) -> torch.Tensor:
    """wy^T img wx per image: (B, h, o) weights, (B, h, w) images, (B, w, p)
    weights -> (B, o, p), rows first (cmx's two einsums)."""
    return torch.bmm(torch.bmm(wy.transpose(1, 2), imgs), wx)


def resized_crop(imgs: torch.Tensor, params: torch.Tensor, out_size: int,
                 method: str = "linear", bf16: bool = False) -> torch.Tensor:
    """Resample (B, H, W) images with per-sample (sy, ty, sx, tx) to
    (B, out, out) as two fp32 batched matmuls. With `bf16` (cmx's
    crop_impl "einsum_bf16") the image and both weight matrices are cast to
    bf16 and each product returns bf16, as jnp's bf16 einsum does: the
    intermediate rounds to bf16 between the two products; the result is
    cast to fp32."""
    b, h, w = imgs.shape
    p = params.float()
    wy = _resize_weight_mat(h, out_size, p[:, 0], p[:, 1], method)  # (B,h,o)
    wx = _resize_weight_mat(w, out_size, p[:, 2], p[:, 3], method)  # (B,w,o)
    if bf16:
        bf = torch.bfloat16
        return _separable(wy.to(bf), imgs.to(bf), wx.to(bf)).float()
    return _separable(wy, imgs.float(), wx)


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
MOCO_BLUR_RADIUS = 3
# the crop_impl values that crop through the weight bank; cmx runs any
# value its random_resized_crop does not name as "scale_translate"
_BANK_IMPLS = ("bank", "bank_fused")


def random_vflip(imgs: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Flip image i top-bottom where flip[i] is True."""
    return torch.where(flip[:, None, None], imgs.flip(-2), imgs)


def _rotation_sources(h: int, w: int, angles: torch.Tensor):
    """(src_y, src_x), each (B, H, W) fp32: the source coordinates of every
    output pixel of a rotation by angles[i] (radians) about the centre."""
    dev = angles.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = (torch.arange(h, dtype=torch.float32, device=dev) - cy)[None, :, None]
    xx = (torch.arange(w, dtype=torch.float32, device=dev) - cx)[None, None, :]
    c = torch.cos(angles.float())[:, None, None]
    s = torch.sin(angles.float())[:, None, None]
    return c * yy - s * xx + cy, s * yy + c * xx + cx


def _take_inside(imgs: torch.Tensor, iy: torch.Tensor,
                 ix: torch.Tensor) -> torch.Tensor:
    """imgs[b, iy, ix] for (B, H, W) integer coordinates, 0 where they
    leave the image: one flat gather over the batch."""
    b, h, w = imgs.shape
    inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    base = (torch.arange(b, device=imgs.device) * (h * w))[:, None, None]
    v = torch.take(imgs, base + iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1))
    return torch.where(inside, v, torch.zeros_like(v))


def batch_rotate_nearest(imgs: torch.Tensor, angles: torch.Tensor,
                         apply: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour rotation of image i by angles[i] (radians) about
    its centre where apply[i], zero outside: one flat gather over the batch.
    round() is half-to-even, as jnp.round."""
    b, h, w = imgs.shape
    src_y, src_x = _rotation_sources(h, w, angles)
    rot = _take_inside(imgs, torch.round(src_y).long(),
                       torch.round(src_x).long()).float()
    return torch.where(apply[:, None, None], rot, imgs)


def batch_rotate_bilinear(imgs: torch.Tensor, angles: torch.Tensor,
                          apply: torch.Tensor) -> torch.Tensor:
    """Bilinear rotation of image i by angles[i] about its centre where
    apply[i]: jax.scipy.ndimage.map_coordinates(order=1, mode="constant",
    cval=0) at the nearest rotation's source coordinates. Four corner
    gathers, a corner outside the image contributing 0, each term weighted
    by (y weight * x weight) and summed in map_coordinates' order (top-left,
    top-right, bottom-left, bottom-right)."""
    b, h, w = imgs.shape
    src_y, src_x = _rotation_sources(h, w, angles)
    fy, fx = torch.floor(src_y), torch.floor(src_x)
    uy, ux = src_y - fy, src_x - fx
    ys = ((fy.long(), 1 - uy), (fy.long() + 1, uy))
    xs = ((fx.long(), 1 - ux), (fx.long() + 1, ux))
    rot = None
    for iy, wy in ys:
        for ix, wx in xs:
            term = (wy * wx) * _take_inside(imgs, iy, ix)
            rot = term if rot is None else rot + term
    return torch.where(apply[:, None, None], rot, imgs)


def _shear_rows(imgs: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """out[b, i, j] = imgs[b, i, j + shifts[b, i]], zero where j + shift
    leaves the row: one gather from the rows zero-padded by W on each side
    (a shift past W lands in the padding too). cmx's four shear bodies
    (augment.py:478-593) are TPU formulations of this integer shift, exact
    in fp32 as this one is."""
    b, h, w = imgs.shape
    idx = (torch.arange(w, device=imgs.device)[None, None, :]
           + shifts[:, :, None] + w).clamp(0, 3 * w - 1)
    return torch.gather(F.pad(imgs, (w, w)), 2, idx)


def batch_rotate_shear3(imgs: torch.Tensor, angles: torch.Tensor,
                        apply: torch.Tensor) -> torch.Tensor:
    """cmx's "shear3" rotation (_rotate_shear3) of square image i by
    angles[i] where apply[i]: rot90 by (-quarter) mod 4, quarter =
    round(angle / (pi/2)) (half to even), then three integer row shears of
    the remaining phi = -(angle - quarter * pi/2): x by round(-tan(phi/2) *
    y), y by round(sin(phi) * x), x again (coordinates about the centre).
    Same distribution as the nearest gather, other per-pixel rounding."""
    b, h, w = imgs.shape
    if h != w:
        raise ValueError(f"shear3 rotation requires square images, got "
                         f"{h}x{w}")
    x = imgs.float()
    angle = angles.float()
    quarter = torch.round(angle / (math.pi / 2)).to(torch.int32)
    phi = -(angle - quarter * (math.pi / 2))
    turns = torch.remainder(-quarter, 4)
    rot = x
    for k in (1, 2, 3):
        rot = torch.where((turns == k)[:, None, None],
                          torch.rot90(x, k, dims=(1, 2)), rot)
    pos = torch.arange(h, dtype=torch.float32, device=x.device) - (h - 1) / 2.0
    sx = torch.round(-torch.tan(phi / 2.0)[:, None] * pos[None, :]).long()
    sy = torch.round(torch.sin(phi)[:, None] * pos[None, :]).long()
    rot = _shear_rows(rot, sx)
    rot = _shear_rows(rot.transpose(1, 2), sy).transpose(1, 2)
    rot = _shear_rows(rot, sx)
    return torch.where(apply[:, None, None], rot, imgs)


def rotate_batch(imgs: torch.Tensor, angles: torch.Tensor,
                 apply: torch.Tensor, method: str = "nearest") -> torch.Tensor:
    """The MoCo rotation by task.rotation_method: "shear3", "bilinear", or
    the nearest gather for "nearest" and any other value (cmx's
    random_rotation gathers nearest for every method it does not name)."""
    if method == "shear3":
        return batch_rotate_shear3(imgs, angles, apply)
    if method == "bilinear":
        return batch_rotate_bilinear(imgs, angles, apply)
    return batch_rotate_nearest(imgs, angles, apply)


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


# ------------------------------------------------------------- bank crop

_BANK_PAD = 4  # bank row margin: kernel support never exceeds 2 taps/side
_BANK_CACHE: dict = {}  # (in, out, method, ch_min, ch_max) -> numpy bank
_BANK_TENSORS: dict = {}  # the same key and a device -> the bank there
_BLUR_BASIS_CACHE: dict = {}  # (n, radius) -> numpy basis
_BLUR_BASIS_TENSORS: dict = {}


def crop_ch_range(
    in_size: int, scale: Tuple[float, float], ratio: Tuple[float, float],
    other_size: Optional[int] = None, axis: str = "h",
) -> Tuple[int, int]:
    """Integer range [ch_min, ch_max] one crop axis can take under the
    torchvision area/aspect draw (used to size the weight bank).

    The two axes have DIFFERENT ranges under an asymmetric aspect draw
    (aspect = w/h in [ratio[0], ratio[1]], area = scale * H * W):
      height ch = sqrt(area / aspect) in [sqrt(s0*A/r1), sqrt(s1*A/r0)]
      width  cw = sqrt(area * aspect) in [sqrt(s0*A*r0), sqrt(s1*A*r1)]
    They coincide only when r0*r1 == 1 (the symmetric 3/4..4/3 default)."""
    other = other_size or in_size
    area = in_size * other
    if axis == "h":
        lo = math.sqrt(scale[0] * area / ratio[1])
        hi = math.sqrt(scale[1] * area / ratio[0])
    elif axis == "w":
        lo = math.sqrt(scale[0] * area * ratio[0])
        hi = math.sqrt(scale[1] * area * ratio[1])
    else:
        raise ValueError(f"axis must be 'h' or 'w', got {axis!r}")
    return max(1, int(math.floor(lo))), min(in_size, int(math.ceil(hi)))


def _crop_weight_bank(in_size: int, out_size: int, method: str, ch_min: int,
                      ch_max: int) -> np.ndarray:
    """(L, P, out) resample-weight bank for integer crop extents
    ch in [ch_min, ch_max], window at offset 0, on a padded row axis
    (P = in_size + 2*_BANK_PAD, row p = input position p - _BANK_PAD).

    Each level's weights are window-confined: taps are masked to [0, ch)
    and renormalized per output column (torchvision's crop-then-resize).
    Built in numpy on the host with cmx's code, so the bank is cmx's bit
    for bit; cached per (sizes, method, range)."""
    key = (in_size, out_size, method, ch_min, ch_max)
    if key not in _BANK_CACHE:
        pad = _BANK_PAD
        pos = (np.arange(in_size + 2 * pad, dtype=np.float32) - pad)[None, :, None]
        chs = np.arange(ch_min, ch_max + 1, dtype=np.float32)[:, None, None]
        inv = chs / out_size
        kernel_scale = np.maximum(inv, 1.0)  # antialias on downscale
        sample_f = ((np.arange(out_size, dtype=np.float32)[None, None, :] + 0.5)
                    * inv - 0.5)
        x = np.abs(sample_f - pos) / kernel_scale  # (L, P, out)
        if method in ("linear", "triangle", "bilinear"):
            w = np.maximum(0.0, 1.0 - x)
        elif method in ("cubic", "bicubic"):
            xx = x
            w = ((1.5 * xx - 2.5) * xx) * xx + 1.0
            w = np.where(xx >= 1.0, ((-0.5 * xx + 2.5) * xx - 4.0) * xx + 2.0, w)
            w = np.where(xx >= 2.0, 0.0, w)
        else:
            raise ValueError(f"unsupported resize method {method!r}")
        inside = (pos >= 0.0) & (pos <= chs - 1.0)
        w = np.where(inside, w, 0.0).astype(np.float32)
        total = np.sum(w, axis=1, keepdims=True)
        w = w / np.where(total > 0, total, 1.0)
        _BANK_CACHE[key] = w
    return _BANK_CACHE[key]


def _on_device(cache: dict, key: tuple, make, device) -> torch.Tensor:
    """The numpy array `make()` as a tensor on `device`, moved there once."""
    k = key + (str(device),)
    if k not in cache:
        cache[k] = torch.from_numpy(make()).to(device)
    return cache[k]


def bank_windows(box: torch.Tensor, h: int, w: int,
                 scale: Tuple[float, float] = MOCO_SCALE,
                 ratio: Tuple[float, float] = MOCO_RATIO):
    """The integer windows (chi, y0i, cwi, x0i), each (B,) int64, of the
    continuous (B, 4) boxes (ch, y0, cw, x0): extents rounded (half to even)
    and clipped to the bank's range, offsets rounded and clipped so the
    window stays inside the image (torchvision's own quantization)."""
    lo_y, hi_y = crop_ch_range(h, scale, ratio, w, axis="h")
    lo_x, hi_x = crop_ch_range(w, scale, ratio, h, axis="w")
    ch, y0, cw, x0 = box.float().unbind(1)
    chi = torch.round(ch).long().clamp(lo_y, hi_y)
    cwi = torch.round(cw).long().clamp(lo_x, hi_x)
    y0i = torch.minimum(torch.round(y0).long().clamp(min=0), h - chi)
    x0i = torch.minimum(torch.round(x0).long().clamp(min=0), w - cwi)
    return chi, y0i, cwi, x0i


def bank_axis_weights(in_size: int, out_size: int, method: str,
                      ch: torch.Tensor, off: torch.Tensor, ch_min: int,
                      ch_max: int) -> torch.Tensor:
    """(B, in, out) per-sample resample weights fetched from the bank by
    index: row i of sample b is bank[ch_b - ch_min][i - off_b + _BANK_PAD],
    zero where that row index is negative (a window far from the origin;
    i - off_b + _BANK_PAD never reaches P). cmx fetches them with two one-hot
    matmuls at Precision.HIGHEST, each output one non-zero product: the same
    values, bit for bit. A negative index is clamped to row 0, which holds
    input position -_BANK_PAD, outside every window: a zero row."""
    bank = _on_device(_BANK_TENSORS, (in_size, out_size, method, ch_min,
                                      ch_max),
                      lambda: _crop_weight_bank(in_size, out_size, method,
                                                ch_min, ch_max), ch.device)
    rows = (torch.arange(in_size, device=ch.device)[None, :] - off[:, None]
            + _BANK_PAD).clamp(min=0)
    flat = (ch - ch_min)[:, None] * bank.shape[1] + rows
    wts = bank.reshape(-1, out_size).index_select(0, flat.reshape(-1))
    return wts.view(ch.shape[0], in_size, out_size)


def _bank_weights(box: torch.Tensor, h: int, w: int, out_size: int,
                  method: str, scale: Tuple[float, float],
                  ratio: Tuple[float, float]):
    """(wy (B, h, out), wx (B, w, out)) of the boxes' integer windows."""
    chi, y0i, cwi, x0i = bank_windows(box, h, w, scale, ratio)
    wy = bank_axis_weights(h, out_size, method, chi, y0i,
                           *crop_ch_range(h, scale, ratio, w, axis="h"))
    wx = bank_axis_weights(w, out_size, method, cwi, x0i,
                           *crop_ch_range(w, scale, ratio, h, axis="w"))
    return wy, wx


def bank_crop_batch(imgs: torch.Tensor, box: torch.Tensor, out_size: int,
                    method: str = "linear",
                    scale: Tuple[float, float] = MOCO_SCALE,
                    ratio: Tuple[float, float] = MOCO_RATIO) -> torch.Tensor:
    """RandomResizedCrop of (B, H, W) images over their (B, 4) continuous
    boxes (ch, y0, cw, x0), rounded to integer windows, with weights from
    the bank: two fp32 batched matmuls. Against the continuous crops the
    one deviation is the window's quantization, which torchvision makes
    too."""
    b, h, w = imgs.shape
    wy, wx = _bank_weights(box, h, w, out_size, method, scale, ratio)
    return _separable(wy, imgs.float(), wx)


def _blur_basis(n: int, radius: int) -> np.ndarray:
    """(2r+1, n, n) 0/1 banded basis: basis[t][i, clamp(i+t-r)] = 1, so
    sum_t taps[t] * basis[t] is the replicate-padded blur's matrix."""
    key = (n, radius)
    if key not in _BLUR_BASIS_CACHE:
        t = np.arange(2 * radius + 1)[:, None]
        i = np.arange(n)[None, :]
        j = np.clip(i + t - radius, 0, n - 1)  # (T, n)
        basis = np.zeros((2 * radius + 1, n, n), np.float32)
        ti = np.broadcast_to(t, j.shape)
        ii = np.broadcast_to(i, j.shape)
        np.add.at(basis, (ti.ravel(), ii.ravel(), j.ravel()), 1.0)
        _BLUR_BASIS_CACHE[key] = basis
    return _BLUR_BASIS_CACHE[key]


def moco_view_tail_matmul(rot: torch.Tensor, d: dict, out_size: int,
                          method: str = "linear",
                          scale: Tuple[float, float] = MOCO_SCALE,
                          ratio: Tuple[float, float] = MOCO_RATIO,
                          blur_radius: int = MOCO_BLUR_RADIUS) -> torch.Tensor:
    """crop_impl "bank_fused": the MoCo chain after the rotation (bank crop
    -> blur p 0.5 -> hflip -> vflip) as two matrices per image, then the
    noise. The blur is its Toeplitz matrix, the taps on the 0/1 basis of
    `_blur_basis`; the p-gate puts a delta in place of the taps, so an
    unblurred image gets the identity. A_y = blur @ W_y^T and A_x = blur @
    W_x^T (W the bank weights); vflip reverses A_y's output rows, hflip
    A_x's; the view is A_y img A_x^T, two fp32 batched matmuls. The draws
    are the chain's: box, blur_apply, sigma, hflip, vflip, noise_apply,
    noise."""
    b, h, w = rot.shape
    dev = rot.device
    wy, wx = _bank_weights(d["box"].to(dev), h, w, out_size, method, scale,
                           ratio)
    n_taps = 2 * blur_radius + 1
    taps = _gaussian_kernel_1d(d["sigma"].to(dev), blur_radius)
    # made on the device: a scalar written into it is copied from the host
    delta = (torch.arange(n_taps, device=dev) == blur_radius).float()
    taps = torch.where(d["blur_apply"].to(dev)[:, None], taps, delta[None, :])
    basis = _on_device(_BLUR_BASIS_TENSORS, (out_size, blur_radius),
                       lambda: _blur_basis(out_size, blur_radius), dev)
    blur = torch.mm(taps, basis.reshape(n_taps, -1)).view(b, out_size,
                                                           out_size)
    a_y = torch.bmm(blur, wy.transpose(1, 2))  # (B, out, h)
    a_x = torch.bmm(blur, wx.transpose(1, 2))  # (B, out, w)
    a_y = torch.where(d["vflip"].to(dev)[:, None, None], a_y.flip(1), a_y)
    a_x = torch.where(d["hflip"].to(dev)[:, None, None], a_x.flip(1), a_x)
    img = torch.bmm(torch.bmm(a_y, rot.float()), a_x.transpose(1, 2))
    return gaussian_noise_max10(img, d["noise"].to(dev),
                                d["noise_apply"].to(dev))


# ------------------------------------------------------------- MoCo views


def moco_view_draws(gen: torch.Generator, batch: int, h: int, w: int,
                    out_size: int, draws: Optional[dict] = None) -> dict:
    """The random draws of one MoCo view of a batch, from `gen`, except
    those given in `draws`:
      angle (B,) radians U(-pi, pi), rot_apply (B,) p 0.5;
      box (B,4) RandomResizedCrop(scale (0.2, 1)) windows (ch, y0, cw, x0),
      and crop (B,4), the (sy, ty, sx, tx) that resample them to out^2;
      blur_apply (B,) p 0.5, sigma (B,) U(0.1, 2);
      hflip, vflip (B,) p 0.5;
      noise_apply (B,) p 0.5, noise (B, out, out) standard normal.
    A "crop" given without a "box" is kept and no box is drawn: the
    continuous crops need none, and the bank crops refuse such draws (the
    window cannot be recovered from (sy, ty) without rounding)."""
    d = dict(draws or {})
    dev = None if gen is None else gen.device

    def u(n=batch):
        return torch.rand((n,), generator=gen, device=dev)

    fill = {
        "angle": lambda: (u() * 2.0 - 1.0) * math.pi,
        "rot_apply": lambda: u() < 0.5,
        "box": lambda: torch.stack(_crop_window_box(
            gen, batch, h, w, MOCO_SCALE, MOCO_RATIO), 1),
        "blur_apply": lambda: u() < 0.5,
        "sigma": lambda: 0.1 + 1.9 * u(),
        "hflip": lambda: u() < 0.5,
        "vflip": lambda: u() < 0.5,
        "noise_apply": lambda: u() < 0.5,
        "noise": lambda: torch.randn((batch, out_size, out_size),
                                     generator=gen, device=dev),
    }
    for name, draw in fill.items():
        if name not in d and not (name == "box" and "crop" in d):
            d[name] = draw()
    if "crop" not in d:
        d["crop"] = box_to_crop(d["box"], out_size)
    return d


def _moco_view_post_crop(imgs: torch.Tensor, d: dict) -> torch.Tensor:
    """After the crop: blur p 0.5 (sigma 0.1-2, radius 3) -> hflip -> vflip
    -> noise max/10 p 0.5."""
    dev = imgs.device
    imgs = gaussian_blur(imgs, d["sigma"].to(dev), d["blur_apply"].to(dev),
                         MOCO_BLUR_RADIUS)
    imgs = random_hflip(imgs, d["hflip"].to(dev))
    imgs = random_vflip(imgs, d["vflip"].to(dev))
    return gaussian_noise_max10(imgs, d["noise"].to(dev),
                                d["noise_apply"].to(dev))


def _need_box(d: dict, impl: str) -> torch.Tensor:
    if "box" not in d:
        raise ValueError(
            f"crop_impl {impl!r} crops the integer window of the draw 'box' "
            "(ch, y0, cw, x0); these draws hold only 'crop', from which the "
            "window is not recovered without rounding")
    return d["box"]


def moco_view_tail(rot: torch.Tensor, d: dict, out_size: int = 224,
                   crop_method: Optional[str] = None,
                   crop_impl: Optional[str] = None) -> torch.Tensor:
    """The MoCo view after its rotation (`rot`, fp32): the crop by
    crop_impl, then blur, flips and noise, from the draws `d` (see
    `moco_view_aug_batch`)."""
    impl = crop_impl or "scale_translate"
    box = _need_box(d, impl) if impl in _BANK_IMPLS else None
    dev = rot.device
    crop_method = crop_method or "linear"
    if impl == "bank_fused":
        return moco_view_tail_matmul(rot, d, out_size, crop_method)
    if box is not None:
        cropped = bank_crop_batch(rot, box.to(dev), out_size, crop_method)
    elif impl == "pallas":
        from cmx_torch.ops.pallas_crop import crop_resize_pallas

        cropped = crop_resize_pallas(rot, d["crop"].to(dev), out_size,
                                     crop_method)
    else:
        cropped = resized_crop(rot, d["crop"].to(dev), out_size, crop_method,
                               bf16=impl == "einsum_bf16")
    return _moco_view_post_crop(cropped, d)


def moco_view_aug_batch(imgs: torch.Tensor, out_size: int = 224,
                        rotation_method: Optional[str] = None,
                        crop_method: Optional[str] = None,
                        crop_impl: Optional[str] = None,
                        gen: Optional[torch.Generator] = None,
                        draws: Optional[dict] = None) -> torch.Tensor:
    """One MoCo v2 view of a (B, H, W) batch (moco_data_module.py:119-132):
    RandomRotation(180) p 0.5 -> RandomResizedCrop(out, (0.2, 1)) ->
    GaussianBlur p 0.5 -> HFlip -> VFlip -> GaussNoise(max/10) p 0.5.

    rotation_method (None: "nearest"): see `rotate_batch`; "shear3" takes
    square images. crop_impl (None: "scale_translate"): "pallas" is K4;
    "scale_translate", "einsum" and any value cmx does not name the plain
    weight-matrix map; "einsum_bf16" that map on bf16 operands; "bank" the
    bank crop; "bank_fused" the fused tail (`moco_view_tail_matmul`) after
    every rotation. After a rotation other than "nearest" and "shear3",
    cmx's per-sample fallback runs "bank_fused" as the bank crop followed
    by the per-stage blur, flips and noise (augment.py:393-395, 1010-1012);
    the fused tail equals that chain to fp32 round-off (rel 1e-5 in the
    tests). The draws of `moco_view_draws` come from `gen` unless given in
    `draws`; the bank impls need its "box"."""
    b, h, w = imgs.shape
    dev = imgs.device
    d = moco_view_draws(gen, b, h, w, out_size, draws)
    rot = rotate_batch(imgs.float(), d["angle"].to(dev),
                       d["rot_apply"].to(dev), rotation_method or "nearest")
    return moco_view_tail(rot, d, out_size, crop_method, crop_impl)


# ------------------------------------------------------------------- CM-UNet

CMUNET_BASE = 256  # the shared RandomResizedCrop's output size
CMUNET_SCALE = (0.2, 1.0)
# crop_impl values that take cmx's plain vmapped chain for the CM-UNet views
# (cmx/ops/augment.py:1091-1093); cmx runs every other value ("bank",
# "bank_fused") through the bank crop, and so does the port.
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
      box (B,4) RandomResizedCrop(256, scale (0.2, 1)) windows
      (ch, y0, cw, x0), and crop (B,4), the (sy, ty, sx, tx) that resample
      them to 256^2; flip (B,) p 0.5;
      shift (B,2) view 2's (dy, dx), integers in [0, shift];
      noise_apply (B,) p 0.5, noise (B, out, out) standard normal.
    A "crop" given without a "box" is kept and no box is drawn, as in
    `moco_view_draws`."""
    d = dict(draws or {})
    dev = None if gen is None else gen.device
    fill = {
        "box": lambda: torch.stack(_crop_window_box(
            gen, batch, h, w, CMUNET_SCALE, MOCO_RATIO), 1),
        "flip": lambda: torch.rand((batch,), generator=gen, device=dev) < 0.5,
        "shift": lambda: torch.randint(0, shift + 1, (batch, 2),
                                       generator=gen, device=dev),
        "noise_apply": lambda: torch.rand((batch,), generator=gen,
                                          device=dev) < 0.5,
        "noise": lambda: torch.randn((batch, out_size, out_size),
                                     generator=gen, device=dev),
    }
    for name, draw in fill.items():
        if name not in d and not (name == "box" and "crop" in d):
            d[name] = draw()
    if "crop" not in d:
        d["crop"] = box_to_crop(d["box"], CMUNET_BASE)
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
    chain with the weight-matrix map, as in cmx (its "pallas" too: no
    kernel); "bank", "bank_fused" and any other value crop the integer
    window of the draw "box" through the bank (`bank_crop_batch`), the
    flip then a column reversal, as cmx's batch path does. The draws of
    `cmunet_view_draws` come from `gen` unless given in `draws`."""
    b, h, w = imgs.shape
    dev = imgs.device
    d = {k: v.to(dev) for k, v in
         cmunet_view_draws(gen, b, h, w, out_size, shift, draws).items()}
    if crop_impl in _CMUNET_CHAIN_IMPLS:
        base = resized_crop(imgs, d["crop"], CMUNET_BASE, method="cubic")
    else:
        base = bank_crop_batch(imgs, _need_box(d, crop_impl), CMUNET_BASE,
                               "cubic", CMUNET_SCALE, MOCO_RATIO)
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
