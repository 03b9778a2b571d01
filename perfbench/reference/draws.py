"""The random draws of a train step and the resampling they drive, made
again from the step's seed.

A step's draws come from one generator on the device, seeded from (run
seed, step) as seed * 1_000_003 + step modulo 2^63, and taken in a fixed
order with fixed shapes; the reference takes them in the same order, so
the same seed gives it the same crops, flips, shifts, noise and masks.

The crop is torchvision's RandomResizedCrop window (continuous), resampled
by the separable scale-and-translate map of jax.image: Keys cubic
(a = -0.5), the kernel widened by 1/scale when it shrinks, half-pixel
centres, each output column's weights normalised, columns whose centre
falls outside the input zeroed.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from perfbench.reference.nn import upsample_nearest


def step_generator(device, run_seed: int, step: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((run_seed * 1_000_003 + step) % (2 ** 63))
    return gen


def crop_boxes(gen: torch.Generator, batch: int, h: int, w: int,
               scale: Tuple[float, float], ratio: Tuple[float, float]):
    """(B, 4) windows (height, top, width, left): area a uniform share of
    the image in `scale`, aspect log-uniform in `ratio`, clamped to it."""
    u = torch.rand((4, batch), generator=gen, device=gen.device)
    area = h * w * (scale[0] + (scale[1] - scale[0]) * u[0])
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    aspect = torch.exp(lo + (hi - lo) * u[1])
    cw = torch.clamp(torch.sqrt(area * aspect), 1.0, w)
    ch = torch.clamp(torch.sqrt(area / aspect), 1.0, h)
    return torch.stack([ch, u[2] * (h - ch), cw, u[3] * (w - cw)], 1)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return torch.where(x < 1.0, near, torch.where(x < 2.0, far, 0.0))


def resample_weights(n_in: int, n_out: int, start: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
    """(B, n_in, n_out) cubic weights that resample the span [start,
    start + length) of each row of n_in samples to n_out samples."""
    scale = n_out / length  # (B,)
    inv = 1.0 / scale
    widen = torch.clamp(inv, min=1.0)
    centre = ((torch.arange(n_out, dtype=torch.float32, device=start.device)
               + 0.5)[None] * inv[:, None] + start[:, None] - 0.5)  # (B, out)
    src = torch.arange(n_in, dtype=torch.float32, device=start.device)
    wts = _keys_cubic((centre[:, None, :] - src[None, :, None]).abs()
                      / widen[:, None, None])
    total = wts.sum(1, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    wts = torch.where(total.abs() > eps,
                      wts / torch.where(total != 0, total, 1.0), 0.0)
    inside = (centre >= -0.5) & (centre <= n_in - 0.5)
    return torch.where(inside[:, None, :], wts, 0.0)


def resized_crop(imgs: torch.Tensor, boxes: torch.Tensor,
                 out: int) -> torch.Tensor:
    """Each (H, W) image's window resampled to (out, out), rows then
    columns, in float32."""
    _, h, w = imgs.shape
    wy = resample_weights(h, out, boxes[:, 1], boxes[:, 0])
    wx = resample_weights(w, out, boxes[:, 3], boxes[:, 2])
    return torch.bmm(torch.bmm(wy.transpose(1, 2), imgs.float()), wx)


def keep_lowest(u: torch.Tensor, k: int) -> torch.Tensor:
    """Per row, True at the k smallest entries of `u`."""
    order = torch.argsort(u, dim=-1, stable=True)
    keep = torch.zeros_like(u, dtype=torch.bool)
    return keep.scatter(-1, order[:, :k], True)


def spark_draws(gen: torch.Generator, imgs: torch.Tensor, grid: int,
                mask_ratio: float) -> Dict[str, torch.Tensor]:
    """SparK's step: the RandomResizedCrop (scale (0.67, 1), ratio (3/4,
    4/3), bicubic) to the input size and a horizontal flip with p 0.5, then
    the active grid (B, grid, grid): per image the round((1 - ratio) *
    grid^2) cells (at least one) of lowest uniform draw are visible."""
    b, h, w = imgs.shape
    boxes = crop_boxes(gen, b, h, w, (0.67, 1.0), (3 / 4, 4 / 3))
    flip = torch.rand((b,), generator=gen, device=gen.device) < 0.5
    n = grid * grid
    u = torch.rand((b, n), generator=gen, device=gen.device)
    keep = keep_lowest(u, max(1, round(n * (1 - mask_ratio))))
    view = resized_crop(imgs, boxes, h)
    view = torch.where(flip[:, None, None], view.flip(-1), view)
    return {"view": view, "active": keep.reshape(b, grid, grid).float()}


def cmunet_draws(gen: torch.Generator, imgs: torch.Tensor, view: int,
                 base: int, shift: int, patch: int, mask_ratio: float
                 ) -> Dict[str, torch.Tensor]:
    """CM-UNet's step: one RandomResizedCrop (scale (0.2, 1), ratio (3/4,
    4/3), bicubic) to base^2 and a horizontal flip with p 0.5 shared by
    both views; view 1 the centre view^2 crop, view 2 the crop moved by
    (dy, dx) uniform in 0..shift and clipped to the image, plus max/10
    Gaussian noise with p 0.5; then the patch mask on view 1: per image
    the int(ratio * view^2) // patch^2 patches of lowest uniform draw are
    hidden."""
    b, h, w = imgs.shape
    dev = gen.device
    boxes = crop_boxes(gen, b, h, w, (0.2, 1.0), (3 / 4, 4 / 3))
    flip = torch.rand((b,), generator=gen, device=dev) < 0.5
    moves = torch.randint(0, shift + 1, (b, 2), generator=gen, device=dev)
    noisy = torch.rand((b,), generator=gen, device=dev) < 0.5
    noise = torch.randn((b, view, view), generator=gen, device=dev)
    f = view // patch
    u = torch.rand((b, f * f), generator=gen, device=dev)
    hidden = keep_lowest(u, min(int(mask_ratio * view * view) // (patch * patch),
                                f * f))

    crop = resized_crop(imgs, boxes, base)
    crop = torch.where(flip[:, None, None], crop.flip(-1), crop)
    top = (base - view) // 2
    v1 = crop[:, top:top + view, top:top + view]
    rows = (top + moves[:, 0]).clamp(0, base - view)
    cols = (top + moves[:, 1]).clamp(0, base - view)
    ar = torch.arange(view, device=dev)
    v2 = crop[torch.arange(b, device=dev)[:, None, None],
              (rows[:, None] + ar)[:, :, None], (cols[:, None] + ar)[:, None, :]]
    sigma = v2.amax(dim=(1, 2)) / 10.0
    v2 = torch.where(noisy[:, None, None], v2 + sigma[:, None, None] * noise, v2)
    active = upsample_nearest((~hidden).reshape(b, f, f).float(), patch)
    return {"view1": v1, "view2": v2, "active": active}
