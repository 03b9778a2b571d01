"""The extended augmentation ops (port of cmx/ops/augment_extra.py): the
rest of the reference's transform library, single-channel, over a (B, H, W)
batch.

Counterparts of CM-UNet's pipelines (cmae/datasets/pipelines/processing.py
RandomErasing, ResizeEdge, ColorJitter; auto_augment.py Solarize, Posterize,
Translate), BEiT's two-size crop, mmcls's padded RandomCrop and the
MultiView wrapper. No training path reaches them; they are library surface,
as in cmx.

Each random op takes its per-image draws as tensors, and has a `*_draws`
function that makes them from a torch.Generator (or keeps those given in
`draws`): cmx draws from per-image keys, so parity tests inject cmx's
values here, as for cmx_torch.ops.augment.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from cmx_torch.ops.augment import (_crop_window_box, _resize_weight_mat,
                                   box_to_crop, resized_crop)


def _fill(d: Optional[dict], fill: dict) -> dict:
    """`d` (copied) with every draw of `fill` it lacks made in order."""
    d = dict(d or {})
    for name, draw in fill.items():
        if name not in d:
            d[name] = draw()
    return d


def _u(gen: Optional[torch.Generator], batch: int) -> torch.Tensor:
    return torch.rand((batch,), generator=gen,
                      device=None if gen is None else gen.device)


def _gate(apply: torch.Tensor, out: torch.Tensor,
          imgs: torch.Tensor) -> torch.Tensor:
    return torch.where(apply[:, None, None], out, imgs)


def _lo_hi(imgs: torch.Tensor):
    return (imgs.amin(dim=(1, 2), keepdim=True),
            imgs.amax(dim=(1, 2), keepdim=True))


def apply_draws(gen: Optional[torch.Generator], batch: int, p: float,
                draws: Optional[dict] = None) -> dict:
    """apply (B,) p: the draws of solarize, posterize and invert."""
    return _fill(draws, {"apply": lambda: _u(gen, batch) < p})


def color_jitter_draws(gen: Optional[torch.Generator], batch: int,
                       brightness: float = 0.4, contrast: float = 0.4,
                       p: float = 1.0, draws: Optional[dict] = None) -> dict:
    """b (B,) U(1 - brightness, 1 + brightness), c (B,) U(1 - contrast,
    1 + contrast), apply (B,) p."""
    return _fill(draws, {
        "b": lambda: 1 - brightness + 2 * brightness * _u(gen, batch),
        "c": lambda: 1 - contrast + 2 * contrast * _u(gen, batch),
        "apply": lambda: _u(gen, batch) < p})


def color_jitter(imgs: torch.Tensor, d: dict) -> torch.Tensor:
    """Brightness/contrast jitter (the grayscale reduction of ColorJitter):
    x * b, then (x - mean) * c + mean, where d["apply"]."""
    out = imgs * d["b"][:, None, None]
    mean = out.mean(dim=(1, 2), keepdim=True)
    out = (out - mean) * d["c"][:, None, None] + mean
    return _gate(d["apply"], out, imgs)


def random_erasing_draws(gen: Optional[torch.Generator], batch: int,
                         area_range: Tuple[float, float] = (0.02, 0.33),
                         aspect_range: Tuple[float, float] = (0.3, 3.33),
                         p: float = 0.5, draws: Optional[dict] = None) -> dict:
    """area (B,) U(area_range) (a fraction of the image), log_r (B,)
    U(log aspect_range), uy, ux (B,) U(0, 1) placing the rectangle, apply
    (B,) p."""
    lo, hi = math.log(aspect_range[0]), math.log(aspect_range[1])
    return _fill(draws, {
        "area": lambda: area_range[0] + (area_range[1] - area_range[0])
        * _u(gen, batch),
        "log_r": lambda: lo + (hi - lo) * _u(gen, batch),
        "uy": lambda: _u(gen, batch),
        "ux": lambda: _u(gen, batch),
        "apply": lambda: _u(gen, batch) < p})


def random_erasing(imgs: torch.Tensor, d: dict,
                   fill: float = 0.0) -> torch.Tensor:
    """RandomErasing (processing.py:616-776): `fill` inside a random
    rectangle of height sqrt(area * aspect) and width sqrt(area / aspect)
    (clipped to the image; cmx's orientation), where d["apply"]."""
    b, h, w = imgs.shape
    area = h * w * d["area"]
    aspect = torch.exp(d["log_r"])
    eh = torch.clamp(torch.sqrt(area * aspect), 1, h)
    ew = torch.clamp(torch.sqrt(area / aspect), 1, w)
    y0, x0 = d["uy"] * (h - eh), d["ux"] * (w - ew)
    eh, ew, y0, x0 = (t[:, None, None] for t in (eh, ew, y0, x0))
    rows = torch.arange(h, dtype=torch.float32, device=imgs.device)[:, None]
    cols = torch.arange(w, dtype=torch.float32, device=imgs.device)[None, :]
    inside = ((rows >= y0) & (rows < y0 + eh) & (cols >= x0)
              & (cols < x0 + ew))
    erased = torch.where(inside, torch.full_like(imgs, fill), imgs)
    return _gate(d["apply"], erased, imgs)


def solarize(imgs: torch.Tensor, apply: torch.Tensor,
             thr: float = 0.5) -> torch.Tensor:
    """Invert the values at or above lo + thr * (hi - lo), on each image's
    own range [lo, hi] (auto_augment Solarize), where apply."""
    lo, hi = _lo_hi(imgs)
    t = lo + thr * (hi - lo)
    return _gate(apply, torch.where(imgs >= t, hi + lo - imgs, imgs), imgs)


def posterize(imgs: torch.Tensor, apply: torch.Tensor,
              bits: int = 4) -> torch.Tensor:
    """Quantize each image to 2^bits levels over its own range
    (auto_augment Posterize), where apply."""
    lo, hi = _lo_hi(imgs)
    span = torch.clamp(hi - lo, min=1e-8)
    levels = float(2 ** bits - 1)
    q = torch.round((imgs - lo) / span * levels) / levels * span + lo
    return _gate(apply, q, imgs)


def invert(imgs: torch.Tensor, apply: torch.Tensor) -> torch.Tensor:
    """hi + lo - x on each image's own range, where apply."""
    lo, hi = _lo_hi(imgs)
    return _gate(apply, hi + lo - imgs, imgs)


def resize_edge(imgs: torch.Tensor, edge: int,
                mode: str = "short") -> torch.Tensor:
    """ResizeEdge (processing.py:778-876): bilinear (antialiased) resize of
    (B, H, W) images so the short (or long) edge equals `edge`, as
    jax.image.resize: the weight-matrix map at scale new/old and
    translation 0, an axis whose size stays untouched."""
    b, h, w = imgs.shape
    scale = edge / (min(h, w) if mode == "short" else max(h, w))
    nh, nw = int(round(h * scale)), int(round(w * scale))
    x = imgs.float()
    for axis, (n, m) in enumerate(((h, nh), (w, nw))):
        if n == m:
            continue
        s = torch.tensor([m / n], dtype=torch.float32, device=x.device)
        wt = _resize_weight_mat(n, m, s, torch.zeros_like(s), "linear")[0]
        x = (torch.matmul(wt.t(), x) if axis == 0 else torch.matmul(x, wt))
    return x


def translate_draws(gen: Optional[torch.Generator], batch: int, h: int,
                    w: int, max_frac: float = 0.2, p: float = 0.5,
                    draws: Optional[dict] = None) -> dict:
    """dy, dx (B,) integer shifts in [-int(h * max_frac), int(h *
    max_frac)] (w for dx), apply (B,) p."""
    my, mx = int(h * max_frac), int(w * max_frac)
    dev = None if gen is None else gen.device
    return _fill(draws, {
        "dy": lambda: torch.randint(-my, my + 1, (batch,), generator=gen,
                                    device=dev),
        "dx": lambda: torch.randint(-mx, mx + 1, (batch,), generator=gen,
                                    device=dev),
        "apply": lambda: _u(gen, batch) < p})


def _shift_crop(imgs: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                out_h: int, out_w: int) -> torch.Tensor:
    """imgs[b, y0[b]:y0[b]+out_h, x0[b]:x0[b]+out_w] for in-range offsets."""
    dev = imgs.device
    rows = y0.long()[:, None] + torch.arange(out_h, device=dev)
    cols = x0.long()[:, None] + torch.arange(out_w, device=dev)
    idx = torch.arange(imgs.shape[0], device=dev)[:, None, None]
    return imgs[idx, rows[:, :, None], cols[:, None, :]]


def translate(imgs: torch.Tensor, d: dict,
              max_frac: float = 0.2) -> torch.Tensor:
    """Integer translation by (dy, dx) with zero fill (auto_augment
    Translate), where d["apply"]: out[i, j] = img[i - dy, j - dx]."""
    b, h, w = imgs.shape
    my, mx = int(h * max_frac), int(w * max_frac)
    padded = F.pad(imgs, (mx, mx, my, my))
    out = _shift_crop(padded, my - d["dy"], mx - d["dx"], h, w)
    return _gate(d["apply"], out, imgs)


def dual_resized_crop_draws(gen: Optional[torch.Generator], batch: int,
                            h: int, w: int,
                            scale: Tuple[float, float] = (0.08, 1.0),
                            ratio: Tuple[float, float] = (3 / 4, 4 / 3),
                            draws: Optional[dict] = None) -> dict:
    """box (B, 4): one RandomResizedCrop window (ch, y0, cw, x0) per
    image."""
    return _fill(draws, {"box": lambda: torch.stack(_crop_window_box(
        gen, batch, h, w, scale, ratio), 1)})


def dual_resized_crop(imgs: torch.Tensor, size: int, second_size: int,
                      d: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """BEiT's RandomResizedCropAndInterpolationWithTwoPic
    (processing.py:130-254): one window per image resized to `size` and to
    `second_size`, both bilinear with antialias by the weight-matrix map
    (cmx's deviation from the reference's lanczos second view, kept)."""
    return tuple(resized_crop(imgs, box_to_crop(d["box"], n), n, "linear")
                 for n in (size, second_size))


def _padded_shape(h: int, w: int, crop_size: int, padding: int,
                  pad_if_needed: bool) -> Tuple[int, int, int, int]:
    """(height, width, row pad, col pad of the fit step) after
    random_crop_padded's padding."""
    h, w = h + 2 * padding, w + 2 * padding
    ph = pw = 0
    if pad_if_needed and (h < crop_size or w < crop_size):
        ph, pw = max(crop_size - h, 0), max(crop_size - w, 0)
    return h + 2 * ph, w + 2 * pw, ph, pw


def random_crop_padded_draws(gen: Optional[torch.Generator], batch: int,
                             h: int, w: int, crop_size: int,
                             padding: int = 0, pad_if_needed: bool = True,
                             draws: Optional[dict] = None) -> dict:
    """y0, x0 (B,) the crop's integer offsets in the padded image."""
    ph, pw = _padded_shape(h, w, crop_size, padding, pad_if_needed)[:2]
    dev = None if gen is None else gen.device
    return _fill(draws, {
        "y0": lambda: torch.randint(0, max(ph - crop_size, 0) + 1, (batch,),
                                    generator=gen, device=dev),
        "x0": lambda: torch.randint(0, max(pw - crop_size, 0) + 1, (batch,),
                                    generator=gen, device=dev)})


def random_crop_padded(imgs: torch.Tensor, crop_size: int, d: dict,
                       padding: int = 0, pad_if_needed: bool = True,
                       pad_val: float = 0.0) -> torch.Tensor:
    """mmcls RandomCrop (processing.py:257-397): a constant `padding` on
    every side, a constant pad on both sides by the shortfall when the
    image is smaller than the crop, then the crop at (y0, x0)."""
    b, h, w = imgs.shape
    _, _, ph, pw = _padded_shape(h, w, crop_size, padding, pad_if_needed)
    x = imgs
    if padding:
        x = F.pad(x, (padding,) * 4, value=pad_val)
    if ph or pw:
        x = F.pad(x, (pw, pw, ph, ph), value=pad_val)
    return _shift_crop(x, d["y0"], d["x0"], crop_size, crop_size)


def multi_view(imgs: torch.Tensor, pipelines: Sequence[Callable],
               num_views: Sequence[int]) -> list:
    """MultiView (wrappers.py:14-97): pipeline k applied num_views[k] times;
    each call is `fn(i, imgs)` with i the view's index over all views (cmx
    keys view i by fold_in(key, i)). Returns the views in order."""
    views = []
    for fn, n in zip(pipelines, num_views):
        for _ in range(n):
            views.append(fn(len(views), imgs))
    return views
