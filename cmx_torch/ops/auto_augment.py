"""AutoAugment / RandAugment op set and policies (port of
cmx/ops/auto_augment.py), over a (B, H, W) batch.

The reference's mmcls-style library (cmae/datasets/pipelines/
auto_augment.py: Shear, Translate, Rotate, AutoContrast, Invert, Equalize,
Solarize, SolarizeAdd, Posterize, Contrast, ColorTransform, Brightness,
Sharpness, Cutout, the "imagenet" AutoAugment policy and RandAugment). No
training path reaches these; they are library surface, as in cmx.

cmx's conventions, kept: single-channel float images in [0, 1] (uint8
magnitudes map to /255 fractions), fill 0 for the geometric ops, nearest
resampling by one gather per batch, ColorTransform the identity on one
channel.

Random draws come per image and per op slot (`op_draws`): "apply" (the
op's probability), "neg" (the random sign of a magnitude, p 0.5) and "cy",
"cx" (U(0, 1), Cutout's centre). `auto_augment` also draws the sub-policy
("choice"), `rand_augment` each step's op; both group the batch by choice,
where cmx runs a lax.switch per image. Parity tests inject cmx's draws.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

# --------------------------------------------------------------- helpers


def _gate(apply: torch.Tensor, out: torch.Tensor,
          imgs: torch.Tensor) -> torch.Tensor:
    return torch.where(apply[:, None, None], out, imgs)


def _signed(neg: torch.Tensor, mag: float) -> torch.Tensor:
    """-mag where neg, else mag (random_negative_prob 0.5), fp32 (B,)."""
    m = torch.full(neg.shape, mag, dtype=torch.float32, device=neg.device)
    return torch.where(neg, -m, m)


def _affine_nearest(imgs: torch.Tensor, mats: torch.Tensor,
                    pad: float = 0.0) -> torch.Tensor:
    """Inverse warp of image b by its (2, 3) output -> input affine
    mats[b], nearest (half to even), `pad` outside: one gather."""
    b, h, w = imgs.shape
    dev = imgs.device
    yy = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :]
    m = mats.float()[:, :, :, None, None]
    src_y = m[:, 0, 0] * yy + m[:, 0, 1] * xx + m[:, 0, 2]
    src_x = m[:, 1, 0] * yy + m[:, 1, 1] * xx + m[:, 1, 2]
    iy, ix = torch.round(src_y).long(), torch.round(src_x).long()
    inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    base = (torch.arange(b, device=dev) * (h * w))[:, None, None]
    out = torch.take(imgs, base + iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1))
    return torch.where(inside, out, torch.full_like(out, pad))


def _mats(rows: Sequence[Sequence]) -> torch.Tensor:
    """(B, 2, 3) from 2 x 3 entries, each a (B,) tensor or a float."""
    ref = next(v for r in rows for v in r if torch.is_tensor(v))
    return torch.stack([torch.stack([
        v if torch.is_tensor(v) else torch.full_like(ref, v) for v in r], 1)
        for r in rows], 1)


# --------------------------------------------------------------- geometric


def shear(imgs: torch.Tensor, magnitude: float, apply: torch.Tensor,
          neg: torch.Tensor, direction: str = "horizontal",
          pad: float = 0.0) -> torch.Tensor:
    """mmcv.imshear (auto_augment.py:375-440): shear fraction +-magnitude."""
    m = _signed(neg, magnitude)
    rows = ([[1.0, 0.0, 0.0], [m, 1.0, 0.0]] if direction == "horizontal"
            else [[1.0, m, 0.0], [0.0, 1.0, 0.0]])
    return _gate(apply, _affine_nearest(imgs, _mats(rows), pad), imgs)


def translate(imgs: torch.Tensor, magnitude: float, apply: torch.Tensor,
              neg: torch.Tensor, direction: str = "horizontal",
              pad: float = 0.0) -> torch.Tensor:
    """auto_augment.py:453-536: an offset of +-magnitude * size."""
    b, h, w = imgs.shape
    m = _signed(neg, magnitude)
    rows = ([[1.0, 0.0, 0.0], [0.0, 1.0, -m * w]] if direction == "horizontal"
            else [[1.0, 0.0, -m * h], [0.0, 1.0, 0.0]])
    return _gate(apply, _affine_nearest(imgs, _mats(rows), pad), imgs)


def rotate(imgs: torch.Tensor, angle: float, apply: torch.Tensor,
           neg: torch.Tensor, pad: float = 0.0) -> torch.Tensor:
    """auto_augment.py:539-619: rotation about the centre by +-angle
    degrees."""
    b, h, w = imgs.shape
    a = _signed(neg, angle) * (math.pi / 180)  # jnp.deg2rad
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    c, s = torch.cos(a), torch.sin(a)
    mats = _mats([[c, -s, cy - c * cy + s * cx],
                  [s, c, cx - s * cy - c * cx]])
    return _gate(apply, _affine_nearest(imgs, mats, pad), imgs)


def cutout(imgs: torch.Tensor, size: float, apply: torch.Tensor,
           cy: torch.Tensor, cx: torch.Tensor,
           pad: float = 0.0) -> torch.Tensor:
    """auto_augment.py:1081-1133: a square hole of side `size` * H centred
    at (cy * H, cx * W), cy, cx U(0, 1)."""
    b, h, w = imgs.shape
    half = size * h / 2.0
    dev = imgs.device
    yy = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :]
    hole = ((torch.abs(yy - (cy * h)[:, None, None]) < half)
            & (torch.abs(xx - (cx * w)[:, None, None]) < half))
    return _gate(apply, torch.where(hole, torch.full_like(imgs, pad), imgs),
                 imgs)


# --------------------------------------------------------------- intensity


def auto_contrast(imgs: torch.Tensor, apply: torch.Tensor) -> torch.Tensor:
    """mmcv.auto_contrast (auto_augment.py:622-650): min..max -> [0, 1]."""
    lo = imgs.amin(dim=(1, 2), keepdim=True)
    hi = imgs.amax(dim=(1, 2), keepdim=True)
    return _gate(apply, (imgs - lo) / torch.clamp(hi - lo, min=1e-8), imgs)


def invert(imgs: torch.Tensor, apply: torch.Tensor) -> torch.Tensor:
    """mmcv.iminvert (auto_augment.py:653-679): 1 - x."""
    return _gate(apply, 1.0 - imgs, imgs)


def equalize(imgs: torch.Tensor, apply: torch.Tensor,
             n_bins: int = 256) -> torch.Tensor:
    """mmcv.imequalize (auto_augment.py:682-710): histogram equalization
    over n_bins levels of [0, 1], cmx's PIL-style LUT: step = (total - the
    last non-empty bin's count) / (n_bins - 1), lut = clip((cdf before the
    bin + step / 2) / step, 0, n_bins - 1) (not floored, as cmx), the
    identity where step is 0."""
    b = imgs.shape[0]
    dev = imgs.device
    bins = torch.clamp((imgs * (n_bins - 1)).to(torch.int32), 0,
                       n_bins - 1).long()
    flat = bins.reshape(b, -1)
    hist = torch.zeros((b, n_bins), dtype=torch.float32, device=dev)
    hist.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.float32))
    cdf = torch.cumsum(hist, dim=1)
    ar = torch.arange(n_bins, device=dev)
    last = torch.where(hist > 0, ar, torch.zeros_like(ar)).amax(dim=1)
    step = (cdf[:, -1] - hist.gather(1, last[:, None])[:, 0]) / (n_bins - 1)
    prev = torch.cat([torch.zeros((b, 1), device=dev), cdf[:, :-1]], 1)
    lut = torch.clamp((prev + step[:, None] / 2)
                      / torch.clamp(step, min=1e-8)[:, None], 0, n_bins - 1)
    lut = torch.where(step[:, None] > 0, lut, ar.float()[None, :])
    out = lut.gather(1, flat).view_as(imgs) / (n_bins - 1)
    return _gate(apply, out, imgs)


def solarize(imgs: torch.Tensor, thr: float,
             apply: torch.Tensor) -> torch.Tensor:
    """auto_augment.py:712-756: 1 - x at and above thr."""
    return _gate(apply, torch.where(imgs >= thr, 1.0 - imgs, imgs), imgs)


def solarize_add(imgs: torch.Tensor, add: float, apply: torch.Tensor,
                 thr: float = 128.0 / 255.0) -> torch.Tensor:
    """auto_augment.py:758-811: clip(x + add, 0, 1) below thr."""
    return _gate(apply, torch.where(
        imgs < thr, torch.clamp(imgs + add, 0.0, 1.0), imgs), imgs)


def posterize(imgs: torch.Tensor, bits: float,
              apply: torch.Tensor) -> torch.Tensor:
    """auto_augment.py:813-864: keep floor(bits) of 8 intensity bits (at
    least 1); `bits` is taken in fp32 before its floor, as cmx's."""
    fbits = float(torch.tensor(bits, dtype=torch.float32))
    q = 256.0 / max(2.0 ** math.floor(fbits), 2.0)
    return _gate(apply, torch.floor(imgs * 255.0 / q) * q / 255.0, imgs)


def _enhance(imgs: torch.Tensor, degenerate: torch.Tensor,
             factor: torch.Tensor) -> torch.Tensor:
    """PIL ImageEnhance: degenerate + factor * (img - degenerate)."""
    return degenerate + factor[:, None, None] * (imgs - degenerate)


def contrast(imgs: torch.Tensor, magnitude: float, apply: torch.Tensor,
             neg: torch.Tensor) -> torch.Tensor:
    """auto_augment.py:866-917: blend with the mean gray; factor 1 +-
    magnitude."""
    mean = imgs.mean(dim=(1, 2), keepdim=True) * torch.ones_like(imgs)
    out = _enhance(imgs, mean, 1.0 + _signed(neg, magnitude))
    return _gate(apply, out, imgs)


def brightness(imgs: torch.Tensor, magnitude: float, apply: torch.Tensor,
               neg: torch.Tensor) -> torch.Tensor:
    """auto_augment.py:973-1025: blend with black; factor 1 +- magnitude."""
    out = _enhance(imgs, torch.zeros_like(imgs), 1.0 + _signed(neg, magnitude))
    return _gate(apply, out, imgs)


def color_transform(imgs: torch.Tensor) -> torch.Tensor:
    """auto_augment.py:919-971: the saturation blend, the identity on one
    channel (PIL Color blends with the image's own grayscale)."""
    return imgs


# PIL's SMOOTH filter
_SMOOTH3 = ((1.0, 1.0, 1.0), (1.0, 5.0, 1.0), (1.0, 1.0, 1.0))


def sharpness(imgs: torch.Tensor, magnitude: float, apply: torch.Tensor,
              neg: torch.Tensor) -> torch.Tensor:
    """auto_augment.py:1027-1079: blend with the 3x3 SMOOTH-filtered image
    (edge padded; the 1-pixel border left unfiltered, as PIL); factor 1 +-
    magnitude."""
    b, h, w = imgs.shape
    k = torch.tensor(_SMOOTH3, device=imgs.device) / 13.0
    xp = F.pad(imgs[:, None], (1, 1, 1, 1), mode="replicate")
    sm = F.conv2d(xp, k[None, None])[:, 0]
    border = torch.zeros((h, w), dtype=torch.bool, device=imgs.device)
    border[0], border[-1], border[:, 0], border[:, -1] = True, True, True, True
    sm = torch.where(border, imgs, sm)
    out = _enhance(imgs, sm, 1.0 + _signed(neg, magnitude))
    return _gate(apply, out, imgs)


# --------------------------------------------------------------- policies

# DeepVoltaire/AutoAugment ImageNetPolicy: the reference's
# AUTOAUG_POLICIES['imagenet']; each sub-policy is two (op, prob, level)
# steps, level 0-9 mapped to a magnitude by `apply_op`.
IMAGENET_POLICY: List[List[Tuple[str, float, int]]] = [
    [("posterize", 0.4, 8), ("rotate", 0.6, 9)],
    [("solarize", 0.6, 5), ("auto_contrast", 0.6, 5)],
    [("equalize", 0.8, 8), ("equalize", 0.6, 3)],
    [("posterize", 0.6, 7), ("posterize", 0.6, 6)],
    [("equalize", 0.4, 7), ("solarize", 0.2, 4)],
    [("equalize", 0.4, 4), ("rotate", 0.8, 8)],
    [("solarize", 0.6, 3), ("equalize", 0.6, 7)],
    [("posterize", 0.8, 5), ("equalize", 1.0, 2)],
    [("rotate", 0.2, 3), ("solarize", 0.6, 8)],
    [("equalize", 0.6, 8), ("posterize", 0.4, 6)],
    [("rotate", 0.8, 8), ("color", 0.4, 0)],
    [("rotate", 0.4, 9), ("equalize", 0.6, 2)],
    [("equalize", 0.0, 7), ("equalize", 0.8, 8)],
    [("invert", 0.6, 4), ("equalize", 1.0, 8)],
    [("color", 0.6, 4), ("contrast", 1.0, 8)],
    [("rotate", 0.8, 8), ("color", 1.0, 2)],
    [("color", 0.8, 8), ("solarize", 0.8, 7)],
    [("sharpness", 0.4, 7), ("invert", 0.6, 8)],
    [("shear_x", 0.6, 5), ("equalize", 1.0, 9)],
    [("color", 0.4, 0), ("equalize", 0.6, 3)],
    [("equalize", 0.4, 7), ("solarize", 0.2, 4)],
    [("solarize", 0.6, 5), ("auto_contrast", 0.6, 5)],
    [("invert", 0.6, 4), ("equalize", 1.0, 8)],
    [("color", 0.6, 4), ("contrast", 1.0, 8)],
    [("equalize", 0.8, 8), ("equalize", 0.6, 3)],
]

# timm's _RAND_INCREASING_TRANSFORMS op names usable on grayscale
RAND_AUGMENT_OPS = (
    "auto_contrast", "equalize", "invert", "rotate", "posterize",
    "solarize", "solarize_add", "color", "contrast", "brightness",
    "sharpness", "shear_x", "shear_y", "translate_x", "translate_y",
)


def op_draws(gen: Optional[torch.Generator], shape: Tuple[int, ...],
             prob) -> dict:
    """Per-image draws of op slots of `shape` (B, ...): apply (p `prob`, a
    float or a tensor of `shape`), neg (p 0.5), cy and cx U(0, 1)."""
    dev = None if gen is None else gen.device

    def u():
        return torch.rand(shape, generator=gen, device=dev)

    return {"apply": u() < prob, "neg": u() < 0.5, "cy": u(), "cx": u()}


def apply_op(name: str, level: int, imgs: torch.Tensor,
             d: dict) -> torch.Tensor:
    """Op `name` at AutoAugment level 0..9 (cmx's level -> magnitude map)
    with the op slot's draws `d` (apply, neg, cy, cx; each (B,))."""
    m = level / 9.0
    apply, neg = d["apply"], d["neg"]
    if name in ("shear_x", "shear_y"):
        return shear(imgs, 0.3 * m, apply, neg,
                     "horizontal" if name == "shear_x" else "vertical")
    if name in ("translate_x", "translate_y"):
        return translate(imgs, 0.45 * m, apply, neg,
                         "horizontal" if name == "translate_x" else "vertical")
    if name == "rotate":
        return rotate(imgs, 30.0 * m, apply, neg)
    if name == "auto_contrast":
        return auto_contrast(imgs, apply)
    if name == "invert":
        return invert(imgs, apply)
    if name == "equalize":
        return equalize(imgs, apply)
    if name == "solarize":
        return solarize(imgs, 1.0 - m, apply)
    if name == "solarize_add":
        return solarize_add(imgs, (110.0 / 255.0) * m, apply)
    if name == "posterize":
        return posterize(imgs, 8.0 - 4.0 * m, apply)
    if name == "contrast":
        return contrast(imgs, 0.9 * m, apply, neg)
    if name == "color":
        return color_transform(imgs)
    if name == "brightness":
        return brightness(imgs, 0.9 * m, apply, neg)
    if name == "sharpness":
        return sharpness(imgs, 0.9 * m, apply, neg)
    if name == "cutout":
        return cutout(imgs, 0.4 * m, apply, d["cy"], d["cx"])
    raise ValueError(f"unknown autoaugment op {name!r}")


def _by_choice(imgs: torch.Tensor, choice: torch.Tensor, n: int,
               run) -> torch.Tensor:
    """run(c, rows) on the images of each choice c in range(n), written
    back in place of those rows."""
    out = imgs.clone()
    for c in range(n):
        rows = torch.nonzero(choice == c).flatten()
        if rows.numel():
            out[rows] = run(c, rows)
    return out


def auto_augment_draws(gen: Optional[torch.Generator], batch: int,
                       policies=None, draws: Optional[dict] = None) -> dict:
    """choice (B,) the sub-policy of each image, and the op slots' draws
    (apply, neg, cy, cx), each (B, L) for L the longest sub-policy, apply
    at the chosen step's probability."""
    policies = IMAGENET_POLICY if policies is None else policies
    d = dict(draws or {})
    dev = None if gen is None else gen.device
    if "choice" not in d:
        d["choice"] = torch.randint(0, len(policies), (batch,),
                                    generator=gen, device=dev)
    if "apply" not in d:
        n_ops = max(len(sub) for sub in policies)
        probs = torch.tensor([[sub[i][1] if i < len(sub) else 0.0
                               for i in range(n_ops)] for sub in policies],
                             device=d["choice"].device)
        d = {**op_draws(gen, (batch, n_ops), probs[d["choice"]]), **d}
    return d


def auto_augment(imgs: torch.Tensor, policies=None,
                 gen: Optional[torch.Generator] = None,
                 draws: Optional[dict] = None) -> torch.Tensor:
    """AutoAugment (auto_augment.py:41-88): one random sub-policy per image,
    its ops applied in order with op slot i's draws (cmx keys slot i by
    fold_in(ka, i)). The draws of `auto_augment_draws` come from `gen`
    unless given in `draws`."""
    policies = IMAGENET_POLICY if policies is None else policies
    d = auto_augment_draws(gen, imgs.shape[0], policies, draws)

    def run(c, rows):
        x = imgs[rows]
        for i, (name, _, level) in enumerate(policies[c]):
            x = apply_op(name, level, x, {k: d[k][rows, i] for k in
                                          ("apply", "neg", "cy", "cx")})
        return x

    return _by_choice(imgs, d["choice"], len(policies), run)


def rand_augment_draws(gen: Optional[torch.Generator], batch: int,
                       num_policies: int = 2,
                       draws: Optional[dict] = None) -> dict:
    """choice (B, N) each step's op of RAND_AUGMENT_OPS, and the op slots'
    draws (apply at p 1, neg, cy, cx), each (B, N)."""
    d = dict(draws or {})
    dev = None if gen is None else gen.device
    if "choice" not in d:
        d["choice"] = torch.randint(0, len(RAND_AUGMENT_OPS),
                                    (batch, num_policies), generator=gen,
                                    device=dev)
    if "apply" not in d:
        d = {**op_draws(gen, (batch, num_policies), 1.0), **d}
    return d


def rand_augment(imgs: torch.Tensor, num_policies: int = 2,
                 magnitude_level: int = 9, total_level: int = 10,
                 gen: Optional[torch.Generator] = None,
                 draws: Optional[dict] = None) -> torch.Tensor:
    """RandAugment (auto_augment.py:91-260): `num_policies` random ops in
    turn, each at probability 1 and the fixed level round(magnitude_level /
    total_level * 9)."""
    level = int(round(magnitude_level / total_level * 9))
    d = rand_augment_draws(gen, imgs.shape[0], num_policies, draws)
    for i in range(num_policies):
        imgs = _by_choice(imgs, d["choice"][:, i], len(RAND_AUGMENT_OPS),
                          lambda c, rows: apply_op(
                              RAND_AUGMENT_OPS[c], level, imgs[rows],
                              {k: d[k][rows, i] for k in
                               ("apply", "neg", "cy", "cx")}))
    return imgs
