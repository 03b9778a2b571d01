"""Model Genesis's distortion chain (port of cmx/ops/genesis.py), written
over the batch.

flip -> local pixel shuffling -> Bezier intensity remap -> in-painting |
out-painting (Transformation_based/utils.py:51-253, cmx's formulation).
Every function takes (B, H, W) fp32 images and the batch's random draws
(`genesis_draws`): raw uniforms and integers, one set per image, drawn from a
torch.Generator on the images' device unless injected, as tests inject the
draws of cmx's key tree. The chain runs as plain PyTorch on the device, with
no Python loop over images and no host synchronisation (per-image scalars
are (B, 1, 1) tensors; a randint whose bounds depend on another draw is
lo + floor(u * (hi - lo)) with tensor bounds).

Two formulations differ from cmx's and compute the same function:
  * cmx's fast shuffle selects among 8 `jnp.roll` copies (gathers were slow
    on the TPU); here each pixel's source index
    ((i - offs[sel, 0]) mod H, (j - offs[sel, 1]) mod W) feeds one gather
    over the batch (the same pixels, bit for bit);
  * per-image rolls (the exact shuffle's) are index gathers too.
The fit remap's 10x10 normal equations are solved by torch.linalg.solve_ex
(no error check, so no host sync); the system is ill-conditioned in fp32,
so its coefficients differ from LAPACK's while the remapped image agrees
within ~1e-5 of the image's span.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

SHUFFLE_K = 8                     # rolled copies of the fast shuffle
EXACT_TILES = (4, 8, 5, 10, 2)    # the exact shuffle's tile size a round
BEZIER_POINTS = 1024
_POLY_DEG = 9
PAINT_BLOCKS = 5
_F32_SPACING_EPS = 2.0 ** -46  # np.spacing(float32 eps), jnp.interp's dx floor


def _shuffle_radius(h: int) -> int:
    return max(h // 50, 2)


def _randint_u(u: torch.Tensor, lo, hi) -> torch.Tensor:
    """jax.random.randint(lo, hi)'s range from uniforms: lo + floor(u *
    (hi - lo)), at most hi - 1; lo and hi may be tensors."""
    span = hi - lo
    return lo + torch.clamp(torch.floor(u * span).long(), max=span - 1)


def _block_bounds(h: int, w: int):
    """In-painting's block-side ranges: [H/6, H/3] (cmx's _block_mask with
    1/6 and 1/3)."""
    return (h * 1 // 6, h * 1 // 3 + 1), (w * 1 // 6, w * 1 // 3 + 1)


def _out_bounds(n: int, device) -> Tuple[torch.Tensor, int]:
    """Out-painting's draw ranges a block: randint(lo_n * n // 7, 4n/7 + 1)
    with lo 2/7 for the first block and 3/7 for the rest (made on the
    device: a copy from the host would synchronise)."""
    first = torch.arange(PAINT_BLOCKS, device=device) == 0
    lo = 3 * n // 7 - first.long() * (3 * n // 7 - 2 * n // 7)
    return lo, 4 * n // 7 + 1


def genesis_draws(gen: Optional[torch.Generator], batch: int, h: int, w: int,
                  draws: Optional[dict] = None,
                  exact_shuffle: bool = False) -> Dict[str, torch.Tensor]:
    """The random draws of the Genesis chain for a batch of (H, W) images,
    from `gen` (on its device), except those given in `draws`. Per image:
      flip_u (B, 3, 2): each round's apply and axis uniforms;
      shuffle_u (B,): the shuffle's gate; shuffle_offs (B, 8, 2) in
        [-r, r], r = max(H // 50, 2); shuffle_sel (B, H, W) in [0, 8);
      with `exact_shuffle`, a round r of EXACT_TILES (tile t):
        shuffle_shift{r} (B, 2) in [0, t) and shuffle_keys{r} (B, ceil(H/t),
        ceil(W/t), t * t) uniforms;
      nonlinear_u (B,): the remap's gate; bezier_u (B, 5): P1, P2 and the
        sort-both coin;
      paint_u, inpaint_u (B,): the painting gates;
      inpaint_cont_u (B, 5); inpaint_sx, inpaint_sy (B, 5) in [H/6, H/3];
        inpaint_x0, inpaint_y0 (B, 5) in [3, max(H - sx - 3, 4));
        inpaint_noise (B, 5, H, W);
      outpaint_cont_u (B, 4) (blocks 1-4); outpaint_rx, outpaint_ry (B, 5)
        in [2H/7 (3H/7 after block 0), 4H/7] (the block side is H - r);
        outpaint_x0, outpaint_y0 (B, 5) in [3, max(H - side - 3, 4));
        outpaint_noise (B, H, W)."""
    d = dict(draws or {})
    dev = None if gen is None else gen.device

    def u(*shape):
        return torch.rand((batch, *shape), generator=gen, device=dev)

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, (batch, *shape), generator=gen,
                             device=dev)

    r = _shuffle_radius(h)
    (sx_lo, sx_hi), (sy_lo, sy_hi) = _block_bounds(h, w)
    fill = {
        "flip_u": lambda: u(3, 2),
        "shuffle_u": u,
        "shuffle_offs": lambda: randint(-r, r + 1, SHUFFLE_K, 2),
        "shuffle_sel": lambda: randint(0, SHUFFLE_K, h, w),
        "nonlinear_u": u,
        "bezier_u": lambda: u(5),
        "paint_u": u,
        "inpaint_u": u,
        "inpaint_cont_u": lambda: u(PAINT_BLOCKS),
        "inpaint_sx": lambda: randint(sx_lo, sx_hi, PAINT_BLOCKS),
        "inpaint_sy": lambda: randint(sy_lo, sy_hi, PAINT_BLOCKS),
        "inpaint_x0": lambda: _randint_u(
            u(PAINT_BLOCKS), 3, torch.clamp(h - d["inpaint_sx"] - 3, min=4)),
        "inpaint_y0": lambda: _randint_u(
            u(PAINT_BLOCKS), 3, torch.clamp(w - d["inpaint_sy"] - 3, min=4)),
        "inpaint_noise": lambda: u(PAINT_BLOCKS, h, w),
        "outpaint_cont_u": lambda: u(PAINT_BLOCKS - 1),
        "outpaint_rx": lambda: _randint_u(u(PAINT_BLOCKS),
                                          *_out_bounds(h, dev)),
        "outpaint_ry": lambda: _randint_u(u(PAINT_BLOCKS),
                                          *_out_bounds(w, dev)),
        "outpaint_x0": lambda: _randint_u(
            u(PAINT_BLOCKS), 3, torch.clamp(d["outpaint_rx"] - 3, min=4)),
        "outpaint_y0": lambda: _randint_u(
            u(PAINT_BLOCKS), 3, torch.clamp(d["outpaint_ry"] - 3, min=4)),
        "outpaint_noise": lambda: u(h, w),
    }
    if exact_shuffle:
        for i, t in enumerate(EXACT_TILES):
            fill[f"shuffle_shift{i}"] = (lambda t=t: randint(0, t, 2))
            fill[f"shuffle_keys{i}"] = (lambda t=t: u(-(-h // t), -(-w // t),
                                                      t * t))
    for name, draw in fill.items():  # in order: x0 reads the drawn sx
        if name not in d:
            d[name] = draw()
    return d


def _col(v: torch.Tensor) -> torch.Tensor:
    """A per-image (B,) value as (B, 1, 1)."""
    return v.reshape(-1, 1, 1)


# ---------------------------------------------------------------- flips


def paired_random_flip(x: torch.Tensor, y: torch.Tensor, d: dict,
                       prob: float = 0.4):
    """Up to 3 joint flips (cmx's three unrolled rounds): round i flips
    where flip_u[:, i, 0] < prob, along H where flip_u[:, i, 1] < 0.5, else
    along W."""
    u = d["flip_u"].to(x.device)
    for i in range(3):
        do, axis0 = _col(u[:, i, 0] < prob), _col(u[:, i, 1] < 0.5)
        fx = torch.where(axis0, x.flip(1), x.flip(2))
        fy = torch.where(axis0, y.flip(1), y.flip(2))
        x = torch.where(do, fx, x)
        y = torch.where(do, fy, y)
    return x, y


# ---------------------------------------------------------------- bezier remap


def _bezier_lut(u: torch.Tensor, vmin: torch.Tensor, vmax: torch.Tensor,
                n: int = BEZIER_POINTS):
    """Per image, the cubic Bezier through ([vmin, vmin], P1, P2, [vmax,
    vmax]) sampled at n points: (xs sorted, ys matched, or sorted too where
    the coin u[:, 4] < 0.5), each (B, n); vmin, vmax (B, 1)."""
    span = vmax - vmin
    p1x, p1y = u[:, 0:1] * span + vmin, u[:, 1:2] * span + vmin
    p2x, p2y = u[:, 2:3] * span + vmin, u[:, 3:4] * span + vmin
    # jnp.linspace(0, 1, n) as XLA computes it: iota * fp32(1 / (n - 1))
    t = (torch.arange(n, dtype=torch.float32, device=u.device)
         * torch.tensor(1 / (n - 1), dtype=torch.float32))[None]
    s = 1 - t
    b0 = s * s * s
    b1 = (3 * t) * (s * s)
    b2 = (3 * (t * t)) * s
    b3 = t * t * t
    xs = b0 * vmin + b1 * p1x + b2 * p2x + b3 * vmax
    ys = b0 * vmin + b1 * p1y + b2 * p2y + b3 * vmax
    order = torch.argsort(xs, dim=1, stable=True)
    xs_sorted = torch.gather(xs, 1, order)
    ys_matched = torch.gather(ys, 1, order)
    sort_both = u[:, 4:5] < 0.5
    ys_final = torch.where(sort_both, torch.sort(ys, dim=1, stable=True).values,
                           ys_matched)
    return xs_sorted, ys_final


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
            ) -> torch.Tensor:
    """jnp.interp per image: x (B, P) against sorted xp, fp (B, n), clamped
    to fp's ends outside xp."""
    n = xp.shape[1]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
    f0, f1 = torch.gather(fp, 1, i - 1), torch.gather(fp, 1, i)
    x0, x1 = torch.gather(xp, 1, i - 1), torch.gather(xp, 1, i)
    df, dx, delta = f1 - f0, x1 - x0, x - x0
    dx0 = torch.abs(dx) <= _F32_SPACING_EPS
    q = delta / torch.where(dx0, torch.ones_like(dx), dx)
    # XLA contracts f0 + q * df into one FMA: q * df is exact in float64,
    # so the float64 sum rounds as the FMA does (up to a double-rounding tie)
    fma = (f0.double() + q.double() * df.double()).float()
    f = torch.where(dx0, f0, fma)
    f = torch.where(x < xp[:, :1], fp[:, :1], f)
    return torch.where(x > xp[:, -1:], fp[:, -1:], f)


def _cheb_basis(t: torch.Tensor):
    cols = [torch.ones_like(t), t]
    for _ in range(_POLY_DEG - 1):
        cols.append(2.0 * t * cols[-1] - cols[-2])
    return cols


def nonlinear_transformation(x: torch.Tensor, d: dict, prob: float = 0.9,
                             exact: bool = False) -> torch.Tensor:
    """The Bezier intensity remap where nonlinear_u < prob. Default: the
    curve's least-squares degree-9 Chebyshev fit (on t = 2u - 1 in [-1, 1],
    ridge 1e-4) evaluated by recurrence, clamped to the curve's y-range;
    `exact`: jnp.interp on the curve."""
    b, h, w = x.shape
    xf = x.reshape(b, h * w)
    vmin = xf.min(dim=1, keepdim=True).values
    vmax = xf.max(dim=1, keepdim=True).values
    xs, ys = _bezier_lut(d["bezier_u"].to(x.device), vmin, vmax)
    apply = _col(d["nonlinear_u"].to(x.device) < prob)
    if exact:
        return torch.where(apply, _interp(xf, xs, ys).reshape(b, h, w), x)
    span = torch.clamp(vmax - vmin, min=1e-8)
    t_fit = 2.0 * (xs - vmin) / span - 1.0
    basis = torch.stack(_cheb_basis(t_fit), dim=2)  # (B, n, D+1)
    bt = basis.transpose(1, 2)
    g = bt @ basis + 1e-4 * torch.eye(_POLY_DEG + 1, device=x.device)
    coef = torch.linalg.solve_ex(g, bt @ ys[:, :, None]).result[:, :, 0]
    c = [_col(coef[:, k]) for k in range(_POLY_DEG + 1)]
    tx = torch.clamp(2.0 * (x - _col(vmin)) / _col(span) - 1.0, -1.0, 1.0)
    prev2, prev1 = torch.ones_like(tx), tx
    acc = c[0] * prev2 + c[1] * prev1
    for k in range(2, _POLY_DEG + 1):
        cur = 2.0 * tx * prev1 - prev2
        acc = acc + c[k] * cur
        prev2, prev1 = prev1, cur
    acc = torch.minimum(torch.maximum(acc, _col(ys.min(dim=1).values)),
                        _col(ys.max(dim=1).values))
    return torch.where(apply, acc, x)


# ---------------------------------------------------------------- local shuffle


def _roll(x: torch.Tensor, s0: torch.Tensor, s1: torch.Tensor
          ) -> torch.Tensor:
    """jnp.roll of each image by its own (s0, s1) (B,) over (H, W): out[i,
    j] = x[(i - s0) mod H, (j - s1) mod W], as two gathers."""
    b, h, w = x.shape
    rows = torch.remainder(
        torch.arange(h, device=x.device)[None] - s0[:, None], h)
    cols = torch.remainder(
        torch.arange(w, device=x.device)[None] - s1[:, None], w)
    x = torch.gather(x, 1, rows[:, :, None].expand(b, h, w))
    return torch.gather(x, 2, cols[:, None, :].expand(b, h, w))


def local_pixel_shuffling(x: torch.Tensor, d: dict, prob: float = 0.5,
                          exact: bool = False) -> torch.Tensor:
    """Local scrambling where shuffle_u < prob. Default: each pixel (i, j)
    takes the pixel of rolled copy sel[i, j], i.e. x[(i - offs[sel, 0]) mod
    H, (j - offs[sel, 1]) mod W], as one gather. `exact`: cmx's five rounds
    of tile permutations (tiles EXACT_TILES, each round rolled by its
    shift, zero-padded to a multiple of the tile, each tile's pixels
    permuted by the argsort of its keys, cropped and rolled back)."""
    b, h, w = x.shape
    apply = _col(d["shuffle_u"].to(x.device) < prob)
    if not exact:
        offs = d["shuffle_offs"].to(x.device).long()
        sel = d["shuffle_sel"].to(x.device).long().reshape(b, h * w)
        o0 = torch.gather(offs[:, :, 0], 1, sel)
        o1 = torch.gather(offs[:, :, 1], 1, sel)
        i = torch.arange(h, device=x.device).repeat_interleave(w)[None]
        j = torch.arange(w, device=x.device).repeat(h)[None]
        src = torch.remainder(i - o0, h) * w + torch.remainder(j - o1, w)
        out = torch.gather(x.reshape(b, h * w), 1, src).reshape(b, h, w)
        return torch.where(apply, out, x)
    out = x
    for r, t in enumerate(EXACT_TILES):
        sh = d[f"shuffle_shift{r}"].to(x.device).long()
        rolled = _roll(out, sh[:, 0], sh[:, 1])
        ph, pw = (t - h % t) % t, (t - w % t) % t
        padded = torch.nn.functional.pad(rolled, (0, pw, 0, ph))
        hh, ww = h + ph, w + pw
        tiles = padded.reshape(b, hh // t, t, ww // t, t).permute(
            0, 1, 3, 2, 4).reshape(b, hh // t, ww // t, t * t)
        order = torch.argsort(d[f"shuffle_keys{r}"].to(x.device), dim=-1,
                              stable=True)
        shuffled = torch.gather(tiles, 3, order)
        back = shuffled.reshape(b, hh // t, ww // t, t, t).permute(
            0, 1, 3, 2, 4).reshape(b, hh, ww)[:, :h, :w]
        out = _roll(back, -sh[:, 0], -sh[:, 1])
    return torch.where(apply, out, x)


# ---------------------------------------------------------------- painting


def _block_mask(h: int, w: int, sx: torch.Tensor, sy: torch.Tensor,
                x0: torch.Tensor, y0: torch.Tensor) -> torch.Tensor:
    """Rectangles rows [x0, x0 + sx) x cols [y0, y0 + sy): integer tensors
    of one shape S -> a bool mask (*S, H, W)."""
    rows = torch.arange(h, device=sx.device)[:, None]
    cols = torch.arange(w, device=sx.device)[None, :]
    x0, sx, y0, sy = (v[..., None, None] for v in (x0, sx, y0, sy))
    return ((rows >= x0) & (rows < x0 + sx) & (cols >= y0)
            & (cols < y0 + sy))


def image_in_painting(x: torch.Tensor, d: dict) -> torch.Tensor:
    """Up to 5 uniform-noise blocks of side in [H/6, H/3]: block i is
    painted iff the first i + 1 continue-draws all hit (< 0.95)."""
    b, h, w = x.shape
    dev = x.device
    cont = torch.cumprod((d["inpaint_cont_u"].to(dev) < 0.95).int(),
                         dim=1).bool()
    m = _block_mask(h, w, *(d[f"inpaint_{k}"].to(dev).long()
                            for k in ("sx", "sy", "x0", "y0")))
    noise = d["inpaint_noise"].to(dev)
    out = x
    for i in range(PAINT_BLOCKS):
        out = torch.where(m[:, i] & _col(cont[:, i]), noise[:, i], out)
    return out


def image_out_painting(x: torch.Tensor, d: dict) -> torch.Tensor:
    """Noise everywhere except 1-5 kept blocks of side H - r: block 0
    always, block i > 0 iff its continue-draw and every earlier one hit."""
    b, h, w = x.shape
    dev = x.device
    hit = d["outpaint_cont_u"].to(dev) < 0.95
    active = torch.cat([torch.ones_like(hit[:, :1]),
                        torch.cumprod(hit.int(), dim=1).bool()], dim=1)
    m = _block_mask(h, w, h - d["outpaint_rx"].to(dev).long(),
                    w - d["outpaint_ry"].to(dev).long(),
                    d["outpaint_x0"].to(dev).long(),
                    d["outpaint_y0"].to(dev).long())
    keep = (m & active[:, :, None, None]).any(dim=1)
    return torch.where(keep, x, d["outpaint_noise"].to(dev))


# ---------------------------------------------------------------- full chain


def genesis_distort(imgs: torch.Tensor, d: dict, *, flip_rate: float = 0.4,
                    local_rate: float = 0.5, nonlinear_rate: float = 0.9,
                    paint_rate: float = 0.9, inpaint_rate: float = 0.2
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(distorted x, target y) of (B, H, W) images with the draws `d`: y is
    the (possibly flipped) original, x the flipped image shuffled,
    remapped, then in-painted where inpaint_u < inpaint_rate or
    out-painted, where paint_u < paint_rate. Default rates from
    Transformation_based/config.py:24-31, as cmx's."""
    x, y = paired_random_flip(imgs, imgs, d, prob=flip_rate)
    x = local_pixel_shuffling(x, d, prob=local_rate)
    x = nonlinear_transformation(x, d, prob=nonlinear_rate)
    dev = x.device
    do_paint = _col(d["paint_u"].to(dev) < paint_rate)
    do_inpaint = _col(d["inpaint_u"].to(dev) < inpaint_rate)
    painted = torch.where(do_inpaint, image_in_painting(x, d),
                          image_out_painting(x, d))
    return torch.where(do_paint, painted, x), y


def genesis_batch(imgs: torch.Tensor, gen: Optional[torch.Generator] = None,
                  draws: Optional[dict] = None, **rates):
    """The Genesis pair of every image of a (B, H, W) batch, the draws of
    `genesis_draws` taken from `gen` unless given in `draws`."""
    b, h, w = imgs.shape
    d = genesis_draws(gen, b, h, w, draws)
    return genesis_distort(imgs.float(), d, **rates)
