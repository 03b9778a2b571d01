"""K4 and the MoCo view pipeline of cmx_torch against cmx, on the CPU.

* `crop_resize_plain` and `crop_resize_pallas`'s CPU path against cmx's
  `crop_resize_pallas` run in interpret mode (as tests/test_pallas_crop.py
  runs it): linear and cubic, a downscaling and an upscaling window, H != W,
  rows outside the image. fp32, relative max error <= 1e-5 of the largest
  entry. Why not tighter: jitted, cmx's weight formula differs from the same
  formula run eagerly by an ulp of the sample position (XLA fuses the
  expression; 1.9e-6 in a weight at 48 taps), which the port reproduces
  bit for bit; at these sizes the crop moves by up to 5e-6 of its largest
  entry.
* K4's banded algorithm replayed in torch (`_band_replay`: the kernel's
  band, `pallas_crop.crop_bands`, the row totals and both passes summed
  in ascending order over it) against cmx's interpret-mode kernel and the
  plain version, rel <= 1e-5, linear and cubic, on PARAMS and on windows
  drawn over s in [0.05, 8] (bands up to the whole image); every non-zero
  tap of `_resize_weight_mat` lies inside the band. The kernel sums in
  FMAs, the replay rounds product and sum apart: the same order, not the
  same bits.
* The view pipeline's stages alone and `moco_view_aug_batch` whole (K4 and
  the plain crop), with the draws of cmx's key tree injected into the port
  (`cmx_view_draws`): blur and noise rel <= 1e-5, the whole view rel <= 1e-5
  (its error is the crop's).
* The nearest rotation: cos and sin may differ by an ulp between XLA and
  torch, which flips round() where a source coordinate lies within ~1e-5 of
  .5; the share of differing pixels is held to <= 1e-3 (measured: 5 of
  4.2 million pixels over 64 random angles at 256^2, 0 at this test's
  seeds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmx.ops import augment as ca
from cmx.ops.pallas_crop import crop_resize_pallas as cmx_crop
from cmx_torch.ops import augment as ta
from cmx_torch.ops import pallas_crop as tpc

TOL = 1e-5


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1e-12)


def _stage_keys(key, batch):
    """cmx's per-image stage keys: split(key, B), then split(k_i, 6)."""
    return jax.vmap(lambda k: jax.random.split(k, 6))(
        jax.random.split(key, batch))


def cmx_view_draws(key, shape, out_size):
    """The draws cmx's moco_view_aug_batch makes from `key` for a (B,H,W)
    batch: split(key, B), then split(k_i, 6) per image; stage s draws from
    ks[:, s] exactly as cmx's stage does (augment.py:686-799, 1013-1052).
    "box" is the window every crop impl derives from (_crop_window_box),
    "crop" its scale_and_translate arguments (_crop_window_params)."""
    b, h, w = shape

    @jax.jit
    def draws(key):
        keys = jax.random.split(key, b)
        ks = jax.vmap(lambda k: jax.random.split(k, 6))(keys)
        pair = jax.vmap(lambda k: jax.random.split(k))
        rot = pair(ks[:, 0])
        blur = pair(ks[:, 2])
        noise = pair(ks[:, 5])
        uni = jax.vmap(jax.random.uniform)
        return {
            "angle": jnp.deg2rad(jax.vmap(lambda k: jax.random.uniform(
                k, minval=-180.0, maxval=180.0))(rot[:, 1])),
            "rot_apply": uni(rot[:, 0]) < 0.5,
            "box": jax.vmap(lambda k: jnp.stack(ca._crop_window_box(
                k, h, w, (0.2, 1.0), (3 / 4, 4 / 3))))(ks[:, 1]),
            "crop": jax.vmap(lambda k: jnp.stack(ca._crop_window_params(
                k, h, w, out_size, (0.2, 1.0), (3 / 4, 4 / 3))))(ks[:, 1]),
            "blur_apply": uni(blur[:, 0]) < 0.5,
            "sigma": jax.vmap(lambda k: jax.random.uniform(
                k, minval=0.1, maxval=2.0))(blur[:, 1]),
            "hflip": uni(ks[:, 3]) < 0.5,
            "vflip": uni(ks[:, 4]) < 0.5,
            "noise_apply": uni(noise[:, 0]) < 0.5,
            "noise": jax.vmap(lambda k: jax.random.normal(
                k, (out_size, out_size), jnp.float32))(noise[:, 1]),
        }

    return {k: torch.from_numpy(np.array(v)) for k, v in draws(key).items()}


# (sy, ty, sx, tx) for a (40, 56) image resampled to 32x32: downscaling,
# upscaling, a window partly outside the image (zeroed rows), mixed.
PARAMS = np.array([[32 / 36, -2.0 * 32 / 36, 32 / 50, -3.5 * 32 / 50],
                   [1.6, -10.0 * 1.6, 2.0, -20.25 * 2.0],
                   [1.6, 5.0, 0.7, 9.0],
                   [0.95, -1.3, 1.25, -30.0]], np.float32)


@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_crop_resize_plain_and_cpu_path_match_pallas(method):
    rng = np.random.default_rng(0)
    imgs = rng.normal(size=(4, 40, 56)).astype(np.float32)
    ref = np.asarray(cmx_crop(jnp.asarray(imgs), jnp.asarray(PARAMS), 32,
                              method=method, interpret=True))
    assert np.all(ref[2, :3] == 0.0)  # rows sampled above the image
    n0 = tpc.crop_resize_pallas.launches
    for fn in (tpc.crop_resize_plain, tpc.crop_resize_pallas):
        got = fn(torch.from_numpy(imgs), torch.from_numpy(PARAMS), 32, method)
        assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
        assert _rel(got.numpy(), ref) <= TOL, (fn.__name__, _rel(got, ref))
    assert tpc.crop_resize_pallas.launches == n0  # the CPU path launches none


def _drawn_params(seed, batch, h, w, out):
    """(sy, ty, sx, tx) with s log-uniform over [0.05, 8] on each axis and
    windows that may reach past the image."""
    rng = np.random.default_rng(seed)
    s = np.exp(rng.uniform(np.log(0.05), np.log(8.0), size=(batch, 2)))
    p = np.empty((batch, 4), np.float32)
    for a, n in ((0, h), (1, w)):
        start = rng.uniform(-0.3 * n, 0.9 * n, size=batch)  # window start
        p[:, 2 * a] = s[:, a]
        p[:, 2 * a + 1] = -start * s[:, a]
    return p


def _band_weights(in_size, out_size, s, t, method):
    """The kernel's taps: (lo (B,out), weights (B,out,K)) with weights[..., k]
    the normalized weight of tap lo + k, zero past the band and for rows the
    kernel zeroes; the row totals summed over the band in ascending order."""
    lo, hi = tpc.crop_bands(in_size, out_size, s, t, method)
    inv = 1.0 / s
    kscale = torch.clamp(inv, min=1.0)[:, None]
    sample_f = ((torch.arange(out_size, dtype=torch.float32) + 0.5)[None, :]
                * inv[:, None] - t[:, None] * inv[:, None] - 0.5)
    n = torch.clamp(hi - lo + 1, min=0)
    taps = []
    for k in range(int(n.max())):
        x = torch.abs(sample_f - (lo + k).float()) / kscale
        w = (torch.clamp(1.0 - x, min=0.0) if method == "linear"
             else ta._keys_cubic_kernel(x))
        taps.append(torch.where(k < n, w, torch.zeros_like(w)))
    total = torch.zeros_like(sample_f)
    for w in taps:  # ascending over the band; the zeros past it are exact
        total = total + w
    valid = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    keep = valid & (total.abs() > 1000.0 * ta._F32_EPS)
    den = torch.where(total != 0, total, torch.ones_like(total))
    w = torch.stack([torch.where(keep, w / den, torch.zeros_like(w))
                     for w in taps], dim=-1)
    return lo, w


def _band_replay(imgs, params, out_size, method):
    """K4's two passes over the bands, each sum in ascending tap order."""
    b, h, w = imgs.shape
    lo_y, wy = _band_weights(h, out_size, params[:, 0], params[:, 1], method)
    lo_x, wx = _band_weights(w, out_size, params[:, 2], params[:, 3], method)
    bi = torch.arange(b)[:, None]
    tmp = torch.zeros((b, out_size, w))
    for k in range(wy.shape[-1]):  # tmp[o, x] += wy[o, k] * img[lo_o + k, x]
        rows = imgs[bi, torch.clamp(lo_y + k, max=h - 1)]  # (B, out, W)
        tmp = tmp + wy[..., k, None] * rows
    out = torch.zeros((b, out_size, out_size))
    for k in range(wx.shape[-1]):  # out[o, ox] += wx[ox, k] * tmp[o, lo + k]
        cols = torch.gather(tmp, 2, torch.clamp(lo_x + k, max=w - 1)[:, None, :]
                            .expand(b, out_size, out_size))
        out = out + wx[:, None, :, k] * cols
    return out


@pytest.mark.parametrize("windows", ["PARAMS", "drawn"])
@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_crop_band_replay_matches_pallas_and_plain(method, windows):
    """The banded algorithm of csrc/crop_resize.cu, replayed on the CPU."""
    rng = np.random.default_rng(5)
    imgs = rng.normal(size=(4 if windows == "PARAMS" else 8, 40, 56))
    imgs = imgs.astype(np.float32)
    params = (PARAMS if windows == "PARAMS"
              else _drawn_params(6, imgs.shape[0], 40, 56, 32))
    it, pt = torch.from_numpy(imgs), torch.from_numpy(params)
    for in_size, s, t in ((40, pt[:, 0], pt[:, 1]), (56, pt[:, 2], pt[:, 3])):
        lo, hi = tpc.crop_bands(in_size, 32, s, t, method)
        bb, i, o = torch.nonzero(ta._resize_weight_mat(in_size, 32, s, t,
                                                       method), as_tuple=True)
        assert bool((lo[bb, o] <= i).all() and (i <= hi[bb, o]).all())
    got = _band_replay(it, pt, 32, method).numpy()
    ref = np.asarray(cmx_crop(jnp.asarray(imgs), jnp.asarray(params), 32,
                              method=method, interpret=True))
    assert _rel(got, ref) <= TOL
    plain = tpc.crop_resize_plain(it, pt, 32, method).numpy()
    assert _rel(got, plain) <= TOL
    if windows == "drawn":  # bands of three of the kernel's 16-tap chunks
        lo, hi = tpc.crop_bands(40, 32, pt[:, 0], pt[:, 1], method)
        assert int((hi - lo + 1).max()) > 32  # and rows it zeroes
        assert np.any(np.all(plain == 0.0, axis=2))


def test_crop_resize_refuses_bad_operands():
    imgs = torch.zeros((2, 8, 8))
    with pytest.raises(ValueError):
        tpc.crop_resize_pallas(imgs, torch.zeros((3, 4)), 4)
    with pytest.raises(ValueError):
        tpc.crop_resize_pallas(imgs, torch.zeros((2, 4)), 4, "lanczos3")


@pytest.mark.parametrize("method,radius", [("linear", 1), ("cubic", 2)])
def test_crop_weights_are_a_band_at_moco_windows(method, radius):
    """K4's bound (roofline.crop_work) counts the non-zero taps: at MoCo's
    windows each weight row has at most ceil(2 * radius * max(1/s, 1)) + 1
    of them, a few of a row's 256."""
    gen = torch.Generator().manual_seed(0)
    p = ta._crop_window_params(gen, 64, 256, 256, 224, ta.MOCO_SCALE,
                               ta.MOCO_RATIO)
    for s, t in ((p[:, 0], p[:, 1]), (p[:, 2], p[:, 3])):
        taps = (ta._resize_weight_mat(256, 224, s, t, method) != 0).sum(1)
        most = torch.ceil(2 * radius * torch.clamp(1 / s, min=1.0)) + 1
        assert bool((taps <= most[:, None]).all())
        assert int(taps.max()) <= (4 if method == "linear" else 6)


def test_batch_rotate_nearest_matches_cmx():
    rng = np.random.default_rng(1)
    imgs = rng.normal(size=(6, 48, 40)).astype(np.float32)
    key = jax.random.key(3)
    ks = _stage_keys(key, imgs.shape[0])
    ref = np.asarray(jax.jit(lambda k, x: ca.batch_rotate_nearest(
        k, x, 180.0, p=0.5))(ks[:, 0], imgs))
    d = cmx_view_draws(key, imgs.shape, 32)
    assert d["rot_apply"].any() and not d["rot_apply"].all()
    got = ta.batch_rotate_nearest(torch.from_numpy(imgs), d["angle"],
                                  d["rot_apply"]).numpy()
    assert np.mean(got != ref) <= 1e-3


def test_gaussian_blur_matches_cmx():
    rng = np.random.default_rng(2)
    imgs = rng.normal(size=(6, 24, 20)).astype(np.float32)
    key = jax.random.key(4)
    ks = _stage_keys(key, imgs.shape[0])
    ref = np.asarray(jax.jit(jax.vmap(lambda k, x: ca.gaussian_blur(
        k, x, sigma_range=(0.1, 2.0), radius=3, p=0.5)))(ks[:, 2], imgs))
    d = cmx_view_draws(key, imgs.shape, 20)
    assert d["blur_apply"].any() and not d["blur_apply"].all()
    got = ta.gaussian_blur(torch.from_numpy(imgs), d["sigma"],
                           d["blur_apply"], 3).numpy()
    assert _rel(got, ref) <= TOL


def test_gaussian_noise_max10_matches_cmx():
    rng = np.random.default_rng(3)
    imgs = rng.normal(size=(6, 16, 16)).astype(np.float32)
    key = jax.random.key(5)
    ks = _stage_keys(key, imgs.shape[0])
    ref = np.asarray(jax.jit(jax.vmap(lambda k, x: ca.gaussian_noise_max10(
        k, x, p=0.5)))(ks[:, 5], imgs))
    d = cmx_view_draws(key, imgs.shape, 16)
    assert d["noise_apply"].any() and not d["noise_apply"].all()
    got = ta.gaussian_noise_max10(torch.from_numpy(imgs), d["noise"],
                                  d["noise_apply"]).numpy()
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("crop_impl", ["pallas", "scale_translate"])
def test_moco_view_aug_batch_matches_cmx(crop_impl):
    rng = np.random.default_rng(4)
    imgs = rng.normal(size=(6, 48, 48)).astype(np.float32) + 1.0
    key = jax.random.key(6)
    ref = np.asarray(jax.jit(lambda k, x: ca.moco_view_aug_batch(
        k, x, 32, "nearest", "linear", crop_impl))(key, imgs))
    d = cmx_view_draws(key, imgs.shape, 32)
    got = ta.moco_view_aug_batch(torch.from_numpy(imgs), 32, "nearest",
                                 "linear", crop_impl, draws=d)
    assert tuple(got.shape) == ref.shape == (6, 32, 32)
    assert _rel(got.numpy(), ref) <= TOL


@pytest.mark.parametrize("kwargs", [dict(rotation_method="shear3"),
                                    dict(rotation_method="bilinear"),
                                    dict(crop_impl="bank"),
                                    dict(crop_impl="bank_fused")])
def test_moco_view_options_not_ported_raise(kwargs):
    """The options this test once found refused (each raised, naming its
    ROADMAP item) are ported: each view against cmx's with cmx's draws, rel
    <= 1e-5 (tests/test_torch_port_views.py holds every pair)."""
    rng = np.random.default_rng(8)
    imgs = rng.normal(size=(6, 48, 48)).astype(np.float32) + 1.0
    key = jax.random.key(9)
    opts = {"rotation_method": "nearest", "crop_impl": "scale_translate",
            **kwargs}
    ref = np.asarray(jax.jit(lambda k, x: ca.moco_view_aug_batch(
        k, x, 32, opts["rotation_method"], "linear", opts["crop_impl"]))(
            key, imgs))
    got = ta.moco_view_aug_batch(torch.from_numpy(imgs), 32,
                                 crop_method="linear",
                                 draws=cmx_view_draws(key, imgs.shape, 32),
                                 **opts)
    assert tuple(got.shape) == ref.shape == (6, 32, 32)
    assert _rel(got.numpy(), ref) <= TOL
