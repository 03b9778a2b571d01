"""MoCo's and CM-UNet's view-pipeline options in cmx_torch against cmx, on
the CPU, with the draws of cmx's key tree injected (`cmx_view_draws`,
`cmx_cmunet_draws`: the window "box" of _crop_window_box and the "crop"
derived from it).

* moco_view_aug_batch for every task.rotation_method in {nearest, shear3,
  bilinear} x task.crop_impl in {scale_translate, pallas, einsum,
  einsum_bf16, bank, bank_fused}, 6 images 32^2 -> 24^2: fp32 impls rel
  <= 1e-5 of the largest entry (the crop tests' bound); einsum_bf16 rel
  <= 2e-2 (the bf16 margin of the MoCo step tests). bilinear runs cmx's
  per-sample fallback, where bank_fused is the bank crop and the
  per-stage tail; the port's fused tail is held against it.
* The rotations alone: nearest and shear3 pixel for pixel except a share
  <= 1e-3 (XLA's and torch's tan / sin / cos may differ by an ulp and flip
  a rounding; 0 at these seeds), bilinear rel <= 1e-5; a method cmx does
  not name is its nearest gather.
* The bank: the numpy bank equals cmx's, and the rows the port fetches by
  index equal cmx's one-hot matmuls bit for bit, for windows at both image
  edges (row indices below 0 and past the window); crop_ch_range for an
  asymmetric ratio; bank equals bank_fused with blur, flips and noise off;
  shear3 refuses a non-square image; the bank impls refuse draws without
  a "box".
* CM-UNet's bank views against cmx's batch path (bank and bank_fused).
* The MoCo step at fp32 with moco_fast's options (shear3, bank_fused)
  against cmx's make_train_step, and `--task moco_fast --preset` on the
  CPU for one epoch at small widths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmx.ops import augment as ca
from cmx_torch.ops import augment as ta
from test_torch_port_cmunet import cmx_cmunet_draws
from test_torch_port_crop import _stage_keys, cmx_view_draws

ROTATIONS = ("nearest", "shear3", "bilinear")
CROP_IMPLS = ("scale_translate", "pallas", "einsum", "einsum_bf16", "bank",
              "bank_fused")
TOL = {"einsum_bf16": 2e-2}  # every other impl: 1e-5
SHAPE, OUT = (6, 32, 32), 24


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1e-12)


def _imgs(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1.0).astype(np.float32)


@pytest.fixture(scope="module")
def views_in():
    imgs = _imgs(4)
    key = jax.random.key(6)
    d = cmx_view_draws(key, imgs.shape, OUT)
    for name in ("rot_apply", "blur_apply", "hflip", "vflip", "noise_apply"):
        assert d[name].any() and not d[name].all(), name
    return imgs, key, d


@pytest.mark.parametrize("crop_impl", CROP_IMPLS)
@pytest.mark.parametrize("rotation", ROTATIONS)
def test_moco_view_aug_batch_matches_cmx_every_option(views_in, rotation,
                                                      crop_impl):
    imgs, key, d = views_in
    ref = np.asarray(jax.jit(lambda k, x: ca.moco_view_aug_batch(
        k, x, OUT, rotation, "linear", crop_impl))(key, imgs))
    got = ta.moco_view_aug_batch(torch.from_numpy(imgs), OUT, rotation,
                                 "linear", crop_impl, draws=d)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == ref.shape == (SHAPE[0], OUT, OUT)
    assert _rel(got.numpy(), ref) <= TOL.get(crop_impl, 1e-5)
    if crop_impl == "einsum_bf16":  # bf16's rounding, not fp32's map
        fp32 = ta.moco_view_aug_batch(torch.from_numpy(imgs), OUT, rotation,
                                      "linear", "einsum", draws=d)
        assert _rel(got.numpy(), ref) < 0.1 * _rel(fp32.numpy(), ref)


@pytest.mark.parametrize("method", ["nearest", "shear3", "bilinear",
                                    "spline"])
def test_rotation_matches_cmx(method):
    """Every quarter of the circle: 64 angles over (-180, 180]."""
    imgs = _imgs(1, (64, 20, 20))
    key = jax.random.key(3)
    ks = _stage_keys(key, imgs.shape[0])
    ref = np.asarray(jax.jit(jax.vmap(lambda k, x: ca.random_rotation(
        k, x, 180.0, p=0.5, method=method)))(ks[:, 0], imgs))
    d = cmx_view_draws(key, imgs.shape, 20)
    quarter = torch.round(d["angle"] / (np.pi / 2)).long() % 4
    assert set(quarter[d["rot_apply"]].tolist()) == {0, 1, 2, 3}
    got = ta.rotate_batch(torch.from_numpy(imgs), d["angle"], d["rot_apply"],
                          method).numpy()
    if method == "bilinear":
        assert _rel(got, ref) <= 1e-5
    else:
        assert np.mean(got != ref) <= 1e-3
    if method == "spline":  # a name cmx does not know: its nearest gather
        assert np.array_equal(got, ta.batch_rotate_nearest(
            torch.from_numpy(imgs), d["angle"], d["rot_apply"]).numpy())


@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_bank_rows_are_cmx_bit_for_bit(method):
    """Windows at offset 0, at the far edge and in between, on both axes of
    a 40x56 image: every fetched row equals cmx's, including the zero rows
    where i - off + _BANK_PAD < 0."""
    h, w, out = 40, 56, 24
    rng = np.random.default_rng(7)
    for in_size, other, axis in ((h, w, "h"), (w, h, "w")):
        lo, hi = ca.crop_ch_range(in_size, (0.2, 1.0), (3 / 4, 4 / 3), other,
                                  axis=axis)
        assert ta.crop_ch_range(in_size, (0.2, 1.0), (3 / 4, 4 / 3), other,
                                axis=axis) == (lo, hi)
        assert np.array_equal(ta._crop_weight_bank(in_size, out, method, lo,
                                                   hi),
                              ca._crop_weight_bank(in_size, out, method, lo,
                                                   hi))
        ch = np.concatenate([[lo, hi, lo], rng.integers(lo, hi + 1, 9)])
        off = np.concatenate([[0, in_size - hi, in_size - lo],
                              [rng.integers(0, in_size - c + 1)
                               for c in ch[3:]]])
        assert off.max() > ta._BANK_PAD  # rows that index below the bank
        ref = np.asarray(ca._bank_axis_weights(
            in_size, out, method, jnp.asarray(ch, jnp.int32),
            jnp.asarray(off, jnp.int32), lo, hi))
        got = ta.bank_axis_weights(in_size, out, method, torch.from_numpy(ch),
                                   torch.from_numpy(off), lo, hi).numpy()
        assert got.dtype == np.float32 and np.array_equal(got, ref)
        assert np.all(got[np.argmax(off), 0] == 0.0)


def test_crop_ch_range_asymmetric_ratio():
    """Under ratio (1/2, 3) on a 40x60 image the axes take different ranges,
    as cmx computes them."""
    for args in ((40, (0.08, 1.0), (0.5, 3.0), 60), (60, (0.2, 0.9),
                                                       (0.5, 3.0), 40)):
        got = {a: ta.crop_ch_range(*args, axis=a) for a in ("h", "w")}
        assert got == {a: ca.crop_ch_range(*args, axis=a) for a in ("h", "w")}
        assert got["h"] != got["w"]
    with pytest.raises(ValueError):
        ta.crop_ch_range(40, (0.2, 1.0), (0.5, 2.0), axis="z")


def test_bank_equals_bank_fused_without_blur_flips_noise(views_in):
    imgs, _, d = views_in
    off = dict(d)
    for name in ("blur_apply", "hflip", "vflip", "noise_apply"):
        off[name] = torch.zeros_like(d[name])
    t = torch.from_numpy(imgs)
    views = [ta.moco_view_aug_batch(t, OUT, "nearest", "linear", impl,
                                    draws=off) for impl in ("bank",
                                                            "bank_fused")]
    assert _rel(views[1].numpy(), views[0].numpy()) <= 1e-6
    # with the blur and flips on, the two impls still agree (cmx's claim:
    # the same linear map up to fp32 round-off)
    on = [ta.moco_view_aug_batch(t, OUT, "nearest", "linear", impl, draws=d)
          for impl in ("bank", "bank_fused")]
    assert _rel(on[1].numpy(), on[0].numpy()) <= 1e-5


def test_shear3_refuses_a_non_square_image():
    with pytest.raises(ValueError, match="square"):
        ta.moco_view_aug_batch(torch.zeros((2, 32, 40)), 16, "shear3",
                               gen=torch.Generator())


@pytest.mark.parametrize("crop_impl", ["bank", "bank_fused"])
def test_bank_impls_refuse_draws_without_a_box(views_in, crop_impl):
    imgs, _, d = views_in
    crop_only = {k: v for k, v in d.items() if k != "box"}
    with pytest.raises(ValueError, match="box"):
        ta.moco_view_aug_batch(torch.from_numpy(imgs), OUT, "nearest",
                               "linear", crop_impl, draws=crop_only)
    # the continuous impls take such draws, and no box is drawn for them
    filled = ta.moco_view_draws(None, *SHAPE, OUT, crop_only)
    assert "box" not in filled and filled["crop"] is crop_only["crop"]
    with pytest.raises(ValueError, match="box"):
        ta.cmunet_two_views_batch(torch.from_numpy(_imgs(0, (2, 64, 64))),
                                  32, 31, crop_impl,
                                  draws={"crop": torch.ones((2, 4))},
                                  gen=torch.Generator())


@pytest.mark.parametrize("crop_impl", ["bank", "bank_fused"])
def test_cmunet_bank_views_match_cmx(crop_impl):
    """8 images 64^2, views 32^2, the bank crop (cubic, to 256^2) of cmx's
    batch path."""
    imgs = _imgs(1, (8, 64, 64))
    key = jax.random.key(11)
    r1, r2 = jax.jit(lambda k, x: ca.cmunet_two_views_batch(
        k, x, 32, 31, crop_impl))(key, imgs)
    d = cmx_cmunet_draws(key, imgs.shape, 32)
    v1, v2 = ta.cmunet_two_views_batch(torch.from_numpy(imgs), 32, 31,
                                       crop_impl, draws=d)
    assert _rel(v1.numpy(), r1) <= 1e-5 and _rel(v2.numpy(), r2) <= 1e-5
    chain, _ = ta.cmunet_two_views_batch(torch.from_numpy(imgs), 32, 31,
                                         None, draws=d)
    assert not torch.equal(chain, v1)  # the integer windows: another crop


def test_moco_fast_step_fp32_matches_cmx():
    """moco_fast's view options (shear3, bank_fused) in the fp32 step of
    test_torch_port_moco: loss rel <= 1e-4, acc1/acc5 equal, grad norm rel
    <= 1e-3, parameters, key encoder and queue after the step as there."""
    from test_torch_port_moco import (B, _kind, _leaf, _setup,
                                      _to_flax_layout, cmx_step_draws)

    imgs, _, jstate, jstep, _, tstate, tstep = _setup(
        torch.float32, "bank_fused", "shear3")
    draws = cmx_step_draws(jstate.rng, 0, imgs.shape)
    jstate, jmet = jstep(jstate, jnp.asarray(imgs))
    tmet = tstep(tstate, torch.from_numpy(imgs), draws)
    assert abs(float(tmet["loss"]) - float(jmet["loss"])) \
        <= 1e-4 * abs(float(jmet["loss"]))
    for k in ("acc1", "acc5", "nonfinite"):
        assert float(tmet[k]) == float(jmet[k]), k
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-3)
    close = dict(atol=1e-6, rtol=1e-4)
    for name, p in tstate.model.named_parameters():
        got = _to_flax_layout(p.detach().numpy(), _kind(tstate.model, name))
        np.testing.assert_allclose(got, np.asarray(_leaf(jstate.params, name)),
                                   err_msg=name, **close)
    np.testing.assert_allclose(tstate.extra["queue"].numpy(),
                               np.asarray(jstate.extra["queue"]), **close)
    assert int(tstate.extra["queue_ptr"]) == int(jstate.extra["queue_ptr"]) == B


def test_cli_moco_fast_preset_trains_one_epoch(tmp_path, monkeypatch):
    """`--task moco_fast --preset` on the CPU at small widths: the preset's
    options reach the task, the epoch's losses are finite and the encoder
    is exported."""
    import functools
    import json

    import cmx_torch.models.unet as unet
    import cmx_torch.ssl.moco as moco
    from cmx_torch.cli.pretrain import main

    monkeypatch.setattr(unet, "UNetEncoderGAP", functools.partial(
        unet.UNetEncoderGAP, widths=(8, 16, 32, 64), bottleneck=128))
    seen = []
    views = moco.moco_view_aug_batch
    monkeypatch.setattr(moco, "moco_view_aug_batch", lambda *a: (
        seen.append(a[2:5]), views(*a))[1])
    out = main(["--device", "cpu", "--task", "moco_fast", "--preset",
                "data.synthetic=True", "data.image_size=32",
                "train.batch_size=4", "model.dtype=float32",
                "data.synthetic_n=40", "task.num_negatives=16",
                "task.view_size=24", "train.epochs=1", "train.patience=5",
                f"data.data_dir={tmp_path / 'data'}",
                f"train.ckpt_dir={tmp_path / 'ckpt'}"])
    assert set(seen) == {("shear3", "linear", "bank_fused")}
    with open(f"{out['ckpt_dir']}/log.jsonl") as f:
        log = [json.loads(line) for line in f]
    assert [r["epoch"] for r in log] == [0]
    assert np.isfinite(log[0]["loss"]) and np.isfinite(log[0]["val_loss"])
    assert out["state"].step > 0
    assert out["encoder"] == f"{out['ckpt_dir']}/encoder.npz"
