"""The library remainder of cmx_torch against cmx, on the CPU: the extended
ops (augment_extra), AutoAugment / RandAugment (auto_augment), the s2d
layout ops, the profiling hooks and the host data modules (analysis,
preprocessing).

* Each random op of augment_extra and auto_augment over a batch, with the
  draws cmx's per-image keys make (`split(key, B)`, then each op's own
  splits) injected: geometric nearest ops pixel for pixel except a share
  <= 1e-3 (a cos / sin ulp can flip a rounding), the rest rel <= 1e-5 of
  the largest entry (reductions summed in another order; the crops' bound).
  auto_augment and rand_augment with cmx's branch choices injected, at
  32^2 (cmx's switch traces every branch).
* s2d: s2d5 / d2s5 round trip bit for bit and cmx's phase order;
  expand_kernel_phase equal to cmx's; phase_conv5 against cmx (fp32 and
  bf16) and against the fine F.conv2d; phase_max against max_pool2d;
  up_transpose5 against cmx and the port's ConvTranspose.
* StepTimer's summary; trace writes a Chrome trace.
* analysis and preprocessing on seeded arrays: equal to cmx's.
"""

import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmx.ops import augment_extra as cx
from cmx.ops import auto_augment as caa
from cmx_torch.ops import augment_extra as tx
from cmx_torch.ops import auto_augment as taa

B = 8


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1e-12)


def _keys(seed, n=B):
    return jax.random.split(jax.random.key(seed), n)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _uni(k, lo=0.0, hi=1.0):
    return jax.random.uniform(k, minval=lo, maxval=hi)


def _imgs(seed, shape=(B, 24, 20), unit=False):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=shape) if unit else rng.normal(size=shape)
    return x.astype(np.float32)


def _vmap(fn, keys, imgs):
    return np.asarray(jax.jit(jax.vmap(fn))(keys, imgs))


# ------------------------------------------------------------ augment_extra


def test_color_jitter_matches_cmx():
    imgs, keys = _imgs(0), _keys(1)

    def draws(k):
        kp, kb, kc, _ = jax.random.split(k, 4)
        return {"b": _uni(kb, 0.6, 1.4), "c": _uni(kc, 0.6, 1.4),
                "apply": _uni(kp) < 0.5}

    ref = _vmap(lambda k, x: cx.color_jitter(k, x, p=0.5), keys, imgs)
    d = _t(jax.vmap(draws)(keys))
    assert d["apply"].any() and not d["apply"].all()
    got = tx.color_jitter(torch.from_numpy(imgs),
                          tx.color_jitter_draws(None, B, draws=d))
    assert _rel(got.numpy(), ref) <= 1e-5


def test_random_erasing_matches_cmx():
    imgs, keys = _imgs(2), _keys(3)

    def draws(k):
        kp, ka, kr, ky, kx, _ = jax.random.split(k, 6)
        return {"area": _uni(ka, 0.02, 0.33),
                "log_r": _uni(kr, jnp.log(0.3), jnp.log(3.33)),
                "uy": _uni(ky), "ux": _uni(kx), "apply": _uni(kp) < 0.7}

    ref = _vmap(lambda k, x: cx.random_erasing(k, x, p=0.7, fill=-9.0),
                keys, imgs)
    d = _t(jax.vmap(draws)(keys))
    got = tx.random_erasing(torch.from_numpy(imgs), d, fill=-9.0).numpy()
    assert np.array_equal(got, ref) and np.any(got == -9.0)


@pytest.mark.parametrize("op", ["solarize", "posterize", "invert"])
def test_range_ops_match_cmx(op):
    imgs, keys = _imgs(4), _keys(5)
    ref = _vmap(lambda k, x: getattr(cx, op)(k, x, p=0.5), keys, imgs)
    d = tx.apply_draws(None, B, 0.5, {"apply": torch.from_numpy(np.array(
        jax.vmap(lambda k: _uni(k) < 0.5)(keys)))})
    assert d["apply"].any() and not d["apply"].all()
    got = getattr(tx, op)(torch.from_numpy(imgs), d["apply"])
    assert _rel(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("h,w,edge,mode", [(40, 80, 20, "short"),
                                           (40, 80, 20, "long"),
                                           (24, 20, 36, "short"),
                                           (10, 100, 99, "long")])
def test_resize_edge_matches_cmx(h, w, edge, mode):
    imgs = _imgs(6, (3, h, w))
    ref = np.stack([np.asarray(cx.resize_edge(jnp.asarray(im), edge, mode))
                    for im in imgs])
    got = tx.resize_edge(torch.from_numpy(imgs), edge, mode).numpy()
    assert got.shape == ref.shape and _rel(got, ref) <= 1e-5


def test_translate_matches_cmx():
    imgs, keys = _imgs(7), _keys(8)

    def draws(k):
        kp, ky, kx = jax.random.split(k, 3)
        return {"dy": jax.random.randint(ky, (), -12, 13),
                "dx": jax.random.randint(kx, (), -10, 11),
                "apply": _uni(kp) < 0.7}

    ref = _vmap(lambda k, x: cx.translate(k, x, max_frac=0.5, p=0.7), keys,
                imgs)
    d = _t(jax.vmap(draws)(keys))
    assert (d["dy"] < 0).any() and (d["dx"] > 0).any()
    got = tx.translate(torch.from_numpy(imgs), d, max_frac=0.5).numpy()
    assert np.array_equal(got, ref)


def test_dual_resized_crop_matches_cmx():
    from cmx.ops.augment import _crop_window_box

    imgs, keys = _imgs(9), _keys(10)
    r1, r2 = jax.jit(jax.vmap(lambda k, x: cx.dual_resized_crop(
        k, x, 16, 8)))(keys, imgs)
    box = jax.vmap(lambda k: jnp.stack(_crop_window_box(
        k, 24, 20, (0.08, 1.0), (3 / 4, 4 / 3))))(keys)
    d = tx.dual_resized_crop_draws(None, B, 24, 20,
                                   draws=_t({"box": box}))
    g1, g2 = tx.dual_resized_crop(torch.from_numpy(imgs), 16, 8, d)
    assert _rel(g1.numpy(), r1) <= 1e-5 and _rel(g2.numpy(), r2) <= 1e-5


@pytest.mark.parametrize("crop,padding", [(16, 0), (28, 2), (30, 0)])
def test_random_crop_padded_matches_cmx(crop, padding):
    imgs, keys = _imgs(11), _keys(12)
    ref = _vmap(lambda k, x: cx.random_crop_padded(k, x, crop, padding,
                                                   pad_val=-1.0), keys, imgs)
    ph, pw = tx._padded_shape(24, 20, crop, padding, True)[:2]

    def draws(k):
        ky, kx = jax.random.split(k)
        return {"y0": jax.random.randint(ky, (), 0, max(ph - crop, 0) + 1),
                "x0": jax.random.randint(kx, (), 0, max(pw - crop, 0) + 1)}

    d = _t(jax.vmap(draws)(keys))
    got = tx.random_crop_padded(torch.from_numpy(imgs), crop, d, padding,
                                pad_val=-1.0).numpy()
    assert got.shape == ref.shape == (B, crop, crop)
    assert np.array_equal(got, ref)


def test_multi_view_matches_cmx():
    imgs, keys = _imgs(13), _keys(14)
    pipes = [lambda k, x: cx.invert(k, x, p=0.5),
             lambda k, x: cx.solarize(k, x, p=0.5)]
    ref = jax.jit(jax.vmap(lambda k, x: cx.multi_view(k, x, pipes,
                                                      [2, 1])))(keys, imgs)

    def view(op):
        def fn(i, x):
            apply = jax.vmap(lambda k: _uni(jax.random.fold_in(k, i))
                             < 0.5)(keys)
            return getattr(tx, op)(x, torch.from_numpy(np.array(apply)))
        return fn

    got = tx.multi_view(torch.from_numpy(imgs), [view("invert"),
                                                 view("solarize")], [2, 1])
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert _rel(g.numpy(), r) <= 1e-5


# ------------------------------------------------------------- auto_augment

GEOMETRIC = ("shear_x", "shear_y", "translate_x", "translate_y", "rotate")
SPLIT2 = GEOMETRIC + ("contrast", "brightness", "sharpness")


def cmx_op_draws(name, prob, k):
    """The draws cmx's op `name` makes from its key `k` (auto_augment.py:
    _maybe and _rand_sign): apply, neg, cy, cx."""
    zero = jnp.zeros(())
    if name in SPLIT2:
        kp, ks = jax.random.split(k)
        return {"apply": _uni(kp) < prob, "neg": _uni(ks) < 0.5,
                "cy": zero, "cx": zero}
    if name == "cutout":
        kp, ky, kx = jax.random.split(k, 3)
        return {"apply": _uni(kp) < prob, "neg": jnp.zeros((), bool),
                "cy": _uni(ky), "cx": _uni(kx)}
    return {"apply": _uni(k) < prob, "neg": jnp.zeros((), bool),
            "cy": zero, "cx": zero}


def _close(name, got, ref):
    if name in GEOMETRIC:
        return np.mean(got != ref) <= 1e-3
    return _rel(got, ref) <= 1e-5


OPS = GEOMETRIC + ("auto_contrast", "invert", "equalize", "solarize",
                   "solarize_add", "posterize", "contrast", "color",
                   "brightness", "sharpness", "cutout")


@pytest.mark.parametrize("name", OPS)
def test_auto_augment_op_matches_cmx(name):
    """Each op at level 7 (6 for posterize: a non-integer bit count) and
    probability 0.5 on 32^2 images in [0, 1]."""
    level = 6 if name == "posterize" else 7
    imgs, keys = _imgs(15, (B, 32, 32), unit=True), _keys(16)
    ref = _vmap(lambda k, x: caa._apply_op(name, 0.5, level, k, x), keys,
                imgs)
    d = _t(jax.vmap(lambda k: cmx_op_draws(name, 0.5, k))(keys))
    assert d["apply"].any() and not d["apply"].all()
    got = taa.apply_op(name, level, torch.from_numpy(imgs), d).numpy()
    assert _close(name, got, ref), name
    assert not np.array_equal(got, imgs) or name == "color"


def test_equalize_is_cmx_on_a_flat_histogram_and_a_constant():
    """step 0 (one occupied bin): the identity LUT; values outside [0, 1]
    clipped into the end bins."""
    imgs = np.stack([np.full((16, 16), 0.3, np.float32),
                     _imgs(17, (16, 16)) * 2.0])
    keys = _keys(18, 2)
    ref = _vmap(lambda k, x: caa.equalize(k, x, prob=1.0), keys, imgs)
    got = taa.equalize(torch.from_numpy(imgs), torch.ones(2, dtype=bool))
    assert _rel(got.numpy(), ref) <= 1e-6


def test_auto_augment_matches_cmx_with_its_choices():
    imgs, keys = _imgs(19, (16, 32, 32), unit=True), _keys(20, 16)
    ref = _vmap(caa.auto_augment, keys, imgs)
    choice, slots = [], []
    for k in keys:
        kc, ka = jax.random.split(k)
        c = int(jax.random.randint(kc, (), 0, len(caa.IMAGENET_POLICY)))
        choice.append(c)
        slots.append([cmx_op_draws(name, prob, jax.random.fold_in(ka, i))
                      for i, (name, prob, _) in enumerate(
                          caa.IMAGENET_POLICY[c])])
    assert len(set(choice)) >= 8
    d = {"choice": torch.tensor(choice)}
    for f in ("apply", "neg", "cy", "cx"):
        d[f] = torch.from_numpy(np.array([[np.array(s[f]) for s in row]
                                          for row in slots]))
    got = taa.auto_augment(torch.from_numpy(imgs), draws=d).numpy()
    assert np.mean(np.abs(got - ref) > 1e-5) <= 1e-3
    assert taa.IMAGENET_POLICY == [list(s) for s in caa.IMAGENET_POLICY]


def test_rand_augment_matches_cmx_with_its_choices():
    imgs, keys = _imgs(21, (16, 32, 32), unit=True), _keys(22, 16)
    ref = _vmap(caa.rand_augment, keys, imgs)
    d = {f: [] for f in ("choice", "apply", "neg", "cy", "cx")}
    for k in keys:
        row = {f: [] for f in d}
        for i in range(2):
            kc, ka = jax.random.split(jax.random.fold_in(k, i))
            c = int(jax.random.randint(kc, (), 0, len(caa.RAND_AUGMENT_OPS)))
            row["choice"].append(c)
            for f, v in cmx_op_draws(caa.RAND_AUGMENT_OPS[c], 1.0,
                                     ka).items():
                row[f].append(np.array(v))
        for f in d:
            d[f].append(row[f])
    d = {f: torch.from_numpy(np.array(v)) for f, v in d.items()}
    assert len(set(d["choice"].flatten().tolist())) >= 8
    got = taa.rand_augment(torch.from_numpy(imgs), draws=d).numpy()
    assert np.mean(np.abs(got - ref) > 1e-5) <= 1e-3
    assert taa.RAND_AUGMENT_OPS == caa.RAND_AUGMENT_OPS


def test_auto_augment_draws_from_a_generator():
    gen = torch.Generator().manual_seed(0)
    imgs = torch.rand((6, 16, 16), generator=gen)
    for fn in (taa.auto_augment, taa.rand_augment):
        out = fn(imgs, gen=gen)
        assert out.shape == imgs.shape and torch.isfinite(out).all()
    d = taa.auto_augment_draws(gen, 64)
    # sub-policy 12 opens with equalize at p 0: never applied
    assert not d["apply"][d["choice"] == 12, 0].any()


# ---------------------------------------------------------------------- s2d


def _nhwc5(y):
    """The port's (B, 4, C, H/2, W/2) as cmx's (B, H/2, W/2, 4, C)."""
    return np.transpose(np.asarray(y, np.float32), (0, 3, 4, 1, 2))


def test_s2d_round_trip_and_phase_order_match_cmx():
    from cmx.ops import s2d as cs
    from cmx_torch.ops import s2d as ts

    x = _imgs(23, (2, 3, 8, 10))
    y = ts.s2d5(torch.from_numpy(x))
    assert tuple(y.shape) == (2, 4, 3, 4, 5)
    assert torch.equal(ts.d2s5(y), torch.from_numpy(x))
    ref = np.asarray(cs.s2d5(jnp.asarray(np.transpose(x, (0, 2, 3, 1)))))
    assert np.array_equal(_nhwc5(y), ref)
    assert torch.equal(y[:, 3, :, 1, 2], torch.from_numpy(x[:, :, 3, 5]))
    with pytest.raises(ValueError):
        ts.d2s5(torch.zeros((1, 3, 2, 2, 2)))


@pytest.mark.parametrize("cin,cout", [(1, 8), (8, 16)])
def test_phase_conv5_matches_cmx_and_the_fine_conv(cin, cout):
    import torch.nn.functional as F

    from cmx.ops import s2d as cs
    from cmx_torch.ops import s2d as ts

    rng = np.random.default_rng(24)
    x = rng.normal(size=(2, cin, 16, 16)).astype(np.float32)
    w = (rng.normal(size=(cout, cin, 3, 3)) * 0.1).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    whwio = jnp.asarray(np.transpose(w, (2, 3, 1, 0)))
    for di, dj in ts.PHASES:
        assert np.array_equal(
            np.transpose(ts.expand_kernel_phase(torch.from_numpy(w), di,
                                                dj).numpy(), (2, 3, 1, 0)),
            np.asarray(cs.expand_kernel_phase(whwio, di, dj)))
    xt = torch.from_numpy(x)
    jx5 = cs.s2d5(jnp.asarray(np.transpose(x, (0, 2, 3, 1))))
    fine = ts.s2d5(F.conv2d(xt, torch.from_numpy(w), torch.from_numpy(b),
                            padding=1))
    for dtype, jdt, tol in ((torch.float32, jnp.float32, 1e-5),
                            (torch.bfloat16, jnp.bfloat16, 1e-2)):
        got = ts.phase_conv5(ts.s2d5(xt), torch.from_numpy(w),
                             torch.from_numpy(b), dtype)
        assert got.dtype == dtype
        ref = cs.phase_conv5(jx5.astype(jdt), whwio, jnp.asarray(b), jdt)
        assert _rel(_nhwc5(got.float()), np.asarray(ref, np.float32)) <= tol
        assert _rel(got.float().numpy(), fine.numpy()) <= tol


def test_phase_max_is_max_pool():
    import torch.nn.functional as F

    from cmx_torch.ops import s2d as ts

    x = torch.from_numpy(_imgs(25, (2, 5, 16, 16)))
    assert torch.equal(ts.phase_max(ts.s2d5(x)), F.max_pool2d(x, 2, 2))


def test_up_transpose5_matches_cmx_and_conv_transpose():
    from cmx.ops import s2d as cs
    from cmx_torch.models.blocks import ConvTranspose
    from cmx_torch.ops import s2d as ts

    rng = np.random.default_rng(26)
    cin, cout = 12, 6
    x = rng.normal(size=(2, cin, 8, 8)).astype(np.float32)
    mod = ConvTranspose(cin, cout, torch.float32)
    mod.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        mod.bias.copy_(torch.from_numpy(rng.normal(size=(cout,)).astype(
            np.float32)))
    xt = torch.from_numpy(x)
    got = ts.up_transpose5(xt, mod.kernel.detach(), mod.bias.detach(),
                           torch.float32)
    with torch.no_grad():
        assert _rel(ts.d2s5(got).numpy(), mod(xt).numpy()) <= 1e-5
    # cmx's kernel is flax's: the port's spatially flipped, (2, 2, Cin, Cout)
    jk = np.transpose(mod.kernel.detach().numpy()[:, :, ::-1, ::-1],
                      (2, 3, 0, 1))
    ref = cs.up_transpose5(jnp.asarray(np.transpose(x, (0, 2, 3, 1))),
                           jnp.asarray(jk), jnp.asarray(mod.bias.detach()),
                           jnp.float32)
    assert _rel(_nhwc5(got), ref) <= 1e-5


# ---------------------------------------------------------------- profiling


def test_step_timer_summary_and_trace(tmp_path):
    from cmx_torch.utils.profiling import StepTimer, trace

    timer = StepTimer()
    assert timer.summary() == {"mean_s": 0.0, "p50_s": 0.0, "min_s": 0.0}
    timer.times = [5.0, 3.0, 1.0, 2.0]
    assert timer.summary() == {"mean_s": 2.0, "p50_s": 2.0, "min_s": 1.0}
    assert timer.summary(skip_first=9)["min_s"] == 1.0
    with timer.measure({"loss": torch.ones(2), "rest": [torch.zeros(1)]}):
        torch.ones(3).sum()
    assert len(timer.times) == 5 and timer.times[-1] >= 0.0
    with trace(None) as path:
        assert path is None
    with trace(str(tmp_path / "prof"), "t.json") as path:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert path == str(tmp_path / "prof" / "t.json")
    assert any("aten::mm" in e.get("name", "") for e in events)


# ------------------------------------------------------------ host modules


def test_analysis_matches_cmx(tmp_path):
    from cmx.data import analysis as ca
    from cmx_torch.data import analysis as ta

    rng = np.random.default_rng(27)
    keyed = {f"{c:02d}-{i}": rng.normal(loc=c * 0.3, size=(12, 12))
             for c in range(3) for i in range(2 + c)}
    groups = ta.group_by_center(keyed)
    ref_groups = ca.group_by_center(keyed)
    assert list(groups) == list(ref_groups) == ["00", "01", "02"]
    assert all(np.array_equal(a, b) for k in groups
               for a, b in zip(groups[k], ref_groups[k]))
    imgs = list(keyed.values())
    assert np.array_equal(ta.intensity_histogram(imgs, 32),
                          ca.intensity_histogram(imgs, 32))
    assert ta.group_similarity_matrix(groups, 16) == \
        ca.group_similarity_matrix(ref_groups, 16)
    hists = ta.center_mean_histograms(keyed, 64)
    ref = ca.center_mean_histograms(keyed, 64)
    assert all(np.array_equal(hists[k], ref[k]) for k in ref)
    p, q = hists["00"] / hists["00"].sum(), hists["02"] / hists["02"].sum()
    assert ta.bhattacharyya_coefficient(p, q) == \
        ca.bhattacharyya_coefficient(p, q)
    out = tmp_path / "ridge.png"
    ta.ridgeline(hists, overlap=0.5, save_path=str(out))
    assert out.stat().st_size > 0
    with pytest.raises(ValueError):
        ta.ridgeline(hists, overlap=2.0)


def _fame_tree(root, rng):
    """Two patients, three views, raw.tif and labelled masks."""
    for patient in ("01-a", "02-b"):
        for view in ("v1", "v2") if patient == "01-a" else ("v1",):
            d = root / patient / view
            d.mkdir(parents=True)
            img = rng.integers(0, 255, size=(60, 70)).astype(np.uint8)
            img[:6] = 3  # a dark border to inpaint
            cv2.imwrite(str(d / "raw.tif"), img)
            for j in range(2):
                m = np.zeros((60, 70), np.uint8)
                m[10 + 9 * j:25 + 9 * j, 20:40 + 5 * j] = 255
                m[15 + 9 * j, 25] = 0  # a hole the contour fill closes
                cv2.imwrite(str(d / f"labelled_{j}.tif"), m)
    (root / "notes.txt").write_text("not a patient")


def test_preprocessing_matches_cmx(tmp_path):
    from cmx.data import preprocessing as cp
    from cmx_torch.data import preprocessing as tp

    _fame_tree(tmp_path / "fame", np.random.default_rng(28))
    images, masks, keys = tp.load_images(str(tmp_path / "fame"))
    ref = cp.load_images(str(tmp_path / "fame"))
    assert keys == ref[2] == ["01-a_v1", "01-a_v2", "02-b_v1"]
    assert all(np.array_equal(a, b) for a, b in zip(images, ref[0]))
    masks[2] = []  # an unlabelled image for UnlabelledRemover
    ref_masks = list(ref[1])
    ref_masks[2] = []
    cut = tp.default_pipeline(crop_size=48)
    got = cut.transform(images, [m if m else None for m in masks])
    want = cp.default_pipeline(crop_size=48).transform(
        ref[0], [m if m else None for m in ref_masks])
    assert len(got[0]) == len(want[0]) == 2
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert a.shape == b.shape and np.array_equal(a, b)
    for step in (tp.MinMaxNormalizer(), tp.IntensityNormalizer(),
                 tp.Unsharper(radius=5)):
        name = type(step).__name__
        a = step.fit_transform(images, masks)[0]
        b = getattr(cp, name)(**({"radius": 5} if name == "Unsharper"
                                 else {})).transform(ref[0], masks)[0]
        assert all(np.array_equal(x, y) for x, y in zip(a, b)), name
    tp.write_dataset(got[0], got[1], keys[:2], str(tmp_path / "ds"))
    assert sorted(os.listdir(tmp_path / "ds" / "masks")) == \
        ["01-a_v1.npy", "01-a_v2.npy"]
    m = np.load(tmp_path / "ds" / "masks" / "01-a_v1.npy")
    assert m.dtype == np.uint8 and set(np.unique(m)) <= {0, 1}
    with pytest.raises(TypeError):
        tp.PreProcessor()
