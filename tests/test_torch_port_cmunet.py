"""The CM-UNet and MAE slice against cmx on the CPU.

* random_patch_mask with cmx's uniforms injected (ratios 0.5 / 0.65 / 0.75,
  per-sample and shared): equal; patchify / unpatchify: equal.
* The CM-UNet views (cmunet_two_views_batch) with draws derived from cmx's
  key tree: 1e-5 relative, as the crop tests hold the cubic crop.
* NonLinearNeck: output and running stats after a train-mode forward.
* CMUNetOnline at full width, view 32, batch 4, fp32 (as cmx's
  test_cmunet_task runs it): forward and encode_project (the target's
  NHWC flatten order) within 1e-4 relative; two steps through
  make_train_step against cmx's (AdamW, warm-up cosine lr, clip 5, cmx's
  masks injected): losses within 1e-4 relative, parameters, target
  parameters and target BN stats within stated bounds, reduce_kernel
  unchanged; a non-finite step keeps everything; a bf16 step's losses.
* MAE: fp32 at full width against cmx, and the bf16 fused flat UNet at
  reduced widths (K1/K2's plain versions against cmx's Pallas kernels in
  interpret mode, FUSED_MIN_HW patched to 32 in both packages).
* The pretrain CLI with --task cmunet --preset on the CPU: runs, a run cut
  after its epoch-1 checkpoint resumes bit for bit, validation keeps every
  BN stat (the target's too), encoder.npz crosses both ways;
  --task mae_tuned --preset resolves to mae as in cmx.
"""

import copy
import functools
import json
import os
import re
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from cmx_torch.ckpt.checkpoint import (_kind, _to_flax_layout,
                                       cmunet_extra_from_flax,
                                       cmunet_extra_to_flax, from_flax,
                                       to_flax)

B, SIZE, VIEW = 4, 64, 32
LR = 1e-3
# Leaves whose true gradient is 0, each a bias that a BN absorbs: conv
# biases feeding a BN, the necks' fc0 biases (bn0 follows), the feature
# decoder's head bias (the channel mean adds it to every input of the
# projector's fc0) and the projector's fc1 bias (a constant shift of the
# predictor's input). Adam turns their rounding noise into +-lr moves.
ABSORBED = re.compile(r"(double_conv|bottleneck)\.conv[01]\.bias$"
                      r"|fc0\.bias$|feature_decoder\.head\.bias$"
                      r"|projector\.fc1\.bias$")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's torch work (the tier-1 run
    shares the cores among its workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _leaf(tree, dotted):
    for k in dotted.split("."):
        tree = tree[k]
    return tree


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1e-12)


# ---------------------------------------------------------------- masks, views


@pytest.mark.parametrize("ratio", [0.5, 0.65, 0.75])
@pytest.mark.parametrize("shared", [False, True])
def test_random_patch_mask_matches_cmx(ratio, shared):
    from cmx.ops.masking import random_patch_mask as jmask
    from cmx_torch.ops.masking import random_patch_mask

    key = jax.random.key(int(ratio * 100) + shared)
    ref = np.asarray(jmask(key, 5, 64, 16, ratio, shared))
    u = np.array(jax.random.uniform(key, (1 if shared else 5, 16)))
    got = random_patch_mask(None, 5, 64, 16, ratio, shared,
                            u=torch.from_numpy(u))
    assert got.dtype == torch.float32 and tuple(got.shape) == (5, 64, 64)
    assert np.array_equal(got.numpy(), ref)
    drawn = random_patch_mask(torch.Generator().manual_seed(0), 5, 64, 16,
                              ratio, shared)
    k = int(ratio * 64 * 64) // 256
    assert (drawn[:, ::16, ::16] == 0).sum((1, 2)).tolist() == [k] * 5


def test_patchify_unpatchify_match_cmx():
    from cmx.ops.masking import patchify as jp, unpatchify as ju
    from cmx_torch.ops.masking import patchify, unpatchify

    x = np.random.default_rng(0).normal(size=(2, 32, 48, 3)).astype(np.float32)
    p = patchify(torch.from_numpy(x), 16)
    assert np.array_equal(p.numpy(), np.asarray(jp(x, 16)))
    assert np.array_equal(unpatchify(p, 16, 32, 48, 3).numpy(), x)
    x1 = x[..., 0]
    assert np.array_equal(patchify(torch.from_numpy(x1), 16).numpy(),
                          np.asarray(jp(x1, 16)))


def cmx_cmunet_draws(key, shape, out_size, shift=31):
    """The draws cmx's cmunet_two_views_batch makes from `key` for a
    (B,H,W) batch: split(key, B), then split(k_i, 5) per image; stage s
    draws from ks[:, s] as cmx's stage does (augment.py:722-762,
    1057-1069)."""
    b, h, w = shape
    from cmx.ops import augment as ca

    @jax.jit
    def draws(key):
        ks = jax.vmap(lambda k: jax.random.split(k, 5))(
            jax.random.split(key, b))
        uni = jax.vmap(jax.random.uniform)

        def offset(k):
            ky, kx = jax.random.split(k)
            return jnp.stack([jax.random.randint(ky, (), 0, shift + 1),
                              jax.random.randint(kx, (), 0, shift + 1)])

        noise = jax.vmap(jax.random.split)(ks[:, 4])
        return {
            "box": jax.vmap(lambda k: jnp.stack(ca._crop_window_box(
                k, h, w, (0.2, 1.0), (3 / 4, 4 / 3))))(ks[:, 0]),
            "crop": jax.vmap(lambda k: jnp.stack(ca._crop_window_params(
                k, h, w, 256, (0.2, 1.0), (3 / 4, 4 / 3))))(ks[:, 0]),
            "flip": uni(ks[:, 1]) < 0.5,
            "shift": jax.vmap(offset)(ks[:, 3]),
            "noise_apply": uni(noise[:, 0]) < 0.5,
            "noise": jax.vmap(lambda k: jax.random.normal(
                k, (out_size, out_size), jnp.float32))(noise[:, 1]),
        }

    return {k: torch.from_numpy(np.array(v)) for k, v in draws(key).items()}


def test_cmunet_two_views_batch_matches_cmx():
    """8 images, 64^2, views 32^2 (the shift clipped at the base's edge
    where 16 + dy > 224): both views within 1e-5 relative of cmx's; the key
    covers both flips, both noise branches and a clipped offset. Every
    crop_impl of cmx's chain gives the same views; "bank" and "bank_fused"
    (the bank crop of the draw "box") match cmx's bank views within 1e-5.
    cmunet_two_views on one image with that image's draws gives the batch's
    views of it."""
    from cmx.ops.augment import cmunet_two_views_batch as jviews
    from cmx_torch.ops.augment import cmunet_two_views, cmunet_two_views_batch

    imgs = (np.random.default_rng(1).normal(size=(8, SIZE, SIZE))
            + 1.0).astype(np.float32)
    key = jax.random.key(11)
    r1, r2 = jviews(key, jnp.asarray(imgs), VIEW, 31)
    d = cmx_cmunet_draws(key, imgs.shape, VIEW)
    assert d["flip"].any() and not d["flip"].all()
    assert d["noise_apply"].any() and not d["noise_apply"].all()
    assert (d["shift"] > 16).any()
    t = torch.from_numpy(imgs)
    v1, v2 = cmunet_two_views_batch(t, VIEW, 31, None, draws=d)
    assert _rel(v1.numpy(), r1) <= 1e-5 and _rel(v2.numpy(), r2) <= 1e-5
    one = cmunet_two_views(t[3], VIEW, 31,
                           draws={k: v[3:4] for k, v in d.items()})
    assert torch.equal(one[0], v1[3]) and torch.equal(one[1], v2[3])
    for impl in ("scale_translate", "einsum", "einsum_bf16", "pallas"):
        w1, w2 = cmunet_two_views_batch(t, VIEW, 31, impl, draws=d)
        assert torch.equal(w1, v1) and torch.equal(w2, v2), impl
    for impl in ("bank", "bank_fused"):
        b1, b2 = jviews(key, jnp.asarray(imgs), VIEW, 31, impl)
        w1, w2 = cmunet_two_views_batch(t, VIEW, 31, impl, draws=d)
        assert _rel(w1.numpy(), b1) <= 1e-5 and _rel(w2.numpy(), b2) <= 1e-5


def test_shift_pixel_crop_matches_cmx():
    from cmx.ops.augment import shift_pixel_crop as jcrop
    from cmx_torch.ops.augment import shift_pixel_crop

    img = np.random.default_rng(2).normal(size=(40, 40)).astype(np.float32)
    for seed in range(6):
        key = jax.random.key(seed)
        ky, kx = jax.random.split(key)
        shift = torch.tensor([[int(jax.random.randint(ky, (), 0, 9)),
                               int(jax.random.randint(kx, (), 0, 9))]])
        got = shift_pixel_crop(torch.from_numpy(img)[None], 24, shift)[0]
        assert np.array_equal(got.numpy(), np.asarray(jcrop(key, img, 24, 8)))
    assert np.array_equal(shift_pixel_crop(torch.from_numpy(img)[None],
                                           24)[0].numpy(),
                          np.asarray(jcrop(key, img, 24, 0)))


# ---------------------------------------------------------------- the neck


def test_nonlinear_neck_matches_cmx():
    """NonLinearNeck(96 -> 64 -> 16) in train mode on a batch of 6: output
    within 1e-5 relative; the running mean and (biased) variance after the
    forward within 1e-6; eval mode uses them, as cmx's."""
    from cmx.models.necks import NonLinearNeck as JNeck
    from cmx_torch.models.necks import NonLinearNeck

    x = (np.random.default_rng(3).normal(size=(6, 96)) * 2 + 0.5).astype(
        np.float32)
    jm = JNeck(hid_channels=64, out_channels=16)
    v = _np_tree(jm.init(jax.random.key(0), x))
    v["batch_stats"]["bn0"]["mean"] += 0.3  # a non-trivial running state
    ref, mut = jm.apply(v, x, mutable=["batch_stats"])
    tm = from_flax(NonLinearNeck(96, 64, 16), v).train()
    got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and _rel(got.detach().numpy(), ref) <= 1e-5
    for name in ("bn0.mean", "bn0.var"):
        np.testing.assert_allclose(dict(tm.named_buffers())[name].numpy(),
                                   _leaf(mut["batch_stats"], name), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    ev = JNeck(hid_channels=64, out_channels=16, use_running_average=True)
    ref_e = ev.apply({"params": v["params"], **mut}, x)
    assert _rel(tm.eval()(torch.from_numpy(x)).detach().numpy(), ref_e) <= 1e-5
    assert to_flax(tm)["params"]["fc0"]["kernel"].shape == (96, 64)


# ---------------------------------------------------------------- CM-UNet


def _cmx_active(rng, step, b, ratio=0.65):
    from cmx.ops.masking import random_patch_mask as jmask

    _, km = jax.random.split(jax.random.fold_in(rng, step))
    return np.asarray(jmask(km, b, VIEW, 16, ratio))


@functools.lru_cache(maxsize=None)
def _cmx_setup(dtype_name):
    """cmx's model, task state and jitted step (compiled once per dtype for
    the module), the port's counterparts from the same weights and extra,
    and the images."""
    from cmx.ssl.cmunet import (CMUNetOnline as JOnline,
                                init_cmunet_extra as jextra,
                                make_cmunet_task as jtask)
    from cmx.train.optim import make_optimizer as jopt
    from cmx.train.schedules import warmup_cosine as jwc
    from cmx.train.state import TrainState as JState
    from cmx.train.trainer import make_train_step as jstepf

    jdt = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    imgs = np.random.default_rng(4).normal(size=(B, SIZE, SIZE)).astype(
        np.float32)
    jm = JOnline(dtype=jdt)
    v = _np_tree(jax.jit(jm.init)(jax.random.key(0), imgs[:1, :VIEW, :VIEW],
                                  jnp.ones((1, VIEW, VIEW))))
    extra = _np_tree(jextra(jax.random.key(1), v["params"], v["batch_stats"]))
    jt, _ = jtask(jm, view_size=VIEW, patch_size=16, augment=False)
    jtx = jopt("adamw", jwc(LR, 10, 2), 0.05, clip_norm=5.0,
               params_example=v["params"])
    jstate = JState.create(params=v["params"], batch_stats=v["batch_stats"],
                           tx=jtx, extra=jax.tree.map(jnp.asarray, extra),
                           rng=jax.random.key(7))
    return imgs, v, extra, jstate, jstepf(jt, jtx, donate=False)


def _port_state(v, extra, dtype):
    from cmx_torch.ssl.cmunet import CMUNetOnline, make_cmunet_task
    from cmx_torch.train.optim import make_optimizer
    from cmx_torch.train.schedules import warmup_cosine
    from cmx_torch.train.state import TrainState
    from cmx_torch.train.trainer import make_train_step

    tm = from_flax(CMUNetOnline(dtype, VIEW), v)
    task, _ = make_cmunet_task(tm, view_size=VIEW, patch_size=16,
                               augment=False)
    tx = make_optimizer("adamw", warmup_cosine(LR, 10, 2), 0.05,
                        clip_norm=5.0, named_params=tm.named_parameters())
    textra = cmunet_extra_from_flax(CMUNetOnline(dtype, VIEW), extra)
    state = TrainState.create(model=tm, tx=tx, extra=textra)
    return task, state, make_train_step(task, tx)


@functools.lru_cache(maxsize=None)
def _two_cmx_steps():
    imgs, v, extra, jstate, jstep = _cmx_setup("float32")
    states, metrics = [jstate], []
    for _ in range(2):
        s, m = jstep(states[-1], jnp.asarray(imgs))
        states.append(s)
        metrics.append({k: float(x) for k, x in m.items()})
    return states, metrics


def test_cmunet_forward_and_encode_project_match_cmx():
    """CMUNetOnline at full width, view 32, batch 4, fp32, train mode:
    pred_pixel, pred and proj of the online forward (a mask with 2 of 4
    patches hidden), and encode_project with the reduce kernel (the
    target's NHWC flatten: a plain NCHW reshape feeds the projector a
    permuted vector), within 1e-4 relative of cmx's; the BN running stats
    both update within 1e-5."""
    from cmx.ssl.cmunet import CMUNetOnline as JOnline
    from cmx_torch.ssl.cmunet import CMUNetOnline

    imgs, v, extra, _, _ = _cmx_setup("float32")
    x = imgs[:, :VIEW, :VIEW]
    active = _cmx_active(jax.random.key(2), 0, B)
    jm = JOnline(dtype=jnp.float32)
    (pp, pred, proj), mut = jax.jit(lambda v, x, a: jm.apply(
        v, x, a, mutable=["batch_stats"]))(v, x, active)
    pt, tmut = jax.jit(lambda v, x, k: jm.apply(
        v, x, k, method=JOnline.encode_project, mutable=["batch_stats"]))(
        v, x, extra["reduce_kernel"])
    tm = from_flax(CMUNetOnline(torch.float32, VIEW), v).train()
    target = copy.deepcopy(tm)
    gp, gpred, gproj = tm(torch.from_numpy(x), torch.from_numpy(active))
    assert gp.shape == (B, 2, VIEW, VIEW) and gpred.shape == (B, 256)
    assert _rel(gp.detach().numpy().transpose(0, 2, 3, 1), pp) <= 1e-4
    assert _rel(gpred.detach().numpy(), pred) <= 1e-4
    assert _rel(gproj.detach().numpy(), proj) <= 1e-4
    with torch.no_grad():
        got = target.encode_project(torch.from_numpy(x),
                                    torch.from_numpy(extra["reduce_kernel"]))
    assert _rel(got.numpy(), pt) <= 1e-4
    for model, ref in ((tm, mut), (target, tmut)):
        for name, b in model.named_buffers():
            np.testing.assert_allclose(
                b.numpy(), _leaf(ref["batch_stats"], name), rtol=1e-5,
                atol=1e-5, err_msg=name)


def test_cmunet_two_steps_match_cmx():
    """Two steps of make_train_step against cmx's (fp32, AdamW on the
    preset's warm-up schedule: lr 0 at step 1, LR / 2 at step 2; wd 0.05,
    clip 5, cmx's masks injected). Losses, loss_ct, loss_rc within 1e-4
    relative, grad norm 1e-3 (step 2's forward runs on parameters step 1
    left equal in both packages). After step 2, each parameter's movement
    against cmx's: Adam's first real update is close to sign(g) entry by
    entry, so an entry whose gradient is at rounding level moves by +-lr in
    either direction; each leaf's error is held in L2 within 5e-2 of its
    movement's L2 (measured: at most 0.023, the bottleneck and down1/down2
    leaves, where a few entries in a thousand flip). The ABSORBED leaves
    (true gradient 0: every entry is rounding noise) are held within 2 LR,
    and named. The target parameters (the EMA of both steps) the same way
    at (1 - m) the scale; every target BN stat within 1e-5 relative (they
    come from step 2's target forward); reduce_kernel bit for bit."""
    imgs, v, extra, jstate0, _ = _cmx_setup("float32")
    states, ref = _two_cmx_steps()
    task, state, step = _port_state(v, extra, torch.float32)
    timgs = torch.from_numpy(imgs)
    for i in range(2):
        m = step(state, timgs, {"active": torch.from_numpy(
            _cmx_active(jstate0.rng, i, B))})
        for k in ("loss", "loss_ct", "loss_rc"):
            assert abs(float(m[k]) - ref[i][k]) <= 1e-4 * abs(ref[i][k]), (
                i, k, float(m[k]), ref[i][k])
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   ref[i]["grad_norm"], rtol=1e-3)
        assert float(m["nonfinite"]) == 0.0
    end = states[-1]
    absorbed = []
    trees = (("params", state.model, jstate0.params, end.params, 1.0),
             ("target", state.extra["target_model"],
              jstate0.extra["target_params"], end.extra["target_params"],
              1.0 - 0.996))
    for what, model, start, final, scale in trees:
        for name, p in model.named_parameters():
            got = _to_flax_layout(p.detach().numpy(), _kind(model, name))
            p0 = np.asarray(_leaf(start, name))
            moved = np.asarray(_leaf(final, name)) - p0
            err = got - p0 - moved
            if ABSORBED.search(name):
                absorbed.append(name)
                assert np.max(np.abs(err)) <= 2 * LR * scale, (what, name)
            else:
                assert np.linalg.norm(err) <= 5e-2 * np.linalg.norm(moved), (
                    what, name, np.linalg.norm(err) / np.linalg.norm(moved))
    assert len(absorbed) == 2 * 30
    for name, b in state.extra["target_model"].named_buffers():
        np.testing.assert_allclose(
            b.numpy(), _leaf(end.extra["target_batch_stats"], name),
            rtol=1e-5, atol=1e-6, err_msg=name)
    ref_extra = cmunet_extra_to_flax(state.extra)
    assert np.array_equal(ref_extra["reduce_kernel"], extra["reduce_kernel"])
    assert state.step == int(end.step) == 2 and int(state.opt.count) == 2


def _snapshot(state):
    x = state.extra
    return ([t.clone() for t in state.model.state_dict().values()]
            + [t.clone() for t in state.opt.mu + state.opt.nu]
            + [state.opt.count.clone()]
            + [t.clone() for t in x["target_model"].state_dict().values()]
            + [x["reduce_kernel"].clone()])


def test_cmunet_nonfinite_step_keeps_params_adamw_state_and_extra():
    _, v, extra, _, _ = _cmx_setup("float32")
    task, state, step = _port_state(v, extra, torch.float32)
    imgs = torch.from_numpy(np.random.default_rng(5).normal(
        size=(B, SIZE, SIZE)).astype(np.float32))
    assert float(step(state, imgs)["nonfinite"]) == 0.0
    before = _snapshot(state)
    bad = imgs.clone()
    bad[0, 3, 3] = float("nan")
    m = step(state, bad)
    assert float(m["nonfinite"]) == 1.0 and not np.isfinite(float(m["loss"]))
    assert all(torch.equal(a, b) for a, b in zip(_snapshot(state), before))
    assert state.step == 2
    assert float(step(state, imgs)["nonfinite"]) == 0.0
    assert int(state.opt.count) == 2


def test_cmunet_bf16_step_matches_cmx():
    """One bf16 step of the port (encoder and decoders in bf16, the necks in
    fp32, as cmx's) against cmx's bf16 loss on the same weights and mask:
    loss_ct within 2e-2 relative and loss_rc within 5e-2 (bf16 rounds at
    other places in the two frameworks; measured on the CPU: 4e-4 and
    1.3e-2), all finite."""
    from cmx.ssl.cmunet import CMUNetOnline as JOnline, make_cmunet_task

    imgs, v, extra, jstate, _ = _cmx_setup("float32")
    jt, _ = make_cmunet_task(JOnline(dtype=jnp.bfloat16), view_size=VIEW,
                             patch_size=16, augment=False)
    rng = jax.random.fold_in(jstate.rng, 0)
    _, aux = jax.jit(jt.loss_fn)(jstate.params, jstate, jnp.asarray(imgs), rng)
    task, state, step = _port_state(v, extra, torch.bfloat16)
    m = step(state, torch.from_numpy(imgs),
             {"active": torch.from_numpy(_cmx_active(jstate.rng, 0, B))})
    assert float(m["nonfinite"]) == 0.0
    for k, tol in (("loss_ct", 2e-2), ("loss_rc", 5e-2)):
        ref = float(aux.metrics[k])
        assert abs(float(m[k]) - ref) <= tol * abs(ref), (k, float(m[k]), ref)


# ---------------------------------------------------------------- MAE


def test_mae_fp32_matches_cmx():
    """make_mae_task on the full-width UNet(out_classes=1), 32^2, batch 2,
    fp32, cmx's mask injected, the full-image and the masked-only losses:
    the loss within 1e-4 relative, the BN running stats within 1e-5. Each
    gradient leaf's error in L2, against its own L2: within 5e-2 of cmx's
    and within 1e-4 of the port's own float64 gradients. cmx's fp32
    gradients on the CPU stray from that float64 reference by up to 8.2e-3
    (full image) and 2.5e-2 (masked only) in the encoder and up4, where the
    port's stay within 3.3e-6; with jax_enable_x64 cmx's float64 gradients
    equal the port's float64 ones within 4e-7, so the spread is cmx's fp32
    rounding, and cmx alone cannot hold the port tighter. The BN-absorbed
    conv biases (true gradient 0) within 1e-4 of the tree's largest
    gradient entry in both packages."""
    from cmx.models.unet import UNet as JUNet
    from cmx.ops.masking import random_patch_mask as jmask
    from cmx.ssl.reconstruction import make_mae_task as jtask
    from cmx_torch.models.unet import UNet
    from cmx_torch.ssl.reconstruction import make_mae_task

    imgs = np.random.default_rng(6).normal(size=(2, 32, 32)).astype(np.float32)
    jm = JUNet(out_classes=1, dtype=jnp.float32)
    v = _np_tree(jax.jit(jm.init)(jax.random.key(0), imgs[:1]))
    state = type("S", (), {"batch_stats": v["batch_stats"]})
    key = jax.random.key(3)
    active = torch.from_numpy(np.asarray(jmask(key, 2, 32, 16, 0.5)))
    for masked_only in (False, True):
        jt, _ = jtask(jm, masked_loss_only=masked_only)
        (jl, jaux), jg = jax.jit(jax.value_and_grad(
            lambda p: jt.loss_fn(p, state, jnp.asarray(imgs), key),
            has_aux=True))(v["params"])
        grads = {}
        for dt in (torch.float32, torch.float64):
            tm = from_flax(UNet(out_classes=1, dtype=dt), v).to(dt).train()
            task, _ = make_mae_task(tm, masked_loss_only=masked_only)
            loss, aux = task.loss_fn(tm, torch.from_numpy(imgs).to(dt), None,
                                     {"active": active.to(dt)})
            grads[dt] = torch.autograd.grad(loss, list(tm.parameters()))
            if dt == torch.float32:
                assert abs(float(loss) - float(jl)) <= 1e-4 * abs(float(jl))
                assert float(aux.metrics["mse"]) == float(loss)
                for name, b in tm.named_buffers():
                    np.testing.assert_allclose(
                        b.numpy(), _leaf(jaux.batch_stats, name), rtol=1e-5,
                        atol=1e-5, err_msg=name)
        scale = max(float(jnp.max(jnp.abs(g))) for g in jax.tree.leaves(jg))
        for (name, _), g, g64 in zip(tm.named_parameters(),
                                     grads[torch.float32],
                                     grads[torch.float64]):
            got = _to_flax_layout(g.numpy(), _kind(tm, name))
            ref = np.asarray(_leaf(jg, name))
            if ABSORBED.search(name):
                assert max(np.max(np.abs(got)), np.max(np.abs(ref))) \
                    <= 1e-4 * scale, name
                continue
            exact = _to_flax_layout(g64.numpy(), _kind(tm, name))
            assert np.linalg.norm(got - ref) <= 5e-2 * np.linalg.norm(ref), \
                name
            assert np.linalg.norm(got - exact) \
                <= 1e-4 * np.linalg.norm(exact), name


WIDTHS = (8, 16, 32, 64)
BNECK = 128


class SmallUNet(fnn.Module):
    """cmx's UNet at reduced widths, one output class, `fused` passed to
    both halves as cmx's UNet does."""

    dtype: Any = jnp.bfloat16
    fused: bool = True

    @fnn.compact
    def __call__(self, x):
        from cmx.models.unet import UNetDecoder, UNetEncoder

        h, skips = UNetEncoder(widths=WIDTHS, bottleneck=BNECK,
                               dtype=self.dtype, fused=self.fused,
                               name="encoder")(x)
        return UNetDecoder(out_classes=1, widths=WIDTHS, dtype=self.dtype,
                           fused=self.fused, name="decoder")(h, skips)


def test_mae_bf16_fused_flat_matches_cmx(monkeypatch):
    """The MAE loss on the fused bf16 UNet (FUSED_IMPL "flat": K1/K2's
    plain versions here, cmx's Pallas kernels in interpret mode), reduced
    widths, 64^2, FUSED_MIN_HW patched to 32 in both packages (down1, down2,
    up2 and up1 fused: K1 8 and K2 8 calls), batch 2, cmx's mask injected:
    the loss within 2e-2 relative and the BN running stats within 5e-2,
    phase 3's bf16 margins in chip_smoke.py."""
    from cmx.ops import fused_conv as cfc
    from cmx.ssl.reconstruction import make_mae_task as jtask
    from cmx.ops.masking import random_patch_mask as jmask
    from cmx_torch.models.unet import UNet
    from cmx_torch.ops import _build
    from cmx_torch.ops import fused_conv as tfc
    from cmx_torch.ssl.reconstruction import make_mae_task

    monkeypatch.setattr(cfc, "FUSED_MIN_HW", 32)
    monkeypatch.setattr(tfc, "FUSED_MIN_HW", 32)
    monkeypatch.setattr(_build, "recorded", [])
    imgs = np.random.default_rng(7).normal(size=(2, 64, 64)).astype(np.float32)
    jm = SmallUNet()
    v = _np_tree(jax.jit(jm.init)(jax.random.key(1), imgs[:1]))
    key = jax.random.key(4)
    state = type("S", (), {"batch_stats": v["batch_stats"]})
    jt, _ = jtask(jm)
    jl, jaux = jax.jit(lambda p: jt.loss_fn(p, state, jnp.asarray(imgs),
                                            key))(v["params"])
    tm = UNet(out_classes=1, widths=WIDTHS, bottleneck=BNECK,
              dtype=torch.bfloat16, fused=True)
    tm = from_flax(tm, v).train()
    task, _ = make_mae_task(tm)
    loss, _ = task.loss_fn(tm, torch.from_numpy(imgs), None, {
        "active": torch.from_numpy(np.asarray(jmask(key, 2, 64, 16, 0.5)))})
    loss.backward()
    names = [n for n, _ in _build.recorded]
    assert names.count("flat_conv3x3_mask_stats") == 8
    assert names.count("flat_bwd_mega") == 8
    assert abs(float(loss) - float(jl)) <= 2e-2 * abs(float(jl))
    for name, b in tm.named_buffers():
        ref = np.asarray(_leaf(jaux.batch_stats, name))
        assert float(np.max(np.abs(b.numpy() - ref))) <= 5e-2, name


# ---------------------------------------------------------------- the CLI


CLI_BASE = ["data.synthetic=True", "data.image_size=64", "data.synthetic_n=16",
            "train.batch_size=4", "model.dtype=float32", f"task.view_size={VIEW}",
            "optim.warmup_epochs=1", "train.patience=5",
            "train.val_fraction=0.25", "train.save_every_epoch=True"]


def _run(tmp_path, name, args):
    from cmx_torch.cli.pretrain import main

    return main(["--device", "cpu", "--task", "cmunet", "--preset"]
                + CLI_BASE + [f"data.data_dir={tmp_path / 'data'}",
                              f"train.ckpt_dir={tmp_path / name}"] + args)


def _log(ckpt_dir):
    with open(os.path.join(ckpt_dir, "log.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """--task cmunet --preset on the CPU (AdamW, warm-up 1 epoch, clip 5,
    EMA 0.996, view 32, validation on): a 3-epoch run, and the same run cut
    after its epoch-1 checkpoint and started again."""
    from cmx_torch.ckpt import checkpoint as tck

    tmp = tmp_path_factory.mktemp("cmunet_cli")
    whole = _run(tmp, "whole", ["train.epochs=3"])
    spe = whole["steps_per_epoch"]
    save = tck.CheckpointManager.save

    def save_then_stop(mgr, step, *a, **kw):
        save(mgr, step, *a, **kw)
        if step == 2 * spe:
            raise KeyboardInterrupt

    tck.CheckpointManager.save = save_then_stop
    try:
        with pytest.raises(KeyboardInterrupt):
            _run(tmp, "cut", ["train.epochs=3"])
    finally:
        tck.CheckpointManager.save = save
    return whole, _run(tmp, "cut", ["train.epochs=3"])


def test_cli_cmunet_preset_resumes_bit_for_bit(cli_runs):
    """The run cut after its epoch-1 checkpoint resumes at epoch 2 and ends
    bit for bit where the uninterrupted one does: the model, AdamW's state,
    the target (parameters and BN stats) and the reduce kernel; every
    epoch's loss_ct, loss_rc and val_loss are finite."""
    whole, resumed = cli_runs
    assert whole["state"].opt.__class__.__name__ == "AdamW"
    assert whole["val_batches"] >= 1 and whole["steps_per_epoch"] >= 1
    log = _log(resumed["ckpt_dir"])
    assert [r["epoch"] for r in log] == [0, 1, 2]
    assert all(np.isfinite(r[k]) for r in log
               for k in ("loss_ct", "loss_rc", "val_loss"))
    a, b = resumed["state"], whole["state"]
    assert a.step == b.step == 3 * whole["steps_per_epoch"]
    for x, y in ((a.model, b.model),
                 (a.extra["target_model"], b.extra["target_model"])):
        for (n, s), t in zip(x.state_dict().items(), y.state_dict().values()):
            assert torch.equal(s, t), n
    for key, xs in a.opt.state_dict().items():
        ys = b.opt.state_dict()[key]
        for s, t in zip(xs if isinstance(xs, list) else [xs],
                        ys if isinstance(ys, list) else [ys]):
            assert torch.equal(s, t), key
    assert torch.equal(a.extra["reduce_kernel"], b.extra["reduce_kernel"])
    # the EMA moved the target away from the online model
    assert any(not torch.equal(p, q) for p, q in zip(
        a.extra["target_model"].parameters(), a.model.parameters()))


def test_cmunet_validation_keeps_every_bn_stat():
    """replay_val_loss on a CM-UNet state: the train-mode loss (the same
    draws give the same loss) with every BN running stat put back, the
    target's included; the same loss_fn called directly does move them."""
    from cmx_torch.cli.pretrain import build_task, replay_val_loss
    from cmx_torch.config.config import Config, apply_overrides
    from cmx_torch.train.optim import make_optimizer
    from cmx_torch.train.state import TrainState

    cfg = apply_overrides(Config(), ["task.name=cmunet",
                                     f"task.view_size={VIEW}"])
    task, model = build_task(cfg, torch.float32, device="cpu")
    extra = task.init_extra(torch.Generator().manual_seed(1))
    state = TrainState.create(model=model, tx=make_optimizer(
        "adamw", 1e-3, named_params=model.named_parameters()), extra=extra)
    model.eval()  # the function sets train mode itself
    imgs = torch.from_numpy(np.random.default_rng(8).normal(
        size=(B, SIZE, SIZE)).astype(np.float32))

    def buffers():
        return [b.clone() for b in list(model.buffers())
                + list(extra["target_model"].buffers())]

    before = buffers()
    loss = replay_val_loss(task, state, imgs, torch.Generator().manual_seed(0))
    assert np.isfinite(float(loss))
    assert all(torch.equal(x, y) for x, y in zip(buffers(), before))
    model.train()
    with torch.no_grad():
        ref, _ = task.loss_fn(model, imgs, torch.Generator().manual_seed(0),
                              None, extra)
    assert float(loss) == float(ref)
    moved = [not torch.equal(x, y) for x, y in zip(buffers(), before)]
    n_online = len(list(model.buffers()))
    assert any(moved[:n_online]) and any(moved[n_online:])


def test_cli_cmunet_encoder_npz_crosses_both_ways(cli_runs, tmp_path):
    """The CLI's encoder.npz (the online encoder's subtree) holds the run's
    encoder leaf for leaf and loads into the port's UNet; cmx's CM-UNet
    encoder export loads into the port's CMUNetOnline, leaf for leaf."""
    from cmx.ckpt.checkpoint import export_encoder as jexport
    from cmx.train.state import TrainState as JState
    from cmx_torch.ckpt.checkpoint import load_encoder
    from cmx_torch.models.unet import UNet
    from cmx_torch.ssl.cmunet import CMUNetOnline
    import optax

    out = cli_runs[1]
    enc = to_flax(out["state"].model)
    with np.load(out["encoder"]) as f:
        files = dict(f)
    assert files and all(k.split("/")[0] in ("params", "batch_stats")
                         for k in files)
    for k, a in files.items():
        top, *path = k.split("/")
        assert np.array_equal(functools.reduce(
            lambda t, p: t[p], path, enc[top]["encoder"]), a), k
    port_unet = load_encoder(out["encoder"], UNet(dtype=torch.float32))
    assert all(torch.equal(p, q) for p, q in zip(
        port_unet.encoder.state_dict().values(),
        out["state"].model.encoder.state_dict().values()))

    v = _cmx_setup("float32")[1]
    path = str(tmp_path / "cmx_encoder.npz")
    jexport(JState.create(params=v["params"], batch_stats=v["batch_stats"],
                          tx=optax.sgd(0.1)), path)
    back = to_flax(load_encoder(path, CMUNetOnline(torch.float32,
                                                   VIEW)).encoder)
    for top in ("params", "batch_stats"):
        for (p, r), g in zip(jax.tree_util.tree_leaves_with_path(
                v[top]["encoder"]), jax.tree.leaves(back[top])):
            assert np.array_equal(g, r), (top, p)


@pytest.mark.parametrize("name", ["cmunet", "mae", "mae_tuned"])
def test_preset_builds_the_task_as_cmx(name):
    """PRESETS[name] equal to cmx's field for field; build_task turns the
    config into the task cmx's build_task makes (mae_tuned resolves to the
    mae task at ratio 0.75), with AdamW (cmunet) or SGD (mae) from
    make_optimizer, and the CM-UNet EMA at task.ema_momentum."""
    import dataclasses

    from cmx.config.config import Config as JConfig, to_dict
    from cmx.config.presets import PRESETS as JPRESETS
    from cmx_torch.cli.pretrain import build_task
    from cmx_torch.config.config import Config, apply_overrides
    from cmx_torch.config.presets import PRESETS
    from cmx_torch.train.optim import AdamW, Sgd, make_optimizer

    cfg = PRESETS[name](Config())
    port = dataclasses.asdict(cfg)
    assert port["train"].pop("trace_spans") is False  # the port's own key
    assert port == to_dict(JPRESETS[name](JConfig()))
    apply_overrides(cfg, [f"task.view_size={VIEW}"])
    task, model = build_task(cfg, torch.float32, device="cpu")
    assert task.name == ("mae" if name.startswith("mae") else name)
    tx = make_optimizer(cfg.optim.name, 1e-3, cfg.optim.weight_decay,
                        named_params=model.named_parameters())
    assert isinstance(tx, AdamW if name == "cmunet" else Sgd)
    if name == "cmunet":
        assert model.projector.fc0.kernel.shape == (VIEW * VIEW, 1536)
        cells = dict(zip(task.post_update.__code__.co_freevars,
                         (c.cell_contents for c in task.post_update.__closure__)))
        assert cells["base_momentum"] == cfg.task.ema_momentum == 0.996
    else:
        assert sum(p.numel() for p in model.parameters()) == 31_042_369
        cells = dict(zip(task.loss_fn.__code__.co_freevars,
                         (c.cell_contents for c in task.loss_fn.__closure__)))
        assert cells["mask_ratio"] == (0.75 if name == "mae_tuned" else 0.5)
