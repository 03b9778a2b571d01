"""The fine-tune slice against cmx on the CPU: the UNet (fp32 at full width,
and fused bf16 through the flat kernels' plain versions against cmx's
Pallas kernels in interpret mode), the metrics, the host metrics, the
fine-tune augmentation with cmx's draws injected, Adam, KFold, both paths of
`fit`, find_best_epochs and the finetune CLI with an encoder.npz crossing
both ways. Weights cross with cmx_torch.ckpt.checkpoint.from_flax; inputs
come from numpy seeds. Tolerances are stated in each test.
"""

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
from flax import linen as nn

from cmx_torch.ckpt.checkpoint import _kind, _to_flax_layout, from_flax, to_flax

WIDTHS = (8, 16, 32, 64)
BNECK = 128
# The biases of convs that feed a batch norm: BN absorbs them, their true
# gradient is 0, and both packages move them by rounding noise only.
BN_ABSORBED = re.compile(r"(double_conv|bottleneck)\.conv[01]\.bias$")
# The leaves of the fused up1, whose K2 dX splits through the concat, and of
# down1, which that skip feeds.
SKIP_FED = re.compile(r"(encoder\.down1|decoder\.up1)\.")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's torch work, restored after
    it: the tier-1 run shares the cores among its workers, and torch's
    default of a thread a core then waits at its thread barriers (one fit
    test here took 229 s beside five busy processes, 14 s with two
    threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _leaf(tree, dotted):
    for k in dotted.split("."):
        tree = tree[k]
    return tree


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1e-12)


def _onehot(labels):
    """(B,H,W) int labels -> one-hot (B,H,W,2) float32 (cmx's layout)."""
    return np.eye(2, dtype=np.float32)[labels]


def _vessels(rng, b, size):
    """(B,H,W) 0/1 labels: a few thick random strokes (vessel-like, so that
    contours, skeletons and the soft skeleton have something to find)."""
    yy, xx = np.mgrid[0:size, 0:size]
    out = np.zeros((b, size, size), np.int64)
    for i in range(b):
        for _ in range(3):
            (y0, x0), (y1, x1) = rng.uniform(0, size, (2, 2))
            t = np.clip(((yy - y0) * (y1 - y0) + (xx - x0) * (x1 - x0))
                        / max((y1 - y0) ** 2 + (x1 - x0) ** 2, 1e-9), 0, 1)
            d = np.hypot(yy - (y0 + t * (y1 - y0)), xx - (x0 + t * (x1 - x0)))
            out[i] |= d < rng.uniform(1.0, 3.0)
    return out


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


class SmallUNet(nn.Module):
    """cmx's UNet at reduced widths: its UNetEncoder and UNetDecoder (which
    take `widths`) under the names `encoder` and `decoder`, with the fields
    cmx's harness reads (out_classes, up_sample_mode, dtype,
    use_running_average)."""

    out_classes: int = 2
    up_sample_mode: str = "conv_transpose"
    dtype: Any = jnp.float32
    use_running_average: bool = False
    fused: bool = False

    @nn.compact
    def __call__(self, x):
        from cmx.models.unet import UNetDecoder, UNetEncoder

        h, skips = UNetEncoder(widths=WIDTHS, bottleneck=BNECK,
                               dtype=self.dtype,
                               use_running_average=self.use_running_average,
                               fused=self.fused, name="encoder")(x)
        return UNetDecoder(out_classes=self.out_classes, widths=WIDTHS,
                           up_sample_mode=self.up_sample_mode,
                           dtype=self.dtype,
                           use_running_average=self.use_running_average,
                           fused=self.fused, name="decoder")(h, skips)


def _port_unet(dtype, fused=False, small=True):
    from cmx_torch.models.unet import UNet

    kw = dict(widths=WIDTHS, bottleneck=BNECK) if small else {}
    model = UNet(out_classes=2, dtype=dtype, fused=fused, **kw)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model


def _grads_vs_cmx(model, loss, jgrads):
    """[(name, port grad in flax layout, cmx grad)] of every parameter."""
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return [(n, _to_flax_layout(g.float().numpy(), _kind(model, n)),
             np.asarray(_leaf(jgrads, n))) for n, g in zip(names, grads)]


# ---------------------------------------------------------------- the UNet


def test_unet_fp32_full_width_matches_cmx():
    """cmx_torch's UNet against cmx.models.unet.UNet at full width, 32^2,
    fp32, batch 2, train mode: logits within 1e-4 of their largest entry;
    the gradients of segmentation_loss within 1e-4 of the largest gradient
    entry of the whole tree, and those not absorbed by a BN within 1e-4 of
    their own largest entry; the BN running statistics within 1e-5."""
    from cmx.eval.metrics import segmentation_loss as jloss
    from cmx.models.unet import UNet as JUNet
    from cmx_torch.eval.metrics import segmentation_loss

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 32)).astype(np.float32)
    y = _onehot(_vessels(rng, 2, 32))
    jm = JUNet(out_classes=2, dtype=jnp.float32)
    v = _np_tree(jax.jit(jm.init)(jax.random.key(0), x[:1]))

    def f(p):
        logits, mut = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                               x, mutable=["batch_stats"])
        return jloss(logits, y), (logits, mut)

    (jl, (jlog, jmut)), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
        v["params"])
    tm = from_flax(_port_unet(torch.float32, small=False), v).train()
    assert sorted(to_flax(tm)["params"]) == ["decoder", "encoder"]
    logits = tm(torch.from_numpy(x))
    assert logits.dtype == torch.float32 and logits.shape == (2, 2, 32, 32)
    assert _rel(logits.detach().numpy().transpose(0, 2, 3, 1), jlog) <= 1e-4
    loss = segmentation_loss(logits, _nchw(y))
    assert abs(float(loss) - float(jl)) <= 1e-4 * abs(float(jl))
    pairs = _grads_vs_cmx(tm, loss, jg)
    scale = max(float(np.max(np.abs(r))) for _, _, r in pairs)
    for name, got, ref in pairs:
        err = float(np.max(np.abs(got - ref)))
        assert err <= 1e-4 * scale, name
        if not BN_ABSORBED.search(name):
            assert err <= 1e-4 * float(np.max(np.abs(ref))), name
    for name, b in tm.named_buffers():
        np.testing.assert_allclose(
            b.numpy(), np.asarray(_leaf(jmut["batch_stats"], name)),
            atol=1e-5, rtol=1e-5, err_msg=name)


def test_unet_passes_fused_to_the_decoder_as_cmx():
    """UNet(fused=True) passes `fused` to every DoubleConv but the
    bottleneck's, as cmx; at the full width's 256^2 shapes the gate lets
    down1, down2 and up1 (Cin 2 * 64 = 128) through, the rest not."""
    from cmx_torch.models.blocks import DoubleConv

    model = _port_unet(torch.bfloat16, fused=True, small=False).train()
    shapes = {"encoder.down1.double_conv": (1, 256), "encoder.down2.double_conv": (64, 128),
              "encoder.down3.double_conv": (128, 64), "encoder.down4.double_conv": (256, 32),
              "encoder.bottleneck": (512, 16), "decoder.up4.double_conv": (1024, 32),
              "decoder.up3.double_conv": (512, 64), "decoder.up2.double_conv": (256, 128),
              "decoder.up1.double_conv": (128, 256)}
    convs = {n: m for n, m in model.named_modules() if isinstance(m, DoubleConv)}
    assert sorted(convs) == sorted(shapes)
    gated = {n for n, (cin, s) in shapes.items() if convs[n].use_fused(
        torch.empty((32, cin, s, s), device="meta"))}
    assert gated == {"encoder.down1.double_conv", "encoder.down2.double_conv",
                     "decoder.up1.double_conv"}
    assert [n for n, m in convs.items() if not m.fused] == ["encoder.bottleneck"]


def test_unet_bf16_fused_flat_matches_cmx(monkeypatch):
    """The fused bf16 UNet (FUSED_IMPL "flat": the plain versions of K1/K2
    here, cmx's Pallas kernels in interpret mode) against cmx's, reduced
    widths, 64^2 with FUSED_MIN_HW patched to 32 in both packages, so that
    down1, down2, up2 and up1 take the fused path (up1 with dX, routed back
    through the concat into the ConvTranspose and the skip). Batch 2, train
    mode, segmentation_loss. Bounds, the bf16 margins of
    test_spark_step_bf16_fused_pallas_loss_matches_cmx: the loss within 2e-2
    relative and the BN running statistics within 5e-2. Each gradient leaf
    is held to its own magnitude: its largest error within 0.15 of its
    largest entry and its error's L2 norm within 0.15 of its L2 norm; up1's
    leaves and down1's (which the skip feeds) within 0.1 on both. A leaf
    that is wrong as a whole is off by about 1. (Measured: at most 0.060
    largest and 0.047 L2 over all leaves, 0.034 over up1's and down1's;
    cmx's own bf16 gradients differ from its fp32 ones by more.) Two kinds
    of leaf are held otherwise. BN-absorbed conv biases (true gradient 0)
    to 1e-2 of the tree's largest gradient entry in both packages. The
    ConvTranspose biases and the head's bias, whose cotangents cmx sums in
    bf16 on the CPU (its head.bias gradient here is 0.123 where the fp32
    sum of its own softmax - target is 0.199), to 1e-2 relative against the
    fp64 sum of the port's own cotangent of that layer's output (measured:
    at most 2.7e-3): a check of the port's reduction only, which supplements
    test_unet_fp32_full_width_matches_cmx's hold of these biases against
    cmx (1e-4 of their largest entry); the cotangents themselves are held
    through the kernels of the same layers above."""
    from cmx.eval.metrics import segmentation_loss as jloss
    from cmx.ops import fused_conv as cfc
    from cmx_torch.eval.metrics import segmentation_loss
    from cmx_torch.ops import _build
    from cmx_torch.ops import fused_conv as tfc

    monkeypatch.setattr(cfc, "FUSED_MIN_HW", 32)
    monkeypatch.setattr(tfc, "FUSED_MIN_HW", 32)
    monkeypatch.setattr(_build, "recorded", [])
    rng = np.random.default_rng(1)
    B, S = 2, 64
    x = rng.normal(size=(B, S, S)).astype(np.float32)
    y = _onehot(_vessels(rng, B, S))
    jm = SmallUNet(dtype=jnp.bfloat16, fused=True)
    v = _np_tree(jax.jit(jm.init)(jax.random.key(3), x[:1]))

    def f(p):
        logits, mut = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                               x, mutable=["batch_stats"])
        return jloss(logits, y), mut

    (jl, jmut), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(v["params"])
    tm = from_flax(_port_unet(torch.bfloat16, fused=True), v).train()
    ups = {}
    for i in range(1, 5):
        getattr(tm.decoder, f"up{i}").up.register_forward_hook(
            lambda m, a, out, i=i: ups.__setitem__(f"decoder.up{i}.up.bias",
                                                   out))
    logits = tm(torch.from_numpy(x))
    loss = segmentation_loss(logits, _nchw(y))
    n_fwd = len(_build.recorded)
    cots = torch.autograd.grad(loss, list(ups.values()), retain_graph=True)
    del _build.recorded[n_fwd:]  # this backward's calls: not the one below
    sums = {name: c.double().sum((0, 2, 3)).numpy()
            for name, c in zip(ups, cots)}
    p = torch.softmax(logits.detach().double(), 1)
    sums["decoder.head.bias"] = ((p - _nchw(y).double()).sum((0, 2, 3))
                                 / (B * S * S)).numpy()
    pairs = _grads_vs_cmx(tm, loss, jg)
    calls = [(n, a) for n, a in _build.recorded]
    fwd = [tuple(a[0].shape) for n, a in calls if n == "flat_conv3x3_mask_stats"]
    bwd = [(a[2].shape[1], a[15]) for n, a in calls if n == "flat_bwd_mega"]
    # down1, down2, up2, up1: two stages each; the backward runs in reverse,
    # dX everywhere but at the image (down1's stage 0)
    assert fwd == [(B, 1, S * S), (B, 8, S * S), (B, 8, (S // 2) ** 2),
                   (B, 16, (S // 2) ** 2), (B, 32, (S // 2) ** 2),
                   (B, 16, (S // 2) ** 2), (B, 16, S * S), (B, 8, S * S)]
    assert bwd == [(8, True), (16, True), (16, True), (32, True), (16, True),
                   (8, True), (8, True), (1, False)]
    assert abs(float(loss) - float(jl)) <= 2e-2 * abs(float(jl))
    for name, b in tm.named_buffers():
        ref = np.asarray(_leaf(jmut["batch_stats"], name))
        assert float(np.max(np.abs(b.numpy() - ref))) <= 5e-2, name
    scale = max(float(np.max(np.abs(r))) for _, _, r in pairs)
    for name, got, ref in pairs:
        if BN_ABSORBED.search(name):
            assert max(np.max(np.abs(got)), np.max(np.abs(ref))) <= 1e-2 * scale
        elif name in sums:
            assert _rel(got, sums[name]) <= 1e-2, name
        else:
            bound = 0.1 if SKIP_FED.match(name) else 0.15
            assert _rel(got, ref) <= bound, name
            assert (np.linalg.norm(got - ref)
                    <= bound * np.linalg.norm(ref)), name
    assert sorted(sums) == sorted(n for n, _, _ in pairs if n in sums)


# ---------------------------------------------------------------- metrics


def _metric_inputs():
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(2, 24, 24, 2)) * 2.0).astype(np.float32)
    target = _onehot(_vessels(rng, 2, 24))
    return logits, target


def _cases():
    """name -> (fn(module, logits, target), returns a map?): each applied
    to cmx's module with class-last arrays and to the port's with NCHW."""
    def sm(mod, lg):
        return mod.softmax_channels(lg)

    return {
        "f_score": lambda m, lg, t: m.f_score(sm(m, lg), t),
        "f_score_thresholded": lambda m, lg, t: m.f_score(
            sm(m, lg), t, beta=2.0, threshold=0.5, ignore_channels=(0,)),
        "dice_loss": lambda m, lg, t: m.dice_loss(lg, t),
        "dice_loss_soft": lambda m, lg, t: m.dice_loss(lg, t, threshold=None),
        "dice_loss_sigmoid": lambda m, lg, t: m.dice_loss(
            lg, t, activation="sigmoid", ignore_channels=None),
        "dice_loss_tanh": lambda m, lg, t: m.dice_loss(
            lg, t, activation="tanh", threshold=None),
        "dice_loss_logsoftmax": lambda m, lg, t: m.dice_loss(
            lg, t, activation="logsoftmax", threshold=None),
        "dice_loss_identity": lambda m, lg, t: m.dice_loss(
            lg, t, activation=None, threshold=0.1),
        "iou_loss": lambda m, lg, t: m.iou_loss(lg, t),
        "iou_loss_soft": lambda m, lg, t: m.iou_loss(lg, t, threshold=None),
        "cross_entropy_loss": lambda m, lg, t: m.cross_entropy_loss(lg, t),
        "nll_loss": lambda m, lg, t: m.nll_loss(
            m._apply_activation(lg, "logsoftmax"), t),
        "bce_with_logits_loss": lambda m, lg, t: m.bce_with_logits_loss(lg, t),
        "label_smooth_loss": lambda m, lg, t: m.label_smooth_loss(lg, t, 0.2),
        "mse_loss": lambda m, lg, t: m.mse_loss(lg, t),
        "l1_loss": lambda m, lg, t: m.l1_loss(lg, t),
        "soft_erode": lambda m, lg, t: m._soft_erode(sm(m, lg)),
        "soft_dilate": lambda m, lg, t: m._soft_dilate(sm(m, lg)),
        "soft_skeletonize": lambda m, lg, t: m.soft_skeletonize(sm(m, lg)),
        "soft_skeletonize_target": lambda m, lg, t: m.soft_skeletonize(t, 5),
        "soft_cldice_loss": lambda m, lg, t: m.soft_cldice_loss(lg, t),
        "soft_cldice_loss_soft": lambda m, lg, t: m.soft_cldice_loss(
            lg, t, threshold=None, num_iter=3, smooth=0.5),
        "soft_dice": lambda m, lg, t: m.soft_dice(t, sm(m, lg)),
        "segmentation_loss": lambda m, lg, t: m.segmentation_loss(lg, t),
        "segmentation_metrics": lambda m, lg, t: m.segmentation_metrics(
            lg, t, cheap=False),
        "segmentation_metrics_cheap": lambda m, lg, t: m.segmentation_metrics(
            lg, t, cheap=True),
    }


@pytest.mark.parametrize("name", sorted(_cases()))
def test_metrics_match_cmx(name):
    """Every function of cmx_torch.eval.metrics against cmx's on the same
    fp32 logits and one-hot targets (class axis 1 against cmx's last):
    within 1e-5 of the reference's largest entry; dict results key by key;
    the soft morphology at the border included (max_pool2d's -inf padding is
    flax's)."""
    from cmx.eval import metrics as jm
    from cmx_torch.eval import metrics as tm

    logits, target = _metric_inputs()
    fn = _cases()[name]
    ref = fn(jm, jnp.asarray(logits), jnp.asarray(target))
    got = fn(tm, _nchw(logits), _nchw(target))
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref)
        pairs = [(got[k], ref[k]) for k in ref]
    else:
        pairs = [(got, ref)]
    for g, r in pairs:
        r = np.asarray(r)
        g = g.numpy()
        if r.ndim == 4:
            g = g.transpose(0, 2, 3, 1)
        assert g.shape == r.shape
        assert _rel(g, r) <= 1e-5, name


def test_thresholded_dice_has_zero_gradient_as_cmx():
    """The loss's Dice is thresholded (no straight-through): its gradient is
    zero in both packages, so segmentation_loss trains through CE alone."""
    from cmx.eval import metrics as jm
    from cmx_torch.eval import metrics as tm

    logits, target = _metric_inputs()
    jg = jax.grad(lambda z: jm.dice_loss(z, target))(jnp.asarray(logits))
    z = _nchw(logits).requires_grad_(True)
    # torch drops the graph at the threshold: no gradient reaches z
    assert float(jnp.max(jnp.abs(jg))) == 0.0
    assert not tm.dice_loss(z, _nchw(target)).requires_grad
    jg = jax.grad(lambda z: jm.segmentation_loss(z, target))(jnp.asarray(logits))
    tm.segmentation_loss(z, _nchw(target)).backward()
    assert _rel(z.grad.numpy().transpose(0, 2, 3, 1), jg) <= 1e-5


def test_host_metrics_equal_cmx():
    """The port's copy of host_metrics gives cmx's numbers exactly on the
    same arrays (class-last, as both take them): Hausdorff on thresholded
    probabilities, the artery radius, and their parts, empty masks
    included."""
    from cmx.eval import host_metrics as jh
    from cmx_torch.eval import host_metrics as th

    rng = np.random.default_rng(5)
    gt = _vessels(rng, 3, 48)
    pr = _vessels(rng, 3, 48)
    pr[2] = 0  # an empty prediction: inf, as the reference
    logits = np.where(_onehot(pr) > 0, 2.0, -2.0).astype(np.float32)
    logits += rng.normal(size=logits.shape).astype(np.float32) * 0.5
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    target = _onehot(gt)
    assert th.hausdorff_metric(probs[..., 1], target[..., 1]) \
        == jh.hausdorff_metric(probs[..., 1], target[..., 1])
    assert th.radius_arteries_metric(logits, target) \
        == jh.radius_arteries_metric(logits, target)
    for i in range(3):
        for method in ("modified", "standard"):
            assert th.hausdorff_distance_mask(pr[i], gt[i], method) \
                == jh.hausdorff_distance_mask(pr[i], gt[i], method)
        assert th.compute_radius_arteries(gt[i]) \
            == jh.compute_radius_arteries(gt[i])
        assert np.array_equal(th.skeletonize(gt[i]), jh.skeletonize(gt[i]))


# ---------------------------------------------------------------- augmentation


def _cmx_finetune_draws(key, h, w):
    """The draws cmx's finetune_train_aug makes from `key`, by its key tree
    (cmx/ops/augment.py:881-939 and the functions it calls)."""
    ks = jax.random.split(key, 6)
    kp, kv, kn = jax.random.split(ks[0], 3)
    d = {"noise_apply": jax.random.uniform(kp) < 0.1,
         "noise_var": jax.random.uniform(kv, minval=10.0, maxval=50.0),
         "noise": jax.random.normal(kn, (h, w), jnp.float32)}
    kp, kss = jax.random.split(ks[1])
    d["blur_sigma"] = jax.random.uniform(kss, minval=0.5, maxval=1.0)
    d["blur_apply"] = jax.random.uniform(kp) < 0.2
    kp, kb, kc = jax.random.split(ks[2], 3)
    d["alpha"] = 1.0 + jax.random.uniform(kc, minval=-0.2, maxval=0.2)
    d["beta"] = jax.random.uniform(kb, minval=-0.25, maxval=0.25)
    d["bc_apply"] = jax.random.uniform(kp) < 0.15
    kp, kl = jax.random.split(ks[3])
    d["down_level"] = jax.random.randint(kl, (), 0, 6)
    d["down_apply"] = jax.random.uniform(kp) < 0.25
    d["oneof_apply"] = jax.random.uniform(ks[4]) < 0.75
    d["oneof_branch"] = jax.random.randint(ks[5], (), 0, 4)
    kp, kv, kn = jax.random.split(jax.random.fold_in(key, 7), 3)
    d["oneof_var"] = jax.random.uniform(kv, minval=10.0, maxval=50.0)
    d["oneof_noise"] = jax.random.normal(kn, (h, w), jnp.float32)
    return d


def _covering_keys(h, w):
    """Keys whose draws, between them, take every OneOf branch (and no
    branch), every downscale level, and the noise, blur and brightness /
    contrast steps, each at least once."""
    want = ({("branch", b) for b in range(4)} | {("branch", None)}
            | {("level", lv) for lv in range(6)}
            | {"noise", "blur", "bc"})
    keys, seen = [], set()
    for i in range(2000):
        key = jax.random.key(i)
        d = _cmx_finetune_draws(key, h, w)
        got = {("branch", int(d["oneof_branch"]) if d["oneof_apply"] else None)}
        if d["down_apply"]:
            got.add(("level", int(d["down_level"])))
        got |= {name for name, k in (("noise", "noise_apply"),
                                     ("blur", "blur_apply"),
                                     ("bc", "bc_apply")) if d[k]}
        if got - seen:
            keys.append(key)
            seen |= got
        if want <= seen:
            return keys
    raise AssertionError(f"no keys cover {want - seen}")


def test_finetune_train_aug_matches_cmx_with_injected_draws():
    """finetune_train_aug over a batch against cmx's per-image function
    (vmapped over its keys), with each image's draws derived from cmx's key
    tree and injected; the keys cover every OneOf branch and no branch,
    every downscale level and the noise, blur and brightness/contrast
    steps. Images within 1e-5 of their largest entry (the blur's and the
    noise's fp32 sums in another order), masks exactly."""
    from cmx.ops.augment import finetune_train_aug as jaug
    from cmx_torch.ops.augment import finetune_train_aug

    H = W = 32
    keys = _covering_keys(H, W)
    B = len(keys)
    rng = np.random.default_rng(6)
    imgs = rng.normal(size=(B, H, W)).astype(np.float32)
    masks = _onehot(_vessels(rng, B, H))
    ji, jmk = jax.jit(jax.vmap(jaug))(jnp.stack(keys), jnp.asarray(imgs),
                                      jnp.asarray(masks))
    per = [_cmx_finetune_draws(k, H, W) for k in keys]
    draws = {k: torch.from_numpy(np.stack([np.asarray(d[k]) for d in per]))
             for k in per[0]}
    ti, tmk = finetune_train_aug(torch.from_numpy(imgs), _nchw(masks),
                                 draws=draws)
    assert _rel(ti.numpy(), ji) <= 1e-5
    assert np.array_equal(tmk.numpy().transpose(0, 2, 3, 1), np.asarray(jmk))


@pytest.mark.parametrize("scale", [0.5, 0.6, 0.7, 0.8, 0.9])
def test_down_up_is_jax_nearest_resize(scale):
    """_down_up (torch's nearest-exact) equals cmx's _down_up
    (jax.image.resize "nearest") bit for bit at every downscale level."""
    from cmx.ops.augment import _down_up as jdown
    from cmx_torch.ops.augment import _down_up

    imgs = np.random.default_rng(7).normal(size=(2, 256, 256)).astype(
        np.float32)
    ref = np.stack([np.asarray(jdown(jnp.asarray(a), scale)) for a in imgs])
    assert np.array_equal(_down_up(torch.from_numpy(imgs), scale).numpy(), ref)


def test_finetune_draws_follow_cmx_distributions():
    """The draws from a generator: shapes, dtypes and ranges of cmx's
    distributions (Bernoulli rates within 5 sigma at 4096 images)."""
    from cmx_torch.ops.augment import finetune_draws

    n = 4096
    d = finetune_draws(torch.Generator().manual_seed(0), n, 8, 8)
    for k, p in (("noise_apply", 0.1), ("blur_apply", 0.2), ("bc_apply", 0.15),
                 ("down_apply", 0.25), ("oneof_apply", 0.75)):
        assert d[k].dtype == torch.bool
        assert abs(float(d[k].float().mean()) - p) <= 5 * (p * (1 - p) / n) ** .5
    for k, lo, hi in (("noise_var", 10, 50), ("oneof_var", 10, 50),
                      ("blur_sigma", 0.5, 1.0), ("alpha", 0.8, 1.2),
                      ("beta", -0.25, 0.25)):
        assert lo <= float(d[k].min()) and float(d[k].max()) <= hi, k
    assert sorted(d["down_level"].unique().tolist()) == list(range(6))
    assert sorted(d["oneof_branch"].unique().tolist()) == list(range(4))
    assert d["noise"].shape == d["oneof_noise"].shape == (n, 8, 8)
    given = {"alpha": torch.ones(n)}
    assert finetune_draws(torch.Generator().manual_seed(0), n, 8, 8,
                          given)["alpha"] is given["alpha"]


# ---------------------------------------------------------------- Adam, KFold


def test_adam_matches_optax_with_a_nonfinite_step():
    """Adam against optax.inject_hyperparams(optax.adam) (the harness's) on
    the same gradients for 5 steps, lr 3e-3 injected into optax's state;
    step 3's gradients hold a NaN: the port keeps its parameters and state
    (count included) and cmx's trainer keeps the old state, so optax skips
    that update. Parameters and moments within 1e-6 relative."""
    import optax

    from cmx_torch.train.optim import Adam, make_optimizer

    rng = np.random.default_rng(8)
    shapes = [(3, 3, 4, 5), (5,), (2, 7)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=1e-3)
    jp = [jnp.asarray(p) for p in params]
    st = tx.init(jp)
    st.hyperparams["learning_rate"] = jnp.asarray(3e-3, jnp.float32)
    tp = [torch.from_numpy(p.copy()) for p in params]
    adam = Adam([(str(i), p) for i, p in enumerate(tp)], 3e-3)
    for step in range(5):
        grads = [(rng.normal(size=s) * 10.0 ** (step - 2)).astype(np.float32)
                 for s in shapes]
        finite = step != 3
        if not finite:
            grads[1][2] = np.nan
        else:
            upd, st = tx.update([jnp.asarray(g) for g in grads], st, jp)
            jp = optax.apply_updates(jp, upd)
        adam.step([torch.from_numpy(g) for g in grads], torch.tensor(finite))
        assert int(adam.count) == int(st.count)
        for t, j, mu, nu, jmu, jnu in zip(tp, jp, adam.mu, adam.nu,
                                          st.inner_state[0].mu,
                                          st.inner_state[0].nu):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-6,
                                       atol=1e-9)
            np.testing.assert_allclose(nu.numpy(), np.asarray(jnu), rtol=1e-6,
                                       atol=1e-12)
    with pytest.raises(ValueError, match="unknown optimizer 'adam'"):
        make_optimizer("adam", 1e-3, named_params=[("w", tp[0])])


@pytest.mark.parametrize("seed", [0, 42, 2024])
def test_kfold_equals_sklearn(seed):
    """KFold(3, random_state) equals scikit-learn's KFold(3, shuffle=True,
    random_state), index for index, for n 3..40 (the card machine has no
    scikit-learn)."""
    from sklearn.model_selection import KFold as SkKFold

    from cmx_torch.data.splits import KFold

    for n in range(3, 41):
        ours = list(KFold(3, random_state=seed).split(range(n)))
        ref = list(SkKFold(3, shuffle=True, random_state=seed).split(
            np.zeros(n)))
        assert len(ours) == len(ref) == 3
        for (a, b), (c, d) in zip(ours, ref):
            assert np.array_equal(a, c) and np.array_equal(b, d), (n, seed)
    with pytest.raises(ValueError):
        list(KFold(3, random_state=seed).split(range(2)))


# ---------------------------------------------------------------- the harness


@pytest.mark.parametrize("logs", [
    {"dice_loss": [0.5, 0.4, 0.45], "cross_entropy_loss": [0.7, 0.6, 0.5]},
    {"dice_loss": [0.5, np.nan, 0.3], "cross_entropy_loss": [0.7, 0.1, 0.6]},
    {"dice_loss": [np.inf, 0.9, 0.2], "cross_entropy_loss": [0.1, 0.1, np.inf]},
    {"dice_loss": [0.3, 0.3, 0.2], "cross_entropy_loss": [0.2, 0.2, 0.3],
     "hausdorff": [np.inf, 4.0, np.nan]},
])
def test_find_best_epochs_matches_cmx(logs):
    from cmx.train.harness import find_best_epochs as jbest
    from cmx_torch.train.harness import find_best_epochs

    before = {k: list(v) for k, v in logs.items()}
    assert find_best_epochs(logs) == jbest(logs)
    assert all(np.array_equal(before[k], logs[k], equal_nan=True)
               for k in logs)  # untouched


@pytest.mark.parametrize("n,batch,seed", [(10, 8, 0), (3, 8, 1), (16, 4, 2)])
def test_batches_equal_cmx(n, batch, seed):
    from cmx.train.harness import _batches as jbatches
    from cmx_torch.train.harness import _batches

    ours = list(_batches(n, batch, np.random.default_rng(seed)))
    ref = list(jbatches(n, batch, np.random.default_rng(seed)))
    assert len(ours) == len(ref)
    assert all(np.array_equal(a, b) for a, b in zip(ours, ref))


def _fit_data(n_train, n_valid, size, seed):
    rng = np.random.default_rng(seed)
    n = n_train + n_valid
    imgs = rng.normal(size=(n, size, size)).astype(np.float32)
    labels = _vessels(rng, n, size)
    imgs += labels * 1.5  # learnable
    masks = _onehot(labels)
    return (imgs[:n_train], masks[:n_train], imgs[n_train:], masks[n_train:])


# Bounds for fit's logs against cmx's. Adam divides by sqrt(nu), so the
# rounding noise in near-zero gradients (the BN-absorbed conv biases) moves
# parameters by up to lr a step in either package; train-mode BN absorbs
# that, the frozen-BN validation forward only in part. Continuous logs within
# 1e-2 relative; the thresholded ones within 2e-2 absolute (a pixel whose
# softmax sits at 0.5 flips between the packages; loss holds the thresholded
# Dice); the host metrics within 0.25 pixel (a flipped pixel moves a
# contour or a skeleton point).
CONTINUOUS = ("cross_entropy_loss", "grad_norm", "nonfinite")
PIXELS = ("hausdorff", "radius_arteries")


def _assert_logs_close(ours, ref):
    assert sorted(ours) == sorted(ref)
    for k in ref:
        a, b = np.asarray(ours[k]), np.asarray(ref[k])
        if k in CONTINUOUS:
            np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-6, err_msg=k)
        else:
            bound = 0.25 if k in PIXELS else 2e-2
            np.testing.assert_allclose(a, b, rtol=0, atol=bound, err_msg=k)


def test_fit_host_loop_matches_cmx():
    """fit's host loop (host_metrics_every=1, augment off) against cmx's:
    reduced widths (the full width's numerics are held by
    test_unet_fp32_full_width_matches_cmx), 32^2, fp32, 2 epochs, batch 8 over 10 training images (the
    second batch wrap-padded) and 4 validation images (one padded batch),
    cmx's initial weights and numpy batches on both sides. The logs (train
    loss, metrics and grad norm; validation metrics with hausdorff and
    radius_arteries) within the bounds above _assert_logs_close, the best
    epoch equal."""
    from cmx.train.harness import fit as jfit
    from cmx_torch.train.harness import fit

    xtr, ytr, xva, yva = _fit_data(10, 4, 32, 9)
    jm = SmallUNet()
    v = _np_tree(jax.jit(jm.init)(jax.random.key(1), xtr[:1]))
    kw = dict(lr=1e-3, epochs=2, batch=8, seed=3, augment=False,
              host_metrics_every=1, init_variables=v)
    ref = jfit(xtr, ytr, xva, yva, model=jm, **kw)
    res = fit(xtr, ytr, xva, yva, model=_port_unet(torch.float32),
              device="cpu", **kw)
    _assert_logs_close(res.train_logs, ref.train_logs)
    _assert_logs_close(res.valid_logs, ref.valid_logs)
    assert res.best_epoch == ref.best_epoch
    assert len(res.valid_logs["hausdorff"]) == 2


def _state_moves(model, variables, ref):
    """[(name, port tensor - initial, cmx's - initial, tree)] of every
    parameter and BN buffer of the port's `model` (in flax layout); `ref`
    is cmx's (params, batch_stats)."""
    params = dict(model.named_parameters())
    out = []
    for name, t in model.state_dict().items():
        i = 0 if name in params else 1
        init = np.asarray(_leaf(variables[("params", "batch_stats")[i]],
                                name), np.float64)
        got = _to_flax_layout(t.detach().float().numpy(), _kind(model, name))
        out.append((name, got - init,
                    np.asarray(_leaf(ref[i], name), np.float64) - init,
                    ("params", "batch_stats")[i]))
    return out


def test_fit_host_loop_with_nan_validation_ends_at_cmx_last_epoch():
    """Every validation image and mask NaN, so no epoch's dice_loss is
    below inf: the
    host loop of both packages returns the last epoch's state (fault F2;
    cmx restores a best state only when it has one). The setting of
    test_fit_host_loop_matches_cmx; the train logs within its bounds, every
    validation dice_loss NaN in both. Each BN running statistic's move from
    the initial state within 5e-2 of cmx's move in L2 (1.34e-2 measured),
    each parameter's within 0.3 (0.19 measured: Adam turns a gradient near
    0 into a move of about lr with the sign of rounding noise, in either
    package); a state left at the start is 1.0 off. The conv biases a BN
    absorbs (true gradient 0) within lr x steps of the start in both."""
    from cmx.train.harness import fit as jfit
    from cmx_torch.train.harness import fit

    xtr, ytr, xva, yva = _fit_data(10, 4, 32, 9)
    xva, yva = np.full_like(xva, np.nan), np.full_like(yva, np.nan)
    jm = SmallUNet()
    v = _np_tree(jax.jit(jm.init)(jax.random.key(1), xtr[:1]))
    kw = dict(lr=1e-3, epochs=2, batch=8, seed=3, augment=False,
              host_metrics_every=1, init_variables=v)
    ref = jfit(xtr, ytr, xva, yva, model=jm, **kw)
    res = fit(xtr, ytr, xva, yva, model=_port_unet(torch.float32),
              device="cpu", **kw)
    _assert_logs_close(res.train_logs, ref.train_logs)
    assert np.isnan(ref.valid_logs["dice_loss"]).all()
    assert np.isnan(res.valid_logs["dice_loss"]).all()
    steps = 2 * 2  # 2 epochs of 2 batches
    moves = _state_moves(res.state.model, v,
                         (ref.state.params, ref.state.batch_stats))
    for name, got, want, tree in moves:
        if BN_ABSORBED.search(name):
            bound = 1e-3 * steps * 1.01
            assert np.max(np.abs(got)) <= bound, name
            assert np.max(np.abs(want)) <= bound, name
            continue
        bound = 0.3 if tree == "params" else 5e-2
        norm = np.linalg.norm(want)
        assert norm > 0 and np.linalg.norm(got - want) <= bound * norm, name


def test_fit_scan_with_nan_validation_ends_where_it_started():
    """The scan path's twin of the test above: with every validation
    dice_loss NaN it returns the initial parameters and BN statistics bit
    for bit, as cmx's _fit_scan does, after training steps that moved
    them."""
    from cmx_torch.train.harness import fit

    xtr, ytr, xva, yva = _fit_data(6, 3, 32, 10)
    xva, yva = np.full_like(xva, np.nan), np.full_like(yva, np.nan)
    model = _port_unet(torch.float32)
    res = fit(xtr, ytr, xva, yva, lr=1e-3, epochs=2, batch=4, seed=5,
              augment=False, model=model, device="cpu")
    assert np.isnan(res.valid_logs["dice_loss"]).all()
    assert np.isfinite(res.train_logs["loss"]).all()
    assert all(float(x) != 0.0 for x in res.train_logs["grad_norm"])
    before = model.state_dict()  # fit trained a copy
    assert res.state.model is not model
    for name, t in res.state.model.state_dict().items():
        assert torch.equal(t, before[name]), name


def test_fit_scan_counterpart_matches_cmx_with_injected_permutations():
    """fit's default path (cmx's _fit_scan counterpart) against cmx's, with
    cmx's epoch permutations injected (jax.random.permutation of
    fold_in(key(seed ^ 0x5EED), epoch)): reduced widths, 32^2, fp32, 3
    epochs, batch 4 over 6 training images (two steps, the second
    wrap-padded) and 5 validation images evaluated in one forward with the
    full metric set. Logs within the bounds above _assert_logs_close, the
    best epoch equal, and the returned state is the best epoch's (its
    validation dice_loss reproduced by evaluating it)."""
    from cmx.train.harness import fit as jfit
    from cmx_torch.train.harness import (evaluate, fit, upload_set)
    from cmx_torch.train.supervised import make_eval_fn

    xtr, ytr, xva, yva = _fit_data(6, 5, 32, 10)
    jm = SmallUNet()
    v = _np_tree(jax.jit(jm.init)(jax.random.key(2), xtr[:1]))
    seed, epochs = 5, 3
    base = jax.random.key(np.uint32(seed) ^ np.uint32(0x5EED))
    perms = [np.asarray(jax.random.permutation(jax.random.fold_in(base, ep),
                                               6)) for ep in range(epochs)]
    kw = dict(lr=1e-3, epochs=epochs, batch=4, seed=seed, augment=False,
              init_variables=v)
    ref = jfit(xtr, ytr, xva, yva, model=jm, **kw)
    res = fit(xtr, ytr, xva, yva, model=_port_unet(torch.float32),
              device="cpu", perms=perms, **kw)
    _assert_logs_close(res.train_logs, ref.train_logs)
    _assert_logs_close(res.valid_logs, ref.valid_logs)
    assert sorted(res.valid_logs) == ["cross_entropy_loss", "dice_loss",
                                      "iou_loss", "soft_clDice"]
    assert res.best_epoch == ref.best_epoch
    best = int(np.argmin(res.valid_logs["dice_loss"]))
    xv, yv = upload_set(xva, yva, torch.device("cpu"))
    again = evaluate(make_eval_fn(res.state.model), xv, yv, batch=5,
                     host=False)
    assert abs(again["dice_loss"] - res.valid_logs["dice_loss"][best]) <= 1e-6


def test_fit_draws_its_own_permutations_and_augments():
    """Without injected permutations fit's default path draws each epoch's
    from its keyed generator (the same for the same seed), and with
    augmentation on the step draws from the step's generator: two runs with
    one seed give the same logs, finite; another seed other logs."""
    from cmx_torch.train.harness import fit

    data = _fit_data(5, 3, 32, 11)
    runs = [fit(*data, lr=1e-3, epochs=2, batch=4, seed=s,
                model=_port_unet(torch.float32), device="cpu")
            for s in (0, 0, 1)]
    assert runs[0].train_logs == runs[1].train_logs
    assert runs[0].train_logs != runs[2].train_logs
    assert all(np.isfinite(v).all() for r in runs
               for v in (*r.train_logs.values(), *r.valid_logs.values()))


# ---------------------------------------------------------------- the CLI


def _cmx_small_state(seed):
    import optax

    from cmx.train.state import TrainState

    jm = SmallUNet()
    v = _np_tree(jax.jit(jm.init)(jax.random.key(seed), jnp.zeros((1, 32, 32))))
    rng = np.random.default_rng(seed)
    bs = jax.tree.map(lambda a: (rng.random(a.shape) + 0.5).astype(np.float32),
                      v["batch_stats"])
    return jm, TrainState.create(params=v["params"], batch_stats=bs,
                                 tx=optax.sgd(0.1))


def test_finetune_cli_on_the_cpu_with_cmx_encoder_both_ways(tmp_path,
                                                            monkeypatch):
    """cmx_torch.cli.finetune on the CPU (12 synthetic images at 32^2,
    data.ratio=0.3: 4 fine-tune and 3 test images, fp32, one lr, one epoch,
    batch 8, reduced widths patched into the CLI's UNet) with an encoder.npz
    that cmx exported: the UNet's encoder equals the file bit for bit (the
    decoder keeps its seeded weights), the grid ran 3 folds, the files carry
    cmx's tag (the encoder's directory), test_<tag>.json holds a finite dice
    = 1 - dice_loss. The reverse: the port's export of the fine-tuned model
    loads through cmx's load_encoder with leaves equal to the port's."""
    import pickle

    import cmx_torch.models.unet as unet
    from cmx.ckpt.checkpoint import export_encoder as jexport
    from cmx.ckpt.checkpoint import load_encoder as jload
    from cmx_torch.ckpt.checkpoint import export_encoder
    from cmx_torch.cli.finetune import main

    monkeypatch.setattr(unet, "UNet", functools.partial(
        unet.UNet, widths=WIDTHS, bottleneck=BNECK))
    jm, jstate = _cmx_small_state(12)
    enc = tmp_path / "spark_run" / "encoder.npz"
    os.makedirs(enc.parent)
    jexport(jstate, str(enc))
    out = tmp_path / "results"
    res = main(["--device", "cpu", "--pretrained", str(enc), "--lrs", "1e-3",
                "--epochs", "1", "--batches", "8", "--out", str(out),
                "data.synthetic=True", "data.synthetic_n=12",
                "data.image_size=32", f"data.data_dir={tmp_path / 'data'}",
                "data.ratio=0.3", "model.dtype=float32"])
    assert (res["n_finetune"], res["n_test"], res["tag"]) == (4, 3, "spark_run")
    loaded = to_flax(res["model"])
    with np.load(enc) as f:
        for k in f.files:
            kind, *path = k.split("/")
            tree = loaded["params" if kind == "params" else "batch_stats"]
            assert np.array_equal(_leaf(tree["encoder"], ".".join(path)),
                                  f[k]), k
    assert len(res["grid"]) == 1 and len(res["grid"][0]["folds"]) == 3
    with open(out / "result_finetuning_unet_spark_run.pkl", "rb") as f:
        assert pickle.load(f)[0]["lr"] == 1e-3
    with open(out / "test_spark_run.json") as f:
        saved = json.load(f)
    assert np.isfinite(saved["dice"])
    assert saved["dice"] == 1.0 - saved["test_metrics"]["dice_loss"]
    assert saved["hypers"] == {"lr": 1e-3, "batch": 8, "epochs": 1}
    assert {"hausdorff", "radius_arteries", "soft_clDice"} <= set(
        saved["test_metrics"])

    from cmx_torch.train.state import TrainState

    back = tmp_path / "port_encoder.npz"
    export_encoder(TrainState.create(model=res["state"].model, tx=None),
                   str(back))
    params, bs = jload(str(back), jstate.params, jstate.batch_stats)
    ours = to_flax(res["state"].model)
    for tree, mine in ((params, ours["params"]), (bs, ours["batch_stats"])):
        la = jax.tree_util.tree_leaves_with_path(tree["encoder"])
        lb = jax.tree_util.tree_leaves_with_path(mine["encoder"])
        assert [p for p, _ in la] == [p for p, _ in lb]
        assert all(np.array_equal(np.asarray(a), b)
                   for (_, a), (_, b) in zip(la, lb))
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(
        jax.tree.leaves(params["decoder"]),
        jax.tree.leaves(jstate.params["decoder"])))


def test_finetune_cli_and_fit_default_to_cuda():
    """Without a card the CLI and fit raise (device defaults to "cuda")."""
    from cmx_torch.cli.finetune import main
    from cmx_torch.train.harness import fit

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["data.synthetic=True"])
    with pytest.raises(RuntimeError, match="cuda"):
        fit(*_fit_data(2, 1, 32, 0), epochs=1)


def test_result_tag_is_cmx_rule():
    from cmx_torch.cli.finetune import result_tag

    assert result_tag(None) == "None"
    assert result_tag("ckpt/spark/encoder.npz") == "spark"
    assert result_tag("ckpt/spark/model.npz") == "spark"
    assert result_tag("weights/moco_r50.npz") == "moco_r50"
