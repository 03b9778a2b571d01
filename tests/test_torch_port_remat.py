"""Selective rematerialization (`model.remat`, cmx's nn.remat on named
blocks) in the port: `torch.utils.checkpoint` on the same blocks, with the
BN running statistics updated once and the recompute shifted by the
running mean the forward saw.

  * in the port, on the CPU: two train steps of SparK and of the MAE UNet
    with remat equal the same steps without it bit for bit (loss, every
    gradient, every BN buffer, the optimizer state), in fp32 and in bf16
    with `fused=True` (the plain versions of K1/K2 here), for the levels
    e1,e2,d1,d2 / bneck,e3,e4 / an unknown name, and for e1,e2,d1,d2 with
    the BN variant shift_max (CMX_BN_VARIANT); the fused recompute runs
    K1 again at the recomputed fused stages;
  * against cmx with the same remat_levels (fp32, cmx's mask injected):
    the tolerances of the SparK and MAE step tests;
  * the parameter names: to_flax of a remat model equals the model's
    without remat, and an encoder.npz exported after a remat step loads
    into cmx;
  * build_task passes the names for spark, genesis and mae and ignores
    them for cmunet and moco, as cmx's;
  * no checkpoint runs without a backward to follow (no_grad, eval mode,
    the CLI's validation replay).
Reduced widths (8,16,32,64), bottleneck 128, 64^2 images, batch 2.
"""

import collections
import copy
import functools
import re
from typing import Any, Sequence

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmx_torch.ckpt import checkpoint as tck
from cmx_torch.ckpt.checkpoint import _kind, _to_flax_layout, from_flax, to_flax

WIDTHS = (8, 16, 32, 64)
BNECK = 128
SIZE = 64
B = 2
LEVELS = {"e1e2d1d2": ("e1", "e2", "d1", "d2"),
          "bneck_e3e4": ("bneck", "e3", "e4"),
          "unknown": ("e9",)}
ABSORBED = re.compile(r"(double_conv|bottleneck)\.conv[01]\.bias$")
# cases of the BN moment variants (CMX_BN_VARIANT) beside the default
# shift_ra: an id -> (a LEVELS key, the variant)
VARIANT_CASES = {"e1e2d1d2_shift_max": ("e1e2d1d2", "shift_max")}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's torch work (the tier-1 run
    shares the cores among its workers)."""
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


def _port_model(kind, dtype, fused, levels):
    from cmx_torch.models.unet import UNet
    from cmx_torch.ssl.spark import SparKModel

    if kind == "spark":
        model = SparKModel(widths=WIDTHS, bottleneck_width=BNECK, dtype=dtype,
                           fused=fused, remat_levels=levels)
    else:
        model = UNet(out_classes=1, widths=WIDTHS, bottleneck=BNECK,
                     dtype=dtype, fused=fused, remat_levels=levels)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model


def _task(kind, model, fused):
    from cmx_torch.ssl.reconstruction import make_mae_task
    from cmx_torch.ssl.spark import make_spark_task

    if kind == "spark":
        return make_spark_task(model, input_size=SIZE, pallas_loss=fused)[0]
    return make_mae_task(model)[0]


def _draws(kind, step):
    from cmx_torch.ops.augment import _crop_window_params
    from cmx_torch.ops.masking import random_patch_mask, spark_active_mask

    g = torch.Generator().manual_seed(step)
    if kind == "mae":
        return {"active": random_patch_mask(g, B, SIZE, 16, 0.5)}
    return {"crop": _crop_window_params(g, B, SIZE, SIZE, SIZE, (0.67, 1.0),
                                       (3 / 4, 4 / 3)),
            "flip": torch.tensor([True, False]),
            "active": spark_active_mask(g, B, SIZE // 16, 0.6)}


def _two_steps(kind, dtype, fused, levels):
    """(first-loss gradients, the two steps' metrics, state_dict, LAMB's
    state, the kernel wrappers' calls) from the same weights, images and
    draws."""
    from cmx_torch.ops import _build
    from cmx_torch.train.optim import make_optimizer
    from cmx_torch.train.state import TrainState
    from cmx_torch.train.trainer import make_train_step

    model = _port_model(kind, dtype, fused, levels)
    task = _task(kind, model, fused)
    imgs = torch.from_numpy(np.random.default_rng(0).normal(
        size=(B, SIZE, SIZE)).astype(np.float32))
    probe = copy.deepcopy(model).train()
    _build.recorded = []
    try:
        loss, _ = _task(kind, probe, fused).loss_fn(probe, imgs, None,
                                                    _draws(kind, 0))
        grads = torch.autograd.grad(loss, list(probe.parameters()))
        calls = collections.Counter(n for n, _ in _build.recorded)
    finally:
        _build.recorded = None
    tx = make_optimizer("lamb", 2e-4, 0.04, clip_norm=5.0,
                        named_params=model.named_parameters())
    state = TrainState.create(model=model, tx=tx)
    step = make_train_step(task, tx)
    metrics = [{k: float(v) for k, v in step(state, imgs,
                                              _draws(kind, i)).items()}
               for i in range(2)]
    return (grads, metrics, model.state_dict(),
            [tx.count] + tx.mu + tx.nu, calls)


@pytest.fixture(scope="module")
def baselines():
    return {}


@pytest.mark.parametrize("levels", list(LEVELS) + list(VARIANT_CASES),
                         ids=list(LEVELS) + list(VARIANT_CASES))
@pytest.mark.parametrize("dtype,fused", [(torch.float32, False),
                                         (torch.bfloat16, True)],
                         ids=["fp32", "bf16_fused"])
@pytest.mark.parametrize("kind", ["spark", "mae"])
def test_remat_steps_equal_steps_without_remat(kind, dtype, fused, levels,
                                               baselines, monkeypatch):
    from cmx_torch.models import blocks
    from cmx_torch.ops import fused_conv as tfc

    # 64^2 images: down1 (64^2) and down2 (32^2) pass the fused gate, as
    # at 256^2 (and, in the MAE UNet, up2 and up1)
    monkeypatch.setattr(tfc, "FUSED_MIN_HW", 32)
    # shift_max: the recompute takes the same subsample max again
    levels, variant = VARIANT_CASES.get(levels, (levels, "shift_ra"))
    monkeypatch.setattr(blocks, "BN_VARIANT", variant)
    key = (kind, dtype, fused, variant)
    if key not in baselines:
        baselines[key] = _two_steps(kind, dtype, fused, ())
    ref = baselines[key]
    got = _two_steps(kind, dtype, fused, LEVELS[levels])
    assert got[1] == ref[1]  # loss, grad norm, ... of both steps
    assert all(torch.equal(a, b) for a, b in zip(got[0], ref[0]))
    assert got[2].keys() == ref[2].keys()
    for name, t in got[2].items():
        assert torch.equal(t, ref[2][name]), name
    assert all(torch.equal(a, b) for a, b in zip(got[3], ref[3]))
    if fused:
        # the recompute runs K1 again at each recomputed fused DoubleConv:
        # down1 and down2, and in the MAE UNet (its decoder fused at these
        # widths: up2's concat is 32 channels) up2 and up1
        extra = {"e1e2d1d2": 4 if kind == "spark" else 8}.get(levels, 0)
        k1, k2 = "flat_conv3x3_mask_stats", "flat_bwd_mega"
        assert got[4][k1] == ref[4][k1] + extra
        assert got[4][k2] == ref[4][k2]


# ------------------------------------------------------------ against cmx


class SmallUNet(fnn.Module):
    """cmx's UNet at reduced widths, one output class, with remat_levels
    passed to both halves as cmx's UNet does."""

    dtype: Any = jnp.float32
    remat_levels: Sequence[str] = ()

    @fnn.compact
    def __call__(self, x):
        from cmx.models.unet import UNetDecoder, UNetEncoder

        h, skips = UNetEncoder(widths=WIDTHS, bottleneck=BNECK,
                               dtype=self.dtype,
                               remat_levels=self.remat_levels,
                               name="encoder")(x)
        return UNetDecoder(out_classes=1, widths=WIDTHS, dtype=self.dtype,
                           remat_levels=self.remat_levels,
                           name="decoder")(h, skips)


CMX_LEVELS = ("e1", "e2", "bneck", "d1", "d2")


def test_spark_remat_matches_cmx():
    """SparK fp32 with remat_levels e1,e2,bneck,d1,d2 in both packages, no
    augmentation, cmx's mask injected: the loss within 1e-4 relative, each
    gradient leaf within 1e-3 of its largest entry (1e-6 of the tree's),
    the BN running statistics after the step's forward and backward within
    atol 1e-5 + rtol 1e-4 of cmx's: the tolerances of the SparK step test."""
    from cmx.ops.masking import spark_active_mask as jmask
    from cmx.ssl.spark import SparKModel as JSparK, make_spark_task as jtask
    from cmx_torch.ssl.spark import SparKModel, make_spark_task

    imgs = np.random.default_rng(1).normal(size=(B, SIZE, SIZE)).astype(
        np.float32)
    jm = JSparK(widths=WIDTHS, bottleneck_width=BNECK, dtype=jnp.float32,
                remat_levels=CMX_LEVELS)
    grid0 = np.ones((1, SIZE // 16, SIZE // 16), np.float32)
    v = _np_tree(jax.jit(jm.init)(jax.random.key(0), imgs[:1], grid0))
    jt, _ = jtask(jm, input_size=SIZE, augment=False)
    state = type("S", (), {"batch_stats": v["batch_stats"]})
    rng = jax.random.key(5)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: jt.loss_fn(p, state, jnp.asarray(imgs), rng),
        has_aux=True))(v["params"])
    km, _ = jax.random.split(rng)
    active = torch.from_numpy(np.asarray(jmask(km, B, SIZE // 16, 0.6)))

    tm = from_flax(SparKModel(widths=WIDTHS, bottleneck_width=BNECK,
                              dtype=torch.float32, remat_levels=CMX_LEVELS),
                   v).train()
    tt, _ = make_spark_task(tm, input_size=SIZE, augment=False)
    loss, _ = tt.loss_fn(tm, torch.from_numpy(imgs), None, {"active": active})
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    assert abs(float(loss.detach()) - float(jl)) <= 1e-4 * abs(float(jl))
    scale = max(float(jnp.max(jnp.abs(g))) for g in jax.tree.leaves(jg))
    for (name, _), g in zip(tm.named_parameters(), grads):
        ref = np.asarray(_leaf(jg, name))
        got = _to_flax_layout(g.numpy(), _kind(tm, name))
        tol = 1e-3 * max(float(np.max(np.abs(ref))), 1e-3 * scale)
        assert float(np.max(np.abs(got - ref))) <= tol, name
    for name, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(),
                                   _leaf(jaux.batch_stats, name),
                                   atol=1e-5, rtol=1e-4, err_msg=name)


def test_mae_remat_matches_cmx():
    """The MAE loss on the reduced-width UNet, fp32, remat_levels
    e1,e2,bneck,d1,d2 in both packages, cmx's mask injected: the loss within
    1e-4 relative, the BN running statistics within 1e-5, each gradient
    leaf within 5e-2 of cmx's in L2 (the BN-absorbed conv biases within
    1e-4 of the tree's largest entry): the MAE step test's tolerances."""
    from cmx.ops.masking import random_patch_mask as jmask
    from cmx.ssl.reconstruction import make_mae_task as jtask
    from cmx_torch.models.unet import UNet
    from cmx_torch.ssl.reconstruction import make_mae_task

    imgs = np.random.default_rng(6).normal(size=(B, 32, 32)).astype(np.float32)
    jm = SmallUNet(remat_levels=CMX_LEVELS)
    v = _np_tree(jax.jit(jm.init)(jax.random.key(0), imgs[:1]))
    state = type("S", (), {"batch_stats": v["batch_stats"]})
    key = jax.random.key(3)
    jt, _ = jtask(jm)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: jt.loss_fn(p, state, jnp.asarray(imgs), key),
        has_aux=True))(v["params"])
    active = torch.from_numpy(np.asarray(jmask(key, B, 32, 16, 0.5)))
    tm = from_flax(UNet(out_classes=1, widths=WIDTHS, bottleneck=BNECK,
                        dtype=torch.float32, remat_levels=CMX_LEVELS),
                   v).train()
    task, _ = make_mae_task(tm)
    loss, _ = task.loss_fn(tm, torch.from_numpy(imgs), None,
                           {"active": active})
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    assert abs(float(loss.detach()) - float(jl)) <= 1e-4 * abs(float(jl))
    for name, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), _leaf(jaux.batch_stats, name),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    scale = max(float(jnp.max(jnp.abs(g))) for g in jax.tree.leaves(jg))
    for (name, _), g in zip(tm.named_parameters(), grads):
        got = _to_flax_layout(g.numpy(), _kind(tm, name))
        ref = np.asarray(_leaf(jg, name))
        if ABSORBED.search(name):
            assert max(np.max(np.abs(got)), np.max(np.abs(ref))) \
                <= 1e-4 * scale, name
            continue
        assert np.linalg.norm(got - ref) <= 5e-2 * np.linalg.norm(ref), name


# ------------------------------------------------------------- the names


def _assert_trees_equal(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert np.array_equal(np.asarray(x, np.float32),
                              np.asarray(y, np.float32)), p


def test_remat_keeps_names_and_checkpoints(tmp_path):
    """to_flax of a remat model has the keys and values of the same model
    without remat; after a remat train step its encoder.npz loads into cmx
    (a SparKModel with the same remat_levels) leaf for leaf."""
    from cmx.ckpt.checkpoint import load_encoder as jload
    from cmx.ssl.spark import SparKModel as JSparK
    from cmx_torch.train.optim import make_optimizer
    from cmx_torch.train.state import TrainState
    from cmx_torch.train.trainer import make_train_step

    levels = LEVELS["e1e2d1d2"] + ("bneck", "e3")
    plain = _port_model("spark", torch.float32, False, ())
    model = _port_model("spark", torch.float32, False, levels)
    _assert_trees_equal(to_flax(model), to_flax(plain))
    assert [n for n, _ in model.named_parameters()] == [
        n for n, _ in plain.named_parameters()]

    tx = make_optimizer("lamb", 2e-4, 0.04,
                        named_params=model.named_parameters())
    state = TrainState.create(model=model, tx=tx)
    imgs = torch.from_numpy(np.random.default_rng(2).normal(
        size=(B, SIZE, SIZE)).astype(np.float32))
    make_train_step(_task("spark", model, False), tx)(
        state, imgs, _draws("spark", 0))
    path = str(tmp_path / "encoder.npz")
    tck.export_encoder(state, path)
    jm = JSparK(widths=WIDTHS, bottleneck_width=BNECK, dtype=jnp.float32,
                remat_levels=levels)
    grid0 = np.ones((1, SIZE // 16, SIZE // 16), np.float32)
    v = _np_tree(jax.jit(jm.init)(jax.random.key(0), imgs[:1].numpy(),
                                  grid0))
    params, bs = jload(path, v["params"], v["batch_stats"])
    ours = to_flax(model)
    _assert_trees_equal({"p": params["encoder"], "b": bs["encoder"]},
                        {"p": ours["params"]["encoder"],
                         "b": ours["batch_stats"]["encoder"]})
    assert not np.array_equal(ours["params"]["encoder"]["down1"]
                              ["double_conv"]["conv0"]["kernel"],
                              to_flax(plain)["params"]["encoder"]["down1"]
                              ["double_conv"]["conv0"]["kernel"])


# -------------------------------------------------------------- build_task


@pytest.mark.parametrize("name", ["spark", "genesis", "mae", "cmunet",
                                  "moco"])
def test_build_task_passes_remat_as_cmx(name, monkeypatch):
    """cmx reads model.remat for spark, genesis and mae (SparK: the encoder
    and the full-UNet decoder) and builds cmunet and moco without it."""
    import cmx_torch.models.unet as unet
    import cmx_torch.ssl.spark as spark
    from cmx_torch.cli.pretrain import build_task
    from cmx_torch.config.config import Config, apply_overrides

    monkeypatch.setattr(spark, "SparKModel", functools.partial(
        spark.SparKModel, widths=WIDTHS, bottleneck_width=BNECK))
    monkeypatch.setattr(unet, "UNet", functools.partial(
        unet.UNet, widths=WIDTHS, bottleneck=BNECK))
    monkeypatch.setattr(unet, "UNetEncoderGAP", functools.partial(
        unet.UNetEncoderGAP, widths=WIDTHS, bottleneck=BNECK))
    cfg = apply_overrides(Config(), [f"task.name={name}",
                                     "model.remat=e1,,d2,bneck,x",
                                     "task.view_size=32"])
    _, model = build_task(cfg, torch.float32, device="cpu")
    levels = {m.remat_levels for m in model.modules()
              if isinstance(m, (unet.UNetEncoder, unet.UNetDecoder))}
    want = ("e1", "d2", "bneck", "x") if name in ("spark", "genesis",
                                                  "mae") else ()
    assert levels == {want}


# ------------------------------------------------- no recompute without grad


def test_no_checkpoint_without_a_backward(monkeypatch):
    """A train-mode forward under no_grad, an eval-mode forward with grad
    and the CLI's validation replay run no checkpoint; the first updates the
    running statistics as the model without remat does, the other two
    leave them as they were."""
    import torch.utils.checkpoint as tuc

    from cmx_torch.cli.pretrain import replay_val_loss
    from cmx_torch.train.state import TrainState

    calls = []
    orig = tuc.checkpoint
    monkeypatch.setattr(tuc, "checkpoint",
                        lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    imgs = torch.from_numpy(np.random.default_rng(3).normal(
        size=(B, SIZE, SIZE)).astype(np.float32))
    draws = _draws("spark", 1)
    models = {lv: _port_model("spark", torch.float32, False, lv)
              for lv in ((), LEVELS["e1e2d1d2"])}
    for lv, model in models.items():
        task = _task("spark", model, False)
        model.train()
        with torch.no_grad():
            task.loss_fn(model, imgs, None, draws)
        before = {n: b.clone() for n, b in model.named_buffers()}
        model.eval()
        loss, _ = task.loss_fn(model, imgs, None, draws)
        loss.backward()
        replay_val_loss(task, TrainState.create(model=model, tx=None), imgs,
                        torch.Generator().manual_seed(0))
        for n, b in model.named_buffers():
            assert torch.equal(b, before[n]), n
    assert not calls
    plain, remat = (dict(m.named_buffers()) for m in models.values())
    assert all(torch.equal(plain[n], b) for n, b in remat.items())
    # and the train-mode step with grad does checkpoint: one call a level
    model = models[LEVELS["e1e2d1d2"]].train()
    _task("spark", model, False).loss_fn(model, imgs, None, draws)[0]
    assert len(calls) == 4
