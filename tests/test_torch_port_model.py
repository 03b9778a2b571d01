"""cmx_torch's modules against cmx's on the CPU, from the same weights
(carried across by cmx_torch.ckpt.checkpoint.from_flax) and the same inputs.

fp32 comparisons use a relative max error <= 1e-4 of the reference's
largest entry (summation order); the fused bf16 DoubleConv uses the bf16
margins of tests/test_fused_conv.py (2e-2 outputs, 5e-2 running stats).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cmx_torch.ckpt.checkpoint import from_flax, to_flax

TOL = 1e-4
WIDTHS = (8, 16, 32, 64)
BNECK = 128


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1e-12)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _nchw(a):
    return torch.from_numpy(np.asarray(a, np.float32).transpose(0, 3, 1, 2).copy())


def _assert_stats_close(torch_module, flax_stats, tol):
    got = to_flax(torch_module)["batch_stats"]
    ref = _np_tree(flax_stats)
    pairs = zip(jax.tree_util.tree_leaves_with_path(ref),
                jax.tree_util.tree_leaves(got))
    n = 0
    for (path, r), g in pairs:
        assert np.max(np.abs(g - r)) <= tol * max(1.0, np.max(np.abs(r))), path
        n += 1
    assert n == len(jax.tree_util.tree_leaves(got)) > 0


@pytest.mark.parametrize("masked", [True, False])
def test_masked_batch_norm_matches_cmx(masked):
    from cmx.models.blocks import MaskedBatchNorm as JBN
    from cmx_torch.models.blocks import MaskedBatchNorm

    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 8, 8, 4)) * 3.0 + 5.0).astype(np.float32)
    mask = (rng.random((2, 8, 8, 1)) > 0.4).astype(np.float32) if masked else None
    bn = JBN(dtype=jnp.float32)
    v = _np_tree(bn.init(jax.random.key(0), x, mask))
    # a non-zero running mean exercises the shift_ra moments
    v["batch_stats"]["mean"] = np.linspace(4.0, 6.0, 4).astype(np.float32)
    out, mut = bn.apply(v, x, mask, mutable=["batch_stats"])

    tbn = from_flax(MaskedBatchNorm(4, torch.float32), v).train()
    tout = tbn(_nchw(x), None if mask is None else _nchw(mask))
    assert _rel(tout.detach().numpy().transpose(0, 2, 3, 1), out) <= TOL
    _assert_stats_close(tbn, mut["batch_stats"], TOL)


def test_double_conv_unfused_matches_cmx():
    from cmx.models.blocks import DoubleConv as JDC
    from cmx_torch.models.blocks import DoubleConv

    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 32, 32, 4)).astype(np.float32)
    mask = (rng.random((2, 32, 32, 1)) > 0.4).astype(np.float32)
    jm = JDC(16, dtype=jnp.float32)
    v = _np_tree(jm.init(jax.random.key(1), x, mask))
    out, mut = jm.apply(v, x * mask, mask, mutable=["batch_stats"])
    tm = from_flax(DoubleConv(4, 16, torch.float32), v).train()
    tout = tm(_nchw(x * mask), _nchw(mask))
    assert _rel(tout.detach().numpy().transpose(0, 2, 3, 1), out) <= TOL
    _assert_stats_close(tm, mut["batch_stats"], TOL)


def test_double_conv_fused_matches_cmx_bf16(monkeypatch):
    """The fused gate picks FlatDoubleConv in both packages; outputs and
    running stats within the bf16 margins."""
    from cmx.models.blocks import DoubleConv as JDC
    from cmx_torch.models.blocks import DoubleConv
    from cmx_torch.ops import fused_conv as tfc

    monkeypatch.setattr(tfc, "FUSED_MIN_HW", 0)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 32, 32, 1)).astype(np.float32)
    mask = (rng.random((2, 32, 32, 1)) > 0.4).astype(np.float32)
    jm = JDC(16, dtype=jnp.bfloat16, fused=True, fused_min_hw=0)
    v = _np_tree(jm.init(jax.random.key(2), x, mask))
    out, mut = jm.apply(v, x * mask, mask, mutable=["batch_stats"])
    tm = from_flax(DoubleConv(1, 16, torch.bfloat16, fused=True), v).train()
    xin = _nchw(x * mask)
    assert tm.use_fused(xin)
    tout = tm(xin, _nchw(mask))
    ref = np.asarray(out, np.float32)
    got = tout.detach().float().numpy().transpose(0, 2, 3, 1)
    assert _rel(got, ref) < 2e-2
    _assert_stats_close(tm, mut["batch_stats"], 5e-2)


def test_unet_encoder_decoder_match_cmx():
    from cmx.models.unet import UNetDecoder as JDec, UNetEncoder as JEnc
    from cmx.ops.masking import upsample_mask as jup
    from cmx_torch.models.unet import UNetDecoder, UNetEncoder

    rng = np.random.default_rng(3)
    imgs = rng.normal(size=(2, 32, 32)).astype(np.float32)
    grid = np.array([[[1, 0], [0, 1]], [[0, 1], [1, 1]]], np.float32)
    mask = np.array(jup(jnp.asarray(grid), 16))
    jenc = JEnc(widths=WIDTHS, bottleneck=BNECK, dtype=jnp.float32)
    ve = _np_tree(jax.jit(jenc.init)(jax.random.key(3), imgs, mask))
    (bott, skips), mut = jax.jit(
        lambda v, x, m: jenc.apply(v, x, m, mutable=["batch_stats"]))(
        ve, imgs, mask)
    tenc = from_flax(UNetEncoder(WIDTHS, BNECK, torch.float32), ve).train()
    tb, tskips = tenc(torch.from_numpy(imgs), torch.from_numpy(mask))
    assert _rel(tb.detach().numpy().transpose(0, 2, 3, 1), bott) <= TOL
    for a, b in zip(tskips, skips):
        assert _rel(a.detach().numpy().transpose(0, 2, 3, 1), b) <= TOL
    _assert_stats_close(tenc, mut["batch_stats"], TOL)

    jdec = JDec(out_classes=1, widths=WIDTHS, dtype=jnp.float32)
    vd = _np_tree(jax.jit(jdec.init)(jax.random.key(4), bott, skips))
    logits, mutd = jax.jit(
        lambda v, x, s: jdec.apply(v, x, s, mutable=["batch_stats"]))(
        vd, bott, skips)
    tdec = from_flax(UNetDecoder(1, WIDTHS, BNECK, torch.float32), vd).train()
    tl = tdec(_nchw(bott), [_nchw(s) for s in skips])
    assert tl.dtype == torch.float32
    assert _rel(tl.detach().numpy().transpose(0, 2, 3, 1), logits) <= TOL
    _assert_stats_close(tdec, mutd["batch_stats"], TOL)


def test_checkpoint_round_trip_and_layouts():
    """from_flax then to_flax gives cmx's SparK tree back exactly, and
    the port's forward equals cmx's from those weights."""
    from cmx.ssl.spark import SparKModel as JSparK
    from cmx_torch.ssl.spark import SparKModel

    rng = np.random.default_rng(4)
    imgs = rng.normal(size=(2, 32, 32)).astype(np.float32)
    grid = np.array([[[1, 0], [0, 1]], [[0, 0], [1, 0]]], np.float32)
    jm = JSparK(widths=WIDTHS, bottleneck_width=BNECK, dtype=jnp.float32)
    v = _np_tree(jax.jit(jm.init)(jax.random.key(5), imgs, grid))
    tm = from_flax(SparKModel(widths=WIDTHS, bottleneck_width=BNECK,
                              dtype=torch.float32), v)
    back = to_flax(tm)
    ref_leaves = jax.tree_util.tree_leaves_with_path(v)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(ref_leaves)
    for path, a in ref_leaves:
        np.testing.assert_array_equal(got[path], a, err_msg=str(path))
    rec, _ = jax.jit(lambda v, x, g: jm.apply(v, x, g,
                                               mutable=["batch_stats"]))(
        v, imgs, grid)
    trec = tm.train()(torch.from_numpy(imgs), torch.from_numpy(grid))
    assert _rel(trec.detach().numpy(), rec) <= TOL


@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_resize_weight_mat_matches_cmx(method):
    from cmx.ops.augment import _resize_weight_mat as jw
    from cmx_torch.ops.augment import _resize_weight_mat

    scales = np.array([0.5, 1.0, 1.3, 2.7], np.float32)
    trans = np.array([3.0, 0.0, -10.5, -40.0], np.float32)
    got = _resize_weight_mat(48, 40, torch.from_numpy(scales),
                             torch.from_numpy(trans), method).numpy()
    for i in range(4):
        ref = np.asarray(jw(48, 40, jnp.float32(scales[i]),
                            jnp.float32(trans[i]), method))
        np.testing.assert_allclose(got[i], ref, rtol=1e-5, atol=1e-6)


def cmx_aug_draws(key, batch, size):
    """The crop windows and flips cmx's spark_pretrain_aug draws under
    vmap_aug(key, ...): split(key, B) -> per sample split -> (k1 crop, k2 flip)."""
    from cmx.ops.augment import _crop_window_params

    crops, flips = [], []
    for k in jax.random.split(key, batch):
        k1, k2 = jax.random.split(k)
        crops.append([float(v) for v in _crop_window_params(
            k1, size, size, size, (0.67, 1.0), (3 / 4, 4 / 3))])
        flips.append(bool(jax.random.uniform(k2) < 0.5))
    return (torch.tensor(crops, dtype=torch.float32), torch.tensor(flips))


def test_spark_pretrain_aug_matches_cmx_with_injected_draws():
    from cmx.ops.augment import spark_pretrain_aug as jaug, vmap_aug
    from cmx_torch.ops.augment import spark_pretrain_aug

    rng = np.random.default_rng(5)
    imgs = rng.normal(size=(6, 48, 48)).astype(np.float32)
    key = jax.random.key(11)
    ref = np.asarray(vmap_aug(jaug, key, jnp.asarray(imgs), 48))
    crop, flip = cmx_aug_draws(key, 6, 48)
    assert flip.any() and not flip.all()
    got = spark_pretrain_aug(torch.from_numpy(imgs), 48, crop=crop, flip=flip)
    assert _rel(got.numpy(), ref) <= TOL


@pytest.mark.parametrize("f,ratio", [(4, 0.6), (16, 0.6), (5, 0.75), (2, 0.99)])
def test_spark_active_mask_keep_counts(f, ratio):
    from cmx.ops.masking import spark_active_mask as jmask
    from cmx_torch.ops.masking import spark_active_mask, upsample_mask

    gen = torch.Generator().manual_seed(0)
    m = spark_active_mask(gen, 5, f, ratio)
    ref = np.asarray(jmask(jax.random.key(0), 5, f, ratio))
    assert tuple(m.shape) == ref.shape
    np.testing.assert_array_equal(m.sum((1, 2)).numpy(), ref.sum((1, 2)))
    assert set(np.unique(m.numpy())) <= {0.0, 1.0}
    up = upsample_mask(m, 3)
    assert tuple(up.shape) == (5, 3 * f, 3 * f)
    assert torch.equal(up[:, ::3, ::3], m)


def _lamb_tree(rng):
    return {
        "conv": {"kernel": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
                 "bias": np.zeros((4,), np.float32)},
        "mask_token0": rng.normal(size=(1, 1, 1, 4)).astype(np.float32) * 0.02,
        "norm": {"scale": np.ones((4,), np.float32)},
    }


@pytest.mark.parametrize("scheduled", [False, True])
def test_lamb_matches_optax(scheduled):
    from cmx.train.optim import make_optimizer as jmake
    from cmx.train.schedules import cosine_anneal as jca, warmup_cosine as jwc
    from cmx_torch.train.optim import make_optimizer
    from cmx_torch.train.schedules import cosine_anneal, warmup_cosine

    rng = np.random.default_rng(6)
    tree = _lamb_tree(rng)
    if scheduled:
        jlr, jwd = jwc(1e-2, 10, 2), jca(0.04, 0.2, 10)
        lr, wd = warmup_cosine(1e-2, 10, 2), cosine_anneal(0.04, 0.2, 10)
    else:
        jlr = lr = 1e-2
        jwd = wd = 0.04
    tx = jmake("lamb", jlr, jwd, clip_norm=5.0, params_example=tree)
    params = jax.tree.map(jnp.asarray, tree)
    opt_state = tx.init(params)
    flat = jax.tree_util.tree_leaves_with_path(tree)
    names = [".".join(k.key for k in path) for path, _ in flat]
    tparams = [torch.from_numpy(a.copy()) for _, a in flat]
    ttx = make_optimizer("lamb", lr, wd, clip_norm=5.0,
                         named_params=list(zip(names, tparams)))
    assert ttx.decay == ["mask_token" not in n and a.ndim >= 2
                         for n, (_, a) in zip(names, flat)]
    for step, gscale in enumerate((1.0, 30.0, 0.5)):  # step 1 is clipped
        grads = jax.tree.map(
            lambda a: (rng.normal(size=a.shape) * gscale).astype(np.float32),
            tree)
        upd, opt_state = tx.update(jax.tree.map(jnp.asarray, grads),
                                   opt_state, params)
        params = optax.apply_updates(params, upd)
        ttx.step([torch.from_numpy(g) for g in jax.tree.leaves(grads)])
        for name, t, (_, r) in zip(names, tparams,
                                   jax.tree_util.tree_leaves_with_path(params)):
            np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{name} @ {step}")


def test_lamb_nonfinite_step_keeps_state():
    from cmx_torch.train.optim import make_optimizer

    p = torch.ones(3, 3)
    tx = make_optimizer("lamb", 1e-2, 0.1, clip_norm=5.0,
                        named_params=[("w", p)])
    tx.step([torch.full((3, 3), 0.5)])
    before = (p.clone(), tx.mu[0].clone(), tx.nu[0].clone(), int(tx.count))
    tx.step([torch.full((3, 3), float("nan"))], finite=torch.tensor(False))
    assert torch.equal(p, before[0]) and torch.equal(tx.mu[0], before[1])
    assert torch.equal(tx.nu[0], before[2]) and int(tx.count) == before[3] == 1


def test_schedules_match_cmx():
    from cmx.train import schedules as js
    from cmx_torch.train import schedules as ts

    for jf, tf in ((js.warmup_cosine(2e-4, 100, 10, 0.01),
                    ts.warmup_cosine(2e-4, 100, 10, 0.01)),
                   (js.cosine_anneal(0.04, 0.2, 100),
                    ts.cosine_anneal(0.04, 0.2, 100))):
        for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
            np.testing.assert_allclose(float(tf(s)), float(jf(s)), rtol=1e-6)
    assert ts.scaled_base_lr(2e-4, 128) == js.scaled_base_lr(2e-4, 128)


def test_config_copy_matches_cmx():
    from cmx.config.config import Config as JConfig, apply_overrides as japply
    from cmx_torch.config.config import Config, apply_overrides

    ov = ["task.name=spark", "model.fused_conv=True", "task.pallas_loss=True",
          "optim.clip_norm=None", "train.batch_size=32"]
    a = japply(JConfig(), ov)
    b = apply_overrides(Config(), ov)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    with pytest.raises(KeyError):
        apply_overrides(Config(), ["task.nope=1"])


def test_build_task_spark_and_gates():
    from cmx_torch.cli.pretrain import build_task
    from cmx_torch.config.config import Config, apply_overrides

    cfg = apply_overrides(Config(), ["task.name=spark", "model.fused_conv=True",
                                     "task.pallas_loss=True"])
    task, model = build_task(cfg, torch.bfloat16, device="cpu")
    assert task.name == "spark"
    assert model.encoder.down1.double_conv.fused
    assert not model.encoder.bottleneck.fused
    assert not model.decoder.up1.double_conv.fused
    assert sum(p.numel() for p in model.parameters()) == 31_048_321
    for name in ("genesis", "mae", "moco", "cmunet"):
        cfg.task.name = name
        with pytest.raises(NotImplementedError):
            build_task(cfg, torch.bfloat16, device="cpu")


def test_cuda_entry_points_raise_without_a_card():
    from cmx_torch import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_ema_update_matches_cmx():
    from cmx.train.state import ema_update as jema
    from cmx_torch.train.state import ema_update

    rng = np.random.default_rng(7)
    ema = [rng.normal(size=(3, 4)).astype(np.float32),
           rng.normal(size=(5,)).astype(np.float32)]
    new = [rng.normal(size=a.shape).astype(np.float32) for a in ema]
    ref = jema([jnp.asarray(a) for a in ema], [jnp.asarray(a) for a in new],
               0.996)
    got = [torch.from_numpy(a.copy()) for a in ema]
    ema_update(got, [torch.from_numpy(a) for a in new], 0.996)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)
