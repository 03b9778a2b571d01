"""The MoCo v2 slice: cmx_torch's modules and train step against cmx's, on
the CPU, from weights and task state carried across (ckpt.checkpoint) and
with cmx's random draws injected into the port.

* UNetEncoderGAP at full width, 32^2 images, batch 2, fp32: rel <= 1e-4.
* Sgd against make_optimizer("sgd", ..., params_example=...): 3 steps, a
  scheduled lr, 1-D leaves (no decay there): rtol 1e-5.
* The whole step, narrow (a test-local flax module wrapping cmx's
  UNetEncoder(widths (8,16,32,64), bottleneck 128) and the fp32 mean, given
  to cmx's make_moco_task), 48^2 images, 32^2 views, batch 2, queue K=8,
  key encoder weights different from the online ones:
  - fp32, crop_impl None: loss rel <= 1e-4, each gradient leaf rel <= 1e-3
    of its largest entry (the conv biases that feed a BN have a true
    gradient of 0: both sides are held below 1e-5 of the largest gradient
    entry instead), and after the step parameters, key parameters
    (EMA), key BN running stats, queue and pointer (atol 1e-6 + rtol 1e-4);
  - bf16, crop_impl "pallas" (cmx's K4 in interpret mode, the port's plain
    version): loss within 2e-2 relative (bf16 rounds at other places in
    the two frameworks).
* Validation against cmx's make_moco_validate (eval-mode encoders, K4).
* A non-finite step keeps parameters, SGD's state and all of `extra`;
  K % B != 0 raises; build_task("moco") runs the EMA at 0.999 whatever
  task.ema_momentum says, as cmx's does.
"""

import copy
import dataclasses
import re
from typing import Any

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmx_torch.ckpt.checkpoint import (_kind, _to_flax_layout, from_flax,
                                       moco_extra_from_flax, moco_extra_to_flax)
from test_torch_port_crop import cmx_view_draws

WIDTHS = (8, 16, 32, 64)
BNECK = 128
SIZE, VIEW, B, K = 48, 32, 2, 8
LR, WD = 0.03, 1e-4
BN_ABSORBED = re.compile(r"(double_conv|bottleneck)\.conv[01]\.bias$")


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1e-12)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _leaf(tree, dotted):
    for k in dotted.split("."):
        tree = tree[k]
    return tree


class GapEncoder(fnn.Module):
    """cmx's UNetEncoderGAP with the encoder's widths exposed."""

    dtype: Any = jnp.float32
    use_running_average: bool = False

    @fnn.compact
    def __call__(self, x):
        from cmx.models.unet import UNetEncoder

        h, _ = UNetEncoder(widths=WIDTHS, bottleneck=BNECK, dtype=self.dtype,
                           use_running_average=self.use_running_average,
                           name="encoder")(x)
        return jnp.mean(h.astype(jnp.float32), axis=(1, 2))


def test_unet_encoder_gap_full_width_matches_cmx():
    from cmx.models.unet import UNetEncoderGAP as JGAP
    from cmx_torch.models.unet import UNetEncoderGAP

    imgs = np.random.default_rng(0).normal(size=(2, 32, 32)).astype(np.float32)
    jm = JGAP(dtype=jnp.float32)
    v = _np_tree(jax.jit(jm.init)(jax.random.key(0), imgs))
    ref, mut = jax.jit(lambda v, x: jm.apply(v, x, mutable=["batch_stats"]))(
        v, imgs)
    tm = from_flax(UNetEncoderGAP(dtype=torch.float32), v).train()
    got = tm(torch.from_numpy(imgs))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 1024)
    assert _rel(got.detach().numpy(), ref) <= 1e-4
    for name, b in tm.named_buffers():
        ref_b = np.asarray(_leaf(mut["batch_stats"], name))
        assert _rel(b.numpy(), ref_b) <= 1e-4, name


def test_sgd_matches_optax():
    from cmx.train.optim import make_optimizer as jmake
    from cmx.train.schedules import warmup_cosine as jwc
    from cmx_torch.train.optim import make_optimizer
    from cmx_torch.train.schedules import warmup_cosine

    rng = np.random.default_rng(1)
    tree = {"conv": {"kernel": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
                     "bias": rng.normal(size=(4,)).astype(np.float32)},
            "norm": {"scale": np.ones((4,), np.float32)}}
    tx = jmake("sgd", jwc(0.03, 10, 2), 1e-2, momentum=0.9,
               params_example=tree)
    params = jax.tree.map(jnp.asarray, tree)
    opt_state = tx.init(params)
    flat = jax.tree_util.tree_leaves_with_path(tree)
    names = [".".join(k.key for k in path) for path, _ in flat]
    tparams = [torch.from_numpy(a.copy()) for _, a in flat]
    ttx = make_optimizer("sgd", warmup_cosine(0.03, 10, 2), 1e-2,
                         momentum=0.9, named_params=list(zip(names, tparams)))
    assert ttx.decay == [a.ndim >= 2 for _, a in flat]
    for step in range(3):
        grads = jax.tree.map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), tree)
        upd, opt_state = tx.update(jax.tree.map(jnp.asarray, grads),
                                   opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, upd)
        ttx.step([torch.from_numpy(g) for g in jax.tree.leaves(grads)])
        for name, t, r in zip(names, tparams, jax.tree.leaves(params)):
            np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{name} @ {step}")
    assert int(ttx.count) == 3


def _setup(dtype, crop_impl, rotation_method=None):
    """cmx's step and the port's from the same weights and task state."""
    from cmx.ssl.moco import make_moco_task as jtask
    from cmx.train.optim import make_optimizer as jopt
    from cmx.train.state import TrainState as JState
    from cmx.train.trainer import make_train_step as jstepf
    from cmx_torch.models.unet import UNetEncoderGAP
    from cmx_torch.ssl.moco import make_moco_task
    from cmx_torch.train.optim import make_optimizer
    from cmx_torch.train.state import TrainState
    from cmx_torch.train.trainer import make_train_step

    rng = np.random.default_rng(2)
    imgs = (rng.normal(size=(B, SIZE, SIZE)) + 1.0).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jm = GapEncoder(dtype=jdt)
    jt, _ = jtask(jm, num_negatives=K, view_size=VIEW, crop_impl=crop_impl,
                  rotation_method=rotation_method)
    init = jax.jit(jm.init)
    v = _np_tree(init(jax.random.key(0), imgs[:1, :VIEW, :VIEW]))
    vk = _np_tree(init(jax.random.key(1), imgs[:1, :VIEW, :VIEW]))
    # a queue of earlier keys (the key encoder's embeddings of other
    # images), so that negatives compete with the positive and the loss is
    # of order log(K + 1), as in training
    others = rng.normal(size=(K, VIEW, VIEW)).astype(np.float32) + 1.0
    queue, _ = jax.jit(lambda v, x: jm.apply(v, x, mutable=["batch_stats"]))(
        vk, others)
    queue = np.asarray(queue, np.float32)
    jextra = {"key_params": vk["params"], "key_batch_stats": vk["batch_stats"],
              "queue": queue / np.linalg.norm(queue, axis=1, keepdims=True),
              "queue_ptr": np.int32(0)}
    jtx = jopt("sgd", LR, WD, momentum=0.9, params_example=v["params"])
    jstate = JState.create(params=v["params"], batch_stats=v["batch_stats"],
                           tx=jtx, extra=jax.tree.map(jnp.asarray, jextra),
                           rng=jax.random.key(7))

    def port_model():
        return UNetEncoderGAP(WIDTHS, BNECK, dtype)

    tm = from_flax(port_model(), v)
    tt, _ = make_moco_task(tm, num_negatives=K, view_size=VIEW,
                           crop_impl=crop_impl,
                           rotation_method=rotation_method)
    ttx = make_optimizer("sgd", LR, WD, momentum=0.9,
                         named_params=tm.named_parameters())
    textra = moco_extra_from_flax(port_model(), jextra)
    tstate = TrainState.create(model=tm, tx=ttx, extra=textra)
    return (imgs, jt, jstate, jstepf(jt, jtx, donate=False), tt, tstate,
            make_train_step(tt, ttx))


def cmx_step_draws(state_rng, step, shape):
    """cmx's step draws: fold_in(rng, step) -> split -> (kq, kk) views."""
    kq, kk = jax.random.split(jax.random.fold_in(state_rng, step))
    return {"q": cmx_view_draws(kq, shape, VIEW),
            "k": cmx_view_draws(kk, shape, VIEW)}


def test_moco_step_fp32_matches_cmx():
    imgs, jt, jstate, jstep, tt, tstate, tstep = _setup(torch.float32, None)
    timgs = torch.from_numpy(imgs)
    draws = cmx_step_draws(jstate.rng, 0, imgs.shape)

    # gradients, leaf by leaf (on copies: the forward moves BN stats)
    rng0 = jax.random.fold_in(jstate.rng, 0)
    jgrads = jax.jit(jax.grad(lambda p: jt.loss_fn(
        p, jstate, jnp.asarray(imgs), rng0)[0]))(jstate.params)
    model = copy.deepcopy(tstate.model).train()
    loss, _ = tt.loss_fn(model, timgs, None, draws,
                         copy.deepcopy(tstate.extra))
    names = [n for n, _ in model.named_parameters()]
    scale = max(float(jnp.max(jnp.abs(g))) for g in jax.tree.leaves(jgrads))
    for name, g in zip(names, torch.autograd.grad(loss, list(
            model.parameters()))):
        ref = np.asarray(_leaf(jgrads, name))
        got = _to_flax_layout(g.numpy(), _kind(model, name))
        if BN_ABSORBED.search(name):
            # BN absorbs these biases: their true gradient is 0, and both
            # packages give rounding noise
            bound = 1e-5 * scale
            assert np.max(np.abs(got)) <= bound >= np.max(np.abs(ref)), name
        else:
            assert _rel(got, ref) <= 1e-3, (name, _rel(got, ref))

    jstate, jmet = jstep(jstate, jnp.asarray(imgs))
    tmet = tstep(tstate, timgs, draws)
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
    got_extra = moco_extra_to_flax(tstate.extra)
    ref_extra = _np_tree(jstate.extra)
    for key in ("key_params", "key_batch_stats"):
        pairs = zip(jax.tree_util.tree_leaves_with_path(ref_extra[key]),
                    jax.tree.leaves(got_extra[key]))
        for (path, r), g in pairs:
            np.testing.assert_allclose(g, r, err_msg=f"{key} {path}", **close)
    np.testing.assert_allclose(got_extra["queue"], ref_extra["queue"], **close)
    assert int(got_extra["queue_ptr"]) == int(jstate.extra["queue_ptr"]) == B
    assert tstate.step == int(jstate.step) == 1


def test_moco_step_bf16_pallas_crop_matches_cmx():
    from cmx_torch.ops import pallas_crop as tpc

    imgs, _, jstate, jstep, _, tstate, tstep = _setup(torch.bfloat16,
                                                      "pallas")
    calls = []
    orig = tpc.crop_resize_pallas
    tpc.crop_resize_pallas = lambda *a: (calls.append(a[0].shape), orig(*a))[1]
    try:
        tmet = tstep(tstate, torch.from_numpy(imgs),
                     cmx_step_draws(jstate.rng, 0, imgs.shape))
    finally:
        tpc.crop_resize_pallas = orig
    assert [tuple(s) for s in calls] == [(B, SIZE, SIZE)] * 2  # q and k views
    jstate, jmet = jstep(jstate, jnp.asarray(imgs))
    tl, jl = float(tmet["loss"]), float(jmet["loss"])
    assert np.isfinite(tl) and float(tmet["nonfinite"]) == 0.0
    assert abs(tl - jl) <= 2e-2 * abs(jl)
    assert int(tstate.extra["queue_ptr"]) == B


def test_moco_validate_matches_cmx():
    from cmx.ssl.moco import make_moco_validate as jval
    from cmx_torch.ssl.moco import init_val_queue, make_moco_validate

    imgs, _, jstate, _, _, tstate, _ = _setup(torch.float32, "pallas")
    vq = init_val_queue(torch.Generator().manual_seed(0), K, BNECK)
    key = jax.random.key(9)
    kq, kk = jax.random.split(key)
    jmet, jq = jval(GapEncoder(), view_size=VIEW, crop_impl="pallas")(
        jstate, {k: jnp.asarray(v.numpy()) for k, v in vq.items()},
        jnp.asarray(imgs), key)
    draws = {"q": cmx_view_draws(kq, imgs.shape, VIEW),
             "k": cmx_view_draws(kk, imgs.shape, VIEW)}
    before = vq["queue"].clone()
    tmet, tq = make_moco_validate(tstate.model, view_size=VIEW,
                                  crop_impl="pallas")(
        tstate, vq, torch.from_numpy(imgs), draws=draws)
    assert torch.equal(vq["queue"], before) and tstate.model.training
    for k in ("val_loss", "val_acc1", "val_acc5"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-4)
    np.testing.assert_allclose(tq["queue"].numpy(), np.asarray(jq["queue"]),
                               atol=1e-6, rtol=1e-4)
    assert int(tq["queue_ptr"]) == int(jq["queue_ptr"]) == B


def _snapshot(state):
    x = state.extra
    return ([t.clone() for t in state.model.state_dict().values()]
            + [t.clone() for t in state.opt.trace] + [state.opt.count.clone()]
            + [t.clone() for t in x["key_model"].state_dict().values()]
            + [x["queue"].clone(), x["queue_ptr"].clone()])


def test_moco_nonfinite_step_keeps_params_sgd_state_and_extra():
    imgs, _, _, _, _, tstate, tstep = _setup(torch.float32, "pallas")
    timgs = torch.from_numpy(imgs)
    assert float(tstep(tstate, timgs)["nonfinite"]) == 0.0
    before = _snapshot(tstate)
    bad = timgs.clone()
    bad[0, 10, 10] = float("nan")
    met = tstep(tstate, bad)
    assert float(met["nonfinite"]) == 1.0 and not np.isfinite(float(met["loss"]))
    assert all(torch.equal(a, b) for a, b in zip(_snapshot(tstate), before))
    assert tstate.step == 2
    assert float(tstep(tstate, timgs)["nonfinite"]) == 0.0
    assert int(tstate.opt.count) == 2 and int(tstate.extra["queue_ptr"]) == 4


def test_moco_queue_not_divisible_by_batch_raises():
    from cmx_torch.models.unet import UNetEncoderGAP
    from cmx_torch.ssl.moco import make_moco_task

    model = UNetEncoderGAP(WIDTHS, BNECK, torch.float32)
    task, _ = make_moco_task(model, num_negatives=K, view_size=VIEW)
    extra = task.init_extra(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="divisible"):
        task.loss_fn(model, torch.zeros((3, SIZE, SIZE)),
                     torch.Generator(), None, extra)


def test_build_task_moco_ignores_task_ema_momentum_as_cmx():
    from cmx.cli.pretrain import build_task as jbuild
    from cmx.config.config import Config as JConfig, apply_overrides as japply
    from cmx_torch.cli.pretrain import build_task
    from cmx_torch.config.config import Config, apply_overrides
    from cmx_torch.train.optim import make_optimizer
    from cmx_torch.train.state import TrainState
    from cmx_torch.train.trainer import make_train_step

    ov = ["task.name=moco", "task.ema_momentum=0.5", "task.num_negatives=8",
          "task.view_size=16", "task.crop_impl=pallas", "data.image_size=32"]
    jtask = jbuild(japply(JConfig(), ov), jnp.float32)[0]
    cells = dict(zip(jtask.post_update.__code__.co_freevars,
                     (c.cell_contents for c in jtask.post_update.__closure__)))
    assert cells["ema_momentum"] == 0.999

    task, model = build_task(apply_overrides(Config(), ov), torch.float32,
                             device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 18_849_984
    extra = task.init_extra(torch.Generator().manual_seed(0))
    key_model = extra["key_model"]
    assert extra["queue"].shape == (8, 1024)
    old = [p.detach().clone() for p in model.parameters()]
    tx = make_optimizer("sgd", 0.03, 1e-4, named_params=model.named_parameters())
    state = TrainState.create(model=model, tx=tx, extra=extra)
    imgs = torch.from_numpy(
        np.random.default_rng(3).normal(size=(2, 32, 32)).astype(np.float32))
    assert float(make_train_step(task, tx)(state, imgs)["nonfinite"]) == 0.0
    moved = max(float((p.detach() - o).abs().max())
                for p, o in zip(model.parameters(), old))
    assert moved > 1e-4
    for pk, o, p in zip(key_model.parameters(), old, model.parameters()):
        # the key encoder started as a copy: one EMA step at m = 0.999
        torch.testing.assert_close(pk, 0.999 * o + (1.0 - 0.999) * p,
                                   rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("name", ["genesis", "genesis_tuned", "mae",
                                  "mae_tuned", "moco", "moco_fast", "spark",
                                  "cmunet"])
def test_presets_copy_matches_cmx(name):
    from cmx.config.config import Config as JConfig, to_dict
    from cmx.config.presets import PRESETS as JPRESETS
    from cmx_torch.config.config import Config
    from cmx_torch.config.presets import PRESETS

    assert set(PRESETS) == set(JPRESETS)
    port = dataclasses.asdict(PRESETS[name](Config()))
    assert port["train"].pop("trace_spans") is False  # the port's own key
    assert port == to_dict(JPRESETS[name](JConfig()))
