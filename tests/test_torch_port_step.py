"""The whole SparK slice: cmx_torch's train step against cmx's
make_train_step, from weights carried across by from_flax and with cmx's
random draws injected into the port (jax.random and torch.Generator differ).

(a) fp32, unfused, two steps. Step 1 runs the whole task, augmentation
    included: per-leaf grads rel <= 1e-3, loss rel <= 1e-4, grad norm rel
    <= 1e-3, parameters within atol 1e-6 + rtol 1e-4. Step 2 feeds both
    sides the batch that cmx's own (jitted) augmentation makes for that
    step, with the mask drawn in the step: loss, grad norm and parameters
    after both steps within the same bounds, BN running stats within atol
    1e-5 + rtol 1e-4. Why step 2 shares the augmented batch: the crop's fp32
    products round differently in cmx's jitted step, in cmx run eagerly and
    in the port (up to 3.7e-5 a pixel at this seed's step-2 draws), and a
    ReLU input of decoder.up4 lies 2.7e-5 from zero there; the gate flips,
    and that leaf's gradient moves by up to 19% of its largest entry. cmx's
    own jitted and eager gradients differ by as much, so entry-wise
    agreement after an augmented step 2 is a property of neither package.
    The biases of the convs that feed a batch norm are held to a bound
    instead: BN absorbs them, their true gradient is 0, and both packages
    move them by rounding noise that Adam normalizes.
(b) bf16, fused DoubleConv + pallas_loss (cmx's Pallas kernels in interpret
    mode, the port's plain versions): loss and BN running stats within the
    bf16 margins of tests/test_fused_conv.py (2e-2, 5e-2).
Reduced widths (8,16,32,64), bottleneck 128, 64x64 images (two fused
levels, as at 256^2), batch 2.
"""

import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cmx_torch.ckpt.checkpoint import _kind, _to_flax_layout, from_flax

WIDTHS = (8, 16, 32, 64)
BNECK = 128
SIZE = 64
B = 2
LR = 2e-4
BN_ABSORBED = re.compile(r"(double_conv|bottleneck)\.conv[01]\.bias$")


def cmx_step_draws(state_rng, step):
    """The draws cmx's SparK step makes at `step`: fold_in(rng, step) ->
    split -> (km mask, ka aug); split(ka, B) -> per sample (k1 crop, k2 flip)."""
    from cmx.ops.augment import _crop_window_params
    from cmx.ops.masking import spark_active_mask

    rng = jax.random.fold_in(state_rng, step)
    km, ka = jax.random.split(rng)
    crops, flips = [], []
    for k in jax.random.split(ka, B):
        k1, k2 = jax.random.split(k)
        crops.append([float(v) for v in _crop_window_params(
            k1, SIZE, SIZE, SIZE, (0.67, 1.0), (3 / 4, 4 / 3))])
        flips.append(bool(jax.random.uniform(k2) < 0.5))
    active = np.array(spark_active_mask(km, B, SIZE // 16, 0.6))
    return {"crop": torch.tensor(crops, dtype=torch.float32),
            "flip": torch.tensor(flips), "active": torch.from_numpy(active)}


def _setup(dtype, fused, pallas_loss):
    from cmx.ssl.spark import SparKModel as JSparK, make_spark_task as jtask
    from cmx.train.optim import make_optimizer as jopt
    from cmx.train.state import TrainState as JState
    from cmx.train.trainer import make_train_step as jstepf
    from cmx_torch.ssl.spark import SparKModel, make_spark_task
    from cmx_torch.train.optim import make_optimizer
    from cmx_torch.train.state import TrainState
    from cmx_torch.train.trainer import make_train_step

    imgs = np.random.default_rng(0).normal(size=(B, SIZE, SIZE)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jm = JSparK(widths=WIDTHS, bottleneck_width=BNECK, dtype=jdt, fused=fused)
    jt, _ = jtask(jm, input_size=SIZE, pallas_loss=pallas_loss)
    jt_batch, _ = jtask(jm, input_size=SIZE, pallas_loss=pallas_loss,
                        augment=False)
    grid0 = np.ones((1, SIZE // 16, SIZE // 16), np.float32)
    v = jax.jit(jm.init)(jax.random.key(0), imgs[:1], grid0)
    v = jax.tree.map(lambda a: np.asarray(a, np.float32), v)
    jtx = jopt("lamb", LR, 0.04, clip_norm=5.0, params_example=v["params"])
    jstate = JState.create(params=v["params"], batch_stats=v["batch_stats"],
                           tx=jtx, rng=jax.random.key(7))
    tm = from_flax(SparKModel(widths=WIDTHS, bottleneck_width=BNECK,
                              dtype=dtype, fused=fused), v)
    tt, _ = make_spark_task(tm, input_size=SIZE, pallas_loss=pallas_loss)
    tt_batch, _ = make_spark_task(tm, input_size=SIZE,
                                  pallas_loss=pallas_loss, augment=False)
    ttx = make_optimizer("lamb", LR, 0.04, clip_norm=5.0,
                         named_params=tm.named_parameters())
    tstate = TrainState.create(model=tm, tx=ttx)
    # steps of the whole task and of the task fed an augmented batch
    jsteps = [jstepf(t, jtx, donate=False) for t in (jt, jt_batch)]
    tsteps = [make_train_step(t, ttx) for t in (tt, tt_batch)]
    return imgs, jt, jstate, jsteps, tt, tstate, tsteps


def _leaf(tree, dotted_name):
    for k in dotted_name.split("."):
        tree = tree[k]
    return tree


def test_spark_step_fp32_unfused_matches_cmx():
    imgs, jt, jstate, (jstep, jstep_batch), tt, tstate, (tstep, tstep_batch) \
        = _setup(torch.float32, fused=False, pallas_loss=False)
    timgs = torch.from_numpy(imgs)

    # gradients of the first step, leaf by leaf
    rng0 = jax.random.fold_in(jstate.rng, 0)
    jgrads = jax.jit(jax.grad(lambda p: jt.loss_fn(
        p, jstate, jnp.asarray(imgs), rng0)[0]))(jstate.params)
    model = copy.deepcopy(tstate.model).train()
    loss, _ = tt.loss_fn(model, timgs, None, cmx_step_draws(jstate.rng, 0))
    names = [n for n, _ in model.named_parameters()]
    tgrads = torch.autograd.grad(loss, list(model.parameters()))
    scale = max(float(jnp.max(jnp.abs(g))) for g in jax.tree.leaves(jgrads))
    for name, g in zip(names, tgrads):
        ref = np.asarray(_leaf(jgrads, name))
        got = _to_flax_layout(g.numpy(), _kind(model, name))
        tol = 1e-3 * max(float(np.max(np.abs(ref))), 1e-3 * scale)
        assert float(np.max(np.abs(got - ref))) <= tol, name

    # step 1: the whole task; step 2: cmx's augmented batch on both sides
    from cmx.ops.augment import spark_pretrain_aug, vmap_aug

    augment = jax.jit(lambda k, x: vmap_aug(spark_pretrain_aug, k, x, SIZE))
    for step in range(2):
        draws = cmx_step_draws(jstate.rng, step)
        if step == 0:
            jstate, jm = jstep(jstate, jnp.asarray(imgs))
            tmet = tstep(tstate, timgs, draws)
        else:
            _, ka = jax.random.split(jax.random.fold_in(jstate.rng, step))
            batch = np.array(augment(ka, jnp.asarray(imgs)))
            jstate, jm = jstep_batch(jstate, jnp.asarray(batch))
            tmet = tstep_batch(tstate, torch.from_numpy(batch),
                               {"active": draws["active"]})
        assert abs(float(tmet["loss"]) - float(jm["loss"])) \
            <= 1e-4 * abs(float(jm["loss"]))
        assert float(tmet["nonfinite"]) == 0.0
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3)
        _assert_params_close(tstate.model, jstate.params, step + 1)
    assert tstate.step == int(jstate.step) == 2
    for name, b in tstate.model.named_buffers():
        np.testing.assert_allclose(b.numpy(),
                                   np.asarray(_leaf(jstate.batch_stats, name)),
                                   atol=1e-5, rtol=1e-4, err_msg=name)


def _assert_params_close(model, params, steps):
    for name, p in model.named_parameters():
        ref = np.asarray(_leaf(params, name))
        got = _to_flax_layout(p.detach().numpy(), _kind(model, name))
        if BN_ABSORBED.search(name):
            # zero-initialized, true gradient 0: at step 1 the trust ratio is
            # 1 and Adam moves each entry by at most lr; after that LAMB moves
            # b by lr * |b| (|.| the L2 norm) at most
            bound = LR * (1 + LR * np.sqrt(got.size)) ** (steps - 1)
            assert np.max(np.abs(got)) <= bound and np.max(np.abs(ref)) <= bound
            continue
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-4,
                                   err_msg=name)


def test_spark_step_nan_guard_keeps_state():
    """A step whose loss is not finite keeps parameters, LAMB's state and the
    BN running stats (cmx/train/trainer.py:72-83) and still counts the step."""
    from cmx_torch.ssl.spark import SparKModel, make_spark_task
    from cmx_torch.train.optim import make_optimizer
    from cmx_torch.train.state import TrainState
    from cmx_torch.train.trainer import make_train_step

    model = SparKModel(widths=WIDTHS, bottleneck_width=BNECK,
                       dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(0))
    task, _ = make_spark_task(model, input_size=32)
    tx = make_optimizer("lamb", LR, 0.04, clip_norm=5.0,
                        named_params=model.named_parameters())
    state = TrainState.create(model=model, tx=tx)
    step = make_train_step(task, tx)
    imgs = torch.from_numpy(
        np.random.default_rng(1).normal(size=(B, 32, 32)).astype(np.float32))
    assert float(step(state, imgs)["nonfinite"]) == 0.0

    def snapshot():
        return ([t.clone() for t in model.state_dict().values()]
                + [t.clone() for t in tx.mu + tx.nu] + [tx.count.clone()])

    before = snapshot()
    bad = imgs.clone()
    bad[0, 0, 0] = float("nan")
    met = step(state, bad)
    assert float(met["nonfinite"]) == 1.0 and not np.isfinite(float(met["loss"]))
    assert all(torch.equal(a, b) for a, b in zip(snapshot(), before))
    assert state.step == 2
    met = step(state, imgs)
    assert float(met["nonfinite"]) == 0.0 and int(tx.count) == 2


def test_spark_step_bf16_fused_pallas_loss_matches_cmx(monkeypatch):
    from cmx.ops import fused_conv as cfc
    from cmx_torch.ops import fused_conv as tfc
    from cmx_torch.ops import fused_conv_flat as tff
    from cmx_torch.ops import pallas_ops as tpo

    # 64x64 images: down1 (64^2) and down2 (32^2) pass the fused gate
    monkeypatch.setattr(cfc, "FUSED_MIN_HW", 32)
    monkeypatch.setattr(tfc, "FUSED_MIN_HW", 32)
    calls = []
    orig = tff.flat_double_conv
    monkeypatch.setattr(tff, "flat_double_conv",
                        lambda *a: (calls.append(a[0].shape), orig(*a))[1])
    loss_calls = []
    orig_loss = tpo.spark_loss_pallas_trainable
    monkeypatch.setattr(tpo, "spark_loss_pallas_trainable",
                        lambda *a: (loss_calls.append(1), orig_loss(*a))[1])

    imgs, jt, jstate, (jstep, _), tt, tstate, (tstep, _) = _setup(
        torch.bfloat16, fused=True, pallas_loss=True)
    draws = cmx_step_draws(jstate.rng, 0)
    jstate, jm = jstep(jstate, jnp.asarray(imgs))
    tmet = tstep(tstate, torch.from_numpy(imgs), draws)
    assert [tuple(s) for s in calls] == [(B, 1, SIZE * SIZE),
                                         (B, WIDTHS[0], (SIZE // 2) ** 2)]
    assert loss_calls == [1]
    jl, tl = float(jm["loss"]), float(tmet["loss"])
    assert np.isfinite(tl) and float(tmet["nonfinite"]) == 0.0
    assert abs(tl - jl) <= 2e-2 * abs(jl)
    for name, b in tstate.model.named_buffers():
        ref = np.asarray(_leaf(jstate.batch_stats, name))
        assert float(np.max(np.abs(b.numpy() - ref))) < 5e-2, name
