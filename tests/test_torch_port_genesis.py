"""Model Genesis against cmx on the CPU.

* Every distortion of cmx_torch.ops.genesis against cmx/ops/genesis.py, run
  eagerly at 64^2 on seven images whose keys reach every branch (flips
  along both axes, both Bezier sort branches, the gates both ways,
  in-painting stopping at different blocks, out-painting keeping 1 and 5
  blocks), with the draws of cmx's key tree injected: bit for bit, except
  the fit remap, which solves an ill-conditioned 10x10 system in another
  order: within 1e-4 of each image's intensity span.
* genesis_draws' own arithmetic (the randint bounds that depend on other
  draws) against cmx's ranges; genesis_batch at batch 4 against cmx's
  jitted genesis_batch (compiled once, in a module fixture).
* make_genesis_task: two SGD steps in fp32 against cmx's make_train_step
  with cmx's distorted pairs injected into both, and the fused bf16 UNet
  (FUSED_MIN_HW patched to 32) against cmx's Pallas kernels in interpret
  mode; build_task for genesis and genesis_tuned; the pretrain CLI with
  --task genesis --preset at small widths, its encoder.npz read by cmx.
Reduced widths through cmx's UNetEncoder/UNetDecoder (which take
`widths`); random variable trees from jax.eval_shape (cmx's jitted init
compiles for seconds). Tolerances are stated in each test.
"""

import functools
import os
import re
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from cmx_torch.ckpt.checkpoint import _kind, _to_flax_layout, from_flax, to_flax

H = 64
# Keys whose draws reach every branch (test_keys_reach_every_branch).
SEEDS = (3, 13, 23, 25, 32, 164, 18)
WIDTHS = (8, 16, 32, 64)
BNECK = 128
B = 4  # genesis_batch and the steps
LR = 1e-2  # the genesis preset's SGD
# Biases of convs that feed a batch norm: BN absorbs them, their true
# gradient is 0, and both packages move them by rounding noise only.
BN_ABSORBED = re.compile(r"(double_conv|bottleneck)\.conv[01]\.bias$")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's torch work (the tier-1 run
    shares the cores among its workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cmx_exact_draws(key, h, w):
    """The exact shuffle's draws for one image (genesis_distort's key)."""
    kl = jax.random.split(key, 7)[1]
    d = {}
    for i, t in enumerate((4, 8, 5, 10, 2)):
        ko, ks = jax.random.split(jax.random.fold_in(kl, i))
        d[f"shuffle_shift{i}"] = np.asarray(jax.random.randint(ko, (2,), 0, t))
        d[f"shuffle_keys{i}"] = np.asarray(jax.random.uniform(
            ks, (-(-h // t), -(-w // t), t * t)))
    return d


def cmx_draws(key, h, w):
    """The raw draws cmx's genesis_distort(key, img) makes for one (h, w)
    image, by its key tree, in genesis_draws' names (the exact shuffle's
    apart: cmx_exact_draws)."""
    kf, kl, kn, kp1, kp2, kin, kout = jax.random.split(key, 7)
    uni = jax.random.uniform
    d = {}
    flips, k = [], kf
    for i in range(3):
        kd, ka, k = jax.random.split(jax.random.fold_in(k, i), 3)
        flips.append([uni(kd), uni(ka)])
    d["flip_u"] = np.array(flips, np.float32)
    d["shuffle_u"] = np.float32(uni(jax.random.fold_in(kl, 99)))
    r = max(h // 50, 2)
    koff, ksel = jax.random.split(jax.random.fold_in(kl, 1))
    d["shuffle_offs"] = np.asarray(jax.random.randint(koff, (8, 2), -r, r + 1))
    d["shuffle_sel"] = np.asarray(jax.random.randint(ksel, (h, w), 0, 8))
    kp, kb = jax.random.split(kn)
    d["nonlinear_u"] = np.float32(uni(kp))
    d["bezier_u"] = np.array([uni(k) for k in jax.random.split(kb, 5)],
                             np.float32)
    d["paint_u"] = np.float32(uni(kp1))
    d["inpaint_u"] = np.float32(uni(kp2))
    cols = {k: [] for k in ("cont_u", "sx", "sy", "x0", "y0", "noise")}
    for i in range(5):
        kc, kb, knoise = jax.random.split(jax.random.fold_in(kin, i), 3)
        k1, k2, k3, k4 = jax.random.split(kb, 4)
        sx = jax.random.randint(k1, (), h // 6, h // 3 + 1)
        sy = jax.random.randint(k2, (), w // 6, w // 3 + 1)
        cols["cont_u"].append(uni(kc))
        cols["sx"].append(sx)
        cols["sy"].append(sy)
        cols["x0"].append(jax.random.randint(k3, (), 3,
                                             jnp.maximum(h - sx - 3, 4)))
        cols["y0"].append(jax.random.randint(k4, (), 3,
                                             jnp.maximum(w - sy - 3, 4)))
        cols["noise"].append(uni(knoise, (h, w)))
    for k, v in cols.items():
        d["inpaint_" + k] = np.asarray(jnp.stack(v))
    cols = {k: [] for k in ("cont_u", "rx", "ry", "x0", "y0")}
    for i in range(5):
        kc, kb = jax.random.split(jax.random.fold_in(kout, i))
        if i:
            cols["cont_u"].append(uni(kc))
        lo = 2 if i == 0 else 3
        k1, k2, k3, k4 = jax.random.split(kb, 4)
        rx = jax.random.randint(k1, (), lo * h // 7, 4 * h // 7 + 1)
        ry = jax.random.randint(k2, (), lo * w // 7, 4 * w // 7 + 1)
        cols["rx"].append(rx)
        cols["ry"].append(ry)
        cols["x0"].append(jax.random.randint(k3, (), 3,
                                             jnp.maximum(h - (h - rx) - 3, 4)))
        cols["y0"].append(jax.random.randint(k4, (), 3,
                                             jnp.maximum(w - (w - ry) - 3, 4)))
    for k, v in cols.items():
        d["outpaint_" + k] = np.asarray(jnp.stack(v))
    d["outpaint_noise"] = np.asarray(uni(jax.random.fold_in(kout, 77), (h, w)))
    return d


def _leaf(tree, dotted):
    for k in dotted.split("."):
        tree = tree[k]
    return tree


def _stack(draws):
    return {k: torch.from_numpy(np.stack([np.asarray(d[k]) for d in draws]))
            for k in draws[0]}


@functools.lru_cache(maxsize=None)
def _cases(exact_shuffle=False):
    """(the per-image keys, seven images of 64^2, the draws of each as
    numpy arrays, and the draws stacked as tensors; with `exact_shuffle`
    the exact shuffle's draws too)."""
    keys = [jax.random.key(s) for s in SEEDS]
    if exact_shuffle:
        _, imgs, draws, _ = _cases()
        draws = [{**d, **cmx_exact_draws(k, H, H)}
                 for k, d in zip(keys, draws)]
        return keys, imgs, draws, _stack(draws)
    imgs = np.random.default_rng(0).normal(size=(len(SEEDS), H, H)).astype(
        np.float32) * 2.0 + 1.0
    draws = [cmx_draws(k, H, H) for k in keys]
    return keys, imgs, draws, _stack(draws)


def _subkeys(keys, i):
    """cmx's i-th split of genesis_distort's key, per image (0 flips, 1
    shuffle, 2 remap, 5 in-painting, 6 out-painting)."""
    return [jax.random.split(k, 7)[i] for k in keys]


def _cmx_each(fn, keys, imgs, **kw):
    return np.stack([np.asarray(fn(k, jnp.asarray(im), **kw))
                     for k, im in zip(keys, imgs)])


def _span(imgs):
    return imgs.reshape(len(imgs), -1).max(1) - imgs.reshape(
        len(imgs), -1).min(1)


def test_keys_reach_every_branch():
    """The seven keys cover: a flip along H and one along W; the Bezier
    sort-both coin both ways; the shuffle and remap gates both ways (at
    their default rates); painted and unpainted, in- and out-painted;
    in-painting stopping after 0, 2, 3 and 5 blocks; out-painting keeping 1
    and 5 blocks."""
    d = _cases()[3]
    u = d["flip_u"]
    applied = u[:, :, 0] < 0.4
    assert (applied & (u[:, :, 1] < 0.5)).any()
    assert (applied & (u[:, :, 1] >= 0.5)).any()
    for name, p in (("bezier_u", None), ("shuffle_u", 0.5),
                    ("nonlinear_u", 0.9), ("paint_u", 0.9),
                    ("inpaint_u", 0.2)):
        hit = d[name][:, 4] < 0.5 if p is None else d[name] < p
        assert hit.any() and (~hit).any(), name
    paint = d["paint_u"] < 0.9
    assert (paint & (d["inpaint_u"] < 0.2)).any()
    assert (paint & (d["inpaint_u"] >= 0.2)).any()
    blocks_in = torch.cumprod((d["inpaint_cont_u"] < 0.95).int(), 1).sum(1)
    assert {0, 2, 3, 5} <= set(blocks_in.tolist())
    blocks_out = 1 + torch.cumprod((d["outpaint_cont_u"] < 0.95).int(),
                                   1).sum(1)
    assert {1, 5} <= set(blocks_out.tolist())


def test_paired_random_flip_matches_cmx():
    """x and y flipped jointly, bit for bit, at the default rate 0.4."""
    from cmx.ops.genesis import paired_random_flip as jflip
    from cmx_torch.ops.genesis import paired_random_flip

    keys, imgs, _, d = _cases()
    x = torch.from_numpy(imgs)
    tx, ty = paired_random_flip(x, x.clone(), d, prob=0.4)
    ref = [jflip(k, jnp.asarray(im), jnp.asarray(im), prob=0.4)
           for k, im in zip(_subkeys(keys, 0), imgs)]
    assert np.array_equal(tx.numpy(), np.stack([np.asarray(r[0]) for r in ref]))
    assert np.array_equal(ty.numpy(), np.stack([np.asarray(r[1]) for r in ref]))
    assert not np.array_equal(tx.numpy(), imgs)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("prob", [1.0, 0.5])
def test_local_pixel_shuffling_matches_cmx(exact, prob):
    """The fast shuffle (one gather from each pixel's source index, against
    cmx's 8 rolled copies) and the exact tile permutations, bit for bit, at
    prob 1 and at the default 0.5 (the gate both ways)."""
    from cmx.ops.genesis import local_pixel_shuffling as jshuf
    from cmx_torch.ops.genesis import local_pixel_shuffling

    keys, imgs, _, d = _cases(exact)
    got = local_pixel_shuffling(torch.from_numpy(imgs), d, prob=prob,
                                exact=exact)
    ref = _cmx_each(jshuf, _subkeys(keys, 1), imgs, prob=prob, exact=exact)
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("exact", [True, False])
def test_nonlinear_transformation_matches_cmx(exact):
    """The Bezier remap at prob 1 and at the default 0.9: the exact path
    (jnp.interp as searchsorted, cmx's FMA rounding kept) bit for bit; the
    fit path (the degree-9 Chebyshev least squares) within 1e-4 of each
    image's span (its 10x10 normal equations are ill-conditioned in fp32,
    so LAPACK's and torch's coefficients differ; measured 3.4e-6)."""
    from cmx.ops.genesis import nonlinear_transformation as jnl
    from cmx_torch.ops.genesis import nonlinear_transformation

    keys, imgs, _, d = _cases()
    tol = 0.0 if exact else 1e-4 * _span(imgs)[:, None, None]
    for prob in (1.0, 0.9):
        got = nonlinear_transformation(torch.from_numpy(imgs), d, prob=prob,
                                       exact=exact).numpy()
        ref = _cmx_each(jnl, _subkeys(keys, 2), imgs, prob=prob, exact=exact)
        assert np.all(np.abs(got - ref) <= tol)


def test_bezier_lut_and_a_constant_image_match_cmx():
    """The sampled curve (jnp.linspace as XLA computes it, iota times
    fp32(1/1023); the stable argsort, both sort branches) bit for bit; a
    constant image (vmin = vmax, span clamped to 1e-8) comes out finite and
    equal to cmx's through both remap paths."""
    from cmx.ops import genesis as jg
    from cmx_torch.ops import genesis as tg

    keys, imgs, draws, d = _cases()
    for k, im, dr in zip(_subkeys(keys, 2), imgs, draws):
        kb = jax.random.split(k)[1]
        xs, ys = jg._bezier_lut(kb, jnp.min(im), jnp.max(im))
        txs, tys = tg._bezier_lut(torch.from_numpy(dr["bezier_u"])[None],
                                  torch.tensor([[im.min()]]),
                                  torch.tensor([[im.max()]]))
        assert np.array_equal(txs[0].numpy(), np.asarray(xs))
        assert np.array_equal(tys[0].numpy(), np.asarray(ys))
    flat = np.full((1, H, H), 0.375, np.float32)
    one = {k: v[:1] for k, v in d.items()}
    for exact in (False, True):
        got = tg.nonlinear_transformation(torch.from_numpy(flat), one,
                                          prob=1.0, exact=exact).numpy()
        ref = np.asarray(jg.nonlinear_transformation(
            _subkeys(keys, 2)[0], jnp.asarray(flat[0]), prob=1.0,
            exact=exact))
        assert np.all(np.isfinite(got)) and np.array_equal(got[0], ref)


def test_in_and_out_painting_match_cmx():
    """In-painting (up to 5 noise blocks, each while the continue-draws
    hit) and out-painting (noise outside 1-5 kept blocks), bit for bit."""
    from cmx.ops import genesis as jg
    from cmx_torch.ops import genesis as tg

    keys, imgs, _, d = _cases()
    x = torch.from_numpy(imgs)
    assert np.array_equal(tg.image_in_painting(x, d).numpy(), _cmx_each(
        jg.image_in_painting, _subkeys(keys, 5), imgs))
    assert np.array_equal(tg.image_out_painting(x, d).numpy(), _cmx_each(
        jg.image_out_painting, _subkeys(keys, 6), imgs))


def test_genesis_distort_matches_cmx():
    """The whole chain at the default rates: y bit for bit, x within 1e-4
    of each image's span (the fit remap; every other step bit for bit)."""
    from cmx.ops.genesis import genesis_distort as jdist
    from cmx_torch.ops.genesis import genesis_distort

    keys, imgs, _, d = _cases()
    x, y = genesis_distort(torch.from_numpy(imgs), d)
    ref = [jdist(k, jnp.asarray(im)) for k, im in zip(keys, imgs)]
    rx = np.stack([np.asarray(r[0]) for r in ref])
    assert np.array_equal(y.numpy(), np.stack([np.asarray(r[1]) for r in ref]))
    assert np.all(np.abs(x.numpy() - rx)
                  <= 1e-4 * _span(imgs)[:, None, None])


def test_genesis_draws_follow_cmx_ranges():
    """genesis_draws from a torch generator (512 images of 64^2): each
    integer inside cmx's randint range, the bounds that depend on another
    draw included (in-painting's x0 in [3, max(H - sx - 3, 4)), out-
    painting's in [3, max(r - 3, 4))), each range's both ends reached;
    uniforms in [0, 1); injected draws kept as given."""
    from cmx_torch.ops.genesis import genesis_draws

    n = 512
    gen = torch.Generator().manual_seed(0)
    fixed = torch.full((n, 5), 12)
    d = genesis_draws(gen, n, H, H, {"inpaint_sx": fixed}, exact_shuffle=True)
    assert d["inpaint_sx"] is fixed

    def spans(v, lo, hi):
        assert bool(((v >= lo) & (v < hi)).all())
        assert bool((v == lo).any()) and bool((v == hi - 1).any())

    spans(d["shuffle_offs"], -2, 3)
    spans(d["shuffle_sel"], 0, 8)
    spans(d["inpaint_sy"], H // 6, H // 3 + 1)
    for name, t in (("shuffle_shift0", 4), ("shuffle_shift3", 10)):
        spans(d[name], 0, t)
    spans(d["outpaint_rx"][:, 0], 2 * H // 7, 4 * H // 7 + 1)
    spans(d["outpaint_rx"][:, 1:], 3 * H // 7, 4 * H // 7 + 1)
    for x0, hi in ((d["inpaint_x0"], torch.clamp(H - fixed - 3, min=4)),
                   (d["inpaint_y0"], torch.clamp(H - d["inpaint_sy"] - 3,
                                                 min=4)),
                   (d["outpaint_x0"], torch.clamp(d["outpaint_rx"] - 3,
                                                  min=4))):
        assert bool(((x0 >= 3) & (x0 < hi)).all())
        assert bool((x0 == 3).any()) and bool((x0 == hi - 1).any())
    for name in ("flip_u", "bezier_u", "inpaint_noise", "outpaint_noise"):
        assert float(d[name].min()) >= 0.0 and float(d[name].max()) < 1.0
    assert d["shuffle_keys2"].shape == (n, 13, 13, 25)


@pytest.fixture(scope="module")
def cmx_pairs():
    """cmx's jitted genesis_batch at the default rates (one compile for the
    module) and the batch-4 images."""
    from cmx.ops.genesis import genesis_batch as jbatch

    imgs = np.random.default_rng(1).normal(size=(B, H, H)).astype(np.float32)
    return jax.jit(jbatch), imgs


def test_genesis_batch_matches_cmx(cmx_pairs):
    """genesis_batch on 4 images with the draws of split(key, 4) injected,
    against cmx's jitted genesis_batch: y bit for bit, x within 1e-4 of
    each image's span."""
    from cmx_torch.ops.genesis import genesis_batch

    jbatch, imgs = cmx_pairs
    key = jax.random.key(5)
    rx, ry = jbatch(key, jnp.asarray(imgs))
    draws = _stack([cmx_draws(k, H, H) for k in jax.random.split(key, B)])
    x, y = genesis_batch(torch.from_numpy(imgs), None, draws)
    assert np.array_equal(y.numpy(), np.asarray(ry))
    assert np.all(np.abs(x.numpy() - np.asarray(rx))
                  <= 1e-4 * _span(imgs)[:, None, None])


# ---------------------------------------------------------------- the task


class SmallUNet(fnn.Module):
    """cmx's UNet(out_classes=1) at reduced widths: its UNetEncoder and
    UNetDecoder (which take `widths`), `fused` passed to both as cmx's UNet
    does."""

    dtype: Any = jnp.float32
    fused: bool = False

    @fnn.compact
    def __call__(self, x):
        from cmx.models.unet import UNetDecoder, UNetEncoder

        h, skips = UNetEncoder(widths=WIDTHS, bottleneck=BNECK,
                               dtype=self.dtype, fused=self.fused,
                               name="encoder")(x)
        return UNetDecoder(out_classes=1, widths=WIDTHS, dtype=self.dtype,
                           fused=self.fused, name="decoder")(h, skips)


def _variables(module, *args, seed=0):
    """A random variable tree of the flax `module` (shapes from
    jax.eval_shape): kernels N(0, 1/fan_in), biases and running means
    N(0, 0.1^2), scales and running variances 1 + 0.1 |N|, fp32."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        z = rng.standard_normal(shape).astype(np.float32)
        if name == "kernel":
            return z / np.float32(np.sqrt(np.prod(shape[:-1])))
        if name in ("scale", "var"):
            return 1.0 + 0.1 * np.abs(z)
        return 0.1 * z

    shapes = jax.eval_shape(module.init, jax.random.key(0), *args)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port_unet(v, dtype, fused=False):
    from cmx_torch.models.unet import UNet

    return from_flax(UNet(1, WIDTHS, BNECK, dtype, fused), v).train()


def test_genesis_two_sgd_steps_fp32_match_cmx(cmx_pairs, monkeypatch):
    """make_genesis_task on the reduced UNet, fp32, batch 4, SGD lr 1e-2
    momentum 0.9 (the preset's), two steps through each package's
    make_train_step. cmx's pairs for step s come from its jitted
    genesis_batch(fold_in(rng, s)) and are injected into both: the port's
    through draws {"x", "y"}, cmx's by feeding the stacked pair through a
    genesis_batch patched to unstack it. Each step's loss within 1e-5
    relative; after both steps every parameter leaf within 5e-2 of cmx's
    movement in L2 (cmx's fp32 CPU gradients stray from float64 by a few
    1e-2 in down1, as test_mae_fp32_matches_cmx records), the BN-absorbed
    conv biases (true gradient 0, moved by rounding only) within 1e-6, and
    the BN running stats within 1e-4."""
    import cmx.ssl.reconstruction as jrec
    from cmx.train.optim import make_optimizer as jopt
    from cmx.train.state import TrainState as JState
    from cmx.train.trainer import make_train_step as jstepf
    from cmx_torch.ssl.reconstruction import make_genesis_task
    from cmx_torch.train.optim import make_optimizer
    from cmx_torch.train.state import TrainState
    from cmx_torch.train.trainer import make_train_step

    jbatch, imgs = cmx_pairs
    monkeypatch.setattr(jrec, "genesis_batch",
                        lambda rng, pair, **rates: (pair[..., 0],
                                                    pair[..., 1]))
    jm = SmallUNet()
    v = _variables(jm, imgs[:1], seed=7)
    jt, _ = jrec.make_genesis_task(jm)
    jtx = jopt("sgd", LR, 0.0, momentum=0.9, params_example=v["params"])
    jstate = JState.create(params=v["params"], batch_stats=v["batch_stats"],
                           tx=jtx, rng=jax.random.key(11))
    jstep = jstepf(jt, jtx, donate=False)
    tm = _port_unet(v, torch.float32)
    task, _ = make_genesis_task(tm)
    tx = make_optimizer("sgd", LR, 0.0, momentum=0.9,
                        named_params=tm.named_parameters())
    state = TrainState.create(model=tm, tx=tx)
    tstep = make_train_step(task, tx)
    for s in range(2):
        x, y = jbatch(jax.random.fold_in(jstate.rng, s), jnp.asarray(imgs))
        jstate, jm_ = jstep(jstate, jnp.stack([x, y], -1))
        m = tstep(state, torch.from_numpy(imgs),
                  {"x": torch.from_numpy(np.asarray(x)),
                   "y": torch.from_numpy(np.asarray(y))})
        assert abs(float(m["loss"]) - float(jm_["loss"])) \
            <= 1e-5 * abs(float(jm_["loss"]))
        assert float(m["mse"]) == float(m["loss"])
    for name, p in tm.named_parameters():
        got = _to_flax_layout(p.detach().numpy(), _kind(tm, name))
        ref = np.asarray(_leaf(jstate.params, name))
        if BN_ABSORBED.search(name):  # rounding noise times lr: ~1e-10
            assert np.max(np.abs(got - ref)) <= 1e-6, name
            continue
        moved = np.linalg.norm(ref - _leaf(v["params"], name))
        assert np.linalg.norm(got - ref) <= 5e-2 * moved, name
    for name, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), _leaf(jstate.batch_stats, name),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_genesis_fused_bf16_matches_cmx(cmx_pairs, monkeypatch):
    """The Genesis loss on the fused bf16 UNet (FUSED_IMPL "flat": the
    port's K1/K2 plain versions, cmx's Pallas kernels in interpret mode),
    reduced widths, 64^2, batch 2, FUSED_MIN_HW patched to 32 in both
    packages (down1, down2, up2 and up1 fused: K1 8 and K2 8 calls), cmx's
    distorted pair injected: the loss within 2e-2 relative and the BN
    running stats within 5e-2 (phase 3's bf16 margins in chip_smoke.py)."""
    import cmx.ssl.reconstruction as jrec
    from cmx.ops import fused_conv as cfc
    from cmx_torch.ops import _build
    from cmx_torch.ops import fused_conv as tfc
    from cmx_torch.ssl.reconstruction import make_genesis_task

    jbatch, imgs = cmx_pairs
    monkeypatch.setattr(cfc, "FUSED_MIN_HW", 32)
    monkeypatch.setattr(tfc, "FUSED_MIN_HW", 32)
    monkeypatch.setattr(_build, "recorded", [])
    monkeypatch.setattr(jrec, "genesis_batch",
                        lambda rng, pair, **rates: (pair[..., 0],
                                                    pair[..., 1]))
    x, y = (np.asarray(a)[:2] for a in jbatch(jax.random.key(2),
                                              jnp.asarray(imgs)))
    jm = SmallUNet(dtype=jnp.bfloat16, fused=True)
    v = _variables(jm, imgs[:1], seed=8)
    jt, _ = jrec.make_genesis_task(jm)
    state = type("S", (), {"batch_stats": v["batch_stats"]})
    jl, jaux = jax.jit(lambda p: jt.loss_fn(p, state, jnp.stack([x, y], -1),
                                            jax.random.key(0)))(v["params"])
    tm = _port_unet(v, torch.bfloat16, fused=True)
    task, _ = make_genesis_task(tm)
    loss, _ = task.loss_fn(tm, torch.from_numpy(imgs[:2]), None, {
        "x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    loss.backward()
    names = [n for n, _ in _build.recorded]
    assert names.count("flat_conv3x3_mask_stats") == 8
    assert names.count("flat_bwd_mega") == 8
    assert abs(float(loss) - float(jl)) <= 2e-2 * abs(float(jl))
    for name, b in tm.named_buffers():
        ref = np.asarray(_leaf(jaux.batch_stats, name))
        assert float(np.max(np.abs(b.numpy() - ref))) <= 5e-2, name


@pytest.mark.parametrize("name", ["genesis", "genesis_tuned"])
def test_build_task_genesis_as_cmx(name, monkeypatch):
    """PRESETS[name] equal to cmx's field for field; build_task makes the
    genesis task (genesis_tuned resolves to it with the remap's rate 0) on
    UNet(out_classes=1) (at full width, 31 042 369 parameters, for
    genesis; at reduced widths for genesis_tuned), with model.fused_conv
    passed to both halves (down1, down2 and up1 through the fused gate at
    256^2), every task.genesis_* rate reaching the loss, and SGD from
    make_optimizer."""
    import dataclasses

    import cmx_torch.models.unet as unet
    from cmx.config.config import Config as JConfig, to_dict
    from cmx.config.presets import PRESETS as JPRESETS
    from cmx_torch.cli.pretrain import build_task
    from cmx_torch.config.config import Config, apply_overrides
    from cmx_torch.config.presets import PRESETS
    from cmx_torch.train.optim import Sgd, make_optimizer

    cfg = PRESETS[name](Config())
    port = dataclasses.asdict(cfg)
    assert port["train"].pop("trace_spans") is False  # the port's own key
    assert port == to_dict(JPRESETS[name](JConfig()))
    apply_overrides(cfg, ["model.fused_conv=True"])
    if name == "genesis_tuned":
        monkeypatch.setattr(unet, "UNet", functools.partial(
            unet.UNet, widths=WIDTHS, bottleneck=BNECK))
    task, model = build_task(cfg, torch.bfloat16, device="cpu")
    assert task.name == "genesis"
    if name == "genesis":
        assert sum(p.numel() for p in model.parameters()) == 31_042_369
    assert model.decoder.head.kernel.shape[0] == 1
    assert model.encoder.down1.double_conv.fused
    assert model.decoder.up1.double_conv.fused
    assert not model.encoder.bottleneck.fused
    cells = dict(zip(task.loss_fn.__code__.co_freevars,
                     (c.cell_contents for c in task.loss_fn.__closure__)))
    t = cfg.task
    assert cells["rates"] == dict(
        flip_rate=t.genesis_flip_rate, local_rate=t.genesis_local_rate,
        nonlinear_rate=t.genesis_nonlinear_rate,
        paint_rate=t.genesis_paint_rate,
        inpaint_rate=t.genesis_inpaint_rate)
    assert cells["rates"]["nonlinear_rate"] == (0.0 if name.endswith("tuned")
                                                else 0.9)
    assert isinstance(make_optimizer(cfg.optim.name, cfg.optim.lr,
                                     named_params=model.named_parameters()),
                      Sgd)


def test_cli_genesis_preset_on_the_cpu(tmp_path, monkeypatch):
    """python -m cmx_torch.cli.pretrain --device cpu --task genesis --preset
    at small widths (16 synthetic images of 64^2, batch 4, fp32, one
    epoch, validation on): finite losses in log.jsonl, and its encoder.npz
    loads through cmx's load_encoder into cmx's tree with every leaf equal
    to the port's final encoder, bit for bit."""
    import json

    import cmx_torch.models.unet as unet
    from cmx.ckpt.checkpoint import load_encoder as jload
    from cmx_torch.cli.pretrain import main

    monkeypatch.setattr(unet, "UNet", functools.partial(
        unet.UNet, widths=WIDTHS, bottleneck=BNECK))
    out = main(["--device", "cpu", "--task", "genesis", "--preset",
                "data.synthetic=True", "data.synthetic_n=16",
                f"data.image_size={H}", "train.batch_size=4",
                "model.dtype=float32", "train.epochs=1",
                "train.val_fraction=0.25",
                f"data.data_dir={tmp_path / 'data'}",
                f"train.ckpt_dir={tmp_path / 'ckpt'}"])
    assert out["val_batches"] >= 1 and out["state"].step >= 1
    with open(os.path.join(out["ckpt_dir"], "log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    assert len(log) == 1 and np.isfinite(log[0]["loss"]) \
        and np.isfinite(log[0]["val_loss"])
    v = _variables(SmallUNet(), np.zeros((1, H, H), np.float32))
    params, bs = jload(out["encoder"], v["params"], v["batch_stats"])
    ours = to_flax(out["state"].model)
    for tree, mine in ((params, ours["params"]), (bs, ours["batch_stats"])):
        la = jax.tree_util.tree_leaves_with_path(tree["encoder"])
        lb = jax.tree_util.tree_leaves_with_path(mine["encoder"])
        assert [p for p, _ in la] == [p for p, _ in lb]
        assert all(np.array_equal(np.asarray(a), b)
                   for (_, a), (_, b) in zip(la, lb))
