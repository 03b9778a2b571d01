"""The port's optimizers and schedules against cmx's on the CPU.

* AdamW and LARS against cmx's make_optimizer("adamw" / "lars", ...,
  params_example=...) (optax.adamw / optax.lars inside
  inject_hyperparams, cmx's no-decay mask, the global-norm clip) over 5
  steps of the same gradients, a scheduled lr and wd, step 3 non-finite
  (cmx's trainer keeps the old state there, so optax skips that update):
  parameters and optimizer state within 1e-6 relative.
* The layer-wise lr decay scales and their transform against cmx's.
* The five schedules at steps 0, 1, warm-up - 1, warm-up, mid, total and
  total + 5, bit for bit in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

WARMUP, TOTAL = 3, 20
SHAPES = {"down1": {"conv": {"kernel": (3, 3, 2, 4), "bias": (4,)},
                    "norm": {"scale": (4,)}},
          "decoder": {"head": {"kernel": (4, 3)}, "mask_token0": (1, 1, 3)},
          "zero": {"kernel": (2, 2)}}


def _tree(rng):
    return jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32),
                        SHAPES, is_leaf=lambda s: isinstance(s, tuple))


def _names_and_leaves(tree):
    flat = jax.tree_util.tree_leaves_with_path(tree)
    return [".".join(k.key for k in path) for path, _ in flat], \
        [a for _, a in flat]


def _state_leaves(opt_state, name):
    """The optimizer-state leaves of `name` ("mu", "nu" or "trace") in cmx's
    state, in parameter order."""
    found = []

    def visit(node):
        if hasattr(node, name) and not callable(getattr(node, name)):
            found.append(jax.tree.leaves(getattr(node, name)))
        elif isinstance(node, (tuple, list)):
            for n in node:
                visit(n)
        elif hasattr(node, "inner_state"):
            visit(node.inner_state)

    visit(opt_state)
    assert len(found) == 1, (name, len(found))
    return found[0]


@pytest.mark.parametrize("name,clip", [("adamw", 5.0), ("adamw", None),
                                       ("lars", 1.0), ("lars", None)])
def test_optimizer_matches_cmx_with_a_nonfinite_step(name, clip):
    """cmx's make_optimizer(name, warmup_cosine(...), cosine_anneal(...),
    clip_norm, params_example) and the port's on the same gradients for 5
    steps (gradient scales 1e-2 .. 1e2, so the clip acts at some steps); a
    leaf of zeros keeps the trust ratio's zero-norm rule in play; step 3's
    gradients hold a NaN: the port keeps parameters and state (count
    included). Parameters and state within 1e-6 relative (atol 1e-7 for
    parameters near 0, 1e-9 / 1e-12 for the moments)."""
    from cmx.train.optim import make_optimizer as jmake
    from cmx.train.schedules import cosine_anneal as jca, warmup_cosine as jwc
    from cmx_torch.train.optim import make_optimizer
    from cmx_torch.train.schedules import cosine_anneal, warmup_cosine

    rng = np.random.default_rng(4)
    tree = _tree(rng)
    tree["zero"]["kernel"][:] = 0.0
    tx = jmake(name, jwc(1e-2, TOTAL, WARMUP), jca(0.05, 0.2, TOTAL),
               momentum=0.9, clip_norm=clip, params_example=tree)
    params = jax.tree.map(jnp.asarray, tree)
    opt_state = tx.init(params)
    names, leaves = _names_and_leaves(tree)
    tparams = [torch.from_numpy(a.copy()) for a in leaves]
    ttx = make_optimizer(name, warmup_cosine(1e-2, TOTAL, WARMUP),
                         cosine_anneal(0.05, 0.2, TOTAL), momentum=0.9,
                         clip_norm=clip, named_params=list(zip(names, tparams)))
    assert ttx.decay == [a.ndim >= 2 and "mask_token" not in n
                         for n, a in zip(names, leaves)]
    state_names = ("mu", "nu") if name == "adamw" else ("trace",)
    for step in range(5):
        grads = jax.tree.map(
            lambda a: (rng.normal(size=a.shape) * 10.0 ** (step - 2)).astype(
                np.float32), tree)
        finite = step != 3
        gl = jax.tree.leaves(grads)
        if not finite:
            gl[1][0] = np.nan
        else:
            upd, opt_state = tx.update(jax.tree.map(jnp.asarray, grads),
                                       opt_state, params)
            params = jax.tree.map(lambda p, u: p + u, params, upd)
        ttx.step([torch.from_numpy(g) for g in gl], torch.tensor(finite))
        for n, t, r in zip(names, tparams, jax.tree.leaves(params)):
            np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{n} @ {step}")
        for sname, atol in zip(state_names, (1e-9, 1e-12)):
            for n, t, r in zip(names, getattr(ttx, sname),
                               _state_leaves(opt_state, sname)):
                np.testing.assert_allclose(t.numpy(), np.asarray(r),
                                           rtol=1e-6, atol=atol,
                                           err_msg=f"{sname} {n} @ {step}")
    assert int(ttx.count) == 4


def test_optimizer_state_dict_round_trip():
    """A second AdamW / Lars loads the first's state_dict and then steps as
    it does, bit for bit; a state of another optimizer is refused."""
    from cmx_torch.train.optim import make_optimizer

    rng = np.random.default_rng(5)
    grads = [torch.from_numpy(rng.normal(size=(3, 4)).astype(np.float32)),
             torch.from_numpy(rng.normal(size=(4,)).astype(np.float32))]
    for name in ("adamw", "lars"):
        ps = [[torch.ones(3, 4), torch.zeros(4)] for _ in range(2)]
        a, b = (make_optimizer(name, 1e-2, 0.05, named_params=[
            ("w", p[0]), ("b", p[1])]) for p in ps)
        a.step(grads)
        for t, s in zip(ps[1], ps[0]):
            t.copy_(s)
        b.load_state_dict(a.state_dict())
        a.step(grads)
        b.step(grads)
        assert all(torch.equal(x, y) for x, y in zip(ps[0], ps[1]))
        other = make_optimizer("adamw" if name == "lars" else "lars", 1e-2,
                               named_params=[("w", ps[0][0]),
                                             ("b", ps[0][1])])
        with pytest.raises(KeyError):
            b.load_state_dict(other.state_dict())
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("adagrad", 1e-3, named_params=[("w", ps[0][0])])


def test_layer_decay_matches_cmx():
    """layer_lr_decay_scales against cmx's on a UNet-shaped tree (equal
    fp32 values), and scale_by_layer_decay after SGD against cmx's
    optax.chain(make_optimizer("sgd"), scale_by_layer_decay) over 2 steps
    (1e-6 relative)."""
    from cmx.train.optim import (layer_lr_decay_scales as jscales,
                                 make_optimizer as jmake,
                                 scale_by_layer_decay as jlayer)
    import optax

    from cmx_torch.train.optim import (layer_lr_decay_scales,
                                       make_optimizer, scale_by_layer_decay,
                                       unet_layer_id)

    rng = np.random.default_rng(6)
    tree = {"encoder": {f"down{i}": {"w": rng.normal(size=(2, 2)).astype(
        np.float32)} for i in range(1, 5)}}
    tree["encoder"]["bottleneck"] = {"w": np.ones((2, 2), np.float32)}
    tree["projector"] = {"fc0": {"kernel": np.ones((3, 2), np.float32)}}
    names, leaves = _names_and_leaves(tree)
    ref = jax.tree.leaves(jscales(tree, 0.75, num_layers=5))
    got = layer_lr_decay_scales(
        [(n, torch.from_numpy(a)) for n, a in zip(names, leaves)], 0.75, 5)
    assert [float(g) for g in got] == [float(r) for r in ref]
    assert [unet_layer_id(n, 5) for n in names] == [4, 0, 1, 2, 3, 5]

    tx = optax.chain(jmake("sgd", 0.1, 0.01, params_example=tree),
                     jlayer(tree, 0.75))
    params = jax.tree.map(jnp.asarray, tree)
    st = tx.init(params)
    tparams = [torch.from_numpy(a.copy()) for a in leaves]
    named = list(zip(names, tparams))
    ttx = scale_by_layer_decay(make_optimizer("sgd", 0.1, 0.01,
                                              named_params=named), named, 0.75)
    for _ in range(2):
        grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
            np.float32), tree)
        upd, st = tx.update(jax.tree.map(jnp.asarray, grads), st, params)
        params = optax.apply_updates(params, upd)
        ttx.step([torch.from_numpy(g) for g in jax.tree.leaves(grads)])
        for n, t, r in zip(names, tparams, jax.tree.leaves(params)):
            np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-6,
                                       atol=1e-7, err_msg=n)


SCHEDULES = {
    "warmup_cosine": lambda m: m.warmup_cosine(1e-3, TOTAL, WARMUP, 0.01),
    "cosine_anneal": lambda m: m.cosine_anneal(0.04, 0.2, TOTAL),
    "step_decay": lambda m: m.step_decay(1e-2, 7, 0.5),
    "constant": lambda m: m.constant(0.3),
    "ema_momentum_cosine": lambda m: m.ema_momentum_cosine(0.99, 0.996, TOTAL),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_cmx(name):
    """The schedule at steps 0, 1, warm-up - 1, warm-up, mid, total and
    total + 5, given as a Python int and as an int32 tensor (the
    optimizers' count), equal to cmx's in fp32 bit for bit."""
    from cmx.train import schedules as js
    from cmx_torch.train import schedules as ts

    jf, tf = SCHEDULES[name](js), SCHEDULES[name](ts)
    for step in (0, 1, WARMUP - 1, WARMUP, TOTAL // 2, TOTAL, TOTAL + 5):
        ref = np.float32(jf(jnp.int32(step)))
        for arg in (step, torch.tensor(step, dtype=torch.int32)):
            got = tf(arg)
            assert got.dtype == torch.float32
            assert got.numpy() == ref, (name, step, float(got), float(ref))
