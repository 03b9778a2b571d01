"""The NHWC fused DoubleConv of cmx_torch (K6-K8) and the BN-ReLU-mask
epilogue (K5) against cmx on the CPU.

The port's wrappers run their plain versions here; cmx's Pallas kernels run
in interpret mode, as tests/test_fused_conv.py runs them. Inputs come from
numpy with a seed. Tolerances, relative to the reference's largest entry:
- K6, K7, K8 at B=2, 32x32 (H a multiple of STRIP), C=16, Cin 16, with
  COMPUTE_DTYPE float32 in both packages: y and dh <= 1e-5, the sums and dW
  <= 1e-4 (the two sides sum in different orders);
- make_patches9: bit-exact;
- FusedDoubleConv's gradients against jax.grad of cmx's fused_double_conv,
  fp32: <= 1e-4; conv-bias gradients whose reference is below 1e-2 (zero,
  or sum(dy), which batch norm makes zero up to rounding) are held below
  1e-2 on both sides, as in cmx's own test;
- bf16 (the module, the SparK step): the margins of tests/test_fused_conv.py,
  outputs and loss 2e-2, BN running stats 5e-2;
- K5: fp32 atol 1e-6, bf16 one bf16 ulp (rel 1e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmx.ops import fused_conv as cfc
from cmx.ops import pallas_ops as cpo
from cmx_torch.ops import _build
from cmx_torch.ops import fused_conv as tfc
from cmx_torch.ops import pallas_ops as tpo

B, H, W, C, CIN = 2, 32, 32, 16, 16


@pytest.fixture
def fp32(monkeypatch):
    monkeypatch.setattr(cfc, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(tfc, "COMPUTE_DTYPE", torch.float32)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1e-12)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _stage(seed, cin=CIN):
    rng = np.random.default_rng(seed)
    m = (rng.random((B, H, W)) > 0.4).astype(np.float32)
    src = rng.normal(size=(B, H, W, cin)).astype(np.float32) * m[..., None]
    w = rng.normal(size=(3, 3, cin, C)).astype(np.float32) * 0.2
    b = rng.normal(size=(C,)).astype(np.float32) * 0.1
    inv = (np.abs(rng.normal(size=(cin,))) + 0.5).astype(np.float32)
    shift = rng.normal(size=(cin,)).astype(np.float32) * 0.3
    return rng, m, src, w, b, inv, shift


def _assert_close(out, ref, tols):
    for name, o, r, tol in zip(("y", "sum", "sumsq"), out, ref, tols):
        assert tuple(o.shape) == tuple(r.shape), name
        assert _rel(o.numpy(), r) <= tol, (name, _rel(o.numpy(), r))


def test_make_patches9_is_bit_exact():
    x = np.random.default_rng(0).normal(size=(B, H, 24)).astype(np.float32)
    ref = np.asarray(cfc.make_patches9(jnp.asarray(x)))
    got = tfc.make_patches9(_t(x)).numpy()
    assert got.shape == ref.shape == (B, H, 24, 9)
    np.testing.assert_array_equal(got, ref)


def test_conv_stem_stats_matches_pallas(fp32):
    rng, m, src, w, b, _, _ = _stage(0, cin=1)
    patches = np.asarray(cfc.make_patches9(jnp.asarray(src[..., 0])))
    w9 = w.reshape(9, C)
    ref = cfc.conv_stem_stats(jnp.asarray(patches), jnp.asarray(m),
                              jnp.asarray(w9), jnp.asarray(b), interpret=True)
    out = tfc.conv_stem_stats(_t(patches), _t(m), _t(w9), _t(b))
    _assert_close(out, ref, (1e-5, 1e-4, 1e-4))


@pytest.mark.parametrize("pre_norm", [False, True])
def test_conv3x3_mask_stats_matches_pallas(fp32, pre_norm):
    _, m, src, w, b, inv, shift = _stage(1)
    if not pre_norm:
        inv = shift = None
    ref = cfc.conv3x3_mask_stats(
        jnp.asarray(src), jnp.asarray(m), jnp.asarray(w), jnp.asarray(b),
        None if inv is None else jnp.asarray(inv),
        None if shift is None else jnp.asarray(shift), interpret=True)
    out = tfc.conv3x3_mask_stats(
        _t(src), _t(m), _t(w), _t(b), None if inv is None else _t(inv),
        None if shift is None else _t(shift))
    _assert_close(out, ref, (1e-5, 1e-4, 1e-4))


@pytest.mark.parametrize("prev_fold", [False, True])
def test_bwd_mega_matches_pallas(fp32, prev_fold):
    rng, m, src, w, b, inv, shift = _stage(2)
    y = rng.normal(size=(B, H, W, C)).astype(np.float32) * m[..., None]
    g = rng.normal(size=(B, H, W, C)).astype(np.float32)
    vecs = [rng.normal(size=(C,)).astype(np.float32) * s
            for s in (1.0, 0.3, 0.2, 0.1, 0.1)]
    vecs[0] = np.abs(vecs[0]) + 0.5  # inv
    var = (np.abs(rng.normal(size=(C,))) + 0.5).astype(np.float32)
    inv1, shift1, mean, s1, s2 = vecs
    nact = np.float32(m.sum())
    pf = (inv, shift) if prev_fold else None
    dh_r, dw_r = cfc.bwd_mega(
        *map(jnp.asarray, (g, y, src, m, inv1, shift1, mean, var, s1, s2,
                           nact, w)),
        prev_fold=None if pf is None else tuple(map(jnp.asarray, pf)),
        interpret=True)
    dh, dw = tfc.bwd_mega(
        *map(_t, (g, y, src, m, inv1, shift1, mean, var, s1, s2)),
        torch.tensor(nact), _t(w),
        prev_fold=None if pf is None else tuple(map(_t, pf)))
    assert tuple(dh.shape) == (B, H, W, CIN) and tuple(dw.shape) == (3, 3, CIN, C)
    assert _rel(dh.numpy(), dh_r) <= 1e-5
    assert _rel(dw.numpy(), dw_r) <= 1e-4


def _double_conv_inputs(cin, seed=3):
    """cmx's tests/test_fused_conv.py::_inputs, as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, cin)).astype(np.float32)
    m = (rng.random((B, H, W)) > 0.4).astype(np.float32)
    params = [
        rng.normal(size=(3, 3, cin, C)).astype(np.float32) * 0.2,
        rng.normal(size=(C,)).astype(np.float32) * 0.1,
        np.full((C,), 1.1, np.float32), np.zeros((C,), np.float32),
        rng.normal(size=(3, 3, C, C)).astype(np.float32) * 0.05,
        rng.normal(size=(C,)).astype(np.float32) * 0.1,
        np.full((C,), 1.2, np.float32), np.full((C,), 0.05, np.float32),
    ]
    probe = rng.normal(size=(B, H, W, C)).astype(np.float32)
    return x * m[..., None], m, params, probe


def _both_grads(x, m, params, probe, x_dtype=torch.float32):
    """(cmx's (out, grads), the port's (out, grads)) of sum(out * probe)."""
    def jloss(*a):
        out, _ = cfc.fused_double_conv(a[0], jnp.asarray(m), *a[1:])
        return jnp.sum(out.astype(jnp.float32) * probe), out

    (_, jout), jg = jax.value_and_grad(
        jloss, argnums=tuple(range(9)), has_aux=True)(
        jnp.asarray(x, jnp.bfloat16 if x_dtype == torch.bfloat16 else None),
        *map(jnp.asarray, params))
    leaves = [_t(x).to(x_dtype).requires_grad_(True)] + [
        _t(p).requires_grad_(True) for p in params]
    out, _ = tfc.fused_double_conv(leaves[0], _t(m), *leaves[1:])
    (out.float() * _t(probe)).sum().backward()
    return (np.asarray(jout, np.float32), [np.asarray(g, np.float32) for g in jg],
            out.detach().float().numpy(), [a.grad.float().numpy() for a in leaves])


NAMES = ["dx", "dw0", "db0", "dg0", "dbe0", "dw1", "db1", "dg1", "dbe1"]


@pytest.mark.parametrize("cin", [1, 3, 16])
def test_fused_double_conv_grads_match_cmx(fp32, cin):
    """All 9 gradient leaves of FusedDoubleConv against jax.grad of cmx's
    fused_double_conv (its custom VJP, K8 in interpret mode), both
    branches of stage 0: Cin >= 8 through K8, Cin < 8 through the plain
    backward -- the K6 stem (Cin 1) and a K7 stage (Cin 3)."""
    jout, jg, out, tg = _both_grads(*_double_conv_inputs(cin))
    assert _rel(out, jout) <= 1e-4
    for name, t, j in zip(NAMES, tg, jg):
        if float(np.max(np.abs(j))) < 1e-2:  # conv biases, absorbed by BN
            assert name in ("db0", "db1") and float(np.max(np.abs(t))) < 1e-2
        else:
            assert _rel(t, j) <= 1e-4, (name, _rel(t, j))


def test_stem_conv_bias_grad_is_sum_dy_in_bf16():
    """bf16: the stem (Cin=1) takes the non-K8 branch in both
    packages, whose conv-bias gradient is sum(dy) -- rounding noise, but not
    zero; stage 1's, through K8, is exactly zero. The port mirrors both.
    sum(dy) cancels to ~1e-4 of its terms, so it is held to rel 0.1; the
    other leaves to the bf16 margin 2e-2."""
    x, m, params, probe = _double_conv_inputs(1, seed=4)
    jout, jg, out, tg = _both_grads(x, m, params, probe, torch.bfloat16)
    assert _rel(out, jout) <= 2e-2
    db0, jdb0 = tg[2], jg[2]
    assert float(np.max(np.abs(jdb0))) > 0.0
    assert float(np.max(np.abs(db0))) > 0.0
    assert _rel(db0, jdb0) <= 0.1
    assert float(np.max(np.abs(tg[6]))) == float(np.max(np.abs(jg[6]))) == 0.0
    for name, t, j in zip(NAMES, tg, jg):
        if name not in ("db0", "db1"):
            assert _rel(t, j) <= 2e-2, (name, _rel(t, j))


@pytest.mark.parametrize("cin", [1, 16])
def test_double_conv_nhwc_matches_cmx_bf16(monkeypatch, cin):
    """DoubleConv(fused=True) with FUSED_IMPL="nhwc" against cmx's
    (fused_impl="nhwc") from the same parameter tree: outputs and running
    stats within the bf16 margins."""
    from cmx.models.blocks import DoubleConv as JDC
    from cmx_torch.ckpt.checkpoint import from_flax
    from cmx_torch.models.blocks import DoubleConv
    from test_torch_port_model import _assert_stats_close, _nchw, _np_tree

    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, H, W, cin)).astype(np.float32)
    mask = (rng.random((B, H, W, 1)) > 0.4).astype(np.float32)
    jm = JDC(C, dtype=jnp.bfloat16, fused=True, fused_min_hw=0,
             fused_impl="nhwc")
    v = _np_tree(jm.init(jax.random.key(2), x, mask))
    out, mut = jm.apply(v, x * mask, mask, mutable=["batch_stats"])
    calls = []
    orig = tfc.fused_double_conv
    monkeypatch.setattr(tfc, "fused_double_conv",
                        lambda *a: (calls.append(a[0].shape), orig(*a))[1])
    monkeypatch.setattr(tfc, "FUSED_MIN_HW", 0)
    monkeypatch.setattr(tfc, "FUSED_IMPL", "nhwc")
    tm = from_flax(DoubleConv(cin, C, torch.bfloat16, fused=True), v).train()
    xin = _nchw(x * mask)
    assert tm.use_fused(xin)
    tout = tm(xin, _nchw(mask))
    assert calls == [(B, H, W, cin)]
    assert tout.shape == (B, C, H, W)
    got = tout.detach().float().numpy().transpose(0, 2, 3, 1)
    assert _rel(got, np.asarray(out, np.float32)) < 2e-2
    _assert_stats_close(tm, mut["batch_stats"], 5e-2)


def test_double_conv_refuses_an_unknown_impl(monkeypatch):
    from cmx_torch.models.blocks import DoubleConv

    monkeypatch.setattr(tfc, "FUSED_MIN_HW", 0)
    dc = DoubleConv(1, 8, torch.bfloat16, fused=True).train()
    x = torch.zeros((1, 1, 32, 32))
    monkeypatch.setattr(tfc, "FUSED_IMPL", "strips")
    with pytest.raises(ValueError, match="strips"):
        dc(x)
    monkeypatch.setattr(tfc, "FUSED_IMPL", "nhwc")  # read at forward time
    assert dc(x).shape == (1, 8, 32, 32)


def test_spark_step_bf16_nhwc_pallas_loss_matches_cmx(monkeypatch):
    """The bf16 SparK step with FUSED_IMPL="nhwc" and pallas_loss against
    cmx's make_train_step (K6/K7/K8 in interpret mode there), cmx's draws
    injected; every fused stage goes through fused_double_conv."""
    from cmx_torch.ops import fused_conv_flat as tff
    from test_torch_port_step import (B as SB, SIZE, WIDTHS, _leaf, _setup,
                                      cmx_step_draws)

    # 64x64 images: down1 (64^2) and down2 (32^2) pass the fused gate
    for mod in (cfc, tfc):
        monkeypatch.setattr(mod, "FUSED_MIN_HW", 32)
        monkeypatch.setattr(mod, "FUSED_IMPL", "nhwc")
    calls, flat_calls = [], []
    orig = tfc.fused_double_conv
    monkeypatch.setattr(tfc, "fused_double_conv",
                        lambda *a: (calls.append(a[0].shape), orig(*a))[1])
    monkeypatch.setattr(tff, "flat_double_conv",
                        lambda *a: flat_calls.append(1))

    imgs, jt, jstate, (jstep, _), tt, tstate, (tstep, _) = _setup(
        torch.bfloat16, fused=True, pallas_loss=True)
    draws = cmx_step_draws(jstate.rng, 0)
    jstate, jm = jstep(jstate, jnp.asarray(imgs))
    tmet = tstep(tstate, torch.from_numpy(imgs), draws)
    assert [tuple(s) for s in calls] == [(SB, SIZE, SIZE, 1),
                                         (SB, SIZE // 2, SIZE // 2, WIDTHS[0])]
    assert flat_calls == []
    jl, tl = float(jm["loss"]), float(tmet["loss"])
    assert np.isfinite(tl) and float(tmet["nonfinite"]) == 0.0
    assert abs(tl - jl) <= 2e-2 * abs(jl)
    for name, b in tstate.model.named_buffers():
        ref = np.asarray(_leaf(jstate.batch_stats, name))
        assert float(np.max(np.abs(b.numpy() - ref))) < 5e-2, name


def _bn_inputs(dtype, seed=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 16, 24, 12)).astype(np.float32) * 2.0
    scale = (rng.normal(size=(12,)) * 0.5 + 1.0).astype(np.float32)
    bias = (rng.normal(size=(12,)) * 0.3).astype(np.float32)
    mask = (rng.random((B, 16, 24, 1)) > 0.4).astype(np.float32)
    jx = jnp.asarray(x, jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    return (jx, jnp.asarray(scale), jnp.asarray(bias), jnp.asarray(mask)), (
        _t(x).to(dtype), _t(scale), _t(bias), _t(mask))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_relu_mask_matches_pallas(dtype):
    jargs, targs = _bn_inputs(dtype)
    ref = np.asarray(cpo.bn_relu_mask_pallas(*jargs, interpret=True),
                     np.float32)
    out = tpo.bn_relu_mask_pallas(*targs)
    assert out.dtype == dtype and tuple(out.shape) == ref.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    else:
        assert _rel(out.float().numpy(), ref) <= 1e-2
    assert float((out[targs[3][..., 0] == 0]).abs().max()) == 0.0


def test_nhwc_wrappers_take_plain_path_only_on_cpu_and_record(fp32):
    """On the CPU the wrappers run the plain versions, count no launch, and
    with recording on leave (name, copies of their arguments)."""
    wrappers = (tfc.conv_stem_stats, tfc.conv3x3_mask_stats, tfc.bwd_mega,
                tpo.bn_relu_mask_pallas)
    before = [fn.launches for fn in wrappers]
    x, m, params, probe = _double_conv_inputs(1, seed=7)
    _, targs = _bn_inputs(torch.float32)
    leaves = [_t(p).requires_grad_(True) for p in params]
    _build.recorded = []
    try:
        out, _ = tfc.fused_double_conv(_t(x), _t(m), *leaves)
        (out * _t(probe)).sum().backward()
        tpo.bn_relu_mask_pallas(*targs)
        calls = _build.recorded
    finally:
        _build.recorded = None
    assert [fn.launches for fn in wrappers] == before
    names = [n for n, _ in calls]
    assert names == ["conv_stem_stats", "conv3x3_mask_stats", "bwd_mega",
                     "bn_relu_mask_pallas"]
    y1, _, _ = tfc.conv3x3_mask_stats(*calls[1][1])
    assert torch.equal(calls[2][1][1], y1)  # K8 reads stage 1's output
    assert calls[2][1][12] is not None  # prev_fold: h recomputed from y0
    np.testing.assert_array_equal(calls[3][1][0].numpy(), targs[0].numpy())
