"""cmx_torch's kernels (plain versions, on the CPU) against cmx's Pallas
kernels run in interpret mode, in fp32.

K1 flat_conv3x3_mask_stats, K2 flat_bwd_mega (and the whole FlatDoubleConv
backward, all 9 gradient leaves), K3 spark_loss_pallas and its gradient.
Tolerance: relative max error <= 1e-4 of the reference's largest entry; the
two sides sum in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmx.ops import fused_conv as cfc
from cmx.ops import fused_conv_flat as cff
from cmx.ops import pallas_ops as cpo
from cmx_torch.ops import fused_conv as tfc
from cmx_torch.ops import fused_conv_flat as tff
from cmx_torch.ops import pallas_ops as tpo

TOL = 1e-4


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


def _stage_inputs(seed, B=2, H=32, W=32, cin=8, C=16):
    rng = np.random.default_rng(seed)
    m = (rng.random((B, 1, H * W)) > 0.4).astype(np.float32)
    src = rng.normal(size=(B, cin, H * W)).astype(np.float32) * m
    w = rng.normal(size=(3, 3, cin, C)).astype(np.float32) * 0.2
    b = rng.normal(size=(C,)).astype(np.float32) * 0.1
    inv = (np.abs(rng.normal(size=(cin,))) + 0.5).astype(np.float32)
    shift = rng.normal(size=(cin,)).astype(np.float32) * 0.3
    return rng, m, src, w, b, inv, shift


@pytest.mark.parametrize("pre_norm", [False, True])
@pytest.mark.parametrize("cin", [1, 8])
def test_flat_conv3x3_mask_stats_matches_pallas(pre_norm, cin):
    _, m, src, w, b, inv, shift = _stage_inputs(0, cin=cin)
    if not pre_norm:
        inv = shift = None
    H = W = 32
    ref = cff.flat_conv3x3_mask_stats(
        jnp.asarray(src), jnp.asarray(m), jnp.asarray(w), jnp.asarray(b), H, W,
        None if inv is None else jnp.asarray(inv),
        None if shift is None else jnp.asarray(shift), interpret=True)
    out = tff.flat_conv3x3_mask_stats(
        _t(src), _t(m), _t(w), _t(b), H, W,
        None if inv is None else _t(inv), None if shift is None else _t(shift))
    for name, o, r in zip(("y", "sum", "sumsq"), out, ref):
        assert tuple(o.shape) == tuple(r.shape), name
        assert _rel(o.numpy(), r) <= TOL, (name, _rel(o.numpy(), r))


@pytest.mark.parametrize("prev_fold", [False, True])
def test_flat_bwd_mega_matches_pallas(fp32, prev_fold):
    rng, m, src, w, b, inv, shift = _stage_inputs(1)
    B, C, H, W = 2, 16, 32, 32
    y = rng.normal(size=(B, C, H * W)).astype(np.float32) * m
    g = rng.normal(size=(B, C, H * W)).astype(np.float32)
    vecs = [rng.normal(size=(C,)).astype(np.float32) * s
            for s in (1.0, 0.3, 0.2, 0.1, 0.1)]
    vecs[0] = np.abs(vecs[0]) + 0.5  # inv
    var = (np.abs(rng.normal(size=(C,))) + 0.5).astype(np.float32)
    inv1, shift1, mean, s1, s2 = vecs
    nact = np.float32(m.sum())
    pf = (inv, shift) if prev_fold else None
    dh_r, dw_r = cff.flat_bwd_mega(
        *map(jnp.asarray, (g, y, src, m, inv1, shift1, mean, var, s1, s2,
                           nact, w)), H, W,
        prev_fold=None if pf is None else tuple(map(jnp.asarray, pf)),
        interpret=True)
    dh, dw = tff.flat_bwd_mega(
        *map(_t, (g, y, src, m, inv1, shift1, mean, var, s1, s2)),
        torch.tensor(nact), _t(w), H, W,
        prev_fold=None if pf is None else tuple(map(_t, pf)))
    assert _rel(dh.numpy(), dh_r) <= TOL
    assert tuple(dw.shape) == (3, 3, 8, C)
    assert _rel(dw.numpy(), dw_r) <= TOL


@pytest.mark.parametrize("cin", [1, 16])
def test_flat_double_conv_grads_match_pallas(fp32, cin):
    """All 9 gradient leaves of FlatDoubleConv against cmx's custom VJP
    (Pallas mega-kernel in interpret mode), plus outputs and stats."""
    rng = np.random.default_rng(2)
    B, H, W, C = 2, 32, 32, 16
    m = (rng.random((B, 1, H * W)) > 0.4).astype(np.float32)
    x = rng.normal(size=(B, cin, H * W)).astype(np.float32) * m
    params = [
        rng.normal(size=(3, 3, cin, C)).astype(np.float32) * 0.2,
        rng.normal(size=(C,)).astype(np.float32) * 0.1,
        np.full((C,), 1.1, np.float32), np.zeros((C,), np.float32),
        rng.normal(size=(3, 3, C, C)).astype(np.float32) * 0.05,
        rng.normal(size=(C,)).astype(np.float32) * 0.1,
        np.full((C,), 1.2, np.float32), np.full((C,), 0.05, np.float32),
    ]
    probe = rng.normal(size=(B, C, H * W)).astype(np.float32)

    def jloss(x, *p):
        out, stats = cff.flat_double_conv(x, jnp.asarray(m), *p, H, W,
                                          interpret=True)
        return jnp.sum(out * probe), (out, stats)

    (_, (jout, jstats)), jg = jax.value_and_grad(
        jloss, argnums=tuple(range(9)), has_aux=True)(
        jnp.asarray(x), *map(jnp.asarray, params))

    tx = [_t(a).requires_grad_(True) for a in [x] + params]
    out, stats = tff.flat_double_conv(tx[0], _t(m), *tx[1:], H, W)
    (out * _t(probe)).sum().backward()
    assert _rel(out.detach().numpy(), jout) <= TOL
    for a, b in zip(stats, jstats):
        assert _rel(a.numpy(), b) <= TOL
    names = ["dx", "dw0", "db0", "dg0", "dbe0", "dw1", "db1", "dg1", "dbe1"]
    for name, t, j in zip(names, tx, jg):
        if name in ("db0", "db1"):  # exactly zero on both sides
            assert float(t.grad.abs().max()) == 0.0
            assert float(jnp.max(jnp.abs(j))) == 0.0
        else:
            assert _rel(t.grad.numpy(), j) <= TOL, (name, _rel(t.grad.numpy(), j))


def test_flat_double_conv_matches_plain_reference(fp32):
    """The hand-derived backward against autograd of the plain reference."""
    rng = np.random.default_rng(3)
    B, H, W, cin, C = 2, 32, 32, 4, 8
    m = _t((rng.random((B, 1, H * W)) > 0.4).astype(np.float32))
    x = _t(rng.normal(size=(B, cin, H * W))) * m
    params = [_t(rng.normal(size=s)) * sc for s, sc in (
        ((3, 3, cin, C), 0.2), ((C,), 0.1), ((C,), 0.1), ((C,), 0.1),
        ((3, 3, C, C), 0.05), ((C,), 0.1), ((C,), 0.1), ((C,), 0.1))]
    params[2] += 1.0
    params[6] += 1.0
    probe = _t(rng.normal(size=(B, C, H * W)))
    grads = []
    for fn in (tff.flat_double_conv, tfc.double_conv_reference):
        leaves = [a.clone().requires_grad_(True) for a in [x] + params]
        out, _ = fn(leaves[0], m, *leaves[1:], H, W)
        (out.float() * probe).sum().backward()
        grads.append([a.grad for a in leaves])
    for i, (a, b) in enumerate(zip(*grads)):
        if i in (2, 6):  # conv biases: absorbed by BN
            assert float(a.abs().max()) == 0.0
            assert float(b.abs().max()) < 1e-3
        else:
            assert _rel(a.numpy(), b.numpy()) <= TOL, i


def _loss_inputs(seed, B=2, H=64):
    rng = np.random.default_rng(seed)
    f = H // 16
    imgs = rng.normal(size=(B, H, H)).astype(np.float32) * 2.0 + 0.5
    rec = rng.normal(size=(B, H, H)).astype(np.float32)
    active = (rng.random((B, f, f)) > 0.6).astype(np.float32)
    active[0, 0, 0] = 0.0
    return imgs, rec, active


def test_spark_loss_map_matches_pallas():
    imgs, rec, active = _loss_inputs(4)
    ref = cpo.spark_loss_pallas(jnp.asarray(rec), jnp.asarray(imgs),
                                jnp.asarray(active), interpret=True)
    out = tpo.spark_loss_pallas(_t(rec), _t(imgs), _t(active))
    assert abs(float(out) - float(ref)) <= TOL * abs(float(ref))
    # the per-patch map itself against the interpret-mode kernel's pieces
    plain = tpo.masked_l2_plain(_t(rec), _t(imgs), _t(active)).numpy()
    non_active = 1.0 - active
    assert abs(plain.sum() / (non_active.sum() + 1e-8) - float(ref)) \
        <= TOL * abs(float(ref))


def test_spark_loss_trainable_grad_matches_pallas():
    imgs, rec, active = _loss_inputs(5)

    def jl(r):
        return cpo.spark_loss_pallas_trainable(r, jnp.asarray(imgs),
                                               jnp.asarray(active), 16)

    jloss, jgrad = jax.value_and_grad(jl)(jnp.asarray(rec))
    r = _t(rec).requires_grad_(True)
    loss = tpo.spark_loss_pallas_trainable(r, _t(imgs), _t(active), 16)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= TOL * abs(float(jloss))
    assert _rel(r.grad.numpy(), jgrad) <= TOL


def test_wrappers_take_plain_path_only_on_cpu():
    """On the CPU the wrappers run the plain versions and count nothing."""
    before = (tff.flat_conv3x3_mask_stats.launches, tff.flat_bwd_mega.launches,
              tpo.spark_loss_pallas.launches)
    _, m, src, w, b, _, _ = _stage_inputs(6)
    tff.flat_conv3x3_mask_stats(_t(src), _t(m), _t(w), _t(b), 32, 32)
    imgs, rec, active = _loss_inputs(6)
    tpo.spark_loss_pallas(_t(rec), _t(imgs), _t(active))
    after = (tff.flat_conv3x3_mask_stats.launches, tff.flat_bwd_mega.launches,
             tpo.spark_loss_pallas.launches)
    assert before == after


def test_recording_replays_each_kernel_call(fp32):
    """With recording on, every wrapper call leaves (name, copies of its
    arguments), and replaying them gives the same results: chip_smoke.py
    takes the kernels' shapes and expected launch counts from this."""
    from cmx_torch.ops import _build

    rng = np.random.default_rng(5)
    B, H, W, cin, C = 2, 32, 32, 1, 8
    m = _t((rng.random((B, 1, H * W)) > 0.4).astype(np.float32))
    x = _t(rng.normal(size=(B, cin, H * W))) * m
    params = [_t(rng.normal(size=s) * 0.2).requires_grad_(True)
              for s in ((3, 3, cin, C), (C,), (C,), (C,), (3, 3, C, C), (C,),
                        (C,), (C,))]
    imgs, rec, active = _loss_inputs(5)
    _build.recorded = []
    try:
        out, _ = tff.flat_double_conv(x, m, *params, H, W)
        out.float().sum().backward()
        loss = tpo.spark_loss_pallas(_t(rec), _t(imgs), _t(active))
        calls = _build.recorded
    finally:
        _build.recorded = None
    names = [n for n, _ in calls]
    assert names == ["flat_conv3x3_mask_stats"] * 2 + ["flat_bwd_mega"] * 2 \
        + ["spark_loss_pallas"]
    need_dx = [args[15] for n, args in calls if n == "flat_bwd_mega"]
    assert need_dx == [True, False]  # the input x needs no gradient
    y0, _, _ = tff.flat_conv3x3_mask_stats(*calls[0][1])
    assert torch.equal(calls[1][1][0], y0)  # stage 1 reads stage 0's output
    assert torch.equal(tpo.spark_loss_pallas(*calls[4][1]), loss)


def test_roofline_table_has_a_row_per_pallas_kernel():
    """cmx_torch.utils.roofline bounds every function of cmx that reaches
    pl.pallas_call (K1-K8), and the bounds follow the recorded shapes (K4:
    the two view batches of one MoCo step and their non-zero taps; K6-K8:
    the calls of one step with FUSED_IMPL="nhwc")."""
    from pathlib import Path

    from cmx_torch.utils import roofline as rl

    root = Path(__file__).resolve().parent.parent / "cmx" / "ops"
    calls = sum(p.read_text().count("pl.pallas_call(") for p in root.glob("*.py"))
    stages = [(256, 256, 1, 64, False), (256, 256, 64, 64, True),
              (128, 128, 64, 128, True), (128, 128, 128, 128, True)]
    taps = 256 * 224 * 3  # 3 non-zero taps a weight row
    crop = (224, [256] * 256, [256] * 256, [224 * 3] * 256, [224 * 3] * 256)
    nhwc = [("conv_stem_stats", (256, 256, 1, 64)),
            ("conv3x3_mask_stats", (256, 256, 64, 64)),
            ("conv3x3_mask_stats", (128, 128, 64, 128)),
            ("conv3x3_mask_stats", (128, 128, 128, 128)),
            ("bwd_mega", (128, 128, 128, 128)), ("bwd_mega", (128, 128, 64, 128)),
            ("bwd_mega", (256, 256, 64, 64))]
    rows = rl.table(32, stages, [crop] * 2, nhwc)
    assert calls == len(rows) == 8
    assert [r["kernel"] for r in rows] == [f"K{i}" for i in range(1, 9)]
    assert [r["launches"] for r in rows] == [4, 4, 2, 2, 1, 1, 3, 3]
    assert all(r["bound_ms"] > 0 for r in rows)
    nb, fl = rl.crop_work(*crop)
    assert nb == 4 * 256 * (256 * 256 + 224 * 224 + 4)
    assert fl == 2 * taps * (256 + 224) + 10 * 2 * taps
    assert rows[3]["flops"] == 2 * fl and rows[3]["bound_by"] == "bytes"
    assert rl.table(32, stages, [crop], nhwc)[3]["flops"] == fl
    # K6-K8 from the NHWC step's recorded calls, not from the flat stages
    assert rows[5]["bytes"] == rl.stem_work(32, 256, 256, 64)[0]
    assert rows[5]["bound_by"] == "bytes"
    assert rows[7]["flops"] == sum(rl.conv3x3_bwd_work(32, *s)[1]
                                   for n, s in nhwc if n == "bwd_mega")
    assert rl.table(32, stages, [crop], nhwc[:2])[6]["launches"] == 1
    # the cheaper order of the two products counts
    assert rl.crop_work(224, [256], [64], [10], [10])[1] \
        == 2 * 10 * (64 + 224) + 200
    # only the pixels inside a window are read
    assert rl.crop_work(224, [128, 256], [64, 256], [10] * 2, [10] * 2)[0] \
        == 4 * (128 * 64 + 256 * 256 + 2 * 224 * 224 + 8)
    b, f = rl.conv3x3_fwd_work(32, 256, 256, 64, 64)
    assert f == 2 * 9 * 64 * 64 * 32 * 256 * 256
    assert rl.bound_ms(b, f, rl.PEAK_BF16) == (
        1e3 * max(b / rl.PEAK_BYTES, f / rl.PEAK_BF16), "bytes")
    assert rl.bound_ms(*rl.spark_loss_work(32, 256, 256, 2), rl.PEAK_FP32)[1] \
        == "bytes"
