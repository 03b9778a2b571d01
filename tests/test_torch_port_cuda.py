"""cmx_torch's CUDA/Triton kernels against their plain versions on the card.

They skip, with a reason, without a CUDA device (the decision is made
inside the fixture). On a machine with the card:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

Shapes here are small and deliberately ragged (Cin not a multiple of the
staging chunk, Cout not a multiple of the channel tile) to exercise the
bounds checks; the main path's full-width shapes are covered by
chip_smoke.py. Tolerances: bf16 outputs rel 1e-2 of the largest entry (a
one-ulp bf16 rounding flip), fp32 sums rel 1e-3 (summation order).
"""

import numpy as np
import pytest
import torch

from cmx_torch.ops import fused_conv_flat as ff
from cmx_torch.ops import pallas_ops as po


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from cmx_torch import resolve_device

    return resolve_device("cuda")


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)


def _inputs(dev, B, H, W, cin, C, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    m = (torch.rand((B, 1, H * W), generator=g, device=dev) > 0.4)
    m = m.to(torch.bfloat16)
    src = (torch.randn((B, cin, H * W), generator=g, device=dev)
           * m.float()).to(torch.bfloat16)
    w = torch.randn((3, 3, cin, C), generator=g, device=dev) * 0.2
    b = torch.randn((C,), generator=g, device=dev) * 0.1
    inv = torch.rand((cin,), generator=g, device=dev) + 0.5
    shift = torch.randn((cin,), generator=g, device=dev) * 0.3
    return g, m, src, w, b, inv, shift


SHAPES = [(2, 32, 64, 1, 16), (2, 8, 32, 3, 96), (1, 16, 32, 64, 64)]


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("B,H,W,cin,C", SHAPES)
def test_flat_conv_kernel_matches_plain(dev, B, H, W, cin, C, pre):
    _, m, src, w, b, inv, shift = _inputs(dev, B, H, W, cin, C)
    inv, shift = (inv, shift) if pre else (None, None)
    n0 = ff.flat_conv3x3_mask_stats.launches
    out = ff.flat_conv3x3_mask_stats(src, m, w, b, H, W, inv, shift)
    ref = ff.flat_conv3x3_mask_stats_plain(src, m, w, b, H, W, inv, shift)
    torch.cuda.synchronize()
    assert ff.flat_conv3x3_mask_stats.launches == n0 + 1
    assert _rel(out[0], ref[0]) <= 1e-2
    assert _rel(out[1], ref[1]) <= 1e-3 and _rel(out[2], ref[2]) <= 1e-3


@pytest.mark.parametrize("need_dx", [False, True])
@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("B,H,W,cin,C", SHAPES)
def test_flat_bwd_kernel_matches_plain(dev, B, H, W, cin, C, pre, need_dx):
    g, m, src, w, b, inv, shift = _inputs(dev, B, H, W, cin, C, seed=1)
    gy = (torch.randn((B, C, H * W), generator=g, device=dev)).to(torch.bfloat16)
    y = (torch.randn((B, C, H * W), generator=g, device=dev)
         * m.float()).to(torch.bfloat16)
    vec = [torch.randn((C,), generator=g, device=dev) * 0.3 for _ in range(5)]
    vec[0] = vec[0].abs() + 0.5
    var = torch.rand((C,), generator=g, device=dev) + 0.5
    args = (gy, y, src, m, vec[0], vec[1], vec[2], var, vec[3], vec[4],
            m.float().sum(), w, H, W, (inv, shift) if pre else None, need_dx)
    n0 = ff.flat_bwd_mega.launches
    dh, dw = ff.flat_bwd_mega(*args)
    dhr, dwr = ff.flat_bwd_mega_plain(*args)
    torch.cuda.synchronize()
    assert ff.flat_bwd_mega.launches == n0 + 1
    assert _rel(dw, dwr) <= 1e-3
    if need_dx:
        assert _rel(dh, dhr) <= 1e-2
    else:
        assert dh is None


def test_flat_double_conv_on_card_matches_cpu(dev):
    """Forward, stats and all gradients of FlatDoubleConv on the card (the
    kernels) against the same function on the CPU (the plain versions)."""
    rng = np.random.default_rng(0)
    B, H, W, cin, C = 2, 32, 32, 8, 16
    m = torch.from_numpy((rng.random((B, 1, H * W)) > 0.4).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(B, cin, H * W)).astype(np.float32)) * m
    params = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.normal(size=(3, 3, cin, C)) * 0.2, rng.normal(size=(C,)) * 0.1,
        1.0 + rng.normal(size=(C,)) * 0.1, rng.normal(size=(C,)) * 0.1,
        rng.normal(size=(3, 3, C, C)) * 0.1, rng.normal(size=(C,)) * 0.1,
        1.0 + rng.normal(size=(C,)) * 0.1, rng.normal(size=(C,)) * 0.1)]
    probe = torch.from_numpy(rng.normal(size=(B, C, H * W)).astype(np.float32))
    res = []
    for d in ("cpu", dev):
        leaves = [a.detach().to(d).requires_grad_(True)
                  for a in [x.to(torch.bfloat16)] + params]
        out, stats = ff.flat_double_conv(leaves[0], m.to(d), *leaves[1:], H, W)
        (out.float() * probe.to(d)).sum().backward()
        res.append([out.detach().cpu()] + [s.cpu() for s in stats]
                   + [a.grad.cpu() for a in leaves])
    for i, (a, b) in enumerate(zip(*res)):
        tol = 1e-3 if i in (1, 2, 3, 4) else 3e-2
        if float(b.abs().max()) == 0.0:
            assert float(a.abs().max()) == 0.0, i
        else:
            assert _rel(a, b) <= tol, (i, _rel(a, b))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    _, m, src, w, b, _, _ = _inputs(dev, 1, 8, 32, 4, 16)
    with pytest.raises(TypeError):
        ff.flat_conv3x3_mask_stats(src.float(), m, w, b, 8, 32)
    _, m2, src2, w2, b2, _, _ = _inputs(dev, 1, 8, 24, 4, 16)
    with pytest.raises(ValueError):
        ff.flat_conv3x3_mask_stats(src2, m2, w2, b2, 8, 24)


@pytest.mark.parametrize("B,H", [(2, 64), (3, 256)])
def test_spark_loss_kernel_matches_plain(dev, B, H):
    g = torch.Generator(device=dev).manual_seed(2)
    imgs = torch.randn((B, H, H), generator=g, device=dev) * 2 + 0.5
    rec = torch.randn((B, H, H), generator=g, device=dev)
    act = (torch.rand((B, H // 16, H // 16), generator=g, device=dev) > 0.6)
    act = act.float()
    n0 = po.spark_loss_pallas.launches
    out = po._masked_l2_triton(rec, imgs, act, 16)
    ref = po.masked_l2_plain(rec, imgs, act, 16)
    assert _rel(out, ref) <= 1e-4
    loss = po.spark_loss_pallas(rec, imgs, act)
    ref_loss = po.spark_loss_pallas_plain(rec, imgs, act)
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    assert po.spark_loss_pallas.launches == n0 + 2


def test_wrappers_refuse_operands_on_another_device(dev):
    _, m, src, w, b, _, _ = _inputs(dev, 1, 8, 32, 4, 16)
    with pytest.raises(ValueError):
        ff.flat_conv3x3_mask_stats(src, m, w.cpu(), b, 8, 32)
    imgs = torch.zeros((1, 32, 32), device=dev)
    with pytest.raises(ValueError):
        po.spark_loss_pallas(imgs, imgs, torch.zeros((1, 2, 2)))
