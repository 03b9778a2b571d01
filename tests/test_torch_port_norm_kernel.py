"""The batch norm's kernel route (cmx_torch/ops/batch_norm.py) on the CPU,
through the plain versions of its four passes, against the plain
composition MaskedBatchNorm runs on the CPU (and ran everywhere before the
kernels): [x * mask], the moments, the normalisation, [ReLU], [* mask].

`blocks.norm_route` is patched to route CPU tensors by their layout, as it
routes CUDA tensors, so MaskedBatchNorm runs NormFunction here; each pass
then runs its plain version (the kernels run only on the card:
tests/test_torch_port_cuda.py holds them to these plain versions).

  * every CMX_BN_VARIANT, masked (random, and all positions masked) and
    unmasked, with the DoubleConv's epilogue (ReLU and re-mask) and without
    (SparK's densify norms, LightDecoder), fp32 and bf16: the output and
    the running statistics bit for bit (the moments' sums are the same
    torch sums; a 0/1 mask makes the input's re-mask a no-op for them);
    the gradients of x, scale and bias against the exact (float64)
    gradient of the same forward (its ReLU gate read from the output):
    dx within one rounding to x's dtype of its largest entry (2^-8 in bf16,
    1e-6 in fp32), scale and bias rel 1e-5 (fp32 sums in another order);
    and against the composition's autograd gradient: within 1e-5 in fp32,
    and in bf16 no further from the exact one than the composition's
    (whose backward rounds its chain to bf16);
  * eval mode (the running statistics, no moment term), both layouts (a
    channels-last input keeps its layout in the output and dx; other
    strides run as their channels-last copy, bit for bit), the route's
    refusals (fp16, another mask shape, a module dtype other than x's) and
    its counters (`NORM_CALLS`);
  * the sum passes' fixed reduction order (csrc/batch_norm.cu: threads'
    strided rows or vectors, the block's halving tree, the finalize's
    strided partials and tree) replayed in fp32 numpy from `sum_geometry`
    and the source's constants: every position counted once, the sums
    within 2e-6 of float64 and 1e-5 of the plain version's torch sums;
  * remat: a masked DownBlock under run_block's checkpoint equals the run
    without it bit for bit (output, gradients, running statistics updated
    once), its norms called again in the recompute;
  * data parallel: two gloo ranks (spawned once, `python
    tests/test_torch_port_norm_kernel.py OUT`) run a masked norm and a
    DoubleConv through the route under each variant against this process
    on the whole batch, within 1e-5 of the largest entry (the running
    statistics 1e-5 absolute), and count their collectives per norm: the
    moments' all-reduce (two for two_pass, and the MAX all-reduce of
    shift_max) and one all-reduce in the backward (the global sums that
    feed dx; autograd ran one a moment all-reduce: two for two_pass).
"""

import contextlib
import json
import math
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cmx_torch.models import blocks
from cmx_torch.ops import _build
from cmx_torch.ops import batch_norm as bo

ROOT = Path(__file__).resolve().parent.parent
VARIANTS = ("shift_ra", "shift_max", "two_pass", "naive")
THREADS = 2
WORLD = 2
DP_SHAPE = (4, 3, 16, 16)  # the global batch of the gloo cases (NCHW)
DC_WIDTHS = (3, 8)         # the DoubleConv's Cin and features


# norm_route without its device check: CPU tensors taken as CUDA ones are
_kernel_route = blocks.kernel_route


@pytest.fixture
def kernel_route(monkeypatch):
    monkeypatch.setattr(blocks, "norm_route", _kernel_route)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _inputs(dtype, mask_kind, seed=0, C=16, layout="channels_first"):
    g = torch.Generator().manual_seed(seed)
    B, H, W = 3, 8, 8
    x = (torch.randn((B, C, H, W), generator=g) * 2 + 3).to(dtype)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    m = {"none": None, "all": torch.zeros((B, 1, H, W)),
         "random": (torch.rand((B, 1, H, W), generator=g) > 0.4).float()
         }[mask_kind]
    gy = torch.randn((B, C, H, W), generator=g).to(dtype)
    return x, (None if m is None else m.to(dtype)), gy


def _module(C, dtype, seed=1, train=True):
    g = torch.Generator().manual_seed(seed)
    bn = blocks.MaskedBatchNorm(C, dtype).train(train)
    with torch.no_grad():
        bn.mean.uniform_(2.0, 3.0, generator=g)
        bn.var.uniform_(2.0, 5.0, generator=g)
        bn.scale.uniform_(0.5, 1.5, generator=g)
        bn.bias.uniform_(-0.5, 0.5, generator=g)
    return bn


def _run(bn, x, m, gy, epi):
    """(y, dx, dscale, dbias, running mean, running var) of bn's forward
    and backward of sum(y * gy)."""
    xi = x.clone().requires_grad_()
    y = bn(xi, m, relu=epi)
    (y.float() * gy.float()).sum().backward()
    return (y.detach(), xi.grad, bn.scale.grad, bn.bias.grad,
            bn.mean.clone(), bn.var.clone())


def _exact_grads(bn, x, m, gy, y, epi, mean=None, var=None, shift=None):
    """float64 (dx, dscale, dbias) of sum(y * gy) for the forward that made
    y: batch moments of x shifted by `shift` (the mean where no position is
    active; mean, var given: the running ones), the ReLU's gate read from y
    (y > 0 where the epilogue ran: the re-mask zeroes the gradient where it
    zeroes y)."""
    xd = x.double()
    n_all = xd.numel() // xd.shape[1]
    md = (torch.ones_like(xd[:, :1]) if m is None else m.double())
    g = gy.double() * (y.double() > 0) if epi else gy.double()
    red = (0, 2, 3)
    if mean is None:
        n = torch.clamp(md.sum(), min=1.0) if m is not None else n_all
        s = shift.double()[:, None, None]
        mean = shift.double() + ((xd - s) * md).sum(red) / n
        var = (md * (xd - mean[:, None, None]) ** 2).sum(red) / n
    else:
        n = None
    rstd = 1.0 / torch.sqrt(var.double() + bn.epsilon)
    xhat = (xd - mean.double()[:, None, None]) * rstd[:, None, None]
    inv = rstd * bn.scale.detach().double()
    sg, sgx = g.sum(red), (g * xhat).sum(red)
    dx = inv[:, None, None] * g
    if n is not None:
        dx = dx - inv[:, None, None] * md * (
            sg[:, None, None] + xhat * sgx[:, None, None]) / n
    return dx, sgx, sg


@pytest.mark.parametrize("epi", [True, False], ids=["relu_remask", "bare"])
@pytest.mark.parametrize("mask_kind", ["none", "random", "all"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_function_matches_the_composition(monkeypatch, variant, dtype,
                                          mask_kind, epi):
    monkeypatch.setattr(blocks, "BN_VARIANT", variant)
    x, m, gy = _inputs(dtype, mask_kind)
    before = dict(blocks.NORM_CALLS)
    comp = _run(_module(16, dtype), x, m, gy, epi)
    with monkeypatch.context() as mp:
        mp.setattr(blocks, "norm_route", _kernel_route)
        bn = _module(16, dtype)
        got = _run(bn, x, m, gy, epi)
    after = blocks.NORM_CALLS
    assert after["norm_plain"] == before["norm_plain"] + 1
    assert after["norm_kernel_channels_first"] == \
        before["norm_kernel_channels_first"] + 1
    y, dx, dscale, dbias, mean, var = got
    assert y.dtype == dtype
    for a, b in ((y, comp[0]), (mean, comp[4]), (var, comp[5])):
        assert torch.equal(a, b)
    shift = (_module(16, dtype).mean if variant == "shift_ra"
             else torch.zeros(16))  # shift_max's: no subsampled x is 0
    ex_dx, ex_ds, ex_db = _exact_grads(bn, x, m, gy, y, epi, shift=shift)
    one_rounding = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-6
    assert _rel(dx, ex_dx) <= one_rounding
    assert _rel(dscale, ex_ds) <= 1e-5
    assert _rel(dbias, ex_db) <= 1e-5
    if dtype == torch.float32:
        for a, b in zip(got[1:4], comp[1:4]):
            assert _rel(a, b) <= 1e-5
    else:  # the composition rounds its backward chain to bf16
        for a, b, ex in zip(got[1:4], comp[1:4], (ex_dx, ex_ds, ex_db)):
            assert _rel(a, ex) <= _rel(b, ex) + 1e-6


@pytest.mark.parametrize("mask_kind", ["none", "random"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_eval_mode_normalises_by_the_running_statistics(kernel_route, dtype,
                                                        mask_kind):
    x, m, gy = _inputs(dtype, mask_kind, seed=3)
    bn = _module(16, dtype, train=False)
    mean0, var0 = bn.mean.clone(), bn.var.clone()
    y, dx, dscale, dbias, mean, var = _run(bn, x, m, gy, True)
    assert torch.equal(mean, mean0) and torch.equal(var, var0)
    with _plain_route():
        comp = _run(_module(16, dtype, train=False), x, m, gy, True)
    assert torch.equal(y, comp[0])
    ex = _exact_grads(bn, x, m, gy, y, True, mean0, var0)
    one_rounding = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-6
    assert _rel(dx, ex[0]) <= one_rounding
    assert _rel(dscale, ex[1]) <= 1e-5 and _rel(dbias, ex[2]) <= 1e-5


@contextlib.contextmanager
def _plain_route():
    """MaskedBatchNorm's plain composition inside the block."""
    old = blocks.norm_route
    blocks.norm_route = lambda x, mask=None: None
    try:
        yield
    finally:
        blocks.norm_route = old


def test_a_channels_last_input_keeps_its_layout(kernel_route):
    x, m, gy = _inputs(torch.bfloat16, "random", seed=4,
                       layout="channels_last")
    before = blocks.NORM_CALLS["norm_kernel_channels_last"]
    got = _run(_module(16, torch.bfloat16), x, m, gy, True)
    assert blocks.NORM_CALLS["norm_kernel_channels_last"] == before + 1
    for t in got[:2]:
        assert t.is_contiguous(memory_format=torch.channels_last)
    # the same values channel-major; torch sums the two layouts in another
    # order: a bf16 rounding of the outputs, fp32 sums rel 1e-5
    ref = _run(_module(16, torch.bfloat16), x.contiguous(), m, gy, True)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert _rel(a, b) <= (2.0 ** -8 if i < 2 else 1e-5)


def test_the_route_keeps_the_cpu_and_fp64_plain():
    x = torch.zeros((2, 8, 4, 4))
    assert blocks.norm_route(x) is None  # the CPU
    assert _kernel_route(x.double()) is None
    assert _kernel_route(x[0]) is None  # not 4-D
    assert _kernel_route(x[:, :, :, :2]) == "channels_last"  # other strides
    assert _kernel_route(x) == "channels_first"
    assert _kernel_route(x.contiguous(memory_format=torch.channels_last)) \
        == "channels_last"


def test_the_route_refuses_what_the_kernels_do_not_take(kernel_route):
    """No norm the kernels cannot take falls back to the plain composition
    on the card: fp16, a mask of another shape and a module dtype other
    than x's raise (tests/test_torch_port_cuda.py holds the same on the
    card through norm_route itself)."""
    x = torch.zeros((2, 8, 4, 4))
    with pytest.raises(TypeError):
        _kernel_route(x.half())
    for shape in ((2, 2, 4, 4), (2, 1, 4, 2), (1, 4, 4), (2, 4, 4, 1)):
        with pytest.raises(ValueError):
            _kernel_route(x, torch.ones(shape))
    before = dict(blocks.NORM_CALLS)
    with pytest.raises(TypeError):
        blocks.MaskedBatchNorm(8, torch.bfloat16).train()(x)
    with pytest.raises(ValueError):
        blocks.MaskedBatchNorm(8).train()(x, torch.ones((2, 1, 4, 2)))
    assert blocks.NORM_CALLS == before


@pytest.mark.parametrize("variant", VARIANTS)
def test_other_strides_run_the_kernels_channels_last(monkeypatch,
                                                     kernel_route, variant):
    """x of strides neither layout has (H and W swapped in memory) runs the
    kernels on its channels-last copy: the output, dx and the running
    statistics equal that copy's bit for bit, dx in x's shape."""
    monkeypatch.setattr(blocks, "BN_VARIANT", variant)
    x, m, gy = _inputs(torch.bfloat16, "random", seed=5)
    strided = x.transpose(2, 3).contiguous().transpose(2, 3)
    assert bo.layout_of(strided) is None
    before = blocks.NORM_CALLS["norm_kernel_channels_last"]
    got = _run(_module(16, torch.bfloat16), strided, m, gy, True)
    assert blocks.NORM_CALLS["norm_kernel_channels_last"] == before + 1
    ref = _run(_module(16, torch.bfloat16),
               x.contiguous(memory_format=torch.channels_last), m, gy, True)
    assert got[1].shape == x.shape
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


# ------------------------------------------------ the kernel's sum order


def _constant(name):
    src = (_build.CSRC / "batch_norm.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _f32(a):
    return np.asarray(a, np.float32)


def _fma(d, acc):
    """fmaf(d, d, acc) in fp32 (the product exact, one rounding)."""
    return (acc.astype(np.float64) + d.astype(np.float64) ** 2).astype(
        np.float32)


def _tree(acc, axis, n):
    """The kernels' halving tree over the first n entries of `axis`: rows
    [h, 2h) onto [0, h), h from the power of two at or above n, halved."""
    acc = np.moveaxis(acc, axis, 0).copy()
    top = 1
    while top < n:
        top *= 2
    h = top // 2
    while h:
        for t in range(h):
            if t + h < n:
                acc[t] = _f32(acc[t] + acc[t + h])
        h //= 2
    return acc[0]


def _finalize(part):
    """norm_finalize_kernel on partials (..., nbx): thread t adds blocks t,
    t + kThreads, ..., then the tree over the threads."""
    threads = _constant("kThreads")
    nbx = part.shape[-1]
    acc = np.zeros(part.shape[:-1] + (threads,), np.float32)
    for j in range(nbx):
        acc[..., j % threads] = _f32(acc[..., j % threads] + part[..., j])
    return _tree(acc, -1, threads)


def _replay_moments(x, m, s, channels_last):
    """csrc/batch_norm.cu's moments pass and finalize in its order, fp32:
    (sum d, sum d^2 per channel, the count), d = (x - s) m."""
    threads, vec = _constant("kThreads"), _constant("kVec")
    max_tx = _constant("kMaxTX")
    B, C, H, W = x.shape
    P = H * W
    K, nbx = bo.sum_geometry(B, C, P, channels_last)
    mm = np.ones((B, P), np.float32) if m is None else _f32(m.reshape(B, P))
    d = _f32(_f32(x - s[None, :, None, None]) * mm.reshape(B, 1, H, W))
    if channels_last:
        tx = min(-(-C // vec), max_tx)
        ty_n = threads // tx
        rows = d.transpose(0, 2, 3, 1).reshape(B * P, C)
        span = nbx * ty_n * K
        assert span >= B * P > (nbx - 1) * ty_n * K
        pad = np.zeros((span, C), np.float32)
        pad[:B * P] = rows
        cnt = np.zeros(span, np.float32)
        cnt[:B * P] = mm.reshape(-1)
        blk = pad.reshape(nbx, K, ty_n, C)  # row bx TY K + it TY + ty
        cblk = cnt.reshape(nbx, K, ty_n)
        a = np.zeros((nbx, ty_n, C), np.float32)
        b = np.zeros_like(a)
        c = np.zeros((nbx, ty_n), np.float32)
        for it in range(K):
            a = _f32(a + blk[:, it])
            b = _fma(blk[:, it], b)
            c = _f32(c + cblk[:, it])
        pa, pb = _tree(a, 1, ty_n).T, _tree(b, 1, ty_n).T  # (C, nbx)
        pc = _tree(c, 1, ty_n)
    else:
        w = vec if P % vec == 0 else 1
        units = B * (P // w)
        span = nbx * K * threads
        assert span >= units > (nbx - 1) * K * threads
        planes = d.reshape(B, C, P // w, w).transpose(1, 0, 2, 3).reshape(
            C, units, w)
        pad = np.zeros((C, span, w), np.float32)
        pad[:, :units] = planes
        mpad = np.zeros((span, w), np.float32)
        mpad[:units] = mm.reshape(units, w)
        blk = pad.reshape(C, nbx, K, threads, w)
        mblk = mpad.reshape(nbx, K, threads, w)
        a = np.zeros((C, nbx, threads, w), np.float32)
        b = np.zeros_like(a)
        c = np.zeros((nbx, threads), np.float32)
        for it in range(K):
            a = _f32(a + blk[:, :, it])
            b = _fma(blk[:, :, it], b)
            for i in range(w):
                c = _f32(c + mblk[:, it, :, i])
        sa = np.zeros(a.shape[:-1], np.float32)
        sb = np.zeros_like(sa)
        for i in range(w):  # the thread's lanes, in order
            sa, sb = _f32(sa + a[..., i]), _f32(sb + b[..., i])
        pa, pb = _tree(sa, 2, threads), _tree(sb, 2, threads)  # (C, nbx)
        pc = _tree(c, 1, threads)
    count = (np.float32(B * P) if m is None else _finalize(pc[None])[0])
    return _finalize(pa), _finalize(pb), count


@pytest.mark.parametrize("B,C,H,W,channels_last", [
    (2, 20, 5, 7, True),     # C % 8 != 0: a short channel group
    (3, 48, 6, 6, True),     # TY = 42: a tree over a non-power of two
    (2, 320, 4, 4, True),    # 40 channel groups: two blocks along y
    (5, 64, 20, 20, True),   # four blocks along x, the last one short
    (2, 6, 9, 9, False),     # H W % 8 != 0: scalar units
    (4, 4, 96, 96, False),   # two blocks along x
])
@pytest.mark.parametrize("masked", [False, True])
def test_sum_passes_replay_the_kernel_order(B, C, H, W, channels_last,
                                            masked):
    rng = np.random.default_rng(B * C + H)
    x = _f32(rng.normal(size=(B, C, H, W)) * 3 + 2)
    s = _f32(rng.normal(size=C))
    m = _f32(rng.random((B, H, W)) > 0.3) if masked else None
    # every position counted once
    ones = _replay_moments(np.ones_like(x), m, np.zeros_like(s),
                           channels_last)
    want = float(B * H * W) if m is None else float(m.sum())
    assert np.all(ones[0] == want) and ones[2] == want
    sa, sb, n = _replay_moments(x, m, s, channels_last)
    mm = np.ones((B, 1, H, W)) if m is None else m[:, None].astype(np.float64)
    d64 = (x.astype(np.float64) - s[None, :, None, None]) * mm
    for got, ref in ((sa, d64.sum((0, 2, 3))), (sb, (d64 ** 2).sum((0, 2, 3)))):
        assert np.max(np.abs(got - ref)) <= 2e-6 * np.max(np.abs(ref))
    plain = bo.norm_moments_plain(torch.from_numpy(x),
                                  None if m is None else torch.from_numpy(m),
                                  torch.from_numpy(s)).numpy()
    assert np.max(np.abs(plain[:C] - sa)) <= 1e-5 * np.max(np.abs(sa))
    assert np.max(np.abs(plain[C:2 * C] - sb)) <= 1e-5 * np.max(np.abs(sb))
    assert plain[2 * C] == n == want


def test_sum_geometry_fits_the_kernel_checks():
    """(K, nbx) within the rows a thread may walk, the blocks covering the
    shape once, at the cells' largest and smallest norms."""
    for B, C, P, cl in ((256, 64, 224 * 224, True), (128, 1024, 14 * 14, True),
                        (128, 64, 256 * 256, False), (1, 3, 5, False)):
        K, nbx = bo.sum_geometry(B, C, P, cl)
        assert bo.ROWS_MIN <= K <= bo.ROWS_MAX
        if cl:
            per = bo.THREADS // min(math.ceil(C / bo.VEC), bo.MAX_TX)
            units = B * P
        else:
            per = bo.THREADS
            units = B * (P // bo.VEC if P % bo.VEC == 0 else P)
        assert (nbx - 1) * per * K < units <= nbx * per * K
    assert (bo.THREADS, bo.VEC, bo.MAX_TX) == (
        _constant("kThreads"), _constant("kVec"), _constant("kMaxTX"))


# ----------------------------------------------------------------- remat


def test_remat_recomputes_through_the_route(kernel_route):
    """A masked bf16 DownBlock under run_block's checkpoint: output, input
    and parameter gradients and running statistics bit for bit those of
    the run without it; the recompute calls its two norms again and
    updates no running statistic a second time."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn((2, 3, 16, 16), generator=g).to(torch.bfloat16)
    m = (torch.rand((2, 1, 16, 16), generator=g) > 0.4).to(torch.bfloat16)
    gy = torch.randn((2, 8, 16, 16), generator=g)
    res = []
    for remat in (False, True):
        block = blocks.DownBlock(3, 8, torch.bfloat16).train()
        blocks.reset_parameters(block, torch.Generator().manual_seed(1))
        with torch.no_grad():
            block.double_conv.bn0.mean.fill_(0.3)
        xi = (x * m).requires_grad_()
        before = blocks.NORM_CALLS["norm_kernel_channels_first"]
        _, skip = blocks.run_block(block, remat, xi, m)
        (skip.float() * gy).sum().backward()
        calls = blocks.NORM_CALLS["norm_kernel_channels_first"] - before
        res.append((calls, [skip, xi.grad]
                    + [p.grad for p in block.parameters()]
                    + list(block.buffers())))
    assert (res[0][0], res[1][0]) == (2, 4)
    for a, b in zip(res[0][1], res[1][1]):
        assert torch.equal(a, b)


# --------------------------------------------------------- data parallel
# (run in every process: torch only)


def _dp_inputs():
    """The global batch: x, mask, the output cotangent (NCHW, fp32)."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=DP_SHAPE) * 2.0 + 5.0
    m = rng.random((DP_SHAPE[0], 1) + DP_SHAPE[2:]) > 0.4
    g = rng.normal(size=(DP_SHAPE[0], DC_WIDTHS[1]) + DP_SHAPE[2:])
    return (torch.from_numpy(x).float(), torch.from_numpy(m).float(),
            torch.from_numpy(g).float())


def run_dp_cases():
    """Every variant's masked norm and DoubleConv forward and backward
    through the route on this rank's rows of the global batch: {variant:
    {name: array}} and the collectives each made."""
    from cmx_torch.parallel import mesh

    x, m, g = (mesh.rank_slice(t) for t in _dp_inputs())
    out = {}
    route = blocks.norm_route
    blocks.norm_route = _kernel_route
    try:
        for variant in VARIANTS:
            blocks.BN_VARIANT = variant
            res = {}
            for name in ("bn", "dc"):
                torch.manual_seed(0)
                if name == "bn":
                    mod = blocks.MaskedBatchNorm(DP_SHAPE[1], torch.float32)
                    with torch.no_grad():
                        mod.mean.fill_(4.0)
                        mod.scale.uniform_(0.5, 1.5)
                    gg = g[:, :DP_SHAPE[1]]
                else:
                    mod = blocks.DoubleConv(*DC_WIDTHS, torch.float32)
                    mod.conv0.reset_parameters(
                        torch.Generator().manual_seed(1))
                    mod.conv1.reset_parameters(
                        torch.Generator().manual_seed(2))
                    gg = g
                mod.train()
                xi = (x * m).requires_grad_()
                mesh.reset_counts()
                y = mod(xi, m, relu=True) if name == "bn" \
                    else mod(xi, m)
                (y * gg).sum().backward()
                res[f"{name}/counts"] = dict(mesh.counts)
                res[f"{name}/out"] = y.detach().numpy()
                res[f"{name}/dx"] = xi.grad.numpy()
                for n, p in mod.named_parameters():
                    res[f"{name}/grad/{n}"] = p.grad.numpy()
                for n, b in mod.named_buffers():
                    res[f"{name}/buf/{n}"] = b.numpy()
            out[variant] = res
    finally:
        blocks.norm_route = route
        blocks.BN_VARIANT = "shift_ra"
    return out


def _dp_worker(out_path):
    torch.set_num_threads(THREADS)
    sys.path.insert(0, str(ROOT))
    from cmx_torch.parallel import dist

    dist.initialize_distributed("cpu")
    rank, _ = dist.process_info()
    res = run_dp_cases()
    arrays = {f"{v}/{k}": a for v, r in res.items() for k, a in r.items()
              if not k.endswith("/counts")}
    np.savez(f"{out_path}.{rank}.npz", **arrays)
    Path(f"{out_path}.{rank}.json").write_text(json.dumps(
        {v: {k: c for k, c in r.items() if k.endswith("/counts")}
         for v, r in res.items()}))
    dist.shutdown()


if __name__ == "__main__":
    _dp_worker(sys.argv[1])
    sys.exit(0)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """(the ranks' results, their collective counts, this process's)."""
    tmp = tmp_path_factory.mktemp("norm_dp")
    env = dict(os.environ, WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), PYTHONPATH=str(ROOT),
               OMP_NUM_THREADS=str(THREADS))
    procs = []
    for rank in range(WORLD):
        log = open(tmp / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, str(tmp / "out")],
            env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)), cwd=ROOT,
            stdout=log, stderr=subprocess.STDOUT), log))
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        one = run_dp_cases()  # meanwhile, the whole batch in this process
    finally:
        torch.set_num_threads(threads)
    bad = []
    for p, log in procs:
        try:
            p.wait(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        log.close()
        if p.returncode:
            bad.append(Path(log.name).read_text()[-4000:])
    assert not bad, "a rank failed:\n" + "\n---\n".join(bad)
    ranks, counts = [], []
    for r in range(WORLD):
        with np.load(tmp / f"out.{r}.npz") as f:
            ranks.append({k: f[k] for k in f.files})
        counts.append(json.loads((tmp / f"out.{r}.json").read_text()))
    return ranks, counts, one


def _np_rel(a, b):
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))),
                                              1e-30)


@pytest.mark.parametrize("variant", VARIANTS)
def test_two_ranks_equal_one_process(dp_runs, variant):
    ranks, _, one = dp_runs
    ref = one[variant]
    for name in ("bn", "dc"):
        for part in ("out", "dx"):
            got = np.concatenate([r[f"{variant}/{name}/{part}"]
                                  for r in ranks])
            assert _np_rel(got, ref[f"{name}/{part}"]) <= 1e-5, (name, part)
        grads = {k: v for k, v in ref.items()
                 if k.startswith(f"{name}/grad/")}
        scale = max(float(np.max(np.abs(v))) for v in grads.values())
        for k, want in grads.items():
            got = sum(r[f"{variant}/{k}"] for r in ranks)
            # a conv bias that a norm absorbs has the true gradient 0
            bound = scale if k.endswith("conv0.bias") or k.endswith(
                "conv1.bias") else float(np.max(np.abs(want)))
            assert np.max(np.abs(got - want)) <= 1e-5 * bound, k
        for k, want in ref.items():
            if k.startswith(f"{name}/buf/"):
                for r in ranks:
                    np.testing.assert_allclose(r[f"{variant}/{k}"], want,
                                               rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("variant", VARIANTS)
def test_the_route_counts_its_collectives(dp_runs, variant):
    _, counts, one = dp_runs
    per_norm = {"shift_ra": {"all_reduce": 2}, "naive": {"all_reduce": 2},
                "shift_max": {"all_reduce": 2, "all_reduce_max": 1},
                "two_pass": {"all_reduce": 3}}[variant]
    for name, norms in (("bn", 1), ("dc", 2)):
        assert one[variant][f"{name}/counts"] == {}  # no group here
        for c in counts:
            calls = {k: v for k, v in c[variant][f"{name}/counts"].items()
                     if not k.endswith("_bytes")}
            assert calls == {k: norms * v for k, v in per_norm.items()}, name
