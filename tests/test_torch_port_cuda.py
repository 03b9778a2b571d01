"""cmx_torch's CUDA/Triton kernels against their plain versions on the card.

They skip, with a reason, without a CUDA device (the decision is made
inside the fixture). On a machine with the card:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

Shapes here are small and deliberately ragged (Cin not a multiple of the
staging chunk, Cout not a multiple of the channel tile) to exercise the
bounds checks; the main path's full-width shapes are covered by
chip_smoke.py. The NHWC kernels (K6-K8) take H % 32 == 0 and W % 8 == 0,
the flat ones (K1/K2) H % 8 == 0 and W % 8 == 0; both sets of shapes
include W = 40 and 24 (8 times an odd number: a column tile that overhangs
the image), Cin 1, 3, 24, 64 and 128 and Cout 20, 64, 96 and 128 (the edges
of the tensor-core tiles), the flat ones also H = 8 (one row tile).
Tolerances: bf16 outputs rel
1e-2 of the largest entry (a one-ulp bf16 rounding flip), fp32 sums rel
1e-3 (summation order); the fp32 crop (K4) rel 1e-5 (its weights equal the
plain version's op for op; the products sum in another order); K5 in fp32
rel 1e-6 (Triton fuses x*scale+bias into one FMA, the plain version rounds
twice); K3's forward loss and numerator rel 1e-5 and its backward one ulp
of rec's dtype at the largest |drec| in bf16, eight in fp32: the patch sums and the
cross-block sum run in another order than the plain version's. The Genesis
chain on the card against the CPU with the same draws: bit for bit but for
the fit remap (1e-4 of the image's span), and no host sync; the decoder
variants fused against unfused at the bf16 margins (loss 2e-2, BN stats
5e-2). The BN moment variants (CMX_BN_VARIANT) on the card against the CPU
(running stats rel 1e-5, bf16 outputs and gradients rel 1e-2), and the
SparK graph under shift_max and two_pass bit for bit. With the program's
spans on, a captured CM-UNet step's replays run its span markers in
capture order. A captured bf16 CM-UNet step runs every library
convolution channels-last; cuDNN transposes only its one- and two-channel
operands. The batch norm's kernels (csrc/batch_norm.cu) against their plain
versions at the cells' shapes (C 64-1024, H W 14^2-256^2, B 128 and 256)
and at odd ones (B 1, C and H W not multiples of 8), channels-last and
channel-major, masked (bf16 and fp32 masks) and not: the sum passes rel
1e-5 of their largest sum (fp32 sums in another order) with the count
exact, the element-wise passes bit for bit (the same fp32 operations on the
same constants); the same bits twice; a captured step at cmunet-b128's
shape runs every norm through them; on the card only fp64 runs the plain
norm, other strides run the kernels and what they cannot take raises.
"""

import numpy as np
import pytest
import torch

from cmx_torch.ops import batch_norm as bo
from cmx_torch.ops import fused_conv as fc
from cmx_torch.ops import fused_conv_flat as ff
from cmx_torch.ops import pallas_crop as pc
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


SHAPES = [(2, 32, 64, 1, 16), (2, 8, 32, 3, 96), (1, 16, 32, 64, 64),
          (2, 32, 40, 1, 64), (1, 8, 40, 3, 20), (2, 16, 24, 24, 96),
          (1, 8, 24, 128, 128), (1, 16, 40, 64, 20)]


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
    for H, W in ((8, 20), (12, 24)):  # W % 8, H % 8
        _, m2, src2, w2, b2, _, _ = _inputs(dev, 1, H, W, 4, 16)
        with pytest.raises(ValueError):
            ff.flat_conv3x3_mask_stats(src2, m2, w2, b2, H, W)


def _loss_inputs(dev, B, H, grid, rec_dtype, seed=2):
    g = torch.Generator(device=dev).manual_seed(seed)
    imgs = torch.randn((B, H, H), generator=g, device=dev) * 2 + 0.5
    rec = torch.randn((B, H, H), generator=g, device=dev).to(rec_dtype)
    f = H // 16
    if grid == "random":
        act = (torch.rand((B, f, f), generator=g, device=dev) > 0.6).float()
    else:  # every patch visible (the denominator is 1e-8) or every masked
        act = torch.full((B, f, f), float(grid == "visible"), device=dev)
    return rec, imgs, act


@pytest.mark.parametrize("grid", ["random", "visible", "masked"])
@pytest.mark.parametrize("rec_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H", [(1, 256), (3, 256), (32, 256), (1, 512),
                                 (3, 512), (32, 512)])
def test_spark_loss_kernels_match_plain(dev, B, H, rec_dtype, grid):
    """K3's forward to rel 1e-5 (sum order) and its backward to one ulp of
    rec's dtype at the largest |drec| in bf16, eight in fp32 (the patch sums
    run in another order), each one launch; g = 0.7 is read on the
    device."""
    rec, imgs, act = _loss_inputs(dev, B, H, grid, rec_dtype)
    n0, nb0 = po.spark_loss_pallas.launches, po.spark_loss_bwd.launches
    loss, _, denom = po._spark_loss(rec, imgs, act, 16)
    ref = po.spark_loss_pallas_plain(rec, imgs, act)
    g = torch.tensor(0.7, device=dev)
    drec = po.spark_loss_bwd(rec, imgs, act, g, denom)
    dref = po.spark_loss_bwd_plain(rec, imgs, act, g)
    torch.cuda.synchronize()
    assert po.spark_loss_pallas.launches == n0 + 1
    assert po.spark_loss_bwd.launches == nb0 + 1
    assert float(denom) == float((1 - act).sum() + 1e-8)
    assert abs(float(loss) - float(ref)) <= 1e-5 * abs(float(ref))
    assert drec.dtype == rec_dtype and drec.shape == rec.shape
    ulps = 1 if rec_dtype == torch.bfloat16 else 8
    tol = ulps * torch.finfo(rec_dtype).eps * float(dref.float().abs().max())
    assert float((drec.float() - dref.float()).abs().max()) <= tol
    if grid == "visible":
        assert float(loss) == 0.0 and not drec.float().abs().max()


@pytest.mark.parametrize("rec_dtype", [torch.bfloat16, torch.float32])
def test_spark_loss_kernels_give_the_same_bits_twice(dev, rec_dtype):
    """The forward sums its blocks' partials in a fixed order (no float
    atomics), so two launches on the same inputs agree bit for bit."""
    rec, imgs, act = _loss_inputs(dev, 32, 256, "random", rec_dtype, seed=4)
    a, _, da = po._spark_loss(rec, imgs, act, 16)
    b, _, db = po._spark_loss(rec, imgs, act, 16)
    g = torch.tensor(1.0, device=dev)
    assert torch.equal(a, b) and torch.equal(da, db)
    assert torch.equal(po.spark_loss_bwd(rec, imgs, act, g, da),
                       po.spark_loss_bwd(rec, imgs, act, g, db))


@pytest.mark.parametrize("grid", ["random", "visible", "masked"])
@pytest.mark.parametrize("rec_dtype", [torch.bfloat16, torch.float32])
def test_spark_loss_forward_writes_its_numerator(dev, rec_dtype, grid):
    """K3's forward also writes the numerator sum(l2 * masked) (data
    parallel sums it over the ranks): against the plain version's to rel
    1e-5 (sum order), the denominator exactly, and numerator / denominator
    is the kernel's own loss bit for bit (one launch)."""
    rec, imgs, act = _loss_inputs(dev, 32, 256, grid, rec_dtype, seed=6)
    n0 = po.spark_loss_pallas.launches
    loss, num, denom = po._spark_loss(rec, imgs, act, 16)
    ref_num, ref_denom = po.spark_loss_terms_plain(rec, imgs, act)
    torch.cuda.synchronize()
    assert po.spark_loss_pallas.launches == n0 + 1
    assert abs(float(num) - float(ref_num)) <= 1e-5 * abs(float(ref_num))
    assert float(denom) == float(ref_denom)
    assert torch.equal(num / denom, loss)


def test_spark_loss_autograd_runs_one_launch_each_way(dev):
    rec, imgs, act = _loss_inputs(dev, 3, 256, "random", torch.bfloat16)
    rec.requires_grad_(True)
    n0, nb0 = po.spark_loss_pallas.launches, po.spark_loss_bwd.launches
    loss = po.spark_loss_pallas_trainable(rec, imgs, act, 16)
    loss.backward()
    assert (po.spark_loss_pallas.launches, po.spark_loss_bwd.launches) == \
        (n0 + 1, nb0 + 1)
    ref = po.spark_loss_bwd_plain(rec.detach(), imgs, act,
                                  torch.ones((), device=dev))
    tol = torch.finfo(torch.bfloat16).eps * float(ref.float().abs().max())
    assert float((rec.grad.float() - ref.float()).abs().max()) <= tol


def test_wrappers_refuse_operands_on_another_device(dev):
    _, m, src, w, b, _, _ = _inputs(dev, 1, 8, 32, 4, 16)
    with pytest.raises(ValueError):
        ff.flat_conv3x3_mask_stats(src, m, w.cpu(), b, 8, 32)
    imgs = torch.zeros((1, 32, 32), device=dev)
    with pytest.raises(ValueError):
        po.spark_loss_pallas(imgs, imgs, torch.zeros((1, 2, 2)))
    with pytest.raises(ValueError):  # K3 takes 16x16 patches only
        po.spark_loss_pallas(imgs, imgs, torch.zeros((1, 4, 4), device=dev),
                             8)


@pytest.mark.parametrize("method", ["linear", "cubic"])
@pytest.mark.parametrize("B,H,W,out", [(3, 40, 56, 32), (2, 256, 256, 224)])
def test_crop_resize_kernel_matches_plain(dev, B, H, W, out, method):
    from cmx_torch.ops.augment import _crop_window_params

    g = torch.Generator(device=dev).manual_seed(3)
    imgs = torch.randn((B, H, W), generator=g, device=dev)
    params = _crop_window_params(g, B, H, W, out, (0.2, 1.0), (3 / 4, 4 / 3))
    params[0] = torch.tensor([1.6, 5.0, 0.7, 9.0], device=dev)  # rows outside
    n0 = pc.crop_resize_pallas.launches
    got = pc.crop_resize_pallas(imgs, params, out, method)
    ref = pc.crop_resize_plain(imgs, params, out, method)
    torch.cuda.synchronize()
    assert pc.crop_resize_pallas.launches == n0 + 1
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel(got, ref) <= 1e-5
    assert bool((got[0, :3] == 0).all())


# K4's banded kernel at windows the MoCo draw does not reach, (sy, ty, sx,
# tx) for each image: a 10x downscale (bands of ~21 taps linear, ~41 cubic:
# several 16-tap chunks), an 8x upscale (1-2 taps), a window partly outside
# the image (rows and columns that must be zero), and a mix.
CROP_WINDOWS = {
    "down10": [0.1, 0.0, 0.1, -0.2],
    "up8": [8.0, -8.0 * 3.25, 8.0, -8.0 * 1.5],
    "outside": [1.6, 5.0, 0.7, 9.0],
    "mixed": [0.3, -1.0, 3.0, -40.0],
}


@pytest.mark.parametrize("method", ["linear", "cubic"])
@pytest.mark.parametrize("B,H,W,out", [(4, 256, 256, 224), (4, 40, 40, 64),
                                       (4, 37, 53, 29), (1, 37, 53, 64)])
def test_crop_resize_kernel_at_any_window(dev, B, H, W, out, method):
    """Downscales, upscales, windows outside the image, out > in, odd sizes
    and B = 1, against the plain version (rel 1e-5)."""
    g = torch.Generator(device=dev).manual_seed(4)
    imgs = torch.randn((B, H, W), generator=g, device=dev)
    params = torch.tensor(list(CROP_WINDOWS.values())[:B], device=dev)
    n0 = pc.crop_resize_pallas.launches
    got = pc.crop_resize_pallas(imgs, params, out, method)
    ref = pc.crop_resize_plain(imgs, params, out, method)
    torch.cuda.synchronize()
    assert pc.crop_resize_pallas.launches == n0 + 1
    assert got.shape == ref.shape == (B, out, out)
    assert _rel(got, ref) <= 1e-5
    if B > 2:  # the window reaching above the image: exact zero rows
        assert bool((got[2, :5] == 0).all() and (ref[2, :5] == 0).all())


def test_crop_resize_refuses_rows_wider_than_its_shared_memory(dev):
    """A block keeps a strip's rows of the y pass in shared memory: one row
    of W fp32 must fit, W <= kMaxW (57344); the C entry refuses a wider
    image."""
    w = 57344 + 1
    params = torch.tensor([[1.0, 0.0, 1.0, 0.0]], device=dev)
    with pytest.raises(RuntimeError, match="CUDA error"):
        pc.crop_resize_pallas(torch.zeros((1, 1, w), device=dev), params, 4)


def _nhwc_inputs(dev, B, H, W, cin, C, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    m = (torch.rand((B, H, W), generator=g, device=dev) > 0.4)
    m = m.to(torch.bfloat16)
    src = (torch.randn((B, H, W, cin), generator=g, device=dev)
           * m.float()[..., None]).to(torch.bfloat16)
    w = torch.randn((3, 3, cin, C), generator=g, device=dev) * 0.2
    b = torch.randn((C,), generator=g, device=dev) * 0.1
    inv = torch.rand((cin,), generator=g, device=dev) + 0.5
    shift = torch.randn((cin,), generator=g, device=dev) * 0.3
    return g, m, src, w, b, inv, shift


# The tensor-core kernels' tile edges: Cin 3, 8, 24 (K not a multiple of
# 16 or of the 32-channel stage), Cout 20 and 96 (N not a multiple of the
# 64-channel block), W 40 and 24 (a partial 32-column tile), and the main
# path's widths at a small spatial size.
NHWC_SHAPES = [(2, 32, 40, 3, 20), (1, 32, 40, 64, 64), (1, 64, 32, 128, 96),
               (2, 32, 24, 128, 128), (1, 32, 40, 8, 20), (2, 32, 40, 24, 96),
               (1, 32, 32, 64, 128), (2, 32, 64, 128, 128)]


# B = 3 at 32 x 40: 3840 pixels, seven and a half of the kernel's 512-pixel
# staged runs; C 8 and 512, the narrowest and widest it takes.
@pytest.mark.parametrize("B,H,W,C", [(2, 32, 40, 64), (1, 64, 24, 20),
                                     (1, 32, 8, 1), (3, 32, 40, 64),
                                     (3, 32, 40, 8), (1, 32, 24, 512)])
@pytest.mark.parametrize("offset", [False, True])
def test_stem_kernel_matches_plain(dev, B, H, W, C, offset):
    """offset: the patches and the mask are views of flat buffers one
    element in, off every 16-byte boundary (the kernel's element copies)."""
    g, m, src, _, b, _, _ = _nhwc_inputs(dev, B, H, W, 1, C)
    patches = fc.make_patches9(src[..., 0])
    if offset:
        flat = torch.empty(patches.numel() + 1, dtype=patches.dtype,
                           device=dev)
        flat[1:] = patches.reshape(-1)
        patches = flat[1:].view(patches.shape)
        flat = torch.empty(m.numel() + 1, dtype=m.dtype, device=dev)
        flat[1:] = m.reshape(-1)
        m = flat[1:].view(m.shape)
        assert patches.data_ptr() % 16 and m.data_ptr() % 16
    w = torch.randn((9, C), generator=g, device=dev) * 0.3
    n0 = fc.conv_stem_stats.launches
    out = fc.conv_stem_stats(patches, m, w, b)
    ref = fc.conv_stem_stats_plain(patches, m, w, b)
    torch.cuda.synchronize()
    assert fc.conv_stem_stats.launches == n0 + 1
    assert out[0].dtype == torch.bfloat16 and out[0].shape == (B, H, W, C)
    assert _rel(out[0], ref[0]) <= 1e-2
    assert _rel(out[1], ref[1]) <= 1e-3 and _rel(out[2], ref[2]) <= 1e-3


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("B,H,W,cin,C", NHWC_SHAPES)
def test_nhwc_conv_kernel_matches_plain(dev, B, H, W, cin, C, pre):
    _, m, src, w, b, inv, shift = _nhwc_inputs(dev, B, H, W, cin, C)
    inv, shift = (inv, shift) if pre else (None, None)
    n0 = fc.conv3x3_mask_stats.launches
    out = fc.conv3x3_mask_stats(src, m, w, b, inv, shift)
    ref = fc.conv3x3_mask_stats_plain(src, m, w, b, inv, shift)
    torch.cuda.synchronize()
    assert fc.conv3x3_mask_stats.launches == n0 + 1
    assert out[0].shape == (B, H, W, C)
    assert _rel(out[0], ref[0]) <= 1e-2
    assert _rel(out[1], ref[1]) <= 1e-3 and _rel(out[2], ref[2]) <= 1e-3


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("B,H,W,cin,C", NHWC_SHAPES)
def test_nhwc_bwd_kernel_matches_plain(dev, B, H, W, cin, C, pre):
    g, m, src, w, b, inv, shift = _nhwc_inputs(dev, B, H, W, cin, C, seed=1)
    gy = torch.randn((B, H, W, C), generator=g, device=dev).to(torch.bfloat16)
    y = (torch.randn((B, H, W, C), generator=g, device=dev)
         * m.float()[..., None]).to(torch.bfloat16)
    vec = [torch.randn((C,), generator=g, device=dev) * 0.3 for _ in range(5)]
    vec[0] = vec[0].abs() + 0.5
    var = torch.rand((C,), generator=g, device=dev) + 0.5
    args = (gy, y, src, m, vec[0], vec[1], vec[2], var, vec[3], vec[4],
            m.float().sum(), w, (inv, shift) if pre else None)
    n0 = fc.bwd_mega.launches
    dh, dw = fc.bwd_mega(*args)
    dhr, dwr = fc.bwd_mega_plain(*args)
    torch.cuda.synchronize()
    assert fc.bwd_mega.launches == n0 + 1
    assert dh.shape == (B, H, W, cin) and dw.shape == (3, 3, cin, C)
    assert _rel(dw, dwr) <= 1e-3
    assert _rel(dh, dhr) <= 1e-2


@pytest.mark.parametrize("cin", [1, 16])
def test_fused_double_conv_on_card_matches_cpu(dev, cin):
    """Forward, stats and all gradients of FusedDoubleConv on the card
    (K6 or K7, K7, K8) against the same function on the CPU (the plain
    versions); Cin=1 runs the stem and its plain-torch backward."""
    rng = np.random.default_rng(1)
    B, H, W, C = 2, 32, 40, 16
    m = torch.from_numpy((rng.random((B, H, W)) > 0.4).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(B, H, W, cin)).astype(np.float32))
    x = x * m[..., None]
    params = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.normal(size=(3, 3, cin, C)) * 0.2, rng.normal(size=(C,)) * 0.1,
        1.0 + rng.normal(size=(C,)) * 0.1, rng.normal(size=(C,)) * 0.1,
        rng.normal(size=(3, 3, C, C)) * 0.1, rng.normal(size=(C,)) * 0.1,
        1.0 + rng.normal(size=(C,)) * 0.1, rng.normal(size=(C,)) * 0.1)]
    probe = torch.from_numpy(rng.normal(size=(B, H, W, C)).astype(np.float32))
    n0 = (fc.conv_stem_stats.launches, fc.bwd_mega.launches)
    res = []
    for d in ("cpu", dev):
        leaves = [a.detach().to(d).requires_grad_(True)
                  for a in [x.to(torch.bfloat16)] + params]
        out, stats = fc.fused_double_conv(leaves[0], m.to(d), *leaves[1:])
        (out.float() * probe.to(d)).sum().backward()
        res.append([out.detach().cpu()] + [s.cpu() for s in stats]
                   + [a.grad.cpu() for a in leaves])
    assert fc.conv_stem_stats.launches == n0[0] + (cin == 1)
    assert fc.bwd_mega.launches == n0[1] + (1 if cin == 1 else 2)
    for i, (a, b) in enumerate(zip(*res)):
        if i == 7:  # the stem's conv bias: sum(dy), cancels to rounding noise
            assert float(a.abs().max()) < 1e-2 and float(b.abs().max()) < 1e-2
            continue
        tol = 1e-3 if i in (1, 2, 3, 4) else 3e-2
        if float(b.abs().max()) == 0.0:
            assert float(a.abs().max()) == 0.0, i
        else:
            assert _rel(a, b) <= tol, (i, _rel(a, b))


# decoder/up1's two stages in the fused fine-tune UNet at full width: 2 * 64
# = 128 -> 64 (the concat of the ConvTranspose's output and the skip) and
# 64 -> 64 with the pre-norm, at 256^2 with an all-ones mask (the decoder
# runs unmasked) and dX needed in both (up1's input is an activation).
UP1_STAGES = [(128, 64, False), (64, 64, True)]


def _up1_operands(dev, B, H, W, cin, C, nhwc):
    """(g, all-ones mask, src, w, b, prev fold or None, gy, y, vecs, var)
    for an up1 stage: flat (B, C, H*W) or NHWC operands."""
    g = torch.Generator(device=dev).manual_seed(cin + C)
    bf16 = torch.bfloat16
    shape = (lambda c: (B, H, W, c)) if nhwc else (lambda c: (B, c, H * W))
    m = torch.ones((B, H, W) if nhwc else (B, 1, H * W), dtype=bf16,
                   device=dev)
    src = torch.randn(shape(cin), generator=g, device=dev).to(bf16)
    w = torch.randn((3, 3, cin, C), generator=g, device=dev) * 0.1
    b = torch.randn((C,), generator=g, device=dev) * 0.1
    inv = torch.rand((cin,), generator=g, device=dev) + 0.5
    shift = torch.randn((cin,), generator=g, device=dev) * 0.3
    gy = torch.randn(shape(C), generator=g, device=dev).to(bf16)
    y = torch.randn(shape(C), generator=g, device=dev).to(bf16)
    vec = [torch.randn((C,), generator=g, device=dev) * 0.3 for _ in range(5)]
    vec[0] = vec[0].abs() + 0.5
    var = torch.rand((C,), generator=g, device=dev) + 0.5
    return m, src, w, b, (inv, shift), gy, y, vec, var


@pytest.mark.parametrize("cin,C,pre", UP1_STAGES)
def test_flat_kernels_at_up1_shapes(dev, cin, C, pre):
    """K1 and K2 (dX on) at up1's stages of the fused fine-tune UNet, B 2,
    against their plain versions."""
    B, H, W = 2, 256, 256
    m, src, w, b, fold, gy, y, vec, var = _up1_operands(dev, B, H, W, cin, C,
                                                        nhwc=False)
    prev = fold if pre else (None, None)
    out = ff.flat_conv3x3_mask_stats(src, m, w, b, H, W, *prev)
    ref = ff.flat_conv3x3_mask_stats_plain(src, m, w, b, H, W, *prev)
    args = (gy, y, src, m, vec[0], vec[1], vec[2], var, vec[3], vec[4],
            m.float().sum(), w, H, W, fold if pre else None, True)
    n0 = ff.flat_bwd_mega.launches
    dh, dw = ff.flat_bwd_mega(*args)
    dhr, dwr = ff.flat_bwd_mega_plain(*args)
    torch.cuda.synchronize()
    assert ff.flat_bwd_mega.launches == n0 + 1
    assert _rel(out[0], ref[0]) <= 1e-2
    assert _rel(out[1], ref[1]) <= 1e-3 and _rel(out[2], ref[2]) <= 1e-3
    assert dh.shape == (B, cin, H * W)
    assert _rel(dw, dwr) <= 1e-3 and _rel(dh, dhr) <= 1e-2


@pytest.mark.parametrize("cin,C,pre", UP1_STAGES)
def test_nhwc_kernels_at_up1_shapes(dev, cin, C, pre):
    """K7 and K8 at up1's stages (FUSED_IMPL="nhwc"), B 2, against their
    plain versions."""
    B, H, W = 2, 256, 256
    m, src, w, b, fold, gy, y, vec, var = _up1_operands(dev, B, H, W, cin, C,
                                                        nhwc=True)
    prev = fold if pre else (None, None)
    out = fc.conv3x3_mask_stats(src, m, w, b, *prev)
    ref = fc.conv3x3_mask_stats_plain(src, m, w, b, *prev)
    args = (gy, y, src, m, vec[0], vec[1], vec[2], var, vec[3], vec[4],
            m.float().sum(), w, fold if pre else None)
    n0 = fc.bwd_mega.launches
    dh, dw = fc.bwd_mega(*args)
    dhr, dwr = fc.bwd_mega_plain(*args)
    torch.cuda.synchronize()
    assert fc.bwd_mega.launches == n0 + 1
    assert _rel(out[0], ref[0]) <= 1e-2
    assert _rel(out[1], ref[1]) <= 1e-3 and _rel(out[2], ref[2]) <= 1e-3
    assert dh.shape == (B, H, W, cin)
    assert _rel(dw, dwr) <= 1e-3 and _rel(dh, dhr) <= 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 32, 40, 64), (1, 8, 24, 20),
                                   (1, 4, 8, 200)])
def test_bn_relu_mask_kernel_matches_plain(dev, dtype, shape):
    g = torch.Generator(device=dev).manual_seed(4)
    B, H, W, C = shape
    x = (torch.randn(shape, generator=g, device=dev) * 2).to(dtype)
    scale = torch.randn((C,), generator=g, device=dev) * 0.5 + 1.0
    bias = torch.randn((C,), generator=g, device=dev) * 0.3
    mask = (torch.rand((B, H, W, 1), generator=g, device=dev) > 0.4).float()
    n0 = po.bn_relu_mask_pallas.launches
    out = po.bn_relu_mask_pallas(x, scale, bias, mask)
    ref = po.bn_relu_mask_plain(x, scale, bias, mask)
    torch.cuda.synchronize()
    assert po.bn_relu_mask_pallas.launches == n0 + 1
    assert out.dtype == dtype and out.shape == x.shape
    assert _rel(out, ref) <= (1e-6 if dtype == torch.float32 else 1e-2)


# Spill bytes each tensor-core kernel may have (ptxas -v): the forward's 64
# accumulators sit at the 128-register cap of two blocks an SM
# (csrc/conv3x3_mma.cuh), where ptxas spills 8 bytes in one instance of each
# layout.
SPILL_BUDGET = {"cmx::conv3x3_mma_kernel<true,true>": 8,
                "cmx::flat_conv3x3_mma_kernel<false,true>": 8}


def _assert_on_the_tensor_cores(want):
    from cmx_torch.ops import _build

    for lib, kernels in want.items():
        counts = _build.sass_counts(_build.dump_sass(lib))
        for k in kernels:
            assert sum(counts[k].values()) > 0, (lib, k, counts.get(k))
        usage = _build.ptxas_usage(_build.build_log(lib))
        for k in kernels:
            if k in usage:
                budget = SPILL_BUDGET.get(k, 0)
                assert max(usage[k][1:]) <= budget, (k, usage[k])


def test_nhwc_kernels_run_on_the_tensor_cores(dev):
    """K7's conv and K8's dX and dW kernels hold tensor-core instructions
    (cuobjdump --dump-sass of the built libraries) and spill no more than
    SPILL_BUDGET (ptxas -v, from the build's log)."""
    _assert_on_the_tensor_cores(
        {"nhwc_conv_fwd": ["cmx::conv3x3_mma_kernel<true,true>",
                           "cmx::conv3x3_mma_kernel<false,true>"],
         "nhwc_conv_bwd": ["cmx::conv3x3_mma_kernel<false,false>",
                           "cmx::conv3x3_dw_mma_kernel<true>",
                           "cmx::conv3x3_dw_mma_kernel<false>"]})


def test_flat_kernels_run_on_the_tensor_cores(dev):
    """K1's conv and K2's dX and dW kernels, the channel-major instances,
    as test_nhwc_kernels_run_on_the_tensor_cores."""
    _assert_on_the_tensor_cores(
        {"flat_conv_fwd": ["cmx::flat_conv3x3_mma_kernel<true,true>",
                           "cmx::flat_conv3x3_mma_kernel<false,true>"],
         "flat_conv_bwd": ["cmx::flat_conv3x3_mma_kernel<false,false>",
                           "cmx::flat_dw_mma_kernel<true>",
                           "cmx::flat_dw_mma_kernel<false>"]})


def test_nhwc_libraries_report_the_wrappers_tile_geometry(dev):
    import ctypes

    from cmx_torch.ops import fused_conv as fc

    for lib in ("nhwc_conv_fwd", "nhwc_conv_bwd", "flat_conv_fwd",
                "flat_conv_bwd"):
        g = (ctypes.c_int * len(fc._MMA_GEOMETRY))()
        assert fc._mma_lib(lib).cmx_mma_geometry(g) == 0
        assert tuple(g) == fc._MMA_GEOMETRY


def test_nhwc_wrappers_refuse_what_the_kernels_do_not_take(dev):
    _, m, src, w, b, inv, shift = _nhwc_inputs(dev, 1, 32, 40, 8, 16)
    with pytest.raises(TypeError):
        fc.conv3x3_mask_stats(src.float(), m, w, b)
    with pytest.raises(ValueError):  # w on another device
        fc.conv3x3_mask_stats(src, m, w.cpu(), b)
    for H, W in ((24, 40), (32, 36)):  # H % 32, W % 8
        _, m2, src2, w2, b2, _, _ = _nhwc_inputs(dev, 1, H, W, 8, 16)
        with pytest.raises(ValueError):
            fc.conv3x3_mask_stats(src2, m2, w2, b2)
    patches = fc.make_patches9(src[..., 0])
    with pytest.raises(ValueError):  # wider than the stem kernel takes
        fc.conv_stem_stats(patches, m, torch.zeros((9, 600), device=dev),
                           torch.zeros((600,), device=dev))
    gy = torch.zeros((1, 32, 40, 16), dtype=torch.bfloat16, device=dev)
    vec = torch.ones((16,), device=dev)
    with pytest.raises(ValueError):  # w of the wrong shape
        fc.bwd_mega(gy, gy, src, m, vec, vec, vec, vec, vec, vec,
                    m.float().sum(), w[:, :, :4])
    x = torch.zeros((1, 4, 8, 16), dtype=torch.float16, device=dev)
    mask = torch.ones((1, 4, 8, 1), device=dev)
    with pytest.raises(TypeError):
        po.bn_relu_mask_pallas(x, vec, vec, mask)
    with pytest.raises(ValueError):
        po.bn_relu_mask_pallas(x.float(), vec, vec, mask.cpu())


def _cmunet_state(device, dtype=torch.float32):
    """The CM-UNet task at full width, view 32, computing in `dtype`, AdamW
    on the preset's warm-up (lr 0 at the first step), weights and extra
    from seeds, on `device`."""
    from cmx_torch.ssl.cmunet import CMUNetOnline, make_cmunet_task
    from cmx_torch.train.optim import make_optimizer
    from cmx_torch.train.schedules import warmup_cosine
    from cmx_torch.train.state import TrainState
    from cmx_torch.train.trainer import make_train_step

    model = CMUNetOnline(dtype, 32)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(device)
    task, _ = make_cmunet_task(model, view_size=32, augment=False)
    extra = task.init_extra(torch.Generator().manual_seed(1))
    tx = make_optimizer("adamw", warmup_cosine(1e-3, 10, 2), 0.05,
                        clip_norm=5.0, named_params=model.named_parameters())
    return (TrainState.create(model=model, tx=tx, extra=extra),
            make_train_step(task, tx))


def test_cmunet_fp32_step_on_card_matches_cpu(dev):
    """Two CM-UNet steps (fp32, view 32, batch 4, the same masks) on the card
    against the port on the CPU: loss, loss_ct and loss_rc within 1e-4
    relative (the second step's forward runs on parameters the first left
    equal: its lr is 0), the target's BN running stats within 1e-4, the
    reduce kernel unchanged, no K1/K2 launch (cmx builds CM-UNet unfused;
    the norms run the norm kernels in fp32 on the card)."""
    from cmx_torch.ops.masking import random_patch_mask

    rng = np.random.default_rng(9)
    imgs = torch.from_numpy(rng.normal(size=(4, 64, 64)).astype(np.float32))
    gen = torch.Generator().manual_seed(2)
    actives = [random_patch_mask(gen, 4, 32, 16, 0.65) for _ in range(2)]
    n0 = (ff.flat_conv3x3_mask_stats.launches, ff.flat_bwd_mega.launches)
    res = []
    for d in ("cpu", dev):
        state, step = _cmunet_state(d)
        kernel = state.extra["reduce_kernel"].clone()
        ms = [step(state, imgs.to(d), {"active": a.to(d)}) for a in actives]
        res.append(([{k: float(v) for k, v in m.items()} for m in ms],
                    [b.cpu() for b in state.extra["target_model"].buffers()]))
        assert torch.equal(state.extra["reduce_kernel"], kernel)
    assert (ff.flat_conv3x3_mask_stats.launches,
            ff.flat_bwd_mega.launches) == n0
    for ref, got in zip(res[0][0], res[1][0]):
        assert got["nonfinite"] == 0.0
        for k in ("loss", "loss_ct", "loss_rc"):
            assert abs(got[k] - ref[k]) <= 1e-4 * abs(ref[k]), (k, got, ref)
    for a, b in zip(res[1][1], res[0][1]):
        assert _rel(a, b) <= 1e-4


def test_mae_fused_step_on_card_runs_k1_k2_and_matches_plain(dev, monkeypatch):
    """One MAE train step on the fused bf16 UNet (reduced widths, 64^2,
    FUSED_MIN_HW patched to 32: down1, down2, up2 and up1 fused) on the
    card: K1 8 and K2 8 launches; its loss within 2e-2 relative and its BN
    running stats within 5e-2 of the unfused model's step from the same
    weights and mask (chip_smoke.py's bf16 margins)."""
    from cmx_torch.models.unet import UNet
    from cmx_torch.ops.masking import random_patch_mask
    from cmx_torch.ssl.reconstruction import make_mae_task
    from cmx_torch.train.optim import make_optimizer
    from cmx_torch.train.state import TrainState
    from cmx_torch.train.trainer import make_train_step

    monkeypatch.setattr(fc, "FUSED_MIN_HW", 32)
    g = torch.Generator(device=dev).manual_seed(4)
    imgs = torch.randn((2, 64, 64), generator=g, device=dev)
    active = random_patch_mask(g, 2, 64, 16, 0.5)
    out = {}
    for fused in (True, False):
        model = UNet(out_classes=1, widths=(8, 16, 32, 64), bottleneck=128,
                     dtype=torch.bfloat16, fused=fused)
        model.reset_parameters(torch.Generator().manual_seed(0))
        model = model.to(dev)
        task, _ = make_mae_task(model)
        tx = make_optimizer("sgd", 1e-2, named_params=model.named_parameters())
        state = TrainState.create(model=model, tx=tx)
        n0 = (ff.flat_conv3x3_mask_stats.launches, ff.flat_bwd_mega.launches)
        m = make_train_step(task, tx)(state, imgs, {"active": active})
        torch.cuda.synchronize()
        n1 = (ff.flat_conv3x3_mask_stats.launches, ff.flat_bwd_mega.launches)
        assert (n1[0] - n0[0], n1[1] - n0[1]) == ((8, 8) if fused else (0, 0))
        out[fused] = (float(m["loss"]), float(m["nonfinite"]),
                      dict(model.named_buffers()))
    assert out[True][1] == 0.0
    assert abs(out[True][0] - out[False][0]) <= 2e-2 * abs(out[False][0])
    for n, b in out[False][2].items():
        assert float((out[True][2][n] - b).abs().max()) <= 5e-2, n


def _cpu_genesis_draws(b, h, seed, exact_shuffle=False):
    from cmx_torch.ops.genesis import genesis_draws

    return genesis_draws(torch.Generator().manual_seed(seed), b, h, h,
                         exact_shuffle=exact_shuffle)


def test_genesis_chain_on_card_matches_cpu(dev):
    """The Genesis chain on the card against itself on the CPU with the
    same injected draws (batch 6, 64^2): the flips, both shuffles, the
    exact remap and both paintings bit for bit; the fit remap (a batched
    10x10 solve on the card) within 1e-4 of each image's span, and so the
    whole pair: y bit for bit, x within 1e-4 of the span."""
    from cmx_torch.ops import genesis as tg

    imgs = torch.randn((6, 64, 64), generator=torch.Generator().manual_seed(1))
    d = _cpu_genesis_draws(6, 64, 2, exact_shuffle=True)
    dc = {k: v.to(dev) for k, v in d.items()}
    x, xc = imgs, imgs.to(dev)
    span = (imgs.amax((1, 2)) - imgs.amin((1, 2)))[:, None, None]
    for fn, kw in ((tg.local_pixel_shuffling, dict(prob=1.0)),
                   (tg.local_pixel_shuffling, dict(prob=1.0, exact=True)),
                   (tg.nonlinear_transformation, dict(prob=1.0, exact=True)),
                   (tg.image_in_painting, {}), (tg.image_out_painting, {})):
        assert torch.equal(fn(xc, dc, **kw).cpu(), fn(x, d, **kw)), fn
    fit = tg.nonlinear_transformation(xc, dc, prob=1.0).cpu()
    assert bool(((fit - tg.nonlinear_transformation(x, d, prob=1.0)).abs()
                 <= 1e-4 * span).all())
    (px, py), (cx, cy) = tg.genesis_batch(xc, None, dc), tg.genesis_batch(
        x, None, d)
    assert torch.equal(py.cpu(), cy)
    assert bool(((px.cpu() - cx).abs() <= 1e-4 * span).all())


def test_genesis_batch_makes_no_host_sync(dev):
    """genesis_batch at batch 8, 256^2, its draws from a generator on the
    card, under torch.cuda.set_sync_debug_mode("error"): no host
    synchronisation anywhere in the chain (no .item(), no tensor-shift
    roll, the solve without its error check)."""
    from cmx_torch.ops.genesis import genesis_batch

    g = torch.Generator(device=dev).manual_seed(3)
    imgs = torch.randn((8, 256, 256), generator=g, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        x, y = genesis_batch(imgs, g)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(x).all()) and x.shape == y.shape == imgs.shape


def _variant(kind, fused):
    """A small bf16 model of decoder variant `kind` ("spark_light",
    "spark_fused_decoder", "unet_bilinear") with seeded weights, and its
    loss on (imgs, active)."""
    from cmx_torch.models.unet import UNet
    from cmx_torch.ssl.spark import SparKModel, spark_loss

    kw = dict(widths=(8, 16, 32, 64), dtype=torch.bfloat16, fused=fused)
    if kind == "unet_bilinear":
        model = UNet(1, bottleneck=128, up_sample_mode="bilinear", **kw)

        def loss(m, imgs, active):
            return torch.square(m(imgs * active)[:, 0] - imgs).mean()
    else:
        model = SparKModel(bottleneck_width=128, decoder_width=32,
                           full_unet=kind != "spark_light",
                           fused_decoder=kind == "spark_fused_decoder", **kw)

        def loss(m, imgs, active):
            grid = active[:, ::16, ::16]
            return spark_loss(m(imgs, grid), imgs, grid)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model, loss


@pytest.mark.parametrize("kind,launches", [
    ("spark_light", 4), ("spark_fused_decoder", 6), ("unet_bilinear", 4)])
def test_decoder_variants_fused_on_card_match_plain(dev, monkeypatch, kind,
                                                    launches):
    """Each decoder variant, fused in bf16 on the card (reduced widths,
    64^2, FUSED_MIN_HW patched to 32 and FUSED_MAX_CIN to 16, the cut the
    full-width gate makes: the bilinear up1's concat 16 + 8 stays
    unfused, and of the fused decoder only up1, 2 * 8, passes), one
    forward and backward: K1 and K2 `launches` each (the encoder's down1
    and down2; with the fused decoder up1 too);
    the loss within 2e-2 relative and the BN running stats within 5e-2 of
    the unfused model's from the same weights and mask."""
    from cmx_torch.ops.masking import random_patch_mask

    monkeypatch.setattr(fc, "FUSED_MIN_HW", 32)
    monkeypatch.setattr(fc, "FUSED_MAX_CIN", 16)
    g = torch.Generator(device=dev).manual_seed(5)
    imgs = torch.randn((2, 64, 64), generator=g, device=dev)
    active = random_patch_mask(g, 2, 64, 16, 0.5)
    out = {}
    for fused in (True, False):
        model, loss_fn = _variant(kind, fused)
        model = model.to(dev).train()
        n0 = (ff.flat_conv3x3_mask_stats.launches, ff.flat_bwd_mega.launches)
        loss = loss_fn(model, imgs, active)
        loss.backward()
        torch.cuda.synchronize()
        n1 = (ff.flat_conv3x3_mask_stats.launches, ff.flat_bwd_mega.launches)
        want = launches if fused else 0
        assert (n1[0] - n0[0], n1[1] - n0[1]) == (want, want)
        out[fused] = (float(loss.detach()), dict(model.named_buffers()))
    assert abs(out[True][0] - out[False][0]) <= 2e-2 * abs(out[False][0])
    for n, b in out[False][1].items():
        assert float((out[True][1][n] - b).abs().max()) <= 5e-2, n


@pytest.mark.parametrize("impl,recomputed", [
    ("flat", {"flat_conv3x3_mask_stats": 4}),
    ("nhwc", {"conv_stem_stats": 1, "conv3x3_mask_stats": 3})])
def test_remat_step_on_card_equals_the_step_without(dev, monkeypatch, impl,
                                                    recomputed):
    """One SparK train step (reduced widths, 64^2, bf16, fused, K3, LAMB;
    FUSED_MIN_HW patched to 32: down1 and down2 fused) with
    remat_levels e1,e2,d1,d2 and without, from the same weights, images
    and draws: the loss and every BN running statistic bit for bit equal
    (the recomputed K1, or K6/K7 under FUSED_IMPL="nhwc", writes the bits
    of the first launch; the running statistics update once), the grad
    norm within 1e-3 relative (cuDNN's backward may sum in another
    order); the recompute launches the forward kernels of down1 and down2
    again (`recomputed`), the backward kernels no more."""
    from cmx_torch.ops.augment import _crop_window_params
    from cmx_torch.ops.masking import spark_active_mask
    from cmx_torch.ssl.spark import SparKModel, make_spark_task
    from cmx_torch.train.optim import make_optimizer
    from cmx_torch.train.state import TrainState
    from cmx_torch.train.trainer import make_train_step

    monkeypatch.setattr(fc, "FUSED_MIN_HW", 32)
    monkeypatch.setattr(fc, "FUSED_IMPL", impl)
    wrappers = {"flat_conv3x3_mask_stats": ff.flat_conv3x3_mask_stats,
                "flat_bwd_mega": ff.flat_bwd_mega,
                "conv_stem_stats": fc.conv_stem_stats,
                "conv3x3_mask_stats": fc.conv3x3_mask_stats,
                "bwd_mega": fc.bwd_mega}
    g = torch.Generator(device=dev).manual_seed(6)
    imgs = torch.randn((2, 64, 64), generator=g, device=dev)
    draws = {"crop": _crop_window_params(g, 2, 64, 64, 64, (0.67, 1.0),
                                         (3 / 4, 4 / 3)),
             "flip": torch.tensor([True, False], device=dev),
             "active": spark_active_mask(g, 2, 4, 0.6)}
    out = {}
    for levels in ((), ("e1", "e2", "d1", "d2")):
        model = SparKModel(widths=(8, 16, 32, 64), bottleneck_width=128,
                           fused=True, remat_levels=levels)
        model.reset_parameters(torch.Generator().manual_seed(0))
        model = model.to(dev)
        task, _ = make_spark_task(model, input_size=64, pallas_loss=True)
        tx = make_optimizer("lamb", 2e-4, 0.04, clip_norm=5.0,
                            named_params=model.named_parameters())
        state = TrainState.create(model=model, tx=tx)
        n0 = {k: w.launches for k, w in wrappers.items()}
        m = make_train_step(task, tx)(state, imgs, draws)
        torch.cuda.synchronize()
        out[levels] = (float(m["loss"]), float(m["grad_norm"]),
                       {k: w.launches - n0[k] for k, w in wrappers.items()},
                       {n: b.clone() for n, b in model.named_buffers()})
    (l0, g0, n0, b0), (l1, g1, n1, b1) = out.values()
    assert l1 == l0 and abs(g1 - g0) <= 1e-3 * g0
    for n, b in b0.items():
        assert torch.equal(b1[n], b), n
    assert {k: n1[k] - n0[k] for k in n0} == {
        k: recomputed.get(k, 0) for k in n0}
    assert all(n0[k] for k in recomputed)


def _graph_against_eager(dev, make, steps=4):
    """`make()` -> (state, step, corpus) twice from the same seeds: `steps`
    eager steps (make_train_step) on the first, the same steps through a
    StepGraph on the second (warm-up, capture, steps - 1 replays), each
    step's rows gathered from `corpus` by the same permutation. Asserts
    every state tensor and metric equal bit for bit and returns the
    graph's report."""
    from cmx_torch.train.graph import StepGraph

    states, rows = [], []
    for kind in ("eager", "graph"):
        state, step, corpus = make()
        c = corpus if isinstance(corpus, tuple) else (corpus,)

        def gather(idx, c=c):
            out = tuple(t.index_select(0, idx) for t in c)
            return out if len(out) > 1 else out[0]

        g = torch.Generator().manual_seed(11)
        idxs = [torch.randperm(c[0].shape[0], generator=g).to(dev)
                for _ in range(steps)]
        graph = StepGraph(step.body, gather, dev)
        r = []
        for idx in idxs:
            if kind == "eager":
                m = step(state, gather(idx))
                r.append(torch.stack([m[k].float() for k in m]))
            else:
                r.append(graph.step(state, idx))
        torch.cuda.synchronize()
        states.append(state)
        rows.append(torch.stack(r))
    assert torch.equal(rows[0], rows[1])
    assert bool(torch.isfinite(rows[1]).all())
    for (n, t), u in zip(_state_tensors(states[0]).items(),
                         _state_tensors(states[1]).values()):
        assert torch.equal(t, u), n
    rep = graph.report
    assert (rep["eager_steps"], rep["replays"]) == (1, steps - 1)
    return rep


def _state_tensors(state):
    out = {f"model/{n}": t for n, t in state.model.state_dict().items()}
    for k, v in state.opt.state_dict().items():
        for i, t in enumerate(v if isinstance(v, list) else [v]):
            out[f"opt/{k}/{i}"] = t
    for k, v in (state.extra or {}).items():
        if isinstance(v, torch.nn.Module):
            out.update({f"extra/{k}/{n}": t
                        for n, t in v.state_dict().items()})
        else:
            out[f"extra/{k}"] = v
    return out


GRAPH_WIDTHS = dict(widths=(8, 16, 32, 64))


def _graph_spark(dev):
    from cmx_torch.ssl.spark import SparKModel, make_spark_task
    from cmx_torch.train.optim import make_optimizer
    from cmx_torch.train.state import TrainState
    from cmx_torch.train.trainer import make_train_step

    model = SparKModel(bottleneck_width=128, fused=True, **GRAPH_WIDTHS)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(dev)
    task, _ = make_spark_task(model, input_size=64, pallas_loss=True)
    tx = make_optimizer("lamb", 2e-4, 0.04, clip_norm=5.0,
                        named_params=model.named_parameters())
    imgs = torch.randn((4, 64, 64), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    return TrainState.create(model=model, tx=tx, seed=3), \
        make_train_step(task, tx), imgs


def _graph_moco(dev):
    from cmx_torch.models.unet import UNetEncoderGAP
    from cmx_torch.ssl.moco import make_moco_task
    from cmx_torch.train.optim import make_optimizer
    from cmx_torch.train.state import TrainState
    from cmx_torch.train.trainer import make_train_step

    model = UNetEncoderGAP(bottleneck=128, **GRAPH_WIDTHS)
    model.reset_parameters(torch.Generator().manual_seed(2))
    model = model.to(dev)
    task, _ = make_moco_task(model, num_negatives=8, view_size=32,
                             crop_impl="pallas")
    tx = make_optimizer("sgd", 0.03, 1e-4,
                        named_params=model.named_parameters())
    g = torch.Generator(device=dev).manual_seed(3)
    extra = task.init_extra(g)
    imgs = torch.randn((4, 48, 48), generator=g, device=dev) + 1.0
    return TrainState.create(model=model, tx=tx, seed=7, extra=extra), \
        make_train_step(task, tx), imgs


def _graph_genesis(dev):
    from cmx_torch.models.unet import UNet
    from cmx_torch.ssl.reconstruction import make_genesis_task
    from cmx_torch.train.optim import make_optimizer
    from cmx_torch.train.state import TrainState
    from cmx_torch.train.trainer import make_train_step

    model = UNet(out_classes=1, bottleneck=128, fused=True, **GRAPH_WIDTHS)
    model.reset_parameters(torch.Generator().manual_seed(4))
    model = model.to(dev)
    task, _ = make_genesis_task(model)
    tx = make_optimizer("sgd", 1e-2, momentum=0.9,
                        named_params=model.named_parameters())
    imgs = torch.rand((4, 64, 64), generator=torch.Generator(
        device=dev).manual_seed(5), device=dev)
    return TrainState.create(model=model, tx=tx, seed=9), \
        make_train_step(task, tx), imgs


SPARK_NORMS = {"norm_moments": 19, "norm_apply": 19, "norm_grad_sums": 19,
               "norm_grad_input": 19, "norm_kernel_channels_last": 17,
               "norm_kernel_channels_first": 2}


@pytest.mark.parametrize("case,calls", [
    ("spark", {"flat_conv3x3_mask_stats": 4, "flat_bwd_mega": 4,
               "spark_loss_pallas": 1, "spark_loss_bwd": 1,
               "library_conv_channels_last": 19, **SPARK_NORMS}),
    ("moco", {"crop_resize_pallas": 2, "library_conv_channels_last": 20,
              "norm_moments": 20, "norm_apply": 20, "norm_grad_sums": 10,
              "norm_grad_input": 10, "norm_kernel_channels_last": 20}),
    ("genesis", {"flat_conv3x3_mask_stats": 8, "flat_bwd_mega": 8,
                 "library_conv_channels_last": 15, "norm_moments": 10,
                 "norm_apply": 10, "norm_grad_sums": 10,
                 "norm_grad_input": 10, "norm_kernel_channels_last": 10})])
def test_graph_replays_equal_eager_steps(dev, monkeypatch, case, calls):
    """A capture and 3 replays against 4 eager steps from the same state,
    weights and batches (reduced widths, bf16, 64^2 or 48^2; FUSED_MIN_HW
    patched to 32; cuDNN deterministic in both, as two eager runs need):
    every parameter, BN buffer, optimizer state, `extra` tensor and metric
    bit for bit; the capture called the kernel wrappers one step's worth
    (SparK fused flat with K3: K1 4, K2 4, K3 1 + 1; MoCo: K4 2; Genesis:
    K1 8, K2 8) and its library convolutions all ran channels-last (SparK
    the encoder's three unfused levels and the unfused decoder: 19; MoCo
    two encoders: 20; Genesis three unfused levels of each half, four
    up-convs and the head: 15); every batch norm outside K1/K2 ran through
    the norm kernels, none plain (SparK: 6 of the encoder, 5 densify norms
    of which the two at the fused levels read channel-major maps, 8 of the
    decoder; MoCo: 10 a encoder, the key encoder's without a backward;
    Genesis: 10)."""
    monkeypatch.setattr(fc, "FUSED_MIN_HW", 32)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    make = {"spark": _graph_spark, "moco": _graph_moco,
            "genesis": _graph_genesis}[case]
    rep = _graph_against_eager(dev, lambda: make(dev))
    assert rep["capture_calls"] == calls


@pytest.mark.parametrize("variant", ["shift_max", "two_pass"])
def test_graph_replays_equal_eager_steps_under_bn_variants(dev, monkeypatch,
                                                           variant):
    """The SparK case above with CMX_BN_VARIANT's shift_max (a MAX
    all-reduce's worth of work: the subsample max, on the device) or
    two_pass (a second pass over every unfused activation): the capture
    meets no host sync, replays equal eager steps bit for bit, and the
    fused stages' kernel calls do not change (two_pass runs the norms'
    moments kernel twice)."""
    from cmx_torch.models import blocks

    monkeypatch.setattr(blocks, "BN_VARIANT", variant)
    monkeypatch.setattr(fc, "FUSED_MIN_HW", 32)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    rep = _graph_against_eager(dev, lambda: _graph_spark(dev))
    assert rep["capture_calls"] == {
        "flat_conv3x3_mask_stats": 4, "flat_bwd_mega": 4,
        "spark_loss_pallas": 1, "spark_loss_bwd": 1,
        "library_conv_channels_last": 19, **SPARK_NORMS,
        "norm_moments": 38 if variant == "two_pass" else 19}


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("variant", ["shift_ra", "shift_max", "two_pass",
                                     "naive"])
def test_bn_variant_on_card_matches_cpu(dev, monkeypatch, variant, masked):
    """MaskedBatchNorm(bf16) under each CMX_BN_VARIANT on the card against
    the same module on the CPU, from the same input, mask and output
    cotangent: running mean and var rel 1e-5 (fp32 sums in another order),
    the bf16 output and input gradient within 1e-2 of their largest entry
    (a bf16 ulp flip)."""
    from cmx_torch.models import blocks

    monkeypatch.setattr(blocks, "BN_VARIANT", variant)
    g = torch.Generator().manual_seed(0)
    x = (torch.randn((4, 16, 32, 32), generator=g) + 0.5).to(torch.bfloat16)
    m = (torch.rand((4, 1, 32, 32), generator=g) > 0.4).float() \
        if masked else None
    gy = torch.randn((4, 16, 32, 32), generator=g)
    got = []
    for d in ("cpu", dev):
        bn = blocks.MaskedBatchNorm(16, torch.bfloat16).to(d).train()
        with torch.no_grad():
            bn.mean.fill_(0.25)
        xi = x.to(d).detach().requires_grad_()
        y = bn(xi, None if m is None else m.to(d))
        (y.float() * gy.to(d)).sum().backward()
        got.append([t.detach().float().cpu() for t in (y, xi.grad, bn.mean,
                                                        bn.var)])
    (y0, dx0, mean0, var0), (y1, dx1, mean1, var1) = got
    assert torch.allclose(mean1, mean0, rtol=1e-5, atol=1e-7)
    assert torch.allclose(var1, var0, rtol=1e-5, atol=0)
    assert _rel(y1, y0) <= 1e-2
    assert _rel(dx1, dx0) <= 1e-2


def test_fit_through_the_graph_equals_the_eager_fit(dev, monkeypatch):
    """harness.fit's _fit_scan counterpart (reduced widths, the fused bf16
    UNet, FUSED_MIN_HW 32: K1/K2 at 64^2 and 32^2; 4 training images at
    batch 2, 2 epochs: a warm-up, a capture and 3 replays) against the
    same fit with every step eager: the train and validation logs and the
    final (best) state bit for bit."""
    from cmx_torch.models.unet import UNet
    from cmx_torch.train import harness
    from cmx_torch.train.graph import StepGraph

    class EagerSteps(StepGraph):
        def step(self, state, idx):
            return self._eager(state, idx)

    monkeypatch.setattr(fc, "FUSED_MIN_HW", 32)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(7, 64, 64)).astype(np.float32)
    fg = rng.normal(size=(7, 64, 64)) > 1.0
    y = np.stack([~fg, fg], -1).astype(np.float32)
    model = UNet(out_classes=2, bottleneck=128, fused=True, **GRAPH_WIDTHS)
    model.reset_parameters(torch.Generator().manual_seed(0))
    graphs = []
    res = {}
    for kind in ("graph", "eager"):
        if kind == "eager":
            monkeypatch.setattr(harness, "StepGraph", EagerSteps)
        n0 = ff.flat_bwd_mega.launches
        res[kind] = harness.fit(x[:4], y[:4], x[4:], y[4:], lr=1e-3,
                                epochs=2, batch=2, model=model, device=dev)
        graphs.append(ff.flat_bwd_mega.launches - n0)
    assert graphs == [8 + 8, 8 * 4]  # the warm-up and the capture; 4 steps
    a, b = res["graph"], res["eager"]
    assert a.train_logs == b.train_logs and a.valid_logs == b.valid_logs
    for (n, t), u in zip(a.state.model.state_dict().items(),
                         b.state.model.state_dict().values()):
        assert torch.equal(t, u), n


@pytest.mark.parametrize("hazard", ["item", "pageable copy"])
def test_a_capture_that_meets_a_host_sync_raises(dev, hazard):
    """A body that reads a value on the host (.item()) or copies from
    pageable host memory runs eagerly as the warm-up and raises
    GraphCaptureError at the capture, naming the line; nothing falls back
    to eager steps."""
    from cmx_torch.train.graph import GraphCaptureError, StepGraph
    from cmx_torch.train.state import TrainState

    corpus = torch.randn((4, 8), device=dev)

    def body(state, batch, gen):
        if hazard == "item":
            scale = batch.sum().item()
        else:
            scale = torch.ones(()).to(dev)
        return {"loss": batch.sum() * scale}

    state = TrainState(step=0, model=None, opt=None)
    graph = StepGraph(body, lambda idx: corpus.index_select(0, idx), dev)
    idx = torch.arange(4, device=dev)
    graph.step(state, idx)
    with pytest.raises(GraphCaptureError, match="in body: scale = "):
        graph.step(state, idx)
    assert graph.graph is None and state.step == 1


def test_graph_replays_the_span_markers_in_capture_order(dev, monkeypatch):
    """A CM-UNet step (full width, fp32, view 32, batch 4) captured with the
    program's spans on: the graph's report counts the markers launched
    while it was captured (`capture_calls["span_mark"]`), and each of two
    profiled replays runs exactly those markers, in capture order, opens
    and closes paired."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cmx_torch.train.graph import StepGraph
    from cmx_torch.utils import profiling

    monkeypatch.setattr(profiling, "_spans_on", True)
    launched = []
    mark = profiling._Span._mark

    def logged(self, close, device):
        if device is not None:
            launched.append(f"cmx::span_{'close' if close else 'open'}_"
                            f"{self.name}")
        mark(self, close, device)

    monkeypatch.setattr(profiling._Span, "_mark", logged)
    state, step = _cmunet_state(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    corpus = torch.rand((8, 64, 64), generator=g, device=dev)
    graph = StepGraph(step.body, lambda idx: corpus.index_select(0, idx), dev)
    idxs = [torch.randperm(8, generator=g, device=dev)[:4] for _ in range(4)]
    graph.step(state, idxs[0])  # eager
    del launched[:]
    graph.step(state, idxs[1])  # the capture, then the first replay
    captured = list(launched)
    assert graph.report["capture_calls"]["span_mark"] == len(captured)
    depth = 0
    for name in captured:
        depth += 1 if "_open_" in name else -1
        assert depth >= 0
    assert depth == 0 and len(captured) > 100
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for idx in idxs[2:]:
            graph.step(state, idx)
        torch.cuda.synchronize()
    marker = re.compile(r"cmx::span_(open|close)_\w+")
    replayed = [marker.search(e.name).group(0) for e in sorted(
        (e for e in prof.events() if e.device_type == DeviceType.CUDA
         and marker.search(e.name)), key=lambda e: e.time_range.start)]
    assert replayed == captured * 2


CMUNET_NORMS = {"norm_kernel_channels_last": 36, "norm_moments": 36,
                "norm_apply": 36, "norm_grad_sums": 26, "norm_grad_input": 26}


def test_graph_runs_cmunet_convolutions_channels_last(dev):
    """A CM-UNet step (full width, bf16, view 32, batch 4) on the card.
    Its eager first step, profiled: cuDNN's layout transposes (nchwToNhwc,
    nhwcToNchw) come only from convolutions with an operand of one or two
    channels (the stem's input, the heads' outputs), which cuDNN pads to
    its NHWC kernels' channel multiple in either layout. The captured step
    holds 46 library convolutions, all channels-last (`capture_calls`: the
    online encoder's 10, two decoders' 13 each, the target encoder's 10),
    and 36 batch norms through the norm kernels on channels-last rows
    (10, 8 each, 10; the target's without a backward);
    its replays run cuDNN's convolutions and no other transposes. An eager
    backward's gradients come back contiguous in their parameters'
    shapes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cmx_torch.train.graph import StepGraph

    def transposes(names):
        return [n for n in names if "nchwToNhwc" in n or "nhwcToNchw" in n]

    state, step = _cmunet_state(dev, torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(3)
    corpus = torch.rand((8, 64, 64), generator=g, device=dev)
    graph = StepGraph(step.body, lambda idx: corpus.index_select(0, idx), dev)
    idxs = [torch.randperm(8, generator=g, device=dev)[:4] for _ in range(4)]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts, record_shapes=True) as prof:
        graph.step(state, idxs[0])  # eager
        torch.cuda.synchronize()
    eager = []
    for ev in prof.profiler.function_events:
        for k in transposes([k.name for k in ev.kernels]):
            op = ev
            while op is not None and not (op.name.startswith("aten::")
                                          and "convolution" in op.name):
                op = op.cpu_parent
            assert op is not None, (k, ev.name)
            assert any(len(s) == 4 and s[1] <= 2 for s in op.input_shapes), \
                (k, op.name, op.input_shapes)
            eager.append(k)
    graph.step(state, idxs[1])  # the capture, then the first replay
    assert graph.report["capture_calls"] == {
        "library_conv_channels_last": 46, **CMUNET_NORMS}
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for idx in idxs[2:]:
            rows = graph.step(state, idx)
        torch.cuda.synchronize()
    assert bool(torch.isfinite(rows).all())
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert any(("cudnn" in n or "xmma" in n or "conv" in n.lower())
               for n in names), sorted(set(names))[:20]
    assert set(transposes(names)) <= set(eager)
    # an eager backward on the card: every gradient contiguous, in shape
    active = (torch.rand((4, 32, 32), generator=g, device=dev) > 0.5).float()
    pix, pred, _ = state.model(corpus[:4, :32, :32], active)
    names, params = zip(*state.model.named_parameters())
    grads = torch.autograd.grad(pix.square().mean() + pred.square().mean(),
                                params)
    for n, p, gr in zip(names, params, grads):
        assert gr.is_contiguous() and gr.shape == p.shape, n


# ------------------------------------------------------------ norm kernels

NORM_SHAPES = [  # (B, C, H, W, channels_last, mask dtype or None)
    (128, 64, 224, 224, True, torch.bfloat16),  # cmunet-b128, level 1
    (256, 64, 224, 224, True, None),            # moco-b256-graph, level 1
    (256, 1024, 14, 14, True, None),            # its bottleneck
    (128, 512, 28, 28, True, torch.bfloat16),
    (1, 3, 5, 7, True, torch.bfloat16),         # B 1, C % 8, a short group
    (2, 96, 13, 11, True, torch.float32),       # 12 groups: TY 21
    (3, 520, 6, 6, True, None),                 # 65 groups: three y blocks
    (128, 64, 256, 256, False, torch.float32),  # spark-b128-fused densify
    (128, 128, 128, 128, False, torch.float32),
    (1, 8, 9, 9, False, torch.bfloat16),        # H W % 8: scalar units
    (2, 1024, 16, 16, False, None),
]


def _norm_operands(dev, B, C, H, W, channels_last, mdtype, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    fmt = torch.channels_last if channels_last else torch.contiguous_format

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x = (rnd(B, C, H, W) * 2 + 3).to(dtype).contiguous(memory_format=fmt)
    dy = rnd(B, C, H, W).to(dtype).contiguous(memory_format=fmt)
    m = None if mdtype is None else (
        torch.rand((B, 1, H, W), generator=g, device=dev) > 0.35).to(mdtype)
    vecs = [rnd(C) for _ in range(6)]
    return x, dy, m, vecs


def _sums_close(got, ref):
    c = (ref.numel() - (ref.numel() % 2)) // 2
    for a, b in ((got[:c], ref[:c]), (got[c:2 * c], ref[c:2 * c])):
        assert _rel(a, b) <= 1e-5
    assert torch.equal(got[2 * c:], ref[2 * c:])  # the count


@pytest.mark.parametrize("B,C,H,W,channels_last,mdtype", NORM_SHAPES)
def test_norm_kernels_match_plain(dev, B, C, H, W, channels_last, mdtype):
    dtypes = [torch.bfloat16] + ([torch.float32] if B * H * W < 2 ** 16
                                 else [])
    for dtype in dtypes:
        x, dy, m, (s, inv, shift, mean, k1, k2) = _norm_operands(
            dev, B, C, H, W, channels_last, mdtype, dtype)
        inv_t, shift_t = inv.to(dtype), shift.to(dtype)
        n0 = [w.launches for w in bo.WRAPPERS]
        _sums_close(bo.norm_moments(x, m, s), bo.norm_moments_plain(x, m, s))
        for relu in (True, False):
            y = bo.norm_apply(x, m, inv_t, shift_t, relu)
            assert y.dtype == dtype and y.stride() == x.stride()
            assert torch.equal(y, bo.norm_apply_plain(x, m, inv_t, shift_t,
                                                      relu))
            _sums_close(
                bo.norm_grad_sums(dy, x, m, inv_t, shift_t, mean, relu),
                bo.norm_grad_sums_plain(dy, x, m, inv_t, shift_t, mean, relu))
            dx = bo.norm_grad_input(dy, x, m, inv_t, shift_t, mean, inv, k1,
                                    k2, relu)
            assert dx.dtype == dtype and dx.stride() == x.stride()
            assert torch.equal(dx, bo.norm_grad_input_plain(
                dy, x, m, inv_t, shift_t, mean, inv, k1, k2, relu))
        assert [w.launches - n for w, n in zip(bo.WRAPPERS, n0)] == \
            [1, 2, 2, 2]


def test_norm_kernels_give_the_same_bits_twice(dev):
    x, dy, m, (s, inv, shift, mean, k1, k2) = _norm_operands(
        dev, 128, 128, 112, 112, True, torch.bfloat16, torch.bfloat16)
    inv_t, shift_t = inv.to(torch.bfloat16), shift.to(torch.bfloat16)
    for run in (lambda: bo.norm_moments(x, m, s),
                lambda: bo.norm_grad_sums(dy, x, m, inv_t, shift_t, mean,
                                          True),
                lambda: bo.norm_moments(x.contiguous(), None, s)):
        assert torch.equal(run(), run())


def test_norm_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros((2, 8, 4, 4), dtype=torch.bfloat16, device=dev)
    s = torch.zeros(8, device=dev)
    with pytest.raises(ValueError):  # neither layout
        bo.norm_moments(x[:, :, :, ::2], None, s)
    with pytest.raises(TypeError):
        bo.norm_moments(x.half(), None, s)
    with pytest.raises(ValueError):  # a mask of another shape
        bo.norm_moments(x, torch.ones((2, 1, 4, 2), device=dev), s)
    with pytest.raises(ValueError):
        bo.norm_moments(x, torch.ones((2, 1, 4, 4)), s)  # on the CPU


def test_norm_on_the_card_runs_the_kernels_or_raises(dev):
    """On the card MaskedBatchNorm leaves only fp64 to its plain
    composition: fp16, a mask of another shape and a module dtype other
    than x's raise; x of other strides runs the kernels channels-last, the
    same bits as its channels-last copy."""
    from cmx_torch.models import blocks

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((2, 8, 6, 4), generator=g, device=dev) + 1
    m = (torch.rand((2, 1, 6, 4), generator=g, device=dev) > 0.3).float()
    before = dict(blocks.NORM_CALLS)
    with pytest.raises(TypeError):
        blocks.MaskedBatchNorm(8).to(dev).train()(x.half(), m)
    with pytest.raises(ValueError):
        blocks.MaskedBatchNorm(8).to(dev).train()(x, m[:, :, :, :2])
    with pytest.raises(TypeError):
        blocks.MaskedBatchNorm(8, torch.bfloat16).to(dev).train()(x, m)
    assert blocks.NORM_CALLS == before
    blocks.MaskedBatchNorm(8).to(dev).train()(x.double(), m)
    assert blocks.NORM_CALLS["norm_plain"] == before["norm_plain"] + 1
    strided = x.transpose(2, 3).contiguous().transpose(2, 3)
    cl = x.contiguous(memory_format=torch.channels_last)
    outs = [blocks.MaskedBatchNorm(8).to(dev).train()(t, m, relu=True)
            for t in (strided, cl)]
    assert blocks.NORM_CALLS["norm_kernel_channels_last"] == \
        before["norm_kernel_channels_last"] + 2
    assert torch.equal(outs[0], outs[1])


def test_cmunet_b128_step_runs_every_norm_through_the_kernels(dev):
    """A CM-UNet step at cmunet-b128's shape (bf16, batch 128 of 224^2
    views from 256^2 images) captured as a CUDA graph (under
    set_sync_debug_mode("error")): its 36 batch norms ran through the
    norm kernels on channels-last rows, none plain; one replay is
    finite."""
    from cmx_torch.ssl.cmunet import CMUNetOnline, make_cmunet_task
    from cmx_torch.train.graph import StepGraph
    from cmx_torch.train.optim import make_optimizer
    from cmx_torch.train.state import TrainState
    from cmx_torch.train.trainer import make_train_step

    torch.cuda.empty_cache()
    model = CMUNetOnline(torch.bfloat16, 224)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(dev)
    task, _ = make_cmunet_task(model, view_size=224)
    g = torch.Generator(device=dev).manual_seed(1)
    tx = make_optimizer("adamw", 1e-4, 0.05,
                        named_params=model.named_parameters())
    state = TrainState.create(model=model, tx=tx, extra=task.init_extra(g))
    corpus = torch.rand((160, 256, 256), generator=g, device=dev)
    graph = StepGraph(make_train_step(task, tx).body,
                      lambda idx: corpus.index_select(0, idx), dev)
    idxs = [torch.randperm(160, generator=g, device=dev)[:128]
            for _ in range(3)]
    graph.step(state, idxs[0])  # eager
    graph.step(state, idxs[1])  # the capture, then the first replay
    rows = graph.step(state, idxs[2])
    torch.cuda.synchronize()
    calls = graph.report["capture_calls"]
    assert "norm_plain" not in calls
    assert {k: calls.get(k) for k in CMUNET_NORMS} == CMUNET_NORMS
    assert bool(torch.isfinite(rows).all())
    del graph, state, model
    torch.cuda.empty_cache()
