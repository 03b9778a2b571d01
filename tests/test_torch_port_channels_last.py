"""The library convolutions' channels-last layout (cmx_torch.models.blocks:
`library_layout`, `_conv_operands`), forced on here on the CPU, where the
port otherwise keeps every activation contiguous NCHW:

  * a tiny UNet step in fp32 gives the NCHW path's loss, outputs, BN
    running stats and gradients within 1e-5 relative (the biases a batch
    norm absorbs, whose gradient is rounding, within 1e-5 of the model's
    largest gradient entry), and so does a tiny CM-UNet step, its
    gradients computed in float64 (see its test); every returned gradient
    is contiguous in its parameter's shape, and the library convolutions
    are counted by layout (`launch_counts`);
  * a fused-gated block (FUSED_MIN_HW patched to 32) still reads and
    writes channel-major tensors on the flat path, and channels-last views
    on the NHWC path, while the library convolutions between them run
    channels-last;
  * a conversion's gradient comes back in the layout and dtype of its
    source (`_in_layout`).
Reduced widths (4, 8, 16, 32), bottleneck 64, 32^2 or 64^2 images, batch 2
(CM-UNet 8).
"""

import functools
import re

import pytest
import torch

from cmx_torch.models import blocks
from cmx_torch.models.unet import UNet
from cmx_torch.ops import fused_conv as fc
from cmx_torch.ops import fused_conv_flat as ff
from cmx_torch.train.graph import launch_counts

WIDTHS = (4, 8, 16, 32)
BNECK = 64
TOL = 1e-5
CL, CF = "library_conv_channels_last", "library_conv_channels_first"
# the biases of convolutions a batch norm follows: their gradient is zero
# but for rounding, held to TOL of the model's largest gradient entry
ABSORBED = re.compile(r"(double_conv|bottleneck)\.conv[01]\.bias$")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _force_channels_last(monkeypatch):
    monkeypatch.setattr(blocks, "library_layout",
                        lambda x: torch.channels_last)


def _assert_grads_close(got, ref, params):
    """Every gradient of `got` contiguous, in its parameter's shape and
    dtype, and within TOL of `ref`'s (ABSORBED ones of the largest)."""
    top = max(float(g.abs().max()) for g in ref.values())
    for n, gr in got.items():
        p = params[n]
        assert gr.is_contiguous() and gr.shape == p.shape, n
        assert gr.dtype == p.dtype, n
        if ABSORBED.search(n):
            assert float((gr - ref[n]).abs().max()) <= TOL * top, n
        else:
            assert _rel(gr, ref[n]) <= TOL, n


def _layout_calls(run):
    """run()'s result and the library convolution calls it made, by
    layout."""
    before = launch_counts()
    out = run()
    after = launch_counts()
    return out, {k: after[k] - before[k] for k in (CL, CF)}


def _unet_step(model_state, imgs, mask):
    """One training forward and backward of a fresh UNet from
    `model_state`: (logits, loss, {name: grad}, BN buffers)."""
    model = UNet(out_classes=2, widths=WIDTHS, bottleneck=BNECK,
                 dtype=torch.float32)
    model.load_state_dict(model_state)
    model.train()
    out = model(imgs, mask)
    loss = (out.square() * torch.linspace(0.5, 1.5, out.shape[1])[
        None, :, None, None]).mean()
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    return out, loss, dict(zip(names, grads)), dict(model.named_buffers())


def test_unet_channels_last_equals_nchw(monkeypatch):
    g = torch.Generator().manual_seed(0)
    ref = UNet(out_classes=2, widths=WIDTHS, bottleneck=BNECK,
               dtype=torch.float32)
    ref.reset_parameters(g)
    state = {k: v.clone() for k, v in ref.state_dict().items()}
    imgs = torch.randn((2, 32, 32), generator=g)
    mask = (torch.rand((2, 1, 32, 32), generator=g) > 0.4).float()
    nchw, calls_f = _layout_calls(lambda: _unet_step(state, imgs, mask))
    _force_channels_last(monkeypatch)
    nhwc, calls_l = _layout_calls(lambda: _unet_step(state, imgs, mask))
    # 5 DoubleConvs of 2 convs, 4 UpBlocks of 3, the head
    assert calls_f == {CL: 0, CF: 23} and calls_l == {CL: 23, CF: 0}
    assert nhwc[0].is_contiguous(memory_format=torch.channels_last)
    assert _rel(nhwc[0], nchw[0]) <= TOL
    assert _rel(nhwc[1], nchw[1]) <= TOL
    _assert_grads_close(nhwc[2], nchw[2], dict(ref.named_parameters()))
    for n, b in nhwc[3].items():
        assert _rel(b, nchw[3][n]) <= TOL, n


def _cmunet(monkeypatch, dtype):
    """A CM-UNet task at reduced widths, view 32, computing in `dtype` (the
    necks in fp32, as always), no augmentation."""
    from cmx_torch.models import unet
    from cmx_torch.ssl import cmunet

    monkeypatch.setattr(cmunet, "UNetEncoder",
                        functools.partial(unet.UNetEncoder, WIDTHS, BNECK))
    monkeypatch.setattr(cmunet, "UNetDecoder", functools.partial(
        unet.UNetDecoder, widths=WIDTHS, in_channels=BNECK))
    monkeypatch.setattr(cmunet, "BOTTLENECK_WIDTH", BNECK)
    model = cmunet.CMUNetOnline(dtype, 32)
    model.reset_parameters(torch.Generator().manual_seed(1))
    task, _ = cmunet.make_cmunet_task(model, view_size=32, augment=False)
    return model, task


def _cmunet_step(model, task, extra, imgs, active):
    loss, aux = task.loss_fn(model, imgs, None, {"active": active}, extra)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    return (loss, aux.metrics, dict(zip(names, grads)),
            dict(model.named_buffers()),
            dict(extra["target_model"].named_buffers()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cmunet_step_channels_last_equals_nchw(monkeypatch, dtype):
    """A CM-UNet loss and backward (batch 8), online and target, from the
    same weights, views and mask. Computing in fp32: the loss, its two
    terms and every BN running stat within TOL, every gradient contiguous
    in its parameter's shape. The gradients' values are held in float64:
    in fp32 a 2x2 max-pool window whose two largest entries lie within
    rounding of each other may take the other argmax when the convolution
    sums in another order, which moves a leaf by up to 3e-3 of the model's
    largest gradient entry, with or without channels-last; in float64 the
    two layouts agree to 1e-14."""
    import copy

    from cmx_torch.ops.masking import random_patch_mask

    model, task = _cmunet(monkeypatch, dtype)
    model.train()
    extra = task.init_extra(torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(3)
    imgs = torch.rand((8, 32, 32), generator=g).to(dtype)
    active = random_patch_mask(g, 8, 32, 16, 0.65)
    runs = []
    for forced in (False, True):
        if forced:
            _force_channels_last(monkeypatch)
        m, e = copy.deepcopy(model), copy.deepcopy(extra)
        runs.append(_layout_calls(
            lambda: _cmunet_step(m, task, e, imgs, active)))
    (nchw, calls_f), (nhwc, calls_l) = runs
    # online: encoder 10, two decoders 13 each; target: encoder 10
    assert calls_f == {CL: 0, CF: 46} and calls_l == {CL: 46, CF: 0}
    assert _rel(nhwc[0], nchw[0]) <= TOL
    for k, v in nhwc[1].items():
        assert _rel(v, nchw[1][k]) <= TOL, k
    params = dict(model.named_parameters())
    if dtype == torch.float64:
        _assert_grads_close(nhwc[2], nchw[2], params)
    for n, gr in nhwc[2].items():
        assert gr.is_contiguous() and gr.shape == params[n].shape, n
    for i in (3, 4):
        for n, b in nhwc[i].items():
            assert _rel(b, nchw[i][n]) <= TOL, n


def _fused_unet_run(monkeypatch):
    """A bf16 fused UNet's forward and backward at 64^2 (batch 2) with the
    layouts it meets recorded: (fused blocks' names, [(input channel-major,
    input channels-last, output channel-major, output channels-last)] of
    each fused block, whether each K1/K2 call's input was channel-major,
    whether each library convolution's output was channels-last, the
    library convolution calls by layout, the loss, {name: gradient})."""
    model = UNet(out_classes=1, widths=WIDTHS, bottleneck=BNECK,
                 dtype=torch.bfloat16, fused=True)
    model.reset_parameters(torch.Generator().manual_seed(4))
    model.train()
    names = {m: n for n, m in model.named_modules()}
    fused, blocks_seen, convs_seen, flat_seen = [], [], [], []

    def block_hook(mod, args, out):
        if mod.use_fused(args[0]):
            fused.append(names[mod])
            blocks_seen.append(tuple(
                t.is_contiguous(memory_format=f) for t in (args[0], out)
                for f in (torch.contiguous_format, torch.channels_last)))

    def conv_hook(mod, args, out):
        convs_seen.append(out.is_contiguous(
            memory_format=torch.channels_last))

    for m in model.modules():
        if isinstance(m, blocks.DoubleConv):
            m.register_forward_hook(block_hook)
        if isinstance(m, (blocks.Conv, blocks.ConvTranspose)):
            m.register_forward_hook(conv_hook)
    flat = ff.flat_double_conv

    def recorded(x, *args):
        flat_seen.append(x.is_contiguous())
        return flat(x, *args)

    monkeypatch.setattr(ff, "flat_double_conv", recorded)
    g = torch.Generator().manual_seed(5)
    imgs = torch.randn((2, 64, 64), generator=g)
    mask = (torch.rand((2, 1, 64, 64), generator=g) > 0.4).to(torch.bfloat16)
    out, calls = _layout_calls(lambda: model(imgs, mask))
    loss = out.float().square().mean()
    pnames, params = zip(*model.named_parameters())
    grads = dict(zip(pnames, torch.autograd.grad(loss, params)))
    monkeypatch.setattr(ff, "flat_double_conv", flat)
    return (fused, blocks_seen, flat_seen, convs_seen, calls,
            float(loss.detach()), grads)


@pytest.mark.parametrize("impl", ["flat", "nhwc"])
def test_fused_blocks_keep_their_layout_between_channels_last_convs(
        monkeypatch, impl):
    """A bf16 fused UNet (FUSED_MIN_HW 32: down1, down2, up2 and up1 fused)
    with channels-last forced: each fused block gets its input
    channel-major on the flat path (K1/K2 too) and returns it so, and on
    the NHWC path gets and returns channels-last NCHW tensors (its NHWC
    view is free); every library convolution runs channels-last; the loss
    is the NCHW run's within the bf16 margin (2e-2), every library
    convolution's gradient is contiguous, and the flat fused blocks'
    gradients have the layout they have in the NCHW run (the NHWC path's
    plain versions here return theirs in the layout of their input, which
    K8 on the card does not)."""
    monkeypatch.setattr(fc, "FUSED_MIN_HW", 32)
    monkeypatch.setattr(fc, "FUSED_IMPL", impl)
    ref = _fused_unet_run(monkeypatch)
    _force_channels_last(monkeypatch)
    fused, blocks_seen, flat_seen, convs_seen, calls, loss, grads = \
        _fused_unet_run(monkeypatch)
    assert fused == ref[0] == ["encoder.down1.double_conv",
                               "encoder.down2.double_conv",
                               "decoder.up2.double_conv",
                               "decoder.up1.double_conv"]
    if impl == "flat":
        assert flat_seen == [True] * 4
        # in and out channel-major (down1's 1-channel image is both)
        assert all(x_cf and y_cf for x_cf, _, y_cf, _ in blocks_seen)
    else:
        assert flat_seen == []
        assert all(x_cl and y_cl for _, x_cl, _, y_cl in blocks_seen)
    # down3, down4, the bottleneck, up4 and up3: 2 convs each; 4 up-convs;
    # the head
    assert calls == {CL: 15, CF: 0} and ref[4] == {CL: 0, CF: 15}
    assert len(convs_seen) == 15 and all(convs_seen)
    assert abs(loss - ref[5]) <= 2e-2 * abs(ref[5])
    for n, gr in grads.items():
        assert bool(torch.isfinite(gr).all()), n
        assert gr.shape == ref[6][n].shape, n
        if not n.startswith(tuple(fused)):
            assert gr.is_contiguous(), n
        elif impl == "flat":  # K1/K2's plain versions, as on the card
            assert gr.stride() == ref[6][n].stride(), n


@pytest.mark.parametrize("src,dst", [
    (torch.contiguous_format, torch.channels_last),
    (torch.channels_last, torch.contiguous_format)])
def test_a_relayout_returns_its_gradient_in_the_source_layout(src, dst):
    """blocks._in_layout converts a 4-D fp32 tensor to bf16 in `dst` in one
    copy, and its gradient comes back in the source's fp32 and layout
    (autograd's own cast would leave it in `dst`); a tensor already in
    `dst` (a 1-channel NCHW one is channels-last too) is only cast."""
    g = torch.Generator().manual_seed(6)
    t = torch.randn((2, 8, 4, 6), generator=g).contiguous(
        memory_format=src).requires_grad_()
    out = blocks._in_layout(t, torch.bfloat16, dst)
    assert out.dtype == torch.bfloat16
    assert out.is_contiguous(memory_format=dst)
    assert torch.equal(out.float(), t.detach().bfloat16().float())
    up = torch.randn(out.shape, generator=g).contiguous(memory_format=dst)
    grad, = torch.autograd.grad(out, t, up.bfloat16())
    assert grad.dtype == torch.float32
    assert grad.is_contiguous(memory_format=src)
    assert torch.equal(grad, up.bfloat16().float())
    one = torch.randn((2, 1, 4, 6), generator=g)
    assert blocks._in_layout(one, torch.float32, torch.channels_last) is one
