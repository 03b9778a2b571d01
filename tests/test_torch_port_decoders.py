"""The decoder variants against cmx on the CPU: bilinear_upsample_2x,
PixelShuffleUpsample2x, LightDecoderBlock / LightDecoder, SparKModel with
LightDecoder (full_unet=False) and with the fused UNet decoder
(fused_decoder=True), the UNet in bilinear mode (fp32, and fused bf16 with
up1 left unfused by the gate), the finetune CLI with
model.up_sample_mode=bilinear, and the checkpoint layouts of every new
module both ways. Weights cross with cmx_torch.ckpt.checkpoint.from_flax;
inputs come from numpy seeds; reduced widths throughout. Tolerances are
stated in each test.
"""

import functools
import re
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from cmx_torch.ckpt.checkpoint import _kind, _to_flax_layout, from_flax, to_flax

WIDTHS = (8, 16, 32, 64)
BNECK = 128
DEC_WIDTH = 32
SIZE = 64
B = 2
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


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _leaf(tree, dotted):
    for k in dotted.split("."):
        tree = tree[k]
    return tree


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _variables(module, *args, seed=0):
    """A random variable tree of the flax `module` in cmx's layout (its
    shapes from jax.eval_shape: tracing only, where jitting cmx's init
    compiles for seconds): kernels N(0, 1/fan_in), biases N(0, 0.1^2),
    scales and running variances 1 + 0.1 |N|, running means and mask
    tokens N(0, 0.1^2), all fp32."""
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


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1e-12)


def _assert_trees_equal(got, ref):
    """Two trees of arrays with the same paths and equal leaves, bit for
    bit."""
    la = jax.tree_util.tree_leaves_with_path(ref)
    lb = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, a), (_, b) in zip(la, lb):
        assert np.asarray(a).shape == np.asarray(b).shape, p
        assert np.array_equal(np.asarray(a), np.asarray(b)), p


def _assert_grads_close(model, grads, jgrads, rtol=1e-4):
    """Each gradient leaf within rtol of cmx's in L2, against the larger of
    its own L2 and 1e-3 of the tree's largest leaf L2 (a leaf whose true
    gradient is near 0 carries rounding only); the BN-absorbed biases
    (true gradient 0) within 1e-4 of the tree's largest entry in both
    packages."""
    scale = max(float(jnp.max(jnp.abs(g))) for g in jax.tree.leaves(jgrads))
    big = max(float(jnp.linalg.norm(g)) for g in jax.tree.leaves(jgrads))
    for (name, _), g in zip(model.named_parameters(), grads):
        got = _to_flax_layout(g.float().numpy(), _kind(model, name))
        ref = np.asarray(_leaf(jgrads, name))
        if BN_ABSORBED.search(name):
            assert max(np.max(np.abs(got)), np.max(np.abs(ref))) \
                <= 1e-4 * scale, name
            continue
        err = float(np.linalg.norm(got - ref))
        assert err <= rtol * max(float(np.linalg.norm(ref)), 1e-3 * big), \
            (name, err / max(float(np.linalg.norm(ref)), 1e-3 * big))


# ---------------------------------------------------------------- blocks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bilinear_upsample_2x_matches_cmx_and_interpolate(dtype):
    """cmx's corner-aligned arithmetic (rows then columns in fp32, cast
    back) bit for bit, on (2, 8, 12, 3) maps; against
    F.interpolate(scale 2, bilinear, align_corners=True) in fp32, which
    forms its weights another way, within 2e-6 of the output's largest
    entry (measured 9.8e-7, 8 ulps)."""
    from cmx.models.blocks import bilinear_upsample_2x as jup
    from cmx_torch.models.blocks import bilinear_upsample_2x

    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = np.random.default_rng(1).normal(size=(2, 8, 12, 3)).astype(np.float32)
    ref = np.asarray(jup(jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    got = bilinear_upsample_2x(_nchw(x).to(tdt))
    assert got.dtype == tdt and got.shape == (2, 3, 16, 24)
    assert np.array_equal(got.float().numpy().transpose(0, 2, 3, 1), ref)
    if dtype == "float32":
        lib = torch.nn.functional.interpolate(
            _nchw(x), scale_factor=2, mode="bilinear", align_corners=True)
        err = float((lib - got).abs().max())
        assert err <= 2e-6 * float(got.abs().max())


def test_pixel_shuffle_upsample_matches_cmx_and_conv_transpose():
    """PixelShuffleUpsample2x from cmx's parameters: its output within 1e-6
    relative of cmx's (fp32; the 1x1 product sums in another order), and
    within 1e-6 relative of the port's ConvTranspose loaded with the same
    tree (the same function); the kernel crosses in ConvTranspose's layout
    (flip included) and back bit for bit."""
    from cmx.models.blocks import PixelShuffleUpsample2x as JPS
    from cmx_torch.models.blocks import ConvTranspose, PixelShuffleUpsample2x

    x = np.random.default_rng(2).normal(size=(2, 5, 6, 16)).astype(np.float32)
    jm = JPS(8, dtype=jnp.float32)
    v = _variables(jm, jnp.asarray(x))
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    ps = from_flax(PixelShuffleUpsample2x(16, 8, torch.float32), v)
    ct = from_flax(ConvTranspose(16, 8, torch.float32), v)
    assert _kind(ps, "kernel") == "conv_transpose"
    with torch.no_grad():
        got = ps(_nchw(x)).numpy().transpose(0, 2, 3, 1)
        lib = ct(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    assert _rel(got, ref) <= 1e-6
    assert _rel(got, lib) <= 1e-6
    _assert_trees_equal(to_flax(ps), {"params": v["params"], "batch_stats": {}})


class _JLightBlock(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        from cmx.models.decoders import LightDecoderBlock

        return LightDecoderBlock(16, 8, dtype=jnp.float32, name="b")(x)


def test_light_decoder_block_matches_cmx():
    """LightDecoderBlock(16 -> 8) in train mode, fp32, on (2, 16, 6, 6):
    its ConvTranspose 4x4 stride 2 SAME (torch padding 1 on the flipped
    kernel), the bias-free convs, BN, ReLU6. Output within 1e-5 relative,
    BN running stats within 1e-5, input gradient and every parameter
    gradient within 1e-4 of their largest entry."""
    from cmx_torch.models.decoders import LightDecoderBlock

    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6, 6, 16)).astype(np.float32) * 3.0
    w = rng.normal(size=(2, 12, 12, 8)).astype(np.float32)
    jm = _JLightBlock()
    v = _variables(jm, jnp.asarray(x), seed=1)

    def jloss(p, xx):
        out, mut = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                            xx, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, mut)

    (_, (jout, jmut)), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(v["params"], jnp.asarray(x))
    tm = from_flax(LightDecoderBlock(16, 8, torch.float32),
                   {k: t["b"] for k, t in v.items()}).train()
    assert tm.conv0.bias is None and _kind(tm, "up.kernel") == "conv_transpose"
    xt = _nchw(x).requires_grad_()
    out = tm(xt)
    assert _rel(out.detach().numpy().transpose(0, 2, 3, 1), jout) <= 1e-5
    for name, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), _leaf(jmut["batch_stats"]["b"],
                                                    name), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    grads = torch.autograd.grad((out * _nchw(w)).sum(),
                                [xt] + list(tm.parameters()))
    assert _rel(grads[0].numpy().transpose(0, 2, 3, 1), jgx) <= 1e-4
    for (name, _), g in zip(tm.named_parameters(), grads[1:]):
        got = _to_flax_layout(g.numpy(), _kind(tm, name))
        assert _rel(got, _leaf(jg["b"], name)) <= 1e-4, name


def _light_inputs(rng):
    """Four maps, smallest first (2^2), at LightDecoder's stage widths,
    and a fifth entry (None) past its last block."""
    return [rng.normal(size=(B, 2 << i, 2 << i, DEC_WIDTH >> i)).astype(
        np.float32) for i in range(4)] + [None]


def test_light_decoder_matches_cmx():
    """LightDecoder(16, width 32) in train mode, fp32: stage i adds map i,
    the fifth entry (None) is not read; the (B, 32, 32, 1) fp32 output
    within 1e-5 relative of cmx's, the BN running stats within 1e-5, and
    every parameter gradient of sum(out * w) within 1e-4 of its largest
    entry."""
    from cmx.models.decoders import LightDecoder as JLight
    from cmx_torch.models.decoders import LightDecoder

    rng = np.random.default_rng(5)
    maps = _light_inputs(rng)
    w = rng.normal(size=(B, 32, 32, 1)).astype(np.float32)
    jm = JLight(up_sample_ratio=16, width=DEC_WIDTH, dtype=jnp.float32)
    jmaps = [None if m is None else jnp.asarray(m) for m in maps]
    v = _variables(jm, jmaps, seed=2)

    def jloss(p):
        out, mut = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                            jmaps, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, mut)

    (_, (jout, jmut)), jg = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(v["params"])
    tm = from_flax(LightDecoder(16, DEC_WIDTH, torch.float32), v).train()
    out = tm([None if m is None else _nchw(m) for m in maps])
    assert out.dtype == torch.float32 and out.shape == (B, 1, 32, 32)
    assert _rel(out.detach().numpy().transpose(0, 2, 3, 1), jout) <= 1e-5
    for name, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), _leaf(jmut["batch_stats"],
                                                    name), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    grads = torch.autograd.grad((out * _nchw(w)).sum(), list(tm.parameters()))
    for (name, _), g in zip(tm.named_parameters(), grads):
        got = _to_flax_layout(g.numpy(), _kind(tm, name))
        assert _rel(got, _leaf(jg, name)) <= 1e-4, name


# ---------------------------------------------------------------- SparK


def _spark_setup(dtype, full_unet, fused=False, fused_decoder=False):
    from cmx.ssl.spark import SparKModel as JSparK
    from cmx_torch.ssl.spark import SparKModel

    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    kw = dict(full_unet=full_unet, widths=WIDTHS, bottleneck_width=BNECK,
              decoder_width=DEC_WIDTH, fused=fused, fused_decoder=fused_decoder)
    imgs = np.random.default_rng(6).normal(size=(B, SIZE, SIZE)).astype(
        np.float32)
    active = np.asarray(jax.random.bernoulli(
        jax.random.key(3), 0.4, (B, SIZE // 16, SIZE // 16)), np.float32)
    active[:, 0, 0] = 1.0  # at least one visible cell a sample
    jm = JSparK(dtype=jdt, **kw)
    v = _variables(jm, imgs[:1], active[:1], seed=3)
    tm = from_flax(SparKModel(dtype=dtype, **kw), v).train()
    return imgs, active, jm, v, tm


def _cmx_spark_loss(jm, v, imgs, active, grad=True):
    """cmx's SparK loss (and, with `grad`, its gradients): ((loss, (rec,
    the updated batch stats)), grads or None)."""
    from cmx.ssl.spark import spark_loss as jloss

    def loss(p):
        rec, mut = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                            jnp.asarray(imgs), jnp.asarray(active),
                            mutable=["batch_stats"])
        return jloss(rec, jnp.asarray(imgs), jnp.asarray(active)), (rec, mut)

    if not grad:  # the fused bf16 tests hold the forward only
        return jax.jit(loss)(v["params"]), None
    return jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])


def test_spark_light_decoder_fp32_matches_cmx():
    """SparKModel(full_unet=False): the densify projections (1x1 at the
    bottleneck, 3x3 after, 32 -> 16 -> 8 -> 4 -> 2 channels; the last is
    computed and not read, as in cmx) and LightDecoder, reduced widths,
    64^2, batch 2, fp32, train mode, an injected active grid. The
    reconstruction within 1e-4 relative, the loss within 1e-5 relative, the
    BN running stats within 1e-5, every gradient leaf as
    _assert_grads_close holds it (the fifth scale's token, norm and
    projection feed nothing: zero in both)."""
    from cmx_torch.ssl.spark import spark_loss

    imgs, active, jm, v, tm = _spark_setup(torch.float32, full_unet=False)
    (jl, (jrec, jmut)), jg = _cmx_spark_loss(jm, v, imgs, active)
    assert not hasattr(tm.decoder, "up1") and tm.densify_proj0.kernel.shape \
        == (DEC_WIDTH, BNECK, 1, 1)
    rec = tm(torch.from_numpy(imgs), torch.from_numpy(active))
    assert _rel(rec.detach().numpy(), jrec) <= 1e-4
    loss = spark_loss(rec, torch.from_numpy(imgs), torch.from_numpy(active))
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    for name, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), _leaf(jmut["batch_stats"],
                                                    name), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    grads = torch.autograd.grad(loss, list(tm.parameters()),
                                allow_unused=True)
    names = [n for n, _ in tm.named_parameters()]
    unused = {n for n, g in zip(names, grads) if g is None}
    assert unused == {"mask_token4", "densify_norm4.scale",
                      "densify_norm4.bias", "densify_proj4.kernel",
                      "densify_proj4.bias"}
    assert not any(np.any(np.asarray(_leaf(jg, n))) for n in unused)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(tm.parameters(), grads)]
    _assert_grads_close(tm, grads, jg)


def test_spark_fused_decoder_reaches_the_unet_decoder():
    """The decoder is fused iff fused and fused_decoder (cmx/ssl/spark.py:
    125); LightDecoder has no fused stage at all."""
    from cmx_torch.ssl.spark import SparKModel

    def fused_up1(**kw):
        m = SparKModel(widths=WIDTHS, bottleneck_width=BNECK, **kw)
        return m.decoder.up1.double_conv.fused

    assert fused_up1(fused=True, fused_decoder=True)
    assert not fused_up1(fused=True)
    assert not fused_up1(fused=False, fused_decoder=True)
    light = SparKModel(full_unet=False, fused=True, widths=WIDTHS,
                       bottleneck_width=BNECK, decoder_width=DEC_WIDTH)
    assert light.encoder.down1.double_conv.fused
    assert not any(getattr(m, "fused", False)
                   for m in light.decoder.modules())


def test_spark_fused_decoder_bf16_matches_cmx(monkeypatch):
    """SparKModel(fused=True, fused_decoder=True) in bf16, FUSED_MIN_HW
    patched to 32 in both packages (the port's plain K1/K2, cmx's Pallas
    kernels in interpret mode): down1, down2, up2 and up1 fused, K1 8 and
    K2 8 calls (a forward and backward in the port, cmx's forward); the
    loss within 2e-2 relative and the BN running stats within 5e-2 (phase
    3's bf16 margins in chip_smoke.py)."""
    from cmx.ops import fused_conv as cfc
    from cmx_torch.ops import _build
    from cmx_torch.ops import fused_conv as tfc
    from cmx_torch.ssl.spark import spark_loss

    monkeypatch.setattr(cfc, "FUSED_MIN_HW", 32)
    monkeypatch.setattr(tfc, "FUSED_MIN_HW", 32)
    monkeypatch.setattr(_build, "recorded", [])
    imgs, active, jm, v, tm = _spark_setup(torch.bfloat16, full_unet=True,
                                           fused=True, fused_decoder=True)
    (jl, (_, jmut)), _ = _cmx_spark_loss(jm, v, imgs, active, grad=False)
    rec = tm(torch.from_numpy(imgs), torch.from_numpy(active))
    loss = spark_loss(rec, torch.from_numpy(imgs), torch.from_numpy(active))
    loss.backward()
    names = [n for n, _ in _build.recorded]
    assert names.count("flat_conv3x3_mask_stats") == 8
    assert names.count("flat_bwd_mega") == 8
    assert abs(float(loss) - float(jl)) <= 2e-2 * abs(float(jl))
    for name, b in tm.named_buffers():
        ref = np.asarray(_leaf(jmut["batch_stats"], name))
        assert float(np.max(np.abs(b.numpy() - ref))) <= 5e-2, name


# ---------------------------------------------------------------- UNet bilinear


class SmallUNet(fnn.Module):
    """cmx's UNet at reduced widths (its UNetEncoder and UNetDecoder, which
    take `widths`), `fused` and `up_sample_mode` passed as cmx's UNet
    passes them."""

    out_classes: int = 2
    up_sample_mode: str = "bilinear"
    dtype: Any = jnp.float32
    fused: bool = False

    @fnn.compact
    def __call__(self, x):
        from cmx.models.unet import UNetDecoder, UNetEncoder

        h, skips = UNetEncoder(widths=WIDTHS, bottleneck=BNECK,
                               dtype=self.dtype, fused=self.fused,
                               name="encoder")(x)
        return UNetDecoder(out_classes=self.out_classes, widths=WIDTHS,
                           up_sample_mode=self.up_sample_mode,
                           dtype=self.dtype, fused=self.fused,
                           name="decoder")(h, skips)


def _unet_setup(dtype, fused=False):
    from cmx_torch.models.unet import UNet

    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    rng = np.random.default_rng(8)
    imgs = rng.normal(size=(B, SIZE, SIZE)).astype(np.float32)
    w = rng.normal(size=(B, SIZE, SIZE, 2)).astype(np.float32)
    jm = SmallUNet(dtype=jdt, fused=fused)
    v = _variables(jm, imgs[:1], seed=4)
    tm = from_flax(UNet(2, WIDTHS, BNECK, dtype, fused,
                        up_sample_mode="bilinear"), v).train()

    def jloss(p):
        out, mut = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                            jnp.asarray(imgs), mutable=["batch_stats"])
        return jnp.mean(jnp.square(out - w)), (out, mut)

    return imgs, w, v, tm, jloss


def test_unet_bilinear_fp32_matches_cmx():
    """UNet(up_sample_mode="bilinear") at reduced widths, 64^2, batch 2,
    fp32, train mode: no `up` parameter, up_l's DoubleConv takes cin +
    features channels; the logits within 1e-4 relative, the BN running
    stats within 1e-5, the MSE against a random target within 1e-5, its
    gradients as _assert_grads_close holds them (against float64, cmx's
    stray by up to 2.4e-5 and the port's by 1.2e-5 of that L2)."""
    imgs, w, v, tm, jloss = _unet_setup(torch.float32)
    (jl, (jout, jmut)), jg = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(v["params"])
    assert "up" not in jg["decoder"]["up1"]
    assert not hasattr(tm.decoder.up1, "up")
    assert tm.decoder.up1.double_conv.conv0.kernel.shape[1] == 16 + 8
    out = tm(torch.from_numpy(imgs))
    assert _rel(out.detach().numpy().transpose(0, 2, 3, 1), jout) <= 1e-4
    loss = torch.square(out - _nchw(w)).mean()
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    for name, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), _leaf(jmut["batch_stats"],
                                                    name), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    _assert_grads_close(tm, torch.autograd.grad(loss, list(tm.parameters())),
                        jg)


def test_unet_bilinear_bf16_fused_leaves_up1_unfused(monkeypatch):
    """The fused bf16 UNet in bilinear mode, FUSED_MIN_HW 32 and
    FUSED_MAX_CIN 16 patched in both packages (at these widths the same
    cut as at full width: conv_transpose's up1 concat 2 * 8 = 16 passes,
    bilinear's 16 + 8 = 24 does not, as 2 * 64 = 128 and 128 + 64 = 192
    against 128): K1 4 and K2 4 calls, down1 and down2 only; the loss
    within 2e-2 relative and the BN running stats within 5e-2 of cmx's."""
    from cmx.ops import fused_conv as cfc
    from cmx_torch.ops import _build
    from cmx_torch.ops import fused_conv as tfc

    for mod in (cfc, tfc):
        monkeypatch.setattr(mod, "FUSED_MIN_HW", 32)
        monkeypatch.setattr(mod, "FUSED_MAX_CIN", 16)
    monkeypatch.setattr(_build, "recorded", [])
    imgs, w, v, tm, jloss = _unet_setup(torch.bfloat16, fused=True)
    jl, (_, jmut) = jax.jit(jloss)(v["params"])
    out = tm(torch.from_numpy(imgs))
    loss = torch.square(out - _nchw(w)).mean()
    loss.backward()
    calls = [(n, a) for n, a in _build.recorded]
    fwd = [a for n, a in calls if n == "flat_conv3x3_mask_stats"]
    assert len(fwd) == 4 and sum(n == "flat_bwd_mega" for n, _ in calls) == 4
    assert sorted(a[0].shape[1] for a in fwd) == [1, 8, 8, 16]  # down1, down2
    assert abs(float(loss) - float(jl)) <= 2e-2 * abs(float(jl))
    for name, b in tm.named_buffers():
        ref = np.asarray(_leaf(jmut["batch_stats"], name))
        assert float(np.max(np.abs(b.numpy() - ref))) <= 5e-2, name


def test_up_block_refuses_an_unknown_mode():
    from cmx_torch.models.blocks import UpBlock

    with pytest.raises(ValueError, match="up_sample_mode must be"):
        UpBlock(16, 8, up_sample_mode="nearest")


def test_finetune_cli_bilinear_on_the_cpu(tmp_path, monkeypatch):
    """cmx_torch.cli.finetune with model.up_sample_mode=bilinear on the CPU
    (12 synthetic images at 32^2, ratio 0.3, fp32, one lr, one epoch, batch
    8, reduced widths patched into the CLI's UNet): the model has no `up`
    parameter anywhere in its decoder, the grid ran 3 folds, and the test
    dice is finite."""
    import cmx_torch.models.unet as unet
    from cmx_torch.cli.finetune import main

    monkeypatch.setattr(unet, "UNet", functools.partial(
        unet.UNet, widths=WIDTHS, bottleneck=BNECK))
    res = main(["--device", "cpu", "--lrs", "1e-3", "--epochs", "1",
                "--batches", "8", "--out", str(tmp_path / "results"),
                "data.synthetic=True", "data.synthetic_n=12",
                "data.image_size=32", f"data.data_dir={tmp_path / 'data'}",
                "data.ratio=0.3", "model.dtype=float32",
                "model.up_sample_mode=bilinear"])
    model = res["model"]
    assert all(model.decoder.get_submodule(f"up{i}").up_sample_mode
               == "bilinear" for i in range(1, 5))
    assert not any(".up." in n for n, _ in model.named_parameters())
    assert len(res["grid"][0]["folds"]) == 3 and np.isfinite(res["dice"])


# ---------------------------------------------------------------- checkpoints


def _cmx_tree(name):
    """(cmx's variable tree of the new module `name`, random values, and
    the port's module)."""
    from cmx.models.blocks import PixelShuffleUpsample2x as JPS
    from cmx.models.decoders import LightDecoder as JLight
    from cmx.ssl.spark import SparKModel as JSparK
    from cmx_torch.models.blocks import PixelShuffleUpsample2x
    from cmx_torch.models.decoders import LightDecoder
    from cmx_torch.models.unet import UNet
    from cmx_torch.ssl.spark import SparKModel

    if name == "pixel_shuffle":
        return (_variables(JPS(8), jnp.zeros((1, 4, 4, 16))),
                PixelShuffleUpsample2x(16, 8))
    if name == "light_decoder":
        maps = [None if m is None else jnp.asarray(m)
                for m in _light_inputs(np.random.default_rng(0))]
        return (_variables(JLight(width=DEC_WIDTH), maps),
                LightDecoder(16, DEC_WIDTH))
    if name == "spark_light":
        kw = dict(full_unet=False, widths=WIDTHS, bottleneck_width=BNECK,
                  decoder_width=DEC_WIDTH)
        return (_variables(JSparK(**kw), jnp.zeros((1, SIZE, SIZE)),
                           jnp.ones((1, 4, 4))), SparKModel(**kw))
    return (_variables(SmallUNet(), jnp.zeros((1, SIZE, SIZE))),
            UNet(2, WIDTHS, BNECK, up_sample_mode="bilinear"))


@pytest.mark.parametrize("name", ["pixel_shuffle", "light_decoder",
                                  "spark_light", "unet_bilinear"])
def test_new_modules_cross_checkpoints_both_ways(name):
    """cmx's variable tree into the port and back: the same tree, bit
    for bit (every ConvTranspose kernel flipped and unflipped: the 4x4 ups
    and PixelShuffleUpsample2x's); and the port's own random weights out
    and back in: the same state_dict."""
    from cmx_torch.models.blocks import reset_parameters

    v, module = _cmx_tree(name)
    v = dict(v)
    v.setdefault("batch_stats", {})
    _assert_trees_equal(to_flax(from_flax(module, v)), v)
    kinds = {n: _kind(module, n) for n, _ in module.named_parameters()}
    ups = [n for n in kinds if re.search(r"(^|\.)up\.kernel$|^kernel$", n)]
    assert all(kinds[n] == "conv_transpose" for n in ups)
    reset_parameters(module, torch.Generator().manual_seed(1))
    other = from_flax(_cmx_tree(name)[1], to_flax(module))
    for (n, a), (_, b) in zip(module.state_dict().items(),
                              other.state_dict().items()):
        assert torch.equal(a, b), n
