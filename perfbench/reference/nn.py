"""Plain PyTorch layers of the reference train steps, written as functions of
a parameter dict.

The reference is what the benchmark holds the program's step against: the
published architecture in float32 with TF32 off, no hand-written kernel, no
fused stage, no CUDA graph. It imports nothing of the program. A `Net`
carries the parameters (name -> tensor), the running statistics it reads
(`stats`) and the ones its forward writes (`new_stats`), the precision of
its products, and whether each DoubleConv is recomputed in the backward (so
that a batch of 128 at 256^2 fits on one card in float32).

Precision "fp32" is the reference. "fp8" is the control: every conv,
transposed conv and dense product takes its operands rounded to float8
e4m3 with a per-tensor scale, and its output gradient rounded to float8
e5m2, the step a later change might take from bfloat16. Everything else
stays float32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

BN_MOMENTUM = 0.9  # running = 0.9 * running + 0.1 * batch (flax's)


def set_fp32_math() -> None:
    """float32 products at full precision (TF32 off for cuBLAS and cuDNN)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8_round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to `dtype` (a float8 type) with the per-tensor scale that
    maps its largest magnitude onto the type's largest value."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return ((x.float() * scale).clamp(-top, top).to(dtype).float()
            / scale).to(x.dtype)


class _Fp8Operand(torch.autograd.Function):
    """Forward: the operand in float8 e4m3; backward: the gradient as it is."""

    @staticmethod
    def forward(ctx, x):
        return _fp8_round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Grad(torch.autograd.Function):
    """Forward: the output as it is; backward: its gradient in float8 e5m2."""

    @staticmethod
    def forward(ctx, y):
        return y

    @staticmethod
    def backward(ctx, g):
        return _fp8_round(g, torch.float8_e5m2)


class Net:
    """Parameters, running statistics and the precision of one forward."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 stats: Dict[str, torch.Tensor], precision: str = "fp32",
                 recompute: bool = True):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.params = params
        self.stats = stats
        self.new_stats: Dict[str, torch.Tensor] = {}
        self.precision = precision
        self.recompute = recompute

    def _operand(self, x: torch.Tensor) -> torch.Tensor:
        return _Fp8Operand.apply(x) if self.precision == "fp8" else x

    def _output(self, y: torch.Tensor) -> torch.Tensor:
        return (_Fp8Grad.apply(y) if self.precision == "fp8"
                and y.requires_grad else y)

    def conv(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """SAME conv with kernel (Cout, Cin, k, k) and bias (Cout,)."""
        w = self.params[name + ".kernel"]
        y = F.conv2d(self._operand(x), self._operand(w),
                     self.params[name + ".bias"], padding=w.shape[-1] // 2)
        return self._output(y)

    def conv_transpose(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """2x2 stride-2 transposed conv, kernel (Cin, Cout, 2, 2)."""
        w = self.params[name + ".kernel"]
        y = F.conv_transpose2d(self._operand(x), self._operand(w),
                               self.params[name + ".bias"], stride=2)
        return self._output(y)

    def dense(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """x @ kernel (in, out) + bias."""
        y = (self._operand(x) @ self._operand(self.params[name + ".kernel"])
             + self.params[name + ".bias"])
        return self._output(y)

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._output(self._operand(a) @ self._operand(b))

    def _running(self, name: str, mean: torch.Tensor, var: torch.Tensor):
        """The running statistics after this batch (the first forward's: a
        recomputed block writes nothing)."""
        if name + ".mean" in self.new_stats:
            return
        m = BN_MOMENTUM
        self.new_stats[name + ".mean"] = (
            m * self.stats[name + ".mean"] + (1 - m) * mean.detach())
        self.new_stats[name + ".var"] = (
            m * self.stats[name + ".var"] + (1 - m) * var.detach())

    def batch_norm(self, x: torch.Tensor, name: str,
                   mask: Optional[torch.Tensor] = None,
                   eps: float = 1e-5) -> torch.Tensor:
        """Batch norm of (B, C, H, W) over the positions where `mask`
        (B, 1, H, W) is 1 (all positions without a mask): the mean, then
        the population variance about it."""
        if mask is None:
            mean = x.mean((0, 2, 3))
            var = (x - mean[:, None, None]).square().mean((0, 2, 3))
        else:
            n = mask.sum((0, 2, 3)).clamp_min(1.0)
            mean = (x * mask).sum((0, 2, 3)) / n
            var = ((x - mean[:, None, None]).square() * mask).sum(
                (0, 2, 3)) / n
        self._running(name, mean, var)
        scale = self.params[name + ".scale"]
        bias = self.params[name + ".bias"]
        inv = torch.rsqrt(var + eps) * scale
        return (x - mean[:, None, None]) * inv[:, None, None] \
            + bias[:, None, None]

    def batch_norm_1d(self, x: torch.Tensor, name: str,
                      eps: float = 1e-6) -> torch.Tensor:
        """Batch norm of (B, C) over the batch."""
        mean = x.mean(0)
        var = (x - mean).square().mean(0)
        self._running(name, mean, var)
        return ((x - mean) * torch.rsqrt(var + eps) * self.params[name + ".scale"]
                + self.params[name + ".bias"])

    def double_conv(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                    prefix: str) -> torch.Tensor:
        """Two (conv 3x3 -> mask -> masked BN -> ReLU -> mask) stages;
        recomputed in the backward when the net says so."""

        def run(x, mask):
            for i in (0, 1):
                x = self.conv(x, f"{prefix}conv{i}")
                if mask is not None:
                    x = x * mask
                x = torch.relu(self.batch_norm(x, f"{prefix}bn{i}", mask))
                if mask is not None:
                    x = x * mask
            return x

        if self.recompute and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(
                run, x, mask, use_reentrant=False, preserve_rng_state=False)
        return run(x, mask)


def upsample_nearest(grid: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, h, w) -> (B, h * factor, w * factor), each cell repeated."""
    return grid.repeat_interleave(factor, 1).repeat_interleave(factor, 2)


def unet_encoder(net: Net, prefix: str, imgs: torch.Tensor,
                 mask: Optional[torch.Tensor], levels: int):
    """(bottleneck, skips) of the 5-level encoder on (B, H, W) images; the
    (B, H, W) mask, 1 = visible, multiplies the input and follows every
    2x2 max pool."""
    x = imgs[:, None]
    m = None if mask is None else mask[:, None]
    if m is not None:
        x = x * m
    skips = []
    for i in range(levels):
        skip = net.double_conv(x, m, f"{prefix}down{i + 1}.double_conv.")
        skips.append(skip)
        x = F.max_pool2d(skip, 2)
        if m is not None:
            m = F.max_pool2d(m, 2)
    return net.double_conv(x, m, f"{prefix}bottleneck."), skips


def unet_decoder(net: Net, prefix: str, x: torch.Tensor, skips) -> torch.Tensor:
    """Transposed-conv upsampling, skip concat and DoubleConv at each
    level, then the 1x1 head: (B, out, H, W)."""
    for lvl in range(len(skips), 0, -1):
        x = net.conv_transpose(x, f"{prefix}up{lvl}.up")
        x = torch.cat([x, skips[lvl - 1]], dim=1)
        x = net.double_conv(x, None, f"{prefix}up{lvl}.double_conv.")
    return net.conv(x, prefix + "head")


# ------------------------------------------------------------ parameters

def lecun_std(fan_in: int) -> float:
    """The standard deviation of flax's lecun-normal kernels (a normal cut
    at two deviations, rescaled to variance 1 / fan_in)."""
    return math.sqrt(1.0 / fan_in) / 0.87962566103423978


def conv_spec(name: str, cin: int, cout: int, k: int):
    return [(name + ".kernel", (cout, cin, k, k), ("trunc", lecun_std(cin * k * k))),
            (name + ".bias", (cout,), "zeros")]


def conv_transpose_spec(name: str, cin: int, cout: int):
    return [(name + ".kernel", (cin, cout, 2, 2), ("trunc", lecun_std(4 * cin))),
            (name + ".bias", (cout,), "zeros")]


def dense_spec(name: str, cin: int, cout: int):
    return [(name + ".kernel", (cin, cout), ("trunc", lecun_std(cin))),
            (name + ".bias", (cout,), "zeros")]


def norm_spec(name: str, c: int):
    return [(name + ".scale", (c,), "ones"), (name + ".bias", (c,), "zeros")]


def norm_stats(name: str, c: int):
    return [(name + ".mean", (c,), "zeros"), (name + ".var", (c,), "ones")]


def double_conv_spec(prefix: str, cin: int, c: int):
    return (conv_spec(prefix + "conv0", cin, c, 3) + norm_spec(prefix + "bn0", c)
            + conv_spec(prefix + "conv1", c, c, 3) + norm_spec(prefix + "bn1", c))


def double_conv_stats(prefix: str, c: int):
    return norm_stats(prefix + "bn0", c) + norm_stats(prefix + "bn1", c)


def encoder_spec(prefix: str, widths, bottleneck: int):
    params, stats, cin = [], [], 1
    for i, w in enumerate(widths):
        p = f"{prefix}down{i + 1}.double_conv."
        params += double_conv_spec(p, cin, w)
        stats += double_conv_stats(p, w)
        cin = w
    params += double_conv_spec(prefix + "bottleneck.", cin, bottleneck)
    stats += double_conv_stats(prefix + "bottleneck.", bottleneck)
    return params, stats


def decoder_spec(prefix: str, widths, cin: int, out: int):
    params, stats = [], []
    for lvl in range(len(widths), 0, -1):
        w = widths[lvl - 1]
        params += conv_transpose_spec(f"{prefix}up{lvl}.up", cin, w)
        p = f"{prefix}up{lvl}.double_conv."
        params += double_conv_spec(p, 2 * w, w)
        stats += double_conv_stats(p, w)
        cin = w
    params += conv_spec(prefix + "head", widths[0], out, 1)
    return params, stats
