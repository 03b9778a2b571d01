"""UNet building blocks (port of cmx/models/blocks.py).

Activations are NCHW inside the port. Parameters keep cmx's names (a conv's
`kernel` and `bias`, a norm's `scale` and `bias`, running `mean` and `var`
buffers) so cmx_torch.ckpt.checkpoint maps a flax tree mechanically; conv
kernels are stored OIHW (torch's layout) and mapped from flax's HWIO there.
bf16 compute, fp32 parameters and statistics, as in cmx. Training mode
(`module.train()`) is cmx's use_running_average=False.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from cmx_torch.ops import fused_conv as fc


def _lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's default kernel init: truncated normal (+-2 std), variance
    1/fan_in after truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)


class Conv(nn.Module):
    """flax nn.Conv(features, (k, k), padding SAME) with fp32 parameters,
    computed in `dtype` (input, kernel and bias cast, as flax does)."""

    def __init__(self, cin: int, cout: int, k: int = 3,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def reset_parameters(self, gen: torch.Generator) -> None:
        cout, cin, k, _ = self.kernel.shape
        with torch.no_grad():
            _lecun_normal_(self.kernel, cin * k * k, gen)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel.shape[-1]
        return F.conv2d(x.to(self.dtype), self.kernel.to(self.dtype),
                        self.bias.to(self.dtype), padding=k // 2)


class ConvTranspose(nn.Module):
    """flax nn.ConvTranspose(features, (2, 2), strides (2, 2)); the kernel is
    stored in torch's (Cin, Cout, 2, 2) layout (the flax kernel spatially
    flipped, see ckpt.checkpoint)."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(cin, cout, 2, 2))
        self.bias = nn.Parameter(torch.zeros(cout))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            _lecun_normal_(self.kernel, 4 * self.kernel.shape[0], gen)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x.to(self.dtype), self.kernel.to(self.dtype),
                                  self.bias.to(self.dtype), stride=2)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over active positions only (cmx's default `shift_ra`
    variant): one-pass moments shifted by the stored running mean,
        var = E[(x-s)^2 m]/n - (E[(x-s) m]/n)^2,  s = running mean (constant),
    clamped at 0; running stats updated as 0.9*old + 0.1*batch with the
    population variance. With mask=None it is plain BatchNorm. Normalizes as
    one multiply-add in `dtype` with (C,)-sized folds computed in fp32."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None,
                 momentum: float = 0.9, epsilon: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset_parameters(self, gen: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Running-average update with externally computed batch moments
        (the fused DoubleConv computes them in its kernels)."""
        self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
        self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B,C,H,W); mask (B,1,H,W) or (B,H,W) with 1 = active."""
        if not self.training:
            mean, var = self.mean, self.var
        else:
            xf = x.float()
            red = (0, 2, 3)
            s = self.mean.clone()[:, None, None]  # stop-gradient shift
            if mask is None:
                d = xf - s
                dm = d.mean(red)
                mean = dm + s[:, 0, 0]
                var = (d * d).mean(red) - dm * dm
            else:
                m = mask.float()
                if m.dim() == 3:
                    m = m[:, None]
                denom = torch.clamp(m.sum(red), min=1.0)
                d = (xf - s) * m
                dm = d.sum(red) / denom
                mean = dm + s[:, 0, 0]
                var = (d * d).sum(red) / denom - dm * dm
            var = torch.clamp(var, min=0.0)
            self.update_running(mean.detach(), var.detach())
        out_dtype = self.dtype or x.dtype
        inv = torch.rsqrt(var + self.epsilon) * self.scale
        shift = self.bias - mean * inv
        return (x.to(out_dtype) * inv.to(out_dtype)[:, None, None]
                + shift.to(out_dtype)[:, None, None])


class DoubleConv(nn.Module):
    """Two (Conv3x3 -> re-mask -> masked BN -> ReLU -> re-mask) stages.

    In training mode with `fused`, bf16 and a stage shape inside the gates of
    cmx (H >= FUSED_MIN_HW, H % STRIP == 0, W % 8 == 0, Cin <= FUSED_MAX_CIN;
    cmx/models/blocks.py:233-241) the stage runs through the flat fused
    kernels (FlatDoubleConv), with naive moments and zero conv-bias grads as
    in cmx; the parameter tree is the same either way."""

    def __init__(self, cin: int, features: int,
                 dtype: torch.dtype = torch.bfloat16, fused: bool = False):
        super().__init__()
        self.dtype = dtype
        self.fused = fused
        self.conv0 = Conv(cin, features, 3, dtype)
        self.bn0 = MaskedBatchNorm(features, dtype)
        self.conv1 = Conv(features, features, 3, dtype)
        self.bn1 = MaskedBatchNorm(features, dtype)

    def use_fused(self, x: torch.Tensor) -> bool:
        _, cin, h, w = x.shape
        return (self.fused and self.training and self.dtype == torch.bfloat16
                and h >= fc.FUSED_MIN_HW and h % fc.STRIP == 0 and w % 8 == 0
                and cin <= fc.FUSED_MAX_CIN)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B,Cin,H,W); mask (B,1,H,W) or None."""
        if self.use_fused(x):
            from cmx_torch.ops import fused_conv_flat as ff

            B, cin, H, W = x.shape
            if mask is None:
                m = torch.ones((B, H, W), dtype=torch.bfloat16, device=x.device)
            else:
                m = mask[:, 0] if mask.dim() == 4 else mask
            params = []
            for conv, bn in ((self.conv0, self.bn0), (self.conv1, self.bn1)):
                params += [conv.kernel.permute(2, 3, 1, 0), conv.bias,
                           bn.scale, bn.bias]
            outf, (mean0, var0, mean1, var1) = ff.flat_double_conv(
                x.to(self.dtype).reshape(B, cin, H * W),
                m.reshape(B, 1, H * W), *params, H, W)
            self.bn0.update_running(mean0, var0)
            self.bn1.update_running(mean1, var1)
            return outf.reshape(B, -1, H, W)

        for conv, bn in ((self.conv0, self.bn0), (self.conv1, self.bn1)):
            x = conv(x)
            if mask is not None:
                x = x * mask.to(x.dtype)
            x = torch.relu(bn(x, mask))
            if mask is not None:
                x = x * mask.to(x.dtype)
        return x


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


class DownBlock(nn.Module):
    """DoubleConv then 2x2 maxpool; returns (down, skip)."""

    def __init__(self, cin: int, features: int,
                 dtype: torch.dtype = torch.bfloat16, fused: bool = False):
        super().__init__()
        self.double_conv = DoubleConv(cin, features, dtype, fused)

    def forward(self, x, mask=None):
        skip = self.double_conv(x, mask)
        return max_pool_2x2(skip), skip


class UpBlock(nn.Module):
    """ConvTranspose 2x2 s2, concat skip, DoubleConv. (cmx's bilinear
    up-sample mode is not ported yet: ROADMAP, LightDecoder item.)"""

    def __init__(self, cin: int, features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.up = ConvTranspose(cin, features, dtype)
        self.double_conv = DoubleConv(2 * features, features, dtype)

    def forward(self, x, skip):
        x = self.up(x)
        x = torch.cat([x, skip.to(x.dtype)], dim=1)
        return self.double_conv(x)


def reset_parameters(module: nn.Module, gen: torch.Generator) -> None:
    """Initialize every block of `module` in a fixed order from `gen`."""
    for m in module.modules():
        if isinstance(m, (Conv, ConvTranspose, MaskedBatchNorm)):
            m.reset_parameters(gen)
