"""Shared pieces of the fused masked DoubleConv (port of cmx/ops/fused_conv.py).

The NHWC strip kernels of cmx (conv_stem_stats, conv3x3_mask_stats,
bwd_mega; reached only with FUSED_IMPL="nhwc") are not ported yet. What the
flat kernels and the model's fused gate need lives here: the constants, the
BN fold and the naive masked moments of the fused path, and a plain
reference of the masked DoubleConv for tests.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Strip height of the TPU kernels; blocks.DoubleConv's gate still requires
# H % STRIP == 0 so that the port fuses exactly where cmx does.
STRIP = 32
_EPS = 1e-5

# Gates of DoubleConv's fused path, as in cmx (tuned there for the TPU;
# module-level so tests and A/B tools can patch them).
FUSED_MIN_HW = 128
FUSED_MAX_CIN = 128

# Kernel compute/storage dtype: bf16 on the main path; tests set float32 to
# compare the hand-derived backward with autograd without rounding noise.
COMPUTE_DTYPE = torch.bfloat16


def _cdt() -> torch.dtype:
    return COMPUTE_DTYPE


def _fold(gamma, beta, mean, var):
    inv = gamma * torch.rsqrt(var + _EPS)
    return inv, beta - mean * inv


def _stats(ssum, sq, nact):
    """Naive masked moments E[x^2]-mean^2, clamped at 0 (the fused path's)."""
    mean = ssum / nact
    var = torch.clamp(sq / nact - mean * mean, min=0.0)
    return mean, var


def double_conv_reference(xf, mflat, w0, b0, g0, be0, w1, b1, g1, be1, H, W):
    """Plain masked DoubleConv (training mode) over flat operands, for tests.

    xf (B,Cin,H*W), mflat (B,1,H*W), w_i (3,3,Cin_i,C) HWIO. Mirrors
    cmx.ops.fused_conv.double_conv_reference (NHWC there) op for op; returns
    (out (B,C,H*W), (mean0, var0, mean1, var1))."""
    B = xf.shape[0]
    mf = mflat.float().reshape(B, 1, H, W)
    nact = torch.clamp(mflat.float().sum(), min=1.0)
    stats = []

    def stage(h, w, b, gamma, beta):
        cdt = _cdt()
        y = F.conv2d(h.to(cdt), w.to(cdt).permute(3, 2, 0, 1), padding=1)
        y = (y + b.to(y.dtype)[:, None, None]).float() * mf
        mean = y.sum((0, 2, 3)) / nact
        var = torch.clamp((y * y).sum((0, 2, 3)) / nact - mean ** 2, min=0.0)
        stats.append((mean, var))
        inv, shift = _fold(gamma, beta, mean, var)
        return (torch.relu(y * inv[:, None, None] + shift[:, None, None])
                * mf).to(cdt)

    h = stage(xf.reshape(B, -1, H, W), w0, b0, g0, be0)
    out = stage(h, w1, b1, g1, be1)
    return (out.reshape(B, out.shape[1], H * W),
            (stats[0][0], stats[0][1], stats[1][0], stats[1][1]))
