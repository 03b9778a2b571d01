"""Space-to-depth (s2d) execution of a full-resolution UNet stage (port of
cmx/ops/s2d.py).

cmx wrote this as a TPU lane-filling relayout: the stride-1 SAME 3x3 conv
at full resolution re-expressed exactly on the (H/2, W/2, 4C) layout by
its polyphase decomposition. Output phase (di, dj) in {0, 1}^2 is a 2x2
conv over the 4C input with per-phase padding,

  out_fine[2i+di, 2j+dj] = sum_ky in_fine[2i+di+ky-1] w[ky]   (per axis)
  fine row 2i+di+ky-1 = s2d row (2i+di+ky-1)//2, phase (2i+di+ky-1)%2,

so the four phase kernels together hold each fine tap once. No Pallas
kernel and no caller in cmx's CLIs; the port keeps it as a layout op with
the same arithmetic, its convs `F.conv2d` (cmx's are lax.conv).

Layout at the port's boundary, NCHW: (B, C, H, W) <-> the rank-5
(B, 4, C, H/2, W/2) with phase = 2 * (row parity) + (col parity); flattening
(phase, C) gives the phase-major 4C channels the phase convs consume, as
cmx's (B, H/2, W/2, 4, C) flattens. Weights are the port's standard
parameters (a conv's (Cout, Cin, 3, 3), a ConvTranspose's (Cin, Cout, 2,
2)), expanded here, so s2d and fine checkpoints are the same.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

PHASES: Sequence = ((0, 0), (0, 1), (1, 0), (1, 1))


def s2d5(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4, C, H/2, W/2); phase index = 2*ri + rj."""
    b, c, h, w = x.shape
    y = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return y.reshape(b, 4, c, h // 2, w // 2)


def d2s5(y: torch.Tensor) -> torch.Tensor:
    """(B, 4, C, H/2, W/2) -> (B, C, H, W)."""
    b, p, c, h2, w2 = y.shape
    if p != 4:
        raise ValueError(f"d2s5 takes 4 phases, got {p}")
    x = y.reshape(b, 2, 2, c, h2, w2).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, c, 2 * h2, 2 * w2)


def expand_kernel_phase(w: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """A fine (Cout, Cin, 3, 3) SAME stride-1 kernel -> the (Cout, 4Cin, 2,
    2) polyphase kernel of output phase (di, dj), used with the padding
    ((1-di, di), (1-dj, dj))."""
    cout, cin, kh, kw = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"expand_kernel_phase takes a 3x3 kernel, got "
                         f"{tuple(w.shape)}")
    we = torch.zeros((cout, 4 * cin, 2, 2), dtype=w.dtype, device=w.device)
    for si in (0, 1):
        for sj in (0, 1):
            for ri in (0, 1):
                for rj in (0, 1):
                    ky = 2 * (si - (1 - di)) + ri - di + 1
                    kx = 2 * (sj - (1 - dj)) + rj - dj + 1
                    if 0 <= ky <= 2 and 0 <= kx <= 2:
                        ci0 = (ri * 2 + rj) * cin
                        we[:, ci0:ci0 + cin, si, sj] = w[:, :, ky, kx]
    return we


def phase_conv5(x5: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The SAME stride-1 3x3 conv executed in s2d space: x5 (B, 4, Cin,
    H/2, W/2), kernel the fine (Cout, Cin, 3, 3), bias (Cout,) -> (B, 4,
    Cout, H/2, W/2). Operands rounded to `dtype`, products summed in fp32
    (cmx's preferred_element_type), each phase cast to `dtype`, the bias
    added in `dtype`."""
    b, p, cin, h2, w2 = x5.shape
    x4 = x5.reshape(b, 4 * cin, h2, w2).to(dtype).float()
    outs = []
    for di, dj in PHASES:
        wp = expand_kernel_phase(kernel, di, dj).to(dtype).float()
        xp = F.pad(x4, (1 - dj, dj, 1 - di, di))
        outs.append(F.conv2d(xp, wp).to(dtype))
    out = torch.stack(outs, dim=1)  # (B, 4, Cout, H/2, W/2), phase 2di+dj
    return out + bias.to(dtype)[None, None, :, None, None]


def phase_max(x5: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool of the underlying fine tensor = the max over
    the phase axis: (B, 4, C, H/2, W/2) -> (B, C, H/2, W/2)."""
    return x5.amax(dim=1)


def up_transpose5(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """ConvTranspose(k=2, s=2) emitting the s2d layout directly: out_fine[o,
    2i+di, 2j+dj] = sum_c x[c, i, j] K[c, o, di, dj], one product per input
    pixel whose (di, dj, o) block is the rank-5 phase layout. x (B, Cin,
    H/2, W/2), kernel the port's ConvTranspose (Cin, Cout, 2, 2) (flax's,
    spatially flipped, as cmx flips it here), bias (Cout,) -> (B, 4, Cout,
    H/2, W/2): operands in `dtype`, summed in fp32, the bias added in fp32,
    cast to `dtype`."""
    b, cin, h2, w2 = x.shape
    cout = kernel.shape[1]
    k = kernel.to(dtype).permute(0, 2, 3, 1).reshape(cin, 4 * cout)
    y = torch.einsum("bchw,ck->bkhw", x.to(dtype).float(), k.float())
    y = y.reshape(b, 4, cout, h2, w2)  # phase = 2di+dj
    return (y + bias.float()[None, None, :, None, None]).to(dtype)
