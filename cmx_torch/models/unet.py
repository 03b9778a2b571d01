"""The 5-level UNet encoder and decoder (port of cmx/models/unet.py:46-145).

Channel plan 1 -> 64 -> 128 -> 256 -> 512, bottleneck 1024, mirrored
decoder with skip concat and a 1x1 head. Inputs are (B,H,W) or (B,1,H,W);
activations are NCHW; logits come out in fp32.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from cmx_torch.models.blocks import (Conv, DoubleConv, DownBlock, UpBlock,
                                     max_pool_2x2)

ENCODER_WIDTHS: Tuple[int, ...] = (64, 128, 256, 512)
BOTTLENECK_WIDTH: int = 1024
DOWNSAMPLE_RATIO: int = 16


def _ensure_nchw(x: torch.Tensor) -> torch.Tensor:
    if x.dim() == 3:
        return x[:, None]
    if x.dim() == 4:
        return x
    raise ValueError(f"expected (B,H,W) or (B,C,H,W) input, got {tuple(x.shape)}")


class UNetEncoder(nn.Module):
    """4 DownBlocks + bottleneck DoubleConv; returns (bottleneck, skips).

    `mask` (B,H,W) or (B,1,H,W), 1 = keep, follows the maxpool to every
    scale (an output position is active iff any input of its 2x2 window
    was). The bottleneck is never fused, as in cmx."""

    def __init__(self, widths: Sequence[int] = ENCODER_WIDTHS,
                 bottleneck: int = BOTTLENECK_WIDTH,
                 dtype: torch.dtype = torch.bfloat16, fused: bool = False):
        super().__init__()
        self.dtype = dtype
        cin = 1
        for i, w in enumerate(widths):
            self.add_module(f"down{i + 1}", DownBlock(cin, w, dtype, fused))
            cin = w
        self.n_levels = len(widths)
        self.bottleneck = DoubleConv(cin, bottleneck, dtype, fused=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        x = _ensure_nchw(x).to(self.dtype)
        if mask is not None:
            mask = _ensure_nchw(mask).to(self.dtype)
            x = x * mask
        skips: List[torch.Tensor] = []
        for i in range(self.n_levels):
            x, skip = getattr(self, f"down{i + 1}")(x, mask)
            skips.append(skip)
            if mask is not None:
                mask = max_pool_2x2(mask)
        return self.bottleneck(x, mask), skips


class UNetDecoder(nn.Module):
    """4 UpBlocks (up4 .. up1) with skip concat + 1x1 head; fp32 logits.
    Unfused, as with cmx's default (its fused-decoder option waits)."""

    def __init__(self, out_classes: int = 2,
                 widths: Sequence[int] = ENCODER_WIDTHS,
                 in_channels: int = BOTTLENECK_WIDTH,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        cin = in_channels
        self.n_levels = len(widths)
        for lvl in range(self.n_levels, 0, -1):
            self.add_module(f"up{lvl}", UpBlock(cin, widths[lvl - 1], dtype))
            cin = widths[lvl - 1]
        self.head = Conv(widths[0], out_classes, 1, dtype)

    def forward(self, x: torch.Tensor, skips: Sequence[torch.Tensor]):
        for lvl in range(self.n_levels, 0, -1):
            x = getattr(self, f"up{lvl}")(x, skips[lvl - 1])
        return self.head(x).float()
