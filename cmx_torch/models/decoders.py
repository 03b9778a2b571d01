"""SparK's LightDecoder (port of cmx/models/decoders.py).

A sum-in pyramid of upsample blocks (Spark/decoder.py:17-31, 81-100): each
block is ConvTranspose 4x4 stride 2 -> Conv3x3 (no bias) -> BN -> ReLU6 ->
Conv3x3 (no bias) -> BN, halving the width; a 1x1 projection to one channel
ends it, in fp32. The BNs are MaskedBatchNorm with no mask (plain BN). The
full-UNet variant is cmx_torch.models.unet.UNetDecoder(out_classes=1).
Activations NCHW, parameters under cmx's names.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn

from cmx_torch.models.blocks import Conv, ConvTranspose, MaskedBatchNorm


class LightDecoderBlock(nn.Module):
    """One 2x upsample block, cin -> cout channels."""

    def __init__(self, cin: int, cout: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.up = ConvTranspose(cin, cin, dtype, k=4)
        self.conv0 = Conv(cin, cin, 3, dtype, bias=False)
        self.bn0 = MaskedBatchNorm(cin, dtype)
        self.conv1 = Conv(cin, cout, 3, dtype, bias=False)
        self.bn1 = MaskedBatchNorm(cout, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn0(self.conv0(self.up(x)))
        x = torch.clamp(torch.relu(x), max=6.0)  # ReLU6
        return self.bn1(self.conv1(x))


class LightDecoder(nn.Module):
    """log2(up_sample_ratio) blocks, widths width / 2^i; stage i adds
    to_dec[i] (a map already at the stage's width and scale, or None) before
    its block. to_dec runs from the smallest map to the largest; entries
    past the last block are not read, as in cmx. Returns (B, 1, H, W) fp32."""

    def __init__(self, up_sample_ratio: int = 16, width: int = 768,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        n = round(math.log2(up_sample_ratio))
        channels = [width // 2 ** i for i in range(n + 1)]
        self.n_blocks = n
        for i, (cin, cout) in enumerate(zip(channels[:-1], channels[1:])):
            self.add_module(f"block{i}", LightDecoderBlock(cin, cout, dtype))
        self.proj = Conv(channels[-1], 1, 1, dtype)

    def forward(self, to_dec: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
        x = None
        for i in range(self.n_blocks):
            if i < len(to_dec) and to_dec[i] is not None:
                t = to_dec[i].to(self.dtype)
                x = t if x is None else x + t
            x = getattr(self, f"block{i}")(x)
        return self.proj(x).float()
