"""The 5-level UNet family (port of cmx/models/unet.py).

Channel plan 1 -> 64 -> 128 -> 256 -> 512, bottleneck 1024, mirrored
decoder with skip concat and a 1x1 head. Inputs are (B,H,W) or (B,1,H,W);
activations are NCHW; logits come out in fp32, NCHW (cmx's are NHWC).
`UNet` is the fine-tune model (encoder + decoder, `fused` passed to both, as
in cmx; the decoder's `up_sample_mode` "conv_transpose" or "bilinear");
UNetEncoderGAP is MoCo's encoder: the encoder and a global average
pool to a 1024-d embedding. `remat_levels` names the blocks recomputed in
the backward pass, as cmx's: "e1".."e4" the DownBlocks, "bneck" the
bottleneck, "d1" (full resolution) .. "d4" the UpBlocks; other names are
ignored.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from cmx_torch.models.blocks import (Conv, DoubleConv, DownBlock, UpBlock,
                                     max_pool_2x2, reset_parameters, run_block)

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
    was). The bottleneck is never fused, as in cmx. `remat_levels`: "e1"..
    "e4", "bneck"."""

    def __init__(self, widths: Sequence[int] = ENCODER_WIDTHS,
                 bottleneck: int = BOTTLENECK_WIDTH,
                 dtype: torch.dtype = torch.bfloat16, fused: bool = False,
                 remat_levels: Sequence[str] = ()):
        super().__init__()
        self.dtype = dtype
        self.remat_levels = tuple(remat_levels)
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
            x, skip = run_block(getattr(self, f"down{i + 1}"),
                                f"e{i + 1}" in self.remat_levels, x, mask)
            skips.append(skip)
            if mask is not None:
                mask = max_pool_2x2(mask)
        return run_block(self.bottleneck, "bneck" in self.remat_levels, x,
                         mask), skips


class UNetDecoder(nn.Module):
    """4 UpBlocks (up4 .. up1) with skip concat + 1x1 head; fp32 logits.
    `fused` passes to every UpBlock's DoubleConv, whose gate decides (at
    256^2 only up1's passes, Cin 2*64 = 128, and in bilinear mode none:
    up1's concat is 128 + 64 = 192 > FUSED_MAX_CIN). `remat_levels`: "d1"
    (up1) .. "d4"."""

    def __init__(self, out_classes: int = 2,
                 widths: Sequence[int] = ENCODER_WIDTHS,
                 in_channels: int = BOTTLENECK_WIDTH,
                 dtype: torch.dtype = torch.bfloat16, fused: bool = False,
                 up_sample_mode: str = "conv_transpose",
                 remat_levels: Sequence[str] = ()):
        super().__init__()
        self.remat_levels = tuple(remat_levels)
        cin = in_channels
        self.n_levels = len(widths)
        for lvl in range(self.n_levels, 0, -1):
            self.add_module(f"up{lvl}", UpBlock(cin, widths[lvl - 1], dtype,
                                                fused, up_sample_mode))
            cin = widths[lvl - 1]
        self.head = Conv(widths[0], out_classes, 1, dtype)

    def forward(self, x: torch.Tensor, skips: Sequence[torch.Tensor]):
        for lvl in range(self.n_levels, 0, -1):
            x = run_block(getattr(self, f"up{lvl}"),
                          f"d{lvl}" in self.remat_levels, x, skips[lvl - 1])
        return self.head(x).float()


class UNet(nn.Module):
    """The segmentation UNet: `encoder` (UNetEncoder) + `decoder`
    (UNetDecoder), so that to_flax / from_flax give cmx's tree
    (encoder/down1/..., decoder/up4/up, decoder/head). (B,H,W) or (B,1,H,W)
    images -> (B, out_classes, H, W) fp32 logits. `fused` and
    `remat_levels` pass to both halves and `up_sample_mode` to the decoder,
    as cmx/models/unet.py:148-179 does."""

    def __init__(self, out_classes: int = 2,
                 widths: Sequence[int] = ENCODER_WIDTHS,
                 bottleneck: int = BOTTLENECK_WIDTH,
                 dtype: torch.dtype = torch.bfloat16, fused: bool = False,
                 up_sample_mode: str = "conv_transpose",
                 remat_levels: Sequence[str] = ()):
        super().__init__()
        self.encoder = UNetEncoder(widths, bottleneck, dtype, fused,
                                   remat_levels)
        self.decoder = UNetDecoder(out_classes, widths, bottleneck, dtype,
                                   fused, up_sample_mode, remat_levels)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """Random weights from `gen` (flax's initializers)."""
        reset_parameters(self, gen)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h, skips = self.encoder(x, mask)
        return self.decoder(h, skips)


class UNetEncoderGAP(nn.Module):
    """UNetEncoder (never fused, never masked, no remat, as cmx's) then the
    mean over H and W in fp32: (B,H,W) -> (B, bottleneck) embedding (MoCo's
    encoder)."""

    def __init__(self, widths: Sequence[int] = ENCODER_WIDTHS,
                 bottleneck: int = BOTTLENECK_WIDTH,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.emb_dim = bottleneck
        self.encoder = UNetEncoder(widths, bottleneck, dtype, fused=False)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """Random weights from `gen` (flax's initializers)."""
        reset_parameters(self, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, _ = self.encoder(x)
        return h.float().mean(dim=(2, 3))
