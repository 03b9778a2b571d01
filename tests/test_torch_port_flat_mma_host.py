"""Host-side pieces of the tensor-core K1/K2 (the channel-major instances in
cmx_torch/csrc/conv3x3_mma.cuh), on the CPU: the shapes the flat wrappers
take, the weight packing of the flipped, channel-transposed dX weights, and
the partial-sum and split-K arithmetic at the flat family's shapes.

The kernels themselves run only on the card (tests/test_torch_port_cuda.py);
here their decomposition of the work is replayed in plain torch over
channel-major (B, C, H, W) maps from the same host functions and held to
the plain versions, which tests/test_torch_port_kernels.py holds to cmx.
Inputs come from numpy with a seed; fp32 throughout, tolerance rel 1e-5 of
the largest entry (summation order).
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cmx_torch.ops import fused_conv as fc
from cmx_torch.ops import fused_conv_flat as ff


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)


def _f32(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("H,W", [(8, 24), (8, 40), (16, 8), (256, 256),
                                 (40, 56)])
def test_flat_shape_check_takes_whole_row_tiles_and_words(H, W):
    fc._check_hw(H, W, *ff._FLAT_HW_MULT)


@pytest.mark.parametrize("H,W", [(8, 20), (12, 24), (32, 36), (4, 32)])
def test_flat_shape_check_refuses_partial_row_tiles_and_words(H, W):
    with pytest.raises(ValueError):
        fc._check_hw(H, W, *ff._FLAT_HW_MULT)


def _tiled_conv_cm(x, wp, cout):
    """The forward kernel's implicit GEMM over a channel-major map: per
    output-channel block and 16-channel chunk, nine shifted windows of the
    halo tile times the packed tap blocks."""
    kc, bn = fc._MMA_KC, fc._MMA_BN
    B, K, H, W = x.shape
    nn_, nk = wp.shape[:2]
    xp = F.pad(x, (1, 1, 1, 1, 0, nk * kc - K))
    out = torch.zeros((B, nn_ * bn, H, W))
    for nb in range(nn_):
        for c in range(nk):
            for t in range(9):
                dy, dx = divmod(t, 3)
                win = xp[:, c * kc:(c + 1) * kc, dy:dy + H, dx:dx + W]
                out[:, nb * bn:(nb + 1) * bn] += torch.einsum(
                    "bkhw,kn->bnhw", win, wp[nb, c, t])
    return out[:, :cout]


@pytest.mark.parametrize("Cin,C", [(1, 64), (3, 20), (24, 96), (64, 64),
                                   (128, 128)])
def test_packed_dx_weights_drive_the_tiled_conv_as_the_plain_k1(Cin, C):
    """K2's dX: the flipped, channel-transposed weights (9, C, Cin), packed
    as the wrapper packs them, replayed as the tiled GEMM over a
    channel-major dy, equal the plain K1 with those weights (no mask, no
    bias) and the plain K2's dX."""
    rng = np.random.default_rng(3)
    B, H, W = 2, 8, 40
    w = _f32(rng, 3, 3, Cin, C)
    dy = _f32(rng, B, C, H, W)
    wt = w.flip(0, 1).permute(0, 1, 3, 2).reshape(9, C, Cin)
    got = _tiled_conv_cm(dy, fc._pack_conv_weights(wt), Cin)
    saved = fc.COMPUTE_DTYPE
    fc.COMPUTE_DTYPE = torch.float32
    try:
        ones = torch.ones((B, 1, H * W))
        y, _, _ = ff.flat_conv3x3_mask_stats_plain(
            dy.reshape(B, C, H * W), ones, wt.reshape(3, 3, C, Cin),
            torch.zeros(Cin), H, W)
        # The plain K2 with y, g chosen so that its dy is exactly `dy`:
        # inv = 1, shift = 1 (every gate open for y = 0), s1 = s2 = 0, m = 1.
        one, zero = torch.ones(C), torch.zeros(C)
        dh, _ = ff.flat_bwd_mega_plain(
            dy.reshape(B, C, H * W), torch.zeros((B, C, H * W)),
            torch.zeros((B, Cin, H * W)), ones, one, one, zero,
            one - 1e-5, zero, zero, torch.tensor(1.0), w, H, W)
    finally:
        fc.COMPUTE_DTYPE = saved
    assert _rel(got.reshape(B, Cin, H * W), y) <= 1e-5
    assert _rel(got.reshape(B, Cin, H * W), dh) <= 1e-5


@pytest.mark.parametrize("B,H,W,Cin,C", [(2, 8, 40, 1, 64), (1, 16, 24, 3, 20),
                                         (2, 8, 64, 64, 64),
                                         (1, 16, 40, 24, 96)])
def test_flat_dw_split_k_partials_sum_to_the_weight_gradient(B, H, W, Cin, C):
    """The channel-major dW kernel's decomposition: chunks of pixel tiles
    (_dw_chunks over _dw_tiles), each tile's three kernel rows times three
    column shifts of h's channel rows against the tile's dy rows, one
    partial per chunk; the partials' sum is conv2d_weight's."""
    rng = np.random.default_rng(4)
    h = _f32(rng, B, Cin, H, W)
    dy = _f32(rng, B, C, H, W)
    tiles = fc._dw_tiles(B, H, W)
    nchunks, per = fc._dw_chunks(tiles, fc._dw_slices(Cin, C), 24)
    TR, TC = fc._MMA_DW_TR, fc._MMA_DW_TC
    tx, ty = math.ceil(W / TC), H // TR
    assert tiles == B * tx * ty
    hp = F.pad(h, (1, 1 + TC, 1, 1))  # zero halo, overhang columns
    dyp = F.pad(dy, (0, TC))
    part = torch.zeros((nchunks, 3, 3, Cin, C))
    for t in range(tiles):
        n, rem = divmod(t, tx * ty)
        y0, x0 = (rem // tx) * TR, (rem % tx) * TC
        d = dyp[n, :, y0:y0 + TR, x0:x0 + TC].reshape(C, -1)
        for a in range(3):
            for b in range(3):
                hs = hp[n, :, y0 + a:y0 + a + TR, x0 + b:x0 + b + TC]
                part[t // per, a, b] += hs.reshape(Cin, -1) @ d.T
    ref = torch.nn.grad.conv2d_weight(h, (C, Cin, 3, 3), dy, padding=1)
    assert _rel(part.sum(0), ref.permute(2, 3, 1, 0)) <= 1e-5


@pytest.mark.parametrize("B,H,W,rows", [(32, 256, 256, 32 * 32 * 8),
                                        (32, 128, 128, 32 * 16 * 4),
                                        (2, 8, 24, 2), (1, 16, 40, 4)])
def test_flat_partial_sum_rows_are_one_per_output_tile(B, H, W, rows):
    """K1 writes one (2, C) partial row per 8 x 32 output tile, a partial
    tile at the right edge included."""
    assert fc._conv_part_rows(B, H, W) == rows
    tiles_x = math.ceil(W / fc._MMA_TW)
    assert rows == B * (H // fc._MMA_TH) * tiles_x
