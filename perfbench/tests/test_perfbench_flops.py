"""The FLOP counter against a hand count of one UNet."""

import pytest

from perfbench import flops
from perfbench.cells import load_cell


def _hand_unet(s: int) -> float:
    """Forward flops of the 5-level UNet (1-64-128-256-512, 1024) with a
    one-channel head at an s x s input, layer by layer: 2 * k^2 * Cin *
    Cout * H * W a conv."""
    c3 = lambda h, ci, co: 2 * 9 * ci * co * h * h  # noqa: E731
    enc = (c3(s, 1, 64) + c3(s, 64, 64)
           + c3(s // 2, 64, 128) + c3(s // 2, 128, 128)
           + c3(s // 4, 128, 256) + c3(s // 4, 256, 256)
           + c3(s // 8, 256, 512) + c3(s // 8, 512, 512)
           + c3(s // 16, 512, 1024) + c3(s // 16, 1024, 1024))
    up = lambda h, ci, co: 2 * 4 * ci * co * (h // 2) ** 2  # noqa: E731
    dec = (up(s // 8, 1024, 512) + c3(s // 8, 1024, 512) + c3(s // 8, 512, 512)
           + up(s // 4, 512, 256) + c3(s // 4, 512, 256) + c3(s // 4, 256, 256)
           + up(s // 2, 256, 128) + c3(s // 2, 256, 128) + c3(s // 2, 128, 128)
           + up(s, 128, 64) + c3(s, 128, 64) + c3(s, 64, 64)
           + 2 * 64 * 1 * s * s)
    return enc + dec


def test_spark_step_flops_match_a_hand_count():
    cell = load_cell("spark-b128-fused")
    fwd = _hand_unet(256)
    first = 2 * 9 * 1 * 64 * 256 * 256
    expect = 128 * (3 * fwd - first)
    assert flops.step_flops(cell["config"], 128) == pytest.approx(expect,
                                                                  rel=1e-12)
    # about 290 GFLOP an image
    assert 280e9 < expect / 128 < 300e9


def test_cmunet_step_counts_two_decoders_and_a_forward_target():
    cell = load_cell("cmunet-b128")
    v = 224
    unet = _hand_unet(v)
    head = 2 * 64 * 1 * v * v
    W = (64, 128, 256, 512)
    enc = (unet - head) - (flops.decoder(v, 1, W, 1024) - head)
    dec2 = flops.decoder(v, 2, W, 1024)
    necks = 2 * (v * v * 1536 + 1536 * 256 + 256 * 1536 + 1536 * 256)
    first = 2 * 9 * 64 * v * v
    online = 3 * (enc + 2 * dec2 + necks) - first
    target = enc + 2 * 14 * 14 * 1024 * 256 + 2 * (v * v * 1536 + 1536 * 256)
    got = flops.step_flops(cell["config"], 1)
    assert got == pytest.approx(online + target, rel=1e-12)
    assert 370e9 < got < 410e9
