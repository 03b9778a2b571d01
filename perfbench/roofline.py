"""The yardstick's frozen copy of the port's roofline arithmetic
(cmx_torch/utils/roofline.py as of its first benchmark): the least device
time of a kernel's work on one H100, and that work counted from shapes.

bound = max(bytes / memory rate, flops / peak rate of the operands' type),
each input read once and each output written once. Peaks: NVIDIA H100 SXM
data sheet, dense, at the full 700 W power limit: 3.35 TB/s HBM3, 989
TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32 outside them.

The program may change its own copy; this one stays, so a kernel's share of
its roofline means the same in every later check.
"""

from __future__ import annotations

from typing import Tuple

PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12


def bound_ms(nbytes: float, flops: float, peak_flops: float) -> Tuple[float, str]:
    """(least time in ms, "bytes" or "operations")."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / peak_flops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def conv3x3_fwd_work(B, H, W, Cin, C) -> Tuple[float, float]:
    """K1: bf16 input, mask and output, bf16 weights, fp32 bias and stats;
    one FMA per tap, input and output channel."""
    nbytes = 2.0 * B * H * W * (Cin + C + 1) + 2 * 9 * Cin * C + 4 * 3 * C
    return nbytes, 2.0 * 9 * Cin * C * B * H * W


def conv3x3_bwd_work(B, H, W, Cin, C, need_dx=True) -> Tuple[float, float]:
    """K2: reads g, y (bf16, C channels), the stage input (Cin), the mask
    and weights; writes dX (bf16, when needed) and dW (fp32)."""
    nbytes = (2.0 * B * H * W * (2 * C + Cin + 1 + (Cin if need_dx else 0))
              + 2 * 9 * Cin * C + 4 * 9 * Cin * C + 4 * 8 * C)
    return nbytes, 2.0 * 9 * Cin * C * B * H * W * (2 if need_dx else 1)


# The stages the fused DoubleConv takes (cmx's gate, as the port keeps it):
# training in bf16, H >= 128, H % 32 == 0, W % 8 == 0, Cin <= 128.
FUSED_MIN_HW, FUSED_STRIP, FUSED_MAX_CIN = 128, 32, 128


def fused_encoder_stages(widths, size: int):
    """[(H, W, Cin, Cout, input gradient needed)] of the encoder's stages
    that run fused at a square input of `size`: both stages of each level
    the gate passes. The first stage's input is the image, which needs no
    gradient."""
    stages, cin, h = [], 1, size
    for w in widths:
        if h >= FUSED_MIN_HW and h % FUSED_STRIP == 0 and cin <= FUSED_MAX_CIN:
            stages += [(h, h, cin, w, cin != 1), (h, h, w, w, True)]
        cin, h = w, h // 2
    return stages


def stages_bound_ms(batch: int, stages, backward: bool) -> float:
    """The bound of all the stages' K1 (forward) or K2 (backward) work in
    one step, summed as one kernel's."""
    works = [conv3x3_bwd_work(batch, h, w, ci, c, dx) if backward
             else conv3x3_fwd_work(batch, h, w, ci, c)
             for h, w, ci, c, dx in stages]
    return bound_ms(sum(b for b, _ in works), sum(f for _, f in works),
                    PEAK_BF16)[0]
