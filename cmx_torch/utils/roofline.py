"""Least device time of each TPU kernel's work on one H100 (the roofline bound).

bound = max(bytes / memory rate, flops / peak rate of the operands' type),
counting each input read once and each output written once, from the
shapes alone. Peaks: NVIDIA H100 SXM data sheet, dense: 3.35 TB/s HBM3,
989 TFLOP/s bf16 tensor cores, 67 TFLOP/s fp32 outside the tensor cores
(at the full 700 W power limit).

chip_smoke.py computes the bounds from the shapes of the kernel calls it
records in one SparK step, and prints `table()` of those shapes.
"""

from __future__ import annotations

from typing import List, Tuple

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
    """K1/K7: bf16 input, mask and output, bf16 weights, fp32 bias and
    stats; one FMA per tap, input and output channel."""
    nbytes = 2.0 * B * H * W * (Cin + C + 1) + 2 * 9 * Cin * C + 4 * 3 * C
    return nbytes, 2.0 * 9 * Cin * C * B * H * W


def conv3x3_bwd_work(B, H, W, Cin, C, need_dx=True) -> Tuple[float, float]:
    """K2/K8: reads g, y (bf16, C channels), the stage input (Cin), the mask
    and weights; writes dX (bf16, when needed) and dW (fp32)."""
    nbytes = (2.0 * B * H * W * (2 * C + Cin + 1 + (Cin if need_dx else 0))
              + 2 * 9 * Cin * C + 4 * 9 * Cin * C + 4 * 8 * C)
    return nbytes, 2.0 * 9 * Cin * C * B * H * W * (2 if need_dx else 1)


def spark_loss_work(B, H, W, patch=16) -> Tuple[float, float]:
    """K3: reads rec and imgs (fp32) and the active grid, writes the map;
    about ten flops a pixel."""
    cells = B * (H // patch) * (W // patch)
    return 4.0 * (2 * B * H * W + 2 * cells), 10.0 * B * H * W


def crop_work(B, H, W, out) -> Tuple[float, float]:
    """K4: per image two fp32 products, (out,H)x(H,W) then (out,W)x(W,out)."""
    nbytes = 4.0 * B * (H * W + out * out + 4)
    return nbytes, 2.0 * B * (out * H * W + out * W * out)


def bn_relu_mask_work(B, H, W, C) -> Tuple[float, float]:
    """K5: bf16 in and out, bf16 mask; three flops an element."""
    return 2.0 * B * H * W * (2 * C + 1) + 8 * C, 3.0 * B * H * W * C


def stem_work(B, H, W, C) -> Tuple[float, float]:
    """K6: (B,H,W,9) bf16 patches and mask in, bf16 output and stats out."""
    nbytes = 2.0 * B * H * W * (9 + 1 + C) + 2 * 9 * C + 4 * 3 * C
    return nbytes, 2.0 * 9 * C * B * H * W


def table(B: int, stages: List[Tuple[int, int, int, int, bool]]) -> List[dict]:
    """One row per TPU kernel: the bound of all its launches' work in one
    SparK step at batch B, whose fused DoubleConv stages are `stages`, as
    (H, W, Cin, Cout, input gradient needed). K4: one MoCo-preset view batch
    (256 images, 256^2 -> 224^2); K3 the loss at the first stage's (the
    input's) size; K5 (no caller): the epilogue of the first stage; K6-K8: the same stages through the NHWC kernels of
    FUSED_IMPL="nhwc" (K6 the Cin=1 stems, K7 the other convs, K8 the
    backward of stages with Cin >= 8; cmx leaves Cin < 8 to XLA there)."""
    fwd = [conv3x3_fwd_work(B, h, w, ci, c) for h, w, ci, c, _ in stages]
    bwd = [conv3x3_bwd_work(B, h, w, ci, c, dx) for h, w, ci, c, dx in stages]
    h0, w0, _, c0, _ = stages[0]
    rows = [
        ("K1", "flat_conv3x3_mask_stats", fwd, PEAK_BF16),
        ("K2", "flat_bwd_mega", bwd, PEAK_BF16),
        ("K3", "spark_loss_pallas", [spark_loss_work(B, h0, w0)], PEAK_FP32),
        ("K4", "crop_resize_pallas", [crop_work(256, 256, 256, 224)],
         PEAK_FP32),
        ("K5", "bn_relu_mask_pallas", [bn_relu_mask_work(B, h0, w0, c0)],
         PEAK_BF16),
        ("K6", "conv_stem_stats",
         [stem_work(B, h, w, c) for h, w, ci, c, _ in stages if ci == 1],
         PEAK_BF16),
        ("K7", "conv3x3_mask_stats",
         [f for f, st in zip(fwd, stages) if st[2] > 1], PEAK_BF16),
        ("K8", "bwd_mega", [b for b, st in zip(bwd, stages) if st[2] >= 8],
         PEAK_BF16),
    ]
    out = []
    for key, name, works, peak in rows:
        nbytes = sum(b for b, _ in works)
        flops = sum(f for _, f in works)
        ms, by = bound_ms(nbytes, flops, peak)
        out.append({"kernel": key, "name": name, "launches": len(works),
                    "bytes": nbytes, "flops": flops, "bound_ms": ms,
                    "bound_by": by})
    return out
