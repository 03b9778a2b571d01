"""Least device time of each TPU kernel's work on one H100 (the roofline bound).

bound = max(bytes / memory rate, flops / peak rate of the operands' type),
counting each input read once and each output written once, from the
shapes (and, for K4, the windows: its work is the pixels inside each
window and the non-zero taps of its weights). Peaks: NVIDIA H100 SXM data sheet, dense: 3.35 TB/s HBM3,
989 TFLOP/s bf16 tensor cores, 67 TFLOP/s fp32 outside the tensor cores
(at the full 700 W power limit).

chip_smoke.py computes the bounds from the kernel calls it records in one
SparK step of each fused impl ("flat", "nhwc") and one MoCo step, and prints
`table()` of those calls.
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


def spark_loss_work(B, H, W, rec_bytes, act_bytes=4, patch=16
                    ) -> Tuple[float, float]:
    """K3 forward: reads rec (rec_bytes a pixel: 4 on the main path, whose
    decoder returns fp32; 2 in bf16), imgs (fp32) and the active grid
    (act_bytes a cell), writes the loss and the denominator; about ten flops
    a pixel."""
    cells = B * (H // patch) * (W // patch)
    return (float(B * H * W * (rec_bytes + 4) + act_bytes * cells + 8),
            10.0 * B * H * W)


def spark_loss_bwd_work(B, H, W, rec_bytes, act_bytes=4, patch=16
                        ) -> Tuple[float, float]:
    """K3 backward: reads rec, imgs, the active grid, the cotangent and the
    denominator, writes drec in rec's dtype; about ten flops a pixel."""
    cells = B * (H // patch) * (W // patch)
    return (float(B * H * W * (2 * rec_bytes + 4) + act_bytes * cells + 8),
            10.0 * B * H * W)


def crop_work(out, rows, cols, taps_y, taps_x) -> Tuple[float, float]:
    """K4: reads the pixels each image's window needs and its params, writes
    the crops (fp32). Per image (sequences of length B): `rows` / `cols`
    count the input rows / columns where some tap of wy (out,H) / wx (out,W)
    is non-zero, so the image's rows x cols pixels are read (a MoCo window
    covers 0.2-1.0 of the image); `taps_y` / `taps_x` count the non-zero taps
    (a band: 2-3 a row for a linear window, twice that cubic). Each tap costs
    about ten flops to evaluate and one FMA per pixel it scales: a wy tap
    scales a row of `cols` pixels and a wx tap a column of out rows (y
    first), or a wx tap a column of `rows` pixels and a wy tap a row of out
    (x first); the cheaper order counts. K4 sums y first over bands
    (`pallas_crop.crop_bands`) that hold these taps and a few exact zeros
    beside them, and its y pass reads whole rows of W, so it reads more
    than this counts where the window is narrower than the image."""
    B = len(rows)
    nbytes = 4.0 * (sum(r * c for r, c in zip(rows, cols)) + B * out * out
                    + 4 * B)
    fma = min(sum(ty * c + tx * out for ty, tx, c in zip(taps_y, taps_x, cols)),
              sum(tx * r + ty * out for ty, tx, r in zip(taps_y, taps_x, rows)))
    return nbytes, 2.0 * fma + 10.0 * (sum(taps_y) + sum(taps_x))


def bn_relu_mask_work(B, H, W, C) -> Tuple[float, float]:
    """K5: bf16 in and out, bf16 mask, fp32 scale and bias; three fp32 flops
    an element."""
    return 2.0 * B * H * W * (2 * C + 1) + 8 * C, 3.0 * B * H * W * C


def stem_work(B, H, W, C) -> Tuple[float, float]:
    """K6: (B,H,W,9) bf16 patches and mask in, bf16 output and stats out."""
    nbytes = 2.0 * B * H * W * (9 + 1 + C) + 2 * 9 * C + 4 * 3 * C
    return nbytes, 2.0 * 9 * C * B * H * W


def table(B: int, stages: List[Tuple[int, int, int, int, bool]],
          crops: List[Tuple[int, int, int, int, float, float]],
          nhwc: List[Tuple[str, Tuple[int, int, int, int]]]) -> List[dict]:
    """One row per TPU kernel: the bound of all its launches' work in one
    step at batch B. K1-K3: the SparK step's flat fused DoubleConv stages,
    `stages` as (H, W, Cin, Cout, input gradient needed), and the loss's
    forward and backward at the first stage's (the input's) size, rec fp32
    (the decoder's head returns fp32); K4: one MoCo step's crop calls, `crops`
    as crop_work's arguments (out, rows, cols, taps_y, taps_x); K5 (no caller):
    the epilogue of the first stage; K6-K8: the calls recorded in one SparK
    step with FUSED_IMPL="nhwc", `nhwc` as (wrapper name, (H, W, Cin, Cout))
    (K6 conv_stem_stats, K7 conv3x3_mask_stats, K8 bwd_mega)."""
    fwd = [conv3x3_fwd_work(B, h, w, ci, c) for h, w, ci, c, _ in stages]
    bwd = [conv3x3_bwd_work(B, h, w, ci, c, dx) for h, w, ci, c, dx in stages]
    h0, w0, _, c0, _ = stages[0]

    def recorded(name):
        return [shape for n, shape in nhwc if n == name]

    rows = [
        ("K1", "flat_conv3x3_mask_stats", fwd, PEAK_BF16),
        ("K2", "flat_bwd_mega", bwd, PEAK_BF16),
        ("K3", "spark_loss_pallas", [spark_loss_work(B, h0, w0, 4),
                                      spark_loss_bwd_work(B, h0, w0, 4)],
         PEAK_FP32),
        ("K4", "crop_resize_pallas", [crop_work(*c) for c in crops],
         PEAK_FP32),
        ("K5", "bn_relu_mask_pallas", [bn_relu_mask_work(B, h0, w0, c0)],
         PEAK_FP32),
        ("K6", "conv_stem_stats",
         [stem_work(B, h, w, c) for h, w, _, c in recorded("conv_stem_stats")],
         PEAK_BF16),
        ("K7", "conv3x3_mask_stats",
         [conv3x3_fwd_work(B, *s) for s in recorded("conv3x3_mask_stats")],
         PEAK_BF16),
        ("K8", "bwd_mega",
         [conv3x3_bwd_work(B, *s) for s in recorded("bwd_mega")], PEAK_BF16),
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
