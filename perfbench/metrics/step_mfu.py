"""step_mfu: the step's model FLOPs (perfbench/flops.py: forward and
backward of every conv, transposed conv and dense layer, counted once from
the shapes) times the window's steps, over the untraced window's seconds,
as a share of one H100's dense bf16 peak, 989 TFLOP/s."""

from perfbench.roofline import PEAK_BF16


def read(ctx):
    return 100.0 * ctx["step_flops"] * ctx["steps"] / ctx["window_s"] / PEAK_BF16
