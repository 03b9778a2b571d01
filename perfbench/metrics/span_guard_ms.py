"""span_guard_ms: device ms a step of the kernels whose innermost span is
`guard`: the NaN guard's buffer copies and restores and the post-update, CM-
UNet's EMA (train/trainer.py); perfbench/spans.py."""

from perfbench import spans


def read(ctx):
    return spans.span_ms(ctx, "guard")
