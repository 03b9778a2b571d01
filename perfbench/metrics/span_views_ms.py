"""span_views_ms: device ms a step of the kernels whose innermost span is
`views`: the task's crops, flips, jitter and mask draws (ssl/cmunet.py,
ssl/spark.py loss_fn; ops/augment.py, ops/masking.py); perfbench/spans.py."""

from perfbench import spans


def read(ctx):
    return spans.span_ms(ctx, "views")
