"""span_norm_ms: device ms a step of the kernels whose innermost span is
`norm`: the batch norms' moments, folds and running updates and their
gradients (models/blocks.py MaskedBatchNorm, models/necks.py
FeatureBatchNorm; the fused DoubleConv's K1/K2 calls whole), online and
target; perfbench/spans.py."""

from perfbench import spans


def read(ctx):
    return spans.span_ms(ctx, "norm")
