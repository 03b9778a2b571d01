"""span_optimizer_ms: device ms a step of the kernels whose innermost span is
`optimizer`: the global gradient norm and the optimizer's update
(train/optim.py); perfbench/spans.py."""

from perfbench import spans


def read(ctx):
    return spans.span_ms(ctx, "optimizer")
