"""span_model_ms: device ms a step of the kernels whose innermost span is
`forward`, `backward` or `feed`: the model's convolutions, masks, ReLUs,
casts, pools and upsamples and their gradients outside the norms and the
loss heads, the gradients' all-reduce, and the corpus row gather;
perfbench/spans.py."""

from perfbench import spans


def read(ctx):
    return spans.span_ms(ctx, "forward", "backward", "feed")
