"""span_loss_ms: device ms a step of the kernels whose innermost span is
`loss`: the loss heads forward and backward (CM-UNet's reconstruction and
InfoNCE, SparK's loss or K3); perfbench/spans.py."""

from perfbench import spans


def read(ctx):
    return spans.span_ms(ctx, "loss")
