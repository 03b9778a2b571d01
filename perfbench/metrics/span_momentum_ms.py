"""span_momentum_ms: device ms a step of the kernels whose innermost span is
`momentum`: a momentum network's forward without gradient and its row
normalisation (MoCo's key encoder: its convolutions, ReLUs, pools and mean;
its batch norms fall under `norm`); perfbench/spans.py. None where the
program has no such span."""

from perfbench import spans


def read(ctx):
    got = spans.split(ctx)
    return None if got is None or "momentum" not in got else got["momentum"]
