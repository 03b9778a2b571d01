"""K1_roofline: the least time of the fused DoubleConv's forward work in a
step (perfbench/roofline.py: conv3x3_fwd_work over the encoder stages the
fused gate passes, bf16 tensor-core peak or HBM bandwidth) over the device
time a step of K1's kernels (cmx_torch/csrc/flat_conv_fwd.cu: the implicit
GEMM instances that write the stage's statistics)."""

from perfbench import roofline

KERNELS = [r"flat_conv3x3_mma_kernel<\s*(true|false)\s*,\s*true\s*>"]


def read(ctx):
    tr = ctx.get("trace")
    cfg = ctx["cell"]["config"]
    if tr is None or not cfg["settings"].get("model.fused_conv"):
        return None
    ms = tr.ms_per_step(KERNELS)
    if ms is None:
        return None
    stages = roofline.fused_encoder_stages(cfg["widths"],
                                           cfg["settings"]["data.image_size"])
    return 100.0 * roofline.stages_bound_ms(ctx["batch"], stages, False) / ms
