"""K2_roofline: the least time of the fused DoubleConv's backward work in a
step (perfbench/roofline.py: conv3x3_bwd_work over the fused encoder
stages, dX skipped at the image) over the device time a step of K2's three
kernels (cmx_torch/csrc/flat_conv_bwd.cu: the BN backward dy, the dX
implicit GEMM without prologue or statistics, the dW GEMM)."""

from perfbench import roofline

KERNELS = [r"bn_bwd_dy_cm_kernel",
           r"flat_conv3x3_mma_kernel<\s*false\s*,\s*false\s*>",
           r"flat_dw_mma_kernel"]


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
    return 100.0 * roofline.stages_bound_ms(ctx["batch"], stages, True) / ms
