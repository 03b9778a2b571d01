"""conv_lib_ms: device ms a step of the library's convolution and matrix
kernels (cuDNN, cuBLAS, CUTLASS: forward, data and weight gradients) and
the layout transposes around them (nchwToNhwc and kin); the port's own
kernels (namespace cmx) excluded."""

KERNELS = [r"xmma", r"cudnn", r"cutlass", r"[Gg]emm", r"nvjet",
           r"nchwToNhwc", r"nhwcToNchw", r"implicit_convolve", r"dgrad",
           r"wgrad", r"fprop", r"convolve"]
NOT = [r"cmx::"]


def read(ctx):
    tr = ctx.get("trace")
    return None if tr is None else tr.ms_per_step(KERNELS, NOT)
