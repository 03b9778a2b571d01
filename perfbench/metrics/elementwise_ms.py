"""elementwise_ms: device ms a step of PyTorch's element-wise, reduction
and foreach kernels (the masked batch norms' moments and folds, the masks
and ReLUs, the optimizer's updates)."""

KERNELS = [r"elementwise_kernel", r"reduce_kernel",
           r"multi_tensor_apply_kernel"]
NOT = [r"cmx::"]


def read(ctx):
    tr = ctx.get("trace")
    return None if tr is None else tr.ms_per_step(KERNELS, NOT)
