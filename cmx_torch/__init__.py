"""cmx_torch — the PyTorch/CUDA port of cmx, for one NVIDIA H100.

The JAX package `cmx/` is the reference; this package mirrors its module
layout and names (`cmx_torch.ops.fused_conv_flat` <-> `cmx.ops.fused_conv_flat`
...) and imports neither JAX nor anything under `cmx`. Every Pallas kernel on
a ported path has a hand-written Hopper kernel beside a plain PyTorch version
of the same function; a wrapper takes the plain version only for tensors on
the CPU.

Entry points take an explicit `device` that defaults to "cuda" and raise when
no card is present; only an explicit `device="cpu"` runs on the CPU.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """torch.device for `device`; a CUDA device must exist.

    Also fixes the float32 matmul/conv precision on the card: cmx runs its
    fp32 products at full precision (the crop at Precision.HIGHEST), so TF32
    is off for both cuBLAS and cuDNN on the port's path."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "cmx_torch: device 'cuda' requested but no CUDA device is "
                "available (pass device='cpu' to run the plain versions)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"cmx_torch runs on 'cuda' or 'cpu', got {device!r}")
    return dev
