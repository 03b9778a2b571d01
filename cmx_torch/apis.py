"""Convenience APIs: init_model / inference_model (port of cmx/apis.py, the
counterpart of CM-UNet's cmae/apis/inference.py:17-90)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cmx_torch import resolve_device
from cmx_torch.models.unet import UNet
from cmx_torch.ops.augment import _resize_weight_mat


def init_model(encoder_path: Optional[str] = None, out_classes: int = 2,
               seed: int = 0, dtype: torch.dtype = torch.bfloat16,
               device="cuda") -> UNet:
    """An eval-mode UNet on `device` (the card unless "cpu" is asked for),
    random weights from `seed`, with a pretrained encoder loaded when
    `encoder_path` is given (any regime's encoder.npz, from either
    package)."""
    model = UNet(out_classes=out_classes, dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model = model.to(resolve_device(device)).eval()
    if encoder_path:
        from cmx_torch.ckpt.checkpoint import load_encoder

        load_encoder(encoder_path, model)
    return model


def _resize_cubic(img: torch.Tensor, size: int) -> torch.Tensor:
    """jax.image.resize(img, (B, size, size), "cubic") of (B, H, W): Keys
    a = -0.5 with antialias on each axis whose length changes."""
    for axis in (1, 2):
        n = img.shape[axis]
        if n == size:
            continue
        scale = torch.full((1,), size / n, dtype=torch.float32,
                           device=img.device)
        w = _resize_weight_mat(n, size, scale, torch.zeros_like(scale),
                               "cubic")[0]  # (n, size)
        img = (torch.einsum("bhw,hk->bkw", img, w) if axis == 1
               else torch.einsum("bhw,wk->bhk", img, w))
    return img


def inference_model(model: UNet, image, size: int = 256) -> np.ndarray:
    """Segment one (H, W) image or a (B, H, W) batch (an array, or a
    tensor): cubic resize to size^2, forward, softmax. Returns the
    probabilities as a numpy array in cmx's class-last layout, (B, size,
    size, C), or (size, size, C) for a single image, so that a script reads
    either package's output the same way."""
    dev = next(model.parameters()).device
    img = torch.as_tensor(image, dtype=torch.float32).to(dev)
    single = img.dim() == 2
    if single:
        img = img[None]
    img = _resize_cubic(img, size)
    model.eval()
    with torch.no_grad():
        probs = torch.softmax(model(img), dim=1)
    probs = probs.permute(0, 2, 3, 1).cpu().numpy()
    return probs[0] if single else probs
