"""Batched crop + resize (port of cmx/ops/pallas_crop.py).

K4 `crop_resize_pallas`: per image, the separable resample weights of the
window (sy, ty, sx, tx) -- `augment._resize_weight_mat`'s formula -- applied
as two fp32 products, out = wy . img . wx^T. On CUDA tensors it launches the
hand-written kernel of csrc/crop_resize.cu: one launch, the weights
regenerated in each block over their band (`crop_bands`) and the products
summed over it in fp32 FMAs, no weight matrix or intermediate in device
memory, no TF32. On CPU tensors it runs `crop_resize_plain`, which is
`augment.resized_crop` (the weight matrices and two fp32 bmm).
`crop_resize_pallas.launches` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from cmx_torch.ops import _build
from cmx_torch.ops.augment import resized_crop

_METHODS = {"linear": 0, "triangle": 0, "bilinear": 0, "cubic": 1,
            "bicubic": 1}


def crop_resize_plain(imgs: torch.Tensor, params: torch.Tensor,
                      out_size: int, method: str = "linear") -> torch.Tensor:
    """Plain version of the kernel (also its CPU path)."""
    return resized_crop(imgs, params, out_size, method)


def crop_bands(in_size: int, out_size: int, scale: torch.Tensor,
               translation: torch.Tensor, method: str = "linear"):
    """(lo, hi), each (B, out) int64: the taps [lo, hi] over which the kernel
    sums each output row's weights into the row's total, for per-sample 1-D
    scale+translate ((B,) fp32). [floor(sample - R*kscale) - 1,
    ceil(sample + R*kscale) + 1] clipped to the input, R = 1 linear, 2
    cubic: every non-zero entry of `_resize_weight_mat`'s row lies inside it
    (one tap of margin a side for rounding; the taps outside the support are
    exact zeros). The kernel's products then run from the band's first
    non-zero tap to its last. It skips rows that are zeroed (sample outside
    [-0.5, in-0.5], or a total at or under 1000*eps); this gives their band
    all the same (empty where the sample lies far outside)."""
    inv = 1.0 / scale.float()
    kscale = torch.clamp(inv, min=1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float32,
                              device=scale.device) + 0.5)[None, :]
                * inv[:, None] - translation.float()[:, None] * inv[:, None]
                - 0.5)
    reach = (2.0 if _METHODS[method] else 1.0) * kscale[:, None]
    lo = torch.clamp(torch.floor(sample_f - reach) - 1.0, min=0.0)
    hi = torch.clamp(torch.ceil(sample_f + reach) + 1.0, max=in_size - 1.0)
    return lo.long(), hi.long()


def _crop_resize_cuda(imgs, params, out_size, method):
    b, h, w = imgs.shape
    if params.device != imgs.device:
        raise ValueError(f"params is on {params.device}, expected "
                         f"{imgs.device}")
    lib = _build.load("crop_resize")
    imgs = imgs.float().contiguous()
    params = params.float().contiguous()
    dev = imgs.device
    out = torch.empty((b, out_size, out_size), dtype=torch.float32, device=dev)
    err = lib.cmx_crop_resize(
        imgs.data_ptr(), params.data_ptr(), out.data_ptr(), b, h, w, out_size,
        _METHODS[method], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "crop_resize_pallas")
    crop_resize_pallas.launches += 1
    return out


def crop_resize_pallas(imgs: torch.Tensor, params: torch.Tensor,
                       out_size: int, method: str = "linear") -> torch.Tensor:
    """imgs (B,H,W) (cast to fp32); params (B,4) fp32 rows (sy, ty, sx, tx)
    as `augment._crop_window_params` makes them. Returns (B, out, out) fp32."""
    _build.record("crop_resize_pallas", imgs, params, out_size, method)
    if imgs.dim() != 3 or tuple(params.shape) != (imgs.shape[0], 4):
        raise ValueError(f"expected imgs (B,H,W) and params (B,4), got "
                         f"{tuple(imgs.shape)} and {tuple(params.shape)}")
    if method not in _METHODS:
        raise ValueError(f"unsupported resize method {method!r}")
    if imgs.device.type == "cpu":
        return crop_resize_plain(imgs, params, out_size, method)
    return _crop_resize_cuda(imgs, params, out_size, method)


crop_resize_pallas.launches = 0
