"""SparK loss tail and the BN-ReLU-mask epilogue (port of cmx/ops/pallas_ops.py).

K3 `spark_loss_pallas`: per 16x16 patch, the mean and one-pass population
variance E[x^2]-mean^2 (unclamped) + 1e-6, the normalized target, the mean
of (rec - norm)^2, times (1 - active); then sum / (sum(1 - active) + 1e-8).
The per-patch map is a Triton kernel on the card and its plain PyTorch
version on the CPU. `SparkLoss` adds cmx's closed-form backward, in plain
torch as in cmx.

K5 `bn_relu_mask_pallas`: max(x*scale+bias, 0)*mask over NHWC x with the
folded BN scale and bias, computed in fp32 and stored in x's type. A Triton
kernel on the card, `bn_relu_mask_plain` on the CPU. cmx calls it from no
path (only its test); chip_smoke.py drives it on the operands of the SparK
step's first pre-norm K7 call.
"""

from __future__ import annotations

import os

import torch

from cmx_torch.ops import _build

_kernel = None
_bn_kernel = None


def _triton_kernel():
    """The Triton kernel, defined at first launch (no triton on the CPU).

    Replaces cmx/ops/pallas_ops.py::spark_loss_pallas (_spark_loss_kernel).
    The TPU kernel summed patches with matmuls against a block-indicator
    matrix (Mosaic cannot split lanes); here one program loads one row of
    patches as a (patches, 256) block and reduces along its second axis.
    Bound on the card: bytes (reads rec and imgs once, 8 bytes a pixel, a
    few flops each)."""
    global _kernel
    if _kernel is None:
        os.environ.setdefault("TRITON_CACHE_DIR",
                              str(_build.BUILD_DIR / "triton"))
        import triton
        import triton.language as tl

        @triton.jit
        def spark_loss_kernel(img_ptr, rec_ptr, act_ptr, out_ptr, H, W, FH, FW,
                              P: tl.constexpr, BLOCK_F: tl.constexpr):
            pid = tl.program_id(0)  # one row of patches of one image
            b = pid // FH
            row = pid % FH
            j = tl.arange(0, BLOCK_F)
            k = tl.arange(0, P * P)
            yy = row * P + k[None, :] // P
            xx = j[:, None] * P + k[None, :] % P
            ok = j[:, None] < FW
            offs = b * H * W + yy * W + xx
            x = tl.load(img_ptr + offs, mask=ok, other=0.0).to(tl.float32)
            r = tl.load(rec_ptr + offs, mask=ok, other=0.0).to(tl.float32)
            inv_n = 1.0 / (P * P)
            mean = tl.sum(x, axis=1) * inv_n
            var = tl.sum(x * x, axis=1) * inv_n - mean * mean
            inv_std = tl.rsqrt(var + 1e-6)
            d = r - (x - mean[:, None]) * inv_std[:, None]
            l2 = tl.sum(d * d, axis=1) * inv_n
            cell = b * FH * FW + row * FW + j
            act = tl.load(act_ptr + cell, mask=j < FW, other=1.0)
            tl.store(out_ptr + cell, l2 * (1.0 - act.to(tl.float32)),
                     mask=j < FW)

        _kernel = (triton, spark_loss_kernel)
    return _kernel


def masked_l2_plain(rec, imgs, active_grid, patch: int = 16):
    """Plain version of the kernel: the (B, f, f) map of masked per-patch L2."""
    b, h, w = imgs.shape
    fh, fw = h // patch, w // patch
    img4 = imgs.float().reshape(b, fh, patch, fw, patch)
    rec4 = rec.float().reshape(b, fh, patch, fw, patch)
    inv_n = 1.0 / float(patch * patch)
    mean = img4.sum((2, 4), keepdim=True) * inv_n
    var = (img4 * img4).sum((2, 4), keepdim=True) * inv_n - mean * mean
    norm = (img4 - mean) * torch.rsqrt(var + 1e-6)
    l2 = ((rec4 - norm) ** 2).sum((2, 4)) * inv_n
    return l2 * (1.0 - active_grid.float())


def _masked_l2_triton(rec, imgs, active_grid, patch):
    b, h, w = imgs.shape
    if h % patch or w % patch:
        raise ValueError(f"image {h}x{w} is not a multiple of patch {patch}")
    if patch & (patch - 1):
        raise ValueError(f"the Triton kernel needs a power-of-two patch, "
                         f"got {patch}")
    for name, t in (("rec", rec), ("active_grid", active_grid)):
        if t.device != imgs.device:
            raise ValueError(f"{name} is on {t.device}, expected {imgs.device}")
    triton, kernel = _triton_kernel()
    fh, fw = h // patch, w // patch
    imgs = imgs.float().contiguous()
    rec = rec.float().contiguous()
    act = active_grid.float().contiguous()
    out = torch.empty((b, fh, fw), dtype=torch.float32, device=imgs.device)
    kernel[(b * fh,)](imgs, rec, act, out, h, w, fh, fw, P=patch,
                      BLOCK_F=triton.next_power_of_2(fw), num_warps=8)
    spark_loss_pallas.launches += 1
    return out


def spark_loss_pallas_plain(rec, imgs, active_grid, patch: int = 16):
    """Plain version of spark_loss_pallas (also its CPU path)."""
    masked_l2 = masked_l2_plain(rec, imgs, active_grid, patch)
    return masked_l2.sum() / ((1.0 - active_grid.float()).sum() + 1e-8)


def spark_loss_pallas(rec: torch.Tensor, imgs: torch.Tensor,
                      active_grid: torch.Tensor, patch: int = 16) -> torch.Tensor:
    """Fused SparK reconstruction loss: rec, imgs (B,H,W); active (B,f,f)
    with 1 = visible. Population variance, as cmx (see cmx's note).
    `spark_loss_pallas.launches` counts the Triton kernel's launches."""
    _build.record("spark_loss_pallas", rec, imgs, active_grid, patch)
    if imgs.device.type == "cpu":
        return spark_loss_pallas_plain(rec, imgs, active_grid, patch)
    masked_l2 = _masked_l2_triton(rec, imgs, active_grid, patch)
    return masked_l2.sum() / ((1.0 - active_grid.float()).sum() + 1e-8)


spark_loss_pallas.launches = 0


def _bn_triton_kernel():
    """The K5 Triton kernel, defined at first launch.

    Replaces cmx/ops/pallas_ops.py::bn_relu_mask_pallas
    (_bn_act_mask_kernel), which took one image a grid step. Bound on the
    card: bytes (reads x and the mask once and writes the output once;
    three flops an element). One program takes a (pixels x channels) block
    of the (B*H*W, C) view: channels contiguous, so the loads and stores of a
    row are one coalesced run; scale and bias are loaded once a program and
    broadcast along the pixels, the mask once a pixel and broadcast along
    the channels."""
    global _bn_kernel
    if _bn_kernel is None:
        os.environ.setdefault("TRITON_CACHE_DIR",
                              str(_build.BUILD_DIR / "triton"))
        import triton
        import triton.language as tl

        @triton.jit
        def bn_relu_mask_kernel(x_ptr, scale_ptr, bias_ptr, mask_ptr, out_ptr,
                                P, C, BLOCK_P: tl.constexpr,
                                BLOCK_C: tl.constexpr):
            rows = tl.program_id(0) * BLOCK_P + tl.arange(0, BLOCK_P)
            cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
            ok_r = rows < P
            ok_c = cols < C
            ok = ok_r[:, None] & ok_c[None, :]
            offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
            x = tl.load(x_ptr + offs, mask=ok, other=0.0).to(tl.float32)
            s = tl.load(scale_ptr + cols, mask=ok_c, other=0.0)
            b = tl.load(bias_ptr + cols, mask=ok_c, other=0.0)
            m = tl.load(mask_ptr + rows, mask=ok_r, other=0.0).to(tl.float32)
            y = tl.maximum(x * s[None, :] + b[None, :], 0.0) * m[:, None]
            tl.store(out_ptr + offs, y.to(out_ptr.dtype.element_ty), mask=ok)

        _bn_kernel = (triton, bn_relu_mask_kernel)
    return _bn_kernel


def bn_relu_mask_plain(x, scale, bias, mask):
    """Plain version of K5 (also its CPU path)."""
    y = torch.relu(x.float() * scale.float() + bias.float())
    return (y * mask.float()).to(x.dtype)


def _bn_relu_mask_triton(x, scale, bias, mask):
    b, h, w, c = x.shape
    if tuple(scale.shape) != (c,) or tuple(bias.shape) != (c,) \
            or tuple(mask.shape) != (b, h, w, 1):
        raise ValueError(f"expected scale, bias ({c},) and mask "
                         f"{(b, h, w, 1)}, got {tuple(scale.shape)}, "
                         f"{tuple(bias.shape)}, {tuple(mask.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the Triton kernel takes fp32 or bf16 x, got {x.dtype}")
    for name, t in (("scale", scale), ("bias", bias), ("mask", mask)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, expected {x.device}")
    triton, kernel = _bn_triton_kernel()
    x = x.contiguous()
    out = torch.empty_like(x)
    P = b * h * w
    block_c = min(triton.next_power_of_2(c), 128)
    block_p = max(1, 4096 // block_c)
    grid = (triton.cdiv(P, block_p), triton.cdiv(c, block_c))
    kernel[grid](x, scale.float().contiguous(), bias.float().contiguous(),
                 mask.contiguous(), out, P, c, BLOCK_P=block_p,
                 BLOCK_C=block_c, num_warps=4)
    bn_relu_mask_pallas.launches += 1
    return out


def bn_relu_mask_pallas(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x (B,H,W,C) fp32 or bf16, folded BN scale and bias (C,), mask
    (B,H,W,1) -> max(x*scale+bias, 0)*mask in x's type.
    `bn_relu_mask_pallas.launches` counts the Triton kernel's launches."""
    _build.record("bn_relu_mask_pallas", x, scale, bias, mask)
    if x.device.type == "cpu":
        return bn_relu_mask_plain(x, scale, bias, mask)
    return _bn_relu_mask_triton(x, scale, bias, mask)


bn_relu_mask_pallas.launches = 0


class SparkLoss(torch.autograd.Function):
    """Kernel forward + cmx's closed-form backward
        dL/drec = 2 (rec - norm(img)) * masked / (p^2 * sum(masked)).
    imgs and the active grid are data (no gradient)."""

    @staticmethod
    def forward(ctx, rec, imgs, active_grid, patch):
        ctx.save_for_backward(rec, imgs, active_grid)
        ctx.patch = patch
        return spark_loss_pallas(rec, imgs, active_grid, patch)

    @staticmethod
    def backward(ctx, g):
        rec, imgs, active_grid = ctx.saved_tensors
        p = ctx.patch
        b, h, w = imgs.shape
        fh, fw = h // p, w // p
        img4 = imgs.float().reshape(b, fh, p, fw, p)
        mean = img4.mean((2, 4), keepdim=True)
        var = (img4 * img4).mean((2, 4), keepdim=True) - mean * mean
        norm = (img4 - mean) * torch.rsqrt(var + 1e-6)
        rec4 = rec.float().reshape(b, fh, p, fw, p)
        masked = (1.0 - active_grid.float()).reshape(b, fh, 1, fw, 1)
        denom = (1.0 - active_grid.float()).sum() + 1e-8
        drec = 2.0 * (rec4 - norm) * masked / (p * p * denom)
        return (g * drec).reshape(b, h, w).to(rec.dtype), None, None, None


def spark_loss_pallas_trainable(rec, imgs, active_grid, patch: int = 16):
    return SparkLoss.apply(rec, imgs, active_grid, patch)
