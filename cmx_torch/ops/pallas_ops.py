"""SparK loss tail and the BN-ReLU-mask epilogue (port of cmx/ops/pallas_ops.py).

K3 `spark_loss_pallas`: per 16x16 patch, the mean and one-pass population
variance E[x^2]-mean^2 (unclamped) + 1e-6, the normalized target, the mean
of (rec - norm)^2, times (1 - active); then sum / (sum(1 - active) + 1e-8).
On CUDA tensors it is one launch of the forward kernel of
csrc/spark_loss.cu, which also finishes the sum and the divide (the last
block to finish sums every block's partials in a fixed order) and writes
the numerator and the denominator beside the loss; rec is read in its own
dtype. `SparkLoss` adds cmx's closed-form backward
    dL/drec = g * 2 (rec - norm(img)) * masked / (p^2 * denom),
one launch of the backward kernel (`spark_loss_bwd`). Under data parallel
`SparkLoss` sums numerator and denominator over the ranks (one all-reduce of
the two) and divides, as cmx's loss over the global batch, and the backward
reads the global denominator; without a process group the kernel's own loss
stands. On CPU tensors both run their plain versions,
`spark_loss_terms_plain` (with `spark_loss_pallas_plain`, their quotient)
and `spark_loss_bwd_plain` (cmx's arithmetic in eager torch).
`spark_loss_pallas.launches` and `spark_loss_bwd.launches` count the two
kernels' launches.

K5 `bn_relu_mask_pallas`: max(x*scale+bias, 0)*mask over NHWC x with the
folded BN scale and bias, computed in fp32 and stored in x's type. A Triton
kernel on the card, `bn_relu_mask_plain` on the CPU. cmx calls it from no
path (only its test); chip_smoke.py drives it on the operands of the SparK
step's first pre-norm K7 call.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from cmx_torch.ops import _build
from cmx_torch.parallel import mesh

PATCH = 16  # the patch the K3 kernels take (DOWNSAMPLE_RATIO)
_LOSS_DTYPES = (torch.float32, torch.bfloat16)
# device -> (ticket, partials): the forward kernel's scratch. The last block
# re-arms the ticket to 0, so it is zeroed once, when it is made.
_loss_scratch: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
_bn_kernel = None


def masked_l2_plain(rec, imgs, active_grid, patch: int = 16):
    """The (B, f, f) map of masked per-patch L2 (the TPU kernel's output)."""
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


def spark_loss_terms_plain(rec, imgs, active_grid, patch: int = 16):
    """Plain version of the forward kernel's numerator sum(masked l2) and
    denominator sum(1 - active) + 1e-8 (also its CPU path)."""
    masked_l2 = masked_l2_plain(rec, imgs, active_grid, patch)
    return masked_l2.sum(), (1.0 - active_grid.float()).sum() + 1e-8


def spark_loss_pallas_plain(rec, imgs, active_grid, patch: int = 16):
    """Plain version of the forward kernel's loss (also its CPU path)."""
    num, denom = spark_loss_terms_plain(rec, imgs, active_grid, patch)
    return num / denom


def spark_loss_bwd_plain(rec, imgs, active_grid, g, patch: int = 16,
                         denom=None):
    """Plain version of the backward kernel (also its CPU path): cmx's
    closed-form gradient, the patch statistics recomputed from imgs, and
    the denominator too unless `denom` gives it (under data parallel, the
    global one)."""
    p = patch
    b, h, w = imgs.shape
    fh, fw = h // p, w // p
    img4 = imgs.float().reshape(b, fh, p, fw, p)
    mean = img4.mean((2, 4), keepdim=True)
    var = (img4 * img4).mean((2, 4), keepdim=True) - mean * mean
    norm = (img4 - mean) * torch.rsqrt(var + 1e-6)
    rec4 = rec.float().reshape(b, fh, p, fw, p)
    masked = (1.0 - active_grid.float()).reshape(b, fh, 1, fw, 1)
    if denom is None:
        denom = (1.0 - active_grid.float()).sum() + 1e-8
    drec = 2.0 * (rec4 - norm) * masked / (p * p * denom)
    return (g * drec).reshape(b, h, w).to(rec.dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and 16-byte aligned (the kernels' vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _loss_operands(rec, imgs, active_grid, patch):
    """(rec, imgs, active, bf16 flags) as the K3 kernels take them: rec and
    the active grid in their own dtype where it is fp32 or bf16, imgs fp32;
    raises on what they do not take."""
    if imgs.dim() != 3:
        raise ValueError(f"expected imgs (B,H,W), got {tuple(imgs.shape)}")
    b, h, w = imgs.shape
    if patch != PATCH or h % patch or w % patch or b == 0:
        raise ValueError(f"the K3 kernels take patch {PATCH} and H, W "
                         f"multiples of it, B > 0; got patch {patch}, "
                         f"{tuple(imgs.shape)}")
    if tuple(rec.shape) != (b, h, w) or \
            tuple(active_grid.shape) != (b, h // patch, w // patch):
        raise ValueError(f"expected rec {(b, h, w)} and active_grid "
                         f"{(b, h // patch, w // patch)}, got "
                         f"{tuple(rec.shape)}, {tuple(active_grid.shape)}")
    for name, t in (("rec", rec), ("active_grid", active_grid)):
        if t.device != imgs.device:
            raise ValueError(f"{name} is on {t.device}, expected {imgs.device}")
    rec = _aligned(rec if rec.dtype in _LOSS_DTYPES else rec.float())
    act = _aligned(active_grid if active_grid.dtype in _LOSS_DTYPES
                   else active_grid.float())
    return (rec, _aligned(imgs.float()), act, int(rec.dtype == torch.bfloat16),
            int(act.dtype == torch.bfloat16))


def _scratch(dev: torch.device, blocks: int):
    ws = _loss_scratch.get(dev)
    if ws is None or ws[1].numel() < 2 * blocks:
        ws = (torch.zeros(1, dtype=torch.int32, device=dev),
              torch.empty(2 * blocks, dtype=torch.float32, device=dev))
        _loss_scratch[dev] = ws
    return ws


def _spark_loss_cuda(rec, imgs, active_grid, patch):
    """(loss, num, denom), 0-d fp32, from one launch of the forward
    kernel."""
    rec, imgs, act, rec_bf16, act_bf16 = _loss_operands(rec, imgs,
                                                         active_grid, patch)
    b, h, w = imgs.shape
    dev = imgs.device
    lib = _build.load("spark_loss")
    ticket, partials = _scratch(dev, b * (h // patch))
    out = torch.empty(3, dtype=torch.float32, device=dev)
    loss, num, denom = out[0], out[1], out[2]
    err = lib.cmx_spark_loss_fwd(
        rec.data_ptr(), imgs.data_ptr(), act.data_ptr(), loss.data_ptr(),
        num.data_ptr(), denom.data_ptr(), partials.data_ptr(),
        ticket.data_ptr(), b, h, w, rec_bf16, act_bf16,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "spark_loss_pallas")
    spark_loss_pallas.launches += 1
    return loss, num, denom


def _spark_loss(rec, imgs, active_grid, patch):
    """(loss, its numerator, its denominator: the one the backward
    reads), 0-d fp32."""
    _build.record("spark_loss_pallas", rec, imgs, active_grid, patch)
    if imgs.device.type == "cpu":
        num, denom = spark_loss_terms_plain(rec, imgs, active_grid, patch)
        return num / denom, num, denom
    return _spark_loss_cuda(rec, imgs, active_grid, patch)


def spark_loss_pallas(rec: torch.Tensor, imgs: torch.Tensor,
                      active_grid: torch.Tensor, patch: int = 16) -> torch.Tensor:
    """Fused SparK reconstruction loss: rec (B,H,W) fp32 or bf16, imgs
    (B,H,W), active (B,f,f) with 1 = visible -> 0-d fp32. Population
    variance, as cmx (see cmx's note)."""
    return _spark_loss(rec, imgs, active_grid, patch)[0]


spark_loss_pallas.launches = 0


def _spark_loss_bwd_cuda(rec, imgs, active_grid, g, denom, patch):
    rec_t, imgs, act, rec_bf16, act_bf16 = _loss_operands(rec, imgs,
                                                           active_grid, patch)
    for name, t in (("g", g), ("denom", denom)):
        if t.device != imgs.device or t.numel() != 1:
            raise ValueError(f"{name} must be one value on {imgs.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    g = g.float().contiguous()
    denom = denom.float().contiguous()
    b, h, w = imgs.shape
    dev = imgs.device
    lib = _build.load("spark_loss")
    drec = torch.empty_like(rec_t)
    err = lib.cmx_spark_loss_bwd(
        rec_t.data_ptr(), imgs.data_ptr(), act.data_ptr(), g.data_ptr(),
        denom.data_ptr(), drec.data_ptr(), b, h, w, rec_bf16, act_bf16,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "spark_loss_bwd")
    spark_loss_bwd.launches += 1
    return drec.to(rec.dtype)


def spark_loss_bwd(rec: torch.Tensor, imgs: torch.Tensor,
                   active_grid: torch.Tensor, g: torch.Tensor,
                   denom: Optional[torch.Tensor] = None,
                   patch: int = 16) -> torch.Tensor:
    """dL/drec of spark_loss_pallas for the cotangent g (0-d), in rec's
    dtype. On the card `denom` is the forward kernel's denominator
    sum(1 - active) + 1e-8 (read on the device, no host synchronisation);
    the plain version recomputes it unless it is given."""
    _build.record("spark_loss_bwd", rec, imgs, active_grid, g, denom, patch)
    if imgs.device.type == "cpu":
        return spark_loss_bwd_plain(rec, imgs, active_grid, g, patch, denom)
    if denom is None:
        raise ValueError("spark_loss_bwd on the card needs the forward "
                         "kernel's denominator")
    return _spark_loss_bwd_cuda(rec, imgs, active_grid, g, denom, patch)


spark_loss_bwd.launches = 0


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
    """The forward kernel and cmx's closed-form backward (the backward
    kernel on the card). imgs and the active grid are data (no gradient).
    Under data parallel the loss is the global batch's (the ranks'
    numerators over their denominators, both summed; each rank's
    denominator carries the 1e-8, which no count >= 1 in fp32 keeps), the
    same on every rank, and the backward gives the rank's own part of its
    gradient."""

    @staticmethod
    def forward(ctx, rec, imgs, active_grid, patch):
        loss, num, denom = _spark_loss(rec, imgs, active_grid, patch)
        if mesh.active():
            num, denom = mesh.all_reduce_sum_many(num, denom)
            loss = num / denom
        ctx.save_for_backward(rec, imgs, active_grid, denom)
        ctx.patch = patch
        return loss

    @staticmethod
    def backward(ctx, g):
        rec, imgs, active_grid, denom = ctx.saved_tensors
        return (spark_loss_bwd(rec, imgs, active_grid, g, denom, ctx.patch),
                None, None, None)


def spark_loss_pallas_trainable(rec, imgs, active_grid, patch: int = 16):
    return SparkLoss.apply(rec, imgs, active_grid, patch)
