"""Channel-major flat-layout fused DoubleConv (port of cmx/ops/fused_conv_flat.py).

Operands are (B, C, H*W) — NCHW-contiguous — as in cmx. Two kernels, each a
hand-written CUDA kernel for Hopper beside a plain PyTorch version of the
same function:

  * flat_conv3x3_mask_stats (K1, csrc/flat_conv_fwd.cu): optional pre-norm
    prologue relu(src*inv+shift)*m, 3x3 SAME conv + bias, re-mask, bf16
    store, per-channel sum / sum of squares of the fp32 result;
  * flat_bwd_mega (K2, csrc/flat_conv_bwd.cu): the masked-BN input gradient
    dy, dX = conv of dy with the flipped, channel-transposed weights, and dW.
Their conv, dX and dW run on the tensor cores, in the channel-major
instances of K7/K8's implicit GEMMs (csrc/conv3x3_mma.cuh): the same tiles,
weight packing and split-K grid (fused_conv._MMA_*), so the kernels take
H % 8 == 0 (the 8-row tile) and W % 8 == 0 (whole 16-byte words a row).

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. `<wrapper>.launches` counts the
kernel's launches: the function that launches it adds one right after.

FlatDoubleConv is the differentiable DoubleConv core: the forward of
cmx's _flat_fwd_impl and the backward of its _flat_bwd (conv biases get
exact-zero gradients: batch norm absorbs them). Under data parallel its
batch sums are global, as in cmx's global-view program: K1's sums and the
active count are all-reduced before the fold, and each stage's (dgamma,
dbeta) sums before K2 reads them; the gamma/beta gradients it returns stay
the rank's own sums, which the step's gradient all-reduce adds up (returning
the global sums would count them W times).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from cmx_torch.ops import _build
from cmx_torch.ops.fused_conv import (_EPS, _aligned16, _bwd_vecs, _cdt,
                                        _check_cuda_operands, _conv_part_rows,
                                        _dw_grid, _fold, _mma_lib,
                                        _pack_conv_weights, _ptr, _stats,
                                        _stream)
from cmx_torch.parallel import mesh
from cmx_torch.utils.profiling import span

# What the flat kernels take: H % 8 == 0 (the conv's 8-row output tile, two
# 4-row dW tiles) and W % 8 == 0 (a channel's image row is whole 16-byte
# words, the unit the kernels stage and store).
_FLAT_HW_MULT = (8, 8)


# ---------------------------------------------------------------------------
# K1: conv3x3 + bias + mask + inline stats
# ---------------------------------------------------------------------------


def flat_conv3x3_mask_stats_plain(src, m, w, b, H, W, inv=None, shift=None):
    """Plain version of K1 (also the CPU path). Same contract as the kernel."""
    B, Cin, HW = src.shape
    C = w.shape[3]
    x = src.reshape(B, Cin, H, W)
    mf = m.reshape(B, 1, H, W).float()
    if inv is not None:
        x = (torch.relu(x.float() * inv[:, None, None] + shift[:, None, None])
             * mf).to(src.dtype)
    wk = w.to(src.dtype).permute(3, 2, 0, 1)  # (C, Cin, 3, 3)
    acc = F.conv2d(x.float(), wk.float(), padding=1)  # fp32 accumulation
    acc = (acc + b.float()[:, None, None]) * mf
    y = acc.to(src.dtype).reshape(B, C, HW)
    return y, acc.sum((0, 2, 3)), (acc * acc).sum((0, 2, 3))


def _flat_conv_cuda(src, m, w, b, H, W, inv, shift):
    B, Cin, HW = src.shape
    C = w.shape[3]
    if HW != H * W or w.shape[:3] != (3, 3, Cin):
        raise ValueError(f"bad shapes src {tuple(src.shape)} w {tuple(w.shape)}")
    _check_cuda_operands(H, W, src.device, dict(src=src),
                         dict(m=m, w=w, b=b, inv=inv, shift=shift),
                         *_FLAT_HW_MULT)
    lib = _mma_lib("flat_conv_fwd")
    dev = src.device
    src = _aligned16(src.contiguous())
    mask = _aligned16(m.reshape(B, HW).to(torch.bfloat16).contiguous())
    wp = _pack_conv_weights(w.to(torch.bfloat16).reshape(9, Cin, C))
    bias = b.float().contiguous()
    prenorm = inv is not None
    inv_ = inv.float().contiguous() if prenorm else None
    shift_ = shift.float().contiguous() if prenorm else None
    y = torch.empty((B, C, HW), dtype=torch.bfloat16, device=dev)
    part = torch.empty((_conv_part_rows(B, H, W), 2, C), dtype=torch.float32,
                       device=dev)
    err = lib.cmx_flat_conv_fwd(
        _ptr(src), _ptr(mask), _ptr(inv_), _ptr(shift_), _ptr(wp), _ptr(bias),
        _ptr(y), _ptr(part), B, Cin, C, H, W, int(prenorm), _stream(y))
    _build.check(err, "flat_conv3x3_mask_stats")
    flat_conv3x3_mask_stats.launches += 1
    s = part.sum(0)
    return y, s[0], s[1]


def flat_conv3x3_mask_stats(
    src: torch.Tensor, m: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
    H: int, W: int, inv: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """src (B,Cin,H*W) flat; m (B,1,H*W) {0,1}; w (3,3,Cin,C); b (C,).

    Returns (y (B,C,H*W) masked conv out, sum (C,), sumsq (C,)). With
    inv/shift given, src is the previous stage's raw conv output and the
    normalize/ReLU/mask prologue runs while the kernel stages its input."""
    _build.record("flat_conv3x3_mask_stats", src, m, w, b, H, W, inv, shift)
    if src.device.type == "cpu":
        return flat_conv3x3_mask_stats_plain(src, m, w, b, H, W, inv, shift)
    return _flat_conv_cuda(src, m, w, b, H, W, inv, shift)


flat_conv3x3_mask_stats.launches = 0


# ---------------------------------------------------------------------------
# K2: masked-BN dy + dX + dW
# ---------------------------------------------------------------------------


def flat_bwd_mega_plain(g, y, src, m, inv, shift, mean, var, s1, s2, nact, w,
                        H, W, prev_fold=None, need_dx=True):
    """Plain version of K2 (also the CPU path). Same contract as the kernel."""
    B, C, HW = y.shape
    Cin = src.shape[1]
    cdt = _cdt()
    inv, shift, mean, rr, s1n, s2n = (
        v.float()[:, None, None]
        for v in _bwd_vecs(inv, shift, mean, var, s1, s2, nact))
    gf = g.to(cdt).float().reshape(B, C, H, W)
    yf = y.to(cdt).float().reshape(B, C, H, W)
    mf = m.float().reshape(B, 1, H, W)
    gate = (yf * inv + shift) > 0
    dz = gf * mf * gate
    xh = (yf - mean) * rr
    dy = ((mf * inv) * (dz - s1n - xh * s2n)).to(cdt)
    h = src.to(cdt).reshape(B, Cin, H, W)
    if prev_fold is not None:
        pinv, pshift = (v.float()[:, None, None] for v in prev_fold)
        h = (torch.relu(h.float() * pinv + pshift) * mf).to(cdt)
    dh = None
    if need_dx:
        wt = w.to(cdt).flip(0, 1).permute(2, 3, 0, 1)  # (Cin, C, 3, 3)
        dh = F.conv2d(dy.float(), wt.float(), padding=1).to(cdt)
        dh = dh.reshape(B, Cin, HW)
    dw = torch.nn.grad.conv2d_weight(h.float(), (C, Cin, 3, 3), dy.float(),
                                     padding=1)
    return dh, dw.permute(2, 3, 1, 0).contiguous()


def _flat_bwd_cuda(g, y, src, m, inv, shift, mean, var, s1, s2, nact, w, H, W,
                   prev_fold, need_dx):
    B, C, HW = y.shape
    Cin = src.shape[1]
    if HW != H * W or tuple(w.shape) != (3, 3, Cin, C):
        raise ValueError(f"bad shapes y {tuple(y.shape)} w {tuple(w.shape)}")
    if _cdt() != torch.bfloat16:
        raise TypeError(f"the CUDA kernel computes in bf16, not {_cdt()}")
    g, y, src = (_aligned16(t.to(torch.bfloat16).contiguous())
                 for t in (g, y, src))
    pinv, pshift = (None, None) if prev_fold is None else prev_fold
    _check_cuda_operands(
        H, W, y.device, dict(g=g, y=y, src=src),
        dict(m=m, inv=inv, shift=shift, mean=mean, var=var, s1=s1, s2=s2,
             w=w, pinv=pinv, pshift=pshift), *_FLAT_HW_MULT)
    lib = _mma_lib("flat_conv_bwd")
    dev = y.device
    mask = _aligned16(m.reshape(B, HW).to(torch.bfloat16).contiguous())
    vecs = torch.stack([v.float() for v in _bwd_vecs(
        inv, shift, mean, var, s1, s2, nact)]).contiguous()  # (6, C)
    if prev_fold is not None:
        pinv, pshift = pinv.float().contiguous(), pshift.float().contiguous()
    wtp = None
    if need_dx:
        wt = w.flip(0, 1).permute(0, 1, 3, 2).reshape(9, C, Cin)
        wtp = _pack_conv_weights(wt.to(torch.bfloat16))
    dy = torch.empty((B, C, HW), dtype=torch.bfloat16, device=dev)
    dh = (torch.empty((B, Cin, HW), dtype=torch.bfloat16, device=dev)
          if need_dx else None)
    nchunks, per_chunk = _dw_grid("flat_conv_bwd", dev, B, H, W, Cin, C,
                                  prev_fold is not None)
    part = torch.empty((nchunks, 9, Cin, C), dtype=torch.float32, device=dev)
    err = lib.cmx_flat_bwd(
        _ptr(g), _ptr(y), _ptr(src), _ptr(mask), _ptr(vecs), _ptr(pinv),
        _ptr(pshift), _ptr(wtp), _ptr(dy), _ptr(dh), _ptr(part),
        B, Cin, C, H, W, int(prev_fold is not None), int(need_dx), nchunks,
        per_chunk, _stream(y))
    _build.check(err, "flat_bwd_mega")
    flat_bwd_mega.launches += 1
    return dh, part.sum(0).reshape(3, 3, Cin, C)


def flat_bwd_mega(g, y, src, m, inv, shift, mean, var, s1, s2, nact, w, H, W,
                  prev_fold=None, need_dx=True):
    """Flat-layout fused stage backward: (dh (B,Cin,HW) or None, dW (3,3,Cin,C)).

    g, y (B,C,H*W): the stage output's cotangent and raw conv output; src
    (B,Cin,H*W) the stage input (raw previous conv output when prev_fold =
    (inv0, shift0) is given); s1 multiplies nothing and s2 multiplies x-hat
    in dy = m*inv*(dz - s1/nact - xhat*s2/nact) (cmx passes (dbeta, dgamma)).
    need_dx=False skips dX (the first stage of the network needs none)."""
    args = (g, y, src, m, inv, shift, mean, var, s1, s2, nact, w, H, W,
            prev_fold, need_dx)
    _build.record("flat_bwd_mega", *args)
    if y.device.type == "cpu":
        return flat_bwd_mega_plain(*args)
    return _flat_bwd_cuda(*args)


flat_bwd_mega.launches = 0


# ---------------------------------------------------------------------------
# The differentiable flat DoubleConv core
# ---------------------------------------------------------------------------


class FlatDoubleConv(torch.autograd.Function):
    """Masked DoubleConv over flat operands: xf (B,Cin,H*W) pre-masked,
    mflat (B,1,H*W). Returns (out (B,C,H*W), mean0, var0, mean1, var1); the
    statistics are not differentiable (they feed the running averages)."""

    @staticmethod
    def forward(ctx, xf, mflat, w0, b0, g0, be0, w1, b1, g1, be1, H, W):
        with span("norm", xf):
            return FlatDoubleConv._forward(ctx, xf, mflat, w0, b0, g0, be0,
                                           w1, b1, g1, be1, H, W)

    @staticmethod
    def _forward(ctx, xf, mflat, w0, b0, g0, be0, w1, b1, g1, be1, H, W):
        cdt = _cdt()
        in_dtype = xf.dtype
        xf = xf.to(cdt)
        mflat = mflat.to(cdt)
        y0, s0, q0 = flat_conv3x3_mask_stats(xf, mflat, w0, b0, H, W)
        s0, q0, nact = mesh.all_reduce_sum_many(s0, q0, mflat.float().sum())
        nact = torch.clamp(nact, min=1.0)
        mean0, var0 = _stats(s0, q0, nact)
        inv0, shift0 = _fold(g0, be0, mean0, var0)
        y1, s1, q1 = flat_conv3x3_mask_stats(y0, mflat, w1, b1, H, W,
                                             inv0, shift0)
        s1, q1 = mesh.all_reduce_sum_many(s1, q1)
        mean1, var1 = _stats(s1, q1, nact)
        inv1, shift1 = _fold(g1, be1, mean1, var1)
        out = (torch.relu(y1.float() * inv1[:, None] + shift1[:, None])
               * mflat.float()).to(cdt)
        ctx.save_for_backward(xf, mflat, w0, w1, g0, be0, g1, be1, y0, y1,
                              mean0, var0, mean1, var1, nact)
        ctx.hw = (H, W)
        ctx.in_dtype = in_dtype
        ctx.mark_non_differentiable(mean0, var0, mean1, var1)
        ctx.scope = mesh.scope()  # the backward's sums run in this group
        return out, mean0, var0, mean1, var1

    @staticmethod
    def backward(ctx, g_out, *_stat_cts):
        with mesh.in_scope(ctx.scope), span("norm", g_out):
            return FlatDoubleConv._backward(ctx, g_out)

    @staticmethod
    def _backward(ctx, g_out):
        (xf, mflat, w0, w1, g0, be0, g1, be1, y0, y1,
         mean0, var0, mean1, var1, nact) = ctx.saved_tensors
        H, W = ctx.hw
        mf = mflat.float()
        inv0, shift0 = _fold(g0, be0, mean0, var0)
        inv1, shift1 = _fold(g1, be1, mean1, var1)

        def stage_sums(dout, y, mean, var, inv, shift):
            yf = y.float()
            r = torch.rsqrt(var + _EPS)
            gate = (yf * inv[:, None] + shift[:, None]) > 0
            dz = dout.float() * mf * gate
            xh = (yf - mean[:, None]) * r[:, None]
            return (dz * xh).sum((0, 2)), dz.sum((0, 2))

        # K2 reads the global sums; dg/dbe return the rank's own
        dg1, dbe1 = stage_sums(g_out, y1, mean1, var1, inv1, shift1)
        sg1, sbe1 = mesh.all_reduce_sum_many(dg1, dbe1)
        dh0, dw1 = flat_bwd_mega(g_out, y1, y0, mflat, inv1, shift1, mean1,
                                 var1, sbe1, sg1, nact, w1, H, W,
                                 prev_fold=(inv0, shift0))
        dg0, dbe0 = stage_sums(dh0, y0, mean0, var0, inv0, shift0)
        sg0, sbe0 = mesh.all_reduce_sum_many(dg0, dbe0)
        dx, dw0 = flat_bwd_mega(dh0, y0, xf, mflat, inv0, shift0, mean0, var0,
                                sbe0, sg0, nact, w0, H, W, prev_fold=None,
                                need_dx=ctx.needs_input_grad[0])
        if dx is not None:
            dx = dx.to(ctx.in_dtype)
        return (dx, None, dw0.float(), torch.zeros_like(dbe0), dg0, dbe0,
                dw1.float(), torch.zeros_like(dbe1), dg1, dbe1, None, None)


def flat_double_conv(xf, mflat, w0, b0, g0, be0, w1, b1, g1, be1, H, W):
    """(out (B,C,H*W), (mean0, var0, mean1, var1)) — cmx's flat_double_conv."""
    out, *stats = FlatDoubleConv.apply(xf, mflat, w0, b0, g0, be0, w1, b1, g1,
                                       be1, H, W)
    return out, tuple(stats)
