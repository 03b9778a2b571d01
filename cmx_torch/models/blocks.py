"""UNet building blocks (port of cmx/models/blocks.py).

Activations are NCHW in shape; their memory layout follows the device
(`library_layout`). On a card the activations between library convolutions
are channels-last, the layout cuDNN's bf16 tensor-core convolutions read
and write, so cuDNN transposes none of them (it still pads a one- or
two-channel operand through its transpose kernel); the masks, norms, ReLU,
max-pool, concatenation and head keep that layout. The flat fused
DoubleConv (K1/K2) reads and writes channel-major tensors, and the layout
changes once at each of its boundaries: a library convolution converts the
pooled output of a fused block, an UpBlock converts the skip of a fused
block, and torch.cat reads a channels-last upsample into a fused block's
channel-major concatenation. On the CPU every activation stays contiguous
NCHW, as cmx's parity tests hold the port.

Parameters keep cmx's names (a conv's `kernel` and `bias`, a norm's `scale`
and `bias`, running `mean` and `var` buffers) so
cmx_torch.ckpt.checkpoint maps a flax tree mechanically; conv
kernels are stored OIHW (torch's layout) and mapped from flax's HWIO there.
bf16 compute, fp32 parameters and statistics, as in cmx. Training mode
(`module.train()`) is cmx's use_running_average=False. `run_block` is
cmx's `nn.remat` on a named block: its activations are recomputed in the
backward pass instead of stored.
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from cmx_torch.ops import batch_norm as bn_ops
from cmx_torch.ops import fused_conv as fc
from cmx_torch.parallel import mesh
from cmx_torch.utils.profiling import span

# The BatchNorm moment variant (MaskedBatchNorm): "shift_ra" (the default),
# "shift_max", "two_pass" or "naive", from the environment as cmx reads it
# (cmx/models/blocks.py:36).
BN_VARIANT = os.environ.get("CMX_BN_VARIANT", "shift_ra")


def _lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's default kernel init: truncated normal (+-2 std), variance
    1/fan_in after truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)


# Library convolution calls by the layout they ran in (Conv, ConvTranspose),
# counted at the call as the kernel wrappers count theirs; read through
# cmx_torch.train.graph.launch_counts.
LIBRARY_CONV_CALLS = {"library_conv_channels_last": 0,
                      "library_conv_channels_first": 0}


# 4-D batch norms (MaskedBatchNorm) by the path they ran, counted at the call
# as LIBRARY_CONV_CALLS are: the norm kernels over channels-last rows or
# channel-major planes (cmx_torch/ops/batch_norm.py), or the plain PyTorch
# composition (the CPU, fp64); read through launch_counts.
NORM_CALLS = {"norm_kernel_channels_last": 0,
              "norm_kernel_channels_first": 0, "norm_plain": 0}


def norm_route(x: torch.Tensor, mask: Optional[torch.Tensor] = None
               ) -> Optional[str]:
    """The layout in which the norm kernels take x, or None where
    MaskedBatchNorm runs its plain composition: a CPU tensor, and on the
    card what `kernel_route` leaves plain."""
    return kernel_route(x, mask) if x.is_cuda else None


def kernel_route(x: torch.Tensor, mask: Optional[torch.Tensor] = None
                 ) -> Optional[str]:
    """"channels_last" or "channels_first": the layout in which the norm
    kernels take a 4-D bf16 or fp32 x, its own where it is one of the two
    (ops/batch_norm.py::layout_of), else channels-last (MaskedBatchNorm
    converts it). None for fp64 or not 4-D, which keep the plain
    composition. Raises on any other dtype and on a mask of another shape
    than (B,1,H,W) or (B,H,W): no other norm falls back to the plain
    composition on the card."""
    if x.dim() != 4 or x.dtype == torch.float64:
        return None
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the norm kernels take bf16, fp32 or (plain) fp64, "
                        f"got {x.dtype}")
    if mask is not None:
        b, _, h, w = x.shape
        if tuple(mask.shape) not in ((b, 1, h, w), (b, h, w)):
            raise ValueError(f"expected a mask (B,1,H,W) or (B,H,W) for x "
                             f"{tuple(x.shape)}, got {tuple(mask.shape)}")
    return bn_ops.layout_of(x) or "channels_last"


def library_layout(x: torch.Tensor) -> torch.memory_format:
    """The memory format of the activations around the library
    convolutions: channels-last on a card, where cuDNN runs its bf16
    tensor-core convolutions in NHWC and would otherwise transpose every
    operand in and every result out; contiguous NCHW on the CPU."""
    return torch.channels_last if x.is_cuda else torch.contiguous_format


class _Relayout(torch.autograd.Function):
    """`t` cast to `dtype` in `memory_format`, in one copy; its gradient
    comes back in t's own dtype and layout (autograd's own cast would keep
    it in the new layout). A conv kernel's gradient so comes back
    contiguous, as the all-reduce, the norm, the clip and the optimizer
    take it; an activation's, in the layout of the code that made it, whose
    backward would otherwise mix two layouts."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, dtype: torch.dtype,
                memory_format: torch.memory_format):
        ctx.dtype = t.dtype
        ctx.layout = (torch.contiguous_format if t.is_contiguous()
                      else torch.channels_last)
        return t.to(dtype, memory_format=memory_format)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad.to(ctx.dtype, memory_format=ctx.layout), None, None


def _in_layout(t: torch.Tensor, dtype: torch.dtype,
               memory_format: torch.memory_format) -> torch.Tensor:
    """t cast to `dtype` and, where it is not already, converted to
    `memory_format` (a 1-channel NCHW tensor already is channels-last)."""
    if t.is_contiguous(memory_format=memory_format):
        return t.to(dtype)
    return _Relayout.apply(t, dtype, memory_format)


def _conv_operands(x: torch.Tensor, kernel: torch.Tensor,
                   dtype: torch.dtype) -> tuple:
    """x and the kernel of a library convolution, cast to `dtype` in the
    layout `library_layout` gives. The kernel is converted always, which
    makes cuDNN take its NHWC path even for a 1-channel input, whose layout
    is ambiguous; a channel-major x (the pooled output of a flat fused
    block) is converted here, once each way."""
    if library_layout(x) == torch.channels_last:
        LIBRARY_CONV_CALLS["library_conv_channels_last"] += 1
        return (_in_layout(x, dtype, torch.channels_last),
                _Relayout.apply(kernel, dtype, torch.channels_last))
    LIBRARY_CONV_CALLS["library_conv_channels_first"] += 1
    return x.to(dtype), kernel.to(dtype)


class Conv(nn.Module):
    """flax nn.Conv(features, (k, k), padding SAME) with fp32 parameters,
    computed in `dtype` (input, kernel and bias cast, as flax does);
    `bias=False` is flax's use_bias=False (no `bias` parameter)."""

    kernel_layout = "conv"  # flax HWIO <-> torch OIHW (ckpt.checkpoint)

    def __init__(self, cin: int, cout: int, k: int = 3,
                 dtype: torch.dtype = torch.bfloat16, bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        cout, cin, k, _ = self.kernel.shape
        with torch.no_grad():
            _lecun_normal_(self.kernel, cin * k * k, gen)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel.shape[-1]
        bias = None if self.bias is None else self.bias.to(self.dtype)
        x, kernel = _conv_operands(x, self.kernel, self.dtype)
        return F.conv2d(x, kernel, bias, padding=k // 2)


class ConvTranspose(nn.Module):
    """flax nn.ConvTranspose(features, (k, k), strides (2, 2), padding
    SAME) for even k (2: the UNet's up, 4: LightDecoder's); the kernel is
    stored in torch's (Cin, Cout, k, k) layout, the flax kernel spatially
    flipped (see ckpt.checkpoint), and SAME is torch's padding (k - 2) / 2
    on it."""

    kernel_layout = "conv_transpose"

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.bfloat16,
                 k: int = 2):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(cin, cout, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def reset_parameters(self, gen: torch.Generator) -> None:
        cin, _, k, _ = self.kernel.shape
        with torch.no_grad():
            _lecun_normal_(self.kernel, k * k * cin, gen)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel.shape[-1]
        x, kernel = _conv_operands(x, self.kernel, self.dtype)
        return F.conv_transpose2d(x, kernel, self.bias.to(self.dtype),
                                  stride=2, padding=(k - 2) // 2)


class PixelShuffleUpsample2x(ConvTranspose):
    """cmx's ConvTranspose(2x2, stride 2) as a 1x1 product plus
    depth-to-space: out[o, 2i+a, 2j+b] = sum_c x[c, i, j] * kernel[a, b, c,
    o] on the flipped flax kernel, accumulated in fp32, plus the bias, cast
    to `dtype`. The parameters are ConvTranspose's, in its layout, so they
    cross checkpoints as an UpBlock's `up` does. No caller, in cmx or here."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__(cin, cout, dtype, k=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, cin, h, w = x.shape
        cout = self.kernel.shape[1]
        # torch (Cin, O, a, b) -> cmx's (Cin, (a, b, O)) product matrix
        k = self.kernel.to(self.dtype).permute(0, 2, 3, 1).reshape(
            cin, 4 * cout)
        y = torch.einsum("bchw,ck->bhwk", x.to(self.dtype).float(), k.float())
        y = y.reshape(b, h, w, 2, 2, cout).permute(0, 5, 1, 3, 2, 4).reshape(
            b, cout, 2 * h, 2 * w)
        return (y + self.bias[:, None, None]).to(self.dtype)


class Dense(nn.Module):
    """flax nn.Dense(features) with fp32 parameters; the kernel is kept in
    flax's (in, out) layout, so it crosses checkpoints as it is."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            _lecun_normal_(self.kernel, self.kernel.shape[0], gen)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class MaskedBatchNorm(nn.Module):
    """BatchNorm over active positions only, with cmx's batch moments:
    mean and variance over the positions where the mask is 1, per channel,
    in the statistics dtype promote(x.dtype, float32); running stats
    updated as 0.9*old + 0.1*batch with the population variance. With
    mask=None it is plain BatchNorm. Normalizes as one multiply-add in
    `dtype` with (C,)-sized folds computed in fp32.

    The moments follow the module global BN_VARIANT (the environment's
    CMX_BN_VARIANT, read at import as cmx reads it; this module reads the
    global at every call, so it may be set after the model is built):
      * "shift_ra" (the default): one pass of shifted moments,
        var = E[(x-s)^2 m]/n - (E[(x-s) m]/n)^2, s = the running mean
        (a constant: no gradient);
      * "shift_max": the same with s = the per-channel max of the active
        positions of the subsample x[:, :, ::8, ::8] (cmx's NHWC
        x[:, ::8, ::8, :]), 0 where none is active; no gradient;
      * "two_pass": the mean, then E[(x-mean)^2 m]/n, the gradient through
        both;
      * any other value: "naive", s = 0 (cmx's fallback).
    fp64 inputs always run "two_pass" in fp64 (cmx's spatial-parity
    harness). Every variant casts mean and var to fp32 and clamps var at 0.
    The fused DoubleConv takes its moments from its kernels' sums and
    ignores the variant, as cmx's does.

    The sums and counts are over the global batch: under data parallel
    they are all-reduced (SyncBN, as cmx's global-view program computes
    them): one all-reduce for "shift_ra" and "naive", a MAX all-reduce of
    the subsample max before it for "shift_max", two for "two_pass". So the
    running stats, and with them the shift, stay equal on every rank.

    `relu` folds the DoubleConv's epilogue into the norm: the output
    max(y, 0) times the mask (the re-mask). On the card every 4-D bf16 or
    fp32 norm runs through the kernels of cmx_torch/ops/batch_norm.py
    (`norm_route`; x channels-last or channel-major, other strides
    converted to channels-last; another dtype, a mask of another shape or
    a module dtype other than x's raises): the moments weight each
    position by the mask, so the input needs no re-mask, and the backward
    is one analytic pass pair for every variant (one all-reduce of two
    C-vectors under data parallel, where autograd ran one a moment
    all-reduce). The CPU and fp64 run the plain composition, which under
    `relu` multiplies the input by the mask first (the DoubleConv's
    pre-norm re-mask: the same moments and output for a 0/1 mask). Both
    take their moments from `moments`, with the kernel's sums or their
    plain version. Each call is counted in NORM_CALLS."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None,
                 momentum: float = 0.9, epsilon: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.recomputing = False  # set by run_block's recompute context

    def reset_parameters(self, gen: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Running-average update with externally computed batch moments
        (the fused DoubleConv computes them in its kernels); none while a
        checkpointed block is recomputed."""
        if self.recomputing:
            return
        self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
        self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)

    def moments(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                sums=bn_ops.norm_moments_plain) -> tuple:
        """(mean, var, the count they divide by) of the batch in the
        statistics dtype, var before the fp32 cast and the clamp, by the
        variant BN_VARIANT names. `sums(x, mask, s)` gives this process's
        (2 C + 1) sums of d = (x - s) m, of d^2 and of m: the moments kernel
        on the kernel route (no gradient: NormFunction's backward takes the
        moments' gradient), its plain version in the plain composition,
        where the gradient runs through them."""
        c = x.shape[1]
        sd = torch.promote_types(x.dtype, torch.float32)
        variant = "two_pass" if sd == torch.float64 else BN_VARIANT
        if variant == "two_pass":
            first = sums(x, mask, x.new_zeros((c,), dtype=sd))
            first = mesh.all_reduce_sync(torch.cat([first[:c],
                                                    first[2 * c:]]))
            denom = first[c:] if mask is None else torch.clamp(first[c:],
                                                                min=1.0)
            mean = first[:c] / denom
            second = sums(x, mask, mean)
            return mean, mesh.all_reduce_sync(second[c:2 * c]) / denom, denom
        if variant == "shift_ra":
            s = self.mean.clone().to(sd)
        elif variant == "shift_max":
            s = _subsample_max(x, mask)
        else:  # naive
            s = x.new_zeros((c,), dtype=sd)
        # the sums over the global batch (one all-reduce under data
        # parallel, whose backward sums the ranks' cotangents); s is a
        # constant: no gradient
        t = mesh.all_reduce_sync(sums(x, mask, s))
        denom = t[2 * c:] if mask is None else torch.clamp(t[2 * c:],
                                                            min=1.0)
        dm = t[:c] / denom
        return dm + s, t[c:2 * c] / denom - dm * dm, denom

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                relu: bool = False) -> torch.Tensor:
        """x (B,C,H,W); mask (B,1,H,W) or (B,H,W) with 1 = active; `relu`
        the DoubleConv's epilogue (class note). The span `norm` with spans
        on (cmx_torch.utils.profiling)."""
        with span("norm", x) as sp:
            x = sp.inputs(x)
            route = norm_route(x, mask)
            if route is None:
                if x.dim() == 4:
                    NORM_CALLS["norm_plain"] += 1
                return sp.outputs(self._plain(x, mask, relu))
            if self.dtype not in (None, x.dtype):
                raise TypeError(f"the norm kernels normalise in x's dtype "
                                f"{x.dtype}; this norm's is {self.dtype}")
            NORM_CALLS["norm_kernel_" + route] += 1
            x = x.contiguous(memory_format=torch.channels_last
                             if route == "channels_last"
                             else torch.contiguous_format)
            if self.training:
                with torch.no_grad():
                    mean, var, denom = self.moments(x, mask,
                                                    bn_ops.norm_moments)
                live = var >= 0
                var = torch.clamp(var, min=0.0)
                self.update_running(mean, var)
            else:
                mean, var, denom, live = self.mean, self.var, None, None
            return sp.outputs(bn_ops.NormFunction.apply(
                x, self.scale, self.bias, mask, mean, var, live, denom,
                self.epsilon, relu))

    def _plain(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                relu: bool) -> torch.Tensor:
        """The plain composition: [x * mask], the norm, [ReLU, * mask]."""
        remask = relu and mask is not None
        if remask:
            x = x * mask.to(x.dtype)
        if not self.training:
            mean, var = self.mean, self.var
        else:
            mean, var, _ = self.moments(x, mask)
            mean = mean.float()
            var = torch.clamp(var, min=0.0).float()
            self.update_running(mean.detach(), var.detach())
        out_dtype = self.dtype or x.dtype
        inv = torch.rsqrt(var + self.epsilon) * self.scale
        shift = self.bias - mean * inv
        y = (x.to(out_dtype) * inv.to(out_dtype)[:, None, None]
             + shift.to(out_dtype)[:, None, None])
        if relu:
            y = torch.relu(y)
        if remask:
            y = y * mask.to(y.dtype)
        return y


@torch.no_grad()
def _subsample_max(x: torch.Tensor, mask: Optional[torch.Tensor]):
    """shift_max's shift: the per-channel max of x[:, :, ::8, ::8] over its
    active positions (masked ones filled with -3e38, as cmx), in the
    statistics dtype, over the global batch (a MAX all-reduce under data
    parallel); 0 where no subsampled position is active."""
    xs = x[:, :, ::8, ::8].to(torch.promote_types(x.dtype, torch.float32))
    if mask is not None:
        m = mask if mask.dim() == 4 else mask[:, None]
        ms = m[:, :, ::8, ::8].to(xs.dtype)
        xs = torch.where(ms > 0, xs * ms, xs.new_full((), -3e38))
    s = mesh.all_reduce_max(xs.amax((0, 2, 3)))
    return torch.where(s < -1e37, torch.zeros_like(s), s)


class DoubleConv(nn.Module):
    """Two (Conv3x3 -> re-mask -> masked BN -> ReLU -> re-mask) stages; the
    re-masks and the ReLU are the norm's epilogue (MaskedBatchNorm's
    `relu`).

    In training mode with `fused`, bf16 and a stage shape inside the gates of
    cmx (H >= FUSED_MIN_HW, H % STRIP == 0, W % 8 == 0, Cin <= FUSED_MAX_CIN;
    cmx/models/blocks.py:233-241) the stage runs through the fused kernels,
    with naive moments as in cmx, in the impl that
    cmx_torch.ops.fused_conv.FUSED_IMPL names at forward time: "flat" through
    FlatDoubleConv (channel-major: a channels-last input is converted, and
    the output is channel-major), "nhwc" through FusedDoubleConv
    (channels-last: a channels-last input is a free view, and its output is
    returned as a channels_last NCHW view). The parameter tree is the same
    either way."""

    def __init__(self, cin: int, features: int,
                 dtype: torch.dtype = torch.bfloat16, fused: bool = False):
        super().__init__()
        self.dtype = dtype
        self.fused = fused
        self.conv0 = Conv(cin, features, 3, dtype)
        self.bn0 = MaskedBatchNorm(features, dtype)
        self.conv1 = Conv(features, features, 3, dtype)
        self.bn1 = MaskedBatchNorm(features, dtype)

    def use_fused(self, x: torch.Tensor) -> bool:
        _, cin, h, w = x.shape
        return (self.fused and self.training and self.dtype == torch.bfloat16
                and h >= fc.FUSED_MIN_HW and h % fc.STRIP == 0 and w % 8 == 0
                and cin <= fc.FUSED_MAX_CIN)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B,Cin,H,W); mask (B,1,H,W) or None."""
        if self.use_fused(x):
            impl = fc.FUSED_IMPL
            B, cin, H, W = x.shape
            if mask is None:
                m = torch.ones((B, H, W), dtype=torch.bfloat16, device=x.device)
            else:
                m = mask[:, 0] if mask.dim() == 4 else mask
            params = []
            for conv, bn in ((self.conv0, self.bn0), (self.conv1, self.bn1)):
                params += [conv.kernel.permute(2, 3, 1, 0), conv.bias,
                           bn.scale, bn.bias]
            if impl == "flat":
                from cmx_torch.ops import fused_conv_flat as ff

                outf, (mean0, var0, mean1, var1) = ff.flat_double_conv(
                    _in_layout(x, self.dtype, torch.contiguous_format
                               ).reshape(B, cin, H * W),
                    m.reshape(B, 1, H * W), *params, H, W)
                out = outf.reshape(B, -1, H, W)
            elif impl == "nhwc":
                outn, (mean0, var0, mean1, var1) = fc.fused_double_conv(
                    x.to(self.dtype).permute(0, 2, 3, 1), m, *params)
                out = outn.permute(0, 3, 1, 2)
            else:
                raise ValueError(f"unknown fused impl {impl!r}: expected "
                                 f"'flat' or 'nhwc'")
            self.bn0.update_running(mean0, var0)
            self.bn1.update_running(mean1, var1)
            return out

        for conv, bn in ((self.conv0, self.bn0), (self.conv1, self.bn1)):
            x = bn(conv(x), mask, relu=True)
        return x


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


class DownBlock(nn.Module):
    """DoubleConv then 2x2 maxpool; returns (down, skip)."""

    def __init__(self, cin: int, features: int,
                 dtype: torch.dtype = torch.bfloat16, fused: bool = False):
        super().__init__()
        self.double_conv = DoubleConv(cin, features, dtype, fused)

    def forward(self, x, mask=None):
        skip = self.double_conv(x, mask)
        return max_pool_2x2(skip), skip


def bilinear_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample of (B, C, H, W) with align_corners=True, cmx's
    arithmetic: corner-aligned positions i * (n - 1) / (2n - 1) rounded to
    fp32 once (as cmx's fp32 ops give them run op by op; its jitted model
    folds them differently, by up to an ulp), rows then columns in fp32,
    cast back to x's dtype."""
    _, _, h, w = x.shape

    def axis_weights(n_in: int):
        n_out = 2 * n_in
        pos = (torch.arange(n_out, dtype=torch.float64, device=x.device)
               * (n_in - 1) / max(n_out - 1, 1)).float()
        lo = torch.floor(pos).long()
        hi = torch.clamp(lo + 1, max=n_in - 1)
        return lo, hi, pos - lo.float()

    li, hi, wi = axis_weights(h)
    lj, hj, wj = axis_weights(w)
    x32 = x.float()
    wi = wi[:, None]
    # index_select: its backward is one index_add, where advanced
    # indexing's sorts its indices first
    top = (x32.index_select(2, li) * (1 - wi)
           + x32.index_select(2, hi) * wi)
    out = top.index_select(3, lj) * (1 - wj) + top.index_select(3, hj) * wj
    return out.to(x.dtype)


class UpBlock(nn.Module):
    """Upsample (ConvTranspose 2x2 s2 to `features`, or bilinear x2 with no
    parameter), concat skip, DoubleConv of cin + features (bilinear) or
    2 * features channels; `fused` passes to the DoubleConv, whose gate
    decides (cmx/models/blocks.py:395-440)."""

    def __init__(self, cin: int, features: int,
                 dtype: torch.dtype = torch.bfloat16, fused: bool = False,
                 up_sample_mode: str = "conv_transpose"):
        super().__init__()
        if up_sample_mode not in ("conv_transpose", "bilinear"):
            raise ValueError(
                "up_sample_mode must be 'conv_transpose' or 'bilinear', got "
                f"{up_sample_mode!r}")
        self.up_sample_mode = up_sample_mode
        if up_sample_mode == "conv_transpose":
            self.up = ConvTranspose(cin, features, dtype)
            cin = features
        self.double_conv = DoubleConv(cin + features, features, dtype, fused)

    def forward(self, x, skip):
        if self.up_sample_mode == "conv_transpose":
            x = self.up(x)
        else:
            x = bilinear_upsample_2x(x)
        # the concatenation in the layout its DoubleConv reads: channel-major
        # for the flat fused kernels (torch.cat reads a channels-last x
        # through its strides), else the library convolutions' layout,
        # which the NHWC fused kernels read as a view (a channel-major skip,
        # from a flat fused block, is converted). Nothing holds the
        # operands past the concatenation.
        b, c, h, w = x.shape
        cat = x.new_empty((b, c + skip.shape[1], h, w), device="meta")
        fmt = library_layout(x)
        if (fmt == torch.channels_last and fc.FUSED_IMPL == "flat"
                and self.double_conv.use_fused(cat)):
            fmt = torch.contiguous_format
        else:
            x = _in_layout(x, x.dtype, fmt)
        x = torch.cat([x, _in_layout(skip, x.dtype, fmt)], dim=1)
        return self.double_conv(x)


def _bn_remat_contexts(block: nn.Module):
    """torch.utils.checkpoint's context_fn for `block`: what flax's remat
    does to batch_stats. The forward context snapshots the block's BN
    running statistics before the forward moves them; the recompute context
    puts that snapshot in place (MaskedBatchNorm shifts its moments by the
    running mean, so the recompute must see the one the forward saw),
    suppresses update_running, and puts the updated statistics back
    afterwards, whether or not the recompute stopped early."""
    bns = [m for m in block.modules() if isinstance(m, MaskedBatchNorm)]
    snapshot = []

    @contextlib.contextmanager
    def forward():
        snapshot[:] = [(bn.mean.clone(), bn.var.clone()) for bn in bns]
        yield

    @contextlib.contextmanager
    def recompute():
        updated = [(bn.mean.clone(), bn.var.clone()) for bn in bns]
        with torch.no_grad():
            for bn, (mean, var) in zip(bns, snapshot):
                bn.mean.copy_(mean)
                bn.var.copy_(var)
                bn.recomputing = True
        try:
            yield
        finally:
            with torch.no_grad():
                for bn, (mean, var) in zip(bns, updated):
                    bn.mean.copy_(mean)
                    bn.var.copy_(var)
                    bn.recomputing = False

    return forward(), recompute()


def run_block(block: nn.Module, remat: bool, *args):
    """block(*args), under torch.utils.checkpoint when `remat` and a
    backward will follow (training mode, gradients enabled): the block's
    activations are recomputed in the backward, its BN running statistics
    updated once (_bn_remat_contexts). Non-reentrant, as the train step
    takes torch.autograd.grad and down1's input needs no grad; the parent
    calls it on the block it owns, so parameter names do not change."""
    if not (remat and block.training and torch.is_grad_enabled()):
        return block(*args)
    # no block draws a random number: there is no RNG state to stash
    return torch.utils.checkpoint.checkpoint(
        block, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=functools.partial(_bn_remat_contexts, block))


def reset_parameters(module: nn.Module, gen: torch.Generator) -> None:
    """Initialize every block of `module` in a fixed order from `gen`."""
    for m in module.modules():
        if isinstance(m, (Conv, ConvTranspose, Dense, MaskedBatchNorm)):
            m.reset_parameters(gen)
