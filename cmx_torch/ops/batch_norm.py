"""The batch norm's kernels (csrc/batch_norm.cu), their plain versions and
the autograd Function that runs them.

`MaskedBatchNorm` (models/blocks.py) sends every 4-D bf16 or fp32 norm on
the card through `NormFunction` here: the batch moments (`norm_moments`, once,
or twice for the "two_pass" variant), the normalisation with the caller's
ReLU and re-mask folded in (`norm_apply`), and a backward of two passes,
the per-channel sums (`norm_grad_sums`) and the input's gradient
(`norm_grad_input`). The per-channel folds between them (mean, var, the
clamp, inv, shift, the running update, the all-reduces under data
parallel) are C-sized torch ops on the host's side, as before. Nothing
fp32 is saved for the backward: x (in its own dtype), the mask and
C-vectors.

Replaces no TPU kernel: cmx's MaskedBatchNorm is XLA element-wise and
reduction ops (cmx/models/blocks.py), and the port's was PyTorch's, 6-8
passes over every activation and as many backward. Bound on the card:
bytes (6 a bf16 value forward, 10 backward; see the source's note).

The layout is read from x: channels-last (the library convolutions' on the
card, models/blocks.py::library_layout) or contiguous channel-major (a flat
fused block's output), one kernel instance each; no other strides are
taken. A CPU tensor runs the plain version of each pass, which repeats the
kernel's arithmetic in eager torch (sums in torch's order); tests reach the
Function on the CPU that way. Each wrapper's `.launches` counts its calls
on the card, and `_build.record` sees every call.

The one backward serves every moment variant: the shift carries no
gradient, so the moments' gradient is the textbook one,
    dx = inv (g - m (sum g + xhat sum g xhat) / n),
with g the gradient reaching the normalised value (under the epilogue
through the re-mask and the ReLU's gate, recomputed from x with the
forward's roundings), xhat =
(x - mean) rstd, inv = rstd scale, sums over the global batch, and none of
it where the running statistics normalise (eval mode). The var term is
dropped where the variant's var was clamped at 0, as the clamp's gradient
drops it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cmx_torch.ops import _build
from cmx_torch.parallel import mesh

PASSES = {"moments": 0, "apply": 1, "grad_sums": 2, "grad_input": 3}
THREADS = 256  # csrc/batch_norm.cu's kThreads
VEC = 8        # its kVec: channels (channels-last) or pixels a thread loads
MAX_TX = 32    # its kMaxTX
# The sum passes' blocks along x: about TARGET_BLOCKS blocks in all, each
# thread summing ROWS_MIN..ROWS_MAX rows (channels-last) or vectors.
TARGET_BLOCKS = 4096
ROWS_MIN, ROWS_MAX = 16, 128
_DTYPES = (torch.bfloat16, torch.float32)


def layout_of(x: torch.Tensor) -> Optional[str]:
    """"channels_last" or "channels_first" (contiguous), the two layouts
    the kernels read; None for any other strides. A tensor that is both
    (one channel, or one pixel) is channel-major: the memory is the same."""
    if x.is_contiguous():
        return "channels_first"
    if x.is_contiguous(memory_format=torch.channels_last):
        return "channels_last"
    return None


def sum_geometry(B: int, C: int, P: int, channels_last: bool
                 ) -> Tuple[int, int]:
    """(K, nbx) of a pass over (B, C, P = H W): each thread walks K rows
    (channels-last: TY = THREADS // TX rows a block step) or K vectors
    (channel-major: THREADS a block step), and nbx blocks along x cover
    the shape; the sum passes write (2 C + 1) nbx partials. The launcher
    checks the pair against the shape."""
    if channels_last:
        groups = -(-C // VEC)
        tx = min(groups, MAX_TX)
        per, gy, units = THREADS // tx, -(-groups // tx), B * P
    else:
        per, gy = THREADS, C
        units = B * (P // VEC if P % VEC == 0 else P)
    want = max(1, TARGET_BLOCKS // gy)
    k = min(max(-(-units // (per * want)), ROWS_MIN), ROWS_MAX)
    return k, -(-units // (per * k))


def _mask4(mask: Optional[torch.Tensor], dtype: torch.dtype):
    """The mask as (B, 1, H, W) in `dtype`, or None."""
    if mask is None:
        return None
    m = mask.to(dtype)
    return m[:, None] if m.dim() == 3 else m


_RED = (0, 2, 3)


def norm_moments_plain(x, mask, shift):
    """Plain version of the moments pass (also its CPU path, and
    MaskedBatchNorm's plain composition's sums, differentiable): (2 C + 1)
    in the statistics dtype (fp32, fp64 for fp64), the sums of
    d = (x - shift) m and d^2 per channel and the count (the sum of m, or
    the positions a channel without a mask)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    c = xf.shape[1]
    m = _mask4(mask, xf.dtype)
    d = xf - shift.to(xf.dtype)[:, None, None]
    if m is not None:
        d = d * m
    n = (xf.new_full((1,), float(xf.numel() // c)) if m is None
         else m.sum(_RED))
    return torch.cat([d.sum(_RED), (d * d).sum(_RED), n])


def _normalised(x, inv_t, shift_t):
    """PyTorch's `x * inv_t + shift_t` in x's dtype (two roundings)."""
    return x * inv_t.to(x.dtype)[:, None, None] + \
        shift_t.to(x.dtype)[:, None, None]


def norm_apply_plain(x, mask, inv_t, shift_t, relu: bool):
    """Plain version of the apply pass (also its CPU path): the
    normalisation in x's dtype, then under `relu` the DoubleConv's
    epilogue: the ReLU and the re-mask."""
    y = _normalised(x, inv_t, shift_t)
    if relu:
        y = torch.relu(y)
        if mask is not None:
            y = y * _mask4(mask, y.dtype)
    return y


def _grad_in(dy, x, mask, inv_t, shift_t, relu):
    """fp32 gradient reaching the normalised value."""
    g = dy.float()
    if relu:
        if mask is not None:
            g = g * _mask4(mask, torch.float32)
        g = torch.where(_normalised(x, inv_t, shift_t) > 0, g,
                        g.new_zeros(()))
    return g


def norm_grad_sums_plain(dy, x, mask, inv_t, shift_t, mean, relu: bool):
    """Plain version of the backward's sums pass (also its CPU path): (2 C)
    fp32, the sums of g and g (x - mean) per channel."""
    g = _grad_in(dy, x, mask, inv_t, shift_t, relu)
    xc = x.float() - mean[:, None, None]
    return torch.cat([g.sum(_RED), (g * xc).sum(_RED)])


def norm_grad_input_plain(dy, x, mask, inv_t, shift_t, mean, inv, k1, k2,
                          relu: bool):
    """Plain version of the backward's input pass (also its CPU path):
    dx = inv g - m (k1 + k2 (x - mean)) in x's dtype and layout."""
    g = _grad_in(dy, x, mask, inv_t, shift_t, relu)
    xc = x.float() - mean[:, None, None]
    t = k1[:, None, None] + k2[:, None, None] * xc
    if mask is not None:
        t = _mask4(mask, torch.float32) * t
    return (inv[:, None, None] * g - t).to(x.dtype)


def _aligned(t: torch.Tensor, fmt: torch.memory_format) -> torch.Tensor:
    """t in `fmt`, 16-byte aligned (the kernels' vector loads)."""
    t = t.contiguous(memory_format=fmt)
    return t if t.data_ptr() % 16 == 0 else t.clone(memory_format=fmt)


def _operands(x, mask):
    """(x, channels_last flag, B, C, P, mask (B, H W) or None, mask kind)
    as the kernels take them; raises on what they do not take."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"the norm kernels take bf16 or fp32, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"expected x (B,C,H,W), got {tuple(x.shape)}")
    layout = layout_of(x)
    if layout is None:
        raise ValueError(f"x of strides {x.stride()} is neither "
                         "channels-last nor contiguous")
    fmt = (torch.channels_last if layout == "channels_last"
           else torch.contiguous_format)
    B, C, H, W = x.shape
    P = H * W
    if B * P >= 2 ** 31 or B == 0:
        raise ValueError(f"the norm kernels take 0 < B H W < 2^31, got "
                         f"{tuple(x.shape)}")
    m, kind = None, 0
    if mask is not None:
        if mask.device != x.device:
            raise ValueError(f"mask is on {mask.device}, expected {x.device}")
        m = mask[:, 0] if mask.dim() == 4 else mask
        if tuple(m.shape) != (B, H, W) or (mask.dim() == 4
                                          and mask.shape[1] != 1):
            raise ValueError(f"expected a mask (B,1,H,W) or (B,H,W) for x "
                             f"{tuple(x.shape)}, got {tuple(mask.shape)}")
        if m.dtype not in _DTYPES:
            m = m.float()
        m = _aligned(m.reshape(B, P), torch.contiguous_format)
        kind = 1 if m.dtype == torch.bfloat16 else 2
    return (_aligned(x, fmt), int(layout == "channels_last"), B, C, P, m,
            kind, fmt)


def _consts(*rows) -> torch.Tensor:
    return torch.stack([r.float() for r in rows]).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _pass(name: str, x, dy, mask, cst, relu=False):
    """One kernel pass on the card: an element-wise pass's output (x's
    dtype and layout), or a sum pass's fp32 sums (moments: 2 C + 1, with the
    count; grad sums: 2 C)."""
    x, cl, B, C, P, m, kind, fmt = _operands(x, mask)
    if dy is not None:
        if dy.shape != x.shape or dy.device != x.device:
            raise ValueError(f"dy {tuple(dy.shape)} on {dy.device} for x "
                             f"{tuple(x.shape)} on {x.device}")
        dy = _aligned(dy.to(x.dtype), fmt)
    k, nbx = sum_geometry(B, C, P, bool(cl))
    sums = name in ("moments", "grad_sums")
    dev = x.device
    out = part = None
    if sums:
        part = torch.empty((2 * C + 1) * nbx, dtype=torch.float32,
                           device=dev)
    else:
        out = torch.empty_like(x, memory_format=fmt)
    lib = _build.load("batch_norm")
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.cmx_norm_pass(
        PASSES[name], cl, int(x.dtype == torch.bfloat16), kind, x.data_ptr(),
        _ptr(dy), _ptr(m), cst.data_ptr(), _ptr(out), _ptr(part), B, C, P,
        k, nbx, int(relu), stream), f"norm_{name}")
    if not sums:
        return out
    nout = 2 * C + 1 if name == "moments" else 2 * C
    res = torch.empty(nout, dtype=torch.float32, device=dev)
    rows = B * P if name == "moments" and m is None else 0
    _build.check(lib.cmx_norm_finalize(
        part.data_ptr(), res.data_ptr(), nout, nbx,
        2 * C if name == "moments" else -1, rows, stream),
        f"norm_{name} (finalize)")
    return res


def norm_moments(x: torch.Tensor, mask: Optional[torch.Tensor],
                 shift: torch.Tensor) -> torch.Tensor:
    """(2 C + 1) fp32: sum (x - shift) m, sum ((x - shift) m)^2 per channel,
    and the count, over this process's batch (x (B,C,H,W), mask (B,1,H,W)
    or (B,H,W) or None, shift (C,))."""
    _build.record("norm_moments", x, mask, shift)
    if x.device.type == "cpu":
        return norm_moments_plain(x, mask, shift)
    out = _pass("moments", x, None, mask, _consts(shift))
    norm_moments.launches += 1
    return out


norm_moments.launches = 0


def norm_apply(x, mask, inv_t, shift_t, relu: bool = False) -> torch.Tensor:
    """x * inv_t + shift_t in x's dtype (inv_t, shift_t (C,), rounded to
    it), then under `relu` max(., 0) times the mask (the DoubleConv's
    epilogue)."""
    _build.record("norm_apply", x, mask, inv_t, shift_t, relu)
    if x.device.type == "cpu":
        return norm_apply_plain(x, mask, inv_t, shift_t, relu)
    out = _pass("apply", x, None, mask, _consts(inv_t, shift_t), relu)
    norm_apply.launches += 1
    return out


norm_apply.launches = 0


def norm_grad_sums(dy, x, mask, inv_t, shift_t, mean,
                   relu: bool = False) -> torch.Tensor:
    """(2 C) fp32: the sums of g and g (x - mean) per channel over this
    process's batch, g the gradient reaching the normalised value."""
    _build.record("norm_grad_sums", dy, x, mask, inv_t, shift_t, mean, relu)
    if x.device.type == "cpu":
        return norm_grad_sums_plain(dy, x, mask, inv_t, shift_t, mean, relu)
    out = _pass("grad_sums", x, dy, mask, _consts(inv_t, shift_t, mean),
                relu)
    norm_grad_sums.launches += 1
    return out


norm_grad_sums.launches = 0


def norm_grad_input(dy, x, mask, inv_t, shift_t, mean, inv, k1, k2,
                    relu: bool = False) -> torch.Tensor:
    """dx = inv g - m (k1 + k2 (x - mean)) in x's dtype and layout (m 1
    without a mask)."""
    _build.record("norm_grad_input", dy, x, mask, inv_t, shift_t, mean, inv,
                  k1, k2, relu)
    if x.device.type == "cpu":
        return norm_grad_input_plain(dy, x, mask, inv_t, shift_t, mean, inv,
                                     k1, k2, relu)
    out = _pass("grad_input", x, dy, mask,
                _consts(inv_t, shift_t, mean, inv, k1, k2), relu)
    norm_grad_input.launches += 1
    return out


norm_grad_input.launches = 0

WRAPPERS = (norm_moments, norm_apply, norm_grad_sums, norm_grad_input)


class NormFunction(torch.autograd.Function):
    """y = norm_apply(x, mask, T(inv), T(shift)) with inv = rsqrt(var + eps)
    scale and shift = bias - mean inv (MaskedBatchNorm's folds, op for op),
    differentiable in x, scale and bias. `denom` is the global count the
    batch moments divided by, `var_live` where their var was not clamped;
    both None with the running statistics (no moment term in the
    gradient)."""

    @staticmethod
    def forward(ctx, x, scale, bias, mask, mean, var, var_live, denom,
                eps: float, relu: bool):
        rstd = torch.rsqrt(var + eps)
        inv = rstd * scale
        shift = bias - mean * inv
        inv_t, shift_t = inv.to(x.dtype), shift.to(x.dtype)
        ctx.save_for_backward(x, mask, mean, rstd, inv, inv_t, shift_t,
                              var_live, denom)
        ctx.relu = relu
        ctx.scope = mesh.scope()
        return norm_apply(x, mask, inv_t, shift_t, relu)

    @staticmethod
    def backward(ctx, dy):
        (x, mask, mean, rstd, inv, inv_t, shift_t, var_live,
         denom) = ctx.saved_tensors
        relu = ctx.relu
        c = x.shape[1]
        sums = norm_grad_sums(dy, x, mask, inv_t, shift_t, mean, relu)
        dx = None
        if ctx.needs_input_grad[0]:
            if denom is None:
                k1 = k2 = torch.zeros_like(mean)
            else:
                # the moments were over the global batch: so are the sums
                # that feed dx (the rank's own are its scale and bias
                # gradients, which the gradient all-reduce adds up)
                tot = sums
                with mesh.in_scope(ctx.scope):
                    if mesh.active():
                        tot = mesh.all_reduce_sum(sums.clone())
                k1 = inv * tot[:c] / denom
                k2 = torch.where(var_live, inv * rstd * rstd * tot[c:] / denom,
                                 torch.zeros_like(inv))
            dx = norm_grad_input(dy, x, mask, inv_t, shift_t, mean, inv, k1,
                                 k2, relu)
        return (dx, sums[c:] * rstd, sums[:c], None, None, None, None, None,
                None, None)

