"""Fused masked DoubleConv, NHWC strip family (port of cmx/ops/fused_conv.py).

Layout as in cmx: NHWC activations (B,H,W,C), (B,H,W) masks, HWIO kernels
(3,3,Cin,C); bf16 activations, fp32 statistics and parameters. Three
kernels, each a hand-written CUDA kernel for Hopper beside a plain PyTorch
version of the same function:

  * conv_stem_stats (K6, csrc/nhwc_conv_fwd.cu): the Cin=1 stem as a 9-tap
    product of make_patches9's patches with w (9,C), + bias, re-mask, bf16
    store, per-channel sum / sum of squares of the fp32 result;
  * conv3x3_mask_stats (K7, csrc/nhwc_conv_fwd.cu): optional pre-norm
    prologue relu(src*inv+shift)*m, 3x3 SAME conv + bias, re-mask, bf16
    store, stats;
  * bwd_mega (K8, csrc/nhwc_conv_bwd.cu): the masked-BN input gradient dy,
    dX = conv of dy with the flipped, channel-transposed weights, and dW.
K7's conv and K8's dX and dW run on the tensor cores (csrc/conv3x3_mma.cuh,
which also holds the channel-major instances of the flat impl's K1/K2);
their weights go in packed by _pack_conv_weights.

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. `<wrapper>.launches` counts the
kernel's launches. cmx's halo pre-slicing (`_halo_rows`, `_with_halo`) is a
Mosaic workaround, not part of the function: the CUDA kernels read their
neighbour pixels from the tensor and zero the image border.

FusedDoubleConv is cmx's fused_double_conv: the forward of its _fwd_impl and
the backward of its _fused_bwd as cmx runs it (FUSED_BWD on). A stage with
Cin >= 8 runs K8 and its conv bias gets an exact-zero gradient; the Cin < 8
stem runs the hand-derived masked-BN backward in plain torch and torch's
conv backward (cmx leaves both to XLA) and its conv bias gets sum(dy).

Also here, shared with the flat impl (fused_conv_flat.py): the gates and
module switches, the BN fold and the naive masked moments of the fused path,
the CUDA operand checks, the tensor-core tile geometry with the weight
packing and split-K arithmetic built on it, and a plain reference of the
masked DoubleConv.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from cmx_torch.ops import _build
from cmx_torch.parallel import mesh

# Strip height of the TPU kernels; blocks.DoubleConv's gate requires
# H % STRIP == 0 so that the port fuses exactly where cmx does, and the NHWC
# kernels take what cmx's take (H % STRIP == 0, W % 8 == 0).
STRIP = 32
_EPS = 1e-5

# The impl DoubleConv's fused path takes, read at forward time as in cmx
# ("flat" = fused_conv_flat.py's channel-major kernels, "nhwc" = this file).
FUSED_IMPL = "flat"

# Gates of DoubleConv's fused path, as in cmx (tuned there for the TPU).
FUSED_MIN_HW = 128
FUSED_MAX_CIN = 128

# Kernel compute/storage dtype: bf16 on the main path; tests set float32 to
# compare the hand-derived backward with autograd without rounding noise.
COMPUTE_DTYPE = torch.bfloat16

# Tile geometry of the tensor-core kernels (csrc/conv3x3_mma.cuh) of K7/K8
# and, channel-major, of K1/K2:
# the conv's output tile (rows, columns), output channels a block and input
# channels a stage (FW_*); dW's pixel tile (rows, columns) and channel
# blocks, three taps (one kernel row) a block (DWM_*). _mma_lib checks it
# against the library's own (cmx_mma_geometry) when it loads one.
_MMA_TH, _MMA_TW, _MMA_BN, _MMA_KC = 8, 32, 64, 16
_MMA_DW_TR, _MMA_DW_TC, _MMA_DW_CI, _MMA_DW_CO = 4, 32, 64, 64
_MMA_GEOMETRY = (_MMA_TH, _MMA_TW, _MMA_BN, _MMA_KC,
                 _MMA_DW_TR, _MMA_DW_TC, _MMA_DW_CI, _MMA_DW_CO)
_STEM_MAX_C = 512


def _cdt() -> torch.dtype:
    return COMPUTE_DTYPE


def _fold(gamma, beta, mean, var):
    inv = gamma * torch.rsqrt(var + _EPS)
    return inv, beta - mean * inv


def _stats(ssum, sq, nact):
    """Naive masked moments E[x^2]-mean^2, clamped at 0 (the fused path's)."""
    mean = ssum / nact
    var = torch.clamp(sq / nact - mean * mean, min=0.0)
    return mean, var


def _bwd_vecs(inv, shift, mean, var, s1, s2, nact):
    rr = torch.rsqrt(var + _EPS)
    return inv, shift, mean, rr, s1 / nact, s2 / nact


# ---------------------------------------------------------------------------
# CUDA launch helpers, shared with fused_conv_flat.py
# ---------------------------------------------------------------------------


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """t, or a fresh copy when its data is not 16-byte aligned (the
    tensor-core kernels copy the mask 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_hw(H: int, W: int, h_mult: int, w_mult: int) -> None:
    """Raise unless H and W are multiples of what the kernel takes."""
    if H % h_mult or W % w_mult:
        raise ValueError(f"the CUDA kernel needs H % {h_mult} == 0 and "
                         f"W % {w_mult} == 0, got {H}x{W}")


def _check_cuda_operands(H: int, W: int, dev: torch.device, bf16: dict,
                         other: dict, h_mult: int, w_mult: int) -> None:
    """Raise unless every operand lies on `dev` (a CUDA device), the
    activations are bf16 and H, W are multiples of what the kernel takes."""
    for name, t in {**bf16, **other}.items():
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    for name, t in bf16.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernel takes bf16 {name}, got {t.dtype}")
    _check_hw(H, W, h_mult, w_mult)


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _dw_chunks(tiles: int, slices: int, target: int):
    """(nchunks, tiles per chunk) of a dW kernel's bounded split-K grid:
    about `target` blocks over `slices` blocks a chunk, each chunk a run of
    pixel tiles, every tile in exactly one chunk."""
    nchunks = min(tiles, max(1, math.ceil(target / slices)))
    per_chunk = math.ceil(tiles / nchunks)
    return math.ceil(tiles / per_chunk), per_chunk


_mma_checked: set = set()


def _mma_lib(name: str):
    """The loaded tensor-core conv library `name`; on first load, raise
    unless its tile geometry is _MMA_GEOMETRY (by which the wrappers pack
    the weights and size the partial sums)."""
    lib = _build.load(name)
    if name not in _mma_checked:
        g = (ctypes.c_int * len(_MMA_GEOMETRY))()
        lib.cmx_mma_geometry(g)
        if tuple(g) != _MMA_GEOMETRY:
            raise RuntimeError(f"cmx_torch: {name}'s tile geometry is "
                               f"{tuple(g)}, the wrapper's {_MMA_GEOMETRY}")
        _mma_checked.add(name)
    return lib


def _pack_conv_weights(wk: torch.Tensor) -> torch.Tensor:
    """(9, K, N) conv weights -> (ceil(N/64), ceil(K/16), 9, 16, 64), zero
    padded: the tensor-core conv's B tiles (conv3x3_mma.cuh: FW_BN, FW_KC),
    one contiguous block per (output-channel block, input-channel chunk),
    taps in order dy*3+dx, rows input channels, columns output channels.
    One copy when K and N fill their tiles, as on the main path."""
    T, K, N = wk.shape
    nk, nn = math.ceil(K / _MMA_KC), math.ceil(N / _MMA_BN)
    if nk * _MMA_KC != K or nn * _MMA_BN != N:
        wk = F.pad(wk, (0, nn * _MMA_BN - N, 0, nk * _MMA_KC - K))
    return wk.reshape(T, nk, _MMA_KC, nn, _MMA_BN).permute(3, 1, 0, 2, 4
                                                           ).contiguous()


def _conv_part_rows(B: int, H: int, W: int) -> int:
    """Partial-sum rows of K7 / K1: one per output tile of the tensor-core
    conv."""
    return B * math.ceil(H / _MMA_TH) * math.ceil(W / _MMA_TW)


def _dw_tiles(B: int, H: int, W: int) -> int:
    """Pixel tiles of K8's / K2's tensor-core dW kernel."""
    return B * math.ceil(H / _MMA_DW_TR) * math.ceil(W / _MMA_DW_TC)


def _dw_slices(Cin: int, C: int) -> int:
    """Blocks a chunk of K8's / K2's dW grid: three kernel rows x channel
    blocks."""
    return 3 * math.ceil(Cin / _MMA_DW_CI) * math.ceil(C / _MMA_DW_CO)


_resident_per_sm: dict = {}


def _resident(name: str, fn: str, dev: torch.device, *args: int) -> int:
    """One wave of a kernel's blocks on `dev`: library `name`'s occupancy
    export `fn(*args)` (blocks a multiprocessor, queried once) times the
    multiprocessors."""
    key = (name, fn, args)
    if key not in _resident_per_sm:
        n = getattr(_build.load(name), fn)(*args)
        if n < 1:
            raise RuntimeError(f"cmx_torch: {name}'s {fn} says its kernel "
                               "cannot be resident on this device")
        _resident_per_sm[key] = n
    return _resident_per_sm[key] * _sms(dev)


def _dw_grid(name: str, dev: torch.device, B: int, H: int, W: int, Cin: int,
             C: int, pre_h: bool):
    """(nchunks, tiles per chunk) of library `name`'s dW kernel: one wave
    of the blocks the CUDA runtime can keep resident."""
    return _dw_chunks(_dw_tiles(B, H, W), _dw_slices(Cin, C),
                      _resident(name, "cmx_dw_blocks_per_sm", dev, int(pre_h)))


# ---------------------------------------------------------------------------
# K6: the Cin=1 stem
# ---------------------------------------------------------------------------


def make_patches9(x: torch.Tensor) -> torch.Tensor:
    """(B,H,W) -> (B,H,W,9) zero-padded 3x3 neighbourhoods, tap dy*3+dx."""
    H, W = x.shape[1], x.shape[2]
    xp = F.pad(x, (1, 1, 1, 1))
    return torch.stack([xp[:, dy:dy + H, dx:dx + W]
                        for dy in range(3) for dx in range(3)], dim=-1)


def conv_stem_stats_plain(patches, m, w, b):
    """Plain version of K6 (also the CPU path). Same contract as the kernel."""
    acc = patches.float() @ w.to(patches.dtype).float()  # (B,H,W,C) fp32
    acc = (acc + b.float()) * m.float()[..., None]
    return acc.to(_cdt()), acc.sum((0, 1, 2)), (acc * acc).sum((0, 1, 2))


def _stem_cuda(patches, m, w, b):
    B, H, W, K = patches.shape
    C = w.shape[1]
    if K != 9 or tuple(w.shape) != (9, C) or tuple(m.shape) != (B, H, W):
        raise ValueError(f"bad shapes patches {tuple(patches.shape)} w "
                         f"{tuple(w.shape)} m {tuple(m.shape)}")
    if C > _STEM_MAX_C:
        raise ValueError(f"the CUDA stem kernel takes C <= {_STEM_MAX_C}, "
                         f"got {C}")
    _check_cuda_operands(H, W, patches.device, dict(patches=patches),
                         dict(m=m, w=w, b=b), STRIP, 8)
    lib = _build.load("nhwc_conv_fwd")
    dev = patches.device
    P = B * H * W
    patches = patches.contiguous()
    mask = m.to(torch.bfloat16).contiguous()
    wk = w.to(torch.bfloat16).contiguous()
    bias = b.float().contiguous()
    nblk = min(math.ceil(P / lib.cmx_stem_run()),
               _resident("nhwc_conv_fwd", "cmx_stem_blocks_per_sm", dev))
    y = torch.empty((B, H, W, C), dtype=torch.bfloat16, device=dev)
    part = torch.empty((nblk, 2, C), dtype=torch.float32, device=dev)
    err = lib.cmx_nhwc_stem(_ptr(patches), _ptr(mask), _ptr(wk), _ptr(bias),
                            _ptr(y), _ptr(part), P, C, nblk, _stream(y))
    _build.check(err, "conv_stem_stats")
    conv_stem_stats.launches += 1
    s = part.sum(0)
    return y, s[0], s[1]


def conv_stem_stats(patches: torch.Tensor, m: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """patches (B,H,W,9) bf16, m (B,H,W), w (9,C), b (C,).

    Returns (y (B,H,W,C) bf16, sum (C,) fp32, sumsq (C,) fp32)."""
    _build.record("conv_stem_stats", patches, m, w, b)
    if patches.device.type == "cpu":
        return conv_stem_stats_plain(patches, m, w, b)
    return _stem_cuda(patches, m, w, b)


conv_stem_stats.launches = 0


# ---------------------------------------------------------------------------
# K7: [normalize-ReLU-mask ->] conv3x3 + bias + mask + inline stats
# ---------------------------------------------------------------------------


def conv3x3_mask_stats_plain(src, m, w, b, inv=None, shift=None):
    """Plain version of K7 (also the CPU path). Same contract as the kernel."""
    cdt = _cdt()
    x = src.to(cdt).permute(0, 3, 1, 2)  # NCHW view
    mf = m.float()[:, None]
    if inv is not None:
        x = (torch.relu(x.float() * inv[:, None, None] + shift[:, None, None])
             * mf).to(cdt)
    wk = w.to(cdt).float().permute(3, 2, 0, 1)  # (C, Cin, 3, 3)
    acc = F.conv2d(x.float(), wk, padding=1)  # fp32 accumulation
    acc = (acc + b.float()[:, None, None]) * mf
    return (acc.to(cdt).permute(0, 2, 3, 1), acc.sum((0, 2, 3)),
            (acc * acc).sum((0, 2, 3)))


def _conv_cuda(src, m, w, b, inv, shift):
    B, H, W, Cin = src.shape
    C = w.shape[3]
    if tuple(w.shape[:3]) != (3, 3, Cin) or tuple(m.shape) != (B, H, W):
        raise ValueError(f"bad shapes src {tuple(src.shape)} w "
                         f"{tuple(w.shape)} m {tuple(m.shape)}")
    _check_cuda_operands(H, W, src.device, dict(src=src),
                         dict(m=m, w=w, b=b, inv=inv, shift=shift), STRIP, 8)
    lib = _mma_lib("nhwc_conv_fwd")
    dev = src.device
    src = src.contiguous()
    mask = _aligned16(m.to(torch.bfloat16).contiguous())
    wp = _pack_conv_weights(w.to(torch.bfloat16).reshape(9, Cin, C))
    bias = b.float().contiguous()
    prenorm = inv is not None
    inv_ = inv.float().contiguous() if prenorm else None
    shift_ = shift.float().contiguous() if prenorm else None
    y = torch.empty((B, H, W, C), dtype=torch.bfloat16, device=dev)
    nblk = _conv_part_rows(B, H, W)
    part = torch.empty((nblk, 2, C), dtype=torch.float32, device=dev)
    err = lib.cmx_nhwc_conv_fwd(
        _ptr(src), _ptr(mask), _ptr(inv_), _ptr(shift_), _ptr(wp), _ptr(bias),
        _ptr(y), _ptr(part), B, Cin, C, H, W, int(prenorm), _stream(y))
    _build.check(err, "conv3x3_mask_stats")
    conv3x3_mask_stats.launches += 1
    s = part.sum(0)
    return y, s[0], s[1]


def conv3x3_mask_stats(
    src: torch.Tensor, m: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
    inv: Optional[torch.Tensor] = None, shift: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused [normalize-ReLU-mask ->] conv3x3 -> +b -> mask -> inline stats.

    src (B,H,W,Cin) bf16 -- the previous stage's raw conv output when
    inv/shift are given (pre_norm), else an already-activated tensor; m
    (B,H,W); w (3,3,Cin,C); b (C,). Returns (y (B,H,W,C) bf16, sum, sumsq)."""
    _build.record("conv3x3_mask_stats", src, m, w, b, inv, shift)
    if src.device.type == "cpu":
        return conv3x3_mask_stats_plain(src, m, w, b, inv, shift)
    return _conv_cuda(src, m, w, b, inv, shift)


conv3x3_mask_stats.launches = 0


# ---------------------------------------------------------------------------
# K8: masked-BN dy + dX + dW
# ---------------------------------------------------------------------------


def bwd_mega_plain(g, y, src, m, inv, shift, mean, var, s1, s2, nact, w,
                   prev_fold=None):
    """Plain version of K8 (also the CPU path). Same contract as the kernel."""
    C, Cin = y.shape[3], src.shape[3]
    cdt = _cdt()
    inv, shift, mean, rr, s1n, s2n = _bwd_vecs(inv, shift, mean, var, s1, s2,
                                               nact)
    gf = g.to(cdt).float()
    yf = y.to(cdt).float()
    mf = m.float()[..., None]
    gate = (yf * inv + shift) > 0
    dz = gf * mf * gate
    xh = (yf - mean) * rr
    dy = ((mf * inv) * (dz - s1n - xh * s2n)).to(cdt)
    h = src.to(cdt)
    if prev_fold is not None:
        h = (torch.relu(h.float() * prev_fold[0] + prev_fold[1]) * mf).to(cdt)
    dyn = dy.float().permute(0, 3, 1, 2)
    wt = w.to(cdt).float().flip(0, 1).permute(2, 3, 0, 1)  # (Cin, C, 3, 3)
    dh = F.conv2d(dyn, wt, padding=1).to(cdt).permute(0, 2, 3, 1)
    dw = torch.nn.grad.conv2d_weight(h.float().permute(0, 3, 1, 2),
                                     (C, Cin, 3, 3), dyn, padding=1)
    return dh, dw.permute(2, 3, 1, 0)


def _bwd_mega_cuda(g, y, src, m, inv, shift, mean, var, s1, s2, nact, w,
                   prev_fold):
    B, H, W, C = y.shape
    Cin = src.shape[3]
    if (tuple(g.shape) != (B, H, W, C) or tuple(src.shape) != (B, H, W, Cin)
            or tuple(w.shape) != (3, 3, Cin, C)):
        raise ValueError(f"bad shapes g {tuple(g.shape)} y {tuple(y.shape)} "
                         f"src {tuple(src.shape)} w {tuple(w.shape)}")
    if _cdt() != torch.bfloat16:
        raise TypeError(f"the CUDA kernel computes in bf16, not {_cdt()}")
    g, y, src = (t.to(torch.bfloat16).contiguous() for t in (g, y, src))
    pinv, pshift = (None, None) if prev_fold is None else prev_fold
    _check_cuda_operands(
        H, W, y.device, dict(g=g, y=y, src=src),
        dict(m=m, inv=inv, shift=shift, mean=mean, var=var, s1=s1, s2=s2,
             w=w, pinv=pinv, pshift=pshift), STRIP, 8)
    lib = _mma_lib("nhwc_conv_bwd")
    dev = y.device
    mask = _aligned16(m.to(torch.bfloat16).contiguous())
    vecs = torch.stack([v.float() for v in _bwd_vecs(
        inv, shift, mean, var, s1, s2, nact)]).contiguous()  # (6, C)
    if prev_fold is not None:
        pinv, pshift = pinv.float().contiguous(), pshift.float().contiguous()
    wt = w.flip(0, 1).permute(0, 1, 3, 2).reshape(9, C, Cin)
    wtp = _pack_conv_weights(wt.to(torch.bfloat16))
    dy = torch.empty((B, H, W, C), dtype=torch.bfloat16, device=dev)
    dh = torch.empty((B, H, W, Cin), dtype=torch.bfloat16, device=dev)
    nchunks, per_chunk = _dw_grid("nhwc_conv_bwd", dev, B, H, W, Cin, C,
                                  prev_fold is not None)
    part = torch.empty((nchunks, 9, Cin, C), dtype=torch.float32, device=dev)
    err = lib.cmx_nhwc_bwd(
        _ptr(g), _ptr(y), _ptr(src), _ptr(mask), _ptr(vecs), _ptr(pinv),
        _ptr(pshift), _ptr(wtp), _ptr(dy), _ptr(dh), _ptr(part),
        B, Cin, C, H, W, int(prev_fold is not None), nchunks, per_chunk,
        _stream(y))
    _build.check(err, "bwd_mega")
    bwd_mega.launches += 1
    return dh, part.sum(0).reshape(3, 3, Cin, C)


def bwd_mega(g, y, src, m, inv, shift, mean, var, s1, s2, nact, w,
             prev_fold=None):
    """Fused stage backward: (dh (B,H,W,Cin) bf16, dW (3,3,Cin,C) fp32).

    g, y (B,H,W,C): the stage output's cotangent and raw conv output; src
    (B,H,W,Cin) the stage input (raw previous conv output when prev_fold =
    (inv0, shift0) is given); s1 multiplies nothing and s2 multiplies x-hat
    in dy = m*inv*(dz - s1/nact - xhat*s2/nact) (cmx passes (dbeta, dgamma))."""
    args = (g, y, src, m, inv, shift, mean, var, s1, s2, nact, w, prev_fold)
    _build.record("bwd_mega", *args)
    if y.device.type == "cpu":
        return bwd_mega_plain(*args)
    return _bwd_mega_cuda(*args)


bwd_mega.launches = 0


# ---------------------------------------------------------------------------
# The differentiable fused DoubleConv core
# ---------------------------------------------------------------------------


def _conv_vjp(h, w, dy, need_dx):
    """(dinput (B,H,W,Cin) or None, dkernel (3,3,Cin,C)) of the NHWC 3x3 SAME
    conv, computed in the compute dtype as cmx's _conv_vjp (torch's conv
    backward, where cmx leaves it to XLA)."""
    cdt = _cdt()
    dinp, dker, _ = torch.ops.aten.convolution_backward(
        dy.to(cdt).permute(0, 3, 1, 2), h.to(cdt).permute(0, 3, 1, 2),
        w.to(cdt).permute(3, 2, 0, 1), None, [1, 1], [1, 1], [1, 1], False,
        [0, 0], 1, [need_dx, True, False])
    return (None if dinp is None else dinp.permute(0, 2, 3, 1),
            dker.permute(2, 3, 1, 0))


class FusedDoubleConv(torch.autograd.Function):
    """Masked DoubleConv (training mode) over NHWC operands: x (B,H,W,Cin)
    pre-masked, m (B,H,W) {0,1}, w_i (3,3,.,C) HWIO. Returns (out (B,H,W,C),
    mean0, var0, mean1, var1); the statistics are not differentiable (they
    feed the running averages). Under data parallel its batch sums are
    global, as FlatDoubleConv's."""

    @staticmethod
    def forward(ctx, x, m, w0, b0, g0, be0, w1, b1, g1, be1):
        cdt = _cdt()
        mb = m.to(cdt)
        if x.shape[-1] == 1:
            patches = make_patches9(x[..., 0].to(cdt))
            y0, s0, q0 = conv_stem_stats(patches, mb,
                                         w0.reshape(9, -1).to(cdt), b0)
        else:
            y0, s0, q0 = conv3x3_mask_stats(x.to(cdt), mb, w0.to(cdt), b0)
        s0, q0, nact = mesh.all_reduce_sum_many(s0, q0, m.float().sum())
        nact = torch.clamp(nact, min=1.0)
        mean0, var0 = _stats(s0, q0, nact)
        inv0, shift0 = _fold(g0, be0, mean0, var0)
        y1, s1, q1 = conv3x3_mask_stats(y0, mb, w1.to(cdt), b1, inv0, shift0)
        s1, q1 = mesh.all_reduce_sum_many(s1, q1)
        mean1, var1 = _stats(s1, q1, nact)
        inv1, shift1 = _fold(g1, be1, mean1, var1)
        out = (torch.relu(y1.float() * inv1 + shift1)
               * m.float()[..., None]).to(cdt)
        ctx.save_for_backward(x, m, w0, w1, g0, be0, g1, be1, y0, y1,
                              mean0, var0, mean1, var1, nact)
        ctx.mark_non_differentiable(mean0, var0, mean1, var1)
        ctx.scope = mesh.scope()  # the backward's sums run in this group
        return out, mean0, var0, mean1, var1

    @staticmethod
    def backward(ctx, g_out, *_stat_cts):
        with mesh.in_scope(ctx.scope):
            return FusedDoubleConv._backward(ctx, g_out)

    @staticmethod
    def _backward(ctx, g_out):
        """cmx's _fused_bwd. Per stage, with xhat = (y-mean)*r:
        dz = g*m*[gate], dgamma = sum(dz*xhat), dbeta = sum(dz),
        dy = m*gamma*r*(dz - (dbeta + xhat*dgamma)/nact); K8 gates on
        y*inv+shift > 0 and stage_bwd on gamma*xhat+beta > 0 (equal up to
        rounding), each as in cmx."""
        (x, m, w0, w1, g0, be0, g1, be1, y0, y1,
         mean0, var0, mean1, var1, nact) = ctx.saved_tensors
        cdt = _cdt()
        mf = m.float()[..., None]
        red = (0, 1, 2)
        inv0, shift0 = _fold(g0, be0, mean0, var0)
        inv1, shift1 = _fold(g1, be1, mean1, var1)

        def stage_sums(dout, y, mean, var, inv, shift):
            yf = y.float()
            r = torch.rsqrt(var + _EPS)
            gate = (yf * inv + shift) > 0
            dz = dout.float() * mf * gate
            return (dz * ((yf - mean) * r)).sum(red), dz.sum(red)

        def stage_bwd(dout, y, mean, var, gamma, beta, dgamma, dbeta):
            yf = y.float()
            r = torch.rsqrt(var + _EPS)
            xhat = (yf - mean) * r
            gate = (gamma * xhat + beta) > 0
            dz = dout.float() * mf * gate
            return mf * (gamma * r) * (dz - (dbeta + xhat * dgamma) / nact)

        # stage 1: out -> y1 -> (h0, w1, b1)
        # (the dy terms read the global sums; dg/dbe return the rank's own)
        dg1, dbe1 = stage_sums(g_out, y1, mean1, var1, inv1, shift1)
        sg1, sbe1 = mesh.all_reduce_sum_many(dg1, dbe1)
        dh0, dw1 = bwd_mega(g_out, y1, y0, m, inv1, shift1, mean1, var1,
                            sbe1, sg1, nact, w1, prev_fold=(inv0, shift0))
        db1 = torch.zeros_like(dbe1)  # BN absorbs the conv bias

        # stage 0: x -> y0 -> (x, w0, b0); the Cin < 8 stem goes to torch
        dg0, dbe0 = stage_sums(dh0, y0, mean0, var0, inv0, shift0)
        sg0, sbe0 = mesh.all_reduce_sum_many(dg0, dbe0)
        if x.shape[-1] >= 8:
            dx, dw0 = bwd_mega(dh0, y0, x.to(cdt), m, inv0, shift0, mean0,
                               var0, sbe0, sg0, nact, w0)
            db0 = torch.zeros_like(dbe0)
        else:
            dy0 = stage_bwd(dh0, y0, mean0, var0, g0, be0, sg0, sbe0)
            db0 = dy0.sum(red)
            dx, dw0 = _conv_vjp(x, w0, dy0.to(cdt),
                                need_dx=ctx.needs_input_grad[0])
        if dx is not None:
            dx = dx.to(x.dtype)
        return (dx, None, dw0.float(), db0, dg0, dbe0, dw1.float(), db1, dg1,
                dbe1)


def fused_double_conv(x, m, w0, b0, g0, be0, w1, b1, g1, be1):
    """(out (B,H,W,C), (mean0, var0, mean1, var1)) -- cmx's fused_double_conv."""
    out, *stats = FusedDoubleConv.apply(x, m, w0, b0, g0, be0, w1, b1, g1, be1)
    return out, tuple(stats)


def double_conv_reference(xf, mflat, w0, b0, g0, be0, w1, b1, g1, be1, H, W):
    """Plain masked DoubleConv (training mode) over flat operands, for tests.

    xf (B,Cin,H*W), mflat (B,1,H*W), w_i (3,3,Cin_i,C) HWIO. Mirrors
    cmx.ops.fused_conv.double_conv_reference (NHWC there) op for op; returns
    (out (B,C,H*W), (mean0, var0, mean1, var1))."""
    B = xf.shape[0]
    mf = mflat.float().reshape(B, 1, H, W)
    nact = torch.clamp(mflat.float().sum(), min=1.0)
    stats = []

    def stage(h, w, b, gamma, beta):
        cdt = _cdt()
        y = F.conv2d(h.to(cdt), w.to(cdt).permute(3, 2, 0, 1), padding=1)
        y = (y + b.to(y.dtype)[:, None, None]).float() * mf
        mean = y.sum((0, 2, 3)) / nact
        var = torch.clamp((y * y).sum((0, 2, 3)) / nact - mean ** 2, min=0.0)
        stats.append((mean, var))
        inv, shift = _fold(gamma, beta, mean, var)
        return (torch.relu(y * inv[:, None, None] + shift[:, None, None])
                * mf).to(cdt)

    h = stage(xf.reshape(B, -1, H, W), w0, b0, g0, be0)
    out = stage(h, w1, b1, g1, be1)
    return (out.reshape(B, out.shape[1], H * W),
            (stats[0][0], stats[0][1], stats[1][0], stats[1][1]))
