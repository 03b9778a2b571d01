"""Host-side pieces of the tensor-core K7/K8 (cmx_torch/csrc/conv3x3_mma.cuh),
on the CPU: the weight packing, the tile and split-K arithmetic, the
parsers that read nvcc's and cuobjdump's output, and the C entry points'
argument lists against the ctypes signatures of `_build`.

The kernels themselves run only on the card (tests/test_torch_port_cuda.py);
here their decomposition of the work is replayed in plain torch from the
same host functions and held to the plain versions, which
tests/test_torch_port_nhwc.py holds to cmx. Inputs come from numpy with a
seed; fp32 throughout, tolerance rel 1e-5 of the largest entry (summation
order).
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cmx_torch.ops import _build
from cmx_torch.ops import fused_conv as fc


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)


@pytest.mark.parametrize("K,N", [(3, 20), (8, 20), (24, 96), (64, 128),
                                 (128, 64)])
def test_pack_conv_weights_places_every_tap_and_zero_pads(K, N):
    rng = np.random.default_rng(0)
    kc = fc._MMA_KC
    wk = torch.from_numpy(rng.normal(size=(9, K, N)).astype(np.float32))
    wp = fc._pack_conv_weights(wk)
    nn_, nk = math.ceil(N / fc._MMA_BN), math.ceil(K / kc)
    assert tuple(wp.shape) == (nn_, nk, 9, kc, fc._MMA_BN)
    assert wp.is_contiguous()
    full = torch.zeros((9, nk * kc, nn_ * fc._MMA_BN))
    full[:, :K, :N] = wk
    for nb in range(nn_):
        for c in range(nk):
            blk = full[:, c * kc:(c + 1) * kc,
                       nb * fc._MMA_BN:(nb + 1) * fc._MMA_BN]
            assert torch.equal(wp[nb, c], blk)
    assert float(wp.abs().sum()) == pytest.approx(float(wk.abs().sum()))


def _tiled_conv(x, wp, cout):
    """The forward kernel's implicit GEMM in plain torch: per output-channel
    block and input-channel chunk, nine shifted halo windows times the
    packed tap blocks."""
    kc = fc._MMA_KC
    B, H, W, K = x.shape
    nn_, nk = wp.shape[:2]
    xp = F.pad(x, (0, nk * kc - K, 1, 1, 1, 1))
    out = torch.zeros((B, H, W, nn_ * fc._MMA_BN))
    for nb in range(nn_):
        cols = slice(nb * fc._MMA_BN, (nb + 1) * fc._MMA_BN)
        for c in range(nk):
            for t in range(9):
                dy, dx = divmod(t, 3)
                win = xp[:, dy:dy + H, dx:dx + W, c * kc:(c + 1) * kc]
                out[..., cols] += win @ wp[nb, c, t]
    return out[..., :cout]


@pytest.mark.parametrize("Cin,C", [(3, 20), (24, 96), (64, 64)])
def test_packed_weights_drive_the_tiled_conv_as_the_plain_k7(Cin, C):
    rng = np.random.default_rng(1)
    B, H, W = 2, 16, 40
    m = torch.from_numpy((rng.random((B, H, W)) > 0.4).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(B, H, W, Cin)).astype(np.float32))
    x = x * m[..., None]
    w = torch.from_numpy(rng.normal(size=(3, 3, Cin, C)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(C,)).astype(np.float32))
    wp = fc._pack_conv_weights(w.reshape(9, Cin, C))
    acc = _tiled_conv(x, wp, C)
    v = (acc + b) * m[..., None]
    saved = fc.COMPUTE_DTYPE
    fc.COMPUTE_DTYPE = torch.float32
    try:
        y, s, q = fc.conv3x3_mask_stats_plain(x, m, w, b)
    finally:
        fc.COMPUTE_DTYPE = saved
    assert _rel(v, y) <= 1e-5
    assert _rel(v.sum((0, 1, 2)), s) <= 1e-5
    assert _rel((v * v).sum((0, 1, 2)), q) <= 1e-5


@pytest.mark.parametrize("B,H,W,Cin,C", [(2, 32, 40, 8, 20),
                                         (1, 32, 64, 64, 128)])
def test_dw_split_k_partials_sum_to_the_weight_gradient(B, H, W, Cin, C):
    """The dW kernel's decomposition: chunks of pixel tiles (_dw_chunks over
    _dw_tiles), each tile's three kernel rows times three columns of h
    against the tile's dy, partial per chunk; the partials' sum is
    conv2d_weight's."""
    rng = np.random.default_rng(2)
    h = torch.from_numpy(rng.normal(size=(B, H, W, Cin)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(B, H, W, C)).astype(np.float32))
    tiles = fc._dw_tiles(B, H, W)
    nchunks, per = fc._dw_chunks(tiles, fc._dw_slices(Cin, C), 24)
    TR, TC = fc._MMA_DW_TR, fc._MMA_DW_TC
    tx = math.ceil(W / TC)
    ty = H // TR
    hp = F.pad(h, (0, 0, 1, 1 + TC, 1, 1))  # zero halo, overhang columns
    dyp = F.pad(dy, (0, 0, 0, TC))
    part = torch.zeros((nchunks, 3, 3, Cin, C))
    for t in range(tiles):
        n, rem = divmod(t, tx * ty)
        y0, x0 = (rem // tx) * TR, (rem % tx) * TC
        d = dyp[n, y0:y0 + TR, x0:x0 + TC].reshape(-1, C)
        for a in range(3):
            for bb in range(3):
                hs = hp[n, y0 + a:y0 + a + TR, x0 + bb:x0 + bb + TC]
                part[t // per, a, bb] += hs.reshape(-1, Cin).T @ d
    ref = torch.nn.grad.conv2d_weight(h.permute(0, 3, 1, 2), (C, Cin, 3, 3),
                                      dy.permute(0, 3, 1, 2), padding=1)
    assert _rel(part.sum(0), ref.permute(2, 3, 1, 0)) <= 1e-5


@pytest.mark.parametrize("tiles,slices,target", [
    (16384, 3, 264), (4096, 12, 264), (5, 12, 264), (1, 3, 1000),
    (187, 24, 24), (100, 7, 9)])
def test_dw_chunks_cover_every_tile_once_within_the_target(tiles, slices,
                                                           target):
    nchunks, per = fc._dw_chunks(tiles, slices, target)
    assert 1 <= nchunks <= tiles and per >= 1
    assert (nchunks - 1) * per < tiles <= nchunks * per
    assert nchunks <= max(1, math.ceil(target / slices))


def test_tile_counts_of_the_tensor_core_kernels():
    assert fc._conv_part_rows(32, 256, 256) == 32 * (256 // fc._MMA_TH) * 8
    assert fc._conv_part_rows(2, 32, 40) == 2 * (32 // fc._MMA_TH) * 2
    assert fc._dw_tiles(2, 32, 40) == 2 * (32 // fc._MMA_DW_TR) * 2
    assert fc._dw_slices(64, 64) == 3
    assert fc._dw_slices(128, 128) == 12
    assert fc._dw_slices(24, 96) == 6


def test_tile_geometry_is_the_kernel_headers():
    """The wrapper's _MMA_GEOMETRY is the header's FW_*/DWM_* constants (on
    the card, _mma_lib also checks it against the built library)."""
    header = (Path(fc.__file__).resolve().parent.parent / "csrc" /
              "conv3x3_mma.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", header))
    names = ("FW_TH", "FW_TW", "FW_BN", "FW_KC",
             "DWM_TR", "DWM_TC", "DWM_CI", "DWM_CO")
    assert tuple(int(consts[n]) for n in names) == fc._MMA_GEOMETRY


def test_aligned16_copies_only_a_misaligned_tensor():
    t = torch.zeros(64, dtype=torch.bfloat16)
    assert fc._aligned16(t) is t
    view = t[1:]
    fixed = fc._aligned16(view)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, view)


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN3cmx18conv3x3_mma_kernelILb1ELb1EEEvPK13__nv_bfloat16S3_PKfS5_S3_S5_PS1_Pfiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN3cmx18conv3x3_mma_kernelILb1ELb1EEEvPK13__nv_bfloat16S3_PKfS5_S3_S5_PS1_Pfiiiiii
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN3cmx21bn_bwd_dy_nhwc_kernelEPK13__nv_bfloat16S2_S2_PKfPS0_ii' for 'sm_90a'
ptxas info    : Function properties for _ZN3cmx21bn_bwd_dy_nhwc_kernelEPK13__nv_bfloat16S2_S2_PKfPS0_ii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers
"""

SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN3cmx21conv3x3_dw_mma_kernelILb0EEEvPK13__nv_bfloat16S3_PKfS5_S3_Pfiiiiiiii
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   HMMA.16816.F32.BF16 R24, R64, R88, R24 ;
        /*0020*/               @P0 HMMA.16816.F32.BF16 R28, R64, R90, R28 ;
        /*0030*/                   LDSM.16.MT88.4 R64, [R3] ;
\t\tFunction : _ZN3cmx11stem_kernelEPK13__nv_bfloat16S2_S2_PKfPS0_Pfxii
        /*0000*/                   FFMA R4, R5, R6, R4 ;
        /*0010*/                   HGMMA.64x64x16.F32.BF16 gdesc[UR4], RZ, !UPT ;
"""


def test_ptxas_usage_reads_registers_and_spills_per_kernel():
    usage = _build.ptxas_usage(PTXAS_LOG)
    assert usage == {"cmx::conv3x3_mma_kernel<true,true>": (128, 8, 8),
                     "cmx::bn_bwd_dy_nhwc_kernel": (40, 0, 0)}


def test_sass_counts_count_tensor_core_instructions_per_kernel():
    counts = _build.sass_counts(SASS)
    assert counts == {"cmx::conv3x3_dw_mma_kernel<false>": {"HMMA": 2,
                                                           "HGMMA": 0},
                      "cmx::stem_kernel": {"HMMA": 0, "HGMMA": 1}}


def test_sass_digests_compare_instructions_not_addresses():
    kernels = _build.sass_by_kernel(SASS)
    assert kernels["cmx::stem_kernel"] == [
        "FFMA R4, R5, R6, R4", "HGMMA.64x64x16.F32.BF16 gdesc[UR4], RZ, !UPT"]
    moved = SASS.replace("/*0000*/", "/*0100*/").replace("/*0010*/",
                                                         "/*0110*/")
    assert _build.sass_digests(moved) == _build.sass_digests(SASS)
    changed = _build.sass_digests(SASS.replace("FFMA R4, R5", "FFMA R4, R7"))
    digests = _build.sass_digests(SASS)
    assert changed["cmx::stem_kernel"] != digests["cmx::stem_kernel"]
    assert (changed["cmx::conv3x3_dw_mma_kernel<false>"] ==
            digests["cmx::conv3x3_dw_mma_kernel<false>"])


@pytest.mark.parametrize("mangled,label", [
    ("_ZN3cmx18conv3x3_mma_kernelILb0ELb1EEEvPK13__nv_bfloat16",
     "cmx::conv3x3_mma_kernel<false,true>"),
    ("_ZN3cmx16bn_bwd_dy_kernelILb1EEEvPK13__nv_bfloat16",
     "cmx::bn_bwd_dy_kernel<true>"),
    ("_ZN3cmx11stem_kernelEPK13__nv_bfloat16", "cmx::stem_kernel"),
    ("_ZN3cmx21spark_loss_fwd_kernelI13__nv_bfloat16fEEvPKT_PKfPKT0_PfS8_S8_"
     "Pjii", "cmx::spark_loss_fwd_kernel<__nv_bfloat16,float>"),
    ("_ZN3cmx18crop_resize_kernelILb0EEEvPKfS2_Pfiiiii",
     "cmx::crop_resize_kernel<false>"),
    ("crop_weights_kernel", "crop_weights_kernel"),
    ("_ZN47_GLOBAL__N__0b13f455_14_crop_resize_cu_118ef53d19crop_weights_"
     "kernelEPKfPfS2_iiiii",
     "_ZN47_GLOBAL__N__14_crop_resize_cu_118ef53d19crop_weights_"
     "kernelEPKfPfS2_iiiii")])
def test_kernel_label_demangles_the_ports_kernels(mangled, label):
    assert _build.kernel_label(mangled) == label


def test_build_log_reads_the_log_beside_a_library_built_earlier(
        tmp_path, monkeypatch):
    libs = {"built": tmp_path / "built-0123.so", "bare": tmp_path / "bare.so"}
    (tmp_path / "built-0123.log").write_text(PTXAS_LOG)
    monkeypatch.setattr(_build, "build_all", lambda: libs)
    monkeypatch.setattr(_build, "build_logs", {})
    assert _build.ptxas_usage(_build.build_log("built"))[
        "cmx::conv3x3_mma_kernel<true,true>"] == (128, 8, 8)
    assert _build.build_log("bare") == ""


@pytest.mark.parametrize("lib", sorted(_build._SIGNATURES))
def test_c_entry_points_take_the_signatures_ctypes_gives_them(lib):
    """Every `extern "C"` function of csrc/<lib>.cu and the headers it
    includes is in `_SIGNATURES`, with a pointer ("p") where the C function
    takes one and an int ("i") else: a mismatch would pass a cut pointer or
    a stray argument on the card."""
    src, todo = "", [f"{lib}.cu"]
    while todo:  # the source and the headers it includes
        text = (_build.CSRC / todo.pop()).read_text()
        src += text
        todo += re.findall(r'#include "(\w+\.cuh)"', text)
    found = {}
    for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        args = [a for a in args.split(",") if a.strip() not in ("", "void")]
        found[name] = "".join("p" if "*" in a else "i" for a in args)
    assert found == _build._SIGNATURES[lib]
