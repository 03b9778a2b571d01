// K8: one masked DoubleConv stage backward on the H100, channels-last.
//
// Replaces the TPU kernel cmx/ops/fused_conv.py::bwd_mega (_bwd_mega_kernel),
// K2 in NHWC: the masked-BN dy = (m*inv)*(dz - s1/nact - xhat*s2/nact) with
// dz = g*m*[y*inv+shift > 0], rounded to bf16; dX = conv(dy, flipped and
// channel-transposed w), bf16; dW = sum over pixels of h-tap (x) dy in fp32,
// h recomputed as bf16(relu(src*inv_p+shift_p)*m) when prev_fold is given.
//
// Bound on the card: the two products (dX, dW), 4*9*Cin*Cout flops a pixel,
// tensor-core bound at the main path's widths; dy is one elementwise pass.
// Design: the three launches of conv3x3_bwd.cuh in their channels-last form
// (K2's split: the TPU kernel kept dy in VMEM, here it makes one bf16 round
// trip through device memory). A pixel's channels are contiguous, so the
// dW kernel stages 8 input channels of a halo pixel with one 16-byte load
// and reads the dy tile along channels; the dX conv is the forward core of
// conv3x3_core.cuh in NHWC. The TPU kernel wrote one dW partial per grid
// step; here each block writes one for its run of pixel tiles and the
// wrapper sums them (no atomics, deterministic). Tiles overhanging the
// right image edge are masked, so any W % 8 == 0 runs.
#include "conv3x3_bwd.cuh"

// g, y: (B, H, W, Cout) bf16; src: (B, H, W, Cin) bf16; mask (B, H, W) bf16;
// vecs (6, Cout) fp32; prev_inv / prev_shift (Cin,) fp32 when pre_h;
// wt (9, Cout, Cin) bf16; dy_buf (B, H, W, Cout) bf16 scratch;
// dh (B, H, W, Cin) bf16; dw_part (nchunks, 9, Cin, Cout) fp32.
extern "C" int cmx_nhwc_bwd(const void* g, const void* y, const void* src,
                            const void* mask, const void* vecs,
                            const void* prev_inv, const void* prev_shift,
                            const void* wt, void* dy_buf, void* dh,
                            void* dw_part, int B, int Cin, int Cout, int H,
                            int W, int pre_h, int nchunks, int tiles_per_chunk,
                            void* stream) {
  return static_cast<int>(cmx::stage_bwd<true>(
      g, y, src, mask, vecs, prev_inv, prev_shift, wt, dy_buf, dh, dw_part, B,
      Cin, Cout, H, W, pre_h, 1, nchunks, tiles_per_chunk,
      static_cast<cudaStream_t>(stream)));
}
