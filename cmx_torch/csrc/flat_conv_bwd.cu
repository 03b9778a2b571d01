// K2: one masked DoubleConv stage backward on the H100.
//
// Replaces the TPU kernel cmx/ops/fused_conv_flat.py::flat_bwd_mega
// (_flat_bwd_kernel), the backward of flat_double_conv, over channel-major
// (B, C, H*W) maps. Three launches on the caller's stream compute what the
// mega-kernel computes: the masked-BN dy, dX (skipped when the caller needs
// no input gradient) and dW as fp32 partials; the kernels, what bounds them
// and their design are in conv3x3_bwd.cuh.
#include "conv3x3_bwd.cuh"

// g, y: (B, Cout, H, W) bf16; src: (B, Cin, H, W) bf16; mask (B, H, W) bf16;
// vecs (6, Cout) fp32; prev_inv / prev_shift (Cin,) fp32 when pre_h;
// wt (9, Cout, Cin) bf16 = flipped, channel-transposed weights;
// dy_buf (B, Cout, H, W) bf16 scratch; dh (B, Cin, H, W) bf16 when need_dx;
// dw_part (nchunks, 9, Cin, Cout) fp32.
extern "C" int cmx_flat_bwd(const void* g, const void* y, const void* src,
                            const void* mask, const void* vecs,
                            const void* prev_inv, const void* prev_shift,
                            const void* wt, void* dy_buf, void* dh,
                            void* dw_part, int B, int Cin, int Cout, int H,
                            int W, int pre_h, int need_dx, int nchunks,
                            int tiles_per_chunk, void* stream) {
  return static_cast<int>(cmx::stage_bwd<false>(
      g, y, src, mask, vecs, prev_inv, prev_shift, wt, dy_buf, dh, dw_part, B,
      Cin, Cout, H, W, pre_h, need_dx, nchunks, tiles_per_chunk,
      static_cast<cudaStream_t>(stream)));
}
