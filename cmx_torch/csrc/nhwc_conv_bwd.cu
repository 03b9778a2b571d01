// K8: one masked DoubleConv stage backward on the H100, channels-last.
//
// Replaces the TPU kernel cmx/ops/fused_conv.py::bwd_mega (_bwd_mega_kernel),
// K2 in NHWC: the masked-BN dy = (m*inv)*(dz - s1/nact - xhat*s2/nact) with
// dz = g*m*[y*inv+shift > 0], rounded to bf16; dX = conv(dy, flipped and
// channel-transposed w), bf16; dW = sum over pixels of h-tap (x) dy in fp32,
// h recomputed as bf16(relu(src*inv_p+shift_p)*m) when prev_fold is given.
//
// Bound on the card: the two products (dX, dW), 4*9*Cin*Cout flops a pixel,
// tensor-core bound at the main path's widths; dy is one elementwise pass
// (bytes). Design: three launches on the caller's stream, the products on
// the tensor cores (conv3x3_mma.cuh):
//   1. dy: bn_bwd_dy_nhwc_kernel, 8 channels (16 bytes) a thread, written
//      once in bf16 (the TPU kernel kept dy in VMEM; here it makes one round
//      trip through device memory); the element-wise bn_bwd_dy_kernel
//      when Cout % 8 != 0;
//   2. dX: K7's implicit GEMM (conv3x3_mma_kernel) over dy with the packed
//      flipped, channel-transposed weights, no prologue, no stats;
//   3. dW: conv3x3_dw_mma_kernel, pixels as the GEMM's K dimension, h
//      pre-normed while staging when prev_fold is given. The TPU kernel
//      wrote one dW partial per grid step; here each block writes one for
//      its run of pixel tiles (a grid of one wave of resident blocks) and the
//      wrapper sums them (no atomics, deterministic).
// Tiles overhanging the right image edge are masked, so any W % 8 == 0 runs.
#include <climits>

#include "conv3x3_mma.cuh"

namespace cmx {

// dy for a Cout that is not a multiple of 8: the masked-BN input gradient
// over channels-last (P, C) maps, one element a thread:
//   dz = g*m*[y*inv+shift > 0],  xh = (y-mean)*rr,
//   dy = bf16((m*inv) * (dz - s1/nact - xh*s2/nact)),
// vecs (6, C) fp32 rows inv, shift, mean, rr, s1/nact, s2/nact; total =
// P*C. The vectorized passes (bn_bwd_dy_nhwc_kernel below, flat_conv_bwd.cu's
// bn_bwd_dy_cm_kernel) round each operation in this order too.
__global__ void bn_bwd_dy_kernel(const __nv_bfloat16* __restrict__ g,
                                 const __nv_bfloat16* __restrict__ y,
                                 const __nv_bfloat16* __restrict__ mask,
                                 const float* __restrict__ vecs,
                                 __nv_bfloat16* __restrict__ dy, int C,
                                 size_t total) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    const size_t pix = i / C;  // the mask's index
    const float inv = vecs[c], shift = vecs[C + c], mean = vecs[2 * C + c];
    const float rr = vecs[3 * C + c], s1n = vecs[4 * C + c];
    const float s2n = vecs[5 * C + c];
    const float gv = __bfloat162float(g[i]);
    const float yv = __bfloat162float(y[i]);
    const float mv = __bfloat162float(mask[pix]);
    // Each operation rounds on its own, in the plain version's order.
    const bool gate = __fadd_rn(__fmul_rn(yv, inv), shift) > 0.f;
    const float dz = __fmul_rn(__fmul_rn(gv, mv), gate ? 1.f : 0.f);
    const float xh = __fmul_rn(__fsub_rn(yv, mean), rr);
    const float t = __fsub_rn(__fsub_rn(dz, s1n), __fmul_rn(xh, s2n));
    dy[i] = __float2bfloat16(__fmul_rn(__fmul_rn(mv, inv), t));
  }
}

// dy: bn_bwd_dy_kernel, each operation rounded in the same
// order, 8 channels (16 bytes) a thread with the six per-channel vectors in
// shared memory. g, y, dy (P, C) bf16 with C % 8 == 0 and 16-byte aligned
// rows; mask (P,); vecs (6, C) fp32 rows inv, shift, mean, rr, s1/nact,
// s2/nact. n8 = P*C/8.
__global__ void __launch_bounds__(256) bn_bwd_dy_nhwc_kernel(
    const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ y,
    const __nv_bfloat16* __restrict__ mask, const float* __restrict__ vecs,
    __nv_bfloat16* __restrict__ dy, int C, int n8) {
  extern __shared__ float sv[];
  for (int i = threadIdx.x; i < 6 * C; i += blockDim.x) sv[i] = vecs[i];
  __syncthreads();
  const int G = C / 8;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n8;
       i += gridDim.x * blockDim.x) {
    const int pix = i / G, c0 = (i - pix * G) * 8;
    float gv[8], yv[8], o[8];
    unpack8(reinterpret_cast<const uint4*>(g)[i], gv);
    unpack8(reinterpret_cast<const uint4*>(y)[i], yv);
    const float mv = __bfloat162float(mask[pix]);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = c0 + k;
      const float inv = sv[c], shift = sv[C + c], mean = sv[2 * C + c];
      const float rr = sv[3 * C + c], s1n = sv[4 * C + c], s2n = sv[5 * C + c];
      // Each operation rounds on its own, in bn_bwd_dy_kernel's order.
      const bool gate = __fadd_rn(__fmul_rn(yv[k], inv), shift) > 0.f;
      const float dz = __fmul_rn(__fmul_rn(gv[k], mv), gate ? 1.f : 0.f);
      const float xh = __fmul_rn(__fsub_rn(yv[k], mean), rr);
      const float t = __fsub_rn(__fsub_rn(dz, s1n), __fmul_rn(xh, s2n));
      o[k] = __fmul_rn(__fmul_rn(mv, inv), t);
    }
    reinterpret_cast<uint4*>(dy)[i] = pack8(o);
  }
}

}  // namespace cmx

// g, y: (B, H, W, Cout) bf16; src: (B, H, W, Cin) bf16; mask (B, H, W) bf16;
// vecs (6, Cout) fp32; prev_inv / prev_shift (Cin,) fp32 when pre_h;
// wtpack the (ceil(Cin/64), ceil(Cout/16), 9, 16, 64) packing of the
// (9, Cout, Cin) bf16 flipped, channel-transposed weights; dy_buf (B, H, W,
// Cout) bf16 scratch; dh (B, H, W, Cin) bf16; dw_part (nchunks, 9, Cin,
// Cout) fp32 over B * (H/4) * ceil(W/32) pixel tiles in runs of
// tiles_per_chunk.
extern "C" int cmx_nhwc_bwd(const void* g, const void* y, const void* src,
                            const void* mask, const void* vecs,
                            const void* prev_inv, const void* prev_shift,
                            const void* wtpack, void* dy_buf, void* dh,
                            void* dw_part, int B, int Cin, int Cout, int H,
                            int W, int pre_h, int nchunks, int tiles_per_chunk,
                            void* stream) {
  using namespace cmx;
  auto s = static_cast<cudaStream_t>(stream);
  auto bf = [](const void* p) { return static_cast<const __nv_bfloat16*>(p); };
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  auto dyp = static_cast<__nv_bfloat16*>(dy_buf);

  const size_t P = (size_t)B * H * W;
  const size_t n8 = P * Cout / 8;
  if (Cout % 8 == 0 && aligned16(g) && aligned16(y) && aligned16(dy_buf) &&
      n8 < (size_t)INT_MAX) {
    const size_t want = (n8 + 255) / 256;
    const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
    bn_bwd_dy_nhwc_kernel<<<blocks, 256, 6 * Cout * sizeof(float), s>>>(
        bf(g), bf(y), bf(mask), f32(vecs), dyp, Cout, (int)n8);
  } else {
    const size_t total = P * Cout;
    const int blocks = (int)((total + 255) / 256 < 132 * 32
                                 ? (total + 255) / 256
                                 : 132 * 32);
    bn_bwd_dy_kernel<<<blocks, 256, 0, s>>>(bf(g), bf(y), bf(mask), f32(vecs),
                                            dyp, Cout, total);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = launch_conv3x3_mma<false, false, false>(
      dyp, nullptr, nullptr, nullptr, bf(wtpack), nullptr,
      static_cast<__nv_bfloat16*>(dh), nullptr, B, Cout, Cin, H, W, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  auto part = static_cast<float*>(dw_part);
  if (pre_h)
    err = launch_dw_mma<false, true>(bf(src), bf(mask), f32(prev_inv),
                                     f32(prev_shift), dyp, part, B, Cin, Cout,
                                     H, W, nchunks, tiles_per_chunk, s);
  else
    err = launch_dw_mma<false, false>(bf(src), bf(mask), nullptr, nullptr, dyp,
                                      part, B, Cin, Cout, H, W, nchunks,
                                      tiles_per_chunk, s);
  return static_cast<int>(err);
}

// Resident blocks a multiprocessor of the dW kernel (with or without the
// pre-norm prologue), 0 on error: the wrapper sizes the split-K grid by it.
extern "C" int cmx_dw_blocks_per_sm(int pre_h) {
  return pre_h ? cmx::dw_mma_blocks_per_sm<false, true>()
               : cmx::dw_mma_blocks_per_sm<false, false>();
}
