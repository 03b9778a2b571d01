// K6 and K7: one masked DoubleConv stage forward on the H100, channels-last.
//
// K7 replaces the TPU kernel cmx/ops/fused_conv.py::conv3x3_mask_stats
// (_conv_kernel, whose _conv_strip is nine shifted MXU dots): optional
// pre-norm prologue bf16(relu(src*inv+shift)*m) on the input (halo pixels
// included), 3x3 SAME conv with bf16 operands and fp32 sums, + bias in fp32,
// re-mask, bf16 store, per-channel sum / sum of squares of the masked fp32
// result.
// Bound on the card: tensor-core flops at the main path's widths. Design:
// the implicit GEMM of conv3x3_mma.cuh on the tensor cores (mma.sync
// m16n8k16, ldmatrix from a cp.async two-stage ring of halo tiles and
// packed weights). The TPU kernel received its strip's halo rows as
// separate pre-sliced inputs (a Mosaic workaround); here a block reads its
// halo pixels from the tensor itself, 16 bytes (8 channels) a copy, and
// zeroes the image border. Each block writes per-channel partial sums and
// the wrapper sums them (deterministic, no atomics).
//
// K6 replaces cmx/ops/fused_conv.py::conv_stem_stats (_stem_kernel): the
// Cin=1 stem as a 9-tap product per pixel, y = (patches . w + b) * m with w
// (9, C) in tap order dy*3+dx, bf16 y, and K7's stats.
// Bound on the card: bytes. It reads 18 bytes of patches and 2 of mask a
// pixel and writes 2*C bytes of y (C = 64: 148 bytes against 1,152 flops).
// Design: the weights and bias sit in shared memory; the threads of a block
// are laid out (pixel, group of 8 channels) with the channel group fastest,
// so a warp writes whole contiguous runs of y in 16-byte stores and the
// pixels' patches (shared by the threads of a pixel) come from L1. Each
// thread keeps its 8 channels' sums over a grid-stride loop of pixels; the
// block reduces them in shared memory and writes one partial row.
#include "conv3x3_mma.cuh"

namespace cmx {

constexpr int STEM_NT = 256;

// patches (P, 9) bf16, mask (P,) bf16, w (9, C) bf16, bias (C,) fp32 ->
// y (P, C) bf16, part (gridDim.x, 2, C) fp32. Needs ceil(C/8) <= STEM_NT
// and (10*C + 2*ppb*8*ceil(C/8)) floats of dynamic shared memory.
__global__ void __launch_bounds__(STEM_NT) stem_kernel(
    const __nv_bfloat16* __restrict__ patches,
    const __nv_bfloat16* __restrict__ mask, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
    float* __restrict__ part, long long P, int C, int vec_out) {
  extern __shared__ float sm[];
  const int G = (C + 7) / 8;        // channel groups
  const int ppb = STEM_NT / G;      // pixels a block works on at once
  float* ws = sm;                   // (9, C)
  float* bs = ws + 9 * C;           // (C,)
  float* red = bs + C;              // (2, ppb, 8*G)
  const int tid = threadIdx.x;
  const int g = tid % G, pl = tid / G;
  const int cb = g * 8;

  for (int i = tid; i < 9 * C; i += STEM_NT) ws[i] = __bfloat162float(w[i]);
  for (int i = tid; i < C; i += STEM_NT) bs[i] = bias[i];
  __syncthreads();

  float s[8], q[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = q[j] = 0.f;
  if (pl < ppb) {
    for (long long p = (long long)blockIdx.x * ppb + pl; p < P;
         p += (long long)gridDim.x * ppb) {
      float pv[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) pv[t] = __bfloat162float(patches[p * 9 + t]);
      const float mv = __bfloat162float(mask[p]);
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int co = cb + j;
        v[j] = 0.f;
        if (co < C) {
          float acc = 0.f;
#pragma unroll
          for (int t = 0; t < 9; ++t) acc = fmaf(pv[t], ws[t * C + co], acc);
          v[j] = (acc + bs[co]) * mv;
          s[j] += v[j];
          q[j] += v[j] * v[j];
        }
      }
      __nv_bfloat16* dst = y + p * C + cb;
      if (vec_out) {
        *reinterpret_cast<uint4*>(dst) = pack8(v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (cb + j < C) dst[j] = __float2bfloat16(v[j]);
      }
    }
    const int ld = 8 * G;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red[pl * ld + cb + j] = s[j];
      red[(ppb + pl) * ld + cb + j] = q[j];
    }
  }
  __syncthreads();
  for (int co = tid; co < C; co += STEM_NT) {
    float S = 0.f, Q = 0.f;
    for (int i = 0; i < ppb; ++i) {
      S += red[i * 8 * G + co];
      Q += red[(ppb + i) * 8 * G + co];
    }
    part[((size_t)blockIdx.x * 2 + 0) * C + co] = S;
    part[((size_t)blockIdx.x * 2 + 1) * C + co] = Q;
  }
}

}  // namespace cmx

// K7. src (B, H, W, Cin) bf16, mask (B, H, W) bf16, inv / shift (Cin,) fp32
// when prenorm, wpack the (ceil(Cout/64), ceil(Cin/16), 9, 16, 64) packing
// of the (9, Cin, Cout) bf16 weights, bias (Cout,) fp32 -> y (B, H, W,
// Cout) bf16, part (B * (H/8) * ceil(W/32), 2, Cout) fp32.
extern "C" int cmx_nhwc_conv_fwd(const void* src, const void* mask,
                                 const void* inv, const void* shift,
                                 const void* wpack, const void* bias, void* y,
                                 void* part, int B, int Cin, int Cout, int H,
                                 int W, int prenorm, void* stream) {
  using namespace cmx;
  auto s = static_cast<cudaStream_t>(stream);
  auto src_ = static_cast<const __nv_bfloat16*>(src);
  auto mask_ = static_cast<const __nv_bfloat16*>(mask);
  auto wp_ = static_cast<const __nv_bfloat16*>(wpack);
  auto y_ = static_cast<__nv_bfloat16*>(y);
  auto inv_ = static_cast<const float*>(inv);
  auto shift_ = static_cast<const float*>(shift);
  auto bias_ = static_cast<const float*>(bias);
  auto part_ = static_cast<float*>(part);
  cudaError_t err;
  if (prenorm)
    err = launch_conv3x3_mma<false, true, true>(src_, mask_, inv_, shift_, wp_,
                                                bias_, y_, part_, B, Cin, Cout,
                                                H, W, s);
  else
    err = launch_conv3x3_mma<false, false, true>(src_, mask_, inv_, shift_, wp_,
                                                 bias_, y_, part_, B, Cin, Cout,
                                                 H, W, s);
  return static_cast<int>(err);
}

// K6. patches (P, 9) bf16, mask (P,) bf16, w (9, C) bf16, bias (C,) fp32 ->
// y (P, C) bf16, part (nblk, 2, C) fp32; P = B*H*W pixels, C <= 512.
extern "C" int cmx_nhwc_stem(const void* patches, const void* mask,
                             const void* w, const void* bias, void* y,
                             void* part, int P, int C, int nblk,
                             void* stream) {
  using namespace cmx;
  const int G = (C + 7) / 8;
  const int ppb = STEM_NT / G;
  const size_t smem = sizeof(float) * (10 * (size_t)C + 2 * (size_t)ppb * 8 * G);
  const int vec_out = C % 8 == 0 && aligned16(y);
  stem_kernel<<<nblk, STEM_NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(patches),
      static_cast<const __nv_bfloat16*>(mask),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(part), P, C,
      vec_out);
  return static_cast<int>(cudaGetLastError());
}
