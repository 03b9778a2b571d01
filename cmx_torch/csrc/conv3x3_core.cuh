// Direct 3x3 SAME convolution over channel-major (B, C, H, W) bf16 maps,
// shared by the forward kernel (flat_conv_fwd.cu) and the input-gradient
// half of the backward (flat_conv_bwd.cu).
//
// Block: an output tile of TH rows x TW columns x CO_T channels, 256 threads.
// Warp w owns channels [8w, 8w+8) of the tile; lane l owns row l/8 and the
// four adjacent columns 4*(l%8)..+3, so each thread keeps 8x4 fp32
// accumulators. The input is staged CK channels at a time into shared memory
// with a one-pixel halo on every side (zero outside the image), the optional
// pre-norm prologue relu(x*inv+shift)*m applied while staging and rounded to
// bf16 as the TPU kernel does; the weights of the same CK channels for all
// nine taps are staged beside it. All lanes of a warp read the same weight
// (a broadcast), and the products are fp32 FMAs on the CUDA cores.
//
// What bounds it on the H100: at the main path's widths (Cin, Cout in
// 64..128) the conv does ~2*9*Cin flops per output byte, so the work is far
// above the card's ridge point (~295 flop/byte for bf16 tensor cores); the
// bound is the tensor-core rate. This first version uses the CUDA cores
// (67 TFLOP/s fp32 peak), so it runs well above that bound; moving the inner
// product to wgmma/mma.sync with the same staging is the next step.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace cmx {

constexpr int TH = 4;     // output rows per block
constexpr int TW = 32;    // output columns per block
constexpr int CO_T = 64;  // output channels per block
constexpr int CK = 8;     // input channels staged per pass
constexpr int NT = 256;   // threads per block
constexpr int PX = 4;     // adjacent output columns per thread
constexpr int CPT = 8;    // output channels per thread (= per warp)

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// out[n, co, y, x] = sum_{ci, dy, dx} h[n, ci, y+dy-1, x+dx-1] * wk[3dy+dx, ci, co]
// h = src, or with PRENORM bf16(relu(src*inv[ci]+shift[ci]) * mask) inside
// the image and 0 outside it (padding is zero in activated space).
// With STATS: v = (acc + bias[co]) * mask, out = bf16(v), and the block's
// per-channel sum / sum of squares of the fp32 v go to
// part[(n*gridDim.x + blockIdx.x), {0,1}, co].
template <bool PRENORM, bool STATS>
__global__ void __launch_bounds__(NT) conv3x3_kernel(
    const __nv_bfloat16* __restrict__ src,   // (B, Cin, H, W)
    const __nv_bfloat16* __restrict__ mask,  // (B, H, W)
    const float* __restrict__ inv,           // (Cin,)   PRENORM only
    const float* __restrict__ shift,         // (Cin,)   PRENORM only
    const __nv_bfloat16* __restrict__ wk,    // (9, Cin, Cout)
    const float* __restrict__ bias,          // (Cout,)  STATS only
    __nv_bfloat16* __restrict__ out,         // (B, Cout, H, W)
    float* __restrict__ part,                // (B*tiles, 2, Cout) STATS only
    int Cin, int Cout, int H, int W) {
  __shared__ float xs[CK][TH + 2][TW + 2];
  __shared__ float ws[9][CK][CO_T];

  const int tiles_x = W / TW;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int co0 = blockIdx.y * CO_T;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int r = lane >> 3;          // output row within the tile
  const int c = (lane & 7) * PX;    // first output column within the tile
  const int cw = warp * CPT;        // first channel within the tile
  const size_t HW = (size_t)H * W;

  float acc[CPT][PX];
#pragma unroll
  for (int o = 0; o < CPT; ++o)
#pragma unroll
    for (int p = 0; p < PX; ++p) acc[o][p] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += CK) {
    for (int i = tid; i < CK * (TH + 2) * (TW + 2); i += NT) {
      const int k = i / ((TH + 2) * (TW + 2));
      const int rem = i % ((TH + 2) * (TW + 2));
      const int yy = rem / (TW + 2), xx = rem % (TW + 2);
      const int gy = ty0 + yy - 1, gx = tx0 + xx - 1;
      const int ci = ci0 + k;
      float v = 0.f;
      if (ci < Cin && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const size_t pix = (size_t)gy * W + gx;
        v = __bfloat162float(src[((size_t)n * Cin + ci) * HW + pix]);
        if (PRENORM) {
          const float mv = __bfloat162float(mask[(size_t)n * HW + pix]);
          // separate roundings, as the plain version's two tensor ops
          v = __fadd_rn(__fmul_rn(v, inv[ci]), shift[ci]);
          v = bf16_round(__fmul_rn(fmaxf(v, 0.f), mv));
        }
      }
      xs[k][yy][xx] = v;
    }
    for (int i = tid; i < 9 * CK * CO_T; i += NT) {
      const int t = i / (CK * CO_T);
      const int rem = i % (CK * CO_T);
      const int k = rem / CO_T, co = rem % CO_T;
      const int ci = ci0 + k, gco = co0 + co;
      float v = 0.f;
      if (ci < Cin && gco < Cout)
        v = __bfloat162float(wk[((size_t)t * Cin + ci) * Cout + gco]);
      ws[t][k][co] = v;
    }
    __syncthreads();
#pragma unroll 2
    for (int k = 0; k < CK; ++k) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float xv[PX + 2];
#pragma unroll
        for (int j = 0; j < PX + 2; ++j) xv[j] = xs[k][r + dy][c + j];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
          for (int o = 0; o < CPT; ++o) {
            const float wv = ws[dy * 3 + dx][k][cw + o];
#pragma unroll
            for (int p = 0; p < PX; ++p)
              acc[o][p] = fmaf(wv, xv[p + dx], acc[o][p]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int gy = ty0 + r;
  const int gx = tx0 + c;
  float mv[PX];
  if (STATS) {
#pragma unroll
    for (int p = 0; p < PX; ++p)
      mv[p] = __bfloat162float(mask[(size_t)n * HW + (size_t)gy * W + gx + p]);
  }
#pragma unroll
  for (int o = 0; o < CPT; ++o) {
    const int co = co0 + cw + o;  // uniform across the warp
    float s = 0.f, q = 0.f;
    if (co < Cout) {
      const float b = STATS ? bias[co] : 0.f;
      __nv_bfloat16* dst = out + ((size_t)n * Cout + co) * HW + (size_t)gy * W + gx;
#pragma unroll
      for (int p = 0; p < PX; ++p) {
        float v = acc[o][p];
        if (STATS) {
          v = (v + b) * mv[p];
          s += v;
          q += v * v;
        }
        dst[p] = __float2bfloat16(v);
      }
    }
    if (STATS) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        q += __shfl_xor_sync(0xffffffffu, q, off);
      }
      if (lane == 0 && co < Cout) {
        const size_t blk = (size_t)n * gridDim.x + blockIdx.x;
        part[(blk * 2 + 0) * Cout + co] = s;
        part[(blk * 2 + 1) * Cout + co] = q;
      }
    }
  }
}

// Launch over the whole (B, Cout, H, W) output. H % TH == 0 and W % TW == 0
// are checked by the Python wrapper.
template <bool PRENORM, bool STATS>
inline cudaError_t launch_conv3x3(const __nv_bfloat16* src,
                                  const __nv_bfloat16* mask, const float* inv,
                                  const float* shift, const __nv_bfloat16* wk,
                                  const float* bias, __nv_bfloat16* out,
                                  float* part, int B, int Cin, int Cout, int H,
                                  int W, cudaStream_t stream) {
  dim3 grid((H / TH) * (W / TW), (Cout + CO_T - 1) / CO_T, B);
  conv3x3_kernel<PRENORM, STATS><<<grid, NT, 0, stream>>>(
      src, mask, inv, shift, wk, bias, out, part, Cin, Cout, H, W);
  return cudaGetLastError();
}

}  // namespace cmx
