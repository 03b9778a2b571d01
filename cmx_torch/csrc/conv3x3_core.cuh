// Direct 3x3 SAME convolution over bf16 activation maps, channel-major
// (B, C, H, W) or channels-last (B, H, W, C), on the CUDA cores: the conv of
// K1 (flat_conv_fwd.cu) and the input-gradient half of K2's backward
// (conv3x3_bwd.cuh). It now serves K1/K2 only: the NHWC kernels K7/K8 run
// their products on the tensor cores (conv3x3_mma.cuh), which takes only
// the helpers below (prenorm, pack8/unpack8, aligned16) from this file.
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
// Channels-last: a pixel's CK = 8 channels are 16 contiguous bytes, so one
// thread stages a halo pixel with one 16-byte load (when Cin % 8 == 0), and
// a thread stores its 8 channels of an output pixel with one 16-byte store
// (when Cout % 8 == 0). Tiles that overhang the right or bottom image edge
// are masked, so W need not be a multiple of TW.
//
// What bounds it on the H100: at the main path's widths (Cin, Cout in
// 64..128) the conv does ~2*9*Cin flops per output byte, so the work is far
// above the card's ridge point (~295 flop/byte for bf16 tensor cores); the
// bound is the tensor-core rate. This version uses the CUDA cores (67
// TFLOP/s fp32 peak), so it runs well above that bound; conv3x3_mma.cuh
// moved K7/K8 to the tensor cores, and the channel-major K1/K2 wait for
// their own tensor-core staging (ROADMAP.md).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

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

// The pre-norm prologue bf16(relu(v*inv+shift) * m), each operation rounded
// on its own, as the plain version's separate tensor ops.
__device__ __forceinline__ float prenorm(float v, float inv, float shift,
                                         float m) {
  v = __fadd_rn(__fmul_rn(v, inv), shift);
  return bf16_round(__fmul_rn(fmaxf(v, 0.f), m));
}

// 8 bf16 values <-> one 16-byte word.
__device__ __forceinline__ void unpack8(uint4 u, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  return u;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// out[n, y, x, co] = sum_{ci, dy, dx} h[n, y+dy-1, x+dx-1, ci] * wk[3dy+dx, ci, co]
// (indices written channels-last; NHWC picks the memory layout of src and
// out). h = src, or with PRENORM bf16(relu(src*inv[ci]+shift[ci]) * mask)
// inside the image and 0 outside it (padding is zero in activated space).
// With STATS: v = (acc + bias[co]) * mask, out = bf16(v), and the block's
// per-channel sum / sum of squares of the fp32 v go to
// part[(n*gridDim.x + blockIdx.x), {0,1}, co].
// vec_in / vec_out (channels-last only): 16-byte loads of 8 input channels /
// stores of 8 output channels; the launcher sets them when the channel count
// is a multiple of 8 and the pointer 16-byte aligned.
template <bool NHWC, bool PRENORM, bool STATS>
__global__ void __launch_bounds__(NT) conv3x3_kernel(
    const __nv_bfloat16* __restrict__ src,   // (B, Cin, H, W) or (B, H, W, Cin)
    const __nv_bfloat16* __restrict__ mask,  // (B, H, W)
    const float* __restrict__ inv,           // (Cin,)   PRENORM only
    const float* __restrict__ shift,         // (Cin,)   PRENORM only
    const __nv_bfloat16* __restrict__ wk,    // (9, Cin, Cout)
    const float* __restrict__ bias,          // (Cout,)  STATS only
    __nv_bfloat16* __restrict__ out,         // (B, Cout, H, W) or (B, H, W, Cout)
    float* __restrict__ part,                // (B*tiles, 2, Cout) STATS only
    int Cin, int Cout, int H, int W, int vec_in, int vec_out) {
  __shared__ float xs[CK][TH + 2][TW + 2];
  __shared__ float ws[9][CK][CO_T];

  const int tiles_x = (W + TW - 1) / TW;
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
    if constexpr (NHWC) {
      // one thread per halo pixel: its CK channels
      for (int i = tid; i < (TH + 2) * (TW + 2); i += NT) {
        const int yy = i / (TW + 2), xx = i % (TW + 2);
        const int gy = ty0 + yy - 1, gx = tx0 + xx - 1;
        float v[CK];
#pragma unroll
        for (int k = 0; k < CK; ++k) v[k] = 0.f;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
          const size_t pix = ((size_t)n * H + gy) * W + gx;
          const __nv_bfloat16* p = src + pix * Cin + ci0;
          if (vec_in) {
            unpack8(*reinterpret_cast<const uint4*>(p), v);
          } else {
#pragma unroll
            for (int k = 0; k < CK; ++k)
              if (ci0 + k < Cin) v[k] = __bfloat162float(p[k]);
          }
          if (PRENORM) {
            const float mv = __bfloat162float(mask[pix]);
#pragma unroll
            for (int k = 0; k < CK; ++k)
              if (ci0 + k < Cin)
                v[k] = prenorm(v[k], inv[ci0 + k], shift[ci0 + k], mv);
          }
        }
#pragma unroll
        for (int k = 0; k < CK; ++k) xs[k][yy][xx] = v[k];
      }
    } else {
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
          if (PRENORM)
            v = prenorm(v, inv[ci], shift[ci],
                        __bfloat162float(mask[(size_t)n * HW + pix]));
        }
        xs[k][yy][xx] = v;
      }
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
  bool in[PX];
  float mv[PX];
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int gx = tx0 + c + p;
    in[p] = gy < H && gx < W;
    mv[p] = (STATS && in[p])
                ? __bfloat162float(mask[((size_t)n * H + gy) * W + gx])
                : 0.f;
  }
  if (STATS) {
#pragma unroll
    for (int o = 0; o < CPT; ++o) {
      const int co = co0 + cw + o;  // uniform across the warp
      const float b = co < Cout ? bias[co] : 0.f;
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int p = 0; p < PX; ++p) {
        const float v = (acc[o][p] + b) * mv[p];
        acc[o][p] = v;
        s += v;
        q += v * v;
      }
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
  if constexpr (NHWC) {
    const int cb = co0 + cw;
    if (cb < Cout) {
#pragma unroll
      for (int p = 0; p < PX; ++p) {
        if (!in[p]) continue;
        __nv_bfloat16* dst =
            out + (((size_t)n * H + gy) * W + tx0 + c + p) * Cout + cb;
        if (vec_out) {
          float v[CPT];
#pragma unroll
          for (int o = 0; o < CPT; ++o) v[o] = acc[o][p];
          *reinterpret_cast<uint4*>(dst) = pack8(v);
        } else {
#pragma unroll
          for (int o = 0; o < CPT; ++o)
            if (cb + o < Cout) dst[o] = __float2bfloat16(acc[o][p]);
        }
      }
    }
  } else {
#pragma unroll
    for (int o = 0; o < CPT; ++o) {
      const int co = co0 + cw + o;
      if (co >= Cout) continue;
      __nv_bfloat16* dst =
          out + ((size_t)n * Cout + co) * HW + (size_t)gy * W + tx0 + c;
#pragma unroll
      for (int p = 0; p < PX; ++p)
        if (in[p]) dst[p] = __float2bfloat16(acc[o][p]);
    }
  }
}

// Launch over the whole output; the wrappers check the shapes (channel-major:
// H % TH == 0 and W % TW == 0; channels-last: H % 32 == 0 and W % 8 == 0).
// part, with STATS, holds B * ceil(H/TH) * ceil(W/TW) rows.
template <bool NHWC, bool PRENORM, bool STATS>
inline cudaError_t launch_conv3x3(const __nv_bfloat16* src,
                                  const __nv_bfloat16* mask, const float* inv,
                                  const float* shift, const __nv_bfloat16* wk,
                                  const float* bias, __nv_bfloat16* out,
                                  float* part, int B, int Cin, int Cout, int H,
                                  int W, cudaStream_t stream) {
  const int tiles = ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  dim3 grid(tiles, (Cout + CO_T - 1) / CO_T, B);
  const int vec_in = NHWC && Cin % CK == 0 && aligned16(src);
  const int vec_out = NHWC && Cout % CPT == 0 && aligned16(out);
  conv3x3_kernel<NHWC, PRENORM, STATS><<<grid, NT, 0, stream>>>(
      src, mask, inv, shift, wk, bias, out, part, Cin, Cout, H, W, vec_in,
      vec_out);
  return cudaGetLastError();
}

}  // namespace cmx
