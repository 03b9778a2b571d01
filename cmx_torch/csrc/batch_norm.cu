// The port's batch norm (models/blocks.py MaskedBatchNorm) on the H100: the
// moments, the normalisation with its ReLU and re-mask, and the two passes of
// its backward, over an activation that is either channels-last rows or
// channel-major planes.
//
// Replaces no TPU kernel. cmx computes MaskedBatchNorm's moments and its
// normalisation as XLA element-wise and reduction ops, which XLA fuses on
// the TPU; in PyTorch the same composition was 6-8 element-wise passes and
// three reductions an activation, most of them over fp32 copies, and as
// many again backward. Four device passes do the same work here:
//   * kMoments: sum over positions of d = (x - s) m, d^2 and m, per channel
//     (s the variant's shift, m the mask, 1 without one);
//   * kApply: y = T(T(x inv_t) + shift_t) (the two roundings of PyTorch's
//     `x.to(T) * inv + shift` in T), then, where the caller asks for the
//     DoubleConv's epilogue (`relu`), max(y, 0) m: the ReLU and the
//     re-mask;
//   * kGradSums: g = dy, or under the epilogue dy m gate (the ReLU's gate
//     recomputed from x with the forward's roundings), sums of g and
//     g (x - mean) per channel: the gradients of the norm's bias and scale
//     (the latter over rstd);
//   * kGradInput: dx = inv g - m (k1 + k2 (x - mean)), in x's type: the
//     gradient through the batch moments, k1 and k2 folded on the host from
//     the global sums (0 with the running statistics).
// The two sum passes write per-block partials; norm_finalize_kernel adds
// them in a fixed order (each thread a strided run of blocks, then a
// halving tree), so a replay gives the same bits every run: no atomics.
//
// Bound on the card: bytes. A value is 2 bytes in bf16; the forward reads
// x twice and writes y once (6 bytes a value), the backward reads dy and x
// twice and writes dx once (10 bytes a value); the mask is one value a row
// (a pixel), the per-channel constants and partials are small. About ten
// flops a value, far under the fp32 peak.
//
// Design. One block is kThreads threads; a thread issues the loads of
// kUnroll rows (units) before their arithmetic, so enough bytes are in
// flight to keep HBM busy at two resident blocks an SM (the grad passes
// hold 48 per-channel constants and need ~128 registers); bf16 roundings
// are packed conversions, two values each.
//   * Channels-last (x as (B H W, C) rows): a thread owns 8 channels (one
//     16-byte load in bf16, two in fp32) and walks K rows of its block,
//     TY rows apart; TX = min(ceil(C/8), 32) threads cover a row's channel
//     groups side by side, so a warp reads whole rows, contiguous; grid.y
//     covers channel groups past 32. The mask is one scalar a row, the
//     per-channel constants sit in registers for the whole walk. A sum pass
//     reduces its block's TY rows by a halving tree in shared memory.
//   * Channel-major (x as (B, C, H W) planes: a flat fused block's output):
//     grid.y is the channel; a thread loads 8 neighbouring pixels of the
//     channel (one 16-byte load) with their 8 mask values, K such units
//     kThreads apart; the constants are scalars. A sum pass reduces its
//     256 threads by a halving tree.
// Measured on the H100 (chip_smoke.py's NORM, device time): 75-91% of the
// bytes bound at 224^2 and 112^2, 47-84% at 14^2-56^2.
// K and the number of blocks along x (nbx) come from the host (ops/
// batch_norm.py::sum_geometry), which sizes the partials; the launcher
// checks them against the shape. Without C % 8 == 0 (channels-last) or
// H W % 8 == 0 (channel-major) the loads are scalar, with the same
// arithmetic. The element-wise terms are written with __fmul_rn /
// __fadd_rn / __fsub_rn in the plain versions' order, so nvcc contracts
// none of them and kApply and kGradInput give the plain versions' bits for
// the same constants.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cmx {

constexpr int kThreads = 256;  // a block
constexpr int kVec = 8;        // values a thread loads at once
constexpr int kMaxTX = 32;     // channel groups across a channels-last block
constexpr int kUnroll = 4;     // rows (units) whose loads a thread issues at once

enum Pass { kMoments = 0, kApply = 1, kGradSums = 2, kGradInput = 3 };

// Per-channel constants a pass reads, rows of C floats in this order:
// kMoments: shift; the others: inv_t, shift_t, mean, inv, k1, k2 (a prefix).
template <int kPass>
struct Consts {
  static constexpr int n = kPass == kMoments ? 1 : kPass == kApply ? 2
                           : kPass == kGradSums ? 3 : 6;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T (a store in T) and read back
template <typename T>
__device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// w < 8 values at p into v, the rest 0 (the scalar path)
template <typename T>
__device__ __forceinline__ void load_w(const T* p, int w, float* v) {
#pragma unroll
  for (int i = 0; i < kVec; ++i) v[i] = i < w ? to_f(p[i]) : 0.0f;
}

template <typename T>
__device__ __forceinline__ void store_w(T* p, int w, const float* v) {
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    if (i < w) p[i] = from_f<T>(v[i]);
}

// 8 values of T as one thread loads them (16 bytes in bf16, 32 in fp32)
template <typename T>
struct Raw8;
template <>
struct Raw8<__nv_bfloat16> {
  uint4 u;
};
template <>
struct Raw8<float> {
  float4 a, b;
};

__device__ __forceinline__ void load_raw(const __nv_bfloat16* p,
                                         Raw8<__nv_bfloat16>& r) {
  r.u = *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void load_raw(const float* p, Raw8<float>& r) {
  r.a = *reinterpret_cast<const float4*>(p);
  r.b = *reinterpret_cast<const float4*>(p + 4);
}
__device__ __forceinline__ void unpack(const Raw8<__nv_bfloat16>& r, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const Raw8<float>& r, float* v) {
  v[0] = r.a.x; v[1] = r.a.y; v[2] = r.a.z; v[3] = r.a.w;
  v[4] = r.b.x; v[5] = r.b.y; v[6] = r.b.z; v[7] = r.b.w;
}

// 8 values rounded to T in place (bf16: four packed conversions)
template <typename T>
__device__ __forceinline__ void round8(float* v);
template <>
__device__ __forceinline__ void round8<float>(float*) {}
template <>
__device__ __forceinline__ void round8<__nv_bfloat16>(float* v) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(__floats2bfloat162_rn(v[2 * i], v[2 * i + 1]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// One vector of w values of a pass: x, dy and the mask values m at them,
// the constants k[j][i] of each value's channel. A sum pass adds into a
// and b; an element-wise pass writes y. The normalised value v is
// PyTorch's `x.to(T) * inv_t + shift_t` in T, the product and the sum each
// rounded to T; the gradient reaching it is dy through the re-mask's
// product and the ReLU's gate (a select, as torch's threshold_backward).
template <int kPass, typename T>
__device__ __forceinline__ void vec_op(const float* xv, const float* gv,
                                       const float* mv, float (*k)[kVec],
                                       int w, bool has_mask, bool relu,
                                       float* a, float* b, float* y) {
  if constexpr (kPass == kMoments) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (i >= w) break;
      const float d = __fmul_rn(__fsub_rn(xv[i], k[0][i]), mv[i]);
      a[i] += d;
      b[i] = fmaf(d, d, b[i]);
    }
  } else {
    float v[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = __fmul_rn(xv[i], k[0][i]);
    round8<T>(v);
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = __fadd_rn(v[i], k[1][i]);
    round8<T>(v);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (i >= w) break;
      const float m = mv[i];
      if constexpr (kPass == kApply) {
        float o = v[i];
        if (relu) {  // NaN passes, as torch.relu; m is 1 without a mask
          o = o < 0.0f ? 0.0f : o;
          o = __fmul_rn(o, m);
        }
        y[i] = o;
      } else {
        float g = gv[i];
        if (relu) {
          g = __fmul_rn(g, m);
          if (!(v[i] > 0.0f)) g = 0.0f;
        }
        const float xc = __fsub_rn(xv[i], k[2][i]);
        if constexpr (kPass == kGradSums) {
          a[i] += g;
          b[i] = fmaf(g, xc, b[i]);
        } else {
          const float mm = has_mask ? m : 1.0f;
          const float t = __fadd_rn(k[4][i], __fmul_rn(k[5][i], xc));
          y[i] = __fsub_rn(__fmul_rn(k[3][i], g), __fmul_rn(mm, t));
        }
      }
    }
  }
}

template <int kPass, bool kCL, typename T, typename TM>
__global__ void __launch_bounds__(kThreads, 2)
norm_pass_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                 const TM* __restrict__ mask, const float* __restrict__ cst,
                 T* __restrict__ out, float* __restrict__ part, int B, int C,
                 int P, int K, int nbx, int relu_i) {
  constexpr bool kSums = kPass == kMoments || kPass == kGradSums;
  constexpr bool kGrad = kPass == kGradSums || kPass == kGradInput;
  constexpr int kNc = Consts<kPass>::n;
  __shared__ float sh[2 * kVec + 1][kThreads];
  const bool has_mask = mask != nullptr;
  const bool relu = relu_i != 0;
  float a[kVec], b[kVec], xv[kVec], gv[kVec], mv[kVec], yv[kVec];
  float k[kNc][kVec];
  float cnt = 0.0f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) a[i] = b[i] = xv[i] = gv[i] = mv[i] = yv[i] = 0.0f;
  if constexpr (kCL) {
    // a thread: channels c0 .. c0 + n - 1 of rows r0, r0 + TY, ...
    const int G = (C + kVec - 1) / kVec;
    const int TX = G < kMaxTX ? G : kMaxTX, TY = kThreads / TX;
    const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
    const int c0 = (blockIdx.y * TX + tx) * kVec;
    const int n = max(0, min(kVec, C - c0));
    const bool vec = C % kVec == 0;  // then n is 8 or 0
#pragma unroll
    for (int j = 0; j < kNc; ++j)
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        k[j][i] = i < n ? cst[j * C + c0 + i] : 0.0f;
    const long R = static_cast<long>(B) * P;
    const long r0 = static_cast<long>(blockIdx.x) * TY * K + ty;
    if (ty < TY && n > 0 && vec) {
      // kUnroll rows' loads in flight before their arithmetic
      for (int it = 0; it < K; it += kUnroll) {
        Raw8<T> rx[kUnroll], rg[kUnroll];
        float mu[kUnroll];
        bool ok[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long r = r0 + static_cast<long>(it + u) * TY;
          ok[u] = it + u < K && r < R;
          if (ok[u]) {
            load_raw(x + r * C + c0, rx[u]);
            if constexpr (kGrad) load_raw(dy + r * C + c0, rg[u]);
            mu[u] = has_mask ? to_f(mask[r]) : 1.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (!ok[u]) break;
          const long r = r0 + static_cast<long>(it + u) * TY;
          unpack(rx[u], xv);
          if constexpr (kGrad) unpack(rg[u], gv);
#pragma unroll
          for (int i = 0; i < kVec; ++i) mv[i] = mu[u];
          cnt += mu[u];
          vec_op<kPass, T>(xv, gv, mv, k, kVec, has_mask, relu, a, b,
                           yv);
          if constexpr (!kSums) store8(out + r * C + c0, yv);
        }
      }
    } else if (ty < TY && n > 0) {
      for (int it = 0; it < K; ++it) {
        const long r = r0 + static_cast<long>(it) * TY;
        if (r >= R) break;
        const float m = has_mask ? to_f(mask[r]) : 1.0f;
        cnt += m;
#pragma unroll
        for (int i = 0; i < kVec; ++i) mv[i] = m;
        const long off = r * C + c0;
        load_w(x + off, n, xv);
        if constexpr (kGrad) load_w(dy + off, n, gv);
        vec_op<kPass, T>(xv, gv, mv, k, n, has_mask, relu, a, b, yv);
        if constexpr (!kSums) store_w(out + off, n, yv);
      }
    }
    if constexpr (kSums) {
      // the block's TY rows by a halving tree: rows [h, 2h) onto [0, h)
      int top = 1;
      while (top < TY) top <<= 1;
      for (int h = top >> 1; h > 0; h >>= 1) {
        if (ty >= h && ty < 2 * h && ty < TY) {
          const int s = (ty - h) * TX + tx;
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            sh[i][s] = a[i];
            sh[kVec + i][s] = b[i];
          }
          sh[2 * kVec][s] = cnt;
        }
        __syncthreads();
        if (ty < h && ty + h < TY) {
          const int s = ty * TX + tx;
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            a[i] += sh[i][s];
            b[i] += sh[kVec + i][s];
          }
          cnt += sh[2 * kVec][s];
        }
        __syncthreads();
      }
      if (ty == 0) {
        for (int i = 0; i < n; ++i) {
          part[static_cast<long>(c0 + i) * nbx + blockIdx.x] = a[i];
          part[static_cast<long>(C + c0 + i) * nbx + blockIdx.x] = b[i];
        }
        if (kPass == kMoments && tx == 0 && blockIdx.y == 0)
          part[static_cast<long>(2 * C) * nbx + blockIdx.x] = cnt;
      }
    }
  } else {
    // a thread: units u0, u0 + kThreads, ... of channel c, a unit w
    // neighbouring pixels of one image's plane (8, or 1 where H W % 8)
    const int c = blockIdx.y;
    const int w = P % kVec == 0 ? kVec : 1;
    const bool vec = w == kVec;
    const long PU = P / w;
    const long U = static_cast<long>(B) * PU;
#pragma unroll
    for (int j = 0; j < kNc; ++j) {
      const float v = cst[j * C + c];
#pragma unroll
      for (int i = 0; i < kVec; ++i) k[j][i] = v;
    }
    const long u0 = static_cast<long>(blockIdx.x) * kThreads * K + threadIdx.x;
    if (vec) {
      // kUnroll units' loads in flight before their arithmetic
      const unsigned pu = static_cast<unsigned>(PU);
      for (int it = 0; it < K; it += kUnroll) {
        Raw8<T> rx[kUnroll], rg[kUnroll];
        Raw8<TM> rm[kUnroll];
        long offs[kUnroll];
        bool ok[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long uu = u0 + static_cast<long>(it + u) * kThreads;
          ok[u] = it + u < K && uu < U;
          if (ok[u]) {
            const unsigned img = static_cast<unsigned>(uu) / pu;
            const long p = static_cast<long>(static_cast<unsigned>(uu) - img * pu) * kVec;
            offs[u] = (static_cast<long>(img) * C + c) * P + p;
            load_raw(x + offs[u], rx[u]);
            if constexpr (kGrad) load_raw(dy + offs[u], rg[u]);
            if (has_mask) load_raw(mask + static_cast<long>(img) * P + p, rm[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (!ok[u]) break;
          unpack(rx[u], xv);
          if constexpr (kGrad) unpack(rg[u], gv);
          if (has_mask) {
            unpack(rm[u], mv);
          } else {
#pragma unroll
            for (int i = 0; i < kVec; ++i) mv[i] = 1.0f;
          }
#pragma unroll
          for (int i = 0; i < kVec; ++i) cnt += mv[i];
          vec_op<kPass, T>(xv, gv, mv, k, kVec, has_mask, relu, a, b,
                           yv);
          if constexpr (!kSums) store8(out + offs[u], yv);
        }
      }
    } else {
      for (int it = 0; it < K; ++it) {
        const long u = u0 + static_cast<long>(it) * kThreads;
        if (u >= U) break;
        const long img = u / PU;
        const long off = (img * C + c) * P + (u - img * PU);
        mv[0] = has_mask ? to_f(mask[img * P + (u - img * PU)]) : 1.0f;
        cnt += mv[0];
        xv[0] = to_f(x[off]);
        if constexpr (kGrad) gv[0] = to_f(dy[off]);
        vec_op<kPass, T>(xv, gv, mv, k, 1, has_mask, relu, a, b, yv);
        if constexpr (!kSums) out[off] = from_f<T>(yv[0]);
      }
    }
    if constexpr (kSums) {
      float sa = 0.0f, sb = 0.0f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        sa += a[i];
        sb += b[i];
      }
      sh[0][threadIdx.x] = sa;
      sh[1][threadIdx.x] = sb;
      sh[2][threadIdx.x] = cnt;
      __syncthreads();
      for (int h = kThreads / 2; h > 0; h >>= 1) {
        if (threadIdx.x < h) {
          sh[0][threadIdx.x] += sh[0][threadIdx.x + h];
          sh[1][threadIdx.x] += sh[1][threadIdx.x + h];
          sh[2][threadIdx.x] += sh[2][threadIdx.x + h];
        }
        __syncthreads();
      }
      if (threadIdx.x == 0) {
        part[static_cast<long>(c) * nbx + blockIdx.x] = sh[0][0];
        part[static_cast<long>(C + c) * nbx + blockIdx.x] = sh[1][0];
        if (kPass == kMoments && c == 0)
          part[static_cast<long>(2 * C) * nbx + blockIdx.x] = sh[2][0];
      }
    }
  }
}

// out[i] = the sum of partials i * nbx .. i * nbx + nbx - 1, thread t adding
// t, t + kThreads, ..., then a halving tree; out[count_index] is
// count_rows as a float instead where count_rows > 0 (no mask: the rows).
__global__ void __launch_bounds__(kThreads)
norm_finalize_kernel(const float* __restrict__ part, float* __restrict__ out,
                     int nbx, int count_index, int count_rows) {
  __shared__ float sh[kThreads];
  const int i = blockIdx.x;
  if (i == count_index && count_rows > 0) {
    if (threadIdx.x == 0) out[i] = static_cast<float>(count_rows);
    return;
  }
  float s = 0.0f;
  for (int j = threadIdx.x; j < nbx; j += kThreads)
    s += part[static_cast<long>(i) * nbx + j];
  sh[threadIdx.x] = s;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) sh[threadIdx.x] += sh[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[i] = sh[0];
}

using Launch = cudaError_t (*)(const void*, const void*, const void*,
                               const void*, void*, void*, int, int, int, int,
                               int, int, dim3, cudaStream_t);

template <int kPass, bool kCL, typename T, typename TM>
cudaError_t launch(const void* x, const void* dy, const void* mask,
                   const void* cst, void* out, void* part, int B, int C,
                   int P, int K, int nbx, int relu, dim3 grid,
                   cudaStream_t s) {
  norm_pass_kernel<kPass, kCL, T, TM><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const TM*>(mask), static_cast<const float*>(cst),
      static_cast<T*>(out), static_cast<float*>(part), B, C, P, K, nbx, relu);
  return cudaGetLastError();
}

template <int kPass, bool kCL>
Launch pick(int x_bf16, int mask_f32) {
  using bf = __nv_bfloat16;
  if (x_bf16)
    return mask_f32 ? launch<kPass, kCL, bf, float> : launch<kPass, kCL, bf, bf>;
  return mask_f32 ? launch<kPass, kCL, float, float>
                  : launch<kPass, kCL, float, bf>;
}

template <int kPass>
Launch pick(int cl, int x_bf16, int mask_f32) {
  return cl ? pick<kPass, true>(x_bf16, mask_f32)
            : pick<kPass, false>(x_bf16, mask_f32);
}

// The grid of a pass, or false where K and nbx do not fit the shape.
bool grid_of(int cl, int B, int C, int P, int K, int nbx, dim3* grid) {
  if (B < 1 || C < 1 || P < 1 || K < 1 || nbx < 1) return false;
  long units, per;
  long gy;
  if (cl) {
    const int G = (C + kVec - 1) / kVec;
    const int TX = G < kMaxTX ? G : kMaxTX;
    per = kThreads / TX;
    gy = (G + TX - 1) / TX;
    units = static_cast<long>(B) * P;
  } else {
    per = kThreads;
    gy = C;
    units = static_cast<long>(B) * (P % kVec == 0 ? P / kVec : P);
  }
  if (static_cast<long>(B) * P >= (1L << 31) || gy > 65535) return false;
  if ((units + per * K - 1) / (per * K) != nbx) return false;
  *grid = dim3(nbx, static_cast<unsigned>(gy));
  return true;
}

}  // namespace cmx

// One pass (0 moments, 1 apply, 2 grad sums, 3 grad input) over x (B, C,
// H W) channel-major (channels_last = 0) or (B H W, C) rows (1), bf16
// (x_bf16 = 1) or fp32, 16-byte aligned; dy as x (the grad passes); mask (B,
// H W) bf16 (mask_kind 1), fp32 (2) or none (0, a null pointer); cst the
// pass's constants, rows of C floats; out as x (apply, grad input); part
// (2 C + 1) nbx floats (the sum passes), K and nbx from the host's
// geometry; relu = 1: the DoubleConv's epilogue (ReLU, then the mask).
extern "C" int cmx_norm_pass(int pass, int channels_last, int x_bf16,
                             int mask_kind, const void* x, const void* dy,
                             const void* mask, const void* cst, void* out,
                             void* part, int B, int C, int P, int K, int nbx,
                             int relu, void* stream) {
  using namespace cmx;
  dim3 grid;
  if (!grid_of(channels_last, B, C, P, K, nbx, &grid) || mask_kind < 0 ||
      mask_kind > 2 || (mask_kind == 0) != (mask == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int mf = mask_kind == 2;
  Launch f;
  switch (pass) {
    case kMoments: f = pick<kMoments>(channels_last, x_bf16, mf); break;
    case kApply: f = pick<kApply>(channels_last, x_bf16, mf); break;
    case kGradSums: f = pick<kGradSums>(channels_last, x_bf16, mf); break;
    case kGradInput: f = pick<kGradInput>(channels_last, x_bf16, mf); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(f(x, dy, mask, cst, out, part, B, C, P, K, nbx,
                            relu, grid,
                            static_cast<cudaStream_t>(stream)));
}

// out[0 .. nout - 1] fp32 from a sum pass's partials (nout rows of nbx);
// out[count_index] = count_rows where count_rows > 0.
extern "C" int cmx_norm_finalize(const void* part, void* out, int nout,
                                 int nbx, int count_index, int count_rows,
                                 void* stream) {
  using namespace cmx;
  if (nout < 1 || nbx < 1) return static_cast<int>(cudaErrorInvalidValue);
  norm_finalize_kernel<<<nout, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(out), nbx,
      count_index, count_rows);
  return static_cast<int>(cudaGetLastError());
}
