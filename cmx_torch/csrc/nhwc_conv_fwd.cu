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
// pixel and writes 2*C bytes of y (C = 64: 148 bytes against 1,152 flops);
// the y stores are 86% of the bytes. Its fp32 FMAs (9*C a pixel) come close:
// at 67 TFLOP/s they take ~40% of the byte bound, so the instructions around
// them have to be few.
// Design: the threads of a block are laid out (pixel, group of 8 channels)
// with the channel group fastest, so a warp writes whole contiguous runs of
// y in 16-byte stores. A thread's channel group never changes, so its 72
// weights and 8 biases sit in registers, loaded once. A block walks runs of
// STEM_RUN pixels (grid-stride); a run's patches and mask (20 bytes a pixel,
// 16-byte aligned at a run's start) come into shared memory by 16-byte
// cp.async, double-buffered so the next run streams in while this one
// computes, and the threads of a pixel read its 9 taps there. Where the
// patches or the mask start off a 16-byte boundary (a view), the same
// staging is done element by element. Each thread keeps its 8 channels' sums
// in fp32; the block reduces them in shared memory and writes one partial
// row, and the wrapper sums the rows (deterministic, no atomics). The grid is
// one wave of resident blocks. The taps are summed t = 0..8 in FMAs, then
// the bias added and the mask applied, as in the first design.
#include "conv3x3_mma.cuh"

namespace cmx {

constexpr int STEM_NT = 256;
constexpr int STEM_RUN = 512;                  // pixels a block stages at once
constexpr int STEM_BUF = STEM_RUN * (9 + 1) * 2;  // patches, then mask
// two staging buffers, later reused for the (2, ppb, 8*G) partial sums
constexpr int STEM_SMEM = 2 * STEM_BUF > 2 * STEM_NT * 8 * 4
                              ? 2 * STEM_BUF
                              : 2 * STEM_NT * 8 * 4;

// The first `bytes` (0..16) of 16 global bytes -> shared, the rest zeroed;
// both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async_part16(uint32_t dst, const void* src,
                                                int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// Run [p0, p0 + np) of the patches and mask into a staging buffer: by
// cp.async (vec: both bases 16-byte aligned, p0 % 8 == 0), else element by
// element.
__device__ __forceinline__ void stem_stage(
    char* buf, const __nv_bfloat16* __restrict__ patches,
    const __nv_bfloat16* __restrict__ mask, long long p0, int np, int vec) {
  const int tid = threadIdx.x;
  if (vec) {
    const int pb = 18 * np, mb = 2 * np;
    const int pc = (pb + 15) / 16, mc = (mb + 15) / 16;
    const char* gp = reinterpret_cast<const char*>(patches + p0 * 9);
    const char* gm = reinterpret_cast<const char*>(mask + p0);
    const uint32_t sp = smem_u32(buf), sm = smem_u32(buf + 18 * STEM_RUN);
    for (int c = tid; c < pc + mc; c += STEM_NT) {
      if (c < pc)
        cp_async_part16(sp + 16 * c, gp + 16 * c, min(16, pb - 16 * c));
      else
        cp_async_part16(sm + 16 * (c - pc), gm + 16 * (c - pc),
                        min(16, mb - 16 * (c - pc)));
    }
  } else {
    auto sp = reinterpret_cast<unsigned short*>(buf);
    auto sm = reinterpret_cast<unsigned short*>(buf + 18 * STEM_RUN);
    auto gp = reinterpret_cast<const unsigned short*>(patches) + p0 * 9;
    auto gm = reinterpret_cast<const unsigned short*>(mask) + p0;
    for (int e = tid; e < 10 * np; e += STEM_NT) {
      if (e < 9 * np)
        sp[e] = gp[e];
      else
        sm[e - 9 * np] = gm[e - 9 * np];
    }
  }
}

// patches (P, 9) bf16, mask (P,) bf16, w (9, C) bf16, bias (C,) fp32 ->
// y (P, C) bf16, part (gridDim.x, 2, C) fp32. Needs ceil(C/8) <= STEM_NT.
__global__ void __launch_bounds__(STEM_NT) stem_kernel(
    const __nv_bfloat16* __restrict__ patches,
    const __nv_bfloat16* __restrict__ mask, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
    float* __restrict__ part, long long P, int C, int vec_in, int vec_out) {
  __shared__ __align__(16) char smem[STEM_SMEM];
  const int G = (C + 7) / 8;        // channel groups
  const int ppb = STEM_NT / G;      // pixels a block works on at once
  const int tid = threadIdx.x;
  const int g = tid % G, pl = tid / G;
  const int cb = g * 8;

  float wr[9][8], br[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool in = cb + j < C;
    br[j] = in ? bias[cb + j] : 0.f;
#pragma unroll
    for (int t = 0; t < 9; ++t)
      wr[t][j] = in ? __bfloat162float(w[t * C + cb + j]) : 0.f;
  }

  float s[8], q[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = q[j] = 0.f;
  const long long runs = (P + STEM_RUN - 1) / STEM_RUN;
  long long r = blockIdx.x;
  int cur = 0;
  if (r < runs)
    stem_stage(smem, patches, mask, r * STEM_RUN,
               (int)min((long long)STEM_RUN, P - r * STEM_RUN), vec_in);
  cp_async_commit();
  for (; r < runs; r += gridDim.x) {
    const long long rn = r + gridDim.x;
    if (rn < runs)
      stem_stage(smem + (cur ^ 1) * STEM_BUF, patches, mask, rn * STEM_RUN,
                 (int)min((long long)STEM_RUN, P - rn * STEM_RUN), vec_in);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const char* buf = smem + cur * STEM_BUF;
    const __nv_bfloat16* sp = reinterpret_cast<const __nv_bfloat16*>(buf);
    const __nv_bfloat16* sm =
        reinterpret_cast<const __nv_bfloat16*>(buf + 18 * STEM_RUN);
    const long long p0 = r * STEM_RUN;
    const int np = (int)min((long long)STEM_RUN, P - p0);
    if (pl < ppb) {
      for (int i = pl; i < np; i += ppb) {
        float pv[9];
#pragma unroll
        for (int t = 0; t < 9; ++t) pv[t] = __bfloat162float(sp[i * 9 + t]);
        const float mv = __bfloat162float(sm[i]);
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float acc = 0.f;
#pragma unroll
          for (int t = 0; t < 9; ++t) acc = fmaf(pv[t], wr[t][j], acc);
          v[j] = (acc + br[j]) * mv;
          s[j] += v[j];
          q[j] += v[j] * v[j];
        }
        __nv_bfloat16* dst = y + (p0 + i) * C + cb;
        if (vec_out) {
          *reinterpret_cast<uint4*>(dst) = pack8(v);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (cb + j < C) dst[j] = __float2bfloat16(v[j]);
        }
      }
    }
    __syncthreads();
    cur ^= 1;
  }
  cp_async_wait<0>();
  __syncthreads();

  float* red = reinterpret_cast<float*>(smem);  // (2, ppb, 8*G)
  const int ld = 8 * G;
  if (pl < ppb) {
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
      S += red[i * ld + co];
      Q += red[(ppb + i) * ld + co];
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
// y (P, C) bf16, part (nblk, 2, C) fp32; P = B*H*W pixels, C <= 512. nblk:
// at most ceil(P / STEM_RUN) (cmx_stem_run()) and one wave of resident blocks
// (cmx_stem_blocks_per_sm() a multiprocessor).
extern "C" int cmx_nhwc_stem(const void* patches, const void* mask,
                             const void* w, const void* bias, void* y,
                             void* part, int P, int C, int nblk,
                             void* stream) {
  using namespace cmx;
  const int vec_in = aligned16(patches) && aligned16(mask);
  const int vec_out = C % 8 == 0 && aligned16(y);
  stem_kernel<<<nblk, STEM_NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(patches),
      static_cast<const __nv_bfloat16*>(mask),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(part), P, C, vec_in,
      vec_out);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks a multiprocessor of the stem kernel, 0 on error.
extern "C" int cmx_stem_blocks_per_sm() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, cmx::stem_kernel,
                                                    cmx::STEM_NT, 0) !=
      cudaSuccess)
    return 0;
  return n;
}

extern "C" int cmx_stem_run() { return cmx::STEM_RUN; }
