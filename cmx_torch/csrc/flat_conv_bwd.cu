// K2: one masked DoubleConv stage backward on the H100.
//
// Replaces the TPU kernel cmx/ops/fused_conv_flat.py::flat_bwd_mega
// (_flat_bwd_kernel), the backward of flat_double_conv. Three launches on
// the caller's stream compute what the mega-kernel computes:
//   1. bn_bwd_dy_kernel: the masked-BN input gradient
//        dz = g*m*[y*inv+shift > 0],  xh = (y-mean)*rr,
//        dy = bf16((m*inv) * (dz - s1/nact - xh*s2/nact))
//      (the TPU kernel rounds dy to bf16 before both products as well);
//   2. dX = 3x3 conv of dy with the flipped, channel-transposed weights:
//      the conv core of conv3x3_core.cuh, skipped when the caller needs no
//      input gradient;
//   3. conv3x3_dw_kernel: dW[a,b,ci,co] = sum over pixels of
//      h[ci, p+(a-1,b-1)] * dy[co, p], with h the stage input, pre-normed
//      relu(src*inv0+shift0)*m in bf16 while staging when the stage is the
//      DoubleConv's second.
//
// Bound on the card: dX and dW each do the forward's flops (2*9*Cin*Cout per
// pixel), tensor-core bound at the main path's widths; dy is one
// elementwise pass (bytes). dy makes one round trip through device memory
// here (2 bytes a value), where the TPU kernel kept it in VMEM; at these
// widths that traffic is small beside the products.
// dW is a reduction over B*H*W for each of the 9*Cin*Cout entries. The grid
// is bounded: each block owns a 16-channel x 64-channel slice of dW and a
// contiguous run of pixel tiles, accumulates in registers, and writes its
// partial; the wrapper sums the partials in fp32. No atomics, so the result
// is deterministic, and it differs from a plain fp32 reduction only by
// summation order (relative error ~1e-6 of the largest entry).
#include "conv3x3_core.cuh"

namespace cmx {

constexpr int DW_CI = 16;            // input channels per block
constexpr int DW_CO = 64;            // output channels per block
constexpr int DW_TR = 2;             // pixel tile rows
constexpr int DW_TC = 32;            // pixel tile columns
constexpr int DW_P = DW_TR * DW_TC;  // pixels per tile
constexpr int DW_LD = DW_CO + 4;     // padded row of the staged dy tile

// vecs (6, C) fp32 rows: inv, shift, mean, rr, s1/nact, s2/nact.
__global__ void bn_bwd_dy_kernel(const __nv_bfloat16* __restrict__ g,
                                 const __nv_bfloat16* __restrict__ y,
                                 const __nv_bfloat16* __restrict__ mask,
                                 const float* __restrict__ vecs,
                                 __nv_bfloat16* __restrict__ dy, int C,
                                 size_t HW, size_t total) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t p = i % HW;
    const int c = (int)((i / HW) % C);
    const size_t n = i / (HW * C);
    const float inv = vecs[c], shift = vecs[C + c], mean = vecs[2 * C + c];
    const float rr = vecs[3 * C + c], s1n = vecs[4 * C + c];
    const float s2n = vecs[5 * C + c];
    const float gv = __bfloat162float(g[i]);
    const float yv = __bfloat162float(y[i]);
    const float mv = __bfloat162float(mask[n * HW + p]);
    // Each operation rounds on its own, in the plain version's order.
    const bool gate = __fadd_rn(__fmul_rn(yv, inv), shift) > 0.f;
    const float dz = __fmul_rn(__fmul_rn(gv, mv), gate ? 1.f : 0.f);
    const float xh = __fmul_rn(__fsub_rn(yv, mean), rr);
    const float t = __fsub_rn(__fsub_rn(dz, s1n), __fmul_rn(xh, s2n));
    dy[i] = __float2bfloat16(__fmul_rn(__fmul_rn(mv, inv), t));
  }
}

template <bool PRENORM>
__global__ void __launch_bounds__(NT) conv3x3_dw_kernel(
    const __nv_bfloat16* __restrict__ src,   // (B, Cin, H, W)
    const __nv_bfloat16* __restrict__ mask,  // (B, H, W)
    const float* __restrict__ inv,           // (Cin,) PRENORM only
    const float* __restrict__ shift,         // (Cin,) PRENORM only
    const __nv_bfloat16* __restrict__ dy,    // (B, Cout, H, W)
    float* __restrict__ part,                // (nchunks, 9, Cin, Cout)
    int B, int Cin, int Cout, int H, int W, int tiles_per_chunk) {
  __shared__ float hs[DW_CI][DW_TR + 2][DW_TC + 2];
  __shared__ __align__(16) float ds[DW_P][DW_LD];

  const int chunk = blockIdx.x;
  const int ci0 = blockIdx.y * DW_CI, co0 = blockIdx.z * DW_CO;
  const int tid = threadIdx.x;
  const int cil = tid >> 4;  // this thread's input channel in the slice
  const int cog = tid & 15;  // this thread's 4 output channels: 4*cog..+3
  const int tiles_x = W / DW_TC, tiles_y = H / DW_TR;
  const int total = B * tiles_x * tiles_y;
  const int t_begin = chunk * tiles_per_chunk;
  const int t_end = min(total, t_begin + tiles_per_chunk);
  const size_t HW = (size_t)H * W;

  float acc[9][4];
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int n = t / (tiles_x * tiles_y);
    const int rem = t % (tiles_x * tiles_y);
    const int ty0 = (rem / tiles_x) * DW_TR, tx0 = (rem % tiles_x) * DW_TC;
    for (int i = tid; i < DW_CI * (DW_TR + 2) * (DW_TC + 2); i += NT) {
      const int k = i / ((DW_TR + 2) * (DW_TC + 2));
      const int r2 = i % ((DW_TR + 2) * (DW_TC + 2));
      const int yy = r2 / (DW_TC + 2), xx = r2 % (DW_TC + 2);
      const int gy = ty0 + yy - 1, gx = tx0 + xx - 1;
      const int ci = ci0 + k;
      float v = 0.f;
      if (ci < Cin && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const size_t pix = (size_t)gy * W + gx;
        v = __bfloat162float(src[((size_t)n * Cin + ci) * HW + pix]);
        if (PRENORM) {
          const float mv = __bfloat162float(mask[(size_t)n * HW + pix]);
          v = __fadd_rn(__fmul_rn(v, inv[ci]), shift[ci]);
          v = bf16_round(__fmul_rn(fmaxf(v, 0.f), mv));
        }
      }
      hs[k][yy][xx] = v;
    }
    for (int i = tid; i < DW_CO * DW_P; i += NT) {
      const int co = i / DW_P, p = i % DW_P;
      const int gco = co0 + co;
      float v = 0.f;
      if (gco < Cout)
        v = __bfloat162float(dy[((size_t)n * Cout + gco) * HW +
                                (size_t)(ty0 + p / DW_TC) * W + tx0 + p % DW_TC]);
      ds[p][co] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int p = 0; p < DW_P; ++p) {
      const int pr = p / DW_TC, pc = p % DW_TC;
      const float4 d = *reinterpret_cast<const float4*>(&ds[p][cog * 4]);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          const float hv = hs[cil][pr + a][pc + b];
          acc[a * 3 + b][0] = fmaf(hv, d.x, acc[a * 3 + b][0]);
          acc[a * 3 + b][1] = fmaf(hv, d.y, acc[a * 3 + b][1]);
          acc[a * 3 + b][2] = fmaf(hv, d.z, acc[a * 3 + b][2]);
          acc[a * 3 + b][3] = fmaf(hv, d.w, acc[a * 3 + b][3]);
        }
      }
    }
    __syncthreads();
  }

  const int ci = ci0 + cil;
  if (ci < Cin) {
#pragma unroll
    for (int k = 0; k < 9; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = co0 + cog * 4 + j;
        if (co < Cout)
          part[(((size_t)chunk * 9 + k) * Cin + ci) * Cout + co] = acc[k][j];
      }
  }
}

}  // namespace cmx

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
  using namespace cmx;
  auto s = static_cast<cudaStream_t>(stream);
  auto bf = [](const void* p) { return static_cast<const __nv_bfloat16*>(p); };
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  auto dyp = static_cast<__nv_bfloat16*>(dy_buf);

  const size_t HW = (size_t)H * W;
  const size_t total = (size_t)B * Cout * HW;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads < 132 * 32
                               ? (total + threads - 1) / threads
                               : 132 * 32);
  bn_bwd_dy_kernel<<<blocks, threads, 0, s>>>(bf(g), bf(y), bf(mask),
                                              f32(vecs), dyp, Cout, HW, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (need_dx) {
    err = launch_conv3x3<false, false>(
        dyp, bf(mask), nullptr, nullptr, bf(wt), nullptr,
        static_cast<__nv_bfloat16*>(dh), nullptr, B, Cout, Cin, H, W, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  dim3 grid(nchunks, (Cin + DW_CI - 1) / DW_CI, (Cout + DW_CO - 1) / DW_CO);
  if (pre_h)
    conv3x3_dw_kernel<true><<<grid, NT, 0, s>>>(
        bf(src), bf(mask), f32(prev_inv), f32(prev_shift), dyp,
        static_cast<float*>(dw_part), B, Cin, Cout, H, W, tiles_per_chunk);
  else
    conv3x3_dw_kernel<false><<<grid, NT, 0, s>>>(
        bf(src), bf(mask), nullptr, nullptr, dyp,
        static_cast<float*>(dw_part), B, Cin, Cout, H, W, tiles_per_chunk);
  return static_cast<int>(cudaGetLastError());
}
