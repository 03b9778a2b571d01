// K2: one masked DoubleConv stage backward on the H100, channel-major.
//
// Replaces the TPU kernel cmx/ops/fused_conv_flat.py::flat_bwd_mega
// (_flat_bwd_kernel), the backward of flat_double_conv over channel-major
// (B, C, H*W) maps: the masked-BN dy = (m*inv)*(dz - s1/nact - xhat*s2/nact)
// with dz = g*m*[y*inv+shift > 0], rounded to bf16; dX = conv(dy, flipped
// and channel-transposed w), bf16, skipped when the caller needs no input
// gradient; dW = sum over pixels of h-tap (x) dy in fp32, h recomputed as
// bf16(relu(src*inv_p+shift_p)*m) when prev_fold is given.
//
// Bound on the card: the two products (dX, dW), 4*9*Cin*Cout flops a pixel,
// tensor-core bound at the main path's widths; dy is one elementwise pass
// (bytes). Design: three launches on the caller's stream, the products on
// the tensor cores in conv3x3_mma.cuh's channel-major instances:
//   1. dy: bn_bwd_dy_cm_kernel, 8 consecutive pixels (16 bytes) of one
//      channel a thread, written once in bf16 (the TPU kernel kept dy in
//      VMEM; here it makes one round trip through device memory);
//   2. dX: K1's implicit GEMM over dy with the packed flipped,
//      channel-transposed weights, no prologue, no stats;
//   3. dW: flat_dw_mma_kernel, pixels as the GEMM's K dimension, h
//      transposed while staging (pre-normed on the way when prev_fold is
//      given), dy's channel rows read as they are. The TPU kernel wrote one
//      dW partial per grid step; here each block writes one for its run of
//      pixel tiles (a grid of one wave of resident blocks) and the wrapper
//      sums them (no atomics, deterministic).
// Tiles overhanging the right image edge are masked, so any H % 8 == 0,
// W % 8 == 0 runs.
#include "conv3x3_mma.cuh"

namespace cmx {

constexpr int DY_NT = 256;

// dy over channel-major maps, each operation rounded in bn_bwd_dy_kernel's
// order: plane pl = n*C + c of g, y and dy (HW = 8*hw8 pixels each) with the
// mask plane n; one channel's six vectors (vecs (6, C) fp32 rows inv, shift,
// mean, rr, s1/nact, s2/nact) in registers, 8 pixels (16 bytes of g, y, mask
// and dy) a thread. Needs 16-byte aligned g, y, mask and dy.
__global__ void __launch_bounds__(DY_NT) bn_bwd_dy_cm_kernel(
    const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ y,
    const __nv_bfloat16* __restrict__ mask, const float* __restrict__ vecs,
    __nv_bfloat16* __restrict__ dy, int C, int hw8, int planes) {
  for (int pl = blockIdx.y; pl < planes; pl += gridDim.y) {
    const int n = pl / C, c = pl - n * C;
    const float inv = vecs[c], shift = vecs[C + c], mean = vecs[2 * C + c];
    const float rr = vecs[3 * C + c], s1n = vecs[4 * C + c];
    const float s2n = vecs[5 * C + c];
    const size_t base = (size_t)pl * hw8;
    const uint4* gp = reinterpret_cast<const uint4*>(g) + base;
    const uint4* yp = reinterpret_cast<const uint4*>(y) + base;
    const uint4* mp = reinterpret_cast<const uint4*>(mask) + (size_t)n * hw8;
    uint4* dp = reinterpret_cast<uint4*>(dy) + base;
    for (int i = blockIdx.x * DY_NT + threadIdx.x; i < hw8;
         i += gridDim.x * DY_NT) {
      float gv[8], yv[8], mv[8], o[8];
      unpack8(gp[i], gv);
      unpack8(yp[i], yv);
      unpack8(mp[i], mv);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const bool gate = __fadd_rn(__fmul_rn(yv[k], inv), shift) > 0.f;
        const float dz = __fmul_rn(__fmul_rn(gv[k], mv[k]), gate ? 1.f : 0.f);
        const float xh = __fmul_rn(__fsub_rn(yv[k], mean), rr);
        const float t = __fsub_rn(__fsub_rn(dz, s1n), __fmul_rn(xh, s2n));
        o[k] = __fmul_rn(__fmul_rn(mv[k], inv), t);
      }
      dp[i] = pack8(o);
    }
  }
}

}  // namespace cmx

// g, y: (B, Cout, H, W) bf16; src: (B, Cin, H, W) bf16; mask (B, H, W) bf16;
// vecs (6, Cout) fp32; prev_inv / prev_shift (Cin,) fp32 when pre_h;
// wtpack the (ceil(Cin/64), ceil(Cout/16), 9, 16, 64) packing of the
// (9, Cout, Cin) bf16 flipped, channel-transposed weights; dy_buf (B, Cout,
// H, W) bf16 scratch; dh (B, Cin, H, W) bf16 when need_dx; dw_part (nchunks,
// 9, Cin, Cout) fp32 over B * (H/4) * ceil(W/32) pixel tiles in runs of
// tiles_per_chunk. Every bf16 map 16-byte aligned.
extern "C" int cmx_flat_bwd(const void* g, const void* y, const void* src,
                            const void* mask, const void* vecs,
                            const void* prev_inv, const void* prev_shift,
                            const void* wtpack, void* dy_buf, void* dh,
                            void* dw_part, int B, int Cin, int Cout, int H,
                            int W, int pre_h, int need_dx, int nchunks,
                            int tiles_per_chunk, void* stream) {
  using namespace cmx;
  auto s = static_cast<cudaStream_t>(stream);
  auto bf = [](const void* p) { return static_cast<const __nv_bfloat16*>(p); };
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  auto dyp = static_cast<__nv_bfloat16*>(dy_buf);

  if (!(aligned16(g) && aligned16(y) && aligned16(mask) && aligned16(dy_buf)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int hw8 = H * W / 8, planes = B * Cout;
  const dim3 grid((hw8 + DY_NT - 1) / DY_NT, planes < 65535 ? planes : 65535);
  bn_bwd_dy_cm_kernel<<<grid, DY_NT, 0, s>>>(bf(g), bf(y), bf(mask), f32(vecs),
                                             dyp, Cout, hw8, planes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (need_dx) {
    err = launch_conv3x3_mma<true, false, false>(
        dyp, nullptr, nullptr, nullptr, bf(wtpack), nullptr,
        static_cast<__nv_bfloat16*>(dh), nullptr, B, Cout, Cin, H, W, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  auto part = static_cast<float*>(dw_part);
  if (pre_h)
    err = launch_dw_mma<true, true>(bf(src), bf(mask), f32(prev_inv),
                                    f32(prev_shift), dyp, part, B, Cin, Cout,
                                    H, W, nchunks, tiles_per_chunk, s);
  else
    err = launch_dw_mma<true, false>(bf(src), bf(mask), nullptr, nullptr, dyp,
                                     part, B, Cin, Cout, H, W, nchunks,
                                     tiles_per_chunk, s);
  return static_cast<int>(err);
}

// Resident blocks a multiprocessor of the dW kernel (with or without the
// pre-norm prologue), 0 on error: the wrapper sizes the split-K grid by it.
extern "C" int cmx_dw_blocks_per_sm(int pre_h) {
  return pre_h ? cmx::dw_mma_blocks_per_sm<true, true>()
               : cmx::dw_mma_blocks_per_sm<true, false>();
}
