// K3: the SparK loss tail on the H100, one launch forward and one backward.
//
// Replaces the TPU kernel cmx/ops/pallas_ops.py::spark_loss_pallas
// (_spark_loss_kernel, the per-image (f, f) map of masked per-patch L2) with
// the jnp sum and divide after it, and the closed-form gradient that cmx
// computes as one fused XLA elementwise op (_spark_loss_bwd):
//   per 16x16 patch: mean and one-pass population variance E[x^2] - mean^2
//   (unclamped) + 1e-6, norm = (x - mean) * rsqrt(var + 1e-6),
//   l2 = mean of (rec - norm)^2, masked = 1 - active;
//   loss = sum(l2 * masked) / (sum(masked) + 1e-8);
//   drec = g * 2 (rec - norm) * masked / (p^2 * denom), in rec's dtype.
//
// Bound on the card: bytes. The forward reads rec (in its own dtype, 2 bytes
// a pixel in bf16), imgs (fp32) and the active grid once and writes three
// floats: 12.6 MB at batch 32, 256^2, bf16 rec, 0.0038 ms at 3.35 TB/s. The
// backward reads the same and writes drec in rec's dtype: 16.8 MB, 0.005 ms.
// About ten flops a pixel each way, far under the fp32 peak.
//
// Design: a block per (image, row of patches), kThreads threads; warp w
// takes the row's patches w, w + kWarps, ... One patch is 256 pixels, 8 a
// lane: lane l holds row l / 2, columns (l % 2) * 8 .. + 7 of the patch, as
// one 16-byte load of bf16 rec (two of fp32) and two of imgs. The patch
// sums reduce by xor shuffles, so every lane holds the same bits of the
// mean, the variance and the L2.
//   * Forward. Lane 0 of each warp accumulates its patches' l2 * masked and
//     masked; the block sums its warps in warp order into a partial pair in
//     `partials`; then __threadfence() and an atomic ticket. The block that
//     draws the last ticket sums every block's partials in a fixed order
//     (each thread a strided run, then a shared-memory tree), writes the
//     fp32 loss, its numerator sum(l2 * masked) and the denominator
//     sum(masked) + 1e-8 (for the backward; under data parallel the host
//     sums numerator and denominator over the ranks and divides), and
//     re-arms the ticket to 0. No host op between rec and the loss, and
//     the same bits on every run with the same inputs.
//   * Backward. The same walk; each patch's statistics are recomputed from
//     imgs, as cmx does (the backward reads imgs anyway to form norm, so a
//     saved (B, f, f, 2) buffer would save no bytes), and g and the
//     denominator are read from device memory. drec is written by 16-byte
//     stores. The elementwise terms are written with __fsub_rn / __fmul_rn
//     in the plain version's order, so nvcc contracts none of them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cmx {

constexpr int kPatch = 16;                 // the SparK patch (the port's only)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kInvN = 1.0f / (kPatch * kPatch);

__device__ __forceinline__ void load8(const float* p, float* v) {
  float4 a = *reinterpret_cast<const float4*>(p);
  float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The lane's 8 pixels of patch j in the block's row of patches, and the
// patch's mean and rsqrt(var + 1e-6), the same in every lane.
struct PatchLane {
  float x[8];
  float mean, inv_std;
  long off;  // offset of the lane's first pixel in the (B, H, W) arrays
};

__device__ __forceinline__ void patch_lane(const float* imgs, int b, int row,
                                           int j, int H, int W, int lane,
                                           PatchLane& pl) {
  int y = row * kPatch + (lane >> 1);
  int x0 = j * kPatch + (lane & 1) * 8;
  pl.off = (static_cast<long>(b) * H + y) * W + x0;
  load8(imgs + pl.off, pl.x);
  float s = 0.0f, q = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    s += pl.x[k];
    q = fmaf(pl.x[k], pl.x[k], q);
  }
  s = warp_sum(s);
  q = warp_sum(q);
  pl.mean = s * kInvN;
  float var = __fsub_rn(q * kInvN, __fmul_rn(pl.mean, pl.mean));
  pl.inv_std = rsqrtf(var + 1e-6f);
}

__device__ __forceinline__ float norm_diff(float r, float x, const PatchLane& pl) {
  return __fsub_rn(r, __fmul_rn(__fsub_rn(x, pl.mean), pl.inv_std));
}

template <typename TR, typename TA>
__global__ void __launch_bounds__(kThreads)
spark_loss_fwd_kernel(const TR* __restrict__ rec, const float* __restrict__ imgs,
                      const TA* __restrict__ act, float* __restrict__ loss,
                      float* __restrict__ num, float* __restrict__ denom,
                      float* __restrict__ partials,
                      unsigned int* __restrict__ ticket, int H, int W) {
  __shared__ float sm_l2[kThreads];
  __shared__ float sm_m[kThreads];
  __shared__ bool last;
  const int fh = H / kPatch, fw = W / kPatch;
  const int b = blockIdx.x / fh, row = blockIdx.x % fh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc_l2 = 0.0f, acc_m = 0.0f;  // lane 0's, over the warp's patches
  for (int j = warp; j < fw; j += kWarps) {
    PatchLane pl;
    patch_lane(imgs, b, row, j, H, W, lane, pl);
    float r[8];
    load8(rec + pl.off, r);
    float e = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float d = norm_diff(r[k], pl.x[k], pl);
      e = fmaf(d, d, e);
    }
    float l2 = warp_sum(e) * kInvN;
    float masked = 1.0f - to_float(act[(static_cast<long>(b) * fh + row) * fw + j]);
    acc_l2 += l2 * masked;
    acc_m += masked;
  }
  if (lane == 0) {
    sm_l2[warp] = acc_l2;
    sm_m[warp] = acc_m;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bl = 0.0f, bm = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      bl += sm_l2[w];
      bm += sm_m[w];
    }
    partials[2 * blockIdx.x] = bl;
    partials[2 * blockIdx.x + 1] = bm;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // The last block: every partial, in a fixed order.
  float sl = 0.0f, sm = 0.0f;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += kThreads) {
    sl += __ldcg(partials + 2 * i);
    sm += __ldcg(partials + 2 * i + 1);
  }
  sm_l2[threadIdx.x] = sl;
  sm_m[threadIdx.x] = sm;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      sm_l2[threadIdx.x] += sm_l2[threadIdx.x + half];
      sm_m[threadIdx.x] += sm_m[threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float d = sm_m[0] + 1e-8f;
    *loss = sm_l2[0] / d;
    *num = sm_l2[0];
    *denom = d;
    *ticket = 0u;  // re-armed for the next launch on the stream
  }
}

template <typename TR, typename TA>
__global__ void __launch_bounds__(kThreads)
spark_loss_bwd_kernel(const TR* __restrict__ rec, const float* __restrict__ imgs,
                      const TA* __restrict__ act, const float* __restrict__ g,
                      const float* __restrict__ denom, TR* __restrict__ drec,
                      int H, int W) {
  const int fh = H / kPatch, fw = W / kPatch;
  const int b = blockIdx.x / fh, row = blockIdx.x % fh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float gv = *g;
  const float c = __fmul_rn(static_cast<float>(kPatch * kPatch), *denom);
  for (int j = warp; j < fw; j += kWarps) {
    PatchLane pl;
    patch_lane(imgs, b, row, j, H, W, lane, pl);
    float r[8];
    load8(rec + pl.off, r);
    float masked = 1.0f - to_float(act[(static_cast<long>(b) * fh + row) * fw + j]);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float t = __fmul_rn(__fmul_rn(2.0f, norm_diff(r[k], pl.x[k], pl)), masked);
      r[k] = __fmul_rn(gv, __fdiv_rn(t, c));
    }
    store8(drec + pl.off, r);
  }
}

template <typename TR, typename TA>
cudaError_t launch_fwd(const void* rec, const void* imgs, const void* act,
                       void* loss, void* num, void* denom, void* partials,
                       void* ticket, int B, int H, int W, cudaStream_t s) {
  spark_loss_fwd_kernel<TR, TA><<<B * (H / kPatch), kThreads, 0, s>>>(
      static_cast<const TR*>(rec), static_cast<const float*>(imgs),
      static_cast<const TA*>(act), static_cast<float*>(loss),
      static_cast<float*>(num), static_cast<float*>(denom),
      static_cast<float*>(partials),
      static_cast<unsigned int*>(ticket), H, W);
  return cudaGetLastError();
}

template <typename TR, typename TA>
cudaError_t launch_bwd(const void* rec, const void* imgs, const void* act,
                       const void* g, const void* denom, void* drec, int B,
                       int H, int W, cudaStream_t s) {
  spark_loss_bwd_kernel<TR, TA><<<B * (H / kPatch), kThreads, 0, s>>>(
      static_cast<const TR*>(rec), static_cast<const float*>(imgs),
      static_cast<const TA*>(act), static_cast<const float*>(g),
      static_cast<const float*>(denom), static_cast<TR*>(drec), H, W);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int W) {
  return B < 1 || H < kPatch || W < kPatch || H % kPatch || W % kPatch;
}

}  // namespace cmx

// rec (B,H,W) bf16 (rec_bf16 = 1) or fp32, imgs (B,H,W) fp32, act (B,H/16,
// W/16) bf16 (act_bf16 = 1) or fp32, all contiguous and 16-byte aligned;
// loss, num and denom one fp32 each; partials 2*B*(H/16) fp32 of scratch; ticket
// one unsigned int that is 0 before the launch (and after it).
extern "C" int cmx_spark_loss_fwd(const void* rec, const void* imgs,
                                  const void* act, void* loss, void* num,
                                  void* denom, void* partials, void* ticket,
                                  int B, int H, int W, int rec_bf16,
                                  int act_bf16, void* stream) {
  using namespace cmx;
  if (bad_shape(B, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto f = rec_bf16 ? (act_bf16 ? launch_fwd<__nv_bfloat16, __nv_bfloat16>
                                : launch_fwd<__nv_bfloat16, float>)
                    : (act_bf16 ? launch_fwd<float, __nv_bfloat16>
                                : launch_fwd<float, float>);
  return static_cast<int>(
      f(rec, imgs, act, loss, num, denom, partials, ticket, B, H, W, s));
}

// The same operands as the forward, g the loss's fp32 cotangent and denom
// the forward's denominator (both on the card); drec (B,H,W) in rec's dtype.
extern "C" int cmx_spark_loss_bwd(const void* rec, const void* imgs,
                                  const void* act, const void* g,
                                  const void* denom, void* drec, int B, int H,
                                  int W, int rec_bf16, int act_bf16,
                                  void* stream) {
  using namespace cmx;
  if (bad_shape(B, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto f = rec_bf16 ? (act_bf16 ? launch_bwd<__nv_bfloat16, __nv_bfloat16>
                                : launch_bwd<__nv_bfloat16, float>)
                    : (act_bf16 ? launch_bwd<float, __nv_bfloat16>
                                : launch_bwd<float, float>);
  return static_cast<int>(f(rec, imgs, act, g, denom, drec, B, H, W, s));
}
