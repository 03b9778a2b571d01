// K4: batched crop + resize (RandomResizedCrop's linear map) on the H100.
//
// Replaces the TPU kernel cmx/ops/pallas_crop.py::crop_resize_pallas
// (_crop_kernel, weights _weights_out_in): per image, from the window
// (sy, ty, sx, tx), the resample weights wy (out, H) and wx (out, W) --
// half-pixel centres, the kernel widened by max(1/s, 1) (antialias), linear
// or Keys cubic a=-0.5, each output row renormalized when |total| >
// 1000*eps, rows whose sample position lies outside [-0.5, in-0.5] zeroed --
// then out = wy . img . wx^T as two fp32 products.
//
// Bound on the card: bytes. The weights are a band (2-3 non-zero taps a
// row at MoCo's linear windows, twice that cubic), so the function needs
// ~0.5 MFLOP an image against ~463 KB of image traffic: ~119 MB a launch at
// batch 256, 0.035 ms over 3.35 TB/s (cmx_torch/utils/roofline.py::crop_work
// counts the taps of the actual windows). This design runs the dense
// products instead, 2*out*H*W + 2*out*out*W flops an image (55.1 MFLOP at
// 256^2 -> 224^2; 14.1 GFLOP a launch at batch 256, 0.21 ms at 67 TFLOP/s
// of CUDA-core fp32), so it sits far above that bound. cmx runs both
// products at Precision.HIGHEST, so they stay fp32 FMAs here: no TF32, no
// tensor cores.
//
// Design (simple first). Three launches on the caller's stream:
//   1. weights: one warp per output row of wy and of wx. Each lane
//      evaluates the kernel at its input positions, the row total is reduced
//      by shuffles, and a second pass writes the normalized, validity-gated
//      row to a (B, out, in) fp32 scratch in device memory. On the TPU these
//      matrices lived in VMEM; one 224x256 fp32 matrix is 229 KB, above the
//      227 KB of shared memory a block can have, so they go through device
//      memory (58.7 MB each at batch 256, mostly served from L2 to stage 2).
//      The expressions of the weight formula are written with __fmul_rn /
//      __fadd_rn / __fdiv_rn in the order of _weights_out_in, so nvcc cannot
//      contract them into FMAs and move a value across the >= -0.5 validity
//      edge or the 1000*eps threshold: the sample positions equal the plain
//      version's bit for bit.
//   2. tmp = wy . img and 3. out = tmp . wx^T: a tiled SIMT fp32 GEMM
//      (64x64 output tile, k-step 16, 256 threads, 4x4 outputs a thread),
//      batched over images by grid.z; each output sums its k terms in order.
// The weights are a band (2 taps a row for linear when upscaling, a few more
// when antialiased): a banded kernel that skips the zeros, with the weights
// regenerated per tile instead of stored, is the later redesign.
// The TPU kernel's (B,4) SMEM block and its int-iota casts were Mosaic
// workarounds and have no counterpart here.
#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kBM = 64, kBN = 64, kBK = 16, kGemmThreads = 256;

__device__ __forceinline__ float keys_cubic(float x) {
  // ((1.5x - 2.5)x)x + 1 on [0,1), ((-0.5x + 2.5)x - 4)x + 2 on [1,2), 0 after
  float near = __fadd_rn(
      __fmul_rn(__fmul_rn(__fsub_rn(__fmul_rn(1.5f, x), 2.5f), x), x), 1.0f);
  float far = __fadd_rn(
      __fmul_rn(
          __fsub_rn(__fmul_rn(__fadd_rn(__fmul_rn(-0.5f, x), 2.5f), x), 4.0f),
          x),
      2.0f);
  float w = x >= 1.0f ? far : near;
  return x >= 2.0f ? 0.0f : w;
}

__device__ __forceinline__ float tap(float sample_f, int i, float kscale,
                                     int cubic) {
  float x = __fdiv_rn(fabsf(__fsub_rn(sample_f, static_cast<float>(i))),
                      kscale);
  return cubic ? keys_cubic(x) : fmaxf(__fsub_rn(1.0f, x), 0.0f);
}

// Rows [0, B*out) are wy's, rows [B*out, 2*B*out) wx's.
__global__ void crop_weights_kernel(const float* __restrict__ params,
                                    float* __restrict__ wy,
                                    float* __restrict__ wx, int B, int H,
                                    int W, int out, int cubic) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const long long rows = static_cast<long long>(B) * out;
  if (row >= 2 * rows) return;
  const int axis = row >= rows;  // 0: y (H), 1: x (W)
  const long long r = axis ? row - rows : row;
  const int b = static_cast<int>(r / out);
  const int o = static_cast<int>(r % out);
  const int in = axis ? W : H;
  const float s = params[4 * b + 2 * axis];
  const float t = params[4 * b + 2 * axis + 1];
  float* dst = (axis ? wx : wy) + r * in;

  const float inv = __fdiv_rn(1.0f, s);
  const float kscale = fmaxf(inv, 1.0f);  // antialias
  // (o + 0.5) * inv - t * inv - 0.5, left to right
  const float sample_f = __fsub_rn(
      __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(o), 0.5f), inv),
                __fmul_rn(t, inv)),
      0.5f);

  float total = 0.0f;
  for (int i = lane; i < in; i += 32)
    total = __fadd_rn(total, tap(sample_f, i, kscale, cubic));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    total = __fadd_rn(total, __shfl_xor_sync(0xffffffffu, total, off));

  const bool valid = sample_f >= -0.5f &&
                     sample_f <= __fsub_rn(static_cast<float>(in), 0.5f);
  const bool keep = valid && fabsf(total) > 1000.0f * FLT_EPSILON;
  const float denom = total != 0.0f ? total : 1.0f;
  for (int i = lane; i < in; i += 32)
    dst[i] = keep ? __fdiv_rn(tap(sample_f, i, kscale, cubic), denom) : 0.0f;
}

// C[b] (M,N) = A[b] (M,K) . op(B[b]); op(B) is B (K,N), or B^T for B (N,K)
// when TRANS_B. Row-major, contiguous, batch strides M*K, K*N, M*N.
template <bool TRANS_B>
__global__ void __launch_bounds__(kGemmThreads)
    sgemm_batched_kernel(const float* __restrict__ A,
                         const float* __restrict__ Bm, float* __restrict__ C,
                         int M, int N, int K) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN + 4];
  const long long b = blockIdx.z;
  A += b * M * K;
  Bm += b * K * N;
  C += b * M * N;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kBK) {
    {  // A tile: 64 rows x 16 k, 4 consecutive k a thread
      const int r = t / 4, kq = (t % 4) * 4, m = m0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + kq + j;
        As[kq + j][r] = (m < M && k < K) ? A[(long long)m * K + k] : 0.0f;
      }
    }
    if (TRANS_B) {  // B (N,K): 64 rows n x 16 k
      const int r = t / 4, kq = (t % 4) * 4, n = n0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + kq + j;
        Bs[kq + j][r] = (n < N && k < K) ? Bm[(long long)n * K + k] : 0.0f;
      }
    } else {  // B (K,N): 16 rows k x 64 n
      const int kr = t / 16, nq = (t % 16) * 4, k = k0 + kr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + nq + j;
        Bs[kr][nq + j] = (k < K && n < N) ? Bm[(long long)k * N + n] : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < M && n < N) C[(long long)m * N + n] = acc[i][j];
    }
  }
}

}  // namespace

// imgs (B,H,W) fp32, params (B,4) fp32 rows (sy,ty,sx,tx); scratch wy
// (B,out,H), wx (B,out,W), tmp (B,out,W); out (B,out,out) fp32.
extern "C" int cmx_crop_resize(const void* imgs, const void* params, void* wy,
                               void* wx, void* tmp, void* out, int B, int H,
                               int W, int out_size, int cubic, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto imgs_ = static_cast<const float*>(imgs);
  auto params_ = static_cast<const float*>(params);
  auto wy_ = static_cast<float*>(wy);
  auto wx_ = static_cast<float*>(wx);
  auto tmp_ = static_cast<float*>(tmp);
  auto out_ = static_cast<float*>(out);

  const long long rows = 2LL * B * out_size;
  const unsigned wblocks =
      static_cast<unsigned>((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  crop_weights_kernel<<<wblocks, 32 * kWarpsPerBlock, 0, s>>>(
      params_, wy_, wx_, B, H, W, out_size, cubic);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // tmp (out, W) = wy (out, H) . img (H, W)
  dim3 g1((W + kBN - 1) / kBN, (out_size + kBM - 1) / kBM, B);
  sgemm_batched_kernel<false><<<g1, kGemmThreads, 0, s>>>(wy_, imgs_, tmp_,
                                                          out_size, W, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // out (out, out) = tmp (out, W) . wx (out, W)^T
  dim3 g2((out_size + kBN - 1) / kBN, (out_size + kBM - 1) / kBM, B);
  sgemm_batched_kernel<true><<<g2, kGemmThreads, 0, s>>>(tmp_, wx_, out_,
                                                         out_size, out_size, W);
  return static_cast<int>(cudaGetLastError());
}
