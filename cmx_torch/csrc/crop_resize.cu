// K4: batched crop + resize (RandomResizedCrop's linear map) on the H100.
//
// Replaces the TPU kernel cmx/ops/pallas_crop.py::crop_resize_pallas
// (_crop_kernel, weights _weights_out_in): per image, from the window
// (sy, ty, sx, tx), the resample weights wy (out, H) and wx (out, W) --
// half-pixel centres, the kernel widened by kscale = max(1/s, 1)
// (antialias), linear or Keys cubic a=-0.5, each output row renormalized
// when |total| > 1000*eps, rows whose sample position lies outside
// [-0.5, in-0.5] zeroed -- then out = wy . img . wx^T in fp32. cmx runs both
// products at Precision.HIGHEST, so they stay fp32 FMAs here: no TF32, no
// tensor cores.
//
// Bound on the card: bytes. The pixels inside each image's window in (the
// rows where some wy tap is non-zero times the columns where some wx tap is,
// at most the whole 256 KB image at 256^2) and one crop of out*out*4 bytes
// out (196 KB at 224^2): at most 118.5 MB a launch at batch 256, 0.035 ms at
// 3.35 TB/s, less by the share of the images outside the windows (MoCo's
// windows cover 0.2-1.0 of an image; roofline.crop_work counts it from the
// windows). The y pass below reads the window's rows whole, W wide, so it
// moves more than that bound where a window is narrower than its image. The
// weights are a band: a tap is non-zero only where |sample - i| < R*kscale
// (R = 1 linear, 2 cubic), 2-3 taps a row at MoCo's linear windows, so the
// products are ~0.5 MFLOP an image.
//
// Design: one launch, one block per (image, strip of up to kRows output
// rows); no weight matrix and no intermediate leaves the block.
//   * Band. A row's band is [floor(sample - R*kscale) - 1,
//     ceil(sample + R*kscale) + 1] clipped to the image: every tap outside it
//     is an exact 0 by the formula, so the sums over the band equal the dense
//     sums term for term. The sample position, the taps and the
//     normalization are written with __fmul_rn / __fadd_rn / __fdiv_rn in
//     _weights_out_in's order, so nvcc cannot contract them into FMAs and
//     move a value across the validity edge or the 1000*eps threshold: they
//     equal the plain version's bit for bit. The row total is summed over the
//     band in ascending order (the plain version sums all `in` taps, the
//     extra ones exact zeros), and the products run from the band's first
//     non-zero tap to its last (2.04 taps of a 6-tap band at MoCo's linear
//     windows).
//   * y pass. Thread o < rows computes row o's band and total; the strip's
//     normalized wy taps are staged in shared memory kTaps at a time (a band
//     wider than that, a downscale of 8x or more, takes several chunks), and
//     tmp[o][x] = sum over the band of wy * img[i][x], i ascending, with the
//     threads along x (coalesced image rows; an image stays in L2 across its
//     strips). tmp, rows x W fp32, lives in shared memory: rows = min(kRows,
//     kTmpFloats / W), at least one.
//   * x pass. Thread ox computes column ox's band, total and taps itself (a
//     column's taps serve only it) and sums out[o][ox] = sum over the band of
//     wx * tmp[o][j], j ascending, for the strip's rows in registers; the
//     stores are coalesced along ox. Invalid rows and columns have an empty
//     band and store exact zeros.
// Each sum runs in the order of the dense products (ascending, FMAs), the
// skipped terms being exact zeros. Shared memory: rows*W*4 bytes of tmp plus
// 1.3 KB, whatever the window; W up to kMaxW.
// The TPU kernel's (B,4) SMEM block and its int-iota casts were Mosaic
// workarounds and have no counterpart here.
#include <cfloat>
#include <cuda_runtime.h>

namespace cmx {

constexpr int kThreads = 256;
constexpr int kRows = 16;          // output rows a block, at most
constexpr int kTaps = 16;          // wy taps a row staged at once
constexpr int kTmpFloats = 4096;   // tmp budget (16 KB) that sets the rows
constexpr int kMaxW = 57344;       // one row of tmp in 227 KB
constexpr int kFixedSmem = 4 * (kRows * kTaps + 4 * kRows);

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

template <bool CUBIC>
__device__ __forceinline__ float tap(float sample_f, int i, float kscale) {
  float x = __fdiv_rn(fabsf(__fsub_rn(sample_f, static_cast<float>(i))),
                      kscale);
  return CUBIC ? keys_cubic(x) : fmaxf(__fsub_rn(1.0f, x), 0.0f);
}

// One output row's (or column's) taps i in [lo, lo + n), weight
// tap(sf, i) / den: from the first non-zero tap of its band to the last
// (the rest are exact zeros). n = 0 for a row that is zeroed.
struct Band {
  float sf, den;
  int lo, n;
};

template <bool CUBIC>
__device__ __forceinline__ Band band_of(float s, float t, int o, int in) {
  const float inv = __fdiv_rn(1.0f, s);
  const float kscale = fmaxf(inv, 1.0f);  // antialias
  // (o + 0.5) * inv - t * inv - 0.5, left to right
  const float sf = __fsub_rn(
      __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(o), 0.5f), inv),
                __fmul_rn(t, inv)),
      0.5f);
  Band b{sf, 1.0f, 0, 0};
  const bool valid = sf >= -0.5f &&
                     sf <= __fsub_rn(static_cast<float>(in), 0.5f);
  if (!valid) return b;
  const float reach = (CUBIC ? 2.0f : 1.0f) * kscale;
  const float flo = fmaxf(floorf(sf - reach) - 1.0f, 0.0f);
  const float fhi =
      fminf(ceilf(sf + reach) + 1.0f, static_cast<float>(in - 1));
  float total = 0.0f;
  int first = -1, last = -1;  // the band's first and last non-zero taps
  for (int i = static_cast<int>(flo); i <= static_cast<int>(fhi); ++i) {
    const float w = tap<CUBIC>(sf, i, kscale);
    total = __fadd_rn(total, w);
    if (w != 0.0f) {
      first = first < 0 ? i : first;
      last = i;
    }
  }
  if (!(fabsf(total) > 1000.0f * FLT_EPSILON)) return b;
  b.den = total;  // != 0 here
  b.lo = first;
  b.n = last - first + 1;
  return b;
}

// imgs (B,H,W) fp32, params (B,4) fp32 rows (sy,ty,sx,tx) -> out (B,out,out)
// fp32. Grid: B * ceil(out / rows) blocks, strip fastest.
template <bool CUBIC>
__global__ void __launch_bounds__(kThreads) crop_resize_kernel(
    const float* __restrict__ imgs, const float* __restrict__ params,
    float* __restrict__ out, int H, int W, int out_size, int rows,
    int strips) {
  extern __shared__ float smem[];
  float* tmp = smem;                    // (rows, W)
  float* wys = tmp + rows * W;          // (kRows, kTaps)
  float* rsf = wys + kRows * kTaps;     // (kRows,) sample positions
  float* rden = rsf + kRows;            // (kRows,) totals
  int* rlo = reinterpret_cast<int*>(rden + kRows);
  int* rn = rlo + kRows;
  const int tid = threadIdx.x;
  const int b = blockIdx.x / strips;
  const int o0 = (blockIdx.x - b * strips) * rows;
  const int nr = min(rows, out_size - o0);
  const float sy = params[4 * b], ty = params[4 * b + 1];
  const float sx = params[4 * b + 2], tx = params[4 * b + 3];
  const float kscale_y = fmaxf(__fdiv_rn(1.0f, sy), 1.0f);
  const float kscale_x = fmaxf(__fdiv_rn(1.0f, sx), 1.0f);
  const float* img = imgs + static_cast<size_t>(b) * H * W;

  if (tid < nr) {
    const Band bd = band_of<CUBIC>(sy, ty, o0 + tid, H);
    rsf[tid] = bd.sf;
    rden[tid] = bd.den;
    rlo[tid] = bd.lo;
    rn[tid] = bd.n;
  }
  __syncthreads();
  const int step_o = kThreads / W, step_x = kThreads - step_o * W;
  int chunks = 1;
  for (int o = 0; o < nr; ++o)
    chunks = max(chunks, (rn[o] + kTaps - 1) / kTaps);

  // y pass: tmp[o][x] = sum_i wy[o][i] * img[i][x], i ascending
  for (int c = 0; c < chunks; ++c) {
    const int k0 = c * kTaps;
    for (int e = tid; e < nr * kTaps; e += kThreads) {
      const int o = e / kTaps, k = e - o * kTaps;
      wys[e] = k0 + k < rn[o]
                   ? __fdiv_rn(tap<CUBIC>(rsf[o], rlo[o] + k0 + k, kscale_y),
                               rden[o])
                   : 0.0f;
    }
    __syncthreads();
    int o = tid / W, x = tid - o * W;  // e = o * W + x, stepped
    for (int e = tid; e < nr * W; e += kThreads) {
      const int kn = min(kTaps, rn[o] - k0);
      if (c == 0 || kn > 0) {
        float acc = c ? tmp[e] : 0.0f;
        const float* src = img + static_cast<size_t>(rlo[o] + k0) * W + x;
        const float* w = wys + o * kTaps;
        for (int k = 0; k < kn; ++k)
          acc = fmaf(w[k], src[static_cast<size_t>(k) * W], acc);
        tmp[e] = acc;
      }
      x += step_x;
      o += step_o;
      if (x >= W) {
        x -= W;
        ++o;
      }
    }
    __syncthreads();
  }

  // x pass: out[o][ox] = sum_j wx[ox][j] * tmp[o][j], j ascending
  for (int ox = tid; ox < out_size; ox += kThreads) {
    const Band bd = band_of<CUBIC>(sx, tx, ox, W);
    float acc[kRows];
#pragma unroll
    for (int o = 0; o < kRows; ++o) acc[o] = 0.0f;
    for (int k = 0; k < bd.n; ++k) {
      const int j = bd.lo + k;
      const float w = __fdiv_rn(tap<CUBIC>(bd.sf, j, kscale_x), bd.den);
#pragma unroll
      for (int o = 0; o < kRows; ++o)
        if (o < nr) acc[o] = fmaf(w, tmp[o * W + j], acc[o]);
    }
    float* dst = out + (static_cast<size_t>(b) * out_size + o0) * out_size + ox;
#pragma unroll
    for (int o = 0; o < kRows; ++o)
      if (o < nr) dst[static_cast<size_t>(o) * out_size] = acc[o];
  }
}

template <bool CUBIC>
cudaError_t launch_crop(const float* imgs, const float* params, float* out,
                        int B, int H, int W, int out_size, cudaStream_t s) {
  const int rows = max(1, min(kRows, kTmpFloats / W));
  const int strips = (out_size + rows - 1) / rows;
  const size_t smem = sizeof(float) * rows * W + kFixedSmem;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        crop_resize_kernel<CUBIC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  crop_resize_kernel<CUBIC><<<B * strips, kThreads, smem, s>>>(
      imgs, params, out, H, W, out_size, rows, strips);
  return cudaGetLastError();
}

}  // namespace cmx

// imgs (B,H,W) fp32, params (B,4) fp32 rows (sy,ty,sx,tx) -> out
// (B,out,out) fp32. cudaErrorInvalidValue for W > kMaxW.
extern "C" int cmx_crop_resize(const void* imgs, const void* params, void* out,
                               int B, int H, int W, int out_size, int cubic,
                               void* stream) {
  using namespace cmx;
  if (W < 1 || W > kMaxW || H < 1 || out_size < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B < 1) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto imgs_ = static_cast<const float*>(imgs);
  auto params_ = static_cast<const float*>(params);
  auto out_ = static_cast<float*>(out);
  return static_cast<int>(
      cubic ? launch_crop<true>(imgs_, params_, out_, B, H, W, out_size, s)
            : launch_crop<false>(imgs_, params_, out_, B, H, W, out_size, s));
}
