// Tensor-core 3x3 SAME convolution and weight gradient over bf16 maps in
// either layout of cmx's fused DoubleConv: channels-last (B, H, W, C), the
// NHWC strip family (K7 nhwc_conv_fwd.cu, K8's dX and dW nhwc_conv_bwd.cu),
// and channel-major (B, C, H*W), the flat family (K1 flat_conv_fwd.cu, K2's
// dX and dW flat_conv_bwd.cu). The TPU kernels they stand for are
// cmx/ops/fused_conv.py::conv3x3_mask_stats (_conv_strip: nine shifted MXU
// dots) and ::bwd_mega (_bwd_mega_kernel), and
// cmx/ops/fused_conv_flat.py::flat_conv3x3_mask_stats and ::flat_bwd_mega.
//
// What bounds it on the H100: at the main path's widths (Cin, Cout 64..128)
// the conv does 2*9*Cin flops per output channel and pixel against ~2*(Cin +
// Cout) bytes, far above the ridge point (~295 flop/byte for bf16 tensor
// cores): the bound is the tensor-core rate. The products therefore run as
// implicit GEMMs on the tensor cores, with mma.sync.m16n8k16 (bf16 in, fp32
// accumulate) fed by ldmatrix from shared memory; the move to wgmma + TMA is
// queued in ROADMAP.md.
//
// Forward / dX (conv3x3_mma_body): a block computes an output tile of
// FW_TH x FW_TW = 8 x 32 = 256 pixels (M) by FW_BN = 64 output channels (N);
// K is 9 taps x Cin, walked FW_KC = 16 input channels at a time. Each of the
// 8 warps owns one tile row (32 pixels, two m16 tiles) by the 64 channels
// (eight n8 tiles): 64 fp32 accumulators a thread. Per chunk the block
// stages the (FW_TH+2) x (FW_TW+2) halo tile (zero outside the image and
// past Cin) and the chunk's weights for all nine taps, pre-packed on the
// host into one contiguous zero-padded block (fused_conv._pack_conv_weights),
// with cp.async into a two-stage ring: chunk k+1 streams in while chunk k
// multiplies. For tap (dy, dx) the A operand is the halo tile shifted by
// (dy, dx): a row of A is one pixel's 16 contiguous channels, so ldmatrix
// takes the shifted window's per-lane row addresses directly. The B operand
// (weights, [ci][co] rows) comes through ldmatrix.trans. Rows of both tiles
// are XOR-swizzled at 16-byte granularity, so every ldmatrix phase is free
// of bank conflicts. The epilogue, in registers: v = (acc + bias) * mask,
// per-channel sum and sum of squares in fp32 (warp shuffles across the
// fragment's rows, then shared memory across warps, one partial row per
// block, no atomics), and the bf16 tile staged through shared memory so the
// stores stay 16-byte. Pixels past the right image edge count zero. An
// 8-row tile halves the weight traffic and the halo of a 4-row one and
// measured faster (PERF.md).
//
// The layout (template parameter CM) changes the staging and the store only:
// - Channels-last: a staged halo pixel's 16 channels are 32 contiguous bytes
//   of the tensor, so cp.async writes the swizzled tile itself. The pre-norm
//   prologue bf16(relu(v*inv+shift)*m) is then one pass over the staged tile
//   (halo pixels included, image border left zero) before it multiplies; a
//   thread keeps one 8-channel group, so its inv / shift sit in registers,
//   and the tile's mask rows arrive by cp.async with the first chunk. The
//   output goes out in 16-byte runs of 8 channels of a pixel. With the
//   prologue's fold registers beside the 64 accumulators the pre-norm
//   instance spills 8 bytes under the 128-register cap that keeps two blocks
//   an SM.
// - Channel-major: 16 contiguous bytes are 8 pixels of one channel, and the
//   halo tile's shifted windows start 2 bytes off those words, which neither
//   ldmatrix nor cp.async can take. So cp.async stages the raw words, six a
//   channel and halo row (pixels x0-8 .. x0+39, 16-byte aligned when W % 8
//   == 0; the outer two words give the halo columns x0-1 and x0+32), into
//   the ring as [row][word][channel], and one pass transposes them into the
//   same swizzled pixel-major tile: ldmatrix.trans of eight channel rows of
//   one word hands each lane two channels of one pixel, which it stores as
//   one 32-bit word. The pre-norm prologue rides on that pass (the lane's
//   two inv / shift pairs in registers, the pixel's mask from the staged
//   rows). The output tile is staged [channel][pixel] and goes out in
//   16-byte runs of 8 pixels of a channel.
//
// dW (dw_mma_body): dW[a,b,ci,co] = sum_p h[p+(a-1,b-1), ci] * dy[p, co], a
// GEMM with M = ci, N = co and K = pixels. A block owns one kernel row a
// (three taps), 64 input x 64 output channels and a run of 4 x 32-pixel
// tiles (the bounded split-K grid: one fp32 partial per block, summed by the
// wrapper). h is staged pixel-major (channels contiguous) and comes through
// ldmatrix.trans; the dy fragment of a 16-pixel slice serves all three taps.
// 48 fp32 accumulators a thread, no spills. The grid puts the kernel row
// fastest, so the blocks that read the same pixels run together and share
// them through L2. The pre-norm prologue runs as in the forward, once a
// staged tile (with the tile's mask rows). Channels-last, dy is staged
// pixel-major and read through ldmatrix.trans; channel-major, h's raw words
// are transposed as in the forward, while dy's channel rows are already the
// GEMM's B columns: cp.async stages them as they are ([co][pixel], swizzled)
// and plain ldmatrix reads them.
#pragma once

#include <atomic>

#include "conv3x3_common.cuh"

namespace cmx {

// Raise kernel Kern's dynamic shared memory limit to Bytes, once for each
// device (the attribute holds per device), not at every launch.
template <auto Kern, int Bytes>
inline cudaError_t smem_attr_once() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev < kMaxDevices;
  if (cached && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Bytes);
  if (err == cudaSuccess && cached)
    done[dev].store(true, std::memory_order_release);
  return err;
}

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !pred (nothing is read then).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk c of row `row` in a tile of 128-byte rows,
// XOR-swizzled: any 8 consecutive rows at one chunk hit 8 distinct bank
// groups.
__device__ __forceinline__ int sw128(int row, int c) {
  return row * 128 + ((c ^ (row & 7)) << 4);
}

__device__ __forceinline__ bool inside(int gy, int gx, int H, int W) {
  return gy >= 0 && gy < H && gx >= 0 && gx < W;
}

// Stage 8 bf16 channels [ch, ch+8) of one pixel into shared memory: with
// cp.async when vec (16-byte aligned rows), else element by element; zeros
// when the pixel is outside (ok false) or past C.
__device__ __forceinline__ void stage8(char* sp, uint32_t sa,
                                       const __nv_bfloat16* __restrict__ base,
                                       const __nv_bfloat16* __restrict__ p,
                                       bool ok, int ch, int C, int vec) {
  if (vec) {
    const bool v = ok && ch < C;
    cp_async16(sa, v ? p : base, v);
  } else {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = (ok && ch + k < C) ? __bfloat162float(p[k]) : 0.f;
    *reinterpret_cast<uint4*>(sp) = pack8(v);
  }
}

// inv / shift of the 8 channels [ch, ch+8) into registers, 0 past C: the
// prologue then keeps a zero-filled channel zero.
__device__ __forceinline__ void load_fold8(const float* __restrict__ inv,
                                           const float* __restrict__ shift,
                                           int ch, int C, float (&iv)[8],
                                           float (&sv)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const bool ok = ch + k < C;
    iv[k] = ok ? inv[ch + k] : 0.f;
    sv[k] = ok ? shift[ch + k] : 0.f;
  }
}

// The pre-norm prologue on 8 staged channels of one in-image pixel.
__device__ __forceinline__ void prenorm8(char* sp, const float (&iv)[8],
                                         const float (&sv)[8], float mv) {
  uint4* q = reinterpret_cast<uint4*>(sp);
  float v[8];
  unpack8(*q, v);
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = prenorm(v[k], iv[k], sv[k], mv);
  *q = pack8(v);
}

// The pre-norm prologue on two channels (a bf16 pair) of one pixel, with
// their inv / shift at iv[k], sv[k] and iv[k+1], sv[k+1].
__device__ __forceinline__ uint32_t prenorm2(uint32_t u, const float* iv,
                                             const float* sv, int k,
                                             float mv) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  const __nv_bfloat162 o = __floats2bfloat162_rn(
      prenorm(f.x, iv[k], sv[k], mv), prenorm(f.y, iv[k + 1], sv[k + 1], mv));
  return *reinterpret_cast<const uint32_t*>(&o);
}

// A tile's mask row: pixels [x0-8, x0+40) of image row gy as MROW bf16 in
// six 16-byte chunks (zero outside the image; W % 8 == 0 keeps a chunk
// whole), so tile column x0-1+j sits at index j+7. Chunk c of the row.
constexpr int MROW = 48;
__device__ __forceinline__ void stage_mask16(uint32_t sa,
                                             const __nv_bfloat16* __restrict__ mask,
                                             int n, int gy, int x0, int H,
                                             int W, int c) {
  const int gx = x0 - 8 + 8 * c;
  const bool ok = inside(gy, gx, H, W);
  cp_async16(sa + 16 * c, ok ? mask + ((size_t)n * H + gy) * W + gx : mask,
             ok);
}

// Channel-major staging: RAW_W 16-byte words of one channel's image row,
// pixels [x0-8, x0+40), the words that hold a tile row and its two halo
// columns (the MROW pixels of a mask row). Word w, pixel j of it is tile
// column 8w+j-7.
constexpr int RAW_W = MROW / 8;

// Stage pixels [gx, gx+8) of row gy of channel ci of the channel-major map
// src (B, C, H, W) with cp.async (gx % 8 == 0): zeros outside the image and
// past C.
__device__ __forceinline__ void stage_raw16(uint32_t sa,
                                            const __nv_bfloat16* __restrict__ src,
                                            int n, int ci, int C, int gy,
                                            int gx, int H, int W) {
  const bool ok = ci < C && inside(gy, gx, H, W);
  cp_async16(sa, ok ? src + (((size_t)n * C + ci) * H + gy) * W + gx : src,
             ok);
}

// ---------------------------------------------------------------------------
// Forward / dX: implicit GEMM over the shifted halo tile
// ---------------------------------------------------------------------------

// Tile geometry. The wrappers (fused_conv.py, _MMA_*) pack the weights and
// size the partial sums by it, and check it against cmx_mma_geometry() when
// they load a library.
constexpr int FW_TH = 8;                  // output rows a block
constexpr int FW_TW = 32;                 // output columns a block
constexpr int FW_BN = 64;                 // output channels a block
constexpr int FW_KC = 16;                 // input channels a stage
constexpr int FW_STAGES = 2;              // depth of the cp.async ring
constexpr int FW_NT = 256;                // 8 warps, one output row each
constexpr int FW_NJ = FW_BN / 8;          // n-tiles (8 channels) a warp
constexpr int FW_CH = FW_KC / 8;          // 16-byte chunks a staged pixel
constexpr int FW_HALO_W = FW_TW + 2;
constexpr int FW_HALO = (FW_TH + 2) * FW_HALO_W;
constexpr int FW_A_BYTES = FW_HALO * FW_KC * 2;
constexpr int FW_B_BYTES = 9 * FW_KC * FW_BN * 2;
constexpr int FW_STAGE = FW_A_BYTES + FW_B_BYTES;
constexpr int FW_OUT_LD = FW_BN + 8;      // staged output row
constexpr int FW_EPI_BYTES = FW_TH * FW_TW * FW_OUT_LD * 2 + 2 * FW_TH * FW_BN * 4;
// The ring (or, after it, the epilogue's staged tile and stats), then the
// halo tile's mask rows.
constexpr int FW_MASK_OFF = FW_STAGES * FW_STAGE > FW_EPI_BYTES
                                ? FW_STAGES * FW_STAGE
                                : FW_EPI_BYTES;
constexpr int FW_SMEM = FW_MASK_OFF + (FW_TH + 2) * MROW * 2;
static_assert(FW_NT == 32 * FW_TH, "one warp an output row");

// Channel-major: a ring stage holds the chunk's raw words, [halo row][word]
// [channel] (FW_CM_RAW_BYTES), then its weights; the transposed halo tile
// sits after the ring; the epilogue stages the output tile [channel][pixel]
// in rows of FW_CM_OUT_LD.
constexpr int FW_CM_RAW = (FW_TH + 2) * RAW_W * FW_KC;  // raw words a chunk
constexpr int FW_CM_RAW_BYTES = FW_CM_RAW * 16;
constexpr int FW_CM_STAGE = FW_CM_RAW_BYTES + FW_B_BYTES;
constexpr int FW_CM_TILE_OFF = FW_STAGES * FW_CM_STAGE;
constexpr int FW_CM_OUT_LD = FW_TH * FW_TW + 8;
constexpr int FW_CM_EPI_BYTES = FW_BN * FW_CM_OUT_LD * 2 + 2 * FW_TH * FW_BN * 4;
constexpr int FW_CM_MASK_OFF = FW_CM_TILE_OFF + FW_A_BYTES > FW_CM_EPI_BYTES
                                   ? FW_CM_TILE_OFF + FW_A_BYTES
                                   : FW_CM_EPI_BYTES;
constexpr int FW_CM_SMEM = FW_CM_MASK_OFF + (FW_TH + 2) * MROW * 2;
// ldmatrix.x4 groups of the transpose pass: four 8-channel x 8-pixel blocks.
constexpr int FW_CM_NQ = FW_CM_RAW / 32;
static_assert(FW_CM_RAW % 32 == 0, "whole ldmatrix.x4 groups");

// Offset of 16-byte chunk c of staged halo pixel p (32-byte rows of FW_KC
// channels), XOR-swizzled: any 8 consecutive pixels at one chunk hit 8
// distinct bank groups.
__device__ __forceinline__ int fw_a_off(int p, int c) {
  return p * 32 + ((c ^ ((p >> 2) & 1)) << 4);
}

// out[n,y,x,co] = sum_{t,ci} h[n, y+t/3-1, x+t%3-1, ci] * w[t, ci, co]
// (indices written channels-last; CM picks the memory layout of src and
// out), h = src or, with PRENORM, bf16(relu(src*inv+shift)*m) inside the
// image and 0 outside. wpack: the (ceil(Cout/FW_BN), ceil(Cin/FW_KC), 9,
// FW_KC, FW_BN) zero-padded packing of w (9, Cin, Cout). With STATS: v =
// (acc+bias)*m, out = bf16(v), and the block's per-channel sum / sum of
// squares of v go to part[blockIdx.x, {0,1}, co]; without: out = bf16(acc)
// (the dX of K2 / K8). vec_in / vec_out (channels-last only): 16-byte
// copies of 8 channels.
template <bool CM, bool PRENORM, bool STATS>
__device__ __forceinline__ void conv3x3_mma_body(
    const __nv_bfloat16* __restrict__ src,   // (B, H, W, Cin) / (B, Cin, H, W)
    const __nv_bfloat16* __restrict__ mask,  // (B, H, W)  PRENORM or STATS
    const float* __restrict__ inv,           // (Cin,)     PRENORM only
    const float* __restrict__ shift,         // (Cin,)     PRENORM only
    const __nv_bfloat16* __restrict__ wpack,
    const float* __restrict__ bias,          // (Cout,)    STATS only
    __nv_bfloat16* __restrict__ out,         // (B, H, W, Cout) / (B, Cout, H, W)
    float* __restrict__ part,                // (gridDim.x, 2, Cout) STATS only
    int Cin, int Cout, int H, int W, int vec_in, int vec_out) {
  constexpr int STAGE = CM ? FW_CM_STAGE : FW_STAGE;
  constexpr int A_STAGE = CM ? FW_CM_RAW_BYTES : FW_A_BYTES;
  constexpr int MASK_OFF = CM ? FW_CM_MASK_OFF : FW_MASK_OFF;
  constexpr int OT_BYTES = CM ? FW_BN * FW_CM_OUT_LD * 2
                              : FW_TH * FW_TW * FW_OUT_LD * 2;
  extern __shared__ __align__(128) char smem[];
  const uint32_t sbase = smem_u32(smem);
  const int tiles_x = (W + FW_TW - 1) / FW_TW, tiles_y = H / FW_TH;
  const int tile = blockIdx.x;
  const int n = tile / (tiles_x * tiles_y);
  const int rem = tile % (tiles_x * tiles_y);
  const int ty0 = (rem / tiles_x) * FW_TH, tx0 = (rem % tiles_x) * FW_TW;
  const int nb = blockIdx.y, co0 = nb * FW_BN;
  const int nch = (Cin + FW_KC - 1) / FW_KC;
  const int tid = threadIdx.x, lane = tid & 31;
  const int wm = tid >> 5;  // the warp's output row (32 pixels, 2 m-tiles)

  auto stage = [&](int kc, int buf) {
    char* sp = smem + buf * STAGE;
    const uint32_t sa = sbase + buf * STAGE;
    const int ci0 = kc * FW_KC;
    if constexpr (CM) {
      for (int i = tid; i < FW_CM_RAW; i += FW_NT) {
        const int w = i % RAW_W, rest = i / RAW_W;
        const int hy = rest % (FW_TH + 2), ch = rest / (FW_TH + 2);
        stage_raw16(sa + ((hy * RAW_W + w) * FW_KC + ch) * 16, src, n,
                    ci0 + ch, Cin, ty0 + hy - 1, tx0 - 8 + 8 * w, H, W);
      }
    } else {
      for (int i = tid; i < FW_HALO * FW_CH; i += FW_NT) {
        const int p = i / FW_CH, c = i % FW_CH;
        const int gy = ty0 + p / FW_HALO_W - 1, gx = tx0 + p % FW_HALO_W - 1;
        const bool in = inside(gy, gx, H, W);
        const int ch = ci0 + c * 8;
        const __nv_bfloat16* gp =
            src + (in ? (((size_t)n * H + gy) * W + gx) * Cin + ch : 0);
        stage8(sp + fw_a_off(p, c), sa + fw_a_off(p, c), src, gp, in, ch, Cin,
               vec_in);
      }
    }
    const __nv_bfloat16* wsrc =
        wpack + ((size_t)nb * nch + kc) * (9 * FW_KC * FW_BN);
    const uint32_t sb = sa + A_STAGE;
    for (int i = tid; i < 9 * FW_KC * 8; i += FW_NT)
      cp_async16(sb + sw128(i >> 3, i & 7), wsrc + (size_t)i * 8, true);
  };

  float acc[2][FW_NJ][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < FW_NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  const __nv_bfloat16* mrow =
      reinterpret_cast<const __nv_bfloat16*>(smem + MASK_OFF);
  if ((PRENORM || STATS) && tid < (FW_TH + 2) * 6)
    stage_mask16(sbase + MASK_OFF + (tid / 6) * MROW * 2, mask, n,
                 ty0 + tid / 6 - 1, tx0, H, W, tid % 6);
#pragma unroll
  for (int s = 0; s < FW_STAGES - 1; ++s) {
    if (s < nch) stage(s, s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nch; ++kc) {
    const int buf = kc % FW_STAGES;
    if (kc + FW_STAGES - 1 < nch)
      stage(kc + FW_STAGES - 1, (kc + FW_STAGES - 1) % FW_STAGES);
    cp_async_commit();
    cp_async_wait<FW_STAGES - 1>();
    __syncthreads();
    if constexpr (CM) {
      // Transpose the raw words into the halo tile, four 8x8 blocks a
      // ldmatrix.x4.trans: block m = 2*(hy*RAW_W + w) + channel group, and
      // the lane gets pixel lane/4 of word w, channels 2*(lane%4) + {0, 1}.
      const uint32_t raw = sbase + buf * STAGE;
      char* at = smem + FW_CM_TILE_OFF;
      const int j = lane >> 2, cq = 2 * (lane & 3);
      float iv[4], sv[4];  // channels cg*8 + cq + {0, 1} at [2cg], [2cg+1]
      if constexpr (PRENORM) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int ch = kc * FW_KC + 8 * (k >> 1) + cq + (k & 1);
          iv[k] = ch < Cin ? inv[ch] : 0.f;
          sv[k] = ch < Cin ? shift[ch] : 0.f;
        }
      }
      for (int q = wm; q < FW_CM_NQ; q += FW_NT / 32) {
        uint32_t r[4];
        ldsm_x4_t(r, raw + (32 * q + lane) * 16);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int hw = (4 * q + i) >> 1, cg = i & 1;
          const int hy = hw / RAW_W, w = hw % RAW_W;
          const int hx = 8 * w + j - 7;
          if (hx < 0 || hx >= FW_HALO_W) continue;
          uint32_t v = r[i];
          if constexpr (PRENORM)
            v = prenorm2(v, iv, sv, 2 * cg,
                         __bfloat162float(mrow[hy * MROW + 8 * w + j]));
          *reinterpret_cast<uint32_t*>(
              at + fw_a_off(hy * FW_HALO_W + hx, cg) + 2 * cq) = v;
        }
      }
      __syncthreads();
    } else if (PRENORM) {
      // A thread keeps one 8-channel group of the chunk: its inv / shift
      // sit in registers, the mask comes from the staged rows.
      char* sp = smem + buf * FW_STAGE;
      const int c = tid % FW_CH;
      float iv[8], sv[8];
      load_fold8(inv, shift, kc * FW_KC + 8 * c, Cin, iv, sv);
      for (int p = tid / FW_CH; p < FW_HALO; p += FW_NT / FW_CH) {
        const int hy = p / FW_HALO_W, hx = p % FW_HALO_W;
        if (!inside(ty0 + hy - 1, tx0 + hx - 1, H, W)) continue;
        prenorm8(sp + fw_a_off(p, c), iv, sv,
                 __bfloat162float(mrow[hy * MROW + hx + 7]));
      }
      __syncthreads();
    }
    const uint32_t sb = sbase + buf * STAGE + A_STAGE;
    const uint32_t sa = CM ? sbase + FW_CM_TILE_OFF : sbase + buf * STAGE;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int dy = t / 3, dx = t % 3;
#pragma unroll
      for (int ks = 0; ks < FW_KC / 16; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int p = (wm + dy) * FW_HALO_W + 16 * mt + (lane & 15) + dx;
          ldsm_x4(a[mt], sa + fw_a_off(p, 2 * ks + (lane >> 4)));
        }
        uint32_t b[FW_NJ][2];
#pragma unroll
        for (int jj = 0; jj < FW_NJ / 2; ++jj) {
          const int row = t * FW_KC + 16 * ks + (lane & 7) + (lane & 8);
          uint32_t r[4];
          ldsm_x4_t(r, sb + sw128(row, 2 * jj + (lane >> 4)));
          b[2 * jj][0] = r[0];
          b[2 * jj][1] = r[1];
          b[2 * jj + 1][0] = r[2];
          b[2 * jj + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int j = 0; j < FW_NJ; ++j)
            mma_bf16(acc[mt][j], a[mt], b[j][0], b[j][1]);
      }
    }
    __syncthreads();
  }

  // Epilogue. The ring is free: stage the bf16 tile (and the stats) there.
  __nv_bfloat16* ot = reinterpret_cast<__nv_bfloat16*>(smem);
  float* red = reinterpret_cast<float*>(smem + OT_BYTES);
  const int g = lane >> 2, tq = lane & 3;
  float mv[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      mv[mt][h] = STATS ? __bfloat162float(
                              mrow[(wm + 1) * MROW + 16 * mt + g + 8 * h + 8])
                        : 0.f;
  // One n-tile at a time, so few values live beside the accumulators.
#pragma unroll
  for (int j = 0; j < FW_NJ; ++j) {
    const int nl = 8 * j + 2 * tq;
    const float b0 = (STATS && co0 + nl < Cout) ? bias[co0 + nl] : 0.f;
    const float b1 = (STATS && co0 + nl + 1 < Cout) ? bias[co0 + nl + 1] : 0.f;
    float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[mt][j][2 * h], v1 = acc[mt][j][2 * h + 1];
        if (STATS) {
          v0 = (v0 + b0) * mv[mt][h];
          v1 = (v1 + b1) * mv[mt][h];
          s0 += v0;
          q0 += v0 * v0;
          s1 += v1;
          q1 += v1 * v1;
        }
        const int p = wm * FW_TW + 16 * mt + g + 8 * h;
        if constexpr (CM) {
          ot[nl * FW_CM_OUT_LD + p] = __float2bfloat16(v0);
          ot[(nl + 1) * FW_CM_OUT_LD + p] = __float2bfloat16(v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(ot + p * FW_OUT_LD + nl) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    if (STATS) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        q0 += __shfl_xor_sync(0xffffffffu, q0, off);
        q1 += __shfl_xor_sync(0xffffffffu, q1, off);
      }
      if (g == 0) {
        red[wm * FW_BN + nl] = s0;
        red[wm * FW_BN + nl + 1] = s1;
        red[FW_TH * FW_BN + wm * FW_BN + nl] = q0;
        red[FW_TH * FW_BN + wm * FW_BN + nl + 1] = q1;
      }
    }
  }
  __syncthreads();
  if (STATS && tid < FW_BN && co0 + tid < Cout) {
    float S = 0.f, Q = 0.f;
#pragma unroll
    for (int w = 0; w < FW_TH; ++w) {
      S += red[w * FW_BN + tid];
      Q += red[FW_TH * FW_BN + w * FW_BN + tid];
    }
    part[((size_t)tile * 2 + 0) * Cout + co0 + tid] = S;
    part[((size_t)tile * 2 + 1) * Cout + co0 + tid] = Q;
  }
  if constexpr (CM) {
    // 16-byte runs of 8 pixels of one channel: word wq of channel c is tile
    // row wq / 4, columns 8 * (wq % 4) ..
    constexpr int WPC = FW_TH * FW_TW / 8;  // words a channel
    for (int i = tid; i < FW_BN * WPC; i += FW_NT) {
      const int c = i / WPC, wq = i % WPC;
      const int oy = ty0 + wq / (FW_TW / 8), ox = tx0 + 8 * (wq % (FW_TW / 8));
      if (ox >= W || co0 + c >= Cout) continue;
      *reinterpret_cast<uint4*>(
          out + (((size_t)n * Cout + co0 + c) * H + oy) * W + ox) =
          *reinterpret_cast<const uint4*>(ot + c * FW_CM_OUT_LD + 8 * wq);
    }
  } else {
    for (int i = tid; i < FW_TH * FW_TW * (FW_BN / 8); i += FW_NT) {
      const int p = i >> 3, c = i & 7;
      const int oy = ty0 + p / FW_TW, ox = tx0 + p % FW_TW, cb = co0 + c * 8;
      if (ox >= W || cb >= Cout) continue;
      const __nv_bfloat16* sp = ot + p * FW_OUT_LD + c * 8;
      __nv_bfloat16* dst = out + (((size_t)n * H + oy) * W + ox) * Cout + cb;
      if (vec_out) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(sp);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (cb + k < Cout) dst[k] = sp[k];
      }
    }
  }
}

// The channels-last instances (K7, K8's dX) and the channel-major ones (K1,
// K2's dX): one body, two kernel names.
template <bool PRENORM, bool STATS>
__global__ void __launch_bounds__(FW_NT, 2) conv3x3_mma_kernel(
    const __nv_bfloat16* __restrict__ src,
    const __nv_bfloat16* __restrict__ mask, const float* __restrict__ inv,
    const float* __restrict__ shift, const __nv_bfloat16* __restrict__ wpack,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part, int Cin, int Cout, int H, int W, int vec_in,
    int vec_out) {
  conv3x3_mma_body<false, PRENORM, STATS>(src, mask, inv, shift, wpack, bias,
                                          out, part, Cin, Cout, H, W, vec_in,
                                          vec_out);
}

template <bool PRENORM, bool STATS>
__global__ void __launch_bounds__(FW_NT, 2) flat_conv3x3_mma_kernel(
    const __nv_bfloat16* __restrict__ src,
    const __nv_bfloat16* __restrict__ mask, const float* __restrict__ inv,
    const float* __restrict__ shift, const __nv_bfloat16* __restrict__ wpack,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part, int Cin, int Cout, int H, int W, int vec_in,
    int vec_out) {
  conv3x3_mma_body<true, PRENORM, STATS>(src, mask, inv, shift, wpack, bias,
                                         out, part, Cin, Cout, H, W, vec_in,
                                         vec_out);
}

// The kernel of layout CM (only that one is instantiated).
template <bool CM, bool PRENORM, bool STATS>
constexpr auto conv3x3_mma_kernel_of() {
  if constexpr (CM) return flat_conv3x3_mma_kernel<PRENORM, STATS>;
  else return conv3x3_mma_kernel<PRENORM, STATS>;
}

// Launch over the whole output (the wrappers check H % FW_TH == 0 and W % 8
// == 0). part, with STATS, holds B * (H / FW_TH) * ceil(W / FW_TW) rows.
// Channel-major (CM) needs src, out and mask 16-byte aligned.
template <bool CM, bool PRENORM, bool STATS>
inline cudaError_t launch_conv3x3_mma(const __nv_bfloat16* src,
                                      const __nv_bfloat16* mask,
                                      const float* inv, const float* shift,
                                      const __nv_bfloat16* wpack,
                                      const float* bias, __nv_bfloat16* out,
                                      float* part, int B, int Cin, int Cout,
                                      int H, int W, cudaStream_t stream) {
  if (!aligned16(wpack) || ((PRENORM || STATS) && !aligned16(mask)) ||
      (CM && !(aligned16(src) && aligned16(out))))
    return cudaErrorMisalignedAddress;
  constexpr auto kern = conv3x3_mma_kernel_of<CM, PRENORM, STATS>();
  constexpr int smem = CM ? FW_CM_SMEM : FW_SMEM;
  const cudaError_t err = smem_attr_once<kern, smem>();
  if (err != cudaSuccess) return err;
  dim3 grid(B * (H / FW_TH) * ((W + FW_TW - 1) / FW_TW),
            (Cout + FW_BN - 1) / FW_BN);
  const int vec_in = !CM && Cin % 8 == 0 && aligned16(src);
  const int vec_out = !CM && Cout % 8 == 0 && aligned16(out);
  kern<<<grid, FW_NT, smem, stream>>>(src, mask, inv, shift, wpack, bias, out,
                                      part, Cin, Cout, H, W, vec_in, vec_out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dW: pixels as the K dimension, three taps of one kernel row a block
// ---------------------------------------------------------------------------

constexpr int DWM_TR = 4;                          // pixel tile rows
constexpr int DWM_TC = 32;                         // pixel tile columns
constexpr int DWM_P = DWM_TR * DWM_TC;             // 128 pixels a tile
constexpr int DWM_CI = 64;                         // input channels a block
constexpr int DWM_CO = 64;                         // output channels a block
constexpr int DWM_NT = 256;                        // 8 warps: 4 (ci) x 2 (co)
constexpr int DWM_HW = DWM_TC + 2;                 // 34 staged h columns
constexpr int DWM_H_BYTES = DWM_TR * DWM_HW * 128; // 17,408
constexpr int DWM_D_BYTES = DWM_P * 128;           // 16,384
constexpr int DWM_M_BYTES = DWM_TR * MROW * 2;     // 384: the h rows' mask
constexpr int DWM_STAGE = DWM_H_BYTES + DWM_D_BYTES + DWM_M_BYTES;
constexpr int DWM_STAGES = 2;                      // depth of the cp.async ring
constexpr int DWM_SMEM = DWM_STAGES * DWM_STAGE;
// Channel-major: a ring stage holds h's raw words [row][word][channel], then
// dy [co][pixel] (the same bytes as channels-last's pixel-major dy) and the
// mask rows; the transposed h tile sits after the ring.
constexpr int DWM_CM_RAW = DWM_TR * RAW_W * DWM_CI;      // raw words a tile
constexpr int DWM_CM_RAW_BYTES = DWM_CM_RAW * 16;        // 24,576
constexpr int DWM_CM_STAGE = DWM_CM_RAW_BYTES + DWM_D_BYTES + DWM_M_BYTES;
constexpr int DWM_CM_TILE_OFF = DWM_STAGES * DWM_CM_STAGE;
constexpr int DWM_CM_SMEM = DWM_CM_TILE_OFF + DWM_H_BYTES;
constexpr int DWM_CM_NQ = DWM_CM_RAW / 32;  // ldmatrix.x4 groups a tile
static_assert(DWM_CM_RAW % 32 == 0 && DWM_CM_NQ % 2 == 0,
              "a warp's transpose blocks keep one channel half");

// Byte offset of 16-byte chunk c (pixels 8c..8c+7 of the tile) of output
// channel co in the channel-major dy tile (256-byte rows), XOR-swizzled as
// sw128: 8 consecutive channels at one chunk hit 8 distinct bank groups.
__device__ __forceinline__ int dwm_d_off(int co, int c) {
  return co * (DWM_P * 2) + ((c ^ (co & 7)) << 4);
}

// Block (blockIdx.x = a + 3*(ci block + ceil(Cin/64) * co block), blockIdx.y
// = chunk): part[chunk, 3a+b, ci, co] = sum over the chunk's pixel tiles of
// h[p+(a-1,b-1), ci] * dy[p, co] (indices written channels-last; CM picks
// the memory layout of src and dy), h = src or, with PRENORM,
// bf16(relu(src*inv+shift)*m) (0 outside the image). The pixel tiles are
// B * (H / DWM_TR) * ceil(W / DWM_TC), in runs of tiles_per_chunk.
template <bool CM, bool PRENORM>
__device__ __forceinline__ void dw_mma_body(
    const __nv_bfloat16* __restrict__ src,   // (B, H, W, Cin) / (B, Cin, H, W)
    const __nv_bfloat16* __restrict__ mask,  // (B, H, W) PRENORM only
    const float* __restrict__ inv,           // (Cin,)    PRENORM only
    const float* __restrict__ shift,         // (Cin,)    PRENORM only
    const __nv_bfloat16* __restrict__ dy,    // (B, H, W, Cout) / (B, Cout, H, W)
    float* __restrict__ part,                // (nchunks, 9, Cin, Cout)
    int B, int Cin, int Cout, int H, int W, int tiles_per_chunk, int vec_in,
    int vec_dy) {
  constexpr int STAGE = CM ? DWM_CM_STAGE : DWM_STAGE;
  constexpr int H_STAGE = CM ? DWM_CM_RAW_BYTES : DWM_H_BYTES;
  extern __shared__ __align__(128) char smem[];
  const uint32_t sbase = smem_u32(smem);
  const int nci = (Cin + DWM_CI - 1) / DWM_CI;
  const int a = blockIdx.x % 3;
  const int ci0 = ((blockIdx.x / 3) % nci) * DWM_CI;
  const int co0 = (blockIdx.x / (3 * nci)) * DWM_CO;
  const int chunk = blockIdx.y;
  const int tiles_x = (W + DWM_TC - 1) / DWM_TC, tiles_y = H / DWM_TR;
  const int total = B * tiles_x * tiles_y;
  const int t_begin = chunk * tiles_per_chunk;
  const int t_end = min(total, t_begin + tiles_per_chunk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3;   // 16 input channels (one m-tile)
  const int wn = warp >> 2;  // 32 output channels (4 n-tiles)

  auto origin = [&](int t, int& n, int& ty0, int& tx0) {
    n = t / (tiles_x * tiles_y);
    const int rem = t % (tiles_x * tiles_y);
    ty0 = (rem / tiles_x) * DWM_TR;
    tx0 = (rem % tiles_x) * DWM_TC;
  };
  // h rows ty0+a-1 .. ty0+a+2, columns tx0-1 .. tx0+32; dy rows ty0 .. +3.
  auto stage = [&](int t, int buf) {
    int n, ty0, tx0;
    origin(t, n, ty0, tx0);
    char* sp = smem + buf * STAGE;
    const uint32_t sa = sbase + buf * STAGE;
    if constexpr (CM) {
      for (int i = tid; i < DWM_CM_RAW; i += DWM_NT) {
        const int w = i % RAW_W, rest = i / RAW_W;
        const int r = rest % DWM_TR, ci = rest / DWM_TR;
        stage_raw16(sa + ((r * RAW_W + w) * DWM_CI + ci) * 16, src, n,
                    ci0 + ci, Cin, ty0 + r + a - 1, tx0 - 8 + 8 * w, H, W);
      }
      constexpr int WPC = DWM_P / 8;  // dy words a channel
      for (int i = tid; i < DWM_CO * WPC; i += DWM_NT) {
        const int co = i / WPC, c = i % WPC;
        stage_raw16(sa + DWM_CM_RAW_BYTES + dwm_d_off(co, c), dy, n, co0 + co,
                    Cout, ty0 + c / (DWM_TC / 8), tx0 + 8 * (c % (DWM_TC / 8)),
                    H, W);
      }
    } else {
      for (int i = tid; i < DWM_TR * DWM_HW * 8; i += DWM_NT) {
        const int p = i >> 3, c = i & 7;
        const int gy = ty0 + p / DWM_HW + a - 1, gx = tx0 + p % DWM_HW - 1;
        const bool in = inside(gy, gx, H, W);
        const int ch = ci0 + c * 8;
        const __nv_bfloat16* gp =
            src + (in ? (((size_t)n * H + gy) * W + gx) * Cin + ch : 0);
        stage8(sp + sw128(p, c), sa + sw128(p, c), src, gp, in, ch, Cin,
               vec_in);
      }
      for (int i = tid; i < DWM_P * 8; i += DWM_NT) {
        const int p = i >> 3, c = i & 7;
        const int gy = ty0 + p / DWM_TC, gx = tx0 + p % DWM_TC;
        const bool in = gx < W;
        const int ch = co0 + c * 8;
        const __nv_bfloat16* gp =
            dy + (in ? (((size_t)n * H + gy) * W + gx) * Cout + ch : 0);
        stage8(sp + DWM_H_BYTES + sw128(p, c), sa + DWM_H_BYTES + sw128(p, c),
               dy, gp, in, ch, Cout, vec_dy);
      }
    }
    if (PRENORM && tid < DWM_TR * 6)
      stage_mask16(sa + H_STAGE + DWM_D_BYTES + (tid / 6) * MROW * 2, mask, n,
                   ty0 + tid / 6 + a - 1, tx0, H, W, tid % 6);
  };

  float acc[3][4][4];
#pragma unroll
  for (int b = 0; b < 3; ++b)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[b][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < DWM_STAGES - 1; ++s) {
    if (t_begin + s < t_end) stage(t_begin + s, s);
    cp_async_commit();
  }
  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) % DWM_STAGES;
    if (t + DWM_STAGES - 1 < t_end)
      stage(t + DWM_STAGES - 1, (t - t_begin + DWM_STAGES - 1) % DWM_STAGES);
    cp_async_commit();
    cp_async_wait<DWM_STAGES - 1>();
    __syncthreads();
    if constexpr (CM) {
      // Transpose h's raw words into the pixel-major tile, as the forward
      // does: block m = 8*(r*RAW_W + w) + channel group. A warp's groups q
      // keep the parity of the warp, so its lanes keep the same four channel
      // groups 4*(warp&1) + i, whose inv / shift pairs sit in registers.
      const uint32_t raw = sbase + buf * STAGE;
      char* ht = smem + DWM_CM_TILE_OFF;
      const __nv_bfloat16* mrow = reinterpret_cast<const __nv_bfloat16*>(
          smem + buf * STAGE + H_STAGE + DWM_D_BYTES);
      const int j = lane >> 2, cq = 2 * (lane & 3);
      float iv[8], sv[8];  // channel group 4*(warp&1)+i: [2i], [2i+1]
      if constexpr (PRENORM) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int ch = ci0 + 8 * (4 * (warp & 1) + (k >> 1)) + cq + (k & 1);
          iv[k] = ch < Cin ? inv[ch] : 0.f;
          sv[k] = ch < Cin ? shift[ch] : 0.f;
        }
      }
      for (int q = warp; q < DWM_CM_NQ; q += DWM_NT / 32) {
        uint32_t rr[4];
        ldsm_x4_t(rr, raw + (32 * q + lane) * 16);
        const int rw = q >> 1, r = rw / RAW_W, w = rw % RAW_W;
        const int hx = 8 * w + j - 7;
        if (hx < 0 || hx >= DWM_HW) continue;
        const int p = r * DWM_HW + hx;
        const float mv =
            PRENORM ? __bfloat162float(mrow[r * MROW + 8 * w + j]) : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t v = rr[i];
          if constexpr (PRENORM) v = prenorm2(v, iv, sv, 2 * i, mv);
          *reinterpret_cast<uint32_t*>(
              ht + sw128(p, 4 * (q & 1) + i) + 2 * cq) = v;
        }
      }
      __syncthreads();
    } else if (PRENORM) {
      // A thread keeps one 8-channel group: its inv / shift in registers,
      // the mask from the staged rows.
      int n, ty0, tx0;
      origin(t, n, ty0, tx0);
      char* sp = smem + buf * DWM_STAGE;
      const __nv_bfloat16* mrow = reinterpret_cast<const __nv_bfloat16*>(
          sp + DWM_H_BYTES + DWM_D_BYTES);
      const int c = tid & 7;
      float iv[8], sv[8];
      load_fold8(inv, shift, ci0 + 8 * c, Cin, iv, sv);
      for (int p = tid >> 3; p < DWM_TR * DWM_HW; p += DWM_NT / 8) {
        const int hy = p / DWM_HW, hx = p % DWM_HW;
        if (!inside(ty0 + hy + a - 1, tx0 + hx - 1, H, W)) continue;
        prenorm8(sp + sw128(p, c), iv, sv,
                 __bfloat162float(mrow[hy * MROW + hx + 7]));
      }
      __syncthreads();
    }
    const uint32_t sd = sbase + buf * STAGE + H_STAGE;
    const uint32_t sh = CM ? sbase + DWM_CM_TILE_OFF : sbase + buf * STAGE;
#pragma unroll 2
    for (int sl = 0; sl < DWM_P / 16; ++sl) {
      const int r = sl >> 1, c16 = 16 * (sl & 1);
      uint32_t bf[4][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t x[4];
        if constexpr (CM) {
          // Rows are output channels, 16-byte chunks 8 pixels: plain
          // ldmatrix gives the col-major B fragment.
          const int co = wn * 32 + 16 * jj + (lane & 7) + ((lane >> 4) << 3);
          ldsm_x4(x, sd + dwm_d_off(co, (r * DWM_TC + c16) / 8 +
                                            ((lane >> 3) & 1)));
        } else {
          const int p = r * DWM_TC + c16 + (lane & 7) + (lane & 8);
          ldsm_x4_t(x, sd + sw128(p, wn * 4 + 2 * jj + (lane >> 4)));
        }
        bf[2 * jj][0] = x[0];
        bf[2 * jj][1] = x[1];
        bf[2 * jj + 1][0] = x[2];
        bf[2 * jj + 1][1] = x[3];
      }
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const int p = r * DWM_HW + c16 + (lane & 7) + ((lane >> 4) << 3) + b;
        uint32_t af[4];
        ldsm_x4_t(af, sh + sw128(p, wm * 2 + ((lane >> 3) & 1)));
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[b][j], af, bf[j][0], bf[j][1]);
      }
    }
    __syncthreads();
  }

  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int b = 0; b < 3; ++b)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ci = ci0 + wm * 16 + g + 8 * h;
      if (ci >= Cin) continue;
      float* row = part + (((size_t)chunk * 9 + 3 * a + b) * Cin + ci) * Cout;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = co0 + wn * 32 + 8 * j + 2 * tq + e;
          if (co < Cout) row[co] = acc[b][j][2 * h + e];
        }
    }
}

template <bool PRENORM>
__global__ void __launch_bounds__(DWM_NT, 2) conv3x3_dw_mma_kernel(
    const __nv_bfloat16* __restrict__ src,
    const __nv_bfloat16* __restrict__ mask, const float* __restrict__ inv,
    const float* __restrict__ shift, const __nv_bfloat16* __restrict__ dy,
    float* __restrict__ part, int B, int Cin, int Cout, int H, int W,
    int tiles_per_chunk, int vec_in, int vec_dy) {
  dw_mma_body<false, PRENORM>(src, mask, inv, shift, dy, part, B, Cin, Cout,
                              H, W, tiles_per_chunk, vec_in, vec_dy);
}

template <bool PRENORM>
__global__ void __launch_bounds__(DWM_NT, 2) flat_dw_mma_kernel(
    const __nv_bfloat16* __restrict__ src,
    const __nv_bfloat16* __restrict__ mask, const float* __restrict__ inv,
    const float* __restrict__ shift, const __nv_bfloat16* __restrict__ dy,
    float* __restrict__ part, int B, int Cin, int Cout, int H, int W,
    int tiles_per_chunk, int vec_in, int vec_dy) {
  dw_mma_body<true, PRENORM>(src, mask, inv, shift, dy, part, B, Cin, Cout,
                             H, W, tiles_per_chunk, vec_in, vec_dy);
}

template <bool CM, bool PRENORM>
constexpr auto dw_mma_kernel_of() {
  if constexpr (CM) return flat_dw_mma_kernel<PRENORM>;
  else return conv3x3_dw_mma_kernel<PRENORM>;
}

// Resident blocks of the dW kernel on one SM (0 on error): the wrapper sizes
// its split-K grid to one wave.
template <bool CM, bool PRENORM>
inline int dw_mma_blocks_per_sm() {
  constexpr auto kern = dw_mma_kernel_of<CM, PRENORM>();
  constexpr int smem = CM ? DWM_CM_SMEM : DWM_SMEM;
  if (smem_attr_once<kern, smem>() != cudaSuccess) return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, DWM_NT,
                                                    smem) != cudaSuccess)
    return 0;
  return blocks;
}

// Channel-major (CM) needs src, dy and mask 16-byte aligned.
template <bool CM, bool PRENORM>
inline cudaError_t launch_dw_mma(const __nv_bfloat16* src,
                                 const __nv_bfloat16* mask, const float* inv,
                                 const float* shift, const __nv_bfloat16* dy,
                                 float* part, int B, int Cin, int Cout, int H,
                                 int W, int nchunks, int tiles_per_chunk,
                                 cudaStream_t stream) {
  if ((PRENORM && !aligned16(mask)) ||
      (CM && !(aligned16(src) && aligned16(dy))))
    return cudaErrorMisalignedAddress;
  constexpr auto kern = dw_mma_kernel_of<CM, PRENORM>();
  constexpr int smem = CM ? DWM_CM_SMEM : DWM_SMEM;
  const cudaError_t err = smem_attr_once<kern, smem>();
  if (err != cudaSuccess) return err;
  dim3 grid(3 * ((Cin + DWM_CI - 1) / DWM_CI) * ((Cout + DWM_CO - 1) / DWM_CO),
            nchunks);
  const int vec_in = !CM && Cin % 8 == 0 && aligned16(src);
  const int vec_dy = !CM && Cout % 8 == 0 && aligned16(dy);
  kern<<<grid, DWM_NT, smem, stream>>>(src, mask, inv, shift, dy, part, B, Cin,
                                       Cout, H, W, tiles_per_chunk, vec_in,
                                       vec_dy);
  return cudaGetLastError();
}

}  // namespace cmx

// The tile geometry by which the wrappers pack the weights and size the
// partial sums (fused_conv._MMA_GEOMETRY, in this order): FW_TH, FW_TW,
// FW_BN, FW_KC, DWM_TR, DWM_TC, DWM_CI, DWM_CO into g[0..7]. Each library
// that includes this header exports it; the wrappers check it at load.
extern "C" int cmx_mma_geometry(void* g) {
  const int v[8] = {cmx::FW_TH,  cmx::FW_TW,  cmx::FW_BN,  cmx::FW_KC,
                    cmx::DWM_TR, cmx::DWM_TC, cmx::DWM_CI, cmx::DWM_CO};
  for (int i = 0; i < 8; ++i) static_cast<int*>(g)[i] = v[i];
  return 0;
}
