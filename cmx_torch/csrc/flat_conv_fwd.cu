// K1: one masked DoubleConv stage forward on the H100, channel-major.
//
// Replaces the TPU kernel cmx/ops/fused_conv_flat.py::flat_conv3x3_mask_stats
// (_flat_conv_kernel): optional pre-norm prologue bf16(relu(src*inv+shift)*m)
// on the input (halo pixels included), 3x3 SAME conv with bf16 operands and
// fp32 sums, + bias in fp32, re-mask, bf16 store, per-channel sum / sum of
// squares of the masked fp32 result, over channel-major (B, C, H*W) maps.
//
// Bound on the card: tensor-core flops at the main path's widths; the stats
// add no pass over memory. Design: the implicit GEMM of conv3x3_mma.cuh on
// the tensor cores (mma.sync m16n8k16) in its channel-major instance: the
// raw channel rows stream in by cp.async, one pass transposes them into K7's
// pixel-major tile with the prologue applied on the way (the activated
// previous-stage tensor never goes to device memory, as on the TPU), and the
// output tile goes out in 16-byte runs of 8 pixels of a channel. The TPU
// kernel accumulated the stats in one VMEM-resident block across its
// sequential grid; blocks on the card run in parallel, so each block writes
// its per-channel partial sums and the wrapper sums them (deterministic, no
// atomics). The TPU kernel's lane rolls and row-wrap masks become 2-D bounds
// checks; tiles that overhang the right image edge are masked, so any
// H % 8 == 0, W % 8 == 0 runs.
#include "conv3x3_mma.cuh"

// src (B, Cin, H, W) bf16, mask (B, H, W) bf16, inv / shift (Cin,) fp32 when
// prenorm, wpack the (ceil(Cout/64), ceil(Cin/16), 9, 16, 64) packing of the
// (9, Cin, Cout) bf16 weights, bias (Cout,) fp32 -> y (B, Cout, H, W) bf16,
// part (B * (H/8) * ceil(W/32), 2, Cout) fp32. src, mask and y 16-byte
// aligned.
extern "C" int cmx_flat_conv_fwd(const void* src, const void* mask,
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
    err = launch_conv3x3_mma<true, true, true>(src_, mask_, inv_, shift_, wp_,
                                               bias_, y_, part_, B, Cin, Cout,
                                               H, W, s);
  else
    err = launch_conv3x3_mma<true, false, true>(src_, mask_, inv_, shift_, wp_,
                                                bias_, y_, part_, B, Cin, Cout,
                                                H, W, s);
  return static_cast<int>(err);
}
