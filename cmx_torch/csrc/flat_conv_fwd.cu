// K1: one masked DoubleConv stage forward on the H100.
//
// Replaces the TPU kernel cmx/ops/fused_conv_flat.py::flat_conv3x3_mask_stats
// (_flat_conv_kernel): optional pre-norm prologue relu(src*inv+shift)*m on
// the input (halo rows included), 3x3 SAME conv + bias, re-mask, bf16 store,
// and per-channel sum / sum of squares of the masked fp32 result.
//
// Bound on the card: tensor-core flops at the main path's widths (see
// conv3x3_core.cuh); the stats add no pass over memory.
// Design: the conv core of conv3x3_core.cuh with the prologue applied while
// staging the input tile (the activated previous-stage tensor never goes to
// device memory, as on the TPU). The TPU kernel accumulated the stats in one
// VMEM-resident block across its sequential grid; blocks on the card run in
// parallel, so each block writes its per-channel partial sums (one warp
// reduces its 8 channels by shuffles) and the wrapper sums the partials.
// Partials keep the result deterministic run to run, where atomics would not.
// The TPU kernel's lane rolls and row-wrap masks become 2-D bounds checks.
#include "conv3x3_core.cuh"

extern "C" int cmx_flat_conv_fwd(const void* src, const void* mask,
                                 const void* inv, const void* shift,
                                 const void* wk, const void* bias, void* y,
                                 void* part, int B, int Cin, int Cout, int H,
                                 int W, int prenorm, void* stream) {
  using namespace cmx;
  auto s = static_cast<cudaStream_t>(stream);
  auto src_ = static_cast<const __nv_bfloat16*>(src);
  auto mask_ = static_cast<const __nv_bfloat16*>(mask);
  auto wk_ = static_cast<const __nv_bfloat16*>(wk);
  auto y_ = static_cast<__nv_bfloat16*>(y);
  auto inv_ = static_cast<const float*>(inv);
  auto shift_ = static_cast<const float*>(shift);
  auto bias_ = static_cast<const float*>(bias);
  auto part_ = static_cast<float*>(part);
  cudaError_t err;
  if (prenorm)
    err = launch_conv3x3<true, true>(src_, mask_, inv_, shift_, wk_, bias_, y_,
                                     part_, B, Cin, Cout, H, W, s);
  else
    err = launch_conv3x3<false, true>(src_, mask_, inv_, shift_, wk_, bias_,
                                      y_, part_, B, Cin, Cout, H, W, s);
  return static_cast<int>(err);
}
