// bf16 helpers shared by the port's conv kernels (K1/K2 and K6-K8).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace cmx {

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The pre-norm prologue bf16(relu(v*inv+shift) * m), each operation rounded
// on its own, as the plain version's separate tensor ops.
__device__ __forceinline__ float prenorm(float v, float inv, float shift,
                                         float m) {
  v = __fadd_rn(__fmul_rn(v, inv), shift);
  return bf16_round(__fmul_rn(fmaxf(v, 0.f), m));
}

// 8 bf16 values <-> one 16-byte word.
__device__ __forceinline__ void unpack8(uint4 u, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  return u;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace cmx
