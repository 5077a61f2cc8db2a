// The storage types of the port's kernels and the one place that says how they
// load, widen and round: float, or __nv_bfloat16 for the bf16 path (the JAX
// kernels' dt = x_ref.dtype). Every kernel holds float in shared memory and
// registers and sums in float; it rounds to T only where the JAX kernels cast
// to dt. Included by every kernel source; each gets its own copy (anonymous
// namespace).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// v rounded to T and held as float: where the JAX kernels cast to dt (a
// matmul's f32 sum, an LN output, a bias add, the probabilities), the bf16
// instances round; for float it is the identity, so the float instances
// compute what they did before they became templates.
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// Four consecutive elements as float4: one 16-byte load for float, one 8-byte
// load for bf16. The pointer must be aligned to 4 elements.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// two floats rounded to bf16 (nearest even) and packed, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16x2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

}  // namespace
