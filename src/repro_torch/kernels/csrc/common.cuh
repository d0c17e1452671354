// Shared helpers of the repro_torch Hopper kernels: dtype codes, loads that
// widen to f32, stores that narrow from f32, and the error-string export
// every library carries (kernels/_build.py:check reads it).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace repro {

// dtype codes passed by the Python wrappers (kernels/_build.py:dtype_code)
enum DType : int { F32 = 0, BF16 = 1, FP8E4M3 = 2 };

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) { *p = __float2bfloat16_rn(v); }

// N consecutive elements at p (aligned to min(16, N * sizeof(T)) bytes),
// read in vectors of up to 16 bytes and widened to f32.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float (&out)[N]) {
  constexpr int BYTES = N * static_cast<int>(sizeof(T));
  constexpr int VB = BYTES >= 16 ? 16 : BYTES;
  constexpr int PER = VB / static_cast<int>(sizeof(T));
  struct alignas(VB) Vec { T x[PER]; };
#pragma unroll
  for (int i = 0; i < N / PER; ++i) {
    const Vec v = reinterpret_cast<const Vec*>(p)[i];
#pragma unroll
    for (int j = 0; j < PER; ++j) out[i * PER + j] = to_f(v.x[j]);
  }
}

// 4 consecutive floats at p (16-byte aligned) as one vector access, shared
// or global (LDS.128, STS.128, LDG.128, STG.128)
__device__ __forceinline__ void ldv(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void stv(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}

// Sum over the 32 lanes of a warp; every lane gets the total.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace repro

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
