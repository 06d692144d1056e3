// Shared helpers of the port's CUDA kernels (plain C interface, no
// PyTorch headers: each .cu builds in seconds with nvcc alone).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Masked logits and the "dead row" threshold use the same finite -1e30 as
// the JAX kernels, so a fully masked row gives exact zeros, never NaN.
#define DK_NEG_INF (-1e30f)

__device__ __forceinline__ float dk_to_f(float x) { return x; }
__device__ __forceinline__ float dk_to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T dk_from_f(float x);
template <> __device__ __forceinline__ float dk_from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 dk_from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as jnp.astype
}

// x rounded through T and back: the probabilities are cast to the input
// dtype before the P.V product, as the TPU kernels do.
template <typename T> __device__ __forceinline__ float dk_round_through(float x) {
  return dk_to_f(dk_from_f<T>(x));
}

// Four consecutive elements (16 bytes of f32, 8 of bf16) as f32; the
// address must be aligned to their size.
__device__ __forceinline__ float4 dk_load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 dk_load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Allow `kernel` all the shared memory a Hopper block may use (227 KB,
// less its static shared memory).  Called once per kernel, at its first
// launch; what each launch asks for still decides its occupancy.
template <typename Kernel>
cudaError_t dk_allow_max_smem(Kernel kernel) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              232448 - static_cast<int>(attr.sharedSizeBytes));
}

extern "C" const char* dk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
