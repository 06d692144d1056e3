// Shared helpers of the port's CUDA kernels (plain C interface, no
// PyTorch headers: each .cu builds in seconds with nvcc alone).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Masked logits and the "dead row" threshold use the same finite -1e30 as
// the JAX kernels, so a fully masked row gives exact zeros, never NaN.
#define DK_NEG_INF (-1e30f)

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
