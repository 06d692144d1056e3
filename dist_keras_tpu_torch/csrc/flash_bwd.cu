// Flash-attention backward for Hopper (sm_90a): dQ (K2) and dK/dV (K3),
// the f32 kernels here, the bf16 kernels in flash_bwd_bf16.cuh, one C
// entry point each for both dtypes.
//
// Replaces the TPU kernels `_dq_kernel` and `_dkv_kernel` (with their
// shared `_p_tile` / `_ds_tile`), called from `_bwd_call` in
// dist_keras_tpu/ops/pallas/flash_attention.py.  Both recompute the
// probabilities from the forward's lse instead of keeping the logits:
//
//   P  = exp(scale * Q K^T - lse)     0 where masked; a dead row
//                                     (lse <= -5e29) shifts by 0
//   dS = P * (dO V^T + dl)            dl = g_lse - rowsum(dO * O), given
//   dQ = scale * dS K                 (K2)
//   dV = P^T dO,  dK = scale * dS^T Q (K3)
//
// with the TPU kernels' casts: every product is an f32 sum of the input
// dtype's values, P is rounded to dO's dtype before P^T dO, dS to the
// input dtype before dS K and dS^T Q, scale multiplies the f32 sum, and
// the outputs are written in the input dtype.
//
// The f32 kernels are in flash_bwd_f32.cuh (split-TF32 products on
// mma.sync), the bf16 kernels in flash_bwd_bf16.cuh (bf16 mma.sync); each
// header states its design and its bound on this card.  The tile
// arithmetic they share with each other and with K4 (fused_bwd.cu) is in
// flash_bwd_tiles.cuh.
#include "flash_bwd_bf16.cuh"
#include "flash_bwd_f32.cuh"
#include "flash_bwd_tiles.cuh"

using dk_bwd::Args;
using dk_bwd::dispatch_d;

// q, dout (B,Tq,H,D), k/v (B,Tk,H,D), all contiguous, one dtype; lse and dl
// (B,H,Tq) f32.  dtype: 0 = float32, 1 = bfloat16.  dq (B,Tq,H,D) in the
// input dtype.  -> cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a dtype or D it does not take).
extern "C" int dk_flash_bwd_dq(int dtype, int D, const void* q, const void* k,
                               const void* v, const void* dout,
                               const float* lse, const float* dl, void* dq,
                               int B, int H, int Tq, int Tk, float scale,
                               int causal, int q_offset, int kv_offset,
                               void* stream) {
  const Args a{q, k, v, dout, lse, dl, B, H, Tq, Tk, scale, causal, q_offset, kv_offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d(D, [&](auto dim) {
      dk_bwd_f32::launch_dq<decltype(dim)::value>(a, dq, st);
    });
  if (dtype == 1)
    return dispatch_d(D, [&](auto dim) {
      dk_bwd_bf16::launch_dq<decltype(dim)::value>(a, dq, st);
    });
  return static_cast<int>(cudaErrorInvalidValue);
}

// As dk_flash_bwd_dq; dk and dv (B,Tk,H,D) in the input dtype.
extern "C" int dk_flash_bwd_dkv(int dtype, int D, const void* q, const void* k,
                                const void* v, const void* dout,
                                const float* lse, const float* dl, void* dk,
                                void* dv, int B, int H, int Tq, int Tk,
                                float scale, int causal, int q_offset,
                                int kv_offset, void* stream) {
  const Args a{q, k, v, dout, lse, dl, B, H, Tq, Tk, scale, causal, q_offset, kv_offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d(D, [&](auto dim) {
      dk_bwd_f32::launch_dkv<decltype(dim)::value>(a, dk, dv, st);
    });
  if (dtype == 1)
    return dispatch_d(D, [&](auto dim) {
      dk_bwd_bf16::launch_dkv<decltype(dim)::value>(a, dk, dv, st);
    });
  return static_cast<int>(cudaErrorInvalidValue);
}
