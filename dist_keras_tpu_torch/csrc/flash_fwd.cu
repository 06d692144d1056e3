// Flash-attention forward for Hopper (sm_90a): one C entry point for the
// f32 kernel (flash_fwd_f32.cuh, split-TF32 products on mma.sync) and the
// bf16 kernel (flash_fwd_bf16.cuh, wgmma fed by TMA).
//
// Both replace the TPU kernel `_fwd_kernel` / `_fwd_call` in
// dist_keras_tpu/ops/pallas/flash_attention.py: blockwise attention with
// an online softmax over kv tiles, a causal mask by global position
// (q_offset / kv_offset), dead rows giving 0 and lse = -1e30, and p cast
// to the input dtype before P.V.  Any Tq and Tk (ragged edges are masked
// in the kernels), head_dim 32, 64 or 128.  Each header states its design
// and its bound on this card.
#include "common.cuh"
#include "flash_fwd_bf16.cuh"
#include "flash_fwd_f32.cuh"

// q (B,Tq,H,D), k/v (B,Tk,H,D), o (B,Tq,H,D), all contiguous; lse (B,H,Tq)
// f32.  dtype: 0 = float32, 1 = bfloat16.  -> cudaGetLastError() after
// the launch (cudaErrorInvalidValue for a dtype or D it does not take).
extern "C" int dk_flash_fwd(int dtype, int D, const void* q, const void* k,
                            const void* v, void* o, float* lse, int B, int H,
                            int Tq, int Tk, float scale, int causal,
                            int q_offset, int kv_offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dk_fwd_f32::dispatch(D, q, k, v, o, lse, B, H, Tq, Tk, scale, causal,
                                q_offset, kv_offset, st);
  if (dtype == 1)
    return dk_fwd_bf16::dispatch(D, q, k, v, o, lse, B, H, Tq, Tk, scale, causal,
                                 q_offset, kv_offset, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
