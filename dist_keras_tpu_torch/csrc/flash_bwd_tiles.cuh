// Tile arithmetic of the flash backward kernels, shared by K2 and K3
// (flash_bwd.cu) and K4 (fused_bwd.cu) in both dtypes.
//
// The counterpart of the JAX package's `_p_tile` / `_ds_tile`
// (ops/pallas/flash_attention.py): one copy, so a fix to the masking or
// the dead-row threshold cannot diverge between the kernels.  It is also
// part of what makes K4 bit-equal to K2 + K3: every kernel forms P and
// dS = P * (dP + dl) from S and dP with `p_ds`.
#pragma once

#include "common.cuh"
#include "sm90_ptx.cuh"

namespace dk_bwd {

constexpr int NT = 128;     // threads per block
constexpr int KV_BQ = 32;   // K3 / K4: q rows per step (first_q_tile's grid)
constexpr float LOG2E = 1.4426950408889634f;

// offset of element (b, t, h, 0) of a contiguous (B, T, H, D) tensor
__device__ __forceinline__ long long row_at(int b, int t, int h, int T, int H,
                                            int D) {
  return ((static_cast<long long>(b) * T + t) * H + h) * D;
}

// Query row `row` may attend to key `kj`: inside both extents, and at or
// before the row's global position under `causal`.
__device__ __forceinline__ bool visible(int row, int kj, int Tq, int Tk,
                                        int causal, int q_offset,
                                        int kv_offset) {
  return row < Tq && kj < Tk && (!causal || kv_offset + kj <= q_offset + row);
}

// The lse a row's probabilities are taken against: a dead row (one that
// sees no key; lse <= -5e29) shifts by 0, so its masked P stays 0.
__device__ __forceinline__ float safe_lse(float l) {
  return l <= DK_NEG_INF / 2 ? 0.f : l;
}

__device__ __forceinline__ float dscore(float p, float dp, float dl) {
  return p * (dp + dl);
}

// In place: s becomes P (f32) and dp becomes dS = P * (dP + dl), for
// m16n8 C fragments (register e of n-tile j holds row g + 8 (e / 2), key
// 8j + 2t + e % 2, g = lane / 4, t = lane % 4) whose row g is global row
// row0 + g and whose key group j starts at key0 + 8j.  lse2_r / dl_r are
// the lane's rows g and g + 8 (lse through safe_lse, times log2(e));
// scale2 = scale * log2(e).  P is 2^(s * scale2 - lse2), one FFMA and the
// special-function unit's ex2.approx.  Without `edge` every pair is
// visible and the mask is skipped.
template <int NJ>
__device__ __forceinline__ void p_ds(float (&s)[NJ][4], float (&dp)[NJ][4],
                                     const float (&lse2_r)[2], const float (&dl_r)[2],
                                     float scale2, bool edge, int row0, int key0, int Tq,
                                     int Tk, int causal, int q_offset, int kv_offset) {
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = !edge || visible(row0 + g + 8 * (e >> 1), key0 + 8 * j + 2 * t4 + (e & 1),
                                       Tq, Tk, causal, q_offset, kv_offset);
      const float p = ok ? dk_exp2(fmaf(s[j][e], scale2, -lse2_r[e >> 1])) : 0.f;
      s[j][e] = p;
      dp[j][e] = dscore(p, dp[j][e], dl_r[e >> 1]);
    }
}

// Heads per group: as many as keep the streamed operands of each
// (`per_head_bytes`) within ~16 MB of L2.
inline int group_heads(long long per_head_bytes, int bh) {
  constexpr long long L2_GROUP_BYTES = 16ll << 20;
  long long heads = L2_GROUP_BYTES / (per_head_bytes > 0 ? per_head_bytes : 1);
  return static_cast<int>(heads < 1 ? 1 : (heads > bh ? bh : heads));
}

// The first q tile (a multiple of KV_BQ) holding a row that sees key k0.
__device__ __forceinline__ int first_q_tile(int k0, int causal, int q_offset,
                                            int kv_offset) {
  return causal ? max(0, kv_offset + k0 - q_offset) / KV_BQ * KV_BQ : 0;
}

// K4's dQ hand-off, block-wide: at kv tile kt > 0, wait until kv tile
// kt - 1 has handed over the q tile's f32 partial (`*count` reached kt
// by a release).  The first thread's acquire and the barrier after it
// order the block's loads of the partial after that release.  A hand-off
// never takes seconds; one that does is a broken launch order, and
// trapping beats hanging the card.
__device__ __forceinline__ void dq_wait(const int* count, int kt) {
  if (kt == 0) return;
  if (threadIdx.x == 0) {
    for (long long spins = 0; dk_ld_acquire(count) < kt; ++spins) {
      if (spins > (1LL << 26)) __trap();
      __nanosleep(32);
    }
  }
  __syncthreads();
}

// The entry points' arguments (flash_bwd.cu, fused_bwd.cu), for either
// dtype.
struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *dl;
  int B, H, Tq, Tk;
  float scale;
  int causal, q_offset, kv_offset;
};

template <int N>
struct DimTag {
  static constexpr int value = N;
};

template <typename F>
int dispatch_d(int D, F&& f) {
  switch (D) {
    case 32: f(DimTag<32>{}); break;
    case 64: f(DimTag<64>{}); break;
    case 128: f(DimTag<128>{}); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dk_bwd
