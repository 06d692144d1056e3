// Tile arithmetic of the flash backward kernels, shared by K2 and K3
// (flash_bwd.cu) and K4 (fused_bwd.cu).
//
// The counterpart of the JAX package's `_p_tile` / `_ds_tile`
// (ops/pallas/flash_attention.py): one copy, so a fix to the masking or
// the dead-row threshold cannot diverge between the kernels.  It is also
// what makes K4 bit-equal to K2 + K3: every kernel forms S and dP as
// fmaf chains over d from 0, P as expf(s * scale - lse) and dS as
// P * (dP + dl), and rounds P and dS through the input dtype, with these
// same functions.
//
// The dK/dV side (K3 and K4) tiles as K3 always has: one block of 128
// threads per (batch*head, 64-key kv tile) walks 32-row Q/dO tiles; a
// thread owns keys tr*4..+3 and q rows (or dims) tc*4..+3.
#pragma once

#include "common.cuh"
#include "sm90_ptx.cuh"

namespace dk_bwd {

constexpr int NT = 128;  // threads per block
constexpr int TC = 8;    // threads across a row group (column / dim groups)

// K3 / K4 tiling: 64 keys per block, 32 q rows per step
constexpr int KV_BK = 64, KV_BQ = 32;
constexpr int KV_KS = KV_BK + 4;  // row stride of the transposed K and V tiles
constexpr int KV_QS = KV_BQ + 4;  // row stride of the transposed Q and dO tiles
constexpr int KV_PS = KV_BK + 4;  // row stride of the P and dS tiles ([q][key])

// offset of element (b, t, h, 0) of a contiguous (B, T, H, D) tensor
__device__ __forceinline__ long long row_at(int b, int t, int h, int T, int H,
                                            int D) {
  return ((static_cast<long long>(b) * T + t) * H + h) * D;
}

__device__ __forceinline__ void store_t(float* base, int stride, int d, int j,
                                        float4 x) {
  base[(d + 0) * stride + j] = x.x;
  base[(d + 1) * stride + j] = x.y;
  base[(d + 2) * stride + j] = x.z;
  base[(d + 3) * stride + j] = x.w;
}

template <typename T>
__device__ __forceinline__ float4 round4(float a, float b, float c, float d) {
  return make_float4(dk_round_through<T>(a), dk_round_through<T>(b),
                     dk_round_through<T>(c), dk_round_through<T>(d));
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

__device__ __forceinline__ float prob(float s, float lse, float scale,
                                      bool ok) {
  return ok ? expf(s * scale - lse) : 0.f;
}

__device__ __forceinline__ float dscore(float p, float dp, float dl) {
  return p * (dp + dl);
}

// s[r][c] = sum_d x1[d][r] * y1[d][c] and dp[r][c] = sum_d x2[d][r] *
// y2[d][c] for r, c < 4, each an fmaf chain over d from 0.  The tiles are
// transposed (element (d, i) at d * stride + i); x1/x2 point at the
// thread's 4 rows, y1/y2 at its 4 columns.
template <int D>
__device__ __forceinline__ void sdp_tiles(const float* x1, const float* x2,
                                          int xs, const float* y1,
                                          const float* y2, int ys,
                                          float s[4][4], float dp[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float4 a1 = *reinterpret_cast<const float4*>(x1 + d * xs);
    const float4 a2 = *reinterpret_cast<const float4*>(x2 + d * xs);
    const float4 b1 = *reinterpret_cast<const float4*>(y1 + d * ys);
    const float4 b2 = *reinterpret_cast<const float4*>(y2 + d * ys);
    const float xa[4] = {a1.x, a1.y, a1.z, a1.w};
    const float xb[4] = {a2.x, a2.y, a2.z, a2.w};
    const float ya[4] = {b1.x, b1.y, b1.z, b1.w};
    const float yb[4] = {b2.x, b2.y, b2.z, b2.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = fmaf(xa[r], ya[c], s[r][c]);
        dp[r][c] = fmaf(xb[r], yb[c], dp[r][c]);
      }
  }
}

// Shared-memory tiles of the dK/dV side, as floats from `smem`.
template <int D>
struct DkvTiles {
  static constexpr int QR = D + 4;  // row stride of the row-major Q/dO tiles
  float* kts;    // [D][KV_KS]  K transposed
  float* vts;    // [D][KV_KS]  V transposed
  float* qts;    // [D][KV_QS]  Q tile transposed
  float* dots;   // [D][KV_QS]  dO tile transposed
  float* qrs;    // [KV_BQ][QR] Q tile row-major
  float* dors;   // [KV_BQ][QR] dO tile row-major
  float* ps;     // [KV_BQ][KV_PS] P rounded, q-major
  float* dss;    // [KV_BQ][KV_PS] dS rounded, q-major
  float* lse_s;  // [KV_BQ]
  float* dl_s;   // [KV_BQ]
  float* end;    // first float past the tiles

  __device__ explicit DkvTiles(float* smem)
      : kts(smem), vts(kts + D * KV_KS), qts(vts + D * KV_KS),
        dots(qts + D * KV_QS), qrs(dots + D * KV_QS), dors(qrs + KV_BQ * QR),
        ps(dors + KV_BQ * QR), dss(ps + KV_BQ * KV_PS),
        lse_s(dss + KV_BQ * KV_PS), dl_s(lse_s + KV_BQ), end(dl_s + KV_BQ) {}

  static constexpr int floats() {
    return 2 * D * KV_KS + 2 * D * KV_QS + 2 * KV_BQ * QR + 2 * KV_BQ * KV_PS +
           2 * KV_BQ;
  }
};

// The block's 64 keys of K and V, transposed into kts / vts; with `krs`,
// K also row-major there (row stride D + 4).  Visible after the caller's
// next barrier.
template <typename T, int D>
__device__ __forceinline__ void load_kv_tile(const DkvTiles<D>& sm,
                                             float* krs, const T* k,
                                             const T* v, int b, int h, int k0,
                                             int H, int Tk) {
  constexpr int KL = KV_BK * (D / 4) / NT;  // K (and V) groups per thread
  static_assert(KV_BK * (D / 4) % NT == 0, "whole loads");
  const int tid = threadIdx.x;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 kr[KL], vr[KL];
#pragma unroll
  for (int it = 0; it < KL; ++it) {
    const int g = tid + it * NT, j = g % KV_BK, d = (g / KV_BK) * 4;
    const int kj = k0 + j;
    const long long off = row_at(b, kj, h, Tk, H, D) + d;
    kr[it] = kj < Tk ? dk_load4(k + off) : zero;
    vr[it] = kj < Tk ? dk_load4(v + off) : zero;
  }
#pragma unroll
  for (int it = 0; it < KL; ++it) {
    const int g = tid + it * NT, j = g % KV_BK, d = (g / KV_BK) * 4;
    store_t(sm.kts, KV_KS, d, j, kr[it]);
    store_t(sm.vts, KV_KS, d, j, vr[it]);
    if (krs != nullptr)
      *reinterpret_cast<float4*>(krs + j * (D + 4) + d) = kr[it];
  }
}

// One step of the dK/dV side for the 32-row q tile at q0: load Q, dO,
// lse and dl; S^T = K Q^T and dP^T = V dO^T; P and dS = P * (dP + dl)
// rounded into ps / dss; then dV += P^T dO and dK += dS^T Q for keys
// tr*4..+3, dims {i*32 + tc*4 .. +3}.  ps and dss hold the step's tiles
// until the caller's next barrier.
template <typename T, int D>
__device__ __forceinline__ void dkv_step(
    const DkvTiles<D>& sm, const T* q, const T* dout, const float* lse,
    const float* dl, int b, int h, int k0, int q0, int H, int Tq, int Tk,
    float scale, int causal, int q_offset, int kv_offset,
    float acc_k[4][D / (4 * TC) * 4], float acc_v[4][D / (4 * TC) * 4]) {
  constexpr int DV = D / (4 * TC);
  constexpr int QL = KV_BQ * (D / 4) / NT;  // Q (and dO) groups per thread
  constexpr int QR = DkvTiles<D>::QR;
  static_assert(KV_BQ * (D / 4) % NT == 0, "whole loads");
  const int tid = threadIdx.x, lane = tid % 32;
  const int tc = lane % TC;                   // q-row / dim group
  const int tr = (tid / 32) * 4 + lane / TC;  // keys tr*4..+3
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 qr[QL], dr[QL];
#pragma unroll
  for (int it = 0; it < QL; ++it) {
    const int g = tid + it * NT, r = g % KV_BQ, d = (g / KV_BQ) * 4;
    const int row = q0 + r;
    const long long off = row_at(b, row, h, Tq, H, D) + d;
    qr[it] = row < Tq ? dk_load4(q + off) : zero;
    dr[it] = row < Tq ? dk_load4(dout + off) : zero;
  }
  float lse_v = 0.f, dl_v = 0.f;
  if (tid < KV_BQ && q0 + tid < Tq) {
    const long long at = (static_cast<long long>(b) * H + h) * Tq + q0 + tid;
    lse_v = safe_lse(lse[at]);
    dl_v = dl[at];
  }
  __syncthreads();  // the previous tiles are consumed
#pragma unroll
  for (int it = 0; it < QL; ++it) {
    const int g = tid + it * NT, r = g % KV_BQ, d = (g / KV_BQ) * 4;
    store_t(sm.qts, KV_QS, d, r, qr[it]);
    store_t(sm.dots, KV_QS, d, r, dr[it]);
    *reinterpret_cast<float4*>(sm.qrs + r * QR + d) = qr[it];
    *reinterpret_cast<float4*>(sm.dors + r * QR + d) = dr[it];
  }
  if (tid < KV_BQ) {
    sm.lse_s[tid] = lse_v;
    sm.dl_s[tid] = dl_v;
  }
  __syncthreads();

  // S^T and dP^T for keys tr*4..+3, q rows tc*4..+3
  float s[4][4], dp[4][4];
  sdp_tiles<D>(sm.kts + tr * 4, sm.vts + tr * 4, KV_KS, sm.qts + tc * 4,
               sm.dots + tc * 4, KV_QS, s, dp);

  // P from lse, dS = P * (dP + dl), both f32; then rounded, q-major
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int row = q0 + tc * 4 + c;
    const float lse_c = sm.lse_s[tc * 4 + c], dl_c = sm.dl_s[tc * 4 + c];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool ok = visible(row, k0 + tr * 4 + r, Tq, Tk, causal, q_offset,
                              kv_offset);
      const float p = prob(s[r][c], lse_c, scale, ok);
      s[r][c] = p;
      dp[r][c] = dscore(p, dp[r][c], dl_c);
    }
    *reinterpret_cast<float4*>(sm.ps + (tc * 4 + c) * KV_PS + tr * 4) =
        round4<T>(s[0][c], s[1][c], s[2][c], s[3][c]);
    *reinterpret_cast<float4*>(sm.dss + (tc * 4 + c) * KV_PS + tr * 4) =
        round4<T>(dp[0][c], dp[1][c], dp[2][c], dp[3][c]);
  }
  __syncthreads();

#pragma unroll 2
  for (int j = 0; j < KV_BQ; ++j) {
    const float4 pv = *reinterpret_cast<const float4*>(sm.ps + j * KV_PS + tr * 4);
    const float4 sv = *reinterpret_cast<const float4*>(sm.dss + j * KV_PS + tr * 4);
    const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
    const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
    for (int i = 0; i < DV; ++i) {
      const float4 ov = *reinterpret_cast<const float4*>(sm.dors + j * QR + i * 32 + tc * 4);
      const float4 qv = *reinterpret_cast<const float4*>(sm.qrs + j * QR + i * 32 + tc * 4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc_v[r][i * 4 + 0] = fmaf(pa[r], ov.x, acc_v[r][i * 4 + 0]);
        acc_v[r][i * 4 + 1] = fmaf(pa[r], ov.y, acc_v[r][i * 4 + 1]);
        acc_v[r][i * 4 + 2] = fmaf(pa[r], ov.z, acc_v[r][i * 4 + 2]);
        acc_v[r][i * 4 + 3] = fmaf(pa[r], ov.w, acc_v[r][i * 4 + 3]);
        acc_k[r][i * 4 + 0] = fmaf(sa[r], qv.x, acc_k[r][i * 4 + 0]);
        acc_k[r][i * 4 + 1] = fmaf(sa[r], qv.y, acc_k[r][i * 4 + 1]);
        acc_k[r][i * 4 + 2] = fmaf(sa[r], qv.z, acc_k[r][i * 4 + 2]);
        acc_k[r][i * 4 + 3] = fmaf(sa[r], qv.w, acc_k[r][i * 4 + 3]);
      }
    }
  }
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

// dK = scale * acc_k and dV = acc_v, in the input dtype, for keys
// tr*4..+3 of the block.
template <typename T, int D>
__device__ __forceinline__ void store_dkv(T* dk, T* dv, int b, int h, int k0,
                                          int H, int Tk, float scale,
                                          const float acc_k[4][D / (4 * TC) * 4],
                                          const float acc_v[4][D / (4 * TC) * 4]) {
  constexpr int DV = D / (4 * TC);
  const int tid = threadIdx.x, lane = tid % 32;
  const int tc = lane % TC;
  const int tr = (tid / 32) * 4 + lane / TC;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kj = k0 + tr * 4 + r;
    if (kj >= Tk) continue;
    T* dkrow = dk + row_at(b, kj, h, Tk, H, D);
    T* dvrow = dv + row_at(b, kj, h, Tk, H, D);
#pragma unroll
    for (int i = 0; i < DV; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dkrow[i * 32 + tc * 4 + e] = dk_from_f<T>(scale * acc_k[r][i * 4 + e]);
        dvrow[i * 32 + tc * 4 + e] = dk_from_f<T>(acc_v[r][i * 4 + e]);
      }
  }
}

template <int N>
struct DimTag {
  static constexpr int value = N;
};

template <typename T, typename F>
int dispatch_d(int D, F&& f) {
  switch (D) {
    case 32: f(T{}, DimTag<32>{}); break;
    case 64: f(T{}, DimTag<64>{}); break;
    case 128: f(T{}, DimTag<128>{}); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dk_bwd
