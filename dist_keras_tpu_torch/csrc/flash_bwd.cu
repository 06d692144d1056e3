// Flash-attention backward for Hopper (sm_90a): dQ (K2) and dK/dV (K3),
// f32 and bf16 inputs.
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
// Design.  Neither kernel needs atomics, so both are deterministic.
// K2: one block of 128 threads per (batch*head, 64-row q tile); the TPU's
// sequential kv grid axis becomes a loop over 32-row K/V tiles that stops
// at the last tile the block's last row can see under `causal`.  K3: one
// block per (batch*head, 64-row kv tile); the loop walks 32-row Q/dO
// tiles from the first one that can see the block's first key.  Tiles sit
// in shared memory as f32, each operand in the layout its product reads
// (transposed for Q K^T and dO V^T, row-major for the accumulations), and
// registers are tiled as in flash_fwd.cu: a thread owns a 4x4 block of
// the 64x32 score tile and 4 rows x D/8 dims of each f32 accumulator, so
// each step of a product loads a few 16-byte vectors for 16 FMAs per
// vector.  Ragged Tq/Tk edges and causal positions (q_offset, kv_offset)
// are masked in the kernel.  Shared memory is above 48 KB at D=128
// (132 KB for K2, 158 KB for K3), hence `dk_allow_max_smem`.
//
// Bound on this card.  Per visible (q, k) pair K2 does 6*D FLOPs and K3
// 8*D against a few bytes per row, so both are bound by operations.  The
// kernels issue f32 FMAs outside the tensor cores (67 TFLOP/s), while a
// bf16 input's bound is the tensor-core rate (989 TFLOP/s): bf16
// `mma`/`wgmma` tiles fed by TMA are the step toward it.
#include "common.cuh"

namespace {

constexpr int NT = 128;  // threads per block
constexpr int TC = 8;    // threads across a row group (column / dim groups)

// K2 tiling: 64 q rows per block, 32 keys per step
constexpr int DQ_BQ = 64, DQ_BK = 32;
constexpr int DQ_QS = DQ_BQ + 4;  // row stride of the transposed Q and dO tiles
constexpr int DQ_KS = DQ_BK + 4;  // row stride of the transposed K and V tiles
constexpr int DQ_PS = DQ_BQ + 4;  // row stride of the dS tile (dS[key][row])

// K3 tiling: 64 keys per block, 32 q rows per step
constexpr int KV_BK = 64, KV_BQ = 32;
constexpr int KV_KS = KV_BK + 4;  // row stride of the transposed K and V tiles
constexpr int KV_QS = KV_BQ + 4;  // row stride of the transposed Q and dO tiles
constexpr int KV_PS = KV_BK + 4;  // row stride of the P and dS tiles ([q][key])

template <int D>
constexpr int dq_smem_floats() {
  return 2 * D * DQ_QS + 2 * D * DQ_KS + DQ_BK * (D + 4) + DQ_BK * DQ_PS;
}

template <int D>
constexpr int dkv_smem_floats() {
  return 2 * D * KV_KS + 2 * D * KV_QS + 2 * KV_BQ * (D + 4) +
         2 * KV_BQ * KV_PS + 2 * KV_BQ;
}

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

// ---------------------------------------------------------------------------
// K2: dQ
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dl,
                    T* __restrict__ dq, int H, int Tq, int Tk, float scale,
                    int causal, int q_offset, int kv_offset) {
  constexpr int DV = D / (4 * TC);    // float4 accumulator groups per row
  constexpr int D4 = D / 4;
  constexpr int QL = DQ_BQ * D4 / NT;  // Q (and dO) groups each thread loads
  constexpr int KL = DQ_BK * D4 / NT;  // K (and V) groups each thread loads
  constexpr int KR = D + 4;            // row stride of the row-major K tile
  static_assert(DQ_BQ * D4 % NT == 0 && DQ_BK * D4 % NT == 0, "whole loads");
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [D][DQ_QS]  Q transposed
  float* dos = qs + D * DQ_QS;      // [D][DQ_QS]  dO transposed
  float* kts = dos + D * DQ_QS;     // [D][DQ_KS]  K tile transposed
  float* vts = kts + D * DQ_KS;     // [D][DQ_KS]  V tile transposed
  float* krs = vts + D * DQ_KS;     // [DQ_BK][KR] K tile row-major
  float* dss = krs + DQ_BK * KR;    // [DQ_BK][DQ_PS] dS tile, key-major

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * DQ_BQ;
  const int tid = threadIdx.x, lane = tid % 32;
  const int tc = lane % TC;                   // key / dim group
  const int tr = (tid / 32) * 4 + lane / TC;  // rows tr*4..+3
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  {  // Q and dO, once; rows walk fastest so the transposed stores spread
    float4 qr[QL], dr[QL];
#pragma unroll
    for (int it = 0; it < QL; ++it) {
      const int g = tid + it * NT, r = g % DQ_BQ, d = (g / DQ_BQ) * 4;
      const int row = q0 + r;
      const long long off = row_at(b, row, h, Tq, H, D) + d;
      qr[it] = row < Tq ? dk_load4(q + off) : zero;
      dr[it] = row < Tq ? dk_load4(dout + off) : zero;
    }
#pragma unroll
    for (int it = 0; it < QL; ++it) {
      const int g = tid + it * NT, r = g % DQ_BQ, d = (g / DQ_BQ) * 4;
      store_t(qs, DQ_QS, d, r, qr[it]);
      store_t(dos, DQ_QS, d, r, dr[it]);
    }
  }
  float lse_r[4], dl_r[4];  // this thread's rows; rows past Tq stay inert
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + tr * 4 + r;
    lse_r[r] = 0.f;
    dl_r[r] = 0.f;
    if (row < Tq) {
      const long long at = (static_cast<long long>(b) * H + h) * Tq + row;
      const float l = lse[at];
      lse_r[r] = l <= DK_NEG_INF / 2 ? 0.f : l;  // dead row: shift by 0
      dl_r[r] = dl[at];
    }
  }

  float acc[4][4 * DV];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 4 * DV; ++i) acc[r][i] = 0.f;

  int kv_end = Tk;
  if (causal) {  // last key the block's last row can see, plus one
    const int q_last = min(q0 + DQ_BQ, Tq) - 1;
    kv_end = max(0, min(Tk, q_offset + q_last - kv_offset + 1));
  }

  for (int k0 = 0; k0 < kv_end; k0 += DQ_BK) {
    float4 kr[KL], vr[KL];
#pragma unroll
    for (int it = 0; it < KL; ++it) {  // issued before the barrier waits
      const int g = tid + it * NT, j = g % DQ_BK, d = (g / DQ_BK) * 4;
      const int kj = k0 + j;
      const long long off = row_at(b, kj, h, Tk, H, D) + d;
      kr[it] = kj < Tk ? dk_load4(k + off) : zero;
      vr[it] = kj < Tk ? dk_load4(v + off) : zero;
    }
    __syncthreads();  // the previous tiles are consumed
#pragma unroll
    for (int it = 0; it < KL; ++it) {
      const int g = tid + it * NT, j = g % DQ_BK, d = (g / DQ_BK) * 4;
      store_t(kts, DQ_KS, d, j, kr[it]);
      store_t(vts, DQ_KS, d, j, vr[it]);
      *reinterpret_cast<float4*>(krs + j * KR + d) = kr[it];
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T for rows tr*4..+3, keys tc*4..+3
    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qs + d * DQ_QS + tr * 4);
      const float4 ov = *reinterpret_cast<const float4*>(dos + d * DQ_QS + tr * 4);
      const float4 kv = *reinterpret_cast<const float4*>(kts + d * DQ_KS + tc * 4);
      const float4 vv = *reinterpret_cast<const float4*>(vts + d * DQ_KS + tc * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float oa[4] = {ov.x, ov.y, ov.z, ov.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
      const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(qa[r], ka[c], s[r][c]);
          dp[r][c] = fmaf(oa[r], va[c], dp[r][c]);
        }
    }

    // dS = P * (dP + dl) in f32, P recomputed from lse
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + tr * 4 + r;
      const int qpos = q_offset + row;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tc * 4 + c;
        const bool ok = row < Tq && kj < Tk && (!causal || kv_offset + kj <= qpos);
        const float p = ok ? expf(s[r][c] * scale - lse_r[r]) : 0.f;
        s[r][c] = p * (dp[r][c] + dl_r[r]);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)  // dS rounded to K's dtype, key-major
      *reinterpret_cast<float4*>(dss + (tc * 4 + c) * DQ_PS + tr * 4) =
          round4<T>(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();

    // dQ += dS K for rows tr*4..+3, dims {i*32 + tc*4 .. +3}
#pragma unroll 4
    for (int j = 0; j < DQ_BK; ++j) {
      const float4 sv = *reinterpret_cast<const float4*>(dss + j * DQ_PS + tr * 4);
      const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int i = 0; i < DV; ++i) {
        const float4 kv = *reinterpret_cast<const float4*>(krs + j * KR + i * 32 + tc * 4);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][i * 4 + 0] = fmaf(sa[r], kv.x, acc[r][i * 4 + 0]);
          acc[r][i * 4 + 1] = fmaf(sa[r], kv.y, acc[r][i * 4 + 1]);
          acc[r][i * 4 + 2] = fmaf(sa[r], kv.z, acc[r][i * 4 + 2]);
          acc[r][i * 4 + 3] = fmaf(sa[r], kv.w, acc[r][i * 4 + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + tr * 4 + r;
    if (row >= Tq) continue;
    T* out = dq + row_at(b, row, h, Tq, H, D);
#pragma unroll
    for (int i = 0; i < DV; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[i * 32 + tc * 4 + e] = dk_from_f<T>(scale * acc[r][i * 4 + e]);
  }
}

// ---------------------------------------------------------------------------
// K3: dK and dV
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dl,
                     T* __restrict__ dk, T* __restrict__ dv, int H, int Tq,
                     int Tk, float scale, int causal, int q_offset,
                     int kv_offset) {
  constexpr int DV = D / (4 * TC);
  constexpr int D4 = D / 4;
  constexpr int KL = KV_BK * D4 / NT;  // K (and V) groups each thread loads
  constexpr int QL = KV_BQ * D4 / NT;  // Q (and dO) groups each thread loads
  constexpr int QR = D + 4;            // row stride of the row-major Q/dO tiles
  static_assert(KV_BK * D4 % NT == 0 && KV_BQ * D4 % NT == 0, "whole loads");
  extern __shared__ __align__(16) float smem[];
  float* kts = smem;                // [D][KV_KS]  K transposed
  float* vts = kts + D * KV_KS;     // [D][KV_KS]  V transposed
  float* qts = vts + D * KV_KS;     // [D][KV_QS]  Q tile transposed
  float* dots = qts + D * KV_QS;    // [D][KV_QS]  dO tile transposed
  float* qrs = dots + D * KV_QS;    // [KV_BQ][QR] Q tile row-major
  float* dors = qrs + KV_BQ * QR;   // [KV_BQ][QR] dO tile row-major
  float* ps = dors + KV_BQ * QR;    // [KV_BQ][KV_PS] P rounded, q-major
  float* dss = ps + KV_BQ * KV_PS;  // [KV_BQ][KV_PS] dS rounded, q-major
  float* lse_s = dss + KV_BQ * KV_PS;  // [KV_BQ]
  float* dl_s = lse_s + KV_BQ;         // [KV_BQ]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * KV_BK;
  const int tid = threadIdx.x, lane = tid % 32;
  const int tc = lane % TC;                   // q-row / dim group
  const int tr = (tid / 32) * 4 + lane / TC;  // keys tr*4..+3
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  {  // K and V, once (visible after the loop's first barrier)
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
      store_t(kts, KV_KS, d, j, kr[it]);
      store_t(vts, KV_KS, d, j, vr[it]);
    }
  }

  float acc_k[4][4 * DV], acc_v[4][4 * DV];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 4 * DV; ++i) acc_k[r][i] = acc_v[r][i] = 0.f;

  int q_begin = 0;
  if (causal)  // the q tile holding the first row that sees key k0
    q_begin = max(0, kv_offset + k0 - q_offset) / KV_BQ * KV_BQ;

  for (int q0 = q_begin; q0 < Tq; q0 += KV_BQ) {
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
      const float l = lse[at];
      lse_v = l <= DK_NEG_INF / 2 ? 0.f : l;  // dead row: shift by 0
      dl_v = dl[at];
    }
    __syncthreads();  // the previous tiles are consumed
#pragma unroll
    for (int it = 0; it < QL; ++it) {
      const int g = tid + it * NT, r = g % KV_BQ, d = (g / KV_BQ) * 4;
      store_t(qts, KV_QS, d, r, qr[it]);
      store_t(dots, KV_QS, d, r, dr[it]);
      *reinterpret_cast<float4*>(qrs + r * QR + d) = qr[it];
      *reinterpret_cast<float4*>(dors + r * QR + d) = dr[it];
    }
    if (tid < KV_BQ) {
      lse_s[tid] = lse_v;
      dl_s[tid] = dl_v;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for keys tr*4..+3, q rows tc*4..+3
    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 kv = *reinterpret_cast<const float4*>(kts + d * KV_KS + tr * 4);
      const float4 vv = *reinterpret_cast<const float4*>(vts + d * KV_KS + tr * 4);
      const float4 qv = *reinterpret_cast<const float4*>(qts + d * KV_QS + tc * 4);
      const float4 ov = *reinterpret_cast<const float4*>(dots + d * KV_QS + tc * 4);
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
      const float va[4] = {vv.x, vv.y, vv.z, vv.w};
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float oa[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(ka[r], qa[c], s[r][c]);
          dp[r][c] = fmaf(va[r], oa[c], dp[r][c]);
        }
    }

    // P from lse, dS = P * (dP + dl), both f32; then rounded, q-major
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = q0 + tc * 4 + c;
      const int qpos = q_offset + row;
      const float lse_c = lse_s[tc * 4 + c], dl_c = dl_s[tc * 4 + c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kj = k0 + tr * 4 + r;
        const bool ok = row < Tq && kj < Tk && (!causal || kv_offset + kj <= qpos);
        const float p = ok ? expf(s[r][c] * scale - lse_c) : 0.f;
        s[r][c] = p;
        dp[r][c] = p * (dp[r][c] + dl_c);
      }
      *reinterpret_cast<float4*>(ps + (tc * 4 + c) * KV_PS + tr * 4) =
          round4<T>(s[0][c], s[1][c], s[2][c], s[3][c]);
      *reinterpret_cast<float4*>(dss + (tc * 4 + c) * KV_PS + tr * 4) =
          round4<T>(dp[0][c], dp[1][c], dp[2][c], dp[3][c]);
    }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q for keys tr*4..+3, dims {i*32 + tc*4 .. +3}
#pragma unroll 2
    for (int j = 0; j < KV_BQ; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(ps + j * KV_PS + tr * 4);
      const float4 sv = *reinterpret_cast<const float4*>(dss + j * KV_PS + tr * 4);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
      const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int i = 0; i < DV; ++i) {
        const float4 ov = *reinterpret_cast<const float4*>(dors + j * QR + i * 32 + tc * 4);
        const float4 qv = *reinterpret_cast<const float4*>(qrs + j * QR + i * 32 + tc * 4);
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

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *dl;
  int B, H, Tq, Tk;
  float scale;
  int causal, q_offset, kv_offset;
};

template <typename T, int D>
void launch_dq(const Args& a, void* dq, cudaStream_t stream) {
  constexpr int smem = dq_smem_floats<D>() * static_cast<int>(sizeof(float));
  static const cudaError_t allowed = dk_allow_max_smem(flash_bwd_dq_kernel<T, D>);
  (void)allowed;  // a refusal surfaces as the launch's error
  const dim3 grid((a.Tq + DQ_BQ - 1) / DQ_BQ, a.B * a.H);
  flash_bwd_dq_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.dl,
      static_cast<T*>(dq), a.H, a.Tq, a.Tk, a.scale, a.causal, a.q_offset,
      a.kv_offset);
}

template <typename T, int D>
void launch_dkv(const Args& a, void* dk, void* dv, cudaStream_t stream) {
  constexpr int smem = dkv_smem_floats<D>() * static_cast<int>(sizeof(float));
  static const cudaError_t allowed = dk_allow_max_smem(flash_bwd_dkv_kernel<T, D>);
  (void)allowed;
  const dim3 grid((a.Tk + KV_BK - 1) / KV_BK, a.B * a.H);
  flash_bwd_dkv_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.dl,
      static_cast<T*>(dk), static_cast<T*>(dv), a.H, a.Tq, a.Tk, a.scale,
      a.causal, a.q_offset, a.kv_offset);
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

// f(T{}, DimTag<D>{}) for the dtype code (0 = float32, 1 = bfloat16) and
// head_dim the caller passed -> the launch's error code
template <typename F>
int dispatch(int dtype, int D, F&& f) {
  if (dtype == 0) return dispatch_d<float>(D, f);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(D, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

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
  return dispatch(dtype, D, [&](auto t, auto dim) {
    launch_dq<decltype(t), decltype(dim)::value>(a, dq, st);
  });
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
  return dispatch(dtype, D, [&](auto t, auto dim) {
    launch_dkv<decltype(t), decltype(dim)::value>(a, dk, dv, st);
  });
}
