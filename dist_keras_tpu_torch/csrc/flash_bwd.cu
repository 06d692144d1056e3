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
// the outputs are written in the input dtype.  The tile arithmetic they
// share with each other and with K4 (fused_bwd.cu) is in
// flash_bwd_tiles.cuh.
//
// Design (f32).  Neither kernel needs atomics, so both are deterministic.
// K2: one block of 128 threads per (batch*head, 64-row q tile); the TPU's
// sequential kv grid axis becomes a loop over 32-row K/V tiles that stops
// at the last tile the block's last row can see under `causal`.  Each
// (row, dim) of dQ is one f32 fmaf chain over the keys in ascending order,
// scaled once at the end.  K3: one block per (batch*head, 64-row kv
// tile); the loop walks 32-row Q/dO tiles from the first one that can see
// the block's first key.  Tiles sit in shared memory as f32, each operand
// in the layout its product reads (transposed for Q K^T and dO V^T,
// row-major for the accumulations), and registers are tiled as in
// flash_fwd.cu: a thread owns a 4x4 block of the 64x32 score tile and 4
// rows x D/8 dims of each f32 accumulator, so each step of a product
// loads a few 16-byte vectors for 16 FMAs per vector.  Ragged Tq/Tk edges
// and causal positions (q_offset, kv_offset) are masked in the kernel.
// Shared memory is above 48 KB at D=128 (132 KB for K2, 158 KB for K3),
// hence `dk_allow_max_smem`.
//
// Bound on this card.  Per visible (q, k) pair K2 does 6*D FLOPs and K3
// 8*D against a few bytes per row, so both are bound by operations.  The
// kernels here issue f32 FMAs outside the tensor cores (67 TFLOP/s): the
// tensor cores would take f32 only as TF32, which the f32 tolerance rules
// out.  bf16 inputs go to the tensor-core kernels in flash_bwd_bf16.cuh
// (989 TFLOP/s dense bf16), through the same two entry points.
#include "flash_bwd_bf16.cuh"
#include "flash_bwd_tiles.cuh"

namespace {

using namespace dk_bwd;

// K2 tiling: 64 q rows per block, 32 keys per step
constexpr int DQ_BQ = 64, DQ_BK = 32;
constexpr int DQ_QS = DQ_BQ + 4;  // row stride of the transposed Q and dO tiles
constexpr int DQ_KS = DQ_BK + 4;  // row stride of the transposed K and V tiles
constexpr int DQ_PS = DQ_BQ + 4;  // row stride of the dS tile (dS[key][row])

template <int D>
constexpr int dq_smem_floats() {
  return 2 * D * DQ_QS + 2 * D * DQ_KS + DQ_BK * (D + 4) + DQ_BK * DQ_PS;
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
      lse_r[r] = safe_lse(lse[at]);
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
    sdp_tiles<D>(qs + tr * 4, dos + tr * 4, DQ_QS, kts + tc * 4, vts + tc * 4,
                 DQ_KS, s, dp);

    // dS = P * (dP + dl) in f32, P recomputed from lse
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + tr * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = visible(row, k0 + tc * 4 + c, Tq, Tk, causal,
                                q_offset, kv_offset);
        s[r][c] = dscore(prob(s[r][c], lse_r[r], scale, ok), dp[r][c],
                         dl_r[r]);
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
  extern __shared__ __align__(16) float smem[];
  const DkvTiles<D> sm(smem);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * KV_BK;

  // K and V, once (visible after the first step's first barrier)
  load_kv_tile<T, D>(sm, nullptr, k, v, b, h, k0, H, Tk);

  float acc_k[4][4 * DV], acc_v[4][4 * DV];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 4 * DV; ++i) acc_k[r][i] = acc_v[r][i] = 0.f;

  for (int q0 = first_q_tile(k0, causal, q_offset, kv_offset); q0 < Tq;
       q0 += KV_BQ)
    dkv_step<T, D>(sm, q, dout, lse, dl, b, h, k0, q0, H, Tq, Tk, scale,
                   causal, q_offset, kv_offset, acc_k, acc_v);

  store_dkv<T, D>(dk, dv, b, h, k0, H, Tk, scale, acc_k, acc_v);
}

using dk_bwd_bf16::Args;

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
  constexpr int smem = DkvTiles<D>::floats() * static_cast<int>(sizeof(float));
  static const cudaError_t allowed = dk_allow_max_smem(flash_bwd_dkv_kernel<T, D>);
  (void)allowed;
  const dim3 grid((a.Tk + KV_BK - 1) / KV_BK, a.B * a.H);
  flash_bwd_dkv_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.dl,
      static_cast<T*>(dk), static_cast<T*>(dv), a.H, a.Tq, a.Tk, a.scale,
      a.causal, a.q_offset, a.kv_offset);
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
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, [&](auto, auto dim) {
      dk_bwd_bf16::launch_dq<decltype(dim)::value>(a, dq, st);
    });
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_d<float>(D, [&](auto t, auto dim) {
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
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, [&](auto, auto dim) {
      dk_bwd_bf16::launch_dkv<decltype(dim)::value>(a, dk, dv, st);
    });
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_d<float>(D, [&](auto t, auto dim) {
    launch_dkv<decltype(t), decltype(dim)::value>(a, dk, dv, st);
  });
}
