// Flash-attention forward for Hopper (sm_90a): the f32 kernel here, the
// bf16 kernel in flash_fwd_bf16.cuh, one C entry point for both.
//
// Replaces the TPU kernel `_fwd_kernel` / `_fwd_call` in
// dist_keras_tpu/ops/pallas/flash_attention.py: blockwise attention with
// an online softmax over kv tiles, a causal mask by global position
// (q_offset / kv_offset), dead rows giving 0 and lse = -1e30, and p cast
// to the input dtype before P.V.
//
// Design.  One block of 128 threads per (batch*head, 64-row q tile); the
// TPU's sequential kv grid axis becomes a loop inside the block over
// 32-row K/V tiles.  Q (once), each K/V tile and each probability tile
// sit in shared memory as f32.  Each thread owns a 4x4 block of the
// 64x32 score tile and a 4-row x 16-dim block of the 64xD output, so a
// step of either product loads two or five 16-byte vectors from shared
// memory and does 16 or 64 FMAs with them (Q and K are stored
// transposed for that).  The eight threads that share a row group are
// neighbouring lanes: the row max and row sum meet through three warp
// shuffles, and m, l and the accumulator stay in f32 registers.  Under
// `causal` the loop stops at the last kv tile the block's last row can
// see; ragged Tq/Tk edges are masked in the kernel, so no T needs to
// tile evenly.
//
// Bound on this card.  At the prefill shapes (f32, D=128) the work is
// 4*D FLOPs per visible (q, k) pair against (3+1)*T*D*4 bytes, so it is
// bound by operations: f32 runs outside the tensor cores (67 TFLOP/s),
// and the kernel issues plain FMAs, register-tiled so that shared-memory
// loads do not limit them.  The tensor cores would take f32 only as TF32,
// which the f32 tolerance rules out; bf16 inputs go to the tensor-core
// kernel (flash_fwd_bf16.cuh).
#include "common.cuh"
#include "flash_fwd_bf16.cuh"

namespace {

constexpr int BQ = 64;            // q rows per block
constexpr int BK = 32;            // kv rows per tile
constexpr int NT = 128;           // threads per block
constexpr int TC = 8;             // threads across a row group (key / dim groups)
constexpr int QS = BQ + 4;        // row stride of the transposed Q tile
constexpr int KS = BK + 4;        // row stride of the transposed K tile
constexpr int PS = BQ + 4;        // row stride of the P tile (P[key][row])

template <int D>
constexpr int smem_floats() {
  return D * QS + D * KS + BK * D + BK * PS;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Tq, int Tk, float scale,
                 int causal, int q_offset, int kv_offset) {
  constexpr int DV = D / (4 * TC);  // float4 output groups per thread
  constexpr int D4 = D / 4;         // 4-element groups per row
  constexpr int QL = BQ * D4 / NT;  // Q groups each thread loads
  constexpr int KL = BK * D4 / NT;  // K (and V) groups each thread loads
  // Q and K are stored transposed, so their loads walk rows fastest
  // (a warp's 32 stores then hit 32 banks); V keeps its row-major walk
  static_assert(BQ * D4 % NT == 0 && BK * D4 % NT == 0, "whole load rounds");
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [D][QS]  Q transposed
  float* ks = qs + D * QS;          // [D][KS]  K tile transposed
  float* vs = ks + D * KS;          // [BK][D]  V tile
  float* ps = vs + BK * D;          // [BK][PS] P tile, key-major

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, lane = tid % 32;
  const int tc = lane % TC;                       // key / dim group
  const int tr = (tid / 32) * 4 + lane / TC;      // row group: rows tr*4..+3

  {  // all of a thread's loads issue before any store waits on one
    float4 qr[QL];
#pragma unroll
    for (int it = 0; it < QL; ++it) {
      const int g = tid + it * NT, r = g % BQ, d = (g / BQ) * 4, row = q0 + r;
      qr[it] = row < Tq ? dk_load4(q + (((long long)b * Tq + row) * H + h) * D + d)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int it = 0; it < QL; ++it) {
      const int g = tid + it * NT, r = g % BQ, d = (g / BQ) * 4;
      qs[(d + 0) * QS + r] = qr[it].x;
      qs[(d + 1) * QS + r] = qr[it].y;
      qs[(d + 2) * QS + r] = qr[it].z;
      qs[(d + 3) * QS + r] = qr[it].w;
    }
  }

  float acc[4][4 * DV];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 4 * DV; ++i) acc[r][i] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) { m[r] = DK_NEG_INF; l[r] = 0.f; }

  int kv_end = Tk;
  if (causal) {  // last key the block's last row can see, plus one
    const int q_last = min(q0 + BQ, Tq) - 1;
    kv_end = max(0, min(Tk, q_offset + q_last - kv_offset + 1));
  }

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    float4 kr[KL], vr[KL];
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int it = 0; it < KL; ++it) {  // issued before the barrier waits
      const int g = tid + it * NT;
      const int kj = k0 + g % BK, vj = k0 + g / D4;
      const int kd = (g / BK) * 4, vd = (g % D4) * 4;
      kr[it] = kj < Tk ? dk_load4(k + (((long long)b * Tk + kj) * H + h) * D + kd) : zero;
      vr[it] = vj < Tk ? dk_load4(v + (((long long)b * Tk + vj) * H + h) * D + vd) : zero;
    }
    __syncthreads();  // the previous tile (and P) are consumed
#pragma unroll
    for (int it = 0; it < KL; ++it) {
      const int g = tid + it * NT;
      const int j = g % BK, d = (g / BK) * 4;
      ks[(d + 0) * KS + j] = kr[it].x;
      ks[(d + 1) * KS + j] = kr[it].y;
      ks[(d + 2) * KS + j] = kr[it].z;
      ks[(d + 3) * KS + j] = kr[it].w;
      *reinterpret_cast<float4*>(vs + (g / D4) * D + (g % D4) * 4) = vr[it];
    }
    __syncthreads();

    // S = Q K^T for rows tr*4..+3, keys tc*4..+3
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qs + d * QS + tr * 4);
      const float4 kv = *reinterpret_cast<const float4*>(ks + d * KS + tc * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qa[r], ka[c], s[r][c]);
    }

    float p[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q_offset + q0 + tr * 4 + r;
      float row_max = DK_NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tc * 4 + c;
        const bool ok = kj < Tk && (!causal || kv_offset + kj <= qpos);
        s[r][c] = ok ? s[r][c] * scale : DK_NEG_INF;
        row_max = fmaxf(row_max, s[r][c]);
      }
#pragma unroll
      for (int w = 1; w < TC; w <<= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, w));
      const float m_new = fmaxf(m[r], row_max);
      // a row with nothing visible yet keeps m == -1e30: shift by 0 so its
      // masked p underflow to exactly 0 instead of exp(0) = 1
      const float safe_m = m_new <= DK_NEG_INF / 2 ? 0.f : m_new;
      const float corr = expf(m[r] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[r][c] = expf(s[r][c] - safe_m);
        row_sum += p[r][c];
      }
#pragma unroll
      for (int w = 1; w < TC; w <<= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, w);
      l[r] = l[r] * corr + row_sum;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < 4 * DV; ++i) acc[r][i] *= corr;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)  // P rounded to the input dtype, key-major
      *reinterpret_cast<float4*>(ps + (tc * 4 + c) * PS + tr * 4) =
          make_float4(dk_round_through<T>(p[0][c]), dk_round_through<T>(p[1][c]),
                      dk_round_through<T>(p[2][c]), dk_round_through<T>(p[3][c]));
    __syncthreads();

    // O += P V for rows tr*4..+3, dims {i*32 + tc*4 .. +3}
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(ps + j * PS + tr * 4);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int i = 0; i < DV; ++i) {
        const float4 vv = *reinterpret_cast<const float4*>(vs + j * D + i * 32 + tc * 4);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][i * 4 + 0] = fmaf(pa[r], vv.x, acc[r][i * 4 + 0]);
          acc[r][i * 4 + 1] = fmaf(pa[r], vv.y, acc[r][i * 4 + 1]);
          acc[r][i * 4 + 2] = fmaf(pa[r], vv.z, acc[r][i * 4 + 2]);
          acc[r][i * 4 + 3] = fmaf(pa[r], vv.w, acc[r][i * 4 + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + tr * 4 + r;
    if (row >= Tq) continue;
    const float l_safe = fmaxf(l[r], 1e-30f);
    T* orow = o + (((long long)b * Tq + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DV; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        orow[i * 32 + tc * 4 + e] = dk_from_f<T>(acc[r][i * 4 + e] / l_safe);
    if (tc == 0)
      lse[((long long)b * H + h) * Tq + row] =
          l[r] > 0.f ? m[r] + logf(l_safe) : DK_NEG_INF;
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, float* lse,
            int B, int H, int Tq, int Tk, float scale, int causal, int q_offset,
            int kv_offset, cudaStream_t stream) {
  constexpr int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  static const cudaError_t allowed = dk_allow_max_smem(flash_fwd_kernel<T, D>);
  (void)allowed;  // a refusal surfaces as the launch's error
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, Tq, Tk, scale, causal, q_offset, kv_offset);
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int Tq, int Tk, float scale, int causal,
               int q_offset, int kv_offset, cudaStream_t stream) {
  switch (D) {
    case 32: launch<T, 32>(q, k, v, o, lse, B, H, Tq, Tk, scale, causal, q_offset, kv_offset, stream); break;
    case 64: launch<T, 64>(q, k, v, o, lse, B, H, Tq, Tk, scale, causal, q_offset, kv_offset, stream); break;
    case 128: launch<T, 128>(q, k, v, o, lse, B, H, Tq, Tk, scale, causal, q_offset, kv_offset, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B,Tq,H,D), k/v (B,Tk,H,D), o (B,Tq,H,D), all contiguous; lse (B,H,Tq)
// f32.  dtype: 0 = float32, 1 = bfloat16.  -> cudaGetLastError() after
// the launch (cudaErrorInvalidValue for a dtype or D it does not take).
extern "C" int dk_flash_fwd(int dtype, int D, const void* q, const void* k,
                            const void* v, void* o, float* lse, int B, int H,
                            int Tq, int Tk, float scale, int causal,
                            int q_offset, int kv_offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, lse, B, H, Tq, Tk, scale, causal,
                             q_offset, kv_offset, st);
  if (dtype == 1)
    return dk_fwd_bf16::dispatch(D, q, k, v, o, lse, B, H, Tq, Tk, scale, causal,
                                 q_offset, kv_offset, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
