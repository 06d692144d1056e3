// Flash-attention forward for f32 inputs on Hopper's tensor cores: split
// TF32 products on warp-level mma.sync (m16n8k8, f32 accumulators), built
// for sm_90a.
//
// Replaces the TPU kernel `_fwd_kernel` in dist_keras_tpu/ops/pallas/
// flash_attention.py for f32 q/k/v, which the JAX package runs with
// all-f32 products.  It computes what flash_fwd.cu's header states, with
// P kept in f32 before P V.
//
// Precision.  One TF32 product keeps 11 significant bits of each operand,
// an error about 2^-11 of each score, which the f32 tolerance (1e-4 on
// out and lse) rules out.  Each operand is split into TF32 hi + lo
// (sm90_ptx.cuh's dk_split_tf32, three instructions; cvt.rna.tf32.f32 is
// a longer sequence) and a product takes lo*hi, then hi*lo, then hi*hi
// into one f32 accumulator; what is dropped is about 2^-21 of the
// product.  The row max, row sum, rescale and output division stay f32.
//
// Design.  One block of 128 threads per (batch*head, 32-row q tile): warp
// w takes the 16 rows of row group w % 2 and keys 32 (w / 2).. of each
// 64-key tile, with its own online softmax and O; at the end the two key
// halves of a row group meet through shared memory, each rescaled to the
// larger max.  So the serving prefill (B=1, T=1024, H=6) runs 192 blocks
// on the card's 132 SMs and its heaviest block walks 16 tiles with two
// warps per row group; under `causal` the blocks start with the heaviest
// q tiles of every head.  Q is split once into the A fragments of S = Q
// K^T, kept in shared memory in fragment order (one LDS.128 per operand);
// K/V tiles arrive through a cp.async ring, rows past T filled with
// zeros; masks run only on tiles that cross the causal line or a ragged
// edge.  The ring has one stage or two (launch, below): two hide each
// tile's load behind the previous tile's products, one halves the K/V
// shared memory so that two blocks share an SM at D=128.  The fragments
// need no shuffles:
//
// - S = Q K^T: within each 16-dim slice, k-step s of the mma takes dim
//   4t + 2s as k = t and 4t + 2s + 1 as k = t + 4 in both operands (a sum
//   over d in another order), so a lane reads its K part as a float4.
// - O += P V: the m16n8 C fragment of S's key group j is the A fragment of
//   k-step j when k = t stands for key 8j + 2t and k = t + 4 for 8j + 2t +
//   1, and V is read for the same keys.  Within each 16-dim slice, column
//   g of n-tile 2c + u is dim 16c + 2g + u, so V reads as float2 and each
//   row of O leaves as float4.
//
// Row strides make those reads conflict-free: K rows D + 16 floats (the 8
// lanes of an LDS.128 phase cover 32 banks), V rows D + 4 (the 16 lanes of
// an LDS.64 phase cover 32 banks).  Shared memory at D=128: 103,424 B with
// one stage, 174,080 B with two.
//
// Bound on this card.  4*D FLOPs per visible (q, k) pair against (3+1)*T*D
// f32 words, so operations bound it: split TF32 does three tensor-core
// products per f32 product, 495 / 3 = 165 TFLOP/s of f32 work, where f32
// FMAs outside the tensor cores reach 67.  mma.sync reaches part of the
// TF32 rate, and the splits (3 instructions per operand element per warp)
// share the issue slots with it.
#pragma once

#include "common.cuh"
#include "sm90_ptx.cuh"

namespace dk_fwd_f32 {

constexpr int BQ = 32;   // q rows per block: two row groups of 16
constexpr int BK = 64;   // keys per kv tile: two halves of 32
constexpr int NT = 128;  // threads per block: a warp per (row group, key half)
constexpr float LOG2E = 1.4426950408889634f;

// NS: stages of the K/V ring (launch below)
template <int D, int NS>
struct Geo {
  static constexpr int KS = D + 16;                 // row stride of the K tile (floats)
  static constexpr int VS = D + 4;                  // row stride of the V tile
  static constexpr int QF = BQ * D * 4;             // bytes of Q's hi (or lo) fragments
  static constexpr int STAGE = BK * (KS + VS) * 4;  // bytes of one K + V stage
  static constexpr int SMEM = 2 * QF + NS * STAGE;
  static_assert(BQ * KS * 4 <= STAGE, "Q stages in a K/V stage");
};

// Rows r0..r0+R-1 of head h, batch b of x (B, T, H, D) into the tile at
// `dst` (row stride RS floats) by cp.async; rows past T are zeros.
template <int D, int R, int RS>
__device__ __forceinline__ void load_tile(uint32_t dst, const float* x, int b, int h, int r0,
                                          int T, int H) {
  constexpr int CH = D / 4;  // 16-byte chunks per row
  static_assert(R * CH % NT == 0, "whole rounds");
#pragma unroll
  for (int it = 0; it < R * CH / NT; ++it) {
    const int i = threadIdx.x + it * NT, r = i / CH, c = i % CH, row = r0 + r;
    const bool ok = row < T;
    const float* src = ok ? x + ((static_cast<long long>(b) * T + row) * H + h) * D + c * 4 : x;
    dk_cp_async16(dst + (r * RS + c * 4) * 4, src, ok);
  }
}

template <int D, int NS>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int Tq, int Tk, float scale, int causal,
                     int q_offset, int kv_offset, int n_qt) {
  using G = Geo<D, NS>;
  extern __shared__ __align__(16) unsigned char fwd32_smem[];
  const uint32_t base = dk_smem_u32(fwd32_smem);
  const float* const smf = reinterpret_cast<const float*>(fwd32_smem);
  auto stage = [&](int st) { return 2 * G::QF + st * G::STAGE; };  // byte offset

  // the q tiles of every batch*head, heaviest first under `causal`
  const int n_bh = gridDim.x / n_qt, qi = blockIdx.x / n_bh, bh = blockIdx.x % n_bh;
  const int b = bh / H, h = bh % H;
  const int q0 = (causal ? n_qt - 1 - qi : qi) * BQ;
  int kv_end = Tk;
  if (causal) {  // last key the block's last row can see, plus one
    const int q_last = min(q0 + BQ, Tq) - 1;
    kv_end = max(0, min(Tk, q_offset + q_last - kv_offset + 1));
  }
  const int n_kt = (kv_end + BK - 1) / BK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int rg = warp % 2, kp = warp / 2;  // rows 16 rg.., keys 32 kp.. of each tile
  const int row0 = q0 + 16 * rg + g;       // the lane's rows row0 and row0 + 8
  const float scale2 = scale * LOG2E;
  auto load_kv = [&](int kt) {
    const int st = kt % NS;
    load_tile<D, BK, G::KS>(base + stage(st), k, b, h, kt * BK, Tk, H);
    load_tile<D, BK, G::VS>(base + stage(st) + BK * G::KS * 4, v, b, h, kt * BK, Tk, H);
  };

  // Q, staged raw in the last K/V stage, split once into the A fragments
  // of S = Q K^T: for warp w, 16-dim slice c, k-step sp and lane l, one
  // uint4 {(g, d), (g + 8, d), (g, d + 1), (g + 8, d + 1)} at d = 16c +
  // 4t + 2sp (below), hi fragments, then lo
  load_tile<D, BQ, G::KS>(base + stage(NS - 1), q, b, h, q0, Tq, H);
  dk_cp_async_commit();
  for (int kt = 0; kt < NS - 1 && kt < n_kt; ++kt) load_kv(kt);
  dk_cp_async_commit();
  dk_cp_async_wait<1>();
  __syncthreads();
  uint4* const qf = reinterpret_cast<uint4*>(fwd32_smem);
  {
    const float* qraw = smf + stage(NS - 1) / 4;
    constexpr int NF = BQ / 16 * (D / 16) * 2 * 32;  // fragments (uint4) per part
#pragma unroll
    for (int it = 0; it < NF / NT; ++it) {
      const int f = tid + it * NT, fl = f % 32, sp = f / 32 % 2, c = f / 64 % (D / 16);
      const int fw = f / (64 * (D / 16)), r = 16 * fw + fl / 4, d = 16 * c + 4 * (fl % 4) + 2 * sp;
      uint32_t hi[4], lo[4];
      dk_split4_tf32(make_float4(qraw[r * G::KS + d], qraw[(r + 8) * G::KS + d],
                         qraw[r * G::KS + d + 1], qraw[(r + 8) * G::KS + d + 1]), hi, lo);
      qf[f] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      qf[NF + f] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
  __syncthreads();  // the fragments are written and the staging stage is free
  const uint4* const qfw = qf + rg * (D / 16) * 64 + lane;  // this lane's, at c = sp = 0
  constexpr int QLO = BQ / 16 * (D / 16) * 64;                // lo fragments follow hi

  float acc[D / 8][4];  // O, the C fragments of n-tiles whose columns are permuted dims
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {DK_NEG_INF, DK_NEG_INF}, l[2] = {0.f, 0.f};  // m in raw score units

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    if (kt + NS - 1 < n_kt) {  // the tile NS - 1 ahead streams in while this one computes
      load_kv(kt + NS - 1);
      dk_cp_async_commit();
      dk_cp_async_wait<NS - 1>();
    } else {
      dk_cp_async_wait<0>();
    }
    __syncthreads();
    // this warp's half of the tile: keys k0w..k0w+31, none of them visible
    // to its rows past a causal line or Tk
    const int k0w = k0 + 32 * kp;
    if (k0w < Tk && (!causal || kv_offset + k0w <= q_offset + q0 + 16 * rg + 15)) {
      const float* ks = smf + stage(kt % NS) / 4 + 32 * kp * G::KS;
      const float* vs = smf + stage(kt % NS) / 4 + BK * G::KS + 32 * kp * G::VS;

      // S = Q K^T: 16 rows x 32 keys, key group j in s[j]
      float s[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        uint32_t ah[2][4], al[2][4];  // k-steps sp = 0, 1 of slice c
#pragma unroll
        for (int sp = 0; sp < 2; ++sp) {
          const uint4 h4 = qfw[(2 * c + sp) * 32], l4 = qfw[QLO + (2 * c + sp) * 32];
          ah[sp][0] = h4.x, ah[sp][1] = h4.y, ah[sp][2] = h4.z, ah[sp][3] = h4.w;
          al[sp][0] = l4.x, al[sp][1] = l4.y, al[sp][2] = l4.z, al[sp][3] = l4.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t kh[4], kl[4];  // dims 4t4 + 2sp (k = t) and + 1 (k = t + 4), sp = 0, 1
          dk_split4_tf32(
              *reinterpret_cast<const float4*>(ks + (8 * j + g) * G::KS + 16 * c + 4 * t4), kh, kl);
#pragma unroll
          for (int sp = 0; sp < 2; ++sp)
            dk_mma3_tf32(s[j], ah[sp], al[sp], kh[2 * sp], kh[2 * sp + 1], kl[2 * sp],
                         kl[2 * sp + 1]);
        }
      }

      // online softmax: s[j][e] is row g + 8 (e / 2), key k0w + 8j + 2t4 + e % 2
      const bool edge =
          k0w + 32 > Tk || (causal && kv_offset + k0w + 31 > q_offset + q0 + 16 * rg);
      float mx[2] = {DK_NEG_INF, DK_NEG_INF};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (edge) {
            const int key = k0w + 8 * j + 2 * t4 + (e & 1);
            const bool ok =
                key < Tk && (!causal || kv_offset + key <= q_offset + row0 + 8 * (e >> 1));
            if (!ok) s[j][e] = DK_NEG_INF;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float shift[2], corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        // nothing visible yet: shift by 0 so the masked p are exactly 0
        shift[i] = m_new <= DK_NEG_INF / 2 ? 0.f : m_new * scale2;
        corr[i] = dk_exp2((m[i] - m_new) * scale2);
        m[i] = m_new;
      }
      float rs[2] = {0.f, 0.f};  // this lane's part of the row sums
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = dk_exp2(fmaf(s[j][e], scale2, -shift[e >> 1]));
          rs[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }

      // O += P V over the half's key groups
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t ph[4], pl[4];  // P (f32) as the A fragment of k-step j
        dk_split4_tf32(make_float4(s[j][0], s[j][2], s[j][1], s[j][3]), ph, pl);
        const float* v0 = vs + (8 * j + 2 * t4) * G::VS + 2 * g;  // keys 8j + 2t4 and + 1
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          const float2 x0 = *reinterpret_cast<const float2*>(v0 + 16 * c);
          const float2 x1 = *reinterpret_cast<const float2*>(v0 + G::VS + 16 * c);
          uint32_t bh[4], bl[4];  // b0, b1 of n-tile 2c, then of n-tile 2c + 1
          dk_split4_tf32(make_float4(x0.x, x1.x, x0.y, x1.y), bh, bl);
          dk_mma3_tf32(acc[2 * c], ph, pl, bh[0], bh[1], bl[0], bl[1]);
          dk_mma3_tf32(acc[2 * c + 1], ph, pl, bh[2], bh[3], bl[2], bl[3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed before a later load refills it
  }
  dk_cp_async_wait<0>();

  // the two key halves of a row group meet: warp (rg, 1) leaves m, its
  // lanes' parts of l and O in shared memory, warp (rg, 0) rescales both
  // to the larger max and adds them (lane for lane, the same fragments)
  float* mrg = reinterpret_cast<float*>(fwd32_smem) + rg * (D / 2 + 4) * 32 + lane;
  if (kp == 1) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mrg[(4 * n + e) * 32] = acc[n][e];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mrg[(D / 2 + i) * 32] = m[i];
      mrg[(D / 2 + 2 + i) * 32] = l[i];
    }
  }
  __syncthreads();
  if (kp == 1) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m1 = mrg[(D / 2 + i) * 32], l1 = mrg[(D / 2 + 2 + i) * 32];
    const float m_new = fmaxf(m[i], m1);
    const float c0 = dk_exp2((m[i] - m_new) * scale2), c1 = dk_exp2((m1 - m_new) * scale2);
    l[i] = l[i] * c0 + l1 * c1;
    m[i] = m_new;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 2 * i; e < 2 * i + 2; ++e)
        acc[n][e] = acc[n][e] * c0 + mrg[(4 * n + e) * 32] * c1;
  }

  // the 4 lanes of a row add their parts of l; a row's dims 16c + 4t4 ..
  // + 3 are (n-tile 2c, 2c + 1) x (column 2t4, 2t4 + 1)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Tq) continue;
    const float l_safe = fmaxf(l[r], 1e-30f);
    float* orow = o + ((static_cast<long long>(b) * Tq + row) * H + h) * D + 4 * t4;
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      *reinterpret_cast<float4*>(orow + 16 * c) =
          make_float4(acc[2 * c][2 * r] / l_safe, acc[2 * c + 1][2 * r] / l_safe,
                      acc[2 * c][2 * r + 1] / l_safe, acc[2 * c + 1][2 * r + 1] / l_safe);
    if (t4 == 0)
      lse[(static_cast<long long>(b) * H + h) * Tq + row] =
          l[r] > 0.f ? m[r] * scale + logf(l[r]) : DK_NEG_INF;
  }
}

// The card's SM count (of the current device, read once).
inline int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

template <int D, int NS>
void launch_ns(const void* q, const void* k, const void* v, void* o, float* lse, int B,
               int H, int Tq, int Tk, float scale, int causal, int q_offset, int kv_offset,
               cudaStream_t stream) {
  static const cudaError_t allowed = dk_allow_max_smem(flash_fwd_f32_kernel<D, NS>);
  (void)allowed;  // a refusal surfaces as the launch's error
  const int n_qt = (Tq + BQ - 1) / BQ;
  flash_fwd_f32_kernel<D, NS><<<n_qt * B * H, NT, Geo<D, NS>::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, H, Tq, Tk, scale, causal, q_offset, kv_offset, n_qt);
}

// A grid of at most two blocks per SM (the serving prefill: one sequence,
// at most 192 blocks at T=1024) is as long as its heaviest blocks, and
// runs the two-stage ring, which hides each tile's load behind the
// previous tile's products; a larger grid (a training batch) is bound by
// the card's throughput and runs one stage, whose smaller shared memory
// fits two blocks per SM at D=128 instead of one.  On an H100 each depth
// is 15-19% faster than the other on its own side (PERF.md).
template <int D>
void launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
            int Tq, int Tk, float scale, int causal, int q_offset, int kv_offset,
            cudaStream_t stream) {
  const long long blocks = static_cast<long long>((Tq + BQ - 1) / BQ) * B * H;
  if (blocks <= 2ll * sm_count())
    launch_ns<D, 2>(q, k, v, o, lse, B, H, Tq, Tk, scale, causal, q_offset, kv_offset, stream);
  else
    launch_ns<D, 1>(q, k, v, o, lse, B, H, Tq, Tk, scale, causal, q_offset, kv_offset, stream);
}

inline int dispatch(int D, const void* q, const void* k, const void* v, void* o, float* lse,
                    int B, int H, int Tq, int Tk, float scale, int causal, int q_offset,
                    int kv_offset, cudaStream_t stream) {
  switch (D) {
    case 32: launch<32>(q, k, v, o, lse, B, H, Tq, Tk, scale, causal, q_offset, kv_offset, stream); break;
    case 64: launch<64>(q, k, v, o, lse, B, H, Tq, Tk, scale, causal, q_offset, kv_offset, stream); break;
    case 128: launch<128>(q, k, v, o, lse, B, H, Tq, Tk, scale, causal, q_offset, kv_offset, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dk_fwd_f32
