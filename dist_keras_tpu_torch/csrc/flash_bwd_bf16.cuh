// Flash-attention backward for bf16 inputs on Hopper's tensor cores: dQ
// (K2), dK/dV (K3) and the one-pass dQ/dK/dV (K4) on warp-level mma.sync
// (m16n8k16, bf16 operands, f32 accumulators), built for sm_90a.
//
// Replaces the TPU kernels `_dq_kernel` and `_dkv_kernel` (with their
// shared `_p_tile` / `_ds_tile`) in dist_keras_tpu/ops/pallas/
// flash_attention.py, and `_fused_bwd_kernel` in
// ops/pallas/fused_bwd_experimental.py (fused_bwd.cu states its contract),
// for bf16 q/k/v/dO, which feed bf16 tiles to the MXU with f32
// accumulation.  They compute what flash_bwd.cu's header states:
//
//   P  = exp(scale * Q K^T - lse)     0 where masked; a dead row
//                                     (lse <= -5e29) shifts by 0
//   dS = P * (dO V^T + dl)            in f32
//   dQ = scale * dS K,  dV = P^T dO,  dK = scale * dS^T Q
//
// every product an f32 sum of bf16 operands, P rounded to bf16 before
// P^T dO and dS before dS K and dS^T Q, the outputs written as bf16.
// P and dS are flash_bwd_tiles.cuh's `p_ds`, shared with the f32
// kernels (flash_bwd_f32.cuh).
//
// Orientation contract.  Both kernels form S and dP with q rows as the M
// dimension, through the one device function `sdp_mma`: each element is
// one chain of mma.sync over D in ascending 16-wide slices, from 0.  K3
// does not form the transposed tiles: it writes the rounded P and dS to
// shared memory and reads them back transposed (ldmatrix.trans) as the A
// operand of dV += P^T dO and dK += dS^T Q.  So K2's and K3's P and dS
// are the same bits by construction, which a one-pass kernel forming dS
// once can rely on to stay bit-equal to both.  The dQ chain of each
// (row, dim) is: kv tiles ascending, within a tile its 16-key slices
// ascending, one f32 accumulator from 0, scale applied once at the end.
// The dK/dV chain of each (key, dim): q steps ascending, 16-row slices
// ascending, one f32 accumulator, scale (dK only) applied once.
//
// Design.  Blocks of 128 threads (4 warps).  Tiles sit in shared memory
// as bf16 rows with 16 bytes of padding (row stride D + 8), so the 8 row
// addresses of an ldmatrix fall on distinct banks; they arrive through
// cp.async, rows past T filled with zeros, in a 2-stage ring.
//
// - K2: one block per (batch*head, 64-row q tile), warp w owning q rows
//   16w..16w+15.  Q and dO load once; the loop walks 64-key K/V tiles up
//   to the last one the block's last row can see.  Per tile a warp forms
//   S and dP (16 x 64, 64 f32 registers), P and dS in registers, packs dS
//   into bf16 A fragments (the m16n8 C layout of two neighbouring key
//   groups is the m16k16 A layout) and adds dS K into its 16 x D f32 dQ
//   fragment, K read MN-major through ldmatrix.trans.
// - K3: one block per (batch*head, 64-key kv tile); K and V load once and
//   the loop walks 32-row Q/dO steps from the first one that sees the
//   block's first key.  Per step warp w forms S and dP for q rows
//   16 (w % 2).. and keys 32 (w / 2).. (16 x 32 each), writes the rounded
//   P and dS to shared memory, and after a barrier adds P^T dO and
//   dS^T Q into the 16 keys x D f32 dV and dK fragments it owns.
// - K4: K3's block and code (`dkv_block`), which after the P/dS barrier
//   also continues the q tile's dQ chain from the previous kv tile's f32
//   partial (fused_bwd.cu's hand-off), with dS read back from shared
//   memory and K as the same bf16 fragments K2 builds; blocks walk the kv
//   tiles slowest, over every batch*head.
// - Masks run only on tiles that cross the causal line or a ragged edge.
// - Blocks walk groups of heads whose streamed operands (K and V for K2,
//   Q and dO for K3) fit in ~16 MB of L2, and within a group the heaviest
//   tiles first, so a causal backward's long blocks start first and the
//   blocks reading one head's operands run close together in time.
// - Neither kernel uses atomics: each block owns its output rows, so both
//   are deterministic.
//
// Registers at D=128: K2 holds S + dP (64) and dQ (64); K3 holds dK + dV
// (128) and S + dP (32); K4 as K3, its dQ partial (32) where S and dP
// were.  Shared memory at D=128: K2 104,448 B, K3 and K4 79,360 B (two
// blocks per SM each).
//
// Bound on this card.  Per visible (q, k) pair K2 does 6*D FLOPs and K3
// 8*D against a few bytes per row, so both are bound by the tensor-core
// rate (989 TFLOP/s dense bf16).  mma.sync reaches part of it: every
// product reads its B fragments through ldmatrix, and shared memory
// (128 B per clock per SM) caps the rate below the tensor cores' own.
#pragma once

#include "flash_bwd_tiles.cuh"
#include "sm90_ptx.cuh"

namespace dk_bwd_bf16 {

using bf16 = __nv_bfloat16;
using dk_bwd::NT;         // 128 threads, 4 warps
constexpr int BQ = 64;    // K2: q rows per block, 16 per warp
constexpr int BK = 64;    // keys per kv tile (K2's loop, K3's block)
constexpr int SQ = 32;    // K3: q rows per step
static_assert(SQ == dk_bwd::KV_BQ, "K3 steps on first_q_tile's grid");

// Shared-memory geometry at head dim D (strides in elements, sizes in bytes).
template <int D>
struct Geo {
  static constexpr int S = D + 8;    // row stride of a Q/dO/K/V tile
  static constexpr int PS = BK + 8;  // row stride of K3's P and dS tiles
  static constexpr int DQ_SMEM = (2 * BQ + 4 * BK) * S * 2;
  static constexpr int DKV_SMEM = (2 * BK + 4 * SQ) * S * 2 + 2 * SQ * PS * 2 + 4 * SQ * 4;
};

// Rows r0..r0+R-1 of head h, batch b of x (B, T, H, D) into the tile at
// `dst` (row stride D + 8) by cp.async; rows past T are zeros.
template <int D, int R>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* x, int b, int h, int r0,
                                          int T, int H) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  static_assert(R * CH % NT == 0, "whole rounds");
#pragma unroll
  for (int it = 0; it < R * CH / NT; ++it) {
    const int i = threadIdx.x + it * NT, r = i / CH, c = i % CH, row = r0 + r;
    const bool ok = row < T;
    const bf16* src = ok ? x + dk_bwd::row_at(b, row, h, T, H, D) + c * 8 : x;
    dk_cp_async16(dst + (r * Geo<D>::S + c * 8) * 2, src, ok);
  }
}

// S = Q K^T and dP = dO V^T for the warp's 16 q rows (tile rows qr0.. of
// the Q and dO tiles at qs / dos) against NJ * 8 keys (tile rows kr0.. of
// the K and V tiles at ks / vs), as m16n8 C fragments: register e of
// n-tile j holds (row g + 8 (e / 2), key 8j + 2t + e % 2), g = lane / 4,
// t = lane % 4.  Each element is one chain of mma.sync over D in ascending
// 16-wide slices, from 0 (the orientation contract above).
template <int D, int NJ>
__device__ __forceinline__ void sdp_mma(uint32_t qs, uint32_t dos, int qr0, uint32_t ks,
                                        uint32_t vs, int kr0, float (&s)[NJ][4],
                                        float (&dp)[NJ][4]) {
  static_assert(NJ % 2 == 0, "key groups go in pairs");
  constexpr int S = Geo<D>::S;
  const int lane = threadIdx.x % 32, mi = lane / 8, mr = lane % 8;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4], ad[4];  // Q and dO rows as A (row-major, d contiguous)
    const int a_off = ((qr0 + mr + 8 * (mi % 2)) * S + kk * 16 + 8 * (mi / 2)) * 2;
    dk_ldsm_x4(a, qs + a_off);
    dk_ldsm_x4(ad, dos + a_off);
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      uint32_t bk[4], bv[4];  // K and V rows as B (K-major): key groups j, j + 1
      const int b_off = ((kr0 + 8 * j + mr + 8 * (mi / 2)) * S + kk * 16 + 8 * (mi % 2)) * 2;
      dk_ldsm_x4(bk, ks + b_off);
      dk_ldsm_x4(bv, vs + b_off);
      dk_mma_bf16(s[j], a, bk[0], bk[1]);
      dk_mma_bf16(s[j + 1], a, bk[2], bk[3]);
      dk_mma_bf16(dp[j], ad, bv[0], bv[1]);
      dk_mma_bf16(dp[j + 1], ad, bv[2], bv[3]);
    }
  }
}

using dk_bwd::LOG2E;
using dk_bwd::p_ds;

// Two f32 rounded to bf16 and stored as one 4-byte pair.
__device__ __forceinline__ void store_pair(bf16* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = dk_pack_bf16(lo, hi);
}

// ---------------------------------------------------------------------------
// K2: dQ
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dl,
                         bf16* __restrict__ dq, int H, int Tq, int Tk, float scale, int causal,
                         int q_offset, int kv_offset, int n_qt, int group_heads) {
  using G = Geo<D>;
  constexpr int TILE = BK * G::S * 2;  // bytes of one 64-row tile
  extern __shared__ __align__(128) unsigned char bwd16_smem[];
  const uint32_t sq = dk_smem_u32(bwd16_smem), sdo = sq + TILE, skv = sdo + TILE;
  auto sk = [&](int st) { return skv + (2 * st) * TILE; };
  auto sv = [&](int st) { return skv + (2 * st + 1) * TILE; };

  // groups of `group_heads` heads, within a group the q tiles heaviest first
  const int lin = blockIdx.x, n_bh = gridDim.x / n_qt;
  const int group = lin / (group_heads * n_qt), first = group * group_heads;
  const int gs = min(group_heads, n_bh - first), within = lin - first * n_qt;
  const int qi = within / gs, bh = first + within % gs, b = bh / H, h = bh % H;
  const int q0 = (causal ? n_qt - 1 - qi : qi) * BQ;
  int kv_end = Tk;
  if (causal) {  // last key the block's last row can see, plus one
    const int q_last = min(q0 + BQ, Tq) - 1;
    kv_end = max(0, min(Tk, q_offset + q_last - kv_offset + 1));
  }
  const int n_kt = (kv_end + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int mi = lane / 8, mr = lane % 8;

  load_rows<D, BQ>(sq, q, b, h, q0, Tq, H);
  load_rows<D, BQ>(sdo, dout, b, h, q0, Tq, H);
  if (n_kt > 0) {
    load_rows<D, BK>(sk(0), k, b, h, 0, Tk, H);
    load_rows<D, BK>(sv(0), v, b, h, 0, Tk, H);
  }
  dk_cp_async_commit();

  float lse2_r[2], dl_r[2];  // rows g and g + 8 of the warp; rows past Tq stay inert
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 16 * warp + g + 8 * i;
    lse2_r[i] = dl_r[i] = 0.f;
    if (row < Tq) {
      const long long at = static_cast<long long>(bh) * Tq + row;
      lse2_r[i] = dk_bwd::safe_lse(lse[at]) * LOG2E;
      dl_r[i] = dl[at];
    }
  }

  float acc[D / 8][4];  // dQ, 16 rows x D
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1, k0 = kt * BK;
    if (kt + 1 < n_kt) {  // the next tile streams in while this one computes
      load_rows<D, BK>(sk(st ^ 1), k, b, h, k0 + BK, Tk, H);
      load_rows<D, BK>(sv(st ^ 1), v, b, h, k0 + BK, Tk, H);
      dk_cp_async_commit();
      dk_cp_async_wait<1>();
    } else {
      dk_cp_async_wait<0>();
    }
    __syncthreads();

    float s[BK / 8][4], dp[BK / 8][4];
    sdp_mma<D, BK / 8>(sq, sdo, 16 * warp, sk(st), sv(st), 0, s, dp);
    const bool edge = k0 + BK > Tk ||
                      (causal && kv_offset + k0 + BK - 1 > q_offset + q0 + 16 * warp);
    p_ds<BK / 8>(s, dp, lse2_r, dl_r, scale * LOG2E, edge, q0 + 16 * warp, k0, Tq, Tk,
                 causal, q_offset, kv_offset);
    uint32_t da[BK / 16][4];  // dS rounded to bf16, as A fragments over 16-key slices
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      da[kk][0] = dk_pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      da[kk][1] = dk_pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      da[kk][2] = dk_pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      da[kk][3] = dk_pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
    }

    // dQ += dS K, K (keys x dims, dims contiguous) read MN-major
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bk[4];
        dk_ldsm_x4_t(bk, sk(st) + ((kk * 16 + mr + 8 * (mi % 2)) * G::S + 8 * n + 8 * (mi / 2)) * 2);
        dk_mma_bf16(acc[n], da[kk], bk[0], bk[1]);
        dk_mma_bf16(acc[n + 1], da[kk], bk[2], bk[3]);
      }
    __syncthreads();  // stage st is consumed before the next load refills it
  }
  dk_cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 16 * warp + g + 8 * i;
    if (row >= Tq) continue;
    bf16* out = dq + dk_bwd::row_at(b, row, h, Tq, H, D);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store_pair(out + 8 * n + 2 * t4, scale * acc[n][2 * i], scale * acc[n][2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// K3: dK and dV; with FUSED, K4: dK, dV and dQ in one pass
// ---------------------------------------------------------------------------
// What K4 writes beside dK and dV (unused by K3).
struct DqHandoff {
  bf16* dq;      // (B, Tq, H, D): the last kv tile a q tile sees writes it
  float* acc;    // (B, Tq, H, D) f32: the partial handed between kv tiles
  int* counts;   // per (batch*head, 32-row q tile): kv tiles that handed on
};

// One block of K3 (FUSED false) or K4 (FUSED true).  K4 runs K3's code
// and, after each q step's P/dS barrier, adds that step's dS K to the q
// tile's dQ: it waits until kv tile kt - 1 has handed over the f32
// partial (none to wait for at kt = 0, whose chain starts from 0),
// continues each (row, dim) with mma.sync over the tile's four 16-key
// slices in ascending order, dS read back from shared memory as A and K
// read MN-major as B, exactly as K2 forms them, and then hands the
// partial on or, at the last kv tile the q tile sees, writes scale * acc
// as K2 does.  Warp w owns q rows 16 (w % 2).. and dims D/2 (w / 2).. of
// dQ; the partial streams in from L2 while dV and dK accumulate, into the
// registers S and dP held.
template <int D, bool FUSED>
__device__ __forceinline__ void dkv_block(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                          const bf16* __restrict__ v,
                                          const bf16* __restrict__ dout,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ dl, bf16* __restrict__ dk,
                                          bf16* __restrict__ dv, int H, int Tq, int Tk,
                                          float scale, int causal, int q_offset, int kv_offset,
                                          int n_kt, int group_heads, const DqHandoff& hand) {
  using G = Geo<D>;
  constexpr int KT = BK * G::S * 2;   // bytes of the K (or V) tile
  constexpr int QT = SQ * G::S * 2;   // bytes of one Q (or dO) step tile
  constexpr int PT = SQ * G::PS * 2;  // bytes of the P (or dS) tile
  extern __shared__ __align__(128) unsigned char bwd16_smem[];
  const uint32_t base = dk_smem_u32(bwd16_smem);
  const uint32_t sk = base, sv = sk + KT, sqd = sv + KT, sp = sqd + 4 * QT, sds = sp + PT;
  const uint32_t slse = sds + PT, sdl = slse + 2 * SQ * 4;
  auto sq = [&](int st) { return sqd + (2 * st) * QT; };
  auto sdo = [&](int st) { return sqd + (2 * st + 1) * QT; };
  bf16* const pp = reinterpret_cast<bf16*>(bwd16_smem + (sp - base));
  bf16* const dsp = reinterpret_cast<bf16*>(bwd16_smem + (sds - base));
  const float* const lse_s = reinterpret_cast<const float*>(bwd16_smem + (slse - base));
  const float* const dl_s = reinterpret_cast<const float*>(bwd16_smem + (sdl - base));

  // groups of `group_heads` heads, within a group the kv tiles in
  // ascending order (under `causal`, heaviest first)
  const int lin = blockIdx.x, n_bh = gridDim.x / n_kt;
  const int group = lin / (group_heads * n_kt), first = group * group_heads;
  const int gs = min(group_heads, n_bh - first), within = lin - first * n_kt;
  const int kt = within / gs, bh = first + within % gs, b = bh / H, h = bh % H;
  const int k0 = kt * BK;
  const int q_first = dk_bwd::first_q_tile(k0, causal, q_offset, kv_offset);
  const int n_steps = q_first < Tq ? (Tq - q_first + SQ - 1) / SQ : 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int mi = lane / 8, mr = lane % 8;
  const int qw = warp % 2, kw = warp / 2;  // S / dP: q rows 16 qw.., keys 32 kw..

  auto load_step = [&](int st, int q0) {
    load_rows<D, SQ>(sq(st), q, b, h, q0, Tq, H);
    load_rows<D, SQ>(sdo(st), dout, b, h, q0, Tq, H);
    if (tid < 2 * SQ) {  // lse by the first warp, dl by the second
      const int r = tid % SQ, row = q0 + r;
      const float* src = tid < SQ ? lse : dl;
      const bool ok = row < Tq;
      dk_cp_async4((tid < SQ ? slse : sdl) + (st * SQ + r) * 4,
                   ok ? src + static_cast<long long>(bh) * Tq + row : src, ok);
    }
  };
  load_rows<D, BK>(sk, k, b, h, k0, Tk, H);
  load_rows<D, BK>(sv, v, b, h, k0, Tk, H);
  if (n_steps > 0) load_step(0, q_first);
  dk_cp_async_commit();

  float acc_k[D / 8][4], acc_v[D / 8][4];  // dK and dV, keys 16 warp.. x D
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    const int st = i & 1, q0 = q_first + i * SQ;
    if (i + 1 < n_steps) {  // the next step streams in while this one computes
      load_step(st ^ 1, q0 + SQ);
      dk_cp_async_commit();
      dk_cp_async_wait<1>();
    } else {
      dk_cp_async_wait<0>();
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    sdp_mma<D, 4>(sq(st), sdo(st), 16 * qw, sk, sv, 32 * kw, s, dp);
    float lse2_r[2], dl_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse2_r[r] = dk_bwd::safe_lse(lse_s[st * SQ + 16 * qw + g + 8 * r]) * LOG2E;
      dl_r[r] = dl_s[st * SQ + 16 * qw + g + 8 * r];
    }
    const bool edge = q0 + SQ > Tq || k0 + BK > Tk ||
                      (causal && kv_offset + k0 + 32 * kw + 31 > q_offset + q0 + 16 * qw);
    p_ds<4>(s, dp, lse2_r, dl_r, scale * LOG2E, edge, q0 + 16 * qw, k0 + 32 * kw, Tq, Tk,
            causal, q_offset, kv_offset);
    // P and dS rounded to bf16, q-major ([q row][key])
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int at = (16 * qw + g + 8 * r) * G::PS + 32 * kw + 8 * j + 2 * t4;
        store_pair(pp + at, s[j][2 * r], s[j][2 * r + 1]);
        store_pair(dsp + at, dp[j][2 * r], dp[j][2 * r + 1]);
      }
    __syncthreads();

    // K4: wait for the q tile's dQ partial, which then streams in from L2
    // while dV and dK accumulate: part[c][j] are the m16n8 C fragments of
    // n-tile j of chunk c (dims d0(c) + 8j..), rows r0 and r0 + 8
    int* count = nullptr;   // this q tile's hand-off counter
    bool hand_on = false;   // a later kv tile continues this q tile
    const int r0 = q0 + 16 * qw + g;
    auto d0 = [&](int c) { return (D / 2) * kw + 16 * c; };
    float part[FUSED ? D / 32 : 1][2][4];
    if constexpr (FUSED) {
      // the next kv tile sees q tiles from next_first on (none after the last)
      const int next_first =
          kt + 1 < n_kt ? dk_bwd::first_q_tile(k0 + BK, causal, q_offset, kv_offset) : Tq;
      count = hand.counts + static_cast<long long>(bh) * ((Tq + SQ - 1) / SQ) + q0 / SQ;
      hand_on = next_first <= q0;
      dk_bwd::dq_wait(count, kt);
#pragma unroll
      for (int c = 0; c < D / 32; ++c)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + 8 * r;
          const float* src = hand.acc + dk_bwd::row_at(b, row, h, Tq, H, D) + d0(c) + 2 * t4;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float2 x = make_float2(0.f, 0.f);
            if (kt > 0 && row < Tq) x = __ldcg(reinterpret_cast<const float2*>(src + 8 * j));
            part[c][j][2 * r] = x.x;
            part[c][j][2 * r + 1] = x.y;
          }
        }
    }

    // dV += P^T dO and dK += dS^T Q for keys 16 warp..: P and dS read back
    // transposed as A, dO and Q (q rows x dims) MN-major as B
#pragma unroll
    for (int kk = 0; kk < SQ / 16; ++kk) {
      uint32_t pa[4], sa[4];
      const int a_off = ((kk * 16 + mr + 8 * (mi / 2)) * G::PS + 16 * warp + 8 * (mi % 2)) * 2;
      dk_ldsm_x4_t(pa, sp + a_off);
      dk_ldsm_x4_t(sa, sds + a_off);
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        const int b_off = ((kk * 16 + mr + 8 * (mi % 2)) * G::S + 8 * n + 8 * (mi / 2)) * 2;
        uint32_t bo[4], bq[4];
        dk_ldsm_x4_t(bo, sdo(st) + b_off);
        dk_mma_bf16(acc_v[n], pa, bo[0], bo[1]);
        dk_mma_bf16(acc_v[n + 1], pa, bo[2], bo[3]);
        dk_ldsm_x4_t(bq, sq(st) + b_off);
        dk_mma_bf16(acc_k[n], sa, bq[0], bq[1]);
        dk_mma_bf16(acc_k[n + 1], sa, bq[2], bq[3]);
      }
    }

    if constexpr (FUSED) {
      // dQ += dS K: dS rows 16 qw.. as A over the tile's 16-key slices in
      // ascending order, K (keys x dims) read MN-major as B, as K2 does
      uint32_t da[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        dk_ldsm_x4(da[kk], sds + ((16 * qw + mr + 8 * (mi % 2)) * G::PS + 16 * kk + 8 * (mi / 2)) * 2);
#pragma unroll
      for (int c = 0; c < D / 32; ++c)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t bk[4];
          dk_ldsm_x4_t(bk, sk + ((kk * 16 + mr + 8 * (mi % 2)) * G::S + d0(c) + 8 * (mi / 2)) * 2);
          dk_mma_bf16(part[c][0], da[kk], bk[0], bk[1]);
          dk_mma_bf16(part[c][1], da[kk], bk[2], bk[3]);
        }
#pragma unroll
      for (int c = 0; c < D / 32; ++c)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + 8 * r;
          if (row >= Tq) continue;
          const long long at = dk_bwd::row_at(b, row, h, Tq, H, D) + d0(c) + 2 * t4;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float lo = part[c][j][2 * r], hi = part[c][j][2 * r + 1];
            if (hand_on)
              __stcg(reinterpret_cast<float2*>(hand.acc + at + 8 * j), make_float2(lo, hi));
            else
              store_pair(hand.dq + at + 8 * j, scale * lo, scale * hi);
          }
        }
    }
    __syncthreads();  // P, dS and stage st are consumed before they are refilled
    if constexpr (FUSED) {
      // the barrier ordered every thread's stores of the partial before
      // this thread's release, which carries them (cumulativity)
      if (hand_on && tid == 0) dk_red_release_add(count, 1);
    }
  }
  dk_cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = k0 + 16 * warp + g + 8 * r;
    if (kj >= Tk) continue;
    bf16* dkrow = dk + dk_bwd::row_at(b, kj, h, Tk, H, D);
    bf16* dvrow = dv + dk_bwd::row_at(b, kj, h, Tk, H, D);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      store_pair(dkrow + 8 * n + 2 * t4, scale * acc_k[n][2 * r], scale * acc_k[n][2 * r + 1]);
      store_pair(dvrow + 8 * n + 2 * t4, acc_v[n][2 * r], acc_v[n][2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dl,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Tq, int Tk,
                          float scale, int causal, int q_offset, int kv_offset, int n_kt,
                          int group_heads) {
  dkv_block<D, false>(q, k, v, dout, lse, dl, dk, dv, H, Tq, Tk, scale, causal, q_offset,
                      kv_offset, n_kt, group_heads, DqHandoff{});
}

// K4 (fused_bwd.cu): q tiles that no kv tile sees keep the zeros the
// caller fills dq with; dq_acc needs no zeroing, counts must be zeros.
template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_fused_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ dl,
                            bf16* __restrict__ dq, bf16* __restrict__ dk,
                            bf16* __restrict__ dv, float* __restrict__ dq_acc,
                            int* __restrict__ counts, int H, int Tq, int Tk, float scale,
                            int causal, int q_offset, int kv_offset, int n_kt) {
  dkv_block<D, true>(q, k, v, dout, lse, dl, dk, dv, H, Tq, Tk, scale, causal, q_offset,
                     kv_offset, n_kt, gridDim.x / n_kt, DqHandoff{dq, dq_acc, counts});
}

using dk_bwd::Args;

using dk_bwd::group_heads;

template <int D>
void launch_dq(const Args& a, void* dq, cudaStream_t stream) {
  static const cudaError_t allowed = dk_allow_max_smem(flash_bwd_dq_bf16_kernel<D>);
  (void)allowed;  // a refusal surfaces as the launch's error
  const int n_qt = (a.Tq + BQ - 1) / BQ;
  flash_bwd_dq_bf16_kernel<D><<<n_qt * a.B * a.H, NT, Geo<D>::DQ_SMEM, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.dl,
      static_cast<bf16*>(dq), a.H, a.Tq, a.Tk, a.scale, a.causal, a.q_offset, a.kv_offset,
      n_qt, group_heads(4ll * a.Tk * D, a.B * a.H));
}

template <int D>
void launch_dkv(const Args& a, void* dk, void* dv, cudaStream_t stream) {
  static const cudaError_t allowed = dk_allow_max_smem(flash_bwd_dkv_bf16_kernel<D>);
  (void)allowed;
  const int n_kt = (a.Tk + BK - 1) / BK;
  flash_bwd_dkv_bf16_kernel<D><<<n_kt * a.B * a.H, NT, Geo<D>::DKV_SMEM, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.dl,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), a.H, a.Tq, a.Tk, a.scale, a.causal,
      a.q_offset, a.kv_offset, n_kt, group_heads(4ll * a.Tq * D, a.B * a.H));
}

// K4: one group of every batch*head, so the kv tile is the slowest grid
// index (see fused_bwd.cu on the hand-off's order and its deadlock
// freedom).
template <int D>
void launch_fused(const Args& a, void* dq, void* dk, void* dv, float* dq_acc, int* counts,
                  cudaStream_t stream) {
  static const cudaError_t allowed = dk_allow_max_smem(flash_bwd_fused_bf16_kernel<D>);
  (void)allowed;
  const int n_kt = (a.Tk + BK - 1) / BK;
  flash_bwd_fused_bf16_kernel<D><<<n_kt * a.B * a.H, NT, Geo<D>::DKV_SMEM, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.dl,
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), dq_acc, counts,
      a.H, a.Tq, a.Tk, a.scale, a.causal, a.q_offset, a.kv_offset, n_kt);
}

}  // namespace dk_bwd_bf16
