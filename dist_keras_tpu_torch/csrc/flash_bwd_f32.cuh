// Flash-attention backward for f32 inputs on Hopper's tensor cores: dQ
// (K2), dK/dV (K3) and the one-pass dQ/dK/dV (K4) on split-TF32 products
// on warp-level mma.sync (m16n8k8, f32 accumulators), built for sm_90a.
//
// Replaces the TPU kernels `_dq_kernel` and `_dkv_kernel` (with their
// shared `_p_tile` / `_ds_tile`) in dist_keras_tpu/ops/pallas/
// flash_attention.py, and `_fused_bwd_kernel` in
// ops/pallas/fused_bwd_experimental.py (fused_bwd.cu states its contract),
// for f32 q/k/v/dO, which the JAX package runs with all-f32 products.
// They compute what flash_bwd.cu's header states, with P and dS kept in
// f32 before the products that take them.
//
// Precision.  As the f32 forward (flash_fwd_f32.cuh): every operand,
// P and dS included, is split into TF32 hi + lo in registers
// (dk_split4_tf32) and each product takes lo*hi, hi*lo, then hi*hi into
// one f32 accumulator (dk_mma3_tf32), about 2^-21 of each product
// dropped.  One TF32 product per f32 product misses the f32 tolerance;
// tests/test_torch_flash_bwd.py models both on the CPU.
//
// Orientation contract (as flash_bwd_bf16.cuh's, for f32).  All three
// kernels form S and dP with q rows as the M dimension through the one
// device function `sdp`: each element is one chain over D in ascending
// 8-wide k-steps (16-dim slice c, then its two k-steps, k-step sp taking
// dims 4t + 2sp as k = t and 4t + 2sp + 1 as k = t + 4), each k-step
// lo*hi, hi*lo, hi*hi, from 0; P and dS come from flash_bwd_tiles.cuh's
// `p_ds`.  So P and dS have the same bits in every kernel.  The dQ chain
// of each (row, dim) runs over the keys' 8-key k-steps in ascending
// order (k = t standing for key 8j + 2t, k = t + 4 for 8j + 2t + 1: the
// C fragment of dS is then the A fragment, no shuffles), one f32
// accumulator from 0, scale applied once at the end.  The dK/dV chain of
// each (key, dim): q steps ascending, 8-row k-steps ascending (q rows
// 8s + 2t and 8s + 2t + 1), one accumulator, scale (dK only) once.
// Column g of n-tile 4c + u of every dQ/dK/dV product is dim 32c + 4g +
// u, so B reads as float4 and each row of an output leaves as float4.
//
// Design.  Q, dO, K and V tiles sit in shared memory as raw f32 rows
// (split on each fragment read), arriving by cp.async (rows past T
// filled with zeros), row stride D with the 16-byte chunks XOR-swizzled
// by row (`at`): the float4 A/B reads of `sdp` (rows g and g + 8, dims
// 16c + 4t) and the float4 B reads of the other products (rows 2t and 2t
// + 1, dims 32c + 4g) are both conflict-free.  Splitting K and V once
// into hi and lo tiles instead was slower on the card: it doubles their
// shared-memory reads (PERF.md).
//
// - K2: blocks of 128 threads (4 warps), one per (batch*head, 64-row q
//   tile), warp w owning q rows 16w..; 32-key K/V tiles up to the last
//   one the block's last row sees, a warp skipping a tile it cannot see.
//   Per tile a warp forms S and dP (16 x 32), P and dS in registers, and
//   adds dS K into its 16 x D dQ fragment.  96 KB of shared memory and
//   248 registers at D=128 let two blocks share an SM, which hides each
//   tile's load better than a 2-stage ring of 64-key tiles at one block
//   per SM did (PERF.md).
// - K3: blocks of 256 threads (8 warps), one per (batch*head, 64-key kv
//   tile); K and V load once and a 2-stage ring walks 32-row Q/dO steps
//   from first_q_tile.  Per step warp w forms S and dP for q rows
//   16 (w % 2).. and keys 16 (w / 2).., writes P and dS (f32) to shared
//   memory [q row][key], row stride 68 (the 32-bit reads below are
//   conflict-free; lse and dl ride in the padding), and after a barrier
//   adds P^T dO and dS^T Q into the 16 keys x D/2 of dV and dK it owns
//   (keys 16 (w % 4).., dims D/2 (w / 4)..; at D = 32 warps 4..7 hold
//   none), P and dS read back transposed as A.  Eight warps hold half of dK and dV each: with four
//   warps holding all of it, ptxas needed more than 255 registers at
//   D=128 and spilled.
// - K4: K3's block and code (`dkv_block`), which after dK/dV also
//   continues the q tile's dQ chain from the previous kv tile's f32
//   partial (fused_bwd.cu's hand-off): dS read back from shared memory as
//   the same A fragments K2 builds in registers, K as K2 reads it; warp w
//   owns q rows 16 (w % 2).. and the 32 dims 32 (w / 2).. of dQ (none
//   past D).
// - Masks run only on tiles that cross the causal line or a ragged edge.
//   Dead rows (lse <= -5e29) shift by 0 (safe_lse), so their P, dS and dq
//   are zeros.  No atomics but K4's hand-off counters: deterministic.
//
// Shared memory at D=128: K2 98,304 B; K3 and K4 148,992 B.
//
// Bound on this card.  Per visible (q, k) pair K2 does 6*D FLOPs, K3 8*D
// and K4 10*D against a few bytes per row, so operations bound them:
// three TF32 tensor-core products per f32 product, 495 / 3 = 165 TFLOP/s
// of f32 work (f32 FMAs outside the tensor cores: 67).  The splits take
// three instructions per operand element per warp and share the issue
// slots with the mma.sync, as in the f32 forward.
#pragma once

#include "flash_bwd_tiles.cuh"
#include "sm90_ptx.cuh"

namespace dk_bwd_f32 {

using dk_bwd::LOG2E;
using dk_bwd::NT;         // K2: 128 threads, 4 warps
constexpr int NT3 = 256;  // K3 / K4: 256 threads, 8 warps
constexpr int BQ = 64;    // K2: q rows per block, 16 per warp
constexpr int BK = 64;    // K3 / K4: keys per block
constexpr int SQ = 32;    // K3: q rows per step
constexpr int KB2 = 32;   // K2: keys per K/V tile
constexpr int NS3 = 2;    // K3: stages of the Q/dO ring
constexpr int PS = BK + 4;  // row stride of K3's P and dS tiles (floats)
static_assert(2 * NS3 <= PS - BK, "lse and dl fit in the P tile's padding");
static_assert(SQ == dk_bwd::KV_BQ, "K3 steps on first_q_tile's grid");

// Shared-memory sizes at head dim D (bytes).
template <int D>
struct Geo {
  static constexpr int DQ_SMEM = (2 * BQ + 2 * KB2) * D * 4;
  static constexpr int DKV_SMEM = (2 * BK + 2 * NS3 * SQ) * D * 4 + 2 * SQ * PS * 4;
};

// Offset (floats) of element (r, d) of a tile of rows of D floats whose
// 16-byte chunks are XOR-swizzled by row (within each group of 8 chunks):
// a phase of 8 lanes reading float4 at rows 8i + {0, 1}, chunks 4c + t,
// and one reading float4 at rows 8i + 2t (or 8i + 2t + 1), chunks 8c +
// {0, 1}, each touch 32 distinct banks.
template <int D>
__device__ __forceinline__ int at(int r, int d) {
  const int swz = (r & 6) ^ ((r & 1) << 2);
  return r * D + ((((d >> 2) ^ swz)) << 2) + (d & 3);
}

// Rows r0..r0+R-1 of head h, batch b of x (B, T, H, D) into the swizzled
// tile at `dst` by cp.async; rows past T are zeros.
template <int D, int R, int NTH = NT>
__device__ __forceinline__ void load_rows(uint32_t dst, const float* x, int b, int h, int r0,
                                          int T, int H) {
  constexpr int CH = D / 4;  // 16-byte chunks per row
  static_assert(R * CH % NTH == 0, "whole rounds");
#pragma unroll
  for (int it = 0; it < R * CH / NTH; ++it) {
    const int i = threadIdx.x + it * NTH, r = i / CH, c = i % CH, row = r0 + r;
    const bool ok = row < T;
    const float* src = ok ? x + dk_bwd::row_at(b, row, h, T, H, D) + c * 4 : x;
    dk_cp_async16(dst + at<D>(r, c * 4) * 4, src, ok);
  }
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// x = A B^T for the warp's 16 rows of A (tile rows ar0.. of the tile at
// as) against NJ * 8 rows of B (tile rows br0.. of the tile at bs), as
// m16n8 C fragments: register e of n-tile j holds (row g + 8 (e / 2), B
// row 8j + 2t + e % 2), g = lane / 4, t = lane % 4.  Each element is one
// chain over D: 16-dim slice c ascending, then its k-steps sp = 0, 1,
// k-step sp taking dims 4t + 2sp (k = t) and 4t + 2sp + 1 (k = t + 4),
// each k-step lo*hi, hi*lo, hi*hi, from 0.
template <int D, int NJ>
__device__ __forceinline__ void qk_split(const float* as, int ar0, const float* bs, int br0,
                                         float (&x)[NJ][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    const int d = 16 * c + 4 * t4;
    // A of k-step sp: (g, 4t + 2sp), (g + 8, ..), (g, 4t + 2sp + 1), (g + 8, ..)
    uint32_t ah[2][4], al[2][4];
    const float4 a0 = lds4(as + at<D>(ar0 + g, d)), a1 = lds4(as + at<D>(ar0 + g + 8, d));
    dk_split4_tf32(make_float4(a0.x, a1.x, a0.y, a1.y), ah[0], al[0]);
    dk_split4_tf32(make_float4(a0.z, a1.z, a0.w, a1.w), ah[1], al[1]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t bh[4], bl[4];  // B row 8j + g, dims 4t + 2sp (k = t), + 1 (k = t + 4)
      dk_split4_tf32(lds4(bs + at<D>(br0 + 8 * j + g, d)), bh, bl);
#pragma unroll
      for (int sp = 0; sp < 2; ++sp)
        dk_mma3_tf32(x[j], ah[sp], al[sp], bh[2 * sp], bh[2 * sp + 1], bl[2 * sp],
                     bl[2 * sp + 1]);
    }
  }
}

// S = Q K^T and dP = dO V^T for the warp's 16 q rows (tile rows qr0.. of
// the Q and dO tiles at qs / dos) against NJ * 8 keys (tile rows kr0.. of
// the K and V tiles at ks / vs), as m16n8 C fragments: register e of
// n-tile j holds (row g + 8 (e / 2), key 8j + 2t + e % 2), g = lane / 4,
// t = lane % 4, each element's chain as qk_split's (the orientation
// contract above).
template <int D, int NJ>
__device__ __forceinline__ void sdp(const float* qs, const float* dos, int qr0, const float* ks,
                                    const float* vs, int kr0, float (&s)[NJ][4],
                                    float (&dp)[NJ][4]) {
  qk_split<D, NJ>(qs, qr0, ks, kr0, s);
  qk_split<D, NJ>(dos, qr0, vs, kr0, dp);
}

// acc[4c + u] += a x (rows kr, kr + 1 of the tile at xs) for the 32-dim
// groups c = c0..c0+NG-1, column g of n-tile 4c + u being dim 32c + 4g +
// u: the k-step whose k = t is tile row kr = 8j + 2t and k = t + 4 is
// kr + 1, A split in ah / al.  Each row's part of a group is one float4
// (the swizzle leaves the group's 32c as an immediate offset).
template <int D, int NG>
__device__ __forceinline__ void mma_rows(float (*acc)[4], const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], const float* xs, int kr,
                                         int c0) {
  const int g = threadIdx.x % 32 / 4;
  const float* const x0p = xs + at<D>(kr, 4 * g) + 32 * c0;
  const float* const x1p = xs + at<D>(kr + 1, 4 * g) + 32 * c0;
#pragma unroll
  for (int c = 0; c < NG; ++c) {
    const float4 x0 = lds4(x0p + 32 * c), x1 = lds4(x1p + 32 * c);
    uint32_t bh[4], bl[4];  // b0, b1 of n-tile 4c, then 4c + 1; then 4c + 2, 4c + 3
    dk_split4_tf32(make_float4(x0.x, x1.x, x0.y, x1.y), bh, bl);
    dk_mma3_tf32(acc[4 * c], ah, al, bh[0], bh[1], bl[0], bl[1]);
    dk_mma3_tf32(acc[4 * c + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
    dk_split4_tf32(make_float4(x0.z, x1.z, x0.w, x1.w), bh, bl);
    dk_mma3_tf32(acc[4 * c + 2], ah, al, bh[0], bh[1], bl[0], bl[1]);
    dk_mma3_tf32(acc[4 * c + 3], ah, al, bh[2], bh[3], bl[2], bl[3]);
  }
}

// acc += X^T Y for 16 keys (key0..) and the 32-dim groups c0..c0+NG-1
// over a q step: X (P or dS) read from [q row][key] at xs, Y (dO or Q)
// from the swizzled tile at ys; k-step sk takes q rows 8sk + 2t (k = t)
// and 8sk + 2t + 1 (k = t + 4), ascending.
template <int D, int NG>
__device__ __forceinline__ void mma_t(float (*acc)[4], const float* xs, const float* ys,
                                      int key0, int c0) {
  const int lane = threadIdx.x % 32, key = key0 + lane / 4;
#pragma unroll
  for (int sk = 0; sk < SQ / 8; ++sk) {
    const int qa = 8 * sk + 2 * (lane % 4);
    uint32_t ah[4], al[4];  // A (m = key, k = q row)
    dk_split4_tf32(make_float4(xs[qa * PS + key], xs[qa * PS + key + 8],
                               xs[(qa + 1) * PS + key], xs[(qa + 1) * PS + key + 8]),
                   ah, al);
    mma_rows<D, NG>(acc, ah, al, ys, qa, c0);
  }
}

// The row of C registers e0, e0 + 1 of NG 32-dim groups of a fragment
// laid out as mma_rows's (dims 32c + 8t..+3 from e0 of n-tiles 4c..4c+3,
// then + 4.. from e0 + 1), times `mul`, as float4 at `out` (the row's dim
// 0) from group c0 on.
template <int NG>
__device__ __forceinline__ void store_row(float* out, const float (*acc)[4], int e0, int c0,
                                          float mul) {
  float* const o = out + 32 * c0 + 8 * (threadIdx.x % 4);
#pragma unroll
  for (int c = 0; c < NG; ++c)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<float4*>(o + 32 * c + 4 * e) =
          make_float4(mul * acc[4 * c][e0 + e], mul * acc[4 * c + 1][e0 + e],
                      mul * acc[4 * c + 2][e0 + e], mul * acc[4 * c + 3][e0 + e]);
}

// ---------------------------------------------------------------------------
// K2: dQ
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ dl,
                        float* __restrict__ dq, int H, int Tq, int Tk, float scale, int causal,
                        int q_offset, int kv_offset, int n_qt, int group_heads) {
  constexpr int QT = BQ * D, KT = KB2 * D;  // floats of the Q (dO) tile, a K (V) tile
  extern __shared__ __align__(128) unsigned char bwd32_smem[];
  const uint32_t base = dk_smem_u32(bwd32_smem);
  const float* const smf = reinterpret_cast<const float*>(bwd32_smem);
  const float* const qs = smf;
  const float* const dos = smf + QT;
  const float* const ks = smf + 2 * QT;
  const float* const vs = ks + KT;
  auto addr = [&](const float* p) { return base + static_cast<uint32_t>((p - smf) * 4); };

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
  const int n_kt = (kv_end + KB2 - 1) / KB2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;

  load_rows<D, BQ>(addr(qs), q, b, h, q0, Tq, H);
  load_rows<D, BQ>(addr(dos), dout, b, h, q0, Tq, H);
  dk_cp_async_commit();

  float lse2_r[2], dl_r[2];  // rows g and g + 8 of the warp; rows past Tq stay inert
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 16 * warp + g + 8 * i;
    lse2_r[i] = dl_r[i] = 0.f;
    if (row < Tq) {
      const long long at_ = static_cast<long long>(bh) * Tq + row;
      lse2_r[i] = dk_bwd::safe_lse(lse[at_]) * LOG2E;
      dl_r[i] = dl[at_];
    }
  }

  float acc[D / 8][4];  // dQ, 16 rows x D
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * KB2;  // one stage: the other block on the SM hides the load
    load_rows<D, KB2>(addr(ks), k, b, h, k0, Tk, H);
    load_rows<D, KB2>(addr(vs), v, b, h, k0, Tk, H);
    dk_cp_async_commit();
    dk_cp_async_wait<0>();
    __syncthreads();

    // a tile no row of the warp sees (and so every later one) would only
    // add zeros to the chain
    if (!(causal && kv_offset + k0 > q_offset + q0 + 16 * warp + 15)) {
      float s[4][4], dp[4][4];
      sdp<D, 4>(qs, dos, 16 * warp, ks, vs, 0, s, dp);
      const bool edge = k0 + KB2 > Tk ||
                        (causal && kv_offset + k0 + KB2 - 1 > q_offset + q0 + 16 * warp);
      dk_bwd::p_ds<4>(s, dp, lse2_r, dl_r, scale * LOG2E, edge, q0 + 16 * warp, k0, Tq, Tk,
                      causal, q_offset, kv_offset);

      // dQ += dS K: the C fragment of key group j is the A fragment of
      // k-step j (k = t: key 8j + 2t, k = t + 4: key 8j + 2t + 1)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t ah[4], al[4];
        dk_split4_tf32(make_float4(dp[j][0], dp[j][2], dp[j][1], dp[j][3]), ah, al);
        mma_rows<D, D / 32>(acc, ah, al, ks, 8 * j + 2 * t4, 0);
      }
    }
    __syncthreads();  // the tile is consumed before the next load refills it
  }
  dk_cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 16 * warp + g + 8 * i;
    if (row < Tq) store_row<D / 32>(dq + dk_bwd::row_at(b, row, h, Tq, H, D), acc, 2 * i, 0, scale);
  }
}

// ---------------------------------------------------------------------------
// K3: dK and dV; with FUSED, K4: dK, dV and dQ in one pass
// ---------------------------------------------------------------------------
// What K4 writes beside dK and dV (unused by K3).
struct DqHandoff {
  float* dq;     // (B, Tq, H, D): the last kv tile a q tile sees writes it
  float* acc;    // (B, Tq, H, D): the partial handed between kv tiles
  int* counts;   // per (batch*head, 32-row q tile): kv tiles that handed on
};

// One block of K3 (FUSED false) or K4 (FUSED true).  K4 runs K3's code
// and, after each q step's dK/dV, adds that step's dS K to the q tile's
// dQ: it waits until kv tile kt - 1 has handed over the f32 partial (none
// to wait for at kt = 0, whose chain starts from 0), continues each (row,
// dim) over the tile's eight 8-key k-steps in ascending order, dS read
// back from shared memory as the A fragments K2 builds and K read as K2
// reads it, and then hands the partial on or, at the last kv tile the q
// tile sees, writes scale * acc as K2 does.
template <int D, bool FUSED>
__device__ __forceinline__ void dkv_block(const float* __restrict__ q, const float* __restrict__ k,
                                          const float* __restrict__ v,
                                          const float* __restrict__ dout,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ dl, float* __restrict__ dk,
                                          float* __restrict__ dv, int H, int Tq, int Tk,
                                          float scale, int causal, int q_offset, int kv_offset,
                                          int n_kt, int group_heads, const DqHandoff& hand) {
  constexpr int KT = BK * D, QT = SQ * D, PT = SQ * PS;  // floats
  extern __shared__ __align__(128) unsigned char bwd32_smem[];
  const uint32_t base = dk_smem_u32(bwd32_smem);
  float* const smf = reinterpret_cast<float*>(bwd32_smem);
  const float* const ks = smf;
  const float* const vs = ks + KT;
  float* const ring = smf + 2 * KT;  // Q/dO steps
  auto qs = [&](int st) { return ring + (2 * st) * QT; };
  auto dos = [&](int st) { return ring + (2 * st + 1) * QT; };
  float* const pp = ring + 2 * NS3 * QT;  // P, [q row][key]
  float* const dsp = pp + PT;             // dS, [q row][key]
  auto addr = [&](const float* p) { return base + static_cast<uint32_t>((p - smf) * 4); };

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
  const int qw = warp % 2, kw = warp / 2;  // S / dP: q rows 16 qw.., keys 16 kw..
  // dK / dV: keys 16 kq.., the 32-dim groups dh NGK.. (at D = 32 the one
  // group goes to dh 0)
  constexpr int NGK = D >= 64 ? D / 64 : 1;
  const int kq = warp % 4, dh = warp / 4;
  const bool dkv_warp = dh * NGK < D / 32;

  // lse and dl of stage st sit in columns BK + 2 st and BK + 2 st + 1 of
  // the P tile's padding
  auto load_step = [&](int i) {
    const int st = i % NS3, q0 = q_first + i * SQ;
    load_rows<D, SQ, NT3>(addr(qs(st)), q, b, h, q0, Tq, H);
    load_rows<D, SQ, NT3>(addr(dos(st)), dout, b, h, q0, Tq, H);
    if (tid < 2 * SQ) {  // lse by the first warp, dl by the second
      const int r = tid % SQ, row = q0 + r;
      const float* src = tid < SQ ? lse : dl;
      const bool ok = row < Tq;
      dk_cp_async4(addr(pp + r * PS + BK + 2 * st + tid / SQ),
                   ok ? src + static_cast<long long>(bh) * Tq + row : src, ok);
    }
  };
  load_rows<D, BK, NT3>(addr(ks), k, b, h, k0, Tk, H);
  load_rows<D, BK, NT3>(addr(vs), v, b, h, k0, Tk, H);
  dk_cp_async_commit();
  for (int i = 0; i < NS3 - 1 && i < n_steps; ++i) load_step(i);
  dk_cp_async_commit();

  float acc_k[4 * NGK][4], acc_v[4 * NGK][4];  // dK and dV, keys 16 kq.., dims NGK groups
#pragma unroll
  for (int n = 0; n < 4 * NGK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    const int st = i % NS3, q0 = q_first + i * SQ;
    if (i + NS3 - 1 < n_steps) {  // the step NS3 - 1 ahead streams in while this one computes
      load_step(i + NS3 - 1);
      dk_cp_async_commit();
      dk_cp_async_wait<NS3 - 1>();
    } else {
      dk_cp_async_wait<0>();
    }
    __syncthreads();

    {
      float s[2][4], dp[2][4];
      sdp<D, 2>(qs(st), dos(st), 16 * qw, ks, vs, 16 * kw, s, dp);
      float lse2_r[2], dl_r[2];  // the lane's rows g and g + 8 (zeros past Tq)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float* x = pp + (16 * qw + g + 8 * r) * PS + BK + 2 * st;
        lse2_r[r] = dk_bwd::safe_lse(x[0]) * LOG2E;
        dl_r[r] = x[1];
      }
      const bool edge = q0 + SQ > Tq || k0 + BK > Tk ||
                        (causal && kv_offset + k0 + 16 * kw + 15 > q_offset + q0 + 16 * qw);
      dk_bwd::p_ds<2>(s, dp, lse2_r, dl_r, scale * LOG2E, edge, q0 + 16 * qw, k0 + 16 * kw, Tq,
                      Tk, causal, q_offset, kv_offset);
      // P and dS, f32, q-major ([q row][key])
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int o = (16 * qw + g + 8 * r) * PS + 16 * kw + 8 * j + 2 * t4;
          *reinterpret_cast<float2*>(pp + o) = make_float2(s[j][2 * r], s[j][2 * r + 1]);
          *reinterpret_cast<float2*>(dsp + o) = make_float2(dp[j][2 * r], dp[j][2 * r + 1]);
        }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q: P and dS read back transposed as A
    // (m = key), dO and Q as B
    if (dkv_warp) {
      mma_t<D, NGK>(acc_v, pp, dos(st), 16 * kq, NGK * dh);
      mma_t<D, NGK>(acc_k, dsp, qs(st), 16 * kq, NGK * dh);
    }

    if constexpr (FUSED) {
      // dQ += dS K for q rows 16 qw.. and 32-dim group kw of K2's (the
      // warps past D / 32 groups have none), continuing the f32 partial of
      // kv tile kt - 1
      const int c = kw, r0 = q0 + 16 * qw + g;
      // the next kv tile sees q tiles from next_first on (none after the last)
      const int next_first =
          kt + 1 < n_kt ? dk_bwd::first_q_tile(k0 + BK, causal, q_offset, kv_offset) : Tq;
      int* const count =
          hand.counts + static_cast<long long>(bh) * ((Tq + SQ - 1) / SQ) + q0 / SQ;
      const bool hand_on = next_first <= q0;  // a later kv tile continues this q tile
      dk_bwd::dq_wait(count, kt);
      // the group's partial (16 registers) in, the tile's eight k-steps,
      // the partial out
      if (c < D / 32) {
        float part[4][4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + 8 * r;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
            if (kt > 0 && row < Tq)
              x = __ldcg(reinterpret_cast<const float4*>(
                  hand.acc + dk_bwd::row_at(b, row, h, Tq, H, D) + 32 * c + 8 * t4 + 4 * e));
            part[0][2 * r + e] = x.x;
            part[1][2 * r + e] = x.y;
            part[2][2 * r + e] = x.z;
            part[3][2 * r + e] = x.w;
          }
        }
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          // dS rows g, g + 8 at keys 8j + 2t, + 1: K2's A fragment of k-step j
          const float2 x = lds2(dsp + (16 * qw + g) * PS + 8 * j + 2 * t4);
          const float2 y = lds2(dsp + (16 * qw + g + 8) * PS + 8 * j + 2 * t4);
          uint32_t ah[4], al[4];
          dk_split4_tf32(make_float4(x.x, y.x, x.y, y.y), ah, al);
          mma_rows<D, 1>(part, ah, al, ks, 8 * j + 2 * t4, c);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + 8 * r;
          if (row >= Tq) continue;
          const long long o = dk_bwd::row_at(b, row, h, Tq, H, D);
          if (hand_on) {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              __stcg(reinterpret_cast<float4*>(hand.acc + o + 32 * c + 8 * t4 + 4 * e),
                     make_float4(part[0][2 * r + e], part[1][2 * r + e], part[2][2 * r + e],
                                 part[3][2 * r + e]));
          } else {
            store_row<1>(hand.dq + o, part, 2 * r, c, scale);
          }
        }
      }
      __syncthreads();  // P, dS and stage st are consumed before they are refilled
      // the barrier ordered every thread's stores of the partial before
      // this thread's release, which carries them (cumulativity)
      if (hand_on && tid == 0) dk_red_release_add(count, 1);
    } else {
      __syncthreads();  // P, dS and stage st are consumed before they are refilled
    }
  }
  dk_cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = k0 + 16 * kq + g + 8 * r;
    if (kj >= Tk || !dkv_warp) continue;
    const long long o = dk_bwd::row_at(b, kj, h, Tk, H, D);
    store_row<NGK>(dk + o, acc_k, 2 * r, NGK * dh, scale);
    store_row<NGK>(dv + o, acc_v, 2 * r, NGK * dh, 1.f);
  }
}

template <int D>
__global__ void __launch_bounds__(NT3, 1)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dl,
                         float* __restrict__ dk, float* __restrict__ dv, int H, int Tq, int Tk,
                         float scale, int causal, int q_offset, int kv_offset, int n_kt,
                         int group_heads) {
  dkv_block<D, false>(q, k, v, dout, lse, dl, dk, dv, H, Tq, Tk, scale, causal, q_offset,
                      kv_offset, n_kt, group_heads, DqHandoff{});
}

// K4 (fused_bwd.cu): q tiles that no kv tile sees keep the zeros the
// caller fills dq with; dq_acc needs no zeroing, counts must be zeros.
template <int D>
__global__ void __launch_bounds__(NT3, 1)
flash_bwd_fused_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ dl,
                           float* __restrict__ dq, float* __restrict__ dk,
                           float* __restrict__ dv, float* __restrict__ dq_acc,
                           int* __restrict__ counts, int H, int Tq, int Tk, float scale,
                           int causal, int q_offset, int kv_offset, int n_kt) {
  dkv_block<D, true>(q, k, v, dout, lse, dl, dk, dv, H, Tq, Tk, scale, causal, q_offset,
                     kv_offset, n_kt, gridDim.x / n_kt, DqHandoff{dq, dq_acc, counts});
}

using dk_bwd::Args;

using dk_bwd::group_heads;

template <int D>
void launch_dq(const Args& a, void* dq, cudaStream_t stream) {
  static const cudaError_t allowed = dk_allow_max_smem(flash_bwd_dq_f32_kernel<D>);
  (void)allowed;  // a refusal surfaces as the launch's error
  const int n_qt = (a.Tq + BQ - 1) / BQ;
  flash_bwd_dq_f32_kernel<D><<<n_qt * a.B * a.H, NT, Geo<D>::DQ_SMEM, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.dl,
      static_cast<float*>(dq), a.H, a.Tq, a.Tk, a.scale, a.causal, a.q_offset, a.kv_offset,
      n_qt, group_heads(8ll * a.Tk * D, a.B * a.H));
}

template <int D>
void launch_dkv(const Args& a, void* dk, void* dv, cudaStream_t stream) {
  static const cudaError_t allowed = dk_allow_max_smem(flash_bwd_dkv_f32_kernel<D>);
  (void)allowed;
  const int n_kt = (a.Tk + BK - 1) / BK;
  flash_bwd_dkv_f32_kernel<D><<<n_kt * a.B * a.H, NT3, Geo<D>::DKV_SMEM, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.dl,
      static_cast<float*>(dk), static_cast<float*>(dv), a.H, a.Tq, a.Tk, a.scale, a.causal,
      a.q_offset, a.kv_offset, n_kt, group_heads(8ll * a.Tq * D, a.B * a.H));
}

// K4: one group of every batch*head, so the kv tile is the slowest grid
// index (see fused_bwd.cu on the hand-off's order and its deadlock
// freedom).
template <int D>
void launch_fused(const Args& a, void* dq, void* dk, void* dv, float* dq_acc, int* counts,
                  cudaStream_t stream) {
  static const cudaError_t allowed = dk_allow_max_smem(flash_bwd_fused_f32_kernel<D>);
  (void)allowed;
  const int n_kt = (a.Tk + BK - 1) / BK;
  flash_bwd_fused_f32_kernel<D><<<n_kt * a.B * a.H, NT3, Geo<D>::DKV_SMEM, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.dl,
      static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), dq_acc, counts,
      a.H, a.Tq, a.Tk, a.scale, a.causal, a.q_offset, a.kv_offset, n_kt);
}

}  // namespace dk_bwd_f32
