// Flash-attention forward for bf16 inputs on Hopper's tensor cores:
// wgmma fed by TMA (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` in
// dist_keras_tpu/ops/pallas/flash_attention.py:131 for bf16 q/k/v: S =
// Q K^T accumulated in f32 from bf16 operands, times the scale; the
// causal mask by global position (key kv_offset + j visible to row
// q_offset + i iff kv_offset + j <= q_offset + i); an online softmax
// with m, l and O in f32, where a row with nothing visible yet shifts by
// 0 so its masked p are exactly 0 and l sums the unrounded p; p rounded
// to bf16 before P.V; O / max(l, 1e-30) written as bf16, lse = m +
// log(l), or -1e30 where l = 0 (dead rows come out as exact zeros).  The
// exponentials are exp2 of scores scaled by scale*log2(e), one FFMA
// each; lse stays a natural logarithm.
//
// Bound on this card.  At the training shape (B=16, T=2048, H=6, D=128,
// causal) the kernel does 4*D FLOPs per visible (q, k) pair against
// reading q, k, v and writing out once, ~300 FLOPs per byte: it is bound
// by operations, and in bf16 only the tensor cores reach that rate (989
// TFLOP/s dense against 67 for FMAs on the CUDA cores), at full rate only
// through wgmma.  So:
//
// - A block owns 128 q rows and has three warpgroups.  One thread of the
//   producer warpgroup issues every TMA copy: Q once, then K and V tiles
//   of 128 keys into a 2-stage ring, each tile's arrival signalled on an
//   mbarrier, each stage's K and V released separately (K as soon as S is
//   in) so the next loads start early.  The producer gives its registers
//   up (setmaxnreg) to the two consumer warpgroups, 64 q rows each.
// - S = Q K^T is wgmma m64n128k16 with Q and K read from 128B-swizzled
//   shared memory through descriptors.  The softmax runs in registers on
//   the accumulator; each row's max and sum meet through two shuffles
//   among the 4 lanes that share the row.  P, rounded to bf16, is the
//   register A operand of the P V wgmma, with V read MN-major (dims
//   contiguous) from shared memory, so P never touches shared memory.
// - Tensor maps are 4-D (D, H, T, B) over the (B, T, H, D) layout, so
//   rows past a ragged T fill with zeros within their own batch and no T
//   needs to tile evenly.  The mask arithmetic runs only on tiles that
//   cross a warpgroup's visibility line or the ragged Tk edge; under
//   `causal` the loop stops at the last kv tile the block's last row can
//   see.
// - Blocks walk the heads in groups whose K and V fit in ~16 MB of L2,
//   and within a group the q tiles heaviest first: the long causal tiles
//   start first, and the q tiles of one head, which read the same K and
//   V, run close together in time.
// - The output is staged through each warp's own rows of the Q tile for
//   16-byte coalesced stores.
//
// f32 inputs run flash_fwd_f32.cuh's split-TF32 kernel instead: one TF32
// product (10 mantissa bits) would break the f32 tolerance (1e-4) the
// serving path is held to.
#pragma once

#include "common.cuh"
#include "sm90_ptx.cuh"

namespace dk_fwd_bf16 {

constexpr int BM = 128;   // q rows per block, 64 per consumer warpgroup
constexpr int BN = 128;   // keys per kv tile
constexpr int NS = 2;     // stages of the K/V ring
constexpr int NT = 384;   // producer warpgroup + two consumer warpgroups
constexpr long long L2_GROUP_BYTES = 16ll << 20;  // K + V of one group of heads
using bf16 = __nv_bfloat16;

// Tile geometry at head dim D.  A tile (Q, K or V, 128 rows) is NB boxes
// of 128 rows x SW bytes, box after box; TMA swizzles each box at SW
// bytes (128, or 64 at D=32), the layout wgmma reads through descriptors.
template <int D>
struct Geo {
  static constexpr int SW = D * 2 < 128 ? D * 2 : 128;  // bytes per box row
  static constexpr int BC = SW / 2;                     // columns per box
  static constexpr int NB = D / BC;                     // boxes across a row
  static constexpr int BOX = BN * SW;                   // bytes of one box
  static constexpr int TILE = NB * BOX;                 // bytes of one tile
  static constexpr uint32_t SWZ = SW == 128 ? 1 : 2;    // descriptor swizzle code
  static constexpr int SMEM = (1 + 2 * NS) * TILE + 128 + 1024;  // + barriers, alignment
  static_assert(8 * (1 + 4 * NS) <= 128, "barriers fit their slot");
};

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&acc)[D / 2], const uint32_t (&a)[4],
                                         uint64_t b) {
  if constexpr (D == 128) dk_wgmma_m64n128k16_rs(acc, a, b);
  else if constexpr (D == 64) dk_wgmma_m64n64k16_rs(acc, a, b);
  else dk_wgmma_m64n32k16_rs(acc, a, b);
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tmq,
                      const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv, bf16* __restrict__ o,
                      float* __restrict__ lse, int H, int Tq, int Tk, float scale,
                      float scale_log2, int causal, int q_offset, int kv_offset, int n_qt,
                      int group_heads) {
  using G = Geo<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // swizzle atoms (8 rows x SW bytes) must start on 1024-byte boundaries
  const uint32_t raw = dk_smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sq = base, sk = sq + G::TILE, sv = sk + NS * G::TILE;
  const uint32_t bars = sv + NS * G::TILE;
  const uint32_t bar_q = bars;
  auto full_k = [&](int s) { return bars + 8u * (1 + s); };
  auto full_v = [&](int s) { return bars + 8u * (1 + NS + s); };
  auto empty_k = [&](int s) { return bars + 8u * (1 + 2 * NS + s); };
  auto empty_v = [&](int s) { return bars + 8u * (1 + 3 * NS + s); };

  // blocks walk groups of `group_heads` heads, and within a group the q
  // tiles heaviest first across the group's heads
  const int lin = blockIdx.x, n_bh = gridDim.x / n_qt;
  const int group = lin / (group_heads * n_qt), first = group * group_heads;
  const int gs = min(group_heads, n_bh - first), within = lin - first * n_qt;
  const int qi = within / gs, bh = first + within % gs, b = bh / H, h = bh % H;
  const int q0 = (causal ? n_qt - 1 - qi : qi) * BM;
  int kv_end = Tk;
  if (causal) {  // last key the block's last row can see, plus one
    const int q_last = min(q0 + BM, Tq) - 1;
    kv_end = max(0, min(Tk, q_offset + q_last - kv_offset + 1));
  }
  const int n_kt = (kv_end + BN - 1) / BN;
  const int tid = threadIdx.x;

  if (tid == 0) {
    dk_mbar_init(bar_q, 1);
    for (int s = 0; s < NS; ++s) {
      dk_mbar_init(full_k(s), 1);
      dk_mbar_init(full_v(s), 1);
      dk_mbar_init(empty_k(s), 8);  // one arrival per consumer warp
      dk_mbar_init(empty_v(s), 8);
    }
    dk_mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup: thread 0 issues every copy
    dk_setmaxnreg_dec<24>();
    if (tid == 0) {
      dk_mbar_arrive_expect_tx(bar_q, G::TILE);
      for (int cb = 0; cb < G::NB; ++cb)
        dk_tma_load_4d(sq + cb * G::BOX, &tmq, bar_q, cb * G::BC, h, q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % NS;
        const uint32_t ph = (kt / NS - 1) & 1;  // the release of tile kt - NS
        if (kt >= NS) dk_mbar_wait(empty_k(s), ph);
        dk_mbar_arrive_expect_tx(full_k(s), G::TILE);
        for (int cb = 0; cb < G::NB; ++cb)
          dk_tma_load_4d(sk + s * G::TILE + cb * G::BOX, &tmk, full_k(s), cb * G::BC, h,
                         kt * BN, b);
        if (kt >= NS) dk_mbar_wait(empty_v(s), ph);
        dk_mbar_arrive_expect_tx(full_v(s), G::TILE);
        for (int cb = 0; cb < G::NB; ++cb)
          dk_tma_load_4d(sv + s * G::TILE + cb * G::BOX, &tmv, full_v(s), cb * G::BC, h,
                         kt * BN, b);
      }
    }
    return;
  }

  // consumer warpgroup c owns q rows 64c..64c+63 of the tile
  dk_setmaxnreg_inc<240>();
  const int c = tid / 128 - 1, ct = tid % 128;
  const int warp = ct / 32, lane = ct % 32, g = lane / 4, t4 = lane % 4;
  const int row_pos = q_offset + q0 + 64 * c + 16 * warp + g;  // global position of row g
  const int wg_first = q_offset + q0 + 64 * c;
  float acc[D / 2];         // O, 64 x D per warpgroup
  float sc[BN / 2];         // S, then P in f32, 64 x 128
  uint32_t pa[BN / 16][4];  // P rounded to bf16: the A operand of P V
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {DK_NEG_INF, DK_NEG_INF}, l[2] = {0.f, 0.f};  // m in raw score units

  dk_mbar_wait(bar_q, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % NS, k0 = kt * BN;
    const uint32_t ph = (kt / NS) & 1;

    // S = Q K^T: 64 rows x 128 keys, both operands K-major in shared memory
    dk_mbar_wait(full_k(s), ph);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    dk_fence_regs(sc);
    dk_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int cb = kk * 16 / G::BC, off = (kk * 16 % G::BC) * 2;
      dk_wgmma_m64n128k16_ss(
          sc, dk_gmma_desc(sq + cb * G::BOX + c * 64 * G::SW + off, 16, 8 * G::SW, G::SWZ),
          dk_gmma_desc(sk + s * G::TILE + cb * G::BOX + off, 16, 8 * G::SW, G::SWZ));
    }
    dk_wgmma_commit();
    dk_wgmma_wait();
    dk_fence_regs(sc);
    if (lane == 0) dk_mbar_arrive(empty_k(s));  // this warp is done with K

    // online softmax: register 4j + e holds row g (e < 2) or g + 8, key
    // 8j + 2t4 + e % 2
    const bool edge = k0 + BN > Tk || (causal && kv_offset + k0 + BN - 1 > wg_first);
    float mx[2] = {DK_NEG_INF, DK_NEG_INF};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge) {
          const int key = k0 + j * 8 + 2 * t4 + (e & 1);
          const bool ok = key < Tk && (!causal || kv_offset + key <= row_pos + (e >> 1) * 8);
          if (!ok) sc[4 * j + e] = DK_NEG_INF;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
      }
    float shift[2], corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      // nothing visible yet: shift by 0 so the masked p are exactly 0
      shift[i] = m_new <= DK_NEG_INF / 2 ? 0.f : m_new * scale_log2;
      corr[i] = dk_exp2((m[i] - m_new) * scale_log2);
      m[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};  // this lane's part of the row sums
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = dk_exp2(fmaf(sc[4 * j + e], scale_log2, -shift[e >> 1]));
        rs[e >> 1] += p[e];
      }
      pa[j / 2][2 * (j % 2)] = dk_pack_bf16(p[0], p[1]);
      pa[j / 2][2 * (j % 2) + 1] = dk_pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[4 * n + 0] *= corr[0];
      acc[4 * n + 1] *= corr[0];
      acc[4 * n + 2] *= corr[1];
      acc[4 * n + 3] *= corr[1];
    }

    // O += P V: P from registers, V (keys x dims, dims contiguous) read
    // MN-major from shared memory
    dk_mbar_wait(full_v(s), ph);
    dk_fence_regs(acc);
    dk_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_pv<D>(acc, pa[kk],
                  dk_gmma_desc(sv + s * G::TILE + kk * 16 * G::SW, G::BOX, 8 * G::SW, G::SWZ));
    dk_wgmma_commit();
    dk_wgmma_wait();
    dk_fence_regs(acc);
    dk_fence_regs(pa);
    if (lane == 0) dk_mbar_arrive(empty_v(s));  // ... and with V
  }

  // epilogue: the 4 lanes of a row add their parts of l; each warp stages
  // its 16 rows of O over its own rows of the Q tile, then stores them
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float l_safe[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
  constexpr int CHB = G::SW / 16;  // 16-byte chunks per box row
  unsigned char* qs = gbase + (sq - base);
  auto staged = [&](int r, int col) {  // staged byte of (tile row r, column col)
    const int cb = col / G::BC, byte = (col % G::BC) * 2;
    return qs + cb * G::BOX + r * G::SW + (((byte >> 4) ^ (r & (CHB - 1))) << 4) +
           (byte & 15);
  };
  const int r0 = 64 * c + 16 * warp;  // this warp's first row of the tile
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + 2 * t4;
    *reinterpret_cast<uint32_t*>(staged(r0 + g, col)) =
        dk_pack_bf16(acc[4 * n] / l_safe[0], acc[4 * n + 1] / l_safe[0]);
    *reinterpret_cast<uint32_t*>(staged(r0 + g + 8, col)) =
        dk_pack_bf16(acc[4 * n + 2] / l_safe[1], acc[4 * n + 3] / l_safe[1]);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * (D / 8) / 32; ++it) {
    const int idx = lane + 32 * it, r = idx / (D / 8), col = (idx % (D / 8)) * 8;
    const int row = q0 + r0 + r;
    if (row < Tq)
      *reinterpret_cast<uint4*>(o + (((long long)b * Tq + row) * H + h) * D + col) =
          *reinterpret_cast<const uint4*>(staged(r0 + r, col));
  }
  if (t4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + r0 + g + 8 * i;
      if (row < Tq)
        lse[((long long)b * H + h) * Tq + row] =
            l[i] > 0.f ? m[i] * scale + logf(l[i]) : DK_NEG_INF;
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time through the CUDA
// runtime's entry-point query, so the library needs no link to libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                           12000, cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D map (D, H, T, B) over x (B, T, H, D): boxes of BC columns x 128
// rows of one head, so rows past T read as zeros within their own batch.
template <int D>
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* x, int B, int T, int H) {
  using G = Geo<D>;
  const cuuint64_t t = T > 0 ? T : 1;  // a map needs non-zero sizes
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), t, cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(D) * 2, cuuint64_t(H) * D * 2,
                                 t * H * D * 2};
  const cuuint32_t box[4] = {cuuint32_t(G::BC), 1, cuuint32_t(BN), 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
                strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                G::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
           int H, int Tq, int Tk, float scale, int causal, int q_offset, int kv_offset,
           cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap mq, mk, mv;
  if (!make_map<D>(encode, &mq, q, B, Tq, H) || !make_map<D>(encode, &mk, k, B, Tk, H) ||
      !make_map<D>(encode, &mv, v, B, Tk, H))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t allowed = dk_allow_max_smem(flash_fwd_bf16_kernel<D>);
  (void)allowed;  // a refusal surfaces as the launch's error
  const int n_qt = (Tq + BM - 1) / BM;
  // heads per group: as many as keep their K and V within L2_GROUP_BYTES
  long long heads = L2_GROUP_BYTES / (4ll * (Tk > 0 ? Tk : 1) * D);
  heads = heads < 1 ? 1 : (heads > B * H ? B * H : heads);
  flash_fwd_bf16_kernel<D><<<n_qt * B * H, NT, Geo<D>::SMEM, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), lse, H, Tq, Tk, scale,
      scale * 1.4426950408889634f, causal, q_offset, kv_offset, n_qt,
      static_cast<int>(heads));
  return static_cast<int>(cudaGetLastError());
}

inline int dispatch(int D, const void* q, const void* k, const void* v, void* o,
                    float* lse, int B, int H, int Tq, int Tk, float scale, int causal,
                    int q_offset, int kv_offset, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<32>(q, k, v, o, lse, B, H, Tq, Tk, scale, causal, q_offset, kv_offset, stream);
    case 64: return launch<64>(q, k, v, o, lse, B, H, Tq, Tk, scale, causal, q_offset, kv_offset, stream);
    case 128: return launch<128>(q, k, v, o, lse, B, H, Tq, Tk, scale, causal, q_offset, kv_offset, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace dk_fwd_bf16
