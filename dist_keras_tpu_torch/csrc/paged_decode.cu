// Paged single-query decode attention for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel `_decode_kernel` / `paged_attention_kernel` in
// dist_keras_tpu/ops/pallas/decode_attention.py: one query per slot over
// a paged KV pool, page ids read from the page table, an online softmax
// over the pool, positions >= lengths[s] masked, and length == 0 giving
// exact zeros.
//
// Bound on this card.  A step reads 2*len*D*4 bytes of K/V per (slot,
// head) and does 4*len*D FLOPs on them: one FLOP per two bytes, far
// below the card's ratio, so the kernel is bound by memory bandwidth.
// At the decode rungs there are few (slot, head) pairs (6 to 48 at the
// served model's six heads) for 132 SMs, so one block per pair leaves
// most of the card idle.
//
// Design: split-KV in one launch.  The grid is (H, S, n_split): each
// slot's extent is cut into chunks of CH positions, and block (h, s, z)
// takes the z-th of n_split even runs of the chunks below lengths[s]
// (read on the device, so ragged slots stay balanced and the host never
// waits on lengths).  The host picks n_split from the shapes alone, for
// about two blocks per SM (ops/decode_attention.py `split_plan`); a
// block is small (128 threads, ~64 KB of shared memory) so three fit on
// an SM and every block of a plan runs in one wave.
//
// Inside a block every warp streams its own KPW positions of each step
// (STEP = NW * KPW positions per block) through its own ring of NSTAGE
// steps of 16-byte cp.async copies, all in flight while it waits for the
// oldest; each row is found through the block's page ids (the lanes
// look up one row each and pass the offsets by shuffle), so the pool is
// never gathered.  A warp is G groups of D/16 lanes; a lane holds 16
// dims of q and of the output (float4 pieces t, t + D/16, ... so a
// group reads a row in 128-byte runs), and a group takes KPG keys per
// step: its dot products reduce in log2(D/16) shuffle rounds, side by
// side, and it keeps its own online softmax, in log2 units (q is scaled
// by scale * log2(e) once, exponentials are ex2.approx).  No warp waits
// for another until the end: the only block barriers are after the page
// ids, after the groups' states, and around the ticket.  The groups'
// states merge once, in group order, into the block's partial (m, l,
// acc), unnormalised.  The warps issue few instructions per position
// (two copies, one float4 load and four FMAs each for K and V per lane
// and 16 dims): a design whose warps reduced every key over all 32
// lanes was bound by its own instruction latency, not by its copies (on
// an H100 80GB HBM3 at 700 W it read about 2 TB/s at ring depths 2, 3
// and 4 alike).
//
// Combine in the same launch.  Each block writes its partial to an f32
// workspace (S, H, n_split, D + 2), fences, and takes a ticket for its
// (s, h); the block that draws the last ticket reads the partials in
// split order 0 .. n_split-1, so the result's bits do not depend on
// which block finished last, merges them
//   M = max m_i (0 when every split is dead),
//   out = sum 2^(m_i - M) acc_i / max(sum 2^(m_i - M) l_i, 1e-30),
// and resets the ticket to 0 for the next launch.  A split with no
// position below lengths[s] writes a dead partial (m = -1e30, l = 0,
// acc = 0) and touches no K/V, so a length-0 slot comes out as exact
// zeros.  With n_split = 1 the block writes the output directly.  The
// caller gives each stream its own tickets and workspace
// (ops/decode_attention.py), so launches on two streams never share them.
#include "common.cuh"
#include "sm90_ptx.cuh"

namespace {

constexpr int NW = 4;          // warps per block
constexpr int NT = NW * 32;    // threads per block
constexpr int DPL = 16;        // dims of q and of the output per lane
constexpr int KPG = 2;         // keys per lane group and step
constexpr int NSTAGE = 2;      // steps in each warp's copy ring
constexpr int CH = 32;         // positions per chunk: CHUNK in ops/decode_attention.py
constexpr int MERGE_BATCH = 16;  // partials' acc loaded together by the combine
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_SPLIT = 4096;  // the combine stages (m, l) of each split in the ring

template <int D>
struct Geometry {
  static constexpr int LPK = D / DPL;          // lanes per key: 8, 4, 2
  static constexpr int G = 32 / LPK;           // lane groups per warp
  static constexpr int KPW = G * KPG;          // positions per warp and step
  static constexpr int STEP = NW * KPW;        // positions per block and step
  static constexpr int WSTAGE = 2 * KPW * D;   // floats per warp and stage (K, V)
  static constexpr int WRING = NSTAGE * WSTAGE;
  static_assert(D % DPL == 0 && 32 % LPK == 0 && KPW <= 32, "warp geometry");
  static_assert(G * (D + 2) <= WRING, "a warp's ring holds its groups' states");
  static_assert(2 * MAX_SPLIT <= NW * WRING, "the ring holds every split's (m, l)");
};

// the warps' copy rings, then the block's page ids
template <int D>
int smem_bytes(int max_pages) {
  return static_cast<int>(NW * Geometry<D>::WRING * sizeof(float) + max_pages * sizeof(int));
}

template <int D>
__global__ void __launch_bounds__(NT, 3)
paged_decode_kernel(const float* __restrict__ q, const float* __restrict__ kp,
                    const float* __restrict__ vp, const int* __restrict__ page_table,
                    const int* __restrict__ lengths, float* __restrict__ out,
                    float* __restrict__ work, int* __restrict__ tickets, int H, int P,
                    int ps, int max_pages, float scale) {
  using Geo = Geometry<D>;
  constexpr int LPK = Geo::LPK, G = Geo::G, KPW = Geo::KPW, STEP = Geo::STEP;
  constexpr int WSTAGE = Geo::WSTAGE, D4 = D / 4, NV = DPL / 4;
  constexpr int PIECES = 2 * KPW * D4;  // 16-byte copies per warp and step
  static_assert(PIECES % 32 == 0, "copy geometry");
  extern __shared__ __align__(16) float ring[];  // [NW][NSTAGE][K rows, V rows][D]
  int* pages = reinterpret_cast<int*>(ring + NW * Geo::WRING);
  __shared__ int last;

  const int h = blockIdx.x, s = blockIdx.y, z = blockIdx.z, n_split = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / LPK, t = lane % LPK;  // lane group, lane within it
  const long long q_base = (static_cast<long long>(s) * H + h) * D;
  // q in log2 units; lane t holds the float4 pieces t, t + LPK, ...
  float4 qv[NV];
#pragma unroll
  for (int e = 0; e < NV; ++e) {
    const float4 x = *reinterpret_cast<const float4*>(q + q_base + 4 * (t + LPK * e));
    const float c = scale * LOG2E;
    qv[e] = make_float4(x.x * c, x.y * c, x.z * c, x.w * c);
  }
  const int len = max(0, min(lengths[s], max_pages * ps));
  const int n_chunks = (len + CH - 1) / CH;
  const int c0 = static_cast<int>(static_cast<long long>(z) * n_chunks / n_split);
  const int c1 = static_cast<int>(static_cast<long long>(z + 1) * n_chunks / n_split);
  const int pos0 = c0 * CH, pos1 = min(c1 * CH, len);  // this split's positions
  // this split's page ids, read once: the copies below index them from
  // shared memory instead of waiting on a global load each.  Clamped as
  // JAX's gather does: a bad id reads a wrong page, never memory outside
  // the pool
  const int pg0 = pos0 / ps;
  const int n_pg = pos1 > pos0 ? (pos1 - 1) / ps - pg0 + 1 : 0;
  const int* pt = page_table + static_cast<long long>(s) * max_pages + pg0;
  for (int i = tid; i < n_pg; i += NT) pages[i] = min(max(pt[i], 0), P - 1);
  __syncthreads();

  const float* kh = kp + static_cast<long long>(h) * P * ps * D;
  const float* vh = vp + static_cast<long long>(h) * P * ps * D;
  float* wring = ring + warp * Geo::WRING;

  auto issue = [&](int step, int stage) {  // this warp's rows of a step
    // lane j < KPW finds row j (-1: past the split, zero-filled)
    const int pos = pos0 + step * STEP + warp * KPW + lane;
    int off = -1;
    if (lane < KPW && pos < pos1) {
      const int i = pos / ps;
      off = (pages[i - pg0] * ps + (pos - i * ps)) * D;
    }
    float* dst = wring + stage * WSTAGE;
#pragma unroll
    for (int it = 0; it < PIECES / 32; ++it) {
      const int idx = lane + it * 32;
      const int row = idx / D4, d4 = idx % D4;  // rows 0..KPW-1 K, then V
      const int r = __shfl_sync(0xffffffffu, off, row % KPW);
      dk_cp_async16(dk_smem_u32(dst + row * D + d4 * 4),
                    (row < KPW ? kh : vh) + (r < 0 ? 0 : r) + d4 * 4, r >= 0);
    }
  };

  float4 acc[NV];
#pragma unroll
  for (int e = 0; e < NV; ++e) acc[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = DK_NEG_INF, l = 0.f;

  // one commit group per step, empty past the end, so wait<NSTAGE-1>
  // after the next step's commit always means "step i has landed"; the
  // next step is issued before the wait, so NSTAGE steps are in flight
  // while the warp waits
  const int n_steps = pos1 > pos0 ? (pos1 - pos0 + STEP - 1) / STEP : 0;
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) {
    if (i < n_steps) issue(i, i);
    dk_cp_async_commit();
  }
  for (int i = 0; i < n_steps; ++i) {
    __syncwarp();  // every lane is done with step i-1: its stage is free
    if (i + NSTAGE - 1 < n_steps) issue(i + NSTAGE - 1, (i + NSTAGE - 1) % NSTAGE);
    dk_cp_async_commit();
    dk_cp_async_wait<NSTAGE - 1>();
    __syncwarp();  // every lane's copies of step i are visible
    const float* ks = wring + (i % NSTAGE) * WSTAGE;
    const float* vs = ks + KPW * D;
    float sc[KPG];
#pragma unroll
    for (int k = 0; k < KPG; ++k) {
      const float* row = ks + (grp * KPG + k) * D;
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < NV; ++e) {
        const float4 x = *reinterpret_cast<const float4*>(row + 4 * (t + LPK * e));
        dot = fmaf(qv[e].x, x.x, dot);
        dot = fmaf(qv[e].y, x.y, dot);
        dot = fmaf(qv[e].z, x.z, dot);
        dot = fmaf(qv[e].w, x.w, dot);
      }
      sc[k] = dot;
    }
#pragma unroll
    for (int w = LPK / 2; w > 0; w >>= 1)
#pragma unroll
      for (int k = 0; k < KPG; ++k) sc[k] += __shfl_xor_sync(0xffffffffu, sc[k], w);
    float tile_max = DK_NEG_INF;
#pragma unroll
    for (int k = 0; k < KPG; ++k) {
      const int pos = pos0 + i * STEP + warp * KPW + grp * KPG + k;
      sc[k] = pos < pos1 ? sc[k] : DK_NEG_INF;
      tile_max = fmaxf(tile_max, sc[k]);
    }
    const float m_new = fmaxf(m, tile_max);
    // a fully masked step contributes exactly nothing
    const float safe_m = m_new <= DK_NEG_INF / 2 ? 0.f : m_new;
    const float corr = dk_exp2(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int k = 0; k < KPG; ++k) {
      sc[k] = dk_exp2(sc[k] - safe_m);
      psum += sc[k];
    }
    l = l * corr + psum;
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      float4 a = make_float4(acc[e].x * corr, acc[e].y * corr, acc[e].z * corr,
                             acc[e].w * corr);
#pragma unroll
      for (int k = 0; k < KPG; ++k) {
        const float4 v = *reinterpret_cast<const float4*>(
            vs + (grp * KPG + k) * D + 4 * (t + LPK * e));
        a.x = fmaf(sc[k], v.x, a.x);
        a.y = fmaf(sc[k], v.y, a.y);
        a.z = fmaf(sc[k], v.z, a.z);
        a.w = fmaf(sc[k], v.w, a.w);
      }
      acc[e] = a;
    }
    m = m_new;
  }
  dk_cp_async_wait<0>();
  __syncwarp();  // the ring is idle: the groups' states go there

  // the groups' states meet once, in group order: the block's partial
  float* mine = wring + grp * (D + 2);
#pragma unroll
  for (int e = 0; e < NV; ++e) {
    float* o = mine + 4 * (t + LPK * e);  // rows of D + 2: not 16-byte aligned
    o[0] = acc[e].x, o[1] = acc[e].y, o[2] = acc[e].z, o[3] = acc[e].w;
  }
  if (t == 0) mine[D] = m, mine[D + 1] = l;
  __syncthreads();
  // one output dim per thread from here (D <= NT); threads past D repeat
  // a dim and write nothing, so every barrier below sees the whole block
  const int dim = tid % D;
  const bool writer = tid < D;
  float mb = DK_NEG_INF;
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int g = 0; g < G; ++g) mb = fmaxf(mb, ring[w * Geo::WRING + g * (D + 2) + D]);
  const float safe_b = mb <= DK_NEG_INF / 2 ? 0.f : mb;
  float lb = 0.f, ab = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float* st = ring + w * Geo::WRING + g * (D + 2);
      const float f = dk_exp2(st[D] - safe_b);  // 0 for a dead group
      lb = fmaf(f, st[D + 1], lb);
      ab = fmaf(f, st[dim], ab);
    }
  if (n_split == 1) {
    if (writer) out[q_base + dim] = ab / fmaxf(lb, 1e-30f);
    return;
  }

  const long long pair = static_cast<long long>(s) * H + h;
  float* wp = work + pair * n_split * (D + 2);
  if (writer) wp[z * (D + 2) + dim] = ab;
  if (tid == 0) wp[z * (D + 2) + D] = mb, wp[z * (D + 2) + D + 1] = lb;
  __threadfence();  // the partial is visible before the ticket is taken
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + pair, 1) == n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();  // every other block's partial is visible from here
  // the splits' (m, l) into the idle ring, all at once, then their acc in
  // split order, MERGE_BATCH loads in flight per thread
  float* ml = ring;
  for (int i = tid; i < n_split; i += NT) {
    ml[2 * i] = __ldcg(wp + i * (D + 2) + D);
    ml[2 * i + 1] = __ldcg(wp + i * (D + 2) + D + 1);
  }
  __syncthreads();
  if (!writer) return;
  float mx = DK_NEG_INF;
  for (int i = 0; i < n_split; ++i) mx = fmaxf(mx, ml[2 * i]);
  const float safe = mx <= DK_NEG_INF / 2 ? 0.f : mx;
  float lt = 0.f, at = 0.f;
  for (int i0 = 0; i0 < n_split; i0 += MERGE_BATCH) {
    float ai[MERGE_BATCH];
#pragma unroll
    for (int j = 0; j < MERGE_BATCH; ++j)
      ai[j] = i0 + j < n_split ? __ldcg(wp + (i0 + j) * (D + 2) + dim) : 0.f;
#pragma unroll
    for (int j = 0; j < MERGE_BATCH && i0 + j < n_split; ++j) {
      const float f = dk_exp2(ml[2 * (i0 + j)] - safe);  // 0 for a dead split
      lt = fmaf(f, ml[2 * (i0 + j) + 1], lt);
      at = fmaf(f, ai[j], at);
    }
  }
  out[q_base + dim] = at / fmaxf(lt, 1e-30f);
  if (tid == 0) tickets[pair] = 0;  // ready for the next launch on this stream
}

template <int D>
void launch(const float* q, const float* kp, const float* vp, const int* pt,
            const int* lengths, float* out, float* work, int* tickets, int S, int H,
            int P, int ps, int max_pages, int n_split, float scale, cudaStream_t stream) {
  const int smem = smem_bytes<D>(max_pages);
  static const cudaError_t allowed = dk_allow_max_smem(paged_decode_kernel<D>);
  (void)allowed;  // a refusal surfaces as the launch's error
  const dim3 grid(H, S, n_split);
  paged_decode_kernel<D><<<grid, NT, smem, stream>>>(q, kp, vp, pt, lengths, out, work,
                                                      tickets, H, P, ps, max_pages, scale);
}

}  // namespace

// q (S,H,D), k/v pools (H,P,ps,D), page_table (S,max_pages) int32,
// lengths (S,) int32, out (S,H,D); all float32 contiguous, pools 16-byte
// aligned, P*ps*D < 2^31.  With n_split > 1: work
// (S*H*n_split*(D+2),) f32 and tickets (S*H,) int32, all zero, used by
// no launch that may run at the same time; the tickets are zero again
// when the launch ends.  -> the launch's cudaGetLastError()
// (cudaErrorInvalidValue for a D or n_split it does not take).
extern "C" int dk_paged_decode(int D, const float* q, const float* kp, const float* vp,
                               const int* page_table, const int* lengths, float* out,
                               float* work, int* tickets, int S, int H, int P, int ps,
                               int max_pages, int n_split, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_split < 1 || n_split > MAX_SPLIT || S > 65535 || (n_split > 1 && (!work || !tickets)) ||
      static_cast<long long>(P) * ps * D >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 32: launch<32>(q, kp, vp, page_table, lengths, out, work, tickets, S, H, P, ps, max_pages, n_split, scale, st); break;
    case 64: launch<64>(q, kp, vp, page_table, lengths, out, work, tickets, S, H, P, ps, max_pages, n_split, scale, st); break;
    case 128: launch<128>(q, kp, vp, page_table, lengths, out, work, tickets, S, H, P, ps, max_pages, n_split, scale, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
