// One-pass flash-attention backward (K4) for Hopper (sm_90a): dQ, dK and
// dV in one kernel, bit-equal to the two-kernel backward K2 (dQ) + K3
// (dK, dV) in both dtypes.  f32 inputs run the kernel here, on f32 FMAs
// over flash_bwd_tiles.cuh like the f32 K2 and K3 (flash_bwd.cu); bf16
// inputs run `flash_bwd_fused_bf16_kernel` (flash_bwd_bf16.cuh), which is
// the bf16 K3's own block on the tensor cores with the dQ hand-off added.
//
// Replaces the TPU kernel `_fused_bwd_kernel` (called from
// `fused_bwd_call`) in dist_keras_tpu/ops/pallas/fused_bwd_experimental.py.
// That kernel walks (batch*head, kv block, q block) in order, keeps dK/dV
// in scratch over the q blocks, and carries dQ across kv blocks through an
// aliased f32 output: each visit reads the block, adds its tile's part and
// writes it back.  Mosaic does not say whether a revisited aliased block
// sees the previous write, so the JAX package serves that kernel only
// after a parity check against the two-kernel backward.  Here the same
// one-pass order is made deterministic instead:
//
// Design.  K3's structure: one block of 128 threads per (batch*head,
// 64-key kv tile) walks 32-row Q/dO tiles from the first one that sees its
// first key, keeps dK and dV in f32 registers and writes them as K3 does
// (in bf16 it is K3's code, so dk and dv are K3's bit for bit).  Once a
// tile's dS sits in shared memory (rounded as K2 rounds it), the block
// adds dS K to dQ in a fixed order: it waits until the previous kv tile of
// the same batch*head has added to that q tile, loads each row's f32 dQ
// partial from a global accumulator (B,Tq,H,D), continues each (row, dim)
// chain over its 64 keys in K2's order, stores the partial back and
// raises the q tile's counter.  f32: an fmaf chain over the keys in
// ascending order.  bf16: mma.sync over the tile's 16-key slices in
// ascending order, dS and K as the same bf16 fragments K2 builds
// (flash_bwd_bf16.cuh's header states that chain).  The chain for a
// (row, dim) then runs over every key in K2's order, and the block holding
// the last kv tile that the q tile sees writes scale * acc into dq in the
// input dtype, as K2 does: dq is K2's bit for bit.  (The two kernels may
// run a row's chain through a different number of trailing zero terms
// past its causal edge, which can only change the sign of an exact zero.)
// The kv tiles that see a q tile are always tiles 0..L, so tile 0 starts
// each chain from 0 and the accumulator needs no zeroing; q tiles that no
// kv tile sees (dead rows) keep the zeros the wrapper fills dq with.
//
// Ordering.  The partial is stored with st.global.cg, and a release
// raises the q tile's counter once every thread's stores are ordered
// before it: f32, __threadfence by every thread, a barrier, then one
// thread's fence and atomicAdd; bf16, a barrier, then one thread's
// red.release.gpu, which carries the block's stores (cumulativity, as a
// grid barrier's release does).  The waiting block's first thread spins
// on ld.acquire.gpu and a barrier lets the block load the partial, with
// ld.global.cg so no stale L1 line is read (flash_bwd_tiles.cuh's
// `dq_wait`).  No float atomics are used: the result does not depend on
// the blocks' timing.
//
// No deadlock.  The kv tile is the slowest grid index (f32: blockIdx.y;
// bf16: the linear index runs over every batch*head within a kv tile), so
// a block that waits depends only on blocks of lower linear index (kv
// tile - 1, same batch*head).  Blocks are dispatched in increasing linear
// index, so every block it waits for is already running or done, and by
// induction on the index each of those finishes.  The same order keeps
// the waits short: the heavy low kv tiles of a causal backward start
// first, and a block of kv tile kt mostly starts after tile kt - 1 has
// passed its first q tiles, instead of waiting for them while holding its
// slot (K3's head groups would make every tile of a group resident at once).
//
// Bound on this card.  Per visible (q, k) pair K4 does 10*D FLOPs (S, dP,
// dV, dK and dQ products) against K2 + K3's 14*D, so it is bound by
// operations: 67 TFLOP/s for f32 (FMAs outside the tensor cores), 989
// TFLOP/s dense bf16 on the tensor cores, where mma.sync reaches part of
// it (flash_bwd_bf16.cuh).  The hand-off moves each q tile's f32 partial
// through L2 once per kv tile that sees it.  Shared memory: f32 K3's
// 158 KB plus a row-major K tile, 191 KB at D=128; bf16 K3's 79,360 B.
#include "flash_bwd_bf16.cuh"
#include "flash_bwd_tiles.cuh"

namespace {

using namespace dk_bwd;

template <int D>
constexpr int fused_smem_floats() {
  return DkvTiles<D>::floats() + KV_BK * (D + 4);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_fused_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ dl, T* __restrict__ dq,
                       T* __restrict__ dk, T* __restrict__ dv,
                       float* __restrict__ dq_acc, int* __restrict__ counts,
                       int H, int Tq, int Tk, float scale, int causal,
                       int q_offset, int kv_offset) {
  constexpr int DV = D / (4 * TC);
  constexpr int KR = D + 4;  // row stride of the row-major K tile
  extern __shared__ __align__(16) float smem[];
  const DkvTiles<D> sm(smem);
  float* krs = sm.end;  // [KV_BK][KR] K tile row-major
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kt = blockIdx.y, k0 = kt * KV_BK;
  const int nqt = (Tq + KV_BQ - 1) / KV_BQ;
  const int tid = threadIdx.x;
  const int rg = tid / TC;  // dQ rows rg*2, rg*2+1 of the q tile
  const int dc = tid % TC;  // dQ dims {i*32 + dc*4 .. +3}

  load_kv_tile<T, D>(sm, krs, k, v, b, h, k0, H, Tk);

  float acc_k[4][4 * DV], acc_v[4][4 * DV];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 4 * DV; ++i) acc_k[r][i] = acc_v[r][i] = 0.f;

  // the next kv tile sees q tiles from here on (none when this is the last)
  const int next_first = kt + 1 < static_cast<int>(gridDim.y)
                             ? first_q_tile(k0 + KV_BK, causal, q_offset, kv_offset)
                             : Tq;
  for (int q0 = first_q_tile(k0, causal, q_offset, kv_offset); q0 < Tq;
       q0 += KV_BQ) {
    dkv_step<T, D>(sm, q, dout, lse, dl, b, h, k0, q0, H, Tq, Tk, scale,
                   causal, q_offset, kv_offset, acc_k, acc_v);

    // dQ: wait for kv tile kt - 1's part of this q tile, then continue
    int* count = counts + static_cast<long long>(bh) * nqt + q0 / KV_BQ;
    dq_wait(count, kt);
    float acc[2][4 * DV];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + rg * 2 + r;
      const float* part = dq_acc + row_at(b, row, h, Tq, H, D);
#pragma unroll
      for (int i = 0; i < DV; ++i) {
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kt > 0 && row < Tq)
          x = __ldcg(reinterpret_cast<const float4*>(part + i * 32 + dc * 4));
        acc[r][i * 4 + 0] = x.x;
        acc[r][i * 4 + 1] = x.y;
        acc[r][i * 4 + 2] = x.z;
        acc[r][i * 4 + 3] = x.w;
      }
    }
    const float* ds0 = sm.dss + (rg * 2) * KV_PS;
#pragma unroll 4
    for (int j = 0; j < KV_BK; ++j) {
      const float sa[2] = {ds0[j], ds0[KV_PS + j]};
#pragma unroll
      for (int i = 0; i < DV; ++i) {
        const float4 kv = *reinterpret_cast<const float4*>(krs + j * KR + i * 32 + dc * 4);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          acc[r][i * 4 + 0] = fmaf(sa[r], kv.x, acc[r][i * 4 + 0]);
          acc[r][i * 4 + 1] = fmaf(sa[r], kv.y, acc[r][i * 4 + 1]);
          acc[r][i * 4 + 2] = fmaf(sa[r], kv.z, acc[r][i * 4 + 2]);
          acc[r][i * 4 + 3] = fmaf(sa[r], kv.w, acc[r][i * 4 + 3]);
        }
      }
    }
    if (next_first > q0) {  // the last kv tile this q tile sees: emit dq
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + rg * 2 + r;
        if (row >= Tq) continue;
        T* out = dq + row_at(b, row, h, Tq, H, D);
#pragma unroll
        for (int i = 0; i < DV; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            out[i * 32 + dc * 4 + e] = dk_from_f<T>(scale * acc[r][i * 4 + e]);
      }
    } else {  // hand the partial to kv tile kt + 1
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + rg * 2 + r;
        if (row >= Tq) continue;
        float* part = dq_acc + row_at(b, row, h, Tq, H, D);
#pragma unroll
        for (int i = 0; i < DV; ++i)
          __stcg(reinterpret_cast<float4*>(part + i * 32 + dc * 4),
                 make_float4(acc[r][i * 4 + 0], acc[r][i * 4 + 1],
                             acc[r][i * 4 + 2], acc[r][i * 4 + 3]));
      }
      __threadfence();
      __syncthreads();
      if (tid == 0) {
        __threadfence();
        atomicAdd(count, 1);
      }
    }
  }

  store_dkv<T, D>(dk, dv, b, h, k0, H, Tk, scale, acc_k, acc_v);
}

template <typename T, int D>
void launch_fused(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* dl,
                  void* dq, void* dk, void* dv, float* dq_acc, int* counts,
                  int B, int H, int Tq, int Tk, float scale, int causal,
                  int q_offset, int kv_offset, cudaStream_t stream) {
  constexpr int smem = fused_smem_floats<D>() * static_cast<int>(sizeof(float));
  static const cudaError_t allowed = dk_allow_max_smem(flash_bwd_fused_kernel<T, D>);
  (void)allowed;  // a refusal surfaces as the launch's error
  const dim3 grid(B * H, (Tk + KV_BK - 1) / KV_BK);  // kv tile slowest
  flash_bwd_fused_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dl,
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), dq_acc,
      counts, H, Tq, Tk, scale, causal, q_offset, kv_offset);
}

}  // namespace

// q, dout (B,Tq,H,D), k/v (B,Tk,H,D), all contiguous, one dtype; lse and dl
// (B,H,Tq) f32.  dtype: 0 = float32, 1 = bfloat16.  dq (B,Tq,H,D) in the
// input dtype, filled with zeros by the caller; dk and dv (B,Tk,H,D) in
// the input dtype.  dq_acc: f32 scratch shaped like q (no zeroing
// needed); counts: B*H*ceil(Tq/32) int32 zeros.  -> cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a dtype or D it does not
// take).
extern "C" int dk_flash_bwd_fused(int dtype, int D, const void* q,
                                  const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* dl, void* dq, void* dk,
                                  void* dv, float* dq_acc, int* counts, int B,
                                  int H, int Tq, int Tk, float scale,
                                  int causal, int q_offset, int kv_offset,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const dk_bwd_bf16::Args a{q, k, v, dout, lse, dl, B, H, Tq, Tk,
                              scale, causal, q_offset, kv_offset};
    return dispatch_d<__nv_bfloat16>(D, [&](auto, auto dim) {
      dk_bwd_bf16::launch_fused<decltype(dim)::value>(a, dq, dk, dv, dq_acc,
                                                      counts, st);
    });
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_d<float>(D, [&](auto t, auto dim) {
    launch_fused<decltype(t), decltype(dim)::value>(
        q, k, v, dout, lse, dl, dq, dk, dv, dq_acc, counts, B, H, Tq, Tk,
        scale, causal, q_offset, kv_offset, st);
  });
}
