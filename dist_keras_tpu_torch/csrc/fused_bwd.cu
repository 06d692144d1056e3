// One-pass flash-attention backward (K4) for Hopper (sm_90a): dQ, dK and
// dV in one kernel, bit-equal to the two-kernel backward K2 (dQ) + K3
// (dK, dV) in both dtypes.  In each dtype it is that dtype's K3 block on
// the tensor cores with the dQ hand-off added: `flash_bwd_fused_f32_kernel`
// (flash_bwd_f32.cuh, split-TF32 mma.sync) and
// `flash_bwd_fused_bf16_kernel` (flash_bwd_bf16.cuh, bf16 mma.sync).
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
// Design.  K3's structure and code: one block of 128 threads per
// (batch*head, 64-key kv tile) walks 32-row Q/dO tiles from the first one
// that sees its first key, keeps dK and dV in f32 registers and writes
// them as K3 does, so dk and dv are K3's bit for bit.  Once a tile's dS
// sits in shared memory (in the dtype K2 takes it in), the block adds dS K
// to dQ in a fixed order: it waits until the previous kv tile of the same
// batch*head has added to that q tile, loads each row's f32 dQ partial
// from a global accumulator (B,Tq,H,D), continues each (row, dim) chain
// over its 64 keys in K2's order, stores the partial back and raises the
// q tile's counter: mma.sync over the tile's k-steps in ascending order,
// dS and K as the same fragments K2 builds (each dtype's header states
// that chain).  The chain for a (row, dim) then runs over every key in
// K2's order, and the block holding the last kv tile that the q tile sees
// writes scale * acc into dq in the input dtype, as K2 does: dq is K2's
// bit for bit.  (The two kernels may
// run a row's chain through a different number of trailing zero terms
// past its causal edge, which can only change the sign of an exact zero.)
// The kv tiles that see a q tile are always tiles 0..L, so tile 0 starts
// each chain from 0 and the accumulator needs no zeroing; q tiles that no
// kv tile sees (dead rows) keep the zeros the wrapper fills dq with.
//
// Ordering.  The partial is stored with st.global.cg, and a release
// raises the q tile's counter once every thread's stores are ordered
// before it: a barrier, then one thread's red.release.gpu, which carries
// the block's stores (cumulativity, as a grid barrier's release does).
// The waiting block's first thread spins on ld.acquire.gpu and a barrier
// lets the block load the partial, with ld.global.cg so no stale L1 line
// is read (flash_bwd_tiles.cuh's `dq_wait`).  No float atomics are
// used: the result does not depend on the blocks' timing.
//
// No deadlock.  The kv tile is the slowest grid index (the linear block
// index runs over every batch*head within a kv tile), so a block that
// waits depends only on blocks of lower linear index (kv tile - 1, same
// batch*head).  Blocks are dispatched in increasing linear
// index, so every block it waits for is already running or done, and by
// induction on the index each of those finishes.  The same order keeps
// the waits short: the heavy low kv tiles of a causal backward start
// first, and a block of kv tile kt mostly starts after tile kt - 1 has
// passed its first q tiles, instead of waiting for them while holding its
// slot (K3's head groups would make every tile of a group resident at once).
//
// Bound on this card.  Per visible (q, k) pair K4 does 10*D FLOPs (S, dP,
// dV, dK and dQ products) against K2 + K3's 14*D, so it is bound by
// operations: 165 TFLOP/s of f32 work as split TF32 (495 / 3), 989
// TFLOP/s dense bf16, where mma.sync reaches part of either (the two
// headers).  The hand-off moves each q tile's f32 partial through L2 once
// per kv tile that sees it.  Shared memory: each dtype's K3's.
#include "flash_bwd_bf16.cuh"
#include "flash_bwd_f32.cuh"
#include "flash_bwd_tiles.cuh"

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
  const dk_bwd::Args a{q, k, v, dout, lse, dl, B, H, Tq, Tk, scale, causal, q_offset, kv_offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dk_bwd::dispatch_d(D, [&](auto dim) {
      dk_bwd_f32::launch_fused<decltype(dim)::value>(a, dq, dk, dv, dq_acc, counts, st);
    });
  if (dtype == 1)
    return dk_bwd::dispatch_d(D, [&](auto dim) {
      dk_bwd_bf16::launch_fused<decltype(dim)::value>(a, dq, dk, dv, dq_acc, counts, st);
    });
  return static_cast<int>(cudaErrorInvalidValue);
}
