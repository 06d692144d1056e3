// Adam's update and optax's apply_updates over a whole params tree, each
// in one launch (or a few), for Hopper (sm_90a); f32 and bf16 leaves.
//
// Replaces no TPU kernel.  The JAX package's adam is optax's tree_map,
// which XLA fuses over each leaf (dist_keras_tpu/ops/optimizers.py);
// the port ran it eagerly, 15 elementwise launches a leaf, and the host's
// dispatch of them, not the card, paced the optimizer phase.
//
// - dk_adam_update: for every leaf, from g, mu and nu,
//     mu' = (1-b1)*g + b1*mu,  nu' = (1-b2)*(g*g) + b2*nu,
//     u   = -lr * (mu'/c1) / (sqrt(nu'/c2 + eps_root) + eps),
//   writing u, mu' and nu' to new buffers (the inputs stay as they
//   were).  c1 = 1 - b1^count and c2 = 1 - b2^count are f32 tensors the
//   caller computed on the card from the step count, read here, never
//   recomputed: one value for the tree (a 0-d count), or one per row of
//   each leaf's leading dims (a stacked count of shape (W,), W workers).
// - dk_apply_updates: p' = p + u for every leaf, the sum in f32, rounded
//   to p's dtype; p and u each f32 or bf16.
//
// Each operation is the eager path's, in its order and with its
// rounding (ops/optimizers.py adam_reference, apply_updates_reference):
// no contraction (the __f*_rn intrinsics), the scalars are the f32 that
// PyTorch makes of the Python doubles, and a bf16 leaf is rounded to
// bf16 after every operation, the corrections too (_lead casts them to
// the leaf's dtype), so the results are bit-equal to the eager ones.
//
// Bound on this card: bytes.  The update reads g, mu and nu and writes
// u, mu' and nu': 24 B a parameter in f32, 0.62 ms for ViT-B/16's 86.5 M
// at 3.35 TB/s; the apply reads p and u and writes p': 12 B, 0.31 ms.
// A few flops an element, far below the card's ratio.
//
// Design.  The host hands every leaf to one launch in a table passed as
// the kernel's parameters (up to 32 KB on CUDA 12.1 and later): the
// leaf's pointers, its size, its row length for a stacked count, its
// dtype and the index of its first block.  A leaf is cut into chunks of
// CHUNK elements, one block a chunk, and a block finds its leaf by a
// binary search of the first blocks, so leaves of 768 elements and of
// 2.36 M share the grid (ViT-B/16: ~21,000 blocks for 132 SMs).  A
// thread moves 16-byte vectors, all of its loads issued before its
// first store; a leaf whose pointers are not 16-byte aligned, and the
// ragged end of each leaf, go element by element.
//
// Every input and output is contiguous: the wrapper (ops/multi_tensor.py)
// hands over a dense copy of the few inputs that autograd delivers
// transposed (a tensor-parallel block's w1, a conv kernel's grad),
// allocates the outputs and plans the launches (more leaves than a
// table holds take further launches).  No host wait, no allocation, no
// copy here.
#include <cstdint>
#include <cstring>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long CHUNK = 4096;       // CHUNK in ops/multi_tensor.py
constexpr int ADAM_MAX_LEAVES = 300;    // ADAM_MAX_LEAVES there
constexpr int APPLY_MAX_LEAVES = 480;   // APPLY_MAX_LEAVES there
constexpr int F32 = 0, BF16 = 1;        // leaf dtype codes

struct AdamLeaf {          // ops/multi_tensor.py ADAM_LEAF, 72 bytes
  const void* g;
  const void* m;
  const void* v;
  void* u;
  void* m_out;
  void* v_out;
  long long n;             // elements
  long long row;           // elements a count row; 0 for a 0-d count
  int dtype;
  int first_block;
};

struct ApplyLeaf {         // ops/multi_tensor.py APPLY_LEAF, 48 bytes
  const void* p;
  const void* u;
  void* out;
  long long n;
  int p_dtype;
  int u_dtype;
  int first_block;
  int pad;
};

struct AdamTable {
  int n_leaves;
  AdamLeaf leaf[ADAM_MAX_LEAVES];
};

struct ApplyTable {
  int n_leaves;
  ApplyLeaf leaf[APPLY_MAX_LEAVES];
};

static_assert(sizeof(AdamLeaf) == 72 && sizeof(ApplyLeaf) == 48, "table rows");
static_assert(sizeof(AdamTable) + 128 <= 32764 && sizeof(ApplyTable) + 128 <= 32764,
              "a table must fit the kernel parameter space with the other arguments");

struct AdamScalars {       // each the f32 PyTorch makes of a Python double
  float b1, one_minus_b1, b2, one_minus_b2, eps, eps_root, neg_lr;
};

// -- element types ----------------------------------------------------------

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The value an eager op of dtype T leaves: a bf16 op computes in f32 and
// rounds its result to bf16; an f32 op's result is already an f32.
template <typename T> __device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

// N elements of T from 16-byte aligned memory, as floats (N * sizeof(T) a
// multiple of 16); and back.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[N]) {
  constexpr int W = N * static_cast<int>(sizeof(T)) / 16;
  uint4 raw[W];
#pragma unroll
  for (int i = 0; i < W; ++i) raw[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = to_f(e[j]);
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[N]) {
  constexpr int W = N * static_cast<int>(sizeof(T)) / 16;
  uint4 raw[W];
  T* e = reinterpret_cast<T*>(raw);
#pragma unroll
  for (int j = 0; j < N; ++j) e[j] = from_f<T>(in[j]);
#pragma unroll
  for (int i = 0; i < W; ++i) reinterpret_cast<uint4*>(p)[i] = raw[i];
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The block's leaf: the last whose first block is at or below blockIdx.x
// (every leaf in a table has at least one block).
template <typename Table>
__device__ __forceinline__ int find_leaf(const Table& t) {
  const int b = static_cast<int>(blockIdx.x);
  int lo = 0, hi = t.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].first_block <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// -- adam -------------------------------------------------------------------

// One element: _scale_by_adam then adam's -lr * u, operation by operation.
// c1 and c2 are the corrections already in the leaf's dtype.
template <typename T>
__device__ __forceinline__ void adam_elem(float g, float m, float v, float c1, float c2,
                                          const AdamScalars& s, float& u, float& mo, float& vo) {
  mo = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(s.one_minus_b1, g)), rnd<T>(__fmul_rn(s.b1, m))));
  const float gg = rnd<T>(__fmul_rn(g, g));
  vo = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(s.one_minus_b2, gg)), rnd<T>(__fmul_rn(s.b2, v))));
  const float m_hat = rnd<T>(__fdiv_rn(mo, c1));
  const float v_hat = rnd<T>(__fdiv_rn(vo, c2));
  const float root = rnd<T>(__fsqrt_rn(rnd<T>(__fadd_rn(v_hat, s.eps_root))));
  const float step = rnd<T>(__fdiv_rn(m_hat, rnd<T>(__fadd_rn(root, s.eps))));
  u = rnd<T>(__fmul_rn(s.neg_lr, step));
}

// The corrections of element i: row i / row of a stacked count, else the
// one value.
template <typename T>
__device__ __forceinline__ void corrections(const float* c1, const float* c2, long long i,
                                            long long row, float& a, float& b) {
  const long long r = row ? i / row : 0;
  a = rnd<T>(c1[r]);
  b = rnd<T>(c2[r]);
}

template <typename T>
__device__ void adam_chunk(const AdamLeaf& L, long long start, long long end,
                           const float* c1p, const float* c2p, const AdamScalars& s) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int ILP = static_cast<int>(CHUNK / (THREADS * VEC));
  const T* g = static_cast<const T*>(L.g);
  const T* m = static_cast<const T*>(L.m);
  const T* v = static_cast<const T*>(L.v);
  T* u = static_cast<T*>(L.u);
  T* mo = static_cast<T*>(L.m_out);
  T* vo = static_cast<T*>(L.v_out);
  const bool vec = aligned16(g) && aligned16(m) && aligned16(v) && aligned16(u) &&
                   aligned16(mo) && aligned16(vo);
  float c1 = 0.f, c2 = 0.f;
  if (L.row == 0) corrections<T>(c1p, c2p, 0, 0, c1, c2);
  if (vec && end - start == CHUNK) {
    // a whole chunk: ILP vectors a thread, every load before any store
    float gr[ILP][VEC], mr[ILP][VEC], vr[ILP][VEC];
#pragma unroll
    for (int k = 0; k < ILP; ++k) {
      const long long i = start + (static_cast<long long>(k) * THREADS + threadIdx.x) * VEC;
      load_vec<T, VEC>(g + i, gr[k]);
      load_vec<T, VEC>(m + i, mr[k]);
      load_vec<T, VEC>(v + i, vr[k]);
    }
#pragma unroll
    for (int k = 0; k < ILP; ++k) {
      const long long i = start + (static_cast<long long>(k) * THREADS + threadIdx.x) * VEC;
      float ur[VEC], mw[VEC], vw[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float a = c1, b = c2;
        if (L.row) corrections<T>(c1p, c2p, i + j, L.row, a, b);
        adam_elem<T>(gr[k][j], mr[k][j], vr[k][j], a, b, s, ur[j], mw[j], vw[j]);
      }
      store_vec<T, VEC>(u + i, ur);
      store_vec<T, VEC>(mo + i, mw);
      store_vec<T, VEC>(vo + i, vw);
    }
    return;
  }
  // the leaf's last chunk, or an unaligned leaf: vectors while they fit,
  // then element by element
  long long i = start;
  if (vec) {
    const long long vend = start + (end - start) / VEC * VEC;
    for (long long k = start + static_cast<long long>(threadIdx.x) * VEC; k < vend;
         k += static_cast<long long>(THREADS) * VEC) {
      float gr[VEC], mr[VEC], vr[VEC], ur[VEC], mw[VEC], vw[VEC];
      load_vec<T, VEC>(g + k, gr);
      load_vec<T, VEC>(m + k, mr);
      load_vec<T, VEC>(v + k, vr);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float a = c1, b = c2;
        if (L.row) corrections<T>(c1p, c2p, k + j, L.row, a, b);
        adam_elem<T>(gr[j], mr[j], vr[j], a, b, s, ur[j], mw[j], vw[j]);
      }
      store_vec<T, VEC>(u + k, ur);
      store_vec<T, VEC>(mo + k, mw);
      store_vec<T, VEC>(vo + k, vw);
    }
    i = vend;
  }
  for (long long k = i + threadIdx.x; k < end; k += THREADS) {
    float a = c1, b = c2, ur, mw, vw;
    if (L.row) corrections<T>(c1p, c2p, k, L.row, a, b);
    adam_elem<T>(to_f(g[k]), to_f(m[k]), to_f(v[k]), a, b, s, ur, mw, vw);
    u[k] = from_f<T>(ur);
    mo[k] = from_f<T>(mw);
    vo[k] = from_f<T>(vw);
  }
}

__global__ void __launch_bounds__(THREADS)
dk_adam_update_kernel(const AdamTable t, const float* __restrict__ c1,
                      const float* __restrict__ c2, const AdamScalars s) {
  const AdamLeaf L = t.leaf[find_leaf(t)];
  const long long start = static_cast<long long>(blockIdx.x - L.first_block) * CHUNK;
  const long long end = start + CHUNK < L.n ? start + CHUNK : L.n;
  if (L.dtype == BF16) adam_chunk<__nv_bfloat16>(L, start, end, c1, c2, s);
  else adam_chunk<float>(L, start, end, c1, c2, s);
}

// -- apply_updates ------------------------------------------------------------

template <typename P, typename U>
__device__ void apply_chunk(const ApplyLeaf& L, long long start, long long end) {
  // 16 bytes of the narrower operand a vector
  constexpr int VEC = 16 / (sizeof(P) < sizeof(U) ? sizeof(P) : sizeof(U));
  constexpr int ILP = static_cast<int>(CHUNK / (THREADS * VEC));
  const P* p = static_cast<const P*>(L.p);
  const U* u = static_cast<const U*>(L.u);
  P* out = static_cast<P*>(L.out);
  const bool vec = aligned16(p) && aligned16(u) && aligned16(out);
  if (vec && end - start == CHUNK) {
    float pr[ILP][VEC], ur[ILP][VEC];
#pragma unroll
    for (int k = 0; k < ILP; ++k) {
      const long long i = start + (static_cast<long long>(k) * THREADS + threadIdx.x) * VEC;
      load_vec<P, VEC>(p + i, pr[k]);
      load_vec<U, VEC>(u + i, ur[k]);
    }
#pragma unroll
    for (int k = 0; k < ILP; ++k) {
      const long long i = start + (static_cast<long long>(k) * THREADS + threadIdx.x) * VEC;
      float o[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = __fadd_rn(pr[k][j], ur[k][j]);
      store_vec<P, VEC>(out + i, o);
    }
    return;
  }
  long long i = start;
  if (vec) {
    const long long vend = start + (end - start) / VEC * VEC;
    for (long long k = start + static_cast<long long>(threadIdx.x) * VEC; k < vend;
         k += static_cast<long long>(THREADS) * VEC) {
      float pr[VEC], ur[VEC], o[VEC];
      load_vec<P, VEC>(p + k, pr);
      load_vec<U, VEC>(u + k, ur);
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = __fadd_rn(pr[j], ur[j]);
      store_vec<P, VEC>(out + k, o);
    }
    i = vend;
  }
  for (long long k = i + threadIdx.x; k < end; k += THREADS)
    out[k] = from_f<P>(__fadd_rn(to_f(p[k]), to_f(u[k])));
}

__global__ void __launch_bounds__(THREADS) dk_apply_updates_kernel(const ApplyTable t) {
  const ApplyLeaf L = t.leaf[find_leaf(t)];
  const long long start = static_cast<long long>(blockIdx.x - L.first_block) * CHUNK;
  const long long end = start + CHUNK < L.n ? start + CHUNK : L.n;
  if (L.p_dtype == F32) {
    if (L.u_dtype == F32) apply_chunk<float, float>(L, start, end);
    else apply_chunk<float, __nv_bfloat16>(L, start, end);
  } else {
    if (L.u_dtype == F32) apply_chunk<__nv_bfloat16, float>(L, start, end);
    else apply_chunk<__nv_bfloat16, __nv_bfloat16>(L, start, end);
  }
}

}  // namespace

// `leaves` points at the table's rows on the host (the wrapper's numpy
// array); they are copied into the launch's parameters, so the host
// memory may go as soon as this returns.
extern "C" int dk_adam_update(const void* leaves, int n_leaves, int n_blocks, long long chunk,
                              const float* c1,
                              const float* c2, float b1, float one_minus_b1, float b2,
                              float one_minus_b2, float eps, float eps_root, float neg_lr,
                              void* stream) {
  if (n_leaves < 1 || n_leaves > ADAM_MAX_LEAVES || n_blocks < 1 || chunk != CHUNK)
    return static_cast<int>(cudaErrorInvalidValue);
  AdamTable t;
  t.n_leaves = n_leaves;
  std::memcpy(t.leaf, leaves, sizeof(AdamLeaf) * n_leaves);
  const AdamScalars s{b1, one_minus_b1, b2, one_minus_b2, eps, eps_root, neg_lr};
  dk_adam_update_kernel<<<n_blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(t, c1, c2,
                                                                                      s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dk_apply_updates(const void* leaves, int n_leaves, int n_blocks, long long chunk,
                                void* stream) {
  if (n_leaves < 1 || n_leaves > APPLY_MAX_LEAVES || n_blocks < 1 || chunk != CHUNK)
    return static_cast<int>(cudaErrorInvalidValue);
  ApplyTable t;
  t.n_leaves = n_leaves;
  std::memcpy(t.leaf, leaves, sizeof(ApplyLeaf) * n_leaves);
  dk_apply_updates_kernel<<<n_blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
