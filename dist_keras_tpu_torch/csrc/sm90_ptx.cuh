// PTX wrappers for Hopper's asynchronous pipeline (sm_90a): mbarriers,
// TMA tile loads, warpgroup matrix multiply (wgmma) and its shared-memory
// descriptors, register reallocation between warpgroups, and the
// register-level helpers around them; and for the warp-level tensor-core
// path: cp.async, ldmatrix and mma.sync.
//
// wgmma accumulator layout (m64nN, f32): warp w of the warpgroup holds
// rows 16w..16w+15; with g = lane / 4 and t = lane % 4, register 4j + e
// of a thread holds (row 16w + g + 8 * (e / 2), column 8j + 2t + e % 2).
// That is the mma.m16n8k16 C layout once per 8 columns, and pairs of it
// are the A layout of a register-sourced wgmma, so a score tile becomes
// the A operand of the next product without leaving the registers.
#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ uint32_t dk_smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers -------------------------------------------------------------
__device__ __forceinline__ void dk_mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA) and to
// the other threads; follow with a block barrier.
__device__ __forceinline__ void dk_mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void dk_mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void dk_mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait that
// outlasts any sane pipeline stall (a lost arrival or a byte count that
// never completes: ~2 s of clock, where a real wait takes microseconds)
// traps, so a fault fails the launch instead of hanging the card.
__device__ __forceinline__ void dk_mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

// -- TMA -------------------------------------------------------------------
// Load the box at coordinates (c0, c1, c2, c3) of a 4-D tensor map into
// shared memory; the bytes complete the transaction count of `bar`.
__device__ __forceinline__ void dk_tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                               uint32_t bar, int c0, int c1, int c2,
                                               int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// -- registers -------------------------------------------------------------
template <int N>
__device__ __forceinline__ void dk_setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void dk_setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Two f32 rounded to bf16 (nearest even) in one register, `lo` in the
// low half: the A-fragment order of two neighbouring columns.
__device__ __forceinline__ uint32_t dk_pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// -- wgmma -----------------------------------------------------------------
// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle (1 = 128 B, 2 = 64 B).
// K-major, swizzled: rows of `row bytes` at the swizzle width, SBO = the
// stride between groups of 8 rows, LBO unused.  MN-major, swizzled: LBO =
// the stride between blocks of one swizzle width along M/N, SBO = the
// stride between groups of 8 rows along K.
__device__ __forceinline__ uint64_t dk_gmma_desc(uint32_t addr, uint32_t lbo,
                                                 uint32_t sbo, uint32_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(swizzle) << 62);
}

__device__ __forceinline__ void dk_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void dk_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until every committed wgmma group of this warpgroup is complete.
__device__ __forceinline__ void dk_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin a register array at this point of the instruction stream: the
// compiler may not move its reads or writes across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void dk_fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// ... and for an A operand in registers, which an in-flight wgmma still
// reads: pinned after the wait, its registers stay untouched until then.
template <int M, int N>
__device__ __forceinline__ void dk_fence_regs(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// -- warp-level tensor cores: cp.async, ldmatrix, mma.sync ----------------
// Copy 16 bytes from global to shared memory asynchronously; with
// `valid` false the 16 bytes are filled with zeros and nothing is read.
__device__ __forceinline__ void dk_cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
// ... 4 bytes (zeros when not `valid`).
__device__ __forceinline__ void dk_cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void dk_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void dk_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i; register i of lane l holds row l / 4, columns
// 2 (l % 4) and 2 (l % 4) + 1 of matrix i (of its transpose with .trans).
__device__ __forceinline__ void dk_ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void dk_ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a * b, m16n8k16, bf16 operands, f32 accumulator.  With g = lane / 4
// and t = lane % 4: a[0] holds A (g, 2t..2t+1), a[1] (g + 8, 2t..), a[2]
// (g, 2t + 8..), a[3] (g + 8, 2t + 8..); b0 holds B (2t..2t+1, g), b1
// (2t + 8.., g); d[e] holds D (g + 8 (e / 2), 2t + e % 2).
__device__ __forceinline__ void dk_mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo for split-TF32 products: hi is x rounded to TF32 (to
// nearest, ties away: half a TF32 ulp added to the bit pattern, the 13
// low bits cleared) and lo = x - hi, exact in f32, is handed to the mma
// as it is, whose TF32 operand keeps the top 19 bits (10 of the mantissa):
// hi + tf32(lo) is x to about 2^-21, so three products hi*hi + hi*lo +
// lo*hi carry an f32 product to within a few f32 ulps.
__device__ __forceinline__ void dk_split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a * b, m16n8k8, tf32 operands, f32 accumulator.  With g = lane / 4
// and t = lane % 4: a[0] holds A (g, t), a[1] (g + 8, t), a[2] (g, t + 4),
// a[3] (g + 8, t + 4); b0 holds B (t, g), b1 (t + 4, g); d[e] holds D
// (g + 8 (e / 2), 2t + e % 2).
__device__ __forceinline__ void dk_mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The four values of x split into TF32 hi and lo parts (dk_split_tf32).
__device__ __forceinline__ void dk_split4_tf32(float4 x, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  dk_split_tf32(x.x, hi[0], lo[0]);
  dk_split_tf32(x.y, hi[1], lo[1]);
  dk_split_tf32(x.z, hi[2], lo[2]);
  dk_split_tf32(x.w, hi[3], lo[3]);
}

// d += a b to f32 precision on split operands (a = ah + al, b = bh + bl):
// lo*hi, hi*lo, then hi*hi, into one f32 accumulator.
__device__ __forceinline__ void dk_mma3_tf32(float (&d)[4], const uint32_t (&ah)[4],
                                             const uint32_t (&al)[4], uint32_t bh0,
                                             uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  dk_mma_tf32(d, al, bh0, bh1);
  dk_mma_tf32(d, ah, bl0, bl1);
  dk_mma_tf32(d, ah, bh0, bh1);
}

// A load with acquire semantics at GPU scope: what the releasing thread
// wrote before its release is visible after it.
__device__ __forceinline__ int dk_ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// *p += v with release semantics at GPU scope: what this thread wrote, or
// saw written (cumulativity, e.g. its block's writes before a barrier),
// is visible to a thread whose acquire reads the new value.
__device__ __forceinline__ void dk_red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// 2^x on the special-function unit (results below 2^-126 flush to 0).
__device__ __forceinline__ float dk_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += a * b: A (64 x 16) and B (16 x 128) both K-major in shared memory.
__device__ __forceinline__ void dk_wgmma_m64n128k16_ss(float (&d)[64], uint64_t a,
                                                     uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// d += a * b: A (64 x 16) from registers (the mma.m16n8k16 A layout,
// warp w holding rows 16w..16w+15), B (16 x 128) MN-major in shared memory.
__device__ __forceinline__ void dk_wgmma_m64n128k16_rs(float (&d)[64],
                                                     const uint32_t (&a)[4],
                                                     uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a * b: A (64 x 16) from registers (the mma.m16n8k16 A layout,
// warp w holding rows 16w..16w+15), B (16 x 64) MN-major in shared memory.
__device__ __forceinline__ void dk_wgmma_m64n64k16_rs(float (&d)[32],
                                                     const uint32_t (&a)[4],
                                                     uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a * b: A (64 x 16) from registers (the mma.m16n8k16 A layout,
// warp w holding rows 16w..16w+15), B (16 x 32) MN-major in shared memory.
__device__ __forceinline__ void dk_wgmma_m64n32k16_rs(float (&d)[16],
                                                     const uint32_t (&a)[4],
                                                     uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
