// Hopper (sm_90a) building blocks shared by the port's hand-written kernels:
// mbarriers, TMA tile loads, cp.async, warpgroup matrix products (wgmma)
// and warp-level ones (mma.sync, ldmatrix) on bf16 operands with f32
// accumulators.
//
// Shared-memory operand layout. Every wgmma operand here lives in shared
// memory without swizzle, as "core matrices" of 8 rows x 16 bytes (8 bf16),
// each stored as 128 contiguous bytes. A tile of R rows x C columns (C a
// multiple of 8) is kept as C/8 column groups, group c at byte c*R*16, row r
// of a group at byte r*16: what one TMA load of an (8 column x R row) box
// writes. For such a tile:
//  - read K-major (the reduction dim along the 16-byte rows: Q and K in
//    S = Q·Kᵀ), the next core matrix along the reduction dim is the next
//    column group (leading byte offset R*16) and the next 8 rows are 128
//    bytes on (stride byte offset 128);
//  - read MN-major (V in O = P·V: the reduction runs over V's rows, the keys;
//    w in the grouped GEMM: over its D rows),
//    the next 8 keys are 128 bytes on (leading byte offset 128) and the next
//    8 output columns are the next column group (stride byte offset R*16).
// With the 128-byte swizzle a tile is kept as 64-column regions of R rows x
// 128 bytes (one TMA box each, region c at byte c*R*128). K-major: the next
// 8 rows are 1024 bytes on (stride byte offset), and k-step j of a region
// starts 32*j bytes into its rows. MN-major: the next 8 keys are 1024
// bytes on (stride byte offset), the next 64 columns the next region
// (leading byte offset R*128).
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
// arrive and expect `bytes` of asynchronous (TMA) writes before the phase ends
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ---- TMA: one (box) tile of a 4-D tensor map into shared memory ----
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// the same with an L2 cache policy (`l2_evict_last`)
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%3, %4, %5, %6}], [%2], %7;" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "l"(policy)
      : "memory");
}
// an L2 policy under which the lines a load brings are evicted last: for
// small data read again while a large stream passes through L2
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// ---- TMA stores: shared memory to a tile of a tensor map ----
// make this thread's shared-memory writes visible to TMA (the async proxy)
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// one box of a 4-D map from shared memory; rows and columns past the
// tensor's extent are not written
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::
          "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
// add `bytes` (a multiple of 16) of f32 from shared memory into device
// memory, elementwise (both addresses 16-byte aligned); committed like a store
__device__ __forceinline__ void bulk_reduce_add_f32(float* dst, const float* src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;" ::"l"(
                   dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// this thread's committed stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// and have written device memory
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
// a barrier of `threads` threads (a multiple of 32) under id 1..15
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// ---- flags between blocks of one launch (device scope) ----
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// ---- cp.async: 16 bytes, zero-filled when `valid` is false ----
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ---- wgmma ----
// descriptor of a no-swizzle operand (layout type 0) starting at `p`
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}
// descriptor of an operand in the 128-byte swizzle (layout type 1), as a
// TMA box of 64 bf16 columns with CU_TENSOR_MAP_SWIZZLE_128B writes it: the
// atom of 8 rows x 128 bytes must start 1024-byte aligned; `p` may point
// 32, 64 or 96 bytes into a row (a K-major k-step)
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  return wgmma_desc(p, lbo, sbo) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 2^x by the special-function unit (relative error ~2^-22; 2^-1e30 = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- mma.sync (sm_80 and up) ----
// D (16 x 8, f32) += A (16 x 16, bf16, rows 8..15 zero) * B (16 x 8, bf16):
// a0, a2 hold A's rows 0..7 (columns 2q, 2q+1 and 8+2q, 9+2q of lane 4g+q's
// row g), b0, b1 B's column g (rows 2q, 2q+1 and 8+2q, 9+2q); d0, d1 are
// row g, columns 2q, 2q+1. The zero rows' results are not kept: they take
// scratch outputs (added to a zero C) that die at once, so no register
// holds them across products.
__device__ __forceinline__ void mma_16816_top(float (&d)[2], uint32_t a0, uint32_t a2,
                                              uint32_t b0, uint32_t b1) {
  float z0, z1;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %10, %10};"
      : "+f"(d[0]), "+f"(d[1]), "=f"(z0), "=f"(z1)
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1), "f"(0.f));
}
// D (16 x 8, f32) += A (16 x 16, bf16) * B (16 x 8, bf16): a0..a3 are A's
// fragments (rows g and g+8, columns 2q, 2q+1 and 8+2q, 9+2q of lane
// 4g+q), b0, b1 B's column g (rows 2q, 2q+1 and 8+2q, 9+2q); d0, d1 are row
// g, d2, d3 row g+8, columns 2q, 2q+1
__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices from shared memory, transposed: lanes 8i..8i+7 give
// the row addresses of matrix i (a shared-memory address), whose fragment
// lands in r[i]
__device__ __forceinline__ void ldmatrix_x4_trans_at(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  ldmatrix_x4_trans_at(r, smem_u32(row));
}

// two floats as one bf16x2 register (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (64 x N, f32) (+)= A (64 x 16) * B (16 x N), bf16 operands; accumulate
// = 0 overwrites D. wgmma_ss: both operands in shared memory, TA / TB = 0
// read K-major (Q and K in S = Q.K^T), 1 MN-major (as desc_mn_major
// describes: V in O = P.V, buf^T in the grouped GEMM's dW). wgmma_rs: A
// from registers in the mma.sync A fragment layout (warp w of the
// warpgroup holding rows 16w..16w+15), B MN-major unless TB = 0.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_m64n16(float (&d)[8], uint64_t desc_a,
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}"
      ", %8, %9, p, 1, 1, %11, %12;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB)
      : "memory");
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_m64n32(float (&d)[16], uint64_t desc_a,
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}"
      ", %16, %17, p, 1, 1, %19, %20;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB)
      : "memory");
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t desc_a,
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}"
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB)
      : "memory");
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t desc_a,
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}"
      ", %64, %65, p, 1, 1, %67, %68;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
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
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB)
      : "memory");
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_m64n160(float (&d)[80], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79"
      "}"
      ", %80, %81, p, 1, 1, %83, %84;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB)
      : "memory");
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_m64n256(float (&d)[128], uint64_t desc_a,
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}"
      ", %128, %129, p, 1, 1, %131, %132;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB)
      : "memory");
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_m64n16(float (&d)[8], const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}"
      ", {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(TB)
      : "memory");
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_m64n32(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(TB)
      : "memory");
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(TB)
      : "memory");
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_m64n80(float (&d)[40], const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}"
      ", {%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(TB)
      : "memory");
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_m64n96(float (&d)[48], const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}"
      ", {%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(TB)
      : "memory");
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(TB)
      : "memory");
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_m64n256(float (&d)[128], const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}"
      ", {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(TB)
      : "memory");
}

template <int N, int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  if constexpr (N == 16) wgmma_ss_m64n16<TA, TB>(d, desc_a, desc_b, accumulate);
  else if constexpr (N == 32) wgmma_ss_m64n32<TA, TB>(d, desc_a, desc_b, accumulate);
  else if constexpr (N == 64) wgmma_ss_m64n64<TA, TB>(d, desc_a, desc_b, accumulate);
  else if constexpr (N == 128) wgmma_ss_m64n128<TA, TB>(d, desc_a, desc_b, accumulate);
  else if constexpr (N == 160) wgmma_ss_m64n160<TA, TB>(d, desc_a, desc_b, accumulate);
  else {
    static_assert(N == 256, "wgmma_ss: N is one of 16, 32, 64, 128, 160, 256");
    wgmma_ss_m64n256<TA, TB>(d, desc_a, desc_b, accumulate);
  }
}

template <int N, int TB = 1>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  if constexpr (N == 16) wgmma_rs_m64n16<TB>(d, a, desc_b, accumulate);
  else if constexpr (N == 32) wgmma_rs_m64n32<TB>(d, a, desc_b, accumulate);
  else if constexpr (N == 64) wgmma_rs_m64n64<TB>(d, a, desc_b, accumulate);
  else if constexpr (N == 80) wgmma_rs_m64n80<TB>(d, a, desc_b, accumulate);
  else if constexpr (N == 96) wgmma_rs_m64n96<TB>(d, a, desc_b, accumulate);
  else if constexpr (N == 128) wgmma_rs_m64n128<TB>(d, a, desc_b, accumulate);
  else {
    static_assert(N == 256, "wgmma_rs: N is one of 16, 32, 64, 80, 96, 128, 256");
    wgmma_rs_m64n256<TB>(d, a, desc_b, accumulate);
  }
}

// a 64 x 64 f32 accumulator (P or dS) as the bf16 A fragments of four
// k-steps: for columns 16*kk.., the accumulator's registers 8*kk .. 8*kk + 7
// are the fragment's, in order
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

// four 8x8 b16 matrices into shared memory, transposed: r[i] is this lane's
// fragment of matrix i (row lane/4, columns 2(lane%4), +1: the mma.sync and
// wgmma accumulator layout); lanes 8i..8i+7 give the addresses (16 bytes
// each) of matrix i's destination rows, its columns 0..7
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, uint32_t r0, uint32_t r1,
                                                  uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// four 8x8 b16 matrices from shared memory, as stored: lanes 8i..8i+7 give
// the row addresses of matrix i, whose fragment lands in r[i]
__device__ __forceinline__ void ldmatrix_x4_at(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// the start of dynamic shared memory, 1024-byte aligned for the 128-byte
// swizzle pattern where the tiles use it
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw, bool swizzle) {
  return swizzle ? raw + ((1024 - (smem_u32(raw) & 1023)) & 1023) : raw;
}

// ---- (rows x D) bf16 tiles written by TMA, read by wgmma ----
// D a multiple of 64 (64, 128, 256) takes the 128-byte swizzle: one TMA box
// of 64 columns (128-byte rows) per 64-column region. D = 32, 80 and 96,
// whose 64-, 160- and 192-byte rows a 128-byte swizzle span does not fit,
// take no swizzle: 8-column groups, one 16-byte-wide TMA box each.
template <int D>
struct Tile {
  static constexpr bool kSwizzle = D % 64 == 0;
  static constexpr int kBoxCols = kSwizzle ? 64 : 8;
};

// descriptor of k-step kk (16 columns) of a K-major operand of `rows` rows
// at `base` (a warpgroup's 64 rows: base offset by its first row times the
// box width)
template <int D>
__device__ __forceinline__ uint64_t desc_k_major(const __nv_bfloat16* base, int rows, int kk) {
  if constexpr (Tile<D>::kSwizzle)   // region kk/4, 32 bytes a k-step inside its 128-byte rows
    return wgmma_desc_sw128(base + (kk / 4) * rows * 64 + (kk % 4) * 16, 16, 1024);
  else
    return wgmma_desc(base + kk * 2 * rows * 8, rows * 16, 128);
}

// descriptor of k-step kk (rows 16*kk ..) of a tile of `rows` rows read
// MN-major: the reduction runs over its rows (V in P·V, K in dS·K, Q and
// dO in dSᵀ·Q and Pᵀ·dO), N over its columns
template <int D>
__device__ __forceinline__ uint64_t desc_mn_major(const __nv_bfloat16* base, int rows, int kk) {
  if constexpr (Tile<D>::kSwizzle)   // 64-column regions rows*128 bytes apart, 8 rows 1024
    return wgmma_desc_sw128(base + kk * 16 * 64, rows * 128, 1024);
  else
    return wgmma_desc(base + kk * 16 * 8, 128, rows * 16);
}

// ---- errors the C entry points report (host) ----
// This thread's note on the error an entry point last returned: which
// check, tensor map or launch failed, and libcuda's or the runtime's reason.
// errors.cu's repro_last_error_note hands it to the Python wrapper
// (build.check), which adds it to the error it raises.
inline char* error_note() {
  static thread_local char note[640];
  return note;
}
template <typename... Args>
inline void note(const char* fmt, Args... args) {
  snprintf(error_note(), 640, fmt, args...);
}
// a refused call: cudaErrorInvalidValue, with `why` noted
inline cudaError_t refuse(const char* why) {
  note("%s", why);
  return cudaErrorInvalidValue;
}

// Ready the calling thread for `kernel`'s launch. On a thread's first
// launch the current device's primary context is made current:
// cuTensorMapEncodeTiled refuses every map on a thread with no current
// context, which is what a thread that has made no CUDA call yet has
// (autograd's device thread running a backward whose first CUDA work is
// this launch: its outputs come from the caching allocator, which makes no
// call). Once a context is current, a change of device goes through
// cudaSetDevice, which makes that device's current, so once a thread is
// enough. Then, at every launch, an error that an earlier runtime call
// left pending on this thread is returned as such, so that the launch's
// own check does not report it as the launch's.
inline cudaError_t begin(const char* kernel) {
  static thread_local bool has_context = false;
  cudaError_t err;
  if (!has_context) {
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) || (err = cudaSetDevice(dev))) {
      note("%s: no CUDA device for the calling thread (%s)", kernel, cudaGetErrorString(err));
      return err;
    }
    has_context = true;
  }
  if ((err = cudaGetLastError()))
    note("%s: an earlier CUDA call on this thread had failed (%s); the kernel was not launched",
         kernel, cudaGetErrorString(err));
  return err;
}

// the number of SMs of the current device
inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) ||
      (err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)))
    note("cudaDeviceGetAttribute(SM count): %s", cudaGetErrorString(err));
  return err;
}

template <typename T>
struct same { using type = T; };

// opt `kernel` into `smem` bytes of dynamic shared memory where that is
// more than 48 KB; a launch site keeps the result in a static, so that a
// kernel is opted in once a process
template <typename Kernel>
inline cudaError_t opt_in(Kernel kernel, int smem) {
  return smem > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
             : cudaSuccess;
}

// Launch `kernel` (named `name` in the error note) on `stream` with `smem`
// bytes of dynamic shared memory, `opted` its opt_in's result; the
// arguments are converted to the kernel's own parameter types. The caller
// has called begin() (before making its tensor maps). → the opt-in's or
// the launch's error.
template <typename... Params>
cudaError_t launch(const char* name, void (*kernel)(Params...), cudaError_t opted, dim3 grid,
                   dim3 block, int smem, cudaStream_t stream,
                   typename same<Params>::type... args) {
  if (opted) {
    note("%s: cudaFuncSetAttribute(%d bytes of dynamic shared memory): %s", name, smem,
         cudaGetErrorString(opted));
    return opted;
  }
  void* argv[] = {static_cast<void*>(&args)..., nullptr};
  const cudaError_t err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), grid, block,
                                           argv, static_cast<size_t>(smem), stream);
  if (err)
    note("%s: launch of (%u, %u, %u) blocks of (%u, %u, %u) threads with %d bytes of shared "
         "memory refused: %s", name, grid.x, grid.y, grid.z, block.x, block.y, block.z, smem,
         cudaGetErrorString(err));
  return err;
}

// ---- TMA tensor maps (host) ----
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, found once through the runtime
// (the library is not linked against libcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A 4-D map of a bf16 (B, rows, H, D) view with D contiguous: dim 0 is D,
// dims 1..3 the (rows, head, batch) dims sorted by stride (a dim of extent 1
// takes the largest), so the strides grow as TMA expects. The box is
// box_cols columns x box_rows rows, in the 128-byte swizzle when box_cols
// is 64. pos[i] says which dim holds rows, head, batch. L2 fetches a load's
// lines in 128-byte units, or 256-byte ones with `l2_256`. A refusal is
// noted with `what` (the operand), libcuda's CUresult and the map.
inline cudaError_t make_map(CUtensorMap* map, const char* what, const void* base, int D,
                            const long long (&ext)[3], const long long (&stride)[3],
                            int box_cols, int box_rows, int (&pos)[3], bool l2_256 = false) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) {
    note("tensor map of %s: cuTensorMapEncodeTiled not found in libcuda", what);
    return cudaErrorNotSupported;
  }
  long long span = 2LL * D;
  for (int i = 0; i < 3; ++i)
    if (ext[i] > 1) span = span > 2 * stride[i] * ext[i] ? span : 2 * stride[i] * ext[i];
  long long bytes[3];
  int order[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i) bytes[i] = ext[i] > 1 ? 2 * stride[i] : span;
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && bytes[order[j]] < bytes[order[j - 1]]; --j) {
      const int t = order[j];
      order[j] = order[j - 1];
      order[j - 1] = t;
    }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), 1, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  for (int j = 0; j < 3; ++j) {
    dims[j + 1] = static_cast<cuuint64_t>(ext[order[j]]);
    strides[j] = static_cast<cuuint64_t>(bytes[order[j]]);
    pos[order[j]] = j + 1;
  }
  box[pos[0]] = static_cast<cuuint32_t>(box_rows);
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                           : CU_TENSOR_MAP_SWIZZLE_NONE,
                            l2_256 ? CU_TENSOR_MAP_L2_PROMOTION_L2_256B
                                   : CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r == CUDA_SUCCESS) return cudaSuccess;
  note("tensor map of %s refused by cuTensorMapEncodeTiled: CUresult %d; base %p, dims "
       "(%llu, %llu, %llu, %llu), strides (%llu, %llu, %llu) bytes, box (%u, %u, %u, %u)",
       what, static_cast<int>(r), base, static_cast<unsigned long long>(dims[0]),
       static_cast<unsigned long long>(dims[1]), static_cast<unsigned long long>(dims[2]),
       static_cast<unsigned long long>(dims[3]), static_cast<unsigned long long>(strides[0]),
       static_cast<unsigned long long>(strides[1]), static_cast<unsigned long long>(strides[2]),
       box[0], box[1], box[2], box[3]);
  return cudaErrorInvalidValue;
}

// one box (box columns x box rows) at (col, row, head, b) of a map made by
// make_map, whose pos says which of its dims holds rows, head and batch
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         const int (&pos)[3], int col, int row, int head,
                                         int b) {
  auto at = [&](int dim) { return pos[0] == dim ? row : pos[1] == dim ? head : b; };
  tma_load_4d(dst, map, bar, col, at(1), at(2), at(3));
}

// the same with an L2 cache policy
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         const int (&pos)[3], int col, int row, int head,
                                         int b, uint64_t policy) {
  auto at = [&](int dim) { return pos[0] == dim ? row : pos[1] == dim ? head : b; };
  tma_load_4d(dst, map, bar, col, at(1), at(2), at(3), policy);
}

// one box at (col, row, head, b) of shared memory into a map made by make_map
__device__ __forceinline__ void store_box(const CUtensorMap* map, const void* src,
                                          const int (&pos)[3], int col, int row, int head,
                                          int b) {
  auto at = [&](int dim) { return pos[0] == dim ? row : pos[1] == dim ? head : b; };
  tma_store_4d(map, src, col, at(1), at(2), at(3));
}

}  // namespace hopper
