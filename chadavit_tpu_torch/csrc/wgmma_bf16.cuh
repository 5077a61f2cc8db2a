// Hopper (sm_90a) building blocks for the port's wgmma kernels
// (linear_wgmma_bf16.cu, and the head-64 attention backward of
// prefix_attention_bf16.cu): TMA tile loads into shared memory that complete
// on an mbarrier, the mbarrier ring between one producer warp and the
// consumer warpgroups, and warpgroup matrix products (wgmma.mma_async, bf16
// in, f32 sums) read from shared memory through descriptors of the 128-byte
// swizzle, or with A from registers.
//
// Shared-memory tiles are what a TMA box of 64 bf16 (128 bytes) a row and
// CU_TENSOR_MAP_SWIZZLE_128B writes: rows of 128 bytes, the 16-byte chunk c
// of row r stored at chunk c ^ (r % 8), in atoms of 8 rows (1024 bytes), so
// every tile starts on a 1024-byte boundary. A wgmma operand reads such a
// tile in one of two orders (PTX ISA, "matrix descriptor"; CUTLASS's
// make_gmma_desc):
//
// - K-major (transpose bit 0): a row is 64 K values of one M (or N) index;
//   SBO is the step from one 8-row atom to the next along M (1024 bytes for
//   packed rows); a k16 step moves the start 32 bytes along the row.
// - MN-major (transpose bit 1): a row is 64 M (or N) values of one K index;
//   SBO is the step from one 8-row group along K to the next (1024 bytes),
//   LBO the step from one 64-wide MN atom to the next; a k16 step moves the
//   start 16 rows (2048 bytes).
//
// The wgmma accumulator of m64nNk16 lies as mma.sync's m16n8 C fragments:
// warp q of the warpgroup owns rows 16 q .. 16 q + 15; lane l (g = l / 4,
// t = l % 4) holds d[4 j + 0..1] at row 16 q + g, columns 8 j + 2 t, + 1,
// and d[4 j + 2..3] at row 16 q + g + 8, the same columns. An A operand from
// registers (the RS form) lies per warp as mma.sync m16n8k16's A fragment of
// the warp's 16 rows: a[0] (row g, k 2 t, + 1), a[1] (row g + 8, the same k),
// a[2] (row g, k 2 t + 8, + 9), a[3] (row g + 8, those k). So the sums of
// two adjacent n8 blocks 2 kk and 2 kk + 1, rounded to bf16 and packed in
// pairs (a_from_acc), are the A operand of the k16 step kk of a product that
// contracts over the accumulator's columns: a tile of scores feeds the next
// product without leaving the registers.
//
// The tensor maps are built on the host by cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint, so the library links no libcuda, and are
// passed to the kernels as __grid_constant__ parameters. Each including file
// gets its own copy (anonymous namespace).
//
// Diagnostic builds (scripts/bench_wgmma_bf16.py --builds; they compute
// nothing meaningful, only their times are read): -DWGMMA_NO_LOAD makes the
// TMA loads nothing and the producer's arrival a plain one, -DWGMMA_NO_MMA
// makes the products nothing.

#pragma once

#include <cuda.h>

#include "storage.cuh"

namespace {
namespace wg {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// makes the initialised barriers visible to the async proxy (TMA); then a
// __syncthreads makes them visible to the block
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also expects `bytes` of TMA transactions in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
#ifdef WGMMA_NO_LOAD
  bytes = 0;
#endif
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// waits until the phase of parity `parity` has completed: on a fresh barrier
// parity 1 passes at once (the producer's first pass over an empty ring) and
// parity 0 waits for the first completion. A wait past 2^36 cycles (about 35
// s) traps, so that an arrival that never comes ends the launch with an error
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 36)) __trap();
  } while (!done);
}

// the warpgroup's registers a thread: fewer for the producer's, more for the
// consumers' (sm_90a; every warp of the warpgroup executes it, on a path that
// does not join the other warpgroups' again)
template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// named barrier `id` (1..15; 0 is __syncthreads) over `threads` threads
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// arrives at named barrier `id` without waiting: with a bar_sync of the
// same count, one warpgroup hands the other its turn
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- TMA ------------------------------------------------------------------
// `bytes` (a multiple of 16) from global memory at src (16-byte aligned) into
// shared memory at dst, counted on bar's transactions (a bulk copy: no tensor
// map, no swizzle)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
#ifdef WGMMA_NO_LOAD
  return;
#endif
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// the box of `map` at (c0 inner, c1 outer) into shared memory at dst, counted
// on bar's transactions; boxes past the tensor's edge are filled with zeros
// (and still count their full size)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
#ifdef WGMMA_NO_LOAD
  return;
#endif
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
// orders this thread's generic-proxy writes to shared memory before later
// async-proxy reads of it (wgmma operands written by plain stores)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- wgmma ----------------------------------------------------------------
// descriptor of a shared-memory operand in the 128-byte swizzle (layout type
// 1, base offset 0: every tile starts on a 1024-byte boundary)
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}
// descriptor of an operand without swizzle (core matrices of 8 rows of 16
// bytes): the column of ones that turns a product into a column sum
__device__ __forceinline__ uint64_t desc_plain(const void* p, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32);
}
// the descriptors of the k16 step kk of a 64 x 64 tile in the 128-byte
// swizzle (one TMA box: 64 rows of 64 bf16): read K-major, a row is 64 K
// values of one M or N index (the step moves 32 bytes along the rows); read
// MN-major (the transposed B), a row is 64 N values of one K index (the step
// moves 16 rows; one 64-wide atom, so LBO is never stepped)
__device__ __forceinline__ uint64_t desc_k64(const void* tile, int kk) {
  return desc_sw128(static_cast<const unsigned char*>(tile) + 32 * kk, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mn64(const void* tile, int kk) {
  return desc_sw128(static_cast<const unsigned char*>(tile) + 2048 * kk, 8192, 1024);
}
// orders register accesses of the accumulators before the wgmma that follow
__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of r across the asynchronous products
template <int R>
__device__ __forceinline__ void fence_operand(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// and of an A operand in registers: its values stay where the asynchronous
// products read them until the wait that follows this fence
template <int R, int C>
__device__ __forceinline__ void fence_operand(uint32_t (&r)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (+)= a b, 64 x 256 x 16: a and b shared-memory descriptors, TA / TB their
// transpose bits (0 K-major, 1 MN-major); scale_d 0 drops d's old value
template <int TA, int TB>
__device__ __forceinline__ void mma_m64n256k16(float (&d)[128], uint64_t a, uint64_t b,
                                               int scale_d) {
#ifdef WGMMA_NO_MMA
  return;
#endif
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}
// d (+)= a b, 64 x 192 x 16 (the accumulator as m64n256k16's first 96 registers)
template <int TA, int TB>
__device__ __forceinline__ void mma_m64n192k16(float (&d)[96], uint64_t a, uint64_t b,
                                               int scale_d) {
#ifdef WGMMA_NO_MMA
  return;
#endif
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}
// d (+)= a b, 64 x N x 16 for N 192 or 256
template <int N, int TA, int TB>
__device__ __forceinline__ void mma_m64k16(float (&d)[N / 2], uint64_t a, uint64_t b,
                                           int scale_d) {
  static_assert(N == 192 || N == 256, "m64n192k16 or m64n256k16");
  if constexpr (N == 256) mma_m64n256k16<TA, TB>(d, a, b, scale_d);
  else mma_m64n192k16<TA, TB>(d, a, b, scale_d);
}
// d (+)= a b, 64 x 64 x 16, a and b shared-memory descriptors
template <int TA, int TB>
__device__ __forceinline__ void mma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b,
                                              int scale_d) {
#ifdef WGMMA_NO_MMA
  return;
#endif
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}
// d (+)= a b, 64 x 64 x 16, a in registers (the RS form: a warp's A fragment
// of its 16 rows, as the header's notes lay it out), b a shared-memory
// descriptor with transpose bit TB
template <int TB>
__device__ __forceinline__ void mma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t b, int scale_d) {
#ifdef WGMMA_NO_MMA
  return;
#endif
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
}
// the A operand of the k16 step kk from the sums of a m64n64 (or wider)
// accumulator, n8 blocks 2 kk and 2 kk + 1, each pair rounded to bf16
template <int R>
__device__ __forceinline__ void a_from_acc(uint32_t (&a)[4], const float (&d)[R], int kk) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
    a[i] = *reinterpret_cast<const uint32_t*>(&v);
  }
}
// d (+)= a b, 64 x 8 x 16
template <int TA, int TB>
__device__ __forceinline__ void mma_m64n8k16(float (&d)[4], uint64_t a, uint64_t b, int scale_d) {
#ifdef WGMMA_NO_MMA
  return;
#endif
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, %4, %5, p, 1, 1, "
      "%7, %8;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// ---- host: tensor maps ------------------------------------------------------
// A 2D bf16 tensor map over a row-major (rows, inner) tensor with rows
// `row_bytes` apart, boxes of (box_inner, box_rows) in the 128-byte swizzle
// (box_inner 64: a box row is 128 bytes). Returns 0 or a cudaError.
inline int make_map_2d(CUtensorMap* map, const void* base, uint64_t inner, uint64_t rows,
                       uint64_t row_bytes, uint32_t box_inner, uint32_t box_rows) {
  using Encode = decltype(&cuTensorMapEncodeTiled);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return (int)e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {inner, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace wg
}  // namespace
