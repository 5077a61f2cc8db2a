// Tensor-core building blocks for the port's bf16 kernels on Hopper (sm_90a):
// warp-level mma.sync m16n8k16 (bf16 x bf16, f32 sums), ldmatrix from
// shared memory (plain and transposed), cp.async 16-byte copies with commit
// groups, and the XOR swizzle that keeps both free of bank conflicts.
//
// Fragment layouts of mma.m16n8k16.row.col (lane l, g = l / 4, t = l % 4):
//   A 16 x 16:  a0 (row g,     k 2t..2t+1)   a1 (row g + 8, k 2t..2t+1)
//               a2 (row g,     k 2t+8..+9)   a3 (row g + 8, k 2t+8..+9)
//   B 16 x 8:   b0 (k 2t..2t+1, col g)       b1 (k 2t+8..+9, col g)
//   C 16 x 8:   c0, c1 (row g, cols 2t, 2t+1)  c2, c3 (row g + 8, same cols)
// ldmatrix .x4 loads four 8 x 8 matrices; lanes 8q..8q+7 give the row
// addresses of matrix q, and register q of every lane receives its part of
// matrix q: the A fragment of a row-major tile (rows, k) or the B fragment of
// a tile stored (cols, k), or with .trans the B fragment of a tile stored
// (k, cols) or the A fragment of a tile stored (k, rows). The ldsm_* helpers below take the tile's top-left element and
// compute each lane's row address themselves.
//
// Shared-memory tiles are row-major with WIDTH bf16 a row, WIDTH a multiple of
// 64 (128 bytes): the 16-byte chunk c of row r is stored at chunk
// c ^ (r % 8) inside its group of eight. Eight rows read at one logical chunk
// (an ldmatrix matrix) then hit eight different chunks, all 32 banks, and a
// warp's 16-byte copies of consecutive chunks stay conflict-free too.
// A row of an odd multiple of 32 bf16 (the attention's heads of 96 and 32: 12
// and 4 chunks)
// starts 4 chunks further along the 8 chunks of a 128-byte line than the row
// before it, so rows r and r + 2 share their chunks' banks; there chunk c is
// stored at c ^ ((r / 2) % 4), inside its aligned group of four (so it stays
// inside the row): the line offset 4 (r % 2) and the XOR (r / 2) % 4 together
// give eight rows eight different chunks of the line, and groups of four
// consecutive chunks stay whole for the copies.

#pragma once

#include "storage.cuh"

namespace {

// element offset of (row, col) in a swizzled tile of WIDTH bf16 a row
template <int WIDTH>
__device__ __forceinline__ int swz(int row, int col) {
  static_assert(WIDTH % 32 == 0, "swizzled rows are multiples of 64 bytes");
  if constexpr (WIDTH % 64 == 0)
    return row * WIDTH + ((((col >> 3) ^ row) & 7) | ((col >> 3) & ~7)) * 8 + (col & 7);
  else
    return row * WIDTH + ((col >> 3) ^ ((row >> 1) & 3)) * 8 + (col & 7);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one 16-byte copy from global to shared memory, bypassing L1
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are still in flight;
// the thread then sees its own copies (the clobber keeps its later reads of
// shared memory after the wait)
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The A fragment of the 16 x 16 block at (row0, k0) of a row-major (rows, k)
// tile of WIDTH columns.
template <int WIDTH>
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const bf16* tile, int row0, int k0) {
  const int lane = threadIdx.x & 31, q = lane >> 3;
  ldsm_x4(a, tile + swz<WIDTH>(row0 + (q & 1) * 8 + (lane & 7), k0 + (q >> 1) * 8));
}
// The A fragment of the 16 x 16 block (rows row0.., k k0..) of a tile stored
// transposed, (k, rows), WIDTH columns: the contraction runs down the tile.
template <int WIDTH>
__device__ __forceinline__ void ldsm_a_t(uint32_t (&a)[4], const bf16* tile, int row0, int k0) {
  const int lane = threadIdx.x & 31, q = lane >> 3;
  ldsm_x4_t(a, tile + swz<WIDTH>(k0 + (q >> 1) * 8 + (lane & 7), row0 + (q & 1) * 8));
}
// The B fragments of two n8 blocks, columns col0..col0+15 and k k0..k0+15, of
// a tile stored (cols, k), WIDTH columns (each row a column of B, as K's rows
// are in Q K^T): {b[0], b[1]} for columns col0..+7, {b[2], b[3]} for
// col0+8..+15.
template <int WIDTH>
__device__ __forceinline__ void ldsm_b(uint32_t (&b)[4], const bf16* tile, int k0, int col0) {
  const int lane = threadIdx.x & 31, q = lane >> 3;
  ldsm_x4(b, tile + swz<WIDTH>(col0 + (q >> 1) * 8 + (lane & 7), k0 + (q & 1) * 8));
}
// The B fragments of two n8 blocks, columns col0..col0+15 and k k0..k0+15, of
// a tile stored (k, cols), WIDTH columns: {b[0], b[1]} for columns col0..+7,
// {b[2], b[3]} for col0+8..+15.
template <int WIDTH>
__device__ __forceinline__ void ldsm_b_t(uint32_t (&b)[4], const bf16* tile, int k0, int col0) {
  const int lane = threadIdx.x & 31, q = lane >> 3;
  ldsm_x4_t(b, tile + swz<WIDTH>(k0 + (q & 1) * 8 + (lane & 7), col0 + (q >> 1) * 8));
}

// c += a b, 16 x 8 x 16, bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
