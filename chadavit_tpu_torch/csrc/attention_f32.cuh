// The pieces that the float32 prefix attention's forward (prefix_attention.cu,
// K3) and backward (prefix_attention_bwd.cu, K4) share on Hopper's CUDA cores
// (and, at the end, the backward's products at head 64 on the tensor cores):
// head rows staged as they lie (d contiguous) by 16-byte cp.async copies into
// (64, HD) tiles padded to HD + 4 floats, so that the 8 rows a quarter warp
// reads lie in distinct banks; the score product of a thread's 4 x 8 entries
// by float4 dot products over d (sgemm::dot4: every score summed over d in
// ascending order with fmaf, so the forward's scores and the backward's
// recomputed ones are the same bits); and the second product, a thread's 4
// rows x HD / 8 head columns summed over a tile's 64 rows in order
// (sgemm::outer). Every piece is a template on the head width HD, one of
// HEAD_DIMS: 96 (ChAdaViT-moyen, D 192 in 2 heads), 64 (ChAdaViT-B/16, D 768
// in 12 heads) and 32 (the smoke configs, D 64 in 2 heads). Each including
// file gets its own copy (anonymous namespace).

#pragma once

#include "mma_tf32.cuh"
#include "sgemm_f32.cuh"

namespace {

constexpr int BT = 64;  // query and key tile
// the head widths the kernels are built for; the entry points refuse others
__host__ __device__ constexpr bool built_head_dim(int hd) {
  return hd == 32 || hd == 64 || hd == 96;
}
// a staged head row, padded: rows 4 banks apart (HD a multiple of 32)
template <int HD>
constexpr int LDH = HD + 4;
template <int HD>
constexpr int TILE_F = BT * LDH<HD>;  // floats of a staged (BT, HD) tile

// BT rows of a head (rows of ld floats from src) into a (BT, LDH) shared
// tile, by cp.async from a block of THREADS threads; the caller commits
template <int THREADS, int HD>
__device__ __forceinline__ void copy_tile(float* dst, const float* __restrict__ src, int ld) {
  static_assert(HD % 32 == 0, "a head is whole groups of 32 columns");
  constexpr int V4 = HD / 4, LD = LDH<HD>;
  static_assert(BT * V4 % THREADS == 0, "whole copies a thread");
#pragma unroll
  for (int i = 0; i < BT * V4 / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS, r = c / V4, cc = c % V4 * 4;
    sgemm::cp_async_16(dst + r * LD + cc, src + (size_t)r * ld + cc);
  }
}

// sc[i][j] = A[r + i] . B[c + 8 j] over the head's d, A and B (BT, LDH)
// shared tiles: the thread's 4 rows of A against its 8 rows of B
template <int HD>
__device__ __forceinline__ void scores(float (&sc)[4][8], const float* A, int r, const float* B,
                                       int c) {
  constexpr int LD = LDH<HD>;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = load4(A + (r + i) * LD + d);
#pragma unroll
    for (int j = 0; j < 8; ++j) sgemm::dot4(sc, j, a, load4(B + (c + 8 * j) * LD + d));
  }
}

// acc[i][j] += sum over the tile's 64 rows n of P[n][r + i] H[n][4 c + 32 (j / 4) + j % 4]:
// P (BT, LDP) with the thread's 4 columns contiguous, H (BT, LDH); the
// thread's HD / 8 head columns are HD / 32 float4 of them, 32 apart
template <int LDP, int HD>
__device__ __forceinline__ void second_product(float (&acc)[4][HD / 8], const float* P, int r,
                                               const float* H, int c) {
  constexpr int LD = LDH<HD>;
#pragma unroll 4
  for (int n = 0; n < BT; ++n) {
    float a[4], bv[HD / 8];
    *reinterpret_cast<float4*>(a) = load4(P + n * LDP + r);
#pragma unroll
    for (int jj = 0; jj < HD / 32; ++jj)
      *reinterpret_cast<float4*>(bv + 4 * jj) = load4(H + n * LD + 4 * c + 32 * jj);
    sgemm::outer(acc, a, bv);
  }
}

// ---- the same products on the tensor cores, in 3xTF32 (mma_tf32.cuh) -------
// The backward at head 64 (prefix_attention_bwd.cu) takes these: a warp owns
// 16 rows of a 64 x 64 product, as eight m16n8k8 tiles of 8 columns (acc[j]
// in the C fragment of tile j: rows r0 + g and r0 + g + 8, columns 8 j + 2 t
// and 8 j + 2 t + 1, g = lane / 4, t = lane % 4). Every operand is split as
// it is read from shared memory, or from the registers of an earlier
// product's C fragment. The (BT, LDH) tiles' padding puts the reads of a
// fragment in 32 distinct banks: rows 4 banks apart for A and for B stored
// [n][k], and for B stored [k][n] read at rows 2 t and 2 t + 1.

// S (16 x 64) = A[r0 .. r0 + 16) . B[0 .. 64)^T over the head's HD columns,
// A and B (BT, LDH) tiles stored [row][d]
template <int HD>
__device__ __forceinline__ void scores_tf32(float (&acc)[8][4], const float* A, int r0,
                                            const float* B, int lane) {
  constexpr int LD = LDH<HD>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
#pragma unroll 2
  for (int kd = 0; kd < HD; kd += 8) {
    const float* a = A + (r0 + g) * LD + kd + t;
    uint32_t ab[4], as[4];
    tf32::split(a[0], ab[0], as[0]);
    tf32::split(a[8 * LD], ab[1], as[1]);
    tf32::split(a[4], ab[2], as[2]);
    tf32::split(a[8 * LD + 4], ab[3], as[3]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* b = B + (8 * j + g) * LD + kd + t;
      uint32_t bb[2], bs[2];
      tf32::split(b[0], bb[0], bs[0]);
      tf32::split(b[4], bb[1], bs[1]);
      tf32::mma3(acc[j], ab, as, bb, bs);
    }
  }
}

// acc (16 x 8 NT columns from column 8 n0) += C . H over the tile's 64 rows:
// C (16 x 64) the caller's C fragments (as scores_tf32 leaves them), H a
// (BT, LDH) tile stored [row][d]. C's fragment of tile k serves as the A
// fragment of step k with its columns taken in the order 2 t, 2 t + 1 for t,
// t + 4, and H's rows 8 k + 2 t, 8 k + 2 t + 1 for B's k = t, t + 4: the same
// permutation of the 8 rows of the step on both sides.
template <int HD, int NT>
__device__ __forceinline__ void second_tf32(float (&acc)[NT][4], const float (&c)[8][4],
                                            const float* H, int n0, int lane) {
  constexpr int LD = LDH<HD>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint32_t ab[4], as[4];
    tf32::split(c[k][0], ab[0], as[0]);
    tf32::split(c[k][2], ab[1], as[1]);
    tf32::split(c[k][1], ab[2], as[2]);
    tf32::split(c[k][3], ab[3], as[3]);
    const float* h = H + (8 * k + 2 * t) * LD + 8 * n0 + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bb[2], bs[2];
      tf32::split(h[8 * j], bb[0], bs[0]);
      tf32::split(h[8 * j + LD], bb[1], bs[1]);
      tf32::mma3(acc[j], ab, as, bb, bs);
    }
  }
}

}  // namespace
