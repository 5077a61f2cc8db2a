// The pieces that the float32 prefix attention's forward (prefix_attention.cu,
// K3) and backward (prefix_attention_bwd.cu, K4) share on Hopper's CUDA cores:
// head rows staged as they lie (d contiguous) by 16-byte cp.async copies into
// (64, 96) tiles padded to 100 floats, so that the 8 rows a quarter warp reads
// lie in distinct banks; the score product of a thread's 4 x 8 entries by
// float4 dot products over d (sgemm::dot4: every score summed over d in
// ascending order with fmaf, so the forward's scores and the backward's
// recomputed ones are the same bits); and the second product, a thread's 4
// rows x 12 head columns summed over a tile's 64 rows in order (sgemm::outer).
// Each including file gets its own copy (anonymous namespace).

#pragma once

#include "sgemm_f32.cuh"

namespace {

constexpr int BT = 64;             // query and key tile
constexpr int HEAD_DIM = 96;       // ChAdaViT-moyen: D 192, 2 heads; other widths are refused
constexpr int LDH = HEAD_DIM + 4;  // a staged head row, padded
constexpr int TILE_F = BT * LDH;   // floats of a staged (BT, HEAD_DIM) tile

// BT rows of a head (rows of ld floats from src) into a (BT, LDH) shared
// tile, by cp.async from a block of THREADS threads; the caller commits
template <int THREADS>
__device__ __forceinline__ void copy_tile(float* dst, const float* __restrict__ src, int ld) {
  constexpr int V4 = HEAD_DIM / 4;
  static_assert(BT * V4 % THREADS == 0, "whole copies a thread");
#pragma unroll
  for (int i = 0; i < BT * V4 / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS, r = c / V4, cc = c % V4 * 4;
    sgemm::cp_async_16(dst + r * LDH + cc, src + (size_t)r * ld + cc);
  }
}

// sc[i][j] = A[r + i] . B[c + 8 j] over the head's d, A and B (BT, LDH)
// shared tiles: the thread's 4 rows of A against its 8 rows of B
__device__ __forceinline__ void scores(float (&sc)[4][8], const float* A, int r, const float* B,
                                       int c) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HEAD_DIM; d += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = load4(A + (r + i) * LDH + d);
#pragma unroll
    for (int j = 0; j < 8; ++j) sgemm::dot4(sc, j, a, load4(B + (c + 8 * j) * LDH + d));
  }
}

// acc[i][j] += sum over the tile's 64 rows n of P[n][r + i] H[n][4 c + 32 (j / 4) + j % 4]:
// P (BT, LDP) with the thread's 4 columns contiguous, H (BT, LDH)
template <int LDP>
__device__ __forceinline__ void second_product(float (&acc)[4][12], const float* P, int r,
                                               const float* H, int c) {
#pragma unroll 4
  for (int n = 0; n < BT; ++n) {
    float a[4], bv[12];
    *reinterpret_cast<float4*>(a) = load4(P + n * LDP + r);
#pragma unroll
    for (int jj = 0; jj < 3; ++jj)
      *reinterpret_cast<float4*>(bv + 4 * jj) = load4(H + n * LDH + 4 * c + 32 * jj);
    sgemm::outer(acc, a, bv);
  }
}

}  // namespace
