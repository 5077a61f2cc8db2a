// Helpers shared by the GEMM kernels of one ChAdaViT encoder layer, forward
// (fused_block.cu) and backward (fused_block_bwd.cu): float32 on CUDA cores, a
// block of NT threads owns BM rows, K is staged through shared memory in BK
// slices. Each including file gets its own copy (anonymous namespace).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int BM = 32;        // rows per block
constexpr int BK = 32;        // K slice staged in shared memory
constexpr int NT = 256;       // threads per block, as a 16 x 16 grid
constexpr int WARPS = NT / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// True when rows [m0, m0 + BM) of the flattened (B * s_pad, .) activation are
// all padding. BM divides s_pad, so the tile lies inside one image.
__device__ __forceinline__ bool tile_is_padding(int m0, int s_pad,
                                                const int* valid_len) {
  const int b = m0 / s_pad;
  return m0 - b * s_pad >= valid_len[b];
}

// Row stats of rows [m0, m0 + BM) over their K columns, f32, in the JAX
// package's form (fused_block.py::_stats): mu = mean(x),
// var = max(mean(x^2) - mu^2, 0), rstd = rsqrt(var + eps).
__device__ void row_stats(const float* x, int ld, int K, int m0, float eps,
                          float* s_mu, float* s_rstd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += WARPS) {
    const float* xr = x + (size_t)(m0 + r) * ld;
    float s = 0.f, ss = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float v = xr[k];
      s += v;
      ss += v * v;
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    if (lane == 0) {
      const float mu = s / K;
      const float var = fmaxf(ss / K - mu * mu, 0.f);
      s_mu[r] = mu;
      s_rstd[r] = rsqrtf(var + eps);
    }
  }
}

// acc[i][j] = sum_k A'[m0 + 2 ty + i, k] * W'[n0 + tx + 16 j, k], where A' is
// A, or LN(A) with the row stats in s_mu/s_rstd and the affine g/beta when
// LN_A. A is (rows, lda) row-major. W' is W when W_NK (W (N, K) row-major, the
// torch Linear layout: the forward's x @ W^T), else W^T (W (K, N) row-major:
// the backward's dY @ W). ldw is W's row stride.
template <int BN, bool LN_A, bool W_NK = true>
__device__ void gemm_tile(const float* __restrict__ A, int lda,
                          const float* __restrict__ W, int ldw, int K, int m0,
                          int n0,
                          const float* s_mu, const float* s_rstd,
                          const float* __restrict__ g,
                          const float* __restrict__ beta,
                          float (*As)[BM + 1], float (*Ws)[BN + 1],
                          float acc[2][BN / 16]) {
  constexpr int TN = BN / 16;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    {  // A tile: BM x BK floats, one float4 per thread, stored k-major
      const int r = tid / 8, c = (tid % 8) * 4;
      const float4 v = *reinterpret_cast<const float4*>(
          A + (size_t)(m0 + r) * lda + k0 + c);
      float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (LN_A)
          e[q] = (e[q] - s_mu[r]) * s_rstd[r] * g[k0 + c + q] + beta[k0 + c + q];
        As[c + q][r] = e[q];
      }
    }
#pragma unroll
    for (int it = 0; it < BN * BK / 4 / NT; ++it) {  // W tile: BN x BK
      const int idx = tid + it * NT;
      if (W_NK) {  // float4 along k
        const int n = idx / 8, c = (idx % 8) * 4;
        const float4 v = *reinterpret_cast<const float4*>(
            W + (size_t)(n0 + n) * ldw + k0 + c);
        Ws[c][n] = v.x;
        Ws[c + 1][n] = v.y;
        Ws[c + 2][n] = v.z;
        Ws[c + 3][n] = v.w;
      } else {  // float4 along n
        const int c = idx / (BN / 4), n = (idx % (BN / 4)) * 4;
        const float4 v = *reinterpret_cast<const float4*>(
            W + (size_t)(k0 + c) * ldw + n0 + n);
        Ws[c][n] = v.x;
        Ws[c][n + 1] = v.y;
        Ws[c][n + 2] = v.z;
        Ws[c][n + 3] = v.w;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float a0 = As[kk][2 * ty], a1 = As[kk][2 * ty + 1];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float w = Ws[kk][tx + 16 * j];
        acc[0][j] = fmaf(a0, w, acc[0][j]);
        acc[1][j] = fmaf(a1, w, acc[1][j]);
      }
    }
    __syncthreads();
  }
}

template <int BN>
__device__ void zero_tile(float* out, int ldo, int m0, int n0) {
  for (int idx = threadIdx.x; idx < BM * BN; idx += NT)
    out[(size_t)(m0 + idx / BN) * ldo + n0 + idx % BN] = 0.f;
}

bool rows_ok(int M, int K, int s_pad) {
  return M > 0 && M % BM == 0 && s_pad % BM == 0 && M % s_pad == 0 &&
         K % BK == 0;
}

// The widths of ChAdaViT-moyen, the one model these kernels are built for:
// D = 192, FFN 2048, so qkv has 3 * D = 576 columns. Other widths are refused.
constexpr int D_MODEL = 192;
constexpr int D_FFN = 2048;

}  // namespace
