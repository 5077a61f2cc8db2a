// Helpers shared by the kernels of one ChAdaViT encoder layer, forward
// (fused_block.cu) and backward (fused_block_bwd.cu): the 32-row tile (BM) of
// the layer's contract and its padding test, the LayerNorm row stats, the
// widths the kernels are built for and the launchers' shape checks. Every sum
// is float32 on CUDA cores. The helpers are templates on the storage type T of
// the activations (storage.cuh). Each including file gets its own copy
// (anonymous namespace).

#pragma once

#include "storage.cuh"

namespace {

constexpr int BM = 32;        // rows per block
constexpr int BK = 32;        // K is a multiple of this
constexpr int NT = 256;       // threads of layernorm_bwd's block
constexpr int WARPS = NT / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// True when rows [m0, m0 + BM) of the flattened (B * s_pad, .) activation are
// all padding. BM divides s_pad, so the tile lies inside one image. Every row
// of a tile that is not padding is computed for real, also the rows past
// valid_len[b]; the forward zero-fills the padding tiles.
__device__ __forceinline__ bool tile_is_padding(int m0, int s_pad,
                                                const int* valid_len) {
  const int b = m0 / s_pad;
  return m0 - b * s_pad >= valid_len[b];
}

// Row stats of rows [m0, m0 + BM) over their K columns, f32, in the JAX
// package's form (fused_block.py::_stats): mu = mean(x),
// var = max(mean(x^2) - mu^2, 0), rstd = rsqrt(var + eps). A block of NWARPS
// warps, one warp a row: each lane sums its columns k = lane, lane + 32, ...
// in order, then the warp adds the lanes' sums (warp_sum). A warp takes its
// rows w, w + NWARPS, ... at once, so that their sums and shuffles overlap;
// each row's arithmetic is the same as one row at a time.
template <int NWARPS, typename T>
__device__ void row_stats(const T* x, int ld, int K, int m0, float eps,
                          float* s_mu, float* s_rstd) {
  constexpr int R = (BM + NWARPS - 1) / NWARPS;  // rows a warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float s[R], ss[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = warp + i * NWARPS;
    s[i] = 0.f;
    ss[i] = 0.f;
    if (r < BM) {
      const T* xr = x + (size_t)(m0 + r) * ld;
      for (int k = lane; k < K; k += 32) {
        const float v = to_f(xr[k]);
        s[i] += v;
        ss[i] += v * v;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {  // every lane of the warp, also past BM
    s[i] = warp_sum(s[i]);
    ss[i] = warp_sum(ss[i]);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = warp + i * NWARPS;
    if (lane == 0 && r < BM) {
      const float mu = s[i] / K;
      const float var = fmaxf(ss[i] / K - mu * mu, 0.f);
      s_mu[r] = mu;
      s_rstd[r] = rsqrtf(var + eps);
    }
  }
}

template <int BN, typename T>
__device__ void zero_tile(T* out, int ldo, int m0, int n0) {
  for (int idx = threadIdx.x; idx < BM * BN; idx += NT)
    out[(size_t)(m0 + idx / BN) * ldo + n0 + idx % BN] = from_f<T>(0.f);
}

bool rows_ok(int M, int K, int s_pad) {
  return M > 0 && M % BM == 0 && s_pad % BM == 0 && M % s_pad == 0 &&
         K % BK == 0;
}

// The widths these kernels are built for: ChAdaViT-moyen's D = 192,
// ChAdaViT-B/16's D_WIDE = 768 and the smoke configs' D_SMALL = 64
// (scripts/smoke/*.yaml), all with FFN 2048, so qkv has 3 D columns. D_MODEL
// (192) is also the column tile of the kernels that own whole rows at D 192:
// at D 768 a row is four such tiles, at D 64 the kernels that own whole rows
// take a tile of 64 columns. Other widths are refused.
constexpr int D_MODEL = 192;
constexpr int D_WIDE = 768;
constexpr int D_SMALL = 64;
constexpr int D_FFN = 2048;

__host__ __device__ constexpr bool is_width(int d) {
  return d == D_MODEL || d == D_WIDE || d == D_SMALL;
}

bool is_weight_shape_at(int N, int K, int d) {  // the four Linear layers of a layer of width d
  return (N == 3 * d && K == d) || (N == d && K == d) || (N == D_FFN && K == d) ||
         (N == d && K == D_FFN);
}
bool is_weight_shape(int N, int K) {
  return is_weight_shape_at(N, K, D_MODEL) || is_weight_shape_at(N, K, D_WIDE) ||
         is_weight_shape_at(N, K, D_SMALL);
}

// linear_dgrad's epilogues: none; out = (dY @ W) [aux > 0]; out = aux + dY @ W
enum Epilogue { EPI_NONE = 0, EPI_RELU_MASK = 1, EPI_RESIDUAL = 2 };

}  // namespace
