// The GEMM steps of one ChAdaViT encoder layer, forward, float32 on CUDA cores.
//
// Replaces the TPU kernel chadavit_tpu/ops/fused_block.py::_fwd_kernel (reached
// through _run_fwd / fused_encoder_block). That kernel keeps a whole layer of one
// image in VMEM; a (2048, 192) f32 activation alone is 1.5 MB against 227 KB of
// shared memory per block on Hopper, so the layer becomes a chain:
//
//   ln_linear_fwd           qkv = LN1(x) @ Wqkv^T + bqkv
//   prefix_attention_fwd    a   = masked MHA(qkv)        (prefix_attention.cu)
//   linear_residual_ln_fwd  x2  = LN1(x + a @ Wout^T + bout)
//   linear_relu_fwd         hid = relu(x2 @ W1^T + b1)
//   linear_residual_ln_fwd  y   = LN2(x2 + hid @ W2^T + b2)
//
// What bounds them on an H100: at B*S_pad = 16384 rows the FFN GEMMs do 12.9
// GFLOP each against ~0.14 GB of traffic, so all three are bound by operations
// (67 TFLOP/s of f32 FMA outside the tensor cores). This first version is the
// simple shape of an f32 GEMM: a block owns BM = 32 rows and BN output columns,
// walks K in BK = 32 slices staged through shared memory, and each of its 256
// threads keeps a 2 x BN/16 tile of sums in registers. D = 192 fits one block's
// columns, so the LayerNorm epilogue of linear_residual_ln_fwd stays in the
// block, and the LayerNorm prologue of ln_linear_fwd is applied as the A tile is
// staged. Tensor cores (wgmma), TMA and bf16 are later work.
//
// Row tiles that lie wholly past valid_len[b] are skipped and written as zeros,
// as the TPU kernel skips its fully-invalid sequence blocks. The skip decision is
// the same for every thread of a block and is taken before the first barrier.
//
// Plain C interface (loaded with ctypes); every launcher returns
// cudaGetLastError() so that the Python wrapper can raise on a refused launch.

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

// acc[i][j] = sum_k A'[m0 + 2 ty + i, k] * W[n0 + tx + 16 j, k], where A' is A,
// or LN(A) with the row stats in s_mu/s_rstd and the affine g/beta when LN_A.
// A is (rows, lda) row-major, W is (N, K) row-major (torch Linear layout).
template <int BN, bool LN_A>
__device__ void gemm_tile(const float* __restrict__ A, int lda,
                          const float* __restrict__ W, int K, int m0, int n0,
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
      const int idx = tid + it * NT, n = idx / 8, c = (idx % 8) * 4;
      const float4 v = *reinterpret_cast<const float4*>(
          W + (size_t)(n0 + n) * K + k0 + c);
      Ws[c][n] = v.x;
      Ws[c + 1][n] = v.y;
      Ws[c + 2][n] = v.z;
      Ws[c + 3][n] = v.w;
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

// ---- ln_linear_fwd: out = LN(x) @ W^T + bias, grid (M / BM, N / BN) --------
template <int BN>
__global__ void __launch_bounds__(NT)
ln_linear_kernel(const float* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ beta, float eps,
                 const float* __restrict__ w, const float* __restrict__ bias,
                 float* __restrict__ out, const int* __restrict__ valid_len,
                 int K, int N, int s_pad) {
  constexpr int TN = BN / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  if (tile_is_padding(m0, s_pad, valid_len)) {  // uniform, before any barrier
    zero_tile<BN>(out, N, m0, n0);
    return;
  }
  __shared__ float As[BK][BM + 1];
  __shared__ float Ws[BK][BN + 1];
  __shared__ float s_mu[BM], s_rstd[BM];
  row_stats(x, K, K, m0, eps, s_mu, s_rstd);
  __syncthreads();
  float acc[2][TN];
  gemm_tile<BN, true>(x, K, w, K, m0, n0, s_mu, s_rstd, g, beta, As, Ws, acc);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      out[(size_t)(m0 + 2 * ty + i) * N + n] = acc[i][j] + bias[n];
    }
}

// ---- linear_relu_fwd: out = relu(x @ W^T + bias), grid (M / BM, N / BN) ----
template <int BN>
__global__ void __launch_bounds__(NT)
linear_relu_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out,
                   const int* __restrict__ valid_len, int K, int N, int s_pad) {
  constexpr int TN = BN / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  if (tile_is_padding(m0, s_pad, valid_len)) {
    zero_tile<BN>(out, N, m0, n0);
    return;
  }
  __shared__ float As[BK][BM + 1];
  __shared__ float Ws[BK][BN + 1];
  float acc[2][TN];
  gemm_tile<BN, false>(x, K, w, K, m0, n0, nullptr, nullptr, nullptr, nullptr,
                       As, Ws, acc);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      out[(size_t)(m0 + 2 * ty + i) * N + n] = fmaxf(acc[i][j] + bias[n], 0.f);
    }
}

// ---- linear_residual_ln_fwd: out = LN(res + (a @ W^T + bias)), grid (M / BM)
// The block owns all N = BN output columns, so the LayerNorm is local.
template <int BN>
__global__ void __launch_bounds__(NT)
linear_residual_ln_kernel(const float* __restrict__ a,
                          const float* __restrict__ w,
                          const float* __restrict__ bias,
                          const float* __restrict__ res,
                          const float* __restrict__ g,
                          const float* __restrict__ beta, float eps,
                          float* __restrict__ out,
                          const int* __restrict__ valid_len, int K, int s_pad) {
  constexpr int TN = BN / 16;
  const int m0 = blockIdx.x * BM;
  if (tile_is_padding(m0, s_pad, valid_len)) {
    zero_tile<BN>(out, BN, m0, 0);
    return;
  }
  __shared__ float As[BK][BM + 1];
  __shared__ float Ws[BK][BN + 1];  // reused below as the (BM, BN) row tile
  float acc[2][TN];
  gemm_tile<BN, false>(a, K, w, K, m0, 0, nullptr, nullptr, nullptr, nullptr,
                       As, Ws, acc);
  static_assert(BK == BM, "the W tile doubles as the row tile");
  float (*R)[BN + 1] = Ws;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int r = 2 * ty + i, n = tx + 16 * j;
      // (a @ W^T + bias) first, then the residual: the JAX order
      R[r][n] = res[(size_t)(m0 + r) * BN + n] + (acc[i][j] + bias[n]);
    }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += WARPS) {
    float s = 0.f, ss = 0.f;
    for (int n = lane; n < BN; n += 32) {
      const float v = R[r][n];
      s += v;
      ss += v * v;
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = s / BN;
    const float rstd = rsqrtf(fmaxf(ss / BN - mu * mu, 0.f) + eps);
    for (int n = lane; n < BN; n += 32)
      out[(size_t)(m0 + r) * BN + n] = (R[r][n] - mu) * rstd * g[n] + beta[n];
  }
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

extern "C" {

// x (M, 192), w (576, 192), out (M, 576).
int ln_linear_fwd(const float* x, const float* g, const float* beta, float eps,
                  const float* w, const float* bias, float* out,
                  const int* valid_len, int M, int K, int N, int s_pad,
                  void* stream) {
  if (!rows_ok(M, K, s_pad) || K != D_MODEL || N != 3 * D_MODEL)
    return (int)cudaErrorInvalidValue;
  ln_linear_kernel<D_MODEL><<<dim3(M / BM, N / D_MODEL), NT, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      x, g, beta, eps, w, bias, out, valid_len, K, N, s_pad);
  return (int)cudaGetLastError();
}

// x (M, 192), w (2048, 192), out (M, 2048).
int linear_relu_fwd(const float* x, const float* w, const float* bias,
                    float* out, const int* valid_len, int M, int K, int N,
                    int s_pad, void* stream) {
  if (!rows_ok(M, K, s_pad) || K != D_MODEL || N != D_FFN)
    return (int)cudaErrorInvalidValue;
  linear_relu_kernel<128><<<dim3(M / BM, N / 128), NT, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, out, valid_len, K, N, s_pad);
  return (int)cudaGetLastError();
}

// a (M, K) with K 192 (out-proj) or 2048 (FFN2), w (192, K), res and out (M, 192).
int linear_residual_ln_fwd(const float* a, const float* w, const float* bias,
                           const float* res, const float* g, const float* beta,
                           float eps, float* out, const int* valid_len, int M,
                           int K, int N, int s_pad, void* stream) {
  if (!rows_ok(M, K, s_pad) || N != D_MODEL || (K != D_MODEL && K != D_FFN))
    return (int)cudaErrorInvalidValue;
  linear_residual_ln_kernel<D_MODEL><<<dim3(M / BM), NT, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      a, w, bias, res, g, beta, eps, out, valid_len, K, s_pad);
  return (int)cudaGetLastError();
}

}  // extern "C"
