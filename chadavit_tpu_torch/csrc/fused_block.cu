// The GEMM steps of one ChAdaViT encoder layer, forward, on CUDA cores, in
// float32.
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
// staged. Tensor cores (wgmma) and TMA are later work.
//
// The three kernels here are float32 only. The bf16 path the JAX package
// trains in (precision "bf16": bf16 activations, f32 parameters cast to bf16
// at use, _pack_weights fused_block.py:467-479) has tensor-core kernels of its
// own for all three steps (linear_fwd_bf16.cu), which round where the TPU
// kernel casts to dt (fused_block.py:106-186): h = LN1(x) before the QKV
// product, every product's f32 sum before its bias add, the bias add, the
// residual add, and the LN output; the LN parameters and the saved row stats
// stay f32, and the row contract below is theirs too.

// Row tiles that lie wholly past valid_len[b] are skipped and written as zeros,
// as the TPU kernel skips its fully-invalid sequence blocks. The skip decision is
// the same for every thread of a block and is taken before the first barrier.
//
// For training (FusedEncoderBlock in ops/fused_block.py) the two LayerNorm
// steps also write the residuals the backward reads, as the TPU kernel does
// with save=True: the LN row mean and rstd, and the pre-LN sum r. These
// outputs are optional (null pointers), so the serving path writes none. On
// skipped tiles they are written as zeros; the backward never reads them there.
// Every row of a tile that is not skipped is computed for real, also its rows
// past valid_len: the 32-row tile is what "computed for real" means for the
// layer (ops/fused_block.py).
//
// Plain C interface (loaded with ctypes); every launcher returns
// cudaGetLastError() so that the Python wrapper can raise on a refused launch.

#include "gemm_common.cuh"

namespace {

// ---- ln_linear_fwd: out = LN(x) @ W^T + bias, grid (M / BM, N / BN) --------
template <int BN>
__global__ void __launch_bounds__(NT)
ln_linear_kernel(const float* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ beta, float eps,
                 const float* __restrict__ w, const float* __restrict__ bias,
                 float* __restrict__ out, float* __restrict__ mean_out,
                 float* __restrict__ rstd_out, const int* __restrict__ valid_len,
                 int K, int N, int s_pad) {
  constexpr int TN = BN / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const bool write_stats = mean_out != nullptr && blockIdx.y == 0;
  if (tile_is_padding(m0, s_pad, valid_len)) {  // uniform, before any barrier
    zero_tile<BN>(out, N, m0, n0);
    if (write_stats && threadIdx.x < BM) {
      mean_out[m0 + threadIdx.x] = 0.f;
      rstd_out[m0 + threadIdx.x] = 0.f;
    }
    return;
  }
  __shared__ float As[BK][BM + 1];
  __shared__ float Ws[BK][BN + 1];
  __shared__ float s_mu[BM], s_rstd[BM];
  row_stats(x, K, K, m0, eps, s_mu, s_rstd);
  __syncthreads();
  if (write_stats && threadIdx.x < BM) {
    mean_out[m0 + threadIdx.x] = s_mu[threadIdx.x];
    rstd_out[m0 + threadIdx.x] = s_rstd[threadIdx.x];
  }
  float acc[2][TN];
  gemm_tile<BN, true>(x, K, w, K, K, m0, n0, s_mu, s_rstd, g, beta, As, Ws, acc);
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
// float32 only (the bf16 instance is linear_fwd_bf16.cu's)
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
  gemm_tile<BN, false>(x, K, w, K, K, m0, n0, nullptr, nullptr, nullptr, nullptr,
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
// float32 only (the bf16 instance is linear_fwd_bf16.cu's)
template <int BN>
__global__ void __launch_bounds__(NT)
linear_residual_ln_kernel(const float* __restrict__ a,
                          const float* __restrict__ w,
                          const float* __restrict__ bias,
                          const float* __restrict__ res,
                          const float* __restrict__ g,
                          const float* __restrict__ beta, float eps,
                          float* __restrict__ out, float* __restrict__ mean_out,
                          float* __restrict__ rstd_out, float* __restrict__ r_out,
                          const int* __restrict__ valid_len, int K, int s_pad) {
  constexpr int TN = BN / 16;
  const int m0 = blockIdx.x * BM;
  if (tile_is_padding(m0, s_pad, valid_len)) {
    zero_tile<BN>(out, BN, m0, 0);
    if (r_out != nullptr) zero_tile<BN>(r_out, BN, m0, 0);
    if (mean_out != nullptr && threadIdx.x < BM) {
      mean_out[m0 + threadIdx.x] = 0.f;
      rstd_out[m0 + threadIdx.x] = 0.f;
    }
    return;
  }
  __shared__ float As[BK][BM + 1];
  __shared__ float Ws[BK][BN + 1];  // reused below as the (BM, BN) row tile
  float acc[2][TN];
  gemm_tile<BN, false>(a, K, w, K, K, m0, 0, nullptr, nullptr, nullptr, nullptr,
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
    for (int n = lane; n < BN; n += 32) {
      out[(size_t)(m0 + r) * BN + n] = (R[r][n] - mu) * rstd * g[n] + beta[n];
      if (r_out != nullptr) r_out[(size_t)(m0 + r) * BN + n] = R[r][n];
    }
    if (mean_out != nullptr && lane == 0) {
      mean_out[m0 + r] = mu;
      rstd_out[m0 + r] = rstd;
    }
  }
}

}  // namespace

extern "C" {

// x (M, 192), w (576, 192), out (M, 576). mean_out and rstd_out, (M,) each,
// are written when not null (both or neither): the LN1 row stats, zeros on
// skipped tiles.
int ln_linear_fwd(const float* x, const float* g, const float* beta, float eps,
                  const float* w, const float* bias, float* out, float* mean_out,
                  float* rstd_out, const int* valid_len, int M, int K, int N,
                  int s_pad, void* stream) {
  if (!rows_ok(M, K, s_pad) || K != D_MODEL || N != 3 * D_MODEL)
    return (int)cudaErrorInvalidValue;
  ln_linear_kernel<D_MODEL><<<dim3(M / BM, N / D_MODEL), NT, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      x, g, beta, eps, w, bias, out, mean_out, rstd_out, valid_len, K, N, s_pad);
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
// When not null: mean_out and rstd_out (M,) get the LN row stats (both or
// neither), r_out (M, 192) the pre-LN sum; zeros on skipped tiles.
int linear_residual_ln_fwd(const float* a, const float* w, const float* bias,
                           const float* res, const float* g, const float* beta,
                           float eps, float* out, float* mean_out,
                           float* rstd_out, float* r_out, const int* valid_len,
                           int M, int K, int N, int s_pad, void* stream) {
  if (!rows_ok(M, K, s_pad) || N != D_MODEL || (K != D_MODEL && K != D_FFN))
    return (int)cudaErrorInvalidValue;
  linear_residual_ln_kernel<D_MODEL><<<dim3(M / BM), NT, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      a, w, bias, res, g, beta, eps, out, mean_out, rstd_out, r_out, valid_len, K,
      s_pad);
  return (int)cudaGetLastError();
}

}  // extern "C"
