// The backward of one ChAdaViT encoder layer, on CUDA cores, in float32 and
// in bf16 (f32 sums, f32 parameter gradients).
//
// Replaces the TPU kernel chadavit_tpu/ops/fused_block.py::_bwd_kernel (reached
// through _vjp_bwd, the custom VJP of fused_encoder_block). That kernel runs the
// images of a batch in order on one core and keeps about 20 VMEM buffers for one
// image, among them the twelve parameter gradients, which it sums across the
// grid and writes at the last step (_init / _flush). On Hopper blocks run in no
// order, so every sum across rows (dW, db, dgamma, dbeta) is written as
// per-block partial sums and added up by a second pass in a fixed order: the
// result is the same from run to run. The layer's backward is a chain of these
// kernels, driven by FusedEncoderBlock in ops/fused_block.py:
//
//   layernorm_bwd   dx = rstd (dy g - mean(dy g) - xhat mean(dy g xhat)) [+ res]
//                   and the partial sums of dgamma = sum dy xhat, dbeta = sum dy
//                   (fused_block.py:242-252); the LN2 site, the double-norm1
//                   site 2 and the site-1 LN1, whose dgamma/dbeta add into
//                   those of site 2 (both use norm1's parameters)
//   linear_dgrad    dX = dY @ W, W in torch Linear layout (N, K) read as (K, N),
//                   with a ReLU mask read from the recomputed hidden
//                   (dz1 = dhid [hid > 0]) or a residual add (dx2 = dr2 + ...)
//   linear_wgrad    dW = dY^T X' and db = colsum(dY), X' = X or LN(X) with the
//                   saved row stats applied while the X tile is staged (the QKV
//                   site, where X' = h = LN1(x) is not saved)
//
// What bounds them on an H100: the four weight-gradient and four data-gradient
// GEMMs of a layer do about 2 x the forward's operations on the same rows, so
// they are bound by operations (67 TFLOP/s of f32 FMA outside the tensor
// cores); layernorm_bwd reads three (M, 192) tensors and writes one, so it is
// bound by bytes. The weight gradients contract over all M = B * S_pad rows into
// outputs of at most 2048 x 192: one block per output tile would leave most of
// the 132 SMs idle, so the rows are cut into chunks of up to 1024 (grid z) and
// each (tile, chunk) block writes a partial sum. Chunks and 32-row tiles wholly
// past valid_len[b] are skipped (the forward wrote zeros there, and its saved
// stats there mean nothing): the partial of a skipped chunk is never written
// and the second pass skips it by the same rule. layernorm_bwd instead cuts
// the rows into a number of splits that does not grow with the batch: each
// block walks a contiguous share of the 32-row tiles and keeps dgamma/dbeta
// in registers, so its partial sums are (splits, 384), every split writes
// its own (zeros when all its tiles are padding), and the second pass, 12
// blocks of 32 warps, adds them in split order with every load in flight at
// once. Every skip decision is uniform per block and taken before the first
// barrier.
//
// The contract, the TPU kernel's (fused_block.py:33-39): the forward computes
// every row of a 32-row tile that holds a valid row for real, also the rows
// past valid_len, and zero-fills the tiles wholly past it. The backward is
// exact for any cotangent on the rows it computed: dx on those rows and the
// twelve parameter gradients equal autograd through the plain forward. Rows of
// the zero-filled tiles give nothing and get dx = 0. Keys past valid_len stay
// masked (prefix_attention_bwd.cu).
//
// The bf16 instances of linear_dgrad and linear_wgrad are tensor-core kernels
// of their own (linear_bwd_bf16.cu); the float32 ones here stay on CUDA cores.
// The bf16 instance of layernorm_bwd (T = bf16) takes bf16 activations and
// writes a bf16 dx, rounded once; the LN parameters, the saved stats, the
// partial sums and dgamma/dbeta stay f32, so the fixed-order reduce is the f32
// one.
//
// Plain C interface (loaded with ctypes); every launcher returns
// cudaGetLastError() so that the Python wrapper can raise on a refused launch.

#include "gemm_common.cuh"

namespace {

// ---- layernorm_bwd: grid (splits), one warp per row, 6 columns per lane ------
// Block `split` walks the 32-row tiles [split T / splits, (split + 1) T /
// splits) of the T = M / BM in order: dx of every row of a tile that holds a
// valid row, zeros on the others, and dgamma/dbeta summed in registers over
// its tiles; then one partial sum per split, warps in a fixed order. splits is
// the caller's plan (ops/fused_block.py::layernorm_bwd_splits), a bound that
// does not grow with the batch, so the scratch and the second pass stay small.
constexpr int LN_COLS = D_MODEL / 32;

template <typename T>
__global__ void __launch_bounds__(NT)
layernorm_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ xin,
                     const float* __restrict__ mean,
                     const float* __restrict__ rstd,
                     const float* __restrict__ g, const T* __restrict__ res,
                     T* __restrict__ dx, float* __restrict__ partial,
                     const int* __restrict__ valid_len, int s_pad, int n_tiles,
                     int splits) {
  const int split = blockIdx.x;
  const int t0 = (int)((long long)split * n_tiles / splits);
  const int t1 = (int)((long long)(split + 1) * n_tiles / splits);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float gc[LN_COLS], pg[LN_COLS], pb[LN_COLS];
#pragma unroll
  for (int j = 0; j < LN_COLS; ++j) {
    gc[j] = g[lane + 32 * j];
    pg[j] = 0.f;
    pb[j] = 0.f;
  }
  for (int tile = t0; tile < t1; ++tile) {
    const int m0 = tile * BM;
    if (tile_is_padding(m0, s_pad, valid_len)) {  // uniform across the block
      zero_tile<D_MODEL>(dx, D_MODEL, m0, 0);
      continue;  // adds nothing to the sums
    }
    for (int r = warp; r < BM; r += WARPS) {  // the whole warp takes one row
      const int row = m0 + r;
      const size_t off = (size_t)row * D_MODEL;
      const float mu = mean[row], rs = rstd[row];
      float d[LN_COLS], xh[LN_COLS], s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < LN_COLS; ++j) {
        d[j] = to_f(dy[off + lane + 32 * j]);
        xh[j] = (to_f(xin[off + lane + 32 * j]) - mu) * rs;
        const float dyg = d[j] * gc[j];
        s1 += dyg;
        s2 += dyg * xh[j];
      }
      const float m1 = warp_sum(s1) / D_MODEL, m2 = warp_sum(s2) / D_MODEL;
#pragma unroll
      for (int j = 0; j < LN_COLS; ++j) {
        float v = rs * (d[j] * gc[j] - m1 - xh[j] * m2);
        if (res != nullptr) v += to_f(res[off + lane + 32 * j]);
        dx[off + lane + 32 * j] = from_f<T>(v);
        pg[j] += d[j] * xh[j];
        pb[j] += d[j];
      }
    }
  }
  // the split's partial sums, zeros when it summed no tile: warps in a fixed order
  __shared__ float red[WARPS][2 * D_MODEL];
#pragma unroll
  for (int j = 0; j < LN_COLS; ++j) {
    red[warp][lane + 32 * j] = pg[j];
    red[warp][D_MODEL + lane + 32 * j] = pb[j];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * D_MODEL; c += NT) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w][c];
    partial[(size_t)split * 2 * D_MODEL + c] = s;
  }
}

// ---- layernorm_bwd's second pass: dgb[i] (+)= the splits' partials at i -----
// Grid (2 D / 32), LN_RED_WARPS warps: lane -> output, warp w -> the splits
// w, w + LN_RED_WARPS, ... in order, then the warps' sums in order. Every
// split wrote its partial, so the loads are independent of each other and of
// valid_len, and stay in flight together.
constexpr int LN_RED_WARPS = 32;
static_assert((2 * D_MODEL) % 32 == 0, "whole warps of outputs");

__global__ void __launch_bounds__(LN_RED_WARPS * 32)
reduce_ln_splits_kernel(const float* __restrict__ partial, float* __restrict__ out,
                        int splits, int accumulate) {
  constexpr int N_OUT = 2 * D_MODEL;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x * 32 + lane;
  float s = 0.f;
#pragma unroll 8
  for (int sp = warp; sp < splits; sp += LN_RED_WARPS) s += partial[(size_t)sp * N_OUT + i];
  __shared__ float red[LN_RED_WARPS][32];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < LN_RED_WARPS; ++w) t += red[w][lane];
    out[i] = accumulate ? out[i] + t : t;
  }
}

// ---- linear_wgrad's second pass: out[i] = sum over the chunks not skipped ----
// partial is (n_chunks, n_out); chunk c covers rows [c * chunk, (c + 1) * chunk)
// of the flattened activation and was skipped iff its first row is padding.
// Grid (ceil(n_out / 32)), 8 warps: lane -> output, warp -> every 8th chunk,
// then the warps' sums in order.
__global__ void __launch_bounds__(NT)
reduce_chunks_kernel(const float* __restrict__ partial, float* __restrict__ out,
                     int n_out, int n_chunks, int chunk, int s_pad,
                     const int* __restrict__ valid_len) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (i < n_out)
    for (int c = warp; c < n_chunks; c += WARPS)
      if (!tile_is_padding(c * chunk, s_pad, valid_len))
        s += partial[(size_t)c * n_out + i];
  __shared__ float red[WARPS][32];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && i < n_out) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += red[w][lane];
    out[i] = t;
  }
}

// ---- linear_dgrad: out = dY @ W (+ epilogue), grid (M / BM, N / BN) ----------
template <int BN, int EPI, typename T>
__global__ void __launch_bounds__(NT)
linear_dgrad_kernel(const T* __restrict__ dy, const T* __restrict__ w,
                    const T* __restrict__ aux, T* __restrict__ out,
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
  gemm_tile<BN, false, false>(dy, K, w, N, K, m0, n0, nullptr, nullptr, nullptr,
                              nullptr, As, Ws, acc);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + 2 * ty + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const size_t o = (size_t)row * N + n0 + tx + 16 * j;
      float v = acc[i][j];
      if (EPI == EPI_RELU_MASK) v = to_f(aux[o]) > 0.f ? v : 0.f;
      if (EPI == EPI_RESIDUAL) v = to_f(aux[o]) + v;
      out[o] = from_f<T>(v);
    }
  }
}

// ---- linear_wgrad: partial dW = dY^T X', db = colsum dY per row chunk --------
// Grid (K / WT, N / WT, M / chunk). A block owns a WT x WT tile of dW (thread
// (ty, tx) the outputs n = ty + 16 i, k = tx + 16 j) and the rows of one chunk
// up to the end of the image's last tile that holds a valid row, staged WM at
// a time; blocks of the first K tile also sum dY's columns. partial is
// (n_chunks, N * K + N): dW row-major, then db.
constexpr int WT = 64;
constexpr int WM = 32;

template <bool LN_X, typename T>
__global__ void __launch_bounds__(NT)
linear_wgrad_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                    const float* __restrict__ mean, const float* __restrict__ rstd,
                    const float* __restrict__ g, const float* __restrict__ beta,
                    float* __restrict__ partial, const int* __restrict__ valid_len,
                    int N, int K, int s_pad, int chunk) {
  const int k0 = blockIdx.x * WT, n0 = blockIdx.y * WT;
  const int r0 = blockIdx.z * chunk;  // first row of the chunk
  const int b = r0 / s_pad;
  const int computed = (valid_len[b] + BM - 1) / BM * BM;  // rows of real tiles
  const int rows = min(chunk, computed - (r0 - b * s_pad));
  if (rows <= 0) return;  // uniform; the second pass skips this chunk
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const bool col_sums = blockIdx.x == 0;
  __shared__ __align__(16) float Ys[WM][WT];
  __shared__ __align__(16) float Xs[WM][WT];
  float acc[4][4], db[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    db[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  for (int m0 = 0; m0 < rows; m0 += WM) {
    // stage WM rows of dY[:, n0:n0+WT] and X'[:, k0:k0+WT]: two groups of
    // four each per thread; rows past the chunk's computed rows as zeros
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int idx = tid + it * NT, r = idx / (WT / 4), c = (idx % (WT / 4)) * 4;
      const bool ok = m0 + r < rows;
      const size_t row = (size_t)r0 + m0 + r;
      float4 yv = make_float4(0.f, 0.f, 0.f, 0.f), xv = yv;
      if (ok) {
        yv = load4(dy + row * N + n0 + c);
        xv = load4(x + row * K + k0 + c);
        if (LN_X) {  // h = LN1(x), rounded to T as the forward's
          const float mu = mean[row], rs = rstd[row];
          xv.x = rnd<T>((xv.x - mu) * rs * g[k0 + c] + beta[k0 + c]);
          xv.y = rnd<T>((xv.y - mu) * rs * g[k0 + c + 1] + beta[k0 + c + 1]);
          xv.z = rnd<T>((xv.z - mu) * rs * g[k0 + c + 2] + beta[k0 + c + 2]);
          xv.w = rnd<T>((xv.w - mu) * rs * g[k0 + c + 3] + beta[k0 + c + 3]);
        }
      }
      *reinterpret_cast<float4*>(&Ys[r][c]) = yv;
      *reinterpret_cast<float4*>(&Xs[r][c]) = xv;
    }
    __syncthreads();
#pragma unroll 8
    for (int m = 0; m < WM; ++m) {
      float yv[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) yv[i] = Ys[m][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = Xs[m][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(yv[i], xv[j], acc[i][j]);
      if (col_sums && tx == 0)
#pragma unroll
        for (int i = 0; i < 4; ++i) db[i] += yv[i];
    }
    __syncthreads();
  }
  float* p = partial + (size_t)blockIdx.z * ((size_t)N * K + N);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      p[(size_t)(n0 + ty + 16 * i) * K + k0 + tx + 16 * j] = acc[i][j];
    if (col_sums && tx == 0) p[(size_t)N * K + n0 + ty + 16 * i] = db[i];
  }
}

template <typename T>
int layernorm_bwd_launch(const T* dy, const T* xin, const float* mean,
                         const float* rstd, const float* g, const T* res, T* dx,
                         float* partial, float* dgb, int accumulate,
                         const int* valid_len, int M, int N, int s_pad, int splits,
                         void* stream) {
  if (!rows_ok(M, BK, s_pad) || N != D_MODEL || splits < 1 || splits > M / BM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  layernorm_bwd_kernel<T><<<splits, NT, 0, st>>>(dy, xin, mean, rstd, g, res, dx, partial,
                                                 valid_len, s_pad, M / BM, splits);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  reduce_ln_splits_kernel<<<2 * D_MODEL / 32, LN_RED_WARPS * 32, 0, st>>>(partial, dgb, splits,
                                                                           accumulate);
  return (int)cudaGetLastError();
}

template <typename T>
int linear_dgrad_launch(const T* dy, const T* w, const T* aux, T* out,
                        int epilogue, const int* valid_len, int M, int K, int N,
                        int s_pad, void* stream) {
  if (!rows_ok(M, K, s_pad) || !is_weight_shape(K, N) ||
      (epilogue != EPI_NONE) != (aux != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == D_FFN && epilogue == EPI_RELU_MASK)
    linear_dgrad_kernel<128, EPI_RELU_MASK, T><<<dim3(M / BM, N / 128), NT, 0, st>>>(
        dy, w, aux, out, valid_len, K, N, s_pad);
  else if (N == D_MODEL && epilogue == EPI_RESIDUAL)
    linear_dgrad_kernel<D_MODEL, EPI_RESIDUAL, T><<<dim3(M / BM), NT, 0, st>>>(
        dy, w, aux, out, valid_len, K, N, s_pad);
  else if (N == D_MODEL && epilogue == EPI_NONE)
    linear_dgrad_kernel<D_MODEL, EPI_NONE, T><<<dim3(M / BM), NT, 0, st>>>(
        dy, w, aux, out, valid_len, K, N, s_pad);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <typename T>
int linear_wgrad_launch(const T* dy, const T* x, const float* mean,
                        const float* rstd, const float* g, const float* beta,
                        float* partial, float* dwb, const int* valid_len, int M,
                        int N, int K, int s_pad, int chunk, void* stream) {
  if (!rows_ok(M, BK, s_pad) || !is_weight_shape(N, K) || chunk < WM ||
      chunk > 1024 || (chunk & (chunk - 1)) || s_pad % chunk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(K / WT, N / WT, M / chunk);
  if (mean != nullptr)
    linear_wgrad_kernel<true, T><<<grid, NT, 0, st>>>(
        dy, x, mean, rstd, g, beta, partial, valid_len, N, K, s_pad, chunk);
  else
    linear_wgrad_kernel<false, T><<<grid, NT, 0, st>>>(
        dy, x, nullptr, nullptr, nullptr, nullptr, partial, valid_len, N, K,
        s_pad, chunk);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  const int n_out = N * K + N;
  reduce_chunks_kernel<<<(n_out + 31) / 32, NT, 0, st>>>(partial, dwb, n_out, M / chunk, chunk,
                                                         s_pad, valid_len);
  return (int)cudaGetLastError();
}

}  // namespace

// The float entry points keep their names; layernorm_bwd_bf16 takes the same
// arguments, with every activation pointer to bf16 and the LN parameters,
// stats, scratch and gradients still f32. linear_dgrad_bf16 and
// linear_wgrad_bf16 are in linear_bwd_bf16.cu.
extern "C" {

// dy, xin, dx (and res, when not null): (M, 192); mean, rstd: (M,);
// partial: (splits, 384) scratch, 1 <= splits <= M / 32; dgb: (384,) =
// dgamma then dbeta, summed into when accumulate is 1, else overwritten.
int layernorm_bwd(const float* dy, const float* xin, const float* mean,
                  const float* rstd, const float* g, const float* res, float* dx,
                  float* partial, float* dgb, int accumulate,
                  const int* valid_len, int M, int N, int s_pad, int splits, void* stream) {
  return layernorm_bwd_launch(dy, xin, mean, rstd, g, res, dx, partial, dgb,
                              accumulate, valid_len, M, N, s_pad, splits, stream);
}
int layernorm_bwd_bf16(const bf16* dy, const bf16* xin, const float* mean,
                       const float* rstd, const float* g, const bf16* res, bf16* dx,
                       float* partial, float* dgb, int accumulate,
                       const int* valid_len, int M, int N, int s_pad, int splits,
                       void* stream) {
  return layernorm_bwd_launch(dy, xin, mean, rstd, g, res, dx, partial, dgb,
                              accumulate, valid_len, M, N, s_pad, splits, stream);
}

// dy (M, K), w (K, N) (the forward's Linear weight, out x in), out (M, N).
// epilogue 0: none; 1: out = (dy @ w) [aux > 0]; 2: out = aux + dy @ w; aux is
// (M, N). The sites of one layer: K 192 -> N 2048 (mask), K 2048 -> N 192
// (residual), K 192 -> N 192 and K 576 -> N 192 (none).
int linear_dgrad(const float* dy, const float* w, const float* aux, float* out,
                 int epilogue, const int* valid_len, int M, int K, int N,
                 int s_pad, void* stream) {
  return linear_dgrad_launch(dy, w, aux, out, epilogue, valid_len, M, K, N, s_pad,
                             stream);
}

// dy (M, N), x (M, K); dwb: (N * K + N,) = dW (N, K) row-major, then db (N,).
// With mean (not null), x is layer-normed with mean, rstd, g, beta as it is
// staged. partial: (M / chunk, N * K + N) scratch; chunk is a power of two,
// 32 <= chunk <= 1024, that divides s_pad.
int linear_wgrad(const float* dy, const float* x, const float* mean,
                 const float* rstd, const float* g, const float* beta,
                 float* partial, float* dwb, const int* valid_len, int M, int N,
                 int K, int s_pad, int chunk, void* stream) {
  return linear_wgrad_launch(dy, x, mean, rstd, g, beta, partial, dwb, valid_len, M,
                             N, K, s_pad, chunk, stream);
}

}  // extern "C"
