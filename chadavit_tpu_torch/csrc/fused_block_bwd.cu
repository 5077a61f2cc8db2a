// The backward of one ChAdaViT encoder layer, float32 on CUDA cores.
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
// each (tile, chunk) block writes a partial sum. Chunks, tiles and rows at or
// past valid_len[b] are skipped (the forward wrote zeros there, and its saved
// stats there mean nothing): the partial of a skipped chunk is never written
// and the second pass skips it by the same rule. Every skip decision is uniform
// per block and taken before the first barrier.
//
// The contract: the cotangent dy is zero on rows >= valid_len (the model reads
// only CLS). Under it, dx on rows < valid_len and the twelve parameter
// gradients equal autograd through the plain forward, and dx on rows >=
// valid_len is written as zero.
//
// Plain C interface (loaded with ctypes); every launcher returns
// cudaGetLastError() so that the Python wrapper can raise on a refused launch.

#include "gemm_common.cuh"

namespace {

// Row r of the flattened (B * s_pad, .) activation is a real token.
__device__ __forceinline__ bool row_is_valid(int r, int s_pad,
                                             const int* valid_len) {
  const int b = r / s_pad;
  return r - b * s_pad < valid_len[b];
}

// ---- layernorm_bwd: grid (M / BM), one warp per row, 6 columns per lane ------
constexpr int LN_COLS = D_MODEL / 32;

__global__ void __launch_bounds__(NT)
layernorm_bwd_kernel(const float* __restrict__ dy, const float* __restrict__ xin,
                     const float* __restrict__ mean,
                     const float* __restrict__ rstd,
                     const float* __restrict__ g, const float* __restrict__ res,
                     float* __restrict__ dx, float* __restrict__ partial,
                     const int* __restrict__ valid_len, int s_pad) {
  const int m0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (tile_is_padding(m0, s_pad, valid_len)) {  // uniform, before any barrier
    zero_tile<D_MODEL>(dx, D_MODEL, m0, 0);
    return;  // the second pass skips this tile's partial
  }
  float gc[LN_COLS], pg[LN_COLS], pb[LN_COLS];
#pragma unroll
  for (int j = 0; j < LN_COLS; ++j) {
    gc[j] = g[lane + 32 * j];
    pg[j] = 0.f;
    pb[j] = 0.f;
  }
  for (int r = warp; r < BM; r += WARPS) {  // the whole warp takes one row
    const int row = m0 + r;
    const size_t off = (size_t)row * D_MODEL;
    if (!row_is_valid(row, s_pad, valid_len)) {
#pragma unroll
      for (int j = 0; j < LN_COLS; ++j) dx[off + lane + 32 * j] = 0.f;
      continue;
    }
    const float mu = mean[row], rs = rstd[row];
    float d[LN_COLS], xh[LN_COLS], s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < LN_COLS; ++j) {
      d[j] = dy[off + lane + 32 * j];
      xh[j] = (xin[off + lane + 32 * j] - mu) * rs;
      const float dyg = d[j] * gc[j];
      s1 += dyg;
      s2 += dyg * xh[j];
    }
    const float m1 = warp_sum(s1) / D_MODEL, m2 = warp_sum(s2) / D_MODEL;
#pragma unroll
    for (int j = 0; j < LN_COLS; ++j) {
      float v = rs * (d[j] * gc[j] - m1 - xh[j] * m2);
      if (res != nullptr) v += res[off + lane + 32 * j];
      dx[off + lane + 32 * j] = v;
      pg[j] += d[j] * xh[j];
      pb[j] += d[j];
    }
  }
  // the block's partial sums: warps in a fixed order
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
    partial[(size_t)blockIdx.x * 2 * D_MODEL + c] = s;
  }
}

// ---- the second pass: out[i] (+)= sum over the chunks not skipped -----------
// partial is (n_chunks, n_out); chunk c covers rows [c * chunk, (c + 1) * chunk)
// of the flattened activation and was skipped iff its first row is padding.
// Grid (ceil(n_out / 32)), 8 warps: lane -> output, warp -> every 8th chunk,
// then the warps' sums in order.
__global__ void __launch_bounds__(NT)
reduce_chunks_kernel(const float* __restrict__ partial, float* __restrict__ out,
                     int n_out, int n_chunks, int chunk, int s_pad,
                     const int* __restrict__ valid_len, int accumulate) {
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
    out[i] = accumulate ? out[i] + t : t;
  }
}

// ---- linear_dgrad: out = dY @ W (+ epilogue), grid (M / BM, N / BN) ----------
enum Epilogue { EPI_NONE = 0, EPI_RELU_MASK = 1, EPI_RESIDUAL = 2 };

template <int BN, int EPI>
__global__ void __launch_bounds__(NT)
linear_dgrad_kernel(const float* __restrict__ dy, const float* __restrict__ w,
                    const float* __restrict__ aux, float* __restrict__ out,
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
    const bool valid = row_is_valid(row, s_pad, valid_len);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const size_t o = (size_t)row * N + n0 + tx + 16 * j;
      float v = acc[i][j];
      if (EPI == EPI_RELU_MASK) v = aux[o] > 0.f ? v : 0.f;
      if (EPI == EPI_RESIDUAL) v = aux[o] + v;
      out[o] = valid ? v : 0.f;
    }
  }
}

// ---- linear_wgrad: partial dW = dY^T X', db = colsum dY per row chunk --------
// Grid (K / WT, N / WT, M / chunk). A block owns a WT x WT tile of dW (thread
// (ty, tx) the outputs n = ty + 16 i, k = tx + 16 j) and the rows of one chunk,
// staged WM at a time; blocks of the first K tile also sum dY's columns.
// partial is (n_chunks, N * K + N): dW row-major, then db.
constexpr int WT = 64;
constexpr int WM = 32;

template <bool LN_X>
__global__ void __launch_bounds__(NT)
linear_wgrad_kernel(const float* __restrict__ dy, const float* __restrict__ x,
                    const float* __restrict__ mean, const float* __restrict__ rstd,
                    const float* __restrict__ g, const float* __restrict__ beta,
                    float* __restrict__ partial, const int* __restrict__ valid_len,
                    int N, int K, int s_pad, int chunk) {
  const int k0 = blockIdx.x * WT, n0 = blockIdx.y * WT;
  const int r0 = blockIdx.z * chunk;  // first row of the chunk
  const int b = r0 / s_pad;
  const int rows = min(chunk, valid_len[b] - (r0 - b * s_pad));
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
    // stage WM rows of dY[:, n0:n0+WT] and X'[:, k0:k0+WT]: two float4 each
    // per thread; rows past the prefix are staged as zeros
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int idx = tid + it * NT, r = idx / (WT / 4), c = (idx % (WT / 4)) * 4;
      const bool ok = m0 + r < rows;
      const size_t row = (size_t)r0 + m0 + r;
      float4 yv = make_float4(0.f, 0.f, 0.f, 0.f), xv = yv;
      if (ok) {
        yv = *reinterpret_cast<const float4*>(dy + row * N + n0 + c);
        xv = *reinterpret_cast<const float4*>(x + row * K + k0 + c);
        if (LN_X) {
          const float mu = mean[row], rs = rstd[row];
          xv.x = (xv.x - mu) * rs * g[k0 + c] + beta[k0 + c];
          xv.y = (xv.y - mu) * rs * g[k0 + c + 1] + beta[k0 + c + 1];
          xv.z = (xv.z - mu) * rs * g[k0 + c + 2] + beta[k0 + c + 2];
          xv.w = (xv.w - mu) * rs * g[k0 + c + 3] + beta[k0 + c + 3];
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

int reduce_chunks(const float* partial, float* out, int n_out, int n_chunks,
                  int chunk, int s_pad, const int* valid_len, int accumulate,
                  cudaStream_t st) {
  reduce_chunks_kernel<<<(n_out + 31) / 32, NT, 0, st>>>(
      partial, out, n_out, n_chunks, chunk, s_pad, valid_len, accumulate);
  return (int)cudaGetLastError();
}

bool is_weight_shape(int N, int K) {  // the four Linear layers of the layer
  return (N == 3 * D_MODEL && K == D_MODEL) || (N == D_MODEL && K == D_MODEL) ||
         (N == D_FFN && K == D_MODEL) || (N == D_MODEL && K == D_FFN);
}

}  // namespace

extern "C" {

// dy, xin, dx (and res, when not null): (M, 192); mean, rstd: (M,);
// partial: (M / 32, 384) scratch; dgb: (384,) = dgamma then dbeta, summed
// into when accumulate is 1, else overwritten.
int layernorm_bwd(const float* dy, const float* xin, const float* mean,
                  const float* rstd, const float* g, const float* res, float* dx,
                  float* partial, float* dgb, int accumulate,
                  const int* valid_len, int M, int N, int s_pad, void* stream) {
  if (!rows_ok(M, BK, s_pad) || N != D_MODEL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  layernorm_bwd_kernel<<<M / BM, NT, 0, st>>>(dy, xin, mean, rstd, g, res, dx,
                                              partial, valid_len, s_pad);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  return reduce_chunks(partial, dgb, 2 * D_MODEL, M / BM, BM, s_pad, valid_len,
                       accumulate, st);
}

// dy (M, K), w (K, N) (the forward's Linear weight, out x in), out (M, N).
// epilogue 0: none; 1: out = (dy @ w) [aux > 0]; 2: out = aux + dy @ w; aux is
// (M, N). The sites of one layer: K 192 -> N 2048 (mask), K 2048 -> N 192
// (residual), K 192 -> N 192 and K 576 -> N 192 (none).
int linear_dgrad(const float* dy, const float* w, const float* aux, float* out,
                 int epilogue, const int* valid_len, int M, int K, int N,
                 int s_pad, void* stream) {
  if (!rows_ok(M, K, s_pad) || !is_weight_shape(K, N) ||
      (epilogue != EPI_NONE) != (aux != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == D_FFN && epilogue == EPI_RELU_MASK)
    linear_dgrad_kernel<128, EPI_RELU_MASK><<<dim3(M / BM, N / 128), NT, 0, st>>>(
        dy, w, aux, out, valid_len, K, N, s_pad);
  else if (N == D_MODEL && epilogue == EPI_RESIDUAL)
    linear_dgrad_kernel<D_MODEL, EPI_RESIDUAL><<<dim3(M / BM), NT, 0, st>>>(
        dy, w, aux, out, valid_len, K, N, s_pad);
  else if (N == D_MODEL && epilogue == EPI_NONE)
    linear_dgrad_kernel<D_MODEL, EPI_NONE><<<dim3(M / BM), NT, 0, st>>>(
        dy, w, aux, out, valid_len, K, N, s_pad);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dy (M, N), x (M, K); dwb: (N * K + N,) = dW (N, K) row-major, then db (N,).
// With mean (not null), x is layer-normed with mean, rstd, g, beta as it is
// staged. partial: (M / chunk, N * K + N) scratch; chunk is a power of two,
// 32 <= chunk <= 1024, that divides s_pad.
int linear_wgrad(const float* dy, const float* x, const float* mean,
                 const float* rstd, const float* g, const float* beta,
                 float* partial, float* dwb, const int* valid_len, int M, int N,
                 int K, int s_pad, int chunk, void* stream) {
  if (!rows_ok(M, BK, s_pad) || !is_weight_shape(N, K) || chunk < WM ||
      chunk > 1024 || (chunk & (chunk - 1)) || s_pad % chunk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(K / WT, N / WT, M / chunk);
  if (mean != nullptr)
    linear_wgrad_kernel<true><<<grid, NT, 0, st>>>(
        dy, x, mean, rstd, g, beta, partial, valid_len, N, K, s_pad, chunk);
  else
    linear_wgrad_kernel<false><<<grid, NT, 0, st>>>(
        dy, x, nullptr, nullptr, nullptr, nullptr, partial, valid_len, N, K,
        s_pad, chunk);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  return reduce_chunks(partial, dwb, N * K + N, M / chunk, chunk, s_pad,
                       valid_len, 0, st);
}

}  // extern "C"
