// The standalone LayerNorm, y = LN(x [+ r]), forward and backward, in float32
// and in bf16 (f32 statistics and sums, f32 parameter gradients).
//
// Replaces the TPU kernels of chadavit_tpu/ops/layernorm.py: _ln_fwd_kernel
// (reached through _ln_fwd_impl) and _ln_bwd_kernel (through _ln_bwd_impl),
// the custom VJPs of fused_layernorm and fused_layernorm_residual. Those run
// (M, D) rows in blocks of 2048 rows through VMEM, keep mu and rstd as
// 8-lane row tensors and write dgamma / dbeta as 8-row broadcast partials per
// block, summed (and divided by 8) in XLA. Here:
//
//   ln_fwd   one warp per row: the row is read once into registers (x + r
//            rounded to T first, the JAX kernel's input-dtype add), its
//            mean and fast variance max(0, mean(x^2) - mean(x)^2) summed in
//            f32 across the warp, then y = (x - mu) rstd g + b written as T.
//            mu and rstd are saved as f32 (M,) rows (no lane broadcast).
//   ln_bwd   one warp per row, LN_BWD_ROWS rows per block: recomputes
//            xhat = (x [+ r] - mu) rstd from the saved stats and writes
//            dx = rstd (dy g - mean(dy g) - xhat mean(dy g xhat)); each lane
//            keeps its columns' sums of dy xhat and dy over the block's rows,
//            the warps add theirs into shared memory one after another, and
//            the block writes one f32 partial row of [dgamma, dbeta].
//   reduce   the second pass: the partial rows summed in a fixed order (warp
//            w takes rows w, w + 8, ..., then the eight warp sums in order),
//            so dgamma / dbeta are the same bits from run to run; no atomics.
//
// g and b come in x's dtype: the JAX kernels round gamma and beta to x's dtype
// before the call (layernorm.py:126, :166). The cotangent of y is one array
// for both addends of x + r (the wrapper hands dx back twice).
//
// What bounds them on an H100: each reads its rows once and writes once
// (forward: x, r, y; backward: x, r, dy, dx), a few operations per element:
// bytes. D is at most LN_MAX_D and a multiple of 4 (4-element loads); the
// launchers refuse anything else with cudaErrorInvalidValue.
//
// Plain C interface (loaded with ctypes); every launcher returns
// cudaGetLastError() so that the Python wrapper can raise on a refused launch.

#include "storage.cuh"

namespace {

constexpr int LN_THREADS = 256;
constexpr int LN_WARPS = LN_THREADS / 32;
constexpr int LN_MAX_D = 1024;
constexpr int LN_BWD_ROWS = 128;  // rows per block of the backward

__device__ __forceinline__ float ln_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// x [+ r] of four columns, the add rounded to T as the JAX kernel adds in dt
template <typename T, bool RES>
__device__ __forceinline__ float4 load_input(const T* x, const T* r, size_t off) {
  float4 a = load4(x + off);
  if (RES) {
    const float4 b = load4(r + off);
    a = make_float4(rnd<T>(a.x + b.x), rnd<T>(a.y + b.y), rnd<T>(a.z + b.z),
                    rnd<T>(a.w + b.w));
  }
  return a;
}

// ---- ln_fwd: grid (ceil(M / 8)), one warp per row, VEC float4 per lane -------
template <typename T, bool RES, int VEC>
__global__ void __launch_bounds__(LN_THREADS)
ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
              const T* __restrict__ g, const T* __restrict__ b, T* __restrict__ y,
              float* __restrict__ mu_out, float* __restrict__ rstd_out, int M, int D,
              float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * LN_WARPS + warp;
  if (row >= M) return;  // the kernel has no barrier
  const int n4 = D / 4;
  const size_t base = (size_t)row * D;
  float4 v[VEC];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int c4 = lane + 32 * j;
    if (c4 < n4) {
      v[j] = load_input<T, RES>(x, r, base + 4 * c4);
      s += (v[j].x + v[j].y) + (v[j].z + v[j].w);
      ss += (v[j].x * v[j].x + v[j].y * v[j].y) + (v[j].z * v[j].z + v[j].w * v[j].w);
    }
  }
  s = ln_warp_sum(s);
  ss = ln_warp_sum(ss);
  const float mu = s / D;
  const float rs = rsqrtf(fmaxf(ss / D - mu * mu, 0.f) + eps);
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int c4 = lane + 32 * j;
    if (c4 < n4) {
      const float4 gv = load4(g + 4 * c4), bv = load4(b + 4 * c4);
      store4(y + base + 4 * c4,
             make_float4((v[j].x - mu) * rs * gv.x + bv.x, (v[j].y - mu) * rs * gv.y + bv.y,
                         (v[j].z - mu) * rs * gv.z + bv.z, (v[j].w - mu) * rs * gv.w + bv.w));
    }
  }
  if (lane == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rs;
  }
}

// ---- ln_bwd: grid (ceil(M / LN_BWD_ROWS)), one warp per row ------------------
// partial is (gridDim.x, 2 D): the block's sums of dy xhat, then of dy.
template <typename T, bool RES, int VEC>
__global__ void __launch_bounds__(LN_THREADS)
ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
              const T* __restrict__ g, const float* __restrict__ mu,
              const float* __restrict__ rstd, const T* __restrict__ dy,
              T* __restrict__ dx, float* __restrict__ partial, int M, int D) {
  extern __shared__ float red[];  // 2 D
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n4 = D / 4;
  float4 gv[VEC], pg[VEC], pb[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int c4 = lane + 32 * j;
    gv[j] = c4 < n4 ? load4(g + 4 * c4) : make_float4(0.f, 0.f, 0.f, 0.f);
    pg[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    pb[j] = pg[j];
  }
  for (int i = warp; i < LN_BWD_ROWS; i += LN_WARPS) {  // the whole warp takes one row
    const int row = blockIdx.x * LN_BWD_ROWS + i;
    if (row >= M) break;
    const size_t base = (size_t)row * D;
    const float m = mu[row], rs = rstd[row];
    float4 xh[VEC], d[VEC];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int c4 = lane + 32 * j;
      if (c4 < n4) {
        const float4 v = load_input<T, RES>(x, r, base + 4 * c4);
        xh[j] = make_float4((v.x - m) * rs, (v.y - m) * rs, (v.z - m) * rs, (v.w - m) * rs);
        d[j] = load4(dy + base + 4 * c4);
        const float4 e = make_float4(d[j].x * gv[j].x, d[j].y * gv[j].y, d[j].z * gv[j].z,
                                     d[j].w * gv[j].w);
        s1 += (e.x + e.y) + (e.z + e.w);
        s2 += (e.x * xh[j].x + e.y * xh[j].y) + (e.z * xh[j].z + e.w * xh[j].w);
      }
    }
    const float m1 = ln_warp_sum(s1) / D, m2 = ln_warp_sum(s2) / D;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int c4 = lane + 32 * j;
      if (c4 < n4) {
        store4(dx + base + 4 * c4,
               make_float4(rs * (d[j].x * gv[j].x - m1 - xh[j].x * m2),
                           rs * (d[j].y * gv[j].y - m1 - xh[j].y * m2),
                           rs * (d[j].z * gv[j].z - m1 - xh[j].z * m2),
                           rs * (d[j].w * gv[j].w - m1 - xh[j].w * m2)));
        pg[j].x += d[j].x * xh[j].x;
        pg[j].y += d[j].y * xh[j].y;
        pg[j].z += d[j].z * xh[j].z;
        pg[j].w += d[j].w * xh[j].w;
        pb[j].x += d[j].x;
        pb[j].y += d[j].y;
        pb[j].z += d[j].z;
        pb[j].w += d[j].w;
      }
    }
  }
  // the block's partial sums: the warps add theirs one after another
  for (int w = 0; w < LN_WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int c4 = lane + 32 * j;
        if (c4 < n4) {
          float* rg = red + 4 * c4;
          float* rb = red + D + 4 * c4;
          if (w == 0) {  // the shared buffer holds nothing yet
            rg[0] = pg[j].x; rg[1] = pg[j].y; rg[2] = pg[j].z; rg[3] = pg[j].w;
            rb[0] = pb[j].x; rb[1] = pb[j].y; rb[2] = pb[j].z; rb[3] = pb[j].w;
          } else {
            rg[0] += pg[j].x; rg[1] += pg[j].y; rg[2] += pg[j].z; rg[3] += pg[j].w;
            rb[0] += pb[j].x; rb[1] += pb[j].y; rb[2] += pb[j].z; rb[3] += pb[j].w;
          }
        }
      }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < 2 * D; c += LN_THREADS)
    partial[(size_t)blockIdx.x * 2 * D + c] = red[c];
}

// ---- the second pass: out[i] = sum over the partial rows, in a fixed order ---
// Grid (ceil(n_out / 32)): lane -> output, warp w -> rows w, w + 8, ...; then
// the eight warp sums in order.
__global__ void __launch_bounds__(LN_THREADS)
ln_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out, int n_out,
                 int n_rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (i < n_out)
    for (int c = warp; c < n_rows; c += LN_WARPS) s += partial[(size_t)c * n_out + i];
  __shared__ float red[LN_WARPS][32];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && i < n_out) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < LN_WARPS; ++w) t += red[w][lane];
    out[i] = t;
  }
}

bool bad_width(int D) { return D <= 0 || D > LN_MAX_D || D % 4 != 0; }

// the float4 slots per lane a row of D needs: 1, 2, 4 or 8
int vec_of(int D) {
  const int n4 = D / 4;
  return n4 <= 32 ? 1 : n4 <= 64 ? 2 : n4 <= 128 ? 4 : 8;
}

template <typename T, bool RES, int VEC>
void fwd_launch(const T* x, const T* r, const T* g, const T* b, T* y, float* mu,
                float* rstd, int M, int D, float eps, cudaStream_t s) {
  ln_fwd_kernel<T, RES, VEC><<<(M + LN_WARPS - 1) / LN_WARPS, LN_THREADS, 0, s>>>(
      x, r, g, b, y, mu, rstd, M, D, eps);
}

template <typename T, bool RES>
void fwd_vec(const T* x, const T* r, const T* g, const T* b, T* y, float* mu, float* rstd,
             int M, int D, float eps, cudaStream_t s) {
  switch (vec_of(D)) {
    case 1: fwd_launch<T, RES, 1>(x, r, g, b, y, mu, rstd, M, D, eps, s); break;
    case 2: fwd_launch<T, RES, 2>(x, r, g, b, y, mu, rstd, M, D, eps, s); break;
    case 4: fwd_launch<T, RES, 4>(x, r, g, b, y, mu, rstd, M, D, eps, s); break;
    default: fwd_launch<T, RES, 8>(x, r, g, b, y, mu, rstd, M, D, eps, s); break;
  }
}

template <typename T>
int ln_fwd_launch(const T* x, const T* r, const T* g, const T* b, T* y, float* mu,
                  float* rstd, int M, int D, float eps, void* stream) {
  if (bad_width(D) || M < 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r != nullptr)
    fwd_vec<T, true>(x, r, g, b, y, mu, rstd, M, D, eps, s);
  else
    fwd_vec<T, false>(x, r, g, b, y, mu, rstd, M, D, eps, s);
  return (int)cudaGetLastError();
}

template <typename T, bool RES, int VEC>
void bwd_launch(const T* x, const T* r, const T* g, const float* mu, const float* rstd,
                const T* dy, T* dx, float* partial, int M, int D, cudaStream_t s) {
  const int blocks = (M + LN_BWD_ROWS - 1) / LN_BWD_ROWS;
  ln_bwd_kernel<T, RES, VEC><<<blocks, LN_THREADS, 2 * D * sizeof(float), s>>>(
      x, r, g, mu, rstd, dy, dx, partial, M, D);
}

template <typename T, bool RES>
void bwd_vec(const T* x, const T* r, const T* g, const float* mu, const float* rstd,
             const T* dy, T* dx, float* partial, int M, int D, cudaStream_t s) {
  switch (vec_of(D)) {
    case 1: bwd_launch<T, RES, 1>(x, r, g, mu, rstd, dy, dx, partial, M, D, s); break;
    case 2: bwd_launch<T, RES, 2>(x, r, g, mu, rstd, dy, dx, partial, M, D, s); break;
    case 4: bwd_launch<T, RES, 4>(x, r, g, mu, rstd, dy, dx, partial, M, D, s); break;
    default: bwd_launch<T, RES, 8>(x, r, g, mu, rstd, dy, dx, partial, M, D, s); break;
  }
}

template <typename T>
int ln_bwd_launch(const T* x, const T* r, const T* g, const float* mu, const float* rstd,
                  const T* dy, T* dx, float* partial, float* dgb, int M, int D,
                  void* stream) {
  if (bad_width(D) || M <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r != nullptr)
    bwd_vec<T, true>(x, r, g, mu, rstd, dy, dx, partial, M, D, s);
  else
    bwd_vec<T, false>(x, r, g, mu, rstd, dy, dx, partial, M, D, s);
  const int n_out = 2 * D;
  ln_reduce_kernel<<<(n_out + 31) / 32, LN_THREADS, 0, s>>>(
      partial, dgb, n_out, (M + LN_BWD_ROWS - 1) / LN_BWD_ROWS);
  return (int)cudaGetLastError();
}

}  // namespace

// The float entry points keep their names; the bf16 ones end in _bf16 and take
// the same arguments, with x, r, g, b, y, dy and dx bf16; the stats, the
// partial scratch and dgb stay f32.
extern "C" {

// x, r (null: no residual), y: (M, D); g, b: (D,); mu, rstd: (M,) f32.
int ln_fwd(const float* x, const float* r, const float* g, const float* b, float* y,
           float* mu, float* rstd, int M, int D, float eps, void* stream) {
  return ln_fwd_launch(x, r, g, b, y, mu, rstd, M, D, eps, stream);
}
int ln_fwd_bf16(const bf16* x, const bf16* r, const bf16* g, const bf16* b, bf16* y,
                float* mu, float* rstd, int M, int D, float eps, void* stream) {
  return ln_fwd_launch(x, r, g, b, y, mu, rstd, M, D, eps, stream);
}

// x, r (null: no residual), dy, dx: (M, D); g: (D,); mu, rstd: (M,) f32;
// partial: (ceil(M / 128), 2 D) f32 scratch; dgb: (2 D,) f32 = dgamma, dbeta.
int ln_bwd(const float* x, const float* r, const float* g, const float* mu,
           const float* rstd, const float* dy, float* dx, float* partial, float* dgb,
           int M, int D, void* stream) {
  return ln_bwd_launch(x, r, g, mu, rstd, dy, dx, partial, dgb, M, D, stream);
}
int ln_bwd_bf16(const bf16* x, const bf16* r, const bf16* g, const float* mu,
                const float* rstd, const bf16* dy, bf16* dx, float* partial, float* dgb,
                int M, int D, void* stream) {
  return ln_bwd_launch(x, r, g, mu, rstd, dy, dx, partial, dgb, M, D, stream);
}

}  // extern "C"
