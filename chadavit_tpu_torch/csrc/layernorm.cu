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
//   ln_bwd   redesigned for Hopper (PERF.md): the rows are cut into a number
//            of splits that depends on M alone and is bounded
//            (ops/layernorm.py::ln_bwd_splits), one block of 256 threads a
//            split walking a contiguous range of rows. At D = 192 a row is
//            a half warp's, 3 float4 a lane, so every lane is busy and a
//            warp takes two rows at once; other widths take a warp a row.
//            Each group of lanes issues its next row's loads before it
//            reduces the current one, recomputes xhat = (x [+ r] - mu) rstd
//            from the saved stats and writes dx = rstd (dy g - mean(dy g)
//            - xhat mean(dy g xhat)); each lane keeps its columns' sums of
//            dy xhat and dy, and the block adds its groups' sums in group
//            order into one f32 partial row of [dgamma, dbeta] a split.
//   reduce   the second pass: the splits' partial rows summed in split
//            order (warp w of 32 takes splits w, w + 32, ..., every load in
//            flight, then the 32 warp sums in order), so dgamma / dbeta are
//            the same bits from run to run; no atomics.
//
// g and b come in x's dtype: the JAX kernels round gamma and beta to x's dtype
// before the call (layernorm.py:126, :166). The cotangent of y is one array
// for both addends of x + r (the wrapper hands dx back twice).
//
// What bounds them on an H100: each reads its rows once and writes once
// (forward: x, r, y; backward: x, r, dy, dx), a few operations per element:
// bytes, over all M rows (the function takes no valid_len). The backward
// keeps enough rows in flight for that: at the hub's 16 384 rows, 256 splits
// of 64 rows, two rows in registers a group of lanes. D is at most LN_MAX_D
// and a multiple of 4 (4-element loads); the launchers refuse anything else
// with cudaErrorInvalidValue.
//
// Plain C interface (loaded with ctypes); every launcher returns
// cudaGetLastError() so that the Python wrapper can raise on a refused launch.

#include "storage.cuh"

namespace {

constexpr int LN_THREADS = 256;
constexpr int LN_WARPS = LN_THREADS / 32;
constexpr int LN_MAX_D = 1024;

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

// ---- ln_bwd: grid (splits), LPR lanes a row, LN_BWD_GROUPS rows in flight ----
// Block `split` walks rows [split M / splits, (split + 1) M / splits) of the
// M, in turns among its LN_BWD_THREADS / LPR groups of LPR lanes (group i
// takes rows r0 + i, r0 + i + GROUPS, ...), each lane VEC float4 of a row.
// A group issues the loads of its next row before it reduces the current one
// (two rows in registers; one at 8 float4 a lane). Each lane keeps its columns' sums of dy xhat and dy;
// then the groups' sums are added in group order, one partial row of
// [dgamma, dbeta] a split: partial is (splits, 2 D). splits is the caller's
// plan (ops/layernorm.py::ln_bwd_splits), a function of M alone and bounded,
// so the scratch and the second pass stay small whatever the batch.
constexpr int LN_BWD_THREADS = 256;

template <int LPR>
__device__ __forceinline__ float lanes_sum(float v) {  // over the LPR lanes of a row
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int VEC>
struct BwdRow {  // one row's operands in registers
  float4 v[VEC], d[VEC];
  float m, rs;
  bool ok;
};

template <typename T, bool RES, int LPR, int VEC>
__global__ void __launch_bounds__(LN_BWD_THREADS)
ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
              const T* __restrict__ g, const float* __restrict__ mu,
              const float* __restrict__ rstd, const T* __restrict__ dy,
              T* __restrict__ dx, float* __restrict__ partial, int M, int D, int splits) {
  constexpr int GROUPS = LN_BWD_THREADS / LPR;
  extern __shared__ float red[];  // GROUPS x 2 D
  const int split = blockIdx.x;
  const int r0 = (int)((long long)split * M / splits);
  const int r1 = (int)((long long)(split + 1) * M / splits);
  const int grp = threadIdx.x / LPR, lane = threadIdx.x % LPR;
  const int n4 = D / 4;
  float4 gv[VEC], pg[VEC], pb[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int c4 = lane + LPR * j;
    gv[j] = c4 < n4 ? load4(g + 4 * c4) : make_float4(0.f, 0.f, 0.f, 0.f);
    pg[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    pb[j] = pg[j];
  }
  auto fetch = [&](BwdRow<VEC>& t, int row) {
    t.ok = row < r1;
    if (!t.ok) return;
    const size_t base = (size_t)row * D;
    t.m = mu[row];
    t.rs = rstd[row];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int c4 = lane + LPR * j;
      if (c4 < n4) {
        t.v[j] = load_input<T, RES>(x, r, base + 4 * c4);
        t.d[j] = load4(dy + base + 4 * c4);
      }
    }
  };
  auto xhat = [&](const BwdRow<VEC>& t, int j) {  // the same bits at each use
    const float4 v = t.v[j];
    return make_float4((v.x - t.m) * t.rs, (v.y - t.m) * t.rs, (v.z - t.m) * t.rs,
                       (v.w - t.m) * t.rs);
  };
  // every lane of a warp calls it, so that the shuffles see the whole warp
  auto finish = [&](const BwdRow<VEC>& t, int row) {
    float s1 = 0.f, s2 = 0.f;
    if (t.ok)
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int c4 = lane + LPR * j;
        if (c4 < n4) {
          const float4 d = t.d[j], xh = xhat(t, j);
          const float4 e = make_float4(d.x * gv[j].x, d.y * gv[j].y, d.z * gv[j].z,
                                       d.w * gv[j].w);
          s1 += (e.x + e.y) + (e.z + e.w);
          s2 += (e.x * xh.x + e.y * xh.y) + (e.z * xh.z + e.w * xh.w);
        }
      }
    const float m1 = lanes_sum<LPR>(s1) / D, m2 = lanes_sum<LPR>(s2) / D;
    if (!t.ok) return;
    const size_t base = (size_t)row * D;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int c4 = lane + LPR * j;
      if (c4 < n4) {
        const float4 d = t.d[j], xh = xhat(t, j);
        store4(dx + base + 4 * c4,
               make_float4(t.rs * (d.x * gv[j].x - m1 - xh.x * m2),
                           t.rs * (d.y * gv[j].y - m1 - xh.y * m2),
                           t.rs * (d.z * gv[j].z - m1 - xh.z * m2),
                           t.rs * (d.w * gv[j].w - m1 - xh.w * m2)));
        pg[j].x += d.x * xh.x;
        pg[j].y += d.y * xh.y;
        pg[j].z += d.z * xh.z;
        pg[j].w += d.w * xh.w;
        pb[j].x += d.x;
        pb[j].y += d.y;
        pb[j].z += d.z;
        pb[j].w += d.w;
      }
    }
  };
  // lead: the row of the warp's first group; the walk is uniform across a warp
  int row = r0 + grp, lead = r0 + threadIdx.x / 32 * (32 / LPR);
  BwdRow<VEC> a, b;
  if constexpr (VEC > 4) {  // 8 float4 a lane: one row in registers at a time
    for (; lead < r1; row += GROUPS, lead += GROUPS) {
      fetch(a, row);
      finish(a, row);
    }
  } else {
    if (lead < r1) fetch(a, row);
    while (lead < r1) {
      if (lead + GROUPS < r1) fetch(b, row + GROUPS);
      finish(a, row);
      row += GROUPS;
      lead += GROUPS;
      if (lead >= r1) break;
      if (lead + GROUPS < r1) fetch(a, row + GROUPS);
      finish(b, row);
      row += GROUPS;
      lead += GROUPS;
    }
  }
  // the split's partial sums, zeros when it has no row: groups in a fixed order
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int c4 = lane + LPR * j;
    if (c4 < n4) {
      float* rg = red + (size_t)grp * 2 * D + 4 * c4;
      float* rb = rg + D;
      rg[0] = pg[j].x; rg[1] = pg[j].y; rg[2] = pg[j].z; rg[3] = pg[j].w;
      rb[0] = pb[j].x; rb[1] = pb[j].y; rb[2] = pb[j].z; rb[3] = pb[j].w;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * D; c += LN_BWD_THREADS) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < GROUPS; ++q) t += red[(size_t)q * 2 * D + c];
    partial[(size_t)split * 2 * D + c] = t;
  }
}

// ---- the second pass: out[i] = the splits' partials at i, in split order ------
// Grid (ceil(n_out / 32)), LN_RED_WARPS warps: lane -> output, warp w -> the
// splits w, w + LN_RED_WARPS, ... in order, then the warps' sums in order, so
// dgamma / dbeta are the same bits from run to run; no atomics. Every split
// wrote its partial, so the loads are independent and stay in flight together.
constexpr int LN_RED_WARPS = 32;

__global__ void __launch_bounds__(LN_RED_WARPS * 32)
ln_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out, int n_out,
                 int splits) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (i < n_out)
#pragma unroll 8
    for (int sp = warp; sp < splits; sp += LN_RED_WARPS) s += partial[(size_t)sp * n_out + i];
  __shared__ float red[LN_RED_WARPS][32];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && i < n_out) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < LN_RED_WARPS; ++w) t += red[w][lane];
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

template <typename T, bool RES, int LPR, int VEC>
int bwd_launch(const T* x, const T* r, const T* g, const float* mu, const float* rstd,
               const T* dy, T* dx, float* partial, int M, int D, int splits,
               cudaStream_t s) {
  auto kernel = ln_bwd_kernel<T, RES, LPR, VEC>;
  const int smem = LN_BWD_THREADS / LPR * 2 * D * (int)sizeof(float);
  const int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          smem);
  if (e != 0) return e;
  kernel<<<splits, LN_BWD_THREADS, smem, s>>>(x, r, g, mu, rstd, dy, dx, partial, M, D,
                                               splits);
  return 0;
}

// D = 192, the model's width: a half warp a row, 3 float4 a lane, every lane
// busy; other widths: a warp a row, 1, 2, 4 or 8 float4 a lane
template <typename T, bool RES>
int bwd_vec(const T* x, const T* r, const T* g, const float* mu, const float* rstd,
            const T* dy, T* dx, float* partial, int M, int D, int splits, cudaStream_t s) {
  if (D == 192) return bwd_launch<T, RES, 16, 3>(x, r, g, mu, rstd, dy, dx, partial, M, D,
                                                 splits, s);
  switch (vec_of(D)) {
    case 1: return bwd_launch<T, RES, 32, 1>(x, r, g, mu, rstd, dy, dx, partial, M, D, splits, s);
    case 2: return bwd_launch<T, RES, 32, 2>(x, r, g, mu, rstd, dy, dx, partial, M, D, splits, s);
    case 4: return bwd_launch<T, RES, 32, 4>(x, r, g, mu, rstd, dy, dx, partial, M, D, splits, s);
    default: return bwd_launch<T, RES, 32, 8>(x, r, g, mu, rstd, dy, dx, partial, M, D, splits, s);
  }
}

template <typename T>
int ln_bwd_launch(const T* x, const T* r, const T* g, const float* mu, const float* rstd,
                  const T* dy, T* dx, float* partial, float* dgb, int M, int D, int splits,
                  void* stream) {
  if (bad_width(D) || M <= 0 || splits <= 0 || splits > M) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = r != nullptr
                    ? bwd_vec<T, true>(x, r, g, mu, rstd, dy, dx, partial, M, D, splits, s)
                    : bwd_vec<T, false>(x, r, g, mu, rstd, dy, dx, partial, M, D, splits, s);
  if (e != 0) return e;
  const int n_out = 2 * D;
  ln_reduce_kernel<<<(n_out + 31) / 32, LN_RED_WARPS * 32, 0, s>>>(partial, dgb, n_out,
                                                                    splits);
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
// partial: (splits, 2 D) f32 scratch, 1 <= splits <= M; dgb: (2 D,) f32 =
// dgamma, dbeta.
int ln_bwd(const float* x, const float* r, const float* g, const float* mu,
           const float* rstd, const float* dy, float* dx, float* partial, float* dgb,
           int M, int D, int splits, void* stream) {
  return ln_bwd_launch(x, r, g, mu, rstd, dy, dx, partial, dgb, M, D, splits, stream);
}
int ln_bwd_bf16(const bf16* x, const bf16* r, const bf16* g, const float* mu,
                const float* rstd, const bf16* dy, bf16* dx, float* partial, float* dgb,
                int M, int D, int splits, void* stream) {
  return ln_bwd_launch(x, r, g, mu, rstd, dy, dx, partial, dgb, M, D, splits, stream);
}

}  // extern "C"
