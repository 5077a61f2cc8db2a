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
//                   saved row stats applied while the X tile is staged (at D
//                   768 in a row pass first; the QKV site, where X' = h =
//                   LN1(x) is not saved)
//
// What bounds them on an H100: the four weight-gradient and four data-gradient
// GEMMs of a layer do about 2 x the forward's operations on the same rows, so
// they are bound by operations (67 TFLOP/s of f32 FMA outside the tensor
// cores); layernorm_bwd reads three (M, 192) tensors and writes one, so it is
// bound by bytes. The weight gradients contract over all M = B * S_pad rows into
// outputs of at most 2048 x 192: one block per output tile would leave most of
// the 132 SMs idle, so the rows are cut into a number of splits that does not
// grow with the batch, each (tile, split) block writes a partial sum, and a
// second pass adds the partials in split order (linear_wgrad's note below).
// layernorm_bwd cuts its rows the same way: each block walks a contiguous
// share of the 32-row tiles and keeps dgamma/dbeta in registers, so its
// partial sums are (splits, 384), every split writes its own (zeros when all
// its tiles are padding), and the second pass, 12 blocks of 32 warps, adds
// them in split order with every load in flight at once. 32-row tiles wholly
// past valid_len[b] add nothing (the forward wrote zeros there, and its saved
// stats there mean nothing). Every skip decision is uniform per block and
// taken before the first barrier.
//
// Every kernel here is built for the layer's three widths, D 192
// (ChAdaViT-moyen), D 768 (ChAdaViT-B/16) and D 64 (the smoke configs), FFN
// 2048 at each: at D 768 linear_dgrad and linear_wgrad are stream-K walks of
// D 192's tiles over a persistent grid (linear_dgrad_d768,
// linear_wgrad_d768, their notes below); at D 64 both take tiles 64 wide on
// the D-wide side (their notes below); layernorm_bwd is a template on D. The
// launchers refuse any other width.
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
// of their own (linear_bwd_bf16.cu); the float32 ones here stay on CUDA cores,
// on the shared main loop of sgemm_f32.cuh.
// The bf16 instance of layernorm_bwd (T = bf16) takes bf16 activations and
// writes a bf16 dx, rounded once; the LN parameters, the saved stats, the
// partial sums and dgamma/dbeta stay f32, so the fixed-order reduce is the f32
// one.
//
// Plain C interface (loaded with ctypes); every launcher returns
// cudaGetLastError() so that the Python wrapper can raise on a refused launch.

#include "gemm_common.cuh"
#include "sgemm_f32.cuh"

#include <cooperative_groups.h>
#include <type_traits>

namespace {

// ---- layernorm_bwd: grid (splits), one warp per row, D / 32 columns per lane --
// Block `split` walks the 32-row tiles [split T / splits, (split + 1) T /
// splits) of the T = M / BM in order: dx of every row of a tile that holds a
// valid row, zeros on the others, and dgamma/dbeta summed in registers over
// its tiles; then one partial sum per split, warps in a fixed order. splits is
// the caller's plan (ops/fused_block.py::layernorm_bwd_splits), a bound that
// does not grow with the batch, so the scratch and the second pass stay small.
// D is the width: 192 (6 columns a lane, the warps' sums staged at once), 64
// (2 a lane) or 768 (24 a lane; dgamma's sums, then dbeta's, so that the
// staging stays 24 KB of static shared memory).
template <int D, typename T>
__global__ void __launch_bounds__(NT)
layernorm_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ xin,
                     const float* __restrict__ mean,
                     const float* __restrict__ rstd,
                     const float* __restrict__ g, const T* __restrict__ res,
                     T* __restrict__ dx, float* __restrict__ partial,
                     const int* __restrict__ valid_len, int s_pad, int n_tiles,
                     int splits) {
  constexpr int LN_COLS = D / 32;
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
      zero_tile<D>(dx, D, m0, 0);
      continue;  // adds nothing to the sums
    }
    for (int r = warp; r < BM; r += WARPS) {  // the whole warp takes one row
      const int row = m0 + r;
      const size_t off = (size_t)row * D;
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
      const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
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
  if constexpr (D != D_WIDE) {
    __shared__ float red[WARPS][2 * D];
#pragma unroll
    for (int j = 0; j < LN_COLS; ++j) {
      red[warp][lane + 32 * j] = pg[j];
      red[warp][D + lane + 32 * j] = pb[j];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < 2 * D; c += NT) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[w][c];
      partial[(size_t)split * 2 * D + c] = s;
    }
  } else {
    __shared__ float red[WARPS][D];
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // dgamma's sums, then dbeta's
      if (half) __syncthreads();  // every thread is done with dgamma's
#pragma unroll
      for (int j = 0; j < LN_COLS; ++j) red[warp][lane + 32 * j] = half ? pb[j] : pg[j];
      __syncthreads();
      for (int c = threadIdx.x; c < D; c += NT) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) s += red[w][c];
        partial[(size_t)split * 2 * D + half * D + c] = s;
      }
    }
  }
}

// ---- layernorm_bwd at D 768 in bf16: a 16-byte row pass ----------------------
// The first pass of layernorm_bwd for ChAdaViT-B/16's bf16 layer (D 768, T =
// bf16), in place of layernorm_bwd_kernel<768, bf16>, which read its three
// tensors one 2-byte element a load with one row of a warp in flight. Bound
// by bytes (it reads dy, x and res once and writes dx), so the design moves
// them at the memory's rate: a lane reads and writes 16-byte chunks (8
// columns; lane l holds the chunks l, l + 32, l + 64 of a row), a warp holds
// LNW_ROWS rows in flight with their stats, so that one row's loads overlap
// the other's warp sums, and a block holds no resident gamma or partials in
// registers (gamma and the warps' partials live in shared memory, in the
// lanes' order), which leaves registers for two or three blocks an SM.
// dgamma and dbeta keep layernorm_bwd_kernel's bits: a warp takes the rows
// w, w + 8, w + 16, w + 24 of each of its split's tiles in order, its partial
// of a column adds d xh (fmaf) and d row by row in that order, and the split's
// partial adds the warps' in warp order; the splits are the plan's and the
// second pass reduce_ln_splits_kernel<768>. dx's two row sums add the lane's
// columns chunk by chunk, then the warp's lanes: another order than the old
// kernel's, within the bf16 bounds of the plain version.
constexpr int LNW_CHUNKS = D_WIDE / 8 / 32;  // a lane's 16-byte chunks of a row
constexpr int LNW_ROWS = 2;                  // rows a warp holds in flight
constexpr int LNW_Q = D_WIDE / 4;            // float4 of a 768-float row
// shared memory: the warps' dgamma, then dbeta partials, then gamma, each as
// [chunk k][half][lane] float4 (columns 8 (lane + 32 k) + 4 half ..)
constexpr int LNW_SMEM = (WARPS * 2 + 1) * D_WIDE * 4;

__device__ __forceinline__ int lnw_slot(int k, int half, int lane) {
  return (k * 2 + half) * 32 + lane;
}

template <bool RES>
__global__ void __launch_bounds__(NT, 2)
layernorm_bwd_wide_bf16_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ xin,
                               const float* __restrict__ mean, const float* __restrict__ rstd,
                               const float* __restrict__ g, const bf16* __restrict__ res,
                               bf16* __restrict__ dx, float* __restrict__ partial,
                               const int* __restrict__ valid_len, int s_pad, int n_tiles,
                               int splits) {
  constexpr int D = D_WIDE;
  extern __shared__ float4 lnw_smem[];
  const int split = blockIdx.x;
  const int t0 = (int)((long long)split * n_tiles / splits);
  const int t1 = (int)((long long)(split + 1) * n_tiles / splits);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float4* pgb = lnw_smem + warp * 2 * LNW_Q;  // this warp's dgamma, then dbeta partials
  const float4* gs = lnw_smem + WARPS * 2 * LNW_Q;
  for (int i = threadIdx.x; i < LNW_Q; i += NT) {
    const int ln = i % 32, kh = i / 32;
    lnw_smem[WARPS * 2 * LNW_Q + i] =
        *reinterpret_cast<const float4*>(g + 8 * (ln + 32 * (kh / 2)) + 4 * (kh % 2));
  }
  for (int i = lane; i < 2 * LNW_Q; i += 32) pgb[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();  // gamma is in
  for (int tile = t0; tile < t1; ++tile) {
    const int m0 = tile * BM;
    if (tile_is_padding(m0, s_pad, valid_len)) {  // uniform across the block
      for (int c = threadIdx.x; c < BM * D / 8; c += NT)
        reinterpret_cast<uint4*>(dx + (size_t)m0 * D)[c] = make_uint4(0, 0, 0, 0);
      continue;  // adds nothing to the sums
    }
#pragma unroll 1
    for (int r0 = warp; r0 < BM; r0 += LNW_ROWS * WARPS) {  // rows r0, r0 + 8
      uint4 dv[LNW_ROWS][LNW_CHUNKS], xv[LNW_ROWS][LNW_CHUNKS], rv[LNW_ROWS][LNW_CHUNKS];
      float mu[LNW_ROWS], rs[LNW_ROWS];
#pragma unroll
      for (int i = 0; i < LNW_ROWS; ++i) {
        const size_t row = (size_t)m0 + r0 + i * WARPS;
        mu[i] = mean[row];
        rs[i] = rstd[row];
        const uint4* dyr = reinterpret_cast<const uint4*>(dy + row * D);
        const uint4* xr = reinterpret_cast<const uint4*>(xin + row * D);
#pragma unroll
        for (int k = 0; k < LNW_CHUNKS; ++k) {
          dv[i][k] = __ldg(dyr + lane + 32 * k);
          xv[i][k] = __ldg(xr + lane + 32 * k);
          if constexpr (RES)
            rv[i][k] = __ldg(reinterpret_cast<const uint4*>(res + row * D) + lane + 32 * k);
        }
      }
      float s1[LNW_ROWS] = {}, s2[LNW_ROWS] = {};
#pragma unroll
      for (int k = 0; k < LNW_CHUNKS; ++k) {
        const float4 ga = gs[lnw_slot(k, 0, lane)], gb = gs[lnw_slot(k, 1, lane)];
        const float gc[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
        for (int i = 0; i < LNW_ROWS; ++i) {
          const uint32_t* du = reinterpret_cast<const uint32_t*>(&dv[i][k]);
          const uint32_t* xu = reinterpret_cast<const uint32_t*>(&xv[i][k]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 d = unpack_bf16x2(du[e]), x = unpack_bf16x2(xu[e]);
            const float dyg0 = d.x * gc[2 * e], dyg1 = d.y * gc[2 * e + 1];
            s1[i] += dyg0;
            s2[i] += dyg0 * ((x.x - mu[i]) * rs[i]);
            s1[i] += dyg1;
            s2[i] += dyg1 * ((x.y - mu[i]) * rs[i]);
          }
        }
      }
      // without the residual, the second pass unpacks the rows again from
      // their 16-byte chunks, rather than the compiler keeping the first
      // pass's floats live (which spilled)
      if constexpr (!RES) {
#pragma unroll
        for (int i = 0; i < LNW_ROWS; ++i)
#pragma unroll
          for (int k = 0; k < LNW_CHUNKS; ++k)
            asm volatile("" : "+r"(dv[i][k].x), "+r"(dv[i][k].y), "+r"(dv[i][k].z),
                         "+r"(dv[i][k].w), "+r"(xv[i][k].x), "+r"(xv[i][k].y), "+r"(xv[i][k].z),
                         "+r"(xv[i][k].w));
      }
      float m1[LNW_ROWS], m2[LNW_ROWS];
#pragma unroll
      for (int i = 0; i < LNW_ROWS; ++i) {
        m1[i] = warp_sum(s1[i]) / D;
        m2[i] = warp_sum(s2[i]) / D;
      }
#pragma unroll
      for (int k = 0; k < LNW_CHUNKS; ++k) {
        uint32_t ou[LNW_ROWS][4];  // the rows' dx chunks, packed
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // columns 8 c + 4 half .. + 3
          const float4 g4 = gs[lnw_slot(k, half, lane)];
          const float gc[4] = {g4.x, g4.y, g4.z, g4.w};
          float4 pg = pgb[lnw_slot(k, half, lane)], pb = pgb[LNW_Q + lnw_slot(k, half, lane)];
          float* pgv = reinterpret_cast<float*>(&pg);
          float* pbv = reinterpret_cast<float*>(&pb);
#pragma unroll
          for (int i = 0; i < LNW_ROWS; ++i) {  // the rows in the warp's order
            const uint32_t* du = reinterpret_cast<const uint32_t*>(&dv[i][k]) + 2 * half;
            const uint32_t* xu = reinterpret_cast<const uint32_t*>(&xv[i][k]) + 2 * half;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float2 d = unpack_bf16x2(du[e]), x = unpack_bf16x2(xu[e]);
              const float xh0 = (x.x - mu[i]) * rs[i], xh1 = (x.y - mu[i]) * rs[i];
              float v0 = rs[i] * (d.x * gc[2 * e] - m1[i] - xh0 * m2[i]);
              float v1 = rs[i] * (d.y * gc[2 * e + 1] - m1[i] - xh1 * m2[i]);
              if constexpr (RES) {
                const float2 rr =
                    unpack_bf16x2(reinterpret_cast<const uint32_t*>(&rv[i][k])[2 * half + e]);
                v0 += rr.x;
                v1 += rr.y;
              }
              ou[i][2 * half + e] = pack_bf16x2(v0, v1);
              pgv[2 * e] = fmaf(d.x, xh0, pgv[2 * e]);
              pgv[2 * e + 1] = fmaf(d.y, xh1, pgv[2 * e + 1]);
              pbv[2 * e] += d.x;
              pbv[2 * e + 1] += d.y;
            }
          }
          pgb[lnw_slot(k, half, lane)] = pg;
          pgb[LNW_Q + lnw_slot(k, half, lane)] = pb;
        }
#pragma unroll
        for (int i = 0; i < LNW_ROWS; ++i)
          reinterpret_cast<uint4*>(dx + ((size_t)m0 + r0 + i * WARPS) * D)[lane + 32 * k] =
              make_uint4(ou[i][0], ou[i][1], ou[i][2], ou[i][3]);
      }
    }
  }
  // the split's partial sums, zeros when it summed no tile: warps in a fixed order
  __syncthreads();
  const float* red = reinterpret_cast<const float*>(lnw_smem);
  for (int c = threadIdx.x; c < 2 * D; c += NT) {
    const int kind = c / D, col = c % D, chunk = col / 8;
    const int at = kind * D + 4 * lnw_slot(chunk / 32, col % 8 / 4, chunk % 32) + col % 4;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w * 2 * D + at];
    partial[(size_t)split * 2 * D + c] = s;
  }
}

// ---- layernorm_bwd's second pass: dgb[i] (+)= the splits' partials at i -----
// Grid (2 D / 32), LN_RED_WARPS warps: lane -> output, warp w -> the splits
// w, w + LN_RED_WARPS, ... in order, then the warps' sums in order. Every
// split wrote its partial, so the loads are independent of each other and of
// valid_len, and stay in flight together.
constexpr int LN_RED_WARPS = 32;

template <int D>
__global__ void __launch_bounds__(LN_RED_WARPS * 32)
reduce_ln_splits_kernel(const float* __restrict__ partial, float* __restrict__ out,
                        int splits, int accumulate) {
  constexpr int N_OUT = 2 * D;
  static_assert(N_OUT % 32 == 0, "whole warps of outputs");
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

// ---- linear_dgrad (float32): out = dY @ W (+ epilogue) -----------------------
// Redesigned for Hopper's CUDA cores on the shared main loop of
// sgemm_f32.cuh; the bf16 instance is linear_bwd_bf16.cu's.
//
// Replaces the data gradients of the TPU kernel
// chadavit_tpu/ops/fused_block.py::_bwd_kernel (:211): the _nt products at
// :318 (FFN2 -> hid, with the ReLU mask), :323 (FFN1 -> x2, plus the
// residual's cotangent), :339 (the out-projection) and :423 (QKV -> h).
//
// What bounds it: operations. At hub shapes the four sites do 17 GFLOP on
// the rows the forward computed, against about 0.2 GB of inputs and outputs,
// so 67 TFLOP/s of f32 FMA is the limit. The design:
// - a block owns one 32-row tile of the contract and BN output columns: all
//   192 at the out-projection, QKV and FFN1 sites, 256 of hid's 2048 at FFN2
//   (so that site's grid is 8 column slices a row tile); each warp takes 32
//   rows x 64 columns, a thread 8 rows x 8 columns (64 sums: rows ty + 4 i,
//   columns 4 tx + {0..3} and 32 + 4 tx + {0..3} of its warp's);
// - dY (K contiguous) and W (read as (K, N): N contiguous) are staged as they
//   lie in memory, DG_BK = 16 columns of K a stage, by 16-byte cp.async
//   copies into a ring of DG_STAGES slots, one barrier a stage; dY's rows are
//   padded to 20 floats. A thread reads a float4 of each of its 8 rows over
//   four k (a quarter warp reads one row: a broadcast) and two float4 of each
//   of those four rows of W (a quarter warp reads 128 contiguous bytes):
//   16 reads of 16 bytes feed 256 FMAs (sgemm::outer4), summed in k order;
// - at FFN1 (K 2048) and QKV (K 576) a cluster of two blocks shares the row
//   tile and block `rank` sums K range [rank K / SPLIT, (rank + 1) K /
//   SPLIT): the hub's 293 computed row tiles become 586 blocks, 4.4 an SM,
//   where whole tiles are 2.2 an SM and the SMs that get 3 set the time
//   (scripts/bench_linear_f32.py: FFN1 0.3155 ms whole, 0.2696 split in
//   two; QKV 0.1006 and 0.0833, NVIDIA H100 80GB HBM3, 700 W). Each block
//   writes its sums into a row tile that reuses the ring; after a cluster
//   barrier block `rank` adds the SPLIT tiles of its 32 / SPLIT rows in rank
//   order through distributed shared memory (the same bits on every run)
//   and adds the residual; a second cluster barrier keeps every tile in
//   place until its readers are done;
// - the epilogue (ReLU mask from the recomputed hid, the residual add) works
//   on 16-byte loads and stores.
// At D 64 the three N 64 sites take BN = 64, one warp a block (the FFN2 site
// keeps its 256-column slices of hid); the K splits are those of D 192.
// A 32-row tile wholly past valid_len is written as zeros and not read; the
// decision is the same for every block of a cluster and taken before any
// barrier. DG_SPLIT_FFN and DG_SPLIT_QKV set the cluster sizes of the FFN1
// and QKV (K 576) sites, so that scripts/bench_linear_f32.py can time other
// splits of the same source; the out-projection (K 192) takes no split.
#ifndef DG_SPLIT_FFN
#define DG_SPLIT_FFN 2
#endif
#ifndef DG_SPLIT_QKV
#define DG_SPLIT_QKV 2
#endif
constexpr int DG_BK = 16;
constexpr int DG_LDA = DG_BK + 4;  // a staged dY row, padded
constexpr int DG_STAGES = 4;
constexpr int DG_TM = 8, DG_TN = 8;  // a thread's rows and columns
constexpr int DG_WN = 64;            // a warp's columns: 4 row groups x 8 column groups

template <int BN>
__host__ __device__ constexpr int dgrad_stage() {  // floats of a stage: dY's slice, W's
  return BM * DG_LDA + DG_BK * BN;
}
template <int BN>
constexpr int dgrad_smem() {
  return DG_STAGES * dgrad_stage<BN>() * 4;
}

template <int BN, int EPI, int SPLIT>
__global__ void __launch_bounds__(BN / DG_WN * 32, 3)
linear_dgrad_kernel(const float* __restrict__ dy, const float* __restrict__ w,
                    const float* __restrict__ aux, float* __restrict__ out,
                    const int* __restrict__ valid_len, int K, int N, int s_pad) {
  constexpr int THREADS = BN / DG_WN * 32, STAGE = dgrad_stage<BN>();
  constexpr int ROWS = BM / SPLIT;  // rows a block writes
  constexpr int LDR = BN + 4;       // the row tile of sums (SPLIT > 1)
  static_assert(BN % DG_WN == 0 && BM == 4 * DG_TM && BM % SPLIT == 0 &&
                    BM * LDR <= DG_STAGES * STAGE,
                "linear_dgrad tile shape");
  namespace cg = cooperative_groups;
  const int rank = SPLIT > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int m0 = blockIdx.x / SPLIT * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tile_is_padding(m0, s_pad, valid_len)) {  // the whole cluster, before any barrier
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = tid; c < ROWS * BN / 4; c += THREADS) {
      const int r = m0 + rank * ROWS + c / (BN / 4), cc = c % (BN / 4) * 4;
      *reinterpret_cast<float4*>(out + (size_t)r * N + n0 + cc) = z;
    }
    return;
  }
  extern __shared__ __align__(16) float dg_smem[];
  const int ty = lane >> 3, tx = lane & 7, wc = warp * DG_WN;
  const int kpart = K / SPLIT, kbase = rank * kpart;

  auto load = [&](int s, int slot) {  // K columns [s BK, (s + 1) BK) of the block's range
    float* as = dg_smem + slot * STAGE;
    float* ws = as + BM * DG_LDA;
    const int k0 = kbase + s * DG_BK;
    for (int c = tid; c < BM * DG_BK / 4; c += THREADS) {
      const int r = c / (DG_BK / 4), cc = c % (DG_BK / 4) * 4;
      sgemm::cp_async_16(as + r * DG_LDA + cc, dy + (size_t)(m0 + r) * K + k0 + cc);
    }
#pragma unroll
    for (int q = 0; q < DG_BK * BN / 4 / THREADS; ++q) {
      const int c = tid + q * THREADS;
      const int r = c / (BN / 4), cc = c % (BN / 4) * 4;
      sgemm::cp_async_16(ws + r * BN + cc, w + (size_t)(k0 + r) * N + n0 + cc);
    }
  };
  float acc[DG_TM][DG_TN];
#pragma unroll
  for (int i = 0; i < DG_TM; ++i)
#pragma unroll
    for (int j = 0; j < DG_TN; ++j) acc[i][j] = 0.f;
  sgemm::ring<DG_STAGES>(kpart / DG_BK, load, [&](int, int slot) {
    const float* as = dg_smem + slot * STAGE + ty * DG_LDA;
    const float* ws = dg_smem + slot * STAGE + BM * DG_LDA + wc + 4 * tx;
#pragma unroll
    for (int kk = 0; kk < DG_BK; kk += 4) {
      float4 av[DG_TM];
      float bv[4][DG_TN];
#pragma unroll
      for (int i = 0; i < DG_TM; ++i) av[i] = load4(as + i * 4 * DG_LDA + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        *reinterpret_cast<float4*>(bv[q]) = load4(ws + (kk + q) * BN);
        *reinterpret_cast<float4*>(bv[q] + 4) = load4(ws + (kk + q) * BN + 32);
      }
      sgemm::outer4(acc, av, bv);
    }
  });

  // out = acc [aux > 0] or aux + acc, 16 bytes at a time
  auto finish = [&](float4 v, size_t o) {
    if constexpr (EPI == EPI_RELU_MASK) {
      const float4 h = load4(aux + o);
      v.x = h.x > 0.f ? v.x : 0.f;
      v.y = h.y > 0.f ? v.y : 0.f;
      v.z = h.z > 0.f ? v.z : 0.f;
      v.w = h.w > 0.f ? v.w : 0.f;
    } else if constexpr (EPI == EPI_RESIDUAL) {
      const float4 r = load4(aux + o);
      v = make_float4(r.x + v.x, r.y + v.y, r.z + v.z, r.w + v.w);
    }
    *reinterpret_cast<float4*>(out + o) = v;
  };
  if constexpr (SPLIT == 1) {
#pragma unroll
    for (int i = 0; i < DG_TM; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        finish(make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]),
               (size_t)(m0 + ty + 4 * i) * N + n0 + wc + 4 * tx + 32 * h);
  } else {
    __syncthreads();  // every warp is done with the ring: it becomes the row tile
    float* rt = dg_smem;
#pragma unroll
    for (int i = 0; i < DG_TM; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float4*>(rt + (ty + 4 * i) * LDR + wc + 4 * tx + 32 * h) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
    cg::this_cluster().sync();  // every block's sums are in place
    const float* tiles[SPLIT];
#pragma unroll
    for (int q = 0; q < SPLIT; ++q) tiles[q] = cg::this_cluster().map_shared_rank(rt, q);
    for (int c = tid; c < ROWS * BN / 4; c += THREADS) {
      const int r = rank * ROWS + c / (BN / 4), cc = c % (BN / 4) * 4;
      float4 p = load4(tiles[0] + r * LDR + cc);
#pragma unroll
      for (int q = 1; q < SPLIT; ++q) {  // in rank order
        const float4 t = load4(tiles[q] + r * LDR + cc);
        p = make_float4(p.x + t.x, p.y + t.y, p.z + t.z, p.w + t.w);
      }
      finish(p, (size_t)(m0 + r) * N + n0 + cc);
    }
    cg::this_cluster().sync();  // the tiles stay until read
  }
}

// ---- linear_wgrad (float32): partial dW = dY^T X', db = colsum dY per split ---
// Redesigned for Hopper's CUDA cores on the shared main loop of
// sgemm_f32.cuh; the bf16 instance is linear_bwd_bf16.cu's.
//
// Replaces the weight gradients and bias sums of the TPU kernel
// chadavit_tpu/ops/fused_block.py::_bwd_kernel (:211): the _tn products and
// column sums at :316-317 (FFN2), :321-322 (FFN1), :337-338 (out-projection)
// and :420-422 (QKV, with h = LN1(x) recomputed).
//
// What bounds it: operations. At hub shapes the four sites do 17.5 GFLOP on
// the rows the forward computed, against about 0.1 GB of inputs, so 67
// TFLOP/s of f32 FMA is the limit. The design:
// - the grid is output tiles x splits. A tile spans 192 of the D-wide side of
//   dW (K at the QKV, out-projection and FFN1 sites, N at FFN2: the whole
//   side at D 192, a quarter at D 768) and 64 of
//   the other, so the 2048-wide operand (dz1 or hid) is read from device
//   memory once (at D 64 the whole 64-wide side and 192, 64, 128 and 128 of
//   the other at the QKV, out-projection, FFN1 and FFN2 sites: 6, 2, 4 and 4
//   warps, WGRAD_F32_TILES); each warp owns 32 x 64 of the tile, a thread 8 x 8
//   sums (n at 4 ln + {0..3} and 16 + 4 ln + {0..3}, k at 4 lk + {0..3} and
//   32 + 4 lk + {0..3} of its warp's tile), so each 16-byte shared read feeds
//   16 FMAs (sgemm::outer) and a quarter warp reads 128 contiguous bytes;
// - a split takes a fixed, contiguous share of the list of computed 32-row
//   tiles (those that hold a valid row; every block builds it from
//   valid_len), as the bf16 instance does, so the partial sums are
//   (splits, N * K + N) whatever the batch; the splits are the caller's plan
//   (ops/fused_block.py::wgrad_splits, WGRAD_F32_TILES);
// - a split's tiles are staged one at a time, dY's and X's columns of the
//   tile as they lie in memory, by 16-byte cp.async copies into a ring of
//   three 32 KB slots: two tiles in flight while one is multiplied, one
//   barrier a tile, two blocks an SM;
// - the QKV site applies LN1 with the saved f32 stats (copied with the tile)
//   to the staged X tile in place, with the forward's expression
//   (ln_linear_fwd's prologue, fused_block.cu), so X' is the forward's h;
// - db = colsum(dY) in the blocks of the first K tile: one thread a column
//   adds the staged dY tile's rows in order.
// Every split writes its partial whole (zeros when it has no tile), so the
// second pass adds the splits in split order with 16-byte loads and no test:
// the same bits on every run, no atomics.
constexpr int WG_TM = 8;         // a thread's sums along n (and 8 along k)
constexpr int WG_WN = 32;        // a warp's tile: 32 (n) x 64 (k)
constexpr int WG_ROWS = BM;      // a stage: one 32-row tile of the contract
constexpr int WG_STAGES = 3;
constexpr int WG_MAX_IMAGES = 1024;
constexpr int WG_STATS = 2 * WG_ROWS;  // a stage's LN stats: mean, then rstd

template <int TN, int TK>
constexpr int wgrad_smem() {  // bytes of the ring: dY tile, X tile, stats
  return WG_STAGES * (WG_ROWS * (TN + TK) + WG_STATS) * 4;
}
template <int TN, int TK>
__host__ __device__ constexpr int wgrad_threads() {  // a warp per 32 x 64 of the tile
  return TN / WG_WN * (TK / 64) * 32;
}

template <int TN, int TK, bool LN_X>
__global__ void __launch_bounds__(wgrad_threads<TN, TK>(), 2)
linear_wgrad_kernel(const float* __restrict__ dy, const float* __restrict__ x,
                    const float* __restrict__ mean, const float* __restrict__ rstd,
                    const float* __restrict__ g, const float* __restrict__ beta,
                    float* __restrict__ partial, const int* __restrict__ valid_len, int N,
                    int K, int s_pad, int bsz, int splits) {
  constexpr int WARPS_K = TK / 64, WG_THREADS = wgrad_threads<TN, TK>();
  constexpr int Y_STAGE = WG_ROWS * TN, X_STAGE = WG_ROWS * TK;
  constexpr int STAGE = Y_STAGE + X_STAGE + WG_STATS;
  static_assert(TN % WG_WN == 0 && TK % 64 == 0 && WG_THREADS >= 2 * WG_STATS / 4,
                "wgrad tile shape");
  extern __shared__ __align__(16) float wg_smem[];
  __shared__ int first[WG_MAX_IMAGES + 1];  // index of each image's first computed tile
  __shared__ __align__(16) float gb[LN_X ? 2 * TK : 4];  // LN_X: g, then beta
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ktiles = K / TK;
  const int n0 = (blockIdx.x / ktiles) * TN, k0 = (blockIdx.x % ktiles) * TK;
  const int split = blockIdx.y;
  const int wn = warp / WARPS_K, wk = warp % WARPS_K, ln = lane >> 3, lk = lane & 7;
  const int na = wn * WG_WN + ln * 4, ka = wk * 64 + lk * 4;  // the thread's first n, k
  if constexpr (LN_X)
    for (int c = tid; c < TK; c += WG_THREADS) {
      gb[c] = g[k0 + c];
      gb[TK + c] = beta[k0 + c];
    }

  // the list of computed tiles, image by image: warp 0 scans the counts
  if (warp == 0) {
    const int per = (bsz + 31) / 32, lo = min(bsz, lane * per), hi = min(bsz, lo + per);
    const int most = s_pad / WG_ROWS;
    auto count = [&](int i) {
      return min(most, (max(valid_len[i], 0) + WG_ROWS - 1) / WG_ROWS);
    };
    int mine = 0;
    for (int i = lo; i < hi; ++i) mine += count(i);
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    int run = incl - mine;
    for (int i = lo; i < hi; ++i) {
      first[i] = run;
      run += count(i);
    }
    if (lane == 31) first[bsz] = incl;
  }
  __syncthreads();
  const int total = first[bsz];
  const int begin = (int)((long long)split * total / splits);
  const int n_tiles = (int)((long long)(split + 1) * total / splits) - begin;
  auto tile_row = [&](int idx) -> size_t {  // first row of computed tile idx
    int lo = 0, hi = bsz;                   // first[lo] <= idx < first[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (first[mid] <= idx) lo = mid;
      else hi = mid;
    }
    return (size_t)lo * s_pad + (size_t)(idx - first[lo]) * WG_ROWS;
  };
  auto load = [&](int s, int slot) {
    const size_t row0 = tile_row(begin + s);
    float* ys = wg_smem + slot * STAGE;
    float* xs = ys + Y_STAGE;
    for (int c = tid; c < Y_STAGE / 4; c += WG_THREADS) {
      const int r = c / (TN / 4), cc = c % (TN / 4) * 4;
      sgemm::cp_async_16(ys + r * TN + cc, dy + (row0 + r) * N + n0 + cc);
    }
    for (int c = tid; c < X_STAGE / 4; c += WG_THREADS) {
      const int r = c / (TK / 4), cc = c % (TK / 4) * 4;
      sgemm::cp_async_16(xs + r * TK + cc, x + (row0 + r) * K + k0 + cc);
    }
    if constexpr (LN_X) {  // 32 means, then 32 rstds: 16 copies of 16 bytes
      if (tid < WG_STATS / 4)
        sgemm::cp_async_16(xs + X_STAGE + tid * 4, (tid < WG_ROWS / 4 ? mean + row0
                                                                     : rstd + row0 - WG_ROWS) +
                                                        tid * 4);
    }
  };

  const bool col_sums = k0 == 0;  // db, in the blocks of the first K tile
  static_assert(TN <= WG_THREADS, "a thread a column of db");
  float acc[WG_TM][8], db = 0.f;
#pragma unroll
  for (int i = 0; i < WG_TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  sgemm::ring<WG_STAGES>(n_tiles, load, [&](int, int slot) {
    const float* ys = wg_smem + slot * STAGE;
    float* xs = wg_smem + slot * STAGE + Y_STAGE;
    if constexpr (LN_X) {  // h = LN1(x), in place: the forward's expression
      const float* st = xs + X_STAGE;
      for (int c = tid; c < X_STAGE / 4; c += WG_THREADS) {
        const int r = c / (TK / 4), cc = c % (TK / 4) * 4;
        const float mu = st[r], rs = st[WG_ROWS + r];
        float4 v = *reinterpret_cast<float4*>(xs + r * TK + cc);
        v.x = (v.x - mu) * rs * gb[cc] + gb[TK + cc];
        v.y = (v.y - mu) * rs * gb[cc + 1] + gb[TK + cc + 1];
        v.z = (v.z - mu) * rs * gb[cc + 2] + gb[TK + cc + 2];
        v.w = (v.w - mu) * rs * gb[cc + 3] + gb[TK + cc + 3];
        *reinterpret_cast<float4*>(xs + r * TK + cc) = v;
      }
      __syncthreads();  // the normed tile
    }
    if (col_sums && tid < TN)
#pragma unroll 8
      for (int m = 0; m < WG_ROWS; ++m) db += ys[m * TN + tid];
#pragma unroll 8
    for (int m = 0; m < WG_ROWS; ++m) {
      float yv[WG_TM], xv[8];
      *reinterpret_cast<float4*>(yv) = load4(ys + m * TN + na);
      *reinterpret_cast<float4*>(yv + 4) = load4(ys + m * TN + na + 16);
      *reinterpret_cast<float4*>(xv) = load4(xs + m * TK + ka);
      *reinterpret_cast<float4*>(xv + 4) = load4(xs + m * TK + ka + 32);
      sgemm::outer(acc, yv, xv);
    }
  });

  // this split's partial, written whole (zeros when it got no tiles)
  float* p = partial + (size_t)split * ((size_t)N * K + N);
#pragma unroll
  for (int i = 0; i < WG_TM; ++i) {
    const size_t n = n0 + na + (i & 3) + (i >> 2) * 16;
    *reinterpret_cast<float4*>(p + n * K + k0 + ka) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(p + n * K + k0 + ka + 32) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  if (col_sums && tid < TN) p[(size_t)N * K + n0 + tid] = db;
}

// ---- linear_wgrad's second pass: out[i] = the splits' partials at i ---------
// added in split order, four outputs a thread; every split wrote its partial,
// so the loads carry no test and stay in flight together
__global__ void __launch_bounds__(NT)
reduce_wgrad_splits_kernel(const float4* __restrict__ partial, float4* __restrict__ out,
                           int n_out4, int splits) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= n_out4) return;
  float4 s = partial[i];
#pragma unroll 8
  for (int sp = 1; sp < splits; ++sp) {
    const float4 v = partial[(size_t)sp * n_out4 + i];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  out[i] = s;
}

// ---- linear_wgrad at D 768 (float32): a stream-K walk over the card --------
// The same products as linear_wgrad_kernel (the same lines of the TPU kernel),
// at ChAdaViT-B/16's four weight shapes. There the split plan above leaves
// the card half idle: at the QKV site the 144 output tiles of 64 x 192 take
// one split each, 144 blocks for 264 places of two an SM, and each block
// walks every computed 32-row tile of the batch alone. So the work is cut
// along the rows as well as the tiles:
// - a unit is one computed 32-row tile of one output tile; the units of every
//   output tile, tile-major (a tile's units in the order of the list of
//   computed tiles), are cut into gridDim.x (two an SM, WGRAD_F32_BLOCKS)
//   contiguous, near-equal shares, one a block, so every SM holds two blocks
//   of the same work whatever the tile count and the batch;
// - a block walks its share through the ring of linear_wgrad_kernel (the same
//   tiles, 8 x 8 sums a thread, the same staging and loop body), its stages
//   running on across a change of output tile; at the last unit of each tile
//   segment it writes the segment's partial dW tile (and db, in the segments
//   of the first K tile) into slot tile + block, then starts from zero;
// - the QKV site's X' = LN1(x) comes from a row pass (ln_rows_saved_f32_kernel)
//   that applies the saved stats by the forward's expression (fused_block.cu's
//   ln_rows_f32_kernel: fmaf((x - mu) rstd, g, beta)) into a scratch of x's
//   shape, so X' is the forward's h, bit for bit (normalising the staged tile
//   in place, a second barrier a stage, cost the site 18 % a FLOP, PERF.md);
// - reduce_wgrad_stream_kernel adds each tile's slots in block order, four
//   outputs a thread: no atomics, the same bits on every run. The scratch is
//   tiles + blocks - 1 slots whatever the batch.
// The rows of dW sum in another order than the split plan's (each share in
// tile order, the shares in block order), which no contract fixes.
template <int TN, int TK>
__host__ __device__ constexpr int wgrad_slot() {  // a partial: the dW tile, then TN of db
  return TN * TK + TN;
}
template <int TN, int TK>
constexpr int wgrad_stream_smem() { return WG_STAGES * WG_ROWS * (TN + TK) * 4; }

// The list of computed 32-row tiles (those that hold a valid row), image by
// image, as warp 0 of a block builds it in shared memory: image i's first
// tile is list entry first[i], first[bsz] the count.
__device__ __forceinline__ void list_tiles(int* first, const int* __restrict__ valid_len,
                                           int bsz, int s_pad) {
  const int lane = threadIdx.x & 31;
  const int per = (bsz + 31) / 32, lo = min(bsz, lane * per), hi = min(bsz, lo + per);
  const int most = s_pad / WG_ROWS;
  auto count = [&](int i) { return min(most, (max(valid_len[i], 0) + WG_ROWS - 1) / WG_ROWS); };
  int mine = 0;
  for (int i = lo; i < hi; ++i) mine += count(i);
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  int run = incl - mine;
  for (int i = lo; i < hi; ++i) {
    first[i] = run;
    run += count(i);
  }
  if (lane == 31) first[bsz] = incl;
}

// first row of computed tile idx of the list (first[lo] <= idx < first[lo + 1])
__device__ __forceinline__ size_t tile_row(const int* first, int bsz, int s_pad, int idx) {
  int lo = 0, hi = bsz;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (first[mid] <= idx) lo = mid;
    else hi = mid;
  }
  return (size_t)lo * s_pad + (size_t)(idx - first[lo]) * WG_ROWS;
}

template <int TN, int TK>
__global__ void __launch_bounds__(wgrad_threads<TN, TK>(), 2)
linear_wgrad_stream_kernel(const float* __restrict__ dy, const float* __restrict__ x,
                           float* __restrict__ partial, const int* __restrict__ valid_len,
                           int N, int K, int s_pad, int bsz) {
  constexpr int WARPS_K = TK / 64, WG_THREADS = wgrad_threads<TN, TK>();
  constexpr int Y_STAGE = WG_ROWS * TN, X_STAGE = WG_ROWS * TK, STAGE = Y_STAGE + X_STAGE;
  static_assert(TN % WG_WN == 0 && TK % 64 == 0 && TN <= WG_THREADS, "wgrad tile shape");
  extern __shared__ __align__(16) float wg_smem[];
  __shared__ int first[WG_MAX_IMAGES + 1];  // index of each image's first computed tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp / WARPS_K, wk = warp % WARPS_K, ln = lane >> 3, lk = lane & 7;
  const int na = wn * WG_WN + ln * 4, ka = wk * 64 + lk * 4;  // the thread's first n, k
  if (warp == 0) list_tiles(first, valid_len, bsz, s_pad);
  __syncthreads();
  // this block's share [ub, ub + units) of the T x C units, C the computed tiles
  const int n32 = first[bsz], ktiles = K / TK;
  const long long total = (long long)(N / TN) * ktiles * n32;
  const int ub = (int)(blockIdx.x * total / gridDim.x);
  const int units = (int)((blockIdx.x + 1) * total / gridDim.x) - ub;
  auto load = [&](int s, int slot) {  // unit ub + s: dY's and X's columns of its tile
    const int u = ub + s, t = u / n32, n0 = t / ktiles * TN, k0 = t % ktiles * TK;
    const size_t row0 = tile_row(first, bsz, s_pad, u - t * n32);
    float* ys = wg_smem + slot * STAGE;
    float* xs = ys + Y_STAGE;
    for (int c = tid; c < Y_STAGE / 4; c += WG_THREADS) {
      const int r = c / (TN / 4), cc = c % (TN / 4) * 4;
      sgemm::cp_async_16(ys + r * TN + cc, dy + (row0 + r) * N + n0 + cc);
    }
    for (int c = tid; c < X_STAGE / 4; c += WG_THREADS) {
      const int r = c / (TK / 4), cc = c % (TK / 4) * 4;
      sgemm::cp_async_16(xs + r * TK + cc, x + (row0 + r) * K + k0 + cc);
    }
  };

  float acc[WG_TM][8], db = 0.f;
#pragma unroll
  for (int i = 0; i < WG_TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  sgemm::ring<WG_STAGES>(units, load, [&](int s, int slot) {
    const int u = ub + s, t = u / n32;
    const float* ys = wg_smem + slot * STAGE;
    const float* xs = ys + Y_STAGE;
    const bool col_sums = t % ktiles == 0;  // db, in the segments of the first K tile
    if (col_sums && tid < TN)
#pragma unroll 8
      for (int m = 0; m < WG_ROWS; ++m) db += ys[m * TN + tid];
#pragma unroll 8
    for (int m = 0; m < WG_ROWS; ++m) {
      float yv[WG_TM], xv[8];
      *reinterpret_cast<float4*>(yv) = load4(ys + m * TN + na);
      *reinterpret_cast<float4*>(yv + 4) = load4(ys + m * TN + na + 16);
      *reinterpret_cast<float4*>(xv) = load4(xs + m * TK + ka);
      *reinterpret_cast<float4*>(xv + 4) = load4(xs + m * TK + ka + 32);
      sgemm::outer(acc, yv, xv);
    }
    if (s + 1 < units && (u + 1) % n32 != 0) return;  // the segment goes on
    // the segment's last unit: its partial into slot tile + block, then zeros
    float* p = partial + (size_t)(t + blockIdx.x) * wgrad_slot<TN, TK>();
#pragma unroll
    for (int i = 0; i < WG_TM; ++i) {
      const int n = na + (i & 3) + (i >> 2) * 16;
      *reinterpret_cast<float4*>(p + n * TK + ka) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(p + n * TK + ka + 32) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    if (col_sums && tid < TN) p[TN * TK + tid] = db;
    db = 0.f;
  });
}

// X' = LN1(x) of the QKV site at width K from the saved row stats, into h:
// one warp a row, four columns a lane at a time, h = fmaf((x - mean) rstd, g,
// beta) as the forward's h. The zero-filled tiles' rows are not written.
template <int K>
__global__ void __launch_bounds__(NT)
ln_rows_saved_f32_kernel(const float* __restrict__ x, const float* __restrict__ mean,
                         const float* __restrict__ rstd, const float* __restrict__ g,
                         const float* __restrict__ beta, float* __restrict__ h,
                         const int* __restrict__ valid_len, int M, int s_pad) {
  const int lane = threadIdx.x & 31, warps = gridDim.x * (NT / 32);
  for (int row = blockIdx.x * (NT / 32) + threadIdx.x / 32; row < M; row += warps) {
    if (tile_is_padding(row / BM * BM, s_pad, valid_len)) continue;  // uniform in the warp
    const float mu = mean[row], rs = rstd[row];
#pragma unroll
    for (int c = lane * 4; c < K; c += 128) {
      const float4 v = *reinterpret_cast<const float4*>(x + (size_t)row * K + c);
      const float4 gg = *reinterpret_cast<const float4*>(g + c);
      const float4 bb = *reinterpret_cast<const float4*>(beta + c);
      float4 o;
      o.x = fmaf(__fmul_rn(__fsub_rn(v.x, mu), rs), gg.x, bb.x);
      o.y = fmaf(__fmul_rn(__fsub_rn(v.y, mu), rs), gg.y, bb.y);
      o.z = fmaf(__fmul_rn(__fsub_rn(v.z, mu), rs), gg.z, bb.z);
      o.w = fmaf(__fmul_rn(__fsub_rn(v.w, mu), rs), gg.w, bb.w);
      *reinterpret_cast<float4*>(h + (size_t)row * K + c) = o;
    }
  }
}

// dwb (N K + N) = each tile's segment partials added in block order, four
// outputs a thread. Tile t's units [t C, t C + C) lie in the shares of blocks
// b(t C) .. b(t C + C - 1), b(u) = ((u + 1) G - 1) / U the block whose share
// holds unit u (U = T C units, G blocks); blocks with an empty share are
// skipped. No units (C = 0): zeros.
template <int TN, int TK>
__global__ void __launch_bounds__(NT)
reduce_wgrad_stream_kernel(const float* __restrict__ partial, float* __restrict__ dwb,
                           const int* __restrict__ valid_len, int N, int K, int s_pad, int bsz,
                           int blocks) {
  __shared__ int n32;
  if (threadIdx.x < 32) {
    int n = 0;
    for (int i = threadIdx.x; i < bsz; i += 32)
      n += min(s_pad / WG_ROWS, (max(valid_len[i], 0) + WG_ROWS - 1) / WG_ROWS);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
    if (threadIdx.x == 0) n32 = n;
  }
  __syncthreads();
  const int e = 4 * (blockIdx.x * NT + threadIdx.x);
  if (e >= N * K + N) return;
  const int ktiles = K / TK;
  int t, off;
  if (e < N * K) {
    const int n = e / K, k = e % K;
    t = n / TN * ktiles + k / TK;
    off = n % TN * TK + k % TK;
  } else {
    const int n = e - N * K;
    t = n / TN * ktiles;
    off = TN * TK + n % TN;
  }
  const long long C = n32, G = blocks, U = (long long)(N / TN) * ktiles * C;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  if (U > 0) {
    const int bf = (int)(((t * C + 1) * G - 1) / U), bl = (int)(((t * C + C) * G - 1) / U);
    for (int b = bf; b <= bl; ++b) {
      if (b * U / G == (b + 1) * U / G) continue;  // a block with no units
      const float4 v = *reinterpret_cast<const float4*>(
          partial + (size_t)(t + b) * wgrad_slot<TN, TK>() + off);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
  }
  *reinterpret_cast<float4*>(dwb + e) = sum;
}

// ---- linear_dgrad at D 768 (float32): a stream-K walk over the card --------
// The same products as linear_dgrad_kernel (the same lines of the TPU kernel),
// at ChAdaViT-B/16's four sites. There a grid of one block a (32-row tile,
// column slice) leaves the card partly empty: three blocks an SM make 396
// places, and at the narrow B/16 rows the out-projection's 110 x 4 computed
// tiles take 1.11 waves (at the 3-channel bucket's rows its 64 x 4 fill 0.65
// of the card). So the work is cut along K as well:
// - a unit is one computed 32-row tile x one column slice (BN = 192, or 256
//   of hid's 2048 at the mask site) x one slab of DG_SLAB columns of K; the
//   units of every output tile (tile t = computed tile i x slices + slice),
//   tile-major, are cut into gridDim.x contiguous, near-equal shares, one a
//   block, the grid being as many blocks as the card holds at the kernel's
//   occupancy (dgrad_stream_blocks);
// - a block walks its share through linear_dgrad_kernel's ring and loop (8 x
//   8 sums a thread, sgemm::outer4), one stage of DG_BK columns of K at a
//   time, the stages running on across a change of output tile; at the end of
//   each tile segment it applies the epilogue and writes dX when its segment
//   is the whole tile, and otherwise writes the segment's sums into slot tile
//   + block, then starts from zero;
// - reduce_dgrad_stream_kernel adds each split tile's slots in block order,
//   applies the epilogue and writes dX, and writes the zero-filled tiles'
//   zeros: no atomics, the same bits on every run. The scratch is at most
//   tiles + blocks - 1 slots of 32 x BN;
// - the list of computed 32-row tiles (dgrad_list_kernel) is built once, into
//   a small scratch that both passes read; each block keeps a cursor over
//   its stages for its copies and one for its products, so that no stage
//   waits on the list or divides (reading the list at every stage made the
//   four sites 7 % slower, PERF.md).
// dX's sums run in another order than linear_dgrad_kernel's where a tile is
// split (each segment in K order, the segments in block order). Measured and
// not kept (scripts/bench_linear_f32.py d768, PERF.md): whole waves of tiles
// before a walk of the rest, the slices' tiles in turn, and the split tiles
// added by the block whose part arrives last were each slower; slabs of 16
// columns of K ran 1 % faster than 32 or 64.
constexpr int DG_SLAB = 16;  // columns of K a unit (fused_block.DGRAD_F32_SLAB)

constexpr int DG_STREAM_WAVES = 3;  // blocks an SM the loop is built for

// list[0 .. bsz]: image i's first entry in the list of computed 32-row tiles
// (list[bsz] their count); list[bsz + 1 + j]: the first row of entry j
__global__ void __launch_bounds__(NT)
dgrad_list_kernel(const int* __restrict__ valid_len, int* __restrict__ list, int bsz,
                  int s_pad) {
  __shared__ int first[WG_MAX_IMAGES + 1];
  if (threadIdx.x < 32) list_tiles(first, valid_len, bsz, s_pad);
  __syncthreads();
  for (int i = threadIdx.x; i <= bsz; i += NT) list[i] = first[i];
  for (int i = threadIdx.x; i < bsz; i += NT)
    for (int j = first[i]; j < first[i + 1]; ++j)
      list[bsz + 1 + j] = i * s_pad + (j - first[i]) * BM;
}

template <int EPI>
__device__ __forceinline__ void dgrad_finish(float4 v, const float* __restrict__ aux,
                                             float* __restrict__ out, size_t o) {
  if constexpr (EPI == EPI_RELU_MASK) {
    const float4 h = load4(aux + o);
    v.x = h.x > 0.f ? v.x : 0.f;
    v.y = h.y > 0.f ? v.y : 0.f;
    v.z = h.z > 0.f ? v.z : 0.f;
    v.w = h.w > 0.f ? v.w : 0.f;
  } else if constexpr (EPI == EPI_RESIDUAL) {
    const float4 r = load4(aux + o);
    v = make_float4(r.x + v.x, r.y + v.y, r.z + v.z, r.w + v.w);
  }
  *reinterpret_cast<float4*>(out + o) = v;
}

template <int BN, int EPI>
__global__ void __launch_bounds__(BN / DG_WN * 32, DG_STREAM_WAVES)
linear_dgrad_stream_kernel(const float* __restrict__ dy, const float* __restrict__ w,
                           const float* __restrict__ aux, float* __restrict__ out,
                           float* __restrict__ partial, const int* __restrict__ list, int bsz,
                           int K, int N) {
  constexpr int THREADS = BN / DG_WN * 32, STAGE = dgrad_stage<BN>();
  constexpr int PER_UNIT = DG_SLAB / DG_BK;  // ring stages a unit
  static_assert(BN % DG_WN == 0 && BM == 4 * DG_TM && DG_SLAB % DG_BK == 0,
                "linear_dgrad tile shape");
  extern __shared__ __align__(16) float dg_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = lane >> 3, tx = lane & 7, wc = warp * DG_WN;
  const int* rows = list + bsz + 1;
  const int slices = N / BN, per_tile = K / DG_BK;  // ring stages a tile
  const int tiles = list[bsz] * slices;
  const long long total = (long long)tiles * (K / DG_SLAB);
  const int ub = (int)(blockIdx.x * total / gridDim.x);
  const int units = (int)((blockIdx.x + 1) * total / gridDim.x) - ub;
  const int s0 = ub * PER_UNIT, n = units * PER_UNIT;  // the share's first stage, its stages
  // Two cursors over the block's stages, one for the copies and one for the
  // products, each moved one stage a call (the ring calls load and compute
  // with s in order): stage kk of output tile t (row entry t / slices, slice
  // t % slices), whose first row m0 is read from the list once a tile
  struct Cursor {
    int kk, t, n0;
    size_t m0;
  };
  auto at = [&](Cursor& c, int t, int kk) {
    c.t = t;
    c.kk = kk;
    if (t < tiles) {
      const int i = t / slices;
      c.m0 = rows[i];
      c.n0 = (t - i * slices) * BN;
    }
  };
  Cursor cl;
  at(cl, s0 / per_tile, s0 % per_tile);
  Cursor cc = cl;
  auto advance = [&](Cursor& c) {
    if (++c.kk < per_tile) return;
    at(c, c.t + 1, 0);
  };
  auto load = [&](int, int slot) {  // the copy cursor's stage: K columns [k0, k0 + BK) of its tile
    const int k0 = cl.kk * DG_BK, n0 = cl.n0;
    const size_t m0 = cl.m0;
    advance(cl);
    float* as = dg_smem + slot * STAGE;
    float* ws = as + BM * DG_LDA;
    for (int c = tid; c < BM * DG_BK / 4; c += THREADS) {
      const int r = c / (DG_BK / 4), cc = c % (DG_BK / 4) * 4;
      sgemm::cp_async_16(as + r * DG_LDA + cc, dy + (m0 + r) * K + k0 + cc);
    }
#pragma unroll
    for (int q = 0; q < DG_BK * BN / 4 / THREADS; ++q) {
      const int c = tid + q * THREADS;
      const int r = c / (BN / 4), cc = c % (BN / 4) * 4;
      sgemm::cp_async_16(ws + r * BN + cc, w + (size_t)(k0 + r) * N + n0 + cc);
    }
  };
  float acc[DG_TM][DG_TN];
#pragma unroll
  for (int i = 0; i < DG_TM; ++i)
#pragma unroll
    for (int j = 0; j < DG_TN; ++j) acc[i][j] = 0.f;
  sgemm::ring<DG_STAGES>(n, load, [&](int s, int slot) {
    const float* as = dg_smem + slot * STAGE + ty * DG_LDA;
    const float* ws = dg_smem + slot * STAGE + BM * DG_LDA + wc + 4 * tx;
#pragma unroll
    for (int kk = 0; kk < DG_BK; kk += 4) {
      float4 av[DG_TM];
      float bv[4][DG_TN];
#pragma unroll
      for (int i = 0; i < DG_TM; ++i) av[i] = load4(as + i * 4 * DG_LDA + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        *reinterpret_cast<float4*>(bv[q]) = load4(ws + (kk + q) * BN);
        *reinterpret_cast<float4*>(bv[q] + 4) = load4(ws + (kk + q) * BN + 32);
      }
      sgemm::outer4(acc, av, bv);
    }
    const Cursor c = cc;
    advance(cc);
    const bool last = c.kk == per_tile - 1;  // the tile's last stage
    if (!last && s + 1 < n) return;  // the segment goes on
    const int t = c.t;
    if (last && t * per_tile >= s0) {  // the whole tile: dX
      const size_t m0 = c.m0;
      const int n0 = c.n0;
#pragma unroll
      for (int i2 = 0; i2 < DG_TM; ++i2)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          dgrad_finish<EPI>(make_float4(acc[i2][4 * h], acc[i2][4 * h + 1], acc[i2][4 * h + 2],
                                        acc[i2][4 * h + 3]),
                            aux, out, (m0 + ty + 4 * i2) * N + n0 + wc + 4 * tx + 32 * h);
    } else {  // a part of it: its sums into slot t + block
      float* p = partial + (size_t)(t + blockIdx.x) * BM * BN;
#pragma unroll
      for (int i2 = 0; i2 < DG_TM; ++i2)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float4*>(p + (ty + 4 * i2) * BN + wc + 4 * tx + 32 * h) =
              make_float4(acc[i2][4 * h], acc[i2][4 * h + 1], acc[i2][4 * h + 2],
                          acc[i2][4 * h + 3]);
    }
#pragma unroll
    for (int i2 = 0; i2 < DG_TM; ++i2)
#pragma unroll
      for (int j = 0; j < DG_TN; ++j) acc[i2][j] = 0.f;
  });
}

// dX of the tiles the walk split, grid (M / 32, N / BN): each split tile's
// slots added in block order, four outputs a thread, then the epilogue;
// zeros on the zero-filled tiles. Tile t's units [t S, t S + S) (S slabs a
// tile) lie in the shares of blocks b(t S) .. b(t S + S - 1), b(u) = ((u + 1)
// G - 1) / U the block whose share holds unit u (U units, G blocks); one
// block: the walk wrote the tile. Blocks with an empty share are skipped.
template <int BN, int EPI>
__global__ void __launch_bounds__(NT)
reduce_dgrad_stream_kernel(const float* __restrict__ partial, const float* __restrict__ aux,
                           float* __restrict__ out, const int* __restrict__ list,
                           const int* __restrict__ valid_len, int bsz, int K, int N, int s_pad,
                           int blocks) {
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  if (tile_is_padding(m0, s_pad, valid_len)) {
    for (int c = threadIdx.x; c < BM * BN / 4; c += NT)
      *reinterpret_cast<float4*>(out + (size_t)(m0 + c / (BN / 4)) * N + n0 + c % (BN / 4) * 4) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const int b = m0 / s_pad, slices = N / BN;
  const long long S = K / DG_SLAB, G = blocks;
  const long long t = (long long)(list[b] + (m0 - b * s_pad) / BM) * slices + blockIdx.y;
  const long long U = (long long)list[bsz] * slices * S;
  const int bf = (int)(((t * S + 1) * G - 1) / U), bl = (int)(((t * S + S) * G - 1) / U);
  if (bf == bl) return;
  for (int c = threadIdx.x; c < BM * BN / 4; c += NT) {
    const int r = c / (BN / 4), cc = c % (BN / 4) * 4;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = bf; q <= bl; ++q) {
      if (q * U / G == (q + 1) * U / G) continue;  // a block with no units
      const float4 v = load4(partial + (size_t)(t + q) * BM * BN + r * BN + cc);
      sum = make_float4(sum.x + v.x, sum.y + v.y, sum.z + v.z, sum.w + v.w);
    }
    dgrad_finish<EPI>(sum, aux, out, (size_t)(m0 + r) * N + n0 + cc);
  }
}

// The walk's grid: as many blocks as the card holds at the kernel's occupancy
// (the SMs of the current device times the blocks an SM, as the runtime
// reports them for this kernel, block and shared memory); or minus a
// cudaError.
template <int BN, int EPI>
int dgrad_stream_blocks() {
  constexpr int smem = dgrad_smem<BN>();
  auto kernel = linear_dgrad_stream_kernel<BN, EPI>;
  int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == 0) e = (int)cudaGetDevice(&dev);
  if (e == 0) e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == 0)
    e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BN / DG_WN * 32,
                                                           smem);
  return e != 0 ? -e : sms * per_sm;
}

// the three passes of the walk at one site: the tile list, the walk over the
// card, the split tiles' sums
template <int BN, int EPI>
int dgrad_stream_launch(const float* dy, const float* w, const float* aux, float* out,
                        float* partial, int slots, int* list, const int* valid_len, int M, int K,
                        int N, int s_pad, cudaStream_t st) {
  constexpr int smem = dgrad_smem<BN>();
  const int blocks = dgrad_stream_blocks<BN, EPI>(), bsz = M / s_pad;
  if (blocks < 0) return -blocks;
  if (blocks == 0 || (long long)(M / BM) * (N / BN) + blocks - 1 > slots || bsz > WG_MAX_IMAGES)
    return (int)cudaErrorInvalidValue;
  dgrad_list_kernel<<<1, NT, 0, st>>>(valid_len, list, bsz, s_pad);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  linear_dgrad_stream_kernel<BN, EPI><<<blocks, BN / DG_WN * 32, smem, st>>>(
      dy, w, aux, out, partial, list, bsz, K, N);
  if ((e = (int)cudaGetLastError()) != 0) return e;
  reduce_dgrad_stream_kernel<BN, EPI><<<dim3(M / BM, N / BN), NT, 0, st>>>(
      partial, aux, out, list, valid_len, bsz, K, N, s_pad, blocks);
  return (int)cudaGetLastError();
}

template <typename T>
int layernorm_bwd_launch(const T* dy, const T* xin, const float* mean,
                         const float* rstd, const float* g, const T* res, T* dx,
                         float* partial, float* dgb, int accumulate,
                         const int* valid_len, int M, int N, int s_pad, int splits,
                         void* stream) {
  if (!rows_ok(M, BK, s_pad) || !is_width(N) || splits < 1 || splits > M / BM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto kernel, auto reduce, int d) {
    kernel<<<splits, NT, 0, st>>>(dy, xin, mean, rstd, g, res, dx, partial, valid_len, s_pad,
                                   M / BM, splits);
    int e = (int)cudaGetLastError();
    if (e != 0) return e;
    reduce<<<2 * d / 32, LN_RED_WARPS * 32, 0, st>>>(partial, dgb, splits, accumulate);
    return (int)cudaGetLastError();
  };
  if (N == D_MODEL)
    return run(layernorm_bwd_kernel<D_MODEL, T>, reduce_ln_splits_kernel<D_MODEL>, D_MODEL);
  if (N == D_SMALL)
    return run(layernorm_bwd_kernel<D_SMALL, T>, reduce_ln_splits_kernel<D_SMALL>, D_SMALL);
  if constexpr (std::is_same<T, bf16>::value) {  // the 16-byte row pass
    const void* ptrs[5] = {dy, xin, g, res, dx};
    for (const void* ptr : ptrs)
      if (reinterpret_cast<uintptr_t>(ptr) % 16) return (int)cudaErrorInvalidValue;
    auto kernel = res != nullptr ? layernorm_bwd_wide_bf16_kernel<true>
                                 : layernorm_bwd_wide_bf16_kernel<false>;
    int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      LNW_SMEM);
    if (e != 0) return e;
    kernel<<<splits, NT, LNW_SMEM, st>>>(dy, xin, mean, rstd, g, res, dx, partial, valid_len,
                                          s_pad, M / BM, splits);
    if ((e = (int)cudaGetLastError()) != 0) return e;
    reduce_ln_splits_kernel<D_WIDE><<<2 * D_WIDE / 32, LN_RED_WARPS * 32, 0, st>>>(
        partial, dgb, splits, accumulate);
    return (int)cudaGetLastError();
  } else {
    return run(layernorm_bwd_kernel<D_WIDE, T>, reduce_ln_splits_kernel<D_WIDE>, D_WIDE);
  }
}

template <int BN, int EPI, int SPLIT>
int dgrad_launch(const float* dy, const float* w, const float* aux, float* out,
                 const int* valid_len, int M, int K, int N, int s_pad, cudaStream_t st) {
  constexpr int smem = dgrad_smem<BN>();
  if (K % (SPLIT * DG_BK)) return (int)cudaErrorInvalidValue;  // whole K slices a block
  auto kernel = linear_dgrad_kernel<BN, EPI, SPLIT>;
  int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != 0) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(M / BM * SPLIT, N / BN);
  cfg.blockDim = dim3(BN / DG_WN * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SPLIT;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = (int)cudaLaunchKernelEx(&cfg, kernel, dy, w, aux, out, valid_len, K, N, s_pad);
  if (e != 0) return e;
  return (int)cudaGetLastError();
}

template <int TN, int TK>
int wgrad_launch(const float* dy, const float* x, const float* mean, const float* rstd,
                 const float* g, const float* beta, float* partial, const int* valid_len,
                 int N, int K, int s_pad, int bsz, int splits, cudaStream_t st) {
  constexpr int smem = wgrad_smem<TN, TK>();
  const dim3 grid(N / TN * (K / TK), splits);
  auto launch = [&](auto kernel) {
    int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      smem);
    if (e != 0) return e;
    kernel<<<grid, wgrad_threads<TN, TK>(), smem, st>>>(dy, x, mean, rstd, g, beta, partial,
                                                        valid_len, N, K, s_pad, bsz, splits);
    return (int)cudaGetLastError();
  };
  if (mean != nullptr) return launch(linear_wgrad_kernel<TN, TK, true>);
  return launch(linear_wgrad_kernel<TN, TK, false>);
}

// both passes of the stream-K walk at D 768 over a grid of `blocks`
template <int TN, int TK>
int wgrad_stream_launch(const float* dy, const float* x, float* partial, float* dwb,
                        const int* valid_len, int N, int K, int s_pad, int bsz, int blocks,
                        cudaStream_t st) {
  constexpr int smem = wgrad_stream_smem<TN, TK>();
  auto kernel = linear_wgrad_stream_kernel<TN, TK>;
  int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != 0) return e;
  kernel<<<blocks, wgrad_threads<TN, TK>(), smem, st>>>(dy, x, partial, valid_len, N, K, s_pad,
                                                        bsz);
  if ((e = (int)cudaGetLastError()) != 0) return e;
  const int n_out4 = (N * K + N) / 4;
  reduce_wgrad_stream_kernel<TN, TK><<<(n_out4 + NT - 1) / NT, NT, 0, st>>>(
      partial, dwb, valid_len, N, K, s_pad, bsz, blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// The float entry points keep their names; layernorm_bwd_bf16 takes the same
// arguments, with every activation pointer to bf16 and the LN parameters,
// stats, scratch and gradients still f32. linear_dgrad_bf16 and
// linear_wgrad_bf16 are in linear_bwd_bf16.cu.
extern "C" {

// dy, xin, dx (and res, when not null): (M, N), N 192, 768 or 64; mean, rstd:
// (M,); partial: (splits, 2 N) scratch, 1 <= splits <= M / 32; dgb: (2 N,) =
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
// (M, N). The sites of one layer of width D (192 or 64): K D -> N 2048
// (mask), K 2048 -> N D (residual), K D -> N D and K 3 D -> N D (none); at
// D 64 the N D sites take one 64-column tile. The D 768 sites are
// linear_dgrad_d768's.
int linear_dgrad(const float* dy, const float* w, const float* aux, float* out,
                 int epilogue, const int* valid_len, int M, int K, int N,
                 int s_pad, void* stream) {
  if (!rows_ok(M, K, s_pad) || !is_weight_shape(K, N) || is_weight_shape_at(K, N, D_WIDE) ||
      (epilogue != EPI_NONE) != (aux != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == D_FFN && epilogue == EPI_RELU_MASK)  // FFN2 -> hid
    return dgrad_launch<256, EPI_RELU_MASK, 1>(dy, w, aux, out, valid_len, M, K, N, s_pad, st);
  if (N == D_SMALL) {  // D 64: tiles of 64 columns
    if (epilogue == EPI_RESIDUAL)  // FFN1 -> x2
      return dgrad_launch<D_SMALL, EPI_RESIDUAL, DG_SPLIT_FFN>(dy, w, aux, out, valid_len, M, K,
                                                               N, s_pad, st);
    if (K == 3 * N && epilogue == EPI_NONE)  // QKV
      return dgrad_launch<D_SMALL, EPI_NONE, DG_SPLIT_QKV>(dy, w, aux, out, valid_len, M, K, N,
                                                           s_pad, st);
    if (epilogue == EPI_NONE)  // out-projection
      return dgrad_launch<D_SMALL, EPI_NONE, 1>(dy, w, aux, out, valid_len, M, K, N, s_pad, st);
    return (int)cudaErrorInvalidValue;
  }
  if (N == D_MODEL && epilogue == EPI_RESIDUAL)  // FFN1 -> x2
    return dgrad_launch<D_MODEL, EPI_RESIDUAL, DG_SPLIT_FFN>(dy, w, aux, out, valid_len, M, K,
                                                             N, s_pad, st);
  if (N == D_MODEL && K == 3 * N && epilogue == EPI_NONE)  // QKV
    return dgrad_launch<D_MODEL, EPI_NONE, DG_SPLIT_QKV>(dy, w, aux, out, valid_len, M, K, N,
                                                         s_pad, st);
  if (N == D_MODEL && epilogue == EPI_NONE)  // out-projection
    return dgrad_launch<D_MODEL, EPI_NONE, 1>(dy, w, aux, out, valid_len, M, K, N, s_pad, st);
  return (int)cudaErrorInvalidValue;
}

// linear_dgrad at ChAdaViT-B/16's four sites (D 768), the stream-K walk over
// as many blocks as the card holds (linear_dgrad_d768_blocks); dy, w, aux,
// out and epilogue as linear_dgrad's. partial: (slots, 32 x BN) scratch, BN
// 256 at the mask site (N 2048) and 192 at the others, slots >= M / 32 x N /
// BN + blocks - 1; list: (M / s_pad + 1 + M / 32) int32 scratch. Every
// operand 16-byte aligned. Three launches: the tile list, the walk, the sums
// of the split tiles.
int linear_dgrad_d768(const float* dy, const float* w, const float* aux, float* out,
                      int epilogue, float* partial, int slots, int* list, const int* valid_len,
                      int M, int K, int N, int s_pad, void* stream) {
  if (!rows_ok(M, K, s_pad) || !is_weight_shape_at(K, N, D_WIDE) || K % DG_SLAB ||
      (epilogue != EPI_NONE) != (aux != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == D_FFN && epilogue == EPI_RELU_MASK)  // FFN2 -> hid
    return dgrad_stream_launch<256, EPI_RELU_MASK>(dy, w, aux, out, partial, slots, list,
                                                   valid_len, M, K, N, s_pad, st);
  if (N == D_WIDE && K == D_FFN && epilogue == EPI_RESIDUAL)  // FFN1 -> x2
    return dgrad_stream_launch<D_MODEL, EPI_RESIDUAL>(dy, w, aux, out, partial, slots, list,
                                                      valid_len, M, K, N, s_pad, st);
  if (N == D_WIDE && K != D_FFN && epilogue == EPI_NONE)  // out-projection, QKV
    return dgrad_stream_launch<D_MODEL, EPI_NONE>(dy, w, aux, out, partial, slots, list,
                                                  valid_len, M, K, N, s_pad, st);
  return (int)cudaErrorInvalidValue;
}

// The grid of linear_dgrad_d768 at a site (K, N, epilogue as its): the SMs
// of the current device times the blocks an SM its walk holds; or minus a
// cudaError.
int linear_dgrad_d768_blocks(int K, int N, int epilogue) {
  if (N == D_FFN && K == D_WIDE && epilogue == EPI_RELU_MASK)
    return dgrad_stream_blocks<256, EPI_RELU_MASK>();
  if (N == D_WIDE && K == D_FFN && epilogue == EPI_RESIDUAL)
    return dgrad_stream_blocks<D_MODEL, EPI_RESIDUAL>();
  if (N == D_WIDE && (K == D_WIDE || K == 3 * D_WIDE) && epilogue == EPI_NONE)
    return dgrad_stream_blocks<D_MODEL, EPI_NONE>();
  return -(int)cudaErrorInvalidValue;
}

// dy (M, N), x (M, K); dwb: (N * K + N,) = dW (N, K) row-major, then db (N,).
// With mean (not null; K 192 or 64 only), x is layer-normed with mean, rstd,
// g, beta as it is staged. partial: (splits, N * K + N) scratch, 1 <= splits
// <= 1024; the tile shapes and so the grid are those of
// ops/fused_block.py::WGRAD_F32_TILES. Every operand 16-byte aligned. The D
// 768 shapes are linear_wgrad_d768's.
int linear_wgrad(const float* dy, const float* x, const float* mean,
                 const float* rstd, const float* g, const float* beta,
                 float* partial, float* dwb, const int* valid_len, int M, int N,
                 int K, int s_pad, int splits, void* stream) {
  if (M <= 0 || s_pad <= 0 || s_pad % WG_ROWS || M % s_pad || M / s_pad > WG_MAX_IMAGES ||
      splits < 1 || splits > 1024 || !is_weight_shape(N, K) ||
      is_weight_shape_at(N, K, D_WIDE) || (mean != nullptr && !is_width(K)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bsz = M / s_pad;
  int e;
  if (is_weight_shape_at(N, K, D_SMALL)) {  // D 64: the whole 64-wide side
    if (K == D_FFN)  // FFN2: all 64 columns of dY, 128 of hid's
      e = wgrad_launch<D_SMALL, 128>(dy, x, mean, rstd, g, beta, partial, valid_len, N, K,
                                     s_pad, bsz, splits, st);
    else if (N == D_FFN)  // FFN1: 128 of dz1's columns, all 64 of x2's
      e = wgrad_launch<128, D_SMALL>(dy, x, mean, rstd, g, beta, partial, valid_len, N, K,
                                     s_pad, bsz, splits, st);
    else if (N == 3 * K)  // QKV: all 192 of dqkv's columns, all 64 of X's
      e = wgrad_launch<3 * D_SMALL, D_SMALL>(dy, x, mean, rstd, g, beta, partial, valid_len, N,
                                             K, s_pad, bsz, splits, st);
    else  // out-projection
      e = wgrad_launch<D_SMALL, D_SMALL>(dy, x, mean, rstd, g, beta, partial, valid_len, N, K,
                                         s_pad, bsz, splits, st);
  } else if (K == D_FFN)  // FFN2: all 192 columns of dY, 64 of hid's
    e = wgrad_launch<D_MODEL, 64>(dy, x, mean, rstd, g, beta, partial, valid_len, N, K, s_pad,
                                  bsz, splits, st);
  else  // QKV, out-projection, FFN1: 64 of dY's columns, all 192 of X's
    e = wgrad_launch<64, D_MODEL>(dy, x, mean, rstd, g, beta, partial, valid_len, N, K, s_pad,
                                  bsz, splits, st);
  if (e != 0) return e;
  const int n_out4 = (N * K + N) / 4;
  reduce_wgrad_splits_kernel<<<(n_out4 + NT - 1) / NT, NT, 0, st>>>(
      reinterpret_cast<const float4*>(partial), reinterpret_cast<float4*>(dwb), n_out4, splits);
  return (int)cudaGetLastError();
}

// linear_wgrad at ChAdaViT-B/16's four weight shapes (D 768), the stream-K
// walk over a grid of `blocks` (1..1024; ops/fused_block.py::WGRAD_F32_BLOCKS,
// two an SM); dy, x, mean, rstd, g, beta and dwb as linear_wgrad's, with
// mean (the QKV site) K 768 only: x is layer-normed into h (M, K) scratch
// first. Tiles: 192 of the D-wide side, 64 of the other
// (ops/fused_block.py::WGRAD_F32_STREAM_TILES); partial: (tiles + blocks - 1,
// TN x TK + TN) scratch, tiles = N / TN x K / TK. Every operand 16-byte
// aligned.
int linear_wgrad_d768(const float* dy, const float* x, const float* mean, const float* rstd,
                      const float* g, const float* beta, float* h, float* partial, float* dwb,
                      const int* valid_len, int M, int N, int K, int s_pad, int blocks,
                      void* stream) {
  if (M <= 0 || s_pad <= 0 || s_pad % WG_ROWS || M % s_pad || M / s_pad > WG_MAX_IMAGES ||
      blocks < 1 || blocks > 1024 || !is_weight_shape_at(N, K, D_WIDE) ||
      (mean != nullptr && (K != D_WIDE || h == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bsz = M / s_pad;
  const float* xs = x;
  if (mean != nullptr) {  // the QKV site: X' = LN1(x) from the saved stats
    ln_rows_saved_f32_kernel<D_WIDE><<<min((M + 7) / 8, 132 * 16), NT, 0, st>>>(
        x, mean, rstd, g, beta, h, valid_len, M, s_pad);
    const int e = (int)cudaGetLastError();
    if (e != 0) return e;
    xs = h;
  }
  if (K == D_FFN)  // FFN2: 192 of dY's columns, 64 of hid's
    return wgrad_stream_launch<D_MODEL, 64>(dy, xs, partial, dwb, valid_len, N, K, s_pad, bsz,
                                            blocks, st);
  // QKV, out-projection, FFN1: 64 of dY's columns, 192 of X's
  return wgrad_stream_launch<64, D_MODEL>(dy, xs, partial, dwb, valid_len, N, K, s_pad, bsz,
                                          blocks, st);
}

}  // extern "C"
