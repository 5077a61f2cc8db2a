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
// - the grid is output tiles x splits. A tile spans the 192-wide side of dW
//   whole (K at the QKV, out-projection and FFN1 sites, N at FFN2) and 64 of
//   the other, so the 2048-wide operand (dz1 or hid) is read from device
//   memory once; each of its 6 warps owns 32 x 64 of the tile, a thread 8 x 8
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
constexpr int WG_THREADS = 192;  // 6 warps
constexpr int WG_ROWS = BM;      // a stage: one 32-row tile of the contract
constexpr int WG_STAGES = 3;
constexpr int WG_MAX_IMAGES = 1024;
constexpr int WG_STATS = 2 * WG_ROWS;  // a stage's LN stats: mean, then rstd

template <int TN, int TK>
constexpr int wgrad_smem() {  // bytes of the ring: dY tile, X tile, stats
  return WG_STAGES * (WG_ROWS * (TN + TK) + WG_STATS) * 4;
}

template <int TN, int TK, bool LN_X>
__global__ void __launch_bounds__(WG_THREADS, 2)
linear_wgrad_kernel(const float* __restrict__ dy, const float* __restrict__ x,
                    const float* __restrict__ mean, const float* __restrict__ rstd,
                    const float* __restrict__ g, const float* __restrict__ beta,
                    float* __restrict__ partial, const int* __restrict__ valid_len, int N,
                    int K, int s_pad, int bsz, int splits) {
  constexpr int WARPS_K = TK / 64;
  constexpr int Y_STAGE = WG_ROWS * TN, X_STAGE = WG_ROWS * TK;
  constexpr int STAGE = Y_STAGE + X_STAGE + WG_STATS;
  static_assert(TN % WG_WN == 0 && TK % 64 == 0 && (TN / WG_WN) * WARPS_K * 32 == WG_THREADS,
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
    kernel<<<grid, WG_THREADS, smem, st>>>(dy, x, mean, rstd, g, beta, partial, valid_len, N,
                                           K, s_pad, bsz, splits);
    return (int)cudaGetLastError();
  };
  if (mean != nullptr) return launch(linear_wgrad_kernel<TN, TK, true>);
  return launch(linear_wgrad_kernel<TN, TK, false>);
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
  if (!rows_ok(M, K, s_pad) || !is_weight_shape(K, N) ||
      (epilogue != EPI_NONE) != (aux != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == D_FFN && epilogue == EPI_RELU_MASK)  // FFN2 -> hid
    return dgrad_launch<256, EPI_RELU_MASK, 1>(dy, w, aux, out, valid_len, M, K, N, s_pad, st);
  if (N == D_MODEL && epilogue == EPI_RESIDUAL)  // FFN1 -> x2
    return dgrad_launch<D_MODEL, EPI_RESIDUAL, DG_SPLIT_FFN>(dy, w, aux, out, valid_len, M, K,
                                                             N, s_pad, st);
  if (N == D_MODEL && K == 3 * D_MODEL && epilogue == EPI_NONE)  // QKV
    return dgrad_launch<D_MODEL, EPI_NONE, DG_SPLIT_QKV>(dy, w, aux, out, valid_len, M, K, N,
                                                         s_pad, st);
  if (N == D_MODEL && epilogue == EPI_NONE)  // out-projection
    return dgrad_launch<D_MODEL, EPI_NONE, 1>(dy, w, aux, out, valid_len, M, K, N, s_pad, st);
  return (int)cudaErrorInvalidValue;
}

// dy (M, N), x (M, K); dwb: (N * K + N,) = dW (N, K) row-major, then db (N,).
// With mean (not null; K 192 only), x is layer-normed with mean, rstd, g,
// beta as it is staged. partial: (splits, N * K + N) scratch, 1 <= splits
// <= 1024; the tile shapes and so the grid are those of
// ops/fused_block.py::WGRAD_F32_TILES. Every operand 16-byte aligned.
int linear_wgrad(const float* dy, const float* x, const float* mean,
                 const float* rstd, const float* g, const float* beta,
                 float* partial, float* dwb, const int* valid_len, int M, int N,
                 int K, int s_pad, int splits, void* stream) {
  if (M <= 0 || s_pad <= 0 || s_pad % WG_ROWS || M % s_pad || M / s_pad > WG_MAX_IMAGES ||
      splits < 1 || splits > 1024 || !is_weight_shape(N, K) ||
      (mean != nullptr && K != D_MODEL))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bsz = M / s_pad;
  int e;
  if (K == D_FFN)  // FFN2: the 192 columns of dY whole, 64 of hid's
    e = wgrad_launch<D_MODEL, 64>(dy, x, mean, rstd, g, beta, partial, valid_len, N, K, s_pad,
                                  bsz, splits, st);
  else  // QKV, out-projection, FFN1: 64 of dY's columns, the 192 of X whole
    e = wgrad_launch<64, D_MODEL>(dy, x, mean, rstd, g, beta, partial, valid_len, N, K, s_pad,
                                  bsz, splits, st);
  if (e != 0) return e;
  const int n_out4 = (N * K + N) / 4;
  reduce_wgrad_splits_kernel<<<(n_out4 + NT - 1) / NT, NT, 0, st>>>(
      reinterpret_cast<const float4*>(partial), reinterpret_cast<float4*>(dwb), n_out4, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
