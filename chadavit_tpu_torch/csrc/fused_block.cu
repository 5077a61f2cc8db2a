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
// (67 TFLOP/s of f32 FMA outside the tensor cores). All three are redesigned
// for Hopper on the shared main loop of sgemm_f32.cuh (their notes below):
// cp.async rings, register tiles of 48-64 sums a thread fed by 16-byte shared
// reads. ln_linear_fwd and linear_relu_fwd keep a block's 32 x 192 input rows
// resident in shared memory (ln_linear_fwd normalises them there once) and
// stream the weight through the ring; D = 192 fits one block's columns, so
// linear_residual_ln_fwd's LayerNorm epilogue stays in the block.
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
#include "sgemm_f32.cuh"

#include <cooperative_groups.h>

namespace {

// ---- ln_linear_fwd: out = LN(x) @ W^T + bias ---------------------------------
// float32 only (the bf16 instance is linear_fwd_bf16.cu's). Redesigned for
// Hopper's CUDA cores on the shared main loop of sgemm_f32.cuh.
//
// Replaces the LN1 + QKV step of the TPU kernel
// chadavit_tpu/ops/fused_block.py::_fwd_kernel (:91), lines :111-124: the
// fast-variance row stats (_stats, :68), h = (x - mu) rstd g1 + b1 and
// qkv = h @ Wqkv + bqkv.
//
// What bounds it: operations. At hub shapes it does 2.04 GFLOP on the rows it
// must compute (0.030 ms at 67 TFLOP/s of f32 FMA), against 0.011 ms of
// output bytes. The design is K1c's (linear_relu_fwd below):
// - a block owns one 32-row tile of the contract and LL_SLABS slabs of
//   LL_BN = 192 of Wqkv's 576 rows (the output's columns): as built one slab,
//   grid (M / 32, 3), at hub shapes 293 computed row tiles x 3 = 6.7 blocks of
//   work an SM. Its 32 x 192 x rows are copied by cp.async into shared memory
//   (rows padded to 196 floats), in a group of their own ahead of the ring's;
// - while the ring's first copies are in flight, the block takes the row
//   stats from that copy (row_stats, one warp a row, a warp's 8 rows at once)
//   and normalises the rows in place, once: the prologue is not applied again
//   per K slice;
// - Wqkv is staged as it lies (K contiguous), 16 columns of K a stage, by
//   16-byte cp.async copies into a ring of LL_STAGES = 3 slots (rows padded to
//   20 floats), one barrier a stage. 69.5 KB of shared memory, three blocks an
//   SM (12 warps: a sub-partition's registers give a thread at most 168). A
//   block that walks LL_SLABS > 1 slabs (a bench build) keeps one ring across
//   them, so the copy, the stats and the normalisation are paid once a walk;
// - each of the 4 warps takes 32 rows x 48 columns of a slab, a thread 8 x
//   LL_TN = 6 sums (rows ty + 4 i, columns tx + 8 j of its warp's), by
//   sgemm::dot4: 14 reads of 16 bytes feed 192 FMAs. 8 x 8 sums (3 warps)
//   need more registers than 168 and spill (scripts/bench_linear_f32.py).
// The bits are those of the first port's kernel (gemm_tile, which this step
// ran on before), which qkv, and through the attention hid, depend on: the
// stats in row_stats' order, the prologue as (x - mu) * rstd * g + beta, every
// sum from k = 0 upward with fmaf, then the bias. A 32-row tile wholly past
// valid_len is written as zeros over the block's columns, its stats too, and
// not read; the decision is the same for every thread of the block and taken
// before any barrier. LL_BN, LL_TN, LL_SLABS and LL_STAGES set the cut of N,
// the thread tile and the ring, and LL_NO_STATS leaves the stats out (mean
// 0, rstd 1: a diagnostic), so that scripts/bench_linear_f32.py can time
// other choices of the same source.
#ifndef LL_BN
#define LL_BN 192
#endif
#ifndef LL_TN
#define LL_TN 6
#endif
#ifndef LL_SLABS
#define LL_SLABS 1
#endif
#ifndef LL_STAGES
#define LL_STAGES 3
#endif
constexpr int LL_N = 3 * D_MODEL;    // qkv's columns
constexpr int LL_BK = 16;
constexpr int LL_LDW = LL_BK + 4;    // a staged Wqkv row, padded
constexpr int LL_LDX = D_MODEL + 4;  // a resident x row, padded
constexpr int LL_TM = 8;             // a thread's rows; LL_TN its columns
constexpr int LL_WARPS = LL_BN / (8 * LL_TN);  // 32 rows x 8 LL_TN columns a warp
constexpr int LL_THREADS = LL_WARPS * 32;
constexpr int LL_STAGE = LL_BN * LL_LDW;  // floats
constexpr int LL_SMEM = (BM * LL_LDX + LL_STAGES * LL_STAGE) * 4;
// blocks an SM by shared memory (227 KB, 1 KB of it reserved a block): the
// register budget follows from it
constexpr int LL_BLOCKS_SM = 232448 / (LL_SMEM + 1024) > 0 ? 232448 / (LL_SMEM + 1024) : 1;
static_assert(LL_BN % (8 * LL_TN) == 0 && BM == 4 * LL_TM &&
                  LL_N % (LL_SLABS * LL_BN) == 0 && LL_BN * LL_BK / 4 % LL_THREADS == 0,
              "ln_linear tile shape");

__global__ void __launch_bounds__(LL_THREADS, LL_BLOCKS_SM)
ln_linear_kernel(const float* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ beta, float eps, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ out,
                 float* __restrict__ mean_out, float* __restrict__ rstd_out,
                 const int* __restrict__ valid_len, int s_pad) {
  constexpr int K = D_MODEL, N = LL_N, KS = K / LL_BK;  // stages a slab
  constexpr int COLS = LL_SLABS * LL_BN;                 // the block's columns
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * COLS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool write_stats = mean_out != nullptr && blockIdx.y == 0;
  if (tile_is_padding(m0, s_pad, valid_len)) {  // uniform, before any barrier
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = tid; c < BM * COLS / 4; c += LL_THREADS) {
      const int r = c / (COLS / 4), cc = c % (COLS / 4) * 4;
      *reinterpret_cast<float4*>(out + (size_t)(m0 + r) * N + n0 + cc) = z;
    }
    if (write_stats)
      for (int r = tid; r < BM; r += LL_THREADS) {
        mean_out[m0 + r] = 0.f;
        rstd_out[m0 + r] = 0.f;
      }
    return;
  }
  extern __shared__ __align__(16) float ll_smem[];
  __shared__ float s_mu[BM], s_rstd[BM];
  float* xs = ll_smem;                 // the block's x rows, resident, then LN1(x)
  float* ring = xs + BM * LL_LDX;
  const int ty = lane >> 3, tx = lane & 7, wc = warp * 8 * LL_TN;

  for (int c = tid; c < BM * K / 4; c += LL_THREADS) {
    const int r = c / (K / 4), cc = c % (K / 4) * 4;
    sgemm::cp_async_16(xs + r * LL_LDX + cc, x + (size_t)(m0 + r) * K + cc);
  }
  sgemm::cp_async_commit();  // the x rows: a group of their own, ahead of the ring's
  auto load = [&](int s, int slot) {  // slab s / KS, K columns [(s % KS) BK, + BK)
    float* ws = ring + slot * LL_STAGE;
    const float* src = w + (size_t)(n0 + s / KS * LL_BN) * K + s % KS * LL_BK;
#pragma unroll
    for (int q = 0; q < LL_BN * LL_BK / 4 / LL_THREADS; ++q) {
      const int c = tid + q * LL_THREADS;
      const int r = c / (LL_BK / 4), cc = c % (LL_BK / 4) * 4;
      sgemm::cp_async_16(ws + r * LL_LDW + cc, src + (size_t)r * K + cc);
    }
  };
  auto head = [&] {  // while the ring's first stages are in flight
    sgemm::cp_async_wait<LL_STAGES - 1>();  // the x rows have landed for this thread
    __syncthreads();                        // and for every thread
#ifndef LL_NO_STATS
    row_stats<LL_WARPS>(xs, LL_LDX, K, 0, eps, s_mu, s_rstd);
#else
    if (tid < BM) s_mu[tid] = 0.f, s_rstd[tid] = 1.f;
#endif
    __syncthreads();
    if (write_stats)
      for (int r = tid; r < BM; r += LL_THREADS) {
        mean_out[m0 + r] = s_mu[r];
        rstd_out[m0 + r] = s_rstd[r];
      }
    for (int c = tid; c < BM * K / 4; c += LL_THREADS) {  // LN1 in place, once
      const int r = c / (K / 4), k = c % (K / 4) * 4;
      float* p = xs + r * LL_LDX + k;
      const float4 v = load4(p), gv = load4(g + k), bv = load4(beta + k);
      const float mu = s_mu[r], rs = s_rstd[r];
      *reinterpret_cast<float4*>(p) =
          make_float4((v.x - mu) * rs * gv.x + bv.x, (v.y - mu) * rs * gv.y + bv.y,
                      (v.z - mu) * rs * gv.z + bv.z, (v.w - mu) * rs * gv.w + bv.w);
    }
    // the ring's first barrier makes the normalised rows visible to every warp
  };
  float acc[LL_TM][LL_TN] = {};
  sgemm::ring<LL_STAGES>(LL_SLABS * KS, load, [&](int s, int slot) {
    const int ks = s % KS;
    if (ks == 0)
#pragma unroll
      for (int i = 0; i < LL_TM; ++i)
#pragma unroll
        for (int j = 0; j < LL_TN; ++j) acc[i][j] = 0.f;
    const float* as = xs + ty * LL_LDX + ks * LL_BK;
    const float* ws = ring + slot * LL_STAGE + (wc + tx) * LL_LDW;
#pragma unroll
    for (int kk = 0; kk < LL_BK; kk += 4) {
      float4 av[LL_TM];
#pragma unroll
      for (int i = 0; i < LL_TM; ++i) av[i] = load4(as + i * 4 * LL_LDX + kk);
#pragma unroll
      for (int j = 0; j < LL_TN; ++j) sgemm::dot4(acc, j, av, load4(ws + j * 8 * LL_LDW + kk));
    }
    if (ks == KS - 1) {  // the slab's sums are whole: then the bias
      const int nc = n0 + s / KS * LL_BN + wc + tx;
#pragma unroll
      for (int j = 0; j < LL_TN; ++j) {
        const float bj = bias[nc + 8 * j];
#pragma unroll
        for (int i = 0; i < LL_TM; ++i)
          out[(size_t)(m0 + ty + 4 * i) * N + nc + 8 * j] = acc[i][j] + bj;
      }
    }
  }, head);
}

// ---- linear_relu_fwd: out = relu(x @ W^T + bias) ----------------------------
// float32 only (the bf16 instance is linear_fwd_bf16.cu's). Redesigned for
// Hopper's CUDA cores on the shared main loop of sgemm_f32.cuh.
//
// Replaces the FFN1 step of the TPU kernel
// chadavit_tpu/ops/fused_block.py::_fwd_kernel (:91), lines :172-173:
// hid = relu(x2 @ W1 + b1).
//
// What bounds it: operations. At hub shapes it does 7.4 GFLOP on the rows it
// must compute (0.11 ms at 67 TFLOP/s of f32 FMA), against 0.023 ms of output
// bytes. The design keeps the FMA units fed from shared memory:
// - a block owns one 32-row tile of the contract and one slab of 256 of W1's
//   2048 rows (the output's columns): grid (M / 32, 8), at hub shapes 293
//   computed row tiles x 8 = 17.8 blocks of work an SM. Its 32 x 192 x rows
//   stay resident in shared memory (rows padded to 196 floats), copied with
//   the ring's first stage;
// - W1 is staged as it lies (K contiguous), 16 columns of K a stage, by
//   16-byte cp.async copies into a ring of LR_STAGES = 3 slots (rows padded
//   to 20 floats, so the 8 rows a quarter warp reads lie in distinct banks),
//   one barrier a stage. 84.5 KB of shared memory, two blocks an SM. A block
//   that walks LR_SLABS > 1 slabs (the bench's builds) keeps one ring across
//   them, so the x copy and the ring's prologue are paid once a walk; at hub
//   shapes one slab is the fastest (scripts/bench_linear_f32.py: more blocks
//   even out the SMs);
// - each of the 4 warps takes 32 rows x 64 columns of a slab, a thread 8 x 8
//   sums (rows ty + 4 i, columns tx + 8 j of its warp's), reading a float4 of
//   each of its 8 x rows (a quarter warp reads one row: a broadcast) and of
//   its 8 W1 rows over four k: 16 reads of 16 bytes feed 256 FMAs
//   (sgemm::dot4);
// - every sum runs from k = 0 upward with fmaf, then the bias is added and
//   then fmaxf(., 0): the order of the first port's gemm_tile, which this
//   step ran on before, so hid keeps its bits; the layer's backward
//   recomputes hid with this kernel, and its ReLU mask reads hid > 0.
// A 32-row tile wholly past valid_len is written as zeros over the block's
// columns and not read; the decision is the same for every thread of the
// block and taken before any barrier. LR_SLABS and LR_STAGES set the walk and
// the ring, so that scripts/bench_linear_f32.py can time other choices of
// the same source (the ring's trip count stays a constant: a runtime count
// made the kernel slower).
#ifndef LR_SLABS
#define LR_SLABS 1
#endif
#ifndef LR_STAGES
#define LR_STAGES 3
#endif
constexpr int LR_BN = 256;           // a slab of output columns
constexpr int LR_BK = 16;
constexpr int LR_LDW = LR_BK + 4;    // a staged W1 row, padded
constexpr int LR_LDX = D_MODEL + 4;  // a resident x row, padded
constexpr int LR_THREADS = 128;      // 4 warps of 32 rows x 64 columns
constexpr int LR_TM = 8, LR_TN = 8;  // a thread's rows and columns
constexpr int LR_STAGE = LR_BN * LR_LDW;  // floats
constexpr int LR_SMEM = (BM * LR_LDX + LR_STAGES * LR_STAGE) * 4;
static_assert(LR_BN == LR_THREADS / 32 * 8 * LR_TN && BM == 4 * LR_TM &&
                  D_FFN % (LR_SLABS * LR_BN) == 0,
              "linear_relu tile shape");

__global__ void __launch_bounds__(LR_THREADS, 2)
linear_relu_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out,
                   const int* __restrict__ valid_len, int s_pad) {
  constexpr int K = D_MODEL, N = D_FFN, KS = K / LR_BK;  // stages a slab
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * LR_SLABS * LR_BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tile_is_padding(m0, s_pad, valid_len)) {  // uniform, before any barrier
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = tid; c < BM * LR_SLABS * LR_BN / 4; c += LR_THREADS) {
      const int r = c / (LR_SLABS * LR_BN / 4), cc = c % (LR_SLABS * LR_BN / 4) * 4;
      *reinterpret_cast<float4*>(out + (size_t)(m0 + r) * N + n0 + cc) = z;
    }
    return;
  }
  extern __shared__ __align__(16) float lr_smem[];
  float* xs = lr_smem;                 // the block's x rows, resident
  float* ring = xs + BM * LR_LDX;
  const int ty = lane >> 3, tx = lane & 7, wc = warp * 64;

  for (int c = tid; c < BM * K / 4; c += LR_THREADS) {  // joins the first stage's copies
    const int r = c / (K / 4), cc = c % (K / 4) * 4;
    sgemm::cp_async_16(xs + r * LR_LDX + cc, x + (size_t)(m0 + r) * K + cc);
  }
  auto load = [&](int s, int slot) {  // slab s / KS, K columns [(s % KS) BK, + BK)
    float* ws = ring + slot * LR_STAGE;
    const float* src = w + (size_t)(n0 + s / KS * LR_BN) * K + s % KS * LR_BK;
#pragma unroll
    for (int q = 0; q < LR_BN * LR_BK / 4 / LR_THREADS; ++q) {
      const int c = tid + q * LR_THREADS;
      const int r = c / (LR_BK / 4), cc = c % (LR_BK / 4) * 4;
      sgemm::cp_async_16(ws + r * LR_LDW + cc, src + (size_t)r * K + cc);
    }
  };
  float acc[LR_TM][LR_TN] = {};
  sgemm::ring<LR_STAGES>(LR_SLABS * KS, load, [&](int s, int slot) {
    const int ks = s % KS;
    if (ks == 0)
#pragma unroll
      for (int i = 0; i < LR_TM; ++i)
#pragma unroll
        for (int j = 0; j < LR_TN; ++j) acc[i][j] = 0.f;
    const float* as = xs + ty * LR_LDX + ks * LR_BK;
    const float* ws = ring + slot * LR_STAGE + (wc + tx) * LR_LDW;
#pragma unroll
    for (int kk = 0; kk < LR_BK; kk += 4) {
      float4 av[LR_TM];
#pragma unroll
      for (int i = 0; i < LR_TM; ++i) av[i] = load4(as + i * 4 * LR_LDX + kk);
#pragma unroll
      for (int j = 0; j < LR_TN; ++j) sgemm::dot4(acc, j, av, load4(ws + j * 8 * LR_LDW + kk));
    }
    if (ks == KS - 1) {  // the slab's sums are whole: the bias, then the ReLU
      const int nc = n0 + s / KS * LR_BN + wc + tx;
#pragma unroll
      for (int j = 0; j < LR_TN; ++j) {
        const float bj = bias[nc + 8 * j];
#pragma unroll
        for (int i = 0; i < LR_TM; ++i)
          out[(size_t)(m0 + ty + 4 * i) * N + nc + 8 * j] = fmaxf(acc[i][j] + bj, 0.f);
      }
    }
  });
}

// ---- linear_residual_ln_fwd: out = LN(res + (a @ W^T + bias)) --------------
// float32 only (the bf16 instance is linear_fwd_bf16.cu's). Redesigned for
// Hopper's CUDA cores on the shared main loop of sgemm_f32.cuh.
//
// Replaces the out-projection and FFN2 steps of the TPU kernel
// chadavit_tpu/ops/fused_block.py::_fwd_kernel (:91), lines :162-186: the
// product, its bias, the residual add and the f32 LayerNorm with its
// fast-variance stats (_stats, :68-72).
//
// What bounds it: operations. At hub shapes the FFN2 site (K 2048) does
// 7.4 GFLOP on the rows it must compute and the out-projection (K 192) 0.7,
// against 15-30 MB of device memory, so 67 TFLOP/s of f32 FMA is the limit.
// The design keeps the FMA units fed and the SMs evenly loaded:
// - a cluster of SPLIT blocks owns one 32-row tile of the contract and all
//   192 columns; block `rank` of the cluster sums the K range [rank K /
//   SPLIT, (rank + 1) K / SPLIT). At FFN2 SPLIT is 2: the hub's 293 computed
//   row tiles are 586 blocks, 4.4 an SM, where whole tiles would be 2.2 an
//   SM and the SMs that get 3 would set the time; W2 is still read from L2
//   once a row tile (scripts/bench_linear_f32.py times 1, 2, 4 and 8);
// - its 4 warps each take 32 rows x 48 columns, a thread 4 rows x 12 columns
//   (48 sums), rows ty + 8 i and columns tx + 4 j of its warp's tile;
// - the A rows and all of W are staged LRN_BK = 16 columns of K at a time,
//   as they lie in memory (K contiguous), by 16-byte cp.async copies into a
//   ring of LRN_STAGES slots; rows are padded to 20 floats, so the rows a
//   quarter warp reads at one k lie in distinct banks, and each 16-byte read
//   of A or W feeds 16 or 12 FMAs (sgemm::dot4). 72 KB of shared memory a
//   block, three blocks an SM;
// - each block writes its sums into a row tile that reuses the ring; after a
//   cluster barrier, block `rank` adds the SPLIT tiles of its 32 / SPLIT rows
//   in rank order through distributed shared memory (a fixed order: the same
//   bits on every run), adds the bias and then the residual (the JAX order:
//   the product and its bias first), and takes the stats and the LayerNorm
//   one warp a row. A second cluster barrier keeps every tile in place until
//   its readers are done.
// A 32-row tile wholly past valid_len is written as zeros (out, r and the
// stats); its rows are not copied. The decision is the same for every block
// of the cluster.
// LRN_SPLIT_FFN sets the FFN2 site's cluster size, so that
// scripts/bench_linear_f32.py can time other splits of the same source; the
// out-projection (K 192) takes no split.
#ifndef LRN_SPLIT_FFN
#define LRN_SPLIT_FFN 2
#endif
constexpr int LRN_BM = BM;  // the contract's 32-row tile
constexpr int LRN_BN = D_MODEL;
constexpr int LRN_BK = 16;
constexpr int LRN_LD = LRN_BK + 4;  // a staged row, padded
constexpr int LRN_STAGES = 4;
constexpr int LRN_WARPS = 4;        // 32 rows x 48 columns a warp
constexpr int LRN_THREADS = LRN_WARPS * 32;
constexpr int LRN_TM = 4, LRN_TN = 12;  // a thread's rows and columns
constexpr int LRN_STAGE = (LRN_BM + LRN_BN) * LRN_LD;  // floats
constexpr int LRN_LDR = LRN_BN + 4;     // the row tile of sums
constexpr int LRN_SMEM = LRN_STAGES * LRN_STAGE * 4;
static_assert(LRN_BN == LRN_WARPS * 4 * LRN_TN && LRN_BM == 8 * LRN_TM &&
                  LRN_BM * LRN_LDR <= LRN_STAGES * LRN_STAGE,
              "linear_residual_ln tile shape");

template <int SPLIT>
__global__ void __launch_bounds__(LRN_THREADS)
linear_residual_ln_kernel(const float* __restrict__ a, const float* __restrict__ w,
                          const float* __restrict__ bias, const float* __restrict__ res,
                          const float* __restrict__ g, const float* __restrict__ beta,
                          float eps, float* __restrict__ out, float* __restrict__ mean_out,
                          float* __restrict__ rstd_out, float* __restrict__ r_out,
                          const int* __restrict__ valid_len, int K, int s_pad) {
  constexpr int BN = LRN_BN, ROWS = LRN_BM / SPLIT;  // rows a block normalises
  static_assert(LRN_BM % SPLIT == 0, "whole rows a block");
  namespace cg = cooperative_groups;
  const int rank = SPLIT > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int m0 = blockIdx.x / SPLIT * LRN_BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tile_is_padding(m0, s_pad, valid_len)) {  // the whole cluster, before any barrier
    const int r0 = m0 + rank * ROWS;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = tid; c < ROWS * BN / 4; c += LRN_THREADS) {
      reinterpret_cast<float4*>(out + (size_t)r0 * BN)[c] = z;
      if (r_out != nullptr) reinterpret_cast<float4*>(r_out + (size_t)r0 * BN)[c] = z;
    }
    if (mean_out != nullptr && tid < ROWS) {
      mean_out[r0 + tid] = 0.f;
      rstd_out[r0 + tid] = 0.f;
    }
    return;
  }
  extern __shared__ __align__(16) float lrn_smem[];
  const int ty = lane >> 2, tx = lane & 3;
  const int kpart = K / SPLIT, kbase = rank * kpart;

  auto load = [&](int s, int slot) {  // K columns [s BK, (s + 1) BK) of the block's range
    float* as = lrn_smem + slot * LRN_STAGE;
    float* ws = as + LRN_BM * LRN_LD;
    const int k0 = kbase + s * LRN_BK;
    {
      const int r = tid / (LRN_BK / 4), c = tid % (LRN_BK / 4) * 4;
      sgemm::cp_async_16(as + r * LRN_LD + c, a + (size_t)(m0 + r) * K + k0 + c);
    }
#pragma unroll
    for (int q = 0; q < BN * LRN_BK / 4 / LRN_THREADS; ++q) {
      const int idx = tid + q * LRN_THREADS;
      const int r = idx / (LRN_BK / 4), c = idx % (LRN_BK / 4) * 4;
      sgemm::cp_async_16(ws + r * LRN_LD + c, w + (size_t)r * K + k0 + c);
    }
  };
  float acc[LRN_TM][LRN_TN];
#pragma unroll
  for (int i = 0; i < LRN_TM; ++i)
#pragma unroll
    for (int j = 0; j < LRN_TN; ++j) acc[i][j] = 0.f;
  sgemm::ring<LRN_STAGES>(kpart / LRN_BK, load, [&](int, int slot) {
    const float* as = lrn_smem + slot * LRN_STAGE + ty * LRN_LD;
    const float* ws = lrn_smem + slot * LRN_STAGE + (LRN_BM + warp * 48 + tx) * LRN_LD;
#pragma unroll
    for (int kk = 0; kk < LRN_BK; kk += 4) {
      float4 av[LRN_TM];
#pragma unroll
      for (int i = 0; i < LRN_TM; ++i) av[i] = load4(as + i * 8 * LRN_LD + kk);
#pragma unroll
      for (int j = 0; j < LRN_TN; ++j) sgemm::dot4(acc, j, av, load4(ws + j * 4 * LRN_LD + kk));
    }
  });
  __syncthreads();  // every warp is done with the ring: it becomes the row tile
  float* rt = lrn_smem;
#pragma unroll
  for (int i = 0; i < LRN_TM; ++i)
#pragma unroll
    for (int j = 0; j < LRN_TN; ++j) rt[(ty + 8 * i) * LRN_LDR + warp * 48 + tx + 4 * j] = acc[i][j];
  if constexpr (SPLIT > 1) cg::this_cluster().sync();  // every block's sums are in place
  else __syncthreads();
  const float* tiles[SPLIT] = {rt};  // every block's row tile, by rank
  if constexpr (SPLIT > 1)
#pragma unroll
    for (int q = 0; q < SPLIT; ++q) tiles[q] = cg::this_cluster().map_shared_rank(rt, q);
  for (int rr = warp; rr < ROWS; rr += LRN_WARPS) {  // one warp a row
    const int r = rank * ROWS + rr;
    const size_t o = (size_t)(m0 + r) * BN;
    float v[BN / 32], s = 0.f, ss = 0.f;
#pragma unroll
    for (int c = 0; c < BN / 32; ++c) {
      const int n = lane + 32 * c;
      float p = tiles[0][r * LRN_LDR + n];
#pragma unroll
      for (int q = 1; q < SPLIT; ++q) p += tiles[q][r * LRN_LDR + n];  // in rank order
      // (a @ W^T + bias) first, then the residual: the JAX order
      v[c] = res[o + n] + (p + bias[n]);
      s += v[c];
      ss += v[c] * v[c];
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = s / BN;
    const float rstd = rsqrtf(fmaxf(ss / BN - mu * mu, 0.f) + eps);
#pragma unroll
    for (int c = 0; c < BN / 32; ++c) {
      const int n = lane + 32 * c;
      out[o + n] = (v[c] - mu) * rstd * g[n] + beta[n];
      if (r_out != nullptr) r_out[o + n] = v[c];
    }
    if (mean_out != nullptr && lane == 0) {
      mean_out[m0 + r] = mu;
      rstd_out[m0 + r] = rstd;
    }
  }
  if constexpr (SPLIT > 1) cg::this_cluster().sync();  // the tiles stay until read
}

template <int SPLIT>
int linear_residual_ln_launch(const float* a, const float* w, const float* bias,
                              const float* res, const float* g, const float* beta, float eps,
                              float* out, float* mean_out, float* rstd_out, float* r_out,
                              const int* valid_len, int M, int K, int s_pad,
                              cudaStream_t st) {
  auto kernel = linear_residual_ln_kernel<SPLIT>;
  int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    LRN_SMEM);
  if (e != 0) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(M / LRN_BM * SPLIT);
  cfg.blockDim = dim3(LRN_THREADS);
  cfg.dynamicSmemBytes = LRN_SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SPLIT;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = (int)cudaLaunchKernelEx(&cfg, kernel, a, w, bias, res, g, beta, eps, out, mean_out,
                              rstd_out, r_out, valid_len, K, s_pad);
  if (e != 0) return e;
  return (int)cudaGetLastError();
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
  if (!rows_ok(M, K, s_pad) || K != D_MODEL || N != LL_N)
    return (int)cudaErrorInvalidValue;
  int e = (int)cudaFuncSetAttribute(ln_linear_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, LL_SMEM);
  if (e != 0) return e;
  ln_linear_kernel<<<dim3(M / BM, N / (LL_SLABS * LL_BN)), LL_THREADS, LL_SMEM,
                     static_cast<cudaStream_t>(stream)>>>(x, g, beta, eps, w, bias, out,
                                                          mean_out, rstd_out, valid_len, s_pad);
  return (int)cudaGetLastError();
}

// x (M, 192), w (2048, 192), out (M, 2048).
int linear_relu_fwd(const float* x, const float* w, const float* bias,
                    float* out, const int* valid_len, int M, int K, int N,
                    int s_pad, void* stream) {
  if (!rows_ok(M, K, s_pad) || K != D_MODEL || N != D_FFN)
    return (int)cudaErrorInvalidValue;
  int e = (int)cudaFuncSetAttribute(linear_relu_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, LR_SMEM);
  if (e != 0) return e;
  linear_relu_kernel<<<dim3(M / BM, N / (LR_SLABS * LR_BN)), LR_THREADS, LR_SMEM,
                       static_cast<cudaStream_t>(stream)>>>(x, w, bias, out, valid_len, s_pad);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K == D_FFN)
    return linear_residual_ln_launch<LRN_SPLIT_FFN>(a, w, bias, res, g, beta, eps, out,
                                                    mean_out, rstd_out, r_out, valid_len, M,
                                                    K, s_pad, st);
  return linear_residual_ln_launch<1>(a, w, bias, res, g, beta, eps, out, mean_out, rstd_out,
                                      r_out, valid_len, M, K, s_pad, st);
}

}  // extern "C"
