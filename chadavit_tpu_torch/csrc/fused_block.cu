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
// reads. ln_linear_fwd and linear_relu_fwd keep a block's 32 x D input rows
// resident in shared memory (ln_linear_fwd normalises them there once) and
// stream the weight through the ring; D = 192 fits one block's columns, so
// linear_residual_ln_fwd's LayerNorm epilogue stays in the block.
//
// Each kernel is built for the layer's three widths, D 192 (ChAdaViT-moyen),
// D 768 (ChAdaViT-B/16) and D 64 (the smoke configs), FFN 2048 at each:
// linear_relu_fwd is a template on K = D, ln_linear_fwd on K = D at D 192 and
// D 64 (at D 64 Wqkv's 192 rows are one slab), linear_residual_ln_fwd at D 64
// a template on its column tile BN = 64, so that one block still owns whole
// rows. At D 64 every product has 64 on one side, so every step is bound by
// its bytes. At D 768 the LN1 + QKV step (ln_linear_fwd_d768), the FFN1 +
// ReLU step and both linear_residual_ln_fwd sites are a GEMM on 128-row
// tiles (gemm128_kernel) with the LayerNorms in row passes of their own, one
// warp a row: LN1 before the product, the residual's LayerNorm after it
// (notes below). The D 192 and D 64 instances compile to the code they had.
// The launchers refuse any other width.
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
#include <type_traits>

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
constexpr int LL_BK = 16;
constexpr int LL_LDW = LL_BK + 4;    // a staged Wqkv row, padded
constexpr int LL_TM = 8;             // a thread's rows; LL_TN its columns
constexpr int LL_WARPS = LL_BN / (8 * LL_TN);  // 32 rows x 8 LL_TN columns a warp
constexpr int LL_THREADS = LL_WARPS * 32;
constexpr int LL_STAGE = LL_BN * LL_LDW;  // floats

template <int K>  // K = D, the width
struct LnLinearF32 {
  static constexpr int N = 3 * K;     // qkv's columns
  static constexpr int LDX = K + 4;   // a resident x row, padded
  static constexpr int SMEM = (BM * LDX + LL_STAGES * LL_STAGE) * 4;
  // blocks an SM by shared memory (227 KB, 1 KB of it reserved a block), at
  // most three: the register budget follows from it (D 192 and D 64: three,
  // 168 registers a thread)
  static constexpr int BY_SMEM = 232448 / (SMEM + 1024);
  static constexpr int BLOCKS_SM = BY_SMEM > 3 ? 3 : BY_SMEM > 0 ? BY_SMEM : 1;
  static_assert(LL_BN % (8 * LL_TN) == 0 && BM == 4 * LL_TM &&
                    LL_BN * LL_BK / 4 % LL_THREADS == 0,
                "ln_linear tile shape");
  // the cut of qkv's columns: a bench build's wider cuts (LL_SLABS, LL_BN)
  // take D 192's 576 columns but not D 64's 192
  static constexpr bool CUT_FITS = N % (LL_SLABS * LL_BN) == 0;
};

template <int K>
__global__ void __launch_bounds__(LL_THREADS, LnLinearF32<K>::BLOCKS_SM)
ln_linear_kernel(const float* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ beta, float eps, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ out,
                 float* __restrict__ mean_out, float* __restrict__ rstd_out,
                 const int* __restrict__ valid_len, int s_pad) {
  constexpr int N = LnLinearF32<K>::N, KS = K / LL_BK;  // stages a slab
  constexpr int LL_LDX = LnLinearF32<K>::LDX;
  static_assert(LnLinearF32<K>::CUT_FITS, "ln_linear tile shape");
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
// Hopper's CUDA cores on the shared main loop of sgemm_f32.cuh. At D 192 and
// D 64; D 768 takes gemm128_kernel's ReLU epilogue (below), which sums in
// this kernel's order.
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
constexpr int LR_THREADS = 128;      // 4 warps of 32 rows x 64 columns
constexpr int LR_TM = 8, LR_TN = 8;  // a thread's rows and columns
constexpr int LR_STAGE = LR_BN * LR_LDW;  // floats
static_assert(LR_BN == LR_THREADS / 32 * 8 * LR_TN && BM == 4 * LR_TM &&
                  D_FFN % (LR_SLABS * LR_BN) == 0,
              "linear_relu tile shape");

template <int K>  // K = D, the width: 192 or 64 (D 768 takes gemm128_kernel)
struct LinearReluF32 {
  static constexpr int LDX = K + 4;  // a resident x row, padded
  // D 192: 84.5 KB, two blocks an SM
  static constexpr int SMEM = (BM * LDX + LR_STAGES * LR_STAGE) * 4;
};

template <int K>
__global__ void __launch_bounds__(LR_THREADS, 2)
linear_relu_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out,
                   const int* __restrict__ valid_len, int s_pad) {
  constexpr int N = D_FFN, KS = K / LR_BK;  // stages a slab
  constexpr int LR_LDX = LinearReluF32<K>::LDX;
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
//
// At D 64 (BN = 64) the block owns whole rows of 64 columns: each warp takes
// 32 rows x 16 columns, a thread 4 rows x 4 columns (rows ty + 8 i, columns
// tx + 4 j of its warp's), the same ring, K split and LayerNorm epilogue.
//
// At D 768 both sites are gemm128_kernel and res_ln_rows_kernel below.
#ifndef LRN_SPLIT_FFN
#define LRN_SPLIT_FFN 2
#endif
constexpr int LRN_BM = BM;  // the contract's 32-row tile
constexpr int LRN_BN = D_MODEL;
constexpr int LRN_BK = 16;
constexpr int LRN_LD = LRN_BK + 4;  // a staged row, padded
constexpr int LRN_STAGES = 4;
constexpr int LRN_WARPS = 4;        // 32 rows x BN / 4 columns a warp
constexpr int LRN_THREADS = LRN_WARPS * 32;
constexpr int LRN_TM = 4;           // a thread's rows

template <int BN>  // the block's columns: D_MODEL or D_SMALL
struct ResLnF32 {
  static constexpr int WC = BN / LRN_WARPS;     // a warp's columns
  static constexpr int TN = WC / 4;             // a thread's columns
  static constexpr int STAGE = (LRN_BM + BN) * LRN_LD;  // floats
  static constexpr int LDR = BN + 4;            // the row tile of sums
  static constexpr int SMEM = LRN_STAGES * STAGE * 4;
  static_assert(BN == LRN_WARPS * 4 * TN && LRN_BM == 8 * LRN_TM && BN % 32 == 0 &&
                    LRN_BM * LDR <= LRN_STAGES * STAGE && BN * LRN_BK / 4 % LRN_THREADS == 0,
                "linear_residual_ln tile shape");
};

template <int SPLIT, int BN>
__global__ void __launch_bounds__(LRN_THREADS)
linear_residual_ln_kernel(const float* __restrict__ a, const float* __restrict__ w,
                          const float* __restrict__ bias, const float* __restrict__ res,
                          const float* __restrict__ g, const float* __restrict__ beta,
                          float eps, float* __restrict__ out, float* __restrict__ mean_out,
                          float* __restrict__ rstd_out, float* __restrict__ r_out,
                          const int* __restrict__ valid_len, int K, int s_pad) {
  using C = ResLnF32<BN>;
  constexpr int ROWS = LRN_BM / SPLIT;  // rows a block normalises
  constexpr int LRN_TN = C::TN, LRN_LDR = C::LDR, LRN_STAGE = C::STAGE;
  static_assert(LRN_BM % SPLIT == 0, "whole rows a block");
  namespace cg = cooperative_groups;
  const int rank = SPLIT > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int m0 = blockIdx.x / SPLIT * LRN_BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tile_is_padding(m0, s_pad, valid_len)) {  // the whole cluster, before any barrier
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const int r0 = m0 + rank * ROWS;
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
    const float* ws = lrn_smem + slot * LRN_STAGE + (LRN_BM + warp * C::WC + tx) * LRN_LD;
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
    for (int j = 0; j < LRN_TN; ++j) rt[(ty + 8 * i) * LRN_LDR + warp * C::WC + tx + 4 * j] = acc[i][j];
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

template <int SPLIT, int BN = LRN_BN>
int linear_residual_ln_launch(const float* a, const float* w, const float* bias,
                              const float* res, const float* g, const float* beta, float eps,
                              float* out, float* mean_out, float* rstd_out, float* r_out,
                              const int* valid_len, int M, int K, int s_pad,
                              cudaStream_t st) {
  constexpr int LRN_SMEM = ResLnF32<BN>::SMEM;
  auto kernel = linear_residual_ln_kernel<SPLIT, BN>;
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

// ---- D 768: a GEMM on 128-row tiles, the LayerNorms in row passes ----------
// The float32 LN1 + QKV step (ln_linear_fwd_d768), the FFN1 + ReLU step
// (linear_relu_fwd at K 768) and both linear_residual_ln_fwd sites at
// ChAdaViT-B/16's D 768. They replace, at that width, the same lines of the
// TPU kernel as the D 192 kernels above (_fwd_kernel :111-124, :172-173 and
// :162-186).
//
// What bounds them: operations (at chip_smoke.py's narrow f32 shapes, 3 340
// valid rows, 11.8 and 14.4 GFLOP: 0.18 and 0.22 ms at 67 TFLOP/s of f32
// FMA). A block that owns one 32-row tile of the contract, as the D 192
// kernels' do, reads all of W from L2 for every 32 rows (7 MB of Wqkv, 8.7
// MB of Wout and W2 a layer): at D 768 that L2 traffic is of the order of
// the FMA time, and K1a's resident 32 x 768 rows left one block of 4 warps
// an SM. So:
// - the LayerNorm leaves the GEMM. K1a: ln_rows_f32_kernel, one warp a row,
//   takes the row stats in row_stats' order and writes h = LN1(x) into a
//   scratch of x's shape (rows of the zero-filled tiles are neither read nor
//   written, their stats are zeros). K1b: the GEMM's epilogue writes the
//   pre-LN sum r = res + (a W^T + bias) (into r_out, or into out when the
//   caller saves no r), and res_ln_rows_kernel, one warp a row, normalises it
//   in the order of the column-cluster kernel this replaces: four partial
//   sums over 192 columns (lane l sums columns 192 q + l + 32 c, c < 6, then
//   the xor butterfly), added for q = 0 .. 3 in order; then the max(0, .)
//   clamp and out = (r - mu) rstd g + beta;
// - K1c (FFN1 + ReLU) is the same GEMM with a ReLU epilogue (G_BIAS_RELU):
//   linear_relu_kernel at D 768 kept a 32 x 768 x tile resident (156.5 KB),
//   one block of 4 warps an SM, and read all of W1 for every 32 rows;
// - gemm128_kernel: a block owns 128 rows (four 32-row tiles of the
//   contract, each tested on its own: they may lie in two images, and the
//   last block may hold fewer) and BN columns, 8 warps of 32 rows x BN / 2
//   columns, a thread 8 x BN / 16 sums (rows ty + 4 i, columns tx + 8 j of
//   its warp's) by sgemm::dot4, A and W staged as they lie (K contiguous),
//   16 columns of K a stage, through a ring of 4 slots (rows padded to 20
//   floats); two blocks an SM. W is read from L2 once for 128 rows, a
//   quarter of the D 192 design's traffic. A warp whose 32-row tile holds no
//   valid row skips its FMAs and writes zeros; the block copies only the
//   rows of its computed tiles, and a block with none writes its zeros and
//   returns before any barrier;
// - BN is 96 (8 x 6 sums a thread), or 64 where the 96-column grid would
//   leave some SMs two blocks and others one or none while the 64-column
//   grid fits in one wave of two an SM (gemm128_launch): a call then takes
//   about the time of the SMs that hold two blocks, and 64 columns make
//   those blocks lighter. At the narrow shapes (40 row blocks) both steps
//   take BN 96: 744 computed K1a blocks (2.8 waves) and 248 K1b blocks
//   (0.94 of a wave); K1b at 4e (b)'s bucket rows (20 row blocks) takes BN
//   64. Other tiles, rings and warp shapes timed no better (PERF.md
//   section 6). K1c's N 2048 is no multiple of 96: it takes BN 64
//   (G_RELU_BN);
// - the bits are those of the kernels this replaces: each sum from k = 0
//   upward with fmaf, then the bias (then the residual); the row passes
//   spell out with intrinsics the products nvcc fused there (the sums of
//   squares, the LayerNorm's * g + beta, K1b's mu * mu) and the one it did
//   not (K1a's mu * mu, after a division by a runtime width).
constexpr int G_BM = 4 * BM;      // rows a block: four tiles of the contract
constexpr int G_BK = 16;
constexpr int G_LD = G_BK + 4;    // a staged row, padded
constexpr int G_STAGES = 4;
constexpr int G_THREADS = 256;    // 4 warps along the rows x 2 along the columns
constexpr int G_TM = 8;           // a thread's rows: 4 x 8 lanes a warp
constexpr int ROWS_THREADS = 256; // the row passes: 8 warps a block, one a row
enum GemmEpilogue { G_BIAS = 0, G_RESIDUAL = 1, G_BIAS_RELU = 2 };
static_assert(BM == 4 * G_TM && G_BM * G_BK / 4 == 2 * G_THREADS, "gemm128 tile shape");

template <int BN>
constexpr int gemm128_smem() { return G_STAGES * (G_BM + BN) * G_LD * 4; }

// out = a W^T + bias (G_BIAS), res + (a W^T + bias) (G_RESIDUAL) or
// max(a W^T + bias, 0) (G_BIAS_RELU: the sum, then the bias, then the max, as
// linear_relu_kernel); a (M, K), W (N, K), res and out (M, N), M a multiple
// of 32.
template <int N, int K, int BN, int EPI>
__global__ void __launch_bounds__(G_THREADS, 2)
gemm128_kernel(const float* __restrict__ a, const float* __restrict__ w,
               const float* __restrict__ bias, const float* __restrict__ res,
               float* __restrict__ out, const int* __restrict__ valid_len, int M, int s_pad) {
  constexpr int TN = BN / 16, STAGE = (G_BM + BN) * G_LD, W_COPIES = BN * G_BK / 4;
  static_assert(BN % 16 == 0 && N % BN == 0 && K % G_BK == 0, "gemm128 shape");
  const int m0 = blockIdx.x * G_BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = min(4, (M - m0) / BM);  // the block's 32-row tiles
  unsigned live = 0;                        // bit t: tile t holds a valid row
  for (int t = 0; t < tiles; ++t)
    live |= (unsigned)!tile_is_padding(m0 + t * BM, s_pad, valid_len) << t;
  if (live == 0) {  // uniform, before any barrier
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = tid; c < tiles * BM * BN / 4; c += G_THREADS)
      *reinterpret_cast<float4*>(out + (size_t)(m0 + c / (BN / 4)) * N + n0 + c % (BN / 4) * 4) = z;
    return;
  }
  extern __shared__ __align__(16) float g_smem[];
  const int tile = warp % 4, wc = warp / 4 * (BN / 2);  // the warp's 32-row tile, columns
  const int ty = lane / 8, tx = lane % 8;
  const bool computed = live >> tile & 1;
  auto load = [&](int s, int slot) {  // K columns [s BK, (s + 1) BK)
    float* as = g_smem + slot * STAGE;
    float* ws = as + G_BM * G_LD;
    const int k0 = s * G_BK;
#pragma unroll
    for (int q = 0; q < 2; ++q) {  // the rows of the computed tiles
      const int c = tid + q * G_THREADS, r = c >> 2;
      if (live >> (r / BM) & 1)
        sgemm::cp_async_16(as + r * G_LD + (c & 3) * 4,
                           a + (size_t)(m0 + r) * K + k0 + (c & 3) * 4);
    }
#pragma unroll
    for (int q = 0; q < (W_COPIES + G_THREADS - 1) / G_THREADS; ++q) {
      const int c = tid + q * G_THREADS;
      if (W_COPIES % G_THREADS == 0 || c < W_COPIES)
        sgemm::cp_async_16(ws + (c >> 2) * G_LD + (c & 3) * 4,
                           w + (size_t)(n0 + (c >> 2)) * K + k0 + (c & 3) * 4);
    }
  };
  float acc[G_TM][TN];
#pragma unroll
  for (int i = 0; i < G_TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  sgemm::ring<G_STAGES>(K / G_BK, load, [&](int, int slot) {
    if (!computed) return;  // uniform in the warp
    const float* as = g_smem + slot * STAGE + (tile * BM + ty) * G_LD;
    const float* ws = g_smem + slot * STAGE + (G_BM + wc + tx) * G_LD;
#pragma unroll
    for (int kk = 0; kk < G_BK; kk += 4) {
      float4 av[G_TM];
#pragma unroll
      for (int i = 0; i < G_TM; ++i) av[i] = load4(as + i * 4 * G_LD + kk);
#pragma unroll
      for (int j = 0; j < TN; ++j) sgemm::dot4(acc, j, av, load4(ws + j * 8 * G_LD + kk));
    }
  });
  if (tile >= tiles) return;  // past M
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + wc + tx + 8 * j;
    const float bj = bias[n];
#pragma unroll
    for (int i = 0; i < G_TM; ++i) {
      const size_t o = (size_t)(m0 + tile * BM + ty + 4 * i) * N + n;
      float v = 0.f;
      if (computed) {
        v = acc[i][j] + bj;
        if constexpr (EPI == G_RESIDUAL) v = res[o] + v;  // the JAX order
        if constexpr (EPI == G_BIAS_RELU) v = fmaxf(v, 0.f);
      }
      out[o] = v;
    }
  }
}

// K1c's column tile at N 2048, which 96 does not divide. 64: at 128 (8 x 8
// sums a thread) the two blocks an SM leave 128 registers and the tile
// spills; at 32 (8 x 2) each block reads its A rows for half the columns.
// Both timed slower at both of chip_smoke.py's f32 D 768 row counts, 32
// also where its grid makes fuller waves (PERF.md section 6)
constexpr int G_RELU_BN = 64;

// gemm128_kernel with BN 64 where the 96-column grid would exceed one block
// an SM and the 64-column grid fits in two, else with BN 96; at N 2048 (K1c)
// with G_RELU_BN.
template <int N, int K, int EPI>
int gemm128_launch(const float* a, const float* w, const float* bias, const float* res,
                   float* out, const int* valid_len, int M, int s_pad, cudaStream_t st) {
  int dev = 0, sms = 0;
  int e = (int)cudaGetDevice(&dev);
  if (e == 0) e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != 0) return e;
  const int row_blocks = (M + G_BM - 1) / G_BM;
  auto run = [&](auto kernel, int bn, int smem) {
    const int status =
        (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (status != 0) return status;
    kernel<<<dim3(row_blocks, N / bn), G_THREADS, smem, st>>>(a, w, bias, res, out, valid_len,
                                                              M, s_pad);
    return (int)cudaGetLastError();
  };
  if constexpr (N % 96 != 0) {
    return run(gemm128_kernel<N, K, G_RELU_BN, EPI>, G_RELU_BN, gemm128_smem<G_RELU_BN>());
  } else {
    if (row_blocks * (N / 96) > sms && row_blocks * (N / 64) <= 2 * sms)
      return run(gemm128_kernel<N, K, 64, EPI>, 64, gemm128_smem<64>());
    return run(gemm128_kernel<N, K, 96, EPI>, 96, gemm128_smem<96>());
  }
}

__device__ __forceinline__ bool row_is_padding(int row, int s_pad, const int* valid_len) {
  const int b = row / s_pad, local = row - b * s_pad;
  return local / BM * BM >= valid_len[b];
}

// LN1 of K1a at width K, one warp a row: the stats in row_stats' order (lane
// l sums columns l, l + 32, ... in order, then warp_sum; the fast variance
// with the max(0, .) clamp), written where asked, and h = (x - mu) rstd g +
// beta with the product by g fused, as the kernel this replaces normalised
// its resident rows. The zero-filled tiles' rows: stats zeros, h not written.
template <int K>
__global__ void __launch_bounds__(ROWS_THREADS)
ln_rows_f32_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, float eps, float* __restrict__ h,
                   float* __restrict__ mean_out, float* __restrict__ rstd_out,
                   const int* __restrict__ valid_len, int M, int s_pad) {
  constexpr int C = K / 32;
  const int lane = threadIdx.x & 31, per_block = ROWS_THREADS / 32;
  const int warps = gridDim.x * per_block;
  for (int row = blockIdx.x * per_block + threadIdx.x / 32; row < M; row += warps) {
    if (row_is_padding(row, s_pad, valid_len)) {  // uniform in the warp
      if (mean_out != nullptr && lane == 0) {
        mean_out[row] = 0.f;
        rstd_out[row] = 0.f;
      }
      continue;
    }
    const float* xr = x + (size_t)row * K;
    float v[C], s = 0.f, ss = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      v[c] = xr[lane + 32 * c];
      s += v[c];
      ss = fmaf(v[c], v[c], ss);
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = s / K;
    const float rs = rsqrtf(fmaxf(__fsub_rn(ss / K, __fmul_rn(mu, mu)), 0.f) + eps);
    if (mean_out != nullptr && lane == 0) {
      mean_out[row] = mu;
      rstd_out[row] = rs;
    }
    float* hr = h + (size_t)row * K;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = lane + 32 * c;
      hr[k] = fmaf(__fmul_rn(__fsub_rn(v[c], mu), rs), gamma[k], beta[k]);
    }
  }
}

// K1b's LayerNorm at width D (a multiple of 192), one warp a row, on the
// pre-LN sum r: D / 192 partial sums of r and r^2 over 192 columns each (lane
// l sums columns 192 q + l + 32 c, c < 6, in order; then warp_sum), added for
// q = 0, 1, ... in order; mu, the clamped fast variance (mu * mu fused into
// its difference, as nvcc compiled the cluster kernel's constant-width
// division) and out = (r - mu) rstd g + beta. r may be out itself (a lane
// reads its columns of the row before it writes them). The zero-filled
// tiles' rows: out and the stats zeros (r holds the GEMM's zeros there).
template <int D>
__global__ void __launch_bounds__(ROWS_THREADS)
res_ln_rows_kernel(const float* r, const float* __restrict__ gamma,
                   const float* __restrict__ beta, float eps, float* out,
                   float* __restrict__ mean_out, float* __restrict__ rstd_out,
                   const int* __restrict__ valid_len, int M, int s_pad) {
  constexpr int Q = D / D_MODEL, C = D_MODEL / 32;
  const int lane = threadIdx.x & 31, per_block = ROWS_THREADS / 32;
  const int warps = gridDim.x * per_block;
  for (int row = blockIdx.x * per_block + threadIdx.x / 32; row < M; row += warps) {
    float* orow = out + (size_t)row * D;
    if (row_is_padding(row, s_pad, valid_len)) {  // uniform in the warp
#pragma unroll
      for (int c = 0; c < D / 32; ++c) orow[lane + 32 * c] = 0.f;
      if (mean_out != nullptr && lane == 0) {
        mean_out[row] = 0.f;
        rstd_out[row] = 0.f;
      }
      continue;
    }
    const float* rr = r + (size_t)row * D;
    float v[Q][C], ts = 0.f, tss = 0.f;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        v[q][c] = rr[D_MODEL * q + lane + 32 * c];
        s += v[q][c];
        ss = fmaf(v[q][c], v[q][c], ss);
      }
      s = warp_sum(s);
      ss = warp_sum(ss);
      ts = q == 0 ? s : ts + s;  // in q order
      tss = q == 0 ? ss : tss + ss;
    }
    const float mu = ts / D;
    const float rstd = rsqrtf(fmaxf(fmaf(-mu, mu, tss / D), 0.f) + eps);
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int n = D_MODEL * q + lane + 32 * c;
        orow[n] = fmaf(__fmul_rn(__fsub_rn(v[q][c], mu), rstd), gamma[n], beta[n]);
      }
    if (mean_out != nullptr && lane == 0) {
      mean_out[row] = mu;
      rstd_out[row] = rstd;
    }
  }
}

int rows_blocks(int M) { return min((M + ROWS_THREADS / 32 - 1) / (ROWS_THREADS / 32), 132 * 16); }

}  // namespace

extern "C" {

// x (M, D), w (3 D, D), out (M, 3 D), D 192 or 64 (D 768: ln_linear_fwd_d768).
// mean_out and rstd_out, (M,) each, are written when not null (both or
// neither): the LN1 row stats, zeros on skipped tiles.
int ln_linear_fwd(const float* x, const float* g, const float* beta, float eps,
                  const float* w, const float* bias, float* out, float* mean_out,
                  float* rstd_out, const int* valid_len, int M, int K, int N,
                  int s_pad, void* stream) {
  if (!rows_ok(M, K, s_pad) || (K != D_MODEL && K != D_SMALL) || N != 3 * K)
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto width) {
    constexpr int D = decltype(width)::value;
    if constexpr (!LnLinearF32<D>::CUT_FITS) {
      return (int)cudaErrorInvalidValue;  // a bench build's cut this width does not admit
    } else {
      auto kernel = ln_linear_kernel<D>;
      constexpr int smem = LnLinearF32<D>::SMEM;
      int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        smem);
      if (e != 0) return e;
      kernel<<<dim3(M / BM, N / (LL_SLABS * LL_BN)), LL_THREADS, smem,
               static_cast<cudaStream_t>(stream)>>>(x, g, beta, eps, w, bias, out, mean_out,
                                                    rstd_out, valid_len, s_pad);
      return (int)cudaGetLastError();
    }
  };
  if (K == D_MODEL) return run(std::integral_constant<int, D_MODEL>());
  return run(std::integral_constant<int, D_SMALL>());
}

// ln_linear_fwd at D 768: x (M, 768), w (2304, 768), out (M, 2304); h (M, 768)
// is the scratch of LN1(x) (its rows on the zero-filled tiles are not
// written). The row pass, then the GEMM.
int ln_linear_fwd_d768(const float* x, const float* g, const float* beta, float eps,
                       const float* w, const float* bias, float* out, float* mean_out,
                       float* rstd_out, float* h, const int* valid_len, int M, int K, int N,
                       int s_pad, void* stream) {
  if (!rows_ok(M, K, s_pad) || K != D_WIDE || N != 3 * K) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ln_rows_f32_kernel<D_WIDE><<<rows_blocks(M), ROWS_THREADS, 0, st>>>(
      x, g, beta, eps, h, mean_out, rstd_out, valid_len, M, s_pad);
  const int e = (int)cudaGetLastError();
  if (e != 0) return e;
  return gemm128_launch<3 * D_WIDE, D_WIDE, G_BIAS>(h, w, bias, nullptr, out, valid_len, M,
                                                    s_pad, st);
}

// x (M, D), w (2048, D), out (M, 2048), D 192, 768 or 64 (D 768: the 128-row
// GEMM with its ReLU epilogue).
int linear_relu_fwd(const float* x, const float* w, const float* bias,
                    float* out, const int* valid_len, int M, int K, int N,
                    int s_pad, void* stream) {
  if (!rows_ok(M, K, s_pad) || !is_width(K) || N != D_FFN)
    return (int)cudaErrorInvalidValue;
  if (K == D_WIDE)
    return gemm128_launch<D_FFN, D_WIDE, G_BIAS_RELU>(x, w, bias, nullptr, out, valid_len, M,
                                                      s_pad, static_cast<cudaStream_t>(stream));
  auto run = [&](auto kernel, int smem) {
    int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != 0) return e;
    kernel<<<dim3(M / BM, N / (LR_SLABS * LR_BN)), LR_THREADS, smem,
             static_cast<cudaStream_t>(stream)>>>(x, w, bias, out, valid_len, s_pad);
    return (int)cudaGetLastError();
  };
  if (K == D_MODEL) return run(linear_relu_kernel<D_MODEL>, LinearReluF32<D_MODEL>::SMEM);
  return run(linear_relu_kernel<D_SMALL>, LinearReluF32<D_SMALL>::SMEM);
}

// a (M, K) with K = N (out-proj) or 2048 (FFN2), w (N, K), res and out (M, N),
// N = D 192, 768 or 64. When not null: mean_out and rstd_out (M,) get the LN
// row stats (both or neither), r_out (M, N) the pre-LN sum; zeros on skipped
// tiles.
int linear_residual_ln_fwd(const float* a, const float* w, const float* bias,
                           const float* res, const float* g, const float* beta,
                           float eps, float* out, float* mean_out,
                           float* rstd_out, float* r_out, const int* valid_len,
                           int M, int K, int N, int s_pad, void* stream) {
  if (!rows_ok(M, K, s_pad) || !is_width(N) || (K != N && K != D_FFN))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == D_WIDE) {  // both sites: the GEMM writes r (into out unless saved), then the row pass
    float* r = r_out != nullptr ? r_out : out;
    const int e = K == D_FFN ? gemm128_launch<D_WIDE, D_FFN, G_RESIDUAL>(
                                   a, w, bias, res, r, valid_len, M, s_pad, st)
                             : gemm128_launch<D_WIDE, D_WIDE, G_RESIDUAL>(
                                   a, w, bias, res, r, valid_len, M, s_pad, st);
    if (e != 0) return e;
    res_ln_rows_kernel<D_WIDE><<<rows_blocks(M), ROWS_THREADS, 0, st>>>(
        r, g, beta, eps, out, mean_out, rstd_out, valid_len, M, s_pad);
    return (int)cudaGetLastError();
  }
  if (N == D_SMALL) {  // whole rows of 64 columns a block; FFN2 split as at D 192
    if (K == D_FFN)
      return linear_residual_ln_launch<LRN_SPLIT_FFN, D_SMALL>(
          a, w, bias, res, g, beta, eps, out, mean_out, rstd_out, r_out, valid_len, M, K, s_pad,
          st);
    return linear_residual_ln_launch<1, D_SMALL>(a, w, bias, res, g, beta, eps, out,
                                                    mean_out, rstd_out, r_out, valid_len, M, K,
                                                    s_pad, st);
  }
  if (K == D_FFN)
    return linear_residual_ln_launch<LRN_SPLIT_FFN>(a, w, bias, res, g, beta, eps, out,
                                                    mean_out, rstd_out, r_out, valid_len, M,
                                                    K, s_pad, st);
  return linear_residual_ln_launch<1>(a, w, bias, res, g, beta, eps, out, mean_out, rstd_out,
                                      r_out, valid_len, M, K, s_pad, st);
}

}  // extern "C"
