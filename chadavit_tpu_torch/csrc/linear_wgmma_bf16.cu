// The bf16 GEMM steps of a ChAdaViT-B/16 encoder layer (D 768, FFN 2048) on
// Hopper's warpgroup products: the LN1 + QKV forward (K1a,
// ln_linear_fwd_wgmma_bf16), the out-projection / FFN2 + residual + LayerNorm
// forward (K1b, linear_residual_ln_fwd_wgmma_bf16), the FFN1 + ReLU forward
// (K1c, linear_relu_fwd_wgmma_bf16), the data gradient at the layer's four
// sites (K2b, linear_dgrad_wgmma_bf16) and the weight gradient (K2c,
// linear_wgrad_wgmma_bf16): TMA tiles through an mbarrier ring, one producer
// thread and two consumer warpgroups, wgmma m64n256k16 (m64n192k16 at the
// N 768 sites of K1b and K2b) from 128-byte-swizzled shared memory (wgmma_bf16.cuh). The
// functions, sites, rounding points and row contract are those of the D 192
// instances (linear_fwd_bf16.cu, linear_bwd_bf16.cu), which stay as they are.
//
// Replaces, with linear_fwd_bf16.cu and linear_bwd_bf16.cu, the TPU kernels
// chadavit_tpu/ops/fused_block.py::_fwd_kernel (:91) and _bwd_kernel (:211)
// at D 768, whose bf16 dots run on the MXU with f32 accumulation.
//
// What bounds them on an H100: at D 768 every product has 768 or more on both
// sides, 380 to 580 operations a byte of device memory, over the 295 at which
// the bf16 tensor cores become the limit: all are bound by operations, which
// only wgmma reaches. The design:
//
// - One warp a row takes LN1 (ln_rows_kernel, shared by K1a and K2c): h =
//   bf16((x - mean) rstd g + b) on the rows of the 32-row tiles that hold a
//   valid row, with the row stats taken here (K1a, f32 fast variance with the
//   max(0, .) clamp, written where asked; zeros on the zero-filled tiles) or
//   read from the forward's saved stats (K2c's QKV site: the forward's h,
//   exactly). The GEMMs then read h by TMA: the LayerNorm runs once a row,
//   not once for each column block.
// - K1a, K1b, K1c and K2b are one kernel (linear_wgmma_kernel), a template on the
//   shape, the column tile and the epilogue: out = epilogue(A B) on tiles of
//   two 64-row units (one a warpgroup) by 256 (or 192) columns, K in slices of
//   64 through a three- or four-stage ring. A is the activations (h, x2, dY),
//   K-major; B is W, K-major for the forward (W (N, K)) and MN-major for the
//   data gradient (W (K, N) as it lies). The units are the 64-row blocks that
//   hold a valid row, listed image by image, so a persistent grid of at most
//   132 blocks walks computed rows only and every block gets the same share
//   of tiles. The epilogue stages each warpgroup's rows in shared memory and
//   stores the rows of the unit's computed 32-row tiles 16 bytes a thread
//   (stored from the fragments, 4 bytes a thread, K1a's stores took 60 % of
//   the kernel on an H100). K2b's mask (hid, 30 MB at 2c's shapes) or
//   residual comes by TMA into that staging while the tile's later slices
//   multiply. The producer warpgroup's three idle warps write the rows of the
//   zero-filled 32-row tiles meanwhile.
// - K1b: the GEMM's epilogue takes the residual the same way and writes the
//   pre-LN sum r = bf16(res + bf16(bf16(s) + b)), the JAX order
//   (chadavit_tpu/ops/fused_block.py:162-186: r is a bf16 tensor there too),
//   into r_out or, when the caller saves no r, into out; then one warp a row
//   (res_ln_rows_bf16_kernel) takes the LayerNorm of r in the order of the
//   four-block column cluster it replaces (a row's four 192-column partial
//   sums, each over lanes of eight columns, added in order), so that given
//   the same r, out and the row stats keep their bits. A column cluster that
//   adds partial sums through distributed shared memory read all of W for
//   each 64 rows on mma.sync and waited at two cluster barriers; the row
//   pass reads r once, 10.7 MB each way at chip_smoke.py's narrow bf16 rows.
// - K2c: dW = dY^T X' and db = colsum dY summed over the computed 32-row
//   tiles, two a unit (64 rows; an odd last tile pairs with a box past the
//   tensor's end, which TMA fills with zeros). dY and X' stay as they are in
//   device memory (rows, features): both operands are MN-major, so TMA boxes
//   of 32 rows x 64 features feed wgmma with no copies by hand. db is one
//   more product, dY^T times a column of ones (m64n8k16), issued with every
//   unit's products (a product under a branch made ptxas serialize the
//   wgmma) and written by the segments of the first column tile only. The
//   work is a stream-K walk: the units of every output tile
//   (tile-major) are cut into 132 contiguous, near-equal shares, one block
//   each, so every SM has work whatever the tile count; a block writes the
//   partial of each tile segment it holds into slot tile + block
//   (tiles + 131 slots at most, whatever the batch), and a second pass adds
//   each tile's slots in block order: no atomics, the same bits on every
//   run.
//
// Plain C interface (loaded with ctypes); each launcher returns
// cudaGetLastError() (or the first error of the tensor maps) so that the
// Python wrapper can raise on a refused launch. Diagnostic builds: those of
// wgmma_bf16.cuh, and -DWGMMA_NO_STORE, which drops the GEMMs' stores of
// their results (scripts/bench_wgmma_bf16.py --builds).

#include "gemm_common.cuh"
#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int CONSUMERS = 2;                        // consumer warpgroups
constexpr int PRODUCER_WARP = 4 * CONSUMERS;        // then one producer warp
constexpr int WG_THREADS = 128 * CONSUMERS + 32;
constexpr int TILE_M = 64 * CONSUMERS;              // rows of a block's output tile
constexpr int TILE_N = 256;                         // its columns: m64n256k16
constexpr int BOX = 64;                             // bf16 a box row: 128 bytes
constexpr int ROW_TILE = BM;                        // the contract's 32-row tile
constexpr int MAX_IMAGES = 1024;
constexpr int RELEASES = 4 * CONSUMERS;             // arrivals that free a stage: a consumer warp each
#ifdef WGMMA_NO_STORE
constexpr bool STORE = false;
#else
constexpr bool STORE = true;
#endif

// the dynamic shared memory's first 1024-byte boundary: the swizzled tiles' base
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (wg::smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ float ln_one(float v, float mu, float rs, float g, float b) {
  return __fmaf_rn(__fmul_rn(__fsub_rn(v, mu), rs), g, b);
}

// ---- LN1 over the computed rows ------------------------------------------------
// One warp a row, rows strided over the grid. Each lane holds its 16-byte
// chunks (lane, lane + 32, ...) of the row; the stats sum them in the order of
// the D 192 K1a (per lane, then warp_sum), and h = bf16((x - mean) rstd g + b)
// as the D 192 K2c's staging computes it (ln_one).
template <int K>
__global__ void __launch_bounds__(256)
ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, float eps, const float* __restrict__ mean_in,
               const float* __restrict__ rstd_in, bf16* __restrict__ h,
               float* __restrict__ mean_out, float* __restrict__ rstd_out,
               const int* __restrict__ valid_len, int M,
               int s_pad) {
  constexpr int CHUNKS = K / 8;
  constexpr int PER_LANE = (CHUNKS + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x / 32);
  for (int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32; row < M; row += warps) {
    const int b = row / s_pad, local = row - b * s_pad;
    if (local / ROW_TILE * ROW_TILE >= valid_len[b]) {  // a zero-filled tile: uniform
      if (mean_out != nullptr && lane == 0) {
        mean_out[row] = 0.f;
        rstd_out[row] = 0.f;
      }
      continue;
    }
    uint4 u[PER_LANE];
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      u[j] = make_uint4(0, 0, 0, 0);
      if (lane + 32 * j < CHUNKS)
        u[j] = *reinterpret_cast<const uint4*>(x + (size_t)row * K + (lane + 32 * j) * 8);
    }
    float mu, rs;
    if (mean_in != nullptr) {
      mu = mean_in[row];
      rs = rstd_in[row];
    } else {
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        const uint32_t* uw = reinterpret_cast<const uint32_t*>(&u[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = unpack_bf16x2(uw[e]);
          s += f.x + f.y;
          ss += f.x * f.x + f.y * f.y;
        }
      }
      s = warp_sum(s);
      ss = warp_sum(ss);
      mu = s / K;
      rs = rsqrtf(fmaxf(ss / K - mu * mu, 0.f) + eps);
      if (mean_out != nullptr && lane == 0) {
        mean_out[row] = mu;
        rstd_out[row] = rs;
      }
    }
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int c8 = (lane + 32 * j) * 8;
      if (c8 >= K) continue;
      float ga[8], ba[8];
      *reinterpret_cast<float4*>(ga) = __ldg(reinterpret_cast<const float4*>(gamma + c8));
      *reinterpret_cast<float4*>(ga + 4) = __ldg(reinterpret_cast<const float4*>(gamma + c8 + 4));
      *reinterpret_cast<float4*>(ba) = __ldg(reinterpret_cast<const float4*>(beta + c8));
      *reinterpret_cast<float4*>(ba + 4) = __ldg(reinterpret_cast<const float4*>(beta + c8 + 4));
      uint32_t* uw = reinterpret_cast<uint32_t*>(&u[j]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = unpack_bf16x2(uw[e]);
        uw[e] = pack_bf16x2(ln_one(f.x, mu, rs, ga[2 * e], ba[2 * e]),
                            ln_one(f.y, mu, rs, ga[2 * e + 1], ba[2 * e + 1]));
      }
      *reinterpret_cast<uint4*>(h + (size_t)row * K + c8) = u[j];
    }
  }
}

template <int K>
int ln_rows_launch(const bf16* x, const float* g, const float* beta, float eps,
                   const float* mean_in, const float* rstd_in, bf16* h, float* mean_out,
                   float* rstd_out, const int* valid_len, int M, int s_pad, cudaStream_t st) {
  const int blocks = min((M + 7) / 8, 132 * 16);  // 8 warps a block
  ln_rows_kernel<K><<<blocks, 256, 0, st>>>(x, g, beta, eps, mean_in, rstd_in, h, mean_out,
                                            rstd_out, valid_len, M, s_pad);
  return (int)cudaGetLastError();
}

// ---- the computed rows as a list of units ----------------------------------------
// The units of UNIT rows (32 or 64; s_pad a multiple of UNIT) that hold a
// valid row, image by image: image i's first unit is list entry first[i],
// first[bsz] the count. warp 0 of the block builds first[] in shared memory.
template <int UNIT>
__device__ __forceinline__ int units_of(int valid_len, int s_pad) {
  return min(s_pad / UNIT, (max(valid_len, 0) + UNIT - 1) / UNIT);
}

template <int UNIT>
__device__ void list_units(int* first, const int* valid_len, int bsz, int s_pad) {
  const int lane = threadIdx.x & 31;
  const int per = (bsz + 31) / 32, lo = min(bsz, lane * per), hi = min(bsz, lo + per);
  int mine = 0;
  for (int i = lo; i < hi; ++i) mine += units_of<UNIT>(valid_len[i], s_pad);
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  int run = incl - mine;
  for (int i = lo; i < hi; ++i) {
    first[i] = run;
    run += units_of<UNIT>(valid_len[i], s_pad);
  }
  if (lane == 31) first[bsz] = incl;
}

// first row of list entry idx (first[lo] <= idx < first[lo + 1])
template <int UNIT>
__device__ __forceinline__ int unit_row(const int* first, int bsz, int s_pad, int idx) {
  int lo = 0, hi = bsz;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (first[mid] <= idx) lo = mid;
    else hi = mid;
  }
  return lo * s_pad + (idx - first[lo]) * UNIT;
}

// ---- K1a, K1c and K2b: out = epilogue(A B) on 128-row tiles ---------------------------
// A (M, K) is the activations, K-major, read in units of 64 rows (a warpgroup
// each); B is W, either (N, K) in Linear layout (K-major: the forward's
// out = A W^T) or (K, N) (MN-major: the data gradient's dX = dY W). A tile is
// two units, consecutive in the list of computed units (so maybe of two
// images), by BN of the N columns: a persistent grid walks the tiles of the
// computed units only, so every block gets the same share of products; K is
// staged 64 at a time through the ring. The epilogue stages each warpgroup's
// rows in shared memory and stores the rows of the unit's computed 32-row
// tiles 16 bytes a thread. The producer warpgroup's three idle warps write
// the zeros of the 32-row tiles past valid_len while the consumers multiply.
//
// The epilogues, rounding as the D 192 kernels: EPI_BIAS (K1a) bf16(bf16(s) +
// b); EPI_BIAS_RELU (K1c) relu of that; EPI_BIAS_RESIDUAL (K1b) bf16(aux +
// that); the data gradient's (gemm_common.cuh) bf16(s), bf16(s [aux > 0])
// and bf16(aux + s), s the f32 sums. The mask or
// residual tile is TMA'd into the warpgroup's staging while the tile's later K
// slices multiply (the staging is free once both warpgroups have passed the
// tile's first slice), in the 128-byte swizzle of its boxes; the epilogue
// turns it into the output in place.
constexpr int EPI_BIAS = 3, EPI_BIAS_RELU = 4, EPI_BIAS_RESIDUAL = 5;  // after gemm_common.cuh's
constexpr int UNIT = 64;                        // rows of a unit: a warpgroup's
constexpr int GRID_MAX = 132;                   // the card's SMs: a block each
// the block: the two consumer warpgroups and a whole producer warpgroup (one
// thread of it loads, three warps write the zero tiles), so that setmaxnreg
// can give the consumers 232 registers a thread and the producers 40: at the
// launch's 168 (65 536 over three warpgroups) K1a's staged epilogue spilled
constexpr int GEMM_THREADS = 128 * (CONSUMERS + 1);
constexpr int ZERO_THREADS = 96;                // the producer warpgroup's other three warps
constexpr int NARROW_N = 192;                   // K1b's and K2b's column tile at N 768

template <int N_, int K_, int BN_, int EPI_>
struct Gemm {
  static constexpr int N = N_, K = K_, BN = BN_, EPI = EPI_;
  static constexpr bool FWD =  // B = W (N, K)
      EPI == EPI_BIAS || EPI == EPI_BIAS_RELU || EPI == EPI_BIAS_RESIDUAL;
  static constexpr bool AUX = EPI == EPI_RELU_MASK || EPI == EPI_RESIDUAL || EPI == EPI_BIAS_RESIDUAL;
  static constexpr int KT = K / BOX;                // K slices of a tile
  static constexpr int CT = N / BN;                 // column tiles
  static constexpr int STAGES = BN == TILE_N ? 3 : 4;
  static constexpr int HALF = UNIT * BOX * 2;       // a unit's rows of A, 64 K
  static constexpr int A = 2 * HALF;
  static constexpr int B = BN * BOX * 2;            // BN columns of W, 64 K
  static constexpr int STAGE = A + B;
  // a warpgroup's output rows, in the 128-byte swizzle of the boxes (64
  // columns of 64 rows) that TMA writes the aux operand in: the eight rows of
  // a fragment's 4-byte stores fall in different banks, and a 16-byte chunk
  // of a row stays whole
  static constexpr int OUT = UNIT * BN * 2;
  static constexpr int SMEM = STAGES * STAGE + CONSUMERS * OUT + 1024;
  static_assert(K % BOX == 0 && N % BN == 0 && BN % BOX == 0 && KT > STAGES &&
                    SMEM + 4 * (MAX_IMAGES + 1) + 128 <= 227 * 1024,
                "wgmma GEMM tile shape");
};

// the staged output's element (r, c) of a warpgroup's rows
__device__ __forceinline__ int staged_at(int r, int c) {
  return c / BOX * (UNIT * BOX) + r * BOX + ((c % BOX / 8) ^ (r % 8)) * 8 + c % 8;
}

template <int N, int K, int BN, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
linear_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                    const __grid_constant__ CUtensorMap b_map, const bf16* __restrict__ bias,
                    bf16* __restrict__ out, const int* __restrict__ valid_len, int M, int s_pad,
                    int bsz, const __grid_constant__ CUtensorMap aux_map) {
  using G = Gemm<N, K, BN, EPI>;
  __shared__ int first[MAX_IMAGES + 1];  // index of each image's first computed unit
  __shared__ __align__(8) uint64_t full[G::STAGES], empty[G::STAGES], aux_full[CONSUMERS];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_1024(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  if (warp == 0) list_units<UNIT>(first, valid_len, bsz, s_pad);
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], RELEASES);
    }
    if constexpr (G::AUX)
      for (int c = 0; c < CONSUMERS; ++c) wg::mbar_init(&aux_full[c], 1);
    wg::mbar_fence_init();
  }
  __syncthreads();
  const int units = first[bsz], tiles = (units + 1) / 2 * G::CT;

  if (warp >= PRODUCER_WARP) {
    wg::setmaxnreg_dec<40>();
    if (warp == PRODUCER_WARP && lane == 0) {  // one thread keeps the ring's loads in flight
      wg::tma_prefetch(&a_map);
      wg::tma_prefetch(&b_map);
      if constexpr (G::AUX) wg::tma_prefetch(&aux_map);
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int p = t / G::CT, n0 = t % G::CT * BN;
        // the tile's two units; an odd last one pairs with rows past M (zeros)
        const int ra = unit_row<UNIT>(first, bsz, s_pad, 2 * p);
        const int rb = 2 * p + 1 < units ? unit_row<UNIT>(first, bsz, s_pad, 2 * p + 1) : M;
        for (int kt = 0; kt < G::KT; ++kt, ++it) {
          const int s = it % G::STAGES;
          wg::mbar_wait(&empty[s], ((it / G::STAGES) & 1) ^ 1);
          unsigned char* st = ring + s * G::STAGE;
          wg::mbar_expect_tx(&full[s], G::STAGE);
          wg::tma_load_2d(st, &a_map, &full[s], kt * BOX, ra);
          wg::tma_load_2d(st + G::HALF, &a_map, &full[s], kt * BOX, rb);
          if constexpr (G::FWD) {
            wg::tma_load_2d(st + G::A, &b_map, &full[s], kt * BOX, n0);
          } else {
#pragma unroll
            for (int c = 0; c < BN / BOX; ++c)
              wg::tma_load_2d(st + G::A + c * (BOX * BOX * 2), &b_map, &full[s], n0 + c * BOX,
                              kt * BOX);
          }
          if constexpr (G::AUX) {
            // the wait above saw both warpgroups release the tile's first
            // slice, so both are done with their staging: the aux tiles go there
            if (kt == G::STAGES) {
#pragma unroll
              for (int c = 0; c < CONSUMERS; ++c) {
                unsigned char* stg = ring + G::STAGES * G::STAGE + c * G::OUT;
                wg::mbar_expect_tx(&aux_full[c], G::OUT);
#pragma unroll
                for (int b = 0; b < BN / BOX; ++b)
                  wg::tma_load_2d(stg + b * (UNIT * BOX * 2), &aux_map, &aux_full[c],
                                  n0 + b * BOX, c == 0 ? ra : rb);
              }
            }
          }
        }
      }
    }
    if (warp > PRODUCER_WARP) {  // the rows of the 32-row tiles past valid_len
      const int zt = threadIdx.x - (PRODUCER_WARP + 1) * 32;
      for (int tile = blockIdx.x; tile < M / ROW_TILE; tile += gridDim.x) {
        const int r0 = tile * ROW_TILE, b = r0 / s_pad;
        if (r0 - b * s_pad < valid_len[b]) continue;
        for (int c = zt; c < ROW_TILE * (N / 8); c += ZERO_THREADS)
          *reinterpret_cast<uint4*>(out + (size_t)(r0 + c / (N / 8)) * N + c % (N / 8) * 8) =
              make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }

  // consumers: warpgroup wgi owns unit 2 p + wgi of tile p's pair
  wg::setmaxnreg_inc<232>();
  const int wgi = warp / 4, q = warp % 4;
  const int g = lane >> 2, tq = lane & 3;
  float acc[BN / 2];
  int it = 0, done = 0;  // done: the tiles this block has finished
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++done) {
    const int unit = t / G::CT * 2 + wgi, n0 = t % G::CT * BN;
    for (int kt = 0; kt < G::KT; ++kt, ++it) {
      const int s = it % G::STAGES;
      wg::mbar_wait(&full[s], (it / G::STAGES) & 1);
      const unsigned char* a = ring + s * G::STAGE + wgi * G::HALF;
      const unsigned char* b = ring + s * G::STAGE + G::A;
      wg::fence_operand(acc);
      wg::fence();
#pragma unroll
      for (int j = 0; j < BOX / 16; ++j) {  // k16 steps
        // A: 32 bytes along the swizzled rows; B: the same (K-major), or 16
        // rows down its 64-column boxes, LBO the step from box to box (MN-major)
        const uint64_t da = wg::desc_sw128(a + 32 * j, 16, 1024);
        if constexpr (G::FWD)
          wg::mma_m64k16<BN, 0, 0>(acc, da, wg::desc_sw128(b + 32 * j, 16, 1024), (kt | j) != 0);
        else
          wg::mma_m64k16<BN, 0, 1>(acc, da, wg::desc_sw128(b + 2048 * j, BOX * BOX * 2, 1024),
                                   (kt | j) != 0);
      }
      wg::commit();
      wg::fence_operand(acc);
      if (kt > 0) {  // the previous slice's products are done: its stage is free
        wg::wait<1>();
        if (lane == 0) wg::mbar_arrive(&empty[(it - 1) % G::STAGES]);
      }
    }
    wg::wait<0>();
    if (lane == 0) wg::mbar_arrive(&empty[(it - 1) % G::STAGES]);
    wg::fence_operand(acc);
    if constexpr (G::AUX) wg::mbar_wait(&aux_full[wgi], done & 1);
    if (unit >= units) continue;  // the odd last tile's empty half

    // epilogue: the sums through the epilogue into bf16, staged in shared
    // memory, then stored 16 bytes a thread on the rows of the unit's
    // computed 32-row tiles
    bf16* staged = reinterpret_cast<bf16*>(ring + G::STAGES * G::STAGE + wgi * G::OUT);
    // the warpgroup is done with its previous tile's rows (with an aux operand,
    // it was before the producer's wait that let its TMA write them)
    if constexpr (!G::AUX) wg::bar_sync(1 + wgi, 128);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rl = 16 * q + g + 8 * hh;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        uint32_t* at = reinterpret_cast<uint32_t*>(staged + staged_at(rl, 8 * j + 2 * tq));
        float v0 = acc[4 * j + 2 * hh], v1 = acc[4 * j + 2 * hh + 1];
        if constexpr (G::FWD) {
          const float2 bb = unpack_bf16x2(
              __ldg(reinterpret_cast<const unsigned int*>(bias + n0 + 8 * j + 2 * tq)));
          v0 = rnd<bf16>(rnd<bf16>(v0) + bb.x);
          v1 = rnd<bf16>(rnd<bf16>(v1) + bb.y);
          if constexpr (EPI == EPI_BIAS_RELU) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
        }
        if constexpr (EPI == EPI_RELU_MASK) {
          const float2 m = unpack_bf16x2(*at);
          v0 = m.x > 0.f ? v0 : 0.f;
          v1 = m.y > 0.f ? v1 : 0.f;
        }
        if constexpr (EPI == EPI_RESIDUAL || EPI == EPI_BIAS_RESIDUAL) {
          const float2 r = unpack_bf16x2(*at);
          v0 = r.x + v0;
          v1 = r.y + v1;
        }
        *at = pack_bf16x2(v0, v1);
      }
    }
    wg::bar_sync(1 + wgi, 128);
    const int r0 = unit_row<UNIT>(first, bsz, s_pad, unit);
    const int img = r0 / s_pad;
    const int live = min(UNIT, (valid_len[img] - (r0 - img * s_pad) + ROW_TILE - 1) /
                                   ROW_TILE * ROW_TILE);
    for (int c = threadIdx.x % 128; c < live * (BN / 8) && STORE; c += 128) {
      const int r = c / (BN / 8), ch = c % (BN / 8);
      *reinterpret_cast<uint4*>(out + (size_t)(r0 + r) * N + n0 + ch * 8) =
          *reinterpret_cast<const uint4*>(staged + staged_at(r, ch * 8));
    }
    // the staging's next aux tile comes by TMA (the async proxy)
    if constexpr (G::AUX) wg::fence_proxy_async();
  }
}

// one launch of linear_wgmma_kernel: a (M, K) K-major; w (N, K) (forward) or
// (K, N) (data gradient); aux (M, N) with the mask and residual epilogues;
// bias (N,) with the forward's
template <int N, int K, int BN, int EPI>
int gemm_launch(const bf16* a, const bf16* w, const bf16* aux, const bf16* bias, bf16* out,
                const int* valid_len, int M, int s_pad, cudaStream_t st) {
  using G = Gemm<N, K, BN, EPI>;
  CUtensorMap a_map, b_map, aux_map;
  int e;
  if ((e = wg::make_map_2d(&a_map, a, K, M, (uint64_t)K * 2, BOX, UNIT)) != 0) return e;
  if (G::FWD)
    e = wg::make_map_2d(&b_map, w, K, N, (uint64_t)K * 2, BOX, BN);
  else
    e = wg::make_map_2d(&b_map, w, N, K, (uint64_t)N * 2, BOX, BOX);
  if (e != 0) return e;
  aux_map = a_map;  // a placeholder where there is no aux operand
  if (G::AUX && (e = wg::make_map_2d(&aux_map, aux, N, M, (uint64_t)N * 2, BOX, UNIT)) != 0)
    return e;
  auto kernel = linear_wgmma_kernel<N, K, BN, EPI>;
  if ((e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     G::SMEM)) != 0)
    return e;
  const int most = (M / UNIT + 1) / 2 * G::CT;  // the tiles if every row were computed
  kernel<<<min(most, GRID_MAX), GEMM_THREADS, G::SMEM, st>>>(
      a_map, b_map, bias, out, valid_len, M, s_pad, M / s_pad, aux_map);
  return (int)cudaGetLastError();
}

// ---- K1b's LayerNorm of r --------------------------------------------------------------
// One warp a row, rows strided over the grid: lanes 0..23 hold the 8 columns
// 192 q + 8 lane .. + 7 of each 192-column part q of the row; for each part
// the lane sums its columns in order (s += v, ss = fmaf(v, v, ss)) and the
// warp adds the lanes (warp_sum), then the parts' sums are added for q = 0,
// 1, ... in order; mu = s / D, rstd = rsqrtf(max(fmaf(-mu, mu, ss / D), 0) +
// eps) and out = bf16(fmaf((r - mu) rstd, g, beta)): the column cluster's
// arithmetic as nvcc compiled it (tests/torch_bf16_order.py). r may be out
// itself (a lane reads its columns of the row before it writes them). The
// zero-filled tiles' rows: out and the stats zeros (r holds the GEMM's zeros).
constexpr int LN_PART = D_MODEL;        // the columns of one partial sum
constexpr int LN_LANES = LN_PART / 8;   // the lanes that hold a part's columns

template <int D>
__global__ void __launch_bounds__(256)
res_ln_rows_bf16_kernel(const bf16* r, const float* __restrict__ gamma,
                        const float* __restrict__ beta, float eps, bf16* out,
                        float* __restrict__ mean_out, float* __restrict__ rstd_out,
                        const int* __restrict__ valid_len, int M, int s_pad) {
  constexpr int Q = D / LN_PART;
  const int lane = threadIdx.x & 31, c8 = lane * 8;
  const int warps = gridDim.x * (blockDim.x / 32);
  for (int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32; row < M; row += warps) {
    bf16* orow = out + (size_t)row * D;
    const int b = row / s_pad, local = row - b * s_pad;
    if (local / ROW_TILE * ROW_TILE >= valid_len[b]) {  // a zero-filled tile: uniform
      if (lane < LN_LANES)
#pragma unroll
        for (int q = 0; q < Q; ++q)
          *reinterpret_cast<uint4*>(orow + LN_PART * q + c8) = make_uint4(0, 0, 0, 0);
      if (mean_out != nullptr && lane == 0) {
        mean_out[row] = 0.f;
        rstd_out[row] = 0.f;
      }
      continue;
    }
    uint4 u[Q];
    float ts = 0.f, tss = 0.f;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      u[q] = make_uint4(0, 0, 0, 0);
      if (lane < LN_LANES)
        u[q] = *reinterpret_cast<const uint4*>(r + (size_t)row * D + LN_PART * q + c8);
      const uint32_t* uw = reinterpret_cast<const uint32_t*>(&u[q]);
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = unpack_bf16x2(uw[e]);
        s += f.x;
        ss = fmaf(f.x, f.x, ss);
        s += f.y;
        ss = fmaf(f.y, f.y, ss);
      }
      s = warp_sum(s);
      ss = warp_sum(ss);
      ts = q == 0 ? s : ts + s;  // in q order
      tss = q == 0 ? ss : tss + ss;
    }
    const float mu = ts / D;
    const float rstd = rsqrtf(fmaxf(fmaf(-mu, mu, tss / D), 0.f) + eps);
    if (lane < LN_LANES)
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        float ga[8], ba[8];
        const int c = LN_PART * q + c8;
        *reinterpret_cast<float4*>(ga) = __ldg(reinterpret_cast<const float4*>(gamma + c));
        *reinterpret_cast<float4*>(ga + 4) = __ldg(reinterpret_cast<const float4*>(gamma + c + 4));
        *reinterpret_cast<float4*>(ba) = __ldg(reinterpret_cast<const float4*>(beta + c));
        *reinterpret_cast<float4*>(ba + 4) = __ldg(reinterpret_cast<const float4*>(beta + c + 4));
        uint32_t* uw = reinterpret_cast<uint32_t*>(&u[q]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = unpack_bf16x2(uw[e]);
          uw[e] = pack_bf16x2(
              fmaf(__fmul_rn(__fsub_rn(f.x, mu), rstd), ga[2 * e], ba[2 * e]),
              fmaf(__fmul_rn(__fsub_rn(f.y, mu), rstd), ga[2 * e + 1], ba[2 * e + 1]));
        }
        *reinterpret_cast<uint4*>(orow + c) = u[q];
      }
    if (mean_out != nullptr && lane == 0) {
      mean_out[row] = mu;
      rstd_out[row] = rstd;
    }
  }
}

// ---- K2c: dW = dY^T X', db = colsum dY ----------------------------------------------
constexpr int WQ_STAGES = 4;
constexpr int WQ_UNIT = 2 * ROW_TILE;               // rows of a unit: two computed 32-row tiles
constexpr int WQ_CHUNK = WQ_UNIT * BOX * 2;         // 64 rows of 64 features
constexpr int WQ_A = (TILE_M / BOX) * WQ_CHUNK;     // dY: the tile's 128 columns
constexpr int WQ_B = (TILE_N / BOX) * WQ_CHUNK;     // X': the tile's 256 columns
constexpr int WQ_STAGE = WQ_A + WQ_B;
constexpr int WQ_SMEM = WQ_STAGES * WQ_STAGE + 1024;
constexpr int WQ_SLOT = TILE_M * TILE_N + TILE_M;   // floats of a partial: the dW tile, then db

__global__ void __launch_bounds__(WG_THREADS, 1)
linear_wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap dy_map,
                          const __grid_constant__ CUtensorMap x_map, float* __restrict__ partial,
                          const int* __restrict__ valid_len, int M, int N, int K, int s_pad,
                          int bsz) {
  __shared__ int first[MAX_IMAGES + 1];  // index of each image's first computed tile
  __shared__ __align__(8) uint64_t full[WQ_STAGES], empty[WQ_STAGES];
  __shared__ __align__(128) bf16 ones[256];  // the B operand of db = dY^T 1
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_1024(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;

  // the list of computed tiles, image by image
  if (warp == 0) list_units<ROW_TILE>(first, valid_len, bsz, s_pad);
  for (int i = threadIdx.x; i < 256; i += WG_THREADS) ones[i] = __float2bfloat16(1.f);
  wg::fence_proxy_async();  // the ones, written by plain stores, are read by wgmma
  if (threadIdx.x == 0) {
    for (int s = 0; s < WQ_STAGES; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], RELEASES);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  // this block's share of the units (tile-major): [ub, ue) of T * C
  const int n32 = first[bsz], units = (n32 + 1) / 2;  // C: units of a tile
  const int ktiles = K / TILE_N;
  const long long total = (long long)(N / TILE_M) * ktiles * units;
  const int ub = (int)(blockIdx.x * total / gridDim.x);
  const int ue = (int)((blockIdx.x + 1) * total / gridDim.x);

  if (warp == PRODUCER_WARP) {
    if (lane == 0) {
      wg::tma_prefetch(&dy_map);
      wg::tma_prefetch(&x_map);
      auto tile_row = [&](int idx) { return unit_row<ROW_TILE>(first, bsz, s_pad, idx); };
      for (int u = ub, it = 0; u < ue; ++u, ++it) {
        const int t = u / units, c = u % units;
        const int n0 = t / ktiles * TILE_M, k0 = t % ktiles * TILE_N;
        // the unit's two tiles; an odd last one pairs with rows past M (zeros)
        const int ra = tile_row(2 * c), rb = 2 * c + 1 < n32 ? tile_row(2 * c + 1) : M;
        const int s = it % WQ_STAGES;
        wg::mbar_wait(&empty[s], ((it / WQ_STAGES) & 1) ^ 1);
        unsigned char* st = ring + s * WQ_STAGE;
        wg::mbar_expect_tx(&full[s], WQ_STAGE);
#pragma unroll
        for (int ch = 0; ch < TILE_M / BOX; ++ch) {
          wg::tma_load_2d(st + ch * WQ_CHUNK, &dy_map, &full[s], n0 + ch * BOX, ra);
          wg::tma_load_2d(st + ch * WQ_CHUNK + WQ_CHUNK / 2, &dy_map, &full[s], n0 + ch * BOX, rb);
        }
#pragma unroll
        for (int ch = 0; ch < TILE_N / BOX; ++ch) {
          wg::tma_load_2d(st + WQ_A + ch * WQ_CHUNK, &x_map, &full[s], k0 + ch * BOX, ra);
          wg::tma_load_2d(st + WQ_A + ch * WQ_CHUNK + WQ_CHUNK / 2, &x_map, &full[s],
                          k0 + ch * BOX, rb);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wgi owns dW rows 64 wgi .. 64 wgi + 63 of the tile
  const int wgi = warp / 4, q = warp % 4;
  const int g = lane >> 2, tq = lane & 3;
  float acc[128], dbacc[4];
  int it = 0;
  for (int u = ub; u < ue;) {  // a segment: this block's units of tile t
    const int t = u / units, k0 = t % ktiles * TILE_N;
    const int seg_end = min(ue, (t + 1) * units);
    for (int v = u; v < seg_end; ++v, ++it) {
      const int s = it % WQ_STAGES;
      wg::mbar_wait(&full[s], (it / WQ_STAGES) & 1);
      const unsigned char* a = ring + s * WQ_STAGE + wgi * WQ_CHUNK;
      const unsigned char* b = ring + s * WQ_STAGE + WQ_A;
      wg::fence_operand(acc);
      wg::fence_operand(dbacc);
      wg::fence();
#pragma unroll
      for (int j = 0; j < WQ_UNIT / 16; ++j) {  // k16 steps: 16 rows, 2048 bytes down the chunks
        const int keep = v > u || j > 0;
        const uint64_t da = wg::desc_sw128(a + 2048 * j, WQ_CHUNK, 1024);
        wg::mma_m64n256k16<1, 1>(acc, da, wg::desc_sw128(b + 2048 * j, WQ_CHUNK, 1024), keep);
        wg::mma_m64n8k16<1, 0>(dbacc, da, wg::desc_plain(ones, 128, 256), keep);
      }
      wg::commit();
      wg::fence_operand(acc);
      wg::fence_operand(dbacc);
      if (v > u) {  // the previous unit's products are done: its stage is free
        wg::wait<1>();
        if (lane == 0) wg::mbar_arrive(&empty[(it - 1) % WQ_STAGES]);
      }
    }
    wg::wait<0>();
    if (lane == 0) wg::mbar_arrive(&empty[(it - 1) % WQ_STAGES]);
    wg::fence_operand(acc);
    wg::fence_operand(dbacc);
    u = seg_end;

    // the segment's partial into slot t + block
    float* p = partial + (size_t)(t + blockIdx.x) * WQ_SLOT;
#pragma unroll
    for (int hh = 0; hh < 2 && STORE; ++hh) {
      const int rl = 64 * wgi + 16 * q + g + 8 * hh;
#pragma unroll
      for (int j = 0; j < TILE_N / 8; ++j)
        *reinterpret_cast<float2*>(p + (size_t)rl * TILE_N + 8 * j + 2 * tq) =
            make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
    if (k0 == 0 && tq == 0 && STORE) {  // every column of the ones product holds the sum
      p[TILE_M * TILE_N + 64 * wgi + 16 * q + g] = dbacc[0];
      p[TILE_M * TILE_N + 64 * wgi + 16 * q + g + 8] = dbacc[2];
    }
  }
}

// dwb (N K + N) = each tile's segment partials added in block order: four
// outputs a thread. A tile's units [t C, t C + C) lie in the shares of blocks
// b(t C) .. b(t C + C - 1), b(u) = ((u + 1) G - 1) / U the block whose share
// holds unit u; blocks with an empty share are skipped.
__global__ void __launch_bounds__(256)
reduce_stream_kernel(const float* __restrict__ partial, float* __restrict__ dwb,
                     const int* __restrict__ valid_len, int N, int K, int s_pad, int bsz,
                     int blocks) {
  __shared__ int n32;
  if (threadIdx.x < 32) {
    int n = 0;
    for (int i = threadIdx.x; i < bsz; i += 32) n += units_of<ROW_TILE>(valid_len[i], s_pad);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
    if (threadIdx.x == 0) n32 = n;
  }
  __syncthreads();
  const int e = 4 * (blockIdx.x * 256 + threadIdx.x);
  if (e >= N * K + N) return;
  const int ktiles = K / TILE_N;
  int t, off;
  if (e < N * K) {
    const int n = e / K, k = e % K;
    t = n / TILE_M * ktiles + k / TILE_N;
    off = n % TILE_M * TILE_N + k % TILE_N;
  } else {
    const int n = e - N * K;
    t = n / TILE_M * ktiles;
    off = TILE_M * TILE_N + n % TILE_M;
  }
  const long long C = (n32 + 1) / 2, G = blocks;
  const long long U = (long long)(N / TILE_M) * ktiles * C;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  if (U > 0) {
    const int bf = (int)(((t * C + 1) * G - 1) / U), bl = (int)(((t * C + C) * G - 1) / U);
    for (int b = bf; b <= bl; ++b) {
      if (b * U / G == (b + 1) * U / G) continue;  // a block with no units
      const float4 v = *reinterpret_cast<const float4*>(partial + (size_t)(t + b) * WQ_SLOT + off);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
  }
  *reinterpret_cast<float4*>(dwb + e) = sum;
}

bool rows_ok_wgmma(int M, int s_pad) {
  return M > 0 && s_pad > 0 && s_pad % ROW_TILE == 0 && M % s_pad == 0;
}

}  // namespace

extern "C" {

// h (M, K) bf16 = LN(x) on the rows of the 32-row tiles that hold a valid
// row (the others are not written), x (M, K) bf16, K 192 or 768, g and beta
// (K,) f32. With mean_in and rstd_in (M,) f32 the row stats are read; else
// they are taken and, where mean_out and rstd_out are not null, written
// (zeros on the zero-filled tiles). s_pad a multiple of 32.
int ln_rows_bf16(const bf16* x, const float* g, const float* beta, float eps,
                 const float* mean_in, const float* rstd_in, bf16* h, float* mean_out,
                 float* rstd_out, const int* valid_len, int M, int K, int s_pad, void* stream) {
  if (!rows_ok_wgmma(M, s_pad) || (K != D_MODEL && K != D_WIDE) ||
      (mean_in == nullptr) != (rstd_in == nullptr) ||
      (mean_out == nullptr) != (rstd_out == nullptr) ||
      (mean_in != nullptr && mean_out != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K == D_WIDE)
    return ln_rows_launch<D_WIDE>(x, g, beta, eps, mean_in, rstd_in, h, mean_out, rstd_out,
                                  valid_len, M, s_pad, st);
  return ln_rows_launch<D_MODEL>(x, g, beta, eps, mean_in, rstd_in, h, mean_out, rstd_out,
                                 valid_len, M, s_pad, st);
}

// K1a at D 768: x (M, 768), w (2304, 768), bias (2304,), out (M, 2304), bf16;
// g and beta (768,) f32; h (M, 768) bf16 scratch (LN1(x)). mean_out and
// rstd_out (M,) f32 get the LN1 row stats when not null (both or neither);
// zeros on the zero-filled tiles. s_pad a multiple of 64, at most 1024
// images; every pointer 16-byte aligned (the tensor maps').
int ln_linear_fwd_wgmma_bf16(const bf16* x, const float* g, const float* beta, float eps,
                             const bf16* w, const bf16* bias, bf16* out, float* mean_out,
                             float* rstd_out, bf16* h, const int* valid_len, int M, int K, int N,
                             int s_pad, void* stream) {
  if (!rows_ok_wgmma(M, s_pad) || s_pad % UNIT || M / s_pad > MAX_IMAGES || K != D_WIDE ||
      N != 3 * D_WIDE || (mean_out == nullptr) != (rstd_out == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int e = ln_rows_launch<D_WIDE>(x, g, beta, eps, nullptr, nullptr, h, mean_out, rstd_out,
                                       valid_len, M, s_pad, st);
  if (e != 0) return e;
  return gemm_launch<3 * D_WIDE, D_WIDE, TILE_N, EPI_BIAS>(h, w, nullptr, bias, out, valid_len,
                                                           M, s_pad, st);
}

// K1c at D 768: x (M, 768), w (2048, 768), bias (2048,), out (M, 2048), bf16;
// out = relu(bf16(bf16(x w^T) + bias)) on the rows of the 32-row tiles that
// hold a valid row, zeros on the others. s_pad a multiple of 64, at most 1024
// images; every pointer 16-byte aligned. The D 192 instance and the float32
// ones are linear_relu_fwd_bf16's and linear_relu_fwd's.
int linear_relu_fwd_wgmma_bf16(const bf16* x, const bf16* w, const bf16* bias, bf16* out,
                               const int* valid_len, int M, int K, int N, int s_pad,
                               void* stream) {
  if (!rows_ok_wgmma(M, s_pad) || s_pad % UNIT || M / s_pad > MAX_IMAGES || K != D_WIDE ||
      N != D_FFN)
    return (int)cudaErrorInvalidValue;
  return gemm_launch<D_FFN, D_WIDE, TILE_N, EPI_BIAS_RELU>(
      x, w, nullptr, bias, out, valid_len, M, s_pad, static_cast<cudaStream_t>(stream));
}

// K1b at D 768: a (M, K) with K 768 (out-projection) or 2048 (FFN2), w (768,
// K), bias (768,), res and out (M, 768), bf16; g and beta (768,) f32. The
// GEMM writes r = bf16(res + bf16(bf16(a w^T) + bias)) into r_out, or into
// out when r_out is null, zeros on the zero-filled tiles; the row pass writes
// out = LN(r) (g, beta, eps) and, when not null (both or neither), mean_out
// and rstd_out (M,) f32, zeros on the zero-filled tiles. 192-column tiles
// (m64n192k16): four a row of tiles, for the same wave count as K2b's N 768
// sites. s_pad a multiple of 64, at most 1024 images; every pointer 16-byte
// aligned. The D 192 and D 64 instances are linear_residual_ln_fwd_bf16's.
int linear_residual_ln_fwd_wgmma_bf16(const bf16* a, const bf16* w, const bf16* bias,
                                      const bf16* res, const float* g, const float* beta,
                                      float eps, bf16* out, float* mean_out, float* rstd_out,
                                      bf16* r_out, const int* valid_len, int M, int K, int N,
                                      int s_pad, void* stream) {
  if (!rows_ok_wgmma(M, s_pad) || s_pad % UNIT || M / s_pad > MAX_IMAGES || N != D_WIDE ||
      (K != D_WIDE && K != D_FFN) || (mean_out == nullptr) != (rstd_out == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* r = r_out != nullptr ? r_out : out;
  const int e = K == D_FFN ? gemm_launch<D_WIDE, D_FFN, NARROW_N, EPI_BIAS_RESIDUAL>(
                                 a, w, res, bias, r, valid_len, M, s_pad, st)
                           : gemm_launch<D_WIDE, D_WIDE, NARROW_N, EPI_BIAS_RESIDUAL>(
                                 a, w, res, bias, r, valid_len, M, s_pad, st);
  if (e != 0) return e;
  res_ln_rows_bf16_kernel<D_WIDE><<<min((M + 7) / 8, 132 * 16), 256, 0, st>>>(
      r, g, beta, eps, out, mean_out, rstd_out, valid_len, M, s_pad);
  return (int)cudaGetLastError();
}

// K2b at D 768: dy (M, K), w (K, N) (the forward's Linear weight, out x in),
// out (M, N), bf16; epilogue and aux as linear_dgrad_bf16's, at a D 768
// layer's four sites: K 768 -> N 2048 (mask, 256-column tiles), K 2048 -> N
// 768 (residual), K 768 -> N 768 and K 2304 -> N 768 (none; the N 768 sites
// on 192-column tiles: four a row of tiles, so that the tiles of a batch fill
// the card's 132 SMs more evenly than three would). Zeros on the rows of the
// 32-row tiles past valid_len. s_pad a multiple of 64, at most 1024 images;
// every pointer 16-byte aligned.
int linear_dgrad_wgmma_bf16(const bf16* dy, const bf16* w, const bf16* aux, bf16* out,
                            int epilogue, const int* valid_len, int M, int K, int N, int s_pad,
                            void* stream) {
  if (!rows_ok_wgmma(M, s_pad) || s_pad % UNIT || M / s_pad > MAX_IMAGES ||
      (epilogue != EPI_NONE) != (aux != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K == D_WIDE && N == D_FFN && epilogue == EPI_RELU_MASK)
    return gemm_launch<D_FFN, D_WIDE, TILE_N, EPI_RELU_MASK>(dy, w, aux, nullptr, out,
                                                             valid_len, M, s_pad, st);
  if (K == D_FFN && N == D_WIDE && epilogue == EPI_RESIDUAL)
    return gemm_launch<D_WIDE, D_FFN, NARROW_N, EPI_RESIDUAL>(dy, w, aux, nullptr, out,
                                                                 valid_len, M, s_pad, st);
  if (K == D_WIDE && N == D_WIDE && epilogue == EPI_NONE)
    return gemm_launch<D_WIDE, D_WIDE, NARROW_N, EPI_NONE>(dy, w, nullptr, nullptr, out,
                                                              valid_len, M, s_pad, st);
  if (K == 3 * D_WIDE && N == D_WIDE && epilogue == EPI_NONE)
    return gemm_launch<D_WIDE, 3 * D_WIDE, NARROW_N, EPI_NONE>(dy, w, nullptr, nullptr, out,
                                                                  valid_len, M, s_pad, st);
  return (int)cudaErrorInvalidValue;
}

// K2c at D 768: dy (M, N), x (M, K) bf16 at the four weight shapes (N, K) of
// a D 768 layer; dwb (N K + N,) f32 = dW (N, K) row-major, then db (N,). With
// mean (the QKV site, K 768), x is layer-normed with mean, rstd, g, beta (f32)
// into h (M, K) bf16 scratch first. partial: (tiles + blocks - 1, 128 x 256 +
// 128) f32 scratch, tiles = N / 128 x K / 256; blocks the grid (1..1024,
// ops/fused_block.py::WGRAD_WGMMA_BLOCKS). s_pad a multiple of 32.
int linear_wgrad_wgmma_bf16(const bf16* dy, const bf16* x, const float* mean, const float* rstd,
                            const float* g, const float* beta, bf16* h, float* partial,
                            float* dwb, const int* valid_len, int M, int N, int K, int s_pad,
                            int blocks, void* stream) {
  if (!rows_ok_wgmma(M, s_pad) || M / s_pad > MAX_IMAGES || blocks < 1 || blocks > 1024 ||
      !is_weight_shape_at(N, K, D_WIDE) || (mean != nullptr && (K != D_WIDE || h == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bsz = M / s_pad;
  int e;
  const bf16* xs = x;
  if (mean != nullptr) {
    if ((e = ln_rows_launch<D_WIDE>(x, g, beta, 0.f, mean, rstd, h, nullptr, nullptr, valid_len,
                                    M, s_pad, st)) != 0)
      return e;
    xs = h;
  }
  CUtensorMap dy_map, x_map;
  if ((e = wg::make_map_2d(&dy_map, dy, N, M, (uint64_t)N * 2, BOX, ROW_TILE)) != 0) return e;
  if ((e = wg::make_map_2d(&x_map, xs, K, M, (uint64_t)K * 2, BOX, ROW_TILE)) != 0) return e;
  e = (int)cudaFuncSetAttribute(linear_wgrad_wgmma_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, WQ_SMEM);
  if (e != 0) return e;
  linear_wgrad_wgmma_kernel<<<blocks, WG_THREADS, WQ_SMEM, st>>>(dy_map, x_map, partial,
                                                                 valid_len, M, N, K, s_pad, bsz);
  if ((e = (int)cudaGetLastError()) != 0) return e;
  const int n_out4 = (N * K + N) / 4;
  reduce_stream_kernel<<<(n_out4 + 255) / 256, 256, 0, st>>>(partial, dwb, valid_len, N, K, s_pad,
                                                              bsz, blocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
