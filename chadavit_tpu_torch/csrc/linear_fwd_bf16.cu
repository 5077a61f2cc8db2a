// The bf16 forward GEMMs of one ChAdaViT encoder layer, on Hopper's tensor
// cores: ln_linear_fwd_bf16 (K1a, qkv = LN1(x) Wqkv^T + bqkv),
// linear_relu_fwd_bf16 (K1c, hid = relu(x2 W1^T + b1)) and
// linear_residual_ln_fwd_bf16 (K1b, y = LN(res + (a W^T + b)), at the
// out-projection site, K 192, and the FFN2 site, K 2048). Their float32
// instances stay the CUDA-core kernels of fused_block.cu; the function, the
// sites, the rounding points and the row contract are theirs (the header of
// fused_block.cu).
//
// Replaces, with fused_block.cu, the TPU kernel
// chadavit_tpu/ops/fused_block.py::_fwd_kernel (:91), whose bf16 dots run on
// the MXU with f32 accumulation.
//
// What bounds them on an H100: each product has 192 on one side, so at the
// layer's shapes K1c does about 190 operations a byte of its (M, 2048)
// output, K1a about 150 a byte of its (M, 576) output and K1b about 190 a
// byte of its (M, K) input a, all under the 295 at which the bf16 tensor
// cores become the limit: all are bound by bytes, K1a and K1c by what they
// write, K1b by the a it reads. The design is the one of linear_bwd_bf16.cu's
// linear_dgrad (mma_bf16.cuh's helpers):
//
// - mma.sync m16n8k16 (bf16 in, f32 sums) from ldmatrix fragments of
//   swizzled shared-memory tiles; W is in nn.Linear layout (N, K), so its
//   tiles are stored (n, k) and read by ldsm_b. Products of bf16 are exact in
//   f32, so only the order of the f32 sums differs from the plain version.
// - A block owns 64 rows, two 32-row tiles of the contract; cp.async 16-byte
//   copies go through a ring of three stages, so the next slice loads while
//   the current one is multiplied.
// - K1a owns one 192-wide third of the 576 columns (q, k or v) of its 64
//   rows, so the grid is (M / 64, 3) and each block takes the LN1 row stats
//   of its rows itself (the first third's blocks write them). K 192 fits the
//   block whole: its x rows and the third's (192, 192) W tile come once, in
//   three cp.async groups of 64 K columns (the ring's three stages, never
//   reused); while the later groups land, one warp a row takes the f32 stats
//   in fast-variance form with the max(0, .) clamp and overwrites the staged
//   x with h = bf16((x - mean) rstd g + b), so h is the A operand and never
//   reaches device memory. Warps of 32 x 48 multiply each group as it
//   arrives, k16 steps one at a time. The epilogue rounds the sums to bf16,
//   adds the bias, rounds, and stores 16-byte rows through the x tile, free
//   by then.
// - K1c keeps the block's (64, 192) x rows in shared memory and walks 512 of
//   the 2048 columns in slices of 128, W in (128, 64) tiles through the
//   ring. Its epilogue rounds the f32 sums to bf16, adds the bias, rounds,
//   applies the ReLU, and stores 16-byte rows through a shared-memory tile.
// - K1b owns all 192 columns, so the LayerNorm stays in the block, and walks
//   K in slices of 64 (3 at the out projection, 32 at FFN2), a's (64, 64)
//   and W's (192, 64) tiles through the ring. The residual comes with
//   cp.async into the stage the slice after the last would take, while the
//   last two slices multiply. The epilogue rounds the sums, adds the bias,
//   rounds, adds the residual (the JAX order, res + (a W^T + b)) and rounds
//   to r, in place of the residual in shared memory; then one warp a row
//   takes the f32 row stats in fast-variance form with the max(0, .) clamp
//   and writes out, and r, mean and rstd where their pointers are not null.
// - 32-row tiles wholly past valid_len are written as zeros (their stats and
//   r too), also inside a computed 64-row block; every row of a tile that
//   holds a valid row is computed for real. No atomics: the same bits on
//   every run.
//
// At D 768 (ChAdaViT-B/16, FFN 2048) every product has 768 or more on both
// sides, 380 to 580 operations a byte, bound by the tensor cores' operations,
// which mma.sync reaches only a share of: K1a, K1b and K1c there are
// linear_wgmma_bf16.cu's ln_linear_fwd_wgmma_bf16,
// linear_residual_ln_fwd_wgmma_bf16 and linear_relu_fwd_wgmma_bf16 (wgmma and
// TMA); this file's entry points take D 192 and D 64 only.
//
// At D 64 (the smoke configs, FFN 2048) every product has 64 on one side and
// each kernel is bound by its bytes: K1a and K1b are templates on the width
// (K1a's block owns a 64-wide third of qkv's 192 columns, its rows and W in
// one copy group of the 64 K columns; K1b's block owns whole rows of 64
// columns, 32 x 16 a warp, and at the out projection, whose K is one slice,
// the residual joins the ring's prologue), K1c is its K template at K 64. The
// D 192 instances compile to the code they had.
//
// Plain C interface (loaded with ctypes); each launcher returns
// cudaGetLastError() so that the Python wrapper can raise on a refused launch.

#include "gemm_common.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int TC_THREADS = 256;  // 8 warps, 2 (rows) x 4 (columns)
constexpr int STAGES = 3;        // the cp.async ring
constexpr int ROW_TILE = BM;     // the contract's 32-row tile
constexpr int FW_BM = 64;        // rows of a block
constexpr int FW_BK = 64;        // K slice of a ring stage

// Rows of the block [m0, m0 + FW_BM) that lie in 32-row tiles holding a
// valid row: the block computes them, and writes zeros past them. FW_BM
// divides s_pad, so the block lies inside one image.
__device__ __forceinline__ int live_rows(int m0, int s_pad, const int* valid_len) {
  const int b = m0 / s_pad, local = m0 - b * s_pad;
  const int ahead = valid_len[b] - local;
  return ahead <= 0 ? 0 : min(FW_BM, (ahead + ROW_TILE - 1) / ROW_TILE * ROW_TILE);
}

// ---- ln_linear_fwd_bf16 -------------------------------------------------------
// Grid (M / FW_BM, 3). A block owns FW_BM rows and one LNL_BN-wide third of
// the 3 D columns (576 at D 192, 192 at D 64); each warp a 32 x D / 4 tile of
// it. x's rows and the third's W tile are staged whole, in KG groups of
// FW_BK K columns (x with the first): three at D 192, one at D 64.
template <int K_>  // K = D, the width
struct LnLinear {
  static constexpr int K = K_;
  static constexpr int LNL_BN = K;                     // a third of the columns
  static constexpr int N = 3 * K;
  static constexpr int KG = K / FW_BK;                 // copy groups
  static constexpr int WN = LNL_BN / 4;                // a warp's columns
  static constexpr int NT8 = WN / 8;                   // its n8 blocks
  static constexpr int A_ELEMS = FW_BM * K;            // x, then h, then the output rows
  static constexpr int W_ELEMS = LNL_BN * K;           // the third's (n, k) W tile
  static constexpr int SMEM = 2 * (A_ELEMS + W_ELEMS);
  static constexpr int A_CHUNKS = A_ELEMS / 8 / TC_THREADS;           // 16 B of x a thread
  static constexpr int W_CHUNKS = LNL_BN * FW_BK / 8 / TC_THREADS;    // of a group's W
  static_assert((KG == 3 || KG == 1) && NT8 % 2 == 0 && A_CHUNKS * 8 * TC_THREADS == A_ELEMS &&
                    W_CHUNKS * 8 * TC_THREADS == LNL_BN * FW_BK && N % LNL_BN == 0,
                "ln_linear tile shape");
};

template <int K_>
__global__ void __launch_bounds__(TC_THREADS, 2)
ln_linear_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, float eps, const bf16* __restrict__ w,
                      const bf16* __restrict__ bias, bf16* __restrict__ out,
                      float* __restrict__ mean_out, float* __restrict__ rstd_out,
                      const int* __restrict__ valid_len, int s_pad) {
  using C = LnLinear<K_>;
  constexpr int K = C::K, N = C::N, LNL_BN = C::LNL_BN;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ws = As + C::A_ELEMS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.x * FW_BM, n0 = blockIdx.y * LNL_BN;
  const bool write_stats = mean_out != nullptr && blockIdx.y == 0;
  const int live = live_rows(m0, s_pad, valid_len);
  if (live == 0) {  // both 32-row tiles are padding: uniform, before any barrier
    constexpr int ROW_CHUNKS = LNL_BN / 8;
    for (int c = tid; c < FW_BM * ROW_CHUNKS; c += TC_THREADS)
      *reinterpret_cast<uint4*>(out + (size_t)(m0 + c / ROW_CHUNKS) * N + n0 +
                                (c % ROW_CHUNKS) * 8) = make_uint4(0, 0, 0, 0);
    if (write_stats && tid < FW_BM) {
      mean_out[m0 + tid] = 0.f;
      rstd_out[m0 + tid] = 0.f;
    }
    return;
  }

  // group 0: the live x rows (the rows of a padding tile give rows of sums
  // that are never stored) and W's first FW_BK K columns; groups 1, 2: the rest
#pragma unroll
  for (int q = 0; q < C::A_CHUNKS; ++q) {
    const int c = tid + q * TC_THREADS, r = c / (K / 8), cc = c % (K / 8);
    if (r < live) cp_async_16(As + swz<K>(r, cc * 8), x + (size_t)(m0 + r) * K + cc * 8);
  }
#pragma unroll
  for (int gq = 0; gq < C::KG; ++gq) {
#pragma unroll
    for (int q = 0; q < C::W_CHUNKS; ++q) {
      const int c = tid + q * TC_THREADS, r = c / (FW_BK / 8);
      const int cc = gq * (FW_BK / 8) + c % (FW_BK / 8);
      cp_async_16(Ws + swz<K>(r, cc * 8), w + (size_t)(n0 + r) * K + cc * 8);
    }
    cp_async_commit();
  }
  cp_async_wait<C::KG - 1>();
  __syncthreads();  // the x rows are in

  // ---- LN1, one warp a row (lanes 0..23 own 8 columns each): the stats, then
  // h = bf16((x - mean) rstd g + b) in place of x ----------------------------
  {
    constexpr int LANES = K / 8;
    const int c8 = lane * 8;
    float ga[8], ba[8];
    if (lane < LANES) {
      *reinterpret_cast<float4*>(ga) = __ldg(reinterpret_cast<const float4*>(gamma + c8));
      *reinterpret_cast<float4*>(ga + 4) = __ldg(reinterpret_cast<const float4*>(gamma + c8 + 4));
      *reinterpret_cast<float4*>(ba) = __ldg(reinterpret_cast<const float4*>(beta + c8));
      *reinterpret_cast<float4*>(ba + 4) = __ldg(reinterpret_cast<const float4*>(beta + c8 + 4));
    }
    for (int row = warp; row < FW_BM; row += TC_THREADS / 32) {
      if (row >= live) {  // a zero-filled 32-row tile: uniform across the warp
        if (write_stats && lane == 0) {
          mean_out[m0 + row] = 0.f;
          rstd_out[m0 + row] = 0.f;
        }
        continue;
      }
      uint4 u = make_uint4(0, 0, 0, 0);
      uint4* p = reinterpret_cast<uint4*>(As + swz<K>(row, c8));
      if (lane < LANES) u = *p;
      uint32_t* uw = reinterpret_cast<uint32_t*>(&u);
      float v[8];
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = unpack_bf16x2(uw[e]);
        v[2 * e] = f.x;
        v[2 * e + 1] = f.y;
        s += f.x + f.y;
        ss += f.x * f.x + f.y * f.y;
      }
      s = warp_sum(s);
      ss = warp_sum(ss);
      const float mu = s / K;
      const float rstd = rsqrtf(fmaxf(ss / K - mu * mu, 0.f) + eps);
      if (lane < LANES) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          uw[e] = pack_bf16x2((v[2 * e] - mu) * rstd * ga[2 * e] + ba[2 * e],
                              (v[2 * e + 1] - mu) * rstd * ga[2 * e + 1] + ba[2 * e + 1]);
        *p = u;
      }
      if (write_stats && lane == 0) {
        mean_out[m0 + row] = mu;
        rstd_out[m0 + row] = rstd;
      }
    }
  }

  float acc[2][C::NT8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  auto multiply = [&](int gq) {  // the K columns of copy group gq
    // k16 steps one at a time: the fragments of four steps of a 32 x 48 warp
    // tile do not fit the 128 registers of two blocks an SM
#pragma unroll 1
    for (int kk = gq * FW_BK; kk < (gq + 1) * FW_BK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) ldsm_a<K>(af[mt], As, wm * 32 + mt * 16, kk);
#pragma unroll
      for (int np = 0; np < C::NT8 / 2; ++np) {
        uint32_t bf[4];
        ldsm_b<K>(bf, Ws, kk, wn * C::WN + np * 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  };
  __syncthreads();  // h is in place (and group 0's W columns)
  multiply(0);
  if constexpr (C::KG == 3) {
    cp_async_wait<C::KG - 2>();
    __syncthreads();  // group 1 is in
    multiply(1);
    cp_async_wait<0>();
    __syncthreads();  // group 2 is in
    multiply(2);
  }
  __syncthreads();  // every warp is done with h: its tile takes the output rows

  // ---- epilogue: sums -> bf16 -> + bias -> bf16, 16-byte rows via the tile ----
  bf16* Es = As;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < C::NT8; ++nt) {
    const int col = wn * C::WN + nt * 8 + 2 * t;
    const float2 bb = unpack_bf16x2(__ldg(reinterpret_cast<const unsigned int*>(bias + n0 + col)));
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + mt * 16 + g + 8 * h;
        float v0 = rnd<bf16>(rnd<bf16>(acc[mt][nt][2 * h]) + bb.x);
        float v1 = rnd<bf16>(rnd<bf16>(acc[mt][nt][2 * h + 1]) + bb.y);
        if (r >= live) v0 = v1 = 0.f;
        *reinterpret_cast<uint32_t*>(Es + swz<LNL_BN>(r, col)) = pack_bf16x2(v0, v1);
      }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < C::A_CHUNKS; ++q) {
    const int c = tid + q * TC_THREADS, r = c / (LNL_BN / 8), cc = c % (LNL_BN / 8);
    *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * N + n0 + cc * 8) =
        *reinterpret_cast<const uint4*>(Es + swz<LNL_BN>(r, cc * 8));
  }
}

// ---- linear_relu_fwd_bf16 -----------------------------------------------------
// Grid (M / FW_BM, D_FFN / (RELU_SLICES * RELU_BN)). A block owns FW_BM rows
// and RELU_SLICES column slices of RELU_BN, walked in order; each warp a
// 32 x 32 tile of the slice. K = D, 192 or 64 (a template on it, as when it
// was also built for D 768, so that the D 192 kernel keeps its name and code).
constexpr int RELU_BN = 128;
constexpr int RELU_SLICES = 4;

template <int K_>
struct Relu {
  static constexpr int K = K_;
  static constexpr int KT = K / FW_BK;            // K slices of a column slice
  static constexpr int ITERS = RELU_SLICES * KT;
  static constexpr int WN = RELU_BN / 4;          // a warp's columns
  static constexpr int NT8 = WN / 8;              // its n8 blocks
  static constexpr int A_ELEMS = FW_BM * K;       // the block's x rows, staged once
  static constexpr int B_STAGE = RELU_BN * FW_BK;  // a (n, k) tile of W
  static constexpr int E_ELEMS = FW_BM * RELU_BN;  // the epilogue's tile
  static constexpr int SMEM = 2 * (A_ELEMS + STAGES * B_STAGE + E_ELEMS);
  static constexpr int CHUNKS = E_ELEMS / 8 / TC_THREADS;  // 16 B of a slice a thread
  static_assert(K % FW_BK == 0 && NT8 % 2 == 0 && ITERS >= STAGES - 1 &&
                    CHUNKS * 8 * TC_THREADS == E_ELEMS,
                "linear_relu tile shape");
};

template <int K_>
__global__ void __launch_bounds__(TC_THREADS, 2)
linear_relu_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        const bf16* __restrict__ bias, bf16* __restrict__ out,
                        const int* __restrict__ valid_len, int s_pad) {
  using C = Relu<K_>;
  constexpr int N = D_FFN, K = C::K;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Bs = As + C::A_ELEMS;
  bf16* Es = Bs + STAGES * C::B_STAGE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.x * FW_BM;
  const int ncol0 = blockIdx.y * RELU_SLICES * RELU_BN;
  const int live = live_rows(m0, s_pad, valid_len);
  if (live == 0) {  // both 32-row tiles are padding: uniform, before any barrier
    constexpr int ROW_CHUNKS = RELU_SLICES * RELU_BN / 8;
    for (int c = tid; c < FW_BM * ROW_CHUNKS; c += TC_THREADS)
      *reinterpret_cast<uint4*>(out + (size_t)(m0 + c / ROW_CHUNKS) * N + ncol0 +
                                (c % ROW_CHUNKS) * 8) = make_uint4(0, 0, 0, 0);
    return;
  }

  auto load = [&](int it) {  // W rows of column slice it / KT, K slice it % KT
    const int j = it / C::KT, i = it % C::KT;
    bf16* bs = Bs + (it % STAGES) * C::B_STAGE;
    const bf16* src = w + (size_t)(ncol0 + j * RELU_BN) * K + i * FW_BK;
#pragma unroll
    for (int q = 0; q < C::B_STAGE / 8 / TC_THREADS; ++q) {
      const int c = tid + q * TC_THREADS, r = c / (FW_BK / 8), cc = c % (FW_BK / 8);
      cp_async_16(bs + swz<FW_BK>(r, cc * 8), src + (size_t)r * K + cc * 8);
    }
  };
#pragma unroll
  for (int q = 0; q < C::A_ELEMS / 8 / TC_THREADS; ++q) {  // in the first group, with slice 0
    const int c = tid + q * TC_THREADS, r = c / (K / 8), cc = c % (K / 8);
    cp_async_16(As + swz<K>(r, cc * 8), x + (size_t)(m0 + r) * K + cc * 8);
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    load(s);
    cp_async_commit();
  }

  const int g = lane >> 2, t = lane & 3;
  float acc[2][C::NT8][4];
  for (int it = 0; it < C::ITERS; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice it is in; every warp is done with slice it - 1
    if (it + STAGES - 1 < C::ITERS) load(it + STAGES - 1);
    cp_async_commit();
    const int j = it / C::KT, i = it % C::KT;
    if (i == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < C::NT8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
    const bf16* bs = Bs + (it % STAGES) * C::B_STAGE;
#pragma unroll
    for (int kk = 0; kk < FW_BK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) ldsm_a<K>(af[mt], As, wm * 32 + mt * 16, i * FW_BK + kk);
#pragma unroll
      for (int np = 0; np < C::NT8 / 2; ++np) {
        uint32_t bf[4];
        ldsm_b<FW_BK>(bf, bs, kk, wn * C::WN + np * 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
    if (i != C::KT - 1) continue;

    // ---- epilogue of column slice j: sums -> bf16 -> + bias -> bf16 -> relu ----
    // (Es was last read by the previous slice's stores, before the barriers
    // at the top of this slice's iterations)
    const int n0 = ncol0 + j * RELU_BN;
#pragma unroll
    for (int nt = 0; nt < C::NT8; ++nt) {
      const int col = wn * C::WN + nt * 8 + 2 * t;
      const float2 bb = unpack_bf16x2(__ldg(reinterpret_cast<const unsigned int*>(bias + n0 + col)));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + mt * 16 + g + 8 * h;
          float v0 = fmaxf(rnd<bf16>(rnd<bf16>(acc[mt][nt][2 * h]) + bb.x), 0.f);
          float v1 = fmaxf(rnd<bf16>(rnd<bf16>(acc[mt][nt][2 * h + 1]) + bb.y), 0.f);
          if (r >= live) v0 = v1 = 0.f;
          *reinterpret_cast<uint32_t*>(Es + swz<RELU_BN>(r, col)) = pack_bf16x2(v0, v1);
        }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < C::CHUNKS; ++q) {
      const int c = tid + q * TC_THREADS, r = c / (RELU_BN / 8), cc = c % (RELU_BN / 8);
      *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * N + n0 + cc * 8) =
          *reinterpret_cast<const uint4*>(Es + swz<RELU_BN>(r, cc * 8));
    }
  }
  cp_async_wait<0>();
}

// ---- linear_residual_ln_fwd_bf16 ------------------------------------------------
// Grid (M / FW_BM). A block owns FW_BM rows, whole: N = LN_N = 192 columns
// (N = 64 at D 64); each warp a 32 x N / 4 tile. The ring's stages hold a's
// (64, 64) and W's (N, 64) tiles of one K slice.
constexpr int LN_N = D_MODEL;

template <int K, int N = LN_N>  // N: the block's columns
struct ResLn {
  static constexpr int KT = K / FW_BK;
  static constexpr int WN = N / 4;
  static constexpr int NT8 = WN / 8;
  static constexpr int A_STAGE = FW_BM * FW_BK;
  static constexpr int STAGE = A_STAGE + N * FW_BK;
  static constexpr int SMEM = 2 * STAGES * STAGE;
  static constexpr int CHUNKS = FW_BM * N / 8 / TC_THREADS;  // 16 B of the rows a thread
  static_assert(K % FW_BK == 0 && KT >= 1 && NT8 % 2 == 0 &&
                    CHUNKS * 8 * TC_THREADS == FW_BM * N,
                "linear_residual_ln tile shape");
  static_assert(FW_BM * N <= STAGE, "the residual tile fits a stage");
};

template <int K, int N_>
__global__ void __launch_bounds__(TC_THREADS, 2)
linear_residual_ln_bf16_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                               const bf16* __restrict__ bias, const bf16* __restrict__ res,
                               const float* __restrict__ gamma,
                               const float* __restrict__ beta, float eps,
                               bf16* __restrict__ out, float* __restrict__ mean_out,
                               float* __restrict__ rstd_out, bf16* __restrict__ r_out,
                               const int* __restrict__ valid_len, int s_pad) {
  using C = ResLn<K, N_>;
  constexpr int N = N_;         // the block's columns: the row's
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  // the residual, then r in its place: the stage that slice KT would take
  bf16* Rs = ring + (C::KT % STAGES) * C::STAGE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.x * FW_BM;
  const int live = live_rows(m0, s_pad, valid_len);
  if (live == 0) {  // both 32-row tiles are padding: uniform, before any barrier
#pragma unroll
    for (int q = 0; q < C::CHUNKS; ++q) {
      const size_t o = (size_t)m0 * N + (tid + q * TC_THREADS) * 8;
      *reinterpret_cast<uint4*>(out + o) = make_uint4(0, 0, 0, 0);
      if (r_out != nullptr) *reinterpret_cast<uint4*>(r_out + o) = make_uint4(0, 0, 0, 0);
    }
    if (mean_out != nullptr && tid < FW_BM) {
      mean_out[m0 + tid] = 0.f;
      rstd_out[m0 + tid] = 0.f;
    }
    return;
  }

  auto load = [&](int i) {  // K slice i: a's rows of the block, W's 192 rows
    bf16* as = ring + (i % STAGES) * C::STAGE;
    bf16* bs = as + C::A_STAGE;
#pragma unroll
    for (int q = 0; q < C::A_STAGE / 8 / TC_THREADS; ++q) {
      const int c = tid + q * TC_THREADS, r = c / (FW_BK / 8), cc = c % (FW_BK / 8);
      cp_async_16(as + swz<FW_BK>(r, cc * 8), a + (size_t)(m0 + r) * K + i * FW_BK + cc * 8);
    }
#pragma unroll
    for (int q = 0; q < N * FW_BK / 8 / TC_THREADS; ++q) {
      const int c = tid + q * TC_THREADS, r = c / (FW_BK / 8), cc = c % (FW_BK / 8);
      cp_async_16(bs + swz<FW_BK>(r, cc * 8), w + (size_t)r * K + i * FW_BK + cc * 8);
    }
  };
  auto load_residual = [&]() {
#pragma unroll
    for (int q = 0; q < C::CHUNKS; ++q) {
      const int c = tid + q * TC_THREADS, r = c / (N / 8), cc = c % (N / 8);
      cp_async_16(Rs + swz<N>(r, cc * 8), res + (size_t)(m0 + r) * N + cc * 8);
    }
  };
  // the ring's prologue; a K of one slice (the out projection at D 64) takes
  // the residual here, into the stage slice KT would take
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < C::KT) load(s);
    else if (s == C::KT) load_residual();
    cp_async_commit();
  }

  float acc[2][C::NT8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  for (int i = 0; i < C::KT; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice i is in; every warp is done with slice i - 1
    if (i + STAGES - 1 < C::KT) load(i + STAGES - 1);
    else if (i + STAGES - 1 == C::KT) load_residual();  // into the stage slice KT would take
    cp_async_commit();
    const bf16* as = ring + (i % STAGES) * C::STAGE;
    const bf16* bs = as + C::A_STAGE;
    // k16 steps one at a time: the fragments of four steps of a 32 x 48 warp
    // tile do not fit the 128 registers of two blocks an SM
#pragma unroll 1
    for (int kk = 0; kk < FW_BK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) ldsm_a<FW_BK>(af[mt], as, wm * 32 + mt * 16, kk);
#pragma unroll
      for (int np = 0; np < C::NT8 / 2; ++np) {
        uint32_t bf[4];
        ldsm_b<FW_BK>(bf, bs, kk, wn * C::WN + np * 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the residual is in

  // ---- r = res + bf16(bf16(sums) + bias), rounded, in place of the residual ----
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < C::NT8; ++nt) {
    const int col = wn * C::WN + nt * 8 + 2 * t;
    const float2 bb =
        unpack_bf16x2(__ldg(reinterpret_cast<const unsigned int*>(bias + col)));
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t* p = reinterpret_cast<uint32_t*>(Rs + swz<N>(wm * 32 + mt * 16 + g + 8 * h, col));
        const float2 rv = unpack_bf16x2(*p);
        *p = pack_bf16x2(rv.x + rnd<bf16>(rnd<bf16>(acc[mt][nt][2 * h]) + bb.x),
                         rv.y + rnd<bf16>(rnd<bf16>(acc[mt][nt][2 * h + 1]) + bb.y));
      }
  }
  __syncthreads();

  // ---- the LayerNorm: one warp a row; lanes 0..23 own 8 columns each ----------
  constexpr int LANES = N / 8;
  const int c8 = lane * 8;
  float ga[8], ba[8];
  if (lane < LANES) {
    *reinterpret_cast<float4*>(ga) = __ldg(reinterpret_cast<const float4*>(gamma + c8));
    *reinterpret_cast<float4*>(ga + 4) = __ldg(reinterpret_cast<const float4*>(gamma + c8 + 4));
    *reinterpret_cast<float4*>(ba) = __ldg(reinterpret_cast<const float4*>(beta + c8));
    *reinterpret_cast<float4*>(ba + 4) = __ldg(reinterpret_cast<const float4*>(beta + c8 + 4));
  }
  for (int row = warp; row < FW_BM; row += TC_THREADS / 32) {
    const size_t o = (size_t)(m0 + row) * N + c8;
    if (row >= live) {  // a zero-filled 32-row tile: uniform across the warp
      if (lane < LANES) {
        *reinterpret_cast<uint4*>(out + o) = make_uint4(0, 0, 0, 0);
        if (r_out != nullptr) *reinterpret_cast<uint4*>(r_out + o) = make_uint4(0, 0, 0, 0);
      }
      if (mean_out != nullptr && lane == 0) {
        mean_out[m0 + row] = 0.f;
        rstd_out[m0 + row] = 0.f;
      }
      continue;
    }
    uint4 u = make_uint4(0, 0, 0, 0);
    float v[8];
    float s = 0.f, ss = 0.f;
    if (lane < LANES) u = *reinterpret_cast<const uint4*>(Rs + swz<N>(row, c8));
    const uint32_t* uw = reinterpret_cast<const uint32_t*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = unpack_bf16x2(uw[e]);
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
      s += f.x + f.y;
      ss += f.x * f.x + f.y * f.y;
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = s / N;
    const float rstd = rsqrtf(fmaxf(ss / N - mu * mu, 0.f) + eps);
    if (lane < LANES) {
      uint4 y;
      uint32_t* yw = reinterpret_cast<uint32_t*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        yw[e] = pack_bf16x2((v[2 * e] - mu) * rstd * ga[2 * e] + ba[2 * e],
                            (v[2 * e + 1] - mu) * rstd * ga[2 * e + 1] + ba[2 * e + 1]);
      *reinterpret_cast<uint4*>(out + o) = y;
      if (r_out != nullptr) *reinterpret_cast<uint4*>(r_out + o) = u;
    }
    if (mean_out != nullptr && lane == 0) {
      mean_out[m0 + row] = mu;
      rstd_out[m0 + row] = rstd;
    }
  }
}

bool rows_ok_bf16(int M, int s_pad) {
  return M > 0 && s_pad > 0 && s_pad % FW_BM == 0 && M % s_pad == 0;
}

}  // namespace

extern "C" {

// x (M, D), w (3 D, D), bias (3 D,), out (M, 3 D), bf16, D 192 or 64; g and
// beta (D,) f32. mean_out and rstd_out (M,) f32 get the LN1 row stats when
// not null (both or neither); zeros on the zero-filled tiles. s_pad a
// multiple of 64, the block's rows. The float32 instance is fused_block.cu's;
// at D 768 the bf16 one is linear_wgmma_bf16.cu's ln_linear_fwd_wgmma_bf16.
int ln_linear_fwd_bf16(const bf16* x, const float* g, const float* beta, float eps,
                       const bf16* w, const bf16* bias, bf16* out, float* mean_out,
                       float* rstd_out, const int* valid_len, int M, int K, int N,
                       int s_pad, void* stream) {
  if (!rows_ok_bf16(M, s_pad) || (K != D_MODEL && K != D_SMALL) || N != 3 * K ||
      (mean_out == nullptr) != (rstd_out == nullptr))
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto kernel, int smem) {
    int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != 0) return e;
    kernel<<<dim3(M / FW_BM, 3), TC_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        x, g, beta, eps, w, bias, out, mean_out, rstd_out, valid_len, s_pad);
    return (int)cudaGetLastError();
  };
  if (K == D_SMALL) return run(ln_linear_bf16_kernel<D_SMALL>, LnLinear<D_SMALL>::SMEM);
  return run(ln_linear_bf16_kernel<D_MODEL>, LnLinear<D_MODEL>::SMEM);
}

// x (M, D), w (2048, D), bias (2048,), out (M, 2048), all bf16, D 192 or 64;
// s_pad a multiple of 64, the block's rows. The float32 instance is
// fused_block.cu's; at D 768 the bf16 one is linear_wgmma_bf16.cu's
// linear_relu_fwd_wgmma_bf16.
int linear_relu_fwd_bf16(const bf16* x, const bf16* w, const bf16* bias, bf16* out,
                         const int* valid_len, int M, int K, int N, int s_pad, void* stream) {
  if (!rows_ok_bf16(M, s_pad) || (K != D_MODEL && K != D_SMALL) || N != D_FFN)
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto kernel, int smem) {
    int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != 0) return e;
    kernel<<<dim3(M / FW_BM, D_FFN / (RELU_SLICES * RELU_BN)), TC_THREADS, smem,
             static_cast<cudaStream_t>(stream)>>>(x, w, bias, out, valid_len, s_pad);
    return (int)cudaGetLastError();
  };
  if (K == D_SMALL) return run(linear_relu_bf16_kernel<D_SMALL>, Relu<D_SMALL>::SMEM);
  return run(linear_relu_bf16_kernel<D_MODEL>, Relu<D_MODEL>::SMEM);
}

// a (M, K) with K = N (out projection) or 2048 (FFN2), w (N, K), bias (N,),
// res and out (M, N), bf16, N = D 192 or 64; g and beta (N,) f32. When not
// null: mean_out and rstd_out (M,) f32 get the LN row stats (both or
// neither), r_out (M, N) bf16 the pre-LN sum; zeros on the zero-filled tiles.
// s_pad a multiple of 64. At D 768 the bf16 one is linear_wgmma_bf16.cu's
// linear_residual_ln_fwd_wgmma_bf16.
int linear_residual_ln_fwd_bf16(const bf16* a, const bf16* w, const bf16* bias,
                                const bf16* res, const float* g, const float* beta,
                                float eps, bf16* out, float* mean_out, float* rstd_out,
                                bf16* r_out, const int* valid_len, int M, int K, int N,
                                int s_pad, void* stream) {
  if (!rows_ok_bf16(M, s_pad) || (N != D_MODEL && N != D_SMALL) || (K != N && K != D_FFN) ||
      (mean_out == nullptr) != (rstd_out == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto kernel, int smem) {
    int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != 0) return e;
    kernel<<<dim3(M / FW_BM), TC_THREADS, smem, st>>>(a, w, bias, res, g, beta, eps, out,
                                                      mean_out, rstd_out, r_out, valid_len,
                                                      s_pad);
    return (int)cudaGetLastError();
  };
  if (N == D_SMALL) {  // whole rows of 64 columns a block
    if (K == D_SMALL)
      return run(linear_residual_ln_bf16_kernel<D_SMALL, D_SMALL>, ResLn<D_SMALL, D_SMALL>::SMEM);
    return run(linear_residual_ln_bf16_kernel<D_FFN, D_SMALL>, ResLn<D_FFN, D_SMALL>::SMEM);
  }
  if (K == D_MODEL)
    return run(linear_residual_ln_bf16_kernel<D_MODEL, LN_N>, ResLn<D_MODEL>::SMEM);
  return run(linear_residual_ln_bf16_kernel<D_FFN, LN_N>, ResLn<D_FFN>::SMEM);
}

}  // extern "C"
