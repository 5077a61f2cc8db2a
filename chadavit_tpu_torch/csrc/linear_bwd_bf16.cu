// The bf16 data- and weight-gradient GEMMs of one ChAdaViT encoder layer's
// backward, on Hopper's tensor cores: linear_dgrad_bf16 (dX = dY W, with the
// ReLU-mask or residual epilogue) and linear_wgrad_bf16 (dW = dY^T X',
// db = colsum dY). Their float32 instances stay the CUDA-core kernels of
// fused_block_bwd.cu; the function, the sites and the contract are theirs.
//
// Replaces, with fused_block_bwd.cu, the TPU kernel
// chadavit_tpu/ops/fused_block.py::_bwd_kernel (:211), whose bf16 dots run on
// the MXU with f32 accumulation.
//
// What bounds them on an H100: at the layer's widths (192 on one side of
// every product) they do about 90 operations a byte of device memory, a third
// of the 295 at which the bf16 tensor cores become the limit, so both are
// bound by bytes: dgrad by the (M, 2048) mask or residual it reads and the
// dX it writes, wgrad by its two inputs and its partial sums. The design
// keeps the tensor cores fed from shared memory and the copies in flight:
//
// - mma.sync m16n8k16 (bf16 in, f32 sums) from ldmatrix fragments of
//   swizzled shared-memory tiles (mma_bf16.cuh); products of bf16 are exact
//   in f32, so only the order of the f32 sums differs from the plain version.
// - cp.async 16-byte copies into a ring of three stages: the next K slice
//   (dgrad) or the next 32-row tile (wgrad) loads while the current one is
//   multiplied.
// - dgrad: a block owns 64 rows (two 32-row tiles of the contract). The FFN
//   site (K 192 -> N 2048) keeps the block's dY rows in shared memory and
//   walks 512 of the 2048 columns in slices of 128, so dY is staged once per
//   block and each slice's mask loads (16 bytes a thread, coalesced) are in
//   flight while the slice is multiplied. The N 192 sites own all 192
//   columns and loop over K; W slices come from L2. The epilogue applies the
//   mask or residual to the f32 sums, rounds once to bf16, and stores 16-byte
//   rows through a shared-memory tile; 32-row tiles wholly past valid_len
//   are written as zeros, also inside a computed 64-row block.
// - wgrad: the grid is output tiles x splits, and a split takes a fixed,
//   contiguous share of the list of computed 32-row tiles (those that hold a
//   valid row), which every block builds from valid_len. The partial sums are
//   (splits, N * K + N), a size set by the grid and not by the batch, and a
//   second pass adds them in a fixed order: no atomics, the same bits on
//   every run. The QKV site applies LN1 with the saved f32 stats to each
//   staged X tile in shared memory and rounds it to bf16 before the tensor
//   cores read it: the forward's h, exactly. db = dY^T 1 is one more
//   tensor-core product (a B fragment of ones) in the blocks of the first K
//   tile.
//
// Both take the four sites of D 192 (ChAdaViT-moyen) and of D 64 (the smoke
// configs, bound by bytes all the more: every product has 64 on one side;
// dgrad takes the same templates at BN 64, wgrad tiles of 64 along its
// 64-wide side). At D 768 (ChAdaViT-B/16)
// every product has 768 or more on both sides, 380 to 580 operations a byte,
// over the 295 at which the bf16 tensor cores become the limit: there dgrad
// and wgrad are linear_wgmma_bf16.cu's linear_dgrad_wgmma_bf16 and
// linear_wgrad_wgmma_bf16 (wgmma and TMA).
//
// Plain C interface (loaded with ctypes); each launcher returns
// cudaGetLastError() so that the Python wrapper can raise on a refused launch.

#include "gemm_common.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int TC_THREADS = 256;  // 8 warps
constexpr int STAGES = 3;        // the cp.async ring
constexpr int ROW_TILE = BM;     // the contract's 32-row tile

// ---- linear_dgrad_bf16 ------------------------------------------------------
// Grid (M / DG_BM, N / (NTILES * BN)). A block owns DG_BM rows and NTILES
// slices of BN columns, walked in order; K is staged DG_BK at a time. Warps
// 2 (rows) x 4 (columns), each a 32 x BN / 4 tile of the slice.
constexpr int DG_BM = 64;
constexpr int DG_BK = 64;

template <int BN, int K, int NTILES, int EPI, bool A_RES>
struct Dgrad {
  static constexpr int WN = BN / 4;       // a warp's columns
  static constexpr int NT8 = WN / 8;      // its n8 blocks
  static constexpr int KT = K / DG_BK;    // K slices of a column slice
  static constexpr int ITERS = NTILES * KT;
  static constexpr int A_STAGE = DG_BM * DG_BK;
  static constexpr int B_STAGE = DG_BK * BN;
  // A_RES: the block's whole (DG_BM, K) dY rows, staged once
  static constexpr int A_ELEMS = A_RES ? DG_BM * K : STAGES * A_STAGE;
  static constexpr int RING = A_ELEMS + STAGES * B_STAGE;
  // the epilogue's (DG_BM, BN) tile; it reuses the ring when the block has
  // one column slice, since the ring is idle by then
  static constexpr int E_ELEMS = DG_BM * BN;
  static constexpr bool E_ALIAS = NTILES == 1;
  static constexpr int SMEM = 2 * (RING + (E_ALIAS ? 0 : E_ELEMS));
  static constexpr int CHUNKS = DG_BM * BN / 8 / TC_THREADS;  // 16 B of a slice a thread
  // k16 steps of a slice unrolled: all four for the 32 x 32 warp tile; one at
  // a time for 32 x 48, whose fragments of four steps would not fit in the
  // 128 registers of two blocks an SM (ptxas spilled)
  static constexpr int KK_UNROLL = NT8 > 4 ? 1 : DG_BK / 16;
  // the epilogue's mask or residual: loaded at the first K slice of a short
  // loop, in flight while the slices are multiplied; loaded by the epilogue
  // itself after a long one, whose loop has no registers to hold it
  static constexpr bool AUX_EARLY = KT <= 3;
  static_assert(K % DG_BK == 0 && NT8 % 2 == 0 && CHUNKS * 8 * TC_THREADS == DG_BM * BN,
                "dgrad tile shape");
  static_assert(!E_ALIAS || E_ELEMS <= RING, "the epilogue tile fits in the ring");
};

template <int BN, int K, int NTILES, int EPI, bool A_RES>
__global__ void __launch_bounds__(TC_THREADS, 2)
linear_dgrad_bf16_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ w,
                         const bf16* __restrict__ aux, bf16* __restrict__ out,
                         const int* __restrict__ valid_len, int N, int s_pad) {
  using C = Dgrad<BN, K, NTILES, EPI, A_RES>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Bs = As + C::A_ELEMS;
  bf16* Es = C::E_ALIAS ? As : Bs + STAGES * C::B_STAGE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.x * DG_BM;
  const int ncol0 = blockIdx.y * NTILES * BN;
  const int b = m0 / s_pad, local = m0 - b * s_pad;
  const int vl = valid_len[b];
  if (local >= vl) {  // both 32-row tiles are padding: uniform, before any barrier
    constexpr int ROW_CHUNKS = NTILES * BN / 8;
    for (int c = tid; c < DG_BM * ROW_CHUNKS; c += TC_THREADS)
      *reinterpret_cast<uint4*>(out + (size_t)(m0 + c / ROW_CHUNKS) * N + ncol0 +
                                (c % ROW_CHUNKS) * 8) = make_uint4(0, 0, 0, 0);
    return;
  }
  // rows of the block in 32-row tiles that hold a valid row; the rest are zero
  const int live = min(DG_BM, (vl - local + ROW_TILE - 1) / ROW_TILE * ROW_TILE);

  auto load = [&](int it) {  // K slice it % KT of column slice it / KT
    const int j = it / C::KT, i = it % C::KT;
    bf16* bs = Bs + (it % STAGES) * C::B_STAGE;
    const bf16* wsrc = w + (size_t)(i * DG_BK) * N + ncol0 + j * BN;
#pragma unroll
    for (int q = 0; q < DG_BK * BN / 8 / TC_THREADS; ++q) {
      const int c = tid + q * TC_THREADS, r = c / (BN / 8), cc = c % (BN / 8);
      cp_async_16(bs + swz<BN>(r, cc * 8), wsrc + (size_t)r * N + cc * 8);
    }
    if constexpr (!A_RES) {
      bf16* as = As + (it % STAGES) * C::A_STAGE;
      const bf16* asrc = dy + (size_t)m0 * K + i * DG_BK;
#pragma unroll
      for (int q = 0; q < DG_BM * DG_BK / 8 / TC_THREADS; ++q) {
        const int c = tid + q * TC_THREADS, r = c / (DG_BK / 8), cc = c % (DG_BK / 8);
        cp_async_16(as + swz<DG_BK>(r, cc * 8), asrc + (size_t)r * K + cc * 8);
      }
    }
  };

  if constexpr (A_RES) {  // in the first group, with slice 0
#pragma unroll
    for (int q = 0; q < DG_BM * K / 8 / TC_THREADS; ++q) {
      const int c = tid + q * TC_THREADS, r = c / (K / 8), cc = c % (K / 8);
      cp_async_16(As + swz<K>(r, cc * 8), dy + (size_t)(m0 + r) * K + cc * 8);
    }
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < C::ITERS) load(s);
    cp_async_commit();
  }

  float acc[2][C::NT8][4];
  uint4 auxr[EPI != EPI_NONE ? C::CHUNKS : 1];
  auto load_aux = [&](int n0) {  // column slice n0's mask or residual, 16 bytes a thread
#pragma unroll
    for (int q = 0; q < C::CHUNKS; ++q) {
      const int c = tid + q * TC_THREADS, r = c / (BN / 8), cc = c % (BN / 8);
      auxr[q] = __ldg(reinterpret_cast<const uint4*>(aux + (size_t)(m0 + r) * N + n0 + cc * 8));
    }
  };
  for (int it = 0; it < C::ITERS; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice it is in; every warp is done with slice it - 1
    if (it + STAGES - 1 < C::ITERS) load(it + STAGES - 1);
    cp_async_commit();
    const int j = it / C::KT, i = it % C::KT;
    const int n0 = ncol0 + j * BN;
    if (i == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < C::NT8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
    if constexpr (EPI != EPI_NONE && C::AUX_EARLY)
      if (i == 0) load_aux(n0);
    const bf16* as = A_RES ? As : As + (it % STAGES) * C::A_STAGE;
    const bf16* bs = Bs + (it % STAGES) * C::B_STAGE;
    constexpr int LDA = A_RES ? K : DG_BK;
    const int ak = A_RES ? i * DG_BK : 0;
    constexpr int kk_unroll = C::KK_UNROLL;
#pragma unroll kk_unroll
    for (int kk = 0; kk < DG_BK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) ldsm_a<LDA>(af[mt], as, wm * 32 + mt * 16, ak + kk);
#pragma unroll
      for (int np = 0; np < C::NT8 / 2; ++np) {
        uint32_t bf[4];
        ldsm_b_t<BN>(bf, bs, kk, wn * C::WN + np * 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
    if (i != C::KT - 1) continue;

    // ---- epilogue of column slice j: f32 sums -> mask / residual -> bf16 ----
    __syncthreads();  // every warp is done with the ring (Es may alias it)
    if constexpr (EPI != EPI_NONE) {
      if constexpr (!C::AUX_EARLY) load_aux(n0);
#pragma unroll
      for (int q = 0; q < C::CHUNKS; ++q) {
        const int c = tid + q * TC_THREADS, r = c / (BN / 8), cc = c % (BN / 8);
        *reinterpret_cast<uint4*>(Es + swz<BN>(r, cc * 8)) = auxr[q];
      }
      __syncthreads();
    }
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < C::NT8; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + mt * 16 + g + 8 * h;
          uint32_t* p = reinterpret_cast<uint32_t*>(Es + swz<BN>(r, wn * C::WN + nt * 8 + 2 * t));
          float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
          if constexpr (EPI == EPI_RELU_MASK) {
            const float2 a = unpack_bf16x2(*p);
            v0 = a.x > 0.f ? v0 : 0.f;
            v1 = a.y > 0.f ? v1 : 0.f;
          }
          if constexpr (EPI == EPI_RESIDUAL) {
            const float2 a = unpack_bf16x2(*p);
            v0 = a.x + v0;
            v1 = a.y + v1;
          }
          if (r >= live) v0 = v1 = 0.f;
          *p = pack_bf16x2(v0, v1);
        }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < C::CHUNKS; ++q) {
      const int c = tid + q * TC_THREADS, r = c / (BN / 8), cc = c % (BN / 8);
      *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * N + n0 + cc * 8) =
          *reinterpret_cast<const uint4*>(Es + swz<BN>(r, cc * 8));
    }
  }
  cp_async_wait<0>();
}

template <int BN, int K, int NTILES, int EPI, bool A_RES>
int dgrad_launch(const bf16* dy, const bf16* w, const bf16* aux, bf16* out,
                 const int* valid_len, int M, int N, int s_pad, cudaStream_t st) {
  using C = Dgrad<BN, K, NTILES, EPI, A_RES>;
  auto kernel = linear_dgrad_bf16_kernel<BN, K, NTILES, EPI, A_RES>;
  int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    C::SMEM);
  if (e != 0) return e;
  kernel<<<dim3(M / DG_BM, N / (NTILES * BN)), TC_THREADS, C::SMEM, st>>>(
      dy, w, aux, out, valid_len, N, s_pad);
  return (int)cudaGetLastError();
}

// ---- linear_wgrad_bf16 ------------------------------------------------------
// Grid (N / TN * K / TK, splits). A block owns a TN x TK tile of dW (warps
// WARPS_N x 8 / WARPS_N) and its split's share of the computed 32-row tiles,
// staged one tile of dY[:, n0:n0+TN] and X[:, k0:k0+TK] at a time.
constexpr int MAX_IMAGES = 1024;
// The ring holds six 32-row tiles: five in flight while one is multiplied
// (one block an SM, so these are the SM's loads in flight).
constexpr int WG_STAGES = 6;

template <int TN, int TK, int WARPS_N, bool LN_X>
__global__ void __launch_bounds__(TC_THREADS)
linear_wgrad_bf16_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ x,
                         const float* __restrict__ mean, const float* __restrict__ rstd,
                         const float* __restrict__ g, const float* __restrict__ beta,
                         float* __restrict__ partial, const int* __restrict__ valid_len,
                         int N, int K, int s_pad, int bsz, int splits) {
  constexpr int WARPS_K = 8 / WARPS_N;
  constexpr int WN = TN / WARPS_N, WK = TK / WARPS_K;
  constexpr int MT = WN / 16, NT8 = WK / 8;
  constexpr int Y_STAGE = ROW_TILE * TN, X_STAGE = ROW_TILE * TK;
  constexpr int STAT_STAGE = 2 * ROW_TILE;  // LN_X: the tile's mean, then rstd (f32)
  constexpr int Y_CHUNKS = Y_STAGE / 8 / TC_THREADS, X_CHUNKS = X_STAGE / 8 / TC_THREADS;
  static_assert(WN % 16 == 0 && NT8 % 2 == 0 && Y_CHUNKS * 8 * TC_THREADS == Y_STAGE &&
                    X_CHUNKS * 8 * TC_THREADS == X_STAGE,
                "wgrad tile shape");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ys = reinterpret_cast<bf16*>(smem_raw);
  bf16* Xs = Ys + WG_STAGES * Y_STAGE;
  float* Ss = reinterpret_cast<float*>(Xs + WG_STAGES * X_STAGE);
  __shared__ int first[MAX_IMAGES + 1];  // index of each image's first computed tile
  __shared__ __align__(16) float gb[LN_X ? 2 * TK : 4];  // LN_X: g, then beta
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp / WARPS_K, wk = warp % WARPS_K;
  const int ktiles = K / TK;
  const int n0 = (blockIdx.x / ktiles) * TN, k0 = (blockIdx.x % ktiles) * TK;
  const int split = blockIdx.y;
  if constexpr (LN_X)
    for (int c = tid; c < TK; c += TC_THREADS) {
      gb[c] = g[k0 + c];
      gb[TK + c] = beta[k0 + c];
    }

  // the list of computed tiles, image by image: warp 0 scans the counts
  if (warp == 0) {
    const int per = (bsz + 31) / 32, lo = min(bsz, lane * per), hi = min(bsz, lo + per);
    const int most = s_pad / ROW_TILE;
    auto count = [&](int i) { return min(most, (max(valid_len[i], 0) + ROW_TILE - 1) / ROW_TILE); };
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
    return (size_t)lo * s_pad + (size_t)(idx - first[lo]) * ROW_TILE;
  };
  auto load = [&](int s) {
    const size_t row0 = tile_row(begin + s);
    bf16* ys = Ys + (s % WG_STAGES) * Y_STAGE;
    bf16* xs = Xs + (s % WG_STAGES) * X_STAGE;
    if constexpr (LN_X) {  // 32 means, 32 rstds: 16 copies of 16 bytes
      if (tid < STAT_STAGE / 4)
        cp_async_16(Ss + (s % WG_STAGES) * STAT_STAGE + tid * 4,
                    (tid < ROW_TILE / 4 ? mean + row0 : rstd + row0 - ROW_TILE) + tid * 4);
    }
#pragma unroll
    for (int q = 0; q < Y_CHUNKS; ++q) {
      const int c = tid + q * TC_THREADS, r = c / (TN / 8), cc = c % (TN / 8);
      cp_async_16(ys + swz<TN>(r, cc * 8), dy + (row0 + r) * N + n0 + cc * 8);
    }
#pragma unroll
    for (int q = 0; q < X_CHUNKS; ++q) {
      const int c = tid + q * TC_THREADS, r = c / (TK / 8), cc = c % (TK / 8);
      cp_async_16(xs + swz<TK>(r, cc * 8), x + (row0 + r) * K + k0 + cc * 8);
    }
  };

#pragma unroll
  for (int s = 0; s < WG_STAGES - 1; ++s) {
    if (s < n_tiles) load(s);
    cp_async_commit();
  }
  float acc[MT][NT8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  // db = dY^T 1 on the tensor cores: the warps of the first K tile's blocks
  // that own the tile's first columns multiply their A fragments by ones too
  const bool col_sums = k0 == 0 && wk == 0;
  constexpr uint32_t ONES = 0x3f803f80u;  // two bf16 1.0
  float dbacc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dbacc[mt][e] = 0.f;

  for (int s = 0; s < n_tiles; ++s) {
    cp_async_wait<WG_STAGES - 2>();
    __syncthreads();  // tile s is in; every warp is done with tile s - 1
    if (s + WG_STAGES - 1 < n_tiles) load(s + WG_STAGES - 1);
    cp_async_commit();
    bf16* ys = Ys + (s % WG_STAGES) * Y_STAGE;
    bf16* xs = Xs + (s % WG_STAGES) * X_STAGE;
    if constexpr (LN_X) {  // h = LN1(x) rounded to bf16, in place
      const float* st = Ss + (s % WG_STAGES) * STAT_STAGE;
#pragma unroll
      for (int q = 0; q < X_CHUNKS; ++q) {
        const int c = tid + q * TC_THREADS, r = c / (TK / 8), cc = c % (TK / 8);
        const float mu = st[r], rs = st[ROW_TILE + r];
        uint4* p = reinterpret_cast<uint4*>(xs + swz<TK>(r, cc * 8));
        uint4 v = *p;
        uint32_t* u = reinterpret_cast<uint32_t*>(&v);
        float ga[8], ba[8];
        *reinterpret_cast<float4*>(ga) = *reinterpret_cast<const float4*>(gb + cc * 8);
        *reinterpret_cast<float4*>(ga + 4) = *reinterpret_cast<const float4*>(gb + cc * 8 + 4);
        *reinterpret_cast<float4*>(ba) = *reinterpret_cast<const float4*>(gb + TK + cc * 8);
        *reinterpret_cast<float4*>(ba + 4) =
            *reinterpret_cast<const float4*>(gb + TK + cc * 8 + 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = unpack_bf16x2(u[e]);
          u[e] = pack_bf16x2((f.x - mu) * rs * ga[2 * e] + ba[2 * e],
                             (f.y - mu) * rs * ga[2 * e + 1] + ba[2 * e + 1]);
        }
        *p = v;
      }
      __syncthreads();  // the normed tile
    }
#pragma unroll
    for (int kk = 0; kk < ROW_TILE; kk += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ldsm_a_t<TN>(af[mt], ys, wn * WN + mt * 16, kk);
#pragma unroll
      for (int np = 0; np < NT8 / 2; ++np) {
        uint32_t bf[4];
        ldsm_b_t<TK>(bf, xs, kk, wk * WK + np * 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
      if (col_sums)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(dbacc[mt], af[mt], ONES, ONES);
    }
  }
  cp_async_wait<0>();

  // this split's partial, written whole (zeros when it got no tiles)
  float* p = partial + (size_t)split * ((size_t)N * K + N);
  const int gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt) {
      const size_t n = n0 + wn * WN + mt * 16 + gq;
      const int k = k0 + wk * WK + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(p + n * K + k) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(p + (n + 8) * K + k) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  if (col_sums && t == 0)  // every column of the ones product holds the sum
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int n = n0 + wn * WN + mt * 16 + gq;
      p[(size_t)N * K + n] = dbacc[mt][0];
      p[(size_t)N * K + n + 8] = dbacc[mt][2];
    }
}

// out[i] = the splits' partials at i, added in split order; four outputs a thread
__global__ void __launch_bounds__(TC_THREADS)
reduce_splits_kernel(const float4* __restrict__ partial, float4* __restrict__ out,
                     int n_out4, int splits) {
  const int i = blockIdx.x * TC_THREADS + threadIdx.x;
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

template <int TN, int TK, int WARPS_N>
int wgrad_launch(const bf16* dy, const bf16* x, const float* mean, const float* rstd,
                 const float* g, const float* beta, float* partial, const int* valid_len,
                 int N, int K, int s_pad, int bsz, int splits, cudaStream_t st) {
  // the ring of dY and X tiles, and of the LN stats (allocated for both)
  constexpr int smem = WG_STAGES * (2 * ROW_TILE * (TN + TK) + 4 * 2 * ROW_TILE);
  const dim3 grid(N / TN * (K / TK), splits);
  auto launch = [&](auto kernel) {
    int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      smem);
    if (e != 0) return e;
    kernel<<<grid, TC_THREADS, smem, st>>>(dy, x, mean, rstd, g, beta, partial, valid_len, N,
                                           K, s_pad, bsz, splits);
    return (int)cudaGetLastError();
  };
  if (mean != nullptr) return launch(linear_wgrad_bf16_kernel<TN, TK, WARPS_N, true>);
  return launch(linear_wgrad_bf16_kernel<TN, TK, WARPS_N, false>);
}

}  // namespace

extern "C" {

// dy (M, K), w (K, N) (the forward's Linear weight, out x in), out (M, N),
// all bf16; epilogue and aux as linear_dgrad's (fused_block_bwd.cu). The
// four sites of a layer of width D 192 or 64 only: K D -> N 2048 (mask),
// K 2048 -> N D (residual), K D -> N D and K 3 D -> N D (none); s_pad a
// multiple of 64, the block's rows.
int linear_dgrad_bf16(const bf16* dy, const bf16* w, const bf16* aux, bf16* out, int epilogue,
                      const int* valid_len, int M, int K, int N, int s_pad, void* stream) {
  if (M <= 0 || s_pad <= 0 || s_pad % DG_BM || M % s_pad ||
      (epilogue != EPI_NONE) != (aux != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K == D_MODEL && N == D_FFN && epilogue == EPI_RELU_MASK)
    return dgrad_launch<128, D_MODEL, 4, EPI_RELU_MASK, true>(dy, w, aux, out, valid_len, M, N,
                                                              s_pad, st);
  if (K == D_FFN && N == D_MODEL && epilogue == EPI_RESIDUAL)
    return dgrad_launch<D_MODEL, D_FFN, 1, EPI_RESIDUAL, false>(dy, w, aux, out, valid_len, M,
                                                                N, s_pad, st);
  if (K == D_MODEL && N == D_MODEL && epilogue == EPI_NONE)
    return dgrad_launch<D_MODEL, D_MODEL, 1, EPI_NONE, false>(dy, w, aux, out, valid_len, M, N,
                                                              s_pad, st);
  if (K == 3 * D_MODEL && N == D_MODEL && epilogue == EPI_NONE)
    return dgrad_launch<D_MODEL, 3 * D_MODEL, 1, EPI_NONE, false>(dy, w, aux, out, valid_len, M,
                                                                  N, s_pad, st);
  // D 64: the same templates at BN 64
  if (K == D_SMALL && N == D_FFN && epilogue == EPI_RELU_MASK)
    return dgrad_launch<128, D_SMALL, 4, EPI_RELU_MASK, true>(dy, w, aux, out, valid_len, M, N,
                                                              s_pad, st);
  if (K == D_FFN && N == D_SMALL && epilogue == EPI_RESIDUAL)
    return dgrad_launch<D_SMALL, D_FFN, 1, EPI_RESIDUAL, false>(dy, w, aux, out, valid_len, M,
                                                                N, s_pad, st);
  if (K == D_SMALL && N == D_SMALL && epilogue == EPI_NONE)
    return dgrad_launch<D_SMALL, D_SMALL, 1, EPI_NONE, false>(dy, w, aux, out, valid_len, M, N,
                                                              s_pad, st);
  if (K == 3 * D_SMALL && N == D_SMALL && epilogue == EPI_NONE)
    return dgrad_launch<D_SMALL, 3 * D_SMALL, 1, EPI_NONE, false>(dy, w, aux, out, valid_len, M,
                                                                  N, s_pad, st);
  return (int)cudaErrorInvalidValue;
}

// dy (M, N), x (M, K) bf16 at the four weight shapes (N, K) of a layer of
// width D 192 or 64; dwb: (N * K + N,) f32 = dW (N, K) row-major, then db
// (N,). With mean (not null; K = D only), x is layer-normed with mean, rstd, g, beta
// (f32) and rounded to bf16 as it is staged. partial: (splits, N * K + N) f32
// scratch, 1 <= splits <= 1024; the tile shapes and so the grid are those of
// ops/fused_block.py::WGRAD_BF16_TILES.
int linear_wgrad_bf16(const bf16* dy, const bf16* x, const float* mean, const float* rstd,
                      const float* g, const float* beta, float* partial, float* dwb,
                      const int* valid_len, int M, int N, int K, int s_pad, int splits,
                      void* stream) {
  if (M <= 0 || s_pad <= 0 || s_pad % ROW_TILE || M % s_pad || M / s_pad > MAX_IMAGES ||
      splits < 1 || splits > 1024 ||
      !(is_weight_shape_at(N, K, D_MODEL) || is_weight_shape_at(N, K, D_SMALL)) ||
      (mean != nullptr && K != D_MODEL && K != D_SMALL))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bsz = M / s_pad;
  int e;
  if (is_weight_shape_at(N, K, D_SMALL)) {  // D 64: tiles of 64 along the 64-wide side
    if (N == D_FFN)
      e = wgrad_launch<128, D_SMALL, 4>(dy, x, mean, rstd, g, beta, partial, valid_len, N, K,
                                        s_pad, bsz, splits, st);
    else if (K == D_FFN)
      e = wgrad_launch<D_SMALL, 128, 2>(dy, x, mean, rstd, g, beta, partial, valid_len, N, K,
                                        s_pad, bsz, splits, st);
    else  // QKV (three tiles along N) and the out projection
      e = wgrad_launch<D_SMALL, D_SMALL, 4>(dy, x, mean, rstd, g, beta, partial, valid_len, N,
                                            K, s_pad, bsz, splits, st);
  } else if (N == D_FFN)
    e = wgrad_launch<128, D_MODEL, 2>(dy, x, mean, rstd, g, beta, partial, valid_len, N, K,
                                      s_pad, bsz, splits, st);
  else if (K == D_FFN)
    e = wgrad_launch<D_MODEL, 128, 4>(dy, x, mean, rstd, g, beta, partial, valid_len, N, K,
                                      s_pad, bsz, splits, st);
  else
    e = wgrad_launch<64, D_MODEL, 2>(dy, x, mean, rstd, g, beta, partial, valid_len, N, K,
                                     s_pad, bsz, splits, st);
  if (e != 0) return e;
  const int n_out4 = (N * K + N) / 4;
  reduce_splits_kernel<<<(n_out4 + TC_THREADS - 1) / TC_THREADS, TC_THREADS, 0, st>>>(
      reinterpret_cast<const float4*>(partial), reinterpret_cast<float4*>(dwb), n_out4, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
