// Prefix-masked multi-head attention in bf16 on Hopper's tensor cores: the
// forward prefix_attention_fwd_bf16 (K3) and the backward
// prefix_attention_bwd_bf16 (K4). Their float32 instances stay the CUDA-core
// kernels of prefix_attention.cu and prefix_attention_bwd.cu; the function,
// the lse layout and the contract are theirs:
//
// - key j of image b is valid iff j < valid_len[b]; queries are not masked;
// - a 64-query tile that holds a valid query is computed for real, all 64
//   rows of it, and the backward is exact for a cotangent on any of them,
//   each with its own lse;
// - a query tile wholly past the prefix writes zeros and lse = 1e30 and gets
//   dq = 0; a key tile wholly past it gets dk = dv = 0.
//
// Replaces the TPU kernels chadavit_tpu/ops/flash_attention.py::_fwd_kernel
// (:103) and ::_bwd_kernel (:157), and the attention steps inside
// chadavit_tpu/ops/fused_block.py::_fwd_kernel and ::_bwd_kernel, whose bf16
// dots run on the MXU with f32 sums.
//
// What bounds them on an H100: per (image, head) the forward does
// 4 vl^2 96 operations on 3 vl 96 bf16 inputs, about 1 300 operations a byte
// at vl 1961, and the backward 10 vl^2 96: both are bound by operations,
// well above the 295 a byte at which the bf16 tensor cores become the limit.
// The design therefore keeps the products on the tensor cores, FlashAttention-2
// style:
//
// - mma.sync m16n8k16 (bf16 in, f32 sums) from ldmatrix fragments of
//   swizzled shared-memory tiles (mma_bf16.cuh; a head row of 96 bf16 takes
//   the 12-chunk swizzle there, one of 64 the 8-chunk XOR of a whole
//   128-byte line). Products of bf16 are exact in f32.
// - A block has 4 warps and owns one 64-row tile of the contract; each warp
//   owns 16 of its rows, so the softmax of a row lives in the quad of lanes
//   that holds it (two __shfl_xor), with no score tile in shared memory and no
//   barrier for it. The m16n8 C layout of two adjacent n8 tiles is the A
//   layout of one k16 step, so p and ds go from the score accumulators to
//   the next product in registers.
// - The streamed tiles (K and V in the forward and in dq, the scaled q, dO,
//   lse and delta in dk/dv) come through a ring of cp.async 16-byte copies:
//   the next tiles load while the current one is multiplied.
// - Numerics round where the JAX kernels cast (flash_attention.py:118-138,
//   185-222): the scaled q (qscale arrives rounded to bf16), p before P V and
//   dV = P^T dO, ds before dK and dQ, and every output; scores, m, l, lse,
//   delta and every sum stay f32. The forward's l sums the unrounded p, and
//   its p is rounded against the running max (the JAX forward rounds against
//   the whole row's).
// - The backward is three launches: a prep pass writes delta = rowsum(dO o)
//   and the scaled q (once, into scratch), then dk/dv (a block per 64 keys,
//   walking the computed query tiles) and dq (a block per 64 queries,
//   walking the key tiles below valid_len). Every sum has one owner and a
//   fixed order, with no atomics: the same inputs give the same bits.
// - At head 64 (ChAdaViT-B/16) the forward and the backward's dk/dv and dq
//   are warpgroup kernels instead (attention_fwd_wgmma_kernel,
//   attention_dkdv_wgmma_kernel, attention_dq_wgmma_kernel, notes below): a
//   head row of 64 bf16 is one 128-byte line, the native TMA / wgmma swizzle
//   (wgmma_bf16.cuh), and a warpgroup-wide wgmma reads each B tile from
//   shared memory once for 64 rows where mma.sync's warps of 16 rows read it
//   four times: ldmatrix traffic held the mma.sync kernels.
//
// Every mma.sync kernel is a template on the head width HD, built for 96
// (ChAdaViT-moyen, D 192 in 2 heads: 6 k16 steps and 12 n8 blocks over a
// head), 64 (ChAdaViT-B/16, D 768 in 12 heads: 4 and 8; the prep pass only,
// the rest runs on the wgmma kernels) and 32 (the smoke
// configs, D 64 in 2 heads: 2 and 4; a head row is 4 chunks of 16 bytes,
// which take the swizzle of an odd multiple of 32 bf16, mma_bf16.cuh); every
// head is in one launch, with no counterpart of the JAX kernels' walk over
// groups of at most 384 lanes (a bound of their VMEM, not part of the
// function).
//
// Every decision to skip a tile is uniform across its block and taken before
// the first barrier. Plain C interface (loaded with ctypes); each launcher
// returns cudaGetLastError() so that the Python wrapper can raise on a
// refused launch.

#include <math.h>

#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int TILE = 64;      // the contract's query and key tile
constexpr int THREADS = 128;  // 4 warps of 16 rows
// the head widths HD the kernels are built for; the entry points refuse others
constexpr bool built_head_dim(int hd) { return hd == 32 || hd == 64 || hd == 96; }
template <int HD>
constexpr int KSTEPS = HD / 16;  // k16 steps over a head
template <int HD>
constexpr int HN8 = HD / 8;  // n8 blocks over a head
template <int HD>
constexpr int ROW_CHUNKS = HD / 8;  // 16-byte chunks of a head row
template <int HD>
constexpr int TILE_ELEMS = TILE * HD;
template <int HD>
constexpr int TILE_COPIES = TILE * ROW_CHUNKS<HD> / THREADS;  // 16-byte copies a thread
// the cp.async rings: two stages in the forward; three in the backward, whose
// longer loops per tile hide more of the copies (a third stage slowed the
// forward on the H100, and sped up the backward)
constexpr int FWD_STAGES = 2;
constexpr int BWD_STAGES = 3;
constexpr float INV_LOG2E = 0.6931471805599453f;
static_assert(TILE_COPIES<32> * THREADS == TILE * ROW_CHUNKS<32> &&
                  TILE_COPIES<64> * THREADS == TILE * ROW_CHUNKS<64> &&
                  TILE_COPIES<96> * THREADS == TILE * ROW_CHUNKS<96>,
              "tile copies");

// a (TILE, HD) block of rows of ld elements from src into a swizzled tile
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int ld) {
  constexpr int RC = ROW_CHUNKS<HD>;
#pragma unroll
  for (int i = 0; i < TILE_COPIES<HD>; ++i) {
    const int c = threadIdx.x + i * THREADS, r = c / RC, cc = c % RC;
    cp_async_16(dst + swz<HD>(r, cc * 8), src + (size_t)r * ld + cc * 8);
  }
}

// zeros into a (TILE, HD) block of rows of ld elements
template <int HD>
__device__ __forceinline__ void zero_tile(bf16* dst, int ld) {
  constexpr int RC = ROW_CHUNKS<HD>;
#pragma unroll
  for (int i = 0; i < TILE_COPIES<HD>; ++i) {
    const int c = threadIdx.x + i * THREADS;
    *reinterpret_cast<uint4*>(dst + (size_t)(c / RC) * ld + (c % RC) * 8) =
        make_uint4(0, 0, 0, 0);
  }
}

// A warp's 16 rows x HD columns in the m16n8 C layout (rows g and g + 8 of
// lane g * 4 + t), rows g times mul0 and rows g + 8 times mul1, rounded to
// bf16 and written to rows of ld elements from dst (the tile's first row) with
// 16-byte stores, through the warp's own 16 rows of the swizzled tile stage.
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HN8<HD>][4], float mul0,
                                           float mul1, bf16* stage, bf16* dst, int ld) {
  constexpr int RC = ROW_CHUNKS<HD>;
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < HN8<HD>; ++nt) {
    *reinterpret_cast<uint32_t*>(stage + swz<HD>(r0 + g, nt * 8 + 2 * t)) =
        pack_bf16x2(acc[nt][0] * mul0, acc[nt][1] * mul0);
    *reinterpret_cast<uint32_t*>(stage + swz<HD>(r0 + g + 8, nt * 8 + 2 * t)) =
        pack_bf16x2(acc[nt][2] * mul1, acc[nt][3] * mul1);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * RC / 32; ++i) {
    const int c = lane + 32 * i, r = r0 + c / RC, cc = c % RC;
    *reinterpret_cast<uint4*>(dst + (size_t)r * ld + cc * 8) =
        *reinterpret_cast<const uint4*>(stage + swz<HD>(r, cc * 8));
  }
}

// p as the A fragment of the k16 step over columns 16 kk.. of a score tile
// held as n8 blocks in the C layout
template <int N8>
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4], const float (&c)[N8][4], int kk) {
  a[0] = pack_bf16x2(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16x2(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16x2(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16x2(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

template <int N8>
__device__ __forceinline__ void zero(float (&c)[N8][4]) {
#pragma unroll
  for (int i = 0; i < N8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = 0.f;
}

// c (a warp's 16 rows x 8 N8 columns) += A B^T over the head: A the warp's 16
// rows of a (rows, HD) tile, B the rows col0.. of another (cols, HD) tile
template <int HD, int N8>
__device__ __forceinline__ void scores(float (&c)[N8][4], const bf16* a_tile, int row0,
                                       const bf16* b_tile, int col0) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS<HD>; ++kk) {
    uint32_t a[4];
    ldsm_a<HD>(a, a_tile, row0, kk * 16);
#pragma unroll
    for (int np = 0; np < N8 / 2; ++np) {
      uint32_t b[4];
      ldsm_b<HD>(b, b_tile, kk * 16, col0 + np * 16);
      mma_bf16(c[2 * np], a, b[0], b[1]);
      mma_bf16(c[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 rows x HD) += a B, a the A fragment of one k16 step and B the 16
// rows k0.. of a (k, HD) tile
template <int HD>
__device__ __forceinline__ void accumulate(float (&acc)[HN8<HD>][4], const uint32_t (&a)[4],
                                           const bf16* b_tile, int k0) {
#pragma unroll
  for (int np = 0; np < HN8<HD> / 2; ++np) {
    uint32_t b[4];
    ldsm_b_t<HD>(b, b_tile, k0, np * 16);
    mma_bf16(acc[2 * np], a, b[0], b[1]);
    mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
  }
}

// ---- K3: the forward ---------------------------------------------------------
// Grid (s_pad / TILE, heads, B). q, k, v: rows of ld elements, image b's rows
// from b * s_pad, head h at columns h * HD; out: rows of ldo elements; lse:
// (B, heads, s_pad) f32 or null. Shared memory: the scaled q tile (later the
// output's staging), then the ring of K and V tiles.
template <int HD>
constexpr int FWD_SMEM = (1 + 2 * FWD_STAGES) * TILE_ELEMS<HD> * 2;

template <int HD>
__global__ void __launch_bounds__(THREADS)
attention_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, int ld, const int* __restrict__ valid_len,
                          bf16* __restrict__ out, int ldo, float* __restrict__ lse, int s_pad,
                          float qscale) {
  constexpr int TE = TILE_ELEMS<HD>, RC = ROW_CHUNKS<HD>, KS = KSTEPS<HD>;
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int vl = min(max(valid_len[b], 0), s_pad);  // a bad length cannot read past the image
  const size_t row0 = (size_t)b * s_pad;
  bf16* o = out + (row0 + q0) * ldo + h * HD;
  float* lse_row = lse == nullptr ? nullptr : lse + ((size_t)b * gridDim.y + h) * s_pad + q0;
  const int tid = threadIdx.x;
  if (q0 >= vl) {  // uniform across the block, before any barrier
    zero_tile<HD>(o, ldo);
    if (lse_row != nullptr && tid < TILE) lse_row[tid] = 1e30f;
    return;
  }
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + TE;
  bf16* Vs = Ks + FWD_STAGES * TE;
  const bf16* kb = k + row0 * ld + h * HD;
  const bf16* vb = v + row0 * ld + h * HD;
  const int n_kt = (vl + TILE - 1) / TILE;
  auto load = [&](int kt) {
    load_tile<HD>(Ks + (kt % FWD_STAGES) * TE, kb + (size_t)kt * TILE * ld, ld);
    load_tile<HD>(Vs + (kt % FWD_STAGES) * TE, vb + (size_t)kt * TILE * ld, ld);
  };
#pragma unroll
  for (int s = 0; s < FWD_STAGES - 1; ++s) {
    if (s < n_kt) load(s);
    cp_async_commit();
  }
  // q times qscale, rounded to bf16, through registers into the swizzled
  // tile while the first K and V tiles are in flight
  const bf16* qb = q + (row0 + q0) * ld + h * HD;
#pragma unroll
  for (int i = 0; i < TILE_COPIES<HD>; ++i) {
    const int c = tid + i * THREADS, r = c / RC, cc = c % RC;
    uint4 u = __ldg(reinterpret_cast<const uint4*>(qb + (size_t)r * ld + cc * 8));
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = unpack_bf16x2(w[e]);
      w[e] = pack_bf16x2(f.x * qscale, f.y * qscale);
    }
    *reinterpret_cast<uint4*>(Qs + swz<HD>(r, cc * 8)) = u;
  }
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  uint32_t qa[KS][4];  // the warp's 16 rows of q, held for the whole loop
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) ldsm_a<HD>(qa[kk], Qs, warp * 16, kk * 16);

  float acc[HN8<HD>][4];
  zero(acc);
  // running max and the thread's share of the running sum, rows g and g + 8;
  // key 0 is valid, so the max is finite from the first tile on
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < n_kt; ++kt) {  // n_kt is uniform: barriers are safe
    cp_async_wait<FWD_STAGES - 2>();
    __syncthreads();  // tile kt is in; every warp is done with tile kt - 1
    if (kt + FWD_STAGES - 1 < n_kt) load(kt + FWD_STAGES - 1);
    cp_async_commit();
    const bf16* ks = Ks + (kt % FWD_STAGES) * TE;
    const bf16* vs = Vs + (kt % FWD_STAGES) * TE;

    float s[TILE / 8][4];  // the warp's 16 rows x 64 keys
    zero(s);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < TILE / 16; ++np) {
        uint32_t bfr[4];
        ldsm_b<HD>(bfr, ks, kk * 16, np * 16);
        mma_bf16(s[2 * np], qa[kk], bfr[0], bfr[1]);
        mma_bf16(s[2 * np + 1], qa[kk], bfr[2], bfr[3]);
      }
    if ((kt + 1) * TILE > vl)  // the ragged last tile
#pragma unroll
      for (int nt = 0; nt < TILE / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kt * TILE + nt * 8 + 2 * t + (e & 1) >= vl) s[nt][e] = -INFINITY;

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < TILE / 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int nt = 0; nt < TILE / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - m[e >> 1]);
        sum[e >> 1] += s[nt][e];  // l sums p unrounded; P V takes it in bf16
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
    for (int nt = 0; nt < HN8<HD>; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= alpha[e >> 1];
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      uint32_t pa[4];
      a_from_c(pa, s, kk);
      accumulate<HD>(acc, pa, vs, kk * 16);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // the quad's shares of the row sum
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  // the warp stages its own 16 rows of Qs, which only it has read
  store_rows<HD>(acc, 1.f / l[0], 1.f / l[1], Qs, o, ldo);
  if (lse_row != nullptr && t == 0) {
    lse_row[warp * 16 + g] = m[0] + log2f(l[0]);
    lse_row[warp * 16 + g + 8] = m[1] + log2f(l[1]);
  }
}

// ---- K4: the backward --------------------------------------------------------
// Prep: for every row of a computed query tile, delta[(b * heads + h) * s_pad
// + r] = rowsum over head h of dO o (0 on the other tiles) and qs = q qscale
// rounded to bf16, (B * s_pad, heads * HD). Sixteen lanes per (row, head),
// HD / 8 of them one 16-byte chunk each.
constexpr int PREP_THREADS = 256;

template <int HD>
__global__ void __launch_bounds__(PREP_THREADS)
attention_bwd_prep_kernel(const bf16* __restrict__ q, int ld, const bf16* __restrict__ o,
                          const bf16* __restrict__ dout, int ldo,
                          const int* __restrict__ valid_len, float* __restrict__ delta,
                          bf16* __restrict__ qs, int heads, int s_pad, int total,
                          float qscale) {
  const int item = (blockIdx.x * PREP_THREADS + threadIdx.x) / 16, c = threadIdx.x & 15;
  if (item >= total) return;  // whole half-warps leave; the shuffles stay in a half
  const unsigned half = 0xffffu << (threadIdx.x & 16);
  const int h = item % heads, row = item / heads, b = row / s_pad, r = row - b * s_pad;
  const bool live = r / TILE * TILE < valid_len[b];  // a query tile the forward computed
  float sum = 0.f;
  if (live && c < ROW_CHUNKS<HD>) {
    const size_t off = (size_t)row * ldo + h * HD + c * 8;
    const uint4 ov = __ldg(reinterpret_cast<const uint4*>(o + off));
    const uint4 dv = __ldg(reinterpret_cast<const uint4*>(dout + off));
    uint4 qv = __ldg(reinterpret_cast<const uint4*>(q + (size_t)row * ld + h * HD + c * 8));
    const uint32_t* ou = reinterpret_cast<const uint32_t*>(&ov);
    const uint32_t* du = reinterpret_cast<const uint32_t*>(&dv);
    uint32_t* qu = reinterpret_cast<uint32_t*>(&qv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = unpack_bf16x2(ou[e]), d = unpack_bf16x2(du[e]);
      sum += d.x * a.x + d.y * a.y;
      const float2 f = unpack_bf16x2(qu[e]);
      qu[e] = pack_bf16x2(f.x * qscale, f.y * qscale);
    }
    *reinterpret_cast<uint4*>(qs + (size_t)row * heads * HD + h * HD + c * 8) = qv;
  }
#pragma unroll
  for (int w = 8; w > 0; w >>= 1) sum += __shfl_xor_sync(half, sum, w);
  if (c == 0) delta[((size_t)b * heads + h) * s_pad + r] = sum;
}

// dK and dV of the TILE keys k0.. of head h of image b. Grid (s_pad / TILE,
// heads, B). Each warp owns 16 keys and walks the computed query tiles in
// halves of QSUB queries: S^T = K qs^T, P^T = exp2(S^T - lse), dV += P^T dO,
// dP^T = V dO^T, dS^T = P^T (dP^T - delta), dK += dS^T qs. K's and V's
// fragments are read from shared memory at each k-step, so that the two
// (16, HD) sums and a half's score tiles stay in registers.
constexpr int QSUB = 32;
constexpr int ROW_STATS = 2 * TILE;  // a query tile's lse, then its delta (f32)
template <int HD>
constexpr int DKDV_STAGE = 2 * TILE_ELEMS<HD> * 2 + ROW_STATS * 4;  // bytes: qs, dO, stats
template <int HD>
constexpr int DKDV_SMEM = 2 * TILE_ELEMS<HD> * 2 + BWD_STAGES * DKDV_STAGE<HD>;

template <int HD>
__global__ void __launch_bounds__(THREADS)
attention_dkdv_bf16_kernel(const bf16* __restrict__ qs, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, int ld, const bf16* __restrict__ dout,
                           int ldo, const float* __restrict__ lse,
                           const float* __restrict__ delta, const int* __restrict__ valid_len,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int ldg, int s_pad) {
  constexpr int TE = TILE_ELEMS<HD>, STAGE = DKDV_STAGE<HD>;
  const int k0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const int vl = min(max(valid_len[b], 0), s_pad);
  const size_t row0 = (size_t)b * s_pad;
  bf16* dkb = dk + (row0 + k0) * ldg + h * HD;
  bf16* dvb = dv + (row0 + k0) * ldg + h * HD;
  if (k0 >= vl) {  // uniform across the block, before any barrier
    zero_tile<HD>(dkb, ldg);
    zero_tile<HD>(dvb, ldg);
    return;
  }
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + TE;
  unsigned char* ring = smem_raw + 2 * TE * 2;
  const int tid = threadIdx.x, ldq = heads * HD;
  const float* lse_h = lse + ((size_t)b * heads + h) * s_pad;
  const float* delta_h = delta + ((size_t)b * heads + h) * s_pad;
  const int n_qt = (vl + TILE - 1) / TILE;  // every query tile the forward computed
  auto load = [&](int qt) {
    unsigned char* st = ring + (qt % BWD_STAGES) * STAGE;
    bf16* qt_s = reinterpret_cast<bf16*>(st);
    load_tile<HD>(qt_s, qs + (row0 + qt * TILE) * ldq + h * HD, ldq);
    load_tile<HD>(qt_s + TE, dout + (row0 + qt * TILE) * ldo + h * HD, ldo);
    if (tid < ROW_STATS / 4) {  // 16 copies of lse, 16 of delta
      float* stats = reinterpret_cast<float*>(qt_s + 2 * TE);
      const int half = tid / (TILE / 4), j = tid % (TILE / 4);
      cp_async_16(stats + half * TILE + j * 4, (half ? delta_h : lse_h) + qt * TILE + j * 4);
    }
  };
  // K and V in the first group, with query tile 0
  load_tile<HD>(Ks, k + (row0 + k0) * ld + h * HD, ld);
  load_tile<HD>(Vs, v + (row0 + k0) * ld + h * HD, ld);
#pragma unroll
  for (int s = 0; s < BWD_STAGES - 1; ++s) {
    if (s < n_qt) load(s);
    cp_async_commit();
  }
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  // keys past valid_len give p = 0, so their dk and dv are zeros
  const bool key_ok[2] = {k0 + warp * 16 + g < vl, k0 + warp * 16 + g + 8 < vl};
  float acc_k[HN8<HD>][4], acc_v[HN8<HD>][4];
  zero(acc_k);
  zero(acc_v);
  for (int qt = 0; qt < n_qt; ++qt) {  // n_qt is uniform: barriers are safe
    cp_async_wait<BWD_STAGES - 2>();
    __syncthreads();  // tile qt is in; every warp is done with tile qt - 1
    if (qt + BWD_STAGES - 1 < n_qt) load(qt + BWD_STAGES - 1);
    cp_async_commit();
    const unsigned char* st = ring + (qt % BWD_STAGES) * STAGE;
    const bf16* qs_s = reinterpret_cast<const bf16*>(st);
    const bf16* do_s = qs_s + TE;
    const float* lse_s = reinterpret_cast<const float*>(qs_s + 2 * TE);
    const float* delta_s = lse_s + TILE;
#pragma unroll 1
    for (int c0 = 0; c0 < TILE; c0 += QSUB) {  // queries c0 .. c0 + QSUB - 1
      float p[QSUB / 8][4], dp[QSUB / 8][4];
      zero(p);
      scores<HD>(p, Ks, warp * 16, qs_s, c0);
#pragma unroll
      for (int nt = 0; nt < QSUB / 8; ++nt) {
        const float2 ls = *reinterpret_cast<const float2*>(lse_s + c0 + nt * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[nt][e] = key_ok[e >> 1] ? exp2f(p[nt][e] - ((e & 1) ? ls.y : ls.x)) : 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < QSUB / 16; ++kk) {  // dV += rnd(P^T) dO
        uint32_t pa[4];
        a_from_c(pa, p, kk);
        accumulate<HD>(acc_v, pa, do_s, c0 + kk * 16);
      }
      zero(dp);
      scores<HD>(dp, Vs, warp * 16, do_s, c0);
#pragma unroll
      for (int nt = 0; nt < QSUB / 8; ++nt) {  // dS^T, kept in p
        const float2 dl = *reinterpret_cast<const float2*>(delta_s + c0 + nt * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) p[nt][e] *= dp[nt][e] - ((e & 1) ? dl.y : dl.x);
      }
#pragma unroll
      for (int kk = 0; kk < QSUB / 16; ++kk) {  // dK += rnd(dS^T) qs
        uint32_t da[4];
        a_from_c(da, p, kk);
        accumulate<HD>(acc_k, da, qs_s, c0 + kk * 16);
      }
    }
  }
  cp_async_wait<0>();
  // each warp stages its own 16 rows of Ks and Vs, which only it has read
  store_rows<HD>(acc_k, INV_LOG2E, INV_LOG2E, Ks, dkb, ldg);
  store_rows<HD>(acc_v, 1.f, 1.f, Vs, dvb, ldg);
}

// dQ of the TILE queries q0.. of head h of image b. Grid (s_pad / TILE,
// heads, B). Each warp owns 16 queries and walks the key tiles below
// valid_len: S = qs K^T, P = exp2(S - lse), dP = dO V^T, dS = P (dP - delta),
// dQ += dS K; dq = dQ scale at write-out.
template <int HD>
constexpr int DQ_SMEM = (2 + 2 * BWD_STAGES) * TILE_ELEMS<HD> * 2;

template <int HD>
__global__ void __launch_bounds__(THREADS)
attention_dq_bf16_kernel(const bf16* __restrict__ qs, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, int ld, const bf16* __restrict__ dout,
                         int ldo, const float* __restrict__ lse,
                         const float* __restrict__ delta, const int* __restrict__ valid_len,
                         bf16* __restrict__ dq, int ldg, int s_pad, float scale) {
  constexpr int TE = TILE_ELEMS<HD>;
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const int vl = min(max(valid_len[b], 0), s_pad);
  const size_t row0 = (size_t)b * s_pad;
  bf16* dqb = dq + (row0 + q0) * ldg + h * HD;
  if (q0 >= vl) {  // uniform across the block, before any barrier
    zero_tile<HD>(dqb, ldg);
    return;
  }
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + TE;
  bf16* Ks = dOs + TE;
  bf16* Vs = Ks + BWD_STAGES * TE;
  const int tid = threadIdx.x;
  const bf16* kb = k + row0 * ld + h * HD;
  const bf16* vb = v + row0 * ld + h * HD;
  const int n_kt = (vl + TILE - 1) / TILE;
  auto load = [&](int kt) {
    load_tile<HD>(Ks + (kt % BWD_STAGES) * TE, kb + (size_t)kt * TILE * ld, ld);
    load_tile<HD>(Vs + (kt % BWD_STAGES) * TE, vb + (size_t)kt * TILE * ld, ld);
  };
  // the block's qs and dO in the first group, with key tile 0
  load_tile<HD>(Qs, qs + (row0 + q0) * (heads * HD) + h * HD, heads * HD);
  load_tile<HD>(dOs, dout + (row0 + q0) * ldo + h * HD, ldo);
#pragma unroll
  for (int s = 0; s < BWD_STAGES - 1; ++s) {
    if (s < n_kt) load(s);
    cp_async_commit();
  }
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const size_t stat = ((size_t)b * heads + h) * s_pad + q0 + warp * 16 + g;
  const float lse_r[2] = {lse[stat], lse[stat + 8]};
  const float delta_r[2] = {delta[stat], delta[stat + 8]};
  float acc[HN8<HD>][4];
  zero(acc);
  for (int kt = 0; kt < n_kt; ++kt) {  // n_kt is uniform: barriers are safe
    cp_async_wait<BWD_STAGES - 2>();
    __syncthreads();  // tile kt is in; every warp is done with tile kt - 1
    if (kt + BWD_STAGES - 1 < n_kt) load(kt + BWD_STAGES - 1);
    cp_async_commit();
    const bf16* ks = Ks + (kt % BWD_STAGES) * TE;
    const bf16* vs = Vs + (kt % BWD_STAGES) * TE;
    float p[TILE / 8][4], dp[TILE / 8][4];
    zero(p);
    scores<HD>(p, Qs, warp * 16, ks, 0);
    zero(dp);
    scores<HD>(dp, dOs, warp * 16, vs, 0);
    const bool ragged = (kt + 1) * TILE > vl;
#pragma unroll
    for (int nt = 0; nt < TILE / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // dS, kept in p
        const float pe = ragged && kt * TILE + nt * 8 + 2 * t + (e & 1) >= vl
                             ? 0.f
                             : exp2f(p[nt][e] - lse_r[e >> 1]);
        p[nt][e] = pe * (dp[nt][e] - delta_r[e >> 1]);
      }
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {  // dQ += rnd(dS) K
      uint32_t da[4];
      a_from_c(da, p, kk);
      accumulate<HD>(acc, da, ks, kk * 16);
    }
  }
  cp_async_wait<0>();
  // the warp stages its own 16 rows of Qs, which only it has read
  store_rows<HD>(acc, scale, scale, Qs, dqb, ldg);
}

// ---- K4 at head 64: dk/dv and dq on wgmma, fed by TMA --------------------------
// What bounds it on an H100: operations (10 vl^2 64 a head and image on 5 vl
// 64 bf16 inputs), which only wgmma reaches. The design, for HD = 64 only:
// - a block owns 128 keys (dk/dv) or 128 queries (dq): two 64-row tiles of
//   the contract, one a consumer warpgroup, each tested against valid_len on
//   its own. One producer thread (a whole producer warpgroup, so that
//   setmaxnreg gives the consumers 232 registers a thread and it 40) loads
//   the block's resident tiles (K and V, or qs and dO) and streams each
//   tile of the walk (qs, dO and the tile's lse and delta for dk/dv; K and V
//   for dq) through a ring of STAGES mbarrier stages by TMA, the tiles in
//   the 128-byte swizzle (one 64 x 64 box each), lse and delta by bulk copy;
// - dk/dv, a consumer warpgroup's 64 keys against each computed query tile:
//   S^T = K qs^T and dP^T = V dO^T (SS m64n64k16, both K-major), P^T =
//   exp2(S^T - lse) (0 on keys past valid_len), dS^T = P^T (dP^T - delta);
//   then dV += bf16(P^T) dO and dK += bf16(dS^T) qs (RS: P^T and dS^T as A
//   straight from the accumulator registers, a_from_acc; dO and qs read
//   MN-major as the transposed B). dq, a consumer warpgroup's 64 queries
//   against each key tile below valid_len: S = qs K^T, dP = dO V^T (SS), P
//   (0 on the ragged tile's keys past valid_len), dS, dQ += bf16(dS) K (RS,
//   K MN-major);
// - dk/dv: a tile's score products are one commit group and its two RS
//   products another, each waited for before the next starts (with a
//   tile's RS products still running under the next tile's score products,
//   160 sums and operands a thread, ptxas serialized every wgmma for want
//   of registers, C7512); the two warpgroups take turns issuing their score
//   products (named barriers TURN, TURN + 1, warpgroup 0 first), so that
//   one's exp and dS overlap the other's products. dq (112 registers of
//   sums and operands): S and dP are two groups, the exp of P runs while
//   dP's products do, and a tile's score products run under the previous
//   tile's dQ product, whose wait frees the previous stage. Every wgmma is
//   outside any branch (a skipped tile is still walked and written as
//   zeros), so ptxas keeps them asynchronous;
// - the rounding points are the mma.sync kernels' (p and ds to bf16 before
//   their products, scores, lse, delta and every sum in f32), every sum has
//   one owner and a fixed order, and the outputs are staged through the
//   warpgroup's own resident tile for 16-byte stores.
namespace wk4 {

constexpr int HD = 64;
constexpr int CONSUMERS = 2;                      // consumer warpgroups, a 64-row tile each
constexpr int PRODUCER_WARP = 4 * CONSUMERS;
constexpr int WG_THREADS = 128 * (CONSUMERS + 1);    // and a producer warpgroup
constexpr int SPAN = TILE * CONSUMERS;            // a block's keys (dk/dv) or queries (dq)
constexpr int BOX = TILE * HD * 2;                // a 64 x 64 bf16 tile: 8 KB
constexpr int STAGES = 4;
constexpr int RELEASES = 4 * CONSUMERS;           // a consumer warp each frees a stage
constexpr int ACC = TILE * TILE / 128;            // a m64n64 sum: 32 floats a thread
constexpr int TURN = 1;                           // named barriers from TURN: the warpgroups' turns
// resident tiles, the ring's tiles, the ring's stats (lse, delta), alignment
constexpr int DKDV_WG_SMEM = 2 * CONSUMERS * BOX + STAGES * 2 * BOX + STAGES * 2 * TILE * 4 + 1024;
constexpr int DQ_WG_SMEM = 2 * CONSUMERS * BOX + STAGES * 2 * BOX + 1024;

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (wg::smem_u32(p) & 1023)) & 1023);
}

// zeros into the rows of the block's 64-row tiles that lie below s_pad, rows
// of ld elements from dst (the block's first row); all WG_THREADS threads
__device__ __forceinline__ void zero_tiles(bf16* dst, int ld, int tiles) {
  for (int c = threadIdx.x; c < tiles * TILE * 8; c += WG_THREADS)
    *reinterpret_cast<uint4*>(dst + (size_t)(c / 8) * ld + c % 8 * 8) = make_uint4(0, 0, 0, 0);
}

// a consumer warpgroup's 64 x 64 sums, the thread's rows 16 q + g times mul0
// and 16 q + g + 8 times mul1, rounded to bf16, written to rows of ld elements
// from dst through the warpgroup's own resident tile (stage: the 128-byte
// swizzle), or zeros where `dead`
__device__ __forceinline__ void store_tile(const float (&acc)[ACC], float mul0, float mul1,
                                           bf16* stage, bf16* dst, int ld, bool dead) {
  const int lane = threadIdx.x & 31, q = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
  unsigned char* st = reinterpret_cast<unsigned char*>(stage);
#pragma unroll
  for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * q + g + 8 * half;
      const float mul = half ? mul1 : mul0;
      *reinterpret_cast<uint32_t*>(st + r * 128 + ((j ^ (r & 7)) << 4) + 4 * t) =
          dead ? 0u : pack_bf16x2(acc[4 * j + 2 * half] * mul, acc[4 * j + 2 * half + 1] * mul);
    }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // the warp's 16 rows, 8 chunks each
    const int c = lane + 32 * i, r = 16 * q + c / 8, cc = c % 8;
    *reinterpret_cast<uint4*>(dst + (size_t)r * ld + cc * 8) =
        *reinterpret_cast<const uint4*>(st + r * 128 + ((cc ^ (r & 7)) << 4));
  }
}
__device__ __forceinline__ void store_tile(const float (&acc)[ACC], float mul, bf16* stage,
                                           bf16* dst, int ld, bool dead) {
  store_tile(acc, mul, mul, stage, dst, ld, dead);
}

}  // namespace wk4

// dK and dV of the keys k0 .. k0 + 127 of head h of image b. Grid (s_pad /
// 128 rounded up, heads, B). k_map, v_map: (B s_pad, heads HD) views of k and
// v (rows of ld); qs_map: of the prep pass's scaled q; do_map: of dout.
__global__ void __launch_bounds__(wk4::WG_THREADS, 1)
attention_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap qs_map,
                            const __grid_constant__ CUtensorMap do_map,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            const int* __restrict__ valid_len, bf16* __restrict__ dk,
                            bf16* __restrict__ dv, int ldg, int s_pad) {
  using namespace wk4;
  const int k0 = blockIdx.x * SPAN, h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const int vl = min(max(valid_len[b], 0), s_pad);
  const int row0 = b * s_pad;
  bf16* dkb = dk + ((size_t)row0 + k0) * ldg + h * HD;
  bf16* dvb = dv + ((size_t)row0 + k0) * ldg + h * HD;
  const int in_image = min(CONSUMERS, (s_pad - k0) / TILE);  // the tiles below s_pad
  if (k0 >= vl) {  // uniform across the block, before any barrier
    zero_tiles(dkb, ldg, in_image);
    zero_tiles(dvb, ldg, in_image);
    return;
  }
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], kv_full;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  unsigned char* Ks = base;                            // the consumers' K tiles
  unsigned char* Vs = Ks + CONSUMERS * BOX;            // and V tiles
  unsigned char* ring = Vs + CONSUMERS * BOX;          // a stage: qs, then dO
  float* stats = reinterpret_cast<float*>(ring + STAGES * 2 * BOX);  // a stage: lse, delta
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], RELEASES);
    }
    wg::mbar_init(&kv_full, 1);
    wg::mbar_fence_init();
  }
  __syncthreads();
  const int n_qt = (vl + TILE - 1) / TILE;  // every query tile the forward computed
  const size_t stat0 = ((size_t)b * heads + h) * s_pad;

  if (warp >= PRODUCER_WARP) {
    wg::setmaxnreg_dec<40>();
    if (warp == PRODUCER_WARP && lane == 0) {
      wg::tma_prefetch(&k_map);
      wg::tma_prefetch(&v_map);
      wg::tma_prefetch(&qs_map);
      wg::tma_prefetch(&do_map);
      wg::mbar_expect_tx(&kv_full, 2 * CONSUMERS * BOX);
      for (int c = 0; c < CONSUMERS; ++c) {  // a tile past the image: its rows are not stored
        wg::tma_load_2d(Ks + c * BOX, &k_map, &kv_full, h * HD, row0 + k0 + c * TILE);
        wg::tma_load_2d(Vs + c * BOX, &v_map, &kv_full, h * HD, row0 + k0 + c * TILE);
      }
      for (int qt = 0; qt < n_qt; ++qt) {
        const int s = qt % STAGES;
        wg::mbar_wait(&empty[s], ((qt / STAGES) & 1) ^ 1);
        unsigned char* st = ring + s * 2 * BOX;
        wg::mbar_expect_tx(&full[s], 2 * BOX + 2 * TILE * 4);
        wg::tma_load_2d(st, &qs_map, &full[s], h * HD, row0 + qt * TILE);
        wg::tma_load_2d(st + BOX, &do_map, &full[s], h * HD, row0 + qt * TILE);
        wg::bulk_load(stats + s * 2 * TILE, lse + stat0 + qt * TILE, TILE * 4, &full[s]);
        wg::bulk_load(stats + s * 2 * TILE + TILE, delta + stat0 + qt * TILE, TILE * 4, &full[s]);
      }
    }
    return;
  }

  wg::setmaxnreg_inc<232>();
  const int wgi = warp / 4, q = warp % 4, g = lane >> 2, t = lane & 3;
  const int kt0 = k0 + wgi * TILE;  // the warpgroup's first key
  const unsigned char* ks = Ks + wgi * BOX;
  const unsigned char* vs = Vs + wgi * BOX;
  // keys past valid_len give p = 0, so their dk and dv are zeros
  const bool key_ok[2] = {kt0 + 16 * q + g < vl, kt0 + 16 * q + g + 8 < vl};
  float acc_k[ACC], acc_v[ACC], sc[ACC], dp[ACC];
  uint32_t pa[TILE / 16][4], da[TILE / 16][4];  // bf16(P^T), bf16(dS^T): the RS A operands
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc_k[i] = acc_v[i] = 0.f;
  wg::mbar_wait(&kv_full, 0);
  for (int qt = 0; qt < n_qt; ++qt) {  // n_qt is uniform: every wgmma outside a branch
    const int s = qt % STAGES;
    wg::mbar_wait(&full[s], (qt / STAGES) & 1);
    const unsigned char* qs_s = ring + s * 2 * BOX;
    const unsigned char* do_s = qs_s + BOX;
    wg::fence_operand(sc);
    wg::fence_operand(dp);
    // the warpgroups take turns issuing their score products, warpgroup 0
    // first, so that one's exp and dS overlap the other's products
    if (qt > 0 || wgi == 1) wg::bar_sync(TURN + wgi, 2 * 128);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)  // S^T = K qs^T
      wg::mma_m64n64k16<0, 0>(sc, wg::desc_k64(ks, kk), wg::desc_k64(qs_s, kk), kk != 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)  // dP^T = V dO^T
      wg::mma_m64n64k16<0, 0>(dp, wg::desc_k64(vs, kk), wg::desc_k64(do_s, kk), kk != 0);
    wg::commit();
    if (qt < n_qt - 1 || wgi == 0) wg::bar_arrive(TURN + 1 - wgi, 2 * 128);
    wg::wait<0>();
    wg::fence_operand(sc);
    wg::fence_operand(dp);
    const float* lse_s = stats + s * 2 * TILE;
    const float* delta_s = lse_s + TILE;
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {  // queries 8 j + 2 t, + 1
      const float2 ls = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
      const float2 dl = *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = key_ok[e >> 1] ? exp2f(sc[4 * j + e] - ((e & 1) ? ls.y : ls.x)) : 0.f;
        sc[4 * j + e] = p;                                              // P^T
        dp[4 * j + e] = p * (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x));  // dS^T
      }
    }
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      wg::a_from_acc(pa[kk], sc, kk);
      wg::a_from_acc(da[kk], dp, kk);
    }
    wg::fence_operand(pa);
    wg::fence_operand(da);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)  // dV += bf16(P^T) dO
      wg::mma_m64n64k16_rs<1>(acc_v, pa[kk], wg::desc_mn64(do_s, kk), 1);
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)  // dK += bf16(dS^T) qs
      wg::mma_m64n64k16_rs<1>(acc_k, da[kk], wg::desc_mn64(qs_s, kk), 1);
    wg::commit();
    // done before the next tile's score products: with both in flight (160
    // sums and operands a thread) ptxas serializes every wgmma (C7512)
    wg::wait<0>();
    wg::fence_operand(pa);
    wg::fence_operand(da);
    wg::fence_operand(acc_k);
    wg::fence_operand(acc_v);
    if (lane == 0) wg::mbar_arrive(&empty[s]);
  }
  if (kt0 >= s_pad) return;  // the second tile of a block that ends the image
  // each warpgroup stages its rows in its own K and V tiles, which only it read
  const bool dead = kt0 >= vl;
  store_tile(acc_k, INV_LOG2E, reinterpret_cast<bf16*>(Ks + wgi * BOX),
             dkb + (size_t)wgi * TILE * ldg, ldg, dead);
  store_tile(acc_v, 1.f, reinterpret_cast<bf16*>(Vs + wgi * BOX),
             dvb + (size_t)wgi * TILE * ldg, ldg, dead);
}

// dQ of the queries q0 .. q0 + 127 of head h of image b. Grid (s_pad / 128
// rounded up, heads, B); the tensor maps as attention_dkdv_wgmma_kernel's.
// dq = dQ scale at write-out.
__global__ void __launch_bounds__(wk4::WG_THREADS, 1)
attention_dq_wgmma_kernel(const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap qs_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const int* __restrict__ valid_len, bf16* __restrict__ dq, int ldg,
                          int s_pad, float scale) {
  using namespace wk4;
  const int q0 = blockIdx.x * SPAN, h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const int vl = min(max(valid_len[b], 0), s_pad);
  const int row0 = b * s_pad;
  bf16* dqb = dq + ((size_t)row0 + q0) * ldg + h * HD;
  const int in_image = min(CONSUMERS, (s_pad - q0) / TILE);
  if (q0 >= vl) {  // uniform across the block, before any barrier
    zero_tiles(dqb, ldg, in_image);
    return;
  }
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], res_full;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  unsigned char* Qs = base;                     // the consumers' qs tiles
  unsigned char* dOs = Qs + CONSUMERS * BOX;    // and dO tiles
  unsigned char* ring = dOs + CONSUMERS * BOX;  // a stage: K, then V
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], RELEASES);
    }
    wg::mbar_init(&res_full, 1);
    wg::mbar_fence_init();
  }
  __syncthreads();
  const int n_kt = (vl + TILE - 1) / TILE;

  if (warp >= PRODUCER_WARP) {
    wg::setmaxnreg_dec<40>();
    if (warp == PRODUCER_WARP && lane == 0) {
      wg::tma_prefetch(&k_map);
      wg::tma_prefetch(&v_map);
      wg::tma_prefetch(&qs_map);
      wg::tma_prefetch(&do_map);
      wg::mbar_expect_tx(&res_full, 2 * CONSUMERS * BOX);
      for (int c = 0; c < CONSUMERS; ++c) {
        wg::tma_load_2d(Qs + c * BOX, &qs_map, &res_full, h * HD, row0 + q0 + c * TILE);
        wg::tma_load_2d(dOs + c * BOX, &do_map, &res_full, h * HD, row0 + q0 + c * TILE);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES;
        wg::mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        unsigned char* st = ring + s * 2 * BOX;
        wg::mbar_expect_tx(&full[s], 2 * BOX);
        wg::tma_load_2d(st, &k_map, &full[s], h * HD, row0 + kt * TILE);
        wg::tma_load_2d(st + BOX, &v_map, &full[s], h * HD, row0 + kt * TILE);
      }
    }
    return;
  }

  wg::setmaxnreg_inc<232>();
  const int wgi = warp / 4, q = warp % 4, g = lane >> 2, t = lane & 3;
  const int qt0 = q0 + wgi * TILE;  // the warpgroup's first query
  const unsigned char* qs = Qs + wgi * BOX;
  const unsigned char* dos = dOs + wgi * BOX;
  // the rows' lse and delta; a tile past the image reads none (p = 0)
  float lse_r[2] = {1e30f, 1e30f}, delta_r[2] = {0.f, 0.f};
  if (qt0 < s_pad) {
    const size_t stat = ((size_t)b * heads + h) * s_pad + qt0 + 16 * q + g;
    lse_r[0] = lse[stat];
    lse_r[1] = lse[stat + 8];
    delta_r[0] = delta[stat];
    delta_r[1] = delta[stat + 8];
  }
  float acc[ACC], sc[ACC], dp[ACC];
  uint32_t da[TILE / 16][4];  // bf16(dS): the RS A operand
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  wg::mbar_wait(&res_full, 0);
  for (int kt = 0; kt < n_kt; ++kt) {  // n_kt is uniform: every wgmma outside a branch
    const int s = kt % STAGES;
    wg::mbar_wait(&full[s], (kt / STAGES) & 1);
    const unsigned char* ks = ring + s * 2 * BOX;
    const unsigned char* vs = ks + BOX;
    wg::fence_operand(sc);
    wg::fence_operand(dp);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)  // S = qs K^T
      wg::mma_m64n64k16<0, 0>(sc, wg::desc_k64(qs, kk), wg::desc_k64(ks, kk), kk != 0);
    wg::commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)  // dP = dO V^T
      wg::mma_m64n64k16<0, 0>(dp, wg::desc_k64(dos, kk), wg::desc_k64(vs, kk), kk != 0);
    wg::commit();
    wg::wait<1>();  // S, and the previous tile's dQ products; dP may run on
    wg::fence_operand(sc);
    wg::fence_operand(da);
    wg::fence_operand(acc);
    if (kt > 0 && lane == 0) wg::mbar_arrive(&empty[(kt - 1) % STAGES]);
    const bool ragged = (kt + 1) * TILE > vl;
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)  // P, kept in sc
        sc[4 * j + e] = ragged && kt * TILE + 8 * j + 2 * t + (e & 1) >= vl
                            ? 0.f
                            : exp2f(sc[4 * j + e] - lse_r[e >> 1]);
    wg::wait<0>();  // dP
    wg::fence_operand(dp);
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)  // dS, kept in dp
        dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - delta_r[e >> 1]);
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) wg::a_from_acc(da[kk], dp, kk);
    wg::fence_operand(da);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)  // dQ += bf16(dS) K
      wg::mma_m64n64k16_rs<1>(acc, da[kk], wg::desc_mn64(ks, kk), 1);
    wg::commit();
  }
  wg::wait<0>();
  wg::fence_operand(da);
  wg::fence_operand(acc);
  if (qt0 >= s_pad) return;  // the second tile of a block that ends the image
  // each warpgroup stages its rows in its own qs tile, which only it read
  store_tile(acc, scale, reinterpret_cast<bf16*>(Qs + wgi * BOX),
             dqb + (size_t)wgi * TILE * ldg, ldg, qt0 >= vl);
}

// ---- K3 at head 64: the forward on wgmma, fed by TMA ---------------------------
// What bounds it on an H100: operations (4 vl^2 64 a head and image on 3 vl
// 64 bf16 inputs), which only wgmma reaches; the mma.sync forward's four
// warps each read every K and V fragment from shared memory for their own 16
// rows, four reads of each B tile for 64 rows. The design, for HD = 64 only,
// in the style of the backward's kernels above (wk4's warpgroups, ring,
// turns and epilogue):
// - a block owns FWD_SPAN queries, FWD_CONSUMERS (3) 64-row tiles of the
//   contract, one a consumer warpgroup, each tested against valid_len on its
//   own; the producer thread TMAs the q tiles, then streams the K and V
//   tiles below valid_len through the ring of STAGES mbarrier stages (a
//   stage: the K tile, then the V tile, 64 x 64 boxes in the 128-byte
//   swizzle);
// - a consumer multiplies its q tile by qscale and rounds it to bf16 in
//   place (the async proxy then sees the plain stores: fence.proxy.async and
//   a barrier of the warpgroup), which is then the SS A operand, K-major;
// - per key tile: S = qs K^T (SS m64n64k16, K K-major), the ragged last
//   tile's keys past valid_len -inf in registers, the online softmax on the
//   accumulator in the mma.sync kernel's order (its s[nt][e] is d[4 nt + e]:
//   the max over the tile, the quad's shuffles, exp2f(s - m), the thread's
//   share of l over the unrounded p in the same order, l = l alpha + sum, O
//   times alpha before the tile's P V), then O += bf16(P) V (RS: P from the
//   accumulator by a_from_acc, V read MN-major). So out and lse keep the
//   mma.sync kernel's bits: the same bf16 products, f32 sums in the same
//   k16 order, the same scalar steps;
// - a tile's P V runs under the next tile's scores and softmax (S of tile
//   kt and P V of tile kt - 1 are two commit groups; the softmax waits for
//   the first, O's rescale and bf16(P) into the RS registers for the second:
//   a register of an RS operand written while a product is in flight, even
//   for the next product, made ptxas serialize every wgmma, C7513), and the
//   warpgroups take turns issuing their products (named barriers TURN ..),
//   so that one's softmax overlaps the others' products. The softmax's
//   instructions, not the products, bound it (its no_mma build takes most of
//   its time), so a block holds three consumer warpgroups, twelve warps to
//   hide their latencies, in 128 registers a thread: 80 of sums and
//   operands (O, S, P). Every wgmma is outside any branch (a dead tile of a
//   live block is walked and written as zeros);
// - the epilogue: O / l rounded to bf16 through the warpgroup's own q tile
//   (store_tile), lse = m + log2 l; a query tile wholly past valid_len writes
//   zeros and lse 1e30; a tile of a block that ends the image past s_pad
//   (s_pad a multiple of 64) stores nothing.
namespace wk4 {
constexpr int FWD_CONSUMERS = 3;  // consumer warpgroups, a 64-query tile each
constexpr int FWD_THREADS = 128 * (FWD_CONSUMERS + 1);  // and a producer warpgroup
constexpr int FWD_PRODUCER_WARP = 4 * FWD_CONSUMERS;
constexpr int FWD_SPAN = TILE * FWD_CONSUMERS;  // a block's queries
constexpr int FWD_RELEASES = 4 * FWD_CONSUMERS;
// the registers a thread at launch (65 536 over the block), the producer's
// after setmaxnreg, and the consumers' with what the producer gave up
constexpr int FWD_PRODUCER_REGS = 24;
constexpr int FWD_CONSUMER_REGS = 160;
constexpr int FWD_WG_SMEM = FWD_CONSUMERS * BOX + STAGES * 2 * BOX + 1024;
// named barriers TURN .. TURN + FWD_CONSUMERS - 1: the turns; then Q_READY ..:
// a warpgroup's scaled q
constexpr int Q_READY = TURN + FWD_CONSUMERS;
}  // namespace wk4

// out and lse of the FWD_SPAN queries from q0 of head h of image b. Grid
// (s_pad / FWD_SPAN rounded up, heads, B). q_map, k_map, v_map: (B s_pad,
// heads HD) views of q, k and v (rows of ld); out: rows of ldo; lse: (B,
// heads, s_pad) f32 or null.
__global__ void __launch_bounds__(wk4::FWD_THREADS, 1)
attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const int* __restrict__ valid_len, bf16* __restrict__ out, int ldo,
                           float* __restrict__ lse, int s_pad, float qscale) {
  using namespace wk4;
  const int q0 = blockIdx.x * FWD_SPAN, h = blockIdx.y, b = blockIdx.z;
  const int vl = min(max(valid_len[b], 0), s_pad);
  const int row0 = b * s_pad;
  bf16* ob = out + ((size_t)row0 + q0) * ldo + h * HD;
  float* lse_row = lse == nullptr ? nullptr : lse + ((size_t)b * gridDim.y + h) * s_pad + q0;
  const int in_image = min(FWD_CONSUMERS, (s_pad - q0) / TILE);  // the tiles below s_pad
  if (q0 >= vl) {  // uniform across the block, before any barrier
    for (int c = threadIdx.x; c < in_image * TILE * 8; c += FWD_THREADS)
      *reinterpret_cast<uint4*>(ob + (size_t)(c / 8) * ldo + c % 8 * 8) = make_uint4(0, 0, 0, 0);
    if (lse_row != nullptr && (int)threadIdx.x < in_image * TILE) lse_row[threadIdx.x] = 1e30f;
    return;
  }
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], q_full;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  unsigned char* Qs = base;                    // the consumers' q tiles
  unsigned char* ring = Qs + FWD_CONSUMERS * BOX;  // a stage: K, then V
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], FWD_RELEASES);
    }
    wg::mbar_init(&q_full, 1);
    wg::mbar_fence_init();
  }
  __syncthreads();
  const int n_kt = (vl + TILE - 1) / TILE;  // key 0 is valid: n_kt >= 1

  if (warp >= FWD_PRODUCER_WARP) {
    wg::setmaxnreg_dec<FWD_PRODUCER_REGS>();
    if (warp == FWD_PRODUCER_WARP && lane == 0) {
      wg::tma_prefetch(&q_map);
      wg::tma_prefetch(&k_map);
      wg::tma_prefetch(&v_map);
      wg::mbar_expect_tx(&q_full, FWD_CONSUMERS * BOX);
      for (int c = 0; c < FWD_CONSUMERS; ++c)  // a tile past the image: its rows are not stored
        wg::tma_load_2d(Qs + c * BOX, &q_map, &q_full, h * HD, row0 + q0 + c * TILE);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES;
        wg::mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        unsigned char* st = ring + s * 2 * BOX;
        wg::mbar_expect_tx(&full[s], 2 * BOX);
        wg::tma_load_2d(st, &k_map, &full[s], h * HD, row0 + kt * TILE);
        wg::tma_load_2d(st + BOX, &v_map, &full[s], h * HD, row0 + kt * TILE);
      }
    }
    return;
  }

  wg::setmaxnreg_inc<FWD_CONSUMER_REGS>();
  const int wgi = warp / 4, q = warp % 4, g = lane >> 2, t = lane & 3;
  const int qt0 = q0 + wgi * TILE;  // the warpgroup's first query
  unsigned char* qs = Qs + wgi * BOX;
  wg::mbar_wait(&q_full, 0);
  {  // q times qscale, rounded to bf16 in place (the swizzle moves whole chunks)
    uint4* chunks = reinterpret_cast<uint4*>(qs);
#pragma unroll
    for (int i = 0; i < BOX / 16 / 128; ++i) {
      uint4 u = chunks[(threadIdx.x & 127) + 128 * i];
      uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = unpack_bf16x2(w[e]);
        w[e] = pack_bf16x2(f.x * qscale, f.y * qscale);
      }
      chunks[(threadIdx.x & 127) + 128 * i] = u;
    }
    wg::fence_proxy_async();  // the plain stores, before the products read them
    wg::bar_sync(Q_READY + wgi, 128);
  }
  float o[ACC], sc[ACC];
  uint32_t pa[TILE / 16][4];  // bf16(P): the RS A operand
#pragma unroll
  for (int i = 0; i < ACC; ++i) o[i] = 0.f;
  // running max and the thread's share of the running sum, rows 16 q + g and
  // 16 q + g + 8; key 0 is valid, so the max is finite from the first tile on
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  // the online softmax of key tile kt on sc, p left in sc; alpha: O's factor
  auto softmax = [&](int kt) {
    if ((kt + 1) * TILE > vl)  // the ragged last tile
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kt * TILE + 8 * j + 2 * t + (e & 1) >= vl) sc[4 * j + e] = -INFINITY;
    float mx[2] = {m[0], m[1]}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[4 * j + e] = exp2f(sc[4 * j + e] - m[e >> 1]);
        sum[e >> 1] += sc[4 * j + e];  // l sums p unrounded; P V takes it in bf16
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
  };

  // the warpgroups take turns issuing their products, warpgroup 0's tile 0,
  // warpgroup 1's, ..., warpgroup 0's tile 1, ...: each waits at its own
  // barrier for its predecessor's arrival and arrives at its successor's
  // (all but the last turn of all)
  const int next = TURN + (wgi + 1) % FWD_CONSUMERS;
  const bool last_wg = wgi == FWD_CONSUMERS - 1;
  // key tile 0: its scores and softmax (O is zero: no rescale)
  wg::mbar_wait(&full[0], 0);
  if (wgi > 0) wg::bar_sync(TURN + wgi, 2 * 128);
  wg::fence_operand(sc);
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)  // S = qs K^T
    wg::mma_m64n64k16<0, 0>(sc, wg::desc_k64(qs, kk), wg::desc_k64(ring, kk), kk != 0);
  wg::commit();
  if (!last_wg || n_kt > 1) wg::bar_arrive(next, 2 * 128);
  wg::wait<0>();
  wg::fence_operand(sc);
  softmax(0);
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) wg::a_from_acc(pa[kk], sc, kk);
  for (int kt = 1; kt < n_kt; ++kt) {  // n_kt is uniform: every wgmma outside a branch
    const int s = kt % STAGES;
    const unsigned char* ks = ring + s * 2 * BOX;
    const unsigned char* vp = ring + ((kt - 1) % STAGES) * 2 * BOX + BOX;  // tile kt - 1's V
    wg::mbar_wait(&full[s], (kt / STAGES) & 1);
    wg::bar_sync(TURN + wgi, 2 * 128);  // its turn
    wg::fence_operand(sc);
    wg::fence_operand(o);
    wg::fence_operand(pa);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)  // S = qs K^T
      wg::mma_m64n64k16<0, 0>(sc, wg::desc_k64(qs, kk), wg::desc_k64(ks, kk), kk != 0);
    wg::commit();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)  // O += bf16(P) V, tile kt - 1
      wg::mma_m64n64k16_rs<1>(o, pa[kk], wg::desc_mn64(vp, kk), 1);
    wg::commit();
    if (!last_wg || kt < n_kt - 1) wg::bar_arrive(next, 2 * 128);
    wg::wait<1>();  // S; the P V products may run on
    wg::fence_operand(sc);
    softmax(kt);
    wg::wait<0>();  // P V: pa and the stage of tile kt - 1 are free
    wg::fence_operand(o);
    wg::fence_operand(pa);
    if (lane == 0) wg::mbar_arrive(&empty[(kt - 1) % STAGES]);
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) wg::a_from_acc(pa[kk], sc, kk);
  }
  // the last tile's P V
  const unsigned char* v_last = ring + ((n_kt - 1) % STAGES) * 2 * BOX + BOX;
  wg::fence_operand(o);
  wg::fence_operand(pa);
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk)
    wg::mma_m64n64k16_rs<1>(o, pa[kk], wg::desc_mn64(v_last, kk), 1);
  wg::commit();
  wg::wait<0>();
  wg::fence_operand(o);
  wg::fence_operand(pa);
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // the quad's shares of the row sum
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if (qt0 >= s_pad) return;  // a tile past the image, in a block that ends it
  // each warpgroup stages its rows in its own q tile, which only it read
  const bool dead = qt0 >= vl;
  store_tile(o, 1.f / l[0], 1.f / l[1], reinterpret_cast<bf16*>(qs),
             ob + (size_t)wgi * TILE * ldo, ldo, dead);
  if (lse_row != nullptr && t == 0) {
    const int r = wgi * TILE + 16 * q + g;
    lse_row[r] = dead ? 1e30f : m[0] + log2f(l[0]);
    lse_row[r + 8] = dead ? 1e30f : m[1] + log2f(l[1]);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int HD>
int launch_fwd(const bf16* q, const bf16* k, const bf16* v, int ld, const int* valid_len,
               bf16* out, int ldo, float* lse, int batch, int heads, int s_pad, float qscale,
               cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(attention_fwd_bf16_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM<HD>);
  if (e != cudaSuccess) return (int)e;
  attention_fwd_bf16_kernel<HD><<<dim3(s_pad / TILE, heads, batch), THREADS, FWD_SMEM<HD>, st>>>(
      q, k, v, ld, valid_len, out, ldo, lse, s_pad, qscale);
  return (int)cudaGetLastError();
}

// K3 at head 64: the wgmma forward. The tensor maps are (B s_pad, heads HD)
// views of q, k and v (rows of ld), 64 x 64 boxes.
int launch_fwd_wgmma(const bf16* q, const bf16* k, const bf16* v, int ld, const int* valid_len,
                     bf16* out, int ldo, float* lse, int batch, int heads, int s_pad,
                     float qscale, cudaStream_t st) {
  using namespace wk4;
  const uint64_t rows = (uint64_t)batch * s_pad, inner = (uint64_t)heads * HD;
  CUtensorMap q_map, k_map, v_map;
  int e = wg::make_map_2d(&q_map, q, inner, rows, (uint64_t)ld * 2, HD, TILE);
  if (e == 0) e = wg::make_map_2d(&k_map, k, inner, rows, (uint64_t)ld * 2, HD, TILE);
  if (e == 0) e = wg::make_map_2d(&v_map, v, inner, rows, (uint64_t)ld * 2, HD, TILE);
  if (e == 0)
    e = (int)cudaFuncSetAttribute(attention_fwd_wgmma_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_WG_SMEM);
  if (e != 0) return e;
  attention_fwd_wgmma_kernel<<<dim3((s_pad + FWD_SPAN - 1) / FWD_SPAN, heads, batch),
                               FWD_THREADS, FWD_WG_SMEM, st>>>(q_map, k_map, v_map, valid_len,
                                                               out, ldo, lse, s_pad, qscale);
  return (int)cudaGetLastError();
}

// K4 at head 64: the prep pass, then the wgmma dk/dv and dq. The tensor maps
// are (B s_pad, heads HD) views of k, v (rows of ld), the scaled q (rows of
// heads HD) and dout (rows of ldo), 64 x 64 boxes.
int launch_bwd_wgmma(const bf16* q, const bf16* k, const bf16* v, int ld, const bf16* o,
                     const bf16* dout, int ldo, const float* lse, float* delta,
                     const int* valid_len, bf16* dq, bf16* dk, bf16* dv, int ldg, int batch,
                     int heads, int s_pad, float qscale, float scale, cudaStream_t st) {
  using namespace wk4;
  bf16* qs = reinterpret_cast<bf16*>(delta + (size_t)batch * heads * s_pad);
  const int total = batch * s_pad * heads;
  attention_bwd_prep_kernel<HD><<<(total + PREP_THREADS / 16 - 1) / (PREP_THREADS / 16),
                                  PREP_THREADS, 0, st>>>(q, ld, o, dout, ldo, valid_len, delta,
                                                         qs, heads, s_pad, total, qscale);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  const uint64_t rows = (uint64_t)batch * s_pad, inner = (uint64_t)heads * HD;
  CUtensorMap k_map, v_map, qs_map, do_map;
  e = wg::make_map_2d(&k_map, k, inner, rows, (uint64_t)ld * 2, HD, TILE);
  if (e == 0) e = wg::make_map_2d(&v_map, v, inner, rows, (uint64_t)ld * 2, HD, TILE);
  if (e == 0) e = wg::make_map_2d(&qs_map, qs, inner, rows, inner * 2, HD, TILE);
  if (e == 0) e = wg::make_map_2d(&do_map, dout, inner, rows, (uint64_t)ldo * 2, HD, TILE);
  if (e == 0)
    e = (int)cudaFuncSetAttribute(attention_dkdv_wgmma_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, DKDV_WG_SMEM);
  if (e == 0)
    e = (int)cudaFuncSetAttribute(attention_dq_wgmma_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_WG_SMEM);
  if (e != 0) return e;
  const dim3 grid((s_pad + SPAN - 1) / SPAN, heads, batch);
  attention_dkdv_wgmma_kernel<<<grid, WG_THREADS, DKDV_WG_SMEM, st>>>(
      k_map, v_map, qs_map, do_map, lse, delta, valid_len, dk, dv, ldg, s_pad);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  attention_dq_wgmma_kernel<<<grid, WG_THREADS, DQ_WG_SMEM, st>>>(
      k_map, v_map, qs_map, do_map, lse, delta, valid_len, dq, ldg, s_pad, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bwd(const bf16* q, const bf16* k, const bf16* v, int ld, const bf16* o,
               const bf16* dout, int ldo, const float* lse, float* delta, const int* valid_len,
               bf16* dq, bf16* dk, bf16* dv, int ldg, int batch, int heads, int s_pad,
               float qscale, float scale, cudaStream_t st) {
  bf16* qs = reinterpret_cast<bf16*>(delta + (size_t)batch * heads * s_pad);
  const int total = batch * s_pad * heads;
  attention_bwd_prep_kernel<HD><<<(total + PREP_THREADS / 16 - 1) / (PREP_THREADS / 16),
                                  PREP_THREADS, 0, st>>>(q, ld, o, dout, ldo, valid_len, delta,
                                                         qs, heads, s_pad, total, qscale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(attention_dkdv_bf16_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, DKDV_SMEM<HD>);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(attention_dq_bf16_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM<HD>);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(s_pad / TILE, heads, batch);
  attention_dkdv_bf16_kernel<HD><<<grid, THREADS, DKDV_SMEM<HD>, st>>>(
      qs, k, v, ld, dout, ldo, lse, delta, valid_len, dk, dv, ldg, s_pad);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attention_dq_bf16_kernel<HD><<<grid, THREADS, DQ_SMEM<HD>, st>>>(
      qs, k, v, ld, dout, ldo, lse, delta, valid_len, dq, ldg, s_pad, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v: (batch * s_pad) rows of ld elements (they may be column slices of
// one packed qkv buffer); out: rows of ldo elements; lse, when not null:
// (batch, heads, s_pad) f32, the base-2 log-sum-exp of each query row.
// valid_len is clamped to [0, s_pad]. head_dim is 32, 64 or 96 (any other is
// refused) and s_pad a multiple of 64; ld and ldo are multiples of 8 and q,
// k, v and out 16-byte aligned (the 16-byte copies and stores). qscale =
// log2(e) / sqrt(head_dim) rounded to bf16.
int prefix_attention_fwd_bf16(const bf16* q, const bf16* k, const bf16* v, int ld,
                              const int* valid_len, bf16* out, int ldo, float* lse, int batch,
                              int heads, int head_dim, int s_pad, float qscale, void* stream) {
  if (batch <= 0 || heads <= 0 || !built_head_dim(head_dim) || s_pad <= 0 || s_pad % TILE ||
      ld % 8 || ldo % 8 || !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 32)
    return launch_fwd<32>(q, k, v, ld, valid_len, out, ldo, lse, batch, heads, s_pad, qscale, st);
  return head_dim == 64
             ? launch_fwd_wgmma(q, k, v, ld, valid_len, out, ldo, lse, batch, heads, s_pad,
                                qscale, st)
             : launch_fwd<96>(q, k, v, ld, valid_len, out, ldo, lse, batch, heads, s_pad, qscale,
                              st);
}

// q, k, v: (batch * s_pad) rows of ld elements (column slices of one packed
// qkv buffer, or not); o (the forward's output) and dout: rows of ldo
// elements; lse: (batch, heads, s_pad) f32, the forward's base-2 lse. delta:
// scratch of batch * heads * s_pad f32 (delta), followed by batch * s_pad *
// heads * head_dim bf16 (the scaled q, rows of heads * head_dim). dq, dk, dv:
// rows of ldg elements (they may be column slices of one packed dqkv
// buffer). head_dim is 32, 64 or 96 (any other is refused) and s_pad a multiple
// of 64; ld, ldo and ldg are multiples of 8 and every bf16 pointer and delta
// 16-byte aligned. qscale = log2(e) / sqrt(head_dim) rounded to bf16, scale =
// 1 / sqrt(head_dim). Three launches: the prep pass, dk/dv, dq (at head 64
// the wgmma kernels, whose tensor maps are built here).
int prefix_attention_bwd_bf16(const bf16* q, const bf16* k, const bf16* v, int ld,
                              const bf16* o, const bf16* dout, int ldo, const float* lse,
                              float* delta, const int* valid_len, bf16* dq, bf16* dk, bf16* dv,
                              int ldg, int batch, int heads, int head_dim, int s_pad,
                              float qscale, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || !built_head_dim(head_dim) || s_pad <= 0 || s_pad % TILE ||
      ld % 8 || ldo % 8 || ldg % 8 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(o) || !aligned16(dout) || !aligned16(lse) || !aligned16(delta) ||
      !aligned16(dq) || !aligned16(dk) || !aligned16(dv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 32)
    return launch_bwd<32>(q, k, v, ld, o, dout, ldo, lse, delta, valid_len, dq, dk, dv, ldg,
                          batch, heads, s_pad, qscale, scale, st);
  return head_dim == 64 ? launch_bwd_wgmma(q, k, v, ld, o, dout, ldo, lse, delta, valid_len, dq,
                                           dk, dv, ldg, batch, heads, s_pad, qscale, scale, st)
                        : launch_bwd<96>(q, k, v, ld, o, dout, ldo, lse, delta, valid_len, dq,
                                         dk, dv, ldg, batch, heads, s_pad, qscale, scale, st);
}

}  // extern "C"
