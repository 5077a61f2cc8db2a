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
//
// Every kernel is a template on the head width HD, built for 96
// (ChAdaViT-moyen, D 192 in 2 heads: 6 k16 steps and 12 n8 blocks over a
// head), 64 (ChAdaViT-B/16, D 768 in 12 heads: 4 and 8) and 32 (the smoke
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
             ? launch_fwd<64>(q, k, v, ld, valid_len, out, ldo, lse, batch, heads, s_pad, qscale,
                              st)
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
// 1 / sqrt(head_dim). Three launches: the prep pass, dk/dv, dq.
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
  return head_dim == 64 ? launch_bwd<64>(q, k, v, ld, o, dout, ldo, lse, delta, valid_len, dq,
                                         dk, dv, ldg, batch, heads, s_pad, qscale, scale, st)
                        : launch_bwd<96>(q, k, v, ld, o, dout, ldo, lse, delta, valid_len, dq,
                                         dk, dv, ldg, batch, heads, s_pad, qscale, scale, st);
}

}  // extern "C"
