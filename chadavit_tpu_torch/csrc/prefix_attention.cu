// Prefix-masked multi-head attention, forward, on CUDA cores, in float32. The
// bf16 instance is a tensor-core kernel of its own (prefix_attention_bf16.cu).
//
// Replaces the TPU kernel chadavit_tpu/ops/flash_attention.py::_fwd_kernel
// (reached through _fwd_impl / prefix_flash_attention), and the attention step
// inside chadavit_tpu/ops/fused_block.py::_fwd_kernel. Key j of image b is valid
// iff j < valid_len[b]; queries are not masked.
//
// What bounds it on an H100: per (image, head) it does 4 * vl^2 * hd operations
// on 3 * vl * hd inputs, about 2 * vl / 3 operations per byte, so at
// vl = 1961 it is bound by operations (67 TFLOP/s of f32 FMA). The TPU kernel
// holds a whole (BQ, S_pad) score row in VMEM; here a block owns BT = 64
// queries of one head and streams 64 keys at a time through shared memory
// with an online softmax. The scale and log2(e) are folded into q once
// (qs = q qscale, rounded once, as the backward's prep pass forms it), and
// the softmax runs in base 2 with exp2f. The key loop stops at valid_len[b],
// and the ragged last key tile is masked to -inf, so padded keys cost
// nothing. The design, for the CUDA cores (attention_f32.cuh holds the
// pieces it shares with the backward, prefix_attention_bwd.cu):
// - 4 warps, each owning 16 of the block's queries; a thread holds the scores
//   of 4 queries x 8 keys (keys kg + 8 j of the tile) and reads a float4 of
//   each over four d (sgemm::dot4: 12 reads of 16 bytes for 128 FMAs). Each
//   score is summed over d in ascending order with fmaf from the same qs, so
//   it is the bit the backward recomputes, and the backward's p = exp2(s -
//   lse) sums to 1 per row within f32 rounding;
// - the online softmax stays in registers: a row's max and sum go by
//   __shfl_xor among the 8 lanes that share the row, with no pass through
//   shared memory and no barrier of its own;
// - P goes through shared memory only within its warp (a thread's score
//   columns are not its output columns): the warp's P[key][query], then the
//   second product acc += P V over the tile's 64 keys, a thread's 4 queries x
//   HD / 8 head columns (at HD 96, 4 reads of 16 bytes for 48 FMAs;
//   sgemm::outer);
// - the key and value tiles come through a two-slot cp.async ring in turns,
//   K of tile t, then V of tile t, then K of tile t + 1: each is in flight
//   while the one before it is multiplied, one barrier a tile each. The
//   block's own Q tile joins the first copy group, and each warp scales its
//   16 rows in place once they have landed. At HD 96, Q 25.6 KB, the ring
//   51.2 KB and the warps' P 20.5 KB make 95 KB of shared memory: two blocks
//   an SM (at HD 64, 73 KB);
// - the blocks take the images longest first: block (tile, head, p) works
//   on the image of rank p by decreasing valid_len (ties by index), which
//   every warp ranks itself from valid_len (batches of at most ORDER_MAX
//   images; larger ones, and ATTN_FWD_IN_ORDER, take index order), so the
//   longest key walks start first and the short ones fill in behind them,
//   with no host sync and no scratch;
// - a diagnostic build, ATTN_FWD_SPLIT = 2, splits each tile's key walk
//   across a cluster of two blocks: block `rank` walks its share of the key
//   tiles and block 0 adds block 1's (m, l, acc) after its own through
//   distributed shared memory (a fixed order, the same bits on every run),
//   so the hub's 298 tiles with work, which walk 4 to 31 key tiles, become
//   596 blocks of at most 16. scripts/bench_attention_f32.py times it 2-3 %
//   faster on an H100, but it rounds o and lse otherwise, and that moved a
//   hid entry of chip_smoke.py's float32 layer check across the ReLU kink;
//   the entry points load whole walks.
//
// A block (a cluster when split) whose first query lies at or past
// valid_len[b] writes zeros and returns. That decision is the same for every
// thread of the cluster and is taken before the first barrier, so no thread
// can wait at a barrier that another has left. For training the kernel also writes the base-2 lse of
// every query row (lse = m + log2(l), flash_attention.py:137-138) at
// lse[(b * heads + h) * s_pad + q], which the backward
// (prefix_attention_bwd.cu) reads; the output is optional (a null pointer),
// so the serving path writes none. Skipped tiles get lse = 1e30 there, the
// TPU kernel's +LARGE, so a recomputed p underflows to 0 on those rows. Every
// row of a 64-query tile that is not skipped is computed for real, also its
// rows past valid_len[b].
//
// q, k, v and out are float32, so nothing rounds where the JAX kernel's
// dtype-generic body (flash_attention.py:103-138) casts to the input dtype.
//
// The kernel is a template on the head width HD, built for 96 (ChAdaViT-moyen),
// 64 (ChAdaViT-B/16, D 768 in 12 heads) and 32 (the smoke configs, D 64 in 2
// heads: one float4 of head columns a thread): one launch covers every head, as
// the grid's y; the JAX kernel's walk over groups of at most 384 lanes
// (flash_attention.py:29, :275) bounds its VMEM and is not part of the
// function, so it has no counterpart here.
//
// Plain C interface (loaded with ctypes); the launcher returns
// cudaGetLastError() so that the Python wrapper can raise on a refused launch.

#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "attention_f32.cuh"

namespace {

constexpr int WARPS = 4;  // 16 queries a warp
constexpr int THREADS = WARPS * 32;
constexpr int LDP = 16 + 4;         // a key's row of a warp's P: its 16 queries, padded
constexpr int P_F = BT * LDP;       // floats of a warp's P
constexpr int STAGES = 2;           // the ring's slots, K and V in turns
constexpr int ORDER_MAX = 64;       // the most images a block ranks
template <int HD>
constexpr int SMEM = (TILE_F<HD> + STAGES * TILE_F<HD> + WARPS * P_F) * (int)sizeof(float);
#ifndef ATTN_FWD_SPLIT
#define ATTN_FWD_SPLIT 1
#endif
constexpr int SPLIT = ATTN_FWD_SPLIT;  // blocks a cluster, each a share of the key walk (2: the bench's)
template <int HD>
constexpr int PART = 4 + 4 + 4 * (HD / 8);  // a thread's m, l and acc, handed between them
static_assert(SPLIT == 1 || SPLIT == 2, "one block, or two splitting the walk");
static_assert(PART<32> * THREADS <= STAGES * TILE_F<32> &&
                  PART<64> * THREADS <= STAGES * TILE_F<64> &&
                  PART<96> * THREADS <= STAGES * TILE_F<96>,
              "the partials fit the ring");

// The image of rank p when the batch's images are taken by decreasing
// valid_len, ties by index. Every lane of the warp takes part and gets it.
__device__ __forceinline__ int image_of_rank(const int* __restrict__ valid_len, int batch,
                                             int p) {
#ifndef ATTN_FWD_IN_ORDER
  if (batch <= ORDER_MAX) {
    const int lane = threadIdx.x & 31;
    for (int t0 = 0; t0 < batch; t0 += 32) {  // the same trips for every lane
      const int t = t0 + lane;
      bool hit = false;
      if (t < batch) {
        const int vt = valid_len[t];
        int rank = 0;
        for (int j = 0; j < batch; ++j) {
          const int vj = valid_len[j];
          rank += vj > vt || (vj == vt && j < t);
        }
        hit = rank == p;
      }
      const unsigned found = __ballot_sync(0xffffffffu, hit);
      if (found != 0u) return t0 + __ffs(found) - 1;
    }
  }
#endif
  return p;
}

// q, k, v: rows of `ld` elements, image b's rows start at b * s_pad; head h
// occupies columns [h * HD, (h + 1) * HD). out: rows of `ldo` elements, the
// same row layout. Grid (s_pad / BT * SPLIT, heads, B) in clusters of
// (SPLIT, 1, 1).
template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
prefix_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, int ld,
                        const int* __restrict__ valid_len,
                        float* __restrict__ out, int ldo,
                        float* __restrict__ lse, int s_pad, float qscale) {
  namespace cg = cooperative_groups;
  const int rank = SPLIT > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int q0 = blockIdx.x / SPLIT * BT, h = blockIdx.y, heads = gridDim.y;
  const int b = image_of_rank(valid_len, gridDim.z, blockIdx.z);
  const int vl = min(max(valid_len[b], 0), s_pad);  // a bad length cannot read past the image
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row0 = (size_t)b * s_pad;
  float* o = out + (row0 + q0) * ldo + h * HD;
  // lse of (image b, head h, row q) at lse[(b * heads + h) * s_pad + q]
  float* lse_row = lse == nullptr ? nullptr : lse + ((size_t)b * heads + h) * s_pad + q0;
  constexpr int V4 = HD / 4, LD = LDH<HD>, TF = TILE_F<HD>;  // V4: groups of four per head row

  if (q0 >= vl) {  // uniform across the cluster, before any barrier
    if (rank != 0) return;
    for (int c = tid; c < BT * V4; c += THREADS)
      *reinterpret_cast<float4*>(o + (size_t)(c / V4) * ldo + c % V4 * 4) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    if (lse_row != nullptr && tid < BT) lse_row[tid] = 1e30f;
    return;
  }

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                             // (BT, LDH), scaled in place
  float* ring = Qs + TF;                        // STAGES slots of (BT, LDH)
  float* Pw = ring + STAGES * TF + warp * P_F;  // this warp's P[key][query]
  // the thread's queries r .. r + 3 (of the scores and of the output); its
  // keys kg + 8 j of a tile; its head columns 4 kg + 32 jj + {0..3}
  const int rg = lane >> 3, kg = lane & 7, r = 16 * warp + 4 * rg;

  // the block's share of the key tiles: [t0, t1) of the nt below valid_len
  const int nt = (vl + BT - 1) / BT, share = (nt + SPLIT - 1) / SPLIT;
  const int t0 = rank * share, t1 = min(nt, t0 + share);
  copy_tile<THREADS, HD>(Qs, q + (row0 + q0) * ld + h * HD, ld);  // with the first K tile's copies
  auto load = [&](int s, int slot) {  // K of tile t0 + s / 2 (s even) or its V (s odd)
    copy_tile<THREADS, HD>(ring + slot * TF,
                           (s & 1 ? v : k) + (row0 + (size_t)(t0 + (s >> 1)) * BT) * ld + h * HD,
                           ld);
  };
  float acc[4][HD / 8] = {};
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  sgemm::ring<STAGES>(2 * max(t1 - t0, 0), load, [&](int s, int slot) {
    const float* st = ring + slot * TF;
    if (s == 0) {  // the warp's 16 rows of q have landed: qs = q qscale, once
      for (int c = lane; c < 16 * V4; c += 32) {
        float* p = Qs + (16 * warp + c / V4) * LD + c % V4 * 4;
        const float4 t = load4(p);
        *reinterpret_cast<float4*>(p) =
            make_float4(t.x * qscale, t.y * qscale, t.z * qscale, t.w * qscale);
      }
      __syncwarp();
    }
    if ((s & 1) == 0) {  // K of tile s / 2: the scores, the softmax, P
      const int k0 = (t0 + (s >> 1)) * BT;
      float sc[4][8];
      scores<HD>(sc, Qs, r, st, kg);
      // the first key of a share is valid, so each row's max is finite from
      // the share's first tile on
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (k0 + kg + 8 * j >= vl) sc[i][j] = -INFINITY;
          mx = fmaxf(mx, sc[i][j]);
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = exp2f(m[i] - m_new);
        m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sc[i][j] = exp2f(sc[i][j] - m_new);
          sum += sc[i][j];
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        l[i] = l[i] * alpha + sum;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) acc[i][j] *= alpha;
      }
      // the warp's P of the tile before last was read before the ring's barrier
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float4*>(Pw + (kg + 8 * j) * LDP + 4 * rg) =
            make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    } else {  // V of tile s / 2: acc += P V (the ring's barrier put P in place)
      second_product<LDP, HD>(acc, Pw, 4 * rg, st, kg);
    }
  });

  if constexpr (SPLIT > 1) {  // block 0 adds block 1's share, in that order
    __syncthreads();          // every warp is done with the ring: it takes the partials
    float* part = ring;       // [value][thread]
    if (rank == 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        part[i * THREADS + tid] = m[i];
        part[(4 + i) * THREADS + tid] = l[i];
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) part[(8 + HD / 8 * i + j) * THREADS + tid] = acc[i][j];
      }
    }
    cg::this_cluster().sync();  // block 1's share is in place
    if (rank == 0) {
      const float* other = cg::this_cluster().map_shared_rank(part, 1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // a share with no tile has m = -inf and l = 0: it adds nothing
        const float m1 = other[i * THREADS + tid], mt = fmaxf(m[i], m1);
        const float a0 = exp2f(m[i] - mt), a1 = exp2f(m1 - mt);
        l[i] = l[i] * a0 + other[(4 + i) * THREADS + tid] * a1;
        m[i] = mt;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          acc[i][j] = acc[i][j] * a0 + other[(8 + HD / 8 * i + j) * THREADS + tid] * a1;
      }
    }
    cg::this_cluster().sync();  // block 1's share stays until read
    if (rank == 1) return;
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.f / l[i];
#pragma unroll
    for (int jj = 0; jj < HD / 32; ++jj)
      *reinterpret_cast<float4*>(o + (size_t)(r + i) * ldo + 4 * kg + 32 * jj) =
          make_float4(acc[i][4 * jj] * inv, acc[i][4 * jj + 1] * inv, acc[i][4 * jj + 2] * inv,
                      acc[i][4 * jj + 3] * inv);
  }
  if (lse_row != nullptr)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (kg == i) lse_row[r + i] = m[i] + log2f(l[i]);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int HD>
int launch(const float* q, const float* k, const float* v, int ld, const int* valid_len,
           float* out, int ldo, float* lse, int batch, int heads, int s_pad, float qscale,
           cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(prefix_attention_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM<HD>);
  if (e != cudaSuccess) return (int)e;
  if constexpr (SPLIT == 1) {
    prefix_attention_kernel<HD><<<dim3(s_pad / BT, heads, batch), THREADS, SMEM<HD>, st>>>(
        q, k, v, ld, valid_len, out, ldo, lse, s_pad, qscale);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(s_pad / BT * SPLIT, heads, batch);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = SMEM<HD>;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = SPLIT;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, prefix_attention_kernel<HD>, q, k, v, ld, valid_len, out, ldo,
                           lse, s_pad, qscale);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v: (batch * s_pad) rows of ld elements (they may be column slices of
// one packed qkv buffer); out: (batch * s_pad) rows of ldo elements. lse, when
// not null: (batch, heads, s_pad) f32, the base-2 log-sum-exp of each query
// row. valid_len is clamped to [0, s_pad]. head_dim is 32, 64 or 96 (any other
// is refused); ld and ldo are multiples of 4 and q, k, v and out are 16-byte
// aligned (the 16-byte copies and stores). qscale = log2(e) / sqrt(head_dim).
int prefix_attention_fwd(const float* q, const float* k, const float* v, int ld,
                         const int* valid_len, float* out, int ldo, float* lse,
                         int batch, int heads, int head_dim, int s_pad,
                         float qscale, void* stream) {
  if (batch <= 0 || heads <= 0 || !built_head_dim(head_dim) || s_pad <= 0 || s_pad % BT != 0 ||
      ld % 4 != 0 || ldo % 4 != 0 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(out))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 32)
    return launch<32>(q, k, v, ld, valid_len, out, ldo, lse, batch, heads, s_pad, qscale, st);
  return head_dim == 64
             ? launch<64>(q, k, v, ld, valid_len, out, ldo, lse, batch, heads, s_pad, qscale, st)
             : launch<96>(q, k, v, ld, valid_len, out, ldo, lse, batch, heads, s_pad, qscale, st);
}

}  // extern "C"
