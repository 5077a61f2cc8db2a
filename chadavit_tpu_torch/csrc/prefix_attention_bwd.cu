// Prefix-masked multi-head attention, backward, in float32: on CUDA cores at
// head widths 96 and 32, on the tensor cores in 3xTF32 at head 64 (the
// blocks "head 64" below). The bf16 instance is a tensor-core kernel of its
// own (prefix_attention_bf16.cu).
//
// Replaces the TPU kernel chadavit_tpu/ops/flash_attention.py::_bwd_kernel
// (reached through _vjp_bwd, the custom VJP of prefix_flash_attention), and the
// attention phase C' of chadavit_tpu/ops/fused_block.py::_bwd_kernel. Key j of
// image b is valid iff j < valid_len[b].
//
// The formulation is the TPU kernel's: the forward's base-2 lse makes the
// softmax exact without a running max, and per query row
//   delta = rowsum(do * o)                       (the prep pass)
//   p     = exp2(q k^T scale log2(e) - lse)
//   dv    = p^T do,  dp = do v^T,  ds = p (dp - delta)
//   dk    = ds^T q scale,  dq = ds k scale
// The scale and log2(e) are folded into q once, by the prep pass (qs = q
// qscale, into scratch), so dk carries a 1/log2(e) fix at write-out and dq
// the plain scale.
//
// What bounds it on an H100: per (image, head) it needs 10 * vl^2 * hd
// operations (the scores, dp, dv, dk, dq) on about 7 vl hd floats, so it is
// bound by operations (67 TFLOP/s of f32 FMA). The TPU kernel recomputes the
// scores once per key block for all queries and sums dq in one VMEM scratch
// across its sequential key loop. Blocks on Hopper run in no order, so dq is
// not summed across blocks: other blocks (dq_block) own 64 queries and walk
// the key blocks themselves, recomputing the scores once more. Every sum
// then has one owner and a fixed order, and the result is the same from run
// to run; the price is the second score recompute (the kernels do 14 vl^2 hd
// operations for the 10 the function needs).
//
// After the prep pass, one launch (attention_bwd_kernel) runs both kinds of
// block: dkdv_block owns BT = 64 keys of one head and walks the query tiles
// below valid_len[b]; dq_block owns BT = 64 queries and walks the key tiles
// below valid_len[b] (at head 64 dkdv_block_tc and dq_block_tc, the same
// walks on the tensor cores). The design, for the CUDA cores:
// - the walked tiles (qs, dO, lse and delta in dkdv; K and V in dq) come
//   through a two-slot ring of 16-byte cp.async copies (sgemm_f32.cuh), one
//   barrier a tile, the next tile in flight while this one is multiplied; the
//   block's own tiles (K and V; qs, dO, lse and delta) join the first copy
//   group. Head rows are staged as they lie, d contiguous, padded to HD + 4
//   floats so that the 8 rows a quarter warp reads lie in distinct banks
//   (attention_f32.cuh: the tiles and products the forward shares);
// - the 8 warps pair up: warp w < 4 computes the scores S (K qs^T in dkdv, qs
//   K^T in dq) of 16 of the block's rows against the tile's 64, warp w + 4
//   dP (V dO^T, dO V^T) of the same entries; a thread holds 4 x 8 of them and
//   reads a float4 of each of its 4 rows and 8 columns over four d (dot4:
//   12 reads of 16 bytes for 128 FMAs). Warp w writes P = exp2(S - lse) (0
//   past valid_len) into shared memory and hands it to warp w + 4 through a
//   named barrier of the two warps; warp w + 4 forms dS = P (dP - delta);
// - the second products read P or dS a float4 of 4 rows at a time and dO, qs
//   or K HD / 32 float4 of HD / 8 head columns (sgemm::outer; at HD 96, 4
//   reads for 48 FMAs): in dkdv warp w sums dV += P^T dO and warp w + 4 dK += dS^T qs, in
//   dq warp w + 4 sums dq += dS K; each warp reads only the P or dS rows that
//   it wrote itself;
// - one block an SM: K and V (or qs and dO) stay resident, and with the ring
//   and P and dS a block takes 185 KB of shared memory at HD 96 (140 KB at
//   HD 64). Two blocks an SM would leave room for no ring at all (one stage
//   alone is 137 KB at HD 96);
// - the blocks take the images longest first: the prep pass writes the
//   images' order by decreasing valid_len, and blocks 2 i and 2 i + 1 take
//   the dk/dv and the dq of the i-th item of that order (image, head, tile),
//   so the longest walks start first and the short ones, of both kinds, fill
//   in behind them.
// Every sum runs in the order of the old one-thread-a-product loops (d in
// order, then queries or keys in order), so only the order against the plain
// versions' matmuls differs.
//
// The contract is the TPU kernel's: the forward (prefix_attention.cu)
// computes every query of a 64-row tile that holds a valid query for real,
// also those past valid_len, so the backward is exact for any cotangent on
// them: every query row of such a tile takes part, with the forward's lse.
// Tiles wholly past the prefix were zero-filled (lse 1e30): they give nothing,
// and a block that owns one writes zeros and returns (dq 0 there). Keys at or
// past valid_len stay masked (p = 0), so their dk and dv are exact zeros.
// Every such decision is uniform per block and taken before the first
// barrier.
//
// q, k, v, o, do and the gradients are float32, so nothing rounds where the
// JAX body (dtype-generic, flash_attention.py:157-230) casts to the input
// dtype.
//
// Every kernel is a template on the head width HD, built for 96
// (ChAdaViT-moyen), 64 (ChAdaViT-B/16, D 768 in 12 heads) and 32 (the smoke
// configs, D 64 in 2 heads); every head is
// in one launch, with no counterpart of the JAX kernel's walk over groups of
// at most 384 lanes (a bound of its VMEM, not part of the function).

#include <math.h>

#include "attention_f32.cuh"

namespace {

constexpr int THREADS = 256;      // 8 warps: 4 pairs
constexpr int LDP = BT + 4;        // a row of P or dS in shared memory
constexpr int STAGES = 2;
constexpr int PREP_THREADS = 256;
constexpr float INV_LOG2E = 0.6931471805599453f;

// The prep pass. delta[(b * heads + h) * s_pad + r] = rowsum over head h of
// do * o, 0 on the query tiles wholly past the prefix; qs = q qscale (rows of
// heads * HD); one warp per (row, head), grid (B * s_pad * heads / 8).
// Block 0 also writes order: the images by decreasing valid_len, ties by
// index, the order in which attention_bwd_kernel takes them (in index
// order when ATTN_BWD_IN_ORDER is defined: scripts/bench_attention_f32.py
// times what the order is worth).
template <int HD>
__global__ void __launch_bounds__(PREP_THREADS)
attention_bwd_prep_kernel(const float* __restrict__ q, int ld, const float* __restrict__ o,
                          const float* __restrict__ dout, int ldo,
                          const int* __restrict__ valid_len, float* __restrict__ delta,
                          float* __restrict__ qs, int* __restrict__ order, int batch,
                          int heads, int s_pad, int total, float qscale) {
  if (blockIdx.x == 0)
    for (int t = threadIdx.x; t < batch; t += PREP_THREADS) {
      const int vt = valid_len[t];
      int rank = 0;
      for (int j = 0; j < batch; ++j) {
        const int vj = valid_len[j];
        rank += vj > vt || (vj == vt && j < t);
      }
#ifdef ATTN_BWD_IN_ORDER
      rank = t;
#endif
      order[rank] = t;
    }
  const int item = blockIdx.x * (PREP_THREADS / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (item >= total) return;  // whole warps leave; there is no barrier
  const int h = item % heads, row = item / heads, b = row / s_pad;
  const int r = row - b * s_pad;
  float s = 0.f;
  if (r / BT * BT < valid_len[b]) {  // a query tile the forward computed
    const size_t off = (size_t)row * ldo + h * HD;
#pragma unroll
    for (int j = 0; j < HD / 32; ++j)
      s += dout[off + lane + 32 * j] * o[off + lane + 32 * j];
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) delta[((size_t)b * heads + h) * s_pad + r] = s;
  const float* qr = q + (size_t)row * ld + h * HD;
  float* qsr = qs + (size_t)row * heads * HD + h * HD;
#pragma unroll
  for (int j = 0; j < HD / 32; ++j) qsr[lane + 32 * j] = qr[lane + 32 * j] * qscale;
}

// BT rows of a head, of row stride ld, set to zero
template <int HD>
__device__ __forceinline__ void zero_rows(float* dst, int ld) {
  constexpr int V4 = HD / 4;
  for (int c = threadIdx.x; c < BT * V4; c += THREADS)
    *reinterpret_cast<float4*>(dst + (size_t)(c / V4) * ld + c % V4 * 4) =
        make_float4(0.f, 0.f, 0.f, 0.f);
}

// Warp w < 4 hands the P it wrote to warp w + 4 through named barrier 1 + w
// of the two warps (64 threads): bar.arrive on one side, bar.sync on the other.
__device__ __forceinline__ void pair_arrive(int pair) {
  asm volatile("bar.arrive %0, 64;\n" ::"r"(pair + 1) : "memory");
}
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(pair + 1) : "memory");
}

// A block's item: (image, head, first row of its tile).
struct Item {
  int b, h, t0;
};

// the thread's 4 rows x HD / 8 head columns of acc times mul into dst (rows of ld)
template <int HD>
__device__ __forceinline__ void store_rows(float* dst, int ld, int r, int c,
                                           const float (&acc)[4][HD / 8], float mul) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < HD / 32; ++jj)
      *reinterpret_cast<float4*>(dst + (size_t)(r + i) * ld + 4 * c + 32 * jj) =
          make_float4(acc[i][4 * jj] * mul, acc[i][4 * jj + 1] * mul, acc[i][4 * jj + 2] * mul,
                      acc[i][4 * jj + 3] * mul);
}

// dk and dv of BT keys of one head.
// Shared memory: K, V (resident), then the ring's STAGES slots of (qs, dO,
// lse, delta) of a query tile, then P and dS (queries x keys).
template <int HD>
constexpr int DKDV_STAGE = 2 * TILE_F<HD> + 2 * BT;
template <int HD>
constexpr int DKDV_SMEM =
    (2 * TILE_F<HD> + STAGES * DKDV_STAGE<HD> + 2 * BT * LDP) * (int)sizeof(float);

template <int HD>
__device__ __forceinline__ void dkdv_block(Item it, float* smem, const float* __restrict__ qs,
                                           const float* __restrict__ k,
                                           const float* __restrict__ v, int ld,
                                           const float* __restrict__ dout, int ldo,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta, int vl,
                                           float* __restrict__ dk, float* __restrict__ dv,
                                           int ldg, int heads, int s_pad) {
  constexpr int TF = TILE_F<HD>, STAGE = DKDV_STAGE<HD>;
  const int b = it.b, h = it.h, k0 = it.t0;
  const size_t row0 = (size_t)b * s_pad;
  float* dkb = dk + (row0 + k0) * ldg + h * HD;
  float* dvb = dv + (row0 + k0) * ldg + h * HD;
  if (k0 >= vl) {  // uniform across the block, before any barrier
    zero_rows<HD>(dkb, ldg);
    zero_rows<HD>(dvb, ldg);
    return;
  }
  float* Ks = smem;
  float* Vs = Ks + TF;
  float* ring = Vs + TF;
  float* Ps = ring + STAGES * STAGE;  // P[query][key]
  float* dSs = Ps + BT * LDP;         // dS[query][key]
  const int ldq = heads * HD;
  const float* lse_h = lse + ((size_t)b * heads + h) * s_pad;
  const float* delta_h = delta + ((size_t)b * heads + h) * s_pad;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // warp w < 4: S, P, dV; warp w + 4: dP, dS, dK; of keys kr .. kr + 3 (and in
  // the scores, of queries qg + 8 j; in dV and dK, of head columns 4 qg + 32 jj
  // + {0..3})
  const int role = warp >> 2, pair = warp & 3;
  const int kr = 16 * pair + 4 * (lane >> 3), qg = lane & 7;

  copy_tile<THREADS, HD>(Ks, k + (row0 + k0) * ld + h * HD, ld);  // with query tile 0's copies
  copy_tile<THREADS, HD>(Vs, v + (row0 + k0) * ld + h * HD, ld);
  auto load = [&](int s, int slot) {
    float* st = ring + slot * STAGE;
    copy_tile<THREADS, HD>(st, qs + (row0 + s * BT) * ldq + h * HD, ldq);
    copy_tile<THREADS, HD>(st + TF, dout + (row0 + s * BT) * ldo + h * HD, ldo);
    if (tid < 2 * BT / 4)  // 64 lse, then 64 delta
      sgemm::cp_async_16(st + 2 * TF + 4 * tid,
                         (tid < BT / 4 ? lse_h : delta_h - BT) + s * BT + 4 * tid);
  };
  float acc[4][HD / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) acc[i][j] = 0.f;

  // every query tile the forward computed, all 64 rows of it
  sgemm::ring<STAGES>((vl + BT - 1) / BT, load, [&](int, int slot) {
    const float* st = ring + slot * STAGE;
    const float* lse_s = st + 2 * TF;
    const float* delta_s = lse_s + BT;
    // S^T = K qs^T (role 0) or dP^T = V dO^T (role 1), keys x queries
    float sc[4][8];
    scores<HD>(sc, role == 0 ? Ks : Vs, kr, st + role * TF, qg);
    if (role == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qc = qg + 8 * j;
        const float l = lse_s[qc];
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = k0 + kr + i < vl ? exp2f(sc[i][j] - l) : 0.f;
        *reinterpret_cast<float4*>(Ps + qc * LDP + kr) = make_float4(p[0], p[1], p[2], p[3]);
      }
      pair_arrive(pair);  // warp pair + 4 may read them
      __syncwarp();
      second_product<LDP, HD>(acc, Ps, kr, st + TF, qg);  // dV += P^T dO
    } else {
      pair_sync(pair);  // P of these keys is in place
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qc = qg + 8 * j;
        const float dl = delta_s[qc];
        const float4 p = load4(Ps + qc * LDP + kr);
        *reinterpret_cast<float4*>(dSs + qc * LDP + kr) =
            make_float4(p.x * (sc[0][j] - dl), p.y * (sc[1][j] - dl), p.z * (sc[2][j] - dl),
                        p.w * (sc[3][j] - dl));
      }
      __syncwarp();
      second_product<LDP, HD>(acc, dSs, kr, st, qg);  // dK += dS^T qs
    }
  });
  if (role == 0) store_rows<HD>(dvb, ldg, kr, qg, acc, 1.f);
  else store_rows<HD>(dkb, ldg, kr, qg, acc, INV_LOG2E);
}

// dq of BT queries of one head.
// Shared memory: qs, dO, lse, delta (resident), then the ring's STAGES slots
// of (K, V) of a key tile, then P and dS (keys x queries).
template <int HD>
constexpr int DQ_STAGE = 2 * TILE_F<HD>;
template <int HD>
constexpr int DQ_SMEM =
    (2 * TILE_F<HD> + 2 * BT + STAGES * DQ_STAGE<HD> + 2 * BT * LDP) * (int)sizeof(float);

template <int HD>
__device__ __forceinline__ void dq_block(Item it, float* smem, const float* __restrict__ qs,
                                         const float* __restrict__ k,
                                         const float* __restrict__ v, int ld,
                                         const float* __restrict__ dout, int ldo,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta, int vl,
                                         float* __restrict__ dq, int ldg, int heads, int s_pad,
                                         float scale) {
  constexpr int TF = TILE_F<HD>, STAGE = DQ_STAGE<HD>;
  const int b = it.b, h = it.h, q0 = it.t0;
  const size_t row0 = (size_t)b * s_pad;
  float* dqb = dq + (row0 + q0) * ldg + h * HD;
  if (q0 >= vl) {  // uniform across the block, before any barrier
    zero_rows<HD>(dqb, ldg);
    return;
  }
  float* Qs = smem;
  float* dOs = Qs + TF;
  float* lse_s = dOs + TF;
  float* delta_s = lse_s + BT;
  float* ring = delta_s + BT;
  float* Ps = ring + STAGES * STAGE;  // P[key][query]
  float* dSs = Ps + BT * LDP;         // dS[key][query]
  const int ldq = heads * HD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // warp w < 4: S, P; warp w + 4: dP, dS, dq; of queries qr .. qr + 3 (and in
  // the scores, of keys kg + 8 j; in dq, of head columns 4 kg + 32 jj + {0..3})
  const int role = warp >> 2, pair = warp & 3;
  const int qr = 16 * pair + 4 * (lane >> 3), kg = lane & 7;

  // the block's qs, dO, lse and delta, with key tile 0's copies
  copy_tile<THREADS, HD>(Qs, qs + (row0 + q0) * ldq + h * HD, ldq);
  copy_tile<THREADS, HD>(dOs, dout + (row0 + q0) * ldo + h * HD, ldo);
  if (tid < 2 * BT / 4)
    sgemm::cp_async_16(lse_s + 4 * tid,
                       (tid < BT / 4 ? lse : delta - BT) + ((size_t)b * heads + h) * s_pad + q0 +
                           4 * tid);
  auto load = [&](int s, int slot) {
    float* st = ring + slot * STAGE;
    copy_tile<THREADS, HD>(st, k + (row0 + s * BT) * ld + h * HD, ld);
    copy_tile<THREADS, HD>(st + TF, v + (row0 + s * BT) * ld + h * HD, ld);
  };
  float acc[4][HD / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) acc[i][j] = 0.f;

  // every key tile below valid_len
  sgemm::ring<STAGES>((vl + BT - 1) / BT, load, [&](int s, int slot) {
    const float* st = ring + slot * STAGE;
    const int k0 = s * BT;
    // S = qs K^T (role 0) or dP = dO V^T (role 1), queries x keys
    float sc[4][8];
    scores<HD>(sc, role == 0 ? Qs : dOs, qr, st + role * TF, kg);
    if (role == 0) {
      float l[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) l[i] = lse_s[qr + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kc = kg + 8 * j;
        const bool ok = k0 + kc < vl;
        *reinterpret_cast<float4*>(Ps + kc * LDP + qr) =
            make_float4(ok ? exp2f(sc[0][j] - l[0]) : 0.f, ok ? exp2f(sc[1][j] - l[1]) : 0.f,
                        ok ? exp2f(sc[2][j] - l[2]) : 0.f, ok ? exp2f(sc[3][j] - l[3]) : 0.f);
      }
      pair_arrive(pair);  // warp pair + 4 may read them
    } else {
      float dl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dl[i] = delta_s[qr + i];
      pair_sync(pair);  // P of these queries is in place
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kc = kg + 8 * j;
        const float4 p = load4(Ps + kc * LDP + qr);
        *reinterpret_cast<float4*>(dSs + kc * LDP + qr) =
            make_float4(p.x * (sc[0][j] - dl[0]), p.y * (sc[1][j] - dl[1]),
                        p.z * (sc[2][j] - dl[2]), p.w * (sc[3][j] - dl[3]));
      }
      __syncwarp();
      second_product<LDP, HD>(acc, dSs, qr, st, kg);  // dq += dS K
    }
  });
  if (role == 1) store_rows<HD>(dqb, ldg, qr, kg, acc, scale);
}

// ---- head 64: the five products on the tensor cores, in 3xTF32 ------------
// At HD 64 the products above run on the CUDA cores' own ceiling: the kernel
// does 14 vl^2 hd FMAs for the 10 the function needs, a thread's 4 x 8 score
// tiles read 0.094 float4 a FMA, and a share of 59 % of the FMA pipe holds it
// at 42 % of its bound. The blocks below keep the kernel's design (the prep
// pass, the items longest first, dk/dv and dq in blocks of their own, the
// ring of walked tiles, warp w < 4 handing P to warp w + 4 through a named
// barrier, the masks and the zero tiles) and form S, dP, dV, dK and dq on the
// tensor cores (attention_f32.cuh: scores_tf32, second_tf32), every operand
// split into two TF32 values and each product three TF32 products into a
// float32 sum (mma_tf32.cuh), so the error stays float32's. A warp owns 16
// rows of the block's 64 (keys in dkdv, queries in dq) against the tile's
// 64, in eight m16n8k8 C fragments; dS = P (dP - delta) is formed on the
// CUDA cores in the C fragments of dP, which then serve as the A fragments
// of dK += dS^T qs (or dq += dS K) with no trip through shared memory: the
// fragment's columns 2 t, 2 t + 1 take the places of A's t, t + 4, and the
// B tile is read at the same permuted rows. P goes from warp w to warp w + 4
// in fragment order (a float a lane, 32 consecutive floats a register), so
// neither side's shared accesses conflict. In dq the dS fragments go back
// from warp w + 4 to warp w the same way, and each of the two warps sums
// half of dq's 64 head columns, so that the two share the dq block's three
// products a tile evenly, as they share dkdv's four.
constexpr int FRAG_F = 4 * 8 * 4 * 32;  // a 64 x 64 tile in C fragments: 4 pairs, 8 x 4 x 32

// register r of C fragment j of a warp's 16 x 64 tile in its pair's part of a
// fragment buffer, at lane 0 (a lane adds its index)
__device__ __forceinline__ int frag_at(int pair, int j, int r) {
  return ((pair * 8 + j) * 4 + r) * 32;
}

// the C fragments of a warp's 16 x 64 tile into (or out of) its pair's part of buf
__device__ __forceinline__ void put_frags(float* buf, int pair, int lane, const float (&c)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) buf[frag_at(pair, j, r) + lane] = c[j][r];
}
__device__ __forceinline__ void get_frags(float (&c)[8][4], const float* buf, int pair, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) c[j][r] = buf[frag_at(pair, j, r) + lane];
}

// Warp w + 4 hands dS to warp w through named barrier 5 + w (dq): the
// direction opposite to pair_arrive / pair_sync's.
__device__ __forceinline__ void back_arrive(int pair) {
  asm volatile("bar.arrive %0, 64;\n" ::"r"(pair + 5) : "memory");
}
__device__ __forceinline__ void back_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(pair + 5) : "memory");
}

// a warp's NT x 8 head columns from column 8 n0, rows r0 + g and r0 + g + 8
// (C fragments), times mul into dst (rows of ld)
template <int NT>
__device__ __forceinline__ void store_frags(float* dst, int ld, int r0, int n0, int lane,
                                            const float (&acc)[NT][4], float mul) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(dst + (size_t)(r0 + g + 8 * h) * ld + 8 * (n0 + j) + 2 * t) =
          make_float2(acc[j][2 * h] * mul, acc[j][2 * h + 1] * mul);
}

template <int HD>
constexpr int DKDV_TC_SMEM =
    (2 * TILE_F<HD> + STAGES * DKDV_STAGE<HD> + FRAG_F) * (int)sizeof(float);
template <int HD>
constexpr int DQ_TC_SMEM =
    (2 * TILE_F<HD> + 2 * BT + STAGES * DQ_STAGE<HD> + FRAG_F) * (int)sizeof(float);

// dk and dv of BT keys of one head, on the tensor cores. Shared memory: K, V
// (resident), the ring's STAGES slots of (qs, dO, lse, delta) of a query
// tile, then P in fragments. Warp w < 4: S^T = K qs^T, P, dV += P^T dO; warp
// w + 4: dP^T = V dO^T, dS, dK += dS^T qs; of keys 16 (w % 4) .. + 16.
template <int HD>
__device__ __forceinline__ void dkdv_block_tc(Item it, float* smem, const float* __restrict__ qs,
                                              const float* __restrict__ k,
                                              const float* __restrict__ v, int ld,
                                              const float* __restrict__ dout, int ldo,
                                              const float* __restrict__ lse,
                                              const float* __restrict__ delta, int vl,
                                              float* __restrict__ dk, float* __restrict__ dv,
                                              int ldg, int heads, int s_pad) {
  constexpr int TF = TILE_F<HD>, STAGE = DKDV_STAGE<HD>;
  const int b = it.b, h = it.h, k0 = it.t0;
  const size_t row0 = (size_t)b * s_pad;
  float* dkb = dk + (row0 + k0) * ldg + h * HD;
  float* dvb = dv + (row0 + k0) * ldg + h * HD;
  if (k0 >= vl) {  // uniform across the block, before any barrier
    zero_rows<HD>(dkb, ldg);
    zero_rows<HD>(dvb, ldg);
    return;
  }
  float* Ks = smem;
  float* Vs = Ks + TF;
  float* ring = Vs + TF;
  float* Pf = ring + STAGES * STAGE;  // P in C fragments
  const int ldq = heads * HD;
  const float* lse_h = lse + ((size_t)b * heads + h) * s_pad;
  const float* delta_h = delta + ((size_t)b * heads + h) * s_pad;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int role = warp >> 2, pair = warp & 3, r0 = 16 * pair;
  const int g = lane >> 2, t = lane & 3;
  const bool key_ok = k0 + r0 + g < vl, key8_ok = k0 + r0 + g + 8 < vl;

  copy_tile<THREADS, HD>(Ks, k + (row0 + k0) * ld + h * HD, ld);  // with query tile 0's copies
  copy_tile<THREADS, HD>(Vs, v + (row0 + k0) * ld + h * HD, ld);
  auto load = [&](int s, int slot) {
    float* st = ring + slot * STAGE;
    copy_tile<THREADS, HD>(st, qs + (row0 + s * BT) * ldq + h * HD, ldq);
    copy_tile<THREADS, HD>(st + TF, dout + (row0 + s * BT) * ldo + h * HD, ldo);
    if (tid < 2 * BT / 4)  // 64 lse, then 64 delta
      sgemm::cp_async_16(st + 2 * TF + 4 * tid,
                         (tid < BT / 4 ? lse_h : delta_h - BT) + s * BT + 4 * tid);
  };
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;

  // every query tile the forward computed, all 64 rows of it
  sgemm::ring<STAGES>((vl + BT - 1) / BT, load, [&](int, int slot) {
    const float* st = ring + slot * STAGE;
    const float* lse_s = st + 2 * TF;
    const float* delta_s = lse_s + BT;
    // S^T = K qs^T (role 0) or dP^T = V dO^T (role 1), keys x queries
    float sc[8][4];
    scores_tf32<HD>(sc, role == 0 ? Ks : Vs, r0, st + role * TF, lane);
    if (role == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // queries 8 j + 2 t, 8 j + 2 t + 1
        const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
        sc[j][0] = key_ok ? exp2f(sc[j][0] - l.x) : 0.f;
        sc[j][1] = key_ok ? exp2f(sc[j][1] - l.y) : 0.f;
        sc[j][2] = key8_ok ? exp2f(sc[j][2] - l.x) : 0.f;
        sc[j][3] = key8_ok ? exp2f(sc[j][3] - l.y) : 0.f;
      }
      put_frags(Pf, pair, lane, sc);
      pair_arrive(pair);  // warp pair + 4 may read them
      second_tf32<HD, HD / 8>(acc, sc, st + TF, 0, lane);  // dV += P^T dO
    } else {
      pair_sync(pair);  // P of these keys is in place
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * t);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          sc[j][r] = Pf[frag_at(pair, j, r) + lane] * (sc[j][r] - (r & 1 ? dl.y : dl.x));
      }
      second_tf32<HD, HD / 8>(acc, sc, st, 0, lane);  // dK += dS^T qs
    }
  });
  if (role == 0) store_frags<HD / 8>(dvb, ldg, r0, 0, lane, acc, 1.f);
  else store_frags<HD / 8>(dkb, ldg, r0, 0, lane, acc, INV_LOG2E);
}

// dq of BT queries of one head, on the tensor cores. Shared memory: qs, dO,
// lse, delta (resident), the ring's STAGES slots of (K, V) of a key tile,
// then P in fragments, which warp w + 4 overwrites with dS (each lane its own
// entries). Warp w < 4: S = qs K^T, P, then dq's head columns 0 .. HD / 2
// from the dS that warp w + 4 hands back; warp w + 4: dP = dO V^T, dS, dq's
// columns HD / 2 .. HD; of queries 16 (w % 4) .. + 16.
template <int HD>
__device__ __forceinline__ void dq_block_tc(Item it, float* smem, const float* __restrict__ qs,
                                            const float* __restrict__ k,
                                            const float* __restrict__ v, int ld,
                                            const float* __restrict__ dout, int ldo,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ delta, int vl,
                                            float* __restrict__ dq, int ldg, int heads, int s_pad,
                                            float scale) {
  constexpr int TF = TILE_F<HD>, STAGE = DQ_STAGE<HD>, NT = HD / 16;
  const int b = it.b, h = it.h, q0 = it.t0;
  const size_t row0 = (size_t)b * s_pad;
  float* dqb = dq + (row0 + q0) * ldg + h * HD;
  if (q0 >= vl) {  // uniform across the block, before any barrier
    zero_rows<HD>(dqb, ldg);
    return;
  }
  float* Qs = smem;
  float* dOs = Qs + TF;
  float* lse_s = dOs + TF;
  float* delta_s = lse_s + BT;
  float* ring = delta_s + BT;
  float* Pf = ring + STAGES * STAGE;  // P, then dS, in C fragments
  const int ldq = heads * HD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int role = warp >> 2, pair = warp & 3, r0 = 16 * pair;
  const int g = lane >> 2, t = lane & 3;

  // the block's qs, dO, lse and delta, with key tile 0's copies
  copy_tile<THREADS, HD>(Qs, qs + (row0 + q0) * ldq + h * HD, ldq);
  copy_tile<THREADS, HD>(dOs, dout + (row0 + q0) * ldo + h * HD, ldo);
  if (tid < 2 * BT / 4)
    sgemm::cp_async_16(lse_s + 4 * tid,
                       (tid < BT / 4 ? lse : delta - BT) + ((size_t)b * heads + h) * s_pad + q0 +
                           4 * tid);
  auto load = [&](int s, int slot) {
    float* st = ring + slot * STAGE;
    copy_tile<THREADS, HD>(st, k + (row0 + s * BT) * ld + h * HD, ld);
    copy_tile<THREADS, HD>(st + TF, v + (row0 + s * BT) * ld + h * HD, ld);
  };
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;

  // every key tile below valid_len
  sgemm::ring<STAGES>((vl + BT - 1) / BT, load, [&](int s, int slot) {
    const float* st = ring + slot * STAGE;
    const int k0 = s * BT;
    // S = qs K^T (role 0) or dP = dO V^T (role 1), queries x keys
    float sc[8][4];
    scores_tf32<HD>(sc, role == 0 ? Qs : dOs, r0, st + role * TF, lane);
    if (role == 0) {
      const float l0 = lse_s[r0 + g], l8 = lse_s[r0 + g + 8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // keys k0 + 8 j + 2 t, k0 + 8 j + 2 t + 1
        const bool ok = k0 + 8 * j + 2 * t < vl, ok1 = k0 + 8 * j + 2 * t + 1 < vl;
        sc[j][0] = ok ? exp2f(sc[j][0] - l0) : 0.f;
        sc[j][1] = ok1 ? exp2f(sc[j][1] - l0) : 0.f;
        sc[j][2] = ok ? exp2f(sc[j][2] - l8) : 0.f;
        sc[j][3] = ok1 ? exp2f(sc[j][3] - l8) : 0.f;
      }
      put_frags(Pf, pair, lane, sc);
      pair_arrive(pair);  // warp pair + 4 may read them
      back_sync(pair);    // and hands dS back in their place
      get_frags(sc, Pf, pair, lane);
      second_tf32<HD, NT>(acc, sc, st, 0, lane);  // dq += dS K, columns 0 .. HD / 2
    } else {
      const float d0 = delta_s[r0 + g], d8 = delta_s[r0 + g + 8];
      pair_sync(pair);  // P of these queries is in place
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          sc[j][r] = Pf[frag_at(pair, j, r) + lane] * (sc[j][r] - (r < 2 ? d0 : d8));
      put_frags(Pf, pair, lane, sc);
      back_arrive(pair);  // warp pair may read them
      second_tf32<HD, NT>(acc, sc, st, NT, lane);  // dq += dS K, columns HD / 2 .. HD
    }
  });
  store_frags<NT>(dqb, ldg, r0, role * NT, lane, acc, scale);
}

// dk/dv and dq in one launch, so that each fills the other's tail: blocks
// 2 i and 2 i + 1 take the dk/dv and the dq of item i of the longest-first
// order (image, head, tile). Grid (2 * batch * heads * s_pad / BT).
template <int HD>
constexpr int BWD_SMEM = HD == 64 ? (DKDV_TC_SMEM<HD> > DQ_TC_SMEM<HD> ? DKDV_TC_SMEM<HD>
                                                                      : DQ_TC_SMEM<HD>)
                                  : (DKDV_SMEM<HD> > DQ_SMEM<HD> ? DKDV_SMEM<HD> : DQ_SMEM<HD>);

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
attention_bwd_kernel(const float* __restrict__ qs, const float* __restrict__ k,
                     const float* __restrict__ v, int ld, const float* __restrict__ dout,
                     int ldo, const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ valid_len, const int* __restrict__ order,
                     float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                     int ldg, int heads, int s_pad, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int nt = s_pad / BT, per_image = heads * nt, item = blockIdx.x / 2;
  const Item it = {order[item / per_image], item % per_image / nt, item % nt * BT};
  const int vl = min(max(valid_len[it.b], 0), s_pad);
  if constexpr (HD == 64) {  // the tensor cores
    if (blockIdx.x % 2 == 0)
      dkdv_block_tc<HD>(it, smem, qs, k, v, ld, dout, ldo, lse, delta, vl, dk, dv, ldg, heads,
                        s_pad);
    else
      dq_block_tc<HD>(it, smem, qs, k, v, ld, dout, ldo, lse, delta, vl, dq, ldg, heads, s_pad,
                      scale);
  } else {
    if (blockIdx.x % 2 == 0)
      dkdv_block<HD>(it, smem, qs, k, v, ld, dout, ldo, lse, delta, vl, dk, dv, ldg, heads,
                     s_pad);
    else
      dq_block<HD>(it, smem, qs, k, v, ld, dout, ldo, lse, delta, vl, dq, ldg, heads, s_pad,
                   scale);
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, int ld, const float* o, const float* dout,
           int ldo, const float* lse, float* delta, const int* valid_len, float* dq,
           float* dk, float* dv, int ldg, int batch, int heads, int s_pad, float qscale,
           float scale, cudaStream_t st) {
  const int total = batch * s_pad * heads;
  float* qs = delta + (size_t)total;
  int* order = reinterpret_cast<int*>(qs + (size_t)total * HD);
  attention_bwd_prep_kernel<HD><<<(total + PREP_THREADS / 32 - 1) / (PREP_THREADS / 32),
                                  PREP_THREADS, 0, st>>>(q, ld, o, dout, ldo, valid_len, delta,
                                                         qs, order, batch, heads, s_pad, total,
                                                         qscale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(attention_bwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           BWD_SMEM<HD>);
  if (e != cudaSuccess) return (int)e;
  attention_bwd_kernel<HD><<<2 * batch * heads * (s_pad / BT), THREADS, BWD_SMEM<HD>, st>>>(
      qs, k, v, ld, dout, ldo, lse, delta, valid_len, order, dq, dk, dv, ldg, heads, s_pad,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v: (batch * s_pad) rows of ld elements (they may be column slices of
// one packed qkv buffer); o (the forward's output) and dout: rows of ldo
// elements; lse: (batch, heads, s_pad) f32, the forward's base-2 lse; delta:
// scratch of batch * heads * s_pad f32 (delta), followed by batch * s_pad *
// heads * head_dim f32 (the scaled q) and batch int32 (the images' order). dq, dk,
// dv: rows of ldg elements (they may be column slices of one packed dqkv
// buffer). head_dim is 32, 64 or 96 (any other is refused); ld, ldo and ldg are
// multiples of 4 and every pointer, delta included, is 16-byte aligned (the
// 16-byte copies). qscale = log2(e) / sqrt(head_dim), scale = 1 /
// sqrt(head_dim). Two launches: the prep pass, then dk/dv and dq in one.
int prefix_attention_bwd(const float* q, const float* k, const float* v, int ld,
                         const float* o, const float* dout, int ldo,
                         const float* lse, float* delta, const int* valid_len,
                         float* dq, float* dk, float* dv, int ldg, int batch,
                         int heads, int head_dim, int s_pad, float qscale,
                         float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || !built_head_dim(head_dim) || s_pad <= 0 || s_pad % BT != 0 ||
      ld % 4 != 0 || ldo % 4 != 0 || ldg % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 32)
    return launch<32>(q, k, v, ld, o, dout, ldo, lse, delta, valid_len, dq, dk, dv, ldg, batch,
                      heads, s_pad, qscale, scale, st);
  return head_dim == 64 ? launch<64>(q, k, v, ld, o, dout, ldo, lse, delta, valid_len, dq, dk,
                                     dv, ldg, batch, heads, s_pad, qscale, scale, st)
                        : launch<96>(q, k, v, ld, o, dout, ldo, lse, delta, valid_len, dq, dk,
                                     dv, ldg, batch, heads, s_pad, qscale, scale, st);
}

}  // extern "C"
