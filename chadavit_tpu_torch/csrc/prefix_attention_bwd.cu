// Prefix-masked multi-head attention, backward, on CUDA cores, in float32. The
// bf16 instance is a tensor-core kernel of its own (prefix_attention_bf16.cu).
//
// Replaces the TPU kernel chadavit_tpu/ops/flash_attention.py::_bwd_kernel
// (reached through _vjp_bwd, the custom VJP of prefix_flash_attention), and the
// attention phase C' of chadavit_tpu/ops/fused_block.py::_bwd_kernel. Key j of
// image b is valid iff j < valid_len[b].
//
// The formulation is the TPU kernel's: the forward's base-2 lse makes the
// softmax exact without a running max, and per query row
//   delta = rowsum(do * o)                       (one small pass, delta_kernel)
//   p     = exp2(q k^T scale log2(e) - lse)
//   dv    = p^T do,  dp = do v^T,  ds = p (dp - delta)
//   dk    = ds^T q scale,  dq = ds k scale
// The scale and log2(e) are folded into q as it is staged, so dk carries a
// 1/log2(e) fix at write-out and dq the plain scale.
//
// What bounds it on an H100: per (image, head) it does 10 * vl^2 * hd
// operations (the scores twice, dp twice, dv, dk, dq), so it is bound by
// operations (67 TFLOP/s of f32 FMA). The TPU kernel recomputes the scores once
// per key block for all queries and sums dq in one VMEM scratch across its
// sequential key loop. Blocks on Hopper run in no order, so dq is not summed
// across blocks: a second kernel (dq_kernel) owns 64 queries and walks the key
// blocks itself, recomputing the scores once more. Every sum then has one
// owner and a fixed order, and the result is the same from run to run; the
// price is the second score recompute (2 of the 10 vl^2 hd terms).
//
// dkdv_kernel: a block owns BKV = 64 keys of one head and walks the query
// tiles below valid_len[b]; dq_kernel: a block owns BQ = 64 queries and walks
// the key tiles below valid_len[b]. The contract is the TPU kernel's: the
// forward (prefix_attention.cu) computes every query of a 64-row tile that
// holds a valid query for real, also those past valid_len, so the backward is
// exact for any cotangent on them: every query row of such a tile takes part,
// with the forward's lse. Tiles wholly past the prefix were zero-filled (lse
// 1e30): they give nothing, and a block that owns one writes zeros and returns
// (dq 0 there). Keys at or past valid_len stay masked (p = 0), so their dk and
// dv are exact zeros. Every such decision is uniform per block and taken
// before the first barrier.
//
// q, k, v, o, do and the gradients are float32, so nothing rounds where the
// JAX body (dtype-generic, flash_attention.py:157-230) casts to the input
// dtype.

#include <math.h>

#include "storage.cuh"

namespace {

constexpr int BT = 64;    // query and key tile
constexpr int NT = 256;   // threads, as a 16 x 16 grid
constexpr int HEAD_DIM = 96;  // ChAdaViT-moyen: D 192, 2 heads; other widths are refused
constexpr int LD = HEAD_DIM + 1;  // shared-memory row stride of a head tile
constexpr int TN = HEAD_DIM / 16;  // head columns per thread
constexpr float INV_LOG2E = 0.6931471805599453f;

// delta[(b * heads + h) * s_pad + r] = rowsum over head h of do * o, 0 on the
// query tiles wholly past the prefix. One warp per (row, head); grid
// (B * s_pad * heads / 8).
__global__ void __launch_bounds__(NT)
delta_kernel(const float* __restrict__ o, const float* __restrict__ dout, int ldo,
             const int* __restrict__ valid_len, float* __restrict__ delta,
             int heads, int s_pad, int total) {
  const int item = blockIdx.x * (NT / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (item >= total) return;  // whole warps leave; there is no barrier
  const int h = item % heads, row = item / heads, b = row / s_pad;
  const int r = row - b * s_pad;
  float s = 0.f;
  if (r / BT * BT < valid_len[b]) {  // a query tile the forward computed
    const size_t off = (size_t)row * ldo + h * HEAD_DIM;
#pragma unroll
    for (int j = 0; j < HEAD_DIM / 32; ++j)
      s += dout[off + lane + 32 * j] * o[off + lane + 32 * j];
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) delta[((size_t)b * heads + h) * s_pad + r] = s;
}

// Stage BT rows x HEAD_DIM of a head (rows of ld elements from row0) into a
// (BT, LD) shared tile, times mul (the scaled q; 1 for the others).
__device__ __forceinline__ void stage(const float* __restrict__ src, int ld,
                                      size_t row0, int col0, float* dst,
                                      float mul) {
  constexpr int V4 = HEAD_DIM / 4;
  for (int idx = threadIdx.x; idx < BT * V4; idx += NT) {
    const int r = idx / V4, c = (idx % V4) * 4;
    const float4 t = load4(src + (row0 + r) * ld + col0 + c);
    float* d = dst + r * LD + c;
    d[0] = t.x * mul;
    d[1] = t.y * mul;
    d[2] = t.z * mul;
    d[3] = t.w * mul;
  }
}

// sa[i][j] = A[4 ty + i] . B[tx + 16 j] and sb[i][j] = C[4 ty + i] . E[tx + 16 j]
// over the head dim, A/B/C/E (BT, LD) shared tiles.
__device__ __forceinline__ void two_score_tiles(const float* A, const float* Bm,
                                                const float* C, const float* E,
                                                float sa[4][4], float sb[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sa[i][j] = sb[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HEAD_DIM; ++d) {
    float a[4], bb[4], c[4], e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = A[(4 * ty + i) * LD + d];
      c[i] = C[(4 * ty + i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bb[j] = Bm[(tx + 16 * j) * LD + d];
      e[j] = E[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sa[i][j] = fmaf(a[i], bb[j], sa[i][j]);
        sb[i][j] = fmaf(c[i], e[j], sb[i][j]);
      }
  }
}

// dk and dv of BT keys of one head. Grid (s_pad / BT, heads, B).
__global__ void __launch_bounds__(NT)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, int ld, const float* __restrict__ dout,
            int ldo, const float* __restrict__ lse, const float* __restrict__ delta,
            const int* __restrict__ valid_len, float* __restrict__ dk,
            float* __restrict__ dv, int ldg, int s_pad, float qscale) {
  const int k0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int heads = gridDim.y;
  const int vl = min(max(valid_len[b], 0), s_pad);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t row0 = (size_t)b * s_pad;
  float* dkb = dk + (row0 + k0) * ldg + h * HEAD_DIM;
  float* dvb = dv + (row0 + k0) * ldg + h * HEAD_DIM;
  if (k0 >= vl) {  // uniform across the block, before any barrier
    for (int idx = tid; idx < BT * HEAD_DIM; idx += NT) {
      dkb[(size_t)(idx / HEAD_DIM) * ldg + idx % HEAD_DIM] = 0.f;
      dvb[(size_t)(idx / HEAD_DIM) * ldg + idx % HEAD_DIM] = 0.f;
    }
    return;
  }
  extern __shared__ float smem[];
  float* Ks = smem;            // BT x LD
  float* Vs = Ks + BT * LD;    // BT x LD
  float* Qs = Vs + BT * LD;    // BT x LD, pre-scaled
  float* dOs = Qs + BT * LD;   // BT x LD
  float* Ps = dOs + BT * LD;   // BT x (BT + 1): p^T, keys x queries
  float* dSs = Ps + BT * (BT + 1);  // ds^T
  float* lse_s = dSs + BT * (BT + 1);
  float* delta_s = lse_s + BT;
  const float* lse_h = lse + ((size_t)b * heads + h) * s_pad;
  const float* delta_h = delta + ((size_t)b * heads + h) * s_pad;

  stage(k, ld, row0 + k0, h * HEAD_DIM, Ks, 1.f);
  stage(v, ld, row0 + k0, h * HEAD_DIM, Vs, 1.f);
  float acc_k[4][TN], acc_v[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // every query tile the forward computed, all 64 rows of it
  for (int q0 = 0; q0 < vl; q0 += BT) {  // vl is uniform: barriers are safe
    __syncthreads();  // the previous tile's Qs/dOs/Ps/dSs are no longer read
    stage(q, ld, row0 + q0, h * HEAD_DIM, Qs, qscale);
    stage(dout, ldo, row0 + q0, h * HEAD_DIM, dOs, 1.f);
    if (tid < BT) {
      lse_s[tid] = lse_h[q0 + tid];
      delta_s[tid] = delta_h[q0 + tid];
    }
    __syncthreads();
    // s^T[key][query] = k . q_scaled, dp^T[key][query] = v . do
    float s[4][4], dp[4][4];
    two_score_tiles(Ks, Qs, Vs, dOs, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kr = 4 * ty + i, qc = tx + 16 * j;
        const float p = k0 + kr < vl ? exp2f(s[i][j] - lse_s[qc]) : 0.f;
        Ps[kr * (BT + 1) + qc] = p;
        dSs[kr * (BT + 1) + qc] = p * (dp[i][j] - delta_s[qc]);
      }
    __syncthreads();
    // dv += p^T do, dk += ds^T q_scaled over this tile's queries
#pragma unroll 4
    for (int qq = 0; qq < BT; ++qq) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[(4 * ty + i) * (BT + 1) + qq];
        dsv[i] = dSs[(4 * ty + i) * (BT + 1) + qq];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float dov = dOs[qq * LD + tx + 16 * j];
        const float qv = Qs[qq * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_v[i][j] = fmaf(pv[i], dov, acc_v[i][j]);
          acc_k[i][j] = fmaf(dsv[i], qv, acc_k[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const size_t o = (size_t)(4 * ty + i) * ldg + tx + 16 * j;
      dkb[o] = acc_k[i][j] * INV_LOG2E;
      dvb[o] = acc_v[i][j];
    }
}

// dq of BT queries of one head. Grid (s_pad / BT, heads, B).
__global__ void __launch_bounds__(NT)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, int ld, const float* __restrict__ dout,
          int ldo, const float* __restrict__ lse, const float* __restrict__ delta,
          const int* __restrict__ valid_len, float* __restrict__ dq, int ldg,
          int s_pad, float qscale, float scale) {
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int heads = gridDim.y;
  const int vl = min(max(valid_len[b], 0), s_pad);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t row0 = (size_t)b * s_pad;
  float* dqb = dq + (row0 + q0) * ldg + h * HEAD_DIM;
  if (q0 >= vl) {  // uniform across the block, before any barrier
    for (int idx = tid; idx < BT * HEAD_DIM; idx += NT)
      dqb[(size_t)(idx / HEAD_DIM) * ldg + idx % HEAD_DIM] = 0.f;
    return;
  }
  extern __shared__ float smem[];
  float* Qs = smem;            // BT x LD, pre-scaled
  float* dOs = Qs + BT * LD;   // BT x LD
  float* Ks = dOs + BT * LD;   // BT x LD
  float* Vs = Ks + BT * LD;    // BT x LD
  float* dSs = Vs + BT * LD;   // BT x (BT + 1): ds, queries x keys
  float* lse_s = dSs + BT * (BT + 1);
  float* delta_s = lse_s + BT;
  const float* lse_h = lse + ((size_t)b * heads + h) * s_pad;
  const float* delta_h = delta + ((size_t)b * heads + h) * s_pad;

  stage(q, ld, row0 + q0, h * HEAD_DIM, Qs, qscale);
  stage(dout, ldo, row0 + q0, h * HEAD_DIM, dOs, 1.f);
  if (tid < BT) {
    lse_s[tid] = lse_h[q0 + tid];
    delta_s[tid] = delta_h[q0 + tid];
  }
  float acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < vl; k0 += BT) {  // vl is uniform: barriers are safe
    __syncthreads();  // the previous tile's Ks/Vs/dSs are no longer read
    stage(k, ld, row0 + k0, h * HEAD_DIM, Ks, 1.f);
    stage(v, ld, row0 + k0, h * HEAD_DIM, Vs, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
    two_score_tiles(Qs, Ks, dOs, Vs, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = 4 * ty + i, kc = tx + 16 * j;
        const float p = k0 + kc < vl ? exp2f(s[i][j] - lse_s[qr]) : 0.f;
        dSs[qr * (BT + 1) + kc] = p * (dp[i][j] - delta_s[qr]);
      }
    __syncthreads();
    // dq += ds k over this tile's keys
#pragma unroll 4
    for (int kk = 0; kk < BT; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(4 * ty + i) * (BT + 1) + kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float kv = Ks[kk * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      dqb[(size_t)(4 * ty + i) * ldg + tx + 16 * j] = acc[i][j] * scale;
}

constexpr int DKDV_SMEM = (4 * BT * LD + 2 * BT * (BT + 1) + 2 * BT) * (int)sizeof(float);
constexpr int DQ_SMEM = (4 * BT * LD + BT * (BT + 1) + 2 * BT) * (int)sizeof(float);

int launch(const float* q, const float* k, const float* v, int ld, const float* o, const float* dout,
           int ldo, const float* lse, float* delta, const int* valid_len, float* dq,
           float* dk, float* dv, int ldg, int batch, int heads, int head_dim, int s_pad,
           float qscale, float scale, cudaStream_t st) {
  if (batch <= 0 || heads <= 0 || head_dim != HEAD_DIM || s_pad % BT != 0 ||
      ld % 4 != 0 || ldo % 4 != 0 || ldg % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int total = batch * s_pad * heads;
  delta_kernel<<<(total + NT / 32 - 1) / (NT / 32), NT, 0, st>>>(
      o, dout, ldo, valid_len, delta, heads, s_pad, total);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           DKDV_SMEM);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           DQ_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(s_pad / BT, heads, batch);
  dkdv_kernel<<<grid, NT, DKDV_SMEM, st>>>(q, k, v, ld, dout, ldo, lse, delta,
                                              valid_len, dk, dv, ldg, s_pad, qscale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dq_kernel<<<grid, NT, DQ_SMEM, st>>>(q, k, v, ld, dout, ldo, lse, delta,
                                          valid_len, dq, ldg, s_pad, qscale, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v: (batch * s_pad) rows of ld elements (they may be column slices of
// one packed qkv buffer); o (the forward's output) and dout: rows of ldo
// elements; lse: (batch, heads, s_pad) f32, the forward's base-2 lse; delta:
// (batch, heads, s_pad) f32 scratch. dq, dk, dv: rows of ldg elements (they may
// be column slices of one packed dqkv buffer). head_dim must be 96; ld, ldo and
// ldg are multiples of 4 and every pointer is aligned to 4 elements.
// qscale = log2(e) / sqrt(96), scale = 1 / sqrt(96). Three launches: delta,
// dk/dv, dq.
int prefix_attention_bwd(const float* q, const float* k, const float* v, int ld,
                         const float* o, const float* dout, int ldo,
                         const float* lse, float* delta, const int* valid_len,
                         float* dq, float* dk, float* dv, int ldg, int batch,
                         int heads, int head_dim, int s_pad, float qscale,
                         float scale, void* stream) {
  return launch(q, k, v, ld, o, dout, ldo, lse, delta, valid_len, dq, dk, dv, ldg,
                batch, heads, head_dim, s_pad, qscale, scale,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
