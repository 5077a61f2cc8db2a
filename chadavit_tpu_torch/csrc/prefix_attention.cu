// Prefix-masked multi-head attention, forward, float32 on CUDA cores.
//
// Replaces the TPU kernel chadavit_tpu/ops/flash_attention.py::_fwd_kernel
// (reached through _fwd_impl / prefix_flash_attention), and the attention step
// inside chadavit_tpu/ops/fused_block.py::_fwd_kernel. Key j of image b is valid
// iff j < valid_len[b]; queries are not masked.
//
// What bounds it on an H100: per (image, head) it does 4 * vl^2 * hd operations
// on 3 * vl * hd inputs, about 2 * vl / 3 operations per byte, so at
// vl = 1961 it is bound by operations (67 TFLOP/s of f32 FMA). The TPU kernel
// holds a whole (BQ, S_pad) score row in VMEM; here a block owns BQ = 64
// queries of one head and streams BKV = 64 keys at a time through shared
// memory with an online softmax, so the score tile stays 16 KB. The scale and
// log2(e) are folded into q as it is staged (flash_attention.py:123-125), and
// the softmax runs in base 2 with exp2f. The key loop stops at valid_len[b],
// and the ragged last key tile is masked, so padded keys cost nothing.
//
// A block whose first query lies at or past valid_len[b] writes zeros and
// returns. That decision is the same for every thread of the block and is taken
// before the first barrier, so no thread can wait at a barrier that another has
// left. For training the kernel also writes the base-2 lse of every query row
// (lse = m + log2(l), flash_attention.py:137-138), which the backward
// (prefix_attention_bwd.cu) reads; the output is optional (a null pointer), so
// the serving path writes none. Skipped blocks write lse = 1e30 there, the TPU
// kernel's +LARGE, so a recomputed p underflows to 0 on those rows.
//
// Plain C interface (loaded with ctypes); the launcher returns
// cudaGetLastError() so that the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;    // queries per block
constexpr int BKV = 64;   // keys per shared-memory tile
constexpr int NT = 256;   // threads, as a 16 x 16 grid
constexpr int WARPS = NT / 32;
constexpr int HEAD_DIM = 96;  // ChAdaViT-moyen: D 192, 2 heads; other widths are refused

template <int HD>
constexpr int smem_floats() {
  return BQ * (HD + 1) + BKV * (HD + 1) + BKV * HD + BQ * (BKV + 1) + 3 * BQ;
}

// q, k, v: rows of `ld` floats, image b's rows start at b * s_pad; head h
// occupies columns [h * HD, (h + 1) * HD). out: rows of `ldo` floats, the same
// row layout. Grid (s_pad / BQ, heads, B).
template <int HD>
__global__ void __launch_bounds__(NT)
prefix_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, int ld,
                        const int* __restrict__ valid_len,
                        float* __restrict__ out, int ldo,
                        float* __restrict__ lse, int s_pad, float qscale) {
  constexpr int TN = HD / 16;  // output columns per thread
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int vl = min(max(valid_len[b], 0), s_pad);  // a bad length cannot read past the image
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t row0 = (size_t)b * s_pad;
  float* o = out + (row0 + q0) * ldo + h * HD;
  // lse of (image b, head h, row q) at lse[(b * heads + h) * s_pad + q]
  float* lse_row = lse == nullptr ? nullptr
                                  : lse + ((size_t)b * gridDim.y + h) * s_pad + q0;

  if (q0 >= vl) {  // uniform across the block, before any barrier
    for (int idx = tid; idx < BQ * HD; idx += NT)
      o[(size_t)(idx / HD) * ldo + idx % HD] = 0.f;
    if (lse_row != nullptr && tid < BQ) lse_row[tid] = 1e30f;
    return;
  }

  extern __shared__ float smem[];
  float* Qs = smem;                    // BQ x (HD + 1), pre-scaled
  float* Ks = Qs + BQ * (HD + 1);      // BKV x (HD + 1)
  float* Vs = Ks + BKV * (HD + 1);     // BKV x HD
  float* Ps = Vs + BKV * HD;           // BQ x (BKV + 1): scores, then p
  float* row_m = Ps + BQ * (BKV + 1);  // running max (base 2)
  float* row_l = row_m + BQ;           // running sum
  float* row_a = row_l + BQ;           // rescale factor of this tile

  constexpr int V4 = HD / 4;  // float4 per head row
  for (int idx = tid; idx < BQ * V4; idx += NT) {
    const int r = idx / V4, c = (idx % V4) * 4;
    const float4 t = *reinterpret_cast<const float4*>(
        q + (row0 + q0 + r) * ld + h * HD + c);
    float* dst = Qs + r * (HD + 1) + c;
    dst[0] = t.x * qscale;
    dst[1] = t.y * qscale;
    dst[2] = t.z * qscale;
    dst[3] = t.w * qscale;
  }
  if (tid < BQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  float acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int warp = tid / 32, lane = tid % 32;
  for (int k0 = 0; k0 < vl; k0 += BKV) {  // vl is uniform: barriers are safe
    __syncthreads();  // the previous tile's Ks/Vs/Ps are no longer read
    for (int idx = tid; idx < BKV * V4; idx += NT) {
      const int r = idx / V4, c = (idx % V4) * 4;
      const size_t off = (row0 + k0 + r) * ld + h * HD + c;
      const float4 kt = *reinterpret_cast<const float4*>(k + off);
      const float4 vt = *reinterpret_cast<const float4*>(v + off);
      float* kd = Ks + r * (HD + 1) + c;
      kd[0] = kt.x;
      kd[1] = kt.y;
      kd[2] = kt.z;
      kd[3] = kt.w;
      *reinterpret_cast<float4*>(Vs + r * HD + c) = vt;
    }
    __syncthreads();

    // scores: this thread's rows 4 ty + i, key columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * ty + i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        Ps[(4 * ty + i) * (BKV + 1) + c] = (k0 + c < vl) ? s[i][j] : -INFINITY;
      }
    __syncthreads();

    // online softmax, one warp per row; key 0 is always valid, so the running
    // max is finite from the first tile on
    for (int r = warp; r < BQ; r += WARPS) {
      float* pr = Ps + r * (BKV + 1);
      const float x0 = pr[lane], x1 = pr[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = exp2f(x0 - m_new), p1 = exp2f(x1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);
        row_a[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v for rows 4 ty + i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = row_a[4 * ty + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(4 * ty + i) * (BKV + 1) + kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float vv = Vs[kk * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  // row_l was last written before the final barrier of the loop
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.f / row_l[4 * ty + i];
#pragma unroll
    for (int j = 0; j < TN; ++j)
      o[(size_t)(4 * ty + i) * ldo + tx + 16 * j] = acc[i][j] * inv;
  }
  if (lse_row != nullptr && tid < BQ) lse_row[tid] = row_m[tid] + log2f(row_l[tid]);
}

template <int HD>
int launch(const float* q, const float* k, const float* v, int ld,
           const int* valid_len, float* out, int ldo, float* lse, int batch,
           int heads, int s_pad, float qscale, cudaStream_t st) {
  constexpr int bytes = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(prefix_attention_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       bytes);
  if (e != cudaSuccess) return (int)e;
  prefix_attention_kernel<HD><<<dim3(s_pad / BQ, heads, batch), NT, bytes, st>>>(
      q, k, v, ld, valid_len, out, ldo, lse, s_pad, qscale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v: (batch * s_pad) rows of ld floats (they may be column slices of one
// packed qkv buffer); out: (batch * s_pad) rows of ldo floats. lse, when not
// null: (batch, heads, s_pad), the base-2 log-sum-exp of each query row.
// valid_len is clamped to [0, s_pad]. head_dim must be 96.
// qscale = log2(e) / sqrt(96).
int prefix_attention_fwd(const float* q, const float* k, const float* v, int ld,
                         const int* valid_len, float* out, int ldo, float* lse,
                         int batch, int heads, int head_dim, int s_pad,
                         float qscale, void* stream) {
  if (batch <= 0 || heads <= 0 || head_dim != HEAD_DIM || s_pad % BQ != 0 ||
      s_pad % BKV != 0 || ld % 4 != 0 || ldo % 4 != 0)
    return (int)cudaErrorInvalidValue;
  return launch<HEAD_DIM>(q, k, v, ld, valid_len, out, ldo, lse, batch, heads,
                          s_pad, qscale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
