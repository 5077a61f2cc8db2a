// One 64 x 64 score tile of the float32 attention backward at head 64, S = A
// B^T over 64 columns, on the CUDA cores (attention_f32.cuh's scores<64>, a
// thread's 4 x 8 entries, as the kernel's four score warps take it) and on
// the tensor cores in 3xTF32 (scores_tf32<64>, a warp's 16 rows; each step's
// three TF32 products into a fragment of zeros added into S, or chained into
// S itself), for
// scripts/bench_attention_f32.py's `tile` mode: each block stages the tile's
// A and B once and forms the product `reps` times, so that the time of the
// product alone is read; with reps 1 and one block, `out` holds the product,
// whose error the script reads against a float64 product. Built by that
// script with the kernels' flags and -I chadavit_tpu_torch/csrc.

#include "attention_f32.cuh"

namespace {

constexpr int PROBE_THREADS = 128;  // four warps: one role of the backward's block

// scores_tf32<64> with each step's three TF32 products chained into S itself
__device__ __forceinline__ void scores_tf32_chained(float (&acc)[8][4], const float* A, int r0,
                                                    const float* B, int lane) {
  constexpr int LD = LDH<64>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
#pragma unroll 2
  for (int kd = 0; kd < 64; kd += 8) {
    const float* a = A + (r0 + g) * LD + kd + t;
    uint32_t ab[4], as[4];
    tf32::split(a[0], ab[0], as[0]);
    tf32::split(a[8 * LD], ab[1], as[1]);
    tf32::split(a[4], ab[2], as[2]);
    tf32::split(a[8 * LD + 4], ab[3], as[3]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* b = B + (8 * j + g) * LD + kd + t;
      uint32_t bb[2], bs[2];
      tf32::split(b[0], bb[0], bs[0]);
      tf32::split(b[4], bb[1], bs[1]);
      tf32::mma(acc[j], as, bb);
      tf32::mma(acc[j], ab, bs);
      tf32::mma(acc[j], ab, bb);
    }
  }
}

__device__ void stage(float* As, float* Bs, const float* a, const float* b) {
  constexpr int LD = LDH<64>;
  for (int c = threadIdx.x; c < BT * 64; c += PROBE_THREADS) {
    As[c / 64 * LD + c % 64] = a[c];
    Bs[c / 64 * LD + c % 64] = b[c];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(PROBE_THREADS)
probe_cuda_cores_kernel(const float* a, const float* b, float* out, int reps) {
  __shared__ __align__(16) float As[TILE_F<64>], Bs[TILE_F<64>];
  stage(As, Bs, a, b);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kr = 16 * warp + 4 * (lane >> 3), qg = lane & 7;
  float tot[4][8] = {};
  for (int rep = 0; rep < reps; ++rep) {
    asm volatile("" ::: "memory");  // the tiles are read again each time
    float sc[4][8];
    scores<64>(sc, As, kr, Bs, qg);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) tot[i][j] += sc[i][j];
  }
  float* o = out + (size_t)blockIdx.x * BT * BT;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) o[(kr + i) * BT + qg + 8 * j] = tot[i][j];
}

template <bool CHAINED>
__global__ void __launch_bounds__(PROBE_THREADS)
probe_tf32_kernel(const float* a, const float* b, float* out, int reps) {
  __shared__ __align__(16) float As[TILE_F<64>], Bs[TILE_F<64>];
  stage(As, Bs, a, b);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float tot[8][4] = {};
  for (int rep = 0; rep < reps; ++rep) {
    asm volatile("" ::: "memory");
    float sc[8][4];
    if constexpr (CHAINED) scores_tf32_chained(sc, As, 16 * warp, Bs, lane);
    else scores_tf32<64>(sc, As, 16 * warp, Bs, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) tot[j][r] += sc[j][r];
  }
  float* o = out + (size_t)blockIdx.x * BT * BT;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      o[(16 * warp + g + 8 * (r >> 1)) * BT + 8 * j + 2 * t + (r & 1)] = tot[j][r];
}

}  // namespace

extern "C" {

// a, b: (64, 64) row-major; out: (blocks, 64, 64); which 0: CUDA cores, 1:
// 3xTF32, 2: 3xTF32 chained
int probe_scores(const float* a, const float* b, float* out, int reps, int blocks, int which,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (which == 0)
    probe_cuda_cores_kernel<<<blocks, PROBE_THREADS, 0, st>>>(a, b, out, reps);
  else if (which == 1)
    probe_tf32_kernel<false><<<blocks, PROBE_THREADS, 0, st>>>(a, b, out, reps);
  else
    probe_tf32_kernel<true><<<blocks, PROBE_THREADS, 0, st>>>(a, b, out, reps);
  return (int)cudaGetLastError();
}

}  // extern "C"
