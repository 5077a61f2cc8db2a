// The float32 GEMM main loop on Hopper's CUDA cores, shared by the redesigned
// ln_linear_fwd, linear_relu_fwd and linear_residual_ln_fwd (fused_block.cu,
// K1a, K1c and K1b), linear_wgrad and linear_dgrad (fused_block_bwd.cu, K2c
// and K2b) and the float32 attention forward and backward
// (prefix_attention.cu and prefix_attention_bwd.cu, K3 and K4, through
// attention_f32.cuh):
//
// - a cp.async ring of shared-memory stages (16-byte cp.async.cg copies, L2
//   only), with one barrier a stage: the copies of the stages ahead are in
//   flight while the current one is multiplied;
// - three register-blocked micro-kernels that read shared memory 16 bytes at
//   a time: dot4 for tiles stored with K contiguous (a block's rows of A and
//   W, as x @ W^T reads them), outer for tiles stored with the output's
//   columns contiguous (dY^T X over the rows of a batch), and outer4 for an A
//   stored with K contiguous against a B stored with the output's columns
//   contiguous (dY @ W, W read as (K, N)).
//
// Every sum is fmaf on the CUDA cores, in float32, in the order of K (no TF32
// and no split-TF32 emulation): the float32 instances are held to the JAX
// package's float32, so only the order of the sums differs from the plain
// versions. What bounds these kernels at the layer's shapes is operations
// (67 TFLOP/s of f32 FMA): their tiles keep 32 to 64 sums a thread, so each
// 16-byte shared load feeds 10 to 16 FMAs. Larger tiles would need fewer
// loads a FMA but more registers than two or three blocks an SM leave; the
// diagnostic builds below show the shared loads and the copies, as much as
// the FMAs, holding the GEMMs (scripts/bench_linear_f32.py,
// scripts/bench_attention_f32.py, PERF.md).
//
// Two diagnostic builds (scripts/bench_linear_f32.py,
// scripts/bench_attention_f32.py) define
// SGEMM_NO_COPY (the copies do nothing) or SGEMM_NO_FMA (each operand is
// added once instead of multiplied into every sum); their results mean
// nothing, only their times are read. Each including file gets its own copy
// (anonymous namespace).

#pragma once

#include "storage.cuh"

namespace {
namespace sgemm {

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
#ifndef SGEMM_NO_COPY
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
#endif
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Runs compute(s, slot) for the stages s = 0 .. n - 1 in order; load(s, slot)
// issues the copies of stage s into ring slot s % STAGES, STAGES - 1 stages
// ahead. One barrier a stage: after it, stage s has landed for every thread,
// and every thread is done with stage s - 1, whose slot the next load takes.
// Every thread of the block calls it with the same n. head() runs once, after
// the copies of the first STAGES - 1 stages are issued (each stage one
// cp.async group) and before the first barrier, so work that waits for
// copies committed before the ring overlaps the ring's first copies; it may
// hold barriers. compute may hold barriers of its own. On return all copies
// have landed; the caller synchronises before it reuses the ring.
template <int STAGES, typename Load, typename Compute, typename Head>
__device__ __forceinline__ void ring(int n, Load&& load, Compute&& compute, Head&& head) {
  static_assert(STAGES >= 2, "a ring of at least two stages");
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load(s, s);
    cp_async_commit();
  }
  head();
  int slot = 0, next_slot = STAGES - 1;
  for (int s = 0; s < n; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (s + STAGES - 1 < n) load(s + STAGES - 1, next_slot);
    cp_async_commit();
    compute(s, slot);
    slot = slot + 1 == STAGES ? 0 : slot + 1;
    next_slot = next_slot + 1 == STAGES ? 0 : next_slot + 1;
  }
  cp_async_wait<0>();
}
template <int STAGES, typename Load, typename Compute>
__device__ __forceinline__ void ring(int n, Load&& load, Compute&& compute) {
  ring<STAGES>(n, load, compute, [] {});
}

// acc[i][j] += a[i] * b[j] for every pair: one step of K of an outer product
template <int RM, int CN>
__device__ __forceinline__ void outer(float (&acc)[RM][CN], const float (&a)[RM],
                                      const float (&b)[CN]) {
#ifndef SGEMM_NO_FMA
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
#else
#pragma unroll
  for (int i = 0; i < RM; ++i) acc[i][0] += a[i];
#pragma unroll
  for (int j = 0; j < CN; ++j) acc[0][j] += b[j];
#endif
}

// acc[i][j] += a[i] . b over four steps of K, in K order (x, y, z, w): column
// j of a tile stored with K contiguous, against the thread's RM rows. j is a
// constant once the caller's loop over its columns is unrolled.
template <int RM, int CN>
__device__ __forceinline__ void dot4(float (&acc)[RM][CN], int j, const float4 (&a)[RM],
                                     float4 b) {
#ifndef SGEMM_NO_FMA
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float s = acc[i][j];
    s = fmaf(a[i].x, b.x, s);
    s = fmaf(a[i].y, b.y, s);
    s = fmaf(a[i].z, b.z, s);
    acc[i][j] = fmaf(a[i].w, b.w, s);
  }
#else
  if (j == 0)
#pragma unroll
    for (int i = 0; i < RM; ++i) acc[i][0] += (a[i].x + a[i].y) + (a[i].z + a[i].w);
  acc[0][j] += (b.x + b.y) + (b.z + b.w);
#endif
}

// acc[i][j] += a[i].x b[0][j] + a[i].y b[1][j] + a[i].z b[2][j] + a[i].w b[3][j],
// one step of K after the other: four outer products, a float4 of each of the
// thread's rows of A over four steps of K (A stored with K contiguous) against
// those four rows of B (B stored with the output's columns contiguous).
template <int RM, int CN>
__device__ __forceinline__ void outer4(float (&acc)[RM][CN], const float4 (&a)[RM],
                                       const float (&b)[4][CN]) {
#ifndef SGEMM_NO_FMA
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      float s = acc[i][j];
      s = fmaf(a[i].x, b[0][j], s);
      s = fmaf(a[i].y, b[1][j], s);
      s = fmaf(a[i].z, b[2][j], s);
      acc[i][j] = fmaf(a[i].w, b[3][j], s);
    }
#else
#pragma unroll
  for (int i = 0; i < RM; ++i) acc[i][0] += (a[i].x + a[i].y) + (a[i].z + a[i].w);
#pragma unroll
  for (int j = 0; j < CN; ++j) acc[0][j] += (b[0][j] + b[1][j]) + (b[2][j] + b[3][j]);
#endif
}

}  // namespace sgemm
}  // namespace
