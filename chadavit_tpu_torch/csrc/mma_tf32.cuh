// Float32 products on Hopper's tensor cores in 3xTF32: x = big + small with
// big = tf32(x) and small = tf32(x - big) (cvt.rna: to nearest, ties away
// from zero, 10 mantissa bits), and a b ~ a_small b_big + a_big b_small +
// a_big b_big, the three TF32 products summed into one float32 accumulator
// (a_small b_small, below float32's rounding, is left out). Each operand
// then carries about 22 of float32's 24 mantissa bits into the products, so
// the result keeps float32-class error where one TF32 product would keep
// 11 bits. Used by the float32 attention backward at head 64
// (prefix_attention_bwd.cu, through attention_f32.cuh).
//
// mma.sync m16n8k8, A row-major, B column-major (PTX ISA, "Matrix Fragments
// for mma.m16n8k8" with .tf32): lane l, g = l / 4, t = l % 4, holds A at
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4), B at (k t, n g), (k t + 4,
// n g), and C/D at (g, 2 t), (g, 2 t + 1), (g + 8, 2 t), (g + 8, 2 t + 1).
//
// With SGEMM_NO_FMA (the diagnostic build of sgemm_f32.cuh) each product
// only adds its operands into the accumulator, and with TF32_ONE_PRODUCT
// mma3 forms big by big alone: their results mean nothing (the second's
// are TF32's), only the time without the tensor cores, or with a third of
// their products, is read (scripts/bench_attention_f32.py). Each including file gets
// its own copy (anonymous namespace).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace tf32 {

// x = big + small, each a TF32 value; x - big is exact in float32. big is
// cvt.rna.tf32.f32 of x, formed on the integer pipe (half a TF32 unit added
// to the bit pattern, the 13 low bits cleared: the same bits for every
// finite x) rather than by cvt, which ran the attention backward 1.34 times
// slower (PERF.md); small keeps its low bits after the half unit is added,
// as the tensor cores read the top 19 bits of a TF32 operand, which is then
// cvt.rna of x - big too.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// d += a b, one m16n8k8 TF32 product into float32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
#ifndef SGEMM_NO_FMA
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#else
  d[0] += __uint_as_float(a[0]) + __uint_as_float(b[0]);
  d[1] += __uint_as_float(a[1]) + __uint_as_float(b[1]);
  d[2] += __uint_as_float(a[2]);
  d[3] += __uint_as_float(a[3]);
#endif
}

// d += a b in 3xTF32: the two small products, then big by big, into a
// fragment of zeros, which is then added into d on the CUDA cores (rounded
// to nearest). Chaining the three products into d itself lets the tensor
// cores' additions, which do not round to nearest, act on d's whole
// magnitude at every step of K; on one 64 x 64 x 64 score tile that gave
// 2.25 times the error of the CUDA cores' fmaf chain against float64, this
// form 0.48 times (scripts/bench_attention_f32.py tile, PERF.md). Three
// fragments of zeros, one a product, added after, ran 1.35-1.37 times slower in
// the attention backward.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&a_big)[4],
                                     const uint32_t (&a_small)[4], const uint32_t (&b_big)[2],
                                     const uint32_t (&b_small)[2]) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#ifndef TF32_ONE_PRODUCT
  mma(s, a_small, b_big);
  mma(s, a_big, b_small);
#endif
  mma(s, a_big, b_big);
#pragma unroll
  for (int r = 0; r < 4; ++r) d[r] += s[r];
}


}  // namespace tf32
}  // namespace
