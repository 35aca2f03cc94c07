// 3xTF32 tensor-core products and cp.async staging, shared by the kernels.
//
// mma.sync.aligned.m16n8k8 TF32 with f32 accumulate. Fragment layout (lane =
// 4 g + t): A (16 x 8, row-major) a0 = A[g][t], a1 = A[g + 8][t], a2 =
// A[g][t + 4], a3 = A[g + 8][t + 4]; B (8 x 8, k x n) b0 = B[t][g], b1 =
// B[t + 4][g]; C (16 x 8) c0 = C[g][2t], c1 = C[g][2t + 1], c2 = C[g + 8][2t],
// c3 = C[g + 8][2t + 1].
//
// 3xTF32 keeps f32 accuracy: each f32 operand a is split into hi = tf32(a),
// rounded to nearest with ties away from zero (the rounding of
// cvt.rna.tf32.f32), and lo = a - hi, and a.b is taken as lo.hi + hi.lo +
// hi.hi with f32 accumulation (the lo.lo term is below f32 rounding). The
// tensor core reads lo to TF32 precision; |lo| <= 2^-11 |a|, so what it drops
// is below 2^-22 |a|. The rounding is done with an integer add and a mask,
// which run at the full integer rate, where a cvt runs at a quarter of
// it; the splits are a large share of both kernels' instructions.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// hi: a rounded to TF32 (10 mantissa bits), ties away from zero; lo = a - hi
// exactly, passed as f32 bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a.b, one TF32 product.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a.b in 3xTF32, the three products summed in the tensor core from zero
// and the result added to d by an f32 add. The tensor core's f32 accumulation
// does not round to nearest; over thousands of products into one accumulator
// its error grows well past f32 rounding, so long sums add in f32 instead.
__device__ __forceinline__ void mma_3xtf32_add(float (&d)[4], const uint32_t (&ah)[4],
                                               const uint32_t (&al)[4], uint32_t bh0,
                                               uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(p, al, bh0, bh1);
  mma_tf32(p, ah, bl0, bl1);
  mma_tf32(p, ah, bh0, bh1);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += p[i];
}

// Split a 16 x 8 A fragment held at rows g, g + 8 and columns t, t + 4 of a
// row-major shared tile with row stride `stride` (floats).
__device__ __forceinline__ void load_a_3xtf32(const float* a, int stride, int g, int t,
                                              uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(a[g * stride + t], hi[0], lo[0]);
  split_tf32(a[(g + 8) * stride + t], hi[1], lo[1]);
  split_tf32(a[g * stride + t + 4], hi[2], lo[2]);
  split_tf32(a[(g + 8) * stride + t + 4], hi[3], lo[3]);
}

// 16-byte global -> shared copy; zero-fills the destination when !in.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
