// bf16 tensor-core products and loads, shared by the kernels' bf16 instances.
//
// mma.sync.aligned.m16n8k16 with bf16 operands and f32 accumulation: every
// product of two bf16 values is exact in f32, so one pass gives what an
// f32-accumulating bf16 matrix product computes (no split, unlike 3xTF32).
// Fragment layout (lane = 4 g + t), each 32-bit register holding two bf16
// (the lower column or row in the low half):
//   A (16 x 16, row-major): a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1],
//                           a2 = A[g][2t+8, 2t+9], a3 = A[g+8][2t+8, 2t+9];
//   B (16 x 8, k x n):      b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g];
//   C (16 x 8):             c0 = C[g][2t], c1 = C[g][2t+1], c2 = C[g+8][2t],
//                           c3 = C[g+8][2t+1].
// A C tile's n-tiles 2j and 2j+1 are, as they lie in registers, the A
// fragment of a product over those 16 columns (attention's P.V).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// d += a.b, one bf16 product with f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B fragment of a 16 x 8 tile stored k-major in shared memory (row r =
// k, 8 consecutive n per row, 16-byte aligned rows): lane l passes the
// address of row l % 16. ldmatrix .trans hands lane 4 g + t the elements
// (2t, g), (2t + 1, g) of each 8 x 8 matrix, which is b0 (rows 0-7) and b1
// (rows 8-15).
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1, const void* row) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(s));
}

// Two f32 values rounded to bf16 (to nearest even), packed lo | hi << 16.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// f32 rounded to bf16 (to nearest even), returned as the f32 value it stands for.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The f32 values of the low and high bf16 halves of a 32-bit word.
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// The f32 value of the bf16 at p (global memory, read-only path).
__device__ __forceinline__ float load_bf16(const __nv_bfloat16* p) {
  return __uint_as_float((uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// 32-bit load of two bf16 from shared memory (4-byte aligned).
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16-byte (cg) and 8-byte (ca) global -> shared copies; zero-fill when !in.
__device__ __forceinline__ void cp_async16_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                bool in) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async8_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               bool in) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 8 : 0));
}
