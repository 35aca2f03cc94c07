// Masked multi-head attention forward (flash-style, f32) for Hopper.
//
// Replaces the Pallas TPU kernel diffreg_tpu/ops/pallas/attention_kernel.py:
// _attn_kernel (pallas_call in _forward). Same function: logits = (q * scale) k^T,
// keys with kv_mask == 0 set to -1e9 for every query, softmax over keys, then
// times v; an online softmax over key tiles with f32 accumulation, so the
// [B, H, L, S] logits never reach device memory. The scale is passed in
// (1/sqrt(108) on the main path), and D = 108 is not padded.
//
// What bounds it on an H100: operations. At L = S = 704, D = 108 it does
// 4 * L * S * D flops per (batch, head) against 4 * (L + 2 S) * D bytes of
// q, k, v and 4 * L * D bytes of output, far past the f32 ridge point.
// Design: one block per (batch * head, tile of 64 queries); 4 threads per
// query row, each owning 16 key columns of the 64-key tile and a quarter of
// the D output lanes in registers; q, the key and value tiles, and the tile's
// probabilities live in shared memory. The products are scalar f32 FMAs on
// CUDA cores (TF32 would change the numbers); register tiling and tensor
// cores are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQT = 64;        // queries per block
constexpr int kKT = 64;        // keys per tile
constexpr int kThreads = 256;  // 4 threads per query row
constexpr int kDMax = 128;     // largest head dim supported
constexpr int kSub = kThreads / kQT;

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)kQT * D + 2 * (size_t)kKT * D + (size_t)kQT * (kKT + 1));
}

__global__ void __launch_bounds__(kThreads) masked_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const uint8_t* __restrict__ kv_mask,
    float* __restrict__ out, int H, int L, int S, int D, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [QT][D], pre-scaled
  float* ks = qs + kQT * D;          // [KT][D]
  float* vs = ks + kKT * D;          // [KT][D]
  float* ps = vs + kKT * D;          // [QT][KT + 1] probabilities of the tile
  __shared__ int key_state[kKT];     // 1 valid, 0 masked (-1e9), -1 past S

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int l0 = blockIdx.x * kQT;
  const int tid = threadIdx.x;
  const int row = tid / kSub, sub = tid % kSub;
  const float* qb = q + (size_t)bh * L * D;
  const float* kb = k + (size_t)bh * S * D;
  const float* vb = v + (size_t)bh * S * D;
  const uint8_t* mb = kv_mask + (size_t)b * S;

  for (int i = tid; i < kQT * D; i += kThreads) {
    const int r = i / D;
    qs[i] = l0 + r < L ? qb[(size_t)l0 * D + i] * scale : 0.f;
  }

  float m = -INFINITY, lsum = 0.f;
  float acc[kDMax / kSub];
#pragma unroll
  for (int i = 0; i < kDMax / kSub; ++i) acc[i] = 0.f;

  for (int s0 = 0; s0 < S; s0 += kKT) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kKT * D; i += kThreads) {
      const bool in = s0 + i / D < S;
      ks[i] = in ? kb[(size_t)s0 * D + i] : 0.f;
      vs[i] = in ? vb[(size_t)s0 * D + i] : 0.f;
    }
    if (tid < kKT) key_state[tid] = s0 + tid < S ? (mb[s0 + tid] ? 1 : 0) : -1;
    __syncthreads();

    float sc[kKT / kSub];
#pragma unroll
    for (int i = 0; i < kKT / kSub; ++i) sc[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = qs[row * D + d];
#pragma unroll
      for (int i = 0; i < kKT / kSub; ++i) sc[i] = fmaf(qv, ks[(sub + kSub * i) * D + d], sc[i]);
    }
    float tmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < kKT / kSub; ++i) {
      const int st = key_state[sub + kSub * i];
      sc[i] = st == 1 ? sc[i] : (st == 0 ? -1.0e9f : -INFINITY);
      tmax = fmaxf(tmax, sc[i]);
    }
    // the 4 threads of a row are adjacent lanes of one warp
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);   // finite: the tile holds a key < S
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < kKT / kSub; ++i) {
      const float p = expf(sc[i] - m_new);
      ps[row * (kKT + 1) + sub + kSub * i] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    lsum = lsum * alpha + psum;
    m = m_new;
    __syncwarp();  // the row's probabilities were written by lanes of this warp

#pragma unroll
    for (int i = 0; i < kDMax / kSub; ++i) acc[i] *= alpha;
    for (int j = 0; j < kKT; ++j) {
      const float p = ps[row * (kKT + 1) + j];
#pragma unroll
      for (int i = 0; i < kDMax / kSub; ++i) {
        const int d = sub + kSub * i;
        if (d < D) acc[i] = fmaf(p, vs[j * D + d], acc[i]);
      }
    }
  }

  if (l0 + row < L) {
    float* ob = out + ((size_t)bh * L + l0 + row) * D;
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
#pragma unroll
    for (int i = 0; i < kDMax / kSub; ++i) {
      const int d = sub + kSub * i;
      if (d < D) ob[d] = acc[i] * inv;
    }
  }
}

}  // namespace

extern "C" {

// q [B, H, L, D], k/v [B, H, S, D], kv_mask [B, S] bool (1 byte), out
// [B, H, L, D]; f32 and contiguous. Returns a cudaError_t (0 on success).
int masked_attention_forward(const float* q, const float* k, const float* v,
                             const uint8_t* kv_mask, float* out, int B, int H,
                             int L, int S, int D, float scale, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || L <= 0 || S <= 0 || D <= 0 || D > kDMax)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      masked_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + kQT - 1) / kQT, B * H);
  masked_attention_kernel<<<grid, kThreads, smem, stream>>>(q, k, v, kv_mask, out, H, L, S,
                                                           D, scale);
  return (int)cudaGetLastError();
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
