// Shared by the KPConv kernels' two libraries, kpconv.cu (f32) and
// kpconv_bf16.cu (the bf16 instance): the influence modes, the CUDA-core
// kernel both use for the shapes their tensor-core kernels do not take, and
// the tiling constants of those tensor-core kernels.
//
// Replaces the Pallas TPU kernel diffreg_tpu/ops/pallas/kpconv_kernel.py:_kernel
// (pallas_call in _fused_kpconv_fwd_impl). Same arithmetic: for each query q and
// each neighbor row n of its fixed-K neighborhood,
//   rel = s[n] - q,  d2_p = max(|rel|^2 + |kp_p|^2 - 2 rel.kp_p, 0),
//   infl_p = max(1 - sqrt(d2_p) / extent, 0),
//   acc[p, c] += infl_p * x[n, c],
// then out[q] = (sum_p acc[p, :] @ W[p]) / max(#neighbors with feature-sum > 0, 1).
// The Pallas kernel has linear influence and sum aggregation only; the JAX
// package runs its other modes in XLA (diffreg_tpu/ops/kpconv.py:
// _influence_weights), and here they are instances of the same kernels: the
// influence is a template parameter (linear as above; constant, infl_p = 1;
// gaussian, infl_p = exp(-d2_p / (2 sigma^2 + 1e-9)) with sigma = 0.3 extent,
// the denominator formed in double by the caller as the JAX package forms it),
// and aggregation "closest" (a runtime flag) keeps, for each neighbor, only the
// influence of its nearest kernel point (the first on ties, as jnp.argmin).
//
// The CUDA-core kernel (any shape; on the main path only the first layer,
// Cin = 1): one block per (pair, tile of TQ queries), reading its rows through
// F32Rows (the bf16 instance's through Bf16Rows); the influences, the density
// count and the influence-weighted [TQ, P * Cin] accumulator live in shared
// memory, and the contraction runs in f32 on CUDA cores, each W element read
// once per block and reused for the TQ queries from registers (TQ the largest
// of 16/8/4/2/1 that fits).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16.cuh"
#include "tf32.cuh"

namespace {

constexpr int kP = 15;         // kernel points (KPFCNConfig.num_kernel_points)
constexpr int kThreads = 256;
constexpr size_t kSmemBudget = 200 * 1024;

__device__ __forceinline__ float kp_norm2(float x, float y, float z) {
  return x * x + y * y + z * z;
}

// Kernel points to shared memory: kps [P][3] and their squared norms k2s [P].
__device__ __forceinline__ void load_kernel_points(const float* kp, float* kps, float* k2s) {
  const int tid = threadIdx.x;
  if (tid < kP) {
    const float a = kp[3 * tid], c = kp[3 * tid + 1], d = kp[3 * tid + 2];
    kps[3 * tid] = a;
    kps[3 * tid + 1] = c;
    kps[3 * tid + 2] = d;
    k2s[tid] = kp_norm2(a, c, d);
  }
}

// The influence modes (template parameter Infl) and the runtime parameters of
// a call: the extent, the gaussian denominator 2 sigma^2 + 1e-9, and whether
// the aggregation is "closest".
enum Influence { kLinear = 0, kConstant = 1, kGaussian = 2 };

struct Mode {
  float extent;
  float gauss_den;
  int closest;
};

// Squared distance of a kernel point (kx, ky, kz; k2 its squared norm) from a
// neighbor at offset r (|r|^2 = n2) from its query, computed as the JAX
// package does: d2 = max(|r|^2 + |kp|^2 - 2 r.kp, 0).
__device__ __forceinline__ float kp_d2(float rx, float ry, float rz, float n2, float kx,
                                       float ky, float kz, float k2) {
  const float cross = rx * kx + ry * ky + rz * kz;
  return fmaxf(n2 + k2 - 2.f * cross, 0.f);
}

// The influence of a kernel point at squared distance d2.
template <int Infl>
__device__ __forceinline__ float influence_of(float d2, const Mode& mode) {
  if (Infl == kLinear) return fmaxf(1.f - sqrtf(d2) / mode.extent, 0.f);
  if (Infl == kConstant) return 1.f;
  return expf(-d2 / mode.gauss_den);
}

// The influences of all P kernel points on one neighbor, into f[0, P): under
// "closest" every point but the nearest (the first of equal ones) gets 0.
template <int Infl>
__device__ __forceinline__ void influences(float rx, float ry, float rz, float n2,
                                           const float* kps, const float* k2s,
                                           const Mode& mode, float (&f)[kP]) {
  float d2[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p)
    d2[p] = kp_d2(rx, ry, rz, n2, kps[3 * p], kps[3 * p + 1], kps[3 * p + 2], k2s[p]);
  int nearest = 0;
  float best = d2[0];
#pragma unroll
  for (int p = 1; p < kP; ++p) {
    if (d2[p] < best) {
      best = d2[p];
      nearest = p;
    }
  }
#pragma unroll
  for (int p = 0; p < kP; ++p)
    f[p] = mode.closest && p != nearest ? 0.f : influence_of<Infl>(d2[p], mode);
}

size_t smem_bytes(int tq, int K, int Cin) {
  return sizeof(float) * ((size_t)tq * kP * Cin + (size_t)tq * K * kP) +
         sizeof(int) * ((size_t)tq * K + tq);
}

// Where the CUDA-core kernel reads the support rows and the weights, and how
// it rounds: the f32 arrays (kpconv_forward), or the bf16 table [B, Ns + 1,
// 8 + Cin] of [hi(pos), lo(pos), 0, 0, features] and bf16 weights, with the bf16
// path's roundings of the influences and of the weighted sums
// (kpconv_forward_bf16).
struct F32Rows {
  const float* s_pts;
  const float* x;
  const float* w;
  int Ns, Cin;
  __device__ void pos(int b, int nb, float& px, float& py, float& pz) const {
    const float* sp = s_pts + ((size_t)b * Ns + nb) * 3;
    px = sp[0];
    py = sp[1];
    pz = sp[2];
  }
  __device__ float feat(int b, int nb, int c) const {
    return x[((size_t)b * Ns + nb) * Cin + c];
  }
  __device__ float weight(size_t i) const { return __ldg(w + i); }
  __device__ static float rounded(float v) { return v; }
};

struct Bf16Rows {
  const __nv_bfloat16* table;
  const __nv_bfloat16* w;
  int Ns, Cin;
  __device__ const __nv_bfloat16* row(int b, int nb) const {
    return table + ((size_t)b * (Ns + 1) + nb) * (8 + Cin);
  }
  __device__ void pos(int b, int nb, float& px, float& py, float& pz) const {
    const __nv_bfloat16* sp = row(b, nb);
    px = load_bf16(sp) + load_bf16(sp + 3);
    py = load_bf16(sp + 1) + load_bf16(sp + 4);
    pz = load_bf16(sp + 2) + load_bf16(sp + 5);
  }
  __device__ float feat(int b, int nb, int c) const { return load_bf16(row(b, nb) + 8 + c); }
  __device__ float weight(size_t i) const { return load_bf16(w + i); }
  __device__ static float rounded(float v) { return round_bf16(v); }
};

template <int TQ, int Infl, class Rows>
__global__ void __launch_bounds__(kThreads) kpconv_kernel(
    const float* __restrict__ q_pts, const Rows rows, const int32_t* __restrict__ inds,
    const float* __restrict__ kp, float* __restrict__ out, int Nq, int Ns, int K, int Cin,
    int Cout, Mode mode) {
  extern __shared__ float smem[];
  const int PC = kP * Cin;
  float* acc = smem;                           // [TQ][P * Cin]
  float* infl = acc + TQ * PC;                 // [TQ][K][P]
  int* nbr = (int*)(infl + TQ * K * kP);       // [TQ][K], -1 = shadow row
  int* cnt = nbr + TQ * K;                     // [TQ]
  __shared__ float kps[kP * 3];
  __shared__ float k2s[kP];

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * TQ;
  const int tid = threadIdx.x;

  load_kernel_points(kp, kps, k2s);
  if (tid < TQ) cnt[tid] = 0;
  __syncthreads();

  // Phase A: neighbor index and influence of every (query, neighbor, kernel point).
  for (int s = tid; s < TQ * K; s += kThreads) {
    const int qi = s / K, k = s - qi * K;
    const int q = q0 + qi;
    const int nb = q < Nq ? inds[((size_t)b * Nq + q) * K + k] : Ns;
    float* ip = infl + s * kP;
    if (nb < 0 || nb >= Ns) {
      nbr[s] = -1;
#pragma unroll
      for (int p = 0; p < kP; ++p) ip[p] = 0.f;
      continue;
    }
    nbr[s] = nb;
    const float* qp = q_pts + ((size_t)b * Nq + q) * 3;
    float px, py, pz;
    rows.pos(b, nb, px, py, pz);
    const float rx = px - qp[0], ry = py - qp[1], rz = pz - qp[2];
    const float n2 = rx * rx + ry * ry + rz * rz;
    float f[kP];
    influences<Infl>(rx, ry, rz, n2, kps, k2s, mode, f);
#pragma unroll
    for (int p = 0; p < kP; ++p) ip[p] = Rows::rounded(f[p]);
  }
  __syncthreads();

  // Phase A2: density count, one warp per (query, neighbor): a neighbor
  // counts iff its feature-sum is positive (the reference's quirk).
  const int warp = tid / 32, lane = tid % 32;
  for (int s = warp; s < TQ * K; s += kThreads / 32) {
    const int nb = nbr[s];
    if (nb < 0) continue;
    float sum = 0.f;
    for (int c = lane; c < Cin; c += 32) sum += rows.feat(b, nb, c);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0 && sum > 0.f) atomicAdd(&cnt[s / K], 1);
  }

  // Phase B: acc[q, p, c] = sum_k infl[q, k, p] * x[nbr[q, k], c]; one
  // thread per (query, channel), P sums in registers, x read once per row.
  for (int s = tid; s < TQ * Cin; s += kThreads) {
    const int qi = s / Cin, c = s - qi * Cin;
    float a[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) a[p] = 0.f;
    const int* nq = nbr + qi * K;
    const float* iq = infl + qi * K * kP;
    for (int k = 0; k < K; ++k) {
      const int nb = nq[k];
      if (nb < 0) continue;
      const float xv = rows.feat(b, nb, c);
#pragma unroll
      for (int p = 0; p < kP; ++p) a[p] = fmaf(iq[k * kP + p], xv, a[p]);
    }
#pragma unroll
    for (int p = 0; p < kP; ++p) acc[qi * PC + p * Cin + c] = Rows::rounded(a[p]);
  }
  __syncthreads();

  // Phase C: out[q, co] = sum_j acc[q, j] * W[j, co] / max(cnt[q], 1).
  for (int co = tid; co < Cout; co += kThreads) {
    float r[TQ];
#pragma unroll
    for (int qi = 0; qi < TQ; ++qi) r[qi] = 0.f;
    for (int j = 0; j < PC; ++j) {
      const float wv = rows.weight((size_t)j * Cout + co);
#pragma unroll
      for (int qi = 0; qi < TQ; ++qi) r[qi] = fmaf(acc[qi * PC + j], wv, r[qi]);
    }
#pragma unroll
    for (int qi = 0; qi < TQ; ++qi) {
      const int q = q0 + qi;
      if (q < Nq) out[((size_t)b * Nq + q) * Cout + co] = r[qi] / (float)max(cnt[qi], 1);
    }
  }
}

template <int TQ, int Infl, class Rows>
cudaError_t launch(const float* q_pts, Rows rows, const int32_t* inds, const float* kp,
                   float* out, int B, int Nq, int Ns, int K, int Cin, int Cout, Mode mode,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(TQ, K, Cin);
  cudaError_t err = cudaFuncSetAttribute(
      kpconv_kernel<TQ, Infl, Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Nq + TQ - 1) / TQ, B);
  kpconv_kernel<TQ, Infl, Rows><<<grid, kThreads, smem, stream>>>(
      q_pts, rows, inds, kp, out, Nq, Ns, K, Cin, Cout, mode);
  return cudaGetLastError();
}

// The CUDA-core kernel at the largest query tile TQ (16/8/4/2/1) whose
// shared memory fits.
template <int Infl, class Rows>
cudaError_t launch_cuda_cores(const float* q_pts, Rows rows, const int32_t* inds,
                              const float* kp, float* out, int B, int Nq, int Ns, int K,
                              int Cin, int Cout, Mode mode, cudaStream_t stream) {
  if (smem_bytes(16, K, Cin) <= kSmemBudget)
    return launch<16, Infl>(q_pts, rows, inds, kp, out, B, Nq, Ns, K, Cin, Cout, mode, stream);
  if (smem_bytes(8, K, Cin) <= kSmemBudget)
    return launch<8, Infl>(q_pts, rows, inds, kp, out, B, Nq, Ns, K, Cin, Cout, mode, stream);
  if (smem_bytes(4, K, Cin) <= kSmemBudget)
    return launch<4, Infl>(q_pts, rows, inds, kp, out, B, Nq, Ns, K, Cin, Cout, mode, stream);
  if (smem_bytes(2, K, Cin) <= kSmemBudget)
    return launch<2, Infl>(q_pts, rows, inds, kp, out, B, Nq, Ns, K, Cin, Cout, mode, stream);
  if (smem_bytes(1, K, Cin) <= kSmemBudget)
    return launch<1, Infl>(q_pts, rows, inds, kp, out, B, Nq, Ns, K, Cin, Cout, mode, stream);
  return cudaErrorInvalidValue;
}

// The tensor-core kernels' tiles: queries per block, channels per chunk (a
// warp's lanes), and the most neighbors a query may have there.
constexpr int kTQ = 32;                 // queries per block
constexpr int kCC = 32;                 // channels per chunk: a warp's lanes
constexpr int kKMax = 40;

}  // namespace
