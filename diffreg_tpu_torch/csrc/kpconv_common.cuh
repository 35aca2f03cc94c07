// Shared by the KPConv kernels' two libraries, kpconv.cu (f32) and
// kpconv_bf16.cu (the bf16 instance): the influence modes, the CUDA-core
// kernels both use for the shapes their tensor-core kernels do not take, and
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
// The kernel-point count P is the weights' first dimension, as in the Pallas
// kernel. The tuned kernels (the tensor-core kernels and the first CUDA-core
// kernel below) are compiled for P = kP = 15 (the default
// KPFCNConfig.num_kernel_points, every preset's and YAML's): their register
// arrays and shared tiles are sized by it. Any other P reads P at run time:
// the any-P tensor-core kernels (their shared steps at the end of this file)
// at the tuned tensor-core kernels' shapes, the any-P CUDA-core kernel
// (kpconv_any_p_kernel) at every other shape (the first layer, Cin = 1; the
// 2D-3D level 0, K = 64; the narrow layers of the synthetic stories).
//
// The CUDA-core kernel at P = 15 (any other shape; on the main path only the
// first layer, Cin = 1): one block per (pair, tile of TQ queries), reading its
// rows through F32Rows (the bf16 instance's through Bf16Rows); the influences,
// the density count and the influence-weighted [TQ, P * Cin] accumulator live
// in shared memory, and the contraction runs in f32 on CUDA cores, each W
// element read once per block and reused for the TQ queries from registers (TQ
// the largest of 16/8/4/2/1 that fits).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "bf16.cuh"
#include "tf32.cuh"

namespace {

constexpr int kP = 15;         // the kernel-point count the tuned kernels are compiled for
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

// ---- the any-P CUDA-core kernel ----
//
// Every kernel-point count P >= 1, every influence and aggregation mode, any
// K, Cin and Cout (where the any-P tensor-core kernels do not take the shape),
// through the same Rows as the kernel above (so the bf16
// instance rounds where the JAX package's bf16 path rounds). P is a runtime
// parameter: the kernel points, the influences [tq][K][P] and the
// influence-weighted sums live in shared memory, not in registers. Cin is
// taken in chunks of cc channels (cc = Cin unless P x Cin x tq would not fit):
// each chunk's sums are contracted with W's rows of that chunk and added to
// the block's output rows in global memory (a block owns its rows, and a
// thread its columns, so no other thread writes them), which are divided by
// the density count after the last chunk. So a layer is never refused for its
// width; only K x P beyond shared memory at one query (K P > 50,000) is.
//
// The contraction: the sums are stored [P][cc][tq] (the tile's queries
// fastest, tq padded to 4), so a thread that owns an output column reads the
// sums of all its queries for one (p, c) as float4 broadcasts and multiplies
// them by one weight, loaded kAnyWU at a time ahead of their products. Below
// 256 output columns the threads split the kernel points into groups (group g
// takes p = g, g + groups, ...), whose partial sums are added in group order
// through shared memory. A block takes at most kAnyBudget of shared memory
// (two blocks an SM) while it holds more than one query, and fewer than 16
// queries where the grid would be short of two blocks an SM.
constexpr int kAnyTQ = 16;  // the most queries a block of the any-P kernel owns
constexpr int kAnyPB = 8;   // kernel points a thread sums at once (registers)
constexpr int kAnyWU = 8;   // weights a contraction thread loads at once
constexpr size_t kAnyBudget = 110 * 1024;  // shared memory of a block: two an SM

__host__ __device__ constexpr int any_p_stride(int tq) { return (tq + 3) / 4 * 4; }

size_t any_p_smem_bytes(int P, int tq, int cc, int K) {
  return sizeof(float) * ((size_t)P * cc * any_p_stride(tq) + (size_t)kThreads * kAnyTQ +
                          (size_t)tq * K * P + 4 * (size_t)P) +
         sizeof(int) * ((size_t)tq * K + tq);
}

template <int Infl, class Rows>
__global__ void __launch_bounds__(kThreads) kpconv_any_p_kernel(
    const float* __restrict__ q_pts, const Rows rows, const int32_t* __restrict__ inds,
    const float* __restrict__ kp, float* __restrict__ out, int Nq, int Ns, int K, int Cin,
    int Cout, int P, int tq, int cc, Mode mode) {
  extern __shared__ __align__(16) float any_smem[];
  const int ts = any_p_stride(tq);
  float* acc = any_smem;                             // [P][cc][ts]
  float* part = acc + (size_t)P * cc * ts;           // [groups - 1][tq][span] partial sums
  float* infl = part + kThreads * kAnyTQ;            // [tq][K][P]
  float* kps = infl + (size_t)tq * K * P;            // [P][3]
  float* k2s = kps + 3 * P;                          // [P]
  int* nbr = (int*)(k2s + P);                        // [tq][K], -1 = shadow row
  int* cnt = nbr + tq * K;                           // [tq]

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * tq;
  const int tid = threadIdx.x;
  for (int p = tid; p < P; p += kThreads) {
    const float a = kp[3 * p], c = kp[3 * p + 1], d = kp[3 * p + 2];
    kps[3 * p] = a;
    kps[3 * p + 1] = c;
    kps[3 * p + 2] = d;
    k2s[p] = kp_norm2(a, c, d);
  }
  if (tid < tq) cnt[tid] = 0;
  __syncthreads();

  // neighbor index and influence of every (query, neighbor, kernel point):
  // the squared distances first, then (under "closest") their argmin, then
  // the influences in place
  for (int s = tid; s < tq * K; s += kThreads) {
    const int qi = s / K, k = s - qi * K;
    const int q = q0 + qi;
    const int nb = q < Nq ? inds[((size_t)b * Nq + q) * K + k] : Ns;
    float* ip = infl + (size_t)s * P;
    if (nb < 0 || nb >= Ns) {
      nbr[s] = -1;
      for (int p = 0; p < P; ++p) ip[p] = 0.f;
      continue;
    }
    nbr[s] = nb;
    const float* qp = q_pts + ((size_t)b * Nq + q) * 3;
    float px, py, pz;
    rows.pos(b, nb, px, py, pz);
    const float rx = px - qp[0], ry = py - qp[1], rz = pz - qp[2];
    const float n2 = rx * rx + ry * ry + rz * rz;
    int nearest = 0;
    for (int p = 0; p < P; ++p) {
      ip[p] = kp_d2(rx, ry, rz, n2, kps[3 * p], kps[3 * p + 1], kps[3 * p + 2], k2s[p]);
      if (ip[p] < ip[nearest]) nearest = p;
    }
    for (int p = 0; p < P; ++p)
      ip[p] = Rows::rounded(mode.closest && p != nearest ? 0.f : influence_of<Infl>(ip[p], mode));
  }
  __syncthreads();

  // density count, one warp per (query, neighbor), over all Cin channels
  const int warp = tid / 32, lane = tid % 32;
  for (int s = warp; s < tq * K; s += kThreads / 32) {
    const int nb = nbr[s];
    if (nb < 0) continue;
    float sum = 0.f;
    for (int c = lane; c < Cin; c += 32) sum += rows.feat(b, nb, c);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0 && sum > 0.f) atomicAdd(&cnt[s / K], 1);
  }

  // the contraction's threads: column co = tid % span (and co + span, ...),
  // kernel points p = g, g + groups, ... (g = tid / span)
  const int span = min(Cout, kThreads), groups = kThreads / span;
  const int g = tid / span;
  for (int c0 = 0; c0 < Cin; c0 += cc) {
    const int nc = min(cc, Cin - c0);
    const bool last = c0 + cc >= Cin;
    // acc[p, c, q] = sum_k infl[q, k, p] * x[nbr[q, k], c0 + c]; one thread
    // per (query, channel), kAnyPB kernel points at a time in registers
    for (int s = tid; s < tq * nc; s += kThreads) {
      const int qi = s / nc, c = s - qi * nc;
      const int* nq = nbr + qi * K;
      const float* iq = infl + (size_t)qi * K * P;
      float* aq = acc + (size_t)c * ts + qi;
      for (int pb = 0; pb < P; pb += kAnyPB) {
        float a[kAnyPB];
#pragma unroll
        for (int j = 0; j < kAnyPB; ++j) a[j] = 0.f;
        for (int k = 0; k < K; ++k) {
          const int nb = nq[k];
          if (nb < 0) continue;
          const float xv = rows.feat(b, nb, c0 + c);
#pragma unroll
          for (int j = 0; j < kAnyPB; ++j)
            if (pb + j < P) a[j] = fmaf(iq[k * P + pb + j], xv, a[j]);
        }
#pragma unroll
        for (int j = 0; j < kAnyPB; ++j)
          if (pb + j < P) aq[(size_t)(pb + j) * cc * ts] = Rows::rounded(a[j]);
      }
    }
    __syncthreads();

    // out[q, co] (+)= sum_{p, c} acc[p, c, q] * W[p, c0 + c, co]; after the
    // last chunk divided by max(cnt[q], 1)
    for (int co = tid % span; co < Cout; co += span) {
      float r[kAnyTQ];
#pragma unroll
      for (int i = 0; i < kAnyTQ; ++i) r[i] = 0.f;
      for (int p = g; p < P && g < groups; p += groups) {
        const float* ap = acc + (size_t)p * cc * ts;
        for (int cb = 0; cb < nc; cb += kAnyWU) {
          float wv[kAnyWU];
#pragma unroll
          for (int u = 0; u < kAnyWU; ++u)
            wv[u] = cb + u < nc ? rows.weight(((size_t)p * Cin + c0 + cb + u) * Cout + co) : 0.f;
#pragma unroll
          for (int u = 0; u < kAnyWU; ++u) {
            if (cb + u >= nc) break;
            const float4* a4 = reinterpret_cast<const float4*>(ap + (size_t)(cb + u) * ts);
#pragma unroll
            for (int v = 0; v < kAnyTQ / 4; ++v) {
              if (4 * v >= tq) break;
              const float4 a = a4[v];  // one address for the warp
              r[4 * v] = fmaf(a.x, wv[u], r[4 * v]);
              r[4 * v + 1] = fmaf(a.y, wv[u], r[4 * v + 1]);
              r[4 * v + 2] = fmaf(a.z, wv[u], r[4 * v + 2]);
              r[4 * v + 3] = fmaf(a.w, wv[u], r[4 * v + 3]);
            }
          }
        }
      }
      if (groups > 1) {
        // span = Cout <= 128: one column a thread, so every thread meets the
        // barrier once; groups 1, 2, ... hand their sums to group 0
        if (g > 0 && g < groups)
#pragma unroll
          for (int i = 0; i < kAnyTQ; ++i)
            if (i < tq) part[((g - 1) * tq + i) * span + co] = r[i];
        __syncthreads();
        if (g == 0)
          for (int o = 1; o < groups; ++o)
#pragma unroll
            for (int i = 0; i < kAnyTQ; ++i)
              if (i < tq) r[i] += part[((o - 1) * tq + i) * span + co];
      }
      if (g != 0) continue;
#pragma unroll
      for (int i = 0; i < kAnyTQ; ++i) {
        const int q = q0 + i;
        if (i >= tq || q >= Nq) continue;
        float* o = out + ((size_t)b * Nq + q) * Cout + co;
        const float v = (c0 == 0 ? 0.f : *o) + r[i];
        *o = last ? v / (float)max(cnt[i], 1) : v;
      }
    }
    __syncthreads();  // the chunk's sums are consumed before the next chunk's
  }
}

// The any-P kernel at the most queries a block (16/8/4/2/1) whose influences
// fit beside a chunk of at least min(Cin, 32) channels within kAnyBudget, so
// that two blocks share an SM; else one query a block with any chunk that fits
// kSmemBudget.
template <int Infl, class Rows>
cudaError_t launch_any_p(const float* q_pts, Rows rows, const int32_t* inds, const float* kp,
                         float* out, int B, int Nq, int Ns, int K, int Cin, int Cout, int P,
                         Mode mode, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // fewer queries a block where 16 would leave the grid short of two blocks an SM
  int most = kAnyTQ;
  while (most > 4 && (long long)((Nq + most - 1) / most) * B < 2LL * sms) most /= 2;
  for (int tq = most; tq >= 1; tq /= 2) {
    const size_t budget = tq > 1 ? kAnyBudget : kSmemBudget;
    const size_t fixed = any_p_smem_bytes(P, tq, 0, K);
    const size_t per_channel = sizeof(float) * any_p_stride(tq) * P;
    if (fixed + per_channel > budget) continue;
    const int cc = (int)std::min<size_t>(Cin, (budget - fixed) / per_channel);
    if (cc < std::min(Cin, 32) && tq > 1) continue;
    const size_t smem = any_p_smem_bytes(P, tq, cc, K);
    err = cudaFuncSetAttribute(
        kpconv_any_p_kernel<Infl, Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Nq + tq - 1) / tq, B);
    kpconv_any_p_kernel<Infl, Rows><<<grid, kThreads, smem, stream>>>(
        q_pts, rows, inds, kp, out, Nq, Ns, K, Cin, Cout, P, tq, cc, mode);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

// The tensor-core kernels' tiles: queries per block, channels per chunk (a
// warp's lanes), and the most neighbors a query may have there.
constexpr int kTQ = 32;                 // queries per block
constexpr int kCC = 32;                 // channels per chunk: a warp's lanes
constexpr int kKMax = 40;

// ---- the any-P tensor-core kernels' shared steps ----
//
// kpconv.cu and kpconv_bf16.cu each have a tensor-core kernel for every
// kernel-point count P but 15 at the tuned kernels' shapes (Cin % 32 == 0, K
// <= 40, Cout in {64, 128, 256, 512}; f32 also Cin >= 64). Both run P in
// chunks of kPC = 16 kernel points, the last chunk padded with zero
// influences, and Cin in chunks of kXC = 16 channels. For each chunk of
// points the block computes the influences of its 32 queries' neighbours,
// [query][point][neighbour] in shared memory; for each chunk of channels each
// warp builds the A rows of 4 queries on tensor cores, A_q[16 points x 16
// channels] = infl_q^T[16 x K] X_q[K x 16] (kernel points on the 16 M rows of
// the product, neighbours on its k), then every warp contracts the A chunk
// with its columns of W on tensor cores, 32 x Cout accumulators in registers
// across all chunks. The density count's feature sums come from the first
// chunk of points' X fragments.
constexpr int kPC = 16;  // kernel points a chunk: the A products' 16 rows
constexpr int kXC = 16;  // channels a chunk
constexpr size_t kTcSmemMax = 227 * 1024;  // shared memory a block may take

// Which kernel a KPConv entry launched (*route): the tuned kernels (P = 15:
// the tensor-core kernel or its CUDA-core kernel), the any-P tensor-core
// kernel, or the any-P CUDA-core kernel.
enum Route { kRouteTuned = 0, kRouteAnyPTensorCores = 1, kRouteAnyPCudaCores = 2 };

// The influence of a kernel point at squared distance d2, the mode a runtime
// value (the any-P tensor-core kernels are one instance for every mode).
__device__ __forceinline__ float influence_rt(float d2, const Mode& mode, int kind) {
  if (kind == kLinear) return influence_of<kLinear>(d2, mode);
  if (kind == kConstant) return 1.f;
  return influence_of<kGaussian>(d2, mode);
}

// Kernel points [P] as (x, y, z, |kp|^2) into shared memory.
__device__ __forceinline__ void load_kernel_points_any(const float* kp, float4* kps, int P) {
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const float a = kp[3 * p], c = kp[3 * p + 1], d = kp[3 * p + 2];
    kps[p] = make_float4(a, c, d, kp_norm2(a, c, d));
  }
}

// A neighbour's offset from its query: (x, y, z, |.|^2).
template <class Rows>
__device__ __forceinline__ float4 neighbour_offset(const float* q_pts, const Rows& rows, int b,
                                                   int q, int nb, int Nq) {
  const float* qp = q_pts + ((size_t)b * Nq + q) * 3;
  float px, py, pz;
  rows.pos(b, nb, px, py, pz);
  const float rx = px - qp[0], ry = py - qp[1], rz = pz - qp[2];
  return make_float4(rx, ry, rz, rx * rx + ry * ry + rz * rz);
}

// The block's neighbour table nbr [TQ][K] (-1: shadow row or out of range),
// under "closest" each neighbour's nearest kernel point over all P (the first
// of equal ones), and the feature sums zeroed.
template <class Rows>
__device__ void any_p_neighbours(const float* q_pts, const Rows& rows, const int32_t* inds,
                                 const float4* kps, int P, int b, int q0, int Nq, int Ns, int K,
                                 const Mode& mode, int* nbr, int* nearest, float* fsum) {
  for (int s = threadIdx.x; s < kTQ * K; s += blockDim.x) {
    const int qi = s / K, k = s - qi * K;
    const int q = q0 + qi;
    const int nb = q < Nq ? inds[((size_t)b * Nq + q) * K + k] : Ns;
    const bool real = nb >= 0 && nb < Ns;
    nbr[s] = real ? nb : -1;
    fsum[s] = 0.f;
    int near = 0;
    if (mode.closest && real) {
      const float4 r = neighbour_offset(q_pts, rows, b, q, nb, Nq);
      float best = 0.f;
      for (int p = 0; p < P; ++p) {
        const float4 kq = kps[p];
        const float d2 = kp_d2(r.x, r.y, r.z, r.w, kq.x, kq.y, kq.z, kq.w);
        if (p == 0 || d2 < best) {
          best = d2;
          near = p;
        }
      }
    }
    nearest[s] = near;
  }
}

// The influences of kernel points [pc0, pc0 + npc) on the block's neighbours,
// infl[q][p][k] (row stride kst; k < kpad, zero past K, for missing
// neighbours and for the chunk's pad points), rounded as Rows rounds them and
// stored as T.
template <class T, class Rows>
__device__ void chunk_influences(T* infl, int kst, int kpad, const float* q_pts, const Rows& rows,
                                 const float4* kps, const int* nbr, const int* nearest, int b,
                                 int q0, int Nq, int K, int pc0, int npc, const Mode& mode,
                                 int kind) {
  for (int s = threadIdx.x; s < kTQ * kpad; s += blockDim.x) {
    const int qi = s / kpad, k = s - qi * kpad;
    const int nb = k < K ? nbr[qi * K + k] : -1;
    float f[kPC];
#pragma unroll
    for (int p = 0; p < kPC; ++p) f[p] = 0.f;
    if (nb >= 0) {
      const float4 r = neighbour_offset(q_pts, rows, b, q0 + qi, nb, Nq);
      const int near = nearest[qi * K + k];
#pragma unroll
      for (int p = 0; p < kPC; ++p) {
        if (p >= npc) break;
        const float4 kq = kps[pc0 + p];
        const float d2 = kp_d2(r.x, r.y, r.z, r.w, kq.x, kq.y, kq.z, kq.w);
        f[p] = mode.closest && pc0 + p != near ? 0.f : influence_rt(d2, mode, kind);
      }
    }
    T* ip = infl + (size_t)qi * kPC * kst + k;
#pragma unroll
    for (int p = 0; p < kPC; ++p) ip[p * kst] = T(Rows::rounded(f[p]));
  }
}

// The density count from the feature sums: a neighbour counts iff its
// feature-sum is positive (the reference's quirk).
__device__ __forceinline__ void any_p_counts(const int* nbr, const float* fsum, int K, int* cnt) {
  if (threadIdx.x < kTQ) {
    int n_pos = 0;
    for (int k = 0; k < K; ++k) {
      const int s = threadIdx.x * K + k;
      n_pos += nbr[s] >= 0 && fsum[s] > 0.f;
    }
    cnt[threadIdx.x] = n_pos;
  }
}

}  // namespace
