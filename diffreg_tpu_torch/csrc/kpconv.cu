// Kernel-point convolution forward (linear influence, sum aggregation) for Hopper.
//
// Replaces the Pallas TPU kernel diffreg_tpu/ops/pallas/kpconv_kernel.py:_kernel
// (pallas_call in _fused_kpconv_fwd_impl). Same arithmetic: for each query q and
// each neighbor row n of its fixed-K neighborhood,
//   rel = s[n] - q,  d2_p = max(|rel|^2 + |kp_p|^2 - 2 rel.kp_p, 0),
//   infl_p = max(1 - sqrt(d2_p) / extent, 0),
//   acc[p, c] += infl_p * x[n, c],
// then out[q] = (sum_p acc[p, :] @ W[p]) / max(#neighbors with feature-sum > 0, 1).
//
// Differences from the TPU kernel, and why:
//  * It reads neighbor rows through the [B, Nq, K] index table itself. No
//    [B, K, N, 3+C] gathered tensor is built in device memory (on the TPU XLA
//    materialised it before the kernel ran). An index equal to Ns is the
//    sentinel: it is skipped, which is exact because the shadow row has zero
//    features (it adds nothing to the sum and nothing to the count). Any index
//    outside [0, Ns) is treated as that sentinel, so a bad table cannot read
//    out of bounds.
//  * The [P*Cin] x Cout contraction is done inside the kernel, reading W from
//    global memory (15.7 MB at 512 -> 512, which fits the 50 MB L2), so every
//    layer of the path runs here; Pallas gave up above 4 MB of weights.
//
// What bounds it on an H100: operations. Per real neighbor it does ~13 P
// flops of distances and influences and 2 P Cin of accumulation, and per
// query the 2 P Cin Cout contraction, in f32 on CUDA cores (67 TFLOP/s);
// its bytes (inputs once, output once) take far less time at 3.35 TB/s.
// Design: one block per (pair, tile of TQ queries); the influences, the
// density count and the influence-weighted [TQ, P * Cin] accumulator live in
// shared memory (each x row is read once per query); the contraction reads
// each W element once per block and reuses it for the TQ queries from
// registers. TQ is the largest of 16/8/4/2/1 whose shared memory fits, so
// the deep layers (TQ = 4 at Cin 512) reread W from L2 often; tensor cores
// (wgmma) and larger query tiles are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kP = 15;         // kernel points (KPFCNConfig.num_kernel_points)
constexpr int kThreads = 256;
constexpr size_t kSmemBudget = 200 * 1024;

size_t smem_bytes(int tq, int K, int Cin) {
  return sizeof(float) * ((size_t)tq * kP * Cin + (size_t)tq * K * kP) +
         sizeof(int) * ((size_t)tq * K + tq);
}

template <int TQ>
__global__ void __launch_bounds__(kThreads) kpconv_kernel(
    const float* __restrict__ q_pts, const float* __restrict__ s_pts,
    const int32_t* __restrict__ inds, const float* __restrict__ x,
    const float* __restrict__ kp, const float* __restrict__ w,
    float* __restrict__ out, int Nq, int Ns, int K, int Cin, int Cout,
    float extent) {
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
  const float* xb = x + (size_t)b * Ns * Cin;

  if (tid < kP) {
    const float a = kp[3 * tid], c = kp[3 * tid + 1], d = kp[3 * tid + 2];
    kps[3 * tid] = a;
    kps[3 * tid + 1] = c;
    kps[3 * tid + 2] = d;
    k2s[tid] = a * a + c * c + d * d;
  }
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
    const float* sp = s_pts + ((size_t)b * Ns + nb) * 3;
    const float rx = sp[0] - qp[0], ry = sp[1] - qp[1], rz = sp[2] - qp[2];
    const float n2 = rx * rx + ry * ry + rz * rz;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const float cross = rx * kps[3 * p] + ry * kps[3 * p + 1] + rz * kps[3 * p + 2];
      const float d2 = fmaxf(n2 + k2s[p] - 2.f * cross, 0.f);
      ip[p] = fmaxf(1.f - sqrtf(d2) / extent, 0.f);
    }
  }
  __syncthreads();

  // Phase A2: density count, one warp per (query, neighbor): a neighbor
  // counts iff its feature-sum is positive (the reference's quirk).
  const int warp = tid / 32, lane = tid % 32;
  for (int s = warp; s < TQ * K; s += kThreads / 32) {
    const int nb = nbr[s];
    if (nb < 0) continue;
    const float* row = xb + (size_t)nb * Cin;
    float sum = 0.f;
    for (int c = lane; c < Cin; c += 32) sum += row[c];
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
      const float xv = xb[(size_t)nb * Cin + c];
#pragma unroll
      for (int p = 0; p < kP; ++p) a[p] = fmaf(iq[k * kP + p], xv, a[p]);
    }
#pragma unroll
    for (int p = 0; p < kP; ++p) acc[qi * PC + p * Cin + c] = a[p];
  }
  __syncthreads();

  // Phase C: out[q, co] = sum_j acc[q, j] * W[j, co] / max(cnt[q], 1).
  for (int co = tid; co < Cout; co += kThreads) {
    float r[TQ];
#pragma unroll
    for (int qi = 0; qi < TQ; ++qi) r[qi] = 0.f;
    for (int j = 0; j < PC; ++j) {
      const float wv = __ldg(w + (size_t)j * Cout + co);
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

template <int TQ>
cudaError_t launch(const float* q_pts, const float* s_pts, const int32_t* inds,
                   const float* x, const float* kp, const float* w, float* out,
                   int B, int Nq, int Ns, int K, int Cin, int Cout, float extent,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(TQ, K, Cin);
  cudaError_t err = cudaFuncSetAttribute(
      kpconv_kernel<TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Nq + TQ - 1) / TQ, B);
  kpconv_kernel<TQ><<<grid, kThreads, smem, stream>>>(
      q_pts, s_pts, inds, x, kp, w, out, Nq, Ns, K, Cin, Cout, extent);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q_pts [B, Nq, 3], s_pts [B, Ns, 3], inds [B, Nq, K] int32 (sentinel Ns),
// x [B, Ns, Cin], kp [P, 3], w [P, Cin, Cout], out [B, Nq, Cout]; all f32 and
// contiguous. Returns a cudaError_t (0 on success).
int kpconv_forward(const float* q_pts, const float* s_pts, const int32_t* inds,
                   const float* x, const float* kp, const float* w, float* out,
                   int B, int Nq, int Ns, int K, int Cin, int Cout, int P,
                   float extent, cudaStream_t stream) {
  if (P != kP || B <= 0 || Nq <= 0 || K <= 0 || Cin <= 0 || Cout <= 0)
    return (int)cudaErrorInvalidValue;
  if (smem_bytes(16, K, Cin) <= kSmemBudget)
    return (int)launch<16>(q_pts, s_pts, inds, x, kp, w, out, B, Nq, Ns, K, Cin, Cout, extent, stream);
  if (smem_bytes(8, K, Cin) <= kSmemBudget)
    return (int)launch<8>(q_pts, s_pts, inds, x, kp, w, out, B, Nq, Ns, K, Cin, Cout, extent, stream);
  if (smem_bytes(4, K, Cin) <= kSmemBudget)
    return (int)launch<4>(q_pts, s_pts, inds, x, kp, w, out, B, Nq, Ns, K, Cin, Cout, extent, stream);
  if (smem_bytes(2, K, Cin) <= kSmemBudget)
    return (int)launch<2>(q_pts, s_pts, inds, x, kp, w, out, B, Nq, Ns, K, Cin, Cout, extent, stream);
  if (smem_bytes(1, K, Cin) <= kSmemBudget)
    return (int)launch<1>(q_pts, s_pts, inds, x, kp, w, out, B, Nq, Ns, K, Cin, Cout, extent, stream);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
