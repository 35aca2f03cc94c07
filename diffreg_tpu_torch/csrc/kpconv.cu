// Kernel-point convolution forward (linear influence, sum aggregation) for Hopper,
// in f32 (kpconv_forward) and in the JAX package's bf16 compute path
// (kpconv_forward_bf16, described above its kernels below).
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
// flops of distances and influences and 2 P Cin of aggregation on CUDA cores
// (67 TFLOP/s f32), and per query the 2 P Cin Cout contraction, which for
// Cin >= 64 runs on tensor cores (495 TFLOP/s dense TF32, of which 3xTF32's
// three products leave at most a third); its bytes (inputs once, output once)
// take far less time at 3.35 TB/s.
//
// Two paths behind one entry point, chosen by shape:
//  * Cin >= 64 (with Cin % 32 == 0, K <= 40 and Cout in {64, 128, 256, 512}):
//    the tensor-core kernel. A block owns 32 queries and all of Cout; out[q] =
//    A[q, P Cin] . W[P Cin, Cout], with A the influence-weighted features.
//    A is built on CUDA cores in shared memory one chunk of 32 channels at a
//    time (all 15 kernel points): each warp builds the rows of 4 queries with
//    a lane per channel, so a neighbor row is read as one 128-byte line and
//    the influences are read once per warp (broadcast). The same loads give
//    the feature-sums of the density count (summed over the chunks, then over
//    the lanes by a 62-shuffle reduce-scatter). Each chunk is then multiplied
//    by its W rows on tensor cores, mma.sync m16n8k8 TF32 in 3xTF32 (hi/lo
//    split as the fragments are loaded, tf32.cuh): warp w owns output columns
//    [Cout w / 8, Cout (w + 1) / 8) of the 32 queries and stages exactly those
//    columns of W with cp.async in a ring of its own, several k-steps ahead,
//    so its k-steps need no block barrier (the block meets twice per chunk).
//    W is read once per 32 queries, and the 32 x Cout accumulators (64 per
//    thread at Cout 512) stay in registers, so the aggregation is done once.
//    When the grid is short of two waves (Nq <= 1536 at 4 pairs), the kernel
//    points are split between two blocks per query tile (0-7 and 8-14) that
//    add their partial results into a zeroed output with atomicAdd; with two
//    addends onto zero the sum does not depend on their order.
//  * any other shape (on the main path only the first layer, Cin = 1): one
//    block per (pair, tile of TQ queries), reading its rows through F32Rows
//    (the bf16 instance's through Bf16Rows); the influences, the density
//    count and the influence-weighted [TQ, P * Cin] accumulator live in shared
//    memory, and the contraction runs in f32 on CUDA cores, each W element
//    read once per block and reused for the TQ queries from registers (TQ
//    the largest of 16/8/4/2/1 that fits).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16.cuh"
#include "tf32.cuh"

namespace {

constexpr int kP = 15;         // kernel points (KPFCNConfig.num_kernel_points)
constexpr int kThreads = 256;
constexpr size_t kSmemBudget = 200 * 1024;

// Kernel points to shared memory: kps [P][3] and their squared norms k2s [P].
__device__ __forceinline__ void load_kernel_points(const float* kp, float* kps, float* k2s) {
  const int tid = threadIdx.x;
  if (tid < kP) {
    const float a = kp[3 * tid], c = kp[3 * tid + 1], d = kp[3 * tid + 2];
    kps[3 * tid] = a;
    kps[3 * tid + 1] = c;
    kps[3 * tid + 2] = d;
    k2s[tid] = a * a + c * c + d * d;
  }
}

// Linear influence of kernel point p on a neighbor at offset r (|r|^2 = n2)
// from its query, computed as the JAX package does: d2 = |r|^2 + |kp|^2 - 2 r.kp.
__device__ __forceinline__ float influence(float rx, float ry, float rz, float n2,
                                           const float* kps, const float* k2s, int p,
                                           float extent) {
  const float cross = rx * kps[3 * p] + ry * kps[3 * p + 1] + rz * kps[3 * p + 2];
  const float d2 = fmaxf(n2 + k2s[p] - 2.f * cross, 0.f);
  return fmaxf(1.f - sqrtf(d2) / extent, 0.f);
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

template <int TQ, class Rows>
__global__ void __launch_bounds__(kThreads) kpconv_kernel(
    const float* __restrict__ q_pts, const Rows rows, const int32_t* __restrict__ inds,
    const float* __restrict__ kp, float* __restrict__ out, int Nq, int Ns, int K, int Cin,
    int Cout, float extent) {
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
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      ip[p] = Rows::rounded(influence(rx, ry, rz, n2, kps, k2s, p, extent));
    }
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

template <int TQ, class Rows>
cudaError_t launch(const float* q_pts, Rows rows, const int32_t* inds, const float* kp,
                   float* out, int B, int Nq, int Ns, int K, int Cin, int Cout, float extent,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(TQ, K, Cin);
  cudaError_t err = cudaFuncSetAttribute(
      kpconv_kernel<TQ, Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Nq + TQ - 1) / TQ, B);
  kpconv_kernel<TQ, Rows><<<grid, kThreads, smem, stream>>>(
      q_pts, rows, inds, kp, out, Nq, Ns, K, Cin, Cout, extent);
  return cudaGetLastError();
}

// The CUDA-core kernel at the largest query tile TQ (16/8/4/2/1) whose
// shared memory fits.
template <class Rows>
cudaError_t launch_cuda_cores(const float* q_pts, Rows rows, const int32_t* inds,
                              const float* kp, float* out, int B, int Nq, int Ns, int K,
                              int Cin, int Cout, float extent, cudaStream_t stream) {
  if (smem_bytes(16, K, Cin) <= kSmemBudget)
    return launch<16>(q_pts, rows, inds, kp, out, B, Nq, Ns, K, Cin, Cout, extent, stream);
  if (smem_bytes(8, K, Cin) <= kSmemBudget)
    return launch<8>(q_pts, rows, inds, kp, out, B, Nq, Ns, K, Cin, Cout, extent, stream);
  if (smem_bytes(4, K, Cin) <= kSmemBudget)
    return launch<4>(q_pts, rows, inds, kp, out, B, Nq, Ns, K, Cin, Cout, extent, stream);
  if (smem_bytes(2, K, Cin) <= kSmemBudget)
    return launch<2>(q_pts, rows, inds, kp, out, B, Nq, Ns, K, Cin, Cout, extent, stream);
  if (smem_bytes(1, K, Cin) <= kSmemBudget)
    return launch<1>(q_pts, rows, inds, kp, out, B, Nq, Ns, K, Cin, Cout, extent, stream);
  return cudaErrorInvalidValue;
}

// ---- the tensor-core path (Cin >= 64) ----

constexpr int kTQ = 32;                 // queries per block
constexpr int kCC = 32;                 // channels per chunk: a warp's lanes
constexpr int kPP = 16;                 // influence row, padded for float4 loads
constexpr int kKMax = 40;               // neighbors per query the path takes
constexpr int kAStride = kP * kCC + 4;  // A chunk row stride (floats): no bank conflicts
constexpr int kWarps = kThreads / 32;
constexpr int kQW = kTQ / kWarps;       // queries whose A rows a warp builds

// Each warp stages its own 8 NT columns of W (Cout = 64 NT), U k-steps (8
// rows each) per cp.async group, G groups in its ring.
template <int NT> __host__ __device__ constexpr int w_unit() { return NT <= 2 ? 4 : 2; }
template <int NT> __host__ __device__ constexpr int w_groups() { return NT == 8 ? 2 : 3; }
template <int NT> __host__ __device__ constexpr int w_stride() { return NT == 1 ? 24 : 8 * NT + 8; }

template <int NT>
size_t tc_smem_bytes(int K) {
  return sizeof(float) * ((size_t)kTQ * K * kPP + (size_t)kTQ * kAStride +
                          (size_t)kWarps * w_groups<NT>() * w_unit<NT>() * 8 * w_stride<NT>()) +
         sizeof(int) * ((size_t)kTQ * K + kTQ);
}

// Sum v over the warp's 32 lanes, 64 values at once (a reduce-scatter: 62
// shuffles); on return v[0] and v[1] hold the totals of entries 2 lane and
// 2 lane + 1.
template <int O>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[64], int lane) {
  constexpr int kHalf = 2 * O;  // 4 O values are live at this step
  const bool up = lane & O;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = up ? v[i] : v[i + kHalf];
    const float keep = up ? v[i + kHalf] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

__device__ __forceinline__ void warp_reduce_scatter64(float (&v)[64], int lane) {
  reduce_scatter_step<16>(v, lane);
  reduce_scatter_step<8>(v, lane);
  reduce_scatter_step<4>(v, lane);
  reduce_scatter_step<2>(v, lane);
  reduce_scatter_step<1>(v, lane);
}

// Blocks (tile, pair, split). Warp w builds the A rows of queries [4 w, 4 w + 4)
// (lane = channel), and owns output columns [8 NT w, 8 NT (w + 1)) of all 32
// queries (two 16-row m-tiles); it stages exactly those columns of W, so its
// k-steps need no block barrier. With two splits, split z takes kernel points
// [8 z, min(8 z + 8, P)) of every chunk.
template <int NT>
__global__ void __launch_bounds__(kThreads) kpconv_tc_kernel(
    const float* __restrict__ q_pts, const float* __restrict__ s_pts,
    const int32_t* __restrict__ inds, const float* __restrict__ x,
    const float* __restrict__ kp, const float* __restrict__ w,
    float* __restrict__ out, int Nq, int Ns, int K, int Cin, float extent) {
  constexpr int kCout = 64 * NT, kU = w_unit<NT>(), kG = w_groups<NT>(), kWS = w_stride<NT>();
  extern __shared__ __align__(16) float tc_smem[];
  float* infl = tc_smem;                                   // [TQ][K][PP]
  float* abuf = infl + kTQ * K * kPP;                      // [TQ][kAStride]
  float* wbuf = abuf + kTQ * kAStride;                     // [warp][G][U * 8][kWS]
  int* nbr = (int*)(wbuf + kWarps * kG * kU * 8 * kWS);    // [TQ][K], -1 = shadow row
  int* cnt = nbr + kTQ * K;                                // [TQ]
  __shared__ float kps[kP * 3];
  __shared__ float k2s[kP];

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTQ;
  const int p0 = gridDim.z > 1 ? 8 * blockIdx.z : 0;
  const int np = gridDim.z > 1 ? min(8, kP - p0) : kP;
  const int n_chunks = Cin / kCC;
  const int chunk_groups = np * (kCC / 8) / kU;            // W groups per chunk
  const int n_groups = n_chunks * chunk_groups;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int col_w = warp * 8 * NT;                         // the warp's first column
  const float* xb = x + (size_t)b * Ns * Cin;
  float* wring = wbuf + warp * kG * kU * 8 * kWS;

  // k-step s of a chunk multiplies A columns [8 s, 8 s + 8) (kernel point
  // p0 + s / 4, channels 8 (s % 4) .. + 8 of the chunk) by the matching 8 W
  // rows; W group gi holds k-steps [U gi', U gi' + U) of chunk gi / chunk_groups
  // (gi' = gi % chunk_groups), columns [col_w, col_w + 8 NT).
  auto load_w = [&](int gi) {
    if (gi < n_groups) {
      const int ch = gi / chunk_groups, s = kU * (gi - ch * chunk_groups);
      const int p = p0 + s / (kCC / 8);
      const float* src =
          w + ((size_t)p * Cin + kCC * ch + 8 * (s % (kCC / 8))) * kCout + col_w;
      float* dst = wring + (gi % kG) * kU * 8 * kWS;
#pragma unroll
      for (int i = lane; i < kU * 8 * 2 * NT; i += 32) {
        const int r = i / (2 * NT), c = 4 * (i - r * 2 * NT);
        cp_async16(dst + r * kWS + c, src + (size_t)r * kCout + c, true);
      }
    }
    cp_async_commit();
  };
  for (int gi = 0; gi < kG - 1; ++gi) load_w(gi);  // in flight during the influences

  load_kernel_points(kp, kps, k2s);
  __syncthreads();

  // neighbor index and influence of every (query, neighbor, kernel point)
#pragma unroll 4
  for (int s = tid; s < kTQ * K; s += kThreads) {  // branch-free, so loads overlap
    const int qi = s / K, k = s - qi * K;
    const int q = min(q0 + qi, Nq - 1);
    const int nb = q0 + qi < Nq ? inds[((size_t)b * Nq + q) * K + k] : Ns;
    const bool real = nb >= 0 && nb < Ns;
    nbr[s] = real ? nb : -1;
    const float* qp = q_pts + ((size_t)b * Nq + q) * 3;
    const float* sp = s_pts + ((size_t)b * Ns + (real ? nb : 0)) * 3;
    const float rx = sp[0] - qp[0], ry = sp[1] - qp[1], rz = sp[2] - qp[2];
    const float n2 = rx * rx + ry * ry + rz * rz;
    float4* ip = reinterpret_cast<float4*>(infl + s * kPP);
#pragma unroll
    for (int j = 0; j < kPP / 4; ++j) {
      float f[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = 4 * j + i;
        if (p < kP) {
          f[i] = real ? influence(rx, ry, rz, n2, kps, k2s, p, extent) : 0.f;
        } else {
          f[i] = 0.f;
        }
      }
      ip[j] = make_float4(f[0], f[1], f[2], f[3]);
    }
  }
  __syncthreads();

  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;

  // rs[i][j]: this lane's share of the feature-sum of neighbor 2 lane + j of
  // the warp's query i, summed over the chunks (for the density count)
  float rs[kQW][2];
#pragma unroll
  for (int i = 0; i < kQW; ++i) rs[i][0] = rs[i][1] = 0.f;

  for (int ch = 0; ch < n_chunks; ++ch) {
    // A[q][32 p + c] = sum_k infl[q, k, p] * x[nbr[q, k], 32 ch + c]
#pragma unroll 1
    for (int i = 0; i < kQW; ++i) {
      const int aq = kQW * warp + i;
      const int* nq = nbr + aq * K;
      const float4* iq = reinterpret_cast<const float4*>(infl + aq * K * kPP);
      const float* xc = xb + kCC * ch + lane;
      float xv[64];
#pragma unroll
      for (int k = 0; k < 64; ++k) {  // all gathered loads in flight at once
        const int nb = k < kKMax && k < K ? nq[k] : -1;
        xv[k] = nb >= 0 ? __ldg(xc + (size_t)nb * Cin) : 0.f;  // shadow: infl 0
      }
      float av[kPP];
#pragma unroll
      for (int p = 0; p < kPP; ++p) av[p] = 0.f;
#pragma unroll
      for (int k = 0; k < kKMax; ++k) {
        if (k >= K) break;
#pragma unroll
        for (int j = 0; j < kPP / 4; ++j) {
          const float4 f = iq[k * (kPP / 4) + j];  // one address for the warp
          av[4 * j] = fmaf(f.x, xv[k], av[4 * j]);
          av[4 * j + 1] = fmaf(f.y, xv[k], av[4 * j + 1]);
          av[4 * j + 2] = fmaf(f.z, xv[k], av[4 * j + 2]);
          av[4 * j + 3] = fmaf(f.w, xv[k], av[4 * j + 3]);
        }
      }
#pragma unroll
      for (int p = 0; p < kP; ++p) abuf[aq * kAStride + p * kCC + lane] = av[p];
      warp_reduce_scatter64(xv, lane);
      rs[i][0] += xv[0];
      rs[i][1] += xv[1];
    }
    __syncthreads();  // the A chunk is complete

    for (int gl = 0; gl < chunk_groups; ++gl) {
      const int gi = ch * chunk_groups + gl;
      cp_async_wait<kG - 2>();
      __syncwarp();  // the warp's W group gi is in place; group gi - 1 is consumed
      load_w(gi + kG - 1);
      const float* wg = wring + (gi % kG) * kU * 8 * kWS + g;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float* as = abuf + 8 * (kU * gl + u) + (p0 * kCC);
        const float* ws = wg + u * 8 * kWS;
        uint32_t ah[2][4], al[2][4];
        load_a_3xtf32(as, kAStride, g, t, ah[0], al[0]);
        load_a_3xtf32(as + 16 * kAStride, kAStride, g, t, ah[1], al[1]);
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          split_tf32(ws[t * kWS + 8 * n], bh[n][0], bl[n][0]);
          split_tf32(ws[(t + 4) * kWS + 8 * n], bh[n][1], bl[n][1]);
        }
        // each k-step's three products are summed in the tensor core from zero
        // and added to the accumulator in f32 (mma_3xtf32_add): accumulating
        // 960 to 3,840 k-steps in the tensor core itself lost f32 accuracy
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n)
            mma_3xtf32_add(acc[m][n], ah[m], al[m], bh[n][0], bh[n][1], bl[n][0], bl[n][1]);
      }
    }
    __syncthreads();  // the A chunk is consumed before the next one is built
  }
  cp_async_wait<0>();

  // density count: a neighbor counts iff its feature-sum is positive (the
  // reference's quirk)
#pragma unroll
  for (int i = 0; i < kQW; ++i) {
    const int aq = kQW * warp + i;
    int n_pos = 0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = 2 * lane + j;
      n_pos += k < K && nbr[aq * K + k] >= 0 && rs[i][j] > 0.f;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) n_pos += __shfl_xor_sync(0xffffffffu, n_pos, off);
    if (lane == 0) cnt[aq] = n_pos;
  }
  __syncthreads();

  // out[q, col] = acc / max(cnt[q], 1)
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = 16 * m + g + 8 * h;
      const int q = q0 + qi;
      if (q >= Nq) continue;
      const float den = (float)max(cnt[qi], 1);
      float* orow = out + ((size_t)b * Nq + q) * kCout + col_w + 2 * t;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float v0 = acc[m][n][2 * h] / den, v1 = acc[m][n][2 * h + 1] / den;
        if (split) {
          atomicAdd(orow + 8 * n, v0);
          atomicAdd(orow + 8 * n + 1, v1);
        } else {
          *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(v0, v1);
        }
      }
    }
  }
}

template <int NT>
cudaError_t launch_tc(const float* q_pts, const float* s_pts, const int32_t* inds,
                      const float* x, const float* kp, const float* w, float* out,
                      int B, int Nq, int Ns, int K, int Cin, float extent,
                      cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<NT>(K);
  cudaError_t err = cudaFuncSetAttribute(
      kpconv_tc_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kpconv_tc_kernel<NT>,
                                                           kThreads, smem)) != cudaSuccess)
    return err;
  const int tiles = (Nq + kTQ - 1) / kTQ;
  // split the kernel points in two when the grid is short of two waves
  const int splits = tiles * B < 2 * sms * per_sm ? 2 : 1;
  if (splits > 1 && (err = cudaMemsetAsync(out, 0, sizeof(float) * B * Nq * 64 * NT,
                                           stream)) != cudaSuccess)
    return err;
  dim3 grid(tiles, B, splits);
  kpconv_tc_kernel<NT><<<grid, kThreads, smem, stream>>>(
      q_pts, s_pts, inds, x, kp, w, out, Nq, Ns, K, Cin, extent);
  return cudaGetLastError();
}

// ---- the bf16 instance (compute_dtype bfloat16) ----
//
// The JAX package's bf16 KPConv (diffreg_tpu/ops/kpconv.py:kpconv with
// compute_dtype; the Pallas kernel has no bf16 path). It reads a bf16
// support table [B, Ns + 1, 8 + Cin] of rows [hi(pos), lo(pos), 0, 0,
// features] (the wrapper builds it from JAX's [hi, lo, features] table with
// the features moved to a 16-byte boundary; row Ns is the shadow row),
// rebuilds each neighbour's position in f32 as hi + lo, computes the
// influence in f32 and rounds it to bf16, sums influence x feature over the
// neighbours in f32 (each product of two bf16 values is exact in f32) and
// rounds that sum to bf16, then contracts it with the bf16 weights
// accumulating in f32, and divides by the density count (feature sums of the
// bf16 features in f32). Two paths:
//  * Cin a multiple of 32, K <= 40, Cout in {64, 128, 256, 512}: the
//    tensor-core kernel below.
//  * any other shape (on the main path the first layer, Cin = 1): the
//    CUDA-core kernel of the f32 path, reading the table through Bf16Rows,
//    which applies the same roundings.
//
// The tensor-core kernel. What bounds it on an H100: operations, both
// products on the bf16 tensor cores (989 TFLOP/s dense): the aggregation
// (2 P Cin per real neighbour) and the contraction (2 P Cin Cout per query).
// The first version built the influence-weighted sums A on CUDA cores (16
// FMAs and unpacks per lane per neighbour: 62-78% of each layer's time) and
// left the k-steps waiting at two block barriers per chunk: 4.80 ms an
// encode (NVIDIA H100 80GB HBM3, 700 W). This one (1.93 ms on that card):
//  * builds A on tensor cores. A query's chunk of 32 channels is a product,
//    A_q[16 x 32] = infl_q^T[16 x Kp] X_q[Kp x 32]: kernel points (15, padded
//    to 16) by neighbours (K padded to Kp, a multiple of 16) by channels,
//    mma.sync m16n8k16 with f32 accumulation, rounded to bf16 into the A
//    chunk. infl_q^T is computed once per block, rounded to bf16, and kept in
//    registers as A fragments (4 queries x 3 k-steps x 4 registers);
//  * stages the gathered rows X_q in shared memory with 16-byte cp.async (the
//    table's features start at a 16-byte boundary) and reads them with
//    ldmatrix.trans; the same rows give the density count's feature sums
//    (a lane per neighbour, in f32);
//  * splits the block's 16 warps by role: 8 producer warps gather and build
//    chunk c + 1 (4 queries each, the next query's rows in flight during
//    this one's products) into one half of a double-buffered A chunk, while
//    8 consumer warps contract chunk c from the other half with W on tensor
//    cores; one block barrier per chunk. The consumers compute half of the
//    influences while the producers compute the other half;
//  * gives every consumer warp 64 output columns (8 n-tiles, 32 mma.sync per
//    kernel point) and a share of the kernel points: all 15 at Cout = 512,
//    every 8 / NT-th below it (split-K), the shares' partial sums added in
//    warp order at the end. Each warp stages its W rows (16 x 64) with
//    cp.async two k-steps ahead. At Cout 64 and 128 a warp that owned 8 or
//    16 columns of all points waited on W loads for 4-8 products a load;
//  * accumulates the contraction in the tensor core's f32 accumulators. Its
//    accumulation does not round to nearest, so adding in f32 on CUDA cores
//    after each kernel point's two k-steps was measured against it at the
//    encode's 10 tensor-core layers: the largest error against the plain
//    bf16 version was 1.490e-4 of max |plain| both ways (the bf16 roundings
//    of A set it), and the tensor-core sum was 7% faster (NVIDIA H100 80GB HBM3,
//    700 W; PERF.md §6).
// When the grid is short of two waves the kernel points are split between
// two blocks per query tile (0-7 and 8-14) that add their partial results
// into a zeroed output with atomicAdd (two addends onto zero: the sum does
// not depend on their order).

constexpr int kBAStride = kP * kCC + 8;  // bf16 A chunk row stride: 976 B, no bank conflicts
constexpr int kPointSteps = 2;           // k-steps of a kernel point (32 channels)
constexpr int kXS = kCC + 8;             // gathered row stride (bf16): 80 B, no bank conflicts
constexpr int kKPadMax = 48;             // K <= 40 padded to a multiple of 16
constexpr int kBWarps = 16;              // 8 consumer warps, then 8 producer warps
constexpr int kBThreads = 32 * kBWarps;
constexpr int kPQ = kTQ / 8;             // queries a producer warp builds

constexpr int kBG = 4;                   // W ring of a consumer warp: k-steps of 16 rows
constexpr int kWSB = 64 + 8;             // W ring row stride (bf16): 144 B, no bank conflicts
constexpr int kXR = 2;                   // gathered-row slots of a producer warp

size_t tc_bf16_smem_bytes(int kpad, int K) {
  return sizeof(__nv_bfloat16) * ((size_t)2 * kTQ * kBAStride + (size_t)8 * kBG * 16 * kWSB +
                                  (size_t)8 * kXR * kpad * kXS) +
         sizeof(int) * ((size_t)kTQ * K + kTQ);
}

// ldmatrix.x4.trans: the B fragments of two adjacent 8-column n-tiles over 16
// k rows of a k-major shared tile; lane l passes the address of row l % 8 +
// 8 ((l / 8) % 2) at column offset 8 (l / 16).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& b0, uint32_t& b1, uint32_t& b2,
                                                  uint32_t& b3, const void* row) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
               : "r"(s));
}

// The block barrier of kpconv_tc_bf16_kernel, reached by the producer and the
// consumer warps at different places in the code: the non-aligned form,
// which does not require every thread to execute the same instruction.
__device__ __forceinline__ void role_barrier() {
  asm volatile("barrier.sync 1, %0;\n" ::"n"(kBThreads) : "memory");
}

// The A fragments (mma.sync m16n8k16) of infl_q^T for one query, k-step ks
// covering neighbours [16 ks, 16 ks + 16): rows are kernel points, columns
// neighbours; lane (g, t) holds kernel points g and g + 8 (the pad point 15
// is zero) at neighbours 16 ks + 2 t + {0, 1, 8, 9}; an influence computed
// in f32 from the neighbour's offset (rel: x, y, z, |.|^2) and rounded to
// bf16, zero past K and for a missing neighbour (nbr < 0).
__device__ __forceinline__ void influence_fragments(uint32_t (&a)[kKPadMax / 16][4],
                                                    const float4* rel, const int* nbr,
                                                    const float* kp, int K, int ksteps,
                                                    float extent, int g, int t) {
  float kpl[6], k2l[2];  // the lane's kernel points g and g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = min(g + 8 * h, kP - 1);
    const float x = __ldg(kp + 3 * p), y = __ldg(kp + 3 * p + 1), z = __ldg(kp + 3 * p + 2);
    kpl[3 * h] = x;
    kpl[3 * h + 1] = y;
    kpl[3 * h + 2] = z;
    k2l[h] = x * x + y * y + z * z;
  }
#pragma unroll
  for (int ks = 0; ks < kKPadMax / 16; ++ks) {
    float f[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 16 * ks + 2 * t + (e & 1) + 8 * (e >> 1);
      if (ks < ksteps && k < K && nbr[k] >= 0) {
        const float4 r = rel[k];
        f[e][0] = influence(r.x, r.y, r.z, r.w, kpl, k2l, 0, extent);
        if (g + 8 < kP) f[e][1] = influence(r.x, r.y, r.z, r.w, kpl, k2l, 1, extent);
      }
    }
    a[ks][0] = pack_bf16(f[0][0], f[1][0]);
    a[ks][1] = pack_bf16(f[0][1], f[1][1]);
    a[ks][2] = pack_bf16(f[2][0], f[3][0]);
    a[ks][3] = pack_bf16(f[2][1], f[3][1]);
  }
}

// Blocks (tile, pair, split). Consumer warp w (0-7) owns output columns
// [64 (w / G), 64 (w / G) + 64) of the 32 queries (G = 8 / NT warps a column
// group) and every G-th kernel point from w % G; producer warp w (8-15)
// builds the A rows of queries [4 (w - 8), 4 (w - 8) + 4). With two splits,
// split z contracts kernel points [8 z, min(8 z + 8, P)) of every chunk.
template <int NT>
__global__ void __launch_bounds__(kBThreads, 1) kpconv_tc_bf16_kernel(
    const float* __restrict__ q_pts, const __nv_bfloat16* __restrict__ table,
    const int32_t* __restrict__ inds, const float* __restrict__ kp,
    const __nv_bfloat16* __restrict__ w, float* __restrict__ out, int Nq, int Ns, int K,
    int Cin, float extent) {
  constexpr int kCout = 64 * NT;
  constexpr int kGroup = 8 / NT;  // consumer warps that share 64 output columns
  const int kpad = (K + 15) / 16 * 16, ksteps_x = kpad / 16;
  extern __shared__ __align__(16) unsigned char tc_bf16_smem[];
  __nv_bfloat16* abuf = reinterpret_cast<__nv_bfloat16*>(tc_bf16_smem);  // [2][TQ][kBAStride]
  __nv_bfloat16* wbuf = abuf + 2 * kTQ * kBAStride;                      // [8][kBG][16][kWSB]
  __nv_bfloat16* xbuf = wbuf + 8 * kBG * 16 * kWSB;                      // [8][kXR][kpad][kXS]
  int* nbr = reinterpret_cast<int*>(xbuf + 8 * kXR * kpad * kXS);        // [TQ][K], -1 = none
  int* cnt = nbr + kTQ * K;                                              // [TQ]
  // the A fragments of the influences of queries [4 w + 2, 4 w + 4), computed
  // by consumer warp w for producer warp w: [8][2][3 k-steps][32 lanes] uint4
  // in the second A buffer, which is first written after they are taken
  uint4* frag = reinterpret_cast<uint4*>(abuf + kTQ * kBAStride);

  const int row = 8 + Cin;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTQ;
  const int p0 = gridDim.z > 1 ? 8 * blockIdx.z : 0;
  const int np = gridDim.z > 1 ? min(8, kP - p0) : kP;
  const int n_chunks = Cin / kCC;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const bool producer = warp >= 8;
  const int pw = warp - 8;                                 // producer index
  const __nv_bfloat16* tb = table + (size_t)b * (Ns + 1) * row;

  // consumers: warp w owns output columns [64 cg, 64 cg + 64) (cg = w /
  // kGroup) of the 32 queries and, of each chunk, the kernel points p0 + j
  // with j = w % kGroup (mod kGroup): its k-step si covers chunk si / (2
  // n_pts), its point j = gw + kGroup (r / 2) and channels 16 (r % 2) .. + 16
  // (r = si % (2 n_pts)), and the matching 16 rows of W, which it stages
  const int cg = warp / kGroup, gw = warp % kGroup;
  const int n_pts = max(0, (np - gw + kGroup - 1) / kGroup);
  const int n_wsteps = n_chunks * 2 * n_pts;
  __nv_bfloat16* wring = wbuf + (producer ? 0 : warp) * kBG * 16 * kWSB;
  auto load_w = [&](int si) {
    if (si < n_wsteps) {
      const int ch = si / (2 * n_pts), r = si - ch * 2 * n_pts;
      const int p = p0 + gw + kGroup * (r / 2);
      const __nv_bfloat16* src =
          w + ((size_t)p * Cin + kCC * ch + 16 * (r % 2)) * kCout + 64 * cg;
      __nv_bfloat16* dst = wring + (si % kBG) * 16 * kWSB;
#pragma unroll
      for (int i = lane; i < 16 * 8; i += 32) {
        const int row = i / 8, c = 8 * (i % 8);
        cp_async16_bf16(dst + row * kWSB + c, src + (size_t)row * kCout + c, true);
      }
    }
    cp_async_commit();
  };
  if (!producer)
    for (int si = 0; si < kBG - kPointSteps; ++si) load_w(si);

  if (producer) {
    // the neighbour indices of the warp's 4 queries
    for (int s = lane; s < kPQ * K; s += 32) {
      const int qi = kPQ * pw + s / K, k = s % K;
      const int nb = q0 + qi < Nq ? inds[((size_t)b * Nq + q0 + qi) * K + k] : Ns;
      nbr[qi * K + k] = nb >= 0 && nb < Ns ? nb : -1;
    }
    __syncwarp();

    // unit u = (chunk u / 4, the warp's query u % 4): its rows (zero past K
    // and for missing neighbours) go to slot u % kXR of the warp's buffer,
    // one commit group a unit, kXR - 1 units ahead
    __nv_bfloat16* xw = xbuf + pw * kXR * kpad * kXS;
    const int n_units = n_chunks * kPQ;
    auto gather = [&](int u) {
      if (u < n_units) {
        const int ch = u / kPQ, qi = kPQ * pw + u % kPQ;
        __nv_bfloat16* dst = xw + (u % kXR) * kpad * kXS;
        for (int i = lane; i < kpad * 4; i += 32) {
          const int k = i / 4, part = i % 4;
          const int nb = k < K ? nbr[qi * K + k] : -1;
          cp_async16_bf16(dst + k * kXS + 8 * part,
                          tb + (size_t)(nb >= 0 ? nb : 0) * row + 8 + kCC * ch + 8 * part,
                          nb >= 0);
        }
      }
      cp_async_commit();
    };
    for (int u = 0; u < kXR - 1; ++u) gather(u);  // in flight during the influences

    // the neighbours' offsets from their query, [4][K] float4 in the warp's
    // last gather slot, whose first gather is issued after the influences
    float4* rel = reinterpret_cast<float4*>(xw + (kXR - 1) * kpad * kXS);
    for (int s = lane; s < kPQ * K; s += 32) {
      const int qi = kPQ * pw + s / K, k = s % K;
      const int q = min(q0 + qi, Nq - 1);
      const int nb = nbr[qi * K + k];
      const uint4 pos = *reinterpret_cast<const uint4*>(tb + (size_t)(nb >= 0 ? nb : 0) * row);
      const float* qp = q_pts + ((size_t)b * Nq + q) * 3;
      const float rx = (bf16_lo(pos.x) + bf16_hi(pos.y)) - qp[0];
      const float ry = (bf16_hi(pos.x) + bf16_lo(pos.z)) - qp[1];
      const float rz = (bf16_lo(pos.y) + bf16_hi(pos.z)) - qp[2];
      rel[s] = make_float4(rx, ry, rz, rx * rx + ry * ry + rz * rz);
    }
    role_barrier();  // the offsets are in place for the consumer warps too

    // the A fragments of infl^T of the warp's 4 queries: queries 0 and 1
    // computed here, 2 and 3 by consumer warp pw meanwhile
    uint32_t ainf[kPQ][kKPadMax / 16][4];
    float fsum[kPQ][2];  // feature sums of neighbours lane and lane + 32, over the chunks
#pragma unroll
    for (int i = 0; i < kPQ / 2; ++i)
      influence_fragments(ainf[i], rel + i * K, nbr + (kPQ * pw + i) * K, kp, K, ksteps_x,
                          extent, g, t);
    role_barrier();  // the consumers' fragments are in place
#pragma unroll
    for (int i = kPQ / 2; i < kPQ; ++i)
#pragma unroll
      for (int ks = 0; ks < kKPadMax / 16; ++ks) {
        const uint4 f = frag[((pw * 2 + i - kPQ / 2) * (kKPadMax / 16) + ks) * 32 + lane];
        ainf[i][ks][0] = f.x;
        ainf[i][ks][1] = f.y;
        ainf[i][ks][2] = f.z;
        ainf[i][ks][3] = f.w;
      }
#pragma unroll
    for (int i = 0; i < kPQ; ++i) fsum[i][0] = fsum[i][1] = 0.f;

    // chunk by chunk: build each query's A rows, A[p][32 channels] =
    // infl^T X on tensor cores, into A buffer (chunk % 2), and add the rows'
    // feature sums; the consumers contract the previous chunk meanwhile
    for (int ch = 0; ch < n_chunks; ++ch) {
      __nv_bfloat16* ab = abuf + (ch & 1) * kTQ * kBAStride;
#pragma unroll
      for (int i = 0; i < kPQ; ++i) {  // unrolled: ainf and fsum stay in registers
        const int u = ch * kPQ + i, qi = kPQ * pw + i;
        __syncwarp();  // every lane is done with slot (u - 1) % kXR
        gather(u + kXR - 1);
        cp_async_wait<kXR - 1>();
        __syncwarp();  // unit u's rows are in place for the warp
        const __nv_bfloat16* xs = xw + (u % kXR) * kpad * kXS;
        float c[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < kKPadMax / 16; ++ks) {
          if (ks >= ksteps_x) break;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t b0, b1, b2, b3;
            ldmatrix_x4_trans(b0, b1, b2, b3,
                              xs + (16 * ks + lane % 8 + 8 * ((lane / 8) % 2)) * kXS + 16 * h +
                                  8 * (lane / 16));
            mma_bf16(c[2 * h], ainf[i][ks], b0, b1);
            mma_bf16(c[2 * h + 1], ainf[i][ks], b2, b3);
          }
        }
        __nv_bfloat16* arow = ab + qi * kBAStride;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          *reinterpret_cast<uint32_t*>(arow + g * kCC + 8 * n + 2 * t) =
              pack_bf16(c[n][0], c[n][1]);
          if (g + 8 < kP)
            *reinterpret_cast<uint32_t*>(arow + (g + 8) * kCC + 8 * n + 2 * t) =
                pack_bf16(c[n][2], c[n][3]);
        }
        // the chunk's feature sums of neighbours lane and lane + 32
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int k = lane + 32 * j;
          if (k < K) {
            const uint4* xr = reinterpret_cast<const uint4*>(xs + k * kXS);
            float s = 0.f;
#pragma unroll
            for (int v = 0; v < kCC / 8; ++v) {
              const uint4 x = xr[v];
              s += bf16_lo(x.x) + bf16_hi(x.x) + bf16_lo(x.y) + bf16_hi(x.y) + bf16_lo(x.z) +
                   bf16_hi(x.z) + bf16_lo(x.w) + bf16_hi(x.w);
            }
            fsum[i][j] += s;
          }
        }
      }
      role_barrier();  // chunk ch is built (and chunk ch - 1 consumed)
    }
    cp_async_wait<0>();

    // density count: a neighbour counts iff its feature-sum is positive
#pragma unroll
    for (int i = 0; i < kPQ; ++i) {
      const int qi = kPQ * pw + i;
      int n_pos = 0;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = lane + 32 * j;
        n_pos += k < K && nbr[qi * K + k] >= 0 && fsum[i][j] > 0.f;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) n_pos += __shfl_xor_sync(0xffffffffu, n_pos, off);
      if (lane == 0) cnt[qi] = n_pos;
    }
    role_barrier();  // the last chunk is consumed; the counts are in place
    return;
  }

  // consumers: the k-steps of chunk ch from A buffer ch % 2, a kernel point
  // (two k-steps) at a time, accumulated in the tensor core
  float acc[2][8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
  {
    role_barrier();  // producer warp `warp`'s neighbour offsets are in place
    const float4* rel = reinterpret_cast<const float4*>(xbuf + (warp * kXR + kXR - 1) * kpad * kXS);
#pragma unroll
    for (int i = kPQ / 2; i < kPQ; ++i) {
      uint32_t f[kKPadMax / 16][4];
      influence_fragments(f, rel + i * K, nbr + (kPQ * warp + i) * K, kp, K, ksteps_x, extent, g,
                          t);
#pragma unroll
      for (int ks = 0; ks < kKPadMax / 16; ++ks)
        frag[((warp * 2 + i - kPQ / 2) * (kKPadMax / 16) + ks) * 32 + lane] =
            make_uint4(f[ks][0], f[ks][1], f[ks][2], f[ks][3]);
    }
    role_barrier();  // the fragments are in place
  }
  role_barrier();  // chunk 0 is built
  for (int ch = 0; ch < n_chunks; ++ch) {
    const __nv_bfloat16* ab = abuf + (ch & 1) * kTQ * kBAStride;
    for (int jp = 0; jp < n_pts; ++jp) {
      const int si = (ch * n_pts + jp) * kPointSteps;
      const int col = (p0 + gw + kGroup * jp) * kCC;  // the point's first A column
      __syncwarp();  // the slots of the previous point's k-steps are consumed
#pragma unroll
      for (int r = 0; r < kPointSteps; ++r) load_w(si + kBG - kPointSteps + r);
      cp_async_wait<kBG - kPointSteps>();
      __syncwarp();  // the warp's W k-steps si .. si + kPointSteps - 1 are in place
      uint32_t a[kPointSteps][2][4];
#pragma unroll
      for (int r = 0; r < kPointSteps; ++r)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const __nv_bfloat16* ar = ab + col + 16 * r + (16 * m + g) * kBAStride + 2 * t;
          a[r][m][0] = ld_pair(ar);
          a[r][m][1] = ld_pair(ar + 8 * kBAStride);
          a[r][m][2] = ld_pair(ar + 8);
          a[r][m][3] = ld_pair(ar + 8 * kBAStride + 8);
        }
#pragma unroll
      for (int h = 0; h < 4; ++h) {  // n-tiles 2 h, 2 h + 1
        uint32_t bw[kPointSteps][4];
#pragma unroll
        for (int r = 0; r < kPointSteps; ++r)
          ldmatrix_x4_trans(bw[r][0], bw[r][1], bw[r][2], bw[r][3],
                            wring + ((si + r) % kBG) * 16 * kWSB +
                                (lane % 8 + 8 * ((lane / 8) % 2)) * kWSB + 16 * h + 8 * (lane / 16));
#pragma unroll
        for (int r = 0; r < kPointSteps; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int m = 0; m < 2; ++m)
              mma_bf16(acc[m][2 * h + e], a[r][m], bw[r][2 * e], bw[r][2 * e + 1]);
      }
    }
    // chunk ch is consumed (and chunk ch + 1 built); after the last, the counts
    role_barrier();
  }
  cp_async_wait<0>();

  // the kGroup warps of a column group add their partial sums in warp order
  // (through the A buffers, free now) into the group's first warp
  if (kGroup > 1) {
    float* red = reinterpret_cast<float*>(abuf);  // [the 8 - NT other warps][64][32 lanes]
    if (gw > 0) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            red[((cg * (kGroup - 1) + gw - 1) * 64 + (m * 8 + n) * 4 + i) * 32 + lane] = acc[m][n][i];
    }
    asm volatile("barrier.sync 2, 256;\n" ::: "memory");  // the consumer warps only
    if (gw > 0) return;
    for (int o = 1; o < kGroup; ++o) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[m][n][i] += red[((cg * (kGroup - 1) + o - 1) * 64 + (m * 8 + n) * 4 + i) * 32 + lane];
    }
  }

  const bool split = gridDim.z > 1;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = 16 * m + g + 8 * h;
      const int q = q0 + qi;
      if (q >= Nq) continue;
      const float den = (float)max(cnt[qi], 1);
      float* orow = out + ((size_t)b * Nq + q) * kCout + 64 * cg + 2 * t;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float v0 = acc[m][n][2 * h] / den, v1 = acc[m][n][2 * h + 1] / den;
        if (split) {
          atomicAdd(orow + 8 * n, v0);
          atomicAdd(orow + 8 * n + 1, v1);
        } else {
          *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(v0, v1);
        }
      }
    }
  }
}

template <int NT>
cudaError_t launch_tc_bf16(const float* q_pts, const __nv_bfloat16* table, const int32_t* inds,
                           const float* kp, const __nv_bfloat16* w, float* out, int B, int Nq,
                           int Ns, int K, int Cin, float extent, cudaStream_t stream) {
  const size_t smem = tc_bf16_smem_bytes((K + 15) / 16 * 16, K);
  cudaError_t err = cudaFuncSetAttribute(
      kpconv_tc_bf16_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kpconv_tc_bf16_kernel<NT>,
                                                           kBThreads, smem)) != cudaSuccess)
    return err;
  const int tiles = (Nq + kTQ - 1) / kTQ;
  const int splits = tiles * B < 2 * sms * per_sm ? 2 : 1;
  if (splits > 1 && (err = cudaMemsetAsync(out, 0, sizeof(float) * B * Nq * 64 * NT,
                                           stream)) != cudaSuccess)
    return err;
  dim3 grid(tiles, B, splits);
  kpconv_tc_bf16_kernel<NT><<<grid, kBThreads, smem, stream>>>(
      q_pts, table, inds, kp, w, out, Nq, Ns, K, Cin, extent);
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
  const bool aligned = ((uintptr_t)w | (uintptr_t)out) % 16 == 0;
  if (Cin >= 64 && Cin % kCC == 0 && K <= kKMax && aligned) {
    switch (Cout) {
      case 64:
        return (int)launch_tc<1>(q_pts, s_pts, inds, x, kp, w, out, B, Nq, Ns, K, Cin, extent, stream);
      case 128:
        return (int)launch_tc<2>(q_pts, s_pts, inds, x, kp, w, out, B, Nq, Ns, K, Cin, extent, stream);
      case 256:
        return (int)launch_tc<4>(q_pts, s_pts, inds, x, kp, w, out, B, Nq, Ns, K, Cin, extent, stream);
      case 512:
        return (int)launch_tc<8>(q_pts, s_pts, inds, x, kp, w, out, B, Nq, Ns, K, Cin, extent, stream);
      default:
        break;
    }
  }
  return (int)launch_cuda_cores(q_pts, F32Rows{s_pts, x, w, Ns, Cin}, inds, kp, out, B, Nq, Ns,
                                K, Cin, Cout, extent, stream);
}

// The bf16 instance. q_pts [B, Nq, 3] f32, table [B, Ns + 1, 8 + Cin] bf16
// (hi(pos), lo(pos), 0, 0, features; row Ns the shadow row), inds [B, Nq, K] int32
// (sentinel Ns), kp [P, 3] f32, w [P, Cin, Cout] bf16, out [B, Nq, Cout] f32;
// all contiguous. Returns a cudaError_t (0 on success).
int kpconv_forward_bf16(const float* q_pts, const __nv_bfloat16* table, const int32_t* inds,
                        const float* kp, const __nv_bfloat16* w, float* out, int B, int Nq,
                        int Ns, int K, int Cin, int Cout, int P, float extent,
                        cudaStream_t stream) {
  if (P != kP || B <= 0 || Nq <= 0 || K <= 0 || Cin <= 0 || Cout <= 0)
    return (int)cudaErrorInvalidValue;
  const bool aligned = ((uintptr_t)table | (uintptr_t)w | (uintptr_t)out) % 16 == 0;
  if (Cin % kCC == 0 && K <= kKMax && aligned) {
    switch (Cout) {
      case 64:
        return (int)launch_tc_bf16<1>(q_pts, table, inds, kp, w, out, B, Nq, Ns, K, Cin, extent, stream);
      case 128:
        return (int)launch_tc_bf16<2>(q_pts, table, inds, kp, w, out, B, Nq, Ns, K, Cin, extent, stream);
      case 256:
        return (int)launch_tc_bf16<4>(q_pts, table, inds, kp, w, out, B, Nq, Ns, K, Cin, extent, stream);
      case 512:
        return (int)launch_tc_bf16<8>(q_pts, table, inds, kp, w, out, B, Nq, Ns, K, Cin, extent, stream);
      default:
        break;
    }
  }
  return (int)launch_cuda_cores(q_pts, Bf16Rows{table, w, Ns, Cin}, inds, kp, out, B, Nq, Ns,
                                K, Cin, Cout, extent, stream);
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
