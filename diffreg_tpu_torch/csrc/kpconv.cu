// Kernel-point convolution forward for Hopper in f32 (kpconv_forward), with
// each of the JAX package's influence and aggregation modes; the arithmetic
// and the modes are described in kpconv_common.cuh, the bf16 instance in
// kpconv_bf16.cu (a library of its own, built in parallel with this one).
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
// flops of distances and influences and 2 P Cin of aggregation, and per query
// the 2 P Cin Cout contraction, on tensor cores in 3xTF32 (495 TFLOP/s dense
// TF32, of which three products leave at most a third; the aggregation too
// outside the tuned kernel, which sums it on CUDA cores at 67 TFLOP/s); its
// bytes (inputs once, output once) take far less time at 3.35 TB/s.
//
// Three kernels behind one entry point, chosen by shape (*route reports which):
//  * P = 15, Cin >= 64 with Cin % 32 == 0, K <= 40 and Cout in {64, 128, 256,
//    512}: the tuned tensor-core kernel. A block owns 32 queries and all of
//    Cout; out[q] = A[q, P Cin] . W[P Cin, Cout], with A the influence-weighted
//    features. A is built on CUDA cores in shared memory one chunk of 32
//    channels at a time (all 15 kernel points): each warp builds the rows of 4
//    queries with a lane per channel, so a neighbor row is read as one
//    128-byte line and the influences are read once per warp (broadcast). The
//    same loads give the feature-sums of the density count (summed over the
//    chunks, then over the lanes by a 62-shuffle reduce-scatter). Each chunk
//    is then multiplied by its W rows on tensor cores, mma.sync m16n8k8 TF32 in
//    3xTF32 (hi/lo split as the fragments are loaded, tf32.cuh): warp w owns
//    output columns [Cout w / 8, Cout (w + 1) / 8) of the 32 queries and
//    stages exactly those columns of W with cp.async in a ring of its own,
//    several k-steps ahead, so its k-steps need no block barrier (the block
//    meets twice per chunk). W is read once per 32 queries, and the 32 x Cout
//    accumulators (64 per thread at Cout 512) stay in registers, so the
//    aggregation is done once. When the grid is short of two waves (Nq <=
//    1536 at 4 pairs), the kernel points are split between two blocks per
//    query tile (0-7 and 8-14) that add their partial results into a zeroed
//    output with atomicAdd; with two addends onto zero the sum does not depend
//    on their order.
//  * any other kernel-point count P at those shapes: the any-P tensor-core
//    kernel below (P in chunks of 16 kernel points, its A rows built on tensor
//    cores too; one instance per Cout for every P and mode);
//  * every other shape (Cin < 64 or not a multiple of 32, K > 40, another
//    Cout, a misaligned view; on the main path the first layer, Cin = 1, and
//    the 2D-3D point backbone's level 0, K = 64): the any-shape tensor-core
//    kernel at the end of this file (kpconv_common.cuh has the steps it
//    shares with the bf16 instance).

#include "kpconv_common.cuh"

namespace {

// ---- the tensor-core path (Cin >= 64) ----

constexpr int kPP = 16;                 // influence row, padded for float4 loads
constexpr int kAStride = kP * kCC + 4;  // A chunk row stride (floats): no bank conflicts
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
template <int NT, int Infl>
__global__ void __launch_bounds__(kThreads) kpconv_tc_kernel(
    const float* __restrict__ q_pts, const float* __restrict__ s_pts,
    const int32_t* __restrict__ inds, const float* __restrict__ x,
    const float* __restrict__ kp, const float* __restrict__ w,
    float* __restrict__ out, int Nq, int Ns, int K, int Cin, Mode mode) {
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
    float f[kP];
    influences<Infl>(rx, ry, rz, n2, kps, k2s, mode, f);
    float4* ip = reinterpret_cast<float4*>(infl + s * kPP);
#pragma unroll
    for (int j = 0; j < kPP / 4; ++j) {
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = real && 4 * j + i < kP ? f[4 * j + i] : 0.f;
      ip[j] = make_float4(v[0], v[1], v[2], v[3]);
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

template <int NT, int Infl>
cudaError_t launch_tc(const float* q_pts, const float* s_pts, const int32_t* inds,
                      const float* x, const float* kp, const float* w, float* out,
                      int B, int Nq, int Ns, int K, int Cin, Mode mode,
                      cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<NT>(K);
  cudaError_t err = cudaFuncSetAttribute(
      kpconv_tc_kernel<NT, Infl>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kpconv_tc_kernel<NT, Infl>,
                                                           kThreads, smem)) != cudaSuccess)
    return err;
  const int tiles = (Nq + kTQ - 1) / kTQ;
  // split the kernel points in two when the grid is short of two waves
  const int splits = tiles * B < 2 * sms * per_sm ? 2 : 1;
  if (splits > 1 && (err = cudaMemsetAsync(out, 0, sizeof(float) * B * Nq * 64 * NT,
                                           stream)) != cudaSuccess)
    return err;
  dim3 grid(tiles, B, splits);
  kpconv_tc_kernel<NT, Infl><<<grid, kThreads, smem, stream>>>(
      q_pts, s_pts, inds, x, kp, w, out, Nq, Ns, K, Cin, mode);
  return cudaGetLastError();
}

// ---- the any-P tensor-core kernel (P != 15; the steps in kpconv_common.cuh) ----
//
// Blocks (tile, pair, split) of 8 warps, 32 queries and all of Cout; with two
// splits, split z takes kernel points [z p_split, min(P, (z + 1) p_split)).
// For each chunk of 16 points: the influences [32][16][K padded to 8, + 4]
// in shared memory; for each chunk of 16 channels, warp w builds the A rows
// of queries [4 w, 4 w + 4) in 3xTF32 (m16n8k8: k-steps of 8 neighbours, X's
// B fragments read from global memory, 32-byte sectors per row), then owns
// output columns [8 NT w, 8 NT (w + 1)) of the contraction, whose W rows
// (16 a point) it stages with cp.async in a ring of its own, as the tuned
// kernel does.
//
// What bounds it: operations, as the tuned kernel (the contraction, 2 P Cin
// Cout a query, in 3xTF32; the A build is 2 x 16 x K x 16 a query and channel
// chunk, padded to 16 points). It replaces the any-P CUDA-core kernel at
// these shapes: configuration C's encode (P = 24) took 27.0 ms there and
// 6.70-6.74 ms here, against the plain version's 14.3-15.4 and the tuned
// P = 15 kernel's 5.90; P = 64 16.0 ms against 28.3-28.5 (tools/
// bench_any_routes.py, NVIDIA H100 80GB HBM3, 700 W). Building A on tensor
// cores keeps the 16-point chunks cheap: the contraction's k-steps take the
// real points only, so P = 24 costs its 24 points there and 32 in the A
// build.
constexpr int kAnyAS = kPC * kXC + 4;  // A chunk row stride (floats): 4 mod 32, no bank conflicts

template <int NT> __host__ __device__ constexpr int any_w_groups() {
  return NT == 8 ? 2 : NT == 4 ? 3 : 4;
}
__host__ __device__ inline int any_kpad(int K) { return (K + 7) / 8 * 8; }

template <int NT>
size_t tc_any_p_smem_bytes(int K, int P) {
  const int kst = any_kpad(K) + 4;
  return sizeof(float4) * P +
         sizeof(float) * ((size_t)kTQ * kPC * kst + (size_t)kTQ * kAnyAS +
                          (size_t)kWarps * any_w_groups<NT>() * 16 * w_stride<NT>() +
                          (size_t)kTQ * K) +
         sizeof(int) * (2 * (size_t)kTQ * K + kTQ);
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 1) kpconv_tc_any_p_kernel(
    const float* __restrict__ q_pts, const float* __restrict__ s_pts,
    const int32_t* __restrict__ inds, const float* __restrict__ x,
    const float* __restrict__ kp, const float* __restrict__ w, float* __restrict__ out, int Nq,
    int Ns, int K, int Cin, int P, int p_split, Mode mode, int kind) {
  constexpr int kCout = 64 * NT, kG = any_w_groups<NT>(), kWS = w_stride<NT>();
  const int kpad = any_kpad(K), kst = kpad + 4;
  extern __shared__ __align__(16) float tc_any_smem[];
  float4* kps = reinterpret_cast<float4*>(tc_any_smem);    // [P]
  float* infl = tc_any_smem + 4 * P;                        // [TQ][PC][kst]
  float* abuf = infl + kTQ * kPC * kst;                     // [TQ][kAnyAS]
  float* wbuf = abuf + kTQ * kAnyAS;                        // [warp][G][16][kWS]
  float* fsum = wbuf + kWarps * kG * 16 * kWS;              // [TQ][K]
  int* nbr = reinterpret_cast<int*>(fsum + kTQ * K);        // [TQ][K], -1 = none
  int* nearest = nbr + kTQ * K;                             // [TQ][K]
  int* cnt = nearest + kTQ * K;                             // [TQ]

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTQ;
  const int p_begin = blockIdx.z * p_split, p_end = min(P, p_begin + p_split);
  const int n_ch = Cin / kXC;
  const int n_groups = (p_end - p_begin) * n_ch;  // W groups: a point's 16 rows of a channel chunk
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int col_w = warp * 8 * NT;
  const F32Rows rows{s_pts, x, Ns, Cin};
  float* wring = wbuf + warp * kG * 16 * kWS;

  // W groups in the order they are used (chunk of points, chunk of channels,
  // point): a cursor that load_w advances
  int wp0 = p_begin, wch = 0, wj = 0;
  auto load_w = [&](int gi) {
    if (gi < n_groups) {
      const float* src = w + ((size_t)(wp0 + wj) * Cin + kXC * wch) * kCout + col_w;
      float* dst = wring + (gi % kG) * 16 * kWS;
#pragma unroll
      for (int i = lane; i < 16 * 2 * NT; i += 32) {
        const int r = i / (2 * NT), c = 4 * (i - r * 2 * NT);
        cp_async16(dst + r * kWS + c, src + (size_t)r * kCout + c, true);
      }
      if (++wj == min(kPC, p_end - wp0)) {
        wj = 0;
        if (++wch == n_ch) {
          wch = 0;
          wp0 += kPC;
        }
      }
    }
    cp_async_commit();
  };
  for (int gi = 0; gi < kG - 1; ++gi) load_w(gi);  // in flight during the set-up

  load_kernel_points_any(kp, kps, P);
  __syncthreads();
  any_p_neighbours(q_pts, rows, inds, kps, P, b, q0, Nq, Ns, K, mode, nbr, nearest, fsum);

  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;

  const float* xb = x + (size_t)b * Ns * Cin + g;
  int gi = 0;
  for (int pc0 = p_begin; pc0 < p_end; pc0 += kPC) {
    const int npc = min(kPC, p_end - pc0);
    const bool first = pc0 == p_begin;
    __syncthreads();  // the neighbour table is in place; the last chunk's influences are consumed
    chunk_influences(infl, kst, kpad, q_pts, rows, kps, nbr, nearest, b, q0, Nq, K, pc0, npc,
                     mode, kind);
    __syncthreads();
    for (int ch = 0; ch < n_ch; ++ch) {
      // A[q][16 p + c] = sum_k infl[q, p, k] x[nbr[q, k], 16 ch + c]
#pragma unroll 1
      for (int i = 0; i < kQW; ++i) {
        const int aq = kQW * warp + i;
        const int* nq = nbr + aq * K;
        const float* xc = xb + kXC * ch;
        // B fragments of X: neighbour 8 ks + t + 4 h, channel 8 n + g
        float xf[kKMax / 8][2][2];
#pragma unroll
        for (int ks = 0; ks < kKMax / 8; ++ks)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int kk = 8 * ks + t + 4 * h;
            const int nb = kk < K ? nq[kk] : -1;
#pragma unroll
            for (int n = 0; n < 2; ++n)
              xf[ks][n][h] = nb >= 0 ? __ldg(xc + (size_t)nb * Cin + 8 * n) : 0.f;
          }
        if (first) {
          // the chunk's share of each neighbour's feature sum, over the 8
          // lanes of a quad column
#pragma unroll
          for (int ks = 0; ks < kKMax / 8; ++ks)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float fs = xf[ks][0][h] + xf[ks][1][h];
              fs += __shfl_xor_sync(0xffffffffu, fs, 4);
              fs += __shfl_xor_sync(0xffffffffu, fs, 8);
              fs += __shfl_xor_sync(0xffffffffu, fs, 16);
              const int kk = 8 * ks + t + 4 * h;
              if (g == 0 && kk < K) fsum[aq * K + kk] += fs;
            }
        }
        float c[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < kKMax / 8; ++ks) {
          if (8 * ks >= kpad) break;
          uint32_t ah[4], al[4];
          load_a_3xtf32(infl + aq * kPC * kst + 8 * ks, kst, g, t, ah, al);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(xf[ks][n][0], bh0, bl0);
            split_tf32(xf[ks][n][1], bh1, bl1);
            mma_3xtf32_add(c[n], ah, al, bh0, bh1, bl0, bl1);
          }
        }
        float* arow = abuf + aq * kAnyAS;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          *reinterpret_cast<float2*>(arow + g * kXC + 8 * n + 2 * t) = make_float2(c[n][0], c[n][1]);
          *reinterpret_cast<float2*>(arow + (g + 8) * kXC + 8 * n + 2 * t) =
              make_float2(c[n][2], c[n][3]);
        }
      }
      __syncthreads();  // the A chunk is complete

      // the contraction: point j of the chunk is A columns [16 j, 16 j + 16)
      // (two k-steps) against its 16 W rows of this channel chunk
      for (int j = 0; j < npc; ++j, ++gi) {
        cp_async_wait<kG - 2>();
        __syncwarp();  // the warp's W group gi is in place; group gi - 1 is consumed
        load_w(gi + kG - 1);
        const float* wg = wring + (gi % kG) * 16 * kWS + g;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float* as = abuf + kXC * j + 8 * u;
          const float* ws = wg + u * 8 * kWS;
          uint32_t ah[2][4], al[2][4];
          load_a_3xtf32(as, kAnyAS, g, t, ah[0], al[0]);
          load_a_3xtf32(as + 16 * kAnyAS, kAnyAS, g, t, ah[1], al[1]);
          uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            split_tf32(ws[t * kWS + 8 * n], bh[n][0], bl[n][0]);
            split_tf32(ws[(t + 4) * kWS + 8 * n], bh[n][1], bl[n][1]);
          }
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int n = 0; n < NT; ++n)
              mma_3xtf32_add(acc[m][n], ah[m], al[m], bh[n][0], bh[n][1], bl[n][0], bl[n][1]);
        }
      }
      __syncthreads();  // the A chunk is consumed before the next one is built
    }
  }
  cp_async_wait<0>();
  any_p_counts(nbr, fsum, K, cnt);
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
cudaError_t launch_tc_any_p(const float* q_pts, const float* s_pts, const int32_t* inds,
                            const float* x, const float* kp, const float* w, float* out, int B,
                            int Nq, int Ns, int K, int Cin, int P, Mode mode, int kind,
                            cudaStream_t stream) {
  const size_t smem = tc_any_p_smem_bytes<NT>(K, P);
  cudaError_t err = cudaFuncSetAttribute(
      kpconv_tc_any_p_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int tiles = (Nq + kTQ - 1) / kTQ;
  // one block an SM: split the kernel points in two when the grid is short of two waves
  const int splits = P > 1 && tiles * B < 2 * sms ? 2 : 1;
  const int p_split = (P + splits - 1) / splits;
  if (splits > 1 && (err = cudaMemsetAsync(out, 0, sizeof(float) * B * Nq * 64 * NT,
                                           stream)) != cudaSuccess)
    return err;
  dim3 grid(tiles, B, splits);
  kpconv_tc_any_p_kernel<NT><<<grid, kThreads, smem, stream>>>(
      q_pts, s_pts, inds, x, kp, w, out, Nq, Ns, K, Cin, P, p_split, mode, kind);
  return cudaGetLastError();
}

// The any-P tensor-core kernel at this Cout, if its tiles fit in shared memory.
cudaError_t forward_tc_any_p(const float* q_pts, const float* s_pts, const int32_t* inds,
                             const float* x, const float* kp, const float* w, float* out, int B,
                             int Nq, int Ns, int K, int Cin, int Cout, int P, Mode mode, int kind,
                             cudaStream_t stream, bool* taken) {
  *taken = true;
  switch (Cout) {
    case 64:
      if (tc_any_p_smem_bytes<1>(K, P) <= kTcSmemMax)
        return launch_tc_any_p<1>(q_pts, s_pts, inds, x, kp, w, out, B, Nq, Ns, K, Cin, P, mode, kind, stream);
      break;
    case 128:
      if (tc_any_p_smem_bytes<2>(K, P) <= kTcSmemMax)
        return launch_tc_any_p<2>(q_pts, s_pts, inds, x, kp, w, out, B, Nq, Ns, K, Cin, P, mode, kind, stream);
      break;
    case 256:
      if (tc_any_p_smem_bytes<4>(K, P) <= kTcSmemMax)
        return launch_tc_any_p<4>(q_pts, s_pts, inds, x, kp, w, out, B, Nq, Ns, K, Cin, P, mode, kind, stream);
      break;
    case 512:
      if (tc_any_p_smem_bytes<8>(K, P) <= kTcSmemMax)
        return launch_tc_any_p<8>(q_pts, s_pts, inds, x, kp, w, out, B, Nq, Ns, K, Cin, P, mode, kind, stream);
      break;
    default:
      break;
  }
  *taken = false;
  return cudaSuccess;
}

// ---- the any-shape tensor-core kernel (every shape the kernels above refuse) ----
//
// The steps shared with the bf16 instance are in kpconv_common.cuh. Here the
// A rows are built in 3xTF32 with mma.sync m16n8k8: per staged chunk of 32
// neighbours, 4 k-steps of 8; lane (g, t) computes the influences of kernel
// points g and g + 8 on neighbours t and t + 4 of each k-step in registers
// (its A fragment) and loads channel g of those neighbours' rows for each
// n-tile of 8 channels (its B fragments; 8 lanes read a 32-byte sector of a
// row), all of the chunk's loads in flight at once; each k-step's three
// products are summed from zero and added to the A sums in f32. The
// contraction runs over the A chunk's packed columns in k-steps of 8 (3xTF32,
// added in f32 per k-step), its W rows staged 16 a group.
//
// What bounds it: at Cin = 1 the influences (P per neighbour, CUDA cores); at
// the 2D-3D level 0's 32 -> 32 (K = 64) the aggregation, 2 x 16 x 64 x 32 a
// query in three TF32 products, and the neighbour rows' L2 reads (8 KB a
// query); at wide layers the contraction, as the tuned kernel.
template <int NT> __host__ __device__ constexpr int gen_w_groups() { return NT == 8 ? 2 : 3; }
template <int NT> __host__ __device__ constexpr int gen_w_stride() { return NT == 1 ? 8 : 8 * NT + 8; }
// A chunk row stride (floats): an odd multiple of 4, so the fragment loads of
// rows g and columns t hit 32 banks
__host__ __device__ inline int gen_a_stride(int Cin) { return 16 * (Cin < kGCC ? Cin : kGCC) + 4; }

template <int NT>
size_t any_shape_smem_bytes(int P, int Cin) {
  return sizeof(float4) * P +
         sizeof(float) * ((size_t)kGQ * gen_a_stride(Cin) +
                          (size_t)kWarps * gen_w_groups<NT>() * 16 * gen_w_stride<NT>()) +
         sizeof(StagedNeighbours) * kWarps + sizeof(int) * kGQ;
}

// The A row of query q for kernel points [pc0, pc0 + 16) and channels
// [c0, c0 + nc) (nc <= 32), A[p][c] = sum_k infl[k, p] x[nbr[k], c0 + c], at
// arow[p nc + c] (the pad points' rows zero). With `count` (one chunk holds
// all of Cin), returns the query's density count at every lane, from the same
// loads (the 8 lanes of a quad column hold a neighbour's channels); else 0.
__device__ int tf32_row(float* arow, StagedNeighbours& st, const float* q_pts, const float* s_pts,
                        const int32_t* inds, const float* x, const float4* kps, int P, int pc0,
                        int b, int q, int Nq, int Ns, int K, int Cin, int c0, int nc, bool count,
                        const Mode& mode, int kind, int lane) {
  const int g = lane / 4, t = lane % 4;
  const int nx = (nc + 7) / 8;
  const F32Rows rows{s_pts, x, Ns, Cin};
  const float4 kq0 = kps[min(pc0 + g, P - 1)], kq1 = kps[min(pc0 + g + 8, P - 1)];
  const float* xc = x + (size_t)b * Ns * Cin + c0 + g;
  float c[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
  int n_pos = 0;
  for (int k0 = 0; k0 < K; k0 += kGKC) {
    __syncwarp();  // the last chunk's staged neighbours are consumed
    stage_neighbours(st, q_pts, rows, inds, kps, P, b, q, Nq, Ns, K, k0, mode, lane);
    __syncwarp();
    // B fragments: neighbour 8 ks + t + 4 h, channel c0 + 8 n + g
    float xf[4][4][2];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int nb = st.nb[8 * ks + t + 4 * h];
#pragma unroll
        for (int n = 0; n < 4; ++n)
          xf[ks][n][h] = nb >= 0 && 8 * n + g < nc ? __ldg(xc + (size_t)nb * Cin + 8 * n) : 0.f;
      }
    if (count) {
      // entry 2 ks + h: this lane's channels of neighbour 8 ks + t + 4 h;
      // after the reduce-scatter, lane (g, t) holds entry g's feature sum
      float fs[8];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          fs[2 * ks + h] = (xf[ks][0][h] + xf[ks][1][h]) + (xf[ks][2][h] + xf[ks][3][h]);
      column_reduce_scatter8(fs, lane);
      n_pos += st.nb[8 * (g / 2) + t + 4 * (g % 2)] >= 0 && fs[0] > 0.f;
    }
    const int kc = min(kGKC, K - k0);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (8 * ks >= kc) break;
      const int j0 = 8 * ks + t, j1 = j0 + 4;
      const float4 r0 = st.rel[j0], r1 = st.rel[j1];
      const int nb0 = st.nb[j0], nb1 = st.nb[j1], near0 = st.near[j0], near1 = st.near[j1];
      // A fragment: a0 point g / neighbour t, a1 point g + 8 / t, a2 g / t + 4, a3 g + 8 / t + 4
      const float f[4] = {influence_at(r0, nb0, near0, pc0 + g, P, kq0, mode, kind),
                          influence_at(r0, nb0, near0, pc0 + g + 8, P, kq1, mode, kind),
                          influence_at(r1, nb1, near1, pc0 + g, P, kq0, mode, kind),
                          influence_at(r1, nb1, near1, pc0 + g + 8, P, kq1, mode, kind)};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(f[e], ah[e], al[e]);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if (n >= nx) break;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(xf[ks][n][0], bh0, bl0);
        split_tf32(xf[ks][n][1], bh1, bl1);
        mma_3xtf32_add(c[n], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  }
  // C fragments: rows kernel points g and g + 8, columns channels 8 n + 2 t (+ 1)
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    if (n >= nx) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ch = 8 * n + 2 * t + (e & 1);
      if (ch < nc) arow[(g + 8 * (e >> 1)) * nc + ch] = c[n][e];
    }
  }
  return count ? __reduce_add_sync(0xffffffffu, n_pos) : 0;
}

// Blocks (tile of 32 queries, pair, column block of 64 NT). Warp w builds the
// A rows of queries [4 w, 4 w + 4) and contracts output columns
// [64 NT z + 8 NT w, + 8 NT) of the 32 queries (two m-tiles), staging those
// columns of W in a ring of its own.
template <int NT>
__global__ void __launch_bounds__(kThreads, NT <= 2 ? 2 : 1) kpconv_any_shape_kernel(
    const float* __restrict__ q_pts, const float* __restrict__ s_pts,
    const int32_t* __restrict__ inds, const float* __restrict__ x,
    const float* __restrict__ kp, const float* __restrict__ w, float* __restrict__ out, int Nq,
    int Ns, int K, int Cin, int Cout, int P, Mode mode, int kind, int w16) {
  constexpr int kG = gen_w_groups<NT>(), kWS = gen_w_stride<NT>();
  const int as = gen_a_stride(Cin);
  extern __shared__ __align__(16) float gen_smem[];
  float4* kps = reinterpret_cast<float4*>(gen_smem);                   // [P]
  float* abuf = gen_smem + 4 * P;                                      // [kGQ][as]
  float* wbuf = abuf + kGQ * as;                                       // [warp][G][16][kWS]
  StagedNeighbours* staged =
      reinterpret_cast<StagedNeighbours*>(wbuf + kWarps * kG * 16 * kWS);  // [warp]
  int* cnt = reinterpret_cast<int*>(staged + kWarps);                 // [kGQ]

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kGQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int col_w = blockIdx.z * 64 * NT + warp * 8 * NT;
  const bool has_cols = col_w < Cout;
  float* wring = wbuf + warp * kG * 16 * kWS;

  // W group (the cursor's next 16 rows, columns [col_w, col_w + 8 NT)) into
  // ring slot `slot`: 16-byte cp.async where W's rows allow it (zero-filled
  // past Cout and for pad rows), else plain loads
  WCursor cur;
  auto load_w = [&](int slot) {
    if (!cur.done(P)) {
      float* dst = wring + slot * 16 * kWS;
      if (w16) {
#pragma unroll
        for (int i = lane; i < 16 * 2 * NT; i += 32) {
          const int r = i / (2 * NT), c = col_w + 4 * (i % (2 * NT));
          const int row = cur.row(r, P, Cin);
          const bool in = row >= 0 && c < Cout;
          cp_async16(dst + r * kWS + (c - col_w), in ? w + (size_t)row * Cout + c : w, in);
        }
      } else {
        for (int i = lane; i < 16 * 8 * NT; i += 32) {
          const int r = i / (8 * NT), c = col_w + i % (8 * NT);
          const int row = cur.row(r, P, Cin);
          dst[r * kWS + (c - col_w)] = row >= 0 && c < Cout ? __ldg(w + (size_t)row * Cout + c) : 0.f;
        }
      }
      cur.advance(P, Cin);
    }
    cp_async_commit();
  };
  if (has_cols)
    for (int s = 0; s < kG - 1; ++s) load_w(s);  // in flight during the first A chunk

  load_kernel_points_any(kp, kps, P);
  __syncthreads();
  const bool chunked = Cin > kGCC;  // the density count cannot come from one chunk's loads
  if (chunked)
    for (int i = 0; i < kGQW; ++i) {
      const int n = dense_count(F32Rows{s_pts, x, Ns, Cin}, inds, b, q0 + kGQW * warp + i, Nq,
                                Ns, K, Cin, lane);
      if (lane == 0) cnt[kGQW * warp + i] = n;
    }

  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  int gi = 0;  // W groups consumed
  for (int pc0 = 0; pc0 < P; pc0 += kPC) {
    const int npc = min(kPC, P - pc0);
    for (int c0 = 0; c0 < Cin; c0 += kGCC) {
      const int nc = min(kGCC, Cin - c0);
      const bool count = pc0 == 0 && !chunked;
#pragma unroll 1
      for (int i = 0; i < kGQW; ++i) {
        const int aq = kGQW * warp + i;
        float* arow = abuf + aq * as;
        const int n = Cin == 1
            ? cin1_row<float>(arow, q_pts, F32Rows{s_pts, x, Ns, Cin}, inds, kps, P, pc0, b,
                              q0 + aq, Nq, Ns, K, mode, kind, lane)
            : tf32_row(arow, staged[warp], q_pts, s_pts, inds, x, kps, P, pc0, b, q0 + aq, Nq,
                       Ns, K, Cin, c0, nc, count, mode, kind, lane);
        if (count && lane == 0) cnt[aq] = n;
      }
      __syncthreads();  // the A chunk is complete

      if (has_cols) {
        const int groups = (npc * nc + 15) / 16;
        for (int gl = 0; gl < groups; ++gl, ++gi) {
          cp_async_wait<kG - 2>();
          __syncwarp();  // the warp's group gi is in place; group gi - 1 is consumed
          load_w((gi + kG - 1) % kG);
          const float* wg = wring + (gi % kG) * 16 * kWS + g;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float* a = abuf + 16 * gl + 8 * u;
            const float* ws = wg + u * 8 * kWS;
            uint32_t ah[2][4], al[2][4];
            load_a_3xtf32(a, as, g, t, ah[0], al[0]);
            load_a_3xtf32(a + 16 * as, as, g, t, ah[1], al[1]);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              uint32_t bh0, bl0, bh1, bl1;
              split_tf32(ws[t * kWS + 8 * n], bh0, bl0);
              split_tf32(ws[(t + 4) * kWS + 8 * n], bh1, bl1);
#pragma unroll
              for (int m = 0; m < 2; ++m)
                mma_3xtf32_add(acc[m][n], ah[m], al[m], bh0, bh1, bl0, bl1);
            }
          }
        }
      }
      __syncthreads();  // the A chunk is consumed before the next one is built
    }
  }
  cp_async_wait<0>();
  if (has_cols) store_any_shape<NT>(out, acc, cnt, b, q0, Nq, Cout, col_w, g, t);
}

template <int NT>
cudaError_t launch_any_shape_nt(const float* q_pts, const float* s_pts, const int32_t* inds,
                                const float* x, const float* kp, const float* w, float* out,
                                int B, int Nq, int Ns, int K, int Cin, int Cout, int P, Mode mode,
                                int kind, cudaStream_t stream) {
  static unsigned devices_done = 0;
  const size_t smem = any_shape_smem_bytes<NT>(P, Cin);
  if (smem > kTcSmemMax) return cudaErrorInvalidValue;  // P past ~8,000 kernel points
  const cudaError_t err = allow_shared_memory(kpconv_any_shape_kernel<NT>, devices_done);
  if (err != cudaSuccess) return err;
  const int w16 = (uintptr_t)w % 16 == 0 && Cout % 4 == 0;
  dim3 grid((Nq + kGQ - 1) / kGQ, B, (Cout + 64 * NT - 1) / (64 * NT));
  kpconv_any_shape_kernel<NT><<<grid, kThreads, smem, stream>>>(
      q_pts, s_pts, inds, x, kp, w, out, Nq, Ns, K, Cin, Cout, P, mode, kind, w16);
  return cudaGetLastError();
}

// The any-shape kernel with 8 NT columns a warp: the fewest that cover Cout,
// up to 64 (512 columns a block).
cudaError_t launch_any_shape(const float* q_pts, const float* s_pts, const int32_t* inds,
                             const float* x, const float* kp, const float* w, float* out, int B,
                             int Nq, int Ns, int K, int Cin, int Cout, int P, Mode mode, int kind,
                             cudaStream_t stream) {
  if (Cout <= 64)
    return launch_any_shape_nt<1>(q_pts, s_pts, inds, x, kp, w, out, B, Nq, Ns, K, Cin, Cout, P, mode, kind, stream);
  if (Cout <= 128)
    return launch_any_shape_nt<2>(q_pts, s_pts, inds, x, kp, w, out, B, Nq, Ns, K, Cin, Cout, P, mode, kind, stream);
  if (Cout <= 256)
    return launch_any_shape_nt<4>(q_pts, s_pts, inds, x, kp, w, out, B, Nq, Ns, K, Cin, Cout, P, mode, kind, stream);
  return launch_any_shape_nt<8>(q_pts, s_pts, inds, x, kp, w, out, B, Nq, Ns, K, Cin, Cout, P, mode, kind, stream);
}

// The f32 path of one influence mode: at P = 15 the tuned tensor-core kernel
// where the shape allows it; at any other P the any-P tensor-core kernel
// where the shape allows it and its tiles fit; else the any-shape kernel.
// *route: which ran.
template <int Infl>
cudaError_t forward_f32(const float* q_pts, const float* s_pts, const int32_t* inds,
                        const float* x, const float* kp, const float* w, float* out, int B,
                        int Nq, int Ns, int K, int Cin, int Cout, int P, Mode mode, int* route,
                        cudaStream_t stream) {
  const bool aligned = ((uintptr_t)w | (uintptr_t)out) % 16 == 0;
  const bool tc_shape = Cin >= 64 && Cin % kCC == 0 && K <= kKMax && aligned;
  if (tc_shape && P != kP) {
    bool taken;
    *route = kRouteAnyPTensorCores;
    const cudaError_t err = forward_tc_any_p(q_pts, s_pts, inds, x, kp, w, out, B, Nq, Ns, K,
                                             Cin, Cout, P, mode, Infl, stream, &taken);
    if (taken) return err;
  }
  if (tc_shape && P == kP) {
    *route = kRouteTuned;
    switch (Cout) {
      case 64:
        return launch_tc<1, Infl>(q_pts, s_pts, inds, x, kp, w, out, B, Nq, Ns, K, Cin, mode, stream);
      case 128:
        return launch_tc<2, Infl>(q_pts, s_pts, inds, x, kp, w, out, B, Nq, Ns, K, Cin, mode, stream);
      case 256:
        return launch_tc<4, Infl>(q_pts, s_pts, inds, x, kp, w, out, B, Nq, Ns, K, Cin, mode, stream);
      case 512:
        return launch_tc<8, Infl>(q_pts, s_pts, inds, x, kp, w, out, B, Nq, Ns, K, Cin, mode, stream);
      default:
        break;
    }
  }
  *route = kRouteAnyShape;
  return launch_any_shape(q_pts, s_pts, inds, x, kp, w, out, B, Nq, Ns, K, Cin, Cout, P, mode,
                          Infl, stream);
}

}  // namespace

extern "C" {

// q_pts [B, Nq, 3], s_pts [B, Ns, 3], inds [B, Nq, K] int32 (sentinel Ns),
// x [B, Ns, Cin], kp [P, 3], w [P, Cin, Cout], out [B, Nq, Cout]; all f32 and
// contiguous; any P >= 1. influence: 0 linear, 1 constant, 2 gaussian (gauss_den its
// 2 sigma^2 + 1e-9); closest: 1 for "closest" aggregation, 0 for "sum".
// *route is set to the kernel that ran (Route: 0 the tuned kernel at P = 15,
// 1 the any-P tensor-core kernel, 2 the any-shape tensor-core kernel).
// Returns a cudaError_t (0 on success).
int kpconv_forward(const float* q_pts, const float* s_pts, const int32_t* inds,
                   const float* x, const float* kp, const float* w, float* out,
                   int B, int Nq, int Ns, int K, int Cin, int Cout, int P,
                   float extent, int influence, int closest, float gauss_den, int* route,
                   cudaStream_t stream) {
  if (P <= 0 || B <= 0 || Nq <= 0 || K <= 0 || Cin <= 0 || Cout <= 0)
    return (int)cudaErrorInvalidValue;
  const Mode mode{extent, gauss_den, closest != 0};
  switch (influence) {
    case kLinear:
      return (int)forward_f32<kLinear>(q_pts, s_pts, inds, x, kp, w, out, B, Nq, Ns, K, Cin,
                                       Cout, P, mode, route, stream);
    case kConstant:
      return (int)forward_f32<kConstant>(q_pts, s_pts, inds, x, kp, w, out, B, Nq, Ns, K, Cin,
                                         Cout, P, mode, route, stream);
    case kGaussian:
      return (int)forward_f32<kGaussian>(q_pts, s_pts, inds, x, kp, w, out, B, Nq, Ns, K, Cin,
                                         Cout, P, mode, route, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
