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
//  * any other shape: the CUDA-core kernel of kpconv_common.cuh, reading its
//    rows through F32Rows.

#include "kpconv_common.cuh"

namespace {

// ---- the tensor-core path (Cin >= 64) ----

constexpr int kPP = 16;                 // influence row, padded for float4 loads
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

// The f32 path of one influence mode: the tensor-core kernel where the shape
// allows it, else the CUDA-core kernel.
template <int Infl>
cudaError_t forward_f32(const float* q_pts, const float* s_pts, const int32_t* inds,
                        const float* x, const float* kp, const float* w, float* out, int B,
                        int Nq, int Ns, int K, int Cin, int Cout, Mode mode,
                        cudaStream_t stream) {
  const bool aligned = ((uintptr_t)w | (uintptr_t)out) % 16 == 0;
  if (Cin >= 64 && Cin % kCC == 0 && K <= kKMax && aligned) {
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
  return launch_cuda_cores<Infl>(q_pts, F32Rows{s_pts, x, w, Ns, Cin}, inds, kp, out, B, Nq, Ns,
                                 K, Cin, Cout, mode, stream);
}

}  // namespace

extern "C" {

// q_pts [B, Nq, 3], s_pts [B, Ns, 3], inds [B, Nq, K] int32 (sentinel Ns),
// x [B, Ns, Cin], kp [P, 3], w [P, Cin, Cout], out [B, Nq, Cout]; all f32 and
// contiguous. influence: 0 linear, 1 constant, 2 gaussian (gauss_den its
// 2 sigma^2 + 1e-9); closest: 1 for "closest" aggregation, 0 for "sum".
// Returns a cudaError_t (0 on success).
int kpconv_forward(const float* q_pts, const float* s_pts, const int32_t* inds,
                   const float* x, const float* kp, const float* w, float* out,
                   int B, int Nq, int Ns, int K, int Cin, int Cout, int P,
                   float extent, int influence, int closest, float gauss_den,
                   cudaStream_t stream) {
  if (P != kP || B <= 0 || Nq <= 0 || K <= 0 || Cin <= 0 || Cout <= 0)
    return (int)cudaErrorInvalidValue;
  const Mode mode{extent, gauss_den, closest != 0};
  switch (influence) {
    case kLinear:
      return (int)forward_f32<kLinear>(q_pts, s_pts, inds, x, kp, w, out, B, Nq, Ns, K, Cin,
                                       Cout, mode, stream);
    case kConstant:
      return (int)forward_f32<kConstant>(q_pts, s_pts, inds, x, kp, w, out, B, Nq, Ns, K, Cin,
                                         Cout, mode, stream);
    case kGaussian:
      return (int)forward_f32<kGaussian>(q_pts, s_pts, inds, x, kp, w, out, B, Nq, Ns, K, Cin,
                                         Cout, mode, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
