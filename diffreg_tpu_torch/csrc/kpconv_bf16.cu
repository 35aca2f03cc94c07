// Kernel-point convolution forward for Hopper in the JAX package's bf16 compute
// path (kpconv_forward_bf16), with each of the JAX package's influence and
// aggregation modes (kpconv_common.cuh); the f32 kernels are in kpconv.cu.
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

#include "kpconv_common.cuh"

namespace {

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

// The kernel point nearest to a neighbour at offset r (x, y, z, |.|^2), the
// first of equal ones: "closest" aggregation's choice, with the distances
// computed as influences() computes them.
__device__ __forceinline__ int nearest_point(const float4& r, const float* kp) {
  int nearest = 0;
  float best = 0.f;
#pragma unroll 1  // rolled: unrolled in every fragment it spilled the kernel's registers
  for (int p = 0; p < kP; ++p) {
    const float x = __ldg(kp + 3 * p), y = __ldg(kp + 3 * p + 1), z = __ldg(kp + 3 * p + 2);
    const float d2 = kp_d2(r.x, r.y, r.z, r.w, x, y, z, kp_norm2(x, y, z));
    if (p == 0 || d2 < best) {
      best = d2;
      nearest = p;
    }
  }
  return nearest;
}

// The A fragments (mma.sync m16n8k16) of infl_q^T for one query, k-step ks
// covering neighbours [16 ks, 16 ks + 16): rows are kernel points, columns
// neighbours; lane (g, t) holds kernel points g and g + 8 (the pad point 15
// is zero) at neighbours 16 ks + 2 t + {0, 1, 8, 9}; an influence computed
// in f32 from the neighbour's offset (rel: x, y, z, |.|^2) and rounded to
// bf16, zero past K and for a missing neighbour (nbr < 0), and under
// "closest" zero unless the point is the neighbour's nearest.
template <int Infl>
__device__ __forceinline__ void influence_fragments(uint32_t (&a)[kKPadMax / 16][4],
                                                    const float4* rel, const int* nbr,
                                                    const float* kp, int K, int ksteps,
                                                    const Mode& mode, int g, int t) {
  float kpl[6], k2l[2];  // the lane's kernel points g and g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = min(g + 8 * h, kP - 1);
    const float x = __ldg(kp + 3 * p), y = __ldg(kp + 3 * p + 1), z = __ldg(kp + 3 * p + 2);
    kpl[3 * h] = x;
    kpl[3 * h + 1] = y;
    kpl[3 * h + 2] = z;
    k2l[h] = kp_norm2(x, y, z);
  }
#pragma unroll
  for (int ks = 0; ks < kKPadMax / 16; ++ks) {
    float f[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 16 * ks + 2 * t + (e & 1) + 8 * (e >> 1);
      if (ks < ksteps && k < K && nbr[k] >= 0) {
        const float4 r = rel[k];
        const int nearest = mode.closest ? nearest_point(r, kp) : -1;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (g + 8 * h < kP && (nearest < 0 || nearest == g + 8 * h))
            f[e][h] = influence_of<Infl>(
                kp_d2(r.x, r.y, r.z, r.w, kpl[3 * h], kpl[3 * h + 1], kpl[3 * h + 2], k2l[h]),
                mode);
        }
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
template <int NT, int Infl>
__global__ void __launch_bounds__(kBThreads, 1) kpconv_tc_bf16_kernel(
    const float* __restrict__ q_pts, const __nv_bfloat16* __restrict__ table,
    const int32_t* __restrict__ inds, const float* __restrict__ kp,
    const __nv_bfloat16* __restrict__ w, float* __restrict__ out, int Nq, int Ns, int K,
    int Cin, Mode mode) {
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
      influence_fragments<Infl>(ainf[i], rel + i * K, nbr + (kPQ * pw + i) * K, kp, K,
                                ksteps_x, mode, g, t);
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
      influence_fragments<Infl>(f, rel + i * K, nbr + (kPQ * warp + i) * K, kp, K, ksteps_x,
                                mode, g, t);
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

template <int NT, int Infl>
cudaError_t launch_tc_bf16(const float* q_pts, const __nv_bfloat16* table, const int32_t* inds,
                           const float* kp, const __nv_bfloat16* w, float* out, int B, int Nq,
                           int Ns, int K, int Cin, Mode mode, cudaStream_t stream) {
  const size_t smem = tc_bf16_smem_bytes((K + 15) / 16 * 16, K);
  cudaError_t err = cudaFuncSetAttribute(
      kpconv_tc_bf16_kernel<NT, Infl>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kpconv_tc_bf16_kernel<NT, Infl>, kBThreads, smem)) != cudaSuccess)
    return err;
  const int tiles = (Nq + kTQ - 1) / kTQ;
  const int splits = tiles * B < 2 * sms * per_sm ? 2 : 1;
  if (splits > 1 && (err = cudaMemsetAsync(out, 0, sizeof(float) * B * Nq * 64 * NT,
                                           stream)) != cudaSuccess)
    return err;
  dim3 grid(tiles, B, splits);
  kpconv_tc_bf16_kernel<NT, Infl><<<grid, kBThreads, smem, stream>>>(
      q_pts, table, inds, kp, w, out, Nq, Ns, K, Cin, mode);
  return cudaGetLastError();
}

// The bf16 path of one influence mode.
template <int Infl>
cudaError_t forward_bf16(const float* q_pts, const __nv_bfloat16* table, const int32_t* inds,
                         const float* kp, const __nv_bfloat16* w, float* out, int B, int Nq,
                         int Ns, int K, int Cin, int Cout, Mode mode, cudaStream_t stream) {
  const bool aligned = ((uintptr_t)table | (uintptr_t)w | (uintptr_t)out) % 16 == 0;
  if (Cin % kCC == 0 && K <= kKMax && aligned) {
    switch (Cout) {
      case 64:
        return launch_tc_bf16<1, Infl>(q_pts, table, inds, kp, w, out, B, Nq, Ns, K, Cin, mode, stream);
      case 128:
        return launch_tc_bf16<2, Infl>(q_pts, table, inds, kp, w, out, B, Nq, Ns, K, Cin, mode, stream);
      case 256:
        return launch_tc_bf16<4, Infl>(q_pts, table, inds, kp, w, out, B, Nq, Ns, K, Cin, mode, stream);
      case 512:
        return launch_tc_bf16<8, Infl>(q_pts, table, inds, kp, w, out, B, Nq, Ns, K, Cin, mode, stream);
      default:
        break;
    }
  }
  return launch_cuda_cores<Infl>(q_pts, Bf16Rows{table, w, Ns, Cin}, inds, kp, out, B, Nq, Ns,
                                 K, Cin, Cout, mode, stream);
}

}  // namespace

extern "C" {

// The bf16 instance. q_pts [B, Nq, 3] f32, table [B, Ns + 1, 8 + Cin] bf16
// (hi(pos), lo(pos), 0, 0, features; row Ns the shadow row), inds [B, Nq, K] int32
// (sentinel Ns), kp [P, 3] f32, w [P, Cin, Cout] bf16, out [B, Nq, Cout] f32;
// all contiguous; the modes as kpconv_forward's. Returns a cudaError_t (0 on
// success).
int kpconv_forward_bf16(const float* q_pts, const __nv_bfloat16* table, const int32_t* inds,
                        const float* kp, const __nv_bfloat16* w, float* out, int B, int Nq,
                        int Ns, int K, int Cin, int Cout, int P, float extent, int influence,
                        int closest, float gauss_den, cudaStream_t stream) {
  if (P != kP || B <= 0 || Nq <= 0 || K <= 0 || Cin <= 0 || Cout <= 0)
    return (int)cudaErrorInvalidValue;
  const Mode mode{extent, gauss_den, closest != 0};
  switch (influence) {
    case kLinear:
      return (int)forward_bf16<kLinear>(q_pts, table, inds, kp, w, out, B, Nq, Ns, K, Cin, Cout,
                                        mode, stream);
    case kConstant:
      return (int)forward_bf16<kConstant>(q_pts, table, inds, kp, w, out, B, Nq, Ns, K, Cin,
                                          Cout, mode, stream);
    case kGaussian:
      return (int)forward_bf16<kGaussian>(q_pts, table, inds, kp, w, out, B, Nq, Ns, K, Cin,
                                          Cout, mode, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
