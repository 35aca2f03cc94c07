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
// bf16 features in f32). Three kernels, chosen as the f32 path's (*route):
//  * P = 15, Cin a multiple of 32, K <= 40, Cout in {64, 128, 256, 512}: the
//    tuned tensor-core kernel below;
//  * any other kernel-point count P at those shapes: the any-P tensor-core
//    kernel below (P in chunks of 16 kernel points);
//  * every other shape (on the main path the first layer, Cin = 1): the
//    any-shape tensor-core kernel at the end of this file, with the same
//    roundings (Bf16Rows).
// The tuned kernel maps kernel points to its mma rows g and g + 8, and its A
// chunk and W ring are laid out for P = 15.
//
// The tuned kernel. What bounds it on an H100: operations, both
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

// ---- the any-P tensor-core kernel (P != 15; the steps in kpconv_common.cuh) ----
//
// The f32 any-P kernel's tiling (kpconv.cu) in bf16 at the roundings of
// Bf16Rows: the influences rounded to bf16 ([32][16][K padded to 16, + 8]
// bf16), the A rows built with mma.sync m16n8k16 (k-steps of 16 neighbours,
// X's B fragments read as bf16 pairs from the table, f32 sums rounded to
// bf16), and the contraction on m16n8k16 with W's B fragments by
// ldmatrix.trans, accumulated in the tensor core's f32 accumulators as the
// tuned bf16 kernel accumulates. It does not split the warps into producers
// and consumers as the tuned kernel does (its blocks meet twice a chunk):
// configuration C's bf16 encode (P = 24) took 29.2 ms on the any-P CUDA-core
// kernel and 3.33-3.36 ms here, against the plain bf16 version's
// 17.0-18.9 and the tuned P = 15 kernel's 2.00-2.02 (tools/bench_any_routes.py,
// NVIDIA H100 80GB HBM3, 700 W).
constexpr int kAnyBAS = kPC * kXC + 8;  // bf16 A chunk row stride: 132 words, 4 mod 32

template <int NT> __host__ __device__ constexpr int any_bw_groups() { return NT == 8 ? 3 : 4; }
template <int NT> __host__ __device__ constexpr int any_bw_stride() {
  return NT == 1 ? 24 : 8 * NT + 8;  // bf16; rows odd multiples of 16 bytes
}
__host__ __device__ inline int any_kpad16(int K) { return (K + 15) / 16 * 16; }

template <int NT>
size_t tc_any_p_bf16_smem_bytes(int K, int P) {
  const int kst = any_kpad16(K) + 8;
  return sizeof(float4) * P +
         sizeof(__nv_bfloat16) * ((size_t)kTQ * kPC * kst + (size_t)kTQ * kAnyBAS +
                                  (size_t)8 * any_bw_groups<NT>() * 16 * any_bw_stride<NT>()) +
         sizeof(float) * kTQ * K + sizeof(int) * (2 * (size_t)kTQ * K + kTQ);
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 1) kpconv_tc_any_p_bf16_kernel(
    const float* __restrict__ q_pts, const __nv_bfloat16* __restrict__ table,
    const int32_t* __restrict__ inds, const float* __restrict__ kp,
    const __nv_bfloat16* __restrict__ w, float* __restrict__ out, int Nq, int Ns, int K, int Cin,
    int P, int p_split, Mode mode, int kind) {
  constexpr int kCout = 64 * NT, kG = any_bw_groups<NT>(), kWS = any_bw_stride<NT>();
  constexpr int kQW = kTQ / 8;  // queries whose A rows a warp builds
  const int kpad = any_kpad16(K), kst = kpad + 8;
  extern __shared__ __align__(16) unsigned char tc_any_bf16_smem[];
  float4* kps = reinterpret_cast<float4*>(tc_any_bf16_smem);                 // [P]
  __nv_bfloat16* infl = reinterpret_cast<__nv_bfloat16*>(kps + P);          // [TQ][PC][kst]
  __nv_bfloat16* abuf = infl + kTQ * kPC * kst;                             // [TQ][kAnyBAS]
  __nv_bfloat16* wbuf = abuf + kTQ * kAnyBAS;                               // [warp][G][16][kWS]
  float* fsum = reinterpret_cast<float*>(wbuf + 8 * kG * 16 * kWS);         // [TQ][K]
  int* nbr = reinterpret_cast<int*>(fsum + kTQ * K);                        // [TQ][K], -1 = none
  int* nearest = nbr + kTQ * K;                                             // [TQ][K]
  int* cnt = nearest + kTQ * K;                                             // [TQ]

  const int row = 8 + Cin;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTQ;
  const int p_begin = blockIdx.z * p_split, p_end = min(P, p_begin + p_split);
  const int n_ch = Cin / kXC;
  const int n_groups = (p_end - p_begin) * n_ch;  // W groups: a point's 16 rows of a channel chunk
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int col_w = warp * 8 * NT;
  const Bf16Rows rows{table, Ns, Cin};
  __nv_bfloat16* wring = wbuf + warp * kG * 16 * kWS;

  // W groups in the order they are used (chunk of points, chunk of channels,
  // point): a cursor that load_w advances
  int wp0 = p_begin, wch = 0, wj = 0;
  auto load_w = [&](int gi) {
    if (gi < n_groups) {
      const __nv_bfloat16* src = w + ((size_t)(wp0 + wj) * Cin + kXC * wch) * kCout + col_w;
      __nv_bfloat16* dst = wring + (gi % kG) * 16 * kWS;
#pragma unroll
      for (int i = lane; i < 16 * NT; i += 32) {
        const int r = i / NT, c = 8 * (i - r * NT);
        cp_async16_bf16(dst + r * kWS + c, src + (size_t)r * kCout + c, true);
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

  const unsigned short* tb =
      reinterpret_cast<const unsigned short*>(table + (size_t)b * (Ns + 1) * row + 8) + g;
  int gi = 0;
  for (int pc0 = p_begin; pc0 < p_end; pc0 += kPC) {
    const int npc = min(kPC, p_end - pc0);
    const bool first = pc0 == p_begin;
    __syncthreads();  // the neighbour table is in place; the last chunk's influences are consumed
    chunk_influences(infl, kst, kpad, q_pts, rows, kps, nbr, nearest, b, q0, Nq, K, pc0, npc,
                     mode, kind);
    __syncthreads();
    for (int ch = 0; ch < n_ch; ++ch) {
      // A[q][16 p + c] = bf16(sum_k infl[q, p, k] x[nbr[q, k], 16 ch + c])
#pragma unroll 1
      for (int i = 0; i < kQW; ++i) {
        const int aq = kQW * warp + i;
        const int* nq = nbr + aq * K;
        const unsigned short* xc = tb + kXC * ch;
        // B fragments of X: neighbour 16 ks + 2 t + (e & 1) + 8 (e >> 1),
        // channel 8 n + g, as bf16 bits
        uint32_t xw[kKPadMax / 16][2][4];
#pragma unroll
        for (int ks = 0; ks < kKPadMax / 16; ++ks)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kk = 16 * ks + 2 * t + (e & 1) + 8 * (e >> 1);
            const int nb = kk < K ? nq[kk] : -1;
#pragma unroll
            for (int n = 0; n < 2; ++n)
              xw[ks][n][e] = nb >= 0 ? (uint32_t)__ldg(xc + (size_t)nb * row + 8 * n) : 0u;
          }
        if (first) {
          // the chunk's share of each neighbour's feature sum (f32), over the
          // 8 lanes of a quad column
#pragma unroll
          for (int ks = 0; ks < kKPadMax / 16; ++ks)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float fs = __uint_as_float(xw[ks][0][e] << 16) + __uint_as_float(xw[ks][1][e] << 16);
              fs += __shfl_xor_sync(0xffffffffu, fs, 4);
              fs += __shfl_xor_sync(0xffffffffu, fs, 8);
              fs += __shfl_xor_sync(0xffffffffu, fs, 16);
              const int kk = 16 * ks + 2 * t + (e & 1) + 8 * (e >> 1);
              if (g == 0 && kk < K) fsum[aq * K + kk] += fs;
            }
        }
        float c[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < kKPadMax / 16; ++ks) {
          if (16 * ks >= kpad) break;
          const __nv_bfloat16* ia = infl + (aq * kPC + g) * kst + 16 * ks + 2 * t;
          const uint32_t a[4] = {ld_pair(ia), ld_pair(ia + 8 * kst), ld_pair(ia + 8),
                                 ld_pair(ia + 8 * kst + 8)};
#pragma unroll
          for (int n = 0; n < 2; ++n)
            mma_bf16(c[n], a, xw[ks][n][0] | xw[ks][n][1] << 16, xw[ks][n][2] | xw[ks][n][3] << 16);
        }
        __nv_bfloat16* arow = abuf + aq * kAnyBAS;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          *reinterpret_cast<uint32_t*>(arow + g * kXC + 8 * n + 2 * t) = pack_bf16(c[n][0], c[n][1]);
          *reinterpret_cast<uint32_t*>(arow + (g + 8) * kXC + 8 * n + 2 * t) =
              pack_bf16(c[n][2], c[n][3]);
        }
      }
      __syncthreads();  // the A chunk is complete

      // the contraction: point j of the chunk is A columns [16 j, 16 j + 16)
      // (one k-step) against its 16 W rows of this channel chunk
      for (int j = 0; j < npc; ++j, ++gi) {
        cp_async_wait<kG - 2>();
        __syncwarp();  // the warp's W group gi is in place; group gi - 1 is consumed
        load_w(gi + kG - 1);
        const __nv_bfloat16* wg = wring + (gi % kG) * 16 * kWS;
        uint32_t a[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const __nv_bfloat16* ar = abuf + (16 * m + g) * kAnyBAS + kXC * j + 2 * t;
          a[m][0] = ld_pair(ar);
          a[m][1] = ld_pair(ar + 8 * kAnyBAS);
          a[m][2] = ld_pair(ar + 8);
          a[m][3] = ld_pair(ar + 8 * kAnyBAS + 8);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, wg + (lane % 16) * kWS + 8 * n);
#pragma unroll
          for (int m = 0; m < 2; ++m) mma_bf16(acc[m][n], a[m], b0, b1);
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
cudaError_t launch_tc_any_p_bf16(const float* q_pts, const __nv_bfloat16* table,
                                 const int32_t* inds, const float* kp, const __nv_bfloat16* w,
                                 float* out, int B, int Nq, int Ns, int K, int Cin, int P,
                                 Mode mode, int kind, cudaStream_t stream) {
  const size_t smem = tc_any_p_bf16_smem_bytes<NT>(K, P);
  cudaError_t err = cudaFuncSetAttribute(
      kpconv_tc_any_p_bf16_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kpconv_tc_any_p_bf16_kernel<NT>, kThreads, smem)) != cudaSuccess)
    return err;
  const int tiles = (Nq + kTQ - 1) / kTQ;
  const int splits = P > 1 && tiles * B < 2 * sms * per_sm ? 2 : 1;
  const int p_split = (P + splits - 1) / splits;
  if (splits > 1 && (err = cudaMemsetAsync(out, 0, sizeof(float) * B * Nq * 64 * NT,
                                           stream)) != cudaSuccess)
    return err;
  dim3 grid(tiles, B, splits);
  kpconv_tc_any_p_bf16_kernel<NT><<<grid, kThreads, smem, stream>>>(
      q_pts, table, inds, kp, w, out, Nq, Ns, K, Cin, P, p_split, mode, kind);
  return cudaGetLastError();
}

// The any-P tensor-core kernel at this Cout, if its tiles fit in shared memory.
cudaError_t forward_tc_any_p_bf16(const float* q_pts, const __nv_bfloat16* table,
                                  const int32_t* inds, const float* kp, const __nv_bfloat16* w,
                                  float* out, int B, int Nq, int Ns, int K, int Cin, int Cout,
                                  int P, Mode mode, int kind, cudaStream_t stream, bool* taken) {
  *taken = true;
  switch (Cout) {
    case 64:
      if (tc_any_p_bf16_smem_bytes<1>(K, P) <= kTcSmemMax)
        return launch_tc_any_p_bf16<1>(q_pts, table, inds, kp, w, out, B, Nq, Ns, K, Cin, P, mode, kind, stream);
      break;
    case 128:
      if (tc_any_p_bf16_smem_bytes<2>(K, P) <= kTcSmemMax)
        return launch_tc_any_p_bf16<2>(q_pts, table, inds, kp, w, out, B, Nq, Ns, K, Cin, P, mode, kind, stream);
      break;
    case 256:
      if (tc_any_p_bf16_smem_bytes<4>(K, P) <= kTcSmemMax)
        return launch_tc_any_p_bf16<4>(q_pts, table, inds, kp, w, out, B, Nq, Ns, K, Cin, P, mode, kind, stream);
      break;
    case 512:
      if (tc_any_p_bf16_smem_bytes<8>(K, P) <= kTcSmemMax)
        return launch_tc_any_p_bf16<8>(q_pts, table, inds, kp, w, out, B, Nq, Ns, K, Cin, P, mode, kind, stream);
      break;
    default:
      break;
  }
  *taken = false;
  return cudaSuccess;
}

// ---- the any-shape tensor-core kernel in bf16 (every shape the kernels above refuse) ----
//
// The f32 any-shape kernel's tiling (kpconv.cu, its shared steps in
// kpconv_common.cuh) at the roundings of Bf16Rows: the A rows built with
// mma.sync m16n8k16 (per staged chunk of 32 neighbours, 2 k-steps of 16; lane
// (g, t) computes the influences of kernel points g and g + 8 on neighbours
// 2 t, 2 t + 1, 2 t + 8, 2 t + 9 of a k-step in f32, rounds them to bf16 as
// its A fragment, and reads channel g of those neighbours' table rows as its B
// fragments), summed in the tensor core's f32 accumulators and rounded to bf16
// into the A chunk; the contraction on m16n8k16 with W's B fragments by
// ldmatrix.trans, accumulated in the tensor core as the tuned bf16 kernel
// accumulates. What bounds it: as the f32 kernel, the products at the bf16
// rate (989 TFLOP/s).
template <int NT> __host__ __device__ constexpr int gen_bw_groups() { return NT == 8 ? 3 : 4; }
// bf16 A chunk row stride: 8 nc + 4 words, an odd multiple of 4
__host__ __device__ inline int gen_ba_stride(int Cin) { return 16 * (Cin < kGCC ? Cin : kGCC) + 8; }

template <int NT>
size_t any_shape_bf16_smem_bytes(int P, int Cin) {
  return sizeof(float4) * P +
         sizeof(__nv_bfloat16) * ((size_t)kGQ * gen_ba_stride(Cin) +
                                  (size_t)kWarps * gen_bw_groups<NT>() * 16 * any_bw_stride<NT>()) +
         sizeof(StagedNeighbours) * kWarps + sizeof(int) * kGQ;
}

// The A row of query q for kernel points [pc0, pc0 + 16) and channels
// [c0, c0 + nc) (nc <= 32), A[p][c] = bf16(sum_k bf16(infl[k, p])
// x[nbr[k], c0 + c]), at arow[p nc + c] (the pad points' rows zero). With
// `count`, returns the query's density count at every lane from the same
// loads (feature sums in f32), else 0.
__device__ int bf16_row(__nv_bfloat16* arow, StagedNeighbours& st, const float* q_pts,
                        const __nv_bfloat16* table, const int32_t* inds, const float4* kps, int P,
                        int pc0, int b, int q, int Nq, int Ns, int K, int Cin, int c0, int nc,
                        bool count, const Mode& mode, int kind, int lane) {
  const int g = lane / 4, t = lane % 4;
  const int nx = (nc + 7) / 8, row = 8 + Cin;
  const Bf16Rows rows{table, Ns, Cin};
  const float4 kq0 = kps[min(pc0 + g, P - 1)], kq1 = kps[min(pc0 + g + 8, P - 1)];
  const unsigned short* xc =
      reinterpret_cast<const unsigned short*>(table + (size_t)b * (Ns + 1) * row + 8) + c0 + g;
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
    // B fragments as bf16 bits: neighbour 16 ks + 2 t + (e & 1) + 8 (e >> 1),
    // channel c0 + 8 n + g
    uint32_t xw[2][4][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int nb = st.nb[16 * ks + 2 * t + (e & 1) + 8 * (e >> 1)];
#pragma unroll
        for (int n = 0; n < 4; ++n)
          xw[ks][n][e] = nb >= 0 && 8 * n + g < nc ? (uint32_t)__ldg(xc + (size_t)nb * row + 8 * n) : 0u;
      }
    if (count) {
      // entry 4 ks + e: this lane's channels of neighbour 16 ks + 2 t + (e & 1)
      // + 8 (e >> 1); after the reduce-scatter, lane (g, t) holds entry g's
      float fs[8];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          fs[4 * ks + e] = (bf16_lo(xw[ks][0][e]) + bf16_lo(xw[ks][1][e])) +
                           (bf16_lo(xw[ks][2][e]) + bf16_lo(xw[ks][3][e]));
      column_reduce_scatter8(fs, lane);
      n_pos += st.nb[16 * (g / 4) + 2 * t + (g & 1) + 8 * ((g >> 1) & 1)] >= 0 && fs[0] > 0.f;
    }
    const int kc = min(kGKC, K - k0);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      if (16 * ks >= kc) break;
      // the influences of points g (h = 0) and g + 8 (h = 1) on neighbour e
      float f[4][2];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 16 * ks + 2 * t + (e & 1) + 8 * (e >> 1);
        const float4 r = st.rel[j];
        const int nb = st.nb[j], near = st.near[j];
        f[e][0] = influence_at(r, nb, near, pc0 + g, P, kq0, mode, kind);
        f[e][1] = influence_at(r, nb, near, pc0 + g + 8, P, kq1, mode, kind);
      }
      const uint32_t a[4] = {pack_bf16(f[0][0], f[1][0]), pack_bf16(f[0][1], f[1][1]),
                             pack_bf16(f[2][0], f[3][0]), pack_bf16(f[2][1], f[3][1])};
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if (n >= nx) break;
        mma_bf16(c[n], a, xw[ks][n][0] | xw[ks][n][1] << 16, xw[ks][n][2] | xw[ks][n][3] << 16);
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
      if (ch < nc) arow[(g + 8 * (e >> 1)) * nc + ch] = __float2bfloat16_rn(c[n][e]);
    }
  }
  return count ? __reduce_add_sync(0xffffffffu, n_pos) : 0;
}

// Blocks (tile of 32 queries, pair, column block of 64 NT), as the f32
// any-shape kernel's; a W group is one k-step of 16 rows.
template <int NT>
__global__ void __launch_bounds__(kThreads, NT <= 2 ? 2 : 1) kpconv_any_shape_bf16_kernel(
    const float* __restrict__ q_pts, const __nv_bfloat16* __restrict__ table,
    const int32_t* __restrict__ inds, const float* __restrict__ kp,
    const __nv_bfloat16* __restrict__ w, float* __restrict__ out, int Nq, int Ns, int K, int Cin,
    int Cout, int P, Mode mode, int kind, int w16) {
  constexpr int kG = gen_bw_groups<NT>(), kWS = any_bw_stride<NT>();
  const int as = gen_ba_stride(Cin);
  extern __shared__ __align__(16) unsigned char gen_bf16_smem[];
  float4* kps = reinterpret_cast<float4*>(gen_bf16_smem);                      // [P]
  __nv_bfloat16* abuf = reinterpret_cast<__nv_bfloat16*>(kps + P);            // [kGQ][as]
  __nv_bfloat16* wbuf = abuf + kGQ * as;                                      // [warp][G][16][kWS]
  StagedNeighbours* staged =
      reinterpret_cast<StagedNeighbours*>(wbuf + kWarps * kG * 16 * kWS);    // [warp]
  int* cnt = reinterpret_cast<int*>(staged + kWarps);                        // [kGQ]

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kGQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int col_w = blockIdx.z * 64 * NT + warp * 8 * NT;
  const bool has_cols = col_w < Cout;
  const Bf16Rows rows{table, Ns, Cin};
  __nv_bfloat16* wring = wbuf + warp * kG * 16 * kWS;

  // W group (one k-step: the cursor's next 16 rows, columns [col_w, col_w +
  // 8 NT)) into ring slot `slot`: 16-byte cp.async where W's rows allow it
  // (zero-filled past Cout and for pad rows), else plain loads
  WCursor cur;
  auto load_w = [&](int slot) {
    if (!cur.done(P)) {
      __nv_bfloat16* dst = wring + slot * 16 * kWS;
      if (w16) {
#pragma unroll
        for (int i = lane; i < 16 * NT; i += 32) {
          const int r = i / NT, c = col_w + 8 * (i % NT);
          const int row = cur.row(r, P, Cin);
          const bool in = row >= 0 && c < Cout;
          cp_async16_bf16(dst + r * kWS + (c - col_w), in ? w + (size_t)row * Cout + c : w, in);
        }
      } else {
        const unsigned short* ws = reinterpret_cast<const unsigned short*>(w);
        unsigned short* ds = reinterpret_cast<unsigned short*>(dst);
        for (int i = lane; i < 16 * 8 * NT; i += 32) {
          const int r = i / (8 * NT), c = col_w + i % (8 * NT);
          const int row = cur.row(r, P, Cin);
          ds[r * kWS + (c - col_w)] = row >= 0 && c < Cout ? __ldg(ws + (size_t)row * Cout + c) : 0;
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
      const int n = dense_count(rows, inds, b, q0 + kGQW * warp + i, Nq, Ns, K, Cin, lane);
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
        __nv_bfloat16* arow = abuf + aq * as;
        const int n = Cin == 1
            ? cin1_row<__nv_bfloat16>(arow, q_pts, rows, inds, kps, P, pc0, b, q0 + aq, Nq, Ns,
                                      K, mode, kind, lane)
            : bf16_row(arow, staged[warp], q_pts, table, inds, kps, P, pc0, b, q0 + aq, Nq, Ns,
                       K, Cin, c0, nc, count, mode, kind, lane);
        if (count && lane == 0) cnt[aq] = n;
      }
      __syncthreads();  // the A chunk is complete

      if (has_cols) {
        const int groups = (npc * nc + 15) / 16;
        for (int gl = 0; gl < groups; ++gl, ++gi) {
          cp_async_wait<kG - 2>();
          __syncwarp();  // the warp's group gi is in place; group gi - 1 is consumed
          load_w((gi + kG - 1) % kG);
          const __nv_bfloat16* wg = wring + (gi % kG) * 16 * kWS;
          uint32_t a[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const __nv_bfloat16* ar = abuf + (16 * m + g) * as + 16 * gl + 2 * t;
            a[m][0] = ld_pair(ar);
            a[m][1] = ld_pair(ar + 8 * as);
            a[m][2] = ld_pair(ar + 8);
            a[m][3] = ld_pair(ar + 8 * as + 8);
          }
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            uint32_t b0, b1;
            ldmatrix_x2_trans(b0, b1, wg + (lane % 16) * kWS + 8 * n);
#pragma unroll
            for (int m = 0; m < 2; ++m) mma_bf16(acc[m][n], a[m], b0, b1);
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
cudaError_t launch_any_shape_bf16_nt(const float* q_pts, const __nv_bfloat16* table,
                                     const int32_t* inds, const float* kp,
                                     const __nv_bfloat16* w, float* out, int B, int Nq, int Ns,
                                     int K, int Cin, int Cout, int P, Mode mode, int kind,
                                     cudaStream_t stream) {
  static unsigned devices_done = 0;
  const size_t smem = any_shape_bf16_smem_bytes<NT>(P, Cin);
  if (smem > kTcSmemMax) return cudaErrorInvalidValue;  // P past ~9,000 kernel points
  const cudaError_t err = allow_shared_memory(kpconv_any_shape_bf16_kernel<NT>, devices_done);
  if (err != cudaSuccess) return err;
  const int w16 = (uintptr_t)w % 16 == 0 && Cout % 8 == 0;
  dim3 grid((Nq + kGQ - 1) / kGQ, B, (Cout + 64 * NT - 1) / (64 * NT));
  kpconv_any_shape_bf16_kernel<NT><<<grid, kThreads, smem, stream>>>(
      q_pts, table, inds, kp, w, out, Nq, Ns, K, Cin, Cout, P, mode, kind, w16);
  return cudaGetLastError();
}

// The any-shape kernel with 8 NT columns a warp: the fewest that cover Cout,
// up to 64 (512 columns a block).
cudaError_t launch_any_shape_bf16(const float* q_pts, const __nv_bfloat16* table,
                                  const int32_t* inds, const float* kp, const __nv_bfloat16* w,
                                  float* out, int B, int Nq, int Ns, int K, int Cin, int Cout,
                                  int P, Mode mode, int kind, cudaStream_t stream) {
  if (Cout <= 64)
    return launch_any_shape_bf16_nt<1>(q_pts, table, inds, kp, w, out, B, Nq, Ns, K, Cin, Cout, P, mode, kind, stream);
  if (Cout <= 128)
    return launch_any_shape_bf16_nt<2>(q_pts, table, inds, kp, w, out, B, Nq, Ns, K, Cin, Cout, P, mode, kind, stream);
  if (Cout <= 256)
    return launch_any_shape_bf16_nt<4>(q_pts, table, inds, kp, w, out, B, Nq, Ns, K, Cin, Cout, P, mode, kind, stream);
  return launch_any_shape_bf16_nt<8>(q_pts, table, inds, kp, w, out, B, Nq, Ns, K, Cin, Cout, P, mode, kind, stream);
}

// The bf16 path of one influence mode, chosen as the f32 path's. *route:
// which kernel ran (Route).
template <int Infl>
cudaError_t forward_bf16(const float* q_pts, const __nv_bfloat16* table, const int32_t* inds,
                         const float* kp, const __nv_bfloat16* w, float* out, int B, int Nq,
                         int Ns, int K, int Cin, int Cout, int P, Mode mode, int* route,
                         cudaStream_t stream) {
  const bool aligned = ((uintptr_t)table | (uintptr_t)w | (uintptr_t)out) % 16 == 0;
  const bool tc_shape = Cin % kCC == 0 && K <= kKMax && aligned;
  if (tc_shape && P != kP) {
    bool taken;
    *route = kRouteAnyPTensorCores;
    const cudaError_t err = forward_tc_any_p_bf16(q_pts, table, inds, kp, w, out, B, Nq, Ns, K,
                                                  Cin, Cout, P, mode, Infl, stream, &taken);
    if (taken) return err;
  }
  if (tc_shape && P == kP) {
    *route = kRouteTuned;
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
  *route = kRouteAnyShape;
  return launch_any_shape_bf16(q_pts, table, inds, kp, w, out, B, Nq, Ns, K, Cin, Cout, P, mode,
                               Infl, stream);
}

}  // namespace

extern "C" {

// The bf16 instance. q_pts [B, Nq, 3] f32, table [B, Ns + 1, 8 + Cin] bf16
// (hi(pos), lo(pos), 0, 0, features; row Ns the shadow row), inds [B, Nq, K] int32
// (sentinel Ns), kp [P, 3] f32, w [P, Cin, Cout] bf16, out [B, Nq, Cout] f32;
// any P >= 1; all contiguous; the modes and *route as kpconv_forward's. Returns a
// cudaError_t (0 on success).
int kpconv_forward_bf16(const float* q_pts, const __nv_bfloat16* table, const int32_t* inds,
                        const float* kp, const __nv_bfloat16* w, float* out, int B, int Nq,
                        int Ns, int K, int Cin, int Cout, int P, float extent, int influence,
                        int closest, float gauss_den, int* route, cudaStream_t stream) {
  if (P <= 0 || B <= 0 || Nq <= 0 || K <= 0 || Cin <= 0 || Cout <= 0)
    return (int)cudaErrorInvalidValue;
  const Mode mode{extent, gauss_den, closest != 0};
  switch (influence) {
    case kLinear:
      return (int)forward_bf16<kLinear>(q_pts, table, inds, kp, w, out, B, Nq, Ns, K, Cin, Cout,
                                        P, mode, route, stream);
    case kConstant:
      return (int)forward_bf16<kConstant>(q_pts, table, inds, kp, w, out, B, Nq, Ns, K, Cin,
                                          Cout, P, mode, route, stream);
    case kGaussian:
      return (int)forward_bf16<kGaussian>(q_pts, table, inds, kp, w, out, B, Nq, Ns, K, Cin,
                                          Cout, P, mode, route, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
