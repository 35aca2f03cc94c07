// Masked multi-head attention forward (flash-style, 3xTF32 tensor cores) for Hopper.
//
// Replaces the Pallas TPU kernel diffreg_tpu/ops/pallas/attention_kernel.py:
// _attn_kernel (pallas_call in _forward). Same function: logits = (q * scale) k^T,
// keys with kv_mask == 0 set to -1e9 for every query, keys past S to -inf,
// softmax over keys, then times v; an online softmax over key tiles in f32, so
// the [B, H, L, S] logits never reach device memory. The scale is passed in
// (1/sqrt(D)). Rows of queries past L are not written.
//
// What bounds it on an H100: operations. At L = S = 704, D = 108 or 132 it does
// 4 L S D product flops per (batch, head) against 4 (L + 2 S) D bytes of q, k,
// v and 4 L D bytes of output, far past the ridge point even at the TF32
// tensor-core rate; 3xTF32 spends three tensor-core products per f32 product.
//
// Design:
//  * Products on tensor cores with mma.sync.aligned.m16n8k8 TF32 (f32
//    accumulate), in 3xTF32 (tf32.cuh): each operand is split into hi and lo
//    as its fragment is loaded into registers. mma.sync, not wgmma: its
//    fragments are loaded by hand, so P.V takes V row-major as it lies in
//    shared memory (TF32 wgmma wants both operands K-major, i.e. V transposed,
//    and reads B from shared memory, where both halves of the split would
//    have to be stored), and P goes from the S accumulators straight into the
//    A fragment of P.V: the keys of each 8-wide k-step are taken in the order
//    (0, 2, 4, 6, 1, 3, 5, 7), which is the order the accumulator layout holds
//    them in, and V's B fragment reads its rows in the same order.
//  * A warp owns 16 query rows; S = q.k^T of a 32-key tile and O [16 x DPad]
//    stay in registers. Row max, rescale and row sum run in f32 on the
//    accumulator fragments; the max needs two quad shuffles, the sum is kept
//    per thread and reduced over the quad once at the end. Each tile's P.V
//    goes to fresh accumulators and is folded into O by one f32 FMA with the
//    rescale (O = O alpha + PV): the tensor core's f32 accumulation does not
//    round to nearest, and carrying O through it over all tiles cost f32
//    accuracy.
//  * D is padded to DPad (a multiple of the k-step 8) with zero columns in
//    shared memory, which leaves every product exact; D columns are written.
//    The kernel is a template on DPad with two instances: 112 for D <= 112
//    (3DMatch, D = 108) and 136 for 112 < D <= 136 (4DMatch, D = 132).
//  * K and V tiles are staged by cp.async (16 B; a 108-float row is 432 B),
//    rows past S zero-filled, into one buffer each, used alternately: the next
//    tile's K loads while this tile's softmax and P.V run, and the next V
//    while the next S runs. That overlaps every load with products at half
//    the shared memory of a double buffer of both. Shared rows are DPad + 4
//    floats apart (116 or 140: 20 or 12 banks), so every fragment load of q, k
//    and v (8 rows x 4 lanes, or 4 row pairs x 8 lanes) hits 32 distinct banks.
//  * 64 queries (4 warps) and 32 keys per tile. DPad 112: 59.4 KB of shared memory (3
//    blocks would fit); the registers (191 a thread, no spills) hold it to 2
//    blocks, 8 warps, per SM: 264 slots on 132 SMs, so the cross calls (176
//    blocks) take one wave and the self calls (352) 1.3. Forcing 3 blocks
//    spills registers. It was the fastest of the tilings tried on the card at
//    the main path's shapes (32 or 64 queries, 32 or 64 keys, a double buffer
//    or this alternation). DPad 136 keeps the tiling: 71.7 KB of shared
//    memory, O in 17 n-tiles, 225 registers a thread with no spills, still 2
//    blocks per SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kQT = 16 * kWarps;     // queries per block
constexpr int kKT = 32;              // keys per tile
constexpr int kThreads = 32 * kWarps;
constexpr int kDMax = 136;           // the widest instance

template <int kDPad>
constexpr size_t smem_bytes() { return sizeof(float) * (kDPad + 4) * (kQT + 2 * kKT); }

// Stage rows [s0, s0 + kKT) of k or v into a shared buffer; rows past S are zeros.
template <int kStride>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int s0, int S, int D) {
  const int chunks = D / 4;
  for (int i = threadIdx.x; i < kKT * chunks; i += kThreads) {
    const int r = i / chunks, c = 4 * (i - r * chunks);
    const bool in = s0 + r < S;
    cp_async16(dst + r * kStride + c, src + (in ? (size_t)(s0 + r) * D + c : 0), in);
  }
  cp_async_commit();
}

// kDPad: D padded to a multiple of the k-step 8.
template <int kDPad>
__global__ void __launch_bounds__(kThreads) masked_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const uint8_t* __restrict__ kv_mask,
    float* __restrict__ out, int H, int L, int S, int D, float scale) {
  constexpr int kStride = kDPad + 4;   // shared row stride (floats): no bank conflicts
  constexpr int kKSteps = kDPad / 8;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // [QT][kStride], pre-scaled
  float* ks = qs + kQT * kStride;      // [KT][kStride]
  float* vs = ks + kKT * kStride;      // [KT][kStride]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int l0 = blockIdx.x * kQT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma group row and thread in quad
  const float* qb = q + (size_t)bh * L * D;
  const float* kb = k + (size_t)bh * S * D;
  const float* vb = v + (size_t)bh * S * D;
  const uint8_t* mb = kv_mask + (size_t)b * S;
  const int n_tiles = (S + kKT - 1) / kKT;

  load_rows<kStride>(ks, kb, 0, S, D);
  load_rows<kStride>(vs, vb, 0, S, D);

  // q (scaled) and the zero columns [D, kDPad) of the K and V buffers
  for (int i = tid; i < kQT * kDPad; i += kThreads) {
    const int r = i / kDPad, c = i - r * kDPad;
    qs[r * kStride + c] = (l0 + r < L && c < D) ? qb[(size_t)(l0 + r) * D + c] * scale : 0.f;
  }
  for (int i = tid; i < 2 * kKT * (kDPad - D); i += kThreads) {
    const int r = i / (kDPad - D), c = D + i - r * (kDPad - D);
    ks[r * kStride + c] = 0.f;
  }

  float o[kKSteps][4];
#pragma unroll
  for (int n = 0; n < kKSteps; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g and g + 8
  float l0sum = 0.f, l1sum = 0.f;        // this thread's share of the row sums

  const float* qw = qs + warp * 16 * kStride;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int s0 = tile * kKT;
    const bool more = tile + 1 < n_tiles;
    cp_async_wait<1>();  // pending: this tile's K and V
    __syncthreads();     // K of this tile (and, at tile 0, q and the pad columns) is in place

    // S = q k^T for 16 rows x 32 keys; the hi.hi and correction products go
    // to separate accumulators for independent mma chains.
    float sc[kKT / 8][4], sx[kKT / 8][4];
#pragma unroll
    for (int n = 0; n < kKT / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] = sx[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t ah[4], al[4];
      load_a_3xtf32(qw + 8 * kk, kStride, g, t, ah, al);
#pragma unroll
      for (int n = 0; n < kKT / 8; ++n) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(ks[(8 * n + g) * kStride + 8 * kk + t], bh0, bl0);
        split_tf32(ks[(8 * n + g) * kStride + 8 * kk + t + 4], bh1, bl1);
        mma_tf32(sx[n], al, bh0, bh1);
        mma_tf32(sx[n], ah, bl0, bl1);
        mma_tf32(sc[n], ah, bh0, bh1);
      }
    }
    __syncthreads();  // K is consumed: stage the next tile's K during softmax and P.V
    if (more) load_rows<kStride>(ks, kb, s0 + kKT, S, D);

    // mask, online softmax; thread holds keys 8n + 2t, 8n + 2t + 1 of rows g, g + 8
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < kKT / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int s = s0 + 8 * n + 2 * t + j;
        const float fill = s < S ? -1.0e9f : -INFINITY;
        const bool valid = s < S && __ldg(mb + s) != 0;
        sc[n][j] = valid ? sc[n][j] + sx[n][j] : fill;
        sc[n][2 + j] = valid ? sc[n][2 + j] + sx[n][2 + j] : fill;
        mx0 = fmaxf(mx0, sc[n][j]);
        mx1 = fmaxf(mx1, sc[n][2 + j]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: the tile holds a key < S
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < kKT / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        sc[n][j] = expf(sc[n][j] - mn0);
        sc[n][2 + j] = expf(sc[n][2 + j] - mn1);
        ps0 += sc[n][j];
        ps1 += sc[n][2 + j];
      }
    }
    l0sum = l0sum * al0 + ps0;
    l1sum = l1sum * al1 + ps1;

    if (more) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();  // V of this tile is in place

    // pv = P V of this tile, in fresh accumulators: k-step j covers keys
    // 8j..8j+7 in the order (0,2,4,6,1,3,5,7), so the A fragment is the
    // accumulator of n-tile j as it stands. The three products of one
    // accumulator are kKSteps products apart in the instruction stream.
    float pv[kKSteps][4];
#pragma unroll
    for (int n = 0; n < kKSteps; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[n][i] = 0.f;
#pragma unroll
    for (int j = 0; j < kKT / 8; ++j) {
      uint32_t ah[4], al[4];
      split_tf32(sc[j][0], ah[0], al[0]);
      split_tf32(sc[j][2], ah[1], al[1]);
      split_tf32(sc[j][1], ah[2], al[2]);
      split_tf32(sc[j][3], ah[3], al[3]);
      const float* v0 = vs + (8 * j + 2 * t) * kStride + g;
      uint32_t bh[kKSteps][2], bl[kKSteps][2];
#pragma unroll
      for (int n = 0; n < kKSteps; ++n) {
        split_tf32(v0[8 * n], bh[n][0], bl[n][0]);
        split_tf32(v0[kStride + 8 * n], bh[n][1], bl[n][1]);
      }
#pragma unroll
      for (int n = 0; n < kKSteps; ++n) mma_tf32(pv[n], al, bh[n][0], bh[n][1]);
#pragma unroll
      for (int n = 0; n < kKSteps; ++n) mma_tf32(pv[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
      for (int n = 0; n < kKSteps; ++n) mma_tf32(pv[n], ah, bh[n][0], bh[n][1]);
    }
    // o = o alpha + pv in f32 on CUDA cores: the tensor core's own f32
    // accumulation does not round to nearest, and over the 22 tiles of the
    // main path that error would reach a few 1e-6
#pragma unroll
    for (int n = 0; n < kKSteps; ++n) {
      o[n][0] = fmaf(o[n][0], al0, pv[n][0]);
      o[n][1] = fmaf(o[n][1], al0, pv[n][1]);
      o[n][2] = fmaf(o[n][2], al1, pv[n][2]);
      o[n][3] = fmaf(o[n][3], al1, pv[n][3]);
    }
    __syncthreads();  // V is consumed: stage the next tile's V during the next S
    if (more) load_rows<kStride>(vs, vb, s0 + kKT, S, D);
  }

  l0sum += __shfl_xor_sync(0xffffffffu, l0sum, 1);
  l0sum += __shfl_xor_sync(0xffffffffu, l0sum, 2);
  l1sum += __shfl_xor_sync(0xffffffffu, l1sum, 1);
  l1sum += __shfl_xor_sync(0xffffffffu, l1sum, 2);
  const float inv0 = 1.f / fmaxf(l0sum, 1e-30f), inv1 = 1.f / fmaxf(l1sum, 1e-30f);
  const int r0 = l0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < kKSteps; ++n) {
    const int d = 8 * n + 2 * t;  // D is a multiple of 4, so d < D implies d + 1 < D
    if (d >= D) continue;
    if (r0 < L)
      *reinterpret_cast<float2*>(out + ((size_t)bh * L + r0) * D + d) =
          make_float2(o[n][0] * inv0, o[n][1] * inv0);
    if (r1 < L)
      *reinterpret_cast<float2*>(out + ((size_t)bh * L + r1) * D + d) =
          make_float2(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int kDPad>
int launch(const float* q, const float* k, const float* v, const uint8_t* kv_mask, float* out,
           int B, int H, int L, int S, int D, float scale, cudaStream_t stream) {
  auto kernel = masked_attention_kernel<kDPad>;
  constexpr size_t bytes = smem_bytes<kDPad>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + kQT - 1) / kQT, B * H);
  kernel<<<grid, kThreads, bytes, stream>>>(q, k, v, kv_mask, out, H, L, S, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, H, L, D], k/v [B, H, S, D], kv_mask [B, S] bool (1 byte), out
// [B, H, L, D]; f32, contiguous, 16-byte aligned; D a multiple of 4, at most
// 136. Returns a cudaError_t (0 on success).
int masked_attention_forward(const float* q, const float* k, const float* v,
                             const uint8_t* kv_mask, float* out, int B, int H,
                             int L, int S, int D, float scale, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || L <= 0 || S <= 0 || D <= 0 || D > kDMax || D % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (D <= 112)
    return launch<112>(q, k, v, kv_mask, out, B, H, L, S, D, scale, stream);
  return launch<136>(q, k, v, kv_mask, out, B, H, L, S, D, scale, stream);
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
