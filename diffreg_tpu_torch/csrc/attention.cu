// Masked multi-head attention forward (flash-style) for Hopper: f32 in 3xTF32
// on the tensor cores (masked_attention_forward), and the JAX package's bf16
// compute path (masked_attention_forward_bf16, described above its kernel).
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
//    The kernel is a template on DPad with three instances: 64 for D <= 64
//    (2D-3D, D = 64), 112 for 64 < D <= 112 (3DMatch, D = 108) and 136 for
//    112 < D <= 136 (4DMatch, D = 132). At D = 64 instance 112 spent 43% of
//    its products on padding and was slower than PyTorch's SDPA.
//  * K and V tiles are staged by cp.async (16 B; a 108-float row is 432 B),
//    rows past S zero-filled, into one buffer each, used alternately: the next
//    tile's K loads while this tile's softmax and P.V run, and the next V
//    while the next S runs. That overlaps every load with products at half
//    the shared memory of a double buffer of both. Shared rows are DPad + 4
//    floats apart (68, 116 or 140: 4, 20 or 12 banks), so every fragment load
//    of q, k and v (8 rows x 4 lanes, or 4 row pairs x 8 lanes) hits 32
//    distinct banks.
//  * 64 queries (4 warps) and 32 keys per tile. DPad 112: 59.4 KB of shared memory (3
//    blocks would fit); the registers (191 a thread, no spills) hold it to 2
//    blocks, 8 warps, per SM: 264 slots on 132 SMs, so the cross calls (176
//    blocks) take one wave and the self calls (352) 1.3. Forcing 3 blocks
//    spills registers. It was the fastest of the tilings tried on the card at
//    the main path's shapes (32 or 64 queries, 32 or 64 keys, a double buffer
//    or this alternation). DPad 136 keeps the tiling: 71.7 KB of shared
//    memory, O in 17 n-tiles, 225 registers a thread with no spills, still 2
//    blocks per SM. DPad 64 keeps it too: 34.8 KB of shared memory, O in 8
//    n-tiles; the 2D-3D image self call ([4, 4, 4602 x 4602]) has 1160 blocks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16.cuh"
#include "tf32.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kQT = 16 * kWarps;     // queries per block
constexpr int kKT = 32;              // keys per tile
constexpr int kThreads = 32 * kWarps;
constexpr int kDMax = 136;           // the widest f32 instance
constexpr int kDMaxBf16 = 144;       // the widest bf16 instance

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

// ---- the bf16 instance (compute_dtype bfloat16) ----
//
// The JAX transformer's bf16 attention at the rounding points of its XLA
// path (diffreg_tpu/nn/transformer.py:414-429, the config's default with
// flash_attention off): logits q.k^T from bf16 operands summed in f32, the
// key mask, the scale and the softmax in f32, the normalised probabilities
// rounded to bf16 for P.V summed in f32, the output rounded to bf16. (The
// Pallas kernel, JAX's flash_attention path, instead rounds q * scale to
// bf16 and multiplies unrounded f32 probabilities by v; the CPU tests bound
// the difference.) The output is bf16: the next op is the bf16 merge
// projection, which rounds its input to bf16 either way, so it equals JAX's
// flash_out_f32 output as the merge reads it.
//
// Rounding the normalised probability needs the row's max and sum before
// any P.V, so the kernel makes two passes over the keys: the first computes
// S = q.k^T tile by tile and keeps the running max and the running sum of
// exp(s - max) (rescaled as the max grows); the second computes S again,
// p = exp(s - max) / sum rounded to bf16, and O += P.V. That is 1.5x the
// products of a one-pass online softmax, on a card whose bf16 tensor cores
// are far from the limit at these shapes.
//
// One bf16 tensor-core pass per product (mma.sync m16n8k16, f32
// accumulate). A warp owns 16 query rows, whose q fragments stay in
// registers for both passes; per 32-key tile S goes to 4 n-tiles of
// accumulators, whose registers are, after the softmax and the rounding, the
// A fragments of P.V (bf16.cuh). K's B fragments are 32-bit shared loads
// (k-major rows); V's come from ldmatrix.trans. O accumulates in the tensor
// core: its sum of normalised terms over at most a few hundred k-steps
// stays far below the bf16 output's rounding. K and V tiles are staged by
// 8-byte cp.async (a 108-wide bf16 row is 216 bytes, not a multiple of 16),
// double-buffered: the next step's tiles load while this one's products
// run. D is padded to a multiple of the k-depth 16: instances 112 (D = 108)
// and 144 (D = 132); shared rows are DPad + 8 bf16 apart (240 or 304 bytes,
// odd multiples of 16: no bank conflicts for the fragment loads or
// ldmatrix).

template <int kDPad>
__host__ __device__ constexpr int bf16_stride() { return kDPad + 8; }

// two buffers each of K and V tiles
template <int kDPad>
constexpr size_t smem_bytes_bf16() { return sizeof(__nv_bfloat16) * bf16_stride<kDPad>() * 4 * kKT; }

// Stage rows [s0, s0 + kKT) of k or v (bf16) into a shared buffer; rows past
// S are zeros. The caller commits the group.
template <int kStride>
__device__ __forceinline__ void load_rows_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               int s0, int S, int D) {
  const int chunks = D / 4;
  for (int i = threadIdx.x; i < kKT * chunks; i += kThreads) {
    const int r = i / chunks, c = 4 * (i - r * chunks);
    const bool in = s0 + r < S;
    cp_async8_bf16(dst + r * kStride + c, src + (in ? (size_t)(s0 + r) * D + c : 0), in);
  }
}

template <int kDPad>
__global__ void __launch_bounds__(kThreads) masked_attention_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ kv_mask,
    __nv_bfloat16* __restrict__ out, int H, int L, int S, int D, float scale) {
  constexpr int kStride = bf16_stride<kDPad>();
  constexpr int kKSteps = kDPad / 16;  // k-steps of q.k^T
  constexpr int kNT = kDPad / 8;       // n-tiles of P.V
  constexpr int kTile = kKT * kStride; // one K or V tile buffer (bf16)
  extern __shared__ __align__(16) unsigned char bf16_smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(bf16_smem);  // [2][KT][kStride]
  __nv_bfloat16* vs = ks + 2 * kTile;                                // [2][KT][kStride]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * kQT + warp * 16 + g, r1 = r0 + 8;
  const __nv_bfloat16* qb = q + (size_t)bh * L * D;
  const __nv_bfloat16* kb = k + (size_t)bh * S * D;
  const __nv_bfloat16* vb = v + (size_t)bh * S * D;
  const uint8_t* mb = kv_mask + (size_t)b * S;
  const int n_tiles = (S + kKT - 1) / kKT;
  const int n_steps = 2 * n_tiles;     // pass 1: K tiles; pass 2: K and V tiles

  // stage step `step`'s tiles into buffer step % 2 (one commit group a step)
  auto stage = [&](int step) {
    if (step < n_steps) {
      const int pass2 = step >= n_tiles;
      const int s0 = (step - pass2 * n_tiles) * kKT;
      load_rows_bf16<kStride>(ks + (step & 1) * kTile, kb, s0, S, D);
      if (pass2) load_rows_bf16<kStride>(vs + (step & 1) * kTile, vb, s0, S, D);
    }
    cp_async_commit();
  };
  stage(0);

  // the zero columns [D, kDPad) of all four buffers (contiguous rows)
  for (int i = tid; i < 4 * kKT * (kDPad - D); i += kThreads) {
    const int r = i / (kDPad - D), c = D + i - r * (kDPad - D);
    ks[r * kStride + c] = __float2bfloat16_rn(0.f);
  }

  // q fragments of rows r0, r1 (zero past L and past D), kept for both passes
  uint32_t qa[kKSteps][4];
  const uint32_t* q0p = reinterpret_cast<const uint32_t*>(qb + (size_t)min(r0, L - 1) * D);
  const uint32_t* q1p = reinterpret_cast<const uint32_t*>(qb + (size_t)min(r1, L - 1) * D);
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    const int c0 = 16 * kk + 2 * t, c1 = c0 + 8;  // D is a multiple of 4: c < D implies c + 1 < D
    qa[kk][0] = (r0 < L && c0 < D) ? __ldg(q0p + c0 / 2) : 0u;
    qa[kk][1] = (r1 < L && c0 < D) ? __ldg(q1p + c0 / 2) : 0u;
    qa[kk][2] = (r0 < L && c1 < D) ? __ldg(q0p + c1 / 2) : 0u;
    qa[kk][3] = (r1 < L && c1 < D) ? __ldg(q1p + c1 / 2) : 0u;
  }

  float o[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums, then the sums

  for (int step = 0; step < n_steps; ++step) {
    const bool pass2 = step >= n_tiles;
    const int s0 = (step - (pass2 ? n_tiles : 0)) * kKT;
    const __nv_bfloat16* kt = ks + (step & 1) * kTile;
    const __nv_bfloat16* vt = vs + (step & 1) * kTile;
    stage(step + 1);
    cp_async_wait<1>();  // this step's tiles have landed (the next step's may be in flight)
    __syncthreads();     // ... for every thread (and, at step 0, the pad columns)

    // S = q k^T for 16 rows x 32 keys, scaled and masked; thread holds keys
    // 8n + 2t, 8n + 2t + 1 of rows g (entries 0, 1) and g + 8 (entries 2, 3)
    float sc[kKT / 8][4];
#pragma unroll
    for (int n = 0; n < kKT / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int n = 0; n < kKT / 8; ++n) {
        const __nv_bfloat16* kr = kt + (8 * n + g) * kStride + 16 * kk + 2 * t;
        mma_bf16(sc[n], qa[kk], ld_pair(kr), ld_pair(kr + 8));
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < kKT / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int s = s0 + 8 * n + 2 * t + j;
        const float fill = s < S ? -1.0e9f : -INFINITY;
        const bool valid = s < S && __ldg(mb + s) != 0;
        sc[n][j] = valid ? sc[n][j] * scale : fill;
        sc[n][2 + j] = valid ? sc[n][2 + j] * scale : fill;
        mx0 = fmaxf(mx0, sc[n][j]);
        mx1 = fmaxf(mx1, sc[n][2 + j]);
      }
    }

    if (!pass2) {
      // running max and sum of exp(s - max)
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: the tile holds a key < S
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int n = 0; n < kKT / 8; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          ps0 += expf(sc[n][j] - mn0);
          ps1 += expf(sc[n][2 + j] - mn1);
        }
      }
      l0 = l0 * expf(m0 - mn0) + ps0;
      l1 = l1 * expf(m1 - mn1) + ps1;
      m0 = mn0;
      m1 = mn1;
      if (step == n_tiles - 1) {  // the rows' sums, over the quad
        l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
        l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
        l0 = 1.f / l0;  // from here on, the reciprocals (the sums are >= 1)
        l1 = 1.f / l1;
      }
    } else {
      // O += P V: k-step j covers keys 16 j .. 16 j + 15, whose probabilities
      // are n-tiles 2 j and 2 j + 1 of sc, rounded to bf16
#pragma unroll
      for (int n = 0; n < kKT / 8; ++n) {
        sc[n][0] = expf(sc[n][0] - m0) * l0;
        sc[n][1] = expf(sc[n][1] - m0) * l0;
        sc[n][2] = expf(sc[n][2] - m1) * l1;
        sc[n][3] = expf(sc[n][3] - m1) * l1;
      }
#pragma unroll
      for (int j = 0; j < kKT / 16; ++j) {
        uint32_t pa[4];
        pa[0] = pack_bf16(sc[2 * j][0], sc[2 * j][1]);
        pa[1] = pack_bf16(sc[2 * j][2], sc[2 * j][3]);
        pa[2] = pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]);
        pa[3] = pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3]);
        const __nv_bfloat16* vrow = vt + (16 * j + lane % 16) * kStride;
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, vrow + 8 * n);
          mma_bf16(o[n], pa, b0, b1);
        }
      }
    }
    __syncthreads();  // this step's buffers are consumed before step + 2 refills them
  }
  cp_async_wait<0>();

#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int d = 8 * n + 2 * t;  // D is a multiple of 4, so d < D implies d + 1 < D
    if (d >= D) continue;
    if (r0 < L)
      *reinterpret_cast<uint32_t*>(out + ((size_t)bh * L + r0) * D + d) =
          pack_bf16(o[n][0], o[n][1]);
    if (r1 < L)
      *reinterpret_cast<uint32_t*>(out + ((size_t)bh * L + r1) * D + d) =
          pack_bf16(o[n][2], o[n][3]);
  }
}

template <int kDPad>
int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                const uint8_t* kv_mask, __nv_bfloat16* out, int B, int H, int L, int S, int D,
                float scale, cudaStream_t stream) {
  auto kernel = masked_attention_bf16_kernel<kDPad>;
  constexpr size_t bytes = smem_bytes_bf16<kDPad>();
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
  if (D <= 64)
    return launch<64>(q, k, v, kv_mask, out, B, H, L, S, D, scale, stream);
  if (D <= 112)
    return launch<112>(q, k, v, kv_mask, out, B, H, L, S, D, scale, stream);
  return launch<136>(q, k, v, kv_mask, out, B, H, L, S, D, scale, stream);
}

// The bf16 instance: q [B, H, L, D], k/v [B, H, S, D] bf16, kv_mask [B, S]
// bool (1 byte), out [B, H, L, D] bf16; contiguous, 8-byte aligned; D a
// multiple of 4, at most 144. Returns a cudaError_t (0 on success).
int masked_attention_forward_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                  const __nv_bfloat16* v, const uint8_t* kv_mask,
                                  __nv_bfloat16* out, int B, int H, int L, int S, int D,
                                  float scale, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || L <= 0 || S <= 0 || D <= 0 || D > kDMaxBf16 || D % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 8 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (D <= 112)
    return launch_bf16<112>(q, k, v, kv_mask, out, B, H, L, S, D, scale, stream);
  return launch_bf16<144>(q, k, v, kv_mask, out, B, H, L, S, D, scale, stream);
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
