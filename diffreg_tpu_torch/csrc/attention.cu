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

#include <cooperative_groups.h>

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
// any P.V (a one-pass online softmax that rounds exp(s - running max) is as
// far from the XLA path as f32 is), so every row's max and sum are known
// before its first P.V. What bounds it on an H100 at the main path's shapes
// ([4 or 8, 4, 704-768 x 704-768], D 108 or 132): neither bytes nor tensor-
// core flops (a few microseconds each) but latency, the exp and the loads.
// The first version (two passes over all keys in one 64-query block, 4
// warps, one mask byte from global memory per score) took 0.110 ms for the
// cross call at B = 4 and 0.126 for the self call at B = 8 (NVIDIA H100 80GB
// HBM3, 700 W): 176 blocks of 4 warps left the card's SMs with about five
// resident warps, pass 1 took 43% of the time, pass 2 54%, the mask loads
// 16-23%.
//
// Design (0.091 ms for that self call, 0.049 for the cross call, same card):
//  * A cluster of four blocks (thread block clusters, sm_90) owns one tile of
//    64 queries; block r of the cluster takes a quarter of the key tiles (32
//    keys each), so the grid has 4x the blocks: 704 of 4 warps at the cross
//    shape, two to three resident per SM (registers and shared memory).
//  * Pass 1, over the block's K tiles: S = q.k^T on tensor cores (mma.sync
//    m16n8k16 bf16, f32 accumulate; a warp owns 16 query rows, its q
//    fragments in registers), masked and scaled in f32 and kept in shared
//    memory (at most kKeepMax = 256 keys a block, i.e. S <= 1024: 64 KB of
//    f32 logits), with the row's running max and its running sum of
//    exp(s - max). Each block then stores its rows' (max, sum) into every
//    block of the cluster (distributed shared memory), one cluster barrier,
//    and each forms the row's max M and sum L over all keys, in rank order.
//    (A max-only pass 1, then a pass over the kept logits for the sums, one
//    exp a score instead of two, measured slower: a second cluster barrier.)
//  * Pass 2, over the block's V tiles: p = exp(s - M) (1 / L) from the kept
//    logits, rounded to bf16, straight into the A fragments of P.V (the
//    accumulator layout, bf16.cuh); V's B fragments by ldmatrix.trans. For a
//    longer key range the block takes its K tiles again in pass 2 and
//    recomputes S (the same kernel, a branch on the range's length). An
//    IEEE division per probability in place of the reciprocal cost 20-25%.
//  * The blocks' partial P.V sums (f32, in registers) are stored into the
//    block that writes their rows (block r writes rows [16 r, 16 r + 16)) and
//    added there in f32, in rank order; each block writes 16 of the 64 rows
//    in bf16. P is normalised and rounded per entry before P.V, so splitting
//    the keys changes only the order of the f32 sums.
//  * The key mask is read once per block into shared memory (a byte per
//    key of its range). K and V tiles are staged by 8-byte cp.async (a
//    108-wide bf16 row is 216 bytes, not a multiple of 16), a warp per 8
//    rows and a lane per 8 bytes, two slots, the next tile in flight during
//    this one's products (staging by a flat index with a division per copy
//    took a quarter of the kernel's time). D is padded to a multiple of the
//    k-depth 16: instances 112 (D = 108) and 144 (D = 132); shared rows are
//    DPad + 8 bf16 apart (odd multiples of 16 bytes: no bank conflicts for
//    the fragment loads or ldmatrix), logit rows C + 8 floats and partial-sum
//    rows DPad + 24 floats (8 mod 32 words: float2 stores of a half-warp hit
//    distinct banks).
//  * Where a block's time goes (globaltimer stamps, cross call): the start
//    2.3 us, pass 1 6.4, the exchange 2.4, pass 2 4.9, the partial sums 4.8;
//    clusters of eight (half the keys a block), three tile slots and
//    16-key tiles measured no faster.
//  * mma.sync, not wgmma or TMA: TMA needs 16-byte global strides, which a
//    216-byte row does not have, and a padded q/k/v layout would add copies
//    to a host-bound step.

constexpr int kClusterBlocks = 4;  // blocks per query tile, each a quarter of the key tiles
constexpr int kKeepMax = 256;      // a block's key range up to which its logits are kept
constexpr int kRing = 2;           // K/V tile slots: kRing - 1 tiles in flight
constexpr int kBKT = 32;           // keys per tile

template <int kDPad>
__host__ __device__ constexpr int bf16_stride() { return kDPad + 8; }
template <int kDPad>
__host__ __device__ constexpr int partial_stride() { return kDPad + 24; }

// Shared memory of a block whose key range is `range` keys: [logits, then
// the partial sums (f32)][kRing K/V tile slots][each block's row max and sum]
// [mask bytes].
template <int kDPad>
__host__ __device__ constexpr int region_floats(int range, bool keep) {
  return keep && kQT * (range + 8) > kQT * partial_stride<kDPad>() ? kQT * (range + 8)
                                                                   : kQT * partial_stride<kDPad>();
}
template <int kDPad>
size_t smem_bytes_bf16(int range, bool keep) {
  return sizeof(float) * region_floats<kDPad>(range, keep) +
         sizeof(__nv_bfloat16) * kRing * kBKT * bf16_stride<kDPad>() +
         sizeof(float) * 2 * kQT * kClusterBlocks +
         (size_t)range;
}

// Stage rows [s0, s0 + kBKT) of k or v (bf16) into a shared buffer; rows past
// S are zeros. Warp w copies rows [8 w, 8 w + 8), lane c the row's 8-byte
// chunk c (and c + 32: D <= 144 has at most 36 chunks). The caller commits
// the group.
template <int kStride>
__device__ __forceinline__ void load_rows_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               int s0, int S, int D, int warp, int lane) {
  const int chunks = D / 4;
  const bool c0 = lane < chunks, c1 = lane + 32 < chunks;
#pragma unroll
  for (int i = 0; i < kBKT / kWarps; ++i) {
    const int r = warp * (kBKT / kWarps) + i;
    const bool in = s0 + r < S;
    const __nv_bfloat16* row = src + (size_t)(in ? s0 + r : 0) * D + 4 * lane;
    __nv_bfloat16* to = dst + r * kStride + 4 * lane;
    if (c0) cp_async8_bf16(to, row, in);
    if (c1) cp_async8_bf16(to + 128, row + 128, in);
  }
}

// S = q k^T of one 32-key tile for the warp's 16 rows: thread holds keys
// 8n + 2t, 8n + 2t + 1 of rows g (entries 0, 1) and g + 8 (entries 2, 3);
// then masked and scaled: the tile's keys start at index lk0 of the block's
// mask bytes (1 valid, 0 masked: -1e9, 2 past S: -inf).
template <int kDPad>
__device__ __forceinline__ void logits_tile(float (&sc)[kBKT / 8][4],
                                            const uint32_t (&qa)[kDPad / 16][4],
                                            const __nv_bfloat16* kt, const uint8_t* msk,
                                            int lk0, float scale, int g, int t) {
  constexpr int kStride = bf16_stride<kDPad>();
#pragma unroll
  for (int n = 0; n < kBKT / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kDPad / 16; ++kk) {
#pragma unroll
    for (int n = 0; n < kBKT / 8; ++n) {
      const __nv_bfloat16* kr = kt + (8 * n + g) * kStride + 16 * kk + 2 * t;
      mma_bf16(sc[n], qa[kk], ld_pair(kr), ld_pair(kr + 8));
    }
  }
#pragma unroll
  for (int n = 0; n < kBKT / 8; ++n) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = msk[lk0 + 8 * n + 2 * t + j];
      const float fill = m == 0 ? -1.0e9f : -INFINITY;
      const bool valid = m == 1;
      sc[n][j] = valid ? sc[n][j] * scale : fill;
      sc[n][2 + j] = valid ? sc[n][2 + j] * scale : fill;
    }
  }
}

template <int kDPad>
__global__ void __cluster_dims__(kClusterBlocks, 1, 1) __launch_bounds__(kThreads, 3)
    masked_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ k,
                                 const __nv_bfloat16* __restrict__ v,
                                 const uint8_t* __restrict__ kv_mask,
                                 __nv_bfloat16* __restrict__ out, int H, int L, int S, int D,
                                 float scale, int tiles_per_block, int keep) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int kStride = bf16_stride<kDPad>();
  constexpr int kPS = partial_stride<kDPad>();
  constexpr int kKSteps = kDPad / 16;  // k-steps of q.k^T
  constexpr int kNT = kDPad / 8;       // n-tiles of P.V
  constexpr int kTile = kBKT * kStride; // one K or V tile slot (bf16)
  constexpr int kRows = kQT / kClusterBlocks;  // output rows a block writes
  const int range = tiles_per_block * kBKT, ls = range + 8;  // keys of a block; logit row stride
  extern __shared__ __align__(16) unsigned char bf16_smem[];
  // [QT][ls] logits; then [cluster rank][kRows][kPS] the partial sums of the rows this block writes
  float* region = reinterpret_cast<float*>(bf16_smem);
  __nv_bfloat16* ring =
      reinterpret_cast<__nv_bfloat16*>(region + region_floats<kDPad>(range, keep));  // [kRing][KT][kStride]
  float* ml = reinterpret_cast<float*>(ring + kRing * kTile);  // [cluster rank][QT][2]: max, sum
  uint8_t* msk = reinterpret_cast<uint8_t*>(ml + 2 * kQT * kClusterBlocks);  // [range]

  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = (blockIdx.x / kClusterBlocks) * kQT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int w0 = warp * 16 + g, w1 = w0 + 8;  // the thread's rows in the tile
  const int r0 = q0 + w0, r1 = q0 + w1;
  const __nv_bfloat16* qb = q + (size_t)bh * L * D;
  const __nv_bfloat16* kb = k + (size_t)bh * S * D;
  const __nv_bfloat16* vb = v + (size_t)bh * S * D;
  const uint8_t* mb = kv_mask + (size_t)b * S;
  const int n_tiles = (S + kBKT - 1) / kBKT;
  const int my_tiles = max(0, min(tiles_per_block, n_tiles - rank * tiles_per_block));
  const int key0 = rank * range;                 // the block's first key
  const int n_a = my_tiles;                      // pass 1: K tiles
  const int n_steps = n_a + (keep ? my_tiles : 2 * my_tiles);  // pass 2: V (or K, V) tiles

  // stage step `st`'s tile into slot st % kRing (one commit group a step)
  auto stage = [&](int st) {
    if (st < n_steps) {
      const int u = st - n_a;
      const bool is_v = st >= n_a && (keep || (u & 1));
      const int tile = st < n_a ? st : keep ? u : u >> 1;
      load_rows_bf16<kStride>(ring + (st % kRing) * kTile, is_v ? vb : kb, key0 + tile * kBKT, S,
                              D, warp, lane);
    }
    cp_async_commit();
  };
  for (int st = 0; st < kRing - 1; ++st) stage(st);

  // q fragments of rows r0, r1 (zero past L and past D)
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
  // the zero columns [D, kDPad) of every slot (contiguous rows); the mask
  // bytes of the block's keys (1 valid, 0 masked, 2 past S)
  for (int i = tid; i < kRing * kBKT * (kDPad - D); i += kThreads) {
    const int r = i / (kDPad - D), c = D + i - r * (kDPad - D);
    ring[r * kStride + c] = __float2bfloat16_rn(0.f);
  }
  for (int i = tid; i < range; i += kThreads) msk[i] = key0 + i < S ? mb[key0 + i] != 0 : 2;

  // pass 1: logits (kept in shared memory), the rows' running max and sum of
  // exp(s - max), rescaled as the max grows (this thread's keys; summed over
  // the quad after the pass)
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float sc[kBKT / 8][4];
  for (int st = 0; st < n_a; ++st) {
    cp_async_wait<kRing - 2>();
    __syncthreads();  // the tile is in place for all; the slot of step st - 1 is free
    stage(st + kRing - 1);
    logits_tile<kDPad>(sc, qa, ring + (st % kRing) * kTile, msk, st * kBKT, scale, g, t);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < kBKT / 8; ++n) {
      if (keep) {
        const int c = st * kBKT + 8 * n + 2 * t;
        *reinterpret_cast<float2*>(region + w0 * ls + c) = make_float2(sc[n][0], sc[n][1]);
        *reinterpret_cast<float2*>(region + w1 * ls + c) = make_float2(sc[n][2], sc[n][3]);
      }
      mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: the tile holds a key < S
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < kBKT / 8; ++n) {
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
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // every block of the cluster gets this block's (max, sum) of each row, in
  // its slot `rank` (stores to distributed shared memory)
  if (t < kClusterBlocks) {
    float* dst = cluster.map_shared_rank(ml, t) + rank * 2 * kQT;
    dst[2 * w0] = m0;
    dst[2 * w0 + 1] = l0;
    dst[2 * w1] = m1;
    dst[2 * w1 + 1] = l1;
  }
  cluster.sync();  // every block's row maxima and sums are in place

  // each row's max M and sum L of exp(s - M) over all keys, from the blocks'
  // in rank order (every block computes the same values)
  float mm0 = -INFINITY, mm1 = -INFINITY, ll0 = 0.f, ll1 = 0.f;
#pragma unroll
  for (int r = 0; r < kClusterBlocks; ++r) {
    mm0 = fmaxf(mm0, ml[r * 2 * kQT + 2 * w0]);
    mm1 = fmaxf(mm1, ml[r * 2 * kQT + 2 * w1]);
  }
#pragma unroll
  for (int r = 0; r < kClusterBlocks; ++r) {
    const float* mr = ml + r * 2 * kQT;
    if (mr[2 * w0 + 1] > 0.f) ll0 += mr[2 * w0 + 1] * expf(mr[2 * w0] - mm0);
    if (mr[2 * w1 + 1] > 0.f) ll1 += mr[2 * w1 + 1] * expf(mr[2 * w1] - mm1);
  }
  const float inv0 = 1.f / ll0, inv1 = 1.f / ll1;  // the sums are >= 1

  // pass 2: O += P V over the block's keys, P = exp(s - M) (1 / L) rounded to
  // bf16; the logits from shared memory, or (a longer key range) from the K
  // tiles again
  float o[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  for (int st = n_a; st < n_steps; ++st) {
    cp_async_wait<kRing - 2>();
    __syncthreads();
    stage(st + kRing - 1);
    const __nv_bfloat16* tile_p = ring + (st % kRing) * kTile;
    const int u = st - n_a;
    if (!keep && !(u & 1)) {  // a K tile: the logits again
      logits_tile<kDPad>(sc, qa, tile_p, msk, (u >> 1) * kBKT, scale, g, t);
      continue;
    }
    if (keep) {
#pragma unroll
      for (int n = 0; n < kBKT / 8; ++n) {
        const int c = u * kBKT + 8 * n + 2 * t;
        const float2 a = *reinterpret_cast<const float2*>(region + w0 * ls + c);
        const float2 e = *reinterpret_cast<const float2*>(region + w1 * ls + c);
        sc[n][0] = a.x;
        sc[n][1] = a.y;
        sc[n][2] = e.x;
        sc[n][3] = e.y;
      }
    }
#pragma unroll
    for (int n = 0; n < kBKT / 8; ++n) {
      sc[n][0] = expf(sc[n][0] - mm0) * inv0;
      sc[n][1] = expf(sc[n][1] - mm0) * inv0;
      sc[n][2] = expf(sc[n][2] - mm1) * inv1;
      sc[n][3] = expf(sc[n][3] - mm1) * inv1;
    }
    // k-step j covers keys 16 j .. 16 j + 15, whose probabilities are n-tiles
    // 2 j and 2 j + 1 of sc
#pragma unroll
    for (int j = 0; j < kBKT / 16; ++j) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * j][0], sc[2 * j][1]);
      pa[1] = pack_bf16(sc[2 * j][2], sc[2 * j][3]);
      pa[2] = pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]);
      pa[3] = pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3]);
      const __nv_bfloat16* vrow = tile_p + (16 * j + lane % 16) * kStride;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vrow + 8 * n);
        mma_bf16(o[n], pa, b0, b1);
      }
    }
  }
  cp_async_wait<0>();
  cluster.sync();  // every block is done with its logits: the regions take the partial sums

  // warp w's rows [16 w, 16 w + 16) are written by block w (kRows = 16): its
  // partial sums go to slot `rank` of that block's region
  static_assert(kRows == 16, "a warp's 16 rows are one block's share");
  float* dst = cluster.map_shared_rank(region, warp) + rank * kRows * kPS;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    *reinterpret_cast<float2*>(dst + g * kPS + 8 * n + 2 * t) = make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(dst + (g + 8) * kPS + 8 * n + 2 * t) =
        make_float2(o[n][2], o[n][3]);
  }
  cluster.sync();  // every block's partial sums of this block's rows are in place

  // the four partial sums of rows [16 rank, 16 rank + 16), added in rank order
  const int half = D / 2;
  for (int i = tid; i < kRows * half; i += kThreads) {
    const int rr = i / half, c = 2 * (i - rr * half);
    float sx = 0.f, sy = 0.f;
#pragma unroll
    for (int r = 0; r < kClusterBlocks; ++r) {
      const float2 p = *reinterpret_cast<const float2*>(region + (r * kRows + rr) * kPS + c);
      sx += p.x;
      sy += p.y;
    }
    const int row = q0 + kRows * rank + rr;
    if (row < L)
      *reinterpret_cast<uint32_t*>(out + ((size_t)bh * L + row) * D + c) = pack_bf16(sx, sy);
  }
}

template <int kDPad>
int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                const uint8_t* kv_mask, __nv_bfloat16* out, int B, int H, int L, int S, int D,
                float scale, cudaStream_t stream) {
  auto kernel = masked_attention_bf16_kernel<kDPad>;
  const int n_tiles = (S + kBKT - 1) / kBKT;
  const int tiles_per_block = (n_tiles + kClusterBlocks - 1) / kClusterBlocks;
  const int range = tiles_per_block * kBKT;
  const bool keep = range <= kKeepMax;
  const size_t bytes = smem_bytes_bf16<kDPad>(range, keep);
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(kClusterBlocks * ((L + kQT - 1) / kQT), B * H);
  kernel<<<grid, kThreads, bytes, stream>>>(q, k, v, kv_mask, out, H, L, S, D, scale,
                                            tiles_per_block, keep ? 1 : 0);
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
// multiple of 4, at most 144; S at most 2^19 (the mask bytes of a block's key
// range in shared memory). Returns a cudaError_t (0 on success).
int masked_attention_forward_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                  const __nv_bfloat16* v, const uint8_t* kv_mask,
                                  __nv_bfloat16* out, int B, int H, int L, int S, int D,
                                  float scale, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || L <= 0 || S <= 0 || D <= 0 || D > kDMaxBf16 || D % 4 != 0 ||
      S > (1 << 19) || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 8 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (D <= 112)
    return launch_bf16<112>(q, k, v, kv_mask, out, B, H, L, S, D, scale, stream);
  return launch_bf16<144>(q, k, v, kv_mask, out, B, H, L, S, D, scale, stream);
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
