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
// Shapes: the tuned instances below take D a multiple of 4 up to 136 (f32) or
// 144 (bf16), 16-byte (f32) or 8-byte (bf16) aligned rows and B * H up to the
// grid's 65535 rows; every other shape the Pallas kernel takes (any D >= 1,
// any alignment, any B * H, any S) goes to the any-D route at the end of the
// file (tensor cores; heads too wide for its shared memory on CUDA cores), in
// either dtype with that dtype's roundings. The entries report which instance
// or branch ran (`route`).
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

#include <algorithm>
#include <map>
#include <mutex>
#include <vector>

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

// A block's key range for S keys, and the shared memory it takes.
template <int kDPad>
size_t bf16_block_bytes(int S, int* tiles_per_block, bool* keep) {
  const int n_tiles = (S + kBKT - 1) / kBKT;
  *tiles_per_block = (n_tiles + kClusterBlocks - 1) / kClusterBlocks;
  const int range = *tiles_per_block * kBKT;
  *keep = range <= kKeepMax;
  return smem_bytes_bf16<kDPad>(range, *keep);
}

template <int kDPad>
int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                const uint8_t* kv_mask, __nv_bfloat16* out, int B, int H, int L, int S, int D,
                float scale, cudaStream_t stream) {
  auto kernel = masked_attention_bf16_kernel<kDPad>;
  int tiles_per_block;
  bool keep;
  const size_t bytes = bf16_block_bytes<kDPad>(S, &tiles_per_block, &keep);
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

// ---- any head width: the any-D route (both dtypes) ----
//
// For the shapes the tuned instances do not take: D not a multiple of 4 (a
// row of D = 54 is 216 bytes in f32, 108 in bf16), D above 136 (f32) or 144
// (bf16), rows not aligned for the tuned instances' copies, B * H above
// 65535, or a bf16 key range whose mask bytes do not fit in shared memory.
// Same function in each dtype, with that dtype's roundings (f32: q * scale,
// then q.k^T; bf16: q.k^T of the bf16 values summed in f32, then masked and
// scaled, the probabilities rounded to bf16 for P.V, the output rounded to
// bf16).
//
// What bounds it on an H100: operations in principle (4 L S D product flops
// per (batch, head), far past the ridge point at D = 216 or 256); in
// practice copying K and V into shared memory. Each block copies every key's
// row (bf16: three times, K, K, V), and those copies ran at 1.0-1.5 TB/s from
// L2 and overlapped little with the products. With the copies cut out, W's
// bf16 self call took 0.097 ms against 0.181 with them (scratch variants,
// NVIDIA H100 80GB HBM3, 700 W). So the tiling gives a block as many query
// rows as twelve warps can hold. Bulk copies (cp.async.bulk, a row an
// instruction, completion on an mbarrier) in place of cp.async measured
// slower where the rows allow them: W's f32 step 1.57 ms against 1.49, the
// 4602^2 bf16 call 1.86 against 1.68 (tools/bench_any_routes.py, same card).
//
// Design (the tensor-core branch, masked_attention_any_d_tc_kernel and its
// bf16 twin): the tuned instances' warp tiling, with D known at run time.
//  * D is padded in shared memory with zero columns to a multiple of kChunk
//    = 32, which leaves every product exact. A warp owns 16 query rows and a
//    column slice of at most kSliceMax = 128 of the padded D (ns slices, each
//    a multiple of 32); O [16 x slice] stays in registers, so any D keeps the
//    registers of a 128-wide instance (an O over all of D = 216 would not
//    fit: instance 136 already takes 225 registers). The slice's loops run 32
//    columns at a time, fully unrolled within the chunk: a runtime bound on
//    every n-tile kept the compiler from interleaving independent mma chains.
//  * The slices share the logits without recomputing them: each warp forms
//    the partial S = q[:, slice] k[:, slice]^T of a 32-key tile on tensor
//    cores, the ns partials of a row group meet in shared memory (a named
//    barrier of the row group's warps) and every warp of the group adds them
//    in slice order, so all of them hold the same S and the same softmax;
//    each then multiplies its P by V[:, slice]. The products are done once:
//    splitting O's columns with the logits recomputed per slice would cost
//    1.5x them at D = 216. The exchange through a block-wide barrier, summed
//    one slice at a time per value, made W's f32 step 2.12 ms; the row
//    group's barrier and sixteen loads a slice, 1.77 (NVIDIA H100 80GB HBM3,
//    700 W).
//  * A block is rw row groups of ns warps; the launcher picks (slice width,
//    rw) for the call's grid with a cost model fitted to sweeps of every
//    tiling (any_d_cost): W's self call takes two slices and six row groups
//    (96 rows), its cross call, half the grid, four 64-column slices of
//    three, C's (D 54) one slice of twelve. x enumerates (query tile, batch x
//    head), so B * H is bounded only by 2^31 / tiles.
//  * K and V rows are staged by cp.async at the widest width the rows'
//    alignment allows (16, 8 or 4 bytes; an f32 row of D = 54 is 216 bytes,
//    8-byte aligned), a warp per row and a lane per piece, rows past S zero-
//    filled; bf16 rows aligned to 2 bytes only are copied by plain loads
//    (cp.async copies 4 bytes at least; TMA would need 16-byte row strides,
//    which these rows do not have). The logits' A (q) and B (K) fragments
//    come by ldmatrix, whose b16 pairs are TF32 values in f32.
//  * f32: one pass with the online softmax of the tuned f32 instance, 3xTF32
//    (tf32.cuh); q in shared memory, scaled; K and V in one buffer each, the
//    next tile's K copied during this tile's P.V, its V during the next S. A
//    32-column chunk's P.V is summed over the tile in the tensor core from
//    zero (three products, four independent chains) and folded into O by one
//    f32 FMA with the rescale, as the tuned instances fold it.
//  * bf16: every row's max and sum are known before its first P.V, as the
//    XLA path's rounding of the normalised probabilities needs (the tuned
//    bf16 instance's reason): pass 1 over the K tiles forms the logits and
//    the rows' running max and sum; pass 2 takes each K tile again, forms the
//    logits again, p = exp(s - M) (1 / L) rounded to bf16 straight into the
//    A fragments, then the V tile (ldmatrix.trans). K and V tiles go through
//    a ring of four slots, three in flight. Neither the kept logits nor the
//    cluster split of the tuned bf16 instance is taken over: keeping W's
//    logits (S = 704) measured no faster (0.269 ms a self call against 0.257
//    recomputed; C's 0.657 against 0.376 on an NVIDIA H100 80GB HBM3, 700
//    W: the kept rows take the shared memory of the blocks that hide
//    latency), and the column slices give a query tile the warps that the
//    cluster gave it.
//  * The CUDA-core branch (masked_attention_wide_d_kernel) takes the heads
//    whose K and V tiles do not fit in shared memory beside q and the
//    exchange (f32 D above 672, bf16 above 832): a block owns 32
//    queries and at most 512 output columns, two passes over the keys on CUDA
//    cores. Its launches are counted apart (*route = 1).
constexpr int kChunk = 32;          // columns of a slice's unrolled inner loops
constexpr int kSliceMax = 128;      // widest column slice a warp owns
constexpr int kAnyWarpsMax = 12;    // ns * rw of the tensor-core branch: 12 warps of at
                                    // most 168 registers fill an SM's register file
constexpr int kAnyRing = 4;         // bf16 K/V tile slots: kAnyRing - 1 tiles in flight
constexpr size_t kAnySmemMax = 227 * 1024;

// Copy `copy` bytes global -> shared (16, 8, 4: cp.async, zero-filled when
// !in; 2: a plain load and store, for bf16 rows aligned to 2 bytes only).
__device__ __forceinline__ void copy_piece(void* dst, const void* src, bool in, int copy) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  if (copy == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(in ? 16 : 0));
  } else if (copy == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
                 "r"(in ? 8 : 0));
  } else if (copy == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(in ? 4 : 0));
  } else {
    *reinterpret_cast<unsigned short*>(dst) =
        in ? __ldg(reinterpret_cast<const unsigned short*>(src)) : (unsigned short)0;
  }
}

// Stage rows [s0, s0 + kKT) of k or v into a shared tile (row stride
// `stride` elements); rows past S are zeros. Warp w copies rows w, w + n_warps,
// ...; lane c the row's pieces c, c + 32, ... The caller commits the group.
template <class T>
__device__ __forceinline__ void stage_any_rows(T* dst, int stride, const T* src, int s0, int S,
                                               int D, int copy, int warp, int n_warps, int lane) {
  const int pieces = D * (int)sizeof(T) / copy;
  for (int r = warp; r < kKT; r += n_warps) {
    const bool in = s0 + r < S;
    const char* from = reinterpret_cast<const char*>(src + (size_t)(in ? s0 + r : 0) * D);
    char* to = reinterpret_cast<char*>(dst + r * stride);
    for (int c = lane; c < pieces; c += 32) copy_piece(to + c * copy, from + c * copy, in, copy);
  }
}

// Add the partial logits of the ns warps of a row group (slot `warp` of xs
// holds this warp's 16 values a lane): every warp of the group adds them in
// slice order, so all of them hold the same sums. The row group's warps meet
// at named barrier 1 + rg; a slot is written again only after the block's
// next barrier.
__device__ __forceinline__ void sum_slices(float (&sc)[kKT / 8][4], float* xs, int warp, int rg,
                                           int ns, int lane) {
#pragma unroll
  for (int n = 0; n < kKT / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) xs[(warp * 16 + 4 * n + i) * 32 + lane] = sc[n][i];
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + rg), "r"(32 * ns) : "memory");
#pragma unroll
  for (int n = 0; n < kKT / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;
  for (int j = 0; j < ns; ++j) {
    const float* xj = xs + (rg * ns + j) * 16 * 32 + lane;
#pragma unroll
    for (int n = 0; n < kKT / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] += xj[(4 * n + i) * 32];
  }
}

// The tensor-core branch's tiling for head width D: padded width (a multiple
// of kChunk), slices, slice width, row groups, threads, shared memory.
struct AnyDPlan {
  int dpad, ns, ds, rw, threads;
  size_t smem;
};

size_t any_d_smem_bytes(const AnyDPlan& p, bool bf16) {
  const int stride = p.dpad + (bf16 ? 8 : 4);
  const size_t tiles = (size_t)(bf16 ? kAnyRing * 2 : 2 * 4) * kKT * stride;  // K and V, or the ring
  const size_t xs = p.ns > 1 ? sizeof(float) * 16 * p.threads : 0;  // partial logits
  return tiles + xs + (bf16 ? 0 : sizeof(float) * 16 * p.rw * stride);  // f32: + q
}

// f32. Shared: K and V tiles [kKT][dpad + 4] (row strides 4 mod 8 floats: the
// fragment loads of q, k and v hit 32 distinct banks), the partial logits
// [warp][16][32 lanes], then the block's q rows [16 rw][dpad + 4], scaled.
__global__ void __launch_bounds__(32 * kAnyWarpsMax) masked_attention_any_d_tc_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const uint8_t* __restrict__ kv_mask, float* __restrict__ out, int H, int L, int S, int D,
    float scale, int q_tiles, int dpad, int ns, int ds, int copy) {
  extern __shared__ __align__(16) float any_tc_smem[];
  const int stride = dpad + 4;
  const int n_warps = blockDim.x / 32, rw = n_warps / ns;
  float* ks = any_tc_smem;
  float* vs = ks + kKT * stride;
  float* xs = vs + kKT * stride;
  float* qs = xs + (ns > 1 ? 16 * blockDim.x : 0);
  const long long bh = blockIdx.x / q_tiles;
  const int l0 = (int)(blockIdx.x - bh * q_tiles) * 16 * rw;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp / ns, c0 = (warp - rg * ns) * ds, cw = min(ds, dpad - c0);
  const float* qb = q + (size_t)bh * L * D;
  const float* kb = k + (size_t)bh * S * D;
  const float* vb = v + (size_t)bh * S * D;
  const uint8_t* mb = kv_mask + (size_t)(bh / H) * S;
  const int n_tiles = (S + kKT - 1) / kKT;

  stage_any_rows(ks, stride, kb, 0, S, D, copy, warp, n_warps, lane);
  cp_async_commit();
  stage_any_rows(vs, stride, vb, 0, S, D, copy, warp, n_warps, lane);
  cp_async_commit();
  // the zero columns [D, dpad) of both tiles (contiguous rows); the block's
  // q rows, scaled, zero past L and past D
  for (int i = tid; i < 2 * kKT * (dpad - D); i += blockDim.x) {
    const int r = i / (dpad - D);
    ks[r * stride + D + i - r * (dpad - D)] = 0.f;
  }
  for (int i = tid; i < 16 * rw * dpad; i += blockDim.x) {
    const int r = i / dpad, c = i - r * dpad;
    qs[r * stride + c] = l0 + r < L && c < D ? qb[(size_t)(l0 + r) * D + c] * scale : 0.f;
  }
  // the lane's ldmatrix rows: q (A: rows lane % 16, columns 4 (lane / 16))
  // and K (B of two n-tiles: keys lane % 8 + 8 (lane / 16), columns 4 ((lane
  // / 8) % 2)), in the warp's slice
  const float* ql = qs + (16 * rg + lane % 16) * stride + c0 + 4 * (lane / 16);
  const float* kl = ks + (lane % 8 + 8 * (lane / 16)) * stride + c0 + 4 * ((lane / 8) % 2);
  const int r0 = l0 + 16 * rg + g, r1 = r0 + 8;

  float o[kSliceMax / 8][4];
#pragma unroll
  for (int n = 0; n < kSliceMax / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g and g + 8
  float l0sum = 0.f, l1sum = 0.f;        // this thread's share of the row sums

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int s0 = tile * kKT;
    const bool more = tile + 1 < n_tiles;
    cp_async_wait<1>();  // pending: this tile's K and V
    __syncthreads();     // K of this tile (and, at tile 0, q and the pad columns) is in place

    // this thread's keys' mask bytes, in flight during the products (1 valid,
    // 0 masked, 2 past S)
    uint32_t mk[kKT / 8][2];
#pragma unroll
    for (int n = 0; n < kKT / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int s = s0 + 8 * n + 2 * t + j;
        mk[n][j] = s < S ? (__ldg(mb + s) != 0) : 2u;
      }
    // the partial S of the slice, 32 columns (4 k-steps) at a time; the hi.hi
    // and correction products in separate accumulators for independent chains
    float sc[kKT / 8][4], sx[kKT / 8][4];
#pragma unroll
    for (int n = 0; n < kKT / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] = sx[n][i] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kSliceMax / kChunk; ++kc) {
      if (kChunk * kc >= cw) break;
#pragma unroll
      for (int k4 = 0; k4 < kChunk / 8; ++k4) {
        const int col = kChunk * kc + 8 * k4;
        uint32_t a[4], ah[4], al[4];
        ldmatrix_x4(a, ql + col);
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(a[i]), ah[i], al[i]);
#pragma unroll
        for (int n2 = 0; n2 < kKT / 16; ++n2) {
          uint32_t b[4];
          ldmatrix_x4(b, kl + 16 * n2 * stride + col);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = 2 * n2 + e;
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(__uint_as_float(b[2 * e]), bh0, bl0);
            split_tf32(__uint_as_float(b[2 * e + 1]), bh1, bl1);
            mma_tf32(sx[n], al, bh0, bh1);
            mma_tf32(sx[n], ah, bl0, bl1);
            mma_tf32(sc[n], ah, bh0, bh1);
          }
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kKT / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] += sx[n][i];
    if (ns > 1) sum_slices(sc, xs, warp, rg, ns, lane);

    // mask, online softmax; thread holds keys 8n + 2t, 8n + 2t + 1 of rows g, g + 8
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < kKT / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float fill = mk[n][j] == 0 ? -1.0e9f : -INFINITY;
        const bool valid = mk[n][j] == 1;
        sc[n][j] = valid ? sc[n][j] : fill;
        sc[n][2 + j] = valid ? sc[n][2 + j] : fill;
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
    // P split for P.V: k-step j covers keys 8j..8j+7 in the order
    // (0,2,4,6,1,3,5,7), so the A fragment is the accumulator of n-tile j as
    // it stands (the tuned instances' order)
    uint32_t pah[kKT / 8][4], pal[kKT / 8][4];
#pragma unroll
    for (int n = 0; n < kKT / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        sc[n][j] = expf(sc[n][j] - mn0);
        sc[n][2 + j] = expf(sc[n][2 + j] - mn1);
        ps0 += sc[n][j];
        ps1 += sc[n][2 + j];
      }
      split_tf32(sc[n][0], pah[n][0], pal[n][0]);
      split_tf32(sc[n][2], pah[n][1], pal[n][1]);
      split_tf32(sc[n][1], pah[n][2], pal[n][2]);
      split_tf32(sc[n][3], pah[n][3], pal[n][3]);
    }
    l0sum = l0sum * al0 + ps0;
    l1sum = l1sum * al1 + ps1;

    cp_async_wait<0>();
    __syncthreads();  // V of this tile is in place; K is consumed: stage the next tile's
                      // K during P.V
    if (more) stage_any_rows(ks, stride, kb, s0 + kKT, S, D, copy, warp, n_warps, lane);
    cp_async_commit();

    // O = O alpha + P V[:, slice], 32 columns (4 n-tiles) at a time: each
    // chunk's P.V summed over the tile in the tensor core from zero, then
    // folded into O by one f32 FMA (the tuned instances' accumulation)
#pragma unroll
    for (int c = 0; c < kSliceMax / kChunk; ++c) {
      if (kChunk * c >= cw) break;
      float pv[kChunk / 8][4];
#pragma unroll
      for (int n = 0; n < kChunk / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[n][i] = 0.f;
#pragma unroll
      for (int j = 0; j < kKT / 8; ++j) {
        const float* v0 = vs + (8 * j + 2 * t) * stride + c0 + kChunk * c + g;
        uint32_t bh[kChunk / 8][2], bl[kChunk / 8][2];
#pragma unroll
        for (int n = 0; n < kChunk / 8; ++n) {
          split_tf32(v0[8 * n], bh[n][0], bl[n][0]);
          split_tf32(v0[stride + 8 * n], bh[n][1], bl[n][1]);
        }
#pragma unroll
        for (int n = 0; n < kChunk / 8; ++n) mma_tf32(pv[n], pal[j], bh[n][0], bh[n][1]);
#pragma unroll
        for (int n = 0; n < kChunk / 8; ++n) mma_tf32(pv[n], pah[j], bl[n][0], bl[n][1]);
#pragma unroll
        for (int n = 0; n < kChunk / 8; ++n) mma_tf32(pv[n], pah[j], bh[n][0], bh[n][1]);
      }
#pragma unroll
      for (int n = 0; n < kChunk / 8; ++n) {
        float* on = o[(kChunk / 8) * c + n];
        on[0] = fmaf(on[0], al0, pv[n][0]);
        on[1] = fmaf(on[1], al0, pv[n][1]);
        on[2] = fmaf(on[2], al1, pv[n][2]);
        on[3] = fmaf(on[3], al1, pv[n][3]);
      }
    }
    __syncthreads();  // V is consumed: stage the next tile's V during the next S
    if (more) stage_any_rows(vs, stride, vb, s0 + kKT, S, D, copy, warp, n_warps, lane);
    cp_async_commit();
  }
  cp_async_wait<0>();

  l0sum += __shfl_xor_sync(0xffffffffu, l0sum, 1);
  l0sum += __shfl_xor_sync(0xffffffffu, l0sum, 2);
  l1sum += __shfl_xor_sync(0xffffffffu, l1sum, 1);
  l1sum += __shfl_xor_sync(0xffffffffu, l1sum, 2);
  const float inv0 = 1.f / fmaxf(l0sum, 1e-30f), inv1 = 1.f / fmaxf(l1sum, 1e-30f);
  float* o0 = out + ((size_t)bh * L + r0) * D;
  float* o1 = out + ((size_t)bh * L + r1) * D;
#pragma unroll
  for (int n = 0; n < kSliceMax / 8; ++n) {
    if (8 * n >= cw) break;
    const int d = c0 + 8 * n + 2 * t;  // scalar stores: rows of odd D are 4-byte aligned
    if (r0 < L && d < D) o0[d] = o[n][0] * inv0;
    if (r0 < L && d + 1 < D) o0[d + 1] = o[n][1] * inv0;
    if (r1 < L && d < D) o1[d] = o[n][2] * inv1;
    if (r1 < L && d + 1 < D) o1[d + 1] = o[n][3] * inv1;
  }
}

// bf16. Shared: a ring of kAnyRing K/V tile slots [kKT][dpad + 8] (row strides
// odd multiples of 16 bytes: the fragment loads and ldmatrix hit distinct
// banks), then the partial logits [warp][16][32 lanes].
__global__ void __launch_bounds__(32 * kAnyWarpsMax) masked_attention_any_d_tc_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ kv_mask,
    __nv_bfloat16* __restrict__ out, int H, int L, int S, int D, float scale, int q_tiles,
    int dpad, int ns, int ds, int copy) {
  extern __shared__ __align__(16) unsigned char any_tc_bf16_smem[];
  const int stride = dpad + 8;
  const int slot = kKT * stride;
  const int n_warps = blockDim.x / 32, rw = n_warps / ns;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(any_tc_bf16_smem);
  float* xs = reinterpret_cast<float*>(ring + kAnyRing * slot);
  const long long bh = blockIdx.x / q_tiles;
  const int l0 = (int)(blockIdx.x - bh * q_tiles) * 16 * rw;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp / ns, c0 = (warp - rg * ns) * ds, cw = min(ds, dpad - c0);
  const __nv_bfloat16* qb = q + (size_t)bh * L * D;
  const __nv_bfloat16* kb = k + (size_t)bh * S * D;
  const __nv_bfloat16* vb = v + (size_t)bh * S * D;
  const uint8_t* mb = kv_mask + (size_t)(bh / H) * S;
  const int n_tiles = (S + kKT - 1) / kKT;
  const int n_steps = 3 * n_tiles;  // pass 1: K tiles; pass 2: K, V of each tile

  // stage step `st`'s tile into slot st % kAnyRing (one commit group a step)
  auto stage = [&](int st) {
    if (st < n_steps) {
      const int u = st - n_tiles;
      const bool is_v = st >= n_tiles && (u & 1);
      const int tile = st < n_tiles ? st : u >> 1;
      stage_any_rows(ring + (st % kAnyRing) * slot, stride, is_v ? vb : kb, tile * kKT, S, D,
                     copy, warp, n_warps, lane);
    }
    cp_async_commit();
  };
  for (int st = 0; st < kAnyRing - 1; ++st) stage(st);
  for (int i = tid; i < kAnyRing * kKT * (dpad - D); i += blockDim.x) {
    const int r = i / (dpad - D);
    ring[r * stride + D + i - r * (dpad - D)] = __float2bfloat16_rn(0.f);
  }

  // the warp's q fragments (A of m16n8k16) over its slice; zero past L and D
  const int r0 = l0 + 16 * rg + g, r1 = r0 + 8;
  auto qpair = [&](int r, int c, bool on) -> uint32_t {
    if (!on || r >= L) return 0u;
    const __nv_bfloat16* p = qb + (size_t)r * D + c;
    const uint32_t lo = c < D ? (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) : 0u;
    const uint32_t hi =
        c + 1 < D ? (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p + 1)) : 0u;
    return lo | hi << 16;
  };
  uint32_t qa[kSliceMax / 16][4];
#pragma unroll
  for (int kk = 0; kk < kSliceMax / 16; ++kk) {
    const int ca = c0 + 16 * kk + 2 * t;
    const bool on = 16 * kk < cw;
    qa[kk][0] = qpair(r0, ca, on);
    qa[kk][1] = qpair(r1, ca, on);
    qa[kk][2] = qpair(r0, ca + 8, on);
    qa[kk][3] = qpair(r1, ca + 8, on);
  }

  // S of one K tile for the warp's rows (keys 8n + 2t, 8n + 2t + 1 of rows g,
  // g + 8), 32 columns (2 k-steps) at a time, summed over the slices, masked
  // and scaled; K's B fragments of two n-tiles by one ldmatrix (the lane's
  // row: key lane % 8 + 8 (lane / 16), columns 8 ((lane / 8) % 2))
  const int kl = (lane % 8 + 8 * (lane / 16)) * stride + c0 + 8 * ((lane / 8) % 2);
  auto logits = [&](const __nv_bfloat16* kt, int s0, float (&sc)[kKT / 8][4]) {
    uint32_t mk[kKT / 8][2];  // mask bytes, in flight during the products
#pragma unroll
    for (int n = 0; n < kKT / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int s = s0 + 8 * n + 2 * t + j;
        mk[n][j] = s < S ? (__ldg(mb + s) != 0) : 2u;
      }
#pragma unroll
    for (int n = 0; n < kKT / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kSliceMax / kChunk; ++kc) {
      if (kChunk * kc >= cw) break;
#pragma unroll
      for (int k2 = 0; k2 < kChunk / 16; ++k2) {
        const int kk = (kChunk / 16) * kc + k2;
#pragma unroll
        for (int n2 = 0; n2 < kKT / 16; ++n2) {
          uint32_t b[4];
          ldmatrix_x4(b, kt + kl + 16 * n2 * stride + 16 * kk);
          mma_bf16(sc[2 * n2], qa[kk], b[0], b[1]);
          mma_bf16(sc[2 * n2 + 1], qa[kk], b[2], b[3]);
        }
      }
    }
    if (ns > 1) sum_slices(sc, xs, warp, rg, ns, lane);
#pragma unroll
    for (int n = 0; n < kKT / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float fill = mk[n][j] == 0 ? -1.0e9f : -INFINITY;
        const bool valid = mk[n][j] == 1;
        sc[n][j] = valid ? sc[n][j] * scale : fill;
        sc[n][2 + j] = valid ? sc[n][2 + j] * scale : fill;
      }
    }
  };

  // pass 1: the rows' running max and sum of exp(s - max) (this thread's
  // keys; summed over the quad after the pass)
  float m0 = -INFINITY, m1 = -INFINITY, l0s = 0.f, l1s = 0.f;
  float sc[kKT / 8][4];
  for (int st = 0; st < n_tiles; ++st) {
    cp_async_wait<kAnyRing - 2>();
    __syncthreads();  // the tile is in place for all; the slot of step st - 1 is free
    stage(st + kAnyRing - 1);
    logits(ring + (st % kAnyRing) * slot, st * kKT, sc);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < kKT / 8; ++n) {
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
    for (int n = 0; n < kKT / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        ps0 += expf(sc[n][j] - mn0);
        ps1 += expf(sc[n][2 + j] - mn1);
      }
    }
    l0s = l0s * expf(m0 - mn0) + ps0;
    l1s = l1s * expf(m1 - mn1) + ps1;
    m0 = mn0;
    m1 = mn1;
  }
  l0s += __shfl_xor_sync(0xffffffffu, l0s, 1);
  l0s += __shfl_xor_sync(0xffffffffu, l0s, 2);
  l1s += __shfl_xor_sync(0xffffffffu, l1s, 1);
  l1s += __shfl_xor_sync(0xffffffffu, l1s, 2);
  const float inv0 = 1.f / l0s, inv1 = 1.f / l1s;  // the sums are >= 1

  // pass 2: O = P V over the slice, P = exp(s - M) (1 / L) rounded to bf16;
  // a K step forms the tile's probabilities again, the V step after it uses
  // them, 32 columns (4 n-tiles) at a time
  float o[kSliceMax / 8][4];
#pragma unroll
  for (int n = 0; n < kSliceMax / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  uint32_t pa[kKT / 16][4];
  for (int st = n_tiles; st < n_steps; ++st) {
    cp_async_wait<kAnyRing - 2>();
    __syncthreads();
    stage(st + kAnyRing - 1);
    const __nv_bfloat16* tile_p = ring + (st % kAnyRing) * slot;
    const int u = st - n_tiles;
    if (!(u & 1)) {
      logits(tile_p, (u >> 1) * kKT, sc);
      // k-step j of P.V covers keys 16 j .. 16 j + 15: n-tiles 2 j and 2 j + 1
#pragma unroll
      for (int j = 0; j < kKT / 16; ++j) {
        pa[j][0] = pack_bf16(expf(sc[2 * j][0] - m0) * inv0, expf(sc[2 * j][1] - m0) * inv0);
        pa[j][1] = pack_bf16(expf(sc[2 * j][2] - m1) * inv1, expf(sc[2 * j][3] - m1) * inv1);
        pa[j][2] =
            pack_bf16(expf(sc[2 * j + 1][0] - m0) * inv0, expf(sc[2 * j + 1][1] - m0) * inv0);
        pa[j][3] =
            pack_bf16(expf(sc[2 * j + 1][2] - m1) * inv1, expf(sc[2 * j + 1][3] - m1) * inv1);
      }
      continue;
    }
#pragma unroll
    for (int c = 0; c < kSliceMax / kChunk; ++c) {
      if (kChunk * c >= cw) break;
#pragma unroll
      for (int j = 0; j < kKT / 16; ++j) {
        const __nv_bfloat16* vrow = tile_p + (16 * j + lane % 16) * stride + c0 + kChunk * c;
        uint32_t b[kChunk / 8][2];
#pragma unroll
        for (int n = 0; n < kChunk / 8; ++n) ldmatrix_x2_trans(b[n][0], b[n][1], vrow + 8 * n);
#pragma unroll
        for (int n = 0; n < kChunk / 8; ++n)
          mma_bf16(o[(kChunk / 8) * c + n], pa[j], b[n][0], b[n][1]);
      }
    }
  }
  cp_async_wait<0>();

  __nv_bfloat16* o0 = out + ((size_t)bh * L + r0) * D;
  __nv_bfloat16* o1 = out + ((size_t)bh * L + r1) * D;
#pragma unroll
  for (int n = 0; n < kSliceMax / 8; ++n) {
    if (8 * n >= cw) break;
    const int d = c0 + 8 * n + 2 * t;  // scalar stores: rows of odd D are 2-byte aligned
    if (r0 < L && d < D) o0[d] = __float2bfloat16_rn(o[n][0]);
    if (r0 < L && d + 1 < D) o0[d + 1] = __float2bfloat16_rn(o[n][1]);
    if (r1 < L && d < D) o1[d] = __float2bfloat16_rn(o[n][2]);
    if (r1 < L && d + 1 < D) o1[d + 1] = __float2bfloat16_rn(o[n][3]);
  }
}

// The widest copy (16, 8, 4 or 2 bytes) that the rows of k and v allow.
int copy_width(const void* k, const void* v, int row_bytes) {
  const uintptr_t any = (uintptr_t)k | (uintptr_t)v | (uintptr_t)row_bytes;
  return any % 16 == 0 ? 16 : any % 8 == 0 ? 8 : any % 4 == 0 ? 4 : 2;
}

// ---- the CUDA-core branch, for heads too wide for the tensor-core branch ----
//
// A block owns 32 queries of one (batch, head) and a range of at most 512
// output columns (gridDim.z splits wider heads; each z recomputes the
// logits); x enumerates (query tile, batch x head). Two passes over the key
// tiles of 32: pass 1 forms the logits (q.k^T over D in chunks of 32 columns,
// q and k staged element by element, so any D and any alignment) and each
// row's running max and sum of exp(s - max); pass 2 forms the logits again,
// p = exp(s - M) / L, and adds p.V into the block's output rows in shared
// memory, 64 columns at a time. Everything runs on CUDA cores in f32.
constexpr int kAQ = 32;         // queries a block
constexpr int kAK = 32;         // keys a tile
constexpr int kAC = 32;         // columns of q and k a staging chunk
constexpr int kAV = 64;         // output columns a P.V chunk
constexpr int kAOMax = 512;     // output columns a block
constexpr int kAThreads = 128;

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_out(float* o, float v) { *o = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

size_t wide_d_smem_bytes(int ow) {
  return sizeof(float) * ((size_t)kAQ * (kAC + 1) + (size_t)kAK * (kAC + 1) +
                          (size_t)kAQ * (kAK + 1) + (size_t)kAK * (kAV + 1) + (size_t)kAQ * ow);
}

template <class T>
__global__ void __launch_bounds__(kAThreads) masked_attention_wide_d_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ kv_mask, T* __restrict__ out, int H, int L, int S, int D,
    float scale, int q_tiles, int ow) {
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ float wide_d_smem[];
  float* qs = wide_d_smem;                  // [kAQ][kAC + 1]
  float* ks = qs + kAQ * (kAC + 1);        // [kAK][kAC + 1]
  float* ps = ks + kAK * (kAC + 1);        // [kAQ][kAK + 1] probabilities of a tile
  float* vs = ps + kAQ * (kAK + 1);        // [kAK][kAV + 1]
  float* os = vs + kAK * (kAV + 1);        // [kAQ][ow] the block's output columns

  const long long bh = blockIdx.x / q_tiles;
  const int l0 = (blockIdx.x - (int)(bh * q_tiles)) * kAQ;
  const int b = (int)(bh / H);
  const int c0 = blockIdx.z * ow, c1 = min(D, c0 + ow);  // the block's output columns
  const int tid = threadIdx.x;
  const int rg = tid / 8, kg = tid % 8;    // rows 2 rg, 2 rg + 1; keys 4 kg .. + 4
  const T* qb = q + (size_t)bh * L * D;
  const T* kb = k + (size_t)bh * S * D;
  const T* vb = v + (size_t)bh * S * D;
  const uint8_t* mb = kv_mask + (size_t)b * S;
  const int n_tiles = (S + kAK - 1) / kAK;

  for (int i = tid; i < kAQ * ow; i += kAThreads) os[i] = 0.f;

  // the masked, scaled logits of rows 2 rg + i, keys s0 + 4 kg + j
  auto logits = [&](int s0, float (&sc)[2][4]) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kAC) {
      __syncthreads();  // the previous chunk is consumed
      for (int i = tid; i < kAQ * kAC; i += kAThreads) {
        const int r = i / kAC, c = i - r * kAC;
        const bool in = d0 + c < D;
        const float qv = in && l0 + r < L ? as_f32(qb[(size_t)(l0 + r) * D + d0 + c]) : 0.f;
        qs[r * (kAC + 1) + c] = kBf16 ? qv : qv * scale;
        ks[r * (kAC + 1) + c] = in && s0 + r < S ? as_f32(kb[(size_t)(s0 + r) * D + d0 + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kAC; ++c) {
        const float a0 = qs[(2 * rg) * (kAC + 1) + c], a1 = qs[(2 * rg + 1) * (kAC + 1) + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float kv = ks[(4 * kg + j) * (kAC + 1) + c];
          sc[0][j] = fmaf(a0, kv, sc[0][j]);
          sc[1][j] = fmaf(a1, kv, sc[1][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + 4 * kg + j;
      const bool valid = s < S && mb[s] != 0;
      const float fill = s < S ? -1.0e9f : -INFINITY;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        sc[i][j] = valid ? (kBf16 ? sc[i][j] * scale : sc[i][j]) : fill;
    }
  };

  // pass 1: each row's max M and sum L of exp(s - M) over all keys (the 8
  // threads of a row group hold its 32 keys of a tile)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float sc[2][4];
  for (int tile = 0; tile < n_tiles; ++tile) {
    logits(tile * kAK, sc);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = fmaxf(fmaxf(sc[i][0], sc[i][1]), fmaxf(sc[i][2], sc[i][3]));
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);  // finite: the tile holds a key < S
      float ps_ = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) ps_ += expf(sc[i][j] - mn);
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) ps_ += __shfl_xor_sync(0xffffffffu, ps_, off);
      l[i] = l[i] * expf(m[i] - mn) + ps_;
      m[i] = mn;
    }
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};  // the sums are >= 1

  // pass 2: O += P V, P = exp(s - M) / L (bf16: rounded), 64 columns at a time
  const int vr = tid / 8, vc = tid % 8;   // P.V: rows 2 vr, 2 vr + 1; columns vc + 8 j
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int s0 = tile * kAK;
    logits(s0, sc);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m[i]) * inv[i];
        ps[(2 * rg + i) * (kAK + 1) + 4 * kg + j] = kBf16 ? round_bf16(p) : p;
      }
    for (int v0 = c0; v0 < c1; v0 += kAV) {
      __syncthreads();  // the probabilities are in place; the previous V chunk is consumed
      for (int i = tid; i < kAK * kAV; i += kAThreads) {
        const int r = i / kAV, c = i - r * kAV;
        vs[r * (kAV + 1) + c] =
            s0 + r < S && v0 + c < c1 ? as_f32(vb[(size_t)(s0 + r) * D + v0 + c]) : 0.f;
      }
      __syncthreads();
      float o[2][8];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) o[i][j] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < kAK; ++kk) {
        const float p0 = ps[(2 * vr) * (kAK + 1) + kk], p1 = ps[(2 * vr + 1) * (kAK + 1) + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float vv = vs[kk * (kAV + 1) + vc + 8 * j];
          o[0][j] = fmaf(p0, vv, o[0][j]);
          o[1][j] = fmaf(p1, vv, o[1][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = v0 + vc + 8 * j;
          if (c < c1) os[(2 * vr + i) * ow + c - c0] += o[i][j];
        }
    }
  }
  __syncthreads();
  for (int i = tid; i < kAQ * (c1 - c0); i += kAThreads) {
    const int r = i / (c1 - c0), c = i - r * (c1 - c0);
    if (l0 + r < L) store_out(out + ((size_t)bh * L + l0 + r) * D + c0 + c, os[r * ow + c]);
  }
}

template <class T>
int launch_wide_d(const T* q, const T* k, const T* v, const uint8_t* kv_mask, T* out, int B,
                  int H, int L, int S, int D, float scale, cudaStream_t stream) {
  const int q_tiles = (L + kAQ - 1) / kAQ;
  const long long blocks = (long long)q_tiles * B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int z = (D + kAOMax - 1) / kAOMax;
  const int ow = (D + z - 1) / z;          // output columns a block
  const size_t bytes = wide_d_smem_bytes(ow);
  auto kernel = masked_attention_wide_d_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)blocks, 1, z);
  kernel<<<grid, kAThreads, bytes, stream>>>(q, k, v, kv_mask, out, H, L, S, D, scale, q_tiles,
                                             ow);
  return (int)cudaGetLastError();
}

inline auto any_d_tc_kernel(const float*) { return masked_attention_any_d_tc_kernel; }
inline auto any_d_tc_kernel(const __nv_bfloat16*) { return masked_attention_any_d_tc_bf16_kernel; }

// The tensor-core branch's tilings for head width D that fit, each with its
// resident blocks an SM (the occupancy calculator): slice widths 128, 96 and
// 64, any number of row groups up to twelve warps a block. Kept per (dtype,
// D).
struct AnyDChoice {
  AnyDPlan p;
  int per_sm;
};

template <class T>
cudaError_t any_d_choices(int D, const std::vector<AnyDChoice>** choices) {
  constexpr bool kBf16 = sizeof(T) == 2;
  static std::mutex lock;
  static std::map<int, std::vector<AnyDChoice>> cache;
  std::lock_guard<std::mutex> hold(lock);
  auto found = cache.find(D);
  if (found == cache.end()) {
    auto kernel = any_d_tc_kernel(static_cast<const T*>(nullptr));
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kAnySmemMax);
    if (err != cudaSuccess) return err;
    std::vector<AnyDChoice> list;
    AnyDPlan p;
    p.dpad = (D + kChunk - 1) / kChunk * kChunk;
    for (int width = kSliceMax; width >= 64; width -= kChunk) {
      const int ns0 = (p.dpad + width - 1) / width;
      p.ds = (p.dpad / kChunk + ns0 - 1) / ns0 * kChunk;
      p.ns = (p.dpad + p.ds - 1) / p.ds;
      for (p.rw = kAnyWarpsMax / p.ns; p.rw >= 1; --p.rw) {
        p.threads = 32 * p.rw * p.ns;
        p.smem = any_d_smem_bytes(p, kBf16);
        if (p.smem > kAnySmemMax) continue;
        int per_sm = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, p.threads, p.smem);
        if (err != cudaSuccess) return err;
        if (per_sm > 0) list.push_back({p, per_sm});
      }
    }
    found = cache.emplace(D, std::move(list)).first;
  }
  *choices = &found->second;
  return cudaSuccess;
}

// The modelled time of a tiling on a grid of `blocks`: blocks are dealt to
// the SMs in waves of per_sm; c blocks sharing an SM take (rw + 1) c / r
// (rw query row groups each and one for copying K and V, r the SM's share of
// its throughput: resident warps / 12, at most 1); times 1 + a (ns - 1) for
// the slices' exchange and repeated softmax (a = 0.1 f32, 0.3 bf16, which
// exchanges twice a tile). Fitted to sweeps of every tiling at W's self and
// cross calls, C's self call and the [4, 1, 4602^2] D = 256 call (NVIDIA
// H100 80GB HBM3, 700 W): it picks the fastest tiling measured at each, e.g.
// at D = 216 two 128-column slices of six row groups for the self call
// (f32 0.217 ms; three row groups 0.230, 64-column slices 0.289) and four
// 64-column slices of three for the cross call, whose grid is half as large
// (0.139 ms; 128-column slices of six 0.207).
double any_d_cost(const AnyDChoice& c, long long blocks, int sms, bool bf16) {
  const int wpb = c.p.rw * c.p.ns;
  auto span = [&](long long n) {  // n blocks sharing an SM
    return (c.p.rw + 1.0) * n / std::min(1.0, n * wpb / 12.0);
  };
  const long long slots = (long long)c.per_sm * sms;
  const long long full = blocks / slots, rem = blocks - full * slots;
  double t = full * span(c.per_sm);
  if (rem) t += span((rem + sms - 1) / sms);
  return t * (1.0 + (bf16 ? 0.3 : 0.1) * (c.p.ns - 1));
}

// The any-D route: the tensor-core branch where its tiles fit (*route = 0),
// else the CUDA-core branch (*route = 1).
template <class T>
int launch_any_d(const T* q, const T* k, const T* v, const uint8_t* kv_mask, T* out, int B,
                 int H, int L, int S, int D, float scale, int* route, cudaStream_t stream) {
  const std::vector<AnyDChoice>* choices;
  cudaError_t err = any_d_choices<T>(D, &choices);
  if (err != cudaSuccess) return (int)err;
  if (choices->empty()) {
    *route = 1;
    return launch_wide_d<T>(q, k, v, kv_mask, out, B, H, L, S, D, scale, stream);
  }
  *route = 0;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const AnyDPlan* p = nullptr;
  double best = 0.0;
  for (const AnyDChoice& c : *choices) {  // ties keep the earlier: fewer slices, more rows
    const long long blocks = (long long)((L + 16 * c.p.rw - 1) / (16 * c.p.rw)) * B * H;
    const double cost = any_d_cost(c, blocks, sms, sizeof(T) == 2);
    if (!p || cost < best) {
      p = &c.p;
      best = cost;
    }
  }
  const int q_tiles = (L + 16 * p->rw - 1) / (16 * p->rw);
  const long long blocks = (long long)q_tiles * B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int copy = copy_width(k, v, D * (int)sizeof(T));
  any_d_tc_kernel(q)<<<(unsigned)blocks, p->threads, p->smem, stream>>>(
      q, k, v, kv_mask, out, H, L, S, D, scale, q_tiles, p->dpad, p->ns, p->ds, copy);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, H, L, D], k/v [B, H, S, D], kv_mask [B, S] bool (1 byte), out
// [B, H, L, D]; f32, contiguous; any D >= 1. *route is set to the instance
// that ran: its padded width (64, 112, 136), or the any-D route's branch (0:
// tensor cores, 1: CUDA cores).
// Returns a cudaError_t (0 on success).
int masked_attention_forward(const float* q, const float* k, const float* v,
                             const uint8_t* kv_mask, float* out, int B, int H,
                             int L, int S, int D, float scale, int* route,
                             cudaStream_t stream) {
  if (B <= 0 || H <= 0 || L <= 0 || S <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const bool aligned = ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 == 0;
  if (D > kDMax || D % 4 != 0 || !aligned || (long long)B * H > 65535)
    return launch_any_d<float>(q, k, v, kv_mask, out, B, H, L, S, D, scale, route, stream);
  *route = D <= 64 ? 64 : D <= 112 ? 112 : 136;
  if (D <= 64)
    return launch<64>(q, k, v, kv_mask, out, B, H, L, S, D, scale, stream);
  if (D <= 112)
    return launch<112>(q, k, v, kv_mask, out, B, H, L, S, D, scale, stream);
  return launch<136>(q, k, v, kv_mask, out, B, H, L, S, D, scale, stream);
}

// The bf16 instance: q [B, H, L, D], k/v [B, H, S, D] bf16, kv_mask [B, S]
// bool (1 byte), out [B, H, L, D] bf16; contiguous; any D >= 1. *route as
// masked_attention_forward's (112, 144, or the any-D route's 0 or 1).
// Returns a cudaError_t (0 on success).
int masked_attention_forward_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                  const __nv_bfloat16* v, const uint8_t* kv_mask,
                                  __nv_bfloat16* out, int B, int H, int L, int S, int D,
                                  float scale, int* route, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || L <= 0 || S <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const bool aligned = ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 8 == 0;
  int tiles_per_block;
  bool keep;
  const bool fits = S <= (1 << 19) && bf16_block_bytes<144>(S, &tiles_per_block, &keep) <=
                                          227 * 1024;
  if (D > kDMaxBf16 || D % 4 != 0 || !aligned || (long long)B * H > 65535 || !fits)
    return launch_any_d<__nv_bfloat16>(q, k, v, kv_mask, out, B, H, L, S, D, scale, route,
                                       stream);
  *route = D <= 112 ? 112 : 144;
  if (D <= 112)
    return launch_bf16<112>(q, k, v, kv_mask, out, B, H, L, S, D, scale, stream);
  return launch_bf16<144>(q, k, v, kv_mask, out, B, H, L, S, D, scale, stream);
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
