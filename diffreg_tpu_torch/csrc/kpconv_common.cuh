// Shared by the KPConv kernels' two libraries, kpconv.cu (f32) and
// kpconv_bf16.cu (the bf16 instance): the influence modes, how each reads its
// support rows, and the shared steps of their tensor-core kernels.
//
// Replaces the Pallas TPU kernel diffreg_tpu/ops/pallas/kpconv_kernel.py:_kernel
// (pallas_call in _fused_kpconv_fwd_impl). Same arithmetic: for each query q and
// each neighbor row n of its fixed-K neighborhood,
//   rel = s[n] - q,  d2_p = max(|rel|^2 + |kp_p|^2 - 2 rel.kp_p, 0),
//   infl_p = max(1 - sqrt(d2_p) / extent, 0),
//   acc[p, c] += infl_p * x[n, c],
// then out[q] = (sum_p acc[p, :] @ W[p]) / max(#neighbors with feature-sum > 0, 1).
// The Pallas kernel has linear influence and sum aggregation only; the JAX
// package runs its other modes in XLA (diffreg_tpu/ops/kpconv.py:
// _influence_weights), and here they are instances of the same kernels: the
// influence is a template parameter of the tuned kernels and a runtime value
// of the others (linear as above; constant, infl_p = 1; gaussian, infl_p =
// exp(-d2_p / (2 sigma^2 + 1e-9)) with sigma = 0.3 extent, the denominator
// formed in double by the caller as the JAX package forms it), and
// aggregation "closest" (a runtime flag) keeps, for each neighbor, only the
// influence of its nearest kernel point (the first on ties, as jnp.argmin).
//
// Three routes in each library, all on tensor cores; the C entry reports the
// one it took (Route):
//  * tuned (P = kP = 15, the default KPFCNConfig.num_kernel_points, every
//    preset's and YAML's; Cin % 32 == 0, K <= 40, Cout in {64, 128, 256, 512},
//    f32 also Cin >= 64): register arrays and shared tiles sized by P;
//  * any-P (any other P at the tuned shapes): P read at run time, in chunks of
//    16 kernel points (its shared steps below);
//  * any-shape (every other shape: the first layer, Cin = 1; the 2D-3D level
//    0, K = 64; narrow layers, any Cin and Cout; K > 40; a misaligned view):
//    any P, K, Cin and Cout, every mode (its shared steps at the end of this
//    file, its kernels kpconv.cu:kpconv_any_shape_kernel and
//    kpconv_bf16.cu:kpconv_any_shape_bf16_kernel).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "bf16.cuh"
#include "tf32.cuh"

namespace {

constexpr int kP = 15;         // the kernel-point count the tuned kernels are compiled for
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float kp_norm2(float x, float y, float z) {
  return x * x + y * y + z * z;
}

// Kernel points to shared memory: kps [P][3] and their squared norms k2s [P].
__device__ __forceinline__ void load_kernel_points(const float* kp, float* kps, float* k2s) {
  const int tid = threadIdx.x;
  if (tid < kP) {
    const float a = kp[3 * tid], c = kp[3 * tid + 1], d = kp[3 * tid + 2];
    kps[3 * tid] = a;
    kps[3 * tid + 1] = c;
    kps[3 * tid + 2] = d;
    k2s[tid] = kp_norm2(a, c, d);
  }
}

// The influence modes (template parameter Infl) and the runtime parameters of
// a call: the extent, the gaussian denominator 2 sigma^2 + 1e-9, and whether
// the aggregation is "closest".
enum Influence { kLinear = 0, kConstant = 1, kGaussian = 2 };

struct Mode {
  float extent;
  float gauss_den;
  int closest;
};

// Squared distance of a kernel point (kx, ky, kz; k2 its squared norm) from a
// neighbor at offset r (|r|^2 = n2) from its query, computed as the JAX
// package does: d2 = max(|r|^2 + |kp|^2 - 2 r.kp, 0).
__device__ __forceinline__ float kp_d2(float rx, float ry, float rz, float n2, float kx,
                                       float ky, float kz, float k2) {
  const float cross = rx * kx + ry * ky + rz * kz;
  return fmaxf(n2 + k2 - 2.f * cross, 0.f);
}

// The influence of a kernel point at squared distance d2.
template <int Infl>
__device__ __forceinline__ float influence_of(float d2, const Mode& mode) {
  if (Infl == kLinear) return fmaxf(1.f - sqrtf(d2) / mode.extent, 0.f);
  if (Infl == kConstant) return 1.f;
  return expf(-d2 / mode.gauss_den);
}

// The influences of all P kernel points on one neighbor, into f[0, P): under
// "closest" every point but the nearest (the first of equal ones) gets 0.
template <int Infl>
__device__ __forceinline__ void influences(float rx, float ry, float rz, float n2,
                                           const float* kps, const float* k2s,
                                           const Mode& mode, float (&f)[kP]) {
  float d2[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p)
    d2[p] = kp_d2(rx, ry, rz, n2, kps[3 * p], kps[3 * p + 1], kps[3 * p + 2], k2s[p]);
  int nearest = 0;
  float best = d2[0];
#pragma unroll
  for (int p = 1; p < kP; ++p) {
    if (d2[p] < best) {
      best = d2[p];
      nearest = p;
    }
  }
#pragma unroll
  for (int p = 0; p < kP; ++p)
    f[p] = mode.closest && p != nearest ? 0.f : influence_of<Infl>(d2[p], mode);
}

// Where a kernel reads the support rows and how it rounds: the f32 arrays
// (kpconv_forward), or the bf16 table [B, Ns + 1, 8 + Cin] of [hi(pos),
// lo(pos), 0, 0, features], with the bf16 path's roundings of the influences
// and of the weighted sums (kpconv_forward_bf16).
struct F32Rows {
  const float* s_pts;
  const float* x;
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
  __device__ static float rounded(float v) { return v; }
};

struct Bf16Rows {
  const __nv_bfloat16* table;
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
  __device__ static float rounded(float v) { return round_bf16(v); }
};

// The tensor-core kernels' tiles: queries per block, channels per chunk (a
// warp's lanes), and the most neighbors a query may have there.
constexpr int kTQ = 32;                 // queries per block
constexpr int kCC = 32;                 // channels per chunk: a warp's lanes
constexpr int kKMax = 40;

// ---- the any-P tensor-core kernels' shared steps ----
//
// kpconv.cu and kpconv_bf16.cu each have a tensor-core kernel for every
// kernel-point count P but 15 at the tuned kernels' shapes (Cin % 32 == 0, K
// <= 40, Cout in {64, 128, 256, 512}; f32 also Cin >= 64). Both run P in
// chunks of kPC = 16 kernel points, the last chunk padded with zero
// influences, and Cin in chunks of kXC = 16 channels. For each chunk of
// points the block computes the influences of its 32 queries' neighbours,
// [query][point][neighbour] in shared memory; for each chunk of channels each
// warp builds the A rows of 4 queries on tensor cores, A_q[16 points x 16
// channels] = infl_q^T[16 x K] X_q[K x 16] (kernel points on the 16 M rows of
// the product, neighbours on its k), then every warp contracts the A chunk
// with its columns of W on tensor cores, 32 x Cout accumulators in registers
// across all chunks. The density count's feature sums come from the first
// chunk of points' X fragments.
constexpr int kPC = 16;  // kernel points a chunk: the A products' 16 rows
constexpr int kXC = 16;  // channels a chunk
constexpr size_t kTcSmemMax = 227 * 1024;  // shared memory a block may take

// Which kernel a KPConv entry launched (*route): the tuned tensor-core kernel
// (P = 15), the any-P tensor-core kernel, or the any-shape tensor-core kernel.
enum Route { kRouteTuned = 0, kRouteAnyPTensorCores = 1, kRouteAnyShape = 2 };

// The influence of a kernel point at squared distance d2, the mode a runtime
// value (the any-P tensor-core kernels are one instance for every mode).
__device__ __forceinline__ float influence_rt(float d2, const Mode& mode, int kind) {
  if (kind == kLinear) return influence_of<kLinear>(d2, mode);
  if (kind == kConstant) return 1.f;
  return influence_of<kGaussian>(d2, mode);
}

// Kernel points [P] as (x, y, z, |kp|^2) into shared memory.
__device__ __forceinline__ void load_kernel_points_any(const float* kp, float4* kps, int P) {
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const float a = kp[3 * p], c = kp[3 * p + 1], d = kp[3 * p + 2];
    kps[p] = make_float4(a, c, d, kp_norm2(a, c, d));
  }
}

// The kernel point nearest to a neighbour at offset r (x, y, z, |.|^2), the
// first of equal ones: "closest" aggregation's choice.
__device__ __forceinline__ int nearest_kernel_point(const float4& r, const float4* kps, int P) {
  int near = 0;
  float best = 0.f;
  for (int p = 0; p < P; ++p) {
    const float4 kq = kps[p];
    const float d2 = kp_d2(r.x, r.y, r.z, r.w, kq.x, kq.y, kq.z, kq.w);
    if (p == 0 || d2 < best) {
      best = d2;
      near = p;
    }
  }
  return near;
}

// A neighbour's offset from its query: (x, y, z, |.|^2).
template <class Rows>
__device__ __forceinline__ float4 neighbour_offset(const float* q_pts, const Rows& rows, int b,
                                                   int q, int nb, int Nq) {
  const float* qp = q_pts + ((size_t)b * Nq + q) * 3;
  float px, py, pz;
  rows.pos(b, nb, px, py, pz);
  const float rx = px - qp[0], ry = py - qp[1], rz = pz - qp[2];
  return make_float4(rx, ry, rz, rx * rx + ry * ry + rz * rz);
}

// The block's neighbour table nbr [TQ][K] (-1: shadow row or out of range),
// under "closest" each neighbour's nearest kernel point over all P (the first
// of equal ones), and the feature sums zeroed.
template <class Rows>
__device__ void any_p_neighbours(const float* q_pts, const Rows& rows, const int32_t* inds,
                                 const float4* kps, int P, int b, int q0, int Nq, int Ns, int K,
                                 const Mode& mode, int* nbr, int* nearest, float* fsum) {
  for (int s = threadIdx.x; s < kTQ * K; s += blockDim.x) {
    const int qi = s / K, k = s - qi * K;
    const int q = q0 + qi;
    const int nb = q < Nq ? inds[((size_t)b * Nq + q) * K + k] : Ns;
    const bool real = nb >= 0 && nb < Ns;
    nbr[s] = real ? nb : -1;
    fsum[s] = 0.f;
    nearest[s] = mode.closest && real
                     ? nearest_kernel_point(neighbour_offset(q_pts, rows, b, q, nb, Nq), kps, P)
                     : 0;
  }
}

// The influences of kernel points [pc0, pc0 + npc) on the block's neighbours,
// infl[q][p][k] (row stride kst; k < kpad, zero past K, for missing
// neighbours and for the chunk's pad points), rounded as Rows rounds them and
// stored as T.
template <class T, class Rows>
__device__ void chunk_influences(T* infl, int kst, int kpad, const float* q_pts, const Rows& rows,
                                 const float4* kps, const int* nbr, const int* nearest, int b,
                                 int q0, int Nq, int K, int pc0, int npc, const Mode& mode,
                                 int kind) {
  for (int s = threadIdx.x; s < kTQ * kpad; s += blockDim.x) {
    const int qi = s / kpad, k = s - qi * kpad;
    const int nb = k < K ? nbr[qi * K + k] : -1;
    float f[kPC];
#pragma unroll
    for (int p = 0; p < kPC; ++p) f[p] = 0.f;
    if (nb >= 0) {
      const float4 r = neighbour_offset(q_pts, rows, b, q0 + qi, nb, Nq);
      const int near = nearest[qi * K + k];
#pragma unroll
      for (int p = 0; p < kPC; ++p) {
        if (p >= npc) break;
        const float4 kq = kps[pc0 + p];
        const float d2 = kp_d2(r.x, r.y, r.z, r.w, kq.x, kq.y, kq.z, kq.w);
        f[p] = mode.closest && pc0 + p != near ? 0.f : influence_rt(d2, mode, kind);
      }
    }
    T* ip = infl + (size_t)qi * kPC * kst + k;
#pragma unroll
    for (int p = 0; p < kPC; ++p) ip[p * kst] = T(Rows::rounded(f[p]));
  }
}

// The density count from the feature sums: a neighbour counts iff its
// feature-sum is positive (the reference's quirk).
__device__ __forceinline__ void any_p_counts(const int* nbr, const float* fsum, int K, int* cnt) {
  if (threadIdx.x < kTQ) {
    int n_pos = 0;
    for (int k = 0; k < K; ++k) {
      const int s = threadIdx.x * K + k;
      n_pos += nbr[s] >= 0 && fsum[s] > 0.f;
    }
    cnt[threadIdx.x] = n_pos;
  }
}

// ---- the any-shape tensor-core kernels' shared steps ----
//
// kpconv.cu:kpconv_any_shape_kernel (f32, 3xTF32) and
// kpconv_bf16.cu:kpconv_any_shape_bf16_kernel (bf16, the roundings of
// Bf16Rows) take every shape the tuned and any-P kernels refuse. A block owns
// kGQ = 32 queries of one pair and up to 64 NT output columns (more columns:
// more blocks, grid z), 8 warps. For each chunk of 16 kernel points and of up
// to kGCC = 32 channels:
//  * each warp builds the A rows of 4 queries, A_q[p][c] = sum_k infl[k, p]
//    x[nbr[k], c], into a shared A chunk [32][16 nc], streaming the neighbours
//    32 at a time (any K): a lane per neighbour stages its offset, row and
//    nearest kernel point (StagedNeighbours, a warp's own 768 bytes: no
//    [TQ][K][P] influence table), then the influences are computed in
//    registers where the tensor core wants them (the A fragments of
//    infl^T [16 points x k neighbours]) and multiplied by the gathered rows
//    (B fragments read through the index table) on tensor cores. At Cin = 1
//    the A row is 16 sums a query: a lane per neighbour accumulates them and
//    a reduce-scatter adds them across the warp (cin1_row);
//  * every warp with output columns contracts the A chunk with those columns
//    of W on tensor cores, the block's 32 x 64 NT accumulators in registers
//    across all chunks; a warp stages its own W rows (16 a group, in the
//    order WCursor walks them) with cp.async, kG - 1 groups ahead, so its
//    k-steps need no block barrier (the block meets twice a chunk).
// The density count comes from the same feature loads where one chunk holds
// all of Cin (and from x itself at Cin = 1); with several channel chunks the
// neighbours' rows are summed first (dense_count).
constexpr int kGQ = 32;               // queries a block: two 16-row m-tiles of the contraction
constexpr int kGQW = kGQ / kWarps;    // queries whose A rows a warp builds
constexpr int kGKC = 32;              // neighbours a staged chunk: a lane each
constexpr int kGCC = 32;              // channels a chunk of A, at most

// A warp's staged chunk of 32 neighbours of one query: each one's offset from
// the query (x, y, z, |.|^2), its row (-1: none) and, under "closest", its
// nearest kernel point over all P.
struct StagedNeighbours {
  float4 rel[kGKC];
  int nb[kGKC];
  int near[kGKC];
};

// The support row of neighbour k of query q (-1: the query is past Nq, k past
// K, or the row outside [0, Ns), the sentinel among them).
__device__ __forceinline__ int neighbour_row(const int32_t* inds, int b, int q, int Nq, int Ns,
                                             int K, int k) {
  const int nb = q < Nq && k < K ? inds[((size_t)b * Nq + q) * K + k] : -1;
  return nb >= 0 && nb < Ns ? nb : -1;
}

// Stage neighbours [k0, k0 + 32) of query q, lane l neighbour k0 + l.
template <class Rows>
__device__ __forceinline__ void stage_neighbours(StagedNeighbours& st, const float* q_pts,
                                                 const Rows& rows, const int32_t* inds,
                                                 const float4* kps, int P, int b, int q, int Nq,
                                                 int Ns, int K, int k0, const Mode& mode,
                                                 int lane) {
  const int nb = neighbour_row(inds, b, q, Nq, Ns, K, k0 + lane);
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  int near = 0;
  if (nb >= 0) {
    r = neighbour_offset(q_pts, rows, b, q, nb, Nq);
    if (mode.closest) near = nearest_kernel_point(r, kps, P);
  }
  st.rel[lane] = r;
  st.nb[lane] = nb;
  st.near[lane] = near;
}

// The influence of kernel point p (kq: its x, y, z, |.|^2) on a neighbour at
// offset r with row nb and nearest point near: zero for no neighbour, for p
// past P and, under "closest", unless p is the nearest. The IEEE sqrt, expf
// and division of influence_rt, as the plain versions take them. Reciprocals
// and approximate sqrt and exp (a few ulps off) were measured, NVIDIA H100
// 80GB HBM3, 700 W: 20-25% faster at the 2D-3D level-0 layers, but the bf16
// path rounds each influence to bf16, and their ulps flipped enough of those
// roundings that a gate-40 DDIM's warp left the CPU's (5.3e-5 of the largest
// confidence against a 1.9e-6 limit); in f32 they took the library's build
// from 40-60 s to 150-220 s.
__device__ __forceinline__ float influence_at(const float4& r, int nb, int near, int p, int P,
                                              const float4& kq, const Mode& mode, int kind) {
  if (nb < 0 || p >= P || (mode.closest && near != p)) return 0.f;
  return influence_rt(kp_d2(r.x, r.y, r.z, r.w, kq.x, kq.y, kq.z, kq.w), mode, kind);
}

// One halving step of a reduce-scatter of N values over lanes: the lanes with
// bit O set keep the upper Half values, the others the lower, each added to
// its partner's copy; the kept ones move to v[0, Half).
template <int Half, int O, int N>
__device__ __forceinline__ void reduce_scatter_half(float (&v)[N], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int i = 0; i < Half; ++i) {
    const float send = up ? v[i] : v[i + Half];
    const float keep = up ? v[i + Half] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// Sum v[16] over the warp's 32 lanes (16 shuffles): on return v[0] at lane l
// holds the total of entry l / 2.
__device__ __forceinline__ void warp_reduce_scatter16(float (&v)[16], int lane) {
  reduce_scatter_half<8, 16>(v, lane);
  reduce_scatter_half<4, 8>(v, lane);
  reduce_scatter_half<2, 4>(v, lane);
  reduce_scatter_half<1, 2>(v, lane);
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// Sum v[8] over the 8 lanes of each quad column (lanes 4 g + t, g = 0..7; 7
// shuffles): on return v[0] at lane (g, t) holds its column's total of entry
// g. The any-shape kernels' density count: entry i is one neighbour's share
// of the feature sum, the 8 lanes of a column its channels.
__device__ __forceinline__ void column_reduce_scatter8(float (&v)[8], int lane) {
  reduce_scatter_half<4, 16>(v, lane);
  reduce_scatter_half<2, 8>(v, lane);
  reduce_scatter_half<1, 4>(v, lane);
}

// The A row of query q at Cin = 1 for kernel points [pc0, pc0 + 16):
// A[p] = sum_k infl[k, p] x[nbr[k]], a lane per neighbour (32 at a time),
// each lane's 16 sums (of the influences rounded as Rows rounds them, times
// the feature) then added across the warp; rounded as Rows rounds and stored
// as T at arow[0, 16) (zero past P). Returns, at every lane, the query's
// density count (neighbours with x > 0).
template <class T, class Rows>
__device__ int cin1_row(T* arow, const float* q_pts, const Rows& rows, const int32_t* inds,
                        const float4* kps, int P, int pc0, int b, int q, int Nq, int Ns, int K,
                        const Mode& mode, int kind, int lane) {
  float a[kPC];
#pragma unroll
  for (int p = 0; p < kPC; ++p) a[p] = 0.f;
  int n_pos = 0;
  for (int k0 = 0; k0 < K; k0 += kGKC) {
    const int nb = neighbour_row(inds, b, q, Nq, Ns, K, k0 + lane);
    if (nb < 0) continue;
    const float4 r = neighbour_offset(q_pts, rows, b, q, nb, Nq);
    const int near = mode.closest ? nearest_kernel_point(r, kps, P) : 0;
    const float xv = rows.feat(b, nb, 0);
    n_pos += xv > 0.f;
#pragma unroll
    for (int p = 0; p < kPC; ++p) {
      if (pc0 + p < P) {
        const float f = influence_at(r, nb, near, pc0 + p, P, kps[pc0 + p], mode, kind);
        a[p] = fmaf(Rows::rounded(f), xv, a[p]);
      }
    }
  }
  warp_reduce_scatter16(a, lane);
  if ((lane & 1) == 0) arow[lane / 2] = T(Rows::rounded(a[0]));
  return __reduce_add_sync(0xffffffffu, n_pos);
}

// The density count of query q where the A rows' loads see one channel chunk
// at a time (Cin > kGCC): each chunk of 32 neighbours read in the A
// fragments' pattern (lane (g, t): neighbours 8 (i / 2) + t + 4 (i % 2),
// channels g, g + 8, ...; 8 lanes a 32-byte sector of a row), summed in f32
// and reduce-scattered over each quad column. Returns it at every lane.
template <class Rows>
__device__ int dense_count(const Rows& rows, const int32_t* inds, int b, int q, int Nq, int Ns,
                           int K, int Cin, int lane) {
  const int g = lane / 4, t = lane % 4;
  int n_pos = 0;
  for (int k0 = 0; k0 < K; k0 += kGKC) {
    int nb[8];
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      nb[i] = neighbour_row(inds, b, q, Nq, Ns, K, k0 + 8 * (i / 2) + t + 4 * (i % 2));
      v[i] = 0.f;
    }
    for (int c = g; c < Cin; c += 8)  // 8 rows' loads in flight a step
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (nb[i] >= 0) v[i] += rows.feat(b, nb[i], c);
    column_reduce_scatter8(v, lane);
    const int j = 8 * (g / 2) + t + 4 * (g % 2);
    n_pos += neighbour_row(inds, b, q, Nq, Ns, K, k0 + j) >= 0 && v[0] > 0.f;
  }
  return __reduce_add_sync(0xffffffffu, n_pos);
}

// Let kernel take up to kTcSmemMax of dynamic shared memory, once per device.
template <class Kernel>
cudaError_t allow_shared_memory(Kernel kernel, unsigned& devices_done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 32 && devices_done >> dev & 1u)) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTcSmemMax);
  if (err == cudaSuccess && dev < 32) devices_done |= 1u << dev;
  return err;
}

// The W rows of the contraction in the order the any-shape kernels take them:
// for each chunk of 16 kernel points (pc0) and of up to kGCC channels (c0), the
// chunk's packed rows j = p nc + c (p < npc points, c < nc channels; the A
// chunk's columns) in groups of 16, the last one padded with zero rows.
struct WCursor {
  int pc0 = 0, c0 = 0, j0 = 0;
  __device__ bool done(int P) const { return pc0 >= P; }
  // W's row (p, c) for row r of the current group, or -1 for a pad row
  __device__ int row(int r, int P, int Cin) const {
    const int nc = min(kGCC, Cin - c0), npc = min(kPC, P - pc0);
    const int j = j0 + r;
    return j < npc * nc ? (pc0 + j / nc) * Cin + c0 + j % nc : -1;
  }
  __device__ void advance(int P, int Cin) {
    const int nc = min(kGCC, Cin - c0), npc = min(kPC, P - pc0);
    j0 += 16;
    if (j0 >= npc * nc) {
      j0 = 0;
      c0 += kGCC;
      if (c0 >= Cin) {
        c0 = 0;
        pc0 += kPC;
      }
    }
  }
};

// out[q, col] = acc / max(cnt[q], 1) for a warp's two m-tiles (queries q0 +
// 16 m + g (+ 8)) and NT n-tiles from column col_w, within Nq and Cout.
template <int NT>
__device__ __forceinline__ void store_any_shape(float* out, const float (&acc)[2][NT][4],
                                                const int* cnt, int b, int q0, int Nq, int Cout,
                                                int col_w, int g, int t) {
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = 16 * m + g + 8 * h;
      if (q0 + qi >= Nq) continue;
      const float den = (float)max(cnt[qi], 1);
      float* orow = out + ((size_t)b * Nq + q0 + qi) * Cout;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col_w + 8 * n + 2 * t + e;
          if (col < Cout) orow[col] = acc[m][n][2 * h + e] / den;
        }
    }
  }
}

}  // namespace
