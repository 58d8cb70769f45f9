// Set-abstraction grouping for Hopper (sm_90a): exact k-nearest selection,
// neighbour-row gather, center subtraction and ball-query substitution.
//
// Replaces the TPU kernels
//   _knn_gather_block_kernel  pdfnet_tpu/ops/pallas_knn.py:172  (eval, level 1)
//   _knn_gather_feat_kernel   pdfnet_tpu/ops/pallas_knn.py:107  (level 2)
//   _knn_gather_kernel        pdfnet_tpu/ops/pallas_knn.py:82   (train, level 1)
//   _knn_kernel               pdfnet_tpu/ops/pallas_knn.py:70   (knn_pallas)
// All compute one function on rows of width C (C == 3 at level 1):
//   for each of the first S rows (the centers) of a hand's (N, C) feature
//   block, select the k rows with the smallest exact float32
//   d2 = (dx*dx + dy*dy) + dz*dz over the first three channels, ascending,
//   the lower index winning ties; emit row - center in the xyz channels, or,
//   where d2 > r2, the center's own row with zero xyz.  At level 1 that
//   substitute is all zeros, as the TPU kernel writes.  The train path's
//   entry points also write each neighbour's index and d2, and its level-1
//   entry point skips the substitution (the caller applies it, as
//   knn_gather_xyz_pallas leaves it to _fused_group_pallas).  The knn entry
//   point (knn_pallas's contract) takes its centers as a separate (H, S, 3)
//   operand and writes only each neighbour's index and d2.
//
// Bound on the H100: the larger of ~9 float32 operations per (center,
// point) pair for d2 and its rank, and the bytes: the rows read once, the
// output written once (H*S*k*C elements, plus 8 bytes of index and distance
// per neighbour on the train path).  Both levels are bound by their bytes
// (level 1 barely: 1.9 us against 1.1 us of operations at batch 8, level 2
// by its 34 MB of bf16 rows).  What sets the time is the selection's
// instruction issue at level 1, and at level 2 the selection and the row
// write, which do not overlap: every block of the grid is resident at once,
// so all of them select, then all of them write.
//
// Design: one warp per center, kWarps = 8 centers per block, the hand's xyz
// staged once per block in shared memory.  The TPU kernel's k rounds of a
// masked argmin over the whole row (a fit for a vector unit holding a
// (128, N) tile) become, per center, work on each (center, point) pair a
// fixed number of times, in four phases:
//   1. keys: each lane computes N/32 distances into registers; a distance is
//      ranked by its bit pattern as an unsigned integer (the order of
//      non-negative floats), NaN canonicalised above +inf and the slots past
//      the hand above everything (the plain version's stable-sort order).
//      __fmul_rn/__fadd_rn keep the compiler from contracting into FMAs, so
//      d2 is bit-identical to the plain version's.
//   2. threshold: the k-th smallest key T by binary search on the key value,
//      one warp-wide count (__reduce_add_sync) of keys <= mid per pass, the
//      interval first narrowed by the lanes' order statistics (for k <= 64:
//      T lies between the smallest and the largest of the lanes' m-th
//      smallest keys, m = ceil(k/32)), so the passes only span the bits
//      in which candidate thresholds differ.
//   3. compaction: every key < T and the first k - count(< T) keys == T in
//      index order (a ballot and a prefix popcount per register), written as
//      64-bit (key << 32 | index) composites to a per-warp buffer in shared
//      memory.  The composite is unique, so ranking the k survivors by it
//      (each lane counts the smaller survivors of its own) gives exactly the
//      plain version's stable order, ties at the k-th place, points on the
//      radius and NaN/inf clouds included.
//   4. output, after a block barrier and never interleaved with selection:
//      the block's centers are consecutive, so its outputs are one flat
//      range of the (H, S, k[, C]) tensors.  Index and distance are two
//      coalesced streams over it.  Rows of C >= 32 channels (level 2) are
//      copied a row per warp, lanes over the channels, four rows loaded
//      before any is stored; narrow rows (C = 3) are written by all the
//      block's threads in element order as 16-byte vector stores (scalar at
//      the unaligned head and tail).
// Shared memory grows with k (two (8, k) arrays of 8-byte composites): above
// 48 KB (k > 288 at N = 1024) the launch opts in, up to 140 KB at
// k = N = 1024.
//
// Wide clouds (N > 1024): the ranked composites go to a global workspace
// of (H, S, k) 8-byte entries instead of a second shared array, so shared
// memory is 8 * k * 8 + 12 * N bytes.  Up to N = 2048 the lane keeps its 64
// keys in registers (PL = 64); wider, every pass of phases 1-3 recomputes
// them from the xyz (PL = 0: three subtractions, three products, two sums
// and the compare a key, bit-identical to phase 1's).
//
// Past shared memory (8 * k * 8 + 12 * N > kMaxSmem, the H100's 227 KB a
// block: N = 4096 with k > 2864, k = N > 3058, N > 19370 at any k), the
// selection spills instead of refusing, on the PL = 0 path only (the main
// shapes, N <= 4096 and k <= 128, never spill and keep their code):
// spill 1 puts the per-warp candidate lists in device memory too, a second
// (H, S, k) half of the workspace, and keeps the staged xyz; spill 2 (12 *
// N > kMaxSmem) also reads each point's xyz from its row in device memory
// (L2), converted as the staged copy would be.  The arithmetic and the
// order are those of the other paths, so the result is the same bits.
// ops/sa.selection_smem_bytes and selection_spill mirror these sizes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;                   // centers (warps) per block
constexpr int kWidePoints = 1024;   // wider: ranked composites in a workspace
constexpr int kRegKeys = 2048;      // keys in registers up to here (PL <= 64)
constexpr int kSmemDefault = 48 * 1024;     // above it only by opting in
constexpr size_t kMaxSmem = 232448;         // 227 KB a block on the H100
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNaNKey = 0x7fc00000u;   // canonical NaN, above +inf
constexpr unsigned kPad = 0xffffffffu;      // past the hand: never selected

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Channel d < 3 of point n of a hand: staged in shared memory as float
// (N, 3), or (spill 2) read from the hand's (N, C) rows in device memory.
struct SharedXyz {
  const float* s;
  __device__ __forceinline__ float operator()(int n, int d) const {
    return s[3 * n + d];
  }
};
template <typename T>
struct GlobalXyz {
  const T* g;
  int C;
  __device__ __forceinline__ float operator()(int n, int d) const {
    return to_f32(g[static_cast<int64_t>(n) * C + d]);
  }
};

// The rank key of point n (phase 1): d2's bit pattern, NaN canonicalised
// above +inf, kPad past the hand.
template <typename X>
__device__ __forceinline__ unsigned point_key(const X& xyz, int n, int N,
                                              float cx, float cy, float cz) {
  if (n >= N) return kPad;
  const float dx = __fsub_rn(xyz(n, 0), cx);
  const float dy = __fsub_rn(xyz(n, 1), cy);
  const float dz = __fsub_rn(xyz(n, 2), cz);
  const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                            __fmul_rn(dz, dz));
  return d != d ? kNaNKey : __float_as_uint(d);
}

// Bounds of T from the lanes' smallest (m1) and second smallest (m2) keys.
// With m = ceil(K/32): every lane holds at least m keys <= the largest
// lane's m-th smallest (so count(<= hi) >= 32m >= K), and at most m - 1
// keys < the smallest lane's m-th smallest (so count(< lo) <= 32(m - 1) <
// K).  Every real key is <= kNaNKey.
__device__ __forceinline__ void threshold_bounds(unsigned m1, unsigned m2,
                                                 int K, unsigned& lo,
                                                 unsigned& hi) {
  if (K <= 32) {
    lo = __reduce_min_sync(kFull, m1);
    hi = __reduce_max_sync(kFull, m1);
  } else if (K <= 64) {
    lo = __reduce_min_sync(kFull, m2);
    hi = __reduce_max_sync(kFull, m2);
  } else {
    lo = __reduce_min_sync(kFull, m1);
    hi = kNaNKey;
  }
  hi = min(hi, kNaNKey);
}

// Phase 3's ranking: each of the K unique composites in cand goes to its
// rank in sorted; two per lane and pass, every lane reading the same
// composite (a broadcast).
__device__ __forceinline__ void rank_composites(
    const unsigned long long* __restrict__ cand,
    unsigned long long* __restrict__ sorted, int K) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < K; base += 64) {
    const int i0 = base + lane, i1 = i0 + 32;
    const unsigned long long c0 = i0 < K ? cand[i0] : ~0ull;
    const unsigned long long c1 = i1 < K ? cand[i1] : ~0ull;
    int r0 = 0, r1 = 0;
    for (int i = 0; i < K; ++i) {
      const unsigned long long c = cand[i];
      r0 += c < c0;
      r1 += c < c1;
    }
    if (i0 < K) sorted[r0] = c0;
    if (i1 < K) sorted[r1] = c1;
  }
}

// Phases 1-3 for one center: writes its k neighbours' (key << 32 | index)
// in ascending order to sorted[0, K).  PL keys per lane (N <= 32 * PL).
template <int PL>
__device__ __forceinline__ void select_center(
    const float* __restrict__ sxyz, float cx, float cy, float cz, int N,
    int K, unsigned long long* __restrict__ cand,
    unsigned long long* __restrict__ sorted) {
  const int lane = threadIdx.x & 31;
  unsigned key[PL];
  unsigned m1 = kPad, m2 = kPad;   // the lane's smallest and second smallest
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    const int n = j * 32 + lane;
    unsigned a = kPad;
    if (n < N) {
      const float dx = __fsub_rn(sxyz[3 * n + 0], cx);
      const float dy = __fsub_rn(sxyz[3 * n + 1], cy);
      const float dz = __fsub_rn(sxyz[3 * n + 2], cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      a = d != d ? kNaNKey : __float_as_uint(d);
    }
    key[j] = a;
    m2 = min(m2, max(m1, a));
    m1 = min(m1, a);
  }

  // bounds of T
  unsigned lo, hi;
  threshold_bounds(m1, m2, K, lo, hi);

  // the smallest T with count(key <= T) >= K
  while (lo < hi) {
    const unsigned mid = lo + ((hi - lo) >> 1);
    unsigned c = 0;
#pragma unroll
    for (int j = 0; j < PL; ++j) c += key[j] <= mid ? 1u : 0u;
    if (__reduce_add_sync(kFull, c) >= static_cast<unsigned>(K)) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  const unsigned T = lo;
  unsigned less = 0;
#pragma unroll
  for (int j = 0; j < PL; ++j) less += key[j] < T ? 1u : 0u;
  const unsigned take = K - __reduce_add_sync(kFull, less);   // >= 1

  // compaction in index order n = j * 32 + lane
  const unsigned below = (1u << lane) - 1u;
  unsigned eq_seen = 0, pos = 0;
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    const unsigned a = key[j];
    const bool eq = a == T;
    const unsigned beq = __ballot_sync(kFull, eq);
    const bool sel = a < T || (eq && eq_seen + __popc(beq & below) < take);
    const unsigned bsel = __ballot_sync(kFull, sel);
    if (sel) {
      cand[pos + __popc(bsel & below)] =
          (static_cast<unsigned long long>(a) << 32) |
          static_cast<unsigned>(j * 32 + lane);
    }
    pos += __popc(bsel);
    eq_seen += __popc(beq);
  }
  __syncwarp();
  rank_composites(cand, sorted, K);
}

// Phases 1-3 for clouds wider than kRegKeys: the same selection with each
// lane's keys j = 0 .. ceil(N/32) - 1 recomputed on every pass.
template <typename X>
__device__ __forceinline__ void select_center_wide(
    const X& xyz, float cx, float cy, float cz, int N, int K,
    unsigned long long* __restrict__ cand,
    unsigned long long* __restrict__ sorted) {
  const int lane = threadIdx.x & 31;
  const int J = (N + 31) / 32;
  unsigned m1 = kPad, m2 = kPad;
  for (int j = 0; j < J; ++j) {
    const unsigned a = point_key(xyz, j * 32 + lane, N, cx, cy, cz);
    m2 = min(m2, max(m1, a));
    m1 = min(m1, a);
  }
  unsigned lo, hi;
  threshold_bounds(m1, m2, K, lo, hi);
  while (lo < hi) {
    const unsigned mid = lo + ((hi - lo) >> 1);
    unsigned c = 0;
    for (int j = 0; j < J; ++j) {
      c += point_key(xyz, j * 32 + lane, N, cx, cy, cz) <= mid ? 1u : 0u;
    }
    if (__reduce_add_sync(kFull, c) >= static_cast<unsigned>(K)) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  const unsigned T = lo;
  unsigned less = 0;
  for (int j = 0; j < J; ++j) {
    less += point_key(xyz, j * 32 + lane, N, cx, cy, cz) < T ? 1u : 0u;
  }
  const unsigned take = K - __reduce_add_sync(kFull, less);   // >= 1

  const unsigned below = (1u << lane) - 1u;
  unsigned eq_seen = 0, pos = 0;
  for (int j = 0; j < J; ++j) {
    const unsigned a = point_key(xyz, j * 32 + lane, N, cx, cy, cz);
    const bool eq = a == T;
    const unsigned beq = __ballot_sync(kFull, eq);
    const bool sel = a < T || (eq && eq_seen + __popc(beq & below) < take);
    const unsigned bsel = __ballot_sync(kFull, sel);
    if (sel) {
      cand[pos + __popc(bsel & below)] =
          (static_cast<unsigned long long>(a) << 32) |
          static_cast<unsigned>(j * 32 + lane);
    }
    pos += __popc(bsel);
    eq_seen += __popc(beq);
  }
  __syncwarp();
  rank_composites(cand, sorted, K);
}

// Rows of C >= 32 channels (level 2): warp w copies rows q = w, w + kWarps,
// ... of the block, its lanes over the channels, so that the out-of-ball
// choice is one per row and both the loads and the stores of a warp are
// contiguous.  Four rows of up to 160 channels are loaded before any is
// stored, to keep enough loads in flight at level 2's few blocks per SM.
template <typename T, bool kBall, typename X>
__device__ __forceinline__ void write_rows(
    const T* __restrict__ fh, const X& xyz,
    const unsigned long long* __restrict__ sorted, T* __restrict__ ob,
    int s0, int rows, int C, int K, float r2) {
  constexpr int kR = 4, kT = 5;
  const int lane = threadIdx.x & 31;
  for (int q0 = threadIdx.x >> 5; q0 < rows; q0 += kR * kWarps) {
    const T* src[kR];
    T* dst[kR];
    int sq[kR];
    bool in[kR], ok[kR];
#pragma unroll
    for (int u = 0; u < kR; ++u) {
      const int q = q0 + u * kWarps;
      ok[u] = q < rows;
      const unsigned long long c = ok[u] ? sorted[q] : 0ull;
      sq[u] = s0 + (ok[u] ? q / K : 0);
      in[u] = !kBall || __uint_as_float(static_cast<unsigned>(c >> 32)) <= r2;
      src[u] = fh + static_cast<int64_t>(
                        in[u] ? static_cast<int>(c & 0xffffffffu) : sq[u]) * C;
      dst[u] = ob + static_cast<int64_t>(q) * C;
    }
    for (int c0 = 0; c0 < C; c0 += 32 * kT) {
      T v[kR][kT];
#pragma unroll
      for (int u = 0; u < kR; ++u) {
#pragma unroll
        for (int t = 0; t < kT; ++t) {
          const int ch = c0 + 32 * t + lane;
          if (ok[u] && ch < C) v[u][t] = src[u][ch];
        }
      }
#pragma unroll
      for (int u = 0; u < kR; ++u) {
#pragma unroll
        for (int t = 0; t < kT; ++t) {
          const int ch = c0 + 32 * t + lane;
          if (!ok[u] || ch >= C) continue;
          T x = v[u][t];
          if (ch < 3) {
            x = in[u] ? from_f32<T>(__fsub_rn(to_f32(x), xyz(sq[u], ch)))
                      : from_f32<T>(0.0f);
          }
          dst[u][ch] = x;
        }
      }
    }
  }
}

// kSel: also write idx (int32) and d2 (float32) per neighbour.
// kBall: substitute out-of-ball neighbours (else always row - center).
// kRows: write the grouped rows (else only idx and d2).
// centers: (H, S, 3) float32, or nullptr for the first S rows of feat.
// PL: keys per lane in registers, or 0 to recompute them.  Wide clouds
// (PL == 0 or 64, N > kWidePoints) rank their composites into ws, (H, S, K)
// entries.  Shared memory: two (kWarps, K) arrays of composites (one for a
// wide cloud), then the (N, 3) xyz.  kSpill (PL == 0 only): 1 puts the
// candidate lists in ws too, a second (H, S, K) half; 2 also leaves the xyz
// in device memory.
template <typename T, bool kSel, bool kBall, bool kRows, int PL,
          int kSpill = 0>
__global__ void __launch_bounds__(kWarps * 32)
sa_group_kernel(const T* __restrict__ feat, T* __restrict__ out,
                int32_t* __restrict__ idx_out, float* __restrict__ dist_out,
                const float* __restrict__ centers,
                unsigned long long* __restrict__ ws, int N, int C, int S,
                int K, float r2) {
  static_assert(kSpill == 0 || PL == 0, "only the PL = 0 path spills");
  constexpr bool kWide = PL == 0 || PL > 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.y;
  const int s0 = blockIdx.x * kWarps;
  const int64_t block_rows = (static_cast<int64_t>(h) * S + s0) * K;
  unsigned long long* cand =
      kSpill > 0
          ? ws + static_cast<int64_t>(gridDim.y) * S * K + block_rows
          : reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* sorted = kWide ? ws + block_rows : cand + kWarps * K;
  float* sxyz = kSpill > 0 ? reinterpret_cast<float*>(smem)
                           : reinterpret_cast<float*>(
                                 cand + (kWide ? 1 : 2) * kWarps * K);

  const T* fh = feat + static_cast<int64_t>(h) * N * C;
  if constexpr (kSpill < 2) {
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      const T* row = fh + static_cast<int64_t>(i) * C;
      sxyz[3 * i + 0] = to_f32(row[0]);
      sxyz[3 * i + 1] = to_f32(row[1]);
      sxyz[3 * i + 2] = to_f32(row[2]);
    }
    __syncthreads();
  }
  const auto xyz = [&] {
    if constexpr (kSpill == 2) {
      return GlobalXyz<T>{fh, C};
    } else {
      return SharedXyz{sxyz};
    }
  }();

  const int w = threadIdx.x >> 5;
  const int s = s0 + w;
  if (s < S) {
    const float* ctr =
        centers != nullptr ? centers + (static_cast<int64_t>(h) * S + s) * 3
                           : nullptr;
    const float cx = ctr != nullptr ? ctr[0] : xyz(s, 0);
    const float cy = ctr != nullptr ? ctr[1] : xyz(s, 1);
    const float cz = ctr != nullptr ? ctr[2] : xyz(s, 2);
    if constexpr (PL > 0) {
      select_center<PL>(sxyz, cx, cy, cz, N, K, cand + w * K,
                        sorted + w * K);
    } else {
      select_center_wide(xyz, cx, cy, cz, N, K, cand + w * K,
                         sorted + w * K);
    }
  }
  __syncthreads();

  // the block's centers s0 .. s0 + nw - 1 own rows row0 .. row0 + nw*K - 1
  const int nw = min(kWarps, S - s0);
  const int64_t row0 = (static_cast<int64_t>(h) * S + s0) * K;
  if (kSel) {
    for (int i = threadIdx.x; i < nw * K; i += blockDim.x) {
      const unsigned long long c = sorted[i];
      idx_out[row0 + i] = static_cast<int32_t>(c & 0xffffffffu);
      dist_out[row0 + i] = __uint_as_float(static_cast<unsigned>(c >> 32));
    }
  }
  if (!kRows) return;
  T* ob = out + row0 * C;
  if (C >= 32) {
    write_rows<T, kBall>(fh, xyz, sorted, ob, s0, nw * K, C, K, r2);
    return;
  }

  // narrow rows (C = 3 at level 1): flat over the block's elements
  // element (q = w*K + r, ch) of the block's rows
  auto value = [&](int q, int wq, int ch) -> T {
    const unsigned long long c = sorted[q];
    const int sq = s0 + wq;
    if (!kBall || __uint_as_float(static_cast<unsigned>(c >> 32)) <= r2) {
      const T v = fh[static_cast<int64_t>(c & 0xffffffffu) * C + ch];
      return ch < 3 ? from_f32<T>(__fsub_rn(to_f32(v), xyz(sq, ch)))
                    : v;
    }
    return ch < 3 ? from_f32<T>(0.0f) : fh[static_cast<int64_t>(sq) * C + ch];
  };
  constexpr int V = 16 / sizeof(T);
  const int total = nw * K * C;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(ob) & 15);
  const int head = min(total, ((16 - mis) & 15) / static_cast<int>(sizeof(T)));
  const int nvec = (total - head) / V;
  for (int e = threadIdx.x; e < head; e += blockDim.x) {
    const int q = e / C;
    ob[e] = value(q, q / K, e - q * C);
  }
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    const int e = head + v * V;
    int q = e / C;
    int ch = e - q * C;
    int wq = q / K;
    int r = q - wq * K;
    alignas(16) T vals[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      vals[i] = value(q, wq, ch);
      if (++ch == C) {
        ch = 0;
        ++q;
        if (++r == K) {
          r = 0;
          ++wq;
        }
      }
    }
    *reinterpret_cast<uint4*>(ob + e) = *reinterpret_cast<const uint4*>(vals);
  }
  for (int e = head + nvec * V + threadIdx.x; e < total; e += blockDim.x) {
    const int q = e / C;
    ob[e] = value(q, q / K, e - q * C);
  }
}

template <typename T, bool kSel, bool kBall, bool kRows, int PL,
          int kSpill = 0>
int launch_pl(dim3 grid, size_t smem, cudaStream_t stream,
              const T* feat, T* out, int32_t* idx, float* dist,
              const float* centers, unsigned long long* ws, int N, int C,
              int S, int K, float r2) {
  auto kernel = sa_group_kernel<T, kSel, kBall, kRows, PL, kSpill>;
  if (smem > static_cast<size_t>(kSmemDefault)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kWarps * 32, smem, stream>>>(feat, out, idx, dist, centers,
                                              ws, N, C, S, K, r2);
  return static_cast<int>(cudaGetLastError());
}

// Mirrored by ops/sa.selection_smem_bytes.
size_t smem_bytes(int N, int K) {
  const size_t lists = N > kWidePoints ? 1 : 2;
  return lists * kWarps * K * sizeof(unsigned long long) +
         static_cast<size_t>(N) * 3 * sizeof(float);
}

// 0: everything in shared memory; 1: the candidate lists in ws; 2: the xyz
// in device memory too.  Mirrored by ops/sa.selection_spill.
int spill_of(int N, int K) {
  if (smem_bytes(N, K) <= kMaxSmem) return 0;
  return static_cast<size_t>(N) * 3 * sizeof(float) <= kMaxSmem ? 1 : 2;
}

// ws: (H, S, K) 8-byte entries, needed (and only used) when N > kWidePoints;
// twice that when the selection spills (spill_of > 0).
template <typename T, bool kSel, bool kBall, bool kRows = true>
int launch(const void* feat, void* out, void* idx, void* dist, void* ws,
           int H, int N, int C, int S, int K, float r2, void* stream,
           const void* centers = nullptr) {
  // without separate centers, the centers are the first S rows
  if (H < 1 || H > 65535 || N < 1 || C < 3 || S < 1 ||
      (centers == nullptr && S > N) || K < 1 || K > N ||
      (N > kWidePoints && ws == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int spill = spill_of(N, K);
  const dim3 grid((S + kWarps - 1) / kWarps, H);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* f = static_cast<const T*>(feat);
  T* o = static_cast<T*>(out);
  int32_t* i = static_cast<int32_t*>(idx);
  float* d = static_cast<float*>(dist);
  const float* c = static_cast<const float*>(centers);
  auto* w = static_cast<unsigned long long*>(ws);
  if (spill == 1) {
    return launch_pl<T, kSel, kBall, kRows, 0, 1>(
        grid, static_cast<size_t>(N) * 3 * sizeof(float), st, f, o, i, d, c,
        w, N, C, S, K, r2);
  }
  if (spill == 2) {
    return launch_pl<T, kSel, kBall, kRows, 0, 2>(grid, 0, st, f, o, i, d, c,
                                                  w, N, C, S, K, r2);
  }
  const size_t smem = smem_bytes(N, K);
  if (N <= 256) {
    return launch_pl<T, kSel, kBall, kRows, 8>(grid, smem, st, f, o, i, d,
                                               c, w, N, C, S, K, r2);
  }
  if (N <= 512) {
    return launch_pl<T, kSel, kBall, kRows, 16>(grid, smem, st, f, o, i, d,
                                                c, w, N, C, S, K, r2);
  }
  if (N <= kWidePoints) {
    return launch_pl<T, kSel, kBall, kRows, 32>(grid, smem, st, f, o, i, d,
                                                c, w, N, C, S, K, r2);
  }
  if (N <= kRegKeys) {
    return launch_pl<T, kSel, kBall, kRows, 64>(grid, smem, st, f, o, i, d,
                                                c, w, N, C, S, K, r2);
  }
  return launch_pl<T, kSel, kBall, kRows, 0>(grid, smem, st, f, o, i, d, c,
                                             w, N, C, S, K, r2);
}

}  // namespace

// Every entry point takes ws, a device workspace of H * S * K 8-byte entries
// (2 * H * S * K where the selection spills past shared memory) that is used
// only for wide clouds (N > 1024) and may be null otherwise.

// Eval, level 1: points (H, N, 3) float32 -> out (H, S, K, 3) float32.
extern "C" int sa_group_l1(const void* points, void* out, void* ws, int H,
                           int N, int S, int K, float r2, void* stream) {
  return launch<float, false, true>(points, out, nullptr, nullptr, ws, H, N,
                                    3, S, K, r2, stream);
}

// Eval, level 2: feat (H, N, C) float32 (bf16 == 0) or bfloat16 (bf16 == 1)
// -> out (H, S, K, C) of the same type.
extern "C" int sa_group_l2(const void* feat, void* out, void* ws, int H,
                           int N, int C, int S, int K, float r2, int bf16,
                           void* stream) {
  return bf16 ? launch<__nv_bfloat16, false, true>(feat, out, nullptr, nullptr,
                                                   ws, H, N, C, S, K, r2,
                                                   stream)
              : launch<float, false, true>(feat, out, nullptr, nullptr, ws, H,
                                           N, C, S, K, r2, stream);
}

// Train, level 1: points (H, N, 3) float32 -> dist (H, S, K) float32,
// idx (H, S, K) int32, nbr (H, S, K, 3) float32 centered, not substituted.
extern "C" int knn_group_xyz(const void* points, void* dist, void* idx,
                             void* nbr, void* ws, int H, int N, int S, int K,
                             void* stream) {
  return launch<float, true, false>(points, nbr, idx, dist, ws, H, N, 3, S, K,
                                    0.0f, stream);
}

// Train, level 2: sa_group_l2's output plus idx (H, S, K) int32 and
// dist (H, S, K) float32.
extern "C" int group_feat(const void* feat, void* out, void* idx, void* dist,
                          void* ws, int H, int N, int C, int S, int K,
                          float r2, int bf16, void* stream) {
  return bf16 ? launch<__nv_bfloat16, true, true>(feat, out, idx, dist, ws, H,
                                                  N, C, S, K, r2, stream)
              : launch<float, true, true>(feat, out, idx, dist, ws, H, N, C,
                                          S, K, r2, stream);
}

// knn_pallas: centers (H, S, 3) and points (H, N, 3) float32 -> dist (H, S, K)
// float32 ascending, idx (H, S, K) int32.
extern "C" int knn(const void* centers, const void* points, void* dist,
                   void* idx, void* ws, int H, int N, int S, int K,
                   void* stream) {
  if (centers == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float, true, false, false>(points, nullptr, idx, dist, ws, H,
                                           N, 3, S, K, 0.0f, stream, centers);
}
