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
// Design: one warp per center, eight centers per block.  The hand's xyz is
// staged in shared memory (12 KB at N = 1024); each lane keeps N/32
// distances in registers and k rounds of a warp-shuffle argmin over
// (value, index) pick the neighbours, so nothing but the output touches
// device memory.  The products and sums use __fmul_rn/__fadd_rn so the
// compiler cannot contract them into FMAs: selection then matches the plain
// version bit for bit, ties and points exactly on the radius included.
// Distances are ranked by their bit patterns as unsigned integers (the
// order of non-negative floats), with NaN above +inf, which is the order of
// the plain version's stable sort: a non-finite cloud selects real rows
// instead of reading past the hand.
//
// Bound on the H100: the output write (H*S*k*C elements, plus 8 bytes of
// index and distance per neighbour on the train path) against ~9 float32
// operations per (center, point) pair; at the main path's shapes the bytes
// dominate, and the k rounds of shuffles, not either bound, set the time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;        // centers per block
constexpr int kPerLane = 32;     // distances per lane: N <= 1024
constexpr int kMaxPoints = 32 * kPerLane;
constexpr unsigned kNaNKey = 0x7fc00000u;   // canonical NaN, above +inf
constexpr unsigned kTaken = 0xffffffffu;    // selected, or past the hand

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

// kSel: also write idx (int32) and d2 (float32) per neighbour.
// kBall: substitute out-of-ball neighbours (else always row - center).
// kRows: write the grouped rows (else only idx and d2).
// centers: (H, S, 3) float32, or nullptr for the first S rows of feat.
template <typename T, bool kSel, bool kBall, bool kRows = true>
__global__ void __launch_bounds__(kWarps * 32)
sa_group_kernel(const T* __restrict__ feat, T* __restrict__ out,
                int32_t* __restrict__ idx_out, float* __restrict__ dist_out,
                const float* __restrict__ centers, int N, int C, int S, int K,
                float r2) {
  extern __shared__ float sxyz[];  // (N, 3) float32
  const int h = blockIdx.y;
  const T* fh = feat + static_cast<int64_t>(h) * N * C;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const T* row = fh + static_cast<int64_t>(i) * C;
    sxyz[3 * i + 0] = to_f32(row[0]);
    sxyz[3 * i + 1] = to_f32(row[1]);
    sxyz[3 * i + 2] = to_f32(row[2]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= S) return;
  const float* ctr = centers != nullptr
                         ? centers + (static_cast<int64_t>(h) * S + s) * 3
                         : sxyz + 3 * s;
  const float cx = ctr[0];
  const float cy = ctr[1];
  const float cz = ctr[2];

  unsigned key[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int n = j * 32 + lane;
    if (n < N) {
      const float dx = __fsub_rn(sxyz[3 * n + 0], cx);
      const float dy = __fsub_rn(sxyz[3 * n + 1], cy);
      const float dz = __fsub_rn(sxyz[3 * n + 2], cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      key[j] = d != d ? kNaNKey : __float_as_uint(d);
    } else {
      key[j] = kTaken;
    }
  }

  const T* crow = fh + static_cast<int64_t>(s) * C;
  const int64_t row0 = (static_cast<int64_t>(h) * S + s) * K;
  T* orow = kRows ? out + row0 * C : nullptr;
  for (int r = 0; r < K; ++r) {
    // lane-local argmin; ascending j keeps the lowest index on ties
    unsigned best = kTaken;
    int bi = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      if (key[j] < best) {
        best = key[j];
        bi = j * 32 + lane;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ob < best || (ob == best && oi < bi)) {
        best = ob;
        bi = oi;
      }
    }
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      if (j * 32 + lane == bi) key[j] = kTaken;
    }

    const float d = __uint_as_float(best);
    if (kSel && lane == 0) {
      idx_out[row0 + r] = bi;
      dist_out[row0 + r] = d;
    }
    if (!kRows) continue;
    T* o = orow + static_cast<int64_t>(r) * C;
    if (!kBall || d <= r2) {
      const T* src = fh + static_cast<int64_t>(bi) * C;
      for (int ch = lane; ch < C; ch += 32) {
        if (ch < 3) {
          const float c = ch == 0 ? cx : (ch == 1 ? cy : cz);
          o[ch] = from_f32<T>(__fsub_rn(to_f32(src[ch]), c));
        } else {
          o[ch] = src[ch];
        }
      }
    } else {
      for (int ch = lane; ch < C; ch += 32) {
        o[ch] = ch < 3 ? from_f32<T>(0.0f) : crow[ch];
      }
    }
  }
}

template <typename T, bool kSel, bool kBall, bool kRows = true>
int launch(const void* feat, void* out, void* idx, void* dist, int H, int N,
           int C, int S, int K, float r2, void* stream,
           const void* centers = nullptr) {
  // without separate centers, the centers are the first S rows
  if (H < 1 || N < 1 || N > kMaxPoints || C < 3 || S < 1 ||
      (centers == nullptr && S > N) || K < 1 || K > N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid((S + kWarps - 1) / kWarps, H);
  const size_t smem = static_cast<size_t>(N) * 3 * sizeof(float);
  sa_group_kernel<T, kSel, kBall, kRows>
      <<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(feat), static_cast<T*>(out),
          static_cast<int32_t*>(idx), static_cast<float*>(dist),
          static_cast<const float*>(centers), N, C, S, K, r2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Eval, level 1: points (H, N, 3) float32 -> out (H, S, K, 3) float32.
extern "C" int sa_group_l1(const void* points, void* out, int H, int N, int S,
                           int K, float r2, void* stream) {
  return launch<float, false, true>(points, out, nullptr, nullptr, H, N, 3, S,
                                    K, r2, stream);
}

// Eval, level 2: feat (H, N, C) float32 (bf16 == 0) or bfloat16 (bf16 == 1)
// -> out (H, S, K, C) of the same type.
extern "C" int sa_group_l2(const void* feat, void* out, int H, int N, int C,
                           int S, int K, float r2, int bf16, void* stream) {
  return bf16 ? launch<__nv_bfloat16, false, true>(feat, out, nullptr, nullptr,
                                                   H, N, C, S, K, r2, stream)
              : launch<float, false, true>(feat, out, nullptr, nullptr, H, N,
                                           C, S, K, r2, stream);
}

// Train, level 1: points (H, N, 3) float32 -> dist (H, S, K) float32,
// idx (H, S, K) int32, nbr (H, S, K, 3) float32 centered, not substituted.
extern "C" int knn_group_xyz(const void* points, void* dist, void* idx,
                             void* nbr, int H, int N, int S, int K,
                             void* stream) {
  return launch<float, true, false>(points, nbr, idx, dist, H, N, 3, S, K,
                                    0.0f, stream);
}

// Train, level 2: sa_group_l2's output plus idx (H, S, K) int32 and
// dist (H, S, K) float32.
extern "C" int group_feat(const void* feat, void* out, void* idx, void* dist,
                          int H, int N, int C, int S, int K, float r2,
                          int bf16, void* stream) {
  return bf16 ? launch<__nv_bfloat16, true, true>(feat, out, idx, dist, H, N,
                                                  C, S, K, r2, stream)
              : launch<float, true, true>(feat, out, idx, dist, H, N, C, S, K,
                                          r2, stream);
}

// knn_pallas: centers (H, S, 3) and points (H, N, 3) float32 -> dist (H, S, K)
// float32 ascending, idx (H, S, K) int32.
extern "C" int knn(const void* centers, const void* points, void* dist,
                   void* idx, int H, int N, int S, int K, void* stream) {
  if (centers == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float, true, false, false>(points, nullptr, idx, dist, H, N, 3,
                                           S, K, 0.0f, stream, centers);
}
