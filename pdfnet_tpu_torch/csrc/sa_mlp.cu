// Set-abstraction MLP + max-pool for Hopper (sm_90a).
//
// Replaces the TPU kernel _mlpmax_feat_kernel (pdfnet_tpu/ops/pallas_knn.py:201,
// with _mlp_folded :157): for each center's k grouped rows of width C, three
// BN-folded layers of (product in the compute dtype, float32 accumulate,
// + bias, ReLU in float32), then a max over the k rows.  Output (H*S, F3)
// float32.  One body serves both levels (3->64->64->128 and
// 131->128->128->256) through its width template.
//
// Two bodies share this file.
//
// bf16 compute (sa_mlp_tc_kernel, both levels of the eval path): the
// products on the tensor cores, mma.sync.m16n8k16 with bf16 operands and
// float32 accumulators.  Persistent blocks of 8 warps, as many as fit on the
// SMs, each staging the three bf16 weight matrices in shared memory once
// (level 2: 141 KB, rows padded by 8 elements for conflict-free ldmatrix;
// 212 KB with the row buffers) and then looping over pairs of centers.  A
// pair's grouped rows are copied as they lie in device memory by cp.async,
// double buffered, so the next pair's rows load while this pair multiplies.
// Each of a center's 4 warps owns 16 of its first 64 rows and builds layer
// 1's A fragments from that copy, rounded to bf16, zero past k rows and C
// channels (C padded to a multiple of 16: level 1's C = 3 becomes one exact
// k16 slice).  Layer 1's float32 accumulators, + bias and ReLU, rounded
// to bf16, are directly the A fragments of layer 2 in registers, and layer
// 2's of layer 3 (the m16n8 accumulator layout of two n8 tiles is the
// m16k16 A layout), so the hidden layers never leave the registers.
// Layer 3 runs in 64-column slices: + bias, ReLU, the max over the warp's
// valid rows in registers and by shuffles, then over the 4 warps through
// shared memory.  Only the grouped
// rows are read from device memory and only the pooled (F3,) float32 vector
// is written.  Rounding points as before: inputs and each hidden layer to
// bf16, bias and ReLU in float32.
//
// k > 64 (both bodies): the k rows are walked in chunks of 64, the block's
// rows, and the max runs across chunks: in a register of each thread in
// the float32 body, in each warp's slot of the maxima in the bf16 body
// (written and re-read by the lane that owns the column).  The bf16 body
// then stages a pair's chunk as two ranges, one per center, so that its
// row buffers are those of k = 64 whatever k is; k <= 64 is one chunk and
// the code path of before.
//
// float32 compute (sa_mlp_max_kernel): float32 FMAs on the CUDA cores, one
// block of 256 threads per center, rows and hidden layers in shared memory,
// each thread one output column for a group of rows, weights read from L2.
// A float32 product on the tensor cores would be TF32, and the float32
// contract is true float32.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700 W), batch 8 = 16 hands: the
// products (2*k*(C*F1 + F1*F2 + F2*F3) per center) at the bf16 tensor-core
// rate, 0.0132 ms at level 1 and 0.0175 ms at level 2, above the grouped
// rows' read: operations.  The tensor-core body measured 0.07 ms at level 1
// and 0.10 ms at level 2 (chip_smoke.py, CUDA-graph replay, NVIDIA H100
// 80GB HBM3 at 700 W), against 0.79 / 0.44 ms for three cuBLAS matmuls
// with bias, ReLU and the max on the same groups.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "mma_util.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;  // rows a block takes at a time: a chunk of k
constexpr size_t kMaxSmem = 232448;  // 227 KB per block on the H100

// ---- float32 compute: the CUDA-core body ----------------------------------

// y[r, c] = relu(sum_i x[r, i] * w[i, c] + b[c]) for kRows rows.
// x: shared (kRows, cin_pad), zero beyond cin; w: global (cin, COUT).
// LAST: instead of storing y, fold the thread's row group's max over its
// valid rows (r < K, the chunk's rows) into run.
template <int COUT, bool LAST>
__device__ __forceinline__ void layer(const float* __restrict__ x, int cin,
                                      int cin_pad,
                                      const float* __restrict__ w,
                                      const float* __restrict__ b,
                                      float* __restrict__ y, int K,
                                      float& run) {
  static_assert(kThreads % COUT == 0, "COUT must divide the block");
  constexpr int kGroups = kThreads / COUT;
  constexpr int R = kRows / kGroups;
  const int c = threadIdx.x % COUT;
  const int r0 = (threadIdx.x / COUT) * R;
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;
  for (int i = 0; i < cin_pad; i += 4) {
    float wv[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      wv[t] = i + t < cin ? __ldg(w + static_cast<int64_t>(i + t) * COUT + c)
                          : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 xv =
          *reinterpret_cast<const float4*>(x + (r0 + r) * cin_pad + i);
      acc[r] = fmaf(xv.x, wv[0], acc[r]);
      acc[r] = fmaf(xv.y, wv[1], acc[r]);
      acc[r] = fmaf(xv.z, wv[2], acc[r]);
      acc[r] = fmaf(xv.w, wv[3], acc[r]);
    }
  }
  const float bv = b[c];
  if (LAST) {
    float m = -CUDART_INF_F;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r0 + r < K) m = fmaxf(m, fmaxf(acc[r] + bv, 0.0f));
    }
    run = fmaxf(run, m);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      y[(r0 + r) * COUT + c] = fmaxf(acc[r] + bv, 0.0f);
    }
  }
}

// kChunked (k > kRows): the rows in chunks of kRows; otherwise all k at once.
template <int F1, int F2, int F3, bool kChunked>
__global__ void __launch_bounds__(kThreads)
sa_mlp_max_kernel(const float* __restrict__ g, int K, int C, int c_pad,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  const float* __restrict__ w3, const float* __restrict__ b3,
                  float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* x0 = reinterpret_cast<float*>(smem4);  // (kRows, c_pad)
  float* h1 = x0 + kRows * c_pad;               // (kRows, F1)
  float* h2 = h1 + kRows * F1;                  // (kRows, F2)
  const int64_t center = blockIdx.x;
  float run = -CUDART_INF_F;  // this thread's column over its row groups
  // chunks of kRows rows; layer 1 reads x0 two barriers before the next
  // chunk overwrites it, and each layer's output likewise
  for (int c0 = 0; c0 < (kChunked ? K : 1); c0 += kRows) {
    const int kr = kChunked ? min(kRows, K - c0) : K;
    const float* gc = g + (center * K + c0) * C;
    for (int idx = threadIdx.x; idx < kRows * c_pad; idx += kThreads) {
      const int r = idx / c_pad, i = idx % c_pad;
      x0[idx] = (r < kr && i < C) ? gc[r * C + i] : 0.0f;
    }
    __syncthreads();
    layer<F1, false>(x0, C, c_pad, w1, b1, h1, kr, run);
    __syncthreads();
    layer<F2, false>(h1, F1, F1, w2, b2, h2, kr, run);
    __syncthreads();
    layer<F3, true>(h2, F2, F2, w3, b3, nullptr, kr, run);
  }
  float* red = x0;  // (kThreads / F3, F3) group maxima; x0 is free now
  red[threadIdx.x] = run;  // (group, c) = threadIdx.x
  __syncthreads();
  constexpr int kGroups = kThreads / F3;
  for (int c = threadIdx.x; c < F3; c += kThreads) {
    float m = red[c];
#pragma unroll
    for (int gi = 1; gi < kGroups; ++gi) m = fmaxf(m, red[gi * F3 + c]);
    out[center * F3 + c] = m;
  }
}

template <int F1, int F2, int F3>
int launch_f32(const void* g, int HS, int K, int C, const void* const* p,
               float* out, cudaStream_t stream) {
  const int c_pad = (C + 3) / 4 * 4;
  // the group maxima reuse x0, which must hold them
  if (kRows * c_pad < kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * kRows * (c_pad + F1 + F2);
  auto kernel = K > kRows ? sa_mlp_max_kernel<F1, F2, F3, true>
                          : sa_mlp_max_kernel<F1, F2, F3, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  auto f = [&](int i) { return static_cast<const float*>(p[i]); };
  kernel<<<HS, kThreads, smem, stream>>>(static_cast<const float*>(g), K, C,
                                          c_pad, f(0), f(1), f(2), f(3), f(4),
                                          f(5), out);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 compute: the tensor-core body -----------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarpRows = 16;                     // rows of a warp: one m16
constexpr int kWarpsPerCenter = kRows / kWarpRows;
constexpr int kCenters = kThreads / 32 / kWarpsPerCenter;  // per iteration
constexpr int kSlice = 64;                        // layer-3 columns a pass

__device__ __forceinline__ bf16 to_bf16(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ bf16 to_bf16(bf16 v) { return v; }

// Bytes of one raw buffer.  k <= kRows: the rows of kCenters centers as
// they lie in device memory, from the 16-byte boundary below the first.
// k > kRows: one slot a center (slot_bytes) for a chunk of its rows.
__host__ __device__ __forceinline__ int slot_bytes(int C, int esize) {
  return (kRows * C * esize + 16 + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ int raw_bytes(int K, int C, int esize) {
  return K <= kRows ? (kCenters * K * C * esize + 16 + 15) / 16 * 16
                    : kCenters * slot_bytes(C, esize);
}

// Mirrored by ops/sa.mlp_tc_smem_bytes.
template <int F1, int F2, int F3>
__host__ __device__ __forceinline__ size_t smem_bytes(int C, int K,
                                                      int esize) {
  const int c1p = (C + 15) / 16 * 16;
  return sizeof(bf16) * (static_cast<size_t>(c1p) * (F1 + 8) + F1 * (F2 + 8) +
                         F2 * (F3 + 8)) +
         2 * static_cast<size_t>(raw_bytes(K, C, esize)) +
         sizeof(float) * kCenters * kWarpsPerCenter * F3;
}

// dst (rows, cols + 8) <- src (n_src, cols) row-major, zero rows >= n_src.
__device__ __forceinline__ void stage_weights(bf16* dst, const bf16* src,
                                              int rows, int n_src, int cols) {
  for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
    const int r = e / cols, c = e % cols;
    dst[r * (cols + 8) + c] = r < n_src ? src[e] : __float2bfloat16_rn(0.0f);
  }
}

// cp.async of the bytes [s0, s1) of g (total bytes) into raw, from the
// 16-byte boundary a0 below s0; returns s0 - a0.
__device__ __forceinline__ int stage_raw(char* raw, const char* g, int64_t s0,
                                         int64_t s1, int64_t total) {
  const int64_t a0 = s0 & ~static_cast<int64_t>(15);
  const int n = static_cast<int>((s1 - a0 + 15) / 16);
  for (int v = threadIdx.x; v < n; v += kThreads) {
    const int64_t a = a0 + 16 * static_cast<int64_t>(v);
    const int64_t left = total - a;
    mma::cp_async16(raw + 16 * v, g + a,
                    left < 16 ? static_cast<int>(left) : 16);
  }
  return static_cast<int>(s0 - a0);
}

// acc (16 x 8*NT) = A (16 x 16*KT, fragments a) @ w (shared, row-major,
// stride ld), columns from n0.
template <int KT, int NT>
__device__ __forceinline__ void product(float (&acc)[NT][4],
                                        const uint32_t (&a)[KT][4],
                                        const bf16* w, int ld, int n0) {
  static_assert(NT % 2 == 0, "pairs of n8 tiles");
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.0f;
  }
  const bf16* b = w + mma::b_lane_offset(lane, ld) + n0;
#pragma unroll
  for (int t = 0; t < KT; ++t) {
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t bf[4];
      mma::ldmatrix_x4_trans(bf, b + t * 16 * ld + j * 8);
      mma::mma_bf16(acc[j], a[t], bf[0], bf[1]);
      mma::mma_bf16(acc[j + 1], a[t], bf[2], bf[3]);
    }
  }
}

// The next layer's A fragments: round(relu(acc + bias)) packed to bf16.
template <int NT>
__device__ __forceinline__ void to_fragments(uint32_t (&a)[NT / 2][4],
                                             const float (&acc)[NT][4],
                                             const float* __restrict__ bias) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float c0 = __ldg(bias + j * 8 + 2 * q);
    const float c1 = __ldg(bias + j * 8 + 2 * q + 1);
    a[j / 2][2 * (j % 2)] = mma::pack_bf16(fmaxf(acc[j][0] + c0, 0.0f),
                                           fmaxf(acc[j][1] + c1, 0.0f));
    a[j / 2][2 * (j % 2) + 1] = mma::pack_bf16(fmaxf(acc[j][2] + c0, 0.0f),
                                               fmaxf(acc[j][3] + c1, 0.0f));
  }
}

// kChunked (k > kRows): a pair's rows in chunks of kRows; otherwise one
// chunk of all k rows, staged as one range.
template <int F1, int F2, int F3, typename TIn, bool kChunked>
__global__ void __launch_bounds__(kThreads)
sa_mlp_tc_kernel(const TIn* __restrict__ g, int HS, int K, int C,
                 const bf16* __restrict__ w1, const float* __restrict__ b1,
                 const bf16* __restrict__ w2, const float* __restrict__ b2,
                 const bf16* __restrict__ w3, const float* __restrict__ b3,
                 float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int c1p = (C + 15) / 16 * 16;
  const int rb = raw_bytes(K, C, sizeof(TIn));
  bf16* sw1 = reinterpret_cast<bf16*>(smem4);     // (c1p, F1 + 8)
  bf16* sw2 = sw1 + c1p * (F1 + 8);               // (F1, F2 + 8)
  bf16* sw3 = sw2 + F1 * (F2 + 8);                // (F2, F3 + 8)
  char* raw = reinterpret_cast<char*>(sw3 + F2 * (F3 + 8));  // 2 x rb bytes
  float* red = reinterpret_cast<float*>(raw + 2 * rb);

  const int64_t row_bytes = static_cast<int64_t>(C) * sizeof(TIn);
  const int64_t center_bytes = K * row_bytes;
  const int64_t total = HS * center_bytes;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kCenters;
  const int nch = kChunked ? (K + kRows - 1) / kRows : 1;
  // stage chunk ch of the pair at base into buffer buf; head[i]: the byte
  // offset of center i's first row in that buffer
  auto stage = [&](int buf, int64_t base, int ch, int (&head)[kCenters]) {
    const char* gb = reinterpret_cast<const char*>(g);
    if constexpr (!kChunked) {
      const int64_t end = base + kCenters < HS ? base + kCenters : HS;
      const int h0 = stage_raw(raw + buf * rb, gb, base * center_bytes,
                               end * center_bytes, total);
#pragma unroll
      for (int i = 0; i < kCenters; ++i) {
        head[i] = h0 + i * static_cast<int>(center_bytes);
      }
      return;
    }
    const int slot = slot_bytes(C, sizeof(TIn));
    const int64_t r0 = static_cast<int64_t>(ch) * kRows;
    const int64_t nr = K - r0 < kRows ? K - r0 : kRows;
#pragma unroll
    for (int i = 0; i < kCenters; ++i) {
      head[i] = i * slot;
      if (base + i >= HS) continue;
      const int64_t s0 = (base + i) * center_bytes + r0 * row_bytes;
      head[i] += stage_raw(raw + buf * rb + i * slot, gb, s0,
                           s0 + nr * row_bytes, total);
    }
  };
  int64_t base = static_cast<int64_t>(blockIdx.x) * kCenters;
  int ch = 0;
  int head[kCenters];
  stage(0, base, 0, head);                        // overlaps the weights
  mma::cp_async_commit();
  stage_weights(sw1, w1, c1p, C, F1);
  stage_weights(sw2, w2, F1, F1, F2);
  stage_weights(sw3, w3, F2, F2, F3);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = warp / kWarpsPerCenter, wr = warp % kWarpsPerCenter;
  const int q = lane & 3;
  const int row0 = wr * kWarpRows + (lane >> 2);  // and row0 + 8
  for (int it = 0; base < HS; ++it) {
    // the next unit: this pair's next chunk, or the next pair's first
    const bool last = !kChunked || ch + 1 == nch;
    const int64_t next_base = last ? base + step : base;
    const int next_ch = last ? 0 : ch + 1;
    int next_head[kCenters] = {};
    if (next_base < HS) stage((it + 1) & 1, next_base, next_ch, next_head);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();  // this chunk's rows (and the weights) are in place

    // layer 1's A fragments straight from the raw rows: row r, channel c
    // of this warp's center, zero past the chunk's kr rows or C channels
    const int kr =
        !kChunked || K - ch * kRows < kRows ? K - ch * kRows : kRows;
    const TIn* x =
        reinterpret_cast<const TIn*>(raw + (it & 1) * rb + head[grp]);
    auto elem = [&](int r, int c) -> float {
      return r < kr && c < C ? __bfloat162float(to_bf16(x[r * C + c])) : 0.0f;
    };
    uint32_t h1[F1 / 16][4];
    {
      float acc[F1 / 8][4];
#pragma unroll
      for (int j = 0; j < F1 / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][r] = 0.0f;
      }
      const bf16* b = sw1 + mma::b_lane_offset(lane, F1 + 8);
      for (int k0 = 0; k0 < c1p; k0 += 16) {
        uint32_t a[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int r = row0 + (t & 1) * 8, c = k0 + 2 * q + (t >> 1) * 8;
          a[t] = mma::pack_bf16(elem(r, c), elem(r, c + 1));
        }
#pragma unroll
        for (int j = 0; j < F1 / 8; j += 2) {
          uint32_t bf[4];
          mma::ldmatrix_x4_trans(bf, b + k0 * (F1 + 8) + j * 8);
          mma::mma_bf16(acc[j], a, bf[0], bf[1]);
          mma::mma_bf16(acc[j + 1], a, bf[2], bf[3]);
        }
      }
      to_fragments<F1 / 8>(h1, acc, b1);
    }
    uint32_t h2[F2 / 16][4];
    {
      float acc[F2 / 8][4];
      product<F1 / 16, F2 / 8>(acc, h1, sw2, F2 + 8, 0);
      to_fragments<F2 / 8>(h2, acc, b2);
    }
    float* wred = red + (grp * kWarpsPerCenter + wr) * F3;
#pragma unroll 1
    for (int n0 = 0; n0 < F3; n0 += kSlice) {
      float acc[kSlice / 8][4];
      product<F2 / 16, kSlice / 8>(acc, h2, sw3, F3 + 8, n0);
#pragma unroll
      for (int j = 0; j < kSlice / 8; ++j) {
        const int col = n0 + j * 8 + 2 * q;
        const float c0 = __ldg(b3 + col), c1 = __ldg(b3 + col + 1);
        float m0 = row0 < kr ? fmaxf(acc[j][0] + c0, 0.0f) : -CUDART_INF_F;
        float m1 = row0 < kr ? fmaxf(acc[j][1] + c1, 0.0f) : -CUDART_INF_F;
        if (row0 + 8 < kr) {
          m0 = fmaxf(m0, fmaxf(acc[j][2] + c0, 0.0f));
          m1 = fmaxf(m1, fmaxf(acc[j][3] + c1, 0.0f));
        }
#pragma unroll
        for (int off = 4; off < 32; off *= 2) {
          m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
          m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
        }
        if (lane < 4) {
          if (kChunked && ch > 0) {  // the max of the earlier chunks
            m0 = fmaxf(m0, wred[col]);
            m1 = fmaxf(m1, wred[col + 1]);
          }
          wred[col] = m0;
          wred[col + 1] = m1;
        }
      }
    }
    __syncthreads();  // red complete; the raw buffer is free again
    for (int e = threadIdx.x; last && e < kCenters * F3; e += kThreads) {
      const int ci = e / F3, c = e % F3;
      if (base + ci >= HS) continue;
      const float* r = red + ci * kWarpsPerCenter * F3 + c;
      float m = r[0];
#pragma unroll
      for (int w = 1; w < kWarpsPerCenter; ++w) m = fmaxf(m, r[w * F3]);
      out[(base + ci) * F3 + c] = m;
    }
#pragma unroll
    for (int i = 0; i < kCenters; ++i) head[i] = next_head[i];
    base = next_base;
    ch = next_ch;
  }
}

template <int F1, int F2, int F3, typename TIn, bool kChunked>
int launch_body(const void* g, int HS, int K, int C, const void* const* p,
                float* out, cudaStream_t stream) {
  const size_t smem = smem_bytes<F1, F2, F3>(C, K, sizeof(TIn));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(g) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  auto kernel = sa_mlp_tc_kernel<F1, F2, F3, TIn, kChunked>;
  // once per instantiation, so that a launch under CUDA-graph capture makes
  // no other attribute call
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t pairs = (static_cast<int64_t>(HS) + kCenters - 1) / kCenters;
  const int64_t slots = static_cast<int64_t>(sms) * per_sm;
  const int grid = static_cast<int>(pairs < slots ? pairs : slots);
  auto w = [&](int i) { return static_cast<const bf16*>(p[i]); };
  auto b = [&](int i) { return static_cast<const float*>(p[i]); };
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const TIn*>(g), HS, K,
                                           C, w(0), b(1), w(2), b(3), w(4),
                                           b(5), out);
  return static_cast<int>(cudaGetLastError());
}

template <int F1, int F2, int F3, typename TIn>
int launch(const void* g, int HS, int K, int C, const void* const* p,
           float* out, cudaStream_t stream) {
  return K > kRows
             ? launch_body<F1, F2, F3, TIn, true>(g, HS, K, C, p, out, stream)
             : launch_body<F1, F2, F3, TIn, false>(g, HS, K, C, p, out,
                                                   stream);
}

}  // namespace tc

template <int F1, int F2, int F3>
int dispatch(const void* g, int g_bf16, int bf16, int HS, int K, int C,
             const void* const* p, float* out, cudaStream_t stream) {
  if (!bf16) {
    return g_bf16 ? static_cast<int>(cudaErrorInvalidValue)
                  : launch_f32<F1, F2, F3>(g, HS, K, C, p, out, stream);
  }
  return g_bf16 ? tc::launch<F1, F2, F3, __nv_bfloat16>(g, HS, K, C, p, out,
                                                        stream)
                : tc::launch<F1, F2, F3, float>(g, HS, K, C, p, out, stream);
}

}  // namespace

// grouped (HS, K, C) of float32 (g_bf16 == 0) or bfloat16 (g_bf16 == 1);
// compute dtype bfloat16 when bf16 == 1 (a bf16 input needs bf16 compute).
// Weights w_l (C_in, F_l) row-major: bfloat16 when bf16 == 1, else float32;
// biases float32; out (HS, F3) float32.  Widths (F1, F2, F3) must be
// (64, 64, 128) or (128, 128, 256); K >= 1.
extern "C" int sa_mlp_max(const void* g, int g_bf16, int bf16, int HS, int K,
                          int C, int F1, int F2, int F3, const void* w1,
                          const void* b1, const void* w2, const void* b2,
                          const void* w3, const void* b3, void* out,
                          void* stream) {
  if (HS < 1 || K < 1 || C < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* p[6] = {w1, b1, w2, b2, w3, b3};
  auto* fout = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (F1 == 64 && F2 == 64 && F3 == 128) {
    return dispatch<64, 64, 128>(g, g_bf16, bf16, HS, K, C, p, fout, st);
  }
  if (F1 == 128 && F2 == 128 && F3 == 256) {
    return dispatch<128, 128, 256>(g, g_bf16, bf16, HS, K, C, p, fout, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
