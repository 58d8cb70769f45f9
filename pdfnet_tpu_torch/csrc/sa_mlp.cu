// Set-abstraction MLP + max-pool for Hopper (sm_90a).
//
// Replaces the TPU kernel _mlpmax_feat_kernel (pdfnet_tpu/ops/pallas_knn.py:201,
// with _mlp_folded :157): for each center's k grouped rows of width C, three
// BN-folded layers of (product in the compute dtype, float32 accumulate,
// + bias, ReLU in float32), then a max over the k rows.  Output (H*S, F3)
// float32.  One body serves both levels (3->64->64->128 and
// 131->128->128->256) through its width template.
//
// "Product in the compute dtype" is done as float32 FMAs on operands rounded
// to the compute dtype: the weights arrive pre-rounded, and the inputs and
// each hidden layer are rounded when they enter shared memory.  A bf16 x bf16
// product is exact in float32, so this is what a bf16 matrix unit with a
// float32 accumulator computes, up to the order of the sums.
//
// Design: one block of 256 threads per center.  The center's k <= 64 rows and
// both hidden layers stay in shared memory (99 KB at level 2); each thread
// owns one output column for a group of rows, reads its weight column from
// L2-resident global memory, and reads the rows as float4 broadcasts.  Only
// the grouped rows are read from device memory and only the pooled (F3,)
// vector is written.
//
// Bound on the H100: the products (2*k*(C*F1 + F1*F2 + F2*F3) per center)
// at the bf16 matrix rate take longer than the grouped-row read, 7x at level
// 1 and 1.7x at level 2 (bf16 rows); this simple kernel runs them as float32
// FMAs on the CUDA cores instead, far below that bound.  Tensor-core tiles
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;  // k <= 64

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <bool BF16>
__device__ __forceinline__ float round_cd(float v) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// y[r, c] = relu(sum_i x[r, i] * w[i, c] + b[c]) for kRows rows.
// x: shared (kRows, cin_pad), zero beyond cin; w: global (cin, COUT).
// LAST: instead of storing y, write each row group's max over its valid rows
// (r < K) to red[group, c].
template <int COUT, bool BF16, bool LAST>
__device__ __forceinline__ void layer(const float* __restrict__ x, int cin,
                                      int cin_pad,
                                      const float* __restrict__ w,
                                      const float* __restrict__ b,
                                      float* __restrict__ y, int K) {
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
    y[(threadIdx.x / COUT) * COUT + c] = m;
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      y[(r0 + r) * COUT + c] = round_cd<BF16>(fmaxf(acc[r] + bv, 0.0f));
    }
  }
}

template <int F1, int F2, int F3, typename TIn, bool BF16>
__global__ void __launch_bounds__(kThreads)
sa_mlp_max_kernel(const TIn* __restrict__ g, int K, int C, int c_pad,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  const float* __restrict__ w3, const float* __restrict__ b3,
                  float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* x0 = reinterpret_cast<float*>(smem4);  // (kRows, c_pad)
  float* h1 = x0 + kRows * c_pad;               // (kRows, F1)
  float* h2 = h1 + kRows * F1;                  // (kRows, F2); reused for red
  const int64_t center = blockIdx.x;
  const TIn* gc = g + center * K * C;
  for (int idx = threadIdx.x; idx < kRows * c_pad; idx += kThreads) {
    const int r = idx / c_pad, i = idx % c_pad;
    x0[idx] = (r < K && i < C) ? round_cd<BF16>(to_f32(gc[r * C + i])) : 0.0f;
  }
  __syncthreads();
  layer<F1, BF16, false>(x0, C, c_pad, w1, b1, h1, K);
  __syncthreads();
  layer<F2, BF16, false>(h1, F1, F1, w2, b2, h2, K);
  __syncthreads();
  float* red = x0;  // (kThreads / F3, F3) group maxima; x0 is free now
  layer<F3, BF16, true>(h2, F2, F2, w3, b3, red, K);
  __syncthreads();
  constexpr int kGroups = kThreads / F3;
  for (int c = threadIdx.x; c < F3; c += kThreads) {
    float m = red[c];
#pragma unroll
    for (int gi = 1; gi < kGroups; ++gi) m = fmaxf(m, red[gi * F3 + c]);
    out[center * F3 + c] = m;
  }
}

template <int F1, int F2, int F3, typename TIn, bool BF16>
int launch(const void* g, int HS, int K, int C, const float* w1,
           const float* b1, const float* w2, const float* b2, const float* w3,
           const float* b3, float* out, cudaStream_t stream) {
  const int c_pad = (C + 3) / 4 * 4;
  // the group maxima reuse x0, which must hold them
  if (kRows * c_pad < kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * kRows * (c_pad + F1 + F2);
  auto kernel = sa_mlp_max_kernel<F1, F2, F3, TIn, BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<HS, kThreads, smem, stream>>>(static_cast<const TIn*>(g), K, C,
                                          c_pad, w1, b1, w2, b2, w3, b3, out);
  return static_cast<int>(cudaGetLastError());
}

template <int F1, int F2, int F3>
int dispatch(const void* g, int g_bf16, int bf16, int HS, int K, int C,
             const float* w1, const float* b1, const float* w2,
             const float* b2, const float* w3, const float* b3, float* out,
             cudaStream_t stream) {
  if (g_bf16 && bf16) {
    return launch<F1, F2, F3, __nv_bfloat16, true>(g, HS, K, C, w1, b1, w2, b2,
                                                   w3, b3, out, stream);
  }
  if (g_bf16) return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? launch<F1, F2, F3, float, true>(g, HS, K, C, w1, b1, w2, b2,
                                                w3, b3, out, stream)
              : launch<F1, F2, F3, float, false>(g, HS, K, C, w1, b1, w2, b2,
                                                 w3, b3, out, stream);
}

}  // namespace

// grouped (HS, K, C) of float32 (g_bf16 == 0) or bfloat16 (g_bf16 == 1);
// compute dtype bfloat16 when bf16 == 1 (a bf16 input needs bf16 compute);
// weights w_l (C_in, F_l) float32 already rounded to the compute dtype,
// biases float32; out (HS, F3) float32.  Widths (F1, F2, F3) must be
// (64, 64, 128) or (128, 128, 256); 1 <= K <= 64.
extern "C" int sa_mlp_max(const void* g, int g_bf16, int bf16, int HS, int K,
                          int C, int F1, int F2, int F3, const void* w1,
                          const void* b1, const void* w2, const void* b2,
                          const void* w3, const void* b3, void* out,
                          void* stream) {
  if (HS < 1 || K < 1 || K > kRows || C < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* fw1 = static_cast<const float*>(w1);
  const auto* fb1 = static_cast<const float*>(b1);
  const auto* fw2 = static_cast<const float*>(w2);
  const auto* fb2 = static_cast<const float*>(b2);
  const auto* fw3 = static_cast<const float*>(w3);
  const auto* fb3 = static_cast<const float*>(b3);
  auto* fout = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (F1 == 64 && F2 == 64 && F3 == 128) {
    return dispatch<64, 64, 128>(g, g_bf16, bf16, HS, K, C, fw1, fb1, fw2,
                                 fb2, fw3, fb3, fout, st);
  }
  if (F1 == 128 && F2 == 128 && F3 == 256) {
    return dispatch<128, 128, 256>(g, g_bf16, bf16, HS, K, C, fw1, fb1, fw2,
                                   fb2, fw3, fb3, fout, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
