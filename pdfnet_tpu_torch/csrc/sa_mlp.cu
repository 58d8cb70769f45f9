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
// float32 compute (sa_mlp_f32_kernel, both levels of the float32 eval
// path): float32 FMAs on the CUDA cores, in true float32 (a float32
// product on the tensor cores would be TF32).  Its bound is the FP32 rate:
// 13.1 / 17.3 GFLOP a call at batch 8, 0.195 / 0.258 ms at 67 TFLOP/s.
// Persistent blocks of 256 threads, one an SM, each walking units of 128
// rows (two centers' 64, or a chunk of a center's k > 64) with the hidden
// layers in shared memory; each of 16 x 16 threads holds an outer product
// of its 8 rows (rg + 16 i) by 4 or 8 columns, A and B read as float4, so
// that each loaded value feeds 4 to 8 FMAs.  Level 1 stages its weights in
// shared memory once (50 KB).  Level 2 stages w2 (64 KB) and streams w1
// and w3 in depth chunks of 16 through a 2-stage cp.async ring: staging
// w1 and w2 (133 KB) leaves room for units of 64 rows only, whose 4 x 8
// outer products ran at ~38 % of the FP32 rate.  A unit's rows are copied
// by cp.async while the previous unit's last two layers run.  The max over
// k runs in registers (across a center's chunks where k > 64), then across
// the row groups by a shuffle and shared memory.
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

namespace f32 {

constexpr int kGroups = 16;          // row groups (and column groups)
constexpr int kRM = 8;               // rows a thread: rg + 16 i
constexpr int kM = kGroups * kRM;    // rows a unit
constexpr int kNS = kM / kRows;      // centers a unit where k <= 64
constexpr int kKC = 16;              // depth of a streamed weight chunk
constexpr int kStages = 2;           // chunks in the ring
constexpr int kRing = kStages * kKC * 128;
constexpr int kWarps = kThreads / 32;

// Level 2's widths (F3 > 128) stream w1 and w3 through the ring and stage
// w2; level 1's stage all three.  The input's depth is padded to 16 for
// the streamed w1, to 4 otherwise.
template <int F3>
__host__ __device__ __forceinline__ int c_pad_of(int C) {
  return F3 > 128 ? (C + 15) / 16 * 16 : (C + 3) / 4 * 4;
}

// Shared memory (floats).  Mirrored by ops/sa.mlp_f32_smem_bytes.
template <int F1, int F2, int F3>
__host__ __device__ __forceinline__ int smem_floats(int C) {
  const int cp = c_pad_of<F3>(C);
  if (F3 > 128) {    // w2, the ring, x rows, one hidden layer at a time
    return F1 * F2 + kRing + kM * (cp + 4) + kM * ((F1 > F2 ? F1 : F2) + 4);
  }
  return cp * F1 + F1 * F2 + F2 * F3 + kM * cp + kM * (F1 + 4) +
         kM * (F2 + 4) + kWarps * kNS * F3;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   mma::smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a,
                                     const float4& b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// acc[i][h] += A's row rg + 16 i @ B's columns 64 h + 0..3 over k < K
// (K % 4 == 0), A (stride lda) and B (stride ldb, already at the thread's
// first column) in shared memory, read as float4.
template <int NH>
__device__ __forceinline__ void product(float (&acc)[kRM][NH][4],
                                        const float* A, int lda,
                                        const float* B, int ldb, int K) {
  const int rg = threadIdx.x / kGroups;
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 bv[4][NH];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        bv[t][h] = *reinterpret_cast<const float4*>(B + (k + t) * ldb +
                                                    64 * h);
      }
    }
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const float4 av = *reinterpret_cast<const float4*>(
          A + (rg + kGroups * i) * lda + k);
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        fma4(acc[i][h], av.x, bv[0][h]);
        fma4(acc[i][h], av.y, bv[1][h]);
        fma4(acc[i][h], av.z, bv[2][h]);
        fma4(acc[i][h], av.w, bv[3][h]);
      }
    }
  }
}

// The same with B = w[:, n0 : n0 + 128] streamed from device memory in
// depth chunks of kKC through the ring, rows past k_valid zero; K % kKC ==
// 0.  The ring is free again when it returns.
__device__ __forceinline__ void product_streamed(
    float (&acc)[kRM][2][4], const float* A, int lda,
    const float* __restrict__ w, int ldw, int n0, int K, int k_valid,
    float* ring) {
  auto stage = [&](int kc) {
    float* dst = ring + (kc % kStages) * kKC * 128;
    for (int e = threadIdx.x; e < kKC * 32; e += kThreads) {
      const int row = kc * kKC + e / 32;
      const bool ok = row < k_valid;
      mma::cp_async16(dst + (e / 32) * 128 + (e % 32) * 4,
                      ok ? w + static_cast<int64_t>(row) * ldw + n0 +
                               (e % 32) * 4
                         : w,
                      ok ? 16 : 0);
    }
  };
  const int c4 = (threadIdx.x % kGroups) * 4;
  stage(0);
  mma::cp_async_commit();
  for (int kc = 0; kc < K / kKC; ++kc) {
    mma::cp_async_wait<0>();
    __syncthreads();   // chunk kc in place; chunk kc - 1's buffer free
    if (kc + 1 < K / kKC) stage(kc + 1);
    mma::cp_async_commit();
    product<2>(acc, A + kc * kKC, lda,
               ring + (kc % kStages) * kKC * 128 + c4, 128, kKC);
  }
  __syncthreads();
}

template <int NH>
__device__ __forceinline__ void zero(float (&acc)[kRM][NH][4]) {
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
#pragma unroll
    for (int h = 0; h < NH; ++h) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][h][q] = 0.0f;
    }
  }
}

// H[row][n] = relu(acc + b[n]) for the thread's rows and columns (4 cg +
// 64 h + q), as float4.
template <int NH>
__device__ __forceinline__ void store_relu(const float (&acc)[kRM][NH][4],
                                           float* H, int ldh,
                                           const float* __restrict__ b) {
  const int rg = threadIdx.x / kGroups, c = (threadIdx.x % kGroups) * 4;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    const float4 bv = make_float4(b[c + 64 * h], b[c + 64 * h + 1],
                                  b[c + 64 * h + 2], b[c + 64 * h + 3]);
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      *reinterpret_cast<float4*>(H + (rg + kGroups * i) * ldh + c + 64 * h) =
          make_float4(fmaxf(acc[i][h][0] + bv.x, 0.0f),
                      fmaxf(acc[i][h][1] + bv.y, 0.0f),
                      fmaxf(acc[i][h][2] + bv.z, 0.0f),
                      fmaxf(acc[i][h][3] + bv.w, 0.0f));
    }
  }
}

// Persistent blocks that walk units of kM rows: two centers of k <= 64
// rows (a slot of 64 rows each), or one chunk of kM of a center's k > 64
// rows.  A thread holds an 8 x 4 (64-column layers) or 8 x 8 (128-column
// passes) outer product.  A unit's rows are copied by cp.async as soon as
// the previous unit's first layer has read its own, so the copy runs under
// the other two layers.  The max over k runs in registers across a
// center's chunks, then across the row groups by a shuffle and shared
// memory.
template <int F1, int F2, int F3>
__global__ void __launch_bounds__(kThreads, 1)
sa_mlp_f32_kernel(const float* __restrict__ g, int HS, int K, int C,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  const float* __restrict__ w3, const float* __restrict__ b3,
                  float* __restrict__ out) {
  constexpr bool kStream = F3 > 128;
  constexpr int kNH1 = F1 / 64, kNH2 = F2 / 64;     // 4-column runs a thread
  constexpr int kP3 = F3 / 128;                     // 128-column passes
  static_assert(!kStream || (F1 == 128 && F2 == 128), "streamed widths");
  extern __shared__ float4 smem4[];
  const int cp = c_pad_of<F3>(C);
  const int ldx = kStream ? cp + 4 : cp;
  float* sw = reinterpret_cast<float*>(smem4);
  float* sw1 = sw;                                  // (cp, F1), level 1
  float* sw2 = kStream ? sw : sw1 + cp * F1;        // (F1, F2)
  float* sw3 = sw2 + F1 * F2;                       // (F2, F3), or the ring
  float* sx = sw3 + (kStream ? kRing : F2 * F3);    // (kM, ldx)
  float* sh1 = sx + kM * ldx;                       // (kM, F1 + 4)
  // level 2: H2 and then the maxima over H1, one hidden layer at a time
  float* sh2 = kStream ? sh1 : sh1 + kM * (F1 + 4);
  float* red = kStream ? sh1 : sh2 + kM * (F2 + 4); // (kWarps, kNS, F3)

  // the staged weights, once: w1's rows past C zero
  for (int e = threadIdx.x; !kStream && e < cp * F1 / 4; e += kThreads) {
    reinterpret_cast<float4*>(sw1)[e] =
        e / (F1 / 4) < C ? reinterpret_cast<const float4*>(w1)[e]
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (int e = threadIdx.x; e < F1 * F2 / 4; e += kThreads) {
    reinterpret_cast<float4*>(sw2)[e] = reinterpret_cast<const float4*>(w2)[e];
  }
  for (int e = threadIdx.x; !kStream && e < F2 * F3 / 4; e += kThreads) {
    reinterpret_cast<float4*>(sw3)[e] = reinterpret_cast<const float4*>(w3)[e];
  }

  const int sl = K <= kRows ? kRows : kM;           // rows a slot
  const int ns = K <= kRows ? kNS : 1;              // centers a unit
  const int nch = (K + sl - 1) / sl;
  const int ngroups = (HS + ns - 1) / ns;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // cp.async of a unit's (kM, cp) rows into sx, zero past C, k and HS
  auto copy_rows = [&](int grp, int ch) {
    auto src = [&](int r, bool& ok) -> const float* {
      const int s = r / sl, row = ch * sl + r % sl;
      const int64_t center = static_cast<int64_t>(grp) * ns + s;
      ok = s < ns && center < HS && row < K;
      return ok ? g + (center * K + row) * C : g;
    };
    if (cp >= 32) {            // a warp a row, its lanes over the channels
      for (int r = warp; r < kM; r += kWarps) {
        bool ok;
        const float* row = src(r, ok);
        for (int c = lane; c < cp; c += 32) {
          const bool in = ok && c < C;
          cp_async4(sx + r * ldx + c, in ? row + c : g, in ? 4 : 0);
        }
      }
    } else {
      for (int e = threadIdx.x; e < kM * cp; e += kThreads) {
        const int r = e / cp, c = e % cp;
        bool ok;
        const float* row = src(r, ok);
        const bool in = ok && c < C;
        cp_async4(sx + r * ldx + c, in ? row + c : g, in ? 4 : 0);
      }
    }
    mma::cp_async_commit();
  };

  const int rg = threadIdx.x / kGroups, c4 = (threadIdx.x % kGroups) * 4;
  float run[kP3][kNS][8];
  auto reset = [&] {
#pragma unroll
    for (int p = 0; p < kP3; ++p) {
#pragma unroll
      for (int s = 0; s < kNS; ++s) {
#pragma unroll
        for (int j = 0; j < 8; ++j) run[p][s][j] = -CUDART_INF_F;
      }
    }
  };
  reset();

  int grp = blockIdx.x, ch = 0;
  if (grp < ngroups) copy_rows(grp, ch);
  while (grp < ngroups) {
    const bool last = ch + 1 == nch;
    const int next_grp = last ? grp + gridDim.x : grp;
    const int next_ch = last ? 0 : ch + 1;
    mma::cp_async_wait<0>();
    __syncthreads();        // the rows (and, first, the weights) in place

    {   // H1 = relu(X @ w1 + b1)
      float acc[kRM][kNH1][4];
      zero(acc);
      if constexpr (kStream) {
        product_streamed(acc, sx, ldx, w1, F1, 0, cp, C, sw3);
      } else {
        product<kNH1>(acc, sx, ldx, sw1 + c4, F1, cp);
        __syncthreads();
      }
      // every thread is done with the rows: the next unit's copy runs
      // under the next two layers
      if (next_grp < ngroups) copy_rows(next_grp, next_ch);
      store_relu<kNH1>(acc, sh1, F1 + 4, b1);
    }
    __syncthreads();
    {   // H2 = relu(H1 @ w2 + b2)
      float acc[kRM][kNH2][4];
      zero(acc);
      product<kNH2>(acc, sh1, F1 + 4, sw2 + c4, F2, F1);
      if (kStream) __syncthreads();     // H2 goes over H1
      store_relu<kNH2>(acc, sh2, F2 + 4, b2);
    }
    __syncthreads();

    // layer 3 and the max over the unit's valid rows of each slot
    const int64_t c0 = static_cast<int64_t>(grp) * ns;
    const int nv0 = c0 < HS ? min(sl, K - ch * sl) : 0;
    const int nv1 = ns > 1 && c0 + 1 < HS ? min(sl, K - ch * sl) : 0;
#pragma unroll
    for (int p = 0; p < kP3; ++p) {
      float acc[kRM][2][4];
      zero(acc);
      if constexpr (kStream) {
        product_streamed(acc, sh2, F2 + 4, w3, F3, 128 * p, F2, F2, sw3);
      } else {
        product<2>(acc, sh2, F2 + 4, sw3 + 128 * p + c4, F3, F2);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float bv = b3[128 * p + c4 + 64 * h + q];
#pragma unroll
          for (int i = 0; i < kRM; ++i) {
            const int r = rg + kGroups * i;
            const bool second = ns > 1 && i >= kRM / 2;   // slot 1's rows
            const int rs = second ? r - kRows : r;
            if (rs >= (second ? nv1 : nv0)) continue;
            const float v = fmaxf(acc[i][h][q] + bv, 0.0f);
            if (second) {
              run[p][1][4 * h + q] = fmaxf(run[p][1][4 * h + q], v);
            } else {
              run[p][0][4 * h + q] = fmaxf(run[p][0][4 * h + q], v);
            }
          }
        }
      }
    }

    if (last) {   // the unit's centers are done: the max over row groups
      // (level 2's maxima go over H2, read by the last product, which ends
      // on a barrier)
#pragma unroll
      for (int p = 0; p < kP3; ++p) {
#pragma unroll
        for (int s = 0; s < kNS; ++s) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float v = run[p][s][j];
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
            if (lane < 16) {
              red[(warp * kNS + s) * F3 + 128 * p + c4 + 64 * (j / 4) +
                  j % 4] = v;
            }
          }
        }
      }
      reset();
      __syncthreads();
      for (int e = threadIdx.x; e < ns * F3; e += kThreads) {
        const int s = e / F3, col = e % F3;
        if (c0 + s >= HS) continue;
        float m = red[s * F3 + col];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) {
          m = fmaxf(m, red[(w * kNS + s) * F3 + col]);
        }
        out[(c0 + s) * F3 + col] = m;
      }
    }
    grp = next_grp;
    ch = next_ch;
  }
}

}  // namespace f32

template <int F1, int F2, int F3>
int launch_f32(const void* g, int HS, int K, int C, const void* const* p,
               float* out, cudaStream_t stream) {
  const size_t smem = sizeof(float) * f32::smem_floats<F1, F2, F3>(C);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 6; i += 2) {
    if (reinterpret_cast<uintptr_t>(p[i]) % 16 != 0) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
  }
  auto kernel = f32::sa_mlp_f32_kernel<F1, F2, F3>;
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
  const int ns = K <= kRows ? f32::kNS : 1;
  const int64_t groups = (static_cast<int64_t>(HS) + ns - 1) / ns;
  const int64_t slots = static_cast<int64_t>(sms) * per_sm;
  const int grid = static_cast<int>(groups < slots ? groups : slots);
  auto f = [&](int i) { return static_cast<const float*>(p[i]); };
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const float*>(g), HS,
                                           K, C, f(0), f(1), f(2), f(3),
                                           f(4), f(5), out);
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
