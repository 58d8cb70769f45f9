// One whole eval-mode ResNet bottleneck block for Hopper (sm_90a):
//
//   out = relu(round(conv1x1_3(y2) + b3) + sc)
//   y2  = round(relu(conv3x3_2(y1) + b2))      (stride 1 or 2, zero padding)
//   y1  = round(relu(conv1x1_1(x) + b1))
//   sc  = x, or round(conv1x1_p(x at the stride) + bp)
//
// with BatchNorm folded into the weights and biases, every product in the
// compute dtype (the type T of the map: float or bfloat16) with a float32
// accumulator, and round() to T.
//
// Replaces the TPU kernels _block_kernel_s1 and _block_kernel_s2
// (pdfnet_tpu/ops/pallas_trunk.py:148 and :198, launched by fused_bottleneck
// :267).  As there, the map is read from device memory once and written
// once; y1 and y2 never leave the chip.  The stride-2 body computes the
// strided 3x3 at the even rows and columns directly (the TPU kernel computes
// it at full resolution and subsamples: the same sums).
//
// Three bodies share this file.
//
// bf16 at stride 1 (bottleneck_tc_kernel, the serving path's 8 blocks a
// step): the products on the tensor cores.  One block of 8 warps per (image,
// tile of TR whole output rows); TR comes from the caller
// (ops/trunk.rows_per_block), which fills the 132 SMs at the main shapes:
// TR = 3 at layer2 (48x48, 128 blocks at batch 8; conv1 on 5 input rows per
// 3 output rows, +16 % operations) and TR = 2 at layer3 (24x24, 96 blocks;
// 4 per 2, +24 %).  y1 (the TR+2 halo'd input rows, a zero column on each
// side, zero rows outside the map) and y2 live in shared memory as bf16, the
// values they are rounded to anyway, each pixel's channels padded by 8 so
// that ldmatrix's eight 16-byte rows fall in distinct banks.  Each product
// is a pass of 48 rows x 64*NI columns: the 8 warps split the columns, each
// warp holds 3 x NI m16n8 float32 accumulators and runs
// mma.sync.m16n8k16 (bf16 in, float32 accumulate), A fragments by ldmatrix
// from row addresses (x rows staged by cp.async for conv1, y1 read in place
// at the 3x3's shifted taps, y2 in place), B fragments by ldmatrix.trans
// from weight chunks of depth 64 staged as bf16 by cp.async, double
// buffered, so that the next chunk loads while one multiplies.  48
// rows divide every pass at the main shapes (240/144 rows at layer2, 96/48
// at layer3).  mma.sync and not wgmma: A rows are gathered per lane (the
// 3x3 taps, the halo), which ldmatrix takes as it is and wgmma's
// shared-memory descriptors do not; this keeps one simple tile for all
// three products.  Takes Cin % 64 == 0, Cw % 128 == 0, no projection (every
// stride-1 block the trunk routes); ops/trunk.check_tc_shape refuses the
// rest by name.
//
// float32 at stride 1 (bottleneck_f32_kernel, the float32 serving path's 8
// blocks a step): float32 FMAs on the CUDA cores, in true float32 (a
// float32 product on the tensor cores would be TF32, and 3xTF32 splits
// another rounding).  Its bound is the FP32 rate: ~10.3 GFLOP a call at
// layer2_1 and layer3_1 at batch 8, 0.153 ms at 67 TFLOP/s, far above the
// map's bytes.  The design against that bound:
//   - Tiles sized to fill the 132 SMs in one wave (ops/trunk.f32_plan, the
//     caller's choice): TR output rows by TW columns, y1 (the halo'd input
//     rows and columns, zero outside the map) and y2 in shared memory as
//     float32, one block of 256 threads an SM.  At layer3 a tile's work is
//     spread over a 2-block thread-block cluster: each block computes half
//     of y1's and y2's channels and half of the output's, and takes the
//     peer's half of y1 and of y2 from its shared memory (distributed
//     shared memory) in one copy after each product, so no halo row is
//     computed twice and the tile needs no more than one SM's shared
//     memory.  ResNet-50 at 384x384, batch 8: layer2 TR = 3, full width
//     (128 blocks; conv1 on 5 input rows per 3, +16 % operations); layer3
//     TR = 3 in clusters of 2 (128 blocks; +16 %).  The fallback of
//     narrower tiles with their halo columns recomputed costs more
//     (f32_plan's count: TR = 2 x TW = 12 at layer3, 192 blocks and +31 %
//     operations) and is what f32_plan takes where clusters do not divide
//     the channels.
//   - Each product is a pass of 16 * RM rows x 128 columns: 16 row groups x
//     16 column groups of threads, each thread an RM x 8 outer product (rows
//     rg + 16 i, columns two runs of 4, 64 apart, so that a quarter warp's
//     float4 reads of a weight row touch 32 distinct banks), A and B read
//     as float4.  RM is sized to the product's real row count (f32::rm_of:
//     240 conv1 rows as 2 x 8, 144 3x3 rows as 9; 120 as 8, 72 as 5), so
//     that no pass runs a quarter or half empty; at most 9, which measured
//     a little faster than 12 (fewer registers).  Warps of 8 x 4 thread
//     groups (fewer shared-memory wavefronts) and register double-buffered
//     fragments measured slower.
//   - Weight chunks (depth 16, 128 columns) and, for conv1, the x rows are
//     staged by 16-byte cp.async into a 2-stage ring: the next chunk loads
//     while one multiplies.  The 3x3 reads y1 in place at its shifted taps,
//     conv3 reads y2 in place; each pixel's channels are padded by 4 floats
//     so that neighbouring rows fall in other banks.
//   - Takes Cin and Cw multiples of 128 and no projection (every stride-1
//     block the trunk routes); ops/trunk.check_f32_shape refuses the rest
//     by name.
//
// float32 and bf16 at stride 2 (bottleneck_kernel, the first body, routed
// by neither package): float32 FMAs on the CUDA cores, y1/y2 as float32 in
// shared memory, 64 x 128 tiles, each thread 4 rows x 8 columns, depth
// staged 32 at a time.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700 W): at the main path's
// shapes (layer2/3 stride 1, batch 8) ~10.3 GFLOP a block at the bf16
// tensor-core rate (~0.010 ms) against 19-38 MB of map read and written
// (~0.006-0.011 ms): operations, by a little.  The tensor-core body
// measured 0.12-0.13 ms a call at layer2_1 and at layer3_1 (chip_smoke.py,
// CUDA-graph replay, NVIDIA H100 80GB HBM3 at 700 W), against 0.11 / 0.07
// ms for cuDNN's three convolutions on the same folded weights.  What holds it
// there: each block streams every weight chunk from L2 once per 48-row
// pass, 1.9 MB (layer2) and 2.7 MB (layer3) a block, ~250 MB a call.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "mma_util.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRM = 4;              // rows per thread
constexpr int kMT = 64;             // rows per pass: 16 row groups x kRM
constexpr int kNT = 128;            // columns per pass: 16 column groups x 8
constexpr int kKC = 32;             // depth of one staged chunk
constexpr int kAStride = kKC + 4;   // padded row of a staged x chunk
constexpr size_t kMaxSmem = 232448;  // 227 KB per block on the H100

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
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// The 8 columns of a thread within a pass: two runs of 4, 64 apart, so a
// quarter warp's float4 reads of a staged weight row touch 32 distinct banks.
__device__ __forceinline__ int col_of(int cg, int j) {
  return (j < 4 ? 0 : 64) + cg * 4 + (j & 3);
}

// bs[kk][nn] = w[k0 + kk][n0 + nn] (zero past column N), w row-major (., ldw).
template <typename T>
__device__ __forceinline__ void stage_w(float* bs, const T* __restrict__ w,
                                        int ldw, int k0, int n0, int N) {
  for (int e = threadIdx.x; e < kKC * kNT; e += kThreads) {
    const int kk = e / kNT, n = n0 + e % kNT;
    bs[e] = n < N ? to_f32(w[static_cast<int64_t>(k0 + kk) * ldw + n]) : 0.0f;
  }
}

// as[r][kk] = x[pix(m0 + r) + k0 + kk], zero where pix < 0 or the row >= M.
template <typename T, typename Pix>
__device__ __forceinline__ void stage_x(float* as, const T* __restrict__ x,
                                        int k0, int m0, int M, Pix pix) {
  for (int e = threadIdx.x; e < kMT * kKC; e += kThreads) {
    const int r = e / kKC, kk = e % kKC;
    const int64_t p = m0 + r < M ? pix(m0 + r) : -1;
    as[r * kAStride + kk] = p >= 0 ? to_f32(x[p + k0 + kk]) : 0.0f;
  }
}

// acc[i][j] += sum over kk < kKC of a[i][kk] * bs[kk][col_of(cg, j)]; each
// a[i] points at kKC contiguous, 16-byte aligned floats in shared memory.
__device__ __forceinline__ void fma_chunk(float (&acc)[kRM][8],
                                          const float* const* a,
                                          const float* bs, int cg) {
#pragma unroll 2
  for (int kk = 0; kk < kKC; kk += 4) {
    float4 av[kRM];
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      av[i] = *reinterpret_cast<const float4*>(a[i] + kk);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float* brow = bs + (kk + t) * kNT + cg * 4;
      const float4 b0 = *reinterpret_cast<const float4*>(brow);
      const float4 b1 = *reinterpret_cast<const float4*>(brow + 64);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const float ai =
            t == 0 ? av[i].x : (t == 1 ? av[i].y : (t == 2 ? av[i].z : av[i].w));
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ai, bv[j], acc[i][j]);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[kRM][8]) {
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
}

struct Shape {
  int H, W, Cin, Cw, Cout, Ho, Wo, TR;
};

// Rows of the y1 tile: the halo'd input rows of TR output rows.
__host__ __device__ __forceinline__ int y1_rows(int TR, int stride) {
  return stride == 1 ? TR + 2 : 2 * TR + 1;
}

__host__ __forceinline__ size_t smem_bytes(const Shape& s, int stride) {
  return sizeof(float) *
         (static_cast<size_t>(y1_rows(s.TR, stride)) * (s.W + 2) * s.Cw +
          static_cast<size_t>(s.TR) * s.Wo * s.Cw + kMT * kAStride +
          kKC * kNT);
}

template <typename T, int kStride, bool kProject>
__global__ void __launch_bounds__(kThreads)
bottleneck_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                  const float* __restrict__ b1, const T* __restrict__ w2,
                  const float* __restrict__ b2, const T* __restrict__ w3,
                  const float* __restrict__ b3, const T* __restrict__ wp,
                  const float* __restrict__ bp, T* __restrict__ out, Shape s) {
  extern __shared__ float4 smem4[];
  const int R1 = y1_rows(s.TR, kStride), Wp = s.W + 2;
  float* y1 = reinterpret_cast<float*>(smem4);    // (R1, W + 2, Cw)
  float* y2 = y1 + R1 * Wp * s.Cw;                // (TR * Wo, Cw)
  float* as = y2 + s.TR * s.Wo * s.Cw;            // (kMT, kAStride)
  float* bs = as + kMT * kAStride;                // (kKC, kNT)

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * s.TR;               // first output row
  const int g0 = r0 * kStride - 1;                // input row of y1 row 0
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  const T* xb = x + static_cast<int64_t>(b) * s.H * s.W * s.Cin;

  for (int e = threadIdx.x; e < R1 * Wp * s.Cw; e += kThreads) y1[e] = 0.0f;

  // ---- y1 = relu(x @ w1 + b1) on the halo'd rows inside the map
  const int M1 = R1 * s.W;
  auto pix1 = [&](int m) -> int64_t {
    const int g = g0 + m / s.W;
    return g >= 0 && g < s.H
               ? (static_cast<int64_t>(g) * s.W + m % s.W) * s.Cin
               : -1;
  };
  float acc[kRM][8];
  const float* a[kRM];
  for (int m0 = 0; m0 < M1; m0 += kMT) {
    for (int n0 = 0; n0 < s.Cw; n0 += kNT) {
      zero(acc);
      for (int k0 = 0; k0 < s.Cin; k0 += kKC) {
        __syncthreads();
        stage_x(as, xb, k0, m0, M1, pix1);
        stage_w(bs, w1, s.Cw, k0, n0, s.Cw);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kRM; ++i) a[i] = as + (rg * kRM + i) * kAStride;
        fma_chunk(acc, a, bs, cg);
      }
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const int m = m0 + rg * kRM + i;
        if (m >= M1 || pix1(m) < 0) continue;
        float* dst = y1 + ((m / s.W) * Wp + m % s.W + 1) * s.Cw;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = n0 + col_of(cg, j);
          if (n < s.Cw) dst[n] = round_to<T>(fmaxf(acc[i][j] + b1[n], 0.0f));
        }
      }
    }
  }

  // ---- y2 = relu(conv3x3(y1) + b2) at the tile's output pixels
  const int rows = min(s.TR, s.Ho - r0);
  const int M2 = rows * s.Wo;
  for (int m0 = 0; m0 < M2; m0 += kMT) {
    for (int n0 = 0; n0 < s.Cw; n0 += kNT) {
      zero(acc);
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        for (int c0 = 0; c0 < s.Cw; c0 += kKC) {
          __syncthreads();
          stage_w(bs, w2 + static_cast<int64_t>(tap) * s.Cw * s.Cw, s.Cw, c0,
                  n0, s.Cw);
          __syncthreads();
#pragma unroll
          for (int i = 0; i < kRM; ++i) {
            const int m = min(m0 + rg * kRM + i, M2 - 1);
            const int oi = m / s.Wo, oj = m % s.Wo;
            a[i] = y1 + ((oi * kStride + dy) * Wp + oj * kStride + dx) * s.Cw +
                   c0;
          }
          fma_chunk(acc, a, bs, cg);
        }
      }
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const int m = m0 + rg * kRM + i;
        if (m >= M2) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = n0 + col_of(cg, j);
          if (n < s.Cw) {
            y2[m * s.Cw + n] = round_to<T>(fmaxf(acc[i][j] + b2[n], 0.0f));
          }
        }
      }
    }
  }

  // ---- out = relu(round(y2 @ w3 + b3) + shortcut)
  auto pix_sc = [&](int m) -> int64_t {
    return (static_cast<int64_t>((r0 + m / s.Wo) * kStride) * s.W +
            (m % s.Wo) * kStride) * s.Cin;
  };
  T* ob = out + (static_cast<int64_t>(b) * s.Ho + r0) * s.Wo * s.Cout;
  float accp[kRM][8];
  for (int m0 = 0; m0 < M2; m0 += kMT) {
    for (int n0 = 0; n0 < s.Cout; n0 += kNT) {
      zero(acc);
      for (int c0 = 0; c0 < s.Cw; c0 += kKC) {
        __syncthreads();
        stage_w(bs, w3, s.Cout, c0, n0, s.Cout);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kRM; ++i) {
          a[i] = y2 + min(m0 + rg * kRM + i, M2 - 1) * s.Cw + c0;
        }
        fma_chunk(acc, a, bs, cg);
      }
      if (kProject) {
        zero(accp);
        for (int k0 = 0; k0 < s.Cin; k0 += kKC) {
          __syncthreads();
          stage_x(as, xb, k0, m0, M2, pix_sc);
          stage_w(bs, wp, s.Cout, k0, n0, s.Cout);
          __syncthreads();
#pragma unroll
          for (int i = 0; i < kRM; ++i) a[i] = as + (rg * kRM + i) * kAStride;
          fma_chunk(accp, a, bs, cg);
        }
      }
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const int m = m0 + rg * kRM + i;
        if (m >= M2) continue;
        const T* xr = xb + pix_sc(m);
        T* o = ob + static_cast<int64_t>(m) * s.Cout;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = n0 + col_of(cg, j);
          if (n >= s.Cout) continue;
          const float y3 = round_to<T>(acc[i][j] + b3[n]);
          const float sc =
              kProject ? round_to<T>(accp[i][j] + bp[n]) : to_f32(xr[n]);
          o[n] = from_f32<T>(fmaxf(y3 + sc, 0.0f));
        }
      }
    }
  }
}

template <typename T, int kStride, bool kProject>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* w3, const void* b3, const void* wp,
           const void* bp, void* out, int B, Shape s, cudaStream_t stream) {
  auto kernel = bottleneck_kernel<T, kStride, kProject>;
  const size_t smem = smem_bytes(s, kStride);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((s.Ho + s.TR - 1) / s.TR, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<const T*>(w3),
      static_cast<const float*>(b3), static_cast<const T*>(wp),
      static_cast<const float*>(bp), static_cast<T*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16, stride 1: the tensor-core body --------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;               // 8 warps split a pass's columns
constexpr int kMI = 3;                      // m16 tiles per pass
constexpr int kMT = 16 * kMI;               // rows per pass
constexpr int kKC = 64;                     // depth of one staged chunk
constexpr int kStages = 2;                  // chunks in the ring
constexpr int kAStride = kKC + 8;           // staged x row (elements)
constexpr int kAStage = kMT * kAStride;     // one staged x chunk
constexpr int kNIMax = 4;                   // n8 tiles per warp, at most
constexpr int kBStage = kKC * (64 * kNIMax + 8);  // one staged weight chunk

// Mirrored by ops/trunk.tc_smem_bytes.
__host__ __forceinline__ size_t smem_bytes(int TR, int W, int Cw) {
  return sizeof(bf16) *
         (static_cast<size_t>(TR + 2) * (W + 2) * (Cw + 8) +
          static_cast<size_t>(TR) * W * (Cw + 8) +
          kStages * (kAStage + kBStage));
}

// acc = A (kMT rows) @ w[:, n0 : n0 + 64 * NI], w row-major (nk * kKC, ldw).
// stage_a(kc) issues the cp.async copies of A's chunk kc (or nothing);
// row_a(i, kc, kk) is the lane's ldmatrix address of m16 tile i at depth
// kk of chunk kc.  Weight chunks go through bs, a ring of kStages buffers
// with kStages - 1 chunks in flight while one multiplies (2 stages of depth
// 64 measured faster than 4 of depth 32).
template <int NI, typename StageA, typename RowA>
__device__ __forceinline__ void gemm_pass(float (&acc)[kMI][NI][4],
                                          const bf16* __restrict__ w, int ldw,
                                          int n0, int nk, bf16* bs,
                                          StageA stage_a, RowA row_a) {
  static_assert(NI % 2 == 0 && NI <= kNIMax, "NI pairs of n8 tiles");
  constexpr int kBS = 64 * NI + 8;          // staged weight row
  constexpr int kRowVecs = 8 * NI;          // 16-byte vectors per row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kMI; ++i) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;
    }
  }
  auto stage_b = [&](int kc) {
    bf16* dst = bs + (kc % kStages) * kBStage;
    const bf16* src = w + static_cast<int64_t>(kc) * kKC * ldw + n0;
    for (int e = threadIdx.x; e < kKC * kRowVecs; e += kThreads) {
      const int r = e / kRowVecs, v = e % kRowVecs;
      mma::cp_async16(dst + r * kBS + v * 8,
                      src + static_cast<int64_t>(r) * ldw + v * 8, 16);
    }
  };
  for (int kc = 0; kc < kStages - 1; ++kc) {
    if (kc < nk) {
      stage_b(kc);
      stage_a(kc);
    }
    mma::cp_async_commit();
  }
  const int b_off = mma::b_lane_offset(lane, kBS) + warp * NI * 8;
  for (int kc = 0; kc < nk; ++kc) {
    mma::cp_async_wait<kStages - 2>();
    // chunk kc is in place for every thread, and every thread is done with
    // chunk kc - 1, whose buffer the next copy fills
    __syncthreads();
    if (kc + kStages - 1 < nk) {
      stage_b(kc + kStages - 1);
      stage_a(kc + kStages - 1);
    }
    mma::cp_async_commit();
    const bf16* b = bs + (kc % kStages) * kBStage + b_off;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      uint32_t a[kMI][4];
#pragma unroll
      for (int i = 0; i < kMI; ++i) mma::ldmatrix_x4(a[i], row_a(i, kc, kk));
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        uint32_t bf[4];
        mma::ldmatrix_x4_trans(bf, b + kk * kBS + j * 8);
#pragma unroll
        for (int i = 0; i < kMI; ++i) {
          mma::mma_bf16(acc[i][j], a[i], bf[0], bf[1]);
          mma::mma_bf16(acc[i][j + 1], a[i], bf[2], bf[3]);
        }
      }
    }
  }
  __syncthreads();  // the ring is free for the next pass
}

// Calls f(m, n, v0, v1) for the two neighbouring columns (n, n + 1) of each
// accumulator row the lane holds, m < M only; m and n within the pass.
template <int NI, typename F>
__device__ __forceinline__ void for_each_pair(const float (&acc)[kMI][NI][4],
                                              int M, F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kMI; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = i * 16 + (lane >> 2) + h * 8;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        f(m, warp * NI * 8 + j * 8 + (lane & 3) * 2, acc[i][j][2 * h],
          acc[i][j][2 * h + 1]);
      }
    }
  }
}

__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<uint32_t*>(p) = mma::pack_bf16(v0, v1);
}

// kNI: n8 tiles per warp in conv1 and the 3x3 (pass width 64 * kNI, which
// divides Cw); conv3 always takes 4 (Cout = 4 * Cw, a multiple of 256).
template <int kNI>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                     const float* __restrict__ b1, const bf16* __restrict__ w2,
                     const float* __restrict__ b2, const bf16* __restrict__ w3,
                     const float* __restrict__ b3, bf16* __restrict__ out,
                     Shape s) {
  extern __shared__ float4 smem4[];
  const int W = s.W, Wp = s.W + 2, CS = s.Cw + 8;
  bf16* y1 = reinterpret_cast<bf16*>(smem4);      // (TR + 2, W + 2, CS)
  bf16* y2 = y1 + (s.TR + 2) * Wp * CS;           // (TR * W, CS)
  bf16* as = y2 + s.TR * W * CS;                  // kStages x (kMT, kAStride)
  bf16* bs = as + kStages * kAStage;              // kStages x kBStage

  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * s.TR;               // first output row
  const bf16* xb = x + static_cast<int64_t>(b) * s.H * W * s.Cin;

  {
    uint4* p = reinterpret_cast<uint4*>(y1);
    const int n = (s.TR + 2) * Wp * CS / 8;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      p[e] = make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();

  // ---- y1 = round(relu(x @ w1 + b1)) on the halo'd input rows in the map
  const int g_lo = max(r0 - 1, 0), g_hi = min(r0 + s.TR + 1, s.H);
  const int M1 = (g_hi - g_lo) * W;
  const bf16* x1 = xb + static_cast<int64_t>(g_lo) * W * s.Cin;
  bf16* y1_first = y1 + (g_lo - (r0 - 1)) * Wp * CS;   // y1 row of g_lo
  float acc[kMI][kNI][4];
  for (int m0 = 0; m0 < M1; m0 += kMT) {
    auto stage_x = [&](int kc) {
      bf16* dst = as + (kc % kStages) * kAStage;
      for (int e = threadIdx.x; e < kMT * kKC / 8; e += kThreads) {
        const int r = e / (kKC / 8), v = e % (kKC / 8);
        const bool ok = m0 + r < M1;
        const bf16* src =
            ok ? x1 + static_cast<int64_t>(m0 + r) * s.Cin + kc * kKC + v * 8
               : x;
        mma::cp_async16(dst + r * kAStride + v * 8, src, ok ? 16 : 0);
      }
    };
    const int a_off = (lane & 15) * kAStride + (lane >> 4) * 8;
    auto row_x = [&](int i, int kc, int kk) {
      return as + (kc % kStages) * kAStage + i * 16 * kAStride + a_off + kk;
    };
    for (int n0 = 0; n0 < s.Cw; n0 += 64 * kNI) {
      gemm_pass<kNI>(acc, w1, s.Cw, n0, s.Cin / kKC, bs, stage_x, row_x);
      for_each_pair<kNI>(acc, M1 - m0, [&](int m, int n, float v0, float v1) {
        const int p = m0 + m;
        n += n0;
        store2(y1_first + ((p / W) * Wp + p % W + 1) * CS + n,
               fmaxf(v0 + b1[n], 0.0f), fmaxf(v1 + b1[n + 1], 0.0f));
      });
    }
  }
  __syncthreads();

  // ---- y2 = round(relu(conv3x3(y1) + b2)) at the tile's output pixels
  const int M2 = min(s.TR, s.H - r0) * W;
  auto no_stage = [](int) {};
  for (int m0 = 0; m0 < M2; m0 += kMT) {
    const bf16* rows[kMI];             // the lane's row at tap (0, 0)
#pragma unroll
    for (int i = 0; i < kMI; ++i) {
      const int m = min(m0 + i * 16 + (lane & 15), M2 - 1);
      rows[i] = y1 + ((m / W) * Wp + m % W) * CS + (lane >> 4) * 8;
    }
    auto row_y1 = [&](int i, int kc, int kk) {
      const int k = kc * kKC, tap = k / s.Cw;
      return rows[i] + ((tap / 3) * Wp + tap % 3) * CS + k % s.Cw + kk;
    };
    for (int n0 = 0; n0 < s.Cw; n0 += 64 * kNI) {
      gemm_pass<kNI>(acc, w2, s.Cw, n0, 9 * s.Cw / kKC, bs, no_stage, row_y1);
      for_each_pair<kNI>(acc, M2 - m0, [&](int m, int n, float v0, float v1) {
        n += n0;
        store2(y2 + (m0 + m) * CS + n, fmaxf(v0 + b2[n], 0.0f),
               fmaxf(v1 + b2[n + 1], 0.0f));
      });
    }
  }
  __syncthreads();

  // ---- out = relu(round(y2 @ w3 + b3) + x)
  const bf16* xs = xb + static_cast<int64_t>(r0) * W * s.Cin;
  bf16* ob = out + (static_cast<int64_t>(b) * s.Ho + r0) * W * s.Cout;
  float acc3[kMI][4][4];
  for (int m0 = 0; m0 < M2; m0 += kMT) {
    const bf16* rows[kMI];
#pragma unroll
    for (int i = 0; i < kMI; ++i) {
      rows[i] = y2 + min(m0 + i * 16 + (lane & 15), M2 - 1) * CS +
                (lane >> 4) * 8;
    }
    auto row_y2 = [&](int i, int kc, int kk) {
      return rows[i] + kc * kKC + kk;
    };
    for (int n0 = 0; n0 < s.Cout; n0 += 256) {
      gemm_pass<4>(acc3, w3, s.Cout, n0, s.Cw / kKC, bs, no_stage, row_y2);
      for_each_pair<4>(acc3, M2 - m0, [&](int m, int n, float v0, float v1) {
        n += n0;
        const int64_t p = static_cast<int64_t>(m0 + m);
        const __nv_bfloat162 sc =
            *reinterpret_cast<const __nv_bfloat162*>(xs + p * s.Cin + n);
        const float y0 = round_to<bf16>(v0 + b3[n]);
        const float y1v = round_to<bf16>(v1 + b3[n + 1]);
        store2(ob + p * s.Cout + n,
               fmaxf(y0 + __bfloat162float(sc.x), 0.0f),
               fmaxf(y1v + __bfloat162float(sc.y), 0.0f));
      });
    }
  }
}

template <int kNI>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* w3, const void* b3, void* out, int B,
           const Shape& s, cudaStream_t stream) {
  auto kernel = bottleneck_tc_kernel<kNI>;
  // once per instantiation, so that a launch under CUDA-graph capture makes
  // no other runtime call
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((s.Ho + s.TR - 1) / s.TR, B);
  kernel<<<grid, kThreads, smem_bytes(s.TR, s.W, s.Cw), stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const bf16*>(w3),
      static_cast<const float*>(b3), static_cast<bf16*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace tc

// ---- float32, stride 1: the CUDA-core body --------------------------------

namespace f32 {

constexpr int kThreads = 256;        // 16 row groups x 16 column groups
constexpr int kGroups = 16;          // column groups
constexpr int kRowGroups = kThreads / kGroups;
constexpr int kNT = 128;             // columns a pass: 16 groups x 8
constexpr int kKC = 16;              // depth of one staged chunk
constexpr int kStages = 2;           // chunks in the ring
constexpr int kPadC = 4;             // floats after each pixel's channels
constexpr int kAStride = kKC + 4;    // staged x row
constexpr int kMaxRM = 9;            // rows a thread in one pass, at most
constexpr int kAStage = kRowGroups * kMaxRM * kAStride;   // one staged x chunk
constexpr int kBStage = kKC * kNT;                     // one weight chunk
constexpr int kXCopies =                 // x-row copies a thread
    (kRowGroups * kMaxRM * (kKC / 4) + kThreads - 1) / kThreads;

// Passes of at most 16 * kMaxRM rows for M rows, and the rows a thread in
// each (RM, one of 4, 5, 6, 8, 9).  Mirrored by ops/trunk.f32_pass_rows.
__host__ __device__ __forceinline__ int passes_of(int M) {
  return (M + kRowGroups * kMaxRM - 1) / (kRowGroups * kMaxRM);
}
__host__ __device__ __forceinline__ int rm_of(int M) {
  const int rows = kRowGroups * passes_of(M);
  const int need = (M + rows - 1) / rows;
  return need <= 4 ? 4 : need <= 6 ? need : need <= 8 ? 8 : 9;
}

// Shared memory of a TR x TW tile.  Mirrored by ops/trunk.f32_smem_bytes.
__host__ __device__ __forceinline__ int y2_floats(int TR, int TW, int Cw) {
  const int y2 = TR * TW * (Cw + kPadC);
  return y2 > kStages * kAStage ? y2 : kStages * kAStage;
}
__host__ __forceinline__ size_t smem_bytes(int TR, int TW, int Cw) {
  return sizeof(float) *
         (static_cast<size_t>(TR + 2) * (TW + 2) * (Cw + kPadC) +
          y2_floats(TR, TW, Cw) + kStages * kBStage);
}

// The thread's row group (rows rg + 16 i) and column group (columns 4 cg
// + 0..3 and + 64).
__device__ __forceinline__ int row_group() { return threadIdx.x / kGroups; }
__device__ __forceinline__ int col_group() { return threadIdx.x % kGroups; }

template <int N>
struct Int {
  static constexpr int value = N;
};

// f(Int<RM>) for the rows a thread of rm_of.
template <typename F>
__device__ __forceinline__ void with_rm(int rm, F f) {
  switch (rm) {
    case 4: f(Int<4>{}); break;
    case 5: f(Int<5>{}); break;
    case 6: f(Int<6>{}); break;
    case 8: f(Int<8>{}); break;
    default: f(Int<9>{}); break;
  }
}

__device__ __forceinline__ void fma4x8(float (&acc)[8], float a,
                                       const float4& b0, const float4& b1) {
  acc[0] = fmaf(a, b0.x, acc[0]);
  acc[1] = fmaf(a, b0.y, acc[1]);
  acc[2] = fmaf(a, b0.z, acc[2]);
  acc[3] = fmaf(a, b0.w, acc[3]);
  acc[4] = fmaf(a, b1.x, acc[4]);
  acc[5] = fmaf(a, b1.y, acc[5]);
  acc[6] = fmaf(a, b1.z, acc[6]);
  acc[7] = fmaf(a, b1.w, acc[7]);
}

// acc = A (the thread's RM rows, rg + 16 i) @ w[:, n0 : n0 + kNT], the
// depth in nk chunks of kKC, w row-major (nk * kKC, ldw).  stage_a(kc)
// starts the cp.async copies of A's chunk kc (or nothing); row_a(i, kc) is
// the thread's row i of chunk kc in shared memory (kKC floats, 16-byte
// aligned).  Weight chunks go through bs, a ring of kStages, kStages - 1 of
// them in flight while one multiplies.
template <int RM, typename StageA, typename RowA>
__device__ __forceinline__ void gemm_pass(float (&acc)[RM][8],
                                          const float* __restrict__ w,
                                          int ldw, int n0, int nk, float* bs,
                                          StageA stage_a, RowA row_a) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  auto stage_b = [&](int kc) {
    float* dst = bs + (kc % kStages) * kBStage;
    const float* src = w + static_cast<int64_t>(kc) * kKC * ldw + n0;
    for (int e = threadIdx.x; e < kKC * kNT / 4; e += kThreads) {
      const int r = e / (kNT / 4), v = e % (kNT / 4);
      mma::cp_async16(dst + r * kNT + v * 4,
                      src + static_cast<int64_t>(r) * ldw + v * 4, 16);
    }
  };
  for (int kc = 0; kc < kStages - 1; ++kc) {
    if (kc < nk) {
      stage_b(kc);
      stage_a(kc);
    }
    mma::cp_async_commit();
  }
  const int cg4 = col_group() * 4;
  for (int kc = 0; kc < nk; ++kc) {
    mma::cp_async_wait<kStages - 2>();
    // chunk kc is in place for every thread, and every thread is done with
    // chunk kc - 1, whose buffer the next copy fills
    __syncthreads();
    if (kc + kStages - 1 < nk) {
      stage_b(kc + kStages - 1);
      stage_a(kc + kStages - 1);
    }
    mma::cp_async_commit();
    const float* b = bs + (kc % kStages) * kBStage + cg4;
    const float* a[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = row_a(i, kc);
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 4) {
      float4 bv[4][2];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        bv[t][0] = *reinterpret_cast<const float4*>(b + (kk + t) * kNT);
        bv[t][1] = *reinterpret_cast<const float4*>(b + (kk + t) * kNT + 64);
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 av = *reinterpret_cast<const float4*>(a[i] + kk);
        fma4x8(acc[i], av.x, bv[0][0], bv[0][1]);
        fma4x8(acc[i], av.y, bv[1][0], bv[1][1]);
        fma4x8(acc[i], av.z, bv[2][0], bv[2][1]);
        fma4x8(acc[i], av.w, bv[3][0], bv[3][1]);
      }
    }
  }
  __syncthreads();  // the ring is free for the next pass
}

// f(m, j0, v) for the thread's rows m = m0 + rg + 16 i < M and its two runs
// of 4 columns (j0 = 0 and 64 within the pass), v the 4 accumulators.
template <int RM, typename F>
__device__ __forceinline__ void for_each_run(const float (&acc)[RM][8],
                                             int m0, int M, F f) {
  const int rg = row_group();
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = m0 + rg + kRowGroups * i;
    if (m >= M) continue;
    f(m, 0, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    f(m, 64, make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
  }
}

__device__ __forceinline__ float4 relu_bias(float4 v, const float* b) {
  return make_float4(fmaxf(v.x + b[0], 0.0f), fmaxf(v.y + b[1], 0.0f),
                     fmaxf(v.z + b[2], 0.0f), fmaxf(v.w + b[3], 0.0f));
}

// dst[p * CSt + c0 .. + n) <- src's, pixels p < npix, through distributed
// shared memory: the channels [c0, c0 + n) the cluster's peer computed.
__device__ __forceinline__ void take_peer(float* dst, const float* src,
                                          int npix, int CSt, int c0, int n) {
  const int vec = n / 4;
  for (int e = threadIdx.x; e < npix * vec; e += kThreads) {
    const int off = (e / vec) * CSt + c0 + (e % vec) * 4;
    *reinterpret_cast<float4*>(dst + off) =
        *reinterpret_cast<const float4*>(src + off);
  }
}

// CS: blocks a cluster, each computing Cw / CS of y1's and y2's channels
// and Cout / CS of the output's.  Grid (tiles * CS, B); a tile is TR
// output rows x TW columns, row-major over the map.
template <int CS>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_f32_kernel(const float* __restrict__ x,
                      const float* __restrict__ w1,
                      const float* __restrict__ b1,
                      const float* __restrict__ w2,
                      const float* __restrict__ b2,
                      const float* __restrict__ w3,
                      const float* __restrict__ b3, float* __restrict__ out,
                      Shape s, int TW) {
  extern __shared__ float4 smem4[];
  const int Wp = TW + 2, CSt = s.Cw + kPadC;
  float* y1 = reinterpret_cast<float*>(smem4);      // (TR + 2, Wp, CSt)
  float* y2 = y1 + (s.TR + 2) * Wp * CSt;           // (TR * TW, CSt)
  float* as = y2;                   // x chunks, while conv1 runs
  float* bs = y2 + y2_floats(s.TR, TW, s.Cw);       // kStages x kBStage

  const int rank = CS > 1 ? static_cast<int>(blockIdx.x % CS) : 0;
  const int tile = blockIdx.x / CS;
  const int tiles_w = (s.W + TW - 1) / TW;
  const int r0 = (tile / tiles_w) * s.TR, c0 = (tile % tiles_w) * TW;
  const int b = blockIdx.y;
  const int rg = row_group();
  const float* xb = x + static_cast<int64_t>(b) * s.H * s.W * s.Cin;
  const int nw = s.Cw / CS, nw0 = rank * nw;        // y1's and y2's columns
  const int no = s.Cout / CS, no0 = rank * no;      // the output's

  {
    float4* p = reinterpret_cast<float4*>(y1);
    const int n = (s.TR + 2) * Wp * CSt / 4;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      p[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  __syncthreads();

  // ---- y1 = relu(x @ w1 + b1) on the tile's halo'd window inside the map
  const int g_lo = max(r0 - 1, 0), g_hi = min(r0 + s.TR + 1, s.H);
  const int x_lo = max(c0 - 1, 0), x_hi = min(c0 + TW + 1, s.W);
  const int Wi = x_hi - x_lo;
  const int M1 = (g_hi - g_lo) * Wi;
  const int rm1 = rm_of(M1);
  for (int p = 0; p < passes_of(M1); ++p) {
    with_rm(rm1, [&](auto rmc) {
      constexpr int RM = decltype(rmc)::value;
      const int m0 = p * kRowGroups * RM;
      // the x row (offset in the image) of each slot this thread copies
      int xoff[kXCopies];
#pragma unroll
      for (int j = 0; j < kXCopies; ++j) {
        const int e = threadIdx.x + j * kThreads;
        const int m = m0 + e / (kKC / 4);
        xoff[j] = e < kRowGroups * RM * (kKC / 4) && m < M1
                      ? ((g_lo + m / Wi) * s.W + x_lo + m % Wi) * s.Cin +
                            (e % (kKC / 4)) * 4
                      : -1;
      }
      auto stage_x = [&](int kc) {
        float* dst = as + (kc % kStages) * kAStage;
#pragma unroll
        for (int j = 0; j < kXCopies; ++j) {
          const int e = threadIdx.x + j * kThreads;
          if (e >= kRowGroups * RM * (kKC / 4)) continue;
          const bool ok = xoff[j] >= 0;
          mma::cp_async16(dst + (e / (kKC / 4)) * kAStride + (e % (kKC / 4)) * 4,
                          ok ? xb + xoff[j] + kc * kKC : x, ok ? 16 : 0);
        }
      };
      auto row_x = [&](int i, int kc) -> const float* {
        return as + (kc % kStages) * kAStage + (rg + kRowGroups * i) * kAStride;
      };
      float acc[RM][8];
      for (int n0 = nw0; n0 < nw0 + nw; n0 += kNT) {
        gemm_pass<RM>(acc, w1, s.Cw, n0, s.Cin / kKC, bs, stage_x, row_x);
        for_each_run<RM>(acc, m0, M1, [&](int m, int j0, float4 v) {
          const int n = n0 + col_group() * 4 + j0;
          const int pix = (g_lo + m / Wi - (r0 - 1)) * Wp +
                          (x_lo + m % Wi - (c0 - 1));
          *reinterpret_cast<float4*>(y1 + pix * CSt + n) = relu_bias(v, b1 + n);
        });
      }
    });
  }
  if constexpr (CS > 1) {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();             // every block's half of y1 is in place
    take_peer(y1, cluster.map_shared_rank(y1, rank ^ 1), (s.TR + 2) * Wp,
              CSt, (rank ^ 1) * nw, nw);
  }
  __syncthreads();

  // ---- y2 = relu(conv3x3(y1) + b2) at the tile's output pixels
  const int rows = min(s.TR, s.H - r0), cols = min(TW, s.W - c0);
  const int M2 = rows * cols;
  const int rm2 = rm_of(M2);
  for (int p = 0; p < passes_of(M2); ++p) {
    with_rm(rm2, [&](auto rmc) {
      constexpr int RM = decltype(rmc)::value;
      const int m0 = p * kRowGroups * RM;
      int base[RM];                     // the row's y1 pixel at tap (0, 0)
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int m = min(m0 + rg + kRowGroups * i, M2 - 1);
        base[i] = ((m / cols) * Wp + m % cols) * CSt;
      }
      auto row_y1 = [&](int i, int kc) -> const float* {
        const int k = kc * kKC, tap = k / s.Cw;
        return y1 + base[i] + ((tap / 3) * Wp + tap % 3) * CSt + k % s.Cw;
      };
      auto no_stage = [](int) {};
      float acc[RM][8];
      for (int n0 = nw0; n0 < nw0 + nw; n0 += kNT) {
        gemm_pass<RM>(acc, w2, s.Cw, n0, 9 * s.Cw / kKC, bs, no_stage,
                      row_y1);
        for_each_run<RM>(acc, m0, M2, [&](int m, int j0, float4 v) {
          const int n = n0 + col_group() * 4 + j0;
          *reinterpret_cast<float4*>(y2 + m * CSt + n) = relu_bias(v, b2 + n);
        });
      }
    });
  }
  if constexpr (CS > 1) {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();             // every block's half of y2 is in place
    take_peer(y2, cluster.map_shared_rank(y2, rank ^ 1), M2, CSt,
              (rank ^ 1) * nw, nw);
    cluster.sync();             // and read: no block leaves while its
                                // shared memory is read
  } else {
    __syncthreads();
  }

  // ---- out = relu(y2 @ w3 + b3 + x)
  const int rm3 = rm2;
  for (int p = 0; p < passes_of(M2); ++p) {
    with_rm(rm3, [&](auto rmc) {
      constexpr int RM = decltype(rmc)::value;
      const int m0 = p * kRowGroups * RM;
      auto row_y2 = [&](int i, int kc) -> const float* {
        return y2 + min(m0 + rg + kRowGroups * i, M2 - 1) * CSt + kc * kKC;
      };
      auto no_stage = [](int) {};
      float acc[RM][8];
      for (int n0 = no0; n0 < no0 + no; n0 += kNT) {
        gemm_pass<RM>(acc, w3, s.Cout, n0, s.Cw / kKC, bs, no_stage, row_y2);
        for_each_run<RM>(acc, m0, M2, [&](int m, int j0, float4 v) {
          const int n = n0 + col_group() * 4 + j0;
          const int64_t pix =
              (static_cast<int64_t>(b) * s.H + r0 + m / cols) * s.W + c0 +
              m % cols;
          const float4 sc = *reinterpret_cast<const float4*>(x + pix * s.Cin + n);
          const float4 y = make_float4(v.x + b3[n], v.y + b3[n + 1],
                                       v.z + b3[n + 2], v.w + b3[n + 3]);
          *reinterpret_cast<float4*>(out + pix * s.Cout + n) =
              make_float4(fmaxf(y.x + sc.x, 0.0f), fmaxf(y.y + sc.y, 0.0f),
                          fmaxf(y.z + sc.z, 0.0f), fmaxf(y.w + sc.w, 0.0f));
        });
      }
    });
  }
}

template <int CS>
int launch(const float* x, const float* w1, const float* b1, const float* w2,
           const float* b2, const float* w3, const float* b3, float* out,
           int B, const Shape& s, int TW, cudaStream_t stream) {
  auto kernel = bottleneck_f32_kernel<CS>;
  // once per instantiation, so that a launch under CUDA-graph capture makes
  // no other runtime call
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int tiles = ((s.H + s.TR - 1) / s.TR) * ((s.W + TW - 1) / TW);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * CS, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(s.TR, TW, s.Cw);
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = CS;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = CS > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, x, w1, b1, w2, b2,
                                             w3, b3, out, s, TW);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

}  // namespace

// x (B, H, W, Cin) NHWC of float32 (bf16 == 0) or bfloat16 (bf16 == 1);
// weights of the same type, row-major: w1 (Cin, Cw), w2 (3, 3, Cw, Cw),
// w3 (Cw, Cout), wp (Cin, Cout) (read when project, always at stride 2);
// biases float32; out (B, H/stride, W/stride, Cout) NHWC of x's type.
// Cin and Cw must be multiples of 32; stride 2 needs project and even H, W.
// bf16 at stride 1 runs the tensor-core body, which also needs Cin % 64 ==
// 0, Cw % 128 == 0, no projection and 16-byte aligned x, weights and out,
// and takes rows_per_block output rows a block (its shared memory must
// fit).  float32 at stride 1 runs its CUDA-core body, which needs Cin and
// Cw multiples of 128, no projection, 16-byte aligned x, weights and out,
// and takes tiles of rows_per_block rows x tile_w columns on clusters of
// `cluster` blocks (1 or 2, dividing Cw and Cout into multiples of 128).
// The stride-2 body ignores the three: 1 output row a block.
extern "C" int fused_bottleneck(const void* x, int bf16, int B, int H, int W,
                                int Cin, int Cw, int Cout, int stride,
                                int project, const void* w1, const void* b1,
                                const void* w2, const void* b2,
                                const void* w3, const void* b3,
                                const void* wp, const void* bp, void* out,
                                int rows_per_block, int tile_w, int cluster,
                                void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < kKC || Cin % kKC != 0 || Cw < kKC ||
      Cw % kKC != 0 || Cout < 1 || (stride != 1 && stride != 2) ||
      (stride == 2 && (!project || H % 2 != 0 || W % 2 != 0)) ||
      (!project && Cin != Cout)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16 && stride == 1) {
    Shape s{H, W, Cin, Cw, Cout, H, W, rows_per_block};
    if (project || Cin % tc::kKC != 0 || Cw % 128 != 0 ||
        rows_per_block < 1 || rows_per_block > H ||
        tc::smem_bytes(rows_per_block, W, Cw) > kMaxSmem) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    for (const void* p : {x, w1, w2, w3, static_cast<const void*>(out)}) {
      if (!tc::aligned16(p)) {
        return static_cast<int>(cudaErrorMisalignedAddress);
      }
    }
    return Cw % 256 == 0
               ? tc::launch<4>(x, w1, b1, w2, b2, w3, b3, out, B, s, st)
               : tc::launch<2>(x, w1, b1, w2, b2, w3, b3, out, B, s, st);
  }
  if (stride == 1) {
    Shape s{H, W, Cin, Cw, Cout, H, W, rows_per_block};
    if (project || Cin % f32::kNT != 0 || (cluster != 1 && cluster != 2) ||
        (Cw / cluster) % f32::kNT != 0 || (Cout / cluster) % f32::kNT != 0 ||
        rows_per_block < 1 || rows_per_block > H || tile_w < 1 ||
        tile_w > W || static_cast<int64_t>(H) * W * Cin > INT32_MAX ||
        f32::smem_bytes(rows_per_block, tile_w, Cw) > kMaxSmem) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    for (const void* p : {x, w1, w2, w3, static_cast<const void*>(out)}) {
      if (!tc::aligned16(p)) {
        return static_cast<int>(cudaErrorMisalignedAddress);
      }
    }
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    return cluster == 2
               ? f32::launch<2>(f(x), f(w1), f(b1), f(w2), f(b2), f(w3),
                                f(b3), static_cast<float*>(out), B, s,
                                tile_w, st)
               : f32::launch<1>(f(x), f(w1), f(b1), f(w2), f(b2), f(w3),
                                f(b3), static_cast<float*>(out), B, s,
                                tile_w, st);
  }
  Shape s{H, W, Cin, Cw, Cout, H / 2, W / 2, 1};
  if (smem_bytes(s, 2) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return bf16 ? launch<__nv_bfloat16, 2, true>(x, w1, b1, w2, b2, w3, b3, wp,
                                               bp, out, B, s, st)
              : launch<float, 2, true>(x, w1, b1, w2, b2, w3, b3, wp, bp, out,
                                       B, s, st);
}
