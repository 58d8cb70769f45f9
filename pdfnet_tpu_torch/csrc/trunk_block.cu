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
// Design: one block of 256 threads per (image, tile of TR output rows).
// y1 for the TR*S+2-S halo'd input rows lives in shared memory as float32
// values rounded to T, with a zero column on each side and zero rows outside
// the map (the 3x3 pads conv2's input, after conv1+BN+ReLU); y2 for the
// tile's output pixels follows it.  Each of the three products (and the
// projection) is a tiled matrix product: 64 rows x 128 columns per pass,
// each thread 4 rows x 8 columns, depth staged 32 at a time (weights always,
// x rows when they come from device memory; y1 and y2 are read in place,
// the 3x3's taps addressed into the padded y1).  The products run as float32
// FMAs on operands that are exact in float32 (a bf16 x bf16 product is), so
// they match a bf16 matrix unit with a float32 accumulator up to the order
// of the sums.
//
// Bound on the H100: at the main path's shapes (layer2/3 stride 1, batch 8)
// ~10.3 GFLOP a block at the bf16 tensor-core rate (~0.010 ms) against
// 19-38 MB of map read and written (~0.006-0.011 ms).  This simple kernel
// runs its products on the float32 CUDA cores (67 TFLOP/s), recomputes conv1
// on the halo rows and leaves tiles partly empty where the pixel count is not
// a multiple of 64, so it is far from that bound; tensor-core tiles are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

template <typename T>
int dispatch(int stride, int project, const void* x, const void* w1,
             const void* b1, const void* w2, const void* b2, const void* w3,
             const void* b3, const void* wp, const void* bp, void* out, int B,
             const Shape& s, cudaStream_t st) {
  if (stride == 2) {
    return launch<T, 2, true>(x, w1, b1, w2, b2, w3, b3, wp, bp, out, B, s,
                              st);
  }
  return project ? launch<T, 1, true>(x, w1, b1, w2, b2, w3, b3, wp, bp, out,
                                      B, s, st)
                 : launch<T, 1, false>(x, w1, b1, w2, b2, w3, b3, wp, bp, out,
                                       B, s, st);
}

}  // namespace

// x (B, H, W, Cin) NHWC of float32 (bf16 == 0) or bfloat16 (bf16 == 1);
// weights of the same type, row-major: w1 (Cin, Cw), w2 (3, 3, Cw, Cw),
// w3 (Cw, Cout), wp (Cin, Cout) (read when project, always at stride 2);
// biases float32; out (B, H/stride, W/stride, Cout) NHWC of x's type.
// Cin and Cw must be multiples of 32; stride 2 needs project and even H, W.
// Output rows per block: 2 at stride 1 (1 if that does not fit in shared
// memory), 1 at stride 2.
extern "C" int fused_bottleneck(const void* x, int bf16, int B, int H, int W,
                                int Cin, int Cw, int Cout, int stride,
                                int project, const void* w1, const void* b1,
                                const void* w2, const void* b2,
                                const void* w3, const void* b3,
                                const void* wp, const void* bp, void* out,
                                void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < kKC || Cin % kKC != 0 || Cw < kKC ||
      Cw % kKC != 0 || Cout < 1 || (stride != 1 && stride != 2) ||
      (stride == 2 && (!project || H % 2 != 0 || W % 2 != 0)) ||
      (!project && Cin != Cout)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Shape s{H, W, Cin, Cw, Cout, H / stride, W / stride, stride == 1 ? 2 : 1};
  if (smem_bytes(s, stride) > kMaxSmem) s.TR = 1;
  if (smem_bytes(s, stride) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(stride, project, x, w1, b1, w2, b2, w3,
                                        b3, wp, bp, out, B, s, st)
              : dispatch<float>(stride, project, x, w1, b1, w2, b2, w3, b3, wp,
                                bp, out, B, s, st);
}
