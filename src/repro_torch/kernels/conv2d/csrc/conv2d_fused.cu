// Implicit-GEMM NHWC conv with a fused bias + ReLU + max-pool epilogue.
//
// Replaces the TPU kernel src/repro/kernels/conv2d/conv2d.py:110
// (conv2d_fused, body _conv2d_kernel).  It computes the same function,
// not the same grid: a strided VALID conv of x (N, H, W, CI) with
// w (KH, KW, CI, CO) as one GEMM with
//     M = N * HO * WO  (output pixels),  N_gemm = CO,  K = KH * KW * CI,
// where A[m][k] is gathered from x on the fly (no im2col buffer) and
// B[k][co] is the HWIO weight itself, read as a row-major K x CO matrix.
// The epilogue runs in fp32 before the one store: + bias, ReLU, then an
// optional non-overlapping max-pool with window == stride (ph, pw) whose
// output is (HO / ph, WO / pw), dropping the ragged tail as the
// reference does.  No pool is the 1x1 window.
//
// What bounds it on an H100: at the VGG16 shapes K is 27..4608 and the
// arithmetic intensity is far above the fp32 ridge point (about 20
// FLOP/byte at 67 TFLOP/s over 3.35 TB/s), so the bound is the fp32
// FMA rate, not HBM.  What the design does about that, simply:
//   * a 64 x 64 output tile per 256-thread block, each thread holding a
//     4 x 4 fp32 accumulator in registers, so every value read from
//     shared memory feeds four FMAs;
//   * K is walked in 16-deep slices staged through shared memory;
//     loads along K are channel-contiguous in NHWC and HWIO;
//   * the pool runs on the tile in shared memory: M is enumerated
//     window-major (n, hp, wp, i, j), so a block always holds whole
//     pool windows and the conv output never reaches device memory;
//   * channel tails are masked loads, not padded copies.
// It does not use the tensor cores (fp32 inputs must stay IEEE fp32),
// and has no cp.async/TMA pipelining yet.
//
// Plain C interface, loaded with ctypes; the launch goes on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // output rows (pixels) per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 16;        // K slice staged in shared memory
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

struct ConvShape {
  int n, h, w, ci, kh, kw, co;
  int sh, sw;          // conv stride
  int ph, pw;          // pool window == pool stride (1, 1 = no pool)
  int hp, wp;          // output spatial size (after the pool)
  int k;               // KH * KW * CI
  int relu, has_bias;
  long long windows;   // N * HP * WP
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv2d_fused_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                    const T* __restrict__ bias, T* __restrict__ y,
                    ConvShape s) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  __shared__ float Cs[BM][BN + 1];

  const int tid = threadIdx.x;
  const int pool = s.ph * s.pw;
  const int wpb = BM / pool;                    // whole windows per block
  const long long win0 = (long long)blockIdx.x * wpb;
  const int co0 = blockIdx.y * BN;

  // --- the A row this thread loads: fixed for the whole K loop ---------
  const int a_row = tid >> 2;                   // 0..63
  const int a_k = (tid & 3) * 4;                // 0, 4, 8, 12
  bool a_valid = false;
  long long a_base = 0;
  {
    const int wi = a_row / pool;
    const int e = a_row - wi * pool;
    const long long win = win0 + wi;
    if (wi < wpb && win < s.windows) {
      const long long per_img = (long long)s.hp * s.wp;
      const int img = (int)(win / per_img);
      const int rem = (int)(win - img * per_img);
      const int hp = rem / s.wp, wp = rem - (rem / s.wp) * s.wp;
      const int ho = hp * s.ph + e / s.pw;
      const int wo = wp * s.pw + e % s.pw;
      a_base = (((long long)img * s.h + (long long)ho * s.sh) * s.w
                + (long long)wo * s.sw) * s.ci;
      a_valid = true;
    }
  }
  // --- the B slice this thread loads ---------------------------------
  const int b_k = tid >> 4;                     // 0..15
  const int b_n = (tid & 15) * 4;               // 0..60

  const int ty = tid >> 4, tx = tid & 15;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int kwci = s.kw * s.ci;
  for (int k0 = 0; k0 < s.k; k0 += BK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + a_k + q;
      float v = 0.f;
      if (a_valid && k < s.k) {
        const int dh = k / kwci;
        const int r = k - dh * kwci;
        const int dw = r / s.ci;
        const int c = r - dw * s.ci;
        v = to_f32(x[a_base + ((long long)dh * s.w + dw) * s.ci + c]);
      }
      As[a_k + q][a_row] = v;
    }
    {
      const int k = k0 + b_k;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int co = co0 + b_n + q;
        Bs[b_k][b_n + q] = (k < s.k && co < s.co)
            ? to_f32(wt[(long long)k * s.co + co]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // --- epilogue: bias, ReLU into the tile, then pool and store --------
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = co0 + tx * 4 + j;
    const float bj = (s.has_bias && co < s.co) ? to_f32(bias[co]) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = acc[i][j] + bj;
      if (s.relu) v = fmaxf(v, 0.f);
      Cs[ty * 4 + i][tx * 4 + j] = v;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < wpb * BN; idx += THREADS) {
    const int wi = idx / BN;
    const int c = idx - wi * BN;
    const long long win = win0 + wi;
    const int co = co0 + c;
    if (win >= s.windows || co >= s.co) continue;
    float v = Cs[wi * pool][c];
    for (int e = 1; e < pool; ++e) v = fmaxf(v, Cs[wi * pool + e][c]);
    y[win * s.co + co] = from_f32<T>(v);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* y,
                   const ConvShape& s, cudaStream_t stream) {
  const int wpb = BM / (s.ph * s.pw);
  const long long blocks_m = (s.windows + wpb - 1) / wpb;
  dim3 grid((unsigned)blocks_m, (unsigned)((s.co + BN - 1) / BN));
  conv2d_fused_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), s);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  b may be null (no bias).  Returns a
// cudaError_t: 0 after a launch that the runtime accepted, or
// cudaErrorInvalidValue (1) for a shape the kernel does not take.
extern "C" int conv2d_fused_launch(int dtype, const void* x, const void* w,
                                   const void* b, void* y, int n, int h,
                                   int wd, int ci, int kh, int kw, int co,
                                   int sh, int sw, int ph, int pw, int relu,
                                   void* stream) {
  ConvShape s;
  s.n = n; s.h = h; s.w = wd; s.ci = ci; s.kh = kh; s.kw = kw; s.co = co;
  s.sh = sh; s.sw = sw; s.ph = ph; s.pw = pw;
  const int ho = (h - kh) / sh + 1, wo = (wd - kw) / sw + 1;
  if (n < 1 || ci < 1 || co < 1 || kh < 1 || kw < 1 || sh < 1 || sw < 1 ||
      ph < 1 || pw < 1 || ph * pw > BM || h < kh || wd < kw)
    return (int)cudaErrorInvalidValue;
  s.hp = ho / ph; s.wp = wo / pw;
  s.k = kh * kw * ci;
  s.relu = relu; s.has_bias = b != nullptr;
  s.windows = (long long)n * s.hp * s.wp;
  if (s.windows == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, w, b, y, s, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, w, b, y, s, st);
  return (int)cudaErrorInvalidValue;
}
