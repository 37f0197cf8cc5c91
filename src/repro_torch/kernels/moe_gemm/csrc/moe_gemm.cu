// Grouped (expert-batched) GEMM of the capacity-dispatch MoE:
// y[e] = x[e] @ w[e] for every expert e.
//
// Replaces the TPU kernel src/repro/kernels/moe_gemm/moe_gemm.py:48
// (moe_gemm, body _moe_gemm_kernel).  Same function: x (E, C, D),
// w (E, D, F) in, y (E, C, F) out in x's dtype, products summed in fp32.
//
// Grid: (F tiles of 64, C tiles of TM, E).  The TPU grid carries its
// fp32 accumulator in VMEM scratch across a sequential D axis; here a
// block loops over D itself, tiles of 32 at a time through shared
// memory, with the accumulator in registers.  The TPU wrapper picks
// tiles that divide C, F and D (falling back to the whole axis); here
// every tail (C, F, D) is a masked, zero-filled load and rows and
// columns past the end are never stored, so any shape runs on the same
// tiles.  TM is 64 rows (4 x 4 outputs a thread) or, when C <= 16, 16
// rows (1 x 4): at decode C is 4, and 64-row tiles would spend 16x the
// FMAs of the real rows.
//
// What bounds it on an H100: at a granite-moe-3b-a800m prefill
// (E = 40, C = 508, D = 1536, F = 512) a launch is 32 GFLOP against
// 266 MB in fp32: operations (0.48 ms at 67 TFLOP/s); in bf16 the
// bytes.  At decode (C = 4) it reads all of w (126 MB in fp32) for four
// rows: bytes (0.038 ms).  This simple version does fp32 FMAs out of
// shared memory with no tensor cores (fp32 stays IEEE fp32) and no
// pipelined loads: wgmma with TMA loads, and a split of the long D loop
// across blocks for the small-C case, come later.
//
// Plain C interface, loaded with ctypes; the launch goes on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TN = 64;        // output columns per block
constexpr int TK = 32;        // depth of one shared-memory tile
constexpr int THREADS = 256;  // 16 x 16: rows ty*RM..+RM-1, cols tx + 16*j

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

template <typename T, int TM>
__global__ void __launch_bounds__(THREADS)
moe_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ y, int C, int D, int F) {
  constexpr int RM = TM / 16;   // rows a thread holds
  __shared__ float xs[TK][TM + 1];   // x tile, k-major (+1: no conflicts
                                     // on the transposing store)
  __shared__ float ws[TK][TN];

  const int e = blockIdx.z, m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* xe = x + (long long)e * C * D;
  const T* we = w + (long long)e * D * F;

  float acc[RM][4];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += TK) {
#pragma unroll
    for (int i = tid; i < TM * TK; i += THREADS) {
      const int r = i / TK, c = i % TK, m = m0 + r, k = k0 + c;
      xs[c][r] = (m < C && k < D) ? to_f32(xe[(long long)m * D + k]) : 0.f;
    }
#pragma unroll
    for (int i = tid; i < TK * TN; i += THREADS) {
      const int r = i / TN, c = i % TN, k = k0 + r, n = n0 + c;
      ws[r][c] = (k < D && n < F) ? to_f32(we[(long long)k * F + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      float a[RM], b[4];
#pragma unroll
      for (int r = 0; r < RM; ++r) a[r] = xs[kk][ty * RM + r];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(a[r], b[j], acc[r][j]);
    }
    __syncthreads();
  }

  T* ye = y + (long long)e * C * F;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int m = m0 + ty * RM + r;
    if (m >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < F) ye[(long long)m * F + n] = from_f32<T>(acc[r][j]);
    }
  }
}

template <typename T, int TM>
cudaError_t launch(const void* x, const void* w, void* y, int e, int c,
                   int d, int f, cudaStream_t stream) {
  dim3 grid((f + TN - 1) / TN, (c + TM - 1) / TM, e);
  moe_gemm_kernel<T, TM><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(y), c, d, f);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(const void* x, const void* w, void* y, int e, int c,
                        int d, int f, cudaStream_t stream) {
  if (c <= 16) return launch<T, 16>(x, w, y, e, c, d, f, stream);
  return launch<T, 64>(x, w, y, e, c, d, f, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Contiguous x (e, c, d), w (e, d, f)
// and y (e, c, f); 1 <= e <= 65535, c >= 1 with ceil(c / 64) <= 65535,
// d >= 0, f >= 1.
// Returns a cudaError_t: 0 after a launch that the runtime accepted.
extern "C" int moe_gemm_launch(int dtype, const void* x, const void* w,
                               void* y, int e, int c, int d, int f,
                               void* stream) {
  if (e < 1 || e > 65535 || c < 1 || (c + 63) / 64 > 65535 || d < 0 || f < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_rows<float>(x, w, y, e, c, d, f, st);
  if (dtype == 1)
    return (int)launch_rows<__nv_bfloat16>(x, w, y, e, c, d, f, st);
  return (int)cudaErrorInvalidValue;
}
