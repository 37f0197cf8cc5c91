// Grouped (expert-batched) GEMM of the capacity-dispatch MoE:
// y[e] = x[e] @ w[e] for every expert e.
//
// Replaces the TPU kernel src/repro/kernels/moe_gemm/moe_gemm.py:48
// (moe_gemm, body _moe_gemm_kernel).  Same function: x (E, C, D),
// w (E, D, F) in, y (E, C, F) out in x's dtype, products summed in fp32.
// The TPU grid carries its fp32 accumulator in VMEM scratch across a
// sequential D axis and picks tiles that divide C, F and D; here every
// tail is a zero-filled load and rows and columns past the end are never
// stored, so any shape runs.
//
// What bounds it on an H100, at granite-moe-3b-a800m's shapes: a prefill
// launch (E = 40, C = 508, D = 1536, F = 512, and its w2 twin) is 32
// GFLOP against 266 MB in fp32, operations (0.48 ms at 67 TFLOP/s); in
// bf16 133 MB against 989 TFLOP/s, bytes (0.044 ms).  A decode launch
// (C = 4) reads all of w for four rows: bytes in both dtypes (0.038 and
// 0.019 ms).  So one entry point holds four variants, which the wrapper
// chooses from the shape and dtype (ops.py, `variant`) and passes in:
//
// 1. wgmma (bf16, C > 16, D and F multiples of 8): 128 x 128 output
//    tiles, two consumer warpgroups of 64 rows and a producer warp, two
//    blocks a SM.  The producer keeps a ring of (x, w) k-tiles of 64 in
//    flight by TMA, through per-expert 3-d tensor maps (D, C, E) and
//    (F, D, E), so the zero fill of a D, C or F tail stays inside one
//    expert; full and empty mbarriers hand the stages over.  The
//    consumers run wgmma m64n128k16 with x K-major and w MN-major
//    (transpose bit; the two 64-column atoms of w's tile LBO apart) from
//    the 128-byte-swizzled tiles, one group in flight while the stage of
//    the previous one is released; fp32 accumulators, bf16 epilogue.
//    What holds it back (0.08-0.11 ms against cuBLAS's 0.056 on an
//    H100): each block refills its own tiles from L2, with no cluster
//    multicast and no persistent tile loop.
// 2. simt (fp32, C > 16, D and F multiples of 4): IEEE fp32 FMAs, no
//    TF32.  128 x 128 block tile, 8 x 8 outputs a thread, k-tiles of 16
//    through a cp.async double buffer of 16-byte copies.  Shared-memory
//    reads are as many as FMA issue slots and one block fits a SM (165
//    registers): about 58% of the fp32 peak.
// 3. stream (C <= 16: decode; fp32 with F a multiple of 4, bf16 with D
//    and F multiples of 8): reads w once at the card's bandwidth, in one
//    launch.
//    - bf16: the wgmma kernel with 64-row tiles (one consumer warpgroup;
//      rows past C are zero fill that TMA never reads from memory) and a
//      four-stage ring: w streams through TMA at about 2.7 TB/s, the
//      tensor cores do the small product.
//    - fp32 (IEEE FMAs, no tensor cores): a block takes a slab of 32 16-byte column
//      vectors and a range of `split_rows` rows of D, with the rows of x
//      staged in shared memory; its eight warps walk the rows
//      (neighbouring lanes on neighbouring vectors), each thread with U
//      loads in flight and the next U loading while it multiplies, and
//      sum their partials in a fixed order.  D is split while the blocks
//      fit one wave; the partial sums of a slab's splits go to a
//      workspace, and the last block of the slab (a counter it takes
//      with one atomic and resets to 0) adds them in split order.
//    No atomics on values: two calls give the same bits.
// 4. general (any other shape, for example D or F not a multiple of 8 in
//    bf16):
//    64-wide tiles through fp32 shared memory, 64 rows (4 x 4 outputs a
//    thread) or 16 when C <= 16.
//
// Plain C interface, loaded with ctypes; the launch goes on the caller's
// stream, allocates nothing (the workspace and counters are the
// wrapper's), and returns cudaGetLastError().

#include "hopper.cuh"

namespace {

constexpr int MAX_SPLIT_ROWS = 2048;  // rows of D a stream block stages

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
cudaError_t launch_general(const void* x, const void* w, void* y, int e,
                           int c, int d, int f, cudaStream_t stream) {
  if (c <= 16) return launch<T, 16>(x, w, y, e, c, d, f, stream);
  return launch<T, 64>(x, w, y, e, c, d, f, stream);
}


// -- 1. wgmma: bf16 prefill, and bf16 decode with 64-row tiles ---------

constexpr int WN = 128, WK = 64;            // block tile columns, k-tile
constexpr int NH = WN / 64;                 // 64-column atoms of w's tile
constexpr int WI = 128;                     // columns of one wgmma
constexpr int NI = WN / WI;                 // wgmmas a k16 step
constexpr int H_BYTES = WK * 64 * 2;        // w atom: 64 k rows of 128 B
constexpr int W_BLOCKS = 2;                 // blocks a SM

// a block of WM_ rows (128 at prefill, 64 when C <= 64: the rows of C
// past its end are zero fill, never read from memory)
template <int WM_>
struct WTile {
  static constexpr int NWG = WM_ / 64;      // consumer warpgroups
  static constexpr int THREADS = NWG * 128 + 32;   // + the producer warp
  static constexpr int STAGES = WM_ == 128 ? 3 : 4;   // 96 KB either way
  static constexpr int A_BYTES = WM_ * WK * 2;        // x: rows of 128 B
  static constexpr int STAGE_BYTES = A_BYTES + NH * H_BYTES;
  static constexpr size_t SMEM = STAGES * STAGE_BYTES + 1024 + 16 * STAGES;
};

template <int WM_>
__global__ void __launch_bounds__(WTile<WM_>::THREADS, W_BLOCKS)
moe_gemm_wgmma(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap wmap,
               __nv_bfloat16* __restrict__ y, int C, int D, int F) {
  using TT = WTile<WM_>;
  constexpr int W_STAGES = TT::STAGES, W_STAGE_BYTES = TT::STAGE_BYTES;
  constexpr int A_BYTES = TT::A_BYTES, WM = WM_;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full = base + W_STAGES * W_STAGE_BYTES;   // W_STAGES bars
  const uint32_t empty = full + 8 * W_STAGES;               // W_STAGES bars
  const int e = blockIdx.z, m0 = blockIdx.y * WM, n0 = blockIdx.x * WN;
  const int nk = (D + WK - 1) / WK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int st = 0; st < W_STAGES; ++st) {
      hopper::mbar_init(full + 8 * st, 1);
      hopper::mbar_init(empty + 8 * st, 4 * TT::NWG);   // each consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * TT::NWG) {            // producer: one thread issues TMA
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % W_STAGES;
        if (kt >= W_STAGES)
          hopper::mbar_wait(empty + 8 * st, (kt / W_STAGES - 1) & 1);
        const uint32_t a_s = base + st * W_STAGE_BYTES, b_s = a_s + A_BYTES;
        hopper::mbar_expect_tx(full + 8 * st, W_STAGE_BYTES);
        hopper::tma_load_3d(a_s, &xmap, full + 8 * st, kt * WK, m0, e);
#pragma unroll
        for (int h = 0; h < NH; ++h)
          hopper::tma_load_3d(b_s + h * H_BYTES, &wmap, full + 8 * st,
                              n0 + 64 * h, kt * WK, e);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + 64 wg .. + 63, all columns
  const int wg = warp / 4;
  float acc[NI][WI / 2];
#pragma unroll
  for (int h = 0; h < NI; ++h)
#pragma unroll
    for (int j = 0; j < WI / 2; ++j) acc[h][j] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % W_STAGES;
    hopper::mbar_wait(full + 8 * st, (kt / W_STAGES) & 1);
    const uint32_t a_s = base + st * W_STAGE_BYTES + wg * 64 * 128;
    const uint32_t b_s = base + st * W_STAGE_BYTES + A_BYTES;
#pragma unroll
    for (int h = 0; h < NI; ++h) hopper::fence_regs(acc[h]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk)
#pragma unroll
      for (int h = 0; h < NI; ++h)
        hopper::wgmma_ss<WI, 0, 1>(
            acc[h], hopper::desc(a_s + kk * 32, 128),
            hopper::desc(b_s + h * (WI / 64) * H_BYTES + kk * 16 * 128, 128,
                         H_BYTES));
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();            // the previous k-tile's group is done
#pragma unroll
    for (int h = 0; h < NI; ++h) hopper::fence_regs(acc[h]);
    if (kt > 0 && lane == 0)
      hopper::mbar_arrive(empty + 8 * ((kt - 1) % W_STAGES));
  }
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < NI; ++h) hopper::fence_regs(acc[h]);

  // fragment: acc[h][j] is row 16 (warp % 4) + lane / 4 + 8 ((j >> 1) & 1),
  // column WI h + 8 (j >> 2) + 2 (lane % 4) + (j & 1)
  __nv_bfloat16* ye = y + (long long)e * C * F;
#pragma unroll
  for (int h = 0; h < NI; ++h)
#pragma unroll
    for (int j = 0; j < WI / 2; j += 2) {
      const int m = m0 + wg * 64 + (warp % 4) * 16 + lane / 4
                    + 8 * ((j >> 1) & 1);
      const int n = n0 + h * WI + 8 * (j >> 2) + 2 * (lane % 4);
      if (m < C && n < F)
        *reinterpret_cast<uint32_t*>(ye + (long long)m * F + n) =
            hopper::pack_bf16(acc[h][j], acc[h][j + 1]);
    }
}

template <int WM>
cudaError_t launch_wgmma(const void* x, const void* w, void* y, int e, int c,
                         int d, int f, cudaStream_t stream) {
  using TT = WTile<WM>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        moe_gemm_wgmma<WM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)TT::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  // per-expert 3-d maps: a tail's zero fill never reaches the next expert
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[3] = {(cuuint64_t)d, (cuuint64_t)c, (cuuint64_t)e};
  const cuuint64_t xstrides[2] = {(cuuint64_t)d * 2, (cuuint64_t)c * d * 2};
  const cuuint32_t xbox[3] = {WK, WM, 1};
  const cuuint64_t wdims[3] = {(cuuint64_t)f, (cuuint64_t)d, (cuuint64_t)e};
  const cuuint64_t wstrides[2] = {(cuuint64_t)f * 2, (cuuint64_t)d * f * 2};
  const cuuint32_t wbox[3] = {64, WK, 1};
  if (!hopper::make_map(&xmap, x, 3, xdims, xstrides, xbox, 128)
      || !hopper::make_map(&wmap, w, 3, wdims, wstrides, wbox, 128))
    return cudaErrorInvalidValue;
  dim3 grid((f + WN - 1) / WN, (c + WM - 1) / WM, e);
  moe_gemm_wgmma<WM><<<grid, TT::THREADS, TT::SMEM, stream>>>(
      xmap, wmap, static_cast<__nv_bfloat16*>(y), c, d, f);
  return cudaGetLastError();
}

// -- 2. simt: fp32 prefill ----------------------------------------------

constexpr int SM_M = 128, SM_N = 128, SM_K = 16;
constexpr int SM_LDA = SM_K + 4;   // x rows padded: 80 B, 16-byte aligned

__global__ void __launch_bounds__(256)
moe_gemm_simt(const float* __restrict__ x, const float* __restrict__ w,
              float* __restrict__ y, int C, int D, int F) {
  __shared__ __align__(16) float xs[2][SM_M][SM_LDA];
  __shared__ __align__(16) float ws[2][SM_K][SM_N];
  const int e = blockIdx.z, m0 = blockIdx.y * SM_M, n0 = blockIdx.x * SM_N;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* xe = x + (long long)e * C * D;
  const float* we = w + (long long)e * D * F;
  const int nk = (D + SM_K - 1) / SM_K;

  // a k-tile: x 128 rows x 4 chunks, w 16 rows x 32 chunks, 2 + 2 a thread
  auto load = [&](int kt, int buf) {
    const int k0 = kt * SM_K;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + 256 * i;
      const int r = id / 4, kc = (id % 4) * 4;
      const bool ok = m0 + r < C && k0 + kc < D;
      hopper::cp_async16(hopper::smem_addr(&xs[buf][r][kc]),
                         ok ? xe + (long long)(m0 + r) * D + k0 + kc : xe, ok);
      const int kr = id / 32, nc = (id % 32) * 4;
      const bool okw = k0 + kr < D && n0 + nc < F;
      hopper::cp_async16(hopper::smem_addr(&ws[buf][kr][nc]),
                         okw ? we + (long long)(k0 + kr) * F + n0 + nc : we, okw);
    }
    hopper::cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (nk > 0) load(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      load(kt + 1, buf ^ 1);
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int k4 = 0; k4 < SM_K; k4 += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(&xs[buf][ty * 8 + i][k4]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(&ws[buf][k4 + kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&ws[buf][k4 + kk][64 + tx * 4]);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                         : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  float* ye = y + (long long)e * C * F;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= C) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      if (n < F)
        *reinterpret_cast<float4*>(ye + (long long)m * F + n) = make_float4(
            acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
            acc[i][4 * h + 3]);
    }
  }
}

// -- 3. stream, fp32: decode (C <= 16) with 16-byte loads ----------------

constexpr int ST_THREADS = 256;    // 32 column lanes x 8 row lanes (warps)
constexpr int ST_VEC = 4;          // fp32 columns of one 16-byte load
constexpr int ST_FS = 32 * ST_VEC; // columns of a block's slab

// 16 bytes of w, read once: not kept in L1, fetched from DRAM into L2 in
// 256-byte sectors
__device__ __forceinline__ float4 ld_stream(const float* p) {
  float4 r;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];\n"
      : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w) : "l"(p));
  return r;
}

// rows d, d + 8, .., d + 8 (U - 1) of one column vector (zero past d1)
template <int U>
__device__ __forceinline__ void load_rows(float4 (&r)[U], const float* wp,
                                          int d, int d1, int F) {
#pragma unroll
  for (int u = 0; u < U; ++u)
    r[u] = d + 8 * u < d1 ? ld_stream(wp + (long long)(d + 8 * u) * F)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
}

template <int CM>
__global__ void __launch_bounds__(ST_THREADS)
moe_gemm_stream(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ y, float* __restrict__ part,
                int* __restrict__ counters, int C, int D, int F, int ds) {
  constexpr int U = 8;                     // rows in flight a thread
  extern __shared__ float st_smem[];
  float* xs = st_smem;                     // [CM][ds], rows >= C zero
  float* red = st_smem + CM * ds;          // [CM][ST_FS]
  __shared__ int last;
  const int e = blockIdx.z, split = blockIdx.y, slab = blockIdx.x;
  const int E = gridDim.z, splits = gridDim.y;
  const int d0 = split * ds, d1 = min(D, d0 + ds), n0 = slab * ST_FS;
  const int tid = threadIdx.x, cl = tid % 32, rl = tid / 32;
  const int col = n0 + cl * ST_VEC;
  const bool live = col < F;
  const float* wp = w + (long long)e * D * F + col;

  // the first U rows of w start loading before x is staged
  int d = d0 + rl;
  float4 cur[U];
  if (live) load_rows<U>(cur, wp, d, d1, F);
  for (int i = tid; i < CM * ds; i += ST_THREADS) {
    const int c = i / ds, dd = d0 + i % ds;
    xs[i] = (c < C && dd < d1) ? x[((long long)e * C + c) * D + dd] : 0.f;
  }
  __syncthreads();

  float acc[CM][ST_VEC];
#pragma unroll
  for (int c = 0; c < CM; ++c)
#pragma unroll
    for (int v = 0; v < ST_VEC; ++v) acc[c][v] = 0.f;

  if (live) {
    // rows d, d + 8, ..: U at a time, the next U loading while these
    // are multiplied
    for (; d < d1; d += 8 * U) {
      float4 nxt[U];
      load_rows<U>(nxt, wp, d + 8 * U, d1, F);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (d + 8 * u >= d1) break;
        const float wv[ST_VEC] = {cur[u].x, cur[u].y, cur[u].z, cur[u].w};
        const float* xr = xs + (d + 8 * u - d0);
#pragma unroll
        for (int c = 0; c < CM; ++c) {
          const float xv = xr[c * ds];
#pragma unroll
          for (int v = 0; v < ST_VEC; ++v)
            acc[c][v] = fmaf(xv, wv[v], acc[c][v]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) cur[u] = nxt[u];
    }
  }

  // the eight row lanes' sums, added in row-lane order
  for (int r = 0; r < 8; ++r) {
    if (rl == r && live) {
#pragma unroll
      for (int c = 0; c < CM; ++c)
#pragma unroll
        for (int v = 0; v < ST_VEC; ++v) {
          float* dst = red + c * ST_FS + cl * ST_VEC + v;
          *dst = r == 0 ? acc[c][v] : *dst + acc[c][v];
        }
    }
    __syncthreads();
  }

  float* ye = y + (long long)e * C * F;
  if (splits == 1) {
    for (int i = tid; i < C * ST_FS; i += ST_THREADS) {
      const int c = i / ST_FS, n = n0 + i % ST_FS;
      if (n < F) ye[(long long)c * F + n] = red[i];
    }
    return;
  }
  // partial sums of this split; the slab's last block adds them in order
  for (int i = tid; i < C * ST_FS; i += ST_THREADS) {
    const int c = i / ST_FS, n = n0 + i % ST_FS;
    if (n < F) part[(((long long)split * E + e) * C + c) * F + n] = red[i];
  }
  __threadfence();
  __syncthreads();
  int* counter = counters + (long long)e * gridDim.x + slab;
  if (tid == 0) last = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < C * ST_FS; i += ST_THREADS) {
    const int c = i / ST_FS, n = n0 + i % ST_FS;
    if (n >= F) continue;
    float sum = 0.f;
    for (int sp = 0; sp < splits; ++sp)
      sum += __ldcg(part + (((long long)sp * E + e) * C + c) * F + n);
    ye[(long long)c * F + n] = sum;
  }
  if (tid == 0) *counter = 0;     // ready for the next launch
}

template <int CM>
cudaError_t launch_stream_cm(const void* x, const void* w, void* y, void* ws,
                             void* counters, int e, int c, int d, int f,
                             int ds, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)CM * (ds + ST_FS);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        moe_gemm_stream<CM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(float) * CM * (MAX_SPLIT_ROWS + ST_FS)));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int splits = d > 0 ? (d + ds - 1) / ds : 1;
  dim3 grid((f + ST_FS - 1) / ST_FS, splits, e);
  moe_gemm_stream<CM><<<grid, ST_THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(y), static_cast<float*>(ws),
      static_cast<int*>(counters), c, d, f, ds);
  return cudaGetLastError();
}

cudaError_t launch_stream(const void* x, const void* w, void* y, void* ws,
                          void* counters, int e, int c, int d, int f, int ds,
                          cudaStream_t stream) {
  if (c <= 4)
    return launch_stream_cm<4>(x, w, y, ws, counters, e, c, d, f, ds, stream);
  if (c <= 8)
    return launch_stream_cm<8>(x, w, y, ws, counters, e, c, d, f, ds, stream);
  return launch_stream_cm<16>(x, w, y, ws, counters, e, c, d, f, ds, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Contiguous x (e, c, d), w (e, d, f)
// and y (e, c, f), 1 <= e <= 65535, c >= 1, d >= 0, f >= 1; `variant`
// as ops.py chooses it (0 general, 1 wgmma, 2 simt, 3 stream), each
// refusing a shape it does not take; the C tiles of its grid (64 rows
// for general, 128 for wgmma and simt) at most 65535.  stream only:
// `split_rows` rows of D a block (a multiple of 8 up to MAX_SPLIT_ROWS),
// `workspace` ceil(d / split_rows) x e x c x f floats when that is more
// than one split, and `counters` e x ceil(f / slab) ints, zero.
// Returns a cudaError_t: 0 after a launch that the runtime accepted.
extern "C" int moe_gemm_launch(int dtype, const void* x, const void* w,
                               void* y, int e, int c, int d, int f,
                               int variant, int split_rows, void* workspace,
                               void* counters, void* stream) {
  if (e < 1 || e > 65535 || c < 1 || d < 0 || f < 1 || dtype < 0
      || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = dtype == 0 ? 4 : 8;      // elements of 16 bytes
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0)
      && (reinterpret_cast<uintptr_t>(w) % 16 == 0)
      && (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  switch (variant) {
    case 0:
      if ((c + 63) / 64 > 65535) return (int)cudaErrorInvalidValue;
      return dtype == 0
          ? (int)launch_general<float>(x, w, y, e, c, d, f, st)
          : (int)launch_general<__nv_bfloat16>(x, w, y, e, c, d, f, st);
    case 1:
      if (dtype != 1 || c <= 16 || d < 8 || d % 8 || f % 8 || !aligned
          || (c + 127) / 128 > 65535)
        return (int)cudaErrorInvalidValue;
      return (int)launch_wgmma<128>(x, w, y, e, c, d, f, st);
    case 2:
      if (dtype != 0 || c <= 16 || d % 4 || f % 4 || !aligned
          || (c + SM_M - 1) / SM_M > 65535)
        return (int)cudaErrorInvalidValue;
      {
        dim3 grid((f + SM_N - 1) / SM_N, (c + SM_M - 1) / SM_M, e);
        moe_gemm_simt<<<grid, 256, 0, st>>>(
            static_cast<const float*>(x), static_cast<const float*>(w),
            static_cast<float*>(y), c, d, f);
        return (int)cudaGetLastError();
      }
    case 3: {
      if (c > 16 || f % vec || !aligned) return (int)cudaErrorInvalidValue;
      if (dtype == 1) {                 // TMA ring, 64-row tiles
        if (d < 8 || d % 8) return (int)cudaErrorInvalidValue;
        return (int)launch_wgmma<64>(x, w, y, e, c, d, f, st);
      }
      if (split_rows < 8 || split_rows % 8 || split_rows > MAX_SPLIT_ROWS
          || counters == nullptr || (d + split_rows - 1) / split_rows > 65535
          || (d > split_rows && workspace == nullptr))
        return (int)cudaErrorInvalidValue;
      return (int)launch_stream(x, w, y, workspace, counters, e, c, d, f,
                                split_rows, st);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
