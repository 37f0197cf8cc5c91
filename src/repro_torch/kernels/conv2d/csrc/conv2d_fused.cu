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
// What bounds it on an H100: the fp32 FMA rate.  At the VGG16 shapes K
// is 27..4608 and the arithmetic intensity is far above the fp32 ridge
// point (about 20 FLOP/byte at 67 TFLOP/s over 3.35 TB/s).  fp32 inputs
// must stay IEEE fp32, so the tensor cores (TF32 at best) do not apply.
// A single frame's late layers are small GEMMs (M = 196..1736 against
// N = 256..512), which give too few output tiles to fill 132 SMs.  What
// the design does about it:
//   * output tiles of 128 x 64 or 64 x 64 a 256-thread block, 8 x 4 or
//     4 x 4 fp32 accumulators a thread, chosen per shape by the wrapper
//     (ops.py, `plan`): the larger tile where it still gives enough
//     blocks.  (128 x 128 tiles, 8 x 8 a thread, fit one block a SM and
//     were no faster at any VGG16 shape, batch 1 or 8);
//   * split-K inside a thread-block cluster: the S <= 8 blocks of one
//     output tile each walk 1/S of K (on 16-deep slice boundaries, in
//     order), leave their fp32 partial tile in their own shared memory,
//     and after a cluster barrier each rank sums 1/S of the tile's pool
//     windows over distributed shared memory in rank order 0..S-1, then
//     runs bias, ReLU and the pool and makes the one store.  No workspace,
//     no second launch, no atomics: a run repeats bit for bit;
//   * the `ring` variant (CI and CO multiples of 4, 16-byte aligned
//     pointers): a 3-stage ring of cp.async copies (16 bytes in fp32, 8 in
//     bf16; rows past M and k past K zero filled without a read) with one
//     __syncthreads a slice.  A slice's channel offset (dh W + dw) CI + c
//     is carried from slice to slice, added to a pixel base computed once
//     a block: no div/mod per element;
//   * the `general` variant (any CI and CO, e.g. the RGB stem CI = 3):
//     the same ring and epilogue with scalar loads that decode
//     (dh, dw, c) per element;
//   * M is enumerated window-major (n, hp, wp, i, j), so a block holds
//     whole pool windows (BM / (ph pw) of them) and the conv output never
//     reaches device memory; channel tails are masked loads.
// bf16 inputs run the same code: bf16 in shared memory, fp32 FMAs.
//
// Plain C interface, loaded with ctypes; the launch goes on the caller's
// stream, allocates nothing, and returns the launch's cudaError_t.

#include "hopper.cuh"

namespace {

constexpr int BK = 16;        // K slice a stage holds
constexpr int STAGES = 3;     // slices in flight
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int APAD = 4;       // A rows padded to BK + 4 elements
constexpr int CPAD = 4;       // partial-tile rows padded to BN + 4 floats
constexpr int MAX_SPLIT = 8;  // blocks of a cluster (portable limit)

struct ConvShape {
  int n, h, w, ci, kh, kw, co;
  int sh, sw;          // conv stride
  int ph, pw;          // pool window == pool stride (1, 1 = no pool)
  int hp, wp;          // output spatial size (after the pool)
  int k;               // KH * KW * CI
  int relu, has_bias;
  int split;           // blocks of a cluster, each 1/split of K
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

// 4 consecutive elements of shared memory as fp32
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// one chunk of 4 elements into shared memory by cp.async
__device__ __forceinline__ void cp_chunk(float* dst, const float* src,
                                         bool valid) {
  hopper::cp_async16(hopper::smem_addr(dst), src, valid);
}
__device__ __forceinline__ void cp_chunk(__nv_bfloat16* dst,
                                         const __nv_bfloat16* src,
                                         bool valid) {
  hopper::cp_async8(hopper::smem_addr(dst), src, valid);
}

template <typename T, int BM, int BN>
struct Tile {
  static constexpr int TM = BM / 16, TN = BN / 16;   // outputs a thread
  static constexpr int A_CH = BM * BK / 4 / THREADS; // A chunks a thread
  static constexpr int B_CH = BK * BN / 4 / THREADS; // B chunks a thread
  static constexpr int LDA = BK + APAD, LDC = BN + CPAD;
  static constexpr size_t A_BYTES = sizeof(T) * STAGES * BM * LDA;
  static constexpr size_t B_BYTES = sizeof(T) * STAGES * BK * BN;
  static constexpr size_t C_BYTES = sizeof(float) * BM * LDC;
  static constexpr size_t SMEM = A_BYTES + B_BYTES > C_BYTES
                                     ? A_BYTES + B_BYTES : C_BYTES;
};

// grid (blocks_m * split, ceil(CO / BN)), clusters of `split` along x
template <typename T, int BM, int BN, bool RING>
__global__ void __launch_bounds__(THREADS)
conv2d_fused_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                    const T* __restrict__ bias, T* __restrict__ y,
                    ConvShape s) {
  using TT = Tile<T, BM, BN>;
  constexpr int TM = TT::TM, TN = TT::TN, LDA = TT::LDA, LDC = TT::LDC;
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);                  // [STAGES][BM][LDA]
  T* Bs = reinterpret_cast<T*>(smem + TT::A_BYTES);    // [STAGES][BK][BN]
  float* Cs = reinterpret_cast<float*>(smem);          // [BM][LDC], after K

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int split = s.split;
  const int rank = (int)hopper::cluster_rank();
  const int pool = s.ph * s.pw;
  const int wpb = BM / pool;                    // whole windows per block
  const long long win0 = (long long)(blockIdx.x / split) * wpb;
  const int co0 = blockIdx.y * BN;

  // this rank's slices of K: [sl0, sl1), balanced, in order
  const int nslices = (s.k + BK - 1) / BK;
  const int sl0 = (int)((long long)rank * nslices / split);
  const int nk = (int)((long long)(rank + 1) * nslices / split) - sl0;

  // --- the A rows this thread loads (rows tid/4 + 64 q, k (tid%4)*4) ----
  const int a_kc = (tid & 3) * 4;
  long long a_base[TT::A_CH];
  bool a_ok[TT::A_CH];
#pragma unroll
  for (int q = 0; q < TT::A_CH; ++q) {
    const int row = (tid >> 2) + 64 * q;
    const int wi = row / pool, e = row - wi * pool;
    const long long win = win0 + wi;
    a_ok[q] = wi < wpb && win < s.windows;
    a_base[q] = 0;
    if (a_ok[q]) {
      const long long per_img = (long long)s.hp * s.wp;
      const int img = (int)(win / per_img);
      const int rem = (int)(win - img * per_img);
      const int hp = rem / s.wp, wp = rem - hp * s.wp;
      const int ho = hp * s.ph + e / s.pw;
      const int wo = wp * s.pw + e % s.pw;
      a_base[q] = (((long long)img * s.h + (long long)ho * s.sh) * s.w
                   + (long long)wo * s.sw) * s.ci;
    }
  }
  // ring: (dh, dw, c) of this thread's first k of the next slice to load
  int a_dh = 0, a_dw = 0, a_c = 0;
  if (RING) {
    const int ka = sl0 * BK + a_kc, kwci = s.kw * s.ci;
    a_dh = ka / kwci;
    a_dw = (ka - a_dh * kwci) / s.ci;
    a_c = ka - a_dh * kwci - a_dw * s.ci;
  }
  // --- the B chunks: rows id / (BN/4), columns (id % (BN/4)) * 4 --------
  constexpr int BCH_ROW = BN / 4;

  auto load = [&](int stage, int slice) {
    T* as = As + stage * BM * LDA;
    T* bs = Bs + stage * BK * BN;
    const int k0 = slice * BK;
    if constexpr (RING) {
      const bool kin = k0 + a_kc < s.k;
      const long long off = ((long long)a_dh * s.w + a_dw) * s.ci + a_c;
#pragma unroll
      for (int q = 0; q < TT::A_CH; ++q) {
        const bool ok = a_ok[q] && kin;
        cp_chunk(as + ((tid >> 2) + 64 * q) * LDA + a_kc,
                 ok ? x + a_base[q] + off : x, ok);
      }
      a_c += BK;                    // the next slice's (dh, dw, c)
      while (a_c >= s.ci) {
        a_c -= s.ci;
        if (++a_dw == s.kw) { a_dw = 0; ++a_dh; }
      }
#pragma unroll
      for (int q = 0; q < TT::B_CH; ++q) {
        const int id = tid + THREADS * q;
        const int kr = id / BCH_ROW, nc = (id % BCH_ROW) * 4;
        const bool ok = k0 + kr < s.k && co0 + nc < s.co;
        cp_chunk(bs + kr * BN + nc,
                 ok ? wt + (long long)(k0 + kr) * s.co + co0 + nc : wt, ok);
      }
    } else {
      const int kwci = s.kw * s.ci;
#pragma unroll
      for (int q = 0; q < TT::A_CH; ++q) {
        T* dst = as + ((tid >> 2) + 64 * q) * LDA + a_kc;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k0 + a_kc + j;
          T v = from_f32<T>(0.f);
          if (a_ok[q] && k < s.k) {
            const int dh = k / kwci;
            const int r = k - dh * kwci;
            const int dw = r / s.ci;
            const int c = r - dw * s.ci;
            v = x[a_base[q] + ((long long)dh * s.w + dw) * s.ci + c];
          }
          dst[j] = v;
        }
      }
#pragma unroll
      for (int q = 0; q < TT::B_CH; ++q) {
        const int id = tid + THREADS * q;
        const int kr = id / BCH_ROW, nc = (id % BCH_ROW) * 4;
        const int k = k0 + kr;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int co = co0 + nc + j;
          bs[kr * BN + nc + j] = (k < s.k && co < s.co)
              ? wt[(long long)k * s.co + co] : from_f32<T>(0.f);
        }
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // rows ty*TM + i; columns h*64 + tx*4 + (0..3) for h < TN / 4
  auto compute = [&](int stage) {
    const T* as = As + stage * BM * LDA;
    const T* bs = Bs + stage * BK * BN;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = ld4(as + (ty * TM + i) * LDA + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float bv[TN];
#pragma unroll
        for (int h = 0; h < TN / 4; ++h) {
          const float4 b = ld4(bs + (k4 + kk) * BN + h * 64 + tx * 4);
          bv[4 * h] = b.x; bv[4 * h + 1] = b.y;
          bv[4 * h + 2] = b.z; bv[4 * h + 3] = b.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                         : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
  };

  // --- the K loop: STAGES - 1 slices ahead, one barrier a slice --------
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load(st, sl0 + st);
    hopper::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    hopper::cp_async_wait<STAGES - 2>();
    __syncthreads();          // slice kt landed; slice kt - 1 is read
    if (kt + STAGES - 1 < nk)
      load((kt + STAGES - 1) % STAGES, sl0 + kt + STAGES - 1);
    hopper::cp_async_commit();
    compute(kt % STAGES);
  }
  hopper::cp_async_wait<0>();
  __syncthreads();            // the ring is free for the partial tile

  // --- epilogue: partial tile to shared memory, then the cluster sum ---
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int h = 0; h < TN / 4; ++h)
      *reinterpret_cast<float4*>(&Cs[(ty * TM + i) * LDC + h * 64 + tx * 4])
          = make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
  hopper::cluster_sync();     // every rank's partial tile is written

  const int per = (wpb + split - 1) / split;     // windows a rank reduces
  const int w_lo = rank * per, w_hi = min(wpb, w_lo + per);
  const uint32_t cs = hopper::smem_addr(Cs);
  constexpr int N4 = BN / 4;
  const bool vec_out = (s.co & 3) == 0;
  for (int idx = tid; idx < (w_hi - w_lo) * N4; idx += THREADS) {
    const int wi = w_lo + idx / N4, c = (idx % N4) * 4;
    const long long win = win0 + wi;
    const int co = co0 + c;
    if (win >= s.windows || co >= s.co) continue;
    float bv[4] = {0.f, 0.f, 0.f, 0.f};
    if (s.has_bias) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (co + j < s.co) bv[j] = to_f32(bias[co + j]);
    }
    float best[4];
    for (int e = 0; e < pool; ++e) {
      const uint32_t off = 4u * ((wi * pool + e) * LDC + c);
      float4 v = hopper::ld_dsmem4(hopper::dsmem_map(cs + off, 0));
      for (int r = 1; r < split; ++r) {          // rank order: same bits
        const float4 p = hopper::ld_dsmem4(hopper::dsmem_map(cs + off, r));
        v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
      }
      float u[4] = {v.x + bv[0], v.y + bv[1], v.z + bv[2], v.w + bv[3]};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (s.relu) u[j] = fmaxf(u[j], 0.f);
        best[j] = e == 0 ? u[j] : fmaxf(best[j], u[j]);
      }
    }
    T* dst = y + win * s.co + co;
    if constexpr (sizeof(T) == 4) {
      if (vec_out) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(best[0], best[1], best[2], best[3]);
        continue;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (co + j < s.co) dst[j] = from_f32<T>(best[j]);
  }
  hopper::cluster_sync();     // no block leaves while others read it
}

template <typename T, int BM, int BN, bool RING>
cudaError_t launch_tile(const void* x, const void* w, const void* b,
                        void* y, const ConvShape& s, cudaStream_t stream) {
  using TT = Tile<T, BM, BN>;
  auto kernel = conv2d_fused_kernel<T, BM, BN, RING>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)TT::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int wpb = BM / (s.ph * s.pw);
  const long long blocks_m = (s.windows + wpb - 1) / wpb;
  if (blocks_m * s.split > 0x7fffffffLL) return cudaErrorInvalidValue;
  dim3 grid((unsigned)(blocks_m * s.split), (unsigned)((s.co + BN - 1) / BN));
  return hopper::launch_cluster(kernel, grid, dim3(THREADS), TT::SMEM,
                                stream, s.split, static_cast<const T*>(x),
                                static_cast<const T*>(w),
                                static_cast<const T*>(b), static_cast<T*>(y),
                                s);
}

template <typename T, bool RING>
cudaError_t launch_variant(const void* x, const void* w, const void* b,
                           void* y, const ConvShape& s, int bm, int bn,
                           cudaStream_t st) {
  if (bm == 128 && bn == 64)
    return launch_tile<T, 128, 64, RING>(x, w, b, y, s, st);
  if (bm == 64 && bn == 64)
    return launch_tile<T, 64, 64, RING>(x, w, b, y, s, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* y,
                   const ConvShape& s, int variant, int bm, int bn,
                   cudaStream_t st) {
  return variant == 0 ? launch_variant<T, true>(x, w, b, y, s, bm, bn, st)
                      : launch_variant<T, false>(x, w, b, y, s, bm, bn, st);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  b may be null (no bias).  variant
// 0 = ring, 1 = general; tile bm x bn 128 x 64 or 64 x 64;
// split 1..8 blocks a cluster, at most one per 16-deep slice of K, as
// ops.py's `plan` chooses them.  Returns a cudaError_t: 0 after a launch
// that the runtime accepted, or cudaErrorInvalidValue (1) for a shape or
// plan the kernel does not take.
extern "C" int conv2d_fused_launch(int dtype, const void* x, const void* w,
                                   const void* b, void* y, int n, int h,
                                   int wd, int ci, int kh, int kw, int co,
                                   int sh, int sw, int ph, int pw, int relu,
                                   int variant, int bm, int bn, int split,
                                   void* stream) {
  ConvShape s;
  s.n = n; s.h = h; s.w = wd; s.ci = ci; s.kh = kh; s.kw = kw; s.co = co;
  s.sh = sh; s.sw = sw; s.ph = ph; s.pw = pw;
  const int ho = (h - kh) / sh + 1, wo = (wd - kw) / sw + 1;
  if (n < 1 || ci < 1 || co < 1 || kh < 1 || kw < 1 || sh < 1 || sw < 1 ||
      ph < 1 || pw < 1 || ph * pw > bm || h < kh || wd < kw)
    return (int)cudaErrorInvalidValue;
  s.hp = ho / ph; s.wp = wo / pw;
  s.k = kh * kw * ci;
  s.relu = relu; s.has_bias = b != nullptr;
  s.split = split;
  s.windows = (long long)n * s.hp * s.wp;
  if (split < 1 || split > MAX_SPLIT || split > (s.k + BK - 1) / BK)
    return (int)cudaErrorInvalidValue;
  if (variant == 0 && (ci % 4 != 0 || co % 4 != 0 || !aligned16(x) ||
                       !aligned16(w)))
    return (int)cudaErrorInvalidValue;
  if (variant != 0 && variant != 1) return (int)cudaErrorInvalidValue;
  if (s.windows == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, w, b, y, s, variant, bm, bn, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, w, b, y, s, variant, bm, bn, st);
  return (int)cudaErrorInvalidValue;
}
