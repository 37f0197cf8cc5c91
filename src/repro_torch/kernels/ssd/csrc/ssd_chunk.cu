// Mamba2 SSD, the intra-chunk step: output within a chunk and the chunk's
// state summary.
//
// Replaces the TPU kernel src/repro/kernels/ssd/ssd_chunk.py:54
// (ssd_chunk, body _ssd_chunk_kernel).  Same function: x (BC, Q, H, P),
// dt (BC, Q, H), A (H,), B and C (BC, Q, N) in; with cum the inclusive
// cumsum of dt * A along the chunk,
//   y[i]  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//   st    = sum_j exp(cum_last - cum_j) dt_j x_j (x) B_j
// out, y (BC, Q, H, P) and st (BC, H, P, N) in the input dtype.
//
// Grid: (state tiles + row tiles, H, BC).  The TPU kernel holds a whole
// chunk in VMEM per (chunk, head); here a chunk may be the whole prompt
// (ssd_chunked takes Q = S when no tile of 64 or more divides S, e.g.
// Q = 511), so nothing is sized by Q.  A y block owns 64 rows i of one
// (chunk, head) and walks the column tiles j only up to the tile of its
// diagonal (the TPU grid computes the dead upper half and masks it).  A
// state block owns 64 of the P rows of st and walks all of Q.  Rows and
// columns past Q are zero-filled loads and are never stored.
//
// The decay cumsum is formed a tile of 64 positions at a time, carried
// from tile to tile, and added in order by one thread: the same order as
// torch.cumsum along a non-innermost dimension, so the plain version
// gets the same cum.  A block recomputes the prefix up to its own tile
// (a few hundred adds) instead of holding all of Q.  exp is taken of the
// fp32 difference cum_i - cum_j, and only where i >= j: A reaches -16, so
// cum falls to about -10^3 over a long chunk, where exp(cum_i) alone
// underflows, and above the diagonal the difference is positive.
//
// B and C are shared by all heads (ngroups = 1); this simple version
// recomputes C B^T per head, as the TPU grid does.
//
// Numerics follow the Pallas kernel: dt * A rounded to the input dtype,
// then cum, the decays, C B^T and M = (C B^T * exp(seg)) * dt in fp32; M
// rounded to the input dtype before M @ x; x * (exp(cum_last - cum) * dt)
// rounded to the input dtype before its product with B; products summed
// in fp32 (registers), stored in the input dtype.
//
// What bounds it on an H100: at BC = 4, Q = 511, H = 32, P = 64, N = 128
// the function needs 3.35 GFLOP (C B^T once per chunk, the causal half,
// the state) against 40 MB in fp32: operations in fp32 (about 0.05 ms),
// bytes in bf16.  This version does 2x the FLOPs (C B^T per head) as
// fp32 FMAs out of shared memory, 4 x 4 outputs a thread, with no tensor
// cores and no pipelined loads: wgmma and C B^T shared across heads come
// later.
//
// Plain C interface, loaded with ctypes; the launch goes on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;        // positions per tile (rows i, columns j)
constexpr int THREADS = 256;  // 16 x 16: rows ty*4..+3, columns tx + 16*k
constexpr int MAX_P = 128;
constexpr int MAX_N = 128;
constexpr int PC = MAX_P / 16;  // y columns a thread holds
constexpr int NC = MAX_N / 16;  // state columns a thread holds

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
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

struct Shape {
  int bc, q, h, p, n;
  int n_ptiles;   // state blocks per (chunk, head): ceil(P / 64)
  int n_itiles;   // y blocks per (chunk, head): ceil(Q / 64)
};

size_t smem_bytes(int p, int n) {
  // a y block: cs, bs [TQ][n + 1]; xs [TQ][p]; ms [TQ][TQ + 1]; a, cum,
  // dt [TQ].  A state block uses less: bs, xw [TQ][TQ + 1], a, cum, dt, w.
  return sizeof(float) * (size_t)(2 * TQ * (n + 1) + TQ * p
                                  + TQ * (TQ + 1) + 4 * TQ);
}

// The cumsum of dt * A over the tile of positions t0..t0+63 of chunk bc,
// head h, continued from `carry` (the cum before t0), into cum_sh; dt of
// the tile into dt_sh.  Positions past Q add 0.  Called by every thread;
// begins and ends with a barrier.  On return carry is the cum at the
// tile's end.
template <typename T>
__device__ void cum_tile(const T* __restrict__ dt, float a_h, const Shape& s,
                         int bc, int h, int t0, float* a_sh, float* cum_sh,
                         float* dt_sh, float& carry) {
  const int tid = threadIdx.x;
  __syncthreads();              // the previous tile's cum/dt are read
  if (tid < TQ) {
    const int q = t0 + tid;
    float d = 0.f, a = 0.f;
    if (q < s.q) {
      d = to_f32(dt[((long long)bc * s.q + q) * s.h + h]);
      a = round_to<T>(d * a_h);
    }
    a_sh[tid] = a;
    dt_sh[tid] = d;
  }
  __syncthreads();
  if (tid == 0) {
    float c = carry;
    for (int t = 0; t < TQ; ++t) {
      c += a_sh[t];
      cum_sh[t] = c;
    }
  }
  __syncthreads();
  carry = cum_sh[TQ - 1];
}

// 64 rows i of y for one (chunk, head).
template <typename T>
__device__ void y_tile(const T* __restrict__ x, const T* __restrict__ dt,
                       float a_h, const T* __restrict__ Bm,
                       const T* __restrict__ Cm, T* __restrict__ y,
                       const Shape& s, int bc, int h, int it, float* smem) {
  const int N = s.n, P = s.p, ldn = N + 1, ldm = TQ + 1;
  float* cs = smem;               // [TQ][N + 1]  C rows of the i tile
  float* bs = cs + TQ * ldn;      // [TQ][N + 1]  B rows of the j tile
  float* xs = bs + TQ * ldn;      // [TQ][P]      x rows of the j tile
  float* ms = xs + TQ * P;        // [TQ][TQ + 1]  M tile
  float* a_sh = ms + TQ * ldm;
  float* cum_sh = a_sh + TQ;
  float* dt_sh = cum_sh + TQ;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int i0 = it * TQ;
  const long long row0 = (long long)bc * s.q;   // chunk's first row in B/C

  for (int e = tid; e < TQ * N; e += THREADS) {
    const int r = e / N, c = e % N, q = i0 + r;
    cs[r * ldn + c] = q < s.q ? to_f32(Cm[(row0 + q) * N + c]) : 0.f;
  }
  // the cum of this block's rows: the chain of tiles up to its own
  float carry = 0.f;
  for (int t = 0; t <= it; ++t)
    cum_tile<T>(dt, a_h, s, bc, h, t * TQ, a_sh, cum_sh, dt_sh, carry);
  float cum_i[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) cum_i[r] = cum_sh[ty * 4 + r];

  float acc[4][PC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < PC; ++c) acc[r][c] = 0.f;

  carry = 0.f;
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * TQ;
    cum_tile<T>(dt, a_h, s, bc, h, j0, a_sh, cum_sh, dt_sh, carry);
    for (int e = tid; e < TQ * N; e += THREADS) {
      const int r = e / N, c = e % N, q = j0 + r;
      bs[r * ldn + c] = q < s.q ? to_f32(Bm[(row0 + q) * N + c]) : 0.f;
    }
    for (int e = tid; e < TQ * P; e += THREADS) {
      const int r = e / P, c = e % P, q = j0 + r;
      xs[r * P + c] =
          q < s.q ? to_f32(x[((row0 + q) * s.h + h) * P + c]) : 0.f;
    }
    __syncthreads();

    // C_i . B_j for 4 x 4 (i, j) pairs a thread
    float sc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) sc[r][k] = 0.f;
    for (int c = 0; c < N; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = cs[(ty * 4 + r) * ldn + c];
#pragma unroll
      for (int k = 0; k < 4; ++k) b[k] = bs[(tx + 16 * k) * ldn + c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) sc[r][k] = fmaf(a[r], b[k], sc[r][k]);
    }
    // M = (C_i . B_j * exp(cum_i - cum_j)) * dt_j where i >= j, else 0,
    // rounded to the input dtype
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int jl = tx + 16 * k;
        float m = 0.f;
        if (j0 + jl <= i)
          m = (sc[r][k] * expf(cum_i[r] - cum_sh[jl])) * dt_sh[jl];
        ms[(ty * 4 + r) * ldm + jl] = round_to<T>(m);
      }
    }
    __syncthreads();

    const int nj = min(TQ, s.q - j0);
    for (int j = 0; j < nj; ++j) {
      float m[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) m[r] = ms[(ty * 4 + r) * ldm + j];
#pragma unroll
      for (int c = 0; c < PC; ++c) {
        const int col = tx + 16 * c;
        if (col < P) {
          const float xv = xs[j * P + col];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(m[r], xv, acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i >= s.q) continue;
    T* out = y + ((row0 + i) * s.h + h) * P;
#pragma unroll
    for (int c = 0; c < PC; ++c) {
      const int col = tx + 16 * c;
      if (col < P) out[col] = from_f32<T>(acc[r][c]);
    }
  }
}

// 64 rows p of the state st[bc, h] (P x N).
template <typename T>
__device__ void state_tile(const T* __restrict__ x, const T* __restrict__ dt,
                           float a_h, const T* __restrict__ Bm,
                           T* __restrict__ st, const Shape& s, int bc, int h,
                           int pt, float* smem) {
  const int N = s.n, P = s.p, ldn = N + 1, ldx = TQ + 1;
  float* bs = smem;               // [TQ][N + 1]  B rows of the q tile
  float* xw = bs + TQ * ldn;      // [TQ][TQ + 1] weighted x, p columns
  float* a_sh = xw + TQ * ldx;
  float* cum_sh = a_sh + TQ;
  float* dt_sh = cum_sh + TQ;
  float* w_sh = dt_sh + TQ;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int p0 = pt * TQ;
  const long long row0 = (long long)bc * s.q;
  const int n_qt = (s.q + TQ - 1) / TQ;

  // cum_last: the whole chain (positions past Q add 0, so the carry at
  // its end is cum[Q - 1])
  float carry = 0.f;
  for (int t = 0; t < n_qt; ++t)
    cum_tile<T>(dt, a_h, s, bc, h, t * TQ, a_sh, cum_sh, dt_sh, carry);
  const float cum_last = carry;

  float acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < NC; ++k) acc[r][k] = 0.f;

  carry = 0.f;
  for (int t = 0; t < n_qt; ++t) {
    const int t0 = t * TQ;
    cum_tile<T>(dt, a_h, s, bc, h, t0, a_sh, cum_sh, dt_sh, carry);
    if (tid < TQ) w_sh[tid] = expf(cum_last - cum_sh[tid]) * dt_sh[tid];
    __syncthreads();
    for (int e = tid; e < TQ * TQ; e += THREADS) {
      const int r = e / TQ, c = e % TQ, q = t0 + r, p = p0 + c;
      float v = 0.f;
      if (q < s.q && p < P)
        v = round_to<T>(to_f32(x[((row0 + q) * s.h + h) * P + p])
                        * w_sh[r]);
      xw[r * ldx + c] = v;
    }
    for (int e = tid; e < TQ * N; e += THREADS) {
      const int r = e / N, c = e % N, q = t0 + r;
      bs[r * ldn + c] = q < s.q ? to_f32(Bm[(row0 + q) * N + c]) : 0.f;
    }
    __syncthreads();
    const int nq = min(TQ, s.q - t0);
    for (int q = 0; q < nq; ++q) {
      float xv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) xv[r] = xw[q * ldx + ty * 4 + r];
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int n = tx + 16 * k;
        if (n < N) {
          const float bv = bs[q * ldn + n];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][k] = fmaf(xv[r], bv, acc[r][k]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = p0 + ty * 4 + r;
    if (p >= P) continue;
    T* out = st + (((long long)bc * s.h + h) * P + p) * N;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int n = tx + 16 * k;
      if (n < N) out[n] = from_f32<T>(acc[r][k]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                 const T* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, T* __restrict__ y,
                 T* __restrict__ st, Shape s) {
  extern __shared__ float smem[];
  const int h = blockIdx.y, bc = blockIdx.z;
  const float a_h = to_f32(A[h]);
  const int b = blockIdx.x;
  if (b < s.n_ptiles) {
    state_tile<T>(x, dt, a_h, Bm, st, s, bc, h, b, smem);
  } else {
    // the longest row tiles (nearest the chunk's end) first
    y_tile<T>(x, dt, a_h, Bm, Cm, y, s, bc, h,
              s.n_itiles - 1 - (b - s.n_ptiles), smem);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, void* y, void* st,
                   Shape s, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(MAX_P, MAX_N));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid(s.n_ptiles + s.n_itiles, s.h, s.bc);
  ssd_chunk_kernel<T><<<grid, THREADS, smem_bytes(s.p, s.n), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), static_cast<T*>(st), s);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Contiguous x (bc, q, h, p),
// dt (bc, q, h), A (h), B and C (bc, q, n); y like x, st (bc, h, p, n);
// 1 <= p, n <= 128; 1 <= bc, h <= 65535; q >= 1.
// Returns a cudaError_t: 0 after a launch that the runtime accepted.
extern "C" int ssd_chunk_launch(int dtype, const void* x, const void* dt,
                                const void* A, const void* Bm, const void* Cm,
                                void* y, void* st, int bc, int q, int h,
                                int p, int n, void* stream) {
  if (p < 1 || p > MAX_P || n < 1 || n > MAX_N || q < 1 || bc < 1
      || bc > 65535 || h < 1 || h > 65535)
    return (int)cudaErrorInvalidValue;
  Shape sh{bc, q, h, p, n, (p + TQ - 1) / TQ, (q + TQ - 1) / TQ};
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, dt, A, Bm, Cm, y, st, sh, strm);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, st, sh, strm);
  return (int)cudaErrorInvalidValue;
}
