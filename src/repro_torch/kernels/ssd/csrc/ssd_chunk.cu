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
// Grid (ceil(H / G), BC, y items + state items), 64 G threads a block,
// one block an SM in fp32 (its shared memory).  G (4 heads a y block,
// or 2 where G = 4's grid is short of a wave or H <= 2) comes from
// ops.plan in Python; G' = G / 2 heads a state block and the tiles (TQ
// = 64, TJ = 32, NS = 64) are this file's, and ssd_chunk_query reports
// the grid and shared memory that the Python plan is held against.  B
// and C are shared by all heads (ngroups = 1), so a block serves a
// group of heads (the last group may hold fewer live heads; nothing is
// stored for the others):
//   - a y block owns a pair of 64-row tiles i of one (chunk, G heads, 64
//     columns of P): row tile it is paired with n_itiles - 1 - it, so
//     every pair walks n_itiles + 1 tiles of columns j (an odd middle
//     tile runs alone).  It walks the columns in steps of TJ = 32.
//     Every second step it forms C_i B_j^T for the next 2 TJ columns once
//     for its G heads (fp32, in shared memory, 4 x 4 a thread, summed
//     over N in order); every step, per head, M = round((C B^T *
//     exp(cum_i - cum_j)) * dt_j) and y += M x_j, 64 threads a head, 8 x
//     8 outputs a thread (four FMAs per float read from shared memory);
//   - a state block owns 64 rows of P and NS = 64 columns of N of st for
//     G' heads (half the y block's group) and walks all of Q in steps of
//     TJ positions: xw = round(x * (exp(cum_last - cum) * dt)), then
//     st += xw^T B, 128 threads a head, 8 x 4 outputs a thread.  Each B
//     tile serves its G' heads; a state block carries about a third of a
//     y block's work, so at mamba2's shape the state blocks fill one wave
//     after the y blocks' one.
// Items run longest first (blockIdx.z: y pairs, then state tiles).
// Nothing is sized by Q (ssd_chunked takes Q = S when no tile of 64 or
// more divides S, e.g. Q = 511 or 1030): rows and columns past Q are
// zero-filled loads that are never stored, and column steps wholly past
// Q are skipped.
//
// Tiles come through cp.async (16-byte copies, each thread on fixed
// chunks, zero fill past Q; plain loads where P or N is not a multiple
// of 16 bytes, N's row is not a power of two of 16-byte chunks, or a
// pointer is not aligned): x through a two-slot ring, B for the next
// C B^T as soon as the current one is formed, the next step's dt into
// registers; all of it lands while a step computes.  Three barriers a
// step: tiles landed | C B^T (y) and the step's cum | M (y) or xw
// (state) | the products.  bf16 tiles stay bf16 in shared memory and
// are widened at the read; the FMAs, rounding points and sums are the
// fp32 path's.
//
// The decay cumsum is added in order by one thread per head (the G
// heads at once), TJ positions at a time from dt * A staged in shared
// memory, in registers, and carried from step to step: the same order
// as torch.cumsum along a non-innermost dimension, so the plain version
// gets the same cum (a different order moves exp(cum_i - cum_j) by about
// 1e-4 relative at cum ~ -10^3).  A block first walks the prefix once
// for all its heads (PB steps of dt in flight at a time): a y block to
// the end of its longer row tile, keeping the cum of both row tiles; a
// state block to cum_last.  exp is taken of the fp32 difference
// cum_i - cum_j, and only where i >= j.
//
// Numerics follow the Pallas kernel: dt * A rounded to the input dtype,
// then cum, the decays, C B^T and M = (C B^T * exp(seg)) * dt in fp32; M
// rounded to the input dtype before M @ x; x * (exp(cum_last - cum) * dt)
// rounded to the input dtype before its product with B; products summed
// in fp32 (registers), stored in the input dtype.  Every sum runs in
// index order (C B^T over n, M x over j, the state over q), as the plain
// version's matrix products sum on this card: at mamba2's shapes the
// two agree bit for bit, which keeps the bf16 model within its band of
// the plain path (summing C B^T in two halves of N moved mamba2's bf16
// logits past it).  No atomics: two calls give the same bits.
//
// What bounds it on an H100: at BC = 4, Q = 511, H = 32, P = 64, N = 128
// the function needs 3.35 GFLOP (C B^T once per chunk, the causal half,
// the state) against 40 MB in fp32: operations in fp32 (0.050 ms at the
// 67 TFLOP/s FMA peak), bytes in bf16.  This version issues about 4.7
// GFLOP as fp32 FMAs out of shared memory (C B^T once per 4 heads and
// the full diagonal tiles), no tensor cores: IEEE fp32 has none on this
// card with TF32 off, and bf16 through mma/wgmma is a later step.  With
// 8 warps an SM and three barriers a step it reaches about a quarter of
// the FMA peak: the C B^T and state products wait on shared-memory
// reads, and the state blocks run as a second wave.
//
// Plain C interface, loaded with ctypes; the launch goes on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int TQ = 64;    // rows i of a y row tile; P columns of a tile
constexpr int TJ = 32;    // positions a step (y: columns j; state: rows q)
constexpr int NS = 64;    // N columns of a state block
constexpr int MAX_P = 128;
constexpr int MAX_N = 128;
constexpr int SMEM_MAX = 232448;   // opt-in shared memory of a block
constexpr int NO_SAVE = -(1 << 30);
constexpr int PB = 8;     // chunks of TJ positions a prefix batch
constexpr int LDC = 2 * TJ + 1;   // row stride of the C B^T tile

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

// four consecutive elements of shared memory as fp32 (bf16 widened)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

struct Shape {
  int bc, q, h, p, n;
  int n_itiles;   // 64-row tiles of Q
  int y_pt;       // 64-column tiles of P (y and state blocks)
  int y_items;    // y blocks per (head group, chunk): pairs x y_pt
  int st_nt;      // NS-column tiles of N (state items: 2 st_nt y_pt)
  int np;         // N rounded up to 16 bytes: width of the C and B tiles
  int ld;         // their row stride in shared memory (np + 16 bytes)
  bool vec;       // 16-byte cp.async copies
};

__host__ __device__ constexpr int align16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// byte offsets of a block's shared memory (the state block uses b, x, m
// (as xw), cumj, dtj, aj, pa and cl)
struct Layout {
  int c, b, x, cb, m, cumi, cumj, dtj, aj, pa, cl, total;
};

__host__ __device__ inline Layout layout(int g, int ld, int esz) {
  Layout L;
  int off = 0;
  L.c = off;     off += align16(2 * TQ * ld * esz);           // C_i, 2 rows
  L.b = off;     off += align16(2 * TJ * (ld > NS ? ld : NS) * esz);
  L.x = off;     off += align16(2 * g * TJ * TQ * esz);       // x ring
  L.cb = off;    off += align16(TQ * LDC * 4);                // C B^T
  L.m = off;     off += align16(g * TJ * TQ * 4);             // M^T / xw
  L.cumi = off;  off += align16(2 * g * TQ * 4);
  L.cumj = off;  off += align16(g * TJ * 4);
  L.dtj = off;   off += align16(g * TJ * 4);
  L.aj = off;    off += align16(g * TJ * 4);
  L.pa = off;    off += align16(PB * g * TJ * 4);
  L.cl = off;    off += align16(g * 4);
  L.total = off;
  return L;
}

// A tile of rows x width elements into shared memory (row stride ld)
// with plain loads and stores: row r from src + r * stride; rows r >=
// rows_ok and columns c >= cols_ok zero filled.  For shapes the 16-byte
// copies of load_rows / load_x do not take.
template <typename T, int NT>
__device__ __forceinline__ void copy_tile(T* dst, int ld, const T* src,
                                          long long stride, int rows,
                                          int width, int rows_ok,
                                          int cols_ok) {
  for (int e = threadIdx.x; e < rows * width; e += NT) {
    const int r = e / width, c = e - r * width;
    dst[r * ld + c] = r < rows_ok && c < cols_ok ? src[r * stride + c]
                                                 : from_f32<T>(0.f);
  }
}

// dt and round(dt * A) of position q0 + t / G, head h0 + t % G, for
// threads t < TJ G; 0 past Q and for heads past H
template <typename T, int G>
__device__ __forceinline__ void load_dt(const T* __restrict__ dt,
                                        const Shape& s, int bc, int h0,
                                        int q0, float a_h, float& d,
                                        float& a) {
  const int t = threadIdx.x, q = q0 + t / G, h = h0 + t % G;
  d = 0.f;
  a = 0.f;
  if (t < TJ * G && q < s.q && h < s.h) {
    d = to_f32(dt[((long long)bc * s.q + q) * s.h + h]);
    a = round_to<T>(d * a_h);
  }
}

// thread g < G: the cum of TJ positions of head g, a[k] (row, TJ
// values in shared memory) added to `carry` in order, in registers;
// written to out
__device__ __forceinline__ void scan_row(const float* row, float* out,
                                         float& carry) {
  float4 v[TJ / 4];
#pragma unroll
  for (int k = 0; k < TJ / 4; ++k)
    v[k] = reinterpret_cast<const float4*>(row)[k];
#pragma unroll
  for (int k = 0; k < TJ / 4; ++k) {
    v[k].x = carry += v[k].x;
    v[k].y = carry += v[k].y;
    v[k].z = carry += v[k].z;
    v[k].w = carry += v[k].w;
  }
  if (out != nullptr) {
#pragma unroll
    for (int k = 0; k < TJ / 4; ++k)
      reinterpret_cast<float4*>(out)[k] = v[k];
  }
}

// The cumsum of dt * A over positions [0, TJ n_chunks) for the block's G
// heads, added in order by thread g < G for head h0 + g; returns thread
// g's carry (the cum at the end: positions past Q add 0).  The cum of
// positions [save0, save0 + TQ) goes to sv0[g][*], of [save1, ...) to
// sv1 (NO_SAVE: none; both multiples of TQ).  dt comes PB chunks at a
// time (the next batch's loads in flight during this one's scan) into
// pa [PB][G][TJ].  Ends with a barrier.
template <typename T, int G>
__device__ float prefix_cum(const T* __restrict__ dt, const Shape& s,
                            int bc, int h0, float a_h, int n_chunks,
                            float* pa, int save0, float* sv0, int save1,
                            float* sv1) {
  const int t = threadIdx.x;
  float carry = 0.f, d, a[PB];
#pragma unroll
  for (int k = 0; k < PB; ++k)
    load_dt<T, G>(dt, s, bc, h0, k * TJ, a_h, d, a[k]);
  for (int c0 = 0; c0 < n_chunks; c0 += PB) {
    if (t < TJ * G) {
#pragma unroll
      for (int k = 0; k < PB; ++k)
        pa[(k * G + t % G) * TJ + t / G] = a[k];
    }
    if (c0 + PB < n_chunks) {
#pragma unroll
      for (int k = 0; k < PB; ++k)
        load_dt<T, G>(dt, s, bc, h0, (c0 + PB + k) * TJ, a_h, d, a[k]);
    }
    __syncthreads();
    if (t < G) {
      for (int k = 0; k < PB && c0 + k < n_chunks; ++k) {
        const int q0 = (c0 + k) * TJ;   // in a saved tile or outside
        float* out = (unsigned)(q0 - save0) < (unsigned)TQ
                     ? sv0 + t * TQ + q0 - save0
                     : (unsigned)(q0 - save1) < (unsigned)TQ
                     ? sv1 + t * TQ + q0 - save1 : nullptr;
        scan_row(pa + (k * G + t) * TJ, out, carry);
      }
    }
    __syncthreads();
  }
  return carry;
}

// this step's dt (registers) into shared memory
template <int G>
__device__ __forceinline__ void stage_dt(float* dtj, float* aj, float d,
                                         float a) {
  const int t = threadIdx.x;
  if (t < TJ * G) {
    dtj[(t % G) * TJ + t / G] = d;
    aj[(t % G) * TJ + t / G] = a;
  }
}

// thread g < G: the step's cum of head g, carried on
template <int G>
__device__ __forceinline__ void scan_step(const float* aj, float* cumj,
                                          float& carry) {
  const int t = threadIdx.x;
  if (t < G) scan_row(aj + t * TJ, cumj + t * TJ, carry);
}

// Rows [j0, j0 + rows) of B or C, columns [n0, n0 + bw), into rows of
// ldb; and x rows [j0, j0 + TJ) of G heads from h0 (64 columns of P from
// p0) into a ring slot [G][TJ][TQ].  On the vec path each thread copies
// fixed 16-byte chunks at offsets from the tile's base pointer found
// with shifts (a row of bw elements is a power of two of chunks, at most
// NT); else copy_tile's plain loads.
template <typename T, int NT>
__device__ __forceinline__ void load_rows(const T* __restrict__ Bm,
                                          const Shape& s, int bc, int j0,
                                          int rows, int n0, int bw, int ldb,
                                          T* bs) {
  constexpr int CE = 16 / sizeof(T);
  const int rows_ok = min(rows, s.q - j0);
  const T* src = Bm + ((long long)bc * s.q + j0) * s.n + n0;
  if (!s.vec) {
    copy_tile<T, NT>(bs, ldb, src, s.n, rows, bw, rows_ok, s.n - n0);
    return;
  }
  const int lg = __ffs(bw / CE) - 1;            // log2 of chunks a row
  const int col = (threadIdx.x & ((1 << lg) - 1)) * CE;
  const bool col_ok = n0 + col < s.n;
  for (int r = threadIdx.x >> lg; r < rows; r += NT >> lg) {
    const bool ok = r < rows_ok && col_ok;
    hopper::cp_async16(hopper::smem_addr(bs + r * ldb + col),
                       ok ? src + r * s.n + col : src, ok);
  }
}

template <typename T, int NT, int G>
__device__ __forceinline__ void load_x(const T* __restrict__ x,
                                       const Shape& s, int bc, int h0,
                                       int p0, int j0, T* xs) {
  constexpr int CE = 16 / sizeof(T), CPX = TQ / CE;
  const int rows_ok = min(TJ, s.q - j0);
  const T* src = x + (((long long)bc * s.q + j0) * s.h + h0) * s.p + p0;
  if (!s.vec) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      copy_tile<T, NT>(xs + g * TJ * TQ, TQ, src + g * s.p,
                       (long long)s.h * s.p, TJ, TQ,
                       h0 + g < s.h ? rows_ok : 0, s.p - p0);
    return;
  }
  // chunk e of the slot: 16 bytes at e CE
#pragma unroll
  for (int k = 0; k < G * TJ * CPX / NT; ++k) {
    const int e = threadIdx.x + k * NT;
    const int g = e / (TJ * CPX), r = e / CPX % TJ, c = e % CPX * CE;
    const bool ok = r < rows_ok && h0 + g < s.h && p0 + c < s.p;
    hopper::cp_async16(hopper::smem_addr(xs + e * CE),
                       ok ? src + (r * s.h + g) * s.p + c : src, ok);
  }
}

// a y thread's 8 x 8 outputs of row tile it (rows r8.., columns p0 + c4..
// and p0 + 32 + c4..) of head h, stored and zeroed
template <typename T>
__device__ __forceinline__ void store_y(float (&acc)[8][8], T* __restrict__ y,
                                        const Shape& s, long long row0,
                                        int h, int it, int p0, int r8,
                                        int c4) {
  const bool live = h < s.h;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = it * TQ + r8 + a;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int col = p0 + (b < 4 ? c4 + b : 32 + c4 + b - 4);
      if (live && i < s.q && col < s.p)
        y[((row0 + i) * s.h + h) * s.p + col] = from_f32<T>(acc[a][b]);
      acc[a][b] = 0.f;
    }
  }
}

// 64 rows i of y for a pair of row tiles (or one), G heads, 64 columns
// of P
template <typename T, int G>
__device__ void y_block(const T* __restrict__ x, const T* __restrict__ dt,
                        const T* __restrict__ A, const T* __restrict__ Bm,
                        const T* __restrict__ Cm, T* __restrict__ y,
                        const Shape& s, int bc, int h0, int pair, int pt,
                        unsigned char* smem) {
  constexpr int NT = 64 * G;
  constexpr int RK = TQ * 16 / NT;   // C B^T rows a thread (4 columns)
  constexpr int IPT = 32 / G;        // M entries (i) a thread, per head
  constexpr int TPJ = TQ / IPT;      // threads per column j of M
  const Layout L = layout(G, s.ld, sizeof(T));
  T* cs = reinterpret_cast<T*>(smem + L.c);
  T* bs = reinterpret_cast<T*>(smem + L.b);
  T* xs = reinterpret_cast<T*>(smem + L.x);
  float* cbs = reinterpret_cast<float*>(smem + L.cb);
  float* ms = reinterpret_cast<float*>(smem + L.m);
  float* cumi = reinterpret_cast<float*>(smem + L.cumi);
  float* cumj = reinterpret_cast<float*>(smem + L.cumj);
  float* dtj = reinterpret_cast<float*>(smem + L.dtj);
  float* aj = reinterpret_cast<float*>(smem + L.aj);
  float* pa = reinterpret_cast<float*>(smem + L.pa);

  const int t = threadIdx.x, ld = s.ld;
  const int tb = s.n_itiles - 1 - pair, ta = pair;   // tb first
  const int n_rt = ta == tb ? 1 : 2;
  const int p0 = pt * TQ;
  const long long row0 = (long long)bc * s.q;
  const float a_h = t < TJ * G && h0 + t % G < s.h
                    ? to_f32(A[h0 + t % G]) : 0.f;
  // column steps of each row tile: up to its diagonal, not past Q; C B^T
  // is formed at even steps (local to the row tile) for 2 TJ columns
  const int ns0 = (min((tb + 1) * TQ, s.q) + TJ - 1) / TJ;
  const int ns1 = n_rt == 2 ? (min((ta + 1) * TQ, s.q) + TJ - 1) / TJ : 0;
  const int n_steps = ns0 + ns1;

  // C rows of both row tiles, B for the first C B^T and x for step 0 in
  // flight during the prefix walk
  for (int r = 0; r < n_rt; ++r)
    load_rows<T, NT>(Cm, s, bc, (r == 0 ? tb : ta) * TQ, TQ, 0, s.np, ld,
                     cs + r * TQ * ld);
  load_rows<T, NT>(Bm, s, bc, 0, 2 * TJ, 0, s.np, ld, bs);
  load_x<T, NT, G>(x, s, bc, h0, p0, 0, xs);
  hopper::cp_async_commit();

  for (int e = t; e < 2 * G * TQ; e += NT) cumi[e] = 0.f;   // rows past Q
  prefix_cum<T, G>(dt, s, bc, h0, a_h, ns0, pa, tb * TQ, cumi,
                   n_rt == 2 ? ta * TQ : NO_SAVE, cumi + G * TQ);

  // thread roles
  const int cb_i = t / 16, cb_j = t % 16;                   // C B^T
  const int m_j = t / TPJ, m_i0 = (t % TPJ) * IPT;          // M
  const int hg = t / 64, r8 = (t % 64) / 8 * 8, c4 = t % 8 * 4;   // M x

  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;

  float carry = 0.f, d, a;
  load_dt<T, G>(dt, s, bc, h0, 0, a_h, d, a);
  for (int f = 0; f < n_steps; ++f) {
    const int r = f < ns0 ? 0 : 1;
    const int it = r == 0 ? tb : ta;
    const int l = f - (r ? ns0 : 0);          // step within the row tile
    const int j0 = l * TJ;
    const int slot = f & 1;
    if (f == ns0) {        // the second row tile starts over from j = 0
      store_y<T>(acc, y, s, row0, h0 + hg, tb, p0, r8, c4);
      carry = 0.f;
    }
    hopper::cp_async_wait<0>();
    stage_dt<G>(dtj, aj, d, a);
    __syncthreads();       // tiles landed; step f - 1 done everywhere
    if (f + 1 < n_steps) {
      const int jn = (f + 1 - (f + 1 < ns0 ? 0 : ns0)) * TJ;
      load_x<T, NT, G>(x, s, bc, h0, p0, jn, xs + (slot ^ 1) * G * TJ * TQ);
      load_dt<T, G>(dt, s, bc, h0, jn, a_h, d, a);
    }
    hopper::cp_async_commit();
    scan_step<G>(aj, cumj, carry);

    // C_i B_j^T for columns [j0, j0 + 2 TJ), summed over N in order:
    // rows cb_i + (NT / 16) k, columns cb_j + 16 m
    if ((l & 1) == 0) {
      const T* ct = cs + r * TQ * ld + cb_i * ld;
      const T* bt = bs + cb_j * ld;
      float sc[RK][4];
#pragma unroll
      for (int k = 0; k < RK; ++k)
#pragma unroll
        for (int m = 0; m < 4; ++m) sc[k][m] = 0.f;
#pragma unroll 2
      for (int n = 0; n < s.np; n += 4) {
        float4 b[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) b[m] = load4(bt + 16 * m * ld + n);
#pragma unroll
        for (int k = 0; k < RK; ++k) {
          const float4 c = load4(ct + (NT / 16) * k * ld + n);
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            sc[k][m] = fmaf(c.x, b[m].x, sc[k][m]);
            sc[k][m] = fmaf(c.y, b[m].y, sc[k][m]);
            sc[k][m] = fmaf(c.z, b[m].z, sc[k][m]);
            sc[k][m] = fmaf(c.w, b[m].w, sc[k][m]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < RK; ++k)
#pragma unroll
        for (int m = 0; m < 4; ++m)
          cbs[(cb_i + (NT / 16) * k) * LDC + cb_j + 16 * m] = sc[k][m];
    }
    __syncthreads();       // C B^T and the step's cum ready

    // B for the next C B^T: this row tile's next pair of steps, else the
    // other row tile's first
    if ((l & 1) == 0) {
      const int jb = r == 0 ? (l + 2 < ns0 ? j0 + 2 * TJ : n_rt == 2 ? 0 : -1)
                            : (l + 2 < ns1 ? j0 + 2 * TJ : -1);
      if (jb >= 0) load_rows<T, NT>(Bm, s, bc, jb, 2 * TJ, 0, s.np, ld, bs);
      hopper::cp_async_commit();
    }

    // M^T[g][j][i] = round((C B^T * exp(cum_i - cum_j)) * dt_j), i >= j
    {
      const int qj = j0 + m_j;
      float cb[IPT];
#pragma unroll
      for (int u = 0; u < IPT; ++u)
        cb[u] = cbs[(m_i0 + u) * LDC + (l & 1) * TJ + m_j];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float cj = cumj[g * TJ + m_j], dj = dtj[g * TJ + m_j];
        const float* ci = cumi + (r * G + g) * TQ + m_i0;
        float* mt = ms + (g * TJ + m_j) * TQ + m_i0;
#pragma unroll
        for (int u = 0; u < IPT; u += 4) {
          float o[4];
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int i = it * TQ + m_i0 + u + v;
            o[v] = qj <= i && i < s.q
                   ? round_to<T>((cb[u + v] * expf(ci[u + v] - cj)) * dj)
                   : 0.f;
          }
          *reinterpret_cast<float4*>(mt + u) =
              make_float4(o[0], o[1], o[2], o[3]);
        }
      }
    }
    __syncthreads();       // M ready

    // y[g] += M[g] x_j[g]: rows r8.., columns c4.. and 32 + c4..
    {
      const float* mp = ms + hg * TJ * TQ + r8;
      const T* xp = xs + slot * G * TJ * TQ + hg * TJ * TQ + c4;
#pragma unroll 4
      for (int j = 0; j < TJ; ++j) {
        const float4 m0 = *reinterpret_cast<const float4*>(mp + j * TQ);
        const float4 m1 = *reinterpret_cast<const float4*>(mp + j * TQ + 4);
        const float4 x0 = load4(xp + j * TQ), x1 = load4(xp + j * TQ + 32);
        const float mv[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
        const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int a8 = 0; a8 < 8; ++a8)
#pragma unroll
          for (int b8 = 0; b8 < 8; ++b8)
            acc[a8][b8] = fmaf(mv[a8], xv[b8], acc[a8][b8]);
      }
    }
  }
  store_y<T>(acc, y, s, row0, h0 + hg, n_rt == 2 ? ta : tb, p0, r8, c4);
}

// 64 rows p and NS columns n of the state st for GS = G / 2 heads from
// h0 (128 threads a head)
template <typename T, int G>
__device__ void state_block(const T* __restrict__ x,
                            const T* __restrict__ dt,
                            const T* __restrict__ A,
                            const T* __restrict__ Bm, T* __restrict__ st,
                            const Shape& s, int bc, int h0, int pt, int nt,
                            unsigned char* smem) {
  constexpr int NT = 64 * G, GS = G / 2, CE = 16 / sizeof(T);
  constexpr int CPX = TQ / CE;
  if (h0 >= s.h) return;   // a head group's second half past H
  const Layout L = layout(G, s.ld, sizeof(T));
  T* bs = reinterpret_cast<T*>(smem + L.b);        // [2][TJ][NS]
  T* xs = reinterpret_cast<T*>(smem + L.x);        // [2][GS][TJ][TQ]
  float* xw = reinterpret_cast<float*>(smem + L.m);  // [GS][TJ][TQ]
  float* cumj = reinterpret_cast<float*>(smem + L.cumj);
  float* dtj = reinterpret_cast<float*>(smem + L.dtj);
  float* aj = reinterpret_cast<float*>(smem + L.aj);
  float* pa = reinterpret_cast<float*>(smem + L.pa);
  float* cl = reinterpret_cast<float*>(smem + L.cl);

  const int t = threadIdx.x;
  const int p0 = pt * TQ, n0 = nt * NS;
  const float a_h = t < TJ * GS && h0 + t % GS < s.h
                    ? to_f32(A[h0 + t % GS]) : 0.f;
  const int n_steps = (s.q + TJ - 1) / TJ;

  load_rows<T, NT>(Bm, s, bc, 0, TJ, n0, NS, NS, bs);
  load_x<T, NT, GS>(x, s, bc, h0, p0, 0, xs);
  hopper::cp_async_commit();
  {
    const float last = prefix_cum<T, GS>(dt, s, bc, h0, a_h, n_steps, pa,
                                         NO_SAVE, nullptr, NO_SAVE,
                                         nullptr);
    if (t < GS) cl[t] = last;   // read after the next two barriers
  }

  const int hg = t / 128, r8 = t % 128 / 16 * 8, c4 = t % 16 * 4;
  float acc[8][4];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  float carry = 0.f, d, a;
  load_dt<T, GS>(dt, s, bc, h0, 0, a_h, d, a);
  for (int f = 0; f < n_steps; ++f) {
    const int slot = f & 1;
    hopper::cp_async_wait<0>();
    stage_dt<GS>(dtj, aj, d, a);
    __syncthreads();
    if (f + 1 < n_steps) {
      load_rows<T, NT>(Bm, s, bc, (f + 1) * TJ, TJ, n0, NS, NS,
                    bs + (slot ^ 1) * TJ * NS);
      load_x<T, NT, GS>(x, s, bc, h0, p0, (f + 1) * TJ,
                        xs + (slot ^ 1) * GS * TJ * TQ);
      load_dt<T, GS>(dt, s, bc, h0, (f + 1) * TJ, a_h, d, a);
    }
    hopper::cp_async_commit();
    scan_step<GS>(aj, cumj, carry);
    __syncthreads();       // the step's cum ready

    // xw[g][q][p] = round(x * (exp(cum_last - cum_q) * dt_q)), a 16-byte
    // chunk e of x (CE elements of row e / CPX) at a time: consecutive
    // threads on consecutive chunks
    {
      const T* src = xs + slot * GS * TJ * TQ;
#pragma unroll
      for (int k = 0; k < GS * TJ * CPX / NT; ++k) {
        const int e = t + k * NT, row = e / CPX, g = row / TJ;
        const float w = expf(cl[g] - cumj[row]) * dtj[row];
#pragma unroll
        for (int u = 0; u < CE; u += 4) {
          const float4 v = load4(src + e * CE + u);
          *reinterpret_cast<float4*>(xw + e * CE + u) = make_float4(
              round_to<T>(v.x * w), round_to<T>(v.y * w),
              round_to<T>(v.z * w), round_to<T>(v.w * w));
        }
      }
    }
    __syncthreads();       // xw ready

    // st[g] += xw[g]^T B: rows p r8.., columns n c4..
    {
      const float* ap = xw + hg * TJ * TQ + r8;
      const T* bp = bs + slot * TJ * NS + c4;
#pragma unroll 4
      for (int q = 0; q < TJ; ++q) {
        const float4 a0 = *reinterpret_cast<const float4*>(ap + q * TQ);
        const float4 a1 = *reinterpret_cast<const float4*>(ap + q * TQ + 4);
        const float4 bv = load4(bp + q * NS);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int a8 = 0; a8 < 8; ++a8)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            acc[a8][b] = fmaf(av[a8], b4[b], acc[a8][b]);
      }
    }
  }

  const int h = h0 + hg;
  if (h >= s.h) return;
#pragma unroll
  for (int a8 = 0; a8 < 8; ++a8) {
    const int p = p0 + r8 + a8;
    if (p >= s.p) break;
    T* out = st + (((long long)bc * s.h + h) * s.p + p) * s.n;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int n = n0 + c4 + b;
      if (n < s.n) out[n] = from_f32<T>(acc[a8][b]);
    }
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(64 * G, 1)
ssd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                 const T* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, T* __restrict__ y,
                 T* __restrict__ st, Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h0 = blockIdx.x * G, bc = blockIdx.y, item = blockIdx.z;
  if (item < s.y_items)
    y_block<T, G>(x, dt, A, Bm, Cm, y, s, bc, h0, item / s.y_pt,
                  item % s.y_pt, smem);
  else
    state_block<T, G>(x, dt, A, Bm, st, s, bc,
                      h0 + (item - s.y_items) % 2 * (G / 2),
                      (item - s.y_items) / 2 / s.st_nt,
                      (item - s.y_items) / 2 % s.st_nt, smem);
}

// Completes s for a launch of g heads a y block with elements of esz
// bytes and sets its grid; returns the block's shared memory in bytes,
// or 0 for a launch this file refuses (widths, G, shared memory, grid).
inline int prepare(int g, int esz, Shape& s, dim3& grid) {
  if (s.p < 1 || s.p > MAX_P || s.n < 1 || s.n > MAX_N || s.q < 1
      || s.bc < 1 || s.bc > 65535 || s.h < 1 || s.h > 65535
      || (g != 2 && g != 4))
    return 0;
  const int ce = 16 / esz;
  s.n_itiles = (s.q + TQ - 1) / TQ;
  s.y_pt = (s.p + TQ - 1) / TQ;
  s.st_nt = (s.n + NS - 1) / NS;
  s.np = (s.n + ce - 1) / ce * ce;
  s.ld = s.np + ce;
  s.y_items = (s.n_itiles + 1) / 2 * s.y_pt;
  const long long items = s.y_items + 2LL * s.y_pt * s.st_nt;
  const int smem = layout(g, s.ld, esz).total;
  if (smem > SMEM_MAX || items > 65535) return 0;
  grid = dim3((s.h + g - 1) / g, s.bc, (unsigned)items);
  return smem;
}

template <typename T, int G>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, void* y, void* st,
                   Shape s, int smem, dim3 grid, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_MAX);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x)
      | reinterpret_cast<uintptr_t>(Bm) | reinterpret_cast<uintptr_t>(Cm);
  constexpr int CE = 16 / sizeof(T);
  const int cpr = s.np / CE;     // chunks of a C / B row: a power of two
  s.vec = bits % 16 == 0 && s.p % CE == 0 && s.n % CE == 0
          && (cpr & (cpr - 1)) == 0;
  ssd_chunk_kernel<T, G><<<grid, 64 * G, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), static_cast<T*>(st), s);
  return cudaGetLastError();
}

Shape shape_of(int bc, int q, int h, int p, int n) {
  Shape s{};
  s.bc = bc; s.q = q; s.h = h; s.p = p; s.n = n;
  return s;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Contiguous x (bc, q, h, p),
// dt (bc, q, h), A (h), B and C (bc, q, n); y like x, st (bc, h, p, n);
// 1 <= p, n <= 128; 1 <= bc, h <= 65535; q >= 1.  g: heads a y block,
// 2 or 4, as ops.plan chooses (a state block takes g / 2; the tiles are
// this file's); a launch whose shared memory or grid does not fit is
// refused.  Returns a cudaError_t: 0 after a launch that the runtime
// accepted.
extern "C" int ssd_chunk_launch(int dtype, const void* x, const void* dt,
                                const void* A, const void* Bm, const void* Cm,
                                void* y, void* st, int bc, int q, int h,
                                int p, int n, int g, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  Shape s = shape_of(bc, q, h, p, n);
  dim3 grid;
  const int smem = prepare(g, dtype == 0 ? 4 : 2, s, grid);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(g == 2
        ? launch<float, 2>(x, dt, A, Bm, Cm, y, st, s, smem, grid, strm)
        : launch<float, 4>(x, dt, A, Bm, Cm, y, st, s, smem, grid, strm));
  return (int)(g == 2
      ? launch<__nv_bfloat16, 2>(x, dt, A, Bm, Cm, y, st, s, smem, grid, strm)
      : launch<__nv_bfloat16, 4>(x, dt, A, Bm, Cm, y, st, s, smem, grid,
                                 strm));
}

// What ssd_chunk_launch would launch with the same arguments: out[0] the
// block's shared memory in bytes, out[1..3] the grid.  Returns
// cudaErrorInvalidValue where the launch would be refused.
extern "C" int ssd_chunk_query(int dtype, int bc, int q, int h, int p,
                               int n, int g, int* out) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  Shape s = shape_of(bc, q, h, p, n);
  dim3 grid;
  const int smem = prepare(g, dtype == 0 ? 4 : 2, s, grid);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  out[0] = smem;
  out[1] = (int)grid.x;
  out[2] = (int)grid.y;
  out[3] = (int)grid.z;
  return 0;
}
