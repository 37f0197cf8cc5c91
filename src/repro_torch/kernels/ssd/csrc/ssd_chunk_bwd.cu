// Backward of the Mamba2 SSD intra-chunk step (fp32): the gradients of
// ssd_chunk.cu's function.
//
// Replaces no TPU kernel.  The reference trains by differentiating plain
// jnp (src/repro/models/transformer/layers.py::ssd_chunked), so XLA
// writes its backward; the port runs the intra-chunk step through
// ssd_chunk.cu, and this is the kernel its torch.autograd.Function
// (ops.SsdChunk) calls for the gradients.
//
// Per (chunk, head), with a = dt A, cum its inclusive cumsum along the
// chunk, L_ij = exp(cum_i - cum_j) for i >= j (0 above), CB_ij = C_i.B_j,
// M_ij = CB_ij L_ij dt_j and w_j = exp(cum_last - cum_j) dt_j, the
// forward is y_i = sum_j M_ij x_j and st = sum_j w_j x_j (x) B_j.  For
// the output gradients dy and dst:
//   dM_ij  = dy_i . x_j;   dx_j = sum_i M_ij dy_i + w_j (dst B_j)
//   dCB_ij = sum_h dM_ij L_ij dt_j  (B and C have no head axis)
//   dC = dCB B;   dB = dCB^T C + sum_h w_j dst^T x_j
//   dS = dM M:  dcum_i += sum_j dS_ij,  dcum_j -= sum_i dS_ij
//   ddt_j += sum_i dM_ij CB_ij L_ij  (taken directly: nothing divides by dt)
//   u_j = x_j . (dst B_j):  ddt_j += u_j exp(cum_last - cum_j),
//     dcum_j -= u_j w_j,  dcum_last += sum_j u_j w_j
// and then da = the reverse cumsum of dcum, ddt += da A, dA = sum da dt.
// exp is taken only where i >= j, as in the forward: at a real training
// shape cum_i - cum_j above the diagonal passes 88 and exp of it would
// overflow (the reference's jax.grad is NaN there for that reason).
//
// One launch, two kinds of block, 256 threads each, grid (ceil(H / G),
// BC, 2 x n_tiles) over 64-position tiles of the chunk:
//  - a column block owns tile jt of positions j and a group of G heads
//    and walks the row tiles i >= jt.  Per row tile it forms C_i B_j^T
//    once for the group, then per head dM (dy_i x_j^T, both from shared
//    memory), L, M = (CB L) dt_j as the forward forms it, dS,
//    the column sums of dS and of dM CB L (registers, across all row
//    tiles), dCB summed over the group's heads (registers), and dx_j +=
//    M^T dy_i (registers, all G heads); after the heads dB_j += dCB^T C_i.
//    After the walk it adds the state terms per head (dst B_j, u_j, w_j
//    dst^T x_j) and writes dx, the group's share of dB, ddt's partial
//    (column sums of dM CB L plus u e), dcum's column part (-sum_i dS - u
//    w) and u w;
//  - a row block owns tile it of positions i and the same group and walks
//    the column tiles j <= it: C B^T, then per head dM and M again, the
//    row sums of dS and dCB summed over the heads; dC_i += dCB B_j.  It
//    writes the group's share of dC and dcum's row part.
// Items of equal length pair up and run longest first (blockIdx.z: column
// tile 0, row tile n - 1, column tile 1, ...), as the forward's pairs do.
// Within a block every 64 x 64 product gives a thread 4 x 4 outputs at
// rows ty + 16 a and columns tx + 16 b (ty = thread / 16, tx = thread %
// 16); the accumulating products (dx, dB, dC, the state terms) give it 4
// rows and P or N / 16 columns.  No atomics: every output and partial has
// one owner, every sum runs in a fixed order, and two calls give the same
// bits.  Nothing Q x Q goes to device memory; nothing is sized by Q
// (ssd_chunked takes Q = S when no tile of 64 or more divides S, e.g. Q =
// 511 or 1030): rows and columns past Q are zero-filled loads that are
// never stored.  P and N are padded to 64 or 128 in shared memory (PW,
// NW); G = 4 heads a group at PW = 64, 2 at PW = 128 (the registers of
// dx).  ops.bwd_plan computes the same grid, G and shared memory, and
// ssd_chunk_bwd_query reports what this file computes.
//
// The decays are the forward's: dt * A in fp32, the cumsum added in order
// by one thread per head, 64 positions at a time, carried from tile to
// tile (a column block walks the prefix to its tile, then on with its
// row tiles; a row block walks to its tile for cum_i, then again from 0
// with its column tiles), C B^T summed over N in order, M = (CB * exp(cum_i
// - cum_j)) * dt_j, w = exp(cum_last - cum_j) * dt_j.  The finish, O(BC Q
// H + groups BC Q N), is torch glue in the wrapper (ops.ssd_chunk_bwd):
// the reverse cumsum of dcum, ddt's A term, dA's sum over chunks and
// positions, and the sums of dB and dC over head groups.
//
// What bounds it on an H100: operations.  The function needs, per chunk
// and head, 2 Q^2 P for dM and M^T dy (the causal half each) and 4 Q P N
// for the state terms, and per chunk 3 Q^2 N for C B^T, dC and dB: 4.5
// GFLOP at mamba2-370m's training fold (8, 256, 32, 64, 128), 0.07 ms at
// the 67 TFLOP/s fp32 FMA peak, against about 60 MB.  This version issues
// C B^T and dM twice (column and row blocks), the full diagonal tiles and
// the padded widths, as IEEE fp32 FMAs on the CUDA cores from shared
// memory, with one block an SM and several barriers a head: a simple
// kernel that is right first.  On an H100 (700 W) it takes about 0.59 ms
// device at mamba2's fold, 11% of the bound, and the torch finish 0.09
// ms more (PERF.md, row 8).  Tensor cores for its five products, and the
// finish folded into a second pass of this file, are later work.
//
// Plain C interface, loaded with ctypes; the launch goes on the caller's
// stream, allocates nothing (the wrapper passes every output and
// partial), and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int T = 64;         // positions a tile (rows i and columns j)
constexpr int THREADS = 256;  // 16 x 16
constexpr int LDD = T + 1;    // row stride of the M and dCB tiles
constexpr int MAX_P = 128;
constexpr int MAX_N = 128;
constexpr int SMEM_MAX = 232448;

struct Shape {
  int bc, q, h, p, n;
  int n_tiles;   // 64-position tiles of Q
};

__host__ __device__ constexpr int align16f(int floats) {
  return (floats + 3) / 4 * 4;   // floats, rounded to 16 bytes
}

// float offsets of a block's shared memory.  fix: the tile a block owns
// (column: B_j; row: C_i); res: G heads of the owned tile's x_j or dy_i;
// walk: the walked tile (column: C_i; row: B_j); ph: one head of the
// walked side (column: dy_i; row: x_j); ms: M (column blocks); dcb: dCB;
// then G x 64 arrays of cum, dt and sums.  A column block's state phase
// reuses walk..dcb for dst (PW x NW) and the column-sum reduction.
struct Layout {
  int fix, res, walk, ph, ms, dcb, cumf, dtf, cumw, dtw, at, us, ss, sd, cl;
  int dst, red, total;
};

__host__ __device__ inline Layout layout(int pw, int nw, int g) {
  const int ldp = pw + 4, ldn = nw + 4;
  Layout L;
  int off = 0;
  L.fix = off;   off += align16f(T * ldn);
  L.res = off;   off += align16f(g * T * ldp);
  L.walk = off;  off += align16f(T * ldn);
  L.ph = off;    off += align16f(T * ldp);
  L.ms = off;    off += align16f(T * LDD);
  L.dcb = off;   off += align16f(T * LDD);
  const int alias_end = off;
  L.cumf = off;  off += align16f(g * T);
  L.dtf = off;   off += align16f(g * T);
  L.cumw = off;  off += align16f(g * T);
  L.dtw = off;   off += align16f(g * T);
  L.at = off;    off += align16f(g * T);
  L.us = off;    off += align16f(g * T);
  L.ss = off;    off += align16f(g * T);
  L.sd = off;    off += align16f(g * T);
  L.cl = off;    off += align16f(g);
  L.total = off;
  L.dst = L.walk;
  L.red = L.dst + align16f(pw * ldn);
  // the state phase's aliases must end within walk..dcb
  if (L.red + 2 * g * 16 * T > alias_end) L.total = -1;
  return L;
}

// rows x W floats into shared memory (row stride ld) from src (row
// stride `stride`), zero at rows >= rows_ok and columns >= cols_ok
template <int W>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* __restrict__ src,
                                          long long stride, int rows,
                                          int rows_ok, int cols_ok) {
  for (int e = threadIdx.x; e < rows * W; e += THREADS) {
    const int r = e / W, c = e % W;
    dst[r * ld + c] = r < rows_ok && c < cols_ok ? src[r * stride + c] : 0.f;
  }
}

// dt and a = dt * A of the 64 positions from q0 for the group's G heads
// into at[g][r] (and dtout[g][r] unless null); 0 past Q and for heads
// past H
template <int G>
__device__ __forceinline__ void stage_dt(const float* __restrict__ dt,
                                         const float* __restrict__ A,
                                         const Shape& s, int bc, int h0,
                                         int q0, float* at, float* dtout) {
  const int t = threadIdx.x;
  if (t < G * T) {
    const int r = t / G, g = t % G, q = q0 + r, h = h0 + g;
    float d = 0.f, a = 0.f;
    if (q < s.q && h < s.h) {
      d = dt[((long long)bc * s.q + q) * s.h + h];
      a = d * A[h];
    }
    at[g * T + r] = a;
    if (dtout != nullptr) dtout[g * T + r] = d;
  }
}

// thread g < G: the cum of head g over the staged 64 positions, added to
// carry in order; written to out[g][*] (and out2) unless null
template <int G>
__device__ __forceinline__ void scan(const float* at, float* out,
                                     float* out2, float& carry) {
  const int t = threadIdx.x;
  if (t < G) {
    const float* row = at + t * T;
    for (int r = 0; r < T; ++r) {
      carry += row[r];
      if (out != nullptr) out[t * T + r] = carry;
      if (out2 != nullptr) out2[t * T + r] = carry;
    }
  }
}

// carry of thread g < G over the first n_tiles tiles, nothing stored
template <int G>
__device__ void prefix(const float* __restrict__ dt,
                       const float* __restrict__ A, const Shape& s, int bc,
                       int h0, int n_tiles, float* at, float& carry) {
  for (int k = 0; k < n_tiles; ++k) {
    __syncthreads();   // the last scan is done with at
    stage_dt<G>(dt, A, s, bc, h0, k * T, at, nullptr);
    __syncthreads();
    scan<G>(at, nullptr, nullptr, carry);
  }
}

// acc[a][b] = sum over W columns of X[ty + 16 a] . Y[tx + 16 b], in
// column order (X, Y tiles of 64 rows of stride ld)
template <int W>
__device__ __forceinline__ void dot_tile(const float* xs, const float* ys,
                                         int ld, float (&acc)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 2
  for (int k = 0; k < W; k += 4) {
    float4 xv[4], yv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      xv[a] = *reinterpret_cast<const float4*>(xs + (ty + 16 * a) * ld + k);
#pragma unroll
    for (int b = 0; b < 4; ++b)
      yv[b] = *reinterpret_cast<const float4*>(ys + (tx + 16 * b) * ld + k);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        acc[a][b] = fmaf(xv[a].x, yv[b].x, acc[a][b]);
        acc[a][b] = fmaf(xv[a].y, yv[b].y, acc[a][b]);
        acc[a][b] = fmaf(xv[a].z, yv[b].z, acc[a][b]);
        acc[a][b] = fmaf(xv[a].w, yv[b].w, acc[a][b]);
      }
  }
}

// acc[a][c] += sum over 64 k of W[k][ty + 16 a] Y[k][tx + 16 c]: W a tile
// of stride LDD (M or dCB read by columns, or dCB^T), Y rows of stride ly
template <int NC, bool TRANS>
__device__ __forceinline__ void add_product(const float* w, const float* y,
                                            int ly, float (&acc)[4][NC]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int k = 0; k < T; ++k) {
    float wv[4], yv[NC];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      wv[a] = TRANS ? w[(ty + 16 * a) * LDD + k] : w[k * LDD + ty + 16 * a];
#pragma unroll
    for (int c = 0; c < NC; ++c) yv[c] = y[k * ly + tx + 16 * c];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[a][c] = fmaf(wv[a], yv[c], acc[a][c]);
  }
}

template <int PW, int NW>
struct Cfg {
  static constexpr int G = PW == 64 ? 4 : 2;
  static constexpr int LDP = PW + 4, LDN = NW + 4;
  static constexpr int PC = PW / 16, NC = NW / 16;
};

// -- column blocks: dx, dB's share, the column sums ------------------------

template <int PW, int NW>
__device__ void column_block(const float* __restrict__ x,
                             const float* __restrict__ dt,
                             const float* __restrict__ A,
                             const float* __restrict__ Bm,
                             const float* __restrict__ Cm,
                             const float* __restrict__ dy,
                             const float* __restrict__ dst,
                             float* __restrict__ dx, float* __restrict__ ddtp,
                             float* __restrict__ dcc, float* __restrict__ uwo,
                             float* __restrict__ dBp, const Shape& s,
                             int grp, int bc, int jt, float* smem) {
  using C = Cfg<PW, NW>;
  constexpr int G = C::G, LDP = C::LDP, LDN = C::LDN;
  const Layout Lo = layout(PW, NW, G);
  float* const bs = smem + Lo.fix;
  float* const xs = smem + Lo.res;
  float* const cs = smem + Lo.walk;
  float* const dys = smem + Lo.ph;
  float* const ms = smem + Lo.ms;
  float* const dcbs = smem + Lo.dcb;
  float* const cumj = smem + Lo.cumf;
  float* const dtj = smem + Lo.dtf;
  float* const cumi = smem + Lo.cumw;
  float* const at = smem + Lo.at;
  float* const us = smem + Lo.us;
  float* const ss = smem + Lo.ss;
  float* const sd = smem + Lo.sd;
  float* const cl = smem + Lo.cl;

  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int h0 = grp * G, j0 = jt * T;
  const int rows_j = min(T, s.q - j0);
  const long long row0 = (long long)bc * s.q;

  // B_j and x_j of the group's heads
  load_tile<NW>(bs, LDN, Bm + (row0 + j0) * s.n, s.n, T, rows_j, s.n);
#pragma unroll
  for (int g = 0; g < G; ++g)
    load_tile<PW>(xs + g * T * LDP, LDP,
                  x + ((row0 + j0) * s.h + h0 + g) * s.p,
                  (long long)s.h * s.p, T, h0 + g < s.h ? rows_j : 0, s.p);
  float carry = 0.f;
  prefix<G>(dt, A, s, bc, h0, jt, at, carry);

  float dxa[G][4][C::PC], dba[4][C::NC], dcb[4][4], colS[G][4], colD[G][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < C::NC; ++c) dba[a][c] = 0.f;
#pragma unroll
    for (int b = 0; b < 4; ++b) dcb[a][b] = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      colS[g][a] = colD[g][a] = 0.f;
#pragma unroll
      for (int c = 0; c < C::PC; ++c) dxa[g][a][c] = 0.f;
    }
  }

  for (int it = jt; it < s.n_tiles; ++it) {
    const int i0 = it * T;
    __syncthreads();   // the last tile's readers of cs, dys, ms, dcbs, at
    load_tile<NW>(cs, LDN, Cm + (row0 + i0) * s.n, s.n, T, min(T, s.q - i0),
                  s.n);
    stage_dt<G>(dt, A, s, bc, h0, i0, at, it == jt ? dtj : nullptr);
    __syncthreads();
    scan<G>(at, cumi, it == jt ? cumj : nullptr, carry);
    __syncthreads();

    float cb[4][4];
    dot_tile<NW>(cs, bs, LDN, cb);       // C_i B_j^T, summed over N in order

#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int h = h0 + g;
      if (h >= s.h) continue;            // the same for the whole block
      __syncthreads();   // the last head's readers of dys and ms are done
      load_tile<PW>(dys, LDP, dy + ((row0 + i0) * s.h + h) * s.p,
                    (long long)s.h * s.p, T, min(T, s.q - i0), s.p);
      __syncthreads();
      float dm[4][4];
      dot_tile<PW>(dys, xs + g * T * LDP, LDP, dm);   // dy_i . x_j
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int il = ty + 16 * a, i = i0 + il;
        const float ci = cumi[g * T + il];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int jl = tx + 16 * b, j = j0 + jl;
          const bool live = i >= j && i < s.q;
          const float l = live ? expf(ci - cumj[g * T + jl]) : 0.f;
          const float dj = dtj[g * T + jl];
          const float cbl = cb[a][b] * l;
          const float m = cbl * dj;
          colS[g][b] += dm[a][b] * m;
          colD[g][b] += dm[a][b] * cbl;
          dcb[a][b] += dm[a][b] * l * dj;
          ms[il * LDD + jl] = m;
        }
      }
      __syncthreads();
      add_product<C::PC, false>(ms, dys, LDP, dxa[g]);   // M^T dy_i
    }

    // dB_j += dCB^T C_i, dCB summed over the group's heads
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        dcbs[(ty + 16 * a) * LDD + tx + 16 * b] = dcb[a][b];
        dcb[a][b] = 0.f;
      }
    __syncthreads();
    add_product<C::NC, false>(dcbs, cs, LDN, dba);
  }

  // the column sums of dS and dM CB L over the 16 row groups, in order
  float* const dsts = smem + Lo.dst;
  float* const red = smem + Lo.red;     // [2][G][16][T]
  __syncthreads();   // the walk is done with cs, dys, ms, dcbs
  if (t < G) cl[t] = carry;              // cum_last
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      red[(g * 16 + ty) * T + tx + 16 * b] = colS[g][b];
      red[((G + g) * 16 + ty) * T + tx + 16 * b] = colD[g][b];
    }
  __syncthreads();
  if (t < G * T) {
    const int g = t / T, jl = t % T;
    float a1 = 0.f, a2 = 0.f;
    for (int k = 0; k < 16; ++k) {
      a1 += red[(g * 16 + k) * T + jl];
      a2 += red[((G + g) * 16 + k) * T + jl];
    }
    ss[t] = a1;
    sd[t] = a2;
  }

  // the state terms, per head: v = dst B_j, dx += w v, u = x . v, dB +=
  // w dst^T x_j
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int h = h0 + g;
    if (h >= s.h) continue;
    __syncthreads();   // the last head's readers of dsts are done
    load_tile<NW>(dsts, LDN, dst + ((long long)bc * s.h + h) * s.p * s.n,
                  s.n, PW, s.p, s.n);
    __syncthreads();
    float v[4][C::PC];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < C::PC; ++c) v[a][c] = 0.f;
#pragma unroll 2
    for (int k = 0; k < NW; k += 4) {
      float4 bv[4], dv[C::PC];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        bv[a] = *reinterpret_cast<const float4*>(bs + (ty + 16 * a) * LDN + k);
#pragma unroll
      for (int c = 0; c < C::PC; ++c)
        dv[c] = *reinterpret_cast<const float4*>(dsts + (tx + 16 * c) * LDN
                                                 + k);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < C::PC; ++c) {
          v[a][c] = fmaf(bv[a].x, dv[c].x, v[a][c]);
          v[a][c] = fmaf(bv[a].y, dv[c].y, v[a][c]);
          v[a][c] = fmaf(bv[a].z, dv[c].z, v[a][c]);
          v[a][c] = fmaf(bv[a].w, dv[c].w, v[a][c]);
        }
    }
    const float* xg = xs + g * T * LDP;
    float w[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int jl = ty + 16 * a;
      w[a] = expf(cl[g] - cumj[g * T + jl]) * dtj[g * T + jl];
      float u = 0.f;
#pragma unroll
      for (int c = 0; c < C::PC; ++c) {
        dxa[g][a][c] = fmaf(w[a], v[a][c], dxa[g][a][c]);
        u = fmaf(xg[jl * LDP + tx + 16 * c], v[a][c], u);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        u += __shfl_xor_sync(0xffffffffu, u, off);
      if (tx == 0) us[g * T + jl] = u;
    }
    float sb[4][C::NC];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < C::NC; ++c) sb[a][c] = 0.f;
#pragma unroll 4
    for (int p = 0; p < PW; ++p) {
      float xv[4], dv[C::NC];
#pragma unroll
      for (int a = 0; a < 4; ++a) xv[a] = xg[(ty + 16 * a) * LDP + p];
#pragma unroll
      for (int c = 0; c < C::NC; ++c) dv[c] = dsts[p * LDN + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < C::NC; ++c) sb[a][c] = fmaf(xv[a], dv[c], sb[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < C::NC; ++c)
        dba[a][c] = fmaf(w[a], sb[a][c], dba[a][c]);
  }
  __syncthreads();   // us, ss, sd written

  // ddt's partial, dcum's column part and u w of each (j, head)
  if (t < G * T) {
    const int r = t / G, g = t % G, j = j0 + r, h = h0 + g;
    if (j < s.q && h < s.h) {
      const float u = us[g * T + r];
      const float e = expf(cl[g] - cumj[g * T + r]);
      const float uw = u * (e * dtj[g * T + r]);
      const long long o = (row0 + j) * s.h + h;
      ddtp[o] = sd[g * T + r] + u * e;
      dcc[o] = -ss[g * T + r] - uw;
      uwo[o] = uw;
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = j0 + ty + 16 * a;
    if (j >= s.q) continue;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (h0 + g >= s.h) continue;
      float* out = dx + ((row0 + j) * s.h + h0 + g) * s.p;
#pragma unroll
      for (int c = 0; c < C::PC; ++c)
        if (tx + 16 * c < s.p) out[tx + 16 * c] = dxa[g][a][c];
    }
    float* out = dBp + (((long long)grp * s.bc + bc) * s.q + j) * s.n;
#pragma unroll
    for (int c = 0; c < C::NC; ++c)
      if (tx + 16 * c < s.n) out[tx + 16 * c] = dba[a][c];
  }
}

// -- row blocks: dC's share and the row sums of dS --------------------------

template <int PW, int NW>
__device__ void row_block(const float* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ A,
                          const float* __restrict__ Bm,
                          const float* __restrict__ Cm,
                          const float* __restrict__ dy,
                          float* __restrict__ dcr, float* __restrict__ dCp,
                          const Shape& s, int grp, int bc, int it,
                          float* smem) {
  using C = Cfg<PW, NW>;
  constexpr int G = C::G, LDP = C::LDP, LDN = C::LDN;
  const Layout Lo = layout(PW, NW, G);
  float* const cs = smem + Lo.fix;
  float* const dys = smem + Lo.res;
  float* const bs = smem + Lo.walk;
  float* const xs = smem + Lo.ph;
  float* const dcbs = smem + Lo.dcb;
  float* const cumi = smem + Lo.cumf;
  float* const cumj = smem + Lo.cumw;
  float* const dtj = smem + Lo.dtw;
  float* const at = smem + Lo.at;

  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int h0 = grp * G, i0 = it * T;
  const int rows_i = min(T, s.q - i0);
  const long long row0 = (long long)bc * s.q;

  load_tile<NW>(cs, LDN, Cm + (row0 + i0) * s.n, s.n, T, rows_i, s.n);
#pragma unroll
  for (int g = 0; g < G; ++g)
    load_tile<PW>(dys + g * T * LDP, LDP,
                  dy + ((row0 + i0) * s.h + h0 + g) * s.p,
                  (long long)s.h * s.p, T, h0 + g < s.h ? rows_i : 0, s.p);
  {   // cum_i: the prefix to tile it, then tile it
    float carry = 0.f;
    prefix<G>(dt, A, s, bc, h0, it, at, carry);
    __syncthreads();
    stage_dt<G>(dt, A, s, bc, h0, i0, at, nullptr);
    __syncthreads();
    scan<G>(at, cumi, nullptr, carry);
  }

  float dca[4][C::NC], dcb[4][4], rowS[G][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < C::NC; ++c) dca[a][c] = 0.f;
#pragma unroll
    for (int b = 0; b < 4; ++b) dcb[a][b] = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) rowS[g][a] = 0.f;
  }

  float carry = 0.f;   // the walk over j starts again from position 0
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * T;
    __syncthreads();   // the last tile's readers of bs, xs, dcbs, at, cumj
    load_tile<NW>(bs, LDN, Bm + (row0 + j0) * s.n, s.n, T, min(T, s.q - j0),
                  s.n);
    stage_dt<G>(dt, A, s, bc, h0, j0, at, dtj);
    __syncthreads();
    scan<G>(at, cumj, nullptr, carry);
    __syncthreads();

    float cb[4][4];
    dot_tile<NW>(cs, bs, LDN, cb);       // C_i B_j^T, as the column blocks

#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int h = h0 + g;
      if (h >= s.h) continue;
      __syncthreads();   // the last head's readers of xs are done
      load_tile<PW>(xs, LDP, x + ((row0 + j0) * s.h + h) * s.p,
                    (long long)s.h * s.p, T, min(T, s.q - j0), s.p);
      __syncthreads();
      float dm[4][4];
      dot_tile<PW>(dys + g * T * LDP, xs, LDP, dm);   // dy_i . x_j
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int il = ty + 16 * a, i = i0 + il;
        const float ci = cumi[g * T + il];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int jl = tx + 16 * b, j = j0 + jl;
          const bool live = i >= j && i < s.q;
          const float l = live ? expf(ci - cumj[g * T + jl]) : 0.f;
          const float dj = dtj[g * T + jl];
          const float m = cb[a][b] * l * dj;
          rowS[g][a] += dm[a][b] * m;
          dcb[a][b] += dm[a][b] * l * dj;
        }
      }
    }

    // dC_i += dCB B_j, dCB summed over the group's heads
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        dcbs[(ty + 16 * a) * LDD + tx + 16 * b] = dcb[a][b];
        dcb[a][b] = 0.f;
      }
    __syncthreads();
    add_product<C::NC, true>(dcbs, bs, LDN, dca);
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float r = rowS[g][a];
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        r += __shfl_xor_sync(0xffffffffu, r, off);
      if (tx == 0 && i < s.q && h0 + g < s.h)
        dcr[(row0 + i) * s.h + h0 + g] = r;
    }
    if (i >= s.q) continue;
    float* out = dCp + (((long long)grp * s.bc + bc) * s.q + i) * s.n;
#pragma unroll
    for (int c = 0; c < C::NC; ++c)
      if (tx + 16 * c < s.n) out[tx + 16 * c] = dca[a][c];
  }
}

template <int PW, int NW>
__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk_bwd_kernel(const float* __restrict__ x,
                     const float* __restrict__ dt,
                     const float* __restrict__ A,
                     const float* __restrict__ Bm,
                     const float* __restrict__ Cm,
                     const float* __restrict__ dy,
                     const float* __restrict__ dst, float* __restrict__ dx,
                     float* __restrict__ ddtp, float* __restrict__ dcc,
                     float* __restrict__ uwo, float* __restrict__ dcr,
                     float* __restrict__ dBp, float* __restrict__ dCp,
                     Shape s) {
  extern __shared__ __align__(16) float smem[];
  const int grp = blockIdx.x, bc = blockIdx.y, z = blockIdx.z;
  if (z % 2 == 0)
    column_block<PW, NW>(x, dt, A, Bm, Cm, dy, dst, dx, ddtp, dcc, uwo, dBp,
                         s, grp, bc, z / 2, smem);
  else
    row_block<PW, NW>(x, dt, A, Bm, Cm, dy, dcr, dCp, s, grp, bc,
                      s.n_tiles - 1 - z / 2, smem);
}

// Completes s and sets the grid and G for a launch; returns the block's
// shared memory in bytes, or 0 for a launch this file refuses.
inline int prepare(Shape& s, dim3& grid, int& g, int& pw, int& nw) {
  if (s.p < 1 || s.p > MAX_P || s.n < 1 || s.n > MAX_N || s.q < 1
      || s.bc < 1 || s.bc > 65535 || s.h < 1)
    return 0;
  pw = s.p <= 64 ? 64 : 128;
  nw = s.n <= 64 ? 64 : 128;
  g = pw == 64 ? 4 : 2;
  s.n_tiles = (s.q + T - 1) / T;
  const Layout L = layout(pw, nw, g);
  const long long z = 2LL * s.n_tiles;
  if (L.total < 0 || L.total * 4 > SMEM_MAX || z > 65535) return 0;
  grid = dim3((unsigned)((s.h + g - 1) / g), (unsigned)s.bc, (unsigned)z);
  return L.total * 4;
}

template <int PW, int NW>
cudaError_t launch(const float* const* in, float* const* out, const Shape& s,
                   dim3 grid, int smem, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_bwd_kernel<PW, NW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  ssd_chunk_bwd_kernel<PW, NW><<<grid, THREADS, smem, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], out[0], out[1],
      out[2], out[3], out[4], out[5], out[6], s);
  return cudaGetLastError();
}

Shape shape_of(int bc, int q, int h, int p, int n) {
  Shape s{};
  s.bc = bc; s.q = q; s.h = h; s.p = p; s.n = n;
  return s;
}

}  // namespace

// dtype: 0 = float32 (the only one).  Contiguous x and dy (bc, q, h, p),
// dt (bc, q, h), A (h), B and C (bc, q, n), dst (bc, h, p, n) in; out dx
// like x, and the partials the wrapper finishes: ddtp, dcc, uw and dcr
// (bc, q, h), dBp and dCp (groups, bc, q, n), groups = ceil(h / G).
// 1 <= p, n <= 128; 1 <= bc <= 65535; q >= 1.  Returns a cudaError_t: 0
// after a launch that the runtime accepted.
extern "C" int ssd_chunk_bwd_launch(int dtype, const void* x, const void* dt,
                                    const void* A, const void* Bm,
                                    const void* Cm, const void* dy,
                                    const void* dst, void* dx, void* ddtp,
                                    void* dcc, void* uw, void* dcr,
                                    void* dBp, void* dCp, int bc, int q,
                                    int h, int p, int n, void* stream) {
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  Shape s = shape_of(bc, q, h, p, n);
  dim3 grid;
  int g, pw, nw;
  const int smem = prepare(s, grid, g, pw, nw);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const float* in[7] = {
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(dy),
      static_cast<const float*>(dst)};
  float* out[7] = {static_cast<float*>(dx), static_cast<float*>(ddtp),
                   static_cast<float*>(dcc), static_cast<float*>(uw),
                   static_cast<float*>(dcr), static_cast<float*>(dBp),
                   static_cast<float*>(dCp)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pw == 64)
    return (int)(nw == 64 ? launch<64, 64>(in, out, s, grid, smem, st)
                          : launch<64, 128>(in, out, s, grid, smem, st));
  return (int)(nw == 64 ? launch<128, 64>(in, out, s, grid, smem, st)
                        : launch<128, 128>(in, out, s, grid, smem, st));
}

// What ssd_chunk_bwd_launch would launch with the same arguments: out[0]
// the block's shared memory in bytes, out[1..3] the grid, out[4] G.
// Returns cudaErrorInvalidValue where the launch would be refused.
extern "C" int ssd_chunk_bwd_query(int dtype, int bc, int q, int h, int p,
                                   int n, int* out) {
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  Shape s = shape_of(bc, q, h, p, n);
  dim3 grid;
  int g, pw, nw;
  const int smem = prepare(s, grid, g, pw, nw);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  out[0] = smem;
  out[1] = (int)grid.x;
  out[2] = (int)grid.y;
  out[3] = (int)grid.z;
  out[4] = g;
  return 0;
}
