// Backward of causal GQA flash attention (fp32), with an optional sliding
// window: the gradients of flash_prefill.cu's function.
//
// Replaces no TPU kernel.  The reference trains by differentiating plain
// jnp (src/repro/models/transformer/layers.py::blockwise_causal_attention
// under jax.checkpoint), so XLA writes its backward; the port runs the
// forward through the Hopper kernel, and this is the kernel its
// torch.autograd.Function (ops.FlashPrefill) calls for the gradients.
//
// q, o, dO (B, S, K, G, D) and k, v (B, S, K, D) in; dQ like q, dK and dV
// like k out.  With scores s = q.k / sqrt(D), P = softmax(s) under the
// forward's mask, Delta = rowsum(dO o O):
//   dP = dO V^T,  dS = P o (dP - Delta),
//   dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D),  dV = P^T dO,
// dK and dV summed over the G query heads of their kv head.
//
// Two launches on the caller's stream, three kinds of block:
//  1. stats: one block a (query tile, b kh).  Delta of each query row
//     (from O and dO), and its log-sum-exp in log2 units (LSE2, from a pass
//     of Q K^T over the live kv tiles with the forward's online max and
//     sum), so P = exp2(s log2(e) / sqrt(D) - LSE2).  The forward kernel
//     writes no LSE, so this pass recomputes it.
//  2. dK/dV blocks: one a (key tile, b kh), 64 keys.  It walks every query
//     tile that can see its keys (from the tile of its first key to the
//     tile of its last key plus the window) and, within each, all G heads
//     (the rows of a query tile are (position, head) pairs, as in the
//     forward), so the sum over G stays inside the block: no atomics, and
//     two calls give the same bits.  Per query tile it recomputes
//     P^T = exp2(K Q^T - LSE2) and dP^T = V dO^T, forms dS^T, and adds
//     P^T dO to dV and dS^T Q to dK, both held in registers.
//  3. dQ blocks: one a (query tile, b kh), 64 rows.  It walks the live kv
//     tiles (as the forward does), recomputes P and dP, and adds dS K to
//     dQ in registers.
// 2 and 3 share the second launch, the dK/dV blocks first.  Under a
// causal mask the first key tiles are seen by every query tile and the
// last by a few (at Llama-3.2-1B's shape 32 query tiles against 4, 18 on
// average), so a launch of the dK/dV blocks alone lasts as long as its
// first blocks; behind them the dQ blocks fill the SMs the short ones
// free.  Timed on an H100 in turns against a launch of each kind (same
// bits), the shared launch was the faster at Llama's and granite's G,
// as fast at D = 80, and a few percent slower at G = 1.
// Every block has 128 threads; a 64 x 64 score tile is 8 rows x 4 columns
// a thread (rows ty + 8 i, columns tx + 16 j; ty = thread / 16, tx =
// thread % 16), so a row's 16 threads are one half-warp, and the P and dS
// tiles a thread reads back for the accumulating product were written by
// its own half-warp (__syncwarp).  The accumulating products (P^T dO,
// dS^T Q, dS K) give each thread 8 rows x DP / 16 columns, as the
// forward's P V does.  Tiles are loaded with plain 16-byte loads into rows
// of DP + 4 floats (zero past S and past D), between two barriers.
//
// What bounds it on an H100: operations.  Counting only the five products
// of the backward (Q K^T, dO V^T, P^T dO, dS^T Q, dS K), 10 D FLOP a live
// (query, key) pair: 10.7 GFLOP a layer at Llama-3.2-1B's (4, 512, 8, 4,
// 64), 0.16 ms at the fp32 FMA peak, against 42 MB of q, k, v, o, dO, dQ,
// dK, dV (0.013 ms).  This design does 16 D a pair (Q K^T three times,
// dO V^T twice), in IEEE fp32 FMAs on the CUDA cores, and waits on each
// tile's loads (two blocks an SM at DP <= 64 hide part of it); the stats
// pass is about an eighth of the time.  The next steps are an LSE written
// by the forward (drops pass 1), a cp.async ring as the forward has, and
// tensor cores for bf16.
//
// Plain C interface, loaded with ctypes; the launch goes on the caller's
// stream, allocates nothing (the wrapper passes the LSE2 and Delta
// scratch), and returns cudaGetLastError().

#include <math.h>

namespace {

constexpr int ROWS = 64;      // (position, head) query rows a query tile
constexpr int BKV = 64;       // key positions a key tile
constexpr int THREADS = 128;  // 16 a row group of 8 rows
constexpr int MAX_D = 128;
constexpr int MAX_G = 64;     // query heads per kv head
constexpr int LDP = 80;       // row stride of the P and dS tiles (floats)
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Shape {
  int b, s, k, g, d;
  int window;   // 0 = full causal
  int bq;       // query positions a query tile: ROWS / G
};

// exp2 as the one MUFU.EX2 instruction (arguments <= 0 here)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

int padded_d(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 128;
}

template <int DP>
struct Tile {
  static constexpr int LD = DP + 4;          // row stride of Q, K, V, dO
  static constexpr int FLOATS = ROWS * LD;   // one 64-row tile
  static constexpr int CPR = DP / 4;         // 16-byte chunks of a row
  static constexpr int NCOL = DP / 16;       // accumulator columns a thread
  static constexpr int VW = NCOL < 4 ? NCOL : 4;  // as vectors of VW
  static constexpr int NG = NCOL / VW;       // at columns VW tx + 64 g
  // dynamic shared memory of each kernel (bytes)
  static constexpr int STATS_SMEM = 4 * 2 * FLOATS;
  static constexpr int KV_SMEM = 4 * (4 * FLOATS + 2 * BKV * LDP + 2 * ROWS);
  static constexpr int Q_SMEM = 4 * (4 * FLOATS + ROWS * LDP + 2 * ROWS);
  static constexpr int GRADS_SMEM = KV_SMEM > Q_SMEM ? KV_SMEM : Q_SMEM;
  static_assert(ROWS == BKV, "one tile shape for queries and keys");
};

// 64 rows of a (B, S, ..., D) tensor into a tile of rows of DP + 4
// floats: row r from src + row(r), zero where row(r) < 0 and past D
template <int DP, typename Row>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int d, Row row) {
  using TL = Tile<DP>;
  for (int idx = threadIdx.x; idx < ROWS * TL::CPR; idx += THREADS) {
    const int r = idx / TL::CPR, c = idx % TL::CPR * 4;
    const long long off = row(r);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (off >= 0 && c < d)
      x = *reinterpret_cast<const float4*>(src + off + c);
    *reinterpret_cast<float4*>(dst + r * TL::LD + c) = x;
  }
}

// acc[i][j] = A[ty + 8 i] . B[tx + 16 j] over DP, two 64-row tiles
template <int DP>
__device__ __forceinline__ void dot_tile(const float* a, const float* b,
                                         float (&acc)[8][4]) {
  constexpr int LD = Tile<DP>::LD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; d += 4) {
    float4 x[8], y[4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      x[i] = *reinterpret_cast<const float4*>(a + (ty + 8 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

// VW consecutive floats of shared memory, as one vector load
template <int VW>
__device__ __forceinline__ void lds(float* out, const float* p) {
  if constexpr (VW == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else if constexpr (VW == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
    out[0] = *p;
  }
}

__device__ __forceinline__ float lane_of(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

// acc[i][:] += sum over 64 t of W[ty + 8 i][t] M[t][columns of the
// thread]: W a P or dS tile (rows of LDP), M a 64-row tile of DP columns
template <int DP>
__device__ __forceinline__ void add_product(
    const float* w, const float* m, float (&acc)[8][Tile<DP>::NCOL]) {
  using TL = Tile<DP>;
  constexpr int VW = TL::VW;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int t = 0; t < ROWS; t += 4) {
    float4 p[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      p[i] = *reinterpret_cast<const float4*>(w + (ty + 8 * i) * LDP + t);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float mv[TL::NCOL];
#pragma unroll
      for (int g = 0; g < TL::NG; ++g)
        lds<VW>(mv + g * VW, m + (t + u) * TL::LD + VW * tx + 64 * g);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float pu = lane_of(p[i], u);
#pragma unroll
        for (int c = 0; c < TL::NCOL; ++c) acc[i][c] = fmaf(pu, mv[c], acc[i][c]);
      }
    }
  }
}

// acc's 8 rows (ty + 8 i, those below n_rows) times `scale` to out, row r
// at out + row(r), columns below d
template <int DP, typename Row>
__device__ __forceinline__ void store_rows(float* out,
                                           const float (&acc)[8][Tile<DP>::NCOL],
                                           float scale, int n_rows, int d,
                                           Row row) {
  using TL = Tile<DP>;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 8 * i;
    if (r >= n_rows) continue;
    float* dst = out + row(r);
#pragma unroll
    for (int g = 0; g < TL::NG; ++g)
#pragma unroll
      for (int e = 0; e < TL::VW; ++e) {
        const int col = TL::VW * tx + 64 * g + e;
        if (col < d) dst[col] = acc[i][g * TL::VW + e] * scale;
      }
  }
}

// where a block's query tile lies: rows r = (position q0 + r / G, head
// r % G) of kv head kh in batch b
struct QTile {
  int b, kh, q0, n_pos, rows;
  long long q_base, st_base;   // offsets of row 0 in q-like and stats arrays

  __device__ QTile(const Shape& s, int b_, int kh_, int qt)
      : b(b_), kh(kh_), q0(qt * s.bq) {
    n_pos = min(s.bq, s.s - q0);
    rows = n_pos * s.g;
    st_base = (((long long)b * s.s + q0) * s.k + kh) * s.g;
    q_base = st_base * s.d;
  }
  // offset of row r in a (B, S, K, G, D) array (-1 past the live rows)
  __device__ long long row(const Shape& s, int r) const {
    return r < rows ? q_base + (long long)(r / s.g) * s.k * s.g * s.d
                          + (r % s.g) * s.d
                    : -1;
  }
  // offset of row r in a (B, S, K, G) stats array
  __device__ long long stat(const Shape& s, int r) const {
    return st_base + (long long)(r / s.g) * s.k * s.g + r % s.g;
  }
};

// offset of key position `pos` of (b, kh) in a (B, S, K, D) array, -1
// past S
__device__ __forceinline__ long long kv_row(const Shape& s, int b, int kh,
                                            int pos) {
  return pos < s.s ? (((long long)b * s.s + pos) * s.k + kh) * s.d : -1;
}

// -- 1. row stats: LSE2 and Delta of each query row -----------------------

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_prefill_bwd_stats(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ o,
                        const float* __restrict__ dout,
                        float* __restrict__ lse2, float* __restrict__ delta,
                        Shape s) {
  using TL = Tile<DP>;
  extern __shared__ __align__(16) float smem[];
  float* const qs = smem;               // [ROWS][LD]
  float* const ks = qs + TL::FLOATS;    // [BKV][LD]
  const int BK = s.b * s.k, n_qt = (s.s + s.bq - 1) / s.bq;
  const int bk = blockIdx.x % BK;
  const QTile qt(s, bk / s.k, bk % s.k, n_qt - 1 - (int)(blockIdx.x / BK));
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float scale2 = LOG2E / sqrtf((float)s.d);

  // Delta: two threads a row, each summing alternate columns
  {
    const int r = tid / 2;
    const long long off = qt.row(s, r);
    float acc = 0.f;
    if (off >= 0)
      for (int c = tid % 2; c < s.d; c += 2)
        acc = fmaf(o[off + c], dout[off + c], acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (off >= 0 && tid % 2 == 0) delta[qt.stat(s, r)] = acc;
  }

  load_tile<DP>(qs, q, s.d, [&](int r) { return qt.row(s, r); });
  const int q_last = qt.q0 + qt.n_pos - 1;
  const int k_first = s.window > 0 ? max(0, qt.q0 - s.window + 1) : 0;
  const int t0 = k_first / BKV, t1 = q_last / BKV;
  int qp[8];
  float m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    qp[i] = qt.q0 + (ty + 8 * i) / s.g;
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int t = t0; t <= t1; ++t) {
    const int k0 = t * BKV;
    __syncthreads();   // every thread is done with the last tile
    load_tile<DP>(ks, k, s.d,
                  [&](int j) { return kv_row(s, qt.b, qt.kh, k0 + j); });
    __syncthreads();
    float sc[8][4];
    dot_tile<DP>(qs, ks, sc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool live = kpos <= qp[i]
            && (s.window == 0 || qp[i] - kpos < s.window);
        sc[i][j] = live ? sc[i][j] * scale2 : NEG;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += ex2(sc[i][j] - m_new);
      l[i] = l[i] * ex2(m[i] - m_new) + sum;
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int r = ty + 8 * i;
    if (tx == 0 && r < qt.rows) lse2[qt.stat(s, r)] = m[i] + log2f(l[i]);
  }
}

// -- 2. dK and dV: one block a key tile, every query row that sees it -----

// block `blk` of the dK/dV blocks: key tile blk / BK (the first tiles,
// which the most query rows see, first) of (b, kh) = blk % BK
template <int DP>
__device__ __forceinline__ void dkdv_block(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse2, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, const Shape& s, int blk,
    float* smem) {
  using TL = Tile<DP>;
  float* const ks = smem;                 // [BKV][LD]
  float* const vs = ks + TL::FLOATS;      // [BKV][LD]
  float* const qs = vs + TL::FLOATS;      // [ROWS][LD]
  float* const dos = qs + TL::FLOATS;     // [ROWS][LD]
  float* const ps = dos + TL::FLOATS;     // P^T [BKV][LDP]
  float* const dss = ps + BKV * LDP;      // dS^T [BKV][LDP]
  float* const ls = dss + BKV * LDP;      // LSE2 of the tile's rows
  float* const dl = ls + ROWS;            // Delta of the tile's rows

  const int BK = s.b * s.k, bk = blk % BK;
  const int b = bk / s.k, kh = bk % s.k;
  const int k0 = (blk / BK) * BKV;
  const int n_keys = min(BKV, s.s - k0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float scale2 = LOG2E / sqrtf((float)s.d);

  load_tile<DP>(ks, k, s.d, [&](int j) { return kv_row(s, b, kh, k0 + j); });
  load_tile<DP>(vs, v, s.d, [&](int j) { return kv_row(s, b, kh, k0 + j); });
  // the query positions that see a key of the tile: k0 .. the last key
  // plus the window (all of them to S without one)
  const int p_last = s.window > 0
      ? min(s.s - 1, k0 + n_keys - 1 + s.window - 1) : s.s - 1;
  const int qt0 = k0 / s.bq, qt1 = p_last / s.bq;

  float adk[8][TL::NCOL], adv[8][TL::NCOL];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < TL::NCOL; ++c) adk[i][c] = adv[i][c] = 0.f;
  int kp[8];   // this thread's key positions
#pragma unroll
  for (int i = 0; i < 8; ++i) kp[i] = k0 + ty + 8 * i;

  for (int t = qt0; t <= qt1; ++t) {
    const QTile qt(s, b, kh, t);
    __syncthreads();   // every thread is done with the last query tile
    load_tile<DP>(qs, q, s.d, [&](int r) { return qt.row(s, r); });
    load_tile<DP>(dos, dout, s.d, [&](int r) { return qt.row(s, r); });
    if (tid < ROWS) {
      const bool live = tid < qt.rows;
      ls[tid] = live ? lse2[qt.stat(s, tid)] : 0.f;
      dl[tid] = live ? delta[qt.stat(s, tid)] : 0.f;
    }
    __syncthreads();
    int qp[4];   // the positions of this thread's query rows
#pragma unroll
    for (int j = 0; j < 4; ++j) qp[j] = qt.q0 + (tx + 16 * j) / s.g;
    // every (key, row) pair of the tile is live: no mask to apply
    const bool full = qt.rows == ROWS && n_keys == BKV
        && qt.q0 >= k0 + BKV - 1
        && (s.window == 0 || qt.q0 + qt.n_pos - 1 - k0 < s.window);

    // P^T = exp2(K Q^T scale2 - LSE2)
    float sc[8][4];
    dot_tile<DP>(ks, qs, sc);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const bool live = full
            || (r < qt.rows && kp[i] < s.s && kp[i] <= qp[j]
                && (s.window == 0 || qp[j] - kp[i] < s.window));
        ps[(ty + 8 * i) * LDP + r] =
            live ? ex2(sc[i][j] * scale2 - ls[r]) : 0.f;
      }
    // dP^T = V dO^T, then dS^T = P^T (dP^T - Delta)
    dot_tile<DP>(vs, dos, sc);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int at = (ty + 8 * i) * LDP + tx + 16 * j;
        dss[at] = ps[at] * (sc[i][j] - dl[tx + 16 * j]);
      }
    __syncwarp();   // a half-warp's rows of P^T and dS^T are its own
    add_product<DP>(ps, dos, adv);
    add_product<DP>(dss, qs, adk);
  }
  const float scale = 1.f / sqrtf((float)s.d);
  store_rows<DP>(dk, adk, scale, n_keys, s.d,
                 [&](int j) { return kv_row(s, b, kh, k0 + j); });
  store_rows<DP>(dv, adv, 1.f, n_keys, s.d,
                 [&](int j) { return kv_row(s, b, kh, k0 + j); });
}

// -- 3. dQ: one block a query tile, every live key tile -------------------

// block `blk` of the dQ blocks: the heaviest query tiles first, as the
// forward's grid
template <int DP>
__device__ __forceinline__ void dq_block(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse2, const float* __restrict__ delta,
    float* __restrict__ dq, const Shape& s, int blk, float* smem) {
  using TL = Tile<DP>;
  float* const qs = smem;                 // [ROWS][LD]
  float* const dos = qs + TL::FLOATS;     // [ROWS][LD]
  float* const ks = dos + TL::FLOATS;     // [BKV][LD]
  float* const vs = ks + TL::FLOATS;      // [BKV][LD]
  float* const dss = vs + TL::FLOATS;     // dS [ROWS][LDP]
  float* const ls = dss + ROWS * LDP;     // LSE2 of the rows
  float* const dl = ls + ROWS;            // Delta of the rows

  const int BK = s.b * s.k, n_qt = (s.s + s.bq - 1) / s.bq;
  const int bk = blk % BK;
  const QTile qt(s, bk / s.k, bk % s.k, n_qt - 1 - blk / BK);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float scale2 = LOG2E / sqrtf((float)s.d);

  load_tile<DP>(qs, q, s.d, [&](int r) { return qt.row(s, r); });
  load_tile<DP>(dos, dout, s.d, [&](int r) { return qt.row(s, r); });
  if (tid < ROWS) {
    const bool live = tid < qt.rows;
    ls[tid] = live ? lse2[qt.stat(s, tid)] : 0.f;
    dl[tid] = live ? delta[qt.stat(s, tid)] : 0.f;
  }
  const int q_last = qt.q0 + qt.n_pos - 1;
  const int k_first = s.window > 0 ? max(0, qt.q0 - s.window + 1) : 0;
  const int t0 = k_first / BKV, t1 = q_last / BKV;
  int qp[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) qp[i] = qt.q0 + (ty + 8 * i) / s.g;
  float adq[8][TL::NCOL];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < TL::NCOL; ++c) adq[i][c] = 0.f;

  for (int t = t0; t <= t1; ++t) {
    const int k0 = t * BKV;
    __syncthreads();   // every thread is done with the last key tile
    load_tile<DP>(ks, k, s.d,
                  [&](int j) { return kv_row(s, qt.b, qt.kh, k0 + j); });
    load_tile<DP>(vs, v, s.d,
                  [&](int j) { return kv_row(s, qt.b, qt.kh, k0 + j); });
    __syncthreads();
    const bool full = qt.rows == ROWS && k0 + BKV <= s.s
        && qt.q0 >= k0 + BKV - 1
        && (s.window == 0 || q_last - k0 < s.window);

    // P = exp2(Q K^T scale2 - LSE2)
    float sc[8][4], p[8][4];
    dot_tile<DP>(qs, ks, sc);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 8 * i, kpos = k0 + tx + 16 * j;
        const bool live = full
            || (r < qt.rows && kpos < s.s && kpos <= qp[i]
                && (s.window == 0 || qp[i] - kpos < s.window));
        p[i][j] = live ? ex2(sc[i][j] * scale2 - ls[r]) : 0.f;
      }
    // dP = dO V^T, then dS = P (dP - Delta)
    dot_tile<DP>(dos, vs, sc);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dss[(ty + 8 * i) * LDP + tx + 16 * j] =
            p[i][j] * (sc[i][j] - dl[ty + 8 * i]);
    __syncwarp();   // a half-warp's rows of dS are its own
    add_product<DP>(dss, ks, adq);
  }
  store_rows<DP>(dq, adq, 1.f / sqrtf((float)s.d), qt.rows, s.d,
                 [&](int r) { return qt.row(s, r); });
}

// 2 and 3 in one launch: the n_kv dK/dV blocks, then the dQ blocks
template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_prefill_bwd_grads(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse2,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, float* __restrict__ dk,
                        float* __restrict__ dv, Shape s, int n_kv) {
  extern __shared__ __align__(16) float smem[];
  const int blk = (int)blockIdx.x;
  if (blk < n_kv)
    dkdv_block<DP>(q, k, v, dout, lse2, delta, dk, dv, s, blk, smem);
  else
    dq_block<DP>(q, k, v, dout, lse2, delta, dq, s, blk - n_kv, smem);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int DP>
cudaError_t launch_as(const float* q, const float* k, const float* v,
                      const float* o, const float* dout, float* dq,
                      float* dk, float* dv, float* lse2, float* delta,
                      Shape s, cudaStream_t stream) {
  using TL = Tile<DP>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err;
    if ((err = allow_smem(flash_prefill_bwd_stats<DP>, TL::STATS_SMEM))
            != cudaSuccess
        || (err = allow_smem(flash_prefill_bwd_grads<DP>, TL::GRADS_SMEM))
            != cudaSuccess)
      return err;
    configured = true;
  }
  const long long bk = (long long)s.b * s.k;
  const long long q_grid = (s.s + s.bq - 1) / s.bq * bk;
  const long long k_grid = (s.s + BKV - 1) / BKV * bk;
  if (q_grid + k_grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_prefill_bwd_stats<DP><<<(unsigned)q_grid, THREADS, TL::STATS_SMEM,
                                stream>>>(q, k, o, dout, lse2, delta, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_prefill_bwd_grads<DP><<<(unsigned)(k_grid + q_grid), THREADS,
                                TL::GRADS_SMEM, stream>>>(
      q, k, v, dout, lse2, delta, dq, dk, dv, s, (int)k_grid);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the only one).  Contiguous q, o, dout, dq (b, s, kh,
// g, d), k, v, dk, dv (b, s, kh, d), lse2 and delta (b, s, kh, g) scratch
// of fp32; d a multiple of 8 up to 128, g <= 64; every pointer 16-byte
// aligned.  Launches the stats kernel, then the dK/dV and dQ blocks;
// returns a cudaError_t: 0 after launches that the runtime accepted.
extern "C" int flash_prefill_bwd_launch(int dtype, const void* q,
                                        const void* k, const void* v,
                                        const void* o, const void* dout,
                                        void* dq, void* dk, void* dv,
                                        void* lse2, void* delta, int b,
                                        int s, int kh, int g, int d,
                                        int window, void* stream) {
  if (dtype != 0 || d < 8 || d > MAX_D || d % 8 != 0 || g < 1 || g > MAX_G
      || s < 1 || window < 0)
    return (int)cudaErrorInvalidValue;
  const Shape sh{b, s, kh, g, d, window, ROWS / g};
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* of = static_cast<const float*>(o);
  const auto* df = static_cast<const float*>(dout);
  auto* dqf = static_cast<float*>(dq);
  auto* dkf = static_cast<float*>(dk);
  auto* dvf = static_cast<float*>(dv);
  auto* lf = static_cast<float*>(lse2);
  auto* tf = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (padded_d(d)) {
    case 16: return (int)launch_as<16>(qf, kf, vf, of, df, dqf, dkf, dvf,
                                       lf, tf, sh, st);
    case 32: return (int)launch_as<32>(qf, kf, vf, of, df, dqf, dkf, dvf,
                                       lf, tf, sh, st);
    case 64: return (int)launch_as<64>(qf, kf, vf, of, df, dqf, dkf, dvf,
                                       lf, tf, sh, st);
    default: return (int)launch_as<128>(qf, kf, vf, of, df, dqf, dkf, dvf,
                                        lf, tf, sh, st);
  }
}
