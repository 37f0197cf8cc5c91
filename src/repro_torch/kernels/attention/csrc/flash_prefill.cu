// Causal GQA flash attention for prefill, with an optional sliding window.
//
// Replaces the TPU kernel src/repro/kernels/attention/flash_prefill.py:87
// (flash_prefill, body _flash_kernel).  Same function, not the same grid:
// q (B, S, K, G, D), k/v (B, S, K, D) in, o (B, S, K, G, D) out, where
// query position i of head (kh, g) sees key positions j <= i (and
// i - j < window when window > 0), with scores q.k / sqrt(D).
//
// Both dtypes: a block holds a tile of query rows, a row being one
// (position, head g) pair of its kv head: bq = rows / G consecutive
// positions, all G heads of each, so every k/v tile it loads serves all
// G heads.  The rows of one position are G * D contiguous values, so the
// (B, S, K, G, D) layout is read in place: the reference's transposes to
// (B*K, S, G, D) are indexing here, not copies.  The block walks its kv
// tiles of 64 positions with an online softmax (running max m, sum l,
// fp32 accumulator in registers), and only the live ones: from the tile
// of the window's first key to the tile of the diagonal.  The TPU grid is
// static and iterates the dead tiles; here they are never visited.  A
// position count S that no tile divides is handled by masked tails
// (zero-filled loads, rows past S never stored).  The head dim is padded
// with zeros to DP = 16, 32, 64 or 128, a template argument.  Scores are
// kept in log2 units (the scale and log2(e) folded into one factor), so
// exp(s - m) is one MUFU.EX2 of their difference, and the mask is applied
// only on tiles that cross the diagonal, the window's edge or S.
//
// What bounds it on an H100: in fp32, operations.  At B = 4, S = 511,
// H = 32, D = 64 a layer does 4 * D FLOP per live (query, key) pair,
// 4.29 GFLOP, against 42 MB of q/k/v/o in fp32 (102 FLOP per byte, above
// the fp32 ridge of 20).  In bf16 (21 MB, 205 FLOP per byte, below the
// tensor cores' ridge of 295) the bound is the bytes.
//
// fp32 (flash_prefill_f32<DP>): IEEE fp32 FMAs on the CUDA cores (tensor
// cores would mean TF32).  At the FMA peak the SM's shared-memory port and
// the latency of the loads are what stand in the way, so:
//  - Register blocking.  A block of 128 threads owns 64 query rows; each
//    thread holds 8 rows x 4 keys of the scores and 8 rows x DP / 16
//    columns of the output.  Its rows are ty + 8 i (ty = thread / 16), its
//    keys tx + 16 j (tx = thread % 16), its output columns 4 tx (+ 64)
//    (fewer at DP < 64).  Q K^T reads float4s along D from row-major Q
//    and K tiles, 12 loads for 128 FMAs; P V reads float4s of P along the
//    keys and one vector of V a key, 12 loads for 128 FMAs (4 x 4 tiles of
//    scalar loads take 8 for 16).  Rows of DP + 4 floats keep 16-byte
//    alignment and put the 16 keys of a K read on distinct banks; P's
//    rows of 80 floats put the two rows of a warp's P store 16 banks
//    apart.  64 rows and not 128: two blocks an SM at DP = 64 (105 KB of
//    shared memory, about 200 registers a thread), whose barriers do not
//    wait on each other, and a finer tail; 128-row blocks of 256 threads
//    were 3% slower at Llama-3.2-1B's shape and 11% at granite's on an
//    H100.
//  - A thread's rows are its half-warp's alone, so P is written and read
//    inside one warp (__syncwarp), and a row's max is taken across its 16
//    threads by shuffles.  l is kept per thread over its own keys (the
//    rescale is the row's) and summed across the 16 at the end.
//  - K and V through a two-stage cp.async ring: 16-byte chunks at fixed
//    per-thread offsets (shifts, no division), zero-filled past S and past
//    D.  The load of tile t + 1 starts right after the one barrier of
//    tile t and lands while tile t is multiplied.  Q is loaded once, in
//    the first group.
//  - The causal tail: the grid is one-dimensional, the query tile the
//    outer index and the heaviest first (every (b, kh) of the last query
//    tile, then the one before), so the short blocks fill the gaps at the
//    end.  Pairing tile i with tile n - 1 - i in one block instead (timed
//    with 128-row blocks) was 20% slower at granite's shape, as fast at
//    Llama's, and faster only at qwen1.5-0.5b's (G = 1).  The plan
//    (padded D, grid, shared memory) is ops.prefill_plan's in Python;
//    flash_prefill_query reports this side's for tests to hold the two
//    equal.
//  - The product loops are unrolled four times: unrolled whole they were
//    up to 45% slower (G = 1), twice about as fast.
//
// bf16 (flash_prefill_wgmma): one warpgroup of 128 threads owns 64 rows.
// Both products run on the tensor cores: S = Q K^T as a wgmma m64n64k16
// chain with Q and K from swizzled shared memory, and O += P V as a wgmma
// with P in registers (the score accumulator's fragment is the A
// fragment, so P never touches shared memory) and V read MN-major
// (transpose bit) from the tile that TMA wrote, so V needs no transposed
// copy.  K and V come by TMA (a 4-d tensor map over (B, S, K, D), boxes
// of 64 positions at one (b, kh), zero-filled past S and past D) into a
// two-stage ring; an mbarrier per stage carries the bytes, and the load
// of tile t + 1 is in flight while tile t is multiplied.  Q is loaded
// once, by the threads, into the same swizzled layout; rows of 32, 64 or
// 128 bytes with the matching swizzle.  The online softmax works on the
// accumulator fragment: each thread holds two rows, and a row's max and
// sum are taken across the four threads that share it.  The softmax is
// most of the block's instructions (the products are a few wgmmas a
// tile).  The last query tiles, which have the most live kv tiles, are
// scheduled first within each (b, kh).  What holds it back (about 1.2x
// SDPA's device time on an H100): each tile's chain (wait, Q K^T,
// softmax, P V, wait) runs in order inside the warpgroup, and five blocks
// a SM (96 registers) hide only part of it.  Overlapping Q K^T of tile
// i + 1 with the softmax of tile i needs a second score buffer, and the
// registers it takes cost more blocks a SM than the overlap gained as
// tried; it wants 128-row blocks with a producer warp and register
// reallocation.
//
// Numerics follow the reference: scores and softmax in fp32, masked
// scores -1e30, the probabilities rounded to the input dtype before the
// p @ v product (as `p.astype(v.dtype)` does), the sum l of the
// unrounded ones, and o = acc / max(l, 1e-30).
//
// Plain C interface, loaded with ctypes; the launch goes on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int ROWS = 64;      // (position, head) query rows per block
constexpr int BKV = 64;       // key positions per kv tile
constexpr int MAX_D = 128;
constexpr int MAX_G = 64;     // query heads per kv head
constexpr float NEG = -1e30f;

struct Shape {
  int b, s, k, g, d;
  int window;   // 0 = full causal
  int bq;       // query positions per block: rows / G
};

// exp2 as the one MUFU.EX2 instruction (arguments <= 0; results below
// 2^-126 flush to 0, where exp's would add nothing to an fp32 sum of
// terms up to 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the head dim padded to the kernels' DP
int padded_d(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 128;
}

// -- fp32: register-blocked FMA tiles, cp.async ring ------------------------

constexpr int F32_LDP = BKV + 16;  // P's row stride: rows 1 apart, 16 banks
constexpr int F32_THREADS = 2 * ROWS;  // 16 a row group of 8 rows

// a block's dynamic shared memory: Q, two stages of K and V (rows of
// DP + 4 floats) and P (ops.prefill_smem computes the same)
constexpr int f32_smem(int dp) {
  return 4 * ((ROWS + 2 * 2 * BKV) * (dp + 4) + ROWS * F32_LDP);
}

template <int DP>
struct F32Tile {
  static constexpr int THREADS = F32_THREADS;
  static constexpr int NRG = ROWS / 8;       // row groups: rows ty + NRG i
  static constexpr int RPT = 8;              // rows a thread
  static constexpr int LD = DP + 4;          // Q, K, V row stride (floats)
  static constexpr int NCOL = DP / 16;       // output columns a thread
  static constexpr int VW = NCOL < 4 ? NCOL : 4;  // as vectors of VW,
  static constexpr int NG = NCOL / VW;       // at columns VW tx + 64 g
  static constexpr int CPR = DP / 4;         // 16-byte chunks of a row
  static constexpr int Q_FLOATS = ROWS * LD;
  static constexpr int KV_FLOATS = BKV * LD;  // one K or V tile
  static constexpr int SMEM = f32_smem(DP);
  static_assert(THREADS % CPR == 0 && BKV * CPR % THREADS == 0, "chunks");
  static_assert(SMEM == 4 * (Q_FLOATS + 4 * KV_FLOATS + ROWS * F32_LDP),
                "the kernel's layout is what f32_smem sizes");
};

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

template <int VW>
__device__ __forceinline__ void stg(float* p, const float* x) {
  if constexpr (VW == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else if constexpr (VW == 2)
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  else
    *p = x[0];
}

__device__ __forceinline__ float lane_of(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

template <int DP>
__global__ void __launch_bounds__(F32Tile<DP>::THREADS, 1)
flash_prefill_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  Shape s) {
  using TL = F32Tile<DP>;
  constexpr int LD = TL::LD, NRG = TL::NRG, RPT = TL::RPT, CPR = TL::CPR;
  constexpr int THREADS = TL::THREADS, NCOL = TL::NCOL, VW = TL::VW;
  extern __shared__ __align__(16) float smem[];
  float* const qs = smem;                      // [ROWS][LD]
  float* const kvs = qs + TL::Q_FLOATS;        // 2 stages of K, V [BKV][LD]
  float* const ps = kvs + 4 * TL::KV_FLOATS;   // [ROWS][F32_LDP]

  const int D = s.d, G = s.g, BK = s.b * s.k;
  // heaviest query tiles first: every (b, kh) of the last tile, then the
  // tile before it
  const int n_qt = (s.s + s.bq - 1) / s.bq;
  const int bk = blockIdx.x % BK;
  const int b = bk / s.k, kh = bk % s.k;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / BK)) * s.bq;
  const int n_pos = min(s.bq, s.s - q0);
  const int rows = n_pos * G;                  // live rows of this block
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float scale2 = 1.4426950408889634f / sqrtf((float)D);
  // row r = (position q0 + r / G, head r % G); its G heads are contiguous
  const long long q_base = (((long long)b * s.s + q0) * s.k + kh) * G * D;
  const long long q_pos_stride = (long long)s.k * G * D;
  const long long kv_base = ((long long)b * s.s * s.k + kh) * D;
  const long long kv_pos_stride = (long long)s.k * D;
  const int q_last = q0 + n_pos - 1;
  const int k_first = s.window > 0 ? max(0, q0 - s.window + 1) : 0;
  const int t0 = k_first / BKV, n_tiles = q_last / BKV - t0 + 1;

  // Q, once: 16-byte chunks, zero past D and in rows past the positions
#pragma unroll
  for (int n = 0; n < ROWS * CPR / THREADS; ++n) {
    const int idx = tid + n * THREADS, r = idx / CPR, c = idx % CPR * 4;
    const bool live = r < rows && c < D;
    const float* src =
        live ? q + q_base + (r / G) * q_pos_stride + (r % G) * D + c : q;
    hopper::cp_async16(hopper::smem_addr(qs + r * LD + c), src, live);
  }
  // K and V of tile t into stage st: this thread's chunks are column c of
  // rows j0, j0 + THREADS / CPR, ...
  const int c_kv = tid % CPR * 4, j0 = tid / CPR;
  auto load_kv = [&](int t, int st) {
    float* const ks = kvs + st * 2 * TL::KV_FLOATS;
#pragma unroll
    for (int n = 0; n < BKV * CPR / THREADS; ++n) {
      const int j = j0 + n * (THREADS / CPR), pos = t * BKV + j;
      const bool live = pos < s.s && c_kv < D;
      const long long off = live ? kv_base + pos * kv_pos_stride + c_kv : 0;
      hopper::cp_async16(hopper::smem_addr(ks + j * LD + c_kv), k + off,
                         live);
      hopper::cp_async16(
          hopper::smem_addr(ks + TL::KV_FLOATS + j * LD + c_kv), v + off,
          live);
    }
  };
  load_kv(t0, 0);
  hopper::cp_async_commit();

  int qp[RPT];                 // the position of each of this thread's rows
  float m[RPT], l[RPT], acc[RPT][NCOL];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    qp[i] = q0 + (ty + NRG * i) / G;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) acc[i][c] = 0.f;
  }
  float* const prow = ps + ty * F32_LDP;      // row i at prow + NRG i LDP

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = (t0 + it) * BKV;
    hopper::cp_async_wait<0>();
    // tile it has landed for every thread, and every thread is done with
    // tile it - 1: its stage takes tile it + 1
    __syncthreads();
    if (it + 1 < n_tiles) load_kv(t0 + it + 1, (it + 1) & 1);
    hopper::cp_async_commit();
    const float* const ks = kvs + (it & 1) * 2 * TL::KV_FLOATS;
    const float* const vs = ks + TL::KV_FLOATS;

    // S = Q K^T: 8 x 4 a thread, summed over D in order
    float sc[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 a[RPT], kb[4];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (ty + NRG * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(a[i].x, kb[j].x, sc[i][j]);
          sc[i][j] = fmaf(a[i].y, kb[j].y, sc[i][j]);
          sc[i][j] = fmaf(a[i].z, kb[j].z, sc[i][j]);
          sc[i][j] = fmaf(a[i].w, kb[j].w, sc[i][j]);
        }
    }

    // online softmax in log2 units; a row's 16 threads are 16 lanes of
    // one half-warp
    const bool edge = k0 + BKV - 1 > q0
        || (s.window > 0 && q_last - k0 >= s.window);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = sc[i][j] * scale2;
        if (edge) {
          const int kpos = k0 + tx + 16 * j;
          const bool live = kpos <= qp[i]
              && (s.window == 0 || qp[i] - kpos < s.window);
          x = live ? x : NEG;
        }
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = ex2(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ex2(sc[i][j] - m_new);
        sum += p;
        prow[NRG * i * F32_LDP + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < NCOL; ++c) acc[i][c] *= corr;
    }
    __syncwarp();   // P's rows are this warp's: written, now read

    // O += P V, summed over the keys in order
#pragma unroll 4
    for (int kk = 0; kk < BKV; kk += 4) {
      float4 p[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        p[i] = *reinterpret_cast<const float4*>(prow + NRG * i * F32_LDP
                                                + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[NCOL];
#pragma unroll
        for (int g = 0; g < TL::NG; ++g)
          lds<VW>(vv + g * VW, vs + (kk + u) * LD + VW * tx + 64 * g);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float pu = lane_of(p[i], u);
#pragma unroll
          for (int c = 0; c < NCOL; ++c) acc[i][c] = fmaf(pu, vv[c], acc[i][c]);
        }
      }
    }
  }

  // l: the row's sum over its 16 threads
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + NRG * i;
    if (r >= rows) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* out = o + q_base + (r / G) * q_pos_stride + (r % G) * D;
#pragma unroll
    for (int g = 0; g < TL::NG; ++g) {
      const int col = VW * tx + 64 * g;
      float y[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) y[e] = acc[i][g * VW + e] / denom;
      if (col < D) stg<VW>(out + col, y);
    }
  }
}

template <int DP>
cudaError_t launch_f32_as(const void* q, const void* k, const void* v,
                          void* o, Shape s, long long grid,
                          cudaStream_t stream) {
  using TL = F32Tile<DP>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_f32<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        TL::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  flash_prefill_f32<DP><<<(unsigned)grid, TL::THREADS, TL::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), s);
  return cudaGetLastError();
}

// the fp32 grid: every (b, kh) of each query tile (ops.prefill_plan)
long long f32_grid(const Shape& s) {
  return (long long)((s.s + s.bq - 1) / s.bq) * s.b * s.k;
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       Shape s, cudaStream_t stream) {
  const long long grid = f32_grid(s);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  switch (padded_d(s.d)) {
    case 16: return launch_f32_as<16>(q, k, v, o, s, grid, stream);
    case 32: return launch_f32_as<32>(q, k, v, o, s, grid, stream);
    case 64: return launch_f32_as<64>(q, k, v, o, s, grid, stream);
    default: return launch_f32_as<128>(q, k, v, o, s, grid, stream);
  }
}

// -- bf16: wgmma, TMA ring --------------------------------------------------

constexpr int WG_THREADS = 128;  // one warpgroup: the block's 64 rows
constexpr int STAGES = 2;        // K/V tiles in flight

template <int DP>  // head dim padded to 16, 32, 64 or 128
struct Tile {
  static constexpr int ATOM = DP < 64 ? DP : 64;  // columns of one row
  static constexpr int RB = ATOM * 2;             // bytes of one row
  static constexpr int NATOM = DP / ATOM;         // 1, or 2 at DP = 128
  static constexpr int Q_BYTES = ROWS * DP * 2;
  static constexpr int KV_BYTES = BKV * DP * 2;   // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int SMEM = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr size_t ALLOC = SMEM + 1024 + 8 * STAGES;  // + align, bars
};

// K and V of tile t (positions t * BKV ..) at (b, kh) into the stage at
// kdst, completing on mbarrier `full`; issued by one thread
template <int DP>
__device__ __forceinline__ void load_kv(uint32_t kdst, uint32_t full,
                                        const CUtensorMap* kmap,
                                        const CUtensorMap* vmap, int t,
                                        int kh, int b) {
  using TL = Tile<DP>;
  hopper::mbar_expect_tx(full, TL::STAGE_BYTES);
#pragma unroll
  for (int a = 0; a < TL::NATOM; ++a) {
    hopper::tma_load_4d(kdst + a * BKV * TL::RB, kmap, full, a * TL::ATOM,
                        kh, t * BKV, b);
    hopper::tma_load_4d(kdst + TL::KV_BYTES + a * BKV * TL::RB, vmap, full,
                        a * TL::ATOM, kh, t * BKV, b);
  }
}

template <int DP>
__global__ void __launch_bounds__(WG_THREADS)
flash_prefill_wgmma(const __nv_bfloat16* __restrict__ q,
                    __nv_bfloat16* __restrict__ o,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, Shape s) {
  using TL = Tile<DP>;
  constexpr int RB = TL::RB, ATOM = TL::ATOM;
  constexpr int NW = ATOM;           // columns of one P V instruction
  constexpr int NCH = TL::NATOM;     // P V instructions per k16 step
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms: 1 KB
  uint8_t* const q_ptr = smem_raw + (base - raw);
  const uint32_t q_s = base;                      // [NATOM][ROWS][ATOM]
  const uint32_t kv_s = base + TL::Q_BYTES;       // stages of K, V
  const uint32_t bar = base + TL::SMEM;           // one mbarrier a stage

  const int D = s.d, G = s.g;
  const int b = blockIdx.y / s.k, kh = blockIdx.y % s.k;
  // the last query tiles (most live kv tiles) are scheduled first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * s.bq;
  const int n_pos = min(s.bq, s.s - q0);
  const int rows = n_pos * G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // scores in log2 units: exp(s - m) = exp2(s log2(e) - m log2(e)), one
  // subtraction and one MUFU.EX2 a score
  const float scale2 = 1.4426950408889634f / sqrtf((float)D);
  const long long q_base = (((long long)b * s.s + q0) * s.k + kh) * G * D;
  const long long q_pos_stride = (long long)s.k * G * D;
  const int q_last = q0 + n_pos - 1;
  const int k_first = s.window > 0 ? max(0, q0 - s.window + 1) : 0;
  const int t0 = k_first / BKV, n_tiles = q_last / BKV - t0 + 1;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) hopper::mbar_init(bar + 8 * st, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < min(STAGES, n_tiles); ++i)
      load_kv<DP>(kv_s + (i % STAGES) * TL::STAGE_BYTES,
                  bar + 8 * (i % STAGES), &kmap, &vmap, t0 + i, kh, b);

  // Q, once: 16-byte chunks, zero past D and in rows past the positions
  constexpr int CH = DP / 8;
  for (int idx = tid; idx < ROWS * CH; idx += WG_THREADS) {
    const int r = idx / CH, col = (idx % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && col < D)
      val = *reinterpret_cast<const uint4*>(
          q + q_base + (r / G) * q_pos_stride + (r % G) * D + col);
    *reinterpret_cast<uint4*>(
        q_ptr + (col / ATOM) * ROWS * RB
        + hopper::swizzle(r * RB + (col % ATOM) * 2, RB)) = val;
  }
  hopper::fence_proxy_async();
  __syncthreads();

  // this thread's rows of the accumulator fragments: r0 and r0 + 8
  const int r0 = warp * 16 + lane / 4;
  const int qp[2] = {q0 + r0 / G, q0 + (r0 + 8) / G};
  const int cq = 2 * (lane % 4);
  float oacc[NCH][NW / 2];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int j = 0; j < NW / 2; ++j) oacc[c][j] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % STAGES;
    const int k0 = (t0 + i) * BKV;
    const uint32_t ks = kv_s + st * TL::STAGE_BYTES, vs = ks + TL::KV_BYTES;
    hopper::mbar_wait(bar + 8 * st, (i / STAGES) & 1);

    // S = Q K^T: 64 x 64, K-major Q and K
    float sacc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sacc[j] = 0.f;
    hopper::fence_regs(sacc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int a = kk * 16 / ATOM;
      const uint32_t koff = (kk * 16 % ATOM) * 2;
      hopper::wgmma_ss<64, 0, 0>(
          sacc, hopper::desc(q_s + a * ROWS * RB + koff, RB),
          hopper::desc(ks + a * BKV * RB + koff, RB));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sacc);

    // online softmax on the fragment: sacc[j] is row r0 + 8 * ((j >> 1) & 1),
    // key k0 + 8 * (j >> 2) + cq + (j & 1)
    const bool edge = k0 + BKV - 1 > q0
        || (s.window > 0 && q_last - k0 >= s.window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int h = (j >> 1) & 1;
      float x = sacc[j] * scale2;
      if (edge) {
        const int kpos = k0 + 8 * (j >> 2) + cq + (j & 1);
        const bool live = kpos <= qp[h]
            && (s.window == 0 || qp[h] - kpos < s.window);
        x = live ? x : NEG;
      }
      sacc[j] = x;
      mx[h] = fmaxf(mx[h], x);
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = ex2(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int h = (j >> 1) & 1;
      const float p = ex2(sacc[j] - m[h]);
      sum[h] += p;
      sacc[j] = p;
    }
    // P rounded to bf16, as the A fragments of four k16 steps
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = hopper::pack_bf16(sacc[8 * kk + 2 * r],
                                      sacc[8 * kk + 2 * r + 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * corr[h] + sum[h];
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int j = 0; j < NW / 2; ++j) oacc[c][j] *= corr[(j >> 1) & 1];

    // O += P V: V read MN-major, 16 key rows a step
#pragma unroll
    for (int c = 0; c < NCH; ++c) hopper::fence_regs(oacc[c]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        hopper::wgmma_rs<NW, 1>(
            oacc[c], pa[kk],
            hopper::desc(vs + c * BKV * RB + kk * 16 * RB, RB));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NCH; ++c) hopper::fence_regs(oacc[c]);

    __syncthreads();   // stage st is read: refill it
    if (tid == 0 && i + STAGES < n_tiles)
      load_kv<DP>(ks, bar + 8 * st, &kmap, &vmap, t0 + i + STAGES, kh, b);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= rows) continue;
    const float denom = fmaxf(l[h], 1e-30f);
    __nv_bfloat16* out = o + q_base + (r / G) * q_pos_stride + (r % G) * D;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int n = 0; n < NW / 8; ++n) {
        const int col = c * NW + 8 * n + cq;
        if (col < D)
          *reinterpret_cast<uint32_t*>(out + col) = hopper::pack_bf16(
              oacc[c][4 * n + 2 * h] / denom,
              oacc[c][4 * n + 2 * h + 1] / denom);
      }
  }
}

template <int DP>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, Shape s, cudaStream_t stream) {
  using TL = Tile<DP>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)TL::ALLOC);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  // k, v (B, S, K, D): boxes of ATOM columns x 1 head x BKV positions
  CUtensorMap kmap, vmap;
  const cuuint64_t dims[4] = {(cuuint64_t)s.d, (cuuint64_t)s.k,
                              (cuuint64_t)s.s, (cuuint64_t)s.b};
  const cuuint64_t strides[3] = {(cuuint64_t)s.d * 2,
                                 (cuuint64_t)s.k * s.d * 2,
                                 (cuuint64_t)s.s * s.k * s.d * 2};
  const cuuint32_t box[4] = {(cuuint32_t)TL::ATOM, 1, (cuuint32_t)BKV, 1};
  if (!hopper::make_map(&kmap, k, 4, dims, strides, box, TL::RB)
      || !hopper::make_map(&vmap, v, 4, dims, strides, box, TL::RB))
    return cudaErrorInvalidValue;
  dim3 grid((s.s + s.bq - 1) / s.bq, s.b * s.k);
  flash_prefill_wgmma<DP><<<grid, WG_THREADS, TL::ALLOC, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(o),
      kmap, vmap, s);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Contiguous q (b, s, kh, g, d),
// k/v (b, s, kh, d) and o like q; d a multiple of 8 up to 128, g <= 64;
// q, k, v and o 16-byte aligned (cp.async, TMA and vector accesses).
// Returns a cudaError_t: 0 after a launch that the runtime accepted.
extern "C" int flash_prefill_launch(int dtype, const void* q, const void* k,
                                    const void* v, void* o, int b, int s,
                                    int kh, int g, int d, int window,
                                    void* stream) {
  if (d < 8 || d > MAX_D || d % 8 != 0 || g < 1 || g > MAX_G || s < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Shape sh{b, s, kh, g, d, window, ROWS / g};
  if (dtype == 0) return (int)launch_f32(q, k, v, o, sh, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (d <= 16) return (int)launch_wgmma<16>(q, k, v, o, sh, st);
  if (d <= 32) return (int)launch_wgmma<32>(q, k, v, o, sh, st);
  if (d <= 64) return (int)launch_wgmma<64>(q, k, v, o, sh, st);
  return (int)launch_wgmma<128>(q, k, v, o, sh, st);
}

// What flash_prefill_launch would launch with the same shape: out[0] rows
// a block, out[1] the padded head dim, out[2] threads a block, out[3] the
// block's dynamic shared memory in bytes, out[4..5] the grid (x, y).
// Returns cudaErrorInvalidValue where the launch would be refused.
extern "C" int flash_prefill_query(int dtype, int b, int s, int kh, int g,
                                   int d, int* out) {
  if (d < 8 || d > MAX_D || d % 8 != 0 || g < 1 || g > MAX_G || s < 1
      || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int dp = padded_d(d), bq = ROWS / g, n_qt = (s + bq - 1) / bq;
  out[0] = ROWS;
  out[1] = dp;
  if (dtype == 0) {
    const long long grid = f32_grid(Shape{b, s, kh, g, d, 0, bq});
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    out[2] = F32_THREADS;
    out[3] = f32_smem(dp);
    out[4] = (int)grid;
    out[5] = 1;
    return 0;
  }
  out[2] = WG_THREADS;
  out[3] = (int)(dp == 16 ? Tile<16>::ALLOC : dp == 32 ? Tile<32>::ALLOC
                 : dp == 64 ? Tile<64>::ALLOC : Tile<128>::ALLOC);
  out[4] = n_qt;
  out[5] = b * kh;
  return 0;
}
