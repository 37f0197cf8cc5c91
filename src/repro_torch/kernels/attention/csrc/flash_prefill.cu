// Causal GQA flash attention for prefill, with an optional sliding window.
//
// Replaces the TPU kernel src/repro/kernels/attention/flash_prefill.py:87
// (flash_prefill, body _flash_kernel).  Same function, not the same grid:
// q (B, S, K, G, D), k/v (B, S, K, D) in, o (B, S, K, G, D) out, where
// query position i of head (kh, g) sees key positions j <= i (and
// i - j < window when window > 0), with scores q.k / sqrt(D).
//
// Grid, both dtypes: (query tiles, B * K).  A block holds ROWS = 64 query
// rows, a row being one (position, head g) pair of its kv head: bq = 64 / G
// consecutive positions, all G heads of each, so every k/v tile it loads
// serves all G heads.  The rows of one position are G * D contiguous
// values, so the (B, S, K, G, D) layout is read in place: the reference's
// transposes to (B*K, S, G, D) are indexing here, not copies.  The block
// walks its kv tiles of 64 positions with an online softmax (running max
// m, sum l, fp32 accumulator in registers), and only the live ones: from
// the tile of the window's first key to the tile of the diagonal.  The
// TPU grid is static and iterates the dead tiles; here they are never
// visited.  A position count S that no tile divides is handled by masked
// tails (zero-filled loads, rows past S never stored).
//
// What bounds it on an H100: in fp32, operations.  At B = 4, S = 511,
// H = 32, D = 64 a layer does 4 * D FLOP per live (query, key) pair,
// 4.29 GFLOP, against 42 MB of q/k/v/o in fp32 (102 FLOP per byte, above
// the fp32 ridge of 20).  In bf16 (21 MB, 205 FLOP per byte, below the
// tensor cores' ridge of 295) the bound is the bytes.
//
// fp32 (flash_prefill_kernel): fp32 FMAs from shared memory (4 x 4 scores
// and 4 x D/16 outputs a thread, each shared value reused four times).
// It stays IEEE fp32: tensor cores would mean TF32.
//
// bf16 (flash_prefill_wgmma): one warpgroup of 128 threads owns the 64
// rows.  Both products run on the tensor cores: S = Q K^T as a wgmma
// m64n64k16 chain with Q and K from swizzled shared memory, and O += P V
// as a wgmma with P in registers (the score accumulator's fragment is
// the A fragment, so P never touches shared memory) and V read MN-major
// (transpose bit) from the tile that TMA wrote, so V needs no transposed
// copy.  K and V come by TMA (a 4-d tensor map over (B, S, K, D), boxes
// of 64 positions at one (b, kh), zero-filled past S and past D) into a
// two-stage ring; an mbarrier per stage carries the bytes, and the load
// of tile t + 1 is in flight while tile t is multiplied.  Q is loaded
// once, by the threads, into the same swizzled layout.  The head dim is
// padded with zeros to DP = 16, 32, 64 or 128 (the wgmma depth is 16),
// rows of 32, 64 or 128 bytes with the matching swizzle.  The online
// softmax works on the accumulator fragment: each thread holds two rows,
// and a row's max and sum are taken across the four threads that share
// it; the mask is applied only on tiles that cross the diagonal, the
// window's edge or S.  The softmax is most of the block's instructions
// (the products are a few wgmmas a tile), so scores are kept in log2
// units (the scale and log2(e) folded into one factor), and exp(s - m)
// is one MUFU.EX2 of their difference.  The last query tiles, which have
// the most live kv tiles, are scheduled first.  What holds it back (about
// 1.2x SDPA's device time on an H100): each tile's chain (wait, Q K^T,
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
constexpr int THREADS = 256;  // 16 x 16: rows ty*4..+3, columns tx + 16*j
constexpr int MAX_D = 128;
constexpr int NC = MAX_D / 16;  // output columns a thread holds
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

struct Shape {
  int b, s, k, g, d;
  int window;   // 0 = full causal
  int bq;       // query positions per block: ROWS / G
};

size_t smem_bytes(int d) {
  return sizeof(float) * (size_t)(ROWS * (d + 1) + BKV * (d + 1) + BKV * d
                                  + ROWS * (BKV + 1));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, Shape s) {
  extern __shared__ float smem[];
  const int D = s.d, G = s.g, ldk = D + 1, ldp = BKV + 1;
  float* qs = smem;                 // [ROWS][D + 1]
  float* ks = qs + ROWS * ldk;      // [BKV][D + 1]
  float* vs = ks + BKV * ldk;       // [BKV][D]
  float* ps = vs + BKV * D;         // [ROWS][BKV + 1]

  const int b = blockIdx.y / s.k, kh = blockIdx.y % s.k;
  const int q0 = blockIdx.x * s.bq;
  const int n_pos = min(s.bq, s.s - q0);
  const int rows = n_pos * G;       // live rows of this block
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float scale = 1.0f / sqrtf((float)D);
  // row r = (position q0 + r / G, head r % G); its G heads are contiguous
  const long long q_base = (((long long)b * s.s + q0) * s.k + kh) * G * D;
  const long long q_pos_stride = (long long)s.k * G * D;
  const long long kv_base = ((long long)b * s.s * s.k + kh) * D;
  const long long kv_pos_stride = (long long)s.k * D;

  for (int i = tid; i < ROWS * D; i += THREADS) {
    const int r = i / D, c = i % D;
    float x = 0.f;
    if (r < rows)
      x = to_f32(q[q_base + (r / G) * q_pos_stride + (r % G) * D + c]);
    qs[r * ldk + c] = x;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int q_last = q0 + n_pos - 1;
  const int k_first = s.window > 0 ? max(0, q0 - s.window + 1) : 0;
  for (int t = k_first / BKV; t <= q_last / BKV; ++t) {
    const int k0 = t * BKV;
    __syncthreads();                // the previous tile's ks/vs/ps are read
    for (int i = tid; i < BKV * D; i += THREADS) {
      const int j = i / D, c = i % D, pos = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (pos < s.s) {
        const long long off = kv_base + pos * kv_pos_stride + c;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[j * ldk + c] = kx;
      vs[j * D + c] = vx;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < D; ++c) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * ldk + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = ks[(tx + 16 * j) * ldk + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], bb[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, qpos = q0 + r / G;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool live = kpos <= qpos
            && (s.window == 0 || qpos - kpos < s.window);
        sc[i][j] = live ? sc[i][j] * scale : NEG;
        mx = fmaxf(mx, sc[i][j]);
      }
      // the 16 threads of a row are 16 neighbouring lanes of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sum += p;
        ps[r * ldp + tx + 16 * j] = to_f32(from_f32<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    const int n_kv = min(BKV, s.s - k0);
    for (int j = 0; j < n_kv; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * ldp + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        if (col < D) {
          const float vx = vs[j * D + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vx, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* out = o + q_base + (r / G) * q_pos_stride + (r % G) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) out[col] = from_f32<T>(acc[i][c] / denom);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   Shape s, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(MAX_D));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((s.s + s.bq - 1) / s.bq, s.b * s.k);
  flash_prefill_kernel<T><<<grid, THREADS, smem_bytes(s.d), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s);
  return cudaGetLastError();
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

// exp2 as the one MUFU.EX2 instruction (arguments <= 0; results below
// 2^-126 flush to 0, where exp's would add nothing to an fp32 sum of
// terms up to 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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
// in bf16, q, k and v 16-byte aligned (vector and TMA loads).
// Returns a cudaError_t: 0 after a launch that the runtime accepted.
extern "C" int flash_prefill_launch(int dtype, const void* q, const void* k,
                                    const void* v, void* o, int b, int s,
                                    int kh, int g, int d, int window,
                                    void* stream) {
  if (d < 8 || d > MAX_D || d % 8 != 0 || g < 1 || g > ROWS || s < 1)
    return (int)cudaErrorInvalidValue;
  Shape sh{b, s, kh, g, d, window, ROWS / g};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(q, k, v, o, sh, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (d <= 16) return (int)launch_wgmma<16>(q, k, v, o, sh, st);
  if (d <= 32) return (int)launch_wgmma<32>(q, k, v, o, sh, st);
  if (d <= 64) return (int)launch_wgmma<64>(q, k, v, o, sh, st);
  return (int)launch_wgmma<128>(q, k, v, o, sh, st);
}
