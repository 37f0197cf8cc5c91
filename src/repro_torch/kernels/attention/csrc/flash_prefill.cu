// Causal GQA flash attention for prefill, with an optional sliding window.
//
// Replaces the TPU kernel src/repro/kernels/attention/flash_prefill.py:87
// (flash_prefill, body _flash_kernel).  Same function, not the same grid:
// q (B, S, K, G, D), k/v (B, S, K, D) in, o (B, S, K, G, D) out, where
// query position i of head (kh, g) sees key positions j <= i (and
// i - j < window when window > 0), with scores q.k / sqrt(D).
//
// Grid: (query tiles, B * K).  A block holds ROWS = 64 query rows, a row
// being one (position, head g) pair of its kv head: bq = 64 / G
// consecutive positions, all G heads of each, so every k/v tile it loads
// serves all G heads.  The rows of one position are G * D contiguous
// values, so the (B, S, K, G, D) layout is read in place through the
// offsets below: the reference's transposes to (B*K, S, G, D) are
// indexing here, not copies.  The block walks its kv tiles of 64
// positions with an online softmax (running max m, sum l, fp32
// accumulator in registers), and only the live ones: from the tile of
// the window's first key to the tile of the diagonal.  The TPU grid is
// static and iterates the dead tiles; here they are never visited.  A
// position count S that no tile divides is handled by masked tails
// (zero-filled loads, rows past S never stored), not by one S-sized tile.
//
// What bounds it on an H100: in fp32, operations.  At B = 4, S = 511,
// H = 32, D = 64 a layer does 4 * D FLOP per live (query, key) pair,
// 4.29 GFLOP, against 42 MB of q/k/v/o in fp32 (102 FLOP per byte, above
// the fp32 ridge of 20).  In bf16 (21 MB, 205 FLOP per byte, below the
// tensor cores' ridge of 295) the bound is the bytes.  This simple
// version does the FLOPs as fp32 FMAs from shared memory (4 x 4 scores
// and 4 x D/16 outputs a thread, each shared value reused four times),
// with no tensor cores (fp32 stays IEEE fp32), no cp.async or TMA
// pipelining: wgmma for bf16 and a pipelined kv loop come later.
//
// Numerics follow the reference: scores and softmax in fp32, masked
// scores -1e30, the probabilities rounded to the input dtype before the
// p @ v product (as `p.astype(v.dtype)` does), the sum l of the
// unrounded ones, and o = acc / max(l, 1e-30).
//
// Plain C interface, loaded with ctypes; the launch goes on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;      // (position, head) query rows per block
constexpr int BKV = 64;       // key positions per kv tile
constexpr int THREADS = 256;  // 16 x 16: rows ty*4..+3, columns tx + 16*j
constexpr int MAX_D = 128;
constexpr int NC = MAX_D / 16;  // output columns a thread holds
constexpr float NEG = -1e30f;

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Contiguous q (b, s, kh, g, d),
// k/v (b, s, kh, d) and o like q; d a multiple of 8 up to 128, g <= 64.
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
  if (dtype == 1) return (int)launch<__nv_bfloat16>(q, k, v, o, sh, st);
  return (int)cudaErrorInvalidValue;
}
