// Flash-decode attention: one new query token per sequence against a
// KV cache whose first valid_len entries are valid.
//
// Replaces the TPU kernel src/repro/kernels/attention/decode_attn.py:71
// (decode_attention, body _decode_attn_kernel).  Same function: q
// (B, K, G, D), k/v (B, W, K, D), a 0-d int32 valid_len, and
// o[b, kh, g] = softmax(q k^T / sqrt(D)) v over the cache entries
// w < valid_len, the rest masked with -1e30 as in the reference.
//
// One block per (b, kv head) holds the G query heads of that kv head and
// walks the cache in tiles of 64 entries with an online softmax (running
// max, sum and fp32 accumulator in shared memory).  valid_len is read on
// the device, from the pointer the wrapper passes: it is the counterpart
// of the TPU kernel's scalar prefetch, and the host never reads it, so a
// decode step does not wait on the card once per layer.  The loop stops
// at the last tile that holds a valid entry, so a short cache reads only
// what it holds.  (A valid_len <= 0 masks every entry; then, as in the
// reference, all W entries get equal weight.)
//
// What bounds it on an H100: bytes.  At B = 4, K = 8, D = 64 and 544
// valid entries a call reads 8.9 MB of k/v in fp32 for 4 * D FLOP per
// (head, entry), about 1 FLOP per byte.  This simple version uses one
// block per (b, kv head): 32 blocks at B = 4 on 132 SMs, which cannot
// pull the card's full bandwidth; at these sizes the launch itself costs
// about as much as the bound.  A split-KV form (several blocks per
// (b, kv head) and a combine pass) is the next step.
//
// Plain C interface, loaded with ctypes; the launch goes on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TS = 64;        // cache entries per tile (two per lane)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 64;
constexpr int MAX_D = 128;
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

size_t smem_bytes(int g, int d) {
  return sizeof(float) * (size_t)(2 * g * d + TS * (d + 1) + TS * d
                                  + g * TS + 3 * g);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ valid_len,
                   T* __restrict__ o, int W, int K, int G, int D) {
  extern __shared__ float smem[];
  const int ldk = D + 1;
  float* qs = smem;                 // [G][D]
  float* acc = qs + G * D;          // [G][D]
  float* ks = acc + G * D;          // [TS][D + 1]
  float* vs = ks + TS * ldk;        // [TS][D]
  float* ps = vs + TS * D;          // [G][TS]
  float* ms = ps + G * TS;          // [G] running max
  float* ls = ms + G;               // [G] running sum
  float* cs = ls + G;               // [G] this tile's correction

  const int bk = blockIdx.x, b = bk / K, kh = bk % K;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float scale = 1.0f / sqrtf((float)D);
  const int vl = *valid_len;
  const int live = vl <= 0 ? W : min(vl, W);   // entries the loop visits
  const long long row0 = (long long)bk * G * D;  // q/o rows of this block
  const long long kv_base = ((long long)b * W * K + kh) * D;
  const long long kv_pos_stride = (long long)K * D;

  for (int i = tid; i < G * D; i += THREADS) {
    qs[i] = to_f32(q[row0 + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    ms[g] = -INFINITY;
    ls[g] = 0.f;
  }

  for (int t0 = 0; t0 < live; t0 += TS) {
    __syncthreads();                // the previous tile's ks/vs/ps are read
    for (int i = tid; i < TS * D; i += THREADS) {
      const int j = i / D, c = i % D, pos = t0 + j;
      float kx = 0.f, vx = 0.f;
      if (pos < W) {
        const long long off = kv_base + pos * kv_pos_stride + c;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[j * ldk + c] = kx;
      vs[j * D + c] = vx;
    }
    __syncthreads();

    for (int i = tid; i < G * TS; i += THREADS) {
      const int g = i / TS, j = i % TS, pos = t0 + j;
      float dot = 0.f;
      for (int c = 0; c < D; ++c)
        dot = fmaf(qs[g * D + c], ks[j * ldk + c], dot);
      // masked entries weigh -1e30 as in the reference; entries past the
      // cache's end (the last tile's tail) weigh nothing
      ps[g * TS + j] = pos >= W ? -INFINITY : pos < vl ? dot * scale : NEG;
    }
    __syncthreads();

    for (int g = warp; g < G; g += WARPS) {
      const float a = ps[g * TS + lane], c = ps[g * TS + lane + 32];
      float mx = fmaxf(a, c);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = ms[g], m_new = fmaxf(m_old, mx);
      const float pa = expf(a - m_new), pc = expf(c - m_new);
      float sum = pa + pc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      // p rounded to the cache's dtype for p @ v, as the reference does
      ps[g * TS + lane] = to_f32(from_f32<T>(pa));
      ps[g * TS + lane + 32] = to_f32(from_f32<T>(pc));
      __syncwarp();                 // every lane has read ms[g]
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        ls[g] = ls[g] * corr + sum;
        ms[g] = m_new;
        cs[g] = corr;
      }
    }
    __syncthreads();

    const int n_kv = min(TS, W - t0);
    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D, c = i % D;
      float pv = 0.f;
      for (int j = 0; j < n_kv; ++j)
        pv = fmaf(ps[g * TS + j], vs[j * D + c], pv);
      acc[i] = acc[i] * cs[g] + pv;
    }
  }
  __syncthreads();

  for (int i = tid; i < G * D; i += THREADS)
    o[row0 + i] = from_f32<T>(acc[i] / fmaxf(ls[i / D], 1e-30f));
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* valid_len, void* o, int B, int W, int K, int G,
                   int D, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(MAX_G, MAX_D));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  decode_attn_kernel<T><<<B * K, THREADS, smem_bytes(G, D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid_len, static_cast<T*>(o), W, K, G, D);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Contiguous q (b, kh, g, d), k/v
// (b, w, kh, d) and o like q; valid_len points to one int32 on the device;
// d a multiple of 8 up to 128, g <= 64.
// Returns a cudaError_t: 0 after a launch that the runtime accepted.
extern "C" int decode_attention_launch(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* valid_len, void* o, int b,
                                       int w, int kh, int g, int d,
                                       void* stream) {
  if (d < 8 || d > MAX_D || d % 8 != 0 || g < 1 || g > MAX_G || w < 1)
    return (int)cudaErrorInvalidValue;
  const int* vl = static_cast<const int*>(valid_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(q, k, v, vl, o, b, w, kh, g, d, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, vl, o, b, w, kh, g, d, st);
  return (int)cudaErrorInvalidValue;
}
