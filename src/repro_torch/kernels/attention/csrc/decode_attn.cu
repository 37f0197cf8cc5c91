// Flash-decode attention: one new query token per sequence against a
// KV cache whose first valid_len entries are valid.
//
// Replaces the TPU kernel src/repro/kernels/attention/decode_attn.py:71
// (decode_attention, body _decode_attn_kernel).  Same function: q
// (B, K, G, D), k/v (B, W, K, D), a 0-d int32 valid_len, and
// o[b, kh, g] = softmax(q k^T / sqrt(D)) v over the cache entries
// w < valid_len, the rest masked with -1e30 as in the reference (a
// valid_len <= 0 masks every entry; then all W entries get equal weight).
// valid_len is read on the device, from the pointer the wrapper passes:
// the counterpart of the TPU kernel's scalar prefetch.  The host never
// reads it, so a decode step does not wait on the card once per layer.
//
// What bounds it on an H100: bytes.  At Llama-3.2-1B's B = 4, K = 8,
// G = 4, D = 64 and 544 cache entries a call reads 8.9 MB of k/v in fp32
// (4.5 in bf16) for 4 D FLOP per (head, entry): about 1 FLOP per byte,
// 2.7 us (1.3) at 3.35 TB/s.  One block per (b, kv head) would give 32
// blocks for 132 SMs.  So the design splits the cache (split-KV) and
// combines the splits inside one launch:
//   * S <= 8 splits per (b, kv head), chosen by the wrapper from W and
//     B K only (ops.py, `decode_splits`): at most one block a SM, since a
//     cluster's blocks must find room in one GPC together; one 192-thread
//     block per (b, kv head, split), the S splits of a (b, kv head) one
//     cluster.
//     Split r takes entries [r W / S, (r + 1) W / S) below valid_len; a
//     split that starts at or past it loads nothing (m = -inf, l = 0);
//   * q (G x D) is held in fp32 registers, pre-scaled by log2(e)/sqrt(D);
//     each warp reads rows of k and v with 16-byte loads, a row across
//     D/4 (fp32) or D/8 (bf16) lanes, several rows in flight a lane;
//     the q.k dot closes with shuffles: nothing is staged through shared
//     memory; a block pass has 96 rows in flight;
//   * an online softmax in log2 units per (lane group, head), fp32 scores
//     and accumulators; p is rounded to the cache's dtype before p.v, as
//     the reference rounds its weights;
//   * the states (running max m, sum l, accumulator) merge in a fixed
//     order: lane groups by shuffles, warps through shared memory, then
//     after a cluster barrier each rank folds splits 0..S-1 over
//     distributed shared memory for its share of the G D outputs and
//     stores them.  One launch a call, no workspace, no atomics: a run
//     repeats bit for bit, and the launch can be captured in a graph.
// Heads run eight at a time (more than eight re-read the split's rows).
//
// Plain C interface, loaded with ctypes; the launch goes on the caller's
// stream, allocates nothing, and returns the launch's cudaError_t.

#include "hopper.cuh"

#include <math.h>

namespace {

constexpr int THREADS = 192;  // 6 warps: 96 rows in flight a block pass
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 64;
constexpr int MAX_D = 128;
constexpr int MAX_SPLIT = 8;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// fp32 values of one 16-byte load
template <typename T> struct Lanes;
template <> struct Lanes<float> { static constexpr int VEC = 4; };
template <> struct Lanes<__nv_bfloat16> { static constexpr int VEC = 8; };

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 16 bytes of the cache, read once: not kept in L1
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  return r;
}

// p as the cache's dtype holds it
__device__ __forceinline__ float round_to(float p, float) { return p; }
__device__ __forceinline__ float round_to(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(p));
}
__device__ __forceinline__ void store4(float* o, const float (&v)[4]) {
  *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* o, const float (&v)[4]) {
  uint2 u;
  u.x = hopper::pack_bf16(v[0], v[1]);
  u.y = hopper::pack_bf16(v[2], v[3]);
  *reinterpret_cast<uint2*>(o) = u;
}

// the weight of a state of running max m against a merged max mx
__device__ __forceinline__ float rescale(float m, float mx) {
  return m == -INFINITY ? 0.f : exp2f(m - mx);
}

size_t smem_bytes(int gc, int g, int d) {
  return sizeof(float) * (size_t)(WARPS * gc * (d + 2) + g * (d + 2));
}

// grid (S * B * K), clusters of S along x; two blocks a SM (GC <= 4)
template <typename T, int GC>
__global__ void __launch_bounds__(THREADS, GC == 8 ? 1 : 2)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ valid_len,
                   T* __restrict__ o, int W, int K, int G, int D, int S) {
  constexpr int VEC = Lanes<T>::VEC;
  constexpr int U = GC == 8 ? 2 : 32 / VEC;        // passes in flight
  extern __shared__ __align__(16) float smem[];
  float* ws_acc = smem;                           // [WARPS][GC][D]
  float* ws_m = ws_acc + WARPS * GC * D;          // [WARPS][GC]
  float* ws_l = ws_m + WARPS * GC;                // [WARPS][GC]
  float* blk_acc = ws_l + WARPS * GC;             // [G][D], this split
  float* blk_m = blk_acc + G * D;                 // [G]
  float* blk_l = blk_m + G;                       // [G]

  const int rank = (int)hopper::cluster_rank();
  const int bk = blockIdx.x / S, b = bk / K, kh = bk % K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int lpr = 1;                                    // lanes a row, a power of 2
  while (lpr * VEC < D) lpr <<= 1;
  const int rp = 32 / lpr, grp = lane / lpr, d0 = (lane % lpr) * VEC;
  const bool act = d0 < D;
  const float qscale = LOG2E / sqrtf((float)D);

  // this split's entries below valid_len: [e0, e1)
  const int vl = *valid_len;
  const int live = vl <= 0 ? W : min(vl, W);
  const int e0 = (int)((long long)rank * W / S);
  const int e1 = min((int)((long long)(rank + 1) * W / S), live);
  const int step = WARPS * U * rp;                // rows of a block pass
  const long long row_stride = (long long)K * D;
  const T* kp = k + ((long long)b * W * K + kh) * D + d0;
  const T* vp = v + ((long long)b * W * K + kh) * D + d0;
  const long long qo = (long long)bk * G * D;     // q/o rows of (b, kh)

  for (int h0 = 0; h0 < G; h0 += GC) {
    float qr[GC][VEC];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      const uint4 raw = act && h0 + g < G
          ? ld_stream(q + qo + (long long)(h0 + g) * D + d0)
          : make_uint4(0u, 0u, 0u, 0u);
      unpack(raw, qr[g]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) qr[g][j] *= qscale;
    }
    float m[GC], l[GC], acc[GC][VEC];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      m[g] = -INFINITY;
      l[g] = 0.f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[g][j] = 0.f;
    }

    // warp w takes rows base + u rp + grp, base = e0 + w U rp + i step
    for (int base = e0 + warp * U * rp; base < e1; base += step) {
      uint4 kr[U], vr[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int row = base + u * rp + grp;
        if (act && row < e1) {
          kr[u] = ld_stream(kp + row * row_stride);
          vr[u] = ld_stream(vp + row * row_stride);
        } else {
          kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      float s[U][GC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[VEC];
        unpack(kr[u], kf);
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int j = 0; j < VEC; ++j) dot = fmaf(qr[g][j], kf[j], dot);
          s[u][g] = dot;
        }
      }
      // the row's lanes close the dots, U GC shuffles a step in flight
      for (int off = lpr >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int g = 0; g < GC; ++g)
            s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
      }
      // masked entries weigh -1e30 as in the reference: with valid_len > 0
      // none is visited, with valid_len <= 0 all are
      if (vl <= 0) {
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int g = 0; g < GC; ++g) s[u][g] = NEG;
      }
      float vf[U][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u) unpack(vr[u], vf[u]);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (base + u * rp + grp < e1) mx = fmaxf(mx, s[u][g]);
        if (mx == -INFINITY) continue;            // no row of this group
        const float corr = exp2f(m[g] - mx);      // 0 while m[g] = -inf
        float p[U], psum = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          p[u] = base + u * rp + grp < e1 ? exp2f(s[u][g] - mx) : 0.f;
          psum += p[u];
          p[u] = round_to(p[u], T());
        }
        l[g] = l[g] * corr + psum;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float a = acc[g][j] * corr;
#pragma unroll
          for (int u = 0; u < U; ++u) a = fmaf(p[u], vf[u][j], a);
          acc[g][j] = a;
        }
        m[g] = mx;
      }
    }

    // lane groups of a warp, by shuffles (both partners get the same bits)
    for (int off = lpr; off < 32; off <<= 1) {
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
        const float mx = fmaxf(m[g], mo);
        const float s1 = rescale(m[g], mx), s2 = rescale(mo, mx);
        l[g] = l[g] * s1 + lo * s2;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[g][j], off);
          acc[g][j] = acc[g][j] * s1 + ao * s2;
        }
        m[g] = mx;
      }
    }
    if (grp == 0 && act) {
#pragma unroll
      for (int g = 0; g < GC; ++g) {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          ws_acc[(warp * GC + g) * D + d0 + j] = acc[g][j];
        if (d0 == 0) {
          ws_m[warp * GC + g] = m[g];
          ws_l[warp * GC + g] = l[g];
        }
      }
    }
    __syncthreads();
    // the warps, in order, into this split's state for heads h0..h0+GC-1
    for (int i = tid; i < GC * D; i += THREADS) {
      const int g = i / D, d = i - g * D;
      if (h0 + g >= G) continue;
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, ws_m[w * GC + g]);
      float a = 0.f, ls = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float sc = rescale(ws_m[w * GC + g], mx);
        a += ws_acc[(w * GC + g) * D + d] * sc;
        ls += ws_l[w * GC + g] * sc;
      }
      blk_acc[(h0 + g) * D + d] = a;
      if (d == 0) {
        blk_m[h0 + g] = mx;
        blk_l[h0 + g] = ls;
      }
    }
    __syncthreads();                              // ws_* free again
  }

  // -- the splits of the cluster, in order; rank r stores its share -------
  hopper::cluster_sync();
  const uint32_t am = hopper::smem_addr(blk_m), al = hopper::smem_addr(blk_l);
  const uint32_t aa = hopper::smem_addr(blk_acc);
  const int n4 = G * D / 4;
  const int i1 = (int)((long long)(rank + 1) * n4 / S);
  for (int i = (int)((long long)rank * n4 / S) + tid; i < i1; i += THREADS) {
    const int g = 4 * i / D, d = 4 * i - g * D;
    float mr[MAX_SPLIT], mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r) {
      if (r >= S) break;
      mr[r] = hopper::ld_dsmem(hopper::dsmem_map(am + 4u * g, r));
      mx = fmaxf(mx, mr[r]);
    }
    float ls = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r) {
      if (r >= S) break;
      const float sc = rescale(mr[r], mx);
      ls += hopper::ld_dsmem(hopper::dsmem_map(al + 4u * g, r)) * sc;
      const float4 ar = hopper::ld_dsmem4(
          hopper::dsmem_map(aa + 4u * (g * D + d), r));
      a[0] += ar.x * sc; a[1] += ar.y * sc;
      a[2] += ar.z * sc; a[3] += ar.w * sc;
    }
    const float den = fmaxf(ls, 1e-30f);
    float out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = a[j] / den;
    store4(o + qo + (long long)g * D + d, out);
  }
  hopper::cluster_sync();                         // no block leaves early
}

template <typename T, int GC>
cudaError_t launch_g(const void* q, const void* k, const void* v,
                     const int* valid_len, void* o, int B, int W, int K,
                     int G, int D, int S, cudaStream_t stream) {
  auto kernel = decode_attn_kernel<T, GC>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(GC, MAX_G, MAX_D));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long blocks = (long long)S * B * K;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  return hopper::launch_cluster(
      kernel, dim3((unsigned)blocks), dim3(THREADS), smem_bytes(GC, G, D),
      stream, S, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid_len, static_cast<T*>(o), W, K, G, D, S);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* valid_len, void* o, int B, int W, int K, int G,
                   int D, int S, cudaStream_t st) {
  if (G <= 1) return launch_g<T, 1>(q, k, v, valid_len, o, B, W, K, G, D, S, st);
  if (G <= 2) return launch_g<T, 2>(q, k, v, valid_len, o, B, W, K, G, D, S, st);
  if (G <= 4) return launch_g<T, 4>(q, k, v, valid_len, o, B, W, K, G, D, S, st);
  return launch_g<T, 8>(q, k, v, valid_len, o, B, W, K, G, D, S, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Contiguous q (b, kh, g, d), k/v
// (b, w, kh, d) and o like q, 16-byte aligned; valid_len points to one
// int32 on the device; d a multiple of 8 up to 128, g <= 64; splits
// 1..8, at most w (ops.py's `decode_splits`).
// Returns a cudaError_t: 0 after a launch that the runtime accepted.
extern "C" int decode_attention_launch(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* valid_len, void* o, int b,
                                       int w, int kh, int g, int d,
                                       int splits, void* stream) {
  if (d < 8 || d > MAX_D || d % 8 != 0 || g < 1 || g > MAX_G || w < 1 ||
      splits < 1 || splits > MAX_SPLIT || splits > w)
    return (int)cudaErrorInvalidValue;
  const int* vl = static_cast<const int*>(valid_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, vl, o, b, w, kh, g, d, splits, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, vl, o, b, w, kh, g, d, splits,
                                      st);
  return (int)cudaErrorInvalidValue;
}
