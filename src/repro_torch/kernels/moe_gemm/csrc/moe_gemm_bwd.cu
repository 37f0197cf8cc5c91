// Backward of the grouped (expert-batched) GEMM: the two products of
// MoeGemm's backward, each reading its operands where they lie.
//
// Replaces no TPU kernel: the reference differentiates layers.moe's
// einsums (src/repro/models/transformer/layers.py:267-269) in XLA.  The
// forward is moe_gemm.cu.  One entry point, a layout code, fp32:
//   0, NT: out[e] = a[e] b[e]ᵀ, a (E, M, K), b (E, N, K) -> (E, M, N).
//          dx = dy wᵀ: a = dy (E, C, F), b = w (E, D, F), K = F.
//   1, TN: out[e] = a[e]ᵀ b[e], a (E, K, M), b (E, K, N) -> (E, M, N).
//          dw = xᵀ dy: a = x (E, C, D), b = dy (E, C, F), K = C.
// IEEE fp32 FMAs, no TF32, as the forward and training run.
//
// What bounds it on an H100: at granite-moe-3b-a800m's training products
// (E 40, C 512, D 1536, F 512, and the w2 twin) each product is 32 GFLOP
// against about 0.4 GB, operations: 0.48 ms at the fp32 peak of 67
// TFLOP/s.  At mixtral's experts at C 64 (E 8, D 4096, F 14336) dw
// writes 1.88 GB (0.56 ms at 3.35 TB/s) for 60 GFLOP (0.90 ms): still
// operations, with the output's write to hide under other blocks'
// products.  The design:
// - No transposed copies.  Shared memory holds both operands with k
//   outermost (As[k][m], Bs[k][n]), so one inner loop serves both
//   layouts.  TN's operands are contiguous along m and n: they land by
//   16-byte cp.async through a ring of 3 k-tiles of 16.  NT's are
//   contiguous along k: each thread loads its 16-byte runs along k into
//   registers one k-tile ahead and stores them transposed once the
//   tile's products are done, into the other of 2 stages.  Rows padded by
//   4 floats keep those stores and the fragment reads free of bank
//   conflicts.  One barrier a k-tile in both.
// - A core that feeds the FMAs: 8 x 8 outputs a thread as two 4-wide
//   groups in m and two in n (a warp covers 64 x 32, its 8 x 4 lanes
//   reading 128 and 64 contiguous bytes), so a k step is 2 LDS.128 of A
//   and 2 of B for 64 FMAs, and the next step's fragments load while
//   this one multiplies.  At most 128 registers a thread: two 256-thread
//   blocks an SM.
// - Tiles from the shape, chosen in Python (ops.py, bwd_plan): 128 x 128
//   outputs a block, or 64 x 128 where the output has at most 64 rows
//   (dx at C <= 64, where a 128-row tile would be half empty).  There
//   the 8 warps split each k-tile in two halves, and the halves' sums
//   meet in shared memory at the end, in a fixed order: mixtral's dx has
//   only 256 blocks, and 8 warps a block keep the SMs' schedulers fed.
// - VEC: 16-byte loads and stores where every row length is a multiple
//   of 4 and the pointers are 16-byte aligned; otherwise 4-byte ones, so
//   every fp32 shape runs in place.
// No split-K across blocks and no atomics: two calls give the same bits.
//
// Plain C interface, loaded with ctypes; the launch goes on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include "hopper.cuh"

namespace {

constexpr int BN = 128;   // output columns a block
constexpr int BK = 16;    // the k-tile
constexpr int PAD = 4;    // floats after each shared row

// 4 bytes into shared memory, zero filled where !valid (.ca: the only
// form below 16 bytes)
DEV void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// 256 threads, 8 warps of 64 x 32 outputs: at BM 128 two rows of four
// warps; at BM 64 one, twice, the two halves of each k-tile summed apart
// (KS 2) and added in a fixed order at the end
template <int BM, bool NT>
struct Tile {
  static constexpr int THREADS = 256;
  static constexpr int KS = 128 / BM;             // k-groups of warps
  static constexpr int STAGES = NT ? 2 : 3;
  static constexpr int LDA = BM + PAD, LDB = BN + PAD;
  static constexpr int STAGE = BK * (LDA + LDB);  // floats of a stage
  static constexpr int RED = KS > 1 ? BM * BN : 0;   // the k-groups' sum
  static constexpr int SMEM =
      4 * (STAGES * STAGE > RED ? STAGES * STAGE : RED);
};

// An operand contiguous along k (NT): R rows [r0, r0 + R) of `rows`, each
// of K floats, the k-tile at k0.  Slot s of the R x BK tile is row
// (s % 2R) / 2 at k (s % 2) * 4 + 8 (s / 2R): a warp reads 32 bytes of
// each of 16 rows, and its transposed stores (rows 16 apart in banks,
// since a padded row is 4 banks on) meet no conflict.
template <int R, int T, bool VEC>
struct KLoad {
  static constexpr int N = R * BK / 4 / T;
  float4 v[N];

  DEV void load(const float* p, int rows, int r0, int K, int k0, int tid) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int s = tid + i * T;
      const int r = r0 + (s % (2 * R)) / 2;
      const int k = k0 + (s % 2) * 4 + 8 * (s / (2 * R));
      const float* q = p + (long long)r * K + k;
      if (VEC) {
        v[i] = r < rows && k < K ? __ldg(reinterpret_cast<const float4*>(q))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        const bool ok = r < rows;
        v[i].x = ok && k < K ? __ldg(q) : 0.f;
        v[i].y = ok && k + 1 < K ? __ldg(q + 1) : 0.f;
        v[i].z = ok && k + 2 < K ? __ldg(q + 2) : 0.f;
        v[i].w = ok && k + 3 < K ? __ldg(q + 3) : 0.f;
      }
    }
  }

  // into s[k][row], rows of R + PAD floats
  DEV void store(float* s, int tid) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int t = tid + i * T;
      const int r = (t % (2 * R)) / 2;
      const int k = (t % 2) * 4 + 8 * (t / (2 * R));
      float* d = s + k * (R + PAD) + r;
      d[0] = v[i].x;
      d[R + PAD] = v[i].y;
      d[2 * (R + PAD)] = v[i].z;
      d[3 * (R + PAD)] = v[i].w;
    }
  }
};

// An operand contiguous along m or n (TN): BK rows of k from k0, columns
// [c0, c0 + R) of `cols`, into s[k][c] by cp.async (a warp copies 512
// contiguous bytes of a row)
template <int R, int T, bool VEC>
DEV void mn_issue(float* s, const float* p, int cols, int c0, int K, int k0,
                  int tid) {
  constexpr int N = R * BK / 4 / T;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int t = tid + i * T;
    const int k = t / (R / 4), c = (t % (R / 4)) * 4;
    const int kk = k0 + k, cc = c0 + c;
    const uint32_t dst = hopper::smem_addr(s + k * (R + PAD) + c);
    const float* q = p + (long long)kk * cols + cc;
    if (VEC) {
      const bool ok = kk < K && cc < cols;
      hopper::cp_async16(dst, ok ? q : p, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = kk < K && cc + j < cols;
        cp_async4(dst + 4 * j, ok ? q + j : p, ok);
      }
    }
  }
}

// the products of one k-tile: acc[i][j] += A[k][row i] B[k][col j], row
// i of rm + (i & 3) + 32 (i >> 2), column j of cn + (j & 3) + 16 (j >> 2)
template <int KT, int LDA, int LDB>
DEV void tile_products(float (&acc)[8][8], const float* As, const float* Bs,
                       int rm, int cn) {
  float4 fa[2][2], fb[2][2];
  fa[0][0] = *reinterpret_cast<const float4*>(As + rm);
  fa[0][1] = *reinterpret_cast<const float4*>(As + rm + 32);
  fb[0][0] = *reinterpret_cast<const float4*>(Bs + cn);
  fb[0][1] = *reinterpret_cast<const float4*>(Bs + cn + 16);
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const int cur = kk & 1;
    if (kk + 1 < KT) {
      const float* an = As + (kk + 1) * LDA;
      const float* bn = Bs + (kk + 1) * LDB;
      fa[cur ^ 1][0] = *reinterpret_cast<const float4*>(an + rm);
      fa[cur ^ 1][1] = *reinterpret_cast<const float4*>(an + rm + 32);
      fb[cur ^ 1][0] = *reinterpret_cast<const float4*>(bn + cn);
      fb[cur ^ 1][1] = *reinterpret_cast<const float4*>(bn + cn + 16);
    }
    const float av[8] = {fa[cur][0].x, fa[cur][0].y, fa[cur][0].z,
                         fa[cur][0].w, fa[cur][1].x, fa[cur][1].y,
                         fa[cur][1].z, fa[cur][1].w};
    const float bv[8] = {fb[cur][0].x, fb[cur][0].y, fb[cur][0].z,
                         fb[cur][0].w, fb[cur][1].x, fb[cur][1].y,
                         fb[cur][1].z, fb[cur][1].w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int BM, bool NT, bool VEC>
__global__ void __launch_bounds__(256, 2)
moe_gemm_bwd(const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ out, int M, int N, int K) {
  using TT = Tile<BM, NT>;
  constexpr int T = TT::THREADS, LDA = TT::LDA, LDB = TT::LDB;
  constexpr int KS = TT::KS, KB = BK / KS;    // k rows of a k-group
  extern __shared__ __align__(16) float smem[];
  const int e = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kg = KS > 1 ? warp / 4 : 0;
  const int rm = (KS > 1 ? 0 : warp / 4) * 64 + (lane / 4) * 4;
  const int cn = (warp % 4) * 32 + (lane % 4) * 4;
  const int ka = kg * KB * LDA, kb = BK * LDA + kg * KB * LDB;
  const float* ae = a + (long long)e * M * K;
  const float* be = b + (long long)e * N * K;
  const int nk = (K + BK - 1) / BK;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if constexpr (NT) {
    // a (M, K) and b (N, K): registers one k-tile ahead, 2 stages
    KLoad<BM, T, VEC> la;
    KLoad<BN, T, VEC> lb;
    la.load(ae, M, m0, K, 0, tid);
    lb.load(be, N, n0, K, 0, tid);
    la.store(smem, tid);
    lb.store(smem + BK * LDA, tid);
    __syncthreads();
    for (int kt = 0; kt < nk; ++kt) {
      float* cur = smem + (kt & 1) * TT::STAGE;
      float* nxt = smem + ((kt & 1) ^ 1) * TT::STAGE;
      // unconditional (past K they load zeros), so the compiler keeps the
      // loads ahead of the products; a condition shared with the stores
      // let it sink them to the stores, the latency then in full view
      la.load(ae, M, m0, K, (kt + 1) * BK, tid);
      lb.load(be, N, n0, K, (kt + 1) * BK, tid);
      tile_products<KB, LDA, LDB>(acc, cur + ka, cur + kb, rm, cn);
      la.store(nxt, tid);     // the other stage was last read before the
      lb.store(nxt + BK * LDA, tid);            // previous barrier
      __syncthreads();
    }
  } else {
    // a (K, M) and b (K, N): cp.async, a ring of 3 stages
    constexpr int S = TT::STAGES;
#pragma unroll
    for (int st = 0; st < S - 1; ++st) {
      if (st < nk) {
        float* s = smem + st * TT::STAGE;
        mn_issue<BM, T, VEC>(s, ae, M, m0, K, st * BK, tid);
        mn_issue<BN, T, VEC>(s + BK * LDA, be, N, n0, K, st * BK, tid);
      }
      hopper::cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      hopper::cp_async_wait<S - 2>();      // k-tile kt is in
      __syncthreads();                     // and kt - 1's stage is free
      const int nx = kt + S - 1;
      if (nx < nk) {
        float* s = smem + (nx % S) * TT::STAGE;
        mn_issue<BM, T, VEC>(s, ae, M, m0, K, nx * BK, tid);
        mn_issue<BN, T, VEC>(s + BK * LDA, be, N, n0, K, nx * BK, tid);
      }
      hopper::cp_async_commit();
      const float* cur = smem + (kt % S) * TT::STAGE;
      tile_products<KB, LDA, LDB>(acc, cur + ka, cur + kb, rm, cn);
    }
  }

  if constexpr (KS > 1) {      // k-group 1's sums through shared memory
    float* red = smem;
    __syncthreads();           // every stage read
    auto slot = [&](int i, int h) {
      return reinterpret_cast<float4*>(
          red + (rm + (i & 3) + 32 * (i >> 2)) * BN + cn + 16 * h);
    };
    if (kg == 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *slot(i, h) = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                    acc[i][4 * h + 2], acc[i][4 * h + 3]);
    }
    __syncthreads();
    if (kg == 1) return;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 o = *slot(i, h);
        acc[i][4 * h] += o.x;
        acc[i][4 * h + 1] += o.y;
        acc[i][4 * h + 2] += o.z;
        acc[i][4 * h + 3] += o.w;
      }
  }

  float* oe = out + (long long)e * M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + rm + (i & 3) + 32 * (i >> 2);
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + cn + 16 * h;
      float* q = oe + (long long)m * N + n;
      if (VEC) {
        if (n < N)
          *reinterpret_cast<float4*>(q) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                          acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) q[j] = acc[i][4 * h + j];
      }
    }
  }
}

template <int BM, bool NT, bool VEC>
cudaError_t run(const void* a, const void* b, void* out, int e, int m, int n,
                int k, cudaStream_t stream) {
  using TT = Tile<BM, NT>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        moe_gemm_bwd<BM, NT, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, TT::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, e);
  moe_gemm_bwd<BM, NT, VEC><<<grid, TT::THREADS, TT::SMEM, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), m, n, k);
  return cudaGetLastError();
}

template <bool NT, bool VEC>
cudaError_t by_rows(int rows, const void* a, const void* b, void* out, int e,
                    int m, int n, int k, cudaStream_t st) {
  return rows == 128 ? run<128, NT, VEC>(a, b, out, e, m, n, k, st)
                     : run<64, NT, VEC>(a, b, out, e, m, n, k, st);
}

}  // namespace

// dtype 0 (float32) only.  Contiguous a, b and out (e, m, n) as the
// layout code says (0 NT: a (e, m, k), b (e, n, k); 1 TN: a (e, k, m),
// b (e, k, n)), 1 <= e <= 65535, m, n, k >= 1; `rows` 64 or 128 (output
// rows a block; ceil(m / rows) <= 65535); `vec` 1 for 16-byte loads and
// stores, refused unless every row length (a's, b's, out's) is a multiple
// of 4 and the three pointers are 16-byte aligned.  Returns a
// cudaError_t: 0 after a launch the runtime accepted.
extern "C" int moe_gemm_bwd_launch(int dtype, const void* a, const void* b,
                                   void* out, int e, int m, int n, int k,
                                   int layout, int rows, int vec,
                                   void* stream) {
  if (dtype != 0 || e < 1 || e > 65535 || m < 1 || n < 1 || k < 1
      || layout < 0 || layout > 1 || (rows != 64 && rows != 128)
      || (m + rows - 1) / rows > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    const bool aligned = reinterpret_cast<uintptr_t>(a) % 16 == 0
        && reinterpret_cast<uintptr_t>(b) % 16 == 0
        && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const int a_row = layout == 0 ? k : m, b_row = layout == 0 ? k : n;
    if (!aligned || a_row % 4 || b_row % 4 || n % 4)
      return (int)cudaErrorInvalidValue;
    return layout == 0
        ? (int)by_rows<true, true>(rows, a, b, out, e, m, n, k, st)
        : (int)by_rows<false, true>(rows, a, b, out, e, m, n, k, st);
  }
  return layout == 0
      ? (int)by_rows<true, false>(rows, a, b, out, e, m, n, k, st)
      : (int)by_rows<false, false>(rows, a, b, out, e, m, n, k, st);
}
