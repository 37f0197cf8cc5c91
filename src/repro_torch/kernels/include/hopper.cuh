// Hopper (sm_90a) building blocks shared by the port's kernels: shared
// memory swizzle and wgmma descriptors, mbarriers, TMA tensor loads,
// cp.async copies, thread-block clusters with their distributed shared
// memory, and the wgmma instructions, each a thin wrapper of one PTX
// instruction (and a cluster launch).
//
// Layouts follow CUTLASS's canonical GMMA layouts (cute/atom/
// mma_traits_sm90_gmma.hpp).  A tile is stored in rows of R = 32, 64 or
// 128 bytes (the swizzle span), 16-byte chunks of row r XOR-permuted by
// r's bits (Swizzle<1|2|3, 4, 3> on the byte address: what TMA writes
// under CU_TENSOR_MAP_SWIZZLE_{32,64,128}B), each tile based on a
// 1024-byte boundary.
//   K-major operand (the reduction dim contiguous): rows are M/N, SBO =
//     8 rows (the next 8-row group), LBO unused; step k16 = +32 bytes.
//   MN-major operand (M/N contiguous, transpose bit 1): rows are k, an
//     atom covers R / 2 columns, SBO = 8 rows, LBO = the distance to the
//     next atom of columns; step k16 = +16 rows.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#define DEV __device__ __forceinline__

namespace hopper {

// byte offset within a swizzled tile (base 1024-aligned), rows of rb bytes
__host__ __device__ constexpr uint32_t swizzle(uint32_t off, int rb) {
  return off ^ ((off >> 3) & (rb == 128 ? 0x70u : rb == 64 ? 0x30u : 0x10u));
}

// wgmma layout code of a swizzle span: 1 = 128B, 2 = 64B, 3 = 32B
__host__ __device__ constexpr int layout_code(int rb) {
  return rb == 128 ? 1 : rb == 64 ? 2 : 3;
}

DEV uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor: rows of rb bytes, 8-row groups
// at SBO = 8 rb; lbo (bytes) is the distance between the column atoms of
// an MN-major operand wider than one atom (unused otherwise)
DEV uint64_t desc(uint32_t addr, int rb, uint32_t lbo = 16) {
  const uint64_t sbo = 8u * rb;
  return (uint64_t)((addr & 0x3FFFFu) >> 4)
       | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16)
       | ((sbo >> 4) << 32) | ((uint64_t)layout_code(rb) << 62);
}

// -- mbarriers --------------------------------------------------------------

DEV void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
DEV void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
DEV void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
DEV void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// wait until the phase of parity `parity` has completed.  A phase that
// never completes (a copy that cannot land) traps after about 2^26
// polls, so the launch fails with an error instead of hanging the card.
DEV void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// -- TMA ---------------------------------------------------------------------

DEV void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                     int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2) : "memory");
}
DEV void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                     int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// generic-proxy writes to shared memory made visible to wgmma and TMA
DEV void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- cp.async: copies into shared memory that the issuing thread waits for --

// 16 bytes, not kept in L1; where !valid nothing is read and the 16 bytes
// are zero filled (src must still be a mapped address)
DEV void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
// 8 bytes (.ca: the only form below 16 bytes), zero fill where !valid
DEV void cp_async8(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 8 : 0) : "memory");
}
DEV void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N> DEV void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// -- thread-block clusters and distributed shared memory ---------------------
// A cluster's blocks run at once on neighbouring SMs and can read each
// other's shared memory.  The port launches 1-d clusters along grid x.

DEV uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// every thread of every block of the cluster arrives, then waits: shared
// memory written before it is visible to all the cluster's blocks after
// it.  Also a block-wide barrier.  A block whose shared memory others
// read must pass one more of these before it exits.
DEV void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}
// the address, in the cluster's shared window, of `addr` (a shared::cta
// address of this block) in the shared memory of block `rank`
DEV uint32_t dsmem_map(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
DEV float ld_dsmem(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v) : "r"(addr) : "memory");
  return v;
}
DEV float4 ld_dsmem4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr) : "memory");
  return v;
}

// launch `kernel` on `grid` (x a multiple of `cluster`) in clusters of
// `cluster` blocks along x; returns what the runtime says
template <typename... KArgs, typename... Args>
cudaError_t launch_cluster(void (*kernel)(KArgs...), dim3 grid, dim3 block,
                           size_t smem, cudaStream_t stream, int cluster,
                           Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
}

// cuTensorMapEncodeTiled from the driver that the process has loaded
// (no link against libcuda: the library keeps a plain runtime link)
typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first; byte strides of dims
// 1..rank-1), boxes of `box`, swizzled rows of rb bytes, zero fill out of
// bounds.  Returns false if the driver refuses it.
inline bool make_map(CUtensorMap* map, const void* base, int rank,
                     const cuuint64_t* dims, const cuuint64_t* strides,
                     const cuuint32_t* box, int rb) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUtensorMapSwizzle sw = rb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                              : rb == 64  ? CU_TENSOR_MAP_SWIZZLE_64B
                                          : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// -- wgmma -------------------------------------------------------------------

DEV void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
DEV void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> DEV void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of accumulator
// registers across a wgmma issue or wait
template <int N> DEV void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// bf16 pair (lo = a) in one 32-bit register
DEV uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D(64 x 16, fp32) += A(64 x 16, bf16 registers) B(16 x 16, shared memory)
template <int TB>
DEV void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t db,
                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

// D(64 x 32, fp32) += A(64 x 16, bf16 registers) B(16 x 32, shared memory)
template <int TB>
DEV void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

// D(64 x 64, fp32) += A(64 x 16) B(16 x 64), A and B from shared memory
template <int TA, int TB>
DEV void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D(64 x 64, fp32) += A(64 x 16, bf16 registers) B(16 x 64, shared memory)
template <int TB>
DEV void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}


// D(64 x 128, fp32) += A(64 x 16) B(16 x 128), A and B from shared memory
template <int TA, int TB>
DEV void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D(64 x N) += A B for N = 64 or 128: A and B from shared memory
template <int N, int TA, int TB>
DEV void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 64) wgmma_ss_n64<TA, TB>(d, da, db, 1);
  else wgmma_ss_n128<TA, TB>(d, da, db, 1);
}
// D(64 x N) += A B for N = 16, 32 or 64, A (64 x 16 bf16) from registers
template <int N, int TB>
DEV void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16<TB>(d, a, db, 1);
  else if constexpr (N == 32) wgmma_rs_n32<TB>(d, a, db, 1);
  else wgmma_rs_n64<TB>(d, a, db, 1);
}

}  // namespace hopper
