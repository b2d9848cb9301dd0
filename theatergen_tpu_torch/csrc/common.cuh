// Shared device helpers for the port's hand-written Hopper kernels:
// bf16 tensor-core MMA (mma.sync m16n8k16, fp32 accumulate), fragment
// packing, 32-bit shared and 128-bit global loads; and for sm_90a:
// mbarriers, TMA tile loads and their tensor maps, 1-D bulk copies,
// thread-block-cluster barriers and distributed shared memory, warpgroup
// MMA (wgmma m64nNk16, bf16 -> fp32; m64n160k32, s8 -> s32) on
// 128-byte-swizzled shared-memory tiles; and the two pieces that
// ff_geglu.cu and geglu_matmul.cu share: a cluster's exchange of bf16 h
// pieces feeding a [128, 160] down-product, and the split reduction of its
// fp32 output tile.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tg {

typedef __nv_bfloat16 bf16;

// c[0..3] += A(16x16, row) * B(16x8, col); fragment layouts of the PTX ISA
// (groupID g = lane / 4, thread-in-group t = lane % 4):
//   a0: (g, 2t..2t+1)  a1: (g+8, 2t..)  a2: (g, 2t+8..)  a3: (g+8, 2t+8..)
//   b0: (k 2t..2t+1, n g)  b1: (k 2t+8.., n g)
//   c0,c1: (g, 2t..2t+1)  c2,c3: (g+8, 2t..2t+1)
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// lo goes to the low half: the lower k (or column) index of a fragment pair
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint4 ldg128(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void st32(bf16* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers (shared::cta) ----
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// arrive and add `bytes` to the transaction count that TMA copies
// targeting this barrier will complete
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// wait until the phase with the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n}\n"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}
// the same, acquiring what other CTAs of the cluster released with
// mbar_arrive_remote
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n}\n"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// ---- TMA: one thread copies a whole box global -> shared ----
// coordinates innermost first; completion counts on bar's transactions
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1) : "memory");
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}
// one thread copies a whole box shared -> global (rows and columns past
// the tensor's extent are dropped); then commit the bulk group and wait
// until the copy has read shared memory
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ---- 1-D bulk copies (no tensor map) ----
// `bytes` (a multiple of 16) from global src to this CTA's shared memory
// at dst, both 16-byte aligned, by the bulk-copy engine; completion counts
// on bar's transactions
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// hand registers between warpgroups: the producer's gives some up, the
// consumers' take them (ptxas then compiles each side to its own count)
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// A tensor map (bf16 unless `dtype` says otherwise) for TMA boxes (dims, strides and box innermost
// first; strides in bytes, for dimensions 1..).  With
// CU_TENSOR_MAP_SWIZZLE_128B a box of 64-element rows lands as 128-byte
// rows swizzled in 1024-byte atoms (box base 1024-byte aligned), the
// layout that wgmma_desc_sw128 describes; elements past the tensor's extent
// arrive as zeros.  Encoded on the host at each call (the driver entry
// point is fetched once through the runtime: no -lcuda).  Returns a
// CUresult.
inline int encode_tensor_map(CUtensorMap* map, const void* base, int rank,
                             const cuuint64_t* dims, const cuuint64_t* strides,
                             const cuuint32_t* box, CUtensorMapSwizzle swizzle,
                             CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                             const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                             const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<Encode>(fn);
  }();
  if (encode == nullptr) return static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return static_cast<int>(encode(
      map, dtype, rank, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// ---- thread-block clusters ----
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// CTAs in this cluster (1 for a launch without a cluster dimension)
__device__ __forceinline__ uint32_t cluster_nctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
// every thread of every CTA of the cluster arrives (release: its shared
// writes before it become visible to the cluster) ...
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
// ... and waits for all of them (acquire)
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// an arrival that releases nothing: after fence.mbarrier_init, it tells
// the peers that this CTA's mbarriers exist
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
// the shared::cluster address of p's offset in CTA `rank` of this cluster
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  return remote;
}
// one arrival on the mbarrier at bar's offset in CTA `rank`, releasing
// this thread's (and, cumulatively, what it observed of its warp's) shared
// writes to the cluster
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, uint32_t rank) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
               :: "r"(cluster_addr(bar, rank)) : "memory");
}
// 16 bytes at the same shared offset as p, in the shared memory of CTA
// `rank` of this cluster
__device__ __forceinline__ uint4 ld_dsmem128(const void* p, uint32_t rank) {
  const uint32_t remote = cluster_addr(p, rank);
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(remote)
               : "memory");
  return v;
}

// 16 bytes to the same shared offset as p in CTA `rank` of this cluster;
// completion counts 16 bytes on the transactions of the mbarrier at bar's
// offset in that CTA
__device__ __forceinline__ void st_async128(const void* p, uint4 v, uint64_t* bar,
                                            uint32_t rank) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32"
      " [%0], {%1, %2, %3, %4}, [%5];\n"
      :: "r"(cluster_addr(p, rank)), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w),
         "r"(cluster_addr(bar, rank)) : "memory");
}
// `bytes` (a multiple of 16) from this CTA's shared memory at src to the
// same offset in CTA `rank`, by the bulk-copy engine; completion counts on
// the transactions of the mbarrier at bar's offset in that CTA
__device__ __forceinline__ void bulk_copy_to_peer(const void* src, uint32_t bytes,
                                                  uint64_t* bar, uint32_t rank) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(cluster_addr(src, rank)), "r"(smem_u32(src)), "r"(bytes),
         "r"(cluster_addr(bar, rank)) : "memory");
}
// orders this thread's generic-proxy shared writes to its own CTA before
// later async-proxy accesses of them (a bulk copy, a wgmma operand)
__device__ __forceinline__ void fence_proxy_async_cta() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// a named barrier of the first `N` threads of the CTA (id 1; id 0 is
// __syncthreads)
template <int N>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(N) : "memory");
}

// ---- warpgroup MMA ----
// A K-major operand of 128-byte rows (64 bf16) in TMA's 128-byte swizzle:
// 8-row atoms of 1024 bytes; the next 16 columns of depth start 32 bytes
// further on.  An MN-major operand in the same swizzle (rows along K, 64
// columns of N each): lbo bytes between 64-column panels, 8-row groups at
// 1024.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(uint32_t addr, uint32_t lbo = 16) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>(lbo >> 4) << 16
         | static_cast<uint64_t>(1024 >> 4) << 32
         | 1ull << 62;  // layout 1: 128-byte swizzle
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// Accumulator layout of m64nN (per warp w of the warpgroup, g = lane / 4,
// t = lane % 4): d[4i + 0..1] = rows 16w + g, columns 8i + 2t, +1;
// d[4i + 2..3] = row 16w + g + 8, the same columns.  The register A
// operand of m64k16 takes mma_16816's A fragment (rows 16w + ...).

// d[32] (+)= A(64x16, smem desc) * B(64x16, smem desc), both K-major
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da,
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64] (+)= A(64x16, smem desc) * B(128x16, smem desc), both K-major
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da,
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[8] (+)= A(64x16, smem desc) * B(16x16, smem desc), both K-major
__device__ __forceinline__ void wgmma_m64n16k16_ss(float (&d)[8], uint64_t da,
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[40] (+)= A(64x16, smem desc) * B(80x16, smem desc), both K-major
__device__ __forceinline__ void wgmma_m64n80k16_ss(float (&d)[40], uint64_t da,
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[20] (+)= A(64x16, registers) * B(40x16, smem desc); TB: B MN-major
template <int TB>
__device__ __forceinline__ void wgmma_m64n40k16_rs(float (&d)[20], const uint32_t (&a)[4],
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19"
      "}, {%20, %21, %22, %23}, %24, p, 1, 1, %26;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(TB));
}

// d[32] (+)= A(64x16, registers) * B(64x16, smem desc); TB: B MN-major
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(TB));
}

// d[40] (+)= A(64x16, registers) * B(80x16, smem desc); TB: B MN-major
template <int TB>
__device__ __forceinline__ void wgmma_m64n80k16_rs(float (&d)[40], const uint32_t (&a)[4],
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(TB));
}

// d[80] (+)= A(64x16, registers) * B(160x16, smem desc); TB: B MN-major
template <int TB>
__device__ __forceinline__ void wgmma_m64n160k16_rs(float (&d)[80], const uint32_t (&a)[4],
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, %86;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(TB));
}

// d[80] (+)= A(64x32, smem desc) * B(160x32, smem desc), int8 -> int32,
// both K-major (the only layout wgmma takes for integer operands)
__device__ __forceinline__ void wgmma_m64n160k32_s8_ss(int (&d)[80], uint64_t da,
                                                      uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79])
      : "l"(da), "l"(db), "r"(accumulate));
}

// ---- the cluster's [128, 160] down-product (ff_geglu.cu, geglu_matmul.cu) ----
// A cluster of C CTAs owns 128 rows; CTA r owns output columns [160r,
// 160r + 160).  Per chunk of 64·C inner columns, CTA r makes the bf16 h
// piece [128, 64] of its 64 inner columns in registers (two consumer
// warpgroups of 64 rows, 16 registers a thread in wgmma's register A
// fragment layout), and every CTA runs the down-product of its 160
// columns over all C pieces, reading the other C - 1 from its neighbours'
// shared memory.

constexpr int DOWN_CONSUMERS = 256;  // two warpgroups
constexpr int DOWN_NO = 160;         // output columns per CTA
constexpr int DOWN_HP = 64;          // inner columns per CTA and chunk
constexpr int H_SLOT_BYTES = DOWN_CONSUMERS * 64;  // one h piece
constexpr int W_TILE_BYTES = DOWN_NO * DOWN_HP * 2;  // a W tile [160, 64]

// The consumer side of a TMA ring: wait for step s's tiles; hand a stage
// back (one arrival a warp) once the wgmma group that read it completed.
template <int STAGES, int STAGE_BYTES>
struct RingConsumer {
  uint64_t* full;
  uint64_t* empty;
  uint32_t base;
  int lane;
  __device__ __forceinline__ uint32_t ready(int s) const {
    mbar_wait(&full[s % STAGES], (s / STAGES) & 1);
    return base + (s % STAGES) * STAGE_BYTES;
  }
  __device__ __forceinline__ void release(int s) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s % STAGES]);
  }
};

// One chunk (index ci) of the exchange and down-product.  `own` holds this
// CTA's piece.  It is published in buffer ci % 2 of `slots` (two
// H_SLOT_BYTES buffers) once every reader is done with chunk ci - 2's,
// and counted on h_full[ci % 2] of every CTA (C·8 arrivals); each reader
// frees the owners' buffers on their h_free at the chunk's end ((C - 1)·8
// arrivals).  Ring steps
// s, s + 1, ... are the W tiles [160, 64] of pieces rank, rank + 1, ...
// (mod C), as the producer loads them; acc += piece · tile^T.  A remote
// read costs about a microsecond, so the pieces are read ahead into five
// register sets: pieces 1-4 together while this CTA's own product runs,
// piece p (> 4) in step p - 4, into the set whose product has completed.
template <int C, int STAGES, int STAGE_BYTES>
__device__ __forceinline__ void exchange_down_chunk(
    float (&acc)[80], const uint32_t (&own)[16], unsigned char* slots,
    uint64_t* h_full, uint64_t* h_free, int ci, int rank, int tid,
    const RingConsumer<STAGES, STAGE_BYTES>& ring, int& s) {
  constexpr int SETS = 5;
  const int buf = ci & 1, lane = tid & 31;
  // 16-byte piece i of thread tid at (i·256 + tid)·16: a warp's loads and
  // stores cover 512 contiguous bytes
  uint4* slot = reinterpret_cast<uint4*>(slots + buf * H_SLOT_BYTES) + tid;
  if (ci >= 2) mbar_wait_cluster(&h_free[buf], ((ci >> 1) - 1) & 1);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    slot[i * DOWN_CONSUMERS] =
        make_uint4(own[4 * i], own[4 * i + 1], own[4 * i + 2], own[4 * i + 3]);
  __syncwarp();
  if (lane < C) mbar_arrive_remote(&h_full[buf], lane);

  uint32_t hs[SETS][16];
#pragma unroll
  for (int i = 0; i < 16; ++i) hs[0][i] = own[i];
  // piece p of this chunk, from CTA (rank + p) mod C, into its set
  auto fetch = [&](int p) {
    const uint32_t j = (rank + p) % C;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 r = ld_dsmem128(slot + i * DOWN_CONSUMERS, j);
      hs[p % SETS][4 * i] = r.x; hs[p % SETS][4 * i + 1] = r.y;
      hs[p % SETS][4 * i + 2] = r.z; hs[p % SETS][4 * i + 3] = r.w;
    }
  };
#pragma unroll
  for (int q = 0; q < C; ++q, ++s) {
    const uint32_t st = ring.ready(s);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DOWN_HP / 16; ++kk) {
      const uint32_t a[4] = {hs[q % SETS][4 * kk], hs[q % SETS][4 * kk + 1],
                             hs[q % SETS][4 * kk + 2], hs[q % SETS][4 * kk + 3]};
      wgmma_m64n160k16_rs<0>(acc, a, wgmma_desc_sw128(st + kk * 32), 1);
    }
    wgmma_commit();
    if (q == 0) {
      mbar_wait_cluster(&h_full[buf], (ci >> 1) & 1);
#pragma unroll
      for (int p = 1; p < SETS && p < C; ++p) fetch(p);
    }
    // the group before this one is done: its set takes piece q + 4
    wgmma_wait<1>();
    fence_regs(acc);
    if (q > 0 && q + SETS - 1 < C) fetch(q + SETS - 1);
    if (q > 0) ring.release(s - 1);
  }
  // every piece is in registers (its product issued): the owners' buffers
  // may be overwritten.  Freed once, here: a cluster-scope release per
  // piece would wait on the read-ahead loads still in flight
  __syncwarp();
  if (lane > 0 && lane < C) mbar_arrive_remote(&h_free[buf], (rank + lane) % C);
  wgmma_wait<0>();
  fence_regs(acc);
  ring.release(s - 1);
}

// The consumers' fp32 tile [128, 160] (thread: rows row0 and row0 + 8,
// columns o0 + 8i + 2t, +1) rounded into bf16 out [M, ldo].  With gridDim.y
// = splits > 1, each split writes its partial to partial [splits, M, ldo]
// and counts itself in counters[blockIdx.x]; only the last split to
// arrive goes on: it reads back all the partials (its own too), sums them
// in split order, so the result does not depend on which split finishes
// last, writes the tile and resets the counter for the next call.
__device__ __forceinline__ void store_split_tile(
    float (&acc)[80], bf16* __restrict__ out, float* __restrict__ partial,
    int* __restrict__ counters, int M, int ldo, int o0, int row0, int t,
    int tid) {
  const int splits = gridDim.y, split = blockIdx.y;
  if (splits > 1) {
    __shared__ int is_last;
#pragma unroll
    for (int i = 0; i < DOWN_NO / 8; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + 8 * half;
        if (r < M)
          __stcg(reinterpret_cast<float2*>(
                     partial + ((long long)split * M + r) * ldo + o0 + 8 * i + 2 * t),
                 make_float2(acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1]));
      }
    __threadfence();
    named_sync<DOWN_CONSUMERS>();
    if (tid == 0) is_last = atomicAdd(&counters[blockIdx.x], 1) == splits - 1;
    named_sync<DOWN_CONSUMERS>();
    if (!is_last) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < DOWN_NO / 2; ++i) acc[i] = 0.f;
    // every load of a partial issued before any is used (a load guarded
    // by a branch of its own would wait out its latency one by one)
    for (int sp = 0; sp < splits; ++sp) {
      const float* ps = partial + (long long)sp * M * ldo;
      float2 v[DOWN_NO / 8][2];
#pragma unroll
      for (int i = 0; i < DOWN_NO / 8; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = row0 + 8 * half;
          v[i][half] = r < M ? __ldcg(reinterpret_cast<const float2*>(
                                   ps + (long long)r * ldo + o0 + 8 * i + 2 * t))
                             : make_float2(0.f, 0.f);
        }
#pragma unroll
      for (int i = 0; i < DOWN_NO / 8; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          acc[4 * i + 2 * half] += v[i][half].x;
          acc[4 * i + 2 * half + 1] += v[i][half].y;
        }
    }
    if (tid == 0) counters[blockIdx.x] = 0;
  }
#pragma unroll
  for (int i = 0; i < DOWN_NO / 8; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + 8 * half;
      if (r < M)
        st32(out + (long long)r * ldo + o0 + 8 * i + 2 * t,
             pack_bf16(acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1]));
    }
}

}  // namespace tg
