// Shared device helpers for the port's hand-written Hopper kernels:
// bf16 tensor-core MMA (mma.sync m16n8k16, fp32 accumulate), fragment
// packing and 32-bit shared/global fragment loads.
#pragma once

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

// Two B fragments (k 0..7 and 8..15) from a row-major [k][n] tile in shared
// memory: lanes 0..15 give the addresses of rows k = lane, 8 columns each.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1,
                                              const bf16* p) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a));
}

// lo goes to the low half: the lower k (or column) index of a fragment pair
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ uint4 ldg128(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void st32(bf16* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

}  // namespace tg
