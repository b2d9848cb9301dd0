// GroupNorm (+ SiLU) for Hopper (sm_90a), bf16 NCHW in and out:
//   out = act((x - mean_g) * (rsqrt(var_g + eps) * scale[c]) + bias[c])
// with the group statistics, the affine and the SiLU in fp32 and one
// rounding to bf16 at the end.  var_g is the centred variance
// E[(x - mean_g)^2]: the E[x^2] - mean^2 form cancels when |mean| >> std.
//
// Replaces theatergen_tpu/ops/groupnorm.py::fused_group_norm (_gn_fused /
// _kernel), the TPU kernel that keeps one batch item in VMEM and does stats,
// normalisation and activation in one pass.  Its one-hot [C, G] matmuls
// (group sums on the MXU for a channel-last layout) have no counterpart
// here: in NCHW each (batch, group) is one contiguous run of C/G·H·W
// elements.
//
// Bound on the H100: bytes.  The input is read once and the output written
// once, 4·B·C·H·W bytes at 3.35 TB/s; the SD1.5 512-px UNet's 61 norms move
// 0.36 GB per CFG evaluation (0.108 ms).  Design (simple first): one block of
// 1024 threads per (batch, group), 16-byte loads.  Three passes over the
// group: the sum, the centred sum of squares, then normalise and write.
// The first pass reads device memory; the group (at most 245 KB at SD1.5's
// shapes, 15.7 MB for a whole call) is still in the 50 MB L2 for the other
// two.  At B = 2 and 32 groups the grid is 64 blocks for 132
// SMs; a thread-block cluster per group that holds its slice in shared
// memory and exchanges partial sums through distributed shared memory is
// the one-read design for a later change.  H·W must be a multiple of 8, so
// no 16-byte piece straddles two channels.

#include "common.cuh"

using namespace tg;

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 8;  // bf16 values in one 16-byte load

// Sum of v over the block; red holds WARPS + 1 floats.  Consecutive calls
// need no barrier between them: a warp writes red[warp] of the next call
// only after passing this call's second barrier, which warp 0 reaches after
// reading every red[lane].
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = red[lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[WARPS] = v;
  }
  __syncthreads();
  return red[WARPS];
}

__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 p =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    f[2 * j] = p.x;
    f[2 * j + 1] = p.y;
  }
}

template <bool SILU>
__device__ __forceinline__ float affine(float x, float mean, float a, float b) {
  const float y = (x - mean) * a + b;
  return SILU ? y / (1.f + __expf(-y)) : y;
}

template <bool SILU>
__global__ void __launch_bounds__(THREADS, 1)
group_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ scale,
                  const bf16* __restrict__ bias, bf16* __restrict__ out,
                  int groups, int cpg, int hw, float eps) {
  __shared__ float red[WARPS + 1];
  const int c0 = (blockIdx.x % groups) * cpg;
  // batch b, group g start at (b·C + g·cpg)·HW = blockIdx.x·cpg·HW
  const long long base = (long long)blockIdx.x * cpg * hw;
  const uint4* xv = reinterpret_cast<const uint4*>(x + base);
  uint4* ov = reinterpret_cast<uint4*>(out + base);
  const int nvec = cpg * hw / VEC, vpc = hw / VEC;
  const float inv_n = 1.f / (float)(cpg * hw);
  float f[VEC];

  float s = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < nvec; i += THREADS) {
    unpack8(__ldg(xv + i), f);
#pragma unroll
    for (int j = 0; j < VEC; ++j) s += f[j];
  }
  const float mean = block_sum(s, red) * inv_n;

  float ss = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < nvec; i += THREADS) {
    unpack8(__ldg(xv + i), f);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float d = f[j] - mean;
      ss += d * d;
    }
  }
  const float inv = rsqrtf(block_sum(ss, red) * inv_n + eps);

#pragma unroll 4
  for (int i = threadIdx.x; i < nvec; i += THREADS) {
    const int c = c0 + i / vpc;
    const float a = inv * __bfloat162float(scale[c]);
    const float b = __bfloat162float(bias[c]);
    unpack8(__ldg(xv + i), f);
    uint4 o;
    o.x = pack_bf16(affine<SILU>(f[0], mean, a, b), affine<SILU>(f[1], mean, a, b));
    o.y = pack_bf16(affine<SILU>(f[2], mean, a, b), affine<SILU>(f[3], mean, a, b));
    o.z = pack_bf16(affine<SILU>(f[4], mean, a, b), affine<SILU>(f[5], mean, a, b));
    o.w = pack_bf16(affine<SILU>(f[6], mean, a, b), affine<SILU>(f[7], mean, a, b));
    ov[i] = o;
  }
}

}  // namespace

// x, out: bf16 [B, C, H, W] contiguous, 16-byte aligned; scale, bias: bf16
// [C].  C must be a multiple of groups and hw = H·W a multiple of 8 (the
// Python wrapper, ops/groupnorm.py, checks the same and raises).  silu != 0
// applies SiLU after the affine.  Returns cudaGetLastError().
extern "C" int tg_group_norm_fwd(const void* x, const void* scale,
                                 const void* bias, void* out, int B, int C,
                                 int hw, int groups, float eps, int silu,
                                 void* stream) {
  if (B < 0 || C <= 0 || hw <= 0 || groups <= 0 || C % groups != 0 ||
      hw % VEC != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const int cpg = C / groups;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * groups);
  auto xp = static_cast<const bf16*>(x);
  auto sp = static_cast<const bf16*>(scale);
  auto bp = static_cast<const bf16*>(bias);
  auto op = static_cast<bf16*>(out);
  if (silu)
    group_norm_kernel<true><<<grid, THREADS, 0, st>>>(xp, sp, bp, op, groups,
                                                      cpg, hw, eps);
  else
    group_norm_kernel<false><<<grid, THREADS, 0, st>>>(xp, sp, bp, op, groups,
                                                       cpg, hw, eps);
  return static_cast<int>(cudaGetLastError());
}
