// Fused transformer feed-forward for Hopper (sm_90a), bf16 in/out:
//   out = geglu(x @ W1^T + b1) @ W2^T,  geglu(hg) = hg[:, :K] * gelu(hg[:, K:])
//
// Replaces theatergen_tpu/ops/geglu_matmul.py::ff_matmul (_ff_matmul_2d /
// _ff_kernel_naive).  Weights come in the layout the kernel reads, the
// module's own [out, in] (W1 [2K, D], b1 [2K], W2 [D, K]): no transpose copy.
// The net.2 bias is added by the caller.
//
// Bound on the H100: 6·M·D·K operations over 2·(M·D·2 + 3·D·K) bytes.  At
// SD1.5's 64²/32²/16² levels the tensor cores bound it; at the 8² mid block
// (M = 128) the 39 MB of weights do.  What the TPU kernel exists for is kept:
// the [M, 2K] up-projection never reaches device memory.  One block owns BM
// rows and all D output columns, with the fp32 accumulator in registers
// (8 warps, each owning D/8 output columns).  The inner dimension streams in
// chunks of 64: up-product (x tile in shared memory, W1 fragments straight
// from global/L2) -> bias + exact-erf GELU gate in fp32 -> bf16 h chunk in
// shared memory -> down-product into the accumulator.  Each warp computes
// the value and the gate of the same 8 inner columns, so the gate needs no
// data exchange.  BM·D is held at 20480 (BM = 64, 32, 16 at D = 320, 640,
// 1280).  The M tail is masked.  Where M/BM blocks would leave SMs idle (the
// 16² level and the mid block), the inner dimension is split over
// blockIdx.y.  Each split writes its fp32 partial [BM, D] to a workspace and
// counts itself in a per-row-block counter; the last split to arrive reads
// back all the partials (its own too) and sums them in split order, so the
// result does not depend on which split finishes last, rounds and writes
// the tile, and resets the counter for the next call.  One launch
// per call; the partials are the only fp32 traffic, never the [M, 2K] h.

#include "common.cuh"

using namespace tg;

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int BK = WARPS * 8; // inner columns per chunk: 8 per warp

__device__ __forceinline__ float geglu(float value, float gate) {
  return value * (0.5f * gate * (1.f + erff(gate * 0.70710678118654752f)));
}

// MT: 16-row m-tiles per block; NTW: 8-column output tiles per warp
template <int MT, int NTW>
__global__ void __launch_bounds__(THREADS, 1)
ff_geglu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                bf16* __restrict__ out, float* __restrict__ partial,
                int* __restrict__ counters, int M, int K,
                int chunks_per_split) {
  constexpr int BM = MT * 16;
  constexpr int D = NTW * 8 * WARPS;
  constexpr int LDX = D + 8;   // smem row strides: spread the banks
  constexpr int LDH = BK + 8;
  constexpr int DSTEPS = D / 16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* x_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* h_s = x_s + BM * LDX;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < BM * (D / 8); i += THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 val = zero;
    if (m0 + r < M) val = ldg128(x + (long long)(m0 + r) * D + c);
    *reinterpret_cast<uint4*>(&x_s[r * LDX + c]) = val;
  }
  __syncthreads();

  float acc[MT][NTW][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NTW; ++n)
      acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;

  const int ocol0 = warp * NTW * 8;  // this warp's output columns
  const int hcol = warp * 8 + 2 * t; // this thread's inner columns (chunk-local)

  const int kc_begin = blockIdx.y * chunks_per_split * BK;
  const int kc_end = kc_begin + chunks_per_split * BK;
  for (int kc = kc_begin; kc < kc_end; kc += BK) {
    // up-product: value and gate of inner columns kc + warp*8 .. +8
    float u[MT][4], gt[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      u[mt][0] = u[mt][1] = u[mt][2] = u[mt][3] = 0.f;
      gt[mt][0] = gt[mt][1] = gt[mt][2] = gt[mt][3] = 0.f;
    }
    const bf16* wv = w1 + (long long)(kc + warp * 8 + g) * D + 2 * t;
    const bf16* wg = w1 + (long long)(K + kc + warp * 8 + g) * D + 2 * t;
#pragma unroll 4
    for (int ks = 0; ks < DSTEPS; ++ks) {
      const uint32_t bv0 = ldg32(wv + ks * 16), bv1 = ldg32(wv + ks * 16 + 8);
      const uint32_t bg0 = ldg32(wg + ks * 16), bg1 = ldg32(wg + ks * 16 + 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const bf16* xr = &x_s[(mt * 16 + g) * LDX + ks * 16 + 2 * t];
        const uint32_t a[4] = {lds32(xr), lds32(xr + 8 * LDX), lds32(xr + 8),
                               lds32(xr + 8 * LDX + 8)};
        mma_16816(u[mt], a, bv0, bv1);
        mma_16816(gt[mt], a, bg0, bg1);
      }
    }

    // bias + GEGLU in fp32, h rounded to bf16
    const float bv_lo = __bfloat162float(b1[kc + hcol]);
    const float bv_hi = __bfloat162float(b1[kc + hcol + 1]);
    const float bg_lo = __bfloat162float(b1[K + kc + hcol]);
    const float bg_hi = __bfloat162float(b1[K + kc + hcol + 1]);
    __syncthreads();  // the previous chunk's down-product is done with h_s
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = mt * 16 + g;
      st32(&h_s[r * LDH + hcol],
           pack_bf16(geglu(u[mt][0] + bv_lo, gt[mt][0] + bg_lo),
                     geglu(u[mt][1] + bv_hi, gt[mt][1] + bg_hi)));
      st32(&h_s[(r + 8) * LDH + hcol],
           pack_bf16(geglu(u[mt][2] + bv_lo, gt[mt][2] + bg_lo),
                     geglu(u[mt][3] + bv_hi, gt[mt][3] + bg_hi)));
    }
    __syncthreads();

    // down-product: acc += h_chunk @ W2[:, kc:kc+BK]^T on this warp's columns
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const bf16* hr = &h_s[(mt * 16 + g) * LDH + ks * 16 + 2 * t];
        a[mt][0] = lds32(hr);
        a[mt][1] = lds32(hr + 8 * LDH);
        a[mt][2] = lds32(hr + 8);
        a[mt][3] = lds32(hr + 8 * LDH + 8);
      }
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const bf16* wr = w2 + (long long)(ocol0 + n * 8 + g) * K + kc + ks * 16 + 2 * t;
        const uint32_t b0 = ldg32(wr), b1v = ldg32(wr + 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_16816(acc[mt][n], a[mt], b0, b1v);
      }
    }
  }

  const int splits = gridDim.y, split = blockIdx.y;
  if (splits > 1) {
    // publish this split's partial, then count it; only the last split of
    // the row block goes on
    __shared__ int is_last;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NTW; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = m0 + mt * 16 + g + 8 * half;
          if (r < M)
            __stcg(reinterpret_cast<float2*>(
                       partial + ((long long)split * M + r) * D + ocol0 + n * 8 + 2 * t),
                   make_float2(acc[mt][n][2 * half], acc[mt][n][2 * half + 1]));
        }
    __threadfence();
    __syncthreads();
    if (tid == 0) is_last = atomicAdd(&counters[blockIdx.x], 1) == splits - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    // sum all the splits' partials (its own too) in split order, each
    // thread over the fragment positions it wrote
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NTW; ++n)
        acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float* ps = partial + (long long)s * M * D;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NTW; ++n)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = m0 + mt * 16 + g + 8 * half;
            if (r >= M) continue;
            const float2 v = __ldcg(reinterpret_cast<const float2*>(
                ps + (long long)r * D + ocol0 + n * 8 + 2 * t));
            acc[mt][n][2 * half] += v.x;
            acc[mt][n][2 * half + 1] += v.y;
          }
    }
    if (tid == 0) counters[blockIdx.x] = 0;
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + mt * 16 + g + 8 * half;
        if (r < M)
          st32(out + (long long)r * D + ocol0 + n * 8 + 2 * t,
               pack_bf16(acc[mt][n][2 * half], acc[mt][n][2 * half + 1]));
      }
}

template <int MT, int NTW>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           void* out, float* partial, int* counters, int M, int K,
           int splits, cudaStream_t stream) {
  constexpr int BM = MT * 16, D = NTW * 8 * WARPS;
  constexpr int smem = (BM * (D + 8) + BM * (BK + 8)) * sizeof(bf16);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ff_geglu_kernel<MT, NTW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  dim3 grid((M + BM - 1) / BM, splits);
  ff_geglu_kernel<MT, NTW><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
      static_cast<bf16*>(out), partial, counters, M, K, K / BK / splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: bf16 [M, D] contiguous; w1: bf16 [2K, D]; b1: bf16 [2K]; w2: bf16 [D, K];
// out: bf16 [M, D].  D is one of the compiled widths below (the Python
// wrapper, ops/geglu_matmul.py::KERNEL_WIDTHS, lists the same); K is a
// multiple of 64 and K/64 a multiple of splits.  With splits > 1, workspace
// is fp32 [splits, M, D] and counters int32 [ceil(M/BM)], zero on entry and
// left zero on exit (so one buffer serves every call on a stream).
// Returns cudaGetLastError().
extern "C" int tg_ff_geglu_fwd(const void* x, const void* w1, const void* b1,
                               const void* w2, void* out, void* workspace,
                               void* counters, int M, int D, int K, int splits,
                               void* stream) {
  if (K % BK != 0 || splits < 1 || (K / BK) % splits != 0 ||
      (splits > 1 && (workspace == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  int* cnt = static_cast<int*>(counters);
  switch (D) {
    case 320: return launch<4, 5>(x, w1, b1, w2, out, ws, cnt, M, K, splits, st);
    case 640: return launch<2, 10>(x, w1, b1, w2, out, ws, cnt, M, K, splits, st);
    case 1280: return launch<1, 20>(x, w1, b1, w2, out, ws, cnt, M, K, splits, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
