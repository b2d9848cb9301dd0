// W8A8 matmul for Hopper (sm_90a) with the activation quantisation inside:
//   s[m]      = max(max_k |x[m, k]| / 127, 1e-8)                  (fp32)
//   xq[m, k]  = clamp(rint(x[m, k] / s[m]), -127, 127)             (int8)
//   acc[m, n] = sum_k xq[m, k] * w_q[n, k]                         (int32)
//   out[m, n] = bf16(acc[m, n] * (s[m] * w_scale[n]) + bias[n])    (fp32)
// x is bf16 [M, K], w_q int8 [N, K] (K contiguous: the `.col` B operand of
// the s8 MMA), w_scale fp32 [N], bias bf16 [N] or null.  Every step is one
// IEEE fp32 operation in the order written (division by __fdiv_rn, round
// half to even, no FMA contraction), and the int32 sum is exact
// (5120 * 127^2 < 2^31), so the result equals the plain version's
// (ops/quant_matmul.py::quant_matmul_plain) bit for bit.
//
// Replaces theatergen_tpu/ops/quant_matmul.py::quant_matmul (_qmm_kernel),
// the TPU kernel whose grid walks a row block's N tiles in order and keeps
// the block's int8 activations and scales in VMEM scratch from n == 0.
// Blocks of a GPU grid share nothing, so here every (row block, column
// block) computes its rows' scales itself and quantises its A tiles again.
//
// Bound on the H100: bytes at every shape of the SD1.5 W8A8 UNet (x read
// once, w_q once, the output written once: 2MK + KN + 2MN; the 184 calls
// of one CFG evaluation move 1.49 GB, 0.444 ms at 3.35 TB/s, against
// 467 GOPS, 0.236 ms at 1979 int8 TOPS).  Design (simple first): 64 x 128
// output tiles, 256 threads as 2 x 4 warps of 32 x 32, mma.sync m16n8k32
// s8 with int32 accumulators.  A first pass reads the block's 64 rows over
// the whole K in bf16 for the row scales (four threads per row, their max
// by shuffles), while the first K steps' copies are in flight.  The K
// loop streams both operands with cp.async through a 4-deep ring of 32-wide
// steps (the bf16 A tile, from L2 after the first pass, and the int8 W
// tile): each step waits for its data two steps ahead of use, so the load
// latency is hidden even where a small grid gives each SM one block (the
// M = 2 and M = 154 calls).  Each thread quantises the 8 bf16 values it
// copied itself into the step's int8 A tile (rows past M are stored as
// zeros without a division), one barrier per step.  Ragged M and N are
// masked (zero rows and columns).  wgmma on s8, TMA, and one quantisation
// of A per row block shared across a cluster instead of one per column
// block, are a later change.

#include "common.cuh"

using namespace tg;

namespace {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int STAGES = 4;  // cp.async ring depth, in K steps
// int8 shared row stride in bytes: 16-byte aligned for cp.async, and 12
// words apart so the fragment loads of 8 rows x 4 words hit 32 banks
constexpr int LDS = BK + 16;

__device__ __forceinline__ void mma_s8_16832(int* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// rint(v / s) clamped to +-127, as one byte
__device__ __forceinline__ uint32_t quant_byte(float v, float s) {
  const int q = max(-127, min(127, __float2int_rn(__fdiv_rn(v, s))));
  return static_cast<uint32_t>(q) & 0xffu;
}

// 8 bf16 of one row -> 8 int8 at dst (the lower k in the lower byte)
__device__ __forceinline__ void quant_store8(int8_t* dst, const bf16* src,
                                             float s) {
  float f[8];
  unpack8(*reinterpret_cast<const uint4*>(src), f);
  uint2 q;
  q.x = quant_byte(f[0], s) | quant_byte(f[1], s) << 8 |
        quant_byte(f[2], s) << 16 | quant_byte(f[3], s) << 24;
  q.y = quant_byte(f[4], s) | quant_byte(f[5], s) << 8 |
        quant_byte(f[6], s) << 16 | quant_byte(f[7], s) << 24;
  *reinterpret_cast<uint2*>(dst) = q;
}

__device__ __forceinline__ float epilogue(int acc, float s, float ws,
                                          const bf16* bias, int n) {
  float y = __fmul_rn(__int2float_rn(acc), __fmul_rn(s, ws));
  if (bias != nullptr) y = __fadd_rn(y, __bfloat162float(bias[n]));
  return y;
}

__global__ void __launch_bounds__(THREADS)
quant_matmul_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ wq,
                    const float* __restrict__ wscale,
                    const bf16* __restrict__ bias, bf16* __restrict__ out,
                    int M, int N, int K) {
  __shared__ __align__(16) bf16 Ab[STAGES][BM * BK];      // staged bf16 A
  __shared__ __align__(16) int8_t Ws[STAGES][BN * LDS];   // staged int8 W
  __shared__ __align__(16) int8_t Aq[2][BM * LDS];        // quantised A
  __shared__ float s_row[BM];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int KT = K / BK;

  // A loader and quantiser: row ar, 8 bf16 at column ac of each K step;
  // W loader: row wr, 16 bytes at column wc
  const int ar = tid >> 2, ac = (tid & 3) * 8;
  const bool a_ok = m0 + ar < M;
  const bf16* a_src = x + (size_t)(a_ok ? m0 + ar : 0) * K + ac;
  const int wr = tid >> 1, wc = (tid & 1) * 16;
  const bool w_ok = n0 + wr < N;
  const int8_t* w_src = wq + (size_t)(w_ok ? n0 + wr : 0) * K + wc;
  auto issue = [&](int step) {
    const int slot = step % STAGES, k0 = step * BK;
    cp_async16(&Ab[slot][ar * BK + ac], a_src + k0, a_ok);
    cp_async16(&Ws[slot][wr * LDS + wc], w_src + k0, w_ok);
  };
  // the thread's own 8 values of step `step`, into the int8 tile
  auto quantise = [&](int step, float s) {
    int8_t* dst = &Aq[step & 1][ar * LDS + ac];
    if (a_ok)
      quant_store8(dst, &Ab[step % STAGES][ar * BK + ac], s);
    else
      *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
  };

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < KT) issue(st);
    cp_async_commit();
  }

  // per-row scales over the whole K: four threads per row (row ar again)
  {
    float amax = 0.f;
    if (a_ok) {
      const uint4* row = reinterpret_cast<const uint4*>(x + (size_t)(m0 + ar) * K);
#pragma unroll 4
      for (int c = tid & 3; c < K / 8; c += 4) {
        float f[8];
        unpack8(__ldg(row + c), f);
#pragma unroll
        for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(f[j]));
      }
    }
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
    if ((tid & 3) == 0) s_row[ar] = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
  }
  __syncthreads();
  const float a_s = s_row[ar];
  cp_async_wait<STAGES - 2>();  // step 0 (the thread's own copies)
  quantise(0, a_s);

  // warp (wm, wn) owns rows wm*32.. and columns wn*32.. of the tile
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int kt = 0; kt < KT; ++kt) {
    // steps <= kt + 1 have landed (own copies); after the barrier every
    // thread's W tile of step kt and int8 A tile of step kt are visible,
    // and every thread is done with step kt - 1's slot
    cp_async_wait<STAGES - 3>();
    __syncthreads();
    if (kt + STAGES - 1 < KT) issue(kt + STAGES - 1);
    cp_async_commit();

    const int8_t* as = Aq[kt & 1];
    const int8_t* ws = Ws[kt % STAGES];
    uint32_t af[2][4], bfr[4][2];
#pragma unroll
    for (int mf = 0; mf < 2; ++mf) {
      // a0: (g, 4t..) a1: (g+8, 4t..) a2: (g, 16+4t..) a3: (g+8, 16+4t..)
      const int8_t* p = as + (wm * 32 + mf * 16 + g) * LDS + 4 * t;
      af[mf][0] = lds32(p);
      af[mf][1] = lds32(p + 8 * LDS);
      af[mf][2] = lds32(p + 16);
      af[mf][3] = lds32(p + 8 * LDS + 16);
    }
#pragma unroll
    for (int nf = 0; nf < 4; ++nf) {
      // b0: (k 4t.., n g)  b1: (k 16+4t.., n g)
      const int8_t* p = ws + (wn * 32 + nf * 8 + g) * LDS + 4 * t;
      bfr[nf][0] = lds32(p);
      bfr[nf][1] = lds32(p + 16);
    }
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int nf = 0; nf < 4; ++nf)
        mma_s8_16832(acc[mf][nf], af[mf], bfr[nf][0], bfr[nf][1]);

    if (kt + 1 < KT) quantise(kt + 1, a_s);
  }

  // epilogue: c0, c1 at (g, 2t..2t+1), c2, c3 at (g+8, 2t..2t+1)
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = wm * 32 + mf * 16 + g + 8 * h;
      if (m0 + lr >= M) continue;
      const float s = s_row[lr];
      bf16* orow = out + (size_t)(m0 + lr) * N;
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) {
        const int c = n0 + wn * 32 + nf * 8 + 2 * t;
        if (c >= N) continue;
        const float y0 = epilogue(acc[mf][nf][2 * h], s, __ldg(wscale + c),
                                  bias, c);
        if (c + 1 < N) {
          const float y1 = epilogue(acc[mf][nf][2 * h + 1], s,
                                    __ldg(wscale + c + 1), bias, c + 1);
          if (pairs) {
            *reinterpret_cast<uint32_t*>(orow + c) = pack_bf16(y0, y1);
          } else {
            orow[c] = __float2bfloat16_rn(y0);
            orow[c + 1] = __float2bfloat16_rn(y1);
          }
        } else {
          orow[c] = __float2bfloat16_rn(y0);
        }
      }
    }
  }
}

}  // namespace

// x: bf16 [M, K] contiguous, 16-byte aligned; wq: int8 [N, K] contiguous,
// 16-byte aligned; wscale: fp32 [N]; bias: bf16 [N] or null; out: bf16
// [M, N].  K must be a positive multiple of 32 (the Python wrapper,
// ops/quant_matmul.py, checks the same and raises).  Returns
// cudaGetLastError().
extern "C" int tg_quant_matmul_fwd(const void* x, const void* wq,
                                   const void* wscale, const void* bias,
                                   void* out, int M, int N, int K,
                                   void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  quant_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(wscale), static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
