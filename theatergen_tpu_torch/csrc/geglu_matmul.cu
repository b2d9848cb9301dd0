// GEGLU gate fused into the down-projection for Hopper (sm_90a), bf16 in/out:
//   out[m, n] = sum_k bf16(value[m, k] * gelu(gate[m, k])) * W[n, k]
// with value = hg[:, :K], gate = hg[:, K:], exact-erf gelu in fp32 and an
// fp32 accumulator.  The caller adds the bias.
//
// Replaces theatergen_tpu/ops/geglu_matmul.py::geglu_matmul
// (_geglu_matmul_2d / _kernel).  Like the TPU kernel (and its _reference),
// the gated product is rounded to bf16 before the product; it is never
// written to device memory.  W is the module's [N, K] weight, read in place:
// row-major [n][k] is already the k-contiguous B operand of mma.sync.
//
// Bound on the H100: 2·M·K·N operations against 2·(2·M·K + N·K + M·N)
// bytes.
// At SDXL's 64² level (M 8192, K 2560, N 640) the 84 MB of hg bound it
// (0.029 ms); at the 32² level (M 2048, K 5120, N 1280) the tensor cores do
// (0.027 ms).  Design (simple first): one block per 64x320 output tile,
// 8 warps side by side, each 64x40 of the tile with its fp32 accumulator in
// registers.  The inner dimension streams in chunks of 32: each thread loads
// its value, gate and weight pieces with 16-byte loads into registers one
// chunk ahead, then computes value·gelu(gate) in fp32, rounds it to bf16 and
// stores it with the weight chunk into one of two shared-memory buffers;
// ldmatrix feeds mma.sync m16n8k16 (bf16 -> fp32).  The grid's x axis is
// the N tile, so the N tiles of one row block run next to each other and
// find that block's hg rows in L2.  Each N tile recomputes the gate of its
// rows, N/320 = 2 or 4 times at SDXL's shapes: the exact-erf gate costs as
// much as the products, and a first 128x128 tile, which recomputed it 5 or
// 10 times, took 1.8-2.4x as long (PERF.md).  Rows past M are masked; N
// must be a multiple of 320 and K of 32.

#include "common.cuh"

using namespace tg;

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int BK = 32;
constexpr int LDS = BK + 8;   // smem row stride (80 bytes): ldmatrix rows
                              // of one phase fall in distinct banks

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x2(uint32_t* r, const bf16* p) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

__device__ __forceinline__ uint32_t geglu2(uint32_t value, uint32_t gate) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&value));
  const float2 g = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&gate));
  const float h0 = v.x * (0.5f * g.x * (1.f + erff(g.x * 0.70710678118654752f)));
  const float h1 = v.y * (0.5f * g.y * (1.f + erff(g.y * 0.70710678118654752f)));
  return pack_bf16(h0, h1);
}

constexpr int BM = 64;      // output rows per block: 4 m-tiles of 16
constexpr int BN = 320;     // output columns per block: 8 warps x 40
constexpr int MT = BM / 16;
constexpr int NT = BN / WARPS / 8;  // 8-column n-tiles per warp (5)
// 16-byte pieces per thread of the value/gate tiles and the weight tile
constexpr int HL = BM * BK / 8 / THREADS;
constexpr int WL = BN * BK / 8 / THREADS;
static_assert(HL * THREADS * 8 == BM * BK && WL * THREADS * 8 == BN * BK,
              "tiles split evenly over the threads");
constexpr int SMEM = 2 * (BM + BN) * LDS * sizeof(bf16);

struct Chunk {
  uint4 value[HL], gate[HL], w[WL];
};

// piece i of a thread: row (tid + i*THREADS) / 4 of its tile, 8 columns at
// ((tid + i*THREADS) % 4) * 8 of the chunk
__device__ __forceinline__ void load_chunk(Chunk& c, const bf16* hg,
                                           const bf16* w, int tid, int m0,
                                           int n0, int k0, int M, int K) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int i = 0; i < HL; ++i) {
    const int idx = tid + i * THREADS, r = idx >> 2, col = k0 + (idx & 3) * 8;
    c.value[i] = c.gate[i] = zero;
    if (m0 + r < M) {
      const bf16* row = hg + (long long)(m0 + r) * (2LL * K) + col;
      c.value[i] = ldg128(row);
      c.gate[i] = ldg128(row + K);
    }
  }
#pragma unroll
  for (int i = 0; i < WL; ++i) {
    const int idx = tid + i * THREADS, r = idx >> 2, col = k0 + (idx & 3) * 8;
    c.w[i] = ldg128(w + (long long)(n0 + r) * K + col);
  }
}

// value·gelu(gate) in fp32, rounded to bf16, and the weight chunk into
// shared memory
__device__ __forceinline__ void store_chunk(const Chunk& c, bf16* h_s,
                                            bf16* w_s, int tid) {
#pragma unroll
  for (int i = 0; i < HL; ++i) {
    const int idx = tid + i * THREADS, r = idx >> 2, col = (idx & 3) * 8;
    uint4 h;
    h.x = geglu2(c.value[i].x, c.gate[i].x);
    h.y = geglu2(c.value[i].y, c.gate[i].y);
    h.z = geglu2(c.value[i].z, c.gate[i].z);
    h.w = geglu2(c.value[i].w, c.gate[i].w);
    *reinterpret_cast<uint4*>(&h_s[r * LDS + col]) = h;
  }
#pragma unroll
  for (int i = 0; i < WL; ++i) {
    const int idx = tid + i * THREADS, r = idx >> 2, col = (idx & 3) * 8;
    *reinterpret_cast<uint4*>(&w_s[r * LDS + col]) = c.w[i];
  }
}

__global__ void __launch_bounds__(THREADS, 1)
geglu_matmul_kernel(const bf16* __restrict__ hg, const bf16* __restrict__ w,
                    bf16* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* h_s = reinterpret_cast<bf16*>(smem_raw);  // [2][BM * LDS]
  bf16* w_s = h_s + 2 * BM * LDS;                 // [2][BN * LDS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  // ldmatrix row addresses.  A (rows m, cols k): row lane%16 at column
  // (lane/16)*8.  B (rows n, cols k), x4 over two n-tiles: matrix lane/8 is
  // (n-tile lane/16, k half (lane/8)%2), row lane%8; x2 over the fifth
  // n-tile: lanes 0..15, the same k halves.
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = warp * NT * 8 + ((lane >> 4) << 3) + (lane & 7);
  const int b_last = warp * NT * 8 + (NT - 1) * 8 + (lane & 7);
  const int b_col = ((lane >> 3) & 1) * 8;

  const int chunks = K / BK;
  Chunk next;
  load_chunk(next, hg, w, tid, m0, n0, 0, M, K);
  store_chunk(next, h_s, w_s, tid);
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    const bf16* hb = h_s + (c & 1) * BM * LDS;
    const bf16* wb = w_s + (c & 1) * BN * LDS;
    if (c + 1 < chunks)  // in flight during the MMAs
      load_chunk(next, hg, w, tid, m0, n0, (c + 1) * BK, M, K);
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(a[mt], &hb[(a_row + mt * 16) * LDS + ks * 16 + a_col]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldsm_x4(r, &wb[(b_row + np * 16) * LDS + ks * 16 + b_col]);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
      ldsm_x2(b[NT - 1], &wb[b_last * LDS + ks * 16 + b_col]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_16816(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
    // the other buffer was last read in iteration c-1, before the barrier
    // that ended it
    if (c + 1 < chunks)
      store_chunk(next, h_s + ((c + 1) & 1) * BM * LDS,
                  w_s + ((c + 1) & 1) * BN * LDS, tid);
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + mt * 16 + g + 8 * half;
        const int col = n0 + warp * NT * 8 + nt * 8 + 2 * t;
        if (r < M)
          st32(out + (long long)r * N + col,
               pack_bf16(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]));
      }
}

}  // namespace

// hg: bf16 [M, 2K] contiguous, 16-byte aligned (K a multiple of 32, so the
// gate half is aligned too); w: bf16 [N, K] contiguous; out: bf16 [M, N].
// N must be a multiple of 320 and K of 32 (the Python wrapper,
// ops/geglu_matmul.py, checks the same and raises).  Returns
// cudaGetLastError().
extern "C" int tg_geglu_matmul_fwd(const void* hg, const void* w, void* out,
                                   int M, int N, int K, void* stream) {
  if (M < 0 || N <= 0 || K <= 0 || N % BN != 0 || K % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        geglu_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  dim3 grid(N / BN, (M + BM - 1) / BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  geglu_matmul_kernel<<<grid, THREADS, SMEM, st>>>(
      static_cast<const bf16*>(hg), static_cast<const bf16*>(w),
      static_cast<bf16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
