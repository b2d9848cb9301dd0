// GEGLU gate fused into the down-projection for Hopper (sm_90a), bf16 in/out:
//   out[m, n] = sum_k bf16(value[m, k] * gelu(gate[m, k])) * W[n, k]
// with value = hg[:, :K], gate = hg[:, K:], exact-erf gelu in fp32 and an
// fp32 accumulator.  The caller adds the bias.
//
// Replaces theatergen_tpu/ops/geglu_matmul.py::geglu_matmul
// (_geglu_matmul_2d / _kernel).  Like the TPU kernel (and its _reference),
// the gated product is rounded to bf16 before the product; it is never
// written to device memory.  W is the module's [N, K] weight, read in place.
//
// Bound on the H100: 2·M·K·N operations against 2·(2·M·K + N·K + M·N)
// bytes.  At SDXL's 64² level (M 8192, K 2560, N 640) the 84 MB of hg bound
// it (0.029 ms); at the 32² level (M 2048, K 5120, N 1280) the tensor cores
// do (0.027 ms).  The exact-erf gate costs about as much as the products,
// so it must be computed once per element: the first design (64x320 output
// tiles, mma.sync) computed it N/320 times and read hg as often.
//
// Design: ff_geglu.cu's without the up-projection.  A thread-block cluster
// of C = N/160 CTAs (2, 4, 6, 8, 10, 12 at N = 320 ... 1920; above 8 a
// non-portable cluster size) owns BM = 128 rows; CTA r owns output
// columns [160r, 160r + 160).  The inner dimension streams in chunks of
// 64·C columns.  For each chunk, CTA r loads by TMA the value and gate
// panels [128, 64] of its 64 inner columns (two tensor maps over hg, one
// per half, so columns past K arrive as zeros and not as the other half),
// reads them at the fragment positions of wgmma's register A operand with
// ldmatrix at the 128-byte-swizzled addresses, takes the GEGLU in fp32 and
// rounds h to bf16.  From there the h piece goes through common.cuh's
// exchange_down_chunk as in ff_geglu: it feeds this CTA's own wgmma from
// registers, is stored for the neighbours, which read it through
// distributed shared memory, and every CTA runs m64n160k16 over all C
// pieces against W tiles [160, 64] (TMA, in place from W [N, K]).  So each
// gate value is computed once per row block and hg is read from device
// memory once.  Rows past M and columns past K arrive as zeros
// (0 · gelu(0) = 0) and are masked at the store.
//
// Per CTA two consumer warpgroups (64 rows each, setmaxnreg 232) and one
// producer thread keeping an 8-stage ring of 20 KB stages full (per chunk
// a value step and a gate step, then C W steps).  Where the row blocks leave SMs
// idle, the chunks split over blockIdx.y (ops/geglu_matmul.py::geglu_plan),
// reduced by common.cuh's store_split_tile.  One launch per call.

#include <type_traits>

#include "common.cuh"

using namespace tg;

namespace {

constexpr int CONSUMERS = DOWN_CONSUMERS;
constexpr int THREADS = CONSUMERS + 128;  // + the producer's warpgroup
constexpr int BM = 128;                   // rows per cluster
constexpr int NO = DOWN_NO;               // output columns per CTA
constexpr int HP = DOWN_HP;               // inner columns per CTA and chunk
constexpr int STAGES = 8;
constexpr int STAGE_BYTES = W_TILE_BYTES;  // 20 KB: a W tile, or a panel
constexpr int PANEL_BYTES = BM * HP * 2;   // a value or gate panel [128, 64]
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * H_SLOT_BYTES + (2 * STAGES + 4) * 8;
static_assert(PANEL_BYTES <= STAGE_BYTES && STAGE_BYTES % 1024 == 0, "stage");

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t geglu2(uint32_t value, uint32_t gate) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&value));
  const float2 g = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&gate));
  const float h0 = v.x * (0.5f * g.x * (1.f + erff(g.x * 0.70710678118654752f)));
  const float h1 = v.y * (0.5f * g.y * (1.f + erff(g.y * 0.70710678118654752f)));
  return pack_bf16(h0, h1);
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
geglu_matmul_kernel(const __grid_constant__ CUtensorMap value_map,
                    const __grid_constant__ CUtensorMap gate_map,
                    const __grid_constant__ CUtensorMap w_map,
                    bf16* __restrict__ out, float* __restrict__ partial,
                    int* __restrict__ counters, int M, int chunks_per_split) {
  constexpr int BK = HP * C;    // inner columns per chunk
  constexpr int SPC = 2 + C;    // ring steps per chunk
  constexpr int N = NO * C;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  unsigned char* slots = smem + STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(slots + 2 * H_SLOT_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* h_full = empty + STAGES;
  uint64_t* h_free = h_full + 2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = static_cast<int>(cluster_ctarank());
  const int m0 = (blockIdx.x / C) * BM;
  const int o0 = rank * NO;
  const int kc0 = blockIdx.y * chunks_per_split * BK;
  const int nsteps = chunks_per_split * SPC;
  const uint32_t ring_base = smem_u32(smem);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&h_full[b], C * CONSUMERS / 32);
      mbar_init(&h_free[b], (C - 1) * CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  cluster_arrive();
  cluster_wait();

  if (warp >= CONSUMERS / 32) {
    // producer: steps 0 and 1 of a chunk are this CTA's value and gate
    // panels, step 2 + q the W tile of piece (rank + q) mod C
    setmaxnreg_dec<40>();
    if (warp == CONSUMERS / 32 && lane == 0) {
      for (int s = 0; s < nsteps; ++s) {
        const int stage = s % STAGES;
        if (s >= STAGES) mbar_wait(&empty[stage], (s / STAGES - 1) & 1);
        const uint32_t st = ring_base + stage * STAGE_BYTES;
        const int kc = kc0 + (s / SPC) * BK, within = s % SPC;
        if (within < 2) {
          mbar_expect_tx(&full[stage], PANEL_BYTES);
          tma_load_2d(st, within == 0 ? &value_map : &gate_map, &full[stage],
                      kc + HP * rank, m0);
        } else {
          const int j = (rank + within - 2) % C;
          mbar_expect_tx(&full[stage], W_TILE_BYTES);
          tma_load_2d(st, &w_map, &full[stage], kc + HP * j, o0);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int wg = tid >> 7, g = lane >> 2, t = lane & 3;
  float acc[NO / 2];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) acc[i] = 0.f;
  const RingConsumer<STAGES, STAGE_BYTES> ring{full, empty, ring_base, lane};

  // ldmatrix rows: lanes 0-15 rows 0-15 of the warp's 16 at the k-step's
  // first 8 columns, lanes 16-31 at its second 8, so matrices 0..3 are the
  // A fragment's a0..a3; each 16-byte row piece sits at its swizzled chunk
  const int lrow = wg * 64 + (warp & 3) * 16 + (lane & 15);
  const uint32_t row_off = lrow * 128;

  int s = 0;
  for (int ci = 0; ci < chunks_per_split; ++ci) {
    uint32_t hf[16];
    const uint32_t sv = ring.ready(s), sg = ring.ready(s + 1);
#pragma unroll
    for (int kk = 0; kk < HP / 16; ++kk) {
      const uint32_t off = row_off + (((2 * kk + (lane >> 4)) ^ (lrow & 7)) << 4);
      uint32_t v[4], gt[4];
      ldsm_x4(v, sv + off);
      ldsm_x4(gt, sg + off);
#pragma unroll
      for (int i = 0; i < 4; ++i) hf[4 * kk + i] = geglu2(v[i], gt[i]);
    }
    ring.release(s);
    ring.release(s + 1);
    s += 2;
    exchange_down_chunk<C>(acc, hf, slots, h_full, h_free, ci, rank, tid, ring, s);
  }
  // no CTA leaves while a neighbour may still read its pieces or arrive on
  // its barriers
  cluster_arrive();
  cluster_wait();

  store_split_tile(acc, out, partial, counters, M, N, o0,
                   m0 + wg * 64 + (warp & 3) * 16 + g, t, tid);
}

template <int C>
cudaError_t configure() {
  static cudaError_t status = [] {
    cudaError_t e = cudaFuncSetAttribute(
        geglu_matmul_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e == cudaSuccess && C > 8)
      e = cudaFuncSetAttribute(geglu_matmul_kernel<C>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  return status;
}

template <int C>
cudaLaunchConfig_t launch_config(dim3 grid, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int C>
int launch(const void* hg, const void* w, void* out, float* partial, int* counters,
           int M, int K, int splits, cudaStream_t stream) {
  const cudaError_t err = configure<C>();
  if (err != cudaSuccess) return static_cast<int>(err);
  // value and gate halves of hg [M, 2K], and W [N, K], in boxes of 64
  // columns; each half's map ends at K
  CUtensorMap value_map, gate_map, w_map;
  const cuuint64_t h_dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t w_dims[2] = {(cuuint64_t)K, (cuuint64_t)(NO * C)};
  const cuuint64_t h_stride[1] = {4 * (cuuint64_t)K}, w_stride[1] = {2 * (cuuint64_t)K};
  const cuuint32_t h_box[2] = {HP, BM}, w_box[2] = {HP, NO};
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const bf16* gate = static_cast<const bf16*>(hg) + K;
  int status = encode_tensor_map(&value_map, hg, 2, h_dims, h_stride, h_box, sw);
  if (status == 0) status = encode_tensor_map(&gate_map, gate, 2, h_dims, h_stride, h_box, sw);
  if (status == 0) status = encode_tensor_map(&w_map, w, 2, w_dims, w_stride, w_box, sw);
  if (status != 0) return status;
  const int chunks = (K + HP * C - 1) / (HP * C);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config<C>(dim3((M + BM - 1) / BM * C, splits), stream, &attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, geglu_matmul_kernel<C>, value_map, gate_map, w_map,
      static_cast<bf16*>(out), partial, counters, M, chunks / splits);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int slots() {
  const cudaError_t err = configure<C>();
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<C>(dim3(C, 1, 1), nullptr, &attr);
  int clusters = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&clusters, geglu_matmul_kernel<C>, &cfg);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return clusters * C;
}

template <typename F>
int by_width(int N, F&& f) {
  switch (N) {
    case 320: return f(std::integral_constant<int, 2>());
    case 640: return f(std::integral_constant<int, 4>());
    case 960: return f(std::integral_constant<int, 6>());
    case 1280: return f(std::integral_constant<int, 8>());
    case 1600: return f(std::integral_constant<int, 10>());
    case 1920: return f(std::integral_constant<int, 12>());
    default: return -1;
  }
}

}  // namespace

// hg: bf16 [M, 2K] contiguous, 16-byte aligned; w: bf16 [N, K] contiguous,
// 16-byte aligned; out: bf16 [M, N].  N is one of 320, 640, ..., 1920 (a
// multiple of 160·2 up to 1920: the Python wrapper,
// ops/geglu_matmul.py::geglu_kernel_takes, accepts the same) and K a
// multiple of 32; the chunk count ceil(K / (64·N/160)) a multiple of
// splits.  With splits > 1, workspace is fp32 [splits, M, N] and counters
// int32 [ceil(M/128)·N/160], zero on entry and left zero on exit.  Returns
// cudaGetLastError(), the launch's error, or the CUresult of a tensor map
// that failed to encode.
extern "C" int tg_geglu_matmul_fwd(const void* hg, const void* w, void* out,
                                   void* workspace, void* counters, int M,
                                   int N, int K, int splits, void* stream) {
  if (M < 0 || K <= 0 || K % 32 != 0 || N % (2 * NO) != 0 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (K + HP * (N / NO) - 1) / (HP * (N / NO));
  if (chunks % splits != 0 || (splits > 1 && (workspace == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  int* cnt = static_cast<int*>(counters);
  const int status = by_width(N, [&](auto c) {
    return launch<decltype(c)::value>(hg, w, out, ws, cnt, M, K, splits, st);
  });
  return status == -1 ? static_cast<int>(cudaErrorInvalidValue) : status;
}

// CTAs of width N's instance that the card holds at once (whole clusters,
// cudaOccupancyMaxActiveClusters), for the split planner; a negative
// cudaError_t on failure.
extern "C" int tg_geglu_matmul_slots(int N) {
  const int n = by_width(N, [](auto c) { return slots<decltype(c)::value>(); });
  return n == -1 ? -static_cast<int>(cudaErrorInvalidValue) : n;
}
