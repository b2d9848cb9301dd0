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
// the [M, 2K] up-projection never reaches device memory.
//
// Design.  A thread-block cluster of C = D/160 CTAs (2, 4, 8 at D = 320,
// 640, 1280) owns BM = 128 rows; CTA r of the cluster owns output columns
// [160r, 160r + 160), so every CTA holds the same fp32 [128, 160]
// accumulator at every width.  The inner dimension streams in chunks of
// 64·C columns.  For each chunk, CTA r computes the up-projection of its
// 64 inner columns (value and gate: W1 rows kc + 64r.. and K + kc + 64r..)
// over all of D, adds the bias and takes the exact-erf GEGLU in fp32
// registers, and rounds its h piece [128, 64] to bf16.  The accumulator
// layout of wgmma is the register A fragment layout, so the piece feeds
// this CTA's down-product straight from registers; it is also stored,
// fragment by fragment, into this CTA's shared memory, and an mbarrier in
// every CTA of the cluster counts it.  Each CTA then reads the other C - 1
// pieces from its neighbours' shared memory (distributed shared memory,
// 16-byte loads at the reader's own fragment offset), tells each owner
// through a second mbarrier that its piece may be overwritten, and runs
// the down-product of its 160 columns over the whole chunk.  Nothing is
// computed twice and h never reaches device memory.
//
// Per CTA, two consumer warpgroups own 64 rows each and one producer
// thread keeps a 5-stage ring of 32 KB stages full by TMA: per up step an
// x panel [128, 64] and the value and gate panels [64, 64] of W1, per down
// step a W2 tile [160, 64] (rows past M arrive as zeros), each as 128-byte
// rows in TMA's 128-byte swizzle.  The producer's warpgroup hands its
// registers to the consumers (setmaxnreg: 40 and 232 a thread, where a
// 384-thread CTA would otherwise hold every thread to 168 and the
// consumers would spill).  Both products run on wgmma (m64n128k16 with x
// and the adjacent W1 value and gate panels from shared memory; m64n160k16
// with h from registers and W2 from shared memory), one step's group in
// flight while the next is issued.  What bounds it on the
// card is the rate at which the stages arrive: every CTA streams the x
// panels of its row block once per chunk (C times per cluster) and each
// cluster all of W1 and W2 (PERF.md).
//
// Where the row blocks leave SMs idle, the chunks split over blockIdx.y
// (ops/geglu_matmul.py::ff_plan; any number of waves).  Each split writes
// its fp32 partial [128, 160] to a workspace and counts itself in a per-CTA
// counter; the last split to arrive reads back all the partials (its own
// too) and sums them in split order, so the result does not depend on which
// split finishes last, rounds and writes the tile, and resets the counter
// for the next call.  One launch per call.  The h exchange with the
// down-product and the split reduction are common.cuh's
// exchange_down_chunk and store_split_tile, shared with geglu_matmul.cu.

#include "common.cuh"

using namespace tg;

namespace {

constexpr int CONSUMERS = DOWN_CONSUMERS;  // two warpgroups
constexpr int THREADS = CONSUMERS + 128;    // + the producer's warpgroup
constexpr int BM = 128;       // rows per cluster (64 per warpgroup)
constexpr int NO = DOWN_NO;   // output columns per CTA
constexpr int HP = DOWN_HP;   // inner (h) columns per CTA and chunk
constexpr int KP = 64;        // D columns per up-product panel
constexpr int STAGES = 5;
constexpr int STAGE_BYTES = 32768;
constexpr int X_BYTES = BM * KP * 2, WV_BYTES = HP * KP * 2;
// + 1 KB: the ring's base is rounded up to the swizzle atom
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * H_SLOT_BYTES + (2 * STAGES + 4) * 8;

__device__ __forceinline__ float geglu(float value, float gate) {
  return value * (0.5f * gate * (1.f + erff(gate * 0.70710678118654752f)));
}

template <int C>
struct Plan {
  static constexpr int D = NO * C;
  static constexpr int UP = D / KP;        // up-product panels per chunk
  static constexpr int SPC = UP + C;       // ring steps per chunk
  static constexpr int BK = HP * C;        // inner columns per chunk
};

template <int C>
__global__ void __cluster_dims__(C, 1, 1) __launch_bounds__(THREADS, 1)
ff_geglu_kernel(const __grid_constant__ CUtensorMap x_map,
                const __grid_constant__ CUtensorMap w1_map,
                const __grid_constant__ CUtensorMap w2_map,
                const bf16* __restrict__ b1, bf16* __restrict__ out,
                float* __restrict__ partial, int* __restrict__ counters, int M,
                int K, int chunks_per_split) {
  constexpr int UP = Plan<C>::UP, SPC = Plan<C>::SPC, BK = Plan<C>::BK;
  constexpr int D = Plan<C>::D;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  unsigned char* slots = smem + STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(slots + 2 * H_SLOT_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* h_full = empty + STAGES;  // [2]: every CTA's piece of a chunk stored
  uint64_t* h_free = h_full + 2;      // [2]: every reader done with this CTA's piece

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = static_cast<int>(cluster_ctarank());
  const int m0 = (blockIdx.x / C) * BM;
  const int o0 = rank * NO;                        // this CTA's output columns
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
  // every CTA's barriers are initialised before any remote arrival
  cluster_arrive();
  cluster_wait();

  if (warp >= CONSUMERS / 32) {
    // producer: ring step s is up panel p of its chunk (x, W1 value and
    // gate panels) or down piece q (the W2 tile of piece owner j)
    setmaxnreg_dec<40>();
    if (warp == CONSUMERS / 32 && lane == 0) {
      for (int s = 0; s < nsteps; ++s) {
        const int stage = s % STAGES;
        if (s >= STAGES) mbar_wait(&empty[stage], (s / STAGES - 1) & 1);
        const uint32_t st = ring_base + stage * STAGE_BYTES;
        const int kc = kc0 + (s / SPC) * BK, within = s % SPC;
        if (within < UP) {
          mbar_expect_tx(&full[stage], X_BYTES + 2 * WV_BYTES);
          tma_load_2d(st, &x_map, &full[stage], within * KP, m0);
          tma_load_2d(st + X_BYTES, &w1_map, &full[stage], within * KP, kc + HP * rank);
          tma_load_2d(st + X_BYTES + WV_BYTES, &w1_map, &full[stage], within * KP,
                      K + kc + HP * rank);
        } else {
          const int j = (rank + within - UP) % C;
          mbar_expect_tx(&full[stage], W_TILE_BYTES);
          tma_load_2d(st, &w2_map, &full[stage], kc + HP * j, o0);
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

  int s = 0;
  for (int ci = 0; ci < chunks_per_split; ++ci) {
    const int kc = kc0 + ci * BK;
    // up-product: value (columns 0..63) and gate (64..127; the two W1
    // panels are adjacent) of this CTA's 64 inner columns, 64 rows per
    // warpgroup
    float u[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) u[i] = 0.f;
    for (int p = 0; p < UP; ++p, ++s) {
      const uint32_t st = ring.ready(s);
      fence_regs(u);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk)
        wgmma_m64n128k16_ss(u, wgmma_desc_sw128(st + wg * 64 * 128 + kk * 32),
                            wgmma_desc_sw128(st + X_BYTES + kk * 32), 1);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(u);
      if (p > 0) ring.release(s - 1);
    }
    wgmma_wait<0>();
    fence_regs(u);
    ring.release(s - 1);

    // bias + GEGLU in fp32, h rounded to bf16 as down-product A fragments
    uint32_t hf[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = kc + HP * rank + 8 * i + 2 * t;
      const float bv0 = __bfloat162float(b1[col]), bv1 = __bfloat162float(b1[col + 1]);
      const float bg0 = __bfloat162float(b1[K + col]), bg1 = __bfloat162float(b1[K + col + 1]);
      // n-block i is k-step i/2's lower (even i) or upper (odd i) half
      const float* v = &u[4 * i];
      const float* gt = &u[4 * (i + 8)];
      hf[(i >> 1) * 4 + (i & 1) * 2] =
          pack_bf16(geglu(v[0] + bv0, gt[0] + bg0), geglu(v[1] + bv1, gt[1] + bg1));
      hf[(i >> 1) * 4 + (i & 1) * 2 + 1] =
          pack_bf16(geglu(v[2] + bv0, gt[2] + bg0), geglu(v[3] + bv1, gt[3] + bg1));
    }
    // publish the piece, and the down-product over the chunk's C pieces
    exchange_down_chunk<C>(acc, hf, slots, h_full, h_free, ci, rank, tid, ring, s);
  }
  // no CTA leaves while a neighbour may still read its pieces or arrive on
  // its barriers (the producer's warpgroup has left: it takes no part)
  cluster_arrive();
  cluster_wait();

  store_split_tile(acc, out, partial, counters, M, D, o0,
                   m0 + wg * 64 + (warp & 3) * 16 + g, t, tid);
}

template <int C>
cudaError_t configure() {
  static cudaError_t status = cudaFuncSetAttribute(
      ff_geglu_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  return status;
}

template <int C>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           void* out, float* partial, int* counters, int M, int K,
           int splits, cudaStream_t stream) {
  constexpr int D = Plan<C>::D;
  const cudaError_t err = configure<C>();
  if (err != cudaSuccess) return static_cast<int>(err);
  // x [M, D], W1 [2K, D], W2 [D, K] in boxes of 64 columns
  CUtensorMap x_map, w1_map, w2_map;
  const cuuint64_t x_dims[2] = {D, (cuuint64_t)M}, w1_dims[2] = {D, 2 * (cuuint64_t)K};
  const cuuint64_t w2_dims[2] = {(cuuint64_t)K, D};
  const cuuint64_t d_stride[1] = {D * 2}, k_stride[1] = {(cuuint64_t)K * 2};
  const cuuint32_t x_box[2] = {KP, BM}, w1_box[2] = {KP, HP}, w2_box[2] = {KP, NO};
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  int status = encode_tensor_map(&x_map, x, 2, x_dims, d_stride, x_box, sw);
  if (status == 0) status = encode_tensor_map(&w1_map, w1, 2, w1_dims, d_stride, w1_box, sw);
  if (status == 0) status = encode_tensor_map(&w2_map, w2, 2, w2_dims, k_stride, w2_box, sw);
  if (status != 0) return status;
  dim3 grid((M + BM - 1) / BM * C, splits);
  ff_geglu_kernel<C><<<grid, THREADS, SMEM, stream>>>(
      x_map, w1_map, w2_map, static_cast<const bf16*>(b1),
      static_cast<bf16*>(out), partial, counters, M, K,
      K / Plan<C>::BK / splits);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int slots() {
  const cudaError_t err = configure<C>();
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = SMEM;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&clusters, ff_geglu_kernel<C>, &cfg);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return clusters * C;
}

}  // namespace

// x: bf16 [M, D] contiguous; w1: bf16 [2K, D]; b1: bf16 [2K]; w2: bf16 [D, K];
// out: bf16 [M, D].  D is one of the compiled widths below (the Python
// wrapper, ops/geglu_matmul.py::KERNEL_WIDTHS, lists the same); K is a
// multiple of the chunk 64·D/160 and K / chunk a multiple of splits; x,
// w1 and w2 16-byte aligned (TMA).  With
// splits > 1, workspace is fp32 [splits, M, D] and counters int32
// [ceil(M/128)·D/160], zero on entry and left zero on exit (so one buffer
// serves every call on a stream).  Returns cudaGetLastError(), or the
// CUresult of a tensor map that failed to encode.
extern "C" int tg_ff_geglu_fwd(const void* x, const void* w1, const void* b1,
                               const void* w2, void* out, void* workspace,
                               void* counters, int M, int D, int K, int splits,
                               void* stream) {
  const int bk = HP * D / NO;
  if (D % NO != 0 || K % bk != 0 || splits < 1 || (K / bk) % splits != 0 ||
      (splits > 1 && (workspace == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  int* cnt = static_cast<int*>(counters);
  switch (D) {
    case 320: return launch<2>(x, w1, b1, w2, out, ws, cnt, M, K, splits, st);
    case 640: return launch<4>(x, w1, b1, w2, out, ws, cnt, M, K, splits, st);
    case 1280: return launch<8>(x, w1, b1, w2, out, ws, cnt, M, K, splits, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// CTAs of width D's instance that the card holds at once (whole clusters,
// cudaOccupancyMaxActiveClusters), for the split planner; a negative
// cudaError_t on failure.
extern "C" int tg_ff_geglu_slots(int D) {
  switch (D) {
    case 320: return slots<2>();
    case 640: return slots<4>();
    case 1280: return slots<8>();
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}
