// Flash attention forward for Hopper (sm_90a), bf16 in/out.
//
// Replaces the four TPU attention kernels of
// theatergen_tpu/ops/flash_attention.py:
//   flash_attention_packed (_flat_call / _attn_kernel_flat, whole K per
//     block, S <= 4096);
//   _flash_attention_flat_online (_flat_online_call /
//     _attn_kernel_flat_online, online softmax over K blocks,
//     4096 < S <= 32768);
//   _flash_attention_bshd (_attn_kernel_bshd, online softmax over
//     [B, S, H, D] blocks indexed in place at the native head dim);
//   _flash_attention_impl (_attn_kernel, online softmax over transposed,
//     lane-padded [B*H, S, Dp] copies, Sq padded to the q block).
// All four compute exact softmax attention of q [B, Sq, H, D] against
// k, v [B, Sk, H, D], the d^-0.5 scale and base-2 exponent applied to the
// fp32 logits, 1/l applied to the output.  The K loop below is online at
// every length and reads BSHD in place at the native head dim, so one
// kernel serves every route; the wrapper counts the routes apart.  Sq may
// differ from Sk (sequence-parallel shards: Sq/n queries against all the
// keys) and need not be a multiple of the 128-row q tile: rows >= Sq are
// zero on load and never stored.  Offsets into q, k, v and o are 64-bit.
//
// Bound on the H100: at SD1.5's shapes (S = 4096, d = 40 and S = 1024,
// d = 80; S = 9216, d = 40 on a 768-px canvas; S = 1024, d = 160 on a
// 1024-px canvas) and SDXL's (S = 4096 and 1024, d = 64) the 4·Sq·Sk·d
// operations per head dwarf the bytes, so the kernel is bound by
// tensor-core throughput and by the exp2 of the Sq·Sk logits.
//
// Design.  The logits never leave the chip.  One CTA per (batch·head, 128
// query rows): two consumer warpgroups own 64 rows each, and one producer
// thread (its warpgroup's registers handed to the consumers by setmaxnreg,
// 24 and 240 a thread) keeps K and V tiles of BKV keys (128, or 64 at d =
// 160) in flight through a 3-stage shared-memory ring by TMA, each stage
// handed to the consumers through an mbarrier that completes when its
// bytes land and handed back through a second one.  The Q tile is loaded once, the same
// way.  Keys past Sk and q rows past Sq arrive as zeros.  QK^T runs on
// wgmma m64nBKVk16 with Q and K from shared memory; the online softmax in
// fp32 registers; P, rounded to bf16 in registers, is the register A
// operand of wgmma m64nDk16 for P·V, with V read from shared memory
// transposed (MN-major).  Each warpgroup issues the next tile's QK^T before
// this tile's softmax (two logit buffers), and while one warpgroup runs its
// softmax the other's wgmmas keep the tensor cores busy.  Tiles arrive in panels of 64
// columns, as 128-byte rows in TMA's 128-byte swizzle; the columns past d
// (d = 40: 40..63, d = 80: 80..127, d = 160: 160..191) lie past the tensor
// map's extent and arrive as zeros, so Q and K are padded in shared memory
// only, and QK^T runs ceil(d/16) steps of depth 16 (d = 40: 48).  P·V
// takes N = d (40, 64, 80, 160: multiples of 8).  Every q block runs the same
// key tiles in the same order, so a row's result does not depend on where
// its block sits (the sequence-parallel shards, concatenated, equal the
// unsharded call).  q, k and v may be strided views (e.g. of one QKV
// projection; strides multiples of 8 elements, 16-byte aligned bases); the
// output is contiguous.

#include "common.cuh"

using namespace tg;

namespace {

constexpr int BQ = 128;        // query rows per CTA (2 warpgroups x 64)
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 128;  // + the producer's warpgroup
constexpr int STAGES = 3;

template <int D>
struct Tile {
  static constexpr int KSTEPS = (D + 15) / 16;  // depth-16 steps of QK^T
  static constexpr int NP = (D + 63) / 64;      // 64-column panels of a row
  static constexpr int BKV = D <= 80 ? 128 : 64;
  static constexpr int Q_PANEL = BQ * 128, K_PANEL = BKV * 128;
  static constexpr int Q_BYTES = NP * Q_PANEL;
  static constexpr int STAGE_BYTES = 2 * NP * K_PANEL;  // K, then V
  // + 1 KB: the tiles' base is rounded up to the swizzle atom
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES + (2 * STAGES + 1) * 8;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N> struct Mma;
template <> struct Mma<64> {
  __device__ static void ss(float (&d)[32], uint64_t a, uint64_t b, int acc) { wgmma_m64n64k16_ss(d, a, b, acc); }
};
template <> struct Mma<128> {
  __device__ static void ss(float (&d)[64], uint64_t a, uint64_t b, int acc) { wgmma_m64n128k16_ss(d, a, b, acc); }
};
template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 40) wgmma_m64n40k16_rs<1>(o, a, b, 1);
  else if constexpr (D == 64) wgmma_m64n64k16_rs<1>(o, a, b, 1);
  else if constexpr (D == 80) wgmma_m64n80k16_rs<1>(o, a, b, 1);
  else wgmma_m64n160k16_rs<1>(o, a, b, 1);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 bf16* __restrict__ o, int Sq, int Sk, int H,
                 float scale_log2) {
  using T = Tile<D>;
  constexpr int BKV = T::BKV, NP = T::NP;
  constexpr int NS = BKV / 8;  // 8-key blocks of the logits

  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const uint32_t q_s = smem_u32(smem);
  const uint32_t ring = q_s + T::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::Q_BYTES + STAGES * T::STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int ntiles = (Sk + BKV - 1) / BKV;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);  // one per consumer warp
    }
    mbar_init(q_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer: the Q tile, then K and V tiles into the ring; its
    // warpgroup hands its registers to the consumers
    setmaxnreg_dec<24>();
    if (tid == CONSUMERS) {
      mbar_expect_tx(q_full, T::Q_BYTES);
      for (int p = 0; p < NP; ++p)
        tma_load_4d(q_s + p * T::Q_PANEL, &q_map, q_full, 64 * p, q0, h, b);
      for (int j = 0; j < ntiles; ++j) {
        const int stage = j % STAGES;
        if (j >= STAGES) mbar_wait(&empty[stage], (j / STAGES - 1) & 1);
        const uint32_t ks_ = ring + stage * T::STAGE_BYTES;
        mbar_expect_tx(&full[stage], T::STAGE_BYTES);
        for (int p = 0; p < NP; ++p) {
          tma_load_4d(ks_ + p * T::K_PANEL, &k_map, &full[stage], 64 * p, j * BKV, h, b);
          tma_load_4d(ks_ + (NP + p) * T::K_PANEL, &v_map, &full[stage], 64 * p, j * BKV, h, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64wg ..
  setmaxnreg_inc<240>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int t = lane & 3;
  const uint32_t q_wg = q_s + wg * 64 * 128;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  mbar_wait(q_full, 0);

  // issue tile j's logits (64 rows x BKV keys) into s, once its K is in
  auto issue_qk = [&](float (&s)[BKV / 2], int j) {
    const int stage = j % STAGES;
    const uint32_t ks_ = ring + stage * T::STAGE_BYTES;
    mbar_wait(&full[stage], (j / STAGES) & 1);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::KSTEPS; ++kk)
      Mma<BKV>::ss(s, wgmma_desc_sw128(q_wg + (kk >> 2) * T::Q_PANEL + (kk & 3) * 32),
                   wgmma_desc_sw128(ks_ + (kk >> 2) * T::K_PANEL + (kk & 3) * 32), kk > 0);
    wgmma_commit();
  };

  // tile j: its logits s are complete; tile j + 1's go into `next` while
  // this one's softmax runs
  auto step = [&](float (&s)[BKV / 2], float (&next)[BKV / 2], int j) {
    if (j + 1 < ntiles) issue_qk(next, j + 1);
    const int stage = j % STAGES;
    const uint32_t vs_ = ring + stage * T::STAGE_BYTES + NP * T::K_PANEL;
    const int k0 = j * BKV;
    if (k0 + BKV > Sk) {  // the ragged last tile: keys >= Sk take no weight
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + n * 8 + 2 * t + (e & 1) >= Sk) s[4 * n + e] = -INFINITY;
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // the maxima of the scaled base-2 logits (scale > 0); every tile holds
    // at least one key < Sk, so they are finite
    const float mn0 = fmaxf(m0, mx0 * scale_log2), mn1 = fmaxf(m1, mx1 * scale_log2);
    const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[4 * n] = ex2(fmaf(s[4 * n], scale_log2, -mn0));
      s[4 * n + 1] = ex2(fmaf(s[4 * n + 1], scale_log2, -mn0));
      s[4 * n + 2] = ex2(fmaf(s[4 * n + 2], scale_log2, -mn1));
      s[4 * n + 3] = ex2(fmaf(s[4 * n + 3], scale_log2, -mn1));
      ps0 += s[4 * n] + s[4 * n + 1];
      ps1 += s[4 * n + 2] + s[4 * n + 3];
    }
    l0 = l0 * a0 + ps0;  // per-thread partial sums; the quad adds them last
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[4 * n] *= a0;
      acc[4 * n + 1] *= a0;
      acc[4 * n + 2] *= a1;
      acc[4 * n + 3] *= a1;
    }

    // P (bf16, from the logit accumulators in place) times V; V MN-major:
    // 16 keys a step, its 64-column panels K_PANEL bytes apart
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[8 * kk], s[8 * kk + 1]), pack_bf16(s[8 * kk + 2], s[8 * kk + 3]),
          pack_bf16(s[8 * kk + 4], s[8 * kk + 5]), pack_bf16(s[8 * kk + 6], s[8 * kk + 7])};
      pv<D>(acc, pa, wgmma_desc_sw128(vs_ + kk * 2048, T::K_PANEL));
    }
    wgmma_commit();
    wgmma_wait<0>();  // this tile's P·V and the next tile's logits
    fence_regs(acc);
    fence_regs(next);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
  };

  float sa[BKV / 2], sb[BKV / 2];
  issue_qk(sa, 0);
  wgmma_wait<0>();
  fence_regs(sa);
  for (int j = 0; j < ntiles; j += 2) {
    step(sa, sb, j);
    if (j + 1 < ntiles) step(sb, sa, j + 1);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float i0 = l0 == 0.f ? 1.f : 1.f / l0;
  const float i1 = l1 == 0.f ? 1.f : 1.f / l1;

  const long long row_stride = (long long)H * D;
  bf16* ob = o + (long long)b * Sq * row_stride + (long long)h * D;
  const int row = q0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (row < Sq)
      st32(ob + row * row_stride + c, pack_bf16(acc[4 * n] * i0, acc[4 * n + 1] * i0));
    if (row + 8 < Sq)
      st32(ob + (row + 8) * row_stride + c,
           pack_bf16(acc[4 * n + 2] * i1, acc[4 * n + 3] * i1));
  }
}

// [D, S, H, B] view of one of q, k, v (strides in elements), boxes of 64
// columns and `rows` rows
inline int encode(CUtensorMap* map, const void* base, int D, int S, int H,
                  int B, const long long* st, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[1] * 2, (cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  return encode_tensor_map(map, base, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, const long long* qs, const long long* ks,
           const long long* vs, float scale_log2, cudaStream_t stream) {
  using T = Tile<D>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  CUtensorMap q_map, k_map, v_map;
  int status = encode(&q_map, q, D, Sq, H, B, qs, BQ);
  if (status == 0) status = encode(&k_map, k, D, Sk, H, B, ks, T::BKV);
  if (status == 0) status = encode(&v_map, v, D, Sk, H, B, vs, T::BKV);
  if (status != 0) return status;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, THREADS, T::SMEM, stream>>>(
      q_map, k_map, v_map, static_cast<bf16*>(o), Sq, Sk, H, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: bf16 [B, Sq, H, D]; k, v: bf16 [B, Sk, H, D]; each with unit stride on
// D and the given batch, sequence and head strides (elements, multiples of
// 8, 16-byte aligned base); o: contiguous bf16 [B, Sq, H, D].  D is one of
// the compiled head dims below (the Python wrapper,
// ops/flash_attention.py::KERNEL_HEAD_DIMS, lists the same and raises for
// any other).  Returns cudaGetLastError(), or the CUresult of a tensor map
// that failed to encode.
extern "C" int tg_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Sk, int H, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, float scale_log2, void* stream) {
  const long long qs[3] = {q_sb, q_ss, q_sh}, ks[3] = {k_sb, k_ss, k_sh};
  const long long vs[3] = {v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40: return launch<40>(q, k, v, o, B, Sq, Sk, H, qs, ks, vs, scale_log2, st);
    case 64: return launch<64>(q, k, v, o, B, Sq, Sk, H, qs, ks, vs, scale_log2, st);
    case 80: return launch<80>(q, k, v, o, B, Sq, Sk, H, qs, ks, vs, scale_log2, st);
    case 160: return launch<160>(q, k, v, o, B, Sq, Sk, H, qs, ks, vs, scale_log2, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
