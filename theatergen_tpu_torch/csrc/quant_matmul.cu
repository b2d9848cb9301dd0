// W8A8 matmul for Hopper (sm_90a) with the activation quantisation inside:
//   s[m]      = max(max_k |x[m, k]| / 127, 1e-8)                  (fp32)
//   xq[m, k]  = clamp(rint(x[m, k] / s[m]), -127, 127)             (int8)
//   acc[m, n] = sum_k xq[m, k] * w_q[n, k]                         (int32)
//   out[m, n] = bf16(acc[m, n] * (s[m] * w_scale[n]) + bias[n])    (fp32)
// x is bf16 [M, K], w_q int8 [N, K], w_scale fp32 [N], bias bf16 [N] or
// null.  Where row_amax (fp32 [M]) is given it replaces max_k |x[m, k]|:
// a row-parallel layer's x holds 1/tp of K, and its scales are the whole
// row's (the maxima all-reduced over tp first).  Every step is one IEEE fp32 operation in the order written (no
// FMA contraction), and the int32 sum is exact (5120 * 127^2 < 2^31), so
// the result equals the plain version's (ops/quant_matmul.py::
// quant_matmul_plain) bit for bit.
//
// Replaces theatergen_tpu/ops/quant_matmul.py::quant_matmul (_qmm_kernel),
// the TPU kernel whose grid walks a row block's N tiles in order and keeps
// the block's int8 activations and scales in VMEM scratch from n == 0.
//
// Bound on the H100: bytes at every shape of the SD1.5 W8A8 UNet (x read
// once, w_q once, the output written once: 2MK + KN + 2MN; the 184 calls
// of one CFG evaluation move 1.49 GB, 0.444 ms at 3.35 TB/s, against
// 467 GOPS, 0.236 ms at 1979 int8 TOPS).
//
// Design.  GPU blocks share nothing, so the first design (64x128 tiles)
// read and quantised A once per 128 output columns (N/128 times a call).
// Here a thread-block cluster of C CTAs along N (C = 1, 2, 4 or 8, the
// largest that divides the column tiles) shares one row block of BM = 128
// rows; CTA r owns output columns [160r, 160r + 160) of its column group.
//   1. Row scales: each CTA reduces the row maxima of x over 1/C of K (a
//      warp per 4 rows, its lanes along K, a warp max of the bits of |x|)
//      and the cluster exchanges them through distributed shared memory; a
//      maximum is exact in any order, so every CTA holds the same scales.
//      With row_amax given, every CTA reads the row maxima from it instead.
//   2. K loop in steps of 128: a producer thread keeps a ring full by TMA
//      (W tile [160, 128] int8 in 128-byte swizzle, read in place from
//      w_q [N, K], and this CTA's 128/C rows of the bf16 A tile); seven
//      quantiser warps turn those rows into int8 and store them, in the
//      128-byte swizzle that the wgmma descriptor reads, into this CTA's A
//      slot, and one of them sends them on to the same rows of every peer's
//      slot with the bulk-copy engine (cp.async.bulk shared::cta ->
//      shared::cluster), which counts the bytes on that slot's "stored"
//      mbarrier (a "freed" mbarrier in each writer counts the C readers
//      done with a slot); two consumer warpgroups (64 rows each,
//      setmaxnreg) run wgmma m64n160k32 s8 -> s32 with both operands
//      K-major in shared memory.  (Per-thread st.shared::cluster stores
//      with a cluster-scope proxy fence cost 1-5 µs a step on the card.)
//   Where N exceeds one cluster's C·160 columns, clusters repeat over
//   column groups: A is quantised ceil(N / (C·160)) times a call, 8 times
//   at the widest shape (N = 10240, C = 8) against 80 in the first design.
//   K past its end arrives as zeros from TMA (0 quantises to 0 and adds 0
//   to the exact sum: K = 320, 768, ...); rows past M as zeros, masked at
//   the store; columns past N zero and masked (N = 130).
// The quotient: y = x · fl(1/s) is within 1.6e-5 of x / s (|x / s| <= 127,
// two roundings); where any of a 16-value chunk's y lies within 1e-4 of a
// half-integer the quantiser takes __fdiv_rn(x, s) for the chunk instead,
// so rint() sees the IEEE quotient's side of every rounding boundary and
// the int8 values are the ones __fdiv_rn gives, at a multiply's cost and
// with no branch per value (tests/test_torch_port_plans.py holds the rule
// against the IEEE quotient at and around every half-integer).
//   3. Split-K where the tiles leave SMs idle (ops/quant_matmul.py::
//      qmm_plan: the M = 2, 128, 154 and 512 shapes): each split computes
//      the row scales over the whole K itself, runs its share of the K
//      steps, writes its int32 partial tile to a workspace and counts
//      itself in a per-tile counter; the last split to arrive sums the
//      partials (exact in any order) and applies the epilogue, so the
//      output is bit-equal whichever split finishes last, and resets the
//      counter.
// One launch per call: a separate quantise kernel would add a launch,
// 17-43 µs of host time each on the host-bound W8A8 path (9200 calls a
// request).

#include "common.cuh"

using namespace tg;

namespace {

constexpr int BM = 128, BN = 160, BK = 128;  // BK: int8 columns per step
constexpr int CONSUMERS = 256;               // two warpgroups
constexpr int QUANT_WARPS = 7;               // warps 9..15
constexpr int THREADS = CONSUMERS + 256;     // + producer warp + quantisers
constexpr int W_BYTES = BN * BK;             // W tile [160, 128] int8
constexpr int AQ_BYTES = BM * BK;            // int8 A tile [128, 128]

template <int C>
struct Cfg {
  static constexpr int R = BM / C;                     // rows quantised per CTA
  static constexpr int A_BYTES = R * BK * 2;           // bf16 rows [R, 128]
  static constexpr int STAGE = W_BYTES + A_BYTES;      // multiple of 1024
  static constexpr int STAGES = C == 1 ? 3 : (C == 8 ? 5 : 4);
  static constexpr int SMEM = 1024 + STAGES * (STAGE + AQ_BYTES) + 4 * STAGES * 8 +
                              3 * BM * 4 + 2 * BN * 4;
};

// rint(y) clamped to +-127, one byte
__device__ __forceinline__ uint32_t to_byte(float y) {
  return static_cast<uint32_t>(max(-127, min(127, __float2int_rn(y)))) & 0xffu;
}

// 16 bf16 values (one 16-byte int8 chunk) quantised: y = x · fl(1/s),
// without a branch; `near` gathers whether any y lies within 1e-4 of a
// half-integer, where the caller takes quant16_exact instead
__device__ __forceinline__ uint4 quant16(const uint4 (&v)[2], float inv, bool& near) {
  uint32_t out[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint32_t pair[2] = {(&v[w >> 1].x)[2 * (w & 1)], (&v[w >> 1].x)[2 * (w & 1) + 1]};
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t bits = pair[e >> 1];
      const float x = __uint_as_float((e & 1) ? bits & 0xffff0000u : bits << 16);
      const float y = __fmul_rn(x, inv);
      near |= fabsf(__fsub_rn(y, rintf(y))) > 0.4999f;
      word |= to_byte(y) << (8 * e);
    }
    out[w] = word;
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// the same with the IEEE quotient __fdiv_rn(x, s) for every value
__device__ __noinline__ uint4 quant16_exact(const uint4 (&v)[2], float s) {
  uint32_t out[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint32_t pair[2] = {(&v[w >> 1].x)[2 * (w & 1)], (&v[w >> 1].x)[2 * (w & 1) + 1]};
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t bits = pair[e >> 1];
      const float x = __uint_as_float((e & 1) ? bits & 0xffff0000u : bits << 16);
      word |= to_byte(__fdiv_rn(x, s)) << (8 * e);
    }
    out[w] = word;
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

__device__ __forceinline__ uint32_t ld_dsmem32(const void* p, uint32_t rank) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n"
               : "=r"(v) : "r"(cluster_addr(p, rank)) : "memory");
  return v;
}

// the quantiser warps alone
__device__ __forceinline__ void named_sync_quant() {
  asm volatile("bar.sync 2, %0;\n" :: "n"(QUANT_WARPS * 32) : "memory");
}

template <int C>
__global__ void __cluster_dims__(C, 1, 1) __launch_bounds__(THREADS, 1)
quant_matmul_kernel(const __grid_constant__ CUtensorMap a_map,
                    const __grid_constant__ CUtensorMap w_map,
                    const __grid_constant__ CUtensorMap out_map, bool tma_out,
                    const bf16* __restrict__ x, const float* __restrict__ wscale,
                    const bf16* __restrict__ bias, const float* __restrict__ row_amax,
                    bf16* __restrict__ out,
                    int* __restrict__ partial, int* __restrict__ counters, int M,
                    int N, int K, int groups, int steps_per_split) {
  using P = Cfg<C>;
  constexpr int STAGES = P::STAGES, R = P::R;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  unsigned char* aq = smem + STAGES * P::STAGE;          // int8 A slots
  uint64_t* full = reinterpret_cast<uint64_t*>(aq + STAGES * AQ_BYTES);
  uint64_t* empty = full + STAGES;    // consumers' W and quantisers' A rows read
  uint64_t* stored = empty + STAGES;  // all rows of the A slot here (own + peers' bytes)
  uint64_t* freed = stored + STAGES;  // every CTA's consumers done with A slot
  unsigned* pmax = reinterpret_cast<unsigned*>(freed + STAGES);  // [BM]
  float* s_row = reinterpret_cast<float*>(pmax + BM);            // [BM]
  float* s_inv = s_row + BM;                                     // [BM]
  float* s_ws = s_inv + BM;                                      // [BN]
  float* s_bias = s_ws + BN;                                     // [BN]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = static_cast<int>(cluster_ctarank());
  const int cid = blockIdx.x / C;
  const int m0 = (cid / groups) * BM;
  const int n0 = ((cid % groups) * C + rank) * BN;
  const int step0 = blockIdx.y * steps_per_split;
  const int nsteps = steps_per_split;
  const uint32_t ring = smem_u32(smem);

  auto issue = [&](int s) {  // the producer thread: ring step s
    const int stage = s % STAGES;
    const uint32_t st = ring + stage * P::STAGE;
    mbar_expect_tx(&full[stage], W_BYTES + P::A_BYTES);
    tma_load_2d(st, &w_map, &full[stage], (step0 + s) * BK, n0);
    tma_load_2d(st + W_BYTES, &a_map, &full[stage], (step0 + s) * BK, m0 + rank * R);
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32 + 1);
      mbar_init(&stored[s], 1);
      mbar_init(&freed[s], C * CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
  // the first stages' loads fly while the row maxima are taken
  if (tid == CONSUMERS)
    for (int s = 0; s < min(STAGES, nsteps); ++s) issue(s);

  // 1. row maxima over this CTA's share of K: each warp takes 8 rows, its
  // lanes along K (16-byte loads, 512 contiguous bytes a row), and reduces
  // them over the warp; none where the caller gives them
  if (row_amax == nullptr) {
    const int units = K / 8, per = (units + C - 1) / C;
    const int u0 = rank * per, u1 = min(units, u0 + per);
    constexpr int RW = BM / (THREADS / 32);  // rows per warp
    const int r0 = warp * RW;
    float amax[RW];
#pragma unroll
    for (int j = 0; j < RW; ++j) amax[j] = 0.f;
    for (int u = u0 + lane; u < u1; u += 32) {
      uint4 v[RW];
#pragma unroll
      for (int j = 0; j < RW; ++j) {
        const bool ok = m0 + r0 + j < M;
        v[j] = ok ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + r0 + j) * K) + u)
                  : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int j = 0; j < RW; ++j) {
        const uint32_t w[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
          amax[j] = fmaxf(amax[j], fmaxf(fabsf(f.x), fabsf(f.y)));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < RW; ++j) {
      // |x| >= 0: the bits order as the values
      const unsigned m = __reduce_max_sync(0xffffffffu, __float_as_uint(amax[j]));
      if (lane == 0) pmax[r0 + j] = m;
    }
  }
  // every CTA's maxima (and barriers) are in place before any remote access
  cluster_arrive();
  cluster_wait();
  if (tid < BM) {
    float amax = 0.f;
    if (row_amax != nullptr) {
      if (m0 + tid < M) amax = row_amax[m0 + tid];
    } else {
      unsigned bits = 0u;
#pragma unroll
      for (int j = 0; j < C; ++j) bits = max(bits, ld_dsmem32(&pmax[tid], j));
      amax = __uint_as_float(bits);
    }
    s_row[tid] = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
    s_inv[tid] = __frcp_rn(s_row[tid]);
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    setmaxnreg_dec<64>();
    if (warp == CONSUMERS / 32) {
      // producer: refill a stage once its W and A rows have been read
      if (lane == 0)
        for (int s = STAGES; s < nsteps; ++s) {
          mbar_wait(&empty[s % STAGES], (s / STAGES - 1) & 1);
          issue(s);
        }
      __syncwarp();
    } else {
      // quantisers: 16 columns (one 16-byte int8 chunk) of one row a unit
      const int qt = tid - CONSUMERS - 32;
      for (int s = 0; s < nsteps; ++s) {
        const int stage = s % STAGES;
        mbar_wait(&full[stage], (s / STAGES) & 1);
        if (s >= STAGES) mbar_wait_cluster(&freed[stage], (s / STAGES - 1) & 1);
        const unsigned char* a = smem + stage * P::STAGE + W_BYTES;
        unsigned char* slot = aq + stage * AQ_BYTES;
        // rows past M and columns past K are not quantised: their products
        // are masked at the store or meet zero W columns
        const int rows = min(R, M - m0 - rank * R);
        const int chunks = min(BK / 16, (K - (step0 + s) * BK) / 16);
        for (int u = qt; u < rows * 8; u += QUANT_WARPS * 32) {
          const int lr = u >> 3, c = u & 7, row = rank * R + lr;
          if (c >= chunks) continue;
          const float sc = s_row[row];
          const uint4 v[2] = {*reinterpret_cast<const uint4*>(a + lr * BK * 2 + c * 32),
                              *reinterpret_cast<const uint4*>(a + lr * BK * 2 + c * 32 + 16)};
          bool near = false;
          uint4 q = quant16(v, s_inv[row], near);
          if (near) q = quant16_exact(v, sc);
          // 128-byte swizzle: chunk c of row `row` at chunk c ^ (row % 8)
          *reinterpret_cast<uint4*>(slot + row * BK + ((c ^ (row & 7)) << 4)) = q;
        }
        // this CTA's rows of the slot, written, go to every peer's slot by
        // the bulk-copy engine and count there on `stored`'s transactions;
        // the rows stay until every CTA's consumers have freed the slot
        fence_proxy_async_cta();
        named_sync_quant();
        if (qt == 0) {
          mbar_arrive(&empty[stage]);
#pragma unroll
          for (int j = 1; j < C; ++j)
            bulk_copy_to_peer(slot + rank * R * BK, R * BK, &stored[stage], (rank + j) % C);
          mbar_expect_tx(&stored[stage], (C - 1) * R * BK);
        }
      }
    }
    // no CTA leaves while a neighbour may still store into it or arrive on
    // its barriers
    cluster_arrive();
    cluster_wait();
    return;
  }

  setmaxnreg_inc<192>();
  const int wg = tid >> 7, g = lane >> 2, t = lane & 3;
  // the epilogue's column scales and bias (0 past N), read once
  if (tid < BN) {
    const int c = n0 + tid;
    s_ws[tid] = c < N ? wscale[c] : 0.f;
    s_bias[tid] = c < N && bias != nullptr ? __bfloat162float(bias[c]) : 0.f;
  }
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  // a slot is freed in every CTA only where a later step reuses it (a
  // cluster-scope release costs about a microsecond)
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s % STAGES]);
    if (s + STAGES < nsteps && lane < C) mbar_arrive_remote(&freed[s % STAGES], lane);
  };
  for (int s = 0; s < nsteps; ++s) {
    const int stage = s % STAGES;
    mbar_wait(&full[stage], (s / STAGES) & 1);
    // the peers' rows arrive by bulk copy: their completion on this CTA's
    // barrier makes them visible, as a TMA load's does
    mbar_wait(&stored[stage], (s / STAGES) & 1);
    const uint32_t w_st = ring + stage * P::STAGE;
    const uint32_t a_st = smem_u32(aq + stage * AQ_BYTES) + wg * 64 * BK;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      wgmma_m64n160k32_s8_ss(acc, wgmma_desc_sw128(a_st + kk * 32),
                             wgmma_desc_sw128(w_st + kk * 32), 1);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    if (s > 0) release(s - 1);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  release(nsteps - 1);
  cluster_arrive();
  cluster_wait();

  // epilogue: d[4i + 2h + e] at row lr0 + 8h, column n0 + 8i + 2t + e
  const int lr0 = wg * 64 + (warp & 3) * 16 + g;
  const bool pairs = (N & 1) == 0;
  const int splits = gridDim.y;
  if (splits > 1) {
    __shared__ int is_last;
    int* mine = partial + (size_t)blockIdx.y * M * N;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + lr0 + 8 * h, c = n0 + 8 * i + 2 * t;
        if (r >= M || c >= N) continue;
        int* p = mine + (size_t)r * N + c;
        if (pairs) {
          __stcg(reinterpret_cast<int2*>(p), make_int2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]));
        } else {
          __stcg(p, acc[4 * i + 2 * h]);
          if (c + 1 < N) __stcg(p + 1, acc[4 * i + 2 * h + 1]);
        }
      }
    __threadfence();
    named_sync<CONSUMERS>();
    const int tile = blockIdx.x;
    if (tid == 0) is_last = atomicAdd(&counters[tile], 1) == splits - 1;
    named_sync<CONSUMERS>();
    if (!is_last) return;
    __threadfence();
    // the other splits' partials (int32: exact in any order), every load
    // of a split issued before any is used
    for (int sp = 0; sp < splits; ++sp) {
      if (sp == static_cast<int>(blockIdx.y)) continue;
      const int* ps = partial + (size_t)sp * M * N;
      int v[BN / 8][2][2];
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + lr0 + 8 * h, c = n0 + 8 * i + 2 * t;
          const int* p = ps + (size_t)r * N + c;
          const bool ok = r < M && c < N;
          if (pairs) {
            const int2 w = ok ? __ldcg(reinterpret_cast<const int2*>(p)) : make_int2(0, 0);
            v[i][h][0] = w.x;
            v[i][h][1] = w.y;
          } else {
            v[i][h][0] = ok ? __ldcg(p) : 0;
            v[i][h][1] = ok && c + 1 < N ? __ldcg(p + 1) : 0;
          }
        }
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[4 * i + 2 * h] += v[i][h][0];
          acc[4 * i + 2 * h + 1] += v[i][h][1];
        }
    }
    if (tid == 0) counters[tile] = 0;
  }
  const bool has_bias = bias != nullptr;
  // with TMA, the bf16 tile [128, 160] is staged in the ring (every stage
  // consumed) and stored by one bulk copy, which drops what lies past M
  // and N
  bf16* tile = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + lr0 + 8 * h;
    const float sc = s_row[lr0 + 8 * h];
    bf16* orow = out + (size_t)r * N;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int cl = 8 * i + 2 * t, c = n0 + cl;
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        y[e] = __fmul_rn(__int2float_rn(acc[4 * i + 2 * h + e]), __fmul_rn(sc, s_ws[cl + e]));
        if (has_bias) y[e] = __fadd_rn(y[e], s_bias[cl + e]);
      }
      if (tma_out) {
        st32(tile + (lr0 + 8 * h) * BN + cl, pack_bf16(y[0], y[1]));
        continue;
      }
      if (r >= M || c >= N) continue;
      if (pairs) {
        st32(orow + c, pack_bf16(y[0], y[1]));
      } else {
        orow[c] = __float2bfloat16_rn(y[0]);
        if (c + 1 < N) orow[c + 1] = __float2bfloat16_rn(y[1]);
      }
    }
  }
  if (tma_out) {
    fence_proxy_async_cta();
    named_sync<CONSUMERS>();
    if (tid == 0) tma_store_2d(&out_map, smem_u32(tile), n0, m0);
  }
}

template <int C>
cudaError_t configure() {
  static cudaError_t status = cudaFuncSetAttribute(
      quant_matmul_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<C>::SMEM);
  return status;
}

template <int C>
int launch(const void* x, const void* wq, const void* wscale, const void* bias,
           const void* row_amax, void* out, int* partial, int* counters, int M, int N, int K,
           int splits, cudaStream_t stream) {
  const cudaError_t err = configure<C>();
  if (err != cudaSuccess) return static_cast<int>(err);
  // x [M, K] bf16 in rows of 128 columns (plain layout: the quantisers
  // read it), w_q [N, K] int8 in 128-byte swizzled tiles [160, 128]
  CUtensorMap a_map, w_map, out_map = {};
  const cuuint64_t a_dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t w_dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t a_stride[1] = {2 * (cuuint64_t)K}, w_stride[1] = {(cuuint64_t)K};
  const cuuint32_t a_box[2] = {BK, Cfg<C>::R}, w_box[2] = {BK, BN};
  int status = encode_tensor_map(&a_map, x, 2, a_dims, a_stride, a_box,
                                 CU_TENSOR_MAP_SWIZZLE_NONE);
  if (status == 0)
    status = encode_tensor_map(&w_map, wq, 2, w_dims, w_stride, w_box,
                               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  // the output by TMA where its rows are 16-byte multiples
  const bool tma_out = N % 8 == 0;
  const cuuint64_t o_dims[2] = {(cuuint64_t)N, (cuuint64_t)M};
  const cuuint64_t o_stride[1] = {2 * (cuuint64_t)N};
  const cuuint32_t o_box[2] = {BN, BM};
  if (status == 0)
    status = tma_out ? encode_tensor_map(&out_map, out, 2, o_dims, o_stride, o_box,
                                         CU_TENSOR_MAP_SWIZZLE_NONE)
                     : 0;
  if (status != 0) return status;
  const int tiles = (N + BN - 1) / BN, groups = tiles / C;
  const int steps = (K + BK - 1) / BK;
  const dim3 grid((M + BM - 1) / BM * groups * C, splits);
  quant_matmul_kernel<C><<<grid, THREADS, Cfg<C>::SMEM, stream>>>(
      a_map, w_map, out_map, tma_out, static_cast<const bf16*>(x), static_cast<const float*>(wscale),
      static_cast<const bf16*>(bias), static_cast<const float*>(row_amax),
      static_cast<bf16*>(out), partial, counters,
      M, N, K, groups, steps / splits);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int slots() {
  const cudaError_t err = configure<C>();
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = Cfg<C>::SMEM;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&clusters, quant_matmul_kernel<C>, &cfg);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return clusters * C;
}

}  // namespace

// x: bf16 [M, K] contiguous, 16-byte aligned; wq: int8 [N, K] contiguous,
// 16-byte aligned; wscale: fp32 [N]; bias: bf16 [N] or null; row_amax:
// fp32 [M] (each row's max |x| over the whole K) or null; out: bf16
// [M, N].  K a positive multiple of 32; cluster (1, 2, 4 or 8) divides
// the column tiles ceil(N / 160) and splits the K steps ceil(K / 128), as
// ops/quant_matmul.py::qmm_plan gives them.  With splits > 1, workspace
// is int32 [splits, M, N] and counters int32 [ceil(M/128)·ceil(N/160)],
// zero on entry and left zero on exit.  Returns cudaGetLastError(), or the
// CUresult of a tensor map that failed to encode.
extern "C" int tg_quant_matmul_fwd(const void* x, const void* wq,
                                   const void* wscale, const void* bias,
                                   const void* row_amax, void* out, void* workspace, void* counters,
                                   int M, int N, int K, int cluster, int splits,
                                   void* stream) {
  const int tiles = (N + BN - 1) / BN, steps = (K + BK - 1) / BK;
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0 || cluster < 1 ||
      tiles % cluster != 0 || splits < 1 || steps % splits != 0 ||
      (splits > 1 && (workspace == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* ws = static_cast<int*>(workspace);
  int* cnt = static_cast<int*>(counters);
  switch (cluster) {
    case 1: return launch<1>(x, wq, wscale, bias, row_amax, out, ws, cnt, M, N, K, splits, st);
    case 2: return launch<2>(x, wq, wscale, bias, row_amax, out, ws, cnt, M, N, K, splits, st);
    case 4: return launch<4>(x, wq, wscale, bias, row_amax, out, ws, cnt, M, N, K, splits, st);
    case 8: return launch<8>(x, wq, wscale, bias, row_amax, out, ws, cnt, M, N, K, splits, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// CTAs of the cluster-size-C instance that the card holds at once (whole
// clusters), for the split planner; a negative cudaError_t on failure.
extern "C" int tg_quant_matmul_slots(int cluster) {
  switch (cluster) {
    case 1: return slots<1>();
    case 2: return slots<2>();
    case 4: return slots<4>();
    case 8: return slots<8>();
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}
