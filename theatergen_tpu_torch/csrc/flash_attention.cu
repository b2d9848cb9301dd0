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
// keys) and need not be a multiple of the 64-row q tile: rows >= Sq are
// zero on load and never stored.  Offsets into q, k, v and o are 64-bit.
//
// Bound on the H100: at SD1.5's shapes (S = 4096, d = 40 and S = 1024,
// d = 80; S = 9216, d = 40 on a 768-px canvas; S = 1024, d = 160 on a
// 1024-px canvas) and SDXL's (S = 4096 and 1024, d = 64) the 4·Sq·Sk·d
// operations per head dwarf the bytes, so the kernel is bound by
// tensor-core throughput and by the exp2 of the Sq·Sk logits.
// The design keeps the logits out of device memory: one block per
// (batch·head, 64 query rows), one warp per 16 query rows, K/V tiles of 64
// keys in shared memory, online softmax in fp32 registers, QK^T and PV on
// mma.sync m16n8k16 (bf16 -> fp32).  d = 40 is not a multiple of the MMA
// depth 16: Q and K are zero-padded to 48 in shared memory only (d = 64,
// 80 and 160 need no pad).  The output MMA covers ceil(d/8) column tiles,
// so V needs no pad.  The three tiles live in dynamic shared memory: at
// d = 160 they take 64.5 KB, past the 48 KB static limit, and the launch
// opts in.  Up to d = 80 each warp keeps its Q fragments in registers; at
// d = 160 the fp32 output accumulator alone takes 80 registers a thread,
// so the Q fragments are read from shared memory at each K tile instead.
// q, k and v may be strided views (e.g. of one QKV projection); the output
// is contiguous.

#include "common.cuh"

using namespace tg;

namespace {

constexpr int BQ = 64;       // query rows per block (4 warps x 16)
constexpr int BKV = 64;      // keys per K/V tile
constexpr int THREADS = 128;

struct Strides {
  long long b, s, h;
};

template <int D>
struct Tile {
  static constexpr int DP = (D + 15) / 16 * 16;  // MMA depth pad of QK^T
  static constexpr int LD = DP + 8;              // smem row stride: spreads banks
  static constexpr int SMEM = (BQ + 2 * BKV) * LD * 2;  // bytes
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int Sq,
                 int Sk, int H, Strides qs, Strides ks, Strides vs,
                 float scale_log2) {
  constexpr int DP = Tile<D>::DP;
  constexpr int LD = Tile<D>::LD;
  constexpr int KSTEPS = DP / 16;
  constexpr int NT = D / 8;               // 8-column tiles of the output
  constexpr int CH = D / 8;               // 16-byte chunks per row
  constexpr bool QREG = D <= 80;          // Q fragments held in registers

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + BQ * LD;
  bf16* v_s = k_s + BKV * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  if (DP > D) {  // pad columns of q_s and k_s stay zero for the whole run
    for (int i = tid; i < BQ * (DP - D); i += THREADS) {
      const int r = i / (DP - D), c = D + i % (DP - D);
      q_s[r * LD + c] = __float2bfloat16(0.f);
      k_s[r * LD + c] = __float2bfloat16(0.f);
    }
  }
  for (int i = tid; i < BQ * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = zero;
    if (q0 + r < Sq) val = ldg128(qb + (long long)(q0 + r) * qs.s + c);
    *reinterpret_cast<uint4*>(&q_s[r * LD + c]) = val;
  }
  __syncthreads();

  const int r0 = warp * 16 + g;
  uint32_t qf[QREG ? KSTEPS : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      qf[kk][0] = lds32(&q_s[r0 * LD + kk * 16 + 2 * t]);
      qf[kk][1] = lds32(&q_s[(r0 + 8) * LD + kk * 16 + 2 * t]);
      qf[kk][2] = lds32(&q_s[r0 * LD + kk * 16 + 8 + 2 * t]);
      qf[kk][3] = lds32(&q_s[(r0 + 8) * LD + kk * 16 + 8 + 2 * t]);
    }
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += BKV) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < BKV * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 kv = zero, vv = zero;
      if (k0 + r < Sk) {
        kv = ldg128(kb + (long long)(k0 + r) * ks.s + c);
        vv = ldg128(vb + (long long)(k0 + r) * vs.s + c);
      }
      *reinterpret_cast<uint4*>(&k_s[r * LD + c]) = kv;
      *reinterpret_cast<uint4*>(&v_s[r * LD + c]) = vv;
    }
    __syncthreads();

    // logits of 16 rows x 64 keys: 8 column tiles of 8 keys
    float s[8][4];
    if constexpr (QREG) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          const bf16* kr = &k_s[(n * 8 + g) * LD + kk * 16 + 2 * t];
          mma_16816(s[n], qf[kk], lds32(kr), lds32(kr + 8));
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint32_t a[4] = {
            lds32(&q_s[r0 * LD + kk * 16 + 2 * t]),
            lds32(&q_s[(r0 + 8) * LD + kk * 16 + 2 * t]),
            lds32(&q_s[r0 * LD + kk * 16 + 8 + 2 * t]),
            lds32(&q_s[(r0 + 8) * LD + kk * 16 + 8 + 2 * t])};
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const bf16* kr = &k_s[(n * 8 + g) * LD + kk * 16 + 2 * t];
          mma_16816(s[n], a, lds32(kr), lds32(kr + 8));
        }
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        s[n][e] = key < Sk ? s[n][e] * scale_log2 : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // every tile holds at least one key < Sk, so the new maxima are finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = exp2f(s[n][0] - mn0);
      s[n][1] = exp2f(s[n][1] - mn0);
      s[n][2] = exp2f(s[n][2] - mn1);
      s[n][3] = exp2f(s[n][3] - mn1);
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = l0 * a0 + ps0;  // per-thread partial sums; the quad adds them last
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }

    // P (bf16, from the logit accumulators in place) times V
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, &v_s[(kk * 16 + (lane & 15)) * LD + n * 8]);
        mma_16816(acc[n], pa, b0, b1);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float i0 = l0 == 0.f ? 1.f : 1.f / l0;
  const float i1 = l1 == 0.f ? 1.f : 1.f / l1;

  const long long row_stride = (long long)H * D;
  bf16* ob = o + (long long)b * Sq * row_stride + (long long)h * D;
  const int row = q0 + r0;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * t;
    if (row < Sq)
      st32(ob + row * row_stride + c, pack_bf16(acc[n][0] * i0, acc[n][1] * i0));
    if (row + 8 < Sq)
      st32(ob + (row + 8) * row_stride + c,
           pack_bf16(acc[n][2] * i1, acc[n][3] * i1));
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, Strides qs, Strides ks, Strides vs,
           float scale_log2, cudaStream_t stream) {
  constexpr int smem = Tile<D>::SMEM;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Sk, H, qs, ks,
      vs, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: bf16 [B, Sq, H, D]; k, v: bf16 [B, Sk, H, D]; each with unit stride on
// D and the given batch, sequence and head strides (elements, multiples of
// 8, 16-byte aligned base); o: contiguous bf16 [B, Sq, H, D].  D is one of
// the compiled head dims below (the Python wrapper,
// ops/flash_attention.py::KERNEL_HEAD_DIMS, lists the same and raises for
// any other).  Returns cudaGetLastError().
extern "C" int tg_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Sk, int H, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, float scale_log2, void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40: return launch<40>(q, k, v, o, B, Sq, Sk, H, qs, ks, vs, scale_log2, st);
    case 64: return launch<64>(q, k, v, o, B, Sq, Sk, H, qs, ks, vs, scale_log2, st);
    case 80: return launch<80>(q, k, v, o, B, Sq, Sk, H, qs, ks, vs, scale_log2, st);
    case 160: return launch<160>(q, k, v, o, B, Sq, Sk, H, qs, ks, vs, scale_log2, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
