// Cross-attention forward for Hopper (sm_90a), bf16 in/out: the denoisers'
// text branch and, optionally, the IP-Adapter branch and their weighted sum
// in one pass.
//
// Replaces no pl.pallas_call: the JAX package leaves these shapes to XLA
// (theatergen_tpu/ops/attention.py::multi_head_attention through
// jax.nn.dot_product_attention, decoupled_attention's fused IP einsum),
// which fuses the chain on the TPU.  Eager PyTorch runs it as some two
// dozen kernels (casts, permuted fp32 copies, two fp32 bmms on the CUDA
// cores, a softmax, the IP branch again, the scale, the sum and a copy
// before to_out), about 86 bytes of traffic per element of q; this kernel
// reads q once and writes the output once.
//
// Computes, for q [B, Sq, H, D], k, v [B, Sk, H, D] and optionally
// k_ip, v_ip [B, Si, H, D] and a scale per batch row:
//   text = bf16(softmax(q·kᵀ · D^-0.5) · v)
//   ip   = bf16(softmax(q·k_ipᵀ · D^-0.5) · v_ip)
//   out  = bf16(text + bf16(scale[b] · ip))      (out = text without IP)
// with the plain version's arithmetic (ops/attention.py::
// decoupled_attention): fp32 logits, an fp32 softmax, P·V at fp32 grade
// (P split into two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), both
// on wgmma with fp32 accumulation) and the outputs rounded to bf16 where
// the plain version rounds them; a scale given as a CUDA tensor is rounded
// to bf16 first, as the plain version's product does.  So the two differ
// by summation order only.
//
// Bound on the H100: bytes.  With Sk <= 128 keys the 4·Sq·Sk·D operations
// per head are a few per byte of q, far below the card's ~295 flops per
// byte, so the least time is q read once and the output written once (K
// and V are a few hundred KB and stay in L2).
//
// Design.  A CTA takes one (batch, head) and a run of 128-row q tiles
// (``tiles_per_cta``, from the wrapper's plan).  The head's K and V (Sk
// keys padded to NK = 80 or 128 rows) and the IP keys (padded to 16) are
// brought into shared memory by TMA once and kept for the CTA's life; the
// q tiles stream through a ring of QST stages, each refilled by TMA as
// soon as both warpgroups' QKᵀ has read it, so the next tiles' loads run
// under this tile's softmax, P·V and stores.  Two warpgroups own 64 rows
// each: QKᵀ and Q·K_ipᵀ on wgmma from shared memory (Q and K in TMA's
// 128-byte swizzle, head dims past D arriving as zeros from past the
// tensor map's extent), the softmax over the whole row in fp32 registers
// (no online rescaling: every key is in one tile; keys past Sk and Si get
// no weight), P·V with P's hi and lo terms as register A operands and V
// MN-major from shared memory.  The text result is rounded to bf16 and
// held packed while the IP branch reuses the accumulators; the sum is
// stored once, straight from registers into the [B, Sq, H, D] output, so
// the reshape before to_out is a view.  The grid runs the heads fastest,
// so the CTAs in flight read neighbouring columns of the same q rows.

#include "common.cuh"

using namespace tg;

namespace {

constexpr int BQ = 128;  // q rows per tile (2 warpgroups x 64)
constexpr int THREADS = 256;
constexpr int NI = 16;   // IP keys per head, padded

template <int D, int NK>
struct Cfg {
  static constexpr int KSTEPS = (D + 15) / 16;  // depth-16 steps of QK^T
  static constexpr int NP = (D + 63) / 64;      // 64-column panels of a row
  static constexpr int QST = NP == 3 ? 2 : 3;   // q tiles in the ring
  static constexpr int Q_PANEL = BQ * 128, Q_BYTES = NP * Q_PANEL;
  static constexpr int K_PANEL = NK * 128, KV_BYTES = 2 * NP * K_PANEL;
  static constexpr int I_PANEL = NI * 128, IP_BYTES = 2 * NP * I_PANEL;
  // + 1 KB: the tiles' base is rounded up to the swizzle atom
  static constexpr int SMEM = 1024 + QST * Q_BYTES + KV_BYTES + IP_BYTES + (QST + 1) * 8;
  // two CTAs an SM where one's shared memory and 128 registers a thread allow
  static constexpr int MIN_BLOCKS = (D <= 64 && NK == 80) ? 2 : 1;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float lo_half(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_half(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

template <int N> struct Qk;
template <> struct Qk<16> {
  __device__ static void ss(float (&d)[8], uint64_t a, uint64_t b, int acc) { wgmma_m64n16k16_ss(d, a, b, acc); }
};
template <> struct Qk<80> {
  __device__ static void ss(float (&d)[40], uint64_t a, uint64_t b, int acc) { wgmma_m64n80k16_ss(d, a, b, acc); }
};
template <> struct Qk<128> {
  __device__ static void ss(float (&d)[64], uint64_t a, uint64_t b, int acc) { wgmma_m64n128k16_ss(d, a, b, acc); }
};

template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 40) wgmma_m64n40k16_rs<1>(o, a, b, 1);
  else if constexpr (D == 64) wgmma_m64n64k16_rs<1>(o, a, b, 1);
  else if constexpr (D == 80) wgmma_m64n80k16_rs<1>(o, a, b, 1);
  else wgmma_m64n160k16_rs<1>(o, a, b, 1);
}

// logits of 64 rows x N keys (accumulator layout) -> probabilities in
// place: keys >= n take no weight; the scaled base-2 exponent relative to
// each row's maximum, then 1 / the row's sum
template <int N>
__device__ __forceinline__ void softmax_rows(float (&s)[N / 2], int n, float scale_log2, int t) {
  if (n < N) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (i * 8 + 2 * t + (e & 1) >= n) s[4 * i + e] = -INFINITY;
  }
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    m0 = fmaxf(m0, fmaxf(s[4 * i], s[4 * i + 1]));
    m1 = fmaxf(m1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
  // n >= 1 keys, so both maxima are finite
  m0 *= scale_log2;
  m1 *= scale_log2;
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    s[4 * i] = ex2(fmaf(s[4 * i], scale_log2, -m0));
    s[4 * i + 1] = ex2(fmaf(s[4 * i + 1], scale_log2, -m0));
    s[4 * i + 2] = ex2(fmaf(s[4 * i + 2], scale_log2, -m1));
    s[4 * i + 3] = ex2(fmaf(s[4 * i + 3], scale_log2, -m1));
    l0 += s[4 * i] + s[4 * i + 1];
    l1 += s[4 * i + 2] + s[4 * i + 3];
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    s[4 * i] *= i0;
    s[4 * i + 1] *= i0;
    s[4 * i + 2] *= i1;
    s[4 * i + 3] *= i1;
  }
}

// the A fragment of P for keys 16kk.. (two bf16 terms: hi, and lo = the
// rest) from the probabilities in accumulator layout
template <int R>
__device__ __forceinline__ void p_fragment(const float (&p)[R], int kk, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float a = p[8 * kk + 2 * e], b = p[8 * kk + 2 * e + 1];
    hi[e] = pack_bf16(a, b);
    lo[e] = pack_bf16(a - lo_half(hi[e]), b - hi_half(hi[e]));
  }
}

// q tile j of head (b, h): NP panels of 128 rows x 64 columns into dst, its
// bytes counted on bar
template <int NP>
__device__ __forceinline__ void load_q(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                       int j, int h, int b) {
  mbar_expect_tx(bar, NP * BQ * 128);
  for (int p = 0; p < NP; ++p) tma_load_4d(dst + p * BQ * 128, map, bar, 64 * p, j * BQ, h, b);
}

template <int D, int NK>
__global__ void __launch_bounds__(THREADS, Cfg<D, NK>::MIN_BLOCKS)
cross_attention_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap ki_map,
                       const __grid_constant__ CUtensorMap vi_map,
                       bf16* __restrict__ o, int Sq, int Sk, int Si, int H,
                       int tiles_per_cta, float scale_log2,
                       const float* __restrict__ ip_scale, int ip_scale_stride,
                       float ip_scale_value, int round_scale) {
  using C = Cfg<D, NK>;
  constexpr int QST = C::QST, NP = C::NP;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const uint32_t q_s = smem_u32(smem);
  const uint32_t k_s = q_s + QST * C::Q_BYTES;
  const uint32_t v_s = k_s + NP * C::K_PANEL;
  const uint32_t ki_s = v_s + NP * C::K_PANEL;
  const uint32_t vi_s = ki_s + NP * C::I_PANEL;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + QST * C::Q_BYTES + C::KV_BYTES + C::IP_BYTES);
  uint64_t* kv_full = q_full + QST;

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.z;
  const int j0 = blockIdx.y * tiles_per_cta;
  const int j1 = min((Sq + BQ - 1) / BQ, j0 + tiles_per_cta);
  const bool ip = Si > 0;

  if (tid == 0) {
    for (int s = 0; s < QST; ++s) mbar_init(&q_full[s], 1);
    mbar_init(kv_full, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kv_full, C::KV_BYTES + (ip ? C::IP_BYTES : 0));
    for (int p = 0; p < NP; ++p) {
      tma_load_4d(k_s + p * C::K_PANEL, &k_map, kv_full, 64 * p, 0, h, b);
      tma_load_4d(v_s + p * C::K_PANEL, &v_map, kv_full, 64 * p, 0, h, b);
      if (ip) {
        tma_load_4d(ki_s + p * C::I_PANEL, &ki_map, kv_full, 64 * p, 0, h, b);
        tma_load_4d(vi_s + p * C::I_PANEL, &vi_map, kv_full, 64 * p, 0, h, b);
      }
    }
    for (int i = 0; i < QST && j0 + i < j1; ++i)
      load_q<NP>(q_s + i * C::Q_BYTES, &q_map, &q_full[i], j0 + i, h, b);
  }

  float sc = ip_scale != nullptr ? ip_scale[(long long)b * ip_scale_stride] : ip_scale_value;
  if (round_scale) sc = round_bf16(sc);

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int t = lane & 3;
  const long long row_stride = (long long)H * D;
  bf16* ob = o + (long long)b * Sq * row_stride + (long long)h * D;
  mbar_wait(kv_full, 0);

  for (int j = j0, i = 0; j < j1; ++j, ++i) {
    const int stage = i % QST;
    const uint32_t q_wg = q_s + stage * C::Q_BYTES + wg * 64 * 128;
    mbar_wait(&q_full[stage], (i / QST) & 1);

    float s[NK / 2], si[NI / 2];
    fence_regs(s);
    fence_regs(si);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk)
      Qk<NK>::ss(s, wgmma_desc_sw128(q_wg + (kk >> 2) * C::Q_PANEL + (kk & 3) * 32),
                 wgmma_desc_sw128(k_s + (kk >> 2) * C::K_PANEL + (kk & 3) * 32), kk > 0);
    if (ip) {
#pragma unroll
      for (int kk = 0; kk < C::KSTEPS; ++kk)
        Qk<NI>::ss(si, wgmma_desc_sw128(q_wg + (kk >> 2) * C::Q_PANEL + (kk & 3) * 32),
                   wgmma_desc_sw128(ki_s + (kk >> 2) * C::I_PANEL + (kk & 3) * 32), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(si);
    // both warpgroups have read this stage's q: refill it with a later tile
    __syncthreads();
    if (tid == 0 && j + QST < j1)
      load_q<NP>(q_s + stage * C::Q_BYTES, &q_map, &q_full[stage], j + QST, h, b);

    // text: softmax, then P·V as hi + lo
    softmax_rows<NK>(s, Sk, scale_log2, t);
    float acc[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      p_fragment(s, kk, hi, lo);
      const uint64_t vd = wgmma_desc_sw128(v_s + kk * 2048, C::K_PANEL);
      pv<D>(acc, hi, vd);
      pv<D>(acc, lo, vd);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    const int row = j * BQ + wg * 64 + warp * 16 + (lane >> 2);
    bf16* o0 = ob + row * row_stride;
    bf16* o1 = o0 + 8 * row_stride;
    if (!ip) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int c = n * 8 + 2 * t;
        if (row < Sq) st32(o0 + c, pack_bf16(acc[4 * n], acc[4 * n + 1]));
        if (row + 8 < Sq) st32(o1 + c, pack_bf16(acc[4 * n + 2], acc[4 * n + 3]));
      }
      continue;
    }

    // the text branch rounded to bf16, packed; the IP branch reuses acc
    uint32_t text[D / 4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      text[2 * n] = pack_bf16(acc[4 * n], acc[4 * n + 1]);
      text[2 * n + 1] = pack_bf16(acc[4 * n + 2], acc[4 * n + 3]);
    }
    softmax_rows<NI>(si, Si, scale_log2, t);
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
    fence_regs(acc);
    wgmma_fence();
    {
      uint32_t hi[4], lo[4];
      p_fragment(si, 0, hi, lo);
      const uint64_t vd = wgmma_desc_sw128(vi_s, C::I_PANEL);
      pv<D>(acc, hi, vd);
      pv<D>(acc, lo, vd);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    // out = bf16(text + bf16(scale · bf16(ip)))
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + 2 * t;
      float r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t tv = text[2 * n + (e >> 1)];
        const float tf = (e & 1) ? hi_half(tv) : lo_half(tv);
        r[e] = tf + round_bf16(sc * round_bf16(acc[4 * n + e]));
      }
      if (row < Sq) st32(o0 + c, pack_bf16(r[0], r[1]));
      if (row + 8 < Sq) st32(o1 + c, pack_bf16(r[2], r[3]));
    }
  }
}

// [D, S, H, B] view of one of q, k, v, k_ip, v_ip (strides in elements),
// boxes of 64 columns and `rows` rows
inline int encode(CUtensorMap* map, const void* base, int D, int S, int H,
                  int B, const long long* st, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[1] * 2, (cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  return encode_tensor_map(map, base, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D, int NK>
int launch(const void* q, const void* k, const void* v, const void* ki,
           const void* vi, void* o, int B, int Sq, int Sk, int Si, int H,
           const long long* qs, const long long* ks, const long long* vs,
           const long long* kis, const long long* vis, int tiles_per_cta,
           float scale_log2, const float* ip_scale, int ip_scale_stride,
           float ip_scale_value, int round_scale, cudaStream_t stream) {
  using C = Cfg<D, NK>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      cross_attention_kernel<D, NK>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  CUtensorMap q_map, k_map, v_map, ki_map, vi_map;
  int status = encode(&q_map, q, D, Sq, H, B, qs, BQ);
  if (status == 0) status = encode(&k_map, k, D, Sk, H, B, ks, NK);
  if (status == 0) status = encode(&v_map, v, D, Sk, H, B, vs, NK);
  if (status == 0 && Si > 0) status = encode(&ki_map, ki, D, Si, H, B, kis, NI);
  if (status == 0 && Si > 0) status = encode(&vi_map, vi, D, Si, H, B, vis, NI);
  if (status != 0) return status;
  if (Si == 0) ki_map = vi_map = k_map;  // never read
  const int ntiles = (Sq + BQ - 1) / BQ;
  dim3 grid(H, (ntiles + tiles_per_cta - 1) / tiles_per_cta, B);
  cross_attention_kernel<D, NK><<<grid, THREADS, C::SMEM, stream>>>(
      q_map, k_map, v_map, ki_map, vi_map, static_cast<bf16*>(o), Sq, Sk, Si, H,
      tiles_per_cta, scale_log2, ip_scale, ip_scale_stride, ip_scale_value, round_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(int NK, const void* q, const void* k, const void* v, const void* ki,
             const void* vi, void* o, int B, int Sq, int Sk, int Si, int H,
             const long long* qs, const long long* ks, const long long* vs,
             const long long* kis, const long long* vis, int tiles_per_cta,
             float scale_log2, const float* ip_scale, int ip_scale_stride,
             float ip_scale_value, int round_scale, cudaStream_t stream) {
  if (NK == 80)
    return launch<D, 80>(q, k, v, ki, vi, o, B, Sq, Sk, Si, H, qs, ks, vs, kis, vis,
                         tiles_per_cta, scale_log2, ip_scale, ip_scale_stride,
                         ip_scale_value, round_scale, stream);
  if (NK == 128)
    return launch<D, 128>(q, k, v, ki, vi, o, B, Sq, Sk, Si, H, qs, ks, vs, kis, vis,
                          tiles_per_cta, scale_log2, ip_scale, ip_scale_stride,
                          ip_scale_value, round_scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q: bf16 [B, Sq, H, D]; k, v: bf16 [B, Sk, H, D], 1 <= Sk <= 128; k_ip,
// v_ip: bf16 [B, Si, H, D], 1 <= Si <= 16, or Si = 0 and no IP branch; each
// with unit stride on D and the given batch, sequence and head strides
// (elements, multiples of 8, 16-byte aligned base); o: contiguous bf16
// [B, Sq, H, D].  NK (80 or 128) is the padded key count, at least Sk; D
// one of 40, 64, 80, 160 (ops/attention.py::CROSS_HEAD_DIMS).  The IP
// scale of batch row b is ip_scale[b * ip_scale_stride] (a device fp32
// array; stride 0 for one scale) or, where ip_scale is null,
// ip_scale_value; rounded to bf16 first where round_scale is set.
// Returns cudaGetLastError(), or the CUresult of a tensor map that failed
// to encode.
extern "C" int tg_cross_attention_fwd(
    const void* q, const void* k, const void* v, const void* k_ip,
    const void* v_ip, void* o, int B, int Sq, int Sk, int Si, int H, int D,
    int NK, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long ki_sb, long long ki_ss, long long ki_sh,
    long long vi_sb, long long vi_ss, long long vi_sh, int tiles_per_cta,
    float scale_log2, const float* ip_scale, int ip_scale_stride,
    float ip_scale_value, int round_scale, void* stream) {
  const long long qs[3] = {q_sb, q_ss, q_sh}, ks[3] = {k_sb, k_ss, k_sh};
  const long long vs[3] = {v_sb, v_ss, v_sh}, kis[3] = {ki_sb, ki_ss, ki_sh};
  const long long vis[3] = {vi_sb, vi_ss, vi_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Sk < 1 || Sk > NK || Si < 0 || Si > NI || tiles_per_cta < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
#define TG_CROSS_CASE(DD)                                                                 \
  case DD:                                                                                \
    return launch_d<DD>(NK, q, k, v, k_ip, v_ip, o, B, Sq, Sk, Si, H, qs, ks, vs, kis, vis, \
                        tiles_per_cta, scale_log2, ip_scale, ip_scale_stride,             \
                        ip_scale_value, round_scale, st);
    TG_CROSS_CASE(40)
    TG_CROSS_CASE(64)
    TG_CROSS_CASE(80)
    TG_CROSS_CASE(160)
#undef TG_CROSS_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
