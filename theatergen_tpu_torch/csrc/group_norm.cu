// GroupNorm (+ SiLU) for Hopper (sm_90a), bf16 NCHW in and out:
//   out = act((x - mean_g) * (rsqrt(var_g + eps) * scale[c]) + bias[c])
// with the group statistics, the affine and the SiLU in fp32 and one
// rounding to bf16 at the end.  var_g is the centred variance
// E[(x - mean_g)^2]: the E[x^2] - mean^2 form cancels when |mean| >> std.
//
// Replaces theatergen_tpu/ops/groupnorm.py:140 (_gn_fused, its _kernel),
// the TPU kernel that keeps one batch item in VMEM and does stats,
// normalisation and activation in one pass.  Its one-hot [C, G] matmuls
// (group sums on the MXU for a channel-last layout) have no counterpart
// here: in NCHW each (batch, group) slice is one contiguous run of
// cpg·H·W elements.
//
// Bound on the H100: bytes.  x is read once and the output written once,
// 4·B·C·H·W bytes at 3.35 TB/s (SD1.5's 61 norms of one CFG evaluation:
// 0.108 ms).  Design: one thread-block cluster of C CTAs (1, 2, 4 or 8)
// per slice, launched with cudaLaunchKernelEx; ops/groupnorm.py::gn_plan
// picks C, the width and the route per shape (fitted to an on-card sweep,
// scripts/torch_gn_sweep.py).  CTA r owns `share` whole 16-byte pieces of
// the slice (the last CTA may own fewer) and reads them once: into
// registers (at most 8 pieces a thread, all loads in flight at once) or,
// for a larger share, into shared memory by 1-D bulk copies in four
// chunks, each completing on its own mbarrier.  Each thread takes the
// count, mean and centred M2 of its own pieces (two passes, chunk by chunk
// as the chunks land, merged by Chan's formula), and two block sums give
// the CTA's: the counts-weighted mean, then M2 = sum M2_t + n_t (mean_t -
// mean)^2.  With C > 1 each CTA pushes its triple into every peer's shared
// memory (st.async, completing on the peer's mbarrier) and all combine
// the C triples in rank order, so every CTA of a slice normalises with the
// same mean and inverse, bit for bit; no CTA leaves before its peers'
// pushes have landed, and nothing reads a peer afterwards.  Then each
// normalises its share and writes it once, 16 bytes a thread, with the
// scale and bias of its channels loaded once and staged in shared memory.
// Measured and dropped (PERF.md §6): bulk stores of the output from shared
// memory, a cluster barrier and remote reads for the exchange, and
// programmatic dependent launch.  H·W must be a multiple of 8, so no piece
// straddles two channels and every share starts 16-byte aligned.

#include <type_traits>

#include "common.cuh"

using namespace tg;

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_CHUNKS = 4;
constexpr int MAX_CLUSTER = 8;
constexpr int MAX_REG_PIECES = 8;  // pieces a thread keeps in registers
constexpr int VEC = 8;             // bf16 values in one 16-byte piece

// Sum of v over the block, the same value bit for bit in every thread: an
// xor butterfly in each warp, one barrier, then every warp runs the same
// butterfly over the warps' sums.  Consecutive calls alternate between
// the two rows of red: a warp writes a row again only after the barrier
// of the call between, which every warp reaches after its reads.
__device__ __forceinline__ float block_sum(float v, float (*red)[MAX_WARPS], int& call) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* row = red[call++ & 1];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) row[warp] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x >> 5) ? row[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

// 16 read-only bytes, not kept in L1, each L2 miss fetching 256 bytes
__device__ __forceinline__ uint4 ldg_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// the eight values' sum, and their centred sum of squares, as trees
__device__ __forceinline__ float sum8(const uint4& v) {
  float f[VEC];
  unpack8(v, f);
  return ((f[0] + f[1]) + (f[2] + f[3])) + ((f[4] + f[5]) + (f[6] + f[7]));
}
__device__ __forceinline__ float sq8(const uint4& v, float mean) {
  float f[VEC];
  unpack8(v, f);
#pragma unroll
  for (int j = 0; j < VEC; ++j) f[j] = (f[j] - mean) * (f[j] - mean);
  return ((f[0] + f[1]) + (f[2] + f[3])) + ((f[4] + f[5]) + (f[6] + f[7]));
}

// (x - mean)·a + b, then SiLU where asked.  The SiLU's quotient is the
// fast one (a reciprocal and a multiply, 2 ulp): the IEEE division is a
// branching subroutine that serialises each thread's values.
template <bool SILU>
__device__ __forceinline__ float affine(float x, float mean, float a, float b) {
  const float y = (x - mean) * a + b;
  return SILU ? __fdividef(y, 1.f + __expf(-y)) : y;
}

template <bool SILU>
__device__ __forceinline__ uint4 normalise8(const uint4& v, float mean, float a, float b) {
  float f[VEC];
  unpack8(v, f);
  uint4 o;
  o.x = pack_bf16(affine<SILU>(f[0], mean, a, b), affine<SILU>(f[1], mean, a, b));
  o.y = pack_bf16(affine<SILU>(f[2], mean, a, b), affine<SILU>(f[3], mean, a, b));
  o.z = pack_bf16(affine<SILU>(f[4], mean, a, b), affine<SILU>(f[5], mean, a, b));
  o.w = pack_bf16(affine<SILU>(f[6], mean, a, b), affine<SILU>(f[7], mean, a, b));
  return o;
}

// Chan's combine of `count` (n, mean, M2) triples, in order: the mean
// weighted by counts, M2 = sum M2_i + sum n_i (mean_i - mean)^2
template <int MAX>
__device__ __forceinline__ float4 chan(const float4* t, int count) {
  float n = 0.f, acc = 0.f;
#pragma unroll
  for (int i = 0; i < MAX; ++i)
    if (i < count) {
      n += t[i].x;
      acc += t[i].x * t[i].y;
    }
  const float mean = acc / n;
  float m2 = 0.f;
#pragma unroll
  for (int i = 0; i < MAX; ++i)
    if (i < count) {
      const float d = t[i].y - mean;
      m2 += t[i].z + t[i].x * d * d;
    }
  return make_float4(n, mean, m2, 0.f);
}

// Channels a run of `share` pieces can touch, for the staged scale and
// bias (ops/groupnorm.py::gn_smem counts the same).
__host__ __device__ __forceinline__ int share_channels(int share, int vpc, int cpg) {
  const int n = (share - 1) / vpc + 2;
  return n < cpg ? n : cpg;
}

// V = 0: the share goes to shared memory by bulk copies, in up to
// MAX_CHUNKS chunks; V > 0: each thread keeps its (at most V) pieces,
// tid + j·threads, in registers
template <bool SILU, int V>
__global__ void __launch_bounds__(MAX_THREADS)
group_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ scale,
                  const bf16* __restrict__ bias, bf16* __restrict__ out,
                  int groups, int cpg, int hw, int share, int chunks, float eps) {
  extern __shared__ __align__(128) uint4 data[];
  __shared__ __align__(8) uint64_t full[MAX_CHUNKS];
  __shared__ __align__(8) uint64_t stats_in;  // the peers' triples arrived
  __shared__ float red[2][MAX_WARPS];
  __shared__ float4 slot[MAX_CLUSTER];        // the cluster's triples, by rank

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int ncta = static_cast<int>(cluster_nctarank());
  const int rank = static_cast<int>(cluster_ctarank());
  const int slice = blockIdx.x / ncta;  // b·G + g
  const int vpc = hw / VEC, pieces = cpg * vpc;
  const int p0 = rank * share;                 // first piece of the share
  const int np = min(share, pieces - p0);      // pieces in the share
  const int ch0 = p0 / vpc;                    // its first channel in the group
  const int nch = (p0 + np - 1) / vpc - ch0 + 1;
  const int c0 = (slice % groups) * cpg + ch0;
  // slice s starts at s·cpg·H·W elements: s·pieces pieces
  const uint4* xv = reinterpret_cast<const uint4*>(x) + (long long)slice * pieces + p0;
  uint4* ov = reinterpret_cast<uint4*>(out) + (long long)slice * pieces + p0;
  // (scale, bias) by channel, after the pieces in shared memory
  float2* par = reinterpret_cast<float2*>(V > 0 ? data : data + share);
  const int nchunk = V > 0 ? 1 : min(chunks, np);
  const int cpc = (np + nchunk - 1) / nchunk;  // pieces per chunk, the last may be shorter
  int call = 0;

  if (tid == 0 && (V == 0 || ncta > 1)) {
    if (V == 0)
      for (int k = 0; k < nchunk; ++k) mbar_init(&full[k], 1);
    if (ncta > 1) {
      mbar_init(&stats_in, 1);
      mbar_expect_tx(&stats_in, 16u * (ncta - 1));
    }
    mbar_fence_init();
  }
  if (ncta > 1) cluster_arrive_relaxed();  // this CTA's stats_in exists
  if (V == 0 && tid == 0)
    for (int k = 0; k < nchunk; ++k) {
      const uint32_t bytes = 16u * min(cpc, np - k * cpc);
      mbar_expect_tx(&full[k], bytes);
      bulk_load(data + k * cpc, xv + k * cpc, bytes, &full[k]);
    }
  uint4 reg[V > 0 ? V : 1];
  if (V > 0) {
#pragma unroll
    for (int j = 0; j < (V > 0 ? V : 1); ++j)
      if (tid + j * nthr < np) reg[j] = ldg_stream(xv + tid + j * nthr);
  }
  // this thread's first channel's scale and bias, loaded now and staged
  // once the data is in
  const bool has_par = tid < nch;
  bf16 sc0, bi0;
  if (has_par) {
    sc0 = scale[c0 + tid];
    bi0 = bias[c0 + tid];
  }
  if (V == 0) __syncthreads();             // the chunks' mbarriers exist

  // Each thread's count, mean and centred M2 over its pieces: per chunk
  // as it lands (its sum, then the squares about that mean, both
  // thread-local, so no chunk waits on a barrier), merged in chunk order
  // (Chan).  Then the CTA's: the counts-weighted mean (one block sum) and
  // M2 = sum M2_t + n_t (mean_t - mean)^2 (another).
  float n_t = 0.f, mean_t = 0.f, m2_t = 0.f;
  auto merge = [&](int count, float s, float m) {
    const float nb = static_cast<float>(count * VEC), n = n_t + nb;
    const float d = s / nb - mean_t;
    mean_t += d * (nb / n);
    m2_t += m + d * d * (n_t * nb / n);
    n_t = n;
  };
  if (V > 0) {
    float s = 0.f, m = 0.f;
    int count = 0;
#pragma unroll
    for (int j = 0; j < (V > 0 ? V : 1); ++j)
      if (tid + j * nthr < np) {
        s += sum8(reg[j]);
        ++count;
      }
    if (count > 0) {
      const float mean_k = s / static_cast<float>(count * VEC);
#pragma unroll
      for (int j = 0; j < (V > 0 ? V : 1); ++j)
        if (tid + j * nthr < np) m += sq8(reg[j], mean_k);
      merge(count, s, m);
    }
  } else {
    for (int k = 0; k < nchunk; ++k) {
      const int end = min(np, (k + 1) * cpc);
      mbar_wait(&full[k], 0);
      float s = 0.f, m = 0.f;
      int count = 0;
#pragma unroll 4
      for (int i = k * cpc + tid; i < end; i += nthr) {
        s += sum8(data[i]);
        ++count;
      }
      if (count == 0) continue;
      const float mean_k = s / static_cast<float>(count * VEC);
#pragma unroll 4
      for (int i = k * cpc + tid; i < end; i += nthr) m += sq8(data[i], mean_k);
      merge(count, s, m);
    }
  }
  // the last barriers before the normalisation publish scale and bias
  if (has_par) par[tid] = make_float2(__bfloat162float(sc0), __bfloat162float(bi0));
  for (int j = tid + nthr; j < nch; j += nthr)
    par[j] = make_float2(__bfloat162float(scale[c0 + j]), __bfloat162float(bias[c0 + j]));
  const float n_loc = static_cast<float>(np * VEC);
  const float mean_loc = block_sum(n_t * mean_t, red, call) / n_loc;
  const float d_t = mean_t - mean_loc;
  float4 st = make_float4(n_loc, mean_loc, block_sum(m2_t + n_t * d_t * d_t, red, call), 0.f);

  if (ncta > 1) {
    // push this CTA's triple into slot[rank] of every peer (each push
    // completes 16 bytes on that peer's stats_in), then combine all C in
    // rank order: every CTA gets the same mean and M2.  No CTA leaves
    // before its peers' pushes have landed, and none is read afterwards.
    cluster_wait();  // every peer's stats_in exists
    if (tid < ncta && tid != rank)
      st_async128(&slot[rank], make_uint4(__float_as_uint(st.x), __float_as_uint(st.y),
                                          __float_as_uint(st.z), 0u),
                  &stats_in, tid);
    mbar_wait_cluster(&stats_in, 0);
    float4 t[MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < ncta) t[r] = r == rank ? st : slot[r];
    st = chan<MAX_CLUSTER>(t, ncta);
  }
  const float mean = st.y, inv = rsqrtf(st.z / st.x + eps);

  // the channel of piece i, (p0 + i) / vpc, kept as a quotient and a
  // remainder that step by the CTA's width
  int q = (p0 + tid) / vpc - ch0, rem = (p0 + tid) % vpc;
  const int step_q = nthr / vpc, step_r = nthr % vpc;
  auto next = [&] {
    q += step_q;
    rem += step_r;
    if (rem >= vpc) {
      rem -= vpc;
      ++q;
    }
  };
  if (V > 0) {
#pragma unroll
    for (int j = 0; j < (V > 0 ? V : 1); ++j) {
      if (tid + j * nthr < np) {
        const float2 sb = par[q];
        ov[tid + j * nthr] = normalise8<SILU>(reg[j], mean, inv * sb.x, sb.y);
      }
      next();
    }
  } else {
#pragma unroll 2
    for (int i = tid; i < np; i += nthr) {
      const float2 sb = par[q];
      ov[i] = normalise8<SILU>(data[i], mean, inv * sb.x, sb.y);
      next();
    }
  }
}

template <bool SILU, int V>
cudaError_t configure() {
  static cudaError_t status = [] {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaFuncAttributes attr;
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, group_norm_kernel<SILU, V>);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(group_norm_kernel<SILU, V>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - static_cast<int>(attr.sharedSizeBytes));
    return e;
  }();
  return status;
}

template <bool SILU, int V>
int launch(const void* x, const void* scale, const void* bias, void* out, int B,
           int groups, int cpg, int hw, float eps, int cluster, int threads,
           int share, int chunks, int smem, cudaStream_t stream) {
  const cudaError_t err = configure<SILU, V>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * groups * cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, group_norm_kernel<SILU, V>, static_cast<const bf16*>(x),
      static_cast<const bf16*>(scale), static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), groups, cpg, hw, share, chunks, eps);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: bf16 [B, C, H, W] contiguous, 16-byte aligned; scale, bias: bf16
// [C].  C must be a multiple of groups and hw = H·W a multiple of 8.
// silu != 0 applies SiLU after the affine.  The launch, as
// ops/groupnorm.py::gn_plan gives it: a cluster of `cluster` CTAs (1, 2, 4
// or 8) per (batch, group) slice of P = C/groups·hw/8 pieces, `threads`
// (a multiple of 32 up to 512) per CTA, `share` pieces per CTA with
// cluster·share >= P and every CTA owning at least one, loaded into shared
// memory in `chunks` (1 to 4) bulk copies, or with chunks = 0 into
// registers (at most 8 pieces a thread), and `smem` bytes of dynamic
// shared memory (16·share unless chunks = 0, plus 8 per channel a share
// can touch).  Returns cudaGetLastError(), the launch's error, or
// cudaErrorInvalidValue for a plan the kernel cannot take.
extern "C" int tg_group_norm_fwd(const void* x, const void* scale,
                                 const void* bias, void* out, int B, int C,
                                 int hw, int groups, float eps, int silu,
                                 int cluster, int threads, int share, int chunks,
                                 int smem, void* stream) {
  if (B < 0 || C <= 0 || hw <= 0 || groups <= 0 || C % groups != 0 ||
      hw % VEC != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cpg = C / groups, vpc = hw / VEC;
  const long long pieces = (long long)cpg * vpc;
  if (pieces > (1LL << 30) || (long long)B * groups * cluster > (1LL << 31) - 1 ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      threads < 32 || threads > MAX_THREADS || threads % 32 != 0 || share < 1 ||
      chunks < 0 || chunks > MAX_CHUNKS || (long long)cluster * share < pieces ||
      (long long)(cluster - 1) * share >= pieces ||
      (chunks == 0 && (long long)threads * MAX_REG_PIECES < share) ||
      smem < (chunks ? 16LL * share : 0) + 8LL * share_channels(share, vpc, cpg))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_thread = (share + threads - 1) / threads;
  auto by_route = [&](auto silu_c) {
    auto go = [&](auto v_c) {
      return launch<decltype(silu_c)::value, decltype(v_c)::value>(
          x, scale, bias, out, B, groups, cpg, hw, eps, cluster, threads, share, chunks,
          smem, st);
    };
    if (chunks > 0) return go(std::integral_constant<int, 0>());
    if (per_thread <= 1) return go(std::integral_constant<int, 1>());
    if (per_thread <= 2) return go(std::integral_constant<int, 2>());
    if (per_thread <= 4) return go(std::integral_constant<int, 4>());
    return go(std::integral_constant<int, 8>());
  };
  return silu ? by_route(std::true_type()) : by_route(std::false_type());
}
