// decode_attention: one query token of GQA attention over a static KV cache,
// as a split-cache flash-decode.
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py::
// decode_attention (body _kernel).  For batch b and query head h,
//
//     out[b, 0, h] = softmax_t(q[b, 0, h] . k[b, t, h / g] / sqrt(D)) v[b, t, h / g]
//
// over t < S, with scores of positions t >= lengths[b] set to -1e30 (so a
// length <= 0 averages V over the whole cache, as the plain softmax does,
// and a length > S reads the whole cache).
//
// Bound: the bytes of the valid cache rows, each read once.  Decode
// attention does about one operation per byte, far below the card's ridge
// point, so the design is about bytes and CTAs in flight, not tensor cores:
//
//   * grid (splits, Hk, B): one CTA takes one contiguous range of cache
//     positions of one (batch, KV head) together with that head's g <= 16
//     query heads, so each cache row is read once for the group.  The
//     wrapper picks the split count so that B * Hk * splits fills the card
//     (a few CTAs an SM, at least 64 positions a split; the last split takes
//     the remainder).  Splits wholly past min(lengths[b], S) return at once
//     without reading the cache.
//   * 16-byte loads: a cache row of D values is read by D * sizeof(T) / 16
//     neighbouring threads (16 for bf16 D = 128, a warp reads two whole
//     rows a load), four rows a thread issued before any is used.  K and V
//     loads of a chunk go out together.  Where that count is not a power of
//     two (D = 80), a row takes the next power of two of threads and the
//     rest idle through the loads (Shape below).
//   * Scores: each thread dots its 16 bytes of a K row with the same slice
//     of the g query rows (float32, shared memory) and the row's threads
//     reduce the g partial sums with __shfl_xor_sync, halving the heads a
//     lane keeps at each step (reduce_heads: 8 shuffles for 8 heads over
//     16 lanes, not 32): shared-memory and shuffle issue, not bytes, bound
//     the score phase.  Softmax state (m, l) per head is updated once a
//     chunk (online softmax within the split).  P.V accumulates float32
//     acc[g][slice] per thread, reduced over the row groups in a fixed
//     order at the end.  Compute is float32 on the CUDA cores for every
//     dtype pair.
//   * Each split writes (m, l, acc[g][D]) to a float32 scratch; a second
//     small launch (decode_fwd_combine, one CTA per (batch, query head), a
//     thread per output column) merges the splits in split order and
//     writes out in q's type.  Every sum runs in a fixed order, so results
//     are bit-identical run to run.  With one split the first launch
//     writes out directly.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;   // cache rows a thread loads a chunk
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The 16 bytes of a uint4 as float32 values.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* f);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& raw, float* f) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& raw,
                                                      float* f) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Sums N per-lane values (one a head) over the TPR lanes of a row group by
// recursive halving: at each lane bit while more than one value is left,
// the lane keeps half of the heads and adds its partner's share of them
// (one shuffle a kept value); then plain butterflies.  N = 8, TPR = 16
// takes 4 + 2 + 1 + 1 shuffles instead of 8 x 4.  Afterwards v[0 .. N /
// TPR) hold the full sums of heads head0 .. ; returns head0 on the lane
// that writes them and -1 on the lanes that hold copies.
template <int TPR, int N>
__device__ __forceinline__ int reduce_heads(float (&v)[N], int lane_in_row) {
  int head0 = 0;
  int copies = 0;
  int cnt = N;
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) {
    if (cnt > 1) {
      const int half = cnt >> 1;
      const bool upper = (lane_in_row & off) != 0;
#pragma unroll
      for (int j = 0; j < N / 2; ++j) {
        if (j < half) {
          const float send = upper ? v[j] : v[j + half];
          const float keep = upper ? v[j + half] : v[j];
          v[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
        }
      }
      if (upper) head0 += half;
      cnt = half;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
      copies |= off;
    }
  }
  return (lane_in_row & copies) ? -1 : head0;
}

constexpr int pow2_ceil(int n) { return n <= 1 ? 1 : 2 * pow2_ceil((n + 1) / 2); }

// A cache row of D values is kLive 16-byte slices, read by the first kLive
// of kTpr = pow2_ceil(kLive) neighbouring threads: row groups must be a
// power of two wide for the shuffles.  For D = 32, 64 and 128 the two are
// equal; for D = 80 (10 slices in bf16, 20 in float32) the last 6 / 12
// threads of a row group load nothing, add zeros to the score sums and
// keep no output columns (a masked tail).
template <typename TC, int D>
struct Shape {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(TC));
  static constexpr int kLive = D / kVec;           // 16-byte slices a row
  static constexpr int kTpr = pow2_ceil(kLive);    // threads a cache row
  static constexpr int kGroups = kThreads / kTpr;  // rows in flight a load
  static constexpr int kChunk = kGroups * kRowsPerThread;
  static_assert(kLive * kVec == D && kTpr <= 32, "unsupported head dim");
};

// Split `blockIdx.x` of (batch blockIdx.z, KV head blockIdx.y).  With one
// split, writes out[b, 0, h0 : h0 + g] directly; otherwise writes the
// split's unnormalised acc[g][D] and (m, l)[g] to part / part_ml.
template <typename TQ, typename TC, int D, int GMAX>
__global__ void __launch_bounds__(kThreads) decode_fwd_split(
    const TQ* __restrict__ q, long long qsb, long long qsh,
    const TC* __restrict__ k, long long ksb, long long kss, long long ksh,
    const TC* __restrict__ v, long long vsb, long long vss, long long vsh,
    const int* __restrict__ lengths, TQ* __restrict__ out,
    float* __restrict__ part, float* __restrict__ part_ml, int S, int H,
    int Hk, int n_splits, int split_len, float scale) {
  using Sh = Shape<TC, D>;
  constexpr int VEC = Sh::kVec, TPR = Sh::kTpr, RG = Sh::kGroups,
                C = Sh::kChunk, LIVE = Sh::kLive;
  __shared__ __align__(16) float qs[GMAX * D];
  __shared__ float sc[GMAX * C];
  __shared__ __align__(16) float red[kWarps * GMAX * D];
  __shared__ float m_s[GMAX], l_s[GMAX], corr_s[GMAX];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rg = tid / TPR;        // row group
  const int cq = tid - rg * TPR;   // 16-byte slice of the row
  const bool live = LIVE == TPR || cq < LIVE;   // false in a masked tail
  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int g = H / Hk;
  const int h0 = hk * g;
  const TQ* qb = q + b * qsb + h0 * qsh;
  for (int idx = tid; idx < g * D; idx += kThreads) {   // in flight with
    const int hh = idx / D;                             // the length's load
    qs[idx] = to_f(qb[hh * qsh + (idx - hh * D)]);
  }
  const int len = lengths[b];
  const int end = len > 0 ? min(len, S) : S;
  const int t_begin = split * split_len;
  const int t_end =
      min(split == n_splits - 1 ? S : t_begin + split_len, end);
  const long long slot =
      (static_cast<long long>(b * Hk + hk) * n_splits + split) * g;

  if (t_begin >= t_end) {   // past the sequence: contributes nothing
    if (n_splits == 1) {
      for (int idx = tid; idx < g * D; idx += kThreads)
        out[(static_cast<long long>(b) * H + h0) * D + idx] = from_f<TQ>(0.f);
    } else if (tid < g) {
      part_ml[(slot + tid) * 2] = kNegInf;
      part_ml[(slot + tid) * 2 + 1] = 0.f;
    }
    return;
  }

  const TC* kb = k + b * ksb + hk * ksh + (live ? cq : 0) * VEC;
  const TC* vb = v + b * vsb + hk * vsh + (live ? cq : 0) * VEC;
  if (tid < GMAX) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[GMAX][VEC];
#pragma unroll
  for (int hh = 0; hh < GMAX; ++hh)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[hh][e] = 0.f;
  __syncthreads();

  for (int c0 = t_begin; c0 < t_end; c0 += C) {
    const int n = min(C, t_end - c0);
    uint4 kr[kRowsPerThread], vr[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = rg + RG * i;
      const int t = c0 + r;
      vr[i] = make_uint4(0u, 0u, 0u, 0u);
      kr[i] = make_uint4(0u, 0u, 0u, 0u);
      if (live && r < n && t < len)
        kr[i] = __ldg(reinterpret_cast<const uint4*>(kb + t * kss));
      if (live && r < n)
        vr[i] = __ldg(reinterpret_cast<const uint4*>(vb + t * vss));
    }
    // scores of this chunk: sc[hh][r]
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = rg + RG * i;
      float kf[VEC];
      unpack<TC>(kr[i], kf);
      float sh[GMAX];
#pragma unroll
      for (int hh = 0; hh < GMAX; ++hh) {
        sh[hh] = 0.f;
        if (live && hh < g) {
          const float4* qr =
              reinterpret_cast<const float4*>(qs + hh * D + cq * VEC);
#pragma unroll
          for (int e4 = 0; e4 < VEC / 4; ++e4) {
            const float4 qv = qr[e4];
            sh[hh] = fmaf(qv.x, kf[4 * e4], sh[hh]);
            sh[hh] = fmaf(qv.y, kf[4 * e4 + 1], sh[hh]);
            sh[hh] = fmaf(qv.z, kf[4 * e4 + 2], sh[hh]);
            sh[hh] = fmaf(qv.w, kf[4 * e4 + 3], sh[hh]);
          }
        }
      }
      const int head0 = reduce_heads<TPR, GMAX>(sh, cq);
      constexpr int kHeld = GMAX > TPR ? GMAX / TPR : 1;
      if (head0 >= 0 && r < n) {
        const bool valid = c0 + r < len;
#pragma unroll
        for (int j = 0; j < kHeld; ++j)
          if (head0 + j < g)
            sc[(head0 + j) * C + r] = valid ? sh[j] * scale : kNegInf;
      }
    }
    __syncthreads();
    // online softmax over the chunk, warp w for heads w, w + kWarps, ...
    for (int hh = warp; hh < g; hh += kWarps) {
      float* row = sc + hh * C;
      const float m_old = m_s[hh];
      float mx = kNegInf;
      for (int i = lane; i < n; i += 32) mx = fmaxf(mx, row[i]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int i = lane; i < n; i += 32) {
        const float p = expf(row[i] - m_new);
        row[i] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {   // every lane has read m_old: the shuffles wait
        const float corr = expf(m_old - m_new);
        corr_s[hh] = corr;
        l_s[hh] = l_s[hh] * corr + sum;
        m_s[hh] = m_new;
      }
    }
    __syncthreads();
    // P.V on this thread's slice of its rows
#pragma unroll
    for (int hh = 0; hh < GMAX; ++hh) {
      if (hh >= g) break;
      const float corr = corr_s[hh];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[hh][e] *= corr;
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = rg + RG * i;
      if (r >= n) break;
      float vf[VEC];
      unpack<TC>(vr[i], vf);
#pragma unroll
      for (int hh = 0; hh < GMAX; ++hh) {
        if (hh >= g) break;
        const float p = sc[hh * C + r];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[hh][e] = fmaf(p, vf[e], acc[hh][e]);
      }
    }
    __syncthreads();   // sc and corr_s are rewritten by the next chunk
  }

  // reduce acc over the row groups: within a warp by shuffles, then over
  // the warps through shared memory, in a fixed order
#pragma unroll
  for (int hh = 0; hh < GMAX; ++hh) {
    if (hh >= g) break;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float a = acc[hh][e];
#pragma unroll
      for (int off = TPR; off < 32; off <<= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      if (lane < TPR && live) red[(warp * GMAX + hh) * D + cq * VEC + e] = a;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < g * D; idx += kThreads) {
    const int hh = idx / D;
    const int d = idx - hh * D;
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += red[(w * GMAX + hh) * D + d];
    if (n_splits == 1)
      out[(static_cast<long long>(b) * H + h0) * D + idx] =
          from_f<TQ>(total / l_s[hh]);
    else
      part[slot * D + idx] = total;
  }
  if (n_splits > 1 && tid < g) {
    part_ml[(slot + tid) * 2] = m_s[tid];
    part_ml[(slot + tid) * 2 + 1] = l_s[tid];
  }
}

// Merges the splits of query head blockIdx.x of batch blockIdx.y, one
// thread per output column, in split order.  Splits past the sequence
// (l = 0) form a suffix and are not read.
template <typename TQ>
__global__ void __launch_bounds__(128) decode_fwd_combine(
    const float* __restrict__ part, const float* __restrict__ part_ml,
    TQ* __restrict__ out, int H, int Hk, int D, int n_splits) {
  extern __shared__ float comb_smem[];   // weights [n_splits], then l
  float* w = comb_smem;
  float* ls = comb_smem + n_splits;
  __shared__ float m_max_s;
  __shared__ int n_valid_s;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = H / Hk;
  const int hk = h / g;
  // (split sp, head h) sits at slot0 + sp * g
  const long long slot0 =
      static_cast<long long>(b * Hk + hk) * n_splits * g + (h - hk * g);
  for (int sp = threadIdx.x; sp < n_splits; sp += blockDim.x) {
    w[sp] = part_ml[(slot0 + sp * g) * 2];
    ls[sp] = part_ml[(slot0 + sp * g) * 2 + 1];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n_valid = 0;
    float m_max = kNegInf;
    while (n_valid < n_splits && ls[n_valid] > 0.f)
      m_max = fmaxf(m_max, w[n_valid++]);
    m_max_s = m_max;
    n_valid_s = n_valid;
  }
  __syncthreads();
  const int n_valid = n_valid_s;
  for (int sp = threadIdx.x; sp < n_valid; sp += blockDim.x)
    w[sp] = expf(w[sp] - m_max_s);
  __syncthreads();
  float total_l = 0.f;
  for (int sp = 0; sp < n_valid; ++sp) total_l += w[sp] * ls[sp];
  const float inv_l = 1.f / total_l;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float* src = part + slot0 * D + d;
    float total = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < n_valid; ++sp)
      total = fmaf(w[sp], src[static_cast<long long>(sp) * g * D], total);
    out[(static_cast<long long>(b) * H + h) * D + d] = from_f<TQ>(total * inv_l);
  }
}

struct Strides {
  long long b, s, h;
};

struct Args {
  const void* q;
  Strides qs;
  const void* k;
  Strides ks;
  const void* v;
  Strides vs;
  const void* lengths;
  void* out;
  float* part;
  int B, S, H, Hk, n_splits, split_len;
};

template <typename TQ, typename TC, int D, int GMAX>
int launch(const Args& a, cudaStream_t stream) {
  float* part_ml = a.n_splits > 1 ? a.part + static_cast<long long>(a.B) *
                                                a.Hk * a.n_splits *
                                                (a.H / a.Hk) * D
                                    : nullptr;
  const dim3 grid(a.n_splits, a.Hk, a.B);
  decode_fwd_split<TQ, TC, D, GMAX><<<grid, kThreads, 0, stream>>>(
      static_cast<const TQ*>(a.q), a.qs.b, a.qs.h,
      static_cast<const TC*>(a.k), a.ks.b, a.ks.s, a.ks.h,
      static_cast<const TC*>(a.v), a.vs.b, a.vs.s, a.vs.h,
      static_cast<const int*>(a.lengths), static_cast<TQ*>(a.out), a.part,
      part_ml, a.S, a.H, a.Hk, a.n_splits, a.split_len,
      1.f / sqrtf(static_cast<float>(D)));
  if (a.n_splits > 1) {
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    const size_t smem = sizeof(float) * 2 * a.n_splits;
    decode_fwd_combine<TQ><<<dim3(a.H, a.B), D, smem, stream>>>(
        a.part, part_ml, static_cast<TQ*>(a.out), a.H, a.Hk, D, a.n_splits);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TC, int D>
int dispatch_g(const Args& a, cudaStream_t stream) {
  const int g = a.H / a.Hk;
  if (g <= 4) return launch<TQ, TC, D, 4>(a, stream);
  if (g <= 8) return launch<TQ, TC, D, 8>(a, stream);
  if (g <= 16) return launch<TQ, TC, D, 16>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TQ, typename TC>
int dispatch_d(int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 32:
      return dispatch_g<TQ, TC, 32>(a, stream);
    case 64:
      return dispatch_g<TQ, TC, 64>(a, stream);
    case 80:
      return dispatch_g<TQ, TC, 80>(a, stream);
    case 128:
      return dispatch_g<TQ, TC, 128>(a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, 1, H, D) given by element strides (batch, -, head); k / v caches
// (B, S, Hk, D) by strides (batch, seq, head), 16-byte-aligned bases and
// strides (the wrapper checks); D contiguous everywhere; lengths (B,)
// int32; out (B, 1, H, D) contiguous in q's type.  (q_dtype, cache_dtype):
// (0, 0) float32, (1, 1) bfloat16, or (0, 1) a float32 query over a
// bfloat16 cache, as the serve path's float32 models use; D in {32, 64,
// 80, 128}; H / Hk <= 16.  The cache is cut into n_splits ranges of split_len
// positions (the last takes the rest); with n_splits > 1, part is float32
// scratch of B * Hk * n_splits * (H / Hk) * (D + 2) values.
extern "C" int decode_attention_launch(
    int q_dtype, int cache_dtype, int D, int B, int S, int H, int Hk,
    int n_splits, int split_len, const void* q, long long qsb, long long qsh,
    const void* k, long long ksb, long long kss, long long ksh,
    const void* v, long long vsb, long long vss, long long vsh,
    const void* lengths, void* out, void* part, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * Hk == 0) return 0;
  if (n_splits < 1 || (n_splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,       {qsb, 0, qsh}, k,    {ksb, kss, ksh},
               v,       {vsb, vss, vsh}, lengths, out,
               static_cast<float*>(part), B, S, H, Hk, n_splits, split_len};
  if (q_dtype == 0 && cache_dtype == 0)
    return dispatch_d<float, float>(D, a, s);
  if (q_dtype == 1 && cache_dtype == 1)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16>(D, a, s);
  if (q_dtype == 0 && cache_dtype == 1)
    return dispatch_d<float, __nv_bfloat16>(D, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
