// decode_attention: one query token of GQA attention over a static KV cache.
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py::
// decode_attention (body _kernel).  For batch b and query head h,
//
//     out[b, 0, h] = softmax_t(q[b, 0, h] . k[b, t, h / g] / sqrt(D)) v[b, t, h / g]
//
// over t < S, with scores of positions t >= lengths[b] set to -1e30 (so a
// length of 0 averages V over the whole cache, as the plain softmax does).
//
// The TPU kernel ran one program per (batch, query head) and walked the
// cache on a sequential grid axis with (m, l, acc) in VMEM.  Here one CTA
// owns one (batch, KV head) and all g query heads that share it, so the
// cache rows of that head are read once for the group:
//
//   * the cache is walked in chunks of 256 positions; thread t of the CTA
//     takes position t of the chunk and computes its g scores against the
//     g query rows staged in shared memory (one contiguous K row a thread);
//   * warp h turns head h's chunk of scores into probabilities with an
//     online-softmax update (running max m, sum l, rescale factor);
//   * for P.V, thread (part, d) accumulates column d of all g heads over
//     every (256 / D)-th position of the chunk (coalesced V rows); the parts
//     are summed once at the end;
//   * positions at or past lengths[b] contribute exactly 0 once a valid
//     position has set the running max, so the walk stops at
//     min(lengths[b], S) (the whole cache when lengths[b] <= 0).
//
// Bound: the bytes of the valid cache rows, read once (decode is memory
// bound); one CTA per (batch, KV head) gives B * Hk CTAs, fewer than the
// card's 132 SMs at small batch, which a split over the cache would fix.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;    // cache positions per chunk (one a thread)
constexpr int kMaxG = 16;      // query heads per KV head
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

template <typename TQ, typename TC, int D>
__global__ void __launch_bounds__(kThreads) decode_fwd(
    const TQ* __restrict__ q, long long qsb, long long qsh,
    const TC* __restrict__ k, long long ksb, long long kss, long long ksh,
    const TC* __restrict__ v, long long vsb, long long vss, long long vsh,
    const int* __restrict__ lengths, TQ* __restrict__ out, int S, int H,
    int Hk, float scale) {
  constexpr int kParts = kThreads / D;          // P.V position interleave
  __shared__ float qs[kMaxG * D];
  __shared__ float sc[kMaxG * kChunk];
  __shared__ float red[kParts * kMaxG * D];
  __shared__ float m_s[kMaxG];     // running max, sum and rescale factor
  __shared__ float l_s[kMaxG];     // of each head
  __shared__ float corr_s[kMaxG];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / Hk;
  const int hk = blockIdx.x - b * Hk;
  const int g = H / Hk;
  const int h0 = hk * g;
  const TQ* qb = q + b * qsb + h0 * qsh;
  const TC* kb = k + b * ksb + hk * ksh;
  const TC* vb = v + b * vsb + hk * vsh;
  const int len = lengths[b];
  const int end = len > 0 ? min(len, S) : S;

  for (int idx = tid; idx < g * D; idx += kThreads) {
    const int hh = idx / D, d = idx - (idx / D) * D;
    qs[idx] = to_f(qb[hh * qsh + d]);
  }
  if (tid < kMaxG) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const int part = tid / D;
  const int col = tid - part * D;
  float acc[kMaxG];
#pragma unroll
  for (int hh = 0; hh < kMaxG; ++hh) acc[hh] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < end; t0 += kChunk) {
    const int n = min(kChunk, end - t0);
    // scores: thread tid takes position t0 + tid
    if (tid < n) {
      const int t = t0 + tid;
      float s[kMaxG];
#pragma unroll
      for (int hh = 0; hh < kMaxG; ++hh) s[hh] = 0.f;
      if (t < len) {
        const TC* kr = kb + t * kss;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          const float kd = to_f(kr[d]);
#pragma unroll
          for (int hh = 0; hh < kMaxG; ++hh)
            if (hh < g) s[hh] = fmaf(qs[hh * D + d], kd, s[hh]);
        }
      }
#pragma unroll
      for (int hh = 0; hh < kMaxG; ++hh)
        if (hh < g) sc[hh * kChunk + tid] = t < len ? s[hh] * scale : kNegInf;
    }
    __syncthreads();
    // online softmax, warp hh for head hh
    for (int hh = warp; hh < g; hh += kThreads / 32) {
      float* row = sc + hh * kChunk;
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
    // P.V: thread (part, col) over positions part, part + kParts, ...
#pragma unroll
    for (int hh = 0; hh < kMaxG; ++hh)
      if (hh < g) acc[hh] *= corr_s[hh];
    for (int i = part; i < n; i += kParts) {
      const float vv = to_f(vb[(t0 + i) * vss + col]);
#pragma unroll
      for (int hh = 0; hh < kMaxG; ++hh)
        if (hh < g) acc[hh] = fmaf(sc[hh * kChunk + i], vv, acc[hh]);
    }
    __syncthreads();  // sc and corr_s are rewritten by the next chunk
  }

#pragma unroll
  for (int hh = 0; hh < kMaxG; ++hh)
    if (hh < g) red[(part * kMaxG + hh) * D + col] = acc[hh];
  __syncthreads();
  for (int idx = tid; idx < g * D; idx += kThreads) {
    const int hh = idx / D, d = idx - (idx / D) * D;
    float total = 0.f;
    for (int p = 0; p < kParts; ++p) total += red[(p * kMaxG + hh) * D + d];
    const float inv = 1.f / fmaxf(l_s[hh], 1e-30f);
    out[(static_cast<long long>(b) * H + h0 + hh) * D + d] =
        from_f<TQ>(total * inv);
  }
}

struct Strides {
  long long b, s, h;
};

template <typename TQ, typename TC, int D>
int launch(const void* q, Strides qs, const void* k, Strides ks,
           const void* v, Strides vs, const void* lengths, void* out, int B,
           int S, int H, int Hk, cudaStream_t stream) {
  decode_fwd<TQ, TC, D><<<B * Hk, kThreads, 0, stream>>>(
      static_cast<const TQ*>(q), qs.b, qs.h, static_cast<const TC*>(k), ks.b,
      ks.s, ks.h, static_cast<const TC*>(v), vs.b, vs.s, vs.h,
      static_cast<const int*>(lengths), static_cast<TQ*>(out), S, H, Hk,
      1.f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TC>
int dispatch_d(int D, const void* q, Strides qs, const void* k, Strides ks,
               const void* v, Strides vs, const void* lengths, void* out,
               int B, int S, int H, int Hk, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<TQ, TC, 32>(q, qs, k, ks, v, vs, lengths, out, B, S, H,
                                Hk, stream);
    case 64:
      return launch<TQ, TC, 64>(q, qs, k, ks, v, vs, lengths, out, B, S, H,
                                Hk, stream);
    case 128:
      return launch<TQ, TC, 128>(q, qs, k, ks, v, vs, lengths, out, B, S, H,
                                 Hk, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TQ>
int dispatch_cache(int cache_dtype, int D, const void* q, Strides qs,
                   const void* k, Strides ks, const void* v, Strides vs,
                   const void* lengths, void* out, int B, int S, int H,
                   int Hk, cudaStream_t stream) {
  if (cache_dtype == 0)
    return dispatch_d<TQ, float>(D, q, qs, k, ks, v, vs, lengths, out, B, S,
                                 H, Hk, stream);
  if (cache_dtype == 1)
    return dispatch_d<TQ, __nv_bfloat16>(D, q, qs, k, ks, v, vs, lengths,
                                         out, B, S, H, Hk, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B, 1, H, D) given by element strides (batch, -, head); k / v caches
// (B, S, Hk, D) by strides (batch, seq, head); D contiguous everywhere;
// lengths (B,) int32; out (B, 1, H, D) contiguous in q's type.  q_dtype and
// cache_dtype: 0 = float32, 1 = bfloat16 (a float32 query may read a
// bfloat16 cache, as the serve path's float32 models do); D in {32, 64,
// 128}; H / Hk <= 16.
extern "C" int decode_attention_launch(
    int q_dtype, int cache_dtype, int D, int B, int S, int H, int Hk,
    const void* q, long long qsb, long long qsh, const void* k,
    long long ksb, long long kss, long long ksh, const void* v,
    long long vsb, long long vss, long long vsh, const void* lengths,
    void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, 0, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  if (B * Hk == 0) return 0;
  if (q_dtype == 0)
    return dispatch_cache<float>(cache_dtype, D, q, qs, k, ks, v, vs,
                                 lengths, out, B, S, H, Hk, s);
  if (q_dtype == 1)
    return dispatch_cache<__nv_bfloat16>(cache_dtype, D, q, qs, k, ks, v, vs,
                                         lengths, out, B, S, H, Hk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
