// flash_attention: causal / non-causal GQA attention forward on Hopper.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::flash_attention
// (body _kernel).  out[b, s, h] = softmax(q[b, s, h] . k[b, :, h / g]^T /
// sqrt(D)) v[b, :, h / g] with g = H / Hk, the softmax in float32 and the
// output in q's type.  Causal attention masks key > query (both counted
// from 0: the wrapper requires Sq == Skv).
//
// The TPU kernel walked KV blocks on a sequential grid axis and kept the
// running (m, l, acc) state in VMEM scratch that later programs revisited.
// Here one CTA owns one (query tile, batch, head) and walks the KV tiles in
// a loop, with (m, l, acc) in registers:
//
//   * 256 threads as a 16 x 16 grid.  Thread (ty, tx) owns query rows
//     ty + 16 i (i < 4), key columns tx + 16 j (j < 4) of the score tile and
//     output columns tx + 16 jj (jj < D / 16), so every shared-memory read
//     in the two inner loops is a broadcast or consecutive across a warp.
//   * Q (once) and each K tile are staged transposed, padded to BQ + 1 /
//     BK + 1 columns so the transposing stores do not collide on a bank;
//     the V tile reuses K's buffer after the scores are taken.
//   * Row max and row sum reduce over the 16 threads of a half-warp with
//     shuffles; P goes through shared memory to the P.V product.
//   * Layout (B, S, H, D) is read through the caller's strides (D
//     contiguous): no transposed or padded copies.  Keys >= Skv are masked
//     (ragged lengths); causal CTAs stop at the last tile that reaches the
//     diagonal, skipping the tiles wholly above it.
//   * Masked scores are -1e30, as in the TPU kernel and the plain version.
//
// Bound: 4 * B * H * Sq * Skv * D operations (half that when causal) on the
// tensor cores' bf16 rate.  This first version computes on the float32
// CUDA cores, one FMA per shared-memory operand pair; it is far from that
// bound, and the tensor-core (wgmma) version is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kPS = kBK + 16;   // P row stride: the two rows a warp reads
                                // fall on different banks
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

template <int D>
constexpr int smem_floats() {
  return D * (kBQ + 1) + (D * (kBK + 1) > kBK * D ? D * (kBK + 1) : kBK * D) +
         kBQ * kPS;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd(
    const T* __restrict__ q, long long qsb, long long qss, long long qsh,
    const T* __restrict__ k, long long ksb, long long kss, long long ksh,
    const T* __restrict__ v, long long vsb, long long vss, long long vsh,
    T* __restrict__ out, int Sq, int Skv, int H, int Hk, int causal,
    float scale) {
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;                    // [D][kBQ + 1]
  float* kv = qs + D * (kBQ + 1);      // K^T [D][kBK + 1], then V [kBK][D]
  float* ps = kv + (D * (kBK + 1) > kBK * D ? D * (kBK + 1) : kBK * D);

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int hk = h / (H / Hk);
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx - (idx / D) * D;
    const int s = q0 + r;
    qs[d * (kBQ + 1) + r] = s < Sq ? to_f(qb[s * qss + d]) : 0.f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (Skv + kBK - 1) / kBK;
  if (causal) {
    const int q_last = min(q0 + kBQ, Sq) - 1;
    n_tiles = min(n_tiles, q_last / kBK + 1);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // previous tile's P.V is done with kv and ps
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int c = idx / D, d = idx - (idx / D) * D;
      const int s = k0 + c;
      kv[d * (kBK + 1) + c] = s < Skv ? to_f(kb[s * kss + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kvv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[d * (kBQ + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kvv[j] = kv[d * (kBK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kvv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < Skv && (!causal || qpos >= kpos);
        sc[i][j] = ok ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        ps[(ty + 16 * i) * kPS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // scores taken: kv may now hold V
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int c = idx / D, d = idx - (idx / D) * D;
      const int s = k0 + c;
      kv[c * D + d] = s < Skv ? to_f(vb[s * vss + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * kPS + c];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const float vv = kv[c * D + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(p[i], vv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* o = out + ((static_cast<long long>(b) * Sq + s) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc)
      o[tx + 16 * cc] = from_f<T>(acc[i][cc] * inv);
  }
}

struct Strides {
  long long b, s, h;
};

template <typename T, int D>
int launch(const void* q, Strides qs, const void* k, Strides ks,
           const void* v, Strides vs, void* out, int B, int Sq, int Skv,
           int H, int Hk, int causal, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kern = flash_fwd<T, D>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), qs.b, qs.s, qs.h, static_cast<const T*>(k),
      ks.b, ks.s, ks.h, static_cast<const T*>(v), vs.b, vs.s, vs.h,
      static_cast<T*>(out), Sq, Skv, H, Hk, causal,
      1.f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, Strides qs, const void* k, Strides ks,
               const void* v, Strides vs, void* out, int B, int Sq, int Skv,
               int H, int Hk, int causal, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, qs, k, ks, v, vs, out, B, Sq, Skv, H, Hk,
                           causal, stream);
    case 64:
      return launch<T, 64>(q, qs, k, ks, v, vs, out, B, Sq, Skv, H, Hk,
                           causal, stream);
    case 128:
      return launch<T, 128>(q, qs, k, ks, v, vs, out, B, Sq, Skv, H, Hk,
                            causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, Sq, H, D), k / v (B, Skv, Hk, D) given by element strides (batch,
// seq, head) with D contiguous; out (B, Sq, H, D) contiguous.  dtype 0 =
// float32, 1 = bfloat16; D in {32, 64, 128}; H a multiple of Hk.
extern "C" int flash_attention_launch(
    int dtype, int D, int causal, int B, int Sq, int Skv, int H, int Hk,
    const void* q, long long qsb, long long qss, long long qsh,
    const void* k, long long ksb, long long kss, long long ksh,
    const void* v, long long vsb, long long vss, long long vsh, void* out,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  if (B * H == 0 || Sq == 0) return 0;
  if (dtype == 0)
    return dispatch_d<float>(D, q, qs, k, ks, v, vs, out, B, Sq, Skv, H, Hk,
                             causal, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, qs, k, ks, v, vs, out, B, Sq, Skv,
                                     H, Hk, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
