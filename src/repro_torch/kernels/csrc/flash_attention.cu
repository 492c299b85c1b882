// flash_attention: causal / non-causal GQA attention forward on Hopper.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::flash_attention
// (body _kernel).  out[b, s, h] = softmax(q[b, s, h] . k[b, :, h / g]^T /
// sqrt(D)) v[b, :, h / g] with g = H / Hk, the softmax in float32 and the
// output in q's type.  Causal attention masks key > query (both counted
// from 0: the wrapper requires Sq == Skv).  Masked scores are -1e30, as in
// the TPU kernel and the plain version.
//
// The TPU kernel walked KV blocks on a sequential grid axis and kept the
// running (m, l, acc) state in VMEM scratch that later programs revisited.
// Here one CTA owns one (query tile, batch, head) and walks the KV tiles in
// a loop with (m, l, acc) in registers.  Layout (B, S, H, D) is read through
// the caller's strides (D contiguous): no transposed or padded copies.
// Keys >= Skv are masked (ragged lengths); causal CTAs stop at the last tile
// that reaches the diagonal, skipping the tiles wholly above it.
//
// Bound: 4 * B * H * Sq * Skv * D operations (half that when causal) on the
// tensor cores' bf16 rate.  Two instantiations:
//
// bfloat16 (the serve path): FlashAttention-2 on the tensor cores.
//   * 4 warps, 16 query rows each (a 64-row Q tile).  The Q fragments are
//     loaded once with ldmatrix and stay in registers for the whole walk.
//   * K and V tiles of 64 keys stay bf16 in shared memory, fed by cp.async
//     (16 bytes a thread, zero-filled past Skv / Sq) and double-buffered:
//     tile t + 1 is in flight while tile t is multiplied.  Rows are padded
//     by 16 bytes so the 8 row addresses of one ldmatrix fall on 8
//     different 4-bank groups.  The Q tile is staged in the second buffer
//     before the walk starts.
//   * S = Q K^T and O += P V on mma.sync.m16n8k16 (bf16 in, float32
//     accumulate).  V's B fragments come from its row-major (key, D) tile
//     through ldmatrix.trans.  The float32 C fragments of two adjacent
//     n8 score tiles are exactly one A fragment of m16n8k16, so P goes from
//     registers to the A operand and never touches shared memory.
//   * P enters the tensor cores as three bf16 parts, hi = bf16(P),
//     mid = bf16(P - hi), lo = bf16(P - hi - mid), in three P.V products:
//     together they carry P's 24 bits.  With one bf16 rounding of P a
//     third of the outputs sit one bf16 ulp off the plain version, and the
//     worst call of the yi-34b serve path reaches 96-100% of the one-ulp
//     gate chip_smoke.py holds every call to; with three parts about one
//     output in a thousand is one ulp off and the worst call stays under
//     60% of the gate (PERF.md has the readings).  Q K^T needs no split:
//     bf16 products are exact in float32.
//   * Online softmax in registers, base 2 (scores pre-scaled by
//     log2(e) / sqrt(D)); row max over the 4 threads of a quad with
//     shuffles, row sums kept per thread and reduced once at the end.  The
//     mask is applied only on tiles that cross the diagonal or the ragged
//     end.  Causal CTAs are launched heaviest first.
// float32: the first port's CUDA-core kernel (256 threads as a 16 x 16 grid,
//   64 x 64 tiles, K staged transposed, P through shared memory).  TF32
//   tensor cores would round the inputs to 10 mantissa bits and break the
//   1e-4 float32 parity the tests hold, so float32 stays on the CUDA cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// bfloat16: mma.sync tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kMmaThreads = kWarps * 32;
constexpr int kTileQ = 16 * kWarps;   // query rows per CTA
constexpr int kTileK = 64;            // keys per K/V tile
constexpr int kPParts = 3;            // bf16 parts of P in P.V (see the top)

template <int D>
__host__ __device__ constexpr int row_stride() { return D + 8; }   // elements: +16 bytes a row

template <int D>
constexpr int mma_smem_bytes() {
  // K and V, two stages; the Q tile (kTileQ <= 2 * kTileK rows) is staged in
  // stage 1 before the walk.
  return 4 * kTileK * row_stride<D>() * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16 x 8, float32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// P's float32 pair (a, b) as N bf16 pairs parts[i][reg], each the bf16
// rounding of what the earlier parts leave out: their sum carries ~8 N
// mantissa bits of a and b (N = 3 keeps all 24).
template <int N>
__device__ __forceinline__ void split_bf16(float a, float b,
                                           uint32_t (&parts)[N][4], int reg) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    parts[i][reg] = *reinterpret_cast<const uint32_t*>(&h);
    a -= __low2float(h);
    b -= __high2float(h);
  }
}

// Copies rows [r0, r0 + rows) of a (seq, D) slice with row stride `ss`
// into shared memory (row stride row_stride<D>()), zero-filling rows >= n.
template <int D, int Rows>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ss, int r0, int n) {
  constexpr int kChunks = D / 8;   // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < Rows * kChunks; idx += kMmaThreads) {
    const int r = idx / kChunks;
    const int c = idx - r * kChunks;
    const int s = r0 + r;
    const bool ok = s < n;
    cp_async16(dst + r * row_stride<D>() + c * 8,
               src + (ok ? s : 0) * ss + c * 8, ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_mma(
    const __nv_bfloat16* __restrict__ q, long long qsb, long long qss,
    long long qsh, const __nv_bfloat16* __restrict__ k, long long ksb,
    long long kss, long long ksh, const __nv_bfloat16* __restrict__ v,
    long long vsb, long long vss, long long vsh,
    __nv_bfloat16* __restrict__ out, int Sq, int Skv, int H, int Hk,
    int causal, float scale_log2) {
  constexpr int LD = row_stride<D>();
  constexpr int KD = D / 16;   // k16 steps over D
  constexpr int ND = D / 8;    // n8 tiles over D
  constexpr int NK = kTileK / 8;
  extern __shared__ __align__(16) unsigned char flash_smem[];
  constexpr int kStage = 2 * kTileK * LD;   // one K tile and one V tile
  __nv_bfloat16* const base = reinterpret_cast<__nv_bfloat16*>(flash_smem);
  __nv_bfloat16* const qs = base + kStage;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int hk = h / (H / Hk);
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kTileQ;
  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + hk * ksh;
  const __nv_bfloat16* vb = v + b * vsb + hk * vsh;

  int n_tiles = (Skv + kTileK - 1) / kTileK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kTileQ, Sq) - 1) / kTileK + 1);

  load_tile<D, kTileQ>(qs, qb, qss, q0, Sq);
  load_tile<D, kTileK>(base, kb, kss, 0, Skv);
  load_tile<D, kTileK>(base + kTileK * LD, vb, vss, 0, Skv);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8);
  __syncthreads();   // stage 1 is free for tile 1

  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + (lane >> 2);   // this thread's rows:
  const int row1 = row0 + 8;                       // row0 and row0 + 8
  const int warp_first = q0 + warp * 16;

  for (int t = 0; t < n_tiles; ++t) {
    const __nv_bfloat16* ks = base + (t & 1) * kStage;
    const __nv_bfloat16* vs = ks + kTileK * LD;
    if (t + 1 < n_tiles) {
      __nv_bfloat16* nxt = base + ((t + 1) & 1) * kStage;
      load_tile<D, kTileK>(nxt, kb, kss, (t + 1) * kTileK, Skv);
      load_tile<D, kTileK>(nxt + kTileK * LD, vb, vss, (t + 1) * kTileK, Skv);
    }
    cp_async_commit();
    cp_async_wait<1>();   // tile t has landed
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys a warp
    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                     LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }

    const int k0 = t * kTileK;
    const bool ragged = k0 + kTileK > Skv;
    const bool diag = causal && k0 + kTileK - 1 > warp_first;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (ragged || diag) {
          const int col = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
          const int row = e < 2 ? row0 : row1;
          if (col >= Skv || (causal && col > row)) x = kNegInf;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // O += P V: P's C fragments repacked as A fragments (kPParts bf16
    // parts), V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) {
      uint32_t pf[kPParts][4];
      split_bf16<kPParts>(s[2 * kk][0], s[2 * kk][1], pf, 0);
      split_bf16<kPParts>(s[2 * kk][2], s[2 * kk][3], pf, 1);
      split_bf16<kPParts>(s[2 * kk + 1][0], s[2 * kk + 1][1], pf, 2);
      split_bf16<kPParts>(s[2 * kk + 1][2], s[2 * kk + 1][3], pf, 3);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(
            bf, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                    dp * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int part = 0; part < kPParts; ++part) {
          mma_bf16(o[2 * dp], pf[part], bf[0], bf[1]);
          mma_bf16(o[2 * dp + 1], pf[part], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();   // this stage is free for tile t + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv0 = 1.f / fmaxf(l[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l[1], 1e-30f);
  const int col = (lane & 3) * 2;
  if (row0 < Sq) {
    __nv_bfloat16* o0 =
        out + ((static_cast<long long>(b) * Sq + row0) * H + h) * D + col;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o0 + j * 8) =
          __floats2bfloat162_rn(o[j][0] * inv0, o[j][1] * inv0);
  }
  if (row1 < Sq) {
    __nv_bfloat16* o1 =
        out + ((static_cast<long long>(b) * Sq + row1) * H + h) * D + col;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o1 + j * 8) =
          __floats2bfloat162_rn(o[j][2] * inv1, o[j][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kPS = kBK + 16;   // P row stride: the two rows a warp reads
                                // fall on different banks

template <int D>
constexpr int smem_floats() {
  return D * (kBQ + 1) + (D * (kBK + 1) > kBK * D ? D * (kBK + 1) : kBK * D) +
         kBQ * kPS;
}

// Thread (ty, tx) of a 16 x 16 grid owns query rows ty + 16 i (i < 4), key
// columns tx + 16 j (j < 4) of the score tile and output columns
// tx + 16 jj (jj < D / 16), so every shared-memory read in the two inner
// loops is a broadcast or consecutive across a warp.  Q (once) and each K
// tile are staged transposed, padded to BQ + 1 / BK + 1 columns so the
// transposing stores do not collide on a bank; the V tile reuses K's buffer
// after the scores are taken.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(
    const float* __restrict__ q, long long qsb, long long qss, long long qsh,
    const float* __restrict__ k, long long ksb, long long kss, long long ksh,
    const float* __restrict__ v, long long vsb, long long vss, long long vsh,
    float* __restrict__ out, int Sq, int Skv, int H, int Hk, int causal,
    float scale) {
  constexpr int kCols = D / 16;
  extern __shared__ float flash_smem_f32[];
  float* qs = flash_smem_f32;          // [D][kBQ + 1]
  float* kv = qs + D * (kBQ + 1);      // K^T [D][kBK + 1], then V [kBK][D]
  float* ps = kv + (D * (kBK + 1) > kBK * D ? D * (kBK + 1) : kBK * D);

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int hk = h / (H / Hk);
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx - (idx / D) * D;
    const int s = q0 + r;
    qs[d * (kBQ + 1) + r] = s < Sq ? qb[s * qss + d] : 0.f;
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
      kv[d * (kBK + 1) + c] = s < Skv ? kb[s * kss + d] : 0.f;
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
      kv[c * D + d] = s < Skv ? vb[s * vss + d] : 0.f;
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
    float* o = out + ((static_cast<long long>(b) * Sq + s) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) o[tx + 16 * cc] = acc[i][cc] * inv;
  }
}

struct Strides {
  long long b, s, h;
};

template <int D>
int launch_f32(const void* q, Strides qs, const void* k, Strides ks,
               const void* v, Strides vs, void* out, int B, int Sq, int Skv,
               int H, int Hk, int causal, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kern = flash_fwd_f32<D>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), qs.b, qs.s, qs.h,
      static_cast<const float*>(k), ks.b, ks.s, ks.h,
      static_cast<const float*>(v), vs.b, vs.s, vs.h,
      static_cast<float*>(out), Sq, Skv, H, Hk, causal,
      1.f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_mma(const void* q, Strides qs, const void* k, Strides ks,
               const void* v, Strides vs, void* out, int B, int Sq, int Skv,
               int H, int Hk, int causal, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<D>();
  auto kern = flash_fwd_mma<D>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  // batch x head on x, query tiles on y (heaviest causal tiles first)
  const dim3 grid(B * H, (Sq + kTileQ - 1) / kTileQ);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), qs.b, qs.s, qs.h,
      static_cast<const __nv_bfloat16*>(k), ks.b, ks.s, ks.h,
      static_cast<const __nv_bfloat16*>(v), vs.b, vs.s, vs.h,
      static_cast<__nv_bfloat16*>(out), Sq, Skv, H, Hk, causal,
      1.4426950408889634f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16>
int dispatch_d(int D, const void* q, Strides qs, const void* k, Strides ks,
               const void* v, Strides vs, void* out, int B, int Sq, int Skv,
               int H, int Hk, int causal, cudaStream_t stream) {
  switch (D) {
    case 32:
      return kBf16 ? launch_mma<32>(q, qs, k, ks, v, vs, out, B, Sq, Skv, H,
                                    Hk, causal, stream)
                   : launch_f32<32>(q, qs, k, ks, v, vs, out, B, Sq, Skv, H,
                                    Hk, causal, stream);
    case 64:
      return kBf16 ? launch_mma<64>(q, qs, k, ks, v, vs, out, B, Sq, Skv, H,
                                    Hk, causal, stream)
                   : launch_f32<64>(q, qs, k, ks, v, vs, out, B, Sq, Skv, H,
                                    Hk, causal, stream);
    case 128:
      return kBf16 ? launch_mma<128>(q, qs, k, ks, v, vs, out, B, Sq, Skv, H,
                                     Hk, causal, stream)
                   : launch_f32<128>(q, qs, k, ks, v, vs, out, B, Sq, Skv, H,
                                     Hk, causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, Sq, H, D), k / v (B, Skv, Hk, D) given by element strides (batch,
// seq, head) with D contiguous; out (B, Sq, H, D) contiguous.  dtype 0 =
// float32, 1 = bfloat16 (bf16 operands need 16-byte-aligned bases and
// strides that are multiples of 8 elements: the wrapper checks); D in
// {32, 64, 128}; H a multiple of Hk.
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
    return dispatch_d<false>(D, q, qs, k, ks, v, vs, out, B, Sq, Skv, H, Hk,
                             causal, s);
  if (dtype == 1)
    return dispatch_d<true>(D, q, qs, k, ks, v, vs, out, B, Sq, Skv, H, Hk,
                            causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
