// che_solve: Che's characteristic time T and the LRU hit rate, one launch.
//
// Replaces the jitted solver repro/kernels/che_solver.py::che_solve (its
// fori_loop of Pallas che_sums passes, body _kernel) together with the
// hit-rate sum that repro/core/cache_models.py::hit_rate_lru takes from
// its T.  It solves C = sum_i (1 - exp(-p_i T)) by K-way subdivision of a
// log-space bracket: each of `iters` passes evaluates the sum at K
// candidate times and keeps the sub-interval whose ends straddle C, then
// T = exp(mid of the bracket) and h = sum_i p_i (1 - exp(-p_i T)).
//
// Work split: one cooperative grid of one block per SM solves the whole
// problem.  Each block stages its ceil(N/B) slice of the probabilities in
// shared memory once; a slice longer than the staging budget reads its
// tail through the read-only cache on every pass.  The prologue's smallest
// nonzero probability is a grid-wide min (order-free, so exact).  One pass
// is one grid-wide reduction: each block reduces its K per-thread sums
// (warp butterflies, warps in order) into its row of a double-buffered
// partials array, one grid barrier, then EVERY block adds the B rows
// itself in one fixed order (warp c takes candidate c: lane l adds rows
// l, l + 32, ... in order, then a butterfly), so every block holds
// bit-identical sums, picks the same sub-interval and leaves the loop
// together: no host round trip, and the same bits from call to call.
//
// A thread-block cluster of 16 CTAs (one DSMEM reduction a pass) was the
// first design: at the Che path's 78,125 pages it took 0.20 ms against
// this grid's 0.086 ms (PERF.md): 16 SMs run the expm1f work too slowly
// for the cheaper barrier to pay.
//
// Arithmetic follows the JAX solver op for op in float32: the bracket
// update is written with __fsub_rn/__fmul_rn/__fadd_rn so that nvcc does
// not contract it into an FMA (the reference rounds each op apart); expf,
// logf, expm1f and the division stay IEEE (no fast math).  Candidates past
// K (the kernel is instantiated for 1, 2, 4, 8 or 16 of them) get t = 0,
// whose terms are exactly 0.
//
// Bound: 4 N bytes read once, against K expm1f per probability on each of
// the `iters` passes (31 SASS instructions each, one MUFU ex2).  At 10^5
// pages a pass's work is a few hundred nanoseconds an SM, so the grid
// barrier and the partials' round trip through L2, ~17 times a solve, set
// the time.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 16;
constexpr int kStageFloats = 24576;  // 96 KiB of staged probabilities a block
constexpr unsigned kFull = 0xffffffffu;

struct SolveArgs {
  const float* probs;
  const float* cap_ptr;  // the capacity on the card, or null: use cap
  float* partials;       // (2, B, kMaxK) scratch, this launch's alone
  float* out;            // (2,): T, h
  float cap;
  int n, K, iters, slice, stage;
  float fracs[kMaxK];    // (j + 1) / (K + 1), rounded as the host does
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// This block's K sums into `row`: a butterfly in each warp, then the
// warps added in order.
template <int kK>
__device__ __forceinline__ void block_partials(float (&red)[kWarps][kMaxK],
                                               const float (&s)[kK], int K,
                                               float* row) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < kK; ++c) {
    const float w = warp_sum(s[c]);
    if (lane == 0) red[warp][c] = w;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += red[w][threadIdx.x];
    row[threadIdx.x] = t;
  }
}

// Sum c of the B rows of `buf`, added by warp c in a fixed order (L2
// reads: other blocks wrote them).  Valid in lane 0.
__device__ __forceinline__ float grid_total(const float* buf, int B, int c) {
  const int lane = threadIdx.x & 31;
  float v = 0.f;
  for (int b = lane; b < B; b += 32) v += __ldcg(buf + b * kMaxK + c);
  return warp_sum(v);
}

template <int kK>
__device__ __forceinline__ void add_terms(float p, const float (&t)[kK],
                                          float (&s)[kK]) {
#pragma unroll
  for (int c = 0; c < kK; ++c) s[c] += -expm1f(-p * t[c]);
}

template <int kK>
__global__ void __launch_bounds__(kThreads) che_solve_kernel(
    const SolveArgs a) {
  extern __shared__ float stage_s[];
  __shared__ float red[kWarps][kMaxK];
  __shared__ float tot[kMaxK];
  const cg::grid_group grid = cg::this_grid();
  const int B = static_cast<int>(gridDim.x);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // this block's slice [j0, j0 + len): the first `staged` in shared memory
  const int j0 = static_cast<int>(min(
      static_cast<long long>(a.n),
      static_cast<long long>(blockIdx.x) * a.slice));
  const int len = min(a.n - j0, a.slice);
  const int staged = min(len, a.stage);
  const float* gp = a.probs + j0;

  // ---- prologue: stage the slice; pmin = max(min_{p > 0} p, 1e-30)
  float mn = INFINITY;
  int j = tid;
  for (; j < staged; j += kThreads) {
    const float p = gp[j];
    stage_s[j] = p;
    if (p > 0.f) mn = fminf(mn, p);
  }
  for (; j < len; j += kThreads) {
    const float p = __ldg(gp + j);
    if (p > 0.f) mn = fminf(mn, p);
  }
  mn = warp_min(mn);
  if (lane == 0) red[warp][0] = mn;
  __syncthreads();  // also publishes the staged slice
  if (tid == 0) {
    float m = red[0][0];
    for (int w = 1; w < kWarps; ++w) m = fminf(m, red[w][0]);
    a.partials[blockIdx.x * kMaxK] = m;
  }
  grid.sync();
  if (warp == 0) {
    float m = INFINITY;
    for (int b = lane; b < B; b += 32)
      m = fminf(m, __ldcg(a.partials + b * kMaxK));
    m = warp_min(m);
    if (lane == 0) tot[0] = m;
  }
  __syncthreads();
  const float pmin = fmaxf(tot[0], 1e-30f);
  const float cap = a.cap_ptr != nullptr ? *a.cap_ptr : a.cap;
  const float hi0 = fmaxf(__fdiv_rn(__fmul_rn(4.f, cap), pmin), 1.f);
  float log_lo = logf(__fmul_rn(hi0, 1e-30f));
  float log_hi = logf(hi0);

  // ---- the passes: K candidates in the log bracket, keep the straddle.
  // Buffers alternate: one is rewritten only after every block has passed
  // the barrier that follows its reads of it (buffer 0 held the min).
  int phase = 1;
  for (int it = 0; it < a.iters; ++it, ++phase) {
    const float d = __fsub_rn(log_hi, log_lo);
    float lt[kK], t[kK], s[kK];
#pragma unroll
    for (int c = 0; c < kK; ++c) {
      lt[c] = __fadd_rn(log_lo, __fmul_rn(d, a.fracs[c]));
      t[c] = c < a.K ? expf(lt[c]) : 0.f;
      s[c] = 0.f;
    }
    j = tid;
    for (; j < staged; j += kThreads) add_terms(stage_s[j], t, s);
    for (; j < len; j += kThreads) add_terms(__ldg(gp + j), t, s);
    float* buf = a.partials + (phase & 1) * B * kMaxK;
    block_partials(red, s, a.K, buf + blockIdx.x * kMaxK);
    grid.sync();
    for (int c = warp; c < a.K; c += kWarps) {
      const float v = grid_total(buf, B, c);
      if (lane == 0) tot[c] = v;
    }
    __syncthreads();
    // rightmost candidate still below C bounds the solution from the left
    int idx = 0;
#pragma unroll
    for (int c = 0; c < kK; ++c) idx += c < a.K && tot[c] < cap;
    float lo = log_lo, hi = log_hi;  // [log_lo, lt[0..K-1], log_hi][idx..]
#pragma unroll
    for (int c = 0; c < kK; ++c) {
      if (c == idx - 1) lo = lt[c];
      if (c == idx && c < a.K) hi = lt[c];
    }
    log_lo = lo;
    log_hi = hi;
  }

  // ---- epilogue: T at the bracket's log-midpoint, then h over the slice
  const float T = expf(__fmul_rn(0.5f, __fadd_rn(log_lo, log_hi)));
  float hv[1] = {0.f};
  j = tid;
  for (; j < staged; j += kThreads) {
    const float p = stage_s[j];
    hv[0] += __fmul_rn(p, -expm1f(-p * T));
  }
  for (; j < len; j += kThreads) {
    const float p = __ldg(gp + j);
    hv[0] += __fmul_rn(p, -expm1f(-p * T));
  }
  float* buf = a.partials + (phase & 1) * B * kMaxK;
  block_partials(red, hv, 1, buf + blockIdx.x * kMaxK);
  grid.sync();
  if (blockIdx.x == 0 && warp == 0) {
    const float h = grid_total(buf, B, 0);
    if (lane == 0) {
      a.out[0] = T;
      a.out[1] = h;
    }
  }
}

template <int kK>
cudaError_t configure() {
  return cudaFuncSetAttribute(che_solve_kernel<kK>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kStageFloats * static_cast<int>(sizeof(float)));
}

}  // namespace

// Once per device (the wrapper caches the answer): sets the kernels'
// attributes and writes to *blocks the grid a solve launches, one block
// per SM (0 where the card takes no cooperative launch or no block fits
// at the full staging budget).
extern "C" int che_solve_setup(int* blocks) {
  *blocks = 0;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = configure<1>();
  if (err == cudaSuccess) err = configure<2>();
  if (err == cudaSuccess) err = configure<4>();
  if (err == cudaSuccess) err = configure<8>();
  if (err == cudaSuccess) err = configure<16>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, che_solve_kernel<16>, kThreads,
        kStageFloats * sizeof(float));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (coop && per_sm >= 1) *blocks = sms;
  return static_cast<int>(cudaGetLastError());
}

// probs (n,) float32 with n >= 1; the capacity as `cap`, or read on the
// card from cap_ptr when that is not null; fracs (K,) float32 on the host
// with 1 <= K <= 16; partials (2, blocks, 16) float32 scratch that no other
// launch uses meanwhile; out (2,) float32: T, h.  blocks, slice and stage
// are the wrapper's launch plan (blocks * slice >= n, stage <= 24,576).
extern "C" int che_solve_launch(const void* probs, int n, float cap,
                                const void* cap_ptr, const void* fracs, int K,
                                int iters, int blocks, int slice, int stage,
                                void* partials, void* out, void* stream) {
  if (n < 1 || K < 1 || K > kMaxK || iters < 0 || blocks < 1 || slice < 1 ||
      static_cast<long long>(blocks) * slice < n || stage < 0 ||
      stage > kStageFloats || stage > slice)
    return static_cast<int>(cudaErrorInvalidValue);
  SolveArgs a = {};
  a.probs = static_cast<const float*>(probs);
  a.cap_ptr = static_cast<const float*>(cap_ptr);
  a.partials = static_cast<float*>(partials);
  a.out = static_cast<float*>(out);
  a.cap = cap;
  a.n = n;
  a.K = K;
  a.iters = iters;
  a.slice = slice;
  a.stage = stage;
  memcpy(a.fracs, fracs, K * sizeof(float));
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(stage) * sizeof(float);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      K <= 1   ? cudaLaunchKernelEx(&cfg, che_solve_kernel<1>, a)
      : K <= 2 ? cudaLaunchKernelEx(&cfg, che_solve_kernel<2>, a)
      : K <= 4 ? cudaLaunchKernelEx(&cfg, che_solve_kernel<4>, a)
      : K <= 8 ? cudaLaunchKernelEx(&cfg, che_solve_kernel<8>, a)
               : cudaLaunchKernelEx(&cfg, che_solve_kernel<16>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
