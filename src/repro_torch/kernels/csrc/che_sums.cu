// che_sums: sum_i (1 - exp(-p_i * t_k)) for K candidate times in one pass.
//
// Replaces the Pallas kernel repro/kernels/che_solver.py::che_sums (body
// _kernel), the evaluator behind che_solve's K-way subdivision of Che's
// consistency condition C = sum_i (1 - exp(-p_i T)).
//
// The TPU kernel accumulated every program's block into one (1, K) output
// tile that the sequential grid revisited in order.  CUDA blocks run in no
// order, so each block reduces its share of the probabilities to K partial
// sums (a grid-stride pass, K float32 accumulators a thread, a warp-shuffle
// and shared-memory tree), and a second one-block launch reduces the
// partials the same way, in a fixed order: the result does not depend on
// scheduling.  Each term is
// -expm1f(-p t), as in the TPU kernel (exact 0 for p = 0).
//
// Bound: the probabilities are read once (4 N bytes) and each of the N K
// terms is one expm1f and an add: at the CAM main path's N = 78,125 pages
// either takes a few microseconds, so one call is bound by its two
// launches.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 16;

__global__ void __launch_bounds__(kThreads) che_partial(
    const float* __restrict__ probs, long long n,
    const float* __restrict__ t, int K, float* __restrict__ partial) {
  __shared__ float ts[kMaxK];
  __shared__ float warp_sums[kThreads / 32][kMaxK];
  if (threadIdx.x < K) ts[threadIdx.x] = t[threadIdx.x];
  __syncthreads();
  float acc[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) acc[j] = 0.f;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    const float p = probs[i];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j)
      if (j < K) acc[j] += -expm1f(-p * ts[j]);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j >= K) break;
    float v = acc[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp][j] = v;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float v = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) v += warp_sums[w][threadIdx.x];
    partial[static_cast<long long>(blockIdx.x) * K + threadIdx.x] = v;
  }
}

__global__ void __launch_bounds__(kThreads) che_final(
    const float* __restrict__ partial, int blocks, int K,
    float* __restrict__ out) {
  __shared__ float warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = 0; j < K; ++j) {
    float v = 0.f;
    for (int b = threadIdx.x; b < blocks; b += kThreads)
      v += partial[b * K + j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
      out[j] = total;
    }
    __syncthreads();
  }
}

}  // namespace

// probs (n,) float32, t (K,) float32 with 1 <= K <= 16, partial (blocks, K)
// float32 scratch, out (K,) float32.  blocks >= 1 is the caller's grid size.
extern "C" int che_sums_launch(const void* probs, long long n, const void* t,
                               int K, int blocks, void* partial, void* out,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K < 1 || K > kMaxK || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  che_partial<<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(probs), n, static_cast<const float*>(t), K,
      static_cast<float*>(partial));
  che_final<<<1, kThreads, 0, s>>>(static_cast<const float*>(partial), blocks, K,
                             static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
