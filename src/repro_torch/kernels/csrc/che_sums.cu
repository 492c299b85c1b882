// che_sums: sum_i (1 - exp(-p_i * t_k)) for K candidate times in one pass.
//
// Replaces the Pallas kernel repro/kernels/che_solver.py::che_sums (body
// _kernel), the evaluator behind che_solve's K-way subdivision of Che's
// consistency condition C = sum_i (1 - exp(-p_i T)).  The whole solve has
// its own one-launch kernel (che_solve.cu); this is the public evaluator.
//
// The TPU kernel accumulated every program's block into one (1, K) output
// tile that the sequential grid revisited in order.  CUDA blocks run in no
// order, so each block reduces its share of the probabilities to K partial
// sums (a grid-stride pass, K float32 accumulators a thread, a warp-shuffle
// and shared-memory tree) and takes a ticket; the block that draws the
// last ticket adds all partials (a warp a candidate, in a fixed order) and
// resets the ticket to zero for the next call: one launch, and a result
// that does not depend on which block finishes last.  Each term is
// -expm1f(-p t), as in the TPU kernel (exact 0 for p = 0).
//
// The partials and the ticket are scratch that belongs to ONE stream: two
// calls that overlap on different streams must not share a ticket (the
// wrapper keeps one scratch per (device, stream)).
//
// Bound: the probabilities are read once (4 N bytes) and each of the N K
// terms is one expm1f and an add: at the CAM main path's N = 78,125 pages
// either takes a few microseconds, so one call is bound by its launch.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 16;

__global__ void __launch_bounds__(kThreads) che_sums_kernel(
    const float* __restrict__ probs, long long n,
    const float* __restrict__ t, int K, float* __restrict__ partial,
    unsigned int* __restrict__ ticket, float* __restrict__ out) {
  __shared__ float ts[kMaxK];
  __shared__ float warp_sums[kWarps][kMaxK];
  __shared__ bool last;
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
    for (int w = 0; w < kWarps; ++w) v += warp_sums[w][threadIdx.x];
    partial[static_cast<long long>(blockIdx.x) * K + threadIdx.x] = v;
    __threadfence();  // the partial is visible before the ticket is drawn
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // the last block: warp w adds candidate j = w (and w + 8) over all
  // blocks' partials, lane l taking blocks l, l + 32, ... in order, then a
  // butterfly: a fixed order.  L2 reads: other blocks wrote them.
  __threadfence();
  const int blocks = static_cast<int>(gridDim.x);
  for (int j = warp; j < K; j += kWarps) {
    float v = 0.f;
    for (int b = lane; b < blocks; b += 32)
      v += __ldcg(partial + static_cast<long long>(b) * K + j);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) out[j] = v;
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

}  // namespace

// probs (n,) float32, t (K,) float32 with 1 <= K <= 16, partial (blocks, K)
// float32 scratch, ticket one uint32 that is 0 on entry (and is again on
// exit), out (K,) float32.  blocks >= 1 is the caller's grid size.
extern "C" int che_sums_launch(const void* probs, long long n, const void* t,
                               int K, int blocks, void* partial, void* ticket,
                               void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K < 1 || K > kMaxK || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  che_sums_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(probs), n, static_cast<const float*>(t), K,
      static_cast<float*>(partial), static_cast<unsigned int*>(ticket),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
