// profile_grid: mixed-eps page occupancy of a whole candidate grid on Hopper.
//
// Replaces the Pallas kernel repro/kernels/profile_grid.py::profile_grid
// (body _occupancy_kernel).  For every candidate row k and query q with a
// valid combined key (key = class * c_ipp + slot, -1 marks a pad) it adds
// the class's Eq. 12 LUT row to the padded histogram:
//
//     out[k, page[q] + d] += lut[key, d]    for d in the class's band
//
// The TPU kernel computed this as banded one-hot matmuls over a revisited
// output tile, a trick for the matrix unit.  Here it is the direct form:
// one thread per (k, q) in a grid-stride loop gathers its LUT row and
// atomically adds each nonzero entry.  The LUT is stored key-major
// (lut[key * W + d]) so one thread's band is contiguous; it is staged in
// shared memory when it fits a block, else read through the read-only
// cache.  Each class's band [lo, hi] limits the loop to the rows that can
// be nonzero, so a query costs its own window width, not the grid-wide one.
//
// Bins accumulate with float64 atomicAdd (native on Hopper) into a scratch
// histogram that one more pass rounds to float32, as the host kernel rounds
// its float64 np.bincount: a hot bin of a skewed workload collects
// thousands of fractional LUT entries, and float32 atomics would leave it
// ~1e-6 relative off depending on their order.  Integer-mass LUTs are
// exact either way.
//
// Bound: one float64 atomicAdd per nonzero (query, page) entry, into an
// L2-resident histogram; hot pages under skewed workloads contend.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool kStaged>
__global__ void __launch_bounds__(kThreads) occupancy_kernel(
    const int* __restrict__ keys, const int* __restrict__ pages,
    const float* __restrict__ lut_g, const int* __restrict__ bands,
    long long total, int Q, int W, int n_keys, int c_ipp, long long pad,
    double* __restrict__ acc) {
  extern __shared__ float lut_s[];
  const float* lut = lut_g;
  if (kStaged) {
    for (int i = threadIdx.x; i < n_keys * W; i += blockDim.x)
      lut_s[i] = lut_g[i];
    __syncthreads();
    lut = lut_s;
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    const int key = keys[i];
    if (key < 0) continue;
    const long long k = i / Q;
    const int q = static_cast<int>(i - k * Q);
    const int cls = key / c_ipp;
    const int lo = bands[2 * cls];
    const int hi = bands[2 * cls + 1];
    const float* src = lut + static_cast<long long>(key) * W;
    double* dst = acc + k * pad + pages[q];
    for (int d = lo; d <= hi; ++d) {
      const float v = kStaged ? src[d] : __ldg(src + d);
      if (v != 0.f) atomicAdd(dst + d, static_cast<double>(v));
    }
  }
}

__global__ void round_to_float(const double* __restrict__ acc, long long n,
                               float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    out[i] = static_cast<float>(acc[i]);
}

}  // namespace

// keys (K, Q) int32, pages (Q,) int32, lut (n_keys, W) float32 key-major,
// bands (n_keys / c_ipp, 2) int32 inclusive [lo, hi] band rows per class,
// acc (K, pad) float64 scratch zeroed by the caller, out (K, pad) float32.
extern "C" int profile_grid_launch(const void* keys, const void* pages,
                                   const void* lut, const void* bands, int K,
                                   int Q, int W, int n_keys, int c_ipp,
                                   long long pad, void* acc, void* out,
                                   int num_sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(K) * Q;
  const long long cap = static_cast<long long>(num_sms) * 16;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > cap) blocks = cap;
  const size_t lut_bytes = static_cast<size_t>(n_keys) * W * sizeof(float);
  // Stage the LUT when it leaves room for several blocks per SM.
  constexpr size_t kStageMax = 64 * 1024;
  if (total > 0 && lut_bytes <= kStageMax) {
    if (lut_bytes > 48 * 1024) {
      cudaFuncSetAttribute(occupancy_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(lut_bytes));
    }
    occupancy_kernel<true><<<static_cast<int>(blocks), kThreads, lut_bytes,
                             s>>>(
        static_cast<const int*>(keys), static_cast<const int*>(pages),
        static_cast<const float*>(lut), static_cast<const int*>(bands), total,
        Q, W, n_keys, c_ipp, pad, static_cast<double*>(acc));
  } else if (total > 0) {
    occupancy_kernel<false><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        static_cast<const int*>(keys), static_cast<const int*>(pages),
        static_cast<const float*>(lut), static_cast<const int*>(bands), total,
        Q, W, n_keys, c_ipp, pad, static_cast<double*>(acc));
  }
  const long long n_out = static_cast<long long>(K) * pad;
  long long out_blocks = (n_out + kThreads - 1) / kThreads;
  if (out_blocks > cap) out_blocks = cap;
  if (n_out > 0) {
    round_to_float<<<static_cast<int>(out_blocks), kThreads, 0, s>>>(
        static_cast<const double*>(acc), n_out, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
