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
// output tile, a trick for the matrix unit.  Here the queries arrive
// sorted by page (the wrapper sorts them once per call; a query's page does
// not depend on the row) and cut into tiles whose page windows
// [page[first] + d0, page[last] + d0 + w_chunk) fit kBins bins.  One block
// takes one (tile, row, band chunk [d0, d0 + w_chunk)):
//
// * each warp owns a private float64 histogram of the window in shared
//   memory and walks its share of the tile's queries in order; the lanes
//   of the warp cover the query's band (lane l adds entry lo + l, + 32, ...)
//   so no two lanes touch one bin and no shared-memory atomic is needed
//   (float64 and float32 shared atomicAdd are CAS loops on sm_90a);
// * a run of equal (page, key) queries, which a skewed workload's hot key
//   fills whole warps with, is added once, times its length;
// * the warps' histograms are then added bin by bin in warp order and each
//   nonzero bin goes to the global float64 histogram with one atomicAdd.
//   Only bins that another tile's window also covers are shared.
//
// Float64 throughout, rounded once to float32 by a second pass, as the host
// kernel rounds its float64 np.bincount: a hot bin collects thousands of
// fractional LUT entries.  Integer-mass LUTs are exact.
//
// Bound: the warp-serial work of each run (shuffles, index arithmetic and
// a warp barrier for a band that often fills few of the 32 lanes, then
// the float64 read-modify-writes in shared memory); the LUT (n_keys x W
// float32) is read through the read-only cache.  Global atomics fall to
// one per nonzero window bin.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 512;  // window bins a block holds (profile_grid.BINS)
constexpr unsigned kFull = 0xffffffffu;

// keys (K, Q) and pages (Q,) in page order; starts (n_tiles + 1,) tile
// bounds; acc (K, pad) float64.
__global__ void __launch_bounds__(kThreads) occupancy_kernel(
    const int* __restrict__ keys, const int* __restrict__ pages,
    const float* __restrict__ lut, const int* __restrict__ bands,
    const int* __restrict__ starts, int Q, int W, int c_ipp, int w_chunk,
    long long pad, double* __restrict__ acc,
    unsigned long long* __restrict__ flushes) {
  __shared__ double hist[kWarps][kBins];
  const int tile = blockIdx.x;
  const int k = blockIdx.y;
  const int d0 = blockIdx.z * w_chunk;
  const int wc = min(w_chunk, W - d0);
  const int q0 = starts[tile];
  const int q1 = starts[tile + 1];
  if (q0 >= q1) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p0 = pages[q0];
  const int nb = pages[q1 - 1] - p0 + wc;  // <= kBins by the tile plan
  double* hw = hist[warp];
  for (int b = lane; b < nb; b += 32) hw[b] = 0.0;
  __syncwarp();

  const int* row_keys = keys + static_cast<long long>(k) * Q;
  for (int base = q0 + 32 * warp; base < q1; base += 32 * kWarps) {
    const int i = base + lane;
    const bool valid = i < q1;
    const int key = valid ? row_keys[i] : -1;
    const int pg = valid ? pages[i] : 0;
    int lo = 0, hi = -1;
    if (key >= 0) {
      const int cls = key / c_ipp;
      lo = max(__ldg(bands + 2 * cls), d0) - d0;
      hi = min(__ldg(bands + 2 * cls + 1), d0 + wc - 1) - d0;
    }
    // run ends: a lane whose successor holds another (page, key)
    const int next_key = __shfl_down_sync(kFull, key, 1);
    const int next_pg = __shfl_down_sync(kFull, pg, 1);
    const bool end = valid && (lane == 31 || i + 1 >= q1 ||
                               next_key != key || next_pg != pg);
    unsigned ends = __ballot_sync(kFull, end);
    int prev = -1;
    while (ends) {
      const int j = __ffs(ends) - 1;
      ends &= ends - 1;
      const int run = j - prev;
      prev = j;
      const int kj = __shfl_sync(kFull, key, j);
      if (kj < 0) continue;  // uniform: a pad run
      const int pj = __shfl_sync(kFull, pg, j);
      const int lj = __shfl_sync(kFull, lo, j);
      const int hj = __shfl_sync(kFull, hi, j);
      const float* src = lut + static_cast<long long>(kj) * W + d0;
      double* dst = hw + (pj - p0);
      const double m = static_cast<double>(run);
      for (int d = lj + lane; d <= hj; d += 32)
        dst[d] += m * static_cast<double>(__ldg(src + d));
      __syncwarp();  // the next run's lanes may cover these bins
    }
  }
  __syncthreads();

  // warp histograms added in warp order; one global atomic per nonzero bin
  double* out = acc + static_cast<long long>(k) * pad + p0 + d0;
  unsigned nonzero = 0;
  for (int b0 = 0; b0 < nb; b0 += kThreads) {
    const int b = b0 + threadIdx.x;
    double s = 0.0;
    if (b < nb) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += hist[w][b];
      if (s != 0.0) {
        atomicAdd(out + b, s);
        ++nonzero;
      }
    }
  }
  if (flushes != nullptr) {  // a reading: one counter atomic per block
    __shared__ unsigned warp_flushes[kWarps];
    const unsigned w = __reduce_add_sync(kFull, nonzero);
    if (lane == 0) warp_flushes[warp] = w;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long n = 0;
      for (int v = 0; v < kWarps; ++v) n += warp_flushes[v];
      if (n) atomicAdd(flushes, n);
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

// keys (K, Q) int32 and pages (Q,) int32 sorted by page, lut (n_keys, W)
// float32 key-major, bands (n_keys / c_ipp, 2) int32 inclusive [lo, hi]
// band rows per class, starts (n_tiles + 1,) int32 tile bounds whose page
// windows satisfy page[last] - page[first] < window_pages; acc (K, pad)
// float64 scratch zeroed by the caller, out (K, pad) float32; flushes, when
// not null, a uint64 counter of global atomics.
extern "C" int profile_grid_launch(const void* keys, const void* pages,
                                   const void* lut, const void* bands,
                                   const void* starts, int K, int Q, int W,
                                   int c_ipp, int n_tiles,
                                   int window_pages, int w_chunk,
                                   long long pad, void* acc, void* out,
                                   void* flushes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_chunk < 1 || window_pages < 1 ||
      window_pages - 1 + w_chunk > kBins)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (W + w_chunk - 1) / w_chunk;
  if (n_tiles > 0 && K > 0 && chunks > 0) {
    occupancy_kernel<<<dim3(n_tiles, K, chunks), kThreads, 0, s>>>(
        static_cast<const int*>(keys), static_cast<const int*>(pages),
        static_cast<const float*>(lut), static_cast<const int*>(bands),
        static_cast<const int*>(starts), Q, W, c_ipp, w_chunk, pad,
        static_cast<double*>(acc),
        static_cast<unsigned long long*>(flushes));
  }
  const long long n_out = static_cast<long long>(K) * pad;
  if (n_out > 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    long long blocks = (n_out + kThreads - 1) / kThreads;
    if (blocks > 16LL * sms) blocks = 16LL * sms;
    round_to_float<<<static_cast<int>(blocks), kThreads, 0, s>>>(
        static_cast<const double*>(acc), n_out, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
