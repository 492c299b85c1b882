// price_grid: the fused PriceTable solve on Hopper.
//
// Replaces the Pallas kernel repro/kernels/price_grid.py::price_grid (body
// _price_kernel): for every (profile row k, capacity cell c) of a padded
// (K x C) table it solves the policy fixed point against row k's request
// probabilities, composes the writeback and sorted-scan terms, writes the
// hit rate h[k, c] and folds the objective (1 - h) * scale into a global
// argmin with lowest-cell-id ties.  Semantics follow
// repro_torch/kernels/price_grid.py::price_grid_ref branch for branch.
//
// Work split: one thread block per (row, cell), so a tuner table of ~20-80
// rows x ~4 cells spreads over the 132 SMs instead of idling most of them
// with one block per row.  Bound: the recency policies run a 64-step
// bisection, each step a block-wide reduction over the P pages of the row
// (strided coalesced loads, warp shuffles, one shared-memory exchange), so
// the kernel is bound by the expm1f/divide work of 64 passes over the row;
// the row (P floats, 312 KB at P = 78,125) is read from L2 after the first
// pass.  The ragged P edge is masked, not padded.  LFU rows read prefix
// sums of the pre-sorted rows, limited to the first cap entries.
//
// Argmin: Pallas carried it in a (1, 1) tile that every sequential program
// revisited; CUDA blocks run in no order, so each block packs its objective
// into the high word of a 64-bit key (an order-preserving float -> uint32
// map, which also orders negative objectives) and its cell id into the low
// word, and takes one atomicMin: the lowest key is the lowest objective,
// then the lowest id.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kF32Cols = 16;
constexpr int kI32Cols = 8;
constexpr int kPadId = 2147483647;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block; every thread receives the total.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // the previous call's readers are done with scratch
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  return warp_sum(lane < kWarps ? scratch[lane] : 0.f);
}

// Occupancy of a page with probability p at characteristic time t:
// Che (LRU, policy 0) or Fricker (FIFO, policy 1).
__device__ __forceinline__ float occupancy(int pol, float p, float t) {
  if (pol == 0) return -expm1f(-p * t);
  return p * t / (1.f - p + p * t);
}

__device__ __forceinline__ unsigned long long pack_key(float v, int id) {
  if (v == 0.f) v = 0.f;  // -0 and +0 tie, as in a float compare
  unsigned int u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) |
         static_cast<unsigned int>(id);
}

__global__ void init_best(unsigned long long* best) {
  *best = pack_key(__int_as_float(0x7f800000), kPadId);  // (inf, PAD_ID)
}

__global__ void unpack_best(const unsigned long long* best, float* best_val,
                            int* best_id) {
  const unsigned long long b = *best;
  unsigned int u = static_cast<unsigned int>(b >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  *best_val = __uint_as_float(u);
  *best_id = static_cast<int>(b & 0xffffffffu);
}

// mode: 0 lru, 1 fifo, 2 lfu (one policy for the launch), 3 multi (each
// row reads its policy id from i32 column 3).
__global__ void __launch_bounds__(kThreads) price_kernel(
    int mode, int has_sorted, int has_write, int iters, int P, int C,
    const float* __restrict__ probs, const float* __restrict__ sorted_probs,
    const float* __restrict__ cov_desc, const float* __restrict__ wprobs,
    const float* __restrict__ wprobs_q, const float* __restrict__ f32s,
    const int* __restrict__ i32s, const float* __restrict__ caps_f,
    const int* __restrict__ caps_i, const int* __restrict__ ids,
    float* __restrict__ h_out, unsigned long long* __restrict__ best) {
  __shared__ float scratch[kWarps];
  const int c = blockIdx.x;
  const int k = blockIdx.y;
  const size_t row = static_cast<size_t>(k) * P;
  const size_t cell = static_cast<size_t>(k) * C + c;
  const float* p = probs + row;
  const float* f = f32s + static_cast<size_t>(k) * kF32Cols;
  const int* z = i32s + static_cast<size_t>(k) * kI32Cols;
  const int pol = mode < 3 ? mode : z[3];
  const float sample_refs = f[0], full = f[1], n_f = f[2], pmin = f[3];
  const int n_i = z[0];
  const int cap_i = caps_i[cell];
  const float c_eff = fmaxf(caps_f[cell], 1.f);

  float w_mass = 0.f;
  if (has_write) {
    float s = 0.f;
    for (int j = threadIdx.x; j < P; j += kThreads) s += wprobs[row + j];
    w_mass = block_sum(s, scratch);
  }

  float h_pol, wb = 0.f;
  if (pol != 2) {
    // lockstep bisection for t_c: sum_j occ(p_j, t) = max(cap, 1)
    float lo = 0.f, hi = fmaxf(4.f * c_eff / pmin, 1.f);
    for (int it = 0; it < iters; ++it) {
      const float mid = 0.5f * (lo + hi);
      float s = 0.f;
      for (int j = threadIdx.x; j < P; j += kThreads)
        s += occupancy(pol, p[j], mid);
      const float val = block_sum(s, scratch) - c_eff;
      if (val < 0.f) lo = mid; else hi = mid;
    }
    const float t_c = 0.5f * (lo + hi);
    float s = 0.f, sw = 0.f;
    for (int j = threadIdx.x; j < P; j += kThreads) {
      const float pj = p[j];
      const float o = occupancy(pol, pj, t_c);
      s += pj * o;
      if (has_write) {
        // dirty-eviction writeback at the same t_c
        const float w = wprobs[row + j];
        const float r = fmaxf(pj - w, 0.f);
        sw += (1.f - o) * (w + r * -expm1f(-w * t_c));
      }
    }
    h_pol = block_sum(s, scratch);
    if (has_write) wb = block_sum(sw, scratch);
  } else {
    // LFU: top-C mass of the descending-sorted row (and the write mass
    // kept by that resident set)
    const int lim = min(max(cap_i, 1), P);
    float s = 0.f, sw = 0.f;
    for (int j = threadIdx.x; j < lim; j += kThreads) {
      s += sorted_probs[row + j];
      if (has_write) sw += wprobs_q[row + j];
    }
    h_pol = block_sum(s, scratch);
    if (has_write) wb = w_mass - block_sum(sw, scratch);
  }

  float floor_h = 0.f;
  if (has_write) {
    h_pol -= wb;
    floor_h = -w_mass;  // cap < 1: every write flushes
  }
  const float h_comp = full > 0.f ? (full - n_f) / fmaxf(full, 1.f) : 0.f;
  float h = cap_i >= n_i ? h_comp : h_pol;
  if (cap_i < 1) h = floor_h;
  if (!(sample_refs > 0.f)) h = 0.f;

  if (has_sorted) {
    const float s_r = f[4], s_full = f[5], s_n = f[6], pinned = f[7];
    const int s_n_i = z[1], s_min_i = z[2];
    float miss = s_n;  // recency rows: compulsory form
    if (pol == 2) {
      const int lim = min(max(cap_i, 0), P);
      float s = 0.f;
      for (int j = threadIdx.x; j < lim; j += kThreads) s += cov_desc[row + j];
      const float topc = block_sum(s, scratch);
      const float freq =
          fminf(fmaxf(fminf(s_r - topc, s_r - pinned), s_n), s_r);
      miss = cap_i >= s_n_i ? s_n : freq;
    }
    if (cap_i < s_min_i) miss = fminf(fmaxf(s_r - pinned, s_n), s_r);
    const float h_s = s_r > 0.f ? (s_r - miss) / fmaxf(s_r, 1.f) : 0.f;
    const float total = full + s_full;
    const float miss_mix = (1.f - h) * full + (1.f - h_s) * s_full;
    h = total > 0.f ? 1.f - miss_mix / fmaxf(total, 1.f) : 0.f;
  }

  if (threadIdx.x == 0) {
    h_out[cell] = h;
    const int id = ids[cell];
    if (id < kPadId) atomicMin(best, pack_key((1.f - h) * f[8], id));
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int price_grid_launch(
    int mode, int has_sorted, int has_write, int iters, int K, int P, int C,
    const void* probs, const void* sorted_probs, const void* cov_desc,
    const void* wprobs, const void* wprobs_q, const void* f32s,
    const void* i32s, const void* caps_f, const void* caps_i, const void* ids,
    void* h, void* best_key, void* best_val, void* best_id, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* best = static_cast<unsigned long long*>(best_key);
  init_best<<<1, 1, 0, s>>>(best);
  if (K > 0 && C > 0) {
    price_kernel<<<dim3(C, K), kThreads, 0, s>>>(
        mode, has_sorted, has_write, iters, P, C,
        static_cast<const float*>(probs),
        static_cast<const float*>(sorted_probs),
        static_cast<const float*>(cov_desc),
        static_cast<const float*>(wprobs),
        static_cast<const float*>(wprobs_q),
        static_cast<const float*>(f32s), static_cast<const int*>(i32s),
        static_cast<const float*>(caps_f), static_cast<const int*>(caps_i),
        static_cast<const int*>(ids), static_cast<float*>(h), best);
  }
  unpack_best<<<1, 1, 0, s>>>(best, static_cast<float*>(best_val),
                              static_cast<int*>(best_id));
  return static_cast<int>(cudaGetLastError());
}
