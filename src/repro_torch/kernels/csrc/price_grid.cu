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
// Work split: one thread-block cluster of S CTAs per row (16 where the
// card can co-schedule that non-portable size, else 8).  Each CTA stages its
// ceil(P/S) slice of the row (probs, and wprobs when has_write) in shared
// memory once; a slice longer than the staging budget reads its tail
// through the read-only cache.  All cells of the row (in groups of up to
// 8) bisect in lockstep: each page value loaded feeds the
// occupancy of every cell's mid.  One step is one cross-CTA reduction:
// each CTA block-reduces its per-cell partials into a double-buffered
// slot, one cluster barrier, then every CTA reads the S slots of its peers
// (distributed shared memory, one load per lane) and adds them in one
// fixed order itself, so all CTAs of a row hold bit-identical totals and
// take the same lo/hi decisions.  A cell stops once mid equals lo or hi: no
// later step can move t_c = (lo + hi) / 2 off the value it has then, so
// the result is the 64-step one, and the exit is uniform over the cluster
// because the totals are.  Cells whose h does not read t_c (cap < 1,
// cap >= n_distinct, no sample) do not bisect.
//
// Bound: expm1f (LRU) or the Fricker division (FIFO) over P pages for
// every live cell and step.  expm1f and the division stay IEEE (no fast
// math): small p * t needs expm1, and the parity gates are float32-tight.
// The LFU, writeback, compulsory and sorted-scan tails run once per
// (row, cell) on CTA 0 after one more cross-CTA reduction.
//
// Argmin: Pallas carried it in a (1, 1) tile that every sequential program
// revisited; CUDA blocks run in no order, so each cell packs its objective
// into the high word of a 64-bit key (an order-preserving float -> uint32
// map, which also orders negative objectives) and its cell id into the low
// word, and takes one atomicMin: the lowest key is the lowest objective,
// then the lowest id.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;  // CTA size: 256, or 128 (see launch_rows)
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kF32Cols = 16;
constexpr int kI32Cols = 8;
constexpr int kPadId = 2147483647;
constexpr size_t kStageBytes = 96 * 1024;  // staged slice, per CTA
constexpr unsigned kFull = 0xffffffffu;

struct PriceArgs {
  int mode, has_sorted, has_write, iters, P, C, stage;
  const float* probs;
  const float* sorted_probs;
  const float* cov_desc;
  const float* wprobs;
  const float* wprobs_q;
  const float* f32s;
  const int* i32s;
  const float* caps_f;
  const int* caps_i;
  const int* ids;
  float* h_out;
  unsigned long long* best;
  int* steps;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Occupancy of a page with probability p at characteristic time t:
// Che (LRU, policy 0) or Fricker (FIFO, policy 1).
template <int kPol>
__device__ __forceinline__ float occupancy(float p, float t) {
  if (kPol == 0) return -expm1f(-p * t);
  return p * t / (1.f - p + p * t);
}

__device__ __forceinline__ float occupancy(int pol, float p, float t) {
  return pol == 0 ? occupancy<0>(p, t) : occupancy<1>(p, t);
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

// Shared state of one CTA for kG cells a group.  `part` is what the
// peers read.
template <int kG>
struct Shared {
  static constexpr int kVals = 3 * kG + 1;  // tail: h, wb, topc; w mass
  float red[kMaxWarps][kVals];
  float part[2][kVals];
  float tot[kVals];
  float lo[kG], hi[kG], c_eff[kG];
  int bisects[kG], steps[kG];
};

// Block-reduces n <= N per-thread partials into this CTA's slot `phase`
// and waits at the cluster barrier; the slot is then readable by every
// peer.  Slots alternate so that one is rewritten only after every peer
// has passed the barrier that follows its read of it.
template <int N, typename Sh>
__device__ __forceinline__ float* publish(const cg::cluster_group& cl,
                                          Sh& sh, const float (&v)[N], int n,
                                          int phase) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < n) {
      const float w = warp_sum(v[i]);
      if (lane == 0) sh.red[warp][i] = w;
    }
  }
  __syncthreads();
  float* slot = sh.part[phase & 1];
  if (threadIdx.x < n) {
    float t = 0.f;
    for (int w = 0; w < (blockDim.x >> 5); ++w) t += sh.red[w][threadIdx.x];
    slot[threadIdx.x] = t;
  }
  cl.sync();
  return slot;
}

// One bisection step's totals: thread (c, r) = (tid / S, tid % S) reads
// cell c's partial from CTA r, and a butterfly over those S lanes adds
// them.  Lane c * S receives cell c's total, added in the same fixed
// order in every CTA of the cluster, hence bit-identical everywhere.
template <int kG>
__device__ __forceinline__ float step_totals(const cg::cluster_group& cl,
                                             Shared<kG>& sh,
                                             const float (&s)[kG], int G,
                                             int phase, int S, int log2s) {
  float* slot = publish(cl, sh, s, G, phase);
  const int tid = threadIdx.x;
  const int c = tid >> log2s;
  float v = c < G ? *cl.map_shared_rank(slot + c, tid & (S - 1)) : 0.f;
  if ((tid & ~31) < G * S) {  // warps holding a (cell, rank) lane
    for (int o = S >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  }
  return v;
}

// Per-thread sums of one bisection step over this CTA's slice: staged
// pages from shared memory, the rest through the read-only cache.  Every
// cell is evaluated and the add masked (no branch per cell), so the kG
// independent expm1f/divide chains interleave.
template <int kPol, int kG>
__device__ __forceinline__ void add_occupancy(float pj,
                                              const float (&mid)[kG],
                                              const bool (&live)[kG],
                                              float (&s)[kG]) {
#pragma unroll
  for (int c = 0; c < kG; ++c) {
    const float o = occupancy<kPol>(pj, mid[c]);
    s[c] += live[c] ? o : 0.f;
  }
}

template <int kPol, int kG>
__device__ __forceinline__ void step_sums(const float* sp, const float* gp,
                                          int staged, int len,
                                          const float (&mid)[kG],
                                          const bool (&live)[kG],
                                          float (&s)[kG]) {
  int j = threadIdx.x;
  for (; j < staged; j += blockDim.x)
    add_occupancy<kPol>(sp[j], mid, live, s);
  for (; j < len; j += blockDim.x)
    add_occupancy<kPol>(__ldg(gp + j), mid, live, s);
}

// mode: 0 lru, 1 fifo, 2 lfu (one policy for the launch), 3 multi (each
// row reads its policy id from i32 column 3).  Grid (S, K), cluster (S);
// kG cells of the row bisect together (groups of kG for larger C).
template <int kG>
__global__ void __launch_bounds__(kMaxThreads, (kG <= 4 ? 4 : 3))
    price_kernel(const PriceArgs a) {
  using Sh = Shared<kG>;
  constexpr int kVals = Sh::kVals;
  extern __shared__ float stage_s[];  // [stage] probs, then [stage] wprobs
  __shared__ Sh sh;
  const cg::cluster_group cl = cg::this_cluster();
  const int ranks = static_cast<int>(cl.num_blocks());
  const int log2s = __ffs(ranks) - 1;
  const int rank = static_cast<int>(cl.block_rank());
  const int tid = threadIdx.x;
  const int k = blockIdx.y;
  const int P = a.P, C = a.C;
  const bool has_write = a.has_write != 0;
  const size_t row = static_cast<size_t>(k) * P;
  const float* f = a.f32s + static_cast<size_t>(k) * kF32Cols;
  const int* z = a.i32s + static_cast<size_t>(k) * kI32Cols;
  const int pol = a.mode < 3 ? a.mode : z[3];
  const bool recency = pol != 2;
  const float sample_refs = f[0], full = f[1], n_f = f[2], pmin = f[3];
  const int n_i = z[0];

  // this CTA's slice [j0, j0 + len) of the row
  const int slice = (P + ranks - 1) / ranks;
  const int j0 = min(P, rank * slice);
  const int len = min(P, j0 + slice) - j0;
  const int staged = recency ? min(len, a.stage) : 0;
  float* sp = stage_s;
  float* sw = stage_s + a.stage;
  const float* gp = a.probs + row + j0;
  const float* gw = has_write ? a.wprobs + row + j0 : nullptr;
  for (int j = tid; j < staged; j += blockDim.x) {
    sp[j] = gp[j];
    if (has_write) sw[j] = gw[j];
  }

  int phase = 0;
  for (int g0 = 0; g0 < C; g0 += kG) {
    const int G = min(kG, C - g0);
    const size_t cell0 = static_cast<size_t>(k) * C + g0;
    if (tid < kG) {
      int bis = 0;
      if (tid < G) {
        const int cap_i = a.caps_i[cell0 + tid];
        const float c_eff = fmaxf(a.caps_f[cell0 + tid], 1.f);
        sh.c_eff[tid] = c_eff;
        sh.lo[tid] = 0.f;
        sh.hi[tid] = fmaxf(4.f * c_eff / pmin, 1.f);
        bis = recency && cap_i >= 1 && cap_i < n_i && sample_refs > 0.f;
      }
      sh.bisects[tid] = bis;
      sh.steps[tid] = 0;
    }
    __syncthreads();  // also publishes the staged slice

    // ---- lockstep bisection for t_c: sum_j occ(p_j, t) = max(cap, 1)
    // lane c * S decides cell c
    const int decides = (tid & (ranks - 1)) == 0 && (tid >> log2s) < G
                            ? tid >> log2s : -1;
    if (recency) {
      for (int it = 0; it < a.iters; ++it) {
        float mid[kG];
        bool live[kG];
        bool any = false;
#pragma unroll
        for (int c = 0; c < kG; ++c) {
          const float l = sh.lo[c], h = sh.hi[c];
          mid[c] = 0.5f * (l + h);
          live[c] = sh.bisects[c] && mid[c] != l && mid[c] != h;
          any |= live[c];
        }
        if (!any) break;  // uniform over the cluster
        float s[kG];
#pragma unroll
        for (int c = 0; c < kG; ++c) s[c] = 0.f;
        if (pol == 0)
          step_sums<0>(sp, gp, staged, len, mid, live, s);
        else
          step_sums<1>(sp, gp, staged, len, mid, live, s);
        const float total = step_totals(cl, sh, s, G, phase++, ranks, log2s);
#pragma unroll
        for (int c = 0; c < kG; ++c) {
          if (c == decides && live[c]) {
            if (total - sh.c_eff[c] < 0.f)
              sh.lo[c] = mid[c];
            else
              sh.hi[c] = mid[c];
            ++sh.steps[c];
          }
        }
        __syncthreads();
      }
    }

    // ---- tail partials: h_pol, writeback, sorted top-C, write mass
    float v[kVals];
#pragma unroll
    for (int i = 0; i < kVals; ++i) v[i] = 0.f;
    if (recency) {
      float t_c[kG];
      bool act[kG];
      bool any = false;
#pragma unroll
      for (int c = 0; c < kG; ++c) {
        t_c[c] = 0.5f * (sh.lo[c] + sh.hi[c]);
        act[c] = sh.bisects[c] != 0;
        any |= act[c];
      }
      for (int j = tid; j < len; j += blockDim.x) {
        const float pj = j < staged ? sp[j] : __ldg(gp + j);
        const float wj = has_write ? (j < staged ? sw[j] : __ldg(gw + j))
                                   : 0.f;
        if (has_write) v[3 * kG] += wj;
        if (!any) continue;
#pragma unroll
        for (int c = 0; c < kG; ++c) {
          if (!act[c]) continue;
          const float o = occupancy(pol, pj, t_c[c]);
          v[c] += pj * o;
          if (has_write) {
            // dirty-eviction writeback at the same t_c
            const float r = fmaxf(pj - wj, 0.f);
            v[kG + c] += (1.f - o) * (wj + r * -expm1f(-wj * t_c[c]));
          }
        }
      }
    } else {
      // LFU: top-C mass of the descending-sorted row (and the write mass
      // kept by that resident set; the sorted scan's top-C coverage)
      int lim[kG], lim0[kG];
      int jmax = 0;
#pragma unroll
      for (int c = 0; c < kG; ++c) {
        const int cap_i = c < G ? a.caps_i[cell0 + c] : 0;
        lim[c] = c < G ? min(max(cap_i, 1), P) : 0;
        lim0[c] = c < G && a.has_sorted ? min(max(cap_i, 0), P) : 0;
        jmax = max(jmax, max(lim[c], lim0[c]));
      }
      const int end = has_write ? len : min(len, max(jmax - j0, 0));
      for (int j = tid; j < end; j += blockDim.x) {
        const int jg = j0 + j;
        const float sp_j = jg < jmax ? __ldg(a.sorted_probs + row + jg) : 0.f;
        const float wq = has_write && jg < jmax
                             ? __ldg(a.wprobs_q + row + jg) : 0.f;
        const float cv = a.has_sorted && jg < jmax
                             ? __ldg(a.cov_desc + row + jg) : 0.f;
        if (has_write) v[3 * kG] += __ldg(gw + j);
#pragma unroll
        for (int c = 0; c < kG; ++c) {
          if (jg < lim[c]) {
            v[c] += sp_j;
            v[kG + c] += wq;
          }
          if (jg < lim0[c]) v[2 * kG + c] += cv;
        }
      }
    }
    {
      // once a group: thread i adds value i over the CTAs in rank order
      const float* slot = publish(cl, sh, v, kVals, phase++);
      if (tid < kVals) {
        float t = 0.f;
        for (int r = 0; r < ranks; ++r)
          t += *cl.map_shared_rank(slot + tid, r);
        sh.tot[tid] = t;
      }
      __syncthreads();
    }

    // ---- per-cell tail on CTA 0
    if (rank == 0 && tid < G) {
      const size_t cell = cell0 + tid;
      const int cap_i = a.caps_i[cell];
      const float w_mass = sh.tot[3 * kG];
      float h_pol = sh.tot[tid];
      float floor_h = 0.f;
      if (has_write) {
        // recency: the writeback sum; LFU: the write mass the top C keep
        const float w_part = sh.tot[kG + tid];
        h_pol -= recency ? w_part : w_mass - w_part;
        floor_h = -w_mass;  // cap < 1: every write flushes
      }
      const float h_comp = full > 0.f ? (full - n_f) / fmaxf(full, 1.f) : 0.f;
      float h = cap_i >= n_i ? h_comp : h_pol;
      if (cap_i < 1) h = floor_h;
      if (!(sample_refs > 0.f)) h = 0.f;

      if (a.has_sorted) {
        const float s_r = f[4], s_full = f[5], s_n = f[6], pinned = f[7];
        const int s_n_i = z[1], s_min_i = z[2];
        float miss = s_n;  // recency rows: compulsory form
        if (pol == 2) {
          const float topc = sh.tot[2 * kG + tid];
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

      a.h_out[cell] = h;
      if (a.steps != nullptr) a.steps[cell] = sh.steps[tid];
      const int id = a.ids[cell];
      if (id < kPadId) atomicMin(a.best, pack_key((1.f - h) * f[8], id));
    }
  }
  cl.sync();  // peers may still read this CTA's slots
}

// Launches price_kernel<kG>: clusters of 16 CTAs a row (more, smaller
// CTAs balance the SMs better than fewer waves), with 256 threads a CTA,
// or 128 where that lets every row's cluster be resident at once (no
// tail wave); 8 CTAs a row only where the card cannot co-schedule 16.
template <int kG>
cudaError_t launch_rows(PriceArgs a, int K, cudaStream_t s) {
  auto kernel = price_kernel<kG>;
  const int arrays = a.has_write ? 2 : 1;
  const int stage_max =
      static_cast<int>(kStageBytes / (arrays * sizeof(float)));
  cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                       1);
  constexpr int kShapes = 4;  // (CTAs a row, threads a CTA)
  const int sizes[kShapes] = {16, 16, 8, 8};
  const int threads[kShapes] = {kMaxThreads, 128, kMaxThreads, 128};
  int fits[kShapes], stage[kShapes];
  cudaLaunchConfig_t cfg[kShapes] = {};
  cudaLaunchAttribute attr[kShapes][1];
  for (int i = 0; i < kShapes; ++i) {
    const int slice = (a.P + sizes[i] - 1) / sizes[i];
    stage[i] = slice < stage_max ? slice : stage_max;
    const size_t smem = static_cast<size_t>(stage[i]) * arrays * sizeof(float);
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    attr[i][0].id = cudaLaunchAttributeClusterDimension;
    attr[i][0].val.clusterDim.x = sizes[i];
    attr[i][0].val.clusterDim.y = 1;
    attr[i][0].val.clusterDim.z = 1;
    cfg[i].gridDim = dim3(sizes[i], K);
    cfg[i].blockDim = dim3(threads[i]);
    cfg[i].dynamicSmemBytes = smem;
    cfg[i].stream = s;
    cfg[i].attrs = attr[i];
    cfg[i].numAttrs = 1;
    if (cudaOccupancyMaxActiveClusters(&fits[i], kernel, &cfg[i]) !=
        cudaSuccess) {
      cudaGetLastError();  // this shape cannot launch: clear, go on
      fits[i] = 0;
    }
  }
  int pick = -1;
  for (int i = 0; i < kShapes && pick < 0; ++i)  // one wave, in order
    if (fits[i] >= K) pick = i;
  const int finest[kShapes] = {1, 3, 0, 2};  // else the smallest CTAs
  for (int i = 0; i < kShapes && pick < 0; ++i)
    if (fits[finest[i]] >= 1) pick = finest[i];
  if (pick < 0) return cudaErrorInvalidConfiguration;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(cfg[pick].dynamicSmemBytes));
  a.stage = stage[pick];
  return cudaLaunchKernelEx(&cfg[pick], kernel, a);
}

}  // namespace

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// steps, when not null, is a (K, C) int32 output: the bisection steps each
// cell ran.
extern "C" int price_grid_launch(
    int mode, int has_sorted, int has_write, int iters, int K, int P, int C,
    const void* probs, const void* sorted_probs, const void* cov_desc,
    const void* wprobs, const void* wprobs_q, const void* f32s,
    const void* i32s, const void* caps_f, const void* caps_i, const void* ids,
    void* h, void* best_key, void* best_val, void* best_id, void* steps,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* best = static_cast<unsigned long long*>(best_key);
  init_best<<<1, 1, 0, s>>>(best);
  if (K > 0 && C > 0) {
    PriceArgs a{mode, has_sorted, has_write, iters, P, C, 0,
                static_cast<const float*>(probs),
                static_cast<const float*>(sorted_probs),
                static_cast<const float*>(cov_desc),
                static_cast<const float*>(wprobs),
                static_cast<const float*>(wprobs_q),
                static_cast<const float*>(f32s),
                static_cast<const int*>(i32s),
                static_cast<const float*>(caps_f),
                static_cast<const int*>(caps_i),
                static_cast<const int*>(ids), static_cast<float*>(h), best,
                static_cast<int*>(steps)};
    // the smallest group of 1, 2, 4 or 8 cells that holds C (or 8)
    const cudaError_t err =
        C >= 5   ? launch_rows<8>(a, K, s)
        : C >= 3 ? launch_rows<4>(a, K, s)
        : C == 2 ? launch_rows<2>(a, K, s)
                 : launch_rows<1>(a, K, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  unpack_best<<<1, 1, 0, s>>>(best, static_cast<float*>(best_val),
                              static_cast<int*>(best_id));
  return static_cast<int>(cudaGetLastError());
}
