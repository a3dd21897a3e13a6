// Per-scan quantile min-max normalisation for Hopper (sm_90a).
//
// Two kernels behind a plain C interface, loaded with ctypes by
// ops/_native.py and wrapped by ops/hopper_norm.py:
//
// minmax_select (replaces multimodal_alzheimer_tpu/ops/pallas_norm.py
//   _minmax_select_kernel): exact order statistics of {x*m != 0} for each
//   scan at ranks lo = floor(q*(n-1)) (f32 arithmetic) and the lo+1
//   neighbour, for up to 8 levels q passed by value in the launch (no copy
//   from host memory). Values map to order-preserving 32-bit keys; the
//   select is an 8-bit digit radix select, most significant digit first.
//   The TPU kernel keeps one scan's 3.6 MB of keys in VMEM. Here the scan is
//   held the same way, in the distributed shared memory of one thread-block
//   cluster per scan (scan_cluster.cuh: 16 blocks of 1024 threads at
//   91x109x91, 56,416 keys a block), so the whole select is one launch with
//   no workspace:
//   * each block reads its stretch of volume and mask once (16-byte loads),
//     writes the keys to shared memory, counts its valid voxels and builds
//     the histogram of the top digit as it goes;
//   * after a cluster barrier every block adds the cluster's counts and
//     histograms over distributed shared memory (integers: exact in any
//     order) and fixes the same digit for each level; the three lower
//     digits follow, each one pass over the keys in shared memory counting
//     only the keys that match the digits fixed so far, one barrier each;
//   * the last digit's count says whether rank lo+1 holds the same key;
//     where it does not, one more pass finds the smallest key above it.
//   Every histogram add is one shared-memory atomic per key. (Adds
//   aggregated across a warp, bin by bin or by __match_any_sync, were
//   slower on an H100, though MRI intensities crowd the top digit's few
//   exponent bins; PERF.md has the times.)
//   Bound: memory, 8 bytes read per voxel (57.8 MB at batch 8, 0.0172 ms
//   at 3.35 TB/s); the digit passes run on shared memory.
//   A scan too large for 16 blocks' shared memory (more than about 3.7
//   million voxels) takes the earlier route, chosen from N before launch:
//   keys in a device-memory workspace, one keys pass, four histogram
//   passes and one neighbour pass, 12 launches.
//
// minmax_apply (replaces pallas_norm.py _minmax_apply_kernel):
//   clamp((x - qmin[b]) / (qmax[b] - qmin[b]), 0, 1) * m, one elementwise
//   pass. Bound: memory, 8 bytes read and 4 written per voxel. The design
//   uses 16-byte vector loads and stores over each scan's aligned body and
//   scalar accesses for the unaligned head and tail.
//
// Exactness: every floating-point operation is written as an _rn intrinsic,
// so the results do not depend on contraction or fast-math flags; keys are
// unsigned integers, so the selection is exact and deterministic.
//
// Each entry point takes device pointers, int64 sizes, the device index and
// a cudaStream_t, allocates nothing, and returns the first CUDA error seen
// (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "scan_cluster.cuh"

// The quantile levels, passed by value in the launch arguments.
struct Levels {
  float q[8];
  int32_t count;
};

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kBins = 256;
constexpr int kDigitPasses = 4;
constexpr int kMaxTargets = 8;
// An invalid voxel (x*m == 0) takes the key of +inf, as the plain version
// sorts it: above every finite value and below NaN, which its sort puts
// last (x*m computed here is NaN with the bits 0x7FFFFFFF, key 0xFFFFFFFF).
// So a scan with no valid voxel gets +inf for both statistics, as there.
constexpr uint32_t kInvalidKey = 0xFF800000u;
// Larger than every key: no neighbour found; slots outside a stretch.
constexpr uint32_t kNoKey = 0xFFFFFFFFu;

// Selection state of one (scan, target) pair; lives in the workspace.
struct Target {
  uint32_t prefix;  // key digits fixed so far; k_lo after the last pass
  uint32_t rank;    // rank still to find among keys matching the prefix
  int32_t lo;       // floor(q * (n - 1)), unclamped, as the TPU kernel has it
  uint32_t count_le;  // keys <= k_lo (neighbour pass)
  uint32_t next;      // smallest key > k_lo (neighbour pass), kNoKey if none
};

// Order-preserving map of a float's bits to an unsigned key: negatives get
// every bit flipped, non-negatives get the sign bit set.
__device__ __forceinline__ uint32_t float_key(float v) {
  const uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__global__ void keys_kernel(const float* __restrict__ vol,
                            const float* __restrict__ mask,
                            uint32_t* __restrict__ keys,
                            uint32_t* __restrict__ count, int64_t n) {
  __shared__ uint32_t block_count;
  if (threadIdx.x == 0) block_count = 0;
  __syncthreads();
  const int64_t row = static_cast<int64_t>(blockIdx.y) * n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  uint32_t valid = 0;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float v = __fmul_rn(vol[row + i], mask[row + i]);
    const bool ok = v != 0.0f;  // excludes +-0; NaN counts as valid
    keys[row + i] = ok ? float_key(v) : kInvalidKey;
    valid += ok;
  }
  if (valid) atomicAdd(&block_count, valid);
  __syncthreads();
  if (threadIdx.x == 0 && block_count) atomicAdd(count + blockIdx.y, block_count);
}

// lo = floor(q * (n - 1)) in f32, as the plain version and the TPU kernel.
__device__ __forceinline__ int32_t low_rank(float q, uint32_t n_valid) {
  return static_cast<int32_t>(
      floorf(__fmul_rn(q, __fsub_rn(static_cast<float>(n_valid), 1.0f))));
}

// Whether rank lo + 1 holds no other key than rank lo: duplicates cover it
// (`equal` keys equal k_lo, of which k_lo is number `within`), or lo + 1 is
// past the last valid rank.
__device__ __forceinline__ bool same_neighbour(uint32_t equal, uint32_t within,
                                               int32_t lo, uint32_t n_valid) {
  return static_cast<int64_t>(equal) > static_cast<int64_t>(within) + 1 ||
         __fadd_rn(static_cast<float>(lo), 1.0f) >= static_cast<float>(n_valid);
}

__global__ void init_targets_kernel(const uint32_t* __restrict__ count,
                                    Levels levels,
                                    Target* __restrict__ targets, int64_t batch,
                                    int64_t n_qs, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= batch * n_qs) return;
  const int32_t lo = low_rank(levels.q[i % n_qs], count[i / n_qs]);
  // A scan with no valid voxel (lo < 0) selects rank 0 among its invalid
  // keys: in bounds, and its result is meaningless by definition.
  int64_t rank = lo < 0 ? 0 : lo;
  if (rank > n - 1) rank = n - 1;
  targets[i] = Target{0u, static_cast<uint32_t>(rank), lo, 0u, kNoKey};
}

__global__ void digit_hist_kernel(const uint32_t* __restrict__ keys, int64_t n,
                                  const Target* __restrict__ targets, int n_qs,
                                  int shift, uint32_t* __restrict__ hist) {
  __shared__ uint32_t block_hist[kMaxTargets * kBins];
  for (int i = threadIdx.x; i < n_qs * kBins; i += blockDim.x) block_hist[i] = 0;
  const int64_t scan = blockIdx.y;
  // Bits above the current digit; zero on the first (most significant) pass.
  const uint32_t high = shift == 24 ? 0u : (0xFFFFFFFFu << (shift + 8));
  uint32_t prefix[kMaxTargets];
#pragma unroll
  for (int t = 0; t < kMaxTargets; ++t)
    prefix[t] = t < n_qs ? targets[scan * n_qs + t].prefix : 0u;
  __syncthreads();

  const int64_t row = scan * n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const uint32_t key = keys[row + i];
    const uint32_t digit = (key >> shift) & 0xFFu;
#pragma unroll
    for (int t = 0; t < kMaxTargets; ++t)
      if (t < n_qs && (key & high) == prefix[t])
        atomicAdd(&block_hist[t * kBins + digit], 1u);
  }
  __syncthreads();
  uint32_t* out = hist + scan * n_qs * kBins;
  for (int i = threadIdx.x; i < n_qs * kBins; i += blockDim.x)
    if (block_hist[i]) atomicAdd(out + i, block_hist[i]);
}

// One thread per (scan, target): walk the 256 bins, fix the digit that holds
// the remaining rank, and reduce the rank by the keys below that digit.
__global__ void digit_pick_kernel(const uint32_t* __restrict__ hist,
                                  Target* __restrict__ targets, int64_t n_targets,
                                  int shift) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_targets) return;
  const uint32_t* h = hist + i * kBins;
  const uint32_t rank = targets[i].rank;
  uint32_t below = 0;
  int digit = 0;
  for (; digit < kBins - 1; ++digit) {
    const uint32_t c = h[digit];
    if (rank < below + c) break;
    below += c;
  }
  targets[i].prefix |= static_cast<uint32_t>(digit) << shift;
  targets[i].rank = rank - below;
}

// Count of keys <= k_lo and the smallest key > k_lo, for each target.
__global__ void neighbour_kernel(const uint32_t* __restrict__ keys, int64_t n,
                                 Target* __restrict__ targets, int n_qs) {
  __shared__ uint32_t block_le[kMaxTargets];
  __shared__ uint32_t block_next[kMaxTargets];
  if (threadIdx.x < kMaxTargets) {
    block_le[threadIdx.x] = 0;
    block_next[threadIdx.x] = kNoKey;
  }
  const int64_t scan = blockIdx.y;
  uint32_t k_lo[kMaxTargets], le[kMaxTargets], next[kMaxTargets];
#pragma unroll
  for (int t = 0; t < kMaxTargets; ++t) {
    k_lo[t] = t < n_qs ? targets[scan * n_qs + t].prefix : 0u;
    le[t] = 0;
    next[t] = kNoKey;
  }
  __syncthreads();

  const int64_t row = scan * n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const uint32_t key = keys[row + i];
#pragma unroll
    for (int t = 0; t < kMaxTargets; ++t) {
      if (t >= n_qs) continue;
      if (key <= k_lo[t]) {
        ++le[t];
      } else if (key < next[t]) {
        next[t] = key;
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kMaxTargets; ++t) {
    if (t >= n_qs) continue;
    if (le[t]) atomicAdd(&block_le[t], le[t]);
    if (next[t] != kNoKey) atomicMin(&block_next[t], next[t]);
  }
  __syncthreads();
  if (threadIdx.x < n_qs) {
    Target* tg = targets + scan * n_qs + threadIdx.x;
    if (block_le[threadIdx.x]) atomicAdd(&tg->count_le, block_le[threadIdx.x]);
    if (block_next[threadIdx.x] != kNoKey)
      atomicMin(&tg->next, block_next[threadIdx.x]);
  }
}

// out row: [n, k_lo(q0), k_hi(q0), k_lo(q1), k_hi(q1), ...] as in the TPU
// kernel. k_hi is k_lo when duplicates cover rank lo+1 or lo+1 is past the
// last valid rank, else the smallest key above k_lo.
__global__ void finish_kernel(const uint32_t* __restrict__ count,
                              const Target* __restrict__ targets, int64_t batch,
                              int64_t n_qs, int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= batch * n_qs) return;
  const int64_t scan = i / n_qs, t = i % n_qs;
  const Target tg = targets[i];
  const uint32_t n_valid = count[scan];
  const bool same =
      static_cast<int64_t>(tg.count_le) > static_cast<int64_t>(tg.lo) + 1 ||
      __fadd_rn(static_cast<float>(tg.lo), 1.0f) >= static_cast<float>(n_valid);
  int32_t* row = out + scan * (1 + 2 * n_qs);
  if (t == 0) row[0] = static_cast<int32_t>(n_valid);
  row[1 + 2 * t] = static_cast<int32_t>(tg.prefix);
  row[2 + 2 * t] = static_cast<int32_t>(same ? tg.prefix : tg.next);
}

// ------------------------------------------------ one cluster per scan --

constexpr int kClusterThreads = scan_cluster::kThreads;
constexpr unsigned kFull = 0xFFFFFFFFu;
// Levels one pass serves: one 256-thread quarter of the block each for the
// digit picks, one 1 KB histogram each, double-buffered across passes.
constexpr int kGroup = kClusterThreads / kBins;

// Per-block state beside the keys and the histograms.
struct SelectState {
  uint32_t warp[scan_cluster::kWarps];  // per-warp scan totals and minima
  uint32_t valid;                       // this block's valid voxels
  uint32_t n_valid;                     // the scan's, added over the cluster
  uint32_t next[kGroup];    // this block's smallest key above k_lo
  uint32_t prefix[kGroup];  // digits fixed so far; k_lo after the last pass
  uint32_t rank[kGroup];    // rank still to find among keys on the prefix
  uint32_t equal[kGroup];   // keys equal to k_lo, after the last pass
  int32_t lo[kGroup];
};

// Shared memory of a block beside its keys.
constexpr int64_t select_extra(int group) {
  return 2 * static_cast<int64_t>(group) * kBins * sizeof(uint32_t) +
         static_cast<int64_t>((sizeof(SelectState) + 15) / 16 * 16);
}

// The digit of each level from the cluster's histogram: thread t * 256 + b
// holds the count of bin b for level t (`count`); the bin whose keys hold
// the remaining rank is fixed into the prefix, and the rank reduced by the
// keys in the bins below it. Every thread of the block calls it.
__device__ __forceinline__ void pick_digit(SelectState* st, uint32_t count,
                                           int levels, int shift) {
  const int t = threadIdx.x / kBins, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  uint32_t incl = count;
#pragma unroll
  for (int offset = 1; offset < 32; offset <<= 1) {
    const uint32_t up = __shfl_up_sync(kFull, incl, offset);
    if (lane >= offset) incl += up;
  }
  if (lane == 31) st->warp[warp] = incl;
  __syncthreads();
  for (int w = t * (kBins / 32); w < warp; ++w) incl += st->warp[w];
  const uint32_t rank = st->rank[t < levels ? t : 0];
  const uint32_t excl = incl - count;
  __syncthreads();  // every rank and warp total read before they change
  if (t < levels && count && excl <= rank && rank < incl) {
    st->prefix[t] |= static_cast<uint32_t>(threadIdx.x % kBins) << shift;
    st->rank[t] = rank - excl;
    st->equal[t] = count;
  }
  __syncthreads();
}

// Sum over the cluster, in rank order, of word `i` of every block's
// histogram buffer `hist`.
__device__ __forceinline__ uint32_t cluster_count(cg::cluster_group& cluster,
                                                  uint32_t* hist, int i) {
  uint32_t total = 0;
  for (unsigned r = 0; r < cluster.num_blocks(); ++r)
    total += cluster.map_shared_rank(hist, r)[i];
  return total;
}

// Grid: one cluster of `blocks` blocks per scan. Dynamic shared memory:
// the stretch's keys (scan_cluster::slots words), two histogram buffers of
// `group` levels, then SelectState.
__global__ void __launch_bounds__(kClusterThreads, 1)
    select_cluster_kernel(const float* __restrict__ vol,
                          const float* __restrict__ mask, int64_t n,
                          int64_t per, int group, Levels levels, bool vec,
                          int32_t* __restrict__ out) {
  extern __shared__ uint4 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int64_t blocks = cluster.num_blocks();
  const int64_t scan = blockIdx.x / blocks;
  const float* v = vol + scan * n;
  const float* m = mask + scan * n;
  const scan_cluster::Stretch s =
      scan_cluster::block_stretch(v, n, per, rank, vec);
  const int64_t chunks = scan_cluster::slots(n, blocks) / 4;
  uint4* keys4 = smem;
  uint32_t* hist = reinterpret_cast<uint32_t*>(smem + chunks);
  SelectState* st = reinterpret_cast<SelectState*>(hist + 2 * group * kBins);
  const int lane = threadIdx.x % 32;

  // Keys, valid count and top-digit histogram (buffer 0, level slot 0):
  // the volume lands in the key slots, and each thread turns its own
  // chunks into keys in place.
  if (threadIdx.x < kBins) hist[threadIdx.x] = 0;
  const scan_cluster::MaskBits mb = scan_cluster::stage(
      v, m, s, vec, chunks, reinterpret_cast<float4*>(keys4));
  __syncthreads();
  uint32_t valid = 0;
#pragma unroll
  for (int k = 0; k < scan_cluster::kMaxChunks; ++k) {
    const int64_t c = threadIdx.x + static_cast<int64_t>(k) * kClusterThreads;
    uint32_t key[4] = {kNoKey, kNoKey, kNoKey, kNoKey};
    if (c < chunks) {
      const float4 x4 = reinterpret_cast<const float4*>(keys4)[c];
      const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
      const int64_t e = s.base + 4 * c;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!scan_cluster::inside(s, e + j)) continue;
        const float val = __fmul_rn(xs[j], mb.at(m, s, e, k, j));
        const bool ok = val != 0.0f;  // NaN is valid
        key[j] = ok ? float_key(val) : kInvalidKey;
        valid += ok;
      }
      keys4[c] = make_uint4(key[0], key[1], key[2], key[3]);
    }
    if (c < chunks) {
#pragma unroll
      for (int j = 0; j < 4; ++j) atomicAdd(hist + (key[j] >> 24), 1u);
    }
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    valid += __shfl_down_sync(kFull, valid, offset);
  if (lane == 0) st->warp[threadIdx.x / 32] = valid;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t total = 0;
    for (int w = 0; w < scan_cluster::kWarps; ++w) total += st->warp[w];
    st->valid = total;
  }
  cluster.sync();

  if (threadIdx.x == 0) {
    uint32_t total = 0;
    for (unsigned r = 0; r < static_cast<unsigned>(blocks); ++r)
      total += *cluster.map_shared_rank(&st->valid, r);
    st->n_valid = total;
  }
  // Thread t * 256 + b keeps the cluster's count of top digit b.
  const uint32_t top = cluster_count(cluster, hist, threadIdx.x % kBins);
  __syncthreads();
  const uint32_t n_valid = st->n_valid;
  const int64_t total_keys = blocks * chunks * 4;
  int32_t* row = out + scan * (1 + 2 * levels.count);
  if (rank == 0 && threadIdx.x == 0) row[0] = static_cast<int32_t>(n_valid);

  for (int t0 = 0; t0 < levels.count; t0 += group) {
    const int here = levels.count - t0 < group ? levels.count - t0 : group;
    if (threadIdx.x < here) {
      const int32_t lo = low_rank(levels.q[t0 + threadIdx.x], n_valid);
      // A scan with no valid voxel (lo < 0) selects rank 0: +inf.
      int64_t r = lo < 0 ? 0 : lo;
      if (r > total_keys - 1) r = total_keys - 1;
      st->lo[threadIdx.x] = lo;
      st->rank[threadIdx.x] = static_cast<uint32_t>(r);
      st->prefix[threadIdx.x] = 0u;
      st->equal[threadIdx.x] = 0u;
    }
    __syncthreads();
    pick_digit(st, top, here, 24);

    // The three lower digits, over the keys in shared memory. Pass p uses
    // histogram buffer p % 2: a buffer is published at one cluster barrier
    // and read before the next, so it is free again after that one.
    for (int p = 1; p < 4; ++p) {
      const int shift = 24 - 8 * p;
      const uint32_t high = 0xFFFFFFFFu << (shift + 8);
      uint32_t* buf = hist + (p % 2) * group * kBins;
      for (int i = threadIdx.x; i < here * kBins; i += kClusterThreads) buf[i] = 0;
      uint32_t prefix[kGroup];
#pragma unroll
      for (int t = 0; t < kGroup; ++t) prefix[t] = t < here ? st->prefix[t] : 0u;
      __syncthreads();
      for (int64_t c0 = 0; c0 < chunks; c0 += kClusterThreads) {
        const int64_t c = c0 + threadIdx.x;
        const uint4 q4 = c < chunks ? keys4[c]
                                    : make_uint4(kNoKey, kNoKey, kNoKey,
                                                 kNoKey);
        const uint32_t k[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int t = 0; t < kGroup; ++t)
            if (t < here && c < chunks && (k[j] & high) == prefix[t])
              atomicAdd(buf + t * kBins + ((k[j] >> shift) & 0xFFu), 1u);
      }
      cluster.sync();
      const int t = threadIdx.x / kBins;
      const uint32_t count =
          t < here ? cluster_count(cluster, buf, threadIdx.x) : 0u;
      pick_digit(st, count, here, shift);
    }

    // k_lo is fixed. Where rank lo + 1 holds another key, it is the
    // smallest key above k_lo.
    bool need_next = false;
    for (int t = 0; t < here; ++t)
      need_next |= !same_neighbour(st->equal[t], st->rank[t], st->lo[t],
                                   n_valid);
    if (need_next) {
      for (int t = 0; t < here; ++t) {
        const uint32_t k_lo = st->prefix[t];
        uint32_t next = kNoKey;
        for (int64_t c = threadIdx.x; c < chunks; c += kClusterThreads) {
          const uint4 q4 = keys4[c];
          if (q4.x > k_lo && q4.x < next) next = q4.x;
          if (q4.y > k_lo && q4.y < next) next = q4.y;
          if (q4.z > k_lo && q4.z < next) next = q4.z;
          if (q4.w > k_lo && q4.w < next) next = q4.w;
        }
        next = __reduce_min_sync(kFull, next);
        if (lane == 0) st->warp[threadIdx.x / 32] = next;
        __syncthreads();
        if (threadIdx.x < 32) {
          next = __reduce_min_sync(kFull, st->warp[threadIdx.x]);
          if (threadIdx.x == 0) st->next[t] = next;
        }
        __syncthreads();
      }
      cluster.sync();
    }
    if (rank == 0 && threadIdx.x < here) {
      const int t = threadIdx.x;
      uint32_t k_hi = st->prefix[t];
      if (!same_neighbour(st->equal[t], st->rank[t], st->lo[t], n_valid)) {
        k_hi = kNoKey;
        for (unsigned r = 0; r < static_cast<unsigned>(blocks); ++r) {
          const uint32_t next = *cluster.map_shared_rank(&st->next[t], r);
          if (next < k_hi) k_hi = next;
        }
      }
      row[1 + 2 * (t0 + t)] = static_cast<int32_t>(st->prefix[t]);
      row[2 + 2 * (t0 + t)] = static_cast<int32_t>(k_hi);
    }
    // No block reuses or leaves its shared memory while another reads it.
    cluster.sync();
  }
}

__device__ __forceinline__ float apply_one(float x, float m, float qmin,
                                           float range) {
  float v = __fdiv_rn(__fsub_rn(x, qmin), range);
  // Not fminf/fmaxf: those drop NaN, while the reference clip keeps it.
  v = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
  return __fmul_rn(v, m);
}

__global__ void minmax_apply_kernel(const float* __restrict__ vol,
                                    const float* __restrict__ mask,
                                    const float* __restrict__ q,
                                    float* __restrict__ out, int64_t n,
                                    bool vectorise) {
  const int64_t scan = blockIdx.y;
  const float qmin = q[2 * scan];
  const float range = __fsub_rn(q[2 * scan + 1], qmin);
  const float* v = vol + scan * n;
  const float* m = mask + scan * n;
  float* o = out + scan * n;
  // With 16-byte aligned bases, all three rows share their misalignment:
  // scalar head up to the first 16-byte boundary, float4 body, scalar tail.
  int64_t head = n, body = 0;
  if (vectorise) {
    head = ((16 - (reinterpret_cast<uintptr_t>(v) & 15)) & 15) / sizeof(float);
    if (head > n) head = n;
    body = (n - head) / 4;
  }
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = tid; i < head; i += stride)
    o[i] = apply_one(v[i], m[i], qmin, range);
  const float4* v4 = reinterpret_cast<const float4*>(v + head);
  const float4* m4 = reinterpret_cast<const float4*>(m + head);
  float4* o4 = reinterpret_cast<float4*>(o + head);
  for (int64_t i = tid; i < body; i += stride) {
    const float4 a = v4[i], b = m4[i];
    o4[i] = make_float4(apply_one(a.x, b.x, qmin, range),
                        apply_one(a.y, b.y, qmin, range),
                        apply_one(a.z, b.z, qmin, range),
                        apply_one(a.w, b.w, qmin, range));
  }
  for (int64_t i = head + 4 * body + tid; i < n; i += stride)
    o[i] = apply_one(v[i], m[i], qmin, range);
}

// About four blocks per SM over the whole batch, and no block with less
// than four elements per thread.
cudaError_t streaming_grid(int device, int64_t batch, int64_t n, dim3* grid) {
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  int64_t per_row = (4 * static_cast<int64_t>(sms) + batch - 1) / batch;
  const int64_t most = (n + 4 * kThreads - 1) / (4 * kThreads);
  if (per_row > most) per_row = most;
  if (per_row < 1) per_row = 1;
  *grid = dim3(static_cast<unsigned>(per_row), static_cast<unsigned>(batch));
  return cudaSuccess;
}

unsigned blocks_for(int64_t items, int threads) {
  return static_cast<unsigned>((items + threads - 1) / threads);
}

}  // namespace

#define RETURN_IF_ERROR(expr)                 \
  do {                                        \
    const cudaError_t err_ = (expr);          \
    if (err_ != cudaSuccess) return err_;     \
  } while (0)

extern "C" {

// Blocks of a scan's cluster on the one-launch route, or 0 for a scan too
// large for it, which takes the device-memory route. Depends on N alone.
int64_t minmax_select_cluster_blocks(int64_t n) {
  return scan_cluster::cluster_blocks(n, select_extra(1));
}

// 32-bit words of scratch that minmax_select needs: none on the one-launch
// route.
int64_t minmax_select_workspace_words(int64_t batch, int64_t n, int64_t n_qs) {
  if (minmax_select_cluster_blocks(n) > 0) return 0;
  return batch * n + kDigitPasses * batch * n_qs * kBins + batch +
         batch * n_qs * static_cast<int64_t>(sizeof(Target) / sizeof(uint32_t));
}

// Clusters of the one-launch route the device keeps resident at once for a
// scan of n voxels (cudaOccupancyMaxActiveClusters); 0 off that route, -1 on
// a CUDA error.
int minmax_select_active_clusters(int64_t n, int64_t device) {
  const int64_t blocks = minmax_select_cluster_blocks(n);
  if (blocks == 0) return 0;
  if (cudaSetDevice(static_cast<int>(device)) != cudaSuccess) return -1;
  return scan_cluster::active_clusters(
      select_cluster_kernel, blocks,
      scan_cluster::slots(n, blocks) * 4 + select_extra(1));
}

int minmax_select(const float* vol, const float* mask, Levels levels,
                  int64_t batch, int64_t n, void* workspace, int32_t* out,
                  int64_t device, void* stream_handle) {
  const int64_t n_qs = levels.count;
  if (batch < 1 || batch > 65535 || n < 1 || n > 0xFFFFFFFFLL || n_qs < 1 ||
      n_qs > kMaxTargets)
    return cudaErrorInvalidValue;
  RETURN_IF_ERROR(cudaSetDevice(static_cast<int>(device)));
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const int64_t blocks = minmax_select_cluster_blocks(n);
  if (blocks > 0) {
    const int64_t keys = scan_cluster::slots(n, blocks) * 4;
    int64_t group = kGroup;
    while (group > 1 && keys + select_extra(group) > scan_cluster::kMaxSmem)
      --group;
    if (group > n_qs) group = n_qs;
    const bool vec = ((reinterpret_cast<uintptr_t>(vol) ^
                       reinterpret_cast<uintptr_t>(mask)) & 15) == 0;
    return scan_cluster::launch(select_cluster_kernel, batch, blocks,
                                keys + select_extra(group), stream, vol, mask,
                                n, scan_cluster::stretch(n, blocks),
                                static_cast<int>(group), levels, vec, out);
  }
  uint32_t* keys = static_cast<uint32_t*>(workspace);
  uint32_t* hist = keys + batch * n;
  const int64_t hist_words = batch * n_qs * kBins;
  uint32_t* count = hist + kDigitPasses * hist_words;
  Target* targets = reinterpret_cast<Target*>(count + batch);
  const int64_t n_targets = batch * n_qs;
  const int small = 128;

  dim3 grid;
  RETURN_IF_ERROR(streaming_grid(static_cast<int>(device), batch, n, &grid));
  RETURN_IF_ERROR(cudaMemsetAsync(
      hist, 0, (kDigitPasses * hist_words + batch) * sizeof(uint32_t), stream));
  keys_kernel<<<grid, kThreads, 0, stream>>>(vol, mask, keys, count, n);
  RETURN_IF_ERROR(cudaGetLastError());
  init_targets_kernel<<<blocks_for(n_targets, small), small, 0, stream>>>(
      count, levels, targets, batch, n_qs, n);
  RETURN_IF_ERROR(cudaGetLastError());
  for (int pass = 0; pass < kDigitPasses; ++pass) {
    const int shift = 24 - 8 * pass;
    digit_hist_kernel<<<grid, kThreads, 0, stream>>>(
        keys, n, targets, static_cast<int>(n_qs), shift, hist + pass * hist_words);
    RETURN_IF_ERROR(cudaGetLastError());
    digit_pick_kernel<<<blocks_for(n_targets, small), small, 0, stream>>>(
        hist + pass * hist_words, targets, n_targets, shift);
    RETURN_IF_ERROR(cudaGetLastError());
  }
  neighbour_kernel<<<grid, kThreads, 0, stream>>>(keys, n, targets,
                                                  static_cast<int>(n_qs));
  RETURN_IF_ERROR(cudaGetLastError());
  finish_kernel<<<blocks_for(n_targets, small), small, 0, stream>>>(
      count, targets, batch, n_qs, out);
  return cudaGetLastError();
}

int minmax_apply(const float* vol, const float* mask, const float* q, float* out,
                 int64_t batch, int64_t n, int64_t device, void* stream_handle) {
  if (batch < 1 || batch > 65535 || n < 1) return cudaErrorInvalidValue;
  RETURN_IF_ERROR(cudaSetDevice(static_cast<int>(device)));
  dim3 grid;
  RETURN_IF_ERROR(streaming_grid(static_cast<int>(device), batch, n, &grid));
  const bool vectorise = ((reinterpret_cast<uintptr_t>(vol) |
                           reinterpret_cast<uintptr_t>(mask) |
                           reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  minmax_apply_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream_handle)>>>(
      vol, mask, q, out, n, vectorise);
  return cudaGetLastError();
}

const char* minmax_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
