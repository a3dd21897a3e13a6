// Per-scan z-score normalisation for Hopper (sm_90a).
//
// One entry point behind a plain C interface, loaded with ctypes by
// ops/_native.py and wrapped by ops/hopper_norm.py:
//
// zscore_norm (replaces multimodal_alzheimer_tpu/ops/pallas_norm.py
//   _zscore_stream_kernel): for each scan b of a (B, N) batch, the count,
//   mean and Bessel-corrected standard deviation of {x * m != 0}, then
//   out = ((x - mean) / std) * m.
//   On the TPU one grid step per scan streams the scan through VMEM twice.
//   Here one launch gives each scan a thread-block cluster of 16 blocks of
//   512 threads, each block one stretch of the scan; no workspace:
//   * each block reads its stretch of volume and mask (16-byte loads, two
//     in flight per thread) and reduces the count, sum and sum of squares
//     of its valid voxels into one partial. The sums are doubles: an f32
//     voxel squared is exact in a double, so the unshifted sum of squares
//     loses nothing that matters even where the mean is far above the
//     standard deviation (N(900, 40) intensities), which an f32 sum of
//     squares does not survive;
//   * after a cluster barrier every block adds the cluster's 16 partials in
//     rank order over distributed shared memory (no float atomics: the same
//     inputs give the same bits, on any device), then mean = sum / n and
//     var = (sumsq - sum * mean) / max(n - 1, 1), as the plain two-pass
//     version (ops/quantile.py masked_nonzero_mean_std). A scan with no
//     valid voxel gets mean 0/0 = NaN, so its whole output is NaN, as in
//     the plain version; one valid voxel gives std 0;
//   * each block then writes out = ((x - mean) / std) * m over its stretch,
//     reading volume and mask again, last chunk first: the lines it read
//     last are the likeliest still in the 50 MB L2.
//   The blocks keep nothing in shared memory, so the clusters of a serving
//   or training batch are resident at once. (Holding the volume in the
//   cluster's shared memory, as K1 holds its keys, takes 227 KB a block: 7
//   such clusters fit an H100 at a time, so batch 8 ran in two waves and
//   was slower; so were a persistent grid over L2-sized groups of scans
//   and blocks of 1024 threads at batch 8. PERF.md has the times.)
//   Bound: memory. The function reads volume and mask once and writes the
//   output once (12 bytes per voxel); this design reads them twice, the
//   second time mostly from the L2.
//
// Exactness: the apply writes every floating-point operation as an _rn
// intrinsic, so given the same mean and std it equals the plain PyTorch
// expression bit for bit.
//
// The same function split in two, for a scan whose depth is sharded over
// several processes (parallel/tp.py): each holds a slab, and the statistics
// need the whole scan.
//
// zscore_partials: for each slab b of a (B, N) batch, the count, sum and sum
//   of squares of {x * m != 0} as doubles, (B, 3). The caller adds the
//   slabs' partials in rank order and takes mean and std as zscore_norm
//   does. A slab is a few MB (one rank's 46 planes of 91x109x91: 3.6 MB of
//   volume and mask), so a cluster of 16 blocks a slab, as zscore_norm
//   launches, leaves most of the card idle at a rank's batch of 4 (64
//   blocks on 132 SMs). Nothing here applies in the same launch, so no
//   block needs another's shared memory or to be resident beside it:
//   * the grid is sized by the card, not by the batch: each slab gets
//     ceil(kPartialBlocksPerSm * SMs / B) blocks of kPartialThreads (fewer
//     where the slab has under a 16-byte chunk a thread), the SM count read
//     once per device: 33 a slab at a rank's batch of 4 on an H100. Each
//     block reduces its stretch of the slab with kPartialLoads 16-byte
//     chunks of volume and of mask in flight per thread (at a rank's slab
//     of 46x109x91 and batch 4, its whole stretch in one round), into one
//     double partial, as zscore_norm's blocks do;
//   * each block writes its partial to its own slot of a workspace, and the
//     last block of a slab to arrive (an arrival counter per slab, an
//     atomic add after a fence) adds the slab's slots in index order (lane
//     r of one warp the slots r, r + 32, ..., then a fixed shuffle tree) and
//     writes the three sums. The order of every add is fixed by the grid,
//     not by arrival, so two calls give the same bits. It then sets the
//     counter back to 0 for the next call. (A second, tiny launch could do
//     the merge; the last block does it instead, so a call stays one
//     launch and the merge costs no launch latency.) The workspace, slots
//     and counters, is the caller's: allocated once per device and stream,
//     the counters zeroed once.
//   Bound: memory, 8 bytes per voxel (volume and mask read once).
// zscore_apply: out = ((x - mean) / std) * m with per-scan float32 mean and
//   std, (B,) each: the same _rn expression, so equal to the plain PyTorch
//   expression bit for bit. 16 blocks a slab, each one stretch, no cluster.
//   Bound: memory, 12 bytes per voxel.
//
// The entry points take device pointers, int64 sizes, the device index and
// a cudaStream_t, allocate nothing, and return the first CUDA error seen (0
// on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kClusterBlocks = 16;  // fixed: the merge order may not vary
// zscore_partials: blocks of 512 threads, one an SM, 8 chunk pairs in
// flight a thread (8 x 32 bytes). (Of 128 to 512 threads, 1 to 8 blocks
// an SM and 2 to 8 pairs, this was the fastest on an H100 at the [tp]
// slabs, batch 1 and 4; PERF.md has the times.)
constexpr int kPartialThreads = 512;
constexpr int kPartialWarps = kPartialThreads / 32;
constexpr int kPartialBlocksPerSm = 1;
constexpr int kPartialLoads = 8;
constexpr int kMaxDevices = 64;

struct Partial {
  double count;
  double sum;
  double sumsq;
};

__device__ __forceinline__ void accumulate(float x, float m, unsigned& count,
                                           double& sum, double& sumsq) {
  const float v = __fmul_rn(x, m);
  if (v != 0.0f) {  // excludes +-0; NaN counts as valid, as in the plain version
    const double d = static_cast<double>(v);
    ++count;
    sum += d;
    sumsq = fma(d, d, sumsq);
  }
}

__device__ __forceinline__ void accumulate4(const float4& x, const float4& m,
                                            unsigned& count, double& sum,
                                            double& sumsq) {
  accumulate(x.x, m.x, count, sum, sumsq);
  accumulate(x.y, m.y, count, sum, sumsq);
  accumulate(x.z, m.z, count, sum, sumsq);
  accumulate(x.w, m.w, count, sum, sumsq);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_down_sync(0xFFFFFFFFu, v, offset);
  return v;
}

__device__ __forceinline__ float apply_one(float x, float m, float mean,
                                           float std) {
  return __fmul_rn(__fdiv_rn(__fsub_rn(x, mean), std), m);
}

// Block `rank`'s stretch of a row of n cut in `blocks`: [begin, end), a
// multiple of 4 long.
__device__ __forceinline__ void stretch_of(int64_t n, int64_t blocks,
                                           int64_t rank, int64_t* begin,
                                           int64_t* end) {
  const int64_t per = ((n + blocks - 1) / blocks + 3) / 4 * 4;
  *begin = rank * per < n ? rank * per : n;
  *end = *begin + per < n ? *begin + per : n;
}

// Elements before the first 16-byte boundary of v + lo (all of [lo, hi)
// when volume and mask are not equally aligned).
__device__ __forceinline__ int64_t head_of(const float* v, int64_t lo,
                                           int64_t hi, bool vec) {
  int64_t head = hi - lo;
  if (vec) {
    const int64_t h = static_cast<int64_t>(
        ((16 - (reinterpret_cast<uintptr_t>(v + lo) & 15)) & 15) / 4);
    if (h < head) head = h;
  }
  return head;
}

// Elements [lo, hi) of a row in 16-byte chunks of their addresses: `one(i,
// x, m)` for each element before the first 16-byte boundary and after the
// last, `four(i, x4, m4)` for each chunk between, two chunks' loads in
// flight per thread; chunks in reverse order when `reverse`.
template <typename One, typename Four>
__device__ __forceinline__ void for_each_chunk(const float* __restrict__ v,
                                               const float* __restrict__ m,
                                               int64_t lo, int64_t hi,
                                               bool vec, bool reverse, One one,
                                               Four four) {
  const int64_t head = head_of(v, lo, hi, vec);
  for (int64_t i = lo + threadIdx.x; i < lo + head; i += kThreads)
    one(i, __ldg(v + i), __ldg(m + i));
  const int64_t start = lo + head;
  const int64_t chunks = (hi - start) / 4;
  for (int64_t i = start + 4 * chunks + threadIdx.x; i < hi; i += kThreads)
    one(i, __ldg(v + i), __ldg(m + i));
  const float4* v4 = reinterpret_cast<const float4*>(v + start);
  const float4* m4 = reinterpret_cast<const float4*>(m + start);
  for (int64_t j = threadIdx.x; j < chunks; j += 2 * kThreads) {
    const int64_t c0 = reverse ? chunks - 1 - j : j;
    const int64_t c1 = reverse ? c0 - kThreads : c0 + kThreads;
    const bool two = j + kThreads < chunks;
    const float4 a0 = __ldg(v4 + c0), b0 = __ldg(m4 + c0);
    float4 a1 = a0, b1 = b0;
    if (two) {
      a1 = __ldg(v4 + c1);
      b1 = __ldg(m4 + c1);
    }
    four(start + 4 * c0, a0, b0);
    if (two) four(start + 4 * c1, a1, b1);
  }
}

// Grid: one cluster of kClusterBlocks blocks per scan. `vec`: volume, mask
// and output equally aligned. Normalises each scan into `out`.
__global__ void __launch_bounds__(kThreads)
    zscore_kernel(const float* __restrict__ vol, const float* __restrict__ mask,
                  float* __restrict__ out, int64_t n, bool vec) {
  __shared__ Partial warp_partials[kWarps];
  __shared__ Partial partial;  // this block's, read by the whole cluster
  __shared__ float stats[2];   // mean, std
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int64_t scan = blockIdx.x / kClusterBlocks;
  const float* v = vol + scan * n;
  const float* m = mask + scan * n;
  float* o = out + scan * n;
  int64_t lo, hi;
  stretch_of(n, kClusterBlocks, rank, &lo, &hi);

  unsigned count = 0;
  double sum = 0.0, sumsq = 0.0;
  for_each_chunk(
      v, m, lo, hi, vec, false,
      [&](int64_t, float x, float w) { accumulate(x, w, count, sum, sumsq); },
      [&](int64_t, const float4& x, const float4& w) {
        accumulate4(x, w, count, sum, sumsq);
      });
  count = warp_sum(count);
  sum = warp_sum(sum);
  sumsq = warp_sum(sumsq);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0)
    warp_partials[warp] = Partial{static_cast<double>(count), sum, sumsq};
  __syncthreads();
  if (warp == 0) {
    const Partial p =
        lane < kWarps ? warp_partials[lane] : Partial{0.0, 0.0, 0.0};
    const double c = warp_sum(p.count), a = warp_sum(p.sum),
                 q = warp_sum(p.sumsq);
    if (lane == 0) partial = Partial{c, a, q};
  }
  cluster.sync();

  if (threadIdx.x == 0) {
    double c = 0.0, a = 0.0, q = 0.0;
    for (unsigned r = 0; r < kClusterBlocks; ++r) {
      const Partial p = *cluster.map_shared_rank(&partial, r);
      c += p.count;
      a += p.sum;
      q += p.sumsq;
    }
    const double mean = a / c;  // NaN for a scan with no valid voxel
    double var = (q - a * mean) / (c - 1.0 > 1.0 ? c - 1.0 : 1.0);
    // Rounding can leave a tiny negative where the spread is zero; the
    // plain version's sum of squared deviations cannot be negative.
    if (var < 0.0) var = 0.0;
    stats[0] = static_cast<float>(mean);
    stats[1] = static_cast<float>(sqrt(var));
  }
  cluster.sync();  // every partial read; the statistics in shared memory
  const float mean = stats[0], std = stats[1];
  for_each_chunk(
      v, m, lo, hi, vec, true,
      [&](int64_t i, float x, float w) { o[i] = apply_one(x, w, mean, std); },
      [&](int64_t i, const float4& x, const float4& w) {
        *reinterpret_cast<float4*>(o + i) = make_float4(
            apply_one(x.x, w.x, mean, std), apply_one(x.y, w.y, mean, std),
            apply_one(x.z, w.z, mean, std), apply_one(x.w, w.w, mean, std));
      });
}

// Grid: `blocks` blocks per slab, each its stretch. Each block's (count,
// sum, sumsq) goes to slots[blockIdx.x]; the last block of slab b to arrive
// adds slots[b * blocks, (b + 1) * blocks) in index order into sums[3 b,
// 3 b + 3) and sets arrivals[b] back to 0.
__global__ void __launch_bounds__(kPartialThreads)
    zscore_partials_kernel(const float* __restrict__ vol,
                           const float* __restrict__ mask,
                           double* __restrict__ sums, Partial* slots,
                           unsigned* arrivals, int64_t n, int blocks,
                           bool vec) {
  __shared__ Partial warp_partials[kPartialWarps];
  __shared__ bool last;
  const int64_t scan = blockIdx.x / blocks;
  const float* v = vol + scan * n;
  const float* m = mask + scan * n;
  int64_t lo, hi;
  stretch_of(n, blocks, blockIdx.x % blocks, &lo, &hi);

  unsigned count = 0;
  double sum = 0.0, sumsq = 0.0;
  const int64_t head = head_of(v, lo, hi, vec);
  for (int64_t i = lo + threadIdx.x; i < lo + head; i += kPartialThreads)
    accumulate(__ldg(v + i), __ldg(m + i), count, sum, sumsq);
  const int64_t start = lo + head;
  const int64_t chunks = (hi - start) / 4;
  for (int64_t i = start + 4 * chunks + threadIdx.x; i < hi;
       i += kPartialThreads)
    accumulate(__ldg(v + i), __ldg(m + i), count, sum, sumsq);
  const float4* v4 = reinterpret_cast<const float4*>(v + start);
  const float4* m4 = reinterpret_cast<const float4*>(m + start);
  for (int64_t j = threadIdx.x; j < chunks;
       j += kPartialLoads * kPartialThreads) {
    float4 a[kPartialLoads], b[kPartialLoads];
#pragma unroll
    for (int u = 0; u < kPartialLoads; ++u) {
      const int64_t c = j + u * kPartialThreads;
      a[u] = c < chunks ? __ldg(v4 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      b[u] = c < chunks ? __ldg(m4 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kPartialLoads; ++u)
      if (j + u * kPartialThreads < chunks)
        accumulate4(a[u], b[u], count, sum, sumsq);
  }
  count = warp_sum(count);
  sum = warp_sum(sum);
  sumsq = warp_sum(sumsq);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0)
    warp_partials[warp] = Partial{static_cast<double>(count), sum, sumsq};
  __syncthreads();
  if (warp == 0) {
    const Partial p =
        lane < kPartialWarps ? warp_partials[lane] : Partial{0.0, 0.0, 0.0};
    const double c = warp_sum(p.count), s = warp_sum(p.sum),
                 q = warp_sum(p.sumsq);
    if (lane == 0) {
      slots[blockIdx.x] = Partial{c, s, q};
      __threadfence();  // the slot is visible before the arrival counts
      last = atomicAdd(arrivals + scan, 1u) == static_cast<unsigned>(blocks - 1);
    }
  }
  __syncthreads();
  if (!last || warp != 0) return;
  __threadfence();  // every other block's slot is read after its arrival
  const Partial* mine = slots + scan * blocks;
  double c = 0.0, s = 0.0, q = 0.0;
  for (int r = lane; r < blocks; r += 32) {
    c += __ldcg(&mine[r].count);
    s += __ldcg(&mine[r].sum);
    q += __ldcg(&mine[r].sumsq);
  }
  c = warp_sum(c);
  s = warp_sum(s);
  q = warp_sum(q);
  if (lane == 0) {
    sums[3 * scan] = c;
    sums[3 * scan + 1] = s;
    sums[3 * scan + 2] = q;
    arrivals[scan] = 0;  // ready for the next call on this stream
  }
}

// Grid: kClusterBlocks blocks per scan, each its stretch; per-scan mean and
// std from mean[scan], std[scan].
__global__ void __launch_bounds__(kThreads)
    zscore_apply_kernel(const float* __restrict__ vol,
                        const float* __restrict__ mask,
                        const float* __restrict__ means,
                        const float* __restrict__ stds,
                        float* __restrict__ out, int64_t n, bool vec) {
  const int64_t scan = blockIdx.x / kClusterBlocks;
  const unsigned rank = blockIdx.x % kClusterBlocks;
  const float* v = vol + scan * n;
  const float* m = mask + scan * n;
  float* o = out + scan * n;
  const float mean = means[scan], std = stds[scan];
  int64_t lo, hi;
  stretch_of(n, kClusterBlocks, rank, &lo, &hi);
  for_each_chunk(
      v, m, lo, hi, vec, false,
      [&](int64_t i, float x, float w) { o[i] = apply_one(x, w, mean, std); },
      [&](int64_t i, const float4& x, const float4& w) {
        *reinterpret_cast<float4*>(o + i) = make_float4(
            apply_one(x.x, w.x, mean, std), apply_one(x.y, w.y, mean, std),
            apply_one(x.z, w.z, mean, std), apply_one(x.w, w.w, mean, std));
      });
}

bool aligned_alike(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) ^ reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

bool valid_rows(int64_t batch, int64_t n) {
  return batch >= 1 && batch * kClusterBlocks <= 0x7FFFFFFFLL && n >= 1 &&
         n <= 0xFFFFFFFFLL;
}

// The SM count of each device, read once (0: not read yet).
int sm_count(int device) {
  static int counts[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return 0;
  if (counts[device] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess)
      return 0;
    counts[device] = sms;
  }
  return counts[device];
}

// Blocks per slab of zscore_partials: kPartialBlocksPerSm a SM over the
// batch, no more than the slab has 16-byte chunks for a thread each; 0 on
// an unknown device.
int64_t partial_blocks(int64_t batch, int64_t n, int64_t device) {
  const int sms = sm_count(static_cast<int>(device));
  if (sms == 0 || batch < 1 || n < 1) return 0;
  const int64_t by_card = (kPartialBlocksPerSm * sms + batch - 1) / batch;
  const int64_t by_size = (n + 4 * kPartialThreads - 1) / (4 * kPartialThreads);
  return by_card < by_size ? by_card : by_size;
}

}  // namespace

#define RETURN_IF_ERROR(expr)             \
  do {                                    \
    const cudaError_t err_ = (expr);      \
    if (err_ != cudaSuccess) return err_; \
  } while (0)

extern "C" {

int zscore_norm(const float* vol, const float* mask, float* out, int64_t batch,
                int64_t n, int64_t device, void* stream_handle) {
  if (!valid_rows(batch, n)) return cudaErrorInvalidValue;
  RETURN_IF_ERROR(cudaSetDevice(static_cast<int>(device)));
  RETURN_IF_ERROR(cudaFuncSetAttribute(
      zscore_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  const bool vec = aligned_alike(vol, mask) && aligned_alike(vol, out);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(batch * kClusterBlocks));
  config.blockDim = dim3(kThreads);
  config.stream = static_cast<cudaStream_t>(stream_handle);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterBlocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  RETURN_IF_ERROR(
      cudaLaunchKernelEx(&config, zscore_kernel, vol, mask, out, n, vec));
  return cudaGetLastError();
}

// Blocks per slab that zscore_partials launches for a (batch, n) batch on
// `device`; the caller's workspace holds batch x this many slots.
int64_t zscore_partials_blocks(int64_t batch, int64_t n, int64_t device) {
  if (!valid_rows(batch, n)) return 0;
  return partial_blocks(batch, n, device);
}

// sums (batch, 3) float64: count, sum and sum of squares of each row's
// {x * m != 0}. slots: batch x zscore_partials_blocks(...) x 3 doubles;
// arrivals: batch uint32 counters, 0 on entry and left 0. One call at a
// time per workspace.
int zscore_partials(const float* vol, const float* mask, double* sums,
                    double* slots, unsigned* arrivals, int64_t batch,
                    int64_t n, int64_t device, void* stream_handle) {
  const int64_t blocks = zscore_partials_blocks(batch, n, device);
  if (blocks == 0 || batch * blocks > 0x7FFFFFFFLL)
    return cudaErrorInvalidValue;
  RETURN_IF_ERROR(cudaSetDevice(static_cast<int>(device)));
  zscore_partials_kernel<<<static_cast<unsigned>(batch * blocks),
                           kPartialThreads, 0,
                           static_cast<cudaStream_t>(stream_handle)>>>(
      vol, mask, sums, reinterpret_cast<Partial*>(slots), arrivals, n,
      static_cast<int>(blocks), aligned_alike(vol, mask));
  return cudaGetLastError();
}

// out = ((x - mean) / std) * m, mean and std (batch,) float32.
int zscore_apply(const float* vol, const float* mask, const float* mean,
                 const float* stdev, float* out, int64_t batch, int64_t n,
                 int64_t device, void* stream_handle) {
  if (!valid_rows(batch, n)) return cudaErrorInvalidValue;
  RETURN_IF_ERROR(cudaSetDevice(static_cast<int>(device)));
  const bool vec = aligned_alike(vol, mask) && aligned_alike(vol, out);
  zscore_apply_kernel<<<static_cast<unsigned>(batch * kClusterBlocks),
                        kThreads, 0, static_cast<cudaStream_t>(
                                         stream_handle)>>>(vol, mask, mean,
                                                           stdev, out, n, vec);
  return cudaGetLastError();
}

}  // extern "C"
