// One thread-block cluster per scan, the scan held in distributed shared
// memory: the layout of the one-launch order-statistics select
// (minmax_norm.cu).
//
// The TPU kernel keeps a whole 91x109x91 scan (3.6 MB of keys) in VMEM. An
// H100 block has at most 227 KB of shared memory, but a cluster of up to 16
// blocks, one per SM of a GPC, can read each other's shared memory. So a
// scan of N voxels is cut into C stretches, the fewest that fit, of
// `per` = ceil(N / C) rounded up to a multiple of 4 voxels, and block `rank`
// of the scan's cluster holds stretch [rank * per, rank * per + per) of the
// row in its shared memory, read once from device memory. At
// N = 902,629: C = 16 and per = 56,416 (225,680 B of shared memory a block).
//
// Shared-memory layout of a stretch: slot j holds row element
// rank * per - lead + j, where `lead` (0-3) is how far the stretch's first
// element lies past a 16-byte boundary of the row. So every group of four
// slots is one 16-byte chunk of device memory, and thread t owns chunks
// t, t + 1024, ... (at most 15). `stage` reads the stretch once: the
// volume's whole chunks by cp.async straight into shared memory, all in
// flight together, the at most two partial chunks at the ends element by
// element (slots outside the stretch read as 0); and the mask, four chunks
// in flight per thread, into one bit per voxel in a register of the thread
// that owns it, with a flag saying whether every mask value it saw was 0.0
// or 1.0 (else the caller reads the mask again where it needs it). When
// volume and mask are not equally aligned every chunk is read element by
// element. A block of 1024 threads keeps its whole stretch, some 225 KB,
// in flight: far more than the latency of device memory needs.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace scan_cluster {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kMaxBlocks = 16;     // non-portable cluster size on sm_90
constexpr int64_t kMaxSmem = 232448;   // opt-in shared memory of one block
// Chunks a thread owns at most: kMaxSmem / 16 / kThreads, rounded up.
constexpr int kMaxChunks = 15;
// Mask chunks a thread has in flight at once.
constexpr int kMaskBatch = 4;

// Voxels of a stretch, a multiple of 4.
__host__ __device__ inline int64_t stretch(int64_t n, int64_t blocks) {
  return ((n + blocks - 1) / blocks + 3) / 4 * 4;
}

// Slots of shared memory a stretch takes: its voxels and up to 3 of lead,
// in whole chunks of four.
__host__ __device__ inline int64_t slots(int64_t n, int64_t blocks) {
  return (stretch(n, blocks) + 3 + 3) / 4 * 4;
}

// Blocks of a scan's cluster: the fewest whose stretches fit in shared
// memory beside `extra` bytes of each block, or 0 when even kMaxBlocks
// blocks do not hold the scan.
inline int64_t cluster_blocks(int64_t n, int64_t extra) {
  for (int64_t c = 1; c <= kMaxBlocks; ++c)
    if (slots(n, c) * 4 + extra <= kMaxSmem) return c;
  return 0;
}

// Where block `rank`'s stretch lies in its row.
struct Stretch {
  int64_t begin;  // first row element of the stretch
  int64_t end;    // one past its last
  int64_t base;   // row element of slot 0: begin - lead
  int64_t chunks; // 16-byte chunks of slots that touch the stretch
};

__device__ inline Stretch block_stretch(const float* row, int64_t n,
                                        int64_t per, unsigned rank,
                                        bool vec) {
  Stretch s;
  s.begin = static_cast<int64_t>(rank) * per;
  if (s.begin > n) s.begin = n;
  s.end = s.begin + per < n ? s.begin + per : n;
  const int64_t lead =
      vec ? static_cast<int64_t>((reinterpret_cast<uintptr_t>(row + s.begin) &
                                  15) / sizeof(float))
          : 0;
  s.base = s.begin - lead;
  s.chunks = (s.end - s.base + 3) / 4;
  return s;
}

// Whether element e of the row lies in the stretch.
__device__ __forceinline__ bool inside(const Stretch& s, int64_t e) {
  return e >= s.begin && e < s.end;
}

__device__ __forceinline__ bool whole(const Stretch& s, int64_t e, bool vec) {
  return vec && e >= s.begin && e + 4 <= s.end;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Four elements of row p at element e: one 16-byte load for a whole chunk,
// else the elements inside the stretch, 0 elsewhere.
__device__ __forceinline__ float4 load4(const float* __restrict__ p,
                                        const Stretch& s, int64_t e,
                                        bool vec) {
  if (whole(s, e, vec)) return __ldg(reinterpret_cast<const float4*>(p + e));
  float t[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) t[j] = inside(s, e + j) ? __ldg(p + e + j) : 0.0f;
  return make_float4(t[0], t[1], t[2], t[3]);
}

// Bit 4k + j of `bits`: element j of the thread's k-th chunk has mask 1.0.
struct MaskBits {
  uint64_t bits;
  bool binary;  // every mask value of the thread's chunks is 0.0 or 1.0

  // Element j of chunk k's mask: from the bit, or read again.
  __device__ __forceinline__ float at(const float* __restrict__ m,
                                      const Stretch& s, int64_t e, int k,
                                      int j) const {
    if (binary) return (bits >> (4 * k + j)) & 1u ? 1.0f : 0.0f;
    return inside(s, e + j) ? __ldg(m + e + j) : 0.0f;
  }
};

// Reads the stretch: the volume into xs[0, chunks) (the block's shared
// memory), the mask into the returned bits. On return the thread's own
// chunks of xs are complete (other threads' need a barrier).
__device__ inline MaskBits stage(const float* __restrict__ v,
                                 const float* __restrict__ m,
                                 const Stretch& s, bool vec, int64_t chunks,
                                 float4* xs) {
#pragma unroll
  for (int k = 0; k < kMaxChunks; ++k) {
    const int64_t c = threadIdx.x + static_cast<int64_t>(k) * kThreads;
    if (c < chunks) {
      const int64_t e = s.base + 4 * c;
      if (whole(s, e, vec))
        cp_async16(xs + c, v + e);
      else
        xs[c] = load4(v, s, e, vec);
    }
  }
  MaskBits mb{0, true};
#pragma unroll
  for (int k0 = 0; k0 < kMaxChunks; k0 += kMaskBatch) {
    float4 w[kMaskBatch];
#pragma unroll
    for (int u = 0; u < kMaskBatch; ++u) {
      const int64_t c = threadIdx.x + static_cast<int64_t>(k0 + u) * kThreads;
      w[u] = k0 + u < kMaxChunks && c < s.chunks
                 ? load4(m, s, s.base + 4 * c, vec)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kMaskBatch; ++u) {
      const float ws[4] = {w[u].x, w[u].y, w[u].z, w[u].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t b = __float_as_uint(ws[j]);
        mb.binary &= b == 0u || b == 0x3F800000u;
        mb.bits |= static_cast<uint64_t>(b == 0x3F800000u)
                   << (4 * (k0 + u) + j);
      }
    }
  }
  cp_async_wait_all();
  return mb;
}

// Launch `kernel` with one cluster of `blocks` blocks per scan, kThreads
// threads and `smem` bytes of dynamic shared memory a block.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int64_t batch, int64_t blocks,
                   int64_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(batch * blocks));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(blocks);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Clusters of `blocks` blocks with `smem` bytes each that the device keeps
// resident at once (cudaOccupancyMaxActiveClusters), or -1 on error.
template <typename... Params>
int active_clusters(void (*kernel)(Params...), int64_t blocks, int64_t smem) {
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess ||
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(blocks));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(blocks);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &config) !=
      cudaSuccess)
    return -1;
  return clusters;
}

}  // namespace scan_cluster
