// Training-mode BatchNorm for Hopper (sm_90a).
//
// Four kernels behind a plain C interface, loaded with ctypes by
// ops/_native.py and wrapped by ops/hopper_bn.py. They work on the model's
// NCDHW activation viewed as (B, C, S) rows, S = D*H*W, with no permute copy:
// row (b, c) is S contiguous floats. The TPU kernels pack F = 128 / C voxels
// into each 128-lane row only to fill the TPU's lanes; nothing here needs it.
//
// bn_stats (replaces multimodal_alzheimer_tpu/ops/pallas_bn.py _sum_kernel):
//   per-channel [sum x; sum x^2] in f32. On the TPU one grid walks the rows
//   in order and accumulates into one (2, 128) block. Blocks run in parallel
//   here, so one launch gives each channel a thread-block cluster of up to 8
//   blocks (cudaLaunchKernelEx with a cluster dimension) and each block one
//   stretch of S in all B rows: 16-byte loads, warp shuffles, shared memory.
//   Rank 0 of the cluster then adds the blocks' partials through
//   distributed shared memory in rank order and writes the channel's sums:
//   no workspace, no second launch, no float atomics, so the result is the
//   same from run to run. The cluster
//   size aims at about 512 blocks in all (four per SM of an H100's 132) with
//   at least 256 elements of S per block: 8 at the ResNet-18 stem and
//   layer1 (64 channels), 4 at layer2 (128), 2 at layer3 (256) and 1 at
//   layer4 (512).
//   Bound: memory, x read once (4 bytes per element).
//
// bn_apply (replaces pallas_bn.py _apply_kernel):
//   y = ((x - mean) * inv) * scale + bias, one elementwise pass.
//   Bound: memory, 4 bytes read and 4 written per element.
//
// bn_grad_sum (replaces pallas_bn.py _grad_sum_kernel):
//   per-channel [sum g; sum g * xhat], xhat = (x - mean) * inv recomputed in
//   registers; bn_stats' kernel (one template) over two inputs.
//   Bound: memory, 8 bytes read per element.
//
// bn_dx (replaces pallas_bn.py _dx_kernel):
//   dx = (scale * inv) * ((g - red0) - xhat * red1), red = [sum g; sum g xhat]
//   / N, one elementwise pass. Bound: memory, 8 bytes read and 4 written per
//   element.
//
// The elementwise kernels write every floating-point operation as an _rn
// intrinsic, so no FMA contraction changes a bit: given the same mean, inv,
// scale, bias and reductions they equal the plain PyTorch versions exactly.
// Each row takes float4 loads and stores when S is a multiple of 4 and the
// operands are 16-byte aligned (S = 116380, 14812 and 2016 on the flagship
// model's path), else scalar ones.
//
// Each entry point takes device pointers, int64 sizes, the device index and a
// cudaStream_t, allocates nothing, and returns the first CUDA error seen (0 on
// success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Blocks a statistics pass aims for over all channels (about four per SM of
// an H100's 132), the least stretch of a row one block takes, and the
// largest portable cluster.
constexpr int64_t kReduceBlocks = 512;
constexpr int64_t kMinSpan = 256;
constexpr int64_t kMaxCluster = 8;
// Blocks an elementwise pass aims for over all rows.
constexpr int64_t kApplyBlocks = 2048;

// (a, b) summed over the block, valid in thread 0. Each block reduces once,
// so `smem` (kWarps entries) is never reused and one barrier does.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* smem) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    a += __shfl_down_sync(0xFFFFFFFFu, a, offset);
    b += __shfl_down_sync(0xFFFFFFFFu, b, offset);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) smem[warp] = make_float2(a, b);
  __syncthreads();
  float2 total = make_float2(0.0f, 0.0f);
  if (warp == 0) {
    if (lane < kWarps) total = smem[lane];
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      total.x += __shfl_down_sync(0xFFFFFFFFu, total.x, offset);
      total.y += __shfl_down_sync(0xFFFFFFFFu, total.y, offset);
    }
  }
  return total;
}

__device__ __forceinline__ float normalised(float x, float mean, float inv) {
  return __fmul_rn(__fsub_rn(x, mean), inv);
}

// kGrad false: a += x, b += x*x (bn_stats). kGrad true: a += g,
// b += g * xhat (bn_grad_sum).
template <bool kGrad>
__device__ __forceinline__ void accumulate(float x, float g, float mean,
                                           float inv, float& a, float& b) {
  if (kGrad) {
    a += g;
    b += g * normalised(x, mean, inv);
  } else {
    a += x;
    b += x * x;
  }
}

template <bool kGrad>
__device__ __forceinline__ void accumulate4(const float4& x, const float4& g,
                                            float mean, float inv, float* a,
                                            float* b) {
  accumulate<kGrad>(x.x, g.x, mean, inv, a[0], b[0]);
  accumulate<kGrad>(x.y, g.y, mean, inv, a[1], b[1]);
  accumulate<kGrad>(x.z, g.z, mean, inv, a[2], b[2]);
  accumulate<kGrad>(x.w, g.w, mean, inv, a[3], b[3]);
}

// One cluster per channel, one block per stretch of S: block `rank` sums
// [rank * span, rank * span + span) of each of the channel's B rows, row
// after row, into four accumulators, a lane of a float4 each. (Loads of
// several rows issued together before the adds were slower on an H100 at
// the ResNet-18 stem; PERF.md has the times.) After a cluster barrier,
// rank 0 adds the cluster's partials from distributed shared memory in rank
// order and writes sums (2, C). Every add happens in an order fixed by the
// code: the same inputs give the same bits.
template <bool kGrad>
__global__ void __launch_bounds__(kThreads)
    reduce_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  const float* __restrict__ mean,
                  const float* __restrict__ inv, int64_t batch,
                  int64_t channels, int64_t spatial, int64_t span, bool vec,
                  float* __restrict__ sums) {
  __shared__ float2 warp_sums[kWarps];
  __shared__ float2 partial;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int64_t c = blockIdx.y;
  const int64_t begin = rank * span;
  const int64_t end = begin + span < spatial ? begin + span : spatial;
  const float m = kGrad ? mean[c] : 0.0f;
  const float iv = kGrad ? inv[c] : 0.0f;
  const int64_t row_step = channels * spatial;  // row (r, c) to (r + 1, c)
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f}, b[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int64_t r = 0; r < batch; ++r) {
    const float* xr = x + r * row_step + c * spatial;
    const float* gr = kGrad ? g + r * row_step + c * spatial : nullptr;
    if (vec) {
      const float4* x4 = reinterpret_cast<const float4*>(xr);
      const float4* g4 = reinterpret_cast<const float4*>(gr);
      const int i1 = static_cast<int>(end / 4);
      for (int i = static_cast<int>(begin / 4) + threadIdx.x; i < i1;
           i += kThreads)
        accumulate4<kGrad>(__ldg(x4 + i),
                           kGrad ? __ldg(g4 + i)
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f),
                           m, iv, a, b);
    } else {
      const int i1 = static_cast<int>(end);
      for (int i = static_cast<int>(begin) + threadIdx.x; i < i1;
           i += kThreads)
        accumulate<kGrad>(__ldg(xr + i), kGrad ? __ldg(gr + i) : 0.0f, m,
                          iv, a[0], b[0]);
    }
  }
  const float2 total = block_sum2((a[0] + a[1]) + (a[2] + a[3]),
                                  (b[0] + b[1]) + (b[2] + b[3]), warp_sums);
  if (threadIdx.x == 0) partial = total;
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    float2 s = make_float2(0.0f, 0.0f);
    for (unsigned r = 0; r < cluster.num_blocks(); ++r) {
      const float2 p = *cluster.map_shared_rank(&partial, r);
      s.x += p.x;
      s.y += p.y;
    }
    sums[c] = s.x;
    sums[channels + c] = s.y;
  }
  cluster.sync();  // no block leaves while rank 0 reads its shared memory
}

__device__ __forceinline__ float apply_one(float x, float mean, float inv,
                                           float scale, float bias) {
  return __fadd_rn(__fmul_rn(normalised(x, mean, inv), scale), bias);
}

__device__ __forceinline__ float dx_one(float g, float x, float mean, float inv,
                                        float scale_inv, float red0,
                                        float red1) {
  const float t = __fsub_rn(__fsub_rn(g, red0),
                            __fmul_rn(normalised(x, mean, inv), red1));
  return __fmul_rn(scale_inv, t);
}

// Grid (rows, chunks): block (row, j) strides over row b*C + c from j.
__global__ void apply_kernel(const float* __restrict__ x,
                             const float* __restrict__ mean,
                             const float* __restrict__ inv,
                             const float* __restrict__ scale,
                             const float* __restrict__ bias,
                             float* __restrict__ y, int64_t channels,
                             int64_t spatial, bool vec) {
  const int64_t row = blockIdx.x, c = row % channels;
  const float m = mean[c], iv = inv[c], sc = scale[c], bi = bias[c];
  const float* xr = x + row * spatial;
  float* yr = y + row * spatial;
  const int64_t start = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.y) * blockDim.x;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    float4* y4 = reinterpret_cast<float4*>(yr);
    for (int64_t i = start; i < spatial / 4; i += stride) {
      const float4 v = x4[i];
      y4[i] = make_float4(apply_one(v.x, m, iv, sc, bi), apply_one(v.y, m, iv, sc, bi),
                          apply_one(v.z, m, iv, sc, bi), apply_one(v.w, m, iv, sc, bi));
    }
  } else {
    for (int64_t i = start; i < spatial; i += stride)
      yr[i] = apply_one(xr[i], m, iv, sc, bi);
  }
}

__global__ void dx_kernel(const float* __restrict__ g,
                          const float* __restrict__ x,
                          const float* __restrict__ mean,
                          const float* __restrict__ inv,
                          const float* __restrict__ scale,
                          const float* __restrict__ red,
                          float* __restrict__ dx, int64_t channels,
                          int64_t spatial, bool vec) {
  const int64_t row = blockIdx.x, c = row % channels;
  const float m = mean[c], iv = inv[c];
  const float s = __fmul_rn(scale[c], iv);
  const float r0 = red[c], r1 = red[channels + c];
  const float* gr = g + row * spatial;
  const float* xr = x + row * spatial;
  float* dr = dx + row * spatial;
  const int64_t start = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.y) * blockDim.x;
  if (vec) {
    const float4* g4 = reinterpret_cast<const float4*>(gr);
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    float4* d4 = reinterpret_cast<float4*>(dr);
    for (int64_t i = start; i < spatial / 4; i += stride) {
      const float4 a = g4[i], b = x4[i];
      d4[i] = make_float4(dx_one(a.x, b.x, m, iv, s, r0, r1),
                          dx_one(a.y, b.y, m, iv, s, r0, r1),
                          dx_one(a.z, b.z, m, iv, s, r0, r1),
                          dx_one(a.w, b.w, m, iv, s, r0, r1));
    }
  } else {
    for (int64_t i = start; i < spatial; i += stride)
      dr[i] = dx_one(gr[i], xr[i], m, iv, s, r0, r1);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool valid_shape(int64_t batch, int64_t channels, int64_t spatial) {
  return batch >= 1 && channels >= 1 && channels <= 65535 && spatial >= 1 &&
         spatial <= 0x7FFFFFFFLL && batch * channels <= 0x7FFFFFFFLL;
}

// Blocks of a statistics pass's cluster: one channel's stretches of S.
int64_t reduce_cluster(int64_t channels, int64_t spatial) {
  int64_t n = (kReduceBlocks + channels - 1) / channels;
  if (n > kMaxCluster) n = kMaxCluster;
  if (n > spatial / kMinSpan) n = spatial / kMinSpan;
  return n < 1 ? 1 : n;
}

// Chunks of each row in an elementwise pass: about kApplyBlocks blocks in
// all, and none with less than one element per thread.
unsigned apply_chunks(int64_t rows, int64_t spatial) {
  int64_t chunks = (kApplyBlocks + rows - 1) / rows;
  const int64_t most = (spatial + kThreads - 1) / kThreads;
  if (chunks > most) chunks = most;
  if (chunks > 65535) chunks = 65535;
  return static_cast<unsigned>(chunks < 1 ? 1 : chunks);
}

#define RETURN_IF_ERROR(expr)             \
  do {                                    \
    const cudaError_t err_ = (expr);      \
    if (err_ != cudaSuccess) return err_; \
  } while (0)

template <bool kGrad>
cudaError_t reduce(const float* x, const float* g, const float* mean,
                   const float* inv, int64_t batch, int64_t channels,
                   int64_t spatial, float* sums, cudaStream_t stream) {
  const int64_t cluster = reduce_cluster(channels, spatial);
  // A multiple of 4, so float4 loads stay aligned when S is.
  const int64_t span = ((spatial + cluster - 1) / cluster + 3) / 4 * 4;
  const bool vec = spatial % 4 == 0 && aligned16(x) && (!kGrad || aligned16(g));
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(cluster),
                        static_cast<unsigned>(channels));
  config.blockDim = dim3(kThreads);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  RETURN_IF_ERROR(cudaLaunchKernelEx(&config, reduce_kernel<kGrad>, x, g,
                                     mean, inv, batch, channels, spatial,
                                     span, vec, sums));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// sums (2, C) = [sum x; sum x^2] over the B rows of each channel.
int bn_stats(const float* x, int64_t batch, int64_t channels, int64_t spatial,
             float* sums, int64_t device, void* stream_handle) {
  if (!valid_shape(batch, channels, spatial)) return cudaErrorInvalidValue;
  RETURN_IF_ERROR(cudaSetDevice(static_cast<int>(device)));
  return reduce<false>(x, nullptr, nullptr, nullptr, batch, channels, spatial,
                       sums, static_cast<cudaStream_t>(stream_handle));
}

// y = ((x - mean) * inv) * scale + bias with (C,) mean, inv, scale, bias.
int bn_apply(const float* x, const float* mean, const float* inv,
             const float* scale, const float* bias, float* y, int64_t batch,
             int64_t channels, int64_t spatial, int64_t device,
             void* stream_handle) {
  if (!valid_shape(batch, channels, spatial)) return cudaErrorInvalidValue;
  RETURN_IF_ERROR(cudaSetDevice(static_cast<int>(device)));
  const int64_t rows = batch * channels;
  const bool vec = spatial % 4 == 0 && aligned16(x) && aligned16(y);
  const dim3 grid(static_cast<unsigned>(rows),
                  apply_chunks(rows, vec ? spatial / 4 : spatial));
  apply_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream_handle)>>>(
      x, mean, inv, scale, bias, y, channels, spatial, vec);
  return cudaGetLastError();
}

// sums (2, C) = [sum g; sum g * (x - mean) * inv].
int bn_grad_sum(const float* g, const float* x, const float* mean,
                const float* inv, int64_t batch, int64_t channels,
                int64_t spatial, float* sums, int64_t device,
                void* stream_handle) {
  if (!valid_shape(batch, channels, spatial)) return cudaErrorInvalidValue;
  RETURN_IF_ERROR(cudaSetDevice(static_cast<int>(device)));
  return reduce<true>(x, g, mean, inv, batch, channels, spatial, sums,
                      static_cast<cudaStream_t>(stream_handle));
}

// dx = (scale * inv) * ((g - red[0]) - (x - mean) * inv * red[1]), red (2, C).
int bn_dx(const float* g, const float* x, const float* mean, const float* inv,
          const float* scale, const float* red, float* dx, int64_t batch,
          int64_t channels, int64_t spatial, int64_t device,
          void* stream_handle) {
  if (!valid_shape(batch, channels, spatial)) return cudaErrorInvalidValue;
  RETURN_IF_ERROR(cudaSetDevice(static_cast<int>(device)));
  const int64_t rows = batch * channels;
  const bool vec = spatial % 4 == 0 && aligned16(g) && aligned16(x) && aligned16(dx);
  const dim3 grid(static_cast<unsigned>(rows),
                  apply_chunks(rows, vec ? spatial / 4 : spatial));
  dx_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream_handle)>>>(
      g, x, mean, inv, scale, red, dx, channels, spatial, vec);
  return cudaGetLastError();
}

}  // extern "C"
