// Training-mode BatchNorm for Hopper (sm_90a).
//
// Four kernels behind a plain C interface, loaded with ctypes by
// ops/_native.py and wrapped by ops/hopper_bn.py. They work on the model's
// NCDHW activation viewed as (B, C, S) rows, S = D*H*W, with no permute copy:
// row (b, c) is S contiguous elements. The TPU kernels pack F = 128 / C voxels
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
// x and g are float32 or bfloat16 (the model's compute dtype); mean, inv,
// scale, bias, the reductions and the sums are float32. Every kernel reads
// its inputs in their dtype, computes in f32 and writes y and dx in x's
// dtype with one rounding (__float2bfloat16_rn in bf16), as the Pallas
// bodies do (pallas_bn.py:70-103). In bf16 the bound halves: 2 bytes per
// element read or written.
//
// The elementwise kernels write every floating-point operation as an _rn
// intrinsic, so no FMA contraction changes a bit: given the same mean, inv,
// scale, bias and reductions they equal the plain PyTorch versions exactly.
// Every row is read and written in 16-byte chunks of its own address (4
// floats or 8 bfloat16s) with element accesses for the partial chunks at
// either end, so any alignment is taken: at the ResNet-18 stem a bf16 row
// of S = 116380 elements is 232,760 bytes, and every other row starts 8
// bytes past a 16-byte boundary. Operands whose addresses differ modulo 16
// take element accesses throughout.
//
// Each entry point takes device pointers, a dtype code (0 float32, 1
// bfloat16), int64 sizes, the device index and a cudaStream_t, allocates
// nothing, and returns the first CUDA error seen (0 on success).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
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

// Loads, stores and 16-byte chunks of one element type, in f32 registers.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;  // elements of a 16-byte chunk
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
  static __device__ __forceinline__ uint32_t bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(bits(f[0]) | (bits(f[1]) << 16),
                      bits(f[2]) | (bits(f[3]) << 16),
                      bits(f[4]) | (bits(f[5]) << 16),
                      bits(f[6]) | (bits(f[7]) << 16));
  }
};

// Elements from p to the next 16-byte boundary (0 if p is on one), at most
// len; all of len when `vec` is false.
template <typename T>
__device__ __forceinline__ int64_t head_of(const T* p, int64_t len, bool vec) {
  if (!vec) return len;
  const int64_t h =
      static_cast<int64_t>(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) /
                           sizeof(T));
  return h < len ? h : len;
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

// One cluster per channel, one block per stretch of S: block `rank` sums
// [rank * span, rank * span + span) of each of the channel's B rows, row
// after row, into four accumulators, element j of a chunk into a[j % 4].
// (Loads of several rows issued together before the adds were slower on an
// H100 at the ResNet-18 stem; PERF.md has the times.) After a cluster
// barrier, rank 0 adds the cluster's partials from distributed shared
// memory in rank order and writes sums (2, C). Every add happens in an
// order fixed by the code: the same inputs give the same bits.
template <typename T, bool kGrad>
__global__ void __launch_bounds__(kThreads)
    reduce_kernel(const T* __restrict__ x, const T* __restrict__ g,
                  const float* __restrict__ mean,
                  const float* __restrict__ inv, int64_t batch,
                  int64_t channels, int64_t spatial, int64_t span, bool vec,
                  float* __restrict__ sums) {
  constexpr int kVec = Elem<T>::kVec;
  __shared__ float2 warp_sums[kWarps];
  __shared__ float2 partial;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int64_t c = blockIdx.y;
  const int64_t begin = rank * span < spatial ? rank * span : spatial;
  const int64_t end = begin + span < spatial ? begin + span : spatial;
  const float m = kGrad ? mean[c] : 0.0f;
  const float iv = kGrad ? inv[c] : 0.0f;
  const int64_t row_step = channels * spatial;  // row (r, c) to (r + 1, c)
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f}, b[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int64_t r = 0; r < batch; ++r) {
    const T* xr = x + r * row_step + c * spatial + begin;
    const T* gr = kGrad ? g + r * row_step + c * spatial + begin : nullptr;
    const int64_t len = end - begin;
    const int64_t head = head_of(xr, len, vec);
    const int64_t chunks = (len - head) / kVec;
    for (int64_t i = threadIdx.x; i < head; i += kThreads)
      accumulate<kGrad>(Elem<T>::load(xr + i),
                        kGrad ? Elem<T>::load(gr + i) : 0.0f, m, iv, a[0],
                        b[0]);
    const uint4* x4 = reinterpret_cast<const uint4*>(xr + head);
    const uint4* g4 = reinterpret_cast<const uint4*>(kGrad ? gr + head : xr);
    for (int64_t i = threadIdx.x; i < chunks; i += kThreads) {
      float xf[kVec], gf[kVec];
      Elem<T>::unpack(__ldg(x4 + i), xf);
      if (kGrad) Elem<T>::unpack(__ldg(g4 + i), gf);
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        accumulate<kGrad>(xf[j], kGrad ? gf[j] : 0.0f, m, iv, a[j % 4],
                          b[j % 4]);
    }
    for (int64_t i = head + chunks * kVec + threadIdx.x; i < len;
         i += kThreads)
      accumulate<kGrad>(Elem<T>::load(xr + i),
                        kGrad ? Elem<T>::load(gr + i) : 0.0f, m, iv, a[0],
                        b[0]);
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
template <typename T>
__global__ void apply_kernel(const T* __restrict__ x,
                             const float* __restrict__ mean,
                             const float* __restrict__ inv,
                             const float* __restrict__ scale,
                             const float* __restrict__ bias,
                             T* __restrict__ y, int64_t channels,
                             int64_t spatial, bool vec) {
  constexpr int kVec = Elem<T>::kVec;
  const int64_t row = blockIdx.x, c = row % channels;
  const float m = mean[c], iv = inv[c], sc = scale[c], bi = bias[c];
  const T* xr = x + row * spatial;
  T* yr = y + row * spatial;
  const int64_t head = head_of(xr, spatial, vec);
  const int64_t chunks = (spatial - head) / kVec;
  const int64_t start = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.y) * blockDim.x;
  for (int64_t i = start; i < head; i += stride)
    Elem<T>::store(yr + i, apply_one(Elem<T>::load(xr + i), m, iv, sc, bi));
  const uint4* x4 = reinterpret_cast<const uint4*>(xr + head);
  uint4* y4 = reinterpret_cast<uint4*>(yr + head);
  for (int64_t i = start; i < chunks; i += stride) {
    float f[kVec];
    Elem<T>::unpack(x4[i], f);
#pragma unroll
    for (int j = 0; j < kVec; ++j) f[j] = apply_one(f[j], m, iv, sc, bi);
    y4[i] = Elem<T>::pack(f);
  }
  for (int64_t i = head + chunks * kVec + start; i < spatial; i += stride)
    Elem<T>::store(yr + i, apply_one(Elem<T>::load(xr + i), m, iv, sc, bi));
}

template <typename T>
__global__ void dx_kernel(const T* __restrict__ g, const T* __restrict__ x,
                          const float* __restrict__ mean,
                          const float* __restrict__ inv,
                          const float* __restrict__ scale,
                          const float* __restrict__ red,
                          T* __restrict__ dx, int64_t channels,
                          int64_t spatial, bool vec) {
  constexpr int kVec = Elem<T>::kVec;
  const int64_t row = blockIdx.x, c = row % channels;
  const float m = mean[c], iv = inv[c];
  const float s = __fmul_rn(scale[c], iv);
  const float r0 = red[c], r1 = red[channels + c];
  const T* gr = g + row * spatial;
  const T* xr = x + row * spatial;
  T* dr = dx + row * spatial;
  const int64_t head = head_of(xr, spatial, vec);
  const int64_t chunks = (spatial - head) / kVec;
  const int64_t start = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.y) * blockDim.x;
  for (int64_t i = start; i < head; i += stride)
    Elem<T>::store(dr + i, dx_one(Elem<T>::load(gr + i), Elem<T>::load(xr + i),
                                  m, iv, s, r0, r1));
  const uint4* g4 = reinterpret_cast<const uint4*>(gr + head);
  const uint4* x4 = reinterpret_cast<const uint4*>(xr + head);
  uint4* d4 = reinterpret_cast<uint4*>(dr + head);
  for (int64_t i = start; i < chunks; i += stride) {
    float gf[kVec], xf[kVec];
    Elem<T>::unpack(g4[i], gf);
    Elem<T>::unpack(x4[i], xf);
#pragma unroll
    for (int j = 0; j < kVec; ++j) gf[j] = dx_one(gf[j], xf[j], m, iv, s, r0, r1);
    d4[i] = Elem<T>::pack(gf);
  }
  for (int64_t i = head + chunks * kVec + start; i < spatial; i += stride)
    Elem<T>::store(dr + i, dx_one(Elem<T>::load(gr + i), Elem<T>::load(xr + i),
                                  m, iv, s, r0, r1));
}

// Whether two operands are equally placed within 16 bytes, so their rows
// share their 16-byte chunks.
bool congruent(const void* p, const void* q) {
  return ((reinterpret_cast<uintptr_t>(p) ^ reinterpret_cast<uintptr_t>(q)) &
          15) == 0;
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

template <typename T, bool kGrad>
cudaError_t reduce(const void* x, const void* g, const float* mean,
                   const float* inv, int64_t batch, int64_t channels,
                   int64_t spatial, float* sums, cudaStream_t stream) {
  const int64_t cluster = reduce_cluster(channels, spatial);
  // A multiple of 16 bytes, so the blocks' stretches of an aligned row
  // start on 16-byte boundaries.
  const int64_t vec_elems = Elem<T>::kVec;
  const int64_t span =
      ((spatial + cluster - 1) / cluster + vec_elems - 1) / vec_elems * vec_elems;
  const bool vec = !kGrad || congruent(x, g);
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
  RETURN_IF_ERROR(cudaLaunchKernelEx(
      &config, reduce_kernel<T, kGrad>, static_cast<const T*>(x),
      static_cast<const T*>(g), mean, inv, batch, channels, spatial, span, vec,
      sums));
  return cudaGetLastError();
}

template <typename T>
cudaError_t apply(const void* x, const float* mean, const float* inv,
                  const float* scale, const float* bias, void* y,
                  int64_t batch, int64_t channels, int64_t spatial,
                  cudaStream_t stream) {
  const int64_t rows = batch * channels;
  const bool vec = congruent(x, y);
  const dim3 grid(static_cast<unsigned>(rows),
                  apply_chunks(rows, vec ? spatial / Elem<T>::kVec : spatial));
  apply_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), mean, inv, scale, bias, static_cast<T*>(y),
      channels, spatial, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dx(const void* g, const void* x, const float* mean,
               const float* inv, const float* scale, const float* red,
               void* out, int64_t batch, int64_t channels, int64_t spatial,
               cudaStream_t stream) {
  const int64_t rows = batch * channels;
  const bool vec = congruent(g, x) && congruent(x, out);
  const dim3 grid(static_cast<unsigned>(rows),
                  apply_chunks(rows, vec ? spatial / Elem<T>::kVec : spatial));
  dx_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), mean, inv, scale,
      red, static_cast<T*>(out), channels, spatial, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// sums (2, C) = [sum x; sum x^2] over the B rows of each channel.
int bn_stats(const void* x, int64_t dtype, int64_t batch, int64_t channels,
             int64_t spatial, float* sums, int64_t device,
             void* stream_handle) {
  if (!valid_shape(batch, channels, spatial) || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  RETURN_IF_ERROR(cudaSetDevice(static_cast<int>(device)));
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  return dtype == 0
             ? reduce<float, false>(x, nullptr, nullptr, nullptr, batch,
                                    channels, spatial, sums, stream)
             : reduce<__nv_bfloat16, false>(x, nullptr, nullptr, nullptr,
                                            batch, channels, spatial, sums,
                                            stream);
}

// y = ((x - mean) * inv) * scale + bias with (C,) mean, inv, scale, bias.
int bn_apply(const void* x, int64_t dtype, const float* mean, const float* inv,
             const float* scale, const float* bias, void* y, int64_t batch,
             int64_t channels, int64_t spatial, int64_t device,
             void* stream_handle) {
  if (!valid_shape(batch, channels, spatial) || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  RETURN_IF_ERROR(cudaSetDevice(static_cast<int>(device)));
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  return dtype == 0 ? apply<float>(x, mean, inv, scale, bias, y, batch,
                                   channels, spatial, stream)
                    : apply<__nv_bfloat16>(x, mean, inv, scale, bias, y,
                                           batch, channels, spatial, stream);
}

// sums (2, C) = [sum g; sum g * (x - mean) * inv].
int bn_grad_sum(const void* g, const void* x, int64_t dtype, const float* mean,
                const float* inv, int64_t batch, int64_t channels,
                int64_t spatial, float* sums, int64_t device,
                void* stream_handle) {
  if (!valid_shape(batch, channels, spatial) || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  RETURN_IF_ERROR(cudaSetDevice(static_cast<int>(device)));
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  return dtype == 0
             ? reduce<float, true>(x, g, mean, inv, batch, channels, spatial,
                                   sums, stream)
             : reduce<__nv_bfloat16, true>(x, g, mean, inv, batch, channels,
                                           spatial, sums, stream);
}

// dx = (scale * inv) * ((g - red[0]) - (x - mean) * inv * red[1]), red (2, C).
int bn_dx(const void* g, const void* x, int64_t dtype, const float* mean,
          const float* inv, const float* scale, const float* red, void* out,
          int64_t batch, int64_t channels, int64_t spatial, int64_t device,
          void* stream_handle) {
  if (!valid_shape(batch, channels, spatial) || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  RETURN_IF_ERROR(cudaSetDevice(static_cast<int>(device)));
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  return dtype == 0 ? dx<float>(g, x, mean, inv, scale, red, out, batch,
                                channels, spatial, stream)
                    : dx<__nv_bfloat16>(g, x, mean, inv, scale, red, out,
                                        batch, channels, spatial, stream);
}

}  // extern "C"
