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
//   here, so a block takes one channel and one stretch of S in each of the B
//   rows, reduces it with 16-byte loads, warp shuffles and shared memory, and
//   writes one partial per (channel, stretch). A second, tiny pass sums each
//   channel's partials in a fixed order: no float atomics, so the result is
//   the same from run to run.
//   Bound: memory, x read once (4 bytes per element).
//
// bn_apply (replaces pallas_bn.py _apply_kernel):
//   y = ((x - mean) * inv) * scale + bias, one elementwise pass.
//   Bound: memory, 4 bytes read and 4 written per element.
//
// bn_grad_sum (replaces pallas_bn.py _grad_sum_kernel):
//   per-channel [sum g; sum g * xhat], xhat = (x - mean) * inv recomputed in
//   registers; bn_stats' structure over two inputs, with the same second pass.
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

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Blocks a statistics pass aims for over all channels (about four per SM of
// an H100's 132), and the least stretch of a row one block takes.
constexpr int64_t kReduceBlocks = 512;
constexpr int64_t kMinSpan = 512;
// Blocks an elementwise pass aims for over all rows.
constexpr int64_t kApplyBlocks = 2048;

// Sum of v over the block, valid in thread 0. `smem` holds kWarps floats and
// may be reused as soon as this returns.
__device__ __forceinline__ float block_sum(float v, float* smem) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_down_sync(0xFFFFFFFFu, v, offset);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  float total = 0.0f;
  if (warp == 0) {
    total = lane < kWarps ? smem[lane] : 0.0f;
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1)
      total += __shfl_down_sync(0xFFFFFFFFu, total, offset);
  }
  __syncthreads();
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

// One block per (stretch of S, channel): partials of both sums over the
// stretch [split * span, split * span + span) of every row of the channel.
// partial is (2, C, splits).
template <bool kGrad>
__global__ void reduce_partial_kernel(const float* __restrict__ x,
                                      const float* __restrict__ g,
                                      const float* __restrict__ mean,
                                      const float* __restrict__ inv,
                                      int64_t batch, int64_t channels,
                                      int64_t spatial, int64_t span, bool vec,
                                      float* __restrict__ partial) {
  __shared__ float smem[kWarps];
  const int64_t c = blockIdx.y, split = blockIdx.x, splits = gridDim.x;
  const int64_t begin = split * span;
  const int64_t end = begin + span < spatial ? begin + span : spatial;
  const float m = kGrad ? mean[c] : 0.0f;
  const float iv = kGrad ? inv[c] : 0.0f;
  float a = 0.0f, b = 0.0f;
  for (int64_t row = c; row < batch * channels; row += channels) {
    const float* xr = x + row * spatial;
    const float* gr = kGrad ? g + row * spatial : nullptr;
    if (vec) {
      const float4* x4 = reinterpret_cast<const float4*>(xr);
      const float4* g4 = reinterpret_cast<const float4*>(gr);
      for (int64_t i = begin / 4 + threadIdx.x; i < end / 4; i += blockDim.x) {
        const float4 xv = x4[i];
        const float4 gv = kGrad ? g4[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        accumulate<kGrad>(xv.x, gv.x, m, iv, a, b);
        accumulate<kGrad>(xv.y, gv.y, m, iv, a, b);
        accumulate<kGrad>(xv.z, gv.z, m, iv, a, b);
        accumulate<kGrad>(xv.w, gv.w, m, iv, a, b);
      }
    } else {
      for (int64_t i = begin + threadIdx.x; i < end; i += blockDim.x)
        accumulate<kGrad>(xr[i], kGrad ? gr[i] : 0.0f, m, iv, a, b);
    }
  }
  a = block_sum(a, smem);
  b = block_sum(b, smem);
  if (threadIdx.x == 0) {
    partial[c * splits + split] = a;
    partial[(channels + c) * splits + split] = b;
  }
}

// One thread per (sum, channel): the channel's partials in order of split.
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    int64_t channels, int64_t splits,
                                    float* __restrict__ sums) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= 2 * channels) return;
  const float* p = partial + i * splits;
  float total = 0.0f;
  for (int64_t j = 0; j < splits; ++j) total += p[j];
  sums[i] = total;
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
         batch * channels <= 0x7FFFFFFFLL;
}

// Stretch of a row, in elements, that one block of a statistics pass takes:
// a multiple of 4, so float4 loads stay aligned when S is.
int64_t reduce_span(int64_t channels, int64_t spatial) {
  const int64_t target = (kReduceBlocks + channels - 1) / channels;
  int64_t span = (spatial + target - 1) / target;
  span = (span + 3) / 4 * 4;
  return span < kMinSpan ? kMinSpan : span;
}

int64_t reduce_splits(int64_t channels, int64_t spatial) {
  const int64_t span = reduce_span(channels, spatial);
  return (spatial + span - 1) / span;
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
                   int64_t spatial, float* partial, float* sums,
                   cudaStream_t stream) {
  const int64_t span = reduce_span(channels, spatial);
  const int64_t splits = (spatial + span - 1) / span;
  const bool vec = spatial % 4 == 0 && aligned16(x) && (!kGrad || aligned16(g));
  const dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>(channels));
  reduce_partial_kernel<kGrad><<<grid, kThreads, 0, stream>>>(
      x, g, mean, inv, batch, channels, spatial, span, vec, partial);
  RETURN_IF_ERROR(cudaGetLastError());
  const int small = 128;
  const unsigned blocks = static_cast<unsigned>((2 * channels + small - 1) / small);
  sum_partials_kernel<<<blocks, small, 0, stream>>>(partial, channels, splits, sums);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Partials per channel and sum that bn_stats and bn_grad_sum write: their
// workspace holds 2 * channels * bn_reduce_splits(channels, spatial) floats.
int64_t bn_reduce_splits(int64_t channels, int64_t spatial) {
  if (channels < 1 || spatial < 1) return 0;
  return reduce_splits(channels, spatial);
}

// sums (2, C) = [sum x; sum x^2] over the B rows of each channel.
int bn_stats(const float* x, int64_t batch, int64_t channels, int64_t spatial,
             float* workspace, float* sums, int64_t device, void* stream_handle) {
  if (!valid_shape(batch, channels, spatial)) return cudaErrorInvalidValue;
  RETURN_IF_ERROR(cudaSetDevice(static_cast<int>(device)));
  return reduce<false>(x, nullptr, nullptr, nullptr, batch, channels, spatial,
                       workspace, sums, static_cast<cudaStream_t>(stream_handle));
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
                int64_t spatial, float* workspace, float* sums, int64_t device,
                void* stream_handle) {
  if (!valid_shape(batch, channels, spatial)) return cudaErrorInvalidValue;
  RETURN_IF_ERROR(cudaSetDevice(static_cast<int>(device)));
  return reduce<true>(x, g, mean, inv, batch, channels, spatial, workspace,
                      sums, static_cast<cudaStream_t>(stream_handle));
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
