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
//   At the serving and training batches (B = 8 or 32) one block per scan
//   would leave most of an H100's 132 SMs idle, so the work is split three
//   ways:
//   * stats_partial_kernel: grid (splits, B). A block takes one stretch of
//     one scan, reads volume and mask with 16-byte loads, and reduces the
//     count, sum and sum of squares of its valid voxels with warp shuffles
//     and shared memory into one partial. The sums are doubles: an f32
//     voxel squared is exact in a double, so the unshifted sum of squares
//     loses nothing that matters even where the mean is far above the
//     standard deviation (N(900, 40) intensities), which an f32 sum of
//     squares does not survive.
//   * stats_merge_kernel: one thread per scan adds its partials in order of
//     stretch (no float atomics: the same inputs give the same bits), then
//     mean = sum / n and var = (sumsq - sum * mean) / max(n - 1, 1), as the
//     plain two-pass version (ops/quantile.py masked_nonzero_mean_std).
//     A scan with no valid voxel gets mean 0/0 = NaN, so its whole output is
//     NaN, as in the plain version; one valid voxel gives std 0.
//   * apply_kernel: out = ((x - mean) / std) * m, one elementwise pass with
//     float4 accesses over each scan's 16-byte aligned body and scalar ones
//     for its head and tail (N = 91*109*91 is odd, so most rows of a batch
//     start off a 16-byte boundary).
//   Bound: memory. The function reads volume and mask once and writes the
//   output once (12 bytes per voxel); this design reads volume and mask
//   twice (20 bytes per voxel).
//
// Exactness: the apply writes every floating-point operation as an _rn
// intrinsic, so given the same mean and std it equals the plain PyTorch
// expression bit for bit.
//
// The entry point takes device pointers, int64 sizes, the device index and a
// cudaStream_t, allocates nothing, and returns the first CUDA error seen (0
// on success).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Blocks a statistics pass aims for over the whole batch (four per SM of an
// H100), and the least stretch of a scan that one block takes. Neither
// depends on the device, so the partials, and the result, do not either.
constexpr int64_t kReduceBlocks = 528;
constexpr int64_t kMinSpan = 4 * kThreads;

struct Partial {
  double count;
  double sum;
  double sumsq;
};

// First index i of a row at p with p + i on a 16-byte boundary.
__device__ __forceinline__ int64_t aligned_start(const float* p) {
  return static_cast<int64_t>(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) /
                              sizeof(float));
}

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

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_down_sync(0xFFFFFFFFu, v, offset);
  return v;
}

__global__ void stats_partial_kernel(const float* __restrict__ vol,
                                     const float* __restrict__ mask, int64_t n,
                                     int64_t span, bool vectorise,
                                     Partial* __restrict__ partial) {
  __shared__ unsigned s_count[kWarps];
  __shared__ double s_sum[kWarps];
  __shared__ double s_sumsq[kWarps];
  const int64_t scan = blockIdx.y, split = blockIdx.x, splits = gridDim.x;
  const float* v = vol + scan * n;
  const float* m = mask + scan * n;
  const int64_t begin = split * span;
  const int64_t end = begin + span < n ? begin + span : n;
  // With 16-byte aligned bases, volume and mask rows share their
  // misalignment: scalar up to the first aligned index, float4 body, scalar
  // tail.
  int64_t body_begin = end, body = 0;
  if (vectorise) {
    const int64_t first = aligned_start(v);
    body_begin = begin <= first ? first : first + (begin - first + 3) / 4 * 4;
    if (body_begin > end) body_begin = end;
    body = (end - body_begin) / 4;
  }
  unsigned count = 0;
  double sum = 0.0, sumsq = 0.0;
  for (int64_t i = begin + threadIdx.x; i < body_begin; i += blockDim.x)
    accumulate(v[i], m[i], count, sum, sumsq);
  const float4* v4 = reinterpret_cast<const float4*>(v + body_begin);
  const float4* m4 = reinterpret_cast<const float4*>(m + body_begin);
  for (int64_t i = threadIdx.x; i < body; i += blockDim.x) {
    const float4 a = v4[i], b = m4[i];
    accumulate(a.x, b.x, count, sum, sumsq);
    accumulate(a.y, b.y, count, sum, sumsq);
    accumulate(a.z, b.z, count, sum, sumsq);
    accumulate(a.w, b.w, count, sum, sumsq);
  }
  for (int64_t i = body_begin + 4 * body + threadIdx.x; i < end; i += blockDim.x)
    accumulate(v[i], m[i], count, sum, sumsq);

  count = warp_sum(count);
  sum = warp_sum(sum);
  sumsq = warp_sum(sumsq);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_count[warp] = count;
    s_sum[warp] = sum;
    s_sumsq[warp] = sumsq;
  }
  __syncthreads();
  if (warp == 0) {
    count = lane < kWarps ? s_count[lane] : 0u;
    sum = lane < kWarps ? s_sum[lane] : 0.0;
    sumsq = lane < kWarps ? s_sumsq[lane] : 0.0;
    count = warp_sum(count);
    sum = warp_sum(sum);
    sumsq = warp_sum(sumsq);
    if (lane == 0)
      partial[scan * splits + split] =
          Partial{static_cast<double>(count), sum, sumsq};
  }
}

// One thread per scan: its partials in order of stretch, then the mean and
// the standard deviation, rounded once to f32. stats is (B, 2): mean, std.
__global__ void stats_merge_kernel(const Partial* __restrict__ partial,
                                   int64_t batch, int64_t splits,
                                   float* __restrict__ stats) {
  const int64_t scan = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (scan >= batch) return;
  const Partial* p = partial + scan * splits;
  double count = 0.0, sum = 0.0, sumsq = 0.0;
  for (int64_t j = 0; j < splits; ++j) {
    count += p[j].count;
    sum += p[j].sum;
    sumsq += p[j].sumsq;
  }
  const double mean = sum / count;  // NaN for a scan with no valid voxel
  double var = (sumsq - sum * mean) / (count - 1.0 > 1.0 ? count - 1.0 : 1.0);
  // Rounding can leave a tiny negative where the spread is zero; the plain
  // version's sum of squared deviations cannot be negative.
  if (var < 0.0) var = 0.0;
  stats[2 * scan] = static_cast<float>(mean);
  stats[2 * scan + 1] = static_cast<float>(sqrt(var));
}

__device__ __forceinline__ float apply_one(float x, float m, float mean,
                                           float std) {
  return __fmul_rn(__fdiv_rn(__fsub_rn(x, mean), std), m);
}

__global__ void apply_kernel(const float* __restrict__ vol,
                             const float* __restrict__ mask,
                             const float* __restrict__ stats,
                             float* __restrict__ out, int64_t n,
                             bool vectorise) {
  const int64_t scan = blockIdx.y;
  const float mean = stats[2 * scan], std = stats[2 * scan + 1];
  const float* v = vol + scan * n;
  const float* m = mask + scan * n;
  float* o = out + scan * n;
  int64_t head = n, body = 0;
  if (vectorise) {
    head = aligned_start(v);
    if (head > n) head = n;
    body = (n - head) / 4;
  }
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = tid; i < head; i += stride)
    o[i] = apply_one(v[i], m[i], mean, std);
  const float4* v4 = reinterpret_cast<const float4*>(v + head);
  const float4* m4 = reinterpret_cast<const float4*>(m + head);
  float4* o4 = reinterpret_cast<float4*>(o + head);
  for (int64_t i = tid; i < body; i += stride) {
    const float4 a = v4[i], b = m4[i];
    o4[i] = make_float4(apply_one(a.x, b.x, mean, std),
                        apply_one(a.y, b.y, mean, std),
                        apply_one(a.z, b.z, mean, std),
                        apply_one(a.w, b.w, mean, std));
  }
  for (int64_t i = head + 4 * body + tid; i < n; i += stride)
    o[i] = apply_one(v[i], m[i], mean, std);
}

// Stretch of a scan, in elements, that one statistics block takes: a
// multiple of 4, so a block's float4 body starts where its stretch does
// whenever the row itself is aligned.
int64_t reduce_span(int64_t batch, int64_t n) {
  const int64_t per_scan = (kReduceBlocks + batch - 1) / batch;
  int64_t span = (n + per_scan - 1) / per_scan;
  span = (span + 3) / 4 * 4;
  return span < kMinSpan ? kMinSpan : span;
}

int64_t reduce_splits(int64_t batch, int64_t n) {
  const int64_t span = reduce_span(batch, n);
  return (n + span - 1) / span;
}

// About four apply blocks per SM over the whole batch, and none with less
// than four elements per thread.
cudaError_t apply_grid(int device, int64_t batch, int64_t n, dim3* grid) {
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

}  // namespace

#define RETURN_IF_ERROR(expr)             \
  do {                                    \
    const cudaError_t err_ = (expr);      \
    if (err_ != cudaSuccess) return err_; \
  } while (0)

extern "C" {

// Bytes of scratch that zscore_norm needs: the partials and the (B, 2)
// statistics.
int64_t zscore_workspace_bytes(int64_t batch, int64_t n) {
  if (batch < 1 || n < 1) return 0;
  return batch * reduce_splits(batch, n) * static_cast<int64_t>(sizeof(Partial)) +
         2 * batch * static_cast<int64_t>(sizeof(float));
}

int zscore_norm(const float* vol, const float* mask, float* out, int64_t batch,
                int64_t n, void* workspace, int64_t device,
                void* stream_handle) {
  if (batch < 1 || batch > 65535 || n < 1 || n > 0xFFFFFFFFLL)
    return cudaErrorInvalidValue;
  RETURN_IF_ERROR(cudaSetDevice(static_cast<int>(device)));
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const int64_t span = reduce_span(batch, n);
  const int64_t splits = (n + span - 1) / span;
  Partial* partial = static_cast<Partial*>(workspace);
  float* stats = reinterpret_cast<float*>(partial + batch * splits);
  const bool vectorise = ((reinterpret_cast<uintptr_t>(vol) |
                           reinterpret_cast<uintptr_t>(mask) |
                           reinterpret_cast<uintptr_t>(out)) & 15) == 0;

  stats_partial_kernel<<<dim3(static_cast<unsigned>(splits),
                              static_cast<unsigned>(batch)),
                         kThreads, 0, stream>>>(vol, mask, n, span, vectorise,
                                                partial);
  RETURN_IF_ERROR(cudaGetLastError());
  const int small = 128;
  stats_merge_kernel<<<static_cast<unsigned>((batch + small - 1) / small), small,
                       0, stream>>>(partial, batch, splits, stats);
  RETURN_IF_ERROR(cudaGetLastError());
  dim3 grid;
  RETURN_IF_ERROR(apply_grid(static_cast<int>(device), batch, n, &grid));
  apply_kernel<<<grid, kThreads, 0, stream>>>(vol, mask, stats, out, n,
                                              vectorise);
  return cudaGetLastError();
}

}  // extern "C"
