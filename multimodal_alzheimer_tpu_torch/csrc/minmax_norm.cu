// Per-scan quantile min-max normalisation for Hopper (sm_90a).
//
// Two kernels behind a plain C interface, loaded with ctypes by
// ops/_native.py and wrapped by ops/hopper_norm.py:
//
// minmax_select (replaces multimodal_alzheimer_tpu/ops/pallas_norm.py
//   _minmax_select_kernel): exact order statistics of {x*m != 0} for each
//   scan at ranks lo = floor(q*(n-1)) (f32 arithmetic) and the lo+1
//   neighbour. The TPU kernel keeps one scan's 3.6 MB of radix keys in VMEM
//   and runs a 32-pass bitwise search over them. A block here has at most
//   227 KB of shared memory, so the keys live in device memory (and mostly
//   in the 50 MB L2 at serving batch sizes) and the search is an 8-bit digit
//   select: one keys pass, four histogram passes (MSB digit first, each
//   counting only the keys that match the prefix fixed so far), and one
//   neighbour pass that yields the lo+1 statistic.
//   Bound: memory. Per 91x109x91 scan it reads 7.2 MB of volume and mask,
//   writes 3.6 MB of keys and re-reads them five times (18 MB). The design
//   keeps every pass a coalesced streaming read with per-block shared-memory
//   histograms, so the global traffic is one atomic per non-empty bin per
//   block; the small pick/finish kernels touch only (B, Q) state.
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

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 256;
constexpr int kDigitPasses = 4;
constexpr int kMaxTargets = 8;
constexpr uint32_t kInvalidKey = 0xFFFFFFFFu;

// Selection state of one (scan, target) pair; lives in the workspace.
struct Target {
  uint32_t prefix;  // key digits fixed so far; k_lo after the last pass
  uint32_t rank;    // rank still to find among keys matching the prefix
  int32_t lo;       // floor(q * (n - 1)), unclamped, as the TPU kernel has it
  uint32_t count_le;  // keys <= k_lo (neighbour pass)
  uint32_t next;      // smallest key > k_lo (neighbour pass)
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

__global__ void init_targets_kernel(const uint32_t* __restrict__ count,
                                    const float* __restrict__ qs,
                                    Target* __restrict__ targets, int64_t batch,
                                    int64_t n_qs, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= batch * n_qs) return;
  const float n_valid = static_cast<float>(count[i / n_qs]);
  const float lo_f = floorf(__fmul_rn(qs[i % n_qs], __fsub_rn(n_valid, 1.0f)));
  const int32_t lo = static_cast<int32_t>(lo_f);
  // A scan with no valid voxel (lo < 0) selects rank 0 among its invalid
  // keys: in bounds, and its result is meaningless by definition.
  int64_t rank = lo < 0 ? 0 : lo;
  if (rank > n - 1) rank = n - 1;
  targets[i] = Target{0u, static_cast<uint32_t>(rank), lo, 0u, kInvalidKey};
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
    block_next[threadIdx.x] = kInvalidKey;
  }
  const int64_t scan = blockIdx.y;
  uint32_t k_lo[kMaxTargets], le[kMaxTargets], next[kMaxTargets];
#pragma unroll
  for (int t = 0; t < kMaxTargets; ++t) {
    k_lo[t] = t < n_qs ? targets[scan * n_qs + t].prefix : 0u;
    le[t] = 0;
    next[t] = kInvalidKey;
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
    if (next[t] != kInvalidKey) atomicMin(&block_next[t], next[t]);
  }
  __syncthreads();
  if (threadIdx.x < n_qs) {
    Target* tg = targets + scan * n_qs + threadIdx.x;
    if (block_le[threadIdx.x]) atomicAdd(&tg->count_le, block_le[threadIdx.x]);
    if (block_next[threadIdx.x] != kInvalidKey)
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

// 32-bit words of scratch that minmax_select needs.
int64_t minmax_select_workspace_words(int64_t batch, int64_t n, int64_t n_qs) {
  return batch * n + kDigitPasses * batch * n_qs * kBins + batch +
         batch * n_qs * static_cast<int64_t>(sizeof(Target) / sizeof(uint32_t));
}

int minmax_select(const float* vol, const float* mask, const float* qs,
                  int64_t batch, int64_t n, int64_t n_qs, void* workspace,
                  int32_t* out, int64_t device, void* stream_handle) {
  if (batch < 1 || batch > 65535 || n < 1 || n > 0xFFFFFFFFLL || n_qs < 1 ||
      n_qs > kMaxTargets)
    return cudaErrorInvalidValue;
  RETURN_IF_ERROR(cudaSetDevice(static_cast<int>(device)));
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
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
      count, qs, targets, batch, n_qs, n);
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
