// int8 3D convolution with a fused float32 epilogue for Hopper (sm_90a).
//
// One entry point behind a plain C interface, loaded with ctypes by
// ops/_native.py and wrapped by ops/int8_conv.py:
//
// int8_conv3d (replaces multimodal_alzheimer_tpu/inference/quantize.py
//   _conv_int8, which XLA lowers as conv_general_dilated with int8 operands
//   and preferred_element_type=int32; no Pallas kernel):
//     out[b, o, f] = float32(sum_k x[b, o + tap(k), c(k)] * w[f, k])
//                    * scale[f] + bias[f]
//   over a (B, D, H, W, C) int8 input in channels-last order, weights packed
//   as (F, K_pad) int8 with k = ((td * kh + th) * kw + tw) * C + c (tap-major,
//   channel-minor, zero rows past K = kd * kh * kw * C up to a multiple of
//   32), and a (B, Do, Ho, Wo, F) float32 output. One stride and one
//   dilation for all three dimensions, a (lo, hi) zero pad for each.
//
// Design: an implicit GEMM, M = B * Do * Ho * Wo output voxels by N = F
// output channels by K. Each block of 128 threads computes a 128 x 64 tile;
// each of its 4 warps a 64 x 32 quarter, as 4 x 4 tiles of
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 with int32 accumulators,
// one 32-deep step of K at a time. Every thread gathers one output voxel's
// 32 inputs of the step (its row of the A tile) and 16 bytes of weights
// into registers, while the warps multiply the step before from the other
// of two shared-memory stages:
//   * where C is a multiple of 16 (every layer past the stem), a row's 32
//     inputs are two 16-byte loads along C, each inside one tap;
//   * elsewhere (the C = 1 and C = 2 stems, the PET tower's narrow blocks)
//     32 byte loads, the tap and channel stepped along without a division.
//   A tap outside the volume reads 0: symmetric int8 has zero point 0, so
//   zero padding is exact. Shared-memory rows are 48 bytes apart, so the
//   fragment reads of a warp hit 32 different banks.
// The epilogue converts each int32 sum to float32 (round to nearest, as
// XLA's convert), then multiplies and adds with __fmul_rn and __fadd_rn:
// nvcc would contract a * s + b into one FMA, and JAX rounds the multiply
// and the add separately. So the kernel equals the plain version
// (ops/int8_conv.int8_conv3d_plain) bit for bit.
//
// Overflow: |x|, |w| <= 127 and K < 133,143 keep every sum below 2^31; the
// wrapper and this entry point refuse a larger K.
//
// Bound: at the ResNet-18 layers past the stem the operations (2 M N K on
// the int8 tensor cores, 1,979 TOP/s dense) exceed the bytes; the stem's
// float32 output (238 MB at batch 8) makes it bound by memory. This first
// version uses mma.sync, not wgmma, and gathers its A tiles through
// registers, not TMA's im2col mode: a later version's work.
//
// The entry point takes device pointers, int64 sizes, the device index and a
// cudaStream_t, allocates nothing, launches once, and returns the first CUDA
// error seen (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 128;  // output voxels per block
constexpr int kBN = 64;   // output channels per block
constexpr int kBK = 32;   // K per step: one m16n8k32
constexpr int kThreads = 128;
constexpr int kRow = kBK + 16;  // shared-memory row stride in bytes
constexpr int64_t kMaxK = 133142;  // 133,142 * 127^2 < 2^31

struct Geometry {
  int64_t D, H, W, C;     // input (B, D, H, W, C)
  int64_t Do, Ho, Wo, F;  // output (B, Do, Ho, Wo, F)
  int64_t K, k_pad, M;
  int kd, kh, kw, stride, dilation, pd, ph, pw;
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    int8_conv3d_kernel(const int8_t* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, float* __restrict__ out,
                       const Geometry g) {
  __shared__ __align__(16) uint8_t sa[2][kBM * kRow];
  __shared__ __align__(16) uint8_t sb[2][kBN * kRow];
  const int tid = threadIdx.x;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * kBN;

  // This thread's row of the A tile: one output voxel.
  const int64_t m = m0 + tid;
  const bool row_ok = m < g.M;
  int id0 = 0, ih0 = 0, iw0 = 0;
  const int8_t* xb = x;
  if (row_ok) {
    int64_t r = m;
    const int ow = static_cast<int>(r % g.Wo);
    r /= g.Wo;
    const int oh = static_cast<int>(r % g.Ho);
    r /= g.Ho;
    const int od = static_cast<int>(r % g.Do);
    r /= g.Do;
    id0 = od * g.stride - g.pd;
    ih0 = oh * g.stride - g.ph;
    iw0 = ow * g.stride - g.pw;
    xb = x + r * g.D * g.H * g.W * g.C;
  }
  // This thread's 16 bytes of the B tile: half a row of one output channel.
  const int bn = tid >> 1, bseg = tid & 1;
  const bool b_ok = n0 + bn < g.F;
  const int8_t* wrow = w + (n0 + bn) * g.k_pad + bseg * 16;

  uint4 ra[2], rb;
  auto in_volume = [&](int id, int ih, int iw) {
    return static_cast<unsigned>(id) < static_cast<unsigned>(g.D) &&
           static_cast<unsigned>(ih) < static_cast<unsigned>(g.H) &&
           static_cast<unsigned>(iw) < static_cast<unsigned>(g.W);
  };
  auto offset = [&](int id, int ih, int iw, int c) {
    return ((static_cast<int64_t>(id) * g.H + ih) * g.W + iw) * g.C + c;
  };
  auto load = [&](int64_t k0) {
    if constexpr (kVec) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int64_t k = k0 + 16 * s;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (row_ok && k < g.K) {
          const int64_t tap = k / g.C;
          const int c = static_cast<int>(k - tap * g.C);
          const int tw = static_cast<int>(tap % g.kw);
          const int64_t t2 = tap / g.kw;
          const int th = static_cast<int>(t2 % g.kh);
          const int td = static_cast<int>(t2 / g.kh);
          const int id = id0 + td * g.dilation, ih = ih0 + th * g.dilation,
                    iw = iw0 + tw * g.dilation;
          if (in_volume(id, ih, iw))
            v = *reinterpret_cast<const uint4*>(xb + offset(id, ih, iw, c));
        }
        ra[s] = v;
      }
    } else {
      const int64_t tap = k0 / g.C;
      int c = static_cast<int>(k0 - tap * g.C);
      int tw = static_cast<int>(tap % g.kw);
      const int64_t t2 = tap / g.kw;
      int th = static_cast<int>(t2 % g.kh);
      int td = static_cast<int>(t2 / g.kh);
      uint32_t word[8];
#pragma unroll
      for (int j = 0; j < kBK; ++j) {
        uint32_t byte = 0;
        // td reaches kd exactly where k reaches K: the zero pad of K.
        if (row_ok && td < g.kd) {
          const int id = id0 + td * g.dilation, ih = ih0 + th * g.dilation,
                    iw = iw0 + tw * g.dilation;
          if (in_volume(id, ih, iw))
            byte = static_cast<uint8_t>(xb[offset(id, ih, iw, c)]);
        }
        word[j / 4] = (j % 4 == 0) ? byte : (word[j / 4] | (byte << (8 * (j % 4))));
        if (++c == g.C) {
          c = 0;
          if (++tw == g.kw) {
            tw = 0;
            if (++th == g.kh) {
              th = 0;
              ++td;
            }
          }
        }
      }
      ra[0] = make_uint4(word[0], word[1], word[2], word[3]);
      ra[1] = make_uint4(word[4], word[5], word[6], word[7]);
    }
    rb = b_ok ? *reinterpret_cast<const uint4*>(wrow + k0)
              : make_uint4(0u, 0u, 0u, 0u);
  };
  auto store = [&](int st) {
    *reinterpret_cast<uint4*>(&sa[st][tid * kRow]) = ra[0];
    *reinterpret_cast<uint4*>(&sa[st][tid * kRow + 16]) = ra[1];
    *reinterpret_cast<uint4*>(&sb[st][bn * kRow + bseg * 16]) = rb;
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;  // 2 x 2 warps of 64 x 32
  const int gq = lane >> 2, tq = lane & 3;  // mma fragment coordinates
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int64_t steps = g.k_pad / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int64_t kt = 0; kt < steps; ++kt) {
    const int st = static_cast<int>(kt & 1);
    if (kt + 1 < steps) load((kt + 1) * kBK);
    uint32_t af[4][4], bf[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // Rows gq and gq + 8, K columns 4 tq..4 tq+3 and 16 + those.
      const uint8_t* p = &sa[st][(wm * 64 + i * 16 + gq) * kRow + tq * 4];
      af[i][0] = *reinterpret_cast<const uint32_t*>(p);
      af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kRow);
      af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
      af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kRow + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // Column gq, K rows 4 tq..4 tq+3 and 16 + those.
      const uint8_t* q = &sb[st][(wn * 32 + j * 8 + gq) * kRow + tq * 4];
      bf[j][0] = *reinterpret_cast<const uint32_t*>(q);
      bf[j][1] = *reinterpret_cast<const uint32_t*>(q + 16);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    if (kt + 1 < steps) store(st ^ 1);
    __syncthreads();
  }

  // Epilogue: accumulator r of tile (i, j) is row gq + 8 (r / 2), column
  // 2 tq + r % 2 of that tile.
  const bool pairs = (g.F % 2) == 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int64_t n = n0 + wn * 32 + j * 8 + tq * 2;
    const float s0 = n < g.F ? scale[n] : 0.f, b0 = n < g.F ? bias[n] : 0.f;
    const float s1 = n + 1 < g.F ? scale[n + 1] : 0.f,
                b1 = n + 1 < g.F ? bias[n + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = m0 + wm * 64 + i * 16 + gq + 8 * h;
        if (row >= g.M || n >= g.F) continue;
        const float v0 =
            __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h]), s0), b0);
        const float v1 =
            __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), s1), b1);
        float* o = out + row * g.F + n;
        if (pairs) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (n + 1 < g.F) o[1] = v1;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

int64_t int8_conv3d_max_k() { return kMaxK; }

int int8_conv3d(const int8_t* x, const int8_t* w, const float* scale,
                const float* bias, float* out, int64_t batch, int64_t d,
                int64_t h, int64_t wd, int64_t c, int64_t f, int64_t kd,
                int64_t kh, int64_t kw, int64_t k_pad, int64_t stride,
                int64_t dilation, int64_t pd_lo, int64_t pd_hi, int64_t ph_lo,
                int64_t ph_hi, int64_t pw_lo, int64_t pw_hi, int64_t device,
                void* stream_handle) {
  Geometry g;
  g.D = d, g.H = h, g.W = wd, g.C = c, g.F = f;
  if (batch < 1 || d < 1 || h < 1 || wd < 1 || c < 1 || f < 1 || kd < 1 ||
      kh < 1 || kw < 1 || stride < 1 || dilation < 1 || pd_lo < 0 ||
      pd_hi < 0 || ph_lo < 0 || ph_hi < 0 || pw_lo < 0 || pw_hi < 0)
    return cudaErrorInvalidValue;
  g.K = kd * kh * kw * c;
  if (g.K > kMaxK || k_pad != (g.K + kBK - 1) / kBK * kBK)
    return cudaErrorInvalidValue;
  g.k_pad = k_pad;
  g.Do = (d + pd_lo + pd_hi - dilation * (kd - 1) - 1) / stride + 1;
  g.Ho = (h + ph_lo + ph_hi - dilation * (kh - 1) - 1) / stride + 1;
  g.Wo = (wd + pw_lo + pw_hi - dilation * (kw - 1) - 1) / stride + 1;
  if (d + pd_lo + pd_hi < dilation * (kd - 1) + 1 ||
      h + ph_lo + ph_hi < dilation * (kh - 1) + 1 ||
      wd + pw_lo + pw_hi < dilation * (kw - 1) + 1)
    return cudaErrorInvalidValue;
  g.M = batch * g.Do * g.Ho * g.Wo;
  g.kd = static_cast<int>(kd), g.kh = static_cast<int>(kh);
  g.kw = static_cast<int>(kw), g.stride = static_cast<int>(stride);
  g.dilation = static_cast<int>(dilation), g.pd = static_cast<int>(pd_lo);
  g.ph = static_cast<int>(ph_lo), g.pw = static_cast<int>(pw_lo);
  const int64_t blocks_m = (g.M + kBM - 1) / kBM;
  const int64_t blocks_n = (f + kBN - 1) / kBN;
  if (blocks_m > 0x7FFFFFFFLL || blocks_n > 65535 || d * h * wd > 0x7FFFFFFFLL)
    return cudaErrorInvalidValue;
  const bool vec = c % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  if ((reinterpret_cast<uintptr_t>(w) & 15) != 0 ||
      (f % 2 == 0 && (reinterpret_cast<uintptr_t>(out) & 7) != 0))
    return cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(blocks_m),
                  static_cast<unsigned>(blocks_n));
  auto stream = static_cast<cudaStream_t>(stream_handle);
  if (vec)
    int8_conv3d_kernel<true><<<grid, kThreads, 0, stream>>>(x, w, scale, bias,
                                                            out, g);
  else
    int8_conv3d_kernel<false><<<grid, kThreads, 0, stream>>>(x, w, scale,
                                                             bias, out, g);
  return cudaGetLastError();
}

}  // extern "C"
