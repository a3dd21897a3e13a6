// The backward of the stem max pool, MaxPool3d(k=3, stride=2, pad=1), for
// Hopper (sm_90a).
//
// Replaces multimodal_alzheimer_tpu/ops/pallas_maxpool.py _bwd_kernel (with
// its host side _bwd_pallas). Behind a plain C interface, loaded with ctypes
// by ops/_native.py and wrapped by ops/hopper_maxpool.py.
//
// What it computes, on NCDHW x (planes, D, H, W) and y, g (planes, Do, Ho, Wo):
//   dx[p, i] = sum of g[p, o] over the output windows o that contain input i
//              and whose winner is i,
// where the winner of a window is its first offset (od, oh, ow), in row-major
// order over the -inf-padded input, at which x == y. A window holding NaN has
// y = NaN and no winner; a winner in the padding credits nothing. The terms
// are added in ascending output index, starting from 0, one rounding per add
// (in bf16: add in float, round to bf16 after every add), which is
// SelectAndScatter's order and the Pallas kernel's.
//
// The TPU kernel walks D-slabs with a halo DMA'd into VMEM, splits H and W into
// parity quarters and leaves the re-interleave to XLA: workarounds for Mosaic's
// DMA alignment and its missing sublane interleave. None of that is needed
// here. Two launches, no atomics, so the same inputs give the same bits:
//   pass 1, one thread per output element: the window's winner offset (0-26,
//     or 27 for none) into a uint8 workspace (planes * Do * Ho * Wo bytes);
//   pass 2, one thread per 2x2x2 block of input elements: the 8 windows the
//     block lies in, each read once; each element adds its at most 8 windows
//     in ascending output order, each credited where its winner is this
//     element; dx is written exactly once, so no memset.
// Bound: memory. The function reads x, y and g once and writes dx once
// (at the ResNet-18 stem, batch 8, f32: 537 MB, 0.160 ms at 3.35 TB/s). This
// design also writes and reads the 7.6 MB workspace; pass 1's 27 reads per
// window and pass 2's 8 per thread hit the caches, not device memory. Each
// block takes a stretch of one slice of a plane, so a thread finds its place
// with one 32-bit division and addresses the slice in 32 bits; pass 1 makes
// all 27 compares of its window with no early exit, so its loads do not wait
// on each other. (A first version with a thread per input element, reading
// a window's code and g once for each element it may credit, and with 64-bit
// index arithmetic, took 1.73 ms at the stem; PERF.md has the times.)
//
// The entry point takes device pointers, int64 sizes, a dtype code (0 f32,
// 1 bf16), the device index and a cudaStream_t, allocates nothing, and
// returns the first CUDA error seen (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWindow = 3;
constexpr unsigned char kNoWinner = kWindow * kWindow * kWindow;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// acc + v with one rounding to T.
__device__ __forceinline__ float add_rounded(float acc, float v, float) {
  return __fadd_rn(acc, v);
}
__device__ __forceinline__ float add_rounded(float acc, float v,
                                             __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(__fadd_rn(acc, v)));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);  // exact: v is already a bf16 value
}

struct Shape {
  int planes, d, h, w, od, oh, ow;
};

// Pass 1: the first offset of each window (p, a, b, c) where x == y. Block
// (e, z) takes window e of plane z = p * Do + a, in the plane's flat (b, c)
// order; a plane of either array is addressed from its own base in 32 bits.
template <typename T>
__global__ void winner_kernel(const T* __restrict__ x, const T* __restrict__ y,
                              Shape s, unsigned char* __restrict__ winner) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= s.oh * s.ow) return;
  const int b = e / s.ow, c = e - b * s.ow;
  for (int z = blockIdx.y; z < s.planes * s.od; z += gridDim.y) {
    const int a = z % s.od;
    const int64_t p = z / s.od;
    const T* xp = x + p * s.d * s.h * s.w;
    const int64_t o = static_cast<int64_t>(z) * s.oh * s.ow + e;
    const float m = to_float(y[o]);
    // All 27 compares, with no early exit: the loads do not wait on each
    // other's results. The first offset that matches wins.
    int win = kNoWinner;
#pragma unroll
    for (int lin = kNoWinner - 1; lin >= 0; --lin) {
      const int i = 2 * a + lin / 9 - 1;
      const int j = 2 * b + (lin / 3) % 3 - 1;
      const int k = 2 * c + lin % 3 - 1;
      const bool inside = i >= 0 && i < s.d && j >= 0 && j < s.h && k >= 0 &&
                          k < s.w;
      const float v = inside ? to_float(xp[(i * s.h + j) * s.w + k])
                             : -__int_as_float(0x7f800000);  // the -inf pad
      win = v == m ? lin : win;
    }
    winner[o] = static_cast<unsigned char>(win);
  }
}

// Pass 2: dx of the 2x2x2 block of input elements (p, 2t + di, 2u + dj,
// 2v + dk), di, dj, dk in {0, 1}. Along one axis, element 2t lies in window t
// alone (at offset 1), and element 2t + 1 in windows t (offset 2) and t + 1
// (offset 0), in that, ascending, order; so the block's elements draw on the
// 8 windows (t + a, u + b, v + c), a, b, c in {0, 1}, whose winner codes and
// g the thread loads once. Block (e, z) takes element block e of slice
// z = p * ceil(D / 2) + t, in the slice's flat (u, v) order.
template <typename T>
__global__ void gather_kernel(const unsigned char* __restrict__ winner,
                              const T* __restrict__ g, Shape s,
                              T* __restrict__ dx) {
  const int bh = (s.h + 1) / 2, bw = (s.w + 1) / 2, bd = (s.d + 1) / 2;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= bh * bw) return;
  const int u = e / bw, v = e - u * bw;
  const int64_t plane_out = static_cast<int64_t>(s.od) * s.oh * s.ow;
  for (int z = blockIdx.y; z < s.planes * bd; z += gridDim.y) {
    const int t = z % bd;
    const int64_t p = z / bd;
    const unsigned char* wp = winner + p * plane_out;
    const T* gp = g + p * plane_out;
    // code[a][b][c] is the winner of window (t + a, u + b, v + c), or 255
    // where that window lies outside the output.
    int code[2][2][2];
    float gv[2][2][2];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const bool in = t + a < s.od && u + b < s.oh && v + c < s.ow;
          const int o = in ? ((t + a) * s.oh + u + b) * s.ow + v + c : 0;
          code[a][b][c] = in ? wp[o] : 255;
          gv[a][b][c] = in ? to_float(gp[o]) : 0.0f;
        }
    T* out = dx + static_cast<int64_t>(p) * s.d * s.h * s.w;
#pragma unroll
    for (int di = 0; di < 2; ++di)
#pragma unroll
      for (int dj = 0; dj < 2; ++dj)
#pragma unroll
        for (int dk = 0; dk < 2; ++dk) {
          const int i = 2 * t + di, j = 2 * u + dj, k = 2 * v + dk;
          if (i >= s.d || j >= s.h || k >= s.w) continue;
          float acc = 0.0f;
          // Windows a = 0 (offset 2 for an odd element, 1 for an even one)
          // then a = 1 (offset 0, odd elements only), on each axis.
#pragma unroll
          for (int a = 0; a <= di; ++a)
#pragma unroll
            for (int b = 0; b <= dj; ++b)
#pragma unroll
              for (int c = 0; c <= dk; ++c) {
                const int od = di ? 2 - 2 * a : 1;
                const int oh = dj ? 2 - 2 * b : 1;
                const int ow = dk ? 2 - 2 * c : 1;
                if (code[a][b][c] == (od * kWindow + oh) * kWindow + ow)
                  acc = add_rounded(acc, gv[a][b][c], T());
              }
          store(out + (i * s.h + j) * s.w + k, acc);
        }
  }
}

dim3 grid(int plane, int planes) {
  constexpr int kMaxY = 65535;
  return dim3((plane + kThreads - 1) / kThreads, planes < kMaxY ? planes : kMaxY);
}

template <typename T>
cudaError_t run(const void* x, const void* y, const void* g,
                unsigned char* winner, void* dx, Shape s, cudaStream_t stream) {
  winner_kernel<T><<<grid(s.oh * s.ow, s.planes * s.od), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), s, winner);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gather_kernel<T><<<grid(((s.h + 1) / 2) * ((s.w + 1) / 2),
                          s.planes * ((s.d + 1) / 2)),
                     kThreads, 0, stream>>>(
      winner, static_cast<const T*>(g), s, static_cast<T*>(dx));
  return cudaGetLastError();
}

int64_t pooled(int64_t n) { return (n - 1) / 2 + 1; }

}  // namespace

extern "C" {

// dx (planes, D, H, W) of MaxPool3d(3, 2, 1) from x (planes, D, H, W) and
// y, g (planes, Do, Ho, Wo), Do = (D - 1) / 2 + 1 and so on; workspace holds
// planes * Do * Ho * Wo bytes. dtype: 0 float32, 1 bfloat16.
int maxpool_bwd(const void* x, const void* y, const void* g, void* workspace,
                void* dx, int64_t planes, int64_t d, int64_t h, int64_t w,
                int64_t dtype, int64_t device, void* stream_handle) {
  // planes * D and one plane, D * H * W, are indexed in 32-bit ints.
  if (planes < 1 || d < 1 || h < 1 || w < 1 || planes * d > 0x7FFFFFFFLL ||
      d * h * w > 0x7FFFFFFFLL)
    return cudaErrorInvalidValue;
  const Shape s{static_cast<int>(planes), static_cast<int>(d),
                static_cast<int>(h), static_cast<int>(w),
                static_cast<int>(pooled(d)), static_cast<int>(pooled(h)),
                static_cast<int>(pooled(w))};
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  auto stream = static_cast<cudaStream_t>(stream_handle);
  auto work = static_cast<unsigned char*>(workspace);
  if (dtype == 0) return run<float>(x, y, g, work, dx, s, stream);
  if (dtype == 1) return run<__nv_bfloat16>(x, y, g, work, dx, s, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
