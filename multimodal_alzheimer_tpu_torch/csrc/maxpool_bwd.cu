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
// here. One launch, no workspace, no atomics. Block (s, p) owns plane p and
// the slab of Td output slices [a0, a0 + Td), a0 = s * Td:
//   1. it stages in shared memory the input slices [2 a0 - 1, 2 a0 + 2 Td - 1]
//      (the -inf halo outside the volume is handled by index, never stored)
//      and y and g of the windows [a0, a0 + Td], each as one contiguous
//      range: whole 16-byte chunks by cp.async, the partial chunks at either
//      end element by element, so any alignment is taken;
//   2. it computes each window's winner code (0-26, or 27 for none) into
//      shared memory as uint8. Each thread loads all 27 taps of its window
//      with no branch and no early exit, sets a bit per tap equal to y, and
//      masks the taps in the padding (which match exactly when y is -inf);
//      the code is the lowest bit set. The slab's last odd input slice,
//      2 a0 + 2 Td - 1, lies also in window a0 + Td, at offset od = 0; since
//      od is the outermost of the row-major order, that window credits the
//      slice exactly when its first match among the 9 offsets of od = 0 is
//      the element, so the block computes those 9 compares again from the
//      slice it holds and needs nothing of the next slab;
//   3. it computes dx of its input slices [2 a0, 2 a0 + 2 Td) and stores
//      it straight to device memory: a thread per 2x2x2 block of inputs
//      reads the codes and g of the block's 8 windows once, each element
//      adds the credits of its at most 8 windows in ascending output order,
//      and neighbouring threads store neighbouring pairs of a row, element
//      by element (one 8-byte store a pair in f32, or 4-byte in bf16, ran
//      slower on an H100; PERF.md).
// Td is at most 8 and is chosen per shape (below, "Slab depth"), among the
// depths whose shared memory lets three blocks of 512 threads share an SM,
// so that one block's copies run under another's compares: at the ResNet-18
// stem 2 in f32 (68 KB), 5 in bf16 (75 KB). (Blocks of 256 or 1024 threads,
// and budgets for 2 or 4 blocks an SM, were slower there on an H100;
// PERF.md has the times.) A volume whose slab of one output slice does not
// fit in a block's 227 KB is refused (the wrapper raises): f32 slices up to
// about 14,000 elements fit, the stem's have 2,530.
// Bound: memory. The function reads x, y and g once and writes dx once (at
// the ResNet-18 stem, batch 8, f32: 537 MB, 0.160 ms at 3.35 TB/s); this
// design reads the slab's first input slice twice (Td + 1/2 slices of x per
// Td of dx) and the window y and g of one slice twice, the second reads
// mostly from the L2.
//
// Slab depth. A depth window's grid is short: 11 output slices of 128
// planes at one rank's [tp] window. There the grid is one or two rounds of
// resident blocks, and what a round costs is the most that one SM was
// given: slabs of 5 slices of 11 (5, 5, 1) put three 5-slice slabs on some
// SMs and three 1-slice ones on others. The launch takes the Td of least
// modelled time, max(the grid's bytes over the SMs, the first round's most
// bytes on one SM with block i on SM i mod SMs), a block's bytes being its
// own slices of x, y, g and dx and half its halo slices (which the L2
// mostly serves); the deeper slab on a tie. On an H100 this picks the
// fastest Td of 1-8, or one within 0.5% of it, at the [tp] windows and the
// stem in both dtypes (PERF.md): the stem's Td stays 2 / 5, a bf16
// window's goes from 5 to 3. (Blocks that cut the plane into H-tiles with
// halo rows, and blocks that walk several planes staging the next one's x
// under the dx, were built and measured too: slower at every one of those
// shapes.)
//
// A depth window (maxpool_bwd_window), for a volume whose depth is sharded
// over several processes (parallel/tp.py): x holds the global input planes
// [z0, z0 + Dw) of a volume of global depth D, and y and g the outputs
// [o0, o0 + Do) whose windows those planes cover, z0 = max(2 o0 - 1, 0), so
// the stride-2 windows stay aligned; the window ends at min(2 (o0 + Do), D).
// Planes before 0 and from D on are the -inf padding, as for a whole volume;
// a window of an interior slab has none, but its first plane 2 o0 - 1 (the
// "lead" plane) lies in window o0 at od = 0 alone. With the lead plane set
// aside, the window is a volume of depth D' = Dw - lead whose outputs are
// the Do windows over it; a block reads the lead plane as a real slice
// where a whole volume has padding, and the first block computes its dx as
// every block computes its own last odd slice, from window o0's offsets od
// = 0. The winners and the order of adds are the global ones; a plane that
// windows of two slabs share gets each slab's credits, which the caller
// adds. The whole volume is the window (0, D) with no lead plane.
//
// The entry points take device pointers, int64 sizes, a dtype code (0 f32,
// 1 bf16), the device index and a cudaStream_t, allocate nothing, and
// return the first CUDA error seen (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kThreads = 512;
constexpr int kWindow = 3;
constexpr int kNoWinner = kWindow * kWindow * kWindow;
constexpr int kChunk = 16;  // bytes of one cp.async
constexpr int kMaxSlab = 8;
// Shared memory of one block such that three share an SM's 228 KB (1 KB of
// each block's is reserved), and the most one block may take.
constexpr int64_t kSlabBudget = (233472 - 3 * 1024) / 3;
constexpr int64_t kMaxSmem = 232448;
constexpr int kMaxY = 65535;

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

// Exact: v is already a value of T.
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// d: the depth after the lead plane (D'); lead: 1 if x and dx hold the
// plane before, else 0 (a plane of x and dx takes d + lead slices).
struct Shape {
  int planes, d, h, w, od, oh, ow, lead;
};

int64_t round16(int64_t bytes) {
  return (bytes + kChunk - 1) / kChunk * kChunk;
}

// Bytes of shared memory a staged range of n elements takes: the range
// starts where its global address does modulo 16. (The x region has kChunk
// guard bytes more in front, which a masked tap of the first row may read.)
int64_t region_bytes(int64_t n, int64_t item) {
  return round16(n * item) + kChunk;
}

struct Layout {
  int x_bytes, y_bytes, codes_bytes;
  int total() const { return x_bytes + 2 * y_bytes + codes_bytes; }
};

Layout layout(const Shape& s, int td, int64_t item) {
  const int64_t hw = static_cast<int64_t>(s.h) * s.w;
  const int64_t ohw = static_cast<int64_t>(s.oh) * s.ow;
  const int64_t x_bytes = kChunk + region_bytes((2 * td + 1) * hw, item);
  return Layout{static_cast<int>(x_bytes),
                static_cast<int>(region_bytes((td + 1) * ohw, item)),
                static_cast<int>((td + 1) * ohw)};
}

// The deepest slab (output slices) that lets three blocks share an SM,
// else 1 if it fits a block at all, else 0.
int slab_slices(const Shape& s, int64_t item) {
  const int64_t hw = static_cast<int64_t>(s.h) * s.w;
  if (hw > (kMaxSmem / item)) return 0;  // keeps layout() within int
  for (int td = s.od < kMaxSlab ? s.od : kMaxSlab; td >= 1; --td)
    if (layout(s, td, item).total() <= kSlabBudget) return td;
  return layout(s, 1, item).total() <= kMaxSmem ? 1 : 0;
}

// Copies src[0, n) into `region` (16-byte aligned) so that element e lands
// at region + head + e * sizeof(T), head = src's address modulo 16: whole
// 16-byte chunks by cp.async (not waited for here), the partial chunks at
// either end element by element. Returns the staged copy of src[0].
template <typename T>
__device__ const T* stage(const T* src, int n, unsigned char* region) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
  const int head = static_cast<int>(addr % kChunk);
  const auto* base = reinterpret_cast<const unsigned char*>(addr - head);
  const int end = head + n * static_cast<int>(sizeof(T));
  for (int lo = threadIdx.x * kChunk; lo < end; lo += kThreads * kChunk) {
    if (lo >= head && lo + kChunk <= end) {
      cp_async16(region + lo, base + lo);
    } else {
      const int from = lo > head ? lo : head;
      const int to = lo + kChunk < end ? lo + kChunk : end;
      for (int byte = from; byte < to; byte += sizeof(T))
        *reinterpret_cast<T*>(region + byte) =
            *reinterpret_cast<const T*>(base + byte);
    }
  }
  return reinterpret_cast<const T*>(region + head);
}

// Bits of the 27 offsets lin = (od * 3 + oh) * 3 + ow whose od, oh or ow
// is 0 or 2.
constexpr unsigned kAllTaps = (1u << kNoWinner) - 1;
constexpr unsigned kOd0 = 0x1FFu, kOd2 = kOd0 << 18;
constexpr unsigned kOh0 = 0x7u | 0x7u << 9 | 0x7u << 18, kOh2 = kOh0 << 6;
constexpr unsigned kOw0 = 0x1249249u, kOw2 = kOw0 << 2;

// Winner code of window (a, b, c), from the staged slices [xi0, xi1) at
// sx. kTaps 27 compares every offset, 9 those of od = 0 alone (the halo
// window). All its loads are made, none waits on a compare: an offset in
// the -inf padding reads a neighbour (a clamped slice or row, the element
// before or after the row, or the region's guard bytes) and is masked
// afterwards, where it matches exactly when y is -inf.
template <int kTaps, typename T>
__device__ __forceinline__ int winner(const T* sx, int a, int b, int c,
                                      int xi0, int xi1, const Shape& s,
                                      int hw, float m) {
  constexpr unsigned taps = kTaps == 27 ? kAllTaps : kOd0;
  unsigned valid = taps;
  if (2 * a - 1 < -s.lead) valid &= ~kOd0;
  if (2 * a + 1 >= s.d) valid &= ~kOd2;
  if (2 * b - 1 < 0) valid &= ~kOh0;
  if (2 * b + 1 >= s.h) valid &= ~kOh2;
  if (2 * c - 1 < 0) valid &= ~kOw0;
  if (2 * c + 1 >= s.w) valid &= ~kOw2;
  unsigned hits = 0;
#pragma unroll
  for (int od = 0; od < kTaps / 9; ++od) {
    int i = 2 * a - 1 + od;
    i = (i < xi0 ? xi0 : i >= xi1 ? xi1 - 1 : i) - xi0;
#pragma unroll
    for (int oh = 0; oh < kWindow; ++oh) {
      int j = 2 * b - 1 + oh;
      j = j < 0 ? 0 : j >= s.h ? s.h - 1 : j;
      const T* row = sx + i * hw + j * s.w + 2 * c - 1;
#pragma unroll
      for (int ow = 0; ow < kWindow; ++ow)
        if (to_float(row[ow]) == m) hits |= 1u << ((od * 3 + oh) * 3 + ow);
    }
  }
  hits &= valid;
  if (m == -__int_as_float(0x7f800000)) hits |= taps & ~valid;
  return hits ? __ffs(hits) - 1 : kNoWinner;
}

// At least three blocks an SM: the registers may not cut the blocks that
// the shared memory lets an SM hold.
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
    maxpool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                       const T* __restrict__ g, T* __restrict__ dx, Shape s,
                       int td, Layout lay) {
  extern __shared__ __align__(16) unsigned char smem[];
  // The x region starts after kChunk guard bytes.
  unsigned char* x_region = smem + kChunk;
  unsigned char* y_region = smem + lay.x_bytes;
  unsigned char* g_region = y_region + lay.y_bytes;
  unsigned char* codes = g_region + lay.y_bytes;
  const int hw = s.h * s.w, ohw = s.oh * s.ow;
  const int a0 = blockIdx.x * td;
  // Windows [a0, ae) have codes here: the slab's, and the halo window a0 + Td
  // (offsets od = 0 only) unless the slab is the last.
  const int full_end = a0 + td < s.od ? a0 + td : s.od;
  const int ae = a0 + td + 1 < s.od ? a0 + td + 1 : s.od;
  const int n_win = ae - a0;
  // Staged input slices [xi0, xi1); the slab's n_dx input slices from 2 a0.
  // Slices index the depth after the lead plane, which is slice -1.
  const int xi0 = 2 * a0 - 1 > -s.lead ? 2 * a0 - 1 : -s.lead;
  const int xi1 = 2 * a0 + 2 * td < s.d ? 2 * a0 + 2 * td : s.d;
  const int n_dx = xi1 - 2 * a0;
  // The first block of a window with a lead plane computes its dx too: the
  // slab's dx slices are [i_first, n_dx) from 2 a0.
  const int i_first = a0 == 0 && s.lead ? -1 : 0;
  const int bh = (s.h + 1) / 2, bw = (s.w + 1) / 2;
  const int64_t stride = static_cast<int64_t>(s.d + s.lead) * hw;
  for (int64_t p = blockIdx.y; p < s.planes; p += gridDim.y) {
    const T* sx =
        stage(x + p * stride + (s.lead + xi0) * hw, (xi1 - xi0) * hw, x_region);
    const T* sy = stage(y + (p * s.od + a0) * ohw, n_win * ohw, y_region);
    cp_async_commit();
    const T* sg = stage(g + (p * s.od + a0) * ohw, n_win * ohw, g_region);
    cp_async_commit();
    cp_async_wait<1>();  // x and y; g may still be in flight
    __syncthreads();

    for (int e = threadIdx.x; e < n_win * ohw; e += kThreads) {
      const int la = e / ohw, rem = e - la * ohw;
      const int b = rem / s.ow, c = rem - b * s.ow;
      const float m = to_float(sy[e]);
      codes[e] = static_cast<unsigned char>(
          a0 + la < full_end
              ? winner<27>(sx, a0 + la, b, c, xi0, xi1, s, hw, m)
              : winner<9>(sx, a0 + la, b, c, xi0, xi1, s, hw, m));
    }
    cp_async_wait<0>();
    __syncthreads();  // codes made, g staged

    // dx of the slab straight to device memory. A thread takes a 2x2x2
    // block of input elements (2t + di, 2u + dj, 2v + dk): along one axis,
    // element 2t lies in window t alone (at offset 1), and element 2t + 1
    // in windows t (offset 2) and t + 1 (offset 0), in that, ascending,
    // order; so the block draws on the 8 windows (t + da, u + db, v + dc),
    // whose codes and g it reads once. Neighbouring threads take
    // neighbouring v, so a warp stores whole runs of a row.
    T* out = dx + p * stride + (s.lead + 2 * a0) * hw;
    for (int q = threadIdx.x; q < ((n_dx + 1) / 2 - i_first) * bh * bw;
         q += kThreads) {
      const int tq = q / (bh * bw), rem = q - tq * bh * bw;
      const int t = tq + i_first;
      const int u = rem / bw, v = rem - u * bw;
      int code[2][2][2];
      float gv[2][2][2];
#pragma unroll
      for (int da = 0; da < 2; ++da)
#pragma unroll
        for (int db = 0; db < 2; ++db)
#pragma unroll
          for (int dc = 0; dc < 2; ++dc) {
            const bool in = t + da >= 0 && t + da < n_win &&
                            u + db < s.oh && v + dc < s.ow;
            const int o = in ? ((t + da) * s.oh + u + db) * s.ow + v + dc : 0;
            code[da][db][dc] = in ? codes[o] : 255;
            gv[da][db][dc] = in ? to_float(sg[o]) : 0.0f;
          }
#pragma unroll
      for (int di = 0; di < 2; ++di)
#pragma unroll
        for (int dj = 0; dj < 2; ++dj) {
          const int i = 2 * t + di, j = 2 * u + dj;
          if (i < i_first || i >= n_dx || j >= s.h) continue;
          float acc[2];
#pragma unroll
          for (int dk = 0; dk < 2; ++dk) {
            acc[dk] = 0.0f;
#pragma unroll
            for (int da = 0; da <= di; ++da)
#pragma unroll
              for (int db = 0; db <= dj; ++db)
#pragma unroll
                for (int dc = 0; dc <= dk; ++dc) {
                  const int od = di ? 2 - 2 * da : 1;
                  const int oh = dj ? 2 - 2 * db : 1;
                  const int ow = dk ? 2 - 2 * dc : 1;
                  if (code[da][db][dc] == (od * kWindow + oh) * kWindow + ow)
                    acc[dk] = add_rounded(acc[dk], gv[da][db][dc], T());
                }
          }
          T* row = out + i * hw + j * s.w + 2 * v;
          from_float(acc[0], row);
          if (2 * v + 1 < s.w) from_float(acc[1], row + 1);
        }
    }
    __syncthreads();  // the next plane's copies overwrite shared memory
  }
}

template <typename T>
cudaError_t run(const void* x, const void* y, const void* g, void* dx,
                const Shape& s, int td, cudaStream_t stream) {
  const Layout lay = layout(s, td, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      maxpool_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      lay.total());
  if (err != cudaSuccess) return err;
  // All of L1's room as shared memory, so three blocks fit on an SM.
  err = cudaFuncSetAttribute(maxpool_bwd_kernel<T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.od + td - 1) / td, s.planes < kMaxY ? s.planes : kMaxY);
  maxpool_bwd_kernel<T><<<grid, kThreads, lay.total(), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(g), static_cast<T*>(dx), s, td, lay);
  return cudaGetLastError();
}

int64_t pooled(int64_t n) { return (n - 1) / 2 + 1; }

int64_t item_size(int64_t dtype) { return dtype == 0 ? 4 : 2; }

bool valid(int64_t planes, int64_t d, int64_t h, int64_t w, int64_t dtype,
           int64_t lead = 0) {
  // planes * D and one plane, D * H * W, are indexed in 32-bit ints.
  return planes >= 1 && d >= 1 && h >= 1 && w >= 1 &&
         (lead == 0 || lead == 1) && planes * (d + lead) <= 0x7FFFFFFFLL &&
         (d + lead) * h * w <= 0x7FFFFFFFLL && (dtype == 0 || dtype == 1);
}

Shape shape_of(int64_t planes, int64_t d, int64_t h, int64_t w,
               int64_t lead = 0) {
  return Shape{static_cast<int>(planes),    static_cast<int>(d),
               static_cast<int>(h),         static_cast<int>(w),
               static_cast<int>(pooled(d)), static_cast<int>(pooled(h)),
               static_cast<int>(pooled(w)), static_cast<int>(lead)};
}

// Blocks of `smem` bytes that one SM holds at once (0 if none fits), by the
// kernel's registers, threads and shared memory.
template <typename T>
int occupancy(int smem) {
  const void* fn = reinterpret_cast<const void*>(maxpool_bwd_kernel<T>);
  int blocks = 0;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                    smem) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return blocks;
}

// A slab depth with its grid, the blocks the card holds at once and the
// model's cost (bytes on the busiest SM).
struct Plan {
  int td;
  int64_t blocks, resident, smem;
  double cost;
};

Plan plan(const Shape& s, int td, int64_t item, int sms) {
  const int64_t slabs = (s.od + td - 1) / td;
  const int64_t rows = s.planes < kMaxY ? s.planes : kMaxY;
  const int64_t smem = layout(s, td, item).total();
  const int occ = item == 4 ? occupancy<float>(static_cast<int>(smem))
                            : occupancy<__nv_bfloat16>(static_cast<int>(smem));
  Plan out{td, slabs * rows, static_cast<int64_t>(occ) * sms, smem, -1.0};
  if (out.resident == 0) return out;
  // Bytes of one block of slab k: its own slices of x, y, g and dx, and
  // half of its halo slices.
  const double hw = static_cast<double>(s.h) * s.w, ohw = 1.0 * s.oh * s.ow;
  auto work = [&](int64_t k) {
    const int a0 = static_cast<int>(k) * td;
    const int full = (a0 + td < s.od ? a0 + td : s.od) - a0;
    const int n_win = (a0 + td + 1 < s.od ? a0 + td + 1 : s.od) - a0;
    const int xi0 = 2 * a0 - 1 > -s.lead ? 2 * a0 - 1 : -s.lead;
    const int xi1 = 2 * a0 + 2 * td < s.d ? 2 * a0 + 2 * td : s.d;
    const int own = xi1 - 2 * a0 + (a0 == 0 && s.lead ? 1 : 0);
    return item * ((2.0 * own + 0.5 * (xi1 - xi0 - own)) * hw +
                   2.0 * (full + 0.5 * (n_win - full)) * ohw);
  };
  double total = 0.0;
  for (int64_t k = 0; k < slabs; ++k) total += work(k) * s.planes;
  // The first round: block i (slab i mod slabs) on SM i mod sms.
  double busiest = 0.0;
  const int64_t first = out.blocks < out.resident ? out.blocks : out.resident;
  for (int64_t sm = 0; sm < sms && sm < first; ++sm) {
    double on = 0.0;
    for (int64_t i = sm; i < first; i += sms) on += work(i % slabs);
    busiest = on > busiest ? on : busiest;
  }
  out.cost = total / sms > busiest ? total / sms : busiest;
  return out;
}

// The slab depth for a shape (cached per device and shape): of 1 to
// slab_slices(), the one of least cost, the deepest on a tie; slab_slices()
// where the model has no answer (a depth of 1 that fits no three blocks).
Plan choose(const Shape& s, int64_t item, int device) {
  static std::mutex lock;
  static std::map<std::tuple<int, int, int, int, int, int, int64_t>, Plan>
      cache;
  const auto key = std::make_tuple(device, s.planes, s.d, s.h, s.w, s.lead,
                                   item);
  std::lock_guard<std::mutex> guard(lock);
  const auto hit = cache.find(key);
  if (hit != cache.end()) return hit->second;
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    sms = 0;
  const int deepest = slab_slices(s, item);
  Plan best = plan(s, deepest, item, sms);
  for (int td = deepest - 1; td >= 1 && best.cost >= 0.0; --td) {
    const Plan p = plan(s, td, item, sms);
    if (p.cost >= 0.0 && p.cost < best.cost) best = p;
  }
  cache[key] = best;
  return best;
}

int launch(const void* x, const void* y, const void* g, void* dx,
           const Shape& s, int td, int64_t dtype, int64_t device,
           void* stream_handle) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  auto stream = static_cast<cudaStream_t>(stream_handle);
  if (td == 0) td = choose(s, item_size(dtype), static_cast<int>(device)).td;
  if (td > s.od) td = s.od;
  if (dtype == 0) return run<float>(x, y, g, dx, s, td, stream);
  return run<__nv_bfloat16>(x, y, g, dx, s, td, stream);
}

}  // namespace

extern "C" {

// Output slices of the deepest slab that lets three blocks share an SM for
// a plane of D x H x W elements of this dtype; 0 if a slab of one does not
// fit in shared memory (maxpool_bwd then refuses the shape).
int64_t maxpool_bwd_slab(int64_t d, int64_t h, int64_t w, int64_t dtype) {
  if (!valid(1, d, h, w, dtype)) return 0;
  return slab_slices(shape_of(1, d, h, w), item_size(dtype));
}

// The slab depth maxpool_bwd (lead 0) or maxpool_bwd_window (lead 1) takes
// for planes of Dw x H x W on `device`, into out[0, 4): Td, blocks,
// resident blocks on the card, shared memory bytes a block. Returns 0, or
// a CUDA error.
int maxpool_bwd_plan(int64_t planes, int64_t dw, int64_t h, int64_t w,
                     int64_t lead, int64_t dtype, int64_t device,
                     int64_t* out) {
  if (!valid(planes, dw - lead, h, w, dtype, lead))
    return cudaErrorInvalidValue;
  const Shape s = shape_of(planes, dw - lead, h, w, lead);
  if (slab_slices(s, item_size(dtype)) == 0) return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const Plan p = choose(s, item_size(dtype), static_cast<int>(device));
  const int64_t v[4] = {p.td, p.blocks, p.resident, p.smem};
  for (int i = 0; i < 4; ++i) out[i] = v[i];
  return 0;
}

// dx (planes, D, H, W) of MaxPool3d(3, 2, 1) from x (planes, D, H, W) and
// y, g (planes, Do, Ho, Wo), Do = (D - 1) / 2 + 1 and so on. dtype: 0
// float32, 1 bfloat16. td: output slices a block, 0 to let the kernel
// choose (tests and timing force others); more than a block holds is
// refused.
int maxpool_bwd(const void* x, const void* y, const void* g, void* dx,
                int64_t planes, int64_t d, int64_t h, int64_t w,
                int64_t dtype, int64_t td, int64_t device,
                void* stream_handle) {
  if (!valid(planes, d, h, w, dtype) || td < 0 || td > kMaxSlab)
    return cudaErrorInvalidValue;
  const Shape s = shape_of(planes, d, h, w);
  if (slab_slices(s, item_size(dtype)) == 0 ||
      (td > 0 && layout(s, td, item_size(dtype)).total() > kMaxSmem))
    return cudaErrorInvalidValue;
  return launch(x, y, g, dx, s, static_cast<int>(td), dtype, device,
                stream_handle);
}

// The same on a depth window: x and dx (planes, Dw, H, W) hold global input
// planes [z0, z0 + Dw), y and g (planes, Do, Ho, Wo) the outputs [o0, o0 +
// Do); lead is 1 where z0 = 2 o0 - 1 (an interior slab), 0 where z0 = 0.
// Then Do = (Dw - lead - 1) / 2 + 1: the caller checks the window.
int maxpool_bwd_window(const void* x, const void* y, const void* g, void* dx,
                       int64_t planes, int64_t dw, int64_t h, int64_t w,
                       int64_t lead, int64_t dtype, int64_t td,
                       int64_t device, void* stream_handle) {
  if (!valid(planes, dw - lead, h, w, dtype, lead) || td < 0 ||
      td > kMaxSlab)
    return cudaErrorInvalidValue;
  const Shape s = shape_of(planes, dw - lead, h, w, lead);
  if (slab_slices(s, item_size(dtype)) == 0 ||
      (td > 0 && layout(s, td, item_size(dtype)).total() > kMaxSmem))
    return cudaErrorInvalidValue;
  return launch(x, y, g, dx, s, static_cast<int>(td), dtype, device,
                stream_handle);
}

}  // extern "C"
