// int8 3D convolution with a fused epilogue for Hopper (sm_90a).
//
// One entry point behind a plain C interface, loaded with ctypes by
// ops/_native.py and wrapped by ops/int8_conv.py:
//
// int8_conv3d (replaces multimodal_alzheimer_tpu/inference/quantize.py
//   _conv_int8, which XLA lowers as conv_general_dilated with int8 operands
//   and preferred_element_type=int32; no Pallas kernel), then the int8
//   graph's next elementwise steps (quantize.py _backbone_forward), in this
//   order:
//     v = float32(sum_k x[b, o + tap(k), c(k)] * w[f, k]) * scale[f] + bias[f]
//     v = v + r[b, o, f]            (residual: none, float32, or an int8
//         or v + float32(q) * s      carrier q with its scale s: dequant)
//     v = max(v, 0)                 (relu, optional)
//     out = v  or  clamp(rint(v * inv), -127, 127) as int8 (the requant)
//   over a (B, D, H, W, C) int8 input in channels-last order, weights packed
//   as (F, K_pad) int8 with k = ((td * kh + th) * kw + tw) * C + c (tap-major,
//   channel-minor, zero columns past K = kd * kh * kw * C up to a multiple of
//   32), and a (B, Do, Ho, Wo, F) float32 or int8 output (the residual has
//   the output's shape). One stride and one dilation for all three
//   dimensions, a (lo, hi) zero pad for each.
//
// Design: an implicit GEMM, M = B * Do * Ho * Wo output voxels by N = F
// output channels by K, int32 sums, on wgmma.mma_async m64nNk32 s32.s8.s8
// with both operands in shared memory, K-major (channels-last activations,
// weights packed (F, K_pad)), 128-byte swizzled rows. A block of 384 threads
// computes one 128 x BN tile (BN = 64 for F <= 64, 128 for F <= 128, else
// 256; 128 where C is not a multiple of 16), one tile per block, the M tile
// outer and the N tile inner in the grid so neighbouring blocks share A:
//   * warpgroup 0 loads (setmaxnreg down to 96 or 120 registers). For each
//     128-byte step of K it fills one stage of a ring of 4 (BN 256), 6
//     (128) or 8 (64) stages, 192 KB of shared memory in every case:
//       - B (weights): one thread issues a tiled TMA copy of the (BN, 128)
//         box of the 2-D (F, K_pad) tensor (cuTensorMapEncodeTiled,
//         128-byte swizzle); the corners past F and K_pad read zeros;
//       - A (im2col rows) where C is a multiple of 16 (every ResNet layer
//         after the stem): 16-byte cp.async copies, each inside one tap,
//         src-size 0 (zero fill) for taps outside the volume and K past its
//         end: symmetric int8 has zero point 0, so the zero pad is exact.
//         Thread t copies chunk t % 8 of rows t / 8 + 16 i, so eight
//         neighbours read one row's 128 contiguous bytes where C >= 128;
//         each thread keeps two steps in flight, then waits for its oldest
//         group, fences the async proxy and arrives on that stage's
//         barrier;
//       - A for any other C, K longer than the ring: the thread of each
//         row gathers its bytes into registers (all offsets of a chunk
//         first, then the loads with no branch between them) and stores
//         them 16 at a time.
//     A stage is full when its 128 row arrivals and the TMA's bytes are in
//     (an mbarrier with a transaction count).
//   * warpgroups 1 and 2 multiply (setmaxnreg up to 200 or 192), 64 rows
//     each: wait for a full stage, wgmma.fence, four m64nBNk32 with
//     descriptors advanced 32 bytes along the swizzled row (the first
//     product of a tile overwrites the accumulators, so no other
//     instruction defines them), commit, and wait for the group before
//     last, whose stage each warp then gives back to the loader. The
//     accumulators are not touched between a commit and its wait.
//   * Where C is not a multiple of 16, F <= 64 and K fits the ring (the
//     C = 1 and C = 2 stems, the PET tower's narrow blocks: 1 to 8 steps) a
//     second kernel, int8_conv3d_gathered, takes the tile: the stem's cost
//     is its byte gather, not its 3 K steps (below).
//   Every A path writes the layout the TMA's 128-byte swizzle writes
//   (16-byte chunk j of row r at r * 128 + 16 * (j ^ (r % 8))), which the
//   wgmma descriptors name (SBO 1024 bytes, 1 KB-aligned stages).
// The epilogue works from the accumulators in registers: each int32 sum
// converted to float32 (round to nearest, as XLA's convert), then every
// step above with __fmul_rn / __fadd_rn (nvcc would contract a * s + b
// into one FMA; JAX and torch round each operation) and __float2int_rn
// (round half to even, as torch.round), so the kernel equals the plain
// version (ops/int8_conv.int8_conv3d_fused_plain) bit for bit. The output
// type is a template switch; the residual's kind and the ReLU are uniform
// branches of each launch: each mainloop instance costs seconds of ptxas,
// and six ring instances (3 tile widths x 2 output types) and two gathered
// ones cover every mode.
//
// Overflow: |x|, |w| <= 127 and K < 133,143 keep every sum below 2^31; the
// wrapper and this entry point refuse a larger K, and M of 2^31 or more.
//
// Bounds on one H100 SXM (1,979 TOP/s dense int8, 3.35 TB/s): the 3^3 convs
// of ResNet-18's layers 2-4 are bound by operations (2 M N K; layers 3-4
// hold 1.0 of the 1.2 TOP of a forward at batch 8). The design keeps the
// tensor cores fed from a deep ring with 128 x 256 tiles where F allows
// (fewer bytes of L2 traffic per operation) and one wave of 126 or two of
// 252 tiles at the 16,128-row layers of batch 8: layers 3-4 run at 44-72%
// of the int8 peak there, ahead of torch._int_mm's GEMM of the same M, N
// and K alone. What holds it back is L2 traffic (each stage reads 48 KB from L2
// for 8.4 M operations), which TMA's im2col mode would not lower: the A
// rows go through cp.async, not im2col TMA. The stem (C = 1, 7^3, stride
// 2) and the 1^3 downsamples are bound by bytes, mostly the output: the
// int8 output mode writes 1 byte a value in place of 4, with no separate
// ReLU, round, clamp, multiply or cast pass over it. The stem's own limit
// is the byte gather.
//
// The entry point takes device pointers, int64 sizes, the device index and a
// cudaStream_t, encodes the weights' TMA descriptor (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint: the library links no libcuda),
// allocates nothing, launches once, and returns the first CUDA error seen (0
// on success); it refuses a geometry it cannot take with
// cudaErrorInvalidValue.

#include <cuda.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kBM = 128;       // output voxels per tile, 64 per consumer
constexpr int kBK = 128;       // K bytes per stage: one 128-byte swizzle row
constexpr int kThreads = 384;  // warpgroup 0 loads, 1 and 2 multiply
constexpr int kLag = 2;        // cp.async steps in flight before a signal
constexpr int kStageA = kBM * kBK;
constexpr int64_t kMaxK = 133142;  // 133,142 * 127^2 < 2^31

template <int BN>
struct Tile {
  static constexpr int kStages = BN == 256 ? 4 : BN == 128 ? 6 : 8;
  static constexpr int kStageB = BN * kBK;
  // Registers a thread after setmaxnreg: 128 loaders and 256 multipliers
  // share the 168 x 384 the launch gives the block. BN = 256 keeps 128
  // accumulators a multiplier.
  static constexpr int kLoadRegs = BN == 256 ? 96 : 120;
  static constexpr int kMathRegs = BN == 256 ? 200 : 192;
  static_assert(128 * kLoadRegs + 256 * kMathRegs <= 168 * 384, "registers");
  // The ring, two barriers a stage, and room to align the ring to 1 KB.
  static constexpr int kSmem =
      kStages * (kStageA + kStageB) + 2 * kStages * 8 + 1024;
};

struct Geometry {
  int64_t D, H, W, C;     // input (B, D, H, W, C)
  int64_t Do, Ho, Wo, F;  // output (B, Do, Ho, Wo, F)
  int64_t M;
  int K, steps, kd, kh, kw, stride, dilation, pd, ph, pw, tiles_n;
  bool vec;       // C % 16 == 0: 16-byte cp.async gathers
  bool gathered;  // else, F <= 64 and K in one ring: int8_conv3d_gathered
  bool pairs;     // F even and the output pair-aligned: paired stores
};

struct Epilogue {
  const float* scale;
  const float* bias;
  const void* residual;  // output-shaped float32 or int8, or null
  void* out;
  int residual_kind;     // 0 none, 1 float32, 2 int8 (dequant by res_scale)
  float res_scale;
  bool relu;
  float out_inv;         // int8 output: the requant's f32(1 / scale)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// K-major operand with 128-byte rows and the 128-byte swizzle: 8-row groups
// 1024 bytes apart (SBO); the leading offset is unused by swizzled K-major
// layouts. The start address may step 32 bytes at a time along the row.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_operand(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}


// d = a * b + (accumulate ? d : 0).
template <int BN>
__device__ __forceinline__ void wgmma(int (&d)[BN / 2], uint64_t a,
                                      uint64_t b, int accumulate) {
  if constexpr (BN == 64)
    wgmma_n64(d, a, b, accumulate);
  else if constexpr (BN == 128)
    wgmma_n128(d, a, b, accumulate);
  else
    wgmma_n256(d, a, b, accumulate);
}

// One tap on: (td, th, tw) in order, tw fastest.
__device__ __forceinline__ void next_tap(const Geometry& g, int& tw, int& th,
                                         int& td) {
  if (++tw == g.kw) {
    tw = 0;
    if (++th == g.kh) {
      th = 0;
      ++td;
    }
  }
}

// ``step`` bytes on along k = ((td, th, tw), c), channel-minor; ``step``
// and C multiples of 16.
__device__ __forceinline__ void advance_by(const Geometry& g, int step, int& c,
                                           int& tw, int& th, int& td) {
  for (c += step; c >= g.C; c -= static_cast<int>(g.C)) next_tap(g, tw, th, td);
}

// Byte gathers (C not a multiple of 16) run in 64- and 128-wide tiles only,
// which keeps them out of the 256-wide instances' registers.
template <int BN>
constexpr bool kGathers = BN != 256;

// Output voxel m's corner (id0, ih0, iw0) in the padded input and its
// sample in x; row_ok false past M.
struct Row {
  const int8_t* xb;
  int id0, ih0, iw0;
  bool ok;
};

__device__ __forceinline__ Row decode_row(const Geometry& g,
                                          const int8_t* x, int64_t m) {
  Row row{x, 0, 0, 0, m < g.M};
  if (row.ok) {
    int64_t r = m;
    const int ow = static_cast<int>(r % g.Wo);
    r /= g.Wo;
    const int oh = static_cast<int>(r % g.Ho);
    r /= g.Ho;
    const int od = static_cast<int>(r % g.Do);
    r /= g.Do;
    row.id0 = od * g.stride - g.pd;
    row.ih0 = oh * g.stride - g.ph;
    row.iw0 = ow * g.stride - g.pw;
    row.xb = x + r * g.D * g.H * g.W * g.C;
  }
  return row;
}

// Bytes k .. k + N - 1 of one A row (any C), into 16-byte chunks j, j + 1,
// ... of its swizzled shared-memory row at ``dst``: N offsets first, then N
// loads with no branch between them (a tap outside the volume or past K
// reads the sample's first byte and drops it), so they are in flight
// together.
template <int N>
__device__ __forceinline__ void gather(const Geometry& g, const Row& row,
                                       int k, uint32_t dst, uint32_t j,
                                       uint32_t swz) {
  const int C = static_cast<int>(g.C), H = static_cast<int>(g.H),
            W = static_cast<int>(g.W);
  int tap = k / C;
  int c = k - tap * C;
  int tw = tap % g.kw;
  tap /= g.kw;
  int th = tap % g.kh, td = tap / g.kh;
  // Per (td, th): where its row of taps starts in the sample and whether it
  // lies inside the volume (and K); per byte only iw is checked.
  int base = 0;
  bool seg = false;
  auto start_row = [&]() {
    const int id = row.id0 + td * g.dilation, ih = row.ih0 + th * g.dilation;
    seg = row.ok && td < g.kd &&
          static_cast<unsigned>(id) < static_cast<unsigned>(g.D) &&
          static_cast<unsigned>(ih) < static_cast<unsigned>(H);
    base = (id * H + ih) * W * C;
  };
  start_row();
  int iw = row.iw0 + tw * g.dilation;
  int off[N];
#pragma unroll
  for (int q = 0; q < N; ++q) {
    off[q] = seg && static_cast<unsigned>(iw) < static_cast<unsigned>(W)
                 ? base + iw * C + c
                 : -1;
    if (++c == C) {
      c = 0;
      iw += g.dilation;
      if (++tw == g.kw) {
        tw = 0;
        iw = row.iw0;
        if (++th == g.kh) {
          th = 0;
          ++td;
        }
        start_row();
      }
    }
  }
  uint32_t word[N / 4];
#pragma unroll
  for (int q = 0; q < N / 4; ++q) word[q] = 0u;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const uint32_t byte =
        static_cast<uint8_t>(__ldg(row.xb + (off[q] < 0 ? 0 : off[q])));
    word[q / 4] |= (off[q] < 0 ? 0u : byte) << (8 * (q % 4));
  }
#pragma unroll
  for (uint32_t h = 0; h < N / 16; ++h)
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     dst + (((j + h) ^ swz) << 4)),
                 "r"(word[4 * h]), "r"(word[4 * h + 1]), "r"(word[4 * h + 2]),
                 "r"(word[4 * h + 3])
                 : "memory");
}

template <int BN>
__device__ __forceinline__ void load_tiles(const CUtensorMap* tmap_w,
                                           const int8_t* __restrict__ x,
                                           const Geometry& g, int64_t m0,
                                           int n0, uint32_t sa, uint32_t sb,
                                           uint32_t full, uint32_t empty) {
  using T = Tile<BN>;
  const int t = threadIdx.x;  // 0..127: this thread's row of the A tile
  const Row own = g.vec || !kGathers<BN> ? Row{} : decode_row(g, x, m0 + t);
  const uint32_t row = static_cast<uint32_t>(t) * kBK;
  const uint32_t swz = static_cast<uint32_t>(t & 7);
  int c = 0, tw = 0, th = 0, td = 0;  // the 16-byte path's k
  // The 16-byte path: thread t copies chunk vj = t % 8 of rows t / 8 + 16 i,
  // so eight neighbouring threads read one row's 128 contiguous bytes where
  // C >= 128 (one tap) and a warp four rows. Its rows' corners, and where
  // in x their samples start (rows past M read nothing).
  const uint32_t vj = static_cast<uint32_t>(t & 7);
  int v_id[8], v_ih[8], v_iw[8];
  int64_t v_base[8];
  if (g.vec) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m_i = static_cast<int>(m0) + (t >> 3) + 16 * i;
      const bool ok = m_i < g.M;
      const int wo = static_cast<int>(g.Wo), ho = static_cast<int>(g.Ho),
                do_ = static_cast<int>(g.Do);
      int r = m_i / wo;
      v_iw[i] = (m_i - r * wo) * g.stride - g.pw;
      int q = r / ho;
      v_ih[i] = (r - q * ho) * g.stride - g.ph;
      r = q / do_;
      v_id[i] = ok ? (q - r * do_) * g.stride - g.pd : -(1 << 29);
      v_base[i] = ok ? r * g.D * g.H * g.W * g.C : 0;
    }
    advance_by(g, 16 * static_cast<int>(vj), c, tw, th, td);
  }
  for (int kt = 0; kt < g.steps; ++kt) {
    const int s = kt % T::kStages;
    mbar_wait(empty + 8 * s, ((kt / T::kStages) & 1) ^ 1);
    if (t == 0) {
      mbar_arrive_expect_tx(full + 8 * s, T::kStageB);
      tma_load_2d(sb + s * T::kStageB, tmap_w, kt * kBK, n0, full + 8 * s);
    }
    const uint32_t dst = sa + s * kStageA + row;
    if (g.vec) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int id = v_id[i] + td * g.dilation,
                  ih = v_ih[i] + th * g.dilation,
                  iw = v_iw[i] + tw * g.dilation;
        const bool ok =
            td < g.kd &&
            static_cast<unsigned>(id) < static_cast<unsigned>(g.D) &&
            static_cast<unsigned>(ih) < static_cast<unsigned>(g.H) &&
            static_cast<unsigned>(iw) < static_cast<unsigned>(g.W);
        const int8_t* src =
            x + v_base[i] +
            (ok ? ((id * static_cast<int>(g.H) + ih) * static_cast<int>(g.W) +
                   iw) * static_cast<int>(g.C) + c
                : 0);
        const uint32_t r = (t >> 3) + 16 * i;
        cp_async_16(sa + s * kStageA + r * kBK + ((vj ^ (r & 7)) << 4), src,
                    ok ? 16u : 0u);
      }
      advance_by(g, kBK, c, tw, th, td);
      cp_async_commit();
      if (kt >= kLag) {
        cp_async_wait<kLag>();
        fence_proxy_async();
        mbar_arrive(full + 8 * ((kt - kLag) % T::kStages));
      }
    } else if constexpr (kGathers<BN>) {
#pragma unroll 1
      for (uint32_t j = 0; j < 8; ++j)
        gather<16>(g, own, kt * kBK + 16 * static_cast<int>(j), dst, j, swz);
      fence_proxy_async();
      mbar_arrive(full + 8 * s);
    }
  }
  if (g.vec) {
    cp_async_wait<0>();
    fence_proxy_async();
    for (int kt = g.steps > kLag ? g.steps - kLag : 0; kt < g.steps; ++kt)
      mbar_arrive(full + 8 * (kt % T::kStages));
  }
}

// The epilogue's steps for one value, in the graph's order.
template <bool kOutI8>
__device__ __forceinline__ void finish(const Epilogue& e, int acc, float s,
                                       float b, int64_t idx, float& v_out,
                                       int& q_out) {
  float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
  if (e.residual_kind == 1)
    v = __fadd_rn(v, static_cast<const float*>(e.residual)[idx]);
  else if (e.residual_kind == 2)
    v = __fadd_rn(v, __fmul_rn(__int2float_rn(static_cast<const int8_t*>(
                                   e.residual)[idx]),
                               e.res_scale));
  if (e.relu) v = fmaxf(v, 0.f);
  v_out = v;
  if constexpr (kOutI8)
    q_out = min(max(__float2int_rn(__fmul_rn(v, e.out_inv)), -127), 127);
}

// Warpgroup ``cw`` multiplies rows 64 cw .. 64 cw + 63 of the tile and
// writes them through the epilogue.
template <int BN, bool kOutI8>
__device__ __forceinline__ void multiply(const Geometry& g, const Epilogue& e,
                                         int64_t m0, int n0, uint32_t sa,
                                         uint32_t sb, uint32_t full,
                                         uint32_t empty, int cw) {
  using T = Tile<BN>;
  const int t = threadIdx.x % 128;
  // No instruction but wgmma defines an accumulator: the first product
  // overwrites them (ptxas serializes the wgmmas otherwise).
  int acc[BN / 2];
  const uint32_t a_rows = sa + cw * 64 * kBK;
  for (int kt = 0; kt < g.steps; ++kt) {
    const int s = kt % T::kStages;
    mbar_wait(full + 8 * s, (kt / T::kStages) & 1);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      wgmma<BN>(acc, smem_desc(a_rows + s * kStageA + 32 * kk),
                smem_desc(sb + s * T::kStageB + 32 * kk), kt > 0 || kk > 0);
    wgmma_commit();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
    wgmma_wait<1>();
    if (kt > 0 && t % 32 == 0)
      mbar_arrive(empty + 8 * ((kt - 1) % T::kStages));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);

  // Accumulator 4 j + 2 h + p: row 16 warp + lane / 4 + 8 h of this
  // warpgroup's 64, column 8 j + 2 (lane % 4) + p of the tile.
  const int lane = t % 32;
  const int64_t row0 = m0 + cw * 64 + (t / 32) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * (lane % 4);
    if (n >= g.F) continue;
    const bool n1 = n + 1 < g.F;
    const float s0 = e.scale[n], b0 = e.bias[n];
    const float s1 = n1 ? e.scale[n + 1] : 0.f, b1 = n1 ? e.bias[n + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t r = row0 + 8 * h;
      if (r >= g.M) continue;
      const int64_t idx = r * g.F + n;
      float v0, v1 = 0.f;
      int q0 = 0, q1 = 0;
      finish<kOutI8>(e, acc[4 * j + 2 * h], s0, b0, idx, v0, q0);
      if (n1)
        finish<kOutI8>(e, acc[4 * j + 2 * h + 1], s1, b1, idx + 1, v1, q1);
      if constexpr (kOutI8) {
        int8_t* o = static_cast<int8_t*>(e.out) + idx;
        if (g.pairs) {
          *reinterpret_cast<uint16_t*>(o) = static_cast<uint16_t>(
              (q0 & 0xFF) | ((q1 & 0xFF) << 8));
        } else {
          o[0] = static_cast<int8_t>(q0);
          if (n1) o[1] = static_cast<int8_t>(q1);
        }
      } else {
        float* o = static_cast<float*>(e.out) + idx;
        if (g.pairs) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (n1) o[1] = v1;
        }
      }
    }
  }
}

template <int BN, bool kOutI8>
__global__ void __launch_bounds__(kThreads, 1)
    int8_conv3d_kernel(const __grid_constant__ CUtensorMap tmap_w,
                       const int8_t* __restrict__ x, const Geometry g,
                       const Epilogue e) {
  using T = Tile<BN>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sa = base;
  const uint32_t sb = sa + T::kStages * kStageA;
  const uint32_t full = sb + T::kStages * T::kStageB;
  const uint32_t empty = full + 8 * T::kStages;
  const int64_t tile = blockIdx.x;
  const int n0 = static_cast<int>(tile % g.tiles_n) * BN;
  const int64_t m0 = tile / g.tiles_n * kBM;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full + 8 * s, 128 + 1);  // 128 rows + the TMA's arrival
      mbar_init(empty + 8 * s, 8);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&tmap_w))
                 : "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(T::kLoadRegs)
                 : "memory");
    load_tiles<BN>(&tmap_w, x, g, m0, n0, sa, sb, full, empty);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::kMathRegs)
                 : "memory");
    multiply<BN, kOutI8>(g, e, m0, n0, sa, sb, full, empty,
                         threadIdx.x / 128 - 1);
  }
}

// Where C is not a multiple of 16, F <= 64 and every K step of the tile
// fits the ring (the C = 1 and C = 2 stems, the PET tower's narrow blocks:
// 1 to 8 steps), the byte gather, not the multiply, is the cost. Two
// warpgroups of a block gather all of the tile's A rows at once (32 bytes
// of row threadIdx % 128 at a time), the weights' TMA copies in flight
// meanwhile, then both multiply, 64 rows each; no ring, no roles. Shared
// memory holds only the tile's steps, so two blocks share an SM and one
// block's gather overlaps the other's products and epilogue.
constexpr int kGatherThreads = 256;

template <int BN, bool kOutI8>
__global__ void __launch_bounds__(kGatherThreads, 2)
    int8_conv3d_gathered(const __grid_constant__ CUtensorMap tmap_w,
                         const int8_t* __restrict__ x, const Geometry g,
                         const Epilogue e) {
  using T = Tile<BN>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sa = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sb = sa + g.steps * kStageA;
  const uint32_t full = sb + g.steps * T::kStageB;
  const uint32_t empty = full + 8 * g.steps;  // arrived on, never awaited
  const int64_t tile = blockIdx.x;
  const int n0 = static_cast<int>(tile % g.tiles_n) * BN;
  const int64_t m0 = tile / g.tiles_n * kBM;
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.steps; ++s) {
      mbar_init(full + 8 * s, 1);  // the TMA's arrival
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int kt = 0; kt < g.steps; ++kt) {
      mbar_arrive_expect_tx(full + 8 * kt, T::kStageB);
      tma_load_2d(sb + kt * T::kStageB, &tmap_w, kt * kBK, n0, full + 8 * kt);
    }
  }
  const uint32_t r = threadIdx.x % 128;
  const Row row = decode_row(g, x, m0 + r);
  for (int q = threadIdx.x / 128; q < 4 * g.steps;
       q += kGatherThreads / 128)
    gather<32>(g, row, 32 * q, sa + (q / 4) * kStageA + r * kBK,
               2 * static_cast<uint32_t>(q % 4), r & 7);
  fence_proxy_async();
  __syncthreads();
  multiply<BN, kOutI8>(g, e, m0, n0, sa, sb, full, empty, threadIdx.x / 128);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static std::atomic<EncodeTiled> fn{nullptr};
  EncodeTiled f = fn.load();
  if (f == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    f = reinterpret_cast<EncodeTiled>(p);
    fn.store(f);
  }
  return f;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int BN, bool kOutI8>
cudaError_t launch(const CUtensorMap& tmap, const int8_t* x,
                   const Geometry& g, const Epilogue& e,
                   cudaStream_t stream) {
  static std::atomic<bool> ready{false};
  auto ring = int8_conv3d_kernel<BN, kOutI8>;
  if (!ready.load()) {
    cudaError_t err = allow_smem(ring, Tile<BN>::kSmem);
    if constexpr (BN == 64)
      if (err == cudaSuccess)
        err = allow_smem(int8_conv3d_gathered<BN, kOutI8>, Tile<BN>::kSmem);
    if (err != cudaSuccess) return err;
    ready.store(true);
  }
  const int64_t tiles = (g.M + kBM - 1) / kBM * g.tiles_n;
  if (tiles > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  const auto grid = static_cast<unsigned>(tiles);
  if constexpr (BN == 64) {
    if (g.gathered) {
      const int smem =
          g.steps * (kStageA + Tile<BN>::kStageB) + 2 * g.steps * 8 + 1024;
      int8_conv3d_gathered<BN, kOutI8>
          <<<grid, kGatherThreads, smem, stream>>>(tmap, x, g, e);
      return cudaGetLastError();
    }
  }
  ring<<<grid, kThreads, Tile<BN>::kSmem, stream>>>(tmap, x, g, e);
  return cudaGetLastError();
}

template <bool kOutI8>
cudaError_t launch_bn(int bn, const CUtensorMap& tmap, const int8_t* x,
                      const Geometry& g, const Epilogue& e,
                      cudaStream_t stream) {
  if (bn == 64) return launch<64, kOutI8>(tmap, x, g, e, stream);
  if (bn == 128) return launch<128, kOutI8>(tmap, x, g, e, stream);
  return launch<256, kOutI8>(tmap, x, g, e, stream);
}

bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

}  // namespace

extern "C" {

int64_t int8_conv3d_max_k() { return kMaxK; }

int int8_conv3d(const int8_t* x, const int8_t* w, const float* scale,
                const float* bias, const void* residual, int64_t residual_kind,
                float residual_scale, int64_t relu, int64_t out_int8,
                float out_inv, void* out, int64_t batch, int64_t d, int64_t h,
                int64_t wd, int64_t c, int64_t f, int64_t kd, int64_t kh,
                int64_t kw, int64_t k_pad, int64_t stride, int64_t dilation,
                int64_t pd_lo, int64_t pd_hi, int64_t ph_lo, int64_t ph_hi,
                int64_t pw_lo, int64_t pw_hi, int64_t device,
                void* stream_handle) {
  Geometry g;
  g.D = d, g.H = h, g.W = wd, g.C = c, g.F = f;
  if (batch < 1 || d < 1 || h < 1 || wd < 1 || c < 1 || f < 1 || kd < 1 ||
      kh < 1 || kw < 1 || stride < 1 || dilation < 1 || pd_lo < 0 ||
      pd_hi < 0 || ph_lo < 0 || ph_hi < 0 || pw_lo < 0 || pw_hi < 0 ||
      residual_kind < 0 || residual_kind > 2 ||
      (residual_kind != 0) != (residual != nullptr))
    return cudaErrorInvalidValue;
  const int64_t k = kd * kh * kw * c;
  if (k > kMaxK || k_pad != (k + 31) / 32 * 32) return cudaErrorInvalidValue;
  if (d + pd_lo + pd_hi < dilation * (kd - 1) + 1 ||
      h + ph_lo + ph_hi < dilation * (kh - 1) + 1 ||
      wd + pw_lo + pw_hi < dilation * (kw - 1) + 1)
    return cudaErrorInvalidValue;
  g.Do = (d + pd_lo + pd_hi - dilation * (kd - 1) - 1) / stride + 1;
  g.Ho = (h + ph_lo + ph_hi - dilation * (kh - 1) - 1) / stride + 1;
  g.Wo = (wd + pw_lo + pw_hi - dilation * (kw - 1) - 1) / stride + 1;
  g.M = batch * g.Do * g.Ho * g.Wo;
  if (g.M > 0x7FFFFFFFLL - kBM) return cudaErrorInvalidValue;
  // Offsets inside one sample and the taps' coordinates fit an int.
  if (d * h * wd * c > 0x7FFFFFFFLL || f > 0x7FFFFFFFLL / 2 ||
      dilation * (kd + kh + kw) + stride * (d + h + wd) > 0x3FFFFFFFLL)
    return cudaErrorInvalidValue;
  g.K = static_cast<int>(k);
  g.steps = static_cast<int>((k_pad + kBK - 1) / kBK);
  g.kd = static_cast<int>(kd), g.kh = static_cast<int>(kh);
  g.kw = static_cast<int>(kw), g.stride = static_cast<int>(stride);
  g.dilation = static_cast<int>(dilation), g.pd = static_cast<int>(pd_lo);
  g.ph = static_cast<int>(ph_lo), g.pw = static_cast<int>(pw_lo);
  const bool vec = c % 16 == 0 && aligned(x, 16);
  const int bn = f <= 64 ? 64 : f <= 128 || !vec ? 128 : 256;
  g.tiles_n = static_cast<int>((f + bn - 1) / bn);
  g.vec = vec;
  g.gathered = !vec && bn == 64 && g.steps <= Tile<64>::kStages;
  g.pairs = f % 2 == 0 && aligned(out, out_int8 ? 2 : 8);
  if (!aligned(w, 16)) return cudaErrorMisalignedAddress;

  Epilogue e;
  e.scale = scale, e.bias = bias, e.residual = residual, e.out = out;
  e.residual_kind = static_cast<int>(residual_kind);
  e.res_scale = residual_scale, e.relu = relu != 0, e.out_inv = out_inv;

  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap tmap;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k_pad),
                              static_cast<cuuint64_t>(f)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k_pad)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK),
                             static_cast<cuuint32_t>(bn)};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&tmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
             const_cast<int8_t*>(w), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  auto stream = static_cast<cudaStream_t>(stream_handle);
  return out_int8 ? launch_bn<true>(bn, tmap, x, g, e, stream)
                  : launch_bn<false>(bn, tmap, x, g, e, stream);
}

}  // extern "C"
