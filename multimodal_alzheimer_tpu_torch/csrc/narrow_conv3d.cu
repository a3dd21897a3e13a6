// Narrow stride-1 "same" 3-D convolutions in bfloat16 for Hopper (sm_90a):
// forward, input gradient and weight gradient.
//
// Entry points behind a plain C interface, loaded with ctypes by
// ops/_native.py and wrapped by ops/narrow_conv.py (an autograd Function):
//
// narrow_conv3d_fprop: y = conv(x, w) + bias, x (B, CIN, D, H, W), w (COUT,
//   CIN, K, K, K), y (B, COUT, D, H, W), all bfloat16 and NCDHW, zero padding
//   K / 2 on every side. The input gradient is the same kernel on dy with
//   the weights flipped and CIN and COUT swapped (a stride-1 "same" conv is
//   its own adjoint in shape): the kernel reads w transposed and flipped
//   while it stages the weights, and adds no bias.
// narrow_conv3d_wgrad: dw = sum over (b, voxel) of dy x shifted x, and
//   db = sum of dy, in two launches: per-block float32 partials, then a
//   merge that adds the blocks' partials in block order.
//
// It replaces no Pallas kernel: the JAX package leaves these convolutions to
// XLA (models/layers.py ConvBlock3D, through flax nn.Conv). It exists for
// the SmallPETCNN towers' first two blocks (1 -> 8 and 8 -> 16 channels,
// 5^3, on the full 91x109x91 grid and its first pool): cuDNN runs them with
// its "indexed" sm80 implicit-GEMM kernels, whose tiles are many times wider
// than N = 8 or 16, plus NCDHW <-> NDHWC transposes, at about 1% of their
// bound; they took over half of a stage-3 train step's device time.
//
// Bounds on one H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the 1 -> 8
// block is bound by bytes (the output is 8 values a voxel: 16 bytes written
// per 2 read), the 8 -> 16 block by operations (2,000 multiply-adds a
// voxel and channel pair of the output, 16 outputs a voxel).
//
// Design: implicit GEMMs on mma.sync (bf16 in, f32 sums), every operand
// from shared memory through ldmatrix or held in registers.
//   * Shared memory holds the input tile as 16-byte cells, one cell = 8
//     bfloat16 of one input voxel. For CIN a multiple of 8 a cell is eight
//     channels (channels-last, transposed from NCDHW while staging). For
//     CIN = 1 a cell is the voxel's run of eight W neighbours x[w - K/2 + j],
//     j < K (zeros for j >= K): the kernel's W taps are folded into the cell,
//     so the layer becomes a K x K x 1 conv over 8 "channels" and no 16-byte
//     row of the GEMM straddles two voxels. Either way every row that
//     ldmatrix reads is one aligned 16-byte cell, at any tap: the tap is a
//     whole number of cells away.
//   * A block of 256 threads (8 warps) owns an output tile of 4 x 8 x 16
//     voxels (D x H x W), 32 rows of 16 W positions. The tile's input cells
//     with their halo ((4 + K - 1) x (8 + K - 1) x (16 + K - 1), or x 16
//     when folded) are staged from NCDHW with consecutive threads on
//     consecutive W, zero outside the volume, in loops of fixed trip count,
//     unrolled so that a thread's loads are in flight together (four
//     8-channel cells at a time, which keeps the 8 -> 16 kernels under 72
//     registers); in-plane offsets are int32.
//   * fprop: M = output voxels (a row of 16 an m16 tile, 4 rows a warp), N =
//     COUT (8 or 16 are legal mma widths), K = taps x input channels. Blocks
//     are persistent over tiles (as many as fit the card), so the weights are
//     read from device memory once a block. A warp's 4 rows share their depth
//     and run along H, so the A fragment of one cell row serves up to K of
//     the warp's (row, kh) products. For CIN a multiple of 8 the weights stay
//     in shared memory as [tap][COUT] cells; a k16 step is a tap pair along
//     W, (kw, kw + 1) at one (g, kd, kh), the last paired with a zero cell;
//     the B fragments of the K pairs of a (g, kd, kw) are loaded into
//     registers, then 8 ldmatrix.x4 of A serve 20 products a n8 tile (taps
//     paired in order took 20 ldmatrix.x4 for them). Folded, the 25 taps' B
//     fragments of m16n8k8 live in registers for the block's life, a cell
//     row's ldmatrix.x2 serves K taps (40 ldmatrix.x2 and 100 mma a warp and
//     tile, where taps paired in order took 52 ldmatrix.x4), and the block
//     loads its next tile's cells into registers (18 a thread) while it
//     computes the current one. The epilogue adds the bias in float32, rounds
//     to bfloat16 once, stages the tile channel-major in the freed cells, and
//     each thread stores its voxels' channels, consecutive threads on
//     consecutive W.
//   * wgrad (CIN a multiple of 8): M = (tap, channel) rows, N = COUT, K =
//     voxels. A is the staged cells read with ldmatrix.trans (rows = voxels,
//     columns = channels, at the tap's offset), B the dy tile staged
//     [COUT][voxel]. One extra "tap" reads a cell of eight 1.0s, so its rows
//     hold sum(dy) per channel: the bias gradient rides in the same products
//     (it fills the otherwise empty half of the last m16 tile of 125 taps).
//     Each warp holds its m16 tiles' sums for the whole run (64 float32 a
//     thread at 8 -> 16).
//   * wgrad folded (CIN = 1): the roles swap, M = the 8 output channels
//     (the m16 fragment's other 8 rows zero), N = a tap's 8 W slots, K = a
//     row's voxels, so one B fragment of a cell row serves K (row, tap)
//     products of a warp that owns all 8 H rows of a depth row: about a
//     third of the shared-memory traffic of one fragment a (row, tap pair).
//     The bias gradient is the same products against a B of 1.0s. Each depth
//     row of a block writes its own partial.
//   * Either wgrad runs a fixed 264 blocks (two an H100 SM, not read from
//     the card), each a fixed contiguous range of tiles, each writing its
//     float32 partials; narrow_conv_merge_kernel then adds the partials of
//     every output value in block order (four interleaved chains, joined in
//     a fixed order). No atomics: the same inputs give the same bits on any
//     card.
// Rounding: every sum is float32 over bfloat16 products (exact in float32);
// y and dx are rounded to bfloat16 once, dw and db once after the merge, as
// cuDNN's bfloat16 convolution rounds its float32 sums.
//
// Each entry point takes device pointers, int64 sizes, the device index and
// a cudaStream_t, allocates nothing, and returns the first CUDA error seen
// (0 on success); a shape with no instance below is refused with
// cudaErrorInvalidValue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTW = 16;  // W positions of a tile row: one m16 run
constexpr int kTH = 8;
constexpr int kTD = 4;
constexpr int kRows = kTD * kTH;              // 32 rows of kTW voxels
constexpr int kRowsPerWarp = kRows / kWarps;  // 4 m16 tiles a warp (fprop)
constexpr int kTileVoxels = kRows * kTW;      // 512
// Channel stride of the [channel][voxel] tiles in shared memory: 8 elements
// past the tile, so the 8 rows of an ldmatrix (one per channel) and the
// epilogue's stores fall in distinct banks.
constexpr int kChannelStride = kTileVoxels + 8;
// Blocks of the weight gradient: two an SM of an H100 (132), fixed and not
// read from the card, so that the partials' order is every card's.
constexpr int kWgradBlocks = 2 * 132;
constexpr int kMaxDevices = 64;

struct Dims {
  int batch, tiles;  // tiles < 2^31
  int d, h, w, plane;  // plane = d * h * w < 2^31
  int tiles_d, tiles_h, tiles_w;
};

template <int CIN, int COUT, int K>
struct Shape {
  static_assert(CIN == 1 || CIN % 8 == 0, "8-channel cells or folded W");
  static_assert(COUT % 8 == 0 && K % 2 == 1, "mma width, odd kernel");
  static constexpr bool kFolded = CIN == 1;
  static constexpr int kGroups = kFolded ? 1 : CIN / 8;
  static constexpr int kPad = K / 2;
  static constexpr int kID = kTD + K - 1;
  static constexpr int kIH = kTH + K - 1;
  static constexpr int kIW = kFolded ? kTW : kTW + K - 1;
  static constexpr int kCells = kGroups * kID * kIH * kIW;
  static constexpr int kTaps = kFolded ? K * K : kGroups * K * K * K;
  static constexpr int kNT = COUT / 8;
  // fprop: the cells (then the output tile), a zero cell and, for 8-channel
  // cells, the weights as [tap][COUT] cells (folded, they live in registers)
  static constexpr int kOutCells = COUT * kChannelStride / 8;
  static constexpr int kRegion = kCells > kOutCells ? kCells : kOutCells;
  static constexpr int kFpropSmem =
      (kRegion + 1 + (kFolded ? 0 : kTaps * COUT)) * 16;
  // wgrad: the taps and the ones tap, two a m16 tile
  static constexpr int kMTiles = (kTaps + 2) / 2;
  static constexpr int kMPerWarp = (kMTiles + kWarps - 1) / kWarps;
  // Partials a block and floats each: folded, one a depth row of the tile,
  // [(tap * 8 + slot) * COUT + n]; else one, [m16 tile * 16 + row][n].
  static constexpr int kWgradParts = kFolded ? kTD : 1;
  static constexpr int kPartial =
      kFolded ? (kTaps + 1) * 8 * COUT : kMTiles * 16 * COUT;
  static constexpr int kWgradSmem =
      (kCells + 1) * 16 + COUT * kChannelStride * 2;
  static constexpr int kWgradFloats = kWgradBlocks * kWgradParts * kPartial;

  // Cells between a tile row's cell at tap 0 and at tap t of 8-channel
  // cells, taps running ((g * K + kd) * K + kh) * K + kw.
  __host__ __device__ static constexpr int tap_cells(int t) {
    return (((t / (K * K * K)) * kID + (t / (K * K)) % K) * kIH +
            (t / K) % K) * kIW + t % K;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1,
                                            uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragments of NT n8 tiles: for each pair of tiles one ldmatrix.x4 whose
// lanes address [half 0 | half 1] x [tile 2p | tile 2p + 1]; a lone tile by
// ldmatrix.x2. `base` is the lane's row of tile 0, `pair_bytes` the bytes
// between the rows of tiles 2p and 2p + 2.
template <int NT>
__device__ __forceinline__ void load_b(uint32_t (&b)[NT][2], uint32_t base,
                                       uint32_t pair_bytes) {
#pragma unroll
  for (int p = 0; p < NT / 2; ++p) {
    uint32_t r[4];
    ldmatrix_x4(r, base + p * pair_bytes);
    b[2 * p][0] = r[0];
    b[2 * p][1] = r[1];
    b[2 * p + 1][0] = r[2];
    b[2 * p + 1][1] = r[3];
  }
  if (NT % 2)
    ldmatrix_x2(b[NT - 1][0], b[NT - 1][1], base + (NT / 2) * pair_bytes);
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf16_value(uint16_t bits) {
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

__device__ __forceinline__ uint4 pack8(const uint16_t (&v)[8]) {
  return make_uint4(v[0] | (uint32_t(v[1]) << 16), v[2] | (uint32_t(v[3]) << 16),
                    v[4] | (uint32_t(v[5]) << 16), v[6] | (uint32_t(v[7]) << 16));
}

struct Origin {
  int64_t b;
  int d0, h0, w0;
};

__device__ __forceinline__ Origin origin_of(int tile, const Dims& s) {
  Origin o;
  o.w0 = tile % s.tiles_w * kTW;
  tile /= s.tiles_w;
  o.h0 = tile % s.tiles_h * kTH;
  tile /= s.tiles_h;
  o.d0 = tile % s.tiles_d * kTD;
  o.b = tile / s.tiles_d;
  return o;
}

// Voxel v of a tile (row v / kTW, W position v % kTW): its offset in a
// channel's plane, or -1 outside the volume.
__device__ __forceinline__ int voxel_offset(int v, const Origin& o,
                                            const Dims& s) {
  const int r = v / kTW;
  const int d = o.d0 + r / kTH, h = o.h0 + r % kTH, w = o.w0 + v % kTW;
  return d < s.d && h < s.h && w < s.w ? (d * s.h + h) * s.w + w : -1;
}

// A thread's share of a folded (CIN = 1) tile's input cells: one W position
// of the cells in rows (dd, hh) 16 apart, each the run of K neighbours along
// W (zero outside the volume), loaded into registers by load() and written
// to shared memory by store(), so a tile's loads can be in flight while the
// block computes the one before.
template <class S>
struct FoldedCells {
  static constexpr int kRowsIn = S::kID * S::kIH, kStep = kThreads / kTW;
  static constexpr int kLoads = (kRowsIn + kStep - 1) / kStep;
  uint32_t v[kLoads][4];

  __device__ __forceinline__ void load(const uint16_t* __restrict__ x,
                                       const Origin& o, const Dims& s) {
    const uint16_t* xb = x + o.b * static_cast<int64_t>(s.plane);
    const int w = o.w0 - S::kPad + threadIdx.x % kTW;
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int row = threadIdx.x / kTW + kStep * q;
      const int d = o.d0 - S::kPad + row / S::kIH;
      const int h = o.h0 - S::kPad + row % S::kIH;
      const bool dh = row < kRowsIn && d >= 0 && d < s.d && h >= 0 && h < s.h;
      const uint16_t* at = xb + (d * s.h + h) * s.w + w;
      uint16_t e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = j < 2 * S::kPad + 1 && dh && w + j >= 0 && w + j < s.w
                   ? __ldg(at + j)
                   : uint16_t(0);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[q][j] = e[2 * j] | (uint32_t(e[2 * j + 1]) << 16);
    }
  }

  __device__ __forceinline__ void store(uint4* cells) const {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int row = threadIdx.x / kTW + kStep * q;
      if (row < kRowsIn)
        cells[row * kTW + threadIdx.x % kTW] =
            make_uint4(v[q][0], v[q][1], v[q][2], v[q][3]);
    }
  }
};

// The tile's input cells with their halo, zero outside the volume. The
// loops have trip counts known at compile time and are unrolled, so a
// thread's loads are in flight together (four cells' at a time where a
// cell takes eight).
template <class S, int CIN>
__device__ __forceinline__ void stage_cells(uint4* cells,
                                            const uint16_t* __restrict__ x,
                                            const Origin& o, const Dims& s) {
  if constexpr (S::kFolded) {
    FoldedCells<S> f;
    f.load(x, o, s);
    f.store(cells);
  } else {  // 8 loads a cell: four cells' loads in flight at a time
    const uint16_t* xb = x + o.b * CIN * static_cast<int64_t>(s.plane);
#pragma unroll 4
    for (int q = 0; q < (S::kCells + kThreads - 1) / kThreads; ++q) {
      const int i = threadIdx.x + kThreads * q;
      if (i >= S::kCells) break;
      const int ww = i % S::kIW;
      const int hh = (i / S::kIW) % S::kIH;
      const int dd = (i / (S::kIW * S::kIH)) % S::kID;
      const int g = i / (S::kIW * S::kIH * S::kID);
      const int d = o.d0 - S::kPad + dd, h = o.h0 - S::kPad + hh,
                w = o.w0 - S::kPad + ww;
      const bool in = d >= 0 && d < s.d && h >= 0 && h < s.h && w >= 0 &&
                      w < s.w;
      const uint16_t* at =
          xb + 8 * g * static_cast<int64_t>(s.plane) + (d * s.h + h) * s.w + w;
      uint16_t v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        v[c] = in ? __ldg(at + c * static_cast<int64_t>(s.plane))
                  : uint16_t(0);
      cells[i] = pack8(v);
    }
  }
}

// y tile = conv(x, w) + bias over output tiles [blockIdx.x, tiles) in
// steps of gridDim.x. w is (COUT, CIN, K, K, K), or with `flipped` the
// weights of the adjoint conv: (CIN, COUT, K, K, K) read transposed and
// flipped, for the input gradient (no instance takes it folded: a CIN = 1
// layer has no input-gradient kernel).
template <int CIN, int COUT, int K>
__global__ void __launch_bounds__(kThreads)
    narrow_conv_fprop_kernel(const uint16_t* __restrict__ x,
                             const uint16_t* __restrict__ wt,
                             const uint16_t* __restrict__ bias,
                             uint16_t* __restrict__ y, Dims s,
                             bool flipped) {
  using S = Shape<CIN, COUT, K>;
  extern __shared__ __align__(16) uint4 smem[];
  uint4* cells = smem;  // the input cells, then the output tile
  uint4* zero = smem + S::kRegion;
  uint4* wts = zero + 1;  // [tap][COUT] cells of 8 input channels
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // Folded W (CIN = 1, no input gradient): each (kd, kh) tap's weights over
  // the cell's 8 W neighbours are one m16n8k8 B fragment, k = lane % 4 * 2
  // (+ 1), n = lane / 4, held in registers for the block's life.
  uint32_t b_k8[S::kFolded ? K * K : 1][S::kNT];
  if constexpr (S::kFolded) {
    const int j = 2 * (lane % 4);
#pragma unroll
    for (int t = 0; t < K * K; ++t)
#pragma unroll
      for (int nt = 0; nt < S::kNT; ++nt) {
        const uint16_t* w = wt + ((nt * 8 + lane / 4) * K * K + t) * K;
        b_k8[t][nt] = (j < K ? w[j] : 0u) |
                      (uint32_t(j + 1 < K ? w[j + 1] : 0u) << 16);
      }
  } else {
    for (int i = threadIdx.x; i < S::kTaps * COUT; i += kThreads) {
      const int n = i % COUT, t = i / COUT;
      uint16_t v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int g = t / (K * K * K), kd = (t / (K * K)) % K,
                  kh = (t / K) % K, kw = t % K, ci = 8 * g + c;
        v[c] = flipped ? wt[(((ci * COUT + n) * K + K - 1 - kd) * K + K - 1 -
                            kh) * K + K - 1 - kw]
                       : wt[(((n * CIN + ci) * K + kd) * K + kh) * K + kw];
      }
      wts[i] = pack8(v);
    }
    if (threadIdx.x == 0) *zero = make_uint4(0u, 0u, 0u, 0u);
  }

  const uint32_t cells_u = smem_u32(cells), zero_u = smem_u32(zero),
                 wts_u = smem_u32(wts);
  // A: lanes 0-15 the first tap of the pair, rows m = lane % 8 (+ 8)
  const int a_m = lane % 8 + 8 * ((lane / 8) % 2), a_hi = lane / 16;
  // B: lanes 0-7 the first tap's cells of n-tile 2p, 8-15 the second's,
  // 16-31 the same of n-tile 2p + 1
  const int b_hi = (lane / 8) % 2, b_row = ((lane / 16) * 8 + lane % 8) * 16;
  uint16_t* out = reinterpret_cast<uint16_t*>(cells);

  // Folded, the next tile's cells are loaded into registers while the
  // block computes this one (the 8-channel cells would take 30 registers
  // more, the folded wgrad's prefetch its second block an SM).
  FoldedCells<S> next;
  if constexpr (S::kFolded)
    if (blockIdx.x < s.tiles) next.load(x, origin_of(blockIdx.x, s), s);
  for (int tile = blockIdx.x; tile < s.tiles; tile += gridDim.x) {
    const Origin o = origin_of(tile, s);
    __syncthreads();  // the last tile's stores have read the output tile
    if constexpr (S::kFolded) {
      next.store(cells);
      if (tile + gridDim.x < s.tiles)
        next.load(x, origin_of(tile + gridDim.x, s), s);
    } else {
      stage_cells<S, CIN>(cells, x, o, s);
    }
    __syncthreads();

    float acc[kRowsPerWarp][S::kNT][4];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int j = 0; j < S::kNT; ++j)
        acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
    if constexpr (S::kFolded) {
      // The warp's 4 rows share their depth and run along H, so the cell
      // row hb + sr at depth dd0 + kd serves row i at tap (kd, sr - i): one
      // m16 x k8 A fragment for up to K products.
      const int r0 = warp * kRowsPerWarp;
      const uint32_t a_lane =
          cells_u + ((r0 / kTH) * S::kIH + r0 % kTH) * S::kIW * 16 +
          (lane % 16) * 16;
#pragma unroll
      for (int kd = 0; kd < K; ++kd)
#pragma unroll
        for (int sr = 0; sr < kRowsPerWarp + K - 1; ++sr) {
          uint32_t a0, a1;
          ldmatrix_x2(a0, a1, a_lane + (kd * S::kIH + sr) * S::kIW * 16);
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) {
            if (sr - i < 0 || sr - i >= K) continue;
#pragma unroll
            for (int j = 0; j < S::kNT; ++j)
              mma_bf16_k8(acc[i][j], a0, a1, b_k8[kd * K + sr - i][j]);
          }
        }
    }
    if constexpr (!S::kFolded) {
      // Taps paired along W, (kw, kw + 1) at one (g, kd, kh), the last
      // with the zero cell. The warp's 4 rows share their depth and run
      // along H, so the A fragment of cell row hb + sr serves row i at kh =
      // sr - i; the K tap pairs' B fragments of a (g, kd, kw) are loaded
      // once into registers.
      static_assert(S::kNT <= 2, "one ldmatrix a B fragment");
      const int r0 = warp * kRowsPerWarp;
      const uint32_t a_lane =
          cells_u + (((r0 / kTH) * S::kIH + r0 % kTH) * S::kIW + a_m) * 16;
#pragma unroll
      for (int g = 0; g < S::kGroups; ++g)
#pragma unroll
        for (int kd = 0; kd < K; ++kd)
#pragma unroll
          for (int kw = 0; kw < K; kw += 2) {
            const bool pad = kw + 1 >= K;
            uint32_t b[K][S::kNT][2];
#pragma unroll
            for (int kh = 0; kh < K; ++kh) {
              const int t = ((g * K + kd) * K + kh) * K + kw + b_hi;
              load_b<S::kNT>(b[kh], b_hi && pad ? zero_u
                                                : wts_u + t * COUT * 16 + b_row,
                             16 * 16);
            }
#pragma unroll
            for (int sr = 0; sr < kRowsPerWarp + K - 1; ++sr) {
              const int cell =
                  ((g * S::kID + kd) * S::kIH + sr) * S::kIW + kw + a_hi;
              uint32_t a[4];
              ldmatrix_x4(a, a_hi && pad ? zero_u : a_lane + cell * 16);
#pragma unroll
              for (int i = 0; i < kRowsPerWarp; ++i) {
                if (sr - i < 0 || sr - i >= K) continue;
#pragma unroll
                for (int j = 0; j < S::kNT; ++j)
                  mma_bf16(acc[i][j], a, b[sr - i][j][0], b[sr - i][j][1]);
              }
            }
          }
    }
    __syncthreads();  // every warp is done with the cells

    // accumulator (row g | g + 8, columns 2 (lane % 4) + {0, 1}) -> the
    // output tile [n][row][w]
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i, m = lane / 4;
#pragma unroll
      for (int j = 0; j < S::kNT; ++j) {
        const int n = j * 8 + 2 * (lane % 4);
        const float b0 = bias ? bf16_value(bias[n]) : 0.f;
        const float b1 = bias ? bf16_value(bias[n + 1]) : 0.f;
        uint16_t* p = out + n * kChannelStride + r * kTW + m;
        p[0] = bf16_bits(__fadd_rn(acc[i][j][0], b0));
        p[kChannelStride] = bf16_bits(__fadd_rn(acc[i][j][1], b1));
        p[8] = bf16_bits(__fadd_rn(acc[i][j][2], b0));
        p[kChannelStride + 8] = bf16_bits(__fadd_rn(acc[i][j][3], b1));
      }
    }
    __syncthreads();
    uint16_t* yb = y + o.b * COUT * static_cast<int64_t>(s.plane);
#pragma unroll
    for (int q = 0; q < kTileVoxels / kThreads; ++q) {
      const int v = threadIdx.x + kThreads * q;
      const int at = voxel_offset(v, o, s);
      if (at < 0) continue;
#pragma unroll
      for (int n = 0; n < COUT; ++n)
        yb[n * static_cast<int64_t>(s.plane) + at] =
            out[n * kChannelStride + v];
    }
  }
}

// One tile of the weight gradient's operands: the input cells and the dy
// tile [n][voxel], zero outside the volume.
template <class S, int CIN, int COUT>
__device__ __forceinline__ void stage_wgrad_tile(
    uint4* cells, uint16_t* dys, const uint16_t* __restrict__ x,
    const uint16_t* __restrict__ dy, const Origin& o, const Dims& s) {
  stage_cells<S, CIN>(cells, x, o, s);
  const uint16_t* dyb = dy + o.b * COUT * static_cast<int64_t>(s.plane);
#pragma unroll
  for (int q = 0; q < kTileVoxels / kThreads; ++q) {
    const int v = threadIdx.x + kThreads * q;
    const int at = voxel_offset(v, o, s);
#pragma unroll
    for (int n = 0; n < COUT; ++n)
      dys[n * kChannelStride + v] =
          at >= 0 ? __ldg(dyb + n * static_cast<int64_t>(s.plane) + at)
                  : uint16_t(0);
  }
}

// Partial sums of dw (and of dy per channel, in the ones tap's rows) over a
// contiguous range of tiles, into partials[blockIdx.x]: kPartial floats,
// [m16 tile * 16 + row][n], row = (tap % 2) * 8 + channel.
template <int CIN, int COUT, int K>
__global__ void __launch_bounds__(kThreads)
    narrow_conv_wgrad_kernel(const uint16_t* __restrict__ x,
                             const uint16_t* __restrict__ dy,
                             float* __restrict__ partials, Dims s) {
  using S = Shape<CIN, COUT, K>;
  static_assert(!S::kFolded, "CIN = 1: narrow_conv_wgrad_folded_kernel");
  extern __shared__ __align__(16) uint4 smem[];
  uint4* cells = smem;
  uint4* ones = smem + S::kCells;  // eight bfloat16 1.0 (0x3F80)
  uint16_t* dys = reinterpret_cast<uint16_t*>(ones + 1);  // [n][voxel]
  if (threadIdx.x == 0)
    *ones = make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // A (transposed): lane -> the tap of its m16 tile's pair and the voxel
  const int a_tap = (lane / 8) % 2, a_v = lane % 8 + 8 * (lane / 16);
  uint32_t a_base[S::kMPerWarp], a_mask[S::kMPerWarp];
#pragma unroll
  for (int i = 0; i < S::kMPerWarp; ++i) {
    const int t = 2 * (warp + kWarps * i) + a_tap;
    const bool tap = t < S::kTaps;  // else the ones tap, or past it
    a_base[i] = tap ? smem_u32(cells) + (S::tap_cells(t) + a_v) * 16
                    : smem_u32(ones);
    a_mask[i] = tap ? ~0u : 0u;
  }
  // B: lanes 0-7 voxels 0-7 of channels 8 (2p) + lane % 8, 8-15 voxels
  // 8-15, 16-31 the same of the next n8 tile
  const uint32_t b_base =
      smem_u32(dys) + (((lane / 16) * 8 + lane % 8) * kChannelStride +
                       ((lane / 8) % 2) * 8) * 2;

  float acc[S::kMPerWarp][S::kNT][4];
#pragma unroll
  for (int i = 0; i < S::kMPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < S::kNT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int first = static_cast<int64_t>(s.tiles) * blockIdx.x / gridDim.x;
  const int last = static_cast<int64_t>(s.tiles) * (blockIdx.x + 1) / gridDim.x;
  for (int tile = first; tile < last; ++tile) {
    const Origin o = origin_of(tile, s);
    __syncthreads();  // every warp is done with the last tile
    stage_wgrad_tile<S, CIN, COUT>(cells, dys, x, dy, o, s);
    __syncthreads();
    for (int r = 0; r < kRows; ++r) {
      const uint32_t row = ((r / kTH) * S::kIH + r % kTH) * S::kIW * 16;
      uint32_t b[S::kNT][2];
      load_b<S::kNT>(b, b_base + r * kTW * 2, 16 * kChannelStride * 2);
#pragma unroll
      for (int i = 0; i < S::kMPerWarp; ++i) {
        if (warp + kWarps * i >= S::kMTiles) continue;
        uint32_t a[4];
        ldmatrix_x4_trans(a, a_base[i] + (row & a_mask[i]));
#pragma unroll
        for (int j = 0; j < S::kNT; ++j) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
      }
    }
  }

  float* p = partials + static_cast<int64_t>(blockIdx.x) * S::kPartial;
#pragma unroll
  for (int i = 0; i < S::kMPerWarp; ++i) {
    const int mt = warp + kWarps * i;
    if (mt >= S::kMTiles) continue;
    const int m = mt * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < S::kNT; ++j) {
      const int n = j * 8 + 2 * (lane % 4);
      *reinterpret_cast<float2*>(p + m * COUT + n) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(p + (m + 8) * COUT + n) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
}

// The folded (CIN = 1) weight gradient with the roles of the products
// swapped: M = COUT = 8 output channels (rows 8-15 of the m16 fragment
// zero), N = a tap's 8 W slots, K = a tile row's 16 voxels. Warp w owns the
// tile's depth row w / 2 and half of the kd taps (w % 2 == 0: kd < (K + 1)
// / 2; else the rest and the ones tap) over all 8 H rows: the 8 rows' dy
// fragments stay in registers, and the B fragment of each cell row
// (ldmatrix.x2.trans, rows = voxels) serves every (row, kh) pair that reads
// it, K of them, where one A fragment per (row, tap pair) served one.
// Each depth row writes its own partial, partials[blockIdx.x * kTD + w / 2],
// [(tap * 8 + slot) * COUT + n].
template <int CIN, int COUT, int K>
__global__ void __launch_bounds__(kThreads, 2)  // two blocks an SM
    narrow_conv_wgrad_folded_kernel(const uint16_t* __restrict__ x,
                                    const uint16_t* __restrict__ dy,
                                    float* __restrict__ partials, Dims s) {
  using S = Shape<CIN, COUT, K>;
  static_assert(S::kFolded && COUT == 8 && kWarps == 2 * kTD,
                "a warp pair a depth row, eight output channels");
  constexpr int kHalf = (K + 1) / 2;  // kd of the first half of the warps
  constexpr uint32_t kOnes = 0x3F803F80u;  // two bfloat16 1.0
  extern __shared__ __align__(16) uint4 smem[];
  uint4* cells = smem;
  uint16_t* dys = reinterpret_cast<uint16_t*>(smem + S::kCells + 1);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int dq = warp / 2, second = warp % 2;
  const int kd0 = second ? kHalf : 0, kds = second ? K - kHalf : kHalf;
  // A: lanes 0-7 channels 0-7 of voxels 0-7, lanes 8-15 of voxels 8-15
  const uint32_t a_lane = smem_u32(dys) + ((lane % 8) * kChannelStride +
                                           ((lane / 8) % 2) * 8) * 2 +
                          dq * kTH * kTW * 2;
  // B: lanes 0-7 the cells of voxels 0-7 of a cell row, 8-15 of 8-15
  const uint32_t b_lane = smem_u32(cells) + (lane % 16) * 16;

  float acc[kHalf][K][4], ones[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kHalf; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int first = static_cast<int64_t>(s.tiles) * blockIdx.x / gridDim.x;
  const int last = static_cast<int64_t>(s.tiles) * (blockIdx.x + 1) / gridDim.x;
  for (int tile = first; tile < last; ++tile) {
    const Origin o = origin_of(tile, s);
    __syncthreads();  // every warp is done with the last tile
    stage_wgrad_tile<S, CIN, COUT>(cells, dys, x, dy, o, s);
    __syncthreads();
    uint32_t a[kTH][4];
#pragma unroll
    for (int hh = 0; hh < kTH; ++hh) {
      ldmatrix_x2(a[hh][0], a[hh][2], a_lane + hh * kTW * 2);
      a[hh][1] = a[hh][3] = 0u;
    }
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      if (i >= kds) break;
      const uint32_t row0 = b_lane + (dq + kd0 + i) * S::kIH * S::kIW * 16;
#pragma unroll
      for (int c = 0; c < kTH + K - 1; ++c) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, row0 + c * S::kIW * 16);
#pragma unroll
        for (int hh = 0; hh < kTH; ++hh)
          if (c - hh >= 0 && c - hh < K) mma_bf16(acc[i][c - hh], a[hh], b0, b1);
      }
    }
    if (second) {
#pragma unroll
      for (int hh = 0; hh < kTH; ++hh) mma_bf16(ones, a[hh], kOnes, kOnes);
    }
  }

  // accumulator (row g = n, columns 2 (lane % 4) + {0, 1} = slots); rows
  // g + 8 are zero
  float* p = partials + (static_cast<int64_t>(blockIdx.x) * kTD + dq) *
                            S::kPartial;
  const int n = lane / 4, slot = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    if (i >= kds) break;
#pragma unroll
    for (int kh = 0; kh < K; ++kh) {
      const int tap = (kd0 + i) * K + kh;
      p[(tap * 8 + slot) * COUT + n] = acc[i][kh][0];
      p[(tap * 8 + slot + 1) * COUT + n] = acc[i][kh][1];
    }
  }
  if (second) {
    p[(S::kTaps * 8 + slot) * COUT + n] = ones[0];
    p[(S::kTaps * 8 + slot + 1) * COUT + n] = ones[1];
  }
}

// dw (COUT, CIN, K, K, K) and db (COUT) bfloat16 from the blocks' partials,
// each value's partials added in block order.
template <int CIN, int COUT, int K>
__global__ void __launch_bounds__(kThreads)
    narrow_conv_merge_kernel(const float* __restrict__ partials, int blocks,
                             uint16_t* __restrict__ dw,
                             uint16_t* __restrict__ db) {
  using S = Shape<CIN, COUT, K>;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= (S::kTaps + 1) * 8 * COUT) return;
  float sum[4] = {0.f, 0.f, 0.f, 0.f};
  int b = 0;
  for (; b + 4 <= blocks; b += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      sum[u] += partials[static_cast<int64_t>(b + u) * S::kPartial + i];
  }
  for (; b < blocks; ++b)
    sum[0] += partials[static_cast<int64_t>(b) * S::kPartial + i];
  const float total = (sum[0] + sum[1]) + (sum[2] + sum[3]);
  const int n = i % COUT, row = i / COUT, t = row / 8, c = row % 8;
  if (t == S::kTaps) {
    if (c == 0 && db != nullptr) db[n] = bf16_bits(total);
    return;
  }
  if (S::kFolded) {
    if (c < K) dw[((n * K + t / K) * K + t % K) * K + c] = bf16_bits(total);
  } else {
    const int g = t / (K * K * K), kd = (t / (K * K)) % K, kh = (t / K) % K,
              kw = t % K;
    dw[(((n * CIN + 8 * g + c) * K + kd) * K + kh) * K + kw] =
        bf16_bits(total);
  }
}

// The SM count of each device, read once (0: not read yet).
int sm_count(int device) {
  static int counts[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return 0;
  if (counts[device] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess)
      return 0;
    counts[device] = sms;
  }
  return counts[device];
}

// A plane (with the halo's reach past it) and the tile count fit int32.
bool dims_of(int64_t batch, int64_t d, int64_t h, int64_t w, Dims* s) {
  if (batch < 1 || d < 1 || h < 1 || w < 1 ||
      (d + kTD) * (h + kTH) * (w + kTW) > 0x7FFFFFFF ||
      batch * ((d + kTD - 1) / kTD) * ((h + kTH - 1) / kTH) *
              ((w + kTW - 1) / kTW) > 0x7FFFFFFF)
    return false;
  s->batch = static_cast<int>(batch);
  s->d = static_cast<int>(d);
  s->h = static_cast<int>(h);
  s->w = static_cast<int>(w);
  s->plane = static_cast<int>(d * h * w);
  s->tiles_d = static_cast<int>((d + kTD - 1) / kTD);
  s->tiles_h = static_cast<int>((h + kTH - 1) / kTH);
  s->tiles_w = static_cast<int>((w + kTW - 1) / kTW);
  s->tiles = s->batch * s->tiles_d * s->tiles_h * s->tiles_w;
  return true;
}

#define RETURN_IF_ERROR(expr)             \
  do {                                    \
    const cudaError_t err_ = (expr);      \
    if (err_ != cudaSuccess) return err_; \
  } while (0)

template <int CIN, int COUT, int K>
int launch_fprop(const void* x, const void* w, const void* bias, void* y,
                 const Dims& s, bool flipped, int device,
                 cudaStream_t stream) {
  using S = Shape<CIN, COUT, K>;
  auto fn = narrow_conv_fprop_kernel<CIN, COUT, K>;
  static int resident = 0;  // blocks an SM holds, read once
  if (resident == 0) {
    RETURN_IF_ERROR(cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kFpropSmem));
    RETURN_IF_ERROR(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, fn, kThreads, S::kFpropSmem));
    if (resident == 0) return cudaErrorInvalidConfiguration;
  }
  const int64_t fill = static_cast<int64_t>(resident) * sm_count(device);
  if (fill == 0) return cudaErrorInvalidDevice;
  const int64_t grid = s.tiles < fill ? s.tiles : fill;
  fn<<<static_cast<unsigned>(grid), kThreads, S::kFpropSmem, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w),
      static_cast<const uint16_t*>(bias), static_cast<uint16_t*>(y), s,
      flipped);
  return cudaGetLastError();
}

template <int CIN, int COUT, int K>
constexpr auto wgrad_kernel() {
  if constexpr (Shape<CIN, COUT, K>::kFolded)
    return narrow_conv_wgrad_folded_kernel<CIN, COUT, K>;
  else
    return narrow_conv_wgrad_kernel<CIN, COUT, K>;
}

template <int CIN, int COUT, int K>
int launch_wgrad(const void* x, const void* dy, float* partials, void* dw,
                 void* db, const Dims& s, cudaStream_t stream) {
  using S = Shape<CIN, COUT, K>;
  auto fn = wgrad_kernel<CIN, COUT, K>();
  static bool ready = false;
  if (!ready) {
    RETURN_IF_ERROR(cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kWgradSmem));
    ready = true;
  }
  fn<<<kWgradBlocks, kThreads, S::kWgradSmem, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(dy),
      partials, s);
  RETURN_IF_ERROR(cudaGetLastError());
  const int values = (S::kTaps + 1) * 8 * COUT;
  narrow_conv_merge_kernel<CIN, COUT, K>
      <<<(values + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          partials, kWgradBlocks * S::kWgradParts, static_cast<uint16_t*>(dw),
          static_cast<uint16_t*>(db));
  return cudaGetLastError();
}

// (CIN, COUT, K) of the instances: the PET blocks 1 -> 8 and 8 -> 16 at 5^3,
// and 16 -> 8 for the second's input gradient. ops/narrow_conv.py's SHAPES
// names the same.
#define NARROW_FPROP(X) X(1, 8, 5) X(8, 16, 5) X(16, 8, 5)
#define NARROW_WGRAD(X) X(1, 8, 5) X(8, 16, 5)

}  // namespace

extern "C" {

// y (batch, cout, d, h, w) = conv(x, w) + bias (bias may be null), all
// bfloat16, stride 1, zero padding k / 2. w is (cout, cin, k, k, k); with
// `flipped` it is (cin, cout, k, k, k) and the conv is its adjoint (the
// input gradient of a cout -> cin conv at dy = x).
int narrow_conv3d_fprop(const void* x, const void* w, const void* bias,
                        void* y, int64_t batch, int64_t d, int64_t h,
                        int64_t width, int64_t cin, int64_t cout, int64_t k,
                        int64_t flipped, int64_t device,
                        void* stream_handle) {
  Dims s;
  if (!dims_of(batch, d, h, width, &s)) return cudaErrorInvalidValue;
  RETURN_IF_ERROR(cudaSetDevice(static_cast<int>(device)));
  const auto stream = static_cast<cudaStream_t>(stream_handle);
#define CASE(CI, CO, KK)                                                 \
  if (cin == CI && cout == CO && k == KK)                                \
    return launch_fprop<CI, CO, KK>(x, w, bias, y, s, flipped != 0,     \
                                    static_cast<int>(device), stream);
  NARROW_FPROP(CASE)
#undef CASE
  return cudaErrorInvalidValue;
}

// float32 values of the weight gradient's partials for (cin, cout, k): its
// blocks times each block's (0: no instance). The caller's scratch holds
// them.
int64_t narrow_conv3d_partial_floats(int64_t cin, int64_t cout, int64_t k) {
#define CASE(CI, CO, KK)                          \
  if (cin == CI && cout == CO && k == KK)         \
    return Shape<CI, CO, KK>::kWgradFloats;
  NARROW_WGRAD(CASE)
#undef CASE
  return 0;
}

// dw (cout, cin, k, k, k) and db (cout; may be null) bfloat16 of
// y = conv(x, w) + b, from x and dy (batch, cout, d, h, w) bfloat16;
// partials: the scratch of narrow_conv3d_partial_floats(...) float32.
int narrow_conv3d_wgrad(const void* x, const void* dy, float* partials,
                        void* dw, void* db, int64_t batch, int64_t d,
                        int64_t h, int64_t width, int64_t cin, int64_t cout,
                        int64_t k, int64_t device, void* stream_handle) {
  Dims s;
  if (!dims_of(batch, d, h, width, &s)) return cudaErrorInvalidValue;
  RETURN_IF_ERROR(cudaSetDevice(static_cast<int>(device)));
  const auto stream = static_cast<cudaStream_t>(stream_handle);
#define CASE(CI, CO, KK)                                                  \
  if (cin == CI && cout == CO && k == KK)                                 \
    return launch_wgrad<CI, CO, KK>(x, dy, partials, dw, db, s, stream);
  NARROW_WGRAD(CASE)
#undef CASE
  return cudaErrorInvalidValue;
}

}  // extern "C"
