// Kernels A and B where every input row takes 16-byte copies (each input's
// C % 8 == 0), the weights are streamed and the ring body (conv3d_same.cu)
// does not take the call: the stride-1 SAME 3x3x3 convolution, channels-last
// bf16, fp32 accumulation, on Hopper's wgmma fed by TMA.
//
// Replaces, with conv3d_same.cu, the Pallas TPU kernels of multitalent_tpu
//   - ops/pallas_conv.py:36 _conv_kernel (the dense conv, and through the
//     flipped, transposed weight every dx of kernel A),
//   - ops/pallas_merged_conv.py:103 _merged_kernel (the same conv on a
//     space-to-depth packed tensor; the port runs it unpacked),
//   - ops/pallas_merged_conv.py:251 _merged2_kernel (the conv over
//     concat(a, b), the concat never built: NIN == 2),
// at the flagship's 120-320-channel stages, its dual convs' dx (up to 640
// output channels), the Liver net's 64-320 and SwinUNETR's 48-768.
//
// What bounds it on an H100: these convs carry ~27 * C FLOPs per input byte,
// far above the card's ~295 FLOP/byte ridge, so the tensor cores should set
// the pace, and only wgmma reaches their full rate. The older body of these
// calls (conv3d_same_kernel: mma.sync fed by ldmatrix, one box staged, then
// computed, chunk by chunk) ran them at 45-280 TFLOP/s. What this body does:
//   - the halo through TMA: a tiled 5-D tensor map over (C, X, Y, Z, N)
//     with a box of (8 channels, 10, 10, 6, 1) loads a 4x8x8 output tile's
//     haloed input one 8-channel unit at a time, from (c0, x0-1, y0-1, z0-1,
//     n). Elements outside the tensor come back 0: the SAME padding, the far
//     edges and channels at or past C (the odd half chunk at 120 and 240
//     channels) cost no mask and no zeroing. B's second input has a map of
//     its own; a chunk takes a's map or b's in [a | b] order;
//   - one staged box serves all 27 taps: the two units of a 16-channel chunk
//     land as [unit][z][y][x][8 ch], which is wgmma's no-swizzle K-major
//     layout for the A operand. A core matrix is 8 consecutive x of one
//     (z, y) line (128 contiguous bytes); the stride between core matrices
//     along M is one halo line (SBO, 160 B), along K one unit's box (LBO,
//     9600 B). An m64 tile is one z plane (8 y lines x 8 x), so tap (dz, dy,
//     dx) is the same descriptor with its start moved by ((dz * 10 + dy) *
//     10 + dx) * 16 bytes: nothing is restaged a tap;
//   - the weights stream through a ring of their own, 9 taps (one dz) a
//     stage, in the layout prepare_conv3d_weight has always written, (kchunks,
//     27, 16, CoutP): a 2-D tensor map over (CoutP, rows) with a box of (64
//     columns, 144 rows) and the 128-byte swizzle delivers wgmma's MN-major
//     B operand (a 64-column block of a tap's 16 rows is two 1024-byte
//     swizzle atoms: SBO 1024 B; BN = 128 takes two boxes: LBO 18432 B).
//     Columns past CoutP come back 0, so BN = 128 needs no padding;
//   - warp specialisation: one producer warp (of a producer warpgroup whose
//     registers setmaxnreg lowers) issues every TMA load; two consumer
//     warpgroups own the 256-voxel tile, two z planes each, x BN output
//     channels. mbarrier full/empty pairs run a ring of 3 boxes and 4 weight
//     stages; a stage's 18 wgmma (9 taps x 2 planes) are one commit group,
//     and wait_group<1> lets one group's products run while the next group's
//     loads land (measured on the card, the copies then hide behind the
//     products: the whole takes about what a products-only form takes;
//     deeper rings and 3-tap stages ran no faster, PERF.md section 6);
//   - the epilogue adds the bias in fp32 and rounds to bf16 once, storing
//     only the voxels inside the volume (a box overhangs where X or Y is not
//     a multiple of 8 or Z of 4). Grids with too few blocks for one wave
//     split the K loop into fp32 partials, added in a fixed order by the
//     split-K reduce kernel: no atomics, outputs bit-equal from call to call.
//   - STATS (kernel D's dual form, two inputs: B's conv plus the per-sample
//     channel sum and sum of squares of its rounded output): with a whole
//     K loop the epilogue sums the bf16 values it stores, per column, over
//     its voxels inside the volume: in registers over the thread's two
//     planes and two lines, by shuffles over the 8 lanes of a column pair,
//     then through shared memory over the 8 consumer warps in warp order,
//     into one row (2, BN) of the partials (N, tiles of a sample, 2, Cout),
//     which reduce_rows adds in tile order (no atomics: two calls are
//     bit-equal). With a split K loop the split-K reduce takes the stats
//     instead (splitk_reduce_stats), in the same pass that writes the
//     output. The products, the plan and the rounding are B's: D's dual
//     form writes B's output bit for bit.
//   - BN (64 or 128) and the K splits are picked per call from a wave model
//     (h_plan).
//
// The probes' forms (mode): 1 copies only (the consumers take each stage and
// hand it back without a product), 2 products only (the producer signals
// each stage without loading it), to show which of the two sets the pace;
// and wgmma_probe_kernel, one m64 x n x k16 product of a TMA-staged box at a
// tap's offset, held against torch on the card.
//
// Layouts: a, b: (N, Z, Y, X, C) bf16 contiguous, 16-byte aligned, C % 8 ==
// 0; w: (kchunks, 27, 16, CoutP) bf16 (ops/conv3d.py:prepare_conv3d_weight);
// out: (N, Z, Y, X, Cout) bf16; ws: (splits, N*Z*Y*X, Cout) fp32 partials;
// part (STATS): (N, rows, 2, Cout) fp32, rows = h_stats_rows.
#include <cuda.h>

#include <initializer_list>

#include "common.cuh"

namespace mt {
namespace {

constexpr int HBZ = 4, HBY = 8, HBX = 8;                  // output tile (256 voxels)
constexpr int HHZ = HBZ + 2, HHY = HBY + 2, HHX = HBX + 2;  // its halo box
constexpr int UNIT = 8;                                   // channels of a TMA box row
constexpr int UNIT_BYTES = HHZ * HHY * HHX * UNIT * 2;    // 9600
constexpr int BOX_BYTES = 2 * UNIT_BYTES;                 // one 16-channel chunk
constexpr int LINE_BYTES = HHX * UNIT * 2;                // 160: SBO of the A operand
constexpr int BOX_STAGES = 3;
constexpr int W_TAPS = 9;                  // taps a weight stage (one dz)
constexpr int W_GROUPS = 27 / W_TAPS;      // weight stages a K chunk
constexpr int W_ROWS = W_TAPS * KC;        // 144 rows of 64 columns
constexpr int W_BOX_BYTES = W_ROWS * 128;  // 18432: one 64-column TMA box
constexpr int W_STAGES = 4;
constexpr int H_THREADS = 384;  // two consumer warpgroups, one producer warpgroup
constexpr int H_MAX_SPLITS = 64;
constexpr int MODE_WHOLE = 0, MODE_COPIES = 1, MODE_PRODUCTS = 2;
// the wave model's costs, in units of one 16-channel chunk of a BN = 128
// block: a block's fixed cost (barriers, the first loads, the epilogue), a
// chunk at BN = 64 (the same A operand reads, half the products) and a
// split K loop's partials and reduce launch
constexpr double H_BLOCK_COST = 1.0, H_BN64_COST = 0.6, H_SPLIT_COST = 2.0;

template <int BN>
__host__ __device__ constexpr int w_stage_bytes() {
  return BN / 64 * W_BOX_BYTES;
}
constexpr int H_CONSUMER_WARPS = 8;
template <int BN, bool STATS = false>
__host__ __device__ constexpr int h_smem_bytes() {
  // 1024 for aligning the ring to the 128-byte swizzle's atom, then the
  // full/empty barrier pairs, then (STATS) the consumer warps' column sums
  return 1024 + W_STAGES * w_stage_bytes<BN>() + BOX_STAGES * BOX_BYTES +
         16 * (W_STAGES + BOX_STAGES) + (STATS ? H_CONSUMER_WARPS * 2 * BN * 4 : 0);
}

struct HParams {
  const float* bias;  // may be null
  __nv_bfloat16* out;
  float* ws;    // split-K partials, when splits > 1
  float* part;  // STATS: the stats rows (N, tiles_zyx, 2, Cout)
  int z, y, x, cout;
  int tiles_y, tiles_x, tiles_zyx;
  int kchunks0;  // K chunks of input a; b's follow
  int per_split, kchunks;
  int mode;
};

// ---------------------------------------------------------------------------
// PTX wrappers: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// A shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), layout (0: no swizzle, 1: 128-byte swizzle).
__host__ __device__ constexpr uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                                 int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}
constexpr int LAYOUT_NONE = 0, LAYOUT_B128 = 1;

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
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (m64 x n, fp32) += A (m64 x k16, K-major, bf16) * B (k16 x n, MN-major,
// bf16), both from shared memory: imm-trans-b 1
template <int N>
struct Mma;
template <>
struct Mma<64> {
  __device__ static void run(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <>
struct Mma<128> {
  __device__ static void run(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

// The A operand of plane `plane`, tap (dz, dy, dx) in the staged box at
// `box`: 8 y lines (SBO) of 8 x voxels, the chunk's two units LBO apart.
__device__ __forceinline__ uint64_t box_desc(uint32_t box, int plane, int dz, int dy, int dx) {
  return gmma_desc(box + ((plane + dz) * HHY + dy) * LINE_BYTES + dx * UNIT * 2, UNIT_BYTES,
                   LINE_BYTES, LAYOUT_NONE);
}
// The B operand of tap t of a weight stage at `stage`: 16 rows of 64
// columns (two 8-row swizzle atoms, SBO 1024 B), 64-column boxes LBO apart.
__device__ __forceinline__ uint64_t weight_desc(uint32_t stage, int t) {
  return gmma_desc(stage + t * KC * 128, W_BOX_BYTES, 1024, LAYOUT_B128);
}

// ---------------------------------------------------------------------------
// the body
// ---------------------------------------------------------------------------

// Block (tile, column block, split): tile blockIdx.x of the 4x8x8 boxes of
// the N samples, output columns [blockIdx.y * BN, + BN), K chunks
// [blockIdx.z * per_split, + per_split). Warpgroups 0 and 1 consume (planes
// 2w and 2w + 1 of the tile), warpgroup 2's first thread produces. STATS
// (one split only): the tile's column sums of the rounded output into row
// (n, tile of the sample) of p.part.
template <int BN, int NIN, bool STATS = false>
__global__ void __launch_bounds__(H_THREADS, 1)
    conv3d_h_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    const __grid_constant__ CUtensorMap map_w, const HParams p) {
  static_assert(!STATS || NIN == 2, "the stats serve kernel D's dual form");
  constexpr int WSTAGE = w_stage_bytes<BN>();
  constexpr int R = BN / 2;  // accumulators of a thread a plane
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t wring = base;
  const uint32_t boxes = wring + W_STAGES * WSTAGE;
  const uint32_t bars = boxes + BOX_STAGES * BOX_BYTES;
  auto full_w = [&](int s) { return bars + 8 * s; };
  auto empty_w = [&](int s) { return bars + 8 * (W_STAGES + s); };
  auto full_b = [&](int s) { return bars + 8 * (2 * W_STAGES + s); };
  auto empty_b = [&](int s) { return bars + 8 * (2 * W_STAGES + BOX_STAGES + s); };

  const int nb = blockIdx.x / p.tiles_zyx;
  const int ts = blockIdx.x - nb * p.tiles_zyx;  // the tile within its sample
  const int z0 = ts / (p.tiles_y * p.tiles_x) * HBZ;
  const int y0 = ts / p.tiles_x % p.tiles_y * HBY;
  const int x0 = ts % p.tiles_x * HBX;
  const int n0 = blockIdx.y * BN;
  const int k_lo = blockIdx.z * p.per_split;
  const int k_hi = min(p.kchunks, k_lo + p.per_split);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(full_w(s), 1);
      mbar_init(empty_w(s), 8);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < BOX_STAGES; ++s) {
      mbar_init(full_b(s), 1);
      mbar_init(empty_b(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 256) return;
    tma_prefetch(&map_a);
    if (NIN == 2) tma_prefetch(&map_b);
    tma_prefetch(&map_w);
    int q = 0;  // weight stages issued
    for (int kc = k_lo; kc < k_hi; ++kc) {
      const int i = kc - k_lo, sb = i % BOX_STAGES;
      mbar_wait(empty_b(sb), ((i / BOX_STAGES) & 1) ^ 1);
      // selects, not an indexed input: chunks of a, then of b
      const bool second = NIN == 2 && kc >= p.kchunks0;
      const int c0 = (kc - (second ? p.kchunks0 : 0)) * KC;
      const CUtensorMap* map = second ? &map_b : &map_a;
      const uint32_t box = boxes + sb * BOX_BYTES;
      if (p.mode != MODE_PRODUCTS) {
        mbar_expect_tx(full_b(sb), BOX_BYTES);
        tma_load_5d(box, map, full_b(sb), c0, x0 - 1, y0 - 1, z0 - 1, nb);
        tma_load_5d(box + UNIT_BYTES, map, full_b(sb), c0 + UNIT, x0 - 1, y0 - 1, z0 - 1, nb);
      } else {
        mbar_arrive(full_b(sb));
      }
      for (int g = 0; g < W_GROUPS; ++g, ++q) {
        const int sw = q % W_STAGES;
        mbar_wait(empty_w(sw), ((q / W_STAGES) & 1) ^ 1);
        if (p.mode != MODE_PRODUCTS) {
          mbar_expect_tx(full_w(sw), WSTAGE);
          const int row = (kc * 27 + g * W_TAPS) * KC;
#pragma unroll
          for (int h = 0; h < BN / 64; ++h)
            tma_load_2d(wring + sw * WSTAGE + h * W_BOX_BYTES, &map_w, full_w(sw), n0 + h * 64,
                        row);
        } else {
          mbar_arrive(full_w(sw));
        }
      }
    }
    return;
  }

  // the consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32 % 4;
  float acc[2][R];
#pragma unroll
  for (int pl = 0; pl < 2; ++pl)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[pl][r] = 0.f;
  // hand stage group q back to the producer: its weights, and the box with
  // its chunk's last group
  auto release = [&](int q) {
    if (lane != 0) return;
    mbar_arrive(empty_w(q % W_STAGES));
    if (q % W_GROUPS == W_GROUPS - 1) mbar_arrive(empty_b(q / W_GROUPS % BOX_STAGES));
  };
  int q = 0;  // weight stages consumed
  for (int kc = k_lo; kc < k_hi; ++kc) {
    const int i = kc - k_lo, sb = i % BOX_STAGES;
    mbar_wait(full_b(sb), (i / BOX_STAGES) & 1);
    const uint32_t box = boxes + sb * BOX_BYTES;
#pragma unroll
    for (int g = 0; g < W_GROUPS; ++g, ++q) {
      const int sw = q % W_STAGES;
      mbar_wait(full_w(sw), (q / W_STAGES) & 1);
      if (p.mode == MODE_COPIES) {
        release(q);
        continue;
      }
      const uint32_t stage = wring + sw * WSTAGE;
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < W_TAPS; ++tap) {
        const int t = g * W_TAPS + tap;  // (dz, dy, dx) = (t / 9, t / 3 % 3, t % 3)
        const uint64_t wd = weight_desc(stage, tap);
#pragma unroll
        for (int pl = 0; pl < 2; ++pl)
          Mma<BN>::run(acc[pl], box_desc(box, 2 * wg + pl, t / 9, t / 3 % 3, t % 3), wd);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      if (q > 0) release(q - 1);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc[0]);
  fence_acc(acc[1]);

  // epilogue: accumulator r of plane pl is row warp * 16 + lane / 4 (+8 for
  // r % 4 >= 2) of the plane's m64 (y = row / 8, x = row % 8), column
  // (r / 4) * 8 + 2 * (lane % 4) + r % 2
  const bool partial = gridDim.z > 1;
  const int64_t nvox = (int64_t)(gridDim.x / p.tiles_zyx) * p.z * p.y * p.x;
  // STATS: the 8 consumer warps' column sums, [warp][sum, squares][BN]
  float* red = reinterpret_cast<float*>(smem_raw + (bars - smem_addr(smem_raw)) +
                                        16 * (W_STAGES + BOX_STAGES));
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int co = n0 + j * 8 + (lane % 4) * 2;
    float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;  // STATS: this thread's voxels
#pragma unroll
    for (int pl = 0; pl < 2; ++pl) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int oz = z0 + 2 * wg + pl, oy = y0 + warp * 2 + h, ox = x0 + lane / 4;
        if (co >= p.cout || oz >= p.z || oy >= p.y || ox >= p.x) continue;
        const int64_t vox = (((int64_t)nb * p.z + oz) * p.y + oy) * p.x + ox;
        float v0 = acc[pl][j * 4 + h * 2], v1 = acc[pl][j * 4 + h * 2 + 1];
        if (partial) {
          float* dst = p.ws + ((int64_t)blockIdx.z * nvox + vox) * p.cout + co;
          if (p.cout % 2 == 0) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            dst[0] = v0;
            if (co + 1 < p.cout) dst[1] = v1;
          }
          continue;
        }
        if (p.bias != nullptr) {
          v0 += p.bias[co];
          if (co + 1 < p.cout) v1 += p.bias[co + 1];
        }
        store_pair(p.out + vox * p.cout, co, p.cout, v0, v1);
        if constexpr (STATS) {  // the values as stored
          const float r0 = __bfloat162float(__float2bfloat16(v0));
          const float r1 = co + 1 < p.cout ? __bfloat162float(__float2bfloat16(v1)) : 0.f;
          s0 += r0;
          q0 += r0 * r0;
          s1 += r1;
          q1 += r1 * r1;
        }
      }
    }
    if constexpr (STATS) {  // over the 8 lanes of the column pair, into the warp's row
#pragma unroll
      for (int off = 4; off < 32; off *= 2) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        q0 += __shfl_xor_sync(0xffffffffu, q0, off);
        q1 += __shfl_xor_sync(0xffffffffu, q1, off);
      }
      if (lane < 4) {
        float* row = red + (threadIdx.x / 32) * 2 * BN + j * 8 + lane * 2;
        row[0] = s0;
        row[1] = s1;
        row[BN] = q0;
        row[BN + 1] = q1;
      }
    }
  }
  if constexpr (STATS) {  // the 8 warps' rows in warp order: the tile's row of p.part
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the consumers only
    for (int i = threadIdx.x; i < 2 * BN; i += 256) {
      const int k = i / BN, c = i - k * BN, co = n0 + c;
      if (co >= p.cout) continue;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < H_CONSUMER_WARPS; ++w) v += red[(w * 2 + k) * BN + c];
      p.part[(((int64_t)nb * p.tiles_zyx + ts) * 2 + k) * p.cout + co] = v;
    }
  }
}

// One m64 x N x k16 product of a TMA-staged box: the box of a (N, Z, Y, X,
// C) tensor at (0, z0-1, y0-1, x0-1, n 0) as the body stages it, chunk 0's
// weights for the taps of tap's weight stage, then plane `plane`, tap `tap`
// through the body's descriptors (box_desc, weight_desc) into out (64, N)
// fp32, row m = y * 8 + x.
template <int N>
__global__ void __launch_bounds__(128, 1)
    wgmma_probe_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_w, float* out, int tap, int plane,
                       int z0, int y0, int x0) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t wst = base, box = base + 2 * W_BOX_BYTES, bar = box + BOX_BYTES;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, BOX_BYTES + N / 64 * W_BOX_BYTES);
    tma_load_5d(box, &map_x, bar, 0, x0 - 1, y0 - 1, z0 - 1, 0);
    tma_load_5d(box + UNIT_BYTES, &map_x, bar, UNIT, x0 - 1, y0 - 1, z0 - 1, 0);
    for (int h = 0; h < N / 64; ++h)
      tma_load_2d(wst + h * W_BOX_BYTES, &map_w, bar, h * 64, tap / W_TAPS * W_ROWS);
  }
  mbar_wait(bar, 0);
  float acc[N / 2];
#pragma unroll
  for (int r = 0; r < N / 2; ++r) acc[r] = 0.f;
  fence_acc(acc);
  wgmma_fence();
  Mma<N>::run(acc, box_desc(box, plane, tap / 9, tap / 3 % 3, tap % 3),
              weight_desc(wst, tap % W_TAPS));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int r = 0; r < N / 2; ++r) {
    const int m = warp * 16 + lane / 4 + (r % 4 >= 2 ? 8 : 0);
    const int col = (r / 4) * 8 + (lane % 4) * 2 + r % 2;
    out[m * N + col] = acc[r];
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime loaded: nothing links
// -lcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return (EncodeTiled) nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) !=
        cudaSuccess)
      return (EncodeTiled) nullptr;
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// The halo box map of a (N, Z, Y, X, C) bf16 tensor: box (8, 10, 10, 6, 1),
// zero outside the tensor.
bool activation_map(CUtensorMap* m, const void* ptr, int n, int z, int y, int x, int c) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr || c % UNIT != 0) return false;
  const cuuint64_t dims[5] = {(cuuint64_t)c, (cuuint64_t)x, (cuuint64_t)y, (cuuint64_t)z,
                              (cuuint64_t)n};
  const cuuint64_t row = (cuuint64_t)c * 2;
  const cuuint64_t strides[4] = {row, row * x, row * x * y, row * x * y * z};
  const cuuint32_t box[5] = {UNIT, HHX, HHY, HHZ, 1};
  const cuuint32_t es[5] = {1, 1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(ptr), dims, strides, box,
             es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The weight map of (rows, CoutP) bf16: box (64 columns, 144 rows), the
// 128-byte swizzle, zero past CoutP.
bool weight_map(CUtensorMap* m, const void* w, long long rows, int coutp) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr || coutp % 8 != 0) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)coutp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)coutp * 2};
  const cuuint32_t box[2] = {64, W_ROWS};
  const cuuint32_t es[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims, strides, box,
             es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int NIN, bool STATS = false>
cudaError_t h_launch(const HPlan& plan, const CUtensorMap& ma, const CUtensorMap& mb,
                     const CUtensorMap& mw, const HParams& p, cudaStream_t stream) {
  constexpr int smem = h_smem_bytes<BN, STATS>();
  cudaError_t err = cudaFuncSetAttribute(conv3d_h_kernel<BN, NIN, STATS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(plan.tiles, plan.nblk, plan.splits);
  conv3d_h_kernel<BN, NIN, STATS><<<grid, H_THREADS, smem, stream>>>(ma, mb, mw, p);
  return cudaGetLastError();
}

}  // namespace

bool h_plan(int n, int z, int y, int x, int ca, int cb, int cout, int coutp, int sms,
            HPlan* out) {
  if (n <= 0 || z <= 0 || y <= 0 || x <= 0 || ca <= 0 || ca % UNIT || cb < 0 || cb % UNIT ||
      cout <= 0 || coutp < cout || coutp % 8)
    return false;
  HPlan p{};
  p.tiles_z = cdiv(z, HBZ);
  p.tiles_y = cdiv(y, HBY);
  p.tiles_x = cdiv(x, HBX);
  const long long tiles = (long long)n * p.tiles_z * p.tiles_y * p.tiles_x;
  if (tiles > 0x7fffffffLL) return false;
  p.tiles = (int)tiles;
  p.kchunks = cdiv(ca, KC) + cdiv(cb, KC);
  const long long vox = (long long)n * z * y * x;
  const long long in_bytes = vox * (ca + cb) * 2 + (long long)p.kchunks * 27 * KC * coutp * 2;
  const long long part_bytes = vox * cout * 4;  // one split's partials
  double best = -1.0;
  for (int bn : {128, 64}) {
    const int nblk = cdiv(cout, bn);
    const long long blocks = tiles * nblk;
    for (int s = 1; s <= p.kchunks && s <= H_MAX_SPLITS; ++s) {
      const int per = cdiv(p.kchunks, s);
      if (cdiv(p.kchunks, per) != s) continue;  // the same as fewer splits
      if (s > 1 && s * part_bytes > in_bytes) break;
      const long long waves = (blocks * s + sms - 1) / sms;
      const double cost = waves * (per + H_BLOCK_COST) * (bn == 128 ? 1.0 : H_BN64_COST) +
                          (s > 1 ? H_SPLIT_COST : 0.0);
      if (best < 0 || cost < best - 1e-9) {
        best = cost;
        p.bn = bn;
        p.nblk = nblk;
        p.splits = s;
        p.per_split = per;
      }
    }
  }
  p.smem = p.bn == 128 ? h_smem_bytes<128>() : h_smem_bytes<64>();
  *out = p;
  return true;
}

long long h_workspace_bytes(const HPlan& plan, int n, int z, int y, int x, int cout) {
  if (plan.splits <= 1) return 0;
  return (long long)plan.splits * n * z * y * x * cout * (long long)sizeof(float);
}

int h_stats_rows(const HPlan& plan, int n, long long s, int cout) {
  return plan.splits > 1 ? splitk_stats_rows(n, s, cout)
                         : plan.tiles_z * plan.tiles_y * plan.tiles_x;
}

cudaError_t h_run(const HPlan& plan, const void* a, const void* b, int ca, int cb, const void* w,
                  const void* bias, void* out, void* ws, long long ws_bytes, float* part, int n,
                  int z, int y, int x, int cout, int coutp, int mode, cudaStream_t stream) {
  const long long need = h_workspace_bytes(plan, n, z, y, x, cout);
  if (need > 0 && (ws == nullptr || ws_bytes < need)) return cudaErrorInvalidValue;
  if (mode < MODE_WHOLE || mode > MODE_PRODUCTS || (part != nullptr && cb == 0))
    return cudaErrorInvalidValue;
  CUtensorMap ma, mb, mw;
  if (!activation_map(&ma, a, n, z, y, x, ca) ||
      (cb > 0 && !activation_map(&mb, b, n, z, y, x, cb)) ||
      !weight_map(&mw, w, (long long)plan.kchunks * 27 * KC, coutp))
    return cudaErrorInvalidValue;
  if (cb == 0) mb = ma;
  HParams p{};
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.ws = static_cast<float*>(ws);
  p.part = part;
  p.z = z;
  p.y = y;
  p.x = x;
  p.cout = cout;
  p.tiles_y = plan.tiles_y;
  p.tiles_x = plan.tiles_x;
  p.tiles_zyx = plan.tiles_z * plan.tiles_y * plan.tiles_x;
  p.kchunks0 = cdiv(ca, KC);
  p.per_split = plan.per_split;
  p.kchunks = plan.kchunks;
  p.mode = mode;
  // the stats epilogue with one split; a split's stats are the reduce's
  const bool stats = part != nullptr && plan.splits == 1;
  cudaError_t err;
  if (plan.bn == 128) {
    err = stats    ? h_launch<128, 2, true>(plan, ma, mb, mw, p, stream)
          : cb > 0 ? h_launch<128, 2>(plan, ma, mb, mw, p, stream)
                   : h_launch<128, 1>(plan, ma, mb, mw, p, stream);
  } else {
    err = stats    ? h_launch<64, 2, true>(plan, ma, mb, mw, p, stream)
          : cb > 0 ? h_launch<64, 2>(plan, ma, mb, mw, p, stream)
                   : h_launch<64, 1>(plan, ma, mb, mw, p, stream);
  }
  if (err != cudaSuccess || plan.splits == 1) return err;
  const long long s = (long long)z * y * x;
  if (part != nullptr)
    return splitk_reduce_stats(p.ws, p.bias, p.out, part, n, s, cout, plan.splits, stream);
  return splitk_reduce(p.ws, p.bias, p.out, n * s * cout, cout, plan.splits, stream);
}

}  // namespace mt

extern "C" {

// The wgmma body alone, in `mode` (0 whole, 1 copies only, 2 products only):
// kernel A (b null, cb 0) or B at sizes every input of which has C % 8 == 0,
// with its own plan; ws as mt_conv3d_workspace reports for such a call.
// Returns cudaGetLastError() after the launches.
int mt_conv3d_wgmma(const void* a, const void* b, const void* w, const void* bias, void* out,
                    void* ws, long long ws_bytes, int n, int z, int y, int xd, int ca, int cb,
                    int cout, int coutp, int mode, void* stream) {
  mt::HPlan plan;
  if ((b == nullptr) != (cb == 0) ||
      !mt::h_plan(n, z, y, xd, ca, cb, cout, coutp, mt::sm_count(), &plan))
    return (int)cudaErrorInvalidValue;
  return (int)mt::h_run(plan, a, b, ca, cb, w, bias, out, ws, ws_bytes, nullptr, n, z, y, xd,
                        cout, coutp, mode, static_cast<cudaStream_t>(stream));
}

// One wgmma (m64 x n x k16, n = 64 or 128) of the body's staging: x (1, Z,
// Y, X, C) bf16 with C % 8 == 0, w prepared (chunk 0 is read), out (64, n)
// fp32 = plane `plane`, tap `tap` of the 4x8x8 tile at (z0, y0, x0), through
// the body's descriptors.
int mt_wgmma_probe(const void* x, const void* w, void* out, int z, int y, int xd, int c,
                   int coutp, int n, int tap, int plane, int z0, int y0, int x0, void* stream) {
  if ((n != 64 && n != 128) || tap < 0 || tap >= 27 || plane < 0 || plane >= mt::HBZ)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mx, mw;
  if (!mt::activation_map(&mx, x, 1, z, y, xd, c) ||
      !mt::weight_map(&mw, w, (long long)mt::cdiv(c, mt::KC) * 27 * mt::KC, coutp))
    return (int)cudaErrorInvalidValue;
  const int smem = 1024 + 2 * mt::W_BOX_BYTES + mt::BOX_BYTES + 8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  cudaError_t err;
  if (n == 64) {
    err = cudaFuncSetAttribute(mt::wgmma_probe_kernel<64>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      mt::wgmma_probe_kernel<64><<<1, 128, smem, s>>>(mx, mw, o, tap, plane, z0, y0, x0);
  } else {
    err = cudaFuncSetAttribute(mt::wgmma_probe_kernel<128>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      mt::wgmma_probe_kernel<128><<<1, 128, smem, s>>>(mx, mw, o, tap, plane, z0, y0, x0);
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
