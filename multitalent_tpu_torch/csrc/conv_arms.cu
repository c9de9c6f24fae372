// Three arms of the stride-1 SAME 3x3x3 convolution, channels-last bf16, fp32
// accumulation, each by its own algorithm on the tensor cores.
//
// Replaces the Pallas TPU kernel scripts/conv_impl_arms.py:_conv_kernel
// (pallas_call at :248) in three of its five arms:
//   - 'im2col' (:160-176): one [M, 27*C] x [27*C, Cout] GEMM from a
//     materialised tile;
//   - 'tap3':   the x taps folded into K, 9 GEMMs of [M, 3*C] x [3*C, Cout];
//   - 'wino':   Winograd F(2x2x2, 3x3x3), 64 transform-domain GEMMs.
// Its 'tap' and 'sum' arms differ on the TPU only in where the accumulator
// lives (a VMEM scratch or the MXU's result chain); a kernel here keeps it
// in registers either way, so both are kernel A (conv3d_same.cu).
//
// What bounds them on an H100: the direct conv does 2*27*C*Cout FLOPs per
// voxel, ~27*C FLOPs per input byte, far above the ~295 FLOP/byte ridge, so
// the tensor cores bound the function (1.38 TFLOP at (2,96,96,96,120) -> 120:
// 1.39 ms at 989 TFLOP/s). The forms are bound instead by:
//   - im2col, C % 8 == 0 (im2col_tma_kernel, wgmma fed by TMA): its own
//     cost, the im2col rows: every output voxel's 27 taps are loaded into
//     shared memory, 27x the input bytes (12.2 GB at the timed shape,
//     mostly L2 hits), plus the weight once a 256-voxel tile (6.1 GB; the
//     first body streamed it once per 32 voxels, 48.9 GB). What the body
//     does:
//       * TMA's im2col mode builds the A operand: one load a (tap, 64
//         channels, 128 output voxels) with the tap's (dx, dy, dz) as the
//         load's offsets, 128 consecutive output voxels a column across
//         lines, planes and samples; the map's bounding box (corners -1,
//         -1) gives the SAME halo, and elements outside the tensor (the
//         halo, channels past C) come back 0, so no mask and no zeroing;
//         the 128-byte swizzle is wgmma's K-major A layout;
//       * the prepared weight through a 2-D tiled map (64-column boxes of
//         64 rows, 128-byte swizzle: wgmma's MN-major B operand); rows past
//         a tap's channels meet zero A channels, rows past the weight come
//         back 0;
//       * wgmma m64n128k16 into fp32 registers: one producer thread issues
//         every load, two consumer warpgroups own 128 rows each of a
//         256-voxel tile, a ring of 4 stages (A 32 KB + B 16 KB) with
//         full/empty mbarriers, one commit group a stage and wait_group<1>;
//         persistent blocks walk the tiles, so a tile's epilogue overlaps
//         the next tile's first loads;
//       * the epilogue rounds to bf16 once and stores the Cout real columns
//         of the rows inside the volume, staged through 32 KB of shared
//         memory beside the ring so that whole rows leave (hopper.cuh
//         store_m64n128);
//   - im2col, other C (im2col_kernel, the first body, mma.sync): 27x the
//     input bytes copied into shared memory, and the whole [27*C, Cout]
//     weight streamed through shared memory for every 32 output voxels (one
//     block per SM: the 32-row tile alone is 221 KB at C = 128, the dynamic
//     shared-memory opt-in);
//   - tap3, C % 8 == 0 (tap3_tma_kernel, wgmma fed by TMA): the x taps
//     folded into K without restaging: a 4x8x8 output box's haloed rows are
//     three TMA loads a 32-channel chunk, shifted by one voxel in x (zeros
//     outside the tensor), and with an x extent of 8 every (dz, dy) shift is
//     whole 8-row swizzle atoms, so each tap is the same A descriptor with
//     its start moved; the weight once a 256-voxel tile through a TMA ring
//     (6.1 GB at the timed shape, 2.5 GB of x-shifted rows);
//   - tap3, other C (tap3_kernel, the first body): kernel A's schedule with
//     the three x taps of a 16-channel chunk side by side in one row (an
//     x-concatenated copy of the haloed box built by cp.async once per
//     chunk), so each (dz, dy) is one mma.sync GEMM with K = 48;
//   - wino: 8/27 of the direct conv's multiplies (0.469 ms of transform-domain
//     products at the timed shape), but its input transform runs on the
//     CUDA cores, about 10 instructions a transformed value, and every 64
//     tiles x 64 columns (what the registers hold) stream the 64
//     transformed weight matrices from L2 (7.25 GB at the timed shape).
//     C % 8 == 0 (wino_tma_kernel): two transform warpgroups build each
//     position's V into swizzled buffers (B^T, adds only, fp32, rounded to
//     bf16 once), two consumer warpgroups run wgmma on it, A^T along x on
//     the tensor cores and along y and z on the CUDA cores; other C
//     (wino_kernel, the first body): V built by every thread, mma.sync, A^T
//     with 8 FMAs per accumulator per position. The weights are transformed
//     on the host (G w G^T per axis in fp32, rounded to bf16 once). Every
//     spatial size must be even.

// Layouts (C_P: C rounded up to 16; the probes' wrappers prepare the weights):
//   x:   (N, Z, Y, X, C) bf16, contiguous; out: (N, Z, Y, X, Cout) bf16.
//   im2col weight: (27 * C_P, CoutP) bf16, row tap * C_P + c, CoutP a
//     multiple of 128, tap = (dz*3 + dy)*3 + dx.
//   tap3 weight: (C_P / 16, 9, 48, CoutP) bf16, [chunk, dz*3 + dy, dx*16 + c],
//     CoutP a multiple of BN (32 or 64); the TMA body reads two 16-channel
//     chunks a box.
//   wino weight: (64, C_P, CoutP) bf16, [(a*4 + b)*4 + c, ci, co], CoutP a
//     multiple of 128.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace mt;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int SMEM_LIMIT = 232448;  // the opt-in maximum of one block

struct ArmParams {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;
  __nv_bfloat16* out;
  int n, z, y, x_, c, cp, cout, coutp;
};

__device__ __forceinline__ int64_t voxel(const ArmParams& p, int nb, int gz, int gy, int gx) {
  return (((int64_t)nb * p.z + gz) * p.y + gy) * p.x_ + gx;
}

// Copy `vec` channels (8: 16 bytes, 2: 4 bytes, 1: one element) of voxel
// (gz, gy, gx), channel ch, to dst; zero when outside the volume or past C.
__device__ __forceinline__ void copy_channels(__nv_bfloat16* dst, const ArmParams& p, int vec,
                                              int nb, int gz, int gy, int gx, int ch) {
  const bool inside = gz >= 0 && gz < p.z && gy >= 0 && gy < p.y && gx >= 0 && gx < p.x_ &&
                      ch < p.c;
  const __nv_bfloat16* s = inside ? p.x + voxel(p, nb, gz, gy, gx) * p.c + ch : p.x;
  if (vec == 8) {
    cp_async16(dst, s, inside);
  } else if (vec == 2) {
    cp_async4(dst, s, inside);
  } else {
    dst[0] = inside ? *s : __float2bfloat16(0.f);
  }
}

__host__ __device__ __forceinline__ int channel_vec(int c) {
  return (c % 8 == 0) ? 8 : ((c % 2 == 0) ? 2 : 1);
}

// ---------------------------------------------------------------------------
// im2col: a block owns 32 consecutive output voxels along x and 128 output
// channels; it materialises their [32, 27 * C_P] im2col rows in shared memory
// once, then runs one GEMM over K = 27 * C_P with the weight streamed in
// 16-row chunks through two shared-memory stages.
// ---------------------------------------------------------------------------
constexpr int I2C_M = 32;
constexpr int I2C_N = 128;
constexpr int I2C_BNP = I2C_N + 8;

// 16 bytes of padding per row: ldmatrix's 8 rows fall on 8 distinct 16-byte
// bank groups for every C_P
__host__ __device__ constexpr int i2c_stride(int cp) { return 27 * cp + 8; }
inline int i2c_smem(int cp) { return I2C_M * i2c_stride(cp) * 2 + 2 * KC * I2C_BNP * 2; }

__global__ void __launch_bounds__(THREADS, 1) im2col_kernel(ArmParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int as = i2c_stride(p.cp);
  __nv_bfloat16* a = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* bs = a + I2C_M * as;  // two stages of (16, I2C_BNP)
  const int xblocks = cdiv(p.x_, I2C_M);
  int t = blockIdx.x;
  const int x0 = (t % xblocks) * I2C_M;
  t /= xblocks;
  const int gy = t % p.y;
  t /= p.y;
  const int gz = t % p.z;
  const int nb = t / p.z;
  const int n0 = blockIdx.y * I2C_N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 2, wn = warp / 2;  // 16 rows x 32 columns per warp

  // row r, tap (dz, dy, dx), channel c = x[gz + dz - 1, gy + dy - 1, x0 + r + dx - 1, c]
  const int vec = channel_vec(p.c);
  const int per_tap = p.cp / vec;
  const int total = I2C_M * 27 * per_tap;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int r = i / (27 * per_tap);
    const int rem = i - r * 27 * per_tap;
    const int tap = rem / per_tap;
    const int ch = (rem - tap * per_tap) * vec;
    copy_channels(a + r * as + tap * p.cp + ch, p, vec, nb, gz + tap / 9 - 1,
                  gy + (tap / 3) % 3 - 1, x0 + r + tap % 3 - 1, ch);
  }
  auto load_b = [&](int kc, int stage) {  // 16 rows x 128 columns: one copy a thread
    const int row = threadIdx.x / 16, col = (threadIdx.x % 16) * 8;
    cp_async16(bs + (stage * KC + row) * I2C_BNP + col,
               p.w + ((int64_t)kc * KC + row) * p.coutp + n0 + col, true);
  };
  load_b(0, 0);
  cp_async_wait_all();
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const __nv_bfloat16* arow = a + (wm * 16 + lane % 16) * as + (lane / 16) * 8;
  const int brow = (lane % 16) * I2C_BNP + wn * 32 + (lane / 16) * 8;
  const int kchunks = 27 * p.cp / KC;
#pragma unroll 1
  for (int kc = 0; kc < kchunks; ++kc) {
    const int stage = kc & 1;
    if (kc + 1 < kchunks) load_b(kc + 1, stage ^ 1);
    uint32_t af[4];
    ldmatrix_x4(af, arow + kc * KC);
    const __nv_bfloat16* bt = bs + stage * KC * I2C_BNP + brow;
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, bt + j * 8);
      mma_16816(acc[j], af, b[0], b[1]);
      mma_16816(acc[j + 1], af, b[2], b[3]);
    }
    cp_async_wait_all();
    __syncthreads();  // stage ^ 1 has landed, stage is consumed
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gx = x0 + wm * 16 + lane / 4 + h * 8;
    if (gx >= p.x_) continue;
    __nv_bfloat16* row = p.out + voxel(p, nb, gz, gy, gx) * p.cout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + wn * 32 + j * 8 + (lane % 4) * 2;
      if (co < p.cout) store_pair(row, co, p.cout, acc[j][h * 2], acc[j][h * 2 + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// im2col on wgmma fed by TMA (C % 8 == 0): a tile is 256 consecutive output
// voxels (of N * Z * Y * X) x 128 output channels; its K loop runs over the
// 27 taps x the 64-channel chunks of C, one ring stage each: the tap's
// im2col rows of the 256 voxels (two 128-pixel loads) and the chunk's 64
// weight rows.
// ---------------------------------------------------------------------------
constexpr int IT_M = 256;                 // output voxels a tile
constexpr int IT_N = 128;                 // output channels a tile
constexpr int IT_COL = 128;               // pixels of one im2col load
constexpr int IT_CH = 64;                 // channels a pixel of a load (128 bytes)
constexpr int IT_A_BYTES = IT_M * 128;    // 32768
constexpr int IT_B_BOX = IT_CH * 128;     // 64 weight rows x 64 columns: 8192
constexpr int IT_STAGE = IT_A_BYTES + 2 * IT_B_BOX;  // 49152
constexpr int IT_STAGES = 4;
constexpr int IT_EPI = 64 * 256;  // a consumer warpgroup's epilogue rows (one m64)
constexpr int IT_THREADS = 384;   // two consumer warpgroups, one producer warpgroup
constexpr int IT_SMEM = 1024 + IT_STAGES * IT_STAGE + 2 * IT_EPI + 16 * IT_STAGES;
static_assert(IT_SMEM <= SMEM_LIMIT, "the im2col ring's shared memory");

struct ItParams {
  __nv_bfloat16* out;
  long long vox;  // N * Z * Y * X
  int z, y, x, cp, cout;
  int chunks;   // 64-channel chunks a tap
  int tiles_m;  // 256-voxel tiles; tiles_m * CoutP / 128 tiles in all
  int tiles;
  int mode;  // hopper::MODE_*
};

__global__ void __launch_bounds__(IT_THREADS, 1)
    im2col_tma_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_w, const ItParams p) {
  using namespace mt::hopper;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t epi = ring + IT_STAGES * IT_STAGE;
  const uint32_t bars = epi + 2 * IT_EPI;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (IT_STAGES + s); };
  const int steps = 27 * p.chunks;
  if (threadIdx.x == 0) {
    for (int s = 0; s < IT_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer warpgroup: its first thread loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 256) return;
    tma_prefetch(&map_x);
    tma_prefetch(&map_w);
    int q = 0;  // stages issued
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const long long m0 = (long long)(tile % p.tiles_m) * IT_M;
      const int n0 = tile / p.tiles_m * IT_N;
      int cx[2], cy[2], cz[2], cn[2];  // each column's first output voxel
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        long long m = m0 + h * IT_COL;
        cx[h] = (int)(m % p.x);
        m /= p.x;
        cy[h] = (int)(m % p.y);
        m /= p.y;
        cz[h] = (int)(m % p.z);
        cn[h] = (int)(m / p.z);  // N past the last voxel: the load is all zeros
      }
      for (int i = 0; i < steps; ++i, ++q) {
        const int s = q % IT_STAGES;
        mbar_wait(empty(s), ((q / IT_STAGES) & 1) ^ 1);
        if (p.mode == MODE_PRODUCTS) {
          mbar_arrive(full(s));
          continue;
        }
        const int tap = i / p.chunks, ch = i - tap * p.chunks;
        const int row = tap * p.cp + ch * IT_CH;
        const uint32_t stage = ring + s * IT_STAGE;
        mbar_expect_tx(full(s), IT_STAGE);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          tma_load_im2col_5d(stage + h * IT_COL * 128, &map_x, full(s), ch * IT_CH, cx[h] - 1,
                             cy[h] - 1, cz[h] - 1, cn[h], (uint16_t)(tap % 3),
                             (uint16_t)(tap / 3 % 3), (uint16_t)(tap / 9));
#pragma unroll
        for (int b = 0; b < 2; ++b)
          tma_load_2d(stage + IT_A_BYTES + b * IT_B_BOX, &map_w, full(s), n0 + b * 64, row);
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows [128 wg, + 128) of a tile, two m64
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  auto release = [&](int q) {
    if (lane == 0) mbar_arrive(empty(q % IT_STAGES));
  };
  float acc[2][64];
  int q = 0;  // stages consumed
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const long long m0 = (long long)(tile % p.tiles_m) * IT_M;
    const int n0 = tile / p.tiles_m * IT_N;
#pragma unroll
    for (int sub = 0; sub < 2; ++sub)
#pragma unroll
      for (int r = 0; r < 64; ++r) acc[sub][r] = 0.f;
    for (int i = 0; i < steps; ++i, ++q) {
      const int s = q % IT_STAGES;
      mbar_wait(full(s), (q / IT_STAGES) & 1);
      if (p.mode == MODE_COPIES) {
        release(q);
        continue;
      }
      // k16 steps of this chunk: the rest of C_P (the prepared weight's rows
      // of this tap) where under 64
      const int ksteps = min(4, (p.cp - (i % p.chunks) * IT_CH) / KC);
      const uint32_t a = ring + s * IT_STAGE + wg * 128 * 128;
      const uint32_t b = ring + s * IT_STAGE + IT_A_BYTES;
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k >= ksteps) break;
        const uint64_t bd = b_desc(b, IT_B_BOX, k);
#pragma unroll
        for (int sub = 0; sub < 2; ++sub)
          mma_m64n128k16(acc[sub], a_desc(a + sub * 64 * 128, k), bd);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      if (i > 0) release(q - 1);
    }
    wgmma_wait<0>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    if (p.mode != MODE_COPIES) release(q - 1);
    auto voxel = [&](int r) {
      const long long m = m0 + r;
      return m < p.vox ? m : -1ll;
    };
#pragma unroll
    for (int sub = 0; sub < 2; ++sub)
      store_m64n128(acc[sub], epi + wg * IT_EPI, 1 + wg, p.out, p.cout, n0, wg * 128 + sub * 64,
                    voxel);
  }
}

// ---------------------------------------------------------------------------
// tap3: kernel A's schedule (a 256-voxel box, 16-channel K chunks) with the
// x taps folded into K: per chunk the block builds the x-concatenated rows
// xcat[vz, vy, vx] = [x(.., vx - 1, c0:c0+16) | x(.., vx) | x(.., vx + 1)] of
// its box grown by 1 in z and y, then runs 9 GEMMs with K = 48, one per
// (dz, dy), reading rows shifted by (dz, dy).
// ---------------------------------------------------------------------------
constexpr int T3_XS = 3 * KC + 8;  // 112-byte rows: ldmatrix conflict-free
constexpr int T3_ROWS = 640;       // the largest (bz + 2)(by + 2) bx of kBoxes
constexpr int MF = BM / (WARPS * 16);  // 16-voxel M fragments per warp

template <int BN>
constexpr int t3_smem() {
  return T3_ROWS * T3_XS * 2 + 9 * 3 * KC * (BN + 8) * 2;
}

struct Tiles {
  Box box;
  int tz, ty, tx;  // boxes per axis
};

template <int BN>
__global__ void __launch_bounds__(THREADS, 1) tap3_kernel(ArmParams p, Tiles tl) {
  constexpr int BNP = BN + 8;
  constexpr int NT = BN / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xcat = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wsm = xcat + T3_ROWS * T3_XS;
  const Box box = tl.box;
  int t = blockIdx.x;
  const int x0 = (t % tl.tx) * box.x;
  t /= tl.tx;
  const int y0 = (t % tl.ty) * box.y;
  t /= tl.ty;
  const int z0 = (t % tl.tz) * box.z;
  const int nb = t / tl.tz;
  const int nblk = blockIdx.y;
  const int hy = box.y + 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  int a_row[MF];
#pragma unroll
  for (int mi = 0; mi < MF; ++mi) {
    const int m = (warp * MF + mi) * 16 + lane % 16;
    const int vz = m / (box.y * box.x), vy = (m / box.x) % box.y, vx = m % box.x;
    a_row[mi] = ((vz * hy + vy) * box.x + vx) * T3_XS + (lane / 16) * 8;
  }
  const int b_row = (lane % 16) * BNP + (lane / 16) * 8;
  float acc[MF][NT][4];
#pragma unroll
  for (int mi = 0; mi < MF; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;

  const int vec = channel_vec(p.c);
  const int per = KC / vec;  // copies per 16-channel segment
  const int rows = (box.z + 2) * hy * box.x;
  const int kchunks = cdiv(p.c, KC);
#pragma unroll 1
  for (int kc = 0; kc < kchunks; ++kc) {
    const int c0 = kc * KC;
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < rows * 3 * per; i += THREADS) {
      const int r = i / (3 * per);
      const int rem = i - r * 3 * per;
      const int dx = rem / per;
      const int ch = (rem - dx * per) * vec;
      const int vx = r % box.x, vy = (r / box.x) % hy, vz = r / (box.x * hy);
      copy_channels(xcat + r * T3_XS + dx * KC + ch, p, vec, nb, z0 + vz - 1, y0 + vy - 1,
                    x0 + vx + dx - 1, c0 + ch);
    }
    constexpr int VPR = BN / 8;
    for (int i = threadIdx.x; i < 9 * 3 * KC * VPR; i += THREADS) {
      const int row = i / VPR, col = (i - row * VPR) * 8;
      cp_async16(wsm + row * BNP + col,
                 p.w + ((int64_t)kc * 9 * 3 * KC + row) * p.coutp + nblk * BN + col, true);
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll 1
    for (int dzy = 0; dzy < 9; ++dzy) {
      const int off = ((dzy / 3) * hy + dzy % 3) * box.x * T3_XS;
#pragma unroll
      for (int kk = 0; kk < 3; ++kk) {
        uint32_t a[MF][4];
#pragma unroll
        for (int mi = 0; mi < MF; ++mi) ldmatrix_x4(a[mi], xcat + a_row[mi] + off + kk * KC);
        const __nv_bfloat16* wt = wsm + (dzy * 3 * KC + kk * KC) * BNP + b_row;
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, wt + j * 8);
#pragma unroll
          for (int mi = 0; mi < MF; ++mi) {
            mma_16816(acc[mi][j], a[mi], b[0], b[1]);
            mma_16816(acc[mi][j + 1], a[mi], b[2], b[3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < MF; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (warp * MF + mi) * 16 + lane / 4 + h * 8;
      const int gz = z0 + m / (box.y * box.x), gy = y0 + (m / box.x) % box.y,
                gx = x0 + m % box.x;
      if (gz >= p.z || gy >= p.y || gx >= p.x_) continue;
      __nv_bfloat16* row = p.out + voxel(p, nb, gz, gy, gx) * p.cout;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int co = nblk * BN + j * 8 + (lane % 4) * 2;
        if (co < p.cout) store_pair(row, co, p.cout, acc[mi][j][h * 2], acc[mi][j][h * 2 + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// tap3 on wgmma fed by TMA (C % 8 == 0): a tile is a 4x8x8 output box (256
// voxels) x 128 output channels. Its x extent of 8 makes a (dz, dy) shift of
// the haloed rows a whole number of 8-row swizzle atoms, so the
// x-concatenated rows are three TMA loads of the box grown by 1 in z and y,
// at x0 - 1, x0 and x0 + 1 (the dx taps; zeros outside the tensor and past
// C), once a 32-channel chunk, 64-byte rows with the 64-byte swizzle,
// double-buffered; every (dz, dy, dx) reads them through the same A
// descriptor with its start moved, nothing restaged. The weight reaches a
// 4-stage ring one (chunk, dz, dy, dx) at a time, 32 rows x 128 columns
// (MN-major, 128-byte swizzle). One producer thread, two consumer
// warpgroups on two m64 (one output z plane each), persistent blocks; the
// epilogue rounds once and leaves through the spent chunk's buffer.
// ---------------------------------------------------------------------------
constexpr int T3W_BZ = 4, T3W_BY = 8, T3W_BX = 8;
constexpr int T3W_LINES = (T3W_BZ + 2) * (T3W_BY + 2);  // haloed x lines of 8 voxels
constexpr int T3W_CH = 32;                              // channels a chunk (64 bytes)
constexpr int T3W_XBOX = T3W_LINES * T3W_BX * 64;       // one dx load: 30720
constexpr int T3W_XSET = 3 * T3W_XBOX;                  // a chunk's three: 92160
constexpr int T3W_XBUFS = 2;
constexpr int T3W_N = 128;                              // output channels a tile
constexpr int T3W_WBOX = T3W_CH * 128;                  // 32 rows x 64 columns: 4096
constexpr int T3W_WSTAGE = 2 * T3W_WBOX;
constexpr int T3W_WSTAGES = 4;
constexpr int T3W_THREADS = 384;  // two consumer warpgroups, one producer warpgroup
constexpr int T3W_SMEM =
    1024 + T3W_XBUFS * T3W_XSET + T3W_WSTAGES * T3W_WSTAGE + 16 * (T3W_XBUFS + T3W_WSTAGES);
static_assert(T3W_SMEM <= SMEM_LIMIT, "the tap3 body's shared memory");
static_assert(T3W_XSET >= 2 * 2 * 64 * 256, "the epilogue's staging fits a chunk's buffer");

struct T3Params {
  __nv_bfloat16* out;
  int z, y, x, cout;
  int tz, ty, tx;  // boxes per axis
  int nblk;        // 128-column blocks
  int chunks;      // 32-channel chunks of C
  int tiles;       // N * tz * ty * tx * nblk
  int mode;        // hopper::MODE_*
};

__global__ void __launch_bounds__(T3W_THREADS, 1)
    tap3_tma_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w, const T3Params p) {
  using namespace mt::hopper;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t xbuf = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t wring = xbuf + T3W_XBUFS * T3W_XSET;
  const uint32_t bars = wring + T3W_WSTAGES * T3W_WSTAGE;
  auto xfull = [&](int b) { return bars + 8 * b; };
  auto xempty = [&](int b) { return bars + 8 * (T3W_XBUFS + b); };
  auto wfull = [&](int s) { return bars + 8 * (2 * T3W_XBUFS + s); };
  auto wempty = [&](int s) { return bars + 8 * (2 * T3W_XBUFS + T3W_WSTAGES + s); };
  if (threadIdx.x == 0) {
    for (int b = 0; b < T3W_XBUFS; ++b) {
      mbar_init(xfull(b), 1);
      mbar_init(xempty(b), 8);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < T3W_WSTAGES; ++s) {
      mbar_init(wfull(s), 1);
      mbar_init(wempty(s), 8);
    }
    mbar_init_fence();
  }
  __syncthreads();
  // tile t's output box corner and first column (column blocks innermost)
  auto corner = [&](int t, int& nb, int& z0, int& y0, int& x0, int& n0) {
    n0 = t % p.nblk * T3W_N;
    t /= p.nblk;
    x0 = t % p.tx * T3W_BX;
    t /= p.tx;
    y0 = t % p.ty * T3W_BY;
    t /= p.ty;
    z0 = t % p.tz * T3W_BZ;
    nb = t / p.tz;
  };

  if (threadIdx.x >= 256) {  // the producer warpgroup: its first thread loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 256) return;
    tma_prefetch(&map_x);
    tma_prefetch(&map_w);
    // the three x-shifted boxes of this block's j-th chunk, as soon as their
    // buffer is free: one chunk ahead of the weights
    auto load_x = [&](int j) {
      const int tile = blockIdx.x + j / p.chunks * gridDim.x;
      if (tile >= p.tiles) return;
      const int b = j % T3W_XBUFS;
      mbar_wait(xempty(b), ((j / T3W_XBUFS) & 1) ^ 1);
      if (p.mode == MODE_PRODUCTS) {
        mbar_arrive(xfull(b));
        return;
      }
      int nb, z0, y0, x0, n0;
      corner(tile, nb, z0, y0, x0, n0);
      mbar_expect_tx(xfull(b), T3W_XSET);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        tma_load_5d(xbuf + b * T3W_XSET + dx * T3W_XBOX, &map_x, xfull(b), j % p.chunks * T3W_CH,
                    x0 - 1 + dx, y0 - 1, z0 - 1, nb);
    };
    load_x(0);
    int j = 0, q = 0;  // chunks and weight stages issued
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int n0 = tile % p.nblk * T3W_N;
      for (int ch = 0; ch < p.chunks; ++ch, ++j) {
        load_x(j + 1);
        for (int tap = 0; tap < 27; ++tap, ++q) {
          const int s = q % T3W_WSTAGES;
          mbar_wait(wempty(s), ((q / T3W_WSTAGES) & 1) ^ 1);
          if (p.mode == MODE_PRODUCTS) {
            mbar_arrive(wfull(s));
            continue;
          }
          mbar_expect_tx(wfull(s), T3W_WSTAGE);
          // rows dx * 16 + c of (chunk16 2 ch and 2 ch + 1, dz * 3 + dy):
          // the chunk's 32 channels
#pragma unroll
          for (int h = 0; h < 2; ++h)
            tma_load_4d(wring + s * T3W_WSTAGE + h * T3W_WBOX, &map_w, wfull(s), n0 + h * 64,
                        tap % 3 * KC, tap / 3, 2 * ch);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns the box's z planes 2 wg and 2 wg + 1
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  float acc[2][64];
  int j = 0, q = 0;  // chunks and weight stages consumed
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
#pragma unroll
    for (int sub = 0; sub < 2; ++sub)
#pragma unroll
      for (int r = 0; r < 64; ++r) acc[sub][r] = 0.f;
    int b = 0;
    for (int ch = 0; ch < p.chunks; ++ch, ++j) {
      b = j % T3W_XBUFS;
      mbar_wait(xfull(b), (j / T3W_XBUFS) & 1);
      for (int tap = 0; tap < 27; ++tap, ++q) {
        const int s = q % T3W_WSTAGES;
        mbar_wait(wfull(s), (q / T3W_WSTAGES) & 1);
        if (p.mode == MODE_COPIES) {
          if (lane == 0) mbar_arrive(wempty(s));
          continue;
        }
        // output plane oz reads haloed line (oz + dz) * 10 + dy of the dx box:
        // 8 lines of 8 rows from there, 512 bytes a line
        const int dz = tap / 9, dy = tap / 3 % 3, dx = tap % 3;
        const uint32_t a = xbuf + b * T3W_XSET + dx * T3W_XBOX +
                           ((2 * wg + dz) * (T3W_BY + 2) + dy) * T3W_BX * 64;
        const uint32_t w = wring + s * T3W_WSTAGE;
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const uint64_t bd = b_desc(w, T3W_WBOX, k);
#pragma unroll
          for (int sub = 0; sub < 2; ++sub)
            mma_m64n128k16(acc[sub], a_desc64(a + sub * (T3W_BY + 2) * T3W_BX * 64, k), bd);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        if (tap > 0 && lane == 0) mbar_arrive(wempty((q - 1) % T3W_WSTAGES));
      }
      if (p.mode != MODE_COPIES) {
        wgmma_wait<0>();
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        if (lane == 0) mbar_arrive(wempty((q - 1) % T3W_WSTAGES));
      }
      // the last chunk's buffer stages the epilogue before it goes back
      if (ch + 1 < p.chunks && lane == 0) mbar_arrive(xempty(b));
    }
    int nb, z0, y0, x0, n0;
    corner(tile, nb, z0, y0, x0, n0);
    auto voxel = [&](int r) {
      const int gz = z0 + r / 64, gy = y0 + r / 8 % 8, gx = x0 + r % 8;
      if (gz >= p.z || gy >= p.y || gx >= p.x) return -1ll;
      return (((long long)nb * p.z + gz) * p.y + gy) * p.x + gx;
    };
    named_sync(1, 256);  // both warpgroups' products have read the buffer
    const uint32_t stage = xbuf + b * T3W_XSET + wg * 2 * 64 * 256;
#pragma unroll
    for (int sub = 0; sub < 2; ++sub)
      store_m64n128(acc[sub], stage + sub * 64 * 256, 2 + wg, p.out, p.cout, n0,
                    wg * 128 + sub * 64, voxel);
    named_sync(2 + wg, 128);  // this warpgroup's reads of the stage are done
    if (lane == 0) mbar_arrive(xempty(b));
  }
}

// ---------------------------------------------------------------------------
// wino: a block owns 2x4x4 output tiles of 2x2x2 voxels (a 4x8x8 output box,
// its 6x10x10 input box) and 128 output channels. Per slab of up to 128 input
// channels it stages the input box once; then for each of the 64 positions
// (a, b, c) it builds V[tile, ci] = (B^T x B^T x B^T) d[tile] on the CUDA
// cores (fp32, rounded to bf16 once), runs M = V U[(a,b,c)] on the tensor
// cores (the next position's U streams in meanwhile) and adds M into the 8
// output phases with A^T's coefficients, all in registers.
// ---------------------------------------------------------------------------
constexpr int W_T = 32;                    // tiles per block (2 x 4 x 4)
constexpr int W_BZ = 4, W_BY = 8, W_BX = 8;  // output box
constexpr int W_IY = W_BY + 2, W_IX = W_BX + 2;
constexpr int W_K = 128;  // input channels per slab
constexpr int W_CS = W_K + 8;
constexpr int W_N = 128;  // output channels per block
constexpr int W_BNP = W_N + 8;
constexpr int W_SMEM = ((W_BZ + 2) * W_IY * W_IX * W_CS + W_T * W_CS + W_K * W_BNP) * 2;
static_assert(W_SMEM <= SMEM_LIMIT, "wino's shared memory");

// B^T's two nonzeros in row a: columns (i0, i1) with signs (s0, s1)
__device__ __forceinline__ void bt_row(int a, int& i0, float& s0, int& i1, float& s1) {
  i0 = a == 0 ? 0 : 1;
  i1 = a == 3 ? 3 : 2;
  s0 = a == 2 ? -1.f : 1.f;
  s1 = (a == 0 || a == 3) ? -1.f : 1.f;
}

// A^T = [[1, 1, 1, 0], [0, 1, -1, -1]]
__device__ __forceinline__ float at_coef(int q, int a) {
  if (q == 0) return a == 3 ? 0.f : 1.f;
  return a == 0 ? 0.f : (a == 1 ? 1.f : -1.f);
}

__global__ void __launch_bounds__(THREADS, 1) wino_kernel(ArmParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* inbox = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vsm = inbox + (W_BZ + 2) * W_IY * W_IX * W_CS;
  __nv_bfloat16* usm = vsm + W_T * W_CS;
  const int bx_n = cdiv(p.x_, W_BX), by_n = cdiv(p.y, W_BY), bz_n = cdiv(p.z, W_BZ);
  int t = blockIdx.x;
  const int x0 = (t % bx_n) * W_BX;
  t /= bx_n;
  const int y0 = (t % by_n) * W_BY;
  t /= by_n;
  const int z0 = (t % bz_n) * W_BZ;
  const int nb = t / bz_n;
  const int n0 = blockIdx.y * W_N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 2, wn = warp / 2;  // 16 tiles x 32 columns per warp
  const Box obox{W_BZ, W_BY, W_BX};

  float out[8][4][4];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[q][j][e] = 0.f;

  const __nv_bfloat16* arow = vsm + (wm * 16 + lane % 16) * W_CS + (lane / 16) * 8;
  const int brow = (lane % 16) * W_BNP + wn * 32 + (lane / 16) * 8;
#pragma unroll 1
  for (int c0 = 0; c0 < p.cp; c0 += W_K) {
    const int width = min(W_K, p.cp - c0);
    auto load_u = [&](int pos) {
      const int per_row = W_N / 8;
      for (int i = threadIdx.x; i < width * per_row; i += THREADS) {
        const int row = i / per_row, col = (i - row * per_row) * 8;
        cp_async16(usm + row * W_BNP + col,
                   p.w + ((int64_t)pos * p.cp + c0 + row) * p.coutp + n0 + col, true);
      }
    };
    __syncthreads();  // the previous slab is consumed
    load_box<THREADS>(inbox, p.x, p.c, c0, width, W_CS, 1, obox, p.z, p.y, p.x_, nb, z0, y0,
                      x0);
    load_u(0);
    cp_async_wait_all();
    __syncthreads();
#pragma unroll 1
    for (int pos = 0; pos < 64; ++pos) {
      const int a = pos / 16, b = (pos / 4) % 4, c = pos % 4;
      int iz[2], iy[2], ix[2];
      float sz[2], sy[2], sx[2];
      bt_row(a, iz[0], sz[0], iz[1], sz[1]);
      bt_row(b, iy[0], sy[0], iy[1], sy[1]);
      bt_row(c, ix[0], sx[0], ix[1], sx[1]);
      // V[tile, channel pair], 8 signed terms each
      const int pairs = width / 2;
      for (int i = threadIdx.x; i < W_T * pairs; i += THREADS) {
        const int tile = i / pairs, ch = (i - tile * pairs) * 2;
        const int tz = tile / 16, ty = (tile / 4) % 4, tx = tile % 4;
        float2 v = make_float2(0.f, 0.f);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int vv = 0; vv < 2; ++vv)
#pragma unroll
            for (int w = 0; w < 2; ++w) {
              const float s = sz[u] * sy[vv] * sx[w];
              const int row = ((2 * tz + iz[u]) * W_IY + 2 * ty + iy[vv]) * W_IX + 2 * tx + ix[w];
              const float2 d = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(inbox + row * W_CS + ch));
              v.x += s * d.x;
              v.y += s * d.y;
            }
        *reinterpret_cast<__nv_bfloat162*>(vsm + tile * W_CS + ch) = __floats2bfloat162_rn(v.x, v.y);
      }
      cp_async_wait_all();  // U[pos]
      __syncthreads();
      float m[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) m[j][e] = 0.f;
#pragma unroll 1
      for (int ks = 0; ks < width / KC; ++ks) {
        uint32_t af[4];
        ldmatrix_x4(af, arow + ks * KC);
        const __nv_bfloat16* bt = usm + ks * KC * W_BNP + brow;
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, bt + j * 8);
          mma_16816(m[j], af, bf[0], bf[1]);
          mma_16816(m[j + 1], af, bf[2], bf[3]);
        }
      }
      __syncthreads();  // V and U[pos] consumed
      if (pos + 1 < 64) load_u(pos + 1);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float coef = at_coef(q / 4, a) * at_coef((q / 2) % 2, b) * at_coef(q % 2, c);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) out[q][j][e] += coef * m[j][e];
      }
    }
  }

  // accumulator element e of column tile j: tile row lane / 4 (+8 for e >= 2),
  // channel 2 * (lane % 4) + (e & 1)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int tile = wm * 16 + lane / 4 + h * 8;
    const int tz = tile / 16, ty = (tile / 4) % 4, tx = tile % 4;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int gz = z0 + 2 * tz + q / 4, gy = y0 + 2 * ty + (q / 2) % 2,
                gx = x0 + 2 * tx + q % 2;
      if (gz >= p.z || gy >= p.y || gx >= p.x_) continue;
      __nv_bfloat16* row = p.out + voxel(p, nb, gz, gy, gx) * p.cout;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = n0 + wn * 32 + j * 8 + (lane % 4) * 2;
        if (co < p.cout) store_pair(row, co, p.cout, out[q][j][h * 2], out[q][j][h * 2 + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// wino on wgmma fed by TMA (C % 8 == 0): a work item is 64 Winograd tiles (a
// 4x4x4 grid of 2x2x2 output tiles: an 8x8x8 output box, its 10x10x10 input
// box) x 64 output channels; the 8 output phases of its 64 x 64 outputs stay
// in the consumers' registers (128 KB) over every position and chunk.
//   - One TMA load of the haloed input box a 64-channel chunk (zeros outside
//     the tensor and past C: the SAME halo, no mask), 128-byte rows.
//   - Two transform warpgroups build V[pos] = (B^T x B^T x B^T) d of the 64
//     tiles, four positions (a, b, 0-3) from one pass over the box: a thread
//     takes 4 channels of a row of 4 tiles, half a row at a time, B^T along
//     z and y into the half's 6 x values, then along x; fp32 adds, each V
//     rounded to bf16 once, into a ring of two 4-position groups of K-major
//     128-byte-swizzled buffers (wgmma's A operand).
//   - Each consumer warpgroup streams its 32 columns of U[pos, chunk] (64
//     rows, 64-byte swizzle) through its own 4-stage TMA ring. A^T along x
//     runs on the tensor cores: for positions (a, b, 0-3), wgmma m64n32k16
//     accumulates t0 = M0 + M1 + M2 and t1 = M1 - M2 - M3 (B scaled by -1),
//     M_c = V_c U_c; A^T along y and z then adds t0 and t1 into the phases
//     on the CUDA cores. The group is a compile-time index of an unrolled
//     loop, so are every ring slot, barrier parity and coefficient.
//   - Persistent blocks; the epilogue rounds each output once.
// ---------------------------------------------------------------------------
constexpr int WT_IN = 10;                                // input box edge
constexpr int WT_CH = 64;                                // channels a chunk
constexpr int WT_N = 64;                                 // output channels a work item
constexpr int WT_BOX = WT_IN * WT_IN * WT_IN * 128;      // 128000
constexpr int WT_V = 64 * 128;                           // one position's V: 8192
constexpr int WT_GROUP = 4 * WT_V;                       // positions (a, b, 0-3)
constexpr int WT_VGROUPS = 2;
constexpr int WT_U = WT_CH * 64;                         // 64 rows x 32 columns: 4096
constexpr int WT_USTAGES = 4;                            // one stage a position of a group
constexpr int WT_THREADS = 512;  // two consumer warpgroups, two transform warpgroups
constexpr int WT_TRANSFORM = 256;
constexpr int WT_BARS = 1 + 2 * WT_VGROUPS + 2 * WT_USTAGES;
constexpr int WT_SMEM =
    1024 + WT_VGROUPS * WT_GROUP + 2 * WT_USTAGES * WT_U + WT_BOX + 8 * WT_BARS;
static_assert(WT_SMEM <= SMEM_LIMIT, "the Winograd body's shared memory");
// every chunk starts each ring's cycle afresh: slots, groups and barrier
// parities follow from the position alone
static_assert(16 % (2 * WT_VGROUPS) == 0, "the V ring's cycle");

struct WtParams {
  __nv_bfloat16* out;
  int z, y, x, cout;
  int gz, gy, gx;  // 8x8x8 output boxes per axis
  int nblk;        // 64-column blocks
  int chunks;      // 64-channel chunks of C
  int items;       // N * gz * gy * gx * nblk
  int mode;        // hopper::MODE_*
};

// V of positions (a, b, 0-3) for tiles (tz, ty, 2 h) and (tz, ty, 2 h + 1),
// channels 4 c4 to 4 c4 + 4, of the box into `group` (4 buffers of 64 rows of
// 128 bytes)
__device__ __forceinline__ void wino_transform(uint32_t box, uint32_t group, int a, int b, int tz,
                                               int ty, int h, int c4) {
  using namespace mt::hopper;
  int iz0, iz1, iy0, iy1;
  float sz0, sz1, sy0, sy1;
  bt_row(a, iz0, sz0, iz1, sz1);
  bt_row(b, iy0, sy0, iy1, sy1);
  const uint32_t half = (c4 & 1) * 8;  // the 4 channels' 8 bytes in their 16
  float r[6][4];  // B^T along z and y, the two tiles' 6 x values
#pragma unroll 1
  for (int l = 0; l < 4; ++l) {  // the (z, y) lines (iz0, iy0), (iz0, iy1), (iz1, iy0), (iz1, iy1)
    const float s = (l < 2 ? sz0 : sz1) * (l % 2 ? sy1 : sy0);
    const int row0 =
        ((2 * tz + (l < 2 ? iz0 : iz1)) * WT_IN + 2 * ty + (l % 2 ? iy1 : iy0)) * WT_IN + 4 * h;
#pragma unroll
    for (int x = 0; x < 6; ++x) {
      const int row = row0 + x;
      const uint2 w = ld_shared_v2(box + row * 128 + (((c4 / 2) ^ (row & 7)) << 4) + half);
      const float v[4] = {__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                          __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u)};
#pragma unroll
      for (int e = 0; e < 4; ++e) r[x][e] = fmaf(s, v[e], l == 0 ? 0.f : r[x][e]);
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {  // B^T along x
    int i0, i1;
    float s0, s1;
    bt_row(c, i0, s0, i1, s1);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(s0 * r[2 * t + i0][0] + s1 * r[2 * t + i1][0],
                                                      s0 * r[2 * t + i0][1] + s1 * r[2 * t + i1][1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(s0 * r[2 * t + i0][2] + s1 * r[2 * t + i1][2],
                                                      s0 * r[2 * t + i0][3] + s1 * r[2 * t + i1][3]);
      const int tile = (tz * 4 + ty) * 4 + 2 * h + t;
      st_shared_v2(group + c * WT_V + tile * 128 + (((c4 / 2) ^ (tile & 7)) << 4) + half,
                   make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                              *reinterpret_cast<const uint32_t*>(&hi)));
    }
  }
}

__global__ void __launch_bounds__(WT_THREADS, 1)
    wino_tma_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_u, const WtParams p) {
  using namespace mt::hopper;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t vring = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t uring = vring + WT_VGROUPS * WT_GROUP;
  const uint32_t box = uring + 2 * WT_USTAGES * WT_U;
  const uint32_t bars = box + WT_BOX;
  const uint32_t box_full = bars;
  auto vfull = [&](int g) { return bars + 8 * (1 + g); };
  auto vempty = [&](int g) { return bars + 8 * (1 + WT_VGROUPS + g); };
  auto ufull = [&](int wg, int s) {
    return bars + 8 * (1 + 2 * WT_VGROUPS + wg * WT_USTAGES + s);
  };
  if (threadIdx.x == 0) {
    mbar_init(box_full, 1);
    for (int g = 0; g < WT_VGROUPS; ++g) {
      mbar_init(vfull(g), WT_TRANSFORM);  // every transform thread
      mbar_init(vempty(g), 8);            // lane 0 of each consumer warp
    }
    for (int s = 0; s < 2 * WT_USTAGES; ++s) mbar_init(ufull(0, s), 1);
    mbar_init_fence();
  }
  __syncthreads();
  // work item i's output box corner and first column (column blocks
  // innermost: both blocks of a box run side by side and share its reads)
  auto item_of = [&](int i, int& nb, int& z0, int& y0, int& x0, int& n0) {
    n0 = i % p.nblk * WT_N;
    i /= p.nblk;
    x0 = i % p.gx * 8;
    i /= p.gx;
    y0 = i % p.gy * 8;
    i /= p.gy;
    z0 = i % p.gz * 8;
    nb = i / p.gz;
  };

  if (threadIdx.x >= 256) {  // the transform warpgroups; the first thread loads the boxes
    asm volatile("setmaxnreg.dec.sync.aligned.u32 64;\n" ::: "memory");
    const int t = threadIdx.x - 256;
    const int c4 = t % 16, ty = t / 16 % 4, tz = t / 64;
    const bool transform = p.mode == MODE_WHOLE || p.mode == MODE_TRANSFORM;
    if (t == 0) tma_prefetch(&map_x);
    int loads = 0;  // boxes loaded
    for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
      int nb, z0, y0, x0, n0;
      item_of(item, nb, z0, y0, x0, n0);
      for (int ch = 0; ch < p.chunks; ++ch) {
        named_sync(3, WT_TRANSFORM);  // every read of the previous chunk's box is done
        if (p.mode != MODE_PRODUCTS) {
          if (t == 0) {
            mbar_expect_tx(box_full, WT_BOX);
            tma_load_5d(box, &map_x, box_full, ch * WT_CH, x0 - 1, y0 - 1, z0 - 1, nb);
          }
          mbar_wait(box_full, loads & 1);
          ++loads;
        }
        // group ab takes V buffer group ab % 2, its (ab / 2)-th use this chunk
        for (int ab = 0; ab < 16; ++ab) {
          const int g = ab % WT_VGROUPS;
          mbar_wait(vempty(g), ((ab / WT_VGROUPS) & 1) ^ 1);
          if (transform) {
#pragma unroll 1
            for (int h = 0; h < 2; ++h)
              wino_transform(box, vring + g * WT_GROUP, ab / 4, ab % 4, tz, ty, h, c4);
          }
          fence_proxy_async();  // V, written here, is read by wgmma
          mbar_arrive(vfull(g));
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns columns n0 + 32 wg of the 64 tiles
  asm volatile("setmaxnreg.inc.sync.aligned.u32 192;\n" ::: "memory");
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32, warp = threadIdx.x / 32 % 4;
  const bool products = p.mode == MODE_WHOLE || p.mode == MODE_PRODUCTS;
  const bool u_loads = p.mode == MODE_WHOLE || p.mode == MODE_COPIES;
  const bool first = threadIdx.x % 128 == 0;
  const uint32_t ur = uring + wg * WT_USTAGES * WT_U;
  // descriptors of V buffer 0 and U stage 0; a buffer's or stage's adds its
  // offset / 16 (the address field's unit)
  const uint64_t vdesc = a_desc(vring, 0), udesc = b_desc_n32(ur, 0);
  // the unrolled loop below would keep every position's descriptors and
  // barrier addresses in registers beside the 160 of t0, t1 and the phases;
  // these bases, opaque to the compiler at each use, keep it to one add each
  auto opaque = [](auto v) {
    asm volatile("" : "+l"(v));
    return v;
  };
  auto opaque32 = [](uint32_t v) {
    asm volatile("" : "+r"(v));
    return v;
  };
  // U[pos] of chunk `row` / 64 at columns `col` into stage pos % 4
  auto load_u = [&](int col, int row, int pos) {
    const int s = pos % WT_USTAGES;
    const uint32_t bar = opaque32(ufull(wg, 0)) + 8 * s;
    mbar_expect_tx(bar, WT_U);
    tma_load_3d(opaque32(ur) + s * WT_U, &map_u, bar, col, row, pos);
  };
  if (first && u_loads) {
    tma_prefetch(&map_u);
    for (int pos = 0; pos < WT_USTAGES; ++pos) load_u(blockIdx.x % p.nblk * WT_N + wg * 32, 0, pos);
  }
  float acc[8][16];  // phase (qz * 2 + qy) * 2 + qx
  float t0[16], t1[16];
  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
#pragma unroll
    for (int ph = 0; ph < 8; ++ph)
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[ph][r] = 0.f;
    const int col = item % p.nblk * WT_N + wg * 32;
    for (int ch = 0; ch < p.chunks; ++ch) {
      // where the U stages freed by this chunk's last group go: the next chunk
      // of this item, else the next item's first (none past the last)
      const bool next_item = ch + 1 == p.chunks;
      const int next = item + gridDim.x;
      const bool more = !next_item || next < p.items;
      const int ncol = next_item ? next % p.nblk * WT_N + wg * 32 : col;
      const int nrow = next_item ? 0 : (ch + 1) * WT_CH;
#pragma unroll
      for (int ab = 0; ab < 16; ++ab) {
        const int g = ab % WT_VGROUPS;
        mbar_wait(opaque32(vfull(0)) + 8 * g, (ab / WT_VGROUPS) & 1);
#pragma unroll
        for (int c = 0; c < 4; ++c) {  // position 4 ab + c in U stage c
          if (u_loads) mbar_wait(opaque32(ufull(wg, 0)) + 8 * c, ab & 1);
          if (products) {
            const uint64_t a = opaque(vdesc) + ((g * WT_GROUP + c * WT_V) >> 4);
            const uint64_t b = opaque(udesc) + ((c * WT_U) >> 4);
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (c <= 2) mma_m64n32k16<1>(t0, a + 2 * k, b + 64 * k, c > 0 || k > 0);
              if (c == 1) mma_m64n32k16<1>(t1, a + 2 * k, b + 64 * k, k > 0);
              if (c >= 2) mma_m64n32k16<-1>(t1, a + 2 * k, b + 64 * k, true);
            }
            wgmma_commit();
          }
          // U stage c - 1 is read once position c - 1's products are done in
          // every warp: it takes the next group's position c - 1
          if (c > 0) {
            if (products) {
              wgmma_wait<1>();
              fence_acc(t0);
              fence_acc(t1);
            }
            if (u_loads) {
              named_sync(1 + wg, 128);
              if (first) {
                if (ab < 15) {
                  load_u(col, ch * WT_CH, 4 * (ab + 1) + c - 1);
                } else if (more) {
                  load_u(ncol, nrow, c - 1);
                }
              }
            }
          }
        }
        if (products) {
          wgmma_wait<0>();
          fence_acc(t0);
          fence_acc(t1);
        }
        if (lane == 0) mbar_arrive(opaque32(vempty(0)) + 8 * g);  // V group read
        if (u_loads) {
          named_sync(1 + wg, 128);
          if (first) {
            if (ab < 15) {
              load_u(col, ch * WT_CH, 4 * (ab + 1) + 3);
            } else if (more) {
              load_u(ncol, nrow, 3);
            }
          }
        }
        if (products) {  // A^T along y and z: phase (qz, qy, qx) += At[qz][a] At[qy][b] t_qx
          const int a = ab / 4, b = ab % 4;
#pragma unroll
          for (int ph = 0; ph < 8; ++ph) {
            const float coef = at_coef(ph / 4, a) * at_coef(ph / 2 % 2, b);
            if (coef != 0.f) {
#pragma unroll
              for (int r = 0; r < 16; ++r)
                acc[ph][r] = fmaf(coef, ph % 2 ? t1[r] : t0[r], acc[ph][r]);
            }
          }
        }
      }
    }
    // accumulator r: tile warp * 16 + lane / 4 (+8 for r % 4 >= 2), column
    // (r / 4) * 8 + 2 * (lane % 4) + r % 2 of this warpgroup's 32
    int nb, z0, y0, x0, n0;
    item_of(item, nb, z0, y0, x0, n0);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int tile = warp * 16 + lane / 4 + 8 * hh;
      const int tz = tile / 16, ty = tile / 4 % 4, tx = tile % 4;
#pragma unroll
      for (int ph = 0; ph < 8; ++ph) {
        const int gz = z0 + 2 * tz + ph / 4, gy = y0 + 2 * ty + ph / 2 % 2,
                  gx = x0 + 2 * tx + ph % 2;
        if (gz >= p.z || gy >= p.y || gx >= p.x) continue;
        __nv_bfloat16* row = p.out + ((((int64_t)nb * p.z + gz) * p.y + gy) * p.x + gx) * p.cout;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int co = n0 + wg * 32 + j * 8 + 2 * (lane % 4);
          if (co < p.cout)
            store_pair(row, co, p.cout, acc[ph][j * 4 + hh * 2], acc[ph][j * 4 + hh * 2 + 1]);
        }
      }
    }
  }
}

ArmParams make_params(const void* x, const void* w, void* out, int n, int z, int y, int xd,
                      int c, int cout, int coutp) {
  ArmParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.n = n;
  p.z = z;
  p.y = y;
  p.x_ = xd;
  p.c = c;
  p.cp = cdiv(c, KC) * KC;
  p.cout = cout;
  p.coutp = coutp;
  return p;
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int smem, const ArmParams& p, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

// The im2col arm on its body: 1 the TMA + wgmma body (C % 8 == 0), 2 the
// first body; mode (the TMA body's forms) hopper::MODE_*.
cudaError_t im2col_run(const ArmParams& p, int body, int mode, cudaStream_t stream) {
  if (p.cp > 128 || p.coutp % I2C_N != 0 || p.cout > p.coutp || mode < hopper::MODE_WHOLE ||
      mode > hopper::MODE_PRODUCTS || (body != 2 && p.c % 8 != 0) ||
      (body == 2 && (mode != hopper::MODE_WHOLE || i2c_smem(p.cp) > SMEM_LIMIT)) ||
      body < 1 || body > 2)
    return cudaErrorInvalidValue;
  if (body == 2) {
    const long long blocks = (long long)p.n * p.z * p.y * cdiv(p.x_, I2C_M);
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    return launch(im2col_kernel, dim3((unsigned)blocks, p.coutp / I2C_N), i2c_smem(p.cp), p,
                  stream);
  }
  ItParams q{};
  q.out = p.out;
  q.vox = (long long)p.n * p.z * p.y * p.x_;
  const long long tiles_m = (q.vox + IT_M - 1) / IT_M;
  if (tiles_m * (p.coutp / IT_N) > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  q.z = p.z;
  q.y = p.y;
  q.x = p.x_;
  q.cp = p.cp;
  q.cout = p.cout;
  q.chunks = cdiv(p.cp, IT_CH);
  q.tiles_m = (int)tiles_m;
  q.tiles = q.tiles_m * (p.coutp / IT_N);
  q.mode = mode;
  CUtensorMap mx, mw;
  const cuuint64_t wdims[2] = {(cuuint64_t)p.coutp, (cuuint64_t)27 * p.cp};
  const cuuint32_t wbox[2] = {64, IT_CH};
  if (!hopper::im2col_map(&mx, p.x, p.n, p.z, p.y, p.x_, p.c, IT_CH, IT_COL) ||
      !hopper::tiled_map(&mw, p.w, 2, wdims, wbox))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(im2col_tma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, IT_SMEM);
  if (err != cudaSuccess) return err;
  const int grid = q.tiles < sm_count() ? q.tiles : sm_count();
  im2col_tma_kernel<<<grid, IT_THREADS, IT_SMEM, stream>>>(mx, mw, q);
  return cudaGetLastError();
}

// The tap3 arm on its body: 1 the TMA + wgmma body (C % 8 == 0), 2 the first
// body (bn 32 or 64: the prepared weight's column block); mode (the TMA
// body's forms) hopper::MODE_WHOLE to MODE_PRODUCTS.
cudaError_t tap3_run(const ArmParams& p, int bn, int body, int mode, cudaStream_t stream) {
  if ((bn != 32 && bn != 64) || p.coutp % bn != 0 || p.cout > p.coutp || body < 1 || body > 2 ||
      mode < hopper::MODE_WHOLE || mode > hopper::MODE_PRODUCTS ||
      (body == 1 && p.c % 8 != 0) || (body == 2 && mode != hopper::MODE_WHOLE))
    return cudaErrorInvalidValue;
  if (body == 2) {
    Tiles tl;
    const long long per_sample = pick_box(p.z, p.y, p.x_, &tl.box);
    tl.tz = cdiv(p.z, tl.box.z);
    tl.ty = cdiv(p.y, tl.box.y);
    tl.tx = cdiv(p.x_, tl.box.x);
    const long long blocks = per_sample * p.n;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)blocks, p.coutp / bn);
    cudaError_t err = cudaFuncSetAttribute(
        bn == 32 ? tap3_kernel<32> : tap3_kernel<64>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bn == 32 ? t3_smem<32>() : t3_smem<64>());
    if (err != cudaSuccess) return err;
    if (bn == 32) {
      tap3_kernel<32><<<grid, THREADS, t3_smem<32>(), stream>>>(p, tl);
    } else {
      tap3_kernel<64><<<grid, THREADS, t3_smem<64>(), stream>>>(p, tl);
    }
    return cudaGetLastError();
  }
  T3Params q{};
  q.out = p.out;
  q.z = p.z;
  q.y = p.y;
  q.x = p.x_;
  q.cout = p.cout;
  q.tz = cdiv(p.z, T3W_BZ);
  q.ty = cdiv(p.y, T3W_BY);
  q.tx = cdiv(p.x_, T3W_BX);
  q.nblk = cdiv(p.coutp, T3W_N);
  q.chunks = cdiv(p.c, T3W_CH);
  const long long tiles = (long long)p.n * q.tz * q.ty * q.tx * q.nblk;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  q.tiles = (int)tiles;
  q.mode = mode;
  CUtensorMap mx, mw;
  const cuuint64_t xdims[5] = {(cuuint64_t)p.c, (cuuint64_t)p.x_, (cuuint64_t)p.y,
                               (cuuint64_t)p.z, (cuuint64_t)p.n};
  const cuuint32_t xbox[5] = {T3W_CH, T3W_BX, T3W_BY + 2, T3W_BZ + 2, 1};
  // the prepared weight (C_P / 16, 9, 48, CoutP): rows dx * 16 + c of two
  // 16-channel chunks a box
  const cuuint64_t wdims[4] = {(cuuint64_t)p.coutp, 3 * KC, 9, (cuuint64_t)(p.cp / KC)};
  const cuuint32_t wbox[4] = {64, KC, 1, 2};
  if (!hopper::tiled_map(&mx, p.x, 5, xdims, xbox, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !hopper::tiled_map(&mw, p.w, 4, wdims, wbox))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tap3_tma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T3W_SMEM);
  if (err != cudaSuccess) return err;
  const int grid = q.tiles < sm_count() ? q.tiles : sm_count();
  tap3_tma_kernel<<<grid, T3W_THREADS, T3W_SMEM, stream>>>(mx, mw, q);
  return cudaGetLastError();
}

// The Winograd arm on its body: 1 the TMA + wgmma body (C % 8 == 0), 2 the
// first body; mode (the TMA body's forms) hopper::MODE_*.
cudaError_t wino_run(const ArmParams& p, int body, int mode, cudaStream_t stream) {
  if (p.z % 2 || p.y % 2 || p.x_ % 2 || p.coutp % W_N != 0 || p.cout > p.coutp || body < 1 ||
      body > 2 || mode < hopper::MODE_WHOLE || mode > hopper::MODE_TRANSFORM ||
      (body == 1 && p.c % 8 != 0) || (body == 2 && mode != hopper::MODE_WHOLE))
    return cudaErrorInvalidValue;
  if (body == 2) {
    const long long blocks =
        (long long)p.n * cdiv(p.z, W_BZ) * cdiv(p.y, W_BY) * cdiv(p.x_, W_BX);
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    return launch(wino_kernel, dim3((unsigned)blocks, p.coutp / W_N), W_SMEM, p, stream);
  }
  WtParams q{};
  q.out = p.out;
  q.z = p.z;
  q.y = p.y;
  q.x = p.x_;
  q.cout = p.cout;
  q.gz = cdiv(p.z / 2, 4);
  q.gy = cdiv(p.y / 2, 4);
  q.gx = cdiv(p.x_ / 2, 4);
  q.nblk = p.coutp / WT_N;
  q.chunks = cdiv(p.cp, WT_CH);
  const long long items = (long long)p.n * q.gz * q.gy * q.gx * q.nblk;
  if (items > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  q.items = (int)items;
  q.mode = mode;
  CUtensorMap mx, mu;
  const cuuint64_t xdims[5] = {(cuuint64_t)p.c, (cuuint64_t)p.x_, (cuuint64_t)p.y,
                               (cuuint64_t)p.z, (cuuint64_t)p.n};
  const cuuint32_t xbox[5] = {WT_CH, WT_IN, WT_IN, WT_IN, 1};
  // U (64, C_P, CoutP): rows past C_P come back 0
  const cuuint64_t udims[3] = {(cuuint64_t)p.coutp, (cuuint64_t)p.cp, 64};
  const cuuint32_t ubox[3] = {32, WT_CH, 1};
  if (!hopper::tiled_map(&mx, p.x, 5, xdims, xbox) ||
      !hopper::tiled_map(&mu, p.w, 3, udims, ubox, CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(wino_tma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, WT_SMEM);
  if (err != cudaSuccess) return err;
  const int grid = q.items < sm_count() ? q.items : sm_count();
  wino_tma_kernel<<<grid, WT_THREADS, WT_SMEM, stream>>>(mx, mu, q);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// im2col arm: C <= 128, coutp a multiple of 128; the TMA + wgmma body where
// C % 8 == 0 (16-byte pixel strides), else the first body
// (probes/conv_impl_arms.py:im2col_plan makes the same choice). Returns
// cudaGetLastError() after the launch (0 on success).
int mt_conv_im2col(const void* x, const void* w, void* out, int n, int z, int y, int xd, int c,
                   int cout, int coutp, void* stream) {
  const ArmParams p = make_params(x, w, out, n, z, y, xd, c, cout, coutp);
  return (int)im2col_run(p, c % 8 == 0 ? 1 : 2, hopper::MODE_WHOLE,
                         static_cast<cudaStream_t>(stream));
}

// The im2col arm on a chosen body (1 TMA + wgmma, 2 the first body) and, on
// the TMA body, its form (0 whole, 1 copies only, 2 products only), for the
// probes' comparisons.
int mt_conv_im2col_form(const void* x, const void* w, void* out, int n, int z, int y, int xd,
                        int c, int cout, int coutp, int body, int mode, void* stream) {
  const ArmParams p = make_params(x, w, out, n, z, y, xd, c, cout, coutp);
  return (int)im2col_run(p, body, mode, static_cast<cudaStream_t>(stream));
}

// tap3 arm: bn 32 or 64 (the prepared weight's column block), coutp a
// multiple of bn; the TMA + wgmma body where C % 8 == 0, else the first
// body (probes/conv_impl_arms.py:tap3_plan makes the same choice).
int mt_conv_tap3(const void* x, const void* w, void* out, int n, int z, int y, int xd, int c,
                 int cout, int coutp, int bn, void* stream) {
  const ArmParams p = make_params(x, w, out, n, z, y, xd, c, cout, coutp);
  return (int)tap3_run(p, bn, c % 8 == 0 ? 1 : 2, hopper::MODE_WHOLE,
                       static_cast<cudaStream_t>(stream));
}

// The tap3 arm on a chosen body (1 TMA + wgmma, 2 the first body) and, on
// the TMA body, its form (0 whole, 1 copies only, 2 products only).
int mt_conv_tap3_form(const void* x, const void* w, void* out, int n, int z, int y, int xd,
                      int c, int cout, int coutp, int bn, int body, int mode, void* stream) {
  const ArmParams p = make_params(x, w, out, n, z, y, xd, c, cout, coutp);
  return (int)tap3_run(p, bn, body, mode, static_cast<cudaStream_t>(stream));
}

// Winograd arm: Z, Y, X even, coutp a multiple of 128; the TMA + wgmma body
// where C % 8 == 0, else the first body (probes/conv_impl_arms.py:wino_plan).
int mt_conv_wino(const void* x, const void* w, void* out, int n, int z, int y, int xd, int c,
                 int cout, int coutp, void* stream) {
  const ArmParams p = make_params(x, w, out, n, z, y, xd, c, cout, coutp);
  return (int)wino_run(p, c % 8 == 0 ? 1 : 2, hopper::MODE_WHOLE,
                       static_cast<cudaStream_t>(stream));
}

// The Winograd arm on a chosen body (1 TMA + wgmma, 2 the first body) and,
// on the TMA body, its form (0 whole, 1 copies only, 2 products only, 3 the
// box loads and the transform only).
int mt_conv_wino_form(const void* x, const void* w, void* out, int n, int z, int y, int xd,
                      int c, int cout, int coutp, int body, int mode, void* stream) {
  const ArmParams p = make_params(x, w, out, n, z, y, xd, c, cout, coutp);
  return (int)wino_run(p, body, mode, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
