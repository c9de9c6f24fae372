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
//   - tap3: kernel A's schedule with the three x taps of a 16-channel chunk
//     side by side in one row (an x-concatenated copy of the haloed box built
//     once per chunk), so each (dz, dy) is one GEMM with K = 48;
//   - wino: 8/27 of the direct conv's multiplies, but each block streams the
//     64 transformed weight matrices from L2 for its 32 tiles, builds each
//     transform-domain input on the CUDA cores (B^T, adds only, fp32, rounded
//     to bf16 once) and applies A^T with 8 FMAs per accumulator per position.
//     The weights are transformed on the host (G w G^T per axis in fp32,
//     rounded to bf16 once). Every spatial size must be even.
//
// Layouts (C_P: C rounded up to 16; the probes' wrappers prepare the weights):
//   x:   (N, Z, Y, X, C) bf16, contiguous; out: (N, Z, Y, X, Cout) bf16.
//   im2col weight: (27 * C_P, CoutP) bf16, row tap * C_P + c, CoutP a
//     multiple of 128, tap = (dz*3 + dy)*3 + dx.
//   tap3 weight: (C_P / 16, 9, 48, CoutP) bf16, [chunk, dz*3 + dy, dx*16 + c],
//     CoutP a multiple of BN (32 or 64).
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

// tap3 arm: bn 32 or 64, coutp a multiple of bn.
int mt_conv_tap3(const void* x, const void* w, void* out, int n, int z, int y, int xd, int c,
                 int cout, int coutp, int bn, void* stream) {
  const ArmParams p = make_params(x, w, out, n, z, y, xd, c, cout, coutp);
  if ((bn != 32 && bn != 64) || coutp % bn != 0 || cout > coutp)
    return (int)cudaErrorInvalidValue;
  Tiles tl;
  const long long per_sample = pick_box(z, y, xd, &tl.box);
  tl.tz = cdiv(z, tl.box.z);
  tl.ty = cdiv(y, tl.box.y);
  tl.tx = cdiv(xd, tl.box.x);
  const long long blocks = per_sample * n;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, coutp / bn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      bn == 32 ? tap3_kernel<32> : tap3_kernel<64>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bn == 32 ? t3_smem<32>() : t3_smem<64>());
  if (err != cudaSuccess) return (int)err;
  if (bn == 32) {
    tap3_kernel<32><<<grid, THREADS, t3_smem<32>(), s>>>(p, tl);
  } else {
    tap3_kernel<64><<<grid, THREADS, t3_smem<64>(), s>>>(p, tl);
  }
  return (int)cudaGetLastError();
}

// Winograd arm: Z, Y, X even, coutp a multiple of 128.
int mt_conv_wino(const void* x, const void* w, void* out, int n, int z, int y, int xd, int c,
                 int cout, int coutp, void* stream) {
  const ArmParams p = make_params(x, w, out, n, z, y, xd, c, cout, coutp);
  if (z % 2 || y % 2 || xd % 2 || coutp % W_N != 0 || cout > coutp)
    return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)n * cdiv(z, W_BZ) * cdiv(y, W_BY) * cdiv(xd, W_BX);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  return (int)launch(wino_kernel, dim3((unsigned)blocks, coutp / W_N), W_SMEM, p,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
