// The cost and grid probes' kernels: the center-view conv and a zero fill,
// each over tiles of a channels-last volume whose size is a parameter.
//
// centern replaces the Pallas TPU kernels scripts/conv_cost_isolate.py:48
// centern_kernel (pallas_call at :92) and scripts/grid_overhead_probe.py:68
// conv_kernel (pallas_call at :123), which compute the same function:
//     out = sum over t < ndots of  x @ w[t % 3, (t / 3) % 3, t % 3]
// with x the voxels of the volume (the TPU kernels read the center view of a
// padded copy, :82 and :105), w (3, 3, 3, C, Cout), fp32 accumulation, bf16
// out. It measures what `ndots` GEMMs on one operand cost, apart from the
// per-tap slicing of a real conv, so the kernel issues the ndots GEMMs as
// they are and never folds the weights into one matrix. A block owns one
// tile (bz, by, bx) of the volume from start to finish, as a TPU grid step
// does (the tile is what the grid probe varies); blocks are persistent over
// the tiles where tiles outnumber the SMs, and where tiles are fewer the
// idle SMs are the measurement ((8, 48, 96) is 24 tiles).
//
// zeros replaces scripts/grid_overhead_probe.py:49 zeros_kernel (pallas_call
// at :54): out = 0, written tile by tile, one block per tile, by contiguous
// runs with no division a store: (a) 16-byte streaming stores (what every
// call runs) or (b) bulk stores by the TMA unit from zeroed shared memory
// (the probes' comparison, `mt_zeros_form`).
//
// What bounds them on an H100. centern: its bytes. The function is
// x @ (sum of the ndots weight matrices), one GEMM of 2 * C * Cout
// operations per voxel (0.029 TFLOP at 96^3 x 128, 0.029 ms at 989 TFLOP/s),
// under its 0.45 GB of x and out (0.135 ms at 3.35 TB/s). The probe's
// question is what the ndots GEMMs cost as issued: 2 * ndots * C * Cout per
// voxel, 0.79 ms at the peak rate with 27 dots and 0.35 ms with 12, a ceiling
// of this kernel's form, not the function's bound. As issued, the ndots
// weight matrices (32 KB each at C = 128) pass from L2 to shared memory once
// for every sub-tile of voxels: the first body (mma.sync fed by ldmatrix)
// took 128-voxel sub-tiles through two cp.async stages with a barrier after
// every dot, 6.1 GB at 27 dots, and reached 31% of the ceiling. This body:
//   - a sub-tile of up to 256 voxels is one 5-D TMA box (64 channels, sx,
//     sy, sz, 1) that never crosses its tile (sx, sy, sz divide the tile;
//     the fewest m64 products, then the fewest boxes), two boxes for C =
//     128, in the 128-byte swizzle (wgmma's K-major A layout); two A
//     buffers, so the next sub-tile lands under the current one's dots;
//   - the weights, (27, C, 128) as prepared, through a 2-D TMA map (boxes of
//     64 columns x C rows, the 128-byte swizzle: wgmma's MN-major B), a ring
//     of 3 dot stages running on across sub-tiles and tiles: 3.1 GB at 27
//     dots (1.4 GB at 12);
//   - wgmma m64n128k16: one producer thread issues every load, two consumer
//     warpgroups own 128 rows each; their fp32 accumulators persist over
//     the ndots dots (setmaxnreg gives them the registers), one commit group
//     a dot and wait_group<1>, so a dot's products run while the next dot's
//     weights land;
//   - the epilogue rounds to bf16 once into the spent A buffer, in the
//     box's own layout (stmatrix), and one thread stores the sub-tile's box
//     by TMA while the next sub-tile's dots run; the buffer goes back to
//     the producer after the next sub-tile's first dot. Where Cout % 8 != 0
//     (no 16-byte rows for a tensor map) the rows leave thread by thread
//     through the same buffer (hopper.cuh store_m64n128).
// zeros: the bytes written, 226 MB at 96^3 x 128 bf16, 0.068 ms. A large
// tile means few blocks, and fewer blocks than the 132 SMs leave SMs idle (a
// (96, 96, 96) tile is a grid of one block, which the probe measures as it
// is): there one SM's path to L2 is the limit, about 64 GB/s on the H100
// whichever form writes (36 GB/s a block with 72 blocks writing); so no
// store may wait on index arithmetic (a 64-bit division a store held one
// block to 9.8 GB/s).
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace mt;

// ---------------------------------------------------------------------------
// centern
// ---------------------------------------------------------------------------
constexpr int CT_M = 256;                       // voxels of a sub-tile at most
constexpr int CT_CH = 64;                       // channels of a box (128 bytes)
constexpr int CT_A_CHUNK = CT_M * 128;          // one box: 32768
constexpr int CT_A_BYTES = 2 * CT_A_CHUNK;      // C <= 128
constexpr int CT_A_BUFS = 2;
constexpr int CT_W_BOX = 128 * 128;             // C <= 128 rows of 64 columns
constexpr int CT_W_STAGE = 2 * CT_W_BOX;        // one dot's (C, 128) matrix
constexpr int CT_W_STAGES = 3;
constexpr int CT_THREADS = 384;  // two consumer warpgroups, one producer warpgroup
constexpr int CT_SMEM = 1024 + CT_A_BUFS * CT_A_BYTES + CT_W_STAGES * CT_W_STAGE +
                        16 * (CT_A_BUFS + CT_W_STAGES);
static_assert(CT_SMEM <= 232448, "centern's shared memory");

// A tile's sub-tiles: boxes (sx, sy, sz) of rows = sx * sy * sz <= 256
// voxels, ns* of them along each axis.
struct SubTiles {
  int sz, sy, sx, nsz, nsy, nsx, rows;
};

// The box that takes the fewest m64 products over the tile, then the fewest
// boxes; of equals the first with the longest x, then y (larger first).
// probes/conv_cost_isolate.py:centern_plan makes the same choice.
SubTiles sub_tiles(int bz, int by, int bx) {
  SubTiles best{1, 1, 1, bz, by, bx, 1};
  long long best_m64 = -1, best_boxes = -1;
  for (int sx = bx < CT_M ? bx : CT_M; sx >= 1; --sx) {
    if (bx % sx) continue;
    for (int sy = by < CT_M ? by : CT_M; sy >= 1; --sy) {
      if (by % sy || sx * sy > CT_M) continue;
      for (int sz = bz < CT_M ? bz : CT_M; sz >= 1; --sz) {
        if (bz % sz || sx * sy * sz > CT_M) continue;
        const long long boxes = (long long)(bx / sx) * (by / sy) * (bz / sz);
        const long long m64 = boxes * cdiv(sx * sy * sz, 64);
        if (best_m64 < 0 || m64 < best_m64 || (m64 == best_m64 && boxes < best_boxes)) {
          best = {sz, sy, sx, bz / sz, by / sy, bx / sx, sx * sy * sz};
          best_m64 = m64;
          best_boxes = boxes;
        }
      }
    }
  }
  return best;
}

struct CenterParams {
  __nv_bfloat16* out;
  int z, y, x_, c, cout, ndots;
  int bz, by, bx;  // the tile
  int tz, ty, tx;  // tiles per axis
  int tiles;       // N * tz * ty * tx
  SubTiles s;
  int tma_store;  // Cout % 8 == 0: the output leaves by TMA stores of a sub-tile's box
  int mode;       // hopper::MODE_*
};

__global__ void __launch_bounds__(CT_THREADS, 1)
    centern_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w,
                   const __grid_constant__ CUtensorMap map_out, const CenterParams p) {
  using namespace mt::hopper;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t abuf = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t wring = abuf + CT_A_BUFS * CT_A_BYTES;
  const uint32_t bars = wring + CT_W_STAGES * CT_W_STAGE;
  auto full_a = [&](int b) { return bars + 8 * b; };
  auto empty_a = [&](int b) { return bars + 8 * (CT_A_BUFS + b); };
  auto full_w = [&](int s) { return bars + 8 * (2 * CT_A_BUFS + s); };
  auto empty_w = [&](int s) { return bars + 8 * (2 * CT_A_BUFS + CT_W_STAGES + s); };
  const SubTiles st = p.s;
  const int nsub = st.nsz * st.nsy * st.nsx;
  if (threadIdx.x == 0) {
    for (int b = 0; b < CT_A_BUFS; ++b) {
      mbar_init(full_a(b), 1);
      mbar_init(empty_a(b), 1);  // consumer thread 0, once the output has left it
    }
    for (int s = 0; s < CT_W_STAGES; ++s) {
      mbar_init(full_w(s), 1);
      mbar_init(empty_w(s), 8);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  // the corner (nb, z0, y0, x0) of sub-tile i of tile `tile`
  auto corner = [&](int tile, int i, int& nb, int& z0, int& y0, int& x0) {
    x0 = tile % p.tx * p.bx + i % st.nsx * st.sx;
    tile /= p.tx;
    y0 = tile % p.ty * p.by + i / st.nsx % st.nsy * st.sy;
    tile /= p.ty;
    z0 = tile % p.tz * p.bz + i / (st.nsx * st.nsy) * st.sz;
    nb = tile / p.tz;
  };

  if (threadIdx.x >= 256) {  // the producer warpgroup: its first thread loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 256) return;
    tma_prefetch(&map_x);
    tma_prefetch(&map_w);
    const int chunks = cdiv(p.c, CT_CH);
    int u = 0, q = 0;  // sub-tiles and dot stages issued
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      for (int i = 0; i < nsub; ++i, ++u) {
        const int ab = u % CT_A_BUFS;
        mbar_wait(empty_a(ab), ((u / CT_A_BUFS) & 1) ^ 1);
        if (p.mode == MODE_PRODUCTS) {
          mbar_arrive(full_a(ab));
        } else {
          int nb, z0, y0, x0;
          corner(tile, i, nb, z0, y0, x0);
          mbar_expect_tx(full_a(ab), chunks * st.rows * 128);
          for (int ch = 0; ch < chunks; ++ch)
            tma_load_5d(abuf + ab * CT_A_BYTES + ch * CT_A_CHUNK, &map_x, full_a(ab),
                        ch * CT_CH, x0, y0, z0, nb);
        }
        for (int d = 0; d < p.ndots; ++d, ++q) {
          const int s = q % CT_W_STAGES;
          mbar_wait(empty_w(s), ((q / CT_W_STAGES) & 1) ^ 1);
          if (p.mode == MODE_PRODUCTS) {
            mbar_arrive(full_w(s));
            continue;
          }
          const int tap = (d % 3) * 9 + (d / 3 % 3) * 3 + d % 3;
          mbar_expect_tx(full_w(s), 2 * p.c * 128);
#pragma unroll
          for (int b = 0; b < 2; ++b)
            tma_load_2d(wring + s * CT_W_STAGE + b * CT_W_BOX, &map_w, full_w(s), b * 64,
                        tap * p.c);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns the sub-tile's m64 rows 2 wg and 2 wg + 1
  // (products of rows past the box are computed, never stored: a product
  // skipped under a condition the compiler cannot see as uniform would
  // serialise every wgmma)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int ksteps = p.c / KC;
  float acc[2][64];
  int u = 0, q = 0;  // sub-tiles and dot stages consumed
  int pending = -1;  // the A buffer whose output thread 0's TMA stores still read
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    for (int i = 0; i < nsub; ++i, ++u) {
      const int ab = u % CT_A_BUFS;
      const uint32_t a = abuf + ab * CT_A_BYTES + 2 * wg * 64 * 128;
      mbar_wait(full_a(ab), (u / CT_A_BUFS) & 1);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int r = 0; r < 64; ++r) acc[m][r] = 0.f;
      for (int d = 0; d < p.ndots; ++d, ++q) {
        const int s = q % CT_W_STAGES;
        mbar_wait(full_w(s), (q / CT_W_STAGES) & 1);
        if (p.mode != MODE_COPIES) {
          const uint32_t w = wring + s * CT_W_STAGE;
          fence_acc(acc[0]);
          fence_acc(acc[1]);
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            if (k >= ksteps) break;
            const uint64_t bd = b_desc(w, CT_W_BOX, k);
            const uint32_t ak = a + k / 4 * CT_A_CHUNK;
            mma_m64n128k16(acc[0], a_desc(ak, k % 4), bd);
            mma_m64n128k16(acc[1], a_desc(ak + 64 * 128, k % 4), bd);
          }
          wgmma_commit();
          wgmma_wait<1>();
          fence_acc(acc[0]);
          fence_acc(acc[1]);
        }
        // the previous sub-tile's A buffer goes back to the producer once its
        // output has left it, which the first dot's products give time for
        if (d == 0 && pending >= 0) {
          if (threadIdx.x == 0) {
            tma_store_wait<true>();
            mbar_arrive(empty_a(pending));
          }
          pending = -1;
        }
        if (lane == 0 && (p.mode == MODE_COPIES || d > 0))
          mbar_arrive(empty_w((p.mode == MODE_COPIES ? q : q - 1) % CT_W_STAGES));
      }
      wgmma_wait<0>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      if (lane == 0 && p.mode != MODE_COPIES) mbar_arrive(empty_w((q - 1) % CT_W_STAGES));
      // the output goes through the A buffer, whose products are done: this
      // warpgroup's rows of it are its own
      int nb, z0, y0, x0;
      corner(tile, i, nb, z0, y0, x0);
      if (p.tma_store) {  // in the box's layout; thread 0 stores the box
        stage_m64n128(acc[0], abuf + ab * CT_A_BYTES, CT_A_CHUNK, 2 * wg * 64);
        stage_m64n128(acc[1], abuf + ab * CT_A_BYTES, CT_A_CHUNK, (2 * wg + 1) * 64);
        fence_proxy_async();
        named_sync(1, 256);  // both warpgroups' rows are staged
        if (threadIdx.x == 0) {
          for (int h = 0; h * 64 < p.cout; ++h)
            tma_store_5d(&map_out, abuf + ab * CT_A_BYTES + h * CT_A_CHUNK, h * 64, x0, y0, z0,
                         nb);
          tma_store_commit();
        }
        pending = ab;
      } else {  // row by row, Cout past 8-channel rows
        auto voxel = [&](int r) {
          if (r >= st.rows) return -1ll;
          const int lz = r / (st.sx * st.sy), ly = r / st.sx % st.sy, lx = r % st.sx;
          return (((long long)nb * p.z + z0 + lz) * p.y + y0 + ly) * p.x_ + x0 + lx;
        };
        store_m64n128(acc[0], a, 2 + wg, p.out, p.cout, 0, 2 * wg * 64, voxel);
        store_m64n128(acc[1], a + CT_A_CHUNK, 2 + wg, p.out, p.cout, 0, (2 * wg + 1) * 64,
                      voxel);
        named_sync(1, 256);
        if (threadIdx.x == 0) mbar_arrive(empty_a(ab));
      }
    }
  }
  if (threadIdx.x == 0 && pending >= 0) tma_store_wait<false>();
}

cudaError_t centern_run(const void* x, const void* w, void* out, int n, int z, int y, int xd,
                        int c, int cout, int ndots, int bz, int by, int bx, int mode,
                        cudaStream_t stream) {
  if (c % KC != 0 || c > 128 || cout > 128 || ndots < 1 || bz < 1 || by < 1 || bx < 1 ||
      z % bz || y % by || xd % bx || mode < hopper::MODE_WHOLE || mode > hopper::MODE_PRODUCTS)
    return cudaErrorInvalidValue;
  CenterParams p{};
  p.out = static_cast<__nv_bfloat16*>(out);
  p.z = z;
  p.y = y;
  p.x_ = xd;
  p.c = c;
  p.cout = cout;
  p.ndots = ndots;
  p.bz = bz;
  p.by = by;
  p.bx = bx;
  p.tz = z / bz;
  p.ty = y / by;
  p.tx = xd / bx;
  const long long tiles = (long long)n * p.tz * p.ty * p.tx;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  p.tiles = (int)tiles;
  p.s = sub_tiles(bz, by, bx);
  p.tma_store = cout % 8 == 0;
  p.mode = mode;
  CUtensorMap mx, mw, mo;
  const cuuint64_t xdims[5] = {(cuuint64_t)c, (cuuint64_t)xd, (cuuint64_t)y, (cuuint64_t)z,
                               (cuuint64_t)n};
  const cuuint32_t xbox[5] = {CT_CH, (cuuint32_t)p.s.sx, (cuuint32_t)p.s.sy,
                              (cuuint32_t)p.s.sz, 1};
  const cuuint64_t wdims[2] = {128, (cuuint64_t)27 * c};
  const cuuint32_t wbox[2] = {64, (cuuint32_t)c};
  const cuuint64_t odims[5] = {(cuuint64_t)cout, (cuuint64_t)xd, (cuuint64_t)y, (cuuint64_t)z,
                               (cuuint64_t)n};
  if (!hopper::tiled_map(&mx, x, 5, xdims, xbox) || !hopper::tiled_map(&mw, w, 2, wdims, wbox) ||
      (p.tma_store && !hopper::tiled_map(&mo, out, 5, odims, xbox)))
    return cudaErrorInvalidValue;
  if (!p.tma_store) mo = mx;
  cudaError_t err = cudaFuncSetAttribute(centern_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, CT_SMEM);
  if (err != cudaSuccess) return err;
  const int grid = p.tiles < sm_count() ? p.tiles : sm_count();
  centern_kernel<<<grid, CT_THREADS, CT_SMEM, stream>>>(mx, mw, mo, p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// zeros
// ---------------------------------------------------------------------------
constexpr int ZV_THREADS = 1024;             // form (a)'s block
constexpr int ZV_UNROLL = 8;                 // its 16-byte stores in flight a lane
constexpr int ZV_PIECE = 32 * ZV_UNROLL;     // 16-byte units a warp stores at once
constexpr int ZB_THREADS = 256;              // form (b)'s block
constexpr int ZB_BYTES = 32768;              // its zero buffer: the largest bulk store

// A tile's contiguous runs, in 16-byte units (8 channels): an x-row of the
// tile; where the tile spans X, the rows of a z plane of it; where it spans
// Y as well, the whole tile. Runs a z plane, units from one row and from one
// z plane of the volume to the next, and the tile grid (x fastest).
struct ZeroRuns {
  int tiles_x, tiles_y;
  int bz, by, bx, cu;  // the tile, and units a voxel
  int runs, per_plane;
  long long run, row, plane;
};

ZeroRuns zero_runs(int y, int xd, int c, int bz, int by, int bx) {
  const long long row = (long long)xd * (c / 8), plane = y * row;
  ZeroRuns r{xd / bx, y / by, bz, by, bx, c / 8, bz * by, by, (long long)bx * (c / 8), row, plane};
  if (bx == xd) r.runs = bz, r.per_plane = 1, r.run = by * row;  // rows of a plane merge
  if (bx == xd && by == y) r.runs = 1, r.run = bz * plane;       // and the planes
  return r;
}

// the unit where tile t starts
__device__ __forceinline__ int64_t tile_start(const ZeroRuns& r, int t) {
  const int tx = t % r.tiles_x, ty = (t / r.tiles_x) % r.tiles_y, tz = t / r.tiles_x / r.tiles_y;
  return (int64_t)tz * r.bz * r.plane + (int64_t)ty * r.by * r.row + (int64_t)tx * r.bx * r.cu;
}

// the unit where run k of the tile at `tile` starts: one division a run,
// none a store
__device__ __forceinline__ int64_t run_start(const ZeroRuns& r, int64_t tile, int k) {
  const int kz = k / r.per_plane;
  return tile + kz * r.plane + (k - kz * r.per_plane) * r.row;
}

// Form (a): 16-byte streaming stores. A warp takes a piece of a run,
// ZV_PIECE units, and each lane issues its ZV_UNROLL stores at once.
__global__ void __launch_bounds__(ZV_THREADS) zeros_vec_kernel(uint4* out, ZeroRuns r) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int per_run = (int)((r.run + ZV_PIECE - 1) / ZV_PIECE);
  const int pieces = per_run * r.runs;
  const int64_t tile = tile_start(r, blockIdx.x);
  for (int q = warp; q < pieces; q += ZV_THREADS / 32) {
    const int k = q / per_run;
    const int64_t u = (int64_t)(q - k * per_run) * ZV_PIECE + lane;
    uint4* p = out + run_start(r, tile, k) + u;
    const int64_t left = r.run - u;
#pragma unroll
    for (int i = 0; i < ZV_UNROLL; ++i) {
      if (i * 32 < left)
        asm volatile("st.global.cs.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"l"(p + i * 32), "r"(0)
                     : "memory");
    }
  }
}

// Form (b): bulk stores from shared memory. The block zeroes ZB_BYTES of
// shared memory once; one thread streams every run from it in pieces of at
// most ZB_BYTES, a bulk group a piece, all in flight at once (the buffer is
// never written again), and waits for them before it exits.
__global__ void __launch_bounds__(ZB_THREADS) zeros_bulk_kernel(char* out, ZeroRuns r) {
  __shared__ __align__(128) uint4 zero[ZB_BYTES / 16];
  for (int i = threadIdx.x; i < ZB_BYTES / 16; i += ZB_THREADS) zero[i] = make_uint4(0, 0, 0, 0);
  hopper::fence_proxy_async();
  __syncthreads();
  if (threadIdx.x != 0) return;
  const uint32_t src = smem_addr(zero);
  const int64_t tile = tile_start(r, blockIdx.x);
  for (int k = 0; k < r.runs; ++k) {
    char* dst = out + run_start(r, tile, k) * 16;
    for (int64_t left = r.run * 16; left > 0; left -= ZB_BYTES, dst += ZB_BYTES) {
      hopper::bulk_store(dst, src, left < ZB_BYTES ? (uint32_t)left : ZB_BYTES);
      hopper::tma_store_commit();
    }
  }
  hopper::tma_store_wait<false>();
}

// form 1 (a) or 2 (b) at one block a tile
cudaError_t zeros_run(void* out, int z, int y, int xd, int c, int bz, int by, int bx, int form,
                      cudaStream_t stream) {
  if (c % 8 != 0 || bz < 1 || by < 1 || bx < 1 || z % bz || y % by || xd % bx || form < 1 ||
      form > 2 || reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  const long long blocks = (long long)(z / bz) * (y / by) * (xd / bx);
  const ZeroRuns r = zero_runs(y, xd, c, bz, by, bx);
  const long long pieces = (long long)r.runs * ((r.run + ZV_PIECE - 1) / ZV_PIECE);
  if (blocks > 0x7fffffffLL || pieces > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  if (form == 1) {
    zeros_vec_kernel<<<(unsigned)blocks, ZV_THREADS, 0, stream>>>(static_cast<uint4*>(out), r);
  } else {
    zeros_bulk_kernel<<<(unsigned)blocks, ZB_THREADS, 0, stream>>>(static_cast<char*>(out), r);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, z, y, x, c) bf16 with c % 16 == 0 and c <= 128; w (27, c, 128) bf16;
// out (n, z, y, x, cout), cout <= 128; the tile (bz, by, bx) divides the
// volume. Returns cudaGetLastError() after the launch (0 on success).
int mt_centern(const void* x, const void* w, void* out, int n, int z, int y, int xd, int c,
               int cout, int ndots, int bz, int by, int bx, void* stream) {
  return (int)centern_run(x, w, out, n, z, y, xd, c, cout, ndots, bz, by, bx,
                          hopper::MODE_WHOLE, static_cast<cudaStream_t>(stream));
}

// The same in `mode` (0 whole, 1 copies only, 2 products only), for the
// probes' comparisons.
int mt_centern_form(const void* x, const void* w, void* out, int n, int z, int y, int xd, int c,
                    int cout, int ndots, int bz, int by, int bx, int mode, void* stream) {
  return (int)centern_run(x, w, out, n, z, y, xd, c, cout, ndots, bz, by, bx, mode,
                          static_cast<cudaStream_t>(stream));
}

// out (z, y, x, c) bf16 = 0, c % 8 == 0, out 16-byte aligned, one block per
// tile (bz, by, bx), which divides the volume: form (a), as fast as (b) or
// faster at each of the grid probe's tiles on the H100 (PERF.md, section 6).
int mt_zeros(void* out, int z, int y, int xd, int c, int bz, int by, int bx, void* stream) {
  return (int)zeros_run(out, z, y, xd, c, bz, by, bx, 1, static_cast<cudaStream_t>(stream));
}

// The same in `form` (1 vector stores, 2 bulk stores), for the probes'
// comparisons.
int mt_zeros_form(void* out, int z, int y, int xd, int c, int bz, int by, int bx, int form,
                  void* stream) {
  return (int)zeros_run(out, z, y, xd, c, bz, by, bx, form, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
