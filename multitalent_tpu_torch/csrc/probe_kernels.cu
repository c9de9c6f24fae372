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
// per-tap slicing of a real conv. A block owns one tile (bz, by, bx) of the
// volume, as a TPU grid step does; it walks the tile in sub-tiles of 128
// voxels, stages each sub-tile's [128, C] rows once and streams the ndots
// [C, Cout] weight matrices through two shared-memory stages, accumulating
// on the tensor cores (mma.sync m16n8k16).
//
// zeros replaces scripts/grid_overhead_probe.py:49 zeros_kernel (pallas_call
// at :54): out = 0, written tile by tile, one block per tile, 16-byte stores.
//
// What bounds them on an H100. centern: its bytes. The function is
// x @ (sum of the ndots weight matrices), one GEMM of 2 * C * Cout
// operations per voxel (0.029 TFLOP at 96^3 x 128, 0.029 ms at 989 TFLOP/s),
// under its 0.45 GB of x and out (0.135 ms at 3.35 TB/s). The probe's
// question is what the ndots GEMMs cost as issued: 2 * ndots * C * Cout per
// voxel, 0.79 ms at the peak rate with 27 dots and 0.35 ms with 12, a ceiling
// of this kernel's form, not the function's bound. zeros: the bytes written,
// 226 MB at 96^3 x 128 bf16, 0.068 ms. A tile is what the
// probes vary: large tiles mean few blocks, and fewer blocks than the 132
// SMs leave SMs idle (a (96, 96, 96) tile is a grid of one block, which the
// probe measures as it is).
#include "common.cuh"

namespace {

using namespace mt;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int CN_M = 128;  // voxels per sub-tile
constexpr int CN_N = 128;  // output channels of a block (CoutP)
constexpr int CN_S = 136;  // shared-memory row stride: ldmatrix conflict-free
constexpr int CN_SMEM = (CN_M + 2 * 128) * CN_S * 2;

struct CenterParams {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;  // (27, C, 128)
  __nv_bfloat16* out;
  int z, y, x_, c, cout;
  int bz, by, bx;  // the tile
  int tz, ty, tx;  // tiles per axis
  int ndots;
};

__global__ void __launch_bounds__(THREADS, 2) centern_kernel(CenterParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* a = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* bs = a + CN_M * CN_S;  // two stages of (C, CN_S)
  int t = blockIdx.x;
  const int x0 = (t % p.tx) * p.bx;
  t /= p.tx;
  const int y0 = (t % p.ty) * p.by;
  t /= p.ty;
  const int z0 = (t % p.tz) * p.bz;
  const int nb = t / p.tz;
  const int tile_vox = p.bz * p.by * p.bx;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 4, wn = warp / 4;  // 32 rows x 64 columns per warp

  auto voxel = [&](int m) {
    const int vz = m / (p.by * p.bx), vy = (m / p.bx) % p.by, vx = m % p.bx;
    return (((int64_t)nb * p.z + z0 + vz) * p.y + y0 + vy) * p.x_ + x0 + vx;
  };
  auto load_b = [&](int d, int stage) {
    const int tap = (d % 3) * 9 + ((d / 3) % 3) * 3 + d % 3;
    const __nv_bfloat16* src = p.w + (int64_t)tap * p.c * CN_N;
    for (int i = threadIdx.x; i < p.c * (CN_N / 8); i += THREADS) {
      const int row = i / (CN_N / 8), col = (i % (CN_N / 8)) * 8;
      cp_async16(bs + (stage * 128 + row) * CN_S + col, src + row * CN_N + col, true);
    }
  };
  int a_row[2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) a_row[mi] = (wm * 32 + mi * 16 + lane % 16) * CN_S + (lane / 16) * 8;
  const int b_row = (lane % 16) * CN_S + wn * 64 + (lane / 16) * 8;
  const int per_row = p.c / 8;

#pragma unroll 1
  for (int s0 = 0; s0 < tile_vox; s0 += CN_M) {
    __syncthreads();  // the previous sub-tile is consumed
    for (int i = threadIdx.x; i < CN_M * per_row; i += THREADS) {
      const int r = i / per_row, ch = (i - r * per_row) * 8;
      const bool valid = s0 + r < tile_vox;
      cp_async16(a + r * CN_S + ch, valid ? p.x + voxel(s0 + r) * p.c + ch : p.x, valid);
    }
    load_b(0, 0);
    cp_async_wait_all();
    __syncthreads();
    float acc[2][8][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
#pragma unroll 1
    for (int d = 0; d < p.ndots; ++d) {
      const int stage = d & 1;
      if (d + 1 < p.ndots) load_b(d + 1, stage ^ 1);
      const __nv_bfloat16* bt = bs + stage * 128 * CN_S + b_row;
#pragma unroll 1
      for (int ks = 0; ks < p.c / KC; ++ks) {
        uint32_t af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) ldmatrix_x4(af[mi], a + a_row[mi] + ks * KC);
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, bt + ks * KC * CN_S + j * 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_16816(acc[mi][j], af[mi], b[0], b[1]);
            mma_16816(acc[mi][j + 1], af[mi], b[2], b[3]);
          }
        }
      }
      cp_async_wait_all();
      __syncthreads();  // stage ^ 1 has landed, stage is consumed
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = s0 + wm * 32 + mi * 16 + lane / 4 + h * 8;
        if (m >= tile_vox) continue;
        __nv_bfloat16* row = p.out + voxel(m) * p.cout;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int co = wn * 64 + j * 8 + (lane % 4) * 2;
          if (co < p.cout) store_pair(row, co, p.cout, acc[mi][j][h * 2], acc[mi][j][h * 2 + 1]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS) zeros_kernel(__nv_bfloat16* out, int y, int xd,
                                                        int c, int bz, int by, int bx, int ty,
                                                        int tx) {
  int t = blockIdx.x;
  const int x0 = (t % tx) * bx;
  t /= tx;
  const int y0 = (t % ty) * by;
  const int z0 = (t / ty) * bz;
  const int per_vox = c / 8;
  const int64_t total = (int64_t)bz * by * bx * per_vox;
  for (int64_t i = threadIdx.x; i < total; i += THREADS) {
    const int64_t v = i / per_vox;
    const int ch = (int)(i - v * per_vox) * 8;
    const int vx = (int)(v % bx), vy = (int)((v / bx) % by), vz = (int)(v / ((int64_t)bx * by));
    const int64_t off = (((int64_t)(z0 + vz) * y + y0 + vy) * xd + x0 + vx) * c + ch;
    *reinterpret_cast<uint4*>(out + off) = make_uint4(0u, 0u, 0u, 0u);
  }
}

}  // namespace

extern "C" {

// x (n, z, y, x, c) bf16 with c % 16 == 0 and c <= 128; w (27, c, 128) bf16;
// out (n, z, y, x, cout), cout <= 128; the tile (bz, by, bx) divides the
// volume. Returns cudaGetLastError() after the launch (0 on success).
int mt_centern(const void* x, const void* w, void* out, int n, int z, int y, int xd, int c,
               int cout, int ndots, int bz, int by, int bx, void* stream) {
  if (c % KC != 0 || c > 128 || cout > CN_N || ndots < 1 || bz < 1 || by < 1 || bx < 1 ||
      z % bz || y % by || xd % bx)
    return (int)cudaErrorInvalidValue;
  CenterParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.z = z;
  p.y = y;
  p.x_ = xd;
  p.c = c;
  p.cout = cout;
  p.bz = bz;
  p.by = by;
  p.bx = bx;
  p.tz = z / bz;
  p.ty = y / by;
  p.tx = xd / bx;
  p.ndots = ndots;
  const long long blocks = (long long)n * p.tz * p.ty * p.tx;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(centern_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, CN_SMEM);
  if (err != cudaSuccess) return (int)err;
  centern_kernel<<<(unsigned)blocks, THREADS, CN_SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// out (z, y, x, c) bf16 = 0, c % 8 == 0, one block per tile (bz, by, bx),
// which divides the volume.
int mt_zeros(void* out, int z, int y, int xd, int c, int bz, int by, int bx, void* stream) {
  if (c % 8 != 0 || bz < 1 || by < 1 || bx < 1 || z % bz || y % by || xd % bx)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)(z / bz) * (y / by) * (xd / bx);
  zeros_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<__nv_bfloat16*>(out), y, xd, c, bz, by, bx, y / by, xd / bx);
  return (int)cudaGetLastError();
}

}  // extern "C"
