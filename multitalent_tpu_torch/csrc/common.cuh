// Building blocks shared by the kernels (conv3d_same.cu, conv3d_wgmma.cu,
// conv3d_wgrad.cu, fused_norm.cu, seghead.cu and the probes' conv_arms.cu,
// probe_kernels.cu):
// cp.async copies with zero-fill and their commit groups, ldmatrix
// fragment loads, the bf16 mma.sync tile product, the line loader of
// kernels A and C (load_lines), the 256-voxel box shapes the conv kernels
// tile volumes with, the normalize prologue's rounding, the row reduce
// kernel D borrows from kernel E, the split-K reduces (one of them with
// kernel D's stats), and the wgmma body's plan and launcher that
// conv3d_same.cu routes kernels A, B and D's dual form to.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace mt {

constexpr int KC = 16;          // channels per K chunk (the mma K)
constexpr int BM = 256;         // voxels per box

struct Box {
  int z, y, x;
};
// 256-voxel boxes, smallest halo first (ties in wasted voxels keep the first)
constexpr Box kBoxes[] = {{4, 8, 8},  {8, 4, 8},  {8, 8, 4},  {4, 4, 16},
                          {4, 16, 4}, {16, 4, 4}, {2, 8, 16}, {2, 16, 8}};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// The box that wastes the fewest voxels at the volume's edges; returns the
// number of boxes per sample.
inline long long pick_box(int z, int y, int x, Box* out) {
  long long best = -1;
  for (const Box& b : kBoxes) {
    const long long n = (long long)cdiv(z, b.z) * cdiv(y, b.y) * cdiv(x, b.x);
    if (best < 0 || n < best) {
      best = n;
      *out = b;
    }
  }
  return best;
}

inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return sms;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 4 bytes; `full` false copies nothing and zero-fills dst
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0));
}
// cp.async of 8 bytes; `full` false copies nothing and zero-fills dst
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 8 : 0));
}
// One copy of `vec` elements (8, 4, 2 or 1) to shared memory, zeros where
// `full` is false: cp.async of 16, 8 or 4 bytes, or one element loaded.
__device__ __forceinline__ void cp_async_vec(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                             bool full, int vec) {
  if (vec == 8) {
    cp_async16(dst, src, full);
  } else if (vec == 4) {
    cp_async8(dst, src, full);
  } else if (vec == 2) {
    cp_async4(dst, src, full);
  } else {
    dst[0] = full ? *src : __float2bfloat16(0.f);
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage `width` channels [c0, c0 + width) of the box at (nb, z0, y0, x0) of a
// channels-last (N, Z, Y, X, C) bf16 tensor into shared memory, one row of
// `stride` elements per voxel of the box grown by `halo` on each side. Zero
// outside the volume and past channel C. 16-byte copies when C % 8 == 0,
// 4-byte when C is even, else one element at a time.
template <int THREADS>
__device__ __forceinline__ void load_box(__nv_bfloat16* dst,
                                         const __nv_bfloat16* __restrict__ src, int c,
                                         int c0, int width, int stride, int halo,
                                         Box box, int n_z, int n_y, int n_x, int nb,
                                         int z0, int y0, int x0) {
  const int vec = (c % 8 == 0) ? 8 : ((c % 2 == 0) ? 2 : 1);
  const int hx = box.x + 2 * halo, hy = box.y + 2 * halo, hz = box.z + 2 * halo;
  const int per_vox = width / vec;
  const int total = hz * hy * hx * per_vox;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int v = i / per_vox;
    const int ch = (i - v * per_vox) * vec;
    const int vx = v % hx;
    const int vy = (v / hx) % hy;
    const int vz = v / (hx * hy);
    const int gz = z0 + vz - halo, gy = y0 + vy - halo, gx = x0 + vx - halo;
    const bool inside = gz >= 0 && gz < n_z && gy >= 0 && gy < n_y && gx >= 0 &&
                        gx < n_x && c0 + ch < c;
    __nv_bfloat16* d = dst + v * stride + ch;
    const int64_t off =
        ((((int64_t)nb * n_z + gz) * n_y + gy) * n_x + gx) * c + c0 + ch;
    cp_async_vec(d, inside ? src + off : src, inside, vec);
  }
}

// elements a copy of C-channel rows: 16, 8 or 4 bytes, or one at a time
__host__ __device__ constexpr int vec_of(int c) {
  return c % 8 == 0 ? 8 : (c % 4 == 0 ? 4 : (c % 2 == 0 ? 2 : 1));
}

// How a warp's lanes share the copies of one operand's voxel rows: a row
// (the channels one block stages for one voxel) is `units` copies of `vec`
// elements; each voxel takes `per_vox` lanes (units, at most 32), a copy
// instruction covers `vpi` = 32 / per_vox voxels, and a lane keeps its
// voxel offset `j` and first unit `u` for every line (lanes past vpi
// voxels idle).
struct LaneMap {
  int units, vec, per_vox, vpi, j, u;
};

__device__ __forceinline__ LaneMap lane_map(int width, int vec, int lane) {
  LaneMap m;
  m.units = width / vec;
  m.vec = vec;
  m.per_vox = min(m.units, 32);
  m.vpi = 32 / m.per_vox;
  m.j = lane / m.per_vox;
  m.u = lane - m.j * m.per_vox;
  return m;
}

// Stage channels [c0, c0 + m.units * m.vec) of `lines` (z, y) lines of
// `len` voxels at (z0, y0, x0) (the corner may lie outside; `by` lines a z
// plane) of sample nb of a channels-last (N, Z, Y, X, C) tensor into dst,
// one row of `stride` elements per voxel in (z, y, x) order; zero where the
// voxel is outside the volume. Channels past the copied ones are left as
// they are: they only meet dw rows or columns that are not written. A line
// is one contiguous run of len voxels in memory: warps take lines, and a
// lane steps through its line by constant strides, with no division.
template <int NWARPS>
__device__ __forceinline__ void load_lines(__nv_bfloat16* dst, int stride,
                                           const __nv_bfloat16* __restrict__ src, int c,
                                           int c0, const LaneMap& m, int len, int lines,
                                           int by, int n_z, int n_y, int n_x, int nb, int z0,
                                           int y0, int x0, int warp) {
  if (m.j >= m.vpi) return;
  const int vlo = max(0, -x0), vhi = min(len, n_x - x0);  // voxels inside along x
  const int s_step = m.vpi * c, d_step = m.vpi * stride;
  for (int l = warp; l < lines; l += NWARPS) {
    const int vz = l / by, vy = l - vz * by;
    const int gz = z0 + vz, gy = y0 + vy;
    const bool line_in = gz >= 0 && gz < n_z && gy >= 0 && gy < n_y;
    const __nv_bfloat16* s_line =
        src + ((((int64_t)nb * n_z + gz) * n_y + gy) * n_x + x0) * c + c0;
    __nv_bfloat16* d_line = dst + l * len * stride;
    for (int u = m.u; u < m.units; u += m.per_vox) {
      int s_off = m.j * c + u * m.vec, d_off = m.j * stride + u * m.vec;
      for (int v = m.j; v < len; v += m.vpi, s_off += s_step, d_off += d_step) {
        const bool in = line_in && v >= vlo && v < vhi;
        cp_async_vec(d_line + d_off, in ? s_line + s_off : src, in, m.vec);
      }
    }
  }
}

// Channels co and co + 1 (co even, co < cout) of one bf16 output row, as a
// pair when cout is even (the row then starts 4-byte aligned).
__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int co, int cout, float v0,
                                           float v1) {
  if (cout % 2 == 0) {
    *reinterpret_cast<__nv_bfloat162*>(row + co) = __floats2bfloat162_rn(v0, v1);
  } else {
    row[co] = __float2bfloat16(v0);
    if (co + 1 < cout) row[co + 1] = __float2bfloat16(v1);
  }
}

// lrelu(bf16(v)): the normalize prologue's rounding order (cast, then the
// activation on the bf16 value, its product rounded to bf16 again), as
// multitalent_tpu/ops/pallas_conv.py:_affine_lrelu and
// multitalent_tpu/ops/packed_conv.py:normalize_from_stats
__device__ __forceinline__ __nv_bfloat16 cast_lrelu(float v, float slope) {
  const __nv_bfloat16 y = __float2bfloat16(v);
  const float f = __bfloat162float(y);
  return f >= 0.f ? y : __float2bfloat16(f * slope);
}

// out = bf16(bias + the sum over `splits` of the fp32 partials ws (splits,
// count)), added in a fixed order (conv3d_same.cu; kernels A, B, D and the
// wgmma body share it).
cudaError_t splitk_reduce(const float* ws, const float* bias, __nv_bfloat16* out,
                          long long count, int cout, int splits, cudaStream_t stream);
// The same out of ws (splits, n * s * cout), with kernel D's stats: blocks
// own runs of voxels of one sample across 64 columns, add the splits as
// splitk_reduce does, store bf16 and sum the stored values per column into
// part (n, rows, 2, cout), rows = splitk_stats_rows(n, s, cout) (at most
// 256: reduce_rows adds them in one pass, with no workspace).
int splitk_stats_rows(int n, long long s, int cout);
cudaError_t splitk_reduce_stats(const float* ws, const float* bias, __nv_bfloat16* out,
                                float* part, int n, long long s, int cout, int splits,
                                cudaStream_t stream);

// The wgmma body of kernels A and B (conv3d_wgmma.cu) for inputs whose C %
// 8 == 0: 4x8x8 output tiles, bn (64 or 128) output channels a block, the K
// loop over kchunks 16-channel chunks in `splits` parts of per_split.
struct HPlan {
  int bn, nblk;
  int tiles, tiles_z, tiles_y, tiles_x;  // tiles: N * the boxes of a sample
  int kchunks, splits, per_split;
  int smem;  // dynamic shared memory bytes of a block
};
// false for sizes the body does not take
bool h_plan(int n, int z, int y, int x, int ca, int cb, int cout, int coutp, int sms,
            HPlan* out);
long long h_workspace_bytes(const HPlan& plan, int n, int z, int y, int x, int cout);
// rows a sample of kernel D's stats partials on the body: a tile's each with
// one split, else splitk_stats_rows
int h_stats_rows(const HPlan& plan, int n, long long s, int cout);
// kernel A (b null, cb 0) or B on the wgmma body; with part (two inputs),
// kernel D's dual form, its stats rows (n, h_stats_rows, 2, cout) into part;
// mode 0 (1: copies only, 2: products only, the probes' forms)
cudaError_t h_run(const HPlan& plan, const void* a, const void* b, int ca, int cb, const void* w,
                  const void* bias, void* out, void* ws, long long ws_bytes, float* part, int n,
                  int z, int y, int x, int cout, int coutp, int mode, cudaStream_t stream);

// Host launchers of fused_norm.cu that kernel D (conv3d_same.cu) shares.
//
// out (n, width) = the sum over rows of part (n, rows, width), fp32, in an
// order fixed by the sizes alone (deterministic, no atomics). Rows beyond 256
// are summed in two passes through `ws`; reduce_rows_workspace gives its
// bytes (-1: more rows than the two passes take).
long long reduce_rows_workspace(int n, int rows, int width);
cudaError_t reduce_rows(const float* part, float* out, float* ws, int n, int rows,
                        int width, cudaStream_t stream);

}  // namespace mt
