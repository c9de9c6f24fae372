// Building blocks shared by the kernels (conv3d_same.cu, conv3d_wgrad.cu,
// fused_norm.cu, seghead.cu): cp.async copies with zero-fill, ldmatrix
// fragment loads, the bf16 mma.sync tile product, the 256-voxel box shapes the
// conv kernels tile volumes with, the normalize prologue's rounding, and the
// channel-statistics launchers kernel D borrows from kernel E.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace mt {

constexpr int KC = 16;          // channels per K chunk (the mma K)
constexpr int HS = KC + 8;      // halo row stride in bf16: 48 B, conflict-free
constexpr int BM = 256;         // voxels per box
constexpr int HALO_MAX = 720;   // largest (bz+2)(by+2)(bx+2) of the boxes below

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
    const __nv_bfloat16* s = inside ? src + off : src;
    if (vec == 8) {
      cp_async16(d, s, inside);
    } else if (vec == 2) {
      cp_async4(d, s, inside);
    } else {
      d[0] = inside ? *s : __float2bfloat16(0.f);
    }
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

// Host launchers of fused_norm.cu that kernel D (conv3d_same.cu) shares.
//
// out (n, width) = the sum over rows of part (n, rows, width), fp32, in an
// order fixed by the sizes alone (deterministic, no atomics). Rows beyond 256
// are summed in two passes through `ws`; reduce_rows_workspace gives its
// bytes (-1: more rows than the two passes take).
long long reduce_rows_workspace(int n, int rows, int width);
cudaError_t reduce_rows(const float* part, float* out, float* ws, int n, int rows,
                        int width, cudaStream_t stream);
// Bytes of workspace channel_stats needs (-1: sizes it does not take).
long long channel_stats_workspace(int n, long long s, int c);
// stats (n, 2, c) fp32: per-sample channel sum and sum of squares of the
// bf16 x (n, s, c); deterministic (per-block partials, fixed-order adds).
cudaError_t channel_stats(const __nv_bfloat16* x, float* stats, float* ws,
                          long long ws_bytes, int n, long long s, int c,
                          cudaStream_t stream);

}  // namespace mt
