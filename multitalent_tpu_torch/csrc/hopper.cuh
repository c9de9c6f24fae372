// Hopper building blocks of the probes' TMA + wgmma bodies (conv_arms.cu's
// im2col, tap3 and Winograd bodies, probe_kernels.cu's centern): mbarriers,
// TMA loads (tiled and im2col mode) and bulk stores, the m64n128k16 and m64n32k16 bf16
// wgmma with their shared-memory descriptors (128- and 64-byte swizzles),
// and the CUDA driver's tensor-map encoders, found through the runtime
// (nothing links -lcuda). conv3d_wgmma.cu keeps its own copies of the same
// PTX for kernels A and B.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace mt {
namespace hopper {

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
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
// im2col mode: the map's pixelsPerColumn pixels from the one at (w, h, d, n)
// onwards in the order of its bounding box (w, then h, then d, then n),
// channels [c, c + channelsPerPixel) each, every pixel read at (w + ow,
// h + oh, d + od) of the tensor: zero outside it
__device__ __forceinline__ void tma_load_im2col_5d(uint32_t dst, const CUtensorMap* map,
                                                   uint32_t bar, int c, int w, int h, int d,
                                                   int n, uint16_t ow, uint16_t oh,
                                                   uint16_t od) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2], {%8, %9, %10};\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h), "r"(d), "r"(n),
      "h"(ow), "h"(oh), "h"(od)
      : "memory");
}

// A box of shared memory `src` to the tensor at (c0, ..., c4), clipped to
// the tensor, in this thread's bulk group
__device__ __forceinline__ void tma_store_5d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5, %6}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4)
      : "memory");
}
// bytes (a multiple of 16, both addresses 16-byte aligned) from shared memory
// at src to global memory at dst, by the TMA unit, in this thread's bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until this thread's bulk stores have read their shared memory (READ) or
// are done
template <bool READ>
__device__ __forceinline__ void tma_store_wait() {
  if constexpr (READ) {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  } else {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}
// this thread's shared-memory writes made visible to TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 8 bytes of shared memory at a shared-space address
__device__ __forceinline__ uint2 ld_shared_v2(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(addr));
  return v;
}
__device__ __forceinline__ void st_shared_v2(uint32_t addr, uint2 v) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "r"(v.x), "r"(v.y) : "memory");
}

// A shared-memory matrix descriptor: start address, leading and stride byte
// offsets, layout (1 the 128-byte swizzle, 2 the 64-byte one)
__host__ __device__ constexpr uint64_t sw_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                               uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}
__host__ __device__ constexpr uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return sw_desc(addr, lbo, sbo, 1);
}
// The K-major A operand of 64 rows of 128 bytes (64 bf16 channels) at
// `rows`, written by TMA with the 128-byte swizzle, k16 step `k` (0-3) of
// those 64 channels: 8-row atoms 1024 B apart, the step 32 B into the row
__device__ __forceinline__ uint64_t a_desc(uint32_t rows, int k) {
  return sw128_desc(rows + k * 32, 16, 1024);
}
// The MN-major B operand of 16 weight rows of 128 columns: two 64-column
// boxes `box` bytes apart, 8-row atoms 1024 B apart, from row 16 * k
__device__ __forceinline__ uint64_t b_desc(uint32_t stage, uint32_t box, int k) {
  return sw128_desc(stage + k * 16 * 128, box, 1024);
}

// The K-major A operand of 64 rows of 64 bytes (32 bf16 channels) at `rows`,
// written by TMA with the 64-byte swizzle, k16 step `k` (0-1): 8-row atoms
// 512 B apart, the step 32 B into the row
__device__ __forceinline__ uint64_t a_desc64(uint32_t rows, int k) {
  return sw_desc(rows + k * 32, 16, 512, 2);
}
// The MN-major B operand of 16 rows of 32 columns (64 bytes) written by TMA
// with the 64-byte swizzle, from row 16 * k: 8-row atoms 512 B apart
__device__ __forceinline__ uint64_t b_desc_n32(uint32_t rows, int k) {
  return sw_desc(rows + k * 16 * 64, 16, 512, 2);
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
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_acc(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (m64 x n32, fp32) = A (m64 x k16, K-major) * SCALE_B B (k16 x n32,
// MN-major) (+ d where `accumulate`), bf16, both from shared memory;
// SCALE_B 1 or -1. Accumulator r of a thread is row (warp % 4) * 16 +
// lane / 4 (+8 for r % 4 >= 2), column (r / 4) * 8 + 2 * (lane % 4) + r % 2.
template <int SCALE_B = 1>
__device__ __forceinline__ void mma_m64n32k16(float (&d)[16], uint64_t a, uint64_t b,
                                              bool accumulate) {
  static_assert(SCALE_B == 1 || SCALE_B == -1, "wgmma scales B by 1 or -1");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, %19, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"((int)accumulate), "n"(SCALE_B));
}

// d (m64 x n128, fp32) += A (m64 x k16, K-major) * B (k16 x n128, MN-major),
// bf16, both from shared memory (imm-trans-b 1). Accumulator r of a thread
// is row (warp % 4) * 16 + lane / 4 (+8 for r % 4 >= 2), column (r / 4) * 8
// + 2 * (lane % 4) + r % 2.
__device__ __forceinline__ void mma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b) {
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

// A barrier over `threads` threads (whole warps) at named barrier `id`, 1-15
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One m64n128 product's accumulators as bf16, each rounded once, into
// shared memory in a TMA box's layout with the 128-byte swizzle: rows of
// 64 columns (128 bytes), the two 64-column halves `half` bytes apart, row
// row0 + (warp % 4) * 16 + lane / 4 (+8) at that row's 128 bytes. stmatrix
// writes 4 8x8 matrices an instruction, the accumulators' own layout.
__device__ __forceinline__ void stage_m64n128(const float (&d)[64], uint32_t base,
                                              uint32_t half, int row0) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32 % 4;
  const int m = lane / 8;  // the matrix whose row this lane addresses
  const int r = row0 + warp * 16 + (m % 2) * 8 + lane % 8;
#pragma unroll
  for (int j = 0; j < 16; j += 2) {  // matrices (rows h, columns 8 (j + t)) of t, h in 0-1
    const int jj = j + m / 2;
    const uint32_t addr = base + jj / 8 * half + r * 128 + (((jj % 8) ^ (r & 7)) << 4);
    uint32_t v[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(d[(j + t / 2) * 4 + (t % 2) * 2],
                                                     d[(j + t / 2) * 4 + (t % 2) * 2 + 1]);
      v[t] = *reinterpret_cast<const uint32_t*>(&b);
    }
    asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
                 "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
                 : "memory");
  }
}

// One m64n128 product's accumulators into a channels-last bf16 output, each
// rounded once: row `row0` + r of the caller's rows (r < 64) at voxel
// `voxel(row)` (-1: not stored), columns n0 + c below cout. Straight from
// the accumulator layout a quad of lanes writes 16 bytes of each of 8 rows,
// so a warp's store is 8 transactions; the values go through `stage`, 64
// rows of 256 bytes of this warpgroup's shared memory (16-byte chunks
// swizzled by the row, conflict-free both ways), and leave as whole rows:
// 16 lanes write a row's 256 bytes. `bar` is the warpgroup's named barrier.
template <typename VoxelOf>
__device__ __forceinline__ void store_m64n128(const float (&d)[64], uint32_t stage, int bar,
                                              __nv_bfloat16* out, int cout, int n0, int row0,
                                              VoxelOf voxel) {
  const int t = threadIdx.x % 128, lane = t % 32, warp = t / 32;
  named_sync(bar, 128);  // the stage's last reads are done
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + lane / 4 + h * 8;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(d[j * 4 + h * 2], d[j * 4 + h * 2 + 1]);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(stage + r * 256 + ((j ^ (r & 7)) << 4) +
                                                      (lane % 4) * 4),
                   "r"(*reinterpret_cast<const uint32_t*>(&v)));
    }
  }
  named_sync(bar, 128);
  const int c = t % 16, col = n0 + c * 8;
#pragma unroll 2
  for (int i = 0; i < 8; ++i) {
    const int r = i * 8 + t / 16;
    const long long vox = voxel(row0 + r);
    if (vox < 0 || col >= cout) continue;
    uint4 v;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(stage + r * 256 + ((c ^ (r & 7)) << 4)));
    __nv_bfloat16* dst = out + vox * cout + col;
    if (cout % 8 == 0) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
      for (int k = 0; k < 8 && col + k < cout; ++k) dst[k] = e[k];
    }
  }
}

// ---------------------------------------------------------------------------
// host: the CUDA driver's tensor-map encoders
// ---------------------------------------------------------------------------

inline void* driver_entry(const char* name) {
  void* f = nullptr;
  cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
  if (cudaGetDriverEntryPointByVersion(name, &f, 12000, cudaEnableDefault, &q) != cudaSuccess)
    return nullptr;
#else
  if (cudaGetDriverEntryPoint(name, &f, cudaEnableDefault, &q) != cudaSuccess) return nullptr;
#endif
  return q == cudaDriverEntryPointSuccess ? f : nullptr;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const int*, const int*,
                                  cuuint32_t, cuuint32_t, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A bf16 tensor of `rank` dims (innermost first, dims[0] contiguous) with
// the 128-byte swizzle (or `swizzle`), zero outside the tensor: tiled with
// `box`.
inline bool tiled_map(CUtensorMap* m, const void* ptr, int rank, const cuuint64_t* dims,
                      const cuuint32_t* box,
                      CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  static const EncodeTiled enc =
      reinterpret_cast<EncodeTiled>(driver_entry("cuTensorMapEncodeTiled"));
  if (enc == nullptr) return false;
  cuuint64_t strides[4];
  cuuint64_t s = dims[0] * 2;
  for (int i = 0; i + 1 < rank; ++i) {
    strides[i] = s;
    s *= dims[i + 1];
  }
  const cuuint32_t es[5] = {1, 1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides,
             box, es, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The im2col map of a channels-last (N, Z, Y, X, C) bf16 tensor for the
// stride-1 SAME 3x3x3 conv: the bounding box runs from -1 to the far edge
// less 2 on every spatial axis (the corner of the window of each output
// voxel), so the offsets (dx, dy, dz) of a tap read input voxel (x + dx - 1,
// ...) for output voxel x; `channels` a pixel with the 128-byte swizzle,
// `pixels` a load.
inline bool im2col_map(CUtensorMap* m, const void* ptr, int n, int z, int y, int x, int c,
                       int channels, int pixels) {
  static const EncodeIm2col enc =
      reinterpret_cast<EncodeIm2col>(driver_entry("cuTensorMapEncodeIm2col"));
  if (enc == nullptr || c % 8 != 0) return false;
  const cuuint64_t dims[5] = {(cuuint64_t)c, (cuuint64_t)x, (cuuint64_t)y, (cuuint64_t)z,
                              (cuuint64_t)n};
  const cuuint64_t row = (cuuint64_t)c * 2;
  const cuuint64_t strides[4] = {row, row * x, row * x * y, row * x * y * z};
  const int lower[3] = {-1, -1, -1}, upper[3] = {-1, -1, -1};
  const cuuint32_t es[5] = {1, 1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(ptr), dims, strides,
             lower, upper, (cuuint32_t)channels, (cuuint32_t)pixels, es,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a body's forms: as it is; its copies only (the consumers hand every stage
// back without a product); its products only (nothing loaded); where it has
// a transform stage (the Winograd body), its copies and transform only
constexpr int MODE_WHOLE = 0, MODE_COPIES = 1, MODE_PRODUCTS = 2, MODE_TRANSFORM = 3;

}  // namespace hopper
}  // namespace mt
