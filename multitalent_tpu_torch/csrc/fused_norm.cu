// Kernel E: the two passes of the fused InstanceNorm + LeakyReLU over a
// channels-last bf16 tensor viewed as (N, S, C), S the flattened volume.
//
// Replaces the two Pallas TPU kernels of multitalent_tpu/ops/fused_norm.py:
//   - _stats_kernel -> channel_stats: per-(n, c) fp32 sum and sum of squares;
//   - _apply_kernel -> affine_lrelu: y = lrelu(x * scale[n, c] + shift[n, c]),
//     with the per-(n, c) scale and shift folded from the statistics by the
//     wrapper (ops/fused_norm.py), in one of two rounding orders:
//       cast_first = 0: lrelu in fp32, then one cast to bf16
//                       (fused_norm.py:_apply_kernel);
//       cast_first = 1: cast to bf16, then lrelu on the bf16 value
//                       (packed_conv.py:normalize_from_stats, the order of the
//                       fused conv chain's `materialize` and of the unfused
//                       blocks).
// Both are used on the fused conv chain: channel_stats for the convs whose
// statistics no kernel epilogue gives (the Cin=1 first conv, strided convs),
// and by kernel D when it splits its K loop; affine_lrelu wherever a
// normalized activation must exist in memory (skips, strided and transposed
// convs).
//
// What bounds it on an H100: one sweep each, ~0 FLOP per byte, so HBM
// bandwidth (3.35 TB/s): the stage-0 activation of 96x192x192x30 bf16 is
// 212 MB, ~63 us a read. The TPU kernels carried the sums across a sequential
// grid in VMEM; blocks here run in no order, so:
//   - channel_stats gives each block a fixed chunk of voxels; its threads
//     read channel pairs of consecutive voxels (coalesced 4-byte loads, a
//     block's rows contiguous in memory), keep per-thread fp32 sums, add them
//     over the block in a fixed order and write one partial per (n, chunk);
//     reduce_rows adds the partials in a fixed order. No atomics: the result
//     is deterministic, run to run.
//   - affine_lrelu is one grid-stride elementwise pass with 16-byte loads and
//     stores (8 channels at a time) when the layout allows it.
#include "common.cuh"

namespace mt {
namespace {

constexpr int THREADS = 256;
constexpr int MAX_CHUNKS = 1024;  // blocks of channel_stats per sample
constexpr int SEG_ROWS = 256;     // rows one reduce_rows block adds

// out (n, segs, width): block (col group, seg, n) adds rows [seg * seg_rows,
// ...) of part (n, rows, width); 8 row lanes, then a fixed-order tree.
__global__ void reduce_rows_kernel(const float* __restrict__ part, float* __restrict__ out,
                                   int rows, int width, int seg_rows) {
  __shared__ float red[8][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  const int seg = blockIdx.y, n = blockIdx.z;
  const int r0 = seg * seg_rows;
  const int r1 = min(rows, r0 + seg_rows);
  float acc = 0.f;
  if (col < width) {
    for (int r = r0 + threadIdx.y; r < r1; r += 8)
      acc += part[((int64_t)n * rows + r) * width + col];
  }
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && col < width) {
    const float v = ((red[0][threadIdx.x] + red[1][threadIdx.x]) +
                     (red[2][threadIdx.x] + red[3][threadIdx.x])) +
                    ((red[4][threadIdx.x] + red[5][threadIdx.x]) +
                     (red[6][threadIdx.x] + red[7][threadIdx.x]));
    out[((int64_t)n * gridDim.y + seg) * width + col] = v;
  }
}

// part (n, chunks, 2, c): block (chunk, n) sums voxels [chunk * per_chunk,
// ...). VEC channels per thread: `cols` = c / VEC threads cover one voxel's
// channels, `rows` = THREADS / cols voxels are read side by side.
template <int VEC>
__global__ void __launch_bounds__(THREADS)
    channel_stats_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ part,
                         long long s, int c, long long per_chunk, int cols, int rows) {
  __shared__ float red[2 * VEC][THREADS];
  const int n = blockIdx.y, chunk = blockIdx.x, chunks = gridDim.x;
  const int col = threadIdx.x % cols, row = threadIdx.x / cols;
  const long long v0 = chunk * per_chunk;
  const long long v1 = min(s, v0 + per_chunk);
  float sum[VEC], sq[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) sum[e] = sq[e] = 0.f;
  if (row < rows) {
    const __nv_bfloat16* base = x + (int64_t)n * s * c + col * VEC;
#pragma unroll 4
    for (long long v = v0 + row; v < v1; v += rows) {
      if constexpr (VEC == 2) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(base + v * c));
        sum[0] += f.x;
        sq[0] += f.x * f.x;
        sum[1] += f.y;
        sq[1] += f.y * f.y;
      } else {
        const float f = __bfloat162float(base[v * c]);
        sum[0] += f;
        sq[0] += f * f;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    red[e][threadIdx.x] = sum[e];
    red[VEC + e][threadIdx.x] = sq[e];
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += THREADS) {
    const int cl = ch / VEC, e = ch % VEC;
    float ts = 0.f, tq = 0.f;
    for (int r = 0; r < rows; ++r) {
      ts += red[e][r * cols + cl];
      tq += red[VEC + e][r * cols + cl];
    }
    float* dst = part + ((int64_t)n * chunks + chunk) * 2 * c;
    dst[ch] = ts;
    dst[c + ch] = tq;
  }
}

struct StatsPlan {
  int vec, cols, rows, chunks;
  long long per_chunk;
};

// pairs: channel pairs may be read as 4-byte words (C even, x 4-byte
// aligned). The chunks do not depend on it, so neither does the workspace.
bool stats_plan(long long s, int c, bool pairs, StatsPlan* p) {
  if (c <= 0 || s <= 0) return false;
  p->vec = pairs && c % 2 == 0 ? 2 : 1;
  p->cols = c / p->vec;
  if (p->cols > THREADS) return false;
  p->rows = THREADS / p->cols;
  const long long rows1 = c < THREADS ? THREADS / c : 1;
  long long chunks = (s + rows1 * 32LL - 1) / (rows1 * 32LL);
  chunks = chunks < 1 ? 1 : (chunks > MAX_CHUNKS ? MAX_CHUNKS : chunks);
  p->per_chunk = (s + chunks - 1) / chunks;
  p->chunks = (int)((s + p->per_chunk - 1) / p->per_chunk);  // no empty chunk
  return true;
}

// y = act(x * sc[n, ch] + sh[n, ch]) elementwise; VEC elements a thread step
// (8: one 16-byte load, all of one sample, since per_sample % 8 == 0).
template <bool CAST_FIRST, int VEC>
__global__ void __launch_bounds__(THREADS)
    affine_lrelu_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y,
                        const float* __restrict__ sc, const float* __restrict__ sh,
                        long long per_sample, int c, long long total, float slope) {
  const long long steps = total / VEC;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < steps;
       i += (long long)gridDim.x * THREADS) {
    const long long e0 = i * VEC;
    const int n = (int)(e0 / per_sample);
    int ch = (int)(e0 % c);
    __align__(16) __nv_bfloat16 in[VEC], out[VEC];
    if constexpr (VEC == 8) {
      *reinterpret_cast<uint4*>(in) = *reinterpret_cast<const uint4*>(x + e0);
    } else {
      in[0] = x[e0];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      // product and sum rounded apart, as the plain version rounds them: an
      // FMA differs by up to half an fp32 ulp of the product where the sum
      // cancels to near 0, which the bf16 cast does not hide
      const float f = __fadd_rn(__fmul_rn(__bfloat162float(in[e]), sc[n * c + ch]),
                                sh[n * c + ch]);
      if constexpr (CAST_FIRST) {
        out[e] = cast_lrelu(f, slope);
      } else {
        out[e] = __float2bfloat16(f >= 0.f ? f : f * slope);
      }
      if (++ch == c) ch = 0;
    }
    if constexpr (VEC == 8) {
      *reinterpret_cast<uint4*>(y + e0) = *reinterpret_cast<const uint4*>(out);
    } else {
      y[e0] = out[0];
    }
  }
}

template <bool CAST_FIRST>
cudaError_t launch_apply(const __nv_bfloat16* x, __nv_bfloat16* y, const float* sc,
                         const float* sh, int n, long long s, int c, float slope,
                         cudaStream_t stream) {
  const long long per_sample = s * c, total = per_sample * n;
  const bool vec8 = per_sample % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const long long steps = vec8 ? total / 8 : total;
  long long blocks = (steps + THREADS - 1) / THREADS;
  const long long cap = 16LL * sm_count();
  blocks = blocks > cap ? cap : (blocks < 1 ? 1 : blocks);
  if (vec8) {
    affine_lrelu_kernel<CAST_FIRST, 8><<<(unsigned)blocks, THREADS, 0, stream>>>(
        x, y, sc, sh, per_sample, c, total, slope);
  } else {
    affine_lrelu_kernel<CAST_FIRST, 1><<<(unsigned)blocks, THREADS, 0, stream>>>(
        x, y, sc, sh, per_sample, c, total, slope);
  }
  return cudaGetLastError();
}

}  // namespace

long long reduce_rows_workspace(int n, int rows, int width) {
  if (rows <= SEG_ROWS) return 0;
  const long long segs = cdiv(rows, SEG_ROWS);
  if (segs > SEG_ROWS) return -1;
  return (long long)n * segs * width * (long long)sizeof(float);
}

cudaError_t reduce_rows(const float* part, float* out, float* ws, int n, int rows,
                        int width, cudaStream_t stream) {
  const dim3 block(32, 8);
  if (rows <= SEG_ROWS) {
    reduce_rows_kernel<<<dim3(cdiv(width, 32), 1, n), block, 0, stream>>>(part, out, rows,
                                                                         width, rows);
    return cudaGetLastError();
  }
  const int segs = cdiv(rows, SEG_ROWS);
  if (segs > SEG_ROWS || ws == nullptr) return cudaErrorInvalidValue;
  reduce_rows_kernel<<<dim3(cdiv(width, 32), segs, n), block, 0, stream>>>(part, ws, rows,
                                                                          width, SEG_ROWS);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_rows_kernel<<<dim3(cdiv(width, 32), 1, n), block, 0, stream>>>(ws, out, segs,
                                                                       width, segs);
  return cudaGetLastError();
}

long long channel_stats_workspace(int n, long long s, int c) {
  StatsPlan p;
  if (n <= 0 || !stats_plan(s, c, true, &p)) return -1;
  const long long red = reduce_rows_workspace(n, p.chunks, 2 * c);
  if (red < 0) return -1;
  return (long long)n * p.chunks * 2 * c * (long long)sizeof(float) + red;
}

cudaError_t channel_stats(const __nv_bfloat16* x, float* stats, float* ws,
                          long long ws_bytes, int n, long long s, int c,
                          cudaStream_t stream) {
  StatsPlan p;
  const bool pairs = reinterpret_cast<uintptr_t>(x) % 4 == 0;
  if (n <= 0 || !stats_plan(s, c, pairs, &p) || ws == nullptr ||
      ws_bytes < channel_stats_workspace(n, s, c))
    return cudaErrorInvalidValue;
  const dim3 grid(p.chunks, n);
  if (p.vec == 2) {
    channel_stats_kernel<2><<<grid, THREADS, 0, stream>>>(x, ws, s, c, p.per_chunk, p.cols,
                                                          p.rows);
  } else {
    channel_stats_kernel<1><<<grid, THREADS, 0, stream>>>(x, ws, s, c, p.per_chunk, p.cols,
                                                          p.rows);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  float* red_ws = ws + (long long)n * p.chunks * 2 * c;
  return reduce_rows(ws, stats, red_ws, n, p.chunks, 2 * c, stream);
}

}  // namespace mt

extern "C" {

// Bytes of fp32 workspace mt_channel_stats needs (-1: sizes it does not take).
long long mt_channel_stats_workspace(int n, long long s, int c) {
  return mt::channel_stats_workspace(n, s, c);
}

// Kernel E, stats: stats (n, 2, c) fp32 of x (n, s, c) bf16.
int mt_channel_stats(const void* x, void* stats, void* ws, long long ws_bytes, int n,
                     long long s, int c, void* stream) {
  if (x == nullptr || stats == nullptr) return (int)cudaErrorInvalidValue;
  return (int)mt::channel_stats(static_cast<const __nv_bfloat16*>(x),
                                static_cast<float*>(stats), static_cast<float*>(ws),
                                ws_bytes, n, s, c, static_cast<cudaStream_t>(stream));
}

// Kernel E, apply: y = lrelu(x * scale + shift) per (sample, channel), scale
// and shift (n, c) fp32; cast_first picks the rounding order (see the top).
int mt_affine_lrelu(const void* x, void* y, const void* scale, const void* shift, int n,
                    long long s, int c, float slope, int cast_first, void* stream) {
  if (x == nullptr || y == nullptr || scale == nullptr || shift == nullptr || n <= 0 ||
      s <= 0 || c <= 0)
    return (int)cudaErrorInvalidValue;
  const auto* xi = static_cast<const __nv_bfloat16*>(x);
  auto* yo = static_cast<__nv_bfloat16*>(y);
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(cast_first ? mt::launch_apply<true>(xi, yo, sc, sh, n, s, c, slope, st)
                          : mt::launch_apply<false>(xi, yo, sc, sh, n, s, c, slope, st));
}

}  // extern "C"
