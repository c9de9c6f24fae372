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
//   - channel_stats cuts each sample into at most 256 chunks of at least
//     64 KB (about 512 blocks in all: a few an SM) and reads a chunk's run
//     of voxels x channels as 16-byte vectors where the run fits them.
//     Vector i holds channels (8 i + e) mod c, which repeat every c / gcd(c,
//     8) vectors (15 at 30, 60 and 120 channels; 30 at 240; 40 at 320), so
//     threads in groups of that period, striding by a multiple of it, each
//     keep 8 fixed channels' fp32 sums on their whole walk with no division;
//     where the vectors do not fit, threads read channel pairs or single
//     channels of consecutive voxels. Each block adds its threads' sums in a
//     fixed order into one partial row, and one reduce_rows launch adds the
//     rows in a fixed order; a sample of one chunk is written directly (one
//     launch). No atomics: the result is deterministic, run to run.
//   - affine_lrelu is one grid-stride elementwise pass with 16-byte loads and
//     stores (8 channels at a time) when the layout allows it.
#include <algorithm>

#include "common.cuh"

namespace mt {
namespace {

constexpr int THREADS = 256;
constexpr int VEC_THREADS = 512;  // threads of a block of channel_stats' vector form
constexpr int UNROLL = 8;         // 16-byte loads a thread has in flight
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
// channels, `rows` = THREADS / cols voxels are read side by side. The form
// for runs that 16-byte vectors do not fit.
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

__device__ __forceinline__ void add8(const uint4& v, float* sum, float* sq) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
    sum[2 * e] += f.x;
    sq[2 * e] = fmaf(f.x, f.x, sq[2 * e]);
    sum[2 * e + 1] += f.y;
    sq[2 * e + 1] = fmaf(f.y, f.y, sq[2 * e + 1]);
  }
}

// part (n, chunks, 2, c) of the sample's flat run of s * c bf16 read as
// 16-byte vectors (s * c % 8 == 0, x 16-byte aligned): vector i holds
// channels (8 i + e) mod c, e < 8, a map that repeats every `period` = c /
// gcd(c, 8) vectors. Block (chunk, n) reads vectors [chunk * per_chunk, ...)
// (per_chunk a multiple of the period) with its first period * reps threads
// (reps a power of two), thread t the vectors t, t + period * reps, .., so
// that it keeps the same 8 channels' sums on its whole walk. Then, in a
// fixed order: a tree over the reps threads of each phase, and for each
// channel the 8 / gcd(c, 8) (phase, e) slots that hold it.
__global__ void __launch_bounds__(VEC_THREADS)
    channel_stats_vec_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ part,
                             long long nvec, int c, int period, int reps,
                             long long per_chunk) {
  __shared__ float red[VEC_THREADS][17];
  const int n = blockIdx.y, chunk = blockIdx.x, chunks = gridDim.x;
  const int t = threadIdx.x, active = period * reps;
  float sum[8], sq[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sum[e] = sq[e] = 0.f;
  if (t < active) {
    const uint4* v = reinterpret_cast<const uint4*>(x) + (long long)n * nvec;
    const long long i1 = min(nvec, (chunk + 1) * per_chunk);
    long long i = chunk * per_chunk + t;
    for (; i + (UNROLL - 1LL) * active < i1; i += (long long)UNROLL * active) {
      uint4 r[UNROLL];  // all loads in flight before the first add
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) r[j] = __ldg(v + i + (long long)j * active);
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) add8(r[j], sum, sq);
    }
    for (; i < i1; i += active) add8(__ldg(v + i), sum, sq);
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red[t][e] = sum[e];
    red[t][8 + e] = sq[e];
  }
  __syncthreads();
  for (int h = reps / 2; h >= 1; h /= 2) {
    if (t < period * h) {
#pragma unroll
      for (int e = 0; e < 16; ++e) red[t][e] += red[t + period * h][e];
    }
    __syncthreads();
  }
  const int slots = 8 * period / c;  // positions 8 phase + e of one channel
  for (int ch = t; ch < c; ch += VEC_THREADS) {
    float ts = 0.f, tq = 0.f;
    for (int m = 0; m < slots; ++m) {
      const int q = ch + m * c;
      ts += red[q >> 3][q & 7];
      tq += red[q >> 3][8 + (q & 7)];
    }
    float* dst = part + ((int64_t)n * chunks + chunk) * 2 * c;
    dst[ch] = ts;
    dst[c + ch] = tq;
  }
}

int gcd(int a, int b) {
  while (b != 0) {
    const int r = a % b;
    a = b;
    b = r;
  }
  return a;
}

// How channel_stats cuts a sample: at most MAX_CHUNKS chunks of at least
// MIN_CHUNK_BYTES, fewer for more samples (about WAVE_BLOCKS blocks in
// all), so that one reduce_rows launch adds the partials, and a sample of
// one chunk needs none. The chunk count depends on the sizes alone, so the
// workspace does not depend on which form a call takes.
constexpr int MAX_CHUNKS = 256;
constexpr long long MIN_CHUNK_BYTES = 64 << 10;
constexpr int WAVE_BLOCKS = 512;

int stats_chunks(int n, long long s, int c) {
  const long long bytes = s * c * 2;
  long long chunks = (bytes + MIN_CHUNK_BYTES - 1) / MIN_CHUNK_BYTES;
  const long long cap = std::max(1, std::min(MAX_CHUNKS, cdiv(WAVE_BLOCKS, n)));
  return (int)std::max(1LL, std::min(chunks, cap));
}

struct StatsPlan {
  bool vec;  // 16-byte vectors; else VEC (2: channel pairs, 1: single channels)
  int vec_n, cols, rows, period, reps, chunks;
  long long per_chunk;  // vectors (vec) or voxels
};

// The form a call takes: 16-byte vectors where the run fits them (s * c %
// 8 == 0, x 16-byte aligned, a period of at most VEC_THREADS), else the pair
// form (c even, x 4-byte aligned) or the single-channel form.
bool stats_plan(int n, long long s, int c, uintptr_t addr, StatsPlan* p) {
  if (n <= 0 || c <= 0 || s <= 0) return false;
  const int target = stats_chunks(n, s, c);
  const int period = c / gcd(c, 8);
  p->vec = (s * c) % 8 == 0 && addr % 16 == 0 && period <= VEC_THREADS;
  if (p->vec) {
    const long long nvec = s * c / 8;
    p->period = period;
    p->reps = 1;
    while (2 * p->reps * period <= VEC_THREADS) p->reps *= 2;
    const long long per = (nvec + target - 1) / target;
    p->per_chunk = (per + period - 1) / period * period;
    p->chunks = (int)((nvec + p->per_chunk - 1) / p->per_chunk);
    return true;
  }
  p->vec_n = (c % 2 == 0 && addr % 4 == 0) ? 2 : 1;
  p->cols = c / p->vec_n;
  if (p->cols > THREADS) return false;
  p->rows = THREADS / p->cols;
  p->per_chunk = (s + target - 1) / target;
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
  // the widest workspace of the forms (the chunk count is theirs alike)
  if (!stats_plan(n, s, c, 16, &p) && !stats_plan(n, s, c, 2, &p)) return -1;
  const int chunks = stats_chunks(n, s, c);
  return chunks == 1 ? 0 : (long long)n * chunks * 2 * c * (long long)sizeof(float);
}

cudaError_t channel_stats(const __nv_bfloat16* x, float* stats, float* ws,
                          long long ws_bytes, int n, long long s, int c,
                          cudaStream_t stream) {
  StatsPlan p;
  if (!stats_plan(n, s, c, reinterpret_cast<uintptr_t>(x), &p) ||
      ws_bytes < channel_stats_workspace(n, s, c) || (p.chunks > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  // one chunk a sample: its block writes the stats; else one reduce_rows
  float* part = p.chunks == 1 ? stats : ws;
  const dim3 grid(p.chunks, n);
  if (p.vec) {
    channel_stats_vec_kernel<<<grid, VEC_THREADS, 0, stream>>>(x, part, s * c / 8, c, p.period,
                                                           p.reps, p.per_chunk);
  } else if (p.vec_n == 2) {
    channel_stats_kernel<2><<<grid, THREADS, 0, stream>>>(x, part, s, c, p.per_chunk, p.cols,
                                                          p.rows);
  } else {
    channel_stats_kernel<1><<<grid, THREADS, 0, stream>>>(x, part, s, c, p.per_chunk, p.cols,
                                                          p.rows);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.chunks == 1) return err;
  return reduce_rows(ws, stats, nullptr, n, p.chunks, 2 * c, stream);
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
