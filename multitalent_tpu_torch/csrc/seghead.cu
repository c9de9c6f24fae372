// Kernel F: the 1x1x1 segmentation head of the fused inference forward, with
// the last InstanceNorm + LeakyReLU in its prologue.
//
//   out[n, k, v] = bias[k] + sum_c w[c, k] * y[n, v, c],
//   y = lrelu(bf16(x[n, v, c] * scale[n, c] + shift[n, c]))   (AFFINE)
//   y = x                                                       (otherwise)
//
// Replaces multitalent_tpu/ops/pallas_seghead.py:_kernel. The TPU kernel runs
// the head on the (2,2) space-to-depth packed tensor as one GEMM per packing
// phase and interleaves the phases back into voxel order in VMEM, so that the
// logits reach memory once, in the layout their consumer reads. The port runs
// unpacked, so there are no phases; the same point becomes writing the logits
// directly as a contiguous NCDHW (N, K, Z, Y, X) tensor, the layout the
// sliding window's flips, sigmoid and accumulation read
// (ops/sliding_window.py), from a channels-last input.
//
// Rounding, as the TPU kernel: the prologue casts to bf16 before the
// activation; products of the bf16 activation and the bf16-rounded weights
// are summed in fp32; the fp32 bias is added last; one cast to the output
// type (bf16 for a bf16 model, packed_unet.py:822, else fp32).
//
// What bounds it on an H100: at the flagship's stage 0 (30 -> 47 channels,
// 3.5M voxels a tile) it reads 212 MB and writes 333 MB (bf16), ~0.16 ms at
// HBM bandwidth, and does 10 GFLOP, ~0.15 ms on the fp32 CUDA cores: too few
// FLOPs per byte for the tensor cores to matter. The design: a block stages
// 256 voxels x C in shared memory with coalesced 2-byte loads, applying the
// prologue on the way in; each thread then owns one voxel and accumulates 16
// outputs at a time in registers against weights read from shared memory as
// broadcast float4s; consecutive threads write consecutive voxels of one
// output channel (coalesced).
#include "common.cuh"

namespace {

using namespace mt;

constexpr int THREADS = 256;  // voxels per block
constexpr int KB = 16;        // outputs accumulated at a time

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// w: (C, KP) fp32, KP = K rounded up to KB, zero past K.
template <typename OutT, bool AFFINE>
__global__ void __launch_bounds__(THREADS)
    seghead_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ shift, const float* __restrict__ w,
                   const float* __restrict__ bias, OutT* __restrict__ out, long long s, int c,
                   int k, int kp, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* wsm = reinterpret_cast<float*>(smem);  // (c, kp)
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + (size_t)c * kp * 4);
  const int n = blockIdx.y;
  const long long v0 = (long long)blockIdx.x * THREADS;
  const int nv = (int)min((long long)THREADS, s - v0);

  for (int i = threadIdx.x; i < c * kp; i += THREADS) wsm[i] = w[i];
  const __nv_bfloat16* src = x + ((long long)n * s + v0) * c;
  for (int i = threadIdx.x; i < nv * c; i += THREADS) {
    __nv_bfloat16 v = src[i];
    if constexpr (AFFINE) {
      const int ch = i % c;
      v = cast_lrelu(__bfloat162float(v) * scale[n * c + ch] + shift[n * c + ch], slope);
    }
    xs[i] = v;
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= nv) return;
  const __nv_bfloat16* row = xs + t * c;
  OutT* dst = out + (long long)n * k * s + v0 + t;
  for (int k0 = 0; k0 < k; k0 += KB) {
    float acc[KB];
#pragma unroll
    for (int j = 0; j < KB; ++j) acc[j] = 0.f;
    for (int ci = 0; ci < c; ++ci) {
      const float yv = __bfloat162float(row[ci]);
      const float4* wr = reinterpret_cast<const float4*>(wsm + ci * kp + k0);
#pragma unroll
      for (int q = 0; q < KB / 4; ++q) {
        const float4 wv = wr[q];
        acc[4 * q] += yv * wv.x;
        acc[4 * q + 1] += yv * wv.y;
        acc[4 * q + 2] += yv * wv.z;
        acc[4 * q + 3] += yv * wv.w;
      }
    }
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      if (k0 + j < k)
        dst[(long long)(k0 + j) * s] =
            from_float<OutT>(acc[j] + (bias != nullptr ? bias[k0 + j] : 0.f));
    }
  }
}

size_t smem_bytes(int c, int kp) {
  return (size_t)c * kp * sizeof(float) + (size_t)THREADS * c * sizeof(__nv_bfloat16);
}

template <typename OutT, bool AFFINE>
cudaError_t launch(const __nv_bfloat16* x, const float* scale, const float* shift,
                   const float* w, const float* bias, void* out, int n, long long s, int c,
                   int k, int kp, float slope, cudaStream_t stream) {
  const size_t smem = smem_bytes(c, kp);
  const long long blocks = (s + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL || n > 65535) return cudaErrorInvalidConfiguration;
  seghead_kernel<OutT, AFFINE><<<dim3((unsigned)blocks, n), THREADS, smem, stream>>>(
      x, scale, shift, w, bias, static_cast<OutT*>(out), s, c, k, kp, slope);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest channel count kernel F takes for k outputs (its shared memory
// stays within the default 48 KB a block); 0: none.
int mt_seghead_max_channels(int k) {
  const int kp = cdiv(k, KB) * KB;
  for (int c = 512; c > 0; --c)
    if (smem_bytes(c, kp) <= 48 * 1024) return c;
  return 0;
}

// Kernel F: out (n, k, s) contiguous (NCDHW), fp32 (out_bf16 = 0) or bf16, of
// x (n, s, c) bf16 (channels-last); w (c, kp) fp32, kp = k rounded up to 16;
// bias (k,) fp32 or null; scale, shift (n, c) fp32 (the prologue) or both
// null.
int mt_seghead(const void* x, const void* scale, const void* shift, const void* w,
               const void* bias, void* out, int out_bf16, int n, long long s, int c, int k,
               int kp, float slope, void* stream) {
  if (x == nullptr || w == nullptr || out == nullptr || n <= 0 || s <= 0 || c <= 0 ||
      k <= 0 || kp != cdiv(k, KB) * KB || c > mt_seghead_max_channels(k) ||
      (scale == nullptr) != (shift == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto* xi = static_cast<const __nv_bfloat16*>(x);
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (out_bf16) {
    err = sc != nullptr
              ? launch<__nv_bfloat16, true>(xi, sc, sh, wf, bf, out, n, s, c, k, kp, slope, st)
              : launch<__nv_bfloat16, false>(xi, sc, sh, wf, bf, out, n, s, c, k, kp, slope,
                                             st);
  } else {
    err = sc != nullptr
              ? launch<float, true>(xi, sc, sh, wf, bf, out, n, s, c, k, kp, slope, st)
              : launch<float, false>(xi, sc, sh, wf, bf, out, n, s, c, k, kp, slope, st);
  }
  return (int)err;
}

}  // extern "C"
