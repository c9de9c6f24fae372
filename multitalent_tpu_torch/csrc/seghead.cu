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
// 3.5M voxels a tile) it reads 212 MB and writes 333 MB (bf16): 0.163 ms at
// 3.35 TB/s. Its 10 GFLOP take 0.15 ms on the fp32 CUDA cores, about the
// whole byte bound, but 0.01 ms on the tensor cores. The design, so that the
// bytes bound it:
//   - warps work alone after one block barrier (the block stages the padded
//     bf16 weight (KP, CP) and the bias once): a warp walks tiles of TV = 32
//     voxels of one sample, persistent, tile t of its walk at warp gw + t *
//     (all warps); 16 warps an SM (shared memory and registers allow no
//     more) hide each other's latencies;
//   - a tile's input is one contiguous run of TV * C bf16. A per-warp ring
//     of 2-3 stages copies it with 16-byte cp.async where the run's start
//     allows (4-byte where it is 4-byte aligned, else element by element;
//     the ragged end element by element), the next tiles in flight while
//     this one computes and stores;
//   - the prologue, shared to shared memory, writes C-padded rows (CP = 16,
//     32, 64 or 128 channels, the padding exactly 0) in an XOR-swizzled
//     layout that ldmatrix reads without bank conflicts, applying cast_lrelu
//     with the sample's scale and shift held in registers (a lane keeps one
//     16-byte unit of 8 channels);
//   - the product is mma.sync m16n8k16 with the weight as the A operand (16
//     outputs x 16 channels) and the tile's voxels as B, so a lane's sums are
//     pairs of consecutive voxels of one output;
//   - the epilogue adds the bias in fp32, casts once, and writes a swizzled
//     (outputs x TV) tile to shared memory, from which the warp stores each
//     output's TV voxels as contiguous 16-byte stores at out + (n K + k) S +
//     v0 (narrower stores where S is not a multiple of 16 bytes, and at the
//     ragged last tile).
#include "common.cuh"

namespace {

using namespace mt;

constexpr int TV = 32;           // voxels a warp tile
constexpr int MAX_WARPS = 16;
constexpr int MAX_CP = 128;      // padded channels the prologue's rows take
constexpr int SMEM_MAX = 232448;  // bytes of shared memory a block may use

__host__ __device__ constexpr int padded_channels(int c) {
  return c <= 16 ? 16 : (c <= 32 ? 32 : (c <= 64 ? 64 : 128));
}

// The XOR of the 16-byte units of row r in rows of `units` (2, 4, 8 or 16)
// units, so that any 8 consecutive rows' unit u lie in 8 distinct bank
// groups (rows of 32 B: 4 rows a 128-byte line, then the unit flips; 64 B:
// 2 rows, then 4 units rotate; 128 B or more: 8 units rotate). Swz holds
// the shift and mask of a row size.
struct Swz {
  int shift, mask;
  __device__ __forceinline__ explicit Swz(int units)
      : shift(units >= 8 ? 0 : (units == 4 ? 1 : 2)), mask(units >= 8 ? 7 : units - 1) {}
  __device__ __forceinline__ int operator()(int r) const { return (r >> shift) & mask; }
};

template <typename OutT>
__device__ __forceinline__ void put_pair(OutT* p, float a, float b);
template <>
__device__ __forceinline__ void put_pair<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void put_pair<__nv_bfloat16>(__nv_bfloat16* p, float a,
                                                          float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The staging tile (outputs x TV voxels) of OutT: rows of TV * sizeof(OutT)
// bytes, the 16-byte unit of voxel v of row r swizzled so that a lane's pair
// stores (8 rows x 4 voxel pairs of the mma's accumulator layout) and the
// 16-byte row reads both avoid bank conflicts.
template <typename OutT>
__device__ __forceinline__ int stage_offset(int r, int v) {
  constexpr int E = (int)sizeof(OutT), PER = 16 / E;  // elements a unit
  const int sw = E == 2 ? ((r >> 1) & 3) : ((2 * r) & 7);
  return r * TV + (((v / PER) ^ sw) * PER) + v % PER;
}

struct HeadParams {
  const __nv_bfloat16* x;
  const float* scale;
  const float* shift;
  const __nv_bfloat16* w;  // (kp, cp), padding 0
  const float* bias;
  void* out;
  long long s;
  unsigned tiles_per_sample, tiles;        // tiles < 2^31
  int n, c, cp, k, kp, stages, raw_elems;  // raw_elems: a ring stage, per warp
  float slope;
};

// Copy len bf16 of one tile's contiguous run from src into a ring stage.
__device__ __forceinline__ void load_run(__nv_bfloat16* dst, const __nv_bfloat16* src, int len,
                                         int lane) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  int done = 0;
  if (a % 16 == 0) {
    done = len & ~7;
    for (int i = lane * 8; i < done; i += 256) cp_async16(dst + i, src + i, true);
  } else if (a % 4 == 0) {
    done = len & ~1;
    for (int i = lane * 2; i < done; i += 64) cp_async4(dst + i, src + i, true);
  }
  for (int i = done + lane; i < len; i += 32) dst[i] = src[i];
}

// lrelu(bf16(x * s + t)) of a bf16 pair, cast_lrelu's rounding with packed
// conversions: the slope's product is taken where the bf16 value's sign bit
// is set (y >= 0 keeps y; -0 and NaN give the same bits either way).
__device__ __forceinline__ uint32_t cast_lrelu2(uint32_t xb, float s0, float s1, float t0,
                                                float t1, float slope) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&xb));
  __nv_bfloat162 y = __floats2bfloat162_rn(fmaf(f.x, s0, t0), fmaf(f.y, s1, t1));
  const float2 g = __bfloat1622float2(y);
  __nv_bfloat162 z = __floats2bfloat162_rn(g.x * slope, g.y * slope);
  const uint32_t yb = *reinterpret_cast<uint32_t*>(&y);
  const uint32_t zb = *reinterpret_cast<uint32_t*>(&z);
  const uint32_t neg = ((yb >> 15) & 0x00010001u) * 0xffffu;
  return (yb & ~neg) | (zb & neg);
}

// MT: m16 tiles of outputs a pass (the outputs loop in passes of MT * 16).
template <typename OutT, bool AFFINE, int MT>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1) seghead_kernel(HeadParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cp = p.cp, units = cp / 8, kp = p.kp;
  const Swz swz(units);
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem);  // (kp, cp) swizzled
  float* bsm = reinterpret_cast<float*>(wsm + kp * cp);          // (kp,)
  unsigned char* wbase = reinterpret_cast<unsigned char*>(bsm + kp);
  const int act_bytes = TV * cp * 2, stage_bytes = MT * 16 * TV * (int)sizeof(OutT);
  const int warp_bytes = p.stages * p.raw_elems * 2 + act_bytes + stage_bytes;
  unsigned char* mine = wbase + warp * warp_bytes;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(mine);
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(mine + p.stages * p.raw_elems * 2);
  OutT* stg = reinterpret_cast<OutT*>(mine + p.stages * p.raw_elems * 2 + act_bytes);

  for (int i = threadIdx.x; i < kp * units; i += blockDim.x) {
    const int r = i / units, u = i - r * units;
    *reinterpret_cast<uint4*>(wsm + r * cp + ((u ^ swz(r)) * 8)) =
        *reinterpret_cast<const uint4*>(p.w + r * cp + u * 8);
  }
  for (int i = threadIdx.x; i < kp; i += blockDim.x)
    bsm[i] = (p.bias != nullptr && i < p.k) ? p.bias[i] : 0.f;
  __syncthreads();

  const unsigned gw = blockIdx.x * warps + warp, all = gridDim.x * warps;
  const int c = p.c;
  auto prefetch = [&](unsigned tile, int slot) {
    if (tile < p.tiles) {
      const unsigned n = tile / p.tiles_per_sample;
      const long long v0 = (long long)(tile - n * p.tiles_per_sample) * TV;
      const int nv = (int)min((long long)TV, p.s - v0);
      load_run(ring + slot * p.raw_elems, p.x + ((long long)n * p.s + v0) * c, nv * c, lane);
    }
    cp_async_commit();
  };
  for (int st = 0; st < p.stages - 1; ++st) prefetch(gw + st * all, st);

  // the prologue's unit: a lane keeps unit u (channels 8u .. 8u + 7) of the
  // voxels j0, j0 + vstep, ..
  const int u = lane % units, vstep = 32 / units, j0 = lane / units;
  const int c0 = u * 8;
  float s[8], t[8];
  unsigned sample = 0xffffffffu;
  int slot = 0;
  for (unsigned tile = gw; tile < p.tiles; tile += all) {
    prefetch(tile + (p.stages - 1) * all, (slot + p.stages - 1) % p.stages);
    if (p.stages == 3) {
      cp_async_wait<2>();
    } else {
      cp_async_wait<1>();
    }
    __syncwarp();
    const unsigned n = tile / p.tiles_per_sample;
    const long long v0 = (long long)(tile - n * p.tiles_per_sample) * TV;
    const int nv = (int)min((long long)TV, p.s - v0);
    if constexpr (AFFINE) {
      if (n != sample) {
        sample = n;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const bool in = c0 + e < c;
          s[e] = in ? p.scale[n * c + c0 + e] : 0.f;
          t[e] = in ? p.shift[n * c + c0 + e] : 0.f;
        }
      }
    }
    // the prologue: raw rows of c channels -> padded, swizzled rows of cp
    const __nv_bfloat16* raw = ring + slot * p.raw_elems;
    for (int v = j0; v < TV; v += vstep) {
      uint4 row = make_uint4(0u, 0u, 0u, 0u);
      uint32_t* wv = reinterpret_cast<uint32_t*>(&row);
      if (v < nv && c0 < c) {
        const __nv_bfloat16* src = raw + v * c + c0;
        if (c % 2 == 0) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c0 + 2 * e < c) wv[e] = *reinterpret_cast<const uint32_t*>(src + 2 * e);
        } else {
          __nv_bfloat16* hv = reinterpret_cast<__nv_bfloat16*>(&row);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (c0 + e < c) hv[e] = src[e];
        }
        if constexpr (AFFINE) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c0 + 2 * e < c)
              wv[e] = cast_lrelu2(wv[e], s[2 * e], s[2 * e + 1], t[2 * e], t[2 * e + 1],
                                  p.slope);
          // a padding channel of a pair holds lrelu(bf16(0 * 0 + 0)) = 0
        }
      }
      *reinterpret_cast<uint4*>(act + v * cp + ((u ^ swz(v)) * 8)) = row;
    }
    __syncwarp();

    // products and epilogue, MT * 16 outputs a pass
    OutT* out = static_cast<OutT*>(p.out);
    const bool vec = nv == TV && (p.s * (long long)sizeof(OutT)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
    for (int m0 = 0; m0 < kp; m0 += MT * 16) {
      const int mts = min(MT, (kp - m0) / 16);
      float acc[MT][4][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
      for (int ks = 0; ks < cp / 16; ++ks) {
        uint32_t b[2][4];  // voxel n8 tiles (0, 1) and (2, 3)
#pragma unroll
        for (int pr = 0; pr < 2; ++pr) {
          const int v = pr * 16 + (lane & 7) + (lane >> 4) * 8;
          const int uu = ks * 2 + ((lane >> 3) & 1);
          ldmatrix_x4(b[pr], act + v * cp + ((uu ^ swz(v)) * 8));
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          if (mi < mts) {
            uint32_t a[4];
            const int r = m0 + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
            const int uu = ks * 2 + (lane >> 4);
            ldmatrix_x4(a, wsm + r * cp + ((uu ^ swz(r)) * 8));
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
              mma_16816(acc[mi][ni], a, b[ni / 2][(ni % 2) * 2],
                        b[ni / 2][(ni % 2) * 2 + 1]);
          }
        }
      }
      const int g = lane >> 2, q = lane & 3;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        if (mi < mts) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = mi * 16 + g + hh * 8;  // row of the staging tile
            const float bv = bsm[m0 + r];
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
              put_pair<OutT>(stg + stage_offset<OutT>(r, ni * 8 + 2 * q),
                               acc[mi][ni][2 * hh] + bv, acc[mi][ni][2 * hh + 1] + bv);
          }
        }
      }
      __syncwarp();
      const int rows = min(mts * 16, p.k - m0);
      OutT* dst = out + ((long long)n * p.k + m0) * p.s + v0;
      if (vec) {
        constexpr int PER = 16 / (int)sizeof(OutT), UR = TV / PER;  // units a row
        for (int i = lane; i < rows * UR; i += 32) {
          const int r = i / UR, uo = i - r * UR;
          *reinterpret_cast<uint4*>(dst + r * p.s + uo * PER) =
              *reinterpret_cast<const uint4*>(stg + stage_offset<OutT>(r, uo * PER));
        }
      } else {
        for (int r = 0; r < rows; ++r)
          for (int v = lane; v < nv; v += 32) dst[r * p.s + v] = stg[stage_offset<OutT>(r, v)];
      }
      __syncwarp();
    }
    slot = slot + 1 == p.stages ? 0 : slot + 1;
  }
  cp_async_wait_all();
}

// The block's plan: warps (1-16) and ring stages (3, else 2) whose shared
// memory fits; false where none does.
struct HeadPlan {
  int warps, stages, raw_elems, mt;
  size_t smem;
};

bool head_plan(int c, int k, int out_bytes, HeadPlan* plan) {
  if (c <= 0 || c > MAX_CP || k <= 0) return false;
  const int cp = padded_channels(c), kp = cdiv(k, 16) * 16;
  plan->mt = kp / 16 < 4 ? kp / 16 : 4;
  plan->raw_elems = cdiv(TV * c, 8) * 8;
  const size_t fixed = (size_t)kp * cp * 2 + (size_t)kp * 4;
  for (int stages = 3; stages >= 2; --stages) {
    const size_t per_warp = (size_t)stages * plan->raw_elems * 2 + (size_t)TV * cp * 2 +
                            (size_t)plan->mt * 16 * TV * out_bytes;
    if (fixed + per_warp > SMEM_MAX) continue;
    const size_t warps = (SMEM_MAX - fixed) / per_warp;
    if (stages == 3 && warps < 8) continue;
    plan->warps = warps > MAX_WARPS ? MAX_WARPS : (int)warps;
    plan->stages = stages;
    plan->smem = fixed + per_warp * plan->warps;
    return true;
  }
  return false;
}

template <typename OutT, bool AFFINE, int MT>
cudaError_t launch_mt(const HeadParams& p, const HeadPlan& plan, cudaStream_t stream) {
  auto fn = seghead_kernel<OutT, AFFINE, MT>;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, plan.warps * 32, plan.smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long blocks = (p.tiles + plan.warps - 1) / plan.warps;
  const long long cap = (long long)per_sm * sm_count();
  blocks = blocks > cap ? cap : blocks;
  fn<<<(unsigned)blocks, plan.warps * 32, plan.smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename OutT, bool AFFINE>
cudaError_t launch(const HeadParams& p, const HeadPlan& plan, cudaStream_t stream) {
  switch (plan.mt) {
    case 1: return launch_mt<OutT, AFFINE, 1>(p, plan, stream);
    case 2: return launch_mt<OutT, AFFINE, 2>(p, plan, stream);
    case 3: return launch_mt<OutT, AFFINE, 3>(p, plan, stream);
    default: return launch_mt<OutT, AFFINE, 4>(p, plan, stream);
  }
}

// ---------------------------------------------------------------------------
// Kernel F's fp32 form, for the networks that compute in fp32 (`--fp32`,
// nnUNetTrainerV2_fp32; the JAX package builds its head kernel in the
// model's dtype, multitalent_tpu/ops/packed_unet.py:656): fp32 x, scale,
// shift and weights, fp32 FFMA (no TF32), the prologue's x * s + t rounded
// apart as the plain version rounds it, the activation on the fp32 value,
// the bias added last, one cast to the output type.
//
// What bounds it: the bytes. At the Liver's head (32 -> 3 channels, 128^3,
// N=2) it reads 128 and writes 12 bytes a voxel, 0.175 ms at 3.35 TB/s, with
// ~0.4 FLOP a byte; at the flagship's in fp32 (30 -> 47 at 96x192x192) 120
// read and 188 written, 0.326 ms, and its 10 GFLOP take 0.15 ms at 67
// TFLOP/s, so the FFMAs must stay dense too. The design carries the bf16
// body's to fp32 and FFMA:
//   - persistent blocks of up to 16 warps, one wave; after one block
//     barrier (the block stages the weight, transposed from
//     prepare_head_weight's padded (KP, CP) rows into (C, KS) rows by warps
//     over outputs and lanes over channels, no division, and the bias) warps
//     work alone: a warp walks tiles of F32_TV = 32 voxels of one sample,
//     tile t of its walk at warp gw + t * (all warps), and stages its
//     sample's scale and shift once a sample;
//   - a per-warp cp.async ring of 3 stages (2 where 3 leave fewer than 8
//     warps): a stage is one tile's contiguous run of 32 * C floats, copied
//     into rows of CS floats (16-byte copies of 4 channels where C % 4 == 0
//     and x is 16-byte aligned, so that every run starts aligned; else
//     4-byte copies of single floats; a lane steps through the run by
//     constant strides, no division), the next tiles in flight while this
//     one computes;
//   - the products by output groups of KG (K rounded up to 4, 8, 16 or 48,
//     a template argument, so that at K = 3 no padded output past the
//     fourth is computed and at K = 47 one group of 48 takes every output),
//     the channels in order for every output (the sum order of the older
//     body: bit-equal to it). Groups of 4 and 8: a lane owns one voxel of
//     the tile and every output of the group: per 4 channels one 16-byte
//     read of its row (CS / 4 odd: the 8 lanes of a phase meet 8 distinct
//     16-byte bank groups; C % 4 != 0: single reads of odd rows), the
//     prologue applied to the values in registers as they are read, then
//     per channel float4 broadcasts of the weight's row and KG FFMAs;
//   - groups of 16 and 48 (a lane's weight reads would otherwise take one
//     shared load for every 4 FFMAs: measured, the products then did not
//     hide behind the copies): the warp applies the prologue to the staged
//     tile in place first (each value once), then lanes form 8 voxel groups
//     (voxels g, g + 8, g + 16, g + 24: the rows' odd stride keeps the reads
//     conflict-free) by 4 output groups (KG / 4 outputs each), a register
//     tile of 4 voxels x KG / 4 outputs: per channel 4 reads of the
//     voxels' values (broadcast to the 4 output groups) and KG / 16 float4
//     reads of the weight's row for KG FFMAs;
//   - the epilogue adds the bias, casts once and writes each output's
//     voxels as coalesced warp stores (a 128-byte fp32 row of 32 voxels; in
//     the wide groups 32-byte runs of 8 voxels) of its NCDHW row.
// ---------------------------------------------------------------------------

constexpr int F32_TV = 32;  // voxels a warp tile: a lane each

struct F32Params {
  const float* x;
  const float* scale;  // null: no prologue
  const float* shift;
  const float* w;  // (kp, cp)
  const float* bias;
  void* out;
  long long s;
  unsigned tiles_per_sample, tiles;  // tiles < 2^31
  int c, cs, cp, k, ks, stages;
  float slope;
};

// floats a staged voxel row: with C % 4 == 0 a multiple of 4 whose 16-byte
// units are odd in number, else odd
__host__ __device__ constexpr int f32_row(int c) {
  return c % 4 == 0 ? (c / 4 % 2 == 1 ? c : c + 4) : (c % 2 == 1 ? c : c + 1);
}
__host__ __device__ constexpr int f32_group(int k) {
  return k <= 4 ? 4 : (k <= 8 ? 8 : (k <= 16 ? 16 : 48));
}

__device__ __forceinline__ void put_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void put_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// lrelu(x * s + t) in fp32, the product and the sum rounded apart
__device__ __forceinline__ float affine_lrelu1(float x, float s, float t, float slope) {
  const float f = __fadd_rn(__fmul_rn(x, s), t);
  return f >= 0.f ? f : f * slope;
}

// acc[e] += y * wrow[e], e < KG, by float4 broadcasts of the weight's row
template <int KG>
__device__ __forceinline__ void fma_row(float (&acc)[KG], float y, const float* wrow) {
#pragma unroll
  for (int q = 0; q < KG / 4; ++q) {
    const float4 w4 = *reinterpret_cast<const float4*>(wrow + 4 * q);
    acc[4 * q] = fmaf(y, w4.x, acc[4 * q]);
    acc[4 * q + 1] = fmaf(y, w4.y, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(y, w4.z, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(y, w4.w, acc[4 * q + 3]);
  }
}

// acc[i][e] += y[i] * wrow[e], i < 4, e < KO, by float4 broadcasts of the
// weight's row: the wide groups' register tile
template <int KO>
__device__ __forceinline__ void fma_tile(float (&acc)[4][KO], const float (&y)[4],
                                         const float* wrow) {
#pragma unroll
  for (int q = 0; q < KO / 4; ++q) {
    const float4 w4 = *reinterpret_cast<const float4*>(wrow + 4 * q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i][4 * q] = fmaf(y[i], w4.x, acc[i][4 * q]);
      acc[i][4 * q + 1] = fmaf(y[i], w4.y, acc[i][4 * q + 1]);
      acc[i][4 * q + 2] = fmaf(y[i], w4.z, acc[i][4 * q + 2]);
      acc[i][4 * q + 3] = fmaf(y[i], w4.w, acc[i][4 * q + 3]);
    }
  }
}

// VEC: rows of C % 4 == 0 floats, staged by 16-byte copies and read as
// float4s; else single floats. KG > 8: the wide groups' register tiles.
template <typename OutT, int KG, bool VEC>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1) seghead_fp32_kernel(F32Params p) {
  extern __shared__ __align__(16) float fsm[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = p.c, cs = p.cs, ks = p.ks, ca = (c + 3) & ~3;
  const int stage_floats = F32_TV * cs;
  float* wt = fsm;         // (c, ks), zero past k
  float* bs = wt + c * ks;  // (ks,)
  float* ss = bs + ks + warp * (2 * ca + p.stages * stage_floats);  // this warp's scale
  float* st = ss + ca;                                               // and shift
  float* ring = st + ca;
  for (int kk = warp; kk < ks; kk += warps)
    for (int ch = lane; ch < c; ch += 32)
      wt[ch * ks + kk] = kk < p.k ? p.w[(int64_t)kk * p.cp + ch] : 0.f;
  for (int i = threadIdx.x; i < ks; i += blockDim.x)
    bs[i] = (p.bias != nullptr && i < p.k) ? p.bias[i] : 0.f;
  __syncthreads();

  const unsigned gw = blockIdx.x * warps + warp, all = gridDim.x * warps;
  // a lane's copies of a run: unit u of voxel v (a unit is 4 floats with
  // VEC, else 1), stepping by 32 units
  const int units = VEC ? c / 4 : c, dv = 32 / units, du = 32 % units;
  constexpr bool WIDE = KG > 8;
  constexpr int KO = KG / 4;  // WIDE: outputs a lane a group
  auto prefetch = [&](unsigned tile, int slot) {
    if (tile < p.tiles) {
      const unsigned n = tile / p.tiles_per_sample;
      const long long v0 = (long long)(tile - n * p.tiles_per_sample) * F32_TV;
      const int nv = (int)min((long long)F32_TV, p.s - v0);
      const float* src = p.x + ((long long)n * p.s + v0) * c;
      float* dst = ring + slot * stage_floats;
      int v = lane / units, u = lane - v * units;
      for (int i = lane; i < nv * units; i += 32) {
        if constexpr (VEC) {
          cp_async16(dst + v * cs + 4 * u, src + 4 * i, true);
        } else {
          cp_async4(dst + v * cs + u, src + i, true);
        }
        v += dv;
        u += du;
        if (u >= units) {
          u -= units;
          ++v;
        }
      }
    }
    cp_async_commit();
  };
  for (int q = 0; q < p.stages - 1; ++q) prefetch(gw + q * all, q);

  const bool affine = p.scale != nullptr;
  unsigned sample = 0xffffffffu;
  int slot = 0;
  for (unsigned tile = gw; tile < p.tiles; tile += all) {
    prefetch(tile + (p.stages - 1) * all, (slot + p.stages - 1) % p.stages);
    if (p.stages == 3) {
      cp_async_wait<2>();
    } else {
      cp_async_wait<1>();
    }
    const unsigned n = tile / p.tiles_per_sample;
    const long long v0 = (long long)(tile - n * p.tiles_per_sample) * F32_TV;
    const int nv = (int)min((long long)F32_TV, p.s - v0);
    if (affine && n != sample) {  // the warp's sample changes: its scale and shift
      sample = n;
      for (int ch = lane; ch < c; ch += 32) {
        ss[ch] = p.scale[(int64_t)n * c + ch];
        st[ch] = p.shift[(int64_t)n * c + ch];
      }
    }
    __syncwarp();
    float* stage = ring + slot * stage_floats;
    if constexpr (WIDE) {  // the prologue in place, each value once
      if (affine) {
        int v = lane / c, ch = lane - v * c;
        const int ev = 32 / c, ec = 32 % c;
        for (int i = lane; i < nv * c; i += 32) {
          float* e = stage + v * cs + ch;
          *e = affine_lrelu1(*e, ss[ch], st[ch], p.slope);
          v += ev;
          ch += ec;
          if (ch >= c) {
            ch -= c;
            ++v;
          }
        }
        __syncwarp();
      }
    }
    for (int g0 = 0; g0 < ks; g0 += KG) {  // output groups
      if constexpr (WIDE) {
        const int g = lane % 8, o = lane / 8;  // voxels g + 8 i, outputs o * KO + e
        const float* rows = stage + g * cs;
        const float* wg = wt + g0 + o * KO;
        float acc[4][KO];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < KO; ++e) acc[i][e] = 0.f;
        if constexpr (VEC) {
#pragma unroll 1
          for (int c4 = 0; c4 < c; c4 += 4) {
            float y[4][4];  // [channel][voxel]
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float4 x4 = *reinterpret_cast<const float4*>(rows + 8 * i * cs + c4);
              y[0][i] = x4.x;
              y[1][i] = x4.y;
              y[2][i] = x4.z;
              y[3][i] = x4.w;
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) fma_tile<KO>(acc, y[e], wg + (c4 + e) * ks);
          }
        } else {
#pragma unroll 2
          for (int ch = 0; ch < c; ++ch) {
            float y[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) y[i] = rows[8 * i * cs + ch];
            fma_tile<KO>(acc, y, wg + ch * ks);
          }
        }
        OutT* out = static_cast<OutT*>(p.out) + (int64_t)n * p.k * p.s + v0 + g;
#pragma unroll
        for (int e = 0; e < KO; ++e) {
          const int kk = g0 + o * KO + e;
          if (kk >= p.k) continue;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (g + 8 * i < nv) put_out(out + (int64_t)kk * p.s + 8 * i, acc[i][e] + bs[kk]);
        }
        continue;
      }
      const float* row = stage + lane * cs;
      OutT* out = static_cast<OutT*>(p.out) + (int64_t)n * p.k * p.s + v0 + lane;
      float acc[KG];
#pragma unroll
      for (int e = 0; e < KG; ++e) acc[e] = 0.f;
      if constexpr (VEC) {
#pragma unroll 2
        for (int c4 = 0; c4 < c; c4 += 4) {
          const float4 x4 = *reinterpret_cast<const float4*>(row + c4);
          float y[4] = {x4.x, x4.y, x4.z, x4.w};
          if (affine) {
            const float4 s4 = *reinterpret_cast<const float4*>(ss + c4);
            const float4 t4 = *reinterpret_cast<const float4*>(st + c4);
            y[0] = affine_lrelu1(y[0], s4.x, t4.x, p.slope);
            y[1] = affine_lrelu1(y[1], s4.y, t4.y, p.slope);
            y[2] = affine_lrelu1(y[2], s4.z, t4.z, p.slope);
            y[3] = affine_lrelu1(y[3], s4.w, t4.w, p.slope);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) fma_row<KG>(acc, y[e], wt + (c4 + e) * ks + g0);
        }
      } else {
#pragma unroll 2
        for (int ch = 0; ch < c; ++ch) {
          float y = row[ch];
          if (affine) y = affine_lrelu1(y, ss[ch], st[ch], p.slope);
          fma_row<KG>(acc, y, wt + ch * ks + g0);
        }
      }
      if (lane < nv) {
#pragma unroll
        for (int e = 0; e < KG; ++e) {
          const int kk = g0 + e;
          if (kk < p.k) put_out(out + (int64_t)kk * p.s, acc[e] + bs[kk]);
        }
      }
    }
    __syncwarp();  // the stage and the scale are read: the next copies may land
    slot = slot + 1 == p.stages ? 0 : slot + 1;
  }
  cp_async_wait_all();
}

// The fp32 form's block: warps (1-16) and ring stages (3, else 2) whose
// shared memory fits; false where none does.
struct F32Plan {
  int kg, ks, cs, warps, stages;
  size_t smem;
};

bool f32_plan(int c, int k, F32Plan* plan) {
  if (c <= 0 || k <= 0) return false;
  plan->kg = f32_group(k);
  plan->ks = cdiv(k, plan->kg) * plan->kg;
  plan->cs = f32_row(c);
  const size_t ca = (size_t)(c + 3) & ~(size_t)3;
  const size_t fixed = 4 * ((size_t)c * plan->ks + plan->ks);
  for (int stages = 3; stages >= 2; --stages) {
    const size_t per_warp = 4 * (2 * ca + (size_t)stages * F32_TV * plan->cs);
    if (fixed + per_warp > SMEM_MAX) continue;
    const size_t warps = (SMEM_MAX - fixed) / per_warp;
    if (stages == 3 && warps < 8) continue;
    plan->warps = warps > MAX_WARPS ? MAX_WARPS : (int)warps;
    plan->stages = stages;
    plan->smem = fixed + per_warp * plan->warps;
    return true;
  }
  return false;
}

template <typename OutT, int KG, bool VEC>
cudaError_t launch_fp32_kg(const F32Params& p, const F32Plan& plan, cudaStream_t stream) {
  auto fn = seghead_fp32_kernel<OutT, KG, VEC>;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, plan.warps * 32, plan.smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long blocks = (p.tiles + plan.warps - 1) / plan.warps;
  const long long cap = (long long)per_sm * sm_count();
  blocks = blocks > cap ? cap : blocks;
  fn<<<(unsigned)blocks, plan.warps * 32, plan.smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename OutT, bool VEC>
cudaError_t launch_fp32_vec(const F32Params& p, const F32Plan& plan, cudaStream_t stream) {
  switch (plan.kg) {
    case 4: return launch_fp32_kg<OutT, 4, VEC>(p, plan, stream);
    case 8: return launch_fp32_kg<OutT, 8, VEC>(p, plan, stream);
    case 16: return launch_fp32_kg<OutT, 16, VEC>(p, plan, stream);
    default: return launch_fp32_kg<OutT, 48, VEC>(p, plan, stream);
  }
}

template <typename OutT>
cudaError_t launch_fp32(const F32Params& p, const F32Plan& plan, cudaStream_t stream) {
  const bool vec = p.c % 4 == 0 && reinterpret_cast<uintptr_t>(p.x) % 16 == 0;
  return vec ? launch_fp32_vec<OutT, true>(p, plan, stream)
             : launch_fp32_vec<OutT, false>(p, plan, stream);
}

}  // namespace

extern "C" {

// The largest channel count kernel F takes for k outputs (its shared memory
// fits a block with either output type); 0: none.
int mt_seghead_max_channels(int k) {
  HeadPlan plan;
  for (int c = MAX_CP; c > 0; --c)
    if (head_plan(c, k, 4, &plan)) return c;
  return 0;
}

// Kernel F: out (n, k, s) contiguous (NCDHW), fp32 (out_bf16 = 0) or bf16, of
// x (n, s, c) bf16 (channels-last); w (kp, cp) bf16, the head's (k, c) weight
// padded with zeros to kp = k rounded up to 16 rows and cp = 16, 32, 64 or
// 128 (the least >= c) columns; bias (k,) fp32 or null; scale, shift (n, c)
// fp32 (the prologue) or both null.
int mt_seghead(const void* x, const void* scale, const void* shift, const void* w,
               const void* bias, void* out, int out_bf16, int n, long long s, int c, int k,
               int kp, float slope, void* stream) {
  HeadPlan plan;
  if (x == nullptr || w == nullptr || out == nullptr || n <= 0 || s <= 0 || c <= 0 ||
      k <= 0 || kp != cdiv(k, 16) * 16 || (scale == nullptr) != (shift == nullptr) ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 2 != 0 ||
      !head_plan(c, k, out_bf16 ? 2 : 4, &plan))
    return (int)cudaErrorInvalidValue;
  HeadParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  const long long tiles_per_sample = (s + TV - 1) / TV;
  if (tiles_per_sample * n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  p.s = s;
  p.tiles_per_sample = (unsigned)tiles_per_sample;
  p.tiles = (unsigned)(tiles_per_sample * n);
  p.n = n;
  p.c = c;
  p.cp = padded_channels(c);
  p.k = k;
  p.kp = kp;
  p.stages = plan.stages;
  p.raw_elems = plan.raw_elems;
  p.slope = slope;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool affine = scale != nullptr;
  cudaError_t err;
  if (out_bf16) {
    err = affine ? launch<__nv_bfloat16, true>(p, plan, st)
                 : launch<__nv_bfloat16, false>(p, plan, st);
  } else {
    err = affine ? launch<float, true>(p, plan, st) : launch<float, false>(p, plan, st);
  }
  return (int)err;
}

// Kernel F's fp32 form: out (n, k, s) contiguous, fp32 (out_bf16 = 0) or
// bf16, of x (n, s, c) fp32; w (kp, cp) fp32, the head's (k, c) weight
// padded with zeros as mt_seghead's; bias (k,) fp32 or null; scale, shift
// (n, c) fp32 or both null.
int mt_seghead_fp32(const void* x, const void* scale, const void* shift, const void* w,
                    const void* bias, void* out, int out_bf16, int n, long long s, int c, int k,
                    int kp, int cp, float slope, void* stream) {
  F32Plan plan;
  if (x == nullptr || w == nullptr || out == nullptr || n <= 0 || s <= 0 || c <= 0 ||
      k <= 0 || kp != cdiv(k, 16) * 16 || cp < c || (scale == nullptr) != (shift == nullptr) ||
      reinterpret_cast<uintptr_t>(x) % 4 != 0 || !f32_plan(c, k, &plan))
    return (int)cudaErrorInvalidValue;
  const long long tiles_per_sample = (s + F32_TV - 1) / F32_TV;
  if (tiles_per_sample * n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  F32Params p;
  p.x = static_cast<const float*>(x);
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.w = static_cast<const float*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.s = s;
  p.tiles_per_sample = (unsigned)tiles_per_sample;
  p.tiles = (unsigned)(tiles_per_sample * n);
  p.c = c;
  p.cs = plan.cs;
  p.cp = cp;
  p.k = k;
  p.ks = plan.ks;
  p.stages = plan.stages;
  p.slope = slope;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(out_bf16 ? launch_fp32<__nv_bfloat16>(p, plan, st) : launch_fp32<float>(p, plan, st));
}

}  // extern "C"
