// The fp32 forms of kernels A, B, C and D: the stride-1 SAME 3x3x3
// convolution (with D's normalize prologue and stats epilogue) and its
// weight gradient with fp32 inputs, weights and outputs, for the networks
// that train and predict in fp32 (`--fp32`, nnUNetTrainerV2_fp32).
//
//   out[n, z, y, x, co] = bias[co] + sum over dz, dy, dx, ci of
//       in[n, z+dz-1, y+dy-1, x+dx-1, ci] * w[co, ci, dz, dy, dx]   (zero outside)
//   dw[co, ci, dz, dy, dx] = sum over n, z, y, x of
//       in[n, z+dz-1, y+dy-1, x+dx-1, ci] * g[n, z, y, x, co]
//
// where `in` is x (kernel A's form), or concat(a, b) along channels (kernel
// B's form and C's dual form) read from the two tensors without building
// the concat. They replace the fp32 instantiations of the Pallas TPU kernels
// of multitalent_tpu, which are built in the input's dtype:
//   - ops/pallas_conv.py _conv_kernel and ops/pallas_merged_conv.py
//     _merged_kernel (fp32 A; with the flipped, transposed weight also dx);
//   - ops/pallas_merged_conv.py _merged2_kernel (fp32 B);
//   - ops/pallas_conv.py _wgrad_kernel and ops/pallas_merged_conv.py
//     _merged_wgrad_kernel (fp32 C);
//   - ops/pallas_conv.py _conv_affine_kernel (fp32 D, the fused conv ->
//     InstanceNorm chain's conv): out = conv(lrelu(x * scale[n, c] +
//     shift[n, c])) + bias with the SAME halo kept at 0 (not lrelu(shift)),
//     and stats (N, 2, Cout): each sample's channel sum and sum of squares of
//     out. Its dual form (two inputs, no prologue) serves a decoder's first
//     conv.
//
// Plain FFMA on the CUDA cores, no TF32: TF32 rounds the inputs to 10
// mantissa bits, and the JAX package's fp32 reference does not. What bounds
// them on an H100 is fp32 arithmetic (67 TFLOP/s): a 32 -> 32 conv, or its
// weight gradient, does 1728 operations for every 256 bytes it must move,
// far above the card's ~20 operations a byte in fp32. So both bodies keep
// the FFMA pipes fed from shared memory with few loads per FMA, behind a
// cp.async ring of 512-voxel boxes (kRingBoxes) walked by persistent blocks:
//   - forward of A, B and D: the ring body, conv_fp32_ring_kernel<DUAL,
//     AFFINE, STATS> (its design is written above the kernel). A is <false,
//     false, false>, B <true, false, false>; D with the prologue <false,
//     true, true> (without scale <false, false, true>), D's dual form <true,
//     false, true>. The host plan is ops/conv3d.py:conv3d_same_fp32_plan;
//     run_ring checks it.
//   - weight gradient (C): the wgrad ring body, wgrad_fp32_ring_kernel<DUAL>
//     (its design is written above it), planned by
//     ops/conv3d.py:conv3d_same_wgrad_fp32_plan; run_wgrad checks the plan.
//
// Layouts: x, a, b: (N, Z, Y, X, C) fp32 contiguous; w: the prepared layout
// of ops/conv3d.py:prepare_conv3d_weight in fp32, (kchunks, 27, 16, CoutP)
// with each input's channels filling whole 16-row K chunks and CoutP a
// multiple of 32; bias (Cout,) fp32 or null; out (N, Z, Y, X, Cout) fp32;
// g (N, Z, Y, X, Cout) fp32; dw (Cout, Ca + Cb, 3, 3, 3) fp32.
#include <algorithm>

#include "common.cuh"

extern "C" {
// kernel E's fp32 stats pass (fused_norm.cu): D's stats where the plan splits K
long long mt_channel_stats_fp32_workspace(int n, long long s, int c);
int mt_channel_stats_fp32(const void* x, void* stats, void* ws, long long ws_bytes, int n,
                          long long s, int c, void* stream);
}

namespace {

using mt::cdiv;

constexpr int KCH = 16;  // rows of a prepared weight chunk (mt::KC)

// The ring bodies' boxes (z, y, x): 512 voxels, x a multiple of 8, y 8 or
// 16 (the forward's warp of 8 voxel groups spans 8 neighbouring rows); the
// same list as ops/conv3d.py:FP32_RING_BOXES, which picks one.
constexpr int kRingBoxes[][3] = {{8, 8, 8}, {4, 8, 16}, {4, 16, 8}, {2, 16, 16}, {2, 8, 32}};

bool known_box(int bz, int by, int bx) {
  for (const auto& k : kRingBoxes)
    if (k[0] == bz && k[1] == by && k[2] == bx) return true;
  return false;
}

constexpr int R_CK = 8;             // input channels a stage
constexpr int R_BN = 32;            // output channels a block
constexpr int R_SMEM_MAX = 232448;  // dynamic shared memory a block may take

// a box's halo row stride in floats: bx + 2 voxels of R_CK channels, + 4
__host__ __device__ constexpr int ring_row_stride(int bx) { return (bx + 2) * R_CK + 4; }

// Channels [c0, c0 + R_CK) of src (c channels, volume z, y, x) over the halo
// of the box at (nb, z0, y0, x0) (hz, hy, hx voxels) into dst, rows of stride
// rs, channels innermost, with cp.async of vec floats (16, 8 or 4 bytes);
// zero outside the volume and past channel c. Warps take the halo's lines,
// lanes their copy units.
__device__ __forceinline__ void stage_halo(float* dst, const float* __restrict__ src, int c,
                                           int c0, int vec, int rs, int z, int y, int x, int hz,
                                           int hy, int hx, int nb, int z0, int y0, int x0,
                                           int warp, int lane, int warps) {
  const int units = R_CK / vec, lg = units == 2 ? 1 : (units == 4 ? 2 : 3);
  const int per_line = hx * units;
  for (int l = warp; l < hz * hy; l += warps) {
    const int vz = l / hy, vy = l - vz * hy;
    const int gz = z0 + vz - 1, gy = y0 + vy - 1;
    const bool line_in = gz >= 0 && gz < z && gy >= 0 && gy < y;
    const float* s_line = src + ((((int64_t)nb * z + gz) * y + gy) * x) * c + c0;
    float* d_line = dst + l * rs;
    for (int u = lane; u < per_line; u += 32) {
      const int v = u >> lg, q = u & (units - 1);
      const int gx = x0 + v - 1, ch = q * vec;
      const bool in = line_in && gx >= 0 && gx < x && c0 + ch < c;
      const float* s = in ? s_line + (int64_t)gx * c + ch : src;
      float* d = d_line + v * R_CK + ch;
      if (vec == 4) {
        mt::cp_async16(d, s, in);
      } else if (vec == 2) {
        mt::cp_async8(d, s, in);
      } else {
        mt::cp_async4(d, s, in);
      }
    }
  }
}

// out[v, co] = bias[co] + the sum over splits of part[s, v, co], in split
// order (bias null: C's dw, count = its entries)
__global__ void conv_fp32_reduce_kernel(const float* __restrict__ part,
                                        const float* __restrict__ bias, float* __restrict__ out,
                                        long long count, int cout, int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < count;
       i += (long long)gridDim.x * blockDim.x) {
    float sum = bias != nullptr ? bias[i % cout] : 0.f;
    for (int s = 0; s < splits; ++s) sum += part[s * count + i];
    out[i] = sum;
  }
}

cudaError_t launch_reduce(const float* part, const float* bias, float* out, long long count,
                          int cout, int splits, cudaStream_t st) {
  const int rblocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  conv_fp32_reduce_kernel<<<rblocks, 256, 0, st>>>(part, bias, out, count, cout, splits);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// forward: kernels A, B and D on the ring body
// ---------------------------------------------------------------------------
//
// A block owns R_BN = 32 output channels (4 groups of 8) and walks 512-voxel
// boxes (bz, by, bx with bx a multiple of 8 and by 8 or 16) in a fixed
// order: boxes p, p + P, ... of the volume for its column block and its
// part of the K loop. Thread t owns 8 neighbouring voxels along x and 8
// output channels (64 sums): lane & 3 picks the channel group, the warp's 8
// voxel groups are 8 neighbouring y rows. Its K loop runs in stages of
// R_CK = 8 input channels of one box's halo, staged with cp.async into a
// ring of 2-3 slots: the copies of stage s + slots - 1 fly while stage s's
// FFMAs run, behind one barrier a stage. The halo keeps its channels
// innermost, as the tensor has them, so each copy moves 16, 8 or 4
// contiguous bytes; a halo row of bx + 2 voxels is padded by 4 floats so
// that a warp's 8 rows land on 8 distinct 16-byte bank groups. Per (input
// channel quad, dz, dy) a thread reads a 10-voxel window of float4s (4
// channels each) once and, per (dx, channel), two float4s of weights that
// every lane of its channel group shares: 768 FFMAs for 34 shared loads.
// The next step's window is read into a second set of registers while this
// step's FFMAs run (one block an SM leaves 2 warps a scheduler to hide the
// shared-memory latency). Weights are resident (the whole K loop's, loaded
// once per block) where they fit beside the ring and the block walks
// several boxes, else each stage carries its chunk's 27 x 8 x 32 weights
// beside the halo. Small grids split the K loop over blocks to fill one
// wave; the splits' fp32 partials are added in split order by
// conv_fp32_reduce_kernel.
//
// Kernel D's switches:
//   - AFFINE, the prologue lrelu(x * scale[n, c] + shift[n, c]) (product and
//     sum rounded apart, __fmul_rn then __fadd_rn, as the plain version
//     rounds them) applied in shared memory to each staged element inside
//     the volume and below the input's channels once its copy has landed;
//     the SAME halo, the far edges and the padding channels stay 0. A box
//     lies in one sample, so a stage needs 8 scales and shifts. With 3 ring
//     slots the prologue runs one stage ahead (stage s + 1's, after the
//     barrier that lands it, while stage s's products run: one barrier a
//     stage, as A's); with 2 it runs on stage s after its barrier, then a
//     second barrier.
//   - STATS: each box's per-channel sum and sum of squares of out (after the
//     bias, over its in-volume voxels): the 8 lanes of a channel group by a
//     butterfly, then the 8 warps in order through shared memory, into row
//     (box) of a workspace (N, boxes of a sample, 2, Cout) that
//     fused_norm.cu's reduce_rows adds in box order: deterministic, whatever
//     the grid. Only with one K split: where the plan splits K, the body
//     runs without STATS, conv_fp32_reduce_kernel writes out, and kernel
//     E's fp32 stats pass (mt_channel_stats_fp32) reads it.

constexpr int R_THREADS = 256;
constexpr int R_TM = 8;                      // voxels along x a thread
constexpr int R_WCHUNK = 27 * R_CK * R_BN;   // floats of one stage's weights
constexpr int R_STATS = (R_THREADS / 32) * 2 * R_BN;  // floats of STATS' warp partials

struct RParams {
  const float* in[2];
  int cin[2];
  int chunks0, chunks;  // R_CK-chunks of input a, of both
  int kchunk0_b;        // first prepared 16-row chunk of input b
  const float* w;
  const float* bias;    // null when splits > 1 (the reduce adds it)
  float* out;           // out, or the partials (splits, voxels, Cout)
  int cout, coutp;
  int n, z, y, x;
  int bz, by, bx, gz, gy, gx;
  int boxes;            // N * the boxes of a sample
  int per_split;        // chunks of a split
  int grid_p;           // blocks along the boxes
  int resident, stages, vec, store4;
  int rs, halo;         // halo row stride and floats of one stage's halo
  int mode;             // 0 whole, 1 copies only, 2 products only (the probe's forms)
  const float* scale;   // AFFINE: (N, cin[0]) each
  const float* shift;
  float slope;
  float* part;          // STATS: (N * boxes of a sample, 2, Cout) rows
};

template <bool DUAL, bool AFFINE, bool STATS>
__global__ void __launch_bounds__(R_THREADS, 1) conv_fp32_ring_kernel(RParams p) {
  extern __shared__ float4 ring_smem4[];
  float* smem = reinterpret_cast<float*>(ring_smem4);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int cb = blockIdx.y, split = blockIdx.z;
  const int co0 = cb * R_BN;
  const int k0 = split * p.per_split;
  const int nk = min(p.per_split, p.chunks - k0);
  const int items = (p.boxes - (int)blockIdx.x + p.grid_p - 1) / p.grid_p;
  const int total = items * nk;
  const int hx = p.bx + 2, hy = p.by + 2, hz = p.bz + 2;
  const int wslot = p.resident ? 0 : R_WCHUNK;
  float* res = smem;  // resident weights: nk chunks
  float* ring = smem + (p.resident ? nk * R_WCHUNK : 0);
  const int slot_floats = p.halo + wslot;
  float* red = ring + p.stages * slot_floats;  // STATS: the warps' partials

  // the box of item i (block boxes blockIdx.x + i * grid_p)
  auto box_of = [&](int i, int* nb, int* z0, int* y0, int* x0) {
    int b = blockIdx.x + i * p.grid_p;
    const int per = p.gz * p.gy * p.gx;
    *nb = b / per;
    b -= *nb * per;
    const int bxi = b % p.gx;
    b /= p.gx;
    *x0 = bxi * p.bx;
    *y0 = (b % p.gy) * p.by;
    *z0 = (b / p.gy) * p.bz;
  };

  // the 27 x R_CK x R_BN weights of chunk k into dst ([tap][ci][co])
  auto load_weights = [&](float* dst, int k) {
    const int s = DUAL && k >= p.chunks0;
    const int j = k - (s ? p.chunks0 : 0);
    const int kc = (s ? p.kchunk0_b : 0) + (j >> 1), r0 = (j & 1) * R_CK;
    const float* src = p.w + ((int64_t)kc * 27 * KCH + r0) * p.coutp + co0;
    for (int i = t; i < 27 * R_CK * (R_BN / 4); i += R_THREADS) {
      const int row = i >> 3, c4 = (i & 7) * 4;  // row = tap * R_CK + ci
      const int tap = row >> 3, ci = row & 7;
      mt::cp_async16(dst + row * R_BN + c4, src + (int64_t)(tap * KCH + ci) * p.coutp + c4,
                     true);
    }
  };

  // stage s: chunk k0 + s % nk of item s / nk, its halo (and weights) into
  // slot s % stages. The halo walk is stage_halo's, written out here: called
  // through the function, B's instantiation ran 2% slower on an H100.
  auto produce = [&](int s) {
    const int i = s / nk, k = k0 + s - i * nk;
    float* slot = ring + (s % p.stages) * slot_floats;
    if (!p.resident) load_weights(slot + p.halo, k);
    int nb, z0, y0, x0;
    box_of(i, &nb, &z0, &y0, &x0);
    const int si = DUAL && k >= p.chunks0;
    const int c = p.cin[si], c0 = (k - (si ? p.chunks0 : 0)) * R_CK;
    const float* src = p.in[si];
    const int units = R_CK / p.vec, lg = units == 2 ? 1 : (units == 4 ? 2 : 3);
    const int per_line = hx * units;
    for (int l = warp; l < hz * hy; l += R_THREADS / 32) {
      const int vz = l / hy, vy = l - vz * hy;
      const int gz = z0 + vz - 1, gy = y0 + vy - 1;
      const bool line_in = gz >= 0 && gz < p.z && gy >= 0 && gy < p.y;
      const float* s_line = src + ((((int64_t)nb * p.z + gz) * p.y + gy) * p.x) * c + c0;
      float* d_line = slot + l * p.rs;
      for (int u = lane; u < per_line; u += 32) {
        const int v = u >> lg, q = u & (units - 1);
        const int gx = x0 + v - 1, ch = q * p.vec;
        const bool in = line_in && gx >= 0 && gx < p.x && c0 + ch < c;
        const float* s = in ? s_line + (int64_t)gx * c + ch : src;
        float* d = d_line + v * R_CK + ch;
        if (p.vec == 4) {
          mt::cp_async16(d, s, in);
        } else if (p.vec == 2) {
          mt::cp_async8(d, s, in);
        } else {
          mt::cp_async4(d, s, in);
        }
      }
    }
  };

  // D's prologue on stage s in place: lrelu(v * scale + shift) of every
  // element inside the volume and below channel c; the rest stays 0. A
  // thread's float4s keep one channel quad (the stride and a line's 2 a
  // voxel are even), so it reads its 4 scales and shifts once.
  auto prologue = [&](int s) {
    const int i = s / nk, k = k0 + s - i * nk;
    float* slot = ring + (s % p.stages) * slot_floats;
    int nb, z0, y0, x0;
    box_of(i, &nb, &z0, &y0, &x0);
    const int c = p.cin[0], q = t & 1, cq = k * R_CK + q * 4;
    float sc[4], sh[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = cq + j < c;
      sc[j] = ok ? p.scale[(int64_t)nb * c + cq + j] : 0.f;
      sh[j] = ok ? p.shift[(int64_t)nb * c + cq + j] : 0.f;
    }
    // float4 u = t, t + R_THREADS, ... of the halo: line l (vz, vy), unit r
    // of the line, stepped without dividing
    const int per_line = hx * 2, dl = R_THREADS / per_line, dr = R_THREADS - dl * per_line;
    int l = t / per_line, r = t - l * per_line;
    int vz = l / hy, vy = l - vz * hy;
    for (int u = t; u < hz * hy * per_line; u += R_THREADS) {
      const int v = r >> 1;
      const int gz = z0 + vz - 1, gy = y0 + vy - 1, gx = x0 + v - 1;
      if (gz >= 0 && gz < p.z && gy >= 0 && gy < p.y && gx >= 0 && gx < p.x) {
        float4* e = reinterpret_cast<float4*>(slot + l * p.rs + v * R_CK + q * 4);
        float f[4] = {e->x, e->y, e->z, e->w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (cq + j < c) {
            const float a = __fadd_rn(__fmul_rn(f[j], sc[j]), sh[j]);
            f[j] = a >= 0.f ? a : a * p.slope;
          }
        }
        *e = make_float4(f[0], f[1], f[2], f[3]);
      }
      r += dr;
      l += dl;
      vy += dl;
      if (r >= per_line) {
        r -= per_line;
        ++l;
        ++vy;
      }
      while (vy >= hy) {
        vy -= hy;
        ++vz;
      }
    }
  };

  // this thread's voxels and channels
  const int cg = lane & 3;
  const int vg = warp * 8 + (lane >> 2);
  const int vy = vg % p.by, rest = vg / p.by;
  const int nxg = p.bx / R_TM;
  const int gxi = rest % nxg, vz = rest / nxg;
  const int base = (vz * hy + vy) * p.rs + gxi * R_TM * R_CK;

  float acc[R_TM][8];
#pragma unroll
  for (int m = 0; m < R_TM; ++m)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[m][c] = 0.f;

  // the prologue one stage ahead: 3 slots, so stage s + 1 has landed at the
  // top of step s (wait_group 0) while stage s + 2 flies
  const bool ahead = AFFINE && p.stages == 3;
  if (total > 0 && p.resident && p.mode != 2)
    for (int k = 0; k < nk; ++k) load_weights(res + k * R_WCHUNK, k0 + k);
  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < total && p.mode != 2) produce(s);
    mt::cp_async_commit();
  }
  for (int s = 0; s < total; ++s) {
    if (p.stages == 3 && !ahead) {
      mt::cp_async_wait<1>();
    } else {
      mt::cp_async_wait<0>();
    }
    __syncthreads();  // stage s landed for all; slot (s - 1) % stages is free
    if (s + p.stages - 1 < total && p.mode != 2) produce(s + p.stages - 1);
    mt::cp_async_commit();
    if constexpr (AFFINE) {
      if (p.mode != 2) {
        if (!ahead || s == 0) {
          prologue(s);
          __syncthreads();
        }
        if (ahead && s + 1 < total) prologue(s + 1);
      }
    }
    const int i = s / nk, kk = s - i * nk;
    if (p.mode != 1) {
      const float* slot = ring + (s % p.stages) * slot_floats;
      const float* wsm = (p.resident ? res + kk * R_WCHUNK : slot + p.halo) + cg * 8;
      const float* xs = slot + base;
      // step j of the stage: channel quad j / 9, (dz, dy) = j % 9; each
      // step's window is loaded one step ahead, into the other buffer
      auto window = [&](float4* a, int j) {
        const int ciq = j >= 9 ? 4 : 0, dzy = j - (j >= 9 ? 9 : 0);
        const int dz = dzy / 3, dy = dzy - dz * 3;
        const float* xp = xs + (dz * hy + dy) * p.rs + ciq;
#pragma unroll
        for (int q = 0; q < R_TM + 2; ++q) a[q] = *reinterpret_cast<const float4*>(xp + q * R_CK);
      };
      auto products = [&](const float4* a, int j) {
        const int ciq = j >= 9 ? 4 : 0, dzy = j - (j >= 9 ? 9 : 0);
        const float* wp = wsm + (dzy * 3 * R_CK + ciq) * R_BN;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
          for (int ci = 0; ci < 4; ++ci) {
            const float4 w0 = *reinterpret_cast<const float4*>(wp + (dx * R_CK + ci) * R_BN);
            const float4 w1 = *reinterpret_cast<const float4*>(wp + (dx * R_CK + ci) * R_BN + 4);
            const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int m = 0; m < R_TM; ++m) {
              const float4 av = a[m + dx];
              const float xv = ci == 0 ? av.x : (ci == 1 ? av.y : (ci == 2 ? av.z : av.w));
#pragma unroll
              for (int c = 0; c < 8; ++c) acc[m][c] = fmaf(xv, wv[c], acc[m][c]);
            }
          }
        }
      };
      static_assert(R_CK == 8, "a stage is two channel quads of 9 (dz, dy) steps");
      float4 a0[R_TM + 2], a1[R_TM + 2];
      window(a0, 0);
#pragma unroll 1
      for (int j = 0; j < 18; j += 2) {
        window(a1, j + 1);
        products(a0, j);
        if (j + 2 < 18) window(a0, j + 2);
        products(a1, j + 1);
      }
    }
    if (kk != nk - 1) continue;
    // the item's last chunk: write its box's sums (+ bias) and start again
    int nb, z0, y0, x0;
    box_of(i, &nb, &z0, &y0, &x0);
    const int oz = z0 + vz, oy = y0 + vy, ox0 = x0 + gxi * R_TM, co = co0 + cg * 8;
    float bsum[8], bsq[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) bsum[c] = bsq[c] = 0.f;
    if (oz < p.z && oy < p.y && co < p.cout) {
      float bv[8];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        bv[c] = p.bias != nullptr && co + c < p.cout ? p.bias[co + c] : 0.f;
      float* dst = p.out + (int64_t)split * p.n * p.z * p.y * p.x * p.cout +
                   ((((int64_t)nb * p.z + oz) * p.y + oy) * p.x + ox0) * p.cout + co;
#pragma unroll
      for (int m = 0; m < R_TM; ++m) {
        if (ox0 + m < p.x) {
          float* row = dst + (int64_t)m * p.cout;
          if (p.store4) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (co + 4 * h < p.cout)
                *reinterpret_cast<float4*>(row + 4 * h) =
                    make_float4(acc[m][4 * h] + bv[4 * h], acc[m][4 * h + 1] + bv[4 * h + 1],
                                acc[m][4 * h + 2] + bv[4 * h + 2],
                                acc[m][4 * h + 3] + bv[4 * h + 3]);
          } else {
#pragma unroll
            for (int c = 0; c < 8; ++c)
              if (co + c < p.cout) row[c] = acc[m][c] + bv[c];
          }
          if constexpr (STATS) {
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const float v = acc[m][c] + bv[c];
              bsum[c] += v;
              bsq[c] = fmaf(v, v, bsq[c]);
            }
          }
        }
      }
    }
    if constexpr (STATS) {
      // the 8 voxel groups of a warp sharing a channel group, then the 8
      // warps in order, into row (box) of part
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          bsum[c] += __shfl_xor_sync(0xffffffffu, bsum[c], o);
          bsq[c] += __shfl_xor_sync(0xffffffffu, bsq[c], o);
        }
      }
      if (lane < 4) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          red[warp * 2 * R_BN + cg * 8 + c] = bsum[c];
          red[warp * 2 * R_BN + R_BN + cg * 8 + c] = bsq[c];
        }
      }
      __syncthreads();
      if (t < 2 * R_BN && co0 + (t & (R_BN - 1)) < p.cout) {
        float v = 0.f;
        for (int w = 0; w < R_THREADS / 32; ++w) v += red[w * 2 * R_BN + t];
        const int b = blockIdx.x + i * p.grid_p;
        p.part[((int64_t)b * 2 + (t >> 5)) * p.cout + co0 + (t & (R_BN - 1))] = v;
      }
      __syncthreads();  // red is free for the next box
    }
#pragma unroll
    for (int m = 0; m < R_TM; ++m)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[m][c] = 0.f;
  }
  mt::cp_async_wait_all();
}

// Bytes of the stats workspace of D's forms at these sizes and this box and
// K split count: the boxes' rows and reduce_rows' scratch (one split), or
// kernel E's fp32 stats pass's (several); -1 where neither takes them.
long long stats_bytes(int n, int z, int y, int x, int cout, int bz, int by, int bx,
                      int splits) {
  if (splits > 1) return mt_channel_stats_fp32_workspace(n, (long long)z * y * x, cout);
  const long long per = (long long)cdiv(z, bz) * cdiv(y, by) * cdiv(x, bx);
  if (per > 0x7fffffffLL) return -1;
  const long long red = mt::reduce_rows_workspace(n, (int)per, 2 * cout);
  if (red < 0) return -1;
  return 4LL * n * per * 2 * cout + red;
}

struct RingCall {
  const void *a, *b, *w, *bias, *scale, *shift;
  float slope;
  void *out, *stats, *ws;
  long long ws_bytes;
  int n, z, y, x, ca, cb, cout, coutp, bz, by, bx, splits, resident, stages, grid_p, mode;
};

template <bool DUAL, bool AFFINE, bool STATS>
cudaError_t launch_ring(const RParams& p, int splits, long long smem, cudaStream_t st) {
  const auto kernel = conv_fp32_ring_kernel<DUAL, AFFINE, STATS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.grid_p, cdiv(p.cout, R_BN), splits), R_THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

// Kernel A (b null, cb 0), B, or with c.stats D (with the prologue where
// scale is given, one input only) on the ring body with the plan that
// ops/conv3d.py:conv3d_same_fp32_plan makes: the box, K splits (partials
// at the head of ws, then conv_fp32_reduce_kernel), resident weights, ring
// stages and blocks along the boxes; D's stats workspace follows the
// partials. Refuses a plan it cannot run.
int run_ring(const RingCall& c, cudaStream_t st) {
  const bool stats = c.stats != nullptr;
  if (c.ca <= 0 || c.cb < 0 || c.cout <= 0 || c.coutp < c.cout || c.coutp % R_BN || c.n <= 0 ||
      c.z <= 0 || c.y <= 0 || c.x <= 0 || (c.cb > 0) != (c.b != nullptr) || c.stages < 2 ||
      c.stages > 3 || (c.resident != 0 && c.resident != 1) || c.mode < 0 || c.mode > 2 ||
      (c.scale == nullptr) != (c.shift == nullptr) || (c.scale != nullptr && c.cb > 0) ||
      (c.scale != nullptr && !stats) || !known_box(c.bz, c.by, c.bx))
    return (int)cudaErrorInvalidValue;
  RParams p{};
  p.in[0] = static_cast<const float*>(c.a);
  p.in[1] = static_cast<const float*>(c.b);
  p.cin[0] = c.ca;
  p.cin[1] = c.cb;
  p.chunks0 = cdiv(c.ca, R_CK);
  p.chunks = p.chunks0 + (c.cb > 0 ? cdiv(c.cb, R_CK) : 0);
  p.kchunk0_b = cdiv(c.ca, KCH);
  p.w = static_cast<const float*>(c.w);
  p.cout = c.cout;
  p.coutp = c.coutp;
  p.n = c.n;
  p.z = c.z;
  p.y = c.y;
  p.x = c.x;
  p.bz = c.bz;
  p.by = c.by;
  p.bx = c.bx;
  p.gz = cdiv(c.z, c.bz);
  p.gy = cdiv(c.y, c.by);
  p.gx = cdiv(c.x, c.bx);
  const long long boxes = (long long)c.n * p.gz * p.gy * p.gx;
  const int splits = c.splits;
  if (splits < 1 || splits > p.chunks || boxes > 0x7fffffffLL || c.grid_p < 1 ||
      c.grid_p > boxes)
    return (int)cudaErrorInvalidValue;
  p.boxes = (int)boxes;
  p.per_split = cdiv(p.chunks, splits);
  if (cdiv(p.chunks, p.per_split) != splits || (c.resident && splits > 1))
    return (int)cudaErrorInvalidValue;
  p.grid_p = c.grid_p;
  p.resident = c.resident;
  p.stages = c.stages;
  const bool even2 = c.ca % 2 == 0 && c.cb % 2 == 0;
  p.vec = c.ca % 4 == 0 && c.cb % 4 == 0 ? 4 : (even2 ? 2 : 1);
  p.rs = ring_row_stride(c.bx);
  p.halo = (c.bz + 2) * (c.by + 2) * p.rs;
  p.mode = c.mode;
  const bool body_stats = stats && splits == 1;
  const long long smem =
      4LL * ((c.resident ? p.per_split * R_WCHUNK : 0) +
             (long long)c.stages * (p.halo + (c.resident ? 0 : R_WCHUNK)) +
             (body_stats ? R_STATS : 0));
  if (smem > R_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const long long count = (long long)c.n * c.z * c.y * c.x * c.cout;
  const long long part_bytes = splits > 1 ? 4LL * splits * count : 0;
  const long long st_bytes =
      stats ? stats_bytes(c.n, c.z, c.y, c.x, c.cout, c.bz, c.by, c.bx, splits) : 0;
  if (st_bytes < 0 || c.ws_bytes < part_bytes + st_bytes ||
      (part_bytes + st_bytes > 0 && c.ws == nullptr))
    return (int)cudaErrorInvalidValue;
  float* ws = static_cast<float*>(c.ws);
  float* tail = part_bytes + st_bytes > 0 ? ws + part_bytes / 4 : nullptr;  // D's stats ws
  p.out = static_cast<float*>(splits > 1 ? ws : c.out);
  p.bias = splits > 1 ? nullptr : static_cast<const float*>(c.bias);
  p.store4 = c.cout % 4 == 0 && reinterpret_cast<uintptr_t>(p.out) % 16 == 0;
  p.scale = static_cast<const float*>(c.scale);
  p.shift = static_cast<const float*>(c.shift);
  p.slope = c.slope;
  p.part = body_stats ? tail : nullptr;
  const bool affine = c.scale != nullptr, dual = c.cb > 0;
  cudaError_t err;
  if (!stats) {
    err = dual ? launch_ring<true, false, false>(p, splits, smem, st)
               : launch_ring<false, false, false>(p, splits, smem, st);
  } else if (splits > 1) {  // D with a split K loop: the stats come after the reduce
    err = affine ? launch_ring<false, true, false>(p, splits, smem, st)
                 : (dual ? launch_ring<true, false, false>(p, splits, smem, st)
                         : launch_ring<false, false, false>(p, splits, smem, st));
  } else {
    err = affine ? launch_ring<false, true, true>(p, splits, smem, st)
                 : (dual ? launch_ring<true, false, true>(p, splits, smem, st)
                         : launch_ring<false, false, true>(p, splits, smem, st));
  }
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {
    err = launch_reduce(ws, static_cast<const float*>(c.bias), static_cast<float*>(c.out), count,
                        c.cout, splits, st);
    if (err != cudaSuccess || !stats) return (int)err;
    return mt_channel_stats_fp32(c.out, c.stats, tail, st_bytes, c.n,
                                 (long long)c.z * c.y * c.x, c.cout, st);
  }
  if (!stats) return (int)cudaSuccess;
  const int per = p.gz * p.gy * p.gx;
  return (int)mt::reduce_rows(tail, static_cast<float*>(c.stats),
                              tail + (long long)c.n * per * 2 * c.cout, c.n, per, 2 * c.cout, st);
}

// ---------------------------------------------------------------------------
// weight gradient: kernel C's fp32 form on the wgrad ring body
// ---------------------------------------------------------------------------
//
// A block's output tile is one 8-channel chunk of the input (of a or b) by
// 32 output channels by the 27 taps: 6912 sums, its share of dw. Its
// reduction runs over the voxels, 512-voxel boxes at a time: a work unit is
// (tile, split), split a run of consecutive boxes, and persistent blocks
// (at most one an SM) walk units p, p + grid, ... box by box through a
// cp.async ring of 2 stages (3 of a 512-voxel box's stages do not fit in
// shared memory). A stage holds one box's x halo (8 input
// channels innermost, rows padded by 4 floats, 16-, 8- or 4-byte copies by
// C % 4 / 2, the forward's addressing) and that box's g rows (32 output
// channels a voxel, 16-byte copies where Cout % 4 == 0); the copies of the
// next stages fly while this one's FFMAs run, behind one barrier a stage.
//
// A thread owns a register tile of outer products: 4 input channels x 8
// output channels x the 3 dx taps of one (dz, dy), 96 sums. 72 such tiles
// (9 (dz, dy) x 4 output octets x 2 input quads) cover the block's output;
// the block's 384 threads (12 warps, 3 a scheduler) hold 5 line groups of
// 72 tiles, each group taking every 5th line (z, y) of the box, and 24
// threads that only copy (4 groups in 9 warps would leave one scheduler 3
// warps of products and the others 2). Along a line a
// thread slides a window of three float4s of x (4 channels at x - 1, x,
// x + 1: one new float4 a voxel) against two float4s of g (8 output
// channels at x): 96 FFMAs for 3 shared loads. The lanes of a warp share a
// line, so the g loads broadcast (4 addresses a warp) and the x loads hit
// 8. Lines and voxels past the volume's edge (g zero there) are skipped.
//
// At a unit's end the line groups' partial tiles are added in shared
// memory (the finished stage's slot, 3 tiles at a time) in a fixed order,
// group 0 + 1 + 2 + 3 + 4, and written to dw, or, where the plan splits the
// voxel axis (only to fill one wave: at 8^3 and 4^3 the tiles alone fill
// the card), to the split's partial dw, added in split order by
// conv_fp32_reduce_kernel. No atomics: two calls are bit-equal.

constexpr int W_TILES = 72;     // (dz, dy) x 4 output octets x 2 input quads
constexpr int W_GROUPS = 5;     // line groups
constexpr int W_THREADS = 384;  // 12 warps: the 5 groups' 360 threads, 24 that only copy
constexpr int W_ROUND = 3;      // partial tiles the flush adds through a slot at a time
constexpr int W_STAGES = 2;     // ring slots
constexpr int W_SUMS = 96;                     // 3 dx x 4 input x 8 output channels
constexpr int W_BOX = 512;                     // voxels of a box

struct WParams {
  const float* in[2];
  int cin[2];
  int chunks0;       // R_CK-chunks of input a
  const float* g;
  float* out;        // dw, or the partials (splits, Cout, Cin, 27)
  int cout, cin_total;
  int n, z, y, x;
  int bz, by, bx, gz, gy, gx;
  int boxes;         // N * the boxes of a sample
  int per_split;     // boxes of a split
  int cols, tiles, units;
  int vec, gvec;
  int rs, halo;      // halo row stride and floats of one stage's halo
  int mode;          // 0 whole, 1 copies only, 2 products only (the probe's forms)
};

template <bool DUAL>
__global__ void __launch_bounds__(W_THREADS, 1) wgrad_fp32_ring_kernel(WParams p) {
  extern __shared__ float4 wring_smem4[];
  float* ring = reinterpret_cast<float*>(wring_smem4);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int hx = p.bx + 2, hy = p.by + 2, hz = p.bz + 2;
  const int slot_floats = p.halo + W_BOX * R_BN;
  const int per = p.gz * p.gy * p.gx;
  const int lines = p.bz * p.by;

  // unit u = split * tiles + tile: its boxes [b, e); tile = chunk * cols + column block
  auto unit_boxes = [&](int u, int* b, int* e) {
    *b = (u / p.tiles) * p.per_split;
    *e = min(p.boxes, *b + p.per_split);
  };
  auto box_of = [&](int b, int* nb, int* z0, int* y0, int* x0) {
    *nb = b / per;
    b -= *nb * per;
    *x0 = (b % p.gx) * p.bx;
    b /= p.gx;
    *y0 = (b % p.gy) * p.by;
    *z0 = (b / p.gy) * p.bz;
  };
  // the next box of a walk over this block's units
  auto advance = [&](int& u, int& b, int& e) {
    if (++b == e) {
      u += gridDim.x;
      if (u < p.units) unit_boxes(u, &b, &e);
    }
  };

  // box b of unit u: its x halo (the unit's input chunk) and g rows (the
  // unit's 32 output channels) into slot
  auto produce = [&](int u, int b, float* slot) {
    const int tile = u % p.tiles, chunk = tile / p.cols, co0 = (tile % p.cols) * R_BN;
    const int si = DUAL && chunk >= p.chunks0;
    int nb, z0, y0, x0;
    box_of(b, &nb, &z0, &y0, &x0);
    stage_halo(slot, p.in[si], p.cin[si], (chunk - (si ? p.chunks0 : 0)) * R_CK, p.vec, p.rs,
               p.z, p.y, p.x, hz, hy, hx, nb, z0, y0, x0, warp, lane, W_THREADS / 32);
    float* gs = slot + p.halo;
    const int units = R_BN / p.gvec, lg = units == 8 ? 3 : (units == 16 ? 4 : 5);
    const int per_line = p.bx * units;
    for (int l = warp; l < lines; l += W_THREADS / 32) {
      const int vz = l / p.by, vy = l - vz * p.by;
      const int gz = z0 + vz, gy = y0 + vy;
      const bool line_in = gz < p.z && gy < p.y;
      const float* s_line = p.g + (((int64_t)nb * p.z + gz) * p.y + gy) * p.x * p.cout + co0;
      float* d_line = gs + l * p.bx * R_BN;
      for (int q = lane; q < per_line; q += 32) {
        const int v = q >> lg, ch = (q & (units - 1)) * p.gvec;
        const bool in = line_in && x0 + v < p.x && co0 + ch < p.cout;
        const float* s = in ? s_line + (int64_t)(x0 + v) * p.cout + ch : p.g;
        float* d = d_line + v * R_BN + ch;
        if (p.gvec == 4) {
          mt::cp_async16(d, s, in);
        } else if (p.gvec == 2) {
          mt::cp_async8(d, s, in);
        } else {
          mt::cp_async4(d, s, in);
        }
      }
    }
  };

  // this thread's tile: line group, (dz, dy), output octet, input quad
  const int grp = t / W_TILES, r = t - grp * W_TILES;
  const int dzdy = r >> 3, cog = (r >> 1) & 3, ciq = r & 1;
  const int dz = dzdy / 3, dy = dzdy - dz * 3;
  float acc[W_SUMS];  // [dx][input channel][output channel]
#pragma unroll
  for (int e = 0; e < W_SUMS; ++e) acc[e] = 0.f;

  auto outer = [&](int dx, const float4& xv, const float4& g0, const float4& g1) {
    const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
    const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        acc[(dx * 4 + i) * 8 + c] = fmaf(xs[i], gv[c], acc[(dx * 4 + i) * 8 + c]);
  };

  // the products of box b (in slot): this group's lines inside the volume,
  // each slid along x over the voxels inside it (whole groups of 8)
  auto products = [&](int b, const float* slot) {
    if (grp >= W_GROUPS) return;  // the threads that only copy
    int nb, z0, y0, x0;
    box_of(b, &nb, &z0, &y0, &x0);
    const int nx = min(p.bx, p.x - x0);
    const float* xs = slot + (dz * hy + dy) * p.rs + ciq * 4;
    const float* gs = slot + p.halo + cog * 8;
#pragma unroll 1
    for (int l = grp; l < lines; l += W_GROUPS) {
      const int vz = l / p.by, vy = l - vz * p.by;
      if (z0 + vz >= p.z || y0 + vy >= p.y) continue;
      const float* xl = xs + (vz * hy + vy) * p.rs;
      const float* gl = gs + l * p.bx * R_BN;
      float4 x0v = *reinterpret_cast<const float4*>(xl);
      float4 x1v = *reinterpret_cast<const float4*>(xl + R_CK);
#pragma unroll 1
      for (int v8 = 0; v8 < nx; v8 += 8) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int vx = v8 + j;
          const float4 x2v = *reinterpret_cast<const float4*>(xl + (vx + 2) * R_CK);
          const float4 g0 = *reinterpret_cast<const float4*>(gl + vx * R_BN);
          const float4 g1 = *reinterpret_cast<const float4*>(gl + vx * R_BN + 4);
          outer(0, x0v, g0, g1);
          outer(1, x1v, g0, g1);
          outer(2, x2v, g0, g1);
          x0v = x1v;
          x1v = x2v;
        }
      }
    }
  };

  // unit u's tile, summed over the line groups in order through slot (free:
  // its products are done), into dw or the split's partial dw
  auto flush = [&](int u, float* slot) {
    __syncthreads();  // every group's products of this slot are done
    // groups 1.. through the slot, W_ROUND at a time, group 0 adding each
    // round's in order
#pragma unroll
    for (int g0 = 1; g0 < W_GROUPS; g0 += W_ROUND) {
      if (g0 > 1) __syncthreads();  // group 0 has read the previous round
      if (grp >= g0 && grp < g0 + W_ROUND) {
#pragma unroll
        for (int e = 0; e < W_SUMS; ++e) slot[((grp - g0) * W_SUMS + e) * W_TILES + r] = acc[e];
      }
      __syncthreads();
      if (grp == 0) {
#pragma unroll
        for (int e = 0; e < W_SUMS; ++e) {
#pragma unroll
          for (int g = 0; g < W_ROUND && g0 + g < W_GROUPS; ++g)
            acc[e] += slot[(g * W_SUMS + e) * W_TILES + r];
        }
      }
    }
    if (grp == 0) {
      const int split = u / p.tiles, tile = u % p.tiles;
      const int chunk = tile / p.cols, co0 = (tile % p.cols) * R_BN;
      const int si = DUAL && chunk >= p.chunks0;
      const int c0 = (chunk - (si ? p.chunks0 : 0)) * R_CK, off = si ? p.cin[0] : 0;
      float* dst = p.out + (int64_t)split * 27 * p.cin_total * p.cout;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ci = c0 + ciq * 4 + i;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int e = (dx * 4 + i) * 8 + c, co = co0 + cog * 8 + c;
            if (ci < p.cin[si] && co < p.cout)
              dst[((int64_t)co * p.cin_total + off + ci) * 27 + dzdy * 3 + dx] = acc[e];
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < W_SUMS; ++e) acc[e] = 0.f;
  };

  int pu = blockIdx.x, pb = 0, pe = 0;  // the producer's walk
  if (pu < p.units) unit_boxes(pu, &pb, &pe);
  if (pu < p.units) {
    if (p.mode != 2) produce(pu, pb, ring);
    advance(pu, pb, pe);
  }
  mt::cp_async_commit();
  int cu = blockIdx.x, cbx = 0, ce = 0;  // the consumer's walk
  if (cu < p.units) unit_boxes(cu, &cbx, &ce);
  static_assert(W_STAGES == 2, "one stage flies while the other's products run");
  for (int s = 0; cu < p.units; ++s) {
    mt::cp_async_wait<0>();
    __syncthreads();  // stage s landed for all; slot (s + 1) % 2 is free
    if (pu < p.units) {
      if (p.mode != 2) produce(pu, pb, ring + ((s + 1) % W_STAGES) * slot_floats);
      advance(pu, pb, pe);
    }
    mt::cp_async_commit();
    float* slot = ring + (s % W_STAGES) * slot_floats;
    if (p.mode != 1) products(cbx, slot);
    if (cbx + 1 == ce) flush(cu, slot);
    advance(cu, cbx, ce);
  }
  mt::cp_async_wait_all();
}

struct WPlan {
  int bz, by, bx, boxes, chunks, cols, tiles, splits, per_split, units, grid;
  long long smem, ws_bytes;
};

// The floats of a stage of the wgrad ring at box (bz, by, bx): the halo and
// the box's g rows.
long long wgrad_slot_floats(int bz, int by, int bx) {
  return (long long)(bz + 2) * (by + 2) * ring_row_stride(bx) + (long long)W_BOX * R_BN;
}

// The plan's rules (ops/conv3d.py:conv3d_same_wgrad_fp32_plan makes the
// same on the host): the box that wastes the fewest voxels (the first of
// ties); the voxel axis split only where the tiles leave SMs of one wave
// idle, into splits of whole boxes, none empty; one block an SM at most.
bool wgrad_plan(int n, int z, int y, int x, int ca, int cb, int cout, int sms, WPlan* w) {
  if (n <= 0 || z <= 0 || y <= 0 || x <= 0 || ca <= 0 || cb < 0 || cout <= 0 || sms <= 0)
    return false;
  long long best = -1;
  for (const auto& k : kRingBoxes) {
    const long long c = (long long)cdiv(z, k[0]) * cdiv(y, k[1]) * cdiv(x, k[2]);
    if (best < 0 || c < best) {
      best = c;
      w->bz = k[0];
      w->by = k[1];
      w->bx = k[2];
    }
  }
  if (best * n > 0x7fffffffLL) return false;
  w->boxes = (int)(best * n);
  w->chunks = cdiv(ca, R_CK) + (cb > 0 ? cdiv(cb, R_CK) : 0);
  w->cols = cdiv(cout, R_BN);
  w->tiles = w->chunks * w->cols;
  int splits = w->tiles >= sms ? 1 : std::min(w->boxes, sms / w->tiles);
  w->per_split = cdiv(w->boxes, splits);
  w->splits = cdiv(w->boxes, w->per_split);
  if ((long long)w->tiles * w->splits > 0x7fffffffLL) return false;
  w->units = w->tiles * w->splits;
  w->grid = std::min(w->units, sms);
  w->smem = 4LL * W_STAGES * wgrad_slot_floats(w->bz, w->by, w->bx);
  w->ws_bytes = w->splits == 1 ? 0 : 4LL * w->splits * 27 * (ca + cb) * cout;
  return w->smem <= R_SMEM_MAX;
}

// Kernel C's fp32 form with the plan of ops/conv3d.py:
// conv3d_same_wgrad_fp32_plan (box, splits, grid, stages: 2); refuses a
// plan it cannot run.
int run_wgrad(const void* a, const void* b, int ca, int cb, const void* gr, void* dw, void* ws,
              long long ws_bytes, int n, int z, int y, int x, int cout, int bz, int by, int bx,
              int splits, int grid, int stages, int mode, cudaStream_t st) {
  if (ca <= 0 || cb < 0 || cout <= 0 || n <= 0 || z <= 0 || y <= 0 || x <= 0 ||
      (cb > 0) != (b != nullptr) || !known_box(bz, by, bx) || stages != W_STAGES || mode < 0 ||
      mode > 2)
    return (int)cudaErrorInvalidValue;
  WParams p{};
  p.in[0] = static_cast<const float*>(a);
  p.in[1] = static_cast<const float*>(b);
  p.cin[0] = ca;
  p.cin[1] = cb;
  p.chunks0 = cdiv(ca, R_CK);
  p.g = static_cast<const float*>(gr);
  p.cout = cout;
  p.cin_total = ca + cb;
  p.n = n;
  p.z = z;
  p.y = y;
  p.x = x;
  p.bz = bz;
  p.by = by;
  p.bx = bx;
  p.gz = cdiv(z, bz);
  p.gy = cdiv(y, by);
  p.gx = cdiv(x, bx);
  const long long boxes = (long long)n * p.gz * p.gy * p.gx;
  const long long tiles = (long long)(p.chunks0 + (cb > 0 ? cdiv(cb, R_CK) : 0)) *
                          cdiv(cout, R_BN);
  if (boxes > 0x7fffffffLL || splits < 1 || splits > boxes || tiles * splits > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  p.boxes = (int)boxes;
  p.per_split = (int)cdiv(p.boxes, splits);
  p.cols = cdiv(cout, R_BN);
  p.tiles = (int)tiles;
  p.units = p.tiles * splits;
  if (cdiv(p.boxes, p.per_split) != splits || grid < 1 || grid > p.units)
    return (int)cudaErrorInvalidValue;
  p.vec = ca % 4 == 0 && cb % 4 == 0 ? 4 : (ca % 2 == 0 && cb % 2 == 0 ? 2 : 1);
  p.gvec = cout % 4 == 0 ? 4 : (cout % 2 == 0 ? 2 : 1);
  p.rs = ring_row_stride(bx);
  p.halo = (bz + 2) * (by + 2) * p.rs;
  p.mode = mode;
  const long long slot = wgrad_slot_floats(bz, by, bx);
  const long long smem = 4LL * W_STAGES * slot;
  // the flush adds the line groups' tiles through one slot
  if (smem > R_SMEM_MAX || slot < (long long)W_ROUND * W_SUMS * W_TILES)
    return (int)cudaErrorInvalidValue;
  const long long count = 27LL * (ca + cb) * cout;
  if (splits > 1 && (ws == nullptr || ws_bytes < 4LL * splits * count))
    return (int)cudaErrorInvalidValue;
  p.out = static_cast<float*>(splits > 1 ? ws : dw);
  const auto kernel = cb > 0 ? wgrad_fp32_ring_kernel<true> : wgrad_fp32_ring_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, W_THREADS, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)launch_reduce(static_cast<const float*>(ws), nullptr, static_cast<float*>(dw),
                            count, cout, splits, st);
}

}  // namespace

extern "C" {

// Kernel A's (b null, cb 0) or B's fp32 form on the ring body: out =
// conv(concat(a, b), w) + bias with the plan of
// ops/conv3d.py:conv3d_same_fp32_plan (ws: the K splits' partials, 4 *
// splits * N * Z * Y * X * Cout bytes when splits > 1); mode 0 (1: copies
// only, 2: products only, the probe's forms). Returns cudaGetLastError()
// after the launches (0 on success).
int mt_conv3d_same_fp32(const void* a, const void* b, const void* w, const void* bias,
                        void* out, void* ws, long long ws_bytes, int n, int z, int y, int x,
                        int ca, int cb, int cout, int coutp, int bz, int by, int bx, int splits,
                        int resident, int stages, int grid_p, int mode, void* stream) {
  RingCall c{a, b, w, bias, nullptr, nullptr, 0.f, out, nullptr, ws, ws_bytes,
             n, z, y, x, ca, cb, cout, coutp, bz, by, bx, splits, resident, stages, grid_p,
             mode};
  return run_ring(c, static_cast<cudaStream_t>(stream));
}

// Kernel D's fp32 form on the ring body: out = conv(concat(a, b), w) + bias
// with, where scale and shift (N, Ca) are given (b null), the prologue
// lrelu(a * scale + shift) on a (halo 0), and stats (N, 2, Cout) of out;
// the plan of ops/conv3d.py:conv3d_same_fp32_plan(..., stats=True), whose
// workspace_bytes ws holds; mode as mt_conv3d_same_fp32's.
int mt_conv3d_same_affine_fp32(const void* a, const void* b, const void* w, const void* bias,
                               const void* scale, const void* shift, float slope, void* out,
                               void* stats, void* ws, long long ws_bytes, int n, int z, int y,
                               int x, int ca, int cb, int cout, int coutp, int bz, int by,
                               int bx, int splits, int resident, int stages, int grid_p,
                               int mode, void* stream) {
  if (stats == nullptr) return (int)cudaErrorInvalidValue;
  RingCall c{a, b, w, bias, scale, shift, slope, out, stats, ws, ws_bytes,
             n, z, y, x, ca, cb, cout, coutp, bz, by, bx, splits, resident, stages, grid_p,
             mode};
  return run_ring(c, static_cast<cudaStream_t>(stream));
}

// Bytes of fp32 workspace kernel C's fp32 form takes at these sizes on the
// current card (the plan's rules): 0 where it writes dw directly (one
// split), -1 for sizes it does not take.
long long mt_conv3d_wgrad_fp32_workspace(int n, int z, int y, int x, int ca, int cb,
                                         int cout) {
  WPlan w;
  return wgrad_plan(n, z, y, x, ca, cb, cout, mt::sm_count(), &w) ? w.ws_bytes : -1;
}

// Kernel C's fp32 form: dw (Cout, Ca + Cb, 3, 3, 3) of the conv of
// concat(a, b) (b null, cb 0: of a) by g, with the plan of
// ops/conv3d.py:conv3d_same_wgrad_fp32_plan (ws: its workspace_bytes);
// mode as mt_conv3d_same_fp32's.
int mt_conv3d_wgrad_fp32(const void* a, const void* b, const void* g, void* dw, void* ws,
                         long long ws_bytes, int n, int z, int y, int x, int ca, int cb,
                         int cout, int bz, int by, int bx, int splits, int grid, int stages,
                         int mode, void* stream) {
  return run_wgrad(a, b, ca, cb, g, dw, ws, ws_bytes, n, z, y, x, cout, bz, by, bx, splits, grid,
                   stages, mode, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
