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
//     conv. It is the forward body below with two compile-time switches:
//     AFFINE applies the prologue to each element as the halo is staged
//     (x * s + t rounded apart, as the plain version rounds them, then the
//     activation; the halo and padding channels stay 0); STATS reduces each
//     block's 256 voxels x 32 channels of out (after the bias) to one row of
//     per-channel sums (warp shuffles, then the two warps of a channel
//     group in order) in a workspace (N, boxes, 2, Cout), and fused_norm.cu's
//     reduce_rows adds the rows in a fixed order: deterministic, no atomics.
//
// Plain FFMA on the CUDA cores, no TF32: TF32 rounds the inputs to 10
// mantissa bits, and the JAX package's fp32 reference does not. What bounds
// them on an H100 is fp32 arithmetic (67 TFLOP/s): a 32 -> 32 conv does 1728
// operations for every 256 bytes it must move, far above the card's ~20
// operations a byte in fp32. So the bodies keep the FFMA pipes fed from
// shared memory with few loads per FMA. Which body serves which form:
//   - forward of A and B (every fp32 A and B call, each dx included): the
//     ring body, conv_fp32_ring_kernel<DUAL> (its design is written above
//     the kernel): persistent blocks walk 512-voxel boxes with a cp.async
//     ring of 8-channel halo stages, weights resident where they fit,
//     8 voxels x 8 output channels a thread (768 FFMAs for 34 shared
//     loads), the K loop split over blocks only to fill one wave, the
//     splits added in a fixed order by conv_fp32_reduce_kernel. The host
//     plan is ops/conv3d.py:conv3d_same_fp32_plan; run_ring checks it.
//   - forward of D (its prologue and stats, and its dual form): the staged
//     body, conv_fp32_kernel<AFFINE, STATS> with STATS set: a block owns a
//     256-voxel box of the output and 32 output channels; it stages 8 input
//     channels of the box's halo and their 27 x 32 weights at a time in
//     shared memory (load, barrier, products, no overlap). A thread owns 4
//     neighbouring voxels along x and 8 output channels (32 sums): per
//     (channel, dz, dy) it reads a 6-voxel window of the halo once and two
//     float4s of weights per tap (the same for the whole warp: broadcast),
//     96 FMAs for 12 loads. A and B never launch it;
//   - weight gradient (C): a block owns 8 input channels, 32 output
//     channels and a contiguous run of boxes (the voxel axis is split over
//     blocks to fill the card); a thread owns one input channel, one (dz, dy)
//     and 4 output channels for the 3 dx taps (12 sums) and walks each line
//     of the box along x with a 3-voxel register window, 12 FMAs for one
//     halo load and one float4 of g. Each split writes its partial dw; a
//     second small kernel adds the splits in a fixed order (deterministic,
//     no atomics), or with one split the block writes dw directly.
//
// Layouts: x, a, b: (N, Z, Y, X, C) fp32 contiguous; w: the prepared layout
// of ops/conv3d.py:prepare_conv3d_weight in fp32, (kchunks, 27, 16, CoutP)
// with each input's channels filling whole 16-row K chunks and CoutP a
// multiple of 32; bias (Cout,) fp32 or null; out (N, Z, Y, X, Cout) fp32;
// g (N, Z, Y, X, Cout) fp32; dw (Cout, Ca + Cb, 3, 3, 3) fp32.
#include "common.cuh"

namespace {

using mt::cdiv;

constexpr int BN = 32;          // output channels a block
constexpr int CK = 8;           // input channels staged at once
constexpr int XS = 820;         // halo row stride: the largest halo (816) + 4, conflict-free
constexpr int KCH = 16;         // rows of a prepared weight chunk (mt::KC)

struct Box {
  int z, y, x;
};
// 256-voxel boxes with x a multiple of 4 and a halo of at most 816 voxels,
// smallest halo first (ties in wasted voxels keep the first)
constexpr Box kBoxes[] = {{4, 8, 8},  {8, 8, 4},  {8, 4, 8},  {4, 4, 16},
                          {16, 4, 4}, {4, 16, 4}, {2, 8, 16}, {2, 4, 32}};

long long pick_box(int z, int y, int x, Box* out) {
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

struct Geometry {
  int n, z, y, x;
  Box box;
  int gz, gy, gx;  // boxes along each axis
  long long boxes;  // boxes of one sample
};

Geometry geometry(int n, int z, int y, int x) {
  Geometry g{};
  g.n = n;
  g.z = z;
  g.y = y;
  g.x = x;
  g.boxes = pick_box(z, y, x, &g.box);
  g.gz = cdiv(z, g.box.z);
  g.gy = cdiv(y, g.box.y);
  g.gx = cdiv(x, g.box.x);
  return g;
}

// box index b (over all samples) -> sample and the box's first voxel
__device__ __forceinline__ void box_origin(const Geometry& g, long long b, int* nb, int* z0,
                                           int* y0, int* x0) {
  *nb = (int)(b / g.boxes);
  long long r = b - (long long)(*nb) * g.boxes;
  const int bx = (int)(r % g.gx);
  r /= g.gx;
  const int by = (int)(r % g.gy);
  const int bz = (int)(r / g.gy);
  *z0 = bz * g.box.z;
  *y0 = by * g.box.y;
  *x0 = bx * g.box.x;
}

// Stage channels [c0, c0 + CK) of the box at (nb, z0, y0, x0) grown by one
// voxel on each side into dst[ci * XS + v], zero outside the volume and
// past channel c. Consecutive threads read consecutive channels of a voxel.
template <int THREADS>
__device__ __forceinline__ void stage_halo(float* dst, const float* __restrict__ src, int c,
                                           int c0, const Geometry& g, int nb, int z0, int y0,
                                           int x0) {
  const int hx = g.box.x + 2, hy = g.box.y + 2, hz = g.box.z + 2;
  const int total = hz * hy * hx * CK;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int v = i / CK, ci = i - v * CK;
    const int vx = v % hx, vy = (v / hx) % hy, vz = v / (hx * hy);
    const int gz = z0 + vz - 1, gy = y0 + vy - 1, gx = x0 + vx - 1;
    const bool in = gz >= 0 && gz < g.z && gy >= 0 && gy < g.y && gx >= 0 && gx < g.x &&
                    c0 + ci < c;
    dst[ci * XS + v] =
        in ? src[((((int64_t)nb * g.z + gz) * g.y + gy) * g.x + gx) * c + c0 + ci] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// forward: kernel A's and B's fp32 form on the ring body
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
// shared-memory latency). Weights are resident (the whole K loop's, loaded once per block) where
// they fit beside the ring and the block walks several boxes, else each
// stage carries its chunk's 27 x 8 x 32 weights beside the halo. Small
// grids split the K loop over blocks to fill one wave; the splits' fp32
// partials are added in split order by conv_fp32_reduce_kernel.

constexpr int R_THREADS = 256;
constexpr int R_BN = 32;                     // output channels a block
constexpr int R_CK = 8;                      // input channels a stage
constexpr int R_TM = 8;                      // voxels along x a thread
constexpr int R_WCHUNK = 27 * R_CK * R_BN;   // floats of one stage's weights
constexpr int R_SMEM_MAX = 232448;           // dynamic shared memory a block may take

// a box's halo row stride in floats: bx + 2 voxels of R_CK channels, + 4
__host__ __device__ constexpr int ring_row_stride(int bx) { return (bx + 2) * R_CK + 4; }

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
};

template <bool DUAL>
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
  // slot s % stages
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

  if (total > 0 && p.resident && p.mode != 2)
    for (int k = 0; k < nk; ++k) load_weights(res + k * R_WCHUNK, k0 + k);
  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < total && p.mode != 2) produce(s);
    mt::cp_async_commit();
  }
  for (int s = 0; s < total; ++s) {
    if (p.stages == 3) {
      mt::cp_async_wait<1>();
    } else {
      mt::cp_async_wait<0>();
    }
    __syncthreads();  // stage s landed for all; slot (s - 1) % stages is free
    if (s + p.stages - 1 < total && p.mode != 2) produce(s + p.stages - 1);
    mt::cp_async_commit();
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
        }
      }
    }
#pragma unroll
    for (int m = 0; m < R_TM; ++m)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[m][c] = 0.f;
  }
  mt::cp_async_wait_all();
}

// out[v, co] = bias[co] + the sum over splits of part[s, v, co], in split order
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

// ---------------------------------------------------------------------------
// forward: kernel D's fp32 form (the staged body)
// ---------------------------------------------------------------------------

constexpr int F_THREADS = 256;
constexpr int F_SMEM = (CK * XS + CK * 27 * BN) * 4;

struct FParams {
  const float* in[2];
  int cin[2];
  int kchunk0[2];  // first prepared-weight chunk of each input
  const float* w;
  const float* bias;
  float* out;
  int cout, coutp;
  Geometry g;
  const float* scale;  // AFFINE: (N, cin[0]) each
  const float* shift;
  float slope;
  float* part;  // STATS: (N, boxes, 2, Cout) per-block channel sums
};

// lrelu(x * s + t) of every staged element inside the volume and below
// channel c (the rest stays 0): the product and the sum rounded apart.
__device__ __forceinline__ void affine_halo(float* dst, const float* __restrict__ scale,
                                            const float* __restrict__ shift, float slope, int c,
                                            int c0, const Geometry& g, int nb, int z0, int y0,
                                            int x0) {
  const int hx = g.box.x + 2, hy = g.box.y + 2, hz = g.box.z + 2;
  const int total = hz * hy * hx * CK;
  for (int i = threadIdx.x; i < total; i += F_THREADS) {
    const int v = i / CK, ci = i - v * CK;
    const int vx = v % hx, vy = (v / hx) % hy, vz = v / (hx * hy);
    const int gz = z0 + vz - 1, gy = y0 + vy - 1, gx = x0 + vx - 1;
    if (gz < 0 || gz >= g.z || gy < 0 || gy >= g.y || gx < 0 || gx >= g.x || c0 + ci >= c)
      continue;
    const int k = nb * c + c0 + ci;
    const float f = __fadd_rn(__fmul_rn(dst[ci * XS + v], scale[k]), shift[k]);
    dst[ci * XS + v] = f >= 0.f ? f : f * slope;
  }
}

template <bool AFFINE, bool STATS>
__global__ void __launch_bounds__(F_THREADS) conv_fp32_kernel(FParams p) {
  extern __shared__ float smem[];
  float* xs = smem;             // [CK][XS]
  float* ws = smem + CK * XS;   // [CK][27][BN]
  const Geometry& g = p.g;
  int nb, z0, y0, x0;
  box_origin(g, blockIdx.x, &nb, &z0, &y0, &x0);
  const int co0 = blockIdx.y * BN;
  const int t = threadIdx.x;
  const int cg = t >> 6;  // 8 output channels: warp-uniform
  const int vg = t & 63;
  const int nxg = g.box.x >> 2;
  const int xg = vg % nxg, vy = (vg / nxg) % g.box.y, vz = vg / (nxg * g.box.y);
  const int hx = g.box.x + 2, hy = g.box.y + 2;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  for (int s = 0; s < 2; ++s) {
    const int c = p.cin[s];
    for (int c0 = 0; c0 < c; c0 += CK) {
      __syncthreads();  // the previous chunk's reads are done
      stage_halo<F_THREADS>(xs, p.in[s], c, c0, g, nb, z0, y0, x0);
      if constexpr (AFFINE) {
        // each thread rewrites the elements it staged: no barrier between
        affine_halo(xs, p.scale, p.shift, p.slope, c, c0, g, nb, z0, y0, x0);
      }
      for (int i = t; i < CK * 27 * BN; i += F_THREADS) {
        const int co = i % BN, tap = (i / BN) % 27, ci = i / (BN * 27);
        const int k = c0 + ci;  // zero rows past c in the prepared layout
        const int64_t row = ((int64_t)(p.kchunk0[s] + k / KCH) * 27 + tap) * KCH + k % KCH;
        ws[i] = k < cdiv(c, KCH) * KCH ? p.w[row * p.coutp + co0 + co] : 0.f;
      }
      __syncthreads();
#pragma unroll 1
      for (int ci = 0; ci < CK; ++ci) {
        const float* xrow = xs + ci * XS;
        const float* wrow = ws + ci * 27 * BN + cg * 8;
#pragma unroll
        for (int dz = 0; dz < 3; ++dz) {
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const float* xp = xrow + ((vz + dz) * hy + vy + dy) * hx + xg * 4;
            float xv[6];
#pragma unroll
            for (int j = 0; j < 6; ++j) xv[j] = xp[j];
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const float* wp = wrow + ((dz * 3 + dy) * 3 + dx) * BN;
              const float4 w0 = *reinterpret_cast<const float4*>(wp);
              const float4 w1 = *reinterpret_cast<const float4*>(wp + 4);
              const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int cc = 0; cc < 8; ++cc) acc[i][cc] = fmaf(xv[i + dx], wv[cc], acc[i][cc]);
            }
          }
        }
      }
    }
  }

  const int oz = z0 + vz, oy = y0 + vy;
  const int cb = co0 + cg * 8;
  float bsum[8], bsq[8];
#pragma unroll
  for (int cc = 0; cc < 8; ++cc) bsum[cc] = bsq[cc] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ox = x0 + xg * 4 + i;
    if (oz >= g.z || oy >= g.y || ox >= g.x) break;
    float* row = p.out + ((((int64_t)nb * g.z + oz) * g.y + oy) * g.x + ox) * p.cout;
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) {
      const int co = cb + cc;
      if (co < p.cout) {
        const float v = acc[i][cc] + (p.bias != nullptr ? p.bias[co] : 0.f);
        row[co] = v;
        if constexpr (STATS) {
          bsum[cc] += v;
          bsq[cc] = fmaf(v, v, bsq[cc]);
        }
      }
    }
  }
  if constexpr (STATS) {
    // the block's 8 channels of a channel group: a warp's lanes by a
    // butterfly, then its two warps in order, into row (nb, box) of part
    __shared__ float red[F_THREADS / 32][16];
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        bsum[cc] += __shfl_xor_sync(0xffffffffu, bsum[cc], o);
        bsq[cc] += __shfl_xor_sync(0xffffffffu, bsq[cc], o);
      }
    }
    const int warp = t >> 5;
    if ((t & 31) == 0) {
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        red[warp][cc] = bsum[cc];
        red[warp][8 + cc] = bsq[cc];
      }
    }
    __syncthreads();
    if (t < 64) {  // thread t: channel group t / 16, value t % 16
      const int grp = t >> 4, e = t & 15, cc = e & 7;
      const int co = co0 + grp * 8 + cc;
      if (co < p.cout) {
        const long long box = blockIdx.x - (long long)nb * g.boxes;
        float* dst = p.part + ((int64_t)nb * g.boxes + box) * 2 * p.cout;
        dst[(e >> 3) * p.cout + co] = red[2 * grp][e] + red[2 * grp + 1][e];
      }
    }
  }
}

// The bytes of D's fp32 form's workspace: the per-block stats rows, then
// reduce_rows' (-1: more boxes than it adds).
long long stats_workspace_bytes(int n, int z, int y, int x, int cout) {
  if (n <= 0 || z <= 0 || y <= 0 || x <= 0 || cout <= 0) return -1;
  const long long boxes = geometry(n, z, y, x).boxes;
  if (boxes > 0x7fffffffLL) return -1;
  const long long red = mt::reduce_rows_workspace(n, (int)boxes, 2 * cout);
  if (red < 0) return -1;
  return 4LL * n * boxes * 2 * cout + red;
}

template <bool AFFINE, bool STATS>
cudaError_t launch_conv(const FParams& p, long long blocks, int cout, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(conv_fp32_kernel<AFFINE, STATS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)blocks, cdiv(cout, BN));
  conv_fp32_kernel<AFFINE, STATS><<<grid, F_THREADS, F_SMEM, st>>>(p);
  return cudaGetLastError();
}

// Kernel D's fp32 form: its prologue where scale is given (one input
// only), the stats through the workspace ws.
int run_conv(const void* a, const void* b, int ca, int cb, const void* w, const void* bias,
             void* out, int n, int z, int y, int x, int cout, int coutp, void* stream,
             const void* scale, const void* shift, float slope, void* stats, void* ws,
             long long ws_bytes) {
  if (ca <= 0 || cb < 0 || cout <= 0 || coutp < cout || coutp % BN || n <= 0 || z <= 0 ||
      y <= 0 || x <= 0 || (cb > 0) != (b != nullptr) || stats == nullptr ||
      (scale == nullptr) != (shift == nullptr) || (scale != nullptr && cb > 0))
    return (int)cudaErrorInvalidValue;
  FParams p{};
  p.in[0] = static_cast<const float*>(a);
  p.in[1] = static_cast<const float*>(b);
  p.cin[0] = ca;
  p.cin[1] = cb;
  p.kchunk0[0] = 0;
  p.kchunk0[1] = cdiv(ca, KCH);
  p.w = static_cast<const float*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<float*>(out);
  p.cout = cout;
  p.coutp = coutp;
  p.g = geometry(n, z, y, x);
  const long long blocks = p.g.boxes * n;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long need = stats_workspace_bytes(n, z, y, x, cout);
  if (need < 0 || ws == nullptr || ws_bytes < need) return (int)cudaErrorInvalidValue;
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.slope = slope;
  p.part = static_cast<float*>(ws);
  cudaError_t err = scale != nullptr ? launch_conv<true, true>(p, blocks, cout, st)
                                     : launch_conv<false, true>(p, blocks, cout, st);
  if (err != cudaSuccess) return (int)err;
  const long long part_elems = (long long)n * p.g.boxes * 2 * cout;  // then reduce_rows'
  return (int)mt::reduce_rows(p.part, static_cast<float*>(stats), p.part + part_elems, n,
                              (int)p.g.boxes, 2 * cout, st);
}

// The ring body's boxes (z, y, x): 512 voxels, x a multiple of R_TM, y 8 or
// 16 (a warp's 8 voxel groups are 8 neighbouring rows); the same list as
// ops/conv3d.py:FP32_RING_BOXES, which picks one.
constexpr int kRingBoxes[][3] = {{8, 8, 8}, {4, 8, 16}, {4, 16, 8}, {2, 16, 16}, {2, 8, 32}};

// Kernel A (b null, cb 0) or B on the ring body with the plan that
// ops/conv3d.py:conv3d_same_fp32_plan makes: the box, K splits (partials
// in ws, then conv_fp32_reduce_kernel), resident weights, ring stages and
// blocks along the boxes. Refuses a plan it cannot run.
int run_ring(const void* a, const void* b, int ca, int cb, const void* w, const void* bias,
             void* out, void* ws, long long ws_bytes, int n, int z, int y, int x, int cout,
             int coutp, int bz, int by, int bx, int splits, int resident, int stages,
             int grid_p, int mode, void* stream) {
  if (ca <= 0 || cb < 0 || cout <= 0 || coutp < cout || coutp % R_BN || n <= 0 || z <= 0 ||
      y <= 0 || x <= 0 || (cb > 0) != (b != nullptr) || stages < 2 || stages > 3 ||
      (resident != 0 && resident != 1) || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  bool known = false;
  for (const auto& k : kRingBoxes) known = known || (k[0] == bz && k[1] == by && k[2] == bx);
  if (!known) return (int)cudaErrorInvalidValue;
  RParams p{};
  p.in[0] = static_cast<const float*>(a);
  p.in[1] = static_cast<const float*>(b);
  p.cin[0] = ca;
  p.cin[1] = cb;
  p.chunks0 = cdiv(ca, R_CK);
  p.chunks = p.chunks0 + (cb > 0 ? cdiv(cb, R_CK) : 0);
  p.kchunk0_b = cdiv(ca, KCH);
  p.w = static_cast<const float*>(w);
  p.cout = cout;
  p.coutp = coutp;
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
  if (splits < 1 || splits > p.chunks || boxes > 0x7fffffffLL || grid_p < 1 || grid_p > boxes)
    return (int)cudaErrorInvalidValue;
  p.boxes = (int)boxes;
  p.per_split = cdiv(p.chunks, splits);
  if (cdiv(p.chunks, p.per_split) != splits || (resident && splits > 1))
    return (int)cudaErrorInvalidValue;
  p.grid_p = grid_p;
  p.resident = resident;
  p.stages = stages;
  const bool even2 = ca % 2 == 0 && cb % 2 == 0;
  p.vec = ca % 4 == 0 && cb % 4 == 0 ? 4 : (even2 ? 2 : 1);
  p.rs = ring_row_stride(bx);
  p.halo = (bz + 2) * (by + 2) * p.rs;
  p.mode = mode;
  const long long smem =
      4LL * ((resident ? p.per_split * R_WCHUNK : 0) +
             (long long)stages * (p.halo + (resident ? 0 : R_WCHUNK)));
  if (smem > R_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const long long count = (long long)n * z * y * x * cout;
  if (splits > 1 && (ws == nullptr || ws_bytes < 4LL * splits * count))
    return (int)cudaErrorInvalidValue;
  p.out = static_cast<float*>(splits > 1 ? ws : out);
  p.bias = splits > 1 ? nullptr : static_cast<const float*>(bias);
  p.store4 = cout % 4 == 0 && reinterpret_cast<uintptr_t>(p.out) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto kernel = cb > 0 ? conv_fp32_ring_kernel<true> : conv_fp32_ring_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(grid_p, cdiv(cout, R_BN), splits), R_THREADS, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int rblocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  conv_fp32_reduce_kernel<<<rblocks, 256, 0, st>>>(static_cast<const float*>(ws),
                                                   static_cast<const float*>(bias),
                                                   static_cast<float*>(out), count, cout, splits);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// weight gradient: kernel C's fp32 form
// ---------------------------------------------------------------------------

constexpr int W_THREADS = 576;  // 8 input channels x 9 (dz, dy) x 8 groups of 4 outputs
constexpr int W_SMEM = (CK * XS + 256 * BN) * 4;

struct WPlan {
  int chunks;  // CK-channel chunks over both inputs
  int splits;  // of the voxel axis
};

WPlan wplan(int n, int z, int y, int x, int ca, int cb, int cout) {
  WPlan p{};
  p.chunks = cdiv(ca, CK) + (cb > 0 ? cdiv(cb, CK) : 0);
  const long long boxes = geometry(n, z, y, x).boxes * n;
  const long long others = (long long)p.chunks * cdiv(cout, BN);
  // two blocks an SM fill the card; never more splits than boxes
  long long splits = (2LL * mt::sm_count() + others - 1) / others;
  if (splits > boxes) splits = boxes;
  p.splits = (int)(splits < 1 ? 1 : splits);
  return p;
}

long long wgrad_workspace_bytes(const WPlan& p, int ca, int cb, int cout) {
  return p.splits == 1 ? 0 : 4LL * p.splits * 27 * (ca + cb) * cout;
}

struct WParams {
  const float* in[2];
  int cin[2];
  int chunks0;  // chunks of the first input
  const float* g;
  float* out;  // dw, or the partials (splits, Cout, Cin, 27)
  int cout;
  long long boxes_per_split, boxes;
  Geometry geo;
};

__global__ void __launch_bounds__(W_THREADS) wgrad_fp32_kernel(WParams p) {
  extern __shared__ float smem[];
  float* xs = smem;             // [CK][XS]
  float* gs = smem + CK * XS;   // [256][BN]
  const Geometry& g = p.geo;
  const int split = blockIdx.x, co0 = blockIdx.y * BN, chunk = blockIdx.z;
  const int s = chunk < p.chunks0 ? 0 : 1;
  const int c = p.cin[s];
  const int c0 = (chunk - (s ? p.chunks0 : 0)) * CK;
  const int t = threadIdx.x;
  const int co4 = t & 7, ci = (t >> 3) & 7, dzdy = t >> 6;
  const int dz = dzdy / 3, dy = dzdy % 3;
  const int bz = g.box.z, by = g.box.y, bx = g.box.x;
  const int hx = bx + 2, hy = by + 2;

  float acc[3][4];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[d][k] = 0.f;

  const long long b0 = (long long)split * p.boxes_per_split;
  const long long b1 = min(b0 + p.boxes_per_split, p.boxes);
  for (long long b = b0; b < b1; ++b) {
    int nb, z0, y0, x0;
    box_origin(g, b, &nb, &z0, &y0, &x0);
    __syncthreads();  // the previous box's reads are done
    stage_halo<W_THREADS>(xs, p.in[s], c, c0, g, nb, z0, y0, x0);
    for (int i = t; i < 256 * BN; i += W_THREADS) {
      const int co = i % BN, v = i / BN;
      const int vx = v % bx, vy = (v / bx) % by, vz = v / (bx * by);
      const int gz = z0 + vz, gy = y0 + vy, gx = x0 + vx;
      const bool in = gz < g.z && gy < g.y && gx < g.x && co0 + co < p.cout;
      gs[i] = in ? p.g[((((int64_t)nb * g.z + gz) * g.y + gy) * g.x + gx) * p.cout + co0 + co]
                 : 0.f;
    }
    __syncthreads();
    const float* xrow = xs + ci * XS;
#pragma unroll 1
    for (int vz = 0; vz < bz; ++vz) {
#pragma unroll 1
      for (int vy = 0; vy < by; ++vy) {
        const float* xl = xrow + ((vz + dz) * hy + vy + dy) * hx;
        const float* gl = gs + (vz * by + vy) * bx * BN + co4 * 4;
        float xa = xl[0], xb = xl[1];
#pragma unroll 4
        for (int vx = 0; vx < bx; ++vx) {
          const float xc = xl[vx + 2];
          const float4 gv = *reinterpret_cast<const float4*>(gl + vx * BN);
          const float gk[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc[0][k] = fmaf(xa, gk[k], acc[0][k]);
            acc[1][k] = fmaf(xb, gk[k], acc[1][k]);
            acc[2][k] = fmaf(xc, gk[k], acc[2][k]);
          }
          xa = xb;
          xb = xc;
        }
      }
    }
  }

  const int cin_total = p.cin[0] + p.cin[1];
  const int cig = (s ? p.cin[0] : 0) + c0 + ci;  // channel of the concat
  if (c0 + ci >= c) return;
  float* base = p.out + (int64_t)split * 27 * cin_total * p.cout;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int co = co0 + co4 * 4 + k;
    if (co >= p.cout) break;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
      base[((int64_t)co * cin_total + cig) * 27 + (dz * 3 + dy) * 3 + dx] = acc[dx][k];
  }
}

// dw[i] = sum over splits of part[s, i], in split order
__global__ void wgrad_fp32_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                                         long long count, int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < count;
       i += (long long)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) sum += part[s * count + i];
    dw[i] = sum;
  }
}

int run_wgrad(const void* a, const void* b, int ca, int cb, const void* gr, void* dw, void* ws,
              long long ws_bytes, int n, int z, int y, int x, int cout, void* stream) {
  if (ca <= 0 || cb < 0 || cout <= 0 || n <= 0 || z <= 0 || y <= 0 || x <= 0 ||
      (cb > 0) != (b != nullptr))
    return (int)cudaErrorInvalidValue;
  const WPlan plan = wplan(n, z, y, x, ca, cb, cout);
  const long long need = wgrad_workspace_bytes(plan, ca, cb, cout);
  if (ws_bytes < need || (need > 0 && ws == nullptr)) return (int)cudaErrorInvalidValue;
  WParams p{};
  p.in[0] = static_cast<const float*>(a);
  p.in[1] = static_cast<const float*>(b);
  p.cin[0] = ca;
  p.cin[1] = cb;
  p.chunks0 = cdiv(ca, CK);
  p.g = static_cast<const float*>(gr);
  p.cout = cout;
  p.geo = geometry(n, z, y, x);
  p.boxes = p.geo.boxes * n;
  p.boxes_per_split = (p.boxes + plan.splits - 1) / plan.splits;
  p.out = static_cast<float*>(plan.splits == 1 ? dw : ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_fp32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(plan.splits, cdiv(cout, BN), plan.chunks);
  wgrad_fp32_kernel<<<grid, W_THREADS, W_SMEM, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || plan.splits == 1) return (int)err;
  const long long count = 27LL * (ca + cb) * cout;
  const int rblocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  wgrad_fp32_reduce_kernel<<<rblocks, 256, 0, st>>>(static_cast<const float*>(ws),
                                                     static_cast<float*>(dw), count,
                                                     plan.splits);
  return (int)cudaGetLastError();
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
  return run_ring(a, b, ca, cb, w, bias, out, ws, ws_bytes, n, z, y, x, cout, coutp, bz, by,
                  bx, splits, resident, stages, grid_p, mode, stream);
}

// Bytes of fp32 workspace kernel D's fp32 form takes at these sizes (-1:
// sizes it does not take).
long long mt_conv3d_stats_fp32_workspace(int n, int z, int y, int x, int cout) {
  return stats_workspace_bytes(n, z, y, x, cout);
}

// Kernel D's fp32 form: out = conv(concat(a, b), w) + bias with, where scale
// and shift (N, Ca) are given (b null), the prologue lrelu(a * scale +
// shift) on a (halo 0), and stats (N, 2, Cout) of out; ws holds
// mt_conv3d_stats_fp32_workspace bytes.
int mt_conv3d_same_affine_fp32(const void* a, const void* b, const void* w, const void* bias,
                               const void* scale, const void* shift, float slope, void* out,
                               void* stats, void* ws, long long ws_bytes, int n, int z, int y,
                               int x, int ca, int cb, int cout, int coutp, void* stream) {
  if (stats == nullptr) return (int)cudaErrorInvalidValue;
  return run_conv(a, b, ca, cb, w, bias, out, n, z, y, x, cout, coutp, stream, scale, shift,
                  slope, stats, ws, ws_bytes);
}

// Bytes of fp32 workspace kernel C's fp32 form takes at these sizes: 0
// where it writes dw directly (one split), -1 for sizes it does not take.
long long mt_conv3d_wgrad_fp32_workspace(int n, int z, int y, int x, int ca, int cb,
                                         int cout) {
  if (ca <= 0 || cb < 0 || cout <= 0 || n <= 0 || z <= 0 || y <= 0 || x <= 0) return -1;
  return wgrad_workspace_bytes(wplan(n, z, y, x, ca, cb, cout), ca, cb, cout);
}

// Kernel C's fp32 form: dw (Cout, Ca + Cb, 3, 3, 3) of the conv of
// concat(a, b) (b null, cb 0: of a) by g.
int mt_conv3d_wgrad_fp32(const void* a, const void* b, const void* g, void* dw, void* ws,
                         long long ws_bytes, int n, int z, int y, int x, int ca, int cb,
                         int cout, void* stream) {
  return run_wgrad(a, b, ca, cb, g, dw, ws, ws_bytes, n, z, y, x, cout, stream);
}

}  // extern "C"
