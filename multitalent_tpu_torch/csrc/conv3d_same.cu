// Stride-1 SAME 3x3x3 convolution, channels-last bf16, fp32 accumulation.
//
// Replaces three Pallas TPU kernels of multitalent_tpu:
//   - ops/pallas_conv.py  _conv_kernel       (dense 27-tap conv, C >= 120)
//   - ops/pallas_merged_conv.py _merged_kernel  (the same conv on a
//     space-to-depth packed tensor: that packing only fills the TPU's
//     128-lane matrix unit, so here it runs unpacked at the true C)
//   - ops/pallas_merged_conv.py _merged2_kernel (conv over concat(a, b)
//     without building the concat) -> the NIN == 2 instantiation below.
// and, as kernel D, a fourth:
//   - ops/pallas_conv.py _conv_affine_kernel (the fused conv -> InstanceNorm
//     chain): the same body with a normalize prologue (AFFINE: the staged
//     halo box becomes lrelu(bf16(x * scale[n, c] + shift[n, c])) before any
//     ldmatrix, the SAME halo and padding channels forced back to 0) and a
//     stats epilogue (STATS: per-channel sum and sum of squares of the
//     bf16-rounded, bias-added output, per-block partials added in a fixed
//     order by fused_norm.cu's reduce_rows; deterministic, no atomics). Where
//     the K loop is split, the stats are taken by fused_norm.cu's
//     channel_stats over the reduced, rounded output instead (the deep
//     stages: at most 6x24x24 voxels). The dual form (NIN == 2 with STATS)
//     serves a decoder's first conv. What D saves: the normalize pass's read
//     and write of the activation and the stats pass's read (~0.6 GB at
//     stage 0 with N=1); the prologue adds ~16 elementwise ops per staged
//     element, once per K chunk, not per tap.
//
// What bounds it on an H100: the flagship's convs carry ~27*C FLOPs per
// input byte, well above the ~295 FLOP/byte ridge, so the tensor cores should
// be the limit. This form (mma.sync, one K chunk in flight, no wgmma/TMA) is
// bound instead by the serialised load -> sync -> compute phases of each K
// chunk, by shared-memory bandwidth, and, at the deep stages (6x6x6 ..
// 12x24x24 voxels), by having too few output tiles to fill 132 SMs. The
// design answers each in a simple way:
//   - implicit GEMM: a block owns 256 output voxels x BN output channels; per
//     16-channel K chunk it stages one haloed input box and the chunk's
//     weights for all 27 taps in shared memory (cp.async, zero-fill) and
//     reuses them for all 27 taps;
//   - shared-memory rows are padded (48 B per voxel, BN+8 per weight row) so
//     every ldmatrix is free of bank conflicts;
//   - the box shape (2x8x16, 4x8x8, ...) is picked per call to waste the
//     fewest voxels at the volume's edges, and small grids split the K loop
//     over blocks (fp32 partials, then one reduce kernel adds the bias);
//   - ragged C (30, 60) and ragged Z/Y/X are zero-filled in shared memory,
//     never padded in device memory;
//   - bias is added in fp32 in the epilogue and the output rounds to bf16
//     once. Two blocks fit on an SM, so one block's loads overlap the
//     other's products.
//
// Layouts:
//   x:   (N, Z, Y, X, Cin) bf16, contiguous (a channels_last_3d NCDHW tensor)
//   w:   (kchunks, 27, 16, CoutP) bf16, prepared once per model load by
//        multitalent_tpu_torch/ops/conv3d.py:prepare_conv3d_weight; tap =
//        (dz*3+dy)*3+dx, rows past an input's channel count are zero;
//        CoutP is Cout rounded up to the block's N width BN.
//   out: (N, Z, Y, X, Cout) bf16, contiguous.
// For NIN == 2 the K loop first runs over the chunks of `a`, then over the
// chunks of `b`: channel order [a | b], as torch.cat((a, b), 1).
#include "common.cuh"

namespace {

using namespace mt;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MF = BM / (WARPS * 16);  // 16-voxel M fragments per warp
constexpr int MAX_SPLITS = 64;

struct Plan {
  Box box;
  int tiles_z, tiles_y, tiles_x;
  int splits, per_split;  // K chunks per split
};

struct Params {
  const __nv_bfloat16* in[2];
  int cin[2];
  int nchunks0;  // K chunks of input 0; input 1's follow
  const __nv_bfloat16* w;
  const float* bias;  // may be null
  __nv_bfloat16* out;
  float* ws;  // split-K partials (splits, N*Z*Y*X, Cout), when splits > 1
  int n, z, y, x, cout, coutp;
  Plan plan;
  // kernel D: the normalize prologue's per-(sample, channel) scale and shift
  // (N, Cin) fp32 and LeakyReLU slope; the stats epilogue's per-block
  // partials (N * tiles, 2, Cout) fp32
  const float* scale;
  const float* shift;
  float slope;
  float* part;
};

Plan make_plan(int n, int z, int y, int x, int kchunks, int nblocks_n, int sms) {
  Plan best{};
  const long long best_vox = pick_box(z, y, x, &best.box);
  best.tiles_z = cdiv(z, best.box.z);
  best.tiles_y = cdiv(y, best.box.y);
  best.tiles_x = cdiv(x, best.box.x);
  const long long blocks = best_vox * n * nblocks_n;
  const long long target = 2LL * sms;  // two resident blocks per SM
  int splits = 1;
  if (blocks < target) splits = (int)((target + blocks - 1) / blocks);
  splits = splits < kchunks ? splits : kchunks;
  splits = splits < MAX_SPLITS ? splits : MAX_SPLITS;
  best.per_split = cdiv(kchunks, splits);
  best.splits = cdiv(kchunks, best.per_split);  // no empty split
  return best;
}

// One K chunk of the haloed input box into shared memory, zero outside the
// volume and past the input's channel count.
__device__ __forceinline__ void load_halo(__nv_bfloat16* halo,
                                          const __nv_bfloat16* __restrict__ src,
                                          int cin, int c0, const Params& p, int nb,
                                          int z0, int y0, int x0) {
  load_box<THREADS>(halo, src, cin, c0, KC, HS, 1, p.plan.box, p.z, p.y, p.x, nb, z0,
                    y0, x0);
}

// The chunk's (27, 16, BN) weight slice for output-channel block `nblk`.
template <int BN>
__device__ __forceinline__ void load_weights(__nv_bfloat16* wsm,
                                             const __nv_bfloat16* __restrict__ w,
                                             int kchunk, int nblk, int coutp) {
  constexpr int BNP = BN + 8;
  constexpr int VPR = BN / 8;  // 16-byte copies per row
  constexpr int total = 27 * KC * VPR;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int row = i / VPR;
    const int col = (i - row * VPR) * 8;
    const int64_t off = ((int64_t)kchunk * 27 * KC + row) * coutp + nblk * BN + col;
    cp_async16(wsm + row * BNP + col, w + off, true);
  }
}

template <int BN>
constexpr int smem_bytes() {
  return HALO_MAX * HS * 2 + 27 * KC * (BN + 8) * 2;
}

// Kernel D's prologue on one staged K chunk: lrelu(bf16(x * scale + shift))
// on in-volume voxels and real channels, 0 on the SAME halo and the padding
// channels (cp.async zero-filled them, but lrelu(shift) is not 0).
__device__ __forceinline__ void normalize_halo(__nv_bfloat16* halo, const Params& p, int nb,
                                               int c0, int z0, int y0, int x0) {
  constexpr int PAIRS = KC / 2;  // channel pairs of a halo row
  static_assert(THREADS % PAIRS == 0, "a thread keeps one channel pair");
  const Box box = p.plan.box;
  const int hx = box.x + 2, hy = box.y + 2, hz = box.z + 2;
  const int cin = p.cin[0];
  // this thread's channel pair, its scale and shift in registers
  const int ch = (threadIdx.x % PAIRS) * 2;
  const int c = c0 + ch;
  const bool has_lo = c < cin, has_hi = c + 1 < cin;
  const float* sc = p.scale + (int64_t)nb * cin;
  const float* sh = p.shift + (int64_t)nb * cin;
  const float s_lo = has_lo ? sc[c] : 0.f, t_lo = has_lo ? sh[c] : 0.f;
  const float s_hi = has_hi ? sc[c + 1] : 0.f, t_hi = has_hi ? sh[c + 1] : 0.f;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const int nvox = hz * hy * hx;
  for (int v = threadIdx.x / PAIRS; v < nvox; v += THREADS / PAIRS) {
    const int vx = v % hx, vy = (v / hx) % hy, vz = v / (hx * hy);
    const int gz = z0 + vz - 1, gy = y0 + vy - 1, gx = x0 + vx - 1;
    const bool inside =
        gz >= 0 && gz < p.z && gy >= 0 && gy < p.y && gx >= 0 && gx < p.x;
    __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(halo + v * HS + ch);
    const float2 f = __bfloat1622float2(*d);
    const __nv_bfloat16 lo = inside && has_lo ? cast_lrelu(f.x * s_lo + t_lo, p.slope) : zero;
    const __nv_bfloat16 hi = inside && has_hi ? cast_lrelu(f.y * s_hi + t_hi, p.slope) : zero;
    *d = __halves2bfloat162(lo, hi);
  }
}

// Kernel D's stats epilogue: the block's per-channel sum and sum of squares
// of bf16(acc + bias) over its in-volume voxels, in a fixed order (lanes by
// shuffles, then warps in turn), written to row blockIdx.x of p.part.
template <int BN, int NT>
__device__ __forceinline__ void block_stats(const float (&acc)[MF][NT][4], float* red,
                                            const Params& p, int nblk, int z0, int y0,
                                            int x0) {
  const Box box = p.plan.box;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bool valid[MF][2];
#pragma unroll
  for (int mi = 0; mi < MF; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (warp * MF + mi) * 16 + lane / 4 + h * 8;
      valid[mi][h] = z0 + m / (box.y * box.x) < p.z && y0 + (m / box.x) % box.y < p.y &&
                     x0 + m % box.x < p.x;
    }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int co = nblk * BN + j * 8 + (lane % 4) * 2;
    const float b0 = p.bias != nullptr && co < p.cout ? p.bias[co] : 0.f;
    const float b1 = p.bias != nullptr && co + 1 < p.cout ? p.bias[co + 1] : 0.f;
    float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
    for (int mi = 0; mi < MF; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!valid[mi][h]) continue;
        const float r0 = __bfloat162float(__float2bfloat16(acc[mi][j][h * 2] + b0));
        const float r1 = __bfloat162float(__float2bfloat16(acc[mi][j][h * 2 + 1] + b1));
        s0 += r0;
        q0 += r0 * r0;
        s1 += r1;
        q1 += r1 * r1;
      }
#pragma unroll
    for (int off = 4; off < 32; off *= 2) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      q0 += __shfl_xor_sync(0xffffffffu, q0, off);
      q1 += __shfl_xor_sync(0xffffffffu, q1, off);
    }
    if (lane < 4) {
      const int c = j * 8 + lane * 2;
      red[(warp * 2 + 0) * BN + c] = s0;
      red[(warp * 2 + 0) * BN + c + 1] = s1;
      red[(warp * 2 + 1) * BN + c] = q0;
      red[(warp * 2 + 1) * BN + c + 1] = q1;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 2 * BN; t += THREADS) {
    const int k = t / BN, c = t % BN;
    const int co = nblk * BN + c;
    if (co >= p.cout) continue;
    float v = 0.f;
    for (int w = 0; w < WARPS; ++w) v += red[(w * 2 + k) * BN + c];
    p.part[((int64_t)blockIdx.x * 2 + k) * p.cout + co] = v;
  }
}

// AFFINE: kernel D's normalize prologue (NIN == 1). STATS: kernel D's
// epilogue, per-block channel sums of the bf16-rounded, bias-added output
// (only when the K loop is not split: a split's partial sums are not the
// output yet, so the caller takes the stats after the split-K reduction).
template <int NIN, int BN, bool AFFINE, bool STATS>
__global__ void __launch_bounds__(THREADS, 2) conv3d_same_kernel(Params p) {
  static_assert(!AFFINE || NIN == 1, "the prologue reads one input");
  constexpr int BNP = BN + 8;
  constexpr int NT = BN / 8;  // n8 tiles per warp
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[STATS ? WARPS * 2 * BN : 1];  // per-warp stats
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem + HALO_MAX * HS * 2);

  const Box box = p.plan.box;
  const int hx = box.x + 2, hy = box.y + 2;
  int t = blockIdx.x;
  const int txi = t % p.plan.tiles_x;
  t /= p.plan.tiles_x;
  const int tyi = t % p.plan.tiles_y;
  t /= p.plan.tiles_y;
  const int tzi = t % p.plan.tiles_z;
  const int nb = t / p.plan.tiles_z;
  const int x0 = txi * box.x, y0 = tyi * box.y, z0 = tzi * box.z;
  const int nblk = blockIdx.y;
  const int split = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // ldmatrix rows: lane l addresses row l % 16 of each of this warp's M
  // fragments (one output voxel each) at K offset (l / 16) * 8
  int a_row[MF];
#pragma unroll
  for (int mi = 0; mi < MF; ++mi) {
    const int m = (warp * MF + mi) * 16 + lane % 16;
    const int vz = m / (box.y * box.x), vy = (m / box.x) % box.y, vx = m % box.x;
    a_row[mi] = ((vz * hy + vy) * hx + vx) * HS + (lane / 16) * 8;
  }
  const int b_row = (lane % 16) * BNP + (lane / 16) * 8;

  float acc[MF][NT][4];
#pragma unroll
  for (int mi = 0; mi < MF; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;

  const int kchunks = p.nchunks0 + (NIN == 2 ? cdiv(p.cin[1], KC) : 0);
  const int k_lo = split * p.plan.per_split;
  const int k_hi = min(kchunks, k_lo + p.plan.per_split);
  for (int kc = k_lo; kc < k_hi; ++kc) {
    // selects, not p.in[inp]: a runtime index would copy p to local memory
    const bool second = NIN == 2 && kc >= p.nchunks0;
    const int c0 = (kc - (second ? p.nchunks0 : 0)) * KC;
    __syncthreads();  // the previous chunk's fragments are consumed
    load_halo(halo, second ? p.in[1] : p.in[0], second ? p.cin[1] : p.cin[0], c0, p,
              nb, z0, y0, x0);
    load_weights<BN>(wsm, p.w, kc, nblk, p.coutp);
    cp_async_wait_all();
    __syncthreads();
    if constexpr (AFFINE) {
      normalize_halo(halo, p, nb, c0, z0, y0, x0);
      __syncthreads();
    }
#pragma unroll 1
    for (int tap = 0; tap < 27; ++tap) {
      const int dz = tap / 9, dy = (tap / 3) % 3, dx = tap % 3;
      const int tap_off = ((dz * hy + dy) * hx + dx) * HS;
      uint32_t a[MF][4];
#pragma unroll
      for (int mi = 0; mi < MF; ++mi) ldmatrix_x4(a[mi], halo + a_row[mi] + tap_off);
      const __nv_bfloat16* wt = wsm + tap * KC * BNP + b_row;
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, wt + j * 8);
#pragma unroll
        for (int mi = 0; mi < MF; ++mi) {
          mma_16816(acc[mi][j], a[mi], b[0], b[1]);
          mma_16816(acc[mi][j + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }

  // epilogue: accumulator element e of tile (mi, j) is voxel row
  // lane / 4 (+8 for e >= 2), channel 2 * (lane % 4) + (e & 1)
  const bool pairs = p.cout % 2 == 0;
  const int64_t nvox = (int64_t)p.n * p.z * p.y * p.x;
#pragma unroll
  for (int mi = 0; mi < MF; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (warp * MF + mi) * 16 + lane / 4 + h * 8;
      const int gz = z0 + m / (box.y * box.x), gy = y0 + (m / box.x) % box.y,
                gx = x0 + m % box.x;
      if (gz >= p.z || gy >= p.y || gx >= p.x) continue;
      const int64_t vox = (((int64_t)nb * p.z + gz) * p.y + gy) * p.x + gx;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int co = nblk * BN + j * 8 + (lane % 4) * 2;
        if (co >= p.cout) continue;
        float v0 = acc[mi][j][h * 2], v1 = acc[mi][j][h * 2 + 1];
        if (p.plan.splits > 1) {
          float* dst = p.ws + ((int64_t)split * nvox + vox) * p.cout + co;
          if (pairs) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            dst[0] = v0;
            if (co + 1 < p.cout) dst[1] = v1;
          }
          continue;
        }
        if (p.bias != nullptr) {
          v0 += p.bias[co];
          if (co + 1 < p.cout) v1 += p.bias[co + 1];
        }
        __nv_bfloat16* dst = p.out + vox * p.cout + co;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
        } else {
          dst[0] = __float2bfloat16(v0);
          if (co + 1 < p.cout) dst[1] = __float2bfloat16(v1);
        }
      }
    }
  }
  if constexpr (STATS) {
    if (p.plan.splits == 1) block_stats<BN, NT>(acc, red, p, nblk, z0, y0, x0);
  }
}

// out = bf16(sum over splits of the partials + bias)
__global__ void splitk_reduce_kernel(const float* __restrict__ ws,
                                     const float* __restrict__ bias,
                                     __nv_bfloat16* __restrict__ out, int64_t count,
                                     int cout, int splits) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (int64_t)gridDim.x * blockDim.x) {
    float v = bias != nullptr ? bias[i % cout] : 0.f;
    for (int s = 0; s < splits; ++s) v += ws[s * count + i];
    out[i] = __float2bfloat16(v);
  }
}

Plan plan_for(int n, int z, int y, int x, int ca, int cb, int coutp, int bn) {
  return make_plan(n, z, y, x, cdiv(ca, KC) + cdiv(cb, KC), coutp / bn, sm_count());
}

long long workspace_bytes(const Plan& plan, int n, int z, int y, int x, int cout) {
  if (plan.splits <= 1) return 0;
  return (long long)plan.splits * n * z * y * x * cout * (long long)sizeof(float);
}

// Kernel D's stats area, after the split-K partials: without a split, the
// per-block partials and reduce_rows' workspace; with one, channel_stats'.
long long stats_workspace_bytes(const Plan& plan, int n, int z, int y, int x, int cout) {
  const long long tiles = (long long)plan.tiles_x * plan.tiles_y * plan.tiles_z;
  if (plan.splits > 1) return channel_stats_workspace(n, (long long)z * y * x, cout);
  if (tiles > 0x7fffffffLL) return -1;
  const long long red = reduce_rows_workspace(n, (int)tiles, 2 * cout);
  if (red < 0) return -1;
  return n * tiles * 2 * cout * (long long)sizeof(float) + red;
}

template <int NIN, int BN, bool AFFINE, bool STATS>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes<BN>();
  cudaError_t err = cudaFuncSetAttribute(conv3d_same_kernel<NIN, BN, AFFINE, STATS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)p.plan.tiles_x * p.plan.tiles_y * p.plan.tiles_z * p.n;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)blocks, p.coutp / BN, p.plan.splits);
  conv3d_same_kernel<NIN, BN, AFFINE, STATS><<<grid, THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.plan.splits == 1) return err;
  const int64_t count = (int64_t)p.n * p.z * p.y * p.x * p.cout;
  const int rblocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  splitk_reduce_kernel<<<rblocks, 256, 0, stream>>>(p.ws, p.bias, p.out, count, p.cout,
                                                    p.plan.splits);
  return cudaGetLastError();
}

// stats (n, 2, cout) of the written output: from the epilogue's per-block
// partials, or (split K loop) by channel_stats over the output.
cudaError_t finish_stats(const Params& p, float* stats, float* sws, long long sws_bytes,
                         cudaStream_t stream) {
  const long long s = (long long)p.z * p.y * p.x;
  if (p.plan.splits > 1)
    return channel_stats(p.out, stats, sws, sws_bytes, p.n, s, p.cout, stream);
  const int tiles = p.plan.tiles_x * p.plan.tiles_y * p.plan.tiles_z;
  return reduce_rows(p.part, stats, p.part + (long long)p.n * tiles * 2 * p.cout, p.n,
                     tiles, 2 * p.cout, stream);
}

// affine: kernel D's prologue (scale, shift non-null; one input); stats
// non-null: kernel D's stats output (n, 2, cout) fp32.
int run(const void* a, const void* b, int ca, int cb, const void* w, const void* bias,
        const void* scale, const void* shift, float slope, void* out, void* stats,
        void* ws, long long ws_bytes, int n, int z, int y, int x, int cout, int coutp,
        int bn, void* stream) {
  if (coutp % bn != 0 || (bn != 32 && bn != 64) || cout > coutp)
    return (int)cudaErrorInvalidValue;
  const bool affine = scale != nullptr;
  if (affine && (shift == nullptr || b != nullptr)) return (int)cudaErrorInvalidValue;
  Params p;
  p.in[0] = static_cast<const __nv_bfloat16*>(a);
  p.in[1] = static_cast<const __nv_bfloat16*>(b);
  p.cin[0] = ca;
  p.cin[1] = cb;
  p.nchunks0 = cdiv(ca, KC);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.ws = static_cast<float*>(ws);
  p.n = n;
  p.z = z;
  p.y = y;
  p.x = x;
  p.cout = cout;
  p.coutp = coutp;
  p.plan = plan_for(n, z, y, x, ca, cb, coutp, bn);
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.slope = slope;
  p.part = nullptr;
  const long long split_bytes = workspace_bytes(p.plan, n, z, y, x, cout);
  long long stats_bytes = 0;
  if (stats != nullptr) {
    stats_bytes = stats_workspace_bytes(p.plan, n, z, y, x, cout);
    if (stats_bytes < 0) return (int)cudaErrorInvalidValue;
  }
  if (ws_bytes < split_bytes + stats_bytes ||
      ((p.plan.splits > 1 || stats != nullptr) && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  float* sws = static_cast<float*>(ws) + split_bytes / (long long)sizeof(float);
  p.part = sws;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (stats == nullptr) {
    if (b == nullptr) {
      err = bn == 32 ? launch<1, 32, false, false>(p, s) : launch<1, 64, false, false>(p, s);
    } else {
      err = bn == 32 ? launch<2, 32, false, false>(p, s) : launch<2, 64, false, false>(p, s);
    }
  } else if (affine) {
    err = bn == 32 ? launch<1, 32, true, true>(p, s) : launch<1, 64, true, true>(p, s);
  } else if (b == nullptr) {
    err = bn == 32 ? launch<1, 32, false, true>(p, s) : launch<1, 64, false, true>(p, s);
  } else {
    err = bn == 32 ? launch<2, 32, false, true>(p, s) : launch<2, 64, false, true>(p, s);
  }
  if (err != cudaSuccess || stats == nullptr) return (int)err;
  return (int)finish_stats(p, static_cast<float*>(stats), sws, stats_bytes, s);
}

}  // namespace

extern "C" {

// Bytes of fp32 workspace a call with these sizes needs (0: no split-K).
// cb is 0 for kernel A.
long long mt_conv3d_workspace(int n, int z, int y, int xd, int ca, int cb, int cout,
                              int coutp, int bn) {
  if (bn <= 0 || coutp % bn != 0) return -1;
  return workspace_bytes(plan_for(n, z, y, xd, ca, cb, coutp, bn), n, z, y, xd, cout);
}

// Bytes of fp32 workspace a kernel-D call (with stats) needs; -1: sizes it
// does not take. cb is 0 for the single-input form.
long long mt_conv3d_stats_workspace(int n, int z, int y, int xd, int ca, int cb, int cout,
                                    int coutp, int bn) {
  if (bn <= 0 || coutp % bn != 0) return -1;
  const Plan plan = plan_for(n, z, y, xd, ca, cb, coutp, bn);
  const long long st = stats_workspace_bytes(plan, n, z, y, xd, cout);
  if (st < 0) return -1;
  return workspace_bytes(plan, n, z, y, xd, cout) + st;
}

// Kernel A. Returns cudaGetLastError() after the launch (0 on success).
int mt_conv3d_same(const void* x, const void* w, const void* bias, void* out, void* ws,
                   long long ws_bytes, int n, int z, int y, int xd, int cin, int cout,
                   int coutp, int bn, void* stream) {
  return run(x, nullptr, cin, 0, w, bias, nullptr, nullptr, 0.f, out, nullptr, ws,
             ws_bytes, n, z, y, xd, cout, coutp, bn, stream);
}

// Kernel B: the conv over concat(a, b) along channels, concat never built.
int mt_conv3d_same_dual(const void* a, const void* b, const void* w, const void* bias,
                        void* out, void* ws, long long ws_bytes, int n, int z, int y,
                        int xd, int ca, int cb, int cout, int coutp, int bn,
                        void* stream) {
  return run(a, b, ca, cb, w, bias, nullptr, nullptr, 0.f, out, nullptr, ws, ws_bytes, n,
             z, y, xd, cout, coutp, bn, stream);
}

// Kernel D: out = conv(lrelu(bf16(x * scale + shift))) + bias with the SAME
// halo at zero (scale, shift (n, cin) fp32; both null: conv(x) + bias), and
// stats (n, 2, cout) fp32, the per-sample channel sum and sum of squares of
// the bf16 out.
int mt_conv3d_same_affine(const void* x, const void* w, const void* bias,
                          const void* scale, const void* shift, float slope, void* out,
                          void* stats, void* ws, long long ws_bytes, int n, int z, int y,
                          int xd, int cin, int cout, int coutp, int bn, void* stream) {
  if (stats == nullptr || (scale == nullptr) != (shift == nullptr))
    return (int)cudaErrorInvalidValue;
  return run(x, nullptr, cin, 0, w, bias, scale, shift, slope, out, stats, ws, ws_bytes, n,
             z, y, xd, cout, coutp, bn, stream);
}

// Kernel D, dual form: kernel B's conv over concat(a, b) with D's stats.
int mt_conv3d_same_dual_stats(const void* a, const void* b, const void* w,
                              const void* bias, void* out, void* stats, void* ws,
                              long long ws_bytes, int n, int z, int y, int xd, int ca,
                              int cb, int cout, int coutp, int bn, void* stream) {
  if (stats == nullptr || b == nullptr) return (int)cudaErrorInvalidValue;
  return run(a, b, ca, cb, w, bias, nullptr, nullptr, 0.f, out, stats, ws, ws_bytes, n, z,
             y, xd, cout, coutp, bn, stream);
}

const char* mt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
