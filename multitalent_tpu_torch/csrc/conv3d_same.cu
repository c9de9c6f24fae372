// Stride-1 SAME 3x3x3 convolution, channels-last bf16, fp32 accumulation.
//
// Replaces three Pallas TPU kernels of multitalent_tpu:
//   - ops/pallas_conv.py  _conv_kernel       (dense 27-tap conv, C >= 120)
//   - ops/pallas_merged_conv.py _merged_kernel  (the same conv on a
//     space-to-depth packed tensor: that packing only fills the TPU's
//     128-lane matrix unit, so here it runs unpacked at the true C)
//   - ops/pallas_merged_conv.py _merged2_kernel (conv over concat(a, b)
//     without building the concat) -> the NIN == 2 instantiations below.
// and, as kernel D, a fourth:
//   - ops/pallas_conv.py _conv_affine_kernel (the fused conv -> InstanceNorm
//     chain): the same conv with a normalize prologue (AFFINE: the staged
//     halo box becomes lrelu(bf16(x * scale[n, c] + shift[n, c])) before any
//     ldmatrix, the SAME halo and padding channels left at 0) and a stats
//     epilogue (STATS: per-channel sum and sum of squares of the
//     bf16-rounded, bias-added output, per-block partials added in a fixed
//     order by fused_norm.cu's reduce_rows; deterministic, no atomics). Where
//     the K loop is split, the split-K reduce takes the stats as it writes
//     the output (splitk_reduce_stats, below). The dual form (NIN == 2 with
//     STATS) serves a decoder's first conv. What D saves: the normalize
//     pass's read and write of the activation and the stats pass's read
//     (~0.6 GB at stage 0 with N=1); the prologue adds ~7 elementwise ops per
//     staged element, once per K chunk, not per tap.
// and the probe kernel scripts/pallas_sparse_conv_arm.py _sparse_kernel
// (pallas_call at :287) -> the ring body's PACKED instantiations,
// `mt_packed_conv3d`: kernel A's conv read and written space-to-depth packed
// (N, Z, Y/fy, X/fx, fy*fx*C), phase-major, of up to 4 concatenated input
// groups (load_lines_packed gives the layout). The TPU kernel merges the
// block-sparse packed taps into 12 or 18 GEMMs (1.33x the direct conv's
// FLOPs); here the packing only decides addresses, at 1x: the loader reads
// each voxel's row at its packed place, the epilogue writes it there. It
// runs A's plan at the unpacked sizes with the K loop whole (a split's
// partials are unpacked), so where A's own plan has one split its output is
// A's bit for bit.
//
// Two bodies. The ring body (conv3d_a_kernel, below), built for the H100's
// narrow stage-0 and stage-1 rows, serves kernel D and the packed conv at
// every size, and kernels A, B and D's dual form wherever a row is narrower
// than 16-byte copies (30, 60, odd C), the weights stay resident, or (one
// input) the K loop is split. Where every row takes 16-byte copies (each
// input's C % 8 == 0), the weights are streamed and the ring does not take
// the call, kernels A (every dx included), B and D's dual form run the wgmma
// body of conv3d_wgmma.cu (TMA halo boxes, one staged box for all 27 taps,
// warp-specialised; 48-768 channels: the flagship's 120-320, the Liver
// net's, SwinUNETR's; D's dual form with its stats in the epilogue or, with
// a split K loop, in the split-K reduce).
//
// What bounds the ring body on an H100: the flagship's convs carry ~27*C FLOPs
// per input byte, well above the ~295 FLOP/byte ridge, so the tensor cores
// should be the limit. The mma.sync products (no wgmma) and their ldmatrix
// reads now bound it: measured on the card, the ring body at 30 and 60
// channels runs ~6-8 us a 256-voxel stage, about what its 27-tap ldmatrix
// and mma.sync issue takes when the two do not overlap, with the copies in
// flight behind them (PERF.md, section 6). What it does:
//   - persistent blocks walk output tiles in a fixed order on a ring of 2-3
//     stages (cp.async commit groups, one barrier a stage): a stage is one
//     tile's haloed input box for a group of K chunks, so the next tile's
//     copies fly while this one's products run;
//   - C's line loader (common.cuh's load_lines): warps take (z, y) lines of
//     the halo and lanes step by constant strides, 4-, 8- or 16-byte copies
//     as C allows; at 30 channels both K chunks of the 60-byte row are
//     staged at once (80-byte rows, conflict-free), so the row is read once;
//   - weights resident for the block's life where they fit beside the ring
//     (stage 0: 69 KB at 30 -> 30, 124 KB for the 30 -> 60 dx), else
//     streamed with each halo; at 30 channels the two 8-warp groups take one
//     K chunk each (their sums meet in shared memory): a third fewer
//     ldmatrix reads than an N split;
//   - K is split only to fill one wave of blocks, and never into more fp32
//     partial bytes than the input and weights hold; with one split the
//     epilogue writes bf16(acc + bias) directly; no atomics (bit-equal
//     outputs from call to call);
//   - channels past the input's are zeroed in every staged halo (they meet
//     zero weight rows, but 0 * NaN is NaN);
//   - B and D's dual form stage a's rows, then b's (at 30 + 30: a, b, a, b,
//     both chunks of a row at once), their four chunks' weights resident in
//     XOR-swizzled 64-byte rows so that two stages fit; D normalizes each
//     staged box in place by lines (16-byte units, no division a voxel), one
//     stage ahead of the products where 3 stages fit (stage 0: the column
//     split), else after the stage's barrier with one more; its stats are
//     summed by each warp in shared memory a tile and added across warps
//     once a sample a block;
//   - the packed conv (PACKED) stages the same lines from the packed tensor
//     (load_lines_packed: a lane's group is fixed for the stage and it
//     carries x % fx along its line, no division a voxel) and writes each
//     output voxel's row at its packed place.
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

constexpr int SK_COLS = 64;     // columns a block of splitk_stats_kernel
constexpr int SK_LANES = 4;     // its voxels side by side
constexpr int SK_MAX_ROWS = 256;  // its rows a sample: reduce_rows adds them in one pass

// Kernel D's split-K reduce: block (run, column block, n) adds the splits of
// voxels [run * per_run, + per_run) of sample n at columns [column block *
// SK_COLS, + SK_COLS), in splitk_reduce_kernel's order (so that the output
// is B's bit for bit), stores bf16 and sums the stored values per column:
// SK_LANES voxels side by side, their sums added in lane order into row
// (n, run) of part (n, gridDim.x, 2, cout).
__global__ void __launch_bounds__(SK_COLS * SK_LANES)
    splitk_stats_kernel(const float* __restrict__ ws, const float* __restrict__ bias,
                        __nv_bfloat16* __restrict__ out, float* __restrict__ part, int64_t s,
                        int cout, int splits, int per_run) {
  __shared__ float red[SK_LANES][2][SK_COLS];
  const int run = blockIdx.x, n = blockIdx.z;
  const int tc = threadIdx.x % SK_COLS, j = threadIdx.x / SK_COLS;
  const int c = blockIdx.y * SK_COLS + tc;
  const int64_t count = (int64_t)gridDim.z * s * cout;
  const int64_t v0 = (int64_t)run * per_run, v1 = v0 + per_run < s ? v0 + per_run : s;
  float sum = 0.f, sq = 0.f;
  if (c < cout) {
    const float b = bias != nullptr ? bias[c] : 0.f;
    for (int64_t v = v0 + j; v < v1; v += SK_LANES) {
      const int64_t i = ((int64_t)n * s + v) * cout + c;
      float val = b;
      for (int k = 0; k < splits; ++k) val += ws[k * count + i];
      const __nv_bfloat16 r = __float2bfloat16(val);
      out[i] = r;
      const float f = __bfloat162float(r);
      sum += f;
      sq += f * f;
    }
  }
  red[j][0][tc] = sum;
  red[j][1][tc] = sq;
  __syncthreads();
  if (threadIdx.x < 2 * SK_COLS) {
    const int k = threadIdx.x / SK_COLS, cc = threadIdx.x % SK_COLS;
    const int co = blockIdx.y * SK_COLS + cc;
    float v = 0.f;
#pragma unroll
    for (int l = 0; l < SK_LANES; ++l) v += red[l][k][cc];
    if (co < cout) part[(((int64_t)n * gridDim.x + run) * 2 + k) * cout + co] = v;
  }
}

// voxels a run of splitk_stats_kernel: about four blocks an SM in all, at
// most SK_MAX_ROWS runs a sample
long long splitk_stats_per_run(int n, long long s, int cout) {
  const long long cols = cdiv(cout, SK_COLS);
  long long rows = (4LL * sm_count() + n * cols - 1) / (n * cols);
  rows = rows < 1 ? 1 : (rows > SK_MAX_ROWS ? SK_MAX_ROWS : rows);
  rows = rows > s ? s : rows;
  return (s + rows - 1) / rows;
}

}  // namespace

cudaError_t mt::splitk_reduce(const float* ws, const float* bias, __nv_bfloat16* out,
                              long long count, int cout, int splits, cudaStream_t stream) {
  const int blocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  splitk_reduce_kernel<<<blocks, 256, 0, stream>>>(ws, bias, out, count, cout, splits);
  return cudaGetLastError();
}

int mt::splitk_stats_rows(int n, long long s, int cout) {
  const long long per = splitk_stats_per_run(n, s, cout);
  return (int)((s + per - 1) / per);
}

cudaError_t mt::splitk_reduce_stats(const float* ws, const float* bias, __nv_bfloat16* out,
                                    float* part, int n, long long s, int cout, int splits,
                                    cudaStream_t stream) {
  const long long per = splitk_stats_per_run(n, s, cout);
  const dim3 grid((unsigned)((s + per - 1) / per), cdiv(cout, SK_COLS), n);
  splitk_stats_kernel<<<grid, SK_COLS * SK_LANES, 0, stream>>>(ws, bias, out, part, s, cout,
                                                               splits, (int)per);
  return cudaGetLastError();
}

namespace {

using namespace mt;

// ---------------------------------------------------------------------------
// The ring body: kernel D, and A, B and D's dual form where their plan takes
// it (at 16-byte rows with streamed weights and a whole K loop, or for two
// inputs any K split, they run conv3d_wgmma.cu's body)
// ---------------------------------------------------------------------------

constexpr int A_SMEM_MAX = 227 * 1024;  // dynamic shared memory of one block
constexpr int MAX_SPLITS = 64;
constexpr int A_WARPS_M = 8;            // warps along the 256 box voxels, 32 each
constexpr int A_MF = BM / (A_WARPS_M * 16);
// two groups of 8 warps, one block an SM: on the H100 this ran faster than
// blocks of 8 warps at every flagship shape (PERF.md, section 6)
constexpr int A_THREADS = 2 * A_WARPS_M * 32;

// A block's shape: G 16-channel K chunks staged at once (G = 2 where the
// input row holds 17-32 channels: the whole 60-byte row of 30 channels in one
// staging), the weights resident for the block's life or streamed through
// the ring beside each halo, and the two 8-warp groups splitting the BN
// output columns or (ksplit, G = 2) the two chunks: each group then keeps
// all BN columns of its chunk, and the groups' sums meet in shared memory
// at each tile's end (two thirds of the ldmatrix reads of an N split at BN
// 32, for one more barrier a tile).
struct AConfig {
  int g, resident, ksplit;
};

// What a launch of the body computes: kernel A (one input), B (two inputs,
// the K loop over a's chunks, then b's), D (one input, the normalize
// prologue and the stats epilogue) or D's dual form (two inputs, the stats).
// PACKED: kernel A's conv of the packed conv's tensors.
struct AForm {
  int nin;
  bool affine, stats, packed;
};
constexpr AForm FORM_A{1, false, false}, FORM_B{2, false, false}, FORM_D{1, true, true},
    FORM_D_DUAL{2, false, true}, FORM_PACKED{1, false, false, true};

// Two inputs with both chunks of their 17-32-channel rows staged at once
// keep four chunks' weights resident: in 64-byte rows, the 16-byte unit u of
// row r at u ^ (r / 2 % 4) (every ldmatrix still conflict-free), in place of
// BN + 8 padded rows: 108 KB in place of 135, so that two stages fit beside
// them.
__host__ __device__ constexpr bool a_swizzled(int nin, int bn, int g, bool resident,
                                              bool ksplit) {
  return nin == 2 && bn == 32 && g == 2 && resident && !ksplit;
}

struct APlan {
  bool ring;   // this body; false: the wgmma body
  bool wgmma;  // conv3d_wgmma.cu's body (where ring is false), with plan h
  HPlan h;
  AConfig cfg;
  Box box;
  int tiles_z, tiles_y, tiles_x;
  int tiles;  // N * boxes of a sample
  int kchunks;
  int splits, per_split;  // K chunks of a split (a multiple of G)
  int stages;             // ring stages: 2 or 3
  int grid_x;             // blocks walking the tiles of one (column block, split)
  int smem;               // dynamic shared memory bytes of a block
  int blocks_per_sm;
};

constexpr int MAX_GROUPS = 4;  // input groups of the packed conv

// The packed conv: factors (fy, fx) of input and output, the input's groups
// as unpacked channel ranges, and the copy width in elements (8, 4, 2 or 1:
// the largest that divides every group's size).
struct APacked {
  int fy, fx, vec, ngroups;
  int gbase[MAX_GROUPS], gsize[MAX_GROUPS];
};

struct AParams {
  const __nv_bfloat16* src;
  const __nv_bfloat16* w;
  const float* bias;  // may be null
  __nv_bfloat16* out;
  float* ws;  // split-K partials (splits, N*Z*Y*X, Cout), when splits > 1
  int z, y, x, cin, cout, coutp;
  APlan plan;
  // B and D: input b (NIN == 2; its K chunks follow a's kchunks0), the
  // prologue's scale and shift (N, Cin) fp32 and slope (AFFINE; null: no
  // prologue), the stats' per-block partials (N, grid_x, 2, Cout) fp32
  // (STATS)
  const __nv_bfloat16* src2;
  int cin2, kchunks0;
  const float* scale;
  const float* shift;
  float slope;
  float* part;
  APacked pk;  // PACKED
};

// The packed conv's element offset of the row of unpacked output voxel (nb,
// z, y, x): tight phase-major.
__device__ __forceinline__ int64_t packed_row(const APacked& pk, int nb, int z, int y, int x,
                                              int n_z, int n_y, int n_x) {
  const int yq = y / pk.fy, xq = x / pk.fx;
  return ((((int64_t)nb * n_z + z) * (n_y / pk.fy) + yq) * (n_x / pk.fx) + xq) *
             (pk.fy * pk.fx) +
         (y - yq * pk.fy) * pk.fx + x - xq * pk.fx;
}

// load_lines from the packed conv's input: channel c of the group at
// unpacked channels [gbase, gbase + gsize) of voxel (nb, gz, gy, gx) sits at
//   vox * P * C + gbase * P + phase * gsize + (c - gbase),
//   vox = ((nb * Z + gz) * Y / fy + gy / fy) * X / fx + gx / fx,
//   phase = (gy % fy) * fx + gx % fx
// (multitalent_tpu/ops/packed_conv.py:59-67, scripts/pallas_sparse_conv_arm.py:68-85;
// probes/sparse_conv_arm.py:packed_source_offsets mirrors it). A unit of
// pk.vec channels never straddles a group; along a line a lane steps by vpi
// = aq * fx + ar voxels, carrying gx % fx: no division a voxel.
template <int NWARPS>
__device__ __forceinline__ void load_lines_packed(__nv_bfloat16* dst, int stride,
                                                  const __nv_bfloat16* __restrict__ src,
                                                  const APacked& pk, int c, int c0,
                                                  const LaneMap& m, int len, int lines, int by,
                                                  int n_z, int n_y, int n_x, int nb, int z0,
                                                  int y0, int x0, int warp) {
  if (m.j >= m.vpi) return;
  const int fy = pk.fy, fx = pk.fx, pc = fy * fx * c, yp = n_y / fy, xp = n_x / fx;
  const int vlo = max(0, -x0), vhi = min(len, n_x - x0);  // voxels inside along x
  // the lane's first voxel x0 + j (>= -1) as xq0 * fx + xr0
  const int xq0 = (x0 + m.j + fx) / fx - 1, xr0 = x0 + m.j - xq0 * fx;
  const int aq = m.vpi / fx, ar = m.vpi - aq * fx, d_step = m.vpi * stride;
  for (int u = m.u; u < m.units; u += m.per_vox) {
    const int cu = c0 + u * m.vec;
    // its group, by selects: a runtime index would copy pk to local memory
    int gbase = 0, gsize = pk.gsize[0];
#pragma unroll
    for (int g = 1; g < MAX_GROUPS; ++g) {
      if (g < pk.ngroups && cu >= pk.gbase[g]) {
        gbase = pk.gbase[g];
        gsize = pk.gsize[g];
      }
    }
    const int chan = gbase * fy * fx + cu - gbase;
    const int s_step = aq * pc + ar * gsize, s_carry = pc - fx * gsize;
    for (int l = warp; l < lines; l += NWARPS) {
      const int vz = l / by, vy = l - vz * by;
      const int gz = z0 + vz, gy = y0 + vy, yq = gy / fy;
      const bool line_in = gz >= 0 && gz < n_z && gy >= 0 && gy < n_y;
      const __nv_bfloat16* s_line =
          src + (((int64_t)nb * n_z + gz) * yp + yq) * xp * pc +
          (gy - yq * fy) * fx * gsize + chan;
      __nv_bfloat16* d_line = dst + l * len * stride;
      int s_off = xq0 * pc + xr0 * gsize, xr = xr0, d_off = m.j * stride + u * m.vec;
      for (int v = m.j; v < len; v += m.vpi, d_off += d_step) {
        const bool in = line_in && v >= vlo && v < vhi;
        cp_async_vec(d_line + d_off, in ? s_line + s_off : src, in, m.vec);
        s_off += s_step;
        xr += ar;
        if (xr >= fx) {
          xr -= fx;
          s_off += s_carry;
        }
      }
    }
  }
}

// Kernel D's prologue on one staged box, in place: channels [0, width) of
// every voxel inside the volume become lrelu(bf16(x * scale + shift)) (sc,
// sh: this sample's scale and shift from the stage's first channel on).
// Each access is one 16-byte unit of 8 channels of a voxel's row, over the
// row's `units` units (the staged chunks): units past width take scale and
// shift 0 and so stay 0, as the staging left them. It walks the box by
// lines as load_lines stages it: a warp takes a (z, y) line, knows whether
// it lies in the volume and its clipped x range, and a lane keeps one unit,
// its scale and shift in registers, with no division a voxel. Voxels
// outside the volume stay as the copies zero-filled them: the SAME halo
// reads 0, not lrelu(shift). The arithmetic is cast_lrelu's: x * s + t in
// fp32, one rounding to bf16, the slope on the bf16 value and one more
// rounding, taken where the bf16 value's sign bit is set (y >= 0 keeps y;
// -0 and NaN give the same bits either way).
template <int NW>
__device__ __forceinline__ void normalize_lines(__nv_bfloat16* stage, int stride, int units,
                                                int width, const float* __restrict__ sc,
                                                const float* __restrict__ sh, float slope,
                                                int len, int lines, int by, int n_z, int n_y,
                                                int n_x, int z0, int y0, int x0, int warp,
                                                int lane) {
  const int u = lane % units, vpi = 32 / units, j = lane / units;
  float s[8], t[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int c = u * 8 + e;
    s[e] = c < width ? sc[c] : 0.f;
    t[e] = c < width ? sh[c] : 0.f;
  }
  const int vlo = max(0, -x0), vhi = min(len, n_x - x0);  // voxels inside along x
  for (int l = warp; l < lines; l += NW) {
    const int vz = l / by, vy = l - vz * by;
    const int gz = z0 + vz, gy = y0 + vy;
    if (gz < 0 || gz >= n_z || gy < 0 || gy >= n_y) continue;
    for (int v = vlo + j; v < vhi; v += vpi) {
      uint4* d = reinterpret_cast<uint4*>(stage + (l * len + v) * stride + u * 8);
      uint4 raw = *d;
      uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[e]));
        __nv_bfloat162 y = __floats2bfloat162_rn(fmaf(f.x, s[2 * e], t[2 * e]),
                                                 fmaf(f.y, s[2 * e + 1], t[2 * e + 1]));
        const float2 g = __bfloat1622float2(y);
        __nv_bfloat162 z = __floats2bfloat162_rn(g.x * slope, g.y * slope);
        const uint32_t yb = *reinterpret_cast<uint32_t*>(&y);
        const uint32_t zb = *reinterpret_cast<uint32_t*>(&z);
        const uint32_t neg = ((yb >> 15) & 0x00010001u) * 0xffffu;  // halves with y < 0
        w[e] = (yb & ~neg) | (zb & neg);
      }
      *d = raw;
    }
  }
}

// Persistent blocks: block (bx, nblk, split) walks tiles bx, bx + gridDim.x,
// .. for output columns [nblk * BN, + BN) and K chunks [split * per_split,
// + per_split). One ring stage is one (tile, group of G chunks): its haloed
// input box and, unless the weights are resident, the group's weights; the
// next stages' copies are in flight while this one's products run, so the
// next tile's first copies overlap this tile's last products. One barrier a
// stage. Warp w owns voxels [(w % 8) * 32, + 32) of the box and columns
// [(w / 8) * BN / 2, + BN / 2), or with KSPLIT all BN columns of chunk w / 8
// of the stage.
//
// NIN == 2 (kernel B, D's dual form): the K loop runs over a's chunks, then
// b's, each stage staging its own input's rows (at 30 + 30 channels the
// stages alternate a, b, a, b). AFFINE (kernel D): the prologue normalizes
// each stage in place, one stage ahead of the products where the ring has 3
// stages, else after the stage's barrier with one more barrier. STATS: each
// warp adds its columns' sums of bf16(acc + bias) over a tile's voxels
// inside the volume to its own shared-memory slots (no barrier a tile);
// where a block's walk leaves a sample (tiles are sample-major), the next
// stage's barrier passes and the slots of its 8 warps are added in a fixed
// order into row (n, blockIdx.x) of p.part (two sets of slots, so the next
// sample's tiles add into the other meanwhile); rows of samples the walk
// skips are 0. No state is carried through the loop for it (registers are
// at the ring's limit of 128): a tile's set and whether it ends its sample
// follow from its index. Only with one split: a split's partials are not
// the output.
template <int BN, int G, bool RESIDENT, bool KSPLIT, int NIN = 1, bool AFFINE = false,
          bool STATS = false, bool PACKED = false>
__global__ void __launch_bounds__(A_THREADS, 1) conv3d_a_kernel(AParams p) {
  static_assert(!KSPLIT || (G == 2 && RESIDENT), "one chunk a warp group");
  static_assert(!AFFINE || NIN == 1, "the prologue reads one input");
  static_assert(!KSPLIT || (NIN == 1 && !AFFINE && !STATS), "the K split serves kernel A");
  static_assert(!PACKED || (NIN == 1 && !AFFINE && !STATS), "the packed conv is kernel A's");
  constexpr int NTHREADS = A_THREADS;
  constexpr int NWARPS = NTHREADS / 32;
  constexpr bool SWZ = a_swizzled(NIN, BN, G, RESIDENT, KSPLIT);
  constexpr int XS = G * KC + 8;              // halo row stride in bf16: 48 or 80 B
  constexpr int BNP = SWZ ? BN : BN + 8;      // weight row stride in bf16
  constexpr int WCHUNK = 27 * KC * BNP;       // one chunk's weights in shared memory
  constexpr int NT = BN / 8 / (KSPLIT ? 1 : 2);  // n8 tiles of a warp
  constexpr int NACC = A_MF * NT * 4;         // accumulators of a thread
  static_assert(NT % 2 == 0, "B fragments come in pairs of n8 tiles");
  static_assert(!SWZ || NT == 2, "a swizzled warp reads one pair of n8 tiles");
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);

  const Box box = p.plan.box;
  const int hx = box.x + 2, hy = box.y + 2, hz = box.z + 2;
  const int halo_vox = hz * hy * hx;
  const int halo_elems = halo_vox * XS;
  const int stage_elems = halo_elems + (RESIDENT ? 0 : G * WCHUNK);
  const int stages = p.plan.stages;
  __nv_bfloat16* wres = ring + stages * stage_elems;  // resident weights
  const int nblk = blockIdx.y, split = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_z = p.z, n_y = p.y, n_x = p.x, cin = p.cin, coutp = p.coutp;
  const int tiles_x = p.plan.tiles_x, tiles_y = p.plan.tiles_y;
  const int tiles_yx = tiles_y * tiles_x, tiles_s = p.plan.tiles_z * tiles_yx;
  const int k_lo = split * p.plan.per_split;
  const int k_hi = min(p.plan.kchunks, k_lo + p.plan.per_split);
  const int ngrp = (k_hi - k_lo + G - 1) / G;  // stages of a tile
  const int bx = blockIdx.x, gx = gridDim.x;
  const int ntile = p.plan.tiles > bx ? (p.plan.tiles - bx + gx - 1) / gx : 0;
  const int nq = ntile * ngrp;
  const int vec = PACKED ? p.pk.vec : vec_of(cin);
  const int vec2 = NIN == 2 ? vec_of(p.cin2) : 0;
  const __nv_bfloat16* __restrict__ src = p.src;
  const __nv_bfloat16* __restrict__ src2 = p.src2;
  const __nv_bfloat16* __restrict__ wsrc = p.w + nblk * BN;

  // the corner of this block's k-th tile
  auto tile_at = [&](int k, int& nb, int& z0, int& y0, int& x0) {
    const int t = bx + k * gx;
    nb = t / tiles_s;
    const int r = t - nb * tiles_s;
    z0 = (r / tiles_yx) * box.z;
    y0 = ((r / tiles_x) % tiles_y) * box.y;
    x0 = (r % tiles_x) * box.x;
  };
  // chunk kc's (27, 16, BN) weight slice of this column block into dst
  auto load_wchunk = [&](__nv_bfloat16* dst, int kc) {
    constexpr int VPR = BN / 8;  // 16-byte copies a row
    const __nv_bfloat16* s = wsrc + (int64_t)kc * 27 * KC * coutp;
    for (int i = threadIdx.x; i < 27 * KC * VPR; i += NTHREADS) {
      const int row = i / VPR, col = (i % VPR) * 8;
      const int dcol = SWZ ? ((col / 8) ^ (row / 2 % 4)) * 8 : col;
      cp_async16(dst + row * BNP + dcol, s + (int64_t)row * coutp + col, true);
    }
  };
  // stage q (tile q / ngrp, chunk group q % ngrp) into ring stage s
  auto issue = [&](int q, int s) {
    const int k = q / ngrp;
    const int kc = k_lo + (q - k * ngrp) * G;
    int nb, z0, y0, x0;
    tile_at(k, nb, z0, y0, x0);
    // selects, not an indexed input: a runtime index would copy p to local
    // memory
    const bool second = NIN == 2 && kc >= p.kchunks0;
    const int cin_s = second ? p.cin2 : cin;
    const int c0 = (kc - (second ? p.kchunks0 : 0)) * KC, width = min(G * KC, cin_s - c0);
    __nv_bfloat16* stage = ring + s * stage_elems;
    if constexpr (PACKED) {
      load_lines_packed<NWARPS>(stage, XS, src, p.pk, cin, c0, lane_map(width, vec, lane), hx,
                                hz * hy, hy, n_z, n_y, n_x, nb, z0 - 1, y0 - 1, x0 - 1, warp);
    } else {
      load_lines<NWARPS>(stage, XS, second ? src2 : src, cin_s, c0,
                         lane_map(width, second ? vec2 : vec, lane), hx, hz * hy, hy, n_z, n_y,
                         n_x, nb, z0 - 1, y0 - 1, x0 - 1, warp);
    }
    // channels past the input's meet zero weight rows, but 0 * NaN is NaN:
    // they are set to 0 here (the stage is free: everyone passed the
    // barrier after its last reads), seen by all after the next barrier
    const int pad = G * KC - width;
    for (int i = threadIdx.x; i < halo_vox * pad; i += NTHREADS) {
      const int v = i / pad;
      stage[v * XS + width + (i - v * pad)] = __float2bfloat16(0.f);
    }
    if constexpr (!RESIDENT) {
#pragma unroll
      for (int g = 0; g < G; ++g) load_wchunk(stage + halo_elems + g * WCHUNK, kc + g);
    }
  };

  // ldmatrix rows: lane l addresses row l % 16 of each of this warp's M
  // fragments (one box voxel each) at K offset (l / 16) * 8; B from the
  // weight rows at this warp's columns
  const int mw = warp % A_WARPS_M, ncol = KSPLIT ? 0 : warp / A_WARPS_M * NT * 8;
  const int kgrp = warp / A_WARPS_M;  // KSPLIT: this warp's chunk of the stage
  // KSPLIT: group 1's sums on their way to group 0, lane-minor
  float* red = reinterpret_cast<float*>(wres + p.plan.kchunks * WCHUNK) + mw * NACC * 32 + lane;
  int a_row[A_MF];
#pragma unroll
  for (int mi = 0; mi < A_MF; ++mi) {
    const int m = (mw * A_MF + mi) * 16 + lane % 16;
    const int vz = m / (box.y * box.x), vy = (m / box.x) % box.y, vx = m % box.x;
    a_row[mi] = ((vz * hy + vy) * hx + vx) * XS + (lane / 16) * 8;
  }
  const int b_off =
      SWZ ? (lane % 16) * BNP + ((ncol / 8 + lane / 16) ^ (lane % 16 / 2 % 4)) * 8
          : (lane % 16) * BNP + (lane / 16) * 8 + ncol;

  float acc[A_MF][NT][4];
#pragma unroll
  for (int mi = 0; mi < A_MF; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;

  // STATS: slots [2][A_WARPS_M][2][BN] fp32 after the resident weights.
  // The tiles of one sample add into one set, the next
  // sample's into the other: where the walk steps by more than a sample,
  // every tile is a sample of its own (set k % 2), else it visits every
  // sample from its first on (set n % 2)
  float* slots = reinterpret_cast<float*>(wres + (RESIDENT ? p.plan.kchunks * WCHUNK : 0));
  auto sample_of = [&](int k) { return (bx + k * gx) / tiles_s; };
  auto set_of = [&](int k) { return (gx > tiles_s ? k : sample_of(k)) & 1; };
  auto part_at = [&](int n, int kk, int co) -> float& {
    return p.part[((int64_t)(n * gx + bx) * 2 + kk) * p.cout + co];
  };
  // the sums of tile k's set into row (its sample, bx) of p.part, and the
  // set back to 0
  auto flush = [&](int k) {
    const int nb = sample_of(k);
    for (int t = threadIdx.x; t < 2 * BN; t += NTHREADS) {
      const int kk = t / BN, c = t - kk * BN, co = nblk * BN + c;
      float* slot = slots + (set_of(k) * A_WARPS_M * 2 + kk) * BN + c;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < A_WARPS_M; ++w) {
        v += slot[w * 2 * BN];
        slot[w * 2 * BN] = 0.f;
      }
      if (co < p.cout) part_at(nb, kk, co) = v;
    }
  };
  if constexpr (STATS) {  // slots to 0; 0 in the rows of the samples the walk skips
    for (int i = threadIdx.x; i < 2 * A_WARPS_M * 2 * BN; i += NTHREADS) slots[i] = 0.f;
    const int nsamp = p.plan.tiles / tiles_s;
    for (int t = threadIdx.x; t < 2 * BN; t += NTHREADS) {
      const int kk = t / BN, co = nblk * BN + t - kk * BN;
      if (co >= p.cout) continue;
      for (int n = 0; n < nsamp; ++n) {
        const int k = max(0, cdiv(n * tiles_s - bx, gx));  // the first tile at or past n
        if (k >= ntile || sample_of(k) != n) part_at(n, kk, co) = 0.f;
      }
    }
  }

  if constexpr (RESIDENT) {  // one split: all chunks, in the first commit group
    for (int kc = 0; kc < p.plan.kchunks; ++kc) load_wchunk(wres + kc * WCHUNK, kc);
  }
  for (int s = 0; s < stages - 1; ++s) {
    if (s < nq) issue(s, s);
    cp_async_commit();
  }
  const bool partial = !PACKED && p.plan.splits > 1;
  const int64_t nvox = (int64_t)(p.plan.tiles / tiles_s) * n_z * n_y * n_x;
#pragma unroll 1
  for (int q = 0; q < nq; ++q) {
    // this thread's copies of stage q have landed (the group after it may
    // still fly with 3 stages, not where D's prologue runs ahead: see
    // below), then everyone's have and the stage consumed last is free
    if constexpr (AFFINE) {
      if (stages == 3 && p.scale == nullptr) {
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else if (stages == 3) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (STATS) {  // the last tile's sums are in: flush the sample it ended
      if (q > 0 && q % ngrp == 0 && sample_of(q / ngrp) != sample_of(q / ngrp - 1))
        flush(q / ngrp - 1);
    }
    if (q + stages - 1 < nq) issue(q + stages - 1, (q + stages - 1) % stages);
    cp_async_commit();
    const __nv_bfloat16* halo = ring + (q % stages) * stage_elems;
    const int k = q / ngrp, j = q - k * ngrp;
    const int kc = k_lo + j * G;
    if constexpr (AFFINE) {
      // the prologue on stage qq
      auto normalize = [&](int qq) {
        const int kk = qq / ngrp;
        const int c0 = (k_lo + (qq - kk * ngrp) * G) * KC, width = min(G * KC, cin - c0);
        int nb, z0, y0, x0;
        tile_at(kk, nb, z0, y0, x0);
        const float* sc = p.scale + (int64_t)nb * cin + c0;
        const float* sh = p.shift + (int64_t)nb * cin + c0;
        normalize_lines<NWARPS>(ring + (qq % stages) * stage_elems, XS, G * KC / 8, width, sc,
                                sh, p.slope, hx, hz * hy, hy, n_z, n_y, n_x, z0 - 1, y0 - 1,
                                x0 - 1, warp, lane);
      };
      // with 3 stages the prologue runs one stage ahead: on stage q + 1,
      // landed, while this stage's products run in other warps, so no
      // barrier waits for it; with 2 stages on stage q, then a barrier
      if (p.scale != nullptr && stages == 3) {
        if (q == 0) {  // the first stage before any products
          normalize(0);
          if (nq > 1) normalize(1);
          __syncthreads();
        } else if (q + 1 < nq) {
          normalize(q + 1);
        }
      } else if (p.scale != nullptr) {
        normalize(q);
        __syncthreads();
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (KSPLIT && g != kgrp) continue;
      const __nv_bfloat16* wch =
          (RESIDENT ? wres + (kc + g) * WCHUNK : halo + halo_elems + g * WCHUNK) + b_off;
#pragma unroll 1
      for (int zy = 0; zy < 9; ++zy) {  // taps (dz, dy, 0..2): three in flight
        const int dz = zy / 3, dy = zy % 3;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int tap_off = ((dz * hy + dy) * hx + dx) * XS + g * KC;
          uint32_t a[A_MF][4];
#pragma unroll
          for (int mi = 0; mi < A_MF; ++mi) ldmatrix_x4(a[mi], halo + a_row[mi] + tap_off);
          const __nv_bfloat16* wt = wch + (zy * 3 + dx) * KC * BNP;
#pragma unroll
          for (int jn = 0; jn < NT; jn += 2) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, wt + jn * 8);
#pragma unroll
            for (int mi = 0; mi < A_MF; ++mi) {
              mma_16816(acc[mi][jn], a[mi], b[0], b[1]);
              mma_16816(acc[mi][jn + 1], a[mi], b[2], b[3]);
            }
          }
        }
      }
    }
    if (j != ngrp - 1) continue;
    if constexpr (KSPLIT) {  // one stage a tile: group 1's sums into group 0's
      if (kgrp == 1) {
#pragma unroll
        for (int mi = 0; mi < A_MF; ++mi)
#pragma unroll
          for (int jn = 0; jn < NT; ++jn)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              red[((mi * NT + jn) * 4 + e) * 32] = acc[mi][jn][e];
              acc[mi][jn][e] = 0.f;
            }
      }
      __syncthreads();  // group 0 reads them before the next stage's barrier
      if (kgrp == 1) continue;
#pragma unroll
      for (int mi = 0; mi < A_MF; ++mi)
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][jn][e] += red[((mi * NT + jn) * 4 + e) * 32];
    }
    // the tile's epilogue, registers to device memory: accumulator element
    // e of tile (mi, jn) is voxel row lane / 4 (+8 for e >= 2), channel
    // 2 * (lane % 4) + (e & 1); bf16(acc + bias) with one split, else the
    // fp32 partials of this split
    int nb, z0, y0, x0;
    tile_at(k, nb, z0, y0, x0);
#pragma unroll
    for (int mi = 0; mi < A_MF; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (mw * A_MF + mi) * 16 + lane / 4 + h * 8;
        const int oz = z0 + m / (box.y * box.x), oy = y0 + (m / box.x) % box.y,
                  ox = x0 + m % box.x;
        if (oz >= n_z || oy >= n_y || ox >= n_x) continue;
        const int64_t vox = (((int64_t)nb * n_z + oz) * n_y + oy) * n_x + ox;
        const int64_t orow = PACKED ? packed_row(p.pk, nb, oz, oy, ox, n_z, n_y, n_x) : vox;
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) {
          const int co = nblk * BN + ncol + jn * 8 + (lane % 4) * 2;
          if (co >= p.cout) continue;
          float v0 = acc[mi][jn][h * 2], v1 = acc[mi][jn][h * 2 + 1];
          if (partial) {
            float* dst = p.ws + ((int64_t)split * nvox + vox) * p.cout + co;
            if (p.cout % 2 == 0) {
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
          store_pair(p.out + orow * p.cout, co, p.cout, v0, v1);
        }
      }
    }
    if constexpr (STATS) {  // this warp's column sums of the tile into its slots
      float* slot = slots + (set_of(k) * A_WARPS_M + mw) * 2 * BN;
      const bool full = z0 + box.z <= n_z && y0 + box.y <= n_y && x0 + box.x <= n_x;
      bool inside[A_MF][2];
#pragma unroll
      for (int mi = 0; mi < A_MF; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = (mw * A_MF + mi) * 16 + lane / 4 + h * 8;
          inside[mi][h] = full || (z0 + m / (box.y * box.x) < n_z &&
                                   y0 + (m / box.x) % box.y < n_y && x0 + m % box.x < n_x);
        }
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) {
        const int c = ncol + jn * 8 + (lane % 4) * 2, co = nblk * BN + c;
        const float b0 = p.bias != nullptr && co < p.cout ? p.bias[co] : 0.f;
        const float b1 = p.bias != nullptr && co + 1 < p.cout ? p.bias[co + 1] : 0.f;
        float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
        for (int mi = 0; mi < A_MF; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (!inside[mi][h]) continue;
            const float r0 = __bfloat162float(__float2bfloat16(acc[mi][jn][h * 2] + b0));
            const float r1 = __bfloat162float(__float2bfloat16(acc[mi][jn][h * 2 + 1] + b1));
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
          slot[c] += s0;
          slot[c + 1] += s1;
          slot[BN + c] += q0;
          slot[BN + c + 1] += q1;
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < A_MF; ++mi)
#pragma unroll
      for (int jn = 0; jn < NT; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][jn][e] = 0.f;
  }
  cp_async_wait<0>();  // no copy outlives the block
  if constexpr (STATS) {  // the last sample's sums
    __syncthreads();
    if (ntile > 0) flush(ntile - 1);
  }
}

using AKernel = void (*)(AParams);

struct AEntry {
  int bn;
  AConfig c;
  AKernel fn;
};
// Kernel A. G = 2 only with resident weights: a streamed stage of both
// chunks' weights leaves no room for a second stage. At BN 32 the K split
// always fits (two stages of the largest halo, the weights and its sums: 212
// KB), at BN 64 never
const AEntry kAKernels[] = {
    {32, {1, 0, 0}, conv3d_a_kernel<32, 1, false, false>},
    {32, {1, 1, 0}, conv3d_a_kernel<32, 1, true, false>},
    {32, {2, 1, 1}, conv3d_a_kernel<32, 2, true, true>},
    {64, {1, 0, 0}, conv3d_a_kernel<64, 1, false, false>},
    {64, {1, 1, 0}, conv3d_a_kernel<64, 1, true, false>},
    {64, {2, 1, 0}, conv3d_a_kernel<64, 2, true, false>},
};

struct AFormEntry {
  AForm form;
  int bn;
  AConfig c;
  AKernel fn;
};
// B and D. D as A but the K split (at 30 channels the column split fits 3
// stages, so the prologue runs ahead of the products: 1.69 vs 1.86 ms
// queued, PERF.md section 6), and without the stats for a split K loop
// (streamed weights only; the split-K reduce takes them). B and D's dual form: two inputs of 17-32
// channels keep their four chunks' weights resident only swizzled with the
// columns split (K split: 239 KB) and never at BN 64 (248 KB of weights)
const AFormEntry kFormKernels[] = {
    {FORM_D, 32, {1, 0, 0}, conv3d_a_kernel<32, 1, false, false, 1, true, true>},
    {FORM_D, 32, {1, 1, 0}, conv3d_a_kernel<32, 1, true, false, 1, true, true>},
    {FORM_D, 32, {2, 1, 0}, conv3d_a_kernel<32, 2, true, false, 1, true, true>},
    {FORM_D, 64, {1, 0, 0}, conv3d_a_kernel<64, 1, false, false, 1, true, true>},
    {FORM_D, 64, {1, 1, 0}, conv3d_a_kernel<64, 1, true, false, 1, true, true>},
    {FORM_D, 64, {2, 1, 0}, conv3d_a_kernel<64, 2, true, false, 1, true, true>},
    {{1, true, false}, 32, {1, 0, 0}, conv3d_a_kernel<32, 1, false, false, 1, true, false>},
    {{1, true, false}, 64, {1, 0, 0}, conv3d_a_kernel<64, 1, false, false, 1, true, false>},
    {FORM_D_DUAL, 32, {1, 0, 0}, conv3d_a_kernel<32, 1, false, false, 2, false, true>},
    {FORM_D_DUAL, 32, {1, 1, 0}, conv3d_a_kernel<32, 1, true, false, 2, false, true>},
    {FORM_D_DUAL, 32, {2, 1, 0}, conv3d_a_kernel<32, 2, true, false, 2, false, true>},
    {FORM_D_DUAL, 64, {1, 0, 0}, conv3d_a_kernel<64, 1, false, false, 2, false, true>},
    {FORM_D_DUAL, 64, {1, 1, 0}, conv3d_a_kernel<64, 1, true, false, 2, false, true>},
    {FORM_B, 32, {1, 0, 0}, conv3d_a_kernel<32, 1, false, false, 2>},
    {FORM_B, 32, {1, 1, 0}, conv3d_a_kernel<32, 1, true, false, 2>},
    {FORM_B, 32, {2, 1, 0}, conv3d_a_kernel<32, 2, true, false, 2>},
    {FORM_B, 64, {1, 0, 0}, conv3d_a_kernel<64, 1, false, false, 2>},
    {FORM_B, 64, {1, 1, 0}, conv3d_a_kernel<64, 1, true, false, 2>},
    // the packed conv: kernel A's configs at the packed calls' shapes (30 and
    // 32 channels: K split by the warp groups; 13 and 60 -> 24: resident;
    // 48 -> 40 and 60 -> 60: streamed), and the streamed ones at each BN,
    // which fit any width
    {FORM_PACKED, 32, {2, 1, 1}, conv3d_a_kernel<32, 2, true, true, 1, false, false, true>},
    {FORM_PACKED, 32, {1, 1, 0}, conv3d_a_kernel<32, 1, true, false, 1, false, false, true>},
    {FORM_PACKED, 32, {1, 0, 0}, conv3d_a_kernel<32, 1, false, false, 1, false, false, true>},
    {FORM_PACKED, 64, {1, 0, 0}, conv3d_a_kernel<64, 1, false, false, 1, false, false, true>},
};

bool same_config(const AConfig& a, const AConfig& b) {
  return a.g == b.g && a.resident == b.resident && a.ksplit == b.ksplit;
}

// The instantiation of `form` at (bn, c); null where there is none.
AKernel a_kernel(const AForm& form, int bn, const AConfig& c) {
  if (form.nin == 1 && !form.affine && !form.stats && !form.packed) {
    for (const AEntry& e : kAKernels)
      if (e.bn == bn && same_config(e.c, c)) return e.fn;
    return nullptr;
  }
  for (const AFormEntry& e : kFormKernels)
    if (e.form.nin == form.nin && e.form.affine == form.affine && e.form.stats == form.stats &&
        e.form.packed == form.packed && e.bn == bn && same_config(e.c, c))
      return e.fn;
  return nullptr;
}

// bytes of dynamic shared memory of a config with `stages` ring stages
int a_smem(const AForm& form, const AConfig& c, const Box& b, int bn, int kchunks, int stages) {
  const bool swz = a_swizzled(form.nin, bn, c.g, c.resident, c.ksplit);
  const long long wchunk = 27 * KC * (swz ? bn : bn + 8);
  const long long stage = (long long)(b.z + 2) * (b.y + 2) * (b.x + 2) * (c.g * KC + 8) +
                          (c.resident ? 0 : c.g * wchunk);
  const long long red = c.ksplit ? 2LL * A_WARPS_M * 32 * A_MF * (bn / 8) * 4 : 0;  // fp32
  const long long slots = form.stats ? 2LL * A_WARPS_M * 2 * bn * 2 : 0;           // fp32
  const long long bytes =
      (stages * stage + (c.resident ? kchunks * wchunk : 0) + red + slots) * 2;
  return bytes > A_SMEM_MAX ? A_SMEM_MAX + 1 : (int)bytes;
}

// Blocks of kernel fn an SM holds at smem bytes (0 where none fits or the
// query fails).
int a_occupancy(AKernel fn, int threads, int smem) {
  const void* f = reinterpret_cast<const void*>(fn);
  int blocks = 0;
  if (cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, A_SMEM_MAX) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, f, threads, smem) != cudaSuccess)
    return 0;
  return blocks;
}

// The plan of a call of `form` on inputs of ca and cb (0: one input)
// channels; false where no config fits. Configs in order of preference: both
// chunks of a 17-32-channel row at once with resident weights (the warp
// groups splitting K, then the columns), one chunk with resident weights,
// one chunk with streamed weights; the first that has an instantiation,
// fits a ring of 2 stages (3 where they fit) and needs no split of K
// (resident weights serve one split). K is split only to fill one wave of
// blocks, and never into more partial bytes than the input and weights
// hold; the packed conv's K loop stays whole. Which body takes the call:
//   - the ring: D and the packed conv at every size, and A, B and D's dual
//     form where a row is narrower than 16-byte copies, the weights stay
//     resident, or one input's K loop is split;
//   - the wgmma body (conv3d_wgmma.cu, its own plan h: BN 64 or 128, its
//     own K splits): A, every dx included, B and D's dual form where the
//     ring does not take the call, i.e. rows of 16-byte copies (every
//     input's C % 8 == 0) with streamed weights and a whole K loop, or two
//     inputs with a split one.
bool make_aplan(const AForm& form, int n, int z, int y, int x, int ca, int cb, int cout,
                int coutp, int bn, int sms, APlan* out) {
  APlan p{};
  p.tiles = (int)(pick_box(z, y, x, &p.box) * n);
  p.tiles_z = cdiv(z, p.box.z);
  p.tiles_y = cdiv(y, p.box.y);
  p.tiles_x = cdiv(x, p.box.x);
  p.kchunks = cdiv(ca, KC) + cdiv(cb, KC);
  const int nblk = coutp / bn;
  const long long work = (long long)p.tiles * nblk;
  const long long vox = (long long)n * z * y * x;
  const long long in_bytes =
      vox * (ca + cb) * 2 + (long long)p.kchunks * 27 * KC * coutp * 2;
  const long long part_bytes = vox * cout * 4;  // one split's partials
  const bool narrow = ca > KC && ca <= 2 * KC && (form.nin == 1 || (cb > KC && cb <= 2 * KC));
  const bool rows16 = ca % 8 == 0 && cb % 8 == 0;
  const AConfig order[] = {{2, 1, 1}, {2, 1, 0}, {1, 1, 0}, {1, 0, 0}};
  for (AConfig c : order) {
    if (c.g == 2 && !narrow) continue;
    const AKernel fn = a_kernel(form, bn, c);
    if (fn == nullptr) continue;
    int stages = 3;
    while (stages >= 2 && a_smem(form, c, p.box, bn, p.kchunks, stages) > A_SMEM_MAX) --stages;
    if (stages < 2) continue;
    const int smem = a_smem(form, c, p.box, bn, p.kchunks, stages);
    const int bps = a_occupancy(fn, A_THREADS, smem);
    if (bps < 1) continue;
    const long long slots = (long long)bps * sms;
    long long splits = 1;
    if (work < slots && !form.packed) {
      splits = slots / work;
      const long long groups = cdiv(p.kchunks, c.g);
      if (splits > groups) splits = groups;
      if (splits > MAX_SPLITS) splits = MAX_SPLITS;
      if (splits > in_bytes / part_bytes) splits = in_bytes / part_bytes;
      if (splits < 1) splits = 1;
    }
    if (c.resident && splits > 1) continue;
    // a split K loop launches the form without its stats (taken after the
    // reduce): that instantiation needs the same shared memory
    if (splits > 1 && form.stats &&
        a_occupancy(a_kernel({form.nin, form.affine, false}, bn, c), A_THREADS, smem) < 1)
      continue;
    p.ring = c.resident || !rows16 || form.affine || (splits > 1 && form.nin == 1);
    p.ring = p.ring || form.packed;  // the wgmma body's TMA boxes read unpacked rows
    p.wgmma = !p.ring;
    if (p.wgmma && !h_plan(n, z, y, x, ca, cb, cout, coutp, sms, &p.h)) return false;
    p.cfg = c;
    p.per_split = cdiv(cdiv(p.kchunks, c.g), (int)splits) * c.g;
    p.splits = cdiv(p.kchunks, p.per_split);
    p.stages = stages;
    p.smem = smem;
    p.blocks_per_sm = bps;
    const long long per_col = slots / ((long long)nblk * p.splits);
    p.grid_x = (int)(per_col < 1 ? 1 : (per_col < p.tiles ? per_col : p.tiles));
    *out = p;
    return true;
  }
  return false;
}

long long a_workspace_bytes(const APlan& plan, int n, int z, int y, int x, int cout) {
  if (plan.splits <= 1) return 0;
  return (long long)plan.splits * n * z * y * x * cout * (long long)sizeof(float);
}

// Rows a sample of a stats call's partials: the ring's blocks along the
// tiles, the wgmma body's tiles of a sample, or with a split K loop the
// split-K reduce's runs.
int stats_rows(const APlan& plan, int n, int z, int y, int x, int cout) {
  const long long s = (long long)z * y * x;
  if (plan.wgmma) return h_stats_rows(plan.h, n, s, cout);
  return plan.splits > 1 ? splitk_stats_rows(n, s, cout) : plan.grid_x;
}

// The stats' area, after the split-K partials: the partial rows (N, rows,
// 2, Cout) and reduce_rows' workspace; -1 where reduce_rows takes no such
// rows.
long long stats_workspace_bytes(int n, int rows, int cout) {
  const long long red = reduce_rows_workspace(n, rows, 2 * cout);
  if (red < 0) return -1;
  return (long long)n * rows * 2 * cout * (long long)sizeof(float) + red;
}

long long split_workspace_bytes(const APlan& plan, int n, int z, int y, int x, int cout) {
  return plan.wgmma ? h_workspace_bytes(plan.h, n, z, y, x, cout)
                    : a_workspace_bytes(plan, n, z, y, x, cout);
}

// The bytes of a call's workspace: its split-K partials, then for a stats
// form the stats' area; -1 for sizes the kernels do not take.
long long call_workspace_bytes(const AForm& form, const APlan& plan, int n, int z, int y, int x,
                               int cout) {
  const long long split = split_workspace_bytes(plan, n, z, y, x, cout);
  if (!form.stats) return split;
  const long long st = stats_workspace_bytes(n, stats_rows(plan, n, z, y, x, cout), cout);
  return st < 0 ? -1 : split + st;
}

// The plan a call of `form` takes; false for sizes the kernels do not take.
bool plan_of(const AForm& form, int n, int z, int y, int xd, int ca, int cb, int cout,
             int coutp, int bn, APlan* plan) {
  return bn > 0 && coutp % bn == 0 &&
         make_aplan(form, n, z, y, xd, ca, cb, cout, coutp, bn, sm_count(), plan);
}

// A call of `form` (kernel A, B, D or D's dual form): on the body its plan
// names (the ring or the wgmma body). b null: one input; scale, shift (D)
// may be null (no prologue); stats (N, 2, Cout) fp32 for D and its dual
// form, from the partial rows the epilogue or the split-K reduce writes.
int run_form(const AForm& form, const void* a, const void* b, int ca, int cb, const void* w,
             const void* bias, const void* scale, const void* shift, float slope, void* out,
             void* stats, void* ws, long long ws_bytes, int n, int z, int y, int xd, int cout,
             int coutp, int bn, void* stream) {
  if (coutp % bn != 0 || (bn != 32 && bn != 64) || cout > coutp || ca <= 0 ||
      (form.nin == 2) != (b != nullptr && cb > 0) || form.stats != (stats != nullptr) ||
      (!form.affine && scale != nullptr) || (scale == nullptr) != (shift == nullptr))
    return (int)cudaErrorInvalidValue;
  AParams p{};
  if (!plan_of(form, n, z, y, xd, ca, cb, cout, coutp, bn, &p.plan))
    return (int)cudaErrorInvalidConfiguration;
  const long long split_bytes = split_workspace_bytes(p.plan, n, z, y, xd, cout);
  const long long need = call_workspace_bytes(form, p.plan, n, z, y, xd, cout);
  if (need < 0 || ws_bytes < need || (need > 0 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  // the stats' partial rows, after the split-K partials
  float* part = form.stats ? static_cast<float*>(ws) + split_bytes / (long long)sizeof(float)
                           : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p.plan.wgmma) {
    err = h_run(p.plan.h, a, b, ca, cb, w, bias, out, ws, ws_bytes, part, n, z, y, xd, cout,
                coutp, 0, s);
  } else {
    // the stats epilogue runs only with one split; a split's stats are the
    // split-K reduce's
    const AForm launched{form.nin, form.affine, form.stats && p.plan.splits == 1};
    const AKernel fn = a_kernel(launched, bn, p.plan.cfg);
    if (fn == nullptr) return (int)cudaErrorInvalidConfiguration;
    p.src = static_cast<const __nv_bfloat16*>(a);
    p.w = static_cast<const __nv_bfloat16*>(w);
    p.bias = static_cast<const float*>(bias);
    p.out = static_cast<__nv_bfloat16*>(out);
    p.ws = static_cast<float*>(ws);
    p.z = z;
    p.y = y;
    p.x = xd;
    p.cin = ca;
    p.cout = cout;
    p.coutp = coutp;
    p.src2 = static_cast<const __nv_bfloat16*>(b);
    p.cin2 = cb;
    p.kchunks0 = cdiv(ca, KC);
    p.scale = static_cast<const float*>(scale);
    p.shift = static_cast<const float*>(shift);
    p.slope = slope;
    p.part = part;
    const dim3 grid(p.plan.grid_x, coutp / bn, p.plan.splits);
    void* args[] = {&p};
    err = cudaLaunchKernel(reinterpret_cast<const void*>(fn), grid, dim3(A_THREADS), args,
                           p.plan.smem, s);
    if (err == cudaSuccess && p.plan.splits > 1) {
      const long long vox = (long long)z * y * xd;
      err = part != nullptr
                ? splitk_reduce_stats(p.ws, p.bias, p.out, part, n, vox, cout, p.plan.splits, s)
                : splitk_reduce(p.ws, p.bias, p.out, n * vox * cout, cout, p.plan.splits, s);
    }
  }
  if (err != cudaSuccess || !form.stats) return (int)err;
  const int rows = stats_rows(p.plan, n, z, y, xd, cout);
  return (int)reduce_rows(part, static_cast<float*>(stats),
                          part + (long long)n * rows * 2 * cout, n, rows, 2 * cout, s);
}

}  // namespace

extern "C" {

// Bytes of fp32 workspace a call with these sizes needs (0: no split-K; -1:
// sizes the kernel does not take): kernel A's (cb 0) or B's, with the plan
// the launch takes; the body that launch runs into *body where it is not
// null (0 the ring, 1 the wgmma body).
long long mt_conv3d_launch_plan(int n, int z, int y, int xd, int ca, int cb, int cout,
                                int coutp, int bn, int* body) {
  APlan plan;
  const AForm form = cb > 0 ? FORM_B : FORM_A;
  if (!plan_of(form, n, z, y, xd, ca, cb, cout, coutp, bn, &plan)) return -1;
  if (body != nullptr) *body = plan.ring ? 0 : 1;
  return call_workspace_bytes(form, plan, n, z, y, xd, cout);
}

// mt_conv3d_launch_plan's bytes alone.
long long mt_conv3d_workspace(int n, int z, int y, int xd, int ca, int cb, int cout,
                              int coutp, int bn) {
  return mt_conv3d_launch_plan(n, z, y, xd, ca, cb, cout, coutp, bn, nullptr);
}

// The same for a kernel-D call (with stats; cb 0 for the single-input
// form): the bytes of its workspace, and its body into *body.
long long mt_conv3d_stats_launch_plan(int n, int z, int y, int xd, int ca, int cb, int cout,
                                      int coutp, int bn, int* body) {
  APlan plan;
  const AForm form = cb > 0 ? FORM_D_DUAL : FORM_D;
  if (!plan_of(form, n, z, y, xd, ca, cb, cout, coutp, bn, &plan)) return -1;
  if (body != nullptr) *body = plan.ring ? 0 : 1;
  return call_workspace_bytes(form, plan, n, z, y, xd, cout);
}

// mt_conv3d_stats_launch_plan's bytes alone.
long long mt_conv3d_stats_workspace(int n, int z, int y, int xd, int ca, int cb, int cout,
                                    int coutp, int bn) {
  return mt_conv3d_stats_launch_plan(n, z, y, xd, ca, cb, cout, coutp, bn, nullptr);
}

// The plan of a call of form 0 (kernel A), 1 (B), 2 (D), 3 (D's dual form)
// or 4 (the packed conv, at the unpacked sizes; cb 0 for the single-input
// forms) at these sizes into plan[0..14):
// the ring body (1) or not (0; the next eight then describe the ring it
// declined), G (chunks staged at once), weights resident (1) or streamed
// (0), the two warp groups splitting K (1) or N (0), ring stages, K splits,
// blocks along the tiles, blocks an SM, dynamic shared memory bytes; then
// the wgmma body (1) or not (0: the ring) and, for the wgmma body, its BN,
// K splits, blocks and dynamic shared memory bytes a block (0 otherwise). Returns 0, or -1 for
// sizes the kernels do not take.
int mt_conv3d_same_plan(int form, int n, int z, int y, int xd, int ca, int cb, int cout,
                        int coutp, int bn, int* plan) {
  const AForm forms[] = {FORM_A, FORM_B, FORM_D, FORM_D_DUAL, FORM_PACKED};
  APlan p;
  if (form < 0 || form > 4 || (forms[form].nin == 2) != (cb > 0) ||
      !plan_of(forms[form], n, z, y, xd, ca, cb, cout, coutp, bn, &p))
    return -1;
  const HPlan h = p.wgmma ? p.h : HPlan{};
  const int v[] = {p.ring,   p.cfg.g,  p.cfg.resident,  p.cfg.ksplit, p.stages,
                   p.splits, p.grid_x, p.blocks_per_sm, p.smem,       p.wgmma,
                   h.bn,     h.splits, h.tiles * h.nblk * h.splits,   h.smem};
  for (int i = 0; i < 14; ++i) plan[i] = v[i];
  return 0;
}

// Kernel A. Returns cudaGetLastError() after the launch (0 on success).
int mt_conv3d_same(const void* x, const void* w, const void* bias, void* out, void* ws,
                   long long ws_bytes, int n, int z, int y, int xd, int cin, int cout,
                   int coutp, int bn, void* stream) {
  return run_form(FORM_A, x, nullptr, cin, 0, w, bias, nullptr, nullptr, 0.f, out, nullptr,
                  ws, ws_bytes, n, z, y, xd, cout, coutp, bn, stream);
}

// Kernel B: the conv over concat(a, b) along channels, concat never built.
int mt_conv3d_same_dual(const void* a, const void* b, const void* w, const void* bias,
                        void* out, void* ws, long long ws_bytes, int n, int z, int y,
                        int xd, int ca, int cb, int cout, int coutp, int bn,
                        void* stream) {
  if (b == nullptr || cb <= 0) return (int)cudaErrorInvalidValue;
  return run_form(FORM_B, a, b, ca, cb, w, bias, nullptr, nullptr, 0.f, out, nullptr, ws,
                  ws_bytes, n, z, y, xd, cout, coutp, bn, stream);
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
  return run_form(FORM_D, x, nullptr, cin, 0, w, bias, scale, shift, slope, out, stats, ws,
                  ws_bytes, n, z, y, xd, cout, coutp, bn, stream);
}

// Kernel D, dual form: kernel B's conv over concat(a, b) with D's stats.
int mt_conv3d_same_dual_stats(const void* a, const void* b, const void* w,
                              const void* bias, void* out, void* stats, void* ws,
                              long long ws_bytes, int n, int z, int y, int xd, int ca,
                              int cb, int cout, int coutp, int bn, void* stream) {
  if (stats == nullptr || b == nullptr || cb <= 0) return (int)cudaErrorInvalidValue;
  return run_form(FORM_D_DUAL, a, b, ca, cb, w, bias, nullptr, nullptr, 0.f, out, stats, ws,
                  ws_bytes, n, z, y, xd, cout, coutp, bn, stream);
}

// The packed conv: x (n, z, y/fy, x/fx, fy*fx*c) packed, groups (ngroups <= 4
// sizes adding up to c; null: one group), w as prepare_conv3d_weight for
// c -> cout over the unpacked channels [g0 | g1 ...], out (n, z, y/fy, x/fx,
// fy*fx*cout) tight phase-major, no bias. y, x are the unpacked sizes. On
// the ring body with kernel A's plan, the K loop whole.
int mt_packed_conv3d(const void* x, const void* w, void* out, const int* groups, int ngroups,
                     int n, int z, int y, int xd, int c, int cout, int coutp, int bn, int fy,
                     int fx, void* stream) {
  if ((bn != 32 && bn != 64) || coutp % bn != 0 || cout > coutp || c < 1 || fy < 1 || fx < 1 ||
      y % fy != 0 || xd % fx != 0 || ngroups < 0 || ngroups > MAX_GROUPS)
    return (int)cudaErrorInvalidValue;
  AParams p{};
  p.pk.fy = fy;
  p.pk.fx = fx;
  p.pk.ngroups = groups == nullptr ? 1 : ngroups;
  p.pk.vec = 8;
  int base = 0;
  for (int g = 0; g < MAX_GROUPS; ++g) {
    const int size = g < p.pk.ngroups ? (groups == nullptr ? c : groups[g]) : 0;
    if (size < 0) return (int)cudaErrorInvalidValue;
    p.pk.gbase[g] = base;
    p.pk.gsize[g] = size;
    while (size % p.pk.vec) p.pk.vec /= 2;
    base += size;
  }
  if (base != c) return (int)cudaErrorInvalidValue;
  if ((long long)n * z * y * xd == 0) return 0;
  if (!plan_of(FORM_PACKED, n, z, y, xd, c, 0, cout, coutp, bn, &p.plan))
    return (int)cudaErrorInvalidConfiguration;
  const AKernel fn = a_kernel(FORM_PACKED, bn, p.plan.cfg);
  if (fn == nullptr) return (int)cudaErrorInvalidConfiguration;
  p.src = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.z = z;
  p.y = y;
  p.x = xd;
  p.cin = c;
  p.cout = cout;
  p.coutp = coutp;
  p.kchunks0 = cdiv(c, KC);
  void* args[] = {&p};
  return (int)cudaLaunchKernel(reinterpret_cast<const void*>(fn),
                               dim3(p.plan.grid_x, coutp / bn, 1), dim3(A_THREADS), args,
                               p.plan.smem, static_cast<cudaStream_t>(stream));
}

const char* mt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
