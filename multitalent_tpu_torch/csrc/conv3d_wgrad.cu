// Kernel C: the weight gradient of the stride-1 SAME 3x3x3 convolution,
// channels-last bf16 in, fp32 out.
//
//   dw[co, ci, dz, dy, dx] = sum over n, z, y, x of
//       x[n, z+dz-1, y+dy-1, x+dx-1, ci] * g[n, z, y, x, co]   (zero outside)
//
// Replaces two Pallas TPU kernels of multitalent_tpu:
//   - ops/pallas_conv.py _wgrad_kernel (dw[27, Cin, Cout] of the dense conv,
//     the training default);
//   - ops/pallas_merged_conv.py _merged_wgrad_kernel (the same gradient on the
//     space-to-depth packed layout, grouped by merged taps: the port runs
//     unpacked, where it is this function).
// The NIN == 2 instantiation is the gradient of kernel B's conv over
// concat(a, b): it reads `a` and `b` and writes dw rows [0, Ca) then
// [Ca, Ca + Cb), without building the concat.
//
// What bounds it on an H100: the FLOPs equal the forward conv's
// (2 * 27 * Cin * Cout per voxel) and the tensor cores are the roofline, but
// the reduction runs over the voxels (7.1M at stage 0 with batch 2) into a
// tiny output (27x30x30 there), so the operands stream through shared memory
// once per box and every block reduces over many boxes. Measured on the
// card, the copies into shared memory and the ldmatrix/mma products cost
// the same warps' time and add up (a form with the products removed and one
// with the copies removed sum to the whole), so what bounds this form is
// the load/store unit's work per box: the cp.async copies (4 bytes a lane
// at 30 channels, whose 60-byte rows admit no wider aligned copy) and the
// ldmatrix reads. The design:
//   - a ring of STAGES boxes in shared memory: box i + 1's (and i + 2's)
//     cp.async copies are in flight while box i's products run, one barrier
//     per box;
//   - a line loader (common.cuh's load_lines, shared with kernel A): warps
//     take (z, y) lines of the box (one contiguous run of voxels in memory
//     each), and a lane keeps one copy unit and voxel offset for every
//     line, stepping by constant strides: no division per copy; 16-, 8- or
//     4-byte copies as the channel count allows (C % 8, C % 4, C % 2). A block owns G 16-channel chunks (G = 2
//     at 30 channels: the whole 60-byte voxel row), so the g box is staged
//     once for both;
//   - the voxel axis is split only to fill the card with one wave of blocks,
//     and never into more partial bytes than the inputs hold; with one split
//     the blocks write dw in torch's layout directly, with no workspace and
//     no second launch.
// The products are mma.sync m16n8k16 (bf16 in, fp32 accumulate) from
// ldmatrix.trans: x is the transposed operand (the voxels are the K axis),
// read from (16 G + 8)-element halo rows, g from (BN + 8)-element rows, both
// conflict-free. Warp w owns tap (dy, dx) = (w % 9 / 3, w % 3) for dz =
// 0..2 of chunk w / 9 % G and n tiles w / (9 G) of the BN columns, so the g
// fragments of a K step serve three taps. No wgmma or TMA: TMA needs
// 16-byte global strides (60- and 120-byte rows at stages 0 and 1), and
// wgmma's swizzled operand layouts do not hold the tap-shifted halo without
// restaging every tap (its no-swizzle K-major layout does: conv3d_wgmma.cu
// reads all 27 taps of one staged box by moving a descriptor's start).
//
// Determinism: no atomics. Each block sums its boxes in a fixed order; the
// partials of the splits are added in a fixed order by a second small kernel.
//
// Layouts: x / a, b: (N, Z, Y, X, Cin) bf16; g: (N, Z, Y, X, Cout) bf16, both
// contiguous; dw: (Cout, Cin, 3, 3, 3) fp32; the partials (splits, Cout, Cin,
// 27) fp32, dw's layout per split.
#include "common.cuh"

namespace {

using namespace mt;

// The block shapes: G 16-channel chunks of one input by BN output channels,
// 18 warps (WN of them share a chunk and tap and split the BN columns), one
// block an SM. A block's accumulators are 27 x 16 G x BN fp32 whatever its
// warps: at these tiles the register file holds one block; two fit only at
// G = 1, BN = 32 (288 threads), which measured slower at 30 and 60 channels
// (PERF.md, PR 7).
struct WConfig {
  int g, bn, wn;
};
constexpr WConfig kSmallOut = {2, 32, 1};  // Cout <= 32, rows of 17-32 channels
constexpr WConfig kWide = {1, 64, 2};      // every other shape
constexpr int STAGES = 3;                  // boxes in the ring

constexpr int SMEM_MAX = 227 * 1024 - BM * 4;  // dynamic shared memory beside vox_row

// bf16 elements of one ring stage: the haloed x box and the g box
int stage_elems(const WConfig& c, const Box& b) {
  return (b.z + 2) * (b.y + 2) * (b.x + 2) * (c.g * KC + 8) + BM * (c.bn + 8);
}

// dynamic shared memory of a block: the ring, or the epilogue's output tile
int smem_bytes(const WConfig& c, const Box& b) {
  const int ring = STAGES * stage_elems(c, b) * 2;
  const int tile = c.bn * (c.g * KC * 27 + 1) * 4;
  return ring > tile ? ring : tile;
}

// G = 2 where every input row holds 17-32 channels (a second chunk would
// be idle otherwise) and Cout <= 32, if its ring fits the box
WConfig pick_config(int ca, int cb, int cout, const Box& box) {
  const bool two_chunks = ca > KC && ca <= 2 * KC && (cb == 0 || cb > KC) && cb <= 2 * KC;
  return two_chunks && cout <= 32 && smem_bytes(kSmallOut, box) <= SMEM_MAX ? kSmallOut
                                                                            : kWide;
}

struct WPlan {
  WConfig cfg;
  Box box;
  int tiles_z, tiles_y, tiles_x;
  int boxes;   // N * tiles
  int groups;  // channel groups of G chunks over both inputs
  int splits;  // blocks along the voxel axis; split s takes boxes s, s+splits, ..
};

WPlan make_wplan(int n, int z, int y, int x, int ca, int cb, int cout, int sms) {
  WPlan p{};
  p.boxes = (int)(pick_box(z, y, x, &p.box) * n);
  p.cfg = pick_config(ca, cb, cout, p.box);
  p.tiles_z = cdiv(z, p.box.z);
  p.tiles_y = cdiv(y, p.box.y);
  p.tiles_x = cdiv(x, p.box.x);
  const int cg = KC * p.cfg.g;
  p.groups = cdiv(ca, cg) + cdiv(cb, cg);
  // one wave of blocks: split the voxel axis only where the groups x output
  // blocks leave SMs idle, and never into more partial bytes than the inputs
  const long long base = (long long)p.groups * cdiv(cout, p.cfg.bn);
  long long splits = sms / base;
  const long long vox = (long long)n * z * y * x;
  const long long in_bytes = vox * (ca + cb + cout) * 2;
  const long long dw_bytes = 27LL * (ca + cb) * cout * 4;
  if (splits > in_bytes / dw_bytes) splits = in_bytes / dw_bytes;
  if (splits > p.boxes) splits = p.boxes;
  p.splits = splits < 1 ? 1 : (int)splits;
  return p;
}

struct WParams {
  const __nv_bfloat16* in[2];
  int cin[2];
  int groups0;  // channel groups of input 0; input 1's follow
  const __nv_bfloat16* g;
  float* out;  // dw (one split) or the partials
  int z, y, x, cout;
  WPlan plan;
  int smem_stage;  // bf16 elements of one ring stage
};

template <int NIN, int BN, int G, int WN>
__global__ void __launch_bounds__(G * WN * 9 * 32, 1) conv3d_wgrad_kernel(WParams p) {
  constexpr int NWARPS = G * WN * 9;
  constexpr int CB = G * KC;        // input channels of the block
  constexpr int XS = CB + 8;        // halo row stride in bf16: 48 or 80 B
  constexpr int GS = BN + 8;        // g row stride in bf16
  constexpr int NT = BN / 8 / WN;   // n8 tiles of a warp
  constexpr int TS = CB * 27 + 1;   // the epilogue tile's floats per output channel
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  __shared__ int vox_row[BM];  // halo row of each box voxel at tap (0, 0, 0)

  const Box box = p.plan.box;
  const int hx = box.x + 2, hy = box.y + 2, hz = box.z + 2;
  const int x_elems = hz * hy * hx * XS;
  const int split = blockIdx.x, oblk = blockIdx.y, grp = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // selects, not p.in[inp]: a runtime index would copy p to local memory
  const bool second = NIN == 2 && grp >= p.groups0;
  const __nv_bfloat16* src = second ? p.in[1] : p.in[0];
  const int cin = second ? p.cin[1] : p.cin[0];
  const int c0 = (grp - (second ? p.groups0 : 0)) * CB;
  const int row0 = (second ? p.cin[0] : 0) + c0;  // dw row of channel c0
  const int cin_total = p.cin[0] + (NIN == 2 ? p.cin[1] : 0);
  const int xw = min(CB, cin - c0), co0 = oblk * BN, gw = min(BN, p.cout - co0);
  const LaneMap xmap = lane_map(xw, vec_of(cin), lane);
  const LaneMap gmap = lane_map(gw, vec_of(p.cout), lane);

  for (int m = threadIdx.x; m < BM; m += blockDim.x) {
    const int vz = m / (box.y * box.x), vy = (m / box.x) % box.y, vx = m % box.x;
    vox_row[m] = (vz * hy + vy) * hx + vx;
  }
  const int n_z = p.z, n_y = p.y, n_x = p.x, cout = p.cout, splits = p.plan.splits;
  const int tiles_x = p.plan.tiles_x, tiles_y = p.plan.tiles_y;
  const int tiles_yx = tiles_y * tiles_x, tiles = p.plan.tiles_z * tiles_yx;
  const int stage_elems = p.smem_stage;
  const __nv_bfloat16* gsrc = p.g;
  // box k of this block into ring stage s
  auto issue = [&](int k, int s) {
    const int bi = split + k * splits;
    const int nb = bi / tiles;
    const int t = bi - nb * tiles;
    const int z0 = (t / tiles_yx) * box.z;
    const int y0 = ((t / tiles_x) % tiles_y) * box.y;
    const int x0 = (t % tiles_x) * box.x;
    __nv_bfloat16* stage = ring + s * stage_elems;
    load_lines<NWARPS>(stage, XS, src, cin, c0, xmap, hx, hz * hy, hy, n_z, n_y, n_x, nb,
                       z0 - 1, y0 - 1, x0 - 1, warp);
    load_lines<NWARPS>(stage + x_elems, GS, gsrc, cout, co0, gmap, box.x, box.z * box.y,
                       box.y, n_z, n_y, n_x, nb, z0, y0, x0, warp);
  };

  // ldmatrix rows. A = x^T (16 channels x 16 voxels), from voxel rows with
  // .trans: lane l addresses voxel (l / 16) * 8 + l % 8 of the K step at
  // channel ((l / 8) % 2) * 8 of the warp's chunk. B = g (16 voxels x 8
  // channels) with .trans: lane l addresses voxel l % 16 at channel
  // (l / 16) * 8 of the warp's columns.
  const int tw = warp % 9, chunk = warp / 9 % G, ncol = warp / (9 * G) * NT * 8;
  const int a_vox = (lane / 16) * 8 + lane % 8;
  const int a_col = chunk * KC + ((lane / 8) % 2) * 8;
  const int tap_row = (tw / 3) * hx + tw % 3;  // (dy, dx) shift of this warp
  const int b_off = (lane % 16) * GS + ncol + (lane / 16) * 8;

  float acc[3][NT][4];
#pragma unroll
  for (int dz = 0; dz < 3; ++dz)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dz][j][e] = 0.f;

  const int nbox = split < p.plan.boxes ? (p.plan.boxes - split + splits - 1) / splits : 0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nbox) issue(s, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int k = 0; k < nbox; ++k) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of box k have landed
    __syncthreads();              // everyone's have; box k - 1's stage is free
    if (k + STAGES - 1 < nbox) issue(k + STAGES - 1, (k + STAGES - 1) % STAGES);
    cp_async_commit();
    const __nv_bfloat16* halo = ring + (k % STAGES) * stage_elems;
    const __nv_bfloat16* gsm = halo + x_elems;
#pragma unroll
    for (int ks = 0; ks < BM / 16; ++ks) {
      uint32_t b[NT / 2][4];
#pragma unroll
      for (int j = 0; j < NT / 2; ++j)
        ldmatrix_x4_trans(b[j], gsm + ks * 16 * GS + b_off + j * 16);
      const int row = vox_row[ks * 16 + a_vox] + tap_row;
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, halo + (row + dz * hy * hx) * XS + a_col);
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          mma_16816(acc[dz][2 * j], a, b[j][0], b[j][1]);
          mma_16816(acc[dz][2 * j + 1], a, b[j][2], b[j][3]);
        }
      }
    }
  }

  // the block's [BN, CB x 27] tile through shared memory (the ring is free),
  // then out row by row: dw[co, row0 .. row0 + xw, 27] is one contiguous run.
  // Accumulator element e of tile (dz, j): input channel lane / 4 (+8 for
  // e >= 2) of the warp's chunk, output channel 2 * (lane % 4) + (e & 1).
  cp_async_wait<0>();
  __syncthreads();
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int dz = 0; dz < 3; ++dz) {
    const int tap = dz * 9 + tw;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = chunk * KC + lane / 4 + (e >> 1) * 8;
        const int co = ncol + j * 8 + (lane % 4) * 2 + (e & 1);
        tile[co * TS + ci * 27 + tap] = acc[dz][j][e];
      }
  }
  __syncthreads();
  float* out = p.out + (int64_t)split * cout * cin_total * 27;
  const int run = xw * 27;
  for (int co = warp; co < gw; co += NWARPS) {
    float* d = out + ((int64_t)(co0 + co) * cin_total + row0) * 27;
    const float* t = tile + co * TS;
    for (int i = lane; i < run; i += 32) d[i] = t[i];
  }
}

// dw[i] = the sum over splits s, in order, of ws[s, i] (dw's layout)
__global__ void wgrad_reduce_kernel(const float* __restrict__ ws, float* __restrict__ dw,
                                    int64_t count, int splits) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (int64_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += ws[s * count + i];
    dw[i] = v;
  }
}

WPlan wplan_for(int n, int z, int y, int x, int ca, int cb, int cout) {
  return make_wplan(n, z, y, x, ca, cb, cout, sm_count());
}

long long wgrad_workspace_bytes(const WPlan& plan, int ca, int cb, int cout) {
  if (plan.splits == 1) return 0;
  return (long long)plan.splits * 27 * (ca + cb) * cout * (long long)sizeof(float);
}

template <int NIN, const WConfig& C>
cudaError_t launch_wgrad(WParams p, float* dw, float* ws, cudaStream_t stream) {
  constexpr auto kernel = conv3d_wgrad_kernel<NIN, C.bn, C.g, C.wn>;
  p.smem_stage = stage_elems(C, p.plan.box);
  const int smem = smem_bytes(C, p.plan.box);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int cin = p.cin[0] + (NIN == 2 ? p.cin[1] : 0);
  p.out = p.plan.splits == 1 ? dw : ws;
  dim3 grid(p.plan.splits, cdiv(p.cout, C.bn), p.plan.groups);
  kernel<<<grid, C.g * C.wn * 9 * 32, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.plan.splits == 1) return err;
  const long long count = 27LL * cin * p.cout;
  const int rblocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  wgrad_reduce_kernel<<<rblocks, 256, 0, stream>>>(ws, dw, count, p.plan.splits);
  return cudaGetLastError();
}

template <int NIN>
cudaError_t launch_for(const WParams& p, float* dw, float* ws, cudaStream_t s) {
  return p.plan.cfg.g == kSmallOut.g ? launch_wgrad<NIN, kSmallOut>(p, dw, ws, s)
                                     : launch_wgrad<NIN, kWide>(p, dw, ws, s);
}

int run_wgrad(const void* a, const void* b, int ca, int cb, const void* g, void* dw,
              void* ws, long long ws_bytes, int n, int z, int y, int x, int cout,
              void* stream) {
  if (ca <= 0 || cb < 0 || cout <= 0) return (int)cudaErrorInvalidValue;
  WParams p{};
  p.in[0] = static_cast<const __nv_bfloat16*>(a);
  p.in[1] = static_cast<const __nv_bfloat16*>(b);
  p.cin[0] = ca;
  p.cin[1] = cb;
  p.g = static_cast<const __nv_bfloat16*>(g);
  p.z = z;
  p.y = y;
  p.x = x;
  p.cout = cout;
  p.plan = wplan_for(n, z, y, x, ca, cb, cout);
  p.groups0 = cdiv(ca, KC * p.plan.cfg.g);
  const long long need = wgrad_workspace_bytes(p.plan, ca, cb, cout);
  if (ws_bytes < need || (need > 0 && ws == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dw);
  float* part = static_cast<float*>(ws);
  return (int)(b == nullptr ? launch_for<1>(p, out, part, s) : launch_for<2>(p, out, part, s));
}

}  // namespace

extern "C" {

// Bytes of fp32 workspace a weight-gradient call with these sizes needs:
// 0 where the call writes dw directly (one split), -1 for sizes it does not
// take. cb is 0 for the single-input form.
long long mt_conv3d_wgrad_workspace(int n, int z, int y, int xd, int ca, int cb,
                                    int cout) {
  if (ca <= 0 || cb < 0 || cout <= 0) return -1;
  return wgrad_workspace_bytes(wplan_for(n, z, y, xd, ca, cb, cout), ca, cb, cout);
}

// Kernel C: dw (Cout, Cin, 3, 3, 3) fp32 of the conv of x by g.
// Returns cudaGetLastError() after the launches (0 on success).
int mt_conv3d_wgrad(const void* x, const void* g, void* dw, void* ws, long long ws_bytes,
                    int n, int z, int y, int xd, int cin, int cout, void* stream) {
  return run_wgrad(x, nullptr, cin, 0, g, dw, ws, ws_bytes, n, z, y, xd, cout, stream);
}

// Kernel C, dual form: dw (Cout, Ca + Cb, 3, 3, 3) of the conv over
// concat(a, b), the concat never built.
int mt_conv3d_wgrad_dual(const void* a, const void* b, const void* g, void* dw, void* ws,
                         long long ws_bytes, int n, int z, int y, int xd, int ca, int cb,
                         int cout, void* stream) {
  if (b == nullptr) return (int)cudaErrorInvalidValue;
  return run_wgrad(a, b, ca, cb, g, dw, ws, ws_bytes, n, z, y, xd, cout, stream);
}

}  // extern "C"
