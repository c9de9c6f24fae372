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
// (2 * 27 * Cin * Cout per voxel), but the reduction runs over the voxels
// (7.1M at stage 0 with batch 2) and the output is tiny there (27x30x30).
// The tensor cores are the roofline; this first form (mma.sync, one box in
// flight, no wgmma/TMA) is bound by its serialised load -> compute phases and,
// where Cout is 320, by 9 warps a block on one block an SM. The design:
//   - a block owns one 16-channel input chunk, BN output channels and a fixed
//     set of 256-voxel boxes (every splits-th box of the volume); per box it
//     stages the haloed x box and the g box in shared memory (cp.async,
//     zero-filled outside the volume and past the channel counts) and
//     accumulates all 27 taps' [16 x BN] products in registers: warp w owns
//     tap (dy, dx) = (w / 3, w % 3) for dz = 0..2, so the g fragments of a
//     K step serve three taps;
//   - x is the transposed operand (the voxels are the K axis), read with
//     ldmatrix.trans from 48-byte halo rows; g with ldmatrix.trans from
//     (BN+8)-element rows: both conflict-free;
//   - every block writes its fp32 partial sums to a workspace whose size the
//     library reports (mt_conv3d_wgrad_workspace); a second small kernel adds
//     the partials of the splits in a fixed order and writes dw in torch's
//     (Cout, Cin, 3, 3, 3) layout. No atomics: the result is deterministic.
//
// Layouts: x / a, b: (N, Z, Y, X, Cin) bf16; g: (N, Z, Y, X, Cout) bf16, both
// contiguous; dw: (Cout, Cin, 3, 3, 3) fp32.
#include "common.cuh"

namespace {

using namespace mt;

constexpr int WARPS = 9;  // one per (dy, dx)
constexpr int THREADS = WARPS * 32;
constexpr int MAX_SPLITS = 1024;

struct WPlan {
  Box box;
  int tiles_z, tiles_y, tiles_x;
  int boxes;   // N * tiles
  int splits;  // blocks along the voxel axis; split s takes boxes s, s+splits, ..
};

struct WParams {
  const __nv_bfloat16* in[2];
  int cin[2];
  int nchunks0;  // K chunks of input 0; input 1's follow
  const __nv_bfloat16* g;
  float* ws;  // partials (splits, 27, cin[0] + cin[1], cout)
  int n, z, y, x, cout;
  WPlan plan;
};

int block_n(int cout) { return cout <= 32 ? 32 : 64; }

WPlan make_wplan(int n, int z, int y, int x, int kchunks, int nblocks_n, int sms) {
  WPlan p{};
  p.boxes = (int)(pick_box(z, y, x, &p.box) * n);
  p.tiles_z = cdiv(z, p.box.z);
  p.tiles_y = cdiv(y, p.box.y);
  p.tiles_x = cdiv(x, p.box.x);
  const long long per_split = (long long)kchunks * nblocks_n;
  const long long target = 4LL * sms;  // a few waves of blocks
  long long splits = (target + per_split - 1) / per_split;
  if (splits > p.boxes) splits = p.boxes;
  if (splits > MAX_SPLITS) splits = MAX_SPLITS;
  p.splits = splits < 1 ? 1 : (int)splits;
  return p;
}

template <int BN>
constexpr int wgrad_smem_bytes() {
  return HALO_MAX * HS * 2 + BM * (BN + 8) * 2;
}

template <int NIN, int BN>
__global__ void __launch_bounds__(THREADS, BN == 32 ? 2 : 1)
    conv3d_wgrad_kernel(WParams p) {
  constexpr int GS = BN + 8;  // g row stride in bf16
  constexpr int NT = BN / 8;  // n8 tiles
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* gsm = reinterpret_cast<__nv_bfloat16*>(smem + HALO_MAX * HS * 2);
  __shared__ int vox_row[BM];  // halo row of each box voxel at tap (0, 0, 0)

  const Box box = p.plan.box;
  const int hx = box.x + 2, hy = box.y + 2;
  const int split = blockIdx.x, nblk = blockIdx.y, kc = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // selects, not p.in[inp]: a runtime index would copy p to local memory
  const bool second = NIN == 2 && kc >= p.nchunks0;
  const __nv_bfloat16* src = second ? p.in[1] : p.in[0];
  const int cin = second ? p.cin[1] : p.cin[0];
  const int c0 = (kc - (second ? p.nchunks0 : 0)) * KC;
  const int row0 = (second ? p.cin[0] : 0) + c0;  // dw row of channel c0
  const int cin_total = p.cin[0] + (NIN == 2 ? p.cin[1] : 0);

  for (int m = threadIdx.x; m < BM; m += THREADS) {
    const int vz = m / (box.y * box.x), vy = (m / box.x) % box.y, vx = m % box.x;
    vox_row[m] = (vz * hy + vy) * hx + vx;
  }
  // ldmatrix rows. A = x^T (16 channels x 16 voxels), from voxel rows with
  // .trans: lane l addresses voxel (l / 16) * 8 + l % 8 of the K step at
  // channel ((l / 8) % 2) * 8. B = g (16 voxels x 8 channels) with .trans:
  // lane l addresses voxel l % 16 at channel (l / 16) * 8.
  const int a_vox = (lane / 16) * 8 + lane % 8;
  const int a_col = ((lane / 8) % 2) * 8;
  const int tap_row = (warp / 3) * hx + warp % 3;  // (dy, dx) shift of this warp
  const int b_off = (lane % 16) * GS + (lane / 16) * 8;

  float acc[3][NT][4];
#pragma unroll
  for (int dz = 0; dz < 3; ++dz)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dz][j][e] = 0.f;

  const int tiles_yx = p.plan.tiles_y * p.plan.tiles_x;
  const int tiles = p.plan.tiles_z * tiles_yx;
  for (int bi = split; bi < p.plan.boxes; bi += p.plan.splits) {
    const int nb = bi / tiles;
    const int t = bi - nb * tiles;
    const int z0 = (t / tiles_yx) * box.z;
    const int y0 = ((t / p.plan.tiles_x) % p.plan.tiles_y) * box.y;
    const int x0 = (t % p.plan.tiles_x) * box.x;
    __syncthreads();  // the previous box's fragments are consumed
    load_box<THREADS>(halo, src, cin, c0, KC, HS, 1, box, p.z, p.y, p.x, nb, z0, y0,
                      x0);
    load_box<THREADS>(gsm, p.g, p.cout, nblk * BN, BN, GS, 0, box, p.z, p.y, p.x, nb,
                      z0, y0, x0);
    cp_async_wait_all();
    __syncthreads();
#pragma unroll 1
    for (int ks = 0; ks < BM / 16; ++ks) {
      uint32_t b[NT / 2][4];
#pragma unroll
      for (int j = 0; j < NT / 2; ++j)
        ldmatrix_x4_trans(b[j], gsm + ks * 16 * GS + b_off + j * 16);
      const int row = vox_row[ks * 16 + a_vox] + tap_row;
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, halo + (row + dz * hy * hx) * HS + a_col);
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          mma_16816(acc[dz][2 * j], a, b[j][0], b[j][1]);
          mma_16816(acc[dz][2 * j + 1], a, b[j][2], b[j][3]);
        }
      }
    }
  }

  // accumulator element e of tile (dz, j): input channel lane / 4 (+8 for
  // e >= 2), output channel 2 * (lane % 4) + (e & 1)
#pragma unroll
  for (int dz = 0; dz < 3; ++dz) {
    const int tap = dz * 9 + warp;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ci = lane / 4 + h * 8;
      if (c0 + ci >= cin) continue;
      float* dst = p.ws + (((int64_t)split * 27 + tap) * cin_total + row0 + ci) * p.cout;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int co = nblk * BN + j * 8 + (lane % 4) * 2;
        if (co < p.cout) dst[co] = acc[dz][j][h * 2];
        if (co + 1 < p.cout) dst[co + 1] = acc[dz][j][h * 2 + 1];
      }
    }
  }
}

// dw[co, ci, tap] = sum over splits s, in order, of ws[s, tap, ci, co]
__global__ void wgrad_reduce_kernel(const float* __restrict__ ws, float* __restrict__ dw,
                                    int cin, int cout, int splits) {
  const int64_t count = 27LL * cin * cout;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int co = (int)(i % cout);
    const int ci = (int)((i / cout) % cin);
    const int tap = (int)(i / ((int64_t)cout * cin));
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += ws[s * count + i];
    dw[((int64_t)co * cin + ci) * 27 + tap] = v;
  }
}

WPlan wplan_for(int n, int z, int y, int x, int ca, int cb, int cout) {
  const int bn = block_n(cout);
  return make_wplan(n, z, y, x, cdiv(ca, KC) + cdiv(cb, KC), cdiv(cout, bn), sm_count());
}

long long wgrad_workspace_bytes(const WPlan& plan, int ca, int cb, int cout) {
  return (long long)plan.splits * 27 * (ca + cb) * cout * (long long)sizeof(float);
}

template <int NIN, int BN>
cudaError_t launch_wgrad(const WParams& p, int kchunks, float* dw, cudaStream_t stream) {
  constexpr int smem = wgrad_smem_bytes<BN>();
  cudaError_t err = cudaFuncSetAttribute(conv3d_wgrad_kernel<NIN, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.plan.splits, cdiv(p.cout, BN), kchunks);
  conv3d_wgrad_kernel<NIN, BN><<<grid, THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int cin = p.cin[0] + (NIN == 2 ? p.cin[1] : 0);
  const long long count = 27LL * cin * p.cout;
  const int rblocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  wgrad_reduce_kernel<<<rblocks, 256, 0, stream>>>(p.ws, dw, cin, p.cout, p.plan.splits);
  return cudaGetLastError();
}

int run_wgrad(const void* a, const void* b, int ca, int cb, const void* g, void* dw,
              void* ws, long long ws_bytes, int n, int z, int y, int x, int cout,
              void* stream) {
  if (ca <= 0 || cb < 0 || cout <= 0 || ws == nullptr) return (int)cudaErrorInvalidValue;
  WParams p;
  p.in[0] = static_cast<const __nv_bfloat16*>(a);
  p.in[1] = static_cast<const __nv_bfloat16*>(b);
  p.cin[0] = ca;
  p.cin[1] = cb;
  p.nchunks0 = cdiv(ca, KC);
  p.g = static_cast<const __nv_bfloat16*>(g);
  p.ws = static_cast<float*>(ws);
  p.n = n;
  p.z = z;
  p.y = y;
  p.x = x;
  p.cout = cout;
  p.plan = wplan_for(n, z, y, x, ca, cb, cout);
  if (ws_bytes < wgrad_workspace_bytes(p.plan, ca, cb, cout))
    return (int)cudaErrorInvalidValue;
  const int kchunks = cdiv(ca, KC) + cdiv(cb, KC);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dw);
  cudaError_t err;
  if (b == nullptr) {
    err = block_n(cout) == 32 ? launch_wgrad<1, 32>(p, kchunks, out, s)
                              : launch_wgrad<1, 64>(p, kchunks, out, s);
  } else {
    err = block_n(cout) == 32 ? launch_wgrad<2, 32>(p, kchunks, out, s)
                              : launch_wgrad<2, 64>(p, kchunks, out, s);
  }
  return (int)err;
}

}  // namespace

extern "C" {

// Bytes of fp32 workspace a weight-gradient call with these sizes needs.
// cb is 0 for the single-input form.
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
