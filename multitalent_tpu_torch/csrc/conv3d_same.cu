// Stride-1 SAME 3x3x3 convolution, channels-last bf16, fp32 accumulation.
//
// Replaces three Pallas TPU kernels of multitalent_tpu:
//   - ops/pallas_conv.py  _conv_kernel       (dense 27-tap conv, C >= 120)
//   - ops/pallas_merged_conv.py _merged_kernel  (the same conv on a
//     space-to-depth packed tensor: that packing only fills the TPU's
//     128-lane matrix unit, so here it runs unpacked at the true C)
//   - ops/pallas_merged_conv.py _merged2_kernel (conv over concat(a, b)
//     without building the concat) -> the NIN == 2 instantiation below.
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

template <int NIN, int BN>
__global__ void __launch_bounds__(THREADS, 2) conv3d_same_kernel(Params p) {
  constexpr int BNP = BN + 8;
  constexpr int NT = BN / 8;  // n8 tiles per warp
  extern __shared__ __align__(128) unsigned char smem[];
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

template <int NIN, int BN>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes<BN>();
  cudaError_t err = cudaFuncSetAttribute(conv3d_same_kernel<NIN, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)p.plan.tiles_x * p.plan.tiles_y * p.plan.tiles_z * p.n;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)blocks, p.coutp / BN, p.plan.splits);
  conv3d_same_kernel<NIN, BN><<<grid, THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.plan.splits == 1) return err;
  const int64_t count = (int64_t)p.n * p.z * p.y * p.x * p.cout;
  const int rblocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  splitk_reduce_kernel<<<rblocks, 256, 0, stream>>>(p.ws, p.bias, p.out, count, p.cout,
                                                    p.plan.splits);
  return cudaGetLastError();
}

int run(const void* a, const void* b, int ca, int cb, const void* w, const void* bias,
        void* out, void* ws, long long ws_bytes, int n, int z, int y, int x, int cout,
        int coutp, int bn, void* stream) {
  if (coutp % bn != 0 || (bn != 32 && bn != 64) || cout > coutp)
    return (int)cudaErrorInvalidValue;
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
  if (ws_bytes < workspace_bytes(p.plan, n, z, y, x, cout) ||
      (p.plan.splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (b == nullptr) {
    err = bn == 32 ? launch<1, 32>(p, s) : launch<1, 64>(p, s);
  } else {
    err = bn == 32 ? launch<2, 32>(p, s) : launch<2, 64>(p, s);
  }
  return (int)err;
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

// Kernel A. Returns cudaGetLastError() after the launch (0 on success).
int mt_conv3d_same(const void* x, const void* w, const void* bias, void* out, void* ws,
                   long long ws_bytes, int n, int z, int y, int xd, int cin, int cout,
                   int coutp, int bn, void* stream) {
  return run(x, nullptr, cin, 0, w, bias, out, ws, ws_bytes, n, z, y, xd, cout, coutp,
             bn, stream);
}

// Kernel B: the conv over concat(a, b) along channels, concat never built.
int mt_conv3d_same_dual(const void* a, const void* b, const void* w, const void* bias,
                        void* out, void* ws, long long ws_bytes, int n, int z, int y,
                        int xd, int ca, int cb, int cout, int coutp, int bn,
                        void* stream) {
  return run(a, b, ca, cb, w, bias, out, ws, ws_bytes, n, z, y, xd, cout, coutp, bn,
             stream);
}

const char* mt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
