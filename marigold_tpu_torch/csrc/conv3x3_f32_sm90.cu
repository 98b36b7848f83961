// SAME-padded stride-1 3x3 convolution in fp32 storage for Hopper (sm_90a):
// an implicit GEMM over nine shifted TMA boxes with 3xTF32 products on
// wgmma (tf32x3.cuh), fed by a ring of shared-memory stages.
//
// Replaces the fp32 instantiation of the TPU package's nine-tap Pallas
// kernel, marigold_tpu/ops/conv.py:_conv3x3_pallas (pallas_call at :176,
// whose gate admits fp32 at :77; opt-in under MARIGOLD_TPU_CONV=pallas):
//   y[b,k,h,w] = bias[k] + sum_{dy,dx,c} x[b,c,h+dy-1,w+dx-1] * W9[3dy+dx,k,c]
// fp32 in and out, every product fp32-accurate. It took the place of a
// CUDA-core FFMA kernel, 4.1x slower at 10x1280@24^2->1280 (PERF.md).
//
// Operands. tf32 wgmma reads both operands K-major, and the reduction
// index is the channel, so the first launch (mt_conv3x3_f32_split, counted
// apart by the wrapper) copies x from NCHW into NHWC hi and lo parts
// ([2, B, H, W, C]: hi = rna_tf32(x), lo = rna_tf32(x - hi)) through a
// [32][33] shared tile. The weight comes split from the wrapper as
// [2, 9, K, C] (ops/conv.py:taps_tf32, which models/layers.py:Conv2d
// caches), hi then lo of the tap-major taps.
//
// Formulation, as conv3x3.cu: M = output pixels, N = output channels, the
// reduction over (32-channel block, tap), taps innermost so that the nine
// shifted boxes of one channel block meet in L2. A consumer warpgroup owns
// a box of TW x TH = 64 output pixels; for tap (dy, dx) and channel block
// cb its A operand is one TMA box {32 ch, TW, TH, 1} of the 4-D map
// {C, W, H, B} of each part at (32 cb, w0 + dx - 1, h0 + dy - 1, b): 64
// rows of 128 bytes, a K-major tile in the 128-byte swizzle; TMA fills
// coordinates outside the image with zeros, so the SAME padding costs
// nothing. B is a {32, 128, 1, 1} box of the map {C, K, 9, 2} at
// (32 cb, n0, tap, part). Per stage and k8 step a consumer issues three
// wgmma m64n128k8 (lo.hi, hi.lo, hi.hi; lo.lo dropped).
//
// Accumulation. The tensor cores truncate as they accumulate
// (tf32x3.cuh), so the products of CHUNK_CB channel blocks x 9 taps (432
// wgmmas) go into a fresh accumulator that is then added into the running
// one with fp32 adds; one accumulator over all of C would take 4320 adds
// at C = 1280.
//
// Block: one producer warpgroup (one thread issues every TMA load,
// setmaxnreg 40) and two consumer warpgroups (setmaxnreg 232) on two pixel
// boxes sharing the weight tile; BN = 128 output channels (the running and
// fresh m64n128 accumulators: 128 registers a thread). A stage is A hi and
// lo for both boxes (4 x 8 KB) and B hi and lo (2 x 16 KB), 64 KB; three
// stages, tracked by full/empty mbarriers. The epilogue adds the bias and
// stores fp32 NCHW from the accumulator registers.
//
// What bounds it on the H100: 18 C K FLOPs per output pixel, x3 for the
// tf32 passes, against 495 TFLOP/s (1.030 ms at 10x1280@24^2->1280), and
// in HBM terms hundreds of FLOP per byte. Between L2 and the SMs it is
// heavier: a 64 KB stage carries 2 x 64 x 128 x 32 x 2 = 1.05 MFLOP of
// fp32 work, 16 FLOP per byte, ~10.6 GB from L2 per call at that shape.
// Measured there (chip_smoke.py, H100 80GB HBM3 at 700 W) the conv launch
// takes 1.33 ms, 77% of the tensor bound: L2 keeps the three-stage ring
// fed, and the last of 3.4 waves of 450 blocks on 132 SMs is most of the
// rest. Grids under two waves (10x2560@12^2: 150 blocks) lose more.

#include "tf32x3.cuh"

namespace {

constexpr int BC = TF32_ROW;           // input channels per stage: 128 bytes
constexpr int PX = 64;                 // output pixels per consumer box
constexpr int BN = 128;                // output channels per block
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int A_BYTES = PX * BC * 4;   // 8 KB: one part of a pixel box
constexpr int B_BYTES = BN * BC * 4;   // 16 KB: one part of the weight tile
constexpr int STAGE = CONSUMERS * 2 * A_BYTES + 2 * B_BYTES;  // 64 KB
constexpr int STAGES = 3;
constexpr int SM_BAR = STAGES * STAGE;
constexpr int SMEM = SM_BAR + 16 * STAGES + 1024;  // + alignment
constexpr int CHUNK_CB = 4;  // channel blocks per fresh accumulator
static_assert(SMEM <= 232448, "fits the 227 KB a block can use");

// Pixel boxes of TW x TH = 64 over [B, H, W] (as conv3x3.cu plans them).
struct Boxes {
  int tw, th, per_w, per_img, count;
};

Boxes plan_boxes(int B, int H, int W) {
  Boxes best{};
  long long best_px = -1;
  for (int tw = 64; tw >= 4; tw /= 2) {
    const int th = PX / tw;
    const long long px = (long long)cdiv(W, tw) * tw * cdiv(H, th) * th;
    if (best_px < 0 || px < best_px) {
      best_px = px;
      best = Boxes{tw, th, cdiv(W, tw), cdiv(W, tw) * cdiv(H, th), 0};
    }
  }
  best.count = B * best.per_img;
  return best;
}

// Box `idx` -> batch row and top-left pixel; idx past the last box gives
// b >= B, which TMA reads as zeros and the epilogue skips.
__device__ __forceinline__ void box_origin(const Boxes& g, int idx, int& b,
                                           int& h0, int& w0) {
  b = idx / g.per_img;
  const int r = idx - b * g.per_img;
  h0 = (r / g.per_w) * g.th;
  w0 = (r % g.per_w) * g.tw;
}

__global__ void __launch_bounds__(THREADS, 1)
conv3x3_f32_kernel(const __grid_constant__ CUtensorMap tm_xh,
                   const __grid_constant__ CUtensorMap tm_xl,
                   const __grid_constant__ CUtensorMap tm_w,
                   const float* __restrict__ bias, float* __restrict__ y,
                   int C, int H, int W, int K, Boxes g) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_full = base + SM_BAR;           // [STAGES]
  const uint32_t bar_empty = bar_full + 8 * STAGES;  // [STAGES]
  const int n0 = blockIdx.y * BN;
  const int n_cb = C / BC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * CONSUMERS);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer warpgroup: one thread issues every TMA load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int b[CONSUMERS], h0[CONSUMERS], w0[CONSUMERS];
      for (int c = 0; c < CONSUMERS; ++c)
        box_origin(g, CONSUMERS * blockIdx.x + c, b[c], h0[c], w0[c]);
      for (int it = 0; it < 9 * n_cb; ++it) {
        const int st = it % STAGES;
        const int cb = it / 9, tap = it % 9;
        const int dy = tap / 3, dx = tap % 3;
        if (it >= STAGES)
          mbar_wait(bar_empty + 8 * st, ((it / STAGES) - 1) & 1);
        const uint32_t stage = base + st * STAGE;
        const uint32_t full = bar_full + 8 * st;
        mbar_expect_tx(full, STAGE);
        for (int c = 0; c < CONSUMERS; ++c) {
          const uint32_t a = stage + 2 * c * A_BYTES;
          tma_load_4d(a, &tm_xh, cb * BC, w0[c] + dx - 1, h0[c] + dy - 1,
                      b[c], full);
          tma_load_4d(a + A_BYTES, &tm_xl, cb * BC, w0[c] + dx - 1,
                      h0[c] + dy - 1, b[c], full);
        }
        const uint32_t bw = stage + CONSUMERS * 2 * A_BYTES;
        tma_load_4d(bw, &tm_w, cb * BC, n0, tap, 0, full);
        tma_load_4d(bw + B_BYTES, &tm_w, cb * BC, n0, tap, 1, full);
      }
    }
    return;
  }

  // Consumer warpgroup c owns pixel box CONSUMERS * blockIdx.x + c.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  float run[BN / 2], fresh[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) run[i] = fresh[i] = 0.f;

  int it = 0;
  for (int cb0 = 0; cb0 < n_cb; cb0 += CHUNK_CB) {
    const int len = 9 * min(CHUNK_CB, n_cb - cb0);
    for (int s = 0; s < len; ++s, ++it) {
      const int st = it % STAGES;
      mbar_wait(bar_full + 8 * st, (it / STAGES) & 1);
      const uint32_t a_hi = base + st * STAGE + 2 * c * A_BYTES;
      const uint32_t b_hi = base + st * STAGE + CONSUMERS * 2 * A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BC / 8; ++kk) {
        const uint32_t ah = kdesc(a_hi + 32 * kk);
        const uint32_t al = kdesc(a_hi + A_BYTES + 32 * kk);
        const uint32_t bh = kdesc(b_hi + 32 * kk);
        const uint32_t bl = kdesc(b_hi + B_BYTES + 32 * kk);
        wgmma_m64n128k8_tf32_ss(fresh, al, bh, s > 0 || kk > 0);
        wgmma_m64n128k8_tf32_ss(fresh, ah, bl, 1);
        wgmma_m64n128k8_tf32_ss(fresh, ah, bh, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the group of the previous stage is done
      if (s > 0 && lane == 0) mbar_arrive(bar_empty + 8 * ((it - 1) % STAGES));
    }
    wgmma_wait<0>();  // the chunk's products are complete
    if (lane == 0) mbar_arrive(bar_empty + 8 * ((it - 1) % STAGES));
    fence_regs(fresh);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) run[i] += fresh[i];
  }

  const int idx = CONSUMERS * blockIdx.x + c;
  if (idx >= g.count) return;
  int b, h0, w0;
  box_origin(g, idx, b, h0, w0);
  const size_t hw = (size_t)H * W;
  const int r0 = (t / 32) * 16 + lane / 4;  // accumulator rows r0, r0 + 8
  const int col = 2 * (lane % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;  // row of the box: pixel (r / TW, r % TW)
    const int h = h0 + r / g.tw, w = w0 + r % g.tw;
    if (h >= H || w >= W) continue;
    float* out = y + (size_t)b * K * hw + (size_t)h * W + w;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + 8 * j + col + e;
        out[(size_t)n * hw] = run[4 * j + 2 * half + e] + bias[n];
      }
    }
  }
}

// The split NHWC copy of x that the A boxes read: each image's [C, H*W]
// through a [32][33] shared tile (conflict-free both ways) into [H*W, C]
// hi and lo parts; a warp reads 32 pixels of one channel and writes 32
// channels of one pixel, 128 bytes each.
constexpr int ST = 32;
constexpr int ST_THREADS = 256;  // 32 x 8: each thread 4 rows of a tile

__global__ void __launch_bounds__(ST_THREADS)
nchw_split_kernel(const float* __restrict__ x, float* __restrict__ hi,
                  float* __restrict__ lo, int C, int HW) {
  __shared__ float tile[ST][ST + 1];
  const int p0 = blockIdx.x * ST, c0 = blockIdx.y * ST;
  const size_t img = (size_t)blockIdx.z * C * HW;
  const int tx = threadIdx.x % ST, ty = threadIdx.x / ST;
#pragma unroll
  for (int i = 0; i < ST / 8; ++i) {
    const int cc = ty + 8 * i;
    tile[cc][tx] =
        p0 + tx < HW ? x[img + (size_t)(c0 + cc) * HW + p0 + tx] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ST / 8; ++i) {
    const int p = ty + 8 * i;
    if (p0 + p >= HW) break;
    const size_t at = img + (size_t)(p0 + p) * C + c0 + tx;
    uint32_t h, l;
    tf32_split(tile[tx][p], h, l);
    hi[at] = __uint_as_float(h);
    lo[at] = __uint_as_float(l);
  }
}

}  // namespace

extern "C" {

// x [B, C, H, W] fp32 -> xs [2, B, H, W, C] fp32 (hi, then lo), both
// contiguous; C a multiple of 32. Returns cudaSuccess (0),
// cudaErrorInvalidValue for bad arguments, or the launch's error.
int mt_conv3x3_f32_split(const void* x, void* xs, int B, int C, int H,
                         int W, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < BC || C % BC || B > 65535 ||
      C / ST > 65535)
    return (int)cudaErrorInvalidValue;
  float* hi = static_cast<float*>(xs);
  float* lo = hi + (size_t)B * C * H * W;
  nchw_split_kernel<<<dim3(cdiv(H * W, ST), C / ST, B), ST_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), hi, lo, C, H * W);
  return (int)cudaGetLastError();
}

// xs [2, B, H, W, C] (mt_conv3x3_f32_split's), w [2, 9, K, C] (hi, lo of
// the taps), bias [K], y [B, K, H, W], all fp32 and contiguous, xs and w
// 16-byte aligned; C a multiple of 32, K of 128. Returns cudaSuccess (0),
// cudaErrorInvalidValue for bad arguments or a map the driver refuses,
// cudaErrorNotSupported without cuTensorMapEncodeTiled, or the error of
// the attribute call or the launch.
int mt_conv3x3_f32_fwd(const void* xs, const void* w, const void* bias,
                       void* y, int B, int C, int H, int W, int K,
                       void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < BC || C % BC || K < BN || K % BN ||
      K / BN > 65535 || reinterpret_cast<uintptr_t>(xs) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const Boxes g = plan_boxes(B, H, W);
  const cuuint64_t dims_x[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                                (cuuint64_t)B};
  const cuuint64_t strides_x[3] = {(cuuint64_t)C * 4, (cuuint64_t)W * C * 4,
                                   (cuuint64_t)H * W * C * 4};
  const cuuint32_t box_x[4] = {BC, (cuuint32_t)g.tw, (cuuint32_t)g.th, 1};
  const cuuint64_t dims_w[4] = {(cuuint64_t)C, (cuuint64_t)K, 9, 2};
  const cuuint64_t strides_w[3] = {(cuuint64_t)C * 4, (cuuint64_t)K * C * 4,
                                   (cuuint64_t)9 * K * C * 4};
  const cuuint32_t box_w[4] = {BC, BN, 1, 1};
  const float* xh = static_cast<const float*>(xs);
  const float* xl = xh + (size_t)B * H * W * C;
  CUtensorMap tm_xh, tm_xl, tm_w;
  if (!encode_f32_sw128(fn, &tm_xh, xh, 4, dims_x, strides_x, box_x) ||
      !encode_f32_sw128(fn, &tm_xl, xl, 4, dims_x, strides_x, box_x) ||
      !encode_f32_sw128(fn, &tm_w, w, 4, dims_w, strides_w, box_w))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(cdiv(g.count, CONSUMERS), K / BN);
  conv3x3_f32_kernel<<<grid, THREADS, SMEM,
                       static_cast<cudaStream_t>(stream)>>>(
      tm_xh, tm_xl, tm_w, static_cast<const float*>(bias),
      static_cast<float*>(y), C, H, W, K, g);
  return (int)cudaGetLastError();
}

// Blocks mt_conv3x3_f32_fwd launches for this shape (132 SMs on the H100).
int mt_conv3x3_f32_blocks(int B, int C, int H, int W, int K) {
  (void)C;
  return cdiv(plan_boxes(B, H, W).count, CONSUMERS) * (K / BN);
}

const char* mt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
