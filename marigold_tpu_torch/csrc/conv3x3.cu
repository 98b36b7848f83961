// SAME-padded stride-1 3x3 convolution for Hopper (sm_90a): an implicit GEMM
// over nine shifted TMA boxes, wgmma, and a ring of shared-memory stages.
//
// Replaces the TPU package's nine-tap Pallas kernel,
// marigold_tpu/ops/conv.py:_conv3x3_pallas / _kernel (pallas_call at :176,
// opt-in under MARIGOLD_TPU_CONV=pallas):
//   y[b,k,h,w] = bias[k] + sum_{dy,dx,c} x[b,c,h+dy-1,w+dx-1] * W9[3dy+dx,k,c]
// bf16 in, fp32 accumulation, bias added in fp32, bf16 out.
//
// Layout: x NCHW, copied to NHWC ([B, H, W, C], a scratch the wrapper
// allocates) by a tiled transpose launched first, as the TPU wrapper pads
// and flattens outside its kernel; the weight tap-major [9, K, C] (C
// innermost), the bias [K], y NCHW.
//
// Formulation: M = output pixels, N = output channels, the reduction over
// (64-channel block, tap). A consumer warpgroup owns a box of TW x TH = 64
// output pixels; for tap (dy, dx) and channel block cb its A operand is one
// TMA box {64 ch, TW, TH, 1} of the 4-D map {C, W, H, B} at
// (64 cb, w0 + dx - 1, h0 + dy - 1, b). The box lands as 64 rows of 128
// bytes, a K-major tile in the 128-byte swizzle, and TMA fills coordinates
// outside the image (negative ones too) with zeros, so the SAME padding
// costs nothing and there is no im2col copy. B is a {64, BN, 1} box of the
// map {C, K, 9} at (64 cb, n0, tap). Per stage each warpgroup issues four
// wgmma m64nBNk16 into its fp32 accumulator in registers.
//
// Block: one producer warpgroup (one thread issues every TMA load,
// setmaxnreg 40) and two consumer warpgroups (setmaxnreg 232) on two pixel
// boxes that share the weight tile; BN = 256 output channels (128 registers
// of accumulator a thread) where K allows it and the grid stays above the
// 132 SMs, else 128. A ring of stages (4 x 48 KB or 6 x 32 KB) tracked by
// full/empty mbarriers keeps loads ahead of the products; each warpgroup
// keeps one wgmma group in flight and releases a stage when the group that
// read it has completed. The epilogue adds the bias and stores bf16 NCHW
// from the accumulator registers (runs of 8 pixels along W per channel).
//
// Box shape per W: TW is the power of two in 4..64 that wastes the fewest
// pixels at the image edge (ties to the wider box): 24 -> 8 x 8, 48 -> 16 x
// 4, 12 -> 16 x 4 (75% of the box inside the image), 96 -> 32 x 2, >= 192
// -> 64 x 1.
//
// What bounds it on the H100: 18*C*K FLOPs per output pixel against
// (C + K) * 2 bytes of activations: hundreds of FLOP per byte at the
// serving shapes, far above the ~295 FLOP/byte ridge of 989 TFLOP/s over
// 3.35 TB/s, so the tensor cores bound it in HBM terms. Between L2 and the
// SMs it is heavier: each stage brings 2 x 8 KB of A and BN x 128 bytes of
// B for 2 x 64 x BN x 64 x 2 FLOPs (85 FLOP/byte at BN = 256), and the nine
// taps read each input row nine times from L2. At full tensor rate that is
// ~11 TB/s of L2-to-SM traffic, above what L2 delivers, so the L2 bounds it
// before the tensor cores do; the design keeps the ring deep enough that
// TMA runs ahead and the tensor cores never wait on HBM. The halo variant
// (one box per channel block, nine descriptor offsets) would cut A's L2
// traffic nine-fold and is left to later work.
//
// ptxas (CUDA 12.8, sm_90a): both instantiations (BN 128, 256) 168
// registers at launch (setmaxnreg 40/232), 0 bytes of spills, 4 HGMMA each
// in the SASS; chip_smoke.py prints these for every build, the transpose
// included.

#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BC = 64;                 // input channels per stage: 128 bytes
constexpr int PX = 64;                 // output pixels per consumer box
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int A_BYTES = PX * BC * 2;   // 8 KB
constexpr int RING_BYTES = 192 * 1024;

template <int BN>
struct Tile {
  static constexpr int STAGE = CONSUMERS * A_BYTES + BN * BC * 2;
  static constexpr int STAGES = RING_BYTES / STAGE;  // 4 (BN 256), 6 (BN 128)
  static constexpr int SM_BAR = STAGES * STAGE;
  static constexpr int SMEM = SM_BAR + 16 * STAGES + 1024;  // + alignment
};

// Pixel boxes of TW x TH = 64 over [B, H, W].
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

int pick_bn(const Boxes& g, int K) {
  return (K % 256 == 0 && cdiv(g.count, CONSUMERS) * (K / 256) >= 132) ? 256
                                                                       : 128;
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

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_sm90_kernel(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_w,
                    const bf16* __restrict__ bias, bf16* __restrict__ y,
                    int C, int H, int W, int K, Boxes g) {
  using T = Tile<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_full = base + T::SM_BAR;            // [STAGES]
  const uint32_t bar_empty = bar_full + 8 * T::STAGES;   // [STAGES]
  const int n0 = blockIdx.y * BN;
  const int n_iter = (C / BC) * 9;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
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
      for (int it = 0; it < n_iter; ++it) {
        const int st = it % T::STAGES;
        const int cb = it / 9, tap = it % 9;
        const int dy = tap / 3, dx = tap % 3;
        if (it >= T::STAGES)
          mbar_wait(bar_empty + 8 * st, ((it / T::STAGES) - 1) & 1);
        const uint32_t stage = base + st * T::STAGE;
        mbar_expect_tx(bar_full + 8 * st, T::STAGE);
        for (int c = 0; c < CONSUMERS; ++c)
          tma_load_4d(stage + c * A_BYTES, &tm_x, cb * BC, w0[c] + dx - 1,
                      h0[c] + dy - 1, b[c], bar_full + 8 * st);
        tma_load(stage + CONSUMERS * A_BYTES, &tm_w, cb * BC, n0, tap,
                 bar_full + 8 * st);
      }
    }
    return;
  }

  // Consumer warpgroup c owns pixel box CONSUMERS * blockIdx.x + c.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int st = it % T::STAGES;
    mbar_wait(bar_full + 8 * st, (it / T::STAGES) & 1);
    const uint32_t a_tile = base + st * T::STAGE + c * A_BYTES;
    const uint32_t b_tile = base + st * T::STAGE + CONSUMERS * A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk)
      wgmma_ss<BN>(acc, kmajor_desc(a_tile + 32 * kk),
                   kmajor_desc(b_tile + 32 * kk), 1);
    wgmma_commit();
    wgmma_wait<1>();  // the group of the previous stage is done
    if (it > 0 && lane == 0)
      mbar_arrive(bar_empty + 8 * ((it - 1) % T::STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc);

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
    bf16* out = y + (size_t)b * K * hw + (size_t)h * W + w;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + 8 * j + col + e;
        out[(size_t)n * hw] = __float2bfloat16(
            acc[4 * j + 2 * half + e] + __bfloat162float(bias[n]));
      }
    }
  }
}

// The NHWC copy of x that the A boxes read: a tiled transpose of each
// image's [C, H*W] into [H*W, C] through shared memory, 64 channels x 64
// pixels per block, both sides in 128-byte rows (bf16 pairs along the
// pixels when H*W is even, along the channels on the way out).
constexpr int TP = 64;  // pixels per transpose tile
constexpr int TT_THREADS = 256;

__global__ void __launch_bounds__(TT_THREADS)
nchw_to_nhwc_kernel(const bf16* __restrict__ x, bf16* __restrict__ xh, int C,
                    int HW) {
  __shared__ __align__(4) bf16 tile[TP][BC + 2];
  const int p0 = blockIdx.x * TP, c0 = blockIdx.y * BC;
  const size_t img = (size_t)blockIdx.z * C * HW;
  const bf16 zero = __float2bfloat16(0.0f);
  const bool pairs = HW % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  for (int i = threadIdx.x; i < BC * (TP / 2); i += TT_THREADS) {
    const int c = i / (TP / 2), p = 2 * (i % (TP / 2));
    const bf16* src = x + img + (size_t)(c0 + c) * HW + p0 + p;
    __nv_bfloat162 pair;
    if (pairs && p0 + p + 1 < HW) {
      pair = *reinterpret_cast<const __nv_bfloat162*>(src);
    } else {
      pair.x = p0 + p < HW ? src[0] : zero;
      pair.y = p0 + p + 1 < HW ? src[1] : zero;
    }
    tile[p][c] = pair.x;
    tile[p + 1][c] = pair.y;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TP * (BC / 2); i += TT_THREADS) {
    const int p = i / (BC / 2), c = 2 * (i % (BC / 2));
    if (p0 + p < HW)
      *reinterpret_cast<__nv_bfloat162*>(xh + img + (size_t)(p0 + p) * C +
                                         c0 + c) =
          *reinterpret_cast<const __nv_bfloat162*>(&tile[p][c]);
  }
}

template <int BN>
cudaError_t launch(const CUtensorMap& tm_x, EncodeTiledFn fn, const void* w9,
                   const bf16* bias, bf16* y, int C, int H, int W, int K,
                   const Boxes& g, cudaStream_t stream) {
  // [9, K, C]: a {64, BN, 1} box per (input block, output block, tap)
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)K, 9};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)K * C * 2};
  const cuuint32_t box[3] = {BC, BN, 1};
  CUtensorMap tm_w;
  if (!encode_bf16_sw128(fn, &tm_w, w9, 3, dims, strides, box))
    return cudaErrorInvalidValue;
  auto kernel = conv3x3_sm90_kernel<BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(g.count, CONSUMERS), K / BN);
  kernel<<<grid, THREADS, Tile<BN>::SMEM, stream>>>(tm_x, tm_w, bias, y, C,
                                                     H, W, K, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B, C, H, W], w9 [9, K, C], bias [K] bf16, y [B, K, H, W] bf16, and the
// scratch x_nhwc [B, H, W, C] bf16 that the caller allocates; w9 and
// x_nhwc 16-byte aligned. Two launches: the NHWC copy of x, then the
// conv. Returns cudaSuccess (0), cudaErrorInvalidValue for C not a multiple
// of 64, K not a multiple of 128 or a map the driver refuses,
// cudaErrorNotSupported without cuTensorMapEncodeTiled, or the error of the
// attribute call or a launch.
int mt_conv3x3_fwd(const void* x, const void* w9, const void* bias,
                   void* x_nhwc, void* y, int B, int C, int H, int W, int K,
                   void* stream) {
  if (B < 1 || H < 1 || W < 1 || C % BC || C < BC || K % 128 || K < 128 ||
      B > 65535 || C / BC > 65535)
    return (int)cudaErrorInvalidValue;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  nchw_to_nhwc_kernel<<<dim3(cdiv(H * W, TP), C / BC, B), TT_THREADS, 0,
                        st>>>(static_cast<const bf16*>(x),
                              static_cast<bf16*>(x_nhwc), C, H * W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Boxes g = plan_boxes(B, H, W);
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {BC, (cuuint32_t)g.tw, (cuuint32_t)g.th, 1};
  CUtensorMap tm_x;
  if (!encode_bf16_sw128(fn, &tm_x, x_nhwc, 4, dims, strides, box))
    return (int)cudaErrorInvalidValue;
  const bf16* bs = static_cast<const bf16*>(bias);
  bf16* out = static_cast<bf16*>(y);
  return pick_bn(g, K) == 256
             ? (int)launch<256>(tm_x, fn, w9, bs, out, C, H, W, K, g, st)
             : (int)launch<128>(tm_x, fn, w9, bs, out, C, H, W, K, g, st);
}

// Blocks mt_conv3x3_fwd launches for this shape (132 SMs on the H100).
int mt_conv3x3_blocks(int B, int C, int H, int W, int K) {
  (void)C;
  const Boxes g = plan_boxes(B, H, W);
  return cdiv(g.count, CONSUMERS) * (K / pick_bn(g, K));
}

const char* mt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
