// Winograd F(2x2, 3x3) SAME-padded stride-1 convolution in fp32 storage
// for Hopper (sm_90a): an input-transform kernel that writes V split into
// tf32 parts, then a GEMM with 3xTF32 products on wgmma (tf32x3.cuh) fed
// by TMA, the output transform fused into its accumulators.
//
// Replaces the fp32 instantiation of the TPU package's Winograd Pallas
// kernel, marigold_tpu/ops/winograd.py:_winograd_impl (pallas_call at
// :251, whose gate admits fp32 at :89; opt-in under
// MARIGOLD_TPU_CONV=winograd); one TPU kernel, two launches here. It took
// the place of CUDA-core FFMA kernels, 6.8x slower at 10x1280@24^2->1280
// (PERF.md). Per 2x2 output tile with 4x4 input patch d, as winograd.cu:
//   V = B^T d B (per input channel), M_ij = sum_c V_ij[c] U_ij[k, c],
//   Y = A^T M A + bias,
// with U = G g G^T computed by the wrapper in fp32 and split into tf32
// parts, [2, 16, K, C] (ops/winograd.py:filter_transform_tf32, which
// models/layers.py:Conv2d caches). V, M, the output transform and the bias
// are fp32; every product is fp32-accurate.
//
// 1. winograd_f32_input_kernel stages the 4 input rows of a strip of 32
//    tiles along W for 32 channels in shared memory, forms V in fp32 per
//    (tile, channel) and writes its hi and lo parts, the scratch
//    [2, 16, T, C] (T = B * H/2 * W/2 tiles, C innermost: each V_ij a
//    K-major A operand, as tf32 wgmma requires), 128 contiguous bytes per
//    warp store. The split costs no launch of its own.
// 2. winograd_f32_gemm_kernel: a block owns 64 tiles and 64 output
//    channels per consumer warpgroup. For each ij a warpgroup runs the
//    reduction over C, M_ij = V_ij U_ij^T, three wgmma m64n64k8 per k8
//    step (lo.hi, hi.lo, hi.hi) on K-major tiles in the 128-byte swizzle
//    that one producer thread brings with TMA into a ring ({32 ch, 64
//    tiles, 1, 1} of the map {C, T, 16, 2} and {32 ch, 64 per consumer,
//    1, 1} of {C, K, 16, 2}). The tensor cores truncate as they
//    accumulate (tf32x3.cuh), so at most CHUNK_CB channel blocks (240
//    wgmmas) go into one fresh accumulator, which is then added with the
//    signs of A^T (x) A^T into the four output-phase accumulators Y_q in
//    fp32. The epilogue adds the bias and stores each tile's rows of two
//    pixels as float2 from the registers.
//
// What bounds it on the H100: 8 C K FLOPs per output pixel (2.25x fewer
// than the direct conv), x3 for the tf32 passes, against 495 TFLOP/s
// (0.458 ms at 10x1280@24^2->1280); the V scratch (hi and lo, 8x the
// input's bytes: 236 MB written and read back at that shape, ~0.14 ms at
// 3.35 TB/s). Registers set the tile: a warpgroup of 64 tiles x 64
// channels holds the fresh accumulator and four Y_q, 160 fp32 registers a
// thread. Each block reads its V rows (64 x 16 x C x 8 bytes) and U rows
// (128 x 16 x C x 8 bytes) from L2, 4x the bytes of the bf16 design:
// ~7.2 GB per call at that shape, 21 FLOP per byte of a 48 KB stage.
// Measured there (chip_smoke.py, H100 80GB HBM3 at 700 W): the GEMM 0.67
// ms, 68% of the tensor bound, the input transform 0.11 ms; at C = 128
// and 768^2 the input transform, bound by V's bytes, takes as long as
// the GEMM. Where the grid of two-consumer blocks would not cover the 132
// SMs the block has one consumer warpgroup and 64 channels, doubling the
// blocks.

#include "tf32x3.cuh"

namespace {

// A^T[q][i] for q in {0, 1}
__host__ __device__ constexpr int at(int q, int i) {
  return q == 0 ? (i == 3 ? 0 : 1) : (i == 0 ? 0 : (i == 1 ? 1 : -1));
}

// ---- 1. input transform with the split ---------------------------------

constexpr int XT = 32;              // tiles per block along W
constexpr int XC = 32;              // channels per block
constexpr int X_THREADS = 256;
constexpr int XPAIRS = XT + 2;      // column pairs 2tx0-2 .. 2tx0+2XT+1
constexpr int XROW = 2 * XPAIRS;    // floats per staged input row
constexpr int XCH = 4 * XROW + 1;   // floats per channel: odd, so lanes on
                                    // consecutive channels hit distinct banks

__global__ void __launch_bounds__(X_THREADS)
winograd_f32_input_kernel(const float* __restrict__ x,
                          float* __restrict__ v_hi, float* __restrict__ v_lo,
                          int C, int H, int W, int T) {
  __shared__ float patch[XC * XCH];
  const int ht = H / 2, wt = W / 2;
  const int strips = cdiv(wt, XT);
  const int s = blockIdx.x % strips;
  const int bty = blockIdx.x / strips;  // b * ht + ty
  const int ty = bty % ht, b = bty / ht;
  const int tx0 = s * XT;
  const int ntx = min(XT, wt - tx0);
  const int c0 = blockIdx.y * XC;
  const float* xb = x + ((size_t)b * C + c0) * H * W;
  // input rows 2ty-1 .. 2ty+2 as float pairs from column 2tx0-2; W is even,
  // so a pair lies wholly inside or outside the image; zeros outside
  for (int i = threadIdx.x; i < XC * 4 * XPAIRS; i += X_THREADS) {
    const int pr = i % XPAIRS, row = i / XPAIRS;
    const int r = row % 4, c = row / 4;
    const int hh = 2 * ty - 1 + r, ww = 2 * tx0 - 2 + 2 * pr;
    float2 pair = make_float2(0.f, 0.f);
    if (hh >= 0 && hh < H && ww >= 0 && ww < W)
      pair = *reinterpret_cast<const float2*>(xb + ((size_t)c * H + hh) * W +
                                              ww);
    float* dst = patch + c * XCH + r * XROW + 2 * pr;
    dst[0] = pair.x;
    dst[1] = pair.y;
  }
  __syncthreads();
  // one (tile, channel) per thread and step; a warp stores 32 channels
  const size_t tile0 = (size_t)bty * wt + tx0;
  const size_t plane = (size_t)T * C;
  for (int i = threadIdx.x; i < ntx * XC; i += X_THREADS) {
    const int cc = i % XC, t = i / XC;
    // the tile's 4x4 patch: image columns 2(tx0 + t) - 1 ..
    const float* src = patch + cc * XCH + 2 * t + 1;
    float d[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) d[r][q] = src[r * XROW + q];
    float f[4][4];  // B^T d
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      f[0][q] = d[0][q] - d[2][q];
      f[1][q] = d[1][q] + d[2][q];
      f[2][q] = d[2][q] - d[1][q];
      f[3][q] = d[1][q] - d[3][q];
    }
    float vv[16];  // (B^T d) B
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      vv[4 * r + 0] = f[r][0] - f[r][2];
      vv[4 * r + 1] = f[r][1] + f[r][2];
      vv[4 * r + 2] = f[r][2] - f[r][1];
      vv[4 * r + 3] = f[r][1] - f[r][3];
    }
    const size_t at0 = (tile0 + t) * C + c0 + cc;
#pragma unroll
    for (int ij = 0; ij < 16; ++ij) {
      uint32_t h, l;
      tf32_split(vv[ij], h, l);
      v_hi[ij * plane + at0] = __uint_as_float(h);
      v_lo[ij * plane + at0] = __uint_as_float(l);
    }
  }
}

// ---- 2. GEMM with the output transform ---------------------------------

constexpr int BC = TF32_ROW;  // input channels per stage: 128 bytes
constexpr int TM = 64;        // tiles per block (the wgmma M)
constexpr int WN = 64;        // output channels per consumer warpgroup
constexpr int RING_BYTES = 192 * 1024;
constexpr int CHUNK_CB = 20;  // channel blocks per fresh accumulator

template <int CONSUMERS>
struct Gemm {
  static constexpr int THREADS = 128 * (1 + CONSUMERS);
  static constexpr int BN = WN * CONSUMERS;
  static constexpr int A_BYTES = TM * BC * 4;           // 8 KB, one part
  static constexpr int B_BYTES = BN * BC * 4;           // 16 or 8 KB
  static constexpr int STAGE = 2 * A_BYTES + 2 * B_BYTES;  // 48 or 32 KB
  static constexpr int STAGES = RING_BYTES / STAGE;     // 4 or 6
  static constexpr int SM_BAR = STAGES * STAGE;
  static constexpr int SMEM = SM_BAR + 16 * STAGES + 1024;  // + alignment
};

template <int CONSUMERS>
__global__ void __launch_bounds__(Gemm<CONSUMERS>::THREADS, 1)
winograd_f32_gemm_kernel(const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_u,
                         const float* __restrict__ bias,
                         float* __restrict__ y, int C, int H, int W, int K,
                         int T) {
  using G = Gemm<CONSUMERS>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_full = base + G::SM_BAR;           // [STAGES]
  const uint32_t bar_empty = bar_full + 8 * G::STAGES;  // [STAGES]
  const int t0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * G::BN;
  const int n_cb = C / BC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * CONSUMERS);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer warpgroup: one thread issues every TMA load, ij-major.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int it = 0; it < 16 * n_cb; ++it) {
        const int st = it % G::STAGES;
        const int ij = it / n_cb, cb = it % n_cb;
        if (it >= G::STAGES)
          mbar_wait(bar_empty + 8 * st, ((it / G::STAGES) - 1) & 1);
        const uint32_t stage = base + st * G::STAGE;
        const uint32_t full = bar_full + 8 * st;
        mbar_expect_tx(full, G::STAGE);
        tma_load_4d(stage, &tm_v, cb * BC, t0, ij, 0, full);
        tma_load_4d(stage + G::A_BYTES, &tm_v, cb * BC, t0, ij, 1, full);
        tma_load_4d(stage + 2 * G::A_BYTES, &tm_u, cb * BC, n0, ij, 0, full);
        tma_load_4d(stage + 2 * G::A_BYTES + G::B_BYTES, &tm_u, cb * BC, n0,
                    ij, 1, full);
      }
    }
    return;
  }

  // Consumer warpgroup c: output channels n0 + 64c .. n0 + 64c + 63.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  float acc[WN / 2];
  float yq[4][WN / 2];  // Y_q, q = 2 qa + qb
#pragma unroll
  for (int k = 0; k < WN / 2; ++k) {
    acc[k] = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) yq[q][k] = 0.f;
  }

  int it = 0;
  for (int ij = 0; ij < 16; ++ij) {
    const int i = ij / 4, j = ij % 4;
    const float ai[2] = {(float)at(0, i), (float)at(1, i)};
    const float aj[2] = {(float)at(0, j), (float)at(1, j)};
    for (int cb0 = 0; cb0 < n_cb; cb0 += CHUNK_CB) {
      const int len = min(CHUNK_CB, n_cb - cb0);
      for (int s = 0; s < len; ++s, ++it) {
        const int st = it % G::STAGES;
        mbar_wait(bar_full + 8 * st, (it / G::STAGES) & 1);
        const uint32_t a_hi = base + st * G::STAGE;
        const uint32_t b_hi = a_hi + 2 * G::A_BYTES + c * WN * BC * 4;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BC / 8; ++kk) {
          const uint32_t ah = kdesc(a_hi + 32 * kk);
          const uint32_t al = kdesc(a_hi + G::A_BYTES + 32 * kk);
          const uint32_t bh = kdesc(b_hi + 32 * kk);
          const uint32_t bl = kdesc(b_hi + G::B_BYTES + 32 * kk);
          wgmma_m64n64k8_tf32_ss(acc, al, bh, s > 0 || kk > 0);
          wgmma_m64n64k8_tf32_ss(acc, ah, bl, 1);
          wgmma_m64n64k8_tf32_ss(acc, ah, bh, 1);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the group of the previous stage is done
        if (s > 0 && lane == 0)
          mbar_arrive(bar_empty + 8 * ((it - 1) % G::STAGES));
      }
      wgmma_wait<0>();  // this chunk of M_ij is complete
      if (lane == 0) mbar_arrive(bar_empty + 8 * ((it - 1) % G::STAGES));
      fence_regs(acc);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float coef = ai[q >> 1] * aj[q & 1];  // 0 or +-1
        if (coef != 0.f) {
#pragma unroll
          for (int k = 0; k < WN / 2; ++k)
            yq[q][k] = fmaf(coef, acc[k], yq[q][k]);
        }
      }
    }
  }

  // the bias, then pixels (2ty + qa, 2tx), (2ty + qa, 2tx + 1) as float2
  const int ht = H / 2, wt = W / 2;
  const int r0 = (t / 32) * 16 + lane / 4;  // accumulator rows r0, r0 + 8
  const int col = 2 * (lane % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int tile = t0 + r0 + 8 * half;
    if (tile >= T) continue;
    const int b = tile / (ht * wt), rem = tile % (ht * wt);
    const int ty = rem / wt, tx = rem % wt;
#pragma unroll
    for (int jj = 0; jj < WN / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + c * WN + 8 * jj + col + e;
        const int k = 4 * jj + 2 * half + e;
        const float bn = bias[n];
        float* out = y + (((size_t)b * K + n) * H + 2 * ty) * W + 2 * tx;
        *reinterpret_cast<float2*>(out) =
            make_float2(yq[0][k] + bn, yq[1][k] + bn);  // qa = 0
        *reinterpret_cast<float2*>(out + W) =
            make_float2(yq[2][k] + bn, yq[3][k] + bn);  // qa = 1
      }
    }
  }
}

int pick_consumers(int T, int K) {
  return cdiv(T, TM) * (K / (2 * WN)) >= 132 ? 2 : 1;
}

template <int CONSUMERS>
cudaError_t launch_gemm(EncodeTiledFn fn, const float* v, const void* u,
                        const float* bias, float* y, int C, int H, int W,
                        int K, int T, cudaStream_t stream) {
  using G = Gemm<CONSUMERS>;
  const cuuint64_t dims_v[4] = {(cuuint64_t)C, (cuuint64_t)T, 16, 2};
  const cuuint64_t strides_v[3] = {(cuuint64_t)C * 4, (cuuint64_t)T * C * 4,
                                   (cuuint64_t)16 * T * C * 4};
  const cuuint32_t box_v[4] = {BC, TM, 1, 1};
  const cuuint64_t dims_u[4] = {(cuuint64_t)C, (cuuint64_t)K, 16, 2};
  const cuuint64_t strides_u[3] = {(cuuint64_t)C * 4, (cuuint64_t)K * C * 4,
                                   (cuuint64_t)16 * K * C * 4};
  const cuuint32_t box_u[4] = {BC, (cuuint32_t)G::BN, 1, 1};
  CUtensorMap tm_v, tm_u;
  if (!encode_f32_sw128(fn, &tm_v, v, 4, dims_v, strides_v, box_v) ||
      !encode_f32_sw128(fn, &tm_u, u, 4, dims_u, strides_u, box_u))
    return cudaErrorInvalidValue;
  auto kernel = winograd_f32_gemm_kernel<CONSUMERS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(T, TM), K / G::BN);
  kernel<<<grid, G::THREADS, G::SMEM, stream>>>(tm_v, tm_u, bias, y, C, H, W,
                                                K, T);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B, C, H, W], u [2, 16, K, C] (hi, lo of filter_transform), bias [K],
// y [B, K, H, W], and the scratch v [2, 16, B * H/2 * W/2, C] that the
// caller allocates, all fp32 and contiguous; x and y 8-byte, u and v
// 16-byte aligned; H and W even, C a multiple of 32, K of 128. Two
// launches: the input transform, then the GEMM. Returns cudaSuccess (0),
// cudaErrorInvalidValue for bad arguments or a map the driver refuses,
// cudaErrorNotSupported without cuTensorMapEncodeTiled, or the error of an
// attribute call or a launch.
int mt_winograd_f32_fwd(const void* x, const void* u, const void* bias,
                        void* v, void* y, int B, int C, int H, int W, int K,
                        void* stream) {
  if (B < 1 || H < 2 || W < 2 || H % 2 || W % 2 || C % BC || C < BC ||
      K % (2 * WN) || K < 2 * WN || C / XC > 65535 ||
      reinterpret_cast<uintptr_t>(x) % 8 ||
      reinterpret_cast<uintptr_t>(y) % 8 ||
      reinterpret_cast<uintptr_t>(u) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16 ||
      (long long)B * (H / 2) * (W / 2) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const int T = B * (H / 2) * (W / 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* v_hi = static_cast<float*>(v);
  float* v_lo = v_hi + (size_t)16 * T * C;
  const dim3 grid_in(B * (H / 2) * cdiv(W / 2, XT), C / XC);
  winograd_f32_input_kernel<<<grid_in, X_THREADS, 0, st>>>(
      static_cast<const float*>(x), v_hi, v_lo, C, H, W, T);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* bs = static_cast<const float*>(bias);
  float* out = static_cast<float*>(y);
  return pick_consumers(T, K) == 2
             ? (int)launch_gemm<2>(fn, v_hi, u, bs, out, C, H, W, K, T, st)
             : (int)launch_gemm<1>(fn, v_hi, u, bs, out, C, H, W, K, T, st);
}

// Blocks of the GEMM launch for this shape (132 SMs on the H100).
int mt_winograd_f32_blocks(int B, int C, int H, int W, int K) {
  (void)C;
  const int T = B * (H / 2) * (W / 2);
  return cdiv(T, TM) * (K / (WN * pick_consumers(T, K)));
}

const char* mt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
