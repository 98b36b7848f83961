// Winograd F(2x2, 3x3) SAME-padded stride-1 convolution for Hopper
// (sm_90a): an input-transform kernel, then a wgmma GEMM fed by TMA with
// the output transform fused into its accumulators.
//
// Replaces the TPU package's Winograd Pallas kernel,
// marigold_tpu/ops/winograd.py:_winograd_impl / _kernel (pallas_call at
// :251, opt-in under MARIGOLD_TPU_CONV=winograd); one TPU kernel, two
// launches here. Per 2x2 output tile with 4x4 input patch d:
//   V = B^T d B (per input channel), M_ij = sum_c V_ij[c] U_ij[k, c],
//   Y = A^T M A + bias,
//   B^T = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]],
//   A^T = [[1,1,1,0],[0,1,-1,-1]],
// with U = G g G^T computed by the wrapper in fp32 and rounded to bf16 (as
// the TPU wrapper computes it outside its kernel), laid out [16, K, C]. V is
// summed in fp32 and rounded once to bf16; M, the output transform and the
// bias are fp32; y is bf16. x and y are NCHW bf16, the bias [K] bf16; H and
// W are even.
//
// 1. winograd_input_kernel reads the 4 input rows of a tile row along W
//    into shared memory (each input row serves two tile rows, so x is read
//    about twice, mostly from L2), forms V per (tile, channel)
//    and writes the scratch V [16, T, C] (T = B * H/2 * W/2 tiles, C
//    innermost, so that each V_ij is a K-major A operand), 128 contiguous
//    bytes per warp store. V is computed once per call.
// 2. winograd_gemm_kernel: a block owns 64 tiles and 64 output channels per
//    consumer warpgroup. For each ij in turn a warpgroup runs the full
//    reduction over C, M_ij = V_ij U_ij^T, with wgmma m64n64k16 on K-major
//    tiles in the 128-byte swizzle that one producer thread brings with TMA
//    into a ring of stages ({64 ch, 64 tiles, 1} of the map {C, T, 16} and
//    {64 ch, 64 per consumer, 1} of {C, K, 16}). After each ij it adds the
//    fresh accumulator, with the signs of A^T (x) A^T, into the four
//    output-phase accumulators Y_q in registers: 36 fp32 adds per output
//    element for the whole call, once per ij after the full C reduction.
//    The epilogue adds the bias, rounds to bf16 and stages Y through the
//    (then idle) ring, so that the stores of pixels (2ty+qa, 2tx+qb) run
//    along W as bf16 pairs.
//
// What bounds it on the H100: 8*C*K FLOPs per output pixel (2.25x fewer
// than the direct conv) over activation bytes, hundreds of FLOP per byte in
// HBM terms, plus the V scratch (4x the input: at 10x1280@24^2, 59 MB
// written and read back, ~35 us at 3.35 TB/s). Registers set the tile: a
// warpgroup of 64 tiles x N channels holds one accumulator and four Y_q,
// 5N/2 fp32 registers a thread (160 at N = 64; N = 128 does not fit), so a
// block is 64 tiles x 128 channels and each block reads its V rows
// (64 x 16 x C) and U rows (128 x 16 x C) from L2: 16 * C * 192 * 2 bytes,
// 7.9 MB at C = 1280, 1.8 GB over the 230 blocks of 10x1280@24^2->1280.
// Each 24 KB stage carries 1 MFLOP (44 FLOP/byte between L2 and the SMs),
// so L2 bandwidth, not the tensor cores, bounds the GEMM. Where the grid of
// two-consumer blocks would not cover the 132 SMs (10x2560@12^2: 60
// blocks) the block has one consumer warpgroup and 64 channels, doubling
// the blocks.
//
// ptxas (CUDA 12.8, sm_90a): the GEMM with two consumers 168 registers at
// launch (setmaxnreg 40/232), with one consumer 232, the input transform
// 42; 0 bytes of spills in all three, 4 HGMMA in each GEMM's SASS.
// chip_smoke.py prints these for every build.

#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

// A^T[q][i] for q in {0, 1}
__host__ __device__ constexpr int at(int q, int i) {
  return q == 0 ? (i == 3 ? 0 : 1) : (i == 0 ? 0 : (i == 1 ? 1 : -1));
}

// ---- 1. input transform ------------------------------------------------

constexpr int XT = 32;              // tiles per block along W
constexpr int XC = 64;              // channels per block
constexpr int X_THREADS = 256;
constexpr int XPAIRS = XT + 2;      // column pairs 2tx0-2 .. 2tx0+2XT+1
constexpr int XROW = 2 * XPAIRS;    // bf16 per staged input row
constexpr int XCH = 4 * XROW + 2;   // bf16 per channel: an odd word count,
                                    // so lanes 2 channels apart do not
                                    // share a bank

__global__ void __launch_bounds__(X_THREADS)
winograd_input_kernel(const bf16* __restrict__ x, bf16* __restrict__ v,
                      int C, int H, int W, int T) {
  __shared__ __align__(4) bf16 patch[XC * XCH];
  const int ht = H / 2, wt = W / 2;
  const int strips = cdiv(wt, XT);
  const int s = blockIdx.x % strips;
  const int bty = blockIdx.x / strips;  // b * ht + ty
  const int ty = bty % ht, b = bty / ht;
  const int tx0 = s * XT;
  const int ntx = min(XT, wt - tx0);
  const int c0 = blockIdx.y * XC;
  const bf16* xb = x + ((size_t)b * C + c0) * H * W;
  // input rows 2ty-1 .. 2ty+2 as bf16 pairs from column 2tx0-2; W is even,
  // so a pair lies wholly inside or outside the image; zeros outside
  for (int i = threadIdx.x; i < XC * 4 * XPAIRS; i += X_THREADS) {
    const int pr = i % XPAIRS, row = i / XPAIRS;
    const int r = row % 4, c = row / 4;
    const int hh = 2 * ty - 1 + r, ww = 2 * tx0 - 2 + 2 * pr;
    __nv_bfloat162 pair = __floats2bfloat162_rn(0.0f, 0.0f);
    if (hh >= 0 && hh < H && ww >= 0 && ww < W)
      pair = *reinterpret_cast<const __nv_bfloat162*>(
          xb + ((size_t)c * H + hh) * W + ww);
    *reinterpret_cast<__nv_bfloat162*>(patch + c * XCH + r * XROW + 2 * pr) =
        pair;
  }
  __syncthreads();
  // one tile and a channel pair per thread; a warp stores 64 channels
  const size_t tile0 = (size_t)bty * wt + tx0;
  for (int i = threadIdx.x; i < ntx * (XC / 2); i += X_THREADS) {
    const int cp = i % (XC / 2), t = i / (XC / 2);
    float vv[2][16];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      // the tile's 4x4 patch: image columns 2(tx0 + t) - 1 ..
      const bf16* src = patch + (2 * cp + e) * XCH + 2 * t + 1;
      float d[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          d[r][q] = __bfloat162float(src[r * XROW + q]);
      float f[4][4];  // B^T d
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        f[0][q] = d[0][q] - d[2][q];
        f[1][q] = d[1][q] + d[2][q];
        f[2][q] = d[2][q] - d[1][q];
        f[3][q] = d[1][q] - d[3][q];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // (B^T d) B
        vv[e][4 * r + 0] = f[r][0] - f[r][2];
        vv[e][4 * r + 1] = f[r][1] + f[r][2];
        vv[e][4 * r + 2] = f[r][2] - f[r][1];
        vv[e][4 * r + 3] = f[r][1] - f[r][3];
      }
    }
    bf16* dst = v + (tile0 + t) * C + c0 + 2 * cp;
#pragma unroll
    for (int ij = 0; ij < 16; ++ij)
      *reinterpret_cast<uint32_t*>(dst + (size_t)ij * T * C) =
          pack_bf16(vv[0][ij], vv[1][ij]);
  }
}

// ---- 2. GEMM with the output transform ---------------------------------

constexpr int BC = 64;    // input channels per stage: 128 bytes
constexpr int TM = 64;    // tiles per block (the wgmma M)
constexpr int WN = 64;    // output channels per consumer warpgroup
constexpr int RING_BYTES = 192 * 1024;
constexpr int EPI_PITCH = 2 * TM + 8;  // words per channel of staged output

template <int CONSUMERS>
struct Gemm {
  static constexpr int THREADS = 128 * (1 + CONSUMERS);
  static constexpr int BN = WN * CONSUMERS;
  static constexpr int A_BYTES = TM * BC * 2;           // 8 KB
  static constexpr int STAGE = A_BYTES + BN * BC * 2;   // 24 KB or 16 KB
  static constexpr int STAGES = RING_BYTES / STAGE;     // 8 or 12
  static constexpr int SM_BAR = STAGES * STAGE;
  static constexpr int SMEM = SM_BAR + 16 * STAGES + 1024;  // + alignment
  static_assert(CONSUMERS * WN * EPI_PITCH * 4 <= SM_BAR,
                "the staged output fits in the ring");
};

template <int CONSUMERS>
__global__ void __launch_bounds__(Gemm<CONSUMERS>::THREADS, 1)
winograd_gemm_kernel(const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_u,
                     const bf16* __restrict__ bias, bf16* __restrict__ y,
                     int C, int H, int W, int K, int T) {
  using G = Gemm<CONSUMERS>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_full = base + G::SM_BAR;           // [STAGES]
  const uint32_t bar_empty = bar_full + 8 * G::STAGES;  // [STAGES]
  const int t0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * G::BN;
  const int nc = C / BC;
  const int n_iter = 16 * nc;

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
      for (int it = 0; it < n_iter; ++it) {
        const int st = it % G::STAGES;
        const int ij = it / nc, cb = it % nc;
        if (it >= G::STAGES)
          mbar_wait(bar_empty + 8 * st, ((it / G::STAGES) - 1) & 1);
        const uint32_t stage = base + st * G::STAGE;
        mbar_expect_tx(bar_full + 8 * st, G::STAGE);
        tma_load(stage, &tm_v, cb * BC, t0, ij, bar_full + 8 * st);
        tma_load(stage + G::A_BYTES, &tm_u, cb * BC, n0, ij,
                 bar_full + 8 * st);
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
    for (int cb = 0; cb < nc; ++cb, ++it) {
      const int st = it % G::STAGES;
      mbar_wait(bar_full + 8 * st, (it / G::STAGES) & 1);
      const uint32_t a_tile = base + st * G::STAGE;
      const uint32_t b_tile = a_tile + G::A_BYTES + c * WN * BC * 2;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk)
        wgmma_ss<WN>(acc, kmajor_desc(a_tile + 32 * kk),
                     kmajor_desc(b_tile + 32 * kk), cb > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the group of the previous stage is done
      if (cb > 0 && lane == 0)
        mbar_arrive(bar_empty + 8 * ((it - 1) % G::STAGES));
    }
    wgmma_wait<0>();  // M_ij is complete
    if (lane == 0) mbar_arrive(bar_empty + 8 * ((it - 1) % G::STAGES));
    fence_regs(acc);
    const int i = ij / 4, j = ij % 4;
    const float ai[2] = {(float)at(0, i), (float)at(1, i)};
    const float aj[2] = {(float)at(0, j), (float)at(1, j)};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float coef = ai[q >> 1] * aj[q & 1];  // 0 or +-1
      if (coef != 0.f) {
#pragma unroll
        for (int k = 0; k < WN / 2; ++k) yq[q][k] = fmaf(coef, acc[k], yq[q][k]);
      }
    }
  }

  // Every consumer is done with the ring: stage Y there as [channel]
  // [tile][qa] bf16 pairs (qb = 0, 1), bias added in fp32.
  named_barrier(1, 128 * CONSUMERS);
  uint32_t* ys = reinterpret_cast<uint32_t*>(
                     smem_raw + (base - smem_u32(smem_raw))) +
                 c * WN * EPI_PITCH;
  const int r0 = (t / 32) * 16 + lane / 4;  // accumulator rows r0, r0 + 8
  const int col = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ch = 8 * j + col + e;
      const float bn = __bfloat162float(bias[n0 + c * WN + ch]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int k = 4 * j + 2 * half + e;
        uint32_t* row = ys + ch * EPI_PITCH + 2 * (r0 + 8 * half);
        row[0] = pack_bf16(yq[0][k] + bn, yq[1][k] + bn);  // qa = 0
        row[1] = pack_bf16(yq[2][k] + bn, yq[3][k] + bn);  // qa = 1
      }
    }
  }
  named_barrier(2 + c, 128);
  const int ht = H / 2, wt = W / 2;
  for (int i = t; i < WN * TM * 2; i += 128) {
    const int r = i % TM, qa = (i / TM) % 2, ch = i / (2 * TM);
    const int tile = t0 + r;
    if (tile >= T) continue;
    const int b = tile / (ht * wt), rem = tile % (ht * wt);
    const int ty = rem / wt, tx = rem % wt;
    const int n = n0 + c * WN + ch;
    *reinterpret_cast<uint32_t*>(
        y + (((size_t)b * K + n) * H + 2 * ty + qa) * W + 2 * tx) =
        ys[ch * EPI_PITCH + 2 * r + qa];
  }
}

int pick_consumers(int T, int K) {
  return cdiv(T, TM) * (K / (2 * WN)) >= 132 ? 2 : 1;
}

template <int CONSUMERS>
cudaError_t launch_gemm(EncodeTiledFn fn, const void* v, const void* u,
                        const bf16* bias, bf16* y, int C, int H, int W, int K,
                        int T, cudaStream_t stream) {
  using G = Gemm<CONSUMERS>;
  const cuuint64_t dims_v[3] = {(cuuint64_t)C, (cuuint64_t)T, 16};
  const cuuint64_t strides_v[2] = {(cuuint64_t)C * 2, (cuuint64_t)T * C * 2};
  const cuuint32_t box_v[3] = {BC, TM, 1};
  const cuuint64_t dims_u[3] = {(cuuint64_t)C, (cuuint64_t)K, 16};
  const cuuint64_t strides_u[2] = {(cuuint64_t)C * 2, (cuuint64_t)K * C * 2};
  const cuuint32_t box_u[3] = {BC, (cuuint32_t)G::BN, 1};
  CUtensorMap tm_v, tm_u;
  if (!encode_bf16_sw128(fn, &tm_v, v, 3, dims_v, strides_v, box_v) ||
      !encode_bf16_sw128(fn, &tm_u, u, 3, dims_u, strides_u, box_u))
    return cudaErrorInvalidValue;
  auto kernel = winograd_gemm_kernel<CONSUMERS>;
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

// x [B, C, H, W], u [16, K, C], bias [K], y [B, K, H, W] bf16, and the
// scratch v [16, B * H/2 * W/2, C] bf16 that the caller allocates; x
// 4-byte, u and v 16-byte aligned. Returns cudaSuccess (0),
// cudaErrorInvalidValue for odd H or W, C not a multiple of 64, K not a
// multiple of 128, a misaligned x or a map the driver refuses,
// cudaErrorNotSupported without cuTensorMapEncodeTiled, or the error of an
// attribute call or a launch.
int mt_winograd_fwd(const void* x, const void* u, const void* bias, void* v,
                    void* y, int B, int C, int H, int W, int K,
                    void* stream) {
  if (B < 1 || H < 2 || W < 2 || H % 2 || W % 2 || C % BC || C < BC ||
      K % (2 * WN) || K < 2 * WN || C / XC > 65535 ||
      reinterpret_cast<uintptr_t>(x) % 4 ||
      (long long)B * (H / 2) * (W / 2) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const int T = B * (H / 2) * (W / 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid_in(B * (H / 2) * cdiv(W / 2, XT), C / XC);
  winograd_input_kernel<<<grid_in, X_THREADS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(v), C, H, W, T);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bf16* bs = static_cast<const bf16*>(bias);
  bf16* out = static_cast<bf16*>(y);
  return pick_consumers(T, K) == 2
             ? (int)launch_gemm<2>(fn, v, u, bs, out, C, H, W, K, T, st)
             : (int)launch_gemm<1>(fn, v, u, bs, out, C, H, W, K, T, st);
}

// Blocks of the GEMM launch for this shape (132 SMs on the H100).
int mt_winograd_blocks(int B, int C, int H, int W, int K) {
  (void)C;
  const int T = B * (H / 2) * (W / 2);
  return cdiv(T, TM) * (K / (WN * pick_consumers(T, K)));
}

const char* mt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
