// SAME-padded stride-1 3x3 convolution on Hopper: nine shifted products.
//
// Replaces the TPU package's nine-tap Pallas kernel,
// marigold_tpu/ops/conv.py:_conv3x3_pallas / _kernel (opt-in under
// MARIGOLD_TPU_CONV=pallas):
//   y[b,k,h,w] = bias[k] + sum_{dy,dx,c} x[b,c,h+dy-1,w+dx-1] * W9[3dy+dx,k,c]
// bf16 in, fp32 accumulation, bf16 out. x and y are NCHW, the weight is the
// wrapper's tap-major [9, K, C] (C innermost), the bias [K].
//
// Formulation: an implicit GEMM with M = output pixels, N = K output
// channels, and a reduction of 9 * C ordered tap-major per channel chunk,
// as the TPU kernel loops its nine taps. There is no im2col copy and no
// padding copy: a block owns an 8 x 16 pixel tile of one image and 128
// output channels, and per chunk of 32 input channels it stages the
// (8+2) x (16+2) input halo (zero outside the image, by predicated loads)
// and the 9 x 128 x 32 weight panel in shared memory. Every one of the nine
// taps then reads its A operand from the same halo at a shifted offset: a
// 16-pixel fragment row is one tile row, contiguous in the halo, so a tap is
// an offset and not a copy. The TPU wrapper's H padding, flattening and
// column-wrap masks (a DMA-window artifact) have no counterpart.
//
// What bounds it on the H100: at the serving shapes (C, K = 128..2560,
// 12..768 pixels wide) the conv does 18*C*K FLOPs per output pixel against
// (C + K) * 2 bytes of activations: hundreds to thousands of FLOP per byte,
// far above the card's ~295 FLOP/byte ridge, so it is tensor-core bound.
// This first kernel issues warp-level mma.sync m16n8k16 (bf16, fp32
// accumulate in registers: each of 8 warps holds a 32 x 64 tile) from
// shared memory with one synchronisation pair per channel chunk and no
// software pipelining; the halo is reused 9 * 128 times, the weight panel
// 128 times. wgmma, TMA and a multi-stage ring are left to later work.
// Shared memory: 14.4 KB halo + 92.2 KB weights per block, two blocks per
// SM. Row pitches of 40 bf16 (80 bytes) keep the fragment loads of a warp
// on 32 distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TH = 8;           // output tile rows
constexpr int TW = 16;          // output tile columns (one fragment row)
constexpr int BN = 128;         // output channels per block
constexpr int KC = 32;          // input channels per stage
constexpr int PITCH = KC + 8;   // shared-memory row pitch (bf16)
constexpr int HALO_W = TW + 2;
constexpr int HALO = (TH + 2) * HALO_W;
constexpr int THREADS = 256;
constexpr size_t SMEM_HALO = (size_t)HALO * PITCH * sizeof(bf16);
constexpr size_t SMEM = SMEM_HALO + (size_t)9 * BN * PITCH * sizeof(bf16);

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D = A (16x16, row-major) * B (16x8, column-major) + D, bf16 in, fp32 acc.
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(THREADS, 2)
conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w9,
               const bf16* __restrict__ bias, bf16* __restrict__ y, int C,
               int H, int W, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* hs = reinterpret_cast<bf16*>(smem);              // [HALO][PITCH]
  bf16* ws = reinterpret_cast<bf16*>(smem + SMEM_HALO);  // [9*BN][PITCH]

  const int tiles_w = (W + TW - 1) / TW;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 3;   // tile rows 2*wm and 2*wm + 1
  const int wn = warp >> 2;  // output channels wn*64 .. wn*64 + 63
  const size_t hw = (size_t)H * W;
  const bf16* xb = x + (size_t)b * C * hw;
  const bf16 zero = __float2bfloat16(0.0f);

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += KC) {
    // input halo, two channels per 32-bit store; zero outside the image
    for (int i = tid; i < HALO * (KC / 2); i += THREADS) {
      const int cp = i / HALO, p = i - cp * HALO;
      const int hh = h0 - 1 + p / HALO_W, ww = w0 - 1 + p % HALO_W;
      __nv_bfloat162 pair;
      pair.x = zero;
      pair.y = zero;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
        const bf16* src = xb + (size_t)(c0 + 2 * cp) * hw + (size_t)hh * W + ww;
        pair.x = src[0];
        pair.y = src[hw];
      }
      *reinterpret_cast<__nv_bfloat162*>(hs + p * PITCH + 2 * cp) = pair;
    }
    // weight panel [tap][n][c], 16-byte vectors
    for (int i = tid; i < 9 * BN * (KC / 8); i += THREADS) {
      const int row = i / (KC / 8), v = i % (KC / 8);
      const int tap = row / BN, n = row % BN;
      *reinterpret_cast<uint4*>(ws + row * PITCH + v * 8) =
          *reinterpret_cast<const uint4*>(
              w9 + ((size_t)tap * K + n0 + n) * C + c0 + v * 8);
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const bf16* wt = ws + tap * BN * PITCH;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const bf16* base =
              hs + ((2 * wm + mi + dy) * HALO_W + dx) * PITCH + kk + 2 * t4;
          a[mi][0] = ld32(base + g * PITCH);
          a[mi][1] = ld32(base + (g + 8) * PITCH);
          a[mi][2] = ld32(base + g * PITCH + 8);
          a[mi][3] = ld32(base + (g + 8) * PITCH + 8);
        }
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const bf16* bb = wt + (wn * 64 + ni * 8 + g) * PITCH + kk + 2 * t4;
          const uint32_t bf[2] = {ld32(bb), ld32(bb + 8)};
          mma16816(acc[0][ni], a[0], bf);
          mma16816(acc[1][ni], a[1], bf);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: bias, bf16, NCHW; fragment rows are tile columns g and g + 8
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int h = h0 + 2 * wm + mi;
    if (h >= H) continue;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int w = w0 + g + (e >> 1) * 8;
        const int n = n0 + wn * 64 + ni * 8 + 2 * t4 + (e & 1);
        if (w < W) {
          y[((size_t)b * K + n) * hw + (size_t)h * W + w] =
              __float2bfloat16(acc[mi][ni][e] + __bfloat162float(bias[n]));
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Returns cudaSuccess (0), cudaErrorInvalidValue for C not a multiple of 32
// or K not a multiple of 128, or the error of the attribute call or launch.
int mt_conv3x3_fwd(const void* x, const void* w9, const void* bias, void* y,
                   int B, int C, int H, int W, int K, void* stream) {
  if (C % KC || K % BN || B > 65535 || K / BN > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), K / BN, B);
  conv3x3_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w9),
      static_cast<const bf16*>(bias), static_cast<bf16*>(y), C, H, W, K);
  return (int)cudaGetLastError();
}

const char* mt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
