// Winograd F(2x2, 3x3) SAME-padded stride-1 convolution on Hopper.
//
// Replaces the TPU package's Winograd Pallas kernel,
// marigold_tpu/ops/winograd.py:_winograd_impl / _kernel (opt-in under
// MARIGOLD_TPU_CONV=winograd). Per 2x2 output tile with 4x4 input patch d:
//   V = B^T d B (per input channel), M_ij = sum_c V_ij[c] U_ij[c, k],
//   Y = A^T M A + bias,
//   B^T = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]],
//   A^T = [[1,1,1,0],[0,1,-1,-1]],
// with U = G g G^T computed by the wrapper in fp32 and rounded to bf16 (as
// the TPU wrapper computes it outside its kernel), laid out [16, K, C].
// x and y are NCHW bf16, the bias [K] bf16; H and W are even.
//
// Formulation: a block owns 4 x 16 output tiles (8 x 32 pixels) of one image
// and 64 output channels. Per chunk of 16 input channels it reads each
// tile's 4x4 patch straight from NCHW with predicated loads (zero outside
// the image; the TPU wrapper's pixel unshuffle and 8-aligned phase width
// were Mosaic unit-stride artifacts), forms V in fp32 and rounds it once to
// bf16 into shared memory [16][64 tiles][16 ch], and stages the U panel
// [16][64][16]. For each of the 16 positions ij a warp then multiplies its
// 16 tiles x 32 channels with one mma.sync m16n8k16 per 8 channels into a
// fresh fp32 fragment and adds it with the signs of A^T into the four
// output-phase accumulators: M is linear, and fragments of one shape share a
// register layout, so the output transform is exact elementwise adds and no
// 16 live product accumulators are needed.
//
// What bounds it on the H100: 16 products per 4 output pixels, 8*C*K FLOPs
// per pixel (2.25x fewer than the direct conv's 18*C*K) over the same
// activation bytes: still hundreds of FLOP per byte at the serving shapes,
// so tensor-core bound in principle. This first kernel adds ~36 fp32 adds
// per 16 tensor-core products per chunk (the output transform done per
// chunk), recomputes V per 64-channel output block, and has no software
// pipelining; wgmma and a deeper chunk are left to later work. Shared
// memory: 48 KB V + 48 KB U per block, two blocks per SM; row pitches of 24
// bf16 (48 bytes) keep the fragment loads of a warp on distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TR = 4;            // tile rows per block
constexpr int TC = 16;           // tile columns per block (one fragment)
constexpr int MT = TR * TC;      // tiles per block
constexpr int BN = 64;           // output channels per block
constexpr int KC = 16;           // input channels per stage
constexpr int PITCH = KC + 8;    // shared-memory row pitch (bf16)
constexpr int THREADS = 256;
constexpr size_t SMEM_V = (size_t)16 * MT * PITCH * sizeof(bf16);
constexpr size_t SMEM = SMEM_V + (size_t)16 * BN * PITCH * sizeof(bf16);

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A^T[q][i] for q in {0, 1}
__device__ __forceinline__ constexpr int at(int q, int i) {
  return q == 0 ? (i == 3 ? 0 : 1) : (i == 0 ? 0 : (i == 1 ? 1 : -1));
}

__global__ void __launch_bounds__(THREADS, 2)
winograd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ u,
                const bf16* __restrict__ bias, bf16* __restrict__ y, int C,
                int H, int W, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* vs = reinterpret_cast<bf16*>(smem);           // [16][MT][PITCH]
  bf16* us = reinterpret_cast<bf16*>(smem + SMEM_V);  // [16][BN][PITCH]

  const int ht = H / 2, wt = W / 2;
  const int blocks_w = (wt + TC - 1) / TC;
  const int ty0 = (blockIdx.x / blocks_w) * TR;
  const int tx0 = (blockIdx.x % blocks_w) * TC;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 3;   // tile row wm of the block
  const int wn = warp >> 2;  // output channels wn*32 .. wn*32 + 31
  const size_t hw = (size_t)H * W;
  const bf16* xb = x + (size_t)b * C * hw;

  float acc[4][4][4];  // [output phase 2*qa+qb][n fragment][element]
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][ni][e] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += KC) {
    // input transform V = B^T d B in fp32, rounded once to bf16
    for (int i = tid; i < MT * KC; i += THREADS) {
      const int c = i / MT, t = i % MT;
      const int r0 = 2 * (ty0 + t / TC) - 1, s0 = 2 * (tx0 + t % TC) - 1;
      const bf16* src = xb + (size_t)(c0 + c) * hw;
      float d[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int hh = r0 + r, ww = s0 + s;
          d[r][s] = (hh >= 0 && hh < H && ww >= 0 && ww < W)
                        ? __bfloat162float(src[(size_t)hh * W + ww])
                        : 0.0f;
        }
      float e[4][4];  // B^T d
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        e[0][s] = d[0][s] - d[2][s];
        e[1][s] = d[1][s] + d[2][s];
        e[2][s] = d[2][s] - d[1][s];
        e[3][s] = d[1][s] - d[3][s];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float v[4] = {e[r][0] - e[r][2], e[r][1] + e[r][2],
                            e[r][2] - e[r][1], e[r][1] - e[r][3]};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          vs[((4 * r + j) * MT + t) * PITCH + c] = __float2bfloat16(v[j]);
        }
      }
    }
    // filter panel U[ij][n][c], 16-byte vectors
    for (int i = tid; i < 16 * BN * (KC / 8); i += THREADS) {
      const int row = i / (KC / 8), v = i % (KC / 8);
      const int ij = row / BN, n = row % BN;
      *reinterpret_cast<uint4*>(us + row * PITCH + v * 8) =
          *reinterpret_cast<const uint4*>(
              u + ((size_t)ij * K + n0 + n) * C + c0 + v * 8);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ij = 4 * i + j;
        const bf16* va = vs + (ij * MT + wm * TC) * PITCH + 2 * t4;
        const uint32_t a[4] = {ld32(va + g * PITCH), ld32(va + (g + 8) * PITCH),
                               ld32(va + g * PITCH + 8),
                               ld32(va + (g + 8) * PITCH + 8)};
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const bf16* ub = us + (ij * BN + wn * 32 + ni * 8 + g) * PITCH + 2 * t4;
          const uint32_t bf[2] = {ld32(ub), ld32(ub + 8)};
          float m[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma16816(m, a, bf);
#pragma unroll
          for (int qa = 0; qa < 2; ++qa) {
#pragma unroll
            for (int qb = 0; qb < 2; ++qb) {
              const int coef = at(qa, i) * at(qb, j);
              if (coef == 0) continue;
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                acc[2 * qa + qb][ni][e] += coef > 0 ? m[e] : -m[e];
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // epilogue: output phase (qa, qb) of tile (ty, tx) is pixel
  // (2*ty + qa, 2*tx + qb); fragment rows are tile columns g and g + 8
  const int ty = ty0 + wm;
  if (ty >= ht) return;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int tx = tx0 + g + (e >> 1) * 8;
      const int n = n0 + wn * 32 + ni * 8 + 2 * t4 + (e & 1);
      if (tx >= wt) continue;
      const float bn = __bfloat162float(bias[n]);
      bf16* out = y + ((size_t)b * K + n) * hw;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        out[(size_t)(2 * ty + (q >> 1)) * W + 2 * tx + (q & 1)] =
            __float2bfloat16(acc[q][ni][e] + bn);
      }
    }
  }
}

}  // namespace

extern "C" {

// Returns cudaSuccess (0), cudaErrorInvalidValue for odd H or W, C not a
// multiple of 16 or K not a multiple of 64, or the error of the attribute
// call or the launch.
int mt_winograd_fwd(const void* x, const void* u, const void* bias, void* y,
                    int B, int C, int H, int W, int K, void* stream) {
  if (H % 2 || W % 2 || C % KC || K % BN || B > 65535 || K / BN > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      winograd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const int ht = H / 2, wt = W / 2;
  const dim3 grid(((ht + TR - 1) / TR) * ((wt + TC - 1) / TC), K / BN, B);
  winograd_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(u),
      static_cast<const bf16*>(bias), static_cast<bf16*>(y), C, H, W, K);
  return (int)cudaGetLastError();
}

const char* mt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
