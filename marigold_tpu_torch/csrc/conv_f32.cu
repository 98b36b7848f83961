// SAME-padded stride-1 3x3 convolutions in fp32 storage, for
// `--full_precision` under MARIGOLD_TPU_CONV=pallas|winograd: a nine-tap
// implicit GEMM and a Winograd F(2x2, 3x3), both multiplying on the CUDA
// cores (FFMA) with fp32 sums.
//
// Replaces the fp32 instantiations of the TPU package's
//   * marigold_tpu/ops/conv.py:_conv3x3_pallas (pallas_call at :176), whose
//     gate admits fp32 (:77), and
//   * marigold_tpu/ops/winograd.py:_winograd_impl (pallas_call at :251),
//     whose gate admits fp32 (:89).
// The bf16 kernels (conv3x3.cu, winograd.cu) run on wgmma, which takes no
// fp32 operand; TF32 keeps ~10 mantissa bits, which is not full precision.
//
// Nine-tap: y[b, k, p] = bias[k] + sum_{t, c} x[b, c, p + off_t] w9[t, k, c]
// over the 9 taps t = 3 dy + dx (off_t = (dy - 1, dx - 1), zero outside the
// image), x and y NCHW, w9 the tap-major [9, K, C] weight (ops/conv.py:taps).
// One block of 256 threads takes 64 pixels of one image (the flattened
// H*W index) x 64 output channels; the reduction walks taps x 16-channel
// chunks. The A tile [16 ch][64 px] is read straight from NCHW (consecutive
// pixels are consecutive addresses; the shift by the tap and the zero
// padding are computed per element), the B tile [16 ch][64 K] is read as
// float4 along C and stored transposed. Each thread holds 4 pixels x 4
// channels: 16 FFMA per two float4 shared-memory reads.
//
// Winograd (Lavin & Gray), with the TPU package's and ops/winograd.py's
// matrices: V = B^T d B per 4x4 input patch and channel, M_ij = sum_c
// V_ij[c] U_ij[k, c] with U = G g G^T ([16, K, C], ops/winograd.py:
// filter_transform), Y = A^T M A + bias, all in fp32.
//   1. input transform: one thread per (2x2 output tile, channel) writes
//      V[16][C][T] (T = B * H/2 * W/2 tiles, tiles innermost so that both
//      this write and the product's A-tile read are consecutive);
//   2. the 16 products with the output transform fused: one block per 64
//      tiles x 64 output channels; for each ij the thread's 4 x 4 block of
//      M_ij is summed over all of C, then added with its A^T coefficients
//      into the four output phases (a 2x2 output tile per tile) held in
//      registers; bias and the NCHW stores at the end.
// The V scratch [16, C, T] fp32 is the caller's.
//
// What bounds them on the H100: 18 B H W C K FLOPs (Winograd: 8) over
// ~4 (x + w + y) bytes, hundreds of FLOP per byte at the UNet shapes, so
// both are bound by FFMA issue against the 67 TFLOP/s fp32 CUDA-core peak
// and by the shared-memory reads feeding it. The design is the simple one:
// one tile in flight (no cp.async ring), no split of the reduction.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BM = 64;  // pixels (nine-tap) or tiles (Winograd) per block
constexpr int BN = 64;  // output channels per block
constexpr int BK = 16;  // reduction channels per stage
constexpr int LB = BN + 4;

// B tile: rows [k0, k0 + BN) of a [K, C] matrix, channels [c0, c0 + BK),
// stored transposed as bs[c][k] (row stride LB)
__device__ __forceinline__ void load_b_transposed(float* bs, const float* w,
                                                  int k0, int c0, int C,
                                                  int tid) {
  const int kk = tid / 4, c4 = tid % 4;
  const float4 val = *reinterpret_cast<const float4*>(
      w + (size_t)(k0 + kk) * C + c0 + 4 * c4);
  bs[(4 * c4 + 0) * LB + kk] = val.x;
  bs[(4 * c4 + 1) * LB + kk] = val.y;
  bs[(4 * c4 + 2) * LB + kk] = val.z;
  bs[(4 * c4 + 3) * LB + kk] = val.w;
}

// acc[i][j] += sum_c as[c][4 tx + i] * bs[c][4 ty + j]
__device__ __forceinline__ void product(float (&acc)[4][4], const float* as,
                                        const float* bs, int tx, int ty) {
#pragma unroll
  for (int c = 0; c < BK; ++c) {
    const float4 a = *reinterpret_cast<const float4*>(as + c * BM + 4 * tx);
    const float4 b = *reinterpret_cast<const float4*>(bs + c * LB + 4 * ty);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__global__ void __launch_bounds__(THREADS)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w9,
                   const float* __restrict__ bias, float* __restrict__ y,
                   int C, int H, int W, int K) {
  __shared__ __align__(16) float as[BK * BM];
  __shared__ __align__(16) float bs[BK * LB];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int hw = H * W, p0 = blockIdx.x * BM, k0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  // this thread's A-tile pixel: the same for every stage
  const int pp = tid % BM, p = p0 + pp;
  const int ph = p / W, pw = p % W;
  const float* xb = x + (size_t)b * C * hw;

  float acc[4][4] = {};
  for (int tap = 0; tap < 9; ++tap) {
    const int hh = ph + tap / 3 - 1, ww = pw + tap % 3 - 1;
    const bool inside = p < hw && hh >= 0 && hh < H && ww >= 0 && ww < W;
    const int src = hh * W + ww;
    const float* wt = w9 + (size_t)tap * K * C;
    for (int c0 = 0; c0 < C; c0 += BK) {
#pragma unroll
      for (int e = 0; e < BK * BM / THREADS; ++e) {
        const int cc = tid / BM + e * (THREADS / BM);
        as[cc * BM + pp] = inside ? xb[(size_t)(c0 + cc) * hw + src] : 0.f;
      }
      load_b_transposed(bs, wt, k0, c0, C, tid);
      __syncthreads();
      product(acc, as, bs, tx, ty);
      __syncthreads();
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = k0 + 4 * ty + j;
    const float bk = bias[k];
    float* yk = y + ((size_t)b * K + k) * hw;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = p0 + 4 * tx + i;
      if (q < hw) yk[q] = acc[i][j] + bk;
    }
  }
}

__constant__ float kBT[4][4] = {
    {1, 0, -1, 0}, {0, 1, 1, 0}, {0, -1, 1, 0}, {0, 1, 0, -1}};
__constant__ float kAT[2][4] = {{1, 1, 1, 0}, {0, 1, -1, -1}};

// V[ij][c][t] = sum_{r, s} BT[i][r] d[r][s] BT[j][s] for the 4x4 patch d of
// channel c at rows 2 ty - 1 .. 2 ty + 2, columns 2 tx - 1 .. 2 tx + 2
__global__ void __launch_bounds__(THREADS)
winograd_f32_input_kernel(const float* __restrict__ x, float* __restrict__ v,
                          int C, int H, int W, int T) {
  const int t = blockIdx.x * THREADS + threadIdx.x, c = blockIdx.y;
  if (t >= T) return;
  const int h2 = H / 2, w2 = W / 2;
  const int b = t / (h2 * w2), ty = t % (h2 * w2) / w2, tx = t % w2;
  const float* xc = x + ((size_t)b * C + c) * H * W;
  float d[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int hh = 2 * ty - 1 + r;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int ww = 2 * tx - 1 + s;
      d[r][s] = (hh >= 0 && hh < H && ww >= 0 && ww < W)
                    ? xc[(size_t)hh * W + ww] : 0.f;
    }
  }
  float bd[4][4];  // B^T d
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) sum = fmaf(kBT[i][r], d[r][s], sum);
      bd[i][s] = sum;
    }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float sum = 0.f;
#pragma unroll
      for (int s = 0; s < 4; ++s) sum = fmaf(bd[i][s], kBT[j][s], sum);
      v[((size_t)(4 * i + j) * C + c) * T + t] = sum;
    }
}

__global__ void __launch_bounds__(THREADS)
winograd_f32_gemm_kernel(const float* __restrict__ v,
                         const float* __restrict__ u,
                         const float* __restrict__ bias,
                         float* __restrict__ y, int C, int H, int W, int K,
                         int T) {
  __shared__ __align__(16) float as[BK * BM];
  __shared__ __align__(16) float bs[BK * LB];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int t0 = blockIdx.x * BM, k0 = blockIdx.y * BN;
  const int mm = tid % BM;
  const bool row_in = t0 + mm < T;

  float out[4][4][4] = {};  // [phase 2 py + px][tile i][channel j]
  for (int ij = 0; ij < 16; ++ij) {
    const float* vij = v + (size_t)ij * C * T;
    const float* uij = u + (size_t)ij * K * C;
    float m[4][4] = {};
    for (int c0 = 0; c0 < C; c0 += BK) {
#pragma unroll
      for (int e = 0; e < BK * BM / THREADS; ++e) {
        const int cc = tid / BM + e * (THREADS / BM);
        as[cc * BM + mm] = row_in ? vij[(size_t)(c0 + cc) * T + t0 + mm] : 0.f;
      }
      load_b_transposed(bs, uij, k0, c0, C, tid);
      __syncthreads();
      product(m, as, bs, tx, ty);
      __syncthreads();
    }
    const int i = ij / 4, j = ij % 4;
#pragma unroll
    for (int py = 0; py < 2; ++py)
#pragma unroll
      for (int px = 0; px < 2; ++px) {
        const float coef = kAT[py][i] * kAT[px][j];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            out[2 * py + px][a][c] = fmaf(coef, m[a][c], out[2 * py + px][a][c]);
      }
  }
  const int h2 = H / 2, w2 = W / 2;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int t = t0 + 4 * tx + a;
    if (t >= T) continue;
    const int b = t / (h2 * w2), ty2 = t % (h2 * w2) / w2, tx2 = t % w2;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = k0 + 4 * ty + c;
      const float bk = bias[k];
      float* yk = y + ((size_t)b * K + k) * H * W;
#pragma unroll
      for (int ph = 0; ph < 4; ++ph)
        yk[(size_t)(2 * ty2 + ph / 2) * W + 2 * tx2 + ph % 2] =
            out[ph][a][c] + bk;
    }
  }
}

}  // namespace

extern "C" {

// x [B, C, H, W], w9 [9, K, C] (16-byte aligned), bias [K], y [B, K, H, W],
// all fp32 and contiguous. Returns cudaSuccess (0), cudaErrorInvalidValue
// for C not a multiple of 16 or K not a multiple of 64, or the launch's
// error.
int mt_conv3x3_f32_fwd(const void* x, const void* w9, const void* bias,
                       void* y, int B, int C, int H, int W, int K,
                       void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < BK || C % BK || K < BN || K % BN ||
      B > 65535 || K / BN > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((H * W + BM - 1) / BM, K / BN, B);
  conv3x3_f32_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w9),
      static_cast<const float*>(bias), static_cast<float*>(y), C, H, W, K);
  return (int)cudaGetLastError();
}

// x [B, C, H, W] (H, W even), u [16, K, C] (16-byte aligned), bias [K],
// the scratch v [16, C, B * H/2 * W/2], y [B, K, H, W], all fp32 and
// contiguous. Two launches: the input transform, then the products with
// the output transform. Returns cudaSuccess (0), cudaErrorInvalidValue for
// odd H or W, C not a multiple of 16 or K not a multiple of 64, or a
// launch's error.
int mt_winograd_f32_fwd(const void* x, const void* u, const void* bias,
                        void* v, void* y, int B, int C, int H, int W, int K,
                        void* stream) {
  if (B < 1 || H < 2 || W < 2 || H % 2 || W % 2 || C < BK || C % BK ||
      K < BN || K % BN || C > 65535 || K / BN > 65535)
    return (int)cudaErrorInvalidValue;
  const int T = B * (H / 2) * (W / 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  winograd_f32_input_kernel<<<dim3((T + THREADS - 1) / THREADS, C), THREADS,
                              0, st>>>(static_cast<const float*>(x),
                                       static_cast<float*>(v), C, H, W, T);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  winograd_f32_gemm_kernel<<<dim3((T + BM - 1) / BM, K / BN), THREADS, 0,
                             st>>>(static_cast<const float*>(v),
                                   static_cast<const float*>(u),
                                   static_cast<const float*>(bias),
                                   static_cast<float*>(y), C, H, W, K, T);
  return (int)cudaGetLastError();
}

const char* mt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
