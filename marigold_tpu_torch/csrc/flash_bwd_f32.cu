// Flash-attention backward dQ in fp32 storage, d = 64: CUDA-core FFMA tiles
// in shared memory, the fp32 counterpart of flash_bwd_sm90.cu's dQ kernel.
//
// Replaces the fp32 instantiation of the TPU package's
// marigold_tpu/ops/flash_attention.py backward, `_flash_dt_bwd_pallas`:
//   * _flash_bwd_dq_kernel  (dQ; the pallas_call at :800).
// Its partner, _flash_bwd_dkv_kernel (dK and dV; :832), is
// flash_bwd_dkv_f32_sm90.cu: 3xTF32 products on wgmma. The training forward
// that writes the logsumexp both read is the online variant of
// flash_fwd_f32.cu (mt_flash_fwd_lse_f32). Here the products run on the
// CUDA cores, and P and dS stay fp32 (the plain version's casts to the
// storage dtype are no-ops in fp32).
//
// Math per (batch, head), all fp32, as the TPU kernels compute it:
//   S = Q K^T * scale;  P = exp(S - lse_row);  dP = dO V^T;
//   dS = P o (dP - delta_row),  delta = rowsum(dO o O) (from the caller);
//   dQ = dS K * scale.
// lse and delta are the caller's [B*H, ld_stat] rows padded to a multiple of
// 64 (ops/flash_attention.py:bwd_stats): lse = 1e30 in a padded row makes
// exp(S - lse) = 0, so padded query rows add nothing; key columns j >= nk
// get P = 0.
//
// Layout: q, dO and dQ are [B, nq, ldq], k and v [B, nk, ldkv] fp32, head h
// at channels [64 h, 64 h + 64). Each block of 256 threads (16 x 16) owns
// one 64-row tile of dQ of one (b, h), so no two blocks write the same
// element: no atomics, and two calls give the same bits. Its Q and dO tiles
// and their lse and delta stay resident; it walks 64-key tiles of K and V:
// S and dP, each thread a 4 x 4 block (rows ty + 16 i, columns tx + 16 j),
// dS into shared memory, then dQ += dS K, each thread rows ty + 16 i and
// columns 4 tx .. 4 tx + 3 in registers. Five [64, 68] tiles, 85 KB. Rows
// are padded to 68 floats, so the float4 reads of rows tx + 16 j fall on
// distinct banks in each 8-lane phase, as in flash_fwd_f32.cu.
//
// What bounds it on the H100: 6 N^2 D FLOPs per head over ~5 N D * 4
// bytes, far above the ridge of the 67 TFLOP/s fp32 CUDA-core peak: it is
// bound by FFMA issue and the shared-memory reads that feed it (8 FFMA per
// 16-byte read in each product). The design is the simple one: one tile in
// flight, each product from float4 shared-memory reads into register
// blocks. The tensor-core design of its partner (3xTF32 on wgmma,
// flash_bwd_dkv_f32_sm90.cu) is ROADMAP work for it.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int D = 64;        // head width
constexpr int BT = 64;       // rows of the output tile and of a walked tile
constexpr int THREADS = 256;
constexpr int LD = D + 4;    // padded row of a tile, in floats
constexpr int TILE = BT * LD;

// rows [n0, n0 + BT) of one head of a [B, N, ld] tensor into dst; rows past
// n are zero
__device__ __forceinline__ void load_tile(float* dst, const float* src, int n0,
                                          int n, int ld, int tid) {
  constexpr int PER_ROW = D / 4;
  for (int idx = tid; idx < BT * PER_ROW; idx += THREADS) {
    const int row = idx / PER_ROW, c4 = idx % PER_ROW;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n0 + row < n)
      val = *reinterpret_cast<const float4*>(src + (size_t)(n0 + row) * ld +
                                             4 * c4);
    *reinterpret_cast<float4*>(dst + row * LD + 4 * c4) = val;
  }
}

// acc[i][j] = row (ty + 16 i) of a . row (tx + 16 j) of b, over D
__device__ __forceinline__ void rows_dot(float (&acc)[4][4], const float* a,
                                         const float* b, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

// acc[i] += sum_n p[ty + 16 i][n] * m[n][4 tx .. 4 tx + 3], p and m [BT, LD]
__device__ __forceinline__ void rows_times(float4 (&acc)[4], const float* p,
                                           const float* m, int tx, int ty) {
#pragma unroll 2
  for (int n = 0; n < BT; n += 4) {
    float4 p4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p4[i] = *reinterpret_cast<const float4*>(p + (ty + 16 * i) * LD + n);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 mm =
          *reinterpret_cast<const float4*>(m + (n + e) * LD + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = e == 0 ? p4[i].x
                      : e == 1 ? p4[i].y
                      : e == 2 ? p4[i].z
                               : p4[i].w;
        acc[i].x = fmaf(w, mm.x, acc[i].x);
        acc[i].y = fmaf(w, mm.y, acc[i].y);
        acc[i].z = fmaf(w, mm.z, acc[i].z);
        acc[i].w = fmaf(w, mm.w, acc[i].w);
      }
    }
  }
}

// rows ty + 16 i (< n) of acc * mul into one head of a [B, N, ld] tensor
__device__ __forceinline__ void store_rows(float* dst, const float4 (&acc)[4],
                                           float mul, int n0, int n, int ld,
                                           int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = n0 + ty + 16 * i;
    if (r >= n) continue;
    *reinterpret_cast<float4*>(dst + (size_t)r * ld + 4 * tx) = make_float4(
        acc[i].x * mul, acc[i].y * mul, acc[i].z * mul, acc[i].w * mul);
  }
}

__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int H, int nq, int nk,
                        int ldq, int ldkv, int ld_stat, float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* gs = qs + TILE;
  float* ks = gs + TILE;
  float* vs = ks + TILE;
  float* dss = vs + TILE;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int m0 = blockIdx.x * BT;
  const size_t qoff = (size_t)b * nq * ldq + (size_t)h * D;
  const size_t koff = (size_t)b * nk * ldkv + (size_t)h * D;

  load_tile(qs, q + qoff, m0, nq, ldq, tid);
  load_tile(gs, dout + qoff, m0, nq, ldq, tid);
  float row_lse[4], row_delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t r = (size_t)bh * ld_stat + m0 + ty + 16 * i;
    row_lse[i] = lse[r];
    row_delta[i] = delta[r];
  }
  float4 acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int n0 = 0; n0 < nk; n0 += BT) {
    load_tile(ks, k + koff, n0, nk, ldkv, tid);
    load_tile(vs, v + koff, n0, nk, ldkv, tid);
    __syncthreads();
    float s[4][4], dp[4][4];
    rows_dot(s, qs, ks, tx, ty);
    rows_dot(dp, gs, vs, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p =
            n0 + c < nk ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        dss[(ty + 16 * i) * LD + c] = p * (dp[i][j] - row_delta[i]);
      }
    __syncthreads();
    rows_times(acc, dss, ks, tx, ty);
    __syncthreads();
  }
  store_rows(dq + qoff, acc, scale, m0, nq, ldq, tx, ty);
}

constexpr int DQ_SMEM = 5 * TILE * 4;

bool bad_args(int B, int H, int nq, int nk, int D_, int ldq, int ldkv,
              int ld_stat) {
  return B < 1 || H < 1 || nq < 1 || nk < 1 || B * H > 65535 || D_ != D ||
         ldq % 4 || ldkv % 4 || ld_stat < (nq + BT - 1) / BT * BT;
}

}  // namespace

extern "C" {

// q and dout are [B, nq, ldq], k and v [B, nk, ldkv] fp32, 16-byte aligned,
// with row strides a multiple of 4 elements; lse and delta [B*H, ld_stat]
// fp32 with ld_stat >= nq rounded up to 64, padded as bwd_stats pads them.
// dq is written in q's layout. The signature is that of flash_bwd_sm90.cu's
// bf16 dQ entry point. It returns cudaSuccess (0),
// cudaErrorInvalidValue for a head width other than 64 or a bad shape, or
// the error of the attribute call or the launch.
int mt_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int B, int H, int nq, int nk, int D_,
                        int ldq, int ldkv, int ld_stat, float scale,
                        void* stream) {
  if (bad_args(B, H, nq, nk, D_, ldq, ldkv, ld_stat))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_f32_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nq + BT - 1) / BT, B * H);
  flash_bwd_dq_f32_kernel<<<grid, THREADS, DQ_SMEM,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), H, nq, nk, ldq, ldkv, ld_stat, scale);
  return (int)cudaGetLastError();
}

const char* mt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
