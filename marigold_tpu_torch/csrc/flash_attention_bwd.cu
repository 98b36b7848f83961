// Flash-attention backward for the SD2 UNet self-attention on Hopper
// (64-wide heads), as two kernels with no atomics.
//
// Replaces the two backward Pallas kernels of the TPU package's
// marigold_tpu/ops/flash_attention.py:_flash_dt_bwd_pallas:
//   * _flash_bwd_dq_kernel  -> flash_bwd_dq_kernel: one block per
//     (q tile, batch*head), looping over K tiles, dQ accumulated in fp32;
//   * _flash_bwd_dkv_kernel -> flash_bwd_dkv_kernel: one block per
//     (k tile, batch*head), looping over q tiles, dK and dV accumulated in
//     fp32.
// Each output element is written by exactly one block, so the two kernels
// need no atomics and give the same bits on every run.
//
// Math per (batch, head), with s = Q K^T * scale and the forward's saved
// row logsumexp lse (the training forward in flash_attention.cu):
//   P  = exp(s - lse)              recomputed in fp32, never stored to HBM
//   dP = dO V^T                    fp32
//   dS = bf16(P * (dP - delta))    delta = rowsum(dO * O), fp32, computed
//                                  outside the kernels as a plain op
//   dQ = dS K * scale,  dK = dS^T Q * scale,  dV = bf16(P)^T dO
// with bf16 operands and fp32 accumulation, rounding dS and P to bf16 at the
// places the TPU kernels do. Key columns past nk get s = -1e30 (P = 0);
// query rows past nq load as zeros with lse = +1e30 (P = 0, dS = 0) and are
// not stored.
//
// Layout: q/k/v/dO and dQ/dK/dV are [B, N, ld] bf16 token-major tensors,
// head h at channels [h*64, (h+1)*64); lse and delta are [B*H, nq] fp32.
//
// What bounds it on the H100: five 64-deep products per tile pair (S, dP,
// then dQ in one kernel, dK and dV in the other; S and dP are computed in
// both), ~10*N*N*d FLOPs over ~10*N*d*2 bytes, far above the card's ~295
// FLOP/byte ridge: tensor-core bound. This first version uses warp-level
// wmma (bf16 in, fp32 accumulate) with every tile in shared memory and a
// __syncthreads between phases. The fp32 accumulators live in wmma
// fragments in registers (no rescaling is needed in the backward), four
// 16x16 tiles per warp and accumulator; the transposed products read P and
// dS from shared memory as col_major A fragments, so no transpose is
// materialised. Shared memory per block: 88.5 KB, set with
// cudaFuncSetAttribute before each launch. wgmma, TMA and double buffering
// are left to later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernels' NEG_INF
constexpr float kLsePad = 1e30f;   // the TPU wrapper's _LSE_PAD
constexpr int D = 64;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NWARPS = 4;
constexpr int NT = NWARPS * 32;
// Row pitches padded by 16 bytes so that consecutive rows start in
// different banks; every wmma tile pointer stays 32-byte aligned.
constexpr int LDH = D + 8;   // bf16 [rows, D] tiles: Q, dO, K, V
constexpr int LDS = BK + 4;  // fp32 [BQ, BK]: S, dP (and the epilogue)
constexpr int LDP = BK + 8;  // bf16 [BQ, BK]: P, dS
// Output tiles of a [64, 64] product: 16 of 16x16, four per warp.
constexpr int TILES = (64 / 16) * (64 / 16);
constexpr int PER_WARP = TILES / NWARPS;
static_assert(BQ == 64 && BK == 64 && D == 64, "tile loops assume 64");

struct Smem {
  static constexpr size_t q = 0;
  static constexpr size_t g = q + sizeof(bf16) * BQ * LDH;
  static constexpr size_t k = g + sizeof(bf16) * BQ * LDH;
  static constexpr size_t v = k + sizeof(bf16) * BK * LDH;
  static constexpr size_t s = v + sizeof(bf16) * BK * LDH;
  static constexpr size_t dp = s + sizeof(float) * BQ * LDS;
  static constexpr size_t p = dp + sizeof(float) * BQ * LDS;
  static constexpr size_t ds = p + sizeof(bf16) * BQ * LDP;
  static constexpr size_t lse = ds + sizeof(bf16) * BQ * LDP;
  static constexpr size_t delta = lse + sizeof(float) * BQ;
  static constexpr size_t bytes = delta + sizeof(float) * BQ;
};

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ARow;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> ACol;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> BRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> BCol;

struct Tiles {
  bf16 *q, *g, *k, *v, *p, *ds;
  float *s, *dp, *lse, *delta;
  __device__ explicit Tiles(unsigned char* smem)
      : q(reinterpret_cast<bf16*>(smem + Smem::q)),
        g(reinterpret_cast<bf16*>(smem + Smem::g)),
        k(reinterpret_cast<bf16*>(smem + Smem::k)),
        v(reinterpret_cast<bf16*>(smem + Smem::v)),
        p(reinterpret_cast<bf16*>(smem + Smem::p)),
        ds(reinterpret_cast<bf16*>(smem + Smem::ds)),
        s(reinterpret_cast<float*>(smem + Smem::s)),
        dp(reinterpret_cast<float*>(smem + Smem::dp)),
        lse(reinterpret_cast<float*>(smem + Smem::lse)),
        delta(reinterpret_cast<float*>(smem + Smem::delta)) {}
};

// Copies a [64, D] bf16 tile (16-byte chunks) into shared memory, zero
// filling rows at or past `valid`.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0,
                                          int valid, int ld_src) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < 64 * CH; i += NT) {
    const int r = i / CH;
    const int c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < valid)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld_src + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

// lse and delta of the q tile's rows; padded rows get lse = +1e30, delta 0.
__device__ __forceinline__ void load_rows(Tiles& t, const float* lse,
                                          const float* delta, int bh, int q0,
                                          int nq) {
  for (int i = threadIdx.x; i < BQ; i += NT) {
    const bool ok = q0 + i < nq;
    t.lse[i] = ok ? lse[(size_t)bh * nq + q0 + i] : kLsePad;
    t.delta[i] = ok ? delta[(size_t)bh * nq + q0 + i] : 0.f;
  }
}

// S = Q K^T and dP = dO V^T, both [BQ, BK] fp32, 32 fragment jobs over the
// warps; then P = exp(S * scale - lse) and dS = P * (dP - delta), both
// rounded to bf16. Columns k0 + c >= nk get P = 0. Ends synchronised.
__device__ __forceinline__ void probabilities(Tiles& t, int k0, int nk,
                                              float scale) {
  const int warp = threadIdx.x / 32;
  for (int f = warp; f < 2 * TILES; f += NWARPS) {
    const bool is_s = f < TILES;
    const int tile = is_s ? f : f - TILES;
    const int fr = tile / 4, fc = tile % 4;
    const bf16* a_src = is_s ? t.q : t.g;
    const bf16* b_src = is_s ? t.k : t.v;
    Acc acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      ARow a;
      BCol b;
      wmma::load_matrix_sync(a, a_src + fr * 16 * LDH + kk, LDH);
      wmma::load_matrix_sync(b, b_src + fc * 16 * LDH + kk, LDH);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync((is_s ? t.s : t.dp) + fr * 16 * LDS + fc * 16,
                            acc, LDS, wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BQ * BK; i += NT) {
    const int r = i / BK, c = i % BK;
    const float s = (k0 + c < nk) ? t.s[r * LDS + c] * scale : kNegInf;
    const float p = expf(s - t.lse[r]);
    t.p[r * LDP + c] = __float2bfloat16(p);
    t.ds[r * LDP + c] = __float2bfloat16(p * (t.dp[r * LDS + c] - t.delta[r]));
  }
  __syncthreads();
}

// Stores `acc` * mul (four tiles of this warp of a [64, 64] fp32 result)
// through the shared fp32 buffer `buf` and writes rows < valid as bf16.
__device__ __forceinline__ void store_out(Acc (&acc)[PER_WARP], float mul,
                                          float* buf, bf16* dst, int row0,
                                          int valid, int ld_dst) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < PER_WARP; ++j) {
    const int tile = warp + j * NWARPS;
    for (int e = 0; e < acc[j].num_elements; ++e) acc[j].x[e] *= mul;
    wmma::store_matrix_sync(buf + (tile / 4) * 16 * LDS + (tile % 4) * 16,
                            acc[j], LDS, wmma::mem_row_major);
  }
  __syncthreads();
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < 64 * CH; i += NT) {
    const int r = i / CH;
    const int c = (i % CH) * 8;
    if (row0 + r >= valid) continue;
    alignas(16) bf16 vals[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) vals[e] = __float2bfloat16(buf[r * LDS + c + e]);
    *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * ld_dst + c) =
        *reinterpret_cast<const uint4*>(vals);
  }
}

__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int H, int nq, int nk, int ldq, int ldkv, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  Tiles t(smem);
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const size_t qoff = (size_t)b * nq * ldq + h * D;
  const size_t koff = (size_t)b * nk * ldkv + h * D;

  load_tile(t.q, q + qoff, q0, nq, ldq);
  load_tile(t.g, g + qoff, q0, nq, ldq);
  load_rows(t, lse, delta, bh, q0, nq);
  Acc acc[PER_WARP];
#pragma unroll
  for (int j = 0; j < PER_WARP; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int k0 = 0; k0 < nk; k0 += BK) {
    load_tile(t.k, k + koff, k0, nk, ldkv);
    load_tile(t.v, v + koff, k0, nk, ldkv);
    __syncthreads();
    probabilities(t, k0, nk, scale);
    // dQ += dS K: A = dS [BQ, BK] row-major, B = K [BK, D] row-major.
#pragma unroll
    for (int j = 0; j < PER_WARP; ++j) {
      const int tile = warp + j * NWARPS;
      const int fr = tile / 4, fc = tile % 4;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        ARow a;
        BRow bm;
        wmma::load_matrix_sync(a, t.ds + fr * 16 * LDP + kk, LDP);
        wmma::load_matrix_sync(bm, t.k + kk * LDH + fc * 16, LDH);
        wmma::mma_sync(acc[j], a, bm, acc[j]);
      }
    }
    __syncthreads();
  }
  store_out(acc, scale, t.s, dq + qoff, q0, nq, ldq);
}

__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int nq, int nk, int ldq,
                     int ldkv, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  Tiles t(smem);
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BK;
  const int warp = threadIdx.x / 32;
  const size_t qoff = (size_t)b * nq * ldq + h * D;
  const size_t koff = (size_t)b * nk * ldkv + h * D;

  load_tile(t.k, k + koff, k0, nk, ldkv);
  load_tile(t.v, v + koff, k0, nk, ldkv);
  Acc dk_acc[PER_WARP], dv_acc[PER_WARP];
#pragma unroll
  for (int j = 0; j < PER_WARP; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.f);
    wmma::fill_fragment(dv_acc[j], 0.f);
  }

  for (int q0 = 0; q0 < nq; q0 += BQ) {
    load_tile(t.q, q + qoff, q0, nq, ldq);
    load_tile(t.g, g + qoff, q0, nq, ldq);
    load_rows(t, lse, delta, bh, q0, nq);
    __syncthreads();
    probabilities(t, k0, nk, scale);
    // dV += P^T dO and dK += dS^T Q: A = P^T (resp. dS^T) [BK, BQ], read as
    // the col-major view of the row-major [BQ, BK] tile; B = dO (resp. Q)
    // [BQ, D] row-major.
#pragma unroll
    for (int j = 0; j < PER_WARP; ++j) {
      const int tile = warp + j * NWARPS;
      const int fr = tile / 4, fc = tile % 4;
#pragma unroll
      for (int kk = 0; kk < BQ; kk += 16) {
        ACol a;
        BRow bm;
        wmma::load_matrix_sync(a, t.p + kk * LDP + fr * 16, LDP);
        wmma::load_matrix_sync(bm, t.g + kk * LDH + fc * 16, LDH);
        wmma::mma_sync(dv_acc[j], a, bm, dv_acc[j]);
        wmma::load_matrix_sync(a, t.ds + kk * LDP + fr * 16, LDP);
        wmma::load_matrix_sync(bm, t.q + kk * LDH + fc * 16, LDH);
        wmma::mma_sync(dk_acc[j], a, bm, dk_acc[j]);
      }
    }
    __syncthreads();
  }
  store_out(dv_acc, 1.f, t.dp, dv + koff, k0, nk, ldkv);
  store_out(dk_acc, scale, t.s, dk + koff, k0, nk, ldkv);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem::bytes);
}

}  // namespace

extern "C" {

// dQ of the attention backward. q/g/dq: [B, nq, ldq] bf16; k/v: [B, nk,
// ldkv] bf16; lse/delta: [B*H, nq] fp32. Returns cudaSuccess (0) or the
// error of the attribute call or the launch; head dims other than 64
// return cudaErrorInvalidValue.
int mt_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                              const void* g, const void* lse,
                              const void* delta, void* dq, int B, int H,
                              int nq, int nk, int D_, int ldq, int ldkv,
                              float scale, void* stream) {
  if (D_ != D) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(flash_bwd_dq_kernel);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nq + BQ - 1) / BQ, B * H);
  flash_bwd_dq_kernel<<<grid, NT, Smem::bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), H, nq, nk, ldq, ldkv, scale);
  return (int)cudaGetLastError();
}

// dK and dV of the attention backward; dk/dv: [B, nk, ldkv] bf16, the
// other arguments as for mt_flash_attention_bwd_dq.
int mt_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                               const void* g, const void* lse,
                               const void* delta, void* dk, void* dv, int B,
                               int H, int nq, int nk, int D_, int ldq,
                               int ldkv, float scale, void* stream) {
  if (D_ != D) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(flash_bwd_dkv_kernel);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nk + BK - 1) / BK, B * H);
  flash_bwd_dkv_kernel<<<grid, NT, Smem::bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, nq, nk, ldq, ldkv,
      scale);
  return (int)cudaGetLastError();
}

const char* mt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
