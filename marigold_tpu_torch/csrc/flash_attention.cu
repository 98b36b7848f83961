// Flash-attention forward for the SD2 UNet and VAE self-attention on Hopper:
// the C entry points of both forward kernels and the 512-wide one.
//
// Replaces the forward variants of the TPU package's
// marigold_tpu/ops/flash_attention.py:_flash_dt_impl and
// _flash_dt_impl_lse. 64-wide heads (the UNet's, every softmax mode and the
// training forward with the logsumexp) go to the Hopper kernel of
// flash_fwd_sm90.cu (wgmma, TMA, register-resident softmax). This file keeps
// the first design for the 512-wide VAE mid head:
//   * _flash_kernel_dt_shifted_kblocked (shifted softmax, K streamed)
//   * _flash_kernel_dt                  (exact online softmax)
// It computes what they compute, not their tiling: K/V stream through
// shared memory.
//
// Math per (batch, head, query row r), with s_j = (q_r . k_j) / sqrt(d):
//   shifted: p_j = exp(min(s_j - shift_r, 75)), shift_r given by the caller
//            (max over a strided K subsample + 40, computed outside);
//   online:  running max m, p_j = exp(s_j - m), acc and l rescaled by
//            exp(m_old - m_new) whenever the max grows;
//   out_r = (sum_j bf16(p_j) v_j) / max(sum_j p_j, 1e-30), in fp32, stored bf16.
// Key columns j >= nk get s_j = -1e30 (p_j = 0); query rows r >= nq are read
// as zeros and not stored. There is no padding copy.
//
// Layout: q/k/v/o are [B, N, ld] bf16 token-major tensors, head h occupying
// channels [h*D, (h+1)*D) -- the [B, N, C] activations the callers hold.
//
// What bounds it on the H100: at N = 9216, d = 512 attention does ~4*N*N*d
// FLOPs over ~4*N*d*2 bytes, about N/2 FLOP/byte, far above the card's ~295
// FLOP/byte ridge: it is tensor-core bound. This first design uses
// warp-level wmma (bf16 in, fp32 accumulate) with all tiles in shared memory
// and one __syncthreads between the QK^T, softmax and PV phases.
//
// Accumulator placement: the fp32 output tile lives in dynamic shared memory,
// not in registers. For d = 512 a [32, 512] fp32 tile is 64 KB, which no
// register file holds; keeping it in shared memory also lets the online mode
// rescale rows by alpha, which wmma's opaque fragment layout does not allow.
// Per-block shared memory (BQ = BK = 32) ~173 KB, under the 227 KB limit,
// set with cudaFuncSetAttribute(MaxDynamicSharedMemorySize) before each
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernels' NEG_INF
constexpr float kClamp = 75.0f;    // exp clamp of the shifted softmax

template <int D, int BQ, int BK>
struct Smem {
  // Row pitches padded by 16 bytes (bf16) or 16 bytes (fp32) so that
  // consecutive rows start in different banks; every wmma tile pointer
  // stays 32-byte aligned.
  static constexpr int LDH = D + 8;   // bf16 Q/K/V tiles
  static constexpr int LDS = BK + 4;  // fp32 logits
  static constexpr int LDP = BK + 8;  // bf16 probabilities
  static constexpr int LDO = D + 4;   // fp32 output accumulator
  static constexpr size_t q = 0;
  static constexpr size_t k = q + sizeof(bf16) * BQ * LDH;
  static constexpr size_t v = k + sizeof(bf16) * BK * LDH;
  static constexpr size_t s = v + sizeof(bf16) * BK * LDH;
  static constexpr size_t p = s + sizeof(float) * BQ * LDS;
  static constexpr size_t o = p + sizeof(bf16) * BQ * LDP;
  static constexpr size_t m = o + sizeof(float) * BQ * LDO;
  static constexpr size_t l = m + sizeof(float) * BQ;
  static constexpr size_t bytes = l + sizeof(float) * BQ;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Copies a [rows, D] bf16 tile (16-byte chunks) into shared memory, zero
// filling rows at or past `valid`.
template <int D, int LD, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int rows, int row0, int valid,
                                          int ld_src) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < rows * CH; i += NT) {
    const int r = i / CH;
    const int c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < valid)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld_src + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int D, int BQ, int BK, int NWARPS, bool ONLINE>
__global__ void __launch_bounds__(NWARPS * 32)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ shift,
                 bf16* __restrict__ o, int H, int nq, int nk, int ldq,
                 int ldkv, int ldo, float scale) {
  using L = Smem<D, BQ, BK>;
  constexpr int NT = NWARPS * 32;
  static_assert(BQ % 16 == 0 && BK % 32 == 0 && D % 16 == 0, "tile shape");

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::v);
  float* ss = reinterpret_cast<float*>(smem + L::s);
  bf16* ps = reinterpret_cast<bf16*>(smem + L::p);
  float* os = reinterpret_cast<float*>(smem + L::o);
  float* ms = reinterpret_cast<float*>(smem + L::m);
  float* ls = reinterpret_cast<float*>(smem + L::l);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const bf16* qg = q + (size_t)b * nq * ldq + h * D;
  const bf16* kg = k + (size_t)b * nk * ldkv + h * D;
  const bf16* vg = v + (size_t)b * nk * ldkv + h * D;
  bf16* og = o + (size_t)b * nq * ldo + h * D;

  load_tile<D, L::LDH, NT>(qs, qg, BQ, q0, nq, ldq);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += NT) os[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += NT) {
    ms[i] = kNegInf;
    ls[i] = 0.f;
  }
  __syncthreads();

  for (int k0 = 0; k0 < nk; k0 += BK) {
    load_tile<D, L::LDH, NT>(ks, kg, BK, k0, nk, ldkv);
    load_tile<D, L::LDH, NT>(vs, vg, BK, k0, nk, ldkv);
    __syncthreads();

    // S = Q K^T: [BQ, BK] in 16x16 fragments spread over the warps.
    constexpr int SC = BK / 16;
    for (int f = warp; f < (BQ / 16) * SC; f += NWARPS) {
      const int fr = f / SC, fc = f % SC;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll 4
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, qs + fr * 16 * L::LDH + kk, L::LDH);
        wmma::load_matrix_sync(bt, ks + fc * 16 * L::LDH + kk, L::LDH);
        wmma::mma_sync(acc, a, bt, acc);
      }
      wmma::store_matrix_sync(ss + fr * 16 * L::LDS + fc * 16, acc, L::LDS,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // Softmax numerators, one warp per row.
    for (int r = warp; r < BQ; r += NWARPS) {
      float sv[BK / 32];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const int c = lane + j * 32;
        const float s = ss[r * L::LDS + c] * scale;
        sv[j] = (k0 + c < nk) ? s : kNegInf;
        mx = fmaxf(mx, sv[j]);
      }
      float ref, alpha = 1.f;
      if (ONLINE) {
        const float m_old = ms[r];
        ref = fmaxf(m_old, warp_max(mx));
        alpha = expf(m_old - ref);
      } else {
        ref = (q0 + r < nq) ? shift[(size_t)bh * nq + q0 + r] : 0.f;
      }
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const float d = sv[j] - ref;
        const float p = ONLINE ? expf(d) : expf(fminf(d, kClamp));
        sum += p;
        ps[r * L::LDP + lane + j * 32] = __float2bfloat16(p);
      }
      sum = warp_sum(sum);
      if (ONLINE) {
        for (int c = lane; c < D; c += 32) os[r * L::LDO + c] *= alpha;
      }
      if (lane == 0) {
        ls[r] = ls[r] * alpha + sum;
        if (ONLINE) ms[r] = ref;
      }
    }
    __syncthreads();

    // O += P V: [BQ, D] fragments, accumulated through shared memory.
    constexpr int OC = D / 16;
    for (int f = warp; f < (BQ / 16) * OC; f += NWARPS) {
      const int fr = f / OC, fc = f % OC;
      float* optr = os + fr * 16 * L::LDO + fc * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, optr, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, ps + fr * 16 * L::LDP + kk, L::LDP);
        wmma::load_matrix_sync(bv, vs + kk * L::LDH + fc * 16, L::LDH);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(optr, acc, L::LDO, wmma::mem_row_major);
    }
    __syncthreads();
  }

  // out = acc / max(l, 1e-30), 8 bf16 per 16-byte store.
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < BQ * CH; i += NT) {
    const int r = i / CH;
    const int c = (i % CH) * 8;
    if (q0 + r >= nq) continue;
    const float l = fmaxf(ls[r], 1e-30f);
    alignas(16) bf16 vals[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      vals[e] = __float2bfloat16(os[r * L::LDO + c + e] / l);
    *reinterpret_cast<uint4*>(og + (size_t)(q0 + r) * ldo + c) =
        *reinterpret_cast<const uint4*>(vals);
  }
}

template <int D, int BQ, int BK, int NWARPS, bool ONLINE>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* shift, void* o, int B, int H, int nq, int nk,
                   int ldq, int ldkv, int ldo, float scale,
                   cudaStream_t stream) {
  using L = Smem<D, BQ, BK>;
  auto kernel = flash_fwd_kernel<D, BQ, BK, NWARPS, ONLINE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + BQ - 1) / BQ, B * H);
  kernel<<<grid, NWARPS * 32, L::bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), shift, static_cast<bf16*>(o), H, nq, nk,
      ldq, ldkv, ldo, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// flash_fwd_sm90.cu: the 64-wide Hopper kernel.
int mt_flash_fwd_sm90(const void* q, const void* k, const void* v,
                      const void* shift, void* o, void* lse, int B, int H,
                      int nq, int nk, int ldq, int ldkv, int ldo, float scale,
                      int online, void* stream);

// Returns cudaSuccess (0) or the error of the attribute call or the launch.
// `shift` is [B*H, nq] fp32 in shifted mode and ignored in online mode.
// Head dims 64 (flash_fwd_sm90.cu) and 512 (here) are instantiated; any
// other returns cudaErrorInvalidValue.
int mt_flash_attention_fwd(const void* q, const void* k, const void* v,
                           const void* shift, void* o, int B, int H, int nq,
                           int nk, int D, int ldq, int ldkv, int ldo,
                           float scale, int online, void* stream) {
  if (D == 64)
    return mt_flash_fwd_sm90(q, k, v, shift, o, nullptr, B, H, nq, nk, ldq,
                             ldkv, ldo, scale, online, stream);
  const float* sh = static_cast<const float*>(shift);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 512) {
    return online ? launch<512, 32, 32, 8, true>(q, k, v, sh, o, B, H, nq,
                                                 nk, ldq, ldkv, ldo, scale, st)
                  : launch<512, 32, 32, 8, false>(q, k, v, sh, o, B, H, nq,
                                                  nk, ldq, ldkv, ldo, scale,
                                                  st);
  }
  return (int)cudaErrorInvalidValue;
}

// The training forward: exact online softmax, output plus the row
// logsumexp `lse` ([B*H, nq] fp32), by the 64-wide Hopper kernel. Any other
// head dim returns cudaErrorInvalidValue.
int mt_flash_attention_fwd_lse(const void* q, const void* k, const void* v,
                               void* o, void* lse, int B, int H, int nq,
                               int nk, int D, int ldq, int ldkv, int ldo,
                               float scale, void* stream) {
  if (D != 64) return (int)cudaErrorInvalidValue;
  return mt_flash_fwd_sm90(q, k, v, nullptr, o, lse, B, H, nq, nk, ldq, ldkv,
                           ldo, scale, 1, stream);
}

const char* mt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
