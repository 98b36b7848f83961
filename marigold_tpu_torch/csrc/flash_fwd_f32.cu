// Flash-attention forward in fp32 storage for 64-wide heads, for
// `--full_precision` and fp32 training: CUDA-core FFMA tiles in shared
// memory with fp32 online-softmax state.
//
// Replaces the fp32 d = 64 instantiations of the TPU package's
// marigold_tpu/ops/flash_attention.py kernels, which take fp32 storage and
// feed the MXU in it ("MXU inputs in the storage dtype", :43-45):
//   * _flash_kernel_dt_shifted          (shifted softmax, d = 64; :396)
//   * _flash_kernel_dt                  (exact online softmax; :460)
//   * _flash_kernel                     (the folded [BH, N, D] entry; :522),
//     run as the online variant with one head per batch row;
//   * _flash_kernel_dt_lse              (the training forward, d = 64; :638):
//     the online variant that also writes the row logsumexp.
// The 512-wide fp32 forward (:429, and :460 and :522 at d = 512) is
// flash_fwd_d512_f32_sm90.cu: 3xTF32 on wgmma (tf32x3.cuh), which carries
// fp32 inputs to ~2^-21 per product where one TF32 product keeps ~2^-11.
// The bf16 forwards are flash_fwd_sm90.cu and flash_fwd_d512_sm90.cu.
//
// Math per (batch, head, query row r), all fp32, as the plain version
// (ops/flash_attention.py:_plain_forward) computes it:
//   s_j = (q_r . k_j) * scale;
//   shifted: p_j = exp(min(s_j - shift_r, 75)), shift_r from the caller;
//   online:  running max m, p_j = exp(s_j - m), O and l rescaled by
//            exp(m_old - m_new) when the max grows;
//   out_r = (sum_j p_j v_j) / max(sum_j p_j, 1e-30), P meeting V in fp32.
// Key columns j >= nk get p_j = 0; query rows r >= nq are not stored.
// The training entry also writes lse_r = m + log(max(sum_j p_j, 1e-30)),
// [B*H, nq] fp32, the statistic the backward (flash_bwd_f32.cu) reads.
//
// Layout: q/k/v/o are [B, N, ld] fp32, head h at channels [64 h, 64 h + 64).
// One block of 256 threads (16 x 16) takes BM = 64 query rows of one (b, h)
// and walks the keys in tiles of BN = 64 rows: Q, K, V and P tiles of 17 KB
// each in shared memory (68 KB), each thread holding a 4 x 4 block of S
// (rows ty + 16 i, columns tx + 16 j) and a 4 x 4 block of O (the same
// rows, columns 4 tx + e). The row max and sum are reductions over the 16
// lanes of a half-warp (xor shuffles 8, 4, 2, 1). Q and K rows are padded
// by 4 floats: a half-warp's float4 reads of K rows tx + 16 j then fall on
// distinct banks in each 8-lane phase, and Q reads are broadcasts. V rows
// are read as float4 across 16 consecutive lanes.
//
// What bounds it on the H100: 4 N^2 D FLOPs per head over ~4 N D * 4 bytes,
// about N/4 FLOP per byte, far above the ridge of the 67 TFLOP/s fp32
// CUDA-core peak: it is bound by FFMA issue and by the shared-memory reads
// that feed it (8 FFMA per 16-byte read in both products). The design
// keeps every product in registers from float4 shared-memory reads and is
// simple: one tile in flight, no copy overlapped with the products. The
// tensor-core design (3xTF32 on wgmma, as the d = 512 forward has it) is
// ROADMAP work for these d = 64 forwards.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int THREADS = 256;
constexpr float EXP_CLAMP = 75.0f;
constexpr int D = 64;   // head width
constexpr int BM = 64;  // query rows per block
constexpr int BN = 64;  // keys per tile
constexpr int SMEM =
    (BM * (D + 4) + BN * (D + 4) + BN * D + BM * (BN + 4)) * 4;

// rows [n0, n0 + ROWS) of one head (channels [col, col + D)) of a [B, N, ld]
// tensor into dst with row stride LDS floats; rows past n are zero
template <int ROWS, int LDS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int n0, int n, int ld, int tid) {
  constexpr int PER_ROW = D / 4;
  for (int idx = tid; idx < ROWS * PER_ROW; idx += THREADS) {
    const int row = idx / PER_ROW, c4 = idx % PER_ROW;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n0 + row < n)
      val = *reinterpret_cast<const float4*>(src + (size_t)(n0 + row) * ld +
                                             4 * c4);
    *reinterpret_cast<float4*>(dst + row * LDS + 4 * c4) = val;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <bool ONLINE>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ shift, float* __restrict__ o,
                     float* __restrict__ lse, int H, int nq, int nk, int ldq,
                     int ldkv, int ldo, float scale) {
  constexpr int RM = BM / 16, CN = BN / 16, DV = D / 64;
  constexpr int LQ = D + 4, LP = BN + 4;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + BM * LQ;
  float* vs = ks + BN * LQ;
  float* ps = vs + BN * D;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int m0 = blockIdx.x * BM;
  const float* qb = q + (size_t)b * nq * ldq + (size_t)h * D;
  const float* kb = k + (size_t)b * nk * ldkv + (size_t)h * D;
  const float* vb = v + (size_t)b * nk * ldkv + (size_t)h * D;

  load_rows<BM, LQ>(qs, qb, m0, nq, ldq, tid);

  float row_shift[RM], m[RM], l[RM];
  float4 acc[RM][DV];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = m0 + ty + 16 * i;
    row_shift[i] = (!ONLINE && r < nq) ? shift[(size_t)bh * nq + r] : 0.f;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < DV; ++g) acc[i][g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int n0 = 0; n0 < nk; n0 += BN) {
    load_rows<BN, LQ>(ks, kb, n0, nk, ldkv, tid);
    load_rows<BN, D>(vs, vb, n0, nk, ldkv, tid);
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[RM], c[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * LQ + d);
#pragma unroll
      for (int j = 0; j < CN; ++j)
        c[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LQ + d);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float corr = 1.f, m_new = 0.f;
      if (ONLINE) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < CN; ++j)
          if (n0 + tx + 16 * j < nk) mx = fmaxf(mx, s[i][j] * scale);
        m_new = fmaxf(m[i], half_warp_max(mx));
        corr = expf(m[i] - m_new);  // 0 on the first tile (m = -inf)
        m[i] = m_new;
      }
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float sj = s[i][j] * scale;
        float p = ONLINE ? expf(sj - m_new)
                         : expf(fminf(sj - row_shift[i], EXP_CLAMP));
        if (n0 + tx + 16 * j >= nk) p = 0.f;
        rs += p;
        ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
      }
      // l stays a per-thread partial sum over this thread's columns; the
      // rescale is uniform along a row, so it applies to each partial
      l[i] = l[i] * corr + rs;
      if (ONLINE) {
#pragma unroll
        for (int g = 0; g < DV; ++g) {
          acc[i][g].x *= corr;
          acc[i][g].y *= corr;
          acc[i][g].z *= corr;
          acc[i][g].w *= corr;
        }
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int n = 0; n < BN; n += 4) {
      float4 p4[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        p4[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * LP + n);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int g = 0; g < DV; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(
              vs + (n + e) * D + 4 * tx + 64 * g);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float p = e == 0 ? p4[i].x
                          : e == 1 ? p4[i].y
                          : e == 2 ? p4[i].z
                                   : p4[i].w;
            acc[i][g].x = fmaf(p, vv.x, acc[i][g].x);
            acc[i][g].y = fmaf(p, vv.y, acc[i][g].y);
            acc[i][g].z = fmaf(p, vv.z, acc[i][g].z);
            acc[i][g].w = fmaf(p, vv.w, acc[i][g].w);
          }
        }
      }
    }
    __syncthreads();
  }

  float* ob = o + (size_t)b * nq * ldo + (size_t)h * D;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const float l_sum = fmaxf(half_warp_sum(l[i]), 1e-30f);
    const float inv = 1.f / l_sum;
    const int r = m0 + ty + 16 * i;
    if (r >= nq) continue;
    if (ONLINE && lse != nullptr && tx == 0)
      lse[(size_t)bh * nq + r] = m[i] + logf(l_sum);
#pragma unroll
    for (int g = 0; g < DV; ++g) {
      float4 out = acc[i][g];
      out.x *= inv;
      out.y *= inv;
      out.z *= inv;
      out.w *= inv;
      *reinterpret_cast<float4*>(ob + (size_t)r * ldo + 4 * tx + 64 * g) = out;
    }
  }
}

template <bool ONLINE>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* shift, float* o, float* lse, int B, int H,
                   int nq, int nk, int ldq, int ldkv, int ldo, float scale,
                   cudaStream_t stream) {
  auto kernel = flash_fwd_f32_kernel<ONLINE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + BM - 1) / BM, B * H);
  kernel<<<grid, THREADS, SMEM, stream>>>(q, k, v, shift, o, lse, H, nq, nk,
                                          ldq, ldkv, ldo, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q and o are [B, nq, ldq/ldo], k and v [B, nk, ldkv] fp32, 16-byte
// aligned, with row strides a multiple of 4 elements; head h of width D at
// channel D*h. `shift` is [B*H, nq] fp32 in shifted mode and ignored in
// online mode. Returns cudaSuccess (0), cudaErrorInvalidValue for a head
// width other than 64 (512 is mt_flash_fwd_d512_f32's, in
// flash_fwd_d512_f32_sm90.cu) or a bad shape, or the error of the attribute
// call or the launch.
int mt_flash_fwd_f32(const void* q, const void* k, const void* v,
                     const void* shift, void* o, int B, int H, int nq, int nk,
                     int D_, int ldq, int ldkv, int ldo, float scale,
                     int online, void* stream) {
  if (B < 1 || H < 1 || nq < 1 || nk < 1 || B * H > 65535 || D_ != D ||
      ldq % 4 || ldkv % 4 || ldo % 4 || (!online && shift == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* sh = static_cast<const float*>(shift);
  float* of = static_cast<float*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return online ? (int)launch<true>(qf, kf, vf, sh, of, nullptr, B, H, nq, nk,
                                    ldq, ldkv, ldo, scale, st)
                : (int)launch<false>(qf, kf, vf, sh, of, nullptr, B, H, nq,
                                     nk, ldq, ldkv, ldo, scale, st);
}

// The training forward: the online variant at D = 64 that also writes
// lse [B*H, nq] fp32. Arguments and preconditions as mt_flash_fwd_f32's
// (the signature of flash_attention.cu's bf16 mt_flash_attention_fwd_lse).
int mt_flash_fwd_lse_f32(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int H, int nq, int nk, int D_,
                         int ldq, int ldkv, int ldo, float scale,
                         void* stream) {
  if (B < 1 || H < 1 || nq < 1 || nk < 1 || B * H > 65535 || ldq % 4 ||
      ldkv % 4 || ldo % 4 || D_ != D || lse == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)launch<true>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), nullptr, static_cast<float*>(o),
      static_cast<float*>(lse), B, H, nq, nk, ldq, ldkv, ldo, scale,
      static_cast<cudaStream_t>(stream));
}

const char* mt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
