// Flash-attention forward for 64-wide heads, designed for Hopper (sm_90a):
// wgmma tensor-core products, TMA loads into a ring of shared-memory stages
// tracked by mbarriers, a producer warp and two consumer warpgroups, and the
// logits, probabilities and output accumulator held in registers.
//
// Replaces the 64-wide instantiations of the TPU package's
// marigold_tpu/ops/flash_attention.py kernels:
//   * _flash_kernel_dt_shifted  (shifted softmax; pallas_call at :396)
//   * _flash_kernel_dt          (exact online softmax; :460)
//   * _flash_kernel_dt_lse      (online softmax + row logsumexp; :638)
//   * _flash_kernel             (the folded [BH, N, D] entry; :522), which the
//     wrapper runs as the online variant with one head per batch row.
// The 512-wide VAE head has its own kernel, flash_fwd_d512_sm90.cu.
//
// Math per (batch, head, query row r), s_j = (q_r . k_j) * scale, fp32:
//   shifted: p_j = exp(min(s_j - shift_r, 75)), shift_r from the caller;
//   online:  running max m, p_j = exp(s_j - m), O and l rescaled by
//            exp(m_old - m_new) when the max grows;
//   out_r = (sum_j bf16(p_j) v_j) / max(sum_j p_j, 1e-30), stored bf16;
//   lse_r = m + log(max(l, 1e-30)) in natural-log units (LSE variant).
// Every exponential is exp2: the logits are multiplied by scale * log2(e),
// and the shift, the clamp and the running max live in the same base-2
// units; the lse is converted back to natural log. Key columns j >= nk get
// s_j = -1e30; query rows r >= nq are computed on TMA's zero fill and not
// stored.
//
// Layout: q/k/v/o are [B, N, ld] bf16, head h at channels [64h, 64h + 64).
// Each tensor has a 3-D TMA map {ld, N, B} with a {64, rows, 1} box at
// channel coordinate 64h and 128-byte swizzle: one 64-wide bf16 row is
// exactly 128 bytes. Because N is a dimension of the map, TMA zero-fills
// rows past nq or nk inside each batch instead of reading the next batch,
// and the output store drops rows past nq. No padding copy.
//
// What bounds it on the H100: ~4*N*N*64 FLOPs over ~4*N*64*2 bytes per
// head, about N/2 FLOP per byte (4608 at N = 9216), far above the card's
// ~295 FLOP/byte ridge: tensor-core bound. At d = 64 the softmax is as
// large as the products (one exp2 per 256 FLOPs of wgmma, and the SFU
// issues exp2 at about the rate the tensor cores finish those FLOPs). The
// design therefore keeps the tensor cores fed from registers and overlaps
// the two kinds of work:
//   * wgmma m64n128k16 for S = Q K^T (Q, K K-major in shared memory) and
//     m64n64k16 for O += P V with P taken from registers (the fp32 S
//     fragment converts in place to the bf16 A fragment) and V read
//     MN-major (transpose bit set);
//   * S, P and O never touch shared memory: the row max is a reduction over
//     the 4 threads that share a row of the accumulator (two shuffles), the
//     rescale of O runs on its registers;
//   * one producer thread keeps KV_STAGES K/V tiles in flight with TMA; the
//     consumers wait on "full" barriers and release "empty" ones, with no
//     block-wide barrier in the K loop;
//   * two consumer warpgroups of 64 query rows (BQ = 128) work on the same
//     K/V tiles, so one warpgroup's softmax overlaps the other's products,
//     and each warpgroup issues the next tile's QK^T before it waits on the
//     current PV;
//   * setmaxnreg moves registers from the producer warpgroup (24) to the
//     consumers (240): one block per SM, 384 threads.

#include "sm90.cuh"

namespace {

constexpr int D = 64;             // head width
constexpr int BQ = 128;           // query rows per block (2 x 64)
constexpr int BK = 128;           // keys per K/V tile
constexpr int KV_STAGES = 2;      // K/V tiles in flight
constexpr int CONSUMERS = 2;      // consumer warpgroups
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int ROW_BYTES = D * 2;  // 128: one swizzle row
constexpr int Q_BYTES = BQ * ROW_BYTES;
constexpr int KV_BYTES = BK * ROW_BYTES;

// Shared memory: Q (reused to stage the output), then K and V per stage,
// then the barriers; every tile 1024-byte aligned (the 128B swizzle atom).
constexpr int SM_Q = 0;
constexpr int SM_K = Q_BYTES;
constexpr int SM_V = SM_K + KV_STAGES * KV_BYTES;
constexpr int SM_BAR = SM_V + KV_STAGES * KV_BYTES;
constexpr int SM_BYTES = SM_BAR + 8 * (2 * KV_STAGES + 1);
constexpr int SMEM_REQUEST = SM_BYTES + 1024;  // room to align the base

constexpr float kNegInf = -1e30f;                 // the TPU kernels' NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kClamp2 = 75.0f * 1.4426950408889634f;  // exp clamp, base 2

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Accumulator layout of wgmma m64nN (per warpgroup thread t, warp w = t/32,
// lane l): d[4j + e] is row 16w + l/4, column 8j + 2(l%4) + e, and
// d[4j + 2 + e] the same columns of row 16w + l/4 + 8 (e in {0, 1}). The A
// fragment of a k16 step kk takes columns 16kk..16kk+15 in the same rows, so
// the bf16 pair (d[2i], d[2i+1]) is A register i: P needs no shuffle.
template <bool ONLINE, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_o,
                      const float* __restrict__ shift,
                      float* __restrict__ lse, int H, int nq, int nk,
                      float scale_log2) {
  static_assert(ONLINE || !LSE, "the logsumexp needs the running max");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_full = base + SM_BAR;                 // [KV_STAGES]
  const uint32_t bar_empty = bar_full + 8 * KV_STAGES;     // [KV_STAGES]
  const uint32_t bar_q = bar_empty + 8 * KV_STAGES;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int n_tiles = (nk + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer warpgroup: one thread issues every TMA load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, Q_BYTES);
      tma_load(base + SM_Q, &tm_q, h * D, q0, b, bar_q);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % KV_STAGES;
        if (it >= KV_STAGES)
          mbar_wait(bar_empty + 8 * st, ((it / KV_STAGES) - 1) & 1);
        mbar_expect_tx(bar_full + 8 * st, 2 * KV_BYTES);
        tma_load(base + SM_K + st * KV_BYTES, &tm_k, h * D, it * BK, b,
                 bar_full + 8 * st);
        tma_load(base + SM_V + st * KV_BYTES, &tm_v, h * D, it * BK, b,
                 bar_full + 8 * st);
      }
    }
    return;
  }

  // Consumer warpgroup c owns query rows [64c, 64c + 64) of the block.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;  // this thread's rows: r0, r0 + 8
  const int col = 2 * (lane % 4);           // its column pair in each 8
  const int row0 = q0 + 64 * c + r0;        // global query rows
  const int row1 = row0 + 8;
  const uint32_t q_tile = base + SM_Q + c * 64 * ROW_BYTES;

  float sh0 = 0.f, sh1 = 0.f;  // shifted mode: the row shift, base 2
  if (!ONLINE) {
    if (row0 < nq) sh0 = shift[(size_t)bh * nq + row0] * kLog2e;
    if (row1 < nq) sh1 = shift[(size_t)bh * nq + row1] * kLog2e;
  }
  float m0 = kNegInf, m1 = kNegInf;  // running max (online), base 2
  float l0 = 0.f, l1 = 0.f;          // this thread's part of the row sums
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float s[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  uint32_t p[32];

  auto issue_qk = [&](int st) {
    const uint32_t k_tile = base + SM_K + st * KV_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n128k16_ss(s, kmajor_desc(q_tile + 32 * kk),
                          kmajor_desc(k_tile + 32 * kk), kk);
    wgmma_commit();
  };

  mbar_wait(bar_q, 0);
  mbar_wait(bar_full, 0);
  issue_qk(0);
  wgmma_wait<0>();
  fence_regs(s);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % KV_STAGES;
    const int k0 = it * BK;
    if (k0 + BK > nk) {  // the ragged last tile: mask key columns >= nk
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (k0 + 8 * j + col + e >= nk) {
            s[4 * j + e] = kNegInf;
            s[4 * j + 2 + e] = kNegInf;
          }
        }
      }
    }
    float ref0, ref1;
    if (ONLINE) {
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      ref0 = fmaxf(m0, quad_max(mx0) * scale_log2);
      ref1 = fmaxf(m1, quad_max(mx1) * scale_log2);
      const float a0 = ex2(m0 - ref0), a1 = ex2(m1 - ref1);
      m0 = ref0;
      m1 = ref1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }
    } else {
      ref0 = sh0;
      ref1 = sh1;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = fmaf(s[4 * j + e], scale_log2, -ref0);
        float x1 = fmaf(s[4 * j + 2 + e], scale_log2, -ref1);
        if (!ONLINE) {
          x0 = fminf(x0, kClamp2);
          x1 = fminf(x1, kClamp2);
        }
        s[4 * j + e] = ex2(x0);
        s[4 * j + 2 + e] = ex2(x1);
        l0 += s[4 * j + e];
        l1 += s[4 * j + 2 + e];
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);

    // O += P V on this stage's V, then (while it runs) the next QK^T.
    const uint32_t v_tile = base + SM_V + st * KV_BYTES;
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n64k16_rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                         p[4 * kk + 3], mnmajor_desc(v_tile + 2048 * kk));
    wgmma_commit();
    if (it + 1 < n_tiles) {
      const int nst = (it + 1) % KV_STAGES;
      mbar_wait(bar_full + 8 * nst, ((it + 1) / KV_STAGES) & 1);
      issue_qk(nst);
      wgmma_wait<1>();  // P V of this tile is done; QK^T may still run
    } else {
      wgmma_wait<0>();
    }
    if (t == 0) mbar_arrive(bar_empty + 8 * st);  // release K/V stage st
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(o);
    fence_regs(p);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (LSE && lane % 4 == 0) {
    if (row0 < nq) lse[(size_t)bh * nq + row0] = m0 * kLn2 + logf(fmaxf(l0, 1e-30f));
    if (row1 < nq) lse[(size_t)bh * nq + row1] = m1 * kLn2 + logf(fmaxf(l1, 1e-30f));
  }

  // Stage the bf16 output in this warpgroup's Q rows (its last QK^T has
  // completed), in the swizzled layout the O map expects, then one TMA
  // store; rows past nq are dropped by the store.
  unsigned char* q_gen = smem_raw + (q_tile - smem_u32(smem_raw));
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const uint32_t chunk = static_cast<uint32_t>(j ^ (r0 & 7)) << 4;
    const uint32_t off = chunk + 2 * col;
    *reinterpret_cast<uint32_t*>(q_gen + r0 * ROW_BYTES + off) =
        pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    *reinterpret_cast<uint32_t*>(q_gen + (r0 + 8) * ROW_BYTES + off) =
        pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
  if (t == 0 && q0 + 64 * c < nq) tma_store(&tm_o, q_tile, h * D, q0 + 64 * c, b);
}

// A map of a [B, N, ld] bf16 tensor with a {64, rows, 1} box.
bool encode(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, int B, int N,
            int ld, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)ld, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)N * ld * 2};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool ONLINE, bool LSE>
cudaError_t launch(const CUtensorMap* maps, const float* shift, float* lse,
                   int B, int H, int nq, int nk, float scale,
                   cudaStream_t stream) {
  auto kernel = flash_fwd_sm90_kernel<ONLINE, LSE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_REQUEST);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + BQ - 1) / BQ, B * H);
  kernel<<<grid, THREADS, SMEM_REQUEST, stream>>>(
      maps[0], maps[1], maps[2], maps[3], shift, lse, H, nq, nk,
      scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The 64-wide forward, called by mt_flash_attention_fwd and
// mt_flash_attention_fwd_lse (flash_attention.cu) for D == 64. q and o are
// [B, nq, ldq/ldo], k and v [B, nk, ldkv] bf16, 16-byte aligned, with row
// strides a multiple of 8 elements (TMA's 16-byte rule); `shift` is
// [B*H, nq] fp32 in shifted mode, `lse` [B*H, nq] fp32 or null. Returns
// cudaSuccess or the error of the map encoding, the attribute call or the
// launch.
int mt_flash_fwd_sm90(const void* q, const void* k, const void* v,
                      const void* shift, void* o, void* lse, int B, int H,
                      int nq, int nk, int ldq, int ldkv, int ldo, float scale,
                      int online, void* stream) {
  if (B < 1 || H < 1 || nq < 1 || nk < 1 || ldq % 8 || ldkv % 8 || ldo % 8 ||
      (!online && shift == nullptr) || (lse != nullptr && !online))
    return (int)cudaErrorInvalidValue;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap maps[4];
  if (!encode(fn, &maps[0], q, B, nq, ldq, BQ) ||
      !encode(fn, &maps[1], k, B, nk, ldkv, BK) ||
      !encode(fn, &maps[2], v, B, nk, ldkv, BK) ||
      !encode(fn, &maps[3], o, B, nq, ldo, 64))
    return (int)cudaErrorInvalidValue;
  const float* sh = static_cast<const float*>(shift);
  float* ls = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ls != nullptr) return launch<true, true>(maps, sh, ls, B, H, nq, nk, scale, st);
  return online ? launch<true, false>(maps, sh, ls, B, H, nq, nk, scale, st)
                : launch<false, false>(maps, sh, ls, B, H, nq, nk, scale, st);
}

}  // extern "C"
