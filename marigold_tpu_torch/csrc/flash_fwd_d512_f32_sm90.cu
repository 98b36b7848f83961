// Flash-attention forward for the 512-wide VAE mid-block head in fp32
// storage (`--full_precision`, fp32 training's VAE encodes), designed for
// Hopper (sm_90a): 3xTF32 products on wgmma (tf32x3.cuh), fed by TMA into
// mbarrier rings, with the output's 512 columns split across two consumer
// warpgroups as in the bf16 kernel (flash_fwd_d512_sm90.cu).
//
// Replaces the fp32 512-wide instantiations of the TPU package's
// marigold_tpu/ops/flash_attention.py kernels:
//   * _flash_kernel_dt_shifted_kblocked (shifted softmax; pallas_call at
//     :429), the VAE mid attention of every fp32 encode and decode;
//   * _flash_kernel_dt (exact online softmax; :460) at d = 512, which the
//     parity pin selects and the folded [BH, N, 512] entry (:522) runs.
// It took the place of a CUDA-core FFMA D = 512 tile (32 x 32 tiles, 198
// KB of shared memory; 13.8-14.1 ms at [1, 9216, 512], PERF.md). The
// 64-wide fp32 forward is flash_fwd_d64_f32_sm90.cu.
//
// Math per (batch, head, query row r), as the plain version
// (ops/flash_attention.py:_plain_forward) computes it in fp32:
//   s_j = (q_r . k_j) / sqrt(512);
//   shifted: p_j = exp(min(s_j - shift_r, 75)), shift_r from the caller;
//   online:  running max m, p_j = exp(s_j - m), O and l rescaled by
//            exp(m_old - m_new) when the max grows;
//   out_r = (sum_j p_j v_j) / max(sum_j p_j, 1e-30), stored fp32.
// Both products are 3xTF32 (lo.hi + hi.lo + hi.hi in the fp32
// accumulator), so they carry fp32 inputs to ~2^-21 per product; l sums
// the fp32 p_j. Every exponential is exp2 on logits scaled by
// log2(e)/sqrt(512), with the shift, the clamp and the running max in the
// same base-2 units. Key columns j >= nk get s_j = -1e30 (p_j = 0, against
// zeros of v^T); query rows r >= nq are computed on TMA's zero fill and not
// stored.
//
// Operands (ops/flash_attention.py:_launch_forward, one tf32_split.cu
// launch before this one): q and k as hi and lo copies in their [B, N, ld]
// layout, v as hi and lo copies of v^T, [B, ld, NKP] (NKP = nk rounded up
// to 8, the keys past nk zeros, keys permuted in groups of 8 so that P's
// accumulator registers are its A fragments: tf32x3.cuh). Every copy has a
// 3-D TMA map with a {32, rows, 1} box and the 128-byte swizzle (32 fp32
// are one swizzle row).
//
// The design, per CTA of 64 query rows of one (b, h):
//   * a producer warpgroup (setmaxnreg 24) whose warp c's lane 0 feeds
//     consumer c's ring, and two consumer warpgroups (240); consumer c owns
//     d columns [256c, 256c + 256): half of each logit's reduction and half
//     of the output, a [64, 256] fp32 accumulator in 128 registers;
//   * per 64-key tile, consumer c's ring brings 8 stages of S, each
//     {Q_hi, Q_lo, K_hi, K_lo} over 32 of its d, and 4 stages of PV, each
//     {V^T_hi, V^T_lo} of 32 keys over 2 x 64 of its output columns (4
//     boxes of 8 KB each); 3 stages of 32 KB in flight per consumer.
//     Q is not resident: [64, 512] fp32 hi and lo would take 256 KB, so
//     each tile reads it again from L2;
//   * S_c = Q K^T over its 256 d by wgmma m64n64k8 (both operands from
//     shared memory, 3 passes per k8 step, one commit group per stage and
//     one group in flight while the next stage is waited for; every thread
//     of the consumer arrives on the stage's empty barrier, so no branch
//     sits among wgmmas in flight); the two
//     partial S meet through shared memory ([2][64 x 64] fp32, 32 KB) at a
//     named barrier and each consumer adds the other's: s_c + s_other is
//     the same fp32 sum in both, so both hold the same S, m and l;
//   * P in registers, split into hi and lo A fragments (tf32x3.cuh) 32
//     keys at a time; per 32 keys and 64 output columns, P V^T by wgmma
//     m64n64k8 with A from registers (lo.hi + hi.lo + hi.hi per k8 step)
//     into a fresh [64, 64] accumulator, added into O's columns with fp32
//     adds: the tensor cores' own accumulation truncates, which over 9216
//     keys in one accumulator cost ~7e-5 of the output's scale
//     (tf32x3.cuh). O (128), the product (32), P's hi fragments (32, in
//     place of P) and the lo ones of 32 keys (16): 208 registers of the
//     consumers' 240 (the lo fragments of all 64 keys spilled);
//   * the epilogue divides by l and stores fp32 straight from registers
//     (two floats per thread per 8 columns), rows past nq skipped.
// Shared memory: 2 consumers x 3 stages x 32 KB + 32 KB of S exchange +
// 12 barriers = 224 KB + 96 B, of the 227 KB a block may use.
//
// What bounds it on the H100: per head 4 N^2 512 FLOPs, x3 for the tf32
// passes: at [1, 9216, 512] 0.522 TFLOP, 1.054 ms at 495 TFLOP/s. Each CTA
// reads per 64-key tile 128 KB of Q (hi and lo), 128 KB of K and 128 KB of
// V^T from L2 for both consumers, 768 KB per tile: at [1, 9216, 512] 144
// CTAs x 144 tiles = 15.9 GB per call, ~2.3 ms at ~7 TB/s (an estimate of
// the L2's rate; no counters run on the card). So L2 may bind before the
// tensor cores; the ring keeps 3 stages in flight against its latency.
// Shared memory read by the tensor cores per tile (both consumers): S 768
// KB, PV 384 KB, at 128 B per cycle ~9.2K cycles against ~12.3K cycles of
// tf32 work per tile at the peak. Known limits, not addressed here: at
// B = 1, N = 9216 the 144 CTAs make two waves on 132 SMs, the second nearly
// empty; the two consumers meet at the S exchange, so their softmax phases
// coincide and leave the tensor cores idle meanwhile; each 32-key,
// 64-column product is waited for before its adds, so a consumer's tensor
// work drains eight times per tile (the other consumer's fills the gap).

#include "tf32x3.cuh"

namespace {

constexpr int D = 512;             // head width
constexpr int BQ = 64;             // query rows per CTA
constexpr int BK = 64;             // keys per tile
constexpr int CONSUMERS = 2;       // consumer warpgroups
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int DH = D / CONSUMERS;  // 256: a consumer's d columns
constexpr int QK_STAGES = DH / TF32_ROW;  // 8 stages of S per key tile
constexpr int DQ = 64;                    // output columns per tile product
constexpr int PV_STAGES = 4;  // (32 keys) x (128 output columns) of V^T
constexpr int BOX_BYTES = BQ * 128;       // {32 fp32, 64 rows}: 8 KB
constexpr int STAGE_BYTES = 4 * BOX_BYTES;  // 32 KB
constexpr int STAGES = 3;                   // per consumer ring

// Shared memory: the consumers' rings, the S exchange, then the barriers
// (full[c][s], then empty[c][s]); every stage 1024-byte aligned.
constexpr int SM_X = CONSUMERS * STAGES * STAGE_BYTES;
constexpr int SM_BAR = SM_X + CONSUMERS * BQ * BK * 4;
constexpr int SM_BYTES = SM_BAR + 8 * 2 * CONSUMERS * STAGES;
constexpr int SMEM_REQUEST = SM_BYTES + 1024;  // room to align the base
static_assert(SMEM_REQUEST <= 232448, "fits the 227 KB a block can use");

constexpr float kNegInf = -1e30f;  // the TPU kernels' NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
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
// d[4j + 2 + e] the same columns of row 16w + l/4 + 8 (e in {0, 1}).
template <bool ONLINE>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_d512_f32_kernel(const __grid_constant__ CUtensorMap tm_qh,
                          const __grid_constant__ CUtensorMap tm_ql,
                          const __grid_constant__ CUtensorMap tm_kh,
                          const __grid_constant__ CUtensorMap tm_kl,
                          const __grid_constant__ CUtensorMap tm_vh,
                          const __grid_constant__ CUtensorMap tm_vl,
                          const float* __restrict__ shift,
                          float* __restrict__ out, int H, int nq, int nk,
                          int ldo, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gen = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t full0 = base + SM_BAR;
  const uint32_t empty0 = full0 + 8 * CONSUMERS * STAGES;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int n_tiles = cdiv(nk, BK);

  if (threadIdx.x == 0) {
    for (int i = 0; i < CONSUMERS * STAGES; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, 128);  // every thread of its consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer warpgroup: lane 0 of warp c feeds consumer c's ring, stage
    // n in slot n % STAGES.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    const int c = threadIdx.x / 32;
    if (c < CONSUMERS && threadIdx.x % 32 == 0) {
      const uint32_t ring = base + c * STAGES * STAGE_BYTES;
      const uint32_t full_c = full0 + 8 * c * STAGES;
      const uint32_t empty_c = empty0 + 8 * c * STAGES;
      const int d0 = h * D + c * DH;
      int n = 0;
      for (int j = 0; j < n_tiles; ++j) {
        for (int i = 0; i < QK_STAGES + PV_STAGES; ++i, ++n) {
          const int slot = n % STAGES;
          const uint32_t full = full_c + 8 * slot;
          const uint32_t dst = ring + slot * STAGE_BYTES;
          if (n >= STAGES) mbar_wait(empty_c + 8 * slot, (n / STAGES - 1) & 1);
          mbar_expect_tx(full, STAGE_BYTES);
          if (i < QK_STAGES) {
            const int dc = d0 + TF32_ROW * i;
            tma_load(dst, &tm_qh, dc, q0, b, full);
            tma_load(dst + BOX_BYTES, &tm_ql, dc, q0, b, full);
            tma_load(dst + 2 * BOX_BYTES, &tm_kh, dc, j * BK, b, full);
            tma_load(dst + 3 * BOX_BYTES, &tm_kl, dc, j * BK, b, full);
          } else {  // V^T_hi, V^T_lo: 2 x 64 output columns, 32 keys
            const int p = i - QK_STAGES;
            const int key = j * BK + TF32_ROW * (p / 2);
            const int dr = d0 + 2 * DQ * (p % 2);
            tma_load(dst, &tm_vh, key, dr, b, full);
            tma_load(dst + BOX_BYTES, &tm_vh, key, dr + DQ, b, full);
            tma_load(dst + 2 * BOX_BYTES, &tm_vl, key, dr, b, full);
            tma_load(dst + 3 * BOX_BYTES, &tm_vl, key, dr + DQ, b, full);
          }
        }
      }
    }
    return;
  }

  // Consumer warpgroup c: d columns [256c, 256c + 256) of S's reduction and
  // of the output.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;  // this thread's rows: r0, r0 + 8
  const int col = 2 * (lane % 4);           // its column pair in each 8
  const int row0 = q0 + r0;                 // global query rows
  const int row1 = row0 + 8;
  const uint32_t ring = base + c * STAGES * STAGE_BYTES;
  const uint32_t full_c = full0 + 8 * c * STAGES;
  const uint32_t empty_c = empty0 + 8 * c * STAGES;
  float* x_mine = reinterpret_cast<float*>(gen + SM_X) + c * BQ * BK;
  const float* x_other =
      reinterpret_cast<const float*>(gen + SM_X) + (1 - c) * BQ * BK;

  float sh0 = 0.f, sh1 = 0.f;  // shifted mode: the row shift, base 2
  if (!ONLINE) {
    if (row0 < nq) sh0 = shift[(size_t)bh * nq + row0] * kLog2e;
    if (row1 < nq) sh1 = shift[(size_t)bh * nq + row1] * kLog2e;
  }
  float m0 = kNegInf, m1 = kNegInf;  // running max (online), base 2
  float l0 = 0.f, l1 = 0.f;          // this thread's part of its row sums
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float s[BK / 2], part[DQ / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = part[i] = 0.f;
  uint32_t pl[BK / 4];  // P's lo A fragments of 32 keys (hi ones replace s)

  int n = 0;  // stages consumed
  for (int j = 0; j < n_tiles; ++j) {
    // S_c = Q K^T over this consumer's 256 d: 8 stages, one commit group
    // each; stage i - 1 is released once stage i's group is issued and
    // stage i - 1's has completed.
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < QK_STAGES; ++i) {
      const int slot = (n + i) % STAGES;
      mbar_wait(full_c + 8 * slot, ((n + i) / STAGES) & 1);
      const uint32_t a = ring + slot * STAGE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TF32_ROW / 8; ++kk) {
        const uint32_t off = 32 * kk;
        const uint32_t qh = kdesc(a + off);
        const uint32_t ql = kdesc(a + BOX_BYTES + off);
        const uint32_t kh = kdesc(a + 2 * BOX_BYTES + off);
        const uint32_t kl = kdesc(a + 3 * BOX_BYTES + off);
        wgmma_m64n64k8_tf32_ss(s, ql, kh, i > 0 || kk > 0);
        wgmma_m64n64k8_tf32_ss(s, qh, kl, 1);
        wgmma_m64n64k8_tf32_ss(s, qh, kh, 1);
      }
      wgmma_commit();
      if (i > 0) {
        wgmma_wait<1>();
        mbar_arrive(empty_c + 8 * ((n + i - 1) % STAGES));
      }
    }
    wgmma_wait<0>();
    fence_regs(s);
    mbar_arrive(empty_c + 8 * ((n + QK_STAGES - 1) % STAGES));
    n += QK_STAGES;

    // The two halves of S meet: the same fp32 sum in both consumers. The
    // second barrier keeps the next tile's writes behind both reads.
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) x_mine[i * 128 + t] = s[i];
    named_barrier(1, 128 * CONSUMERS);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] += x_other[i * 128 + t];
    named_barrier(2, 128 * CONSUMERS);

    const int k0 = j * BK;
    if (k0 + BK > nk) {  // the ragged edge: mask keys >= nk
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (k0 + 8 * jj + col + e >= nk) {
            s[4 * jj + e] = kNegInf;
            s[4 * jj + 2 + e] = kNegInf;
          }
        }
      }
    }
    float ref0, ref1;
    if (ONLINE) {
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * jj], s[4 * jj + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
      }
      ref0 = fmaxf(m0, quad_max(mx0) * scale_log2);
      ref1 = fmaxf(m1, quad_max(mx1) * scale_log2);
      const float a0 = ex2(m0 - ref0), a1 = ex2(m1 - ref1);
      m0 = ref0;
      m1 = ref1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int i = 0; i < DH / 8; ++i) {
        o[4 * i] *= a0;
        o[4 * i + 1] *= a0;
        o[4 * i + 2] *= a1;
        o[4 * i + 3] *= a1;
      }
    } else {
      ref0 = sh0;
      ref1 = sh1;
    }
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = fmaf(s[4 * jj + e], scale_log2, -ref0);
        float x1 = fmaf(s[4 * jj + 2 + e], scale_log2, -ref1);
        if (!ONLINE) {
          x0 = fminf(x0, kClamp2);
          x1 = fminf(x1, kClamp2);
        }
        s[4 * jj + e] = ex2(x0);
        s[4 * jj + 2 + e] = ex2(x1);
        l0 += s[4 * jj + e];
        l1 += s[4 * jj + 2 + e];
      }
    }
    // O_c += P V^T_c, per 32 keys: P's hi and lo fragments of those keys,
    // then two stages of V^T_hi and V^T_lo over 2 x 64 output columns; each
    // 64 columns' product goes into a fresh accumulator that is added into
    // O with fp32 adds (the tensor cores' own accumulation truncates:
    // tf32x3.cuh).
#pragma unroll
    for (int p = 0; p < PV_STAGES; ++p) {
      if (p == 0) acc_to_tf32x2<0>(s, pl);
      if (p == 2) acc_to_tf32x2<BK / 16>(s, pl);
      const int slot = (n + p) % STAGES;
      mbar_wait(full_c + 8 * slot, ((n + p) / STAGES) & 1);
      const uint32_t a = ring + slot * STAGE_BYTES;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        fence_regs(s);
        fence_regs(pl);
        fence_regs(part);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TF32_ROW / 8; ++kk) {
          const int f = 4 * (4 * (p / 2) + kk);  // the k8 step's hi fragments
          const uint32_t box = a + half * BOX_BYTES + 32 * kk;
          const uint32_t vh = kdesc(box);
          const uint32_t vl = kdesc(box + 2 * BOX_BYTES);
          const uint32_t h0 = __float_as_uint(s[f]);
          const uint32_t h1 = __float_as_uint(s[f + 1]);
          const uint32_t h2 = __float_as_uint(s[f + 2]);
          const uint32_t h3 = __float_as_uint(s[f + 3]);
          wgmma_m64n64k8_tf32_rs(part, pl[4 * kk], pl[4 * kk + 1],
                                 pl[4 * kk + 2], pl[4 * kk + 3], vh, kk > 0);
          wgmma_m64n64k8_tf32_rs(part, h0, h1, h2, h3, vl, 1);
          wgmma_m64n64k8_tf32_rs(part, h0, h1, h2, h3, vh, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(part);
        fence_regs(s);
        fence_regs(pl);
        const int q = 2 * (p % 2) + half;  // the 64-column quarter
#pragma unroll
        for (int i = 0; i < DQ / 2; ++i) o[q * (DQ / 2) + i] += part[i];
      }
      mbar_arrive(empty_c + 8 * slot);
    }
    n += PV_STAGES;
  }

  // Both consumers hold the same row sums; each stores its 256 columns.
  const float inv0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
  const float inv1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
  float* ob = out + (size_t)b * nq * ldo + h * D + c * DH + col;
  if (row0 < nq) {
    float* dst = ob + (size_t)row0 * ldo;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      *reinterpret_cast<float2*>(dst + 8 * i) =
          make_float2(o[4 * i] * inv0, o[4 * i + 1] * inv0);
  }
  if (row1 < nq) {
    float* dst = ob + (size_t)row1 * ldo;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      *reinterpret_cast<float2*>(dst + 8 * i) =
          make_float2(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
  }
}

template <bool ONLINE>
cudaError_t launch(const CUtensorMap* maps, const float* shift, float* out,
                   int B, int H, int nq, int nk, int ldo, float scale,
                   cudaStream_t stream) {
  auto kernel = flash_fwd_d512_f32_kernel<ONLINE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_REQUEST);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(nq, BQ), B * H);
  kernel<<<grid, THREADS, SMEM_REQUEST, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], shift, out, H,
      nq, nk, ldo, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The fp32 512-wide forward on split operands (tf32_split.cu): q_hi/q_lo
// [B, nq, ld], k_hi/k_lo [B, nk, ld], vt_hi/vt_lo [B, ld, round_up(nk, 8)]
// fp32, all 16-byte aligned, ld = 512 H a multiple of 4; o [B, nq, ldo]
// fp32 with ldo a multiple of 2; `shift` [B*H, nq] fp32 in shifted mode.
// Returns cudaSuccess (0) or the error of the checks, the map encoding, the
// attribute call or the launch.
int mt_flash_fwd_d512_f32(const void* q_hi, const void* q_lo,
                          const void* k_hi, const void* k_lo,
                          const void* vt_hi, const void* vt_lo,
                          const void* shift, void* o, int B, int H, int nq,
                          int nk, int ld, int ldo, int online, float scale,
                          void* stream) {
  if (B < 1 || H < 1 || B * H > 65535 || nq < 1 || nk < 1 || ld != D * H ||
      ldo % 2 || (!online && shift == nullptr))
    return (int)cudaErrorInvalidValue;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const int nkp = (nk + 7) / 8 * 8;
  CUtensorMap maps[6];
  if (!encode_f32_rows(fn, &maps[0], q_hi, B, nq, ld, BQ) ||
      !encode_f32_rows(fn, &maps[1], q_lo, B, nq, ld, BQ) ||
      !encode_f32_rows(fn, &maps[2], k_hi, B, nk, ld, BK) ||
      !encode_f32_rows(fn, &maps[3], k_lo, B, nk, ld, BK) ||
      !encode_f32_rows(fn, &maps[4], vt_hi, B, ld, nkp, DQ) ||
      !encode_f32_rows(fn, &maps[5], vt_lo, B, ld, nkp, DQ))
    return (int)cudaErrorInvalidValue;
  const float* sh = static_cast<const float*>(shift);
  float* of = static_cast<float*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return online ? (int)launch<true>(maps, sh, of, B, H, nq, nk, ldo, scale, st)
                : (int)launch<false>(maps, sh, of, B, H, nq, nk, ldo, scale,
                                     st);
}

}  // extern "C"
