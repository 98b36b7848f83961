// Flash-attention backward dK and dV in fp32 storage (fp32 fine-tuning)
// for heads 40, 64, 80 and 160 wide (a template on the head width D),
// designed for Hopper (sm_90a): 3xTF32 products on wgmma (tf32x3.cuh), TMA
// loads into an mbarrier ring, a producer warp and two consumer
// warpgroups, no atomics.
//
// Replaces the fp32 instantiations at those widths (SD2's 64-wide heads;
// the 40-, 80- and 160-wide heads of an SD1.x-class UNet) of the TPU
// package's marigold_tpu/ops/flash_attention.py:_flash_bwd_dkv_kernel
// (pallas_call at :832, in _flash_dt_bwd_pallas). At D = 64 it took the
// place of a CUDA-core FFMA dK/dV kernel (one 64 x 64 tile in flight, 102.5
// KB of shared memory, 3.698 ms at [2, 4800, 320] h = 5, PERF.md); its
// partner, the fp32 dQ, is flash_bwd_dq_f32_sm90.cu, which also writes the
// padded lse and delta rows read here.
//
// Math per (batch, head), as the TPU kernel computes it:
//   S = Q K^T * scale;  P = exp(S - lse_row);  dP = dO V^T;
//   dS = P o (dP - delta_row),  delta = rowsum(dO o O) (from the caller);
//   dK = dS^T Q * scale;  dV = P^T dO,
// P and dS fp32, every product 3xTF32 (lo.hi + hi.lo + hi.hi in the fp32
// accumulator, ~2^-21 per product). lse and delta are the caller's
// [B*H, ld_stat] rows padded to a multiple of 64 (written by the dQ
// kernel, as ops/flash_attention.py:bwd_stats pads them): lse = 1e30 in a
// padded row makes P = 0 there, so padded query rows add nothing. Key
// rows past nk are computed on TMA's zero fill and not stored.
//
// Operands (ops/flash_attention.py:flash_attention_bwd_dkv: pairs of the
// backward's one tf32_split.cu launch, which the dQ kernel reads too), each
// product's B operand K-major as tf32 requires:
//   S^T  = K Q^T:   A = K (resident),  B = Q    [B, nq, ld] hi/lo
//   dP^T = V dO^T:  A = V (resident),  B = dO   [B, nq, ld] hi/lo
//   dV  += P^T dO:  A = P^T (registers), B = dO^T [B, ld, NQP] hi/lo
//   dK  += dS^T Q:  A = dS^T (registers), B = Q^T [B, ld, NQP] hi/lo
// The transposed copies come from the split kernel (NQP = nq rounded up to
// 8, the query rows past nq zeros), their query index permuted in groups
// of 8 so that the S^T and dP^T accumulators' registers are the A
// fragments of P^T and dS^T with no shuffle and no trip through shared
// memory (tf32x3.cuh). Every copy has a 4-D TMA map that names the head
// (tf32x3.cuh:encode_heads, encode_heads_t), so a box's lanes or rows past
// D read as zeros, never the next head's.
//
// The design, per block of BM key rows of one (b, h):
//   * K and V hi and lo resident, each QB = ceil(D / 32) boxes of {32
//     lanes, BM rows};
//   * per 64 query rows KS = ceil(D / 64) substages each of Q and dO and
//     NV = ceil(D / 64) each of dO^T and Q^T (64 output columns each) go
//     through a ring of 32 KB slots, each hi and lo as four 8 KB boxes,
//     each consumed by both consumers (every consumer thread arrives on its
//     empty barrier, no branch among wgmmas in flight);
//   * S^T and dP^T by wgmma m64n64k8 with both operands in shared memory;
//     P^T and dS^T with lse and delta per column read from the padded rows
//     in device memory (L1 hits: one block reads the same 64 of each); P^T
//     and dS^T split into hi and lo A fragments; per transposed substage
//     the tile's dV or dK product (24 wgmma with A from registers) into a
//     fresh accumulator, waited and added with fp32 adds (the tensor
//     cores' accumulation truncates, and over 75 tiles it would cost ~5e-5
//     of dV's scale: tf32x3.cuh);
//   * D <= 64: BM = 128, consumer c owns key rows [64c, 64c + 64) and
//     computes dK and dV, issuing S^T and dP^T as two commit groups; it
//     holds S^T, dP^T, dK, dV, the tile product (160 registers) and one
//     product's lo fragments (32) at most. K, V hi/lo take 128 KB, the
//     ring 3 slots: 224 KB;
//   * D = 80 and 160 (SPLIT): dK and dV take 64 or 96 registers each, too
//     many for one consumer beside the rest, and K and V of 128 rows would
//     take 192 or 320 KB; so BM = 64, both consumers own the block's 64
//     keys and compute S^T (each substage waited for and released before
//     the next), consumer 0 also dP^T, dS^T and dK, consumer 1 P^T and dV;
//     each waits on the slots it does not read and releases them.
//     Registers: dK or dV (96 at D = 160), the lo fragments, S^T (which
//     takes the dK consumer's tile products once dS^T is computed) and
//     dP^T or the dV consumer's tile product: 192 at D = 160. Shared
//     memory: at D = 80 96 KB resident + 4 slots, at D = 160 160 KB + 2
//     slots: 224 KB;
//   * the epilogue stores dK * scale and dV fp32 straight from registers,
//     rows past nk and columns past D skipped. Each output element is
//     written by one thread of one block: no atomics, two calls give the
//     same bits.
//
// What bounds it on the H100: 8 N^2 D FLOPs per head (S^T, dP^T, dV, dK),
// x3 for the tf32 passes: at [2, 4800, 320] h = 5 (D = 64) 0.354 TFLOP,
// 0.715 ms at 495 TFLOP/s, against 128 KB of ring traffic per 64 query
// rows per block (3.6 GB from L2 per call at that shape) and ~9 exp2/FMA
// per tensor k8 step; at D = 80 and 160 the duplicated S^T adds 2 N^2 D.
// The consumers do not overlap one stage's products with the next one's
// softmax (that would take ~256 registers); the two consumers, each on its
// own rows or products, fill each other's gaps.

#include "tf32x3.cuh"

namespace {

constexpr int BN = 64;            // query rows per ring substage
constexpr int CONSUMERS = 2;      // consumer warpgroups
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int STAT_PAD = 64;      // ld_stat's multiple
constexpr int SLOT_BYTES = 4 * ATT_BOX;  // hi (2 boxes), lo (2 boxes)

// The shapes of the instantiation at head width D.
template <int D>
struct Shape {
  static_assert(D % 8 == 0 && D <= 160, "D a multiple of 8, at most 160");
  static constexpr bool SPLIT = D > 64;        // see above
  static constexpr int BM = SPLIT ? 64 : 128;  // key rows per block
  static constexpr int QB = (D + 31) / 32;     // 32-lane boxes of a row
  static constexpr int KS = (D + 63) / 64;     // Q (and dO) substages
  static constexpr int NV = (D + 63) / 64;     // dO^T (and Q^T) substages
  static constexpr int SUBS = 2 * KS + 2 * NV;  // substages per 64 rows
  static constexpr int RES_BOX = BM * 128;     // {32 lanes, BM rows}
  static constexpr int RES_BYTES = QB * RES_BOX;  // one of K/V hi/lo
  static constexpr int FIT =
      (232448 - 1024 - 8 * 9 - 4 * RES_BYTES) / SLOT_BYTES;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;  // ring slots
  static_assert(STAGES >= 2, "two ring slots fit");
  // Shared memory: K_hi, K_lo, V_hi, V_lo, the ring, then the barriers
  // (full[STAGES], empty[STAGES], resident); every box 1024-byte aligned.
  static constexpr int SM_KH = 0;
  static constexpr int SM_KL = RES_BYTES;
  static constexpr int SM_VH = 2 * RES_BYTES;
  static constexpr int SM_VL = 3 * RES_BYTES;
  static constexpr int SM_RING = 4 * RES_BYTES;
  static constexpr int SM_BAR = SM_RING + STAGES * SLOT_BYTES;
  static constexpr int SM_BYTES = SM_BAR + 8 * (2 * STAGES + 1);
  static constexpr int SMEM_REQUEST = SM_BYTES + 1024;  // room to align
  static_assert(SMEM_REQUEST <= 232448, "fits the 227 KB a block can use");
};

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Rows r0 and r0 + 8 (those < nk) of acc * mul into one head of a
// [B, N, ld] fp32 tensor at row n0: column col of each 8 of each 64-column
// part (acc[v] columns [64v, 64v + 64), those past D skipped).
template <int D, int NV>
__device__ __forceinline__ void store_rows(float* dst,
                                           const float (&acc)[NV][32],
                                           float mul, int n0, int r0, int col,
                                           int nk, int ld) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = n0 + r0 + 8 * half;
    if (r >= nk) continue;
    float* row = dst + (size_t)r * ld + col;
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (64 * v + 8 * j < D)
          *reinterpret_cast<float2*>(row + 64 * v + 8 * j) =
              make_float2(acc[v][4 * j + 2 * half] * mul,
                          acc[v][4 * j + 2 * half + 1] * mul);
  }
}

// P^T = exp2(s * scale * log2e - lse * log2e) in place, lse per column
// (query row) from the padded rows at `lse_r` (this thread's column of
// the stage's first 8); padded rows hold 1e30.
__device__ __forceinline__ void probabilities_t(float (&s)[32],
                                                const float* lse_r,
                                                float scale_log2) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse_r + 8 * j);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float nl = -(e ? l2.y : l2.x) * kLog2e;
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], scale_log2, nl));
      s[4 * j + 2 + e] = ex2(fmaf(s[4 * j + 2 + e], scale_log2, nl));
    }
  }
}

// dS^T = P^T (dP^T - delta) in place in dp, delta per column (0 on padded
// rows) from the padded rows at `dl_r`.
__device__ __forceinline__ void grad_logits_t(const float (&s)[32],
                                              float (&dp)[32],
                                              const float* dl_r) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float2 d2 = *reinterpret_cast<const float2*>(dl_r + 8 * j);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float d = e ? d2.y : d2.x;
      dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - d);
      dp[4 * j + 2 + e] = s[4 * j + 2 + e] * (dp[4 * j + 2 + e] - d);
    }
  }
}

// Accumulator layout of wgmma m64nN (per warpgroup thread t, warp w = t/32,
// lane l): d[4j + e] is row 16w + l/4, column 8j + 2(l%4) + e, and
// d[4j + 2 + e] the same columns of row 16w + l/4 + 8 (e in {0, 1}). Here
// rows are keys and columns query rows of the substage.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_f32_kernel(
    const __grid_constant__ CUtensorMap tm_kh,
    const __grid_constant__ CUtensorMap tm_kl,
    const __grid_constant__ CUtensorMap tm_vh,
    const __grid_constant__ CUtensorMap tm_vl,
    const __grid_constant__ CUtensorMap tm_qh,
    const __grid_constant__ CUtensorMap tm_ql,
    const __grid_constant__ CUtensorMap tm_gh,
    const __grid_constant__ CUtensorMap tm_gl,
    const __grid_constant__ CUtensorMap tm_gth,
    const __grid_constant__ CUtensorMap tm_gtl,
    const __grid_constant__ CUtensorMap tm_qth,
    const __grid_constant__ CUtensorMap tm_qtl,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int H, int ld_stat,
    int nq, int nk, int ld, float scale, float scale_log2) {
  using S_ = Shape<D>;
  constexpr bool SPLIT = S_::SPLIT;
  constexpr int STAGES = S_::STAGES;
  constexpr int KS = S_::KS;
  constexpr int NV = S_::NV;
  constexpr int SUBS = S_::SUBS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = base + S_::SM_BAR;
  const uint32_t empty0 = full0 + 8 * STAGES;
  const uint32_t res = empty0 + 8 * STAGES;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * S_::BM;
  const int n_tiles = cdiv(nq, BN);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 128 * CONSUMERS);  // every consumer thread
    }
    mbar_init(res, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      // the resident K and V tiles, hi and lo, QB boxes each
      mbar_expect_tx(res, 4 * S_::RES_BYTES);
      const CUtensorMap* res_maps[4] = {&tm_kh, &tm_kl, &tm_vh, &tm_vl};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int box = 0; box < S_::QB; ++box)
          tma_load_4d(base + i * S_::RES_BYTES + box * S_::RES_BOX,
                      res_maps[i], 32 * box, h, k0, b, res);
      // per 64 query rows: KS substages of Q and of dO (row-major), NV of
      // dO^T and of Q^T (transposed)
      const CUtensorMap* row_maps[2][2] = {{&tm_qh, &tm_ql}, {&tm_gh, &tm_gl}};
      const CUtensorMap* t_maps[2][2] = {{&tm_gth, &tm_gtl},
                                         {&tm_qth, &tm_qtl}};
      int n = 0;
      for (int it = 0; it < n_tiles; ++it) {
#pragma unroll
        for (int sub = 0; sub < SUBS; ++sub, ++n) {
          const int slot = n % STAGES;
          const uint32_t full = full0 + 8 * slot;
          const uint32_t dst = base + S_::SM_RING + slot * SLOT_BYTES;
          if (n >= STAGES) mbar_wait(empty0 + 8 * slot, (n / STAGES - 1) & 1);
          if (sub < 2 * KS) {  // [B, nq, ld]: 64 query rows, 32 d lanes
            const int ks = sub % KS;
            const int boxes = S_::QB - 2 * ks < 2 ? 1 : 2;
            mbar_expect_tx(full, 2 * boxes * ATT_BOX);
#pragma unroll
            for (int part = 0; part < 2; ++part)    // hi, lo
#pragma unroll
              for (int half = 0; half < boxes; ++half)
                tma_load_4d(dst + (2 * part + half) * ATT_BOX,
                            row_maps[sub / KS][part], 32 * (2 * ks + half), h,
                            it * BN, b, full);
          } else {  // [B, ld, NQP]: 64 d rows of the head, 32 queries
            const int ts = sub - 2 * KS;
            mbar_expect_tx(full, SLOT_BYTES);
#pragma unroll
            for (int part = 0; part < 2; ++part)
#pragma unroll
              for (int half = 0; half < 2; ++half)
                tma_load_4d(dst + (2 * part + half) * ATT_BOX,
                            t_maps[ts / NV][part], it * BN + 32 * half,
                            64 * (ts % NV), h, b, full);
          }
        }
      }
    }
    return;
  }

  // Consumer warpgroup c: key rows [64c, 64c + 64) of the block, or
  // (SPLIT) the block's 64 keys and dK (c = 0) or dV (c = 1).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;  // this thread's key rows r0, +8
  const int col = 2 * (lane % 4);           // its query column pair per 8
  const int crow = SPLIT ? 0 : 64 * c;      // its rows' offset in the block
  const uint32_t rows = crow * 128;         // ... inside each box
  const uint32_t kh = base + S_::SM_KH + rows, kl = base + S_::SM_KL + rows;
  const uint32_t vh = base + S_::SM_VH + rows, vl = base + S_::SM_VL + rows;
  const float* lse_r = lse + (size_t)bh * ld_stat + col;
  const float* dl_r = delta + (size_t)bh * ld_stat + col;
  const size_t head = (size_t)b * nk * ld + h * D;

  auto slot_of = [&](int n) {
    return base + S_::SM_RING + (n % STAGES) * SLOT_BYTES;
  };
  auto wait_full = [&](int n) {
    mbar_wait(full0 + 8 * (n % STAGES), (n / STAGES) & 1);
  };
  auto release = [&](int n) { mbar_arrive(empty0 + 8 * (n % STAGES)); };
  // acc[v] += the tile's product of the fragments (hi in `x`, lo) with the
  // transposed substages n0 .. n0 + NV - 1, each into a fresh accumulator
  // added with fp32 adds (the tensor cores' own accumulation truncates:
  // tf32x3.cuh).
  auto products = [&](float (&acc)[NV][32], float (&x)[32],
                      uint32_t (&lo)[32], float (&part)[32], int n0) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      wait_full(n0 + v);
      wgmma_att_nn(part, x, lo, slot_of(n0 + v));
      wgmma_wait<0>();
      fence_regs(part);
      fence_regs(x);
      fence_regs(lo);
      release(n0 + v);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[v][i] += part[i];
    }
  };
  // waits on substages n0 .. n0 + count - 1 and releases them unread
  auto skip = [&](int n0, int count) {
    for (int i = 0; i < count; ++i) {
      wait_full(n0 + i);
      release(n0 + i);
    }
  };

  mbar_wait(res, 0);
  if constexpr (!SPLIT) {
    float s[32], dp[32], dkacc[NV][32], dvacc[NV][32], part[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = part[i] = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int i = 0; i < 32; ++i) dkacc[v][i] = dvacc[v][i] = 0.f;
    uint32_t lo[32];
    for (int it = 0; it < n_tiles; ++it) {
      const int n = it * SUBS;
      wait_full(n);
      wgmma_att_nt<D>(s, kh, kl, S_::RES_BOX, slot_of(n), 0);   // S^T = K Q^T
      wait_full(n + 1);
      wgmma_att_nt<D>(dp, vh, vl, S_::RES_BOX, slot_of(n + 1), 0);  // dP^T
      wgmma_wait<1>();
      fence_regs(s);
      release(n);
      probabilities_t(s, lse_r + it * BN, scale_log2);
      wgmma_wait<0>();
      fence_regs(dp);
      release(n + 1);
      grad_logits_t(s, dp, dl_r + it * BN);
      // dV += P^T dO against dO^T, then dK += dS^T Q against Q^T
      acc_to_tf32x2<0>(s, lo);
      products(dvacc, s, lo, part, n + 2);
      acc_to_tf32x2<0>(dp, lo);
      products(dkacc, dp, lo, part, n + 3);
    }
    store_rows<D>(dk + head, dkacc, scale, k0 + crow, r0, col, nk, ld);
    store_rows<D>(dv + head, dvacc, 1.f, k0 + crow, r0, col, nk, ld);
  } else if (c == 0) {
    // dK: S^T and dP^T one substage at a time, dS^T, dK += dS^T Q (each
    // tile's product in S^T's registers, free once dS^T is computed)
    float s[32], dp[32], dkacc[NV][32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int i = 0; i < 32; ++i) dkacc[v][i] = 0.f;
    uint32_t lo[32];
    for (int it = 0; it < n_tiles; ++it) {
      const int n = it * SUBS;
#pragma unroll
      for (int sub = 0; sub < 2 * KS; ++sub) {
        wait_full(n + sub);
        if (sub < KS)
          wgmma_att_nt<D>(s, kh, kl, S_::RES_BOX, slot_of(n + sub), sub);
        else
          wgmma_att_nt<D>(dp, vh, vl, S_::RES_BOX, slot_of(n + sub),
                          sub - KS);
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        release(n + sub);
      }
      probabilities_t(s, lse_r + it * BN, scale_log2);
      grad_logits_t(s, dp, dl_r + it * BN);
      skip(n + 2 * KS, NV);  // dO^T: consumer 1's
      acc_to_tf32x2<0>(dp, lo);
      products(dkacc, dp, lo, s, n + 2 * KS + NV);
    }
    store_rows<D>(dk + head, dkacc, scale, k0, r0, col, nk, ld);
  } else {
    // dV: S^T one substage at a time, P^T, dV += P^T dO
    float s[32], dvacc[NV][32], part[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = part[i] = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int i = 0; i < 32; ++i) dvacc[v][i] = 0.f;
    uint32_t lo[32];
    for (int it = 0; it < n_tiles; ++it) {
      const int n = it * SUBS;
#pragma unroll
      for (int sub = 0; sub < KS; ++sub) {
        wait_full(n + sub);
        wgmma_att_nt<D>(s, kh, kl, S_::RES_BOX, slot_of(n + sub), sub);
        wgmma_wait<0>();
        fence_regs(s);
        release(n + sub);
      }
      skip(n + KS, KS);  // dO: consumer 0's
      probabilities_t(s, lse_r + it * BN, scale_log2);
      acc_to_tf32x2<0>(s, lo);
      products(dvacc, s, lo, part, n + 2 * KS);
      skip(n + 2 * KS + NV, NV);  // Q^T: consumer 0's
    }
    store_rows<D>(dv + head, dvacc, 1.f, k0, r0, col, nk, ld);
  }
}

template <int D>
cudaError_t launch(const CUtensorMap (&maps)[12], const float* lse,
                   const float* delta, float* dk, float* dv, int B, int H,
                   int nq, int nk, int ld, int ld_stat, float scale,
                   cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_f32_kernel<D>;
  constexpr int smem = Shape<D>::SMEM_REQUEST;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(nk, Shape<D>::BM), B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7],
      maps[8], maps[9], maps[10], maps[11], lse, delta, dk, dv, H, ld_stat,
      nq, nk, ld, scale, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dK and dV of the fp32 attention backward at head width D (40, 64, 80 or
// 160) on split operands (tf32_split.cu): q_hi/q_lo and g_hi/g_lo (dO)
// [B, nq, ld], k_hi/k_lo and v_hi/v_lo [B, nk, ld], qt_hi/qt_lo and
// gt_hi/gt_lo [B, ld, round_up(nq, 8)], all fp32 and 16-byte aligned with
// ld >= H D a multiple of 4; lse/delta [B*H, ld_stat] fp32, ld_stat a
// multiple of 64 and at least nq, padded as bwd_stats pads them; dk/dv
// [B, nk, ld] fp32. Returns cudaSuccess (0) or the error of the checks,
// the map encoding, the attribute call or the launch.
int mt_flash_bwd_dkv_f32(const void* q_hi, const void* q_lo,
                         const void* g_hi, const void* g_lo,
                         const void* k_hi, const void* k_lo,
                         const void* v_hi, const void* v_lo,
                         const void* qt_hi, const void* qt_lo,
                         const void* gt_hi, const void* gt_lo,
                         const void* lse, const void* delta, void* dk,
                         void* dv, int B, int H, int nq, int nk, int D,
                         int ld, int ld_stat, float scale, void* stream) {
  if ((D != 40 && D != 64 && D != 80 && D != 160) || B < 1 || H < 1 ||
      B * H > 65535 || nq < 1 || nk < 1 || ld % 4 || ld < H * D ||
      ld_stat % STAT_PAD || ld_stat < nq ||
      reinterpret_cast<uintptr_t>(lse) % 16 ||
      reinterpret_cast<uintptr_t>(delta) % 16)
    return (int)cudaErrorInvalidValue;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const int nqp = (nq + 7) / 8 * 8;
  const int bm = D > 64 ? 64 : 128;  // Shape<D>::BM
  CUtensorMap maps[12];
  const void* kv[4] = {k_hi, k_lo, v_hi, v_lo};
  const void* rows[4] = {q_hi, q_lo, g_hi, g_lo};
  const void* cols[4] = {gt_hi, gt_lo, qt_hi, qt_lo};
  for (int i = 0; i < 4; ++i) {
    if (!encode_heads(fn, &maps[i], kv[i], B, H, nk, D, ld, bm) ||
        !encode_heads(fn, &maps[4 + i], rows[i], B, H, nq, D, ld, BN) ||
        !encode_heads_t(fn, &maps[8 + i], cols[i], B, H, nqp, D, ld))
      return (int)cudaErrorInvalidValue;
  }
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40:
      return (int)launch<40>(maps, ls, dl, dkf, dvf, B, H, nq, nk, ld,
                             ld_stat, scale, st);
    case 64:
      return (int)launch<64>(maps, ls, dl, dkf, dvf, B, H, nq, nk, ld,
                             ld_stat, scale, st);
    case 80:
      return (int)launch<80>(maps, ls, dl, dkf, dvf, B, H, nq, nk, ld,
                             ld_stat, scale, st);
    default:
      return (int)launch<160>(maps, ls, dl, dkf, dvf, B, H, nq, nk, ld,
                              ld_stat, scale, st);
  }
}

}  // extern "C"
