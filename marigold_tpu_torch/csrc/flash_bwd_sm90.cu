// Flash-attention backward for 64-wide heads, designed for Hopper (sm_90a):
// two kernels with no atomics, each built like the forward
// (flash_fwd_sm90.cu): wgmma tensor-core products, TMA loads into a ring of
// shared-memory stages tracked by mbarriers, a producer warp and two
// consumer warpgroups, and every intermediate (S, dP, P, dS) in registers.
//
// Replaces the two backward Pallas kernels of the TPU package's
// marigold_tpu/ops/flash_attention.py:_flash_dt_bwd_pallas (:751):
//   * _flash_bwd_dq_kernel (:650; pallas_call at :800) ->
//     flash_bwd_dq_kernel: one block per (128 query rows, batch*head),
//     streaming K and V;
//   * _flash_bwd_dkv_kernel (:695; pallas_call at :832) ->
//     flash_bwd_dkv_kernel: one block per (128 key rows, batch*head),
//     streaming Q and dO.
// Each output element is written by exactly one block, so the kernels need
// no atomics and give the same bits on every run. The price is S and dP
// computed in both kernels (14 N^2 d FLOPs per head, against 10 N^2 d for a
// fused kernel that adds dQ atomically).
//
// Math per (batch, head), with s = Q K^T * scale and the forward's saved
// natural-log row logsumexp lse:
//   P  = exp(s - lse)             fp32, recomputed as exp2(s * scale * log2e
//                                 - lse * log2e)
//   dP = dO V^T                   fp32
//   dS = bf16(P * (dP - delta))   delta = rowsum(dO * O), fp32, computed
//                                 outside the kernels (ops/flash_attention.py)
//   dQ = dS K * scale,  dK = dS^T Q * scale,  dV = bf16(P)^T dO
// with bf16 operands and fp32 sums, rounding dS and P to bf16 where the TPU
// kernels round them. The dQ kernel masks key columns >= nk to s = -1e30
// (zero-filled K rows would otherwise give P = exp(-lse) != 0). Query rows
// >= nq carry lse = +1e30 and delta = 0 (the wrapper pads both), so their
// P and dS are 0. Rows past nq or nk are computed on TMA's zero fill and
// never stored; an output row depends only on its own row of the register
// operand, so what those rows hold reaches nothing that is stored.
//
// Layout: q/k/v/dO and dQ/dK/dV are [B, N, ld] bf16, head h at channels
// [64h, 64h + 64), each with a 3-D TMA map {ld, N, B}, a {64, rows, 1} box
// at channel 64h and the 128-byte swizzle (one 64-wide bf16 row is one
// swizzle row). lse and delta are [B*H, ld_stat] fp32, ld_stat a multiple
// of 64 at least nq, so that each 64-row stage of the dK/dV kernel finds
// its statistics, padded ones included, in one 256-byte bulk copy.
//
// What bounds it on the H100: per head, the dQ kernel does 6 N^2 d FLOPs
// (S, dP, dQ) and the dK/dV kernel 8 N^2 d (S^T, dP^T, dV, dK) over about
// 4 N d * 2 bytes of inputs each, thousands of FLOPs per byte at N = 4800,
// far above the card's ~295 FLOP/byte ridge: tensor-core bound, with one
// exp2 per 384 (dQ) or 512 (dK/dV) FLOPs of wgmma beside it. The design:
//   * dQ kernel: Q and dO resident (each consumer warpgroup owns 64 query
//     rows), K and V streamed 64 keys per stage. S = Q K^T and dP = dO V^T
//     by wgmma m64n64k16 with both operands K-major in shared memory; P and
//     dS computed on the accumulator registers with the row's lse and delta
//     held in registers; dS packed in place into bf16 A fragments (the
//     accumulator pair (d[2i], d[2i+1]) is A register i); dQ += dS K by the
//     register-A wgmma reading the same K stage MN-major (transpose bit).
//   * dK/dV kernel, computed transposed: K and V resident (64 key rows per
//     consumer warpgroup), Q and dO streamed 64 query rows per stage.
//     S^T = K Q^T and dP^T = V dO^T (K-major); P^T and dS^T with lse and
//     delta per column, read from the stage's shared memory where the
//     producer copied them beside Q and dO; dV += P^T dO and dK += dS^T Q
//     with P^T and dS^T as register A fragments and the dO and Q stages read
//     MN-major. Four fp32 accumulators (S^T, dP^T, dK, dV) of 32 registers.
//   * one producer thread keeps STAGES stages in flight with TMA; the
//     consumers wait on "full" barriers and release "empty" ones (one
//     arrival per warpgroup), with no block-wide barrier in the loop;
//   * per stage a consumer issues S and dP as two commit groups and then
//     the previous stage's gradient products as a third, so that P is
//     computed while dP and those products run, and dS while they finish;
//     every group is waited for within the iteration (a group left in
//     flight across the loop's back edge makes ptxas serialise the wgmmas:
//     C7515);
//   * setmaxnreg moves registers from the producer warpgroup (24) to the
//     consumers (240): one block per SM, 384 threads;
//   * the epilogue stages the bf16 gradients in the warpgroup's idle
//     resident tile (Q, or K and V) for TMA stores, which drop rows past
//     nq or nk.

#include "sm90.cuh"

namespace {

constexpr int D = 64;             // head width
constexpr int BM = 128;           // output rows per block (2 x 64)
constexpr int BN = 64;            // streamed rows per stage
constexpr int STAGES = 4;         // stages in flight
constexpr int CONSUMERS = 2;      // consumer warpgroups
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int ROW_BYTES = D * 2;  // 128: one swizzle row
constexpr int RES_BYTES = BM * ROW_BYTES;   // a resident [128, 64] tile
constexpr int TILE_BYTES = BN * ROW_BYTES;  // a streamed [64, 64] tile
constexpr int STAT_BYTES = BN * 4;          // 64 fp32 row statistics
constexpr int STAT_PAD = 64;                // ld_stat's multiple

// Shared memory: the two resident tiles, the two streamed tiles per stage,
// the statistics per stage (lse then delta; dK/dV kernel only), then the
// barriers; every tile 1024-byte aligned (the 128B swizzle atom).
constexpr int SM_R0 = 0;
constexpr int SM_R1 = RES_BYTES;
constexpr int SM_S0 = 2 * RES_BYTES;
constexpr int SM_S1 = SM_S0 + STAGES * TILE_BYTES;
constexpr int SM_STAT = SM_S1 + STAGES * TILE_BYTES;
constexpr int SM_BAR = SM_STAT + STAGES * 2 * STAT_BYTES;
constexpr int SM_BYTES = SM_BAR + 8 * (2 * STAGES + 1);
constexpr int SMEM_REQUEST = SM_BYTES + 1024;  // room to align the base

constexpr float kNegInf = -1e30f;  // the TPU kernels' NEG_INF
constexpr float kLsePad = 1e30f;   // the TPU wrapper's _LSE_PAD
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Copies `bytes` (a multiple of 16, both ends 16-byte aligned) from global
// to shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// full[STAGES], empty[STAGES] and the resident tiles' barrier, initialised
// by thread 0 (one producer arrival, one per consumer warpgroup) before a
// block-wide barrier.
struct Barriers {
  uint32_t full, empty, res;
  __device__ explicit Barriers(uint32_t base)
      : full(base + SM_BAR), empty(full + 8 * STAGES),
        res(empty + 8 * STAGES) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(full + 8 * s, 1);
        mbar_init(empty + 8 * s, CONSUMERS);
      }
      mbar_init(res, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
};

// The producer (thread 0): the block's two resident [128, 64] tiles at row
// m0, then, per stage, the two streamed [64, 64] tiles of rows it * 64 and,
// with `lse` (the dK/dV kernel), their lse and delta rows.
__device__ __forceinline__ void produce(
    uint32_t base, const Barriers& bar, const CUtensorMap* res0,
    const CUtensorMap* res1, const CUtensorMap* str0, const CUtensorMap* str1,
    int h, int m0, int b, int n_tiles, const float* lse, const float* delta) {
  mbar_expect_tx(bar.res, 2 * RES_BYTES);
  tma_load(base + SM_R0, res0, h * D, m0, b, bar.res);
  tma_load(base + SM_R1, res1, h * D, m0, b, bar.res);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES;
    const uint32_t full = bar.full + 8 * st;
    if (it >= STAGES) mbar_wait(bar.empty + 8 * st, ((it / STAGES) - 1) & 1);
    mbar_expect_tx(full, 2 * TILE_BYTES + (lse ? 2 * STAT_BYTES : 0));
    tma_load(base + SM_S0 + st * TILE_BYTES, str0, h * D, it * BN, b, full);
    tma_load(base + SM_S1 + st * TILE_BYTES, str1, h * D, it * BN, b, full);
    if (lse) {
      const uint32_t stat = base + SM_STAT + st * 2 * STAT_BYTES;
      bulk_load(stat, lse + it * BN, STAT_BYTES, full);
      bulk_load(stat + STAT_BYTES, delta + it * BN, STAT_BYTES, full);
    }
  }
}

// x = A B^T over the head's 64 columns: A this warpgroup's 64 rows, B a
// stage's 64 rows, both K-major tiles in shared memory. One commit group.
__device__ __forceinline__ void issue_nt(float (&x)[32], uint32_t a,
                                         uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n64k16_ss(x, kmajor_desc(a + 32 * kk), kmajor_desc(b + 32 * kk),
                       kk);
  wgmma_commit();
}

// acc += A B over a 64-deep reduction: A the bf16 fragments `a` (k16 step kk
// in a[4kk..4kk+3]), B a stage's [64, 64] tile read MN-major (its rows are
// the reduction). No fence or commit.
__device__ __forceinline__ void issue_nn(float (&acc)[32],
                                         const uint32_t (&a)[16],
                                         uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_m64n64k16_rs(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                       a[4 * kk + 3], mnmajor_desc(tile + 2048 * kk));
}

// Writes acc * mul as bf16 into a [64, 64] tile in the 128-byte swizzle (row
// r's 16-byte chunk j at r * 128 + ((j ^ r % 8) << 4)), this thread's rows
// r0 and r0 + 8.
__device__ __forceinline__ void stage_out(unsigned char* tile,
                                          const float (&acc)[32], float mul,
                                          int r0, int col) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const uint32_t off = (static_cast<uint32_t>(j ^ (r0 & 7)) << 4) + 2 * col;
    *reinterpret_cast<uint32_t*>(tile + r0 * ROW_BYTES + off) =
        pack_bf16(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    *reinterpret_cast<uint32_t*>(tile + (r0 + 8) * ROW_BYTES + off) =
        pack_bf16(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// Accumulator layout of wgmma m64nN (per warpgroup thread t, warp w = t/32,
// lane l): d[4j + e] is row 16w + l/4, column 8j + 2(l%4) + e, and
// d[4j + 2 + e] the same columns of row 16w + l/4 + 8 (e in {0, 1}). The A
// fragment of a k16 step kk takes columns 16kk..16kk+15 in the same rows,
// so the bf16 pair (d[2i], d[2i+1]) is A register i: P and dS need no
// shuffle.
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_g,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_dq,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, int H, int ld_stat,
                    int nq, int nk, float scale, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const Barriers bar(base);
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BM;
  const int n_tiles = cdiv(nk, BN);

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0)
      produce(base, bar, &tm_q, &tm_g, &tm_k, &tm_v, h, q0, b, n_tiles,
              nullptr, nullptr);
    return;
  }

  // Consumer warpgroup c owns query rows [64c, 64c + 64) of the block.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;  // this thread's rows: r0, r0 + 8
  const int col = 2 * (lane % 4);           // its column pair in each 8
  const uint32_t q_tile = base + SM_R0 + c * 64 * ROW_BYTES;
  const uint32_t g_tile = base + SM_R1 + c * 64 * ROW_BYTES;

  // The rows' statistics; rows past nq take lse = +1e30, delta = 0.
  const int qr = q0 + 64 * c + r0;
  const float* lse_r = lse + (size_t)bh * ld_stat;
  const float* dl_r = delta + (size_t)bh * ld_stat;
  const float nl0 = qr < nq ? -lse_r[qr] * kLog2e : -kLsePad * kLog2e;
  const float nl1 = qr + 8 < nq ? -lse_r[qr + 8] * kLog2e : -kLsePad * kLog2e;
  const float dl0 = qr < nq ? dl_r[qr] : 0.f;
  const float dl1 = qr + 8 < nq ? dl_r[qr + 8] : 0.f;

  float s[32], dp[32], dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  uint32_t ds[16];

  // P = exp2(s * scale * log2e - lse * log2e) of stage `it` in place, key
  // columns >= nk masked on the ragged last stage.
  auto probabilities = [&](int it) {
    const int k0 = it * BN;
    if (k0 + BN > nk) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (k0 + 8 * j + col + e >= nk) {
            s[4 * j + e] = kNegInf;
            s[4 * j + 2 + e] = kNegInf;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * j + e] = ex2(fmaf(s[4 * j + e], scale_log2, nl0));
        s[4 * j + 2 + e] = ex2(fmaf(s[4 * j + 2 + e], scale_log2, nl1));
      }
    }
  };
  // dS = P (dP - delta) in place.
  auto grad_logits = [&]() {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * j + e] *= dp[4 * j + e] - dl0;
        s[4 * j + 2 + e] *= dp[4 * j + 2 + e] - dl1;
      }
    }
  };
  // dS into the bf16 A fragments of dQ += dS K.
  auto pack = [&]() {
#pragma unroll
    for (int i = 0; i < 16; ++i) ds[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
  };
  auto issue_dq = [&](int st) {
    fence_regs(dq);
    fence_regs(ds);
    wgmma_fence();
    issue_nn(dq, ds, base + SM_S0 + st * TILE_BYTES);
    wgmma_commit();
  };

  // Stage 0: S and dP as two commit groups, P while dP runs.
  mbar_wait(bar.res, 0);
  mbar_wait(bar.full, 0);
  issue_nt(s, q_tile, base + SM_S0);
  issue_nt(dp, g_tile, base + SM_S1);
  wgmma_wait<1>();
  fence_regs(s);
  probabilities(0);
  wgmma_wait<0>();
  fence_regs(dp);
  grad_logits();
  pack();

  // Stage it: S, dP and the previous stage's dQ += dS K (its K read
  // MN-major) in flight as three groups; P as soon as S is done, dS once dP
  // is, and the previous stage released once its dQ product is. No group
  // stays in flight across iterations.
  for (int it = 1; it < n_tiles; ++it) {
    const int st = it % STAGES;
    const int pst = (it - 1) % STAGES;
    mbar_wait(bar.full + 8 * st, (it / STAGES) & 1);
    issue_nt(s, q_tile, base + SM_S0 + st * TILE_BYTES);
    issue_nt(dp, g_tile, base + SM_S1 + st * TILE_BYTES);
    issue_dq(pst);
    wgmma_wait<2>();
    fence_regs(s);
    probabilities(it);
    wgmma_wait<1>();
    fence_regs(dp);
    grad_logits();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(ds);
    if (t == 0) mbar_arrive(bar.empty + 8 * pst);
    pack();
  }
  issue_dq((n_tiles - 1) % STAGES);
  wgmma_wait<0>();
  fence_regs(dq);

  // Stage bf16 dQ * scale in this warpgroup's Q rows (its last S product
  // has completed), then one TMA store; rows past nq are dropped.
  stage_out(smem_raw + (q_tile - smem_u32(smem_raw)), dq, scale, r0, col);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_barrier(1 + c, 128);
  if (t == 0 && q0 + 64 * c < nq)
    tma_store(&tm_dq, q_tile, h * D, q0 + 64 * c, b);
}

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_g,
                     const __grid_constant__ CUtensorMap tm_dk,
                     const __grid_constant__ CUtensorMap tm_dv,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, int H, int ld_stat,
                     int nq, int nk, float scale, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const Barriers bar(base);
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * BM;
  const int n_tiles = cdiv(nq, BN);

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0)
      produce(base, bar, &tm_k, &tm_v, &tm_q, &tm_g, h, k0, b, n_tiles,
              lse + (size_t)bh * ld_stat, delta + (size_t)bh * ld_stat);
    return;
  }

  // Consumer warpgroup c owns key rows [64c, 64c + 64) of the block; its
  // accumulator columns are the stage's query rows.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  const uint32_t k_tile = base + SM_R0 + c * 64 * ROW_BYTES;
  const uint32_t v_tile = base + SM_R1 + c * 64 * ROW_BYTES;
  const unsigned char* stats =
      smem_raw + (base + SM_STAT - smem_u32(smem_raw));

  float s[32], dp[32], dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  uint32_t pt[16], dst[16];

  // P^T = exp2(s * scale * log2e - lse * log2e) of stage st in place, lse
  // per column (query row) from the stage's copy; padded query rows hold
  // lse = +1e30.
  auto probabilities = [&](int st) {
    const float2* lse2 =
        reinterpret_cast<const float2*>(stats + st * 2 * STAT_BYTES);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 l = lse2[(8 * j + col) / 2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float nl = -(e ? l.y : l.x) * kLog2e;
        s[4 * j + e] = ex2(fmaf(s[4 * j + e], scale_log2, nl));
        s[4 * j + 2 + e] = ex2(fmaf(s[4 * j + 2 + e], scale_log2, nl));
      }
    }
  };
  // dS^T = P^T (dP^T - delta) in place in dp, delta per column (0 on
  // padded rows).
  auto grad_logits = [&](int st) {
    const float2* dl2 =
        reinterpret_cast<const float2*>(stats + (2 * st + 1) * STAT_BYTES);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 dl = dl2[(8 * j + col) / 2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = e ? dl.y : dl.x;
        dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - d);
        dp[4 * j + 2 + e] = s[4 * j + 2 + e] * (dp[4 * j + 2 + e] - d);
      }
    }
  };
  // P^T and dS^T into the bf16 A fragments of the gradient products.
  auto pack = [&]() {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      pt[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
      dst[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);
    }
  };
  // dV += P^T dO and dK += dS^T Q on stage st's dO and Q read MN-major, one
  // commit group.
  auto issue_grads = [&](int st) {
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(pt);
    fence_regs(dst);
    wgmma_fence();
    issue_nn(dv, pt, base + SM_S1 + st * TILE_BYTES);
    issue_nn(dk, dst, base + SM_S0 + st * TILE_BYTES);
    wgmma_commit();
  };

  // Stage 0: S^T and dP^T as two commit groups, P^T while dP^T runs.
  mbar_wait(bar.res, 0);
  mbar_wait(bar.full, 0);
  issue_nt(s, k_tile, base + SM_S0);
  issue_nt(dp, v_tile, base + SM_S1);
  wgmma_wait<1>();
  fence_regs(s);
  probabilities(0);
  wgmma_wait<0>();
  fence_regs(dp);
  grad_logits(0);
  pack();

  // Stage it: S^T, dP^T and the previous stage's dV and dK products in
  // flight as three groups; the previous stage released once its gradient
  // products are done. No group stays in flight across iterations.
  for (int it = 1; it < n_tiles; ++it) {
    const int st = it % STAGES;
    const int pst = (it - 1) % STAGES;
    mbar_wait(bar.full + 8 * st, (it / STAGES) & 1);
    issue_nt(s, k_tile, base + SM_S0 + st * TILE_BYTES);
    issue_nt(dp, v_tile, base + SM_S1 + st * TILE_BYTES);
    issue_grads(pst);
    wgmma_wait<2>();
    fence_regs(s);
    probabilities(st);
    wgmma_wait<1>();
    fence_regs(dp);
    grad_logits(st);
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(pt);
    fence_regs(dst);
    if (t == 0) mbar_arrive(bar.empty + 8 * pst);
    pack();
  }
  issue_grads((n_tiles - 1) % STAGES);
  wgmma_wait<0>();
  fence_regs(dk);
  fence_regs(dv);

  // Stage bf16 dK * scale and dV in this warpgroup's K and V rows (idle
  // since its last S^T and dP^T), then two TMA stores; rows past nk are
  // dropped.
  stage_out(smem_raw + (k_tile - smem_u32(smem_raw)), dk, scale, r0, col);
  stage_out(smem_raw + (v_tile - smem_u32(smem_raw)), dv, 1.f, r0, col);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_barrier(1 + c, 128);
  if (t == 0 && k0 + 64 * c < nk) {
    tma_store(&tm_dk, k_tile, h * D, k0 + 64 * c, b);
    tma_store(&tm_dv, v_tile, h * D, k0 + 64 * c, b);
  }
}

// A map of a [B, N, ld] bf16 tensor with a {64, rows, 1} box.
bool encode(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, int B, int N,
            int ld, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)ld, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)N * ld * 2};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)rows, 1};
  return encode_bf16_sw128(fn, map, ptr, 3, dims, strides, box);
}

// What both entry points check: a 64-wide head, TMA's 16-byte row strides,
// statistics rows covering every 64-row stage, 16-byte aligned statistics.
int check_args(int B, int H, int nq, int nk, int D_, int ldq, int ldkv,
               int ld_stat, const void* lse, const void* delta) {
  if (D_ != D || B < 1 || H < 1 || nq < 1 || nk < 1 || ldq % 8 || ldkv % 8 ||
      ld_stat % STAT_PAD || ld_stat < nq ||
      reinterpret_cast<uintptr_t>(lse) % 16 ||
      reinterpret_cast<uintptr_t>(delta) % 16)
    return (int)cudaErrorInvalidValue;
  return encode_tiled() == nullptr ? (int)cudaErrorNotSupported : 0;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_REQUEST);
}

}  // namespace

extern "C" {

// dQ of the attention backward. q/g/dq: [B, nq, ldq] bf16; k/v: [B, nk,
// ldkv] bf16; all 16-byte aligned with row strides a multiple of 8
// elements. lse/delta: [B*H, ld_stat] fp32, ld_stat a multiple of 64 and
// at least nq, rows past nq padded with lse = +1e30 and delta = 0. Returns
// cudaSuccess (0) or the error of the checks, the map encoding, the
// attribute call or the launch.
int mt_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                              const void* g, const void* lse,
                              const void* delta, void* dq, int B, int H,
                              int nq, int nk, int D_, int ldq, int ldkv,
                              int ld_stat, float scale, void* stream) {
  int err = check_args(B, H, nq, nk, D_, ldq, ldkv, ld_stat, lse, delta);
  if (err) return err;
  const EncodeTiledFn fn = encode_tiled();
  CUtensorMap maps[5];
  if (!encode(fn, &maps[0], q, B, nq, ldq, BM) ||
      !encode(fn, &maps[1], g, B, nq, ldq, BM) ||
      !encode(fn, &maps[2], k, B, nk, ldkv, BN) ||
      !encode(fn, &maps[3], v, B, nk, ldkv, BN) ||
      !encode(fn, &maps[4], dq, B, nq, ldq, 64))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = prepare(flash_bwd_dq_kernel);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(cdiv(nq, BM), B * H);
  flash_bwd_dq_kernel<<<grid, THREADS, SMEM_REQUEST,
                        static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4],
      static_cast<const float*>(lse), static_cast<const float*>(delta), H,
      ld_stat, nq, nk, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

// dK and dV of the attention backward; dk/dv: [B, nk, ldkv] bf16, the
// other arguments as for mt_flash_attention_bwd_dq.
int mt_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                               const void* g, const void* lse,
                               const void* delta, void* dk, void* dv, int B,
                               int H, int nq, int nk, int D_, int ldq,
                               int ldkv, int ld_stat, float scale,
                               void* stream) {
  int err = check_args(B, H, nq, nk, D_, ldq, ldkv, ld_stat, lse, delta);
  if (err) return err;
  const EncodeTiledFn fn = encode_tiled();
  CUtensorMap maps[6];
  if (!encode(fn, &maps[0], k, B, nk, ldkv, BM) ||
      !encode(fn, &maps[1], v, B, nk, ldkv, BM) ||
      !encode(fn, &maps[2], q, B, nq, ldq, BN) ||
      !encode(fn, &maps[3], g, B, nq, ldq, BN) ||
      !encode(fn, &maps[4], dk, B, nk, ldkv, 64) ||
      !encode(fn, &maps[5], dv, B, nk, ldkv, 64))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = prepare(flash_bwd_dkv_kernel);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(cdiv(nk, BM), B * H);
  flash_bwd_dkv_kernel<<<grid, THREADS, SMEM_REQUEST,
                         static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5],
      static_cast<const float*>(lse), static_cast<const float*>(delta), H,
      ld_stat, nq, nk, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

const char* mt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
