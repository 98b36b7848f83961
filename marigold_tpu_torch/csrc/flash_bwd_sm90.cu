// Flash-attention backward for heads 40, 64, 80 and 160 wide (a template on
// the head width D), designed for Hopper (sm_90a): two kernels with no
// atomics, each built like the forward (flash_fwd_sm90.cu): wgmma
// tensor-core products, TMA loads into a ring of shared-memory stages
// tracked by mbarriers, a producer warp and two consumer warpgroups, and
// every intermediate (S, dP, P, dS) in registers.
//
// Replaces the two backward Pallas kernels of the TPU package's
// marigold_tpu/ops/flash_attention.py:_flash_dt_bwd_pallas (:751) at those
// widths (SD2's 64-wide heads; the 40-, 80- and 160-wide heads of an
// SD1.x-class UNet, 320, 640 and 1280 channels over 8 heads), and the row
// statistics that wrapper computes before them (:764-776: delta =
// rowsum(dO o O), lse and delta padded with _LSE_PAD and 0):
//   * _flash_bwd_dq_kernel (:650; pallas_call at :800) and the statistics
//     -> flash_bwd_dq_kernel: one block per (128 query rows, batch*head),
//     streaming K and V;
//   * _flash_bwd_dkv_kernel (:695; pallas_call at :832) ->
//     flash_bwd_dkv_kernel: one block per (128 key rows, or 64 at D = 80
//     and 160, batch*head), streaming Q and dO.
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
//                                 by the dQ kernel (below)
//   dQ = dS K * scale,  dK = dS^T Q * scale,  dV = bf16(P)^T dO
// with bf16 operands and fp32 sums, rounding dS and P to bf16 where the TPU
// kernels round them. The dQ kernel masks key columns >= nk to s = -1e30
// (zero-filled K rows would otherwise give P = exp(-lse) != 0). Query rows
// >= nq carry lse = +1e30 and delta = 0 (the dQ kernel pads both), so their
// P and dS are 0. Rows past nq or nk are computed on TMA's zero fill and
// never stored; an output row depends only on its own row of the register
// operand, so what those rows hold reaches nothing that is stored.
//
// Row statistics: in its prologue each dQ consumer thread computes delta
// of its two query rows in fp32 from plain 16-byte loads of O and dO (the
// four lanes that share a row take every fourth 8-column chunk of it, then
// a two-shuffle sum), reads their lse from the forward's [B*H, nq] rows,
// and writes the padded [B*H, ld_stat] lse and delta rows the dK/dV kernel
// reads (lse 1e30 and delta 0 from nq to ld_stat, as the TPU wrapper pads
// them; the last block's rows past ld_stat are not written). So a backward
// is two launches, the dK/dV one after the dQ one on the stream.
//
// Layout: q/k/v/dO and dQ/dK/dV are [B, N, ld] bf16, head h at channels
// [Dh, Dh + D). Each tensor has a 4-D TMA map {D, H, N, B} (head stride D,
// row stride ld), a {64, 1, rows, 1} box and the 128-byte swizzle, as the
// forward's maps: one 64-wide bf16 row is one swizzle atom, a head wider
// than 64 takes ATOMS = ceil(D / 64) boxes side by side, each its own
// [rows, 128 B] block of shared memory, and a box's lanes past D lie
// outside the map: zeros on a load (never the next head's lanes), dropped
// on a store. S and dP contract over KSTEPS = ceil(D / 16) k16 steps (the
// lanes past D zero in both operands); each gradient product runs one
// m64n64 product per atom, its columns past D computed on zeros and never
// stored. The padded lse and delta are [B*H, ld_stat] fp32, ld_stat = nq
// rounded up to 64, so that each 64-row stage of the dK/dV kernel finds
// its statistics, padded ones included, in one 256-byte bulk copy.
//
// What bounds it on the H100: per head, the dQ kernel does 6 N^2 d FLOPs
// (S, dP, dQ) and the dK/dV kernel 8 N^2 d (S^T, dP^T, dV, dK) over about
// 4 N d * 2 bytes of inputs each, thousands of FLOPs per byte at N = 4800,
// far above the card's ~295 FLOP/byte ridge: tensor-core bound at d = 64,
// with one exp2 per 384 (dQ) or 512 (dK/dV) FLOPs of wgmma beside it; at
// d = 40 the exponentials (one per logit in each kernel, 16 per SM per
// clock) take about as long as the products. The design:
//   * dQ kernel: Q and dO resident (each consumer warpgroup owns 64 query
//     rows), K and V streamed 64 keys per stage. S = Q K^T and dP = dO V^T
//     by wgmma m64n64k16 with both operands K-major in shared memory; P and
//     dS computed on the accumulator registers with the row's lse and delta
//     held in registers; dS packed in place into bf16 A fragments (the
//     accumulator pair (d[2i], d[2i+1]) is A register i); dQ += dS K by the
//     register-A wgmma reading the same K stage MN-major (transpose bit),
//     one m64n64 per atom. Registers per consumer thread: S and dP (32
//     each), dQ (32 per atom), dS (16): 176 at D = 160.
//   * dK/dV kernel, computed transposed: K and V resident, Q and dO
//     streamed 64 query rows per stage. S^T = K Q^T and dP^T = V dO^T
//     (K-major); P^T and dS^T with lse and delta per column, read from the
//     stage's shared memory where the producer copied them beside Q and
//     dO; dV += P^T dO and dK += dS^T Q with P^T and dS^T as register A
//     fragments and the dO and Q stages read MN-major. At D <= 64 each
//     consumer owns 64 key rows and holds four fp32 accumulators (S^T,
//     dP^T, dK, dV) of 32 registers. At D = 80 and 160 dK and dV take 64
//     or 96 registers each, which with S^T, dP^T and the fragments is more
//     than setmaxnreg's 240 (SPLIT): the block owns 64 keys, one consumer
//     computes S^T, dP^T and dK, the other S^T again and dV (S^T 32, dK or
//     dV 32 per atom, dP^T 32, fragments 16: 176 at D = 160);
//   * one producer thread keeps STAGES stages in flight with TMA; the
//     consumers wait on "full" barriers and release "empty" ones (one
//     arrival per warpgroup), with no block-wide barrier in the loop;
//   * per stage a consumer issues S and dP as two commit groups and then
//     the previous stage's gradient products as a third, so that P is
//     computed while dP and those products run, and dS while they finish;
//     every group is waited for within the iteration (a group left in
//     flight across the loop's back edge makes ptxas serialise the wgmmas:
//     C7515);
//   * ping-pong (Tune, below): the two consumers take turns through two
//     named barriers to issue a stage's products, so that one's
//     exponentials and dS run while the tensor cores work through the
//     other's products, instead of both issuing together and then both
//     computing their exponentials together. Every block's consumers walk
//     the same number of stages (past-nq or past-nk rows included), so
//     both take the same number of turns. It moves when a product is
//     issued, never what it sums: the bits are the same either way;
//   * setmaxnreg moves registers from the producer warpgroup (24) to the
//     consumers (240): one block per SM, 384 threads;
//   * the epilogue stages the bf16 gradients in an idle resident tile (Q,
//     or K and V) for TMA stores, which drop rows past nq or nk and lanes
//     past D.
// Measured on the H100 (flash_bwd_variants.py's probes, PERF.md, section
// 6): at d = 64 and 40 the kernels are bound by their m64n64 products;
// taking the exponentials out saves under 10%, the streamed loads under
// 3%. At d = 40 the loads alone would take longer than at 64 (the boxes'
// 24 lanes past the head are zero-filled), but the products hide them.
// Shared memory: two resident tiles (rows x 128 B per atom each) and
// STAGES stages of two [64, 128 B] tiles per atom plus 512 B of
// statistics: STAGES = 4 but at D = 160, whose dQ takes 2 (96 KB resident,
// 48 KB a stage) and dK/dV 3 (48 KB resident at 64 keys).

#include "sm90.cuh"

namespace {

constexpr int BN = 64;            // streamed rows per stage
constexpr int CONSUMERS = 2;      // consumer warpgroups
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int ROW_BYTES = 128;    // one 64-lane bf16 swizzle atom row
constexpr int TILE_ATOM = BN * ROW_BYTES;   // one atom of a streamed tile
constexpr int STAT_BYTES = BN * 4;          // 64 fp32 row statistics
constexpr int STAT_PAD = 64;                // ld_stat's multiple
constexpr int SMEM_LIMIT = 232448;          // what a block can use
constexpr int TURN_BAR = 4;  // ping-pong's named barriers, 4 and 5 (0 is
                             // __syncthreads', 1 to 3 the epilogues')

// The shared-memory plan of a kernel at head width D whose two resident
// tiles hold RES_ROWS rows: the resident tiles, the two streamed tiles per
// stage, the statistics per stage (lse then delta; dK/dV kernel only),
// then the barriers; every tile 1024-byte aligned (the 128B swizzle atom).
template <int D, int RES_ROWS>
struct Plan {
  static_assert(D % 8 == 0 && D <= 192, "D a multiple of 8, at most 3 atoms");
  static constexpr int ATOMS = (D + 63) / 64;   // 64-lane boxes per row
  static constexpr int KSTEPS = (D + 15) / 16;  // k16 steps of S and dP
  static constexpr int RES_ATOM = RES_ROWS * ROW_BYTES;
  static constexpr int RES_BYTES = ATOMS * RES_ATOM;
  static constexpr int TILE_BYTES = ATOMS * TILE_ATOM;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - 8 * 9 - 2 * RES_BYTES) /
                             (2 * TILE_BYTES + 2 * STAT_BYTES);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;  // stages in flight
  static_assert(STAGES >= 2, "two stages fit");
  static constexpr int SM_R0 = 0;
  static constexpr int SM_R1 = RES_BYTES;
  static constexpr int SM_S0 = 2 * RES_BYTES;
  static constexpr int SM_S1 = SM_S0 + STAGES * TILE_BYTES;
  static constexpr int SM_STAT = SM_S1 + STAGES * TILE_BYTES;
  static constexpr int SM_BAR = SM_STAT + STAGES * 2 * STAT_BYTES;
  static constexpr int SM_BYTES = SM_BAR + 8 * (2 * STAGES + 1);
  static constexpr int SMEM_REQUEST = SM_BYTES + 1024;  // room to align
  static_assert(SMEM_REQUEST <= SMEM_LIMIT, "fits the 227 KB a block can use");
};

// dK and dV on separate consumers, the block owning 64 keys (see above).
template <int D>
constexpr bool kSplit = D > 64;
template <int D>
constexpr int kDkvRows = kSplit<D> ? 64 : 128;  // key rows per dK/dV block
constexpr int BM_DQ = 128;                      // query rows per dQ block

// The schedule of each kernel at head width D, each choice measured to win
// where it is taken (flash_bwd_variants.py; PERF.md, section 6):
//   * PINGPONG: the two consumers take turns to issue (see above), or both
//     issue together. dQ at D <= 80 (12-16% faster at 40 and 64, 15% at
//     80); at 160 the two are level and dQ keeps issuing together. dK/dV
//     at D <= 64 (6-7% faster); its SPLIT consumers at 80 and 160 do
//     different work per stage and never ping-pong.
//   * AREG: S and dP take their A operand (this consumer's 64 rows of the
//     two resident tiles) from registers loaded once, so that those
//     products read only their B stage from shared memory: dQ at 64 and
//     80 (2-4% faster; at 40 it is 1% slower, at 160 the registers are
//     not there) and dK/dV at D <= 64 (4-9% faster).
// FLASH_BWD_PINGPONG and FLASH_BWD_AREG (0 or 1, nvcc -D switches of
// flash_bwd_variants.py; nothing else defines them) set the one or the
// other for every kernel and width where it applies, to measure them.
template <int D>
struct Tune {
#ifdef FLASH_BWD_PINGPONG
  static constexpr bool DQ_PINGPONG = FLASH_BWD_PINGPONG != 0;
  static constexpr bool DKV_PINGPONG = FLASH_BWD_PINGPONG != 0 && !kSplit<D>;
#else
  static constexpr bool DQ_PINGPONG = D <= 80;
  static constexpr bool DKV_PINGPONG = !kSplit<D>;
#endif
#ifdef FLASH_BWD_AREG
  static constexpr bool DQ_AREG = FLASH_BWD_AREG != 0 && D <= 80;
  static constexpr bool DKV_AREG = FLASH_BWD_AREG != 0 && !kSplit<D>;
#else
  static constexpr bool DQ_AREG = D == 64 || D == 80;
  static constexpr bool DKV_AREG = !kSplit<D>;
#endif
};

constexpr float kNegInf = -1e30f;  // the TPU kernels' NEG_INF
constexpr float kLsePad = 1e30f;   // the TPU wrapper's _LSE_PAD
constexpr float kLog2e = 1.4426950408889634f;

// FLASH_BWD_PROBE_NO_EXP, _NO_LOGIT_MMA, _NO_GRAD_MMA and _NO_LOAD (nvcc
// -D switches of flash_bwd_variants.py's probes; nothing else defines
// them) take the exponentials, the S and dP products, the gradient
// products or the streamed stages' loads out of both kernels, to see what
// their time goes to; the outputs are then wrong.
__device__ __forceinline__ float ex2(float x) {
#ifdef FLASH_BWD_PROBE_NO_EXP
  return x;
#else
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
#endif
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The fp32 sum of o[i] * g[i] over the 8-column chunks part, part + 4,
// part + 8, ... of a D-wide bf16 row (16-byte aligned), one lane's share
// of delta = rowsum(dO o O).
template <int D>
__device__ __forceinline__ float row_dot(const __nv_bfloat16* o,
                                         const __nv_bfloat16* g, int part) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < (D / 8 + 3) / 4; ++i) {
    const int j = part + 4 * i;
    if (j < D / 8) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(o + 8 * j));
      const uint4 y = __ldg(reinterpret_cast<const uint4*>(g + 8 * j));
      const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(x2[e]);
        const float2 b = __bfloat1622float2(y2[e]);
        acc = fmaf(a.x, b.x, acc);
        acc = fmaf(a.y, b.y, acc);
      }
    }
  }
  return acc;
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
template <class P>
struct Barriers {
  uint32_t full, empty, res;
  __device__ explicit Barriers(uint32_t base)
      : full(base + P::SM_BAR), empty(full + 8 * P::STAGES),
        res(empty + 8 * P::STAGES) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < P::STAGES; ++s) {
        mbar_init(full + 8 * s, 1);
        mbar_init(empty + 8 * s, CONSUMERS);
      }
      mbar_init(res, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
};

// The producer (thread 0): the block's two resident tiles at row m0 (one
// box per atom), then, per stage, the two streamed tiles of rows it * 64
// and, with `lse` (the dK/dV kernel), their lse and delta rows.
template <class P>
__device__ __forceinline__ void produce(
    uint32_t base, const Barriers<P>& bar, const CUtensorMap* res0,
    const CUtensorMap* res1, const CUtensorMap* str0, const CUtensorMap* str1,
    int h, int m0, int b, int n_tiles, const float* lse, const float* delta) {
  mbar_expect_tx(bar.res, 2 * P::RES_BYTES);
#pragma unroll
  for (int a = 0; a < P::ATOMS; ++a) {
    tma_load_4d(base + P::SM_R0 + a * P::RES_ATOM, res0, 64 * a, h, m0, b,
                bar.res);
    tma_load_4d(base + P::SM_R1 + a * P::RES_ATOM, res1, 64 * a, h, m0, b,
                bar.res);
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % P::STAGES;
    const uint32_t full = bar.full + 8 * st;
    if (it >= P::STAGES)
      mbar_wait(bar.empty + 8 * st, ((it / P::STAGES) - 1) & 1);
#ifdef FLASH_BWD_PROBE_NO_LOAD
    mbar_expect_tx(full, 0);
    continue;
#endif
    mbar_expect_tx(full, 2 * P::TILE_BYTES + (lse ? 2 * STAT_BYTES : 0));
#pragma unroll
    for (int a = 0; a < P::ATOMS; ++a) {
      const uint32_t off = st * P::TILE_BYTES + a * TILE_ATOM;
      tma_load_4d(base + P::SM_S0 + off, str0, 64 * a, h, it * BN, b, full);
      tma_load_4d(base + P::SM_S1 + off, str1, 64 * a, h, it * BN, b, full);
    }
    if (lse) {
      const uint32_t stat = base + P::SM_STAT + st * 2 * STAT_BYTES;
      bulk_load(stat, lse + it * BN, STAT_BYTES, full);
      bulk_load(stat + STAT_BYTES, delta + it * BN, STAT_BYTES, full);
    }
  }
}

// x = A B^T over the head's D columns: A this warpgroup's 64 rows of a
// resident tile (atom 0 at `a`), B a stage's 64 rows (atom 0 at `b`), both
// K-major in shared memory. One commit group.
template <class P>
__device__ __forceinline__ void issue_nt(float (&x)[32], uint32_t a,
                                         uint32_t b) {
  wgmma_fence();
#ifndef FLASH_BWD_PROBE_NO_LOGIT_MMA
#pragma unroll
  for (int kk = 0; kk < P::KSTEPS; ++kk) {
    const uint32_t off = 32 * (kk % 4);
    wgmma_m64n64k16_ss(x, kmajor_desc(a + (kk / 4) * P::RES_ATOM + off),
                       kmajor_desc(b + (kk / 4) * TILE_ATOM + off), kk);
  }
#endif
  wgmma_commit();
}

// The bf16 A fragments of this warpgroup's 64 rows of a resident tile over
// the head's KSTEPS k16 steps (step kk in a[4kk..4kk+3], the layout of
// issue_nn's `a`), read from the tile's 128-byte swizzle; `tile` is atom
// 0 of those rows, atoms RES_ATOM apart; lanes past D read TMA's zeros.
template <class P>
__device__ __forceinline__ void load_a(uint32_t (&a)[4 * P::KSTEPS],
                                       const unsigned char* tile,
                                       int r0, int lane) {
#pragma unroll
  for (int kk = 0; kk < P::KSTEPS; ++kk) {
    const unsigned char* atom = tile + (kk / 4) * P::RES_ATOM;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int j = 2 * (kk % 4) + hf;  // the 16-byte chunk of the row
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = r0 + 8 * rr;
        a[4 * kk + 2 * hf + rr] = *reinterpret_cast<const uint32_t*>(
            atom + row * ROW_BYTES + ((j ^ (row & 7)) << 4) + 4 * (lane % 4));
      }
    }
  }
}

// x = A B^T as issue_nt, A from load_a's fragments. One commit group.
template <class P>
__device__ __forceinline__ void issue_nt_rs(float (&x)[32],
                                            const uint32_t (&a)[4 * P::KSTEPS],
                                            uint32_t b) {
  wgmma_fence();
#ifndef FLASH_BWD_PROBE_NO_LOGIT_MMA
#pragma unroll
  for (int kk = 0; kk < P::KSTEPS; ++kk)
    wgmma_m64n64k16_rs_nt(x, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                          a[4 * kk + 3],
                          kmajor_desc(b + (kk / 4) * TILE_ATOM + 32 * (kk % 4)),
                          kk);
#endif
  wgmma_commit();
}

// acc[atom] += A B over a 64-deep reduction: A the bf16 fragments `a` (k16
// step kk in a[4kk..4kk+3]), B a stage's [64, 64] tile of each atom read
// MN-major (its rows are the reduction). No fence or commit.
template <int ATOMS>
__device__ __forceinline__ void issue_nn(float (&acc)[ATOMS][32],
                                         const uint32_t (&a)[16],
                                         uint32_t tile) {
#ifndef FLASH_BWD_PROBE_NO_GRAD_MMA
#pragma unroll
  for (int at = 0; at < ATOMS; ++at) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_m64n64k16_rs(acc[at], a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                         a[4 * kk + 3],
                         mnmajor_desc(tile + at * TILE_ATOM + 2048 * kk));
  }
#endif
}

template <int ATOMS>
__device__ __forceinline__ void fence_atoms(float (&acc)[ATOMS][32]) {
#pragma unroll
  for (int at = 0; at < ATOMS; ++at) fence_regs(acc[at]);
}

// Writes acc * mul as bf16 into a resident tile (atom at `tile + at *
// atom_bytes`) in the 128-byte swizzle (row r's 16-byte chunk j at r * 128
// + ((j ^ r % 8) << 4)), this thread's rows r0 and r0 + 8.
template <int ATOMS>
__device__ __forceinline__ void stage_out(unsigned char* tile,
                                          int atom_bytes,
                                          const float (&acc)[ATOMS][32],
                                          float mul, int r0, int col) {
#pragma unroll
  for (int at = 0; at < ATOMS; ++at) {
    unsigned char* atom = tile + at * atom_bytes;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t off =
          (static_cast<uint32_t>(j ^ (r0 & 7)) << 4) + 2 * col;
      *reinterpret_cast<uint32_t*>(atom + r0 * ROW_BYTES + off) =
          pack_bf16(acc[at][4 * j] * mul, acc[at][4 * j + 1] * mul);
      *reinterpret_cast<uint32_t*>(atom + (r0 + 8) * ROW_BYTES + off) =
          pack_bf16(acc[at][4 * j + 2] * mul, acc[at][4 * j + 3] * mul);
    }
  }
}

// P^T = exp2(s * scale * log2e - lse * log2e) in place, lse per column
// (query row) from a stage's statistics; padded query rows hold lse =
// +1e30.
__device__ __forceinline__ void probabilities_t(float (&s)[32],
                                                const unsigned char* stat,
                                                int col, float scale_log2) {
  const float2* lse2 = reinterpret_cast<const float2*>(stat);
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
}

// dS^T = P^T (dP^T - delta) in place in dp, delta per column (0 on padded
// rows) from a stage's statistics.
__device__ __forceinline__ void grad_logits_t(const float (&s)[32],
                                              float (&dp)[32],
                                              const unsigned char* stat,
                                              int col) {
  const float2* dl2 = reinterpret_cast<const float2*>(stat + STAT_BYTES);
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
}

// Accumulator layout of wgmma m64nN (per warpgroup thread t, warp w = t/32,
// lane l): d[4j + e] is row 16w + l/4, column 8j + 2(l%4) + e, and
// d[4j + 2 + e] the same columns of row 16w + l/4 + 8 (e in {0, 1}). The A
// fragment of a k16 step kk takes columns 16kk..16kk+15 in the same rows,
// so the bf16 pair (d[2i], d[2i+1]) is A register i: P and dS need no
// shuffle.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_g,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_dq,
                    const __nv_bfloat16* __restrict__ o,
                    const __nv_bfloat16* __restrict__ g,
                    const float* __restrict__ lse,
                    float* __restrict__ lse_pad,
                    float* __restrict__ delta_pad, int H, int ld,
                    int ld_stat, int nq, int nk, float scale,
                    float scale_log2) {
  using P = Plan<D, BM_DQ>;
  constexpr int ATOMS = P::ATOMS;
  constexpr int STAGES = P::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const Barriers<P> bar(base);
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BM_DQ;
  const int n_tiles = cdiv(nk, BN);

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0)
      produce<P>(base, bar, &tm_q, &tm_g, &tm_k, &tm_v, h, q0, b, n_tiles,
                 nullptr, nullptr);
    return;
  }

  // Consumer warpgroup c owns query rows [64c, 64c + 64) of the block: the
  // same rows of each atom of the Q and dO tiles.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;  // this thread's rows: r0, r0 + 8
  const int col = 2 * (lane % 4);           // its column pair in each 8
  const uint32_t q_tile = base + P::SM_R0 + c * 64 * ROW_BYTES;
  const uint32_t g_tile = base + P::SM_R1 + c * 64 * ROW_BYTES;

  // The rows' statistics (lse 1e30 and delta 0 past nq), and the padded
  // rows of both for the dK/dV kernel.
  const int qr = q0 + 64 * c + r0;  // this thread's query rows: qr, qr + 8
  const size_t head = (size_t)b * nq * ld + (size_t)h * D;
  float lse0 = kLsePad, lse1 = kLsePad, dl0 = 0.f, dl1 = 0.f;
  if (qr < nq) {
    lse0 = lse[(size_t)bh * nq + qr];
    dl0 = row_dot<D>(o + head + (size_t)qr * ld, g + head + (size_t)qr * ld,
                     lane % 4);
  }
  if (qr + 8 < nq) {
    lse1 = lse[(size_t)bh * nq + qr + 8];
    dl1 = row_dot<D>(o + head + (size_t)(qr + 8) * ld,
                     g + head + (size_t)(qr + 8) * ld, lane % 4);
  }
  dl0 = quad_sum(dl0);
  dl1 = quad_sum(dl1);
  if (col == 0) {
    if (qr < ld_stat) {
      lse_pad[(size_t)bh * ld_stat + qr] = lse0;
      delta_pad[(size_t)bh * ld_stat + qr] = dl0;
    }
    if (qr + 8 < ld_stat) {
      lse_pad[(size_t)bh * ld_stat + qr + 8] = lse1;
      delta_pad[(size_t)bh * ld_stat + qr + 8] = dl1;
    }
  }
  const float nl0 = -lse0 * kLog2e, nl1 = -lse1 * kLog2e;

  float s[32], dp[32], dq[ATOMS][32];
#pragma unroll
  for (int at = 0; at < ATOMS; ++at)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[at][i] = 0.f;
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
    fence_atoms(dq);
    fence_regs(ds);
    wgmma_fence();
    issue_nn(dq, ds, base + P::SM_S0 + st * P::TILE_BYTES);
    wgmma_commit();
  };

  constexpr bool PINGPONG = Tune<D>::DQ_PINGPONG;
  constexpr bool AREG = Tune<D>::DQ_AREG;
  uint32_t qa[AREG ? 4 * P::KSTEPS : 1], ga[AREG ? 4 * P::KSTEPS : 1];
  // S = Q K^T and dP = dO V^T of stage st, each one commit group
  auto issue_s = [&](int st) {
    const uint32_t k_st = base + P::SM_S0 + st * P::TILE_BYTES;
    if constexpr (AREG) issue_nt_rs<P>(s, qa, k_st);
    else issue_nt<P>(s, q_tile, k_st);
  };
  auto issue_dp = [&](int st) {
    const uint32_t v_st = base + P::SM_S1 + st * P::TILE_BYTES;
    if constexpr (AREG) issue_nt_rs<P>(dp, ga, v_st);
    else issue_nt<P>(dp, g_tile, v_st);
  };
  // Stage 0: S and dP as two commit groups, P while dP runs.
  mbar_wait(bar.res, 0);
  if constexpr (AREG) {
    load_a<P>(qa, smem_raw + (q_tile - smem_u32(smem_raw)), r0, lane);
    load_a<P>(ga, smem_raw + (g_tile - smem_u32(smem_raw)), r0, lane);
  }
  mbar_wait(bar.full, 0);
  issue_s(0);
  issue_dp(0);
  wgmma_wait<1>();
  fence_regs(s);
  probabilities(0);
  wgmma_wait<0>();
  fence_regs(dp);
  grad_logits();
  pack();
  if (PINGPONG && c == 1)  // consumer 0 takes the first turn
    named_barrier_arrive(TURN_BAR, 256);

  // Stage it: S, dP and the previous stage's dQ += dS K (its K read
  // MN-major) in flight as three groups, issued in this consumer's turn;
  // P as soon as S is done, dS once dP is, and the previous stage released
  // once its dQ product is. No group stays in flight across iterations.
  for (int it = 1; it < n_tiles; ++it) {
    const int st = it % STAGES;
    const int pst = (it - 1) % STAGES;
    mbar_wait(bar.full + 8 * st, (it / STAGES) & 1);
    if (PINGPONG) named_barrier(TURN_BAR + c, 256);  // this one's turn
    issue_s(st);
    issue_dp(st);
    issue_dq(pst);
    if (PINGPONG)  // the other one's turn
      named_barrier_arrive(TURN_BAR + 1 - c, 256);
    wgmma_wait<2>();
    fence_regs(s);
    probabilities(it);
    wgmma_wait<1>();
    fence_regs(dp);
    grad_logits();
    wgmma_wait<0>();
    fence_atoms(dq);
    fence_regs(ds);
    if (t == 0) mbar_arrive(bar.empty + 8 * pst);
    pack();
  }
  // the last stage's dQ product; consumer 1 takes the last turn
  if (PINGPONG) named_barrier(TURN_BAR + c, 256);
  issue_dq((n_tiles - 1) % STAGES);
  if (PINGPONG && c == 0) named_barrier_arrive(TURN_BAR + 1, 256);
  wgmma_wait<0>();
  fence_atoms(dq);

  // Stage bf16 dQ * scale in this warpgroup's Q rows of each atom (its last
  // S product has completed), then one TMA store per atom; rows past nq and
  // lanes past D are dropped.
  stage_out(smem_raw + (q_tile - smem_u32(smem_raw)), P::RES_ATOM, dq, scale,
            r0, col);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_barrier(1 + c, 128);
  if (t == 0 && q0 + 64 * c < nq) {
#pragma unroll
    for (int at = 0; at < ATOMS; ++at)
      tma_store_4d(&tm_dq, q_tile + at * P::RES_ATOM, 64 * at, h,
                   q0 + 64 * c, b);
  }
}

template <int D>
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
  constexpr bool SPLIT = kSplit<D>;
  constexpr int BM = kDkvRows<D>;
  using P = Plan<D, BM>;
  constexpr int ATOMS = P::ATOMS;
  constexpr int STAGES = P::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const Barriers<P> bar(base);
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * BM;
  const int n_tiles = cdiv(nq, BN);

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0)
      produce<P>(base, bar, &tm_k, &tm_v, &tm_q, &tm_g, h, k0, b, n_tiles,
                 lse + (size_t)bh * ld_stat, delta + (size_t)bh * ld_stat);
    return;
  }

  // Consumer warpgroup c owns key rows [64c, 64c + 64) of the block (SPLIT:
  // both own the block's 64 keys, c = 0 computing dK, c = 1 dV); its
  // accumulator columns are the stage's query rows.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  const uint32_t rows = SPLIT ? 0 : c * 64 * ROW_BYTES;
  const uint32_t k_tile = base + P::SM_R0 + rows;
  const uint32_t v_tile = base + P::SM_R1 + rows;
  const unsigned char* stats =
      smem_raw + (base + P::SM_STAT - smem_u32(smem_raw));
  auto stat = [&](int st) { return stats + st * 2 * STAT_BYTES; };
  auto q_stage = [&](int st) { return base + P::SM_S0 + st * P::TILE_BYTES; };
  auto g_stage = [&](int st) { return base + P::SM_S1 + st * P::TILE_BYTES; };
  auto k_gen = smem_raw + (k_tile - smem_u32(smem_raw));
  auto v_gen = smem_raw + (v_tile - smem_u32(smem_raw));

  if constexpr (!SPLIT) {
    float s[32], dp[32], dk[ATOMS][32], dv[ATOMS][32];
#pragma unroll
    for (int at = 0; at < ATOMS; ++at)
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[at][i] = dv[at][i] = 0.f;
    uint32_t pt[16], dst[16];

    // P^T and dS^T into the bf16 A fragments of the gradient products.
    auto pack = [&]() {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        pt[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
        dst[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);
      }
    };
    // dV += P^T dO and dK += dS^T Q on stage st's dO and Q read MN-major,
    // one commit group.
    auto issue_grads = [&](int st) {
      fence_atoms(dk);
      fence_atoms(dv);
      fence_regs(pt);
      fence_regs(dst);
      wgmma_fence();
      issue_nn(dv, pt, g_stage(st));
      issue_nn(dk, dst, q_stage(st));
      wgmma_commit();
    };

    constexpr bool PINGPONG = Tune<D>::DKV_PINGPONG;
    constexpr bool AREG = Tune<D>::DKV_AREG;
    uint32_t ka[AREG ? 4 * P::KSTEPS : 1], va[AREG ? 4 * P::KSTEPS : 1];
    // S^T = K Q^T and dP^T = V dO^T of stage st, each one commit group
    auto issue_s = [&](int st) {
      if constexpr (AREG) issue_nt_rs<P>(s, ka, q_stage(st));
      else issue_nt<P>(s, k_tile, q_stage(st));
    };
    auto issue_dp = [&](int st) {
      if constexpr (AREG) issue_nt_rs<P>(dp, va, g_stage(st));
      else issue_nt<P>(dp, v_tile, g_stage(st));
    };
    // Stage 0: S^T and dP^T as two commit groups, P^T while dP^T runs.
    mbar_wait(bar.res, 0);
    if constexpr (AREG) {
      load_a<P>(ka, k_gen, r0, lane);
      load_a<P>(va, v_gen, r0, lane);
    }
    mbar_wait(bar.full, 0);
    issue_s(0);
    issue_dp(0);
    wgmma_wait<1>();
    fence_regs(s);
    probabilities_t(s, stat(0), col, scale_log2);
    wgmma_wait<0>();
    fence_regs(dp);
    grad_logits_t(s, dp, stat(0), col);
    pack();
    if (PINGPONG && c == 1)  // consumer 0 takes the first turn
      named_barrier_arrive(TURN_BAR, 256);

    // Stage it: S^T, dP^T and the previous stage's dV and dK products in
    // flight as three groups, issued in this consumer's turn; the previous
    // stage released once its gradient products are done. No group stays
    // in flight across iterations.
    for (int it = 1; it < n_tiles; ++it) {
      const int st = it % STAGES;
      const int pst = (it - 1) % STAGES;
      mbar_wait(bar.full + 8 * st, (it / STAGES) & 1);
      if (PINGPONG) named_barrier(TURN_BAR + c, 256);
      issue_s(st);
      issue_dp(st);
      issue_grads(pst);
      if (PINGPONG) named_barrier_arrive(TURN_BAR + 1 - c, 256);
      wgmma_wait<2>();
      fence_regs(s);
      probabilities_t(s, stat(st), col, scale_log2);
      wgmma_wait<1>();
      fence_regs(dp);
      grad_logits_t(s, dp, stat(st), col);
      wgmma_wait<0>();
      fence_atoms(dk);
      fence_atoms(dv);
      fence_regs(pt);
      fence_regs(dst);
      if (t == 0) mbar_arrive(bar.empty + 8 * pst);
      pack();
    }
    if (PINGPONG) named_barrier(TURN_BAR + c, 256);
    issue_grads((n_tiles - 1) % STAGES);
    if (PINGPONG && c == 0) named_barrier_arrive(TURN_BAR + 1, 256);
    wgmma_wait<0>();
    fence_atoms(dk);
    fence_atoms(dv);

    // Stage bf16 dK * scale and dV in this warpgroup's K and V rows (idle
    // since its last S^T and dP^T), then TMA stores; rows past nk and
    // lanes past D are dropped.
    stage_out(k_gen, P::RES_ATOM, dk, scale, r0, col);
    stage_out(v_gen, P::RES_ATOM, dv, 1.f, r0, col);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_barrier(1 + c, 128);
    if (t == 0 && k0 + 64 * c < nk) {
#pragma unroll
      for (int at = 0; at < ATOMS; ++at) {
        tma_store_4d(&tm_dk, k_tile + at * P::RES_ATOM, 64 * at, h,
                     k0 + 64 * c, b);
        tma_store_4d(&tm_dv, v_tile + at * P::RES_ATOM, 64 * at, h,
                     k0 + 64 * c, b);
      }
    }
  } else if (c == 0) {
    // dK: S^T, dP^T, dS^T and dK += dS^T Q per stage, pipelined as above.
    float s[32], dp[32], dk[ATOMS][32];
#pragma unroll
    for (int at = 0; at < ATOMS; ++at)
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[at][i] = 0.f;
    uint32_t dst[16];
    auto pack = [&]() {
#pragma unroll
      for (int i = 0; i < 16; ++i) dst[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);
    };
    auto issue_dk = [&](int st) {
      fence_atoms(dk);
      fence_regs(dst);
      wgmma_fence();
      issue_nn(dk, dst, q_stage(st));
      wgmma_commit();
    };
    mbar_wait(bar.res, 0);
    mbar_wait(bar.full, 0);
    issue_nt<P>(s, k_tile, q_stage(0));
    issue_nt<P>(dp, v_tile, g_stage(0));
    wgmma_wait<1>();
    fence_regs(s);
    probabilities_t(s, stat(0), col, scale_log2);
    wgmma_wait<0>();
    fence_regs(dp);
    grad_logits_t(s, dp, stat(0), col);
    pack();
    for (int it = 1; it < n_tiles; ++it) {
      const int st = it % STAGES;
      const int pst = (it - 1) % STAGES;
      mbar_wait(bar.full + 8 * st, (it / STAGES) & 1);
      issue_nt<P>(s, k_tile, q_stage(st));
      issue_nt<P>(dp, v_tile, g_stage(st));
      issue_dk(pst);
      wgmma_wait<2>();
      fence_regs(s);
      probabilities_t(s, stat(st), col, scale_log2);
      wgmma_wait<1>();
      fence_regs(dp);
      grad_logits_t(s, dp, stat(st), col);
      wgmma_wait<0>();
      fence_atoms(dk);
      fence_regs(dst);
      if (t == 0) mbar_arrive(bar.empty + 8 * pst);
      pack();
    }
    issue_dk((n_tiles - 1) % STAGES);
    wgmma_wait<0>();
    fence_atoms(dk);
    // both consumers are done with K and V: dK goes out through V's tile
    named_barrier(1, 256);
    stage_out(v_gen, P::RES_ATOM, dk, scale, r0, col);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_barrier(2, 128);
    if (t == 0 && k0 < nk) {
#pragma unroll
      for (int at = 0; at < ATOMS; ++at)
        tma_store_4d(&tm_dk, v_tile + at * P::RES_ATOM, 64 * at, h, k0, b);
    }
  } else {
    // dV: S^T, P^T and dV += P^T dO per stage; the stage's dO tile is read
    // only by the product.
    float s[32], dv[ATOMS][32];
#pragma unroll
    for (int at = 0; at < ATOMS; ++at)
#pragma unroll
      for (int i = 0; i < 32; ++i) dv[at][i] = 0.f;
    uint32_t pt[16];
    auto pack = [&]() {
#pragma unroll
      for (int i = 0; i < 16; ++i) pt[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    };
    auto issue_dv = [&](int st) {
      fence_atoms(dv);
      fence_regs(pt);
      wgmma_fence();
      issue_nn(dv, pt, g_stage(st));
      wgmma_commit();
    };
    mbar_wait(bar.res, 0);
    mbar_wait(bar.full, 0);
    issue_nt<P>(s, k_tile, q_stage(0));
    wgmma_wait<0>();
    fence_regs(s);
    probabilities_t(s, stat(0), col, scale_log2);
    pack();
    for (int it = 1; it < n_tiles; ++it) {
      const int st = it % STAGES;
      const int pst = (it - 1) % STAGES;
      mbar_wait(bar.full + 8 * st, (it / STAGES) & 1);
      issue_nt<P>(s, k_tile, q_stage(st));
      issue_dv(pst);
      wgmma_wait<1>();
      fence_regs(s);
      probabilities_t(s, stat(st), col, scale_log2);
      wgmma_wait<0>();
      fence_atoms(dv);
      fence_regs(pt);
      if (t == 0) mbar_arrive(bar.empty + 8 * pst);
      pack();
    }
    issue_dv((n_tiles - 1) % STAGES);
    wgmma_wait<0>();
    fence_atoms(dv);
    named_barrier(1, 256);
    stage_out(k_gen, P::RES_ATOM, dv, 1.f, r0, col);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_barrier(3, 128);
    if (t == 0 && k0 < nk) {
#pragma unroll
      for (int at = 0; at < ATOMS; ++at)
        tma_store_4d(&tm_dv, k_tile + at * P::RES_ATOM, 64 * at, h, k0, b);
    }
  }
}

// A map of the heads of a [B, N, ld] bf16 tensor: {D, H, N, B} (head h at
// channels [Dh, Dh + D)), a {64, 1, rows, 1} box. Lanes of a box past D and
// rows past N read as zeros and are not stored.
bool encode(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, int B, int H,
            int N, int D, int ld, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)N,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)ld * 2,
                                 (cuuint64_t)N * ld * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return encode_bf16_sw128(fn, map, ptr, 4, dims, strides, box);
}

// What both entry points check: a head width with an instantiation, TMA's
// 16-byte row strides, rows holding every head, the padded statistics'
// rows nq rounded up to a 64-row stage, 16-byte aligned padded statistics.
int check_args(int B, int H, int nq, int nk, int D, int ldq, int ldkv,
               int ld_stat, const void* lse, const void* delta) {
  if ((D != 40 && D != 64 && D != 80 && D != 160) || B < 1 || H < 1 ||
      nq < 1 || nk < 1 || ldq % 8 || ldkv % 8 || ldq < D * H ||
      ldkv < D * H || ld_stat != cdiv(nq, STAT_PAD) * STAT_PAD ||
      reinterpret_cast<uintptr_t>(lse) % 16 ||
      reinterpret_cast<uintptr_t>(delta) % 16)
    return (int)cudaErrorInvalidValue;
  return encode_tiled() == nullptr ? (int)cudaErrorNotSupported : 0;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int D>
cudaError_t launch_dq(const CUtensorMap (&maps)[5], const __nv_bfloat16* o,
                      const __nv_bfloat16* g, const float* lse,
                      float* lse_pad, float* delta_pad, int B, int H, int nq,
                      int nk, int ldq, int ld_stat, float scale,
                      cudaStream_t stream) {
  constexpr int smem = Plan<D, BM_DQ>::SMEM_REQUEST;
  cudaError_t e = prepare(flash_bwd_dq_kernel<D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(cdiv(nq, BM_DQ), B * H);
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], o, g, lse, lse_pad,
      delta_pad, H, ldq, ld_stat, nq, nk, scale, scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* const (&ptrs)[6], const float* lse,
                       const float* delta, int B, int H, int nq, int nk,
                       int ldq, int ldkv, int ld_stat, float scale,
                       cudaStream_t stream) {
  constexpr int bm = kDkvRows<D>;
  constexpr int smem = Plan<D, bm>::SMEM_REQUEST;
  const EncodeTiledFn fn = encode_tiled();
  CUtensorMap maps[6];
  if (!encode(fn, &maps[0], ptrs[0], B, H, nk, D, ldkv, bm) ||   // k
      !encode(fn, &maps[1], ptrs[1], B, H, nk, D, ldkv, bm) ||   // v
      !encode(fn, &maps[2], ptrs[2], B, H, nq, D, ldq, BN) ||    // q
      !encode(fn, &maps[3], ptrs[3], B, H, nq, D, ldq, BN) ||    // dO
      !encode(fn, &maps[4], ptrs[4], B, H, nk, D, ldkv, 64) ||   // dk
      !encode(fn, &maps[5], ptrs[5], B, H, nk, D, ldkv, 64))     // dv
    return cudaErrorInvalidValue;
  cudaError_t e = prepare(flash_bwd_dkv_kernel<D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(cdiv(nk, bm), B * H);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], lse, delta, H,
      ld_stat, nq, nk, scale, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dQ of the attention backward at head width D (40, 64, 80 or 160), with
// delta = rowsum(dO o O) and the padded statistics the dK/dV kernel reads.
// q/g/o/dq: [B, nq, ldq] bf16 (o the training forward's output, g = dO);
// k/v: [B, nk, ldkv] bf16; all 16-byte aligned with row strides a multiple
// of 8 elements and at least H D. lse: the forward's [B*H, nq] fp32.
// lse_pad/delta_pad: [B*H, ld_stat] fp32, ld_stat = nq rounded up to 64,
// 16-byte aligned, written: lse and delta, rows past nq +1e30 and 0.
// Returns cudaSuccess (0) or the error of the checks, the map encoding,
// the attribute call or the launch.
int mt_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                              const void* g, const void* o, const void* lse,
                              void* dq, void* lse_pad, void* delta_pad, int B,
                              int H, int nq, int nk, int D, int ldq, int ldkv,
                              int ld_stat, float scale, void* stream) {
  int err = check_args(B, H, nq, nk, D, ldq, ldkv, ld_stat, lse_pad,
                       delta_pad);
  if (err) return err;
  if (reinterpret_cast<uintptr_t>(o) % 16 ||
      reinterpret_cast<uintptr_t>(g) % 16)
    return (int)cudaErrorInvalidValue;
  const EncodeTiledFn fn = encode_tiled();
  CUtensorMap maps[5];
  if (!encode(fn, &maps[0], q, B, H, nq, D, ldq, BM_DQ) ||
      !encode(fn, &maps[1], g, B, H, nq, D, ldq, BM_DQ) ||
      !encode(fn, &maps[2], k, B, H, nk, D, ldkv, BN) ||
      !encode(fn, &maps[3], v, B, H, nk, D, ldkv, BN) ||
      !encode(fn, &maps[4], dq, B, H, nq, D, ldq, 64))
    return (int)cudaErrorInvalidValue;
  const auto* ob = static_cast<const __nv_bfloat16*>(o);
  const auto* gb = static_cast<const __nv_bfloat16*>(g);
  const float* ls = static_cast<const float*>(lse);
  float* lp = static_cast<float*>(lse_pad);
  float* dp = static_cast<float*>(delta_pad);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40:
      return (int)launch_dq<40>(maps, ob, gb, ls, lp, dp, B, H, nq, nk, ldq,
                                ld_stat, scale, st);
    case 64:
      return (int)launch_dq<64>(maps, ob, gb, ls, lp, dp, B, H, nq, nk, ldq,
                                ld_stat, scale, st);
    case 80:
      return (int)launch_dq<80>(maps, ob, gb, ls, lp, dp, B, H, nq, nk, ldq,
                                ld_stat, scale, st);
    default:
      return (int)launch_dq<160>(maps, ob, gb, ls, lp, dp, B, H, nq, nk, ldq,
                                 ld_stat, scale, st);
  }
}

// dK and dV of the attention backward; dk/dv: [B, nk, ldkv] bf16, lse and
// delta the padded rows mt_flash_attention_bwd_dq writes, the other
// arguments as for it.
int mt_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                               const void* g, const void* lse,
                               const void* delta, void* dk, void* dv, int B,
                               int H, int nq, int nk, int D, int ldq,
                               int ldkv, int ld_stat, float scale,
                               void* stream) {
  int err = check_args(B, H, nq, nk, D, ldq, ldkv, ld_stat, lse, delta);
  if (err) return err;
  const void* const ptrs[6] = {k, v, q, g, dk, dv};
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40:
      return (int)launch_dkv<40>(ptrs, ls, dl, B, H, nq, nk, ldq, ldkv,
                                 ld_stat, scale, st);
    case 64:
      return (int)launch_dkv<64>(ptrs, ls, dl, B, H, nq, nk, ldq, ldkv,
                                 ld_stat, scale, st);
    case 80:
      return (int)launch_dkv<80>(ptrs, ls, dl, B, H, nq, nk, ldq, ldkv,
                                 ld_stat, scale, st);
    default:
      return (int)launch_dkv<160>(ptrs, ls, dl, B, H, nq, nk, ldq, ldkv,
                                  ld_stat, scale, st);
  }
}

const char* mt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
