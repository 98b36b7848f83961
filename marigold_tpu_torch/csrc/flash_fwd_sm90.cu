// Flash-attention forward for heads 40, 64, 80 and 160 wide (a template on
// the head width D), designed for Hopper (sm_90a): wgmma tensor-core
// products, TMA loads into a ring of shared-memory stages tracked by
// mbarriers, a producer warp and two consumer warpgroups, and the logits,
// probabilities and output accumulator held in registers.
//
// Replaces the instantiations at those widths (SD2's 64-wide heads; the
// 40-, 80- and 160-wide heads of an SD1.x-class UNet, 320, 640 and 1280
// channels over 8 heads) of the TPU package's
// marigold_tpu/ops/flash_attention.py kernels:
//   * _flash_kernel_dt_shifted  (shifted softmax; pallas_call at :396), and
//     the row shift its wrapper _flash_dt_impl computes outside it
//     (:362-373), which this kernel computes in its own launch
//   * _flash_kernel_dt          (exact online softmax; :460)
//   * _flash_kernel_dt_lse      (online softmax + row logsumexp; :638), the
//     training forward whose lse the backward kernels (flash_bwd_sm90.cu)
//     read
//   * _flash_kernel             (the folded [BH, N, D] entry; :522), which the
//     wrapper runs as the online variant with one head per batch row.
// The 512-wide VAE head has its own kernel, flash_fwd_d512_sm90.cu.
//
// Math per (batch, head, query row r), s_j = (q_r . k_j) * scale, fp32:
//   shifted: p_j = exp(min(s_j - shift_r, 75)), shift_r = max of s_j over
//            the sampled keys j = 0, stride, 2 stride, ... < nk (stride =
//            max(1, nk // 128), n_sub <= 255 of them) + 40, computed by the
//            kernel itself (below);
//   online:  running max m, p_j = exp(s_j - m), O and l rescaled by
//            exp(m_old - m_new) when the max grows;
//   out_r = (sum_j bf16(p_j) v_j) / max(sum_j p_j, 1e-30), stored bf16;
//   lse_r = m + log(max(l, 1e-30)) in natural-log units (LSE variant).
// Every exponential is exp2: the logits are multiplied by scale * log2(e),
// and the shift, the clamp and the running max live in the same base-2
// units; the lse (and the shift the shifted mode writes when asked) is
// converted back to natural log. Key columns j >= nk get
// s_j = -1e30; query rows r >= nq are computed on TMA's zero fill and not
// stored.
//
// Layout: q/k/v/o are [B, N, ld] bf16, head h at channels [Dh, Dh + D) (ld
// may exceed H D: the projected self-attention reads q, k and v in place
// in one [B, N, 3C] product). Each tensor has a 4-D TMA map {D, H, N, B}
// whose innermost dimension is the head itself (head stride D, row stride
// ld), with a {64, 1, rows, 1} box and the 128-byte swizzle: one 64-wide
// bf16 row is one 128-byte swizzle atom. A head wider than 64 takes
// ATOMS = ceil(D / 64) boxes side by side, each its own [rows, 128 B]
// block of shared memory. The box's lanes past D are outside the map's
// innermost dimension, so TMA fills them with zeros on a load (never the
// next head's lanes) and drops them on a store; rows past nq or nk are
// outside N, zero-filled inside each batch and dropped by the store. No
// padding copy. The map needs a head stride of a multiple of 16 bytes (D a
// multiple of 8), as ops/flash_attention.py:check_kernel_args checks.
//
// Padded widths: QK^T contracts over KSTEPS = ceil(D / 16) k16 steps (48
// lanes at D = 40, the 8 past D zero in both operands); P V runs one
// m64n64 product per atom (64, 128 or 192 output columns), the columns
// past D zeros of V, computed and never stored.
//
// What bounds it on the H100: ~4*N*N*64 FLOPs over ~4*N*64*2 bytes per
// head, about N/2 FLOP per byte (4608 at N = 9216), far above the card's
// ~295 FLOP/byte ridge: the tensor cores and the exponentials. At d = 64
// the softmax is as large as the products: one exp2 per 256 FLOPs of
// wgmma, and the special-function units (16 exp2 per SM per clock, ~3.9
// T/s) finish the exponentials of [1,9216,320] h=5 in 0.109 ms against the
// tensor cores' 0.111. Run one after the other they take the sum; the
// design runs them side by side:
//   * wgmma m64n128k16 for S = Q K^T (Q, K K-major in shared memory) and
//     m64n64k16 for O += P V with P taken from registers (the fp32 S
//     fragment converts in place to the bf16 A fragment) and V read
//     MN-major (transpose bit set);
//   * S, P and O never touch shared memory: the row max is a reduction over
//     the 4 threads that share a row of the accumulator (two shuffles), the
//     rescale of O runs on its registers;
//   * one producer thread keeps STAGES K/V tiles in flight with TMA; the
//     consumers wait on "full" barriers and release "empty" ones, with no
//     block-wide barrier in the K loop;
//   * two consumer warpgroups of 64 query rows (BQ = 128) work on the same
//     K/V tiles; setmaxnreg moves registers from the producer warpgroup
//     (24) to the consumers (240): one block per SM, 384 threads;
//   * overlap within a warpgroup (FlashAttention-3's): each warpgroup
//     issues QK^T(j+1) and P V(j) together, waits for the first only and
//     runs the softmax of tile j+1 while P V(j) is on the tensor cores; O's
//     rescale waits for P V(j). The last P V follows the loop, so that no
//     wgmma is issued on one path only (ptxas then cannot tell which wait
//     retires which product and serialises them, C7514);
//   * one of two schedules per head width and mode (Tune, below): ping-pong
//     between the warpgroups, whose two named barriers make them take turns
//     to issue their wgmmas, so that one's softmax runs under the other's
//     products (both take the same number of turns: every block walks
//     every tile in each consumer, past-nq rows included, and the shifted
//     mode's sample pass takes no turn), P packed once P V(j) is done; or,
//     for the online mode at d <= 64, no turns and P(j+1) packed into a
//     second buffer under P V(j). Neither changes the arithmetic: exp2 of
//     the same fp32 values, P rounded to bf16 at the same place.
// Registers per consumer thread: S (BK/2), P (BK/4 per buffer) and O (32
// per atom). At D = 160 O takes 96, so that width runs 64-key tiles (BK =
// 64: S 32, P 16); the others 128-key tiles. Shared memory: Q (BQ x 128 B
// per atom) and STAGES K/V stages (2 x BK x 128 B per atom each).
//
// At D = 40 the exponentials bind rather than the tensor cores: one exp2
// per logit against 4 D = 160 FLOPs of products per logit, and the card's
// special-function units finish fewer exponentials per second than its
// tensor cores finish those FLOPs.
//
// The shifted mode's row shift comes from a sample pass in the same CTA,
// before the K loop (the TPU wrapper computes it outside its kernel, as a
// strided slice of K, a product and a max that XLA fuses; on the card that
// chain of eager launches, with a copy of Q to fp32, cost as much as the
// kernel at the SD1.x widths). A fifth TMA map reads K's sampled rows in
// place: {D, H, n_sub, B} with a row stride of stride * ldkv elements (any
// multiple of 16 bytes will do), its rows past n_sub zero-filled. The
// producer puts ceil(n_sub / BK) sample tiles, K only, into the ring ahead
// of the first K/V tile; each consumer computes S for them with the main
// loop's QK^T, masks the columns >= n_sub, takes the row max over its quad
// and sets shift = max * scale * log2(e) + 40 log2(e), then runs the K
// loop unchanged. No exponential and no P V in that pass: ceil(n_sub / BK)
// extra QK^T tiles of ceil(nk / BK) (1.4-2.8% at nk = 9216, 12.5-25% at
// 1024). When the `lse` pointer is given the shifted mode writes that
// shift into it (natural-log units), for the tests.
//
// The host side encodes the five TMA maps per call (they hold the
// tensors' addresses; all five cost about a microsecond, PERF.md) and sets
// each instantiation's shared-memory limit once per device, not per launch.

#include <atomic>
#include <chrono>

#include "sm90.cuh"

namespace {

constexpr int BQ = 128;           // query rows per block (2 x 64)
constexpr int CONSUMERS = 2;      // consumer warpgroups
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int ROW_BYTES = 128;    // one 64-lane bf16 swizzle atom row
constexpr int SMEM_LIMIT = 232448;  // the 227 KB a block can use
constexpr int TURN_BAR = 3;  // PINGPONG's named barriers, 3 and 4 (0 is
                             // __syncthreads', 1 and 2 the epilogue's)

// The shapes of the instantiation at head width D with a ring of STAGES.
template <int D, int STAGES>
struct Shape {
  static_assert(D % 8 == 0 && D <= 192, "D a multiple of 8, at most 3 atoms");
  static constexpr int ATOMS = (D + 63) / 64;   // 64-lane boxes per row
  static constexpr int KSTEPS = (D + 15) / 16;  // k16 steps of Q K^T
  static constexpr int BK = D > 128 ? 64 : 128; // keys per K/V tile
  static constexpr int Q_ATOM = BQ * ROW_BYTES;  // one atom of the Q tile
  static constexpr int KV_ATOM = BK * ROW_BYTES;
  static constexpr int Q_BYTES = ATOMS * Q_ATOM;
  static constexpr int KV_BYTES = ATOMS * KV_ATOM;
  // Shared memory: Q (reused to stage the output), then K and V per
  // stage, then the barriers; every tile 1024-byte aligned (the 128B
  // swizzle atom).
  static constexpr int SM_Q = 0;
  static constexpr int SM_K = Q_BYTES;
  static constexpr int SM_V = SM_K + STAGES * KV_BYTES;
  static constexpr int SM_BAR = SM_V + STAGES * KV_BYTES;
  static constexpr int SM_BYTES = SM_BAR + 8 * (2 * STAGES + 1);
  static constexpr int SMEM_REQUEST = SM_BYTES + 1024;  // room to align
  static_assert(SMEM_REQUEST <= SMEM_LIMIT, "fits the 227 KB a block can use");
};

// The schedule of each instantiation: ping-pong with one P buffer and 3
// K/V stages (3 fit at every width: at D = 80 two 64-lane atoms of
// 128-key tiles, 3 x 64 KB), but for the online mode (the lse forward and
// the folded entry too) at d = 40 and 64, whose row max must precede the
// tile's exponentials, so that a turn would wait on it: there two P
// buffers and no turns, over 4 stages. Each wins where it is chosen
// (PERF.md, section 6, PR 22: ping-pong 3-26% faster in the shifted mode
// and online at d >= 80; the second P buffer 0-7% faster online at d <=
// 64, a fourth stage 0-9% there and nothing elsewhere).
template <int D, bool ONLINE>
struct Tune {
  static constexpr bool PINGPONG = !(ONLINE && D <= 64);
  static constexpr int STAGES = PINGPONG ? 3 : 4;
};

constexpr float kNegInf = -1e30f;                 // the TPU kernels' NEG_INF
constexpr int kMaxSample = 255;  // sampled keys: max(1, nk // 128) strides
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kClamp2 = 75.0f * 1.4426950408889634f;  // exp clamp, base 2
constexpr float kMargin2 = 40.0f * 1.4426950408889634f;  // shift margin, base 2

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
template <int D, bool ONLINE, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_o,
                      const __grid_constant__ CUtensorMap tm_ks,
                      float* __restrict__ lse, int H, int nq, int nk,
                      int n_sub, float scale_log2) {
  static_assert(ONLINE || !LSE, "the logsumexp needs the running max");
  using T_ = Tune<D, ONLINE>;
  constexpr int STAGES = T_::STAGES;
  using S_ = Shape<D, STAGES>;
  constexpr int ATOMS = S_::ATOMS;
  constexpr int BK = S_::BK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_full = base + S_::SM_BAR;             // [STAGES]
  const uint32_t bar_empty = bar_full + 8 * STAGES;        // [STAGES]
  const uint32_t bar_q = bar_empty + 8 * STAGES;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int n_tiles = (nk + BK - 1) / BK;
  // shifted mode: the sample tiles of K that go through the ring first
  const int n_pre = ONLINE ? 0 : (n_sub + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer warpgroup: one thread starts every TMA load, one box per
    // 64-lane atom of the head, into ring slot `slot` of pass `phase`.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, S_::Q_BYTES);
#pragma unroll
      for (int a = 0; a < ATOMS; ++a)
        tma_load_4d(base + S_::SM_Q + a * S_::Q_ATOM, &tm_q, 64 * a, h, q0, b,
                    bar_q);
      int slot = 0;
      uint32_t phase = 0;
      for (int it = 0; it < n_pre + n_tiles; ++it) {
        if (it >= STAGES) mbar_wait(bar_empty + 8 * slot, phase ^ 1);
        const bool sample = it < n_pre;  // K's sampled rows only
        mbar_expect_tx(bar_full + 8 * slot, (sample ? 1 : 2) * S_::KV_BYTES);
#pragma unroll
        for (int a = 0; a < ATOMS; ++a) {
          const uint32_t off = slot * S_::KV_BYTES + a * S_::KV_ATOM;
          if (sample) {
            tma_load_4d(base + S_::SM_K + off, &tm_ks, 64 * a, h, it * BK, b,
                        bar_full + 8 * slot);
          } else {
            const int k0 = (it - n_pre) * BK;
            tma_load_4d(base + S_::SM_K + off, &tm_k, 64 * a, h, k0, b,
                        bar_full + 8 * slot);
            tma_load_4d(base + S_::SM_V + off, &tm_v, 64 * a, h, k0, b,
                        bar_full + 8 * slot);
          }
        }
        if (++slot == STAGES) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // Consumer warpgroup c owns query rows [64c, 64c + 64) of the block: the
  // same rows of each atom of the Q tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;  // this thread's rows: r0, r0 + 8
  const int col = 2 * (lane % 4);           // its column pair in each 8
  const int row0 = q0 + 64 * c + r0;        // global query rows
  const int row1 = row0 + 8;
  const uint32_t q_tile = base + S_::SM_Q + c * 64 * ROW_BYTES;

  float s[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  // P of a tile as the bf16 A fragment; without ping-pong the next tile's
  // is packed into the second buffer while the P V of this one reads the
  // first
  uint32_t p[T_::PINGPONG ? 1 : 2][BK / 4];
  float o[ATOMS][32];                // output columns [64a, 64a + 64)
#pragma unroll
  for (int a = 0; a < ATOMS; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[a][i] = 0.f;

  // the ring position of the next tile this warpgroup reads (a running
  // count: deriving it from the tile index and the sample's length made
  // ptxas serialise the wgmmas of the fp32 kernel at D = 160, C7511)
  int slot = 0;
  uint32_t phase = 0;
  auto next_slot = [&] {
    if (++slot == STAGES) {
      slot = 0;
      phase ^= 1;
    }
  };

  auto issue_qk = [&](int st) {
    const uint32_t k_tile = base + S_::SM_K + st * S_::KV_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < S_::KSTEPS; ++kk) {
      const uint32_t off = 32 * (kk % 4);
      wgmma_ss<BK>(s, kmajor_desc(q_tile + (kk / 4) * S_::Q_ATOM + off),
                   kmajor_desc(k_tile + (kk / 4) * S_::KV_ATOM + off), kk);
    }
    wgmma_commit();
  };

  // O += P V on stage st's V with P from `pr`, one product per atom of
  // output columns.
  auto issue_pv = [&](int st, uint32_t(&pr)[BK / 4]) {
    const uint32_t v_tile = base + S_::SM_V + st * S_::KV_BYTES;
#pragma unroll
    for (int a = 0; a < ATOMS; ++a) fence_regs(o[a]);
    fence_regs(pr);
    wgmma_fence();
#pragma unroll
    for (int a = 0; a < ATOMS; ++a) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n64k16_rs(o[a], pr[4 * kk], pr[4 * kk + 1], pr[4 * kk + 2],
                           pr[4 * kk + 3],
                           mnmajor_desc(v_tile + a * S_::KV_ATOM + 2048 * kk));
    }
    wgmma_commit();
  };

  auto fence_pv = [&](uint32_t(&pr)[BK / 4]) {
#pragma unroll
    for (int a = 0; a < ATOMS; ++a) fence_regs(o[a]);
    fence_regs(pr);
  };

  mbar_wait(bar_q, 0);
  float sh0 = 0.f, sh1 = 0.f;  // shifted mode: the row shift, base 2
  if (!ONLINE) {
    // The sample pass: S on the sampled keys, columns >= n_sub masked, the
    // row max over the quad, plus the margin.
    float mx0 = kNegInf, mx1 = kNegInf;
    for (int it = 0; it < n_pre; ++it) {
      mbar_wait(bar_full + 8 * slot, phase);
      issue_qk(slot);
      wgmma_wait<0>();
      fence_regs(s);
      if (t == 0) mbar_arrive(bar_empty + 8 * slot);  // release the sample
      next_slot();
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (it * BK + 8 * j + col + e < n_sub) {
            mx0 = fmaxf(mx0, s[4 * j + e]);
            mx1 = fmaxf(mx1, s[4 * j + 2 + e]);
          }
        }
      }
    }
    sh0 = fmaf(quad_max(mx0), scale_log2, kMargin2);
    sh1 = fmaf(quad_max(mx1), scale_log2, kMargin2);
    if (lse != nullptr && lane % 4 == 0) {
      if (row0 < nq) lse[(size_t)bh * nq + row0] = sh0 * kLn2;
      if (row1 < nq) lse[(size_t)bh * nq + row1] = sh1 * kLn2;
    }
  }
  float m0 = kNegInf, m1 = kNegInf;  // running max (online), base 2
  float l0 = 0.f, l1 = 0.f;          // this thread's part of the row sums
  float a0 = 1.f, a1 = 1.f;          // online: O's pending rescale

  // The exponentials of tile `it` in place in s, their sums into l; online,
  // the new running max and O's rescale factor (l rescaled here, O by
  // rescale_o once the tile before's P V is done).
  auto softmax = [&](int it) {
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
      a0 = ex2(m0 - ref0);
      a1 = ex2(m1 - ref1);
      m0 = ref0;
      m1 = ref1;
      l0 *= a0;
      l1 *= a1;
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
  };

  auto rescale_o = [&] {
    if (ONLINE) {
#pragma unroll
      for (int a = 0; a < ATOMS; ++a) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[a][4 * j] *= a0;
          o[a][4 * j + 1] *= a0;
          o[a][4 * j + 2] *= a1;
          o[a][4 * j + 3] *= a1;
        }
      }
    }
  };

  auto pack_p = [&](uint32_t(&pr)[BK / 4]) {
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) pr[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
  };

  // Tile 0's QK^T and softmax before the loop.
  mbar_wait(bar_full + 8 * slot, phase);
  issue_qk(slot);
  wgmma_wait<0>();
  fence_regs(s);
  softmax(0);
  rescale_o();
  pack_p(p[0]);
  if (T_::PINGPONG && c == 1)  // consumer 0 takes the first turn
    named_barrier_arrive(TURN_BAR, 256);

  // Every tile but the last: QK^T of the next tile and P V of this one (P
  // in pc) issued together, the next softmax under the P V, its P packed
  // into pn (without ping-pong the other buffer, under the P V; else pc,
  // once the P V is done), O rescaled once the P V is done.
  auto overlap_step = [&](int it, uint32_t(&pc)[BK / 4],
                          uint32_t(&pn)[BK / 4]) {
    const int cur = slot;  // tile it's stage
    if (T_::PINGPONG) named_barrier(TURN_BAR + c, 256);  // this one's turn
    next_slot();  // tile it + 1's stage
    mbar_wait(bar_full + 8 * slot, phase);
    issue_qk(slot);
    issue_pv(cur, pc);
    if (T_::PINGPONG)  // the other one's turn
      named_barrier_arrive(TURN_BAR + 1 - c, 256);
    wgmma_wait<1>();  // QK^T of tile it + 1 is done; P V may run on
    fence_regs(s);
    softmax(it + 1);
    if (!T_::PINGPONG) pack_p(pn);
    wgmma_wait<0>();
    fence_pv(pc);
    if (t == 0) mbar_arrive(bar_empty + 8 * cur);  // release K/V stage
    rescale_o();
    if (T_::PINGPONG) pack_p(pn);
  };
  // The last tile's P V (P in pc); consumer 1 takes the last turn.
  auto overlap_last = [&](uint32_t(&pc)[BK / 4]) {
    if (T_::PINGPONG) named_barrier(TURN_BAR + c, 256);
    issue_pv(slot, pc);
    if (T_::PINGPONG && c == 0) named_barrier_arrive(TURN_BAR + 1, 256);
    wgmma_wait<0>();
    fence_pv(pc);
    if (t == 0) mbar_arrive(bar_empty + 8 * slot);
  };

  if constexpr (!T_::PINGPONG) {  // the P buffers alternate by tile
    int it = 0;
    for (; it + 2 < n_tiles; it += 2) {
      overlap_step(it, p[0], p[1]);
      overlap_step(it + 1, p[1], p[0]);
    }
    if (it + 1 < n_tiles) {
      overlap_step(it, p[0], p[1]);
      overlap_last(p[1]);
    } else {
      overlap_last(p[0]);
    }
  } else {
    for (int it = 0; it + 1 < n_tiles; ++it) overlap_step(it, p[0], p[0]);
    overlap_last(p[0]);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  // the lse rounds m ln 2 before the add: left to the compiler, the sum
  // contracts into an FMA in some schedules and not in others
  if (LSE && lane % 4 == 0) {
    if (row0 < nq)
      lse[(size_t)bh * nq + row0] =
          __fadd_rn(__fmul_rn(m0, kLn2), logf(fmaxf(l0, 1e-30f)));
    if (row1 < nq)
      lse[(size_t)bh * nq + row1] =
          __fadd_rn(__fmul_rn(m1, kLn2), logf(fmaxf(l1, 1e-30f)));
  }

  // Stage the bf16 output in this warpgroup's Q rows of each atom (its last
  // QK^T has completed), in the swizzled layout the O map expects, then one
  // TMA store per atom; lanes past D and rows past nq are dropped by the
  // store.
  unsigned char* q_gen = smem_raw + (q_tile - smem_u32(smem_raw));
#pragma unroll
  for (int a = 0; a < ATOMS; ++a) {
    unsigned char* atom = q_gen + a * S_::Q_ATOM;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t chunk = static_cast<uint32_t>(j ^ (r0 & 7)) << 4;
      const uint32_t off = chunk + 2 * col;
      *reinterpret_cast<uint32_t*>(atom + r0 * ROW_BYTES + off) =
          pack_bf16(o[a][4 * j] * inv0, o[a][4 * j + 1] * inv0);
      *reinterpret_cast<uint32_t*>(atom + (r0 + 8) * ROW_BYTES + off) =
          pack_bf16(o[a][4 * j + 2] * inv1, o[a][4 * j + 3] * inv1);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
  if (t == 0 && q0 + 64 * c < nq) {
#pragma unroll
    for (int a = 0; a < ATOMS; ++a)
      tma_store_4d(&tm_o, q_tile + a * S_::Q_ATOM, 64 * a, h, q0 + 64 * c, b);
  }
}

// A map of the heads of a [B, N, ld] bf16 tensor: {D, H, N, B} (head h at
// channels [Dh, Dh + D)), a {64, 1, rows, 1} box. Lanes of a box past D and
// rows past N read as zeros and are not stored. With `stride` > 1 the map
// takes every stride-th row, ceil(N / stride) of them (the shifted mode's
// sample of K).
bool encode(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, int B, int H,
            int N, int D, int ld, int rows, int stride = 1) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H,
                              (cuuint64_t)cdiv(N, stride), (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)ld * stride * 2,
                                 (cuuint64_t)N * ld * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return encode_bf16_sw128(fn, map, ptr, 4, dims, strides, box);
}

// The shared-memory limit of a kernel, set once per device (a bit per
// device of `done`): cudaFuncSetAttribute costs a few microseconds, and
// the host time of a call bounds the small SD1.x ones.
template <typename K>
cudaError_t set_smem_once(K kernel, int smem, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;  // above 32: every launch
  if (bit != 0 && (done.load(std::memory_order_acquire) & bit)) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int D, bool ONLINE, bool LSE>
cudaError_t launch(const CUtensorMap* maps, float* lse, int B, int H, int nq,
                   int nk, int n_sub, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_sm90_kernel<D, ONLINE, LSE>;
  constexpr int smem = Shape<D, Tune<D, ONLINE>::STAGES>::SMEM_REQUEST;
  static std::atomic<unsigned> attribute_set{0};
  cudaError_t err = set_smem_once(kernel, smem, attribute_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + BQ - 1) / BQ, B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], lse, H, nq, nk, n_sub,
      scale * kLog2e);
  return cudaGetLastError();
}

// Online: the training forward (with the lse) when `lse` is given, else
// the serving forward. Shifted: the serving forward, which writes its row
// shift into `lse` when given.
template <int D>
cudaError_t launch_mode(const CUtensorMap* maps, float* lse, int B, int H,
                        int nq, int nk, int n_sub, float scale, int online,
                        cudaStream_t stream) {
  if (!online)
    return launch<D, false, false>(maps, lse, B, H, nq, nk, n_sub, scale,
                                   stream);
  if (lse != nullptr)
    return launch<D, true, true>(maps, lse, B, H, nq, nk, n_sub, scale,
                                 stream);
  return launch<D, true, false>(maps, lse, B, H, nq, nk, n_sub, scale,
                                stream);
}

// The five maps of a call: q, k, v, o and (shifted mode) K's sampled rows;
// online, the fifth is k's, unread.
bool encode_maps(EncodeTiledFn fn, CUtensorMap* maps, const void* q,
                 const void* k, const void* v, void* o, int B, int H, int nq,
                 int nk, int D, int ldq, int ldkv, int ldo, int stride,
                 int online) {
  const int bk = D > 128 ? 64 : 128;  // Shape<D, .>::BK
  if (!encode(fn, &maps[0], q, B, H, nq, D, ldq, BQ) ||
      !encode(fn, &maps[1], k, B, H, nk, D, ldkv, bk) ||
      !encode(fn, &maps[2], v, B, H, nk, D, ldkv, bk) ||
      !encode(fn, &maps[3], o, B, H, nq, D, ldo, 64))
    return false;
  if (online) {
    maps[4] = maps[1];
    return true;
  }
  return encode(fn, &maps[4], k, B, H, nk, D, ldkv, bk, stride);
}

}  // namespace

extern "C" {

// The forward at head width D (40, 64, 80 or 160), called by
// mt_flash_attention_fwd and mt_flash_attention_fwd_lse (flash_attention.cu).
// q and o are [B, nq, ldq/ldo], k and v [B, nk, ldkv] bf16, 16-byte
// aligned, with row strides a multiple of 8 elements (TMA's 16-byte rule).
// Shifted mode (online = 0): the kernel computes the row shift from K's
// rows 0, stride, 2 stride, ... < nk, n_sub = ceil(nk / stride) <= 255 of
// them, and writes it into `lse` ([B*H, nq] fp32, natural-log units) when
// that is not null. Online: `lse` [B*H, nq] fp32 or null (the training
// forward's logsumexp); stride and n_sub are ignored. Returns cudaSuccess
// or the error of the checks, the map encoding, the attribute call or the
// launch.
int mt_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                      void* lse, int B, int H, int nq, int nk, int D, int ldq,
                      int ldkv, int ldo, int stride, int n_sub, float scale,
                      int online, void* stream) {
  if (B < 1 || H < 1 || nq < 1 || nk < 1 || ldq % 8 || ldkv % 8 || ldo % 8 ||
      ldq < D * H || ldkv < D * H || ldo < D * H ||
      (!online && (stride < 1 || n_sub > kMaxSample ||
                   n_sub != cdiv(nk, stride))))
    return (int)cudaErrorInvalidValue;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap maps[5];
  if (!encode_maps(fn, maps, q, k, v, o, B, H, nq, nk, D, ldq, ldkv, ldo,
                   stride, online))
    return (int)cudaErrorInvalidValue;
  float* ls = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40:
      return launch_mode<40>(maps, ls, B, H, nq, nk, n_sub, scale, online, st);
    case 64:
      return launch_mode<64>(maps, ls, B, H, nq, nk, n_sub, scale, online, st);
    case 80:
      return launch_mode<80>(maps, ls, B, H, nq, nk, n_sub, scale, online, st);
    case 160:
      return launch_mode<160>(maps, ls, B, H, nq, nk, n_sub, scale, online,
                              st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The host nanoseconds of one call's map encoding (the mean of `reps`
// encodings of mt_flash_fwd_sm90's maps for these arguments), or -1 if one
// fails: what caching the maps could save a call (chip_smoke.py).
double mt_flash_fwd_maps_ns(const void* q, const void* k, const void* v,
                            void* o, int B, int H, int nq, int nk, int D,
                            int ldq, int ldkv, int ldo, int stride,
                            int online, int reps) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || reps < 1) return -1.0;
  CUtensorMap maps[5];
  const auto t0 = std::chrono::steady_clock::now();
  for (int r = 0; r < reps; ++r)
    if (!encode_maps(fn, maps, q, k, v, o, B, H, nq, nk, D, ldq, ldkv, ldo,
                     stride, online))
      return -1.0;
  const std::chrono::duration<double, std::nano> dt =
      std::chrono::steady_clock::now() - t0;
  return dt.count() / reps;
}

}  // extern "C"
