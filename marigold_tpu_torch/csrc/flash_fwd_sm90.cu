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
// multiple of 8), as ops/flash_attention.py:check_tma checks.
//
// Padded widths: QK^T contracts over KSTEPS = ceil(D / 16) k16 steps (48
// lanes at D = 40, the 8 past D zero in both operands); P V runs one
// m64n64 product per atom (64, 128 or 192 output columns), the columns
// past D zeros of V, computed and never stored.
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
// Registers per consumer thread: S (BK/2), P (BK/4) and O (32 per atom).
// At D = 160 O takes 96, so that width runs 64-key tiles (BK = 64: S 32,
// P 16); the others 128-key tiles. Shared memory: Q (BQ x 128 B per atom)
// and two K/V stages (2 x BK x 128 B per atom each): 80 KB at D = 40 and
// 64, 160 KB at D = 80, 144 KB at D = 160.
//
// At D = 40 the exponentials bind rather than the tensor cores: one exp2
// per logit against 4 D = 160 FLOPs of products per logit, and the card's
// special-function units (16 exp2 per SM per clock) finish fewer
// exponentials per second than its tensor cores finish those FLOPs.
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

#include "sm90.cuh"

namespace {

constexpr int BQ = 128;           // query rows per block (2 x 64)
constexpr int KV_STAGES = 2;      // K/V tiles in flight
constexpr int CONSUMERS = 2;      // consumer warpgroups
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int ROW_BYTES = 128;    // one 64-lane bf16 swizzle atom row

// The shapes of the instantiation at head width D.
template <int D>
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
  static constexpr int SM_V = SM_K + KV_STAGES * KV_BYTES;
  static constexpr int SM_BAR = SM_V + KV_STAGES * KV_BYTES;
  static constexpr int SM_BYTES = SM_BAR + 8 * (2 * KV_STAGES + 1);
  static constexpr int SMEM_REQUEST = SM_BYTES + 1024;  // room to align
  static_assert(SMEM_REQUEST <= 232448, "fits the 227 KB a block can use");
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
  using S_ = Shape<D>;
  constexpr int ATOMS = S_::ATOMS;
  constexpr int BK = S_::BK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_full = base + S_::SM_BAR;             // [KV_STAGES]
  const uint32_t bar_empty = bar_full + 8 * KV_STAGES;     // [KV_STAGES]
  const uint32_t bar_q = bar_empty + 8 * KV_STAGES;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int n_tiles = (nk + BK - 1) / BK;
  // shifted mode: the sample tiles of K that go through the ring first
  const int n_pre = ONLINE ? 0 : (n_sub + BK - 1) / BK;

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
    // Producer warpgroup: one thread starts every TMA load, one box per
    // 64-lane atom of the head.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, S_::Q_BYTES);
#pragma unroll
      for (int a = 0; a < ATOMS; ++a)
        tma_load_4d(base + S_::SM_Q + a * S_::Q_ATOM, &tm_q, 64 * a, h, q0, b,
                    bar_q);
      for (int it = 0; it < n_pre + n_tiles; ++it) {
        const int st = it % KV_STAGES;
        if (it >= KV_STAGES)
          mbar_wait(bar_empty + 8 * st, ((it / KV_STAGES) - 1) & 1);
        const bool sample = it < n_pre;  // K's sampled rows only
        mbar_expect_tx(bar_full + 8 * st, (sample ? 1 : 2) * S_::KV_BYTES);
#pragma unroll
        for (int a = 0; a < ATOMS; ++a) {
          const uint32_t off = st * S_::KV_BYTES + a * S_::KV_ATOM;
          if (sample) {
            tma_load_4d(base + S_::SM_K + off, &tm_ks, 64 * a, h, it * BK, b,
                        bar_full + 8 * st);
          } else {
            const int k0 = (it - n_pre) * BK;
            tma_load_4d(base + S_::SM_K + off, &tm_k, 64 * a, h, k0, b,
                        bar_full + 8 * st);
            tma_load_4d(base + S_::SM_V + off, &tm_v, 64 * a, h, k0, b,
                        bar_full + 8 * st);
          }
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
  uint32_t p[BK / 4];

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

  mbar_wait(bar_q, 0);
  float sh0 = 0.f, sh1 = 0.f;  // shifted mode: the row shift, base 2
  if (!ONLINE) {
    // The sample pass: S on the sampled keys, columns >= n_sub masked, the
    // row max over the quad, plus the margin.
    float mx0 = kNegInf, mx1 = kNegInf;
    for (int it = 0; it < n_pre; ++it) {
      const int st = it % KV_STAGES;
      mbar_wait(bar_full + 8 * st, (it / KV_STAGES) & 1);
      issue_qk(st);
      wgmma_wait<0>();
      fence_regs(s);
      if (t == 0) mbar_arrive(bar_empty + 8 * st);  // release sample stage st
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
  float o[ATOMS][32];                // output columns [64a, 64a + 64)
#pragma unroll
  for (int a = 0; a < ATOMS; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[a][i] = 0.f;

  mbar_wait(bar_full + 8 * (n_pre % KV_STAGES), (n_pre / KV_STAGES) & 1);
  issue_qk(n_pre % KV_STAGES);
  wgmma_wait<0>();
  fence_regs(s);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = (n_pre + it) % KV_STAGES;
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
      for (int a = 0; a < ATOMS; ++a) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[a][4 * j] *= a0;
          o[a][4 * j + 1] *= a0;
          o[a][4 * j + 2] *= a1;
          o[a][4 * j + 3] *= a1;
        }
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
    for (int i = 0; i < BK / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);

    // O += P V on this stage's V, one product per atom of output columns,
    // then (while they run) the next QK^T.
    const uint32_t v_tile = base + S_::SM_V + st * S_::KV_BYTES;
#pragma unroll
    for (int a = 0; a < ATOMS; ++a) fence_regs(o[a]);
    fence_regs(p);
    wgmma_fence();
#pragma unroll
    for (int a = 0; a < ATOMS; ++a) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n64k16_rs(o[a], p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                           p[4 * kk + 3],
                           mnmajor_desc(v_tile + a * S_::KV_ATOM + 2048 * kk));
    }
    wgmma_commit();
    if (it + 1 < n_tiles) {
      const int nst = (n_pre + it + 1) % KV_STAGES;
      mbar_wait(bar_full + 8 * nst, ((n_pre + it + 1) / KV_STAGES) & 1);
      issue_qk(nst);
      wgmma_wait<1>();  // P V of this tile is done; QK^T may still run
    } else {
      wgmma_wait<0>();
    }
    if (t == 0) mbar_arrive(bar_empty + 8 * st);  // release K/V stage st
    wgmma_wait<0>();
    fence_regs(s);
#pragma unroll
    for (int a = 0; a < ATOMS; ++a) fence_regs(o[a]);
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

template <int D, bool ONLINE, bool LSE>
cudaError_t launch(const CUtensorMap* maps, float* lse, int B, int H, int nq,
                   int nk, int n_sub, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_sm90_kernel<D, ONLINE, LSE>;
  constexpr int smem = Shape<D>::SMEM_REQUEST;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
  const int bk = D > 128 ? 64 : 128;  // Shape<D>::BK
  CUtensorMap maps[5];
  if (!encode(fn, &maps[0], q, B, H, nq, D, ldq, BQ) ||
      !encode(fn, &maps[1], k, B, H, nk, D, ldkv, bk) ||
      !encode(fn, &maps[2], v, B, H, nk, D, ldkv, bk) ||
      !encode(fn, &maps[3], o, B, H, nq, D, ldo, 64))
    return (int)cudaErrorInvalidValue;
  if (online)
    maps[4] = maps[1];  // unread
  else if (!encode(fn, &maps[4], k, B, H, nk, D, ldkv, bk, stride))
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

}  // extern "C"
