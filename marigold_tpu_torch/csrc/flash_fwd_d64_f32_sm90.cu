// Flash-attention forward in fp32 storage (`--full_precision` serving,
// fp32 fine-tuning's training forward, the folded entry) for heads 40, 64,
// 80 and 160 wide (a template on the head width D; the file kept its name
// from the 64-wide kernel it began as), designed for Hopper (sm_90a):
// 3xTF32 products on wgmma (tf32x3.cuh), TMA loads into an mbarrier ring, a
// producer warp and two consumer warpgroups that each own 64 query rows.
//
// Replaces the fp32 instantiations at those widths (SD2's 64-wide heads;
// the 40-, 80- and 160-wide heads of an SD1.x-class UNet) of the TPU
// package's marigold_tpu/ops/flash_attention.py kernels:
//   * _flash_kernel_dt_shifted (shifted softmax; pallas_call at :396), every
//     UNet self-attention of an fp32 request, and the row shift its wrapper
//     _flash_dt_impl computes outside it (:362-373), which this kernel
//     computes in its own launch;
//   * _flash_kernel_dt (exact online softmax; :460), the parity pin;
//   * _flash_kernel through flash_attention (the folded [BH, N, D] entry;
//     :522), run online with one head per batch row;
//   * _flash_kernel_dt_lse (the training forward; :638): online, and it
//     writes the row logsumexp the backward kernels
//     (flash_bwd_dq_f32_sm90.cu, flash_bwd_dkv_f32_sm90.cu) read.
// At D = 64 it took the place of a CUDA-core FFMA design (64 x 64 tiles,
// one in flight; 4.058 ms shifted and 3.772 ms online at [1, 9216, 320]
// h = 5, PERF.md). The 512-wide fp32 forward is flash_fwd_d512_f32_sm90.cu.
//
// Math per (batch, head, query row r), as the plain version
// (ops/flash_attention.py:_plain_forward) computes it in fp32:
//   s_j = (q_r . k_j) / sqrt(D);
//   shifted: p_j = exp(min(s_j - shift_r, 75)), shift_r = max of s_j over
//            the sampled keys j = 0, stride, 2 stride, ... < nk (stride =
//            max(1, nk // 128), n_sub <= 255 of them) + 40, computed by the
//            kernel (below);
//   online:  running max m, p_j = exp(s_j - m), O and l rescaled by
//            exp(m_old - m_new) when the max grows;
//   out_r = (sum_j p_j v_j) / max(sum_j p_j, 1e-30), stored fp32;
//   lse (training): lse_r = m + log(max(sum_j p_j, 1e-30)), [B*H, nq] fp32.
// Both products are 3xTF32 (lo.hi + hi.lo + hi.hi in the fp32
// accumulator, ~2^-21 per product); l sums the fp32 p_j. Every exponential
// is exp2 on logits scaled by log2(e)/sqrt(D), with the shift, the clamp
// (75 log2(e)) and the running max in the same base-2 units, so the lse is
// written as ln(2) (m_2 + log2(l)). Key columns j >= nk get s_j = -1e30
// (p_j = 0, against zeros of v^T); query rows r >= nq are computed on TMA's
// zero fill and not stored.
//
// Operands (ops/flash_attention.py:_launch_forward and flash_attention_lse,
// one tf32_split.cu launch before this one): q and k as hi and lo copies in
// their [B, N, ld] layout, v as hi and lo copies of v^T, [B, ld, NKP] (NKP
// = nk rounded up to 8, the keys past nk zeros, keys permuted in groups of
// 8 so that P's accumulator registers are its A fragments: tf32x3.cuh).
// Every copy has a 4-D TMA map whose dimensions name the head: q and k
// {D, H, N, B} with a {32, 1, rows, 1} box (32 fp32 lanes: one 128-byte
// swizzle row), v^T {NKP, D, H, B} with a {32 keys, 64 rows, 1, 1} box. A
// box's lanes or rows past D lie outside the map and read as zeros, never
// the next head's; the head stride (4 D bytes) is a multiple of 16 for D a
// multiple of 4.
//
// The design, per CTA of 128 query rows of one (b, h):
//   * Q hi and lo resident, each QB = ceil(D / 32) boxes of {32, 128 rows}
//     (16 KB each); consumer c owns query rows [64c, 64c + 64);
//   * per 64-key tile KS = ceil(D / 64) K substages (hi and lo of two
//     32-lane boxes, the last one where D ends inside it) and NV =
//     ceil(D / 64) V^T substages (hi and lo of 64 rows of v^T, 32 keys per
//     box) go through a ring of 32 KB slots, each consumed by both
//     consumers (every consumer thread arrives on its empty barrier, no
//     branch among wgmmas in flight);
//   * S = Q K^T contracts over D / 8 k8 steps, three wgmma m64n64k8 each,
//     both operands in shared memory, one commit group per K substage
//     (started when its slot is full, waited and released); the consumer
//     masks the ragged key tile, runs the softmax in registers (online: the
//     row max over the quad of lanes that share a row, O and l rescaled),
//     splits P into hi and lo A fragments and, per V^T substage, runs
//     P V^T (24 wgmma with A from registers, 64 output columns, those past
//     D zeros) into a fresh accumulator, waits and adds it into that
//     substage's part of O with fp32 adds (the tensor cores' own
//     accumulation truncates: over 9216 keys in one accumulator ~7e-5 of
//     the output's scale, tf32x3.cuh). Registers: S, the tile product, P's
//     lo fragments (32 each) and O (32 per V^T substage): 128 at D <= 64,
//     160 at D = 80, 192 at D = 160, of the consumers' 240;
//   * the epilogue reduces l over the quad, divides and stores fp32 straight
//     from registers (two floats per thread per 8 columns, the columns past
//     D skipped), rows past nq skipped, and with the lse one float per row.
//   * shifted mode, before the key loop: ceil(n_sub / 64) sample tiles,
//     each KS K substages (hi and lo) read through two more maps over
//     k_hi and k_lo, {D, H, n_sub, B} with a row stride of stride * ld
//     elements, rows past n_sub zero-filled, go through the same ring
//     first; each consumer computes their S with the main loop's 3xTF32
//     products (the same hi/lo terms, so the sampled max is the kernel's
//     own logit up to accumulation order), masks the columns >= n_sub,
//     takes the row max over its quad and sets shift = max * scale *
//     log2(e) + 40 log2(e); no exponential, no P V. When the `lse` pointer
//     is given the shifted mode writes that shift into it (natural-log
//     units), for the tests. The TPU wrapper computes the shift outside its
//     kernel; on the card that chain of eager launches cost up to half the
//     kernel's time.
// Shared memory: Q hi and lo (32 KB per box pair) + a ring of STAGES x 32 KB
// + barriers: at D = 40 and 64, 64 KB + 4 slots = 192 KB; at D = 80, 96 KB
// + 4 slots = 224 KB; at D = 160, 160 KB + 2 slots = 224 KB (the producer
// keeps one substage ahead there).
//
// What bounds it on the H100: per head 4 N^2 D FLOPs, x3 for the tf32
// passes, with P V padded to 64-column products (at D = 40 64 columns, at
// D = 80 128, at D = 160 192). At [1, 9216, 320] h = 5 (D = 64) 0.326
// TFLOP, 0.659 ms at 495 TFLOP/s. Each CTA reads 32 KB of ring per
// substage from L2 (at that shape 360 CTAs x 144 tiles x 2 substages, 3.4
// GB per call, ~0.5 ms at ~7 TB/s), and each consumer runs ~8 exp2/FMA per
// tensor k8 step. A consumer does not overlap one tile's softmax with the
// next tile's S (the two consumers, each on its own rows, fill each
// other's gaps).

#include "tf32x3.cuh"

namespace {

constexpr int BQ = 128;           // query rows per CTA (2 x 64)
constexpr int BK = 64;            // keys per tile
constexpr int CONSUMERS = 2;      // consumer warpgroups
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int SLOT_BYTES = 4 * ATT_BOX;     // hi (2 boxes), lo (2 boxes)
constexpr int RES_BOX = ATT_RES_BOX;        // {32 fp32, 128 rows}: 16 KB

// The shapes of the instantiation at head width D.
template <int D>
struct Shape {
  static_assert(D % 8 == 0 && D <= 160, "D a multiple of 8, at most 160");
  static constexpr int QB = (D + 31) / 32;    // 32-lane boxes of a q/k row
  static constexpr int KS = (D + 63) / 64;    // K substages per key tile
  static constexpr int NV = (D + 63) / 64;    // V^T substages: 64 columns
  static constexpr int SUBS = KS + NV;
  static constexpr int STAGES = D > 128 ? 2 : 4;  // ring slots
  static constexpr int RES_BYTES = QB * RES_BOX;  // one part of the Q tile
  // Shared memory: Q_hi, Q_lo, the ring, then the barriers (full[STAGES],
  // empty[STAGES], resident); every box 1024-byte aligned.
  static constexpr int SM_QH = 0;
  static constexpr int SM_QL = RES_BYTES;
  static constexpr int SM_RING = 2 * RES_BYTES;
  static constexpr int SM_BAR = SM_RING + STAGES * SLOT_BYTES;
  static constexpr int SM_BYTES = SM_BAR + 8 * (2 * STAGES + 1);
  static constexpr int SMEM_REQUEST = SM_BYTES + 1024;  // room to align
  static_assert(SMEM_REQUEST <= 232448, "fits the 227 KB a block can use");
};

constexpr float kNegInf = -1e30f;  // the TPU kernels' NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kClamp2 = 75.0f * 1.4426950408889634f;  // exp clamp, base 2
constexpr float kMargin2 = 40.0f * 1.4426950408889634f;  // shift margin, base 2
constexpr int kMaxSample = 255;  // sampled keys: max(1, nk // 128) strides

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
// d[4j + 2 + e] the same columns of row 16w + l/4 + 8 (e in {0, 1}). Here
// rows are query rows and columns keys (S, P) or head columns (O).
template <int D, bool ONLINE, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap tm_qh,
                     const __grid_constant__ CUtensorMap tm_ql,
                     const __grid_constant__ CUtensorMap tm_kh,
                     const __grid_constant__ CUtensorMap tm_kl,
                     const __grid_constant__ CUtensorMap tm_vh,
                     const __grid_constant__ CUtensorMap tm_vl,
                     const __grid_constant__ CUtensorMap tm_ksh,
                     const __grid_constant__ CUtensorMap tm_ksl,
                     float* __restrict__ out, float* __restrict__ lse,
                     int H, int nq, int nk, int n_sub, int ldo,
                     float scale_log2) {
  using S_ = Shape<D>;
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
  const int q0 = blockIdx.x * BQ;
  const int n_tiles = cdiv(nk, BK);
  // shifted mode: the sample tiles of K that go through the ring first
  const int n_pre = ONLINE ? 0 : cdiv(n_sub, BK);

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
      // the resident Q tile, hi and lo, QB boxes each
      mbar_expect_tx(res, 2 * S_::RES_BYTES);
#pragma unroll
      for (int i = 0; i < S_::QB; ++i) {
        tma_load_4d(base + S_::SM_QH + i * RES_BOX, &tm_qh, 32 * i, h, q0, b,
                    res);
        tma_load_4d(base + S_::SM_QL + i * RES_BOX, &tm_ql, 32 * i, h, q0, b,
                    res);
      }
      // per 64 keys: KS substages of K (row-major), NV of V^T (transposed);
      // in shifted mode the sample tiles' K substages first
      const CUtensorMap* k_maps[2] = {&tm_kh, &tm_kl};
      const CUtensorMap* s_maps[2] = {&tm_ksh, &tm_ksl};
      const CUtensorMap* v_maps[2] = {&tm_vh, &tm_vl};
      // [B, nk, ld] (or the sample's rows): 64 keys, 32 d lanes per box
      auto load_k = [&](const CUtensorMap* const* maps, int row, int sub,
                        int n) {
        const int slot = n % STAGES;
        const uint32_t full = full0 + 8 * slot;
        const uint32_t dst = base + S_::SM_RING + slot * SLOT_BYTES;
        if (n >= STAGES) mbar_wait(empty0 + 8 * slot, (n / STAGES - 1) & 1);
        const int boxes = S_::QB - 2 * sub < 2 ? 1 : 2;
        mbar_expect_tx(full, 2 * boxes * ATT_BOX);
#pragma unroll
        for (int part = 0; part < 2; ++part)    // hi, lo
#pragma unroll
          for (int half = 0; half < boxes; ++half)
            tma_load_4d(dst + (2 * part + half) * ATT_BOX, maps[part],
                        32 * (2 * sub + half), h, row, b, full);
      };
      int n = 0;
      for (int j = 0; j < n_pre; ++j) {
#pragma unroll
        for (int sub = 0; sub < KS; ++sub, ++n) load_k(s_maps, j * BK, sub, n);
      }
      for (int j = 0; j < n_tiles; ++j) {
#pragma unroll
        for (int sub = 0; sub < SUBS; ++sub, ++n) {
          if (sub < KS) {
            load_k(k_maps, j * BK, sub, n);
            continue;
          }
          // [B, ld, NKP]: 64 d rows of the head, 32 keys per box
          const int slot = n % STAGES;
          const uint32_t full = full0 + 8 * slot;
          const uint32_t dst = base + S_::SM_RING + slot * SLOT_BYTES;
          if (n >= STAGES) mbar_wait(empty0 + 8 * slot, (n / STAGES - 1) & 1);
          mbar_expect_tx(full, SLOT_BYTES);
#pragma unroll
          for (int part = 0; part < 2; ++part)
#pragma unroll
            for (int half = 0; half < 2; ++half)
              tma_load_4d(dst + (2 * part + half) * ATT_BOX, v_maps[part],
                          j * BK + 32 * half, 64 * (sub - KS), h, b, full);
        }
      }
    }
    return;
  }

  // Consumer warpgroup c: query rows [64c, 64c + 64) of the CTA.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;  // this thread's rows r0, r0 + 8
  const int col = 2 * (lane % 4);           // its column pair in each 8
  const uint32_t rows = c * 64 * 128;       // its rows inside each box
  const uint32_t qh = base + S_::SM_QH + rows, ql = base + S_::SM_QL + rows;
  const int row0 = q0 + 64 * c + r0;        // global query rows
  const int row1 = row0 + 8;

  float s[32], part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = part[i] = 0.f;

  auto slot_of = [&](int n) {
    return base + S_::SM_RING + (n % STAGES) * SLOT_BYTES;
  };
  auto wait_full = [&](int n) {
    mbar_wait(full0 + 8 * (n % STAGES), (n / STAGES) & 1);
  };
  auto release = [&](int n) { mbar_arrive(empty0 + 8 * (n % STAGES)); };

  mbar_wait(res, 0);
  float sh0 = 0.f, sh1 = 0.f;  // shifted mode: the row shift, base 2
  if (!ONLINE) {
    // The sample pass: S on the sampled keys (3xTF32, as below), columns
    // >= n_sub masked, the row max over the quad, plus the margin.
    float mx0 = kNegInf, mx1 = kNegInf;
    for (int j = 0; j < n_pre; ++j) {
#pragma unroll
      for (int sub = 0; sub < KS; ++sub) {
        wait_full(j * KS + sub);
        wgmma_att_nt<D>(s, qh, ql, RES_BOX, slot_of(j * KS + sub), sub);
        wgmma_wait<0>();
        fence_regs(s);
        release(j * KS + sub);
      }
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (j * BK + 8 * jj + col + e < n_sub) {
            mx0 = fmaxf(mx0, s[4 * jj + e]);
            mx1 = fmaxf(mx1, s[4 * jj + 2 + e]);
          }
        }
      }
    }
    sh0 = fmaf(quad_max(mx0), scale_log2, kMargin2);
    sh1 = fmaf(quad_max(mx1), scale_log2, kMargin2);
    if (lse != nullptr && col == 0) {
      if (row0 < nq) lse[(size_t)bh * nq + row0] = sh0 * kLn2;
      if (row1 < nq) lse[(size_t)bh * nq + row1] = sh1 * kLn2;
    }
  }
  float m0 = kNegInf, m1 = kNegInf;  // running max (online), base 2
  float l0 = 0.f, l1 = 0.f;          // this thread's part of its row sums
  float o[NV][32];                   // output columns [64v, 64v + 64)
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[v][i] = 0.f;
  uint32_t lo[32];

  // n: the tile's first ring slot, after the sample's (a running count:
  // computing it from j and n_pre cost ptxas the registers to pipeline the
  // D = 160 wgmmas, C7511)
  for (int j = 0, n = n_pre * KS; j < n_tiles; ++j, n += SUBS) {
    // S = Q K^T, 3xTF32 over the D / 8 k8 steps, one commit group per K
    // substage; the first step overwrites S.
#pragma unroll
    for (int sub = 0; sub < KS; ++sub) {
      wait_full(n + sub);
      wgmma_att_nt<D>(s, qh, ql, RES_BOX, slot_of(n + sub), sub);
      wgmma_wait<0>();
      fence_regs(s);
      release(n + sub);
    }

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
      for (int v = 0; v < NV; ++v) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          o[v][4 * i] *= a0;
          o[v][4 * i + 1] *= a0;
          o[v][4 * i + 2] *= a1;
          o[v][4 * i + 3] *= a1;
        }
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
    // O += P V^T per 64 output columns: P's hi and lo fragments, each
    // substage's product into a fresh accumulator, added into its part of
    // O with fp32 adds (tf32x3.cuh)
    acc_to_tf32x2<0>(s, lo);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      wait_full(n + KS + v);
      wgmma_att_nn(part, s, lo, slot_of(n + KS + v));
      wgmma_wait<0>();
      fence_regs(part);
      fence_regs(s);
      fence_regs(lo);
      release(n + KS + v);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[v][i] += part[i];
    }
  }

  const float sum0 = fmaxf(quad_sum(l0), 1e-30f);
  const float sum1 = fmaxf(quad_sum(l1), 1e-30f);
  const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
  float* ob = out + (size_t)b * nq * ldo + h * D + col;
  if (row0 < nq) {
    float* dst = ob + (size_t)row0 * ldo;
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (64 * v + 8 * i < D)
          *reinterpret_cast<float2*>(dst + 64 * v + 8 * i) =
              make_float2(o[v][4 * i] * inv0, o[v][4 * i + 1] * inv0);
    if (LSE && col == 0)
      lse[(size_t)bh * nq + row0] = kLn2 * (m0 + log2f(sum0));
  }
  if (row1 < nq) {
    float* dst = ob + (size_t)row1 * ldo;
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (64 * v + 8 * i < D)
          *reinterpret_cast<float2*>(dst + 64 * v + 8 * i) =
              make_float2(o[v][4 * i + 2] * inv1, o[v][4 * i + 3] * inv1);
    if (LSE && col == 0)
      lse[(size_t)bh * nq + row1] = kLn2 * (m1 + log2f(sum1));
  }
}

// The TMA maps of one call: q_hi, q_lo, k_hi, k_lo ([B, N, ld]), vt_hi,
// vt_lo ([B, ld, round_up(nk, 8)]) and the shifted mode's sample of k_hi
// and k_lo (every stride-th row; `stride` 0 for a call that reads none).
// False if the encode refuses one.
bool encode_maps(CUtensorMap (&maps)[8], const void* const (&ptrs)[6], int B,
                 int H, int nq, int nk, int D, int ld, int stride) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const int nkp = (nk + 7) / 8 * 8;
  const bool ok =
      encode_heads(fn, &maps[0], ptrs[0], B, H, nq, D, ld, BQ) &&
      encode_heads(fn, &maps[1], ptrs[1], B, H, nq, D, ld, BQ) &&
      encode_heads(fn, &maps[2], ptrs[2], B, H, nk, D, ld, BK) &&
      encode_heads(fn, &maps[3], ptrs[3], B, H, nk, D, ld, BK) &&
      encode_heads_t(fn, &maps[4], ptrs[4], B, H, nkp, D, ld) &&
      encode_heads_t(fn, &maps[5], ptrs[5], B, H, nkp, D, ld);
  if (!ok || stride == 0) {
    maps[6] = maps[2];  // unread
    maps[7] = maps[3];
    return ok;
  }
  return encode_heads(fn, &maps[6], ptrs[2], B, H, nk, D, ld, BK, stride) &&
         encode_heads(fn, &maps[7], ptrs[3], B, H, nk, D, ld, BK, stride);
}

template <int D, bool ONLINE, bool LSE>
cudaError_t launch(const CUtensorMap (&maps)[8], float* out, float* lse,
                   int B, int H, int nq, int nk, int n_sub, int ldo,
                   float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_f32_kernel<D, ONLINE, LSE>;
  constexpr int smem = Shape<D>::SMEM_REQUEST;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(nq, BQ), B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7],
      out, lse, H, nq, nk, n_sub, ldo, scale * kLog2e);
  return cudaGetLastError();
}

// Online: the serving forward. Shifted: the serving forward, which writes
// its row shift into `shift_out` when given.
template <int D>
cudaError_t launch_mode(const CUtensorMap (&maps)[8], float* out,
                        float* shift_out, int B, int H, int nq, int nk,
                        int n_sub, int ldo, int online, float scale,
                        cudaStream_t stream) {
  if (online)
    return launch<D, true, false>(maps, out, nullptr, B, H, nq, nk, n_sub,
                                  ldo, scale, stream);
  return launch<D, false, false>(maps, out, shift_out, B, H, nq, nk, n_sub,
                                 ldo, scale, stream);
}

bool bad_args(int B, int H, int nq, int nk, int D, int ld, int ldo) {
  return B < 1 || H < 1 || B * H > 65535 || nq < 1 || nk < 1 ||
         ld != D * H || ldo % 2 || ldo < D * H;
}

}  // namespace

extern "C" {

// The fp32 serving forward at head width D (40, 64, 80 or 160) on split
// operands (tf32_split.cu): q_hi/q_lo [B, nq, ld], k_hi/k_lo [B, nk, ld],
// vt_hi/vt_lo [B, ld, round_up(nk, 8)] fp32, all 16-byte aligned, ld = D H;
// o [B, nq, ldo] fp32 with ldo a multiple of 2. Shifted mode (online = 0):
// the kernel computes the row shift from K's rows 0, stride, 2 stride, ...
// < nk, n_sub = ceil(nk / stride) <= 255 of them, and writes it into
// `shift_out` ([B*H, nq] fp32, natural-log units) when that is not null;
// online: `shift_out` null, stride and n_sub ignored. Returns cudaSuccess
// (0) or the error of the checks, the map encoding, the attribute call or
// the launch; any other D returns cudaErrorInvalidValue.
int mt_flash_fwd_f32(const void* q_hi, const void* q_lo, const void* k_hi,
                     const void* k_lo, const void* vt_hi, const void* vt_lo,
                     void* o, void* shift_out, int B, int H, int nq, int nk,
                     int D, int ld, int ldo, int online, int stride, int n_sub,
                     float scale, void* stream) {
  if (bad_args(B, H, nq, nk, D, ld, ldo) ||
      (online && shift_out != nullptr) ||
      (!online && (stride < 1 || n_sub > kMaxSample ||
                   n_sub != cdiv(nk, stride))))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[8];
  if (!encode_maps(maps, {q_hi, q_lo, k_hi, k_lo, vt_hi, vt_lo}, B, H, nq, nk,
                   D, ld, online ? 0 : stride))
    return (int)cudaErrorInvalidValue;
  float* of = static_cast<float*>(o);
  float* sh = static_cast<float*>(shift_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40:
      return (int)launch_mode<40>(maps, of, sh, B, H, nq, nk, n_sub, ldo,
                                  online, scale, st);
    case 64:
      return (int)launch_mode<64>(maps, of, sh, B, H, nq, nk, n_sub, ldo,
                                  online, scale, st);
    case 80:
      return (int)launch_mode<80>(maps, of, sh, B, H, nq, nk, n_sub, ldo,
                                  online, scale, st);
    case 160:
      return (int)launch_mode<160>(maps, of, sh, B, H, nq, nk, n_sub, ldo,
                                   online, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The training forward at head width D (40, 64, 80 or 160): online, and
// lse [B*H, nq] fp32 in natural-log units. Other arguments as
// mt_flash_fwd_f32's.
int mt_flash_fwd_lse_f32(const void* q_hi, const void* q_lo, const void* k_hi,
                         const void* k_lo, const void* vt_hi,
                         const void* vt_lo, void* o, void* lse, int B, int H,
                         int nq, int nk, int D, int ld, int ldo, float scale,
                         void* stream) {
  if (bad_args(B, H, nq, nk, D, ld, ldo) || lse == nullptr)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[8];
  if (!encode_maps(maps, {q_hi, q_lo, k_hi, k_lo, vt_hi, vt_lo}, B, H, nq, nk,
                   D, ld, 0))
    return (int)cudaErrorInvalidValue;
  float* of = static_cast<float*>(o);
  float* ls = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40:
      return (int)launch<40, true, true>(maps, of, ls, B, H, nq, nk, nk, ldo,
                                         scale, st);
    case 64:
      return (int)launch<64, true, true>(maps, of, ls, B, H, nq, nk, nk, ldo,
                                         scale, st);
    case 80:
      return (int)launch<80, true, true>(maps, of, ls, B, H, nq, nk, nk, ldo,
                                         scale, st);
    case 160:
      return (int)launch<160, true, true>(maps, of, ls, B, H, nq, nk, nk, ldo,
                                          scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* mt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
