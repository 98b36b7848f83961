// Flash-attention backward dQ in fp32 storage (fp32 fine-tuning) for heads
// 40, 64, 80 and 160 wide (a template on the head width D), designed for
// Hopper (sm_90a): 3xTF32 products on wgmma (tf32x3.cuh), TMA loads into
// an mbarrier ring, a producer warp and two consumer warpgroups, no
// atomics. Its partner is flash_bwd_dkv_f32_sm90.cu (dK and dV), with the
// roles of queries and keys swapped.
//
// Replaces the fp32 instantiations at those widths (SD2's 64-wide heads;
// the 40-, 80- and 160-wide heads of an SD1.x-class UNet) of the TPU
// package's marigold_tpu/ops/flash_attention.py:_flash_bwd_dq_kernel
// (pallas_call at :800, in _flash_dt_bwd_pallas) and the row statistics
// that wrapper computes before its kernels (delta = rowsum(dO o O), lse and
// delta padded with _LSE_PAD and 0). At D = 64 it took the place of a
// CUDA-core FFMA dQ kernel (five [64, 68] fp32 tiles, one in flight; 2.817
// ms at [2, 4800, 320] h = 5, PERF.md) and, on the fp32 path, of
// ops/flash_attention.py:bwd_stats' small launches.
//
// Math per (batch, head), as the TPU kernel computes it:
//   S = Q K^T * scale;  P = exp(S - lse_row);  dP = dO V^T;
//   dS = P o (dP - delta_row),  delta = rowsum(dO o O);
//   dQ = dS K * scale,
// P and dS fp32, every product 3xTF32 (lo.hi + hi.lo + hi.hi in the fp32
// accumulator, ~2^-21 per product); P is exp2 of the logits scaled by
// scale log2(e) less lse log2(e). Key columns j >= nk get P = 0. Query rows
// past nq are computed on TMA's zero fill with lse = 1e30 and not stored.
//
// Row statistics: in its prologue each consumer thread computes delta of
// its two query rows in fp32 from plain loads of O and dO (each lane of
// the quad that shares a row takes D / 4 columns) and writes the padded
// [B*H, ld_stat] lse and delta rows the dK/dV kernel reads (ld_stat = nq
// rounded up to 64; lse 1e30 and delta 0 past nq, as bwd_stats pads them);
// the last CTA's rows past ld_stat are not written.
//
// Operands (ops/flash_attention.py:flash_attention_bwd_dq_f32: pairs of the
// backward's one tf32_split.cu launch, which the dK/dV kernel reads too),
// each product's B operand K-major as tf32 requires:
//   S   = Q K^T:   A = Q (resident),  B = K    [B, nk, ld] hi/lo
//   dP  = dO V^T:  A = dO (resident), B = V    [B, nk, ld] hi/lo
//   dQ += dS K:    A = dS (registers), B = K^T [B, ld, NKP] hi/lo
// K^T comes from the split kernel (NKP = nk rounded up to 8, the keys past
// nk zeros), its key index permuted in groups of 8 so that the dP
// accumulator's registers are the A fragments of dS (tf32x3.cuh). Every
// copy has a 4-D TMA map that names the head (tf32x3.cuh:encode_heads,
// encode_heads_t), so a box's lanes or rows past D read as zeros, never the
// next head's.
//
// The design, per block of BQ query rows of one (b, h):
//   * Q and dO hi and lo resident, each QB = ceil(D / 32) boxes of {32
//     lanes, BQ rows};
//   * per 64 keys KS = ceil(D / 64) K substages, KS V substages and NV =
//     ceil(D / 64) K^T substages (64 output columns each) go through a
//     ring of 32 KB slots, each hi and lo as four 8 KB boxes, each consumed
//     by both consumers (every consumer thread arrives on its empty
//     barrier, no branch among wgmmas in flight);
//   * S and dP by wgmma m64n64k8 with both operands in shared memory; P
//     from S (the ragged key tile masked by a select), dS from dP; dS split
//     into hi and lo A fragments; per K^T substage the tile's dQ product
//     (24 wgmma with A from registers) into a fresh accumulator, waited and
//     added into dQ with fp32 adds (the tensor cores' own accumulation
//     truncates: tf32x3.cuh);
//   * D <= 64: BQ = 128, consumer c owns query rows [64c, 64c + 64), and
//     issues S and dP as two commit groups, computing P while dP runs; it
//     holds S, dP, dQ, the tile product (128 registers) and dS's lo
//     fragments (32). Q, dO hi/lo take 128 KB, the ring 3 slots: 224 KB;
//   * D = 80 and 160 (COLSPLIT): Q and dO of 128 rows would take 192 or
//     320 KB, so BQ = 64: both consumers own the block's 64 rows and
//     compute S and dP (each substage waited for and released before the
//     next), and consumer c computes the dQ columns of the K^T substages v
//     with v % 2 == c (it waits on the others' slots and releases them).
//     Registers: S (which takes the tile products once dS is computed),
//     dP, dS's lo fragments and dQ (32 per substage it owns): 160 at
//     D = 160. Shared memory: at D = 80 96 KB
//     resident + 4 slots, at D = 160 160 KB + 2 slots: 224 KB;
//   * the epilogue stores dQ * scale fp32 straight from registers, rows
//     past nq and columns past D skipped. Each dQ element is written by one
//     thread of one block: no atomics, two calls give the same bits.
//
// What bounds it on the H100: 6 N^2 D FLOPs per head (S, dP, dQ), x3 for
// the tf32 passes: at [2, 4800, 320] h = 5 (D = 64) 0.265 TFLOP, 0.536 ms
// at 495 TFLOP/s, against 96 KB of ring traffic per 64 keys per block (2.8
// GB from L2 per call at that shape) and ~6 exp2/FMA per tensor k8 step;
// at D = 80 and 160 the duplicated S and dP add 4 N^2 D. As in dK/dV the
// consumers do not overlap one tile's products with the next one's
// softmax; the two consumers fill each other's gaps.

#include "tf32x3.cuh"

namespace {

constexpr int BK = 64;            // keys per ring substage
constexpr int CONSUMERS = 2;      // consumer warpgroups
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int STAT_PAD = 64;      // ld_stat's multiple
constexpr float kLsePad = 1e30f;  // the TPU wrapper's _LSE_PAD
constexpr int SLOT_BYTES = 4 * ATT_BOX;  // hi (2 boxes), lo (2 boxes)

// The shapes of the instantiation at head width D.
template <int D>
struct Shape {
  static_assert(D % 8 == 0 && D <= 160, "D a multiple of 8, at most 160");
  static constexpr bool COLSPLIT = D > 64;     // see above
  static constexpr int BQ = COLSPLIT ? 64 : 128;  // query rows per block
  static constexpr int QB = (D + 31) / 32;     // 32-lane boxes of a row
  static constexpr int KS = (D + 63) / 64;     // K (and V) substages
  static constexpr int NV = (D + 63) / 64;     // K^T substages
  static constexpr int SUBS = 2 * KS + NV;     // substages per 64 keys
  static constexpr int NVC = COLSPLIT ? (NV + 1) / 2 : NV;  // dQ's per thread
  static constexpr int RES_BOX = BQ * 128;     // {32 lanes, BQ rows}
  static constexpr int RES_BYTES = QB * RES_BOX;  // one of Q/dO hi/lo
  static constexpr int FIT =
      (232448 - 1024 - 8 * 9 - 4 * RES_BYTES) / SLOT_BYTES;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;  // ring slots
  static_assert(STAGES >= 2, "two ring slots fit");
  // Shared memory: Q_hi, Q_lo, dO_hi, dO_lo, the ring, then the barriers
  // (full[STAGES], empty[STAGES], resident); every box 1024-byte aligned.
  static constexpr int SM_QH = 0;
  static constexpr int SM_QL = RES_BYTES;
  static constexpr int SM_GH = 2 * RES_BYTES;
  static constexpr int SM_GL = 3 * RES_BYTES;
  static constexpr int SM_RING = 4 * RES_BYTES;
  static constexpr int SM_BAR = SM_RING + STAGES * SLOT_BYTES;
  static constexpr int SM_BYTES = SM_BAR + 8 * (2 * STAGES + 1);
  static constexpr int SMEM_REQUEST = SM_BYTES + 1024;  // room to align
  static_assert(SMEM_REQUEST <= 232448, "fits the 227 KB a block can use");
};

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rowsum(o * g) over N of a head's columns starting at `o` and `g` (8-byte
// aligned; 16-byte aligned when N is a multiple of 4), summed in column
// order; the quad that shares the row sums the rest.
template <int N>
__device__ __forceinline__ float dot_cols(const float* o, const float* g) {
  float acc = 0.f;
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(o + 4 * i);
      const float4 y = *reinterpret_cast<const float4*>(g + 4 * i);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
      acc = fmaf(x.z, y.z, acc);
      acc = fmaf(x.w, y.w, acc);
    }
  } else {
    static_assert(N % 2 == 0, "whole float2s");
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 x = *reinterpret_cast<const float2*>(o + 2 * i);
      const float2 y = *reinterpret_cast<const float2*>(g + 2 * i);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
  return acc;
}

// Accumulator layout of wgmma m64nN (per warpgroup thread t, warp w = t/32,
// lane l): d[4j + e] is row 16w + l/4, column 8j + 2(l%4) + e, and
// d[4j + 2 + e] the same columns of row 16w + l/4 + 8 (e in {0, 1}). Here
// rows are query rows and columns keys (S, P, dP, dS) or head columns (dQ).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_f32_kernel(
    const __grid_constant__ CUtensorMap tm_qh,
    const __grid_constant__ CUtensorMap tm_ql,
    const __grid_constant__ CUtensorMap tm_gh,
    const __grid_constant__ CUtensorMap tm_gl,
    const __grid_constant__ CUtensorMap tm_kh,
    const __grid_constant__ CUtensorMap tm_kl,
    const __grid_constant__ CUtensorMap tm_vh,
    const __grid_constant__ CUtensorMap tm_vl,
    const __grid_constant__ CUtensorMap tm_kth,
    const __grid_constant__ CUtensorMap tm_ktl,
    const float* __restrict__ o, const float* __restrict__ g,
    const float* __restrict__ lse, float* __restrict__ dq,
    float* __restrict__ lse_pad, float* __restrict__ delta_pad, int H,
    int nq, int nk, int ld, int ld_stat, float scale, float scale_log2) {
  using S_ = Shape<D>;
  constexpr bool COLSPLIT = S_::COLSPLIT;
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
  const int q0 = blockIdx.x * S_::BQ;
  const int n_tiles = cdiv(nk, BK);

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
      // the resident Q and dO tiles, hi and lo, QB boxes each
      mbar_expect_tx(res, 4 * S_::RES_BYTES);
      const CUtensorMap* res_maps[4] = {&tm_qh, &tm_ql, &tm_gh, &tm_gl};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int box = 0; box < S_::QB; ++box)
          tma_load_4d(base + i * S_::RES_BYTES + box * S_::RES_BOX,
                      res_maps[i], 32 * box, h, q0, b, res);
      // per 64 keys: KS substages of K, KS of V (row-major), NV of K^T
      // (transposed)
      const CUtensorMap* row_maps[2][2] = {{&tm_kh, &tm_kl}, {&tm_vh, &tm_vl}};
      const CUtensorMap* kt_maps[2] = {&tm_kth, &tm_ktl};
      int n = 0;
      for (int it = 0; it < n_tiles; ++it) {
#pragma unroll
        for (int sub = 0; sub < SUBS; ++sub, ++n) {
          const int slot = n % STAGES;
          const uint32_t full = full0 + 8 * slot;
          const uint32_t dst = base + S_::SM_RING + slot * SLOT_BYTES;
          if (n >= STAGES) mbar_wait(empty0 + 8 * slot, (n / STAGES - 1) & 1);
          if (sub < 2 * KS) {  // [B, nk, ld]: 64 keys, 32 d lanes per box
            const int ks = sub % KS;
            const int boxes = S_::QB - 2 * ks < 2 ? 1 : 2;
            mbar_expect_tx(full, 2 * boxes * ATT_BOX);
#pragma unroll
            for (int part = 0; part < 2; ++part)    // hi, lo
#pragma unroll
              for (int half = 0; half < boxes; ++half)
                tma_load_4d(dst + (2 * part + half) * ATT_BOX,
                            row_maps[sub / KS][part], 32 * (2 * ks + half), h,
                            it * BK, b, full);
          } else {  // [B, ld, NKP]: 64 d rows of the head, 32 keys per box
            mbar_expect_tx(full, SLOT_BYTES);
#pragma unroll
            for (int part = 0; part < 2; ++part)
#pragma unroll
              for (int half = 0; half < 2; ++half)
                tma_load_4d(dst + (2 * part + half) * ATT_BOX, kt_maps[part],
                            it * BK + 32 * half, 64 * (sub - 2 * KS), h, b,
                            full);
          }
        }
      }
    }
    return;
  }

  // Consumer warpgroup c: query rows [64c, 64c + 64) of the block, or
  // (COLSPLIT) the block's 64 rows and the dQ columns of its K^T
  // substages.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;  // this thread's rows r0, r0 + 8
  const int col = 2 * (lane % 4);           // its key column pair per 8
  const int crow = COLSPLIT ? 0 : 64 * c;   // its rows' offset in the block
  const uint32_t rows = crow * 128;         // ... inside each box
  const uint32_t qh = base + S_::SM_QH + rows, ql = base + S_::SM_QL + rows;
  const uint32_t gh = base + S_::SM_GH + rows, gl = base + S_::SM_GL + rows;
  const int row0 = q0 + crow + r0;          // global query rows
  const int row1 = row0 + 8;

  // The rows' statistics: lse (1e30 past nq) and delta (0 past nq), and
  // the padded rows of both for the dK/dV kernel.
  const size_t head = (size_t)b * nq * ld + h * D + (D / 4) * (lane % 4);
  float lse0 = kLsePad, lse1 = kLsePad, dl0 = 0.f, dl1 = 0.f;
  if (row0 < nq) {
    lse0 = lse[(size_t)bh * nq + row0];
    dl0 = dot_cols<D / 4>(o + head + (size_t)row0 * ld,
                          g + head + (size_t)row0 * ld);
  }
  if (row1 < nq) {
    lse1 = lse[(size_t)bh * nq + row1];
    dl1 = dot_cols<D / 4>(o + head + (size_t)row1 * ld,
                          g + head + (size_t)row1 * ld);
  }
  dl0 = quad_sum(dl0);
  dl1 = quad_sum(dl1);
  if (col == 0 && (!COLSPLIT || c == 0)) {
    if (row0 < ld_stat) {
      lse_pad[(size_t)bh * ld_stat + row0] = lse0;
      delta_pad[(size_t)bh * ld_stat + row0] = dl0;
    }
    if (row1 < ld_stat) {
      lse_pad[(size_t)bh * ld_stat + row1] = lse1;
      delta_pad[(size_t)bh * ld_stat + row1] = dl1;
    }
  }
  const float nl0 = -lse0 * kLog2e, nl1 = -lse1 * kLog2e;

  float s[32], dp[32], part[32], dqacc[S_::NVC][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = part[i] = 0.f;
#pragma unroll
  for (int v = 0; v < S_::NVC; ++v)
#pragma unroll
    for (int i = 0; i < 32; ++i) dqacc[v][i] = 0.f;
  uint32_t lo[32];

  auto slot_of = [&](int n) {
    return base + S_::SM_RING + (n % STAGES) * SLOT_BYTES;
  };
  auto wait_full = [&](int n) {
    mbar_wait(full0 + 8 * (n % STAGES), (n / STAGES) & 1);
  };
  auto release = [&](int n) { mbar_arrive(empty0 + 8 * (n % STAGES)); };

  mbar_wait(res, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int n = it * SUBS;
    const int lim = nk - it * BK - col;  // this thread's keys e < lim are in
    // P = exp2(s * scale * log2e - lse * log2e), keys >= nk masked
    auto probabilities = [&]() {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool in = 8 * j + e < lim;
          s[4 * j + e] =
              ex2(fmaf(in ? s[4 * j + e] : kNegInf, scale_log2, nl0));
          s[4 * j + 2 + e] =
              ex2(fmaf(in ? s[4 * j + 2 + e] : kNegInf, scale_log2, nl1));
        }
      }
    };
    if constexpr (KS == 1) {
      // S = Q K^T and dP = dO V^T in flight together, P while dP runs
      wait_full(n);
      wgmma_att_nt<D>(s, qh, ql, S_::RES_BOX, slot_of(n), 0);
      wait_full(n + 1);
      wgmma_att_nt<D>(dp, gh, gl, S_::RES_BOX, slot_of(n + 1), 0);
      wgmma_wait<1>();
      fence_regs(s);
      release(n);
      probabilities();
      wgmma_wait<0>();
      fence_regs(dp);
      release(n + 1);
    } else {
      // S, then dP, one K or V substage at a time (the ring holds fewer
      // slots than a tile's substages at D = 160)
#pragma unroll
      for (int sub = 0; sub < 2 * KS; ++sub) {
        wait_full(n + sub);
        if (sub < KS)
          wgmma_att_nt<D>(s, qh, ql, S_::RES_BOX, slot_of(n + sub), sub);
        else
          wgmma_att_nt<D>(dp, gh, gl, S_::RES_BOX, slot_of(n + sub),
                          sub - KS);
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        release(n + sub);
      }
      probabilities();
    }
    // dS = P (dP - delta)
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - dl0);
        dp[4 * j + 2 + e] = s[4 * j + 2 + e] * (dp[4 * j + 2 + e] - dl1);
      }
    }
    // dQ += dS K against K^T, per 64 columns: the tile's product into a
    // fresh accumulator, added with fp32 adds (the tensor cores' own
    // accumulation truncates: tf32x3.cuh)
    // (COLSPLIT: the products in S's registers, free once dS is computed)
    acc_to_tf32x2<0>(dp, lo);
    float(&tile)[32] = COLSPLIT ? s : part;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int nv = n + 2 * KS + v;
      wait_full(nv);
      if (!COLSPLIT || v % 2 == c) {
        wgmma_att_nn(tile, dp, lo, slot_of(nv));
        wgmma_wait<0>();
        fence_regs(tile);
        fence_regs(dp);
        fence_regs(lo);
        release(nv);
        const int mine = COLSPLIT ? v / 2 : v;
#pragma unroll
        for (int i = 0; i < 32; ++i) dqacc[mine][i] += tile[i];
      } else {
        release(nv);
      }
    }
  }

  float* db = dq + (size_t)b * nq * ld + h * D + col;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? row1 : row0;
    if (r >= nq) continue;
    float* dst = db + (size_t)r * ld;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (COLSPLIT && v % 2 != c) continue;
      const int mine = COLSPLIT ? v / 2 : v;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (64 * v + 8 * j < D)
          *reinterpret_cast<float2*>(dst + 64 * v + 8 * j) =
              make_float2(dqacc[mine][4 * j + 2 * half] * scale,
                          dqacc[mine][4 * j + 2 * half + 1] * scale);
    }
  }
}

template <int D>
cudaError_t launch(const CUtensorMap (&maps)[10], const float* o,
                   const float* g, const float* lse, float* dq,
                   float* lse_pad, float* delta_pad, int B, int H, int nq,
                   int nk, int ld, int ld_stat, float scale,
                   cudaStream_t stream) {
  auto kernel = flash_bwd_dq_f32_kernel<D>;
  constexpr int smem = Shape<D>::SMEM_REQUEST;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(nq, Shape<D>::BQ), B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7],
      maps[8], maps[9], o, g, lse, dq, lse_pad, delta_pad, H, nq, nk, ld,
      ld_stat, scale, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dQ of the fp32 attention backward at head width D (40, 64, 80 or 160) on
// split operands (tf32_split.cu), with delta and the padded statistics:
// q_hi/q_lo and g_hi/g_lo (dO) [B, nq, ld], k_hi/k_lo and v_hi/v_lo
// [B, nk, ld], kt_hi/kt_lo [B, ld, round_up(nk, 8)], o and g (O and dO
// themselves) [B, nq, ld], all fp32 and 16-byte aligned with ld >= H D a
// multiple of 4; lse [B*H, nq] fp32 (the training forward's); dq [B, nq,
// ld] fp32; lse_pad and delta_pad [B*H, ld_stat] fp32, ld_stat = nq
// rounded up to 64, written here for mt_flash_bwd_dkv_f32. Returns
// cudaSuccess (0) or the error of the checks, the map encoding, the
// attribute call or the launch.
int mt_flash_bwd_dq_f32(const void* q_hi, const void* q_lo, const void* g_hi,
                        const void* g_lo, const void* k_hi, const void* k_lo,
                        const void* v_hi, const void* v_lo, const void* kt_hi,
                        const void* kt_lo, const void* o, const void* g,
                        const void* lse, void* dq, void* lse_pad,
                        void* delta_pad, int B, int H, int nq, int nk, int D,
                        int ld, int ld_stat, float scale, void* stream) {
  if ((D != 40 && D != 64 && D != 80 && D != 160) || B < 1 || H < 1 ||
      B * H > 65535 || nq < 1 || nk < 1 || ld % 4 || ld < H * D ||
      ld_stat != cdiv(nq, STAT_PAD) * STAT_PAD ||
      reinterpret_cast<uintptr_t>(o) % 16 ||
      reinterpret_cast<uintptr_t>(g) % 16)
    return (int)cudaErrorInvalidValue;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const int nkp = (nk + 7) / 8 * 8;
  const int bq = D > 64 ? 64 : 128;  // Shape<D>::BQ
  CUtensorMap maps[10];
  const void* res[4] = {q_hi, q_lo, g_hi, g_lo};
  const void* kv[4] = {k_hi, k_lo, v_hi, v_lo};
  for (int i = 0; i < 4; ++i) {
    if (!encode_heads(fn, &maps[i], res[i], B, H, nq, D, ld, bq) ||
        !encode_heads(fn, &maps[4 + i], kv[i], B, H, nk, D, ld, BK))
      return (int)cudaErrorInvalidValue;
  }
  if (!encode_heads_t(fn, &maps[8], kt_hi, B, H, nkp, D, ld) ||
      !encode_heads_t(fn, &maps[9], kt_lo, B, H, nkp, D, ld))
    return (int)cudaErrorInvalidValue;
  const float* of = static_cast<const float*>(o);
  const float* gf = static_cast<const float*>(g);
  const float* ls = static_cast<const float*>(lse);
  float* d = static_cast<float*>(dq);
  float* lp = static_cast<float*>(lse_pad);
  float* dp = static_cast<float*>(delta_pad);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40:
      return (int)launch<40>(maps, of, gf, ls, d, lp, dp, B, H, nq, nk, ld,
                             ld_stat, scale, st);
    case 64:
      return (int)launch<64>(maps, of, gf, ls, d, lp, dp, B, H, nq, nk, ld,
                             ld_stat, scale, st);
    case 80:
      return (int)launch<80>(maps, of, gf, ls, d, lp, dp, B, H, nq, nk, ld,
                             ld_stat, scale, st);
    default:
      return (int)launch<160>(maps, of, gf, ls, d, lp, dp, B, H, nq, nk, ld,
                              ld_stat, scale, st);
  }
}

const char* mt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
