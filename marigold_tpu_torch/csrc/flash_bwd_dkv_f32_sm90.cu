// Flash-attention backward dK and dV for 64-wide heads in fp32 storage
// (fp32 fine-tuning), designed for Hopper (sm_90a): 3xTF32 products on
// wgmma (tf32x3.cuh), TMA loads into an mbarrier ring, a producer warp and
// two consumer warpgroups, no atomics.
//
// Replaces the fp32 instantiation of the TPU package's
// marigold_tpu/ops/flash_attention.py:_flash_bwd_dkv_kernel (pallas_call at
// :832, in _flash_dt_bwd_pallas). It took the place of a CUDA-core FFMA
// dK/dV kernel (one 64 x 64 tile in flight, 102.5 KB of shared memory,
// 3.698 ms at [2, 4800, 320] h = 5, PERF.md); its partner, the fp32 dQ, is
// flash_bwd_dq_f32_sm90.cu, which also writes the padded lse and delta rows
// read here.
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
// memory (tf32x3.cuh).
//
// The design, per block of 128 key rows of one (b, h):
//   * K and V hi and lo resident (each [128, 64] fp32 as two 16 KB boxes of
//     32 columns: 128 KB); consumer c owns key rows [64c, 64c + 64);
//   * per 64 query rows four substages go through a ring of 3 slots of
//     32 KB, each consumed by both consumers (every consumer thread
//     arrives on its empty barrier, no branch among wgmmas in flight): Q,
//     dO, dO^T, Q^T, each hi and lo as four 8 KB boxes;
//   * a consumer issues S^T (Q) and dP^T (dO) as two commit groups of 24
//     wgmma m64n64k8 with both operands in shared memory, computes P^T as
//     soon as S^T is done and dS^T once dP^T is, with lse and delta per
//     column read from the padded rows in device memory (L1 hits: one
//     block reads the same 64 of each); then splits P^T into hi and lo A
//     fragments and issues dV's tile product (24 wgmma with A from
//     registers) against dO^T into a fresh accumulator, waits, adds it into
//     dV with fp32 adds (the tensor cores' accumulation truncates, and over
//     75 tiles it would cost ~5e-5 of dV's scale: tf32x3.cuh), then the
//     same for dK against Q^T. Every group is waited for inside the
//     iteration; a consumer holds S^T, dP^T, dK, dV, the tile product (160
//     registers) and one product's lo fragments (32) at most;
//   * the epilogue stores dK * scale and dV fp32 straight from registers,
//     rows past nk skipped. Each output row is written by one block: no
//     atomics, two calls give the same bits.
// Shared memory: 128 KB resident + 3 x 32 KB ring + 7 barriers = 224 KB +
// 56 B, of the 227 KB a block may use.
//
// What bounds it on the H100: 8 N^2 64 FLOPs per head (S^T, dP^T, dV, dK),
// x3 for the tf32 passes: at [2, 4800, 320] h = 5 0.354 TFLOP, 0.715 ms at
// 495 TFLOP/s, against 128 KB of ring traffic per 64 query rows per block
// (3.6 GB from L2 per call at that shape) and ~9 exp2/FMA per tensor k8
// step. The consumers do not overlap one stage's products with the next
// one's softmax (that would take ~256 registers); the two consumers, each
// on its own rows, fill each other's gaps.

#include "tf32x3.cuh"

namespace {

constexpr int D = 64;             // head width
constexpr int BM = 128;           // key rows per block (2 x 64)
constexpr int BN = 64;            // query rows per ring substage
constexpr int CONSUMERS = 2;      // consumer warpgroups
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int SUBS = 4;           // substages per 64 query rows
constexpr int STAGES = 3;         // ring slots
constexpr int STAT_PAD = 64;      // ld_stat's multiple
constexpr int RES_BOX = ATT_RES_BOX;       // {32 fp32, 128 rows}: 16 KB
constexpr int RES_BYTES = 2 * RES_BOX;     // one [128, 64] fp32 tile
constexpr int BOX_BYTES = ATT_BOX;         // {32 fp32, 64 rows}: 8 KB
constexpr int SLOT_BYTES = 4 * BOX_BYTES;  // hi (2 boxes), lo (2 boxes)

// Shared memory: K_hi, K_lo, V_hi, V_lo, the ring, then the barriers
// (full[3], empty[3], resident); every box 1024-byte aligned.
constexpr int SM_KH = 0;
constexpr int SM_KL = RES_BYTES;
constexpr int SM_VH = 2 * RES_BYTES;
constexpr int SM_VL = 3 * RES_BYTES;
constexpr int SM_RING = 4 * RES_BYTES;
constexpr int SM_BAR = SM_RING + STAGES * SLOT_BYTES;
constexpr int SM_BYTES = SM_BAR + 8 * (2 * STAGES + 1);
constexpr int SMEM_REQUEST = SM_BYTES + 1024;  // room to align the base
static_assert(SMEM_REQUEST <= 232448, "fits the 227 KB a block can use");

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// rows r0 and r0 + 8 (those < nk) of acc * mul into one head of a
// [B, N, ld] fp32 tensor at row n0, column col of each 8.
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[32],
                                           float mul, int n0, int r0, int col,
                                           int nk, int ld) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = n0 + r0 + 8 * half;
    if (r >= nk) continue;
    float* row = dst + (size_t)r * ld + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j) =
          make_float2(acc[4 * j + 2 * half] * mul,
                      acc[4 * j + 2 * half + 1] * mul);
  }
}

// Accumulator layout of wgmma m64nN (per warpgroup thread t, warp w = t/32,
// lane l): d[4j + e] is row 16w + l/4, column 8j + 2(l%4) + e, and
// d[4j + 2 + e] the same columns of row 16w + l/4 + 8 (e in {0, 1}). Here
// rows are keys and columns query rows of the substage.
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
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = base + SM_BAR;
  const uint32_t empty0 = full0 + 8 * STAGES;
  const uint32_t res = empty0 + 8 * STAGES;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * BM;
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
      // the resident K and V tiles, hi and lo, two boxes each
      mbar_expect_tx(res, 4 * RES_BYTES);
      const CUtensorMap* res_maps[4] = {&tm_kh, &tm_kl, &tm_vh, &tm_vl};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          tma_load(base + i * RES_BYTES + half * RES_BOX, res_maps[i],
                   h * D + 32 * half, k0, b, res);
      // per 64 query rows: Q, dO (row-major), dO^T, Q^T (transposed)
      const CUtensorMap* sub_maps[SUBS][2] = {{&tm_qh, &tm_ql},
                                              {&tm_gh, &tm_gl},
                                              {&tm_gth, &tm_gtl},
                                              {&tm_qth, &tm_qtl}};
      int n = 0;
      for (int it = 0; it < n_tiles; ++it) {
#pragma unroll
        for (int sub = 0; sub < SUBS; ++sub, ++n) {
          const int slot = n % STAGES;
          const uint32_t full = full0 + 8 * slot;
          const uint32_t dst = base + SM_RING + slot * SLOT_BYTES;
          if (n >= STAGES) mbar_wait(empty0 + 8 * slot, (n / STAGES - 1) & 1);
          mbar_expect_tx(full, SLOT_BYTES);
#pragma unroll
          for (int part = 0; part < 2; ++part) {    // hi, lo
#pragma unroll
            for (int half = 0; half < 2; ++half) {  // columns 0-31, 32-63
              const uint32_t box = dst + (2 * part + half) * BOX_BYTES;
              if (sub < 2)  // [B, nq, ld]: 64 query rows, 32 of the d
                tma_load(box, sub_maps[sub][part], h * D + 32 * half,
                         it * BN, b, full);
              else  // [B, ld, NQP]: the head's 64 d rows, 32 queries
                tma_load(box, sub_maps[sub][part], it * BN + 32 * half,
                         h * D, b, full);
            }
          }
        }
      }
    }
    return;
  }

  // Consumer warpgroup c: key rows [64c, 64c + 64) of the block.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;  // this thread's key rows r0, +8
  const int col = 2 * (lane % 4);           // its query column pair per 8
  const uint32_t rows = c * 64 * 128;       // its rows inside each box
  const uint32_t kh = base + SM_KH + rows, kl = base + SM_KL + rows;
  const uint32_t vh = base + SM_VH + rows, vl = base + SM_VL + rows;
  const float* lse_r = lse + (size_t)bh * ld_stat + col;
  const float* dl_r = delta + (size_t)bh * ld_stat + col;

  float s[32], dp[32], dkacc[32], dvacc[32], part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i)
    s[i] = dp[i] = dkacc[i] = dvacc[i] = part[i] = 0.f;
  uint32_t lo[32];

  auto slot_of = [&](int n) {
    return base + SM_RING + (n % STAGES) * SLOT_BYTES;
  };
  auto wait_full = [&](int n) {
    mbar_wait(full0 + 8 * (n % STAGES), (n / STAGES) & 1);
  };
  auto release = [&](int n) { mbar_arrive(empty0 + 8 * (n % STAGES)); };

  mbar_wait(res, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int n = it * SUBS;
    wait_full(n);
    wgmma_att_nt(s, kh, kl, slot_of(n));        // S^T = K Q^T
    wait_full(n + 1);
    wgmma_att_nt(dp, vh, vl, slot_of(n + 1));   // dP^T = V dO^T
    // P^T = exp2(s * scale * log2e - lse * log2e), lse per column (query
    // row), padded rows 1e30
    wgmma_wait<1>();
    fence_regs(s);
    release(n);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 l2 =
          *reinterpret_cast<const float2*>(lse_r + it * BN + 8 * j);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float nl = -(e ? l2.y : l2.x) * kLog2e;
        s[4 * j + e] = ex2(fmaf(s[4 * j + e], scale_log2, nl));
        s[4 * j + 2 + e] = ex2(fmaf(s[4 * j + 2 + e], scale_log2, nl));
      }
    }
    // dS^T = P^T (dP^T - delta), delta per column (0 on padded rows)
    wgmma_wait<0>();
    fence_regs(dp);
    release(n + 1);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 d2 =
          *reinterpret_cast<const float2*>(dl_r + it * BN + 8 * j);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = e ? d2.y : d2.x;
        dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - d);
        dp[4 * j + 2 + e] = s[4 * j + 2 + e] * (dp[4 * j + 2 + e] - d);
      }
    }
    // dV += P^T dO against dO^T, then dK += dS^T Q against Q^T: each
    // tile's product into a fresh accumulator, added with fp32 adds (the
    // tensor cores' own accumulation truncates: tf32x3.cuh)
    acc_to_tf32x2<0>(s, lo);
    wait_full(n + 2);
    wgmma_att_nn(part, s, lo, slot_of(n + 2));
    wgmma_wait<0>();
    fence_regs(part);
    fence_regs(s);
    fence_regs(lo);
    release(n + 2);
#pragma unroll
    for (int i = 0; i < 32; ++i) dvacc[i] += part[i];
    acc_to_tf32x2<0>(dp, lo);
    wait_full(n + 3);
    wgmma_att_nn(part, dp, lo, slot_of(n + 3));
    wgmma_wait<0>();
    fence_regs(part);
    fence_regs(dp);
    fence_regs(lo);
    release(n + 3);
#pragma unroll
    for (int i = 0; i < 32; ++i) dkacc[i] += part[i];
  }

  const int row0 = k0 + 64 * c;
  const size_t head = (size_t)b * nk * ld + h * D;
  store_rows(dk + head, dkacc, scale, row0, r0, col, nk, ld);
  store_rows(dv + head, dvacc, 1.f, row0, r0, col, nk, ld);
}

}  // namespace

extern "C" {

// dK and dV of the fp32 attention backward on split operands
// (tf32_split.cu): q_hi/q_lo and g_hi/g_lo (dO) [B, nq, ld], k_hi/k_lo and
// v_hi/v_lo [B, nk, ld], qt_hi/qt_lo and gt_hi/gt_lo [B, ld, round_up(nq,
// 8)], all fp32 and 16-byte aligned with ld a multiple of 4; lse/delta
// [B*H, ld_stat] fp32, ld_stat a multiple of 64 and at least nq, padded as
// bwd_stats pads them; dk/dv [B, nk, ld] fp32. Returns cudaSuccess (0) or
// the error of the checks, the map encoding, the attribute call or the
// launch.
int mt_flash_bwd_dkv_f32(const void* q_hi, const void* q_lo,
                         const void* g_hi, const void* g_lo,
                         const void* k_hi, const void* k_lo,
                         const void* v_hi, const void* v_lo,
                         const void* qt_hi, const void* qt_lo,
                         const void* gt_hi, const void* gt_lo,
                         const void* lse, const void* delta, void* dk,
                         void* dv, int B, int H, int nq, int nk, int D_,
                         int ld, int ld_stat, float scale, void* stream) {
  if (D_ != D || B < 1 || H < 1 || B * H > 65535 || nq < 1 || nk < 1 ||
      ld % 4 || ld < H * D || ld_stat % STAT_PAD || ld_stat < nq ||
      reinterpret_cast<uintptr_t>(lse) % 16 ||
      reinterpret_cast<uintptr_t>(delta) % 16)
    return (int)cudaErrorInvalidValue;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const int nqp = (nq + 7) / 8 * 8;
  CUtensorMap maps[12];
  const void* kv[4] = {k_hi, k_lo, v_hi, v_lo};
  const void* rows[4] = {q_hi, q_lo, g_hi, g_lo};
  const void* cols[4] = {gt_hi, gt_lo, qt_hi, qt_lo};
  for (int i = 0; i < 4; ++i) {
    if (!encode_f32_rows(fn, &maps[i], kv[i], B, nk, ld, BM) ||
        !encode_f32_rows(fn, &maps[4 + i], rows[i], B, nq, ld, BN) ||
        !encode_f32_rows(fn, &maps[8 + i], cols[i], B, ld, nqp, D))
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_REQUEST);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(cdiv(nk, BM), B * H);
  flash_bwd_dkv_f32_kernel<<<grid, THREADS, SMEM_REQUEST,
                             static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7],
      maps[8], maps[9], maps[10], maps[11], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), H, ld_stat, nq, nk, ld, scale,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // extern "C"
