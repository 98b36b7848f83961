// Flash-attention backward dQ for 64-wide heads in fp32 storage (fp32
// fine-tuning), designed for Hopper (sm_90a): 3xTF32 products on wgmma
// (tf32x3.cuh), TMA loads into an mbarrier ring, a producer warp and two
// consumer warpgroups, no atomics. Its partner is flash_bwd_dkv_f32_sm90.cu
// (dK and dV), with the roles of queries and keys swapped.
//
// Replaces the fp32 instantiation of the TPU package's
// marigold_tpu/ops/flash_attention.py:_flash_bwd_dq_kernel (pallas_call at
// :800, in _flash_dt_bwd_pallas) and the row statistics that wrapper
// computes before its kernels (delta = rowsum(dO o O), lse and delta padded
// with _LSE_PAD and 0). It took the place of a CUDA-core FFMA dQ kernel
// (five [64, 68] fp32 tiles, one in flight; 2.817 ms at [2, 4800, 320]
// h = 5, PERF.md) and, on the fp32 path, of ops/flash_attention.py:
// bwd_stats' small launches.
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
// its two query rows in fp32 from plain loads of O and dO (the quad of
// lanes that shares a row takes 16 columns each) and writes the padded
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
// accumulator's registers are the A fragments of dS (tf32x3.cuh).
//
// The design, per block of 128 query rows of one (b, h):
//   * Q and dO hi and lo resident (each [128, 64] fp32 as two 16 KB boxes of
//     32 columns: 128 KB); consumer c owns query rows [64c, 64c + 64);
//   * per 64 keys three substages go through a ring of 3 slots of 32 KB,
//     each consumed by both consumers (every consumer thread arrives on its
//     empty barrier, no branch among wgmmas in flight): K, V, K^T, each hi
//     and lo as four 8 KB boxes;
//   * a consumer issues S (K) and dP (V) as two commit groups of 24 wgmma
//     m64n64k8 with both operands in shared memory, computes P as soon as S
//     is done (the ragged key tile masked by a select, not a branch, since
//     dP is in flight) and dS once dP is; then splits dS into hi and lo A
//     fragments and issues the tile's dQ product (24 wgmma with A from
//     registers) against K^T into a fresh accumulator, waits and adds it
//     into dQ with fp32 adds (the tensor cores' own accumulation truncates:
//     tf32x3.cuh). Every group is waited for inside the iteration; a
//     consumer holds S, dP, dQ, the tile product (128 registers) and dS's lo
//     fragments (32);
//   * the epilogue stores dQ * scale fp32 straight from registers, rows
//     past nq skipped. Each dQ row is written by one block: no atomics, two
//     calls give the same bits.
// Shared memory: 128 KB resident + 3 x 32 KB ring + 7 barriers = 224 KB +
// 56 B, of the 227 KB a block may use.
//
// What bounds it on the H100: 6 N^2 64 FLOPs per head (S, dP, dQ), x3 for
// the tf32 passes: at [2, 4800, 320] h = 5 0.265 TFLOP, 0.536 ms at 495
// TFLOP/s, against 96 KB of ring traffic per 64 keys per block (2.8 GB from
// L2 per call at that shape) and ~6 exp2/FMA per tensor k8 step. As in
// dK/dV the consumers do not overlap one tile's products with the next
// one's softmax; the two consumers, each on its own rows, fill each
// other's gaps.

#include "tf32x3.cuh"

namespace {

constexpr int D = 64;             // head width
constexpr int BQ = 128;           // query rows per block (2 x 64)
constexpr int BK = 64;            // keys per ring substage
constexpr int CONSUMERS = 2;      // consumer warpgroups
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int SUBS = 3;           // substages per 64 keys: K, V, K^T
constexpr int STAGES = 3;         // ring slots
constexpr int STAT_PAD = 64;      // ld_stat's multiple
constexpr float kLsePad = 1e30f;  // the TPU wrapper's _LSE_PAD
constexpr int RES_BYTES = 2 * ATT_RES_BOX;  // one [128, 64] fp32 tile
constexpr int SLOT_BYTES = 4 * ATT_BOX;     // hi (2 boxes), lo (2 boxes)

// Shared memory: Q_hi, Q_lo, dO_hi, dO_lo, the ring, then the barriers
// (full[3], empty[3], resident); every box 1024-byte aligned.
constexpr int SM_QH = 0;
constexpr int SM_QL = RES_BYTES;
constexpr int SM_GH = 2 * RES_BYTES;
constexpr int SM_GL = 3 * RES_BYTES;
constexpr int SM_RING = 4 * RES_BYTES;
constexpr int SM_BAR = SM_RING + STAGES * SLOT_BYTES;
constexpr int SM_BYTES = SM_BAR + 8 * (2 * STAGES + 1);
constexpr int SMEM_REQUEST = SM_BYTES + 1024;  // room to align the base
static_assert(SMEM_REQUEST <= 232448, "fits the 227 KB a block can use");

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

// rowsum(o * g) over 16 of a head's columns starting at `o` and `g`; the
// quad that shares the row sums the rest.
__device__ __forceinline__ float dot16(const float* o, const float* g) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(o + 4 * i);
    const float4 y = *reinterpret_cast<const float4*>(g + 4 * i);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
  return acc;
}

// Accumulator layout of wgmma m64nN (per warpgroup thread t, warp w = t/32,
// lane l): d[4j + e] is row 16w + l/4, column 8j + 2(l%4) + e, and
// d[4j + 2 + e] the same columns of row 16w + l/4 + 8 (e in {0, 1}). Here
// rows are query rows and columns keys (S, P, dP, dS) or head columns (dQ).
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
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = base + SM_BAR;
  const uint32_t empty0 = full0 + 8 * STAGES;
  const uint32_t res = empty0 + 8 * STAGES;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
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
      // the resident Q and dO tiles, hi and lo, two boxes each
      mbar_expect_tx(res, 4 * RES_BYTES);
      const CUtensorMap* res_maps[4] = {&tm_qh, &tm_ql, &tm_gh, &tm_gl};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          tma_load(base + i * RES_BYTES + half * ATT_RES_BOX, res_maps[i],
                   h * D + 32 * half, q0, b, res);
      // per 64 keys: K, V (row-major), K^T (transposed)
      const CUtensorMap* sub_maps[SUBS][2] = {
          {&tm_kh, &tm_kl}, {&tm_vh, &tm_vl}, {&tm_kth, &tm_ktl}};
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
            for (int half = 0; half < 2; ++half) {  // 32 columns each
              const uint32_t box = dst + (2 * part + half) * ATT_BOX;
              if (sub < 2)  // [B, nk, ld]: 64 keys, 32 of the d
                tma_load(box, sub_maps[sub][part], h * D + 32 * half,
                         it * BK, b, full);
              else  // [B, ld, NKP]: the head's 64 d rows, 32 keys
                tma_load(box, sub_maps[sub][part], it * BK + 32 * half,
                         h * D, b, full);
            }
          }
        }
      }
    }
    return;
  }

  // Consumer warpgroup c: query rows [64c, 64c + 64) of the block.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;  // this thread's rows r0, r0 + 8
  const int col = 2 * (lane % 4);           // its key column pair per 8
  const uint32_t rows = c * 64 * 128;       // its rows inside each box
  const uint32_t qh = base + SM_QH + rows, ql = base + SM_QL + rows;
  const uint32_t gh = base + SM_GH + rows, gl = base + SM_GL + rows;
  const int row0 = q0 + 64 * c + r0;        // global query rows
  const int row1 = row0 + 8;

  // The rows' statistics: lse (1e30 past nq) and delta (0 past nq), and
  // the padded rows of both for the dK/dV kernel.
  const size_t head = (size_t)b * nq * ld + h * D + 16 * (lane % 4);
  float lse0 = kLsePad, lse1 = kLsePad, dl0 = 0.f, dl1 = 0.f;
  if (row0 < nq) {
    lse0 = lse[(size_t)bh * nq + row0];
    dl0 = dot16(o + head + (size_t)row0 * ld, g + head + (size_t)row0 * ld);
  }
  if (row1 < nq) {
    lse1 = lse[(size_t)bh * nq + row1];
    dl1 = dot16(o + head + (size_t)row1 * ld, g + head + (size_t)row1 * ld);
  }
  dl0 = quad_sum(dl0);
  dl1 = quad_sum(dl1);
  if (col == 0) {
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

  float s[32], dp[32], dqacc[32], part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = dqacc[i] = part[i] = 0.f;
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
    const int lim = nk - it * BK - col;  // this thread's keys e < lim are in
    wait_full(n);
    wgmma_att_nt(s, qh, ql, slot_of(n));       // S = Q K^T
    wait_full(n + 1);
    wgmma_att_nt(dp, gh, gl, slot_of(n + 1));  // dP = dO V^T
    // P = exp2(s * scale * log2e - lse * log2e), keys >= nk masked
    wgmma_wait<1>();
    fence_regs(s);
    release(n);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = 8 * j + e < lim;
        s[4 * j + e] = ex2(fmaf(in ? s[4 * j + e] : kNegInf, scale_log2, nl0));
        s[4 * j + 2 + e] =
            ex2(fmaf(in ? s[4 * j + 2 + e] : kNegInf, scale_log2, nl1));
      }
    }
    // dS = P (dP - delta)
    wgmma_wait<0>();
    fence_regs(dp);
    release(n + 1);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - dl0);
        dp[4 * j + 2 + e] = s[4 * j + 2 + e] * (dp[4 * j + 2 + e] - dl1);
      }
    }
    // dQ += dS K against K^T: the tile's product into a fresh accumulator,
    // added with fp32 adds (the tensor cores' own accumulation truncates:
    // tf32x3.cuh)
    acc_to_tf32x2<0>(dp, lo);
    wait_full(n + 2);
    wgmma_att_nn(part, dp, lo, slot_of(n + 2));
    wgmma_wait<0>();
    fence_regs(part);
    fence_regs(dp);
    fence_regs(lo);
    release(n + 2);
#pragma unroll
    for (int i = 0; i < 32; ++i) dqacc[i] += part[i];
  }

  float* db = dq + (size_t)b * nq * ld + h * D + col;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? row1 : row0;
    if (r >= nq) continue;
    float* dst = db + (size_t)r * ld;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(dqacc[4 * j + 2 * half] * scale,
                      dqacc[4 * j + 2 * half + 1] * scale);
  }
}

}  // namespace

extern "C" {

// dQ of the fp32 attention backward on split operands (tf32_split.cu),
// with delta and the padded statistics: q_hi/q_lo and g_hi/g_lo (dO)
// [B, nq, ld], k_hi/k_lo and v_hi/v_lo [B, nk, ld], kt_hi/kt_lo [B, ld,
// round_up(nk, 8)], o and g (O and dO themselves) [B, nq, ld], all fp32 and
// 16-byte aligned with ld a multiple of 4; lse [B*H, nq] fp32 (the
// training forward's); dq [B, nq, ld] fp32; lse_pad and delta_pad
// [B*H, ld_stat] fp32, ld_stat = nq rounded up to 64, written here for
// mt_flash_bwd_dkv_f32. Returns cudaSuccess (0) or the error of the checks,
// the map encoding, the attribute call or the launch.
int mt_flash_bwd_dq_f32(const void* q_hi, const void* q_lo, const void* g_hi,
                        const void* g_lo, const void* k_hi, const void* k_lo,
                        const void* v_hi, const void* v_lo, const void* kt_hi,
                        const void* kt_lo, const void* o, const void* g,
                        const void* lse, void* dq, void* lse_pad,
                        void* delta_pad, int B, int H, int nq, int nk, int D_,
                        int ld, int ld_stat, float scale, void* stream) {
  if (D_ != D || B < 1 || H < 1 || B * H > 65535 || nq < 1 || nk < 1 ||
      ld % 4 || ld < H * D || ld_stat != cdiv(nq, STAT_PAD) * STAT_PAD ||
      reinterpret_cast<uintptr_t>(o) % 16 ||
      reinterpret_cast<uintptr_t>(g) % 16)
    return (int)cudaErrorInvalidValue;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const int nkp = (nk + 7) / 8 * 8;
  CUtensorMap maps[10];
  const void* res[4] = {q_hi, q_lo, g_hi, g_lo};
  const void* kv[4] = {k_hi, k_lo, v_hi, v_lo};
  for (int i = 0; i < 4; ++i) {
    if (!encode_f32_rows(fn, &maps[i], res[i], B, nq, ld, BQ) ||
        !encode_f32_rows(fn, &maps[4 + i], kv[i], B, nk, ld, BK))
      return (int)cudaErrorInvalidValue;
  }
  if (!encode_f32_rows(fn, &maps[8], kt_hi, B, ld, nkp, D) ||
      !encode_f32_rows(fn, &maps[9], kt_lo, B, ld, nkp, D))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_REQUEST);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(cdiv(nq, BQ), B * H);
  flash_bwd_dq_f32_kernel<<<grid, THREADS, SMEM_REQUEST,
                            static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7],
      maps[8], maps[9], static_cast<const float*>(o),
      static_cast<const float*>(g), static_cast<const float*>(lse),
      static_cast<float*>(dq), static_cast<float*>(lse_pad),
      static_cast<float*>(delta_pad), H, nq, nk, ld, ld_stat, scale,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

const char* mt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
