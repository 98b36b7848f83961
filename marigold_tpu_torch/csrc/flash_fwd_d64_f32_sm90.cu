// Flash-attention forward for 64-wide heads in fp32 storage
// (`--full_precision` serving, fp32 fine-tuning's training forward, the
// folded entry), designed for Hopper (sm_90a): 3xTF32 products on wgmma
// (tf32x3.cuh), TMA loads into an mbarrier ring, a producer warp and two
// consumer warpgroups that each own 64 query rows.
//
// Replaces the fp32 d = 64 instantiations of the TPU package's
// marigold_tpu/ops/flash_attention.py kernels:
//   * _flash_kernel_dt_shifted (shifted softmax; pallas_call at :396), every
//     UNet self-attention of an fp32 request;
//   * _flash_kernel_dt (exact online softmax; :460), the parity pin;
//   * _flash_kernel through flash_attention (the folded [BH, N, D] entry;
//     :522), run online with one head per batch row;
//   * _flash_kernel_dt_lse (the training forward; :638): online, and it
//     writes the row logsumexp the backward reads.
// It took the place of a CUDA-core FFMA design (64 x 64 tiles, one in
// flight; 4.058 ms shifted and 3.772 ms online at [1, 9216, 320] h = 5,
// PERF.md). The 512-wide fp32 forward is flash_fwd_d512_f32_sm90.cu.
//
// Math per (batch, head, query row r), as the plain version
// (ops/flash_attention.py:_plain_forward) computes it in fp32:
//   s_j = (q_r . k_j) / 8;
//   shifted: p_j = exp(min(s_j - shift_r, 75)), shift_r from the caller;
//   online:  running max m, p_j = exp(s_j - m), O and l rescaled by
//            exp(m_old - m_new) when the max grows;
//   out_r = (sum_j p_j v_j) / max(sum_j p_j, 1e-30), stored fp32;
//   lse (training): lse_r = m + log(max(sum_j p_j, 1e-30)), [B*H, nq] fp32.
// Both products are 3xTF32 (lo.hi + hi.lo + hi.hi in the fp32
// accumulator, ~2^-21 per product); l sums the fp32 p_j. Every exponential
// is exp2 on logits scaled by log2(e)/8, with the shift, the clamp
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
// Every copy has a 3-D TMA map with a {32, rows, 1} box and the 128-byte
// swizzle.
//
// The design, per CTA of 128 query rows of one (b, h):
//   * Q hi and lo resident (each [128, 64] fp32 as two 16 KB boxes: 64 KB);
//     consumer c owns query rows [64c, 64c + 64);
//   * per 64-key tile two substages go through a ring of 4 slots of 32 KB,
//     each consumed by both consumers (every consumer thread arrives on its
//     empty barrier, no branch among wgmmas in flight): K (hi and lo, the B
//     operand of S = Q K^T) and V^T (hi and lo, the B operand of P V);
//   * a consumer issues S as one commit group of 24 wgmma m64n64k8 with both
//     operands in shared memory, waits, masks the ragged key tile, runs the
//     softmax in registers (online: the row max over the quad of lanes that
//     share a row, O and l rescaled), splits P into hi and lo A fragments
//     and issues P V^T (24 wgmma with A from registers) into a fresh
//     accumulator, waits and adds it into O with fp32 adds (the tensor
//     cores' own accumulation truncates: over 9216 keys in one accumulator
//     ~7e-5 of the output's scale, tf32x3.cuh). S, O, the tile product and
//     P's lo fragments: 128 registers of the consumers' 240;
//   * the epilogue reduces l over the quad, divides and stores fp32 straight
//     from registers (two floats per thread per 8 columns), rows past nq
//     skipped, and with the lse one float per row.
// Shared memory: 64 KB resident + 4 x 32 KB ring + 9 barriers = 192 KB +
// 72 B, of the 227 KB a block may use.
//
// What bounds it on the H100: per head 4 N^2 64 FLOPs, x3 for the tf32
// passes: at [1, 9216, 320] h = 5 0.326 TFLOP, 0.659 ms at 495 TFLOP/s.
// Each CTA reads 64 KB of ring per 64-key tile from L2 (at that shape 360
// CTAs x 144 tiles, 3.4 GB per call, ~0.5 ms at ~7 TB/s), and each
// consumer runs ~8 exp2/FMA per tensor k8 step. A consumer does not
// overlap one tile's softmax with the next tile's S (the two consumers,
// each on its own rows, fill each other's gaps); at [1, 9216, 320] h = 5
// the 360 CTAs make 2.7 waves on 132 SMs.

#include "tf32x3.cuh"

namespace {

constexpr int D = 64;             // head width
constexpr int BQ = 128;           // query rows per CTA (2 x 64)
constexpr int BK = 64;            // keys per tile
constexpr int CONSUMERS = 2;      // consumer warpgroups
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int SUBS = 2;           // ring substages per key tile: K, V^T
constexpr int STAGES = 4;         // ring slots
constexpr int RES_BYTES = 2 * ATT_RES_BOX;  // one [128, 64] fp32 tile
constexpr int SLOT_BYTES = 4 * ATT_BOX;     // hi (2 boxes), lo (2 boxes)

// Shared memory: Q_hi, Q_lo, the ring, then the barriers (full[4],
// empty[4], resident); every box 1024-byte aligned.
constexpr int SM_QH = 0;
constexpr int SM_QL = RES_BYTES;
constexpr int SM_RING = 2 * RES_BYTES;
constexpr int SM_BAR = SM_RING + STAGES * SLOT_BYTES;
constexpr int SM_BYTES = SM_BAR + 8 * (2 * STAGES + 1);
constexpr int SMEM_REQUEST = SM_BYTES + 1024;  // room to align the base
static_assert(SMEM_REQUEST <= 232448, "fits the 227 KB a block can use");

constexpr float kNegInf = -1e30f;  // the TPU kernels' NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
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
// d[4j + 2 + e] the same columns of row 16w + l/4 + 8 (e in {0, 1}). Here
// rows are query rows and columns keys (S, P) or head columns (O).
template <bool ONLINE, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_d64_f32_kernel(const __grid_constant__ CUtensorMap tm_qh,
                         const __grid_constant__ CUtensorMap tm_ql,
                         const __grid_constant__ CUtensorMap tm_kh,
                         const __grid_constant__ CUtensorMap tm_kl,
                         const __grid_constant__ CUtensorMap tm_vh,
                         const __grid_constant__ CUtensorMap tm_vl,
                         const float* __restrict__ shift,
                         float* __restrict__ out, float* __restrict__ lse,
                         int H, int nq, int nk, int ldo, float scale_log2) {
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
      // the resident Q tile, hi and lo, two boxes each
      mbar_expect_tx(res, 2 * RES_BYTES);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        tma_load(base + SM_QH + half * ATT_RES_BOX, &tm_qh,
                 h * D + 32 * half, q0, b, res);
        tma_load(base + SM_QL + half * ATT_RES_BOX, &tm_ql,
                 h * D + 32 * half, q0, b, res);
      }
      // per 64 keys: K (row-major), V^T (transposed)
      const CUtensorMap* sub_maps[SUBS][2] = {{&tm_kh, &tm_kl},
                                              {&tm_vh, &tm_vl}};
      int n = 0;
      for (int j = 0; j < n_tiles; ++j) {
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
              if (sub == 0)  // [B, nk, ld]: 64 keys, 32 of the d
                tma_load(box, sub_maps[sub][part], h * D + 32 * half, j * BK,
                         b, full);
              else  // [B, ld, NKP]: the head's 64 d rows, 32 keys
                tma_load(box, sub_maps[sub][part], j * BK + 32 * half, h * D,
                         b, full);
            }
          }
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
  const uint32_t qh = base + SM_QH + rows, ql = base + SM_QL + rows;
  const int row0 = q0 + 64 * c + r0;        // global query rows
  const int row1 = row0 + 8;

  float sh0 = 0.f, sh1 = 0.f;  // shifted mode: the row shift, base 2
  if (!ONLINE) {
    if (row0 < nq) sh0 = shift[(size_t)bh * nq + row0] * kLog2e;
    if (row1 < nq) sh1 = shift[(size_t)bh * nq + row1] * kLog2e;
  }
  float m0 = kNegInf, m1 = kNegInf;  // running max (online), base 2
  float l0 = 0.f, l1 = 0.f;          // this thread's part of its row sums
  float s[32], o[32], part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = o[i] = part[i] = 0.f;
  uint32_t lo[32];

  auto slot_of = [&](int n) {
    return base + SM_RING + (n % STAGES) * SLOT_BYTES;
  };
  auto wait_full = [&](int n) {
    mbar_wait(full0 + 8 * (n % STAGES), (n / STAGES) & 1);
  };
  auto release = [&](int n) { mbar_arrive(empty0 + 8 * (n % STAGES)); };

  mbar_wait(res, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int n = j * SUBS;
    wait_full(n);
    wgmma_att_nt(s, qh, ql, slot_of(n));  // S = Q K^T
    wgmma_wait<0>();
    fence_regs(s);
    release(n);

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
      for (int i = 0; i < D / 8; ++i) {
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
    // O += P V^T: P's hi and lo fragments, the tile's product into a fresh
    // accumulator, added into O with fp32 adds (tf32x3.cuh)
    acc_to_tf32x2<0>(s, lo);
    wait_full(n + 1);
    wgmma_att_nn(part, s, lo, slot_of(n + 1));
    wgmma_wait<0>();
    fence_regs(part);
    fence_regs(s);
    fence_regs(lo);
    release(n + 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] += part[i];
  }

  const float sum0 = fmaxf(quad_sum(l0), 1e-30f);
  const float sum1 = fmaxf(quad_sum(l1), 1e-30f);
  const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
  float* ob = out + (size_t)b * nq * ldo + h * D + col;
  if (row0 < nq) {
    float* dst = ob + (size_t)row0 * ldo;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<float2*>(dst + 8 * i) =
          make_float2(o[4 * i] * inv0, o[4 * i + 1] * inv0);
    if (LSE && col == 0)
      lse[(size_t)bh * nq + row0] = kLn2 * (m0 + log2f(sum0));
  }
  if (row1 < nq) {
    float* dst = ob + (size_t)row1 * ldo;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<float2*>(dst + 8 * i) =
          make_float2(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
    if (LSE && col == 0)
      lse[(size_t)bh * nq + row1] = kLn2 * (m1 + log2f(sum1));
  }
}

// The TMA maps of one call: q_hi, q_lo, k_hi, k_lo ([B, N, ld]) and
// vt_hi, vt_lo ([B, ld, round_up(nk, 8)]). False if the encode refuses one.
bool encode_maps(CUtensorMap (&maps)[6], const void* const (&ptrs)[6], int B,
                 int nq, int nk, int ld) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const int nkp = (nk + 7) / 8 * 8;
  return encode_f32_rows(fn, &maps[0], ptrs[0], B, nq, ld, BQ) &&
         encode_f32_rows(fn, &maps[1], ptrs[1], B, nq, ld, BQ) &&
         encode_f32_rows(fn, &maps[2], ptrs[2], B, nk, ld, BK) &&
         encode_f32_rows(fn, &maps[3], ptrs[3], B, nk, ld, BK) &&
         encode_f32_rows(fn, &maps[4], ptrs[4], B, ld, nkp, D) &&
         encode_f32_rows(fn, &maps[5], ptrs[5], B, ld, nkp, D);
}

template <bool ONLINE, bool LSE>
cudaError_t launch(const CUtensorMap (&maps)[6], const float* shift,
                   float* out, float* lse, int B, int H, int nq, int nk,
                   int ldo, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_d64_f32_kernel<ONLINE, LSE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_REQUEST);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(nq, BQ), B * H);
  kernel<<<grid, THREADS, SMEM_REQUEST, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], shift, out, lse,
      H, nq, nk, ldo, scale * kLog2e);
  return cudaGetLastError();
}

bool bad_args(int B, int H, int nq, int nk, int ld, int ldo) {
  return B < 1 || H < 1 || B * H > 65535 || nq < 1 || nk < 1 ||
         ld != D * H || ldo % 2;
}

}  // namespace

extern "C" {

// The fp32 64-wide serving forward on split operands (tf32_split.cu):
// q_hi/q_lo [B, nq, ld], k_hi/k_lo [B, nk, ld], vt_hi/vt_lo [B, ld,
// round_up(nk, 8)] fp32, all 16-byte aligned, ld = 64 H; o [B, nq, ldo]
// fp32 with ldo a multiple of 2; `shift` [B*H, nq] fp32 in shifted mode
// (online = 0). The arguments of flash_fwd_d512_f32_sm90.cu's
// mt_flash_fwd_d512_f32. Returns cudaSuccess (0) or the error of the
// checks, the map encoding, the attribute call or the launch.
int mt_flash_fwd_d64_f32(const void* q_hi, const void* q_lo, const void* k_hi,
                         const void* k_lo, const void* vt_hi,
                         const void* vt_lo, const void* shift, void* o, int B,
                         int H, int nq, int nk, int ld, int ldo, int online,
                         float scale, void* stream) {
  if (bad_args(B, H, nq, nk, ld, ldo) || (!online && shift == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[6];
  if (!encode_maps(maps, {q_hi, q_lo, k_hi, k_lo, vt_hi, vt_lo}, B, nq, nk,
                   ld))
    return (int)cudaErrorInvalidValue;
  const float* sh = static_cast<const float*>(shift);
  float* of = static_cast<float*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return online ? (int)launch<true, false>(maps, sh, of, nullptr, B, H, nq,
                                           nk, ldo, scale, st)
                : (int)launch<false, false>(maps, sh, of, nullptr, B, H, nq,
                                            nk, ldo, scale, st);
}

// The training forward: online, and lse [B*H, nq] fp32 in natural-log
// units. Other arguments as mt_flash_fwd_d64_f32's.
int mt_flash_fwd_lse_f32(const void* q_hi, const void* q_lo, const void* k_hi,
                         const void* k_lo, const void* vt_hi,
                         const void* vt_lo, void* o, void* lse, int B, int H,
                         int nq, int nk, int ld, int ldo, float scale,
                         void* stream) {
  if (bad_args(B, H, nq, nk, ld, ldo) || lse == nullptr)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[6];
  if (!encode_maps(maps, {q_hi, q_lo, k_hi, k_lo, vt_hi, vt_lo}, B, nq, nk,
                   ld))
    return (int)cudaErrorInvalidValue;
  return (int)launch<true, true>(maps, nullptr, static_cast<float*>(o),
                                 static_cast<float*>(lse), B, H, nq, nk, ldo,
                                 scale, static_cast<cudaStream_t>(stream));
}

const char* mt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
