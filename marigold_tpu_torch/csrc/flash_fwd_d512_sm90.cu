// Flash-attention forward for the 512-wide VAE mid-block head, designed for
// Hopper (sm_90a): wgmma tensor-core products on TMA-loaded tiles, with
// the output's 512 columns split across two consumer warpgroups so that the
// fp32 accumulator lives in registers.
//
// Replaces the 512-wide instantiations of the TPU package's
// marigold_tpu/ops/flash_attention.py kernels:
//   * _flash_kernel_dt_shifted_kblocked (shifted softmax, K streamed;
//     pallas_call at :429), the VAE mid attention of every encode and decode;
//   * _flash_kernel_dt (exact online softmax; :460) at d = 512, which the
//     parity pin selects and the folded [BH, N, 512] entry runs.
//
// Math per (batch, head, query row r), s_j = (q_r . k_j) / sqrt(512), fp32:
//   shifted: p_j = exp(min(s_j - shift_r, 75)), shift_r from the caller;
//   online:  running max m, p_j = exp(s_j - m), O and l rescaled by
//            exp(m_old - m_new) when the max grows;
//   out_r = (sum_j bf16(p_j) v_j) / max(sum_j p_j, 1e-30), stored bf16.
// Every exponential is exp2 on logits scaled by log2(e)/sqrt(512), with the
// shift, the clamp and the running max in the same base-2 units. Key
// columns j >= nk get s_j = -1e30; query rows r >= nq are computed on TMA's
// zero fill and not stored.
//
// Layout: q/k/v/o are [B, N, ld] bf16, head h at channels [512h, 512h+512).
// Each has a 3-D TMA map {ld, N, B} with a {64 ch, 64 rows, 1} box and the
// 128-byte swizzle (64 bf16 are one swizzle row), so a 64 x 512 tile is 8
// boxes, 8 KB each, at channel coordinates 512h + 64i. TMA zero-fills rows
// past nq or nk inside each batch, and the output store drops them.
//
// What bounds it on the H100. 4*N*N*512 FLOPs per head: at N = 9216 the
// tensor-core bound is 0.176 ms per batch row. A block of BQ query rows
// reads all of K and V (4*N*512 bytes, 18.9 MB at N = 9216), mostly from
// L2, for 4*BQ*N*512 FLOPs: BQ FLOP per L2 byte. The 989 TFLOP/s peak at
// BQ = 64 would need ~15 TB/s of L2, about twice what the conv GEMMs
// suggest the card gives (an estimate: no counters run there), so L2
// bandwidth looked like the first limit; the measurement below says
// otherwise. Registers and shared memory set BQ: a [64, 512] fp32
// accumulator is 256 registers per thread of one warpgroup, and a 64-row
// Q, K or V tile is 64 KB.
//
// The design:
//   * one CTA per 64 query rows: a producer warpgroup (one thread issues
//     every TMA load; setmaxnreg 24) and two consumer warpgroups (240);
//   * the output's D is split: warpgroup w owns columns [256w, 256w+256),
//     a [64, 256] fp32 accumulator in 128 registers, rescaled in place in
//     online mode;
//   * the logits are split by keys: for a tile of 64 keys warpgroup w
//     computes S_w = Q K[32w:32w+32]^T over the full 512 (32 k16 steps of
//     wgmma m64n32k16, Q and K K-major in shared memory), turns it into
//     bf16 P in its 32 columns of a [64, 64] P tile, written in the swizzled
//     K-major layout, and after a named barrier over the 256 consumer
//     threads runs O_w += P V[:, 256w:256w+256] (4 k16 steps of wgmma
//     m64n256k16, V MN-major over four 64-column atoms 8 KB apart: the
//     descriptor's leading offset). P is double-buffered, so one tile's P
//     writes never wait for the other warpgroup's last product;
//   * online mode exchanges each warpgroup's row max over its 32 keys
//     through shared memory at one more named barrier; both warpgroups
//     then hold the same running max. Each keeps its own partial row sum,
//     added through shared memory before the epilogue;
//   * Q (64 KB) is loaded once; K and V have one 64 KB slot each with full
//     and empty mbarriers: K_{j+1} loads while tile j's softmax and PV run,
//     V_{j+1} while QK^T_{j+1} runs (about 210 KB of the 227 KB);
//   * the epilogue divides by l, rounds to bf16, stages the tile in Q's
//     (then idle) shared memory and stores it with TMA.
// Measured on the H100 (PERF.md): each CTA takes ~2.4-2.8 us per 64-key
// tile at every shape, also where one wave holds fewer CTAs than SMs (108
// at [1, 6912, 512]), against ~1.1 us of tensor work at the peak. So the
// aggregate L2 bandwidth estimated above is not what binds; the limit is
// inside the SM. Two changes aimed at L2 and at load latency both measured
// slower and were taken out: CTA pairs sharing each K/V tile by TMA
// multicast (1.6-2.1x slower), and a mbarrier pair per 8 KB K box and per
// 16 KB V slice, refilled as each wgmma group completes (8-22% slower;
// ptxas then injects a warpgroup.arrive per group). The likeliest limit
// left is the m64n32 QK^T, whose shared-memory operands carry 21 FLOP per
// byte where the tensor peak needs ~32, with both warpgroups' softmax
// between the products (an estimate: no counters run there).
// Known limit, not fixed here: at B = 1, N = 9216 the 144 CTAs make two
// waves on 132 SMs, the second nearly empty; splitting the keys of a query
// tile across CTAs would fill it (later work). At B = 10 the 1440 CTAs
// make 10.9 waves.

#include "sm90.cuh"

namespace {

constexpr int D = 512;            // head width
constexpr int BQ = 64;            // query rows per CTA
constexpr int BK = 64;            // keys per K/V tile
constexpr int CONSUMERS = 2;      // consumer warpgroups
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int WN = D / CONSUMERS;  // 256 output columns per warpgroup
constexpr int SN = BK / CONSUMERS;  // 32 logit columns per warpgroup
constexpr int BOX_BYTES = 64 * 128;  // {64 ch, 64 rows} bf16
constexpr int BOXES = D / 64;        // 8 boxes per 64 x 512 tile
constexpr int TILE_BYTES = BOXES * BOX_BYTES;  // 64 KB
constexpr int P_BYTES = BQ * BK * 2;           // 8 KB

// Shared memory: Q (reused to stage the output), K, V, two P tiles, the
// [2][64] fp32 exchange of row maxima and row sums, then the barriers;
// every tile 1024-byte aligned (the 128B swizzle atom).
constexpr int SM_Q = 0;
constexpr int SM_K = SM_Q + TILE_BYTES;
constexpr int SM_V = SM_K + TILE_BYTES;
constexpr int SM_P = SM_V + TILE_BYTES;
constexpr int SM_RED = SM_P + 2 * P_BYTES;
constexpr int SM_BAR = SM_RED + CONSUMERS * BQ * 4;
constexpr int SM_BYTES = SM_BAR + 8 * 5;
constexpr int SMEM_REQUEST = SM_BYTES + 1024;  // room to align the base
static_assert(SMEM_REQUEST <= 232448, "fits the 227 KB a block can use");

constexpr float kNegInf = -1e30f;  // the TPU kernels' NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
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

// Byte offset of element (row r, column c) in a tile of 128-byte swizzled
// rows (c < 64): the 16-byte chunk c/8 is XORed with r % 8.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + 2 * (c & 7);
}

// Accumulator layout of wgmma m64nN (per warpgroup thread t, warp w = t/32,
// lane l): d[4j + e] is row 16w + l/4, column 8j + 2(l%4) + e, and
// d[4j + 2 + e] the same columns of row 16w + l/4 + 8 (e in {0, 1}).
template <bool ONLINE>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_d512_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_o,
                      const float* __restrict__ shift, int H, int nq, int nk,
                      float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gen = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bar_q = base + SM_BAR;
  const uint32_t k_full = bar_q + 8, k_empty = bar_q + 16;
  const uint32_t v_full = bar_q + 24, v_empty = bar_q + 32;
  float* red = reinterpret_cast<float*>(gen + SM_RED);  // [CONSUMERS][BQ]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int n_tiles = (nk + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    mbar_init(k_empty, CONSUMERS);
    mbar_init(v_empty, CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer warpgroup: one thread issues every TMA load, a 64 x 512
    // tile as 8 boxes on one barrier.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      auto load = [&](uint32_t dst, const CUtensorMap* map, int row,
                      uint32_t full) {
        mbar_expect_tx(full, TILE_BYTES);
        for (int i = 0; i < BOXES; ++i)
          tma_load(dst + i * BOX_BYTES, map, h * D + 64 * i, row, b, full);
      };
      load(base + SM_Q, &tm_q, q0, bar_q);
      for (int j = 0; j < n_tiles; ++j) {
        if (j > 0) mbar_wait(k_empty, (j - 1) & 1);
        load(base + SM_K, &tm_k, j * BK, k_full);
        if (j > 0) mbar_wait(v_empty, (j - 1) & 1);
        load(base + SM_V, &tm_v, j * BK, v_full);
      }
    }
    return;
  }

  // Consumer warpgroup c: logit columns [32c, 32c + 32) of each key tile
  // and output columns [256c, 256c + 256).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;  // this thread's rows: r0, r0 + 8
  const int col = 2 * (lane % 4);           // its column pair in each 8
  const int row0 = q0 + r0;                 // global query rows
  const int row1 = row0 + 8;
  float* red_mine = red + c * BQ;
  const float* red_other = red + (1 - c) * BQ;

  float sh0 = 0.f, sh1 = 0.f;  // shifted mode: the row shift, base 2
  if (!ONLINE) {
    if (row0 < nq) sh0 = shift[(size_t)bh * nq + row0] * kLog2e;
    if (row1 < nq) sh1 = shift[(size_t)bh * nq + row1] * kLog2e;
  }
  float m0 = kNegInf, m1 = kNegInf;  // running max (online), base 2
  float l0 = 0.f, l1 = 0.f;          // this thread's part of its row sums
  float o[WN / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) o[i] = 0.f;
  float s[SN / 2];
#pragma unroll
  for (int i = 0; i < SN / 2; ++i) s[i] = 0.f;

  auto issue_qk = [&]() {
    const uint32_t k_rows = base + SM_K + c * SN * 128;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * BOX_BYTES + 32 * (kk % 4);
      wgmma_m64n32k16_ss(s, kmajor_desc(base + SM_Q + off),
                         kmajor_desc(k_rows + off), kk);
    }
    wgmma_commit();
  };

  mbar_wait(bar_q, 0);
  mbar_wait(k_full, 0);
  issue_qk();
  wgmma_wait<0>();
  fence_regs(s);
  if (n_tiles > 1 && t == 0) mbar_arrive(k_empty);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK + c * SN;  // this warpgroup's first key
    if (k0 + SN > nk) {              // the ragged edge: mask keys >= nk
#pragma unroll
      for (int jj = 0; jj < SN / 8; ++jj) {
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
      for (int jj = 0; jj < SN / 8; ++jj) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * jj], s[4 * jj + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
      }
      mx0 = quad_max(mx0) * scale_log2;
      mx1 = quad_max(mx1) * scale_log2;
      if (lane % 4 == 0) {
        red_mine[r0] = mx0;
        red_mine[r0 + 8] = mx1;
      }
      named_barrier(1, 128 * CONSUMERS);
      ref0 = fmaxf(m0, fmaxf(mx0, red_other[r0]));
      ref1 = fmaxf(m1, fmaxf(mx1, red_other[r0 + 8]));
      const float a0 = ex2(m0 - ref0), a1 = ex2(m1 - ref1);
      m0 = ref0;
      m1 = ref1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int i = 0; i < WN / 8; ++i) {
        o[4 * i] *= a0;
        o[4 * i + 1] *= a0;
        o[4 * i + 2] *= a1;
        o[4 * i + 3] *= a1;
      }
    } else {
      ref0 = sh0;
      ref1 = sh1;
    }

    // P = exp2(...) in bf16 into this warpgroup's 32 columns of P[j % 2]
    unsigned char* p_tile = gen + SM_P + (j & 1) * P_BYTES;
#pragma unroll
    for (int jj = 0; jj < SN / 8; ++jj) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = fmaf(s[4 * jj + e], scale_log2, -ref0);
        float x1 = fmaf(s[4 * jj + 2 + e], scale_log2, -ref1);
        if (!ONLINE) {
          x0 = fminf(x0, kClamp2);
          x1 = fminf(x1, kClamp2);
        }
        p[e] = ex2(x0);
        p[2 + e] = ex2(x1);
        l0 += p[e];
        l1 += p[2 + e];
      }
      const int pc = c * SN + 8 * jj + col;  // key column in the tile
      *reinterpret_cast<uint32_t*>(p_tile + swz(r0, pc)) = pack_bf16(p[0], p[1]);
      *reinterpret_cast<uint32_t*>(p_tile + swz(r0 + 8, pc)) =
          pack_bf16(p[2], p[3]);
    }
    // the generic-proxy P writes, seen by the other warpgroup's wgmma
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_barrier(1, 128 * CONSUMERS);

    // O_w += P V[:, 256c:256c+256], then (while it runs) the next QK^T
    mbar_wait(v_full, j & 1);
    const uint32_t p_addr = base + SM_P + (j & 1) * P_BYTES;
    const uint32_t v_cols = base + SM_V + c * (WN / 64) * BOX_BYTES;
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n256k16_ss<1>(o, kmajor_desc(p_addr + 32 * kk),
                             mnmajor_desc_wide(v_cols + 2048 * kk, BOX_BYTES),
                             1);
    wgmma_commit();
    if (j + 1 < n_tiles) {
      mbar_wait(k_full, (j + 1) & 1);
      issue_qk();
      wgmma_wait<1>();  // P V of tile j is done; QK^T may still run
      if (t == 0) mbar_arrive(v_empty);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(o);
      if (j + 2 < n_tiles && t == 0) mbar_arrive(k_empty);
    } else {
      wgmma_wait<0>();
      fence_regs(o);
    }
  }

  // The row sums: this warpgroup's part, then the other's through shared
  // memory (its last reads of the row maxima are behind the P barrier).
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (lane % 4 == 0) {
    red_mine[r0] = l0;
    red_mine[r0 + 8] = l1;
  }
  named_barrier(1, 128 * CONSUMERS);
  const float inv0 = 1.f / fmaxf(l0 + red_other[r0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l1 + red_other[r0 + 8], 1e-30f);

  // Stage the bf16 output in Q's boxes 4c..4c+3 (every QK^T of both
  // warpgroups completed before the barrier), swizzled as the O map
  // expects, then one TMA store per box; rows past nq are dropped.
#pragma unroll
  for (int i = 0; i < WN / 8; ++i) {
    unsigned char* box = gen + SM_Q + (c * (WN / 64) + i / 8) * BOX_BYTES;
    const int bc = 8 * (i % 8) + col;
    *reinterpret_cast<uint32_t*>(box + swz(r0, bc)) =
        pack_bf16(o[4 * i] * inv0, o[4 * i + 1] * inv0);
    *reinterpret_cast<uint32_t*>(box + swz(r0 + 8, bc)) =
        pack_bf16(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_barrier(2 + c, 128);
  if (t == 0 && q0 < nq) {
    for (int i = 0; i < WN / 64; ++i) {
      const int bx = c * (WN / 64) + i;
      tma_store(&tm_o, base + SM_Q + bx * BOX_BYTES, h * D + 64 * bx, q0, b);
    }
  }
}

// A map of a [B, N, ld] bf16 tensor with a {64, 64, 1} box.
bool encode(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, int B, int N,
            int ld) {
  const cuuint64_t dims[3] = {(cuuint64_t)ld, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)N * ld * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  return encode_bf16_sw128(fn, map, ptr, 3, dims, strides, box);
}

template <bool ONLINE>
cudaError_t launch(const CUtensorMap* maps, const float* shift, int B, int H,
                   int nq, int nk, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_d512_kernel<ONLINE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_REQUEST);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(nq, BQ), B * H);
  kernel<<<grid, THREADS, SMEM_REQUEST, stream>>>(
      maps[0], maps[1], maps[2], maps[3], shift, H, nq, nk, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The 512-wide forward, called by mt_flash_attention_fwd
// (flash_attention.cu) for D == 512. q and o are [B, nq, ldq/ldo], k and v
// [B, nk, ldkv] bf16, 16-byte aligned, with row strides a multiple of 8
// elements (TMA's 16-byte rule); `shift` is [B*H, nq] fp32 in shifted mode.
// Returns cudaSuccess or the error of the map encoding, the attribute call
// or the launch.
int mt_flash_fwd_d512_sm90(const void* q, const void* k, const void* v,
                           const void* shift, void* o, int B, int H, int nq,
                           int nk, int ldq, int ldkv, int ldo, float scale,
                           int online, void* stream) {
  if (B < 1 || H < 1 || nq < 1 || nk < 1 || ldq % 8 || ldkv % 8 || ldo % 8 ||
      (!online && shift == nullptr))
    return (int)cudaErrorInvalidValue;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap maps[4];
  if (!encode(fn, &maps[0], q, B, nq, ldq) ||
      !encode(fn, &maps[1], k, B, nk, ldkv) ||
      !encode(fn, &maps[2], v, B, nk, ldkv) ||
      !encode(fn, &maps[3], o, B, nq, ldo))
    return (int)cudaErrorInvalidValue;
  const float* sh = static_cast<const float*>(shift);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return online ? launch<true>(maps, sh, B, H, nq, nk, scale, st)
                : launch<false>(maps, sh, B, H, nq, nk, scale, st);
}

}  // extern "C"
