// Winograd F(2x2, 3x3) SAME-padded stride-1 convolution for Hopper
// (sm_90a), bf16, in one of two designs that the wrapper
// (ops/winograd.py:design) picks by the shape: "fused", one launch that
// builds V in shared memory from boxes of x (C <= 256), or "split", an
// input-transform launch that writes V to a scratch and a GEMM launch that
// reads it back with TMA.
//
// Replaces the TPU package's Winograd Pallas kernel,
// marigold_tpu/ops/winograd.py:_winograd_impl / _kernel (pallas_call at
// :251, opt-in under MARIGOLD_TPU_CONV=winograd), which builds V in VMEM
// and never stores it. Per 2x2 output tile with 4x4 input patch d:
//   V = B^T d B (per input channel), M_ij = sum_c V_ij[c] U_ij[k, c],
//   Y = A^T M A + bias,
//   B^T = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]],
//   A^T = [[1,1,1,0],[0,1,-1,-1]],
// with U = G g G^T computed by the wrapper in fp32 and rounded to bf16 (as
// the TPU wrapper computes it outside its kernel), laid out [16, K, C]. V is
// summed in fp32 (rows of d first, then columns) and rounded once to bf16;
// M, the output transform and the bias are fp32; y is bf16. x and y are
// NCHW bf16, the bias [K] bf16; H and W are even.
//
// The GEMM (both designs). A block owns 64 tiles and 64 output channels
// per consumer warpgroup (two; the split design takes one where two would
// not cover the 132 SMs). A stage is one ij and one 64-channel chunk of C:
// four wgmma m64n64k16 on K-major tiles in the 128-byte swizzle (A = V_ij,
// 64 tiles x 64 channels; B = U_ij, 64 output channels x 64 channels,
// streamed by TMA from the map {C, K, 16}). Each consumer keeps four
// output-phase accumulators Y_q and two accumulators for the products that
// take turns, so that the fold of a finished product into the Y_q (with
// the signs of A^T (x) A^T) runs while the next product is on the tensor
// cores: 2 x 32 + 4 x 32 fp32 registers a thread.
//
// Split (two launches): winograd_input_kernel reads 4 input rows of a tile
// row into shared memory, forms V per (tile, channel) and writes the
// scratch V [16, T, C] (T = B * H/2 * W/2 tiles in raster order, C
// innermost); the GEMM's producer thread brings V_ij tiles ({64 ch, 64
// tiles, 1} of the map {C, T, 16}) and U tiles with TMA into rings of 8.
// Its stages are ij-major: M_ij over all of C in one accumulator, folded
// while the first stage of ij + 1 runs in the other, so that the tensor
// cores do not wait for a fold after each ij. The epilogue stages Y
// through the idle rings so that the stores run along W.
//
// Fused (one launch): a persistent grid of one block per SM over work
// items, an item being a 4 x 16 rectangle of one image's tiles and a
// 128-channel slice of the output (slices fastest, so that the items that
// share an input box run side by side and the second reads it from L2);
// the rings and barriers run on from one item to the next, so that the
// next item's box loads and its V is built while this one's last stages
// run and its output is stored. Stages are chunk-major: for each
// 64-channel chunk, the 16 ij, each a fresh M_ij of the chunk folded into
// the Y_q while the next runs (one fold per stage: Y sums M over (chunk,
// ij) in fp32, an association that differs from a full-C M_ij only by fp32
// rounding). Warpgroup 0: warp 0 the producer, warps 1-3 the builders.
//   * The box: per chunk the producer brings {40 px, 10 rows, 64 ch} of
//     x from column 2 tx0 (input columns 2 tx0 .. 2 tx0 + 32 are needed;
//     a TMA box must start on a 16-byte aligned column: one that starts at
//     2 tx0 - 1 faults with an illegal instruction) with one load of a 4-D
//     map over NCHW x, {W, H, C, B}, whose zero fill past every image edge
//     is the SAME padding and keeps a box inside its image. The builders
//     bring the left halo column 2 tx0 - 1 with cp.async (one word per
//     channel and row, the value in its high half) a chunk ahead, into one
//     of two halo buffers. Where TMA cannot describe the box (W not a
//     multiple of 8; x not 16-byte aligned) they load the box themselves.
//     One box buffer: the next chunk's box loads once the builders are
//     done with this one, while the consumers work off the stages the
//     builders are ahead by.
//   * V: for each row i of B^T the builders form V_i0..V_i3 of the chunk
//     at once (a "quad" of 4 slots of a ring of 8): a lane reads the two
//     input rows of two neighbouring tiles for 2 channels (8- and 4-byte
//     loads), sums them in fp32 into 6 row values, forms the 8 V, rounds
//     them to bf16 pairs and stores one word per tile and j in the swizzle
//     that the wgmma descriptor reads. A slot's row m holds tile (ty_l,
//     tx_l) = (m / 16, 2 (m % 8) + (m / 8) % 2), so that the 32 words of a
//     store fall in 32 distinct banks, and so that a consumer thread's two
//     accumulator rows are neighbouring tiles: the epilogue stores Y
//     straight from the registers, 8 contiguous bytes a thread and output
//     row, with no staging and no barrier.
//   V never reaches HBM, and x is read once per 128 output channels.
//   Shared memory: V ring 64 KB, U ring 6 x 16 KB, box 50 KB, halos 5 KB.
//
// What bounds it on the H100: 8*C*K FLOPs per output pixel (2.25x fewer
// than the direct conv), small against the bytes that feed the tensor
// cores: each stage of 1 MFLOP (two consumers) reads a 16 KB U tile from
// L2, and V (split: an 8 KB tile, which its input transform also wrote to
// HBM, 4x the input's bytes); the fused design's builders and the per-stage
// folds and barriers take the rest (PERF.md has the measured split). The
// split design runs from C = 512, where V's round trip is a small share.
//
// Registers (setmaxnreg within the launch allocation): fused 72 for the
// producer and builders, 216 for the consumers; split 40 and 232. ptxas
// reports no spills (chip_smoke.py's build phase prints and gates it).
//
// WINO_VARIANT_NO_BUILD, _NO_WGMMA and _NO_FOLD (winograd_variants.py
// alone defines them) take the V build, the products or all but one
// register of each fold out of the fused design, for a breakdown of its
// time; the output is then wrong.

#include <atomic>
#include <cstring>

#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

// A^T[q][i] for q in {0, 1}
__host__ __device__ constexpr int at(int q, int i) {
  return q == 0 ? (i == 3 ? 0 : 1) : (i == 0 ? 0 : (i == 1 ? 1 : -1));
}

// ---- split design, launch 1: the input transform -------------------------

constexpr int XT = 32;              // tiles per block along W
constexpr int XC = 64;              // channels per block
constexpr int X_THREADS = 256;
constexpr int XPAIRS = XT + 2;      // column pairs 2tx0-2 .. 2tx0+2XT+1
constexpr int XROW = 2 * XPAIRS;    // bf16 per staged input row
constexpr int XCH = 4 * XROW + 2;   // bf16 per channel: an odd word count,
                                    // so lanes 2 channels apart do not
                                    // share a bank

__global__ void __launch_bounds__(X_THREADS)
winograd_input_kernel(const bf16* __restrict__ x, bf16* __restrict__ v,
                      int C, int H, int W, int T) {
  __shared__ __align__(4) bf16 patch[XC * XCH];
  const int ht = H / 2, wt = W / 2;
  const int strips = cdiv(wt, XT);
  const int s = blockIdx.x % strips;
  const int bty = blockIdx.x / strips;  // b * ht + ty
  const int ty = bty % ht, b = bty / ht;
  const int tx0 = s * XT;
  const int ntx = min(XT, wt - tx0);
  const int c0 = blockIdx.y * XC;
  const bf16* xb = x + ((size_t)b * C + c0) * H * W;
  // input rows 2ty-1 .. 2ty+2 as bf16 pairs from column 2tx0-2; W is even,
  // so a pair lies wholly inside or outside the image; zeros outside
  for (int i = threadIdx.x; i < XC * 4 * XPAIRS; i += X_THREADS) {
    const int pr = i % XPAIRS, row = i / XPAIRS;
    const int r = row % 4, c = row / 4;
    const int hh = 2 * ty - 1 + r, ww = 2 * tx0 - 2 + 2 * pr;
    __nv_bfloat162 pair = __floats2bfloat162_rn(0.0f, 0.0f);
    if (hh >= 0 && hh < H && ww >= 0 && ww < W)
      pair = *reinterpret_cast<const __nv_bfloat162*>(
          xb + ((size_t)c * H + hh) * W + ww);
    *reinterpret_cast<__nv_bfloat162*>(patch + c * XCH + r * XROW + 2 * pr) =
        pair;
  }
  __syncthreads();
  // one tile and a channel pair per thread; a warp stores 64 channels
  const size_t tile0 = (size_t)bty * wt + tx0;
  for (int i = threadIdx.x; i < ntx * (XC / 2); i += X_THREADS) {
    const int cp = i % (XC / 2), t = i / (XC / 2);
    float vv[2][16];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      // the tile's 4x4 patch: image columns 2(tx0 + t) - 1 ..
      const bf16* src = patch + (2 * cp + e) * XCH + 2 * t + 1;
      float d[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          d[r][q] = __bfloat162float(src[r * XROW + q]);
      float f[4][4];  // B^T d
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        f[0][q] = d[0][q] - d[2][q];
        f[1][q] = d[1][q] + d[2][q];
        f[2][q] = d[2][q] - d[1][q];
        f[3][q] = d[1][q] - d[3][q];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // (B^T d) B
        vv[e][4 * r + 0] = f[r][0] - f[r][2];
        vv[e][4 * r + 1] = f[r][1] + f[r][2];
        vv[e][4 * r + 2] = f[r][2] - f[r][1];
        vv[e][4 * r + 3] = f[r][1] - f[r][3];
      }
    }
    bf16* dst = v + (tile0 + t) * C + c0 + 2 * cp;
#pragma unroll
    for (int ij = 0; ij < 16; ++ij)
      *reinterpret_cast<uint32_t*>(dst + (size_t)ij * T * C) =
          pack_bf16(vv[0][ij], vv[1][ij]);
  }
}

// ---- the GEMM ---------------------------------------------------------------

constexpr int BC = 64;    // input channels per stage: 128 bytes
constexpr int TM = 64;    // tiles per block (the wgmma M)
constexpr int WN = 64;    // output channels per consumer warpgroup
constexpr int V_SLOT = TM * BC * 2;     // 8 KB
constexpr int V_STAGES = 8;             // two quads
constexpr int EPI_PITCH = 2 * TM + 8;   // words per channel of staged output
constexpr int SMEM_MAX = 232448;        // the H100's per-block limit

// the fused design's block of tiles and its input box
constexpr int RECT_TY = 4, RECT_TX = 16;   // tile rows x tile columns
constexpr int BOX_H = 2 * RECT_TY + 2;     // 10 input rows
constexpr int BOX_W = 40;  // columns 2 tx0 .. 2 tx0 + 32, padded to 80 bytes
constexpr int BOX_ROW = BOX_W * 2;         // 80 bytes
constexpr int BOX_CH = BOX_H * BOX_ROW;    // 800 bytes per channel
constexpr int BOX_BYTES = BC * BOX_CH;     // 51200
// column 2 tx0 - 1 (TMA takes a box only from a 16-byte aligned column):
// one word per (channel, row), the value in its high half
constexpr int HALO_BYTES = BC * BOX_H * 4;  // 2560
constexpr int BUILD_WARPS = 3;             // warps 1-3 of warpgroup 0
constexpr int BUILDERS = 32 * BUILD_WARPS;
constexpr int BUILD_BAR = 4;               // named barrier (1-3: epilogue)

template <bool FUSED, int CONSUMERS>
struct Plan {
  static constexpr int THREADS = 128 * (1 + CONSUMERS);
  static constexpr int BN = WN * CONSUMERS;
  static constexpr int U_SLOT = BN * BC * 2;  // 16 or 8 KB
  // fused: one box and two halo buffers (the box of chunk g + 1 loads
  // while the consumers finish chunk g, which the builders are ahead of).
  // Split with one consumer: a ring of 12 as the parent design's read no
  // faster than 8 (PERF.md, PR 23)
  static constexpr int U_STAGES = FUSED ? 6 : 8;
  static constexpr int BOXES = FUSED ? 1 : 0;
  static constexpr int SM_V = 0;
  static constexpr int SM_U = SM_V + V_STAGES * V_SLOT;
  static constexpr int SM_BOX = SM_U + U_STAGES * U_SLOT;
  static constexpr int SM_HALO = SM_BOX + BOXES * BOX_BYTES;
  static constexpr int SM_BAR = SM_HALO + 2 * BOXES * HALO_BYTES;
  // v_full, v_empty [V_STAGES]; u_full, u_empty [U_STAGES]; box_full,
  // box_empty [BOXES]
  static constexpr int N_BAR = 2 * (V_STAGES + U_STAGES + BOXES);
  static constexpr int SMEM = SM_BAR + 8 * N_BAR + 1024;  // + alignment
  // registers a thread after setmaxnreg: the producer (and builder)
  // warpgroup's, and each consumer's (acc 2 x 32, Y 4 x 32 and the rest)
  static constexpr int PRODUCER_REGS = FUSED ? 72 : 40;
  static constexpr int CONSUMER_REGS = FUSED ? 216 : 232;
  static_assert(SMEM <= SMEM_MAX, "shared memory");
  static_assert(CONSUMERS * WN * EPI_PITCH * 4 <= SM_BOX,
                "the staged output fits in the rings");
  // setmaxnreg moves registers within the block's launch allocation (the
  // launch bound's count, in multiples of 8, for every thread): more hangs
  static_assert(128 * (PRODUCER_REGS + CONSUMERS * CONSUMER_REGS) <=
                    65536 / THREADS / 8 * 8 * THREADS,
                "the block's registers");
};

__device__ __forceinline__ float lo_f(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// One quad of the fused design: V_{i,0..3} of the block's 64 tiles and the
// chunk's 64 channels, from the chunk's box at `box` (and the halo column
// at `halo`) into the four V slots from `vq` (j = 0..3), by builder warp
// `bw`. A warp task is a tile row ty_l and an octet o of channels; lane l
// (p = l % 8, cp = l / 8) takes tiles 2p, 2p+1 of the row and channels
// 8o + 2cp, +1, and stores a word (the channel pair) per tile and j: row m
// of tile 2p is 16 ty_l + p and of tile 2p+1 16 ty_l + 8 + p, so a store's
// 32 words fall in chunk o ^ p, word cp of their rows, 32 distinct banks.
// Sums as the split design's input transform: f_i over rows, then V_ij
// over columns, in fp32.
__device__ __forceinline__ void build_quad(const unsigned char* box,
                                           const unsigned char* halo,
                                           unsigned char* vq, int i, int bw,
                                           int lane) {
  // rows of B^T's row i: f_i = d[ra] +- d[rb]
  const int ra = i == 0 ? 0 : (i == 1 ? 1 : (i == 2 ? 2 : 1));
  const int rb = i == 0 ? 2 : (i == 1 ? 2 : (i == 2 ? 1 : 3));
  const bool add = i == 1;
  const int p = lane % 8, cp = lane / 8;
  for (int task = bw; task < RECT_TY * (BC / 8); task += BUILD_WARPS) {
    const int ty_l = task % RECT_TY, o = task / RECT_TY;
    // the pair's columns 4p - 1 .. 4p + 4 of the box (box column 0 is
    // input column 2 tx0): words 4p - 2 (its high half; the halo's at p =
    // 0), 4p .. 4p + 3 and 4p + 4 (its low half)
    const int ch0 = 8 * o + 2 * cp;
    const unsigned char* src = box + ch0 * BOX_CH + 2 * ty_l * BOX_ROW + 8 * p;
    const unsigned char* left =
        p ? src - 4 : halo + (ch0 * BOX_H + 2 * ty_l) * 4;
    const int left_ch = p ? BOX_CH : BOX_H * 4;  // per channel, per row
    const int left_row = p ? BOX_ROW : 4;
    float prev[2][4];
    uint32_t w[2][4];  // [tile][j]: the channel pair, bf16
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const unsigned char* ch = src + e * BOX_CH;
      const unsigned char* lc = left + e * left_ch;
      const uint32_t a0 =
          *reinterpret_cast<const uint32_t*>(lc + ra * left_row);
      const uint2 a14 = *reinterpret_cast<const uint2*>(ch + ra * BOX_ROW);
      const uint32_t a5 =
          *reinterpret_cast<const uint32_t*>(ch + ra * BOX_ROW + 8);
      const uint32_t b0 =
          *reinterpret_cast<const uint32_t*>(lc + rb * left_row);
      const uint2 b14 = *reinterpret_cast<const uint2*>(ch + rb * BOX_ROW);
      const uint32_t b5 =
          *reinterpret_cast<const uint32_t*>(ch + rb * BOX_ROW + 8);
      const float da[6] = {hi_f(a0),    lo_f(a14.x), hi_f(a14.x),
                           lo_f(a14.y), hi_f(a14.y), lo_f(a5)};
      const float db[6] = {hi_f(b0),    lo_f(b14.x), hi_f(b14.x),
                           lo_f(b14.y), hi_f(b14.y), lo_f(b5)};
      float f[6];
#pragma unroll
      for (int q = 0; q < 6; ++q) f[q] = add ? da[q] + db[q] : da[q] - db[q];
#pragma unroll
      for (int tl = 0; tl < 2; ++tl) {  // tile 2p + tl: columns 2tl ..
        const float* g = f + 2 * tl;
        const float vv[4] = {g[0] - g[2], g[1] + g[2], g[2] - g[1],
                             g[1] - g[3]};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (e == 0)
            prev[tl][j] = vv[j];
          else
            w[tl][j] = pack_bf16(prev[tl][j], vv[j]);
        }
      }
    }
    const int off = (16 * ty_l + p) * 128 + ((o ^ p) << 4) + 4 * cp;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<uint32_t*>(vq + j * V_SLOT + off) = w[0][j];
      *reinterpret_cast<uint32_t*>(vq + j * V_SLOT + off + 8 * 128) = w[1][j];
    }
  }
}

// The fused design's box of a chunk filled by the builders with plain
// loads (zeros outside the image): columns 0..32 of each row, input
// columns x0 = 2 tx0 ...
__device__ __forceinline__ void load_box_plain(unsigned char* box,
                                               const bf16* __restrict__ x,
                                               int b, int c0, int C, int H,
                                               int W, int y0, int x0, int bt) {
  constexpr int COLS = 2 * RECT_TX + 1;
  for (int i = bt; i < BC * BOX_H * COLS; i += BUILDERS) {
    const int col = i % COLS, row = (i / COLS) % BOX_H, c = i / (COLS * BOX_H);
    const int hh = y0 + row, ww = x0 + col;
    bf16 val = __float2bfloat16(0.0f);
    if (hh >= 0 && hh < H && ww >= 0 && ww < W)
      val = x[(((size_t)b * C + c0 + c) * H + hh) * W + ww];
    *reinterpret_cast<bf16*>(box + c * BOX_CH + row * BOX_ROW + 2 * col) = val;
  }
}

// The halo column x0 - 1 of a chunk's box (rows y0 .., channels c0 ..)
// into `halo`, thread bt's share (elements bt + 96 k): each element's
// word is the input pair of columns x0 - 2, x0 - 1 (W is even, so the pair
// lies inside or outside the image), copied by cp.async (zeros outside) so
// that it is in flight while the builder works.
__device__ __forceinline__ void load_halo(uint32_t halo,
                                          const bf16* __restrict__ x, int b,
                                          int c0, int C, int H, int W,
                                          int y0, int x0, int bt) {
  for (int i = bt; i < BC * BOX_H; i += BUILDERS) {
    const int row = i % BOX_H, c = i / BOX_H;
    const int hh = y0 + row;
    const bool in = x0 >= 2 && hh >= 0 && hh < H;
    const bf16* src =
        in ? x + (((size_t)b * C + c0 + c) * H + hh) * W + x0 - 2 : x;
    asm volatile(
        "cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(halo + 4 * i),
        "l"(src), "r"(in ? 4 : 0)
        : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The tiles of work item `it`: fused, a RECT_TY x RECT_TX rectangle of
// image b (items run the 128-channel output slices fastest, so that the
// items that share an input box run together and the second reads it from
// L2); split, the 64 tiles from t0 in raster order.
struct Item {
  int n0, b, ty0, tx0, t0;
};

template <bool FUSED, int CONSUMERS>
__device__ __forceinline__ Item item_of(int it, int ht, int wt, int K) {
  Item r{0, 0, 0, 0, 0};
  if (FUSED) {
    const int nk = K / Plan<FUSED, CONSUMERS>::BN;
    const int rx = cdiv(wt, RECT_TX), ry = cdiv(ht, RECT_TY);
    const int rect = it / nk;
    r.n0 = (it % nk) * Plan<FUSED, CONSUMERS>::BN;
    r.tx0 = (rect % rx) * RECT_TX;
    r.ty0 = ((rect / rx) % ry) * RECT_TY;
    r.b = rect / (rx * ry);
  } else {
    r.t0 = blockIdx.x * TM;
    r.n0 = blockIdx.y * Plan<FUSED, CONSUMERS>::BN;
  }
  return r;
}

// Fused: a persistent grid, block x taking items x, x + gridDim.x, ..
// (n_items of them) with its rings and barriers running on from one item
// to the next, so that the next item's box loads and its V is built while
// this one's last stages run and its output is stored. Split: one item,
// the block's.
template <bool FUSED, int CONSUMERS>
__global__ void __launch_bounds__(Plan<FUSED, CONSUMERS>::THREADS, 1)
winograd_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                     const __grid_constant__ CUtensorMap tm_u,
                     const bf16* __restrict__ x, int box_tma,
                     const bf16* __restrict__ bias, bf16* __restrict__ y,
                     int B, int C, int H, int W, int K, int n_items) {
  using P = Plan<FUSED, CONSUMERS>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t v_full = base + P::SM_BAR;
  const uint32_t v_empty = v_full + 8 * V_STAGES;
  const uint32_t u_full = v_empty + 8 * V_STAGES;
  const uint32_t u_empty = u_full + 8 * P::U_STAGES;
  const uint32_t box_full = u_empty + 8 * P::U_STAGES;
  const uint32_t box_empty = box_full + 8 * P::BOXES;
  const int ht = H / 2, wt = W / 2;
  const int nc = C / BC;
  const int first = FUSED ? blockIdx.x : 0;
  const int step = FUSED ? gridDim.x : 1;
  const int last = FUSED ? n_items : 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < V_STAGES; ++s) {
      mbar_init(v_full + 8 * s, FUSED ? BUILDERS : 1);
      mbar_init(v_empty + 8 * s, 4 * CONSUMERS);  // one arrival per warp
    }
    for (int s = 0; s < P::U_STAGES; ++s) {
      mbar_init(u_full + 8 * s, 1);
      mbar_init(u_empty + 8 * s, 4 * CONSUMERS);
    }
    for (int s = 0; s < P::BOXES; ++s) {
      mbar_init(box_full + 8 * s, 1);
      mbar_init(box_empty + 8 * s, 1);  // one builder thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        P::PRODUCER_REGS));
    const int warp = threadIdx.x / 32;
    if (warp == 0) {
      // Producer: one thread issues every TMA load, in stage order (fused:
      // chunk-major; split: ij-major); a chunk's box as the chunk starts,
      // once the builders are done with the chunk before's.
      if (lane != 0) return;
      int s = 0, g = 0;  // stage, chunk of this block
      for (int it = first; it < last; it += step) {
        const Item itm = item_of<FUSED, CONSUMERS>(it, ht, wt, K);
        for (int q = 0; q < 16 * nc; ++q, ++s) {
          const int chunk = FUSED ? q / 16 : q % nc;
          const int ij = FUSED ? q % 16 : q / nc;
          if (FUSED && box_tma && ij == 0) {
            if (g >= 1) mbar_wait(box_empty, (g - 1) & 1);
            mbar_expect_tx(box_full, BOX_BYTES);
            tma_load_4d(base + P::SM_BOX, &tm_a, 2 * itm.tx0, 2 * itm.ty0 - 1,
                        chunk * BC, itm.b, box_full);
            ++g;
          }
          if (!FUSED) {
            const int vs = s % V_STAGES;
            if (s >= V_STAGES)
              mbar_wait(v_empty + 8 * vs, ((s / V_STAGES) - 1) & 1);
            mbar_expect_tx(v_full + 8 * vs, V_SLOT);
            tma_load(base + P::SM_V + vs * V_SLOT, &tm_a, chunk * BC,
                     itm.t0, ij, v_full + 8 * vs);
          }
          const int us = s % P::U_STAGES;
          if (s >= P::U_STAGES)
            mbar_wait(u_empty + 8 * us, ((s / P::U_STAGES) - 1) & 1);
          mbar_expect_tx(u_full + 8 * us, P::U_SLOT);
          tma_load(base + P::SM_U + us * P::U_SLOT, &tm_u, chunk * BC,
                   itm.n0, ij, u_full + 8 * us);
        }
      }
      return;
    }
    if (!FUSED) return;
    // Builders: warps 1-3, one quad (V_{i,0..3} of a chunk) at a time.
    // Chunk g + 1's halo (and, without TMA, its box) is loaded while chunk
    // g is built.
    const int bw = warp - 1, bt = threadIdx.x - 32;
    auto halo_of = [&](int it, int chunk, int hb) {
      const Item itm = item_of<FUSED, CONSUMERS>(it, ht, wt, K);
      load_halo(base + P::SM_HALO + hb * HALO_BYTES, x, itm.b, chunk * BC,
                C, H, W, 2 * itm.ty0 - 1, 2 * itm.tx0, bt);
    };
    if (first < last) halo_of(first, 0, 0);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    int g = 0;
    for (int it = first; it < last; it += step) {
      const Item itm = item_of<FUSED, CONSUMERS>(it, ht, wt, K);
      const int y0 = 2 * itm.ty0 - 1, x0 = 2 * itm.tx0;
      for (int chunk = 0; chunk < nc; ++chunk, ++g) {
        const int hb = g % 2;
        unsigned char* box = sbase + P::SM_BOX;
        const unsigned char* halo = sbase + P::SM_HALO + hb * HALO_BYTES;
        // every builder is past chunk g - 1: its halo buffer takes g + 1
        if (chunk + 1 < nc)
          halo_of(it, chunk + 1, 1 - hb);
        else if (it + step < last)
          halo_of(it + step, 0, 1 - hb);
        if (box_tma)
          mbar_wait(box_full, g & 1);
        else
          load_box_plain(box, x, itm.b, chunk * BC, C, H, W, y0, x0, bt);
        named_barrier(BUILD_BAR, BUILDERS);  // the box and this halo are in
        for (int i = 0; i < 4; ++i) {
          const int s = 16 * g + 4 * i;  // the quad's stages s .. s + 3
          if (s >= V_STAGES)  // consumers release in order: the last slot
            mbar_wait(v_empty + 8 * ((s + 3) % V_STAGES),
                      (((s + 3) / V_STAGES) - 1) & 1);
#ifndef WINO_VARIANT_NO_BUILD
          build_quad(box, halo, sbase + P::SM_V + (s % V_STAGES) * V_SLOT, i,
                     bw, lane);
#endif
          // the generic-proxy V writes, seen by the consumers' wgmma
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mbar_arrive(v_full + 8 * ((s + j) % V_STAGES));
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        named_barrier(BUILD_BAR, BUILDERS);  // every builder is done with it
        if (box_tma && bt == 0) mbar_arrive(box_empty);
      }
    }
    return;
  }

  // Consumer warpgroup c: output channels n0 + 64c .. n0 + 64c + 63.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      P::CONSUMER_REGS));
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  float acc0[WN / 2], acc1[WN / 2];
  float yq[4][WN / 2];  // Y_q, q = 2 qa + qb

  // M of stage s into acc (afresh if `fresh`), committed as one group
  auto issue = [&](float(&acc)[WN / 2], int s, bool fresh) {
    const int vs = s % V_STAGES, us = s % P::U_STAGES;
    mbar_wait(v_full + 8 * vs, (s / V_STAGES) & 1);
    mbar_wait(u_full + 8 * us, (s / P::U_STAGES) & 1);
    const uint32_t a_tile = base + P::SM_V + vs * V_SLOT;
    const uint32_t b_tile = base + P::SM_U + us * P::U_SLOT + c * WN * BC * 2;
#ifndef WINO_VARIANT_NO_WGMMA
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk)
      wgmma_ss<WN>(acc, kmajor_desc(a_tile + 32 * kk),
                   kmajor_desc(b_tile + 32 * kk), !fresh || kk > 0);
#else
    if (a_tile == 1u) {  // never: keeps the accumulators' registers
      wgmma_fence();
      wgmma_ss<WN>(acc, kmajor_desc(a_tile), kmajor_desc(b_tile), !fresh);
    }
#endif
    wgmma_commit();
  };
  auto release = [&](int s) {
    if (lane == 0) {
      mbar_arrive(v_empty + 8 * (s % V_STAGES));
      mbar_arrive(u_empty + 8 * (s % P::U_STAGES));
    }
  };
  // Y_q += A^T[qa][i] A^T[qb][j] M_ij (coefficients 0 or +-1)
#ifndef WINO_VARIANT_NO_FOLD
  constexpr int FOLDED = WN / 2;
#else
  constexpr int FOLDED = 1;
#endif
  auto fold = [&](float(&acc)[WN / 2], int ij) {
    fence_regs(acc);
    const int i = ij / 4, j = ij % 4;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int coef = at(q >> 1, i) * at(q & 1, j);
      if (coef > 0) {
#pragma unroll
        for (int k = 0; k < FOLDED; ++k) yq[q][k] += acc[k];
      } else if (coef < 0) {
#pragma unroll
        for (int k = 0; k < FOLDED; ++k) yq[q][k] -= acc[k];
      }
    }
  };

  int g = 0;  // chunks (fused) of this block so far
  for (int it = first; it < last; it += step) {
#pragma unroll
    for (int k = 0; k < WN / 2; ++k)
#pragma unroll
      for (int q = 0; q < 4; ++q) yq[q][k] = 0.f;
    if (FUSED) {
      // chunk-major: a fresh M_ij per chunk and ij, folded while the next
      // stage runs
      for (int chunk = 0; chunk < nc; ++chunk, ++g) {
        int s0 = 16 * g;
        // opaque to the compiler: with s0 % 8 known to be 0 it hoists
        // every stage's slot addresses and descriptors out of the loop
        // into registers, which the accumulators need
        asm volatile("" : "+r"(s0));
        issue(acc0, s0, true);
#pragma unroll
        for (int ij = 1; ij < 16; ++ij) {
          if (ij & 1)
            issue(acc1, s0 + ij, true);
          else
            issue(acc0, s0 + ij, true);
          wgmma_wait<1>();  // stage s0 + ij - 1 is done; s0 + ij runs on
          release(s0 + ij - 1);
          if (ij & 1)
            fold(acc0, ij - 1);
          else
            fold(acc1, ij - 1);
        }
        wgmma_wait<0>();
        release(s0 + 15);
        fold(acc1, 15);
      }
    } else {
      // ij-major: M_ij over all of C in one accumulator, folded while the
      // next ij's first stage runs
      int s = 0;
#pragma unroll
      for (int ij = 0; ij < 16; ++ij) {
        if (ij & 1)
          issue(acc1, s, true);
        else
          issue(acc0, s, true);
        wgmma_wait<1>();  // the previous ij's last stage is done
        if (s > 0) release(s - 1);
        if (ij > 0) {
          if (ij & 1)
            fold(acc0, ij - 1);
          else
            fold(acc1, ij - 1);
        }
        ++s;
        for (int cb = 1; cb < nc; ++cb, ++s) {
          if (ij & 1)
            issue(acc1, s, false);
          else
            issue(acc0, s, false);
          wgmma_wait<1>();
          release(s - 1);
        }
      }
      wgmma_wait<0>();
      release(s - 1);
      fold(acc1, 15);
    }

    const Item itm = item_of<FUSED, CONSUMERS>(it, ht, wt, K);
    const int r0 = (t / 32) * 16 + lane / 4;  // accumulator rows r0, r0 + 8
    const int col = 2 * (lane % 4);
    if (FUSED) {
      // Y straight from the registers: rows r0 and r0 + 8 are the tiles
      // (ty_l, tx_l) = (r0 / 16, 2 (lane / 4)) and its right neighbour, so
      // a thread's four pixels of an output row are contiguous (8 bytes
      // where W % 4 == 0) and a warp's run along W
      const int ty = itm.ty0 + t / 32, tx = itm.tx0 + 2 * (lane / 4);
      if (ty < ht && tx < wt) {
        const bool both = tx + 1 < wt, wide = W % 4 == 0;
#pragma unroll
        for (int j = 0; j < WN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = itm.n0 + c * WN + 8 * j + col + e;
            const float bn = __bfloat162float(bias[n]);
            const int ka = 4 * j + e, kb = ka + 2;  // rows r0, r0 + 8
#pragma unroll
            for (int qa = 0; qa < 2; ++qa) {
              uint32_t* dst = reinterpret_cast<uint32_t*>(
                  y + (((size_t)itm.b * K + n) * H + 2 * ty + qa) * W + 2 * tx);
              const uint32_t lo = pack_bf16(yq[2 * qa][ka] + bn,
                                            yq[2 * qa + 1][ka] + bn);
              const uint32_t hi = pack_bf16(yq[2 * qa][kb] + bn,
                                            yq[2 * qa + 1][kb] + bn);
              if (both && wide) {
                *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
              } else {
                dst[0] = lo;
                if (both) dst[1] = hi;
              }
            }
          }
        }
      }
      continue;
    }
    // Split: every consumer is done with the rings: stage Y there as
    // [channel][row][qa] bf16 pairs (qb = 0, 1), bias added in fp32.
    named_barrier(1, 128 * CONSUMERS);
    uint32_t* ys = reinterpret_cast<uint32_t*>(sbase) + c * WN * EPI_PITCH;
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ch = 8 * j + col + e;
        const float bn = __bfloat162float(bias[itm.n0 + c * WN + ch]);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int k = 4 * j + 2 * half + e;
          uint32_t* row = ys + ch * EPI_PITCH + 2 * (r0 + 8 * half);
          row[0] = pack_bf16(yq[0][k] + bn, yq[1][k] + bn);  // qa = 0
          row[1] = pack_bf16(yq[2][k] + bn, yq[3][k] + bn);  // qa = 1
        }
      }
    }
    named_barrier(2 + c, 128);
    const int n_tiles = B * ht * wt;
    for (int i = t; i < WN * TM * 2; i += 128) {
      const int r = i % TM, qa = (i / TM) % 2, ch = i / (2 * TM);
      const int tile = itm.t0 + r;
      if (tile >= n_tiles) continue;
      const int bb = tile / (ht * wt), rem = tile % (ht * wt);
      const int ty = rem / wt, tx = rem % wt;
      const int n = itm.n0 + c * WN + ch;
      *reinterpret_cast<uint32_t*>(
          y + (((size_t)bb * K + n) * H + 2 * ty + qa) * W + 2 * tx) =
          ys[ch * EPI_PITCH + 2 * r + qa];
    }
  }
}

// The shared-memory limit of a kernel, set once per device (a bit per
// device of `done`): cudaFuncSetAttribute costs a few microseconds a call.
template <typename Kern>
cudaError_t set_smem_once(Kern kernel, int smem, std::atomic<unsigned>& done) {
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

// The fused design's box map: NCHW x as {W, H, C, B}, a box of {BOX_W,
// BOX_H, BC, 1} without swizzle; zeros out of range.
bool encode_box_map(EncodeTiledFn fn, CUtensorMap* map, const void* x, int B,
                    int C, int H, int W) {
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)C,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)W * 2, (cuuint64_t)H * W * 2,
                                 (cuuint64_t)C * H * W * 2};
  const cuuint32_t box[4] = {BOX_W, BOX_H, BC, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int pick_consumers(int T, int K) {
  return cdiv(T, TM) * (K / (2 * WN)) >= 132 ? 2 : 1;
}

// Streaming multiprocessors of the current device, read once per device.
int sm_count() {
  static std::atomic<int> counts[32];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (dev < 32 && counts[dev].load(std::memory_order_relaxed) > 0)
    return counts[dev].load(std::memory_order_relaxed);
  int n = 132;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (dev < 32) counts[dev].store(n, std::memory_order_relaxed);
  return n;
}

int rects(int B, int H, int W) {
  return B * cdiv(H / 2, RECT_TY) * cdiv(W / 2, RECT_TX);
}

template <bool FUSED, int CONSUMERS>
cudaError_t launch_gemm(const CUtensorMap& tm_a, EncodeTiledFn fn,
                        const void* u, const bf16* x, int box_tma,
                        const bf16* bias, bf16* y, int B, int C, int H, int W,
                        int K, cudaStream_t stream) {
  using P = Plan<FUSED, CONSUMERS>;
  const cuuint64_t dims_u[3] = {(cuuint64_t)C, (cuuint64_t)K, 16};
  const cuuint64_t strides_u[2] = {(cuuint64_t)C * 2, (cuuint64_t)K * C * 2};
  const cuuint32_t box_u[3] = {BC, (cuuint32_t)P::BN, 1};
  CUtensorMap tm_u;
  if (!encode_bf16_sw128(fn, &tm_u, u, 3, dims_u, strides_u, box_u))
    return cudaErrorInvalidValue;
  auto kernel = winograd_gemm_kernel<FUSED, CONSUMERS>;
  static std::atomic<unsigned> attribute_set{0};
  cudaError_t err = set_smem_once(kernel, P::SMEM, attribute_set);
  if (err != cudaSuccess) return err;
  const int T = B * (H / 2) * (W / 2);
  const int n_items = FUSED ? rects(B, H, W) * (K / P::BN) : 1;
  const int sms = sm_count();
  const dim3 grid = FUSED ? dim3(n_items < sms ? n_items : sms)
                          : dim3(cdiv(T, TM), K / P::BN);
  kernel<<<grid, P::THREADS, P::SMEM, stream>>>(tm_a, tm_u, x, box_tma, bias,
                                                y, B, C, H, W, K, n_items);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B, C, H, W], u [16, K, C], bias [K], y [B, K, H, W] bf16; `fused`
// nonzero: one launch (v unused, may be null); zero: the input transform
// into the scratch v [16, B * H/2 * W/2, C] bf16 that the caller
// allocates, then the GEMM. x 4-byte, u and v 16-byte aligned. Returns cudaSuccess (0), cudaErrorInvalidValue for odd H or W,
// C not a multiple of 64, K not a multiple of 128, a misaligned pointer,
// a grid past its limits or a map the driver refuses,
// cudaErrorNotSupported without cuTensorMapEncodeTiled, or the error of an
// attribute call or a launch.
int mt_winograd_fwd(const void* x, const void* u, const void* bias, void* v,
                    void* y, int B, int C, int H, int W, int K, int fused,
                    void* stream) {
  if (B < 1 || H < 2 || W < 2 || H % 2 || W % 2 || C % BC || C < BC ||
      K % (2 * WN) || K < 2 * WN || C / XC > 65535 ||
      reinterpret_cast<uintptr_t>(x) % 4 ||
      reinterpret_cast<uintptr_t>(u) % 16 ||
      (!fused && (v == nullptr || reinterpret_cast<uintptr_t>(v) % 16)) ||
      (long long)B * (H / 2) * (W / 2) > 0x7fffffffLL ||
      (long long)B * cdiv(H / 2, RECT_TY) * cdiv(W / 2, RECT_TX) *
              (K / (2 * WN)) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const int T = B * (H / 2) * (W / 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xs = static_cast<const bf16*>(x);
  const bf16* bs = static_cast<const bf16*>(bias);
  bf16* out = static_cast<bf16*>(y);
  CUtensorMap tm_a;
  if (fused) {
    // TMA reads the box where x's rows are 16-byte multiples and x is
    // 16-byte aligned; the builders load it elsewhere (the map then unused)
    const int box_tma =
        W % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    if (box_tma) {
      if (!encode_box_map(fn, &tm_a, x, B, C, H, W))
        return (int)cudaErrorInvalidValue;
    } else {
      memset(&tm_a, 0, sizeof(tm_a));
    }
    return (int)launch_gemm<true, 2>(tm_a, fn, u, xs, box_tma, bs, out, B,
                                     C, H, W, K, st);
  }
  const dim3 grid_in(B * (H / 2) * cdiv(W / 2, XT), C / XC);
  winograd_input_kernel<<<grid_in, X_THREADS, 0, st>>>(
      xs, static_cast<bf16*>(v), C, H, W, T);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int consumers = pick_consumers(T, K);
  const cuuint64_t dims_v[3] = {(cuuint64_t)C, (cuuint64_t)T, 16};
  const cuuint64_t strides_v[2] = {(cuuint64_t)C * 2, (cuuint64_t)T * C * 2};
  const cuuint32_t box_v[3] = {BC, TM, 1};
  if (!encode_bf16_sw128(fn, &tm_a, v, 3, dims_v, strides_v, box_v))
    return (int)cudaErrorInvalidValue;
  return consumers == 2
             ? (int)launch_gemm<false, 2>(tm_a, fn, u, xs, 0, bs, out, B, C,
                                          H, W, K, st)
             : (int)launch_gemm<false, 1>(tm_a, fn, u, xs, 0, bs, out, B, C,
                                          H, W, K, st);
}

// Blocks of the GEMM launch (the fused design's only launch, a persistent
// grid of at most one block per SM) for this shape (132 SMs on the H100).
int mt_winograd_blocks(int B, int C, int H, int W, int K, int fused) {
  (void)C;
  if (fused) {
    const int n_items = rects(B, H, W) * (K / (2 * WN)), sms = sm_count();
    return n_items < sms ? n_items : sms;
  }
  const int T = B * (H / 2) * (W / 2);
  return cdiv(T, TM) * (K / (WN * pick_consumers(T, K)));
}

const char* mt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
