// 3xTF32 building blocks for the fp32 wgmma kernels
// (flash_fwd_d64_f32_sm90.cu, flash_fwd_d512_f32_sm90.cu,
// flash_bwd_dq_f32_sm90.cu, flash_bwd_dkv_f32_sm90.cu, conv3x3_f32_sm90.cu,
// winograd_f32_sm90.cu) and the operand split the attention kernels read
// (tf32_split.cu): the split of an fp32 value into two TF32 parts, the tf32
// wgmma wrappers, the accumulator-to-A-fragment packing, the 64-wide
// attention kernels' tile products and the fp32 tensor-map encode.
//
// 3xTF32. wgmma takes fp32 storage only as tf32 (the top 19 bits of each
// 32-bit word: 10 mantissa bits). One tf32 product keeps ~2^-11 of each
// operand, ~1e-3 of a sum's scale: not fp32. Each operand is split as
// x = hi + lo, hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi) (x - hi is
// exact in fp32), so hi + lo carries x to ~2^-22; the products sum
// lo.hi + hi.lo + hi.hi in the fp32 accumulator and drop lo.lo (~2^-22 of
// the product), ~2^-21 per product in all. Three tensor passes at 495
// TFLOP/s (H100 SXM, dense tf32) still give 165 TFLOP/s of fp32-accurate
// products, 2.5x the 67 TFLOP/s fp32 FFMA peak.
//
// The tensor cores add each wgmma's products into its accumulator with
// truncation, not rounding to nearest: the error of a long accumulation
// grows with its length. A kernel that sums thousands of k8 steps into one
// accumulator (the attention's P V over all keys, dK and dV over all
// queries) lost ~7e-5 of the output's scale that way at 9216 keys
// (measured on an H100 80GB HBM3 and reproduced by emulating the
// truncation on the CPU); so each 64-key or 64-query tile (in the convs,
// each chunk of a few hundred wgmmas) sums into a fresh accumulator that
// is then added into the running one with fp32 adds, rounded to nearest
// (~7e-6 in the emulation).
//
// Hardware facts these kernels keep to: for .tf32 both wgmma operands are
// K-major (no transpose bit, unlike bf16), so an operand whose reduction
// index is not contiguous in memory comes transposed from the split
// (tf32_split.cu); a 128-byte swizzle row holds 32 fp32 values and a k8
// step advances a descriptor's start by 32 bytes inside it; a tile starts
// on a 1024-byte boundary (kmajor_desc, sm90.cuh; kdesc below).
//
// The A fragment of a tf32 k8 step in registers (per warpgroup thread t,
// warp w = t/32, lane l): a0 is (row 16w + l/4, k = l%4), a1 the row 8
// below, a2 and a3 the same rows at k = l%4 + 4. The m64nN accumulator
// holds, in the same rows, columns 2(l%4) and 2(l%4) + 1 of each 8. So an
// accumulator (P, or P^T and dS^T in the backward) becomes an A operand
// without a shuffle when the B operand's reduction index is permuted
// inside each group of 8: stored position kappa holds index
// TF32_PERM[kappa] = 0, 2, 4, 6, 1, 3, 5, 7. tf32_split.cu writes the
// transposed copies in that order (ops/flash_attention.py:TF32_PERM).

#pragma once

#include "sm90.cuh"

namespace {

constexpr int TF32_ROW = 32;  // fp32 values in one 128-byte swizzle row

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to ~2^-22 of x, each part a tf32 value in a 32-bit word.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// The hi and lo A fragments of k8 steps [J0, J0 + NL/4) of an m64nN
// accumulator `p` (4 registers per step), in the permuted reduction order
// above: those steps of p are overwritten with the hi fragments (tf32 bit
// patterns, read back with __float_as_uint), so that the fp32 values and
// the hi parts share registers; lo[0..NL) gets the lo fragments.
template <int J0, int NA, int NL>
__device__ __forceinline__ void acc_to_tf32x2(float (&p)[NA],
                                              uint32_t (&lo)[NL]) {
  static_assert(4 * J0 + NL <= NA, "steps inside the accumulator");
#pragma unroll
  for (int j = J0; j < J0 + NL / 4; ++j) {
    // in: (row r, 2q), (r, 2q+1), (r+8, 2q), (r+8, 2q+1);
    // out: (r, k 2q), (r+8, k 2q), (r, k 2q+1), (r+8, k 2q+1)
    const float x[4] = {p[4 * j], p[4 * j + 2], p[4 * j + 1], p[4 * j + 3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t hi;
      tf32_split(x[e], hi, lo[4 * (j - J0) + e]);
      p[4 * j + e] = __uint_as_float(hi);
    }
  }
}

// A K-major descriptor (sm90.cuh:kmajor_desc: 128-byte swizzle, 8-row
// groups 1024 bytes apart) as two words: the low one holds the start
// address (and the unused leading offset) and changes per tile and k8
// step; the high one (the stride offset and the swizzle) is the same for
// every tile. The wrappers below take the low word and pack the pair
// inside their asm, so a run of wgmmas keeps one 32-bit register per
// descriptor, not two (the 3xTF32 kernels issue up to 96 in a row and are
// short of registers).
constexpr uint32_t KDESC_HI = (1024 >> 4) | (1u << 30);

__device__ __forceinline__ uint32_t kdesc(uint32_t addr) {
  return ((addr & 0x3FFFF) >> 4) | (1u << 16);
}

// d[64 x 64] (+)= A[64 x 8] B[64 x 8]^T in tf32, both K-major in shared
// memory (descriptors' low words `da`, `db`: kdesc); accumulate = 0
// overwrites d.
__device__ __forceinline__ void wgmma_m64n64k8_tf32_ss(float (&d)[32],
                                                      uint32_t da, uint32_t db,
                                                      int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b64 da, db;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "mov.b64 da, {%32, %35};\n"
      "mov.b64 db, {%33, %35};\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "da, db, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(da), "r"(db), "r"(accumulate), "r"(KDESC_HI));
}

// d[64 x 128] (+)= A[64 x 8] B[128 x 8]^T in tf32, both K-major in shared
// memory (descriptors' low words `da`, `db`: kdesc); accumulate = 0
// overwrites d.
__device__ __forceinline__ void wgmma_m64n128k8_tf32_ss(float (&d)[64],
                                                       uint32_t da, uint32_t db,
                                                       int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b64 da, db;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "mov.b64 da, {%64, %67};\n"
      "mov.b64 db, {%65, %67};\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "da, db, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(da), "r"(db), "r"(accumulate), "r"(KDESC_HI));
}

// d[64 x 64] (+)= A[64 x 8] B[64 x 8]^T in tf32: A in registers (a0..a3,
// the fragment layout above), B K-major in shared memory (descriptor's low
// word `db`: kdesc); accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32],
                                                      uint32_t a0, uint32_t a1,
                                                      uint32_t a2, uint32_t a3,
                                                      uint32_t db,
                                                      int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b64 db;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "mov.b64 db, {%36, %38};\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, db, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(db), "r"(accumulate),
        "r"(KDESC_HI));
}

// The tiles of the 64-wide attention kernels (flash_fwd_d64_f32_sm90.cu,
// flash_bwd_dq_f32_sm90.cu, flash_bwd_dkv_f32_sm90.cu). A resident [128, 64]
// fp32 tile is two TMA boxes of {32 columns, 128 rows}, ATT_RES_BOX bytes
// each, a consumer's 64 rows 8 KB into each; a ring slot is four boxes of
// {32 columns, 64 rows}, ATT_BOX bytes each: hi columns 0-31 and 32-63,
// then lo columns 0-31 and 32-63.
constexpr int ATT_RES_BOX = 128 * 128;  // 16 KB
constexpr int ATT_BOX = 64 * 128;       // 8 KB

// x (+)= A B^T over 64 columns, 3xTF32: A a consumer's 64 rows of a
// resident tile (hi at `ah`, lo at `al`), B a slot's [64, 64] tile. One
// commit group; the first k8 step overwrites x.
__device__ __forceinline__ void wgmma_att_nt(float (&x)[32], uint32_t ah,
                                             uint32_t al, uint32_t slot) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t ra = (kk / 4) * ATT_RES_BOX + 32 * (kk % 4);
    const uint32_t rb = (kk / 4) * ATT_BOX + 32 * (kk % 4);
    const uint32_t a_hi = kdesc(ah + ra), a_lo = kdesc(al + ra);
    const uint32_t b_hi = kdesc(slot + rb);
    const uint32_t b_lo = kdesc(slot + 2 * ATT_BOX + rb);
    wgmma_m64n64k8_tf32_ss(x, a_lo, b_hi, kk > 0);
    wgmma_m64n64k8_tf32_ss(x, a_hi, b_lo, 1);
    wgmma_m64n64k8_tf32_ss(x, a_hi, b_hi, 1);
  }
  wgmma_commit();
}

// acc = A B over 64 reduction rows, 3xTF32: A the hi fragments (bit
// patterns in `hi`) and lo fragments of an accumulator (acc_to_tf32x2), B a
// slot's transposed [64 columns, 64 reduction rows] tile in the permuted
// order. One commit group. The caller pins acc, hi and lo after its wait
// (fence_regs); pinning them here as well made ptxas serialise the wgmmas
// for want of registers (C7511).
__device__ __forceinline__ void wgmma_att_nn(float (&acc)[32],
                                             float (&hi)[32],
                                             uint32_t (&lo)[32],
                                             uint32_t slot) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t rb = (kk / 4) * ATT_BOX + 32 * (kk % 4);
    const uint32_t b_hi = kdesc(slot + rb);
    const uint32_t b_lo = kdesc(slot + 2 * ATT_BOX + rb);
    const uint32_t h0 = __float_as_uint(hi[4 * kk]);
    const uint32_t h1 = __float_as_uint(hi[4 * kk + 1]);
    const uint32_t h2 = __float_as_uint(hi[4 * kk + 2]);
    const uint32_t h3 = __float_as_uint(hi[4 * kk + 3]);
    wgmma_m64n64k8_tf32_rs(acc, lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2],
                           lo[4 * kk + 3], b_hi, kk > 0);
    wgmma_m64n64k8_tf32_rs(acc, h0, h1, h2, h3, b_lo, 1);
    wgmma_m64n64k8_tf32_rs(acc, h0, h1, h2, h3, b_hi, 1);
  }
  wgmma_commit();
}

// A map of an fp32 tensor of `rank` dimensions (innermost first, the
// innermost contiguous), strides in bytes of dimensions 1.., a box of `box`
// elements (32 innermost: one 128-byte swizzle row) and the 128-byte
// swizzle; out-of-range elements read as zero. False if the encode refuses
// it.
inline bool encode_f32_sw128(EncodeTiledFn fn, CUtensorMap* map,
                             const void* ptr, int rank, const cuuint64_t* dims,
                             const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
            const_cast<void*>(ptr), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A map of a [B, rows, ld] fp32 tensor (ld a multiple of 4) with a
// {32, box_rows, 1} box.
inline bool encode_f32_rows(EncodeTiledFn fn, CUtensorMap* map,
                            const void* ptr, int B, int rows, int ld,
                            int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)ld, (cuuint64_t)rows,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 4,
                                 (cuuint64_t)rows * ld * 4};
  const cuuint32_t box[3] = {(cuuint32_t)TF32_ROW, (cuuint32_t)box_rows, 1};
  return encode_f32_sw128(fn, map, ptr, 3, dims, strides, box);
}

}  // namespace
