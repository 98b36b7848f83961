// The operand split of the 3xTF32 attention kernels (tf32x3.cuh): each fp32
// input of flash_fwd_d64_f32_sm90.cu, flash_fwd_d512_f32_sm90.cu,
// flash_bwd_dq_f32_sm90.cu and flash_bwd_dkv_f32_sm90.cu becomes two tf32
// copies in device memory, hi = cvt.rna.tf32(x) and
// lo = cvt.rna.tf32(x - hi), either in the input's own [B, N, C] layout or
// transposed to [B, C, NP] for an operand whose reduction index is N (wgmma
// reads tf32 operands K-major only, and TMA cannot transpose).
//
// Replaces no TPU kernel of its own: it is the first launch of the 3xTF32
// path of marigold_tpu/ops/flash_attention.py's kernels at :396, :429, :460,
// :522 and :638 (the forwards) and :800 and :832 (the backward), whose MXU
// takes fp32 storage as it is.
//
// A transposed copy holds NP = N rounded up to 8 columns, input rows past
// N read as zeros, and permutes each group of 8 columns: stored column
// 8g + kappa is input row 8g + TF32_PERM[kappa], TF32_PERM = 0, 2, 4, 6,
// 1, 3, 5, 7, the order in which an accumulator's registers form a tf32 A
// fragment (tf32x3.cuh).
//
// One launch splits up to MAX_JOBS tensors of one [B, *, C] family (a
// forward's q, k and v^T; the backward's q, dO, k, v, q^T, dO^T and k^T),
// each a job of its own row count: blockIdx.z is the job, blockIdx.y the
// batch row, blockIdx.x a 32 x 32 tile (the last one along C masked where C
// is not a multiple of 32). A plain job reads and writes each row of the
// tile as one 128-byte warp access; a transposed job goes through a
// [32][33] shared tile (conflict-free both ways) and writes rows of the
// transposed copy.
//
// What bounds it on the H100: bytes. Each job reads its input once and
// writes two copies, 12 bytes per element, with a few integer and fp32
// operations per element: at [1, 9216, 512] (q, k and v^T) 170 MB, ~0.05
// ms at 3.35 TB/s.

#include "tf32x3.cuh"

namespace {

constexpr int MAX_JOBS = 8;
constexpr int TILE = 32;
constexpr int THREADS = 256;  // 32 x 8: each thread 4 rows of a tile

struct Job {
  const float* src;
  float* hi;
  float* lo;
  int rows;        // N
  int transposed;  // 0: [B, N, C] copies; 1: [B, C, NP] copies
};

struct Jobs {
  Job job[MAX_JOBS];
};

__device__ __forceinline__ int padded(const Job& j) {
  return j.transposed ? (j.rows + 7) / 8 * 8 : j.rows;
}

__global__ void __launch_bounds__(THREADS)
tf32_split_kernel(const __grid_constant__ Jobs jobs, int C, int tiles_c) {
  const Job& job = jobs.job[blockIdx.z];
  const int b = blockIdx.y;
  const int c0 = TILE * (blockIdx.x % tiles_c);
  const int n0 = TILE * (blockIdx.x / tiles_c);
  const int np = padded(job);
  if (n0 >= np) return;  // the whole block: this job has fewer tiles
  const int tx = threadIdx.x % TILE, ty = threadIdx.x / TILE;
  const size_t in0 = (size_t)b * job.rows * C;
  uint32_t hi, lo;
  if (!job.transposed) {
    if (c0 + tx >= C) return;  // the ragged last tile of columns
#pragma unroll
    for (int i = 0; i < TILE / 8; ++i) {
      const int n = n0 + ty + 8 * i;
      if (n >= job.rows) break;
      const size_t at = in0 + (size_t)n * C + c0 + tx;
      tf32_split(job.src[at], hi, lo);
      job.hi[at] = __uint_as_float(hi);
      job.lo[at] = __uint_as_float(lo);
    }
    return;
  }
  __shared__ float tile[TILE][TILE + 1];
#pragma unroll
  for (int i = 0; i < TILE / 8; ++i) {
    const int n = n0 + ty + 8 * i;
    tile[ty + 8 * i][tx] = n < job.rows && c0 + tx < C
                               ? job.src[in0 + (size_t)n * C + c0 + tx]
                               : 0.f;
  }
  __syncthreads();
  // output column n0 + tx holds input row n0 + 8 (tx / 8) + TF32_PERM[tx % 8]
  const int k = tx % 8;
  const int src_row = (tx & ~7) + (k < 4 ? 2 * k : 2 * k - 7);
  if (n0 + tx >= np) return;
#pragma unroll
  for (int i = 0; i < TILE / 8; ++i) {
    const int cc = ty + 8 * i;
    if (c0 + cc >= C) break;
    const size_t at = ((size_t)b * C + c0 + cc) * np + n0 + tx;
    tf32_split(tile[src_row][cc], hi, lo);
    job.hi[at] = __uint_as_float(hi);
    job.lo[at] = __uint_as_float(lo);
  }
}

}  // namespace

extern "C" {

// Splits n_jobs (1..MAX_JOBS = 8) fp32 tensors src[i], each [B, rows[i], C] and
// contiguous, into hi[i] and lo[i]: [B, rows[i], C] if transposed[i] is 0,
// else [B, C, round_up(rows[i], 8)] in the permuted column order. C is a
// multiple of 4 (the narrow heads' folded tensors, C = 40 or 80, end in a
// part-filled tile of columns). Returns cudaSuccess (0),
// cudaErrorInvalidValue for bad arguments, or the launch's error.
int mt_tf32_split(const void* const* src, void* const* hi, void* const* lo,
                  const int* rows, const int* transposed, int n_jobs, int B,
                  int C, void* stream) {
  if (n_jobs < 1 || n_jobs > MAX_JOBS || B < 1 || B > 65535 || C < 4 ||
      C % 4)
    return (int)cudaErrorInvalidValue;
  Jobs jobs = {};
  int max_np = 0;
  for (int i = 0; i < n_jobs; ++i) {
    if (rows[i] < 1) return (int)cudaErrorInvalidValue;
    jobs.job[i] = {static_cast<const float*>(src[i]),
                   static_cast<float*>(hi[i]), static_cast<float*>(lo[i]),
                   rows[i], transposed[i] != 0};
    const int np = transposed[i] ? (rows[i] + 7) / 8 * 8 : rows[i];
    max_np = np > max_np ? np : max_np;
  }
  const int tiles_c = cdiv(C, TILE);
  const dim3 grid(tiles_c * cdiv(max_np, TILE), B, n_jobs);
  tf32_split_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      jobs, C, tiles_c);
  return (int)cudaGetLastError();
}

const char* mt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
