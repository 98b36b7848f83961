// Flash-attention forward for the UNet and VAE self-attention on Hopper:
// the C entry points of the forward kernels.
//
// Replaces the forward variants of the TPU package's
// marigold_tpu/ops/flash_attention.py:_flash_dt_impl and
// _flash_dt_impl_lse. Heads 40, 64, 80 and 160 wide (the UNets' of SD2 and
// SD1.x-class checkpoints, every softmax mode and the training forward
// with the logsumexp) go to the Hopper kernel of flash_fwd_sm90.cu, a
// template on the head width; the 512-wide VAE mid head, in both softmax
// modes, to
// the Hopper kernel of flash_fwd_d512_sm90.cu (wgmma, TMA, the output's D
// split across two consumer warpgroups). The notes in those files give the
// math, the layout and what bounds each kernel. The shifted softmax's row
// shift is computed inside the kernel at 40, 64, 80 and 160 and passed in
// by the caller at 512.

#include <cuda_runtime.h>

extern "C" {

// flash_fwd_sm90.cu: the Hopper kernel at head widths 40, 64, 80 and 160.
int mt_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                      void* lse, int B, int H, int nq, int nk, int D, int ldq,
                      int ldkv, int ldo, int stride, int n_sub, float scale,
                      int online, void* stream);

// flash_fwd_d512_sm90.cu: the 512-wide Hopper kernel.
int mt_flash_fwd_d512_sm90(const void* q, const void* k, const void* v,
                           const void* shift, void* o, int B, int H, int nq,
                           int nk, int ldq, int ldkv, int ldo, float scale,
                           int online, void* stream);

// Returns cudaSuccess (0) or the error of the checks, the map encoding, the
// attribute call or the launch. Shifted mode (online = 0): at head dims 40,
// 64, 80 and 160 the kernel computes the row shift itself from K's rows 0,
// stride, 2 stride, ... < nk (n_sub = ceil(nk / stride) of them), `shift`
// must be null, and `shift_out` ([B*H, nq] fp32) receives the shift when
// not null; at 512 `shift` is the [B*H, nq] fp32 shift from the caller and
// `shift_out` must be null. Online: `shift` and `shift_out` null. Head dims
// 40, 64, 80, 160 and 512 are instantiated; any other returns
// cudaErrorInvalidValue.
int mt_flash_attention_fwd(const void* q, const void* k, const void* v,
                           const void* shift, void* o, void* shift_out, int B,
                           int H, int nq, int nk, int D, int ldq, int ldkv,
                           int ldo, int stride, int n_sub, float scale,
                           int online, void* stream) {
  if (D == 512)
    return shift_out != nullptr
               ? (int)cudaErrorInvalidValue
               : mt_flash_fwd_d512_sm90(q, k, v, shift, o, B, H, nq, nk, ldq,
                                        ldkv, ldo, scale, online, stream);
  if (shift != nullptr || (online && shift_out != nullptr))
    return (int)cudaErrorInvalidValue;
  return mt_flash_fwd_sm90(q, k, v, o, shift_out, B, H, nq, nk, D, ldq, ldkv,
                           ldo, stride, n_sub, scale, online, stream);
}

// The training forward: exact online softmax, output plus the row
// logsumexp `lse` ([B*H, nq] fp32), by the Hopper kernel at head widths 40,
// 64, 80 and 160. Any other head dim returns cudaErrorInvalidValue.
int mt_flash_attention_fwd_lse(const void* q, const void* k, const void* v,
                               void* o, void* lse, int B, int H, int nq,
                               int nk, int D, int ldq, int ldkv, int ldo,
                               float scale, void* stream) {
  if (D != 40 && D != 64 && D != 80 && D != 160)
    return (int)cudaErrorInvalidValue;
  return mt_flash_fwd_sm90(q, k, v, o, lse, B, H, nq, nk, D, ldq, ldkv, ldo,
                           1, nk, scale, 1, stream);
}

const char* mt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
