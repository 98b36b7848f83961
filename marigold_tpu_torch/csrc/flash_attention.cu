// Flash-attention forward for the SD2 UNet and VAE self-attention on Hopper:
// the C entry points of the forward kernels.
//
// Replaces the forward variants of the TPU package's
// marigold_tpu/ops/flash_attention.py:_flash_dt_impl and
// _flash_dt_impl_lse. 64-wide heads (the UNet's, every softmax mode and the
// training forward with the logsumexp) go to the Hopper kernel of
// flash_fwd_sm90.cu; the 512-wide VAE mid head, in both softmax modes, to
// the Hopper kernel of flash_fwd_d512_sm90.cu (wgmma, TMA, the output's D
// split across two consumer warpgroups). The notes in those files give the
// math, the layout and what bounds each kernel.

#include <cuda_runtime.h>

extern "C" {

// flash_fwd_sm90.cu: the 64-wide Hopper kernel.
int mt_flash_fwd_sm90(const void* q, const void* k, const void* v,
                      const void* shift, void* o, void* lse, int B, int H,
                      int nq, int nk, int ldq, int ldkv, int ldo, float scale,
                      int online, void* stream);

// flash_fwd_d512_sm90.cu: the 512-wide Hopper kernel.
int mt_flash_fwd_d512_sm90(const void* q, const void* k, const void* v,
                           const void* shift, void* o, int B, int H, int nq,
                           int nk, int ldq, int ldkv, int ldo, float scale,
                           int online, void* stream);

// Returns cudaSuccess (0) or the error of the map encoding, the attribute
// call or the launch. `shift` is [B*H, nq] fp32 in shifted mode and ignored
// in online mode. Head dims 64 and 512 are instantiated; any other returns
// cudaErrorInvalidValue.
int mt_flash_attention_fwd(const void* q, const void* k, const void* v,
                           const void* shift, void* o, int B, int H, int nq,
                           int nk, int D, int ldq, int ldkv, int ldo,
                           float scale, int online, void* stream) {
  if (D == 64)
    return mt_flash_fwd_sm90(q, k, v, shift, o, nullptr, B, H, nq, nk, ldq,
                             ldkv, ldo, scale, online, stream);
  if (D == 512)
    return mt_flash_fwd_d512_sm90(q, k, v, shift, o, B, H, nq, nk, ldq, ldkv,
                                  ldo, scale, online, stream);
  return (int)cudaErrorInvalidValue;
}

// The training forward: exact online softmax, output plus the row
// logsumexp `lse` ([B*H, nq] fp32), by the 64-wide Hopper kernel. Any other
// head dim returns cudaErrorInvalidValue.
int mt_flash_attention_fwd_lse(const void* q, const void* k, const void* v,
                               void* o, void* lse, int B, int H, int nq,
                               int nk, int D, int ldq, int ldkv, int ldo,
                               float scale, void* stream) {
  if (D != 64) return (int)cudaErrorInvalidValue;
  return mt_flash_fwd_sm90(q, k, v, nullptr, o, lse, B, H, nq, nk, ldq, ldkv,
                           ldo, scale, 1, stream);
}

const char* mt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
