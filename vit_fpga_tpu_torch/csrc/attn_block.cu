// Per-block attention half on Hopper (sm_90a), the forward the training
// path and safe-softmax serving run.
//
// Replaces vit_fpga_tpu/ops/attn_block.py:_attn_block_kernel (wrapper
// attn_block_pallas), one Pallas kernel on the TPU.  It is K1
// (attn_stats.cu) with the LayerNorm statistics computed here and a choice
// of softmax.  A short sequence of launches on one stream, counted as one
// ported kernel:
//
//   (a) row_stats           one-pass (mu, rstd) of x, as the TPU kernel
//   (b) gw_kernel<LN>       qkv = bf16(LN(x; mu, rstd, ls, lb) @ Wqkv + bqkv)
//   (c) mha_wgmma_kernel    per (128 query rows, image x head): s = (q k^T)
//                           * scale in f32, keys at or past n_valid
//                           masked; e = exp(s - max) (safe, MW_SAFE) or
//                           exp(clip(s, -70, 80)) (max-free, MW_MAXFREE);
//                           ao = bf16((bf16(e) @ v) * (1 / sum(e))), over
//                           128-key tiles at every length the gate takes
//   (d) gw_kernel           out = x + bf16(ao @ Wo + bo)
//
// (b)-(d) are attn_half.cuh's sequence, K1's: without safe_softmax K4 is
// row_stats followed by K1 without the next stats.  They replace the
// wmma gemm_bf16 of common.cuh (both GEMMs) and attn.cuh's mma.sync
// attention tiles (attn_kernel up to 256 keys, the key-tiled
// attn_long_kernel past them), so one kernel now serves every length.
//
// What bounds it on the H100: at ViT-B/16 batch 64 the launch does 8 R D^2
// + 4 B H n_pad n_valid dh = 68 GFLOP against 44 MB of compulsory traffic,
// so it is bound by tensor-core operations (0.0689 ms at 989 TFLOP/s), as
// K1.  The design is K1's: LN applied to the landed A tiles in shared
// memory, the scores and probabilities in registers; qkv and the attention
// output round-trip through device memory.  The safe mode computes q k^T
// twice (the row max, then e against it, both from the same bits): 2 B H
// n_pad n_valid dh more flops, 3 GFLOP (4%) at ViT-B/16 b64.

#define VFT_NS attn_block
#include "common.cuh"
#include "hopper.cuh"
#include "gemm_wgmma.cuh"
#include "mha_wgmma.cuh"
#include "attn_half.cuh"

using namespace VFT_NS;

extern "C" {

// Finds the driver's tensor-map encoder and opts this unit's kernels in to
// the shared memory they use, on the current device.  Called once per
// device before the first launch.  Returns a cudaError_t.
int vft_attn_block_init() {
  cudaError_t err = attn_half_enable<MW_MAXFREE>();
  if (err != cudaSuccess) return err;
  return mha_wgmma_enable<MW_SAFE>();
}

// x, out: (B * n_pad, D) bf16; ls, lb, bo: (D,) f32; wqkv: (D, 3D) bf16;
// bqkv: (3D,) f32; wo: (D, D) bf16.  Scratch: stats (B * n_pad, 2) f32,
// qkv (B * n_pad, 3D) and ao (B * n_pad, D) bf16; every pointer 16-byte
// aligned.  Head dim 64, 1 <= n_valid <= n_pad <= 1024.  safe selects the
// max-subtract softmax.  *long_path is set to 1 when more than 256 keys
// are valid (the same kernels; the launch checks count those launches
// apart) and 0 otherwise.  Everything is enqueued on `stream`, which
// belongs to the current device.  Returns a cudaError_t.
int vft_attn_block_fwd(const void* x, const void* ls, const void* lb, const void* wqkv,
                       const void* bqkv, const void* wo, const void* bo, void* out, void* stats,
                       void* qkv, void* ao, int batch, int n_pad, int d, int heads, int n_valid,
                       int safe, float eps, float scale, void* stream, int* long_path) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (d != heads * AH_DH || batch < 1 || n_valid < 1 || n_valid > n_pad ||
      n_pad > AH_MAX_TOKENS)
    return cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  float* stf = static_cast<float*>(stats);
  cudaError_t err;
  if ((err = launch_row_stats(xb, stf, batch * n_pad, d, eps, st)) != cudaSuccess) return err;
  const auto half = safe ? launch_attn_half<MW_SAFE> : launch_attn_half<MW_MAXFREE>;
  if ((err = half(xb, stf, static_cast<const float*>(ls), static_cast<const float*>(lb),
                  static_cast<const bf16*>(wqkv), static_cast<const float*>(bqkv),
                  static_cast<const bf16*>(wo), static_cast<const float*>(bo),
                  static_cast<bf16*>(out), static_cast<bf16*>(qkv), static_cast<bf16*>(ao), batch,
                  n_pad, d, heads, n_valid, scale, st, long_path)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

}  // extern "C"
