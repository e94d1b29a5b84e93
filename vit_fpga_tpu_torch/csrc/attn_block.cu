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
// row_stats followed by K1 without the next stats, one attention kernel
// at every length.  Head dim 64 or 80 (ViT-H/14): the GEMMs take any D, the
// attention core's tiles take either (mha_wgmma.cuh's MwDim).
//
// What bounds it on the H100: at ViT-B/16 batch 64 the launch does 8 R D^2
// + 4 B H n_pad n_valid dh = 68 GFLOP against 44 MB of compulsory traffic,
// so it is bound by tensor-core operations (0.0689 ms at 989 TFLOP/s), as
// K1.  The design is K1's: LN applied to the landed A tiles in shared
// memory, the scores and probabilities in registers; qkv and the attention
// output round-trip through device memory.  The safe mode computes q k^T
// twice (the row max, then e against it, both from the same bits): 2 B H
// n_pad n_valid dh more flops, 3 GFLOP (4%) at ViT-B/16 b64.
//
// In f32 (vft_attn_block_fwd_f32) the same steps run in true f32 fma on
// the CUDA cores: (a) row_stats_f32, (b)-(d) attn_half_f32.cuh's sequence
// (gemm_f32.cuh's GEMMs, seq_attn.cuh's SF_HALF_MAXFREE or SF_ONLINE
// attention, head dim 64 or 80).  Bound there: 68 GFLOP at 67 TFLOP/s
// (1.02 ms) at ViT-B/16 b64; 244 GFLOP (3.6 ms) at ViT-H/14 b64.

#define VFT_NS attn_block
#include "common.cuh"
#include "hopper.cuh"
#include "gemm_wgmma.cuh"
#include "mha_wgmma.cuh"
#include "attn_half.cuh"
#include "gemm_f32.cuh"
#include "seq_attn.cuh"
#include "attn_half_f32.cuh"

using namespace VFT_NS;

extern "C" {

// Finds the driver's tensor-map encoder and opts this unit's kernels in to
// the shared memory they use, on the current device.  Called once per
// device before the first launch.  Returns a cudaError_t.
int vft_attn_block_init() {
  cudaError_t err = attn_half_enable<MW_MAXFREE>();
  if (err != cudaSuccess) return err;
  if ((err = mha_wgmma_enable<MW_SAFE>()) != cudaSuccess) return err;
  if ((err = mha_wgmma_enable<MW_MAXFREE, false, 80>()) != cudaSuccess) return err;
  if ((err = mha_wgmma_enable<MW_SAFE, false, 80>()) != cudaSuccess) return err;
  if ((err = seq_attn_f32_enable<64, SF_HALF_MAXFREE>()) != cudaSuccess) return err;
  if ((err = seq_attn_f32_enable<64, SF_ONLINE>()) != cudaSuccess) return err;
  if ((err = seq_attn_f32_enable<80, SF_HALF_MAXFREE>()) != cudaSuccess) return err;
  return seq_attn_f32_enable<80, SF_ONLINE>();
}

// x, out: (B * n_pad, D) bf16; ls, lb, bo: (D,) f32; wqkv: (D, 3D) bf16;
// bqkv: (3D,) f32; wo: (D, D) bf16.  Scratch: stats (B * n_pad, 2) f32,
// qkv (B * n_pad, 3D) and ao (B * n_pad, D) bf16; every pointer 16-byte
// aligned.  Head dim D / heads 64 or 80, 1 <= n_valid <= n_pad, batch x
// heads <= MW_MAX_GRID_Y; any n_pad (the wrapper takes the JAX attn_block_pallas
// geometry, up to 3137 tokens at ViT-B/16).  safe selects the
// max-subtract softmax.  *long_path is set to 1 when more than 256 keys
// are valid (the same kernels; the launch checks count those launches
// apart) and 0 otherwise.  Everything is enqueued on `stream`, which
// belongs to the current device.  Returns a cudaError_t.
int vft_attn_block_fwd(const void* x, const void* ls, const void* lb, const void* wqkv,
                       const void* bqkv, const void* wo, const void* bo, void* out, void* stats,
                       void* qkv, void* ao, int batch, int n_pad, int d, int heads, int n_valid,
                       int safe, float eps, float scale, void* stream, int* long_path) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (heads < 1 || d % heads || (d / heads != 64 && d / heads != 80) || batch < 1 ||
      n_valid < 1 || n_valid > n_pad || (long long)batch * heads > MW_MAX_GRID_Y)
    return cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  float* stf = static_cast<float*>(stats);
  cudaError_t err;
  if ((err = launch_row_stats(xb, stf, batch * n_pad, d, eps, st)) != cudaSuccess) return err;
  const auto half = d / heads == 80
                        ? (safe ? launch_attn_half<MW_SAFE, 80> : launch_attn_half<MW_MAXFREE, 80>)
                        : (safe ? launch_attn_half<MW_SAFE> : launch_attn_half<MW_MAXFREE>);
  if ((err = half(xb, stf, static_cast<const float*>(ls), static_cast<const float*>(lb),
                  static_cast<const bf16*>(wqkv), static_cast<const float*>(bqkv),
                  static_cast<const bf16*>(wo), static_cast<const float*>(bo),
                  static_cast<bf16*>(out), static_cast<bf16*>(qkv), static_cast<bf16*>(ao), batch,
                  n_pad, d, heads, n_valid, scale, st, long_path)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

// The f32 mode: the same arguments, every tensor f32 (x, out, wqkv, wo, the
// stats / qkv / ao scratch), D a multiple of 4: row_stats_f32 over x, then
// attn_half_f32.cuh's sequence, true f32 fma on the CUDA cores.
int vft_attn_block_fwd_f32(const void* x, const void* ls, const void* lb, const void* wqkv,
                           const void* bqkv, const void* wo, const void* bo, void* out,
                           void* stats, void* qkv, void* ao, int batch, int n_pad, int d,
                           int heads, int n_valid, int safe, float eps, float scale, void* stream,
                           int* long_path) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (heads < 1 || d % heads || (d / heads != 64 && d / heads != 80) || batch < 1 ||
      n_valid < 1 || n_valid > n_pad)
    return cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  float* stf = static_cast<float*>(stats);
  cudaError_t err;
  if ((err = launch_row_stats_f32(xf, stf, batch * n_pad, d, eps, st)) != cudaSuccess) return err;
  const auto half =
      d / heads == 80
          ? (safe ? launch_attn_half_f32<80, SF_ONLINE> : launch_attn_half_f32<80, SF_HALF_MAXFREE>)
          : (safe ? launch_attn_half_f32<64, SF_ONLINE> : launch_attn_half_f32<64, SF_HALF_MAXFREE>);
  if ((err = half(xf, stf, static_cast<const float*>(ls), static_cast<const float*>(lb),
                  static_cast<const float*>(wqkv), static_cast<const float*>(bqkv),
                  static_cast<const float*>(wo), static_cast<const float*>(bo),
                  static_cast<float*>(out), static_cast<float*>(qkv), static_cast<float*>(ao),
                  batch, n_pad, d, heads, n_valid, scale, st, long_path)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

}  // extern "C"
