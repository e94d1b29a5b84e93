// Calibrated static-scale int8 attention half on Hopper (sm_90a), the
// static int8 serving path's attention.
//
// Replaces vit_fpga_tpu/ops/quant_block.py:_attn_int8_static_kernel
// (wrapper attn_block_int8_static), one Pallas kernel on the TPU.  The
// calibrated scales arrive folded into the arguments
// (models/quantized.quantize_vit_static): ls, lb carry 1/a_x, sqkv
// carries a_x, so carries a_ao, and out_scale = 1/a_ao rides the
// attention's post-PV reciprocal.  K16's launch sequence (attn_int8.cu)
// without its ao row pass, its two GEMMs on qgemm_wgmma.cuh's int8 wgmma +
// TMA kernel and its attention on mha_wgmma.cuh's; four launches on one
// stream, counted as one ported kernel:
//
//   (a) quant_rows<LN_ONE_PASS, STATIC>  xq = clip(rint(LN(x)), -127, 127)
//   (b) QW_BF16     qkv = bf16(float(xq wqkvq) * sqkv + bqkv), by TMA, the
//                   row scale 1.0 (a null sa: exact, 1.0f * sqkv == sqkv)
//   (c) MW_MAXFREE, Q8  per (128 query rows, image x head) over 128-key
//                   tiles, s = (q k^T) * scale in f32, keys at or past
//                   n_valid masked (TMA zero-fills them, the last tile sets
//                   e = 0), e = exp(clip(s, -70, 80)), r = (1 / sum(e)) *
//                   out_scale, aoq = clip(rint(bf16((bf16(e) @ v) * r))): ao
//                   is rounded to bf16 in the quant domain, as the TPU
//                   kernel's bf16 scratch does, and emitted as int8; at
//                   head dim 64 or 80 (ViT-H/14; mha_wgmma.cuh's MwDim)
//   (d) QW_RESID    out = x + bf16(float(aoq woq) * so + bo), by TMA, the row
//                   scale 1.0
//
// What bounds it on the H100: at ViT-B/16 batch 64 (R = 12 800 rows,
// D = 768, 12 heads of 64, n_valid 197) 8·R·D² = 60.4 G int8 operations
// (31 us at 1979 TOPS) plus 4·B·H·n_pad·n_valid·dh = 7.8 GFLOP of bf16
// attention (8 us at 989 TFLOP/s) against about 42 MB of compulsory
// traffic (13 us): bound by tensor-core operations, about 38 us, as K16.
// Against K16 the static scale removes the ao row pass: the attention
// writes int8 aoq (9.8 MB at b64) where K16 writes bf16 ao and reads it
// back for its row absmax.  The keys stream through the attention's ring,
// so nothing bounds the length but the grid (batch x heads <=
// MW_MAX_GRID_Y); the wrapper's gate is K16's, the JAX planner's.

#define VFT_NS attn_int8_static
#include "common.cuh"
#include "quant.cuh"
#include "hopper.cuh"
#include "qgemm_wgmma.cuh"
#include "mha_wgmma.cuh"

using namespace VFT_NS;

extern "C" {

// Finds cuTensorMapEncodeTiled (tma_init) and opts the GEMM's epilogues and
// the max-free attention with its int8 output in to their shared memory,
// on the current device.  Called once per device before the first launch.
// Returns a cudaError_t.
int vft_attn_int8_static_init() {
  cudaError_t err = tma_init();
  if (err != cudaSuccess) return err;
  if ((err = qgemm_epi_enable<QW_BF16>()) != cudaSuccess) return err;
  if ((err = qgemm_epi_enable<QW_RESID>()) != cudaSuccess) return err;
  if ((err = mha_wgmma_enable<MW_MAXFREE, true>()) != cudaSuccess) return err;
  return mha_wgmma_enable<MW_MAXFREE, true, 80>();
}

// x, out: (B * n_pad, D) bf16; ls, lb, so, bo: (D,) f32; wqkv: (3D, D) int8
// (the (D, 3D) weight transposed); sqkv, bqkv: (3D,) f32; wo: (D, D) int8
// (transposed).  Scratch: q8 (B * n_pad, D) int8 (xq, then aoq), qkv
// (B * n_pad, 3D) bf16; every tensor 16-byte aligned.  Head dim 64 or
// 80, 1 <= n_valid <= n_pad, batch x heads <= MW_MAX_GRID_Y; out_scale the
// static attention-output scale 1/a_ao.  Everything is enqueued on
// `stream`, which belongs to the current device.  Returns a cudaError_t.
int vft_attn_block_int8_static(const void* x, const void* ls, const void* lb, const void* wqkv,
                               const void* sqkv, const void* bqkv, const void* wo, const void* so,
                               const void* bo, void* out, void* q8, void* qkv, int batch,
                               int n_pad, int d, int heads, int n_valid, float eps, float scale,
                               float out_scale, void* stream) {
  if (heads < 1 || d % heads || (d / heads != 64 && d / heads != 80) || batch < 1 ||
      n_valid < 1 || n_valid > n_pad || (long long)batch * heads > MW_MAX_GRID_Y)
    return cudaErrorInvalidValue;
  if (tma_encoder() == nullptr) return cudaErrorInitializationError;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int rows = batch * n_pad;
  signed char* q = static_cast<signed char*>(q8);
  bf16* qkvb = static_cast<bf16*>(qkv);
  cudaError_t err;
  if ((err = launch_quant_rows<bf16, LN_ONE_PASS, true>(
           static_cast<const bf16*>(x), static_cast<const float*>(ls),
           static_cast<const float*>(lb), q, nullptr, rows, d, eps, st)) != cudaSuccess)
    return err;

  QwArgs g{};
  g.M = rows;
  g.N = 3 * d;
  g.K = d;
  g.sb = static_cast<const float*>(sqkv);
  g.bias = static_cast<const float*>(bqkv);
  if ((err = launch_qgemm_epi<QW_BF16>(q, static_cast<const signed char*>(wqkv), qkvb, g, st)) !=
      cudaSuccess)
    return err;

  err = d / heads == 80
            ? launch_mha_packed<MW_MAXFREE, true, 80>(qkvb, q, batch, n_pad, d, heads, n_valid,
                                                      scale, st, out_scale)
            : launch_mha_packed<MW_MAXFREE, true>(qkvb, q, batch, n_pad, d, heads, n_valid, scale,
                                                  st, out_scale);
  if (err != cudaSuccess)
    return err;

  QwArgs o{};
  o.M = rows;
  o.N = d;
  o.K = d;
  o.sb = static_cast<const float*>(so);
  o.bias = static_cast<const float*>(bo);
  o.residual = static_cast<const bf16*>(x);
  if ((err = launch_qgemm_epi<QW_RESID>(q, static_cast<const signed char*>(wo), out, o, st)) !=
      cudaSuccess)
    return err;
  return cudaGetLastError();
}

}  // extern "C"
