// Calibrated static-scale int8 attention half on Hopper (sm_90a), the
// static int8 serving path's attention.
//
// Replaces vit_fpga_tpu/ops/quant_block.py:_attn_int8_static_kernel
// (wrapper attn_block_int8_static), one Pallas kernel on the TPU.  The
// calibrated scales arrive folded into the arguments
// (models/quantized.quantize_vit_static): ls, lb carry 1/a_x, sqkv
// carries a_x, so carries a_ao, and out_scale = 1/a_ao rides the
// attention's post-PV reciprocal.  Four launches on one stream, counted as
// one ported kernel:
//
//   (a) quant_rows<LN_ONE_PASS, STATIC>  xq = clip(rint(LN(x)), -127, 127)
//   (b) qgemm<EPI_PLAIN> qkv = bf16(float(xq wqkvq) * sqkv + bqkv)
//   (c) attn_kernel<false, true>  K1's attention tile (attn.cuh): per
//                        (image, head), s = (q k^T) * scale in f32, keys at
//                        or past n_valid masked, e = exp(clip(s, -70, 80)),
//                        r = (1 / sum(e)) * out_scale, aoq = clip(rint(
//                        bf16((bf16(e) @ v) * r))): ao is rounded to bf16 in
//                        the quant domain, as the TPU kernel's bf16 scratch
//                        does, and emitted as int8
//   (d) qgemm<EPI_RESID> out = x + bf16(float(aoq woq) * so + bo), the row
//                        scale 1.0 (exact: 1.0f * so == so)
//
// What bounds it on the H100: at ViT-B/16 batch 64 (R = 12 800 rows,
// D = 768, 12 heads of 64, n_valid 197) 8·R·D² = 60.4 G int8 operations
// (31 us at 1979 TOPS) plus 4·B·H·n_pad·n_valid·dh = 7.8 GFLOP of bf16
// attention (8 us at 989 TFLOP/s) against about 42 MB of compulsory
// traffic (13 us): bound by tensor-core operations, about 38 us, as K16.
// Against K16 (attn_int8.cu) the static scale removes the ao row pass: the
// attention tile writes int8 aoq (9.8 MB at b64) where K16 writes bf16 ao
// and reads it back for its row absmax.

#define VFT_NS attn_int8_static
#include "common.cuh"
#include "attn.cuh"
#include "quant.cuh"

using namespace VFT_NS;

extern "C" {

// Opts this unit's kernels in to the shared memory they may use, on the
// current device.  Called once per device before the first launch.
// Returns a cudaError_t.
int vft_attn_int8_static_init() {
  cudaError_t err = qgemm_enable<EPI_PLAIN>();
  if (err != cudaSuccess) return err;
  if ((err = qgemm_enable<EPI_RESID>()) != cudaSuccess) return err;
  return attn_enable<false, true>();
}

// x, out: (B * n_pad, D) bf16; ls, lb, so, bo: (D,) f32; wqkv: (3D, D) int8
// (the (D, 3D) weight transposed); sqkv, bqkv: (3D,) f32; wo: (D, D) int8
// (transposed).  Scratch: q8 (B * n_pad, D) int8 (xq, then aoq), qkv
// (B * n_pad, 3D) bf16.  Head dim 64, 1 <= n_valid <= min(n_pad, 256);
// out_scale the static attention-output scale 1/a_ao.  Everything is
// enqueued on `stream`, which belongs to the current device.  Returns a
// cudaError_t.
int vft_attn_block_int8_static(const void* x, const void* ls, const void* lb, const void* wqkv,
                               const void* sqkv, const void* bqkv, const void* wo, const void* so,
                               const void* bo, void* out, void* q8, void* qkv, int batch,
                               int n_pad, int d, int heads, int n_valid, float eps, float scale,
                               float out_scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int rows = batch * n_pad;
  const int kvp = (n_valid + 15) / 16 * 16;
  if (d != heads * ATT_DH || n_valid < 1 || n_valid > n_pad || kvp > ATT_MAX_KV)
    return cudaErrorInvalidValue;
  signed char* q = static_cast<signed char*>(q8);
  cudaError_t err;
  if ((err = launch_quant_rows<bf16, LN_ONE_PASS, true>(
           static_cast<const bf16*>(x), static_cast<const float*>(ls),
           static_cast<const float*>(lb), q, nullptr, rows, d, eps, st)) != cudaSuccess)
    return err;

  QGemmArgs g{};
  g.A = q;
  g.B = static_cast<const signed char*>(wqkv);
  g.sb = static_cast<const float*>(sqkv);
  g.bias = static_cast<const float*>(bqkv);
  g.C = qkv;
  g.M = rows;
  g.N = 3 * d;
  g.K = d;
  if ((err = launch_qgemm<EPI_PLAIN>(g, st)) != cudaSuccess) return err;

  if ((err = launch_attn<false, true>(static_cast<const bf16*>(qkv), nullptr, batch, n_pad,
                                      n_valid, kvp, d, heads, scale, st, q, out_scale)) !=
      cudaSuccess)
    return err;

  QGemmArgs o{};
  o.A = q;
  o.B = static_cast<const signed char*>(wo);
  o.sb = static_cast<const float*>(so);
  o.bias = static_cast<const float*>(bo);
  o.residual = static_cast<const bf16*>(x);
  o.C = out;
  o.M = rows;
  o.N = d;
  o.K = d;
  if ((err = launch_qgemm<EPI_RESID>(o, st)) != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
