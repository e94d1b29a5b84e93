// Int8-projection attention half on Hopper (sm_90a), the dynamic int8
// serving path's attention.
//
// Replaces vit_fpga_tpu/ops/quant_block.py:_attn_int8_kernel (wrapper
// attn_block_int8), one Pallas kernel on the TPU.  A short sequence of
// launches on one stream, counted as one ported kernel: the int8 instance
// of attn_half.cuh's sequence, its two GEMMs on qgemm_wgmma.cuh's int8
// wgmma + TMA kernel with dequantizing epilogues and its attention on
// mha_wgmma.cuh's:
//
//   (a) quant_rows<LN_ONE_PASS>  xn = LN(x) (one-pass, _ln_f32), row absmax,
//                   sx = absmax / 127, xq = clip(rint(xn / sx))
//   (b) QW_BF16     qkv = bf16(float(xq wqkvq) * (sx * wqkvs) + bqkv), by TMA
//   (c) MW_MAXFREE  per (128 query rows, image x head) over 128-key tiles,
//                   at head dim 64 or 80 (ViT-H/14; mha_wgmma.cuh's MwDim),
//                   s = (q k^T) * scale in f32, keys at or past n_valid
//                   masked (TMA zero-fills them, the last tile sets e = 0),
//                   e = exp(clip(s, -70, 80)), ao = bf16((bf16(e) @ v) *
//                   (1 / sum(e))): the TPU kernel's max-free _mha_loop
//   (d) quant_rows<LN_NONE>  the row absmax of f32(ao) over all D columns
//                   (every head), sa = absmax / 127, aoq
//   (e) QW_RESID    out = x + bf16(float(aoq woq) * (sa * wos) + bo), by TMA
//
// Rounding follows quant.cuh and the plain version: IEEE operations in its
// order, rint half to even, the clip at +-127, the absmax floored at 1e-12;
// the attention's e comes from ex2.approx (mha_wgmma.cuh: within ~5e-6
// relative of expf, so bf16(e) flips on rare elements only).
//
// What bounds it on the H100: at ViT-B/16 batch 64 (R = 12 800 rows,
// D = 768, 12 heads of 64, n_valid 197) the launch does 8·R·D² = 60.4 G
// int8 operations (31 us at 1979 TOPS) plus 4·B·H·n_pad·n_valid·dh =
// 7.8 GFLOP of bf16 attention (8 us at 989 TFLOP/s) against about 42 MB of
// compulsory traffic (13 us): bound by tensor-core operations, about
// 38 us.  ao's scale spans all 12 heads while an attention block sees one:
// ao round-trips through device memory in bf16 (as in K1) and a row pass
// takes its absmax before the out-projection; xq, qkv and aoq round-trip
// too (59 MB of bf16 qkv at b64).  The keys stream through the attention's
// ring, so nothing bounds the length but the grid (batch x heads <=
// MW_MAX_GRID_Y); the wrapper's gate is the JAX planner's
// (ops/quant_block.attn_int8_geometry), up to 3137 tokens at ViT-B/16.

#define VFT_NS attn_int8
#include "common.cuh"
#include "quant.cuh"
#include "hopper.cuh"
#include "qgemm_wgmma.cuh"
#include "mha_wgmma.cuh"

using namespace VFT_NS;

extern "C" {

// Finds cuTensorMapEncodeTiled (tma_init) and opts the GEMM's epilogues and
// the max-free attention in to their shared memory, on the current device.
// Called once per device before the first launch.  Returns a cudaError_t.
int vft_attn_int8_init() {
  cudaError_t err = tma_init();
  if (err != cudaSuccess) return err;
  if ((err = qgemm_epi_enable<QW_BF16>()) != cudaSuccess) return err;
  if ((err = qgemm_epi_enable<QW_RESID>()) != cudaSuccess) return err;
  if ((err = mha_wgmma_enable<MW_MAXFREE>()) != cudaSuccess) return err;
  return mha_wgmma_enable<MW_MAXFREE, false, 80>();
}

// x, out: (B * n_pad, D) bf16; ls, lb, so, bo: (D,) f32; wqkv: (3D, D) int8
// (the (D, 3D) weight transposed); sqkv, bqkv: (3D,) f32; wo: (D, D) int8
// (transposed).  Scratch: q8 (B * n_pad, D) int8 (xq, then aoq), s
// (B * n_pad,) f32 (sx, then sa), qkv (B * n_pad, 3D) and ao (B * n_pad, D)
// bf16; every tensor 16-byte aligned.  Head dim 64 or 80, 1 <= n_valid <= n_pad,
// batch x heads <= MW_MAX_GRID_Y.  Everything is enqueued on `stream`,
// which belongs to the current device.  Returns a cudaError_t.
int vft_attn_block_int8(const void* x, const void* ls, const void* lb, const void* wqkv,
                        const void* sqkv, const void* bqkv, const void* wo, const void* so,
                        const void* bo, void* out, void* q8, void* s, void* qkv, void* ao,
                        int batch, int n_pad, int d, int heads, int n_valid, float eps,
                        float scale, void* stream) {
  if (heads < 1 || d % heads || (d / heads != 64 && d / heads != 80) || batch < 1 ||
      n_valid < 1 || n_valid > n_pad || (long long)batch * heads > MW_MAX_GRID_Y)
    return cudaErrorInvalidValue;
  if (tma_encoder() == nullptr) return cudaErrorInitializationError;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int rows = batch * n_pad;
  signed char* q = static_cast<signed char*>(q8);
  float* sc = static_cast<float*>(s);
  bf16* qkvb = static_cast<bf16*>(qkv);
  bf16* aob = static_cast<bf16*>(ao);
  cudaError_t err;
  if ((err = launch_quant_rows<bf16, LN_ONE_PASS>(static_cast<const bf16*>(x),
                                                  static_cast<const float*>(ls),
                                                  static_cast<const float*>(lb), q, sc, rows, d,
                                                  eps, st)) != cudaSuccess)
    return err;

  QwArgs g{};
  g.M = rows;
  g.N = 3 * d;
  g.K = d;
  g.sa = sc;
  g.sb = static_cast<const float*>(sqkv);
  g.bias = static_cast<const float*>(bqkv);
  if ((err = launch_qgemm_epi<QW_BF16>(q, static_cast<const signed char*>(wqkv), qkvb, g, st)) !=
      cudaSuccess)
    return err;

  err = d / heads == 80 ? launch_mha_packed<MW_MAXFREE, false, 80>(qkvb, aob, batch, n_pad, d,
                                                                    heads, n_valid, scale, st)
                        : launch_mha_packed<MW_MAXFREE>(qkvb, aob, batch, n_pad, d, heads, n_valid,
                                                        scale, st);
  if (err != cudaSuccess)
    return err;

  if ((err = launch_quant_rows<bf16, LN_NONE>(aob, nullptr, nullptr, q, sc, rows, d, 0.0f, st)) !=
      cudaSuccess)
    return err;

  QwArgs o{};
  o.M = rows;
  o.N = d;
  o.K = d;
  o.sa = sc;
  o.sb = static_cast<const float*>(so);
  o.bias = static_cast<const float*>(bo);
  o.residual = static_cast<const bf16*>(x);
  if ((err = launch_qgemm_epi<QW_RESID>(q, static_cast<const signed char*>(wo), out, o, st)) !=
      cudaSuccess)
    return err;
  return cudaGetLastError();
}

}  // extern "C"
