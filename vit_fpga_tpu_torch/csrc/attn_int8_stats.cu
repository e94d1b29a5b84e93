// Int8 stats-chain attention half on Hopper (sm_90a), the int8 stats
// chain's attention.
//
// Replaces vit_fpga_tpu/ops/quant_block.py:_attn_int8_stats_kernel (wrapper
// attn_block_int8_stats), one Pallas kernel on the TPU.  It is K16
// (attn_int8.cu) with the LayerNorm statistics taken from the producer half
// and the next half's emitted: K16's launches, its two GEMMs on
// qgemm_wgmma.cuh's int8 wgmma + TMA kernel with dequantizing epilogues and
// its attention on mha_wgmma.cuh's max-free sweep, counted as one ported
// kernel:
//
//   (a) quant_rows<LN_STATS>  xn = ((x - mu) * rstd) * ls + lb with (mu,
//                   rstd) read from the incoming (B * n_pad, 2) stats (f32
//                   or bf16), no reduction; row absmax, sx = absmax / 127,
//                   xq = clip(rint(xn / sx))
//   (b) QW_BF16     qkv = bf16(float(xq wqkvq) * (sx * wqkvs) + bqkv), by TMA
//   (c) MW_MAXFREE  per (128 query rows, image x head) over 128-key tiles,
//                   keys at or past n_valid masked (TMA zero-fills them, the
//                   last tile sets e = 0), e = exp(clip(s, -70, 80)), ao =
//                   bf16((bf16(e) @ v) * (1 / sum(e)))
//   (d) quant_rows<LN_NONE>  the row absmax of f32(ao) over all D columns,
//                   sa = absmax / 127, aoq
//   (e) QW_RESID    out = x + bf16(float(aoq woq) * (sa * wos) + bo), by TMA
//   (f) row_stats   the MLP half's (mu, rstd) of out's bf16 values,
//                   one-pass, in the incoming stats' dtype; skipped when
//                   stats_out is null
//
// Rounding follows quant.cuh and the plain version, as K16's.
//
// What bounds it on the H100: at ViT-B/16 batch 64 (R = 12 800 rows,
// D = 768, 12 heads of 64, n_valid 197) 8·R·D² = 60.4 G int8 operations
// (31 us at 1979 TOPS) plus 4·B·H·n_pad·n_valid·dh = 7.8 GFLOP of bf16
// attention (8 us at 989 TFLOP/s) against about 42 MB of compulsory
// traffic (13 us): bound by tensor-core operations, about 38 us, as K16.
// Against K16 the LN reduction of (a) gives way to the stats pass (f),
// which reads out once more (19.7 MB at b64).  The keys stream through the
// attention's ring, so nothing bounds the length but the grid (batch x
// heads <= MW_MAX_GRID_Y); the wrapper's gate is K16's, the JAX planner's,
// with the JAX wrapper's refusal of q-slot reuse.

#define VFT_NS attn_int8_stats
#include "common.cuh"
#include "quant.cuh"
#include "hopper.cuh"
#include "qgemm_wgmma.cuh"
#include "mha_wgmma.cuh"

using namespace VFT_NS;

namespace {

template <typename ST>
cudaError_t run(const void* x, const void* stats, const void* ls, const void* lb,
                const void* wqkv, const void* sqkv, const void* bqkv, const void* wo,
                const void* so, const void* bo, void* out, void* stats_out, void* q8, void* s,
                void* qkv, void* ao, int batch, int n_pad, int d, int heads, int n_valid,
                float eps, float scale, cudaStream_t st) {
  const int rows = batch * n_pad;
  signed char* q = static_cast<signed char*>(q8);
  float* sc = static_cast<float*>(s);
  bf16* qkvb = static_cast<bf16*>(qkv);
  bf16* aob = static_cast<bf16*>(ao);
  cudaError_t err;
  if ((err = launch_quant_rows<bf16, LN_STATS, false, ST>(
           static_cast<const bf16*>(x), static_cast<const float*>(ls),
           static_cast<const float*>(lb), q, sc, rows, d, eps, st,
           static_cast<const ST*>(stats))) != cudaSuccess)
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

  if ((err = launch_mha_packed<MW_MAXFREE>(qkvb, aob, batch, n_pad, d, heads, n_valid, scale,
                                           st)) != cudaSuccess)
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

  if (stats_out != nullptr &&
      (err = launch_row_stats(static_cast<const bf16*>(out), static_cast<ST*>(stats_out), rows, d,
                              eps, st)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Finds cuTensorMapEncodeTiled (tma_init) and opts the GEMM's epilogues and
// the max-free attention in to their shared memory, on the current device.
// Called once per device before the first launch.  Returns a cudaError_t.
int vft_attn_int8_stats_init() {
  cudaError_t err = tma_init();
  if (err != cudaSuccess) return err;
  if ((err = qgemm_epi_enable<QW_BF16>()) != cudaSuccess) return err;
  if ((err = qgemm_epi_enable<QW_RESID>()) != cudaSuccess) return err;
  return mha_wgmma_enable<MW_MAXFREE>();
}

// x, out: (B * n_pad, D) bf16; stats, stats_out: (B * n_pad, 2) f32, or
// bf16 when st_bf16 (stats_out may be null: no next stats); ls, lb, so, bo:
// (D,) f32; wqkv: (3D, D) int8 (the (D, 3D) weight transposed); sqkv,
// bqkv: (3D,) f32; wo: (D, D) int8 (transposed).  Scratch: q8
// (B * n_pad, D) int8 (xq, then aoq), s (B * n_pad,) f32 (sx, then sa),
// qkv (B * n_pad, 3D) and ao (B * n_pad, D) bf16; every tensor 16-byte
// aligned.  Head dim 64, 1 <= n_valid <= n_pad, batch x heads <=
// MW_MAX_GRID_Y.  Everything is enqueued on `stream`, which belongs to the
// current device.  Returns a cudaError_t.
int vft_attn_block_int8_stats(const void* x, const void* stats, const void* ls, const void* lb,
                              const void* wqkv, const void* sqkv, const void* bqkv,
                              const void* wo, const void* so, const void* bo, void* out,
                              void* stats_out, void* q8, void* s, void* qkv, void* ao, int batch,
                              int n_pad, int d, int heads, int n_valid, int st_bf16, float eps,
                              float scale, void* stream) {
  if (heads < 1 || d != heads * MW_DH || batch < 1 || n_valid < 1 || n_valid > n_pad ||
      (long long)batch * heads > MW_MAX_GRID_Y)
    return cudaErrorInvalidValue;
  if (tma_encoder() == nullptr) return cudaErrorInitializationError;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return st_bf16 ? run<bf16>(x, stats, ls, lb, wqkv, sqkv, bqkv, wo, so, bo, out, stats_out, q8,
                             s, qkv, ao, batch, n_pad, d, heads, n_valid, eps, scale, st)
                 : run<float>(x, stats, ls, lb, wqkv, sqkv, bqkv, wo, so, bo, out, stats_out, q8,
                              s, qkv, ao, batch, n_pad, d, heads, n_valid, eps, scale, st);
}

}  // extern "C"
