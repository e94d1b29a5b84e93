// Int8 stats-chain attention half on Hopper (sm_90a), the int8 stats
// chain's attention.
//
// Replaces vit_fpga_tpu/ops/quant_block.py:_attn_int8_stats_kernel (wrapper
// attn_block_int8_stats), one Pallas kernel on the TPU.  It is K16's
// function (attn_int8.cu) with the LayerNorm statistics taken from the
// producer half and the next half's emitted, still on K16's first design
// (quant.cuh's wmma GEMM, attn.cuh's tile: up to 256 keys; K16 itself runs
// on qgemm_wgmma.cuh and mha_wgmma.cuh).  A short sequence of launches on
// one stream, counted as one ported kernel:
//
//   (a) quant_rows<LN_STATS>  xn = ((x - mu) * rstd) * ls + lb with (mu,
//                        rstd) read from the incoming (B * n_pad, 2) stats
//                        (f32 or bf16), no reduction; row absmax, sx =
//                        absmax / 127, xq = clip(rint(xn / sx))
//   (b) qgemm<EPI_PLAIN> qkv = bf16(float(xq wqkvq) * (sx * wqkvs) + bqkv)
//   (c) attn_kernel        the max-free attention tile (attn.cuh): keys at
//                        or past n_valid masked, e = exp(clip(s, -70, 80)),
//                        ao = bf16((bf16(e) @ v) * (1 / sum(e)))
//   (d) quant_rows<LN_NONE>  the row absmax of f32(ao) over all D columns,
//                        sa = absmax / 127, aoq
//   (e) qgemm<EPI_RESID> out = x + bf16(float(aoq woq) * (sa * wos) + bo)
//   (f) row_stats        the MLP half's (mu, rstd) of out's bf16 values,
//                        one-pass, in the incoming stats' dtype
//
// What bounds it on the H100: at ViT-B/16 batch 64 (R = 12 800 rows,
// D = 768, 12 heads of 64, n_valid 197) 8·R·D² = 60.4 G int8 operations
// (31 us at 1979 TOPS) plus 4·B·H·n_pad·n_valid·dh = 7.8 GFLOP of bf16
// attention (8 us at 989 TFLOP/s) against about 42 MB of compulsory
// traffic (13 us): bound by tensor-core operations, about 38 us, as K16.
// Against K16 the LN reduction of (a) gives way to the stats pass (f),
// which reads out once more (19.7 MB at b64).

#define VFT_NS attn_int8_stats
#include "common.cuh"
#include "attn.cuh"
#include "quant.cuh"

using namespace VFT_NS;

namespace {

template <typename ST>
cudaError_t run(const void* x, const void* stats, const void* ls, const void* lb,
                const void* wqkv, const void* sqkv, const void* bqkv, const void* wo,
                const void* so, const void* bo, void* out, void* stats_out, void* q8, void* s,
                void* qkv, void* ao, int batch, int n_pad, int d, int heads, int n_valid, int kvp,
                float eps, float scale, cudaStream_t st) {
  const int rows = batch * n_pad;
  signed char* q = static_cast<signed char*>(q8);
  float* sc = static_cast<float*>(s);
  cudaError_t err;
  if ((err = launch_quant_rows<bf16, LN_STATS, false, ST>(
           static_cast<const bf16*>(x), static_cast<const float*>(ls),
           static_cast<const float*>(lb), q, sc, rows, d, eps, st,
           static_cast<const ST*>(stats))) != cudaSuccess)
    return err;

  QGemmArgs g{};
  g.A = q;
  g.sa = sc;
  g.B = static_cast<const signed char*>(wqkv);
  g.sb = static_cast<const float*>(sqkv);
  g.bias = static_cast<const float*>(bqkv);
  g.C = qkv;
  g.M = rows;
  g.N = 3 * d;
  g.K = d;
  if ((err = launch_qgemm<EPI_PLAIN>(g, st)) != cudaSuccess) return err;

  if ((err = launch_attn(static_cast<const bf16*>(qkv), static_cast<bf16*>(ao), batch,
                                n_pad, n_valid, kvp, d, heads, scale, st)) != cudaSuccess)
    return err;

  if ((err = launch_quant_rows<bf16, LN_NONE>(static_cast<const bf16*>(ao), nullptr, nullptr, q,
                                              sc, rows, d, 0.0f, st)) != cudaSuccess)
    return err;

  QGemmArgs o{};
  o.A = q;
  o.sa = sc;
  o.B = static_cast<const signed char*>(wo);
  o.sb = static_cast<const float*>(so);
  o.bias = static_cast<const float*>(bo);
  o.residual = static_cast<const bf16*>(x);
  o.C = out;
  o.M = rows;
  o.N = d;
  o.K = d;
  if ((err = launch_qgemm<EPI_RESID>(o, st)) != cudaSuccess) return err;

  if (stats_out != nullptr &&
      (err = launch_row_stats(static_cast<const bf16*>(out), static_cast<ST*>(stats_out), rows, d,
                              eps, st)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Opts this unit's kernels in to the shared memory they may use, on the
// current device.  Called once per device before the first launch.
// Returns a cudaError_t.
int vft_attn_int8_stats_init() {
  cudaError_t err = qgemm_enable<EPI_PLAIN>();
  if (err != cudaSuccess) return err;
  if ((err = qgemm_enable<EPI_RESID>()) != cudaSuccess) return err;
  return attn_enable();
}

// x, out: (B * n_pad, D) bf16; stats, stats_out: (B * n_pad, 2) f32, or
// bf16 when st_bf16 (stats_out may be null: no next stats); ls, lb, so, bo:
// (D,) f32; wqkv: (3D, D) int8 (the (D, 3D) weight transposed); sqkv,
// bqkv: (3D,) f32; wo: (D, D) int8 (transposed).  Scratch: q8
// (B * n_pad, D) int8 (xq, then aoq), s (B * n_pad,) f32 (sx, then sa),
// qkv (B * n_pad, 3D) and ao (B * n_pad, D) bf16.  Head dim 64,
// 1 <= n_valid <= min(n_pad, 256).  Everything is enqueued on `stream`,
// which belongs to the current device.  Returns a cudaError_t.
int vft_attn_block_int8_stats(const void* x, const void* stats, const void* ls, const void* lb,
                              const void* wqkv, const void* sqkv, const void* bqkv,
                              const void* wo, const void* so, const void* bo, void* out,
                              void* stats_out, void* q8, void* s, void* qkv, void* ao, int batch,
                              int n_pad, int d, int heads, int n_valid, int st_bf16, float eps,
                              float scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int kvp = (n_valid + 15) / 16 * 16;
  if (d != heads * ATT_DH || n_valid < 1 || n_valid > n_pad || kvp > ATT_MAX_KV)
    return cudaErrorInvalidValue;
  return st_bf16 ? run<bf16>(x, stats, ls, lb, wqkv, sqkv, bqkv, wo, so, bo, out, stats_out, q8,
                             s, qkv, ao, batch, n_pad, d, heads, n_valid, kvp, eps, scale, st)
                 : run<float>(x, stats, ls, lb, wqkv, sqkv, bqkv, wo, so, bo, out, stats_out, q8,
                              s, qkv, ao, batch, n_pad, d, heads, n_valid, kvp, eps, scale, st);
}

}  // extern "C"
