// Int8 stats-chain MLP half on Hopper (sm_90a), the int8 stats chain's MLP.
//
// Replaces vit_fpga_tpu/ops/quant_block.py:_mlp_int8_stats_kernel (wrapper
// mlp_block_int8_stats), one Pallas kernel on the TPU.  It is K15
// (mlp_int8.cu) with the LayerNorm statistics taken from the producer half
// and the next half's emitted.  A short sequence of launches on one
// stream, counted as one ported kernel:
//
//   (a) quant_rows<LN_STATS>  xn = ((x - mu) * rstd) * ls + lb with (mu,
//                       rstd) read from the incoming (T, 2) stats (f32 or
//                       bf16), no reduction; its row absmax, sx = absmax /
//                       127, xq = clip(rint(xn / sx))
//   (b) qgemm<EPI_AMAX> h = act(float(xq w1q) * (sx * w1s) + b1) in f32, and
//                       each block's per-row absmax of h over its 128 columns
//   (c) quant_amax      the row absmax of h from those partials, then
//                       hq = clip(rint(h / sh)) over all M columns
//   (d) qgemm<EPI_RESID> out = x + bf16(float(hq w2q) * (sh * w2s) + b2)
//   (e) row_stats       the next half's (mu, rstd) of out's bf16 values,
//                       one-pass, in the incoming stats' dtype; skipped when
//                       stats_out is null (the last layer's MLP half)
//
// What bounds it on the H100: at ViT-B/16 batch 64 (T = 12 800 rows,
// D = 768, M = 3072) the launch does 4·T·D·M = 120.8 G int8 operations
// (61 us at 1979 TOPS) against about 44 MB of compulsory traffic (13 us),
// so it is bound by tensor-core operations, as K15.  Against K15 it trades
// the LN reduction of (a) for a row-stats pass over out (e), which reads
// the 19.7 MB of out once more; on the TPU that pass hid in the tail GEMM's
// epilogue, here it is its own launch (later work: fold it into (d)'s
// epilogue, whose blocks see 128 of out's columns).

#define VFT_NS mlp_int8_stats
#include "common.cuh"
#include "quant.cuh"

using namespace VFT_NS;

namespace {

template <typename ST>
cudaError_t run(const void* x, const void* stats, const void* ls, const void* lb, const void* w1,
                const void* s1, const void* b1, const void* w2, const void* s2, const void* b2,
                void* out, void* stats_out, void* q8, void* s, void* h, void* parts, int t, int d,
                int m, int act, float eps, cudaStream_t st) {
  signed char* q = static_cast<signed char*>(q8);
  float* sc = static_cast<float*>(s);
  cudaError_t err;
  if ((err = launch_quant_rows<bf16, LN_STATS, false, ST>(
           static_cast<const bf16*>(x), static_cast<const float*>(ls),
           static_cast<const float*>(lb), q, sc, t, d, eps, st,
           static_cast<const ST*>(stats))) != cudaSuccess)
    return err;

  QGemmArgs up{};
  up.A = q;
  up.sa = sc;
  up.B = static_cast<const signed char*>(w1);
  up.sb = static_cast<const float*>(s1);
  up.bias = static_cast<const float*>(b1);
  up.C = h;
  up.amax = static_cast<float*>(parts);
  up.M = t;
  up.N = m;
  up.K = d;
  up.act = act;
  if ((err = launch_qgemm<EPI_AMAX>(up, st)) != cudaSuccess) return err;

  if ((err = launch_quant_amax(static_cast<const float*>(h), static_cast<const float*>(parts),
                               qgemm_col_blocks(m), q, sc, t, m, st)) != cudaSuccess)
    return err;

  QGemmArgs down{};
  down.A = q;
  down.sa = sc;
  down.B = static_cast<const signed char*>(w2);
  down.sb = static_cast<const float*>(s2);
  down.bias = static_cast<const float*>(b2);
  down.residual = static_cast<const bf16*>(x);
  down.C = out;
  down.M = t;
  down.N = d;
  down.K = m;
  if ((err = launch_qgemm<EPI_RESID>(down, st)) != cudaSuccess) return err;

  if (stats_out != nullptr &&
      (err = launch_row_stats(static_cast<const bf16*>(out), static_cast<ST*>(stats_out), t, d,
                              eps, st)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Opts this unit's GEMMs in to their shared memory, on the current device.
// Called once per device before the first launch.  Returns a cudaError_t.
int vft_mlp_int8_stats_init() {
  cudaError_t err = qgemm_enable<EPI_AMAX>();
  if (err != cudaSuccess) return err;
  return qgemm_enable<EPI_RESID>();
}

// x, out: (T, D) bf16; stats, stats_out: (T, 2) f32, or bf16 when st_bf16
// (stats_out may be null: no next stats); ls, lb, s2, b2: (D,) f32; w1:
// (M, D) int8 (the (D, M) weight transposed); s1, b1: (M,) f32; w2: (D, M)
// int8 (the (M, D) weight transposed).  Scratch: q8 (T, M) int8 (xq, then
// hq), s (T,) f32 (sx, then sh), h (T, M) f32, parts (ceil(M / 128), T)
// f32.  act is one of ACT_GELU_TANH, ACT_QUICK_GELU, ACT_RELU.  D and M
// multiples of 16.  Everything is enqueued on `stream`, which belongs to
// the current device.  Returns a cudaError_t.
int vft_mlp_block_int8_stats(const void* x, const void* stats, const void* ls, const void* lb,
                             const void* w1, const void* s1, const void* b1, const void* w2,
                             const void* s2, const void* b2, void* out, void* stats_out, void* q8,
                             void* s, void* h, void* parts, int t, int d, int m, int act,
                             int st_bf16, float eps, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return st_bf16 ? run<bf16>(x, stats, ls, lb, w1, s1, b1, w2, s2, b2, out, stats_out, q8, s, h,
                             parts, t, d, m, act, eps, st)
                 : run<float>(x, stats, ls, lb, w1, s1, b1, w2, s2, b2, out, stats_out, q8, s, h,
                              parts, t, d, m, act, eps, st);
}

}  // extern "C"
