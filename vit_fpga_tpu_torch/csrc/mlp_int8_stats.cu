// Int8 stats-chain MLP half on Hopper (sm_90a), the int8 stats chain's MLP.
//
// Replaces vit_fpga_tpu/ops/quant_block.py:_mlp_int8_stats_kernel (wrapper
// mlp_block_int8_stats), one Pallas kernel on the TPU.  It is K15
// (mlp_int8.cu) with the LayerNorm statistics taken from the producer half
// and the next half's emitted: K15's launches, its two GEMMs on
// qgemm_wgmma.cuh's int8 wgmma + TMA kernel with dequantizing epilogues,
// counted as one ported kernel:
//
//   (a) quant_rows<LN_STATS>  xn = ((x - mu) * rstd) * ls + lb with (mu,
//                  rstd) read from the incoming (T, 2) stats (f32 or bf16),
//                  no reduction; its row absmax, sx = absmax / 127, xq =
//                  clip(rint(xn / sx))
//   (b) QW_H       h = act(float(xq w1q) * (sx * w1s) + b1) in f32, stored by
//                  TMA, and each tile's row absmax of h over its columns
//   (c) quant_amax the row absmax of h from the tiles' maxima, sh = absmax
//                  / 127, hq = clip(rint(h / sh)) over all M columns
//   (d) QW_RESID   out = x + bf16(float(hq w2q) * (sh * w2s) + b2)
//   (e) row_stats  the next half's (mu, rstd) of out's bf16 values,
//                  one-pass, in the incoming stats' dtype; skipped when
//                  stats_out is null (the last layer's MLP half)
//
// Rounding follows quant.cuh and the plain version, as K15's.
//
// What bounds it on the H100: at ViT-B/16 batch 64 (T = 12 800 rows,
// D = 768, M = 3072) the launch does 4·T·D·M = 120.8 G int8 operations
// (61 us at 1979 TOPS) against about 44 MB of compulsory traffic (13 us),
// so it is bound by tensor-core operations, as K15, whose design it takes
// (mlp_int8.cu: f32 h through device memory, W1's epilogue arithmetic
// sets W1's pace).  Against K15 it trades the LN reduction of (a) for a
// row-stats pass over out (e), which reads the 19.7 MB of out once more;
// on the TPU that pass hid in the tail GEMM's epilogue, here it is its own
// launch (later work: fold it into (d)'s epilogue, whose tiles see 128 of
// out's columns, at the cost of another order of the sums).

#define VFT_NS mlp_int8_stats
#include "common.cuh"
#include "quant.cuh"
#include "hopper.cuh"
#include "qgemm_wgmma.cuh"

using namespace VFT_NS;

namespace {

template <typename ST>
cudaError_t run(const void* x, const void* stats, const void* ls, const void* lb, const void* w1,
                const void* s1, const void* b1, const void* w2, const void* s2, const void* b2,
                void* out, void* stats_out, signed char* xq, float* sx, signed char* hq,
                float* sh, void* h, float* parts, int t, int d, int m, int nparts, int act,
                float eps, cudaStream_t st) {
  cudaError_t err;
  if ((err = launch_quant_rows<bf16, LN_STATS, false, ST>(
           static_cast<const bf16*>(x), static_cast<const float*>(ls),
           static_cast<const float*>(lb), xq, sx, t, d, eps, st,
           static_cast<const ST*>(stats))) != cudaSuccess)
    return err;

  QwArgs up{};
  up.M = t;
  up.N = m;
  up.K = d;
  up.sa = sx;
  up.sb = static_cast<const float*>(s1);
  up.bias = static_cast<const float*>(b1);
  up.parts = parts;
  up.act = act;
  if ((err = launch_qgemm_epi<QW_H>(xq, static_cast<const signed char*>(w1), h, up, st)) !=
      cudaSuccess)
    return err;
  if ((err = launch_quant_amax(static_cast<const float*>(h), parts, nparts, hq, sh, t, m, st)) !=
      cudaSuccess)
    return err;

  QwArgs down{};
  down.M = t;
  down.N = d;
  down.K = m;
  down.sa = sh;
  down.sb = static_cast<const float*>(s2);
  down.bias = static_cast<const float*>(b2);
  down.residual = static_cast<const bf16*>(x);
  if ((err = launch_qgemm_epi<QW_RESID>(hq, static_cast<const signed char*>(w2), out, down,
                                        st)) != cudaSuccess)
    return err;

  if (stats_out != nullptr &&
      (err = launch_row_stats(static_cast<const bf16*>(out), static_cast<ST*>(stats_out), t, d,
                              eps, st)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Finds cuTensorMapEncodeTiled (tma_init) and opts the GEMM's epilogues
// in to their shared memory, on the current device.  Called once per
// device before the first launch.  Returns a cudaError_t.
int vft_mlp_int8_stats_init() {
  cudaError_t err = tma_init();
  if (err != cudaSuccess) return err;
  if ((err = qgemm_epi_enable<QW_H>()) != cudaSuccess) return err;
  return qgemm_epi_enable<QW_RESID>();
}

// x, out: (T, D) bf16; stats, stats_out: (T, 2) f32, or bf16 when st_bf16
// (stats_out may be null: no next stats); ls, lb, s2, b2: (D,) f32; w1:
// (M, D) int8 (the (D, M) weight transposed); s1, b1: (M,) f32; w2: (D, M)
// int8 (the (M, D) weight transposed).  Scratch as K15's: xq (T, D) and hq
// (T, M) int8, sx and sh (T,) f32, h (T, M) f32, parts (nparts, T) f32 with
// nparts = qgemm_wgmma_col_tiles(M).  act is one of ACT_GELU_TANH,
// ACT_QUICK_GELU, ACT_RELU.  D and M multiples of 16; the tensors 16-byte
// aligned.  Everything is enqueued on `stream`, which belongs to the
// current device.  Returns a cudaError_t.
int vft_mlp_block_int8_stats(const void* x, const void* stats, const void* ls, const void* lb,
                             const void* w1, const void* s1, const void* b1, const void* w2,
                             const void* s2, const void* b2, void* out, void* stats_out, void* xq,
                             void* sx, void* hq, void* sh, void* h, void* parts, int t, int d,
                             int m, int nparts, int act, int st_bf16, float eps, void* stream) {
  if (t < 1 || d % 16 || m % 16 || d < 16 || m < 16 || nparts != qgemm_wgmma_col_tiles(m) ||
      (act != ACT_GELU_TANH && act != ACT_QUICK_GELU && act != ACT_RELU))
    return cudaErrorInvalidValue;
  if (tma_encoder() == nullptr) return cudaErrorInitializationError;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  auto* xq8 = static_cast<signed char*>(xq);
  auto* hq8 = static_cast<signed char*>(hq);
  auto* sxf = static_cast<float*>(sx);
  auto* shf = static_cast<float*>(sh);
  auto* pf = static_cast<float*>(parts);
  return st_bf16 ? run<bf16>(x, stats, ls, lb, w1, s1, b1, w2, s2, b2, out, stats_out, xq8, sxf,
                             hq8, shf, h, pf, t, d, m, nparts, act, eps, st)
                 : run<float>(x, stats, ls, lb, w1, s1, b1, w2, s2, b2, out, stats_out, xq8, sxf,
                              hq8, shf, h, pf, t, d, m, nparts, act, eps, st);
}

}  // extern "C"
