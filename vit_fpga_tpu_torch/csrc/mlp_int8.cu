// Int8 MLP half on Hopper (sm_90a), the dynamic int8 serving path's MLP.
//
// Replaces vit_fpga_tpu/ops/quant_block.py:_mlp_int8_kernel (wrapper
// mlp_block_int8), one Pallas kernel on the TPU.  A short sequence of
// launches on one stream, counted as one ported kernel, its two GEMMs on
// qgemm_wgmma.cuh's int8 wgmma + TMA kernel with dequantizing epilogues:
//
//   (a) quant_rows<LN_ONE_PASS>  xn = LN(x) (one-pass stats, _ln_f32), its
//                  row absmax, sx = absmax / 127, xq = clip(rint(xn / sx))
//   (b) QW_H       h = act(float(xq w1q) * (sx * w1s) + b1) in f32 (the fma
//                  tanh-GELU, quick_gelu or relu), stored by TMA, and each
//                  tile's row absmax of h over its 256 (or 128) columns
//   (c) quant_amax the row absmax of h from the tiles' maxima, sh = absmax
//                  / 127, hq = clip(rint(h / sh)) over all M columns
//   (d) QW_RESID   out = x + bf16(float(hq w2q) * (sh * w2s) + b2)
//
// Rounding follows quant.cuh and the plain version: IEEE operations in its
// order, rint half to even, the clip at +-127, the absmax floored at 1e-12.
//
// What bounds it on the H100: at ViT-B/16 batch 64 (T = 12 800 rows,
// D = 768, M = 3072) the launch does 4·T·D·M = 120.8 G int8 operations
// (61 us at 1979 TOPS) against about 44 MB of compulsory traffic (13 us),
// so it is bound by tensor-core operations.  The hard part is that h's
// scale spans its whole 3072-wide row while a GEMM tile sees 256 columns:
// the TPU kernel holds the row in VMEM.  Here f32 h goes to device memory
// (157 MB at b64) and comes back once.  W1 run twice instead, its row
// maxima and then int8 hq from the same h, kept h on the chip but doubled
// W1's epilogue, whose activation on T x M values sets W1's pace; it was
// slower on the H100 (PERF.md).

#define VFT_NS mlp_int8
#include "common.cuh"
#include "quant.cuh"
#include "hopper.cuh"
#include "qgemm_wgmma.cuh"

using namespace VFT_NS;

extern "C" {

// Finds cuTensorMapEncodeTiled (tma_init) and opts the GEMM's epilogues
// in to their shared memory, on the current device.  Called once per
// device before the first launch.  Returns a cudaError_t.
int vft_mlp_int8_init() {
  cudaError_t err = tma_init();
  if (err != cudaSuccess) return err;
  if ((err = qgemm_epi_enable<QW_H>()) != cudaSuccess) return err;
  return qgemm_epi_enable<QW_RESID>();
}

// x, out: (T, D) bf16; ls, lb, s2, b2: (D,) f32; w1: (M, D) int8 (the
// (D, M) weight transposed); s1, b1: (M,) f32; w2: (D, M) int8 (the (M, D)
// weight transposed).  Scratch: xq (T, D) and hq (T, M) int8, sx and sh
// (T,) f32, h (T, M) f32, parts (nparts, T) f32 with nparts =
// qgemm_wgmma_col_tiles(M).  act is one of ACT_GELU_TANH, ACT_QUICK_GELU,
// ACT_RELU.  D and M multiples of 16; the tensors 16-byte aligned.
// Everything is enqueued on `stream`, which belongs to the current device.
// Returns a cudaError_t.
int vft_mlp_block_int8(const void* x, const void* ls, const void* lb, const void* w1,
                       const void* s1, const void* b1, const void* w2, const void* s2,
                       const void* b2, void* out, void* xq, void* sx, void* hq, void* sh, void* h,
                       void* parts, int t, int d, int m, int nparts, int act, float eps,
                       void* stream) {
  if (t < 1 || d % 16 || m % 16 || d < 16 || m < 16 || nparts != qgemm_wgmma_col_tiles(m) ||
      (act != ACT_GELU_TANH && act != ACT_QUICK_GELU && act != ACT_RELU))
    return cudaErrorInvalidValue;
  if (tma_encoder() == nullptr) return cudaErrorInitializationError;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  signed char* xq8 = static_cast<signed char*>(xq);
  signed char* hq8 = static_cast<signed char*>(hq);
  cudaError_t err;
  if ((err = launch_quant_rows<bf16, LN_ONE_PASS>(static_cast<const bf16*>(x),
                                                  static_cast<const float*>(ls),
                                                  static_cast<const float*>(lb), xq8,
                                                  static_cast<float*>(sx), t, d, eps, st)) !=
      cudaSuccess)
    return err;

  QwArgs up{};
  up.M = t;
  up.N = m;
  up.K = d;
  up.sa = static_cast<const float*>(sx);
  up.sb = static_cast<const float*>(s1);
  up.bias = static_cast<const float*>(b1);
  up.parts = static_cast<float*>(parts);
  up.act = act;
  if ((err = launch_qgemm_epi<QW_H>(xq8, static_cast<const signed char*>(w1), h, up, st)) !=
      cudaSuccess)
    return err;
  if ((err = launch_quant_amax(static_cast<const float*>(h), up.parts, nparts, hq8,
                               static_cast<float*>(sh), t, m, st)) != cudaSuccess)
    return err;

  QwArgs down{};
  down.M = t;
  down.N = d;
  down.K = m;
  down.sa = static_cast<const float*>(sh);
  down.sb = static_cast<const float*>(s2);
  down.bias = static_cast<const float*>(b2);
  down.residual = static_cast<const bf16*>(x);
  if ((err = launch_qgemm_epi<QW_RESID>(hq8, static_cast<const signed char*>(w2), out, down,
                                        st)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

}  // extern "C"
