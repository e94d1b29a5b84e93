// Int8 MLP half on Hopper (sm_90a), the dynamic int8 serving path's MLP.
//
// Replaces vit_fpga_tpu/ops/quant_block.py:_mlp_int8_kernel (wrapper
// mlp_block_int8), one Pallas kernel on the TPU.  A short sequence of
// launches on one stream, counted as one ported kernel:
//
//   (a) quant_rows<LN_ONE_PASS>  xn = LN(x) (one-pass stats, _ln_f32), its
//                       row absmax, sx = absmax / 127, xq = clip(rint(xn / sx))
//   (b) qgemm<EPI_AMAX> h = act(float(xq w1q) * (sx * w1s) + b1) in f32 (the
//                       fma tanh-GELU, quick_gelu or relu), and each block's
//                       per-row absmax of h over its 128 columns
//   (c) quant_amax      the row absmax of h from those partials, then
//                       hq = clip(rint(h / sh)) over all M columns
//   (d) qgemm<EPI_RESID> out = x + bf16(float(hq w2q) * (sh * w2s) + b2)
//
// What bounds it on the H100: at ViT-B/16 batch 64 (T = 12 800 rows,
// D = 768, M = 3072) the launch does 4·T·D·M = 120.8 G int8 operations
// (61 us at 1979 TOPS) against about 44 MB of compulsory traffic (13 us),
// so it is bound by tensor-core operations.  The hard part is that h's
// scale spans its whole 3072-wide row while a GEMM block sees 128 columns:
// the TPU kernel holds the row in VMEM.  Here GEMM1's epilogue writes f32 h
// (157 MB at b64; rounding h to bf16 first would move rint against the TPU
// kernel) with per-block row maxima, one small pass reduces them and
// quantizes, and GEMM2 reads int8 hq.  h and hq round-trip through device
// memory (later work: keep them on chip, wgmma).

#define VFT_NS mlp_int8
#include "common.cuh"
#include "quant.cuh"

using namespace VFT_NS;

extern "C" {

// Opts this unit's GEMMs in to their shared memory, on the current device.
// Called once per device before the first launch.  Returns a cudaError_t.
int vft_mlp_int8_init() {
  cudaError_t err = qgemm_enable<EPI_AMAX>();
  if (err != cudaSuccess) return err;
  return qgemm_enable<EPI_RESID>();
}

// x, out: (T, D) bf16; ls, lb, s2, b2: (D,) f32; w1: (M, D) int8 (the
// (D, M) weight transposed); s1, b1: (M,) f32; w2: (D, M) int8 (the (M, D)
// weight transposed).  Scratch: q8 (T, M) int8 (xq, then hq), s (T,) f32
// (sx, then sh), h (T, M) f32, parts (ceil(M / 128), T) f32.  act is one of
// ACT_GELU_TANH, ACT_QUICK_GELU, ACT_RELU.  D and M multiples of 16.
// Everything is enqueued on `stream`, which belongs to the current device.
// Returns a cudaError_t.
int vft_mlp_block_int8(const void* x, const void* ls, const void* lb, const void* w1,
                       const void* s1, const void* b1, const void* w2, const void* s2,
                       const void* b2, void* out, void* q8, void* s, void* h, void* parts, int t,
                       int d, int m, int act, float eps, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  signed char* q = static_cast<signed char*>(q8);
  float* sc = static_cast<float*>(s);
  cudaError_t err;
  if ((err = launch_quant_rows<bf16, LN_ONE_PASS>(static_cast<const bf16*>(x),
                                                  static_cast<const float*>(ls),
                                                  static_cast<const float*>(lb), q, sc, t, d, eps,
                                                  st)) != cudaSuccess)
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
  return cudaGetLastError();
}

}  // extern "C"
