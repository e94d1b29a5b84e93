// Fused row-wise int8 linear on Hopper (sm_90a): the dynamic int8 path's
// head, and every linear of the per-linear int8 route.
//
// Replaces vit_fpga_tpu/ops/quant_fused.py:_fused_kernel (wrapper
// int8_linear_fused), one Pallas kernel on the TPU.  Two launches on one
// stream, counted as one ported kernel:
//
//   (a) quant_rows   optional two-pass LayerNorm (the TPU kernel's jnp.var),
//                    then per-row absmax -> s = absmax / 127,
//                    xq = clip(rint(x / s), +-127)  (quant.cuh)
//   (b) qgemm        out = act(float(xq wq) * (s * ws) + bias), bf16 or f32;
//                    act: none, tanh-GELU (jax.nn.gelu's textbook form),
//                    quick_gelu, relu  (qgemm_wgmma.cuh's QW_ACT epilogue)
//
// What bounds it on the H100.  At the ViT-B/16 head, T = 64 rows, K = 768,
// N = 1000: 0.1 G int8 operations (0.05 us at 1979 TOPS) against the 0.77
// MB int8 weight read once (0.23 us at 3.35 TB/s), so bytes, and in
// practice the two launches' latency.  On the per-linear route of ViT-B/16
// @1024 (make_forward_int8: 49 launches a batch, b2 = 8208 rows) the
// linears are (8208, 768) x 2304 (with the LN), x 768 and x 3072 and (8208,
// 3072) x 768: 116 G int8 operations a layer, 59 us at 1979 TOPS, against
// ~30 MB of rows and outputs, so operations.  The quantized rows go
// through device memory (T x K bytes) and the GEMM is qgemm_wgmma.cuh's
// persistent warp-specialised kernel (int8 wgmma fed by TMA through a
// 4-stage ring, the epilogue staged 32 columns at a time and stored by TMA
// while the next tile's products run), reading the weight transposed, (N,
// K) k-contiguous, as the forward lays it out once.  The columns past a
// ragged N (the head's 1000 end 104 into their eighth 128-wide tile) are
// left out by TMA; an output row stride that is no multiple of 16 bytes is
// stored from the registers, masked.

#define VFT_NS quant_linear
#include "common.cuh"
#include "quant.cuh"
#include "hopper.cuh"
#include "qgemm_wgmma.cuh"

using namespace VFT_NS;

extern "C" {

// Resolves the tensor-map encoder and opts the GEMM's two tile widths in
// to their shared memory, on the current device.  Called once per device
// before the first launch.  Returns a cudaError_t.
int vft_quant_linear_init() {
  const cudaError_t err = tma_init();
  return err != cudaSuccess ? err : qgemm_epi_enable<QW_ACT>();
}

// x: (T, K) bf16, or f32 when x_f32; ls, lb: (K,) f32 (read when ln != 0);
// wq: (N, K) int8 (the (K, N) weight transposed); ws, bias: (N,) f32;
// out: (T, N) bf16, or f32 when out_f32.  Scratch: xq (T, K) int8, sx (T,)
// f32.  ln is 0 (none) or 2 (two-pass LayerNorm with eps); act is 0 (none),
// ACT_GELU_TANH_JAX, ACT_QUICK_GELU or ACT_RELU.  K % 16 == 0; wq, xq, out,
// ws and bias 16-byte aligned.  Everything is enqueued on `stream`, which
// belongs to the current device.  Returns a cudaError_t.
int vft_int8_linear_fused(const void* x, const void* ls, const void* lb, const void* wq,
                          const void* ws, const void* bias, void* out, void* xq, void* sx,
                          int x_f32, int ln, int out_f32, int t, int k, int n, int act, float eps,
                          void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (ln != LN_NONE && ln != LN_TWO_PASS) return cudaErrorInvalidValue;
  signed char* q = static_cast<signed char*>(xq);
  float* s = static_cast<float*>(sx);
  const float* fls = static_cast<const float*>(ls);
  const float* flb = static_cast<const float*>(lb);
  cudaError_t err;
  if (x_f32)
    err = ln ? launch_quant_rows<float, LN_TWO_PASS>(static_cast<const float*>(x), fls, flb, q, s,
                                                     t, k, eps, st)
             : launch_quant_rows<float, LN_NONE>(static_cast<const float*>(x), fls, flb, q, s, t,
                                                 k, eps, st);
  else
    err = ln ? launch_quant_rows<bf16, LN_TWO_PASS>(static_cast<const bf16*>(x), fls, flb, q, s, t,
                                                    k, eps, st)
             : launch_quant_rows<bf16, LN_NONE>(static_cast<const bf16*>(x), fls, flb, q, s, t, k,
                                                eps, st);
  if (err != cudaSuccess) return err;

  QwArgs g{};
  g.M = t;
  g.N = n;
  g.K = k;
  g.sa = s;
  g.sb = static_cast<const float*>(ws);
  g.bias = static_cast<const float*>(bias);
  g.act = act;
  g.y_f32 = out_f32;
  if ((err = launch_qgemm_epi<QW_ACT>(q, static_cast<const signed char*>(wq), out, g, st)) !=
      cudaSuccess)
    return err;
  return cudaGetLastError();
}

}  // extern "C"
