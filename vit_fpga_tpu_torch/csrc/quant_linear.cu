// Fused row-wise int8 linear on Hopper (sm_90a): the dynamic int8 path's
// head, and any linear of the per-linear int8 route.
//
// Replaces vit_fpga_tpu/ops/quant_fused.py:_fused_kernel (wrapper
// int8_linear_fused), one Pallas kernel on the TPU.  Two launches on one
// stream, counted as one ported kernel:
//
//   (a) quant_rows   optional two-pass LayerNorm (the TPU kernel's jnp.var),
//                    then per-row absmax -> s = absmax / 127,
//                    xq = clip(rint(x / s), +-127)
//   (b) qgemm        out = act(float(xq wq) * (s * ws) + bias), bf16 or f32;
//                    act: none, tanh-GELU (jax.nn.gelu's textbook form),
//                    quick_gelu, relu
//
// What bounds it on the H100: on the serving path it is the ViT-B/16 head,
// T = 64 rows, K = 768, N = 1000: 0.1 G int8 operations (0.05 us at 1979
// TOPS) against the 0.77 MB int8 weight read once (0.23 us at 3.35 TB/s),
// so it is bound by bytes, and in practice by two launches' latency.  The
// design is the simplest right one: the quantized rows go through device
// memory (T x K bytes) and the GEMM is the shared wmma int8 GEMM of
// quant.cuh reading the weight transposed, (N, K) k-contiguous, as the
// forward lays it out once; a ragged N (1000 = 7 x 128 + 104) is masked
// in the epilogue.

#define VFT_NS quant_linear
#include "common.cuh"
#include "quant.cuh"

using namespace VFT_NS;

extern "C" {

// Opts the GEMM in to its shared memory, on the current device.  Called
// once per device before the first launch.  Returns a cudaError_t.
int vft_quant_linear_init() { return qgemm_enable<EPI_PLAIN>(); }

// x: (T, K) bf16, or f32 when x_f32; ls, lb: (K,) f32 (read when ln != 0);
// wq: (N, K) int8 (the (K, N) weight transposed); ws, bias: (N,) f32;
// out: (T, N) bf16, or f32 when out_f32.  Scratch: xq (T, K) int8, sx (T,)
// f32.  ln is 0 (none) or 2 (two-pass LayerNorm with eps); act is 0 (none),
// ACT_GELU_TANH_JAX, ACT_QUICK_GELU or ACT_RELU.  K % 16 == 0.  Everything
// is enqueued on `stream`, which belongs to the current device.  Returns a
// cudaError_t.
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

  QGemmArgs g{};
  g.A = q;
  g.sa = s;
  g.B = static_cast<const signed char*>(wq);
  g.sb = static_cast<const float*>(ws);
  g.bias = static_cast<const float*>(bias);
  g.C = out;
  g.M = t;
  g.N = n;
  g.K = k;
  g.act = act;
  g.c_f32 = out_f32;
  if ((err = launch_qgemm<EPI_PLAIN>(g, st)) != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
