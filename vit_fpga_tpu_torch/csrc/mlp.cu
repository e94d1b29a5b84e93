// Per-block MLP half on Hopper (sm_90a), the forward the training path
// and safe-softmax serving run.
//
// Replaces vit_fpga_tpu/ops/fused_mlp.py:_mlp_kernel (wrapper
// fused_mlp_pallas), one Pallas kernel on the TPU.  It is K2
// (mlp_stats.cu) with two-pass LayerNorm statistics computed here and no
// stats output.  A short sequence of launches on one stream, counted as
// one ported kernel:
//
//   (a) ln_rows         two-pass (mu, rstd) of x (the TPU kernel's jnp.var)
//   (b) gemm_bf16<LN>   h = bf16(act(LN(x; mu, rstd, ls, lb) @ W1 + b1))
//   (c) gemm_bf16       out = x + bf16(h @ W2 + b2)
//
// What bounds it on the H100: at ViT-B/16 batch 64 (12 800 token rows,
// D = 768, M = 3072) the launch does about 121 GFLOP against about 49 MB
// of compulsory traffic, so it is bound by tensor-core operations (about
// 122 us at 989 TFLOP/s).  The normalised activations never reach device
// memory (LN is applied to the A tiles in shared memory) and the
// activation runs in the first GEMM's epilogue; the (T, M) bf16 hidden
// tensor (79 MB at ViT-B b64) round-trips through device memory, as in K2.

#define VFT_NS mlp
#include "common.cuh"
#include "norm.cuh"

using namespace VFT_NS;

extern "C" {

// Opts this unit's GEMMs in to the shared memory they use, on the current
// device.  Called once per device before the first launch.  Returns a
// cudaError_t.
int vft_fused_mlp_init() { return gemm_init(); }

// x, out: (T, D) bf16; ls, lb, b2: (D,) f32; w1: (D, M) bf16; b1: (M,) f32;
// w2: (M, D) bf16.  Scratch: stats (T, 2) f32, h (T, M) bf16.  act is one
// of the Act codes in common.cuh.  Everything is enqueued on `stream`,
// which belongs to the current device.  Returns a cudaError_t.
int vft_fused_mlp(const void* x, const void* ls, const void* lb, const void* w1, const void* b1,
                  const void* w2, const void* b2, void* out, void* stats, void* h, int t, int d,
                  int m, int act, float eps, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if ((err = launch_ln_rows(static_cast<const bf16*>(x), nullptr, nullptr,
                            static_cast<float*>(stats), nullptr, t, d, eps, st)) != cudaSuccess)
    return err;

  GemmArgs up{};
  up.A = static_cast<const bf16*>(x);
  up.stats = static_cast<const float*>(stats);
  up.ln_scale = static_cast<const float*>(ls);
  up.ln_bias = static_cast<const float*>(lb);
  up.B = static_cast<const bf16*>(w1);
  up.bias = static_cast<const float*>(b1);
  up.C = h;
  up.M = t;
  up.N = m;
  up.K = d;
  up.act = act;
  if ((err = launch_gemm(true, up, st)) != cudaSuccess) return err;

  GemmArgs down{};
  down.A = static_cast<const bf16*>(h);
  down.B = static_cast<const bf16*>(w2);
  down.bias = static_cast<const float*>(b2);
  down.residual = static_cast<const bf16*>(x);
  down.C = out;
  down.M = t;
  down.N = d;
  down.K = m;
  if ((err = launch_gemm(false, down, st)) != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
