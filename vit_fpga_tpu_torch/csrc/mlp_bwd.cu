// MLP-half backward on Hopper (sm_90a), the backward of mlp.cu.
//
// Replaces vit_fpga_tpu/ops/fused_mlp.py:_mlp_bwd_with_b1_kernel (wrapper
// fused_mlp_bwd_pallas), one Pallas kernel on the TPU that recomputes the
// forward per token tile and sums the weight gradients in VMEM across its
// sequential grid.  Here it is a sequence of launches on one stream,
// counted as one ported kernel; every sum runs in a fixed order (no
// atomics), so a result is the same from run to run:
//
//   (a) ln_rows              two-pass (mu, rstd) of x and xn = bf16(LN(x))
//   (b) gemm_bf16<TB>        da = g @ W2^T                       (f32)
//   (c) gemm_bf16 act-bwd    h = xn @ W1 + b1 -> a = bf16(act(h)),
//                            dh = bf16(da * act'(h)), and the per-block
//                            column sums of da * act'(h) (f32)
//   (d) colsum               db1 = sum of those block sums
//   (e) gemm_bf16<TB>        dxn = dh @ W1^T                     (f32)
//   (f) gemm_bf16<TA>        dW1 = xn^T dh, (g) dW2 = a^T g      (f32, over
//                            all T rows in one product)
//   (h) colsum               db2 = sum of g
//   (i) ln_bwd + colsum      dx = bf16(g + LN backward of dxn), dls, dlb
//
// What bounds it on the H100: five T x D x M products, 10 T D M flops
// (302 GFLOP at ViT-B/16 batch 64, 0.305 ms at 989 TFLOP/s), so it is
// bound by tensor-core operations; its compulsory traffic is under 100 MB.
// The design recomputes the forward instead of saving activations (the
// autograd function saves only the inputs, as the JAX custom_vjp), and it
// turns the TPU's grid-carried VMEM accumulators into whole-batch
// transposed-A GEMMs and column sums.  The (T, M) f32 da and bf16 a and dh
// tensors round-trip through device memory (157 + 79 + 79 MB at ViT-B
// b64); keeping them on chip is later work.

#define VFT_NS mlp_bwd
#include "common.cuh"
#include "norm.cuh"

using namespace VFT_NS;

namespace {

struct MlpBwdWork {
  size_t st, xn, da, a, dh, dxn, b1part, lnpart, cspart, bytes;
};

inline size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

MlpBwdWork mlp_bwd_work(int t, int d, int m) {
  MlpBwdWork w;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off += align256(bytes);
    return at;
  };
  const int row_blocks = (t + GEMM_BM - 1) / GEMM_BM;
  w.st = take((size_t)t * 2 * sizeof(float));
  w.xn = take((size_t)t * d * sizeof(bf16));
  w.da = take((size_t)t * m * sizeof(float));
  w.a = take((size_t)t * m * sizeof(bf16));
  w.dh = take((size_t)t * m * sizeof(bf16));
  w.dxn = take((size_t)t * d * sizeof(float));
  w.b1part = take((size_t)row_blocks * m * sizeof(float));
  w.lnpart = take((size_t)ln_bwd_blocks(t) * 2 * d * sizeof(float));
  size_t cs = colsum_scratch_floats(row_blocks, m);
  cs = cs > colsum_scratch_floats(t, d) ? cs : colsum_scratch_floats(t, d);
  cs = cs > colsum_scratch_floats(ln_bwd_blocks(t), 2 * d)
           ? cs
           : colsum_scratch_floats(ln_bwd_blocks(t), 2 * d);
  w.cspart = take(cs * sizeof(float));
  w.bytes = off;
  return w;
}

}  // namespace

extern "C" {

// Opts this unit's kernels in to the shared memory they use, on the
// current device.  Called once per device before the first launch.
// Returns a cudaError_t.
int vft_mlp_bwd_init() {
  cudaError_t err;
  if ((err = gemm_enable<false, false, false>()) != cudaSuccess) return err;
  if ((err = gemm_enable<false, false, true>()) != cudaSuccess) return err;
  if ((err = gemm_enable<false, true, false>()) != cudaSuccess) return err;
  return ln_bwd_enable();
}

// Bytes of device workspace vft_fused_mlp_bwd takes at this shape.
size_t vft_mlp_bwd_workspace(int t, int d, int m) { return mlp_bwd_work(t, d, m).bytes; }

// x, g, dx: (T, D) bf16; ls, lb: (D,) f32; w1: (D, M) bf16; b1: (M,) f32;
// w2: (M, D) bf16.  Outputs, f32: dln (2D,) = [dls | dlb], dw1 (D, M),
// db1 (M,), dw2 (M, D), db2 (D,).  work: vft_mlp_bwd_workspace bytes.
// T, D and M multiples of 8, D <= 2048; act is one of the Act codes in
// common.cuh.  Everything is enqueued on `stream`, which belongs to the
// current device.  Returns a cudaError_t.
int vft_fused_mlp_bwd(const void* x, const void* g, const void* ls, const void* lb,
                      const void* w1, const void* b1, const void* w2, void* dx, void* dln,
                      void* dw1, void* db1, void* dw2, void* db2, void* work, int t, int d,
                      int m, int act, float eps, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (t % 8 || d % 8 || m % 8 || d > LNB_MAX_D) return cudaErrorInvalidValue;
  const MlpBwdWork w = mlp_bwd_work(t, d, m);
  unsigned char* ws = static_cast<unsigned char*>(work);
  float* stats = reinterpret_cast<float*>(ws + w.st);
  bf16* xn = reinterpret_cast<bf16*>(ws + w.xn);
  float* da = reinterpret_cast<float*>(ws + w.da);
  bf16* a = reinterpret_cast<bf16*>(ws + w.a);
  bf16* dh = reinterpret_cast<bf16*>(ws + w.dh);
  float* dxn = reinterpret_cast<float*>(ws + w.dxn);
  float* b1part = reinterpret_cast<float*>(ws + w.b1part);
  float* lnpart = reinterpret_cast<float*>(ws + w.lnpart);
  float* cspart = reinterpret_cast<float*>(ws + w.cspart);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  cudaError_t err;

  if ((err = launch_ln_rows(xb, static_cast<const float*>(ls), static_cast<const float*>(lb),
                            stats, xn, t, d, eps, st)) != cudaSuccess)
    return err;

  GemmArgs p{};  // da = g @ W2^T
  p.A = gb;
  p.B = static_cast<const bf16*>(w2);
  p.C = da;
  p.c_f32 = 1;
  p.M = t;
  p.N = m;
  p.K = d;
  if ((err = launch_gemm_t<false, false, true>(p, st)) != cudaSuccess) return err;

  p = GemmArgs{};  // a, dh and db1's block sums from h = xn @ W1 + b1
  p.A = xn;
  p.B = static_cast<const bf16*>(w1);
  p.bias = static_cast<const float*>(b1);
  p.act = act;
  p.aux = da;
  p.C = a;
  p.C2 = dh;
  p.col_partials = b1part;
  p.M = t;
  p.N = m;
  p.K = d;
  if ((err = launch_gemm_t<false, false, false>(p, st)) != cudaSuccess) return err;
  if ((err = launch_colsum<float>(b1part, static_cast<float*>(db1), cspart,
                                  (t + GEMM_BM - 1) / GEMM_BM, m, st)) != cudaSuccess)
    return err;

  p = GemmArgs{};  // dxn = dh @ W1^T
  p.A = dh;
  p.B = static_cast<const bf16*>(w1);
  p.C = dxn;
  p.c_f32 = 1;
  p.M = t;
  p.N = d;
  p.K = m;
  if ((err = launch_gemm_t<false, false, true>(p, st)) != cudaSuccess) return err;

  p = GemmArgs{};  // dW1 = xn^T dh
  p.A = xn;
  p.B = dh;
  p.C = dw1;
  p.c_f32 = 1;
  p.M = d;
  p.N = m;
  p.K = t;
  if ((err = launch_gemm_t<false, true, false>(p, st)) != cudaSuccess) return err;

  p = GemmArgs{};  // dW2 = a^T g
  p.A = a;
  p.B = gb;
  p.C = dw2;
  p.c_f32 = 1;
  p.M = m;
  p.N = d;
  p.K = t;
  if ((err = launch_gemm_t<false, true, false>(p, st)) != cudaSuccess) return err;

  if ((err = launch_colsum<bf16>(gb, static_cast<float*>(db2), cspart, t, d, st)) != cudaSuccess)
    return err;

  if ((err = launch_ln_bwd(xb, stats, dxn, gb, static_cast<const float*>(ls),
                           static_cast<bf16*>(dx), lnpart, t, d, st)) != cudaSuccess)
    return err;
  if ((err = launch_colsum<float>(lnpart, static_cast<float*>(dln), cspart, ln_bwd_blocks(t),
                                  2 * d, st)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

}  // extern "C"
