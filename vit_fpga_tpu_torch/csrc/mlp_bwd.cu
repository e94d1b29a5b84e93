// MLP-half backward on Hopper (sm_90a), the backward of mlp.cu.
//
// Replaces vit_fpga_tpu/ops/fused_mlp.py:_mlp_bwd_with_b1_kernel (wrapper
// fused_mlp_bwd_pallas), one Pallas kernel on the TPU that recomputes the
// forward per token tile and sums the weight gradients in VMEM across its
// sequential grid.  Here it is a sequence of launches on one stream,
// counted as one ported kernel; every sum runs in a fixed order (no
// atomics), so a result is the same from run to run:
//
//   (a) ln_rows           two-pass (mu, rstd) of x and xn = bf16(LN(x))
//   (b, c) gf_kernel      da = g @ W2^T and h = xn @ W1 + b1 on one tile,
//                         in registers -> a = bf16(act(h)), dh = bf16(da *
//                         act'(h)), and the per-64-row column sums of da *
//                         act'(h) (f32, unrounded)
//   (d) colsum            db1 = sum of those block sums
//   (e) GEMM, B K-major   dxn = dh @ W1^T                       (f32)
//   (f) GEMM, A MN-major  dW1 = xn^T dh, (g) dW2 = a^T g (f32, over all T
//                         rows, split-K partials) + split_sum of each
//   (h) colsum            db2 = sum of g
//   (i) ln_bwd + colsum   dx = bf16(g + LN backward of dxn), dls, dlb
//
// The five products run on gemm_wgmma.cuh's persistent wgmma + TMA units
// (a producer warpgroup streaming 64-deep K steps into an mbarrier ring,
// two consumer warpgroups), in the layouts the backward needs: the weight
// read K-major without the transpose bit for (b) and (e), the activation
// read MN-major through the transpose bit on A for (f) and (g); (b) and
// (c) share one 128 x 128 tile in gemm_wgmma.cuh's gf_kernel
// (wgmma.m64n128k16, both accumulators in registers), the others run
// gw_kernel's 128 x 256 tiles (wgmma.m64n256k16).  They replace five launches of common.cuh's wmma
// GEMM (gemm_bf16_kernel with its TA / TB flags and its
// activation-backward epilogue).
//
// What bounds it on the H100: five T x D x M products, 10 T D M flops
// (302 GFLOP at ViT-B/16 batch 64, 0.305 ms at 989 TFLOP/s), so it is
// bound by tensor-core operations; its compulsory traffic is under 100 MB.
// The library's autograd yardstick saves the forward's activations and so
// does 4 of the 5 products (242 GFLOP in 1.5939 ms, about 152 TFLOP/s);
// this kernel recomputes h instead (the autograd function saves only the
// inputs, as the JAX custom_vjp).  What the design does about each step:
// (b) + (c) are 2400 tiles of 128 x 128 (18.2 waves of 132 SMs), and the
// (T, M) f32 da (157 MB at ViT-B b64) never reaches device memory; the
// bf16 a and dh (79 + 79 MB) still do, for (e), (f) and (g).  (e) is 300
// tiles (2.3 waves).  (f) and (g) have 72 tiles each, and 200 K steps a
// tile: split-K in gw_splits' count (8 at b64, 576 units, 4.4 waves)
// spreads them over the card, at the cost of the f32 partials (8 x 9.4 MB
// each) that split_sum adds in split order.

#define VFT_NS mlp_bwd
#include "common.cuh"
#include "hopper.cuh"
#include "gemm_wgmma.cuh"
#include "norm.cuh"

using namespace VFT_NS;

namespace {

struct MlpBwdWork {
  size_t st, xn, parts, a, dh, dxn, b1part, lnpart, cspart, bytes;
  int splits;  // of the weight-gradient products (f) and (g)
};

inline size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

// The workspace at this shape on a card of `sms` SMs.
MlpBwdWork mlp_bwd_work(int t, int d, int m, int sms) {
  MlpBwdWork w;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off += align256(bytes);
    return at;
  };
  const int row_blocks = (t + GF_COLSUM_ROWS - 1) / GF_COLSUM_ROWS;
  const long long wtiles = (long long)((d + GW_BM - 1) / GW_BM) * ((m + GW_BN - 1) / GW_BN);
  w.splits = gw_splits(wtiles, (t + GW_BK - 1) / GW_BK, sms);
  w.st = take((size_t)t * 2 * sizeof(float));
  w.xn = take((size_t)t * d * sizeof(bf16));
  w.parts = take((size_t)w.splits * d * m * sizeof(float));  // (f) and (g) in turn
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

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace

extern "C" {

// Opts this unit's kernels in to the shared memory they use, on the
// current device.  Called once per device before the first launch.
// Returns a cudaError_t.
int vft_mlp_bwd_init() {
  cudaError_t err = tma_init();
  if (err != cudaSuccess) return err;
  if ((err = gw_enable_bwd<GW_AK_BK, GW_EPI_F32>()) != cudaSuccess) return err;
  if ((err = gf_enable()) != cudaSuccess) return err;
  if ((err = gw_enable_bwd<GW_AM_BN, GW_EPI_F32>()) != cudaSuccess) return err;
  return ln_bwd_enable();
}

// Bytes of device workspace vft_fused_mlp_bwd takes at this shape on the
// current device (0 if the device cannot be read).
size_t vft_mlp_bwd_workspace(int t, int d, int m) {
  int sms = 0;
  return sm_count(&sms) == cudaSuccess ? mlp_bwd_work(t, d, m, sms).bytes : 0;
}

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
  if (tma_encoder() == nullptr) return cudaErrorInitializationError;
  int sms = 0;
  cudaError_t err;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  const MlpBwdWork w = mlp_bwd_work(t, d, m, sms);
  unsigned char* ws = static_cast<unsigned char*>(work);
  float* stats = reinterpret_cast<float*>(ws + w.st);
  bf16* xn = reinterpret_cast<bf16*>(ws + w.xn);
  float* parts = reinterpret_cast<float*>(ws + w.parts);
  bf16* a = reinterpret_cast<bf16*>(ws + w.a);
  bf16* dh = reinterpret_cast<bf16*>(ws + w.dh);
  float* dxn = reinterpret_cast<float*>(ws + w.dxn);
  float* b1part = reinterpret_cast<float*>(ws + w.b1part);
  float* lnpart = reinterpret_cast<float*>(ws + w.lnpart);
  float* cspart = reinterpret_cast<float*>(ws + w.cspart);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  const bf16* w1b = static_cast<const bf16*>(w1);

  if ((err = launch_ln_rows(xb, static_cast<const float*>(ls), static_cast<const float*>(lb),
                            stats, xn, t, d, eps, st)) != cudaSuccess)
    return err;

  GfArgs f{};  // (b, c) a, dh and db1's 64-row sums from da = g @ W2^T
  f.bias = static_cast<const float*>(b1);  // and h = xn @ W1 + b1
  f.a = a;
  f.dh = dh;
  f.col_partials = b1part;
  f.M = t;
  f.N = m;
  f.K = d;
  f.act = act;
  if ((err = launch_act_bwd_fused(gb, xn, static_cast<const bf16*>(w2), w1b, f, st)) !=
      cudaSuccess)
    return err;
  if ((err = launch_colsum<float>(b1part, static_cast<float*>(db1), cspart,
                                  (t + GF_COLSUM_ROWS - 1) / GF_COLSUM_ROWS, m, st)) !=
      cudaSuccess)
    return err;

  GwArgs p{};  // (e) dxn = dh @ W1^T, W1 (D, M) read K-major
  p.C32 = dxn;
  p.splits = 1;
  p.M = t;
  p.N = d;
  p.K = m;
  if ((err = launch_gemm_wgmma<GW_AK_BK, GW_EPI_F32>(dh, w1b, false, p, st)) != cudaSuccess)
    return err;

  p = GwArgs{};  // (f) dW1 = xn^T dh, xn (T, D) read MN-major, split over T
  p.C32 = parts;
  p.splits = w.splits;
  p.M = d;
  p.N = m;
  p.K = t;
  if ((err = launch_gemm_wgmma<GW_AM_BN, GW_EPI_F32>(xn, dh, false, p, st)) != cudaSuccess ||
      (err = launch_split_sum(parts, static_cast<float*>(dw1), (size_t)d * m, w.splits, st)) !=
          cudaSuccess)
    return err;

  p.M = m;  // (g) dW2 = a^T g, a (T, M) read MN-major, split over T
  p.N = d;
  if ((err = launch_gemm_wgmma<GW_AM_BN, GW_EPI_F32>(a, gb, false, p, st)) != cudaSuccess ||
      (err = launch_split_sum(parts, static_cast<float*>(dw2), (size_t)m * d, w.splits, st)) !=
          cudaSuccess)
    return err;

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
