// Whole calibrated static-scale int8 encoder in one launch on Hopper
// (sm_90a), the batch-1 static int8 latency serving path's encoder.
//
// Replaces vit_fpga_tpu/ops/vit_stack.py:_stack_int8_static_kernel
// (wrapper vit_layers_int8_static_pallas), whose layer is exactly K18 then
// K17 (_layer_math_int8_static).  The calibrated scales arrive folded into
// the arguments (models/quantized.quantize_vit_static); the two that
// cannot fold, 1/a_ao and 1/a_h, come as (depth,) tables read on the card
// at the layer the loop is on.  One cooperative persistent grid, a block
// of a producer and two consumer warpgroups on each SM, walks the layers
// and separates the stages with grid-wide barriers (stack_wgmma.cuh, its
// static variant LQ_STATIC):
//
//   (0) rows   tok = x; xq = clip(rint(LN1(tok)))                 (once)
//   per layer l:
//   (a) items  qkv = bf16(float(xq wqkvq) * sqkv + bqkv): int8 wgmma, xq
//              and wqkvq by TMA
//   (b) items  the max-free masked attention (mha_wgmma.cuh's mf_sweep)
//              with r = (1 / sum(e)) * inv_ao[l], emitting aoq =
//              clip(rint(bf16(o * r)), -127, 127)
//   (c) items  split-K int32 partials of aoq woq, aoq by TMA (exact in any
//              order)
//   (d) rows   tok = tok + bf16(float(sum) * so + bo); xq = clip(rint(LN2))
//   (e) items  hq = clip(rint(act_scaled(float(xq w1q) * s1 + b1,
//              inv_ah[l]))) (the order of _apply_act_scaled), emitted as
//              int8
//   (f) items  split-K int32 partials of hq w2q, hq by TMA
//   (g) rows   tok = tok + bf16(float(sum) * s2 + b2); the next layer's xq
//
// Rounding follows quant.cuh: the one-pass f32 LN with IEEE operations in
// the plain version's order, rint half to even, saturation at +-127 (live
// here: activations past the calibrated absmax clip), dequantization
// float(acc) * s_col + bias with the row scale 1.0, products and sums
// written as __fmul_rn / __fadd_rn so that nvcc cannot contract them.
//
// What bounds it on the H100: as K19a, at ViT-B/16 batch 1 the encoder
// reads 84.9 MB of int8 weights and 0.33 MB of scales (25.4 us at
// 3.35 TB/s) against 33.5 G int8 operations (16.9 us at 1979 TOPS): bound
// by bytes; at 200 rows the chain of 85 grid barriers weighs as much.
// Against K19a the static scale leaves no quantisation in the
// out-projection and W2: both read their int8 A (aoq, hq) by TMA as QKV
// and W1 read xq, and h crosses L2 as int8 instead of f32.

#define VFT_NS vit_stack_int8_static
#include "common.cuh"
#include "quant.cuh"
#include "hopper.cuh"
#include "qgemm_wgmma.cuh"
#include "gemm_wgmma.cuh"
#include "mha_wgmma.cuh"
#include "stack.cuh"
#include "stack_wgmma.cuh"

using namespace VFT_NS;

namespace VFT_NS {

__global__ void __launch_bounds__(LQ_THREADS, 1)
    stack_int8_static_kernel(const __grid_constant__ LqArgs p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  LqRing<LQ_STATIC> r = lq_ring<LQ_STATIC>(smem);
  StageClock clk{p.trace};
  clk.start();

  if (!lq_consumer()) {
    lq_producer_regs();
    lq_layers_producer(p, r, clk, grid);
  } else {
    lq_consumer_regs();
    lq_layers_consumer(p, r, clk, grid);
  }
  clk.work_done(LQ_T_RES_LN1);
}

}  // namespace VFT_NS

extern "C" {

// Finds cuTensorMapEncodeTiled (tma_init) and opts the kernel in to its
// shared memory, on the current device.  Returns a cudaError_t.
int vft_vit_stack_int8_static_init() {
  cudaError_t err = tma_init();
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(stack_int8_static_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)lq_smem_bytes(LQ_STATIC));
}

// Bytes of scratch vft_vit_layers_int8_static needs at `rows` = B * n_pad.
size_t vft_vit_stack_int8_static_workspace(int rows, int d, int m) {
  return lq_work_layout(nullptr, rows, d, m, LQ_STATIC, nullptr);
}

// x, out: (B * n_pad, D) bf16; the per-layer f32 vectors stacked (L, .),
// folded as quantize_vit_static folds them; inv_ao, inv_ah: (L,) f32;
// wqkv (L, 3D, D), wo (L, D, D), w1 (L, M, D), w2 (L, D, M) int8, each the
// (K, N) weight stored k-contiguous, 16-byte aligned; work:
// vft_vit_stack_int8_static_workspace bytes.  Head dim 64, D a multiple of
// 64 up to 2048, M a multiple of 64, 1 <= n_valid <= min(n_pad, 256).
// act: ACT_GELU_TANH or ACT_QUICK_GELU.  trace: null, or a zeroed int64
// (ST_TRACE_BLOCKS, ST_TRACE_KINDS, 2) StageClock buffer.  Enqueued on
// `stream`, which belongs to the current device.  Returns a cudaError_t.
int vft_vit_layers_int8_static(const void* x, void* out, void* work, const void* ls1,
                               const void* lb1, const void* wqkv, const void* sqkv,
                               const void* bqkv, const void* wo, const void* so, const void* bo,
                               const void* ls2, const void* lb2, const void* w1, const void* s1,
                               const void* b1, const void* w2, const void* s2, const void* b2,
                               const void* inv_ao, const void* inv_ah, int batch, int n_pad, int d,
                               int m, int depth, int heads, int n_valid, int act, float eps,
                               float scale, void* trace, void* stream) {
  if (d != heads * ST_DH || d % ST_DH || d > LQ_MAX_D || m % ST_DH || m < ST_DH || depth < 1 ||
      n_valid < 1 || n_valid > n_pad || n_valid > ST_MAX_KV || batch < 1 ||
      (act != ACT_GELU_TANH && act != ACT_QUICK_GELU))
    return cudaErrorInvalidValue;
  if (tma_encoder() == nullptr) return cudaErrorInitializationError;
  if (!lq_aligned(wqkv) || !lq_aligned(wo) || !lq_aligned(w1) || !lq_aligned(w2) ||
      !lq_aligned(work))
    return cudaErrorMisalignedAddress;
  LqArgs a;
  a.x = static_cast<const bf16*>(x);
  a.tok = static_cast<bf16*>(out);
  a.work = static_cast<unsigned char*>(work);
  a.ls1 = static_cast<const float*>(ls1);
  a.lb1 = static_cast<const float*>(lb1);
  a.sqkv = static_cast<const float*>(sqkv);
  a.bqkv = static_cast<const float*>(bqkv);
  a.so = static_cast<const float*>(so);
  a.bo = static_cast<const float*>(bo);
  a.ls2 = static_cast<const float*>(ls2);
  a.lb2 = static_cast<const float*>(lb2);
  a.s1 = static_cast<const float*>(s1);
  a.b1 = static_cast<const float*>(b1);
  a.s2 = static_cast<const float*>(s2);
  a.b2 = static_cast<const float*>(b2);
  a.inv_ao = static_cast<const float*>(inv_ao);
  a.inv_ah = static_cast<const float*>(inv_ah);
  a.batch = batch;
  a.n_pad = n_pad;
  a.d = d;
  a.m = m;
  a.depth = depth;
  a.heads = heads;
  a.n_valid = n_valid;
  a.act = act;
  a.eps = eps;
  a.scale = scale;
  a.trace = static_cast<long long*>(trace);
  a.wps = a.posb = a.lfs = a.lfb = nullptr;
  a.p3 = 0;
  LqWork w;
  lq_work_layout(a.work, batch * n_pad, d, m, LQ_STATIC, &w);
  if (!lq_encode_layers<LQ_STATIC>(&a.maps, w, wqkv, wo, w1, w2, batch, n_pad, d, m, depth,
                                   heads, n_valid))
    return cudaErrorInvalidValue;
  return coop_launch(reinterpret_cast<const void*>(stack_int8_static_kernel), &a,
                     lq_smem_bytes(LQ_STATIC), trace != nullptr,
                     reinterpret_cast<cudaStream_t>(stream), LQ_THREADS);
}

}  // extern "C"
