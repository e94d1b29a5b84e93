// Whole bf16 encoder in one launch on Hopper (sm_90a), the batch-1 latency
// serving path's encoder.
//
// Replaces vit_fpga_tpu/ops/vit_stack.py:_stack_kernel (wrapper
// vit_layers_pallas), one Pallas kernel whose grid walks the layers.  Here
// one cooperative persistent grid (stack_wgmma.cuh, its bf16 variant
// LQ_BF16: a producer and two consumer warpgroups a block, one ring of TMA
// stages) walks them in a loop and separates the stages with grid-wide
// barriers:
//
//   (0) rows   tok = x; xn = bf16(LN1(tok))                      (once)
//   per layer: the stages (a)-(g) of stack_wgmma.cuh on 128 x 64 bf16
//              items (wgmma.m64n64k16, the (K, N) weights through the
//              transpose bit), the attention on mha_wgmma.cuh's max-free
//              sweep, split-K f32 partials summed in slice order by the row
//              stages; after the last layer no LayerNorm
//
// tok is the output tensor itself.  It is K12's loop (vit_full.cu) without
// the patch rows, the embed and the head.
//
// What bounds it on the H100: at ViT-B/16 batch 1 (197 tokens) the encoder
// reads 169.9 MB of bf16 weights (50.7 us at 3.35 TB/s) and does
// 34.9 GFLOP (35.3 us at 989 TFLOP/s): bound by bytes.  The weights stream
// through TMA into every SM's ring, the next GEMM stage's first weight
// boxes issued before each barrier; 7 grid barriers a layer.

#define VFT_NS vit_stack
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

__global__ void __launch_bounds__(LQ_THREADS, 1) stack_kernel(const __grid_constant__ LqArgs p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  LqRing<LQ_BF16> r = lq_ring<LQ_BF16>(smem);
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
int vft_vit_stack_init() {
  cudaError_t err = tma_init();
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)lq_smem_bytes(LQ_BF16));
}

// Bytes of scratch vft_vit_layers needs at `rows` = B * n_pad token rows.
size_t vft_vit_stack_workspace(int rows, int d, int m) {
  return lq_work_layout(nullptr, rows, d, m, LQ_BF16, nullptr);
}

// x, out: (B * n_pad, D) bf16; ls1, lb1, bqkv, bo, ls2, lb2, b1, b2: the
// stacked (L, .) f32 vectors; wqkv (L, D, 3D), wo (L, D, D), w1 (L, D, M),
// w2 (L, M, D) bf16 row-major, 16-byte aligned; work:
// vft_vit_stack_workspace bytes.  Head dim 64, D a multiple of 64 up to
// 2048, M a multiple of 64, 1 <= n_valid <= min(n_pad, 256).  act:
// ACT_GELU_TANH or ACT_QUICK_GELU.  trace: null, or a zeroed int64
// (ST_TRACE_BLOCKS, ST_TRACE_KINDS, 2) StageClock buffer.  Enqueued on
// `stream`, which belongs to the current device.  Returns a cudaError_t.
int vft_vit_layers(const void* x, void* out, void* work, const void* ls1, const void* lb1,
                   const void* wqkv, const void* bqkv, const void* wo, const void* bo,
                   const void* ls2, const void* lb2, const void* w1, const void* b1,
                   const void* w2, const void* b2, int batch, int n_pad, int d, int m, int depth,
                   int heads, int n_valid, int act, float eps, float scale, void* trace,
                   void* stream) {
  if (d != heads * ST_DH || d % ST_DH || d > LQ_MAX_D || m % ST_DH || m < ST_DH || depth < 1 ||
      n_valid < 1 || n_valid > n_pad || n_valid > ST_MAX_KV || batch < 1 ||
      (act != ACT_GELU_TANH && act != ACT_QUICK_GELU))
    return cudaErrorInvalidValue;
  if (tma_encoder() == nullptr) return cudaErrorInitializationError;
  if (!lq_aligned(x) || !lq_aligned(out) || !lq_aligned(wqkv) || !lq_aligned(wo) ||
      !lq_aligned(w1) || !lq_aligned(w2) || !lq_aligned(work))
    return cudaErrorMisalignedAddress;
  LqArgs a;
  a.x = static_cast<const bf16*>(x);
  a.tok = static_cast<bf16*>(out);
  a.work = static_cast<unsigned char*>(work);
  a.ls1 = static_cast<const float*>(ls1);
  a.lb1 = static_cast<const float*>(lb1);
  a.bqkv = static_cast<const float*>(bqkv);
  a.bo = static_cast<const float*>(bo);
  a.ls2 = static_cast<const float*>(ls2);
  a.lb2 = static_cast<const float*>(lb2);
  a.b1 = static_cast<const float*>(b1);
  a.b2 = static_cast<const float*>(b2);
  a.sqkv = a.so = a.s1 = a.s2 = a.inv_ao = a.inv_ah = nullptr;
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
  lq_work_layout(a.work, batch * n_pad, d, m, LQ_BF16, &w);
  if (!lq_encode_layers<LQ_BF16>(&a.maps, w, wqkv, wo, w1, w2, batch, n_pad, d, m, depth,
                                 heads, n_valid))
    return cudaErrorInvalidValue;
  return coop_launch(reinterpret_cast<const void*>(stack_kernel), &a, lq_smem_bytes(LQ_BF16),
                     trace != nullptr, reinterpret_cast<cudaStream_t>(stream), LQ_THREADS);
}

}  // extern "C"
