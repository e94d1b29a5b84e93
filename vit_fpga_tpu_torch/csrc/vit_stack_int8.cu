// Whole dynamic-int8 encoder in one launch on Hopper (sm_90a), the batch-1
// int8 latency serving path's encoder.
//
// Replaces vit_fpga_tpu/ops/vit_stack.py:_stack_int8_kernel (wrapper
// vit_layers_int8_pallas), whose layer is exactly K16 then K15.  One
// cooperative persistent grid, a block of a producer and two consumer
// warpgroups on each SM, walks the layers and separates the stages with
// grid-wide barriers (stack_wgmma.cuh, its dynamic variant LQ_DYN):
//
//   (0) rows   tok = x; xq, sx = rowquant(LN1(tok))              (once)
//   per layer: stages (a)-(g) of stack_wgmma.cuh (int8 QKV items,
//              attention items, int8 out-projection split-K items with ao
//              quantised in their prologue, residual + LN2 + quant rows,
//              int8 W1 + act + row max items, int8 W2 split-K items with h
//              quantised in their prologue, residual + next LN1 + quant
//              rows): 7 grid barriers
//
// Rounding follows quant.cuh and PR 3's kernels: the one-pass f32 LN with
// IEEE operations in the plain version's order, s = max(absmax, 1e-12) /
// 127 by IEEE division, q = clip(rint(x / s), -127, 127) (half to even),
// dequantization float(acc) * (s_row * s_col) + bias, products and sums
// written as __fmul_rn / __fadd_rn so that nvcc cannot contract them.
//
// What bounds it on the H100: at ViT-B/16 batch 1 the encoder reads
// 84.9 MB of int8 weights and 0.33 MB of scales (25.4 us at 3.35 TB/s) and
// does 33.5 G int8 operations (16.9 us at 1979 TOPS) plus 1.4 GFLOP of bf16
// attention: bound by bytes.  At 200 rows every stage is short, so the
// chain of 85 grid barriers and the latency of each stage's first loads
// weigh as much as the bytes: the design streams each weight by TMA into a
// 4-deep ring on all SMs, issues the next GEMM stage's first weight boxes
// before each barrier, and folds the two absmax-only row stages of a
// layer into the next GEMM's prologue.

#define VFT_NS vit_stack_int8
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

__global__ void __launch_bounds__(LQ_THREADS, 1) stack_int8_kernel(const __grid_constant__ LqArgs p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  LqRing<LQ_DYN> r = lq_ring<LQ_DYN>(smem);
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

// Finds the driver's tensor-map encoder and opts the kernel in to its
// shared memory, on the current device.  Returns a cudaError_t.
int vft_vit_stack_int8_init() {
  cudaError_t err = tma_init();
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(stack_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)lq_smem_bytes(LQ_DYN));
}

// Bytes of scratch vft_vit_layers_int8 needs at `rows` = B * n_pad rows.
size_t vft_vit_stack_int8_workspace(int rows, int d, int m) {
  return lq_work_layout(nullptr, rows, d, m, LQ_DYN, nullptr);
}

// x, out: (B * n_pad, D) bf16; the per-layer f32 vectors stacked (L, .);
// wqkv (L, 3D, D), wo (L, D, D), w1 (L, M, D), w2 (L, D, M) int8, each the
// (K, N) weight stored k-contiguous, 16-byte aligned; work:
// vft_vit_stack_int8_workspace bytes.  Head dim 64, D a multiple of 64 up
// to 2048, M a multiple of 64 up to 4096, 1 <= n_valid <= min(n_pad, 256).
// act: ACT_GELU_TANH or ACT_QUICK_GELU.  trace: null, or a zeroed int64
// (ST_TRACE_BLOCKS, ST_TRACE_KINDS, 2) StageClock buffer.  Enqueued on
// `stream`, which belongs to the current device.  Returns a cudaError_t.
int vft_vit_layers_int8(const void* x, void* out, void* work, const void* ls1, const void* lb1,
                        const void* wqkv, const void* sqkv, const void* bqkv, const void* wo,
                        const void* so, const void* bo, const void* ls2, const void* lb2,
                        const void* w1, const void* s1, const void* b1, const void* w2,
                        const void* s2, const void* b2, int batch, int n_pad, int d, int m,
                        int depth, int heads, int n_valid, int act, float eps, float scale,
                        void* trace, void* stream) {
  if (d != heads * ST_DH || d % ST_DH || d > LQ_MAX_D || m % ST_DH || m < ST_DH ||
      m > LQ_MAX_M || depth < 1 || n_valid < 1 || n_valid > n_pad || n_valid > ST_MAX_KV ||
      batch < 1 || (act != ACT_GELU_TANH && act != ACT_QUICK_GELU))
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
  a.inv_ao = a.inv_ah = a.wps = a.posb = a.lfs = a.lfb = nullptr;
  a.p3 = 0;
  LqWork w;
  lq_work_layout(a.work, batch * n_pad, d, m, LQ_DYN, &w);
  if (!lq_encode_layers<LQ_DYN>(&a.maps, w, wqkv, wo, w1, w2, batch, n_pad, d, m, depth, heads,
                                n_valid))
    return cudaErrorInvalidValue;
  return coop_launch(reinterpret_cast<const void*>(stack_int8_kernel), &a, lq_smem_bytes(LQ_DYN),
                     trace != nullptr, reinterpret_cast<cudaStream_t>(stream), LQ_THREADS);
}

}  // extern "C"
