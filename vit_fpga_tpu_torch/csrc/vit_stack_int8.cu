// Whole dynamic-int8 encoder in one launch on Hopper (sm_90a), the batch-1
// int8 latency serving path's encoder.
//
// Replaces vit_fpga_tpu/ops/vit_stack.py:_stack_int8_kernel (wrapper
// vit_layers_int8_pallas), whose layer is exactly K16 then K15.  One
// cooperative persistent grid walks the layers in a loop and separates
// the stages with grid-wide barriers (stack.cuh):
//
//   (0) rows   tok = x; xq, sx = rowquant(LN1(tok))              (once)
//   per layer: stages (a)-(i) of stack_i8.cuh (int8 QKV tiles, attention
//              items, ao quant rows, int8 out-projection split-K, residual
//              + LN2 + quant rows, int8 W1 + act + row max tiles, h quant
//              rows, int8 W2 split-K, residual + next LN1 + quant rows)
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
// attention: bound by bytes.  The design spreads each weight stream over
// all SMs in 64 x 64 tiles and split-K, and takes a row's scale (ao over
// 12 heads, h over 3072 columns) in a row pass after a barrier.  What it
// costs: 9 grid barriers per layer.

#define VFT_NS vit_stack_int8
#include "common.cuh"
#include "quant.cuh"
#include "stack.cuh"
#include "stack_i8.cuh"

using namespace VFT_NS;

namespace VFT_NS {

__global__ void __launch_bounds__(SK_THREADS, 2) stack_int8_kernel(StackI8Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int rows = p.batch * p.n_pad;
  WorkI8 w;
  work_layout_i8(p.work, rows, p.d, p.m, &w);
  StageClock clk{p.trace, 0};
  clk.start();

  for (int r = blockIdx.x; r < rows; r += gridDim.x)
    row_pass_i8<false>(p.x, p.tok, nullptr, 0, 0, nullptr, nullptr, p.ls1, p.lb1, w.q, w.sx, r, p.d,
                       p.eps);
  clk.sync(grid, T_LN1);
  encoder_layers_i8(p, w, clk, grid, smem);
  clk.work_done(T_RES_LN1);
}

}  // namespace VFT_NS

extern "C" {

// Opts the kernel in to the shared memory of the largest attention item,
// on the current device.  Returns a cudaError_t.
int vft_vit_stack_int8_init() {
  return cudaFuncSetAttribute(stack_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)stack_smem_bytes(ST_MAX_KV));
}

// Bytes of scratch vft_vit_layers_int8 needs at `rows` = B * n_pad rows.
size_t vft_vit_stack_int8_workspace(int rows, int d, int m) {
  return work_layout_i8(nullptr, rows, d, m, nullptr);
}

// x, out: (B * n_pad, D) bf16; the per-layer f32 vectors stacked (L, .);
// wqkv (L, 3D, D), wo (L, D, D), w1 (L, M, D), w2 (L, D, M) int8, each the
// (K, N) weight stored k-contiguous; work: vft_vit_stack_int8_workspace
// bytes.  Head dim 64, D a multiple of 64 up to 1024, M a multiple of 64,
// 1 <= n_valid <= min(n_pad, 256).  act: ACT_GELU_TANH or ACT_QUICK_GELU.
// trace: null, or a zeroed int64 (ST_TRACE_BLOCKS, ST_TRACE_KINDS, 2)
// StageClock buffer.  Enqueued on `stream`, which belongs to the current
// device.  Returns a cudaError_t.
int vft_vit_layers_int8(const void* x, void* out, void* work, const void* ls1, const void* lb1,
                        const void* wqkv, const void* sqkv, const void* bqkv, const void* wo,
                        const void* so, const void* bo, const void* ls2, const void* lb2,
                        const void* w1, const void* s1, const void* b1, const void* w2,
                        const void* s2, const void* b2, int batch, int n_pad, int d, int m,
                        int depth, int heads, int n_valid, int act, float eps, float scale,
                        void* trace, void* stream) {
  if (d != heads * ST_DH || d % ST_BN || d > 8 * SK_THREADS || m % ST_BN ||
      m > 8 * SK_THREADS * ST_H_CHUNKS || m / ST_BN > SK_THREADS || depth < 1 ||
      n_valid < 1 || n_valid > n_pad || n_valid > ST_MAX_KV || batch < 1 ||
      (act != ACT_GELU_TANH && act != ACT_QUICK_GELU))
    return cudaErrorInvalidValue;
  StackI8Args a;
  a.x = static_cast<const bf16*>(x);
  a.tok = static_cast<bf16*>(out);
  a.work = static_cast<unsigned char*>(work);
  a.ls1 = static_cast<const float*>(ls1);
  a.lb1 = static_cast<const float*>(lb1);
  a.wqkv = static_cast<const signed char*>(wqkv);
  a.sqkv = static_cast<const float*>(sqkv);
  a.bqkv = static_cast<const float*>(bqkv);
  a.wo = static_cast<const signed char*>(wo);
  a.so = static_cast<const float*>(so);
  a.bo = static_cast<const float*>(bo);
  a.ls2 = static_cast<const float*>(ls2);
  a.lb2 = static_cast<const float*>(lb2);
  a.w1 = static_cast<const signed char*>(w1);
  a.s1 = static_cast<const float*>(s1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const signed char*>(w2);
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
  a.amax_parts = m / ST_BN;
  a.eps = eps;
  a.scale = scale;
  a.trace = static_cast<long long*>(trace);
  const int kvp = (n_valid + 15) / 16 * 16;
  return coop_launch(reinterpret_cast<const void*>(stack_int8_kernel), &a, stack_smem_bytes(kvp),
                     trace != nullptr, reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
