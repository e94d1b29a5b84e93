// Whole bf16 encoder in one launch on Hopper (sm_90a), the batch-1 latency
// serving path's encoder.
//
// Replaces vit_fpga_tpu/ops/vit_stack.py:_stack_kernel (wrapper
// vit_layers_pallas), one Pallas kernel whose grid walks the layers.  Here
// one cooperative persistent grid walks them in a loop and separates the
// stages of each layer with grid-wide barriers (stack.cuh):
//
//   (0) rows   tok = x; xn = bf16(LN1(tok))                    (once)
//   per layer: stages (a)-(g) of stack_bf16.cuh (QKV tiles, attention
//              items, out-projection split-K, residual + LN2 rows, W1 + act
//              tiles, W2 split-K, residual + next LN1 rows)
//
// tok is the output tensor itself.
//
// What bounds it on the H100: at ViT-B/16 batch 1 (197 tokens) the encoder
// reads 169.9 MB of bf16 weights (50.7 us at 3.35 TB/s) and does
// 34.9 GFLOP (35.3 us at 989 TFLOP/s): bound by bytes.  Every stage is a
// weight stream: 64 x 64 tiles (and split-K for the narrow out-projection
// and W2) spread each weight over all SMs, the attention splits queries
// so that about 84 items exist at batch 1, and one launch replaces some
// 60 host launches per forward.  What it costs: 7 grid barriers per layer.

#define VFT_NS vit_stack
#include "common.cuh"
#include "quant.cuh"
#include "stack.cuh"
#include "stack_bf16.cuh"

using namespace VFT_NS;

namespace VFT_NS {

__global__ void __launch_bounds__(SK_THREADS, 2) stack_kernel(StackArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int rows = p.batch * p.n_pad;
  Work w;
  work_layout(p.work, rows, p.d, p.m, &w);
  StageClock clk{p.trace};
  clk.start();

  for (int r = blockIdx.x; r < rows; r += gridDim.x)
    row_pass(p.x, p.tok, nullptr, 0, 0, nullptr, p.ls1, p.lb1, w.xn, r, p.d, p.eps);
  clk.sync(grid, T_LN1);
  encoder_layers(p, w, clk, grid, smem);
  clk.work_done(T_RES_LN1);
}

}  // namespace VFT_NS

extern "C" {

// Opts the kernel in to the shared memory of the largest attention item
// (ST_MAX_KV keys), on the current device.  Returns a cudaError_t.
int vft_vit_stack_init() {
  return cudaFuncSetAttribute(stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)stack_smem_bytes(ST_MAX_KV));
}

// Bytes of scratch vft_vit_layers needs at `rows` = B * n_pad token rows.
size_t vft_vit_stack_workspace(int rows, int d, int m) {
  return work_layout(nullptr, rows, d, m, nullptr);
}

// x, out: (B * n_pad, D) bf16; ls1, lb1, bqkv, bo, ls2, lb2, b1, b2: the
// stacked (L, .) f32 vectors; wqkv (L, D, 3D), wo (L, D, D), w1 (L, D, M),
// w2 (L, M, D) bf16 row-major; work: vft_vit_stack_workspace bytes.  Head
// dim 64, D a multiple of 64 up to 1024, M a multiple of 64, 1 <= n_valid
// <= min(n_pad, 256).  act: ACT_GELU_TANH or ACT_QUICK_GELU.  trace: null,
// or a zeroed int64 (ST_TRACE_BLOCKS, ST_TRACE_KINDS, 2) StageClock buffer.
// Enqueued on `stream`, which belongs to the current device.  Returns a
// cudaError_t.
int vft_vit_layers(const void* x, void* out, void* work, const void* ls1, const void* lb1,
                   const void* wqkv, const void* bqkv, const void* wo, const void* bo,
                   const void* ls2, const void* lb2, const void* w1, const void* b1,
                   const void* w2, const void* b2, int batch, int n_pad, int d, int m, int depth,
                   int heads, int n_valid, int act, float eps, float scale, void* trace,
                   void* stream) {
  if (d != heads * ST_DH || d % ST_BN || d > 8 * SK_THREADS || m % ST_BN || depth < 1 ||
      n_valid < 1 || n_valid > n_pad || n_valid > ST_MAX_KV || batch < 1 ||
      (act != ACT_GELU_TANH && act != ACT_QUICK_GELU))
    return cudaErrorInvalidValue;
  StackArgs a;
  a.x = static_cast<const bf16*>(x);
  a.tok = static_cast<bf16*>(out);
  a.work = static_cast<unsigned char*>(work);
  a.ls1 = static_cast<const float*>(ls1);
  a.lb1 = static_cast<const float*>(lb1);
  a.wqkv = static_cast<const bf16*>(wqkv);
  a.bqkv = static_cast<const float*>(bqkv);
  a.wo = static_cast<const bf16*>(wo);
  a.bo = static_cast<const float*>(bo);
  a.ls2 = static_cast<const float*>(ls2);
  a.lb2 = static_cast<const float*>(lb2);
  a.w1 = static_cast<const bf16*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const bf16*>(w2);
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
  const int kvp = (n_valid + 15) / 16 * 16;
  return coop_launch(reinterpret_cast<const void*>(stack_kernel), &a, stack_smem_bytes(kvp),
                     trace != nullptr, reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
