// Whole calibrated static-scale int8 encoder in one launch on Hopper
// (sm_90a), the batch-1 static int8 latency serving path's encoder.
//
// Replaces vit_fpga_tpu/ops/vit_stack.py:_stack_int8_static_kernel
// (wrapper vit_layers_int8_static_pallas), whose layer is exactly K18 then
// K17 (_layer_math_int8_static).  The calibrated scales arrive folded into
// the arguments (models/quantized.quantize_vit_static); the two that
// cannot fold, 1/a_ao and 1/a_h, come as (depth,) tables read at the
// layer the loop is on.  One cooperative persistent grid walks the layers
// and separates the stages with grid-wide barriers (stack.cuh):
//
//   (0) rows   tok = x; xq = clip(rint(LN1(tok)))                 (once)
//   per layer l:
//   (a) tiles  qkv = bf16(float(xq wqkvq) * sqkv + bqkv)
//   (b) items  the max-free masked attention with r = (1 / sum(e)) *
//              inv_ao[l], emitting aoq = clip(rint(bf16(o * r))); idle
//              blocks prefetch Wo, W1, W2 into L2
//   (c) tiles  split-K int32 partials of aoq woq (exact in any order)
//   (d) rows   tok = tok + bf16(float(sum) * so + bo); xq = clip(rint(LN2))
//   (e) tiles  hq = clip(rint(act(float(xq w1q) * s1 + b1) * inv_ah[l]))
//              (the order of _apply_act_scaled), emitted as int8
//   (f) tiles  split-K int32 partials of hq w2q
//   (g) rows   tok = tok + bf16(float(sum) * s2 + b2); the next layer's xq;
//              prefetch of the next layer's Wqkv
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
// by bytes; at batch 4 by operations.  Against K19a the static scale
// removes the two row-quantization stages ("ao quant rows", "h quant
// rows") and their barriers: 7 barriers a layer where K19a has 9, and h
// crosses L2 as int8 instead of f32.

#define VFT_NS vit_stack_int8_static
#include "common.cuh"
#include "quant.cuh"
#include "stack.cuh"

using namespace VFT_NS;

namespace VFT_NS {

struct StackS8Args {
  const bf16* x;
  bf16* tok;
  unsigned char* work;
  const float* ls1;
  const float* lb1;
  const signed char* wqkv;  // (L, 3D, D): the (D, 3D) weights transposed
  const float* sqkv;
  const float* bqkv;
  const signed char* wo;    // (L, D, D) transposed
  const float* so;
  const float* bo;
  const float* ls2;
  const float* lb2;
  const signed char* w1;    // (L, M, D) transposed
  const float* s1;
  const float* b1;
  const signed char* w2;    // (L, D, M) transposed
  const float* s2;
  const float* b2;
  const float* inv_ao;      // (L,) 1/a_ao of each layer
  const float* inv_ah;      // (L,) 1/a_h of each layer
  long long* trace;         // optional StageClock buffer (stack.cuh)
  int batch, n_pad, d, m, depth, heads, n_valid, act;
  float eps, scale;
};

// Stage kinds of the StageClock trace (ops/vit_stack.K19B_STAGES).
enum { T_LN1 = 0, T_QKV, T_ATTN, T_OPROJ, T_RES_LN2, T_W1, T_W2, T_RES_LN1 };

struct WorkS8 {
  signed char* q;   // (R, D): xq, then aoq
  signed char* hq;  // (R, M)
  bf16* qkv;        // (R, 3D)
  int* part;        // (4, R, D)
};

__host__ __device__ inline size_t work_layout_s8(unsigned char* base, int rows, int d, int m,
                                                 WorkS8* w) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = base + off;
    off += align256(bytes);
    return p;
  };
  signed char* q = reinterpret_cast<signed char*>(take((size_t)rows * d));
  signed char* hq = reinterpret_cast<signed char*>(take((size_t)rows * m));
  bf16* qkv = reinterpret_cast<bf16*>(take((size_t)rows * 3 * d * 2));
  int* part = reinterpret_cast<int*>(take((size_t)ST_MAX_SPLIT * rows * d * 4));
  if (w != nullptr) *w = WorkS8{q, hq, qkv, part};
  return off;
}

// hq = clip(rint(act(dequant(xq w1q)) * qs)), 16 int8 of a row per lane.
__device__ void w1_stage_static(const signed char* A, const signed char* W, const float* scol,
                                const float* bias, signed char* hq, int rows, int n, int k,
                                int act, float qs, unsigned char* smem) {
  const int mt = (rows + ST_BM - 1) / ST_BM;
  const int items = mt * (n / ST_BN);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int m0 = (it % mt) * ST_BM, n0 = (it / mt) * ST_BN;
    tile_i8(A, k, W, k, rows, m0, n0, 0, k, smem, [&](int r, int c, int* acc) {
      if (r >= rows) return;
      float f[16];
#pragma unroll
      for (int t = 0; t < 16; ++t)
        f[t] = qact_scaled(dequant(acc[t], 1.0f, scol[c + t], bias[c + t]), act, qs);
      store_rint8(hq + (size_t)r * n + c, f);
      store_rint8(hq + (size_t)r * n + c + 8, f + 8);
    });
  }
}

__global__ void __launch_bounds__(SK_THREADS, 2) stack_int8_static_kernel(StackS8Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int rows = p.batch * p.n_pad, d = p.d, m = p.m;
  WorkS8 w;
  work_layout_s8(p.work, rows, d, m, &w);
  const size_t pstride = (size_t)rows * d;
  const int so = pick_split(d, 3);
  const int s2 = pick_split(m, 4);
  StageClock clk{p.trace, 0};
  clk.start();

  for (int r = blockIdx.x; r < rows; r += gridDim.x)
    row_pass_i8<true>(p.x, p.tok, nullptr, 0, 0, nullptr, nullptr, p.ls1, p.lb1, w.q, nullptr, r,
                      d, p.eps);
  clk.sync(grid, T_LN1);
  for (int l = 0; l < p.depth; ++l) {
    const signed char* wqkv = p.wqkv + (size_t)l * 3 * d * d;
    const signed char* wo = p.wo + (size_t)l * d * d;
    const signed char* w1 = p.w1 + (size_t)l * m * d;
    const signed char* w2 = p.w2 + (size_t)l * d * m;
    const float inv_ao = __ldg(p.inv_ao + l);
    const float inv_ah = __ldg(p.inv_ah + l);
    qkv_stage(w.q, nullptr, wqkv, p.sqkv + (size_t)l * 3 * d, p.bqkv + (size_t)l * 3 * d, w.qkv,
              rows, 3 * d, d, smem);
    clk.sync(grid, T_QKV);
    attn_stage<true>(w.qkv, nullptr, p.batch, p.heads, p.n_pad, p.n_valid, d, p.scale, smem, w.q,
                     inv_ao);
    prefetch_l2(wo, (size_t)d * d);
    prefetch_l2(w1, (size_t)d * m);
    prefetch_l2(w2, (size_t)m * d);
    clk.sync(grid, T_ATTN);
    split_stage_i8(w.q, wo, w.part, rows, d, d, so, smem);
    clk.sync(grid, T_OPROJ);
    for (int r = blockIdx.x; r < rows; r += gridDim.x)
      row_pass_i8<true>(p.tok, p.tok, w.part, so, pstride, p.so + (size_t)l * d,
                        p.bo + (size_t)l * d, p.ls2 + (size_t)l * d, p.lb2 + (size_t)l * d, w.q,
                        nullptr, r, d, p.eps);
    clk.sync(grid, T_RES_LN2);
    w1_stage_static(w.q, w1, p.s1 + (size_t)l * m, p.b1 + (size_t)l * m, w.hq, rows, m, d, p.act,
                    inv_ah, smem);
    clk.sync(grid, T_W1);
    split_stage_i8(w.hq, w2, w.part, rows, d, m, s2, smem);
    clk.sync(grid, T_W2);
    const bool last = l == p.depth - 1;
    for (int r = blockIdx.x; r < rows; r += gridDim.x)
      row_pass_i8<true>(p.tok, p.tok, w.part, s2, pstride, p.s2 + (size_t)l * d,
                        p.b2 + (size_t)l * d, last ? nullptr : p.ls1 + (size_t)(l + 1) * d,
                        last ? nullptr : p.lb1 + (size_t)(l + 1) * d, w.q, nullptr, r, d, p.eps);
    if (!last) {
      prefetch_l2(p.wqkv + (size_t)(l + 1) * 3 * d * d, (size_t)3 * d * d);
      clk.sync(grid, T_RES_LN1);
    } else {
      clk.work_done(T_RES_LN1);
    }
  }
}

}  // namespace VFT_NS

extern "C" {

// Opts the kernel in to the shared memory of the largest attention item,
// on the current device.  Returns a cudaError_t.
int vft_vit_stack_int8_static_init() {
  return cudaFuncSetAttribute(stack_int8_static_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)stack_smem_bytes(ST_MAX_KV));
}

// Bytes of scratch vft_vit_layers_int8_static needs at `rows` = B * n_pad.
size_t vft_vit_stack_int8_static_workspace(int rows, int d, int m) {
  return work_layout_s8(nullptr, rows, d, m, nullptr);
}

// x, out: (B * n_pad, D) bf16; the per-layer f32 vectors stacked (L, .),
// folded as quantize_vit_static folds them; inv_ao, inv_ah: (L,) f32;
// wqkv (L, 3D, D), wo (L, D, D), w1 (L, M, D), w2 (L, D, M) int8, each the
// (K, N) weight stored k-contiguous; work: vft_vit_stack_int8_static_
// workspace bytes.  Head dim 64, D a multiple of 64 up to 2048, M a
// multiple of 64, 1 <= n_valid <= min(n_pad, 256).  act: ACT_GELU_TANH or
// ACT_QUICK_GELU.  trace: null, or a zeroed int64 (ST_TRACE_BLOCKS,
// ST_TRACE_KINDS, 2) StageClock buffer.  Enqueued on `stream`, which
// belongs to the current device.  Returns a cudaError_t.
int vft_vit_layers_int8_static(const void* x, void* out, void* work, const void* ls1,
                               const void* lb1, const void* wqkv, const void* sqkv,
                               const void* bqkv, const void* wo, const void* so, const void* bo,
                               const void* ls2, const void* lb2, const void* w1, const void* s1,
                               const void* b1, const void* w2, const void* s2, const void* b2,
                               const void* inv_ao, const void* inv_ah, int batch, int n_pad, int d,
                               int m, int depth, int heads, int n_valid, int act, float eps,
                               float scale, void* trace, void* stream) {
  if (d != heads * ST_DH || d % ST_BN || d > 8 * SK_THREADS || m % ST_BN || depth < 1 ||
      n_valid < 1 || n_valid > n_pad || n_valid > ST_MAX_KV || batch < 1 ||
      (act != ACT_GELU_TANH && act != ACT_QUICK_GELU))
    return cudaErrorInvalidValue;
  StackS8Args a;
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
  const int kvp = (n_valid + 15) / 16 * 16;
  return coop_launch(reinterpret_cast<const void*>(stack_int8_static_kernel), &a,
                     stack_smem_bytes(kvp), trace != nullptr,
                     reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
