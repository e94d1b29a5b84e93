// Whole dynamic-int8 encoder in one launch on Hopper (sm_90a), the batch-1
// int8 latency serving path's encoder.
//
// Replaces vit_fpga_tpu/ops/vit_stack.py:_stack_int8_kernel (wrapper
// vit_layers_int8_pallas), whose layer is exactly K16 then K15.  One
// cooperative persistent grid walks the layers in a loop and separates
// the stages with grid-wide barriers (stack.cuh):
//
//   (0) rows   tok = x; xq, sx = rowquant(LN1(tok))              (once)
//   per layer:
//   (a) tiles  qkv = bf16(float(xq wqkvq) * (sx * sqkv) + bqkv)
//   (b) items  the max-free masked attention -> ao (bf16); idle blocks
//              prefetch Wo, W1, W2 into L2
//   (c) rows   aoq, sa = rowquant(f32(ao)) over all D columns (every head)
//   (d) tiles  split-K int32 partials of aoq woq (exact in any order)
//   (e) rows   tok = tok + bf16(float(sum) * (sa * so) + bo);
//              xq, sx = rowquant(LN2(tok))
//   (f) tiles  h = act(float(xq w1q) * (sx * s1) + b1) in f32, and each
//              64-column tile's row absmax of h
//   (g) rows   sh from those maxima over the whole 3072-wide row;
//              hq = rowquant(h): h is quantized from f32, not bf16
//   (h) tiles  split-K int32 partials of hq w2q
//   (i) rows   tok = tok + bf16(float(sum) * (sh * s2) + b2); the next
//              layer's xq, sx; prefetch of the next layer's Wqkv
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

using namespace VFT_NS;

namespace VFT_NS {

struct StackI8Args {
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
  long long* trace;  // optional StageClock buffer (stack.cuh)
  int batch, n_pad, d, m, depth, heads, n_valid, act, amax_parts;
  float eps, scale;
};

// Stage kinds of the StageClock trace.
enum {
  T_LN1 = 0, T_QKV, T_ATTN, T_AO_QUANT, T_OPROJ, T_RES_LN2, T_W1, T_H_QUANT, T_W2, T_RES_LN1
};

struct WorkI8 {
  signed char* q;  // (R, max(D, M))
  float* sx;       // (R,)
  bf16* qkv;       // (R, 3D)
  bf16* ao;        // (R, D)
  float* h;        // (R, M)
  float* amax;     // (M / 64, R)
  int* part;       // (4, R, D)
};

__host__ __device__ inline size_t work_layout_i8(unsigned char* base, int rows, int d, int m,
                                                 WorkI8* w) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = base + off;
    off += align256(bytes);
    return p;
  };
  signed char* q = reinterpret_cast<signed char*>(take((size_t)rows * (d > m ? d : m)));
  float* sx = reinterpret_cast<float*>(take((size_t)rows * 4));
  bf16* qkv = reinterpret_cast<bf16*>(take((size_t)rows * 3 * d * 2));
  bf16* ao = reinterpret_cast<bf16*>(take((size_t)rows * d * 2));
  float* h = reinterpret_cast<float*>(take((size_t)rows * m * 4));
  float* amax = reinterpret_cast<float*>(take((size_t)(m / ST_BN) * rows * 4));
  int* part = reinterpret_cast<int*>(take((size_t)ST_MAX_SPLIT * rows * d * 4));
  if (w != nullptr) *w = WorkI8{q, sx, qkv, ao, h, amax, part};
  return off;
}

// aoq, sa = rowquant(f32(ao)) over the row's D columns.  One block per row.
__device__ __noinline__ void ao_quant_row(const bf16* ao, signed char* q, float* sx, int row,
                                          int d) {
  const int c = threadIdx.x * 8;
  const bool on = c < d;
  const size_t off = (size_t)row * d + (on ? c : 0);
  float v[8];
  ldcg8(ao + off, v);
  quant_chunk(v, on, q + off, sx + row);
}

// hq, sh = rowquant(h) with the row absmax taken from the nparts
// per-tile maxima.  One block per row, up to ST_H_CHUNKS 8-column chunks
// per thread (M <= 8 * SK_THREADS * ST_H_CHUNKS), all loaded first.
constexpr int ST_H_CHUNKS = 2;

__device__ __noinline__ void h_quant_row(const float* h, const float* amax_parts, int nparts,
                                         signed char* q, float* sx, int row, int rows, int m) {
  const int tid = threadIdx.x;
  float f[ST_H_CHUNKS][8];
  bool on[ST_H_CHUNKS];
#pragma unroll
  for (int i = 0; i < ST_H_CHUNKS; ++i) {
    const int c = (tid + i * SK_THREADS) * 8;
    on[i] = c < m;
    ldcg8f(h + (size_t)row * m + (on[i] ? c : 0), f[i]);
  }
  const float part = tid < nparts ? __ldcg(amax_parts + (size_t)tid * rows + row) : 0.0f;
  const float qs = __fdiv_rn(fmaxf(block_max(part), 1e-12f), 127.0f);
#pragma unroll
  for (int i = 0; i < ST_H_CHUNKS; ++i)
    if (on[i]) store_q8(q + (size_t)row * m + (tid + i * SK_THREADS) * 8, f[i], qs);
  if (tid == 0) sx[row] = qs;
}

// h = act(dequant(xq w1q)) in f32, and amax[n0 / 64][row] = the tile's
// row absmax of h.
__device__ void w1_stage(const signed char* A, const float* sx, const signed char* W,
                         const float* scol, const float* bias, float* h, float* amax, int rows,
                         int n, int k, int act, unsigned char* smem) {
  const int mt = (rows + ST_BM - 1) / ST_BM;
  const int items = mt * (n / ST_BN);
  float* red = reinterpret_cast<float*>(smem + (size_t)SK_WARPS * 16 * ST_C_LD * 4);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int m0 = (it % mt) * ST_BM, n0 = (it / mt) * ST_BN;
    tile_i8(A, k, W, k, rows, m0, n0, 0, k, smem, [&](int r, int c, int* acc) {
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
      float mx = 0.0f;
      if (r < rows) {
        const float srow = __ldcg(sx + r);
        float f[16];
#pragma unroll
        for (int t = 0; t < 16; ++t) {
          f[t] = stack_act(dequant(acc[t], srow, scol[c + t], bias[c + t]), act);
          mx = fmaxf(mx, fabsf(f[t]));
        }
        store16(h + (size_t)r * n + c, f);
      }
      // the row's two lanes, then the two column warps
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const int wm = warp >> 1, wn = warp & 1;
      if ((lane & 1) == 0) red[wn * ST_BM + wm * 16 + (lane >> 1)] = mx;
      __syncthreads();
      const int t = threadIdx.x;
      if (t < ST_BM && m0 + t < rows)
        amax[(size_t)(n0 / ST_BN) * rows + m0 + t] = fmaxf(red[t], red[ST_BM + t]);
    });
  }
}

__global__ void __launch_bounds__(SK_THREADS, 2) stack_int8_kernel(StackI8Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int rows = p.batch * p.n_pad, d = p.d, m = p.m;
  WorkI8 w;
  work_layout_i8(p.work, rows, d, m, &w);
  const size_t pstride = (size_t)rows * d;
  const int so = pick_split(d, 3);
  const int s2 = pick_split(m, 4);
  StageClock clk{p.trace, 0};
  clk.start();

  for (int r = blockIdx.x; r < rows; r += gridDim.x)
    row_pass_i8<false>(p.x, p.tok, nullptr, 0, 0, nullptr, nullptr, p.ls1, p.lb1, w.q, w.sx, r, d, p.eps);
  clk.sync(grid, T_LN1);
  for (int l = 0; l < p.depth; ++l) {
    const signed char* wqkv = p.wqkv + (size_t)l * 3 * d * d;
    const signed char* wo = p.wo + (size_t)l * d * d;
    const signed char* w1 = p.w1 + (size_t)l * m * d;
    const signed char* w2 = p.w2 + (size_t)l * d * m;
    qkv_stage(w.q, w.sx, wqkv, p.sqkv + (size_t)l * 3 * d, p.bqkv + (size_t)l * 3 * d, w.qkv,
              rows, 3 * d, d, smem);
    clk.sync(grid, T_QKV);
    attn_stage(w.qkv, w.ao, p.batch, p.heads, p.n_pad, p.n_valid, d, p.scale, smem);
    prefetch_l2(wo, (size_t)d * d);
    prefetch_l2(w1, (size_t)d * m);
    prefetch_l2(w2, (size_t)m * d);
    clk.sync(grid, T_ATTN);
    for (int r = blockIdx.x; r < rows; r += gridDim.x) ao_quant_row(w.ao, w.q, w.sx, r, d);
    clk.sync(grid, T_AO_QUANT);
    split_stage_i8(w.q, wo, w.part, rows, d, d, so, smem);
    clk.sync(grid, T_OPROJ);
    for (int r = blockIdx.x; r < rows; r += gridDim.x)
      row_pass_i8<false>(p.tok, p.tok, w.part, so, pstride, p.so + (size_t)l * d, p.bo + (size_t)l * d,
                  p.ls2 + (size_t)l * d, p.lb2 + (size_t)l * d, w.q, w.sx, r, d, p.eps);
    clk.sync(grid, T_RES_LN2);
    w1_stage(w.q, w.sx, w1, p.s1 + (size_t)l * m, p.b1 + (size_t)l * m, w.h, w.amax, rows, m, d,
             p.act, smem);
    clk.sync(grid, T_W1);
    for (int r = blockIdx.x; r < rows; r += gridDim.x)
      h_quant_row(w.h, w.amax, p.amax_parts, w.q, w.sx, r, rows, m);
    clk.sync(grid, T_H_QUANT);
    split_stage_i8(w.q, w2, w.part, rows, d, m, s2, smem);
    clk.sync(grid, T_W2);
    const bool last = l == p.depth - 1;
    for (int r = blockIdx.x; r < rows; r += gridDim.x)
      row_pass_i8<false>(p.tok, p.tok, w.part, s2, pstride, p.s2 + (size_t)l * d, p.b2 + (size_t)l * d,
                  last ? nullptr : p.ls1 + (size_t)(l + 1) * d,
                  last ? nullptr : p.lb1 + (size_t)(l + 1) * d, w.q, w.sx, r, d, p.eps);
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
