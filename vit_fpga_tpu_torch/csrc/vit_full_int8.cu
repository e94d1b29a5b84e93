// Whole dynamic-int8 ViT forward in one launch on Hopper (sm_90a): image
// in, class logits out, the batch-1 int8 latency serving path's
// single-launch forward.
//
// Replaces vit_fpga_tpu/ops/vit_stack.py:_stack_full_int8_kernel (wrapper
// vit_full_int8_pallas): K19a's layers with an int8 patch embed before
// them and the final LayerNorm and an int8 head after them.  One
// cooperative persistent grid (stack.cuh) runs:
//
//   (p) rows   pq, sp = rowquant(bf16 patch row) for every padded token row,
//              gathered from the NHWC image (full.cuh); the all-zero CLS
//              and tail rows quantize to 0
//   (e) tiles  tok = bf16(float(pq wpq) * (sp * wps) + posb)
//   (0) rows   xq, sx = rowquant(LN1(tok))
//   per layer: K19a's stages (a)-(i) (stack_i8.cuh); after the last layer
//              each image's first (CLS) row takes the final one-pass
//              LayerNorm and its row quantization from f32, rq, rs
//   (h) items  logits = float(rq whq) * (rs * whs) + bh (the padded whs
//              columns are 1.0), the padded classes split in 8-column
//              items over the grid
//
// Row quantization is _row_quant of the JAX package (quant_block.py):
// s = max(absmax, 1e-12) / 127 by IEEE division, q = clip(rint(x / s),
// -127, 127), dequantization float(acc) * (s_row * s_col) + bias.
//
// What bounds it on the H100: at ViT-B/16 batch 1 it reads K19a's 84.9 MB
// of int8 weights and 0.33 MB of scales, wpq (0.6 MB), the 1024-column
// int8 head (0.8 MB) and posb (0.6 MB), 87.3 MB in all (26.1 us at
// 3.35 TB/s), for 33.7 G int8 operations (17.0 us at 1979 TOPS): bound by
// bytes.  The embed adds two grid barriers before the layers and the head
// one after them.

#define VFT_NS vit_full_int8
#include "common.cuh"
#include "quant.cuh"
#include "stack.cuh"
#include "stack_i8.cuh"
#include "full.cuh"

using namespace VFT_NS;

namespace VFT_NS {

struct FullI8Args {
  StackI8Args s;             // s.tok lives in the workspace; s.x is unused
  Patches g;
  const signed char* wpq;    // (D, p3): the (p3, D) weight transposed
  const float* wps;          // (D,)
  const float* posb;         // (n_pad, D)
  const float* lfs;
  const float* lfb;
  const signed char* whq;    // (D, cls_pad) row-major
  const float* whs;          // (cls_pad,)
  const float* bh;           // (cls_pad,)
  float* logits;             // (B, cls_pad)
  int cls_pad;
};

// Stage kinds of the StageClock trace past K19a's.
enum { T_PATCH_QUANT = T_RES_LN1 + 1, T_EMBED, T_HEAD };

struct FullI8Work {
  WorkI8 w;
  bf16* tok;         // (R, D)
  signed char* pq;   // (R, p3)
};

__host__ __device__ inline size_t full_work_layout_i8(unsigned char* base, int rows, int d, int m,
                                                      int p3, FullI8Work* fw) {
  size_t off = work_layout_i8(base, rows, d, m, fw != nullptr ? &fw->w : nullptr);
  bf16* tok = reinterpret_cast<bf16*>(base + off);
  off += align256((size_t)rows * d * 2);
  signed char* pq = reinterpret_cast<signed char*>(base + off);
  off += align256((size_t)rows * p3);
  if (fw != nullptr) {
    fw->tok = tok;
    fw->pq = pq;
  }
  return off;
}

// pq[row], sp[row] = rowquant(the bf16 patch row), one block per row, up to
// two 8-column chunks per thread (p3 <= FULL_MAX_P3), all loaded first.
__device__ void patch_quant_row(const Patches& g, int n_pad, signed char* pq, float* sp, int row) {
  const int b = row / n_pad, t = row % n_pad;
  float f[2][8];
  bool on[2];
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = (threadIdx.x + i * SK_THREADS) * 8;
    on[i] = c < g.p3;
    if (on[i]) {
      patch_chunk(g, b, t, c, f[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(f[i][e]));
    }
  }
  const float qs = __fdiv_rn(fmaxf(block_max(amax), 1e-12f), 127.0f);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (on[i]) store_q8(pq + (size_t)row * g.p3 + (threadIdx.x + i * SK_THREADS) * 8, f[i], qs);
  if (threadIdx.x == 0) sp[row] = qs;
}

// tok = bf16(float(pq wpq) * (sp * wps) + posb).
__device__ __forceinline__ void embed_stage_i8(const FullI8Args& a, const signed char* pq,
                                               const float* sp, unsigned char* smem) {
  const StackI8Args& p = a.s;
  const int rows = p.batch * p.n_pad, d = p.d, p3 = a.g.p3;
  const int mt = (rows + ST_BM - 1) / ST_BM;
  const int items = mt * (d / ST_BN);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int m0 = (it % mt) * ST_BM, n0 = (it / mt) * ST_BN;
    tile_i8(pq, p3, a.wpq, p3, rows, m0, n0, 0, p3, smem, [&](int r, int c, int* acc) {
      if (r >= rows) return;
      const float srow = __ldcg(sp + r);
      const float* pb = a.posb + (size_t)(r % p.n_pad) * d + c;
      float f[16];
#pragma unroll
      for (int t = 0; t < 16; ++t) f[t] = dequant(acc[t], srow, a.wps[c + t], pb[t]);
      store16(p.tok + (size_t)r * d + c, f);
    });
  }
}

// logits[b, c0 .. c0 + 7] = float(rq[b * n_pad] whq[:, c0 .. c0 + 7]) *
// (rs * whs) + bh: exact int32 sums, each thread a slice of k.
__device__ __forceinline__ void head_stage_i8(const FullI8Args& a, const signed char* rq,
                                              const float* rs) {
  __shared__ int red[SK_WARPS][FULL_MAX_BATCH * HEAD_COLS];
  const StackI8Args& p = a.s;
  const int d = p.d, nb = p.batch;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int it = blockIdx.x; it < a.cls_pad / HEAD_COLS; it += gridDim.x) {
    const int c0 = it * HEAD_COLS;
    int acc[FULL_MAX_BATCH][HEAD_COLS];
#pragma unroll
    for (int b = 0; b < FULL_MAX_BATCH; ++b)
#pragma unroll
      for (int j = 0; j < HEAD_COLS; ++j) acc[b][j] = 0;
    for (int k = threadIdx.x; k < d; k += SK_THREADS) {
      union {
        uint2 u;
        signed char c[8];
      } w;
      w.u = __ldg(reinterpret_cast<const uint2*>(a.whq + (size_t)k * a.cls_pad + c0));
#pragma unroll
      for (int b = 0; b < FULL_MAX_BATCH; ++b) {
        if (b >= nb) break;
        const int x = __ldcg(rq + ((size_t)b * p.n_pad) * d + k);
#pragma unroll
        for (int j = 0; j < HEAD_COLS; ++j) acc[b][j] += x * (int)w.c[j];
      }
    }
#pragma unroll
    for (int b = 0; b < FULL_MAX_BATCH; ++b)
#pragma unroll
      for (int j = 0; j < HEAD_COLS; ++j) {
        int v = acc[b][j];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) red[warp][b * HEAD_COLS + j] = v;
      }
    __syncthreads();
    if (threadIdx.x < nb * HEAD_COLS) {
      int s = 0;
#pragma unroll
      for (int w = 0; w < SK_WARPS; ++w) s += red[w][threadIdx.x];
      const int b = threadIdx.x / HEAD_COLS, c = c0 + threadIdx.x % HEAD_COLS;
      a.logits[(size_t)b * a.cls_pad + c] =
          dequant(s, __ldcg(rs + (size_t)b * p.n_pad), a.whs[c], a.bh[c]);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(SK_THREADS, 2) full_int8_kernel(FullI8Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const StackI8Args& p = a.s;
  const int rows = p.batch * p.n_pad;
  FullI8Work fw;
  full_work_layout_i8(p.work, rows, p.d, p.m, a.g.p3, &fw);
  StageClock clk{p.trace, 0};
  clk.start();

  for (int r = blockIdx.x; r < rows; r += gridDim.x) patch_quant_row(a.g, p.n_pad, fw.pq, fw.w.sx, r);
  clk.sync(grid, T_PATCH_QUANT);
  embed_stage_i8(a, fw.pq, fw.w.sx, smem);
  clk.sync(grid, T_EMBED);
  for (int r = blockIdx.x; r < rows; r += gridDim.x)
    row_pass_i8<false>(p.tok, p.tok, nullptr, 0, 0, nullptr, nullptr, p.ls1, p.lb1, fw.w.q,
                       fw.w.sx, r, p.d, p.eps);
  clk.sync(grid, T_LN1);
  encoder_layers_i8(p, fw.w, clk, grid, smem, a.lfs, a.lfb);
  clk.sync(grid, T_RES_LN1);
  head_stage_i8(a, fw.w.q, fw.w.sx);
  clk.work_done(T_HEAD);
}

}  // namespace VFT_NS

extern "C" {

// Opts the kernel in to the shared memory of the largest attention item,
// on the current device.  Returns a cudaError_t.
int vft_vit_full_int8_init() {
  return cudaFuncSetAttribute(full_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)stack_smem_bytes(ST_MAX_KV));
}

// Bytes of scratch vft_vit_full_int8 needs at `rows` = B * n_pad rows.
size_t vft_vit_full_int8_workspace(int rows, int d, int m, int p3) {
  return full_work_layout_i8(nullptr, rows, d, m, p3, nullptr);
}

// img: (B, H, W, 3) f32 (img_f32 = 1) or bf16 NHWC images; logits: (B,
// cls_pad) f32; work: vft_vit_full_int8_workspace bytes; wpq (D, p3) int8
// (the (p3, D) weight k-contiguous) with p3 = 3 * patch^2 a multiple of 16
// up to FULL_MAX_P3, wps (D,) f32; posb (n_pad, D) f32; the layer
// arguments as vft_vit_layers_int8; lfs, lfb (D,) f32; whq (D, cls_pad)
// int8 row-major, whs and bh (cls_pad,) f32, cls_pad a multiple of 8.
// n_tok = 1 + (H / patch) * (W / patch) <= min(n_pad, 256), batch 1..4.
// Enqueued on `stream`, which belongs to the current device.  Returns a
// cudaError_t.
int vft_vit_full_int8(const void* img, void* logits, void* work, const void* wpq,
                      const void* wps, const void* posb, const void* ls1, const void* lb1,
                      const void* wqkv, const void* sqkv, const void* bqkv, const void* wo,
                      const void* so, const void* bo, const void* ls2, const void* lb2,
                      const void* w1, const void* s1, const void* b1, const void* w2,
                      const void* s2, const void* b2, const void* lfs, const void* lfb,
                      const void* whq, const void* whs, const void* bh, int img_f32, int img_h,
                      int img_w, int patch, int batch, int n_pad, int d, int m, int depth,
                      int heads, int n_tok, int cls_pad, int act, float eps, float scale,
                      void* trace, void* stream) {
  if (d != heads * ST_DH || d % ST_BN || d > 8 * SK_THREADS || m % ST_BN ||
      m > 8 * SK_THREADS * ST_H_CHUNKS || m / ST_BN > SK_THREADS || depth < 1 || n_tok < 1 ||
      n_tok > n_pad || n_tok > ST_MAX_KV || batch < 1 || batch > FULL_MAX_BATCH ||
      cls_pad < HEAD_COLS || cls_pad % HEAD_COLS || !patches_ok(img_h, img_w, patch, n_tok) ||
      (act != ACT_GELU_TANH && act != ACT_QUICK_GELU))
    return cudaErrorInvalidValue;
  FullI8Args a;
  StackI8Args& s = a.s;
  FullI8Work fw;
  full_work_layout_i8(static_cast<unsigned char*>(work), batch * n_pad, d, m, 3 * patch * patch,
                      &fw);
  s.x = nullptr;
  s.tok = fw.tok;
  s.work = static_cast<unsigned char*>(work);
  s.ls1 = static_cast<const float*>(ls1);
  s.lb1 = static_cast<const float*>(lb1);
  s.wqkv = static_cast<const signed char*>(wqkv);
  s.sqkv = static_cast<const float*>(sqkv);
  s.bqkv = static_cast<const float*>(bqkv);
  s.wo = static_cast<const signed char*>(wo);
  s.so = static_cast<const float*>(so);
  s.bo = static_cast<const float*>(bo);
  s.ls2 = static_cast<const float*>(ls2);
  s.lb2 = static_cast<const float*>(lb2);
  s.w1 = static_cast<const signed char*>(w1);
  s.s1 = static_cast<const float*>(s1);
  s.b1 = static_cast<const float*>(b1);
  s.w2 = static_cast<const signed char*>(w2);
  s.s2 = static_cast<const float*>(s2);
  s.b2 = static_cast<const float*>(b2);
  s.trace = static_cast<long long*>(trace);
  s.batch = batch;
  s.n_pad = n_pad;
  s.d = d;
  s.m = m;
  s.depth = depth;
  s.heads = heads;
  s.n_valid = n_tok;
  s.act = act;
  s.amax_parts = m / ST_BN;
  s.eps = eps;
  s.scale = scale;
  a.g = make_patches(img, img_f32, img_h, img_w, patch, n_tok);
  a.wpq = static_cast<const signed char*>(wpq);
  a.wps = static_cast<const float*>(wps);
  a.posb = static_cast<const float*>(posb);
  a.lfs = static_cast<const float*>(lfs);
  a.lfb = static_cast<const float*>(lfb);
  a.whq = static_cast<const signed char*>(whq);
  a.whs = static_cast<const float*>(whs);
  a.bh = static_cast<const float*>(bh);
  a.logits = static_cast<float*>(logits);
  a.cls_pad = cls_pad;
  const int kvp = (n_tok + 15) / 16 * 16;
  return coop_launch(reinterpret_cast<const void*>(full_int8_kernel), &a, stack_smem_bytes(kvp),
                     trace != nullptr, reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
