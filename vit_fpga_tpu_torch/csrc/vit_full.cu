// Whole bf16 ViT forward in one launch on Hopper (sm_90a): image in, class
// logits out, the batch-1 latency serving path's single-launch forward.
//
// Replaces vit_fpga_tpu/ops/vit_stack.py:_stack_full_kernel (wrapper
// vit_full_pallas), one Pallas kernel whose grid walks the layers with the
// patch-embed GEMM before the first and the final LayerNorm and head after
// the last.  Here one cooperative persistent grid (stack.cuh) runs:
//
//   (p) rows   pp = the padded patch matrix, gathered from the NHWC image
//              (full.cuh: the CLS row and the tail rows zero)
//   (e) tiles  tok = bf16(pp Wp + posb), f32 sums; posb is the (n_pad, D)
//              f32 fold of the CLS token, position table and patch bias
//   (0) rows   xn = bf16(LN1(tok))
//   per layer: K11's stages (a)-(g) (stack_bf16.cuh); after the last layer
//              each image's first (CLS) row takes the final one-pass
//              LayerNorm, xn = bf16(LNf(tok)): the JAX kernel casts it to
//              the head weight's dtype
//   (h) items  logits = xn Wh + bh in f32 for each image's CLS row, the
//              padded classes split in 8-column items over the grid
//
// What bounds it on the H100: at ViT-B/16 batch 1 (197 tokens) it reads
// K11's 169.9 MB of layer weights plus Wp (1.2 MB), the 1024-column head
// (1.6 MB) and posb (0.6 MB), 173.3 MB in all (51.7 us at 3.35 TB/s),
// for 35.1 GFLOP (35.5 us at 989 TFLOP/s): bound by bytes.  The embed adds
// two grid barriers before the layers and the head one after them.

#define VFT_NS vit_full
#include "common.cuh"
#include "quant.cuh"
#include "stack.cuh"
#include "stack_bf16.cuh"
#include "full.cuh"

using namespace VFT_NS;

namespace VFT_NS {

struct FullArgs {
  StackArgs s;        // s.tok lives in the workspace; s.x is unused
  Patches g;
  const bf16* wp;     // (p3, D)
  const float* posb;  // (n_pad, D)
  const float* lfs;
  const float* lfb;
  const bf16* wh;     // (D, cls_pad)
  const float* bh;    // (cls_pad,)
  float* logits;      // (B, cls_pad)
  int cls_pad;
};

// Stage kinds of the StageClock trace past K11's.
enum { T_PATCH = T_RES_LN1 + 1, T_EMBED, T_HEAD };

struct FullWork {
  Work w;
  bf16* tok;  // (R, D)
  bf16* pp;   // (R, p3)
};

__host__ __device__ inline size_t full_work_layout(unsigned char* base, int rows, int d, int m,
                                                   int p3, FullWork* fw) {
  size_t off = work_layout(base, rows, d, m, fw != nullptr ? &fw->w : nullptr);
  bf16* tok = reinterpret_cast<bf16*>(base + off);
  off += align256((size_t)rows * d * 2);
  bf16* pp = reinterpret_cast<bf16*>(base + off);
  off += align256((size_t)rows * p3 * 2);
  if (fw != nullptr) {
    fw->tok = tok;
    fw->pp = pp;
  }
  return off;
}

// pp[row] from the image, one block per row.
__device__ void patch_row(const Patches& g, int n_pad, bf16* pp, int row) {
  const int b = row / n_pad, t = row % n_pad;
  for (int c = threadIdx.x * 8; c < g.p3; c += SK_THREADS * 8) {
    float f[8];
    patch_chunk(g, b, t, c, f);
    *reinterpret_cast<uint4*>(pp + (size_t)row * g.p3 + c) = pack8(f);
  }
}

// tok = bf16(pp Wp + posb).
__device__ __forceinline__ void embed_stage(const FullArgs& a, const bf16* pp, unsigned char* smem) {
  const StackArgs& p = a.s;
  const int rows = p.batch * p.n_pad, d = p.d, p3 = a.g.p3;
  const int mt = (rows + ST_BM - 1) / ST_BM;
  const int items = mt * (d / ST_BN);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int m0 = (it % mt) * ST_BM, n0 = (it / mt) * ST_BN;
    tile_bf16(pp, p3, a.wp, d, rows, m0, n0, 0, p3, smem, [&](int r, int c, float* f) {
      if (r >= rows) return;
      const float* pb = a.posb + (size_t)(r % p.n_pad) * d + c;
#pragma unroll
      for (int t = 0; t < 16; ++t) f[t] = __fadd_rn(f[t], pb[t]);
      store16(p.tok + (size_t)r * d + c, f);
    });
  }
}

// logits[b, c0 .. c0 + 7] = xn[b * n_pad] Wh[:, c0 .. c0 + 7] + bh, f32
// sums: each thread a slice of k, then the warps' sums in a fixed order.
__device__ __forceinline__ void head_stage(const FullArgs& a, const bf16* xn) {
  __shared__ float red[SK_WARPS][FULL_MAX_BATCH * HEAD_COLS];
  const StackArgs& p = a.s;
  const int d = p.d, nb = p.batch;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int it = blockIdx.x; it < a.cls_pad / HEAD_COLS; it += gridDim.x) {
    const int c0 = it * HEAD_COLS;
    float acc[FULL_MAX_BATCH][HEAD_COLS];
#pragma unroll
    for (int b = 0; b < FULL_MAX_BATCH; ++b)
#pragma unroll
      for (int j = 0; j < HEAD_COLS; ++j) acc[b][j] = 0.0f;
    for (int k = threadIdx.x; k < d; k += SK_THREADS) {
      float w[8];
      unpack8(__ldg(reinterpret_cast<const uint4*>(a.wh + (size_t)k * a.cls_pad + c0)), w);
#pragma unroll
      for (int b = 0; b < FULL_MAX_BATCH; ++b) {
        if (b >= nb) break;
        const float x = __bfloat162float(__ushort_as_bfloat16(
            __ldcg(reinterpret_cast<const unsigned short*>(xn + ((size_t)b * p.n_pad) * d + k))));
#pragma unroll
        for (int j = 0; j < HEAD_COLS; ++j) acc[b][j] = fmaf(x, w[j], acc[b][j]);
      }
    }
#pragma unroll
    for (int b = 0; b < FULL_MAX_BATCH; ++b)
#pragma unroll
      for (int j = 0; j < HEAD_COLS; ++j) {
        const float v = warp_sum(acc[b][j]);
        if (lane == 0) red[warp][b * HEAD_COLS + j] = v;
      }
    __syncthreads();
    if (threadIdx.x < nb * HEAD_COLS) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < SK_WARPS; ++w) s += red[w][threadIdx.x];
      const int b = threadIdx.x / HEAD_COLS, j = threadIdx.x % HEAD_COLS;
      a.logits[(size_t)b * a.cls_pad + c0 + j] = __fadd_rn(s, a.bh[c0 + j]);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(SK_THREADS, 2) full_kernel(FullArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const StackArgs& p = a.s;
  const int rows = p.batch * p.n_pad;
  FullWork fw;
  full_work_layout(p.work, rows, p.d, p.m, a.g.p3, &fw);
  StageClock clk{p.trace, 0};
  clk.start();

  for (int r = blockIdx.x; r < rows; r += gridDim.x) patch_row(a.g, p.n_pad, fw.pp, r);
  clk.sync(grid, T_PATCH);
  embed_stage(a, fw.pp, smem);
  clk.sync(grid, T_EMBED);
  for (int r = blockIdx.x; r < rows; r += gridDim.x)
    row_pass(p.tok, p.tok, nullptr, 0, 0, nullptr, p.ls1, p.lb1, fw.w.xn, r, p.d, p.eps);
  clk.sync(grid, T_LN1);
  encoder_layers(p, fw.w, clk, grid, smem, a.lfs, a.lfb);
  clk.sync(grid, T_RES_LN1);
  head_stage(a, fw.w.xn);
  clk.work_done(T_HEAD);
}

}  // namespace VFT_NS

extern "C" {

// Opts the kernel in to the shared memory of the largest attention item,
// on the current device.  Returns a cudaError_t.
int vft_vit_full_init() {
  return cudaFuncSetAttribute(full_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)stack_smem_bytes(ST_MAX_KV));
}

// Bytes of scratch vft_vit_full needs at `rows` = B * n_pad token rows.
size_t vft_vit_full_workspace(int rows, int d, int m, int p3) {
  return full_work_layout(nullptr, rows, d, m, p3, nullptr);
}

// img: (B, H, W, 3) f32 (img_f32 = 1) or bf16 NHWC images; logits: (B,
// cls_pad) f32; work: vft_vit_full_workspace bytes; wp (p3, D) bf16 with
// p3 = 3 * patch^2 a multiple of 16 up to FULL_MAX_P3; posb (n_pad, D)
// f32; the layer arguments as vft_vit_layers; lfs, lfb (D,) f32; wh (D,
// cls_pad) bf16, bh (cls_pad,) f32, cls_pad a multiple of 8.  n_tok = 1 +
// (H / patch) * (W / patch) <= min(n_pad, 256), batch 1..4.  Enqueued on
// `stream`, which belongs to the current device.  Returns a cudaError_t.
int vft_vit_full(const void* img, void* logits, void* work, const void* wp, const void* posb,
                 const void* ls1, const void* lb1, const void* wqkv, const void* bqkv,
                 const void* wo, const void* bo, const void* ls2, const void* lb2, const void* w1,
                 const void* b1, const void* w2, const void* b2, const void* lfs, const void* lfb,
                 const void* wh, const void* bh, int img_f32, int img_h, int img_w, int patch,
                 int batch, int n_pad, int d, int m, int depth, int heads, int n_tok,
                 int cls_pad, int act, float eps, float scale, void* trace, void* stream) {
  if (d != heads * ST_DH || d % ST_BN || d > 8 * SK_THREADS || m % ST_BN || depth < 1 ||
      n_tok < 1 || n_tok > n_pad || n_tok > ST_MAX_KV || batch < 1 || batch > FULL_MAX_BATCH ||
      cls_pad < HEAD_COLS || cls_pad % HEAD_COLS || !patches_ok(img_h, img_w, patch, n_tok) ||
      (act != ACT_GELU_TANH && act != ACT_QUICK_GELU))
    return cudaErrorInvalidValue;
  FullArgs a;
  StackArgs& s = a.s;
  FullWork fw;
  full_work_layout(static_cast<unsigned char*>(work), batch * n_pad, d, m, 3 * patch * patch, &fw);
  s.x = nullptr;
  s.tok = fw.tok;
  s.work = static_cast<unsigned char*>(work);
  s.ls1 = static_cast<const float*>(ls1);
  s.lb1 = static_cast<const float*>(lb1);
  s.wqkv = static_cast<const bf16*>(wqkv);
  s.bqkv = static_cast<const float*>(bqkv);
  s.wo = static_cast<const bf16*>(wo);
  s.bo = static_cast<const float*>(bo);
  s.ls2 = static_cast<const float*>(ls2);
  s.lb2 = static_cast<const float*>(lb2);
  s.w1 = static_cast<const bf16*>(w1);
  s.b1 = static_cast<const float*>(b1);
  s.w2 = static_cast<const bf16*>(w2);
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
  s.eps = eps;
  s.scale = scale;
  a.g = make_patches(img, img_f32, img_h, img_w, patch, n_tok);
  a.wp = static_cast<const bf16*>(wp);
  a.posb = static_cast<const float*>(posb);
  a.lfs = static_cast<const float*>(lfs);
  a.lfb = static_cast<const float*>(lfb);
  a.wh = static_cast<const bf16*>(wh);
  a.bh = static_cast<const float*>(bh);
  a.logits = static_cast<float*>(logits);
  a.cls_pad = cls_pad;
  const int kvp = (n_tok + 15) / 16 * 16;
  return coop_launch(reinterpret_cast<const void*>(full_kernel), &a, stack_smem_bytes(kvp),
                     trace != nullptr, reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
