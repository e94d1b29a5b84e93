// Whole bf16 ViT forward in one launch on Hopper (sm_90a): image in, class
// logits out, the batch-1 latency serving path's single-launch forward.
//
// Replaces vit_fpga_tpu/ops/vit_stack.py:_stack_full_kernel (wrapper
// vit_full_pallas), one Pallas kernel whose grid walks the layers with the
// patch-embed GEMM before the first and the final LayerNorm and head after
// the last.  Here one cooperative persistent grid (stack_wgmma.cuh, its
// bf16 variant LQ_BF16: a producer and two consumer warpgroups a block,
// one ring of TMA stages) runs:
//
//   (p) rows   pp = the padded patch matrix, gathered from the NHWC image
//              (full.cuh: the CLS row and the tail rows zero); one warp a
//              row
//   (e) items  tok = bf16(pp Wp + posb), f32 sums: bf16 wgmma, pp and Wp
//              by TMA; posb is the (n_pad, D) f32 fold of the CLS token,
//              position table and patch bias
//   (0) rows   xn = bf16(LN1(tok))
//   per layer: the stages (a)-(g) of stack_wgmma.cuh on 128 x 64 bf16
//              items (wgmma.m64n64k16, the (K, N) weights through the
//              transpose bit), the attention on mha_wgmma.cuh's max-free
//              sweep, split-K f32 partials summed in slice order by the row
//              stages; after the last layer each image's first (CLS) row
//              takes the final one-pass LayerNorm, xn = bf16(LNf(tok)): the
//              JAX kernel casts it to the head weight's dtype
//   (h) items  logits = xn Wh + bh in f32 for each image's CLS row, the
//              padded classes split in 8-column items over the grid
//
// What bounds it on the H100: at ViT-B/16 batch 1 (197 tokens) it reads
// 169.9 MB of layer weights plus Wp (1.2 MB), the 1024-column head
// (1.6 MB) and posb (0.6 MB), 173.3 MB in all (51.7 us at 3.35 TB/s),
// for 35.1 GFLOP (35.5 us at 989 TFLOP/s): bound by bytes.  The embed adds
// two grid barriers before the layers and the head one after them.

#define VFT_NS vit_full
#include "common.cuh"
#include "quant.cuh"
#include "hopper.cuh"
#include "qgemm_wgmma.cuh"
#include "gemm_wgmma.cuh"
#include "mha_wgmma.cuh"
#include "stack.cuh"
#include "stack_wgmma.cuh"
#include "full.cuh"

using namespace VFT_NS;

namespace VFT_NS {

struct FullArgs {
  LqArgs s;           // s.tok lives in the workspace; s.x is unused
  Patches g;
  const bf16* wh;     // (D, cls_pad)
  const float* bh;    // (cls_pad,)
  float* logits;      // (B, cls_pad)
  int cls_pad;
};

struct FullWork {
  LqWork w;
  bf16* tok;  // (R, D)
  bf16* pp;   // (R, p3)
};

__host__ __device__ inline size_t full_work_layout(unsigned char* base, int rows, int d, int m,
                                                   int p3, FullWork* fw) {
  LqWork w;
  size_t off = lq_work_layout(base, rows, d, m, LQ_BF16, &w);
  bf16* tok = reinterpret_cast<bf16*>(base + off);
  off += align256((size_t)rows * d * 2);
  bf16* pp = reinterpret_cast<bf16*>(base + off);
  off += align256((size_t)rows * p3 * 2);
  if (fw != nullptr) *fw = FullWork{w, tok, pp};
  return off;
}

// pp[row] from the image, one warp a row.
__device__ __forceinline__ void patch_row(const Patches& g, int n_pad, bf16* pp, int row) {
  const int lane = threadIdx.x & 31, b = row / n_pad, t = row % n_pad;
  for (int c = 8 * lane; c < g.p3; c += 256) {
    float f[8];
    patch_chunk(g, b, t, c, f);
    *reinterpret_cast<uint4*>(pp + (size_t)row * g.p3 + c) = pack8(f);
  }
}

// logits[b, c0 .. c0 + 7] = xn[b * n_pad] Wh[:, c0 .. c0 + 7] + bh, f32
// sums: each thread a slice of k, then the warps' sums in a fixed order.
__device__ __forceinline__ void head_stage(const FullArgs& a, const bf16* xn) {
  __shared__ float red[LQ_THREADS / 32][FULL_MAX_BATCH * HEAD_COLS];
  const LqArgs& p = a.s;
  const int d = p.d, nb = p.batch;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int it = blockIdx.x; it < a.cls_pad / HEAD_COLS; it += gridDim.x) {
    const int c0 = it * HEAD_COLS;
    float acc[FULL_MAX_BATCH][HEAD_COLS];
#pragma unroll
    for (int b = 0; b < FULL_MAX_BATCH; ++b)
#pragma unroll
      for (int j = 0; j < HEAD_COLS; ++j) acc[b][j] = 0.0f;
    for (int k = threadIdx.x; k < d; k += LQ_THREADS) {
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
      for (int w = 0; w < LQ_THREADS / 32; ++w) s += red[w][threadIdx.x];
      const int b = threadIdx.x / HEAD_COLS, j = threadIdx.x % HEAD_COLS;
      a.logits[(size_t)b * a.cls_pad + c0 + j] = __fadd_rn(s, a.bh[c0 + j]);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(LQ_THREADS, 1) full_kernel(const __grid_constant__ FullArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const LqArgs& p = a.s;
  const int rows = p.batch * p.n_pad;
  LqRing<LQ_BF16> r = lq_ring<LQ_BF16>(smem);
  StageClock clk{p.trace};
  clk.start();
  if (lq_producer()) lq_prefill(lq_layer_gemm<LQ_BF16>(p, 0, -1), r);
  {
    FullWork fw;
    full_work_layout(p.work, rows, p.d, p.m, a.g.p3, &fw);
    for (int row = (threadIdx.x >> 5) * gridDim.x + blockIdx.x; row < rows;
         row += (LQ_THREADS / 32) * gridDim.x)
      patch_row(a.g, p.n_pad, fw.pp, row);
  }
  fence_proxy_async_global();  // pp is read by the embed's TMA
  clk.sync(grid, LQ_T_PATCH);
  if (!lq_consumer()) {
    lq_producer_regs();
    lq_layers_producer(p, r, clk, grid);
  } else {
    lq_consumer_regs();
    lq_layers_consumer(p, r, clk, grid);
  }
  lq_even_regs();
  clk.sync(grid, LQ_T_RES_LN1);
  head_stage(a, static_cast<const bf16*>(lq_work<LQ_BF16>(p).xq));
  clk.work_done(LQ_T_HEAD);
}

}  // namespace VFT_NS

extern "C" {

// Finds cuTensorMapEncodeTiled (tma_init) and opts the kernel in to its
// shared memory, on the current device.  Returns a cudaError_t.
int vft_vit_full_init() {
  cudaError_t err = tma_init();
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(full_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)lq_smem_bytes(LQ_BF16));
}

// Bytes of scratch vft_vit_full needs at `rows` = B * n_pad token rows.
size_t vft_vit_full_workspace(int rows, int d, int m, int p3) {
  return full_work_layout(nullptr, rows, d, m, p3, nullptr);
}

// img: (B, H, W, 3) f32 (img_f32 = 1) or bf16 NHWC images; logits: (B,
// cls_pad) f32; work: vft_vit_full_workspace bytes; wp (p3, D) bf16 with
// p3 = 3 * patch^2 a multiple of 16 up to FULL_MAX_P3; posb (n_pad, D)
// f32; wqkv (L, D, 3D), wo (L, D, D), w1 (L, D, M), w2 (L, M, D) bf16,
// the per-layer f32 vectors stacked (L, .); lfs, lfb (D,) f32; wh (D,
// cls_pad) bf16, bh (cls_pad,) f32, cls_pad a multiple of 8; the weights
// 16-byte aligned.  Head dim 64, D a multiple of 64 up to 2048, M a
// multiple of 64; n_tok = 1 + (H / patch) * (W / patch) <= min(n_pad,
// 256), batch 1..4.  Enqueued on `stream`, which belongs to the current
// device.  Returns a cudaError_t.
int vft_vit_full(const void* img, void* logits, void* work, const void* wp, const void* posb,
                 const void* ls1, const void* lb1, const void* wqkv, const void* bqkv,
                 const void* wo, const void* bo, const void* ls2, const void* lb2, const void* w1,
                 const void* b1, const void* w2, const void* b2, const void* lfs, const void* lfb,
                 const void* wh, const void* bh, int img_f32, int img_h, int img_w, int patch,
                 int batch, int n_pad, int d, int m, int depth, int heads, int n_tok,
                 int cls_pad, int act, float eps, float scale, void* trace, void* stream) {
  if (d != heads * ST_DH || d % ST_DH || d > LQ_MAX_D || m % ST_DH || m < ST_DH || depth < 1 ||
      n_tok < 1 || n_tok > n_pad || n_tok > ST_MAX_KV || batch < 1 || batch > FULL_MAX_BATCH ||
      cls_pad < HEAD_COLS || cls_pad % HEAD_COLS || !patches_ok(img_h, img_w, patch, n_tok) ||
      (act != ACT_GELU_TANH && act != ACT_QUICK_GELU))
    return cudaErrorInvalidValue;
  if (tma_encoder() == nullptr) return cudaErrorInitializationError;
  if (!lq_aligned(wqkv) || !lq_aligned(wo) || !lq_aligned(w1) || !lq_aligned(w2) ||
      !lq_aligned(wp) || !lq_aligned(work))
    return cudaErrorMisalignedAddress;
  const int rows = batch * n_pad, p3 = 3 * patch * patch;
  FullArgs a;
  LqArgs& s = a.s;
  FullWork fw;
  full_work_layout(static_cast<unsigned char*>(work), rows, d, m, p3, &fw);
  s.x = nullptr;
  s.tok = fw.tok;
  s.work = static_cast<unsigned char*>(work);
  s.ls1 = static_cast<const float*>(ls1);
  s.lb1 = static_cast<const float*>(lb1);
  s.bqkv = static_cast<const float*>(bqkv);
  s.bo = static_cast<const float*>(bo);
  s.ls2 = static_cast<const float*>(ls2);
  s.lb2 = static_cast<const float*>(lb2);
  s.b1 = static_cast<const float*>(b1);
  s.b2 = static_cast<const float*>(b2);
  s.sqkv = s.so = s.s1 = s.s2 = s.inv_ao = s.inv_ah = s.wps = nullptr;
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
  s.posb = static_cast<const float*>(posb);
  s.lfs = static_cast<const float*>(lfs);
  s.lfb = static_cast<const float*>(lfb);
  s.p3 = p3;
  a.g = make_patches(img, img_f32, img_h, img_w, patch, n_tok);
  a.wh = static_cast<const bf16*>(wh);
  a.bh = static_cast<const float*>(bh);
  a.logits = static_cast<float*>(logits);
  a.cls_pad = cls_pad;
  if (!lq_encode_layers<LQ_BF16>(&s.maps, fw.w, wqkv, wo, w1, w2, batch, n_pad, d, m, depth,
                                 heads, n_tok) ||
      !lq_encode_bf16(&s.maps.pq, fw.pp, rows, p3) ||
      !lq_encode_bf16(&s.maps.wp, wp, p3, d, GW_BK))
    return cudaErrorInvalidValue;
  return coop_launch(reinterpret_cast<const void*>(full_kernel), &a, lq_smem_bytes(LQ_BF16),
                     trace != nullptr, reinterpret_cast<cudaStream_t>(stream), LQ_THREADS);
}

}  // extern "C"
