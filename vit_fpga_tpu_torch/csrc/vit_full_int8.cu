// Whole dynamic-int8 ViT forward in one launch on Hopper (sm_90a): image
// in, class logits out, the batch-1 int8 latency serving path's
// single-launch forward.
//
// Replaces vit_fpga_tpu/ops/vit_stack.py:_stack_full_int8_kernel (wrapper
// vit_full_int8_pallas): K19a's layers with an int8 patch embed before
// them and the final LayerNorm and an int8 head after them.  One
// cooperative persistent grid (stack_wgmma.cuh, LQ_DYN: a producer and two
// consumer warpgroups a block, one ring of TMA stages) runs:
//
//   (p) rows   pq, sp = rowquant(bf16 patch row) for every padded token row,
//              gathered from the NHWC image (full.cuh); the all-zero CLS
//              and tail rows quantize to 0; one warp a row
//   (e) items  tok = bf16(float(pq wpq) * (sp * wps) + posb): int8 wgmma,
//              pq and wpq by TMA
//   (0) rows   xq, sx = rowquant(LN1(tok))
//   per layer: K19a's stages (a)-(g) (stack_wgmma.cuh); after the last
//              layer each image's first (CLS) row takes the final one-pass
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
#include "hopper.cuh"
#include "qgemm_wgmma.cuh"
#include "gemm_wgmma.cuh"
#include "mha_wgmma.cuh"
#include "stack.cuh"
#include "stack_wgmma.cuh"
#include "full.cuh"

using namespace VFT_NS;

namespace VFT_NS {

struct FullI8Args {
  LqArgs s;                  // s.tok lives in the workspace; s.x is unused
  Patches g;
  const signed char* whq;    // (D, cls_pad) row-major
  const float* whs;          // (cls_pad,)
  const float* bh;           // (cls_pad,)
  float* logits;             // (B, cls_pad)
  int cls_pad;
};

struct FullI8Work {
  LqWork w;
  bf16* tok;         // (R, D)
  signed char* pq;   // (R, p3)
};

__host__ __device__ inline size_t full_work_layout_i8(unsigned char* base, int rows, int d, int m,
                                                      int p3, FullI8Work* fw) {
  LqWork w;
  size_t off = lq_work_layout(base, rows, d, m, LQ_DYN, &w);
  bf16* tok = reinterpret_cast<bf16*>(base + off);
  off += align256((size_t)rows * d * 2);
  signed char* pq = reinterpret_cast<signed char*>(base + off);
  off += align256((size_t)rows * p3);
  if (fw != nullptr) *fw = FullI8Work{w, tok, pq};
  return off;
}

// pq[row], sp[row] = rowquant(the bf16 patch row), one warp a row: the
// row's absmax, then its chunks gathered again and quantized.
__device__ __forceinline__ void patch_quant_row(const Patches& g, int n_pad, signed char* pq,
                                                float* sp, int row) {
  const int lane = threadIdx.x & 31, b = row / n_pad, t = row % n_pad;
  float amax = 0.0f;
  for (int c = 8 * lane; c < g.p3; c += 256) {
    float f[8];
    patch_chunk(g, b, t, c, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(f[e]));
  }
  const float qs = __fdiv_rn(fmaxf(warp_max(amax), 1e-12f), 127.0f);
  const float rq = __fdiv_rn(1.0f, qs);
  for (int c = 8 * lane; c < g.p3; c += 256) {
    float f[8];
    patch_chunk(g, b, t, c, f);
    *reinterpret_cast<uint2*>(pq + (size_t)row * g.p3 + c) =
        make_uint2(lq_q4(f[0], f[1], f[2], f[3], qs, rq), lq_q4(f[4], f[5], f[6], f[7], qs, rq));
  }
  if (lane == 0) sp[row] = qs;
}

// logits[b, c0 .. c0 + 7] = float(rq[b * n_pad] whq[:, c0 .. c0 + 7]) *
// (rs * whs) + bh: exact int32 sums, each thread a slice of k.
__device__ __forceinline__ void head_stage_i8(const FullI8Args& a, const signed char* rq,
                                              const float* rs) {
  __shared__ int red[LQ_THREADS / 32][FULL_MAX_BATCH * HEAD_COLS];
  const LqArgs& p = a.s;
  const int d = p.d, nb = p.batch;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int it = blockIdx.x; it < a.cls_pad / HEAD_COLS; it += gridDim.x) {
    const int c0 = it * HEAD_COLS;
    int acc[FULL_MAX_BATCH][HEAD_COLS];
#pragma unroll
    for (int b = 0; b < FULL_MAX_BATCH; ++b)
#pragma unroll
      for (int j = 0; j < HEAD_COLS; ++j) acc[b][j] = 0;
    for (int k = threadIdx.x; k < d; k += LQ_THREADS) {
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
      for (int w = 0; w < LQ_THREADS / 32; ++w) s += red[w][threadIdx.x];
      const int b = threadIdx.x / HEAD_COLS, c = c0 + threadIdx.x % HEAD_COLS;
      a.logits[(size_t)b * a.cls_pad + c] =
          dequant(s, __ldcg(rs + (size_t)b * p.n_pad), a.whs[c], a.bh[c]);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(LQ_THREADS, 1) full_int8_kernel(const __grid_constant__ FullI8Args a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const LqArgs& p = a.s;
  const int rows = p.batch * p.n_pad, d = p.d;
  LqRing<LQ_DYN> r = lq_ring<LQ_DYN>(smem);
  StageClock clk{p.trace};
  clk.start();
  if (lq_producer()) lq_prefill(lq_layer_gemm<LQ_DYN>(p, 0, -1), r);
  {
    FullI8Work fw;
    full_work_layout_i8(p.work, rows, d, p.m, a.g.p3, &fw);
    for (int row = (threadIdx.x >> 5) * gridDim.x + blockIdx.x; row < rows;
         row += (LQ_THREADS / 32) * gridDim.x)
      patch_quant_row(a.g, p.n_pad, fw.pq, fw.w.sx, row);
  }
  fence_proxy_async_global();  // pq is read by the embed's TMA
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
  {
    const LqWork w = lq_work<LQ_DYN>(p);
    head_stage_i8(a, static_cast<const signed char*>(w.xq), w.sx);
  }
  clk.work_done(LQ_T_HEAD);
}

}  // namespace VFT_NS

extern "C" {

// Finds the driver's tensor-map encoder and opts the kernel in to its
// shared memory, on the current device.  Returns a cudaError_t.
int vft_vit_full_int8_init() {
  cudaError_t err = tma_init();
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(full_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)lq_smem_bytes(LQ_DYN));
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
  if (d != heads * ST_DH || d % ST_DH || d > LQ_MAX_D || m % ST_DH || m < ST_DH ||
      m > LQ_MAX_M || depth < 1 || n_tok < 1 || n_tok > n_pad || n_tok > ST_MAX_KV ||
      batch < 1 || batch > FULL_MAX_BATCH || cls_pad < HEAD_COLS || cls_pad % HEAD_COLS ||
      !patches_ok(img_h, img_w, patch, n_tok) || (act != ACT_GELU_TANH && act != ACT_QUICK_GELU))
    return cudaErrorInvalidValue;
  if (tma_encoder() == nullptr) return cudaErrorInitializationError;
  if (!lq_aligned(wqkv) || !lq_aligned(wo) || !lq_aligned(w1) || !lq_aligned(w2) ||
      !lq_aligned(wpq) || !lq_aligned(work))
    return cudaErrorMisalignedAddress;
  const int rows = batch * n_pad, p3 = 3 * patch * patch;
  FullI8Args a;
  LqArgs& s = a.s;
  FullI8Work fw;
  full_work_layout_i8(static_cast<unsigned char*>(work), rows, d, m, p3, &fw);
  s.x = nullptr;
  s.tok = fw.tok;
  s.work = static_cast<unsigned char*>(work);
  s.ls1 = static_cast<const float*>(ls1);
  s.lb1 = static_cast<const float*>(lb1);
  s.sqkv = static_cast<const float*>(sqkv);
  s.bqkv = static_cast<const float*>(bqkv);
  s.so = static_cast<const float*>(so);
  s.bo = static_cast<const float*>(bo);
  s.ls2 = static_cast<const float*>(ls2);
  s.lb2 = static_cast<const float*>(lb2);
  s.s1 = static_cast<const float*>(s1);
  s.b1 = static_cast<const float*>(b1);
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
  s.eps = eps;
  s.scale = scale;
  s.inv_ao = s.inv_ah = nullptr;
  s.wps = static_cast<const float*>(wps);
  s.posb = static_cast<const float*>(posb);
  s.lfs = static_cast<const float*>(lfs);
  s.lfb = static_cast<const float*>(lfb);
  s.p3 = p3;
  a.g = make_patches(img, img_f32, img_h, img_w, patch, n_tok);
  a.whq = static_cast<const signed char*>(whq);
  a.whs = static_cast<const float*>(whs);
  a.bh = static_cast<const float*>(bh);
  a.logits = static_cast<float*>(logits);
  a.cls_pad = cls_pad;
  if (!lq_encode_layers<LQ_DYN>(&s.maps, fw.w, wqkv, wo, w1, w2, batch, n_pad, d, m, depth,
                                heads, n_tok) ||
      !lq_encode_rows(&s.maps.pq, fw.pq, rows, p3) ||
      !lq_encode_rows(&s.maps.wp, wpq, d, p3, LQ_BN))
    return cudaErrorInvalidValue;
  return coop_launch(reinterpret_cast<const void*>(full_int8_kernel), &a, lq_smem_bytes(LQ_DYN),
                     trace != nullptr, reinterpret_cast<cudaStream_t>(stream), LQ_THREADS);
}

}  // extern "C"
