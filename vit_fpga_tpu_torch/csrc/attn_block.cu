// Per-block attention half on Hopper (sm_90a), the forward the training
// path and safe-softmax serving run.
//
// Replaces vit_fpga_tpu/ops/attn_block.py:_attn_block_kernel (wrapper
// attn_block_pallas), one Pallas kernel on the TPU.  It is K1
// (attn_stats.cu) with the LayerNorm statistics computed here and a choice
// of softmax.  A short sequence of launches on one stream, counted as one
// ported kernel:
//
//   (a) row_stats       one-pass (mu, rstd) of x, as the TPU kernel
//   (b) gemm_bf16<LN>   qkv = bf16(LN(x; mu, rstd, ls, lb) @ Wqkv + bqkv)
//   (c) attn_kernel     per (image, head): s = (q k^T) * scale in f32, keys
//                       at or past n_valid masked; e = exp(s - max) (safe) or
//                       exp(clip(s, -70, 80)) (max-free);
//                       ao = bf16((bf16(e) @ v) * (1 / sum(e)));
//                       past ATT_MAX_KV (256) keys attn_long_kernel, the
//                       same function with the keys streamed in 64-key
//                       tiles (attn.cuh), up to ATT_MAX_LONG (1024) tokens:
//                       max-free in one sweep, safe in two (the row max
//                       first, then e against it)
//   (d) gemm_bf16       out = x + bf16(ao @ Wo + bo)
//
// What bounds it on the H100: at ViT-B/16 batch 64 the launch does about
// 68 GFLOP against 44 MB of compulsory traffic, so it is bound by
// tensor-core operations (about 69 us at 989 TFLOP/s), as K1.  The design
// is K1's: LN applied to the A tiles in shared memory, one attention block
// per (image, head) holding the head's keys and values, scores and
// probabilities in shared memory; qkv and the attention output
// round-trip through device memory, and the GEMMs use wmma fragments
// (wgmma is later work).  Past 256 keys a block no longer holds a head's
// keys and values, so the key-tiled tile streams them, and in the safe
// mode computes QK^T twice (CLIP ViT-L/14 at batch 1: 257 tokens, 16
// heads; ViT-B/16 @384: 577 tokens).

#define VFT_NS attn_block
#include "common.cuh"
#include "attn.cuh"

using namespace VFT_NS;

extern "C" {

// Opts this unit's kernels in to the shared memory they may use, on the
// current device.  Called once per device before the first launch.
// Returns a cudaError_t.
int vft_attn_block_init() {
  cudaError_t err = gemm_init();
  if (err != cudaSuccess) return err;
  if ((err = attn_enable<true>()) != cudaSuccess) return err;
  if ((err = attn_enable<false>()) != cudaSuccess) return err;
  if ((err = attn_long_enable<true>()) != cudaSuccess) return err;
  return attn_long_enable<false>();
}

// x, out: (B * n_pad, D) bf16; ls, lb, bo: (D,) f32; wqkv: (D, 3D) bf16;
// bqkv: (3D,) f32; wo: (D, D) bf16.  Scratch: stats (B * n_pad, 2) f32,
// qkv (B * n_pad, 3D) and ao (B * n_pad, D) bf16.  Head dim 64,
// 1 <= n_valid <= n_pad <= ATT_MAX_LONG (1024): up to 256 valid keys take
// attn_kernel, more the key-tiled attn_long_kernel.  safe selects the
// max-subtract softmax.  *long_path is set to 1 when the key-tiled
// attn_long_kernel was launched and 0 otherwise; this entry is the only
// place that chooses.  Everything is enqueued on `stream`, which belongs
// to the current device.  Returns a cudaError_t.
int vft_attn_block_fwd(const void* x, const void* ls, const void* lb, const void* wqkv,
                       const void* bqkv, const void* wo, const void* bo, void* out, void* stats,
                       void* qkv, void* ao, int batch, int n_pad, int d, int heads, int n_valid,
                       int safe, float eps, float scale, void* stream, int* long_path) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int rows = batch * n_pad;
  const int kvp = (n_valid + 15) / 16 * 16;
  if (d != heads * ATT_DH || n_valid < 1 || n_valid > n_pad || n_pad > ATT_MAX_LONG)
    return cudaErrorInvalidValue;
  cudaError_t err;

  if ((err = launch_row_stats(static_cast<const bf16*>(x), static_cast<float*>(stats), rows, d,
                              eps, st)) != cudaSuccess)
    return err;

  GemmArgs g{};
  g.A = static_cast<const bf16*>(x);
  g.stats = static_cast<const float*>(stats);
  g.ln_scale = static_cast<const float*>(ls);
  g.ln_bias = static_cast<const float*>(lb);
  g.B = static_cast<const bf16*>(wqkv);
  g.bias = static_cast<const float*>(bqkv);
  g.C = qkv;
  g.M = rows;
  g.N = 3 * d;
  g.K = d;
  if ((err = launch_gemm(true, g, st)) != cudaSuccess) return err;

  const bf16* q = static_cast<const bf16*>(qkv);
  bf16* a = static_cast<bf16*>(ao);
  *long_path = kvp > ATT_MAX_KV;
  if (!*long_path)
    err = safe ? launch_attn<true>(q, a, batch, n_pad, n_valid, kvp, d, heads, scale, st)
               : launch_attn<false>(q, a, batch, n_pad, n_valid, kvp, d, heads, scale, st);
  else
    err = safe ? launch_attn_long<true>(q, a, batch, n_pad, n_valid, d, heads, scale, st)
               : launch_attn_long<false>(q, a, batch, n_pad, n_valid, d, heads, scale, st);
  if (err != cudaSuccess) return err;

  GemmArgs o{};
  o.A = static_cast<const bf16*>(ao);
  o.B = static_cast<const bf16*>(wo);
  o.bias = static_cast<const float*>(bo);
  o.residual = static_cast<const bf16*>(x);
  o.C = out;
  o.M = rows;
  o.N = d;
  o.K = d;
  if ((err = launch_gemm(false, o, st)) != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
