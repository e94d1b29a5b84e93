// Stats-chain attention half on Hopper (sm_90a).
//
// Replaces vit_fpga_tpu/ops/attn_block.py:_attn_stats_kernel (with its
// _mha_loop), one Pallas kernel on the TPU.  Here it is a short sequence of
// launches on one stream, counted as one ported kernel:
//
//   (a) gemm_bf16<LN>   qkv = bf16(LN(x; mu, rstd, ls, lb) @ Wqkv + bqkv)
//   (b) attn_kernel     per (image, head), one 16-row query tile per warp:
//                       s = (q k^T) * scale in f32, e = exp(clip(s, -70, 80))
//                       with keys at or past n_valid masked to 0,
//                       ao = bf16((bf16(e) @ v) * (1 / sum(e)))
//   (c) gemm_bf16       out = x + bf16(ao @ Wo + bo)
//   (d) row_stats       next (mu, rstd) of out, only when asked for
//
// What bounds it on the H100: at ViT-B/16 batch 64 the launch does about
// 68 GFLOP against 44 MB of traffic, so it is bound by tensor-core
// operations (about 69 us at 989 TFLOP/s).  The design keeps the
// normalised activations out of device memory (LN is applied to the A tile
// in shared memory), loads each head's keys and values once per image, and
// keeps each query tile's scores, probabilities and partial outputs in
// shared memory; the qkv and attention-output tensors (59 + 20 MB at
// ViT-B b64) still round-trip through device memory, and the GEMMs use
// wmma fragments rather than wgmma, which is later work.

#define VFT_NS attn_half
#include "common.cuh"
#include "attn.cuh"

using namespace VFT_NS;

extern "C" {

const char* vft_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// Opts this unit's kernels in to the shared memory they may use, on the
// current device (the attention block at ATT_MAX_KV keys needs 221 KB).
// Called once per device before the first launch.  Returns a cudaError_t.
int vft_attn_init() {
  cudaError_t err = gemm_init();
  if (err != cudaSuccess) return err;
  return attn_enable<false>();
}

// x, out: (B * n_pad, D) bf16; stats, stats_out: (B * n_pad, 2) f32;
// ls, lb, bo: (D,) f32; wqkv: (D, 3D) bf16; bqkv: (3D,) f32; wo: (D, D) bf16;
// qkv (B * n_pad, 3D) and ao (B * n_pad, D) are bf16 scratch.
// Head dim 64, 1 <= n_valid <= 256.  stats_out may be null (no next
// stats).  Everything is enqueued on `stream`, which belongs to the current
// device.  Returns a cudaError_t.
int vft_attn_block_stats(const void* x, const void* stats, const void* ls, const void* lb,
                         const void* wqkv, const void* bqkv, const void* wo, const void* bo,
                         void* out, void* stats_out, void* qkv, void* ao, int batch, int n_pad,
                         int d, int heads, int n_valid, float eps, float scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int rows = batch * n_pad;
  const int kvp = (n_valid + 15) / 16 * 16;
  if (d != heads * ATT_DH || n_valid < 1 || kvp > ATT_MAX_KV) return cudaErrorInvalidValue;
  cudaError_t err;

  GemmArgs g{};
  g.A = static_cast<const bf16*>(x);
  g.stats = static_cast<const float*>(stats);
  g.ln_scale = static_cast<const float*>(ls);
  g.ln_bias = static_cast<const float*>(lb);
  g.B = static_cast<const bf16*>(wqkv);
  g.bias = static_cast<const float*>(bqkv);
  g.residual = nullptr;
  g.C = static_cast<bf16*>(qkv);
  g.M = rows;
  g.N = 3 * d;
  g.K = d;
  g.act = ACT_NONE;
  if ((err = launch_gemm(true, g, st)) != cudaSuccess) return err;

  if ((err = launch_attn<false>(static_cast<const bf16*>(qkv), static_cast<bf16*>(ao), batch, n_pad,
                         n_valid, kvp, d, heads, scale, st)) != cudaSuccess)
    return err;

  GemmArgs o{};
  o.A = static_cast<const bf16*>(ao);
  o.B = static_cast<const bf16*>(wo);
  o.bias = static_cast<const float*>(bo);
  o.residual = static_cast<const bf16*>(x);
  o.C = static_cast<bf16*>(out);
  o.M = rows;
  o.N = d;
  o.K = d;
  o.act = ACT_NONE;
  if ((err = launch_gemm(false, o, st)) != cudaSuccess) return err;

  if (stats_out != nullptr &&
      (err = launch_row_stats(static_cast<const bf16*>(out), static_cast<float*>(stats_out),
                              rows, d, eps, st)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

}  // extern "C"
