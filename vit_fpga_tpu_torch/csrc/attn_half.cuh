// The attention half's launch sequence on Hopper's units, shared by K1
// (attn_stats.cu, from the producer's LN statistics) and K4 (attn_block.cu,
// after its own row_stats); include after gemm_wgmma.cuh and mha_wgmma.cuh.
//
//   (a) gw_kernel<LN>       qkv = bf16(LN(x; mu, rstd, ls, lb) @ Wqkv + bqkv)
//   (b) mha_wgmma_kernel    per (128 query rows, image x head), keys at or
//                           past n_valid masked, streamed in 128-key tiles
//                           at any length (the wrappers take the JAX
//                           planner's geometry, up to 3137 tokens at
//                           ViT-B/16): MODE MW_MAXFREE e = exp(clip(s *
//                           scale, -70, 80)) in one pass, or MW_SAFE e =
//                           exp(s * scale - max) after a pass for the row
//                           max; ao = bf16((bf16(e) @ v) * (1 / sum(e)))
//   (c) gw_kernel           out = x + bf16(ao @ Wo + bo)
//
// (b) reads the packed qkv scratch through 4-D tensor maps, {64, rows,
// heads, batch} (and at head dim 80 a second {16, ...} map of columns
// 64..79): Q's row extent n_pad, K's and V's n_valid (mha_wgmma.cuh's
// launch_mha_packed).  K1 runs at head dim 64, K4 at 64 or 80 (DH).

#pragma once

namespace VFT_NS {

constexpr int AH_LONG_KEYS = 256;    // more valid keys: counted apart (*long_path)

// Finds the driver's tensor-map encoder and opts the GEMM and the attention
// in MODE in to their shared memory, on the current device.
template <int MODE>
inline cudaError_t attn_half_enable() {
  cudaError_t err = tma_init();
  if (err != cudaSuccess) return err;
  if ((err = gw_enable()) != cudaSuccess) return err;
  return mha_wgmma_enable<MODE>();
}

// x, out: (B * n_pad, D) bf16; stats: (B * n_pad, 2) f32; ls, lb, bo: (D,)
// f32; wqkv: (D, 3D) bf16; bqkv: (3D,) f32; wo: (D, D) bf16; qkv (B *
// n_pad, 3D) and ao (B * n_pad, D) bf16 scratch; every pointer 16-byte
// aligned.  Head dim DH, 1 <= n_valid <= n_pad, batch x heads <=
// MW_MAX_GRID_Y (the attention's grid rows); the keys stream through the
// ring, so no bound on n_pad is set here.  *long_path is set
// to 1 when more than 256 keys are valid (the same kernels; the launch
// checks count those launches apart) and 0 otherwise.  Enqueues (a)-(c) on
// `st`.
template <int MODE, int DH = 64>
inline cudaError_t launch_attn_half(const bf16* x, const float* stats, const float* ls,
                                    const float* lb, const bf16* wqkv, const float* bqkv,
                                    const bf16* wo, const float* bo, bf16* out, bf16* qkv,
                                    bf16* ao, int batch, int n_pad, int d, int heads, int n_valid,
                                    float scale, cudaStream_t st, int* long_path) {
  static_assert(MODE == MW_MAXFREE || MODE == MW_SAFE, "the attention half's two softmaxes");
  if (d != heads * DH || batch < 1 || n_valid < 1 || n_valid > n_pad ||
      (long long)batch * heads > MW_MAX_GRID_Y)
    return cudaErrorInvalidValue;
  if (tma_encoder() == nullptr) return cudaErrorInitializationError;
  const int rows = batch * n_pad;
  cudaError_t err;

  GwArgs g{};
  g.stats = stats;
  g.ln_scale = ls;
  g.ln_bias = lb;
  g.bias = bqkv;
  g.C = qkv;
  g.M = rows;
  g.N = 3 * d;
  g.K = d;
  g.act = ACT_NONE;
  if ((err = launch_gemm_wgmma(x, wqkv, true, g, st)) != cudaSuccess) return err;

  *long_path = n_valid > AH_LONG_KEYS;
  if ((err = launch_mha_packed<MODE, false, DH>(qkv, ao, batch, n_pad, d, heads, n_valid, scale,
                                                st)) != cudaSuccess)
    return err;

  GwArgs o{};
  o.bias = bo;
  o.residual = x;
  o.C = out;
  o.M = rows;
  o.N = d;
  o.K = d;
  o.act = ACT_NONE;
  return launch_gemm_wgmma(ao, wo, false, o, st);
}

}  // namespace VFT_NS
