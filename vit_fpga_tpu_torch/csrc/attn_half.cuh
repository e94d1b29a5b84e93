// The attention half's launch sequence on Hopper's units, shared by K1
// (attn_stats.cu, from the producer's LN statistics) and K4 (attn_block.cu,
// after its own row_stats); include after gemm_wgmma.cuh and mha_wgmma.cuh.
//
//   (a) gw_kernel<LN>       qkv = bf16(LN(x; mu, rstd, ls, lb) @ Wqkv + bqkv)
//   (b) mha_wgmma_kernel    per (128 query rows, image x head), keys at or
//                           past n_valid masked, over 128-key tiles for
//                           every length the gate takes (up to 1024
//                           tokens): MODE MW_MAXFREE e = exp(clip(s * scale,
//                           -70, 80)) in one pass, or MW_SAFE e = exp(s *
//                           scale - max) after a pass for the row max; ao =
//                           bf16((bf16(e) @ v) * (1 / sum(e)))
//   (c) gw_kernel           out = x + bf16(ao @ Wo + bo)
//
// (b) reads the packed qkv scratch through 4-D tensor maps, {64, rows,
// heads, batch}: Q's row extent n_pad, K's and V's n_valid.

#pragma once

namespace VFT_NS {

constexpr int AH_DH = 64;            // head dim
constexpr int AH_LONG_KEYS = 256;    // more valid keys: counted apart (*long_path)
constexpr int AH_MAX_TOKENS = 1024;  // n_pad the gate takes

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
// aligned.  Head dim 64, 1 <= n_valid <= n_pad <= 1024.  *long_path is set
// to 1 when more than 256 keys are valid (the same kernels; the launch
// checks count those launches apart) and 0 otherwise.  Enqueues (a)-(c) on
// `st`.
template <int MODE>
inline cudaError_t launch_attn_half(const bf16* x, const float* stats, const float* ls,
                                    const float* lb, const bf16* wqkv, const float* bqkv,
                                    const bf16* wo, const float* bo, bf16* out, bf16* qkv,
                                    bf16* ao, int batch, int n_pad, int d, int heads, int n_valid,
                                    float scale, cudaStream_t st, int* long_path) {
  static_assert(MODE == MW_MAXFREE || MODE == MW_SAFE, "the attention half's two softmaxes");
  if (d != heads * AH_DH || batch < 1 || n_valid < 1 || n_valid > n_pad ||
      n_pad > AH_MAX_TOKENS)
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

  // q, k and v are column blocks of the packed rows: head h at h * 64 of
  // each, row stride 3D, image stride n_pad * 3D.
  const long long in_b = (long long)n_pad * 3 * d;
  CUtensorMap tq, tk, tv;
  if (!mw_encode(&tq, qkv, in_b, AH_DH, 3 * d, n_pad, heads, batch) ||
      !mw_encode(&tk, qkv + d, in_b, AH_DH, 3 * d, n_valid, heads, batch) ||
      !mw_encode(&tv, qkv + 2 * d, in_b, AH_DH, 3 * d, n_valid, heads, batch))
    return cudaErrorInvalidValue;
  const MhaTmaArgs a{ao,     (long long)n_pad * d, AH_DH, d, heads, n_pad, n_valid,
                     scale * 1.4426950408889634f, scale};
  *long_path = n_valid > AH_LONG_KEYS;
  if ((err = launch_mha_wgmma<MODE>(tq, tk, tv, a, batch, st)) != cudaSuccess) return err;

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
