// The attention half in f32 (K1's and K4's f32 mode): three launches on
// one stream, true f32 fma on the CUDA cores throughout; include after
// common.cuh, gemm_f32.cuh and seq_attn.cuh.
//
//   (a) gemm_f32_kernel<FG_PRO_LN, FG_EPI_BIAS>
//           qkv = LN(x; mu, rstd, ls, lb) @ Wqkv + bqkv, the LayerNorm
//           applied as x's slices land
//   (b) seq_attn_f32_kernel<DH, SF_HALF_MAXFREE | SF_ONLINE>
//           per (128 query rows, image x head) on the packed qkv: q scaled,
//           the max-free softmax exp(clip(s, -70, 80)), ao = (e v) *
//           (1 / sum e); or the exact one by a running max (K4's
//           safe_softmax); keys at or past n_valid masked
//   (c) gemm_f32_kernel<FG_PRO_NONE, FG_EPI_BIAS_RESID>
//           out = x + (ao @ Wo + bo)
//
// (mu, rstd) come from the previous half (K1) or from a row pass over x
// (K4).  What bounds it on the H100: at ViT-B/16 b64 8 R D^2 + 4 B H n_pad
// n_valid dh = 68 GFLOP at 67 TFLOP/s (1.02 ms), against about 88 MB of
// compulsory traffic (26 us): the CUDA cores' f32 rate.  qkv and ao
// round-trip through device memory (79 + 39 MB at ViT-B/16 b64).

#pragma once

namespace VFT_NS {

constexpr int AHF_LONG_KEYS = 256;  // more valid keys: counted apart (*long_path)

template <int DH, int MODE>
inline cudaError_t launch_attn_half_f32(const float* x, const float* stats, const float* ls,
                                        const float* lb, const float* wqkv, const float* bqkv,
                                        const float* wo, const float* bo, float* out, float* qkv,
                                        float* ao, int batch, int n_pad, int d, int heads,
                                        int n_valid, float scale, cudaStream_t st,
                                        int* long_path) {
  if (d != heads * DH || batch < 1 || n_valid < 1 || n_valid > n_pad) return cudaErrorInvalidValue;
  const int rows = batch * n_pad;
  cudaError_t err;

  FgArgs g{};
  g.A = x;
  g.B = wqkv;
  g.C = qkv;
  g.M = rows;
  g.N = 3 * d;
  g.K = d;
  g.stats = stats;
  g.ls = ls;
  g.lb = lb;
  g.bias = bqkv;
  if ((err = launch_gemm_f32<FG_PRO_LN, FG_EPI_BIAS>(g, st)) != cudaSuccess) return err;

  *long_path = n_valid > AHF_LONG_KEYS;
  const SeqAttnArgs a{qkv,       qkv + d, qkv + 2 * d, ao,    (long long)n_pad * 3 * d,
                      DH,        3 * d,   (long long)n_pad * d, DH, d,
                      heads,     n_pad,   n_valid,     scale};
  if ((err = launch_seq_attn_f32<DH, MODE>(a, batch, st)) != cudaSuccess) return err;

  FgArgs o{};
  o.A = ao;
  o.B = wo;
  o.C = out;
  o.M = rows;
  o.N = d;
  o.K = d;
  o.bias = bo;
  o.resid = x;
  return launch_gemm_f32<FG_PRO_NONE, FG_EPI_BIAS_RESID>(o, st);
}

}  // namespace VFT_NS
