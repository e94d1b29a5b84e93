// The bf16 single-launch encoder's layer pieces, shared by K11
// (vit_stack.cu) and K12 (vit_full.cu); include after stack.cuh.
//
//   per layer:
//   (a) tiles  qkv = bf16(xn Wqkv + bqkv)
//   (b) items  the max-free masked attention per (image, head, 32 query
//              rows) -> ao; idle blocks prefetch Wo, W1, W2 into L2
//   (c) tiles  split-K partials of ao Wo (f32)
//   (d) rows   tok = tok + bf16(sum of partials + bo); xn = bf16(LN2(tok))
//   (e) tiles  h = bf16(act(xn W1 + b1))
//   (f) tiles  split-K partials of h W2 (f32)
//   (g) rows   tok = tok + bf16(sum + b2); xn = bf16(LN1 of the next layer);
//              prefetch of the next layer's Wqkv.  After the last layer,
//              rows r with r % n_pad == 0 (the first row of each image)
//              take the final LayerNorm instead when one is given (K12).
//
// LN is the one-pass f32 LayerNorm, var = max(E[x^2] - mu^2, 0); act the
// fma-form tanh-GELU or quick_gelu.

#pragma once

namespace VFT_NS {

struct StackArgs {
  const bf16* x;   // (R, D) input tokens
  bf16* tok;       // (R, D) token state, the output
  unsigned char* work;
  const float* ls1;
  const float* lb1;
  const bf16* wqkv;  // (L, D, 3D)
  const float* bqkv;
  const bf16* wo;    // (L, D, D)
  const float* bo;
  const float* ls2;
  const float* lb2;
  const bf16* w1;    // (L, D, M)
  const float* b1;
  const bf16* w2;    // (L, M, D)
  const float* b2;
  long long* trace;  // optional StageClock buffer (stack.cuh)
  int batch, n_pad, d, m, depth, heads, n_valid, act;
  float eps, scale;
};

// Stage kinds of the StageClock trace.
enum { T_LN1 = 0, T_QKV, T_ATTN, T_OPROJ, T_RES_LN2, T_W1, T_W2, T_RES_LN1 };

struct Work {
  bf16* xn;    // (R, D)
  bf16* qkv;   // (R, 3D)
  bf16* ao;    // (R, D)
  bf16* h;     // (R, M)
  float* part; // (4, R, D)
};

__host__ __device__ inline size_t work_layout(unsigned char* base, int rows, int d, int m, Work* w) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = base + off;
    off += align256(bytes);
    return p;
  };
  bf16* xn = reinterpret_cast<bf16*>(take((size_t)rows * d * 2));
  bf16* qkv = reinterpret_cast<bf16*>(take((size_t)rows * 3 * d * 2));
  bf16* ao = reinterpret_cast<bf16*>(take((size_t)rows * d * 2));
  bf16* h = reinterpret_cast<bf16*>(take((size_t)rows * m * 2));
  float* part = reinterpret_cast<float*>(take((size_t)ST_MAX_SPLIT * rows * d * 4));
  if (w != nullptr) *w = Work{xn, qkv, ao, h, part};
  return off;
}

// One token row: tok = src (+ bf16(sum of nsplit partials + bias)), then,
// with ls, xn = bf16(((tok - mu) * rstd) * ls + lb).  One block per row,
// one 8-column chunk per thread (D <= 8 * SK_THREADS); every load is issued
// before the first is used.  Every thread of the block calls it.
__device__ __noinline__ void row_pass(const bf16* src, bf16* tok, const float* part, int nsplit,
                                      size_t pstride, const float* bias, const float* ls,
                                      const float* lb, bf16* xn, int row, int d, float eps) {
  const int c = threadIdx.x * 8;
  const bool on = c < d;
  const int cc = on ? c : 0;  // threads past d load column 0 and drop it
  const size_t off = (size_t)row * d + cc;
  float v[8], y[ST_MAX_SPLIT][8], bi[8], sc[8], sb[8];
  ldcg8(src + off, v);
  if (part != nullptr) {
#pragma unroll
    for (int k = 0; k < ST_MAX_SPLIT; ++k)
      if (k < nsplit) ldcg8f(part + k * pstride + off, y[k]);
    load8f(bias + cc, bi);
  }
  if (ls != nullptr) {
    load8f(ls + cc, sc);
    load8f(lb + cc, sb);
  }
  if (part != nullptr) {
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      float acc = y[0][t];
#pragma unroll
      for (int k = 1; k < ST_MAX_SPLIT; ++k)
        if (k < nsplit) acc = __fadd_rn(acc, y[k][t]);
      v[t] = bf16_round(v[t] + bf16_round(__fadd_rn(acc, bi[t])));
    }
  }
  if (on && (part != nullptr || src != tok)) *reinterpret_cast<uint4*>(tok + off) = pack8(v);
  if (ls == nullptr) return;
  float s = 0.0f, ss = 0.0f;
  if (on) {
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      s += v[t];
      ss += v[t] * v[t];
    }
  }
  const float2 tot = block_sum2(s, ss);
  const float mu = __fdiv_rn(tot.x, (float)d);
  const float var = fmaxf(__fsub_rn(__fdiv_rn(tot.y, (float)d), __fmul_rn(mu, mu)), 0.0f);
  const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  if (!on) return;
  float o[8];
#pragma unroll
  for (int t = 0; t < 8; ++t)
    o[t] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[t], mu), rstd), sc[t]), sb[t]);
  *reinterpret_cast<uint4*>(xn + off) = pack8(o);
}

// C (M, N) = bf16(act(A W + bias)) with act none or the MLP's.
__device__ void gemm_bias_stage(const bf16* A, const bf16* W, const float* bias, bf16* C, int rows,
                                int n, int k, int act, unsigned char* smem) {
  const int mt = (rows + ST_BM - 1) / ST_BM;
  const int items = mt * (n / ST_BN);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int m0 = (it % mt) * ST_BM, n0 = (it / mt) * ST_BN;
    tile_bf16(A, k, W, n, rows, m0, n0, 0, k, smem, [&](int r, int c, float* f) {
      if (r >= rows) return;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const float y = __fadd_rn(f[t], bias[c + t]);
        f[t] = act ? stack_act(y, act) : y;
      }
      store16(C + (size_t)r * n + c, f);
    });
  }
}

// part[s] (M, N) f32 = A[:, ks] W[ks, :] over `split` slices of k.
__device__ void gemm_split_stage(const bf16* A, const bf16* W, float* part, int rows, int n, int k,
                                 int split, unsigned char* smem) {
  const int mt = (rows + ST_BM - 1) / ST_BM;
  const int nt = n / ST_BN;
  const int items = mt * nt * split;
  const int kn = k / split;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int m0 = (it % mt) * ST_BM, n0 = ((it / mt) % nt) * ST_BN, s = it / (mt * nt);
    float* dst = part + (size_t)s * rows * n;
    tile_bf16(A, k, W, n, rows, m0, n0, s * kn, kn, smem, [&](int r, int c, float* f) {
      if (r < rows) store16(dst + (size_t)r * n + c, f);
    });
  }
}

// The layer loop, entered after a grid barrier with xn = bf16(LN1(tok)) of
// layer 0.  It ends after stage (g) of the last layer without a barrier;
// with lfs, (g) writes xn = bf16(LNf(tok)) of each image's first row.
__device__ __forceinline__ void encoder_layers(const StackArgs& p, const Work& w, StageClock& clk,
                                               cg::grid_group& grid, unsigned char* smem,
                                               const float* lfs = nullptr,
                                               const float* lfb = nullptr) {
  const int rows = p.batch * p.n_pad, d = p.d, m = p.m;
  const size_t pstride = (size_t)rows * d;
  const int so = pick_split(d, 3);
  const int s2 = pick_split(m, 4);
  for (int l = 0; l < p.depth; ++l) {
    const bf16* wqkv = p.wqkv + (size_t)l * d * 3 * d;
    const bf16* wo = p.wo + (size_t)l * d * d;
    const bf16* w1 = p.w1 + (size_t)l * d * m;
    const bf16* w2 = p.w2 + (size_t)l * m * d;
    gemm_bias_stage(w.xn, wqkv, p.bqkv + (size_t)l * 3 * d, w.qkv, rows, 3 * d, d, ACT_NONE, smem);
    clk.sync(grid, T_QKV);
    attn_stage(w.qkv, w.ao, p.batch, p.heads, p.n_pad, p.n_valid, d, p.scale, smem);
    prefetch_l2(wo, (size_t)d * d * 2);
    prefetch_l2(w1, (size_t)d * m * 2);
    prefetch_l2(w2, (size_t)m * d * 2);
    clk.sync(grid, T_ATTN);
    gemm_split_stage(w.ao, wo, w.part, rows, d, d, so, smem);
    clk.sync(grid, T_OPROJ);
    for (int r = blockIdx.x; r < rows; r += gridDim.x)
      row_pass(p.tok, p.tok, w.part, so, pstride, p.bo + (size_t)l * d, p.ls2 + (size_t)l * d,
               p.lb2 + (size_t)l * d, w.xn, r, d, p.eps);
    clk.sync(grid, T_RES_LN2);
    gemm_bias_stage(w.xn, w1, p.b1 + (size_t)l * m, w.h, rows, m, d, p.act, smem);
    clk.sync(grid, T_W1);
    gemm_split_stage(w.h, w2, w.part, rows, d, m, s2, smem);
    clk.sync(grid, T_W2);
    const bool last = l == p.depth - 1;
    for (int r = blockIdx.x; r < rows; r += gridDim.x) {
      const bool fin = last && r % p.n_pad == 0;
      row_pass(p.tok, p.tok, w.part, s2, pstride, p.b2 + (size_t)l * d,
               last ? (fin ? lfs : nullptr) : p.ls1 + (size_t)(l + 1) * d,
               last ? (fin ? lfb : nullptr) : p.lb1 + (size_t)(l + 1) * d, w.xn, r, d, p.eps);
    }
    if (!last) {
      prefetch_l2(p.wqkv + (size_t)(l + 1) * d * 3 * d, (size_t)d * 3 * d * 2);
      clk.sync(grid, T_RES_LN1);
    }
  }
}

}  // namespace VFT_NS
