// The dynamic int8 single-launch encoder's layer pieces, shared by K19a
// (vit_stack_int8.cu) and K20 (vit_full_int8.cu); include after
// stack.cuh.
//
//   per layer:
//   (a) tiles  qkv = bf16(float(xq wqkvq) * (sx * sqkv) + bqkv)
//   (b) items  the max-free masked attention -> ao (bf16); idle blocks
//              prefetch Wo, W1, W2 into L2
//   (c) rows   aoq, sa = rowquant(f32(ao)) over all D columns (every head)
//   (d) tiles  split-K int32 partials of aoq woq (exact in any order)
//   (e) rows   tok = tok + bf16(float(sum) * (sa * so) + bo);
//              xq, sx = rowquant(LN2(tok))
//   (f) tiles  h = act(float(xq w1q) * (sx * s1) + b1) in f32, and each
//              64-column tile's row absmax of h
//   (g) rows   sh from those maxima over the whole 3072-wide row;
//              hq = rowquant(h): h is quantized from f32, not bf16
//   (h) tiles  split-K int32 partials of hq w2q
//   (i) rows   tok = tok + bf16(float(sum) * (sh * s2) + b2); the next
//              layer's xq, sx; prefetch of the next layer's Wqkv.  After
//              the last layer, rows r with r % n_pad == 0 (the first row
//              of each image) take the final LayerNorm and its row
//              quantization instead when one is given (K20).

#pragma once

namespace VFT_NS {

struct StackI8Args {
  const bf16* x;
  bf16* tok;
  unsigned char* work;
  const float* ls1;
  const float* lb1;
  const signed char* wqkv;  // (L, 3D, D): the (D, 3D) weights transposed
  const float* sqkv;
  const float* bqkv;
  const signed char* wo;    // (L, D, D) transposed
  const float* so;
  const float* bo;
  const float* ls2;
  const float* lb2;
  const signed char* w1;    // (L, M, D) transposed
  const float* s1;
  const float* b1;
  const signed char* w2;    // (L, D, M) transposed
  const float* s2;
  const float* b2;
  long long* trace;  // optional StageClock buffer (stack.cuh)
  int batch, n_pad, d, m, depth, heads, n_valid, act, amax_parts;
  float eps, scale;
};

// Stage kinds of the StageClock trace.
enum {
  T_LN1 = 0, T_QKV, T_ATTN, T_AO_QUANT, T_OPROJ, T_RES_LN2, T_W1, T_H_QUANT, T_W2, T_RES_LN1
};

struct WorkI8 {
  signed char* q;  // (R, max(D, M))
  float* sx;       // (R,)
  bf16* qkv;       // (R, 3D)
  bf16* ao;        // (R, D)
  float* h;        // (R, M)
  float* amax;     // (M / 64, R)
  int* part;       // (4, R, D)
};

__host__ __device__ inline size_t work_layout_i8(unsigned char* base, int rows, int d, int m,
                                                 WorkI8* w) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = base + off;
    off += align256(bytes);
    return p;
  };
  signed char* q = reinterpret_cast<signed char*>(take((size_t)rows * (d > m ? d : m)));
  float* sx = reinterpret_cast<float*>(take((size_t)rows * 4));
  bf16* qkv = reinterpret_cast<bf16*>(take((size_t)rows * 3 * d * 2));
  bf16* ao = reinterpret_cast<bf16*>(take((size_t)rows * d * 2));
  float* h = reinterpret_cast<float*>(take((size_t)rows * m * 4));
  float* amax = reinterpret_cast<float*>(take((size_t)(m / ST_BN) * rows * 4));
  int* part = reinterpret_cast<int*>(take((size_t)ST_MAX_SPLIT * rows * d * 4));
  if (w != nullptr) *w = WorkI8{q, sx, qkv, ao, h, amax, part};
  return off;
}

// aoq, sa = rowquant(f32(ao)) over the row's D columns.  One block per row.
__device__ __noinline__ void ao_quant_row(const bf16* ao, signed char* q, float* sx, int row,
                                          int d) {
  const int c = threadIdx.x * 8;
  const bool on = c < d;
  const size_t off = (size_t)row * d + (on ? c : 0);
  float v[8];
  ldcg8(ao + off, v);
  quant_chunk(v, on, q + off, sx + row);
}

// hq, sh = rowquant(h) with the row absmax taken from the nparts
// per-tile maxima.  One block per row, up to ST_H_CHUNKS 8-column chunks
// per thread (M <= 8 * SK_THREADS * ST_H_CHUNKS), all loaded first.
constexpr int ST_H_CHUNKS = 2;

__device__ __noinline__ void h_quant_row(const float* h, const float* amax_parts, int nparts,
                                         signed char* q, float* sx, int row, int rows, int m) {
  const int tid = threadIdx.x;
  float f[ST_H_CHUNKS][8];
  bool on[ST_H_CHUNKS];
#pragma unroll
  for (int i = 0; i < ST_H_CHUNKS; ++i) {
    const int c = (tid + i * SK_THREADS) * 8;
    on[i] = c < m;
    ldcg8f(h + (size_t)row * m + (on[i] ? c : 0), f[i]);
  }
  const float part = tid < nparts ? __ldcg(amax_parts + (size_t)tid * rows + row) : 0.0f;
  const float qs = __fdiv_rn(fmaxf(block_max(part), 1e-12f), 127.0f);
#pragma unroll
  for (int i = 0; i < ST_H_CHUNKS; ++i)
    if (on[i]) store_q8(q + (size_t)row * m + (tid + i * SK_THREADS) * 8, f[i], qs);
  if (tid == 0) sx[row] = qs;
}

// h = act(dequant(xq w1q)) in f32, and amax[n0 / 64][row] = the tile's
// row absmax of h.
__device__ void w1_stage(const signed char* A, const float* sx, const signed char* W,
                         const float* scol, const float* bias, float* h, float* amax, int rows,
                         int n, int k, int act, unsigned char* smem) {
  const int mt = (rows + ST_BM - 1) / ST_BM;
  const int items = mt * (n / ST_BN);
  float* red = reinterpret_cast<float*>(smem + (size_t)SK_WARPS * 16 * ST_C_LD * 4);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int m0 = (it % mt) * ST_BM, n0 = (it / mt) * ST_BN;
    tile_i8(A, k, W, k, rows, m0, n0, 0, k, smem, [&](int r, int c, int* acc) {
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
      float mx = 0.0f;
      if (r < rows) {
        const float srow = __ldcg(sx + r);
        float f[16];
#pragma unroll
        for (int t = 0; t < 16; ++t) {
          f[t] = stack_act(dequant(acc[t], srow, scol[c + t], bias[c + t]), act);
          mx = fmaxf(mx, fabsf(f[t]));
        }
        store16(h + (size_t)r * n + c, f);
      }
      // the row's two lanes, then the two column warps
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const int wm = warp >> 1, wn = warp & 1;
      if ((lane & 1) == 0) red[wn * ST_BM + wm * 16 + (lane >> 1)] = mx;
      __syncthreads();
      const int t = threadIdx.x;
      if (t < ST_BM && m0 + t < rows)
        amax[(size_t)(n0 / ST_BN) * rows + m0 + t] = fmaxf(red[t], red[ST_BM + t]);
    });
  }
}

// The layer loop, entered after a grid barrier with xq, sx =
// rowquant(LN1(tok)) of layer 0.  It ends after stage (i) of the last
// layer without a barrier; with lfs, (i) writes xq, sx = rowquant(LNf(tok))
// of each image's first row.
__device__ __forceinline__ void encoder_layers_i8(const StackI8Args& p, const WorkI8& w,
                                                  StageClock& clk, cg::grid_group& grid,
                                                  unsigned char* smem, const float* lfs = nullptr,
                                                  const float* lfb = nullptr) {
  const int rows = p.batch * p.n_pad, d = p.d, m = p.m;
  const size_t pstride = (size_t)rows * d;
  const int so = pick_split(d, 3);
  const int s2 = pick_split(m, 4);
  for (int l = 0; l < p.depth; ++l) {
    const signed char* wqkv = p.wqkv + (size_t)l * 3 * d * d;
    const signed char* wo = p.wo + (size_t)l * d * d;
    const signed char* w1 = p.w1 + (size_t)l * m * d;
    const signed char* w2 = p.w2 + (size_t)l * d * m;
    qkv_stage(w.q, w.sx, wqkv, p.sqkv + (size_t)l * 3 * d, p.bqkv + (size_t)l * 3 * d, w.qkv,
              rows, 3 * d, d, smem);
    clk.sync(grid, T_QKV);
    attn_stage(w.qkv, w.ao, p.batch, p.heads, p.n_pad, p.n_valid, d, p.scale, smem);
    prefetch_l2(wo, (size_t)d * d);
    prefetch_l2(w1, (size_t)d * m);
    prefetch_l2(w2, (size_t)m * d);
    clk.sync(grid, T_ATTN);
    for (int r = blockIdx.x; r < rows; r += gridDim.x) ao_quant_row(w.ao, w.q, w.sx, r, d);
    clk.sync(grid, T_AO_QUANT);
    split_stage_i8(w.q, wo, w.part, rows, d, d, so, smem);
    clk.sync(grid, T_OPROJ);
    for (int r = blockIdx.x; r < rows; r += gridDim.x)
      row_pass_i8<false>(p.tok, p.tok, w.part, so, pstride, p.so + (size_t)l * d, p.bo + (size_t)l * d,
                  p.ls2 + (size_t)l * d, p.lb2 + (size_t)l * d, w.q, w.sx, r, d, p.eps);
    clk.sync(grid, T_RES_LN2);
    w1_stage(w.q, w.sx, w1, p.s1 + (size_t)l * m, p.b1 + (size_t)l * m, w.h, w.amax, rows, m, d,
             p.act, smem);
    clk.sync(grid, T_W1);
    for (int r = blockIdx.x; r < rows; r += gridDim.x)
      h_quant_row(w.h, w.amax, p.amax_parts, w.q, w.sx, r, rows, m);
    clk.sync(grid, T_H_QUANT);
    split_stage_i8(w.q, w2, w.part, rows, d, m, s2, smem);
    clk.sync(grid, T_W2);
    const bool last = l == p.depth - 1;
    for (int r = blockIdx.x; r < rows; r += gridDim.x) {
      const bool fin = last && r % p.n_pad == 0;
      row_pass_i8<false>(p.tok, p.tok, w.part, s2, pstride, p.s2 + (size_t)l * d, p.b2 + (size_t)l * d,
                  last ? (fin ? lfs : nullptr) : p.ls1 + (size_t)(l + 1) * d,
                  last ? (fin ? lfb : nullptr) : p.lb1 + (size_t)(l + 1) * d, w.q, w.sx, r, d, p.eps);
    }
    if (!last) {
      prefetch_l2(p.wqkv + (size_t)(l + 1) * 3 * d * d, (size_t)3 * d * d);
      clk.sync(grid, T_RES_LN1);
    }
  }
}

}  // namespace VFT_NS
