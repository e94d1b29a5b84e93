// Attention-half backward on Hopper (sm_90a), the backward of
// attn_block.cu.
//
// Replaces vit_fpga_tpu/ops/attn_block.py:_attn_bwd_kernel (wrapper
// attn_block_bwd_pallas), one Pallas kernel on the TPU that recomputes the
// forward per image and sums the weight gradients in VMEM across its
// sequential grid.  It ports that kernel's per-head (non-pair) arithmetic
// as a sequence of launches on one stream, counted as one ported kernel;
// every sum runs in a fixed order (no atomics), so a result is the same
// from run to run:
//
//   (a) ln_rows            two-pass (mu, rstd) of x and xn = bf16(LN(x))
//   (b) gemm_bf16          qkv = bf16(xn @ Wqkv + bqkv)
//   (c) gemm_bf16<TB>      gw = bf16(g @ Wo^T)
//   (d) attn_bwd_kernel    per (image, head), see below: ao, dq, dk, dv
//   (e) gemm_bf16<TA>      dWo = ao^T g, (f) dWqkv = xn^T dqkv  (f32, over
//                          all B * n_pad rows in one product)
//   (g) colsum             dbo = sum of g, dbqkv = sum of dqkv
//   (h) gemm_bf16<TB>      dxn = dqkv @ Wqkv^T                  (f32)
//   (i) ln_bwd + colsum    dx = bf16(g + LN backward of dxn), dls, dlb
//
// attn_bwd_kernel, one block of 4 warps per (head, image).  A head's P is
// up to 256 x 256 f32, too large for shared memory beside K and V, so the
// block makes two passes over it:
//   pass 1, a 16-row query tile per warp: s = (q k^T) * scale (f32), keys
//     at or past n_valid masked, p = exp(s - max) / sum (f32);
//     ao = bf16(bf16(p) @ v); dP = gw v^T; dS = bf16(p (dP - rowsum(dP p))
//     * scale); dq = bf16(dS @ k); each row's max, sum and rowsum are kept;
//   pass 2, a 16-key tile per warp: the same s, dP, p and dS are recomputed
//     tile by tile with the same fragment sums and the kept row values, and
//     dv = bf16(sum over query tiles of bf16(p)^T gw), dk = bf16(sum of
//     dS^T q) accumulate in registers, so no warp adds into another's sums.
//
// What bounds it on the H100: seven projection-sized products (22 R D^2
// flops, R = B * n_pad) plus six score-space products (6 x 2 B H n_pad
// n_valid dh), 189 GFLOP at ViT-B/16 batch 64 (0.191 ms at 989 TFLOP/s), so
// it is bound by tensor-core operations; compulsory traffic is under
// 100 MB.  qkv, gw, ao, dqkv and the f32 dxn round-trip through device
// memory, the score-space products run on wmma fragments from shared
// memory at 1 block per SM, and pass 2 recomputes s and dP; fusing and
// wgmma are later work.

#define VFT_NS attn_bwd
#include "common.cuh"
#include "norm.cuh"

namespace VFT_NS {

constexpr int AB_WARPS = 4;
constexpr int AB_THREADS = AB_WARPS * 32;
constexpr int AB_MAX = 256;  // keys (kvp) and query rows (nq): 8 per lane in the softmax
constexpr int AB_DH = 64;
constexpr int AB_LDQ = AB_DH + 8;  // bf16 row of a head panel
constexpr int AB_LDO = AB_DH + 4;  // f32 row of a 16 x 64 output staging tile
constexpr int AB_LDT = 16 + 4;     // f32 row of a 16 x 16 pass-2 tile
constexpr int AB_LDB = 16 + 8;     // bf16 row of a 16 x 16 pass-2 tile

// Shared memory: K and V panels (kvp rows) and the per-row softmax values
// (max, sum, rowsum(dP p), nq each), then per warp for pass 1 its q and gw
// tiles (their space is the output staging tile once the products are
// done) and two 16 x kvp f32 tiles, S (scores, then p; bf16(p) over it row
// by row) and D (dP; dS over it).  Pass 2 reuses the pass-1 region for the
// Q and gw panels (nq rows) and a per-warp set of 16 x 16 tiles.
struct AttnBwdSmem {
  int lds;
  size_t k_off, v_off, stat_off, w_off, w_bytes, s_rel, d_rel, qp_off, gp_off, w2_off, w2_bytes,
      bytes;
};

__host__ __device__ inline AttnBwdSmem attn_bwd_smem(int kvp, int nq) {
  AttnBwdSmem m;
  m.lds = kvp + 4;
  m.k_off = 0;
  m.v_off = round128((size_t)kvp * AB_LDQ * 2);
  m.stat_off = m.v_off + round128((size_t)kvp * AB_LDQ * 2);
  m.w_off = m.stat_off + round128((size_t)3 * nq * 4);
  m.s_rel = round128((size_t)2 * 16 * AB_LDQ * 2);
  m.d_rel = m.s_rel + round128((size_t)16 * m.lds * 4);
  m.w_bytes = m.d_rel + round128((size_t)16 * m.lds * 4);
  m.qp_off = m.w_off;
  m.gp_off = m.qp_off + round128((size_t)nq * AB_LDQ * 2);
  m.w2_off = m.gp_off + round128((size_t)nq * AB_LDQ * 2);
  m.w2_bytes = round128((size_t)16 * AB_LDO * 4);
  const size_t pass1 = m.w_off + AB_WARPS * m.w_bytes;
  const size_t pass2 = m.w2_off + AB_WARPS * m.w2_bytes;
  m.bytes = pass1 > pass2 ? pass1 : pass2;
  return m;
}

// Writes a 16 x 64 f32 staging tile as bf16 rows r0 + r < rmax of dst
// (row stride ld elements).
__device__ __forceinline__ void store_tile_bf16(const float* os, bf16* dst, size_t ld, int r0,
                                                int rmax, int lane) {
  for (int c = lane; c < 16 * (AB_DH / 8); c += 32) {
    const int r = c / (AB_DH / 8), cc = c % (AB_DH / 8);
    if (r0 + r >= rmax) continue;
    float f[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) f[t] = os[r * AB_LDO + cc * 8 + t];
    *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * ld + cc * 8) = pack8(f);
  }
}

// qkv, dqkv: (B * n_pad, 3D) bf16, q | k | v column blocks, head h at
// h*AB_DH; gw, ao: (B * n_pad, D) bf16.  kvp = n_valid rounded up to 16,
// nq = n_pad rounded up to 16, both <= AB_MAX.
__global__ void __launch_bounds__(AB_THREADS)
    attn_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ gw,
                    bf16* __restrict__ ao, bf16* __restrict__ dqkv, int n_pad, int n_valid,
                    int kvp, int nq, int d, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int CPR = AB_DH / 8;  // 16-byte chunks per head row
  constexpr int NF = AB_DH / 16;  // fragments across the head dimension
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
  using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
  using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  const AttnBwdSmem L = attn_bwd_smem(kvp, nq);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L.k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.v_off);
  float* row_m = reinterpret_cast<float*>(smem + L.stat_off);
  float* row_l = row_m + nq;
  float* row_rs = row_l + nq;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t ld3 = 3 * (size_t)d;
  const size_t row0 = (size_t)b * n_pad;
  const bf16* qbase = qkv + row0 * ld3 + h * AB_DH;  // q of head h, row 0
  const bf16* gbase = gw + row0 * d + h * AB_DH;
  bf16* aobase = ao + row0 * d + h * AB_DH;
  bf16* dbase = dqkv + row0 * ld3 + h * AB_DH;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // Keys and values past n_valid are masked, so they are zero-filled here.
  for (int c = tid; c < kvp * CPR; c += AB_THREADS) {
    const int r = c / CPR, cc = c % CPR;
    uint4 kv = zero, vv = zero;
    if (r < n_valid) {
      const bf16* row = qbase + (size_t)r * ld3 + cc * 8;
      kv = *reinterpret_cast<const uint4*>(row + d);
      vv = *reinterpret_cast<const uint4*>(row + 2 * d);
    }
    *reinterpret_cast<uint4*>(Ks + r * AB_LDQ + cc * 8) = kv;
    *reinterpret_cast<uint4*>(Vs + r * AB_LDQ + cc * 8) = vv;
  }
  __syncthreads();

  // ---- pass 1: one 16-row query tile per warp ----
  {
    unsigned char* wb = smem + L.w_off + warp * L.w_bytes;
    bf16* Qs = reinterpret_cast<bf16*>(wb);
    bf16* Gs = Qs + 16 * AB_LDQ;
    float* Os = reinterpret_cast<float*>(wb);  // over Qs / Gs once they are used
    float* S = reinterpret_cast<float*>(wb + L.s_rel);
    float* D = reinterpret_cast<float*>(wb + L.d_rel);
    bf16* P = reinterpret_cast<bf16*>(S);    // bf16(p), row r over S row r
    bf16* DS = reinterpret_cast<bf16*>(D);   // dS, row r over D row r
    const int ldp = 2 * L.lds;               // bf16 elements per P / DS row
    for (int qt = warp; qt < nq / 16; qt += AB_WARPS) {
      const int q0 = qt * 16;
      for (int c = lane; c < 16 * CPR; c += 32) {
        const int r = c / CPR, cc = c % CPR;
        uint4 qv = zero, gv = zero;
        if (q0 + r < n_pad) {
          qv = *reinterpret_cast<const uint4*>(qbase + (size_t)(q0 + r) * ld3 + cc * 8);
          gv = *reinterpret_cast<const uint4*>(gbase + (size_t)(q0 + r) * d + cc * 8);
        }
        *reinterpret_cast<uint4*>(Qs + r * AB_LDQ + cc * 8) = qv;
        *reinterpret_cast<uint4*>(Gs + r * AB_LDQ + cc * 8) = gv;
      }
      __syncwarp();
      {  // s = q k^T and dP = gw v^T (f32), one 16-key block at a time
        FragA qa[NF], ga[NF];
#pragma unroll
        for (int kk = 0; kk < NF; ++kk) {
          wmma::load_matrix_sync(qa[kk], Qs + kk * 16, AB_LDQ);
          wmma::load_matrix_sync(ga[kk], Gs + kk * 16, AB_LDQ);
        }
        for (int j = 0; j < kvp / 16; ++j) {
          FragC sacc, dacc;
          wmma::fill_fragment(sacc, 0.0f);
          wmma::fill_fragment(dacc, 0.0f);
#pragma unroll
          for (int kk = 0; kk < NF; ++kk) {
            FragBT kb, vb;
            wmma::load_matrix_sync(kb, Ks + (j * 16) * AB_LDQ + kk * 16, AB_LDQ);
            wmma::load_matrix_sync(vb, Vs + (j * 16) * AB_LDQ + kk * 16, AB_LDQ);
            wmma::mma_sync(sacc, qa[kk], kb, sacc);
            wmma::mma_sync(dacc, ga[kk], vb, dacc);
          }
          wmma::store_matrix_sync(S + j * 16, sacc, L.lds, wmma::mem_row_major);
          wmma::store_matrix_sync(D + j * 16, dacc, L.lds, wmma::mem_row_major);
        }
      }
      __syncwarp();

      // Row by row: the softmax and its backward.  All lanes read row r of
      // S and D into registers before bf16(p) and dS are written over it.
      for (int r = 0; r < 16; ++r) {
        const float* srow = S + r * L.lds;
        const float* drow = D + r * L.lds;
        float pv[AB_MAX / 32], dv[AB_MAX / 32];
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < AB_MAX / 32; ++i) {
          const int c = lane + 32 * i;
          pv[i] = c < n_valid ? srow[c] * scale : -INFINITY;
          dv[i] = c < kvp ? drow[c] : 0.0f;
          mx = fmaxf(mx, pv[i]);
        }
        mx = warp_max(mx);
        float sum = 0.0f;
#pragma unroll
        for (int i = 0; i < AB_MAX / 32; ++i) {
          const int c = lane + 32 * i;
          pv[i] = c < n_valid ? expf(pv[i] - mx) : 0.0f;
          sum += pv[i];
        }
        sum = warp_sum(sum);
        float rs = 0.0f;
#pragma unroll
        for (int i = 0; i < AB_MAX / 32; ++i) {
          pv[i] = pv[i] / sum;
          rs += dv[i] * pv[i];
        }
        rs = warp_sum(rs);
        __syncwarp();
        bf16* prow = P + r * ldp;
        bf16* dsrow = DS + r * ldp;
#pragma unroll
        for (int i = 0; i < AB_MAX / 32; ++i) {
          const int c = lane + 32 * i;
          if (c < kvp) {
            prow[c] = __float2bfloat16(pv[i]);
            dsrow[c] = __float2bfloat16((pv[i] * (dv[i] - rs)) * scale);
          }
        }
        if (lane == 0 && q0 + r < n_pad) {
          row_m[q0 + r] = mx;
          row_l[q0 + r] = sum;
          row_rs[q0 + r] = rs;
        }
      }
      __syncwarp();

      // ao = bf16(bf16(p) @ v), then dq = bf16(dS @ k), through Os
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        const bf16* lhs = which == 0 ? P : DS;
        const bf16* rhs = which == 0 ? Vs : Ks;
        FragC oacc[NF];
#pragma unroll
        for (int j = 0; j < NF; ++j) wmma::fill_fragment(oacc[j], 0.0f);
        for (int kk = 0; kk < kvp / 16; ++kk) {
          FragA la;
          wmma::load_matrix_sync(la, lhs + kk * 16, ldp);
#pragma unroll
          for (int j = 0; j < NF; ++j) {
            FragB rb;
            wmma::load_matrix_sync(rb, rhs + (kk * 16) * AB_LDQ + j * 16, AB_LDQ);
            wmma::mma_sync(oacc[j], la, rb, oacc[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < NF; ++j)
          wmma::store_matrix_sync(Os + j * 16, oacc[j], AB_LDO, wmma::mem_row_major);
        __syncwarp();
        if (which == 0)
          store_tile_bf16(Os, aobase, d, q0, n_pad, lane);
        else
          store_tile_bf16(Os, dbase, ld3, q0, n_pad, lane);
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // ---- pass 2: one 16-key tile per warp ----
  bf16* Qp = reinterpret_cast<bf16*>(smem + L.qp_off);
  bf16* Gp = reinterpret_cast<bf16*>(smem + L.gp_off);
  for (int c = tid; c < nq * CPR; c += AB_THREADS) {
    const int r = c / CPR, cc = c % CPR;
    uint4 qv = zero, gv = zero;
    if (r < n_pad) {
      qv = *reinterpret_cast<const uint4*>(qbase + (size_t)r * ld3 + cc * 8);
      gv = *reinterpret_cast<const uint4*>(gbase + (size_t)r * d + cc * 8);
    }
    *reinterpret_cast<uint4*>(Qp + r * AB_LDQ + cc * 8) = qv;
    *reinterpret_cast<uint4*>(Gp + r * AB_LDQ + cc * 8) = gv;
  }
  __syncthreads();
  unsigned char* w2 = smem + L.w2_off + warp * L.w2_bytes;
  float* Ss = reinterpret_cast<float*>(w2);               // 16 x AB_LDT
  float* Dt = Ss + 16 * AB_LDT;                           // 16 x AB_LDT
  bf16* Pt = reinterpret_cast<bf16*>(Dt + 16 * AB_LDT);   // 16 x AB_LDB, [query][key]
  bf16* DSt = Pt + 16 * AB_LDB;                           // 16 x AB_LDB
  float* Os = reinterpret_cast<float*>(w2);               // after the loop
  const int er = lane >> 1;
  const int ec = (lane & 1) * 8;
  for (int kt = warp; kt < nq / 16; kt += AB_WARPS) {
    const int k0 = kt * 16;
    FragC dkacc[NF], dvacc[NF];
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::fill_fragment(dkacc[j], 0.0f);
      wmma::fill_fragment(dvacc[j], 0.0f);
    }
    if (k0 < kvp) {  // key tiles past kvp are all masked: zero gradients
      FragBT kb[NF], vb[NF];
#pragma unroll
      for (int kk = 0; kk < NF; ++kk) {
        wmma::load_matrix_sync(kb[kk], Ks + k0 * AB_LDQ + kk * 16, AB_LDQ);
        wmma::load_matrix_sync(vb[kk], Vs + k0 * AB_LDQ + kk * 16, AB_LDQ);
      }
      for (int q0 = 0; q0 < nq; q0 += 16) {
        FragC sacc, dacc;
        wmma::fill_fragment(sacc, 0.0f);
        wmma::fill_fragment(dacc, 0.0f);
#pragma unroll
        for (int kk = 0; kk < NF; ++kk) {
          FragA qa, ga;
          wmma::load_matrix_sync(qa, Qp + q0 * AB_LDQ + kk * 16, AB_LDQ);
          wmma::load_matrix_sync(ga, Gp + q0 * AB_LDQ + kk * 16, AB_LDQ);
          wmma::mma_sync(sacc, qa, kb[kk], sacc);
          wmma::mma_sync(dacc, ga, vb[kk], dacc);
        }
        wmma::store_matrix_sync(Ss, sacc, AB_LDT, wmma::mem_row_major);
        wmma::store_matrix_sync(Dt, dacc, AB_LDT, wmma::mem_row_major);
        __syncwarp();
        const int q = q0 + er;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int key = k0 + ec + t;
          float p = 0.0f, ds = 0.0f;
          if (q < n_pad && key < n_valid) {
            p = expf(Ss[er * AB_LDT + ec + t] * scale - row_m[q]) / row_l[q];
            ds = (p * (Dt[er * AB_LDT + ec + t] - row_rs[q])) * scale;
          }
          Pt[er * AB_LDB + ec + t] = __float2bfloat16(p);
          DSt[er * AB_LDB + ec + t] = __float2bfloat16(ds);
        }
        __syncwarp();
        // dv += bf16(p)^T gw, dk += dS^T q over this query tile
        FragAT pa, dsa;
        wmma::load_matrix_sync(pa, Pt, AB_LDB);
        wmma::load_matrix_sync(dsa, DSt, AB_LDB);
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          FragB gb, qb;
          wmma::load_matrix_sync(gb, Gp + q0 * AB_LDQ + j * 16, AB_LDQ);
          wmma::load_matrix_sync(qb, Qp + q0 * AB_LDQ + j * 16, AB_LDQ);
          wmma::mma_sync(dvacc[j], pa, gb, dvacc[j]);
          wmma::mma_sync(dkacc[j], dsa, qb, dkacc[j]);
        }
        __syncwarp();
      }
    }
#pragma unroll
    for (int j = 0; j < NF; ++j)
      wmma::store_matrix_sync(Os + j * 16, dkacc[j], AB_LDO, wmma::mem_row_major);
    __syncwarp();
    store_tile_bf16(Os, dbase + d, ld3, k0, n_pad, lane);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NF; ++j)
      wmma::store_matrix_sync(Os + j * 16, dvacc[j], AB_LDO, wmma::mem_row_major);
    __syncwarp();
    store_tile_bf16(Os, dbase + 2 * d, ld3, k0, n_pad, lane);
    __syncwarp();
  }
}

struct AttnBwdWork {
  size_t st, xn, qkv, gw, ao, dqkv, dxn, lnpart, cspart, bytes;
};

inline size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

inline AttnBwdWork attn_bwd_work(int rows, int d) {
  AttnBwdWork w;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off += align256(bytes);
    return at;
  };
  w.st = take((size_t)rows * 2 * sizeof(float));
  w.xn = take((size_t)rows * d * sizeof(bf16));
  w.qkv = take((size_t)rows * 3 * d * sizeof(bf16));
  w.gw = take((size_t)rows * d * sizeof(bf16));
  w.ao = take((size_t)rows * d * sizeof(bf16));
  w.dqkv = take((size_t)rows * 3 * d * sizeof(bf16));
  w.dxn = take((size_t)rows * d * sizeof(float));
  w.lnpart = take((size_t)ln_bwd_blocks(rows) * 2 * d * sizeof(float));
  const size_t cs = colsum_scratch_floats(rows, 3 * d);  // the largest of the three
  w.cspart = take(cs * sizeof(float));
  w.bytes = off;
  return w;
}

}  // namespace VFT_NS

using namespace VFT_NS;

extern "C" {

// Opts this unit's kernels in to the shared memory they use (the
// attention block at 256 keys and rows needs 223 KB), on the current
// device.  Called once per device before the first launch.  Returns a
// cudaError_t.
int vft_attn_bwd_init() {
  cudaError_t err;
  if ((err = gemm_enable<false, false, false>()) != cudaSuccess) return err;
  if ((err = gemm_enable<false, false, true>()) != cudaSuccess) return err;
  if ((err = gemm_enable<false, true, false>()) != cudaSuccess) return err;
  if ((err = ln_bwd_enable()) != cudaSuccess) return err;
  return cudaFuncSetAttribute(attn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)attn_bwd_smem(AB_MAX, AB_MAX).bytes);
}

// Bytes of device workspace vft_attn_block_bwd takes at this shape.
size_t vft_attn_bwd_workspace(int batch, int n_pad, int d) {
  return attn_bwd_work(batch * n_pad, d).bytes;
}

// x, g, dx: (B * n_pad, D) bf16; ls, lb: (D,) f32; wqkv: (D, 3D) bf16;
// bqkv: (3D,) f32; wo: (D, D) bf16.  Outputs, f32: dln (2D,) = [dls | dlb],
// dwqkv (D, 3D), dbqkv (3D,), dwo (D, D), dbo (D,).  work:
// vft_attn_bwd_workspace bytes.  Head dim 64, 1 <= n_valid <= n_pad <= 256,
// B * n_pad a multiple of 8, D <= 2048.  Everything is enqueued on
// `stream`, which belongs to the current device.  Returns a cudaError_t.
int vft_attn_block_bwd(const void* x, const void* g, const void* ls, const void* lb,
                       const void* wqkv, const void* bqkv, const void* wo, void* dx, void* dln,
                       void* dwqkv, void* dbqkv, void* dwo, void* dbo, void* work, int batch,
                       int n_pad, int d, int heads, int n_valid, float eps, float scale,
                       void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int rows = batch * n_pad;
  const int kvp = (n_valid + 15) / 16 * 16;
  const int nq = (n_pad + 15) / 16 * 16;
  if (d != heads * AB_DH || n_valid < 1 || n_valid > n_pad || nq > AB_MAX || rows % 8 ||
      d > LNB_MAX_D)
    return cudaErrorInvalidValue;
  const AttnBwdWork w = attn_bwd_work(rows, d);
  unsigned char* ws = static_cast<unsigned char*>(work);
  float* stats = reinterpret_cast<float*>(ws + w.st);
  bf16* xn = reinterpret_cast<bf16*>(ws + w.xn);
  bf16* qkv = reinterpret_cast<bf16*>(ws + w.qkv);
  bf16* gw = reinterpret_cast<bf16*>(ws + w.gw);
  bf16* ao = reinterpret_cast<bf16*>(ws + w.ao);
  bf16* dqkv = reinterpret_cast<bf16*>(ws + w.dqkv);
  float* dxn = reinterpret_cast<float*>(ws + w.dxn);
  float* lnpart = reinterpret_cast<float*>(ws + w.lnpart);
  float* cspart = reinterpret_cast<float*>(ws + w.cspart);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  cudaError_t err;

  if ((err = launch_ln_rows(xb, static_cast<const float*>(ls), static_cast<const float*>(lb),
                            stats, xn, rows, d, eps, st)) != cudaSuccess)
    return err;

  GemmArgs p{};  // qkv = bf16(xn @ Wqkv + bqkv)
  p.A = xn;
  p.B = static_cast<const bf16*>(wqkv);
  p.bias = static_cast<const float*>(bqkv);
  p.C = qkv;
  p.M = rows;
  p.N = 3 * d;
  p.K = d;
  if ((err = launch_gemm_t<false, false, false>(p, st)) != cudaSuccess) return err;

  p = GemmArgs{};  // gw = bf16(g @ Wo^T)
  p.A = gb;
  p.B = static_cast<const bf16*>(wo);
  p.C = gw;
  p.M = rows;
  p.N = d;
  p.K = d;
  if ((err = launch_gemm_t<false, false, true>(p, st)) != cudaSuccess) return err;

  attn_bwd_kernel<<<dim3(heads, batch), AB_THREADS, attn_bwd_smem(kvp, nq).bytes, st>>>(
      qkv, gw, ao, dqkv, n_pad, n_valid, kvp, nq, d, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  p = GemmArgs{};  // dWo = ao^T g
  p.A = ao;
  p.B = gb;
  p.C = dwo;
  p.c_f32 = 1;
  p.M = d;
  p.N = d;
  p.K = rows;
  if ((err = launch_gemm_t<false, true, false>(p, st)) != cudaSuccess) return err;
  if ((err = launch_colsum<bf16>(gb, static_cast<float*>(dbo), cspart, rows, d, st)) !=
      cudaSuccess)
    return err;

  p = GemmArgs{};  // dWqkv = xn^T dqkv
  p.A = xn;
  p.B = dqkv;
  p.C = dwqkv;
  p.c_f32 = 1;
  p.M = d;
  p.N = 3 * d;
  p.K = rows;
  if ((err = launch_gemm_t<false, true, false>(p, st)) != cudaSuccess) return err;
  if ((err = launch_colsum<bf16>(dqkv, static_cast<float*>(dbqkv), cspart, rows, 3 * d, st)) !=
      cudaSuccess)
    return err;

  p = GemmArgs{};  // dxn = dqkv @ Wqkv^T
  p.A = dqkv;
  p.B = static_cast<const bf16*>(wqkv);
  p.C = dxn;
  p.c_f32 = 1;
  p.M = rows;
  p.N = d;
  p.K = 3 * d;
  if ((err = launch_gemm_t<false, false, true>(p, st)) != cudaSuccess) return err;

  if ((err = launch_ln_bwd(xb, stats, dxn, gb, static_cast<const float*>(ls),
                           static_cast<bf16*>(dx), lnpart, rows, d, st)) != cudaSuccess)
    return err;
  if ((err = launch_colsum<float>(lnpart, static_cast<float*>(dln), cspart, ln_bwd_blocks(rows),
                                  2 * d, st)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

}  // extern "C"
