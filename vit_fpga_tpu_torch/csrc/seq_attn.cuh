// Attention over a whole sequence of any length, on strided q, k and v
// (flash_attn.cu K9, mha.cu K7 / K8 in f32); include after common.cuh.
// K7 / K8 in bf16 are mha_wgmma.cuh's kernel.
//
// The operands are read by strides, so one kernel takes the packed
// (B, N, 3D) qkv tensor (q, k and v are column blocks of one row) and the
// (B, H, N, Dh) layout alike; the JAX wrappers' head-split transposes and
// their padding of N are layout, not function.  Head dim 64.
//
//   seq_attn_kernel  K9, the blockwise online softmax of
//       flash_attention.py, in bf16 on mma.sync m16n8k16 with f32 sums; one
//       block of SQ_WARPS warps per (SQ_BQ query rows, image x head), each
//       warp 16 query rows whose scores, probabilities and output stay in
//       registers.  The keys and values stream through shared memory in
//       SQ_KT-key tiles, double-buffered with cp.async; only the tiles
//       before n_valid are read.  s = (q k^T) * scale in f32, keys at or
//       past n_valid masked.  Per key block of bk keys (its boundaries are
//       part of the function: p is rounded to bf16 against the running max
//       after each block), m_new = max(m, max_block s), alpha = exp(m -
//       m_new), p = exp(s - m_new), l = l alpha + sum p, acc = acc alpha +
//       bf16(p) v; o = bf16(acc / l).  A block of one tile takes one pass;
//       a longer block reads its tiles twice, first for its max.  Blocks
//       wholly past n_valid are skipped: on the TPU they leave m, l and acc
//       unchanged (alpha = 1, p = 0).
//   seq_attn_f32_kernel  the exact softmax in f32 (K7 / K8 in f32) with
//       true f32 fma on the CUDA cores: no TF32, no bf16 staging.  Each warp
//       takes SF_ROWS query rows, each lane two keys of a SF_KT-key tile and
//       then two output columns.

#pragma once

namespace VFT_NS {

constexpr int SQ_DH = 64;                // head dim
constexpr int SQ_WARPS = 4;
constexpr int SQ_THREADS = SQ_WARPS * 32;
constexpr int SQ_BQ = 16 * SQ_WARPS;     // query rows per block
constexpr int SQ_KT = 128;               // keys per streamed tile
constexpr int SQ_LD = SQ_DH + 8;         // bf16 elements per shared row (144 bytes)
constexpr int SQ_TILE = SQ_KT * SQ_LD;   // elements of one K (or V) tile

// Q rows, then two stages of a (K, V) tile pair.
constexpr size_t SQ_SMEM_BYTES = (size_t)(SQ_BQ * SQ_LD + 2 * 2 * SQ_TILE) * 2;

struct SeqAttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long in_b, in_h;    // element strides of q, k and v: image, head
  int in_r;                // and token row
  long long out_b, out_h;  // of o
  int out_r;
  int heads, n, n_valid;   // n query rows and keys; keys >= n_valid masked
  int bk;                  // K9's key block, a multiple of SQ_KT (unused in f32)
  float scale;
};

__global__ void __launch_bounds__(SQ_THREADS) seq_attn_kernel(SeqAttnArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* KV = Qs + SQ_BQ * SQ_LD;  // stage s: K at KV + 2 s SQ_TILE, V after it
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int q0 = blockIdx.x * SQ_BQ;
  const size_t in_off = (size_t)b * p.in_b + (size_t)h * p.in_h;
  const bf16* qg = static_cast<const bf16*>(p.q) + in_off;
  const bf16* kg = static_cast<const bf16*>(p.k) + in_off;
  const bf16* vg = static_cast<const bf16*>(p.v) + in_off;

  // The tile stream.  A key block of tpb tiles is read twice (phase 0: its
  // statistics from K, phase 1: its output from K and V); a block of one
  // tile is read once (phase 2).
  const int ntiles = (p.n_valid + SQ_KT - 1) / SQ_KT;
  const int tpb = p.bk / SQ_KT;
  const bool one_pass = tpb == 1;
  const int nsteps = one_pass ? ntiles : 2 * ntiles;
  auto step_of = [&](int i, int& tile, int& phase, int& w, int& c) {
    if (one_pass) {
      tile = i;
      phase = 2;
      w = 0;
      c = 1;
      return;
    }
    const int f = (i / (2 * tpb)) * tpb;  // the block's first tile
    c = min(tpb, ntiles - f);
    w = i - 2 * f;
    phase = w < c ? 0 : 1;
    tile = f + (w < c ? w : w - c);
  };
  // Keys and values at or past n_valid are zero-filled (0 * p stays 0).
  auto load = [&](int i, int s) {
    int tile, phase, w, c;
    step_of(i, tile, phase, w, c);
    bf16* Ks = KV + 2 * s * SQ_TILE;
    bf16* Vs = Ks + SQ_TILE;
    for (int ch = tid; ch < SQ_KT * 8; ch += SQ_THREADS) {
      const int r = ch >> 3, cc = (ch & 7) * 8;
      const int key = tile * SQ_KT + r;
      const bool ok = key < p.n_valid;
      const size_t off = (size_t)(ok ? key : 0) * p.in_r + cc;
      cp_async16(Ks + r * SQ_LD + cc, kg + off, ok);
      if (phase != 0) cp_async16(Vs + r * SQ_LD + cc, vg + off, ok);
    }
  };

  for (int ch = tid; ch < SQ_BQ * 8; ch += SQ_THREADS) {
    const int r = ch >> 3, cc = (ch & 7) * 8;
    const bool ok = q0 + r < p.n;
    cp_async16(Qs + r * SQ_LD + cc, qg + (size_t)(ok ? q0 + r : 0) * p.in_r + cc, ok);
  }
  load(0, 0);
  cp_async_commit();

  unsigned qf[4][4];     // the warp's 16 x 64 query rows as A fragments
  float acc[8][4];       // 16 x 64 output: rows g, g + 8; columns 8 n + 2 t4 (+1)
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {-1e30f, -1e30f};  // running max of rows g, g + 8
  float l[2] = {0.0f, 0.0f};      // running sum
  float mb[2], lb[2];             // a two-pass flash block's max and sum

  for (int i = 0; i < nsteps; ++i) {
    if (i + 1 < nsteps) load(i + 1, (i + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldsm_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * SQ_LD + kk * 16 + (lane >> 4) * 8);
    }
    int tile, phase, w, c;
    step_of(i, tile, phase, w, c);
    const bf16* Ks = KV + 2 * (i & 1) * SQ_TILE;
    const bf16* Vs = Ks + SQ_TILE;

    // s = (q k^T) * scale for the tile's SQ_KT keys: 16 tiles of 16 x 8
    float s[16][4];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {
        unsigned r[4];
        ldsm_x4(r, Ks + (j * 8 + (lane & 7)) * SQ_LD + kp * 32 + (lane >> 3) * 8);
        mma_bf16(s[j], qf[2 * kp], r[0], r[1]);
        mma_bf16(s[j], qf[2 * kp + 1], r[2], r[3]);
      }
    }
    const int key0 = tile * SQ_KT + 2 * t4;
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = key0 + j * 8 + (e & 1) < p.n_valid;
        s[j][e] = ok ? s[j][e] * p.scale : -INFINITY;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s[j][e]);
      }
    }
    tmax[0] = quad_max(tmax[0]);
    tmax[1] = quad_max(tmax[1]);

    if (phase == 0) {  // statistics pass: the block's max
      if (w == 0) mb[0] = mb[1] = -INFINITY;
      mb[0] = fmaxf(mb[0], tmax[0]);
      mb[1] = fmaxf(mb[1], tmax[1]);
    } else {  // output pass: p, then acc += bf16(p) v
      const bool first = phase == 2 || w == c;
      if (first) {  // the block's new max rescales acc and l
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float mn = fmaxf(m[rr], phase == 2 ? tmax[rr] : mb[rr]);
          const float alpha = expf(m[rr] - mn);
          l[rr] *= alpha;
          lb[rr] = 0.0f;
          m[rr] = mn;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            acc[n][2 * rr] *= alpha;
            acc[n][2 * rr + 1] *= alpha;
          }
        }
      }
      float part[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - m[e >> 1]);
          part[e >> 1] += s[j][e];
        }
      lb[0] += quad_sum(part[0]);
      lb[1] += quad_sum(part[1]);
      if (phase == 2 || w == 2 * c - 1) {  // the block's last tile: l = l alpha + sum p
        l[0] += lb[0];
        l[1] += lb[1];
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {  // 16 keys a step
        unsigned a[4];
        a[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
          unsigned r[4];
          ldsm_x4_t(r, Vs + (kk * 16 + (lane & 15)) * SQ_LD + dp * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * dp], a, r[0], r[1]);
          mma_bf16(acc[2 * dp + 1], a, r[2], r[3]);
        }
      }
    }
    __syncthreads();  // this stage is free for the copies of step i + 2
  }
  cp_async_wait<0>();

  bf16* og = static_cast<bf16*>(p.o) + (size_t)b * p.out_b + (size_t)h * p.out_h;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + warp * 16 + g + 8 * rr;
    if (row >= p.n) continue;
    bf16* orow = og + (size_t)row * p.out_r + 2 * t4;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float a0 = acc[n][2 * rr] / l[rr], a1 = acc[n][2 * rr + 1] / l[rr];
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) = __floats2bfloat162_rn(a0, a1);
    }
  }
}

inline cudaError_t seq_attn_enable() {
  return cudaFuncSetAttribute(seq_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)SQ_SMEM_BYTES);
}

inline cudaError_t launch_seq_attn(const SeqAttnArgs& p, int batch, cudaStream_t stream) {
  if (p.n < 1 || p.n_valid < 1 || p.n_valid > p.n || p.bk < SQ_KT || p.bk % SQ_KT)
    return cudaErrorInvalidValue;
  const dim3 grid((p.n + SQ_BQ - 1) / SQ_BQ, batch * p.heads);
  seq_attn_kernel<<<grid, SQ_THREADS, SQ_SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The exact softmax in f32
// ---------------------------------------------------------------------------

constexpr int SF_WARPS = 4;
constexpr int SF_THREADS = SF_WARPS * 32;
constexpr int SF_ROWS = 8;                   // query rows per warp
constexpr int SF_BQ = SF_ROWS * SF_WARPS;    // per block
constexpr int SF_KT = 64;                    // keys per tile: two per lane
constexpr int SF_KLD = SF_KT + 1;            // K^T rows: lane-indexed keys, no bank conflicts
// Q rows, K^T [dh][SF_KLD], V [SF_KT][dh], and per warp its rows' p.
constexpr size_t SF_SMEM_FLOATS =
    (size_t)SF_BQ * SQ_DH + SQ_DH * SF_KLD + SF_KT * SQ_DH + SF_WARPS * SF_ROWS * SF_KT;

__global__ void __launch_bounds__(SF_THREADS) seq_attn_f32_kernel(SeqAttnArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* KT = Qs + SF_BQ * SQ_DH;
  float* Vs = KT + SQ_DH * SF_KLD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* Ps = Vs + SF_KT * SQ_DH + warp * SF_ROWS * SF_KT;
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int q0 = blockIdx.x * SF_BQ;
  const size_t in_off = (size_t)b * p.in_b + (size_t)h * p.in_h;
  const float* qg = static_cast<const float*>(p.q) + in_off;
  const float* kg = static_cast<const float*>(p.k) + in_off;
  const float* vg = static_cast<const float*>(p.v) + in_off;

  for (int e = tid; e < SF_BQ * SQ_DH; e += SF_THREADS) {
    const int r = e / SQ_DH, cc = e % SQ_DH;
    Qs[e] = q0 + r < p.n ? qg[(size_t)(q0 + r) * p.in_r + cc] : 0.0f;
  }
  const int ntiles = (p.n_valid + SF_KT - 1) / SF_KT;
  float m[SF_ROWS], l[SF_ROWS], acc[SF_ROWS][2];
#pragma unroll
  for (int r = 0; r < SF_ROWS; ++r) {
    m[r] = -1e30f;
    l[r] = 0.0f;
    acc[r][0] = acc[r][1] = 0.0f;
  }
  const float* qw = Qs + warp * SF_ROWS * SQ_DH;

  // pass 0: running max and sum of each row; pass 1: p and p v
  for (int pass = 0; pass < 2; ++pass) {
    for (int t = 0; t < ntiles; ++t) {
      __syncthreads();  // the previous tile is consumed (and Q has landed)
      for (int e = tid; e < SF_KT * SQ_DH; e += SF_THREADS) {
        const int r = e / SQ_DH, cc = e % SQ_DH;
        const int key = t * SF_KT + r;
        const bool ok = key < p.n_valid;
        KT[cc * SF_KLD + r] = ok ? kg[(size_t)key * p.in_r + cc] : 0.0f;
        if (pass == 1) Vs[e] = ok ? vg[(size_t)key * p.in_r + cc] : 0.0f;
      }
      __syncthreads();
      float s[SF_ROWS][2];
#pragma unroll
      for (int r = 0; r < SF_ROWS; ++r) s[r][0] = s[r][1] = 0.0f;
      for (int d = 0; d < SQ_DH; ++d) {
        const float k0 = KT[d * SF_KLD + lane], k1 = KT[d * SF_KLD + lane + 32];
#pragma unroll
        for (int r = 0; r < SF_ROWS; ++r) {
          const float qv = qw[r * SQ_DH + d];
          s[r][0] = fmaf(qv, k0, s[r][0]);
          s[r][1] = fmaf(qv, k1, s[r][1]);
        }
      }
      const bool ok0 = t * SF_KT + lane < p.n_valid;
      const bool ok1 = t * SF_KT + lane + 32 < p.n_valid;
#pragma unroll
      for (int r = 0; r < SF_ROWS; ++r) {
        s[r][0] = ok0 ? s[r][0] * p.scale : -INFINITY;
        s[r][1] = ok1 ? s[r][1] * p.scale : -INFINITY;
      }
      if (pass == 0) {
#pragma unroll
        for (int r = 0; r < SF_ROWS; ++r) {
          const float mn = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
          const float part = warp_sum(expf(s[r][0] - mn) + expf(s[r][1] - mn));
          l[r] = l[r] * expf(m[r] - mn) + part;
          m[r] = mn;
        }
        continue;
      }
#pragma unroll
      for (int r = 0; r < SF_ROWS; ++r) {
        Ps[r * SF_KT + lane] = expf(s[r][0] - m[r]) / l[r];
        Ps[r * SF_KT + lane + 32] = expf(s[r][1] - m[r]) / l[r];
      }
      __syncwarp();
      for (int j = 0; j < SF_KT; ++j) {
        const float v0 = Vs[j * SQ_DH + lane], v1 = Vs[j * SQ_DH + lane + 32];
#pragma unroll
        for (int r = 0; r < SF_ROWS; ++r) {
          const float pv = Ps[r * SF_KT + j];
          acc[r][0] = fmaf(pv, v0, acc[r][0]);
          acc[r][1] = fmaf(pv, v1, acc[r][1]);
        }
      }
      __syncwarp();  // Ps is rewritten by the next tile
    }
  }

  float* og = static_cast<float*>(p.o) + (size_t)b * p.out_b + (size_t)h * p.out_h;
#pragma unroll
  for (int r = 0; r < SF_ROWS; ++r) {
    const int row = q0 + warp * SF_ROWS + r;
    if (row >= p.n) continue;
    og[(size_t)row * p.out_r + lane] = acc[r][0];
    og[(size_t)row * p.out_r + lane + 32] = acc[r][1];
  }
}

inline cudaError_t seq_attn_f32_enable() {
  return cudaFuncSetAttribute(seq_attn_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(SF_SMEM_FLOATS * sizeof(float)));
}

inline cudaError_t launch_seq_attn_f32(const SeqAttnArgs& p, int batch, cudaStream_t stream) {
  if (p.n < 1 || p.n_valid < 1 || p.n_valid > p.n) return cudaErrorInvalidValue;
  const dim3 grid((p.n + SF_BQ - 1) / SF_BQ, batch * p.heads);
  seq_attn_f32_kernel<<<grid, SF_THREADS, SF_SMEM_FLOATS * sizeof(float), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace VFT_NS
