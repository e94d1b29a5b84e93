// The softmax attention over a whole sequence in f32 (mha.cu K7 / K8 in
// f32), on strided q, k and v; include after common.cuh.  K7 / K8 in bf16
// and K9 are mha_wgmma.cuh's kernel.
//
// The operands are read by strides, so one kernel takes the packed
// (B, N, 3D) qkv tensor (q, k and v are column blocks of one row) and the
// (B, H, N, Dh) layout alike; the JAX wrappers' head-split transposes and
// their padding of N are layout, not function.  Head dim 64.
//
//   seq_attn_f32_kernel  the softmax attention in f32 (K7 / K8 in f32)
//       with true f32 fma on the CUDA cores: no TF32, no bf16 staging.  One
//       pass over the keys with a running max and sum (in f32 the online
//       form is the exact softmax's function), register-tiled like an
//       SGEMM: each lane an 8 x 8 micro-tile of s and of o, fed by float4
//       reads of shared memory; the next K / V tile copied by cp.async
//       while this one's products run.

#pragma once

namespace VFT_NS {

constexpr int SF_DH = 64;  // head dim

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
  float scale;
};

// ---------------------------------------------------------------------------
// The softmax attention in f32 (K7 / K8 in f32)
// ---------------------------------------------------------------------------
//
// One pass over the keys with a running max and sum, register-tiled like an
// SGEMM on the CUDA cores in true f32 fma (no TF32, no bf16 staging).  In
// f32 the rounding of p to the dtype is the identity, so the online form
// computes the exact softmax's function up to f32 rounding: per SF_KT-key
// tile, m_new = max(m, max_tile s), alpha = exp(m - m_new), e = exp(s -
// m_new), l = l alpha + sum e, acc = acc alpha + e v; o = acc / l.
//
// A block of SF_WARPS warps takes SF_BQ query rows of one (image, head),
// each warp 32 of them.  A lane (rg = lane / 8, kg = lane % 8) holds rows
// rg + 4 i (i < 8) of its warp:
//   s   keys kg + 8 j (j < 8) of the tile, an 8 x 8 micro-tile; q and k
//       are read along the head dim in float4s, 16 shared loads for 256
//       fma (a quarter warp reads one q piece, or eight k pieces of one
//       128-byte row of banks);
//   o   columns 4 kg .. 4 kg + 3 and 32 + 4 kg .. 32 + 4 kg + 3, an 8 x 8
//       micro-tile over the tile's keys; e (through the warp's own shared
//       rows) and v in float4s, again 16 loads for 256 fma.
// The K and V tiles stream through shared memory by cp.async in 16-byte
// pieces (keys at or past n_valid zero-filled), each in its own slot and in
// alternation: the next tile's K lands while this tile's e v runs, its V
// while the next q k^T runs.  One slot each leaves room for Q and e, so two
// blocks (8 warps) share an SM.  The last key tile computes only its
// 16-key groups before n_valid, and a warp whose rows all lie past n does
// no products: at 197 tokens 224 of 256 padded rows and 208 keys.
//
// Bound: 4 N^2 64 flop a head, 7.6 GFLOP at the per-tensor int8 forward's
// (64, 197, 2304): 114 us at the 67 TFLOP/s of f32 outside the tensor
// cores, against 155 MB of traffic (q, k, v and o; 46 us at 3.35 TB/s).
// With the padding the products are 9.2 GFLOP (137 us).  What holds it at
// ~0.31 ms on the H100 (PERF.md, experiments/torch_f32_attn_variants.py):
// the products run at ~50 TFLOP/s, and the softmax (~0.06 ms), the tile
// copies and the first touch of q, k and v (~0.07 ms) do not overlap them.

constexpr int SF_WARPS = 4;
constexpr int SF_THREADS = SF_WARPS * 32;
constexpr int SF_WROWS = 32;                // query rows per warp
constexpr int SF_BQ = SF_WROWS * SF_WARPS;  // per block
constexpr int SF_KT = 64;                   // keys per tile
constexpr int SF_KJ = SF_KT / 8;            // keys per lane
constexpr int SF_MIN_BLOCKS = 2;            // blocks an SM
constexpr int SF_KLD = SF_DH + 4;  // Q / K rows: consecutive rows 4 banks apart
constexpr int SF_VLD = SF_DH;      // V rows, read along the row
constexpr int SF_PLD = SF_KT + 8;  // e rows: a warp's four row groups 8 banks apart
constexpr int SF_Q_FLOATS = SF_BQ * SF_KLD;
constexpr int SF_K_FLOATS = SF_KT * SF_KLD;
constexpr int SF_V_FLOATS = SF_KT * SF_VLD;
// Q rows, the K slot, the V slot, each warp's e rows.
constexpr size_t SF_SMEM_BYTES =
    (size_t)(SF_Q_FLOATS + SF_K_FLOATS + SF_V_FLOATS + SF_WARPS * SF_WROWS * SF_PLD) *
    sizeof(float);

// s[i][j] = q(row rg + 4 i) . k(key kg + 8 j) for j < NJ, summed along the
// head dim in order by fma.
template <int NJ>
__device__ __forceinline__ void sf_scores(float (&s)[8][SF_KJ], const float* qw, const float* ks) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < SF_KJ; ++j) s[i][j] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < SF_DH; d += 4) {
    float4 q[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) q[i] = *reinterpret_cast<const float4*>(qw + 4 * i * SF_KLD + d);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 k = *reinterpret_cast<const float4*>(ks + 8 * j * SF_KLD + d);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[i][j] = fmaf(q[i].x, k.x, s[i][j]);
        s[i][j] = fmaf(q[i].y, k.y, s[i][j]);
        s[i][j] = fmaf(q[i].z, k.z, s[i][j]);
        s[i][j] = fmaf(q[i].w, k.w, s[i][j]);
      }
    }
  }
}

// sf_scores<NJ> for the fewest pairs of 8-key columns that hold the nj
// columns before n_valid.
template <int NJ>
__device__ __forceinline__ void sf_scores_upto(int nj, float (&s)[8][SF_KJ], const float* qw,
                                               const float* ks) {
  if constexpr (NJ > 2) {
    if (nj <= NJ - 2) {
      sf_scores_upto<NJ - 2>(nj, s, qw, ks);
      return;
    }
  }
  sf_scores<NJ>(s, qw, ks);
}

__global__ void __launch_bounds__(SF_THREADS, SF_MIN_BLOCKS) seq_attn_f32_kernel(SeqAttnArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + SF_Q_FLOATS;
  float* Vs = Ks + SF_K_FLOATS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane >> 3, kg = lane & 7;
  float* Pw = Vs + SF_V_FLOATS + warp * SF_WROWS * SF_PLD;
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int q0 = blockIdx.x * SF_BQ;
  const size_t in_off = (size_t)b * p.in_b + (size_t)h * p.in_h;
  const float* qp = static_cast<const float*>(p.q) + in_off;
  const float* kp = static_cast<const float*>(p.k) + in_off;
  const float* vp = static_cast<const float*>(p.v) + in_off;
  const int ntiles = (p.n_valid + SF_KT - 1) / SF_KT;

  // Rows of tile t into a slot; keys at or past n_valid are zero-filled
  // (their scores are masked and their e is 0).
  auto load = [&](float* slot, int ld, const float* src, int t) {
    for (int ch = tid; ch < SF_KT * 16; ch += SF_THREADS) {
      const int r = ch >> 4, c = (ch & 15) * 4;
      const int key = t * SF_KT + r;
      const bool ok = key < p.n_valid;
      cp_async16(slot + r * ld + c, src + (size_t)(ok ? key : 0) * p.in_r + c, ok);
    }
  };
  for (int ch = tid; ch < SF_BQ * 16; ch += SF_THREADS) {
    const int r = ch >> 4, c = (ch & 15) * 4;
    const bool ok = q0 + r < p.n;
    cp_async16(Qs + r * SF_KLD + c, qp + (size_t)(ok ? q0 + r : 0) * p.in_r + c, ok);
  }
  load(Ks, SF_KLD, kp, 0);
  cp_async_commit();
  load(Vs, SF_VLD, vp, 0);
  cp_async_commit();

  const bool active = q0 + warp * SF_WROWS < p.n;  // else the warp only copies
  const float* qw = Qs + (warp * SF_WROWS + rg) * SF_KLD;
  const float* ks = Ks + kg * SF_KLD;
  const float* pw = Pw + rg * SF_PLD;
  float acc[8][8], m[8], l[8];  // rows rg + 4 i; columns 4 kg + c, 32 + 4 kg + c
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;  // this lane's share of the row sum
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;
  }

  for (int t = 0; t < ntiles; ++t) {
    // Groups in flight: K of tile t, then V of tile t.
    cp_async_wait<1>();
    __syncthreads();  // K (and at t = 0, Q) of tile t visible
    const int nk = min(SF_KT, p.n_valid - t * SF_KT);  // valid keys of the tile
    if (active) {
      float s[8][SF_KJ];
      sf_scores_upto<SF_KJ>((nk + 7) >> 3, s, qw, ks);  // 8-key columns holding a valid key
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float mt = -INFINITY;
#pragma unroll
        for (int j = 0; j < SF_KJ; ++j) {
          s[i][j] = kg + 8 * j < nk ? s[i][j] * p.scale : -INFINITY;
          mt = fmaxf(mt, s[i][j]);
        }
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
        // every tile holds a valid key, so mn is finite; the first
        // tile's alpha is exp(-inf) = 0
        const float mn = fmaxf(m[i], mt);
        const float alpha = expf(m[i] - mn);
        m[i] = mn;
        float part = 0.0f;
#pragma unroll
        for (int j = 0; j < SF_KJ; ++j) {
          const float e = expf(s[i][j] - mn);
          part += e;
          Pw[(rg + 4 * i) * SF_PLD + kg + 8 * j] = e;
        }
        l[i] = l[i] * alpha + part;
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with K; V of tile t visible
    if (t + 1 < ntiles) load(Ks, SF_KLD, kp, t + 1);
    cp_async_commit();
    if (active) {
      // acc += e v over the tile's keys, four at a time (e is 0 past nk)
      const int kend = (nk + 3) & ~3;
#pragma unroll 2
      for (int j = 0; j < kend; j += 4) {
        float4 e[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) e[i] = *reinterpret_cast<const float4*>(pw + 4 * i * SF_PLD + j);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 v0 = *reinterpret_cast<const float4*>(Vs + (j + u) * SF_VLD + 4 * kg);
          const float4 v1 = *reinterpret_cast<const float4*>(Vs + (j + u) * SF_VLD + 32 + 4 * kg);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float eu = u == 0 ? e[i].x : u == 1 ? e[i].y : u == 2 ? e[i].z : e[i].w;
            acc[i][0] = fmaf(eu, v0.x, acc[i][0]);
            acc[i][1] = fmaf(eu, v0.y, acc[i][1]);
            acc[i][2] = fmaf(eu, v0.z, acc[i][2]);
            acc[i][3] = fmaf(eu, v0.w, acc[i][3]);
            acc[i][4] = fmaf(eu, v1.x, acc[i][4]);
            acc[i][5] = fmaf(eu, v1.y, acc[i][5]);
            acc[i][6] = fmaf(eu, v1.z, acc[i][6]);
            acc[i][7] = fmaf(eu, v1.w, acc[i][7]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with V and its e rows
    if (t + 1 < ntiles) load(Vs, SF_VLD, vp, t + 1);
    cp_async_commit();
  }
  cp_async_wait<0>();
  if (!active) return;

  float* og = static_cast<float*>(p.o) + (size_t)b * p.out_b + (size_t)h * p.out_h;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float sum = l[i];
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const int row = q0 + warp * SF_WROWS + rg + 4 * i;
    if (row >= p.n) continue;
    float* orow = og + (size_t)row * p.out_r + 4 * kg;
    *reinterpret_cast<float4*>(orow) =
        make_float4(acc[i][0] / sum, acc[i][1] / sum, acc[i][2] / sum, acc[i][3] / sum);
    *reinterpret_cast<float4*>(orow + 32) =
        make_float4(acc[i][4] / sum, acc[i][5] / sum, acc[i][6] / sum, acc[i][7] / sum);
  }
}

inline cudaError_t seq_attn_f32_enable() {
  return cudaFuncSetAttribute(seq_attn_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)SF_SMEM_BYTES);
}

inline cudaError_t launch_seq_attn_f32(const SeqAttnArgs& p, int batch, cudaStream_t stream) {
  if (p.n < 1 || p.n_valid < 1 || p.n_valid > p.n) return cudaErrorInvalidValue;
  const dim3 grid((p.n + SF_BQ - 1) / SF_BQ, batch * p.heads);
  seq_attn_f32_kernel<<<grid, SF_THREADS, SF_SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace VFT_NS
