// The softmax attention over a whole sequence in f32, on strided q, k and
// v; include after common.cuh.  One kernel, two modes:
//
//   SF_ONLINE        K7 / K8 in f32 (mha.cu), K9 in f32 (flash_attn.cu) and
//                    K4's safe_softmax in f32 (attn_half_f32.cuh):
//                    s = (q . k) * scale, the exact softmax by a running max
//                    and sum, o = acc / l (the JAX kernels scale q first and
//                    multiply by 1 / l: one f32 rounding apart)
//   SF_HALF_MAXFREE  the f32 attention halves' max-free softmax (K1, K4):
//                    q scaled first, e = exp(clip(s, -70, 80)) with no max,
//                    o = acc * (1 / sum e)
//
// Keys at or past n_valid are masked (their e is 0) in every mode.  The
// operands are read by strides, so one kernel takes the packed (B, N, 3D)
// qkv tensor (q, k and v are column blocks of one row) and the
// (B, H, N, Dh) layout alike; the JAX wrappers' head-split transposes and
// their padding of N are layout, not function.  Head dim 64 or 80 (DH).
//
// True f32 fma on the CUDA cores: no TF32 and no rounding of e to a
// narrower type.  In f32 the rounding of p to the dtype is the identity, so
// the online form computes the exact softmax's function up to f32
// rounding, whatever the key blocks (K9's bk) of the plain version: per
// SF_KT-key tile, m_new = max(m, max_tile s), alpha = exp(m - m_new), e =
// exp(s - m_new), l = l alpha + sum e, acc = acc alpha + e v.
//
// A block of SF_WARPS warps takes SF_BQ query rows of one (image, head),
// each warp 32 of them.  A lane (rg = lane / 8, kg = lane % 8) holds rows
// rg + 4 i (i < 8) of its warp:
//   s   keys kg + 8 j (j < 8) of the tile, an 8 x 8 micro-tile; q and k
//       are read along the head dim in float4s, 16 (DH 64) shared loads for
//       256 fma (a quarter warp reads one q piece, or eight k pieces of one
//       128-byte row of banks);
//   o   columns 4 kg .. 4 kg + 3 and 32 + 4 kg .. 32 + 4 kg + 3, and at DH
//       80 also 64 + 2 kg, 64 + 2 kg + 1: an 8 x (DH / 8) micro-tile over
//       the tile's keys; e (through the warp's own shared rows) and v in
//       float4s (the last two columns a float2).
// The K and V tiles stream through shared memory by cp.async in 16-byte
// pieces (keys at or past n_valid zero-filled), each in its own slot and in
// alternation: the next tile's K lands while this tile's e v runs, its V
// while the next q k^T runs.  One slot each leaves room for Q and e, so at
// DH 64 two blocks (8 warps) share an SM (DH 80: one).  The last key tile
// computes only its 16-key groups before n_valid, and a warp whose rows all
// lie past n does no products: at 197 tokens 224 of 256 padded rows and 208
// keys.
//
// Bound: 4 N^2 DH flop a head, 7.6 GFLOP at the per-tensor int8 forward's
// (64, 197, 2304): 114 us at the 67 TFLOP/s of f32 outside the tensor
// cores, against 155 MB of traffic (q, k, v and o; 46 us at 3.35 TB/s).
// With the padding the products are 9.2 GFLOP (137 us).  What holds it at
// ~0.31 ms on the H100 (PERF.md, experiments/torch_f32_attn_variants.py):
// the products run at ~50 TFLOP/s, and the softmax (~0.06 ms), the tile
// copies and the first touch of q, k and v (~0.07 ms) do not overlap them.

#pragma once

namespace VFT_NS {

enum SfMode { SF_ONLINE = 0, SF_HALF_MAXFREE = 1 };

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

constexpr int SF_WARPS = 4;
constexpr int SF_THREADS = SF_WARPS * 32;
constexpr int SF_WROWS = 32;                // query rows per warp
constexpr int SF_BQ = SF_WROWS * SF_WARPS;  // per block
constexpr int SF_KT = 64;                   // keys per tile
constexpr int SF_KJ = SF_KT / 8;            // keys per lane
constexpr int SF_PLD = SF_KT + 8;  // e rows: a warp's four row groups 8 banks apart
constexpr float SF_EXP_LO = -70.0f, SF_EXP_HI = 80.0f;  // the max-free clip window

template <int DH>
struct SfDim {
  static_assert(DH == 64 || DH == 80, "head dim 64 or 80");
  static constexpr int KLD = DH + 4;   // Q / K rows: consecutive rows 4 banks apart
  static constexpr int VLD = DH;       // V rows, read along the row
  static constexpr int CHUNKS = DH / 4;  // 16-byte pieces a row
  static constexpr int OC = DH / 8;    // output columns a lane
  static constexpr int MIN_BLOCKS = DH == 64 ? 2 : 1;  // blocks an SM
  static constexpr int Q_FLOATS = SF_BQ * KLD;
  static constexpr int K_FLOATS = SF_KT * KLD;
  static constexpr int V_FLOATS = SF_KT * VLD;
  // Q rows, the K slot, the V slot, each warp's e rows.
  static constexpr size_t SMEM_BYTES =
      (size_t)(Q_FLOATS + K_FLOATS + V_FLOATS + SF_WARPS * SF_WROWS * SF_PLD) * sizeof(float);
};

// s[i][j] = q(row rg + 4 i) . k(key kg + 8 j) for j < NJ, summed along the
// head dim in order by fma.
template <int DH, int NJ>
__device__ __forceinline__ void sf_scores(float (&s)[8][SF_KJ], const float* qw, const float* ks) {
  constexpr int KLD = SfDim<DH>::KLD;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < SF_KJ; ++j) s[i][j] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < DH; d += 4) {
    float4 q[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) q[i] = *reinterpret_cast<const float4*>(qw + 4 * i * KLD + d);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 k = *reinterpret_cast<const float4*>(ks + 8 * j * KLD + d);
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

// sf_scores<DH, NJ> for the fewest pairs of 8-key columns that hold the nj
// columns before n_valid.
template <int DH, int NJ>
__device__ __forceinline__ void sf_scores_upto(int nj, float (&s)[8][SF_KJ], const float* qw,
                                               const float* ks) {
  if constexpr (NJ > 2) {
    if (nj <= NJ - 2) {
      sf_scores_upto<DH, NJ - 2>(nj, s, qw, ks);
      return;
    }
  }
  sf_scores<DH, NJ>(s, qw, ks);
}

template <int DH, int MODE>
__global__ void __launch_bounds__(SF_THREADS, SfDim<DH>::MIN_BLOCKS)
    seq_attn_f32_kernel(SeqAttnArgs p) {
  using Dim = SfDim<DH>;
  constexpr int KLD = Dim::KLD, VLD = Dim::VLD, CH = Dim::CHUNKS, OC = Dim::OC;
  constexpr bool MAXFREE = MODE == SF_HALF_MAXFREE;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + Dim::Q_FLOATS;
  float* Vs = Ks + Dim::K_FLOATS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane >> 3, kg = lane & 7;
  float* Pw = Vs + Dim::V_FLOATS + warp * SF_WROWS * SF_PLD;
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
    for (int ch = tid; ch < SF_KT * CH; ch += SF_THREADS) {
      const int r = ch / CH, c = (ch % CH) * 4;
      const int key = t * SF_KT + r;
      const bool ok = key < p.n_valid;
      cp_async16(slot + r * ld + c, src + (size_t)(ok ? key : 0) * p.in_r + c, ok);
    }
  };
  for (int ch = tid; ch < SF_BQ * CH; ch += SF_THREADS) {
    const int r = ch / CH, c = (ch % CH) * 4;
    const bool ok = q0 + r < p.n;
    cp_async16(Qs + r * KLD + c, qp + (size_t)(ok ? q0 + r : 0) * p.in_r + c, ok);
  }
  load(Ks, KLD, kp, 0);
  cp_async_commit();
  load(Vs, VLD, vp, 0);
  cp_async_commit();

  const bool active = q0 + warp * SF_WROWS < p.n;  // else the warp only copies
  const float* qw = Qs + (warp * SF_WROWS + rg) * KLD;
  const float* ks = Ks + kg * KLD;
  const float* pw = Pw + rg * SF_PLD;
  float acc[8][OC], m[8], l[8];  // rows rg + 4 i; columns 4 kg + c, 32 + 4 kg + c (, 64 + 2 kg + c)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;  // this lane's share of the row sum
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.0f;
  }

  for (int t = 0; t < ntiles; ++t) {
    // Groups in flight: K of tile t, then V of tile t.
    cp_async_wait<1>();
    if (MAXFREE && t == 0) {
      // the max-free mode scales q in f32 before the products, as the JAX
      // kernels do (the clip reads the scaled scores): each thread scales
      // the pieces it copied (they are its own to
      // read once its copies are complete)
      for (int ch = tid; ch < SF_BQ * CH; ch += SF_THREADS) {
        float4* qv = reinterpret_cast<float4*>(Qs + (ch / CH) * KLD + (ch % CH) * 4);
        float4 v = *qv;
        v.x *= p.scale;
        v.y *= p.scale;
        v.z *= p.scale;
        v.w *= p.scale;
        *qv = v;
      }
    }
    __syncthreads();  // K (and at t = 0, Q) of tile t visible
    const int nk = min(SF_KT, p.n_valid - t * SF_KT);  // valid keys of the tile
    if (active) {
      float s[8][SF_KJ];
      sf_scores_upto<DH, SF_KJ>((nk + 7) >> 3, s, qw, ks);  // 8-key columns holding a valid key
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if constexpr (MAXFREE) {
          float part = 0.0f;
#pragma unroll
          for (int j = 0; j < SF_KJ; ++j) {
            const float e =
                kg + 8 * j < nk ? expf(fminf(fmaxf(s[i][j], SF_EXP_LO), SF_EXP_HI)) : 0.0f;
            part += e;
            Pw[(rg + 4 * i) * SF_PLD + kg + 8 * j] = e;
          }
          l[i] += part;
        } else {
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
          for (int c = 0; c < OC; ++c) acc[i][c] *= alpha;
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with K; V of tile t visible
    if (t + 1 < ntiles) load(Ks, KLD, kp, t + 1);
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
          const float* vr = Vs + (j + u) * VLD;
          const float4 v0 = *reinterpret_cast<const float4*>(vr + 4 * kg);
          const float4 v1 = *reinterpret_cast<const float4*>(vr + 32 + 4 * kg);
          float2 v2 = make_float2(0.0f, 0.0f);
          if constexpr (OC == 10) v2 = *reinterpret_cast<const float2*>(vr + 64 + 2 * kg);
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
            if constexpr (OC == 10) {
              acc[i][8] = fmaf(eu, v2.x, acc[i][8]);
              acc[i][9] = fmaf(eu, v2.y, acc[i][9]);
            }
          }
        }
      }
    }
    __syncthreads();  // every warp is done with V and its e rows
    if (t + 1 < ntiles) load(Vs, VLD, vp, t + 1);
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
    float o[OC];
    if constexpr (MAXFREE) {
      const float r = 1.0f / sum;  // the JAX kernels' reciprocal, then pv * r
#pragma unroll
      for (int c = 0; c < OC; ++c) o[c] = acc[i][c] * r;
    } else {
#pragma unroll
      for (int c = 0; c < OC; ++c) o[c] = acc[i][c] / sum;
    }
    float* orow = og + (size_t)row * p.out_r;
    *reinterpret_cast<float4*>(orow + 4 * kg) = make_float4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<float4*>(orow + 32 + 4 * kg) = make_float4(o[4], o[5], o[6], o[7]);
    if constexpr (OC == 10)
      *reinterpret_cast<float2*>(orow + 64 + 2 * kg) = make_float2(o[8], o[9]);
  }
}

template <int DH, int MODE>
inline cudaError_t seq_attn_f32_enable() {
  return cudaFuncSetAttribute(seq_attn_f32_kernel<DH, MODE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)SfDim<DH>::SMEM_BYTES);
}

template <int DH, int MODE>
inline cudaError_t launch_seq_attn_f32(const SeqAttnArgs& p, int batch, cudaStream_t stream) {
  if (p.n < 1 || p.n_valid < 1 || p.n_valid > p.n || batch < 1 || p.heads < 1 ||
      (long long)batch * p.heads > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((p.n + SF_BQ - 1) / SF_BQ, batch * p.heads);
  seq_attn_f32_kernel<DH, MODE><<<grid, SF_THREADS, SfDim<DH>::SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace VFT_NS
