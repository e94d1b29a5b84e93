// True-f32 GEMM on the CUDA cores, with the hooks the f32 halves need;
// include after common.cuh.
//
//   gemm_f32_kernel<PRO, EPI, TM>  C (M, N) = epi(pro(A) (M, K) @ B (K, N)), all
//       f32 and row-major, every product an f32 fma on the CUDA cores: no
//       TF32 (it would round each operand to 10 mantissa bits) and no
//       tensor-core instruction of any kind.
//         PRO  FG_PRO_NONE  A as it is
//              FG_PRO_LN    the LayerNorm from given (mu, rstd) per row and
//                           (ls, lb) per column of A, ((a - mu) rstd) ls + lb,
//                           applied as A's slice is stored to shared memory
//                           (the chain's halves)
//         EPI  FG_EPI_BIAS        acc + bias
//              FG_EPI_BIAS_ACT    act(acc + bias)
//              FG_EPI_BIAS_RESID  resid + (acc + bias), resid may be C itself
//                                 (each thread reads its own elements before
//                                 it writes them): K3's chunks run as one
//                                 launch each over A's columns (lda) into the
//                                 running output, the bias on the last alone
//       A bias of nullptr adds none; K26 in f32 takes PRO_NONE and
//       EPI_STORE.
//   row_stats_f32_kernel  one-pass LayerNorm statistics of f32 rows:
//       mu = mean(x), rstd = 1 / sqrt(max(mean(x^2) - mu^2, 0) + eps).
//
// Tiling: a block of 256 threads (16 x 16) owns a BM x BM tile of C, BM =
// 16 TM: 128 x 128 (TM 8) where those tiles give every SM of the card a
// block, else 64 x 64 (TM 4, four times the blocks: K26's small GEMMs and
// the b1-3 QKV and out-projections, whose 128-wide grids leave most SMs
// idle).  Each thread holds a TM x TM micro-tile (rows 64 h + 4 ty + i,
// columns 64 h + 4 tx + j, h < TM / 4, i, j < 4), fed by 2 TM / 4 float4
// reads of shared memory a step for TM^2 fma, the next step's read while
// this step's fma run.  K advances 16 at a time: A's BM x 16 slice is read
// from device memory as float4s (TM / 4 a thread) and stored transposed
// (k-major, rows 4 floats apart) through the prologue (applied at the
// store, after this slice's fma, so that the loads stay in flight under
// them), B's 16 x BM slice likewise; two shared slots, the next slice's
// loads issued before this slice's products and stored into the other
// slot after them, one barrier a slice; two blocks an SM at least (128
// registers a thread).  Every output element takes its K products in the
// same order whatever the tile, so the two tiles give the same bits.  The
// edges are zero-filled (rows past M, columns past N, k past K, the
// prologue's output included) and never stored.  Bound: 2 M N K flop at
// 67 TFLOP/s (H100 SXM, f32 outside the tensor cores).  Measured at the
// f32 ViT-B/16 b64 forward's four shapes (experiments/
// torch_f32_gemm_variants.py, H100 80GB HBM3, 700 W): 38-44 TFLOP/s
// against torch.matmul's 43-48 (cuBLAS SGEMM, TF32 off).

#pragma once

namespace VFT_NS {

enum FgPro { FG_PRO_NONE = 0, FG_PRO_LN = 1 };
enum FgEpi { FG_EPI_STORE = 0, FG_EPI_BIAS = 1, FG_EPI_BIAS_ACT = 2, FG_EPI_BIAS_RESID = 3 };

constexpr int FG_BK = 16;         // K a slice
constexpr int FG_THREADS = 256;   // 16 x 16
constexpr int FG_MIN_BLOCKS = 2;  // blocks an SM

// The tile of TM x TM micro-tiles (TM 8 or 4).
template <int TM>
struct FgTile {
  static_assert(TM == 8 || TM == 4, "128- or 64-wide tiles");
  static constexpr int BM = 16 * TM;                         // rows and columns of C
  static constexpr int ALD = BM + 4;                         // floats per k row of A's slice
  static constexpr int LOADS = BM * FG_BK / (4 * FG_THREADS);  // float4s of A (of B) a thread
  static constexpr int H = TM / 4;                           // 64-wide halves
};

struct FgArgs {
  const float* A;      // (M, K), rows lda apart (0: K)
  const float* B;      // (K, N)
  float* C;            // (M, N)
  int M, N, K;         // N and K multiples of 4
  const float* stats;  // (M, 2) mu, rstd               [FG_PRO_LN]
  const float* ls;     // (K,)                          [FG_PRO_LN]
  const float* lb;     // (K,)                          [FG_PRO_LN]
  const float* bias;   // (N,)                          [EPI != STORE]
  const float* resid;  // (M, N), may be C             [FG_EPI_BIAS_RESID]
  int act;             // Act code                      [FG_EPI_BIAS_ACT]
  int lda;             // floats between A's rows: 0 (K) or a multiple of 4
};

// The epilogue: bias (where given), activation or residual, the store.
// The values past M or N are not stored.
template <int EPI, int TM>
__device__ __forceinline__ void fg_epilogue(const FgArgs& p, float (&acc)[TM][TM], int m0, int n0,
                                            int ty, int tx) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + 64 * (i / 4) + 4 * ty + i % 4;
    if (row >= p.M) continue;
#pragma unroll
    for (int h = 0; h < TM / 4; ++h) {
      const int col = n0 + 64 * h + 4 * tx;
      if (col >= p.N) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = acc[i][4 * h + j];
      const size_t off = (size_t)row * p.N + col;
      if constexpr (EPI != FG_EPI_STORE) {
        if (p.bias != nullptr) {
          const float4 b = *reinterpret_cast<const float4*>(p.bias + col);
          v[0] += b.x;
          v[1] += b.y;
          v[2] += b.z;
          v[3] += b.w;
        }
      }
      if constexpr (EPI == FG_EPI_BIAS_ACT) {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = apply_act(v[j], p.act);
      }
      if constexpr (EPI == FG_EPI_BIAS_RESID) {
        const float4 r = *reinterpret_cast<const float4*>(p.resid + off);
        v[0] = r.x + v[0];
        v[1] = r.y + v[1];
        v[2] = r.z + v[2];
        v[3] = r.w + v[3];
      }
      *reinterpret_cast<float4*>(p.C + off) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <int PRO, int EPI, int TM>
__global__ void __launch_bounds__(FG_THREADS, FG_MIN_BLOCKS) gemm_f32_kernel(FgArgs p) {
  using T = FgTile<TM>;
  constexpr int BM = T::BM, ALD = T::ALD, LOADS = T::LOADS;
  __shared__ __align__(16) float As[2][FG_BK * ALD];
  __shared__ __align__(16) float Bs[2][FG_BK * BM];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BM;
  // this thread's loads, l < LOADS: A row ar[l], k ak[l] .. + 3; B k row
  // bk[l], columns bn .. bn + 3 (B_CHUNKS divides FG_THREADS)
  constexpr int A_CHUNKS = FG_BK / 4;  // float4s of an A row's slice
  constexpr int B_CHUNKS = BM / 4;     // float4s of a B row's slice
  int ar[LOADS], ak[LOADS], bk[LOADS];
  const int bn = (tid % B_CHUNKS) * 4;
  bool a_row[LOADS];
  const float* a_src[LOADS];
  float mu[LOADS], rstd[LOADS];
#pragma unroll
  for (int l = 0; l < LOADS; ++l) {
    const int idx = tid + l * FG_THREADS;
    ar[l] = idx / A_CHUNKS;
    ak[l] = (idx % A_CHUNKS) * 4;
    bk[l] = idx / B_CHUNKS;
    a_row[l] = m0 + ar[l] < p.M;
    a_src[l] = p.A + (size_t)(a_row[l] ? m0 + ar[l] : 0) * (p.lda > 0 ? p.lda : p.K);
    mu[l] = rstd[l] = 0.0f;
    if constexpr (PRO == FG_PRO_LN) {
      if (a_row[l]) {
        mu[l] = p.stats[2 * (size_t)(m0 + ar[l])];
        rstd[l] = p.stats[2 * (size_t)(m0 + ar[l]) + 1];
      }
    }
  }

  auto load_a = [&](int k0, int l) {
    const int k = k0 + ak[l];
    if (a_row[l] && k < p.K) return *reinterpret_cast<const float4*>(a_src[l] + k);
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  };
  auto load_b = [&](int k0, int l) {
    const int k = k0 + bk[l], n = n0 + bn;
    if (k < p.K && n < p.N) return *reinterpret_cast<const float4*>(p.B + (size_t)k * p.N + n);
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  };
  // slice k0's loads into slot s, A through the prologue (the zero fill
  // past M and K stays zero)
  auto store = [&](int s, int k0, const float4 (&a)[LOADS], const float4 (&b)[LOADS]) {
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      float4 v = a[l];
      if constexpr (PRO == FG_PRO_LN) {
        const int k = k0 + ak[l];
        if (a_row[l] && k < p.K) {
          const float4 sc = *reinterpret_cast<const float4*>(p.ls + k);
          const float4 sh = *reinterpret_cast<const float4*>(p.lb + k);
          v.x = (v.x - mu[l]) * rstd[l] * sc.x + sh.x;
          v.y = (v.y - mu[l]) * rstd[l] * sc.y + sh.y;
          v.z = (v.z - mu[l]) * rstd[l] * sc.z + sh.z;
          v.w = (v.w - mu[l]) * rstd[l] * sc.w + sh.w;
        }
      }
      float* as = As[s] + ak[l] * ALD + ar[l];
      as[0] = v.x;
      as[ALD] = v.y;
      as[2 * ALD] = v.z;
      as[3 * ALD] = v.w;
      *reinterpret_cast<float4*>(Bs[s] + bk[l] * BM + bn) = b[l];
    }
  };
  // the fragments of step kk: A rows 64 h + 4 ty .., B columns 64 h + 4 tx ..
  auto frag = [&](const float* as, const float* bs, int kk, float (&a)[TM], float (&b)[TM]) {
    float4 av[T::H], bv[T::H];
#pragma unroll
    for (int h = 0; h < T::H; ++h) av[h] = *reinterpret_cast<const float4*>(as + kk * ALD + 64 * h + 4 * ty);
#pragma unroll
    for (int h = 0; h < T::H; ++h) bv[h] = *reinterpret_cast<const float4*>(bs + kk * BM + 64 * h + 4 * tx);
#pragma unroll
    for (int h = 0; h < T::H; ++h) {
      a[4 * h] = av[h].x; a[4 * h + 1] = av[h].y; a[4 * h + 2] = av[h].z; a[4 * h + 3] = av[h].w;
      b[4 * h] = bv[h].x; b[4 * h + 1] = bv[h].y; b[4 * h + 2] = bv[h].z; b[4 * h + 3] = bv[h].w;
    }
  };

  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.0f;

  const int nk = (p.K + FG_BK - 1) / FG_BK;
  {
    float4 a[LOADS], b[LOADS];
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      a[l] = load_a(0, l);
      b[l] = load_b(0, l);
    }
    store(0, 0, a, b);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    float4 na[LOADS], nb[LOADS];
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      na[l] = nb[l] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (kt + 1 < nk) {
        na[l] = load_a((kt + 1) * FG_BK, l);
        nb[l] = load_b((kt + 1) * FG_BK, l);
      }
    }
    const float* as = As[s];
    const float* bs = Bs[s];
    // the next step's fragments read while this step's fma run
    float a[2][TM], b[2][TM];
    frag(as, bs, 0, a[0], b[0]);
#pragma unroll
    for (int kk = 0; kk < FG_BK; ++kk) {
      if (kk + 1 < FG_BK) frag(as, bs, kk + 1, a[(kk + 1) & 1], b[(kk + 1) & 1]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(a[kk & 1][i], b[kk & 1][j], acc[i][j]);
    }
    if (kt + 1 < nk) store(s ^ 1, (kt + 1) * FG_BK, na, nb);
    __syncthreads();
  }
  fg_epilogue<EPI, TM>(p, acc, m0, n0, ty, tx);
}

template <int PRO, int EPI>
inline cudaError_t launch_gemm_f32(const FgArgs& p, cudaStream_t stream) {
  if (p.M < 1 || p.N < 1 || p.K < 1 || p.N % 4 || p.K % 4 || p.lda % 4 ||
      (p.lda > 0 && p.lda < p.K))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int wide_tiles = ((p.N + 127) / 128) * ((p.M + 127) / 128);
  const bool wide = wide_tiles >= sms;  // a 128-wide tile for every SM
  const int bm = wide ? 128 : 64;
  const dim3 grid((p.N + bm - 1) / bm, (p.M + bm - 1) / bm);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if (wide)
    gemm_f32_kernel<PRO, EPI, 8><<<grid, FG_THREADS, 0, stream>>>(p);
  else
    gemm_f32_kernel<PRO, EPI, 4><<<grid, FG_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Row statistics of f32 rows: one warp a row, a float4 a lane a step.
// ---------------------------------------------------------------------------

constexpr int FG_STATS_THREADS = 256;

__global__ void __launch_bounds__(FG_STATS_THREADS)
    row_stats_f32_kernel(const float* __restrict__ x, float* __restrict__ st, int rows, int d,
                         float eps) {
  const int row = (blockIdx.x * FG_STATS_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* xr = x + (size_t)row * d;
  float s = 0.0f, ss = 0.0f;
  for (int c = lane * 4; c < d; c += 32 * 4) {
    const float4 v = *reinterpret_cast<const float4*>(xr + c);
    s += v.x + v.y + v.z + v.w;
    ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  if (lane == 0) {
    const float mu = s / (float)d;
    const float var = fmaxf(ss / (float)d - mu * mu, 0.0f);
    st[2 * (size_t)row] = mu;
    st[2 * (size_t)row + 1] = 1.0f / sqrtf(var + eps);
  }
}

// x: (rows, d) f32, d a multiple of 4; st: (rows, 2) f32.
inline cudaError_t launch_row_stats_f32(const float* x, float* st, int rows, int d, float eps,
                                        cudaStream_t stream) {
  if (rows < 1 || d < 4 || d % 4) return cudaErrorInvalidValue;
  const int rows_per_block = FG_STATS_THREADS / 32;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  row_stats_f32_kernel<<<blocks, FG_STATS_THREADS, 0, stream>>>(x, st, rows, d, eps);
  return cudaGetLastError();
}

}  // namespace VFT_NS
