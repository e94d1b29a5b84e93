// Microbenchmark of one bf16 QKV stage's tiles (M 200, N 2304, K 768, 144
// tiles of 64 x 64) of the single-launch encoder, outside the persistent
// kernel: the tile with wmma fragments, the same with ldmatrix + mma.sync
// (stack.cuh's tile_bf16), its MMA work alone and its copies alone.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -I vit_fpga_tpu_torch/csrc experiments/torch_stack_tile_bench.cu \
//        -o tile_bench && ./tile_bench
//
// Each time includes about 3 us of back-to-back launch; the last line
// compares the two stages' outputs on random data.
#define VFT_NS tb
#include "common.cuh"
#include "quant.cuh"
#include "stack.cuh"
#include <cstdio>
#include <cstring>
#include <vector>
using namespace tb;

// The tile as wmma fragments (stack.cuh's tile_bf16 before ldmatrix).
template <typename Epi>
__device__ void tile_wmma(const bf16* A, int lda, const bf16* B, int ldb, int M, int m0, int n0,
                          int k0, int kn, unsigned char* smem, Epi epi) {
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + ST_STAGES * SA_ELEMS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  int ar[2], akc[2], bkr[2], bnc[2];
  bool aok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * SK_THREADS;
    ar[i] = c >> 3; akc[i] = (c & 7) * 8; aok[i] = m0 + ar[i] < M; bkr[i] = c >> 3; bnc[i] = (c & 7) * 8;
  }
  auto load = [&](int s, int kt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ka = kt * ST_BK + akc[i];
      const bool va = aok[i] && ka < kn;
      cp_async16(As + s * SA_ELEMS + ar[i] * SA_LD + akc[i], va ? A + (size_t)(m0 + ar[i]) * lda + k0 + ka : A, va);
      const int kb = kt * ST_BK + bkr[i];
      const bool vb = kb < kn;
      cp_async16(Bs + s * SB_ELEMS + bkr[i] * SB_LD + bnc[i], vb ? B + (size_t)(k0 + kb) * ldb + n0 + bnc[i] : B, vb);
    }
  };
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  const int nk = (kn + ST_BK - 1) / ST_BK;
  __syncthreads();
#pragma unroll
  for (int s = 0; s < ST_STAGES - 1; ++s) { if (s < nk) load(s, s); cp_async_commit(); }
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % ST_STAGES;
    cp_async_wait<ST_STAGES - 2>();
    __syncthreads();
    const int next = kt + ST_STAGES - 1;
    if (next < nk) load(next % ST_STAGES, next);
    cp_async_commit();
    const bf16* as = As + s * SA_ELEMS;
    const bf16* bs = Bs + s * SB_ELEMS;
#pragma unroll
    for (int kk = 0; kk < ST_BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, as + wm * 16 * SA_LD + kk * 16, SA_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, bs + kk * 16 * SB_LD + wn * 32 + j * 16, SB_LD);
        wmma::mma_sync(acc[j], af, bfr, acc[j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* cs = reinterpret_cast<float*>(smem) + warp * 16 * ST_C_LD;
  wmma::store_matrix_sync(cs, acc[0], ST_C_LD, wmma::mem_row_major);
  wmma::store_matrix_sync(cs + 16, acc[1], ST_C_LD, wmma::mem_row_major);
  __syncwarp();
  const int r = lane >> 1, c = (lane & 1) * 16;
  float f[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) f[t] = cs[r * ST_C_LD + c + t];
  epi(m0 + wm * 16 + r, n0 + wn * 32 + c, f);
}

__device__ unsigned int g_flag;

// mode 0: items only; mode 1: blocks without an item spin on g_flag with
// ld.acquire.gpu (as a grid barrier's waiters do) until the workers finish.
__global__ void __launch_bounds__(SK_THREADS, 2) stage_kernel(const bf16* A, const bf16* W, const float* bias,
                                                              bf16* C, int rows, int n, int k, int mode,
                                                              unsigned int* done) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int mt = (rows + ST_BM - 1) / ST_BM;
  const int items = mt * (n / ST_BN);
  if ((int)blockIdx.x >= items) {
    if (mode == 1 && threadIdx.x == 0) {
      unsigned int v;
      do {
        asm volatile("ld.acquire.gpu.u32 %0,[%1];" : "=r"(v) : "l"(done) : "memory");
      } while (v < (unsigned)items);
    }
    return;
  }
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int m0 = (it % mt) * ST_BM, n0 = (it / mt) * ST_BN;
    tile_wmma(A, k, W, n, rows, m0, n0, 0, k, smem, [&](int r, int c, float* f) {
      if (r >= rows) return;
#pragma unroll
      for (int t = 0; t < 16; ++t) f[t] = __fadd_rn(f[t], bias[c + t]);
      store16(C + (size_t)r * n + c, f);
    });
  }
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(done, 1u);
}


// The tile's MMA work alone: the same fragment loads and mma_sync over 12
// k-steps of a shared-memory ring that is never refilled.
__global__ void __launch_bounds__(SK_THREADS, 2) mma_only(bf16* C, int nk) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + ST_STAGES * SA_ELEMS;
  const int warp = threadIdx.x >> 5, wm = warp >> 1, wn = warp & 1;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % ST_STAGES;
    __syncthreads();
    const bf16* as = As + s * SA_ELEMS;
    const bf16* bs = Bs + s * SB_ELEMS;
#pragma unroll
    for (int kk = 0; kk < ST_BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, as + wm * 16 * SA_LD + kk * 16, SA_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, bs + kk * 16 * SB_LD + wn * 32 + j * 16, SB_LD);
        wmma::mma_sync(acc[j], af, bfr, acc[j]);
      }
    }
  }
  float* cs = reinterpret_cast<float*>(smem) + warp * 16 * ST_C_LD;
  __syncthreads();
  wmma::store_matrix_sync(cs, acc[0], ST_C_LD, wmma::mem_row_major);
  if (threadIdx.x == 0) C[blockIdx.x] = __float2bfloat16(cs[0]);
}

// The tile's copies alone: the cp.async ring over 12 k-steps, no MMA.
__global__ void __launch_bounds__(SK_THREADS, 2) loads_only(const bf16* A, const bf16* W, bf16* C, int rows,
                                                            int n, int k) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int mt = (rows + ST_BM - 1) / ST_BM;
  const int it = blockIdx.x;
  const int m0 = (it % mt) * ST_BM, n0 = (it / mt) * ST_BN;
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + ST_STAGES * SA_ELEMS;
  const int tid = threadIdx.x;
  int ar[2], akc[2], bkr[2], bnc[2];
  bool aok[2];
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * SK_THREADS;
    ar[i] = c >> 3; akc[i] = (c & 7) * 8; aok[i] = m0 + ar[i] < rows; bkr[i] = c >> 3; bnc[i] = (c & 7) * 8;
  }
  auto load = [&](int s, int kt) {
    for (int i = 0; i < 2; ++i) {
      const int ka = kt * ST_BK + akc[i];
      cp_async16(As + s * SA_ELEMS + ar[i] * SA_LD + akc[i], aok[i] ? A + (size_t)(m0 + ar[i]) * k + ka : A, aok[i]);
      const int kb = kt * ST_BK + bkr[i];
      cp_async16(Bs + s * SB_ELEMS + bkr[i] * SB_LD + bnc[i], W + (size_t)kb * n + n0 + bnc[i], true);
    }
  };
  const int nk = k / ST_BK;
  for (int s = 0; s < ST_STAGES - 1; ++s) { if (s < nk) load(s, s); cp_async_commit(); }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<ST_STAGES - 2>();
    __syncthreads();
    const int next = kt + ST_STAGES - 1;
    if (next < nk) load(next % ST_STAGES, next);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();
  if (tid == 0) C[blockIdx.x] = As[5];
}


__global__ void __launch_bounds__(SK_THREADS, 2) stage_ptx(const bf16* A, const bf16* W, const float* bias, bf16* C,
                                                           int rows, int n, int k) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int mt = (rows + ST_BM - 1) / ST_BM;
  const int items = mt * (n / ST_BN);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int m0 = (it % mt) * ST_BM, n0 = (it / mt) * ST_BN;
    tile_bf16(A, k, W, n, rows, m0, n0, 0, k, smem, [&](int r, int c, float* f) {
      if (r >= rows) return;
#pragma unroll
      for (int t = 0; t < 16; ++t) f[t] = __fadd_rn(f[t], bias[c + t]);
      store16(C + (size_t)r * n + c, f);
    });
  }
}

int main() {
  const int rows = 200, n = 2304, k = 768;
  bf16 *A, *W, *C;
  float* bias;
  unsigned int* done;
  cudaMalloc(&A, (size_t)rows * k * 2);
  cudaMalloc(&W, (size_t)12 * k * n * 2);  // 12 layers' worth, to defeat L2 between launches
  cudaMalloc(&C, (size_t)rows * n * 2);
  cudaMalloc(&bias, n * 4);
  cudaMalloc(&done, 4);
  cudaMemset(A, 0, (size_t)rows * k * 2);
  cudaMemset(W, 0, (size_t)12 * k * n * 2);
  cudaMemset(bias, 0, n * 4);
  const size_t smem = ST_GEMM_BYTES;
  cudaFuncSetAttribute(stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int items = ((rows + 63) / 64) * (n / 64);
  struct Case { const char* name; int blocks; int mode; };
  Case cases[] = {{"items only", items, 0}, {"264 blocks, idle exit", 264, 0}, {"264 blocks, idle spin", 264, 1}};
  for (auto& cs : cases) {
    float best = 1e9f;
    for (int rep = 0; rep < 3; ++rep) {
      const int iters = 120;
      cudaEventRecord(e0);
      for (int i = 0; i < iters; ++i) {
        cudaMemsetAsync(done, 0, 4);
        stage_kernel<<<cs.blocks, SK_THREADS, smem>>>(A, W + (size_t)(i % 12) * k * n, bias, C, rows, n, k,
                                                       cs.mode, done);
      }
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms;
      cudaEventElapsedTime(&ms, e0, e1);
      best = fminf(best, ms / iters * 1000.0f);
    }
    printf("%-24s %3d blocks: %.2f us per stage (incl. a memset)\n", cs.name, cs.blocks, best);
  }
  cudaFuncSetAttribute(mma_only, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncSetAttribute(loads_only, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  auto timeit = [&](const char* name, auto launch) {
    float best = 1e9f;
    for (int rep = 0; rep < 3; ++rep) {
      cudaEventRecord(e0);
      for (int i = 0; i < 120; ++i) launch(i);
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms;
      cudaEventElapsedTime(&ms, e0, e1);
      best = fminf(best, ms / 120 * 1000.0f);
    }
    printf("%-40s %.2f us per launch\n", name, best);
  };
  timeit("stage, weights from DRAM (12 sets)", [&](int i) {
    stage_kernel<<<items, SK_THREADS, smem>>>(A, W + (size_t)(i % 12) * k * n, bias, C, rows, n, k, 0, done); });
  timeit("stage, weights L2-hot (1 set)", [&](int i) {
    stage_kernel<<<items, SK_THREADS, smem>>>(A, W, bias, C, rows, n, k, 0, done); });
  timeit("mma only (12 k-steps)", [&](int i) { mma_only<<<items, SK_THREADS, smem>>>(C, k / ST_BK); });
  timeit("mma only (1 k-step)", [&](int i) { mma_only<<<items, SK_THREADS, smem>>>(C, 1); });
  timeit("loads only, DRAM", [&](int i) {
    loads_only<<<items, SK_THREADS, smem>>>(A, W + (size_t)(i % 12) * k * n, C, rows, n, k); });
  timeit("loads only, L2-hot", [&](int i) { loads_only<<<items, SK_THREADS, smem>>>(A, W, C, rows, n, k); });
  cudaFuncSetAttribute(stage_ptx, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  timeit("stage ptx mma, DRAM", [&](int i) {
    stage_ptx<<<items, SK_THREADS, smem>>>(A, W + (size_t)(i % 12) * k * n, bias, C, rows, n, k); });
  timeit("stage ptx mma, L2-hot", [&](int i) { stage_ptx<<<items, SK_THREADS, smem>>>(A, W, bias, C, rows, n, k); });
  // correctness: random data, compare wmma stage vs ptx stage
  {
    std::vector<unsigned short> ha((size_t)rows * k), hw((size_t)k * n);
    unsigned seed = 1;
    auto rnd = [&]() { seed = seed * 1664525u + 1013904223u; float f = ((seed >> 9) & 0xffff) / 65536.0f - 0.5f;
                       unsigned u; memcpy(&u, &f, 4); return (unsigned short)(u >> 16); };
    for (auto& v : ha) v = rnd();
    for (auto& v : hw) v = rnd();
    cudaMemcpy(A, ha.data(), ha.size() * 2, cudaMemcpyHostToDevice);
    cudaMemcpy(W, hw.data(), hw.size() * 2, cudaMemcpyHostToDevice);
    bf16* C2; cudaMalloc(&C2, (size_t)rows * n * 2);
    stage_kernel<<<items, SK_THREADS, smem>>>(A, W, bias, C, rows, n, k, 0, done);
    stage_ptx<<<items, SK_THREADS, smem>>>(A, W, bias, C2, rows, n, k);
    std::vector<unsigned short> c1((size_t)rows * n), c2((size_t)rows * n);
    cudaMemcpy(c1.data(), C, c1.size() * 2, cudaMemcpyDeviceToHost);
    cudaMemcpy(c2.data(), C2, c2.size() * 2, cudaMemcpyDeviceToHost);
    double md = 0, mx = 0;
    for (size_t i = 0; i < c1.size(); ++i) {
      unsigned u1 = (unsigned)c1[i] << 16, u2 = (unsigned)c2[i] << 16; float f1, f2; memcpy(&f1, &u1, 4); memcpy(&f2, &u2, 4);
      md = fmax(md, fabs(f1 - f2)); mx = fmax(mx, fabs(f1));
    }
    printf("wmma vs ptx stage: max diff %.4g (max |out| %.4g)\n", md, mx);
  }
  // the memset alone
  cudaEventRecord(e0);
  for (int i = 0; i < 120; ++i) cudaMemsetAsync(done, 0, 4);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  printf("memset alone: %.2f us\n", ms / 120 * 1000.0f);
  printf("err: %s\n", cudaGetErrorString(cudaGetLastError()));
  return 0;
}
