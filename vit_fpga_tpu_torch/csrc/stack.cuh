// Device pieces of the single-launch encoders (K11, K12, K19a, K19b and K20
// run on stack_wgmma.cuh's layer loop): the stage clock, the cooperative
// launch and the scalar helpers of every encoder; include after
// common.cuh and quant.cuh.
//
// The encoders are cooperative and persistent: one grid of blocks stays
// resident for the whole encoder, walks the layers in a loop and separates
// its stages with grid-wide barriers.  A stage is a list of work items
// (GEMM tiles, attention chunks, token rows) that the blocks take in turn.
//
// Data one stage writes and a later one reads (after a grid barrier) is
// read with TMA or __ldcg, so no stale line is read from L1 or through
// ld.global.nc.

#pragma once

#include <cooperative_groups.h>

namespace VFT_NS {

namespace cg = cooperative_groups;

constexpr int SK_THREADS = 256;       // full.cuh's gather gate (FULL_MAX_P3)
constexpr int ST_MAX_KV = 256;        // keys per (image, head)
constexpr int ST_DH = 64;             // head dim

__host__ __device__ inline size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

__device__ __forceinline__ void ldcg8(const bf16* p, float* f) {
  unpack8(__ldcg(reinterpret_cast<const uint4*>(p)), f);
}

__device__ __forceinline__ void ldcg8f(const float* p, float* f) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p + 4));
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// ---------------------------------------------------------------------------
// The int8 encoders' scalar helpers (stack_wgmma.cuh).
// ---------------------------------------------------------------------------

__device__ __forceinline__ float dequant(int acc, float srow, float scol, float bias) {
  return __fadd_rn(__fmul_rn((float)acc, __fmul_rn(srow, scol)), bias);
}

__device__ __forceinline__ void ldcg8i(const int* p, int* a) {
  const int4 u = __ldcg(reinterpret_cast<const int4*>(p));
  const int4 w = __ldcg(reinterpret_cast<const int4*>(p + 4));
  a[0] = u.x; a[1] = u.y; a[2] = u.z; a[3] = u.w;
  a[4] = w.x; a[5] = w.y; a[6] = w.z; a[7] = w.w;
}

// ---------------------------------------------------------------------------
// Stage clock: with a trace buffer, thread 0 of each block adds, per stage
// kind, the globaltimer nanoseconds from the end of the previous barrier
// to the end of its block's work (slot 0) and the time it then waits in
// the grid barrier (slot 1): trace[(block * ST_TRACE_KINDS + kind) * 2 +
// slot], int64, zeroed by the caller.  Without one it is the barrier alone.
// ---------------------------------------------------------------------------

constexpr int ST_TRACE_KINDS = 16;
constexpr int ST_TRACE_BLOCKS = 1024;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct StageClock {
  long long* trace;
  // The last reading (thread 0's) lives in shared memory: a 64-bit value
  // live across every stage of a layer loop would hold two registers that
  // the stages need, and ptxas spilled around the barriers for it.
  __device__ static unsigned long long& last() {
    __shared__ unsigned long long t;
    return t;
  }
  __device__ void start() {
    if (trace != nullptr && threadIdx.x == 0) last() = global_ns();
  }
  __device__ void work_done(int kind) {
    if (trace == nullptr) return;
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned long long now = global_ns();
      trace[((size_t)blockIdx.x * ST_TRACE_KINDS + kind) * 2] += (long long)(now - last());
      last() = now;
    }
  }
  // the end of stage `kind`: its work, then the grid barrier
  __device__ void sync(cg::grid_group& grid, int kind) {
    work_done(kind);
    grid.sync();
    if (trace != nullptr && threadIdx.x == 0) {
      const unsigned long long now = global_ns();
      trace[((size_t)blockIdx.x * ST_TRACE_KINDS + kind) * 2 + 1] += (long long)(now - last());
      last() = now;
    }
  }
};

// ---------------------------------------------------------------------------
// Launch: a cooperative grid of `threads`-thread blocks as large as can be
// resident at once, or a loud error (ST_TRACE_BLOCKS at most when traced).
// The grid size is kept per device and shared memory size.
// ---------------------------------------------------------------------------

inline cudaError_t coop_launch(const void* fn, void* args, size_t smem, bool traced,
                               cudaStream_t stream, int threads) {
  static int dev_smem[64];
  static int dev_blocks[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (dev_smem[dev] != (int)smem || dev_blocks[dev] == 0) {
    int coop = 0, sms = 0, occ = 0;
    if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, threads, smem)) != cudaSuccess)
      return err;
    if (occ < 1) return cudaErrorCooperativeLaunchTooLarge;
    dev_blocks[dev] = occ * sms;
    dev_smem[dev] = (int)smem;
  }
  const int blocks = traced && dev_blocks[dev] > ST_TRACE_BLOCKS ? ST_TRACE_BLOCKS : dev_blocks[dev];
  void* kargs[] = {args};
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(threads), kargs, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace VFT_NS
