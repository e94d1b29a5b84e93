// K13: the int8 x int8 -> int32 GEMM on Hopper (sm_90a).
//
// Replaces vit_fpga_tpu/ops/quant.py:_int8_gemm_kernel (wrapper
// int8_gemm_pallas): C = A B for A (M, K) int8 and B (K, N) int8, C (M, N)
// int32, the sums exact.  It carries the dense network's bit-exact int8
// datapath (NetCUDA(compute_dtype="int8") -> mlp_forward_int8 ->
// int8_linear) and the linears of the per-tensor int8 ViT forward, whose f32
// epilogue (bias requantized to int32, one f32 multiply) stays in PyTorch
// ops, as the JAX package leaves it to XLA.
//
// The GEMM is qgemm_wgmma.cuh's: a persistent block per SM, a producer
// thread streaming 128-deep K steps of A and of B by TMA into a 4-stage
// mbarrier ring, two consumer warpgroups on wgmma.m64nNk32.s32.s8.s8 (N 256
// or 128 columns a tile), and the int32 tile stored by TMA from staging
// buffers while the next tile's products run (masked register stores where
// N % 4 != 0).  It reads B transposed, (N, K) k-contiguous, as the int8
// forward lays the weight out once: both operands K-major, as 8-bit wgmma
// takes them.  TMA zero-fills K past the tensor, so the dense net's K = 784
// needs no padding; K must be a multiple of 16 (TMA's 16-byte row stride:
// the wrapper pads K = 1 to 16 with zero columns of A and rows of B, which
// add exact zeros).
//
// What bounds it on the H100: at the ViT-B MLP shape (12 800, 768) x (768,
// 3072) it does 60.4 G int8 operations (0.031 ms at 1979 TOPS) but writes a
// 157 MB int32 output (169 MB in all, 0.051 ms at 3.35 TB/s): bound by
// bytes, as is the dense network's (10 000, 784) x (784, 256) (18.3 MB,
// 0.005 ms).  Hence the overlapped store.

#define VFT_NS int8_gemm
#include "common.cuh"
#include "hopper.cuh"
#include "qgemm_wgmma.cuh"

using namespace VFT_NS;

extern "C" {

// Finds the driver's cuTensorMapEncodeTiled and opts the GEMM in to its
// shared memory, on the current device.  Called once per device before the
// first launch.  Returns a cudaError_t.
int vft_int8_gemm_init() {
  cudaError_t err = tma_init();
  if (err != cudaSuccess) return err;
  return qgemm_wgmma_enable();
}

// a: (m, k) int8; bt: (n, k) int8 (the (k, n) operand transposed); c: (m, n)
// int32.  k % 16 == 0; all three 16-byte aligned.  Enqueued on `stream`,
// which belongs to the current device.  Returns a cudaError_t.
int vft_int8_gemm(const void* a, const void* bt, void* c, int m, int k, int n, void* stream) {
  if (tma_encoder() == nullptr) return cudaErrorInitializationError;
  return launch_qgemm_wgmma(static_cast<const signed char*>(a),
                            static_cast<const signed char*>(bt), static_cast<int*>(c), m, n, k,
                            reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
