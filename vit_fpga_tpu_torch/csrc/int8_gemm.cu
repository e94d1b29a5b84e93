// K13: the int8 x int8 -> int32 GEMM on Hopper (sm_90a).
//
// Replaces vit_fpga_tpu/ops/quant.py:_int8_gemm_kernel (wrapper
// int8_gemm_pallas): C = A B for A (M, K) int8 and B (K, N) int8, C (M, N)
// int32, the sums exact.  It carries the dense network's bit-exact int8
// datapath (NetCUDA(compute_dtype="int8") -> mlp_forward_int8 ->
// int8_linear), whose f32 epilogue (bias requantized to int32, one f32
// multiply) stays in PyTorch ops, as the JAX package leaves it to XLA.
//
// The GEMM is quant.cuh's wmma int8 GEMM (128 x 128 x 64 block tiles, a
// 4-deep cp.async ring, exact int32 accumulation in 16x16x16 signed-char
// fragments) with its raw int32 epilogue, EPI_I32.  It reads B transposed,
// (N, K) k-contiguous, as the int8 forward lays the weight out once.  Rows
// past M and columns past N are masked; K is a multiple of 16 (the wrapper
// pads a ragged K with zero columns of A and rows of B, which adds exact
// zeros), and a last K step shorter than 64 (K = 784 in the MNIST-sized
// network: 12 full steps and 16) is zero-filled in shared memory.
//
// What bounds it on the H100: at the ViT-B MLP shape (12 800, 768) x (768,
// 3072) it does 60.4 G int8 operations (0.031 ms at 1979 TOPS) but writes a
// 157 MB int32 output (169 MB in all, 0.051 ms at 3.35 TB/s): bound by
// bytes, as is the dense network's (10 000, 784) x (784, 256) (18.3 MB,
// 0.005 ms).  The design is the simplest right one, shared with the
// other int8 kernels; the int32 output is written once, 32 bytes a lane.

#define VFT_NS int8_gemm
#include "common.cuh"
#include "quant.cuh"

using namespace VFT_NS;

extern "C" {

// Opts the GEMM in to its shared memory, on the current device.  Called
// once per device before the first launch.  Returns a cudaError_t.
int vft_int8_gemm_init() { return qgemm_enable<EPI_I32>(); }

// a: (m, k) int8; bt: (n, k) int8 (the (k, n) operand transposed); c: (m, n)
// int32.  k % 16 == 0; all three 16-byte aligned.  Enqueued on `stream`,
// which belongs to the current device.  Returns a cudaError_t.
int vft_int8_gemm(const void* a, const void* bt, void* c, int m, int k, int n, void* stream) {
  QGemmArgs g{};
  g.A = static_cast<const signed char*>(a);
  g.B = static_cast<const signed char*>(bt);
  g.C = c;
  g.M = m;
  g.N = n;
  g.K = k;
  return launch_qgemm<EPI_I32>(g, reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
