// K26: the streamed GEMM on Hopper (sm_90a).
//
// Replaces vit_fpga_tpu/ops/streamed_gemm.py:_streamed_kernel (wrapper
// streamed_gemm): out = (x @ w) in x's dtype, x (T, K) and w (K, N) both f32
// or both bf16, every product summed in f32.  The TPU kernel keeps a row
// tile of x resident and streams the K-tiles of W from HBM through two VMEM
// slots with manual DMAs, starting the copy of tile k + 1 before it waits
// for tile k: the double-buffered weight stream of BASELINE config 4.
//
//   bf16: gemm_wgmma.cuh's persistent GEMM (no LN, no bias, no residual,
//         ACT_NONE): one block an SM walks 128 x 256 output tiles, one
//         producer thread streams the 64-deep K tiles of x and W by TMA into
//         a 4-stage mbarrier ring, two consumer warpgroups issue
//         wgmma.m64n256k16 on each landed stage.  The same weight stream as
//         the TPU's, four stages deep instead of two, in place of
//         128 x 128 mma.sync tiles fed by a two-slot cp.async ring.
//   f32:  gemm_f32.cuh's GEMM (no prologue, a plain store), shared with the
//         f32 attention and MLP halves: 256 threads a block by FMA on the
//         CUDA cores (no TF32: it would round the operands to 10 bits), a
//         128 x 128 tile (8 x 8 outputs a thread) where those tiles give
//         every SM a block, else 64 x 64 (4 x 4 a thread: the (256, 1024)
//         x (1024, 512) case takes 32 blocks, not 8); 16-deep K slices of
//         x and W through two shared-memory slots, the loads of slice k + 1
//         in flight while the block computes slice k (zero-fill past K, T
//         and N).
//
// What bounds it on the H100: at (584, 1024) x (1024, 4096) bf16 (the
// ViT-L/16 @384 b1 MLP up-projection) 4.9 GFLOP at 989 TFLOP/s, 5.0 us,
// against 14.4 MB at 3.35 TB/s, 4.3 us: operations, barely.  There the
// GEMM has 5 x 16 = 80 tiles for 132 SMs, one partial wave of 16 K steps
// each: a tile is 67 MFLOP, 9 us at one SM's share of the peak, plus the
// ring's fill and the epilogue, so the tile's latency, not the card's rate,
// sets the time.  Measured on an H100 SXM at 700 W: 13.5 us of device time
// a call, 0.58 us a 64-deep K step (96% of one SM's share of the peak, on
// the 80 SMs that hold a tile) plus ~4 us of launch, fill and epilogue;
// spreading the K steps over all 132 SMs (stream-K) is what would close
// the rest.  In f32 the CUDA cores' 67 TFLOP/s bound it.
//
// TMA and cp.async copy 16-byte pieces, so rows of x and w must start
// 16-byte aligned: K and N are multiples of 8 (bf16) or 4 (f32).  The
// wrapper zero-pads them, as the TPU wrapper pads K to its tile, which
// changes no sum.

#define VFT_NS streamed_gemm
#include "common.cuh"
#include "hopper.cuh"
#include "gemm_wgmma.cuh"
#include "gemm_f32.cuh"

using namespace VFT_NS;

extern "C" {

// Finds cuTensorMapEncodeTiled and opts the bf16 GEMM in to the shared
// memory it uses, on the current device.  Called once per device
// before the first launch.  Returns a cudaError_t.
int vft_streamed_gemm_init() {
  cudaError_t err = tma_init();
  if (err != cudaSuccess) return err;
  return gw_enable();
}

// x: (T, K), w: (K, N), out: (T, N), all bf16 when bf16 else f32,
// contiguous on the current device, 16-byte aligned; K and N multiples of
// 8 (bf16) or 4 (f32).  Enqueued on `stream`.  Returns a cudaError_t.
int vft_streamed_gemm(const void* x, const void* w, void* out, int T, int K, int N, int bf16_io,
                      void* stream) {
  const int align = bf16_io ? 8 : 4;
  if (T < 1 || K < 1 || N < 1 || K % align || N % align) return cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (bf16_io) {
    if (tma_encoder() == nullptr) return cudaErrorInitializationError;
    GwArgs p{};
    p.C = static_cast<bf16*>(out);
    p.M = T;
    p.N = N;
    p.K = K;
    p.act = ACT_NONE;
    return launch_gemm_wgmma(static_cast<const bf16*>(x), static_cast<const bf16*>(w), false, p,
                             st);
  }
  FgArgs f{};
  f.A = static_cast<const float*>(x);
  f.B = static_cast<const float*>(w);
  f.C = static_cast<float*>(out);
  f.M = T;
  f.N = N;
  f.K = K;
  return launch_gemm_f32<FG_PRO_NONE, FG_EPI_STORE>(f, st);
}

}  // extern "C"
