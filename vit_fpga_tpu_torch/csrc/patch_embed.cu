// K10: the uint8 patch embedding on Hopper (sm_90a).
//
// Replaces vit_fpga_tpu/ops/patch_embed.py:_pe_kernel (wrapper
// patch_embed_pallas): raw uint8 (B, H, W, 3) images and the folded f32
// (P*P*3, D) kernel and (D,) bias of fold_preprocess give tokens
//
//   out[b, gy*gw + gx, d] = sum_(py, px, c) f32(img[b, gy*P + py, gx*P + px, c])
//                                           * k[(py, px, c), d] + bias[d]
//
// with every sum in f32 and the output rounded once to bf16 or f32.  The
// TPU kernel contracts (py) in an outer loop of small GEMMs over
// contiguous (px, c) runs; here the whole (py, px, c) axis is one K loop,
// so only the order of the f32 sums differs.
//
// What bounds it on the H100: at ViT-B/16 batch 64 it is 2 * 12 544 * 768
// * 768 = 14.8 GFLOP against 31 MB (9.6 MB of images, 2.4 MB of kernel,
// 19.3 MB of bf16 tokens).  The products are f32 (TF32 would round the
// folded weights to 10 bits), so the tensor cores are out: the bound is
// the 67 TFLOP/s of the CUDA cores, 0.22 ms, against 9 us for the bytes.
// The design is a register-tiled f32 GEMM over the B * gh * gw token rows
// whose A operand is gathered from the image inside the tile load (the
// patchify, with no staging tensor): a block computes a 128 x 64 output
// tile, each thread 8 x 4 outputs with FMAs, from 16-deep K steps held in
// shared memory, A stored k-major so a thread reads its 8 rows as two
// float4s.  Pixels are read a byte at a time: a (px, c) run is P * 3
// bytes (42 at CLIP's P = 14), so a run's start is not 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace patch_embed {

constexpr int BM = 128;  // token rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 16;   // K depth of one shared-memory step
constexpr int THREADS = 256;
constexpr int TM = 8;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int LDA = BM + 4;
constexpr int LDB = BN + 4;

struct Geometry {
  int rows;   // B * gh * gw
  int h, w;   // image height and width
  int patch;  // P
  int gw;     // patches per image row
  int gpi;    // patches per image, gh * gw
  int k;      // P * P * 3
  int n;      // D
};

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename OUT>
__global__ void __launch_bounds__(THREADS)
    pe_kernel(const uint8_t* __restrict__ img, const float* __restrict__ kern,
              const float* __restrict__ bias, OUT* __restrict__ out, Geometry g) {
  __shared__ __align__(16) float As[BK][LDA];  // k-major: As[k][row]
  __shared__ __align__(16) float Bs[BK][LDB];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int p3 = g.patch * 3;
  const size_t w3 = (size_t)g.w * 3;

  // A loads: this thread fills column ak of As for rows ar0 + 16 i, so a
  // warp reads 16 neighbouring bytes of two patch rows.  Each row's first
  // byte (pixel (gy*P, gx*P), channel 0) is computed once.
  const int ak = tid % BK;
  const int ar0 = tid / BK;
  size_t rowbase[BM / 16];
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) {
    const int m = m0 + ar0 + 16 * i;
    const int b = m / g.gpi, pidx = m % g.gpi;
    const int gy = pidx / g.gw, gx = pidx % g.gw;
    rowbase[i] = m < g.rows ? (((size_t)b * g.h + (size_t)gy * g.patch) * g.w
                               + (size_t)gx * g.patch) * 3
                            : SIZE_MAX;
  }
  // B loads: row bk, columns bc .. bc + 3
  const int bk = tid / (BN / 4);
  const int bc = (tid % (BN / 4)) * 4;

  const int tx = tid % (BN / TN);  // columns tx*4 .. tx*4 + 3
  const int ty = tid / (BN / TN);  // rows ty*8 .. ty*8 + 7
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < g.k; k0 += BK) {
    {
      const int k = k0 + ak;
      const bool kin = k < g.k;
      const int py = kin ? k / p3 : 0;
      const size_t koff = (size_t)py * w3 + (kin ? k % p3 : 0);
#pragma unroll
      for (int i = 0; i < BM / 16; ++i)
        As[ak][ar0 + 16 * i] =
            (kin && rowbase[i] != SIZE_MAX) ? (float)__ldg(img + rowbase[i] + koff) : 0.0f;
      const int kb = k0 + bk;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + bc + j;
        Bs[bk][bc + j] = (kb < g.k && n < g.n) ? __ldg(kern + (size_t)kb * g.n + n) : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= g.rows) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < g.n) store_out(out + (size_t)m * g.n + n, __fadd_rn(acc[i][j], __ldg(bias + n)));
    }
  }
}

}  // namespace patch_embed

extern "C" {

// img: (B, H, W, 3) uint8; kern: (P*P*3, D) f32; bias: (D,) f32; out:
// (B, (H/P)*(W/P), D), bf16 when out_bf16 else f32; all contiguous on the
// current device.  H and W are multiples of P.  Enqueued on `stream`.
// Returns a cudaError_t.
int vft_patch_embed(const void* img, const void* kern, const void* bias, void* out, int batch,
                    int h, int w, int patch, int d, int out_bf16, void* stream) {
  using namespace patch_embed;
  if (batch < 1 || patch < 1 || h < patch || w < patch || h % patch || w % patch || d < 1)
    return cudaErrorInvalidValue;
  Geometry g;
  g.h = h;
  g.w = w;
  g.patch = patch;
  g.gw = w / patch;
  g.gpi = (h / patch) * g.gw;
  g.rows = batch * g.gpi;
  g.k = patch * patch * 3;
  g.n = d;
  const dim3 grid((d + BN - 1) / BN, (g.rows + BM - 1) / BM);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const uint8_t* im = static_cast<const uint8_t*>(img);
  const float* k = static_cast<const float*>(kern);
  const float* b = static_cast<const float*>(bias);
  if (out_bf16)
    pe_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(im, k, b, static_cast<__nv_bfloat16*>(out), g);
  else
    pe_kernel<float><<<grid, THREADS, 0, st>>>(im, k, b, static_cast<float*>(out), g);
  return cudaGetLastError();
}

}  // extern "C"
