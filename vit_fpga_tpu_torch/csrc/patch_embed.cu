// K10: the uint8 patch embedding on Hopper (sm_90a).
//
// Replaces vit_fpga_tpu/ops/patch_embed.py:_pe_kernel (wrapper
// patch_embed_pallas): raw uint8 (B, H, W, 3) images and the folded f32
// (P*P*3, D) kernel and (D,) bias of fold_preprocess give tokens
//
//   out[b, gy*gw + gx, d] = sum_(py, px, c) f32(img[b, gy*P + py, gx*P + px, c])
//                                           * k[(py, px, c), d] + bias[d]
//
// with every sum in f32 and the output rounded once to bf16 or f32.
//
// What bounds it on the H100: at ViT-B/16 batch 64 it is 2 * 12 544 * 768
// * 768 = 14.8 GFLOP against 31 MB.  The products must keep the f32
// weights whole (TF32 would round them to 10 bits), which on the CUDA
// cores bounds it at 0.22 ms (67 TFLOP/s).  The tensor cores form the
// same products exactly in bf16: a pixel (0..255) is exact in bf16, a
// normal f32 weight w is the exact sum of three bf16 pieces
//
//   hi = bf16(w), mid = bf16(w - hi), lo = bf16(w - hi - mid)
//
// (each subtraction exact in f32; 3 x 8 significant bits hold w's 24), and
// a pixel times a piece has at most 16 significant bits, exact in f32.  So
// one bf16 GEMM over K' = 3 K, the image's patch rows against the three
// planes, sums exactly the products pixel * w, in f32: 3 x 14.8 GFLOP at
// 989 TFLOP/s, 0.045 ms.  Only the order of the f32 sums differs from the
// TPU kernel's (it contracts (py) in an outer loop of small GEMMs).  Three
// launches on one stream, counted as one ported kernel:
//
//   (a) split     the (K, D) f32 kernel into B' (3 Kq, D) bf16, the planes
//                 [lo; mid; hi] of Kq = Kp rounded up to 64 rows each (rows
//                 past K zero), in the (K, N) layout gemm_wgmma.cuh reads;
//                 a weight whose pieces do not sum to it, or with a piece
//                 that is a bf16 subnormal (below 2^-126: the weights under
//                 about 2^-110 with low bits set, the f32 subnormals), a
//                 NaN or an infinity, is counted, and the wrapper raises.
//   (b) patchify  the images into A (B gh gw, Kp) bf16, K = P*P*3 padded
//                 with zero columns to Kp, a multiple of 8 (TMA's 16-byte
//                 row stride: CLIP's P 14 gives 588 -> 592): each byte read
//                 once, 16 bytes (8 columns) written a thread.
//   (c) GEMM      gemm_wgmma.cuh's persistent wgmma + TMA GEMM over K' = 3
//                 Kq: A' = [A | A | A] is A read three times over (its K
//                 step kt at column (64 kt) % Kq, the columns past Kp land
//                 zero), B' the planes, the small pieces first; the epilogue
//                 f = acc + bias rounded once to bf16, or stored in f32
//                 (GW_EPI_F32 with the bias).

#define VFT_NS patch_embed
#include "common.cuh"
#include "hopper.cuh"
#include "gemm_wgmma.cuh"

namespace VFT_NS {

constexpr int PE_THREADS = 256;

__device__ __forceinline__ bool subnormal(float v) {
  return v != 0.0f && fabsf(v) < 1.17549435e-38f;  // FLT_MIN
}

inline bool pe_misaligned(const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) != 0; }

// (a) Thread i: four columns of row r = i / (D / 4) of every plane.  D % 4
// == 0 and w 16-byte aligned.  *inexact counts the weights whose pieces do
// not sum to them exactly or hold a subnormal piece.
__global__ void __launch_bounds__(PE_THREADS)
    split_kernel(const float* __restrict__ w, bf16* __restrict__ planes,
                 int* __restrict__ inexact, int k, int kq, int d) {
  const int d4 = d / 4;
  const size_t n = (size_t)kq * d4;
  const size_t plane = (size_t)kq * d;
  int bad = 0;
  for (size_t i = (size_t)blockIdx.x * PE_THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * PE_THREADS) {
    const int r = (int)(i / d4), c = (int)(i % d4) * 4;
    const float4 v = r < k ? __ldg(reinterpret_cast<const float4*>(w + (size_t)r * d + c))
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float x[4] = {v.x, v.y, v.z, v.w};
    float pc[3][4];  // lo, mid, hi
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float hi = bf16_round(x[e]);
      const float r1 = __fsub_rn(x[e], hi);  // exact
      const float mid = bf16_round(r1);
      const float r2 = __fsub_rn(r1, mid);   // exact
      const float lo = bf16_round(r2);
      // w == hi + mid + lo exactly iff lo == r2
      bad += !(lo == r2) || subnormal(hi) || subnormal(mid) || subnormal(lo);
      pc[0][e] = lo, pc[1][e] = mid, pc[2][e] = hi;
    }
#pragma unroll
    for (int s = 0; s < 3; ++s)
      *reinterpret_cast<uint2*>(planes + s * plane + (size_t)r * d + c) =
          make_uint2(pack_bf16x2(pc[s][0], pc[s][1]), pack_bf16x2(pc[s][2], pc[s][3]));
  }
  if (bad) atomicAdd(inexact, bad);
}

struct Geometry {
  int rows;   // B * gh * gw
  int h, w;   // image height and width
  int patch;  // P
  int gw;     // patches per image row
  int gpi;    // patches per image, gh * gw
  int k;      // P * P * 3
  int kp;     // k rounded up to 8: A's columns
};

// (b) Thread i: columns 8 j .. 8 j + 7 of token row m, i = m (Kp / 8) + j,
// one 16-byte store.  Column q = (py, px, c) is byte (py W + px) 3 + c of
// the patch's first pixel row.  RUN8: P * 3 % 8 == 0 (P 8, 16, 32) and the
// image 8-byte aligned, so the eight bytes lie in one (px, c) run, 8-byte
// aligned: one load.
template <bool RUN8>
__global__ void __launch_bounds__(PE_THREADS)
    patchify_kernel(const uint8_t* __restrict__ img, bf16* __restrict__ a, Geometry g) {
  const int per_row = g.kp / 8;
  const size_t n = (size_t)g.rows * per_row;
  const int p3 = g.patch * 3;
  const size_t w3 = (size_t)g.w * 3;
  for (size_t i = (size_t)blockIdx.x * PE_THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * PE_THREADS) {
    const int m = (int)(i / per_row), q0 = (int)(i % per_row) * 8;
    const int b = m / g.gpi, pidx = m % g.gpi;
    const int gy = pidx / g.gw, gx = pidx % g.gw;
    const uint8_t* base =
        img + (((size_t)b * g.h + (size_t)gy * g.patch) * g.w + (size_t)gx * g.patch) * 3;
    float f[8];
    if (RUN8) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(base + (size_t)(q0 / p3) * w3 +
                                                           q0 % p3));
      const uint32_t wd[2] = {u.x, u.y};
#pragma unroll
      for (int t = 0; t < 8; ++t) f[t] = (float)((wd[t >> 2] >> (8 * (t & 3))) & 0xffu);
    } else {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int q = q0 + t;
        f[t] = q < g.k ? (float)__ldg(base + (size_t)(q / p3) * w3 + q % p3) : 0.0f;
      }
    }
    *reinterpret_cast<uint4*>(a + (size_t)m * g.kp + q0) = pack8(f);  // exact: 0..255
  }
}

inline int pe_grid(size_t n, int sms) {
  const size_t blocks = (n + PE_THREADS - 1) / PE_THREADS;
  const size_t most = (size_t)sms * 16;
  return (int)(blocks < most ? blocks : most);
}

}  // namespace VFT_NS

using namespace VFT_NS;

extern "C" {

// Resolves the tensor-map encoder and opts the GEMM's bf16 and f32
// variants in to their shared memory, on the current device.  Called once
// per device before the first launch.  Returns a cudaError_t.
int vft_patch_embed_init() {
  cudaError_t err = tma_init();
  if (err != cudaSuccess) return err;
  if ((err = gw_enable_bwd<GW_AK_BN, GW_EPI_BF16>()) != cudaSuccess) return err;
  return gw_enable_bwd<GW_AK_BN, GW_EPI_F32>();
}

// img: (B, H, W, 3) uint8; kern: (P*P*3, D) f32; bias: (D,) f32; out:
// (B, (H/P)*(W/P), D), bf16 when out_bf16 else f32; all contiguous on the
// current device, kern, bias and out 16-byte aligned.  H and W are
// multiples of P, D of 8.  Scratch: planes (3 Kq, D) bf16 and a (B gh gw,
// Kp) bf16, 16-byte aligned, Kp = P*P*3 rounded up to 8 and Kq = Kp
// rounded up to 64; inexact: one int, set to the count of weights the
// three pieces do not hold exactly.  Enqueued on `stream`.  Returns a
// cudaError_t.
int vft_patch_embed(const void* img, const void* kern, const void* bias, void* out, void* planes,
                    void* a, void* inexact, int batch, int h, int w, int patch, int d,
                    int out_bf16, void* stream) {
  if (batch < 1 || patch < 1 || h < patch || w < patch || h % patch || w % patch || d < 8 ||
      d % 8)
    return cudaErrorInvalidValue;
  if (pe_misaligned(kern) || pe_misaligned(planes) || pe_misaligned(a))
    return cudaErrorMisalignedAddress;
  Geometry g;
  g.h = h;
  g.w = w;
  g.patch = patch;
  g.gw = w / patch;
  g.gpi = (h / patch) * g.gw;
  g.rows = batch * g.gpi;
  g.k = patch * patch * 3;
  g.kp = (g.k + 7) / 8 * 8;
  const int kq = (g.kp + GW_BK - 1) / GW_BK * GW_BK;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;

  int* bad = static_cast<int*>(inexact);
  bf16* pl = static_cast<bf16*>(planes);
  bf16* am = static_cast<bf16*>(a);
  if ((err = cudaMemsetAsync(bad, 0, sizeof(int), st)) != cudaSuccess) return err;
  split_kernel<<<pe_grid((size_t)kq * (d / 4), sms), PE_THREADS, 0, st>>>(
      static_cast<const float*>(kern), pl, bad, g.k, kq, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const uint8_t* im = static_cast<const uint8_t*>(img);
  const size_t vecs = (size_t)g.rows * (g.kp / 8);
  if ((patch * 3) % 8 == 0 && !(reinterpret_cast<uintptr_t>(im) & 7))
    patchify_kernel<true><<<pe_grid(vecs, sms), PE_THREADS, 0, st>>>(im, am, g);
  else
    patchify_kernel<false><<<pe_grid(vecs, sms), PE_THREADS, 0, st>>>(im, am, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  GwArgs p{};
  p.M = g.rows;
  p.N = d;
  p.K = 3 * kq;
  p.act = ACT_NONE;
  p.bias = static_cast<const float*>(bias);
  p.a_cols = g.kp;
  p.a_period = kq;
  if (out_bf16) {
    p.C = static_cast<bf16*>(out);
    return launch_gemm_wgmma(am, pl, false, p, st);
  }
  p.C32 = static_cast<float*>(out);
  p.splits = 1;
  return launch_gemm_wgmma<GW_AK_BN, GW_EPI_F32>(am, pl, false, p, st);
}

}  // extern "C"
