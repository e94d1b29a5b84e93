// K25: the streaming 3x3 image filter on Hopper (sm_90a).
//
// Replaces vit_fpga_tpu/ops/image_filter.py:_filter_kernel (wrapper
// filter_image_pallas): out = uint8(clip(rint(sum_{dy,dx} t[dy][dx] *
// in[y + dy - 1][x + dx - 1]), 0, 255)) over an (H, W) uint8 frame, zero
// outside the frame, the sum in f32.
//
// Exactness: the pixels are integers in [0, 255] and every tap of the four
// filters (sharpen, blur, edge, identity) is an integer or a multiple of
// 1/16, so every product and every partial sum is a multiple of 1/16 below
// 2^12 in magnitude: each is exact in f32, the sum is the same in any order,
// and the kernel equals filter_image_numpy bit for bit.  The sum still runs
// in the oracle's order (dy-major, zero taps skipped), each step rounded on
// its own (__fmul_rn, __fadd_rn: no fma), and it rounds half to even
// (rintf, numpy's rint), not half away from zero (roundf): the blur puts
// many pixels on a half.
//
// What bounds it on the H100: a 1080 x 1920 frame is 2.07 MB in and 2.07 MB
// out, 1.24 us at 3.35 TB/s; 9 multiply-adds a pixel are nothing beside
// that.  So it is bound by bytes, and at this size in practice by its
// launch.  The design is the simple right one: a block stages a 32 x 128
// tile of the frame with its one-pixel halo in shared memory as f32 (each
// input byte is read from device memory about once, neighbouring threads
// on neighbouring bytes), then each of its 256 threads computes 16 pixels
// from shared memory and writes them, a warp on 32 neighbouring bytes.
// The taps are an argument, not a table compiled in.

#include <cuda_runtime.h>
#include <stdint.h>

namespace image_filter {

constexpr int TILE_W = 128;
constexpr int TILE_H = 32;
constexpr int THREADS_X = 32;
constexpr int THREADS_Y = 8;
constexpr int HALO_W = TILE_W + 2;
constexpr int HALO_H = TILE_H + 2;

struct Taps {
  float t[9];  // row-major [dy][dx]
};

__global__ void __launch_bounds__(THREADS_X * THREADS_Y)
    filter_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, Taps taps, int h,
                  int w) {
  __shared__ float tile[HALO_H][HALO_W];
  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TILE_H;
  const int tid = threadIdx.y * THREADS_X + threadIdx.x;
  // Stage the tile and its halo: frame pixel (y0 - 1 + r, x0 - 1 + c) at
  // tile[r][c], zero outside the frame.
  for (int i = tid; i < HALO_H * HALO_W; i += THREADS_X * THREADS_Y) {
    const int r = i / HALO_W, c = i % HALO_W;
    const int y = y0 - 1 + r, x = x0 - 1 + c;
    tile[r][c] = (y >= 0 && y < h && x >= 0 && x < w) ? (float)in[(size_t)y * w + x] : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TILE_H / THREADS_Y; ++i) {
    const int r = threadIdx.y + i * THREADS_Y;
    const int y = y0 + r;
    if (y >= h) break;
#pragma unroll
    for (int j = 0; j < TILE_W / THREADS_X; ++j) {
      const int c = threadIdx.x + j * THREADS_X;
      const int x = x0 + c;
      if (x >= w) break;
      float acc = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float t = taps.t[dy * 3 + dx];
          if (t != 0.0f) acc = __fadd_rn(acc, __fmul_rn(t, tile[r + dy][c + dx]));
        }
      const int q = min(max(static_cast<int>(rintf(acc)), 0), 255);
      out[(size_t)y * w + x] = static_cast<uint8_t>(q);
    }
  }
}

}  // namespace image_filter

extern "C" {

// in, out: (h, w) uint8 on the current device; taps: 9 host floats,
// row-major [dy][dx].  Enqueued on `stream`.  Returns a cudaError_t.
int vft_image_filter(const void* in, void* out, const float* taps, int h, int w, void* stream) {
  using namespace image_filter;
  if (h < 1 || w < 1 || taps == nullptr) return cudaErrorInvalidValue;
  Taps t;
  for (int i = 0; i < 9; ++i) t.t[i] = taps[i];
  const dim3 grid((w + TILE_W - 1) / TILE_W, (h + TILE_H - 1) / TILE_H);
  const dim3 block(THREADS_X, THREADS_Y);
  filter_kernel<<<grid, block, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), t, h, w);
  return cudaGetLastError();
}

}  // extern "C"
