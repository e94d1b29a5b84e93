// K25's TMA variant, timed beside csrc/image_filter.cu by
// experiments/torch_k25_ab.py (--extra tma=experiments/k25_tma.cu); not
// built into the port.
//
// The same function (3x3 taps over an (H, W) uint8 frame, zero outside it,
// exact f32 sums, round half to even, clip to [0, 255]) for frames whose W
// is a multiple of 16 and whose pointers are 16-byte aligned; any other
// frame returns cudaErrorInvalidValue.  A block owns 224 output columns by
// BROWS rows: one thread issues one cp.async.bulk.tensor 2-D box of
// (BROWS + 2) rows x 256 bytes at (x0 - 16, y0 - 1), whose out-of-bounds
// zero fill is the frame's zero border (a box's first column must sit on
// 16 bytes: a box at x0 - 8, for 240 columns a block, never completes its
// barrier on the H100); 14 x GROUPS threads each take 16 columns by TROWS
// rows from shared memory (one 16-byte read and the two bytes beside it a
// row), write their packed output rows to a second shared tile, and one
// thread stores it by a TMA box store, which leaves out what lies past
// the frame.

#define VFT_NS k25_tma
#include "common.cuh"
#include "hopper.cuh"

using namespace VFT_NS;

namespace {

constexpr int COLS = 224;            // output columns a block
constexpr int TROWS = 4;             // output rows a thread
constexpr int GROUPS = 8;            // row groups a block
constexpr int BROWS = TROWS * GROUPS;
constexpr int CHUNKS = COLS / 16;    // threads along a row
constexpr int IN_W = 256;            // box width: 16 + 224 + 16
constexpr int IN_BYTES = (BROWS + 2) * IN_W;
constexpr int OUT_BYTES = BROWS * COLS;

struct Taps {
  float t[9];
};

__device__ __forceinline__ float byte_f32(uint32_t word, int j) {
  return __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440u | j)) - 8388608.0f;
}

__device__ __forceinline__ uint32_t pixel_bits(float acc) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(acc, 0.0f), 255.0f), 12582912.0f));
}

template <int MASK>
__global__ void __launch_bounds__(CHUNKS * GROUPS)
    filter_kernel(const __grid_constant__ CUtensorMap tin, const __grid_constant__ CUtensorMap tout,
                  Taps taps) {
  __shared__ __align__(128) uint8_t sin[IN_BYTES];
  __shared__ __align__(128) uint8_t sout[OUT_BYTES];
  __shared__ __align__(8) uint64_t bar;
  const int tid = threadIdx.y * CHUNKS + threadIdx.x;
  const int x0 = blockIdx.x * COLS, y0 = blockIdx.y * BROWS;
  const uint32_t b = smem_u32(&bar);
  if (tid == 0) {
    mbar_init(b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(b, IN_BYTES);
    tma_load_2d(smem_u32(sin), &tin, b, x0 - 16, y0 - 1);
  }
  mbar_wait(b, 0);
  const int c = threadIdx.x, g = threadIdx.y;
  float win[3][18];
  auto unpack = [&](float (&f)[18], int r) {
    const uint8_t* row = sin + (g * TROWS + r) * IN_W + 16 * c;
    const uint4 a = *reinterpret_cast<const uint4*>(row + 16);
    f[0] = byte_f32(row[15], 0);
    const uint32_t w4[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int j = 0; j < 16; ++j) f[j + 1] = byte_f32(w4[j >> 2], j & 3);
    f[17] = byte_f32(row[32], 0);
  };
  unpack(win[0], 0);
  unpack(win[1], 1);
#pragma unroll
  for (int r = 0; r < TROWS; ++r) {
    unpack(win[(r + 2) % 3], r + 2);
    uint32_t px[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          if ((MASK >> (dy * 3 + dx)) & 1)
            acc = fmaf(taps.t[dy * 3 + dx], win[(r + dy) % 3][j + dx], acc);
      px[j] = pixel_bits(acc);
    }
    uint32_t q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      q[k] = __byte_perm(__byte_perm(px[4 * k], px[4 * k + 1], 0x0040u),
                         __byte_perm(px[4 * k + 2], px[4 * k + 3], 0x0040u), 0x5410u);
    *reinterpret_cast<uint4*>(sout + (g * TROWS + r) * COLS + 16 * c) =
        make_uint4(q[0], q[1], q[2], q[3]);
  }
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    tma_store_2d(&tout, smem_u32(sout), x0, y0);
    bulk_commit();
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

}  // namespace

extern "C" {

int vft_image_filter(const void* in, void* out, const float* taps, int h, int w, void* stream) {
  if (h < 1 || w < 1 || taps == nullptr || w % 16 != 0 ||
      ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) % 16) != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = tma_init();
  if (err != cudaSuccess) return err;
  Taps t;
  int nonzero = 0;
  for (int i = 0; i < 9; ++i) {
    t.t[i] = taps[i];
    if (taps[i] != 0.0f) nonzero |= 1 << i;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)w, (cuuint64_t)h};
  const cuuint64_t strides[1] = {(cuuint64_t)w};
  const cuuint32_t box_in[2] = {IN_W, BROWS + 2};
  const cuuint32_t box_out[2] = {COLS, BROWS};
  CUtensorMap tin, tout;
  if (!tma_encode_s8(&tin, in, 2, dims, strides, box_in, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tma_encode_s8(&tout, out, 2, dims, strides, box_out, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const dim3 grid((w + COLS - 1) / COLS, (h + BROWS - 1) / BROWS);
  const dim3 block(CHUNKS, GROUPS);
  auto s = reinterpret_cast<cudaStream_t>(stream);
  if ((nonzero & ~0x0ba) == 0)
    filter_kernel<0x0ba><<<grid, block, 0, s>>>(tin, tout, t);
  else
    filter_kernel<0x1ff><<<grid, block, 0, s>>>(tin, tout, t);
  return cudaGetLastError();
}

}  // extern "C"
