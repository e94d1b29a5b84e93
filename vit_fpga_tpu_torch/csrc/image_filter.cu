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
// 2^12 in magnitude: each is exact in f32, so the sum is the same in any
// order and an fma gives the same bits as a multiply and an add.  It rounds
// half to even (rintf, numpy's rint), not half away from zero (roundf): the
// blur puts many pixels on a half.  So the kernel equals filter_image_numpy
// bit for bit.
//
// What bounds it on the H100: a 1080 x 1920 frame is 2.07 MB in and 2.07 MB
// out, 1.24 us at 3.35 TB/s; its 9 f32 multiply-adds a pixel take 0.56 us
// at 67 TFLOP/s.  So it is bound by bytes.  The first design staged a 32 x
// 128 tile through shared memory one byte a load (LDG.E.U8 in a loop, each
// with a multiply-high for the divide and the modulo by the halo width),
// and wrote one byte a store: 0.0080 ms device alone at 1080p (0.52 TB/s),
// with a few KB an SM in flight where the card wants ~2 MB in all (3.35
// TB/s times ~0.7 us of latency), about the whole frame at once.
//
// The design: a thread owns one chunk of VEC neighbouring columns (16, one
// uint4, where W is a multiple of 16 and both frames are 16-byte aligned;
// 1 otherwise, the same code) over a strip of ROWS output rows, and issues
// all ROWS + 2 row loads (ld.global.nc) before it uses the first, so the
// whole frame is in flight in one wave.  A warp covers 32 chunks side by
// side: each lane takes the byte left of its chunk from its left
// neighbour's last byte and the byte right of it from its right
// neighbour's first (__shfl_up_sync / __shfl_down_sync); only lane 0 and
// lane 31 read one byte from memory, zero outside the frame, as are the
// rows above and below the frame.  A rolling three-row window unpacks each
// byte to f32 once (0x4B0000bb - 2^23), each pixel takes the filter's
// nonzero taps alone (the tap mask is a template argument), and each
// output row goes back in one streaming store (st.global.cs: the frame
// goes back to the host, not to another kernel).  The taps are an
// argument, not a table compiled in.
//
// Measured (H100 SXM, 700 W; experiments/torch_k25_ab.py, device alone,
// sharpen): 0.0029 ms at 1080 x 1920 (1.4 TB/s) and 0.0071 ms at 2160 x
// 3840, with ROWS = 2; ROWS = 4 took 0.0030 / 0.0065 and 8 0.0035 / 0.0068,
// a TMA variant (experiments/k25_tma.cu) 0.0029-0.0033 / 0.0070.  The
// kernel starts, loads, computes and stores in one wave, so a fixed ~1.5
// us stays beside the streaming, which runs at ~3 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace image_filter {

constexpr int ROWS = 2;       // output rows a thread: one strip
constexpr int WARPS = 4;      // warps a block, a strip each
constexpr unsigned FULL = 0xffffffffu;

// The taps a kernel applies, as a mask of bit dy * 3 + dx: every tap, the
// plus of sharpen and edge, identity's centre.
constexpr int TAPS_ALL = 0x1ff;
constexpr int TAPS_PLUS = 0x0ba;
constexpr int TAPS_CENTRE = 0x010;

struct Taps {
  float t[9];  // row-major [dy][dx]
};

// VEC neighbouring bytes of a row as 32-bit words (byte j in word j / 4).
template <int VEC>
struct Chunk {
  static constexpr int WORDS = (VEC + 3) / 4;
  uint32_t w[WORDS];
};

template <int VEC>
__device__ __forceinline__ Chunk<VEC> load_chunk(const uint8_t* p, bool ok) {
  Chunk<VEC> c;
  if constexpr (VEC == 16) {
    const uint4 v = ok ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
    c.w[0] = v.x;
    c.w[1] = v.y;
    c.w[2] = v.z;
    c.w[3] = v.w;
  } else {
    static_assert(VEC == 1, "a chunk is 16 bytes or 1");
    c.w[0] = ok ? __ldg(p) : 0u;
  }
  return c;
}

template <int VEC>
__device__ __forceinline__ void store_chunk(uint8_t* p, const uint32_t (&w)[Chunk<VEC>::WORDS]) {
  if constexpr (VEC == 16)
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
  else
    __stcs(p, static_cast<unsigned char>(w[0]));
}

// Byte j of word as an exact f32: the bits 0x4B0000bb are 2^23 + bb.
__device__ __forceinline__ float byte_f32(uint32_t word, int j) {
  return __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440u | j)) - 8388608.0f;
}

// The output pixel of sum acc in the low byte of the result: acc clipped
// to [0, 255] (the same as rint then clip, since 0 and 255 are integers)
// plus 1.5 * 2^23, where the f32 ulp is 1, so the add rounds half to even
// (rintf) and the bits are 0x4B400000 + the pixel.  No F2I: a conversion
// issues at an eighth of an add's rate on this card.
__device__ __forceinline__ uint32_t pixel_bits(float acc) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(acc, 0.0f), 255.0f), 12582912.0f));
}

// Word k of a packed chunk: the low bytes of px[4k .. 4k + 3].
template <int VEC>
__device__ __forceinline__ uint32_t pack4(const uint32_t (&px)[VEC], int k) {
  if constexpr (VEC == 1) {
    return px[0] & 0xffu;
  } else {
    const uint32_t lo = __byte_perm(px[4 * k], px[4 * k + 1], 0x0040u);
    const uint32_t hi = __byte_perm(px[4 * k + 2], px[4 * k + 3], 0x0040u);
    return __byte_perm(lo, hi, 0x5410u);
  }
}

// One row of the window: the byte left of the chunk, its VEC bytes, the
// byte right of it.
template <int VEC>
__device__ __forceinline__ void unpack_row(float (&f)[VEC + 2], const Chunk<VEC>& c,
                                           uint32_t left, uint32_t right) {
  f[0] = byte_f32(left, 0);
#pragma unroll
  for (int j = 0; j < VEC; ++j) f[j + 1] = byte_f32(c.w[j >> 2], j & 3);
  f[VEC + 1] = byte_f32(right, 0);
}

// grid (ceil(W / VEC / 32), ceil(ceil(H / ROWS) / WARPS)), block (32, WARPS):
// lane = chunk within the warp's 32, threadIdx.y = strip within the block.
template <int VEC, int MASK>
__global__ void __launch_bounds__(32 * WARPS)
    filter_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, Taps taps, int h,
                  int w) {
  constexpr int WORDS = Chunk<VEC>::WORDS;
  const int lane = threadIdx.x;
  const int y0 = (blockIdx.y * WARPS + threadIdx.y) * ROWS;
  if (y0 >= h) return;  // the whole warp: its strip lies below the frame
  const int x = (blockIdx.x * 32 + lane) * VEC;
  const bool live = x < w;  // lanes past the right edge hold zeros
  // Every load of the strip first: rows y0 - 1 .. y0 + ROWS, and the
  // bytes beside the warp's 32 chunks.
  Chunk<VEC> c[ROWS + 2];
  uint32_t left[ROWS + 2], right[ROWS + 2];
#pragma unroll
  for (int r = 0; r < ROWS + 2; ++r) {
    const int y = y0 - 1 + r;
    const bool row_in = y >= 0 && y < h;
    const uint8_t* row = in + static_cast<ptrdiff_t>(y) * w;
    c[r] = load_chunk<VEC>(row + x, row_in && live);
    left[r] = lane == 0 && row_in && x > 0 ? __ldg(row + x - 1) : 0u;
    right[r] = lane == 31 && row_in && x + VEC < w ? __ldg(row + x + VEC) : 0u;
  }
#pragma unroll
  for (int r = 0; r < ROWS + 2; ++r) {
    const uint32_t l = __shfl_up_sync(FULL, c[r].w[WORDS - 1] >> (8 * ((VEC - 1) & 3)), 1);
    const uint32_t rt = __shfl_down_sync(FULL, c[r].w[0] & 0xffu, 1);
    if (lane > 0) left[r] = l;
    if (lane < 31) right[r] = rt;
  }
  float win[3][VEC + 2];
  unpack_row<VEC>(win[0], c[0], left[0], right[0]);
  unpack_row<VEC>(win[1], c[1], left[1], right[1]);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    unpack_row<VEC>(win[(r + 2) % 3], c[r + 2], left[r + 2], right[r + 2]);
    uint32_t px[VEC], q[WORDS];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          if ((MASK >> (dy * 3 + dx)) & 1)
            acc = fmaf(taps.t[dy * 3 + dx], win[(r + dy) % 3][j + dx], acc);
      px[j] = pixel_bits(acc);
    }
#pragma unroll
    for (int k = 0; k < WORDS; ++k) q[k] = pack4<VEC>(px, k);
    const int y = y0 + r;
    if (live && y < h) store_chunk<VEC>(out + static_cast<ptrdiff_t>(y) * w + x, q);
  }
}

template <int VEC>
cudaError_t launch(const uint8_t* in, uint8_t* out, const Taps& t, int mask, int h, int w,
                   cudaStream_t stream) {
  const int strips = (h + ROWS - 1) / ROWS;
  const dim3 grid((w / VEC + 31) / 32, (strips + WARPS - 1) / WARPS);
  const dim3 block(32, WARPS);
  if (mask == TAPS_CENTRE)
    filter_kernel<VEC, TAPS_CENTRE><<<grid, block, 0, stream>>>(in, out, t, h, w);
  else if (mask == TAPS_PLUS)
    filter_kernel<VEC, TAPS_PLUS><<<grid, block, 0, stream>>>(in, out, t, h, w);
  else
    filter_kernel<VEC, TAPS_ALL><<<grid, block, 0, stream>>>(in, out, t, h, w);
  return cudaGetLastError();
}

}  // namespace image_filter

extern "C" {

// The bytes a thread's chunk takes for these frames: 16 where w is a
// multiple of 16 and both frames are 16-byte aligned (every row then is),
// else 1.
int vft_image_filter_chunk(const void* in, const void* out, int w) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out);
  return w % 16 == 0 && base % 16 == 0 ? 16 : 1;
}

// in, out: (h, w) uint8 on the current device; taps: 9 host floats,
// row-major [dy][dx].  Enqueued on `stream`.  Returns a cudaError_t.
int vft_image_filter(const void* in, void* out, const float* taps, int h, int w, void* stream) {
  using namespace image_filter;
  if (h < 1 || w < 1 || taps == nullptr) return cudaErrorInvalidValue;
  Taps t;
  int nonzero = 0;
  for (int i = 0; i < 9; ++i) {
    t.t[i] = taps[i];
    if (taps[i] != 0.0f) nonzero |= 1 << i;
  }
  // the smallest tap mask that holds the nonzero taps
  const int mask = (nonzero & ~TAPS_CENTRE) == 0 ? TAPS_CENTRE
                   : (nonzero & ~TAPS_PLUS) == 0 ? TAPS_PLUS
                                                 : TAPS_ALL;
  const auto* src = static_cast<const uint8_t*>(in);
  auto* dst = static_cast<uint8_t*>(out);
  auto s = reinterpret_cast<cudaStream_t>(stream);
  return vft_image_filter_chunk(in, out, w) == 16 ? launch<16>(src, dst, t, mask, h, w, s)
                                                  : launch<1>(src, dst, t, mask, h, w, s);
}

}  // extern "C"
