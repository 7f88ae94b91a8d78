// The served frame's bytes, written for Hopper (sm_90a).
//
// encode_rgb8 (wrapper raster/tile_kernel.py::encode_rgb8) replaces no TPU
// kernel: the JAX server encodes its float image on the host
// (gsplat_tpu/viewer/network_gui.py::image_to_bytes), and so did the port,
// after copying a float32 [H, W, 3] image of 12 B a pixel to the host. The
// SIBR viewer receives 3 B a pixel, so the device makes those bytes and
// only they cross to the host. It takes the inference image, bf16
// [3, H, W] as rasterize returns it, and writes uint8 [H, W, 3], row-major
// (the SIBR layout), each value
//
//   x = clamp(float(v), 0, 1);  byte = trunc(fl(fl(x * 255) + 0.5))
//
// fl a float32 round to nearest: numpy's float32 `x * 255`, then `+ 0.5`,
// then the cast to uint8. The explicit-rounding intrinsics
// keep nvcc from contracting the two into one FMA (which rounds once); for
// a bf16 input the product is exact in float32 and both agree, but the
// bytes then stay numpy's whatever the compiler does or the input type
// becomes. fmaxf / fminf send NaN to 0.
//
// What bounds it on this card: bytes, 6 B read and 3 B written a pixel
// (18.8 MB at 1920 x 1088, 5.6 us at 3.35 TB/s). A thread takes four
// consecutive pixels: one 8-byte load from each channel plane (neighbouring
// threads on neighbouring words, so each plane is read coalesced) and their
// 12 output bytes as three 4-byte stores (a warp writes 384 contiguous
// bytes). Where the pixel count is not a multiple of four, or a pointer is
// not aligned for those words, every thread takes the byte-wise path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 4;  // pixels a thread

__device__ __forceinline__ unsigned to_byte(unsigned short bits) {
  float x = __bfloat162float(__ushort_as_bfloat16(bits));
  x = fminf(fmaxf(x, 0.f), 1.f);
  return __float2uint_rz(__fadd_rn(__fmul_rn(x, 255.f), 0.5f));
}

__global__ void __launch_bounds__(kThreads)
    encode_rgb8_kernel(const unsigned short* __restrict__ img, long long n,
                       bool vec, unsigned char* __restrict__ out) {
  const long long p0 =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kPix;
  if (p0 >= n) return;
  if (vec) {  // n % 4 == 0: the thread's four pixels are all there
    unsigned b[kPix][3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(img + c * n + p0));
      b[0][c] = to_byte(v.x & 0xffffu);
      b[1][c] = to_byte(v.x >> 16);
      b[2][c] = to_byte(v.y & 0xffffu);
      b[3][c] = to_byte(v.y >> 16);
    }
    // little-endian words over bytes R0 G0 B0 R1 | G1 B1 R2 G2 | B2 R3 G3 B3
    unsigned* o = reinterpret_cast<unsigned*>(out + 3 * p0);
    o[0] = b[0][0] | b[0][1] << 8 | b[0][2] << 16 | b[1][0] << 24;
    o[1] = b[1][1] | b[1][2] << 8 | b[2][0] << 16 | b[2][1] << 24;
    o[2] = b[2][2] | b[3][0] << 8 | b[3][1] << 16 | b[3][2] << 24;
    return;
  }
  for (int j = 0; j < kPix && p0 + j < n; ++j) {
    const long long p = p0 + j;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[3 * p + c] = (unsigned char)to_byte(img[c * n + p]);
  }
}

}  // namespace

// img: [3, n] bf16 bits, contiguous; out: [n, 3] uint8. Returns the launch's
// cudaError_t (0 when n == 0: nothing is launched).
extern "C" int gsplat_encode_rgb8(const void* img, long long n, void* out,
                                  cudaStream_t stream) {
  if (n == 0) return 0;
  const bool vec = n % kPix == 0 &&
                   (reinterpret_cast<unsigned long long>(img) & 7u) == 0 &&
                   (reinterpret_cast<unsigned long long>(out) & 3u) == 0;
  const long long blocks = (n + (long long)kThreads * kPix - 1) /
                           ((long long)kThreads * kPix);
  encode_rgb8_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const unsigned short*>(img), n, vec,
      static_cast<unsigned char*>(out));
  return (int)cudaGetLastError();
}
