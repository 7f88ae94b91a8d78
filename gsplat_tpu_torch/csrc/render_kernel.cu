// Inference tile render, written for Hopper (sm_90a).
//
// Replaces gsplat_tpu/raster/tile_kernel.py::_render_kernel (wrapper
// render_forward). Semantics kept from the TPU kernel: per tile, walk the
// tile's 128-slot chunks front to back; alpha = min(0.99, opa * e^power),
// 0 where power > 0 or alpha < 1/255; no per-pixel stop rule; after each
// chunk the whole tile stops once every pixel has T <= 1e-4; the
// background is composited in; tiles without chunks are pure background.
// Output bf16 [num_tiles, 3, n_pix], the JAX layout.
//
// Design. One block per tile; each thread owns up to kMaxPixPerThread
// pixels (strided by blockDim.x, so stores are coalesced), which covers
// the server's 128x32 tiles (4096 pixels) with 1024 threads. Each chunk's
// nine bf16 feature rows are staged once in shared memory as float32, with
// the mean already shifted to tile-local coordinates (x - ox, as the TPU
// kernel computes it). Compositing is sequential per pixel in float32,
// T *= (1 - alpha): the TPU kernel's bf16 log1p scan and bf16 color matmul
// were MXU devices and are not carried over. The tile-wide stop is
// __syncthreads_or(T > 1e-4) after each chunk, the TPU kernel's rule.
// A tile's chunk range is found in-kernel with a lower-bound search over
// the tile ids in chunk_meta (sorted; sentinel chunks carry num_tiles and
// sort last, so they are never visited).
//
// Bound: for the serving frame, operations. Each (pixel, slot) pair of a
// visited chunk costs one expf and ~20 float operations; the bytes are the
// feature stream (18 B/slot) and the image (6 B/pixel).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr int kNumFeat = 9;
constexpr int kMaxChunk = 256;
constexpr int kMaxPixPerThread = 4;

__global__ void __launch_bounds__(1024)
render_kernel(const __nv_bfloat16* __restrict__ feat, long long k_slots,
              const int* __restrict__ chunk_meta, int n_chunks,
              const float* __restrict__ bg, __nv_bfloat16* __restrict__ out,
              int n_pix, int tile_x, int tile_y, int grid_x, int chunk) {
  __shared__ float s_feat[kNumFeat][kMaxChunk];
  const int tile = blockIdx.x;
  const float ox = (float)((tile % grid_x) * tile_x);
  const float oy = (float)((tile / grid_x) * tile_y);

  // first chunk whose tile id >= tile (tile ids ascend along chunk_meta)
  int lo = 0, hi = n_chunks;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if ((chunk_meta[mid] >> 2) < tile) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }

  float px[kMaxPixPerThread], py[kMaxPixPerThread];
  float T[kMaxPixPerThread], cr[kMaxPixPerThread], cg[kMaxPixPerThread],
      cb[kMaxPixPerThread];
#pragma unroll
  for (int j = 0; j < kMaxPixPerThread; ++j) {
    const int p = threadIdx.x + j * blockDim.x;
    px[j] = (float)(p % tile_x);
    py[j] = (float)(p / tile_x);
    T[j] = 1.0f;
    cr[j] = cg[j] = cb[j] = 0.0f;
  }

  for (int c = lo; c < n_chunks && (chunk_meta[c] >> 2) == tile; ++c) {
    const long long base = (long long)c * chunk;
    for (int i = threadIdx.x; i < kNumFeat * chunk; i += blockDim.x) {
      const int row = i / chunk;
      const int col = i - row * chunk;
      float v = __bfloat162float(feat[row * k_slots + base + col]);
      if (row == 0) v -= ox;
      if (row == 1) v -= oy;
      s_feat[row][col] = v;
    }
    __syncthreads();
    for (int g = 0; g < chunk; ++g) {
      const float x = s_feat[0][g], y = s_feat[1][g];
      const float a = s_feat[2][g], b = s_feat[3][g], cc = s_feat[4][g];
      const float opa = s_feat[5][g];
      const float r = s_feat[6][g], gr = s_feat[7][g], bl = s_feat[8][g];
#pragma unroll
      for (int j = 0; j < kMaxPixPerThread; ++j) {
        // power in the plain version's operation order and rounding (no
        // FMA contraction), so both take the same alpha-threshold branches
        const float dx = __fsub_rn(px[j], x);
        const float dy = __fsub_rn(py[j], y);
        const float quad =
            __fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx),
                      __fmul_rn(__fmul_rn(cc, dy), dy));
        const float power =
            __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(b, dx), dy));
        float alpha = fminf(kAlphaMax, opa * expf(power));
        if (power > 0.0f || alpha < kAlphaMin) alpha = 0.0f;
        const float w = alpha * T[j];
        cr[j] += r * w;
        cg[j] += gr * w;
        cb[j] += bl * w;
        T[j] *= 1.0f - alpha;
      }
    }
    int live = 0;
#pragma unroll
    for (int j = 0; j < kMaxPixPerThread; ++j) {
      const int p = threadIdx.x + j * blockDim.x;
      live |= (p < n_pix && T[j] > kTEps);
    }
    // barrier + tile-wide decision; also orders this chunk's shared-memory
    // reads before the next chunk's staging writes
    if (!__syncthreads_or(live)) break;
  }

  const float bg_r = bg[0], bg_g = bg[1], bg_b = bg[2];
  __nv_bfloat16* o = out + (long long)tile * 3 * n_pix;
#pragma unroll
  for (int j = 0; j < kMaxPixPerThread; ++j) {
    const int p = threadIdx.x + j * blockDim.x;
    if (p < n_pix) {
      o[p] = __float2bfloat16(cr[j] + T[j] * bg_r);
      o[n_pix + p] = __float2bfloat16(cg[j] + T[j] * bg_g);
      o[2 * n_pix + p] = __float2bfloat16(cb[j] + T[j] * bg_b);
    }
  }
}

}  // namespace

// chunk <= 256 and n_pix <= 4096, or cudaErrorInvalidValue
extern "C" int gsplat_render_forward(const void* feat, long long k_slots,
                                     const int* chunk_meta, int n_chunks,
                                     const float* bg, void* out,
                                     int num_tiles, int n_pix, int tile_x,
                                     int tile_y, int grid_x, int chunk,
                                     cudaStream_t stream) {
  if (num_tiles == 0) return 0;
  if (chunk > kMaxChunk || n_pix > 1024 * kMaxPixPerThread) {
    return (int)cudaErrorInvalidValue;
  }
  int threads = (n_pix + kMaxPixPerThread - 1) / kMaxPixPerThread;
  threads = ((threads + 31) / 32) * 32;
  render_kernel<<<num_tiles, threads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(feat), k_slots, chunk_meta, n_chunks,
      bg, static_cast<__nv_bfloat16*>(out), n_pix, tile_x, tile_y, grid_x,
      chunk);
  return (int)cudaGetLastError();
}
