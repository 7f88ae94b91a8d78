// Training tile blend, forward and backward, written for Hopper (sm_90a).
//
// blend_forward replaces gsplat_tpu/raster/tile_kernel.py::_fwd_kernel
// (wrapper _forward); blend_backward replaces _bwd_kernel (wrapper
// _backward). Semantics kept from the TPU kernels (the CUDA reference's
// renderCUDA rule): per tile, the tile's 128-slot chunks front to back;
// alpha = min(0.99, opa * e^power), 0 where power > 0 or alpha < 1/255; a
// contribution composites only while T * (1 - alpha) >= 1e-4 and the pixel
// is not done; the first violator is dropped and latches the pixel done,
// and its T freezes. The tile stops once every pixel is done. Tiles with no
// chunks give C = 0, T = 1.
//
// Outputs of the forward: ct [num_tiles, 4, n_pix] float32 (rows 0-2 the
// premultiplied color without background, row 3 the final T) and
// used [K_slots] int32, the number of pixels each slot composited into
// (the caller zero-fills it: slots of chunks past a tile's stop and of
// sentinel chunks stay 0). The backward takes dpack [num_tiles, 4, n_pix]
// (rows 0-2 dC, row 3 D = <dC, C> + dT * T per pixel) and writes
// dfeat [9, K_slots] = d(x, y, a, b, c, opa, r, g, b) per slot (the caller
// zero-fills it); the per-Gaussian reduction happens outside.
//
// Design. One block per tile, one thread per pixel (n_pix <= 1024), the
// done latch and T in registers. Each chunk's nine feature rows are staged
// once in shared memory with the mean shifted to tile-local coordinates.
// T is the sequential float32 product T *= (1 - alpha) (the TPU kernel's
// log1p scan was an MXU device), and the quadratic form, alpha and the
// product are written with __fmul_rn/__fadd_rn so nvcc does not contract
// them into FMAs: the kernels then take the same 1/255 and 1e-4 branches
// as the plain PyTorch versions in raster/tile_kernel.py. The tile stop is
// __syncthreads_or(!done) after each chunk.
//
// Per-slot sums over the tile's pixels stay inside the block, because a
// slot belongs to one tile: the forward counts composited pixels with a
// warp ballot per slot; the backward reduces its nine per-slot values with
// warp shuffles (skipped when no lane of the warp contributed) into a
// shared [warps][9][chunk] buffer that the block sums in warp order after
// the chunk. No global atomics, and the result does not depend on timing.
// The backward re-runs the forward front to back, carrying the running sum
// of <dC, rgb> * w, and uses the direct per-pixel chain rule
// (da = -dx^2/2 * dpower, db = -dx dy * dpower, ...) instead of the TPU's
// monomial matmul.
//
// Bound: operations. Each visited (pixel, slot) pair costs one expf and
// ~25 float operations in the forward, ~60 in the backward; the bytes are
// the feature stream (36 B/slot), the per-tile buffers (16 B/pixel) and
// the per-slot outputs.

#include <cuda_runtime.h>

namespace {

constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr int kNumFeat = 9;
constexpr int kMaxChunk = 128;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// first chunk whose tile id >= tile (tile ids ascend along chunk_meta;
// sentinel chunks carry num_tiles and sort last, so they are never visited)
__device__ __forceinline__ int first_chunk(const int* chunk_meta,
                                           int n_chunks, int tile) {
  int lo = 0, hi = n_chunks;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if ((chunk_meta[mid] >> 2) < tile) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ void stage_chunk(const float* __restrict__ feat,
                                            long long k_slots, long long base,
                                            int chunk, float ox, float oy,
                                            float (*s_feat)[kMaxChunk]) {
  for (int i = threadIdx.x; i < kNumFeat * chunk; i += blockDim.x) {
    const int row = i / chunk;
    const int col = i - row * chunk;
    float v = feat[row * k_slots + base + col];
    if (row == 0) v = __fsub_rn(v, ox);
    if (row == 1) v = __fsub_rn(v, oy);
    s_feat[row][col] = v;
  }
}

// power in the plain version's operation order and rounding
__device__ __forceinline__ float power_of(float dx, float dy, float a,
                                          float b, float c) {
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx),
                               __fmul_rn(__fmul_rn(c, dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(b, dx), dy));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kMaxThreads)
blend_forward_kernel(const float* __restrict__ feat, long long k_slots,
                     const int* __restrict__ chunk_meta, int n_chunks,
                     float* __restrict__ ct, int* __restrict__ used,
                     int n_pix, int tile_x, int tile_y, int grid_x,
                     int chunk) {
  __shared__ float s_feat[kNumFeat][kMaxChunk];
  __shared__ int s_hits[kMaxWarps][kMaxChunk];
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int n_warps = blockDim.x >> 5;
  const float ox = (float)((tile % grid_x) * tile_x);
  const float oy = (float)((tile / grid_x) * tile_y);
  const float px = (float)(p % tile_x);
  const float py = (float)(p / tile_x);

  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
  bool done = p >= n_pix;  // threads past the tile take no part
  for (int c = first_chunk(chunk_meta, n_chunks, tile);
       c < n_chunks && (chunk_meta[c] >> 2) == tile; ++c) {
    const long long base = (long long)c * chunk;
    stage_chunk(feat, k_slots, base, chunk, ox, oy, s_feat);
    __syncthreads();
    for (int g = 0; g < chunk; ++g) {
      bool hit = false;
      if (!done) {
        const float dx = __fsub_rn(px, s_feat[0][g]);
        const float dy = __fsub_rn(py, s_feat[1][g]);
        const float power =
            power_of(dx, dy, s_feat[2][g], s_feat[3][g], s_feat[4][g]);
        const float alpha =
            fminf(kAlphaMax, __fmul_rn(s_feat[5][g], expf(power)));
        if (!(power > 0.0f || alpha < kAlphaMin)) {
          const float t_next = __fmul_rn(T, __fsub_rn(1.0f, alpha));
          if (t_next < kTEps) {
            done = true;
          } else {
            const float w = __fmul_rn(alpha, T);
            cr = __fadd_rn(cr, __fmul_rn(s_feat[6][g], w));
            cg = __fadd_rn(cg, __fmul_rn(s_feat[7][g], w));
            cb = __fadd_rn(cb, __fmul_rn(s_feat[8][g], w));
            T = t_next;
            hit = true;
          }
        }
      }
      const unsigned votes = __ballot_sync(kFull, hit);
      if (lane == 0) s_hits[warp][g] = __popc(votes);
    }
    __syncthreads();
    for (int g = threadIdx.x; g < chunk; g += blockDim.x) {
      int n = 0;
      for (int w = 0; w < n_warps; ++w) n += s_hits[w][g];
      used[base + g] = n;
    }
    // barrier + tile-wide decision; also orders this chunk's shared-memory
    // reads before the next chunk's staging writes
    if (!__syncthreads_or(!done)) break;
  }

  if (p < n_pix) {
    float* o = ct + (long long)tile * 4 * n_pix;
    o[p] = cr;
    o[n_pix + p] = cg;
    o[2 * n_pix + p] = cb;
    o[3 * n_pix + p] = T;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
blend_backward_kernel(const float* __restrict__ feat, long long k_slots,
                      const int* __restrict__ chunk_meta, int n_chunks,
                      const float* __restrict__ dpack,
                      float* __restrict__ dfeat, int n_pix, int tile_x,
                      int tile_y, int grid_x, int chunk) {
  __shared__ float s_feat[kNumFeat][kMaxChunk];
  extern __shared__ float s_part[];  // [n_warps][kNumFeat][chunk]
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int n_warps = blockDim.x >> 5;
  const float ox = (float)((tile % grid_x) * tile_x);
  const float oy = (float)((tile / grid_x) * tile_y);
  const float px = (float)(p % tile_x);
  const float py = (float)(p / tile_x);

  bool done = p >= n_pix;
  float dcr = 0.0f, dcg = 0.0f, dcb = 0.0f, d_tot = 0.0f;
  if (!done) {
    const float* d = dpack + (long long)tile * 4 * n_pix;
    dcr = d[p];
    dcg = d[n_pix + p];
    dcb = d[2 * n_pix + p];
    d_tot = d[3 * n_pix + p];
  }
  float T = 1.0f;
  float acc = 0.0f;  // running sum of <dC, rgb> * w, inclusive
  for (int c = first_chunk(chunk_meta, n_chunks, tile);
       c < n_chunks && (chunk_meta[c] >> 2) == tile; ++c) {
    const long long base = (long long)c * chunk;
    stage_chunk(feat, k_slots, base, chunk, ox, oy, s_feat);
    __syncthreads();
    for (int g = 0; g < chunk; ++g) {
      float v[kNumFeat];
#pragma unroll
      for (int k = 0; k < kNumFeat; ++k) v[k] = 0.0f;
      bool live = false;
      if (!done) {
        const float dx = __fsub_rn(px, s_feat[0][g]);
        const float dy = __fsub_rn(py, s_feat[1][g]);
        const float a = s_feat[2][g], b = s_feat[3][g], cc = s_feat[4][g];
        const float opa = s_feat[5][g];
        const float power = power_of(dx, dy, a, b, cc);
        const float g_exp = expf(power);
        const float alpha = fminf(kAlphaMax, __fmul_rn(opa, g_exp));
        if (!(power > 0.0f || alpha < kAlphaMin)) {
          const float one_m = __fsub_rn(1.0f, alpha);
          const float t_next = __fmul_rn(T, one_m);
          if (t_next < kTEps) {
            done = true;
          } else {
            const float r = s_feat[6][g], gr = s_feat[7][g],
                        bl = s_feat[8][g];
            const float w = __fmul_rn(alpha, T);
            const float a_pg = dcr * r + dcg * gr + dcb * bl;
            acc += a_pg * w;
            // suffix contributions after this slot, the T term included
            const float s = d_tot - acc;
            const float dalpha = a_pg * T - s / one_m;
            // the 0.99 clamp passes the gradient through (backward.cu)
            const float de = dalpha * g_exp;
            const float dpow = de * opa;
            v[0] = dpow * (a * dx + b * dy);
            v[1] = dpow * (cc * dy + b * dx);
            v[2] = -0.5f * dpow * dx * dx;
            v[3] = -dpow * dx * dy;
            v[4] = -0.5f * dpow * dy * dy;
            v[5] = de;
            v[6] = dcr * w;
            v[7] = dcg * w;
            v[8] = dcb * w;
            T = t_next;
            live = true;
          }
        }
      }
      float* part = s_part + (long long)warp * kNumFeat * chunk + g;
      if (__any_sync(kFull, live)) {
#pragma unroll
        for (int k = 0; k < kNumFeat; ++k) v[k] = warp_sum(v[k]);
        if (lane == 0) {
#pragma unroll
          for (int k = 0; k < kNumFeat; ++k) part[k * chunk] = v[k];
        }
      } else if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kNumFeat; ++k) part[k * chunk] = 0.0f;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kNumFeat * chunk; i += blockDim.x) {
      float sum = 0.0f;
      for (int w = 0; w < n_warps; ++w) sum += s_part[w * kNumFeat * chunk + i];
      const int row = i / chunk;
      dfeat[row * k_slots + base + (i - row * chunk)] = sum;
    }
    if (!__syncthreads_or(!done)) break;
  }
}

int block_threads(int n_pix) { return ((n_pix + 31) / 32) * 32; }

}  // namespace

// chunk <= 128 and n_pix <= 1024, or cudaErrorInvalidValue
extern "C" int gsplat_blend_forward(const float* feat, long long k_slots,
                                    const int* chunk_meta, int n_chunks,
                                    float* ct, int* used, int num_tiles,
                                    int n_pix, int tile_x, int tile_y,
                                    int grid_x, int chunk,
                                    cudaStream_t stream) {
  if (num_tiles == 0) return 0;
  if (chunk > kMaxChunk || n_pix > kMaxThreads || n_pix <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  blend_forward_kernel<<<num_tiles, block_threads(n_pix), 0, stream>>>(
      feat, k_slots, chunk_meta, n_chunks, ct, used, n_pix, tile_x, tile_y,
      grid_x, chunk);
  return (int)cudaGetLastError();
}

extern "C" int gsplat_blend_backward(const float* feat, long long k_slots,
                                     const int* chunk_meta, int n_chunks,
                                     const float* dpack, float* dfeat,
                                     int num_tiles, int n_pix, int tile_x,
                                     int tile_y, int grid_x, int chunk,
                                     cudaStream_t stream) {
  if (num_tiles == 0) return 0;
  if (chunk > kMaxChunk || n_pix > kMaxThreads || n_pix <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = block_threads(n_pix);
  const int smem = (threads / 32) * kNumFeat * chunk * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      blend_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  blend_backward_kernel<<<num_tiles, threads, smem, stream>>>(
      feat, k_slots, chunk_meta, n_chunks, dpack, dfeat, n_pix, tile_x,
      tile_y, grid_x, chunk);
  return (int)cudaGetLastError();
}
