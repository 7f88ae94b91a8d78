// Training tile blend, forward and backward, written for Hopper (sm_90a).
//
// blend_forward replaces gsplat_tpu/raster/tile_kernel.py::_fwd_kernel
// (wrapper _forward); blend_backward replaces _bwd_kernel (wrapper
// _backward). Semantics kept from the TPU kernels (the CUDA reference's
// renderCUDA rule): per tile, the tile's chunks front to back;
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
// What bounds them on this card: issue slots. Every (pixel, slot) pair a
// thread evaluates costs one expf and ~25 float operations in the forward,
// ~60 in the backward, whether or not it contributes, and on the training
// scenes only a few percent of the pairs of a tile's chunks pass
// alpha >= 1/255 (a quarter of the slots are chunk padding with opacity 0).
// The bytes (36 B a slot, 16 B a pixel) are far below the memory rate.
// The design therefore evaluates fewer pairs and makes each one cheaper:
//
// - One block per tile. Each warp owns a compact block of pixels:
//   kPix pixels a thread, strided 8 columns and 4 rows apart, so a warp's
//   8 x 4 lanes cover kBlockX x kBlockY pixels (16 x 8 at kPix = 4).
//   Very thin tiles take kPix * 32 consecutive pixels a warp instead
//   (tile_common.cuh: tile_geometry). Pixels past the tile are done from
//   the start. T, the done latch and the running sums stay in registers.
// - Any tile size and chunk. A block has at most kMaxWarps warps (1,024
//   pixels; at the backward's register count more threads would not fit
//   an SM), so a larger tile walks its chunks once for each group of
//   kMaxWarps warp blocks in turn. The stop rule is per pixel, so a group
//   stops on its own; used adds the groups' integer counts and dfeat the
//   groups' sums in group order. A chunk larger than kMaxChunk slots is
//   staged and walked in pieces of kMaxChunk, in slot order; chunk_meta
//   still marks chunks. At the default shapes (up to 1,024 pixels and
//   128-slot chunks) both loops run once.
// - The block stages each chunk as records: per slot 48 bytes (the mean
//   shifted to tile coordinates, -a/2, b, -c/2, opacity, rgb and a cull
//   extent), which a thread reads with three 16-byte broadcast loads and
//   uses for all its pixels. Staging is synchronous: double-buffering the
//   chunk with cp.async measured no faster (scripts/torch_blend_variants.py).
// - Exact culling per warp. Each lane tests its slots' cull boxes against
//   the warp's kPix sub-blocks (a thread's j-th pixels across the warp form
//   one 8 x 4 sub-block), keeps the sub-block bits per slot in shared
//   memory, and the warp ballots which slots meet any sub-block (four
//   ballots for 128 slots). The warp walks only those slots and, for each,
//   only the sub-blocks its box meets (a warp-uniform branch). It stops
//   walking once all its pixels are done. The block-wide stop
//   (__syncthreads_or) is unchanged.
// - The backward sums each slot's nine values over a thread's pixels in
//   registers, then over the warp with a reduce-scatter butterfly (12
//   shuffles, not 9 x 5), only for slots where some lane was live, into a
//   [warps][chunk][9] shared buffer that the block sums in warp order.
//   No float atomics: dfeat is the same from run to run.
//
// Why the culling is exact: see tile_common.cuh, which holds the cull
// box, the staged record and the warp pixel geometry (shared with the
// inference render, render_kernel.cu).

#include <cuda_runtime.h>

#include "tile_common.cuh"

namespace {

// staging sizes, not limits: a chunk is staged in pieces of up to
// kMaxChunk slots and a tile runs kMaxWarps warps over its pixel groups
constexpr int kMaxChunk = 128;
constexpr int kMaskWords = kMaxChunk / 32;
constexpr int kMaxWarps = 1024 / (32 * kPix);
constexpr int kMaxThreads = 32 * kMaxWarps;

// Shared memory both kernels use: the staged chunk, each warp's sub-block
// boxes (x0, x1, y0, y1 of its valid pixels) and, per slot, the bits of the
// sub-blocks its cull box meets.
struct Staging {
  Slot slot[kMaxChunk];
  float4 box[kMaxWarps][kPix];
  unsigned char sub[kMaxWarps][kMaxChunk];
};

// stage one chunk as records (mean to tile coordinates, -a/2, -c/2, the
// cull extents); thread g reads slot g's nine feature rows
__device__ __forceinline__ void stage_chunk(const float* __restrict__ feat,
                                            long long k_slots, long long base,
                                            int chunk, float ox, float oy,
                                            Slot* __restrict__ s) {
  for (int g = threadIdx.x; g < chunk; g += blockDim.x) {
    const float* f = feat + base + g;
    s[g] = make_slot(f[0], f[k_slots], f[2 * k_slots], f[3 * k_slots],
                     f[4 * k_slots], f[5 * k_slots], f[6 * k_slots],
                     f[7 * k_slots], f[8 * k_slots], ox, oy);
  }
}

// Per slot of the chunk, the bits of the warp's sub-blocks its cull box
// meets (into ``sub``), and the slots that meet any as ballot words.
__device__ __forceinline__ void cull_mask(const Staging& st, int chunk,
                                          int warp, int lane,
                                          unsigned char* sub,
                                          unsigned (&todo)[kMaskWords]) {
  float4 box[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) box[j] = st.box[warp][j];
#pragma unroll
  for (int w = 0; w < kMaskWords; ++w) {
    const int g = w * 32 + lane;
    unsigned bits = 0u;
    if (g < chunk) {
      const Slot s = st.slot[g];
#pragma unroll
      for (int j = 0; j < kPix; ++j) bits |= meets(s, box[j]) ? 1u << j : 0u;
      sub[g] = static_cast<unsigned char>(bits);
    }
    todo[w] = __ballot_sync(kFull, bits != 0u);
  }
  __syncwarp();
}

// Warp sum of nine values in 12 shuffles: halve the set of values a lane
// holds at each of the xor-16, 8, 4, 2 steps (padding 9 -> 10 -> 6 -> 4 ->
// 2), then one all-reduce step. Lanes 2i and 2i + 1 end with the sum of
// value sum9_index(lane), or of a padding zero where that is -1. The order
// of the additions is fixed, so the result is the same on every run.
__device__ __forceinline__ float warp_sum9(const float (&v)[kNumFeat],
                                           int lane) {
  float a[5];
  const bool h4 = lane & 16;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const float lo = v[k];
    const float hi = k + 5 < kNumFeat ? v[k + 5] : 0.0f;
    a[k] = (h4 ? hi : lo) + __shfl_xor_sync(kFull, h4 ? lo : hi, 16);
  }
  float b[3];
  const bool h3 = lane & 8;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float lo = a[k];
    const float hi = k + 3 < 5 ? a[k + 3] : 0.0f;
    b[k] = (h3 ? hi : lo) + __shfl_xor_sync(kFull, h3 ? lo : hi, 8);
  }
  float c[2];
  const bool h2 = lane & 4;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float lo = b[k];
    const float hi = k + 2 < 3 ? b[k + 2] : 0.0f;
    c[k] = (h2 ? hi : lo) + __shfl_xor_sync(kFull, h2 ? lo : hi, 4);
  }
  const bool h1 = lane & 2;
  float d = (h1 ? c[1] : c[0]) + __shfl_xor_sync(kFull, h1 ? c[0] : c[1], 2);
  return d + __shfl_xor_sync(kFull, d, 1);
}

// which of the nine sums warp_sum9 leaves in ``lane`` (-1: padding)
__device__ __forceinline__ int sum9_index(int lane) {
  const int h4 = (lane >> 4) & 1, h3 = (lane >> 3) & 1;
  const int x = 2 * ((lane >> 2) & 1) + ((lane >> 1) & 1);
  if (!h3) return x < 3 ? 5 * h4 + x : -1;
  return 3 + x < (h4 ? 4 : 5) ? 5 * h4 + 3 + x : -1;
}

// kSplit: the tile may run in several pixel groups or its chunks in several
// pieces. The default shapes take the kSplit = false instantiation, in
// which both loops run once at compile time (the registers of a kernel
// without them).
template <bool kSplit>
__global__ void __launch_bounds__(kMaxThreads)
blend_forward_kernel(const float* __restrict__ feat, long long k_slots,
                     const int* __restrict__ chunk_meta, int n_chunks,
                     float* __restrict__ ct, int* __restrict__ used,
                     int n_pix, int tile_x, int tile_y, int grid_x, int nbx,
                     int groups, int chunk) {
  __shared__ Staging st;
  __shared__ int s_hits[kMaxWarps][kMaxChunk];
  __shared__ unsigned s_mask[kMaxWarps][kMaskWords];
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const float ox = (float)((tile % grid_x) * tile_x);
  const float oy = (float)((tile / grid_x) * tile_y);
  unsigned char* sub = st.sub[warp];
  float* o = ct + (long long)tile * 4 * n_pix;

  // the tile's pixel groups in turn: a pixel's walk is its own (the stop
  // rule is per pixel), so each group walks to its own stop; used sums
  // the groups' counts
  for (int q = 0; q < (kSplit ? groups : 1); ++q) {
    const Pixels px = pixels_of(q * n_warps + warp, lane, nbx, n_pix,
                                tile_x, tile_y, st.box[warp]);
    float T[kPix], cr[kPix], cg[kPix], cb[kPix];
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      T[j] = 1.0f;
      cr[j] = cg[j] = cb[j] = 0.0f;
    }
    unsigned done = ~px.valid & kAllPix;  // pixels past the tile take no part
    for (int c = first_chunk(chunk_meta, n_chunks, tile);
         c < n_chunks && (chunk_meta[c] >> 2) == tile; ++c) {
      // a chunk in pieces of kMaxChunk slots, in slot order
      bool live = true;
      for (int off = 0; live && off < (kSplit ? chunk : 1);
           off += kMaxChunk) {
        const int len = kSplit ? min(kMaxChunk, chunk - off) : chunk;
        const long long base = (long long)c * chunk + off;
        stage_chunk(feat, k_slots, base, len, ox, oy, st.slot);
        __syncthreads();

        unsigned todo[kMaskWords], hit_bits[kMaskWords];
        const bool warp_done = __all_sync(kFull, done == kAllPix);
        cull_mask(st, warp_done ? 0 : len, warp, lane, sub, todo);
        bool walking = !warp_done;
#pragma unroll
        for (int w = 0; w < kMaskWords; ++w) {
          hit_bits[w] = 0u;
          unsigned bits = walking ? todo[w] : 0u;
          while (bits) {
            const int g = w * 32 + __ffs(bits) - 1;
            bits &= bits - 1u;
            const Slot s = st.slot[g];
            int hits = 0;
            const unsigned meet = sub[g];
#pragma unroll
            for (int j = 0; j < kPix; ++j) {
              if (!(meet >> j & 1u)) continue;  // warp-uniform
              if (done >> j & 1u) continue;
              const float dx = __fsub_rn(px.x[j], s.p.x);
              const float dy = __fsub_rn(px.y[j], s.p.y);
              const float power = power_of(dx, dy, s.p.z, s.p.w, s.q.x);
              const float alpha =
                  fminf(kAlphaMax, __fmul_rn(s.q.y, expf(power)));
              if (power > 0.0f || alpha < kAlphaMin) continue;
              const float t_next = __fmul_rn(T[j], __fsub_rn(1.0f, alpha));
              if (t_next < kTEps) {
                done |= 1u << j;
                continue;
              }
              const float wgt = __fmul_rn(alpha, T[j]);
              cr[j] = __fadd_rn(cr[j], __fmul_rn(s.q.z, wgt));
              cg[j] = __fadd_rn(cg[j], __fmul_rn(s.q.w, wgt));
              cb[j] = __fadd_rn(cb[j], __fmul_rn(s.r.x, wgt));
              T[j] = t_next;
              ++hits;
            }
            const int n = __reduce_add_sync(kFull, hits);
            if (n > 0) {
              hit_bits[w] |= 1u << (g & 31);
              if (lane == 0) s_hits[warp][g] = n;
            }
            if (__all_sync(kFull, done == kAllPix)) {
              walking = false;
              break;
            }
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int w = 0; w < kMaskWords; ++w) s_mask[warp][w] = hit_bits[w];
        }
        __syncthreads();
        for (int g = threadIdx.x; g < len; g += blockDim.x) {
          int n = 0;
          for (int w = 0; w < n_warps; ++w) {
            if (s_mask[w][g >> 5] >> (g & 31) & 1u) n += s_hits[w][g];
          }
          // the same thread owns slot g in every group: no race
          if (!kSplit || q == 0) {
            used[base + g] = n;
          } else {
            used[base + g] += n;
          }
        }
        // barrier + group-wide decision (the rest of a chunk adds nothing
        // once every pixel is done); also orders this piece's
        // shared-memory reads before the next piece's writes
        live = __syncthreads_or(done != kAllPix);
      }
      if (!live) break;
    }

#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      if (!(px.valid >> j & 1u)) continue;
      const int p = pixel_index(px, j, tile_x);
      o[p] = cr[j];
      o[n_pix + p] = cg[j];
      o[2 * n_pix + p] = cb[j];
      o[3 * n_pix + p] = T[j];
    }
  }
}

template <bool kSplit>
__global__ void __launch_bounds__(kMaxThreads)
blend_backward_kernel(const float* __restrict__ feat, long long k_slots,
                      const int* __restrict__ chunk_meta, int n_chunks,
                      const float* __restrict__ dpack,
                      float* __restrict__ dfeat, int n_pix, int tile_x,
                      int tile_y, int grid_x, int nbx, int groups,
                      int chunk) {
  __shared__ Staging st;
  __shared__ unsigned s_mask[kMaxWarps][kMaskWords];
  extern __shared__ float s_part[];  // [n_warps][piece][kNumFeat]
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int piece = kSplit ? min(chunk, kMaxChunk) : chunk;
  const float ox = (float)((tile % grid_x) * tile_x);
  const float oy = (float)((tile / grid_x) * tile_y);
  unsigned char* sub = st.sub[warp];
  const int out_k = sum9_index(lane);

  // the tile's pixel groups in turn, each to its own stop; a slot's sums
  // add the groups in order (no float atomics: the same bits every run)
  for (int q = 0; q < (kSplit ? groups : 1); ++q) {
    const Pixels px = pixels_of(q * n_warps + warp, lane, nbx, n_pix,
                                tile_x, tile_y, st.box[warp]);
    float T[kPix], acc[kPix], dcr[kPix], dcg[kPix], dcb[kPix], d_tot[kPix];
    const float* d = dpack + (long long)tile * 4 * n_pix;
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      T[j] = 1.0f;
      acc[j] = 0.0f;  // running sum of <dC, rgb> * w, inclusive
      dcr[j] = dcg[j] = dcb[j] = d_tot[j] = 0.0f;
      if (px.valid >> j & 1u) {
        const int p = pixel_index(px, j, tile_x);
        dcr[j] = d[p];
        dcg[j] = d[n_pix + p];
        dcb[j] = d[2 * n_pix + p];
        d_tot[j] = d[3 * n_pix + p];
      }
    }
    unsigned done = ~px.valid & kAllPix;
    for (int c = first_chunk(chunk_meta, n_chunks, tile);
         c < n_chunks && (chunk_meta[c] >> 2) == tile; ++c) {
      bool live = true;
      for (int off = 0; live && off < (kSplit ? chunk : 1);
           off += kMaxChunk) {
        const int len = kSplit ? min(kMaxChunk, chunk - off) : chunk;
        const long long base = (long long)c * chunk + off;
        stage_chunk(feat, k_slots, base, len, ox, oy, st.slot);
        __syncthreads();

        unsigned todo[kMaskWords], live_bits[kMaskWords];
        const bool warp_done = __all_sync(kFull, done == kAllPix);
        cull_mask(st, warp_done ? 0 : len, warp, lane, sub, todo);
        bool walking = !warp_done;
        float* part = s_part + (long long)warp * piece * kNumFeat;
#pragma unroll
        for (int w = 0; w < kMaskWords; ++w) {
          live_bits[w] = 0u;
          unsigned bits = walking ? todo[w] : 0u;
          while (bits) {
            const int g = w * 32 + __ffs(bits) - 1;
            bits &= bits - 1u;
            const Slot s = st.slot[g];
            const float ha = s.p.z, b = s.p.w, hc = s.q.x, opa = s.q.y;
            const float a = -2.0f * ha, cc = -2.0f * hc;  // exact
            float v[kNumFeat];
#pragma unroll
            for (int k = 0; k < kNumFeat; ++k) v[k] = 0.0f;
            bool live = false;
            const unsigned meet = sub[g];
#pragma unroll
            for (int j = 0; j < kPix; ++j) {
              if (!(meet >> j & 1u)) continue;  // warp-uniform
              if (done >> j & 1u) continue;
              const float dx = __fsub_rn(px.x[j], s.p.x);
              const float dy = __fsub_rn(px.y[j], s.p.y);
              const float power = power_of(dx, dy, ha, b, hc);
              const float g_exp = expf(power);
              const float alpha = fminf(kAlphaMax, __fmul_rn(opa, g_exp));
              if (power > 0.0f || alpha < kAlphaMin) continue;
              const float one_m = __fsub_rn(1.0f, alpha);
              const float t_next = __fmul_rn(T[j], one_m);
              if (t_next < kTEps) {
                done |= 1u << j;
                continue;
              }
              const float wgt = __fmul_rn(alpha, T[j]);
              const float a_pg =
                  dcr[j] * s.q.z + dcg[j] * s.q.w + dcb[j] * s.r.x;
              acc[j] += a_pg * wgt;
              // suffix contributions after this slot, the T term included
              const float suf = d_tot[j] - acc[j];
              const float dalpha = a_pg * T[j] - suf / one_m;
              // the 0.99 clamp passes the gradient through (backward.cu)
              const float de = dalpha * g_exp;
              const float dpow = de * opa;
              v[0] += dpow * (a * dx + b * dy);
              v[1] += dpow * (cc * dy + b * dx);
              v[2] += -0.5f * dpow * dx * dx;
              v[3] += -dpow * dx * dy;
              v[4] += -0.5f * dpow * dy * dy;
              v[5] += de;
              v[6] += dcr[j] * wgt;
              v[7] += dcg[j] * wgt;
              v[8] += dcb[j] * wgt;
              T[j] = t_next;
              live = true;
            }
            if (__any_sync(kFull, live)) {
              const float sum = warp_sum9(v, lane);
              if (out_k >= 0 && !(lane & 1)) part[g * kNumFeat + out_k] = sum;
              live_bits[w] |= 1u << (g & 31);
            }
            if (__all_sync(kFull, done == kAllPix)) {
              walking = false;
              break;
            }
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int w = 0; w < kMaskWords; ++w) s_mask[warp][w] = live_bits[w];
        }
        __syncthreads();
        for (int i = threadIdx.x; i < kNumFeat * len; i += blockDim.x) {
          const int row = i / len;
          const int col = i - row * len;
          float sum = 0.0f;
          for (int w = 0; w < n_warps; ++w) {
            if (s_mask[w][col >> 5] >> (col & 31) & 1u) {
              sum += s_part[((long long)w * piece + col) * kNumFeat + row];
            }
          }
          // the same thread owns (row, col) in every group: no race
          float* dst = dfeat + row * k_slots + base + col;
          if (!kSplit || q == 0) {
            *dst = sum;
          } else {
            *dst += sum;
          }
        }
        live = __syncthreads_or(done != kAllPix);
      }
      if (!live) break;
    }
  }
}

bool bad_args(int n_pix, int chunk) { return chunk <= 0 || n_pix <= 0; }

}  // namespace

// any chunk > 0 and n_pix > 0 (larger tiles run in pixel groups, larger
// chunks in pieces), or cudaErrorInvalidValue
extern "C" int gsplat_blend_forward(const float* feat, long long k_slots,
                                    const int* chunk_meta, int n_chunks,
                                    float* ct, int* used, int num_tiles,
                                    int n_pix, int tile_x, int tile_y,
                                    int grid_x, int chunk,
                                    cudaStream_t stream) {
  if (num_tiles == 0) return 0;
  if (bad_args(n_pix, chunk)) return (int)cudaErrorInvalidValue;
  const Geometry geo = tile_geometry(n_pix, tile_x, tile_y, kMaxWarps);
  auto* kernel = geo.groups > 1 || chunk > kMaxChunk
                     ? blend_forward_kernel<true>
                     : blend_forward_kernel<false>;
  kernel<<<num_tiles, 32 * geo.warps, 0, stream>>>(
      feat, k_slots, chunk_meta, n_chunks, ct, used, n_pix, tile_x, tile_y,
      grid_x, geo.nbx, geo.groups, chunk);
  return (int)cudaGetLastError();
}

extern "C" int gsplat_blend_backward(const float* feat, long long k_slots,
                                     const int* chunk_meta, int n_chunks,
                                     const float* dpack, float* dfeat,
                                     int num_tiles, int n_pix, int tile_x,
                                     int tile_y, int grid_x, int chunk,
                                     cudaStream_t stream) {
  if (num_tiles == 0) return 0;
  if (bad_args(n_pix, chunk)) return (int)cudaErrorInvalidValue;
  const Geometry geo = tile_geometry(n_pix, tile_x, tile_y, kMaxWarps);
  const int piece = chunk < kMaxChunk ? chunk : kMaxChunk;
  const int smem = geo.warps * piece * kNumFeat * (int)sizeof(float);
  auto* kernel = geo.groups > 1 || chunk > kMaxChunk
                     ? blend_backward_kernel<true>
                     : blend_backward_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<num_tiles, 32 * geo.warps, smem, stream>>>(
      feat, k_slots, chunk_meta, n_chunks, dpack, dfeat, n_pix, tile_x,
      tile_y, grid_x, geo.nbx, geo.groups, chunk);
  return (int)cudaGetLastError();
}
