// Inference tile render, written for Hopper (sm_90a).
//
// Replaces gsplat_tpu/raster/tile_kernel.py::_render_kernel (wrapper
// render_forward). Semantics kept from the TPU kernel: per tile, walk the
// tile's chunks front to back; alpha = min(0.99, opa * e^power), 0 where
// power > 0 or alpha < 1/255; no per-pixel stop rule; after each chunk
// the whole tile stops once every pixel has T <= 1e-4; the background is
// composited in; tiles without chunks are pure background. Output bf16
// [num_tiles, 3, n_pix], the JAX layout. Compositing is sequential per
// pixel in float32, T *= (1 - alpha): the TPU kernel's bf16 log1p scan and
// bf16 color matmul were MXU devices and are not carried over.
//
// What bounds it on this card: issue slots. Each (pixel, slot) pair a
// thread evaluates costs one expf and ~25 float operations; on the serving
// frame only ~28% of the pairs of the visited chunks pass 1/255, and the
// bytes (18 B a slot, 6 B a pixel) are far below the memory rate. The
// busiest tiles hold up to five chunks, which one block walks in series.
// The design evaluates fewer pairs and spreads each tile over SMs:
//
// - Each warp owns a compact 16 x 8 pixel block at four pixels a thread
//   (tile_common.cuh: pixels_of), so a 128 x 32 tile is 8 x 4 warp
//   blocks; pixels past a ragged tile are masked, and thin tiles take
//   consecutive pixels a warp. T and the three running sums stay in
//   registers.
// - A tile of more than kBlockWarps warps is split over a thread-block
//   cluster of up to four blocks (kBlockWarps warps each, the tile's warps
//   in order), which the card places on neighbouring SMs. Every block
//   stages and walks the chunks for its own pixels. The tile-wide stop is
//   a vote: each block's __syncthreads_or, published in its shared memory,
//   read by every block of the cluster through distributed shared memory
//   after a cluster barrier (barrier.cluster arrive/wait with
//   release/acquire). All blocks read the same votes, so they leave the
//   chunk loop together; a last cluster barrier keeps each block's shared
//   memory alive until the others have read it.
// - The block stages each chunk once as 48-byte float records decoded from
//   the bf16 rows (the mean shifted to tile coordinates, -a/2, b, -c/2,
//   opacity, rgb and the cull extents computed from those decoded values).
// - Exact culling per warp, as in the training blends: each lane tests one
//   slot of a 32-slot word against the warp's four 8 x 4 sub-blocks, the
//   warp ballots the slots that meet any, and walks those in order,
//   evaluating only the sub-blocks each slot's box meets (the bits come
//   from the testing lane by a shuffle; a warp-uniform branch). A slot
//   that meets all four (most kept slots) takes a straight-line path that
//   evaluates the four pixels side by side: each pixel's chain (quadratic
//   form, expf, composite) is latency-bound, and the per-sub-block
//   branches kept the chains apart. On compact blocks that path also
//   shares the products of the quadratic form between pixels on one row
//   or column. The proof
//   that a culled pair would have added nothing is in tile_common.cuh; the
//   power here is that file's staged form, which equals the plain render's
//   -0.5 (a dx dx + c dy dy) - b dx dy bit for bit (-1/2 scales exactly).
//   There is no per-warp stop: a warp whose pixels are all below 1e-4
//   keeps compositing until the tile stops, as the plain version does.
// - Any tile size and chunk. A tile of more than kTileWarps (32) warp
//   blocks walks its chunks once for each group of 32 in turn. The stop is
//   tile-wide, so a group cannot finish alone: each group walks to its own
//   stop (every pixel of the group at T <= 1e-4 after a chunk; T only
//   falls, so the tile stops after the latest group's stop), writes its
//   pixels and keeps its state (T and colour, 16 B a pixel) in a scratch
//   buffer; then the groups that stopped earlier resume from that state up
//   to the tile's stop and write again. Each pair is evaluated once. A
//   chunk larger than kMaxChunk slots is staged and walked in pieces, in
//   slot order; the vote comes after the whole chunk. At the default
//   shapes (up to 4,096 pixels and 256-slot chunks) there is one group and
//   one piece, and no scratch.
//
// RENDER_BLOCK_WARPS (8: clusters for big tiles; 32: one block per tile),
// RENDER_CULL (1; 0: every pair evaluated) and RENDER_ILP (1; 0: no
// straight-line path for slots that meet all four sub-blocks) exist so
// that scripts/torch_serve_variants.py can build the ablations of this
// source.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tile_common.cuh"

#ifndef RENDER_BLOCK_WARPS
#define RENDER_BLOCK_WARPS 8
#endif
#ifndef RENDER_CULL
#define RENDER_CULL 1
#endif
#ifndef RENDER_ILP
#define RENDER_ILP 1
#endif

namespace {

namespace cg = cooperative_groups;

// staging sizes, not limits: a chunk is staged in pieces of up to kMaxChunk
// slots, and a tile runs kTileWarps warps (4,096 pixels) a group of pixels
constexpr int kMaxChunk = 256;
constexpr int kTileWarps = 32;
constexpr int kBlockWarps = RENDER_BLOCK_WARPS;
constexpr int kMaxCluster = kTileWarps / kBlockWarps;
constexpr bool kCull = RENDER_CULL != 0;
constexpr bool kIlp = RENDER_ILP != 0;
static_assert(kTileWarps % kBlockWarps == 0 && kMaxCluster <= 8,
              "a tile's warps must split over a portable cluster");
static_assert(kPixX == 2 && kPixY == 2,
              "the shared terms of the all-four path assume 2 x 2 pixels");

struct RenderStaging {
  Slot slot[kMaxChunk];
  float4 box[kBlockWarps][kPix];
  int vote[2];
};

// stage slots [base, base + len) as records decoded from the bf16 rows
__device__ __forceinline__ void stage_piece(
    const __nv_bfloat16* __restrict__ feat, long long k_slots,
    long long base, int len, float ox, float oy, Slot* __restrict__ slot) {
  for (int g = threadIdx.x; g < len; g += blockDim.x) {
    const __nv_bfloat16* f = feat + base + g;
    float v[kNumFeat];
#pragma unroll
    for (int i = 0; i < kNumFeat; ++i) v[i] = __bfloat162float(f[i * k_slots]);
    slot[g] = make_slot(v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8],
                        ox, oy);
  }
}

// composite the staged slots [0, len) into the thread's pixels, in slot
// order, evaluating only the (sub-block, slot) pairs the cull box keeps
__device__ __forceinline__ void composite_piece(
    const RenderStaging& st, int len, int lwarp, int lane, int nbx,
    const Pixels& px, float (&T)[kPix], float (&cr)[kPix],
    float (&cg_)[kPix], float (&cb)[kPix]) {
  for (int g0 = 0; g0 < len; g0 += 32) {
    // lane l tests slot g0 + l against the warp's sub-blocks
    unsigned bits = 0u;
    if (g0 + lane < len) {
      if (kCull) {
        const Slot s = st.slot[g0 + lane];
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
          bits |= meets(s, st.box[lwarp][j]) ? 1u << j : 0u;
        }
      } else {
        bits = kAllPix;
      }
    }
    unsigned todo = __ballot_sync(kFull, bits != 0u);
    while (todo) {
      const int l = __ffs(todo) - 1;
      todo &= todo - 1u;
      const unsigned meet = __shfl_sync(kFull, bits, l);
      const Slot s = st.slot[g0 + l];
      if (kIlp && meet == kAllPix) {
        // every sub-block: the four pixels' chains side by side, no
        // branch between them (alpha 0 leaves colour and T unchanged)
        float alpha[kPix], pw[kPix];
        if (nbx > 0) {
          // compact blocks: pixels 0/2 share x, 1/3 share x, 0/1 and 2/3
          // share y, so power_of's products are shared (same roundings)
          const float dx0 = __fsub_rn(px.x[0], s.p.x);
          const float dx1 = __fsub_rn(px.x[1], s.p.x);
          const float dy0 = __fsub_rn(px.y[0], s.p.y);
          const float dy2 = __fsub_rn(px.y[2], s.p.y);
          const float qx0 = __fmul_rn(__fmul_rn(s.p.z, dx0), dx0);
          const float qx1 = __fmul_rn(__fmul_rn(s.p.z, dx1), dx1);
          const float qy0 = __fmul_rn(__fmul_rn(s.q.x, dy0), dy0);
          const float qy2 = __fmul_rn(__fmul_rn(s.q.x, dy2), dy2);
          const float bx0 = __fmul_rn(s.p.w, dx0);
          const float bx1 = __fmul_rn(s.p.w, dx1);
          pw[0] = __fsub_rn(__fadd_rn(qx0, qy0), __fmul_rn(bx0, dy0));
          pw[1] = __fsub_rn(__fadd_rn(qx1, qy0), __fmul_rn(bx1, dy0));
          pw[2] = __fsub_rn(__fadd_rn(qx0, qy2), __fmul_rn(bx0, dy2));
          pw[3] = __fsub_rn(__fadd_rn(qx1, qy2), __fmul_rn(bx1, dy2));
        } else {
#pragma unroll
          for (int j = 0; j < kPix; ++j) {
            pw[j] = power_of(__fsub_rn(px.x[j], s.p.x),
                             __fsub_rn(px.y[j], s.p.y), s.p.z, s.p.w, s.q.x);
          }
        }
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
          const float a = fminf(kAlphaMax, __fmul_rn(s.q.y, expf(pw[j])));
          alpha[j] = (pw[j] > 0.0f || a < kAlphaMin) ? 0.0f : a;
        }
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
          const float w = alpha[j] * T[j];
          cr[j] += s.q.z * w;
          cg_[j] += s.q.w * w;
          cb[j] += s.r.x * w;
          T[j] *= 1.0f - alpha[j];
        }
        continue;
      }
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        if (!(meet >> j & 1u)) continue;  // warp-uniform
        const float dx = __fsub_rn(px.x[j], s.p.x);
        const float dy = __fsub_rn(px.y[j], s.p.y);
        const float power = power_of(dx, dy, s.p.z, s.p.w, s.q.x);
        const float alpha = fminf(kAlphaMax, __fmul_rn(s.q.y, expf(power)));
        if (power > 0.0f || alpha < kAlphaMin) continue;
        const float w = alpha * T[j];
        cr[j] += s.q.z * w;
        cg_[j] += s.q.w * w;
        cb[j] += s.r.x * w;
        T[j] *= 1.0f - alpha;
      }
    }
  }
}

// the thread's pixels of the tile's image, colour over the background
__device__ __forceinline__ void write_pixels(
    __nv_bfloat16* __restrict__ o, const float* __restrict__ bg, int n_pix,
    int tile_x, const Pixels& px, const float (&T)[kPix],
    const float (&cr)[kPix], const float (&cg_)[kPix],
    const float (&cb)[kPix]) {
  const float bg_r = bg[0], bg_g = bg[1], bg_b = bg[2];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    if (!(px.valid >> j & 1u)) continue;
    const int p = pixel_index(px, j, tile_x);
    o[p] = __float2bfloat16(cr[j] + T[j] * bg_r);
    o[n_pix + p] = __float2bfloat16(cg_[j] + T[j] * bg_g);
    o[2 * n_pix + p] = __float2bfloat16(cb[j] + T[j] * bg_b);
  }
}

// scratch (tiles of more than one pixel group only): per tile the carried
// state [4][n_pix] (T, r, g, b), then one int a (block, group): the chunk
// after the group's own stop. kSplit: the tile may run in several pixel
// groups or its chunks in several pieces; the default shapes take the
// kSplit = false instantiation, in which the group and piece loops run
// once at compile time and step 2 is left out.
template <bool kSplit>
__global__ void __launch_bounds__(32 * kBlockWarps)
render_kernel(const __nv_bfloat16* __restrict__ feat, long long k_slots,
              const int* __restrict__ chunk_meta, int n_chunks,
              const float* __restrict__ bg, __nv_bfloat16* __restrict__ out,
              float* __restrict__ scratch, int n_pix, int tile_x, int tile_y,
              int grid_x, int nbx, int groups, int chunk) {
  __shared__ RenderStaging st;
  cg::cluster_group cluster = cg::this_cluster();
  const int parts = static_cast<int>(cluster.num_blocks());
  const int tile = blockIdx.x / parts;
  const int lane = threadIdx.x & 31;
  const int lwarp = threadIdx.x >> 5;
  // the tile's warps in order over the cluster's blocks
  const int warp =
      static_cast<int>(cluster.block_rank()) * (blockDim.x >> 5) + lwarp;
  const int group_warps = parts * (blockDim.x >> 5);
  const float ox = (float)((tile % grid_x) * tile_x);
  const float oy = (float)((tile / grid_x) * tile_y);
  const int c_first = first_chunk(chunk_meta, n_chunks, tile);
  __nv_bfloat16* o = out + (long long)tile * 3 * n_pix;
  float* carry = scratch + (long long)tile * 4 * n_pix;
  int* ends = reinterpret_cast<int*>(scratch + (long long)gridDim.x / parts *
                                                   4 * n_pix) +
              (long long)blockIdx.x * groups;

  // 1. Each pixel group walks the tile's chunks until all its pixels have
  //    T <= 1e-4 after a chunk (a vote over the cluster). With one group
  //    that is the tile-wide stop. With more, the tile stops after the
  //    latest group's stop, so each group's state is kept and step 2
  //    resumes the groups that stopped earlier.
  int round = 0;
  int c_stop = c_first;  // one past the tile's last chunk
  for (int q = 0; q < (kSplit ? groups : 1); ++q) {
    const Pixels px = pixels_of(q * group_warps + warp, lane, nbx, n_pix,
                                tile_x, tile_y, st.box[lwarp]);
    float T[kPix], cr[kPix], cg_[kPix], cb[kPix];
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      T[j] = 1.0f;
      cr[j] = cg_[j] = cb[j] = 0.0f;
    }
    int c = c_first;
    while (c < n_chunks && (chunk_meta[c] >> 2) == tile) {
      // a chunk in pieces of kMaxChunk slots, in slot order
      for (int off = 0; off < (kSplit ? chunk : 1); off += kMaxChunk) {
        const int len = kSplit ? min(kMaxChunk, chunk - off) : chunk;
        stage_piece(feat, k_slots, (long long)c * chunk + off, len, ox, oy,
                    st.slot);
        __syncthreads();
        composite_piece(st, len, lwarp, lane, nbx, px, T, cr, cg_, cb);
        // orders this piece's reads before the next piece's staging
        if (kSplit && off + kMaxChunk < chunk) __syncthreads();
      }
      ++c;
      int live = 0;
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        live |= (px.valid >> j & 1u) && T[j] > kTEps;
      }
      // barrier + the block's vote; also orders this chunk's shared-memory
      // reads before the next chunk's staging writes
      live = __syncthreads_or(live);
      if (parts > 1) {
        // votes alternate between two words: a block writes round r + 2's
        // word only after round r + 1's barrier, which every block reaches
        // after reading round r's votes
        if (threadIdx.x == 0) st.vote[round & 1] = live;
        cluster.sync();
        int any = 0;
        if (lane < parts) {
          any = *cluster.map_shared_rank(&st.vote[round & 1], lane);
        }
        live = __any_sync(kFull, any);
      }
      ++round;
      if (!live) break;
    }
    c_stop = max(c_stop, c);
    write_pixels(o, bg, n_pix, tile_x, px, T, cr, cg_, cb);
    if (kSplit && groups > 1) {
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        if (!(px.valid >> j & 1u)) continue;
        const int p = pixel_index(px, j, tile_x);
        carry[p] = T[j];
        carry[n_pix + p] = cr[j];
        carry[2 * n_pix + p] = cg_[j];
        carry[3 * n_pix + p] = cb[j];
      }
      if (threadIdx.x == 0) ends[q] = c;
    }
  }

  // 2. Groups that stopped before the tile go on compositing to its stop
  //    (no per-pixel stop rule), from their kept state. The same thread
  //    wrote the state it reads; every block of a cluster saw the same
  //    votes, so they walk the same chunks.
  if (kSplit && groups > 1) {
    __syncthreads();  // ends[] written by thread 0
    for (int q = 0; q < groups; ++q) {
      const int c_end = ends[q];
      if (c_end == c_stop) continue;  // block-uniform
      const Pixels px = pixels_of(q * group_warps + warp, lane, nbx, n_pix,
                                  tile_x, tile_y, st.box[lwarp]);
      float T[kPix], cr[kPix], cg_[kPix], cb[kPix];
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        T[j] = 1.0f;
        cr[j] = cg_[j] = cb[j] = 0.0f;
        if (!(px.valid >> j & 1u)) continue;
        const int p = pixel_index(px, j, tile_x);
        T[j] = carry[p];
        cr[j] = carry[n_pix + p];
        cg_[j] = carry[2 * n_pix + p];
        cb[j] = carry[3 * n_pix + p];
      }
      for (int c = c_end; c < c_stop; ++c) {
        for (int off = 0; off < chunk; off += kMaxChunk) {
          const int len = min(kMaxChunk, chunk - off);
          stage_piece(feat, k_slots, (long long)c * chunk + off, len, ox, oy,
                      st.slot);
          __syncthreads();
          composite_piece(st, len, lwarp, lane, nbx, px, T, cr, cg_, cb);
          __syncthreads();
        }
      }
      write_pixels(o, bg, n_pix, tile_x, px, T, cr, cg_, cb);
    }
  }
  if (parts > 1) cluster.sync();  // no block leaves while its votes are read
}

// Blocks a tile (a power of two: a cluster's blocks) and warps a block for
// a tile geometry; the last block's spare warps hold no pixels.
void launch_shape(const Geometry& geo, int& parts, int& warps) {
  parts = 1;
  while (parts * kBlockWarps < geo.warps) parts *= 2;
  warps = parts == 1 ? geo.warps : kBlockWarps;
}

}  // namespace

// float32 elements of the scratch gsplat_render_forward needs (0: none)
extern "C" long long gsplat_render_scratch_floats(int num_tiles, int n_pix,
                                                  int tile_x, int tile_y) {
  const Geometry geo = tile_geometry(n_pix, tile_x, tile_y, kTileWarps);
  if (geo.groups == 1) return 0;
  int parts, warps;
  launch_shape(geo, parts, warps);
  return (long long)num_tiles * (4LL * n_pix + (long long)parts * geo.groups);
}

// any chunk > 0 and n_pix > 0 (larger tiles run in pixel groups, larger
// chunks in pieces), or cudaErrorInvalidValue; scratch:
// gsplat_render_scratch_floats(num_tiles, n_pix, tile_x, tile_y) floats
extern "C" int gsplat_render_forward(const void* feat, long long k_slots,
                                     const int* chunk_meta, int n_chunks,
                                     const float* bg, void* out,
                                     void* scratch, int num_tiles, int n_pix,
                                     int tile_x, int tile_y, int grid_x,
                                     int chunk, cudaStream_t stream) {
  if (num_tiles == 0) return 0;
  if (chunk <= 0 || n_pix <= 0) return (int)cudaErrorInvalidValue;
  const Geometry geo = tile_geometry(n_pix, tile_x, tile_y, kTileWarps);
  if (geo.groups > 1 && scratch == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  int parts, warps;
  launch_shape(geo, parts, warps);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(num_tiles * parts);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto* kernel = geo.groups > 1 || chunk > kMaxChunk ? render_kernel<true>
                                                     : render_kernel<false>;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(feat), k_slots,
      chunk_meta, n_chunks, bg, static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(scratch), n_pix, tile_x, tile_y, grid_x, geo.nbx,
      geo.groups, chunk);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
