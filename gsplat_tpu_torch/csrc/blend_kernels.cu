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
//   Tiles whose blocks would need more than kMaxWarps warps (very thin
//   tiles) take kPix * 32 consecutive pixels a warp instead. Pixels past
//   the tile are done from the start. T, the done latch and the running
//   sums stay in registers.
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
// Why the culling is exact. The kernels compute power in the plain
// version's operation order with __fmul_rn/__fadd_rn (no contraction; the
// -1/2 is folded into a and c at staging, which is exact in binary
// floating point), so kernels and plain versions take the same 1/255 and
// 1e-4 branches. A slot with opa < 1/255 never passes (e^power <= 1 where
// power <= 0). Otherwise a passing pixel needs q = a dx^2 + 2 b dx dy +
// c dy^2 <= r^2 = 2 ln(255 opa) up to rounding. The float q differs from
// the exact one by at most 5 ulp-units of a dx^2 + c dy^2, so for a
// positive definite conic it is at least dx^2 (ac - b^2 - 10 eps ac) / c;
// hence |dx| <= sqrt(r^2 c / det') and |dy| <= sqrt(r^2 a / det') with
// det' = ac - b^2 - kDetSlack * ac. r^2 and the extents are widened by
// kR2Slack and kExtSlack, far above the error of expf, logf, sqrtf and
// the divisions. The box test uses the kernel's own float dx: a sub-
// block's pixels lie between fl(x0 - x) and fl(x1 - x) (rounding is
// monotone). A conic that is not positive definite (or not finite) is
// never culled. So a culled pair has alpha < 1/255 and would change
// nothing: not C, T, the done latch, used or dfeat.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr int kNumFeat = 9;
constexpr int kMaxChunk = 128;
constexpr int kMaskWords = kMaxChunk / 32;
constexpr int kMaxPixels = 1024;
constexpr unsigned kFull = 0xffffffffu;

// the geometry: pixels a thread (kPixX columns x kPixY rows of them)
constexpr int kPix = 4;
constexpr int kPixY = kPix >= 2 ? 2 : 1;
constexpr int kPixX = kPix / kPixY;
constexpr int kBlockX = 8 * kPixX;
constexpr int kBlockY = 4 * kPixY;
constexpr int kMaxWarps = kMaxPixels / (32 * kPix);
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr unsigned kAllDone = (1u << kPix) - 1u;

// cull margins (see the note above)
constexpr float kDetSlack = 1e-5f;
constexpr float kR2Slack = 1e-5f;
constexpr float kExtSlack = 1e-4f;

// one staged slot: three 16-byte words
struct __align__(16) Slot {
  float4 p;  // x - ox, y - oy, -a/2, b
  float4 q;  // -c/2, opa, r, g
  float4 r;  // b, cull half-width hx, half-height hy (-1: never passes), 0
};

// Shared memory both kernels use: the staged chunk, each warp's sub-block
// boxes (x0, x1, y0, y1 of its valid pixels) and, per slot, the bits of the
// sub-blocks its cull box meets.
struct Staging {
  Slot slot[kMaxChunk];
  float4 box[kMaxWarps][kPix];
  unsigned char sub[kMaxWarps][kMaxChunk];
};

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

// half extents of the box outside which opa * e^power < 1/255 for every
// float dx, dy; -1 when no pixel can pass, +inf when the box is unknown
__device__ __forceinline__ void cull_extent(float a, float b, float c,
                                            float opa, float& hx, float& hy) {
  hx = hy = __int_as_float(0x7f800000);
  if (opa < kAlphaMin) {
    hx = hy = -1.0f;
    return;
  }
  const float ac = a * c;
  const float det = ac - b * b - kDetSlack * ac;
  if (a > 0.0f && c > 0.0f && det > 0.0f) {
    const float r2 =
        fmaxf(2.0f * logf(255.0f * opa), 0.0f) * (1.0f + kR2Slack) + kR2Slack;
    hx = sqrtf(r2 * c / det) * (1.0f + kExtSlack);
    hy = sqrtf(r2 * a / det) * (1.0f + kExtSlack);
  }
}

// stage one chunk as records (mean to tile coordinates, -a/2, -c/2, the
// cull extents); thread g reads slot g's nine feature rows
__device__ __forceinline__ void stage_chunk(const float* __restrict__ feat,
                                            long long k_slots, long long base,
                                            int chunk, float ox, float oy,
                                            Slot* __restrict__ s) {
  for (int g = threadIdx.x; g < chunk; g += blockDim.x) {
    const float* f = feat + base + g;
    const float a = f[2 * k_slots], b = f[3 * k_slots], c = f[4 * k_slots];
    const float opa = f[5 * k_slots];
    float hx, hy;
    cull_extent(a, b, c, opa, hx, hy);
    Slot v;
    v.p = make_float4(__fsub_rn(f[0], ox), __fsub_rn(f[k_slots], oy),
                      __fmul_rn(-0.5f, a), b);
    v.q = make_float4(__fmul_rn(-0.5f, c), opa, f[6 * k_slots],
                      f[7 * k_slots]);
    v.r = make_float4(f[8 * k_slots], hx, hy, 0.0f);
    s[g] = v;
  }
}

// power in the plain version's operation order and rounding, with
// ha = -a/2 and hc = -c/2: -(a dx dx + c dy dy)/2 - b dx dy
__device__ __forceinline__ float power_of(float dx, float dy, float ha,
                                          float b, float hc) {
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ha, dx), dx),
                               __fmul_rn(__fmul_rn(hc, dy), dy));
  return __fsub_rn(quad, __fmul_rn(__fmul_rn(b, dx), dy));
}

// A thread's pixels: tile-local coordinates and the valid ones as bits.
struct Pixels {
  float x[kPix], y[kPix];
  unsigned valid;
};

// the thread's pixels; lane 0 writes the warp's sub-block boxes (sub-block
// j: the j-th pixels of the warp's 32 lanes)
__device__ __forceinline__ Pixels pixels_of(int warp, int lane, int nbx,
                                            int n_pix, int tile_x, int tile_y,
                                            float4* box) {
  Pixels px;
  px.valid = 0u;
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    int x, y;
    bool ok;
    if (nbx > 0) {  // compact kBlockX x kBlockY blocks
      x = (warp % nbx) * kBlockX + (lane & 7) + 8 * (j % kPixX);
      y = (warp / nbx) * kBlockY + (lane >> 3) + 4 * (j / kPixX);
      ok = x < tile_x && y < tile_y;
    } else {  // thin tiles: consecutive pixels
      const int p = warp * 32 * kPix + lane + 32 * j;
      x = p % tile_x;
      y = p / tile_x;
      ok = p < n_pix;
    }
    px.x[j] = static_cast<float>(x);
    px.y[j] = static_cast<float>(y);
    if (ok) px.valid |= 1u << j;
    // a sub-block without valid pixels gets an empty box far away
    const int x0 = __reduce_min_sync(kFull, ok ? x : INT_MAX);
    const int x1 = __reduce_max_sync(kFull, ok ? x : INT_MIN);
    const int y0 = __reduce_min_sync(kFull, ok ? y : INT_MAX);
    const int y1 = __reduce_max_sync(kFull, ok ? y : INT_MIN);
    if (lane == 0) {
      box[j] = make_float4(static_cast<float>(x0), static_cast<float>(x1),
                           static_cast<float>(y0), static_cast<float>(y1));
    }
  }
  return px;
}

__device__ __forceinline__ int pixel_index(const Pixels& px, int j,
                                           int tile_x) {
  return static_cast<int>(px.y[j]) * tile_x + static_cast<int>(px.x[j]);
}

// may a pixel of ``box`` (x0, x1, y0, y1) pass for slot s? False only when
// none can; NaN extents keep the slot.
__device__ __forceinline__ bool meets(const Slot& s, float4 box) {
  const float hx = s.r.y, hy = s.r.z;
  return !(hx < 0.0f || __fsub_rn(box.x, s.p.x) > hx ||
           __fsub_rn(box.y, s.p.x) < -hx || __fsub_rn(box.z, s.p.y) > hy ||
           __fsub_rn(box.w, s.p.y) < -hy);
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

__global__ void __launch_bounds__(kMaxThreads)
blend_forward_kernel(const float* __restrict__ feat, long long k_slots,
                     const int* __restrict__ chunk_meta, int n_chunks,
                     float* __restrict__ ct, int* __restrict__ used,
                     int n_pix, int tile_x, int tile_y, int grid_x, int nbx,
                     int chunk) {
  __shared__ Staging st;
  __shared__ int s_hits[kMaxWarps][kMaxChunk];
  __shared__ unsigned s_mask[kMaxWarps][kMaskWords];
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const float ox = (float)((tile % grid_x) * tile_x);
  const float oy = (float)((tile / grid_x) * tile_y);
  const Pixels px =
      pixels_of(warp, lane, nbx, n_pix, tile_x, tile_y, st.box[warp]);
  unsigned char* sub = st.sub[warp];

  float T[kPix], cr[kPix], cg[kPix], cb[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    T[j] = 1.0f;
    cr[j] = cg[j] = cb[j] = 0.0f;
  }
  unsigned done = ~px.valid & kAllDone;  // pixels past the tile take no part
  for (int c = first_chunk(chunk_meta, n_chunks, tile);
       c < n_chunks && (chunk_meta[c] >> 2) == tile; ++c) {
    const long long base = (long long)c * chunk;
    stage_chunk(feat, k_slots, base, chunk, ox, oy, st.slot);
    __syncthreads();

    unsigned todo[kMaskWords], hit_bits[kMaskWords];
    const bool warp_done = __all_sync(kFull, done == kAllDone);
    cull_mask(st, warp_done ? 0 : chunk, warp, lane, sub, todo);
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
        if (__all_sync(kFull, done == kAllDone)) {
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
    for (int g = threadIdx.x; g < chunk; g += blockDim.x) {
      int n = 0;
      for (int w = 0; w < n_warps; ++w) {
        if (s_mask[w][g >> 5] >> (g & 31) & 1u) n += s_hits[w][g];
      }
      used[base + g] = n;
    }
    // barrier + tile-wide decision; also orders this chunk's shared-memory
    // reads before the next chunk's writes
    if (!__syncthreads_or(done != kAllDone)) break;
  }

  float* o = ct + (long long)tile * 4 * n_pix;
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

__global__ void __launch_bounds__(kMaxThreads)
blend_backward_kernel(const float* __restrict__ feat, long long k_slots,
                      const int* __restrict__ chunk_meta, int n_chunks,
                      const float* __restrict__ dpack,
                      float* __restrict__ dfeat, int n_pix, int tile_x,
                      int tile_y, int grid_x, int nbx, int chunk) {
  __shared__ Staging st;
  __shared__ unsigned s_mask[kMaxWarps][kMaskWords];
  extern __shared__ float s_part[];  // [n_warps][chunk][kNumFeat]
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const float ox = (float)((tile % grid_x) * tile_x);
  const float oy = (float)((tile / grid_x) * tile_y);
  const Pixels px =
      pixels_of(warp, lane, nbx, n_pix, tile_x, tile_y, st.box[warp]);
  unsigned char* sub = st.sub[warp];
  const int out_k = sum9_index(lane);

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
  unsigned done = ~px.valid & kAllDone;
  for (int c = first_chunk(chunk_meta, n_chunks, tile);
       c < n_chunks && (chunk_meta[c] >> 2) == tile; ++c) {
    const long long base = (long long)c * chunk;
    stage_chunk(feat, k_slots, base, chunk, ox, oy, st.slot);
    __syncthreads();

    unsigned todo[kMaskWords], live_bits[kMaskWords];
    const bool warp_done = __all_sync(kFull, done == kAllDone);
    cull_mask(st, warp_done ? 0 : chunk, warp, lane, sub, todo);
    bool walking = !warp_done;
    float* part = s_part + (long long)warp * chunk * kNumFeat;
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
          const float a_pg = dcr[j] * s.q.z + dcg[j] * s.q.w + dcb[j] * s.r.x;
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
        if (__all_sync(kFull, done == kAllDone)) {
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
    for (int i = threadIdx.x; i < kNumFeat * chunk; i += blockDim.x) {
      const int row = i / chunk;
      const int col = i - row * chunk;
      float sum = 0.0f;
      for (int w = 0; w < n_warps; ++w) {
        if (s_mask[w][col >> 5] >> (col & 31) & 1u) {
          sum += s_part[((long long)w * chunk + col) * kNumFeat + row];
        }
      }
      dfeat[row * k_slots + base + col] = sum;
    }
    if (!__syncthreads_or(done != kAllDone)) break;
  }
}

// blocks of kBlockX x kBlockY pixels when they need at most kMaxWarps
// warps (nbx > 0 block columns), else consecutive pixels (nbx = 0)
struct Geometry {
  int nbx;
  int warps;
};

Geometry geometry(int n_pix, int tile_x, int tile_y) {
  const int nbx = (tile_x + kBlockX - 1) / kBlockX;
  const int nby = (tile_y + kBlockY - 1) / kBlockY;
  if (nbx * nby <= kMaxWarps) return {nbx, nbx * nby};
  return {0, (n_pix + 32 * kPix - 1) / (32 * kPix)};
}

bool bad_args(int n_pix, int chunk) {
  return chunk > kMaxChunk || chunk <= 0 || n_pix > kMaxPixels || n_pix <= 0;
}

}  // namespace

// chunk <= 128 and n_pix <= 1024, or cudaErrorInvalidValue
extern "C" int gsplat_blend_forward(const float* feat, long long k_slots,
                                    const int* chunk_meta, int n_chunks,
                                    float* ct, int* used, int num_tiles,
                                    int n_pix, int tile_x, int tile_y,
                                    int grid_x, int chunk,
                                    cudaStream_t stream) {
  if (num_tiles == 0) return 0;
  if (bad_args(n_pix, chunk)) return (int)cudaErrorInvalidValue;
  const Geometry geo = geometry(n_pix, tile_x, tile_y);
  blend_forward_kernel<<<num_tiles, 32 * geo.warps, 0, stream>>>(
      feat, k_slots, chunk_meta, n_chunks, ct, used, n_pix, tile_x, tile_y,
      grid_x, geo.nbx, chunk);
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
  const Geometry geo = geometry(n_pix, tile_x, tile_y);
  const int smem = geo.warps * chunk * kNumFeat * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      blend_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  blend_backward_kernel<<<num_tiles, 32 * geo.warps, smem, stream>>>(
      feat, k_slots, chunk_meta, n_chunks, dpack, dfeat, n_pix, tile_x,
      tile_y, grid_x, geo.nbx, chunk);
  return (int)cudaGetLastError();
}
