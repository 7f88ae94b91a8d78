// Pieces shared by the tile kernels (render_kernel.cu, blend_kernels.cu):
// the thresholds, the warp pixel geometry, the staged slot record, the
// quadratic form and the exact cull box. A plain CUDA header (no PyTorch
// headers); everything has internal linkage in each file that includes it.
//
// Why the culling is exact. The kernels compute power in the plain
// versions' operation order with __fmul_rn/__fadd_rn (no contraction; the
// -1/2 is folded into a and c at staging, which is exact in binary
// floating point: the two forms agree bit for bit unless an intermediate
// product is subnormal), so kernels and plain versions take the same 1/255
// and 1e-4 branches. A slot with opa < 1/255 never passes (e^power <= 1
// where power <= 0). Otherwise a passing pixel needs q = a dx^2 + 2 b dx dy
// + c dy^2 <= r^2 = 2 ln(255 opa) up to rounding. The float q differs from
// the exact one by at most 5 ulp-units of a dx^2 + c dy^2, so for a
// positive definite conic it is at least dx^2 (ac - b^2 - 10 eps ac) / c;
// hence |dx| <= sqrt(r^2 c / det') and |dy| <= sqrt(r^2 a / det') with
// det' = ac - b^2 - kDetSlack * ac. r^2 and the extents are widened by
// kR2Slack and kExtSlack, far above the error of expf, logf, sqrtf and
// the divisions. The box test uses the kernel's own float dx: a sub-
// block's pixels lie between fl(x0 - x) and fl(x1 - x) (rounding is
// monotone). A conic that is not positive definite (or not finite) is
// never culled. So a culled pair has alpha < 1/255 in the kernel's own
// arithmetic, and computing it would have changed nothing.

#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr int kNumFeat = 9;
constexpr unsigned kFull = 0xffffffffu;

// the geometry: pixels a thread (kPixX columns x kPixY rows of them),
// strided 8 columns and 4 rows apart, so a warp's 8 x 4 lanes cover a
// kBlockX x kBlockY block (16 x 8 at kPix = 4); the thread's j-th pixels
// across the warp form the 8 x 4 sub-block j
constexpr int kPix = 4;
constexpr int kPixY = kPix >= 2 ? 2 : 1;
constexpr int kPixX = kPix / kPixY;
constexpr int kBlockX = 8 * kPixX;
constexpr int kBlockY = 4 * kPixY;
constexpr unsigned kAllPix = (1u << kPix) - 1u;

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

// the staged record of one slot from its nine feature values (the mean
// shifted to tile coordinates, -a/2, -c/2, the cull extents)
__device__ __forceinline__ Slot make_slot(float x, float y, float a, float b,
                                          float c, float opa, float r,
                                          float g, float bl, float ox,
                                          float oy) {
  float hx, hy;
  cull_extent(a, b, c, opa, hx, hy);
  Slot v;
  v.p = make_float4(__fsub_rn(x, ox), __fsub_rn(y, oy), __fmul_rn(-0.5f, a),
                    b);
  v.q = make_float4(__fmul_rn(-0.5f, c), opa, r, g);
  v.r = make_float4(bl, hx, hy, 0.0f);
  return v;
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

// The thread's pixels for warp ``warp`` of the tile: compact kBlockX x
// kBlockY blocks when nbx > 0 (nbx block columns), else kPix * 32
// consecutive pixels a warp (thin tiles). Lane 0 writes the warp's
// sub-block boxes (x0, x1, y0, y1 of the valid pixels; an empty sub-block
// gets an empty box far away).
__device__ __forceinline__ Pixels pixels_of(int warp, int lane, int nbx,
                                            int n_pix, int tile_x, int tile_y,
                                            float4* box) {
  Pixels px;
  px.valid = 0u;
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    int x, y;
    bool ok;
    if (nbx > 0) {
      x = (warp % nbx) * kBlockX + (lane & 7) + 8 * (j % kPixX);
      y = (warp / nbx) * kBlockY + (lane >> 3) + 4 * (j / kPixX);
      ok = x < tile_x && y < tile_y;
    } else {
      const int p = warp * 32 * kPix + lane + 32 * j;
      x = p % tile_x;
      y = p / tile_x;
      ok = p < n_pix;
    }
    px.x[j] = static_cast<float>(x);
    px.y[j] = static_cast<float>(y);
    if (ok) px.valid |= 1u << j;
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

// Warp units of a tile: compact blocks of kBlockX x kBlockY pixels (nbx > 0
// block columns) unless there are more of them than both max_warps and
// the units of kPix * 32 consecutive pixels (thin tiles), which are then
// taken instead (nbx = 0). A tile of more units than max_warps runs its
// warps over ``groups`` groups of units in turn: warp w of group q holds
// unit q * warps + w (units past the tile hold no pixel).
struct Geometry {
  int nbx;
  int warps;
  int groups;
};

inline Geometry tile_geometry(int n_pix, int tile_x, int tile_y,
                              int max_warps) {
  const int nbx = (tile_x + kBlockX - 1) / kBlockX;
  const int nby = (tile_y + kBlockY - 1) / kBlockY;
  const int linear = (n_pix + 32 * kPix - 1) / (32 * kPix);
  const bool compact = (long long)nbx * nby <= (max_warps > linear
                                                     ? max_warps
                                                     : linear);
  const int units = compact ? nbx * nby : linear;
  const int warps = units < max_warps ? units : max_warps;
  return {compact ? nbx : 0, warps, (units + warps - 1) / warps};
}

}  // namespace
