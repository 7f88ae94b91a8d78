// Owner-expansion kernels for binning, written for Hopper (sm_90a).
//
// expand_scan replaces gsplat_tpu/raster/scan_kernel.py::_expand_kernel
// (wrapper expand_scan). It is one pass over the K slots computing three
// associative scans: the latest nonzero mark ("pack"), the running max of
// base_in floored at 0 ("base"), and the 1-based running count of nonzero
// marks ("rank"). The TPU kernel carried its running values across a
// sequential grid in SMEM; blocks on the card run in no order, so the scan
// is two launches: a reduction of each 4096-slot tile to one aggregate,
// then a scan in which every block first folds the aggregates of the tiles
// before it and then scans its own tile. Bound: bytes. Each slot reads two
// int32 and writes three (20 B/slot), and the tile loads and stores are
// warp-contiguous (lane l touches slot base + 32 i + l).
//
// merge_expand replaces scan_kernel.py::_merge_kernel (wrapper
// merge_expand). Slot d's owner is the last g with starts[g] <= d, starts
// ascending. The TPU kernel resolved it with a byte-split one-hot matmul
// over a host-searched window of candidates; here each thread runs an
// upper-bound binary search over starts (P <= a few million ints, which
// stay in the 50 MB L2 after the first blocks touch them). Bound: bytes,
// 12 B written per slot plus starts and pack read once.
//
// multi_cumsum replaces scan_kernel.py::_cumsum_kernel (wrapper
// multi_cumsum): the inclusive float32 cumsum of n equal-length rows, with
// a Neumaier-compensated carry between 4096-element blocks, so each
// element's error stays at within-block scale instead of growing with the
// running total (segment differences of the cumsum expose that error, see
// rasterize._segsum_reduce). The TPU kernel carried (sum, compensation)
// across a sequential grid; here it is the aggregate-then-fold design of
// expand_scan: launch 1 scans every (row, block) and stores the block's
// total; launch 2 has warp 0 of each block fold the compensated sum of the
// totals before it (each lane folds a strided share, the lanes combine in
// a fixed tree), then scans its own block and adds the carry. Bound:
// bytes, 8 B per element (one float read, one written); launch 2 reads the
// input a second time.
//
// multi_cummax replaces scan_kernel.py::_kernel (wrapper multi_cummax): the
// inclusive int32 cummax of n equal-length rows. The TPU kernel carried each
// row's running max across a sequential grid in SMEM; here it is
// multi_cumsum's two launches with max in place of the sum and INT_MIN as
// the identity (the TPU wrapper pads with INT_MIN). Max is exact and
// associative, so the result is bit-equal to a sequential scan whatever
// order the folds take, and no compensation is needed. Bound: bytes, 8 B per
// element; launch 2 reads the input a second time.
//
// Plain C interface: pointers and the stream come from the binding; each
// launcher returns cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>

namespace {

constexpr int kScanThreads = 256;
constexpr int kScanItems = 16;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kScanTile = kScanThreads * kScanItems;  // slots per block
constexpr unsigned kFull = 0xffffffffu;

struct Owner {
  int pack;  // latest nonzero mark
  int base;  // running max of base_in (identity 0: the TPU carry starts at 0)
  int rank;  // running count of nonzero marks
};

__device__ __forceinline__ Owner identity() { return Owner{0, 0, 0}; }

// a precedes b in slot order
__device__ __forceinline__ Owner combine(const Owner& a, const Owner& b) {
  return Owner{b.pack != 0 ? b.pack : a.pack, max(a.base, b.base),
               a.rank + b.rank};
}

__device__ __forceinline__ Owner shfl_up(const Owner& v, int off) {
  return Owner{__shfl_up_sync(kFull, v.pack, off),
               __shfl_up_sync(kFull, v.base, off),
               __shfl_up_sync(kFull, v.rank, off)};
}

__device__ __forceinline__ Owner shfl_idx(const Owner& v, int lane) {
  return Owner{__shfl_sync(kFull, v.pack, lane),
               __shfl_sync(kFull, v.base, lane),
               __shfl_sync(kFull, v.rank, lane)};
}

__device__ __forceinline__ Owner warp_inclusive_scan(Owner v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    Owner u = shfl_up(v, off);
    if (lane >= off) v = combine(u, v);
  }
  return v;
}

__device__ __forceinline__ Owner load_slot(const int* marks,
                                           const int* base_in, long long idx,
                                           long long k) {
  if (idx >= k) return identity();
  int m = marks[idx];
  return Owner{m, base_in[idx], m != 0 ? 1 : 0};
}

// Scans tile `tile` in slot order; returns the tile's total (valid in every
// thread) and leaves each slot's tile-local inclusive value in vals[].
__device__ __forceinline__ Owner scan_tile(const int* marks,
                                           const int* base_in, long long k,
                                           long long tile,
                                           Owner (&vals)[kScanItems],
                                           Owner* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long warp_base =
      tile * kScanTile + (long long)warp * 32 * kScanItems;
  Owner run = identity();
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    Owner x = load_slot(marks, base_in, warp_base + 32 * i + lane, k);
    x = combine(run, warp_inclusive_scan(x, lane));
    vals[i] = x;
    run = shfl_idx(x, 31);
  }
  if (lane == 0) warp_tot[warp] = run;
  __syncthreads();
  Owner total = identity();
  for (int w = 0; w < kScanWarps; ++w) total = combine(total, warp_tot[w]);
  return total;
}

__global__ void __launch_bounds__(kScanThreads)
expand_reduce_kernel(const int* __restrict__ marks,
                     const int* __restrict__ base_in, long long k,
                     Owner* __restrict__ agg) {
  __shared__ Owner warp_tot[kScanWarps];
  Owner vals[kScanItems];
  Owner total = scan_tile(marks, base_in, k, blockIdx.x, vals, warp_tot);
  if (threadIdx.x == 0) agg[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kScanThreads)
expand_scan_kernel(const int* __restrict__ marks,
                   const int* __restrict__ base_in, long long k,
                   const Owner* __restrict__ agg, int* __restrict__ pack_out,
                   int* __restrict__ base_out, int* __restrict__ rank_out) {
  __shared__ Owner warp_tot[kScanWarps];
  __shared__ Owner part[kScanWarps];
  __shared__ int part_last[kScanWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long tile = blockIdx.x;

  // 1. Fold the aggregates of tiles [0, tile). base and rank commute; the
  //    latest nonzero pack is the pack of the highest such tile, so track
  //    that tile's index and reduce by max.
  int rank_sum = 0, base_max = 0, last = -1;
  for (long long j = threadIdx.x; j < tile; j += kScanThreads) {
    Owner a = agg[j];
    rank_sum += a.rank;
    base_max = max(base_max, a.base);
    if (a.pack != 0) last = (int)j;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    rank_sum += __shfl_down_sync(kFull, rank_sum, off);
    base_max = max(base_max, __shfl_down_sync(kFull, base_max, off));
    last = max(last, __shfl_down_sync(kFull, last, off));
  }
  if (lane == 0) {
    part[warp] = Owner{0, base_max, rank_sum};
    part_last[warp] = last;
  }
  __syncthreads();
  Owner carry = identity();
  int carry_last = -1;
  for (int w = 0; w < kScanWarps; ++w) {
    carry.rank += part[w].rank;
    carry.base = max(carry.base, part[w].base);
    carry_last = max(carry_last, part_last[w]);
  }
  if (carry_last >= 0) carry.pack = agg[carry_last].pack;

  // 2. Scan this tile and add the carry.
  Owner vals[kScanItems];
  scan_tile(marks, base_in, k, tile, vals, warp_tot);
  Owner prefix = carry;
  for (int w = 0; w < warp; ++w) prefix = combine(prefix, warp_tot[w]);
  const long long warp_base =
      tile * kScanTile + (long long)warp * 32 * kScanItems;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    long long idx = warp_base + 32 * i + lane;
    if (idx < k) {
      Owner v = combine(prefix, vals[i]);
      pack_out[idx] = v.pack;
      base_out[idx] = v.base;
      rank_out[idx] = v.rank;
    }
  }
}

__global__ void merge_expand_kernel(const int* __restrict__ starts,
                                    const int* __restrict__ pack, int p,
                                    int k, int* __restrict__ pack_out,
                                    int* __restrict__ base_out,
                                    int* __restrict__ rank_out) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= k) return;
  int lo = 0, hi = p;  // upper bound: first g with starts[g] > d
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (starts[mid] <= d) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int g = lo - 1;
  pack_out[d] = g >= 0 ? pack[g] : 0;
  base_out[d] = g >= 0 ? starts[g] : 0;
  rank_out[d] = g + 1;
}

// ---- multi_cumsum

__device__ __forceinline__ float warp_inclusive_sum(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    float u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

// Scans block `blk` of row x (length k); returns the block's total (valid
// in every thread) and leaves each element's block-local inclusive sum,
// less the totals of the warps before its own, in vals[].
__device__ __forceinline__ float scan_block_f32(const float* x, long long k,
                                                long long blk,
                                                float (&vals)[kScanItems],
                                                float* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long warp_base =
      blk * kScanTile + (long long)warp * 32 * kScanItems;
  float run = 0.0f;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const long long idx = warp_base + 32 * i + lane;
    float v = idx < k ? x[idx] : 0.0f;
    v = warp_inclusive_sum(v, lane) + run;
    vals[i] = v;
    run = __shfl_sync(kFull, v, 31);
  }
  if (lane == 0) warp_tot[warp] = run;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < kScanWarps; ++w) total += warp_tot[w];
  return total;
}

// Neumaier sum of (hi, lo) pairs: hi carries the sum, lo the compensation
__device__ __forceinline__ void neumaier_add(float& hi, float& lo, float y) {
  const float t = hi + y;
  lo += fabsf(hi) >= fabsf(y) ? (hi - t) + y : (y - t) + hi;
  hi = t;
}

__global__ void __launch_bounds__(kScanThreads)
cumsum_reduce_kernel(const float* __restrict__ x, long long k,
                     float* __restrict__ totals) {
  __shared__ float warp_tot[kScanWarps];
  const long long row = blockIdx.y;
  float vals[kScanItems];
  const float total =
      scan_block_f32(x + row * k, k, blockIdx.x, vals, warp_tot);
  if (threadIdx.x == 0) totals[row * gridDim.x + blockIdx.x] = total;
}

__global__ void __launch_bounds__(kScanThreads)
cumsum_scan_kernel(const float* __restrict__ x, long long k,
                   const float* __restrict__ totals, float* __restrict__ out) {
  __shared__ float warp_tot[kScanWarps];
  __shared__ float s_carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = blockIdx.y;
  const long long blk = blockIdx.x;

  // 1. Compensated sum of the totals of blocks [0, blk) of this row.
  if (warp == 0) {
    const float* tot = totals + row * gridDim.x;
    float hi = 0.0f, lo = 0.0f;
    for (long long j = lane; j < blk; j += 32) neumaier_add(hi, lo, tot[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o_hi = __shfl_down_sync(kFull, hi, off);
      const float o_lo = __shfl_down_sync(kFull, lo, off);
      neumaier_add(hi, lo, o_hi);
      lo += o_lo;
    }
    if (lane == 0) s_carry = hi + lo;
  }

  // 2. Scan this block and add the warps before, then the carry.
  float vals[kScanItems];
  scan_block_f32(x + row * k, k, blk, vals, warp_tot);
  float prefix = 0.0f;
  for (int w = 0; w < warp; ++w) prefix += warp_tot[w];
  const float carry = s_carry;  // written before scan_block_f32's barrier
  const long long warp_base =
      blk * kScanTile + (long long)warp * 32 * kScanItems;
  float* o = out + row * k;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const long long idx = warp_base + 32 * i + lane;
    if (idx < k) o[idx] = (prefix + vals[i]) + carry;
  }
}

// ---- multi_cummax

constexpr int kIntMin = -2147483647 - 1;  // identity of max

__device__ __forceinline__ int warp_inclusive_max(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v = max(v, u);
  }
  return v;
}

// Scans block `blk` of row x (length k); returns the block's max (valid in
// every thread) and leaves each element's warp-local inclusive max (over
// the warp's 32 * kScanItems elements) in vals[].
__device__ __forceinline__ int scan_block_max(const int* x, long long k,
                                              long long blk,
                                              int (&vals)[kScanItems],
                                              int* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long warp_base =
      blk * kScanTile + (long long)warp * 32 * kScanItems;
  int run = kIntMin;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const long long idx = warp_base + 32 * i + lane;
    int v = idx < k ? x[idx] : kIntMin;
    v = max(warp_inclusive_max(v, lane), run);
    vals[i] = v;
    run = __shfl_sync(kFull, v, 31);
  }
  if (lane == 0) warp_tot[warp] = run;
  __syncthreads();
  int total = kIntMin;
  for (int w = 0; w < kScanWarps; ++w) total = max(total, warp_tot[w]);
  return total;
}

__global__ void __launch_bounds__(kScanThreads)
cummax_reduce_kernel(const int* __restrict__ x, long long k,
                     int* __restrict__ totals) {
  __shared__ int warp_tot[kScanWarps];
  const long long row = blockIdx.y;
  int vals[kScanItems];
  const int total = scan_block_max(x + row * k, k, blockIdx.x, vals, warp_tot);
  if (threadIdx.x == 0) totals[row * gridDim.x + blockIdx.x] = total;
}

__global__ void __launch_bounds__(kScanThreads)
cummax_scan_kernel(const int* __restrict__ x, long long k,
                   const int* __restrict__ totals, int* __restrict__ out) {
  __shared__ int warp_tot[kScanWarps];
  __shared__ int s_carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = blockIdx.y;
  const long long blk = blockIdx.x;

  // 1. Max of the block maxima of blocks [0, blk) of this row.
  if (warp == 0) {
    const int* tot = totals + row * gridDim.x;
    int m = kIntMin;
    for (long long j = lane; j < blk; j += 32) m = max(m, tot[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = max(m, __shfl_down_sync(kFull, m, off));
    if (lane == 0) s_carry = m;
  }

  // 2. Scan this block; fold in the warps before, then the carry.
  int vals[kScanItems];
  scan_block_max(x + row * k, k, blk, vals, warp_tot);
  int prefix = s_carry;  // written before scan_block_max's barrier
  for (int w = 0; w < warp; ++w) prefix = max(prefix, warp_tot[w]);
  const long long warp_base =
      blk * kScanTile + (long long)warp * 32 * kScanItems;
  int* o = out + row * k;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const long long idx = warp_base + 32 * i + lane;
    if (idx < k) o[idx] = max(prefix, vals[i]);
  }
}

}  // namespace

extern "C" int gsplat_cumsum_blocks(long long k) {
  return (int)((k + kScanTile - 1) / kScanTile);
}

// x, out: [n, k] row-major; totals: scratch of n * gsplat_cumsum_blocks(k)
extern "C" int gsplat_multi_cumsum(const float* x, int n, long long k,
                                   float* totals, float* out,
                                   cudaStream_t stream) {
  const int blocks = gsplat_cumsum_blocks(k);
  if (blocks == 0 || n == 0) return 0;
  if (n > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks, n);
  cumsum_reduce_kernel<<<grid, kScanThreads, 0, stream>>>(x, k, totals);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cumsum_scan_kernel<<<grid, kScanThreads, 0, stream>>>(x, k, totals, out);
  return (int)cudaGetLastError();
}

// x, out: [n, k] row-major int32; totals: scratch of
// n * gsplat_cumsum_blocks(k) int32 (the same 4096-element blocks)
extern "C" int gsplat_multi_cummax(const int* x, int n, long long k,
                                   int* totals, int* out,
                                   cudaStream_t stream) {
  const int blocks = gsplat_cumsum_blocks(k);
  if (blocks == 0 || n == 0) return 0;
  if (n > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks, n);
  cummax_reduce_kernel<<<grid, kScanThreads, 0, stream>>>(x, k, totals);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cummax_scan_kernel<<<grid, kScanThreads, 0, stream>>>(x, k, totals, out);
  return (int)cudaGetLastError();
}

extern "C" int gsplat_expand_scan_tiles(long long k) {
  return (int)((k + kScanTile - 1) / kScanTile);
}

// agg: scratch of gsplat_expand_scan_tiles(k) * 3 int32
extern "C" int gsplat_expand_scan(const int* marks, const int* base_in,
                                  long long k, int* agg, int* pack_out,
                                  int* base_out, int* rank_out,
                                  cudaStream_t stream) {
  const int tiles = gsplat_expand_scan_tiles(k);
  if (tiles == 0) return 0;
  Owner* agg_o = reinterpret_cast<Owner*>(agg);
  expand_reduce_kernel<<<tiles, kScanThreads, 0, stream>>>(marks, base_in, k,
                                                          agg_o);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  expand_scan_kernel<<<tiles, kScanThreads, 0, stream>>>(
      marks, base_in, k, agg_o, pack_out, base_out, rank_out);
  return (int)cudaGetLastError();
}

extern "C" int gsplat_merge_expand(const int* starts, const int* pack, int p,
                                   int k, int* pack_out, int* base_out,
                                   int* rank_out, cudaStream_t stream) {
  if (k == 0) return 0;
  const int threads = 256;
  merge_expand_kernel<<<(k + threads - 1) / threads, threads, 0, stream>>>(
      starts, pack, p, k, pack_out, base_out, rank_out);
  return (int)cudaGetLastError();
}
