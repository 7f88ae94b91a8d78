// Owner-expansion kernels for binning, written for Hopper (sm_90a).
//
// expand_scan replaces gsplat_tpu/raster/scan_kernel.py::_expand_kernel
// (wrapper expand_scan). It is one pass over the K slots computing three
// associative scans: the latest nonzero mark ("pack"), the running max of
// base_in floored at 0 ("base"), and the 1-based running count of nonzero
// marks ("rank"). Bound: bytes, 20 B a slot (two int32 read, three
// written). The TPU kernel carried its running values across a sequential
// grid in SMEM; blocks on the card run in no order, so the carry between
// 4096-slot tiles goes through a single-pass chained scan with decoupled
// look-back (Merrill & Garland), one launch that reads each slot once:
//
// - A block takes its tile from an atomic ticket counter, so a tile's
//   predecessors were all taken by blocks that are already running, and
//   its look-back cannot wait on a block that is not resident. The block
//   that takes the last ticket puts the counter back to 0 for the next
//   call (every other ticket has been handed out by then).
// - It loads the tile once with 16-byte loads (lane l of a warp holds four
//   consecutive slots of each 128-slot row of the warp's 512 slots), scans
//   its four slots in registers, then the row across the warp by shuffles,
//   then the warps' totals in shared memory.
// - Thread 0 publishes the tile's aggregate, warp 0 looks back over the
//   32 tiles before it at a time (status words read with ld.acquire.gpu;
//   the nearest inclusive prefix, combined in slot order with the
//   aggregates after it) and publishes the tile's inclusive prefix. Each
//   value is stored before its status word with st.release.gpu, so a
//   reader that sees the status sees the value; values are read through
//   L2 (__ldcg).
// - Status words carry the call's epoch beside the flag, so words left by
//   an earlier call read as "not yet published" and nothing has to be
//   cleared between calls: the wrapper keeps one zero-initialised state
//   buffer per device and stream and counts the epochs.
// - Every thread writes its slots' three outputs once, with 16-byte stores.
//
// Tiles past K's end and buffers that are not 16-byte aligned take scalar
// loads and stores for the affected rows.

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
// across a sequential grid; here it is two launches: launch 1 scans every
// (row, block) and stores the block's total; launch 2 has warp 0 of each
// block fold the compensated sum of the totals before it (each lane folds
// a strided share, the lanes combine in a fixed tree), then scans its own
// block and adds the carry. Bound: bytes, 8 B per element (one float read,
// one written); launch 2 reads the input a second time.
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

// ---- expand_scan

constexpr int kFlagAggregate = 1;
constexpr int kFlagPrefix = 2;
constexpr int kRowSlots = 32 * 4;  // one 16-byte load a lane
constexpr int kRows = kScanItems / 4;

// a tile's published state: 32 bytes, status word first
struct TileState {
  unsigned long long status;  // epoch << 2 | flag
  int agg[3];                 // the tile's own aggregate
  int incl[3];                // its inclusive prefix
};
static_assert(sizeof(TileState) == 32, "gsplat_expand_scan_state_words");

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// a value, then its status word (release: the value is seen first)
__device__ __forceinline__ void publish(TileState* s, int* dst,
                                        const Owner& v,
                                        unsigned long long status) {
  __stcg(dst, v.pack);
  __stcg(dst + 1, v.base);
  __stcg(dst + 2, v.rank);
  store_release(&s->status, status);
}

__device__ __forceinline__ Owner shfl_down(const Owner& v, int off) {
  return Owner{__shfl_down_sync(kFull, v.pack, off),
               __shfl_down_sync(kFull, v.base, off),
               __shfl_down_sync(kFull, v.rank, off)};
}

// The exclusive prefix of tile ``tile`` > 0, by warp 0: lane l reads tile
// tile - 32 + l of each window (tiles before 0 count as the identity with
// a prefix), waits until it is published in this epoch, and the window's
// values from its last prefix on are combined in slot order.
__device__ Owner look_back(const TileState* state, long long tile,
                           unsigned long long epoch, int lane) {
  Owner run = identity();  // the tiles after the current window
  for (long long pred = tile - 32 + lane;; pred -= 32) {
    int flag = kFlagPrefix;
    Owner v = identity();
    if (pred >= 0) {
      const TileState* s = state + pred;
      unsigned long long st;
      do {
        st = load_acquire(&s->status);
      } while ((st >> 2) != epoch);
      flag = static_cast<int>(st & 3u);
      const int* src = flag == kFlagPrefix ? s->incl : s->agg;
      v = Owner{__ldcg(src), __ldcg(src + 1), __ldcg(src + 2)};
    }
    const unsigned prefixes = __ballot_sync(kFull, flag == kFlagPrefix);
    const int start = prefixes ? 31 - __clz(prefixes) : 0;
    Owner x = lane >= start ? v : identity();
    // ordered reduction: lane l ends with lanes [l, l + 2 off) combined
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const Owner y = shfl_down(x, off);
      if (lane + off < 32) x = combine(x, y);
    }
    run = combine(shfl_idx(x, 0), run);
    if (prefixes) return run;
  }
}

// four slots from idx: one 16-byte load where they all exist and the
// buffer is aligned, else scalar loads (0 past the end)
__device__ __forceinline__ int4 load4(const int* __restrict__ p,
                                      long long idx, long long k, bool vec) {
  if (vec && idx + 3 < k) return __ldg(reinterpret_cast<const int4*>(p + idx));
  int4 v = make_int4(0, 0, 0, 0);
  if (idx < k) v.x = p[idx];
  if (idx + 1 < k) v.y = p[idx + 1];
  if (idx + 2 < k) v.z = p[idx + 2];
  if (idx + 3 < k) v.w = p[idx + 3];
  return v;
}

__device__ __forceinline__ void store4(int* __restrict__ p, long long idx,
                                       long long k, bool vec, int4 v) {
  if (vec && idx + 3 < k) {
    *reinterpret_cast<int4*>(p + idx) = v;
    return;
  }
  if (idx < k) p[idx] = v.x;
  if (idx + 1 < k) p[idx + 1] = v.y;
  if (idx + 2 < k) p[idx + 2] = v.z;
  if (idx + 3 < k) p[idx + 3] = v.w;
}

__device__ __forceinline__ Owner slot_of(int mark, int base) {
  return Owner{mark, base, mark != 0 ? 1 : 0};
}

__global__ void __launch_bounds__(kScanThreads)
expand_scan_kernel(const int* __restrict__ marks,
                   const int* __restrict__ base_in, long long k,
                   unsigned long long* __restrict__ ticket,
                   TileState* __restrict__ state, int tiles,
                   unsigned long long epoch, bool vec,
                   int* __restrict__ pack_out, int* __restrict__ base_out,
                   int* __restrict__ rank_out) {
  __shared__ long long s_tile;
  __shared__ Owner s_warp[kScanWarps];
  __shared__ Owner s_carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    const unsigned long long t = atomicAdd(ticket, 1ull);
    if (t == static_cast<unsigned long long>(tiles - 1)) {
      atomicExch(ticket, 0ull);
    }
    s_tile = static_cast<long long>(t);
  }
  __syncthreads();
  const long long tile = s_tile;
  const long long warp_base =
      tile * kScanTile + (long long)warp * 32 * kScanItems;

  // 1. Load and scan: row i of the warp is slots warp_base + 128 i ...;
  //    lane l holds its four slots 4 l .. 4 l + 3, inclusive in vals[].
  Owner vals[kScanItems];
  Owner run = identity();
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long long idx = warp_base + (long long)i * kRowSlots + 4 * lane;
    const int4 m = load4(marks, idx, k, vec);
    const int4 b = load4(base_in, idx, k, vec);
    Owner x[4] = {slot_of(m.x, b.x), slot_of(m.y, b.y), slot_of(m.z, b.z),
                  slot_of(m.w, b.w)};
#pragma unroll
    for (int q = 1; q < 4; ++q) x[q] = combine(x[q - 1], x[q]);
    const Owner incl = warp_inclusive_scan(x[3], lane);
    Owner excl = shfl_up(incl, 1);
    excl = combine(run, lane == 0 ? identity() : excl);
#pragma unroll
    for (int q = 0; q < 4; ++q) vals[4 * i + q] = combine(excl, x[q]);
    run = combine(run, shfl_idx(incl, 31));
  }
  if (lane == 0) s_warp[warp] = run;
  __syncthreads();

  // 2. The tile's carry: publish, look back, publish the prefix.
  if (warp == 0) {
    Owner total = identity();
    for (int w = 0; w < kScanWarps; ++w) total = combine(total, s_warp[w]);
    TileState* s = state + tile;
    Owner carry = identity();
    if (tile == 0) {
      if (lane == 0) publish(s, s->incl, total, epoch << 2 | kFlagPrefix);
    } else {
      if (lane == 0) publish(s, s->agg, total, epoch << 2 | kFlagAggregate);
      carry = look_back(state, tile, epoch, lane);
      if (lane == 0) {
        publish(s, s->incl, combine(carry, total),
                epoch << 2 | kFlagPrefix);
      }
    }
    if (lane == 0) s_carry = carry;
  }
  __syncthreads();

  // 3. Write: the carry, the warps before this one, the slot's own value.
  Owner prefix = s_carry;
  for (int w = 0; w < warp; ++w) prefix = combine(prefix, s_warp[w]);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long long idx = warp_base + (long long)i * kRowSlots + 4 * lane;
    Owner v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = combine(prefix, vals[4 * i + q]);
    store4(pack_out, idx, k, vec,
           make_int4(v[0].pack, v[1].pack, v[2].pack, v[3].pack));
    store4(base_out, idx, k, vec,
           make_int4(v[0].base, v[1].base, v[2].base, v[3].base));
    store4(rank_out, idx, k, vec,
           make_int4(v[0].rank, v[1].rank, v[2].rank, v[3].rank));
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

// int64 words of the state buffer expand_scan takes: the ticket counter
// (padded to 32 bytes), then one TileState a tile. The caller zero-fills it
// once and passes a larger epoch on every later call that uses it.
extern "C" long long gsplat_expand_scan_state_words(long long k) {
  const long long tiles = (k + kScanTile - 1) / kScanTile;
  return 4 * (tiles + 1);
}

// state: gsplat_expand_scan_state_words(k) int64, epoch >= 1 and larger
// than on every earlier call with this buffer; calls sharing a buffer must
// not overlap (one stream)
extern "C" int gsplat_expand_scan(const int* marks, const int* base_in,
                                  long long k, void* state,
                                  unsigned long long epoch, int* pack_out,
                                  int* base_out, int* rank_out,
                                  cudaStream_t stream) {
  const long long tiles = (k + kScanTile - 1) / kScanTile;
  if (tiles == 0) return 0;
  if (tiles > 0x7fffffffLL || epoch == 0 || epoch >= (1ull << 62)) {
    return (int)cudaErrorInvalidValue;
  }
  auto aligned = [](const void* p) {
    return (reinterpret_cast<unsigned long long>(p) & 15u) == 0;
  };
  const bool vec = aligned(marks) && aligned(base_in) && aligned(pack_out) &&
                   aligned(base_out) && aligned(rank_out);
  auto* ticket = static_cast<unsigned long long*>(state);
  auto* tile_state = reinterpret_cast<TileState*>(ticket + 4);
  expand_scan_kernel<<<(unsigned)tiles, kScanThreads, 0, stream>>>(
      marks, base_in, k, ticket, tile_state, (int)tiles, epoch, vec,
      pack_out, base_out, rank_out);
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
