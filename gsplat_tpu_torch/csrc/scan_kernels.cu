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
//   cleared between calls. The epoch lives in the state buffer's header,
//   in the ticket's word (take_ticket): a block's ticket comes with it,
//   and the block that takes the last ticket advances it. So a launch
//   needs nothing from the host but a buffer zero-filled once, and every
//   replay of a captured CUDA graph runs under an epoch of its own. The
//   epoch starts again at 1 after 2^32 - 1 calls; a status word left by a
//   call that long ago, and by no call of as many tiles since, would read
//   as published.
// - Every thread writes its slots' three outputs once, with 16-byte stores.
//
// Tiles past K's end and buffers that are not 16-byte aligned take scalar
// loads and stores for the affected rows.

// merge_expand replaces scan_kernel.py::_merge_kernel (wrapper
// merge_expand). Slot d's owner is the last g with starts[g] <= d, starts
// ascending (runs of equal starts, the empty ranges, allowed anywhere).
// The TPU kernel resolved it with a byte-split one-hot matmul over a
// host-searched window of candidates. Bound: bytes, 8 B a start (starts
// and pack read once) and 12 B a slot written, 8P + 12K. A binary search
// a slot would read ~20 scattered starts a slot; here it is ModernGPU's
// load-balancing search, a merge of the P starts with the K slot indices
// (start g goes before slot d iff starts[g] <= d), one launch:
//
// - Block b takes items [b T, (b + 1) T) of the merged sequence (T = 1024)
//   and finds its two ends on the merge path: the count of starts among
//   the first i items is #{g : g + min(starts[g], K) < i}, a strictly
//   increasing key, searched by one warp each, 32 probes a step (4-5
//   dependent reads at P = 100k-1M instead of ~20). Each block's work
//   is its share of P + K whatever the runs of empty ranges: a run of 900k
//   equal starts is merely ~880 blocks of starts and no slots. At P = 100k
//   the kernel is one wave of such latency chains, so the tile is small
//   (T = 2048 is 14% slower there and 11% faster at P = 1M on an H100,
//   scripts/torch_blend_variants.py's merge_items8 ablation).
// - It loads its window of starts and packs once, coalesced, into shared
//   memory, with the start and pack just before the window (the owner of
//   the window's first slots).
// - Each thread merges 4 items serially from its own split, found by a
//   binary search in shared memory; a slot records its owner's index in
//   the window (a start is taken before a slot it equals).
// - The block writes the three outputs of its slots coalesced, with
//   16-byte stores where a group of four slots is whole and aligned.
//
// multi_cumsum replaces scan_kernel.py::_cumsum_kernel (wrapper
// multi_cumsum): the inclusive float32 cumsum of n equal-length rows, with
// a Neumaier-compensated carry between 16384-element tiles, so each
// element's error stays at within-tile scale instead of growing with the
// running total (segment differences of the cumsum expose that error, see
// rasterize._segsum_reduce). The TPU kernel carried (sum, compensation)
// across a sequential grid. Bound: bytes, 8 B an element (one float read,
// one written). A reduce launch and a scan launch would read the input
// twice; here it is expand_scan's single-pass chained scan, one launch,
// each element read once with 16-byte loads, in tiles of 512 threads x
// 32 elements (the look-back's fixed cost a tile is spread over 64 KB;
// 4,096-element tiles made the single pass slower than two launches on
// an H100, the cumsum_tile4096 ablation):
//
// - Tiles (row-major over the rows) come from the same self-resetting
//   ticket counter, with the epoch beside it; a tile's look-back stays
//   inside its row.
// - A tile publishes its float total A_b, then its inclusive prefix as a
//   Neumaier pair P_b = fold(P_{b-1}, A_b) (P_{-1} = (0, 0)), each value
//   stored before its epoch-tagged status word (release / acquire).
// - Determinism: the look-back finds the nearest published prefix P_j
//   and folds it forward through A_{j+1} ... A_{b-1}, in tile order on
//   one lane (all lanes compute the same). By induction that is P_{b-1}
//   bit for bit whichever j the walk stopped at, so the result does not
//   depend on timing; a tree of aggregates, or a pair collapsed early,
//   would. The pair collapses (hi + lo) only when the carry is added to
//   the tile's elements. Aggregates of windows without a prefix wait in
//   shared memory; past kLookWindows windows the walk waits for the
//   oldest tile's prefix (its block is running: tickets are in order).
// - Its state buffer is its own (the wrapper keys the buffers by kernel),
//   never expand_scan's.
//
// multi_cummax replaces scan_kernel.py::_kernel (wrapper multi_cummax): the
// inclusive int32 cummax of n equal-length rows, INT_MIN the identity (the
// TPU wrapper pads with it). The TPU kernel carried each row's running max
// across a sequential grid in SMEM. Bound: bytes, 8 B an element (one int
// read, one written). It is multi_cumsum's single pass with max in place
// of the compensated sum: one launch, tiles of 512 threads x 32 elements
// from the self-resetting ticket, each element read once with 16-byte
// loads. What max changes:
//
// - A tile's state is one packed 64-bit word, epoch << 34 | flag << 32 |
//   value, written with one relaxed 64-bit store and read with relaxed
//   loads: the value travels with its flag, so there is no value-then-
//   status handshake (release / acquire) and no second read. The epoch
//   has 30 bits and starts again at 1 after 2^30 - 1 calls, with
//   expand_scan's caveat (at one call a densification, a billion
//   densifications).
// - Max is exact and idempotent, so the look-back takes the maximum of
//   everything it read up to the nearest prefix, in any order, and the
//   result is the sequential scan's bit for bit: no tile order on one
//   lane, no aggregates kept in shared memory, no window limit.
// - Its state buffer is its own (keyed "multi_cummax" by the wrapper).

// Plain C interface: pointers and the stream come from the binding; each
// launcher returns cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>

// MERGE_ITEMS (merged items a thread of merge_expand), CUMSUM_THREADS and
// CUMSUM_ITEMS (a multi_cumsum tile is their product) and CUMSUM_LOOKBACK
// and CUMMAX_LOOKBACK (0: no carry at all, a wrong result that times the
// kernel's streaming alone) exist so that scripts/torch_blend_variants.py
// can build the ablations of this source.
#ifndef MERGE_ITEMS
#define MERGE_ITEMS 4
#endif
#ifndef CUMSUM_THREADS
#define CUMSUM_THREADS 512
#endif
#ifndef CUMSUM_ITEMS
#define CUMSUM_ITEMS 32
#endif
#ifndef CUMSUM_LOOKBACK
#define CUMSUM_LOOKBACK 1
#endif
#ifndef CUMMAX_LOOKBACK
#define CUMMAX_LOOKBACK 1
#endif

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
// epochs of expand_scan's and multi_cumsum's status words (epoch << 2 |
// flag): the header's 32 bits
constexpr unsigned long long kEpochLimit = 1ull << 32;
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

// The state buffer's header, its first 32 bytes: word 0 packs the epoch
// of the last call (high 32 bits, 0 in a zeroed buffer) with the ticket
// counter (low 32 bits). Thread 0 of each block takes its tile with one
// atomic add, which reads the epoch with it; the block that takes the last
// ticket (every other block of the call has taken its own by then, under
// the same epoch) puts the counter back to 0 and stores this call's
// epoch, one more than the last call's, wrapping to 1 below ``limit``.
__device__ __forceinline__ long long take_ticket(unsigned long long* header,
                                                 int tiles,
                                                 unsigned long long limit,
                                                 unsigned long long* epoch) {
  const unsigned long long old = atomicAdd(header, 1ull);
  const unsigned long long e = (old >> 32) + 1;
  const unsigned long long t = old & 0xffffffffull;
  if (t == static_cast<unsigned long long>(tiles - 1)) {
    atomicExch(header, (e + 1 == limit ? 0ull : e) << 32);
  }
  *epoch = e;
  return static_cast<long long>(t);
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

// three blocks an SM: at 86 registers (the epoch's take_ticket) two fit
// and the kernel ran 13% slower on an H100; bounded, 80 and no spills
__global__ void __launch_bounds__(kScanThreads, 3)
expand_scan_kernel(const int* __restrict__ marks,
                   const int* __restrict__ base_in, long long k,
                   unsigned long long* __restrict__ header,
                   TileState* __restrict__ state, int tiles, bool vec,
                   int* __restrict__ pack_out, int* __restrict__ base_out,
                   int* __restrict__ rank_out) {
  __shared__ long long s_tile;
  __shared__ unsigned long long s_epoch;
  __shared__ Owner s_warp[kScanWarps];
  __shared__ Owner s_carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_tile = take_ticket(header, tiles, kEpochLimit, &s_epoch);
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
    const unsigned long long epoch = s_epoch;  // not held through the scan
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

// ---- merge_expand

constexpr int kMergeThreads = 256;
constexpr int kMergeItems = MERGE_ITEMS;                 // merged items a thread
constexpr int kMergeTile = kMergeThreads * kMergeItems;  // a block's share
// The number of starts among the first ``end`` items of the merged
// sequence, #{g : g + min(starts[g], k) < end}, by one warp (every lane
// returns it): each step probes 32 evenly spaced points of the interval
// that holds it; the key is strictly increasing, so the probes below
// ``end`` are a prefix of the lanes and the interval shrinks 32-fold.
__device__ long long merge_split(const int* __restrict__ starts, int p,
                                 int k, long long end, int lane) {
  long long lo = end > k ? end - k : 0;
  long long hi = end < p ? end : (long long)p;
  while (lo < hi) {
    const long long step = (hi - lo + 31) >> 5;
    const long long g = lo + lane * step;
    const bool before = g < hi && g + min(__ldg(starts + g), k) < end;
    const int n = __popc(__ballot_sync(kFull, before));
    if (n == 0) {
      hi = lo;
    } else {
      const long long next_lo = lo + (n - 1) * step + 1;
      hi = min(lo + n * step, hi);
      lo = next_lo;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kMergeThreads)
merge_expand_kernel(const int* __restrict__ starts,
                    const int* __restrict__ pack, int p, int k, bool vec,
                    int* __restrict__ pack_out, int* __restrict__ base_out,
                    int* __restrict__ rank_out) {
  // the window: entry 0 is start a0 - 1 (zeros when a0 == 0), entry s + 1
  // is start a0 + s; a slot's owner is window entry s_owner[slot]
  __shared__ int s_start[kMergeTile + 1];
  __shared__ int s_pack[kMergeTile + 1];
  __shared__ unsigned short s_owner[kMergeTile];
  __shared__ long long s_split[2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // 1. The block's ends on the merge path (warps 0 and 1), its window.
  const long long total = (long long)p + k;
  const long long i0 = (long long)blockIdx.x * kMergeTile;
  const long long i1 = min(i0 + kMergeTile, total);
  if (warp < 2) {
    const long long a = merge_split(starts, p, k, warp == 0 ? i0 : i1, lane);
    if (lane == 0) s_split[warp] = a;
  }
  __syncthreads();
  const long long a0 = s_split[0];
  const int n_starts = static_cast<int>(s_split[1] - a0);
  const int n_items = static_cast<int>(i1 - i0);
  const int n_slots = n_items - n_starts;
  const int d0 = static_cast<int>(i0 - a0);  // the block's first slot
  for (int s = threadIdx.x; s <= n_starts; s += kMergeThreads) {
    const long long g = a0 - 1 + s;
    s_start[s] = g >= 0 ? __ldg(starts + g) : 0;
    s_pack[s] = g >= 0 ? __ldg(pack + g) : 0;
  }
  __syncthreads();

  // 2. The thread's split in the window, then its items in merge order: a
  //    start goes before a slot it is <= to.
  const int diag = min(static_cast<int>(threadIdx.x) * kMergeItems, n_items);
  int lo = max(0, diag - n_slots), hi = min(diag, n_starts);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (mid + min(s_start[mid + 1], k) - d0 < diag) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int s = lo, j = diag - lo;
#pragma unroll
  for (int it = 0; it < kMergeItems; ++it) {
    if (diag + it < n_items) {
      if (s < n_starts && (j >= n_slots || s_start[s + 1] <= d0 + j)) {
        ++s;
      } else {
        s_owner[j++] = static_cast<unsigned short>(s);
      }
    }
  }
  __syncthreads();

  // 3. The slots' outputs, four consecutive slots (16-byte aligned groups)
  //    a thread.
  const int d1 = d0 + n_slots;
  for (int q = (d0 & ~3) + 4 * static_cast<int>(threadIdx.x); q < d1;
       q += 4 * kMergeThreads) {
    int v[3][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int d = q + r;
      const int o = d >= d0 && d < d1 ? s_owner[d - d0] : 0;
      v[0][r] = s_pack[o];
      v[1][r] = s_start[o];
      v[2][r] = static_cast<int>(a0) + o;  // (a0 - 1 + o) + 1
    }
    if (vec && q >= d0 && q + 3 < d1) {
      *reinterpret_cast<int4*>(pack_out + q) =
          make_int4(v[0][0], v[0][1], v[0][2], v[0][3]);
      *reinterpret_cast<int4*>(base_out + q) =
          make_int4(v[1][0], v[1][1], v[1][2], v[1][3]);
      *reinterpret_cast<int4*>(rank_out + q) =
          make_int4(v[2][0], v[2][1], v[2][2], v[2][3]);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (q + r >= d0 && q + r < d1) {
          pack_out[q + r] = v[0][r];
          base_out[q + r] = v[1][r];
          rank_out[q + r] = v[2][r];
        }
      }
    }
  }
}

// ---- multi_cumsum

constexpr int kLookWindows = 8;  // look-back windows of 32 tiles kept
constexpr int kSumThreads = CUMSUM_THREADS;
constexpr int kSumWarps = kSumThreads / 32;
constexpr int kSumItems = CUMSUM_ITEMS;   // elements a thread
constexpr int kSumRows = kSumItems / 4;   // 16-byte loads a thread
constexpr int kSumTile = kSumThreads * kSumItems;

// a tile's published state: 32 bytes, status word first
struct SumState {
  unsigned long long status;  // epoch << 2 | flag
  float agg;                  // the tile's own total
  float hi, lo;               // its inclusive prefix, a Neumaier pair
  float pad[3];
};
static_assert(sizeof(SumState) == 32, "gsplat_multi_cumsum_state_words");

__device__ __forceinline__ float warp_inclusive_sum(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    float u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

// Neumaier add of y into the pair (hi, lo): hi carries the sum, lo the
// compensation
__device__ __forceinline__ void neumaier_add(float& hi, float& lo, float y) {
  const float t = hi + y;
  lo += fabsf(hi) >= fabsf(y) ? (hi - t) + y : (y - t) + hi;
  hi = t;
}

// four floats from idx: one 16-byte load where they all exist and the
// buffer is aligned, else scalar loads (0 past the end)
__device__ __forceinline__ float4 load4f(const float* __restrict__ p,
                                         long long idx, long long k,
                                         bool vec) {
  if (vec && idx + 3 < k) {
    return __ldg(reinterpret_cast<const float4*>(p + idx));
  }
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (idx < k) v.x = p[idx];
  if (idx + 1 < k) v.y = p[idx + 1];
  if (idx + 2 < k) v.z = p[idx + 2];
  if (idx + 3 < k) v.w = p[idx + 3];
  return v;
}

__device__ __forceinline__ void store4f(float* __restrict__ p, long long idx,
                                        long long k, bool vec, float4 v) {
  if (vec && idx + 3 < k) {
    *reinterpret_cast<float4*>(p + idx) = v;
    return;
  }
  if (idx < k) p[idx] = v.x;
  if (idx + 1 < k) p[idx + 1] = v.y;
  if (idx + 2 < k) p[idx + 2] = v.z;
  if (idx + 3 < k) p[idx + 3] = v.w;
}

// The carry of tile ``tile`` (> row_first, its row's first tile): the
// inclusive prefix P_{b-1} of the tile before it, by warp 0, the same pair
// in every lane. Lane l of window w reads tile tile - 32 (w + 1) + l and
// waits until it is published in this epoch; tiles before the row count
// as published prefixes (0, 0). The nearest prefix is folded forward
// through the aggregates after it, in tile order, so the result does not
// depend on where the walk stopped.
__device__ void cumsum_look_back(const SumState* state, long long tile,
                                 long long row_first,
                                 unsigned long long epoch, int lane,
                                 float (*s_agg)[32], float& hi, float& lo) {
  for (int w = 0;; ++w) {
    const long long pred = tile - 32LL * (w + 1) + lane;
    bool prefix = true;
    float a = 0.0f, h = 0.0f, l = 0.0f;
    if (pred >= row_first) {
      const SumState* s = state + pred;
      // the last kept window waits for its oldest tile's prefix
      const bool need_prefix = w == kLookWindows - 1 && lane == 0;
      unsigned long long st;
      do {
        st = load_acquire(&s->status);
      } while ((st >> 2) != epoch ||
               (need_prefix && (st & 3u) != kFlagPrefix));
      prefix = (st & 3u) == kFlagPrefix;
      if (prefix) {
        h = __ldcg(&s->hi);
        l = __ldcg(&s->lo);
      } else {
        a = __ldcg(&s->agg);
      }
    }
    const unsigned prefixes = __ballot_sync(kFull, prefix);
    if (!prefixes) {  // w < kLookWindows - 1
      s_agg[w][lane] = a;
      continue;
    }
    const int start = 31 - __clz(prefixes);
    hi = __shfl_sync(kFull, h, start);
    lo = __shfl_sync(kFull, l, start);
#pragma unroll
    for (int m = 0; m < 32; ++m) {
      const float am = __shfl_sync(kFull, a, m);
      if (m > start) neumaier_add(hi, lo, am);
    }
    __syncwarp();
    for (int v = w - 1; v >= 0; --v) {
      for (int m = 0; m < 32; ++m) neumaier_add(hi, lo, s_agg[v][m]);
    }
    return;
  }
}

__global__ void __launch_bounds__(kSumThreads)
multi_cumsum_kernel(const float* __restrict__ x, long long k, int row_tiles,
                    unsigned long long* __restrict__ header,
                    SumState* __restrict__ state, int tiles,
                    float* __restrict__ out) {
  __shared__ long long s_tile;
  __shared__ unsigned long long s_epoch;
  __shared__ float s_warp[kSumWarps];
  __shared__ float s_carry;
  __shared__ float s_agg[kLookWindows][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_tile = take_ticket(header, tiles, kEpochLimit, &s_epoch);
  }
  __syncthreads();
  const long long tile = s_tile;
  const long long row = tile / row_tiles;
  const long long blk = tile - row * row_tiles;
  const float* xr = x + row * k;
  float* orow = out + row * k;
  const bool vec = ((reinterpret_cast<unsigned long long>(xr) |
                     reinterpret_cast<unsigned long long>(orow)) &
                    15u) == 0;
  const long long warp_base =
      blk * kSumTile + (long long)warp * 32 * kSumItems;

  // 1. Load and scan: lane l holds four consecutive elements of each
  //    128-element row of the warp's 512, inclusive in vals[] less the
  //    totals of the warps before its own.
  float vals[kSumItems];
  float run = 0.0f;
#pragma unroll
  for (int i = 0; i < kSumRows; ++i) {
    const long long idx = warp_base + (long long)i * kRowSlots + 4 * lane;
    const float4 v = load4f(xr, idx, k, vec);
    const float x0 = v.x, x1 = x0 + v.y, x2 = x1 + v.z, x3 = x2 + v.w;
    const float incl = warp_inclusive_sum(x3, lane);
    const float up = __shfl_up_sync(kFull, incl, 1);
    const float excl = run + (lane == 0 ? 0.0f : up);
    vals[4 * i] = excl + x0;
    vals[4 * i + 1] = excl + x1;
    vals[4 * i + 2] = excl + x2;
    vals[4 * i + 3] = excl + x3;
    run += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) s_warp[warp] = run;
  __syncthreads();

  // 2. The tile's carry P_{b-1}: publish the total, look back, publish
  //    the inclusive prefix fold(P_{b-1}, total).
  if (warp == 0) {
    const unsigned long long epoch = s_epoch;  // not held through the scan
    float total = 0.0f;
    for (int w = 0; w < kSumWarps; ++w) total += s_warp[w];
    SumState* s = state + tile;
    float hi = 0.0f, lo = 0.0f;
    if (CUMSUM_LOOKBACK && blk > 0) {
      if (lane == 0) {
        __stcg(&s->agg, total);
        store_release(&s->status, epoch << 2 | kFlagAggregate);
      }
      cumsum_look_back(state, tile, tile - blk, epoch, lane, s_agg, hi, lo);
    }
    if (lane == 0) {
      s_carry = hi + lo;
      neumaier_add(hi, lo, total);
      __stcg(&s->hi, hi);
      __stcg(&s->lo, lo);
      store_release(&s->status, epoch << 2 | kFlagPrefix);
    }
  }
  __syncthreads();

  // 3. Write: the warps before this one, the element, then the carry.
  float prefix = 0.0f;
  for (int w = 0; w < warp; ++w) prefix += s_warp[w];
  const float carry = s_carry;
#pragma unroll
  for (int i = 0; i < kSumRows; ++i) {
    const long long idx = warp_base + (long long)i * kRowSlots + 4 * lane;
    store4f(orow, idx, k, vec,
            make_float4((prefix + vals[4 * i]) + carry,
                        (prefix + vals[4 * i + 1]) + carry,
                        (prefix + vals[4 * i + 2]) + carry,
                        (prefix + vals[4 * i + 3]) + carry));
  }
}

// ---- multi_cummax

constexpr int kIntMin = -2147483647 - 1;  // identity of max
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxItems = 32;            // elements a thread
constexpr int kMaxRows = kMaxItems / 4;  // 16-byte loads a thread
constexpr int kMaxTile = kMaxThreads * kMaxItems;
constexpr int kMaxEpochBits = 30;        // epoch << 34 | flag << 32 | value

// a tile's published state, one packed 64-bit word
__device__ __forceinline__ unsigned long long max_status(
    unsigned long long epoch, int flag, int v) {
  return epoch << 34 | static_cast<unsigned long long>(flag) << 32 |
         static_cast<unsigned>(v);
}

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ int warp_inclusive_max(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v = max(v, u);
  }
  return v;
}

// four ints from idx: one 16-byte load where they all exist and the
// buffer is aligned, else scalar loads (INT_MIN past the end)
__device__ __forceinline__ int4 load4_max(const int* __restrict__ p,
                                          long long idx, long long k,
                                          bool vec) {
  if (vec && idx + 3 < k) return __ldg(reinterpret_cast<const int4*>(p + idx));
  int4 v = make_int4(kIntMin, kIntMin, kIntMin, kIntMin);
  if (idx < k) v.x = p[idx];
  if (idx + 1 < k) v.y = p[idx + 1];
  if (idx + 2 < k) v.z = p[idx + 2];
  if (idx + 3 < k) v.w = p[idx + 3];
  return v;
}

// The carry of tile ``tile`` (> row_first, its row's first tile): the
// maximum of its row's tiles before it, by warp 0, the same in every lane.
// Lane l of window w reads tile tile - 32 (w + 1) + l and waits until its
// word carries this call's epoch; tiles before the row count as prefixes
// of INT_MIN. The walk stops at the first window holding a prefix. Max is
// exact, idempotent and commutative, so the maximum over every value the
// walk read (aggregates before that prefix too) is the carry, whatever was
// published when: no ordering of the fold and no compensation.
__device__ int cummax_look_back(const unsigned long long* state,
                                long long tile, long long row_first,
                                unsigned long long epoch, int lane) {
  int run = kIntMin;
  for (long long pred = tile - 32 + lane;; pred -= 32) {
    bool prefix = true;
    if (pred >= row_first) {
      unsigned long long st;
      do {
        st = load_relaxed(state + pred);
      } while ((st >> 34) != epoch);
      prefix = ((st >> 32) & 3u) == kFlagPrefix;
      run = max(run, static_cast<int>(static_cast<unsigned>(st)));
    }
    if (__ballot_sync(kFull, prefix)) break;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    run = max(run, __shfl_xor_sync(kFull, run, off));
  }
  return run;
}

__global__ void __launch_bounds__(kMaxThreads)
multi_cummax_kernel(const int* __restrict__ x, long long k, int row_tiles,
                    unsigned long long* __restrict__ header,
                    unsigned long long* __restrict__ state, int tiles,
                    int* __restrict__ out) {
  __shared__ long long s_tile;
  __shared__ unsigned long long s_epoch;
  __shared__ int s_warp[kMaxWarps];
  __shared__ int s_carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_tile = take_ticket(header, tiles, 1ull << kMaxEpochBits, &s_epoch);
  }
  __syncthreads();
  const long long tile = s_tile;
  const long long row = tile / row_tiles;
  const long long blk = tile - row * row_tiles;
  const int* xr = x + row * k;
  int* orow = out + row * k;
  const bool vec = ((reinterpret_cast<unsigned long long>(xr) |
                     reinterpret_cast<unsigned long long>(orow)) &
                    15u) == 0;
  const long long warp_base =
      blk * kMaxTile + (long long)warp * 32 * kMaxItems;

  // 1. Load and scan: lane l holds four consecutive elements of each
  //    128-element row of the warp's, inclusive in vals[] without the
  //    warps before its own.
  int vals[kMaxItems];
  int run = kIntMin;
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    const long long idx = warp_base + (long long)i * kRowSlots + 4 * lane;
    const int4 v = load4_max(xr, idx, k, vec);
    const int x0 = v.x, x1 = max(x0, v.y), x2 = max(x1, v.z),
              x3 = max(x2, v.w);
    const int incl = warp_inclusive_max(x3, lane);
    const int up = __shfl_up_sync(kFull, incl, 1);
    const int excl = lane == 0 ? run : max(run, up);
    vals[4 * i] = max(excl, x0);
    vals[4 * i + 1] = max(excl, x1);
    vals[4 * i + 2] = max(excl, x2);
    vals[4 * i + 3] = max(excl, x3);
    run = max(run, __shfl_sync(kFull, incl, 31));
  }
  if (lane == 0) s_warp[warp] = run;
  __syncthreads();

  // 2. The tile's carry: publish the tile's maximum, look back, publish
  //    the inclusive prefix max(carry, maximum); each one 64-bit store.
  if (warp == 0) {
    const unsigned long long epoch = s_epoch;  // not held through the scan
    int total = kIntMin;
    for (int w = 0; w < kMaxWarps; ++w) total = max(total, s_warp[w]);
    int carry = kIntMin;
    if (CUMMAX_LOOKBACK && blk > 0) {
      if (lane == 0) {
        store_relaxed(state + tile, max_status(epoch, kFlagAggregate, total));
      }
      carry = cummax_look_back(state, tile, tile - blk, epoch, lane);
    }
    if (lane == 0) {
      s_carry = carry;
      store_relaxed(state + tile,
                    max_status(epoch, kFlagPrefix, max(carry, total)));
    }
  }
  __syncthreads();

  // 3. Write: the carry and the warps before this one, then the element.
  int prefix = s_carry;
  for (int w = 0; w < warp; ++w) prefix = max(prefix, s_warp[w]);
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    const long long idx = warp_base + (long long)i * kRowSlots + 4 * lane;
    store4(orow, idx, k, vec,
           make_int4(max(prefix, vals[4 * i]), max(prefix, vals[4 * i + 1]),
                     max(prefix, vals[4 * i + 2]),
                     max(prefix, vals[4 * i + 3])));
  }
}

}  // namespace

// int64 words of the look-back state multi_cumsum takes for n rows of k:
// the header (ticket and epoch, padded to 32 bytes), then one SumState a
// tile. The caller zero-fills it once.
extern "C" long long gsplat_multi_cumsum_state_words(int n, long long k) {
  const long long tiles = (long long)n * ((k + kSumTile - 1) / kSumTile);
  return 4 * (tiles + 1);
}

// x, out: [n, k] row-major; state: gsplat_multi_cumsum_state_words(n, k)
// int64; calls sharing a buffer must not overlap (one stream)
extern "C" int gsplat_multi_cumsum(const float* x, int n, long long k,
                                   void* state, float* out,
                                   cudaStream_t stream) {
  const long long row_tiles = (k + kSumTile - 1) / kSumTile;
  const long long tiles = (long long)n * row_tiles;
  if (tiles == 0) return 0;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto* header = static_cast<unsigned long long*>(state);
  auto* tile_state = reinterpret_cast<SumState*>(header + 4);
  multi_cumsum_kernel<<<(unsigned)tiles, kSumThreads, 0, stream>>>(
      x, k, (int)row_tiles, header, tile_state, (int)tiles, out);
  return (int)cudaGetLastError();
}

// int64 words of the look-back state multi_cummax takes for n rows of k:
// the header (ticket and epoch, padded to 32 bytes), then one packed
// status word a tile. The caller zero-fills it once.
extern "C" long long gsplat_multi_cummax_state_words(int n, long long k) {
  const long long tiles = (long long)n * ((k + kMaxTile - 1) / kMaxTile);
  return 4 + tiles;
}

extern "C" unsigned long long gsplat_multi_cummax_epoch_limit() {
  return 1ull << kMaxEpochBits;
}

// x, out: [n, k] row-major int32; state: gsplat_multi_cummax_state_words
// int64; calls sharing a buffer must not overlap (one stream)
extern "C" int gsplat_multi_cummax(const int* x, int n, long long k,
                                   void* state, int* out,
                                   cudaStream_t stream) {
  const long long row_tiles = (k + kMaxTile - 1) / kMaxTile;
  const long long tiles = (long long)n * row_tiles;
  if (tiles == 0) return 0;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto* header = static_cast<unsigned long long*>(state);
  multi_cummax_kernel<<<(unsigned)tiles, kMaxThreads, 0, stream>>>(
      x, k, (int)row_tiles, header, header + 4, (int)tiles, out);
  return (int)cudaGetLastError();
}

// int64 words of the state buffer expand_scan takes: the header (ticket
// and epoch, padded to 32 bytes), then one TileState a tile. The caller
// zero-fills it once.
extern "C" long long gsplat_expand_scan_state_words(long long k) {
  const long long tiles = (k + kScanTile - 1) / kScanTile;
  return 4 * (tiles + 1);
}

// state: gsplat_expand_scan_state_words(k) int64; calls sharing a buffer
// must not overlap (one stream)
extern "C" int gsplat_expand_scan(const int* marks, const int* base_in,
                                  long long k, void* state, int* pack_out,
                                  int* base_out, int* rank_out,
                                  cudaStream_t stream) {
  const long long tiles = (k + kScanTile - 1) / kScanTile;
  if (tiles == 0) return 0;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto aligned = [](const void* p) {
    return (reinterpret_cast<unsigned long long>(p) & 15u) == 0;
  };
  const bool vec = aligned(marks) && aligned(base_in) && aligned(pack_out) &&
                   aligned(base_out) && aligned(rank_out);
  auto* header = static_cast<unsigned long long*>(state);
  auto* tile_state = reinterpret_cast<TileState*>(header + 4);
  expand_scan_kernel<<<(unsigned)tiles, kScanThreads, 0, stream>>>(
      marks, base_in, k, header, tile_state, (int)tiles, vec, pack_out,
      base_out, rank_out);
  return (int)cudaGetLastError();
}

extern "C" int gsplat_merge_expand(const int* starts, const int* pack, int p,
                                   int k, int* pack_out, int* base_out,
                                   int* rank_out, cudaStream_t stream) {
  if (k == 0) return 0;
  const long long blocks = ((long long)p + k + kMergeTile - 1) / kMergeTile;
  auto aligned = [](const void* q) {
    return (reinterpret_cast<unsigned long long>(q) & 15u) == 0;
  };
  const bool vec = aligned(pack_out) && aligned(base_out) && aligned(rank_out);
  merge_expand_kernel<<<(unsigned)blocks, kMergeThreads, 0, stream>>>(
      starts, pack, p, k, vec, pack_out, base_out, rank_out);
  return (int)cudaGetLastError();
}
