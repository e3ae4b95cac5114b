// Inclusive segmented scans in one pass, shared by seg_cumsum_i64.cu,
// seg_scan_multi.cu and fused_running_stats.cu.
//
// A row whose flag is set starts a new segment; row 0 always starts fresh.
// Segments combine as pairs (flag-seen, value-since-last-flag). The scans
// are memory-bound, so the design is about device-memory passes:
// launch_lookback makes one launch, one read of every input byte and one
// write of every output byte: the single-pass scan with decoupled
// look-back of Merrill & Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back" (NVIDIA, 2016), with the segmented stopping rule.
// See segscan_lookback below.
//
// A lane type L describes the values being scanned: K lanes of words W
// (V = Words<W, K>), each lane its own output array of n words:
//   typename L::W, typename L::V, static constexpr int kLanes = K
//   static constexpr bool kOneInput     false: K inputs, lane j reads x[j];
//                                       true: every lane reads the one
//                                       column x[0] (fused_running_stats)
//   const W* x[K] (x[1] if kOneInput); W* out[K]
//   V identity() const                 identity of combine
//   V combine(V a, V b) const          associative; a is the earlier value
//   V shfl_up(V v, int delta) const    __shfl_up_sync over every word of v
//   void with_op(int j, F f) const      calls f(op) with an op type of lane
//                                       j: static W identity(), static W
//                                       combine(W a, W b)
#pragma once

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace aq {

template <class W, int K>
struct Words {
  W w[K];
};

template <class W, int K>
__device__ __forceinline__ Words<W, K> words_shfl_up(const Words<W, K>& v,
                                                     int delta) {
  Words<W, K> r;
#pragma unroll
  for (int j = 0; j < K; ++j)
    r.w[j] = __shfl_up_sync(0xffffffffu, v.w[j], delta);
  return r;
}

constexpr unsigned kFull = 0xffffffffu;

template <class L>
struct Seg {
  typename L::V v;
  int f;  // a segment start lies inside the span this pair covers
};

// (fa, va) . (fb, vb) = (fa | fb, fb ? vb : va + vb): associative, not
// commutative; a covers the earlier rows.
template <class L>
__device__ __forceinline__ Seg<L> seg_combine(const L& lanes, const Seg<L>& a,
                                              const Seg<L>& b) {
  Seg<L> r;
  r.f = a.f | b.f;
  r.v = b.f ? b.v : lanes.combine(a.v, b.v);
  return r;
}

template <class L>
__device__ __forceinline__ Seg<L> seg_identity(const L& lanes) {
  Seg<L> r;
  r.v = lanes.identity();
  r.f = 0;
  return r;
}

template <class L>
__device__ __forceinline__ Seg<L> seg_shfl_up(const L& lanes, const Seg<L>& x,
                                              int delta) {
  Seg<L> r;
  r.v = lanes.shfl_up(x.v, delta);
  r.f = __shfl_up_sync(kFull, x.f, delta);
  return r;
}

template <class L>
__device__ __forceinline__ Seg<L> warp_inclusive_scan(const L& lanes, Seg<L> x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    Seg<L> y = seg_shfl_up(lanes, x, d);
    if (lane >= d) x = seg_combine(lanes, y, x);
  }
  return x;
}

// Exclusive scan of one pair per thread across the block (blockDim.x a
// multiple of 32, at most 1024). Returns the thread's exclusive prefix and
// sets *total to the fold of the whole block. Every thread must call it.
template <class L>
__device__ Seg<L> block_exclusive_scan(const L& lanes, const Seg<L>& x,
                                       Seg<L>* total) {
  __shared__ Seg<L> warp_part[32];
  __shared__ Seg<L> block_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  Seg<L> inc = warp_inclusive_scan(lanes, x);
  Seg<L> exc = seg_shfl_up(lanes, inc, 1);
  if (lane == 0) exc = seg_identity(lanes);
  if (lane == 31) warp_part[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Seg<L> w = lane < nwarps ? warp_part[lane] : seg_identity(lanes);
    Seg<L> winc = warp_inclusive_scan(lanes, w);
    Seg<L> wexc = seg_shfl_up(lanes, winc, 1);
    if (lane == 0) wexc = seg_identity(lanes);
    if (lane < nwarps) warp_part[lane] = wexc;
    if (lane == 31) block_total = winc;
  }
  __syncthreads();
  Seg<L> out = seg_combine(lanes, warp_part[warp], exc);
  *total = block_total;
  __syncthreads();  // the shared slots may be reused by the next call
  return out;
}

// ---------------------------------------------------------------------------
// Single pass with decoupled look-back (Merrill & Garland 2016).
//
// Each block takes its tile id from an atomic counter (not blockIdx.x), so
// it waits only on tiles whose blocks have already started: it makes
// progress at any occupancy. The block
//   1. copies its tile of every lane into shared memory, neighbouring
//      threads on neighbouring 16-byte chunks (cp.async), and loads its
//      thread's flags (one per row, lb_items rows) in one load;
//   2. folds each thread's rows (read back from shared memory in blocked
//      order), scans the folds across the block, and publishes the tile's
//      aggregate pair (status 1, or 3 if a flag lies in the tile);
//   3. resolves its carry-in in warp 0, 32 predecessors at a time: the
//      walk stops at the first inclusive prefix (status 2) or at the first
//      aggregate whose flag is set, since that tile's value already
//      excludes everything before its segment start, and it waits only
//      for the tiles from that stop on; the window is combined in tile
//      order (earlier . later), and windows further back go in front of
//      the ones nearer;
//   4. publishes its inclusive prefix (status 2), rescans its rows from
//      shared memory with the carry-in into the same slots, and writes
//      them out as it loaded them.
// A lane type with kOneInput (K statistics of one column) stages the
// column once, and every lane folds and rescans it from there; step 4
// rescans one lane at a time into a second buffer, which goes out before
// the next lane's rescan. So its block holds two tile buffers, not K
// (tile_buffers), and its tiles are those of two lanes.
// Publishing: the value words, then __threadfence(), then the status word
// with a release store; a reader spins on the status with acquire loads
// and reads the words past L1. Aggregates and inclusive prefixes have
// their own arrays, so a reader never sees a half-overwritten value.
//
// The status words and the tile counter (status[ntiles]) are zeroed by the
// caller before every launch, on its stream.
//
// Float add lanes: whether a look-back meets a predecessor's aggregate or
// its inclusive prefix depends on timing, so float adds are associated
// differently from run to run (not bit-reproducible). Integer lanes,
// min/max and integer-valued float sums are exact in any order.

// Rows per thread for K lanes of words W: 16, or 8 where 16 rows of every
// lane would pass 256 bytes (three or four 64-bit lanes), so that those
// blocks keep enough threads. A thread's flags are one 16- or 8-byte load.
template <class W, int K>
__host__ __device__ constexpr int lb_items() {
  return K * (int)sizeof(W) * 16 <= 256 ? 16 : 8;
}

enum : int { kEmpty = 0, kAggregate = 1, kInclusive = 2, kAggregateFlag = 3 };

// Tile buffers a block of lane type L stages in shared memory: one a lane,
// or for a one-input lane type two (the column, and one lane's results on
// their way out). The tile geometry below is that of this many lanes.
template <class L>
__host__ __device__ constexpr int tile_buffers() {
  return L::kOneInput ? 2 : L::kLanes;
}

// Rows per tile for K lanes of words W: lb_items rows for each of the
// most threads (a multiple of 32) whose tiles of every lane fit the 48 KB
// of shared memory a block gets without opting in, less 2 KB for the
// block scan's own (static and dynamic together count against the 48 KB),
// and at most 4096 rows. So four blocks fit an SM: 4096 rows for one or
// two 32-bit lanes or one 64-bit lane, down to 1280 for four 64-bit lanes.
// A diagnostic build may set another budget (nvcc -DAQ_LOOKBACK_SMEM=bytes,
// utils/lookback_diag.py's sweep).
#ifndef AQ_LOOKBACK_SMEM
#define AQ_LOOKBACK_SMEM 47104
#endif
template <class W, int K>
__host__ __device__ constexpr int lookback_rows() {
  constexpr int items = lb_items<W, K>();
  constexpr int fit =
      AQ_LOOKBACK_SMEM / (K * (int)sizeof(W) * items) / 32 * 32;
  return items * (fit < 4096 / items ? fit : 4096 / items);
}

// Threads and bytes of dynamic shared memory of one block of lane type L.
template <class L>
__host__ __device__ constexpr int lookback_threads() {
  return lookback_rows<typename L::W, tile_buffers<L>()>() /
         lb_items<typename L::W, tile_buffers<L>()>();
}
template <class L>
__host__ __device__ constexpr int lookback_smem() {
  return tile_buffers<L>() * lookback_rows<typename L::W, tile_buffers<L>()>() *
         (int)sizeof(typename L::W);
}

// 16-byte chunk c of a lane's tile buffer sits at chunk swz(c): rows of
// eight chunks (128 bytes, the 32 banks), the column XORed with the row.
// Then the striped copy (thread l on chunk l) and the blocked reads (thread
// t on its rows: 4 or 8 consecutive chunks) both touch eight different
// columns in each quarter-warp: no bank conflicts.
__device__ __forceinline__ int swz(int c) { return c ^ ((c >> 3) & 7); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// Diagnostic builds (nvcc -DAQ_LOOKBACK_DIAG, utils/lookback_diag.py):
// thread 0 of each block records, for its tile, the SM it ran on, its
// clock64() at entry, once the tile is in shared memory, before and after
// the look-back and once the tile is written out, and the look-back's
// windows; read_lookback_diag copies the records out. Without the macro
// nothing is recorded.
#ifdef AQ_LOOKBACK_DIAG
#define AQ_DIAG(...) __VA_ARGS__
constexpr int kDiagTiles = 16384;
constexpr int kDiagWords = 8;
static __device__ long long lookback_diag[kDiagTiles * kDiagWords];

// The records of the last launch's first ntiles tiles, into host memory.
static inline cudaError_t read_lookback_diag(void* dst, int ntiles) {
  if (ntiles > kDiagTiles) ntiles = kDiagTiles;
  return cudaMemcpyFromSymbol(dst, lookback_diag,
                              (size_t)ntiles * kDiagWords * sizeof(long long));
}
#else
#define AQ_DIAG(...)
#endif

// Pairs published by earlier tiles: the aggregate (or inclusive prefix)
// of tile p, words of lane j at v[j * ntiles + p].
template <class L>
__device__ __forceinline__ typename L::V read_pub(
    const typename L::W* v, int p, int ntiles) {
  typename L::V r;
#pragma unroll
  for (int j = 0; j < L::kLanes; ++j)
    r.w[j] = __ldcg(v + (size_t)j * ntiles + p);
  return r;
}

template <class L>
__device__ __forceinline__ void write_pub(typename L::W* v, int p,
                                          int ntiles,
                                          const typename L::V& x) {
#pragma unroll
  for (int j = 0; j < L::kLanes; ++j)
    __stcg(v + (size_t)j * ntiles + p, x.w[j]);
}

// Warp 0: the carry-in of `tile` from its predecessors' published pairs.
// The result is valid in lane 31; *windows counts the windows walked.
template <class L>
__device__ Seg<L> look_back(const L& lanes, const typename L::W* agg,
                            const typename L::W* inc, const int* status,
                            int tile, int ntiles, int* windows) {
  const int lane = threadIdx.x & 31;
  Seg<L> run = seg_identity(lanes);
  for (int end = tile;; end -= 32) {
    ++*windows;
    const int p = end - 32 + lane;           // lane 31: the nearest tile
    int st = p < 0 ? -1 : kEmpty;            // before tile 0: identity
    unsigned stops;
    while (true) {
      if (st == kEmpty) st = load_acquire(status + p);
      const unsigned empty = __ballot_sync(kFull, st == kEmpty);
      stops = __ballot_sync(kFull, st >= kInclusive);
      // Go on once every tile from the nearest stop on has published (the
      // highest set bit of stops above that of empty): the tiles before
      // that stop are not read, so they need not be waited for.
      if (empty == 0 || stops > empty) break;
    }
    const int s = stops ? 31 - __clz(stops) : -1;   // the nearest stop
    Seg<L> x = seg_identity(lanes);
    if (lane >= s && st > kEmpty) {
      x.v = read_pub<L>(st == kInclusive ? inc : agg, p, ntiles);
      x.f = st >= kInclusive;
    }
    const Seg<L> window = warp_inclusive_scan(lanes, x);
    run = seg_combine(lanes, window, run);   // earlier . later
    if (stops) return run;
  }
}

// Writes a lane's tile buffer out to dst[0, rows): as it was loaded, one
// 16-byte chunk a thread in turn where the tile is full and dst aligned,
// else word by word.
template <class W, int ROWS, int THREADS>
__device__ __forceinline__ void store_tile(const W* lb, W* dst, int rows,
                                           bool full) {
  constexpr int P = 16 / (int)sizeof(W);
  if (full && aligned16(dst)) {
    for (int c = threadIdx.x; c < ROWS / P; c += THREADS)
      *reinterpret_cast<uint4*>(dst + c * P) =
          *reinterpret_cast<const uint4*>(lb + swz(c) * P);
  } else {
    for (int w = threadIdx.x; w < rows; w += THREADS)
      dst[w] = lb[swz(w / P) * P + w % P];
  }
}

// Whether row i of the thread's rows starts a segment (flag byte i).
template <bool HAS_FLAGS, int N>
__device__ __forceinline__ bool row_flag(const uint32_t (&fw)[N], int i) {
  return HAS_FLAGS && ((fw[i >> 2] >> (8 * (i & 3))) & 0xffu) != 0u;
}

template <class L, bool HAS_FLAGS>
__global__ void __launch_bounds__(lookback_threads<L>())
segscan_lookback(L lanes, const uint8_t* __restrict__ flags,
                 typename L::W* agg, typename L::W* inc, int* status,
                 int64_t n, int ntiles) {
  using W = typename L::W;
  using V = typename L::V;
  constexpr int K = L::kLanes;
  constexpr int B = tile_buffers<L>();
  constexpr int ROWS = lookback_rows<W, B>();
  constexpr int ITEMS = lb_items<W, B>();    // rows per thread
  constexpr int THREADS = ROWS / ITEMS;
  constexpr int P = 16 / (int)sizeof(W);     // words per 16-byte chunk
  constexpr int CHUNKS = ROWS / P;           // chunks per lane's tile
  constexpr int MINE = ITEMS / P;            // a thread's chunks per lane
  constexpr bool ONE = L::kOneInput;         // every lane reads x[0]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* buf = reinterpret_cast<W*>(smem_raw);   // B buffers x ROWS words
  __shared__ int s_tile;
  __shared__ Seg<L> s_carry;
  AQ_DIAG(const long long c_entry = clock64();)

  if (threadIdx.x == 0) s_tile = atomicAdd(status + ntiles, 1);
  __syncthreads();
  const int tile = s_tile;
  const int64_t base = (int64_t)tile * ROWS;
  const int rows = n - base < ROWS ? (int)(n - base) : ROWS;
  const bool full = rows == ROWS;
  const V id = lanes.identity();

  // 1. the tile into shared memory; rows past n hold the identity (of lane
  // 0 for a one-input tile: rows past n only follow the rows written out)
#pragma unroll
  for (int j = 0; j < (ONE ? 1 : K); ++j) {
    W* lb = buf + j * ROWS;
    const W* src = lanes.x[j] + base;
    if (full && aligned16(src)) {
      for (int c = threadIdx.x; c < CHUNKS; c += THREADS)
        cp_async16(lb + swz(c) * P, src + c * P);
    } else {
      for (int w = threadIdx.x; w < ROWS; w += THREADS)
        lb[swz(w / P) * P + w % P] = w < rows ? src[w] : id.w[j];
    }
  }
  uint32_t fw[ITEMS / 4] = {};                // the thread's flag bytes
  if (HAS_FLAGS) {
    const int r0 = threadIdx.x * ITEMS;
    const uint8_t* fsrc = flags + base + r0;
    if (full && aligned16(flags)) {
      if constexpr (ITEMS == 16) {
        const uint4 f = *reinterpret_cast<const uint4*>(fsrc);
        fw[0] = f.x; fw[1] = f.y; fw[2] = f.z; fw[3] = f.w;
      } else {
        const uint2 f = *reinterpret_cast<const uint2*>(fsrc);
        fw[0] = f.x; fw[1] = f.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < ITEMS; ++i)
        if (r0 + i < rows && fsrc[i]) fw[i >> 2] |= 1u << (8 * (i & 3));
    }
  }
  cp_async_wait_all();
  __syncthreads();
  AQ_DIAG(const long long c_loaded = clock64();)

  // 2. fold the thread's rows, scan the folds, publish the aggregate. The
  // row loops run lane by lane, each compiled for its lane's op, so a
  // lane's op is chosen once per tile and not once per row.
  bool any_flag = false;
#pragma unroll
  for (int w = 0; w < ITEMS / 4; ++w) any_flag |= fw[w] != 0u;
  Seg<L> part;
  part.f = any_flag;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const W* lb = buf + (ONE ? 0 : j) * ROWS;
    lanes.with_op(j, [&](auto op) {
      using Op = decltype(op);
      W v = Op::identity();
#pragma unroll
      for (int q = 0; q < MINE; ++q) {
        W words[P];
        const uint4 c = *reinterpret_cast<const uint4*>(
            lb + swz(threadIdx.x * MINE + q) * P);
        memcpy(words, &c, 16);
#pragma unroll
        for (int e = 0; e < P; ++e)
          v = row_flag<HAS_FLAGS>(fw, q * P + e) ? words[e]
                                                 : Op::combine(v, words[e]);
      }
      part.v.w[j] = v;
    });
  }
  Seg<L> total;
  const Seg<L> exc = block_exclusive_scan(lanes, part, &total);

  // 3. the carry-in, and the inclusive prefix
  AQ_DIAG(const long long c_scanned = clock64(); long long c_walked = c_scanned;)
  int windows = 0;
  if (threadIdx.x < 32) {
    Seg<L> carry = seg_identity(lanes);
    if (tile > 0) {
      if (threadIdx.x == 31) {
        write_pub<L>(agg, tile, ntiles, total.v);
        __threadfence();
        store_release(status + tile, total.f ? kAggregateFlag : kAggregate);
      }
      carry = look_back(lanes, agg, inc, status, tile, ntiles, &windows);
      AQ_DIAG(c_walked = clock64();)
    }
    if (threadIdx.x == 31) {
      write_pub<L>(inc, tile, ntiles, seg_combine(lanes, carry, total).v);
      __threadfence();
      store_release(status + tile, kInclusive);
      s_carry = carry;
    }
  }
  __syncthreads();

  // 4. rescan the thread's rows into their slots (a one-input tile: each
  // lane's from the column into the second buffer, which goes out before
  // the next lane's), then write them out
  const V start = seg_combine(lanes, s_carry, exc).v;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const W* from = buf + (ONE ? 0 : j) * ROWS;
    W* to = buf + (ONE ? 1 : j) * ROWS;
    lanes.with_op(j, [&](auto op) {
      using Op = decltype(op);
      W acc = start.w[j];
#pragma unroll
      for (int q = 0; q < MINE; ++q) {
        const int at = swz(threadIdx.x * MINE + q) * P;
        W words[P];
        uint4 c = *reinterpret_cast<const uint4*>(from + at);
        memcpy(words, &c, 16);
#pragma unroll
        for (int e = 0; e < P; ++e) {
          acc = row_flag<HAS_FLAGS>(fw, q * P + e) ? words[e]
                                                   : Op::combine(acc, words[e]);
          words[e] = acc;
        }
        memcpy(&c, words, 16);
        *reinterpret_cast<uint4*>(to + at) = c;
      }
    });
    if constexpr (ONE) {
      __syncthreads();
      store_tile<W, ROWS, THREADS>(to, lanes.out[j] + base, rows, full);
      if (j + 1 < K) __syncthreads();   // the next lane rewrites `to`
    }
  }
  if constexpr (!ONE) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < K; ++j)
      store_tile<W, ROWS, THREADS>(buf + j * ROWS, lanes.out[j] + base, rows,
                                   full);
  }
  AQ_DIAG(
    __syncthreads();
    if (threadIdx.x == 0 && tile < kDiagTiles) {
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      long long* r = lookback_diag + (size_t)tile * kDiagWords;
      r[0] = sm; r[1] = c_entry; r[2] = c_loaded; r[3] = c_scanned;
      r[4] = c_walked; r[5] = clock64(); r[6] = windows; r[7] = THREADS;
    })
}

// One single-pass launch on `stream`. scratch: 2 * K * ntiles words (the
// aggregates, then the inclusive prefixes); status: ntiles + 1 int32,
// zeroed by the caller (the last one is the tile counter). Returns the
// launch error.
template <class L, bool HAS_FLAGS>
cudaError_t launch_lookback(const L& lanes, const uint8_t* flags,
                            typename L::W* scratch, int* status, int64_t n,
                            cudaStream_t stream) {
  constexpr int K = L::kLanes;
  constexpr int ROWS = lookback_rows<typename L::W, tile_buffers<L>()>();
  const int ntiles = (int)((n + ROWS - 1) / ROWS);
  segscan_lookback<L, HAS_FLAGS>
      <<<ntiles, lookback_threads<L>(), lookback_smem<L>(), stream>>>(
      lanes, flags, scratch, scratch + (size_t)K * ntiles, status, n, ntiles);
  return cudaGetLastError();
}

// The block of launch_lookback<L>, for the scans' *_block exports (read by
// utils/lookback_diag.py): out[0] threads, out[1] bytes of dynamic shared
// memory (at most 46 KB). Returns 0.
template <class L>
int lookback_block(int* out) {
  out[0] = lookback_threads<L>();
  out[1] = lookback_smem<L>();
  return 0;
}

}  // namespace aq
