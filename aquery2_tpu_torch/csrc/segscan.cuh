// Inclusive segmented scans, shared by seg_cumsum_i64.cu, seg_scan_multi.cu
// and fused_running_stats.cu.
//
// A row whose flag is set starts a new segment; row 0 always starts fresh.
// Segments combine as pairs (flag-seen, value-since-last-flag). The scans
// are memory-bound, so the design is about device-memory passes. Two
// routines:
//
// * launch_lookback (seg_cumsum_i64, seg_scan_multi): one launch, one read
//   of every input byte, one write of every output byte: the single-pass
//   scan with decoupled look-back of Merrill & Garland, "Single-pass
//   Parallel Prefix Scan with Decoupled Look-back" (NVIDIA, 2016), with
//   the segmented stopping rule. See segscan_lookback below.
// * launch_segscan (fused_running_stats): three phases, which read the
//   input twice:
//     1. tile_reduce:  each block folds one tile of kTile rows into a pair.
//     2. tile_scan:    one block scans those pairs across tiles and leaves
//                      each tile's carry-in in place of its pair.
//     3. tile_rescan:  each block reloads its tile into registers, scans it
//                      with the carry-in, then writes the outputs.
//   Rows are blocked per thread (kItems consecutive rows each) and loaded
//   straight from device memory, so a warp's load touches 32 rows kItems
//   apart: uncoalesced. Its redesign is a later change.
//
// A lane type L describes the values being scanned:
//   typename L::V                      the per-row value (all lanes of a row)
//   V identity() const                 identity of combine
//   V combine(V a, V b) const          associative; a is the earlier value
//   V shfl_up(V v, int delta) const    __shfl_up_sync over every word of v
// for launch_segscan also
//   V load(int64_t row) const / void store(int64_t row, V v) const
//   V load_tile(int t) const / void store_tile(int t, V v) const
// and for launch_lookback, where V is Words<W, K> (K lanes of words W,
// each lane its own array of n words):
//   typename L::W, static constexpr int kLanes = K
//   const W* x[K]; W* out[K];           the lanes' inputs and outputs
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

constexpr int kThreads = 256;                 // threads per block, phases 1 and 3
constexpr int kItems = 16;                    // rows per thread
constexpr int kTile = kThreads * kItems;      // rows per tile
constexpr int kScanThreads = 1024;            // threads of the one phase-2 block
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

// Phase 1: fold each tile into one pair.
template <class L, bool HAS_FLAGS>
__global__ void __launch_bounds__(kThreads)
tile_reduce(L lanes, const uint8_t* __restrict__ flags,
            int32_t* __restrict__ tile_f, int64_t n) {
  const int64_t base =
      (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  Seg<L> agg = seg_identity(lanes);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t row = base + i;
    if (row < n) {
      Seg<L> x;
      x.v = lanes.load(row);
      x.f = HAS_FLAGS ? (int)(flags[row] != 0) : 0;
      agg = seg_combine(lanes, agg, x);
    }
  }
  Seg<L> total;
  block_exclusive_scan(lanes, agg, &total);
  if (threadIdx.x == 0) {
    lanes.store_tile(blockIdx.x, total.v);
    tile_f[blockIdx.x] = total.f;
  }
}

// Phase 2: one block turns the tile pairs into exclusive carry-ins.
template <class L>
__global__ void __launch_bounds__(kScanThreads)
tile_scan(L lanes, int32_t* __restrict__ tile_f, int ntiles) {
  Seg<L> running = seg_identity(lanes);
  for (int start = 0; start < ntiles; start += blockDim.x) {
    const int t = start + threadIdx.x;
    Seg<L> x = seg_identity(lanes);
    if (t < ntiles) {
      x.v = lanes.load_tile(t);
      x.f = tile_f[t];
    }
    Seg<L> total;
    Seg<L> exc = block_exclusive_scan(lanes, x, &total);
    if (t < ntiles) {
      Seg<L> carry = seg_combine(lanes, running, exc);
      lanes.store_tile(t, carry.v);
      tile_f[t] = carry.f;
    }
    running = seg_combine(lanes, running, total);
  }
}

// Phase 3: rescan each tile from registers with its carry-in.
template <class L, bool HAS_FLAGS>
__global__ void __launch_bounds__(kThreads)
tile_rescan(L lanes, const uint8_t* __restrict__ flags,
            const int32_t* __restrict__ tile_f, int64_t n) {
  using V = typename L::V;
  const int64_t base =
      (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  V vals[kItems];
  int fl[kItems];
  Seg<L> agg = seg_identity(lanes);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t row = base + i;
    if (row < n) {
      vals[i] = lanes.load(row);
      fl[i] = HAS_FLAGS ? (int)(flags[row] != 0) : 0;
    } else {
      vals[i] = lanes.identity();
      fl[i] = 0;
    }
    Seg<L> x;
    x.v = vals[i];
    x.f = fl[i];
    agg = seg_combine(lanes, agg, x);
  }
  Seg<L> total;
  Seg<L> exc = block_exclusive_scan(lanes, agg, &total);
  Seg<L> carry;
  carry.v = lanes.load_tile(blockIdx.x);
  carry.f = tile_f[blockIdx.x];
  V acc = seg_combine(lanes, carry, exc).v;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t row = base + i;
    acc = fl[i] ? vals[i] : lanes.combine(acc, vals[i]);
    if (row < n) lanes.store(row, acc);
  }
}

inline int num_tiles(int64_t n) { return (int)((n + kTile - 1) / kTile); }

// Runs the three phases on `stream`; returns the first launch error.
template <class L, bool HAS_FLAGS>
cudaError_t launch_segscan(const L& lanes, const uint8_t* flags,
                           int32_t* tile_f, int64_t n, cudaStream_t stream) {
  const int ntiles = num_tiles(n);
  tile_reduce<L, HAS_FLAGS><<<ntiles, kThreads, 0, stream>>>(lanes, flags,
                                                            tile_f, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tile_scan<L><<<1, kScanThreads, 0, stream>>>(lanes, tile_f, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tile_rescan<L, HAS_FLAGS><<<ntiles, kThreads, 0, stream>>>(lanes, flags,
                                                            tile_f, n);
  return cudaGetLastError();
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

// Whether row i of the thread's rows starts a segment (flag byte i).
template <bool HAS_FLAGS, int N>
__device__ __forceinline__ bool row_flag(const uint32_t (&fw)[N], int i) {
  return HAS_FLAGS && ((fw[i >> 2] >> (8 * (i & 3))) & 0xffu) != 0u;
}

template <class L, bool HAS_FLAGS>
__global__ void __launch_bounds__(
    lookback_rows<typename L::W, L::kLanes>() /
    lb_items<typename L::W, L::kLanes>())
segscan_lookback(L lanes, const uint8_t* __restrict__ flags,
                 typename L::W* agg, typename L::W* inc, int* status,
                 int64_t n, int ntiles) {
  using W = typename L::W;
  using V = typename L::V;
  constexpr int K = L::kLanes;
  constexpr int ROWS = lookback_rows<W, K>();
  constexpr int ITEMS = lb_items<W, K>();    // rows per thread
  constexpr int THREADS = ROWS / ITEMS;
  constexpr int P = 16 / (int)sizeof(W);     // words per 16-byte chunk
  constexpr int CHUNKS = ROWS / P;           // chunks per lane's tile
  constexpr int MINE = ITEMS / P;            // a thread's chunks per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* buf = reinterpret_cast<W*>(smem_raw);   // K lanes x ROWS words
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

  // 1. the tile into shared memory; rows past n hold the identity
#pragma unroll
  for (int j = 0; j < K; ++j) {
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
    const W* lb = buf + j * ROWS;
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

  // 4. rescan the thread's rows into their slots, then write them out
  const V start = seg_combine(lanes, s_carry, exc).v;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    W* lb = buf + j * ROWS;
    lanes.with_op(j, [&](auto op) {
      using Op = decltype(op);
      W acc = start.w[j];
#pragma unroll
      for (int q = 0; q < MINE; ++q) {
        W words[P];
        W* slot = lb + swz(threadIdx.x * MINE + q) * P;
        uint4 c = *reinterpret_cast<const uint4*>(slot);
        memcpy(words, &c, 16);
#pragma unroll
        for (int e = 0; e < P; ++e) {
          acc = row_flag<HAS_FLAGS>(fw, q * P + e) ? words[e]
                                                   : Op::combine(acc, words[e]);
          words[e] = acc;
        }
        memcpy(&c, words, 16);
        *reinterpret_cast<uint4*>(slot) = c;
      }
    });
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const W* lb = buf + j * ROWS;
    W* dst = lanes.out[j] + base;
    if (full && aligned16(dst)) {
      for (int c = threadIdx.x; c < CHUNKS; c += THREADS)
        *reinterpret_cast<uint4*>(dst + c * P) =
            *reinterpret_cast<const uint4*>(lb + swz(c) * P);
    } else {
      for (int w = threadIdx.x; w < rows; w += THREADS)
        dst[w] = lb[swz(w / P) * P + w % P];
    }
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
  using W = typename L::W;
  constexpr int K = L::kLanes;
  constexpr int ROWS = lookback_rows<W, K>();
  const int ntiles = (int)((n + ROWS - 1) / ROWS);
  const int smem = K * ROWS * (int)sizeof(W);   // at most 46 KB
  segscan_lookback<L, HAS_FLAGS>
      <<<ntiles, ROWS / lb_items<W, K>(), smem, stream>>>(
      lanes, flags, scratch, scratch + (size_t)K * ntiles, status, n, ntiles);
  return cudaGetLastError();
}

}  // namespace aq
