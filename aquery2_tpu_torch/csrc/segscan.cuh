// Three-phase inclusive segmented scan, shared by seg_cumsum_i64.cu and
// seg_scan_multi.cu.
//
// A row whose flag is set starts a new segment; row 0 always starts fresh.
// The scan is memory-bound, so the design is about device-memory passes:
//
//   1. tile_reduce:  each block folds one tile of kTile rows into a
//                    (flag-seen, value-since-last-flag) pair.
//   2. tile_scan:    one block scans those pairs across tiles and leaves
//                    each tile's carry-in in place of its pair.
//   3. tile_rescan:  each block reloads its tile into registers, scans it
//                    and folds the carry-in into the rows before the
//                    tile's first flag, then writes the outputs.
//
// Phases 1 and 3 each read the input once (the second read is the price of
// not having a look-back); phase 3 writes the output once. Phase 2 touches
// a few KB. Within a block, rows are blocked per thread (kItems consecutive
// rows each) so a thread's fold runs in registers; threads combine with
// warp shuffles and one shared-memory step across warps.
//
// A lane type L describes the values being scanned:
//   typename L::V                      the per-row value (all lanes of a row)
//   V identity() const                 identity of combine
//   V combine(V a, V b) const          associative; a is the earlier value
//   V shfl_up(V v, int delta) const    __shfl_up_sync over every word of v
//   V load(int64_t row) const / void store(int64_t row, V v) const
//   V load_tile(int t) const / void store_tile(int t, V v) const
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace aq {

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

}  // namespace aq
