// Running sum, min and max of one float32 column in one scan, for Hopper
// (sm_90a).
//
// Replaces aquery2_tpu/ops/pallas_kernels.py fused_running_stats (the TPU
// kernel _running_kernel with _block_scan_2d): the TPU grid walks (64, 128)
// blocks in order and carries (sum, min, max) in SMEM. CUDA blocks run in
// no order, so the carry goes through segscan.cuh's three phases with no
// flags; the three statistics share one lane type, so x is read once per
// phase for all three, not once per statistic.
//
// min/max propagate NaN as jnp.minimum/jnp.maximum do. The sums are added
// in another order than a row loop (per thread, then across the block, then
// across tiles), so they agree with a sequential float32 cumsum to rounding.
//
// Memory-bound: 20 B/row (x read in phases 1 and 3, three float32 outputs
// written once in phase 3).
#include "segscan.cuh"

namespace aq_running {

struct Stats {
  float s, lo, hi;
};

__device__ __forceinline__ float nan_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b > a ? b : a;
}

struct Running {
  using V = Stats;
  const float* x;
  float* sums;
  float* mins;
  float* maxs;
  Stats* tile_v;   // ntiles carries

  __device__ __forceinline__ V identity() const {
    return {0.0f, __uint_as_float(0x7f800000u), __uint_as_float(0xff800000u)};
  }
  __device__ __forceinline__ V combine(const V& a, const V& b) const {
    return {a.s + b.s, nan_min(a.lo, b.lo), nan_max(a.hi, b.hi)};
  }
  __device__ __forceinline__ V shfl_up(const V& v, int delta) const {
    return {__shfl_up_sync(aq::kFull, v.s, delta),
            __shfl_up_sync(aq::kFull, v.lo, delta),
            __shfl_up_sync(aq::kFull, v.hi, delta)};
  }
  __device__ __forceinline__ V load(int64_t row) const {
    const float v = x[row];
    return {v, v, v};
  }
  __device__ __forceinline__ void store(int64_t row, const V& v) const {
    sums[row] = v.s;
    mins[row] = v.lo;
    maxs[row] = v.hi;
  }
  __device__ __forceinline__ V load_tile(int t) const { return tile_v[t]; }
  __device__ __forceinline__ void store_tile(int t, const V& v) const {
    tile_v[t] = v;
  }
};

}  // namespace aq_running

extern "C" {

// Rows per tile: the wrapper sizes its scratch as ceil(n / tile) entries.
int aq_fused_running_stats_tile_rows() { return aq::kTile; }

// x: float32[n]. sums, mins, maxs: float32[n] outputs. tile_v: float32[3 *
// ntiles] and tile_f: int32[ntiles] scratch. Returns the cudaError_t of the
// launches; allocates nothing and does not synchronise.
int aq_fused_running_stats(const void* x, void* sums, void* mins, void* maxs,
                           void* tile_v, void* tile_f, int64_t n,
                           void* stream) {
  aq_running::Running lanes{static_cast<const float*>(x),
                            static_cast<float*>(sums),
                            static_cast<float*>(mins),
                            static_cast<float*>(maxs),
                            static_cast<aq_running::Stats*>(tile_v)};
  return (int)aq::launch_segscan<aq_running::Running, false>(
      lanes, nullptr, static_cast<int32_t*>(tile_f), n,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
