// Running sum, min and max of one float32 column in one pass, for Hopper
// (sm_90a).
//
// Replaces aquery2_tpu/ops/pallas_kernels.py fused_running_stats (the TPU
// kernel _running_kernel with _block_scan_2d): the TPU grid walks (64, 128)
// blocks in order and carries (sum, min, max) in SMEM. CUDA blocks run in
// no order, so the carry goes through segscan.cuh's single pass with
// decoupled look-back (Merrill & Garland 2016), with no flags: every walk
// ends at a predecessor's inclusive prefix.
//
// Bound: bytes. 16 B/row (x read once, three float32 outputs written
// once); at 12,582,912 rows 201 MB, 0.060 ms at the H100's 3.35 TB/s.
// Design: the three statistics are three lanes of one lane type with
// kOneInput, so x's tile is staged in shared memory once, by coalesced
// 16-byte cp.async copies, and each statistic is folded and rescanned from
// that copy. The rescan puts one statistic at a time into a second tile
// buffer, which goes out by coalesced 16-byte stores before the next: two
// buffers, not three, so a 4096-row tile takes 32 KB and shared memory
// has room for six blocks an SM (five with three buffers, and that kernel
// was slower: 0.1293 ms against 0.1191 ms on an H100, PERF.md).
//
// The ops are seg_scan_multi's float32 lanes (lane_ops.cuh): min/max
// propagate NaN as jnp.minimum/jnp.maximum do, keeping the earlier NaN.
// The sums are added per thread, then across the block, then across tiles
// in whatever order the look-back meets its predecessors, so they agree
// with a sequential float32 cumsum to rounding and are not bit-reproducible
// from run to run; min, max and integer-valued sums below 2^24 are exact.
#include "lane_ops.cuh"
#include "segscan.cuh"

namespace aq_running {

using aq_ops::kAddF32;
using aq_ops::kMaxF32;
using aq_ops::kMinF32;
using aq_ops::Op;

// The lane type of segscan.cuh: sum, min and max of the one column x[0].
struct RunStats {
  using W = uint32_t;
  using V = aq::Words<W, 3>;
  static constexpr int kLanes = 3;
  static constexpr bool kOneInput = true;
  const W* x[1];
  W* out[3];   // sums, mins, maxs

  template <class F>
  __device__ __forceinline__ void with_op(int j, F f) const {
    switch (j) {
      case 0: f(Op<kAddF32, W>{}); break;
      case 1: f(Op<kMinF32, W>{}); break;
      case 2: f(Op<kMaxF32, W>{}); break;
    }
  }
  __device__ __forceinline__ V identity() const {
    return {{Op<kAddF32, W>::identity(), Op<kMinF32, W>::identity(),
             Op<kMaxF32, W>::identity()}};
  }
  __device__ __forceinline__ V combine(const V& a, const V& b) const {
    return {{Op<kAddF32, W>::combine(a.w[0], b.w[0]),
             Op<kMinF32, W>::combine(a.w[1], b.w[1]),
             Op<kMaxF32, W>::combine(a.w[2], b.w[2])}};
  }
  __device__ __forceinline__ V shfl_up(const V& v, int delta) const {
    return aq::words_shfl_up(v, delta);
  }
};

}  // namespace aq_running

using aq_running::RunStats;

extern "C" {

// Rows per tile: the wrapper sizes its scratch from ntiles = ceil(n / tile).
int aq_fused_running_stats_tile_rows() {
  return aq::lookback_rows<RunStats::W, aq::tile_buffers<RunStats>()>();
}

// out[0] threads and out[1] bytes of dynamic shared memory of a block.
int aq_fused_running_stats_block(int* out) {
  return aq::lookback_block<RunStats>(out);
}

// x: float32[n]. sums, mins, maxs: float32[n] outputs. scratch: float32[6 *
// ntiles]; status: int32[ntiles + 1], zeroed before every call on
// `stream`. Returns the cudaError_t of the launch; allocates nothing and
// does not synchronise.
int aq_fused_running_stats(const void* x, void* sums, void* mins, void* maxs,
                           void* scratch, void* status, int64_t n,
                           void* stream) {
  RunStats lanes{{static_cast<const uint32_t*>(x)},
                 {static_cast<uint32_t*>(sums), static_cast<uint32_t*>(mins),
                  static_cast<uint32_t*>(maxs)}};
  return (int)aq::launch_lookback<RunStats, false>(
      lanes, nullptr, static_cast<uint32_t*>(scratch),
      static_cast<int*>(status), n, static_cast<cudaStream_t>(stream));
}

#ifdef AQ_LOOKBACK_DIAG
// Diagnostic builds: the last launch's per-tile records (segscan.cuh,
// 8 int64 words a tile) of its first ntiles tiles, into host memory dst.
int aq_fused_running_stats_lookback_diag(void* dst, int ntiles) {
  return (int)aq::read_lookback_diag(dst, ntiles);
}
#endif

}  // extern "C"
