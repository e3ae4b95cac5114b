// k inclusive segmented scans sharing one flag array, in one pass, for
// Hopper (sm_90a).
//
// Replaces aquery2_tpu/ops/pallas_kernels.py seg_scan_multi (the TPU kernel
// _make_segscan_kernel, one pass with the carries in SMEM). Up to 4 lanes,
// each with its own op (add, min or max), all of one word width: float32
// and int32 lanes travel as 32-bit words, float64 and int64 lanes as 64-bit
// words. The flag scan is done once per row and shared by every lane: that
// fusion is the point of the TPU kernel, and here it means the flags are
// read once for all k lanes.
//
// The 64-bit lanes are what the JAX package computes outside Pallas, with
// XLA's log2(n) doubling passes: the sorted reduction's min/max of int64 and
// float64 lanes (ops/reduce.py _segmented_extreme) and the float64 running
// sums of ops/scan.py. The card has native 64-bit words, so those lanes take
// the same scan.
//
// The ops (lane_ops.cuh, shared with fused_running_stats.cu): min/max
// propagate NaN as jnp.minimum/jnp.maximum do, keeping the earlier NaN;
// int32 add wraps mod 2^32 and int64 add mod 2^64.
//
// Bound: bytes. Per 32-bit lane 8 B/row and per 64-bit lane 16 B/row (read
// once, written once) plus 1 B/row of flags: 3 x 32-bit lanes 25 B/row,
// 3 x 64-bit 49 B/row; at 12,582,912 rows 0.094 and 0.184 ms at the H100's
// 3.35 TB/s. Design: segscan.cuh's single pass with decoupled look-back
// (Merrill & Garland 2016), tiles of every lane staged in shared memory by
// coalesced 16-byte copies (1280 to 4096 rows, whatever fits 46 KB, so
// that four blocks fit an SM). Each lane's op is chosen once per tile
// (Multi::with_op), so the row loops run without a switch per row.
//
// Float add lanes are not bit-reproducible from run to run: whether a
// look-back meets a predecessor's aggregate or its inclusive prefix depends
// on timing, and so does the association of the float adds across tiles.
// Integer lanes, min/max and integer-valued float sums are exact.
#include "lane_ops.cuh"
#include "segscan.cuh"

namespace aq_multi {

using namespace aq_ops;   // the lane codes and their ops

// The lane type of segscan.cuh: K lanes of words W (uint32_t or U64).
template <class W_, int K>
struct Multi {
  using W = W_;
  using V = aq::Words<W, K>;
  static constexpr int kLanes = K;
  static constexpr bool kOneInput = false;
  const W* x[K];
  W* out[K];
  int code[K];

  __device__ __forceinline__ V identity() const {
    V r;
#pragma unroll
    for (int j = 0; j < K; ++j) r.w[j] = identity1(code[j], W());
    return r;
  }
  __device__ __forceinline__ V combine(const V& a, const V& b) const {
    V r;
#pragma unroll
    for (int j = 0; j < K; ++j) r.w[j] = combine1(code[j], a.w[j], b.w[j]);
    return r;
  }
  __device__ __forceinline__ V shfl_up(const V& v, int delta) const {
    return aq::words_shfl_up(v, delta);
  }
  template <class F>
  __device__ __forceinline__ void with_op(int j, F f) const {
    constexpr int o = sizeof(W) == 8 ? kAddF64 : kAddF32;  // first code
    switch (code[j] - o) {
      case 0: f(Op<o + 0, W>{}); break;
      case 1: f(Op<o + 1, W>{}); break;
      case 2: f(Op<o + 2, W>{}); break;
      case 3: f(Op<o + 3, W>{}); break;
      case 4: f(Op<o + 4, W>{}); break;
      case 5: f(Op<o + 5, W>{}); break;
    }
  }
};

template <class W, int K>
cudaError_t run(const uint8_t* flags, void* const* xs, void* const* outs,
                const int* codes, W* scratch, int* status, int64_t n,
                cudaStream_t s) {
  Multi<W, K> lanes;
  for (int j = 0; j < K; ++j) {
    lanes.x[j] = static_cast<const W*>(xs[j]);
    lanes.out[j] = static_cast<W*>(outs[j]);
    lanes.code[j] = codes[j];
  }
  if (flags != nullptr)
    return aq::launch_lookback<Multi<W, K>, true>(lanes, flags, scratch,
                                                  status, n, s);
  return aq::launch_lookback<Multi<W, K>, false>(lanes, nullptr, scratch,
                                                 status, n, s);
}

template <class W>
cudaError_t run_k(int k, const uint8_t* flags, void* const* xs,
                  void* const* outs, const int* codes, void* scratch,
                  int* status, int64_t n, cudaStream_t s) {
  W* sv = static_cast<W*>(scratch);
  switch (k) {
    case 1: return run<W, 1>(flags, xs, outs, codes, sv, status, n, s);
    case 2: return run<W, 2>(flags, xs, outs, codes, sv, status, n, s);
    case 3: return run<W, 3>(flags, xs, outs, codes, sv, status, n, s);
    case 4: return run<W, 4>(flags, xs, outs, codes, sv, status, n, s);
  }
  return cudaErrorInvalidValue;
}

template <class W>
int tile_rows(int k) {
  switch (k) {
    case 1: return aq::lookback_rows<W, 1>();
    case 2: return aq::lookback_rows<W, 2>();
    case 3: return aq::lookback_rows<W, 3>();
    case 4: return aq::lookback_rows<W, 4>();
  }
  return 0;
}

template <class W>
int block(int k, int* out) {
  switch (k) {
    case 1: return aq::lookback_block<Multi<W, 1>>(out);
    case 2: return aq::lookback_block<Multi<W, 2>>(out);
    case 3: return aq::lookback_block<Multi<W, 3>>(out);
    case 4: return aq::lookback_block<Multi<W, 4>>(out);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace aq_multi

extern "C" {

// Rows per tile of a call with k lanes of 32-bit (wide = 0) or 64-bit
// (wide = 1) words; 0 for a bad k. The wrapper sizes its scratch from
// ntiles = ceil(n / tile).
int aq_seg_scan_multi_tile_rows(int k, int wide) {
  return wide ? aq_multi::tile_rows<aq_multi::U64>(k)
              : aq_multi::tile_rows<uint32_t>(k);
}

// out[0] threads and out[1] bytes of dynamic shared memory of a block of
// that call. Returns cudaErrorInvalidValue for a bad k.
int aq_seg_scan_multi_block(int k, int wide, int* out) {
  return wide ? aq_multi::block<aq_multi::U64>(k, out)
              : aq_multi::block<uint32_t>(k, out);
}

// flags: uint8[n] or NULL. k in 1..4. xs, outs: k device pointers to lanes
// of n words; codes: k lane codes (see aq_multi above), all 32-bit (0..5)
// or all 64-bit (6..11), which sets the word width of every pointer;
// scratch: 2 * k * ntiles words; status: int32[ntiles + 1], zeroed before
// every call on `stream`. The pointer and code arrays live in host memory.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for a bad
// k, a bad code or mixed widths); allocates nothing and does not
// synchronise.
int aq_seg_scan_multi(const void* flags, int k, void* const* xs,
                      void* const* outs, const int* codes, void* scratch,
                      void* status, int64_t n, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  const bool wide = codes[0] >= aq_multi::kAddF64;
  for (int j = 0; j < k; ++j)
    if (codes[j] < 0 || codes[j] > aq_multi::kMaxI64 ||
        (codes[j] >= aq_multi::kAddF64) != wide)
      return (int)cudaErrorInvalidValue;
  const uint8_t* f = static_cast<const uint8_t*>(flags);
  int* st = static_cast<int*>(status);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide)
    return (int)aq_multi::run_k<aq_multi::U64>(k, f, xs, outs, codes,
                                               scratch, st, n, s);
  return (int)aq_multi::run_k<uint32_t>(k, f, xs, outs, codes, scratch, st,
                                        n, s);
}

#ifdef AQ_LOOKBACK_DIAG
// Diagnostic builds: the last launch's per-tile records (segscan.cuh,
// 8 int64 words a tile) of its first ntiles tiles, into host memory dst.
int aq_seg_scan_multi_lookback_diag(void* dst, int ntiles) {
  return (int)aq::read_lookback_diag(dst, ntiles);
}
#endif

}  // extern "C"
