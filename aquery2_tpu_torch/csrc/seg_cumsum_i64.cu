// Inclusive segmented 64-bit running sum, for Hopper (sm_90a).
//
// Replaces aquery2_tpu/ops/pallas_kernels.py seg_cumsum_i64 (the TPU kernel
// _make_segsum64_kernel over (hi, lo) int32 limb pairs, one pass with the
// carry in SMEM). The card has native int64 adds, so the limbs go: values
// are int64 and are added through uint64_t, which wraps mod 2^64 exactly as
// the limb-pair _add64 does.
//
// Bound: bytes. 17 B/row (the int64 input and the flags read once, the
// int64 output written once); at 12,582,912 rows 214 MB, 0.064 ms at the
// H100's 3.35 TB/s. Design: segscan.cuh's single pass with decoupled
// look-back (Merrill & Garland 2016), 4096-row tiles staged in shared
// memory by coalesced 16-byte copies. Integer adds are exact in any
// association, so the result does not depend on how the look-back met its
// predecessors.
#include "segscan.cuh"

namespace aq_i64 {

struct AddOp {
  static __device__ __forceinline__ unsigned long long identity() {
    return 0ull;
  }
  static __device__ __forceinline__ unsigned long long combine(
      unsigned long long a, unsigned long long b) {
    return a + b;
  }
};

struct AddI64 {
  using W = unsigned long long;
  using V = aq::Words<W, 1>;
  static constexpr int kLanes = 1;
  static constexpr bool kOneInput = false;
  const W* x[1];
  W* out[1];

  __device__ __forceinline__ V identity() const { return {{0ull}}; }
  __device__ __forceinline__ V combine(const V& a, const V& b) const {
    return {{a.w[0] + b.w[0]}};
  }
  __device__ __forceinline__ V shfl_up(const V& v, int delta) const {
    return aq::words_shfl_up(v, delta);
  }
  template <class F>
  __device__ __forceinline__ void with_op(int, F f) const {
    f(AddOp{});
  }
};

}  // namespace aq_i64

using aq_i64::AddI64;

extern "C" {

// Rows per tile: the wrapper sizes its scratch from ntiles = ceil(n / tile).
int aq_seg_cumsum_i64_tile_rows() {
  return aq::lookback_rows<AddI64::W, AddI64::kLanes>();
}

// out[0] threads and out[1] bytes of dynamic shared memory of a block.
int aq_seg_cumsum_i64_block(int* out) {
  return aq::lookback_block<AddI64>(out);
}

// flags: uint8[n] or NULL (one unsegmented sum). x, out: int64[n].
// scratch: int64[2 * ntiles]; status: int32[ntiles + 1], zeroed before
// every call on `stream`. Returns the cudaError_t of the launch; allocates
// nothing and does not synchronise.
int aq_seg_cumsum_i64(const void* flags, const void* x, void* out,
                      void* scratch, void* status, int64_t n, void* stream) {
  AddI64 lanes{{static_cast<const unsigned long long*>(x)},
               {static_cast<unsigned long long*>(out)}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* sv = static_cast<unsigned long long*>(scratch);
  int* st = static_cast<int*>(status);
  if (flags != nullptr)
    return (int)aq::launch_lookback<AddI64, true>(
        lanes, static_cast<const uint8_t*>(flags), sv, st, n, s);
  return (int)aq::launch_lookback<AddI64, false>(lanes, nullptr, sv, st, n,
                                                 s);
}

#ifdef AQ_LOOKBACK_DIAG
// Diagnostic builds: the last launch's per-tile records (segscan.cuh,
// 8 int64 words a tile) of its first ntiles tiles, into host memory dst.
int aq_seg_cumsum_i64_lookback_diag(void* dst, int ntiles) {
  return (int)aq::read_lookback_diag(dst, ntiles);
}
#endif

}  // extern "C"
