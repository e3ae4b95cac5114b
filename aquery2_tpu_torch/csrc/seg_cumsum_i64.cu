// Inclusive segmented 64-bit running sum, for Hopper (sm_90a).
//
// Replaces aquery2_tpu/ops/pallas_kernels.py seg_cumsum_i64 (the TPU kernel
// _make_segsum64_kernel over (hi, lo) int32 limb pairs). The card has native
// int64 adds, so the limbs go: values are int64 and are added through
// uint64_t, which wraps mod 2^64 exactly as the limb-pair _add64 does.
//
// Memory-bound: about 26 B/row (the int64 input read twice, the flags read
// twice, the int64 output written once) over segscan.cuh's three phases.
#include "segscan.cuh"

namespace aq_i64 {

struct AddI64 {
  using V = unsigned long long;
  const unsigned long long* x;
  unsigned long long* out;
  unsigned long long* tile_v;

  __device__ __forceinline__ V identity() const { return 0ull; }
  __device__ __forceinline__ V combine(V a, V b) const { return a + b; }
  __device__ __forceinline__ V shfl_up(V v, int delta) const {
    return __shfl_up_sync(aq::kFull, v, delta);
  }
  __device__ __forceinline__ V load(int64_t row) const { return x[row]; }
  __device__ __forceinline__ void store(int64_t row, V v) const { out[row] = v; }
  __device__ __forceinline__ V load_tile(int t) const { return tile_v[t]; }
  __device__ __forceinline__ void store_tile(int t, V v) const { tile_v[t] = v; }
};

}  // namespace aq_i64

using aq_i64::AddI64;

extern "C" {

// Rows per tile: the wrapper sizes its scratch as ceil(n / tile) entries.
int aq_seg_cumsum_i64_tile_rows() { return aq::kTile; }

// flags: uint8[n] or NULL (one unsegmented sum). x, out: int64[n].
// tile_v: int64[ntiles], tile_f: int32[ntiles] scratch. Returns the
// cudaError_t of the launches; allocates nothing and does not synchronise.
int aq_seg_cumsum_i64(const void* flags, const void* x, void* out,
                      void* tile_v, void* tile_f, int64_t n, void* stream) {
  AddI64 lanes{static_cast<const unsigned long long*>(x),
               static_cast<unsigned long long*>(out),
               static_cast<unsigned long long*>(tile_v)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* tf = static_cast<int32_t*>(tile_f);
  if (flags != nullptr)
    return (int)aq::launch_segscan<AddI64, true>(
        lanes, static_cast<const uint8_t*>(flags), tf, n, s);
  return (int)aq::launch_segscan<AddI64, false>(lanes, nullptr, tf, n, s);
}

}  // extern "C"
