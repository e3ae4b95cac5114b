// k inclusive segmented scans sharing one flag array, in one pass, for
// Hopper (sm_90a).
//
// Replaces aquery2_tpu/ops/pallas_kernels.py seg_scan_multi (the TPU kernel
// _make_segscan_kernel). Up to 4 lanes of float32 or int32, each with its
// own op (add, min or max). The flag scan is done once per row and shared
// by every lane: that fusion is the point of the TPU kernel, and here it
// means the flags are read once per phase for all k lanes.
//
// min/max propagate NaN as jnp.minimum/jnp.maximum do (fminf/fmaxf drop
// NaN, so they are not used). int32 add wraps mod 2^32.
//
// Memory-bound: per lane 12 B/row (the 4-byte input read twice, the output
// written once) plus 2 B/row of flags, over segscan.cuh's three phases.
#include "segscan.cuh"

namespace aq_multi {

// code = dtype * 3 + op; dtype 0 = float32, 1 = int32; op 0 = add, 1 = min,
// 2 = max. Values travel as their 32-bit patterns.
enum : int {
  kAddF32 = 0, kMinF32 = 1, kMaxF32 = 2,
  kAddI32 = 3, kMinI32 = 4, kMaxI32 = 5,
};

__device__ __forceinline__ float as_f(uint32_t u) { return __uint_as_float(u); }
__device__ __forceinline__ uint32_t as_u(float f) { return __float_as_uint(f); }

__device__ __forceinline__ uint32_t identity1(int code) {
  switch (code) {
    case kMinF32: return 0x7f800000u;          // +inf
    case kMaxF32: return 0xff800000u;          // -inf
    case kMinI32: return 0x7fffffffu;          // INT32_MAX
    case kMaxI32: return 0x80000000u;          // INT32_MIN
    default: return 0u;                        // 0 and 0.0f
  }
}

__device__ __forceinline__ uint32_t combine1(int code, uint32_t a, uint32_t b) {
  switch (code) {
    case kAddF32:
      return as_u(as_f(a) + as_f(b));
    case kMinF32: {
      const float x = as_f(a), y = as_f(b);
      if (x != x) return a;
      if (y != y) return b;
      return y < x ? b : a;
    }
    case kMaxF32: {
      const float x = as_f(a), y = as_f(b);
      if (x != x) return a;
      if (y != y) return b;
      return y > x ? b : a;
    }
    case kAddI32:
      return a + b;
    case kMinI32:
      return (int32_t)b < (int32_t)a ? b : a;
    case kMaxI32:
      return (int32_t)b > (int32_t)a ? b : a;
  }
  return a;
}

template <int K>
struct Words {
  uint32_t w[K];
};

template <int K>
struct Multi {
  using V = Words<K>;
  const uint32_t* x[K];
  uint32_t* out[K];
  uint32_t* tile_v[K];   // K scratch arrays of ntiles words
  int code[K];

  __device__ __forceinline__ V identity() const {
    V r;
#pragma unroll
    for (int j = 0; j < K; ++j) r.w[j] = identity1(code[j]);
    return r;
  }
  __device__ __forceinline__ V combine(const V& a, const V& b) const {
    V r;
#pragma unroll
    for (int j = 0; j < K; ++j) r.w[j] = combine1(code[j], a.w[j], b.w[j]);
    return r;
  }
  __device__ __forceinline__ V shfl_up(const V& v, int delta) const {
    V r;
#pragma unroll
    for (int j = 0; j < K; ++j) r.w[j] = __shfl_up_sync(aq::kFull, v.w[j], delta);
    return r;
  }
  __device__ __forceinline__ V load(int64_t row) const {
    V r;
#pragma unroll
    for (int j = 0; j < K; ++j) r.w[j] = x[j][row];
    return r;
  }
  __device__ __forceinline__ void store(int64_t row, const V& v) const {
#pragma unroll
    for (int j = 0; j < K; ++j) out[j][row] = v.w[j];
  }
  __device__ __forceinline__ V load_tile(int t) const {
    V r;
#pragma unroll
    for (int j = 0; j < K; ++j) r.w[j] = tile_v[j][t];
    return r;
  }
  __device__ __forceinline__ void store_tile(int t, const V& v) const {
#pragma unroll
    for (int j = 0; j < K; ++j) tile_v[j][t] = v.w[j];
  }
};

template <int K>
cudaError_t run(const uint8_t* flags, void* const* xs, void* const* outs,
                void* const* tiles, const int* codes, int32_t* tile_f,
                int64_t n, cudaStream_t s) {
  Multi<K> lanes;
  for (int j = 0; j < K; ++j) {
    lanes.x[j] = static_cast<const uint32_t*>(xs[j]);
    lanes.out[j] = static_cast<uint32_t*>(outs[j]);
    lanes.tile_v[j] = static_cast<uint32_t*>(tiles[j]);
    lanes.code[j] = codes[j];
  }
  if (flags != nullptr)
    return aq::launch_segscan<Multi<K>, true>(lanes, flags, tile_f, n, s);
  return aq::launch_segscan<Multi<K>, false>(lanes, nullptr, tile_f, n, s);
}

}  // namespace aq_multi

extern "C" {

// Rows per tile: the wrapper sizes its scratch as ceil(n / tile) entries.
int aq_seg_scan_multi_tile_rows() { return aq::kTile; }

// flags: uint8[n] or NULL. k in 1..4. xs, outs: k device pointers to 32-bit
// lanes of n rows; tiles: k device pointers to ntiles words of scratch;
// codes: k lane codes (see aq_multi above); tile_f: int32[ntiles] scratch.
// The pointer and code arrays live in host memory. Returns the cudaError_t
// of the launches (cudaErrorInvalidValue for a bad k or code); allocates
// nothing and does not synchronise.
int aq_seg_scan_multi(const void* flags, int k, void* const* xs,
                      void* const* outs, void* const* tiles, const int* codes,
                      void* tile_f, int64_t n, void* stream) {
  for (int j = 0; j < k; ++j)
    if (codes[j] < 0 || codes[j] > aq_multi::kMaxI32)
      return (int)cudaErrorInvalidValue;
  const uint8_t* f = static_cast<const uint8_t*>(flags);
  int32_t* tf = static_cast<int32_t*>(tile_f);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return (int)aq_multi::run<1>(f, xs, outs, tiles, codes, tf, n, s);
    case 2: return (int)aq_multi::run<2>(f, xs, outs, tiles, codes, tf, n, s);
    case 3: return (int)aq_multi::run<3>(f, xs, outs, tiles, codes, tf, n, s);
    case 4: return (int)aq_multi::run<4>(f, xs, outs, tiles, codes, tf, n, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
