// k inclusive segmented scans sharing one flag array, in one pass, for
// Hopper (sm_90a).
//
// Replaces aquery2_tpu/ops/pallas_kernels.py seg_scan_multi (the TPU kernel
// _make_segscan_kernel). Up to 4 lanes, each with its own op (add, min or
// max), all of one word width: float32 and int32 lanes travel as 32-bit
// words, float64 and int64 lanes as 64-bit words. The flag scan is done
// once per row and shared by every lane: that fusion is the point of the
// TPU kernel, and here it means the flags are read once per phase for all
// k lanes.
//
// The 64-bit lanes are what the JAX package computes outside Pallas, with
// XLA's log2(n) doubling passes: the sorted reduction's min/max of int64 and
// float64 lanes (ops/reduce.py _segmented_extreme) and the float64 running
// sums of ops/scan.py. The card has native 64-bit words, so those lanes take
// the same three-phase scan.
//
// min/max propagate NaN as jnp.minimum/jnp.maximum do (fminf/fmaxf and
// fmin/fmax drop NaN, so they are not used). int32 add wraps mod 2^32 and
// int64 add mod 2^64 (unsigned words, as seg_cumsum_i64 adds).
//
// Memory-bound: per 32-bit lane 12 B/row and per 64-bit lane 24 B/row (the
// input read twice, the output written once) plus 2 B/row of flags, over
// segscan.cuh's three phases.
#include "segscan.cuh"

namespace aq_multi {

using U64 = unsigned long long;

// code = dtype * 3 + op; dtype 0 = float32, 1 = int32, 2 = float64,
// 3 = int64; op 0 = add, 1 = min, 2 = max. Values travel as their bit
// patterns in words of the lane's width.
enum : int {
  kAddF32 = 0, kMinF32 = 1, kMaxF32 = 2,
  kAddI32 = 3, kMinI32 = 4, kMaxI32 = 5,
  kAddF64 = 6, kMinF64 = 7, kMaxF64 = 8,
  kAddI64 = 9, kMinI64 = 10, kMaxI64 = 11,
};

__device__ __forceinline__ float as_f(uint32_t u) { return __uint_as_float(u); }
__device__ __forceinline__ uint32_t as_u(float f) { return __float_as_uint(f); }
__device__ __forceinline__ double as_d(U64 u) {
  return __longlong_as_double((long long)u);
}
__device__ __forceinline__ U64 as_u(double d) {
  return (U64)__double_as_longlong(d);
}

__device__ __forceinline__ uint32_t identity1(int code, uint32_t) {
  switch (code) {
    case kMinF32: return 0x7f800000u;          // +inf
    case kMaxF32: return 0xff800000u;          // -inf
    case kMinI32: return 0x7fffffffu;          // INT32_MAX
    case kMaxI32: return 0x80000000u;          // INT32_MIN
    default: return 0u;                        // 0 and 0.0f
  }
}

__device__ __forceinline__ U64 identity1(int code, U64) {
  switch (code) {
    case kMinF64: return 0x7ff0000000000000ull;   // +inf
    case kMaxF64: return 0xfff0000000000000ull;   // -inf
    case kMinI64: return 0x7fffffffffffffffull;   // INT64_MAX
    case kMaxI64: return 0x8000000000000000ull;   // INT64_MIN
    default: return 0ull;                         // 0 and 0.0
  }
}

// NaN-propagating min/max of two floating values given as words.
template <class F, class W>
__device__ __forceinline__ W nan_pick(W a, W b, F x, F y, bool is_min) {
  if (x != x) return a;
  if (y != y) return b;
  return (is_min ? y < x : y > x) ? b : a;
}

__device__ __forceinline__ uint32_t combine1(int code, uint32_t a, uint32_t b) {
  switch (code) {
    case kAddF32:
      return as_u(as_f(a) + as_f(b));
    case kMinF32:
      return nan_pick(a, b, as_f(a), as_f(b), true);
    case kMaxF32:
      return nan_pick(a, b, as_f(a), as_f(b), false);
    case kAddI32:
      return a + b;
    case kMinI32:
      return (int32_t)b < (int32_t)a ? b : a;
    case kMaxI32:
      return (int32_t)b > (int32_t)a ? b : a;
  }
  return a;
}

__device__ __forceinline__ U64 combine1(int code, U64 a, U64 b) {
  switch (code) {
    case kAddF64:
      return as_u(as_d(a) + as_d(b));
    case kMinF64:
      return nan_pick(a, b, as_d(a), as_d(b), true);
    case kMaxF64:
      return nan_pick(a, b, as_d(a), as_d(b), false);
    case kAddI64:
      return a + b;
    case kMinI64:
      return (long long)b < (long long)a ? b : a;
    case kMaxI64:
      return (long long)b > (long long)a ? b : a;
  }
  return a;
}

template <class W, int K>
struct Words {
  W w[K];
};

// The lane type of segscan.cuh: K lanes of words W (uint32_t or U64).
template <class W, int K>
struct Multi {
  using V = Words<W, K>;
  const W* x[K];
  W* out[K];
  W* tile_v[K];   // K scratch arrays of ntiles words
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

template <class W, int K>
cudaError_t run(const uint8_t* flags, void* const* xs, void* const* outs,
                void* const* tiles, const int* codes, int32_t* tile_f,
                int64_t n, cudaStream_t s) {
  Multi<W, K> lanes;
  for (int j = 0; j < K; ++j) {
    lanes.x[j] = static_cast<const W*>(xs[j]);
    lanes.out[j] = static_cast<W*>(outs[j]);
    lanes.tile_v[j] = static_cast<W*>(tiles[j]);
    lanes.code[j] = codes[j];
  }
  if (flags != nullptr)
    return aq::launch_segscan<Multi<W, K>, true>(lanes, flags, tile_f, n, s);
  return aq::launch_segscan<Multi<W, K>, false>(lanes, nullptr, tile_f, n, s);
}

template <class W>
cudaError_t run_k(int k, const uint8_t* flags, void* const* xs,
                  void* const* outs, void* const* tiles, const int* codes,
                  int32_t* tile_f, int64_t n, cudaStream_t s) {
  switch (k) {
    case 1: return run<W, 1>(flags, xs, outs, tiles, codes, tile_f, n, s);
    case 2: return run<W, 2>(flags, xs, outs, tiles, codes, tile_f, n, s);
    case 3: return run<W, 3>(flags, xs, outs, tiles, codes, tile_f, n, s);
    case 4: return run<W, 4>(flags, xs, outs, tiles, codes, tile_f, n, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace aq_multi

extern "C" {

// Rows per tile: the wrapper sizes its scratch as ceil(n / tile) entries.
int aq_seg_scan_multi_tile_rows() { return aq::kTile; }

// flags: uint8[n] or NULL. k in 1..4. xs, outs: k device pointers to lanes
// of n words; tiles: k device pointers to ntiles words of scratch; codes: k
// lane codes (see aq_multi above), all 32-bit (0..5) or all 64-bit (6..11),
// which sets the word width of every pointer; tile_f: int32[ntiles]
// scratch. The pointer and code arrays live in host memory. Returns the
// cudaError_t of the launches (cudaErrorInvalidValue for a bad k, a bad code
// or mixed widths); allocates nothing and does not synchronise.
int aq_seg_scan_multi(const void* flags, int k, void* const* xs,
                      void* const* outs, void* const* tiles, const int* codes,
                      void* tile_f, int64_t n, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  const bool wide = codes[0] >= aq_multi::kAddF64;
  for (int j = 0; j < k; ++j)
    if (codes[j] < 0 || codes[j] > aq_multi::kMaxI64 ||
        (codes[j] >= aq_multi::kAddF64) != wide)
      return (int)cudaErrorInvalidValue;
  const uint8_t* f = static_cast<const uint8_t*>(flags);
  int32_t* tf = static_cast<int32_t*>(tile_f);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide)
    return (int)aq_multi::run_k<aq_multi::U64>(k, f, xs, outs, tiles, codes,
                                               tf, n, s);
  return (int)aq_multi::run_k<uint32_t>(k, f, xs, outs, tiles, codes, tf, n,
                                        s);
}

}  // extern "C"
