// The scan ops of one lane, shared by seg_scan_multi.cu and
// fused_running_stats.cu: add, min and max of float32, int32, float64 and
// int64 values carried as the bit patterns of 32-bit or 64-bit words.
//
// min/max propagate NaN as jnp.minimum/jnp.maximum do, keeping the earlier
// NaN (fminf/fmaxf and fmin/fmax drop NaN, so they are not used). int32 add
// wraps mod 2^32 and int64 add mod 2^64 (unsigned words, as seg_cumsum_i64
// adds).
#pragma once

#include <cstdint>

namespace aq_ops {

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

// One lane code as a type, for the row loops: the switches above fold away.
template <int CODE, class W>
struct Op {
  static __device__ __forceinline__ W identity() {
    return identity1(CODE, W());
  }
  static __device__ __forceinline__ W combine(W a, W b) {
    return combine1(CODE, a, b);
  }
};

}  // namespace aq_ops
