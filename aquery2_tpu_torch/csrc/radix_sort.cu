// Stable radix sort of (key, value) pairs over the key's low end_bit bits,
// for Hopper (sm_90a): ops/sort.lexsort's sort of each packed key.
//
// torch.sort sorts an int64 key over all 64 bits (8 digit passes of CUB's
// onesweep) and carries an int64 index: 32 B a row a pass. A pack of
// lexsort holds only the bits of its fields, so this entry point hands
// CUB's DeviceRadixSort the pack as an unsigned key of 32 bits where it
// fits, else 64, with end_bit set to the pack's width (ceil(end_bit / 8)
// passes), and a 32-bit row index as the value where n < 2^31. Float64 keys
// are first mapped to their order bits by one elementwise pass
// (f64_order_bits), then sorted as 64-bit keys.
//
// CUB sorts on double buffers: the caller hands both halves of the keys
// and of the values, the input in the first, and learns from *selector
// which half holds the result. The temporary storage is the caller's (a
// torch allocation), sized by aq_radix_sort_temp_bytes. The device
// kernels keep CUB's names (DeviceRadixSortOnesweepKernel and its
// histogram, scan and single-tile kernels).
#include <cub/device/device_radix_sort.cuh>

#include <algorithm>
#include <cstdint>

namespace aq_sort {

// Key kinds: 32-bit and 64-bit unsigned keys, float64 keys ascending and
// descending (their order bits sorted as 64-bit keys).
enum KeyKind { kU32 = 0, kU64 = 1, kF64 = 2, kF64Desc = 3 };

// Each row's 64 order bits: unsigned order equals the order of the
// double with -0.0 equal to 0.0 and every NaN after +inf (negated first
// where desc, so NaN stays last).
__global__ void f64_order_bits(const double* __restrict__ x, int64_t n,
                               bool desc,
                               unsigned long long* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const double v = desc ? -x[i] : x[i];
    const unsigned long long b =
        v == 0.0 ? 0ull
        : isnan(v) ? 0x7ff8000000000000ull
                   : static_cast<unsigned long long>(__double_as_longlong(v));
    out[i] = (b >> 63) ? ~b : (b | 0x8000000000000000ull);
  }
}

template <class K, class V, class N>
cudaError_t sort_pairs(void* temp, size_t& temp_bytes, void* keys,
                       void* keys_alt, void* values, void* values_alt, N n,
                       int end_bit, int* selector, cudaStream_t stream) {
  cub::DoubleBuffer<K> k(static_cast<K*>(keys), static_cast<K*>(keys_alt));
  cub::DoubleBuffer<V> v(static_cast<V*>(values),
                         static_cast<V*>(values_alt));
  const cudaError_t err = cub::DeviceRadixSort::SortPairs(
      temp, temp_bytes, k, v, n, 0, end_bit, stream);
  *selector = k.selector;
  return err;
}

// The four instantiations: 32-bit or 64-bit keys, each with 32-bit values
// and 32-bit row counts, or 64-bit values and 64-bit row counts.
cudaError_t dispatch(int kind, bool wide, void* temp, size_t& temp_bytes,
                     void* keys, void* keys_alt, void* values,
                     void* values_alt, int64_t n, int end_bit, int* selector,
                     cudaStream_t stream) {
  if (wide) {
    return kind == kU32
               ? sort_pairs<uint32_t, uint64_t>(temp, temp_bytes, keys,
                                                keys_alt, values, values_alt,
                                                n, end_bit, selector, stream)
               : sort_pairs<uint64_t, uint64_t>(temp, temp_bytes, keys,
                                                keys_alt, values, values_alt,
                                                n, end_bit, selector, stream);
  }
  const int m = static_cast<int>(n);
  return kind == kU32
             ? sort_pairs<uint32_t, uint32_t>(temp, temp_bytes, keys,
                                              keys_alt, values, values_alt, m,
                                              end_bit, selector, stream)
             : sort_pairs<uint64_t, uint32_t>(temp, temp_bytes, keys,
                                              keys_alt, values, values_alt, m,
                                              end_bit, selector, stream);
}

}  // namespace aq_sort

extern "C" {

// Bytes of temporary storage aq_radix_sort_pairs needs for these
// arguments, into *bytes. Launches nothing.
int aq_radix_sort_temp_bytes(int kind, int wide, int64_t n, int end_bit,
                             size_t* bytes) {
  *bytes = 0;
  if (n < 2) return 0;
  int selector = 0;
  return (int)aq_sort::dispatch(kind, wide != 0, nullptr, *bytes, nullptr,
                                nullptr, nullptr, nullptr, n, end_bit,
                                &selector, nullptr);
}

// Sort n (key, value) pairs by the keys' bits [0, end_bit), stably.
// kind: aq_sort::KeyKind. keys, keys_alt: uint32[n] (kU32) or uint64[n],
// the input in keys; for float64 kinds x is the float64[n] input (read
// only) and its order bits are written to keys first. values,
// values_alt: uint32[n] (wide 0, n < 2^31) or uint64[n], the input in
// values. *selector: 0 where the sorted pairs are in keys and values, 1
// where in keys_alt and values_alt. temp: temp_bytes of device memory
// (aq_radix_sort_temp_bytes). Returns the cudaError_t of the launches;
// allocates nothing and does not synchronise.
int aq_radix_sort_pairs(int kind, int wide, const void* x, void* keys,
                        void* keys_alt, void* values, void* values_alt,
                        int64_t n, int end_bit, void* temp, size_t temp_bytes,
                        int* selector, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *selector = 0;
  if (kind >= aq_sort::kF64 && n > 0) {
    const int blocks = static_cast<int>(
        std::min<int64_t>((n + 255) / 256, 132 * 16));
    aq_sort::f64_order_bits<<<blocks, 256, 0, s>>>(
        static_cast<const double*>(x), n, kind == aq_sort::kF64Desc,
        static_cast<unsigned long long*>(keys));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n < 2) return 0;
  return (int)aq_sort::dispatch(kind, wide != 0, temp, temp_bytes, keys,
                                keys_alt, values, values_alt, n, end_bit,
                                selector, s);
}

}  // extern "C"
