// Exact grouped int64 sums over a small slot domain, for Hopper (sm_90a).
//
// Replaces aquery2_tpu/ops/pallas_kernels.py onehot_segment_sums (the TPU
// kernel _make_onehot_kernel) together with its caller
// aquery2_tpu/ops/reduce.py _pallas_onehot_reduce: out[s][j] is the sum of
// lane j over the rows whose code is s, wrapping mod 2^64. The TPU kernel
// splits every lane into bf16 base-128 digits so that a one-hot matmul on
// the MXU stays exact, and returns f32 superblock partials; the card adds
// int64 natively, so the digits, the superblocks and the matmul go.
//
// Bound: device memory, about 4 B/row of codes plus each lane's width
// (8, 4 or 1 B/row), read once. The trap is contention: the dense tier has
// few slots (h2o q1: 10 live slots for 12.6M rows), so one accumulator per
// slot serialises every add. Each block therefore keeps `ncopies` copies
// of the [dp][k] accumulators in shared memory, interleaved so that copy c
// of entry e sits at e * ncopies + c; thread t adds into copy t % ncopies.
// With ncopies >= 32 the 32 threads of a warp never share a word, so their
// atomics never wait on each other. After the grid-stride loop the block folds its copies and adds
// each nonzero (slot, lane) total into the zeroed output with one global
// atomic. Integer addition in any order gives the same sum, so the result
// is deterministic and equal to the plain version's bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace aq_onehot {

constexpr int kThreads = 256;
constexpr int kMaxLanes = 8;
constexpr int kCopyBudget = 48 * 1024;     // shared bytes per block, above one copy
constexpr int kMaxShared = 232448;         // Hopper's opt-in maximum per block

// Lane dtype codes, as ops/kernels.py passes them.
enum : int { kI64 = 0, kI32 = 1, kBool = 2 };

struct Lanes {
  const void* x[kMaxLanes];
  int dtype[kMaxLanes];
};

__device__ __forceinline__ unsigned long long lane_value(const Lanes& l, int j,
                                                         int64_t row) {
  switch (l.dtype[j]) {
    case kI64:
      return static_cast<const unsigned long long*>(l.x[j])[row];
    case kI32:  // sign-extend, then wrap as unsigned
      return (unsigned long long)(long long)static_cast<const int32_t*>(l.x[j])[row];
    default:
      return static_cast<const uint8_t*>(l.x[j])[row] != 0;
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
onehot_sums(const int32_t* __restrict__ code, Lanes lanes, int dp, int ncopies,
            int64_t n, unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long acc[];   // [dp * K][ncopies]
  const int entries = dp * K;
  for (int i = threadIdx.x; i < entries * ncopies; i += blockDim.x) acc[i] = 0ull;
  __syncthreads();

  const int copy = threadIdx.x % ncopies;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; row < n;
       row += stride) {
    const int s = code[row];
    if ((unsigned)s >= (unsigned)dp) continue;   // outside the contract: dropped
    unsigned long long* base = acc + (int64_t)s * K * ncopies + copy;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const unsigned long long v = lane_value(lanes, j, row);
      if (v != 0ull) atomicAdd(base + j * ncopies, v);
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < entries; e += blockDim.x) {
    unsigned long long total = 0ull;
    const unsigned long long* p = acc + (int64_t)e * ncopies;
    for (int c = 0; c < ncopies; ++c) total += p[c];
    if (total != 0ull) atomicAdd(out + e, total);
  }
}

// Copies per block: the most that fit kCopyBudget, a power of two, at most
// one per thread; 1 when a single copy is larger than the budget.
inline int copies_for(int dp, int k) {
  const int64_t one = (int64_t)dp * k * 8;
  int c = 1;
  while (c * 2 <= kThreads && one * c * 2 <= kCopyBudget) c *= 2;
  return c;
}

template <int K>
cudaError_t run(const int32_t* code, const Lanes& lanes, int dp, int64_t n,
                unsigned long long* out, cudaStream_t s) {
  const int ncopies = copies_for(dp, K);
  const size_t shmem = (size_t)dp * K * 8 * ncopies;
  cudaError_t err = cudaFuncSetAttribute(
      onehot_sums<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, onehot_sums<K>, kThreads, shmem)) != cudaSuccess)
    return err;
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t fill = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(want < fill ? want : fill);
  onehot_sums<K><<<blocks, kThreads, shmem, s>>>(code, lanes, dp, ncopies, n,
                                                 out);
  return cudaGetLastError();
}

}  // namespace aq_onehot

extern "C" {

// code: int32[n] slots in [0, dp). k in 1..8 lanes: xs holds k device
// pointers to n-row lanes, dtypes their codes (0 int64, 1 int32, 2 bool);
// both arrays live in host memory. out: int64[dp * k], zeroed by the
// caller, row-major [dp][k]. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a bad k or dtype, or a dp whose one copy of
// the accumulators does not fit a block's shared memory); allocates nothing and
// does not synchronise.
int aq_onehot_segment_sums(const void* code, int k, void* const* xs,
                           const int* dtypes, int dp, int64_t n, void* out,
                           void* stream) {
  if (k < 1 || k > aq_onehot::kMaxLanes || dp < 1 ||
      (int64_t)dp * k * 8 > aq_onehot::kMaxShared)
    return (int)cudaErrorInvalidValue;
  aq_onehot::Lanes lanes{};
  for (int j = 0; j < k; ++j) {
    if (dtypes[j] < aq_onehot::kI64 || dtypes[j] > aq_onehot::kBool)
      return (int)cudaErrorInvalidValue;
    lanes.x[j] = xs[j];
    lanes.dtype[j] = dtypes[j];
  }
  const int32_t* c = static_cast<const int32_t*>(code);
  auto* o = static_cast<unsigned long long*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return (int)aq_onehot::run<1>(c, lanes, dp, n, o, s);
    case 2: return (int)aq_onehot::run<2>(c, lanes, dp, n, o, s);
    case 3: return (int)aq_onehot::run<3>(c, lanes, dp, n, o, s);
    case 4: return (int)aq_onehot::run<4>(c, lanes, dp, n, o, s);
    case 5: return (int)aq_onehot::run<5>(c, lanes, dp, n, o, s);
    case 6: return (int)aq_onehot::run<6>(c, lanes, dp, n, o, s);
    case 7: return (int)aq_onehot::run<7>(c, lanes, dp, n, o, s);
    case 8: return (int)aq_onehot::run<8>(c, lanes, dp, n, o, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
