// Grouped sums over a small slot domain, for Hopper (sm_90a): exact int64
// sums of integer and bool lanes, float64 sums of float64 lanes.
//
// Replaces aquery2_tpu/ops/pallas_kernels.py onehot_segment_sums (the TPU
// kernel _make_onehot_kernel) together with its caller
// aquery2_tpu/ops/reduce.py _pallas_onehot_reduce: out[s][j] is the sum of
// lane j over the rows whose code is s, wrapping mod 2^64 for an integer
// lane and in float64 IEEE adds for a float64 lane (whose 8-byte word of
// the int64 output holds the double). The TPU kernel splits every lane
// into bf16 base-128 digits so that a one-hot matmul on the MXU stays
// exact, and returns f32 superblock partials; the card adds int64 and
// float64 natively, so the digits, the superblocks and the matmul go.
//
// Bound: device memory, 4 B/row of codes plus each lane's width (8, 4 or
// 1 B/row), read once (h2o q1: 9 B/row, q9: 37 B/row). The design:
//   * Tiles staged in shared memory. A persistent grid (the blocks an SM
//     holds, on every SM) walks tiles of tile_rows rows (a multiple of
//     1024, about 32 KB of staging; with a float64 lane, a private plan
//     whose one block holds an SM alone anyway takes the largest tiles that
//     fit beside its accumulators); each block copies the codes and every
//     lane of its next tile with 16-byte cp.async, neighbouring threads on
//     neighbouring chunks, into the other of two stage buffers before it
//     adds the current tile. An array whose pointer is not 16-byte aligned
//     (a view such as x[3:]) is copied from the aligned chunk below its
//     tile's first byte and read at that offset; a chunk that would reach
//     outside the array (its first or last, for a misaligned pointer or a
//     ragged n) is copied byte by byte. No input is routed elsewhere.
//   * Lane dtypes are fixed outside the row loop: each thread reads its 4
//     rows' codes, then each lane's 4 values, with one dtype switch per lane
//     per 4 rows, widened to 64-bit words in registers (a float64 lane's
//     bits as they are). Whether any lane is float64 is a template flag: a
//     call with integer and bool lanes only runs the instantiation, plan
//     and launch it ran before float64 lanes existed.
//   * Adds by what fits. Private route, where one copy of the [dp][k]
//     accumulators per thread fits beside the staging (h2o q1 and q4, dp
//     11): thread t owns entry e at acc[e * threads + t] (a warp's 64-bit
//     words on consecutive banks) and adds with a plain load, add and store
//     (an integer add, or a float64 add for a float64 lane), no atomic.
//     Shared route (q2 and q9, dp 101, up to dp 513): one copy per warp,
//     copy-major, so an atomic waits only on lanes of its own warp that hit
//     the same slot (fewer copies, each shared by warps, where that lets an
//     SM hold more blocks); each integer entry is a low and a high 32-bit
//     word added by native 32-bit shared atomics with the carry passed on
//     (add_split), since a 64-bit shared atomic add is a CAS loop here.
//     With a float64 lane the entries are whole 64-bit words (add_split on
//     their halves); a warp first sums the float64 values of its lanes that
//     hit one slot (__match_any_sync, then a tree of shuffles), and the
//     group's first lane adds the sum to the warp's copy: a plain load, add
//     and store where the copy is the warp's own, else a shared atomicAdd
//     (a CAS loop, but one lane per slot and warp).
//   * Epilogue: the block folds its copies (a warp's shuffles for the
//     private route), in float64 for a float64 lane, and adds each nonzero
//     (slot, lane) total into the zeroed output with one global atomic
//     (atomicAdd on the word as an int64 or a double). Integer addition in
//     any order gives the same sum, so an integer lane equals the plain
//     version's bit for bit; a float64 lane's adds take an order that
//     depends on the timing of the blocks, as index_add_'s does.
#include "segscan.cuh"

namespace aq_onehot {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;               // rows a thread adds per step
constexpr int kChunkRows = kThreads * kRowsPerThread;   // tile_rows' unit
constexpr int kStages = 2;                      // stage buffers
constexpr int kStageTarget = 32 * 1024;         // staging bytes per tile
constexpr int kMaxLanes = 8;
constexpr int kMaxShared = 232448;              // Hopper's opt-in maximum per block
constexpr int kMaxRowBytes = 4 + 8 * kMaxLanes;

// Lane dtype codes, as ops/kernels.py passes them.
enum : int { kI64 = 0, kI32 = 1, kBool = 2, kF64 = 3 };

__host__ __device__ constexpr int dtype_bytes(int dt) {
  return dt == kI64 || dt == kF64 ? 8 : dt == kI32 ? 4 : 1;
}

// Staging bytes of one tile: every array's rows, plus 16 for a misaligned
// start.
__host__ __device__ constexpr int64_t stage_bytes(int64_t rows, int row_bytes,
                                                  int arrays) {
  return rows * row_bytes + 16 * arrays;
}

// The most entries (slots x lanes) one copy may hold: one copy beside the
// staging of kChunkRows rows of 8 int64 lanes in every stage buffer.
constexpr int kMaxEntries =
    (kMaxShared - kStages * (int)stage_bytes(kChunkRows, kMaxRowBytes,
                                             kMaxLanes + 1)) / 8;

struct Params {
  const unsigned char* ptr[kMaxLanes + 1];   // [0] the codes, then the lanes
  int width[kMaxLanes + 1];                  // bytes per row
  int seg[kMaxLanes + 1];                    // array's offset in a stage
  int dtype[kMaxLanes];
  int dp;
  int tile_rows;
  int stage;                                 // bytes of one stage buffer
  int acc_bytes;                             // accumulators, 16-byte padded
  int copies;                                // shared route: copies per block
  int64_t n;
  int64_t ntiles;
  unsigned long long* out;
};

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_prior() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows of tile `tile`: tile_rows, fewer in the last.
__device__ __forceinline__ int64_t tile_rows_of(const Params& p, int64_t tile) {
  const int64_t left = p.n - tile * p.tile_rows;
  return left < p.tile_rows ? left : p.tile_rows;
}

// Issue the copies of tile `tile` (if it exists) into stage buffer `st`.
template <int K>
__device__ __forceinline__ void load_tile(const Params& p, int64_t tile,
                                          unsigned char* st) {
  if (tile >= p.ntiles) return;
  const int64_t row0 = tile * p.tile_rows;
  const int64_t rows = tile_rows_of(p, tile);
#pragma unroll
  for (int a = 0; a <= K; ++a) {
    const int w = p.width[a];
    const uintptr_t lo = (uintptr_t)p.ptr[a];
    const uintptr_t hi = lo + (uintptr_t)(p.n * w);
    const uintptr_t first = (lo + (uintptr_t)(row0 * w)) & ~(uintptr_t)15;
    const int chunks = (int)((lo + row0 * w + rows * w - first + 15) >> 4);
    unsigned char* dst = st + p.seg[a];
    for (int c = threadIdx.x; c < chunks; c += kThreads) {
      const uintptr_t g = first + 16 * (uintptr_t)c;
      if (g >= lo && g + 16 <= hi) {
        aq::cp_async16(dst + 16 * c, (const void*)g);
      } else {                      // the array's first or last chunk
        for (int b = 0; b < 16; ++b)
          if (g + b >= lo && g + b < hi)
            dst[16 * c + b] = *(const unsigned char*)(g + b);
      }
    }
  }
}

// Array a's row r in a stage buffer: its segment, the pointer's offset
// within 16 bytes, then r rows.
template <class T>
__device__ __forceinline__ const T* staged(const Params& p,
                                           const unsigned char* st, int a) {
  return reinterpret_cast<const T*>(st + p.seg[a] +
                                    ((uintptr_t)p.ptr[a] & 15));
}

// x += v mod 2^64 for an entry kept as two 32-bit shared words, by native
// 32-bit shared atomics; the low word's carry goes into the high word.
// (Hopper has no 64-bit shared atomic add: atomicAdd on a 64-bit shared
// word compiles to a compare-and-swap loop, ATOMS.CAST.SPIN.64, which
// retries while lanes of a warp hit one slot.)
__device__ __forceinline__ void add_split(unsigned* lo, unsigned* hi,
                                          unsigned long long v) {
  const unsigned l = (unsigned)v;
  unsigned h = (unsigned)(v >> 32);
  if (l != 0u) {
    const unsigned old = atomicAdd(lo, l);
    h += old + l < old;
  }
  if (h != 0u) atomicAdd(hi, h);
}

__device__ __forceinline__ double as_f64(unsigned long long w) {
  return __longlong_as_double((long long)w);
}

__device__ __forceinline__ unsigned long long f64_bits(double x) {
  return (unsigned long long)__double_as_longlong(x);
}

// Row i's float64 lanes summed over each group of a warp's lanes whose rows
// hit one slot (peers: the lane's group, from __match_any_sync), into the
// group's first lane: a tree in lane order (each remaining lane adds the
// value of the next remaining lane above it, then every second one drops
// out), in which every lane of the warp takes part in each shuffle.
template <int K>
__device__ __forceinline__ void sum_peers(
    unsigned f64, unsigned peers, unsigned long long (&v)[K][kRowsPerThread],
    int i) {
  const int lane = threadIdx.x & 31;
  unsigned rank = __popc(peers & ((1u << lane) - 1u));  // lower peers
  unsigned above = peers & (0xfffffffeu << lane);       // higher peers left
  while (__any_sync(0xffffffffu, above != 0u)) {
    const int next = __ffs(above) - 1;                  // -1: none
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (!(f64 >> j & 1u)) continue;
      const double x = __shfl_sync(0xffffffffu, as_f64(v[j][i]),
                                   next < 0 ? lane : next);
      if (next >= 0) v[j][i] = f64_bits(as_f64(v[j][i]) + x);
    }
    above &= ~__ballot_sync(0xffffffffu, rank & 1u);    // absorbed lanes
    rank >>= 1;
  }
}

template <int K, bool kPrivate, bool kHasF64>
__global__ void __launch_bounds__(kThreads, 2)
onehot_sums(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(smem);
  unsigned char* stages = smem + p.acc_bytes;
  const int entries = p.dp * K;
  const int t = threadIdx.x;
  for (int i = t; i < p.acc_bytes / 8; i += kThreads) acc[i] = 0ull;
  unsigned f64 = 0u;                          // bit j: lane j is float64
  if (kHasF64) {
#pragma unroll
    for (int j = 0; j < K; ++j) f64 |= (unsigned)(p.dtype[j] == kF64) << j;
  }

  const int64_t G = gridDim.x;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    load_tile<K>(p, blockIdx.x + s * G, stages + s * p.stage);
    commit();
  }
  // shared route: the copies' low 32-bit words, then their high words
  // (with a float64 lane, each entry's two words side by side: ws 32-bit
  // words from one entry to the next); this warp's copy
  constexpr int ws = kHasF64 ? 2 : 1;
  unsigned* const lo0 = reinterpret_cast<unsigned*>(acc);
  unsigned* const hi0 = kHasF64 ? lo0 + 1 : lo0 + (int64_t)p.copies * entries;
  const int64_t mine = (int64_t)((t >> 5) % p.copies) * entries;
  unsigned* lo = lo0 + ws * mine;
  unsigned* hi = hi0 + ws * mine;

  int buf = 0;
  for (int64_t tile = blockIdx.x; tile < p.ntiles; tile += G) {
    const int next = (buf + kStages - 1) % kStages;
    load_tile<K>(p, tile + (kStages - 1) * G, stages + next * p.stage);
    commit();
    wait_prior<kStages - 1>();
    __syncthreads();

    const unsigned char* st = stages + buf * p.stage;
    const int rows = (int)tile_rows_of(p, tile);
    const int32_t* codes = staged<int32_t>(p, st, 0);
    for (int base = 0; base < rows; base += kChunkRows) {
      int slot[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int r = base + t + i * kThreads;
        const int s = codes[r];               // in the buffer even past rows
        slot[i] = (r < rows && (unsigned)s < (unsigned)p.dp) ? s : -1;
      }
      unsigned long long v[K][kRowsPerThread];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int r0 = base + t;
        // once per lane per 4 rows; a float64 lane's bits load as int64's
        switch (f64 >> j & 1u ? (int)kI64 : p.dtype[j]) {
          case kI64: {
            const unsigned long long* x =
                staged<unsigned long long>(p, st, j + 1) + r0;
#pragma unroll
            for (int i = 0; i < kRowsPerThread; ++i) v[j][i] = x[i * kThreads];
            break;
          }
          case kI32: {                        // sign-extend, wrap as unsigned
            const int32_t* x = staged<int32_t>(p, st, j + 1) + r0;
#pragma unroll
            for (int i = 0; i < kRowsPerThread; ++i)
              v[j][i] = (unsigned long long)(long long)x[i * kThreads];
            break;
          }
          default: {
            const unsigned char* x = staged<unsigned char>(p, st, j + 1) + r0;
#pragma unroll
            for (int i = 0; i < kRowsPerThread; ++i)
              v[j][i] = x[i * kThreads] != 0;
          }
        }
      }
      if (kHasF64 && !kPrivate) {             // float64 lanes: a group's sum
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const unsigned peers = __match_any_sync(0xffffffffu, slot[i]);
          sum_peers<K>(f64, peers, v, i);
          if (slot[i] >= 0 && (t & 31) == __ffs(peers) - 1) {
            double* w = reinterpret_cast<double*>(lo + 2 * slot[i] * K);
#pragma unroll
            for (int j = 0; j < K; ++j) {
              if (!(f64 >> j & 1u)) continue;
              if (p.copies == kWarps)         // the warp's own copy
                w[j] += as_f64(v[j][i]);
              else
                atomicAdd(w + j, as_f64(v[j][i]));
            }
          }
          __syncwarp();                       // before another lane's add
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        if (slot[i] < 0) continue;            // outside [0, dp): dropped
        const int e = slot[i] * K;
        if (kPrivate) {
          unsigned long long* q = acc + (int64_t)e * kThreads + t;
          unsigned long long a[K];
#pragma unroll
          for (int j = 0; j < K; ++j) a[j] = q[j * kThreads];
#pragma unroll
          for (int j = 0; j < K; ++j)
            q[j * kThreads] = f64 >> j & 1u
                                  ? f64_bits(as_f64(a[j]) + as_f64(v[j][i]))
                                  : a[j] + v[j][i];
        } else {
#pragma unroll
          for (int j = 0; j < K; ++j)
            if (!(f64 >> j & 1u))
              add_split(lo + ws * (e + j), hi + ws * (e + j), v[j][i]);
        }
      }
    }
    __syncthreads();                          // the buffer may be refilled
    buf = (buf + 1) % kStages;
  }
  __syncthreads();

  if (kPrivate) {                             // a warp folds one entry at a time
    const int lane = t & 31;
    for (int e = t >> 5; e < entries; e += kWarps) {
      if (f64 >> (e % K) & 1u) {
        double total = 0.0;
#pragma unroll
        for (int m = 0; m < kThreads; m += 32)
          total += as_f64(acc[(int64_t)e * kThreads + m + lane]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          total += __shfl_xor_sync(0xffffffffu, total, o);
        if (lane == 0 && f64_bits(total) != 0ull)
          atomicAdd(reinterpret_cast<double*>(p.out + e), total);
        continue;
      }
      unsigned long long total = 0ull;
#pragma unroll
      for (int m = 0; m < kThreads; m += 32)
        total += acc[(int64_t)e * kThreads + m + lane];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        total += __shfl_xor_sync(0xffffffffu, total, o);
      if (lane == 0 && total != 0ull) atomicAdd(p.out + e, total);
    }
  } else {
    for (int e = t; e < entries; e += kThreads) {
      if (f64 >> (e % K) & 1u) {
        double total = 0.0;
        for (int c = 0; c < p.copies; ++c)
          total += *reinterpret_cast<const double*>(
              lo0 + 2 * ((int64_t)c * entries + e));
        if (f64_bits(total) != 0ull)
          atomicAdd(reinterpret_cast<double*>(p.out + e), total);
        continue;
      }
      unsigned long long total = 0ull;
      for (int c = 0; c < p.copies; ++c)
        total += lo0[ws * ((int64_t)c * entries + e)] +
                 ((unsigned long long)hi0[ws * ((int64_t)c * entries + e)]
                  << 32);
      if (total != 0ull) atomicAdd(p.out + e, total);
    }
  }
}

// The launch for (dp, lane dtypes, n): route, copies, tile rows, shared
// memory and grid.
struct Plan {
  bool priv, f64;
  int copies, tile_rows, stage, acc_bytes, smem, per_sm, blocks;
};

inline int64_t pad16(int64_t b) { return (b + 15) / 16 * 16; }

template <int K, bool kPrivate, bool kHasF64>
cudaError_t grid_for(Plan& pl, int64_t n) {
  cudaError_t err = cudaFuncSetAttribute(
      onehot_sums<K, kPrivate, kHasF64>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &pl.per_sm, onehot_sums<K, kPrivate, kHasF64>, kThreads,
           pl.smem)) !=
      cudaSuccess)
    return err;
  const int64_t ntiles = (n + pl.tile_rows - 1) / pl.tile_rows;
  const int64_t fill = (int64_t)sms * (pl.per_sm > 0 ? pl.per_sm : 1);
  pl.blocks = (int)(ntiles < fill ? (ntiles > 0 ? ntiles : 1) : fill);
  return cudaSuccess;
}

// The grid of the kernel the plan runs: its route and whether a lane is
// float64.
template <int K>
cudaError_t grid_of(Plan& pl, int64_t n) {
  if (pl.priv)
    return pl.f64 ? grid_for<K, true, true>(pl, n)
                  : grid_for<K, true, false>(pl, n);
  return pl.f64 ? grid_for<K, false, true>(pl, n)
                : grid_for<K, false, false>(pl, n);
}

template <int K>
cudaError_t plan_for(Plan& pl, int dp, int row_bytes, int64_t n) {
  int64_t rows = kStageTarget / row_bytes / kChunkRows * kChunkRows;
  if (rows < kChunkRows) rows = kChunkRows;
  auto total = [&](int64_t acc, int64_t r) {
    return pad16(acc) + kStages * stage_bytes(r, row_bytes, K + 1);
  };
  const int64_t one = (int64_t)dp * K * 8;
  pl.priv = total(one * kThreads, kChunkRows) <= kMaxShared;
  pl.copies = pl.priv ? kThreads : kWarps;
  // With a float64 lane, a private plan that holds an SM alone anyway
  // (more than half of the shared memory) takes tiles as large as fit:
  // its one block keeps more bytes in flight (h2o q4's 21 B rows: 1,024-
  // row tiles 1.25 ms, 3,072 1.02 ms at 1e8 rows on the H100).
  if (pl.f64 && pl.priv && 2 * total(one * kThreads, rows) > kMaxShared)
    rows = kMaxShared / (kStages * row_bytes) / kChunkRows * kChunkRows;
  if (!pl.priv) {
    while (pl.copies > 1 && total(one * pl.copies, rows) > kMaxShared)
      pl.copies /= 2;
  }
  while (rows > kChunkRows && total(one * pl.copies, rows) > kMaxShared)
    rows -= kChunkRows;
  if (total(one * pl.copies, rows) > kMaxShared) return cudaErrorInvalidValue;
  pl.tile_rows = (int)rows;
  pl.stage = (int)stage_bytes(rows, row_bytes, K + 1);
  pl.acc_bytes = (int)pad16(one * pl.copies);
  pl.smem = (int)total(one * pl.copies, rows);
  if (pl.priv) return grid_of<K>(pl, n);
  cudaError_t err = grid_of<K>(pl, n);
  // fewer copies where that lets an SM hold more blocks (h2o q9 with NAs:
  // 7 lanes at dp 101 hold one block of 8 copies an SM, two of 4)
  for (Plan fewer = pl; err == cudaSuccess && fewer.copies > 1;) {
    fewer.copies /= 2;
    fewer.acc_bytes = (int)pad16(one * fewer.copies);
    fewer.smem = (int)total(one * fewer.copies, rows);
    err = grid_of<K>(fewer, n);
    if (err == cudaSuccess && fewer.per_sm > pl.per_sm) pl = fewer;
  }
  // the kernel's shared-memory limit back to the chosen plan's
  return err == cudaSuccess ? grid_of<K>(pl, n) : err;
}

template <int K>
cudaError_t run(Params& p, const Plan& pl, cudaStream_t s) {
  const size_t smem = pl.smem;
  if (pl.priv && pl.f64)
    onehot_sums<K, true, true><<<pl.blocks, kThreads, smem, s>>>(p);
  else if (pl.priv)
    onehot_sums<K, true, false><<<pl.blocks, kThreads, smem, s>>>(p);
  else if (pl.f64)
    onehot_sums<K, false, true><<<pl.blocks, kThreads, smem, s>>>(p);
  else
    onehot_sums<K, false, false><<<pl.blocks, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

// Checks the arguments and makes the plan; fills p's layout when p is
// given.
inline cudaError_t plan(int k, const int* dtypes, int dp, int64_t n, Plan& pl,
                        Params* p) {
  if (k < 1 || k > kMaxLanes || dp < 1 || (int64_t)dp * k > kMaxEntries)
    return cudaErrorInvalidValue;
  int row_bytes = 4;
  pl.f64 = false;
  for (int j = 0; j < k; ++j) {
    if (dtypes[j] < kI64 || dtypes[j] > kF64) return cudaErrorInvalidValue;
    row_bytes += dtype_bytes(dtypes[j]);
    pl.f64 = pl.f64 || dtypes[j] == kF64;
  }
  cudaError_t err = cudaErrorInvalidValue;
  switch (k) {
    case 1: err = plan_for<1>(pl, dp, row_bytes, n); break;
    case 2: err = plan_for<2>(pl, dp, row_bytes, n); break;
    case 3: err = plan_for<3>(pl, dp, row_bytes, n); break;
    case 4: err = plan_for<4>(pl, dp, row_bytes, n); break;
    case 5: err = plan_for<5>(pl, dp, row_bytes, n); break;
    case 6: err = plan_for<6>(pl, dp, row_bytes, n); break;
    case 7: err = plan_for<7>(pl, dp, row_bytes, n); break;
    case 8: err = plan_for<8>(pl, dp, row_bytes, n); break;
  }
  if (err != cudaSuccess || p == nullptr) return err;
  int seg = 0;
  for (int a = 0; a <= k; ++a) {
    p->width[a] = a == 0 ? 4 : dtype_bytes(dtypes[a - 1]);
    p->seg[a] = seg;
    seg += pl.tile_rows * p->width[a] + 16;
    if (a > 0) p->dtype[a - 1] = dtypes[a - 1];
  }
  p->dp = dp;
  p->tile_rows = pl.tile_rows;
  p->stage = pl.stage;
  p->acc_bytes = pl.acc_bytes;
  p->copies = pl.copies;
  p->n = n;
  p->ntiles = (n + pl.tile_rows - 1) / pl.tile_rows;
  return cudaSuccess;
}

}  // namespace aq_onehot

extern "C" {

// code: int32[n] slots in [0, dp). k in 1..8 lanes: xs holds k device
// pointers to n-row lanes, dtypes their codes (0 int64, 1 int32, 2 bool,
// 3 float64); both arrays live in host memory. Any pointer alignment and
// any n >= 1. out: int64[dp * k], zeroed by the caller, row-major [dp][k];
// a float64 lane's words hold doubles (a zeroed word is +0.0). Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a bad k or dtype,
// or a dp * k above aq_onehot_max_entries()); allocates nothing and does
// not synchronise.
int aq_onehot_segment_sums(const void* code, int k, void* const* xs,
                           const int* dtypes, int dp, int64_t n, void* out,
                           void* stream) {
  aq_onehot::Plan pl{};
  aq_onehot::Params p{};
  cudaError_t err = aq_onehot::plan(k, dtypes, dp, n, pl, &p);
  if (err != cudaSuccess) return (int)err;
  p.ptr[0] = static_cast<const unsigned char*>(code);
  for (int j = 0; j < k; ++j)
    p.ptr[j + 1] = static_cast<const unsigned char*>(xs[j]);
  p.out = static_cast<unsigned long long*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return (int)aq_onehot::run<1>(p, pl, s);
    case 2: return (int)aq_onehot::run<2>(p, pl, s);
    case 3: return (int)aq_onehot::run<3>(p, pl, s);
    case 4: return (int)aq_onehot::run<4>(p, pl, s);
    case 5: return (int)aq_onehot::run<5>(p, pl, s);
    case 6: return (int)aq_onehot::run<6>(p, pl, s);
    case 7: return (int)aq_onehot::run<7>(p, pl, s);
    case 8: return (int)aq_onehot::run<8>(p, pl, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The launch aq_onehot_segment_sums makes for these arguments, into
// info[8]: private route (1) or shared (0), accumulator copies per block,
// threads per block, blocks, tile rows, dynamic shared memory per block
// (bytes), blocks an SM holds, and one stage buffer's bytes. Returns a
// cudaError_t as aq_onehot_segment_sums does.
int aq_onehot_route(int k, const int* dtypes, int dp, int64_t n, int* info) {
  aq_onehot::Plan pl{};
  const cudaError_t err = aq_onehot::plan(k, dtypes, dp, n, pl, nullptr);
  if (err != cudaSuccess) return (int)err;
  const int vals[8] = {pl.priv ? 1 : 0, pl.copies, aq_onehot::kThreads,
                       pl.blocks, pl.tile_rows, pl.smem, pl.per_sm, pl.stage};
  for (int i = 0; i < 8; ++i) info[i] = vals[i];
  return 0;
}

// The most entries (dp * k) a call takes.
int aq_onehot_max_entries() { return aq_onehot::kMaxEntries; }

}  // extern "C"
