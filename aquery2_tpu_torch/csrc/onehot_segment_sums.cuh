// Grouped sums over a small slot domain, for Hopper (sm_90a): exact int64
// sums of integer and bool lanes, float64 sums of float64 lanes, each row's
// slot computed from its key columns as they are stored.
//
// Replaces aquery2_tpu/ops/pallas_kernels.py onehot_segment_sums (the TPU
// kernel _make_onehot_kernel) together with its caller
// aquery2_tpu/ops/reduce.py _pallas_onehot_reduce, and the dense tier's
// preparation passes around it: out[s][j] is the sum of lane j over the
// rows whose slot is s, wrapping mod 2^64 for an integer lane and in
// float64 IEEE adds for a float64 lane (whose 8-byte word of the int64
// output holds the double). The TPU kernel splits every lane into bf16
// base-128 digits so that a one-hot matmul on the MXU stays exact, and
// returns f32 superblock partials; the card adds int64 and float64
// natively, so the digits, the superblocks and the matmul go.
//
// The keyed load. A row's slot is sum_i (key_i - min_i) * stride_i over up
// to 4 integer key columns of one dtype (int8 to int64), in wrapping 64-bit
// arithmetic; a row is dropped where its slot falls outside [0, dp) or an
// optional bool row mask (a WHERE) is false. A lane sums one source column
// as it is stored (int64, int32, bool or float64), or the product of two
// integer or bool sources widened to int64 (corr's and var's products), or
// 1 (the slot's row count). So the engine hands over the table's columns
// and builds no codes, validity, masked lanes or products in passes of its
// own (h2o q9 at 1e8 rows: 16 B/row read here instead of about 300 B/row
// moved by those passes). The code form, a precomputed int32 code per row,
// is the keyed form with one int32 key, minimum 0 and stride 1, run by the
// same kernels.
//
// Bound: device memory, each key, mask and source byte read once (h2o q1
// keyed: 8 B/row, q9: 16 B/row). The design:
//   * Tiles staged in shared memory. A persistent grid (the blocks an SM
//     holds, on every SM) walks tiles of tile_rows rows (a multiple of
//     1024, about 32 KB of staging; with a float64 lane, a private plan
//     whose one block holds an SM alone anyway takes the largest tiles that
//     fit beside its accumulators); each block copies every key, the mask
//     and every source of its next tile with 16-byte cp.async, neighbouring
//     threads on neighbouring chunks, into the other of two stage buffers
//     before it adds the current tile. An array whose pointer is not
//     16-byte aligned (a view such as x[3:]) is copied from the aligned
//     chunk below its tile's first byte and read at that offset; a chunk
//     that would reach outside the array (its first or last, for a
//     misaligned pointer or a ragged n) is copied byte by byte. No input is
//     routed elsewhere.
//   * Dtypes and lane kinds are fixed outside the row loop: each thread
//     makes its 4 rows' slots from the keys, then each lane's 4 values,
//     with one dtype switch per array per 4 rows, widened to 64-bit words
//     in registers (a float64 lane's bits as they are). The number of
//     lanes, whether any lane is float64 and the number of keys (0 for the
//     code form, whose slot is its code) are template parameters; the key
//     dtype, the mask and each lane's sources are runtime descriptions.
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
#pragma once

#include "segscan.cuh"

namespace aq_onehot {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;               // rows a thread adds per step
constexpr int kChunkRows = kThreads * kRowsPerThread;   // tile_rows' unit
constexpr int kStages = 2;                      // stage buffers
constexpr int kStageTarget = 32 * 1024;         // staging bytes per tile
constexpr int kMaxLanes = 8;
constexpr int kMaxKeys = 4;
constexpr int kMaxSources = kMaxLanes;
constexpr int kMaxArrays = kMaxKeys + 1 + kMaxSources;  // keys, mask, sources
constexpr int kMaxShared = 232448;              // Hopper's opt-in maximum per block
constexpr int kMaxRowBytes = 4 + 8 * kMaxLanes; // the code form's widest row

// Dtype codes, as ops/kernels.py passes them: a source is one of the first
// four, a key one of int64, int32, int16 and int8.
enum : int { kI64 = 0, kI32 = 1, kBool = 2, kF64 = 3, kI16 = 4, kI8 = 5 };

__host__ __device__ constexpr int dtype_bytes(int dt) {
  return dt == kI64 || dt == kF64 ? 8 : dt == kI32 ? 4 : dt == kI16 ? 2 : 1;
}

// Staging bytes of one tile: every array's rows, plus 16 for a misaligned
// start.
__host__ __device__ constexpr int64_t stage_bytes(int64_t rows, int row_bytes,
                                                  int arrays) {
  return rows * row_bytes + 16 * arrays;
}

// The most entries (slots x lanes) one copy may hold: one copy beside the
// staging of kChunkRows rows of codes and 8 int64 lanes in every stage
// buffer. A keyed call whose rows are wider fits fewer (plan_for).
constexpr int kMaxEntries =
    (kMaxShared - kStages * (int)stage_bytes(kChunkRows, kMaxRowBytes,
                                             kMaxLanes + 1)) / 8;

struct Params {
  const unsigned char* ptr[kMaxArrays];      // keys, the mask, the sources
  int width[kMaxArrays];                     // bytes per row
  int seg[kMaxArrays];                       // array's offset in a stage
  int arrays;
  // where the hot loop reads: an array's row 0 in a stage buffer (its
  // segment plus its pointer's offset within 16 bytes), by key, the mask
  // and each lane's sources, so that it indexes no array at run time
  int key_off[kMaxKeys];
  int key_dtype;
  int mask_off;                              // -1: no mask
  // lane j: its source's offset and load4 dtype (a float64 as kI64; -1:
  // the row count), times another source's (-1: none)
  int a_off[kMaxLanes], a_dt[kMaxLanes];
  int b_off[kMaxLanes], b_dt[kMaxLanes];
  unsigned f64;                              // bit j: lane j is float64
  long long kmin[kMaxKeys];
  long long stride[kMaxKeys];
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

// Issue the copies of array a's rows [row0, row0 + rows) into stage buffer
// `st`.
__device__ __forceinline__ void load_array(const Params& p, int a,
                                           int64_t row0, int64_t rows,
                                           unsigned char* st) {
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
    } else {                        // the array's first or last chunk
      for (int b = 0; b < 16; ++b)
        if (g + b >= lo && g + b < hi)
          dst[16 * c + b] = *(const unsigned char*)(g + b);
    }
  }
}

// Issue the copies of tile `tile` (if it exists) into stage buffer `st`:
// kArrays arrays, or p.arrays where kArrays is 0.
template <int kArrays>
__device__ __forceinline__ void load_tile(const Params& p, int64_t tile,
                                          unsigned char* st) {
  if (tile >= p.ntiles) return;
  const int64_t row0 = tile * p.tile_rows;
  const int64_t rows = tile_rows_of(p, tile);
  if constexpr (kArrays > 0) {
#pragma unroll
    for (int a = 0; a < kArrays; ++a) load_array(p, a, row0, rows, st);
  } else {
    for (int a = 0; a < p.arrays; ++a) load_array(p, a, row0, rows, st);
  }
}

// Rows r0 + i * kThreads (i < 4) of the staged array at byte off of a
// stage buffer, as 64-bit words: integers sign-extended (wrapping as
// unsigned), a bool 0 or 1, a float64's bits as they are (its lane loads
// as kI64). dt: kI64, kI32 or else a bool; a key (kKey) kI64, kI32, kI16
// or else kI8. One switch per array per 4 rows.
template <bool kKey>
__device__ __forceinline__ void load4(const unsigned char* st, int off, int dt,
                                      int r0,
                                      unsigned long long (&v)[kRowsPerThread]) {
  const unsigned char* b = st + off;
  switch (dt) {
    case kI64: {
      const unsigned long long* x =
          reinterpret_cast<const unsigned long long*>(b) + r0;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) v[i] = x[i * kThreads];
      break;
    }
    case kI32: {
      const int32_t* x = reinterpret_cast<const int32_t*>(b) + r0;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        v[i] = (unsigned long long)(long long)x[i * kThreads];
      break;
    }
    default:
      if (kKey && dt == kI16) {
        const int16_t* x = reinterpret_cast<const int16_t*>(b) + r0;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          v[i] = (unsigned long long)(long long)x[i * kThreads];
      } else if (kKey) {
        const int8_t* x = reinterpret_cast<const int8_t*>(b) + r0;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          v[i] = (unsigned long long)(long long)x[i * kThreads];
      } else {
        const unsigned char* x = b + r0;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) v[i] = x[i * kThreads] != 0;
      }
  }
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

// kKeys: the keyed form with that many keys, or 0: the code form, one int32
// key (the code) of minimum 0 and stride 1, no mask, each lane one source
// (plan() picks it for such a description, whichever entry point).
template <int K, bool kPrivate, bool kHasF64, int kKeys>
__global__ void __launch_bounds__(kThreads, 2)
onehot_sums(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(smem);
  unsigned char* stages = smem + p.acc_bytes;
  const int entries = p.dp * K;
  const int t = threadIdx.x;
  for (int i = t; i < p.acc_bytes / 8; i += kThreads) acc[i] = 0ull;
  const unsigned f64 = kHasF64 ? p.f64 : 0u;  // bit j: lane j is float64

  // the arrays: the code and a source a lane (the keyed form's count is
  // known at run time)
  constexpr int kArrays = kKeys == 0 ? 1 + K : 0;
  const int64_t G = gridDim.x;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    load_tile<kArrays>(p, blockIdx.x + s * G, stages + s * p.stage);
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
    load_tile<kArrays>(p, tile + (kStages - 1) * G, stages + next * p.stage);
    commit();
    wait_prior<kStages - 1>();
    __syncthreads();

    const unsigned char* st = stages + buf * p.stage;
    const int rows = (int)tile_rows_of(p, tile);
    for (int base = 0; base < rows; base += kChunkRows) {
      const int r0 = base + t;
      int slot[kRowsPerThread];
      if constexpr (kKeys == 0) {             // the code: in [0, dp) or out
        const int32_t* codes =
            reinterpret_cast<const int32_t*>(st + p.key_off[0]) + r0;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const int c = codes[i * kThreads];  // in the buffer even past rows
          slot[i] = (r0 + i * kThreads < rows && (unsigned)c < (unsigned)p.dp)
                        ? c : -1;
        }
      } else {                                // in wrapping 64-bit arithmetic
        unsigned long long s[kRowsPerThread] = {};
#pragma unroll
        for (int q = 0; q < kKeys; ++q) {
          unsigned long long x[kRowsPerThread];
          load4<true>(st, p.key_off[q], p.key_dtype, r0, x);
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
            s[i] += (x[i] - (unsigned long long)p.kmin[q]) *
                    (unsigned long long)p.stride[q];
        }
        unsigned long long keep[kRowsPerThread] = {1ull, 1ull, 1ull, 1ull};
        if (p.mask_off >= 0) load4<false>(st, p.mask_off, kBool, r0, keep);
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          slot[i] = (r0 + i * kThreads < rows && keep[i] != 0ull &&
                     s[i] < (unsigned long long)p.dp) ? (int)s[i] : -1;
      }
      unsigned long long v[K][kRowsPerThread];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (kKeys != 0 && p.a_dt[j] < 0) {    // the slot's row count
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) v[j][i] = 1ull;
          continue;
        }
        load4<false>(st, p.a_off[j], p.a_dt[j], r0, v[j]);
        if (kKeys != 0 && p.b_dt[j] >= 0) {   // a product, mod 2^64
          unsigned long long y[kRowsPerThread];
          load4<false>(st, p.b_off[j], p.b_dt[j], r0, y);
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) v[j][i] *= y[i];
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
        if (slot[i] < 0) continue;            // dropped
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

using Kernel = void (*)(Params);

template <int kKeys, int K>
Kernel route_kernel(bool priv, bool f64) {
  if (priv)
    return f64 ? onehot_sums<K, true, true, kKeys>
               : onehot_sums<K, true, false, kKeys>;
  return f64 ? onehot_sums<K, false, true, kKeys>
             : onehot_sums<K, false, false, kKeys>;
}

// The kernel of kKeys keys (0: the code form) for k lanes, its route and
// whether a lane is float64. Each kKeys' kernels are instantiated in a
// translation unit of their own (onehot_segment_sums.cu for the code form,
// onehot_keys_<kKeys>.cu), so that nvcc builds them side by side.
template <int kKeys>
Kernel kernel_for(int k, bool priv, bool f64) {
  switch (k) {
    case 1: return route_kernel<kKeys, 1>(priv, f64);
    case 2: return route_kernel<kKeys, 2>(priv, f64);
    case 3: return route_kernel<kKeys, 3>(priv, f64);
    case 4: return route_kernel<kKeys, 4>(priv, f64);
    case 5: return route_kernel<kKeys, 5>(priv, f64);
    case 6: return route_kernel<kKeys, 6>(priv, f64);
    case 7: return route_kernel<kKeys, 7>(priv, f64);
    case 8: return route_kernel<kKeys, 8>(priv, f64);
  }
  return nullptr;
}

}  // namespace aq_onehot
