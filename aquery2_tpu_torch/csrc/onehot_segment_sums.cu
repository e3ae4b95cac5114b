// onehot_segment_sums' plan, launch and C interface; the kernels are in
// onehot_segment_sums.cuh, the keyed form's in onehot_keys_<n>.cu.
#include "onehot_segment_sums.cuh"

namespace aq_onehot {

// The launch for (dp, the rows' bytes and arrays, lanes, n): route,
// copies, tile rows, shared memory and grid, and the instantiation.
struct Plan {
  bool priv, f64;
  int keys;                                  // kKeys
  int copies, tile_rows, stage, acc_bytes, smem, per_sm, blocks;
};

inline int64_t pad16(int64_t b) { return (b + 15) / 16 * 16; }

extern template Kernel kernel_for<1>(int, bool, bool);
extern template Kernel kernel_for<2>(int, bool, bool);
extern template Kernel kernel_for<3>(int, bool, bool);
extern template Kernel kernel_for<4>(int, bool, bool);

// The kernel the plan runs: its lanes, route, whether a lane is float64
// and its keys.
template <int K>
Kernel kernel_of(const Plan& pl) {
  switch (pl.keys) {
    case 0: return kernel_for<0>(K, pl.priv, pl.f64);
    case 1: return kernel_for<1>(K, pl.priv, pl.f64);
    case 2: return kernel_for<2>(K, pl.priv, pl.f64);
    case 3: return kernel_for<3>(K, pl.priv, pl.f64);
    case 4: return kernel_for<4>(K, pl.priv, pl.f64);
  }
  return nullptr;
}

template <int K>
cudaError_t grid_of(Plan& pl, int64_t n) {
  const Kernel kern = kernel_of<K>(pl);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &pl.per_sm, kern, kThreads, pl.smem)) != cudaSuccess)
    return err;
  const int64_t ntiles = (n + pl.tile_rows - 1) / pl.tile_rows;
  const int64_t fill = (int64_t)sms * (pl.per_sm > 0 ? pl.per_sm : 1);
  pl.blocks = (int)(ntiles < fill ? (ntiles > 0 ? ntiles : 1) : fill);
  return cudaSuccess;
}

template <int K>
cudaError_t plan_for(Plan& pl, int dp, int row_bytes, int arrays, int64_t n) {
  int64_t rows = kStageTarget / row_bytes / kChunkRows * kChunkRows;
  if (rows < kChunkRows) rows = kChunkRows;
  auto total = [&](int64_t acc, int64_t r) {
    return pad16(acc) + kStages * stage_bytes(r, row_bytes, arrays);
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
  pl.stage = (int)stage_bytes(rows, row_bytes, arrays);
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
  kernel_of<K>(pl)<<<pl.blocks, kThreads, pl.smem, s>>>(p);
  return cudaGetLastError();
}

// A call's description: its keys, mask, sources and lanes; the pointers,
// minimums and strides may be null where only the plan is wanted.
struct Desc {
  int nkeys, key_dtype;
  void* const* keys;
  const long long* mins;
  const long long* strides;
  int has_mask;
  const void* mask;
  int nsrc;
  void* const* srcs;
  const int* dtypes;                         // the sources'
  int k;
  const int* lane_a;
  const int* lane_b;
};

// Checks the description and makes the plan; fills p when p is given.
inline cudaError_t plan(const Desc& d, int dp, int64_t n, Plan& pl,
                        Params* p) {
  const int kd = d.key_dtype;
  if (d.k < 1 || d.k > kMaxLanes || dp < 1 ||
      (int64_t)dp * d.k > kMaxEntries || d.nkeys < 1 ||
      d.nkeys > kMaxKeys || d.nsrc < 0 || d.nsrc > kMaxSources ||
      !(kd == kI64 || kd == kI32 || kd == kI16 || kd == kI8))
    return cudaErrorInvalidValue;
  int row_bytes = d.nkeys * dtype_bytes(kd) + (d.has_mask ? 1 : 0);
  for (int s = 0; s < d.nsrc; ++s) {
    if (d.dtypes[s] < kI64 || d.dtypes[s] > kF64) return cudaErrorInvalidValue;
    row_bytes += dtype_bytes(d.dtypes[s]);
  }
  // the code form: one int32 key of minimum 0 and stride 1, no mask, lane
  // j the sum of source j
  bool code = d.nkeys == 1 && kd == kI32 && !d.has_mask && d.nsrc == d.k &&
              (d.mins == nullptr || (d.mins[0] == 0 && d.strides[0] == 1));
  pl.f64 = false;
  for (int j = 0; j < d.k; ++j) {
    code = code && d.lane_a[j] == j && d.lane_b[j] < 0;
    const int a = d.lane_a[j], b = d.lane_b[j];
    if (a < -1 || a >= d.nsrc || b < -1 || b >= d.nsrc || (a < 0 && b >= 0))
      return cudaErrorInvalidValue;
    if (b >= 0 && (d.dtypes[a] == kF64 || d.dtypes[b] == kF64))
      return cudaErrorInvalidValue;          // products of integers only
    pl.f64 = pl.f64 || (a >= 0 && b < 0 && d.dtypes[a] == kF64);
  }
  pl.keys = code ? 0 : d.nkeys;
  const int arrays = d.nkeys + (d.has_mask ? 1 : 0) + d.nsrc;
  cudaError_t err = cudaErrorInvalidValue;
  switch (d.k) {
    case 1: err = plan_for<1>(pl, dp, row_bytes, arrays, n); break;
    case 2: err = plan_for<2>(pl, dp, row_bytes, arrays, n); break;
    case 3: err = plan_for<3>(pl, dp, row_bytes, arrays, n); break;
    case 4: err = plan_for<4>(pl, dp, row_bytes, arrays, n); break;
    case 5: err = plan_for<5>(pl, dp, row_bytes, arrays, n); break;
    case 6: err = plan_for<6>(pl, dp, row_bytes, arrays, n); break;
    case 7: err = plan_for<7>(pl, dp, row_bytes, arrays, n); break;
    case 8: err = plan_for<8>(pl, dp, row_bytes, arrays, n); break;
  }
  if (err != cudaSuccess || p == nullptr) return err;
  // the arrays in stage order: the keys, the mask, the sources
  const int src = arrays - d.nsrc;
  int seg = 0;
  for (int a = 0; a < arrays; ++a) {
    const void* ptr = a < d.nkeys ? d.keys[a] : a < src ? d.mask
                                                        : d.srcs[a - src];
    p->ptr[a] = static_cast<const unsigned char*>(ptr);
    p->width[a] = a < d.nkeys ? dtype_bytes(kd)
                  : a < src   ? 1
                              : dtype_bytes(d.dtypes[a - src]);
    p->seg[a] = seg;
    seg += pl.tile_rows * p->width[a] + 16;
  }
  auto off = [&](int a) {
    return p->seg[a] + (int)((uintptr_t)p->ptr[a] & 15);
  };
  p->arrays = arrays;
  for (int q = 0; q < d.nkeys; ++q) {
    p->key_off[q] = off(q);
    p->kmin[q] = d.mins[q];
    p->stride[q] = d.strides[q];
  }
  p->key_dtype = kd;
  p->mask_off = d.has_mask ? off(d.nkeys) : -1;
  for (int j = 0; j < d.k; ++j) {
    const int a = d.lane_a[j], b = d.lane_b[j];
    p->a_off[j] = a < 0 ? 0 : off(src + a);
    p->a_dt[j] = a < 0 ? -1 : d.dtypes[a] == kF64 ? kI64 : d.dtypes[a];
    p->f64 |= (unsigned)(a >= 0 && b < 0 && d.dtypes[a] == kF64) << j;
    p->b_off[j] = b < 0 ? 0 : off(src + b);
    p->b_dt[j] = b < 0 ? -1 : d.dtypes[b];
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

// keys: nkeys (1..4) device pointers to n-row integer columns of one dtype
// (key_dtype: 0 int64, 1 int32, 4 int16, 5 int8); a row's slot is
// sum_i (keys[i][r] - mins[i]) * strides[i], wrapping mod 2^64. mask: an
// n-row bool column (a row whose byte is 0 is dropped) or null. srcs: nsrc
// (0..8) device pointers to n-row columns, dtypes their codes (0 int64,
// 1 int32, 2 bool, 3 float64). k in 1..8 lanes: lane j sums source
// lane_a[j] (-1: 1 a row, the slot's row count), times source lane_b[j]
// where that is not -1 (integer and bool sources only, widened to int64).
// Rows whose slot is outside [0, dp) are dropped. Every array but the
// pointers lives in host memory. Any pointer alignment and any n >= 1.
// out: int64[dp * k], zeroed by the caller, row-major [dp][k]; a float64
// lane's words hold doubles (a zeroed word is +0.0). Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a bad description,
// a dp * k above aq_onehot_max_entries(), or accumulators that do not fit
// beside the staging of these rows); allocates nothing and does not
// synchronise. The code form: one int32 key, min 0, stride 1.
int aq_onehot_segment_sums(int nkeys, int key_dtype, void* const* keys,
                           const long long* mins, const long long* strides,
                           const void* mask, int nsrc, void* const* srcs,
                           const int* dtypes, int k, const int* lane_a,
                           const int* lane_b, int dp, int64_t n, void* out,
                           void* stream) {
  const aq_onehot::Desc d{nkeys, key_dtype, keys,   mins,   strides,
                          mask != nullptr,  mask,   nsrc,   srcs,
                          dtypes, k,        lane_a, lane_b};
  aq_onehot::Plan pl{};
  aq_onehot::Params p{};
  cudaError_t err = aq_onehot::plan(d, dp, n, pl, &p);
  if (err != cudaSuccess) return (int)err;
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

// The launch aq_onehot_segment_sums makes for this description (has_mask
// in place of the mask; a description the code form runs, planned as the
// code form), into info[8]: private route (1) or shared (0),
// accumulator copies per block, threads per block, blocks, tile rows,
// dynamic shared memory per block (bytes), blocks an SM holds, and one
// stage buffer's bytes. Returns a cudaError_t as aq_onehot_segment_sums
// does.
int aq_onehot_route(int nkeys, int key_dtype, int has_mask, int nsrc,
                    const int* dtypes, int k, const int* lane_a,
                    const int* lane_b, int dp, int64_t n, int* info) {
  const aq_onehot::Desc d{nkeys,   key_dtype, nullptr, nullptr, nullptr,
                          has_mask, nullptr,  nsrc,    nullptr, dtypes,
                          k,        lane_a,   lane_b};
  aq_onehot::Plan pl{};
  const cudaError_t err = aq_onehot::plan(d, dp, n, pl, nullptr);
  if (err != cudaSuccess) return (int)err;
  const int vals[8] = {pl.priv ? 1 : 0, pl.copies, aq_onehot::kThreads,
                       pl.blocks, pl.tile_rows, pl.smem, pl.per_sm, pl.stage};
  for (int i = 0; i < 8; ++i) info[i] = vals[i];
  return 0;
}

// The most entries (dp * k) a call takes.
int aq_onehot_max_entries() { return aq_onehot::kMaxEntries; }

}  // extern "C"
