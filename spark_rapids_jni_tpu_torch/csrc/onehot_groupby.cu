// One-hot group-by: per-bucket column sums with no one-hot in memory.
//
// Replaces: spark_rapids_jni_tpu/ops/pallas_kernels.py onehot_groupby_parts
// (-> _onehot_gb_call, kernels _onehot_gb_kernel / _onehot_gb_kernel_int),
// the contraction behind relational/aggregate.py group_by_onehot.
//
// Two kernels.  onehot_columns is the main path's: it reads the raw
// columns once — the key (int32/int64) and its validity, the row-live
// mask, each referenced column's validity, each int sum column's data
// (bool/int32/int64) and each float sum column's f64 data — and computes
// in registers what the reference builds as a payload and contracts:
//   * the bucket: clamp(k, 0, K - 1) for a live non-null key, K for a
//     live null key, none for a dead row; the out-of-domain flag (a live
//     non-null key outside [0, K)) is written on the device;
//   * count(*) and each column's non-null count;
//   * each int sum in uint64 adds, mod 2^64 — Spark's non-ANSI wrap, the
//     same bits as the reference's eight offset byte limbs recombined;
//   * each float sum through the f32x3 Dekker split (hi, mid, lo summed
//     in f32 per block, then f64), so the reference's tolerance holds.
// Outputs (zeroed by the caller): uint64[K + 1, 1 + nc + ni] (count(*),
// the nc counts, the ni int sums) and f64[K + 1, 3 nf] (hi, mid, lo).
//
// onehot_gb_kernel is the reference's contract entry: bucket int32[n] in
// [0, domain), -1 for dead rows; int payload int8[n, mi] with |x| <= 128;
// float payload f32[n, mf] — int32 partials per block of fewer than 2^24
// rows, float partials f32 per block, added into int64 / f64 outputs.
//
// What bounds them on the H100: bytes.  onehot_columns reads about 24 B a
// row at q6 (key 4 + 1, v 8 + 1, price 8 + 1, live 1): ~0.12 ms at 2^24
// rows and 3.35 TB/s; the adds are a few a byte.  The contract kernel
// reads 4 + mi + 4 mf bytes a row of a payload someone had to build.
//
// What the designs do: each block keeps its partials in shared memory
// and adds each row into its bucket's row with shared-memory atomics, so
// device memory sees the columns once and the small output once per
// block.  On sm_90 a shared f32 or u64 atomicAdd is a compare-and-swap
// loop (ATOMS.CAST.SPIN) and a u32 +1 a warp-aggregated ATOMS.POPC.INC,
// so onehot_columns keeps its counts in u32 (0.45 -> 0.33 ms at q6)
// and only the int sums in u64.  Measured and not kept: a copy of the
// partials per warp (no gain on ~100 hot buckets) and lanes of a warp
// adding a bucket's values first (labeled_partition + reduce: 2.5x
// slower).  A domain whose partials pass a block's 48 KB is tiled over
// gridDim.y; each tile re-reads the rows.  Atomic order makes float sums
// nondeterministic run to run, as Spark's own float sums are.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kHasFloat>
__global__ void __launch_bounds__(kThreads)
onehot_gb_kernel(const int32_t* __restrict__ bucket,
                 const int8_t* __restrict__ pi,
                 const float* __restrict__ pf,
                 unsigned long long* __restrict__ oi,
                 double* __restrict__ of,
                 long long n, int mi, int mf, int domain, int dtile,
                 long long rows_per_block) {
  extern __shared__ int smem[];
  int* si = smem;
  float* sf = reinterpret_cast<float*>(smem + dtile * mi);
  const int d0 = blockIdx.y * dtile;
  const int dt = min(dtile, domain - d0);
  for (int t = threadIdx.x; t < dt * mi; t += blockDim.x) si[t] = 0;
  if (kHasFloat)
    for (int t = threadIdx.x; t < dt * mf; t += blockDim.x) sf[t] = 0.0f;
  __syncthreads();

  const long long lo = (long long)blockIdx.x * rows_per_block;
  const long long hi = min(n, lo + rows_per_block);
  for (long long r = lo + threadIdx.x; r < hi; r += blockDim.x) {
    const int b = bucket[r] - d0;
    if (b < 0 || b >= dt) continue;  // dead row (-1) or another tile
    const int8_t* prow = pi + r * mi;
    int* srow = si + b * mi;
    for (int j = 0; j < mi; ++j) {
      const int x = prow[j];
      if (x != 0) atomicAdd(srow + j, x);
    }
    if (kHasFloat) {
      const float* frow = pf + r * mf;
      float* sfrow = sf + b * mf;
      for (int j = 0; j < mf; ++j) {
        const float x = frow[j];
        if (x != 0.0f) atomicAdd(sfrow + j, x);
      }
    }
  }
  __syncthreads();

  // the tile's rows are contiguous in the row-major outputs
  unsigned long long* oit = oi + (long long)d0 * mi;
  for (int t = threadIdx.x; t < dt * mi; t += blockDim.x) {
    const int v = si[t];
    if (v != 0) atomicAdd(oit + t, (unsigned long long)(long long)v);
  }
  if (kHasFloat) {
    double* oft = of + (long long)d0 * mf;
    for (int t = threadIdx.x; t < dt * mf; t += blockDim.x) {
      const float v = sf[t];
      if (v != 0.0f) atomicAdd(oft + t, (double)v);
    }
  }
}

constexpr int kMaxCols = 16;  // referenced columns per group-by

struct Cols {
  const void* key;            // int32[n] or int64[n]
  int key_bytes;              // 4 or 8
  const uint8_t* key_valid;   // bool[n]
  const uint8_t* live;        // bool[n]; null: every row live
  const uint8_t* cvalid[kMaxCols];  // validity of each counted column
  const void* idata[kMaxCols];      // int sum columns
  const uint8_t* ivalid[kMaxCols];
  int ibytes[kMaxCols];             // 1 (bool), 4 or 8
  const double* fdata[kMaxCols];    // float sum columns
  const uint8_t* fvalid[kMaxCols];
  int nc, ni, nf;
  long long n;
  int K;         // buckets 0..K, K = the null key
  int dtile;     // buckets per gridDim.y tile
  unsigned long long* oi;  // [K + 1, 1 + nc + ni]
  double* of;              // [K + 1, 3 nf]
  uint8_t* overflow;
};

__device__ __forceinline__ long long load_int(const void* p, int bytes,
                                              long long r) {
  if (bytes == 8) return static_cast<const long long*>(p)[r];
  if (bytes == 4) return static_cast<const int*>(p)[r];
  return static_cast<const uint8_t*>(p)[r];
}

// shared-memory bytes of one bucket's partials: u64 int sums, u32
// counts, f32 float limbs
__host__ __device__ inline int bucket_bytes(int nc, int ni, int nf) {
  return 8 * ni + 4 * (1 + nc) + 12 * nf;
}

template <bool kHasFloat>
__global__ void __launch_bounds__(kThreads) onehot_columns(Cols a) {
  // [dtile] rows of ni u64 sums, then of 1 + nc u32 counts, then of 3 nf
  // f32 limbs
  extern __shared__ __align__(8) unsigned long long sbuf[];
  const int nk = 1 + a.nc;  // count(*) and the non-null counts
  const int mi = nk + a.ni;
  const int mf = 3 * a.nf;
  const int K = a.K;
  const int d0 = blockIdx.y * a.dtile;
  const int dt = min(a.dtile, K + 1 - d0);
  unsigned long long* ss = sbuf;
  unsigned* sc = reinterpret_cast<unsigned*>(ss + a.dtile * a.ni);
  float* sf = reinterpret_cast<float*>(sc + a.dtile * nk);
  for (int t = threadIdx.x; t < dt * a.ni; t += blockDim.x) ss[t] = 0;
  for (int t = threadIdx.x; t < dt * nk; t += blockDim.x) sc[t] = 0;
  if (kHasFloat)
    for (int t = threadIdx.x; t < dt * mf; t += blockDim.x) sf[t] = 0.0f;
  __syncthreads();

  const bool flag = blockIdx.y == 0;  // one tile reports the overflow
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < a.n; r += stride) {
    if (a.live && !a.live[r]) continue;  // dead row
    int b = K;                           // null key
    if (a.key_valid[r]) {
      const long long k = a.key_bytes == 8
                              ? static_cast<const long long*>(a.key)[r]
                              : static_cast<const int*>(a.key)[r];
      if (k < 0 || k >= K) {
        if (flag) *a.overflow = 1;
        b = k < 0 ? 0 : K - 1;
      } else {
        b = (int)k;
      }
    }
    b -= d0;
    if (b < 0 || b >= dt) continue;  // another tile's bucket
    unsigned* crow = sc + b * nk;
    atomicAdd(crow, 1u);
    for (int j = 0; j < a.nc; ++j)
      if (a.cvalid[j][r]) atomicAdd(crow + 1 + j, 1u);
    unsigned long long* srow = ss + b * a.ni;
    for (int j = 0; j < a.ni; ++j) {
      if (!a.ivalid[j][r]) continue;
      const long long v = load_int(a.idata[j], a.ibytes[j], r);
      if (v) atomicAdd(srow + j, (unsigned long long)v);
    }
    if (kHasFloat) {
      float* frow = sf + b * mf;
      for (int j = 0; j < a.nf; ++j) {
        if (!a.fvalid[j][r]) continue;
        const double v = a.fdata[j][r];
        if (v == 0.0) continue;
        // exact split of v into f32 hi + mid + lo
        const float hi = (float)v;
        const double r1 = v - (double)hi;
        const float mid = (float)r1;
        const float lo = (float)(r1 - (double)mid);
        atomicAdd(frow + 3 * j, hi);
        if (mid != 0.0f) atomicAdd(frow + 3 * j + 1, mid);
        if (lo != 0.0f) atomicAdd(frow + 3 * j + 2, lo);
      }
    }
  }
  __syncthreads();

  // one global atomic per bucket and column; the tile's rows are
  // contiguous in the row-major outputs
  unsigned long long* oit = a.oi + (long long)d0 * mi;
  for (int t = threadIdx.x; t < dt * nk; t += blockDim.x) {
    const unsigned v = sc[t];
    if (v) atomicAdd(oit + (t / nk) * mi + t % nk, (unsigned long long)v);
  }
  for (int t = threadIdx.x; t < dt * a.ni; t += blockDim.x) {
    const unsigned long long v = ss[t];
    if (v) atomicAdd(oit + (t / a.ni) * mi + nk + t % a.ni, v);
  }
  if (kHasFloat) {
    double* oft = a.of + (long long)d0 * mf;
    for (int t = threadIdx.x; t < dt * mf; t += blockDim.x) {
      const float v = sf[t];
      if (v != 0.0f) atomicAdd(oft + t, (double)v);
    }
  }
}

}  // namespace

extern "C" {

// Shared memory one block takes without opting in to more.
int srj_onehot_smem_limit() { return 48 * 1024; }

// Largest block of rows whose int32 partials cannot wrap: rows * 128 < 2^31.
long long srj_onehot_max_block_rows() { return (1LL << 24) - 1; }

int srj_onehot_groupby(const void* bucket, const void* pi, const void* pf,
                       void* oi, void* of, long long n, int mi, int mf,
                       int domain, int dtile, long long rows_per_block,
                       void* stream) {
  if (n <= 0 || domain <= 0 || (mi == 0 && mf == 0)) return 0;
  const long long gx = (n + rows_per_block - 1) / rows_per_block;
  const int gy = (domain + dtile - 1) / dtile;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  const size_t smem = (size_t)dtile * (mi + mf) * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mf > 0) {
    onehot_gb_kernel<true><<<grid, kThreads, smem, s>>>(
        static_cast<const int32_t*>(bucket), static_cast<const int8_t*>(pi),
        static_cast<const float*>(pf), static_cast<unsigned long long*>(oi),
        static_cast<double*>(of), n, mi, mf, domain, dtile, rows_per_block);
  } else {
    onehot_gb_kernel<false><<<grid, kThreads, smem, s>>>(
        static_cast<const int32_t*>(bucket), static_cast<const int8_t*>(pi),
        nullptr, static_cast<unsigned long long*>(oi), nullptr, n, mi, 0,
        domain, dtile, rows_per_block);
  }
  return (int)cudaGetLastError();
}

// The fused group-by over raw columns.  ptrs (host array of device
// pointers): cvalid[nc], then idata[ni], ivalid[ni], then fdata[nf],
// fvalid[nf]; ibytes[ni] (host).  key int32/int64[n] (key_bytes),
// key_valid bool[n], live bool[n] or null; outputs oi uint64[K + 1, 1 + nc
// + ni] and of f64[K + 1, 3 nf] zeroed, overflow uint8[1] zeroed.
// dtile: buckets per gridDim.y tile; dtile * (8 ni + 4 (1 + nc) + 12 nf)
// <= the shared-memory limit (a block's count partials are u32: n <
// 2^31 rows).
int srj_onehot_columns(const void* key, int key_bytes, const void* key_valid,
                       const void* live, const int64_t* ptrs,
                       const int* ibytes, int nc, int ni, int nf, void* oi,
                       void* of, void* overflow, long long n, int K,
                       int dtile, int device, void* stream) {
  if (n <= 0) return 0;
  if (nc < 0 || ni < 0 || nf < 0 || nc > kMaxCols || ni > kMaxCols ||
      nf > kMaxCols || K < 1 || dtile < 1 ||
      (key_bytes != 4 && key_bytes != 8))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)dtile * bucket_bytes(nc, ni, nf);
  if (smem > (size_t)srj_onehot_smem_limit())
    return (int)cudaErrorInvalidValue;
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Cols a;
  a.key = key;
  a.key_bytes = key_bytes;
  a.key_valid = static_cast<const uint8_t*>(key_valid);
  a.live = static_cast<const uint8_t*>(live);
  int at = 0;
  for (int j = 0; j < nc; ++j)
    a.cvalid[j] = reinterpret_cast<const uint8_t*>(ptrs[at++]);
  for (int j = 0; j < ni; ++j)
    a.idata[j] = reinterpret_cast<const void*>(ptrs[at++]);
  for (int j = 0; j < ni; ++j) {
    a.ivalid[j] = reinterpret_cast<const uint8_t*>(ptrs[at++]);
    a.ibytes[j] = ibytes[j];
    if (ibytes[j] != 1 && ibytes[j] != 4 && ibytes[j] != 8)
      return (int)cudaErrorInvalidValue;
  }
  for (int j = 0; j < nf; ++j)
    a.fdata[j] = reinterpret_cast<const double*>(ptrs[at++]);
  for (int j = 0; j < nf; ++j)
    a.fvalid[j] = reinterpret_cast<const uint8_t*>(ptrs[at++]);
  a.nc = nc;
  a.ni = ni;
  a.nf = nf;
  a.n = n;
  a.K = K;
  a.dtile = dtile;
  a.oi = static_cast<unsigned long long*>(oi);
  a.of = static_cast<double*>(of);
  a.overflow = static_cast<uint8_t*>(overflow);
  const void* fn = nf ? (const void*)onehot_columns<true>
                      : (const void*)onehot_columns<false>;
  int per_sm = 0, sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  long long gx = (n + kThreads - 1) / kThreads;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (gx > resident) gx = resident;
  const int gy = (K + 1 + dtile - 1) / dtile;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nf)
    onehot_columns<true><<<grid, kThreads, smem, s>>>(a);
  else
    onehot_columns<false><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

const char* srj_onehot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
