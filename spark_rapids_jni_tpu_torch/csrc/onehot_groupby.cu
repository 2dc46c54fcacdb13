// One-hot group-by: per-bucket column sums with no one-hot in memory.
//
// Replaces: spark_rapids_jni_tpu/ops/pallas_kernels.py onehot_groupby_parts
// (-> _onehot_gb_call, kernels _onehot_gb_kernel / _onehot_gb_kernel_int),
// the contraction behind relational/aggregate.py group_by_onehot.
//
// Contract (same as the Pallas kernel): bucket int32[n] in [0, domain), -1
// for dead rows; int payload int8[n, mi] with |x| <= 128; float payload
// f32[n, mf].  Outputs int64[domain, mi] and f64[domain, mf] (zeroed by
// the caller) receive the per-bucket column sums.  Int sums are exact:
// int32 partials per block of fewer than 2^24 rows (so rows * 128 < 2^31
// cannot wrap), added into int64 with 64-bit atomics (mod 2^64, Spark's
// non-ANSI wraparound).  Float sums are f32 per block, then f64.
//
// What bounds it on the H100: the bytes of the payload, 4 + mi + 4 mf per
// row (27 B/row at q6's mi = 11, mf = 3), read once — a memory-bound
// kernel, ~0.14 ms at 2^24 rows and 3.35 TB/s.  The arithmetic is a
// handful of adds per payload byte, far below the card's rates.
//
// What the design does about it: the one-hot never exists.  Each block
// keeps its [domain tile, mi] int32 and [domain tile, mf] f32 partials in
// shared memory and adds each row's payload into its bucket's row with
// shared-memory atomics, so device memory sees the payload once and the
// small output once per block.  The Pallas kernel fed the TPU's matrix
// unit with a one-hot tile because the TPU has no fast scatter; Hopper
// has fast shared atomics, so the simple first version uses them.  When
// domain x (mi + mf) x 4 bytes exceeds the shared memory a block takes
// without opting in (48 KB), the domain is tiled over gridDim.y and each
// tile re-reads the rows it needs.  Atomic order makes float sums
// nondeterministic run to run, as Spark's own float sums are.  Later
// work: int8 tensor-core MMA, building the payload inside the kernel.

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

const char* srj_onehot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
