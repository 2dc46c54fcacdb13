// Partition scatter: one mapped morsel into one round's send chunk, for
// every shard of the mesh in one launch.
//
// Replaces: spark_rapids_jni_tpu/ops/pallas_kernels.py partition_scatter
// (kernel _part_scatter_kernel), the fused twin of shuffle/service.py
// _scatter_step.  Products are bit-identical to that lax formulation.
//
// Shard s of the morsel holds M rows, already regrouped destination-major
// by the map step; cnts[s, :P] are its per-destination row counts and
// base[s, :P] the cumulative counts of the same buckets before this morsel.
// For row i of shard s:
//   d = #{ends <= i}, ends = cumsum(cnts[s])      (upper-bound search)
//   k = base[s, d] + i - offs[d], offs = ends - cnts[s]
// and when d < P and r*C <= k < (r+1)*C the row copies every leaf to slot
//   t = (s*P + d)*C + k - r*C
// of the chunk and sets occ[t].  Everything else drops: rows at or past
// sum(cnts[s]) (padding, the null partition) have d == P and never clamp
// into partition P-1.
//
// Design: grid (ceil(M / 256), S), one thread per row.  Each block loads
// its shard's cnts and base rows into shared memory and forms the prefix
// sums there (P is small: the exchange's partition count).  A thread's
// search is over those P ends in shared memory; its row then moves leaf
// by leaf in units of the leaf's element size (1, 2, 4 or 8 bytes; a
// leaf wider than one element per row, e.g. a 2-D decimal leaf, loops
// over its bytes-per-row).  The chunk is written in place: targets are
// disjoint per (morsel, round), so the result does not depend on thread
// order, and consecutive rows of one bucket land on consecutive slots,
// so the writes coalesce.
//
// What bounds it on the H100: bytes.  A launch reads the morsel's leaves
// once (S*M rows) plus 2*S*P ints, and writes the rows of this round
// once plus their occ bytes: about 1.6 MB at the streamed fact table's
// shape (S 8, M 4096, 24 B a row), a bound of about 0.5 us — so each
// launch is set by launch latency, and the stream by how many (morsel,
// round) launches it needs.  Later work: one launch per morsel for all
// the rounds it touches.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 64;
constexpr int kMaxPartitions = 2048;  // 3 * P int64 in shared memory

struct Leaves {
  char* chunk[kMaxLeaves];
  const char* morsel[kMaxLeaves];
  int64_t row_bytes[kMaxLeaves];
  int elem_bytes[kMaxLeaves];
  int n;
};

template <typename T>
__device__ __forceinline__ void copy_units(char* dst, const char* src,
                                           int64_t units) {
  T* d = reinterpret_cast<T*>(dst);
  const T* s = reinterpret_cast<const T*>(src);
  for (int64_t u = 0; u < units; ++u) d[u] = s[u];
}

__device__ __forceinline__ void copy_row(char* dst, const char* src,
                                         int64_t row_bytes, int elem) {
  const int64_t units = row_bytes / elem;
  switch (elem) {
    case 8: copy_units<uint64_t>(dst, src, units); break;
    case 4: copy_units<uint32_t>(dst, src, units); break;
    case 2: copy_units<uint16_t>(dst, src, units); break;
    default: copy_units<uint8_t>(dst, src, row_bytes); break;
  }
}

__global__ void part_scatter(Leaves L, uint8_t* __restrict__ occ,
                             const int32_t* __restrict__ cnts,
                             const int32_t* __restrict__ base, int P,
                             int64_t C, int M, int64_t r) {
  extern __shared__ int64_t sh[];
  int64_t* ends = sh;
  int64_t* offs = sh + P;
  int64_t* bs = sh + 2 * P;
  const int s = blockIdx.y;
  const int32_t* cs = cnts + (int64_t)s * P;
  const int32_t* b0 = base + (int64_t)s * P;
  for (int j = threadIdx.x; j < P; j += blockDim.x) bs[j] = b0[j];
  if (threadIdx.x == 0) {
    int64_t acc = 0;
    for (int j = 0; j < P; ++j) {
      offs[j] = acc;
      acc += cs[j];
      ends[j] = acc;
    }
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  // upper bound: the first j with ends[j] > i, i.e. #{ends <= i}
  int lo = 0, hi = P;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ends[mid] <= i) lo = mid + 1; else hi = mid;
  }
  const int d = lo;
  if (d >= P) return;  // padding / null-partition rows drop
  const int64_t k = bs[d] + (i - offs[d]);
  const int64_t r0 = r * C;
  if (k < r0 || k >= r0 + C) return;  // another round's slot
  const int64_t t = ((int64_t)s * P + d) * C + (k - r0);
  const int64_t src = (int64_t)s * M + i;
  for (int l = 0; l < L.n; ++l) {
    const int64_t w = L.row_bytes[l];
    copy_row(L.chunk[l] + t * w, L.morsel[l] + src * w, w, L.elem_bytes[l]);
  }
  occ[t] = 1;
}

}  // namespace

extern "C" {

// Launch one scatter of S shards' morsels (M rows each) into round r of a
// chunk of S * P * C slots.  chunk_ptrs / morsel_ptrs / row_bytes /
// elem_bytes: nleaf entries each (host arrays).  Returns a cudaError_t.
int srj_partition_scatter(const int64_t* chunk_ptrs,
                          const int64_t* morsel_ptrs,
                          const int64_t* row_bytes, const int* elem_bytes,
                          int nleaf, void* occ, const void* cnts,
                          const void* base, int S, int P, long long C, int M,
                          long long r, void* stream) {
  if (nleaf < 0 || nleaf > kMaxLeaves || P < 1 || P > kMaxPartitions ||
      S < 1 || S > 65535 || M < 0 || C < 1 || r < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (M == 0) return (int)cudaSuccess;
  Leaves L;
  L.n = nleaf;
  for (int l = 0; l < nleaf; ++l) {
    L.chunk[l] = reinterpret_cast<char*>(chunk_ptrs[l]);
    L.morsel[l] = reinterpret_cast<const char*>(morsel_ptrs[l]);
    L.row_bytes[l] = row_bytes[l];
    L.elem_bytes[l] = elem_bytes[l];
  }
  dim3 grid((unsigned)((M + kThreads - 1) / kThreads), (unsigned)S);
  const size_t smem = 3 * (size_t)P * sizeof(int64_t);
  part_scatter<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      L, static_cast<uint8_t*>(occ), static_cast<const int32_t*>(cnts),
      static_cast<const int32_t*>(base), P, (int64_t)C, M, (int64_t)r);
  return (int)cudaGetLastError();
}

const char* srj_partition_scatter_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

}  // extern "C"
