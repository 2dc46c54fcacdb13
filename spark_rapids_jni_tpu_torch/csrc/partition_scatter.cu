// Partition scatter: one morsel, as the map step leaves it, into the send
// chunks of every round it touches, for every shard of the mesh in one
// launch.
//
// Replaces: spark_rapids_jni_tpu/ops/pallas_kernels.py partition_scatter
// (kernel _part_scatter_kernel), the fused twin of shuffle/service.py
// _scatter_step.  Products are bit-identical to that lax formulation.
//
// The Pallas kernel takes each shard's rows regrouped destination-major
// (XLA regroups cheaply on the TPU) and one round per call.  Here the
// morsel comes in map order: shard s holds rows [s*M, (s+1)*M) of every
// leaf, and pid[row] in [0, P] is its destination (P = the null partition:
// dead rows, padding and out-of-range ids, which drop).  Within a shard
// the stable position of a row in bucket d of the regrouped form is its
// rank among the shard's rows with pid d, so the row goes to
//   k = base[s, d] + rank,   round k / C,   slot (s*P + d)*C + k % C
// of that round's chunk, with occ set — the same slot as the regrouped
// form.  base[s, :] (int64) holds the shard's cumulative bucket counts
// before this morsel.  Rows whose round lies outside [r_lo, r_hi] are not
// written (the caller gives every round the morsel touches, computed on
// the host from base and the counts; the regrouped entry passes one).
//
// Design: a thread-block cluster per shard (up to 8 blocks of 512
// threads, one per 512-row tile of the shard's M rows; more tiles a
// block past 4096 rows).  Each block first
// counts its rows per destination; after a cluster barrier it sums the
// counts of the blocks before it through distributed shared memory, which
// gives each bucket's starting rank in the block.  It then walks its
// tiles: each warp groups its lanes by destination with
// __match_any_sync (a lane's rank in the warp is the popcount of its
// lower peers), the leader of each group writes the group's size into a
// shared [16 warps][P] table, one warp per bucket turns its column into
// an exclusive prefix over the warps (a shuffle scan), and running
// per-bucket counters
// carry the ranks from tile to tile: ranks are stable in row order with
// no sort and no gather.  The chunk pointers of every open round live in
// a device table dir[round][leaf..., occ] that the host writes once when
// the round opens, so a launch passes only the morsel's leaf pointers.
// A row's leaves are loaded in batches of 8 before any is stored, so the
// loads overlap.  Shared memory is 12P + 32P bytes (run/tot/hist int32,
// the uint16 table): P <= 2048 (88 KB).  Targets are disjoint across
// rows, so the result does not depend on thread order.
//
// What bounds it on the H100: bytes.  A launch reads the morsel's leaves
// and pids once plus S*P base ints, and writes the placed rows and their
// occ bytes once: about 1.7 MB at the streamed fact table's shape (S 8,
// M 4096, 24 B a row), a bound of about 0.5 us.  At that size the launch
// and the host's call cost more than the copy, so the design's gain is
// one launch per morsel (not one per (morsel, round)) and no regroup
// before it.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;  // <= 32 lanes: one warp scans them
constexpr int kMaxLeaves = 64;
constexpr int kMaxPartitions = 2048;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kBatch = 8;       // leaves loaded before any is stored

struct Morsel {
  const char* leaf[kMaxLeaves];
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

__device__ __forceinline__ uint64_t load_unit(const char* p, int elem) {
  switch (elem) {
    case 8: return *reinterpret_cast<const uint64_t*>(p);
    case 4: return *reinterpret_cast<const uint32_t*>(p);
    case 2: return *reinterpret_cast<const uint16_t*>(p);
    default: return *reinterpret_cast<const uint8_t*>(p);
  }
}

__device__ __forceinline__ void store_unit(char* p, int elem, uint64_t v) {
  switch (elem) {
    case 8: *reinterpret_cast<uint64_t*>(p) = v; break;
    case 4: *reinterpret_cast<uint32_t*>(p) = (uint32_t)v; break;
    case 2: *reinterpret_cast<uint16_t*>(p) = (uint16_t)v; break;
    default: *reinterpret_cast<uint8_t*>(p) = (uint8_t)v; break;
  }
}

inline size_t smem_bytes(int P) {
  return 3 * (size_t)P * sizeof(int32_t) +
         (size_t)kWarps * P * sizeof(uint16_t);
}

// row src of the morsel -> slot t of the chunks in ptrs (leaves, then occ)
__device__ __forceinline__ void place(const Morsel& L, const int64_t* ptrs,
                                      int64_t t, int64_t src) {
  for (int l0 = 0; l0 < L.n; l0 += kBatch) {
    uint64_t v[kBatch];
    char* dst[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int l = l0 + u;
      if (l < L.n) {
        const int64_t w = L.row_bytes[l];
        dst[u] = reinterpret_cast<char*>(ptrs[l]) + t * w;
        if (w == L.elem_bytes[l])
          v[u] = load_unit(L.leaf[l] + src * w, (int)w);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int l = l0 + u;
      if (l < L.n) {
        const int64_t w = L.row_bytes[l];
        const int e = L.elem_bytes[l];
        if (w == e) {
          store_unit(dst[u], e, v[u]);
        } else {  // a leaf of several elements a row (e.g. 2-D)
          copy_row(dst[u], L.leaf[l] + src * w, w, e);
        }
      }
    }
  }
  reinterpret_cast<uint8_t*>(ptrs[L.n])[t] = 1;
}

__global__ void __launch_bounds__(kThreads)
part_scatter(Morsel Lp, const int32_t* __restrict__ pid,
             const int64_t* __restrict__ base,
             const int64_t* __restrict__ dir, int P, int64_t C, int M,
             int r_lo, int r_hi, int per) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ Morsel L;  // indexed by leaf at run time: keep it in smem
  extern __shared__ int32_t sh[];
  int32_t* run = sh;          // rows of each bucket before this tile
  int32_t* tot = sh + P;      // rows of each bucket in this tile
  int32_t* hist = sh + 2 * P; // rows of each bucket in this block
  uint16_t* tab = reinterpret_cast<uint16_t*>(sh + 3 * P);  // [warp][P]
  const int nb = (int)cluster.num_blocks();
  const int b = (int)cluster.block_rank();
  const int s = blockIdx.x / nb;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  {
    const int words = (int)(sizeof(Morsel) / sizeof(int32_t));
    const int32_t* from = reinterpret_cast<const int32_t*>(&Lp);
    int32_t* to = reinterpret_cast<int32_t*>(&L);
    for (int j = threadIdx.x; j < words; j += kThreads) to[j] = from[j];
  }
  for (int j = threadIdx.x; j < P; j += kThreads) hist[j] = 0;
  for (int j = threadIdx.x; j < kWarps * P; j += kThreads) tab[j] = 0;
  __syncthreads();
  const int32_t* ps = pid + (int64_t)s * M;
  const int64_t* bs = base + (int64_t)s * P;
  const int lo = b * per;
  const int hi = min(M, lo + per);
  // this block's rows per bucket
  for (int t0 = lo; t0 < hi; t0 += kThreads) {
    const int i = t0 + threadIdx.x;
    int d = i < hi ? ps[i] : P;
    const bool live = d >= 0 && d < P;
    if (!live) d = P;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (live && __popc(peers & lower) == 0) atomicAdd(hist + d, __popc(peers));
  }
  cluster.sync();
  // ranks before this block: the shard's earlier blocks' counts
  for (int j = threadIdx.x; j < P; j += kThreads) {
    int acc = 0;
    for (int q = 0; q < b; ++q) acc += cluster.map_shared_rank(hist, q)[j];
    run[j] = acc;
  }
  cluster.sync();  // no block leaves while another still reads its hist
  const int stride = L.n + 1;
  for (int t0 = lo; t0 < hi; t0 += kThreads) {
    const int i = t0 + threadIdx.x;
    int d = i < hi ? ps[i] : P;
    const bool live = d >= 0 && d < P;
    if (!live) d = P;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int below = __popc(peers & lower);
    if (live && below == 0) tab[warp * P + d] = (uint16_t)__popc(peers);
    __syncthreads();
    // one warp per bucket: lane w holds warp w's count; a shuffle scan
    // makes it the exclusive prefix
    for (int j = warp; j < P; j += kWarps) {
      const int c = lane < kWarps ? tab[lane * P + j] : 0;
      int x = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      if (lane < kWarps) tab[lane * P + j] = (uint16_t)(x - c);
      if (lane == 31) tot[j] = x;
    }
    __syncthreads();
    if (live) {
      const int64_t k = bs[d] + run[d] + tab[warp * P + d] + below;
      const int64_t rr = k / C;
      if (rr >= r_lo && rr <= r_hi) {
        place(L, dir + rr * stride, ((int64_t)s * P + d) * C + (k - rr * C),
              (int64_t)s * M + i);
      }
    }
    __syncthreads();
    for (int j = warp; j < P; j += kWarps) {
      if (lane < kWarps) tab[lane * P + j] = 0;
      if (lane == 0) run[j] += tot[j];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// One launch for S shards of M rows each.  leaf_ptrs / row_bytes /
// elem_bytes: nleaf entries each (host arrays); pid int32[S*M]; base
// int64[S, P]; dir int64[>= r_hi + 1, nleaf + 1] on the device (per
// round: the chunk pointer of every leaf, then occ).  Returns a
// cudaError_t.
int srj_partition_scatter(const int64_t* leaf_ptrs, const int64_t* row_bytes,
                          const int* elem_bytes, int nleaf, const void* pid,
                          const void* base, const void* dir, int S, int P,
                          long long C, int M, int r_lo, int r_hi,
                          int device, void* stream) {
  if (nleaf < 0 || nleaf > kMaxLeaves || P < 1 || P > kMaxPartitions ||
      S < 1 || M < 0 || C < 1 || r_lo < 0 || r_hi < r_lo) {
    return (int)cudaErrorInvalidValue;
  }
  if (M == 0) return (int)cudaSuccess;
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Morsel L;
  L.n = nleaf;
  for (int l = 0; l < nleaf; ++l) {
    L.leaf[l] = reinterpret_cast<const char*>(leaf_ptrs[l]);
    L.row_bytes[l] = row_bytes[l];
    L.elem_bytes[l] = elem_bytes[l];
  }
  const size_t smem = smem_bytes(P);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(part_scatter,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // one cluster per shard, one block per 512-row tile (at most 8)
  const int tiles = (M + kThreads - 1) / kThreads;
  const int nb = tiles < kMaxCluster ? tiles : kMaxCluster;
  const int per = ((tiles + nb - 1) / nb) * kThreads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(S * nb));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, part_scatter, L,
                           static_cast<const int32_t*>(pid),
                           static_cast<const int64_t*>(base),
                           static_cast<const int64_t*>(dir), P, (int64_t)C,
                           M, r_lo, r_hi, per);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* srj_partition_scatter_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

}  // extern "C"
