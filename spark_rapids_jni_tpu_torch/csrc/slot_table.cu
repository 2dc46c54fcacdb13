// Open-addressing slot table: build in synchronous rounds, probe by chain walk.
//
// Replaces: spark_rapids_jni_tpu/ops/pallas_kernels.py slot_table_build
// (-> _slot_build_call, kernel _slot_build_kernel) and slot_table_probe
// (-> _slot_probe_call, kernel _slot_probe_kernel), the fused twins of
// relational/hashtable.py build_slot_table / probe_slot_table.  Both
// products are bit-identical to the reference's lax formulation.
//
// Keys are W u32 words per row.  The candidate chain is the reference's:
// cand0 = fold_hash(words) & (S - 1), FNV-1a over the words then a
// lowbias32-style finalizer, and round r probes (cand0 + r) & (S - 1).
//
// Build: ONE cooperative launch (cudaLaunchCooperativeKernel) runs every
// round; its grid is at most the co-resident blocks and at most what the
// rows need, rows covered grid-stride.  The reference's round is claim
// (every active row proposes its row id for its candidate slot), elect
// (an EMPTY slot takes the minimum proposal: the minimum live row id of
// the slot's key, the representative row the sort engine exposes — a
// first-come atomicCAS insert would not be), retire (a row whose words
// equal its slot owner's takes the slot).  Here table[c] packs (round,
// row id) in 64 bits, so one atomicMin is claim and elect at once: an
// empty slot takes the round's minimum row id, and an owner from an
// earlier round has the smaller tag and stays.  A round is then ONE
// phase, followed by one grid-wide barrier (cooperative_groups grid
// sync): every visited row reads its slot's final owner, retires on a
// match, or goes on the next round's worklist and claims its next slot
// (that claim cannot change an owner this round reads: such a slot is
// already taken, with a smaller tag).  Round 0 visits every row; round
// r > 0 only its worklist, so the long tail of a chain-bound build (46
// rounds for the join build) costs the rows still active, not n.  After
// the barrier every thread reads the worklist's length; the kernel stops
// when it is zero or at max_rounds, unpacks owner and writes the
// overflow flag itself, so the host reads nothing during a build.  The
// layout is the round-synchronous one, so owner, slot and overflow are
// bit-identical to the plain version for every max_rounds.  The words
// are read straight from the int64 carriers (their low 32 bits) through
// W pointers.
//
// What bounds it on the H100: bytes.  The build reads each row's words
// (8W B as carried) and liveness once and writes slot (4 B) per row and
// owner (4 B) per slot.  Past that it pays one grid barrier a round
// (about 1.3 us) and the latency of a visited row's dependent reads.
// Two hot spots are pre-reduced before the global atomicMin of a claim:
//   * S <= kSmallSlots (the q6 group-by build, S 4096): each block keeps
//     its own table in shared memory, claims with shared atomics, and
//     flushes one global atomicMin per touched slot;
//   * otherwise (the join build, S 2^22): lanes of a warp that claim the
//     same slot agree with __match_any_sync and __reduce_min_sync, and
//     one lane claims their minimum row id.
//
// Probe: one thread per probe row walks its chain over owner and the
// owners' words gathered once into [S, W]; no VMEM-style size cutoff —
// the table lives in device memory at every S.  Random reads of owner
// and the gathered words miss L2 when the table (48 MB at S = 2^22)
// does not fit the 50 MB cache.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBuildThreads = 512;
constexpr int kMaxWords = 32;
constexpr int kSmallSlots = 4096;  // 32 KB of shared claims per block

__device__ __forceinline__ uint32_t finalize(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  return h ^ (h >> 16);
}

__device__ __forceinline__ uint32_t fold_hash(const uint32_t* w, int W) {
  uint32_t h = 2166136261u;
  for (int j = 0; j < W; ++j) h = (h ^ w[j]) * 16777619u;
  return finalize(h);
}

// the build's key words: W int64 carriers of u32 lanes
struct Words {
  const long long* w[kMaxWords];
  int W;
};

// table[c] packs (round claimed, owner row id) so that one atomicMin
// both elects the minimum claimant of an empty slot and leaves an owner
// from an earlier round in place
constexpr unsigned long long kEmpty = ~0ull;

struct Build {
  Words k;
  const uint8_t* live;
  int32_t* cand0;
  int32_t* list;   // [2, n] worklists of the rows a round visits
  int32_t* slot;
  int32_t* owner;
  unsigned long long* table;  // [S]
  int* cnt;        // [3] rotating worklist lengths
  uint8_t* overflow;
  int n, S, max_rounds;
};

__device__ __forceinline__ uint32_t word(const Words& k, int j, int i) {
  return (uint32_t)(unsigned long long)k.w[j][i];
}

__device__ __forceinline__ uint32_t row_hash(const Words& k, int i) {
  uint32_t h = 2166136261u;
  for (int j = 0; j < k.W; ++j) h = (h ^ word(k, j, i)) * 16777619u;
  return finalize(h);
}

__device__ __forceinline__ bool same_key(const Words& k, int a, int b) {
  for (int j = 0; j < k.W; ++j)
    if (word(k, j, a) != word(k, j, b)) return false;
  return true;
}

// row i claims slot c in round r; called by every lane of the warp
// together (act false for lanes without a claim)
template <bool kSmall>
__device__ __forceinline__ void claim(bool act, int c, int i, int r,
                                      unsigned long long* table,
                                      unsigned long long* stab) {
  const unsigned long long tag = (unsigned long long)r << 32;
  if (kSmall) {
    if (act) atomicMin(stab + c, tag | (unsigned)i);
    return;
  }
  const unsigned am = __ballot_sync(0xffffffffu, act);
  if (!act) return;
  const unsigned peers = __match_any_sync(am, c);
  const int lo = __reduce_min_sync(peers, i);
  if ((int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicMin(table + c, tag | (unsigned)lo);
}

// small mode: one global atomicMin per slot this block claimed
__device__ __forceinline__ void flush(unsigned long long* table,
                                      unsigned long long* stab, int S) {
  __syncthreads();
  for (int c = threadIdx.x; c < S; c += blockDim.x) {
    const unsigned long long v = stab[c];
    if (v != kEmpty) {
      atomicMin(table + c, v);
      stab[c] = kEmpty;
    }
  }
}

// Round 0 visits every row (live ones take part); round r > 0 visits
// only the rows that failed round r - 1, compacted into a worklist.
template <bool kSmall>
__global__ void __launch_bounds__(kBuildThreads) slot_build(Build a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ unsigned long long stab[];  // [S] in small mode
  const int n = a.n, S = a.S, mask = S - 1;
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long warp0 = gtid - lane;  // warp-uniform row loops
  for (long long c = gtid; c < S; c += stride) a.table[c] = kEmpty;
  if (kSmall)
    for (int c = threadIdx.x; c < S; c += blockDim.x) stab[c] = kEmpty;
  if (gtid == 0) a.cnt[0] = 0;
  grid.sync();
  // every row: cand0 and slot, and the claims of round 0
  for (long long b = warp0; b < n; b += stride) {
    const int i = (int)(b + lane);
    bool act = false;
    int c = 0;
    if (i < n) {
      c = (int)(row_hash(a.k, i) & (uint32_t)mask);
      act = a.live[i] != 0;
      a.cand0[i] = c;
      a.slot[i] = S;
    }
    claim<kSmall>(act, c, i, 0, a.table, stab);
  }
  if (kSmall) flush(a.table, stab, S);
  grid.sync();
  // round r: every claim of round r has landed, so a visited row's slot
  // owner is final; a row that matches it retires, the others go on the
  // next worklist and claim round r + 1's slot, which cannot change an
  // owner a round-r row reads (that slot is taken, by a smaller tag)
  int len = n;  // rows this round visits
  int r = 0;
  for (;; ++r) {
    const int32_t* list = a.list + (r & 1) * (long long)n;
    int32_t* next_list = a.list + ((r + 1) & 1) * (long long)n;
    const bool more = r + 1 < a.max_rounds;
    for (long long b = warp0; b < len; b += stride) {
      const long long j = b + lane;
      int i = 0;
      bool act = false;
      if (j < len) {
        i = r ? list[j] : (int)j;
        act = r || a.live[i];
      }
      bool next = false;
      int c = 0;
      if (act) {
        c = (a.cand0[i] + r) & mask;
        const int o = (int)(unsigned)a.table[c];  // this row claimed c
        if (same_key(a.k, i, o)) {
          a.slot[i] = c;
        } else {
          next = true;
          c = (c + 1) & mask;
        }
      }
      const unsigned left = __ballot_sync(0xffffffffu, next);
      if (left) {
        int at = 0;
        if (lane == 0) at = atomicAdd(a.cnt + r % 3, __popc(left));
        at = __shfl_sync(0xffffffffu, at, 0);
        if (next) next_list[at + __popc(left & lower)] = i;
      }
      if (more) claim<kSmall>(next, c, i, r + 1, a.table, stab);
    }
    if (kSmall && more) flush(a.table, stab, S);
    if (gtid == 0) a.cnt[(r + 1) % 3] = 0;
    grid.sync();
    len = *(volatile int*)(a.cnt + r % 3);
    if (len == 0 || !more) break;
  }
  for (long long c = gtid; c < S; c += stride) {
    const unsigned long long v = a.table[c];
    a.owner[c] = v == kEmpty ? n : (int)(unsigned)v;
  }
  if (gtid == 0) *a.overflow = len > 0;
}

__global__ void slot_probe(const int32_t* __restrict__ owner,
                           const uint32_t* __restrict__ slotw,
                           const uint32_t* __restrict__ pw,
                           const uint8_t* __restrict__ live,
                           uint8_t* __restrict__ found,
                           int32_t* __restrict__ slot, int m, int W, int S,
                           int n_build, int rounds) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  bool f = false;
  int s = S;
  if (live[i]) {
    const uint32_t* wi = pw + (size_t)i * W;
    const uint32_t mask = (uint32_t)(S - 1);
    uint32_t c = fold_hash(wi, W) & mask;
    for (int r = 0; r < rounds; ++r) {
      if (owner[c] == n_build) break;  // an empty slot ends the chain
      const uint32_t* wo = slotw + (size_t)c * W;
      bool match = true;
      for (int j = 0; j < W; ++j) match = match && (wo[j] == wi[j]);
      if (match) {
        f = true;
        s = (int)c;
        break;
      }
      c = (c + 1) & mask;
    }
  }
  found[i] = f;
  slot[i] = s;
}

inline unsigned blocks(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// The whole build in one cooperative launch.  word_ptrs: W device
// pointers (host array) to int64[n] u32 carriers; live uint8[n]; scratch
// cand0 int32[n], list int32[2*n], table uint64[S], cnt int32[3];
// outputs owner int32[S], slot int32[n], overflow uint8[1].  n >= 1,
// max_rounds >= 1.  Returns a cudaError_t.
int srj_slot_build(const int64_t* word_ptrs, int W, const void* live,
                   void* cand0, void* list, void* slot, void* owner,
                   void* table, void* cnt, void* overflow, int n, int S,
                   int max_rounds, int device, void* stream) {
  if (W < 1 || W > kMaxWords || n < 1 || S < 1 || (S & (S - 1)) != 0 ||
      max_rounds < 1) {
    return (int)cudaErrorInvalidValue;
  }
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Build a;
  for (int j = 0; j < W; ++j)
    a.k.w[j] = reinterpret_cast<const long long*>(word_ptrs[j]);
  a.k.W = W;
  a.live = static_cast<const uint8_t*>(live);
  a.cand0 = static_cast<int32_t*>(cand0);
  a.list = static_cast<int32_t*>(list);
  a.slot = static_cast<int32_t*>(slot);
  a.owner = static_cast<int32_t*>(owner);
  a.table = static_cast<unsigned long long*>(table);
  a.cnt = static_cast<int*>(cnt);
  a.overflow = static_cast<uint8_t*>(overflow);
  a.n = n;
  a.S = S;
  a.max_rounds = max_rounds;
  const bool small = S <= kSmallSlots;
  const void* fn = small ? (const void*)slot_build<true>
                         : (const void*)slot_build<false>;
  const size_t smem = small ? (size_t)S * sizeof(unsigned long long) : 0;
  int per_sm = 0, sms = 0, coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                      kBuildThreads, smem);
  if (err != cudaSuccess) return (int)err;
  long long grid = (long long)per_sm * sms;
  const long long need = ((long long)n + kBuildThreads - 1) / kBuildThreads;
  if (need < grid) grid = need;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3((unsigned)grid),
                                    dim3(kBuildThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int srj_slot_probe(const void* owner, const void* slotw, const void* pw,
                   const void* live, void* found, void* slot, int m, int W,
                   int S, int n_build, int rounds, void* stream) {
  if (m <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  slot_probe<<<blocks(m), kThreads, 0, s>>>(
      static_cast<const int32_t*>(owner), static_cast<const uint32_t*>(slotw),
      static_cast<const uint32_t*>(pw), static_cast<const uint8_t*>(live),
      static_cast<uint8_t*>(found), static_cast<int32_t*>(slot), m, W, S,
      n_build, rounds);
  return (int)cudaGetLastError();
}

const char* srj_slot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
