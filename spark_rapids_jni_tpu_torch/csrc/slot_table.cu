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
// Probe, in two launches of their own.  Once per built table,
// slot_records writes one record per slot in slot order: the owner's row
// id, then its W key words (u32), W + 1 words in all (12 bytes at W = 2),
// so a step of the walk reads one record and linear probing's next step
// is the adjacent record.  The same launch computes the table's chain
// bound: each empty slot walks back over the run of occupied slots
// before it and takes max(run + 1) (S where a run reaches kMaxRun; 0 when
// no slot is empty, read as S) — a bound covering the longest chain, so
// any walk it truncates would have ended at an empty slot first.
//
// Then per probe call, slot_probe: one thread walks one probe row's
// chain, (cand0 + r) & (S - 1) for r < min(max_rounds, chain bound),
// and stops at the first slot that is empty or whose owner's words equal
// the probe's, exactly as the round-by-round walk does.  At load 1/2 a
// hit reads about 1.5 records, so lanes added to one row would mostly
// idle.  The probe words are read from their int64 carriers (low 32
// bits) through W pointers, live as bool bytes, and found is written as
// bool bytes: the wrapper packs nothing.  The loops over the words are
// unrolled to a compile-time cap (2 where W <= 2, else kMaxWords) and
// predicated on W, so a record's loads issue together and
// the probe words stay in registers; loops that stopped at a runtime W
// issued them one after another and walked 1.5x slower.  A table whose
// records fit kSmemRecords bytes (dim2's 25-row S = 64 table of the q95
// hash join and q9) is staged into each block's shared memory and walked
// there.
//
// What bounds the probe: bytes.  Per probe row it reads its words as
// carried (8 B each) and live, and writes found and slot; the records of
// a large table (S = 2^22: 48 MB beside a 50 MB L2) are read at random,
// about 1.5 records a hit at load 1/2.

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

// ---------------------------------------------------------------------------
// probe: per-table slot records, then one thread's walk per probe row
// ---------------------------------------------------------------------------

constexpr int kMaxRun = 1024;            // a longer run bounds the walk by S
constexpr int kSmemRecords = 48 * 1024;  // records staged in shared memory

// one record per slot: owner, then its W words; and the chain bound
// (atomicMax over the empty slots; *bound is 0 on entry)
__global__ void slot_records(const int32_t* __restrict__ owner, Words k,
                             uint32_t* __restrict__ rec, int* bound, int S,
                             int n) {
  const int mask = S - 1, R = k.W + 1;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       c < S; c += stride) {
    const int o = owner[c];
    uint32_t* r = rec + c * R;
    r[0] = (uint32_t)o;
    const bool occ = o != n;
    for (int j = 0; j < k.W; ++j) r[1 + j] = occ ? word(k, j, o) : 0u;
    if (!occ) {
      int len = 0;
      int p = ((int)c - 1) & mask;
      while (len < kMaxRun && owner[p] != n) {
        ++len;
        p = (p - 1) & mask;
      }
      atomicMax(bound, len < kMaxRun ? len + 1 : S);
    }
  }
}

struct Probe {
  Words k;                // probe words: W int64 carriers
  const uint8_t* live;    // bool[m]
  const uint32_t* rec;    // [S * (W + 1)] slot records
  const int* bound;       // the table's chain bound, 0 = S
  uint8_t* found;         // bool[m]
  int32_t* slot;          // int32[m]
  long long m;
  int S, n_build, max_rounds;
};

template <bool kSmem>
__device__ __forceinline__ uint32_t rec_word(const uint32_t* p) {
  return kSmem ? *p : __ldg(p);
}

// kCap >= W: the word loops' compile-time length; kSmem: the table's
// records are staged in shared memory
template <int kCap, bool kSmem>
__global__ void __launch_bounds__(kThreads) slot_probe(Probe a) {
  extern __shared__ uint32_t srec[];
  const int S = a.S, W = a.k.W, R = W + 1;
  const uint32_t* rec = a.rec;
  if constexpr (kSmem) {
    for (int i = threadIdx.x; i < S * R; i += blockDim.x)
      srec[i] = __ldg(a.rec + i);
    __syncthreads();
    rec = srec;
  }
  const int b = *a.bound;
  const int rounds = min(a.max_rounds, b ? b : S);
  const uint32_t mask = (uint32_t)(S - 1);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < a.m; i += stride) {
    bool f = false;
    int s = S;
    // the probe side streams through once: evict-first loads and stores
    // (__ldcs / __stcs) leave L2 to the records
    if (__ldcs(reinterpret_cast<const signed char*>(a.live) + i)) {
      uint32_t pw[kCap];
      uint32_t h = 2166136261u;
#pragma unroll
      for (int j = 0; j < kCap; ++j) {
        pw[j] = j < W ? (uint32_t)(unsigned long long)__ldcs(a.k.w[j] + i)
                      : 0u;
        if (j < W) h = (h ^ pw[j]) * 16777619u;
      }
      uint32_t c = finalize(h) & mask;
      for (int r = 0; r < rounds; ++r, c = (c + 1) & mask) {
        const uint32_t* e = rec + (long long)c * R;
        const uint32_t o = rec_word<kSmem>(e);
        bool match = true;
#pragma unroll
        for (int j = 0; j < kCap; ++j)
          if (j < W) match &= rec_word<kSmem>(e + 1 + j) == pw[j];
        if ((int)o == a.n_build) break;  // an empty slot ends the chain
        if (match) {
          f = true;
          s = (int)c;
          break;
        }
      }
    }
    __stcs(reinterpret_cast<signed char*>(a.found) + i, (signed char)f);
    __stcs(a.slot + i, s);
  }
}

template <int kCap, bool kSmem>
cudaError_t launch_probe(const Probe& a, cudaStream_t stream, int device) {
  const void* fn = (const void*)slot_probe<kCap, kSmem>;
  const size_t smem = kSmem ? (size_t)a.S * (a.k.W + 1) * 4 : 0;
  int per_sm = 0, sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  long long grid = (a.m + kThreads - 1) / kThreads;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (grid > resident) grid = resident;
  slot_probe<kCap, kSmem><<<(unsigned)grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kSmem>
cudaError_t probe_by_words(const Probe& a, cudaStream_t s, int device) {
  // two words: one int32 key with its null word, the q95 and q9 joins
  if (a.k.W <= 2) return launch_probe<2, kSmem>(a, s, device);
  return launch_probe<kMaxWords, kSmem>(a, s, device);
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

// One record per slot, once per built table.  owner int32[S];
// word_ptrs: W device pointers (host array) to the build side's int64[n]
// u32 carriers; rec uint32[S * (W + 1)] out; bound int32[1], zero on
// entry, out.  Returns a cudaError_t.
int srj_slot_records(const void* owner, const int64_t* word_ptrs, int W,
                     void* rec, void* bound, int S, int n, void* stream) {
  if (W < 1 || W > kMaxWords || S < 1 || (S & (S - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  Words k;
  for (int j = 0; j < W; ++j)
    k.w[j] = reinterpret_cast<const long long*>(word_ptrs[j]);
  k.W = W;
  const long long grid = ((long long)S + kThreads - 1) / kThreads;
  slot_records<<<(unsigned)(grid < 65535 ? grid : 65535), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(owner), k, static_cast<uint32_t*>(rec),
      static_cast<int*>(bound), S, n);
  return (int)cudaGetLastError();
}

// Largest record table (bytes) the probe stages in shared memory.
int srj_slot_probe_smem_limit() { return kSmemRecords; }

// The probe over slot records: word_ptrs: W device pointers (host array)
// to the probe side's int64[m] carriers; live bool[m]; rec uint32[S *
// (W + 1)] and bound int32[1] from srj_slot_records; found bool[m] and
// slot int32[m] out.  smem: stage the records in shared memory (S * (W +
// 1) * 4 <= the limit).
int srj_slot_probe(const int64_t* word_ptrs, int W, const void* live,
                   const void* rec, const void* bound, void* found,
                   void* slot, long long m, int S, int n_build,
                   int max_rounds, int smem, int device, void* stream) {
  if (m <= 0) return 0;
  if (W < 1 || W > kMaxWords || S < 1 || (S & (S - 1)) != 0 ||
      (smem && (long long)S * (W + 1) * 4 > kSmemRecords))
    return (int)cudaErrorInvalidValue;
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Probe a;
  for (int j = 0; j < kMaxWords; ++j)  // unused entries: a valid pointer
    a.k.w[j] = reinterpret_cast<const long long*>(word_ptrs[j < W ? j : 0]);
  a.k.W = W;
  a.live = static_cast<const uint8_t*>(live);
  a.rec = static_cast<const uint32_t*>(rec);
  a.bound = static_cast<const int*>(bound);
  a.found = static_cast<uint8_t*>(found);
  a.slot = static_cast<int32_t*>(slot);
  a.m = m;
  a.S = S;
  a.n_build = n_build;
  a.max_rounds = max_rounds;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = smem ? probe_by_words<true>(a, s, device)
             : probe_by_words<false>(a, s, device);
  return (int)err;
}

const char* srj_slot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
