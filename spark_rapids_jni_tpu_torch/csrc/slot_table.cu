// Open-addressing slot table: build in synchronous rounds, probe by chain walk.
//
// Replaces: spark_rapids_jni_tpu/ops/pallas_kernels.py slot_table_build
// (-> _slot_build_call, kernel _slot_build_kernel) and slot_table_probe
// (-> _slot_probe_call, kernel _slot_probe_kernel), the fused twins of
// relational/hashtable.py build_slot_table / probe_slot_table.  Both
// products are bit-identical to the reference's lax formulation.
//
// Keys are W u32 words per row, row-major [n, W].  The candidate chain is
// the reference's: cand0 = fold_hash(words) & (S - 1), FNV-1a over the
// words then a lowbias32-style finalizer, and round r probes
// (cand0 + r) & (S - 1).
//
// Build, one round = three launches, since the phases need a grid-wide
// barrier between them:
//   claim:  every active row atomicMin's its row id into prop[cand];
//   elect:  an EMPTY owner slot takes prop[cand] — the minimum live row
//           id of the round's claimants, which is the representative row
//           the sort engine exposes (a first-come atomicCAS insert would
//           not be);
//   retire: an active row whose words equal its slot owner's words takes
//           the slot and retires; every active row resets prop[cand] to
//           the sentinel, so prop is clean for the next round without a
//           table-sized fill; still-active rows are counted.
// The host stops as soon as the count reaches zero (the Pallas grid runs
// all max_rounds rounds; with the join build's bound S = 2^22 that would
// never finish).  Rounds past that point change nothing, so stopping
// early is result-identical.
//
// What bounds it on the H100: bytes.  The build reads the words (4W B)
// and liveness of each row once and writes slot (4 B) per row and owner
// (4 B) per slot: about 13 B/row at W = 2.  Each extra round re-reads
// cand0 and the active flags of every row and the words of the rows
// still active; those passes and the launch latency of three launches a
// round are what the simple first version pays past the bound.  The
// probe reads the probe words and liveness once and writes found and
// slot (18 B/row at W = 2), plus random reads of owner and the gathered
// owner words [S, W] that miss L2 when the table (48 MB at S = 2^22)
// does not fit the 50 MB cache.
//
// What the design does about it: the tables live in device memory for
// every S (no VMEM-style size cutoff), the probe walks each chain in one
// thread with the owner's words gathered beside owner so a step is one
// 4 B read plus one W x 4 B read at the same slot, and the build's
// claim uses global atomics only for rows still active.  Later work: a
// shared-memory table for small S, warp-aggregated claims for skewed
// keys, fusing retire(r) with claim(r + 1).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t fold_hash(const uint32_t* w, int W) {
  uint32_t h = 2166136261u;
  for (int j = 0; j < W; ++j) h = (h ^ w[j]) * 16777619u;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  return h ^ (h >> 16);
}

__global__ void slot_init(const uint32_t* __restrict__ words,
                          const uint8_t* __restrict__ live,
                          int32_t* __restrict__ cand0,
                          uint8_t* __restrict__ active,
                          int32_t* __restrict__ slot, int n, int W, int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  cand0[i] = (int32_t)(fold_hash(words + (size_t)i * W, W) & (uint32_t)(S - 1));
  active[i] = live[i] != 0;
  slot[i] = S;
}

__global__ void slot_claim(const int32_t* __restrict__ cand0,
                           const uint8_t* __restrict__ active,
                           int32_t* __restrict__ prop, int n, int mask,
                           int r) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !active[i]) return;
  atomicMin(prop + ((cand0[i] + r) & mask), i);
}

__global__ void slot_elect(const int32_t* __restrict__ cand0,
                           const uint8_t* __restrict__ active,
                           int32_t* owner, const int32_t* __restrict__ prop,
                           int n, int mask, int r) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !active[i]) return;
  const int c = (cand0[i] + r) & mask;
  // every claimant of c writes the same prop[c]: the race is benign
  if (owner[c] == n) owner[c] = prop[c];
}

__global__ void slot_retire(const uint32_t* __restrict__ words,
                            const int32_t* __restrict__ cand0,
                            uint8_t* __restrict__ active,
                            int32_t* __restrict__ slot,
                            const int32_t* __restrict__ owner,
                            int32_t* __restrict__ prop,
                            int* __restrict__ remaining, int n, int W,
                            int mask, int r) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !active[i]) return;
  const int c = (cand0[i] + r) & mask;
  const int o = owner[c];  // never the sentinel: this row claimed c
  prop[c] = n;
  const uint32_t* wi = words + (size_t)i * W;
  const uint32_t* wo = words + (size_t)o * W;
  bool match = true;
  for (int j = 0; j < W; ++j) match = match && (wi[j] == wo[j]);
  if (match) {
    slot[i] = c;
    active[i] = 0;
  } else {
    atomicAdd(remaining, 1);
  }
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

// cand0, active and slot for n > 0 rows.
int srj_slot_init(const void* words, const void* live, void* cand0,
                  void* active, void* slot, int n, int W, int S,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  slot_init<<<blocks(n), kThreads, 0, s>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint8_t*>(live),
      static_cast<int32_t*>(cand0), static_cast<uint8_t*>(active),
      static_cast<int32_t*>(slot), n, W, S);
  return (int)cudaGetLastError();
}

// One build round r; `remaining` (zeroed by the caller) receives the
// number of rows still active after it.
int srj_slot_round(const void* words, const void* cand0, void* active,
                   void* slot, void* owner, void* prop, void* remaining,
                   int n, int W, int S, int r, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mask = S - 1;
  slot_claim<<<blocks(n), kThreads, 0, s>>>(
      static_cast<const int32_t*>(cand0), static_cast<const uint8_t*>(active),
      static_cast<int32_t*>(prop), n, mask, r);
  slot_elect<<<blocks(n), kThreads, 0, s>>>(
      static_cast<const int32_t*>(cand0), static_cast<const uint8_t*>(active),
      static_cast<int32_t*>(owner), static_cast<const int32_t*>(prop), n,
      mask, r);
  slot_retire<<<blocks(n), kThreads, 0, s>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(cand0),
      static_cast<uint8_t*>(active), static_cast<int32_t*>(slot),
      static_cast<const int32_t*>(owner), static_cast<int32_t*>(prop),
      static_cast<int*>(remaining), n, W, mask, r);
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
