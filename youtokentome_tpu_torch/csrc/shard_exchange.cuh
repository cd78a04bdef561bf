// The exchange of the sharded trainers (train_delta_sharded.cu for v2,
// train_sparse_sharded.cu for v3; the v1 and v0 engines fold through
// shard_part_fold and shard_gather): the ctl slots that a shard's kernels
// and the other shards' folds read, the work counters, the parts of the
// partitioned fold, and the warp-aggregated append to a shard's delta
// buffer.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "train_common.cuh"

namespace yttm {

// ctl: the common slots, then NAFF .. DOVF, which every round's top-k zeroes
// (n_own = 4), then the engine's own.  LIVE is v2's live tokens (v3: the
// positions of the round's listed words).  ROCC and ROVF are the scratch
// table's occupancy and overflow; POCC the keys that the partitioned fold
// (v1, v0) put in the replica's own part (past the part's size: full).
enum ShardCtl { NAFF = CTL_OWN, DN_OLD, DN_NEW, DOVF, NREC, LIVE, ROCC, ROVF, POCC };
static_assert(ROCC == kShardRocc && ROVF == kShardRovf, "the shard counts' scratch slots");
// work (int64): the bytes each kernel must move, summed over the rounds
// (W_RELAY, which the host adds, then W_ENTRIES: the buffer entries written)
enum ShardWork { W_EMIT = W_OWN, W_COUNT, W_FOLD, W_RELAY, W_ENTRIES };

// The partitioned fold's parts: part p of a replica holds the slots
// [part_lo(p), part_lo(p + 1)) and the keys with key_part(key) == p.
__device__ __forceinline__ long long part_lo(int p, int cap, int n) {
  return (long long)p * cap / n;
}

// The part of a key among n: a multiplicative mix of its two ids, every
// product below 2^63 (the plain version computes it in int64).
__device__ __forceinline__ int key_part(unsigned long long key, int n) {
  const unsigned long long m32 = 0xFFFFFFFFull;
  unsigned long long h = (((key >> 32) * 0x9E3779B1ull) & m32) ^ (((key & m32) * 0x85EBCA77ull) & m32);
  h = ((h ^ (h >> 15)) * 0x2C1B3C6Dull) & m32;
  return (int)((h * (unsigned long long)n) >> 32);
}

__device__ __forceinline__ bool any_flag(const int32_t *const *ctls, int n, int slot) {
  bool any = false;
  for (int s = 0; s < n; ++s) any |= __ldcg(ctls[s] + slot) != 0;
  return any;
}

// Warp-aggregated append of (key, val) for the lanes with pred to one side
// of the buffer (side DN_OLD at [0, dcap), DN_NEW at [dcap, 2*dcap)); the
// side's count may pass dcap, which sets DOVF.  Called by all 32 lanes.
__device__ __forceinline__ void emit(bool pred, unsigned long long key, int32_t val, int side,
                                     unsigned long long *dk, int32_t *dv, int dcap, int32_t *ctl,
                                     long long *work) {
  const unsigned m = __ballot_sync(0xFFFFFFFFu, pred);
  if (m == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(m) - 1;
  const int k = __popc(m);
  int base = 0;
  if (lane == leader) {
    base = atomicAdd(ctl + side, k);
    if (base + k > dcap) atomicExch(ctl + DOVF, 1);
    const int kept = base >= dcap ? 0 : (base + k > dcap ? dcap - base : k);
    if (kept) {
      atomicAdd((unsigned long long *)(work + W_EMIT), 12ull * kept);
      atomicAdd((unsigned long long *)(work + W_ENTRIES), (unsigned long long)kept);
    }
  }
  base = __shfl_sync(0xFFFFFFFFu, base, leader);
  if (!pred) return;
  const int slot = base + __popc(m & ((1u << lane) - 1u));
  if (slot < dcap) {
    const int at = (side == DN_NEW ? dcap : 0) + slot;
    dk[at] = key;
    dv[at] = val;
  }
}

}  // namespace yttm
