// The exchange of the sharded trainers (train_delta_sharded.cu for v2,
// train_sparse_sharded.cu for v3; the v1 and v0 engines fold through
// shard_part_fold and shard_gather, on part_list.cuh's parts): the ctl
// slots that a shard's kernels and the other shards' folds read, the work
// counters, and the warp-aggregated append to a shard's delta buffer.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "part_list.cuh"
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

__device__ __forceinline__ bool any_flag(const int32_t *const *ctls, int n, int slot) {
  bool any = false;
  for (int s = 0; s < n; ++s) any |= __ldcg(ctls[s] + slot) != 0;
  return any;
}

// any_flag by a warp, lane s reading shard s's slot (32 shards a step), so
// that the n pointer loads and n flag loads are in flight together, not one
// after another.  Called by all 32 lanes; every lane gets the answer.
__device__ __forceinline__ bool warp_any_flag(const int32_t *const *ctls, int n, int slot) {
  const int lane = threadIdx.x & 31;
  bool any = false;
  for (int b = 0; b < n; b += 32)
    any |= __any_sync(0xFFFFFFFFu, b + lane < n && __ldcg(ctls[b + lane] + slot) != 0);
  return any;
}

// Opens a recount of a shard (v2's shard_recount, v3's
// sparse_shard_recount): its scratch table emptied, ROCC and ROVF zeroed and
// the count's reads (the stream's n slots, its W words' offsets and weights)
// added to work; a no-op unless some shard's DOVF is set.  A grid of at most
// one wave (grid_for) striding over the table.
__global__ void __launch_bounds__(256)
    recount_clear_kernel(unsigned long long *rkeys, int32_t *rcnts, int cap, int32_t *ctl,
                         const int32_t *const *ctls, int n_sh, int n, int W, long long *work) {
  if (!warp_any_flag(ctls, n_sh, DOVF)) return;
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < cap; s += gridDim.x * blockDim.x) {
    rkeys[s] = kEmpty;
    rcnts[s] = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    ctl[ROCC] = 0;
    ctl[ROVF] = 0;
    // the live pairs written are added by the rebuild fold, which reads ROCC
    work[W_COUNT] += 4ll * n + 8ll * W;
  }
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
