// The exchange of the sharded trainers (train_delta_sharded.cu for v2,
// train_sparse_sharded.cu for v3; the v1 and v0 engines fold through
// shard_part_fold and shard_gather, on part_list.cuh's parts): the ctl
// slots that a shard's kernels and the other shards' folds read, the work
// counters, and the emits' staging of a shard's delta buffer.

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

// -- the emits' delta buffers ---------------------------------------------------
//
// delta_emit (train_delta_sharded.cu) and sparse_emit (train_sparse_sharded.cu)
// take every shard of a card in one launch, a block walking a contiguous
// range of steps that stay inside one shard.  A warp stages its entries in
// shared memory, kStage a side; the block reserves its staged entries with
// one atomicAdd a (shard, side) when its range moves to another shard and at
// its end, and a warp whose staging fills reserves and writes its own (so the
// counts pass dcap, setting DOVF, and the entries past dcap are dropped,
// wherever that falls).  The block's words, slots and entries kept are summed
// in shared memory and sent with its reservation.

constexpr int kMaxShards = kMaxParts;  // shards of a card in one launch
constexpr int kEmitWarps = 8;          // 256 threads a block
constexpr int kStage = 64;             // entries a warp stages a side

// A shard of an emit's card, as the host lays it out: 12 int64.  v3 puts
// its tombstoned stream t, pw and its end off[W] in tok, pwid and Mw.
struct EmitShard {
  int32_t *tok;
  const int32_t *pwid;
  long long Mw;
  const int32_t *off;
  const int32_t *fw;
  long long W;
  int32_t *ctl;
  const int32_t *cand;
  int32_t *wmark;
  unsigned long long *dk;
  int32_t *dv;
  long long *work;
};
static_assert(sizeof(EmitShard) == 12 * 8, "the host lays an emit shard out as 12 int64");

// The shared state of an emit block.
struct EmitStage {
  EmitShard cur;                                 // the shard of the block's current steps
  int pre[kMaxShards + 1];                       // each shard's first step
  unsigned long long sk[kEmitWarps][2][kStage];  // a warp's staged entries, a side each
  int32_t sv[kEmitWarps][2][kStage];
  int sn[kEmitWarps][2];    // their numbers, at a reservation
  int base[2];              // the block's reservation a side
  int naff, live, slots, kept;  // the block's sums for the current shard
};

// The shards' step prefix in sb.pre (steps(shard): a shard's steps), by the
// first warp of the block; the block's sums zeroed.  The caller's next
// __syncthreads orders it.
template <class Steps>
__device__ void emit_open(EmitStage &sb, const EmitShard *shards, int n_sh, Steps steps) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int carry = 0;
  for (int b = 0; b < n_sh; b += 32) {
    const int s = b + lane;
    const int v = s < n_sh ? steps(shards + s) : 0;
    int incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(kFullMask, incl, d);
      if (lane >= d) incl += u;
    }
    if (s < n_sh) sb.pre[s] = carry + incl - v;
    carry += __shfl_sync(kFullMask, incl, 31);
  }
  if (lane == 0) {
    sb.pre[n_sh] = carry;
    sb.naff = sb.live = sb.slots = sb.kept = 0;
  }
}

// The entries of a reservation [base, base + k) that fit below dcap.
__device__ __forceinline__ int kept_of(int base, int k, int dcap) {
  return base >= dcap ? 0 : (base + k > dcap ? dcap - base : k);
}

// A warp whose staging of `side` is full reserves its cnt entries and
// writes them.  Called by all 32 lanes.
__device__ void emit_flush_warp(EmitStage &sb, int side, int cnt, int dcap) {
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  int base = 0;
  if (lane == 0) {
    base = atomicAdd(sb.cur.ctl + DN_OLD + side, cnt);
    if (base + cnt > dcap) atomicExch(sb.cur.ctl + DOVF, 1);
    atomicAdd(&sb.kept, kept_of(base, cnt, dcap));
  }
  base = __shfl_sync(kFullMask, base, 0);
  __syncwarp();
  for (int i = lane; i < cnt && base + i < dcap; i += 32) {
    sb.cur.dk[side * dcap + base + i] = sb.sk[wi][side][i];
    sb.cur.dv[side * dcap + base + i] = sb.sv[wi][side][i];
  }
  __syncwarp();
}

// Stages (key, val) of the lanes with pred on `side` (cnt: the warp's
// staged entries there).  Called by all 32 lanes.
__device__ __forceinline__ void emit_stage(EmitStage &sb, bool pred, unsigned long long key,
                                           int32_t val, int side, int &cnt, int dcap) {
  const unsigned m = __ballot_sync(kFullMask, pred);
  if (!m) return;
  const int k = __popc(m);
  if (cnt + k > kStage) {
    emit_flush_warp(sb, side, cnt, dcap);
    cnt = 0;
  }
  if (pred) {
    const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
    const int at = cnt + __popc(m & ((1u << lane) - 1u));
    sb.sk[wi][side][at] = key;
    sb.sv[wi][side][at] = val;
  }
  cnt += k;
}

// The block's reservation for its current shard: every warp's staged
// entries (n_old, n_new: this warp's) reserved with one atomicAdd a side and
// written, then the block's sums sent: naff to NAFF, live to ctl[LiveSlot],
// the words' slots read and written (8 B each) and the entries kept to work.
// Called by every thread.
template <int LiveSlot>
__device__ void emit_flush_block(EmitStage &sb, int &n_old, int &n_new, int dcap) {
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  if (lane == 0) {
    sb.sn[wi][0] = n_old;
    sb.sn[wi][1] = n_new;
  }
  n_old = n_new = 0;
  __syncthreads();
  if (threadIdx.x < 2) {
    const int side = threadIdx.x;
    int sum = 0;
    for (int w = 0; w < kEmitWarps; ++w) sum += sb.sn[w][side];
    int base = 0;
    if (sum) {
      base = atomicAdd(sb.cur.ctl + DN_OLD + side, sum);
      if (base + sum > dcap) atomicExch(sb.cur.ctl + DOVF, 1);
      atomicAdd(&sb.kept, kept_of(base, sum, dcap));
    }
    sb.base[side] = base;
  }
  __syncthreads();
  for (int j = wi; j < 2 * kEmitWarps; j += kEmitWarps) {  // a warp a (side, warp)'s entries
    const int side = j / kEmitWarps, w = j % kEmitWarps;
    int at = sb.base[side];
    for (int u = 0; u < w; ++u) at += sb.sn[u][side];
    for (int i = lane; i < sb.sn[w][side] && at + i < dcap; i += 32) {
      sb.cur.dk[side * dcap + at + i] = sb.sk[w][side][i];
      sb.cur.dv[side * dcap + at + i] = sb.sv[w][side][i];
    }
  }
  if (threadIdx.x == 0) {
    int32_t *ctl = sb.cur.ctl;
    long long *work = sb.cur.work;
    if (sb.naff) atomicAdd(ctl + NAFF, sb.naff);
    if (sb.live) atomicAdd(ctl + LiveSlot, sb.live);
    const unsigned long long bytes = 8ull * sb.slots + 12ull * sb.kept;
    if (bytes) atomicAdd((unsigned long long *)(work + W_EMIT), bytes);
    if (sb.kept) atomicAdd((unsigned long long *)(work + W_ENTRIES), (unsigned long long)sb.kept);
    sb.naff = sb.live = sb.slots = sb.kept = 0;
  }
  __syncthreads();
}

// The shard of `step` (sb.pre), from the block's current one `cur` on; the
// block reserves its entries for `cur` first when it changes (emit_flush_block,
// LiveSlot as there).  Called by every thread of the block.
template <int LiveSlot>
__device__ int emit_shard(EmitStage &sb, const EmitShard *shards, int step, int cur, int &n_old,
                          int &n_new, int dcap) {
  int s = cur < 0 ? 0 : cur;
  while (sb.pre[s + 1] <= step) ++s;  // the same in every thread
  if (s != cur) {
    if (cur >= 0) emit_flush_block<LiveSlot>(sb, n_old, n_new, dcap);
    if (threadIdx.x == 0) sb.cur = shards[s];
    __syncthreads();
  }
  return s;
}

// A warp's words gained this step: summed in the block's sums.
__device__ __forceinline__ void emit_sums(EmitStage &sb, int words, int live, int slots) {
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&sb.naff, words);
    atomicAdd(&sb.live, live);
    atomicAdd(&sb.slots, slots);
  }
  __syncwarp();
}

}  // namespace yttm
