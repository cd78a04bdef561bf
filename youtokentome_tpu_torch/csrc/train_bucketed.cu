// The v0 bucketed trainer's merge round, on Hopper: two kernels here and the
// shared top-k of train_topk.cu (k = 1).
//
// Replaces the JAX device program
//   youtokentome_tpu/ops/train_kernel.py:97 train_rounds
// and what it runs each round: _pair_arrays with segment.py
// pair_count_mask, _segment_counts (a sort of every pair and a
// reduce-by-key), _argmax_tiebreak and segment.py apply_merge_rows.  The
// plain torch versions of the kernels are in
// youtokentome_tpu_torch/ops/bucketed_kernels.py.
//
// State (all on the card; the host reads `ctl` once per batch of rounds):
//   tok [S] int32    the length buckets' rows end to end: row r is
//                    tok[roff[r], roff[r+1]), a row of a [Wb, Lb] bucket,
//                    PAD (-1) after its live tokens (and inside a row that
//                    was never merged, as the buckets arrive)
//   rfreq [R] int32  the word frequency of each row (0 for padding rows)
//   keys [cap] u64, cnts [cap] int32
//                    open-addressing pair-count table, key x << 32 | y,
//                    emptied and counted again every round
//   ctl [8] int32    used, done, overflow, round, n_acc, occupied, error
//                    (train_common.cuh)
//   cand [1, 4]      this round's [x, y, z, count]
//   work [8] int64   rounds, the table slots the counts filled, the slots
//                    the top-k scanned, the slots the applies changed
//                    (summed over the rounds)
//
// Kernels:
//   bucket_count   clear: every slot emptied; count: one thread a row adds
//                  the row's pairs (run parity: floor(r/2) pairs in a run
//                  of r equal tokens) weighted by the row's frequency, with
//                  atomicCAS inserts and atomicAdd counts
//   topk_accept    (train_topk.cu, k = 1) the table's top pair in the
//                  reference order, the tie order of _argmax_tiebreak (v0
//                  merges one pair a round), stored as rule z
//   bucket_apply   one warp a row: hits of the pair, even offsets inside
//                  runs of hits take z, their right neighbours drop, and the
//                  row is front-packed in place; a slot is written only
//                  where its value changes
//
// The sharded v0 engine (ops/recount_sharded_kernels.py, replacing
// youtokentome_tpu/parallel/train_sharded.py:38 _train_rounds_sharded) runs
// the same count on each shard's rows into the shard's scratch table
// (bucket_shard_count: its occupancy and overflow in ctl's scratch slots).
// Its insert also lists every slot it claims in its key's part
// (part_list.cuh: a claim staged in the block's shared memory, the block's
// entries reserved once a part at its end); that is all the partitioned
// fold asks of it, and the thread-a-row walk and the global atomics on the
// table stay.  train_delta_sharded.cu's shard_part_fold rebuilds each
// replica's own part from the N shards' lists of that part and shard_gather
// copies the other parts in; the top-k (k = 1) runs on every replica and
// bucket_apply on every shard.
//
// Every kernel does nothing once `done` or `overflow` is set or `used`
// reached min(vocab, limit), so the host enqueues rounds in batches.  A count
// that fills more than half the table sets `overflow` and stops probing; the
// host doubles the table and the round runs again.
//
// Bound.  A round reads every slot of the rows twice (count and apply, 4 B
// a slot, plus the rows' offsets and frequencies), writes the slots the merge
// changes, empties the table (12 B a slot), fills its occupied slots, and
// reads every count and the live keys in the top-k.  At the 100 MB /
// vocab-30000 point that is ~8.4 M slots x 8 B and a 2^19-slot table a
// round, ~25 us at 3.35 TB/s, times ~29,000 rounds.  What the design does
// about it: no sort (the JAX program sorts every pair each round), one pass
// a kernel, rows compacted where they lie and left unwritten where the merge
// misses them; one merge a round is v0's own rule, so the round count stays.

#include <cstdint>
#include <cuda_runtime.h>

#include "pair_count.cuh"
#include "part_list.cuh"
#include "train_common.cuh"

namespace {

using namespace yttm;

enum { W_WRITES = W_OWN };
constexpr int kRowStage = 2048;  // claims a block of the sharded count stages

// OCC_ and OVF_: the table's occupancy and overflow slots (the state's own
// table; a shard's scratch table in the sharded engine, whose overflow flag
// and part lists are cleared with it)
template <int OCC_, int OVF_, bool kLists>
__global__ void __launch_bounds__(256)
    clear_kernel(unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl, PartLists pl,
                 int limit, int vocab) {
  if (!round_active(ctl, limit, vocab)) return;
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < cap; s += gridDim.x * blockDim.x) {
    keys[s] = kEmpty;
    cnts[s] = 0;
  }
  if constexpr (kLists) part_lists_reset(pl);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    ctl[OCC_] = 0;
    if (OVF_ != OVERFLOW) ctl[OVF_] = 0;
  }
}

// table_add in count mode with every claimed slot handed to `list` (NoList
// for the state's own table, the block's BlockList for the sharded count):
// count_put's probe, the claim counted in ctl[OCC_] at once.
template <int OCC_, int OVF_, class List>
__device__ __forceinline__ void listed_add(unsigned long long *keys, int32_t *cnts, int cap,
                                           int32_t *ctl, unsigned long long key, int32_t delta,
                                           const List &list) {
  if (count_put<OVF_>(keys, cnts, cap, ctl, key, delta, (unsigned)hash64(key), list)) {
    const int occ = atomicAdd(ctl + OCC_, 1) + 1;
    if (2ll * occ > (long long)cap) atomicExch(ctl + OVF_, 1);
  }
}

// One thread a row: rows are short (a bucket's width), so a warp a row
// would leave most lanes idle and each row's chain of loads and probes
// exposed; a thread walks its row keeping the run of equal pairs
// (for_word_pairs' parity: in a run of equal pairs every other one counts,
// from its first).  The sharded count's claims go to `list`.
template <int OCC_, int OVF_, class List>
__device__ __forceinline__ void count_rows(const int32_t *tok, const int32_t *roff,
                                           const int32_t *rfreq, int R, unsigned long long *keys,
                                           int32_t *cnts, int cap, int32_t *ctl,
                                           const List &list) {
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < R; r += gridDim.x * blockDim.x) {
    const int32_t f = rfreq[r];
    if (f == 0) continue;  // a padding row: no pairs
    const int base = roff[r], n = roff[r + 1] - base;
    const int32_t *t = tok + base;
    int32_t a = n > 0 ? t[0] : kPad;
    int run = 0;  // equal pairs since the last position that starts none
    for (int i = 0; i + 1 < n; ++i) {
      const int32_t b = t[i + 1];
      const bool pairv = a >= 0 && b >= 0;
      const bool eq = pairv && a == b;
      if (pairv && (!eq || (run & 1) == 0))
        listed_add<OCC_, OVF_>(keys, cnts, cap, ctl, pair_key(a, b), f, list);
      run = eq ? run + 1 : 0;
      a = b;
    }
  }
}

// The count (all rows into the table); with kLists every claimed slot is
// listed in pl through the block's stage, built here in the kernel
// (stream_count.cuh says why).
template <int OCC_, int OVF_, bool kLists>
__global__ void __launch_bounds__(256)
    count_rows_kernel(const int32_t *tok, const int32_t *roff, const int32_t *rfreq, int R,
                      unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl,
                      PartLists pl, int limit, int vocab) {
  if (!block_active(ctl, limit, vocab)) return;
  if constexpr (kLists) {
    __shared__ ListStage<kRowStage> stage;
    const BlockList<kRowStage, 256> list{pl, &stage};
    list.open();
    __syncthreads();
    count_rows<OCC_, OVF_>(tok, roff, rfreq, R, keys, cnts, cap, ctl, list);
    __syncthreads();
    list.close(keys);
  } else {
    count_rows<OCC_, OVF_>(tok, roff, rfreq, R, keys, cnts, cap, ctl, NoList{});
  }
}

__global__ void __launch_bounds__(256)
    apply_rows_kernel(int32_t *tok, const int32_t *roff, int R, const int32_t *ctl,
                      const int32_t *cand, long long *work) {
  if (ctl[NACC] == 0) return;
  const int32_t x = cand[0], y = cand[1], z = cand[2];
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  int writes = 0;  // the lane's slots whose value changed
  for (int r = warp; r < R; r += n_warps) {
    const int base = roff[r];
    const int len = roff[r + 1] - base;
    int32_t *t = tok + base;
    int carry_hit = -1, out = 0, last_live = -1;
    bool carry_sel = false;
    // merge and compact in place: all lanes read a chunk (and the next
    // chunk's first token) before any lane writes, and writes land at or
    // before the positions read.  Destinations fill [0, out) in order, so a
    // destination still holds its old value when it is written.
    for (int b = 0; b < len; b += 32) {
      const int i = b + lane;
      const int32_t a = i < len ? t[i] : kPad;
      const int32_t nb = i + 1 < len ? t[i + 1] : kPad;
      const bool hit = a == x && nb == y;  // x, y >= 0: both live
      int lnh = warp_max_scan(hit ? -1 : i);
      lnh = lnh > carry_hit ? lnh : carry_hit;
      const bool sel = hit && ((i - lnh - 1) & 1) == 0;
      bool prev_sel = __shfl_up_sync(0xFFFFFFFFu, sel, 1);
      if (lane == 0) prev_sel = carry_sel;
      const bool keep = a >= 0 && !prev_sel;
      const unsigned kmask = __ballot_sync(0xFFFFFFFFu, keep);
      const unsigned lmask = __ballot_sync(0xFFFFFFFFu, a >= 0);
      if (lmask) last_live = b + 31 - __clz(lmask);
      const int d = out + __popc(kmask & lt);
      const int32_t v = sel ? z : a;
      const int32_t old = keep && d != i ? t[d] : a;
      __syncwarp();
      if (keep && old != v) {
        t[d] = v;
        ++writes;
      }
      __syncwarp();
      out += __popc(kmask);
      carry_hit = __shfl_sync(0xFFFFFFFFu, lnh, 31);
      carry_sel = __shfl_sync(0xFFFFFFFFu, sel, 31);
    }
    // past the last live token every slot holds PAD already
    for (int i = out + lane; i <= last_live; i += 32) {
      if (t[i] != kPad) {
        t[i] = kPad;
        ++writes;
      }
    }
    __syncwarp();
  }
  for (int o = 16; o > 0; o >>= 1) writes += __shfl_xor_sync(0xFFFFFFFFu, writes, o);
  if (lane == 0 && writes)
    atomicAdd((unsigned long long *)work + W_WRITES, (unsigned long long)writes);
}

template <int OCC_, int OVF_, bool kLists>
int count(const void *tok, const void *roff, const void *rfreq, int R, void *keys, void *cnts,
          int cap, void *ctl, const PartLists &pl, int limit, int vocab, void *stream) {
  if (R <= 0 || cap <= 0 || (cap & (cap - 1)) != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  clear_kernel<OCC_, OVF_, kLists><<<grid_for(cap, 256), 256, 0, s>>>(
      (unsigned long long *)keys, (int32_t *)cnts, cap, (int32_t *)ctl, pl, limit, vocab);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  count_rows_kernel<OCC_, OVF_, kLists><<<grid_for(R, 256), 256, 0, s>>>(
      (const int32_t *)tok, (const int32_t *)roff, (const int32_t *)rfreq, R,
      (unsigned long long *)keys, (int32_t *)cnts, cap, (int32_t *)ctl, pl, limit, vocab);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One round's count: the table emptied, every row's pairs counted into it.
int yttm_bucket_count(const void *tok, const void *roff, const void *rfreq, int R, void *keys,
                      void *cnts, int cap, void *ctl, int limit, int vocab, void *stream) {
  return count<OCC, OVERFLOW, false>(tok, roff, rfreq, R, keys, cnts, cap, ctl,
                                     PartLists{nullptr, nullptr, 0, cap}, limit, vocab, stream);
}

// The sharded v0 engine's count of one shard's rows into its scratch table
// (rkeys, rcnts), the occupancy and overflow in ctl's scratch slots, every
// claimed slot listed in its key's part among n_parts (plist [cap], pcnt
// [n_parts]); shard_part_fold then rebuilds every replica.
int yttm_bucket_shard_count(const void *tok, const void *roff, const void *rfreq, int R,
                            void *rkeys, void *rcnts, int cap, void *ctl, void *plist, void *pcnt,
                            int n_parts, int limit, int vocab, void *stream) {
  if (n_parts <= 0 || n_parts > kMaxParts || cap < n_parts || !plist || !pcnt)
    return (int)cudaErrorInvalidValue;
  return count<kShardRocc, kShardRovf, true>(
      tok, roff, rfreq, R, rkeys, rcnts, cap, ctl,
      PartLists{(int32_t *)plist, (int32_t *)pcnt, n_parts, cap}, limit, vocab, stream);
}

// One round's apply: the pair merged in every row, the rows front-packed.
int yttm_bucket_apply(void *tok, const void *roff, int R, const void *ctl, const void *cand,
                      void *work, void *stream) {
  if (R <= 0) return (int)cudaErrorInvalidValue;
  apply_rows_kernel<<<grid_for_warps(R), 256, 0, (cudaStream_t)stream>>>(
      (int32_t *)tok, (const int32_t *)roff, R, (const int32_t *)ctl, (const int32_t *)cand,
      (long long *)work);
  return (int)cudaGetLastError();
}

}  // extern "C"
