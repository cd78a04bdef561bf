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
//                    PAD (-1) after its live tokens (a row that fills its
//                    width has none)
//   bk [nb + 1] int4 each bucket's first slot, first row, width and log2
//                    width (RowBucket), then the slots' end
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
//   bucket_count   clear: every slot emptied; count: a flat walk of the
//                  rows' slots into pair_count.cuh's block table (below)
//   topk_accept    (train_topk.cu, k = 1) the table's top pair in the
//                  reference order, the tie order of _argmax_tiebreak (v0
//                  merges one pair a round), stored as rule z
//   bucket_apply   one warp a row: hits of the pair, even offsets inside
//                  runs of hits take z, their right neighbours drop, and the
//                  row is front-packed in place; a slot is written only
//                  where its value changes
//
// The count.  The old one gave each row a thread and sent every counted
// pair to the global table with its own CAS or atomicAdd, and every claim
// to ctl[OCC] with one more: the first count puts 8.4 M live tokens on 702
// keys, and 742.7 ms went to the 3,845 counts of the 100 MB run's first
// 3,000 ids against a bound of 75.25 (H100 80GB HBM3, 700 W).  This one is
// v1's count (stream_count.cuh) on the rows' layout:
//  * a warp takes a contiguous run of 128-slot chunks of tok, a lane 4
//    slots by one 16-byte load.  A pair is two live tokens of one row: a
//    row that fills its width has no PAD at its end, so a slot's row and
//    whether it ends it come from the bucket table (a lane's bucket carried
//    from chunk to chunk, a shift for the power-of-two widths of 8-1024, a
//    division for the odd width of a word longer than 1024, which may put
//    a lane's 4 slots in two rows or two buckets).  A pair weighs its
//    row's frequency (a padding row's 0: not counted), no roff read;
//  * run parity from pair_count.cuh's carried warp max scan
//    (chunk_counted), restarting at every row end; a warp's first chunk
//    walks back over the run that crosses into it, at most to its row's
//    first slot;
//  * each block counts into a table of its own in shared memory, flushed
//    once a key a block, its claims counted once a block, a grid of one
//    wave (pair_count.cuh).  The table's contract holds: at the end it is
//    exact, or OVF is set and the host counts again at twice the size.
//
// The sharded v0 engine (ops/recount_sharded_kernels.py, replacing
// youtokentome_tpu/parallel/train_sharded.py:38 _train_rounds_sharded) runs
// the same count on each shard's rows into the shard's scratch table
// (bucket_shard_count: its occupancy and overflow in ctl's scratch slots),
// every slot it claims listed in its key's part (part_list.cuh: a claim
// staged in the block's shared memory, kListStage of them beside the block
// table, the block's entries reserved once a part at its end).
// train_delta_sharded.cu's shard_part_fold rebuilds each replica's own part
// from the N shards' lists of that part and shard_gather copies the other
// parts in; the top-k (k = 1) runs on every replica and bucket_apply on
// every shard.
//
// Every kernel does nothing once `done` or `overflow` is set or `used`
// reached min(vocab, limit), so the host enqueues rounds in batches.  A count
// that fills more than half the table sets `overflow` and stops probing; the
// host doubles the table and the round runs again.
//
// Bound.  A round reads every slot of the rows twice (count and apply, 4 B
// a slot, plus the rows' frequencies, and the apply the rows' offsets),
// writes the slots the merge changes, empties the table (12 B a slot),
// fills its occupied slots, and reads every count and the live keys in the
// top-k.  At the 100 MB / vocab-30000 point that is ~8.4 M slots x 8 B and a
// 2^19-slot table a round, ~25 us at 3.35 TB/s, times ~29,000 rounds.  What
// the design does about it: no sort (the JAX program sorts every pair each
// round), one pass a kernel, the count's same-key updates summed in shared
// memory, rows compacted where they lie and left unwritten where the merge
// misses them; one merge a round is v0's own rule, so the round count stays.

#include <cstdint>
#include <cuda_runtime.h>

#include "pair_count.cuh"
#include "part_list.cuh"
#include "train_common.cuh"

namespace {

using namespace yttm;

enum { W_WRITES = W_OWN };

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

// A bucket of rows as the host lays it out (4 int32): its first slot, its
// first row, its rows' width and that width's log2 (-1 when it is not a
// power of two); after the last bucket one whose first slot is the slots'
// end.
struct RowBucket {
  int32_t off, row0, width, shift;
};

// The bucket that holds slot i (bk[0].off == 0 <= i < the end): the last
// one whose first slot is at or before i.
__device__ __forceinline__ int bucket_of(const RowBucket *bk, int nb, int i) {
  int lo = 0, hi = nb - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(&bk[mid].off) <= i) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// The row of slot i of bucket b (its RowBucket as an int4), and whether i
// is that row's last slot.
__device__ __forceinline__ int row_at(const int4 &b, int i, bool &last) {
  const int d = i - b.x;
  const int q = b.w >= 0 ? d >> b.w : d / b.z;
  last = d - q * b.z == b.z - 1;
  return b.y + q;
}

__device__ __forceinline__ int4 bucket_row(const RowBucket *bk, int b) {
  return __ldg(reinterpret_cast<const int4 *>(bk) + b);
}

// The last slot before p0 (0 < p0 < S) that starts no equal pair (-1:
// none), by the whole warp, 32 slots a step back: a pair of equal live
// tokens of one row.  The walk ends at the latest at p0's row's first slot.
__device__ inline int row_unequal_before(const int32_t *tok, const RowBucket *bk, int nb,
                                         int p0) {
  const int lane = threadIdx.x & 31;
  for (int b = p0 - 32;; b -= 32) {
    const int i = b + lane;
    bool ne = false;
    if (i >= 0) {
      const int32_t x = tok[i];
      ne = x < 0 || x != tok[i + 1];
      if (!ne) row_at(bucket_row(bk, bucket_of(bk, nb, i)), i, ne);
    }
    const unsigned m = __ballot_sync(kFullMask, ne);
    if (m) return b + 31 - __clz(m);
    if (b <= 0) return -1;
  }
}

// The walk of one block over the S slots of the rows: a warp a run of
// 128-slot chunks, a lane 4 slots by one 16-byte load; a pair is two live
// tokens of one row (a row that fills its width has no PAD at its end),
// weighted by its row's frequency (a padding row weighs 0: not counted),
// run parity from the carried warp max scan (pair_count.cuh chunk_counted,
// restarting at every row end); each counted pair through the block's table
// bt, each global claim handed to `list`.
template <int OCC_, int OVF_, class List>
__device__ __forceinline__ void rows_count_block(const int32_t *tok, int S, const RowBucket *bk,
                                                 int nb, const int32_t *rfreq,
                                                 unsigned long long *keys, int32_t *cnts,
                                                 int cap, int32_t *ctl, BlockTable &bt,
                                                 const List &list) {
  block_table_open(bt);  // its barrier covers the list's stage too
  const int lane = threadIdx.x & 31;
  int c0, c1;
  warp_chunks(S, c0, c1);
  int claims = 0;  // global slots this lane claimed
  if (c0 < c1) {
    int carry = c0 ? row_unequal_before(tok, bk, nb, c0 * 128) : -1;
    // the lane's bucket, and where the next one starts
    int b = bucket_of(bk, nb, c0 * 128 + 4 * lane < S ? c0 * 128 + 4 * lane : S - 1);
    int4 cb = bucket_row(bk, b);
    int next = __ldg(&bk[b + 1].off);
    for (int c = c0; c < c1; ++c) {
      const int p = c * 128 + 4 * lane;
      int32_t a[4];
      load4(tok, p, S, kPad, a);
      int32_t after = __shfl_down_sync(kFullMask, a[0], 1);
      if (lane == 31) after = c * 128 + 128 < S ? __ldg(tok + c * 128 + 128) : kPad;
      const int32_t nbr[4] = {a[1], a[2], a[3], after};
      bool pv[4];
      int row[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pv[j] = false;
        if (a[j] < 0 || nbr[j] < 0) continue;  // PAD, or past the end
        while (p + j >= next) {
          cb = bucket_row(bk, ++b);
          next = __ldg(&bk[b + 1].off);
        }
        bool last;
        row[j] = row_at(cb, p + j, last);
        pv[j] = !last;
      }
      const unsigned counted = chunk_counted(p, a, nbr, pv, carry);
      unsigned long long key[4];
      int32_t f[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        key[j] = kEmpty;
        if (!((counted >> j) & 1u)) continue;
        f[j] = __ldg(rfreq + row[j]);
        if (f[j] > 0) key[j] = pair_key(a[j], nbr[j]);
      }
      claims += block_table_put<OVF_>(bt, key, f, keys, cnts, cap, ctl, list);
    }
  }
  block_table_close<OCC_, OVF_>(bt, claims, keys, cnts, cap, ctl, list);
}

// The count (every row's pairs into the table, claims in ctl[OCC_], a table
// more than half full in ctl[OVF_]); with kLists every claimed slot is
// listed in pl through the block's stage, built here in the kernel
// (stream_count.cuh says why).
template <int OCC_, int OVF_, bool kLists>
__global__ void __launch_bounds__(kCountThreads, kCountBlocksSM)
    rows_count_kernel(const int32_t *tok, int S, const RowBucket *bk, int nb,
                      const int32_t *rfreq, unsigned long long *keys, int32_t *cnts, int cap,
                      int32_t *ctl, PartLists pl, int limit, int vocab) {
  if (!block_active(ctl, limit, vocab)) return;
  __shared__ BlockTable bt;
  if constexpr (kLists) {
    __shared__ ListStage<kListStage> stage;
    const BlockList<kListStage, kCountThreads> list{pl, &stage};
    list.open();
    rows_count_block<OCC_, OVF_>(tok, S, bk, nb, rfreq, keys, cnts, cap, ctl, bt, list);
    list.close(keys);
  } else {
    rows_count_block<OCC_, OVF_>(tok, S, bk, nb, rfreq, keys, cnts, cap, ctl, bt, NoList{});
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
int count(const void *tok, int S, const void *bk, int nb, const void *rfreq, void *keys,
          void *cnts, int cap, void *ctl, const PartLists &pl, int limit, int vocab,
          int max_blocks, void *stream) {
  if (S <= 0 || nb <= 0 || cap <= 0 || (cap & (cap - 1)) != 0 || ((uintptr_t)tok & 15u) ||
      ((uintptr_t)bk & 15u))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  clear_kernel<OCC_, OVF_, kLists><<<grid_for(cap, 256), 256, 0, s>>>(
      (unsigned long long *)keys, (int32_t *)cnts, cap, (int32_t *)ctl, pl, limit, vocab);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rows_count_kernel<OCC_, OVF_, kLists>
      <<<count_grid<rows_count_kernel<OCC_, OVF_, kLists>>(S, max_blocks), kCountThreads, 0, s>>>(
          (const int32_t *)tok, S, (const RowBucket *)bk, nb, (const int32_t *)rfreq,
          (unsigned long long *)keys, (int32_t *)cnts, cap, (int32_t *)ctl, pl, limit, vocab);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One round's count: the table emptied, every row's pairs counted into it
// (tok [S] 16-byte aligned; bk: nb buckets and the end, RowBucket; at most
// max_blocks blocks when > 0, else one wave).
int yttm_bucket_count(const void *tok, int S, const void *bk, int nb, const void *rfreq,
                      void *keys, void *cnts, int cap, void *ctl, int limit, int vocab,
                      int max_blocks, void *stream) {
  return count<OCC, OVERFLOW, false>(tok, S, bk, nb, rfreq, keys, cnts, cap, ctl,
                                     PartLists{nullptr, nullptr, 0, cap}, limit, vocab,
                                     max_blocks, stream);
}

// The sharded v0 engine's count of one shard's rows into its scratch table
// (rkeys, rcnts), the occupancy and overflow in ctl's scratch slots, every
// claimed slot listed in its key's part among n_parts (plist [cap], pcnt
// [n_parts]); shard_part_fold then rebuilds every replica.
int yttm_bucket_shard_count(const void *tok, int S, const void *bk, int nb, const void *rfreq,
                            void *rkeys, void *rcnts, int cap, void *ctl, void *plist, void *pcnt,
                            int n_parts, int limit, int vocab, int max_blocks, void *stream) {
  if (n_parts <= 0 || n_parts > kMaxParts || cap < n_parts || !plist || !pcnt)
    return (int)cudaErrorInvalidValue;
  return count<kShardRocc, kShardRovf, true>(
      tok, S, bk, nb, rfreq, rkeys, rcnts, cap, ctl,
      PartLists{(int32_t *)plist, (int32_t *)pcnt, n_parts, cap}, limit, vocab, max_blocks,
      stream);
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
