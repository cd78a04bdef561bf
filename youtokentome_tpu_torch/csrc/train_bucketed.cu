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
//   tok [S] int32    the length buckets' rows end to end, each bucket a
//                    [Wb, Lb] matrix flattened: PAD (-1) after a row's live
//                    tokens (a row that fills its width has none)
//   bk [nb + 1] int4 each bucket's first slot, first row, width and log2
//                    width (RowBucket), then the slots' end: a slot's row,
//                    and whether it starts or ends it, without row offsets
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
//   bucket_apply   one launch for the states of a card: a flat walk of
//                  their rows' slots (below) in which hits of the pair at
//                  even offsets inside runs of hits take z, their right
//                  neighbours drop, and each row is front-packed in place; a
//                  slot is written only where its value changes
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
//    row's frequency (a padding row's 0: not counted);
//  * run parity from pair_count.cuh's carried warp max scan
//    (chunk_counted), restarting at every row end; a warp's first chunk
//    walks back over the run that crosses into it, at most to its row's
//    first slot;
//  * each block counts into a table of its own in shared memory, flushed
//    once a key a block, its claims counted once a block, a grid of one
//    wave (pair_count.cuh).  The table's contract holds: at the end it is
//    exact, or OVF is set and the host counts again at twice the size.
//
// The apply.  The old one gave each row a warp, every row every round
// (grid_for_warps over ~1.1 M rows of 2-14 tokens in buckets of width 8 or
// 16, most lanes idle), each visit reading the row's offsets and walking
// its chunks with two ballots and two shuffles a chunk: 821.9 ms over the
// 3,844 applies of the 100 MB run's first 3,000 ids against a bound of
// 65.76, and on 4 shards a launch a shard, 849.8 ms over 15,376 (H100 80GB
// HBM3, 700 W), though in a late round almost no row holds the pair.  This
// one walks the slots, not the rows, as the count does:
//  * a grid of one wave over one slot space of the card's states' 128-slot
//    chunks (a device array of RowShard, a prefix of their chunk counts in
//    shared memory); a warp a contiguous run of them, a lane 4 slots by one
//    16-byte load;
//  * a warp owns the rows whose first slot lies in its run: it starts at
//    the first of them and goes on past the run's end to the end of the
//    last, so no two warps write one row and run parity restarts at each
//    owned row's first slot with no walk back;
//  * a chunk without a hit (a[i] == x, a[i+1] == y, both slots the warp's)
//    costs one load and one vote, unless a row with drops before it runs
//    into it; nothing is written for it.  Else each slot's row comes from
//    the bucket table (a hit never joins two rows), the selected hits from
//    the carried max scan, and each kept token moves left by the drops
//    before it in its row: a segmented scan over the lanes' slots, the
//    drops before the slot less those before its row's first slot, carried
//    across chunks for a row that spans them.  PAD goes from a row's new
//    live end to its old one.
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
// parts in; the top-k (k = 1) runs on every replica and bucket_apply once a
// card over its shards' rows.
//
// Every kernel does nothing once `done` or `overflow` is set or `used`
// reached min(vocab, limit), so the host enqueues rounds in batches.  A count
// that fills more than half the table sets `overflow` and stops probing; the
// host doubles the table and the round runs again.
//
// Bound.  A round reads every slot of the rows twice (count and apply, 4 B
// a slot, plus the rows' frequencies in the count), writes the slots the
// merge changes, empties the table (12 B a slot), fills its occupied slots,
// and reads every count and the live keys in the top-k.  At the 100 MB /
// vocab-30000 point that is ~8.4 M slots x 8 B and a 2^19-slot table a
// round, ~25 us at 3.35 TB/s, times ~29,000 rounds.  What the design does
// about it: no sort (the JAX program sorts every pair each round), one flat
// pass a kernel, the count's same-key updates summed in shared memory, rows
// compacted where they lie and left unwritten (and, but for one load, unread
// past the vote) where the merge misses them; one merge a round is v0's own
// rule, so the round count stays.

#include <cstdint>
#include <cuda_runtime.h>

#include "encode_common.cuh"
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

// One shard of an apply launch, as the host lays it out (8 int64): its rows
// (tok [S], 16-byte aligned), bucket table (nb buckets and the end), ctl,
// cand and work.
struct RowShard {
  int32_t *tok;
  const RowBucket *bk;
  long long nb;
  long long S;
  const int32_t *ctl;
  const int32_t *cand;
  long long *work;
  long long unused;
};
static_assert(sizeof(RowShard) == 8 * 8, "the host lays an apply shard out as 8 int64");

constexpr int kMaxRowShards = kMaxParts;  // shards of a card in one apply launch

// Four slots from p (16-byte aligned), PAD past n, by plain loads: the apply
// rewrites the rows it reads.
__device__ __forceinline__ void load4_rw(const int32_t *v, int p, int n, int32_t (&out)[4]) {
  if (p + 3 < n) {
    const int4 q = *reinterpret_cast<const int4 *>(v + p);
    out[0] = q.x;
    out[1] = q.y;
    out[2] = q.z;
    out[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = p + j < n ? v[p + j] : kPad;
  }
}

// The offset of slot i in its row, i in bucket b (its RowBucket as an int4).
__device__ __forceinline__ int row_pos(const int4 &b, int i) {
  const int d = i - b.x;
  return d - (b.w >= 0 ? d >> b.w : d / b.z) * b.z;
}

// The first slot of the first row that starts at or after slot i (i < S).
__device__ __forceinline__ int row_start_from(const RowBucket *bk, int nb, int i) {
  const int4 b = bucket_row(bk, bucket_of(bk, nb, i));
  const int r = row_pos(b, i);
  return r ? i - r + b.z : i;
}

// The merge of (x, y) -> z in the rows of shard R that start in its chunks
// [c0, c1), by one warp: it owns those rows (and no other warp writes them),
// so it walks from the first one's first slot to the last one's end, past
// c1 when that row runs on.  A chunk of 128 slots is a 16-byte load a lane;
// one with no hit of an owned row, and no row before it whose slots still
// move, ends there.  Else each slot's row comes from the bucket table, and
// inside each row: hits at even offsets of a run of hits take z (run parity
// from the carried warp max scan of the last slot without a hit; a row's
// last slot is never a hit, so runs restart at every row), the slot after
// each drops, and each kept token moves left by the drops before it in its
// row (a segmented scan: the drops before the slot less those before its
// row's first slot, carried across chunks for a row that spans them); the
// destinations fill each row in order, at or before the slots read, so a
// destination still holds its old value when it is read.  PAD goes from a
// row's new live end to its old one.  A slot is written only where its
// value changes; returns the lane's writes.
__device__ int apply_run(const RowShard &R, int c0, int c1, int32_t x, int32_t y, int32_t z) {
  int32_t *tok = R.tok;
  const RowBucket *bk = R.bk;
  const int nb = (int)R.nb, S = (int)R.S;
  const int lane = threadIdx.x & 31;
  const int P0 = c0 * 128, P1 = c1 * 128 < S ? c1 * 128 : S;
  const int lo = row_start_from(bk, nb, P0);  // the first owned row
  if (lo >= P1) return 0;                       // no row starts in the run
  const int hi = P1 < S ? row_start_from(bk, nb, P1) : S;  // past the last owned row
  int4 cb = make_int4(1 << 30, 0, 1, 0);  // the lane's bucket, [cb.x, b_next)
  int b_next = 0;
  int writes = 0;
  int lnh = lo - 1;   // the last slot so far without a hit
  bool csel = false;  // the slot before the chunk holds a selected hit
  int dx = 0;         // drops before the chunk
  int rdx = 0;        // drops before the first slot of the row open at the chunk's start
  int open_end = 0;   // that row's end, while its slots still move
  for (int base = lo & ~127; base < hi; base += 128) {
    const int p = base + 4 * lane;
    int32_t a[4];
    load4_rw(tok, p, S, a);
    int32_t after = __shfl_down_sync(kFullMask, a[0], 1);
    if (lane == 31) after = a[3] == x && base + 128 < S ? tok[base + 128] : kPad;
    int32_t nbr[4] = {a[1], a[2], a[3], after};
    bool any = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) any |= a[j] == x && nbr[j] == y && p + j >= lo && p + j < hi;
    if (!__any_sync(kFullMask, any) && base >= open_end) {
      lnh = base + 127;
      rdx = dx;
      continue;
    }
    if (lane == 31) nbr[3] = base + 128 < S ? tok[base + 128] : kPad;
    bool mine[4], first[4], last[4], hit[4];
    int rend = 0;  // the end of the row of the lane's last slot
    int ln = -1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = p + j;
      mine[j] = i >= lo && i < hi;
      first[j] = false;
      last[j] = true;
      if (mine[j]) {
        if (i < cb.x || i >= b_next) {
          const int b = bucket_of(bk, nb, i);
          cb = bucket_row(bk, b);
          b_next = __ldg(&bk[b + 1].off);
        }
        const int r = row_pos(cb, i);
        first[j] = r == 0;
        last[j] = r == cb.z - 1;
        if (j == 3) rend = i - r + cb.z;
      }
      hit[j] = mine[j] && !last[j] && a[j] == x && nbr[j] == y;
      if (!hit[j]) ln = i;
    }
    // run parity
    const int incl = warp_max_scan(ln);
    int l = __shfl_up_sync(kFullMask, incl, 1);
    if (lane == 0) l = -1;
    l = l > lnh ? l : lnh;
    const int top = __shfl_sync(kFullMask, incl, 31);
    lnh = top > lnh ? top : lnh;
    bool sel[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!hit[j]) l = p + j;
      sel[j] = hit[j] && ((p + j - l - 1) & 1) == 0;
    }
    bool psel = __shfl_up_sync(kFullMask, sel[3], 1);
    if (lane == 0) psel = csel;
    csel = __shfl_sync(kFullMask, sel[3], 31);
    const bool drop[4] = {psel, sel[0], sel[1], sel[2]};
    // the drops before each slot, and before its row's first slot
    const int nd = (int)drop[0] + (int)drop[1] + (int)drop[2] + (int)drop[3];
    const int dincl = yttm_enc::warp_inclusive_scan(nd, yttm_enc::SumOp());
    int e = dx + dincl - nd;
    dx += __shfl_sync(kFullMask, dincl, 31);
    int dxs[4], rs = -1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dxs[j] = e;
      if (first[j]) rs = e;
      e += drop[j];
    }
    const int rin = warp_max_scan(rs);
    int rp = __shfl_up_sync(kFullMask, rin, 1);
    if (lane == 0) rp = -1;
    rp = rp > rdx ? rp : rdx;
    const int rtop = __shfl_sync(kFullMask, rin, 31);
    rdx = rtop > rdx ? rtop : rdx;
    int dst[4];
    int32_t old[4];
    bool put[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (first[j]) rp = dxs[j];
      const int sh = dxs[j] - rp;
      dst[j] = p + j - sh;
      put[j] = mine[j] && a[j] >= 0 && !drop[j] && (sh > 0 || sel[j]);
      old[j] = put[j] && sh > 0 ? tok[dst[j]] : a[j];
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int32_t v = sel[j] ? z : a[j];
      if (put[j] && v != old[j]) {
        tok[dst[j]] = v;
        ++writes;
      }
      // a row's last live slot: PAD over the slots its drops freed
      if (mine[j] && a[j] >= 0 && (last[j] || nbr[j] < 0)) {
        const int i = p + j, k = i - dst[j] + (int)drop[j];
        for (int q = i + 1 - k; q <= i; ++q) {
          tok[q] = kPad;
          ++writes;
        }
      }
    }
    __syncwarp();
    // the row open at the chunk's end, if its slots still move
    const int oe = __shfl_sync(kFullMask, mine[3] && !last[3] ? rend : 0, 31);
    open_end = dx != rdx || csel ? oe : 0;
  }
  return writes;
}

// The round's merge in the rows of the n_sh shards of one card (rows: a
// device array of RowShard): one slot space of every shard's 128-slot
// chunks (a shard whose round accepted nothing has none), a warp a
// contiguous run of them (apply_run on each shard it meets).
__global__ void __launch_bounds__(kCountThreads)
    apply_rows_kernel(const RowShard *rows, int n_sh) {
  __shared__ int pre[kMaxRowShards + 1];  // each shard's first chunk
  if (threadIdx.x < n_sh) {
    const RowShard &r = rows[threadIdx.x];
    pre[threadIdx.x + 1] = r.ctl[NACC] ? (int)((r.S + 127) / 128) : 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    pre[0] = 0;
    for (int s = 0; s < n_sh; ++s) pre[s + 1] += pre[s];
  }
  __syncthreads();
  const long long total = pre[n_sh];
  if (total == 0) return;
  const long long warp = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = (gridDim.x * (long long)blockDim.x) >> 5;
  const int g0 = (int)(total * warp / n_warps), g1 = (int)(total * (warp + 1) / n_warps);
  for (int s = 0; s < n_sh; ++s) {
    const int c0 = g0 > pre[s] ? g0 : pre[s], c1 = g1 < pre[s + 1] ? g1 : pre[s + 1];
    if (c0 >= c1) continue;
    const RowShard R = rows[s];
    int writes = apply_run(R, c0 - pre[s], c1 - pre[s], R.cand[0], R.cand[1], R.cand[2]);
    writes = __reduce_add_sync(kFullMask, writes);
    if ((threadIdx.x & 31) == 0 && writes)
      atomicAdd((unsigned long long *)R.work + W_WRITES, (unsigned long long)writes);
  }
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

// One round's apply in the rows of n_sh shards of one card (rows: a device
// array of RowShard, each tok 16-byte aligned: the caller checks; slots:
// their rows' slots summed): the pair merged in every row, the rows
// front-packed; at most max_blocks blocks when > 0, else one wave.
int yttm_bucket_apply(const void *rows, int n_sh, long long slots, int max_blocks, void *stream) {
  if (n_sh <= 0 || n_sh > kMaxRowShards || slots <= 0) return (int)cudaErrorInvalidValue;
  apply_rows_kernel<<<count_grid<apply_rows_kernel>(slots, max_blocks), kCountThreads, 0,
                      (cudaStream_t)stream>>>((const RowShard *)rows, n_sh);
  return (int)cudaGetLastError();
}

}  // extern "C"
