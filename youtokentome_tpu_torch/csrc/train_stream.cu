// The v1 stream trainer's merge round, on Hopper: its count (a clear here,
// then stream_count.cuh's flat count), its apply here, and the shared top-k
// of train_topk.cu.
//
// Replaces the JAX device program
//   youtokentome_tpu/ops/train_stream.py:251 train_rounds_resumable
// and what it runs each round: pair_keys_and_weights(_fw),
// _segment_counts_flat (a 3-array sort and a reduce-by-key), _topk_candidates,
// accept_prefix, store_rules, pair_hits, apply_accepted and sort_compact.
// The plain torch versions of the kernels are in
// youtokentome_tpu_torch/ops/stream_train_kernels.py.
//
// State (all on the card; the host reads `ctl` once per batch of rounds):
//   t, wid [M] int32   the JAX program's flat stream: the live tokens
//                      front-compacted (t[0, live)), PAD (-1) after them; a
//                      word is a run of one word id
//   tmp_t, tmp_w [M]   the merged stream before its compaction
//   tiles [2 * T]      the apply's scratch, per tile of 8192 positions: a
//                      max (of the scans' positions) and a count (of the
//                      kept positions)
//   keys [cap] u64, cnts [cap] int32
//                      open-addressing pair-count table, key x << 32 | y,
//                      emptied and counted again every round
//   ctl [12] int32     used, done, overflow, round, n_acc, occupied, error
//                      (train_common.cuh), live, next live
//   work [8] int64     rounds, occupied slots, table slots scanned (the
//                      top-k's), live tokens and kept tokens of the applied
//                      rounds (summed over the rounds)
//
// Kernels:
//   recount        clear: every slot emptied (and live <- next live);
//                  count: stream_count.cuh's flat walk of the live prefix,
//                  a warp a run of 128-slot chunks (16-byte loads of t and
//                  wid), run parity from a warp max scan carried from chunk
//                  to chunk (a run of equal tokens may span any number of
//                  chunks, warps and blocks), each block counting into a
//                  table of its own in shared memory, flushed once a key a
//                  block, its claims counted once a block
//   topk_accept    (train_topk.cu) the top 16 in the reference order and
//                  accept_prefix; writes cand, rules, ctl, work
//   apply_compact  hit tiles: each tile's last position without a hit;
//                  select: parity along runs of hits from the carried scan,
//                  z written at the selected starts, their right partners
//                  marked dropped, each tile's kept count; scatter: the kept
//                  tokens written in order at (earlier tiles' counts + a
//                  block exclusive scan), PAD after the new live end
//
// The sharded v1 engine (ops/recount_sharded_kernels.py, replacing
// youtokentome_tpu/parallel/train_stream_sharded.py:42 _train_sharded) runs
// the same count on each shard into the shard's scratch table
// (stream_shard_count: its occupancy and overflow in ctl's scratch slots),
// with every claimed slot listed by its key's part (part_list.cuh, staged a
// block).
// train_delta_sharded.cu's shard_part_fold rebuilds each replica's own part
// from the N shards' lists of that part and shard_gather copies the other
// parts in; the top-k runs on every replica and apply_compact on every
// shard.
//
// Every kernel does nothing once `done` or `overflow` is set or `used`
// reached min(vocab, limit), so the host enqueues rounds in batches.  A count
// that fills more than half the table sets `overflow` and stops probing;
// the host doubles the table and the round runs again (nothing was applied).
//
// Bound.  A round reads the live stream in the count (t, wid: 8 B a token)
// and the word frequencies (4 B a word, held in L2), fills the occupied
// slots (12 B) and empties the table (12 B a slot); it reads the live stream
// three times in the apply (t, wid) and writes it twice (tmp, then the
// compacted stream).  What the design does about it:
// no sort (the JAX program sorts the stream twice a round), every pass
// coalesced over the live prefix only, the count one pass with its
// same-key updates summed in shared memory; the recount of every pair every
// round is v1's own rule.

#include <cstdint>
#include <cuda_runtime.h>

#include "encode_common.cuh"
#include "part_list.cuh"
#include "stream_count.cuh"
#include "train_common.cuh"

namespace {

using namespace yttm;
using yttm_enc::block_exclusive_scan;
using yttm_enc::MaxOp;
using yttm_enc::SumOp;

enum { LIVE = CTL_OWN, NEXT_LIVE };
enum { W_LIVE = W_OWN, W_KEEP };

constexpr int kThreads = 1024;
constexpr int kItems = 8;  // consecutive positions a thread owns
constexpr int kTile = kThreads * kItems;
constexpr int32_t kKill = -2;  // a dropped position in tmp_t

// The block's reduction of v (every thread calls it).
template <class Op>
__device__ __forceinline__ int32_t block_reduce(int32_t v, int32_t identity, int32_t *wbuf, Op op) {
  int32_t total;
  block_exclusive_scan(v, identity, wbuf, &total, op);
  return total;
}

// The carry of tile b: the reduction of vals[0, b) (every thread calls it).
template <class Op>
__device__ __forceinline__ int32_t tile_carry(const int32_t *vals, int b, int32_t identity,
                                              int32_t *wbuf, Op op) {
  int32_t c = identity;
  for (int j = threadIdx.x; j < b; j += blockDim.x) c = op(c, vals[j]);
  return block_reduce(c, identity, wbuf, op);
}

// (t[i], t[i+1]) is a pair of one word (i + 1 < n, the live end)
__device__ __forceinline__ bool pair_at(const int32_t *wid, int i, int n) {
  return i + 1 < n && wid[i] == wid[i + 1];
}

// -- recount -------------------------------------------------------------------

// The clear before a count.  OCC_ and OVF_: the table's occupancy and
// overflow slots (the state's own table; a shard's scratch table in the
// sharded engine, whose overflow flag and part lists are cleared with it).
template <int OCC_, int OVF_, bool kLists>
__global__ void __launch_bounds__(256)
    clear_kernel(unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl, PartLists pl,
                 int limit, int vocab) {
  if (blockIdx.x == 0 && threadIdx.x == 0) ctl[LIVE] = ctl[NEXT_LIVE];
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

// -- apply ---------------------------------------------------------------------

// The index of the accepted candidate (a, b) is, or -1.
__device__ __forceinline__ int match(const Cands &c, int n, int32_t a, int32_t b) {
  int rix = -1;
  for (int j = 0; j < n; ++j)
    if (rix < 0 && a == c.x[j] && b == c.y[j]) rix = j;
  return rix;
}

__global__ void __launch_bounds__(kThreads)
    hit_tiles_kernel(const int32_t *t, const int32_t *wid, const int32_t *ctl,
                     const int32_t *cand, int32_t *tiles) {
  __shared__ Cands c;
  __shared__ int32_t wbuf[kThreads / 32];
  const int na = load_cands(c, ctl, cand);
  if (na == 0) return;
  const int n = ctl[LIVE];
  const int base = blockIdx.x * kTile;
  if (base >= n) return;
  int32_t m = -1;
  const int i0 = base + threadIdx.x * kItems;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = i0 + k;
    if (i < n && !(pair_at(wid, i, n) && match(c, na, t[i], t[i + 1]) >= 0)) m = i;
  }
  m = block_reduce(m, -1, wbuf, MaxOp());
  if (threadIdx.x == 0) tiles[blockIdx.x] = m;
}

__global__ void __launch_bounds__(kThreads)
    select_tiles_kernel(const int32_t *t, const int32_t *wid, const int32_t *ctl,
                        const int32_t *cand, int32_t *tiles, int n_tiles, int32_t *tmp_t,
                        int32_t *tmp_w) {
  __shared__ Cands c;
  __shared__ int32_t wbuf[kThreads / 32];
  const int na = load_cands(c, ctl, cand);
  if (na == 0) return;
  const int n = ctl[LIVE];
  const int base = blockIdx.x * kTile;
  if (base >= n) return;
  const int32_t carry = tile_carry(tiles, blockIdx.x, -1, wbuf, MaxOp());
  const int i0 = base + threadIdx.x * kItems;
  int rix[kItems];
  int32_t m = -1;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = i0 + k;
    rix[k] = i < n && pair_at(wid, i, n) ? match(c, na, t[i], t[i + 1]) : -1;
    if (i < n && rix[k] < 0) m = i;
  }
  int32_t total;
  int32_t run = block_exclusive_scan(m, -1, wbuf, &total, MaxOp());
  run = run > carry ? run : carry;  // the last position before i0 without a hit
  // was the position before i0 selected?  If it holds a hit, it adds nothing
  // to the scan, so `run` is its own last position without a hit
  bool prev_sel = false;
  if (i0 > 0 && i0 < n && pair_at(wid, i0 - 1, n) && match(c, na, t[i0 - 1], t[i0]) >= 0)
    prev_sel = ((i0 - 1 - run - 1) & 1) == 0;
  int32_t keeps = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = i0 + k;
    if (i >= n) break;
    if (rix[k] < 0) run = i;
    const bool sel = rix[k] >= 0 && ((i - run - 1) & 1) == 0;
    const bool keep = !prev_sel;
    tmp_t[i] = keep ? (sel ? c.z[rix[k]] : t[i]) : kKill;
    tmp_w[i] = wid[i];
    keeps += keep;
    prev_sel = sel;
  }
  keeps = block_reduce(keeps, 0, wbuf, SumOp());
  if (threadIdx.x == 0) tiles[n_tiles + blockIdx.x] = keeps;
}

__global__ void __launch_bounds__(kThreads)
    scatter_kernel(int32_t *t, int32_t *wid, int32_t *ctl, const int32_t *tiles, int n_tiles,
                   const int32_t *tmp_t, const int32_t *tmp_w, long long *work) {
  __shared__ int32_t wbuf[kThreads / 32];
  if (ctl[NACC] == 0) return;
  const int n = ctl[LIVE];
  const int base = blockIdx.x * kTile;
  if (base >= n) return;
  const int used_tiles = (n + kTile - 1) / kTile;
  const int32_t off = tile_carry(tiles + n_tiles, blockIdx.x, 0, wbuf, SumOp());
  const int32_t live2 = tile_carry(tiles + n_tiles, used_tiles, 0, wbuf, SumOp());
  const int i0 = base + threadIdx.x * kItems;
  int32_t keeps = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) keeps += i0 + k < n && tmp_t[i0 + k] != kKill;
  int32_t total;
  int32_t o = off + block_exclusive_scan(keeps, 0, wbuf, &total, SumOp());
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = i0 + k;
    if (i >= n) break;
    const int32_t v = tmp_t[i];
    if (v != kKill) {
      t[o] = v;
      wid[o] = tmp_w[i];
      ++o;
    }
    if (i >= live2) {  // never a destination: those lie below live2
      t[i] = kPad;
      wid[i] = kPad;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    ctl[NEXT_LIVE] = live2;
    work[W_LIVE] += n;
    work[W_KEEP] += live2;
  }
}

inline int n_tiles(int M) { return (M + kTile - 1) / kTile; }

template <int OCC_, int OVF_, bool kLists>
int recount(const void *t, const void *wid, const void *freq, int M, void *keys, void *cnts,
            int cap, void *ctl, const PartLists &pl, int limit, int vocab, int max_blocks,
            void *stream) {
  if (M <= 0 || cap <= 0 || (cap & (cap - 1)) != 0 || ((uintptr_t)t & 15u) ||
      ((uintptr_t)wid & 15u))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  clear_kernel<OCC_, OVF_, kLists><<<grid_for(cap, 256), 256, 0, s>>>(
      (unsigned long long *)keys, (int32_t *)cnts, cap, (int32_t *)ctl, pl, limit, vocab);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_stream_count<OCC_, OVF_, LIVE, kLists>(
      (const int32_t *)t, (const int32_t *)wid, (const int32_t *)freq, M,
      (unsigned long long *)keys, (int32_t *)cnts, cap, (int32_t *)ctl, pl, limit, vocab,
      max_blocks, s);
}

}  // namespace

extern "C" {

// One round's count: the table emptied, every live pair counted into it
// (t and wid 16-byte aligned; at most max_blocks blocks when > 0, else one
// wave).
int yttm_stream_recount(const void *t, const void *wid, const void *freq, int M, void *keys,
                        void *cnts, int cap, void *ctl, int limit, int vocab, int max_blocks,
                        void *stream) {
  return recount<OCC, OVERFLOW, false>(t, wid, freq, M, keys, cnts, cap, ctl,
                                       PartLists{nullptr, nullptr, 0, cap}, limit, vocab,
                                       max_blocks, stream);
}

// The sharded v1 engine's count of one shard: its scratch table (rkeys,
// rcnts) emptied and its live pairs counted into it, the occupancy and
// overflow in ctl's scratch slots, every claimed slot listed in its key's
// part among n_parts (plist [cap], pcnt [n_parts]); shard_part_fold then
// rebuilds every replica.
int yttm_stream_shard_count(const void *t, const void *wid, const void *freq, int M,
                            void *rkeys, void *rcnts, int cap, void *ctl, void *plist, void *pcnt,
                            int n_parts, int limit, int vocab, int max_blocks, void *stream) {
  if (n_parts <= 0 || n_parts > kMaxParts || cap < n_parts || !plist || !pcnt)
    return (int)cudaErrorInvalidValue;
  return recount<kShardRocc, kShardRovf, true>(
      t, wid, freq, M, rkeys, rcnts, cap, ctl,
      PartLists{(int32_t *)plist, (int32_t *)pcnt, n_parts, cap}, limit, vocab, max_blocks,
      stream);
}

// One round's merge of the accepted candidates and the stream's compaction.
int yttm_stream_apply(void *t, void *wid, int M, void *tmp_t, void *tmp_w, void *tiles, void *ctl,
                      const void *cand, void *work, void *stream) {
  if (M <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nt = n_tiles(M);
  hit_tiles_kernel<<<nt, kThreads, 0, s>>>((const int32_t *)t, (const int32_t *)wid,
                                           (const int32_t *)ctl, (const int32_t *)cand,
                                           (int32_t *)tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  select_tiles_kernel<<<nt, kThreads, 0, s>>>((const int32_t *)t, (const int32_t *)wid,
                                              (const int32_t *)ctl, (const int32_t *)cand,
                                              (int32_t *)tiles, nt, (int32_t *)tmp_t,
                                              (int32_t *)tmp_w);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  scatter_kernel<<<nt, kThreads, 0, s>>>((int32_t *)t, (int32_t *)wid, (int32_t *)ctl,
                                         (const int32_t *)tiles, nt, (const int32_t *)tmp_t,
                                         (const int32_t *)tmp_w, (long long *)work);
  return (int)cudaGetLastError();
}

}  // extern "C"
