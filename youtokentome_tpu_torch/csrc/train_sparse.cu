// The v3 sparse trainer's merge round, on Hopper: two kernels here and the
// shared top-k of train_topk.cu.
//
// Replaces the JAX device program
//   youtokentome_tpu/ops/train_sparse.py:156 train_rounds_sparse
// and what it runs each round: _pairs_tomb (next live neighbours by a
// suffix-min scan, run parity in live-rank space), _apply_tomb,
// train_delta.py _affected_positions, _gather_affected (a batched binary
// search), the dcap0/dcap1/recount tiers and _reduce_by_key, with the shared
// _topk_candidates, accept_prefix and store_rules.  The plain torch
// versions of the kernels are in youtokentome_tpu_torch/ops/sparse_kernels.py.
//
// State (all on the card; the host reads `ctl` once per batch of rounds):
//   t [M] int32        the JAX program's tombstoned stream: positions never
//                      move; a merge writes z at the selected pair starts and
//                      PAD (-1) at their live partners
//   pw [M], off [W+1]  word of each position (-1 after the last word) and
//                      each word's first position: word k is t[off[k], off[k+1])
//   fw [W] int32       each word's frequency
//   keys [cap] u64, cnts [cap] int32
//                      the exact pair-count table, open addressing, key
//                      x << 32 | y, atomic counts, a key keeps its slot at
//                      count 0 until the next rebuild
//   ctl [8] int32      used, done, overflow, round, n_acc, occupied, error
//                      (train_common.cuh), n_aff
//   aff [W], wmark [W] this round's listed words, and the round each word
//                      was last listed in
//   work [8] int64     rounds, occupied slots, table slots scanned (the
//                      top-k's), positions walked in pass 2, table updates
//                      (summed over the rounds)
//
// Kernels (their word walks in sparse_word.cuh, shared with the sharded
// engine's train_sparse_sharded.cu):
//   sparse_count   tomb_count.cuh's flat count of the stream's live pairs
//                  into an empty table (start, and rebuild after an
//                  overflow), shared with the sharded engine's recount
//   topk_accept    (train_topk.cu) the top 16 in the reference order and
//                  accept_prefix; writes cand, rules, ctl, work
//   sparse_apply   pass 1: a thread a position; a live token equal to an
//                  accepted x walks to its next live neighbour inside the
//                  word and lists the word on a hit; pass 2: one warp a
//                  listed word walks it once, 32 positions at a time, with a
//                  ballot-compacted live list (each live token's left partner
//                  is the previous live lane, or the carry of earlier
//                  chunks): the word's old pairs out (run parity in
//                  live-rank space), hits selected by parity along runs of
//                  hits, z and PAD written in place; then a second walk puts
//                  the new pairs in.  A word of any length full of
//                  tombstones costs one read of its positions a walk.
//
// The JAX program's tiers (site buffers of dcap0/dcap1 positions, else a
// full recount) decide nothing observable: the kernels have one path.  Every
// kernel does nothing once `done` or `overflow` is set or `used` reached
// min(vocab, limit), so the host enqueues rounds in batches; an insert that
// finds the table more than half full sets `overflow`, the round still
// completes exactly, and the host rebuilds the table from the stream.
//
// Bound.  A round reads every slot's count in the top-k (4 B a slot) and the
// live keys (8 B), the stream once in pass 1 (4 B a position, the word of
// the positions that hold an accepted x), and in pass 2 the listed words'
// positions twice with the table entries their pairs touch.  What the design
// does about it: no sort and no scan over the stream (the JAX program runs
// two suffix scans, cumsums and a site gather over all M positions a round),
// work proportional to the listed words' positions.

#include <cstdint>
#include <cuda_runtime.h>

#include "sparse_word.cuh"
#include "tomb_count.cuh"
#include "train_common.cuh"

namespace {

using namespace yttm;

enum { NAFF = CTL_OWN };  // the round's listed words
enum { W_SITES = W_OWN, W_TOUCH };

__device__ __forceinline__ void table_add(unsigned long long *keys, int32_t *cnts, int cap,
                                          int32_t *ctl, unsigned long long key, int32_t delta,
                                          Mode mode) {
  yttm::table_add<OCC, OVERFLOW, ERROR>(keys, cnts, cap, ctl, key, delta, mode);
}

// Adds delta for every counted live pair of the word t[0, n); returns the
// lane's number of table updates.  All 32 lanes.
__device__ int walk_add(const int32_t *t, int n, int32_t delta, Mode mode,
                        unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl) {
  int ops = 0;
  for_live_pairs(t, n, [&](bool counted, unsigned long long key) {
    if (counted) {
      table_add(keys, cnts, cap, ctl, key, delta, mode);
      ++ops;
    }
  });
  return ops;
}

// -- apply ---------------------------------------------------------------------

__global__ void __launch_bounds__(256)
    apply_words_kernel(int32_t *t, const int32_t *off, const int32_t *fw,
                       unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl,
                       const int32_t *cand, const int32_t *aff, long long *work) {
  __shared__ Cands c;
  const int n = load_cands(c, ctl, cand);
  if (n == 0) return;
  const int n_aff = ctl[NAFF];
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  for (int a_i = warp; a_i < n_aff; a_i += n_warps) {
    const int w = aff[a_i];
    int32_t *tw = t + off[w];
    const int len = off[w + 1] - off[w];
    const int32_t f = fw[w];
    int ops = 0;
    merge_live_word(tw, len, c, n, [&](bool counted, unsigned long long key) {
      if (counted) {
        table_add(keys, cnts, cap, ctl, key, -f, kSub);
        ++ops;
      }
    });
    ops += walk_add(tw, len, f, kAdd, keys, cnts, cap, ctl);
    ops = warp_sum(ops);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd((unsigned long long *)work + W_SITES, (unsigned long long)len);
      atomicAdd((unsigned long long *)work + W_TOUCH, (unsigned long long)ops);
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// Count the live pairs of the stream t / pw (M = off[W] slots, both
// 16-byte aligned) into an empty table (keys all EMPTY, counts 0, ctl[OCC] =
// ctl[OVERFLOW] = 0, set by the caller), on at most max_blocks blocks when
// that is > 0 (else one wave).
int yttm_sparse_count(const void *t, const void *pw, const void *off, const void *fw, int M,
                      void *keys, void *cnts, int cap, void *ctl, int max_blocks, void *stream) {
  if (M <= 0 || cap <= 0 || (cap & (cap - 1)) != 0 || max_blocks < 0 || ((uintptr_t)t & 15u) ||
      ((uintptr_t)pw & 15u))
    return (int)cudaErrorInvalidValue;
  return (int)launch_tomb_count<OCC, OVERFLOW>(
      (const int32_t *)t, (const int32_t *)pw, (const int32_t *)off, (const int32_t *)fw, M,
      (unsigned long long *)keys, (int32_t *)cnts, cap, (int32_t *)ctl, nullptr, 0, 0, max_blocks,
      (cudaStream_t)stream);
}

// One round's merge of the accepted candidates (in place, tombstones) with
// the table's deltas.
int yttm_sparse_apply(void *t, const void *pw, const void *off, const void *fw, int W,
                      void *keys, void *cnts, int cap, void *ctl, const void *cand, void *aff,
                      void *wmark, void *work, void *stream) {
  if (W <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  mark_live_words_kernel<<<grid_for_warps(W), 256, 0, s>>>(
      (const int32_t *)t, (const int32_t *)pw, (const int32_t *)off, W, (int32_t *)ctl,
      (const int32_t *)cand, (int32_t *)aff, (int32_t *)wmark);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  apply_words_kernel<<<grid_for_warps(W), 256, 0, s>>>(
      (int32_t *)t, (const int32_t *)off, (const int32_t *)fw, (unsigned long long *)keys,
      (int32_t *)cnts, cap, (int32_t *)ctl, (const int32_t *)cand, (const int32_t *)aff,
      (long long *)work);
  return (int)cudaGetLastError();
}

}  // extern "C"
