// The v3 trainer sharded over a data mesh, on Hopper: the shard-local half
// of a round and the recount branch's count; the exchange and fold into
// every replica are train_delta_sharded.cu's shard_fold.
//
// Replaces the JAX program
//   youtokentome_tpu/parallel/train_sparse_sharded.py:86 _train_sparse_sharded
// (per shard: _pairs_tomb, _apply_tomb, _affected_positions and the delta
// fold's _gather_affected with the old and new contributions of the
// affected positions, bounded to dcap; the pmax of the shards' n_aff > dcap;
// the recount fold's local _pairs_tomb count).  The plain torch versions are
// in youtokentome_tpu_torch/ops/sparse_sharded_kernels.py.
//
// State.  Every shard keeps, on its device, the v3 state of train_sparse.cu
// (its tombstoned stream t, pw, off, fw; a replica of the exact pair-count
// table), its ctl (shard_exchange.cuh), a delta buffer dk/dv of 2*dcap
// entries (old contributions at [0, dcap), new at [dcap, 2*dcap)) and a
// scratch table of cap slots for the recount branch.  All replicas fold the
// same entries, so they hold the same keys and counts and take the same
// candidates.
//
// Kernels (one C entry each; a round is topk_accept and sparse_emit on every
// shard, sparse_shard_recount on every shard, shard_fold on every replica):
//   sparse_emit           sparse_apply's two passes (sparse_word.cuh): list
//                         the words holding an accepted pair among their
//                         live tokens, then one warp a listed word merges it
//                         in place; its old (-f) and new (+f) counted pairs
//                         go to the shard's buffer through a warp-aggregated
//                         cursor, not into the table.  ctl[LIVE] sums the
//                         listed words' positions, tombstones included (the
//                         JAX n_aff: _affected_positions flags every position
//                         of a word with a hit); DOVF is set when it passes
//                         dcap.  Past dcap no entry is kept, and the round
//                         takes the recount branch.
//   sparse_shard_recount  a no-op unless some shard's DOVF is set (the JAX
//                         pmax): clears the shard's scratch table
//                         (shard_exchange.cuh) and counts the shard's
//                         tombstoned stream into it (tomb_count.cuh, the
//                         flat count that the one-device sparse_count runs).
//
// Two routes drive a round (ops/sparse_sharded_kernels.py).  On a mesh whose
// shards share one card the round is a CUDA graph (round_graph.cuh) built
// here by yttm_sparse_shard_graph: every shard's top-k (through
// yttm_topk_accept's address in libtrain_topk.so) and sparse_emit, the gate,
// an IF node over every shard's sparse_shard_recount and the rebuild fold,
// an IF node over the delta fold (both through their entries' addresses in
// libtrain_delta_sharded.so).  Elsewhere the host launches every kernel of a
// round, the recount and both fold entries each deciding on the card.
//
// Bound.  A round's emit reads the shard's positions once (4 B) and reads
// and writes the listed words (8 B a position) and writes its buffer entries
// (12 B each); a recount round reads the stream and the words' offsets and
// weights and writes the shard's live pairs (12 B each; shard_fold adds
// those, from ROCC).  The kernels add these bytes to work[W_EMIT] and
// work[W_COUNT].  What the design does about it: the exchange moves the
// bounded buffers, not tables, in every round without a DOVF; the branch is
// picked on the card, and on one card only the branch's kernels run.

#include <cstdint>
#include <cuda_runtime.h>

#include "round_graph.cuh"
#include "shard_exchange.cuh"
#include "sparse_word.cuh"
#include "tomb_count.cuh"
#include "train_common.cuh"

namespace {

using namespace yttm;

constexpr int NPOS = LIVE;  // v3: the positions of the round's listed words

__global__ void __launch_bounds__(256)
    emit_live_words_kernel(int32_t *t, const int32_t *off, const int32_t *fw, int32_t *ctl,
                           const int32_t *cand, const int32_t *aff, unsigned long long *dk,
                           int32_t *dv, int dcap, long long *work, int end) {
  __shared__ Cands c;
  const int n = load_cands(c, ctl, cand);
  if (n == 0) return;
  const int lane = threadIdx.x & 31;
  if (blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd((unsigned long long *)(work + W_EMIT), 4ull * end);  // pass 1's read
  const int n_aff = ctl[NAFF];
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  for (int a_i = warp; a_i < n_aff; a_i += n_warps) {
    const int w = aff[a_i];
    int32_t *tw = t + off[w];
    const int len = off[w + 1] - off[w];
    const int32_t f = fw[w];
    if (lane == 0) {
      if (atomicAdd(ctl + NPOS, len) + len > dcap) atomicExch(ctl + DOVF, 1);
      atomicAdd((unsigned long long *)(work + W_EMIT), 8ull * len);
    }
    merge_live_word(tw, len, c, n, [&](bool counted, unsigned long long key) {
      emit(counted && f > 0, key, -f, DN_OLD, dk, dv, dcap, ctl, work);
    });
    for_live_pairs(tw, len, [&](bool counted, unsigned long long key) {
      emit(counted && f > 0, key, f, DN_NEW, dk, dv, dcap, ctl, work);
    });
  }
}

}  // namespace

extern "C" {

// One round's shard-local half: list the words with an accepted pair among
// their live tokens, merge them in place, and append their old and new
// contributions to the buffer.  end = off[W], the positions of the words.
int yttm_sparse_shard_emit(void *t, const void *pw, const void *off, const void *fw, int W,
                           int end, void *ctl, const void *cand, void *aff, void *wmark, void *dk,
                           void *dv, int dcap, void *work, void *stream) {
  if (W <= 0 || dcap <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync((int32_t *)ctl + NPOS, 0, sizeof(int32_t), s);
  if (e != cudaSuccess) return (int)e;
  mark_live_words_kernel<<<grid_for_warps(W), 256, 0, s>>>(
      (const int32_t *)t, (const int32_t *)pw, (const int32_t *)off, W, (int32_t *)ctl,
      (const int32_t *)cand, (int32_t *)aff, (int32_t *)wmark);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  emit_live_words_kernel<<<grid_for_warps(W), 256, 0, s>>>(
      (int32_t *)t, (const int32_t *)off, (const int32_t *)fw, (int32_t *)ctl,
      (const int32_t *)cand, (const int32_t *)aff, (unsigned long long *)dk, (int32_t *)dv, dcap,
      (long long *)work, end);
  return (int)cudaGetLastError();
}

// The recount branch's count of one shard's tombstoned stream into its
// scratch table, a no-op unless some shard's DOVF is set: the table
// emptied, then tomb_count.cuh's count into it (ROCC, ROVF).  t and pw (end
// = off[W] slots) 16-byte aligned; ctls: a device array of the n_sh shards'
// ctl pointers; the count on at most max_blocks blocks when that is > 0.
int yttm_sparse_shard_recount(const void *t, const void *pw, const void *off, const void *fw,
                              int W, int end, void *rkeys, void *rcnts, int cap, void *ctl,
                              const void *ctls, int n_sh, void *work, int max_blocks,
                              void *stream) {
  // a shard without words still clears its scratch table, which every
  // replica reads in a recount round
  if (W < 0 || (W > 0 && end <= 0) || cap <= 0 || (cap & (cap - 1)) != 0 || n_sh <= 0 ||
      max_blocks < 0 || ((uintptr_t)t & 15u) || ((uintptr_t)pw & 15u))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  recount_clear_kernel<<<grid_for(cap, 256), 256, 0, s>>>(
      (unsigned long long *)rkeys, (int32_t *)rcnts, cap, (int32_t *)ctl,
      (const int32_t *const *)ctls, n_sh, end, W, (long long *)work);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || W == 0) return (int)e;
  return (int)launch_tomb_count<ROCC, ROVF>(
      (const int32_t *)t, (const int32_t *)pw, (const int32_t *)off, (const int32_t *)fw, end,
      (unsigned long long *)rkeys, (int32_t *)rcnts, cap, (int32_t *)ctl,
      (const int32_t *const *)ctls, n_sh, DOVF, max_blocks, s);
}

// Frees a graph of yttm_sparse_shard_graph (null: nothing).
int yttm_sparse_shard_graph_free(void *graph) { return shard_graph_free((ShardGraph *)graph); }

// The round graph (round_graph.cuh) of the n_sh shards of one card: every
// shard's top-k and sparse_emit, the gate, the recount branch (every shard's
// sparse_shard_recount, then fold_rebuild) and fold_delta.  shards, a host
// array of n_sh GraphShard (t, pw and off[W] in tok, pwid and Mw); reps, a
// device array of their n_sh Replica (train_delta_sharded.cu); ctls .. rcs,
// the device arrays of the shards' pointers that the per-call entries take;
// topk, fold_delta, fold_rebuild: the addresses of yttm_topk_accept,
// yttm_shard_fold_delta and yttm_shard_fold_rebuild; limit .. n_own, the
// top-k's arguments; runs, 2 int64 on the card.  *out gets a handle for
// yttm_sparse_shard_graph_launch and yttm_sparse_shard_graph_free.
int yttm_sparse_shard_graph(void **out, const void *shards, int n_sh, const void *reps,
                            const void *ctls, const void *dks, const void *dvs, const void *rks,
                            const void *rcs, int dcap, void *topk, void *fold_delta,
                            void *fold_rebuild, int limit, int vocab, int used_ids0, int k,
                            int n_own, void *runs) {
  *out = nullptr;
  const GraphShard *sh = (const GraphShard *)shards;
  if (n_sh <= 0 || !topk || !fold_delta || !fold_rebuild || !runs) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_sh; ++i)
    if (sh[i].cap != sh[0].cap) return (int)cudaErrorInvalidValue;
  const int cap = (int)sh[0].cap;
  const TopkFn topk_accept = (TopkFn)topk;
  const FoldDeltaFn fold_d = (FoldDeltaFn)fold_delta;
  const FoldRebuildFn fold_r = (FoldRebuildFn)fold_rebuild;
  // every shard's top-k, then every shard's merge and buffer
  auto local = [&](cudaStream_t s) {
    cudaError_t e = cudaSuccess;
    for (int i = 0; i < n_sh && e == cudaSuccess; ++i) {
      const GraphShard &q = sh[i];
      e = (cudaError_t)topk_accept((const void *)q.keys, (const void *)q.cnts, (int)q.cap,
                                   (void *)q.blk_hi, (void *)q.blk_lo, (int)q.n_blk,
                                   (void *)q.ticket, (void *)q.ctl, (void *)q.cand,
                                   (void *)q.rules, limit, vocab, used_ids0, k, n_own,
                                   (void *)q.work, s);
    }
    for (int i = 0; i < n_sh && e == cudaSuccess; ++i) {
      const GraphShard &q = sh[i];
      if (q.W == 0) continue;  // as the per-call wrapper: a shard with no word emits nothing
      e = (cudaError_t)yttm_sparse_shard_emit(
          (void *)q.tok, (const void *)q.pwid, (const void *)q.off, (const void *)q.fw, (int)q.W,
          (int)q.Mw, (void *)q.ctl, (const void *)q.cand, (void *)q.aff, (void *)q.wmark,
          (void *)q.dk, (void *)q.dv, dcap, (void *)q.work, s);
    }
    return e;
  };
  // the recount branch: every shard's count, then the rebuild of every replica
  auto recount = [&](cudaStream_t b) {
    cudaError_t e = cudaSuccess;
    for (int i = 0; i < n_sh && e == cudaSuccess; ++i) {
      const GraphShard &q = sh[i];
      e = (cudaError_t)yttm_sparse_shard_recount(
          (const void *)q.tok, (const void *)q.pwid, (const void *)q.off, (const void *)q.fw,
          (int)q.W, (int)q.Mw, (void *)q.rkeys, (void *)q.rcnts, cap, (void *)q.ctl, ctls, n_sh,
          (void *)q.work, 0, b);
    }
    if (e == cudaSuccess) e = (cudaError_t)fold_r(reps, n_sh, cap, ctls, rks, rcs, n_sh, runs, b);
    return e;
  };
  auto delta = [&](cudaStream_t b) {
    return (cudaError_t)fold_d(reps, n_sh, cap, ctls, dks, dvs, dcap, n_sh, b);
  };
  return build_round_graph(out, ctls, n_sh, runs, local, recount, delta);
}

// n replays of the round graph on `stream`.
int yttm_sparse_shard_graph_launch(void *graph, int n, void *stream) {
  return shard_graph_launch((ShardGraph *)graph, n, (cudaStream_t)stream);
}

}  // extern "C"
