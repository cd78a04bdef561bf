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
// Kernels (one C entry each; a round is topk_accept on every shard and
// sparse_emit on every card, sparse_shard_recount on every shard, shard_fold
// on every replica):
//   sparse_emit           one launch for every shard of a card (its section
//                         below): the words holding an accepted pair among
//                         their live tokens claimed and merged in place, in
//                         one flat pass; their old (-f) and new (+f) counted
//                         pairs go to the shard's buffer, not into the table.
//                         ctl[LIVE] sums the listed words' positions,
//                         tombstones included (the JAX n_aff:
//                         _affected_positions flags every position of a word
//                         with a hit); DOVF is set when it passes dcap.  Past
//                         dcap no entry is kept, and the round takes the
//                         recount branch.
//   sparse_shard_recount  a no-op unless some shard's DOVF is set (the JAX
//                         pmax): clears the shard's scratch table
//                         (shard_exchange.cuh) and counts the shard's
//                         tombstoned stream into it (tomb_count.cuh, the
//                         flat count that the one-device sparse_count runs).
//
// Two routes drive a round (ops/sparse_sharded_kernels.py).  On a mesh whose
// shards share one card the round is a CUDA graph (round_graph.cuh) built
// here by yttm_sparse_shard_graph: every shard's top-k (through
// yttm_topk_accept's address in libtrain_topk.so), one sparse_emit, the gate,
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
// work[W_COUNT].  What the design does about it: the emit reads the stream
// once (pw only where a pair of tokens is a candidate) and merges what it
// claims in the same pass, one launch a card; the exchange moves the
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
// ctl slots past the exchange's, 0 between launches: the positions summed so
// far this round (a shard's), and the blocks done (shard 0's)
enum { NPOS_RUN = POCC + 1, EMIT_DONE };

// -- sparse_emit --------------------------------------------------------------
//
// One launch a round for every shard of a card (a device array of
// EmitShard: t, pw and off[W] in tok, pwid and Mw).  The old emit made a
// memset and two launches a shard (a thread a position listing the words
// with a hit, up to 16 compares a live token and a serial walk over
// tombstones on an x; then a warp a listed word over a grid sized to all the
// shard's words, most lanes idle on words of ~8 positions): twelve nodes a
// round on 4 shards, 260.0 ms over 13,272 launches of the 100 MB run against
// a bound of 32.87 (H100 80GB HBM3, 700 W).  The design, delta_emit's
// (train_delta_sharded.cu) on the tombstoned stream:
//  * a grid of one wave over the concatenation of the card's shards: a step
//    is 8 warps x 256 positions of one shard, a block takes a contiguous
//    range of steps (emit_open, emit_shard);
//  * a warp loads its 256 positions, 8 a lane in two 16-byte loads, and
//    the 32 before them, finds each live token's left partner across
//    tombstones and tests the
//    pair with the candidates' bitmap, reading pw only for a pair the bitmap
//    takes (claim_live_words); a partner before those 32 is walked back for
//    only when they are all tombstones and the warp's first live token is
//    some candidate's y;
//  * the warp merges the words it claimed at once: short words (up to 32
//    positions, tombstones included) packed side by side over its lanes
//    (live_pack_merge), a longer word on the whole warp (merge_live_word,
//    then for_live_pairs);
//  * each word sends its whole old word's counted pairs (-f) and its whole
//    new word's (+f), staged a warp and reserved a block (EmitStage):
//    DN_OLD, DN_NEW and DOVF are the JAX counts and flags;
//  * NPOS (the JAX n_aff: every position of a listed word, tombstones
//    included) is summed a block into ctl[NPOS_RUN]; the launch's last block
//    (a ticket in shard 0's ctl[EMIT_DONE]) moves it to ctl[NPOS], sets DOVF
//    past dcap and leaves both slots 0, so the round needs no memset.
// A claimed word is the claimer's alone: another warp that reads it
// meanwhile may see it half merged, but only tests claims, and the word is
// taken.  Every replica takes the same candidates (the fold's note), so the
// launch loads shard 0's.

// The shared state of an emit block: the staging (shard_exchange.cuh), the
// round's candidates and each warp's words of its step.
struct SparseEmitBlock {
  CandSet c;
  EmitStage st;
  int32_t claimed[kEmitWarps][kWarpSlots];
  bool last;  // the launch's last block
};

constexpr int kStepSlots = kEmitWarps * kWarpSlots;

__device__ __forceinline__ int sparse_steps(const EmitShard *sh) {
  return sh->W > 0 ? (int)((sh->Mw + kStepSlots - 1) / kStepSlots) : 0;
}

__global__ void __launch_bounds__(256, 4)
    sparse_emit_kernel(const EmitShard *shards, int n_sh, int dcap) {
  __shared__ SparseEmitBlock sb;
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  emit_open(sb.st, shards, n_sh, [](const EmitShard *sh) { return sparse_steps(sh); });
  const int n = load_cand_set(sb.c, shards[0].ctl, shards[0].cand);  // its barriers order pre
  int cur = -1;
  if (n > 0) {
    if (blockIdx.x == 0 && threadIdx.x < n_sh && shards[threadIdx.x].W > 0)  // the walk's read
      atomicAdd((unsigned long long *)(shards[threadIdx.x].work + W_EMIT),
                4ull * shards[threadIdx.x].Mw);
    const int tag = shards[0].ctl[ROUND];
    const int T = sb.st.pre[n_sh];
    const int lo = (int)((long long)blockIdx.x * T / gridDim.x);
    const int hi = (int)((long long)(blockIdx.x + 1) * T / gridDim.x);
    int n_old = 0, n_new = 0;  // this warp's staged entries
    for (int step = lo; step < hi; ++step) {
      cur = emit_shard<NPOS_RUN>(sb.st, shards, step, cur, n_old, n_new, dcap);
      const EmitShard &sh = sb.st.cur;
      const int end = (int)sh.Mw;
      const int p0 = (step - sb.st.pre[cur]) * kStepSlots + wi * kWarpSlots;
      if (p0 >= end) continue;  // past the shard's end: the warp waits
      int32_t *t = sh.tok;
      int32_t a[kLaneSlots];
      load_slots(t, p0 + kLaneSlots * lane, end, a);
      const int32_t back = p0 - 32 + lane >= 0 ? t[p0 - 32 + lane] : kPad;
      int32_t w[kLaneSlots];
      const unsigned mine =
          claim_live_words(a, back, t, sh.pwid, sh.off, p0, sb.c, n, tag, sh.wmark, w);
      int total;
      int at = warp_exclusive(__popc(mine), total);
      if (total == 0) continue;
      int32_t *mine_w = sb.claimed[wi];
#pragma unroll
      for (int j = 0; j < kLaneSlots; ++j)
        if ((mine >> j) & 1u) mine_w[at++] = w[j];
      __syncwarp();
      int slots = 0;  // the words' positions
      for (int b = 0; b < total; b += 32) {
        const int cnt = min(32, total - b);
        for_word_packs(
            lane < cnt ? mine_w[b + lane] : -1, cnt, t, sh.off, sh.fw, 0,
            [&](int base, int len, int32_t f, int start, int ws, unsigned smask, int ptotal) {
              const LivePack p =
                  live_pack_merge(t, base, len, f, start, ws, smask, ptotal, sb.c, n);
              emit_stage(sb.st, p.co && p.f > 0, p.ko, -p.f, 0, n_old, dcap);
              emit_stage(sb.st, p.cn && p.f > 0, p.kn, p.f, 1, n_new, dcap);
              slots += ptotal;
              live_pack_write(p);
            },
            [&](int32_t *tw, int len, int32_t f) {
              merge_live_word(tw, len, sb.c, n, [&](bool counted, unsigned long long key) {
                emit_stage(sb.st, counted && f > 0, key, -f, 0, n_old, dcap);
              });
              for_live_pairs(tw, len, [&](bool counted, unsigned long long key) {
                emit_stage(sb.st, counted && f > 0, key, f, 1, n_new, dcap);
              });
              slots += len;
            });
      }
      emit_sums(sb.st, total, slots, slots);
    }
    if (cur >= 0) emit_flush_block<NPOS_RUN>(sb.st, n_old, n_new, dcap);
  }
  // the last block: every shard's positions to NPOS, DOVF past dcap
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    sb.last = atomicAdd(shards[0].ctl + EMIT_DONE, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!sb.last) return;
  __threadfence();
  for (int s = threadIdx.x; s < n_sh; s += blockDim.x) {
    if (shards[s].W <= 0) continue;
    int32_t *ctl = shards[s].ctl;
    const int npos = atomicExch(ctl + NPOS_RUN, 0);
    ctl[NPOS] = npos;
    if (npos > dcap) ctl[DOVF] = 1;
  }
  if (threadIdx.x == 0) shards[0].ctl[EMIT_DONE] = 0;
}

// Blocks of sparse_emit_kernel that the card holds at once.
int sparse_emit_grid() {
  static int blocks = 0;
  if (!blocks) blocks = wave_blocks(sparse_emit_kernel, kEmitWarps * 32);
  return blocks;
}

}  // namespace

extern "C" {

// The int32 slots a shard's ctl must hold (ops/sparse_sharded_kernels.py
// checks its own layout against it).
int yttm_sparse_shard_ctl_n() { return EMIT_DONE + 1; }

// One round's shard-local half for every shard of one card, one launch
// (sparse_emit_kernel): the words with an accepted pair among their live
// tokens merged in place, their old and new contributions appended to the
// shard's buffer.  shards: a device array of n_sh EmitShard (t 16-byte
// aligned: the caller checks; a shard without words has none of the walk).
int yttm_sparse_shard_emit_card(const void *shards, int n_sh, int dcap, void *stream) {
  if (n_sh <= 0 || n_sh > kMaxShards || dcap <= 0) return (int)cudaErrorInvalidValue;
  sparse_emit_kernel<<<sparse_emit_grid(), kEmitWarps * 32, 0, (cudaStream_t)stream>>>(
      (const EmitShard *)shards, n_sh, dcap);
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
// shard's top-k, one sparse_emit, the gate, the recount branch (every
// shard's sparse_shard_recount, then fold_rebuild) and fold_delta.  shards,
// a host array of n_sh GraphShard (t, pw and off[W] in tok, pwid and Mw);
// reps, a device array of their n_sh Replica (train_delta_sharded.cu); ctls
// .. rcs, the device arrays of the shards' pointers that the per-call
// entries take; topk, fold_delta, fold_rebuild: the addresses of
// yttm_topk_accept, yttm_shard_fold_delta and yttm_shard_fold_rebuild; emit,
// a device array of their n_sh EmitShard (yttm_sparse_shard_emit_card's);
// limit .. n_own, the top-k's arguments; runs, 2 int64 on the card.  *out
// gets a handle for yttm_sparse_shard_graph_launch and
// yttm_sparse_shard_graph_free.
int yttm_sparse_shard_graph(void **out, const void *shards, int n_sh, const void *reps,
                            const void *ctls, const void *dks, const void *dvs, const void *rks,
                            const void *rcs, int dcap, void *topk, void *fold_delta,
                            void *fold_rebuild, const void *emit, int limit, int vocab,
                            int used_ids0, int k, int n_own, void *runs) {
  *out = nullptr;
  const GraphShard *sh = (const GraphShard *)shards;
  if (n_sh <= 0 || n_sh > kMaxShards || !topk || !fold_delta || !fold_rebuild || !emit || !runs)
    return (int)cudaErrorInvalidValue;
  bool words = false;  // some shard holds a word: the emit runs
  for (int i = 0; i < n_sh; ++i) {
    if (sh[i].cap != sh[0].cap || (sh[i].tok & 15)) return (int)cudaErrorInvalidValue;
    words |= sh[i].W > 0;
  }
  const int cap = (int)sh[0].cap;
  const TopkFn topk_accept = (TopkFn)topk;
  const FoldDeltaFn fold_d = (FoldDeltaFn)fold_delta;
  const FoldRebuildFn fold_r = (FoldRebuildFn)fold_rebuild;
  // every shard's top-k, then the card's merge and buffers
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
    if (e == cudaSuccess && words)
      e = (cudaError_t)yttm_sparse_shard_emit_card(emit, n_sh, dcap, s);
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
