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
//                         pmax): clears the shard's scratch table and counts
//                         the shard's tombstoned stream into it (run parity
//                         in live-rank space, tombstones skipped).
//
// Bound.  A round's emit reads the shard's positions once (4 B) and reads
// and writes the listed words (8 B a position) and writes its buffer entries
// (12 B each); a recount round reads the stream and the words' offsets and
// weights and writes the shard's live pairs (12 B each; shard_fold adds
// those, from ROCC).  The kernels add these bytes to work[W_EMIT] and
// work[W_COUNT].  What the design does about it: the exchange moves the
// bounded buffers, not tables, in every round without a DOVF, and the
// branch is picked on the card.

#include <cstdint>
#include <cuda_runtime.h>

#include "shard_exchange.cuh"
#include "sparse_word.cuh"
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

// -- recount -----------------------------------------------------------------

__global__ void __launch_bounds__(256)
    sparse_recount_clear_kernel(unsigned long long *rkeys, int32_t *rcnts, int cap, int32_t *ctl,
                                const int32_t *const *ctls, int n_sh, int end, int W,
                                long long *work) {
  if (!any_flag(ctls, n_sh, DOVF)) return;
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < cap; s += gridDim.x * blockDim.x) {
    rkeys[s] = kEmpty;
    rcnts[s] = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    ctl[ROCC] = 0;
    ctl[ROVF] = 0;
    // the stream with its offsets and weights read once (the live pairs
    // written are added by shard_fold, which reads ROCC)
    work[W_COUNT] += 4ll * end + 8ll * W;
  }
}

__global__ void __launch_bounds__(256)
    sparse_recount_kernel(const int32_t *t, const int32_t *off, const int32_t *fw, int W,
                          unsigned long long *rkeys, int32_t *rcnts, int cap, int32_t *ctl,
                          const int32_t *const *ctls, int n_sh) {
  if (!any_flag(ctls, n_sh, DOVF)) return;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  for (int w = warp; w < W; w += n_warps) {
    const int32_t f = fw[w];
    for_live_pairs(t + off[w], off[w + 1] - off[w], [&](bool counted, unsigned long long key) {
      if (counted && f > 0)
        table_add<ROCC, ROVF, ERROR>(rkeys, rcnts, cap, ctl, key, f, kCount);
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
// scratch table, a no-op unless some shard's DOVF is set.  ctls: a device
// array of the n_sh shards' ctl pointers.
int yttm_sparse_shard_recount(const void *t, const void *off, const void *fw, int W, int end,
                              void *rkeys, void *rcnts, int cap, void *ctl, const void *ctls,
                              int n_sh, void *work, void *stream) {
  // a shard without words still clears its scratch table, which every
  // replica reads in a recount round
  if (W < 0 || cap <= 0 || (cap & (cap - 1)) != 0 || n_sh <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  sparse_recount_clear_kernel<<<grid_for(cap, 256), 256, 0, s>>>(
      (unsigned long long *)rkeys, (int32_t *)rcnts, cap, (int32_t *)ctl,
      (const int32_t *const *)ctls, n_sh, end, W, (long long *)work);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || W == 0) return (int)e;
  sparse_recount_kernel<<<grid_for_warps(W), 256, 0, s>>>(
      (const int32_t *)t, (const int32_t *)off, (const int32_t *)fw, W,
      (unsigned long long *)rkeys, (int32_t *)rcnts, cap, (int32_t *)ctl,
      (const int32_t *const *)ctls, n_sh);
  return (int)cudaGetLastError();
}

}  // extern "C"
