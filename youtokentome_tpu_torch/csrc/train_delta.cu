// The v2 delta trainer's merge round, on Hopper: two kernels here and the
// shared top-k of train_topk.cu.
//
// Replaces the JAX device program
//   youtokentome_tpu/ops/train_delta.py:210 train_rounds_delta
// and the functions it runs each round: train_stream.py
// pair_keys_and_weights_fw, _topk_candidates, accept_prefix, store_rules,
// pair_hits, apply_accepted, sort_compact, and train_delta.py
// _reduce_by_key, _compact_kv, _full_recount, _affected_positions,
// _delta_contributions.  The plain torch versions of the kernels are in
// youtokentome_tpu_torch/ops/train_kernels.py.
//
// State (all on the card; the host reads `ctl` once per batch of rounds):
//   tok [Mw] int32   the word-laid stream: word w owns tok[off[w], off[w+1]-1),
//                    its live tokens front-packed, PAD (-1) after them, and
//                    one PAD separator at off[w+1]-1.  Words never move, so a
//                    merge compacts inside its word only: no stream-wide
//                    compaction (the JAX program sorts the whole stream).
//   pwid [Mw] int32  word of each position (-1 on separators)
//   keys [cap] u64, cnts [cap] int32
//                    open-addressing pair-count table, key x << 32 | y,
//                    linear probing, EMPTY = all ones, no deletions: a key
//                    whose count falls to 0 keeps its slot (it can never
//                    reach the top-k, which takes counts > 0 only).
//   ctl [8] int32    used, done, overflow, round, n_acc, occupied, error
//                    (train_common.cuh), n_aff
//   cand [16, 4]     this round's accepted [x, y, z, count]
//
// Kernels:
//   pair_count    one warp per word adds its pair contributions (run
//                 parity: floor(r/2) pairs in a run of r equal tokens,
//                 bpe.cpp:140-143), weighted by the word's frequency, with
//                 atomicCAS inserts and atomicAdd counts.  Builds the table
//                 at the start and rebuilds it from the stream after an
//                 overflow (the JAX recount and pcap-doubling retry); a
//                 count that overflows its table cuts its probes short, and
//                 the host counts again into a table twice the size.
//   topk_accept   (train_topk.cu) the top 16 live slots in the reference
//                 order and accept_prefix; writes rules, cand, ctl.
//   apply_delta   pass 1: threads walk the stream's positions and mark the
//                 words holding an accepted pair and list them; pass 2: one warp per
//                 listed word subtracts the word's old contributions, merges
//                 (even offsets inside runs of hits), compacts the word in
//                 place, and adds its new contributions.  A word of any
//                 length is walked 32 positions at a time by its warp.  Both
//                 passes are in word_apply.cuh, shared with the sharded
//                 engine's delta_emit (train_delta_sharded.cu).
//
// Every kernel does nothing once `done` or `overflow` is set or `used`
// reached min(vocab, limit), so the host can enqueue rounds in batches.
// An insert that finds the table more than half full sets `overflow`; the
// round still completes exactly (the stream is right; the table may not
// be), and the host rebuilds the table from the stream, which drops the
// count-0 slots (at twice the size when live pairs fill a quarter of it).
//
// Bound.  A round reads every slot's count in topk_accept (4 B a slot) and
// the keys of the live slots (8 B each), and the live stream once in
// apply_delta's pass 1 (4 B a token); the words with a hit are written
// again, with their offsets and the table entries their deltas touch.  At
// the 100 MB / vocab-30000 point that is a 2^19-2^22-slot table x 4 B plus
// up to 8.4 M x 4 B, ~10-15 us a round at 3.35 TB/s.  What the design does
// about it: no sort and no stream-wide compaction, so a round moves the
// table and the stream once; the words without a hit (most of them, after
// the first rounds) cost one coalesced read.  Same-key atomics on the most
// frequent pairs serialise in the first rounds, when most words are hit.

#include <cstdint>
#include <cuda_runtime.h>

#include "train_common.cuh"
#include "word_apply.cuh"

namespace {

using namespace yttm;

enum { NAFF = CTL_OWN };  // the round's listed words

__device__ __forceinline__ void table_add(unsigned long long *keys, int32_t *cnts, int cap,
                                          int32_t *ctl, unsigned long long key, int32_t delta,
                                          Mode mode) {
  yttm::table_add<OCC, OVERFLOW, ERROR>(keys, cnts, cap, ctl, key, delta, mode);
}

// Adds delta for every counted pair of the word tok[0, n) (live tokens
// first, PAD after).  Called by all 32 lanes of a warp.
__device__ __forceinline__ void add_word(const int32_t *tok, int n, int32_t delta, Mode mode,
                                         unsigned long long *keys, int32_t *cnts, int cap,
                                         int32_t *ctl) {
  yttm::add_word<OCC, OVERFLOW, ERROR>(tok, n, delta, mode, keys, cnts, cap, ctl);
}

__global__ void __launch_bounds__(256)
    pair_count_kernel(const int32_t *tok, const int32_t *off, const int32_t *fw, int W,
                      unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  for (int w = warp; w < W; w += n_warps) {
    const int base = off[w];
    add_word(tok + base, off[w + 1] - 1 - base, fw[w], kCount, keys, cnts, cap, ctl);
  }
}

// -- apply -------------------------------------------------------------------

__global__ void __launch_bounds__(256)
    apply_words_kernel(int32_t *tok, const int32_t *off, const int32_t *fw,
                       unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl,
                       const int32_t *cand, const int32_t *aff) {
  __shared__ Cands c;
  const int n = load_cands(c, ctl, cand);
  if (n == 0) return;
  const int n_aff = ctl[NAFF];
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  for (int a_i = warp; a_i < n_aff; a_i += n_warps) {
    const int w = aff[a_i];
    const int base = off[w];
    const int32_t f = fw[w];
    int32_t *t = tok + base;
    // old contributions out, merge, compact in place, new contributions in
    const int out = merge_word(t, off[w + 1] - 1 - base, c, n,
                               [&](bool counted, unsigned long long key) {
                                 if (counted) table_add(keys, cnts, cap, ctl, key, -f, kSub);
                               });
    add_word(t, out, f, kAdd, keys, cnts, cap, ctl);
  }
}

}  // namespace

extern "C" {

// Count every pair of the stream into an empty table (keys all EMPTY,
// counts 0, ctl[OCC] = ctl[OVERFLOW] = 0, set by the caller).
int yttm_train_pair_count(const void *tok, const void *off, const void *fw, int W, void *keys,
                          void *cnts, int cap, void *ctl, void *stream) {
  if (W <= 0 || cap <= 0 || (cap & (cap - 1)) != 0) return (int)cudaErrorInvalidValue;
  pair_count_kernel<<<grid_for_warps(W), 256, 0, (cudaStream_t)stream>>>(
      (const int32_t *)tok, (const int32_t *)off, (const int32_t *)fw, W,
      (unsigned long long *)keys, (int32_t *)cnts, cap, (int32_t *)ctl);
  return (int)cudaGetLastError();
}

// One round's merge of the accepted candidates with the table's deltas.
int yttm_train_apply_delta(void *tok, const void *pwid, int Mw, const void *off, const void *fw,
                           int W, void *keys, void *cnts, int cap, void *ctl, const void *cand,
                           void *aff, void *wmark, void *stream) {
  if (Mw < 2 || W <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  mark_words_kernel<NAFF><<<grid_for_warps((Mw - 1 + 31) / 32), 256, 0, s>>>(
      (const int32_t *)tok, (const int32_t *)pwid, Mw, (int32_t *)ctl, (const int32_t *)cand,
      (int32_t *)aff, (int32_t *)wmark);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  apply_words_kernel<<<grid_for_warps(W), 256, 0, s>>>(
      (int32_t *)tok, (const int32_t *)off, (const int32_t *)fw, (unsigned long long *)keys,
      (int32_t *)cnts, cap, (int32_t *)ctl, (const int32_t *)cand, (const int32_t *)aff);
  return (int)cudaGetLastError();
}

}  // extern "C"
