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
// Kernels:
//   sparse_count   one warp a word walks its live pairs (below) and counts
//                  them into an empty table (start, and rebuild after an
//                  overflow)
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

// The walk of a word's live tokens, 32 positions a chunk: each live lane
// learns its left partner (the previous live token of the word: the previous
// live lane of the chunk, or the last live token of earlier chunks) and the
// live rank of that partner.
struct LiveWalk {
  int32_t carry_tok = kPad;  // the last live token of earlier chunks
  int carry_pos = -1;        // its position
  int rank_base = 0;         // live tokens in earlier chunks

  // For the lane's token `a` at position i: sets (pa, pp, r) = the left
  // partner's token, position and live rank; returns whether the lane holds
  // a live pair.  All 32 lanes call it; then `advance`.
  __device__ __forceinline__ bool step(int32_t a, int i, unsigned kmask, int32_t &pa, int &pp,
                                       int &r) const {
    const int lane = threadIdx.x & 31;
    const unsigned lower = kmask & ((1u << lane) - 1u);
    const int src = lower ? 31 - __clz(lower) : 0;
    pa = __shfl_sync(0xFFFFFFFFu, a, src);
    pp = __shfl_sync(0xFFFFFFFFu, i, src);
    if (!lower) {
      pa = carry_tok;
      pp = carry_pos;
    }
    r = rank_base + __popc(lower) - 1;
    return a >= 0 && pa >= 0;
  }

  __device__ __forceinline__ void advance(int32_t a, int i, unsigned kmask) {
    const int last = kmask ? 31 - __clz(kmask) : 0;
    const int32_t lt = __shfl_sync(0xFFFFFFFFu, a, last);
    const int lp = __shfl_sync(0xFFFFFFFFu, i, last);
    if (kmask) {
      carry_tok = lt;
      carry_pos = lp;
    }
    rank_base += __popc(kmask);
  }
};

// Adds delta for every counted live pair of the word t[0, n) (run parity in
// live-rank space); returns the lane's number of table updates.  All 32 lanes.
__device__ int walk_add(const int32_t *t, int n, int32_t delta, Mode mode,
                        unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl) {
  LiveWalk lw;
  int carry_lne = -1, ops = 0;
  for (int b = 0; b < n; b += 32) {
    const int i = b + (threadIdx.x & 31);
    const int32_t a = i < n ? t[i] : kPad;
    const unsigned kmask = __ballot_sync(0xFFFFFFFFu, a >= 0);
    int32_t pa;
    int pp, r;
    const bool pair = lw.step(a, i, kmask, pa, pp, r);
    const bool eq = pair && pa == a;
    int lne = warp_max_scan(pair && !eq ? r : -1);
    lne = lne > carry_lne ? lne : carry_lne;
    if (pair && (!eq || ((r - lne - 1) & 1) == 0)) {
      table_add(keys, cnts, cap, ctl, pair_key(pa, a), delta, mode);
      ++ops;
    }
    carry_lne = __shfl_sync(0xFFFFFFFFu, lne, 31);
    lw.advance(a, i, kmask);
  }
  return ops;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

__global__ void __launch_bounds__(256)
    count_words_kernel(const int32_t *t, const int32_t *off, const int32_t *fw, int W,
                       unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  for (int w = warp; w < W; w += n_warps)
    walk_add(t + off[w], off[w + 1] - off[w], fw[w], kCount, keys, cnts, cap, ctl);
}

// -- apply ---------------------------------------------------------------------

__global__ void __launch_bounds__(256)
    mark_words_kernel(const int32_t *t, const int32_t *pw, const int32_t *off, int W,
                      int32_t *ctl, const int32_t *cand, int32_t *aff, int32_t *wmark) {
  __shared__ Cands c;
  const int n = load_cands(c, ctl, cand);
  if (n == 0) return;
  const int tag = ctl[ROUND];
  const int end = off[W];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < end; i += gridDim.x * blockDim.x) {
    const int32_t a = t[i];
    if (a < 0) continue;
    bool is_x = false;
    for (int j = 0; j < n; ++j) is_x |= a == c.x[j];
    if (!is_x) continue;
    const int w = pw[i];
    if (w < 0) continue;
    const int wend = off[w + 1];
    int nx = i + 1;
    while (nx < wend && t[nx] < 0) ++nx;  // tombstones: each walked by one token
    if (nx >= wend) continue;
    const int32_t b = t[nx];
    bool hit = false;
    for (int j = 0; j < n; ++j) hit |= a == c.x[j] && b == c.y[j];
    if (hit && atomicExch(wmark + w, tag) != tag) aff[atomicAdd(ctl + NAFF, 1)] = w;
  }
}

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
    // one walk over the old tokens: old pairs out, hits, z and PAD written
    // (only at or before the lane's own position, after all lanes read the
    // chunk; the partners of later chunks come from the walk's carry)
    LiveWalk lw;
    int carry_lne = -1, carry_lnh = -1, ops = 0;
    for (int b = 0; b < len; b += 32) {
      const int i = b + (threadIdx.x & 31);
      const int32_t a = i < len ? tw[i] : kPad;
      const unsigned kmask = __ballot_sync(0xFFFFFFFFu, a >= 0);
      int32_t pa;
      int pp, r;
      const bool pair = lw.step(a, i, kmask, pa, pp, r);
      const bool eq = pair && pa == a;
      int lne = warp_max_scan(pair && !eq ? r : -1);
      lne = lne > carry_lne ? lne : carry_lne;
      if (pair && (!eq || ((r - lne - 1) & 1) == 0)) {
        table_add(keys, cnts, cap, ctl, pair_key(pa, a), -f, kSub);
        ++ops;
      }
      int rix = -1;
      if (pair)
        for (int j = 0; j < n; ++j)
          if (rix < 0 && pa == c.x[j] && a == c.y[j]) rix = j;
      int lnh = warp_max_scan(pair && rix < 0 ? r : -1);
      lnh = lnh > carry_lnh ? lnh : carry_lnh;
      const bool sel = rix >= 0 && ((r - lnh - 1) & 1) == 0;
      __syncwarp();
      if (sel) {
        tw[pp] = c.z[rix];
        tw[i] = kPad;
      }
      carry_lne = __shfl_sync(0xFFFFFFFFu, lne, 31);
      carry_lnh = __shfl_sync(0xFFFFFFFFu, lnh, 31);
      lw.advance(a, i, kmask);
    }
    __syncwarp();
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

// Count every word's live pairs into an empty table (keys all EMPTY, counts
// 0, ctl[OCC] = ctl[OVERFLOW] = 0, set by the caller).
int yttm_sparse_count(const void *t, const void *off, const void *fw, int W, void *keys,
                      void *cnts, int cap, void *ctl, void *stream) {
  if (W <= 0 || cap <= 0 || (cap & (cap - 1)) != 0) return (int)cudaErrorInvalidValue;
  count_words_kernel<<<grid_for_warps(W), 256, 0, (cudaStream_t)stream>>>(
      (const int32_t *)t, (const int32_t *)off, (const int32_t *)fw, W,
      (unsigned long long *)keys, (int32_t *)cnts, cap, (int32_t *)ctl);
  return (int)cudaGetLastError();
}

// One round's merge of the accepted candidates (in place, tombstones) with
// the table's deltas.
int yttm_sparse_apply(void *t, const void *pw, const void *off, const void *fw, int W,
                      void *keys, void *cnts, int cap, void *ctl, const void *cand, void *aff,
                      void *wmark, void *work, void *stream) {
  if (W <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  mark_words_kernel<<<grid_for_warps(W), 256, 0, s>>>(
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
