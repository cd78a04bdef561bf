// The tombstoned word walk shared by the v3 trainer (train_sparse.cu
// sparse_apply) and its sharded engine (train_sparse_sharded.cu sparse_emit),
// over the v3 stream: t [M] whose positions never move, a merge writing z at
// the selected pair starts and PAD at their live partners; word k is
// t[off[k], off[k+1]), pw [M] the word of each position (-1 after the last
// word).
//
//   mark_live_words_kernel  pass 1: a thread a position; a live token equal
//                           to an accepted x walks to its next live
//                           neighbour inside the word and lists the word
//                           (ctl[CTL_OWN] counts them) on a hit
//   for_live_pairs          a warp walks a word's live pairs (run parity in
//                           live-rank space), 32 positions a chunk (the
//                           counts of the whole stream walk it flat:
//                           tomb_count.cuh)
//   merge_live_word         pass 2, one warp a listed word: the old pairs
//                           handed to a callback, hits selected by parity
//                           along runs of hits, z and PAD written in place

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "train_common.cuh"

namespace yttm {

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

// Calls f(counted, key) at every position of the tombstoned word t[0, n):
// counted when the lane's live token ends a live pair that counts (run
// parity in live-rank space), key that pair's.  Called by all 32 lanes of a
// warp; every lane calls f in every step (f may use warp votes).
template <class F>
__device__ void for_live_pairs(const int32_t *t, int n, F f) {
  LiveWalk lw;
  int carry_lne = -1;
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
    f(pair && (!eq || ((r - lne - 1) & 1) == 0), pair_key(pa, a));
    carry_lne = __shfl_sync(0xFFFFFFFFu, lne, 31);
    lw.advance(a, i, kmask);
  }
}

// Merges the n accepted candidates c into the tombstoned word tw[0, len) in
// place: z at the selected pair starts, PAD at their live partners.  Before
// the merge, old(counted, key) is called at every position as
// for_live_pairs calls it (the word's old pairs).  Called by all 32 lanes.
template <class Old>
__device__ void merge_live_word(int32_t *tw, int len, const Cands &c, int n, Old old) {
  // one walk over the old tokens: writes land only at or before the lane's
  // own position, after all lanes read the chunk; the partners of later
  // chunks come from the walk's carry
  LiveWalk lw;
  int carry_lne = -1, carry_lnh = -1;
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
    old(pair && (!eq || ((r - lne - 1) & 1) == 0), pair_key(pa, a));
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
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

// Lists in aff (their number in ctl[CTL_OWN]) the words holding an accepted
// pair among their live tokens; wmark keeps the round a word was last listed.
__global__ void __launch_bounds__(256)
    mark_live_words_kernel(const int32_t *t, const int32_t *pw, const int32_t *off, int W,
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
    if (hit && atomicExch(wmark + w, tag) != tag) aff[atomicAdd(ctl + CTL_OWN, 1)] = w;
  }
}

}  // namespace yttm
