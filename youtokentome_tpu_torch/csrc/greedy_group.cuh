// The greedy merge of one word on warp lanes, shared by encode_greedy.cu
// (padded word rows) and stream_encode.cu (the unique words of a chunk),
// and the lane helpers that encode_dropout.cu takes from it.
//
// Semantics (the JAX _encode_greedy and _merge_fixed_point on one word):
// every round ranks each adjacent pair in the rule table, takes the
// word's least rank m, and merges the leftmost non-overlapping
// occurrences of rule m (even offsets inside each run of consecutive
// hits); the word stops when no pair has a rule.
//
// Two routines, both warp-synchronous (every lane of the warp calls them
// together, with no shared state but the warp's own scratch):
//   * greedy_group<G>: a word of up to G <= 32 tokens on G lanes, one
//     position a lane, 32 / G words a warp.  The word stays in registers
//     and is never compacted: a merge only marks its right token dead.  A
//     lane finds its right neighbour as the next live lane of the group's
//     ballot and keeps its pair's rank across rounds, looking the pair up
//     again only when it merged or its neighbour did.  The minimum is a
//     butterfly of shuffles within the group; the run parity of the hits
//     is a popcount of the live lanes since the last live non-hit lane.
//     No shared memory, no __syncthreads.  The warp loops until every
//     group is done; a group with no rule changes nothing in later rounds.
//   * greedy_warp<P>: a word of up to 32 * P tokens on a warp, P positions
//     a lane (chunk k: slots 32k..32k+31), the scans as warp shuffles
//     carried across chunks, the compaction through the warp's own
//     scratch (2 x 32P int32, shared memory); ranks move with their tokens
//     and only changed pairs are looked up.
//
// Placeholders (>= 1e9, unknown-character runs), PAD and NEWLINE never
// match a rule: stored keys are real token ids below 1e9, so no pair
// holding one is looked up.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "encode_common.cuh"

namespace yttm_enc {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int32_t kStale = -2;  // a rank to look up again (ranks are >= 0)

// The rank of pair (x, y), kMiss without a rule; PAD, NEWLINE and
// placeholders have none, and are not looked up.
__device__ __forceinline__ int32_t rank_of(const Table &t, int32_t x, int32_t y) {
  if (x < 0 || y < 0 || x >= kPlaceholderStart || y >= kPlaceholderStart) return kMiss;
  return lookup(t, x, y);
}

// The lane of the first set bit of m above this lane, -1 without one.
__device__ __forceinline__ int next_lane(unsigned m) {
  const unsigned up = m & ~((2u << (threadIdx.x & 31)) - 1u);
  return up ? __ffs(up) - 1 : -1;
}

// The lanes of this lane's group of G.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  const int lane = threadIdx.x & 31;
  return G == 32 ? kFull : ((1u << G) - 1u) << (lane - (lane & (G - 1)));
}

// Token (or rank) of the slot after each lane's in chunk c of a row held as
// v[P] (chunk c: slots 32c..32c+31): lane 31 takes the next chunk's first,
// `end` past the row.
template <int P>
__device__ __forceinline__ int32_t next_slot(const int32_t (&v)[P], int c, int32_t end) {
  int32_t head = end;
  if (c + 1 < P) head = __shfl_sync(kFull, v[c + 1 < P ? c + 1 : c], 0);
  const int32_t d = __shfl_down_sync(kFull, v[c], 1);
  return (threadIdx.x & 31) == 31 ? head : d;
}

// The greedy fixed point of each group's word (greedy_group above): on
// entry a lane holds its position's token and whether it is one (live;
// the live lanes of a group are its first ones), on return its token and
// whether it survived.  Returns the group's mask of surviving lanes: the
// merged word's token at lane l goes to position popc(mask & lanes below
// l).  n_rules == 0 leaves every word as it is.
template <int G>
__device__ __forceinline__ unsigned greedy_group(int32_t &tok, bool &live, const Table &t,
                                                 const int32_t *rules_z, int n_rules) {
  const int lane = threadIdx.x & 31;
  const unsigned group = group_mask<G>();
  const unsigned below = (1u << lane) - 1u;
  unsigned lm = __ballot_sync(kFull, live) & group;
  if (n_rules <= 0) return lm;
  int nl = next_lane(lm);
  int32_t nt = __shfl_sync(kFull, tok, nl < 0 ? lane : nl);
  int32_t rk = live && nl >= 0 ? rank_of(t, tok, nt) : kMiss;
  for (;;) {
    int32_t m = rk;
#pragma unroll
    for (int o = 1; o < G; o <<= 1) m = min(m, __shfl_xor_sync(kFull, m, o));
    const bool active = m < kMiss;
    if (!__any_sync(kFull, active)) break;
    // hits of rank m at even offsets inside each run of hits: the run
    // starts after the last live lane below that holds no hit
    const bool hit = active && rk == m;
    const unsigned nonhit = lm & ~__ballot_sync(kFull, hit) & below;
    const int lnh = nonhit ? 31 - __clz(nonhit) : -1;
    const unsigned since = lnh < 0 ? kFull : ~((2u << lnh) - 1u);
    const bool sel = hit && (__popc(lm & below & since) & 1) == 0;
    const unsigned sm = __ballot_sync(kFull, sel) & group;
    // the right token of a merged pair (the next live lane of a selected
    // one) leaves; a pair changes when either of its tokens merged
    const unsigned prev = lm & below;
    const bool dropped = prev && ((sm >> (31 - __clz(prev))) & 1u);
    const bool stale = sel || (nl >= 0 && ((sm >> nl) & 1u));
    if (sel) tok = __ldg(rules_z + m);
    if (dropped) {
      live = false;
      tok = kPad;
    }
    lm = __ballot_sync(kFull, live) & group;
    nl = next_lane(lm);
    nt = __shfl_sync(kFull, tok, nl < 0 ? lane : nl);
    if (!live) rk = kMiss;
    else if (stale) rk = nl >= 0 ? rank_of(t, tok, nt) : kMiss;
  }
  return lm;
}

// The greedy fixed point of one word held by the warp as tk[P] (slot
// 32k + lane in tk[k]; front-packed, PAD after), using stok and srk (32 * P
// int32 each, the warp's own) as scratch.  On return tk holds the merged
// word, front-packed, PAD after; returns its length.
template <int P>
__device__ __forceinline__ int greedy_warp(int32_t (&tk)[P], int32_t *stok, int32_t *srk,
                                           const Table &t, const int32_t *rules_z, int n_rules) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int n = 0;
#pragma unroll
  for (int k = 0; k < P; ++k) n += __popc(__ballot_sync(kFull, tk[k] != kPad));
  if (n_rules <= 0) return n;
  int32_t rk[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int32_t nt = next_slot<P>(tk, k, kPad);
    rk[k] = rank_of(t, tk[k], nt);
  }
  for (;;) {
    int32_t m = rk[0];
#pragma unroll
    for (int k = 1; k < P; ++k) m = min(m, rk[k]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = min(m, __shfl_xor_sync(kFull, m, o));
    if (m == kMiss) break;
    const int32_t z = __ldg(rules_z + m);
    // even offsets inside runs of hits: the last non-hit slot at or
    // before each, carried across chunks
    unsigned sm[P];
    int carry = -1;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int i = 32 * k + lane;
      const bool hit = rk[k] == m;
      int lnh = warp_inclusive_scan(hit ? -1 : i, MaxOp());
      lnh = lnh > carry ? lnh : carry;
      carry = __shfl_sync(kFull, lnh, 31);
      sm[k] = __ballot_sync(kFull, hit && ((i - lnh - 1) & 1) == 0);
    }
    // drop the right token of each merged pair, keep the ranks of the
    // pairs neither of whose tokens merged, compact into the scratch
    n = 0;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const bool sel = (sm[k] >> lane) & 1u;
      const bool sel_prev = lane ? (sm[k] >> (lane - 1)) & 1u : k > 0 && (sm[k > 0 ? k - 1 : 0] >> 31);
      const bool sel_next =
          lane < 31 ? (sm[k] >> (lane + 1)) & 1u : k + 1 < P && (sm[k + 1 < P ? k + 1 : k] & 1u);
      const bool keep = tk[k] != kPad && !sel_prev;
      const unsigned km = __ballot_sync(kFull, keep);
      if (keep) {
        const int o = n + __popc(km & below);
        stok[o] = sel ? z : tk[k];
        srk[o] = sel || sel_next ? kStale : rk[k];
      }
      n += __popc(km);
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int i = 32 * k + lane;
      tk[k] = i < n ? stok[i] : kPad;
      rk[k] = i < n ? srk[i] : kMiss;
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int32_t nt = next_slot<P>(tk, k, kPad);
      if (rk[k] == kStale) rk[k] = rank_of(t, tk[k], nt);
    }
  }
  return n;
}

}  // namespace yttm_enc
