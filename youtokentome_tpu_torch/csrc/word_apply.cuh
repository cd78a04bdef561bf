// The word-laid apply shared by the v2 trainer (train_delta.cu apply_delta)
// and its sharded engine (train_delta_sharded.cu delta_emit), over the
// stream layout of train_delta.cu: word w owns tok[off[w], off[w+1]-1), live
// tokens first, PAD after them, one PAD separator at the end.
//
//   mark_words_kernel  pass 1: threads walk the stream's positions, mark the
//                      words holding an accepted pair and list them
//   merge_word         pass 2, one warp a listed word: merge (even offsets
//                      inside runs of hits), compact the word in place

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "train_common.cuh"

namespace yttm {

// Lists in aff (their number in ctl[NAFF]) the words of the stream that hold
// an accepted pair this round; wmark keeps the round a word was last listed.
template <int NAFF>
__global__ void __launch_bounds__(256)
    mark_words_kernel(const int32_t *tok, const int32_t *pwid, int Mw, int32_t *ctl,
                      const int32_t *cand, int32_t *aff, int32_t *wmark) {
  __shared__ int32_t sx[kK], sy[kK];
  const int n = ctl[NACC];
  if (n == 0) return;
  if (threadIdx.x < n) {
    sx[threadIdx.x] = cand[threadIdx.x * 4];
    sy[threadIdx.x] = cand[threadIdx.x * 4 + 1];
  }
  __syncthreads();
  const int tag = ctl[ROUND];
  // a grid of a few blocks per SM walks the stream: the prologue above
  // (two dependent loads and a barrier) runs once per block, not once per
  // 256 positions
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < Mw - 1; i += gridDim.x * blockDim.x) {
    const int32_t a = tok[i];
    const int32_t b = tok[i + 1];
    if (a < 0 || b < 0) continue;
    bool hit = false;
    for (int j = 0; j < n; ++j) hit |= a == sx[j] && b == sy[j];
    if (!hit) continue;
    const int w = pwid[i];
    if (atomicExch(wmark + w, tag) != tag) aff[atomicAdd(ctl + NAFF, 1)] = w;
  }
}

// Merges the n accepted candidates c into the word t[0, len) (live tokens
// first, PAD after) and compacts it in place, PAD after the tokens left;
// returns their number.  Before the merge, old(counted, key) is called at
// every position as for_word_pairs calls it (the word's old pairs).  Called
// by all 32 lanes of a warp.
template <class Old>
__device__ int merge_word(int32_t *t, int len, const Cands &c, int n, Old old) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  int carry_eq = -1, carry_hit = -1, out = 0;
  bool carry_sel = false;
  // all lanes read a chunk (and the next chunk's first token) before any
  // lane writes, and writes land at or before the positions read
  for (int b = 0; b < len; b += 32) {
    const int i = b + lane;
    const int32_t a = i < len ? t[i] : kPad;
    const int32_t nb = i + 1 < len ? t[i + 1] : kPad;
    const bool pairv = a >= 0 && nb >= 0;
    const bool eq = pairv && a == nb;
    int lne = warp_max_scan(eq ? -1 : i);
    lne = lne > carry_eq ? lne : carry_eq;
    old(pairv && (!eq || ((i - lne - 1) & 1) == 0), pair_key(a, nb));
    int rix = -1;
    if (pairv)
      for (int j = 0; j < n; ++j)
        if (rix < 0 && a == c.x[j] && nb == c.y[j]) rix = j;
    const bool hit = rix >= 0;
    int lnh = warp_max_scan(hit ? -1 : i);
    lnh = lnh > carry_hit ? lnh : carry_hit;
    const bool sel = hit && ((i - lnh - 1) & 1) == 0;
    bool prev_sel = __shfl_up_sync(0xFFFFFFFFu, sel, 1);
    if (lane == 0) prev_sel = carry_sel;
    const bool keep = a >= 0 && !prev_sel;
    const unsigned kmask = __ballot_sync(0xFFFFFFFFu, keep);
    __syncwarp();
    if (keep) t[out + __popc(kmask & lt)] = sel ? c.z[rix] : a;
    __syncwarp();
    out += __popc(kmask);
    carry_eq = __shfl_sync(0xFFFFFFFFu, lne, 31);
    carry_hit = __shfl_sync(0xFFFFFFFFu, lnh, 31);
    carry_sel = __shfl_sync(0xFFFFFFFFu, sel, 31);
  }
  for (int i = out + lane; i < len; i += 32) t[i] = kPad;
  __syncwarp();
  return out;
}

}  // namespace yttm
