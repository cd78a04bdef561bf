// The word-laid apply shared by the v2 trainer (train_delta.cu apply_delta)
// and its sharded engine (train_delta_sharded.cu delta_emit), over the
// stream layout of train_delta.cu: word w owns tok[off[w], off[w+1]-1), live
// tokens first, PAD after them, one PAD separator at the end; and the
// candidate test that v5's apply (train_tiered.cu) shares.
//
//   CandSet / cand_of  the round's accepted pairs with a hashed bitmap of
//                      them in shared memory: one shared load and a bit test
//                      decide a pair, the compare with the candidates runs
//                      only when the bit is set (a compare with each of up to
//                      16 candidates at every position would make a walk
//                      over the stream issue-bound)
//   load_group /       a thread takes four positions of the stream (one
//   claim_words        16-byte load) and claims the words that hold an
//                      accepted pair there (the first claim of a round wins)
//   mark_words_kernel  pass 1 of delta_emit: the claimed words listed, a
//                      warp-aggregated atomic
//   merge_word         one warp a word of any length: merge (even offsets
//                      inside runs of hits), compact the word in place

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "train_common.cuh"

namespace yttm {

constexpr int kCandLog = 11;  // 2048 bits: 16 pairs set at most 16 of them
constexpr int kCandWords = (1 << kCandLog) / 32;

struct CandSet {
  int32_t x[kK], y[kK], z[kK];
  uint32_t bits[kCandWords];
};

__device__ __forceinline__ uint32_t cand_hash(int32_t a, int32_t b) {
  return (((uint32_t)a * 0x9E3779B1u) ^ (uint32_t)b) * 0x85EBCA77u >> (32 - kCandLog);
}

// Loads the round's accepted candidates and their bitmap; returns their
// number (every thread of the block calls it).
__device__ __forceinline__ int load_cand_set(CandSet &c, const int32_t *ctl, const int32_t *cand) {
  const int n = ctl[NACC];
  for (int i = threadIdx.x; i < kCandWords; i += blockDim.x) c.bits[i] = 0u;
  __syncthreads();
  if (threadIdx.x < n) {
    const int32_t x = cand[threadIdx.x * 4], y = cand[threadIdx.x * 4 + 1];
    c.x[threadIdx.x] = x;
    c.y[threadIdx.x] = y;
    c.z[threadIdx.x] = cand[threadIdx.x * 4 + 2];
    const uint32_t h = cand_hash(x, y);
    atomicOr(c.bits + (h >> 5), 1u << (h & 31));
  }
  __syncthreads();
  return n;
}

// The index j of the candidate (a, b) == (x[j], y[j]), or -1 (also for a
// PAD on either side).  The accepted pairs are distinct.
__device__ __forceinline__ int cand_of(const CandSet &c, int n, int32_t a, int32_t b) {
  if (a < 0 || b < 0) return -1;
  const uint32_t h = cand_hash(a, b);
  if (!((c.bits[h >> 5] >> (h & 31)) & 1u)) return -1;
  for (int j = 0; j < n; ++j)
    if (a == c.x[j] && b == c.y[j]) return j;
  return -1;
}

// The four positions from 4g of the stream and the token after them, PAD
// past its end: one 16-byte load (tok is 16-byte aligned) and one more.
__device__ __forceinline__ void load_group(const int32_t *tok, int Mw, int g, int32_t (&t)[5]) {
  const int i = 4 * g;
  if (i + 4 < Mw) {
    const int4 v = *reinterpret_cast<const int4 *>(tok + i);
    t[0] = v.x;
    t[1] = v.y;
    t[2] = v.z;
    t[3] = v.w;
    t[4] = tok[i + 4];
  } else {
#pragma unroll
    for (int k = 0; k < 5; ++k) t[k] = i + k < Mw ? tok[i + k] : kPad;
  }
}

// The words that the positions from 4g (t: load_group) show to hold an
// accepted pair and that no thread took before this round (wmark keeps the
// round a word was last taken, `tag`): up to four word ids in w, one bit
// each in the returned mask.
__device__ __forceinline__ unsigned claim_words(const int32_t (&t)[5], const int32_t *pwid, int Mw,
                                                int g, const CandSet &c, int n, int tag,
                                                int32_t *wmark, int32_t (&w)[4]) {
  const int i = 4 * g;
  unsigned mine = 0;
  int last = -1;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[k] = -1;
    if (i + k < Mw - 1 && cand_of(c, n, t[k], t[k + 1]) >= 0) {
      const int wk = pwid[i + k];
      if (wk != last) {
        last = wk;
        if (atomicExch(wmark + wk, tag) != tag) {
          w[k] = wk;
          mine |= 1u << k;
        }
      }
    }
  }
  return mine;
}

// The lanes' exclusive prefix sum of v, and its total (all 32 lanes).
__device__ __forceinline__ int warp_exclusive(int v, int &total) {
  const int lane = threadIdx.x & 31;
  int at = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFullMask, at, o);
    if (lane >= o) at += u;
  }
  total = __shfl_sync(kFullMask, at, 31);
  return at - v;
}

// Lists in aff (their number in ctl[NAFF]) the words of the stream that hold
// an accepted pair this round; a warp lists its new words with one atomic.
template <int NAFF>
__global__ void __launch_bounds__(256)
    mark_words_kernel(const int32_t *tok, const int32_t *pwid, int Mw, int32_t *ctl,
                      const int32_t *cand, int32_t *aff, int32_t *wmark) {
  __shared__ CandSet c;
  const int n = load_cand_set(c, ctl, cand);
  if (n == 0) return;
  const int tag = ctl[ROUND];
  const int lane = threadIdx.x & 31;
  const int n_grp = (Mw - 1 + 3) >> 2;
  // the warp's groups start together, so its votes stay converged
  for (int g0 = blockIdx.x * blockDim.x + (threadIdx.x & ~31); g0 < n_grp;
       g0 += gridDim.x * blockDim.x) {
    int32_t t[5], w[4];
    load_group(tok, Mw, g0 + lane, t);
    const unsigned mine = claim_words(t, pwid, Mw, g0 + lane, c, n, tag, wmark, w);
    int total;
    int at = warp_exclusive(__popc(mine), total);
    if (total == 0) continue;
    int base = 0;
    if (lane == 0) base = atomicAdd(ctl + NAFF, total);
    at += __shfl_sync(kFullMask, base, 0);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if ((mine >> k) & 1u) aff[at++] = w[k];
  }
}

// Merges the n accepted candidates c into the word t[0, len) (live tokens
// first, PAD after) and compacts it in place, PAD after the tokens left;
// returns their number.  Before the merge, old(counted, key, rix) is called
// at every position as for_word_pairs calls it (the word's old pairs), rix
// the candidate the pair is (-1 for none).  Called by all 32 lanes of a warp.
template <class Old>
__device__ int merge_word(int32_t *t, int len, const CandSet &c, int n, Old old) {
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
    const int rix = cand_of(c, n, a, nb);
    old(pairv && (!eq || ((i - lne - 1) & 1) == 0), pair_key(a, nb), rix);
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

// -- relay: the stream laid out again over its live tokens ------------------

// Per word: its new slot count (live + 1, or 0 when it holds fewer than
// min_live live tokens) and whether it is kept.
__global__ void __launch_bounds__(256)
    relay_len_kernel(const int32_t *tok, const int32_t *off, int W, int32_t *lens, int32_t *keep,
                     int min_live) {
  for (int w = blockIdx.x * blockDim.x + threadIdx.x; w < W; w += gridDim.x * blockDim.x) {
    const int end = off[w + 1] - 1;
    int i = off[w];
    while (i < end && tok[i] >= 0) ++i;
    const int live = i - off[w];
    lens[w] = live >= min_live ? live + 1 : 0;
    keep[w] = live >= min_live;
  }
}

// One warp a kept word copies its live tokens to their new slots (wids and
// wids2 may be null: the word ids stay where every word is kept).
__global__ void __launch_bounds__(256)
    relay_write_kernel(const int32_t *tok, const int32_t *off, const int32_t *fw,
                       const int32_t *wids, int W, const int32_t *lens, const int32_t *new_off,
                       const int32_t *new_idx, int32_t *tok2, int32_t *pwid2, int32_t *off2,
                       int32_t *fw2, int32_t *wids2, int W2, int Mw2) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  if (blockIdx.x == 0 && threadIdx.x == 0) off2[W2] = Mw2;
  for (int w = warp; w < W; w += n_warps) {
    const int n = lens[w];
    if (n == 0) continue;
    const int k = new_idx[w], src = off[w], dst = new_off[w];
    for (int i = lane; i < n; i += 32) {
      tok2[dst + i] = i < n - 1 ? tok[src + i] : kPad;
      pwid2[dst + i] = i < n - 1 ? k : kPad;
    }
    if (lane == 0) {
      off2[k] = dst;
      fw2[k] = fw[w];
      if (wids2) wids2[k] = wids[w];
    }
  }
}

// A mark_words_kernel launch over a stream of Mw slots; tok is 16-byte
// aligned (the caller checks).
template <int NAFF>
inline void launch_mark_words(const int32_t *tok, const int32_t *pwid, int Mw, int32_t *ctl,
                              const int32_t *cand, int32_t *aff, int32_t *wmark,
                              cudaStream_t s) {
  const int grid = grid_for_warps(((Mw - 1 + 3) / 4 + 31) / 32);
  mark_words_kernel<NAFF><<<grid, 256, 0, s>>>(tok, pwid, Mw, ctl, cand, aff, wmark);
}

}  // namespace yttm
