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
//   for_word_packs /   up to 32 claimed words on a warp: short words packed
//   pack_merge         side by side into the 32 lanes (words hold ~8 slots),
//                      each lane's slot merged in registers; a word longer
//                      than 32 slots takes the warp alone (merge_word)
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

// One lane's slot of a pack of short claimed words (their slots side by
// side over the warp's lanes: words lie in the pack from lane `start` on,
// one bit a word in smask, `total` lanes in use), through the round's merge:
// the old word's pair at the slot and the new word's, all in registers.
struct PackLane {
  int32_t *t;       // the lane's word
  int pos;          // the lane's slot in it
  int32_t f;        // the word's weight
  int32_t a, nb;    // the slot's token and the word's next one (PAD at its end)
  bool co;          // (a, nb) is a counted pair of the old word (run parity)
  int rix;          // the candidate (a, nb) is, or -1
  bool sel, sel_next, keep;  // merged here; merged at the next slot; a token kept
  int32_t v;        // the kept token (z where merged)
  int rank, kept;   // its slot in the new word; the new word's tokens
  int32_t nbn;      // the new word's next token (PAD: none)
  bool cn;          // (v, nbn) is a counted pair of the new word
};

// pack_merge's view of the slot: every lane reads its slot before any lane
// writes (pack_write).  Run parity is taken inside a word: a word's last
// slot pairs with PAD, which ends every run.  Called by all 32 lanes.
__device__ __forceinline__ PackLane pack_merge(int32_t *tok, int base, int len, int32_t f,
                                               int start, int s, unsigned smask, int total,
                                               const CandSet &c, int n) {
  PackLane p;
  const int q = threadIdx.x & 31;
  const bool valid = q < total;
  const unsigned upto = (2u << q) - 1u;  // lanes 0..q
  const unsigned lt = (1u << q) - 1u;
  const int k = valid ? s + __popc(smask & upto) - 1 : s;  // this lane's word
  const int kb = __shfl_sync(kFullMask, base, k), ks = __shfl_sync(kFullMask, start, k);
  const int kl = __shfl_sync(kFullMask, len, k);
  p.f = __shfl_sync(kFullMask, f, k);
  p.pos = q - ks;
  p.t = tok + kb;
  p.a = valid ? p.t[p.pos] : kPad;
  const int32_t down = __shfl_down_sync(kFullMask, p.a, 1);
  const bool word_end = !valid || q == 31 || q + 1 >= total || ((smask >> (q + 1)) & 1u);
  p.nb = word_end ? kPad : down;
  // the old word: counted pairs (run parity), hits, the merge
  const bool pairv = p.a >= 0 && p.nb >= 0;
  const bool eq = pairv && p.a == p.nb;
  const int lne = warp_max_scan(eq ? -1 : q);
  p.co = pairv && (!eq || ((q - lne - 1) & 1) == 0);
  p.rix = cand_of(c, n, p.a, p.nb);
  const int lnh = warp_max_scan(p.rix >= 0 ? -1 : q);
  p.sel = p.rix >= 0 && ((q - lnh - 1) & 1) == 0;
  const bool prev_sel = __shfl_up_sync(kFullMask, p.sel, 1) && q > 0;
  p.sel_next = __shfl_down_sync(kFullMask, p.sel, 1);
  p.keep = p.a >= 0 && !prev_sel;
  p.v = p.sel ? c.z[p.rix] : p.a;
  // the new word: each kept token's successor is the next kept one of its word
  const unsigned kmask = __ballot_sync(kFullMask, p.keep);
  const unsigned wm = (kl >= 32 ? 0xFFFFFFFFu : (1u << kl) - 1u) << ks;
  p.rank = __popc(kmask & wm & lt);
  p.kept = __popc(kmask & wm);
  const unsigned later = kmask & wm & ~upto;
  const int32_t vn = __shfl_sync(kFullMask, p.v, later ? __ffs(later) - 1 : q);
  p.nbn = p.keep && later ? vn : kPad;
  const bool eqn = p.nbn >= 0 && p.v == p.nbn;
  const int r = __popc(kmask & lt);
  const int lnen = warp_max_scan(p.keep && !eqn ? r : -1);
  p.cn = p.nbn >= 0 && (!eqn || ((r - lnen - 1) & 1) == 0);
  return p;
}

// The merged word compacted in place, PAD after its tokens.
__device__ __forceinline__ void pack_write(const PackLane &p) {
  if (p.keep && (p.rank != p.pos || p.v != p.a)) p.t[p.rank] = p.v;
  if (p.a >= 0 && p.pos >= p.kept) p.t[p.pos] = kPad;
}

// Up to 32 claimed words, lane j holding word w (-1 past cnt), on the
// warp: short words packed side by side into the 32 lanes, pack(base, len,
// f, start, s, smask, total) for each pack (pack_merge's arguments), and
// long_word(t, len, f) for a word longer than 32 slots, on the whole warp.
// Word w's slots are tok[off[w], off[w+1] - tail): tail 1 for the stream's
// PAD separator (v2), 0 for v3's words laid end to end (sparse_word.cuh).
// Called by all 32 lanes.
template <class Pack, class Long>
__device__ __forceinline__ void for_word_packs(int w, int cnt, int32_t *tok, const int32_t *off,
                                               const int32_t *fw, int tail, Pack pack,
                                               Long long_word) {
  const int lane = threadIdx.x & 31;
  int base = 0, len = 0;
  int32_t f = 0;
  if (lane < cnt) {
    base = off[w];
    len = off[w + 1] - tail - base;
    f = fw[w];
  }
  int end = len;  // inclusive prefix of the lengths
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFullMask, end, o);
    if (lane >= o) end += u;
  }
  for (int s = 0; s < cnt;) {
    const int ls = __shfl_sync(kFullMask, len, s);
    if (ls > 32) {
      long_word(tok + __shfl_sync(kFullMask, base, s), ls, __shfl_sync(kFullMask, f, s));
      ++s;
      continue;
    }
    const int before = s > 0 ? __shfl_sync(kFullMask, end, s > 0 ? s - 1 : 0) : 0;
    const bool in = lane >= s && lane < cnt && end - before <= 32;
    const int e = 31 - __clz(__ballot_sync(kFullMask, in));
    const int start = end - len - before;
    const unsigned smask = __reduce_or_sync(kFullMask, in ? 1u << start : 0u);
    pack(base, len, f, start, s, smask, __shfl_sync(kFullMask, end, e) - before);
    s = e + 1;
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

}  // namespace yttm
