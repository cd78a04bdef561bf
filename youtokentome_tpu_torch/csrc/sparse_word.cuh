// The tombstoned word walk shared by the v3 trainer (train_sparse.cu
// sparse_apply) and its sharded engine (train_sparse_sharded.cu sparse_emit),
// over the v3 stream: t [M] whose positions never move, a merge writing z at
// the selected pair starts and PAD at their live partners; word k is
// t[off[k], off[k+1]), pw [M] the word of each position (-1 after the last
// word).
//
//   mark_live_words_kernel  pass 1 of sparse_apply: a thread a position; a
//                           live token equal to an accepted x walks to its
//                           next live neighbour inside the word and lists the
//                           word (ctl[CTL_OWN] counts them) on a hit
//   for_live_pairs          a warp walks a word's live pairs (run parity in
//                           live-rank space), 32 positions a chunk (the
//                           counts of the whole stream walk it flat:
//                           tomb_count.cuh)
//   merge_live_word         one warp a word of any length: the old pairs
//                           handed to a callback, hits selected by parity
//                           along runs of hits, z and PAD written in place
//   load_slots /            sparse_emit's flat walk: a lane takes 8 positions
//   claim_live_words        (two 16-byte loads of t) and one of the 32 before
//                           the warp's; each live token's left partner is the
//                           previous live token of the stream (live_before: a
//                           walk back over tombstones, only when those 32 are
//                           all tombstones and the warp's first live token is
//                           some candidate's y); a pair of tokens that the
//                           candidates' bitmap (word_apply.cuh) takes is
//                           checked for one word by pw, read only there, and
//                           its word claimed (the first claim of a round wins)
//   live_pack_merge         up to 32 slots of short claimed words side by
//                           side over a warp's lanes (for_word_packs, tail 0):
//                           each lane's slot merged in registers, the old and
//                           new counted pairs in live-rank space of the pack

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "train_common.cuh"
#include "word_apply.cuh"

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

// Merges the n accepted candidates c (Cands or CandSet) into the tombstoned
// word tw[0, len) in place: z at the selected pair starts, PAD at their live
// partners.  Before the merge, old(counted, key) is called at every position
// as for_live_pairs calls it (the word's old pairs).  Called by all 32 lanes.
template <class C, class Old>
__device__ void merge_live_word(int32_t *tw, int len, const C &c, int n, Old old) {
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

// -- sparse_emit's walk -----------------------------------------------------------

constexpr int kLaneSlots = 8;                // positions a lane takes a step
constexpr int kWarpSlots = 32 * kLaneSlots;  // a warp's

// The kLaneSlots positions of t from p (a multiple of 8; t 16-byte aligned),
// PAD from `end` on: two 16-byte loads.
__device__ __forceinline__ void load_slots(const int32_t *t, int p, int end,
                                           int32_t (&a)[kLaneSlots]) {
  if (p + kLaneSlots <= end) {
    const int4 u = *reinterpret_cast<const int4 *>(t + p);
    const int4 v = *reinterpret_cast<const int4 *>(t + p + 4);
    a[0] = u.x;
    a[1] = u.y;
    a[2] = u.z;
    a[3] = u.w;
    a[4] = v.x;
    a[5] = v.y;
    a[6] = v.z;
    a[7] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kLaneSlots; ++j) a[j] = p + j < end ? t[p + j] : kPad;
  }
}

// The last live token before position `from` in the word of position i
// (>= from) and its position (tok kPad: none): a walk back over the word's
// slots, 32 a step, never before its first.  Called by all 32 lanes.
__device__ inline void live_before(const int32_t *t, const int32_t *pw, const int32_t *off, int i,
                                   int from, int32_t &tok, int &pos) {
  tok = kPad;
  pos = -1;
  const int ws = off[pw[i]];
  const int lane = threadIdx.x & 31;
  for (int b = from - 32; b + 32 > ws; b -= 32) {
    const int j = b + lane;
    const int32_t a = j >= ws ? t[j] : kPad;
    const unsigned m = __ballot_sync(kFullMask, a >= 0);
    if (m) {
      const int hi = 31 - __clz(m);
      tok = __shfl_sync(kFullMask, a, hi);
      pos = b + hi;
      return;
    }
  }
}

// The warp's positions [p0, p0 + kWarpSlots) of t, a lane's kLaneSlots in
// a (load_slots), and the 32 before them, a lane's one in `back` (PAD
// before 0): the words they show to hold an accepted pair, by the pair's
// right token, that no warp took before this round (wmark keeps the round a
// word was last taken, `tag`): up to kLaneSlots word ids a lane in w, one bit
// each in the returned mask.  A live token's left partner is the previous
// live token of the stream: the warp's, or the last one of `back`, or,
// when those 32 positions are all tombstones, the last one before them in
// the word of the warp's first live token, walked back for only when that
// token is some candidate's y.  A pair of tokens that cand_of takes is a
// pair when pw puts both in one word (pw is read only there).  Called by all
// 32 lanes.
__device__ unsigned claim_live_words(const int32_t (&a)[kLaneSlots], int32_t back,
                                     const int32_t *t, const int32_t *pw, const int32_t *off,
                                     int p0, const CandSet &c, int n, int tag, int32_t *wmark,
                                     int32_t (&w)[kLaneSlots]) {
  const int lane = threadIdx.x & 31;
  const int p = p0 + kLaneSlots * lane;
  int32_t first = kPad, last = kPad;
  int first_at = -1, last_at = -1;
#pragma unroll
  for (int j = kLaneSlots - 1; j >= 0; --j)
    if (a[j] >= 0) {
      first = a[j];
      first_at = p + j;
    }
#pragma unroll
  for (int j = 0; j < kLaneSlots; ++j) {
    w[j] = -1;
    if (a[j] >= 0) {
      last = a[j];
      last_at = p + j;
    }
  }
  const unsigned has = __ballot_sync(kFullMask, first >= 0);
  if (!has) return 0u;
  // the left partner of the lane's first live token
  const unsigned lower = has & ((1u << lane) - 1u);
  const int src = lower ? 31 - __clz(lower) : 0;
  int32_t pa = __shfl_sync(kFullMask, last, src);
  int pp = __shfl_sync(kFullMask, last_at, src);
  int32_t carry = kPad;
  int carry_at = -1;
  const unsigned bm = __ballot_sync(kFullMask, back >= 0);
  if (bm) {
    const int hi = 31 - __clz(bm);
    carry = __shfl_sync(kFullMask, back, hi);
    carry_at = p0 - 32 + hi;
  } else {
    const int l0 = __ffs(has) - 1;
    const int32_t a0 = __shfl_sync(kFullMask, first, l0);
    bool is_y = false;
    for (int k = 0; k < n; ++k) is_y |= a0 == c.y[k];
    if (is_y) live_before(t, pw, off, __shfl_sync(kFullMask, first_at, l0), p0 - 32, carry, carry_at);
  }
  if (!lower) {
    pa = carry;
    pp = carry_at;
  }
  unsigned mine = 0u;
  int prev = -1;  // the word the lane took or saw taken last
#pragma unroll
  for (int j = 0; j < kLaneSlots; ++j) {
    if (a[j] < 0) continue;
    if (cand_of(c, n, pa, a[j]) >= 0) {
      const int wj = pw[p + j];
      if (wj == pw[pp] && wj != prev) {
        prev = wj;
        if (atomicExch(wmark + wj, tag) != tag) {
          w[j] = wj;
          mine |= 1u << j;
        }
      }
    }
    pa = a[j];
    pp = p + j;
  }
  return mine;
}

// One lane's slot of a pack of short claimed words (their slots side by side
// over the warp's lanes, as for_word_packs lays them with tail 0: words from
// lane `start` on, one bit a word in smask, `total` lanes in use), through
// the round's merge, all in registers: a live slot's left partner is the
// previous live slot of its word, run parity is taken over the live ranks of
// the pack (a word's first live token ends every run), a selected pair's
// right token drops and its left partner takes z.
struct LivePack {
  int32_t *t;                 // the lane's word
  int pos;                    // the lane's slot in it
  int32_t f;                  // the word's weight
  int32_t a, v;               // the slot's token before and after the merge
  bool co, cn;                // a counted pair of the old, the new word ends here
  unsigned long long ko, kn;  // its key
};

// live_pack_merge's view of the slot: every lane reads its slot before any
// lane writes (live_pack_write).  Called by all 32 lanes.
__device__ __forceinline__ LivePack live_pack_merge(int32_t *tok, int base, int len, int32_t f,
                                                    int start, int s, unsigned smask, int total,
                                                    const CandSet &c, int n) {
  LivePack p;
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
  const unsigned wm = valid ? (kl >= 32 ? 0xFFFFFFFFu : (1u << kl) - 1u) << ks : 0u;
  // the old word: counted pairs, hits, the merge
  const unsigned live = __ballot_sync(kFullMask, p.a >= 0);
  const unsigned lower = live & wm & lt;
  const int32_t pa = __shfl_sync(kFullMask, p.a, lower ? 31 - __clz(lower) : q);
  const bool pair = p.a >= 0 && lower;
  const bool eq = pair && pa == p.a;
  const int r = __popc(live & lt);  // the slot's live rank in the pack
  const int lne = warp_max_scan(p.a >= 0 && !eq ? r - 1 : -1);
  p.co = pair && (!eq || ((r - lne) & 1) == 0);
  p.ko = pair_key(pa, p.a);
  const int rix = pair ? cand_of(c, n, pa, p.a) : -1;
  const int lnh = warp_max_scan(p.a >= 0 && rix < 0 ? r - 1 : -1);
  const bool sel = rix >= 0 && ((r - lnh) & 1) == 0;
  const unsigned later = live & wm & ~upto;
  const int nx = later ? __ffs(later) - 1 : q;
  const bool sel_nx = __shfl_sync(kFullMask, sel, nx) && later;
  const int rix_nx = __shfl_sync(kFullMask, rix, nx);
  p.v = sel ? kPad : (p.a >= 0 && sel_nx ? c.z[rix_nx] : p.a);
  // the new word
  const unsigned nlive = __ballot_sync(kFullMask, p.v >= 0);
  const unsigned nlower = nlive & wm & lt;
  const int32_t npa = __shfl_sync(kFullMask, p.v, nlower ? 31 - __clz(nlower) : q);
  const bool npair = p.v >= 0 && nlower;
  const bool neq = npair && npa == p.v;
  const int nr = __popc(nlive & lt);
  const int nlne = warp_max_scan(p.v >= 0 && !neq ? nr - 1 : -1);
  p.cn = npair && (!neq || ((nr - nlne) & 1) == 0);
  p.kn = pair_key(npa, p.v);
  return p;
}

// The merged slot written in place.
__device__ __forceinline__ void live_pack_write(const LivePack &p) {
  __syncwarp();
  if (p.a != p.v) p.t[p.pos] = p.v;
}

}  // namespace yttm
