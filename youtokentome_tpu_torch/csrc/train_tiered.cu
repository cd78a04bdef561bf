// The v5 tiered trainer's merge round, on Hopper: four kernels.
//
// Replaces the JAX device programs
//   youtokentome_tpu/ops/train_tiered.py:193 train_rounds_tiered
//   youtokentome_tpu/ops/train_tiered.py:485 _fold_check, :496 _fold_rows
// and what they run each round: sig_prefilter, the tier_mini/tier_full
// cascade (pair_hits, _apply_rowwise, _mini_contribs, sig_build), fold_full,
// update_full/_resplit, update_incremental and _reduce_by_key_signed.  The
// plain torch versions of the kernels are in
// youtokentome_tpu_torch/ops/tiered_kernels.py.
//
// The TPU program keeps a frozen cold table and a pending buffer and gathers
// affected blocks into static [KB, B] mini streams, because it cannot
// scatter into a table without a sort and needs static shapes.  A card needs
// neither.  The state here (all on the card):
//   tok, wid [NB*B] int32   the block stream: row r is tok[r*B, (r+1)*B),
//                           whole words, live tokens first, PAD after them
//   sig [NB, 16] uint32     512-bit token presence signature of each row
//   keys/cnts [cap]         the FULL pair-count table, exact after every
//                           round: open addressing, key x << 32 | y, atomic
//                           counts, a key keeps its slot at count 0 until a
//                           rebuild (as in train_delta.cu)
//   hkeys/hcnts [hslots]    the HOT table: every key whose count exceeds T,
//                           exact, plus keys made this round; hslots = 2*hcap
//   ctl [24] int32          round control (enum below)
//
// Hot-tier membership.  A round's deltas go into the full table always, and
// into the hot table only when the key is already there or holds one of this
// round's z ids.  An existing pair's count never increases (train_tiered.py
// module note), so a key missing from the hot table is a key whose count was
// <= T at the last resplit and has only fallen since; inserting it would plant
// a partial count.  A key with a new z did not exist before this round.
// Hence every key with count > T is in the hot table with its exact count, and
// while the hot top count exceeds T, the hot top-16 with the floor T accepts
// exactly what the full table would.
//
// Kernels (one wrapper each in tiered_kernels.py):
//   tier_select   top-16 of the hot table; when its top count is <= T or the
//                 hot table overflowed, a refresh round: top-16 of the full
//                 table with no floor.  accept_prefix + store_rules.  Two
//                 launches a round (see its section).
//   apply_blocks  two launches a round (its section below): every row's
//                 signature tested against the accepted pairs (NBAFF counts
//                 the rows that may hold one) and the rows that do hold one
//                 listed; those merged (run parity per word; pairs never
//                 cross a word: wid equality guards every pair) and
//                 front-compacted in order, both tables moved by the net
//                 deltas of the words with a hit, the rows' signatures
//                 rebuilt, the round's stats counted by the last block.  In
//                 count mode (start, rebuild: tier_count_kernel) every
//                 row's pairs go into an empty full table.
//   resplit       after a refresh round: T = the count at rank hcap/2 of the
//                 full table (radix select, 3 passes of 11/11/10 bits over
//                 the whole grid, the last block of each picks the bin; 0
//                 with fewer live keys), then the hot table is rebuilt from
//                 every key with count > T.
//   fold_rows     row fills, a stable counting sort of the rows by fill, the
//                 pair check (emptiest with fullest fits a row), and the fold:
//                 row i = concat(row order[NB-1-i], row order[i]), compacted,
//                 with its signature; the row order equals the JAX fold's.
//
// Every kernel does nothing once `done` or `overflow` is set or `used`
// reached min(vocab, limit), so the host enqueues rounds in batches and
// reads ctl once per batch.
//
// Bound.  A hot round reads the hot table's counts (4 B a slot, 2^17 slots at
// the 100 MB point) and the live keys, every row's signature (64 B), and the
// listed rows and the table entries their words touch; a refresh round reads
// the full table as well.  What the design does about it: the per-round table
// work is the hot table's, not the full table's (train_delta.cu scans all of
// it each round), and the stream work is a signature read a row plus the rows
// that may hold a hit.  On the H100 the apply is held back by latency, not
// bytes: the chain of dependent loads of a listed row, its words' weights
// and its table probes, and the first rounds' same-key atomics;
// apply_blocks' section says what its design does about it.

#include <cstdint>
#include <cuda_runtime.h>

#include "train_common.cuh"
#include "word_apply.cuh"

namespace {

using namespace yttm;

enum {
  USED = 0, DONE, OVERFLOW, ROUND, NACC, NBAFF, OCC, ERROR,
  REFRESH,   // this round selects from the full table
  HOT_OVF,   // the hot table overflowed (or was never built): refresh next
  HOCC,      // claimed hot slots
  THRESH,    // T
  ZLO,       // the first z id of this round
  ACTIVE,    // this round ran (cleared by the round's stats)
  ST_ROUNDS, ST_REFRESH, ST_MID, ST_FULL,
  LIVE,      // fold plan: live tokens
  FOLD_MAX,  // fold plan: the largest fill of a row pair
  CTL_N = 24
};

constexpr int kSigW = 16;
constexpr int kMaxB = 512;

__device__ __forceinline__ int sig_pos(int32_t tok) {
  return (int)(((uint32_t)tok * 2654435761u) >> 23) & 511;
}

__device__ __forceinline__ bool resplit_due(const int32_t *ctl) {
  return ctl[REFRESH] && ctl[NACC] > 0 && !ctl[OVERFLOW];
}

// Hot-table update: a present key adds `delta`; a missing key is claimed
// only when `insert` (it holds this round's z).  Overflow past half the
// slots sets HOT_OVF, which makes the next round a refresh round.
__device__ void hot_add(unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl,
                        unsigned long long key, int32_t delta, bool insert) {
  const unsigned mask = (unsigned)cap - 1u;
  const unsigned h = (unsigned)hash64(key) & mask;
  for (int p = 0; p < cap; ++p) {
    const unsigned s = (h + (unsigned)p) & mask;
    unsigned long long k = __ldcg(keys + s);
    if (k == kEmpty) {
      if (!insert) return;
      k = atomicCAS(keys + s, kEmpty, key);
      if (k == kEmpty) {
        const int occ = atomicAdd(ctl + HOCC, 1) + 1;
        if (2ll * occ > (long long)cap) atomicExch(ctl + HOT_OVF, 1);
        atomicAdd(cnts + s, delta);
        return;
      }
    }
    if (k == key) {
      atomicAdd(cnts + s, delta);
      return;
    }
  }
  atomicExch(ctl + HOT_OVF, 1);
}

// -- tier_select -------------------------------------------------------------
//
// Two launches a round (four before): tier_hot ranks the hot table and
// accepts from it, or marks a refresh round; tier_full ranks the full table
// on a refresh round and returns at once on a hot round.  Both are
// grid_topk (train_common.cuh) with the acceptance in the last block.
//
// Bound.  A hot round reads the hot table's counts (2^17 slots at the 100 MB
// point: 0.5 MB) and the keys of its slots whose count reaches the 16th
// largest, ~0.2 us a round at 3.35 TB/s (PERF.md row 6a sums it over the
// run's rounds); a refresh round reads the full table's as well.  The old
// design took ~75 us a round (torch.profiler, H100 80GB HBM3, 700 W:
// hot_blocks 42 us, hot_select 25 us): four launches, two of them a single block merging up to 4096
// entries, 32 blocks of 128 threads on the hot table, and lists of 16 whose
// keys loaded one insert at a time.  The new one is train_common.cuh's
// top-k section, on 128 blocks of 256 threads for the hot table (one per
// 1024 slots), with the merge of the block lists and the acceptance in the
// last block of the same launch.

__global__ void __launch_bounds__(kSelThreads, 2)
    tier_hot_kernel(const unsigned long long *hkeys, const int32_t *hcnts, int hslots,
                    unsigned long long *blk_hi, uint32_t *blk_lo, unsigned *ticket, int32_t *ctl,
                    int32_t *cand, int32_t *rules, int limit, int vocab, int used_ids0, int k,
                    bool wide) {
  __shared__ int top_c[kK];
  __shared__ unsigned long long top_k[kK];
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  // every block reads the round control before it takes its ticket; only
  // block 0's lead (on the early exits, slots no block reads) and the last
  // block write it
  if (!round_active(ctl, limit, vocab)) {
    if (lead) {
      ctl[NACC] = 0;
      ctl[ACTIVE] = 0;
      ctl[REFRESH] = 0;
    }
    return;
  }
  if (ctl[HOT_OVF]) {  // a refresh round, whatever the hot table holds
    if (lead) {
      ctl[ACTIVE] = 1;
      ctl[REFRESH] = 1;
      ctl[NACC] = 0;
    }
    return;
  }
  const int used = ctl[USED], T = ctl[THRESH];  // loaded now, used by the last block
  if (!grid_topk<kK>(hkeys, hcnts, hslots, wide, blk_hi, blk_lo, ticket, top_c, top_k)) return;
  if (threadIdx.x >= 32) return;
  if (top_c[0] <= T) {
    if (threadIdx.x == 0) {
      ctl[ACTIVE] = 1;
      ctl[REFRESH] = 1;
      ctl[NACC] = 0;
    }
    return;
  }
  const int n_acc = accept_prefix_warp(top_c, top_k, k, used, vocab, T, cand, rules, used_ids0);
  if (threadIdx.x != 0) return;
  ctl[ACTIVE] = 1;
  ctl[REFRESH] = 0;
  ctl[USED] = used + n_acc;
  ctl[NACC] = n_acc;
  atomicAdd(ctl + ROUND, 1);
  ctl[NBAFF] = 0;
  ctl[ZLO] = used;
}

__global__ void __launch_bounds__(kSelThreads, 2)
    tier_full_kernel(const unsigned long long *keys, const int32_t *cnts, int cap,
                     unsigned long long *blk_hi, uint32_t *blk_lo, unsigned *ticket, int32_t *ctl,
                     int32_t *cand, int32_t *rules, int vocab, int used_ids0, int k, bool wide) {
  __shared__ int top_c[kK];
  __shared__ unsigned long long top_k[kK];
  if (!ctl[ACTIVE] || !ctl[REFRESH]) return;
  const int used = ctl[USED];  // loaded now, used by the last block
  if (!grid_topk<kK>(keys, cnts, cap, wide, blk_hi, blk_lo, ticket, top_c, top_k)) return;
  if (threadIdx.x >= 32) return;
  const int n_acc = accept_prefix_warp(top_c, top_k, k, used, vocab, 0, cand, rules, used_ids0);
  if (threadIdx.x != 0) return;
  ctl[USED] = used + n_acc;
  ctl[NACC] = n_acc;
  ctl[DONE] = n_acc == 0;
  atomicAdd(ctl + ROUND, 1);
  ctl[NBAFF] = 0;
  ctl[ZLO] = used;
}

// -- apply_blocks ------------------------------------------------------------
//
// Two launches a round (three before: the filter, the apply, and a
// one-thread launch for the stats), each a wave of the blocks the card
// holds at once, 64 registers a thread:
//  * tier_find_kernel: a warp's 32 rows at a time, their signatures staged
//    in shared memory by four 16-byte loads a lane in flight together, the
//    test of sig_prefilter on 2 rows x 16 candidates over the lanes (NBAFF
//    summed a block: same-address atomics serialise); the
//    listed rows' tokens (their loads in flight together) and the
//    candidate test (word_apply.cuh cand_of: one shared load and a bit a
//    pair).  Once the first rounds are past most listed rows hold no
//    candidate pair (the signature says only that both ids occur); the
//    ones that do are listed for the second launch;
//  * tier_apply_kernel: the listed rows spread evenly over the warps (a
//    warp that meets several of them in turn would hold the round back:
//    each is a chain of dependent loads), merge_row on each: its word ids
//    and weights, the words that hold a hit, the merge and the row's front
//    compaction into the warp's scratch, the new pairs and the signature,
//    the changed slots written back.  Only the words with a hit move the
//    tables, by their net deltas (a pair that survives the merge moves only
//    when run parity changed its count: see apply_pack in
//    train_delta.cu); a lane's two updates load their first probes in both
//    tables together; the candidates' own keys are summed in shared memory
//    and sent once a block.  The tables stay exact after the round, and
//    the hot table claims exactly the keys holding a z, as when every old
//    pair was subtracted and every new one added.  The last block to take
//    a ticket counts the round's stats.

constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;

// A warp's scratch for a row (dynamic shared memory, B slots): the compacted
// row t2/w2, wa (by word start: the word holds a hit), so (by new position:
// 0 or 1, an old pair that survives with that old count; 2, a new pair of a
// word with a hit; 3, a word without one) and the new signature.
__host__ __device__ inline int row_scratch_bytes(int B) { return (10 * B + 4 * kSigW + 15) & ~15; }

struct RowScratch {
  int32_t *t2, *w2;
  uint32_t *sig;
  uint8_t *wa, *so;
  __device__ RowScratch(unsigned char *p, int B)
      : t2((int32_t *)p), w2(t2 + B), sig((uint32_t *)(w2 + B)), wa((uint8_t *)(sig + kSigW)),
        so(wa + B) {}
};

// A row's signature in the find kernel's shared memory: kSigW + 1 words, so
// that the lanes' rows fall in distinct banks.
constexpr int kSigPitch = kSigW + 1;

// Token (or word id) v of the slot after each lane's, in chunk c of the
// row held as v[P] (chunk c: slots 32c..32c+31): lane 31 takes the next
// chunk's first, `end` past the row.
template <int P>
__device__ __forceinline__ int32_t next_slot(const int32_t (&v)[P], int c, int32_t end) {
  int32_t head = end;
  if (c + 1 < P) head = __shfl_sync(kFullMask, v[c + 1 < P ? c + 1 : c], 0);
  const int32_t d = __shfl_down_sync(kFullMask, v[c], 1);
  return (threadIdx.x & 31) == 31 ? head : d;
}

// One update of both tables, its first probes loaded ahead (probe_first):
// the full table by delta (kAdd or kSub by its sign), the hot table only when
// hot, claiming a slot only when `insert` (the key holds one of this round's
// ids).
struct Move {
  unsigned long long key;
  int32_t delta;
  bool insert;
  Probe full, hot;
};

__device__ __forceinline__ void move_probe(Move &m, const unsigned long long *keys, int cap,
                                           const unsigned long long *hkeys, int hslots, bool hot) {
  if (!m.delta) return;
  m.full = probe_first(keys, cap, m.key);
  if (hot) m.hot = probe_first(hkeys, hslots, m.key);
}

__device__ __forceinline__ void move_apply(const Move &m, unsigned long long *keys, int32_t *cnts,
                                           int cap, unsigned long long *hkeys, int32_t *hcnts,
                                           int hslots, int32_t *ctl, bool hot) {
  if (!m.delta) return;
  table_add_from<OCC, OVERFLOW, ERROR>(keys, cnts, cap, ctl, m.key, m.delta,
                                       m.delta > 0 ? kAdd : kSub, m.full);
  if (!hot) return;
  if (m.hot.k == m.key) atomicAdd(hcnts + m.hot.s, m.delta);
  else hot_add(hkeys, hcnts, hslots, ctl, m.key, m.delta, m.insert);
}

// Row r's tokens (or word ids), B / 32 a lane (chunk k: slots 32k..32k+31),
// `pad` past B.
template <int P>
__device__ __forceinline__ void load_row(int r, int B, const int32_t *src, int32_t pad,
                                         int32_t (&v)[P]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < P; ++k) v[k] = k * 32 + lane < B ? src[(size_t)r * B + k * 32 + lane] : pad;
}

// Some pair of row r's tokens t is an accepted pair, word boundaries aside
// (all 32 lanes of a warp).
template <int P>
__device__ __forceinline__ bool row_has_cand(const int32_t (&t)[P], const CandSet &c, int n) {
  bool any = false;
#pragma unroll
  for (int k = 0; k < P; ++k) any |= cand_of(c, n, t[k], next_slot(t, k, kPad)) >= 0;
  return __any_sync(kFullMask, any);
}

// The round's apply of row r, which holds a candidate pair (all 32 lanes of
// a warp).  A lane's updates of the tables (one for its old pair, one at its new
// position) wait to the end, so that their first probes load together.
template <int P>
__device__ void merge_row(int r, int B, int32_t *tok, int32_t *wid,
                                       const int32_t *freq, uint32_t *sig, const CandSet &c,
                                       int n, int32_t *acc, RowScratch rs,
                                       unsigned long long *keys, int32_t *cnts, int cap,
                                       unsigned long long *hkeys, int32_t *hcnts, int hslots,
                                       int32_t *ctl, bool hot, int zlo) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  int32_t *trow = tok + (size_t)r * B, *wrow = wid + (size_t)r * B;
  int32_t t[P], w[P];
  load_row<P>(r, B, tok, kPad, t);
  load_row<P>(r, B, wid, -1, w);
  for (int i = lane; i < B; i += 32) rs.wa[i] = 0;
  __syncwarp();
  // hits (pairs never cross a word), word starts, the words with a hit
  int32_t nb[P], f[P];
  int ws[P], rix[P];
  int carry = -1;
  int32_t wprev = -2;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = k * 32 + lane;
    f[k] = w[k] >= 0 ? freq[w[k]] : 0;
    const int32_t wn = next_slot(w, k, -2), tn = next_slot(t, k, kPad);
    int32_t wp = __shfl_up_sync(kFullMask, w[k], 1);
    if (lane == 0) wp = wprev;
    wprev = __shfl_sync(kFullMask, w[k], 31);
    int s = warp_max_scan(i < B && wp != w[k] ? i : -1);
    ws[k] = s = s > carry ? s : carry;
    carry = __shfl_sync(kFullMask, s, 31);
    nb[k] = i + 1 < B && wn == w[k] ? tn : kPad;
    rix[k] = cand_of(c, n, t[k], nb[k]);
    if (rix[k] >= 0) rs.wa[s] = 1;
  }
  // the merge: even offsets inside runs of hits
  bool sel[P];
  carry = -1;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = k * 32 + lane;
    int lnh = warp_max_scan(rix[k] >= 0 ? -1 : i);
    lnh = lnh > carry ? lnh : carry;
    sel[k] = rix[k] >= 0 && ((i - lnh - 1) & 1) == 0;
    carry = __shfl_sync(kFullMask, lnh, 31);
  }
  __syncwarp();
  // old pairs of the words with a hit, front compaction into the scratch
  Move old[P], fresh[P];
  carry = -1;
  bool carry_sel = false;
  int out = 0;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = k * 32 + lane;
    const int32_t a = t[k];
    const bool aff = a >= 0 && rs.wa[ws[k]];
    const bool pairv = a >= 0 && nb[k] >= 0;
    const bool eq = pairv && a == nb[k];
    int lne = warp_max_scan(eq ? -1 : i);
    lne = lne > carry ? lne : carry;
    carry = __shfl_sync(kFullMask, lne, 31);
    const bool co = pairv && (!eq || ((i - lne - 1) & 1) == 0);
    bool prev_sel = __shfl_up_sync(kFullMask, sel[k], 1);
    if (lane == 0) prev_sel = carry_sel;
    carry_sel = __shfl_sync(kFullMask, sel[k], 31);
    bool sel_next = __shfl_down_sync(kFullMask, sel[k], 1);
    if (k + 1 < P) {
      const bool h = __shfl_sync(kFullMask, sel[k + 1 < P ? k + 1 : k], 0);
      if (lane == 31) sel_next = h;
    }
    const bool keep = a >= 0 && !prev_sel;
    const bool same = keep && !sel[k] && nb[k] >= 0 && !sel_next;
    const bool out_pair = aff && co && !same;
    if (out_pair && rix[k] >= 0) atomicAdd(acc + rix[k], f[k]);
    old[k] = Move{pair_key(a, nb[k]), out_pair && rix[k] < 0 ? -f[k] : 0, false, {}, {}};
    const unsigned kmask = __ballot_sync(kFullMask, keep);
    if (keep) {
      const int o = out + __popc(kmask & lt);
      rs.t2[o] = sel[k] ? c.z[rix[k]] : a;
      rs.w2[o] = w[k];
      rs.so[o] = aff ? (same ? (uint8_t)co : 2) : 3;
    }
    out += __popc(kmask);
  }
  for (int i = out + lane; i < B; i += 32) {
    rs.t2[i] = kPad;
    rs.w2[i] = -1;
    rs.so[i] = 3;
  }
  if (lane < kSigW) rs.sig[lane] = 0u;
  __syncwarp();
  // new pairs of the words with a hit, the signature, the changed slots back
  carry = -1;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = k * 32 + lane;
    const int32_t a = i < B ? rs.t2[i] : kPad, wv = i < B ? rs.w2[i] : -1;
    const int32_t b = i + 1 < B && rs.w2[i + 1] == wv ? rs.t2[i + 1] : kPad;
    const bool pairv = a >= 0 && b >= 0;
    const bool eq = pairv && a == b;
    int lne = warp_max_scan(eq ? -1 : i);
    lne = lne > carry ? lne : carry;
    carry = __shfl_sync(kFullMask, lne, 31);
    const int cn = pairv && (!eq || ((i - lne - 1) & 1) == 0);
    const int s = i < B ? rs.so[i] : 3;
    // a surviving pair moves by its change of count; a new one comes in
    const int d = s <= 1 ? cn - s : (s == 2 ? cn : 0);
    fresh[k] = Move{pair_key(a, b), d ? d * freq[wv] : 0, s == 2 && (a >= zlo || b >= zlo), {}, {}};
    if (a >= 0) {
      const int p = sig_pos(a);
      atomicOr(rs.sig + (p >> 5), 1u << (p & 31));
    }
    if (i < B && (a != t[k] || wv != w[k])) {
      trow[i] = a;
      wrow[i] = wv;
    }
  }
#pragma unroll
  for (int k = 0; k < P; ++k) {
    move_probe(old[k], keys, cap, hkeys, hslots, hot);
    move_probe(fresh[k], keys, cap, hkeys, hslots, hot);
  }
#pragma unroll
  for (int k = 0; k < P; ++k) {
    move_apply(old[k], keys, cnts, cap, hkeys, hcnts, hslots, ctl, hot);
    move_apply(fresh[k], keys, cnts, cap, hkeys, hcnts, hslots, ctl, hot);
  }
  __syncwarp();
  if (lane < kSigW) sig[(size_t)r * kSigW + lane] = rs.sig[lane];
  __syncwarp();
}

__device__ __forceinline__ void round_end(int32_t *ctl, int kb1, int kb2) {
  if (!ctl[ACTIVE]) return;
  const int nb = __ldcg(ctl + NBAFF);
  ctl[ST_ROUNDS] += 1;
  ctl[ST_REFRESH] += ctl[REFRESH];
  ctl[ST_MID] += nb > kb1 && nb <= kb2;
  ctl[ST_FULL] += nb > kb2;
  ctl[ACTIVE] = 0;
}

// Pass 1: a warp's 32 rows at a time, their signatures into shared memory
// (four 16-byte loads a lane, in flight together), the test of
// sig_prefilter on 2 rows x 16 candidates over the warp's lanes (NBAFF by
// one atomic a warp), then the listed rows' tokens (R rows' loads in
// flight together) and the candidate test (cand_of).  Most listed rows
// hold no candidate pair once the first rounds are past (the signature
// only says that both ids occur); the others are listed in rows, their
// number in *hits.
template <int P>
__global__ void __launch_bounds__(kRowThreads, 4)
    tier_find_kernel(const int32_t *tok, const uint32_t *sig, int B, int NB, int32_t *ctl,
                     const int32_t *cand, int32_t *rows, int32_t *hits) {
  __shared__ CandSet c;
  __shared__ int16_t spx[kK], spy[kK];
  __shared__ uint32_t sigs[kRowWarps][32 * kSigPitch];
  __shared__ int n_listed;  // the block's listed rows: one atomic a block on NBAFF
  const int n = load_cand_set(c, ctl, cand);
  if (n == 0) return;
  if (threadIdx.x == 0) n_listed = 0;
  if (threadIdx.x < n) {
    spx[threadIdx.x] = (int16_t)sig_pos(c.x[threadIdx.x]);
    spy[threadIdx.x] = (int16_t)sig_pos(c.y[threadIdx.x]);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, j = lane & 15;
  const int px = j < n ? spx[j] : 0, py = j < n ? spy[j] : 0;
  uint32_t *ws = sigs[threadIdx.x >> 5];
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  constexpr int R = P <= 2 ? 4 : (P <= 4 ? 2 : 1);  // rows whose loads fly together
  for (int r0 = warp * 32; r0 < NB; r0 += n_warps * 32) {
    if (r0 + lane < NB) {
      const uint4 *src = reinterpret_cast<const uint4 *>(sig + (size_t)(r0 + lane) * kSigW);
      uint4 v[kSigW / 4];
#pragma unroll
      for (int q = 0; q < kSigW / 4; ++q) v[q] = src[q];
#pragma unroll
      for (int q = 0; q < kSigW / 4; ++q) {
        uint32_t *d = ws + lane * kSigPitch + 4 * q;
        d[0] = v[q].x;
        d[1] = v[q].y;
        d[2] = v[q].z;
        d[3] = v[q].w;
      }
    }
    __syncwarp();
    // lanes 0-15 test one row against the candidates, 16-31 the next
    unsigned listed = 0;
#pragma unroll
    for (int h = 0; h < 16; ++h) {
      const int rl = 2 * h + (lane >> 4);
      const uint32_t *sg = ws + rl * kSigPitch;
      const bool f = r0 + rl < NB && j < n &&
                     ((sg[px >> 5] >> (px & 31)) & (sg[py >> 5] >> (py & 31)) & 1u);
      const unsigned b = __ballot_sync(kFullMask, f);
      listed |= (unsigned)((b & 0xFFFFu) != 0) << (2 * h) | (unsigned)((b >> 16) != 0) << (2 * h + 1);
    }
    __syncwarp();
    if (lane == 0 && listed) atomicAdd(&n_listed, __popc(listed));
    unsigned hit = 0;
    while (listed) {
      int rr[R];
      int32_t t[R][P];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        rr[q] = listed ? r0 + __ffs(listed) - 1 : -1;
        listed &= listed - 1;
        if (rr[q] >= 0) load_row<P>(rr[q], B, tok, kPad, t[q]);
      }
#pragma unroll
      for (int q = 0; q < R; ++q)
        if (rr[q] >= 0 && row_has_cand<P>(t[q], c, n)) hit |= 1u << (rr[q] - r0);
    }
    if (!hit) continue;
    int base = 0;
    if (lane == 0) base = atomicAdd(hits, __popc(hit));
    base = __shfl_sync(kFullMask, base, 0);
    if ((hit >> lane) & 1u) rows[base + __popc(hit & ((1u << lane) - 1u))] = r0 + lane;
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_listed) atomicAdd(ctl + NBAFF, n_listed);
}

// Pass 2: the rows with a candidate pair, spread evenly over the warps
// (merge_row); the candidates' keys summed in shared memory, sent once a
// block; the last block to take a ticket counts the round's stats and
// clears *hits for the next round.
template <int P>
__global__ void __launch_bounds__(kRowThreads, 4)
    tier_apply_kernel(int32_t *tok, int32_t *wid, const int32_t *freq, uint32_t *sig, int B,
                      int32_t *ctl, const int32_t *cand, unsigned long long *keys, int32_t *cnts,
                      int cap, unsigned long long *hkeys, int32_t *hcnts, int hslots,
                      const int32_t *rows, int32_t *hits, unsigned *ticket, int kb1, int kb2) {
  extern __shared__ __align__(16) unsigned char scratch[];
  __shared__ CandSet c;
  __shared__ int32_t acc[kK];
  __shared__ bool last;
  const int n = load_cand_set(c, ctl, cand);
  if (n == 0) {  // no merge: the round's stats alone
    if (blockIdx.x == 0 && threadIdx.x == 0) round_end(ctl, kb1, kb2);
    return;
  }
  if (threadIdx.x < kK) acc[threadIdx.x] = 0;
  __syncthreads();
  const bool hot = !ctl[REFRESH];
  const int zlo = ctl[ZLO], n_hit = *hits;
  const RowScratch rs(scratch + (threadIdx.x >> 5) * row_scratch_bytes(B), B);
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  for (int i = warp; i < n_hit; i += n_warps)
    merge_row<P>(rows[i], B, tok, wid, freq, sig, c, n, acc, rs, keys, cnts, cap, hkeys, hcnts,
                 hslots, ctl, hot, zlo);
  __syncthreads();
  if (threadIdx.x < n && acc[threadIdx.x] != 0) {
    Move m{pair_key(c.x[threadIdx.x], c.y[threadIdx.x]), -acc[threadIdx.x], false, {}, {}};
    move_probe(m, keys, cap, hkeys, hslots, hot);
    move_apply(m, keys, cnts, cap, hkeys, hcnts, hslots, ctl, hot);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last && threadIdx.x == 0) {
    round_end(ctl, kb1, kb2);
    *hits = 0;
    *ticket = 0u;
  }
}

// Count mode: every row's counted pairs into the (emptied) full table, every
// signature rebuilt; a warp a row.
template <int P>
__global__ void __launch_bounds__(kRowThreads)
    tier_count_kernel(const int32_t *tok, const int32_t *wid, const int32_t *freq, uint32_t *sig,
                      int B, int NB, int32_t *ctl, unsigned long long *keys, int32_t *cnts,
                      int cap) {
  __shared__ uint32_t ssig[kRowWarps][kSigW];
  uint32_t *sg = ssig[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  for (int r = warp; r < NB; r += n_warps) {
    const int32_t *trow = tok + (size_t)r * B, *wrow = wid + (size_t)r * B;
    int32_t t[P], w[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      t[k] = k * 32 + lane < B ? trow[k * 32 + lane] : kPad;
      w[k] = k * 32 + lane < B ? wrow[k * 32 + lane] : -1;
    }
    if (lane < kSigW) sg[lane] = 0u;
    __syncwarp();
    int carry = -1;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int i = k * 32 + lane;
      const int32_t wn = next_slot(w, k, -2), tn = next_slot(t, k, kPad);
      const int32_t b = i + 1 < B && wn == w[k] ? tn : kPad;
      const bool pairv = t[k] >= 0 && b >= 0;
      const bool eq = pairv && t[k] == b;
      int lne = warp_max_scan(eq ? -1 : i);
      lne = lne > carry ? lne : carry;
      carry = __shfl_sync(kFullMask, lne, 31);
      if (pairv && (!eq || ((i - lne - 1) & 1) == 0))
        table_add<OCC, OVERFLOW, ERROR>(keys, cnts, cap, ctl, pair_key(t[k], b), freq[w[k]], kCount);
      if (t[k] >= 0) {
        const int p = sig_pos(t[k]);
        atomicOr(sg + (p >> 5), 1u << (p & 31));
      }
    }
    __syncwarp();
    if (lane < kSigW) sig[(size_t)r * kSigW + lane] = sg[lane];
    __syncwarp();
  }
}

// Blocks of `kernel` the card holds at once with `smem` bytes of dynamic
// shared memory a block.
template <class K>
int one_wave(K kernel, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRowThreads, smem);
  return sms * (per_sm > 0 ? per_sm : 1);
}

template <int P>
cudaError_t launch_apply(int32_t *tok, int32_t *wid, const int32_t *freq, uint32_t *sig, int B,
                         int NB, int32_t *rows, int32_t *hits, unsigned *ticket, int32_t *ctl,
                         const int32_t *cand, unsigned long long *keys, int32_t *cnts, int cap,
                         unsigned long long *hkeys, int32_t *hcnts, int hslots, int count_mode,
                         int kb1, int kb2, cudaStream_t s) {
  if (count_mode) {
    tier_count_kernel<P><<<grid_for((long long)NB * 32, kRowThreads, 16), kRowThreads, 0, s>>>(
        tok, wid, freq, sig, B, NB, ctl, keys, cnts, cap);
    return cudaGetLastError();
  }
  // one wave each: the blocks the card holds at once (the rows' scratch of
  // the largest B may pass 48 KB)
  static int find_blocks = 0, apply_blocks = 0;
  const int smem = kRowWarps * row_scratch_bytes(kMaxB);
  if (!apply_blocks) {
    cudaError_t e = cudaFuncSetAttribute(tier_apply_kernel<P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    find_blocks = one_wave(tier_find_kernel<P>, 0);
    apply_blocks = one_wave(tier_apply_kernel<P>, smem);
  }
  const long long need = ((NB + 31) / 32 + kRowWarps - 1) / kRowWarps;
  tier_find_kernel<P><<<(int)(need < find_blocks ? need : find_blocks), kRowThreads, 0, s>>>(
      tok, sig, B, NB, ctl, cand, rows, hits);
  tier_apply_kernel<P><<<apply_blocks, kRowThreads, kRowWarps * row_scratch_bytes(B), s>>>(
      tok, wid, freq, sig, B, ctl, cand, keys, cnts, cap, hkeys, hcnts, hslots, rows, hits, ticket,
      kb1, kb2);
  return cudaGetLastError();
}

// -- resplit -----------------------------------------------------------------

constexpr int kBins = 2048;
constexpr int kScanBlocks = 264;  // two blocks an SM for the table scans
// resplit scratch after the kBins histogram: the prefix and mask of the
// bits picked so far, the rank still to find, "fewer live counts than the
// rank", and the count of blocks done with a pass
enum { SEL_PREFIX = kBins, SEL_MASK, SEL_REST, SEL_NONE, SEL_DONE, SEL_N = kBins + 8 };

// One pass of the radix select of T, the boundary-th largest count among
// counts > 0 (0 with fewer of them): pass p histograms bits 31-21, 20-10 or
// 9-0 of the counts that match the bits picked so far; the last block to
// finish picks the bin that holds the rank, zeroes the histogram for the
// next pass, and after the last pass sets T.
__global__ void __launch_bounds__(256)
    resplit_pass_kernel(const int32_t *cnts, int cap, int32_t *ctl, int32_t *sel, int pass,
                        int boundary) {
  __shared__ int hist[kBins];
  __shared__ bool last;
  if (!resplit_due(ctl)) return;
  if (pass > 0 && __ldcg(sel + SEL_NONE)) return;
  const int sh = pass == 0 ? 21 : (pass == 1 ? 10 : 0);
  const uint32_t prefix = pass == 0 ? 0u : (uint32_t)__ldcg(sel + SEL_PREFIX);
  const uint32_t mask = pass == 0 ? 0u : (uint32_t)__ldcg(sel + SEL_MASK);
  for (int d = threadIdx.x; d < kBins; d += blockDim.x) hist[d] = 0;
  __syncthreads();
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < cap; s += gridDim.x * blockDim.x) {
    const int c = cnts[s];
    if (c > 0 && ((uint32_t)c & mask) == prefix)
      atomicAdd(hist + (((uint32_t)c >> sh) & (kBins - 1)), 1);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < kBins; d += blockDim.x)
    if (hist[d]) atomicAdd(sel + d, hist[d]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(sel + SEL_DONE, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  if (threadIdx.x == 0) {
    const int rest = pass == 0 ? boundary : __ldcg(sel + SEL_REST);
    int cum = 0, d = kBins - 1;
    for (; d >= 0; --d) {
      const int h = __ldcg(sel + d);
      if (cum + h >= rest) break;
      cum += h;
    }
    const bool none = d < 0;  // fewer live counts than the boundary
    const uint32_t pre = none ? 0u : prefix | ((uint32_t)d << sh);
    sel[SEL_PREFIX] = (int)pre;
    sel[SEL_MASK] = (int)(mask | ((uint32_t)(kBins - 1) << sh));
    sel[SEL_REST] = rest - cum;
    sel[SEL_NONE] = none;
    sel[SEL_DONE] = 0;
    if (none || pass == 2) {
      ctl[THRESH] = (int)pre;
      ctl[HOCC] = 0;
      ctl[HOT_OVF] = 0;
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < kBins; d += blockDim.x) sel[d] = 0;
}

__global__ void __launch_bounds__(256)
    hot_clear_kernel(unsigned long long *hkeys, int32_t *hcnts, int hslots, const int32_t *ctl) {
  if (!resplit_due(ctl)) return;
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < hslots; s += gridDim.x * blockDim.x) {
    hkeys[s] = kEmpty;
    hcnts[s] = 0;
  }
}

__global__ void __launch_bounds__(256)
    hot_fill_kernel(const unsigned long long *keys, const int32_t *cnts, int cap,
                    unsigned long long *hkeys, int32_t *hcnts, int hslots, int32_t *ctl) {
  if (!resplit_due(ctl)) return;
  const int T = ctl[THRESH];
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < cap; s += gridDim.x * blockDim.x) {
    const int c = cnts[s];
    if (c > T) hot_add(hkeys, hcnts, hslots, ctl, keys[s], c, true);
  }
}

// -- fold_rows ---------------------------------------------------------------

constexpr int kFoldChunk = 256;  // rows a block of the counting sort takes

__global__ void __launch_bounds__(256)
    fold_fills_kernel(const int32_t *tok, int B, int NB, int32_t *fills, int32_t *ctl) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  for (int r = warp; r < NB; r += n_warps) {
    int f = 0;
    for (int b = 0; b < B; b += 32) {
      const int i = b + lane;
      f += __popc(__ballot_sync(0xFFFFFFFFu, i < B && tok[(size_t)r * B + i] >= 0));
    }
    if (lane == 0) {
      fills[r] = f;
      atomicAdd(ctl + LIVE, f);
    }
  }
}

__global__ void __launch_bounds__(32)
    fold_hist_kernel(const int32_t *fills, int NB, int B, int32_t *ghist) {
  __shared__ int hist[kMaxB + 1];
  for (int v = threadIdx.x; v <= B; v += 32) hist[v] = 0;
  __syncwarp();
  const int r0 = blockIdx.x * kFoldChunk;
  for (int r = r0 + threadIdx.x; r < NB && r < r0 + kFoldChunk; r += 32)
    atomicAdd(hist + fills[r], 1);
  __syncwarp();
  for (int v = threadIdx.x; v <= B; v += 32) ghist[(size_t)blockIdx.x * (B + 1) + v] = hist[v];
}

// ghist[g][v] -> the first output position of block g's rows of fill v
__global__ void __launch_bounds__(1024)
    fold_scan_kernel(int32_t *ghist, int G, int B) {
  __shared__ int total[kMaxB + 1];
  const int v = threadIdx.x;
  if (v <= B) {
    int s = 0;
    for (int g = 0; g < G; ++g) s += ghist[(size_t)g * (B + 1) + v];
    total[v] = s;
  }
  __syncthreads();
  if (v == 0) {
    int run = 0;
    for (int u = 0; u <= B; ++u) {
      const int c = total[u];
      total[u] = run;
      run += c;
    }
  }
  __syncthreads();
  if (v <= B) {
    int run = total[v];
    for (int g = 0; g < G; ++g) {
      int32_t *h = ghist + (size_t)g * (B + 1) + v;
      const int c = *h;
      *h = run;
      run += c;
    }
  }
}

// stable placement: rows in index order within each fill
__global__ void __launch_bounds__(32)
    fold_place_kernel(const int32_t *fills, int NB, int B, const int32_t *ghist, int32_t *order) {
  __shared__ int cursor[kMaxB + 1];
  const int lane = threadIdx.x;
  for (int v = lane; v <= B; v += 32) cursor[v] = ghist[(size_t)blockIdx.x * (B + 1) + v];
  __syncwarp();
  const int r0 = blockIdx.x * kFoldChunk;
  for (int b = r0; b < NB && b < r0 + kFoldChunk; b += 32) {
    const int r = b + lane;
    const bool ok = r < NB && r < r0 + kFoldChunk;
    const int v = ok ? fills[r] : B + 1 + lane;  // a value of its own
    const unsigned same = __match_any_sync(0xFFFFFFFFu, v);
    if (ok) order[cursor[v] + __popc(same & ((1u << lane) - 1u))] = r;
    __syncwarp();
    if (ok && 31 - __clz(same) == lane) cursor[v] += __popc(same);
    __syncwarp();
  }
}

__global__ void __launch_bounds__(256)
    fold_check_kernel(const int32_t *fills, const int32_t *order, int NB, int32_t *ctl) {
  int best = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < NB / 2; i += gridDim.x * blockDim.x) {
    const int s = fills[order[i]] + fills[order[NB - 1 - i]];
    best = s > best ? s : best;
  }
  best = __reduce_max_sync(0xFFFFFFFFu, best);
  if ((threadIdx.x & 31) == 0) atomicMax(ctl + FOLD_MAX, best);
}

__global__ void __launch_bounds__(256)
    fold_write_kernel(const int32_t *tok, const int32_t *wid, const int32_t *fills,
                      const int32_t *order, int B, int NB, int32_t *tok2, int32_t *wid2,
                      uint32_t *sig2) {
  __shared__ uint32_t ssig[8][kSigW];
  const int lane = threadIdx.x & 31;
  uint32_t *sg = ssig[threadIdx.x >> 5];
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  for (int i = warp; i < NB / 2; i += n_warps) {
    const int hi = order[NB - 1 - i], lo = order[i];
    const int fh = fills[hi], fl = fills[lo];
    if (lane < kSigW) sg[lane] = 0u;
    __syncwarp();
    for (int j = lane; j < B; j += 32) {
      int32_t t = kPad, w = -1;
      if (j < fh) {
        t = tok[(size_t)hi * B + j];
        w = wid[(size_t)hi * B + j];
      } else if (j < fh + fl) {
        t = tok[(size_t)lo * B + j - fh];
        w = wid[(size_t)lo * B + j - fh];
      }
      tok2[(size_t)i * B + j] = t;
      wid2[(size_t)i * B + j] = w;
      if (t >= 0) {
        const int p = sig_pos(t);
        atomicOr(sg + (p >> 5), 1u << (p & 31));
      }
    }
    __syncwarp();
    if (lane < kSigW) sig2[(size_t)i * kSigW + lane] = sg[lane];
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// One round's selection: tier_hot on hn_blk blocks, then tier_full on
// fn_blk blocks (a no-op but on refresh rounds).  blk_hi and blk_lo hold
// max(hn_blk, fn_blk) * 16 entries of scratch; *ticket is 0 (each launch
// leaves it so).  cnts and hcnts are 16-byte aligned.
int yttm_tiered_select(const void *keys, const void *cnts, int cap, const void *hkeys,
                       const void *hcnts, int hslots, void *blk_hi, void *blk_lo, int hn_blk,
                       int fn_blk, void *ticket, void *ctl, void *cand, void *rules, int limit,
                       int vocab, int used_ids0, int k, void *stream) {
  if (cap <= 0 || hslots <= 0 || hn_blk <= 0 || fn_blk <= 0 || hn_blk > kSelMaxBlocks ||
      fn_blk > kSelMaxBlocks || k <= 0 || k > kK ||
      ((uintptr_t)cnts & 15u) || ((uintptr_t)hcnts & 15u))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int32_t *c = (int32_t *)ctl;
  const bool wide = vocab > 65536;  // ids below vocab: narrow words hold them all
  tier_hot_kernel<<<hn_blk, kSelThreads, 0, s>>>(
      (const unsigned long long *)hkeys, (const int32_t *)hcnts, hslots,
      (unsigned long long *)blk_hi, (uint32_t *)blk_lo, (unsigned *)ticket, c, (int32_t *)cand,
      (int32_t *)rules, limit, vocab, used_ids0, k, wide);
  tier_full_kernel<<<fn_blk, kSelThreads, 0, s>>>(
      (const unsigned long long *)keys, (const int32_t *)cnts, cap, (unsigned long long *)blk_hi,
      (uint32_t *)blk_lo, (unsigned *)ticket, c, (int32_t *)cand, (int32_t *)rules, vocab,
      used_ids0, k, wide);
  return (int)cudaGetLastError();
}

// One round's apply (count_mode: count every row into the full table and
// rebuild every signature; the caller emptied the table and zeroed OCC and
// OVERFLOW).  rows holds NB entries of scratch; *hits and *ticket are 0
// (each round leaves them so).
int yttm_tiered_apply(void *tok, void *wid, const void *freq, void *sig, int B, int NB,
                      void *rows, void *hits, void *ticket, void *ctl, const void *cand,
                      void *keys, void *cnts, int cap, void *hkeys, void *hcnts, int hslots,
                      int count_mode, int kb1, int kb2, void *stream) {
  if (B < 1 || B > kMaxB || NB <= 0 || cap <= 0 || hslots <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t (*launch)(int32_t *, int32_t *, const int32_t *, uint32_t *, int, int, int32_t *,
                        int32_t *, unsigned *, int32_t *, const int32_t *, unsigned long long *,
                        int32_t *, int, unsigned long long *, int32_t *, int, int, int, int,
                        cudaStream_t) =
      B <= 32 ? &launch_apply<1> : B <= 64 ? &launch_apply<2> : B <= 128 ? &launch_apply<4>
      : B <= 256 ? &launch_apply<8> : &launch_apply<16>;
  return (int)launch((int32_t *)tok, (int32_t *)wid, (const int32_t *)freq, (uint32_t *)sig, B, NB,
                     (int32_t *)rows, (int32_t *)hits, (unsigned *)ticket, (int32_t *)ctl,
                     (const int32_t *)cand, (unsigned long long *)keys, (int32_t *)cnts, cap,
                     (unsigned long long *)hkeys, (int32_t *)hcnts, hslots, count_mode, kb1, kb2,
                     (cudaStream_t)stream);
}

// After a refresh round that merged: T and the hot table.  sel holds SEL_N
// entries of scratch, zero before the first call (each call leaves them so).
int yttm_tiered_resplit(const void *keys, const void *cnts, int cap, void *hkeys, void *hcnts,
                        int hslots, void *ctl, void *sel, int boundary, void *stream) {
  if (cap <= 0 || hslots <= 0 || boundary < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int32_t *c = (int32_t *)ctl;
  const int scan = grid_for(cap, 256, 16) < kScanBlocks ? grid_for(cap, 256, 16) : kScanBlocks;
  for (int pass = 0; pass < 3; ++pass)
    resplit_pass_kernel<<<scan, 256, 0, s>>>((const int32_t *)cnts, cap, c, (int32_t *)sel, pass,
                                             boundary);
  hot_clear_kernel<<<grid_for(hslots, 256, 16), 256, 0, s>>>((unsigned long long *)hkeys,
                                                         (int32_t *)hcnts, hslots, c);
  hot_fill_kernel<<<scan, 256, 0, s>>>(
      (const unsigned long long *)keys, (const int32_t *)cnts, cap, (unsigned long long *)hkeys,
      (int32_t *)hcnts, hslots, c);
  return (int)cudaGetLastError();
}

// The fold's plan: fills, LIVE, the stable order by fill, FOLD_MAX.  ghist
// holds ceil(NB / 256) * (B + 1) entries of scratch.
int yttm_tiered_fold_plan(const void *tok, int B, int NB, void *fills, void *ghist, void *order,
                          void *ctl, void *stream) {
  if (B < 1 || B > kMaxB || NB < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int32_t *c = (int32_t *)ctl;
  cudaError_t e = cudaMemsetAsync(c + LIVE, 0, 2 * sizeof(int32_t), s);
  if (e != cudaSuccess) return (int)e;
  const int G = (NB + kFoldChunk - 1) / kFoldChunk;
  fold_fills_kernel<<<grid_for((long long)NB * 32, 256, 16), 256, 0, s>>>(
      (const int32_t *)tok, B, NB, (int32_t *)fills, c);
  fold_hist_kernel<<<G, 32, 0, s>>>((const int32_t *)fills, NB, B, (int32_t *)ghist);
  fold_scan_kernel<<<1, 1024, 0, s>>>((int32_t *)ghist, G, B);
  fold_place_kernel<<<G, 32, 0, s>>>((const int32_t *)fills, NB, B, (const int32_t *)ghist,
                                     (int32_t *)order);
  fold_check_kernel<<<grid_for(NB / 2, 256, 16), 256, 0, s>>>((const int32_t *)fills,
                                                          (const int32_t *)order, NB, c);
  return (int)cudaGetLastError();
}

// The fold itself, into tok2/wid2 [NB/2 * B] and sig2 [NB/2, 16].
int yttm_tiered_fold_write(const void *tok, const void *wid, const void *fills, const void *order,
                           int B, int NB, void *tok2, void *wid2, void *sig2, void *stream) {
  if (B < 1 || B > kMaxB || NB < 2) return (int)cudaErrorInvalidValue;
  fold_write_kernel<<<grid_for((long long)(NB / 2) * 32, 256, 16), 256, 0, (cudaStream_t)stream>>>(
      (const int32_t *)tok, (const int32_t *)wid, (const int32_t *)fills, (const int32_t *)order, B,
      NB, (int32_t *)tok2, (int32_t *)wid2, (uint32_t *)sig2);
  return (int)cudaGetLastError();
}

}  // extern "C"
