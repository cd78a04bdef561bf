// The v5 tiered trainer's merge round, on Hopper: four kernels and a graph.
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
//   resplit       after a refresh round that merged: T = the count at rank
//                 hcap/2 of the full table (0 with fewer live keys), found by
//                 one or two histogram passes from the round's top count down,
//                 and the hot table rebuilt from every key with count > T; one
//                 cooperative kernel with a grid barrier between its steps
//                 (its section).
//   fold_rows     at a segment end where the kept live count (ctl[LIVE])
//                 calls for it: row fills, a stable counting sort of the rows
//                 by fill and the pair check (emptiest with fullest fits a
//                 row) in one cooperative launch, then the fold: row i =
//                 concat(row order[NB-1-i], row order[i]), compacted, with its
//                 signature; the row order equals the JAX fold's.
//
// Every kernel does nothing once `done` or `overflow` is set or `used`
// reached min(vocab, limit), so the host enqueues rounds in batches and
// reads ctl once per batch.  The kernel engine enqueues a round as one CUDA
// graph (yttm_tiered_graph: tier_select's and apply_blocks' launches, then
// resplit under an IF node set on the card), replayed n times by one call a
// batch; the per-call entries stay for the checks and the round-by-round
// replay.
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
  LIVE,      // live tokens: set by a count, less each round's merges
  FOLD_MAX,  // fold plan: the largest fill of a row pair
  CTL_N = 24
};

constexpr int kSigW = 16;
constexpr int kMaxB = 512;
// apply_blocks' scratch `hits` (int32): [0] the listed rows, [2, 4) the
// apply's 64-bit ticket (blocks done, tokens removed)
constexpr int kHitsN = 4;

__device__ __forceinline__ int sig_pos(int32_t tok) {
  return (int)(((uint32_t)tok * 2654435761u) >> 23) & 511;
}

// After a refresh round that merged (and did not overflow): T and the hot
// table are rebuilt.  Read through L2: the apply's blocks set OVERFLOW.
__device__ __forceinline__ bool resplit_due(const int32_t *ctl) {
  return __ldcg(ctl + REFRESH) && __ldcg(ctl + NACC) > 0 && !__ldcg(ctl + OVERFLOW);
}

// Hot-table update: a present key adds `delta`; a missing key is claimed
// only when `insert` (it holds this round's z).  Returns 1 when it claimed a
// free slot; a probe past every slot sets HOT_OVF.
__device__ int hot_put(unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl,
                       unsigned long long key, int32_t delta, bool insert) {
  const unsigned mask = (unsigned)cap - 1u;
  const unsigned h = (unsigned)hash64(key) & mask;
  for (int p = 0; p < cap; ++p) {
    const unsigned s = (h + (unsigned)p) & mask;
    unsigned long long k = __ldcg(keys + s);
    if (k == kEmpty) {
      if (!insert) return 0;
      k = atomicCAS(keys + s, kEmpty, key);
      if (k == kEmpty) {
        atomicAdd(cnts + s, delta);
        return 1;
      }
    }
    if (k == key) {
      atomicAdd(cnts + s, delta);
      return 0;
    }
  }
  atomicExch(ctl + HOT_OVF, 1);
  return 0;
}

// hot_put with the claimed slots counted in HOCC at once: overflow past
// half the slots sets HOT_OVF, which makes the next round a refresh round.
__device__ void hot_add(unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl,
                        unsigned long long key, int32_t delta, bool insert) {
  if (hot_put(keys, cnts, cap, ctl, key, delta, insert) &&
      2ll * (atomicAdd(ctl + HOCC, 1) + 1) > (long long)cap)
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
// Returns the row's merges: the tokens it lost.
template <int P>
__device__ int merge_row(int r, int B, int32_t *tok, int32_t *wid,
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
  // the merge: even offsets inside runs of hits; each drops the token after it
  bool sel[P];
  int merged = 0;
  carry = -1;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = k * 32 + lane;
    int lnh = warp_max_scan(rix[k] >= 0 ? -1 : i);
    lnh = lnh > carry ? lnh : carry;
    sel[k] = rix[k] >= 0 && ((i - lnh - 1) & 1) == 0;
    merged += __popc(__ballot_sync(kFullMask, sel[k]));
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
  return merged;
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
// block.  Each block takes a ticket, a 64-bit atomic at hits + 2 (kHitsN
// int32 of scratch): blocks done in its low word, the tokens the block's
// merges removed in its high word.  The last block subtracts their sum
// from ctl[LIVE] (the live count the fold's trigger reads), counts the
// round's stats and clears *hits and the ticket for the next round.  (An
// atomic a block on ctl[LIVE] itself, beside the ticket's, cost ~1.5 ms
// over the 100 MB run's 3,247 rounds: same-address contention.)
template <int P>
__global__ void __launch_bounds__(kRowThreads, 4)
    tier_apply_kernel(int32_t *tok, int32_t *wid, const int32_t *freq, uint32_t *sig, int B,
                      int32_t *ctl, const int32_t *cand, unsigned long long *keys, int32_t *cnts,
                      int cap, unsigned long long *hkeys, int32_t *hcnts, int hslots,
                      const int32_t *rows, int32_t *hits, int kb1, int kb2,
                      cudaGraphConditionalHandle gate, int gated) {
  extern __shared__ __align__(16) unsigned char scratch[];
  __shared__ CandSet c;
  __shared__ int32_t acc[kK];
  __shared__ int removed, all_removed;
  __shared__ bool last;
  const int n = load_cand_set(c, ctl, cand);
  if (n == 0) {  // no merge: the round's stats alone
    if (blockIdx.x == 0 && threadIdx.x == 0) round_end(ctl, kb1, kb2);
    return;
  }
  if (threadIdx.x < kK) acc[threadIdx.x] = 0;
  if (threadIdx.x == 0) removed = 0;
  __syncthreads();
  const bool hot = !ctl[REFRESH];
  const int zlo = ctl[ZLO], n_hit = *hits;
  const RowScratch rs(scratch + (threadIdx.x >> 5) * row_scratch_bytes(B), B);
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  int merged = 0;
  for (int i = warp; i < n_hit; i += n_warps)
    merged += merge_row<P>(rows[i], B, tok, wid, freq, sig, c, n, acc, rs, keys, cnts, cap, hkeys,
                           hcnts, hslots, ctl, hot, zlo);
  if ((threadIdx.x & 31) == 0 && merged) atomicAdd(&removed, merged);
  __syncthreads();
  if (threadIdx.x < n && acc[threadIdx.x] != 0) {
    Move m{pair_key(c.x[threadIdx.x], c.y[threadIdx.x]), -acc[threadIdx.x], false, {}, {}};
    move_probe(m, keys, cap, hkeys, hslots, hot);
    move_apply(m, keys, cnts, cap, hkeys, hcnts, hslots, ctl, hot);
  }
  __threadfence();
  __syncthreads();
  unsigned long long *ticket = reinterpret_cast<unsigned long long *>(hits + 2);
  if (threadIdx.x == 0) {
    const unsigned long long was = atomicAdd(ticket, (unsigned long long)removed << 32 | 1ull);
    last = (unsigned)was == gridDim.x - 1;
    all_removed = (int)(was >> 32) + removed;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    ctl[LIVE] -= all_removed;
    round_end(ctl, kb1, kb2);
    *hits = 0;
    *ticket = 0ull;
    // the round graph's IF node over the resplit (default 0: a round with
    // no merge leaves it so)
    if (gated) cudaGraphSetConditional(gate, resplit_due(ctl) ? 1u : 0u);
  }
}

// Count mode: every row's counted pairs into the (emptied) full table, every
// signature rebuilt, and the live tokens added to ctl[LIVE] (zeroed by the
// caller) once a block; a warp a row.
template <int P>
__global__ void __launch_bounds__(kRowThreads)
    tier_count_kernel(const int32_t *tok, const int32_t *wid, const int32_t *freq, uint32_t *sig,
                      int B, int NB, int32_t *ctl, unsigned long long *keys, int32_t *cnts,
                      int cap) {
  __shared__ uint32_t ssig[kRowWarps][kSigW];
  __shared__ int blk_live;
  uint32_t *sg = ssig[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  if (threadIdx.x == 0) blk_live = 0;
  __syncthreads();
  int live = 0;
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
      live += __popc(__ballot_sync(kFullMask, t[k] >= 0));
    }
    __syncwarp();
    if (lane < kSigW) sig[(size_t)r * kSigW + lane] = sg[lane];
    __syncwarp();
  }
  if (lane == 0 && live) atomicAdd(&blk_live, live);
  __syncthreads();
  if (threadIdx.x == 0 && blk_live) atomicAdd(ctl + LIVE, blk_live);
}

// Blocks of `kernel` the card holds at once with `smem` bytes of dynamic
// shared memory a block of `threads`.
template <class K>
int one_wave(K kernel, int smem, int threads = kRowThreads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  return sms * (per_sm > 0 ? per_sm : 1);
}

// The apply's two launches for rows of B slots: one wave each, the blocks
// the card holds at once (the rows' scratch of the largest B may pass 48 KB).
struct ApplyPlan {
  int find_grid, apply_grid, apply_smem;
};

template <int P>
cudaError_t apply_plan(int B, int NB, ApplyPlan *p) {
  static int find_blocks = 0, apply_blocks = 0;
  if (!apply_blocks) {
    const int smem = kRowWarps * row_scratch_bytes(kMaxB);
    cudaError_t e = cudaFuncSetAttribute(tier_apply_kernel<P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    find_blocks = one_wave(tier_find_kernel<P>, 0);
    apply_blocks = one_wave(tier_apply_kernel<P>, smem);
  }
  const long long need = ((NB + 31) / 32 + kRowWarps - 1) / kRowWarps;
  p->find_grid = (int)(need < find_blocks ? need : find_blocks);
  p->apply_grid = apply_blocks;
  p->apply_smem = kRowWarps * row_scratch_bytes(B);
  return cudaSuccess;
}

template <int P>
cudaError_t launch_apply(int32_t *tok, int32_t *wid, const int32_t *freq, uint32_t *sig, int B,
                         int NB, int32_t *rows, int32_t *hits, int32_t *ctl,
                         const int32_t *cand, unsigned long long *keys, int32_t *cnts, int cap,
                         unsigned long long *hkeys, int32_t *hcnts, int hslots, int count_mode,
                         int kb1, int kb2, cudaStream_t s) {
  if (count_mode) {
    tier_count_kernel<P><<<grid_for((long long)NB * 32, kRowThreads, 16), kRowThreads, 0, s>>>(
        tok, wid, freq, sig, B, NB, ctl, keys, cnts, cap);
    return cudaGetLastError();
  }
  ApplyPlan pl;
  cudaError_t e = apply_plan<P>(B, NB, &pl);
  if (e != cudaSuccess) return e;
  tier_find_kernel<P><<<pl.find_grid, kRowThreads, 0, s>>>(tok, sig, B, NB, ctl, cand, rows, hits);
  tier_apply_kernel<P><<<pl.apply_grid, kRowThreads, pl.apply_smem, s>>>(
      tok, wid, freq, sig, B, ctl, cand, keys, cnts, cap, hkeys, hcnts, hslots, rows, hits, kb1,
      kb2, 0, 0);
  return cudaGetLastError();
}

// -- resplit -----------------------------------------------------------------
//
// One kernel, run only after a refresh round that merged (resplit_due): T =
// the boundary-th largest count among counts > 0 (0 with fewer), the hot
// table cleared, and every key of the full table with count > T put in it.
// The old design made five launches every round (three radix passes of
// 11/11/10 bits, a clear, a fill), each of which read ctl and returned on
// all but 49 of the 3,247 rounds at the 100 MB point: ~6 us of device time
// a round for nothing (and five launches for the host to make), and ~1.2 ms
// a due round, 76.7 ms over the run against a bound of 0.525 ms
// (torch.profiler, H100 80GB HBM3, 700 W).  A due round read the full
// table's counts four times (2^23 slots, 33.5 MB); the counts there are far
// below 2^21, so its first pass put nearly every one into bin 0 (one shared
// memory address), and its fill counted every insert on one global
// address (HOCC).
//
// Now the round graph (yttm_tiered_graph below) runs this kernel under an
// IF node that tier_apply_kernel's last block sets from resplit_due: a round
// that needs no resplit launches nothing.  The kernel is one wave of blocks
// (a cooperative launch: every block resident), with a grid barrier between
// its steps:
//   * the hot table cleared, while the first pass runs;
//   * each pass histograms the counts in [lo, hi] into 2048 bins of 2^sh
//     counts, and counts those above hi; the pass starts at [1, top], top
//     being the count of the refresh round's first accepted pair: no count
//     exceeds it after the round (an existing pair's count never grows, and
//     a new pair's count is at most the merges of its pair), so while top
//     < 2049 one pass finds T, and below 2^22 two do;
//   * every block then picks the bin that holds the rank, from the global
//     histogram, so the grid agrees on the next [lo, hi] with no further
//     step; the pass whose bins are single counts (sh == 0) gives T;
//   * during that last pass the slots in [lo, hi] are listed and, unless
//     it is the first, the keys above hi go into the hot table (they are
//     above T); after it, the listed slots above T go in too.
// So a due round reads the full table's counts once or twice (one pass per
// 11 bits of top - 1) and the keys of the hot slots once.  The last pass
// lists its range only when the slots there (the chosen bin's count, or the
// claimed slots for a first pass) fit the list, cap / 16 slots: gathering
// more at random would cost more than a sequential read of the counts.
// Otherwise, as where fewer live counts than the boundary were found before
// the last pass (T = 0) or a first pass that was also the last met a count
// above top, the kernel reads the counts once more and puts in the keys
// with T < c <= hi (a round whose top count is low, so that its one pass
// spans every live key, takes this read).  A count above top (which the
// invariant rules out) costs a pass, not a wrong T.
//
// The histogram's shared atomics are summed a bin a warp first
// (__match_any_sync), the list takes one atomic a warp for its 128 slots,
// and the taken hot slots are counted in HOCC once a block (hot_put), not
// once a key (hot_add).
//
// Bound: the full table's counts (4 B a slot), and the hot keys read and
// written with their counts (24 B each), ~10 us a due round at the 100 MB
// point; the kernel counts its own runs (sel[SEL_RUNS]) so that the host
// can report them without a launch count.

constexpr int kBins = 2048;
constexpr int kBinBits = 11;
constexpr int kPasses = 4;  // a first pass over [1, top], then 31 bits at 11 a pass
constexpr int kSplitThreads = 512;
// resplit scratch (int32): a kBins histogram a pass, the counts above each
// pass's range, the listed slots, the grid barrier's arrivals and
// generation, the exit ticket and the count of runs
enum {
  SEL_ABOVE = kPasses * kBins, SEL_LISTED = SEL_ABOVE + kPasses, SEL_ARRIVED, SEL_GEN,
  SEL_TICKET, SEL_RUNS, SEL_N = SEL_ABOVE + 16
};

// Every block of the (co-resident) grid waits here for the others.  gen is
// thread 0's copy of the barrier's generation.
__device__ __forceinline__ void grid_sync(int32_t *sel, unsigned &gen) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned *arrived = (unsigned *)(sel + SEL_ARRIVED);
    volatile unsigned *g = (volatile unsigned *)(sel + SEL_GEN);
    __threadfence();
    if (atomicAdd(arrived, 1u) == gridDim.x - 1) {
      atomicExch(arrived, 0u);
      __threadfence();
      atomicAdd((unsigned *)(sel + SEL_GEN), 1u);
    } else {
      while (*g == gen) __nanosleep(32);
    }
    __threadfence();
    ++gen;
  }
  __syncthreads();
}

// The bin of the global histogram h (kBins bins, from the top) that holds
// rank `need`: every thread of the block takes 4 bins (one 16-byte load),
// the block scans the sums from the top, and the thread whose bins hold the
// rank writes its bin to *d; -1 when all of h holds fewer than need.  Every
// thread calls it.
static_assert(kSplitThreads * 4 == kBins, "a thread a 4-bin group");

__device__ void pick_bin(const int32_t *h, int need, int *wsum, int *d) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int4 q = __ldcg(reinterpret_cast<const int4 *>(h) + threadIdx.x);
  const int sum = q.x + q.y + q.z + q.w;
  int incl = sum;  // this lane's and the higher lanes' sums
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_down_sync(kFullMask, incl, o);
    if (lane + o < 32) incl += v;
  }
  if (threadIdx.x == 0) *d = -1;
  if (lane == 0) wsum[warp] = incl;
  __syncthreads();
  int above = incl - sum;
  for (int w = warp + 1; w < kSplitThreads / 32; ++w) above += wsum[w];
  if (above < need && above + sum >= need) {
    const int v[4] = {q.x, q.y, q.z, q.w};
    int j = 3, c = above;
    for (; j > 0 && c + v[j] < need; --j) c += v[j];
    *d = 4 * threadIdx.x + j;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kSplitThreads)
    resplit_kernel(const unsigned long long *keys, const int32_t *cnts, int cap,
                   unsigned long long *hkeys, int32_t *hcnts, int hslots, int32_t *ctl, int32_t *sel,
                   int32_t *slots, int slot_cap, const int32_t *cand, int boundary) {
  __shared__ int hist[kBins];
  __shared__ int blk_above, blk_put, pick_d, wsum[kSplitThreads / 32];
  __shared__ bool last;
  if (!resplit_due(ctl)) return;
  unsigned gen = 0;
  if (threadIdx.x == 0) gen = *(volatile unsigned *)(sel + SEL_GEN);
  const int lane = threadIdx.x & 31;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x, nthreads = gridDim.x * blockDim.x;
  for (int s = tid; s < hslots; s += nthreads) {
    hkeys[s] = kEmpty;
    hcnts[s] = 0;
  }
  if (tid == 0) {
    ctl[HOCC] = 0;
    ctl[HOT_OVF] = 0;
  }
  if (threadIdx.x == 0) blk_put = 0;
  const int top = __ldcg(cand + 3);
  long long lo = 1, hi = top > 1 ? top : 1;
  int T = 0, pass = 0, put = 0;
  bool fin = false, list_all = false;
  // the slots in [lo, hi]: at first at most the claimed ones
  long long in_range = __ldcg(ctl + OCC);
  const int n4 = cap >> 2;
  const int4 *c4 = reinterpret_cast<const int4 *>(cnts);
  for (;; ++pass) {
    int sh = 0;
    while (((hi - lo) >> sh) >= kBins) ++sh;
    fin = sh == 0;
    // the first pass inserts nothing (a count above top would make its
    // range wrong); a later last pass inserts the keys above its range
    const bool ins = fin && pass > 0;
    for (int i = threadIdx.x; i < kBins; i += blockDim.x) hist[i] = 0;
    if (threadIdx.x == 0) blk_above = 0;
    __syncthreads();
    int above = 0;
    // the last pass lists its range's slots when they fit the list (a
    // larger range is read again instead); warp-uniform, off once full
    list_all = fin && in_range <= slot_cap;
    bool listing = list_all;
    // warp-uniform trips: the ballots and matches need the whole warp
    for (int v0 = tid - lane; v0 < n4; v0 += nthreads) {
      const int v = v0 + lane;
      int4 q = make_int4(0, 0, 0, 0);
      if (v < n4) q = __ldg(c4 + v);
      const int cs[4] = {q.x, q.y, q.z, q.w};
      bool listed[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long c = cs[j];
        int bin = -1;
        listed[j] = false;
        if (c > hi) {
          ++above;
          if (ins) put += hot_put(hkeys, hcnts, hslots, ctl, keys[4 * v + j], (int32_t)c, true);
        } else if (c >= lo) {
          bin = (int)((c - lo) >> sh);
          listed[j] = listing;
        }
        // the counts crowd the low bins: one shared atomic a bin a warp
        if (__any_sync(kFullMask, bin >= 0)) {
          const unsigned peers = __match_any_sync(kFullMask, bin);
          if (bin >= 0 && lane == __ffs(peers) - 1) atomicAdd(hist + bin, __popc(peers));
        }
      }
      if (listing) {  // one atomic a warp for its 128 slots
        unsigned m[4];
        int n = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          m[j] = __ballot_sync(kFullMask, listed[j]);
          n += __popc(m[j]);
        }
        if (n) {
          int base = 0;
          if (lane == 0) base = atomicAdd(sel + SEL_LISTED, n);
          base = __shfl_sync(kFullMask, base, 0);
          listing = base + n <= slot_cap;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int at = base + __popc(m[j] & ((1u << lane) - 1u));
            if (listed[j] && at < slot_cap) slots[at] = 4 * v + j;
            base += __popc(m[j]);
          }
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) above += __shfl_xor_sync(kFullMask, above, o);
    if (lane == 0 && above) atomicAdd(&blk_above, above);
    __syncthreads();
    int32_t *gh = sel + pass * kBins;
    for (int i = threadIdx.x; i < kBins; i += blockDim.x)
      if (hist[i]) atomicAdd(gh + i, hist[i]);
    if (threadIdx.x == 0 && blk_above) atomicAdd(sel + SEL_ABOVE + pass, blk_above);
    grid_sync(sel, gen);
    const int A = __ldcg(sel + SEL_ABOVE + pass);
    if (A >= boundary) {  // counts above top: start again above it
      if (tid == 0) sel[SEL_LISTED] = 0;  // read by no block before the fill
      lo = hi + 1;
      hi = 0x7FFFFFFF;
      in_range = A;
      continue;
    }
    pick_bin(gh, boundary - A, wsum, &pick_d);
    const int d = pick_d;
    if (d < 0) break;  // fewer live counts than the boundary: T = 0
    if (fin) {
      T = (int)(lo + d);
      break;
    }
    in_range = __ldcg(gh + d);
    lo += (long long)d << sh;
    hi = min(hi, lo + (1ll << sh) - 1);
  }
  // the listed slots hold every count in [lo, hi] when the last pass was a
  // later one (it put those above hi in) or found none above hi
  const int n_list = __ldcg(sel + SEL_LISTED);
  const bool from_list =
      list_all && (pass > 0 || __ldcg(sel + SEL_ABOVE + pass) == 0) && n_list <= slot_cap;
  if (from_list) {
    for (int i = tid; i < n_list; i += nthreads) {
      const int s = slots[i];
      const int c = cnts[s];
      if (c > T) put += hot_put(hkeys, hcnts, hslots, ctl, keys[s], c, true);
    }
  } else {
    const long long ins_hi = fin && pass > 0 ? hi : 0x7FFFFFFFll;
    for (int s = tid; s < cap; s += nthreads) {
      const int c = cnts[s];
      if (c > T && c <= ins_hi) put += hot_put(hkeys, hcnts, hslots, ctl, keys[s], c, true);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) put += __shfl_xor_sync(kFullMask, put, o);
  if (lane == 0 && put) atomicAdd(&blk_put, put);
  if (tid == 0) ctl[THRESH] = T;
  // the last block out leaves the scratch zeroed for the next run
  __syncthreads();
  if (threadIdx.x == 0 && blk_put) atomicAdd(ctl + HOCC, blk_put);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd((unsigned *)(sel + SEL_TICKET), 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  for (int i = threadIdx.x; i < (pass + 1) * kBins; i += blockDim.x) sel[i] = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    if (2ll * __ldcg(ctl + HOCC) > (long long)hslots) ctl[HOT_OVF] = 1;
    for (int p = 0; p < kPasses; ++p) sel[SEL_ABOVE + p] = 0;
    sel[SEL_LISTED] = 0;
    sel[SEL_TICKET] = 0;
    sel[SEL_RUNS] += 1;
  }
}

// One wave of resplit_kernel, no more blocks than the table's int4 loads
// need: every block resident, as the grid barrier needs (the launches are
// cooperative, which checks it).
int resplit_grid(int cap) {
  static int wave = 0;
  if (!wave) wave = one_wave(resplit_kernel, 0, kSplitThreads);
  const int need = (cap / 4 + kSplitThreads - 1) / kSplitThreads;
  return need < 1 ? 1 : (need < wave ? need : wave);
}

// -- the round graph ------------------------------------------------------------
//
// v5's round as one CUDA graph that the host replays n times a batch:
// tier_hot -> tier_full -> tier_find -> tier_apply -> IF(resplit_due) {
// resplit }.  tier_apply's last block sets the IF node's value on the card
// (cudaGraphSetConditional; the value resets to 0 at each replay), so a
// round that needs no resplit launches nothing for it, and the host neither
// reads the card nor calls Python per round.  The graph holds the state's
// pointers and sizes: the host builds another when they change (a resize, a
// rebuild, a fold) and updates tier_hot's `limit` in place between segments.

struct RoundGraph {
  cudaGraph_t graph = nullptr;  // kept: its tier_hot node is updated in exec
  cudaGraphExec_t exec = nullptr;
  cudaGraphNode_t hot = nullptr;
  cudaKernelNodeParams hot_params{};
  // tier_hot_kernel's arguments, which hot_params points at
  const unsigned long long *hkeys;
  const int32_t *hcnts;
  int hslots;
  unsigned long long *blk_hi;
  uint32_t *blk_lo;
  unsigned *ticket;
  int32_t *ctl, *cand, *rules;
  int limit, vocab, used_ids0, k;
  bool wide;
  void *hot_args[14];
};

cudaError_t add_kernel(cudaGraphNode_t *node, cudaGraph_t g, const cudaGraphNode_t *dep,
                       const void *fn, int grid, int threads, int smem, void **args) {
  cudaKernelNodeParams kp{};
  kp.func = const_cast<void *>(fn);
  kp.gridDim = dim3(grid);
  kp.blockDim = dim3(threads);
  kp.sharedMemBytes = smem;
  kp.kernelParams = args;
  return cudaGraphAddKernelNode(node, g, dep, dep ? 1 : 0, &kp);
}

template <int P>
cudaError_t add_apply_nodes(cudaGraph_t g, cudaGraphNode_t *dep, int32_t *tok, int32_t *wid,
                            const int32_t *freq, uint32_t *sig, int B, int NB, int32_t *rows,
                            int32_t *hits, int32_t *ctl, const int32_t *cand,
                            unsigned long long *keys, int32_t *cnts, int cap,
                            unsigned long long *hkeys, int32_t *hcnts, int hslots, int kb1,
                            int kb2, cudaGraphConditionalHandle gate) {
  ApplyPlan pl;
  cudaError_t e = apply_plan<P>(B, NB, &pl);
  if (e != cudaSuccess) return e;
  void *fa[] = {&tok, &sig, &B, &NB, &ctl, &cand, &rows, &hits};
  cudaGraphNode_t find;
  e = add_kernel(&find, g, dep, (const void *)tier_find_kernel<P>, pl.find_grid, kRowThreads, 0, fa);
  if (e != cudaSuccess) return e;
  int gated = 1;
  void *aa[] = {&tok, &wid, &freq, &sig, &B, &ctl, &cand, &keys, &cnts, &cap, &hkeys, &hcnts,
                &hslots, &rows, &hits, &kb1, &kb2, &gate, &gated};
  return add_kernel(dep, g, &find, (const void *)tier_apply_kernel<P>, pl.apply_grid, kRowThreads,
                    pl.apply_smem, aa);
}

cudaError_t add_node(cudaGraphNode_t *node, cudaGraph_t g, const cudaGraphNode_t *dep,
                     cudaGraphNodeParams *p) {
#if CUDART_VERSION >= 13000
  return cudaGraphAddNode(node, g, dep, nullptr, 1, p);
#else
  return cudaGraphAddNode(node, g, dep, 1, p);
#endif
}

// -- fold_rows ---------------------------------------------------------------
//
// The plan runs only where the JAX host loop would check the fold: at a
// segment end with more rows than YTTM_TRAIN_FOLD_MIN and the live tokens
// below 45 % of the slots (fold_wanted).  The live count is kept on the
// card: tier_count_kernel sets ctl[LIVE] from the stream, every block of
// tier_apply_kernel subtracts the tokens its merges removed (one atomic a
// block), and a fold moves tokens without changing their number; the host
// reads it with the rest of ctl at the segment end.  The old design planned
// at every segment end (30 plans for 1 fold at the 100 MB point): a memset
// and five launches, 3.3 ms in all (torch.profiler, H100 80GB HBM3, 700 W):
// the fills a warp a 64-slot row by 4-byte loads with one global atomic a
// row on LIVE (2.2 ms), and a scan by one block whose threads each walked
// the ~540 block histograms serially (0.85 ms).
//
// When it runs, the plan is one cooperative launch (a wave of blocks, every
// one resident), with a grid barrier between its steps:
//   1. each block takes a contiguous run of rows: their fills by 16-byte
//      loads (a group of B/4 lanes a row, summed by shuffles), kept in
//      shared memory and written out, and the block's histogram of the
//      fills in shared memory, written bin-major (ghist[v * G + g]);
//   2. each bin's column over the blocks scanned by one block in shared
//      memory (a block per bin), its total kept after the columns;
//   3. every block scans the totals over the bins (<= 513 values) to each
//      fill's first rank, places its rows stably (warp 0: 32 rows a step,
//      ranked by __match_any_sync, into order), and its other warps take
//      the pair check: the fill at rank i from the scanned totals (binary
//      search), max over i < NB/2 of fill(i) + fill(NB-1-i) into FOLD_MAX
//      (one atomic a block).  The order is torch.sort(fills, stable=True)'s,
//      the JAX fold's.
// The fold's write (fold_write_kernel) stays a second launch, after the host
// reads FOLD_MAX: the write is needed only when the pairs fit a row.
//
// Bound: a plan reads the stream's tokens (4 B a slot) and writes the fills
// and the order (8 B a row): ~11 us at the 100 MB point's first plan
// (138,240 rows of 64).

constexpr int kFoldThreads = 512;
constexpr int kFoldRowsPerBlock = 256;  // the grid: a block per 256 rows, one wave at most
constexpr int kFoldMaxBlocks = 1024;    // a bin's column, scanned in shared memory
constexpr int kFoldRows = 4096;         // a block's fills kept in shared memory

// Exclusive scan of a[0, n) in place (shared memory), by the whole block,
// each thread a contiguous run; returns the total.  Every thread calls it.
__device__ int block_scan(int *a, int n, int *wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += a[i];
  int incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFullMask, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFullMask, w, o);
      if (lane >= o) w += v;
    }
    __syncwarp();
    if (lane < nw) wsum[lane] = w;
  }
  __syncthreads();
  int run = incl - s + (warp ? wsum[warp - 1] : 0);
  const int total = wsum[nw - 1];
  for (int i = lo; i < hi; ++i) {
    const int c = a[i];
    a[i] = run;
    run += c;
  }
  __syncthreads();
  return total;
}

// The fill at rank i of the sorted fills, from first[v] (the first rank of
// fill v, v = 0..B, nondecreasing): the last v with first[v] <= i.
__device__ __forceinline__ int fill_at(const int *first, int B, int i) {
  int lo = 0, hi = B;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (first[mid] <= i) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__global__ void __launch_bounds__(kFoldThreads)
    fold_plan_kernel(const int32_t *tok, int B, int NB, bool vec, int32_t *fills, int32_t *ghist,
                     int32_t *order, int32_t *ctl, int32_t *sel) {
  __shared__ int hist[kMaxB + 1];  // the block's histogram, then its rows' next places
  __shared__ int buf[kFoldMaxBlocks > kMaxB + 1 ? kFoldMaxBlocks : kMaxB + 1];
  __shared__ int sfill[kFoldRows];
  __shared__ int wsum[kFoldThreads / 32];
  __shared__ int blk_best;
  unsigned gen = 0;
  if (threadIdx.x == 0) gen = *(volatile unsigned *)(sel + SEL_GEN);
  const int G = gridDim.x, g = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (NB + G - 1) / G;
  const int r0 = min(NB, g * per), r1 = min(NB, r0 + per);
  for (int v = threadIdx.x; v <= B; v += blockDim.x) hist[v] = 0;
  if (threadIdx.x == 0) blk_best = 0;
  if (g == 0 && threadIdx.x == 0) ctl[FOLD_MAX] = 0;
  __syncthreads();
  auto record = [&](int r, int f) {
    fills[r] = f;
    if (r - r0 < kFoldRows) sfill[r - r0] = f;
    atomicAdd(hist + f, 1);
  };
  // 1. fills and the block's histogram
  const int q = B >> 2;  // int4 a row
  const int4 *t4 = reinterpret_cast<const int4 *>(tok);
  if (vec && q <= 32 && (q & (q - 1)) == 0) {  // a group of q lanes a row
    const int rpp = blockDim.x / q;
    for (int rb = r0; rb < r1; rb += rpp) {
      const int r = rb + (int)threadIdx.x / q, part = threadIdx.x & (q - 1);
      int f = 0;
      if (r < r1) {
        const int4 x = __ldg(t4 + (size_t)r * q + part);
        f = (x.x >= 0) + (x.y >= 0) + (x.z >= 0) + (x.w >= 0);
      }
      for (int o = q >> 1; o > 0; o >>= 1) f += __shfl_xor_sync(kFullMask, f, o);
      if (r < r1 && part == 0) record(r, f);
    }
  } else {  // a warp a row
    for (int r = r0 + warp; r < r1; r += blockDim.x >> 5) {
      int f = 0;
      if (vec) {
        for (int j = lane; j < q; j += 32) {
          const int4 x = __ldg(t4 + (size_t)r * q + j);
          f += (x.x >= 0) + (x.y >= 0) + (x.z >= 0) + (x.w >= 0);
        }
      } else {
        for (int j = lane; j < B; j += 32) f += __ldg(tok + (size_t)r * B + j) >= 0;
      }
      f = __reduce_add_sync(kFullMask, f);
      if (lane == 0) record(r, f);
    }
  }
  __syncthreads();
  for (int v = threadIdx.x; v <= B; v += blockDim.x) ghist[(size_t)v * G + g] = hist[v];
  grid_sync(sel, gen);
  // 2. each bin's column over the blocks: a block a bin
  int32_t *tot = ghist + (size_t)(B + 1) * G;
  for (int v = g; v <= B; v += G) {
    for (int j = threadIdx.x; j < G; j += blockDim.x) buf[j] = __ldcg(ghist + (size_t)v * G + j);
    __syncthreads();
    const int total = block_scan(buf, G, wsum);
    for (int j = threadIdx.x; j < G; j += blockDim.x) ghist[(size_t)v * G + j] = buf[j];
    if (threadIdx.x == 0) tot[v] = total;
    __syncthreads();
  }
  grid_sync(sel, gen);
  // 3. each fill's first rank, then the block's rows placed and the pairs checked
  for (int v = threadIdx.x; v <= B; v += blockDim.x) buf[v] = __ldcg(tot + v);
  __syncthreads();
  block_scan(buf, B + 1, wsum);
  for (int v = threadIdx.x; v <= B; v += blockDim.x)
    hist[v] = buf[v] + __ldcg(ghist + (size_t)v * G + g);
  __syncthreads();
  int best = 0;
  if (warp == 0) {  // stable: rows in index order within each fill
    for (int b = r0; b < r1; b += 32) {
      const int r = b + lane;
      const bool ok = r < r1;
      const int v = ok ? (r - r0 < kFoldRows ? sfill[r - r0] : __ldcg(fills + r)) : B + 1 + lane;
      const unsigned same = __match_any_sync(kFullMask, v);
      if (ok) order[hist[v] + __popc(same & ((1u << lane) - 1u))] = r;
      __syncwarp();
      if (ok && 31 - __clz(same) == lane) hist[v] += __popc(same);
      __syncwarp();
    }
  } else {
    const int nc = blockDim.x - 32;
    for (int i = g * nc + (int)threadIdx.x - 32; i < NB / 2; i += G * nc) {
      const int s = fill_at(buf, B, i) + fill_at(buf, B, NB - 1 - i);
      best = s > best ? s : best;
    }
  }
  best = __reduce_max_sync(kFullMask, best);
  if (lane == 0 && best) atomicMax(&blk_best, best);
  __syncthreads();
  if (threadIdx.x == 0 && blk_best) atomicMax(ctl + FOLD_MAX, blk_best);
}

// One wave of fold_plan_kernel, a block per kFoldRowsPerBlock rows.
int fold_grid(int NB) {
  static int wave = 0;
  if (!wave) wave = one_wave(fold_plan_kernel, 0, kFoldThreads);
  int most = wave < kFoldMaxBlocks ? wave : kFoldMaxBlocks;
  const int need = (NB + kFoldRowsPerBlock - 1) / kFoldRowsPerBlock;
  return need < 1 ? 1 : (need < most ? need : most);
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

// One round's apply (count_mode: count every row into the full table,
// rebuild every signature and add the live tokens to ctl[LIVE]; the caller
// emptied the table and zeroed OCC, OVERFLOW and LIVE).  rows holds NB
// entries of scratch; hits kHitsN, zero (each round leaves them so) and
// 8-byte aligned.
int yttm_tiered_apply(void *tok, void *wid, const void *freq, void *sig, int B, int NB,
                      void *rows, void *hits, void *ctl, const void *cand,
                      void *keys, void *cnts, int cap, void *hkeys, void *hcnts, int hslots,
                      int count_mode, int kb1, int kb2, void *stream) {
  if (B < 1 || B > kMaxB || NB <= 0 || cap <= 0 || hslots <= 0 || ((uintptr_t)hits & 7u))
    return (int)cudaErrorInvalidValue;
  cudaError_t (*launch)(int32_t *, int32_t *, const int32_t *, uint32_t *, int, int, int32_t *,
                        int32_t *, int32_t *, const int32_t *, unsigned long long *,
                        int32_t *, int, unsigned long long *, int32_t *, int, int, int, int,
                        cudaStream_t) =
      B <= 32 ? &launch_apply<1> : B <= 64 ? &launch_apply<2> : B <= 128 ? &launch_apply<4>
      : B <= 256 ? &launch_apply<8> : &launch_apply<16>;
  return (int)launch((int32_t *)tok, (int32_t *)wid, (const int32_t *)freq, (uint32_t *)sig, B, NB,
                     (int32_t *)rows, (int32_t *)hits, (int32_t *)ctl,
                     (const int32_t *)cand, (unsigned long long *)keys, (int32_t *)cnts, cap,
                     (unsigned long long *)hkeys, (int32_t *)hcnts, hslots, count_mode, kb1, kb2,
                     (cudaStream_t)stream);
}

// The blocks of tier_apply_kernel's launch (one wave) for rows of B slots:
// each sends the tokens its merges removed in its ticket (for the bound).
int yttm_tiered_apply_grid(int B) {
  if (B < 1 || B > kMaxB) return -(int)cudaErrorInvalidValue;
  ApplyPlan pl;
  cudaError_t (*plan)(int, int, ApplyPlan *) = B <= 32 ? &apply_plan<1> : B <= 64 ? &apply_plan<2>
      : B <= 128 ? &apply_plan<4> : B <= 256 ? &apply_plan<8> : &apply_plan<16>;
  const cudaError_t e = plan(B, 1, &pl);
  return e == cudaSuccess ? pl.apply_grid : -(int)e;
}

// After a refresh round that merged: T and the hot table (a no-op on any
// other round).  sel holds SEL_N entries of scratch, zero before the first
// call (each call leaves them so, but for its count of runs); slots
// slot_cap entries; cand the round's accepted rows.  cnts is 16-byte
// aligned and cap a multiple of 4.
int yttm_tiered_resplit(const void *keys, const void *cnts, int cap, void *hkeys, void *hcnts,
                        int hslots, void *ctl, void *sel, void *slots, int slot_cap,
                        const void *cand, int boundary, void *stream) {
  if (cap <= 0 || (cap & 3) || hslots <= 0 || boundary < 1 || slot_cap < 0 ||
      ((uintptr_t)cnts & 15u))
    return (int)cudaErrorInvalidValue;
  void *args[] = {&keys, &cnts, &cap, &hkeys, &hcnts, &hslots, &ctl, &sel, &slots, &slot_cap,
                  &cand, &boundary};
  return (int)cudaLaunchCooperativeKernel((const void *)resplit_kernel, dim3(resplit_grid(cap)),
                                          dim3(kSplitThreads), args, 0, (cudaStream_t)stream);
}

// Frees a graph of yttm_tiered_graph (null: nothing).
int yttm_tiered_graph_free(void *graph) {
  RoundGraph *rg = (RoundGraph *)graph;
  if (!rg) return 0;
  cudaError_t e = rg->exec ? cudaGraphExecDestroy(rg->exec) : cudaSuccess;
  if (rg->graph) {
    const cudaError_t f = cudaGraphDestroy(rg->graph);
    if (e == cudaSuccess) e = f;
  }
  delete rg;
  return (int)e;
}

// The round graph (see its section) over the state's buffers, with the
// arguments of yttm_tiered_select, yttm_tiered_apply (count_mode 0) and
// yttm_tiered_resplit; *out gets a handle for yttm_tiered_graph_launch and
// yttm_tiered_graph_free.
int yttm_tiered_graph(void **out, const void *keys, const void *cnts, int cap, const void *hkeys,
                      const void *hcnts, int hslots, void *blk_hi, void *blk_lo, int hn_blk,
                      int fn_blk, void *ticket, void *ctl, void *cand, void *rules, int limit,
                      int vocab, int used_ids0, int k, void *tok, void *wid, const void *freq,
                      void *sig, int B, int NB, void *rows, void *hits, int kb1, int kb2, void *sel,
                      void *slots, int slot_cap, int boundary) {
  *out = nullptr;
  if (cap <= 0 || (cap & 3) || hslots <= 0 || hn_blk <= 0 || fn_blk <= 0 ||
      hn_blk > kSelMaxBlocks || fn_blk > kSelMaxBlocks || k <= 0 || k > kK || B < 1 ||
      B > kMaxB || NB <= 0 || boundary < 1 || slot_cap < 0 || ((uintptr_t)cnts & 15u) ||
      ((uintptr_t)hcnts & 15u) || ((uintptr_t)hits & 7u))
    return (int)cudaErrorInvalidValue;
  RoundGraph *rg = new RoundGraph();
  rg->hkeys = (const unsigned long long *)hkeys;
  rg->hcnts = (const int32_t *)hcnts;
  rg->hslots = hslots;
  rg->blk_hi = (unsigned long long *)blk_hi;
  rg->blk_lo = (uint32_t *)blk_lo;
  rg->ticket = (unsigned *)ticket;
  rg->ctl = (int32_t *)ctl;
  rg->cand = (int32_t *)cand;
  rg->rules = (int32_t *)rules;
  rg->limit = limit;
  rg->vocab = vocab;
  rg->used_ids0 = used_ids0;
  rg->k = k;
  rg->wide = vocab > 65536;
  void *ha[] = {&rg->hkeys, &rg->hcnts, &rg->hslots, &rg->blk_hi, &rg->blk_lo, &rg->ticket,
                &rg->ctl, &rg->cand, &rg->rules, &rg->limit, &rg->vocab, &rg->used_ids0, &rg->k,
                &rg->wide};
  for (int i = 0; i < 14; ++i) rg->hot_args[i] = ha[i];
  cudaGraph_t g = nullptr;
  cudaGraphConditionalHandle gate;
  cudaGraphNode_t dep, cond;
  cudaGraphNodeParams cp{};
  cudaError_t e = cudaGraphCreate(&g, 0);
  if (e == cudaSuccess) e = cudaGraphConditionalHandleCreate(&gate, g, 0, cudaGraphCondAssignDefault);
  if (e == cudaSuccess) {
    rg->hot_params.func = (void *)tier_hot_kernel;
    rg->hot_params.gridDim = dim3(hn_blk);
    rg->hot_params.blockDim = dim3(kSelThreads);
    rg->hot_params.kernelParams = rg->hot_args;
    e = cudaGraphAddKernelNode(&rg->hot, g, nullptr, 0, &rg->hot_params);
  }
  if (e == cudaSuccess) {
    bool wide = rg->wide;
    void *fa[] = {&keys, &cnts, &cap, &blk_hi, &blk_lo, &ticket, &ctl, &cand, &rules, &vocab,
                  &used_ids0, &k, &wide};
    e = add_kernel(&dep, g, &rg->hot, (const void *)tier_full_kernel, fn_blk, kSelThreads, 0, fa);
  }
  if (e == cudaSuccess) {
    auto add = B <= 32 ? &add_apply_nodes<1> : B <= 64 ? &add_apply_nodes<2>
             : B <= 128 ? &add_apply_nodes<4> : B <= 256 ? &add_apply_nodes<8>
             : &add_apply_nodes<16>;
    e = add(g, &dep, (int32_t *)tok, (int32_t *)wid, (const int32_t *)freq, (uint32_t *)sig, B, NB,
            (int32_t *)rows, (int32_t *)hits, (int32_t *)ctl,
            (const int32_t *)cand, (unsigned long long *)keys, (int32_t *)cnts, cap,
            (unsigned long long *)hkeys, (int32_t *)hcnts, hslots, kb1, kb2, gate);
  }
  if (e == cudaSuccess) {
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = gate;
    cp.conditional.type = cudaGraphCondTypeIf;
    cp.conditional.size = 1;
    e = add_node(&cond, g, &dep, &cp);
  }
  if (e == cudaSuccess) {
    cudaGraphNode_t split;
    void *sa[] = {&keys, &cnts, &cap, &hkeys, &hcnts, &hslots, &ctl, &sel, &slots, &slot_cap,
                  &cand, &boundary};
    e = add_kernel(&split, cp.conditional.phGraph_out[0], nullptr, (const void *)resplit_kernel,
                   resplit_grid(cap), kSplitThreads, 0, sa);
    if (e == cudaSuccess) {
      cudaKernelNodeAttrValue v{};
      v.cooperative = 1;
      e = cudaGraphKernelNodeSetAttribute(split, cudaLaunchAttributeCooperative, &v);
    }
  }
  if (e == cudaSuccess) e = cudaGraphInstantiate(&rg->exec, g, 0);
  rg->graph = g;
  if (e != cudaSuccess) {
    yttm_tiered_graph_free(rg);
    return (int)e;
  }
  *out = rg;
  return 0;
}

// n replays of the round graph on `stream`, tier_hot's limit set first.
int yttm_tiered_graph_launch(void *graph, int n, int limit, void *stream) {
  RoundGraph *rg = (RoundGraph *)graph;
  if (!rg || n < 0) return (int)cudaErrorInvalidValue;
  if (limit != rg->limit) {
    rg->limit = limit;
    cudaError_t e = cudaGraphExecKernelNodeSetParams(rg->exec, rg->hot, &rg->hot_params);
    if (e != cudaSuccess) return (int)e;
  }
  for (int i = 0; i < n; ++i) {
    cudaError_t e = cudaGraphLaunch(rg->exec, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}


// The fold's plan (fold_plan_kernel, one cooperative launch): the rows'
// fills, their stable order by fill and ctl[FOLD_MAX]; ctl[LIVE] is left as
// it is.  ghist holds (B + 1) * (min(ceil(NB / 256), 1024) + 1) entries of
// scratch; sel is the resplit's scratch (the plan shares its grid barrier,
// which each launch leaves ready for the next).
int yttm_tiered_fold_plan(const void *tok, int B, int NB, void *fills, void *ghist, void *order,
                          void *ctl, void *sel, void *stream) {
  if (B < 1 || B > kMaxB || NB < 2) return (int)cudaErrorInvalidValue;
  bool vec = (B & 3) == 0 && ((uintptr_t)tok & 15u) == 0;
  void *args[] = {&tok, &B, &NB, &vec, &fills, &ghist, &order, &ctl, &sel};
  return (int)cudaLaunchCooperativeKernel((const void *)fold_plan_kernel, dim3(fold_grid(NB)),
                                          dim3(kFoldThreads), args, 0, (cudaStream_t)stream);
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
