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
//   apply_blocks  one thread a row tests the row's signature against the
//                 accepted pairs and lists the rows that may hold one; one
//                 warp a listed row finds the hits (pairs never cross a word:
//                 wid equality guards every pair), takes the words with a
//                 hit out of both tables, merges (run parity per word),
//                 front-compacts the row in order, puts the words back, and
//                 rebuilds the row's signature; a last thread counts the
//                 round's stats.  In count mode (start, rebuild) every row's
//                 pairs go into an empty full table.
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
// that may hold a hit.

#include <cstdint>
#include <cuda_runtime.h>

#include "train_common.cuh"

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
constexpr int kApplyWarps = 4;

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

__global__ void __launch_bounds__(256)
    sig_filter_kernel(const uint32_t *sig, int NB, int32_t *ctl, const int32_t *cand,
                      int32_t *rows) {
  __shared__ int wx[kK], wy[kK];
  __shared__ uint32_t bx[kK], by[kK];
  const int n = ctl[NACC];
  if (n == 0) return;
  if (threadIdx.x < n) {
    const int px = sig_pos(cand[threadIdx.x * 4]), py = sig_pos(cand[threadIdx.x * 4 + 1]);
    wx[threadIdx.x] = px >> 5;
    bx[threadIdx.x] = 1u << (px & 31);
    wy[threadIdx.x] = py >> 5;
    by[threadIdx.x] = 1u << (py & 31);
  }
  __syncthreads();
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < NB; r += gridDim.x * blockDim.x) {
    uint32_t w[kSigW];
    const uint4 *src = reinterpret_cast<const uint4 *>(sig + (size_t)r * kSigW);
#pragma unroll
    for (int q = 0; q < kSigW / 4; ++q) {
      const uint4 v = src[q];
      w[4 * q] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
    bool flag = false;
    for (int j = 0; j < n && !flag; ++j) {
      uint32_t ax = 0, ay = 0;
#pragma unroll
      for (int q = 0; q < kSigW; ++q) {
        ax |= q == wx[j] ? w[q] : 0u;
        ay |= q == wy[j] ? w[q] : 0u;
      }
      flag = (ax & bx[j]) && (ay & by[j]);
    }
    if (flag) rows[atomicAdd(ctl + NBAFF, 1)] = r;
  }
}

// A warp's row in shared memory.
struct RowBuf {
  int32_t t[kMaxB];
  int32_t w[kMaxB];
  int16_t ws[kMaxB];  // start of the word at each position (before the merge)
  uint8_t wa[kMaxB];  // by word start: the word holds a hit
  uint8_t pa[kMaxB];  // by position, after the merge: its word held a hit
  uint32_t sig[kSigW];
};

// The token after position i within its word (PAD at a word's end).
__device__ __forceinline__ int32_t next_in_word(const RowBuf &rb, int i, int B, int32_t w) {
  return (i + 1 < B && rb.w[i + 1] == w) ? rb.t[i + 1] : kPad;
}

// Adds +f (kind kAdd or kCount) for every counted pair of the row's words
// that `all` or pa[] selects, into the full table, and (hot) into the hot
// table; rebuilds the row's signature in rb.sig.  All 32 lanes call it.
__device__ void add_row(RowBuf &rb, int B, const int32_t *freq, unsigned long long *keys,
                        int32_t *cnts, int cap, unsigned long long *hkeys, int32_t *hcnts,
                        int hslots, int32_t *ctl, bool all, bool hot, int zlo, Mode mode) {
  const int lane = threadIdx.x & 31;
  if (lane < kSigW) rb.sig[lane] = 0u;
  __syncwarp();
  int carry = -1;
  for (int b = 0; b < B; b += 32) {
    const int i = b + lane;
    const int32_t a = i < B ? rb.t[i] : kPad;
    const int32_t w = i < B ? rb.w[i] : -1;
    const int32_t nb = i < B ? next_in_word(rb, i, B, w) : kPad;
    const bool pairv = a >= 0 && nb >= 0;
    const bool eq = pairv && a == nb;
    int lne = warp_max_scan(eq ? -1 : i);
    lne = lne > carry ? lne : carry;
    if (pairv && (!eq || ((i - lne - 1) & 1) == 0) && (all || rb.pa[i])) {
      const unsigned long long key = pair_key(a, nb);
      const int32_t f = freq[w];
      table_add<OCC, OVERFLOW, ERROR>(keys, cnts, cap, ctl, key, f, mode);
      if (hot) hot_add(hkeys, hcnts, hslots, ctl, key, f, a >= zlo || nb >= zlo);
    }
    if (a >= 0) {
      const int p = sig_pos(a);
      atomicOr(rb.sig + (p >> 5), 1u << (p & 31));
    }
    carry = __shfl_sync(0xFFFFFFFFu, lne, 31);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(32 * kApplyWarps)
    apply_rows_kernel(int32_t *tok, int32_t *wid, const int32_t *freq, uint32_t *sig, int B,
                      int NB, const int32_t *rows, int32_t *ctl, const int32_t *cand,
                      unsigned long long *keys, int32_t *cnts, int cap,
                      unsigned long long *hkeys, int32_t *hcnts, int hslots, int count_mode) {
  __shared__ RowBuf bufs[kApplyWarps];
  __shared__ int32_t sx[kK], sy[kK], sz[kK];
  const int n = count_mode ? 0 : ctl[NACC];
  if (!count_mode && n == 0) return;
  if (threadIdx.x < n) {
    sx[threadIdx.x] = cand[threadIdx.x * 4];
    sy[threadIdx.x] = cand[threadIdx.x * 4 + 1];
    sz[threadIdx.x] = cand[threadIdx.x * 4 + 2];
  }
  __syncthreads();
  const int n_rows = count_mode ? NB : ctl[NBAFF];
  const bool hot = !count_mode && !ctl[REFRESH];
  const int zlo = ctl[ZLO];
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  RowBuf &rb = bufs[threadIdx.x >> 5];
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  for (int li = warp; li < n_rows; li += n_warps) {
    const int r = count_mode ? li : rows[li];
    int32_t *trow = tok + (size_t)r * B;
    int32_t *wrow = wid + (size_t)r * B;
    for (int i = lane; i < B; i += 32) {
      rb.t[i] = trow[i];
      rb.w[i] = wrow[i];
      rb.wa[i] = 0;
    }
    __syncwarp();
    if (count_mode) {
      add_row(rb, B, freq, keys, cnts, cap, hkeys, hcnts, hslots, ctl, true, false, 0, kCount);
      if (lane < kSigW) sig[(size_t)r * kSigW + lane] = rb.sig[lane];
      __syncwarp();
      continue;
    }
    // pass A: hits, word starts, the words that hold a hit
    int carry_ws = -1;
    for (int b = 0; b < B; b += 32) {
      const int i = b + lane;
      const int32_t a = i < B ? rb.t[i] : kPad;
      const int32_t w = i < B ? rb.w[i] : -1;
      const int32_t nb = i < B ? next_in_word(rb, i, B, w) : kPad;
      const bool start = i < B && (i == 0 || rb.w[i - 1] != w);
      int ws = warp_max_scan(start ? i : -1);
      ws = ws > carry_ws ? ws : carry_ws;
      if (i < B) rb.ws[i] = (int16_t)ws;
      bool hit = false;
      if (a >= 0 && nb >= 0)
        for (int j = 0; j < n; ++j) hit |= a == sx[j] && nb == sy[j];
      if (hit) rb.wa[ws] = 1;
      carry_ws = __shfl_sync(0xFFFFFFFFu, ws, 31);
    }
    __syncwarp();
    // pass B: old pairs of the hit words out, merge, compact in place; all
    // lanes read a chunk before any lane writes, and writes land at or
    // before the positions read
    int carry_eq = -1, carry_hit = -1, out = 0;
    bool carry_sel = false;
    for (int b = 0; b < B; b += 32) {
      const int i = b + lane;
      const int32_t a = i < B ? rb.t[i] : kPad;
      const int32_t w = i < B ? rb.w[i] : -1;
      const int32_t nb = i < B ? next_in_word(rb, i, B, w) : kPad;
      const bool aff = a >= 0 && rb.wa[rb.ws[i]];
      const bool pairv = a >= 0 && nb >= 0;
      const bool eq = pairv && a == nb;
      int lne = warp_max_scan(eq ? -1 : i);
      lne = lne > carry_eq ? lne : carry_eq;
      if (aff && pairv && (!eq || ((i - lne - 1) & 1) == 0)) {
        const unsigned long long key = pair_key(a, nb);
        const int32_t f = freq[w];
        table_add<OCC, OVERFLOW, ERROR>(keys, cnts, cap, ctl, key, -f, kSub);
        if (hot) hot_add(hkeys, hcnts, hslots, ctl, key, -f, false);
      }
      int rix = -1;
      if (pairv)
        for (int j = 0; j < n; ++j)
          if (rix < 0 && a == sx[j] && nb == sy[j]) rix = j;
      const bool hit = rix >= 0;
      int lnh = warp_max_scan(hit ? -1 : i);
      lnh = lnh > carry_hit ? lnh : carry_hit;
      const bool sel = hit && ((i - lnh - 1) & 1) == 0;
      bool prev_sel = __shfl_up_sync(0xFFFFFFFFu, sel, 1);
      if (lane == 0) prev_sel = carry_sel;
      const bool keep = a >= 0 && !prev_sel;
      const unsigned kmask = __ballot_sync(0xFFFFFFFFu, keep);
      __syncwarp();
      if (keep) {
        const int o = out + __popc(kmask & lt);
        rb.t[o] = sel ? sz[rix] : a;
        rb.w[o] = w;
        rb.pa[o] = aff;
      }
      __syncwarp();
      out += __popc(kmask);
      carry_eq = __shfl_sync(0xFFFFFFFFu, lne, 31);
      carry_hit = __shfl_sync(0xFFFFFFFFu, lnh, 31);
      carry_sel = __shfl_sync(0xFFFFFFFFu, sel, 31);
    }
    for (int i = out + lane; i < B; i += 32) {
      rb.t[i] = kPad;
      rb.w[i] = -1;
      rb.pa[i] = 0;
    }
    __syncwarp();
    // pass C: new pairs of the hit words in, the signature rebuilt
    add_row(rb, B, freq, keys, cnts, cap, hkeys, hcnts, hslots, ctl, false, hot, zlo, kAdd);
    for (int i = lane; i < B; i += 32) {
      trow[i] = rb.t[i];
      wrow[i] = rb.w[i];
    }
    if (lane < kSigW) sig[(size_t)r * kSigW + lane] = rb.sig[lane];
    __syncwarp();
  }
}

__global__ void round_end_kernel(int32_t *ctl, int kb1, int kb2) {
  if (!ctl[ACTIVE]) return;
  const int nb = ctl[NBAFF];
  ctl[ST_ROUNDS] += 1;
  ctl[ST_REFRESH] += ctl[REFRESH];
  ctl[ST_MID] += nb > kb1 && nb <= kb2;
  ctl[ST_FULL] += nb > kb2;
  ctl[ACTIVE] = 0;
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
// OVERFLOW).  rows holds NB entries of scratch.
int yttm_tiered_apply(void *tok, void *wid, const void *freq, void *sig, int B, int NB,
                      void *rows, void *ctl, const void *cand, void *keys, void *cnts, int cap,
                      void *hkeys, void *hcnts, int hslots, int count_mode, int kb1, int kb2,
                      void *stream) {
  if (B < 1 || B > kMaxB || NB <= 0 || cap <= 0 || hslots <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int32_t *c = (int32_t *)ctl;
  if (!count_mode) {
    sig_filter_kernel<<<grid_for(NB, 256, 16), 256, 0, s>>>((const uint32_t *)sig, NB, c,
                                                        (const int32_t *)cand, (int32_t *)rows);
  }
  apply_rows_kernel<<<grid_for((long long)NB * 32, 32 * kApplyWarps, 16), 32 * kApplyWarps, 0, s>>>(
      (int32_t *)tok, (int32_t *)wid, (const int32_t *)freq, (uint32_t *)sig, B, NB,
      (const int32_t *)rows, c, (const int32_t *)cand, (unsigned long long *)keys,
      (int32_t *)cnts, cap, (unsigned long long *)hkeys, (int32_t *)hcnts, hslots, count_mode);
  if (!count_mode) round_end_kernel<<<1, 1, 0, s>>>(c, kb1, kb2);
  return (int)cudaGetLastError();
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
