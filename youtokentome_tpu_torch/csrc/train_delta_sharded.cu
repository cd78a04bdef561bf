// The v2 trainer sharded over a data mesh, on Hopper: the shard-local half
// of a round, the exchange and fold into every replica of the table, and the
// re-layout of a shard's stream.
//
// Replaces the JAX programs
//   youtokentome_tpu/parallel/train_delta_sharded.py:81 _train_delta_sharded
//   (per shard: pair_hits, _affected_positions, the old and new
//   _delta_contributions bounded to dcap, apply_accepted; the pmax of the
//   shards' overflow flags; the delta fold, all_gather of the [2*dcap]
//   buffers and _reduce_by_key into the table, or the recount fold, each
//   shard's _full_recount gathered and reduced) and
//   youtokentome_tpu/parallel/train_delta_sharded.py:212 _repack_sharded.
// The plain torch versions are in
// youtokentome_tpu_torch/ops/delta_sharded_kernels.py.
//
// State.  Every shard s keeps, on its device, its word-laid stream (the
// layout of train_delta.cu: word w owns tok[off[w], off[w+1]-1), live tokens
// first, PAD after them, one PAD separator), a replica of the exact
// pair-count table (keys [cap] u64, cnts [cap] int32: train_delta.cu's
// open-addressing table), its ctl (below), a delta buffer dk/dv of 2*dcap
// entries (the round's old contributions at [0, dcap), its new ones at
// [dcap, 2*dcap)) and a scratch table of cap slots for the recount branch.
// The shard's top-k (train_topk.cu) runs on its replica; all replicas fold
// the same entries, so they hold the same keys and counts, take the same
// candidates and keep the same ctl slots USED .. ERROR.
//
// Kernels (one C entry each; a round is topk_accept on every shard and
// delta_emit on every card, then the exchange: shard_recount on every shard
// and fold_rebuild when some shard's buffer overflowed, else fold_delta):
//   delta_emit     one launch for every shard of a card (its section below):
//                  apply_delta's walk and merge (word_apply.cuh), with each
//                  claimed word's old (-f) and new (+f) counted-pair
//                  contributions appended to its shard's buffer, not added
//                  to the table; DOVF is set when either side passes dcap
//                  (the entries past it are dropped).  The merge and
//                  compaction happen in any case.  A contribution is one
//                  counted pair of an affected word with weight > 0, so the
//                  counts equal JAX's _delta_contributions.
//   shard_recount  no-op unless some shard's DOVF is set (the JAX pmax):
//                  clears the shard's scratch table and counts the shard's
//                  stream into it (pair_count.cuh, v2's count).
//   shard_fold     two entries, each one launch for every replica of a card
//                  (its section below).  fold_delta, unless some DOVF is
//                  set: adds every shard's buffer entries into each replica
//                  (a subtraction from a missing key sets ERROR; inserts
//                  that fill more than half the table set OVERFLOW, as in
//                  the one-device engine).  fold_rebuild, only when some
//                  DOVF is set: copies each replica's own shard's scratch
//                  table in (same capacity and hash: a copy, not a rebuild)
//                  and adds the other N-1 scratch tables into it, so it
//                  holds exactly the live keys; a scratch table that
//                  overflowed sets OVERFLOW (the host counts again into
//                  tables twice the size).
//   shard_part_fold, shard_gather
//                  the fold of the engines that recount every round (v1 and
//                  v0, recount_sharded_kernels.py), a reduce-scatter and an
//                  all-gather: a replica's table is cut into N parts
//                  (part_list.cuh: part p the slots [p*cap/N, (p+1)*cap/N),
//                  the keys with key_part == p, probed inside the part).
//                  Each shard's count lists the scratch slots it claimed by
//                  their keys' parts.  shard_part_fold on replica r empties
//                  its part r and adds the entries of every shard's part-r
//                  list into it: each entry is read and inserted once over
//                  all replicas, and no replica reads an empty or
//                  other-part scratch slot (the old fold walked all N
//                  scratch tables on every replica, N^2 x cap slots a
//                  round: 145 us a replica-round against a bound of 1.2 on
//                  the 100 MB sharded v1 run, H100 80GB HBM3, 700 W).  A
//                  list that dropped claims (more keys of the part than the
//                  part has slots) marks the part full, which skips its
//                  fold.  The fold lists every slot it claims in the
//                  replica's fill list of the round (a replica keeps two,
//                  this round's and the last's, turned by the fold on the
//                  card).  Once every replica has folded, shard_gather, one
//                  launch a card for its replicas, copies each other part p
//                  from replica p at the slots of p's two fill lists: part
//                  p was emptied and refilled, so it changed nowhere else
//                  (the old gather copied every slot of the N - 1 other
//                  parts, a launch a replica: 390.5 ms over 23,692 launches
//                  against a bound of 46.98 on the 100 MB sharded v1 run,
//                  H100 80GB HBM3, 700 W), and sums the parts' counts into
//                  OCC (more than half the table, or a full part, sets
//                  OVERFLOW).
//   shard_relay    a plan and a scatter (relay.cuh's flat walks of the
//                  stream and scan.cuh, the one-device v2 engine's too) that
//                  lay a shard's stream out again over its live tokens: words
//                  with fewer than two live tokens (which hold no pair and
//                  never will) are dropped, every other word gets live + 1
//                  slots.  Run at the JAX host loop's repack trigger; the JAX
//                  program slices its front-compacted stream there, which has
//                  no counterpart in a word-laid stream.
//
// The exchange: shard_recount and the fold take device arrays of the
// shards' pointers (ctl, buffers, scratch tables).  On one card every shard
// is on the same device and stream, so the launches' order orders the
// exchange, and the round is a CUDA graph (round_graph.cuh) whose gate
// picks the branch on the card.  The per-call entries serve the engines
// that launch a round from the host: across processes (the host knows the
// branch and launches only its entry), the sharded v3 engine (both entries
// each round, each deciding on the card) and shards on distinct cards,
// which need peer access (the engine enables it or raises) and CUDA events
// between the steps (the engine records them).
//
// Bound.  A round's emit reads each shard's stream once (4 B a slot) and
// reads and writes the claimed words (8 B a slot) and writes its buffer
// entries (12 B each); a delta fold reads every shard's entries and updates
// a table slot for each (24 B an entry); a recount round reads the streams,
// writes each shard's live pairs to its scratch table and reads them once
// (12 B a pair), and writes every replica's live entries (12 B each): the
// slots that hold no pair are not work the function needs.  The kernels add
// these bytes to work[W_EMIT], work[W_COUNT] and work[W_FOLD].  What the design
// does about it: the host replays the round graph a batch of rounds at a
// time and reads shard 0's ctl once a batch (the branch is picked on the
// card); the exchange moves the bounded buffers, not tables, in every round
// without a buffer overflow; and the launches of a round are sized to its
// work (the delta fold's grid to the card, the recount only on rounds that
// recount).

#include <cstdint>
#include <cuda_runtime.h>

#include "pair_count.cuh"
#include "relay.cuh"
#include "round_graph.cuh"
#include "scan.cuh"
#include "shard_exchange.cuh"
#include "train_common.cuh"
#include "word_apply.cuh"

namespace {

using namespace yttm;

// -- delta_emit -------------------------------------------------------------
//
// One launch a round for every shard of a card (a device array of
// EmitShard).  The old emit made two launches a shard (list the words with a
// hit, then a warp a listed word over a grid sized to all the shard's
// words), eight kernel nodes a round on 4 shards: 51.5 us a round against a
// bound of 6.7 (H100 80GB HBM3, 700 W), the rest launch and dependency
// latency, idle warps and same-address atomics (three global atomics a warp
// step of a word's walk).  The design:
//  * a grid of one wave, sized by occupancy, over the concatenation of the
//    card's shards' streams: a step is 8 warps x 256 positions of one shard
//    (each shard's groups of 4 positions cut in steps of its own, so that no
//    group or warp straddles two streams; a shard without words has none),
//    and a block takes a contiguous range of steps (a prefix of the shards'
//    step counts in shared memory maps a step to its shard);
//  * a warp walks its 256 positions, two groups a lane with their loads in
//    flight together (load_group, claim_words; one group a lane, 128
//    positions, took 91.1-91.2 ms over the 100 MB run against 84.3-84.4:
//    chip_smoke.compare_emit, H100 80GB HBM3, 700 W), and merges the words
//    it claimed at once, as apply_delta does: no list, no second launch.  A claimed word is the claimer's alone: another warp reading it
//    meanwhile may see it half merged, but only tests claims, and this word
//    is taken;
//  * short words packed side by side into the warp's 32 lanes (pack_merge);
//    a word longer than 32 slots takes the warp alone (merge_word);
//  * each word sends its whole old word's counted pairs (-f) and its whole
//    new word's (+f), not net deltas: DN_OLD, DN_NEW and DOVF are the JAX
//    _delta_contributions' counts and flags, which pick the round's branch;
//  * entries staged a warp and reserved a block (shard_exchange.cuh's
//    EmitStage, which sparse_emit shares); NAFF, LIVE, W_EMIT and W_ENTRIES
//    are summed in shared memory and sent with the block's reservation.
// Every replica takes the same candidates in the same round (all fold the
// same entries: the header note), so the launch loads shard 0's ctl[NACC],
// ctl[ROUND] and candidates once for the card.

constexpr int kLaneGroups = 2;  // groups of 4 positions a lane takes a step
constexpr int kWarpGroups = 32 * kLaneGroups;
constexpr int kStepGroups = kWarpGroups * kEmitWarps;

// The shared state of an emit block: the staging (shard_exchange.cuh), the
// round's candidates and each warp's words of its step.
struct EmitBlock {
  CandSet c;
  EmitStage st;
  int32_t claimed[kEmitWarps][4 * kWarpGroups];
};

// A shard's steps: its groups of 4 positions (pairs start at 0 .. Mw - 2)
// in steps of kStepGroups; none without words.
__device__ __forceinline__ int emit_steps(const EmitShard *sh) {
  if (sh->W <= 0) return 0;
  const int n_grp = ((int)sh->Mw - 1 + 3) >> 2;
  return (n_grp + kStepGroups - 1) / kStepGroups;
}

__global__ void __launch_bounds__(256, 4)
    delta_emit_kernel(const EmitShard *shards, int n_sh, int dcap) {
  __shared__ EmitBlock sb;
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  emit_open(sb.st, shards, n_sh, [](const EmitShard *sh) { return emit_steps(sh); });
  const int n = load_cand_set(sb.c, shards[0].ctl, shards[0].cand);  // its barriers order pre
  if (n == 0) return;
  if (blockIdx.x == 0 && threadIdx.x < n_sh && shards[threadIdx.x].W > 0)  // the walk's read
    atomicAdd((unsigned long long *)(shards[threadIdx.x].work + W_EMIT),
              4ull * shards[threadIdx.x].Mw);
  const int tag = shards[0].ctl[ROUND];
  const int T = sb.st.pre[n_sh];
  const int lo = (int)((long long)blockIdx.x * T / gridDim.x);
  const int hi = (int)((long long)(blockIdx.x + 1) * T / gridDim.x);
  int cur = -1, n_old = 0, n_new = 0;  // n_old, n_new: this warp's staged entries
  for (int step = lo; step < hi; ++step) {
    cur = emit_shard<LIVE>(sb.st, shards, step, cur, n_old, n_new, dcap);
    const EmitShard &sh = sb.st.cur;
    const int Mw = (int)sh.Mw;
    const int g0 = (step - sb.st.pre[cur]) * kStepGroups + wi * kWarpGroups;
    if (g0 >= ((Mw - 1 + 3) >> 2)) continue;  // past the shard's end: the warp waits
    int32_t *tok = sh.tok;
    // a lane's groups, g0 + lane and 32 on: their loads in flight together
    int32_t t[kLaneGroups][5], w[kLaneGroups][4];
    unsigned mine[kLaneGroups];
#pragma unroll
    for (int j = 0; j < kLaneGroups; ++j) load_group(tok, Mw, g0 + 32 * j + lane, t[j]);
    int claims = 0;
#pragma unroll
    for (int j = 0; j < kLaneGroups; ++j) {
      mine[j] = claim_words(t[j], sh.pwid, Mw, g0 + 32 * j + lane, sb.c, n, tag, sh.wmark, w[j]);
      claims += __popc(mine[j]);
    }
    int total;
    int at = warp_exclusive(claims, total);
    if (total == 0) continue;
    int32_t *mine_w = sb.claimed[wi];
#pragma unroll
    for (int j = 0; j < kLaneGroups; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if ((mine[j] >> q) & 1u) mine_w[at++] = w[j][q];
    __syncwarp();
    int live = 0, slots = 0;  // the words' live tokens gained, their slots
    for (int b = 0; b < total; b += 32) {
      const int cnt = min(32, total - b);
      for_word_packs(
          lane < cnt ? mine_w[b + lane] : -1, cnt, tok, sh.off, sh.fw, 1,
          [&](int base, int len, int32_t f, int start, int ws, unsigned smask, int ptotal) {
            const PackLane p = pack_merge(tok, base, len, f, start, ws, smask, ptotal, sb.c, n);
            emit_stage(sb.st, p.co && p.f > 0, pair_key(p.a, p.nb), -p.f, 0, n_old, dcap);
            emit_stage(sb.st, p.cn && p.f > 0, pair_key(p.v, p.nbn), p.f, 1, n_new, dcap);
            live -= __popc(__ballot_sync(kFullMask, p.a >= 0 && !p.keep));
            slots += ptotal;
            pack_write(p);
          },
          [&](int32_t *tw, int len, int32_t f) {
            int was = 0;
            for (int i = 0; i < len; i += 32)
              was += __popc(__ballot_sync(kFullMask, i + lane < len && tw[i + lane] >= 0));
            const int out = merge_word(tw, len, sb.c, n, [&](bool counted, unsigned long long key, int) {
              emit_stage(sb.st, counted && f > 0, key, -f, 0, n_old, dcap);
            });
            for_word_pairs(tw, out, [&](bool counted, unsigned long long key) {
              emit_stage(sb.st, counted && f > 0, key, f, 1, n_new, dcap);
            });
            live += out - was;
            slots += len;
          });
    }
    emit_sums(sb.st, total, live, slots);
  }
  if (cur >= 0) emit_flush_block<LIVE>(sb.st, n_old, n_new, dcap);
}

// Blocks of delta_emit_kernel that the card holds at once.
int emit_grid() {
  static int blocks = 0;
  if (!blocks) blocks = wave_blocks(delta_emit_kernel, kEmitWarps * 32);
  return blocks;
}

// -- fold --------------------------------------------------------------------
//
// The fold's two entries take every replica of one card in one launch (a
// device array of Replica, below).  The old fold launched three kernels a
// replica a round, each sized to the table's capacity (a 2^22-slot table at
// the 100 MB point): on a delta round ~1,000 blocks read every
// shard's ctl and returned, one thread summed the counts, and 2 * n * dcap
// thread slots tested their index against the round's ~2,700 entries a
// shard: 13.8 us a call against a bound of 54 ns (H100 80GB HBM3, 700 W).
//  * fold_delta: a grid of one wave, sized by occupancy.  Each block reads
//    the 2n counts (DN_OLD, DN_NEW, clamped to dcap) once, a lane a shard,
//    and forms their prefix in shared memory; a thread takes (entry,
//    replica) pairs, entry-major so that the lanes on one entry share its
//    load, and adds it with table_add.  The branch flag (DOVF anywhere:
//    return at once) and the work counter are read and kept in the same
//    launch.  What is left is the launch's chain of dependent loads (the
//    shards' ctl pointers, their counts, an entry, its table slot, the
//    atomic), ~9 us a round on average over the 100 MB run (H100 80GB HBM3,
//    700 W): two blocks an SM and one wave timed the same, and summing a
//    block's share of the entries by key in shared memory first (they
//    repeat their keys) was slower (48.8 ms against 31.0), its flush
//    serialising a thread's global updates.
//  * fold_rebuild: the recount branch, three launches, each a no-op unless
//    some DOVF is set: every replica's own scratch table copied in (same
//    capacity and hash: a copy, not a rebuild), then every scratch table's
//    live entries added into every other replica (a slot read once a card),
//    then the replicas' written entries added to work.

// A replica on the fold's card, as the host lays it out: 7 int64.
struct Replica {
  unsigned long long *keys;
  int32_t *cnts;
  int32_t *ctl;
  long long *work;
  const unsigned long long *own_keys;  // its shard's scratch table
  const int32_t *own_cnts;
  long long self;  // its shard's index
};
static_assert(sizeof(Replica) == 7 * 8, "the host lays a replica out as 7 int64");

__device__ __forceinline__ void load_replicas(Replica *sr, const Replica *reps, int n_rep) {
  for (int r = threadIdx.x; r < n_rep; r += blockDim.x) sr[r] = reps[r];
}

__global__ void __launch_bounds__(256)
    fold_delta_kernel(const Replica *reps, int n_rep, int cap, const int32_t *const *ctls,
                      const unsigned long long *const *dks, const int32_t *const *dvs, int dcap,
                      int n_sh) {
  __shared__ int pre[2 * kMaxShards + 1];  // each (shard, side)'s first entry
  __shared__ bool recount;
  __shared__ Replica sr[kMaxShards];
  __shared__ const unsigned long long *sdk[kMaxShards];
  __shared__ const int32_t *sdv[kMaxShards];
  if (threadIdx.x < 32) {  // a lane a shard: its loads in flight together
    const int lane = threadIdx.x;
    int carry = 0;
    bool any = false;
    for (int b = 0; b < n_sh; b += 32) {
      const int s = b + lane;
      int o = 0, w = 0;
      bool f = false;
      if (s < n_sh) {
        const int32_t *c = ctls[s];
        o = min(__ldcg(c + DN_OLD), dcap);
        w = min(__ldcg(c + DN_NEW), dcap);
        f = __ldcg(c + DOVF) != 0;
        sdk[s] = dks[s];
        sdv[s] = dvs[s];
      }
      int incl = o + w;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(kFullMask, incl, d);
        if (lane >= d) incl += u;
      }
      if (s < n_sh) {
        pre[2 * s] = carry + incl - o - w;
        pre[2 * s + 1] = carry + incl - w;
      }
      carry += __shfl_sync(kFullMask, incl, 31);
      any |= __any_sync(kFullMask, f);
    }
    if (lane == 0) {
      pre[2 * n_sh] = carry;
      recount = any;
    }
  }
  load_replicas(sr, reps, n_rep);
  __syncthreads();
  if (recount) return;
  const int total = pre[2 * n_sh];
  if (blockIdx.x == 0)
    for (int r = threadIdx.x; r < n_rep; r += blockDim.x)
      sr[r].work[W_FOLD] += 24ll * total;  // each entry read, and a table slot updated
  const long long items = (long long)total * n_rep;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < items;
       i += (long long)gridDim.x * blockDim.x) {
    const int e = (int)(i / n_rep), r = (int)(i % n_rep);
    int lo = 0, hi = 2 * n_sh - 1;  // the last (shard, side) starting at or before e
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (pre[mid] <= e) lo = mid;
      else hi = mid - 1;
    }
    const int s = lo >> 1, at = (lo & 1) * dcap + e - pre[lo];
    const int32_t v = sdv[s][at];
    table_add<OCC, OVERFLOW, ERROR>(sr[r].keys, sr[r].cnts, cap, sr[r].ctl, sdk[s][at], v,
                                    v < 0 ? kSub : kAdd);
  }
}

__global__ void __launch_bounds__(256)
    rebuild_copy_kernel(const Replica *reps, int n_rep, int cap, const int32_t *const *ctls,
                        int n_sh) {
  if (!warp_any_flag(ctls, n_sh, DOVF)) return;
  for (int r = 0; r < n_rep; ++r) {
    const Replica p = reps[r];
    for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < cap; s += gridDim.x * blockDim.x) {
      p.keys[s] = p.own_keys[s];
      p.cnts[s] = p.own_cnts[s];
    }
  }
  if (blockIdx.x == 0) {
    const bool rovf = warp_any_flag(ctls, n_sh, ROVF);
    for (int r = threadIdx.x; r < n_rep; r += blockDim.x) {
      int32_t *ctl = reps[r].ctl;
      ctl[OCC] = ctl[ROCC];
      ctl[NREC] += 1;
      if (rovf) ctl[OVERFLOW] = 1;
      // the shard's count wrote its live pairs; the fold reads them once
      // (rebuild_done adds the replica's entries written)
      reps[r].work[W_COUNT] += 12ll * ctl[ROCC];
      reps[r].work[W_FOLD] += 12ll * ctl[ROCC];
    }
  }
}

__global__ void __launch_bounds__(256)
    rebuild_add_kernel(const Replica *reps, int n_rep, int cap, const int32_t *const *ctls,
                       const unsigned long long *const *rkeys, const int32_t *const *rcnts,
                       int n_sh) {
  __shared__ Replica sr[kMaxShards];
  if (!warp_any_flag(ctls, n_sh, DOVF)) return;
  load_replicas(sr, reps, n_rep);
  __syncthreads();
  for (int s = 0; s < n_sh; ++s) {
    const unsigned long long *rk = rkeys[s];
    const int32_t *rc = rcnts[s];
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < cap; j += gridDim.x * blockDim.x) {
      const unsigned long long k = rk[j];
      if (k == kEmpty) continue;
      const int32_t c = rc[j];
      if (c <= 0) continue;
      for (int r = 0; r < n_rep; ++r)
        if (sr[r].self != s)
          table_add<OCC, OVERFLOW, ERROR>(sr[r].keys, sr[r].cnts, cap, sr[r].ctl, k, c, kAdd);
    }
  }
}

// The rebuild's last step: every replica's live entries written; runs[1]
// counts the rebuilds (the round graph's recount branch counts its runs
// here).
__global__ void rebuild_done_kernel(const Replica *reps, int n_rep, const int32_t *const *ctls,
                                    int n_sh, long long *runs) {
  if (!warp_any_flag(ctls, n_sh, DOVF)) return;
  for (int r = threadIdx.x; r < n_rep; r += blockDim.x)
    reps[r].work[W_FOLD] += 12ll * reps[r].ctl[OCC];
  if (threadIdx.x == 0 && runs) runs[1] += 1;
}

// Blocks of fold_delta_kernel that the card holds at once.
int fold_grid() {
  static int blocks = 0;
  if (!blocks) blocks = wave_blocks(fold_delta_kernel, 256);
  return blocks;
}

// -- partitioned fold (v1, v0) ---------------------------------------------------

// Add `delta` to `key` in part [lo, lo + size) of the table: table_add's
// probe, wrapped inside the part; returns the slot (from lo) that the key
// claimed, or -1 (the caller sums the claims into POCC and lists them).  A
// part with no free slot sets POCC past its size (the host then doubles the
// tables).
__device__ int part_add(unsigned long long *keys, int32_t *cnts, long long lo, int size,
                        int32_t *ctl, unsigned long long key, int32_t delta) {
  const unsigned h = (unsigned)hash64(key) % (unsigned)size;
  for (int p = 0; p < size; ++p) {
    if ((p & 31) == 31 && __ldcg(ctl + POCC) > size) return -1;
    unsigned s = h + (unsigned)p;
    if (s >= (unsigned)size) s -= (unsigned)size;
    unsigned long long *slot = keys + lo + s;
    unsigned long long k = __ldcg(slot);
    if (k == kEmpty) {
      k = atomicCAS(slot, kEmpty, key);
      if (k == kEmpty) {
        atomicAdd(cnts + lo + s, delta);
        return (int)s;
      }
    }
    if (k == key) {
      atomicAdd(cnts + lo + s, delta);
      return -1;
    }
  }
  atomicExch(ctl + POCC, size + 1);
  return -1;
}

// Some shard's list of part `self` dropped claims: the part is full.
__device__ __forceinline__ bool part_lost(const int32_t *const *pcnts, int n_sh, int self,
                                          long long size) {
  bool lost = false;
  for (int s = 0; s < n_sh; ++s) lost |= __ldcg(pcnts[s] + self) > size;
  return lost;
}

// A replica's fill lists: the slots of its own part that its fold claimed,
// this round's and the last round's, as two bitmaps (bit i of a list: slot
// part_lo(self) + i), fill_words(cap, n) words each, so that no list can
// overflow; the word after them (kFillSel) picks the list that the next fold
// fills.  The fold's prep empties that list, the fold sets a bit for each
// slot it claims, and the gather, once it has read both lists, turns the
// word for the replicas it wrote.
__host__ __device__ __forceinline__ int fill_words(int cap, int n) {
  return ((cap + n - 1) / n + 31) / 32;
}
__host__ __device__ __forceinline__ int fill_sel(int cap, int n) { return 2 * fill_words(cap, n); }

// Empties the replica's own part and the fill list its fold fills, and
// opens the round's count of the part (POCC past the part's size when a
// list dropped claims).
__global__ void __launch_bounds__(256)
    part_prep_kernel(unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl,
                     const int32_t *const *ctls, const int32_t *const *pcnts, int n_sh, int self,
                     uint32_t *fill, long long *work) {
  const long long lo = part_lo(self, cap, n_sh), hi = part_lo(self + 1, cap, n_sh);
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long s = lo + tid; s < hi; s += stride) {
    keys[s] = kEmpty;
    cnts[s] = 0;
  }
  const int words = fill_words(cap, n_sh);
  uint32_t *bits = fill + (long long)fill[fill_sel(cap, n_sh)] * words;
  for (long long w = tid; w < words; w += stride) bits[w] = 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    ctl[POCC] = part_lost(pcnts, n_sh, self, hi - lo) ? (int32_t)(hi - lo + 1) : 0;
    ctl[NREC] += 1;
    if (any_flag(ctls, n_sh, ROVF)) ctl[OVERFLOW] = 1;
    work[W_FOLD] += 12ll * ctl[ROCC];  // the shard's live pairs, read once
  }
}

// The entries of every shard's list of the replica's part, added into it
// (nothing when a list dropped claims: the part is full); each claimed slot
// set in the round's fill list; the claims summed a warp at a time into
// POCC (an atomic on one address for every claim would serialise them).
__global__ void __launch_bounds__(256)
    part_fold_kernel(unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl,
                     const unsigned long long *const *rkeys, const int32_t *const *rcnts,
                     const int32_t *const *plists, const int32_t *const *pcnts, int n_sh,
                     int self, uint32_t *fill) {
  const long long lo = part_lo(self, cap, n_sh);
  const int size = (int)(part_lo(self + 1, cap, n_sh) - lo);
  if (part_lost(pcnts, n_sh, self, size)) return;
  uint32_t *bits = fill + (long long)__ldg(fill + fill_sel(cap, n_sh)) * fill_words(cap, n_sh);
  const long long stride = (long long)gridDim.x * blockDim.x;
  int claims = 0;
  for (int s = 0; s < n_sh; ++s) {
    const unsigned long long *rk = rkeys[s];
    const int32_t *rc = rcnts[s];
    const int32_t *list = plists[s] + lo;
    const int m = __ldcg(pcnts[s] + self);
    for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < m; j += stride) {
      const int32_t slot = list[j];
      const int32_t c = rc[slot];
      if (c <= 0) continue;
      const int at = part_add(keys, cnts, lo, size, ctl, rk[slot], c);
      if (at >= 0) {
        atomicOr(bits + (at >> 5), 1u << (at & 31));
        ++claims;
      }
    }
  }
  claims = __reduce_add_sync(0xFFFFFFFFu, claims);
  if ((threadIdx.x & 31) == 0 && claims) atomicAdd(ctl + POCC, claims);
}

// The other replicas' parts copied into every replica of one card (reps),
// each part p from replica p at the slots its two fill lists name: part p
// was emptied and refilled, so it changed since the last round only there
// (a slot of the last list alone now holds EMPTY and 0, which clears the
// copies).  One pass over the slots in order, part by part, a thread a
// slot: its bits read, its key and count read once and written to each
// replica of the card but the part's owner.  Then each replica's occupancy
// and overflow from every part's count (the same on every replica), and its
// fill lists turned.  Its bytes, the replica's live entries written, are the
// occupancy that the next top-k sums (W_OCC).
__global__ void __launch_bounds__(256)
    gather_kernel(const Replica *reps, int n_rep, int cap, const int32_t *const *ctls,
                  const unsigned long long *const *tkeys, const int32_t *const *tcnts,
                  uint32_t *const *fills, int n_sh) {
  __shared__ Replica sr[kMaxShards];
  load_replicas(sr, reps, n_rep);
  __syncthreads();
  const int words = fill_words(cap, n_sh);
  const int tid = blockIdx.x * blockDim.x + threadIdx.x, stride = gridDim.x * blockDim.x;
  for (int p = 0; p < n_sh; ++p) {
    if (n_rep == 1 && sr[0].self == p) continue;
    const int lo = (int)part_lo(p, cap, n_sh), size = (int)part_lo(p + 1, cap, n_sh) - lo;
    const uint32_t *f = fills[p];
    const unsigned long long *pk = tkeys[p] + lo;
    const int32_t *pc = tcnts[p] + lo;
    for (int i = tid; i < size; i += stride) {
      if (!(((__ldcg(f + (i >> 5)) | __ldcg(f + words + (i >> 5))) >> (i & 31)) & 1u)) continue;
      const unsigned long long k = __ldcg(pk + i);
      const int32_t c = __ldcg(pc + i);
      for (int r = 0; r < n_rep; ++r)
        if (sr[r].self != p) {
          sr[r].keys[lo + i] = k;
          sr[r].cnts[lo + i] = c;
        }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < n_rep) {
    const Replica &q = sr[threadIdx.x];
    long long occ = 0;
    bool full = false;
    for (int p = 0; p < n_sh; ++p) {
      const int n = __ldcg(ctls[p] + POCC);
      full |= n > part_lo(p + 1, cap, n_sh) - part_lo(p, cap, n_sh);
      occ += n;
    }
    q.ctl[OCC] = (int32_t)(occ < cap ? occ : cap);
    if (full || 2 * occ > cap) q.ctl[OVERFLOW] = 1;
    fills[q.self][fill_sel(cap, n_sh)] ^= 1u;
  }
}

}  // namespace

extern "C" {

// One round's shard-local half on every shard of one card, one launch
// (delta_emit_kernel): each shard's words with an accepted pair merged, and
// their old and new contributions appended to its buffer.  shards: a device
// array of n_sh EmitShard (tok 16-byte aligned: the caller checks; a shard
// with W == 0 is skipped), every buffer of dcap entries a side.
int yttm_shard_delta_emit_card(const void *shards, int n_sh, int dcap, void *stream) {
  if (n_sh <= 0 || n_sh > kMaxShards || dcap <= 0) return (int)cudaErrorInvalidValue;
  delta_emit_kernel<<<emit_grid(), 256, 0, (cudaStream_t)stream>>>((const EmitShard *)shards,
                                                                    n_sh, dcap);
  return (int)cudaGetLastError();
}

// The recount branch's count of one shard into its scratch table, a no-op
// unless some shard's DOVF is set: the table emptied, then pair_count.cuh's
// count into it (ROCC, ROVF).  ctls: a device array of the n_sh shards' ctl
// pointers; tok and pwid (Mw slots) 16-byte aligned.
int yttm_shard_recount(const void *tok, const void *pwid, const void *fw, int Mw, int W,
                       void *rkeys, void *rcnts, int cap, void *ctl, const void *ctls, int n_sh,
                       void *work, void *stream) {
  // a shard without words still clears its scratch table, which every
  // replica reads in a recount round
  if (W < 0 || (W > 0 && Mw <= 0) || cap <= 0 || (cap & (cap - 1)) != 0 || n_sh <= 0 ||
      ((uintptr_t)tok & 15u) || ((uintptr_t)pwid & 15u))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  recount_clear_kernel<<<grid_for(cap, 256), 256, 0, s>>>(
      (unsigned long long *)rkeys, (int32_t *)rcnts, cap, (int32_t *)ctl,
      (const int32_t *const *)ctls, n_sh, Mw, W, (long long *)work);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || W == 0) return (int)e;
  return (int)launch_pair_count<ROCC, ROVF>(
      (const int32_t *)tok, (const int32_t *)pwid, (const int32_t *)fw, Mw,
      (unsigned long long *)rkeys, (int32_t *)rcnts, cap, (int32_t *)ctl,
      (const int32_t *const *)ctls, n_sh, DOVF, s);
}

// The delta fold of every replica on one card (reps: a device array of
// n_rep Replica), one launch: every shard's buffer entries added into each;
// a no-op when some shard's DOVF is set.  ctls, dks, dvs: device arrays of
// the n_sh shards' pointers.
int yttm_shard_fold_delta(const void *reps, int n_rep, int cap, const void *ctls, const void *dks,
                          const void *dvs, int dcap, int n_sh, void *stream) {
  if (n_rep <= 0 || n_rep > n_sh || n_sh > kMaxShards || cap <= 0 || (cap & (cap - 1)) != 0 ||
      dcap <= 0)
    return (int)cudaErrorInvalidValue;
  fold_delta_kernel<<<fold_grid(), 256, 0, (cudaStream_t)stream>>>(
      (const Replica *)reps, n_rep, cap, (const int32_t *const *)ctls,
      (const unsigned long long *const *)dks, (const int32_t *const *)dvs, dcap, n_sh);
  return (int)cudaGetLastError();
}

// The recount branch's fold of every replica on one card, a no-op unless
// some shard's DOVF is set: its own scratch table copied in, the other
// shards' scratch tables (rkeys, rcnts: device arrays of the n_sh shards')
// added, OCC, NREC and OVERFLOW (some ROVF) set.  runs (or null): runs[1]
// counts the rebuilds.
int yttm_shard_fold_rebuild(const void *reps, int n_rep, int cap, const void *ctls,
                            const void *rkeys, const void *rcnts, int n_sh, void *runs,
                            void *stream) {
  if (n_rep <= 0 || n_rep > n_sh || n_sh > kMaxShards || cap <= 0 || (cap & (cap - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Replica *r = (const Replica *)reps;
  const int32_t *const *c = (const int32_t *const *)ctls;
  rebuild_copy_kernel<<<grid_for(cap, 256), 256, 0, s>>>(r, n_rep, cap, c, n_sh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rebuild_add_kernel<<<grid_for(cap, 256), 256, 0, s>>>(
      r, n_rep, cap, c, (const unsigned long long *const *)rkeys, (const int32_t *const *)rcnts,
      n_sh);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rebuild_done_kernel<<<1, 64, 0, s>>>(r, n_rep, c, n_sh, (long long *)runs);
  return (int)cudaGetLastError();
}

// Frees a graph of yttm_shard_graph (null: nothing).
int yttm_shard_graph_free(void *graph) { return shard_graph_free((ShardGraph *)graph); }

// The round graph (round_graph.cuh) of the n_sh shards of one card: every
// shard's top-k, then one delta_emit for them all, the gate, the recount
// branch (every shard's shard_recount, then the rebuild fold) and the delta
// fold.  shards, a host array of n_sh GraphShard; reps, a device array of
// their n_sh Replica; ctls .. rcs, the device arrays of the shards' pointers
// that the per-call entries take; topk, yttm_topk_accept's address; emit, a
// device array of their n_sh EmitShard (yttm_shard_delta_emit_card's);
// limit .. n_own, the top-k's arguments; runs, 2 int64 on the card.  *out
// gets a handle for yttm_shard_graph_launch and yttm_shard_graph_free.
int yttm_shard_graph(void **out, const void *shards, int n_sh, const void *reps, const void *ctls,
                     const void *dks, const void *dvs, const void *rks, const void *rcs, int dcap,
                     void *topk, const void *emit, int limit, int vocab, int used_ids0, int k,
                     int n_own, void *runs) {
  *out = nullptr;
  const GraphShard *sh = (const GraphShard *)shards;
  if (n_sh <= 0 || n_sh > kMaxShards || !topk || !emit || !runs) return (int)cudaErrorInvalidValue;
  bool words = false;  // some shard holds a word: the emit runs
  for (int i = 0; i < n_sh; ++i) {
    if (sh[i].cap != sh[0].cap || (sh[i].tok & 15)) return (int)cudaErrorInvalidValue;
    words |= sh[i].W > 0;
  }
  const int cap = (int)sh[0].cap;
  const TopkFn topk_accept = (TopkFn)topk;
  // every shard's top-k, then the card's merge and buffers
  auto local = [&](cudaStream_t s) {
    cudaError_t e = cudaSuccess;
    for (int i = 0; i < n_sh && e == cudaSuccess; ++i) {
      const GraphShard &q = sh[i];
      e = (cudaError_t)topk_accept((const void *)q.keys, (const void *)q.cnts, (int)q.cap,
                                   (void *)q.blk_hi, (void *)q.blk_lo, (int)q.n_blk,
                                   (void *)q.ticket, (void *)q.ctl, (void *)q.cand,
                                   (void *)q.rules, limit, vocab, used_ids0, k, n_own,
                                   (void *)q.work, s);
    }
    if (e == cudaSuccess && words)  // as the per-call wrapper: no word, no launch
      e = (cudaError_t)yttm_shard_delta_emit_card(emit, n_sh, dcap, s);
    return e;
  };
  // the recount branch: every shard's count, then the rebuild of every replica
  auto recount = [&](cudaStream_t b) {
    cudaError_t e = cudaSuccess;
    for (int i = 0; i < n_sh && e == cudaSuccess; ++i) {
      const GraphShard &q = sh[i];
      e = (cudaError_t)yttm_shard_recount(
          (const void *)q.tok, (const void *)q.pwid, (const void *)q.fw, (int)q.Mw, (int)q.W,
          (void *)q.rkeys, (void *)q.rcnts, cap, (void *)q.ctl, ctls, n_sh, (void *)q.work, b);
    }
    if (e == cudaSuccess)
      e = (cudaError_t)yttm_shard_fold_rebuild(reps, n_sh, cap, ctls, rks, rcs, n_sh, runs, b);
    return e;
  };
  auto delta = [&](cudaStream_t b) {
    return (cudaError_t)yttm_shard_fold_delta(reps, n_sh, cap, ctls, dks, dvs, dcap, n_sh, b);
  };
  return build_round_graph(out, ctls, n_sh, runs, local, recount, delta);
}

// n replays of the round graph on `stream`.
int yttm_shard_graph_launch(void *graph, int n, void *stream) {
  return shard_graph_launch((ShardGraph *)graph, n, (cudaStream_t)stream);
}

// The partitioned fold's first half on the replica of shard `self` (the
// engines that recount every round): its part emptied, then the entries of
// every shard's list of that part added, each slot it claims set in the
// replica's fill lists (fill: 2 * fill_words(cap, n_sh) + 1 int32, zeroed
// with the table).  rkeys, rcnts, plists, pcnts: device arrays of the n_sh
// scratch tables and their part lists (part_list.cuh), as the shards'
// counts left them.  shard_gather follows once every replica ran this.
int yttm_shard_part_fold(void *keys, void *cnts, int cap, void *ctl, const void *ctls,
                         const void *rkeys, const void *rcnts, const void *plists,
                         const void *pcnts, int n_sh, int self, void *fill, void *work,
                         void *stream) {
  if (cap < n_sh || (cap & (cap - 1)) != 0 || n_sh <= 0 || n_sh > kMaxParts || self < 0 ||
      self >= n_sh || !fill)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = grid_for(cap / n_sh + 1, 256);
  part_prep_kernel<<<blocks, 256, 0, s>>>((unsigned long long *)keys, (int32_t *)cnts, cap,
                                          (int32_t *)ctl, (const int32_t *const *)ctls,
                                          (const int32_t *const *)pcnts, n_sh, self,
                                          (uint32_t *)fill, (long long *)work);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  part_fold_kernel<<<blocks, 256, 0, s>>>(
      (unsigned long long *)keys, (int32_t *)cnts, cap, (int32_t *)ctl,
      (const unsigned long long *const *)rkeys, (const int32_t *const *)rcnts,
      (const int32_t *const *)plists, (const int32_t *const *)pcnts, n_sh, self,
      (uint32_t *)fill);
  return (int)cudaGetLastError();
}

// The partitioned fold's second half on the n_rep replicas of one card
// (reps: a device array of Replica), one launch: every other replica's own
// part copied in at the slots of its fill lists, which it then turns.  ctls,
// tkeys, tcnts, fills: device arrays of the n_sh replicas' ctl, tables and
// fill lists.
int yttm_shard_gather(const void *reps, int n_rep, int cap, const void *ctls, const void *tkeys,
                      const void *tcnts, const void *fills, int n_sh, void *stream) {
  if (cap < n_sh || (cap & (cap - 1)) != 0 || n_sh <= 0 || n_sh > kMaxParts || n_rep <= 0 ||
      n_rep > n_sh)
    return (int)cudaErrorInvalidValue;
  gather_kernel<<<fold_grid(), 256, 0, (cudaStream_t)stream>>>(
      (const Replica *)reps, n_rep, cap, (const int32_t *const *)ctls,
      (const unsigned long long *const *)tkeys, (const int32_t *const *)tcnts,
      (uint32_t *const *)fills, n_sh);
  return (int)cudaGetLastError();
}

// int32 slots of scratch a relay of W words needs.
long yttm_shard_relay_scratch(int W) { return yttm_scan::scratch_ints(W > 0 ? W : 1); }

// The relay's plan (relay.cuh) over the stream tok / pwid (Mw slots, both
// 16-byte aligned): each word's new slot count (lens) and keep flag, their
// exclusive scans (new_off, new_idx) and totals (totals[0] the new stream's
// slots, totals[1] its words).
int yttm_shard_relay_plan(const void *tok, const void *pwid, const void *off, int Mw, int W,
                          void *lens, void *keep, void *new_off, void *new_idx, void *scratch,
                          void *totals, void *stream) {
  if (W <= 0 || Mw <= 0 || ((uintptr_t)tok & 15u) || ((uintptr_t)pwid & 15u))
    return (int)cudaErrorInvalidValue;
  return (int)launch_relay_plan((const int32_t *)tok, (const int32_t *)pwid, (const int32_t *)off,
                                Mw, W, (int32_t *)lens, (int32_t *)keep, (int32_t *)new_off,
                                (int32_t *)new_idx, (int32_t *)scratch, (int32_t *)totals, 2,
                                (cudaStream_t)stream);
}

// The relay's scatter into the new stream (tok2, pwid2 of n2 >= Mw2 slots:
// the Mw2 of the stream all written, the rest set to PAD; off2 of W2 + 1,
// fw2 and wids2 of W2).
int yttm_shard_relay_write(const void *tok, const void *pwid, int Mw, const void *off,
                           const void *fw, const void *wids, int W, const void *lens,
                           const void *new_off, const void *new_idx, void *tok2, void *pwid2,
                           void *off2, void *fw2, void *wids2, int W2, int Mw2, int n2,
                           void *stream) {
  if (W <= 0 || Mw <= 0 || n2 < Mw2 || ((uintptr_t)tok & 15u) || ((uintptr_t)pwid & 15u))
    return (int)cudaErrorInvalidValue;
  return (int)launch_relay_write(
      (const int32_t *)tok, (const int32_t *)pwid, Mw, (const int32_t *)off, (const int32_t *)fw,
      (const int32_t *)wids, (const int32_t *)lens, (const int32_t *)new_off,
      (const int32_t *)new_idx, (int32_t *)tok2, (int32_t *)pwid2, (int32_t *)off2,
      (int32_t *)fw2, (int32_t *)wids2, W2, Mw2, n2, (cudaStream_t)stream);
}

// Lets the current device read `peer`'s memory (shards on distinct cards).
int yttm_shard_enable_peer(int device, int peer) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    return 0;
  }
  return (int)e;
}

}  // extern "C"
