// The v2 delta trainer's merge round, on Hopper: the kernels here and the
// shared top-k of train_topk.cu.
//
// Replaces the JAX device program
//   youtokentome_tpu/ops/train_delta.py:210 train_rounds_delta
// and the functions it runs each round: train_stream.py
// pair_keys_and_weights_fw, _topk_candidates, accept_prefix, store_rules,
// pair_hits, apply_accepted, sort_compact, and train_delta.py
// _reduce_by_key, _compact_kv, _full_recount, _affected_positions,
// _delta_contributions; and the host loop's re-pack
// (youtokentome_tpu/ops/train_delta.py:473).  The plain torch versions of
// the kernels are in youtokentome_tpu_torch/ops/train_kernels.py.
//
// State (all on the card; the host reads `ctl` once per batch of rounds):
//   tok [Mw] int32   the word-laid stream: word w owns tok[off[w], off[w+1]-1),
//                    its live tokens front-packed, PAD (-1) after them, and
//                    one PAD separator at off[w+1]-1.  Words never move, so a
//                    merge compacts inside its word only: no stream-wide
//                    compaction (the JAX program sorts the whole stream).
//   pwid [Mw] int32  word of each position (-1 on separators)
//   keys [cap] u64, cnts [cap] int32
//                    open-addressing pair-count table, key x << 32 | y,
//                    linear probing, EMPTY = all ones, no deletions: a key
//                    whose count falls to 0 keeps its slot (it can never
//                    reach the top-k, which takes counts > 0 only).
//   ctl [8] int32    used, done, overflow, round, n_acc, occupied, error
//                    (train_common.cuh), n_aff
//   cand [16, 4]     this round's accepted [x, y, z, count]
//
// Kernels:
//   pair_count    one warp per word adds its pair contributions (run
//                 parity: floor(r/2) pairs in a run of r equal tokens,
//                 bpe.cpp:140-143), weighted by the word's frequency, with
//                 atomicCAS inserts and atomicAdd counts.  Builds the table
//                 at the start and rebuilds it from the stream after an
//                 overflow (the JAX recount and pcap-doubling retry); a
//                 count that overflows its table cuts its probes short, and
//                 the host counts again into a table twice the size.
//   topk_accept   (train_topk.cu) the top 16 live slots in the reference
//                 order and accept_prefix; writes rules, cand, ctl.
//   apply_delta   one launch a round (delta_apply_kernel, below).
//   relay         at a segment end where the live tokens fill less than
//                 half the stream's slots: the stream laid out again, every
//                 word its live tokens and a separator (word_apply.cuh's
//                 relay kernels and scan.cuh).  The JAX host loop slices its
//                 front-compacted stream there (the re-pack).
//
// Every kernel does nothing once `done` or `overflow` is set or `used`
// reached min(vocab, limit), so the host can enqueue rounds in batches.
// An insert that finds the table more than half full sets `overflow`; the
// round still completes exactly (the stream is right; the table may not
// be), and the host rebuilds the table from the stream, which drops the
// count-0 slots (at twice the size when live pairs fill a quarter of it).
//
// apply_delta on the H100.  A round must read the live stream once (4 B a
// token) and, for the words with a hit, rewrite them and update the table
// entries their merges change; what holds it back is latency, not bytes:
// the dependent loads of a walk over the stream, of a claimed word's
// offsets, tokens and table probes, and same-key atomics in the first
// rounds.  The design:
//  * one launch a round: a warp walks 128 positions at a time, a lane's
//    four in one 16-byte load, over a grid of one wave at 8 blocks an SM;
//    a position's pair is tested with one shared load and a bit (word_apply.cuh cand_of); a word with a hit is
//    claimed (its wmark takes the round's tag) and applied at once by the
//    warp that claimed it, so no list and no second pass;
//  * the claimed words are packed side by side into the warp's 32 lanes
//    (words hold ~8 slots); a word longer than 32 slots takes the warp
//    alone;
//  * net deltas: a lane whose pair survives the merge (kept, not merged,
//    nor the token after it) sends an update only when run parity changed
//    its count; every other old pair is subtracted, every new one added, so
//    a merge moves ~4 entries.  The table ends each round exact: only the
//    order of the additions changes, and a key is claimed iff it is new and
//    its count is positive (a pair holding a round's z is never old);
//  * the candidates' own keys, subtracted by every word they merge in, are
//    summed in shared memory and sent once a block;
//  * a lane's updates load their first probes together (probe_first);
//  * the relay at segment ends: the walk then reads the live tokens and a
//    separator a word, not the initial slots (9.5 M at the 100 MB point).

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"
#include "train_common.cuh"
#include "word_apply.cuh"

namespace {

using namespace yttm;

enum { NAFF = CTL_OWN };  // the round's words with a hit

__device__ __forceinline__ void table_add(unsigned long long *keys, int32_t *cnts, int cap,
                                          int32_t *ctl, unsigned long long key, int32_t delta,
                                          Mode mode) {
  yttm::table_add<OCC, OVERFLOW, ERROR>(keys, cnts, cap, ctl, key, delta, mode);
}

// Adds delta for every counted pair of the word tok[0, n) (live tokens
// first, PAD after).  Called by all 32 lanes of a warp.
__device__ __forceinline__ void add_word(const int32_t *tok, int n, int32_t delta, Mode mode,
                                         unsigned long long *keys, int32_t *cnts, int cap,
                                         int32_t *ctl) {
  yttm::add_word<OCC, OVERFLOW, ERROR>(tok, n, delta, mode, keys, cnts, cap, ctl);
}

__global__ void __launch_bounds__(256)
    pair_count_kernel(const int32_t *tok, const int32_t *off, const int32_t *fw, int W,
                      unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  for (int w = warp; w < W; w += n_warps) {
    const int base = off[w];
    add_word(tok + base, off[w + 1] - 1 - base, fw[w], kCount, keys, cnts, cap, ctl);
  }
}

// -- apply -------------------------------------------------------------------

// A pack of short listed words (their slots, 32 at most, side by side over
// the warp's lanes; words lie in the pack from lane `start` on, one bit a
// word in smask): merge, compact each word in place, and move the table by
// the net deltas.  A lane whose old pair survives the merge unchanged (it is
// kept, not merged, and so is the token after it) meets the same key in the
// new word, so it sends one atomic only when run parity changed the pair's
// count; every other old counted pair is subtracted (the candidates' own
// keys into the block's acc), every other new counted pair added.
// Called by all 32 lanes of a warp.
__device__ __forceinline__ void apply_pack(int32_t *tok, int base, int len, int32_t f, int start,
                                           int s, unsigned smask, int total, const CandSet &c,
                                           int n, int32_t *acc, unsigned long long *keys,
                                           int32_t *cnts, int cap, int32_t *ctl) {
  const int q = threadIdx.x & 31;
  const bool valid = q < total;
  const unsigned upto = (2u << q) - 1u;  // lanes 0..q
  const unsigned lt = (1u << q) - 1u;
  const int k = valid ? s + __popc(smask & upto) - 1 : s;  // this lane's word
  const int kb = __shfl_sync(kFullMask, base, k), ks = __shfl_sync(kFullMask, start, k);
  const int kl = __shfl_sync(kFullMask, len, k);
  const int32_t kf = __shfl_sync(kFullMask, f, k);
  const int pos = q - ks;
  int32_t *t = tok + kb;
  const int32_t a = valid ? t[pos] : kPad;
  const int32_t down = __shfl_down_sync(kFullMask, a, 1);
  const bool word_end = !valid || q == 31 || q + 1 >= total || ((smask >> (q + 1)) & 1u);
  const int32_t nb = word_end ? kPad : down;
  // the old word: counted pairs (run parity), hits, the merge
  const bool pairv = a >= 0 && nb >= 0;
  const bool eq = pairv && a == nb;
  const int lne = warp_max_scan(eq ? -1 : q);
  const bool co = pairv && (!eq || ((q - lne - 1) & 1) == 0);
  const int rix = cand_of(c, n, a, nb);
  const int lnh = warp_max_scan(rix >= 0 ? -1 : q);
  const bool sel = rix >= 0 && ((q - lnh - 1) & 1) == 0;
  const bool prev_sel = __shfl_up_sync(kFullMask, sel, 1) && q > 0;
  const bool sel_next = __shfl_down_sync(kFullMask, sel, 1);
  const bool keep = a >= 0 && !prev_sel;
  const int32_t v = sel ? c.z[rix] : a;
  // the new word: each kept token's successor is the next kept one of its word
  const unsigned kmask = __ballot_sync(kFullMask, keep);
  const unsigned wm = (kl >= 32 ? 0xFFFFFFFFu : (1u << kl) - 1u) << ks;
  const int rank = __popc(kmask & wm & lt), kept = __popc(kmask & wm);
  const unsigned later = kmask & wm & ~upto;
  const int32_t vn = __shfl_sync(kFullMask, v, later ? __ffs(later) - 1 : q);
  const int32_t nbn = keep && later ? vn : kPad;
  const bool eqn = nbn >= 0 && v == nbn;
  const int r = __popc(kmask & lt);
  const int lnen = warp_max_scan(keep && !eqn ? r : -1);
  const bool cn = nbn >= 0 && (!eqn || ((r - lnen - 1) & 1) == 0);
  // a lane's updates: the same pair's change, or its old pair out and its
  // new pair in; both first probes in flight together
  const bool same = keep && !sel && nb >= 0 && !sel_next;
  const unsigned long long ko = pair_key(a, nb), kn = pair_key(v, nbn);
  const int32_t d_old = same ? ((int)cn - (int)co) * kf : (co && rix < 0 ? -kf : 0);
  const int32_t d_new = !same && cn ? kf : 0;
  if (co && rix >= 0 && !same) atomicAdd(acc + rix, kf);
  Probe po{0u, 0ull}, pn{0u, 0ull};
  if (d_old) po = probe_first(keys, cap, ko);
  if (d_new) pn = probe_first(keys, cap, kn);
  if (d_old)
    table_add_from<OCC, OVERFLOW, ERROR>(keys, cnts, cap, ctl, ko, d_old, d_old > 0 ? kAdd : kSub, po);
  if (d_new) table_add_from<OCC, OVERFLOW, ERROR>(keys, cnts, cap, ctl, kn, d_new, kAdd, pn);
  // every lane read its slot above; the word compacts in place
  if (keep && (rank != pos || v != a)) t[rank] = v;
  if (a >= 0 && pos >= kept) t[pos] = kPad;
}

// A listed word longer than 32 slots, on the whole warp: every old counted
// pair out (the candidates' keys into acc), the merge, every new one in.
__device__ __forceinline__ void apply_long(int32_t *t, int len, int32_t f, const CandSet &c,
                                           int n, int32_t *acc, unsigned long long *keys,
                                           int32_t *cnts, int cap, int32_t *ctl) {
  const int out = merge_word(t, len, c, n, [&](bool counted, unsigned long long key, int rix) {
    if (!counted) return;
    if (rix >= 0) atomicAdd(acc + rix, f);
    else table_add(keys, cnts, cap, ctl, key, -f, kSub);
  });
  add_word(t, out, f, kAdd, keys, cnts, cap, ctl);
}

// Up to 32 claimed words, lane j holding word w (-1 past cnt), on the
// warp: short words packed side by side into the 32 lanes (apply_pack), a
// longer one alone (apply_long).
__device__ void apply_words(int w, int cnt, int32_t *tok, const int32_t *off, const int32_t *fw,
                            const CandSet &c, int n, int32_t *acc, unsigned long long *keys,
                            int32_t *cnts, int cap, int32_t *ctl) {
  const int lane = threadIdx.x & 31;
  int base = 0, len = 0;
  int32_t f = 0;
  if (lane < cnt) {
    base = off[w];
    len = off[w + 1] - 1 - base;
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
      apply_long(tok + __shfl_sync(kFullMask, base, s), ls, __shfl_sync(kFullMask, f, s), c, n,
                 acc, keys, cnts, cap, ctl);
      ++s;
      continue;
    }
    const int before = s > 0 ? __shfl_sync(kFullMask, end, s > 0 ? s - 1 : 0) : 0;
    const bool in = lane >= s && lane < cnt && end - before <= 32;
    const int e = 31 - __clz(__ballot_sync(kFullMask, in));
    const int start = end - len - before;
    const unsigned smask = __reduce_or_sync(kFullMask, in ? 1u << start : 0u);
    apply_pack(tok, base, len, f, start, s, smask, __shfl_sync(kFullMask, end, e) - before, c, n,
               acc, keys, cnts, cap, ctl);
    s = e + 1;
  }
}

// The round's apply, one launch: a warp walks 128 positions of the stream
// at a time (claim_words), counts the words it claimed (NAFF) and applies
// them at once (NAFF summed a block: same-address atomics serialise).  A
// claimed word is the claimer's alone: another thread
// reading it meanwhile may see it half merged, but only claims words, and
// this word is taken.  Every claimed word subtracts the candidates' own
// keys, so a block sums those in shared memory and adds them to the table
// once.  Registers are held to 32 a thread (8 blocks an SM): the walk is
// bound by its loads' latency, and more warps keep more of them in flight.
__global__ void __launch_bounds__(256, 8)
    delta_apply_kernel(int32_t *tok, const int32_t *pwid, int Mw, const int32_t *off,
                       const int32_t *fw, unsigned long long *keys, int32_t *cnts, int cap,
                       int32_t *ctl, const int32_t *cand, int32_t *wmark) {
  __shared__ CandSet c;
  __shared__ int32_t acc[kK];
  __shared__ int32_t claimed[8][128];  // a warp's words of its 128 positions
  __shared__ int n_claimed;  // the block's: one atomic a block on NAFF
  const int n = load_cand_set(c, ctl, cand);
  if (n == 0) return;
  if (threadIdx.x < kK) acc[threadIdx.x] = 0;
  if (threadIdx.x == 0) n_claimed = 0;
  __syncthreads();
  const int tag = ctl[ROUND];
  const int lane = threadIdx.x & 31;
  int32_t *mine_w = claimed[threadIdx.x >> 5];
  const int n_grp = (Mw - 1 + 3) >> 2;
  for (int g0 = blockIdx.x * blockDim.x + (threadIdx.x & ~31); g0 < n_grp;
       g0 += gridDim.x * blockDim.x) {
    int32_t t[5], w[4];
    load_group(tok, Mw, g0 + lane, t);
    const unsigned mine = claim_words(t, pwid, Mw, g0 + lane, c, n, tag, wmark, w);
    int total;
    int at = warp_exclusive(__popc(mine), total);
    if (total == 0) continue;
    if (lane == 0) atomicAdd(&n_claimed, total);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if ((mine >> q) & 1u) mine_w[at++] = w[q];
    __syncwarp();
    for (int b = 0; b < total; b += 32) {
      const int cnt = min(32, total - b);
      apply_words(lane < cnt ? mine_w[b + lane] : -1, cnt, tok, off, fw, c, n, acc, keys, cnts,
                  cap, ctl);
    }
    __syncwarp();
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_claimed) atomicAdd(ctl + NAFF, n_claimed);
  if (threadIdx.x < n && acc[threadIdx.x] != 0)
    table_add(keys, cnts, cap, ctl, pair_key(c.x[threadIdx.x], c.y[threadIdx.x]),
              -acc[threadIdx.x], kSub);
}

// Blocks of delta_apply_kernel that the card holds at once: the launch is
// one wave, each thread walking its share of the stream.
int apply_grid() {
  static int blocks = 0;
  if (!blocks) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, delta_apply_kernel, 256, 0);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

}  // namespace

extern "C" {

// Count every pair of the stream into an empty table (keys all EMPTY,
// counts 0, ctl[OCC] = ctl[OVERFLOW] = 0, set by the caller).
int yttm_train_pair_count(const void *tok, const void *off, const void *fw, int W, void *keys,
                          void *cnts, int cap, void *ctl, void *stream) {
  if (W <= 0 || cap <= 0 || (cap & (cap - 1)) != 0) return (int)cudaErrorInvalidValue;
  pair_count_kernel<<<grid_for_warps(W), 256, 0, (cudaStream_t)stream>>>(
      (const int32_t *)tok, (const int32_t *)off, (const int32_t *)fw, W,
      (unsigned long long *)keys, (int32_t *)cnts, cap, (int32_t *)ctl);
  return (int)cudaGetLastError();
}

// One round's merge of the accepted candidates with the table's deltas; tok
// is 16-byte aligned (a fresh allocation).
int yttm_train_apply_delta(void *tok, const void *pwid, int Mw, const void *off, const void *fw,
                           void *keys, void *cnts, int cap, void *ctl, const void *cand,
                           void *wmark, void *stream) {
  if (Mw < 2 || cap <= 0 || ((uintptr_t)tok & 15u)) return (int)cudaErrorInvalidValue;
  const long long warps = ((Mw - 1 + 3) / 4 + 31) / 32;
  const long long most = apply_grid();
  delta_apply_kernel<<<(int)((warps + 7) / 8 < most ? (warps + 7) / 8 : most), 256, 0,
                       (cudaStream_t)stream>>>(
      (int32_t *)tok, (const int32_t *)pwid, Mw, (const int32_t *)off, (const int32_t *)fw,
      (unsigned long long *)keys, (int32_t *)cnts, cap, (int32_t *)ctl, (const int32_t *)cand,
      (int32_t *)wmark);
  return (int)cudaGetLastError();
}

// int32 slots of scratch a relay of W words needs.
long yttm_train_relay_scratch(int W) { return yttm_scan::scratch_ints(W > 0 ? W : 1); }

// The relay's plan: each word's new slot count (lens: live + 1, every word
// kept), its exclusive scan (new_off) and totals[0] the new stream's slots;
// keep and new_idx (all ones, the identity) and totals[1] (W) as the
// sharded relay computes them.
int yttm_train_relay_plan(const void *tok, const void *off, int W, void *lens, void *keep,
                          void *new_off, void *new_idx, void *scratch, void *totals,
                          void *stream) {
  if (W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  relay_len_kernel<<<grid_for(W, 256), 256, 0, s>>>((const int32_t *)tok, (const int32_t *)off, W,
                                                  (int32_t *)lens, (int32_t *)keep, 1);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = yttm_scan::exclusive_scan((const int32_t *)lens, (int32_t *)new_off, W, (int32_t *)scratch,
                                (int32_t *)totals, s);
  if (e != cudaSuccess) return (int)e;
  return (int)yttm_scan::exclusive_scan((const int32_t *)keep, (int32_t *)new_idx, W,
                                        (int32_t *)scratch, (int32_t *)totals + 1, s);
}

// The relay's scatter into the new stream (tok2, pwid2 of Mw2 slots,
// PAD-filled by the caller; off2 of W + 1, fw2 of W).
int yttm_train_relay_write(const void *tok, const void *off, const void *fw, int W,
                           const void *lens, const void *new_off, const void *new_idx, void *tok2,
                           void *pwid2, void *off2, void *fw2, int Mw2, void *stream) {
  if (W <= 0) return (int)cudaErrorInvalidValue;
  relay_write_kernel<<<grid_for_warps(W), 256, 0, (cudaStream_t)stream>>>(
      (const int32_t *)tok, (const int32_t *)off, (const int32_t *)fw, nullptr, W,
      (const int32_t *)lens, (const int32_t *)new_off, (const int32_t *)new_idx, (int32_t *)tok2,
      (int32_t *)pwid2, (int32_t *)off2, (int32_t *)fw2, nullptr, W, Mw2);
  return (int)cudaGetLastError();
}

}  // extern "C"
