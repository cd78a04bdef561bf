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
// Kernels (one C entry each; a round is topk_accept, delta_emit and
// shard_recount on every shard, then shard_fold on every replica):
//   delta_emit     apply_delta (word_apply.cuh) with one change: a listed
//                  word's old (-f) and new (+f) counted-pair contributions
//                  go to the shard's buffer through a warp-aggregated atomic
//                  cursor, not into the table; DOVF is set when either side
//                  passes dcap (the entries past it are dropped).  The merge
//                  and compaction happen in any case.  A contribution is
//                  one counted pair of an affected word with weight > 0, so
//                  the counts equal JAX's _delta_contributions.
//   shard_recount  no-op unless some shard's DOVF is set (the JAX pmax):
//                  clears the shard's scratch table and counts the shard's
//                  stream into it (pair_count's add_word).
//   shard_fold     reads every shard's DOVF.  None set (the delta branch):
//                  adds every shard's buffer entries into the replica (a
//                  subtraction from a missing key sets ERROR; inserts that
//                  fill more than half the table set OVERFLOW, as in the
//                  one-device engine).  Some set (the recount branch): copies
//                  its own shard's scratch table into the replica (same
//                  capacity and hash: a copy, not a rebuild) and adds the
//                  other N-1 scratch tables into it, so it holds exactly the
//                  live keys; a scratch table that overflowed sets OVERFLOW
//                  (the host counts again into tables twice the size).
//   shard_part_fold, shard_gather
//                  the fold of the engines that recount every round (v1 and
//                  v0, recount_sharded_kernels.py), a reduce-scatter and an
//                  all-gather: a replica's table is cut into N parts (part p
//                  the slots [p*cap/N, (p+1)*cap/N), the keys with
//                  key_part == p, probed inside the part).  shard_part_fold
//                  on replica r empties its part r and adds every shard's
//                  scratch entries of part r into it, so each entry is
//                  inserted once over all replicas (the recount branch
//                  above inserts N-1 tables on every replica); once every
//                  replica has, shard_gather copies every other part p from
//                  replica p and sums the parts' counts into OCC (more than
//                  half the table, or a full part, sets OVERFLOW).
//   shard_relay    a scan and a scatter (word_apply.cuh's relay kernels, the
//                  one-device v2 engine's too) that lay a shard's stream out
//                  again over its live tokens: words with fewer than two live
//                  tokens (which hold no pair and never will) are dropped,
//                  every other word gets live + 1 slots.  Run at the JAX
//                  host loop's repack trigger; the JAX program slices its
//                  front-compacted stream there, which has no counterpart in
//                  a word-laid stream.
//
// The exchange: shard_recount and shard_fold take device arrays of the
// shards' pointers (ctl, buffers, scratch tables).  On one card every shard
// is on the same device and stream, so the launches' order orders the
// exchange.  Shards on distinct cards need peer access (the engine enables
// it or raises) and CUDA events between the steps (the engine records them).
//
// Bound.  A round's emit reads the shard's stream once (4 B a slot) and
// reads and writes the listed words (8 B a slot) and writes its buffer
// entries (12 B each); a delta fold reads every shard's entries and updates
// a table slot for each (24 B an entry); a recount round reads the streams,
// writes each shard's live pairs to its scratch table and reads them once
// (12 B a pair), and writes every replica's live entries (12 B each): the
// slots that hold no pair are not work the function needs.  The kernels add
// these bytes to work[W_EMIT], work[W_COUNT] and work[W_FOLD].  What the design
// does about it: the host reads shard 0's ctl once per batch of rounds (the
// branch is picked on the card), and the exchange moves the bounded buffers,
// not tables, in every round without a buffer overflow.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"
#include "shard_exchange.cuh"
#include "train_common.cuh"
#include "word_apply.cuh"

namespace {

using namespace yttm;

__global__ void __launch_bounds__(256)
    emit_words_kernel(int32_t *tok, const int32_t *off, const int32_t *fw, int Mw, int32_t *ctl,
                      const int32_t *cand, const int32_t *aff, unsigned long long *dk, int32_t *dv,
                      int dcap, long long *work) {
  __shared__ CandSet c;
  const int n = load_cand_set(c, ctl, cand);
  if (n == 0) return;
  const int lane = threadIdx.x & 31;
  if (blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd((unsigned long long *)(work + W_EMIT), 4ull * Mw);  // pass 1's read
  const int n_aff = ctl[NAFF];
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  for (int a_i = warp; a_i < n_aff; a_i += n_warps) {
    const int w = aff[a_i];
    const int base = off[w];
    const int len = off[w + 1] - 1 - base;
    const int32_t f = fw[w];
    int32_t *t = tok + base;
    int live = 0;
    for (int b = 0; b < len; b += 32)
      live += __popc(__ballot_sync(0xFFFFFFFFu, b + lane < len && t[b + lane] >= 0));
    const int out = merge_word(t, len, c, n, [&](bool counted, unsigned long long key, int) {
      emit(counted && f > 0, key, -f, DN_OLD, dk, dv, dcap, ctl, work);
    });
    for_word_pairs(t, out, [&](bool counted, unsigned long long key) {
      emit(counted && f > 0, key, f, DN_NEW, dk, dv, dcap, ctl, work);
    });
    if (lane == 0) {
      atomicAdd(ctl + LIVE, out - live);
      atomicAdd((unsigned long long *)(work + W_EMIT), 8ull * len);
    }
  }
}

// -- recount -----------------------------------------------------------------

__global__ void __launch_bounds__(256)
    recount_clear_kernel(unsigned long long *rkeys, int32_t *rcnts, int cap, int32_t *ctl,
                         const int32_t *const *ctls, int n_sh, int Mw, int W, long long *work) {
  if (!any_flag(ctls, n_sh, DOVF)) return;
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < cap; s += gridDim.x * blockDim.x) {
    rkeys[s] = kEmpty;
    rcnts[s] = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    ctl[ROCC] = 0;
    ctl[ROVF] = 0;
    // the stream with its offsets and weights read once (the live pairs
    // written are added by shard_fold, which reads ROCC)
    work[W_COUNT] += 4ll * Mw + 8ll * W;
  }
}

__global__ void __launch_bounds__(256)
    recount_kernel(const int32_t *tok, const int32_t *off, const int32_t *fw, int W,
                   unsigned long long *rkeys, int32_t *rcnts, int cap, int32_t *ctl,
                   const int32_t *const *ctls, int n_sh) {
  if (!any_flag(ctls, n_sh, DOVF)) return;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  for (int w = warp; w < W; w += n_warps) {
    const int base = off[w];
    add_word<ROCC, ROVF, ERROR>(tok + base, off[w + 1] - 1 - base, fw[w], kCount, rkeys, rcnts,
                                cap, ctl);
  }
}

// -- fold --------------------------------------------------------------------

__global__ void __launch_bounds__(256)
    fold_prep_kernel(unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl,
                     const int32_t *const *ctls, int n_sh, int dcap,
                     const unsigned long long *own_keys, const int32_t *own_cnts,
                     long long *work) {
  if (!any_flag(ctls, n_sh, DOVF)) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      long long n = 0;
      for (int s = 0; s < n_sh; ++s)
        n += min(__ldcg(ctls[s] + DN_OLD), dcap) + min(__ldcg(ctls[s] + DN_NEW), dcap);
      work[W_FOLD] += 24 * n;  // each entry read, and a table slot updated
    }
    return;
  }
  // the shard's own scratch table, counted into a table of the replica's
  // capacity and hash, is the replica's first part as it lies
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < cap; s += gridDim.x * blockDim.x) {
    keys[s] = own_keys[s];
    cnts[s] = own_cnts[s];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    ctl[OCC] = ctl[ROCC];
    ctl[NREC] += 1;
    if (any_flag(ctls, n_sh, ROVF)) ctl[OVERFLOW] = 1;
    // the shard's count wrote its live pairs; the fold reads them once
    // (fold_done adds the replica's entries written)
    work[W_COUNT] += 12ll * ctl[ROCC];
    work[W_FOLD] += 12ll * ctl[ROCC];
  }
}

// The recount branch's last step: the replica's live entries written.
__global__ void fold_done_kernel(const int32_t *ctl, const int32_t *const *ctls, int n_sh,
                                 long long *work) {
  if (any_flag(ctls, n_sh, DOVF)) work[W_FOLD] += 12ll * ctl[OCC];
}

__global__ void __launch_bounds__(256)
    fold_kernel(unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl,
                const int32_t *const *ctls, const unsigned long long *const *dks,
                const int32_t *const *dvs, int dcap, const unsigned long long *const *rkeys,
                const int32_t *const *rcnts, int n_sh, int self) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (any_flag(ctls, n_sh, DOVF)) {
    for (int s = 0; s < n_sh; ++s) {
      if (s == self) continue;  // copied by fold_prep
      for (long long j = i0; j < cap; j += stride) {
        const unsigned long long k = rkeys[s][j];
        const int32_t c = rcnts[s][j];
        if (k != kEmpty && c > 0)
          table_add<OCC, OVERFLOW, ERROR>(keys, cnts, cap, ctl, k, c, kAdd);
      }
    }
    return;
  }
  for (long long i = i0; i < 2ll * n_sh * dcap; i += stride) {
    const int s = (int)(i / (2 * dcap)), j = (int)(i % (2 * dcap));
    const int side = j >= dcap;
    const int n = min(__ldcg(ctls[s] + (side ? DN_NEW : DN_OLD)), dcap);
    if (j - side * dcap >= n) continue;
    const int32_t v = dvs[s][j];
    table_add<OCC, OVERFLOW, ERROR>(keys, cnts, cap, ctl, dks[s][j], v, v < 0 ? kSub : kAdd);
  }
}

// -- partitioned fold (v1, v0) ---------------------------------------------------

// Add `delta` to `key` in part [lo, lo + size) of the table: table_add's
// probe, wrapped inside the part; returns 1 when the key claimed a slot (the
// caller sums the claims into POCC).  A part with no free slot sets POCC
// past its size (the host then doubles the tables).
__device__ int part_add(unsigned long long *keys, int32_t *cnts, long long lo, int size,
                        int32_t *ctl, unsigned long long key, int32_t delta) {
  const unsigned h = (unsigned)hash64(key) % (unsigned)size;
  for (int p = 0; p < size; ++p) {
    if ((p & 31) == 31 && __ldcg(ctl + POCC) > size) return 0;
    unsigned s = h + (unsigned)p;
    if (s >= (unsigned)size) s -= (unsigned)size;
    unsigned long long *slot = keys + lo + s;
    unsigned long long k = __ldcg(slot);
    if (k == kEmpty) {
      k = atomicCAS(slot, kEmpty, key);
      if (k == kEmpty) {
        atomicAdd(cnts + lo + s, delta);
        return 1;
      }
    }
    if (k == key) {
      atomicAdd(cnts + lo + s, delta);
      return 0;
    }
  }
  atomicExch(ctl + POCC, size + 1);
  return 0;
}

// Empties the replica's own part and opens the round's count of it.
__global__ void __launch_bounds__(256)
    part_prep_kernel(unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl,
                     const int32_t *const *ctls, int n_sh, int self, long long *work) {
  const long long lo = part_lo(self, cap, n_sh), hi = part_lo(self + 1, cap, n_sh);
  for (long long s = lo + blockIdx.x * blockDim.x + threadIdx.x; s < hi;
       s += (long long)gridDim.x * blockDim.x) {
    keys[s] = kEmpty;
    cnts[s] = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    ctl[POCC] = 0;
    ctl[NREC] += 1;
    if (any_flag(ctls, n_sh, ROVF)) ctl[OVERFLOW] = 1;
    work[W_FOLD] += 12ll * ctl[ROCC];  // the shard's live pairs, read once
  }
}

// Every shard's scratch entries of the replica's part, added into it; the
// claims are summed a warp at a time into POCC (an atomic on one address
// for every claim would serialise them).
__global__ void __launch_bounds__(256)
    part_fold_kernel(unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl,
                     const unsigned long long *const *rkeys, const int32_t *const *rcnts,
                     int n_sh, int self) {
  const long long lo = part_lo(self, cap, n_sh);
  const int size = (int)(part_lo(self + 1, cap, n_sh) - lo);
  const long long stride = (long long)gridDim.x * blockDim.x;
  int claims = 0;
  for (int s = 0; s < n_sh; ++s) {
    const unsigned long long *rk = rkeys[s];
    const int32_t *rc = rcnts[s];
    for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < cap; j += stride) {
      const unsigned long long k = rk[j];
      if (k == kEmpty || key_part(k, n_sh) != self) continue;
      const int32_t c = rc[j];
      if (c > 0) claims += part_add(keys, cnts, lo, size, ctl, k, c);
    }
  }
  claims = __reduce_add_sync(0xFFFFFFFFu, claims);
  if ((threadIdx.x & 31) == 0 && claims) atomicAdd(ctl + POCC, claims);
}

// The other replicas' parts copied in; occupancy and overflow from every
// part's count (the same on every replica).  Its bytes, the replica's live
// entries written, are the occupancy that the next top-k sums (W_OCC).
__global__ void __launch_bounds__(256)
    gather_kernel(unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl,
                  const int32_t *const *ctls, const unsigned long long *const *pkeys,
                  const int32_t *const *pcnts, int n_sh, int self) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int p = 0; p < n_sh; ++p) {
    if (p == self) continue;
    const long long lo = part_lo(p, cap, n_sh), hi = part_lo(p + 1, cap, n_sh);
    const unsigned long long *pk = pkeys[p];
    const int32_t *pc = pcnts[p];
    for (long long j = lo + (long long)blockIdx.x * blockDim.x + threadIdx.x; j < hi; j += stride) {
      keys[j] = pk[j];
      cnts[j] = pc[j];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    long long occ = 0;
    bool full = false;
    for (int p = 0; p < n_sh; ++p) {
      const int n = __ldcg(ctls[p] + POCC);
      full |= n > part_lo(p + 1, cap, n_sh) - part_lo(p, cap, n_sh);
      occ += n;
    }
    ctl[OCC] = (int32_t)(occ < cap ? occ : cap);
    if (full || 2 * occ > cap) ctl[OVERFLOW] = 1;
  }
}

}  // namespace

extern "C" {

// One round's shard-local half: list the words with an accepted pair, merge
// them, and append their old and new contributions to the buffer; tok is
// 16-byte aligned (a fresh allocation).
int yttm_shard_delta_emit(void *tok, const void *pwid, int Mw, const void *off, const void *fw,
                          int W, void *ctl, const void *cand, void *aff, void *wmark, void *dk,
                          void *dv, int dcap, void *work, void *stream) {
  if (Mw < 2 || W <= 0 || dcap <= 0 || ((uintptr_t)tok & 15u)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  launch_mark_words<NAFF>((const int32_t *)tok, (const int32_t *)pwid, Mw, (int32_t *)ctl,
                          (const int32_t *)cand, (int32_t *)aff, (int32_t *)wmark, s);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  emit_words_kernel<<<grid_for_warps(W), 256, 0, s>>>(
      (int32_t *)tok, (const int32_t *)off, (const int32_t *)fw, Mw, (int32_t *)ctl,
      (const int32_t *)cand, (const int32_t *)aff, (unsigned long long *)dk, (int32_t *)dv, dcap,
      (long long *)work);
  return (int)cudaGetLastError();
}

// The recount branch's count of one shard into its scratch table, a no-op
// unless some shard's DOVF is set.  ctls: a device array of the n_sh
// shards' ctl pointers.
int yttm_shard_recount(const void *tok, int Mw, const void *off, const void *fw, int W,
                       void *rkeys, void *rcnts, int cap, void *ctl, const void *ctls, int n_sh,
                       void *work, void *stream) {
  // a shard without words still clears its scratch table, which every
  // replica reads in a recount round
  if (W < 0 || cap <= 0 || (cap & (cap - 1)) != 0 || n_sh <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  recount_clear_kernel<<<grid_for(cap, 256), 256, 0, s>>>(
      (unsigned long long *)rkeys, (int32_t *)rcnts, cap, (int32_t *)ctl,
      (const int32_t *const *)ctls, n_sh, Mw, W, (long long *)work);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  recount_kernel<<<grid_for_warps(W), 256, 0, s>>>(
      (const int32_t *)tok, (const int32_t *)off, (const int32_t *)fw, W,
      (unsigned long long *)rkeys, (int32_t *)rcnts, cap, (int32_t *)ctl,
      (const int32_t *const *)ctls, n_sh);
  return (int)cudaGetLastError();
}

// The exchange and fold into the replica of shard `self`.  ctls, dks, dvs,
// rkeys, rcnts: device arrays of the n_sh shards' pointers; own_keys,
// own_cnts: shard self's scratch table (the self-th of rkeys, rcnts).
int yttm_shard_fold(void *keys, void *cnts, int cap, void *ctl, const void *ctls, const void *dks,
                    const void *dvs, int dcap, const void *rkeys, const void *rcnts, int n_sh,
                    int self, const void *own_keys, const void *own_cnts, void *work,
                    void *stream) {
  if (cap <= 0 || (cap & (cap - 1)) != 0 || dcap <= 0 || n_sh <= 0 || self < 0 || self >= n_sh)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  fold_prep_kernel<<<grid_for(cap, 256), 256, 0, s>>>(
      (unsigned long long *)keys, (int32_t *)cnts, cap, (int32_t *)ctl,
      (const int32_t *const *)ctls, n_sh, dcap, (const unsigned long long *)own_keys,
      (const int32_t *)own_cnts, (long long *)work);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long items = cap > 2ll * n_sh * dcap ? cap : 2ll * n_sh * dcap;
  fold_kernel<<<grid_for(items, 256), 256, 0, s>>>(
      (unsigned long long *)keys, (int32_t *)cnts, cap, (int32_t *)ctl,
      (const int32_t *const *)ctls, (const unsigned long long *const *)dks,
      (const int32_t *const *)dvs, dcap, (const unsigned long long *const *)rkeys,
      (const int32_t *const *)rcnts, n_sh, self);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fold_done_kernel<<<1, 1, 0, s>>>((const int32_t *)ctl, (const int32_t *const *)ctls, n_sh,
                                   (long long *)work);
  return (int)cudaGetLastError();
}

// The partitioned fold's first half on the replica of shard `self` (the
// engines that recount every round): its part emptied, then every shard's
// scratch entries of that part added.  rkeys, rcnts: device arrays of the
// n_sh scratch tables.  shard_gather follows once every replica ran this.
int yttm_shard_part_fold(void *keys, void *cnts, int cap, void *ctl, const void *ctls,
                         const void *rkeys, const void *rcnts, int n_sh, int self, void *work,
                         void *stream) {
  if (cap < n_sh || (cap & (cap - 1)) != 0 || n_sh <= 0 || self < 0 || self >= n_sh)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  part_prep_kernel<<<grid_for(cap / n_sh + 1, 256), 256, 0, s>>>(
      (unsigned long long *)keys, (int32_t *)cnts, cap, (int32_t *)ctl,
      (const int32_t *const *)ctls, n_sh, self, (long long *)work);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  part_fold_kernel<<<grid_for(cap, 256), 256, 0, s>>>(
      (unsigned long long *)keys, (int32_t *)cnts, cap, (int32_t *)ctl,
      (const unsigned long long *const *)rkeys, (const int32_t *const *)rcnts, n_sh, self);
  return (int)cudaGetLastError();
}

// The partitioned fold's second half on the replica of shard `self`: every
// other replica's own part copied in.  pkeys, pcnts: device arrays of the
// n_sh replicas' tables.
int yttm_shard_gather(void *keys, void *cnts, int cap, void *ctl, const void *ctls,
                      const void *pkeys, const void *pcnts, int n_sh, int self, void *stream) {
  if (cap < n_sh || (cap & (cap - 1)) != 0 || n_sh <= 0 || self < 0 || self >= n_sh)
    return (int)cudaErrorInvalidValue;
  gather_kernel<<<grid_for(cap, 256), 256, 0, (cudaStream_t)stream>>>(
      (unsigned long long *)keys, (int32_t *)cnts, cap, (int32_t *)ctl,
      (const int32_t *const *)ctls, (const unsigned long long *const *)pkeys,
      (const int32_t *const *)pcnts, n_sh, self);
  return (int)cudaGetLastError();
}

// int32 slots of scratch a relay of W words needs.
long yttm_shard_relay_scratch(int W) { return yttm_scan::scratch_ints(W > 0 ? W : 1); }

// The relay's plan: each word's new slot count (lens) and keep flag, their
// exclusive scans (new_off, new_idx) and totals (totals[0] the new stream's
// slots, totals[1] its words).
int yttm_shard_relay_plan(const void *tok, const void *off, int W, void *lens, void *keep,
                          void *new_off, void *new_idx, void *scratch, void *totals,
                          void *stream) {
  if (W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  relay_len_kernel<<<grid_for(W, 256), 256, 0, s>>>((const int32_t *)tok, (const int32_t *)off, W,
                                                  (int32_t *)lens, (int32_t *)keep, 2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = yttm_scan::exclusive_scan((const int32_t *)lens, (int32_t *)new_off, W, (int32_t *)scratch,
                                (int32_t *)totals, s);
  if (e != cudaSuccess) return (int)e;
  return (int)yttm_scan::exclusive_scan((const int32_t *)keep, (int32_t *)new_idx, W,
                                        (int32_t *)scratch, (int32_t *)totals + 1, s);
}

// The relay's scatter into the new stream (tok2, pwid2 of max(Mw2, 2)
// slots, PAD-filled by the caller; off2 of W2 + 1, fw2 and wids2 of W2).
int yttm_shard_relay_write(const void *tok, const void *off, const void *fw, const void *wids,
                           int W, const void *lens, const void *new_off, const void *new_idx,
                           void *tok2, void *pwid2, void *off2, void *fw2, void *wids2, int W2,
                           int Mw2, void *stream) {
  if (W <= 0) return (int)cudaErrorInvalidValue;
  relay_write_kernel<<<grid_for_warps(W), 256, 0, (cudaStream_t)stream>>>(
      (const int32_t *)tok, (const int32_t *)off, (const int32_t *)fw, (const int32_t *)wids, W,
      (const int32_t *)lens, (const int32_t *)new_off, (const int32_t *)new_idx,
      (int32_t *)tok2, (int32_t *)pwid2, (int32_t *)off2, (int32_t *)fw2, (int32_t *)wids2, W2,
      Mw2);
  return (int)cudaGetLastError();
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
