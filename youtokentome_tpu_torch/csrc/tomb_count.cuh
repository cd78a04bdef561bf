// The count of every live pair of the v3 tombstoned stream into an empty
// table, on Hopper: the v3 trainer's sparse_count (train_sparse.cu, into the
// table: OCC, OVERFLOW) and the sharded v3 trainer's sparse_shard_recount
// (train_sparse_sharded.cu, into a shard's scratch table: ROCC, ROVF) run
// this kernel, templated on the ctl slots it writes.
//
// Replaces what the JAX programs count there:
//   youtokentome_tpu/ops/train_sparse.py:78 _pairs_tomb (and :252
//   _host_table_tomb) and the recount fold of
//   youtokentome_tpu/parallel/train_sparse_sharded.py:149-161:
// every live token pairs with the next live token of its word, run parity is
// taken in live-rank space (a run of r equal live tokens, tombstones between
// them, counts floor(r/2) pairs), and a pair weighs fw[word].
//
// The old design gave each word a warp (sparse_word.cuh for_live_pairs:
// words hold ~8 positions, so ~3/4 of the lanes idled) and sent every
// counted pair to the global table with its own atomicAdd (a few hundred hot
// keys at the first count): the design that v2's pair_count gave up.
// This kernel takes over pair_count.cuh's design (its block table, claims
// and grid), with the walk that the v3 layout needs:
//  * the stream is walked flat: a warp takes a contiguous run of 128-slot
//    chunks, a lane 4 slots by one 16-byte load of t and one of pw.  v3's
//    words lie end to end with no separator, so a lane's left partner is
//    the previous live slot of the stream when pw puts it in the same word:
//    a word boundary breaks a run as an unequal pair does.  The partner of a
//    lane's first live slot is the last live slot of the lanes before it
//    (a ballot and two shuffles), or the chunk's carry.
//  * run parity comes from live ranks: each live slot's rank is the live
//    slots before it (a warp sum scan of the lanes' counts, carried from
//    chunk to chunk), and the rank before each live slot that is not the
//    second of an equal pair is taken by a warp max scan, carried too.
//  * a warp's first chunk finds its carry (the last live token before it,
//    and the rank of the last live slot there that starts no equal pair) by
//    walking back over tombstones, a warp 32 slots a step, never before the
//    first slot off[pw[p0]] of the word it starts in: late in training long
//    words are mostly tombstones, and a walk that crossed the word's start
//    would find no partner there.
//  * the counted pairs go to the block's table in shared memory, flushed
//    once a key a block; the claims are counted once a block; a grid of one
//    wave (pair_count.cuh).  The table's contract holds: at the end it is
//    exact, or OVF is set and the host counts again at twice the size.
//  * an optional gate (the sharded recount: some shard's DOVF set).
//
// Bound: the stream's slots (4 B each), the words' offsets and weights, and
// the filled slots (key and count, 12 B each).  The kernel also reads pw (4 B
// a slot), which the flat walk needs to tell words apart.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "pair_count.cuh"
#include "train_common.cuh"

namespace yttm {

// What a warp carries from the slots before a chunk: the last live token
// before it in the same word (tok kPad: none) with that word, and the live
// rank, counted from the chunk's first live slot (rank 0), of the last live
// slot before it that starts no equal pair.
struct TombCarry {
  int32_t tok;
  int32_t word;
  int lne;
};

// The carry of a warp whose walk starts at slot p0 (< M), by the whole warp:
// back from p0 over the slots of p0's word, 32 a step, to its last live
// token, then to the last live token that differs from the next one.  When
// every live token of the word before p0 is equal, the slot that starts no
// equal pair is the one before the word's first live token (another word's,
// or none).
__device__ inline TombCarry tomb_carry(const int32_t *t, const int32_t *pw, const int32_t *off,
                                       int p0) {
  TombCarry cr{kPad, -1, -1};
  const int w = pw[p0];
  if (w < 0) return cr;
  const int ws = off[w];
  const int lane = threadIdx.x & 31;
  int k = 0;  // live slots seen, all after the step's
  for (int b = p0 - 32; b + 32 > ws; b -= 32) {
    const int i = b + lane;
    const int32_t a = i >= ws ? t[i] : kPad;
    const unsigned m = __ballot_sync(kFullMask, a >= 0);
    if (!m) continue;
    if (cr.tok < 0) {
      cr.tok = __shfl_sync(kFullMask, a, 31 - __clz(m));
      cr.word = w;
    }
    const unsigned u = __ballot_sync(kFullMask, a >= 0 && a != cr.tok);
    if (u) {
      const int top = 31 - __clz(u);
      cr.lne = -(k + __popc(m & ~((2u << top) - 1u)) + 1);
      return cr;
    }
    k += __popc(m);
  }
  cr.lne = -(k + 1);
  return cr;
}

// Counts every live pair of the tombstoned stream t / pw (M slots; word k
// is [off[k], off[k+1]) and weighs fw[k]) into keys / cnts, claims in
// ctl[OCC], a table more than half full in ctl[OVF]; pairs of weight <= 0
// are not counted.  gate: as pair_count_kernel's.
template <int OCC, int OVF>
__global__ void __launch_bounds__(kCountThreads)
    tomb_count_kernel(const int32_t *t, const int32_t *pw, const int32_t *off, const int32_t *fw,
                      int M, unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl,
                      const int32_t *const *gate, int n_gate, int gate_slot) {
  if (!count_gate_open(gate, n_gate, gate_slot)) return;
  __shared__ BlockTable bt;
  block_table_open(bt);
  const int lane = threadIdx.x & 31;
  int c0, c1;
  warp_chunks(M, c0, c1);
  int claims = 0;  // global slots this lane claimed
  if (c0 < c1) {
    TombCarry cr = tomb_carry(t, pw, off, c0 * 128);
    int base = 0;  // the live rank of the chunk's first slot
    for (int c = c0; c < c1; ++c) {
      const int p = c * 128 + 4 * lane;
      int32_t a[4], w[4];
      load4(t, p, M, kPad, a);
      load4(pw, p, M, -1, w);
      int nl = 0;
      int32_t last_a = kPad, last_w = -1;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (a[j] >= 0) {
          ++nl;
          last_a = a[j];
          last_w = w[j];
        }
      // the left partner of the lane's first live slot
      const unsigned has = __ballot_sync(kFullMask, nl > 0);
      const unsigned lower = has & ((1u << lane) - 1u);
      const int src = lower ? 31 - __clz(lower) : 0;
      int32_t la = __shfl_sync(kFullMask, last_a, src);
      int32_t lw = __shfl_sync(kFullMask, last_w, src);
      if (!lower) {
        la = cr.tok;
        lw = cr.word;
      }
      // the rank of the lane's first slot
      int incl = nl;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(kFullMask, incl, d);
        if (lane >= d) incl += u;
      }
      const int r0 = base + incl - nl;
      // each live slot's pair with its partner; the ranks before the live
      // slots that are not the second of an equal pair
      bool pr[4], eq[4];
      int32_t left[4];
      int ev = INT_MIN, r = r0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool live = a[j] >= 0;
        pr[j] = live && la >= 0 && w[j] >= 0 && w[j] == lw;
        eq[j] = pr[j] && la == a[j];
        left[j] = la;
        if (live) {
          if (!eq[j]) ev = max(ev, r - 1);
          la = a[j];
          lw = w[j];
          ++r;
        }
      }
      const int ev_incl = warp_max_scan(ev);
      int lne = __shfl_up_sync(kFullMask, ev_incl, 1);
      if (lane == 0) lne = INT_MIN;
      lne = max(lne, cr.lne);
      // the counted pairs: an unequal pair, or an equal one at an even
      // place of its run
      unsigned long long key[4];
      int32_t f[4];
      r = r0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        key[j] = kEmpty;
        if (a[j] < 0) continue;
        if (!eq[j]) lne = max(lne, r - 1);
        if (pr[j] && (!eq[j] || ((r - 2 - lne) & 1) == 0)) {
          f[j] = __ldg(fw + w[j]);
          if (f[j] > 0) key[j] = pair_key(left[j], a[j]);
        }
        ++r;
      }
      // the chunk's carry
      const unsigned last = __ballot_sync(kFullMask, nl > 0);
      if (last) {
        const int hi = 31 - __clz(last);
        cr.tok = __shfl_sync(kFullMask, last_a, hi);
        cr.word = __shfl_sync(kFullMask, last_w, hi);
      }
      base += __shfl_sync(kFullMask, incl, 31);
      cr.lne = max(cr.lne, __shfl_sync(kFullMask, ev_incl, 31));
      claims += block_table_put<OVF>(bt, key, f, keys, cnts, cap, ctl);
    }
  }
  block_table_close<OCC, OVF>(bt, claims, keys, cnts, cap, ctl);
}

// The count's launch over the M slots of t / pw (16-byte aligned; M =
// off[W], the end of the last word), at most max_blocks blocks when that is
// > 0 (else one wave); the table empty and ctl[OCC] = ctl[OVF] = 0 (set by
// the caller, or, behind a gate, by a launch before it).
template <int OCC, int OVF>
cudaError_t launch_tomb_count(const int32_t *t, const int32_t *pw, const int32_t *off,
                              const int32_t *fw, int M, unsigned long long *keys, int32_t *cnts,
                              int cap, int32_t *ctl, const int32_t *const *gate, int n_gate,
                              int gate_slot, int max_blocks, cudaStream_t s) {
  tomb_count_kernel<OCC, OVF><<<count_grid<tomb_count_kernel<OCC, OVF>>(M, max_blocks),
                                kCountThreads, 0, s>>>(t, pw, off, fw, M, keys, cnts, cap, ctl,
                                                        gate, n_gate, gate_slot);
  return cudaGetLastError();
}

}  // namespace yttm
