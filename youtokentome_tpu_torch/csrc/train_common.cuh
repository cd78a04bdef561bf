// Device code shared by the trainers' kernels (train_topk.cu, train_delta.cu,
// train_tiered.cu, train_stream.cu, train_sparse.cu, train_block.cu,
// train_bucketed.cu, train_delta_sharded.cu, train_sparse_sharded.cu): the
// round control, the open-addressing pair-count table, the warp scan of the
// run parity, a word's pairs and its pair count, and the tie-ordered top-16
// with prefix acceptance.
//
// Pair keys are x << 32 | y (unsigned 64-bit); an empty slot holds all ones.
// The top-k keeps the reference order (train_stream.py _topk_candidates):
// count descending, then max(x, y) ascending, then min(x, y) ascending, then
// x descending; entries with count <= 0 come last.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace yttm {

constexpr int kK = 16;            // candidates per round (batch_k <= 16)
constexpr int32_t kPad = -1;
constexpr unsigned long long kEmpty = ~0ull;

// -- round control -----------------------------------------------------------

// Every trainer's ctl (int32) opens with these slots; its own follow from
// CTL_OWN (train_tiered.cu keeps a layout of its own with the first five).
enum Ctl { USED = 0, DONE, OVERFLOW, ROUND, NACC, OCC, ERROR, CTL_OWN };
// The sharded engines' scratch-table slots (shard_exchange.cuh ROCC, ROVF):
// a shard's count into its scratch table claims slots at kShardRocc and
// flags more than half of them taken at kShardRovf, which shard_fold reads.
constexpr int kShardRocc = CTL_OWN + 6, kShardRovf = CTL_OWN + 7;
// work (int64) opens with these counters, summed over the active rounds by
// the shared top-k; a trainer's own follow from W_OWN.
enum Work { W_ROUNDS = 0, W_OCC, W_SLOTS, W_OWN };

// The round loop still runs: not done, no overflow, `used` below
// min(vocab, limit).
__device__ __forceinline__ bool round_active(const int32_t *ctl, int limit, int vocab) {
  const int lim = limit < vocab ? limit : vocab;
  return !ctl[DONE] && !ctl[OVERFLOW] && ctl[USED] < lim;
}

// round_active decided once for the whole block: a count's other blocks may
// set `overflow` while this one starts.  Every thread must call it.
__device__ __forceinline__ bool block_active(const int32_t *ctl, int limit, int vocab) {
  __shared__ int active;
  if (threadIdx.x == 0) active = round_active(ctl, limit, vocab);
  __syncthreads();
  return active;
}

// The round's accepted candidates, in shared memory.
struct Cands {
  int32_t x[kK], y[kK], z[kK];
};

// Loads the round's accepted candidates; returns their number (every thread
// calls it).
__device__ __forceinline__ int load_cands(Cands &c, const int32_t *ctl, const int32_t *cand) {
  const int n = ctl[NACC];
  if (threadIdx.x < n) {
    c.x[threadIdx.x] = cand[threadIdx.x * 4];
    c.y[threadIdx.x] = cand[threadIdx.x * 4 + 1];
    c.z[threadIdx.x] = cand[threadIdx.x * 4 + 2];
  }
  __syncthreads();
  return n;
}

// Blocks of `threads` for n items, at most `per_sm` blocks on each of the
// 132 SMs (the kernels stride over the rest).
inline int grid_for(long long n, int threads, int per_sm = 8) {
  const long long blocks = (n + threads - 1) / threads;
  const long long most = 132ll * per_sm;
  return (int)(blocks < 1 ? 1 : (blocks < most ? blocks : most));
}

// Blocks of `threads` of `kernel` that the card holds at once (one wave).
template <class K>
int wave_blocks(K kernel, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  return sms * (per_sm > 0 ? per_sm : 1);
}

__device__ __forceinline__ unsigned long long hash64(unsigned long long k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdull;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ull;
  k ^= k >> 33;
  return k;
}

__device__ __forceinline__ unsigned long long pair_key(int32_t x, int32_t y) {
  return ((unsigned long long)(uint32_t)x << 32) | (uint32_t)y;
}

// How table_add treats a key the table lacks.
enum Mode {
  kSub,    // an error: subtractions only touch pairs the exact table holds
  kAdd,    // the key claims the first empty slot of its probe sequence
  kCount,  // as kAdd, but a probe stops once the table overflowed:
           // the caller recounts into a table twice the size, so a
           // count that outgrows its table never walks a full one
};

// Add `delta` to the count of `key`.  ctl[OCC] counts the claimed slots,
// ctl[OVF] is set when more than half the slots are claimed (or none is
// free), ctl[ERR] when a subtraction finds no key.
template <int OCC, int OVF, int ERR>
__device__ void table_add(unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl,
                          unsigned long long key, int32_t delta, Mode mode) {
  const unsigned mask = (unsigned)cap - 1u;
  const unsigned h = (unsigned)hash64(key) & mask;
  for (int p = 0; p < cap; ++p) {
    // a count gives up every 32 probes once the table overflowed: it may
    // fill the table, but never probes all of it (a check before every
    // claim would load the line of the occupancy atomics on each insert)
    if (mode == kCount && (p & 31) == 31 && __ldcg(ctl + OVF)) return;
    const unsigned s = (h + (unsigned)p) & mask;
    unsigned long long k = __ldcg(keys + s);
    if (k == kEmpty) {
      if (mode == kSub) {
        atomicExch(ctl + ERR, 1);
        return;
      }
      k = atomicCAS(keys + s, kEmpty, key);
      if (k == kEmpty) {
        const int occ = atomicAdd(ctl + OCC, 1) + 1;
        if (2ll * occ > (long long)cap) atomicExch(ctl + OVF, 1);
        atomicAdd(cnts + s, delta);
        return;
      }
    }
    if (k == key) {
      atomicAdd(cnts + s, delta);
      return;
    }
  }
  atomicExch(ctl + OVF, 1);  // the table is full: rebuilt by the host
}

// The first slot of a key's probe sequence and the key it holds, loaded
// ahead so that a lane's several updates have their loads in flight together
// (table_add_from).
struct Probe {
  unsigned s;
  unsigned long long k;
};

__device__ __forceinline__ Probe probe_first(const unsigned long long *keys, int cap,
                                             unsigned long long key) {
  const unsigned s = (unsigned)hash64(key) & ((unsigned)cap - 1u);
  return Probe{s, __ldcg(keys + s)};
}

// table_add after probe_first: a key found in its first slot takes the
// delta there; any other walks the probe sequence as table_add does.
template <int OCC, int OVF, int ERR>
__device__ __forceinline__ void table_add_from(unsigned long long *keys, int32_t *cnts, int cap,
                                               int32_t *ctl, unsigned long long key,
                                               int32_t delta, Mode mode, Probe p) {
  if (p.k == key) atomicAdd(cnts + p.s, delta);
  else table_add<OCC, OVF, ERR>(keys, cnts, cap, ctl, key, delta, mode);
}

__device__ __forceinline__ int warp_max_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xFFFFFFFFu, v, o);
    if (lane >= o) v = v > u ? v : u;
  }
  return v;
}

// Calls f(counted, key) at every position of the word tok[0, n): counted
// when the position starts a pair that counts (PAD slots break pairs; run
// parity: floor(r/2) pairs in a run of r equal tokens, bpe.cpp:140-143).
// Called by all 32 lanes of a warp, which walk the word 32 positions at a
// time; every lane calls f in every step (f may use warp votes).
template <class F>
__device__ void for_word_pairs(const int32_t *tok, int n, F f) {
  const int lane = threadIdx.x & 31;
  int carry = -1;  // last position < this chunk that does not start an equal pair
  for (int b = 0; b < n; b += 32) {
    const int i = b + lane;
    const int32_t a = i < n ? tok[i] : kPad;
    const int32_t nb = i + 1 < n ? tok[i + 1] : kPad;
    const bool pairv = a >= 0 && nb >= 0;
    const bool eq = pairv && a == nb;
    int lne = warp_max_scan(eq ? -1 : i);
    lne = lne > carry ? lne : carry;
    f(pairv && (!eq || ((i - lne - 1) & 1) == 0), pair_key(a, nb));
    carry = __shfl_sync(0xFFFFFFFFu, lne, 31);
  }
}

// Adds `delta` for every counted pair of the word tok[0, n) (for_word_pairs).
template <int OCC, int OVF, int ERR>
__device__ void add_word(const int32_t *tok, int n, int32_t delta, Mode mode,
                         unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl) {
  for_word_pairs(tok, n, [&](bool counted, unsigned long long key) {
    if (counted) table_add<OCC, OVF, ERR>(keys, cnts, cap, ctl, key, delta, mode);
  });
}

// -- top-k -------------------------------------------------------------------
//
// A round's top-K (K = 16, or 1 for v0) of a pair-count table in the
// reference order, in one launch: train_topk.cu's topk_select and
// train_tiered.cu's tier_hot / tier_full call grid_topk.
//
// Bound.  The round must read every slot's count (4 B) and the key (8 B) of
// each slot whose count reaches the K-th largest (a slot below it ranks
// after K others whatever its key): on v2's table of 2^22 slots, ~5 us at
// 3.35 TB/s; on v5's hot table of 2^17 slots, ~0.2 us.
//
// What held the old design back (measured with torch.profiler and a timer
// trace inside the kernels; H100 80GB HBM3, 700 W): two launches a
// round, pass 1 (the scan, 150 us a round on v2's run) with a thread's
// sorted list of 16 (count, key) pairs (80 registers) whose key loaded
// inside each insert, one memory latency after another, and block merges
// of 16 argmax rounds with three barriers each; pass 2 (53 us) one block of
// 128 threads over up to 4,096 entries.  v5's hot pass ran 32 blocks.
//
// The new design, one launch a round:
//  * one comparable word a slot.  While every id fits 16 bits the
//    reference order is one unsigned 64-bit word, NarrowOrder:
//      count << 33 | (0xFFFF - max) << 17 | (0xFFFF - min) << 1 | (x == max),
//    0 for a dead slot, (x, y) decoded from it (the card-side form of the
//    JAX package's narrow packing, train_stream.py _topk_candidates).
//    Wider ids take WideOrder, a 64-bit word and a 32-bit one compared in
//    turn.  The launch picks narrow when vocab <= 65536; a block that meets
//    an id above 65535 in narrow order scans its share again in wide order
//    (training never does, its ids being below vocab; tables built for the
//    checks put ids from 70000 under vocab 30000).
//  * the selection in warps.  A warp keeps its top 16 over lanes 0-15 and
//    reads 4 int4 of counts a lane at a time (512 slots), the next chunk's
//    loads in flight while a chunk is handled.  A slot is offered only when
//    its count reaches a bar: at first the 16th largest of the block's
//    lanes' largest counts in their first chunk, then the warp's 16th.  The
//    passing slots gather in a buffer and their keys load together (the
//    trace showed the scan waiting out a key latency in every chunk
//    otherwise); they merge into the queue by a bitonic sort of the batch
//    when many lanes offer, by ballot and shuffle inserts when few do.
//  * the block's warps' queues merge by bitonic merges in shared memory
//    (log2 of 8 steps); its 16 words go to the scratch; the last block to
//    finish (a ticket in the scratch) reads whole only the lists whose head
//    count reaches the 16th largest head count, merges them with the same
//    queues, and accepts on one warp, a lane a candidate (the trace showed
//    one thread's acceptance at 7.8 us of a hot round, re-reading its rows
//    from device memory).
//  * a grid of 256-thread blocks, one per 1024 slots and at most two an SM,
//    so that v5's hot table of 2^17 slots spreads over 128 SMs.
//  * K = 1 keeps one word a lane, the block's largest count as its bar, and
//    a 64-bit warp max by shuffles.

constexpr int kSelThreads = 256;  // threads of a selection block
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kSelVec = 4;        // int4 loads of counts a lane keeps in flight
constexpr int kSelBuf = 64;       // slots a warp gathers before it loads their keys
constexpr int kSelMaxBlocks = 2 * kSelThreads;  // lists the last block can pick from
constexpr unsigned kFullMask = 0xFFFFFFFFu;

// A wide word: hi = count << 31 | (2^31 - 1 - max), lo = (2^31 - 1 - min)
// << 1 | (x == max), compared hi first.  Ids are below 2^31.
struct Wide {
  unsigned long long hi;
  uint32_t lo;
};

struct WideOrder {
  typedef Wide W;
  __device__ static __forceinline__ W zero() { return Wide{0ull, 0u}; }
  __device__ static __forceinline__ bool fits(unsigned long long) { return true; }
  __device__ static __forceinline__ W pack(int c, unsigned long long key) {
    const uint32_t x = (uint32_t)(key >> 32), y = (uint32_t)key;
    const uint32_t mx = x > y ? x : y, mn = x < y ? x : y;
    return Wide{(unsigned long long)(uint32_t)c << 31 | (0x7FFFFFFFu - mx),
                (0x7FFFFFFFu - mn) << 1 | (uint32_t)(x == mx)};
  }
  __device__ static __forceinline__ uint32_t count(W w) { return (uint32_t)(w.hi >> 31); }
  __device__ static __forceinline__ bool gt(W a, W b) {
    return a.hi > b.hi || (a.hi == b.hi && a.lo > b.lo);
  }
  __device__ static __forceinline__ W shfl(W w, int src) {
    return Wide{__shfl_sync(kFullMask, w.hi, src), __shfl_sync(kFullMask, w.lo, src)};
  }
  __device__ static __forceinline__ W shfl_up(W w, int d) {
    return Wide{__shfl_up_sync(kFullMask, w.hi, d), __shfl_up_sync(kFullMask, w.lo, d)};
  }
  __device__ static __forceinline__ W shfl_xor(W w, int m) {
    return Wide{__shfl_xor_sync(kFullMask, w.hi, m), __shfl_xor_sync(kFullMask, w.lo, m)};
  }
  __device__ static __forceinline__ Wide widen(W w) { return w; }
};

struct NarrowOrder {
  typedef unsigned long long W;
  __device__ static __forceinline__ W zero() { return 0ull; }
  // both ids below 65536
  __device__ static __forceinline__ bool fits(unsigned long long key) {
    return (key & 0xFFFF0000FFFF0000ull) == 0ull;
  }
  __device__ static __forceinline__ W pack(int c, unsigned long long key) {
    const uint32_t x = (uint32_t)(key >> 32), y = (uint32_t)key;
    const uint32_t mx = x > y ? x : y, mn = x < y ? x : y;
    return (W)(uint32_t)c << 33 | (W)((0xFFFFu - mx) & 0xFFFFu) << 17 |
           (W)((0xFFFFu - mn) & 0xFFFFu) << 1 | (W)(x == mx);
  }
  __device__ static __forceinline__ uint32_t count(W w) { return (uint32_t)(w >> 33); }
  __device__ static __forceinline__ bool gt(W a, W b) { return a > b; }
  __device__ static __forceinline__ W shfl(W w, int src) { return __shfl_sync(kFullMask, w, src); }
  __device__ static __forceinline__ W shfl_up(W w, int d) { return __shfl_up_sync(kFullMask, w, d); }
  __device__ static __forceinline__ W shfl_xor(W w, int m) { return __shfl_xor_sync(kFullMask, w, m); }
  __device__ static __forceinline__ Wide widen(W w) {
    const uint32_t c = count(w);
    if (c == 0) return WideOrder::zero();
    const uint32_t mx = 0xFFFFu - (uint32_t)((w >> 17) & 0xFFFFu);
    const uint32_t mn = 0xFFFFu - (uint32_t)((w >> 1) & 0xFFFFu);
    return Wide{(unsigned long long)c << 31 | (0x7FFFFFFFu - mx),
                (0x7FFFFFFFu - mn) << 1 | (uint32_t)(w & 1ull)};
  }
};

// (count, key x << 32 | y) of a wide word; count 0 for a dead one
__device__ __forceinline__ int unpack_wide(Wide w, unsigned long long *key) {
  const uint32_t mx = 0x7FFFFFFFu - (uint32_t)(w.hi & 0x7FFFFFFFull);
  const uint32_t mn = 0x7FFFFFFFu - (w.lo >> 1);
  *key = (w.lo & 1u) ? pair_key((int32_t)mx, (int32_t)mn) : pair_key((int32_t)mn, (int32_t)mx);
  return (int)(w.hi >> 31);
}

// Sorts a 32-word bitonic sequence over the warp's lanes descending (every
// lane calls it): a bitonic merge, 5 compare-exchange steps.
template <class O>
__device__ __forceinline__ typename O::W bitonic_merge32(typename O::W v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const typename O::W o = O::shfl_xor(v, s);
    if (((lane & s) == 0) == O::gt(o, v)) v = o;  // the lower lane keeps the larger
  }
  return v;
}

// Sorts 32 words over the warp's lanes descending: 15 steps.
template <class O>
__device__ __forceinline__ typename O::W bitonic_sort32(typename O::W v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int s = k >> 1; s > 0; s >>= 1) {
      const typename O::W o = O::shfl_xor(v, s);
      const bool desc = (lane & k) == 0, lower = (lane & s) == 0;
      if (lower == desc ? O::gt(o, v) : O::gt(v, o)) v = o;
    }
  }
  return v;
}

// Counts as words (a block's bar).
struct CountOrder {
  typedef uint32_t W;
  __device__ static __forceinline__ W zero() { return 0u; }
  __device__ static __forceinline__ bool gt(W a, W b) { return a > b; }
  __device__ static __forceinline__ W shfl_xor(W w, int m) { return __shfl_xor_sync(kFullMask, w, m); }
};

template <class O>
__device__ __forceinline__ typename O::W warp_max(typename O::W v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const typename O::W u = O::shfl_xor(v, o);
    if (O::gt(u, v)) v = u;
  }
  return v;
}

// The block's largest v, to every thread (every thread calls it).
template <class O>
__device__ typename O::W block_max(typename O::W v) {
  __shared__ typename O::W buf[kSelWarps];
  const int lane = threadIdx.x & 31;
  v = warp_max<O>(v);
  if (lane == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  v = warp_max<O>(buf[lane < kSelWarps ? lane : 0]);
  __syncthreads();
  return v;
}

// Merges the block's warps' sorted lists of 16 (lane j < 16 of each warp
// holds its j-th word in q) by bitonic merges in shared memory, log2 of
// kSelWarps steps; the block's best 16 are left in buf[0][0, 16).  Every
// thread calls it.
template <class O>
__device__ void merge_warp_lists(typename O::W q, typename O::W (*buf)[kK]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < kK) buf[warp][lane] = q;
  __syncthreads();
  // warps w < n merge the lists w and w + n, the second reversed
#pragma unroll
  for (int n = kSelWarps / 2; n > 0; n >>= 1) {
    typename O::W v = O::zero();
    if (warp < n) v = bitonic_merge32<O>(lane < kK ? buf[warp][lane] : buf[warp + n][31 - lane]);
    __syncthreads();
    if (warp < n && lane < kK) buf[warp][lane] = v;
    __syncthreads();
  }
}

// The K-th largest of the block's threads' v (K = 16, or 1), to every
// thread (every thread calls it).
template <class O, int K>
__device__ typename O::W block_kth(typename O::W v) {
  if constexpr (K == 1) {
    return block_max<O>(v);
  } else {
    __shared__ typename O::W buf[kSelWarps][kK];
    merge_warp_lists<O>(bitonic_sort32<O>(v), buf);
    const typename O::W r = buf[0][kK - 1];
    __syncthreads();
    return r;
  }
}

// A warp's best K words (K = 16: the j-th best in lane j < 16, 0 in lanes
// 16-31, sorted; K = 1: each lane's own best).  `bar` is the count a slot
// must reach to be offered: the count of the K-th best, at least `floor`.
template <class O, int K>
struct WarpTop {
  static_assert(K == 1 || K == kK, "the warp queue holds 1 or 16 words");
  typename O::W q, last;
  uint32_t bar, floor;

  __device__ __forceinline__ void clear(uint32_t f = 0) {
    q = last = O::zero();
    bar = floor = f;
  }

  __device__ __forceinline__ void raise(typename O::W w) {
    const uint32_t c = O::count(w);
    bar = c > floor ? c : floor;
  }

  // Offers w from each lane where `has`; every lane calls it.
  __device__ __forceinline__ void offer(bool has, typename O::W w) {
    if constexpr (K == 1) {
      if (has && O::gt(w, q)) {
        q = w;
        raise(w);
      }
    } else {
      offer_warp(has, w);
    }
  }

  __device__ __forceinline__ void offer_warp(bool has, typename O::W w) {
    const int lane = threadIdx.x & 31;
    bool want = has && O::gt(w, last);
    unsigned m = __ballot_sync(kFullMask, want);
    if (__popc(m) > 4) {
      // many at once: sort the batch, then one bitonic merge of its top 16
      // (reversed into lanes 16-31) with the queue
      const typename O::W s = bitonic_sort32<O>(want ? w : O::zero());
      const typename O::W r = O::shfl(s, 31 - lane);
      q = bitonic_merge32<O>(lane < kK ? q : r);
      if (lane >= kK) q = O::zero();
      last = O::shfl(q, kK - 1);
      raise(last);
      return;
    }
    while (m) {
      const int src = __ffs(m) - 1;
      const typename O::W c = O::shfl(w, src);
      const int pos = __popc(__ballot_sync(kFullMask, lane < kK && O::gt(q, c)));
      const typename O::W up = O::shfl_up(q, 1);
      if (lane == pos) q = c;
      else if (lane > pos && lane < kK) q = up;
      last = O::shfl(q, kK - 1);
      if (lane == src) want = false;
      want = want && O::gt(w, last);
      m = __ballot_sync(kFullMask, want);
    }
    raise(last);
  }
};

// Four counts from slot 4g on (0 past the table's end).
__device__ __forceinline__ int4 load_counts(const int32_t *cnts, int cap, int g) {
  if (4 * g + 3 < cap) return __ldg(reinterpret_cast<const int4 *>(cnts) + g);
  int4 r = make_int4(0, 0, 0, 0);
  if (4 * g < cap) r.x = cnts[4 * g];
  if (4 * g + 1 < cap) r.y = cnts[4 * g + 1];
  if (4 * g + 2 < cap) r.z = cnts[4 * g + 2];
  return r;
}

// A lane's kSelVec int4 of counts of the chunk at group b (groups of 4
// slots, a warp's 32 lanes side by side, chunks `step` groups apart).
__device__ __forceinline__ void load_chunk(int (&c)[4 * kSelVec], const int32_t *cnts, int cap,
                                           int b, int step) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int v = 0; v < kSelVec; ++v) {
    const int4 q = load_counts(cnts, cap, b + v * step + lane);
    c[4 * v] = q.x;
    c[4 * v + 1] = q.y;
    c[4 * v + 2] = q.z;
    c[4 * v + 3] = q.w;
  }
}

// Offers every slot of warp `warp`'s share of the table whose count
// reaches the queue's bar to `top`.  The bar starts at the K-th largest of
// the block's lanes' largest counts in its first chunk (K distinct slots
// reach it, so the block's K-th best does).  The next chunk's counts load
// while a chunk is handled.  The slots that pass wait in a buffer of the
// warp's (kSelBuf) and their keys load together when it fills, and at the
// end; a chunk with more passing slots than that is offered at once.
// Returns false when a key it ranked does not fit the order (narrow order
// only).  Every thread calls it.
template <class O, int K>
__device__ bool scan_share(const unsigned long long *keys, const int32_t *cnts, int cap, int warp,
                           int n_warps, WarpTop<O, K> &top) {
  constexpr int kN = 4 * kSelVec;
  __shared__ int2 sbuf[kSelWarps][kSelBuf];  // (slot, count)
  int2 *buf = sbuf[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int n4 = (cap + 3) >> 2, step = n_warps * 32, b0 = warp * 32;
  int c[kN];
  load_chunk(c, cnts, cap, b0, step);
  uint32_t lmax = 0;
#pragma unroll
  for (int i = 0; i < kN; ++i) lmax = c[i] > (int)lmax ? (uint32_t)c[i] : lmax;
  top.clear(block_kth<CountOrder, K>(lmax));
  bool fit = true;
  int n_buf = 0;  // the same in every lane
  // the buffered slots' keys, kSelBuf / 32 a lane in flight, then offered
  auto flush = [&]() {
    unsigned long long key[kSelBuf / 32];
    int cb[kSelBuf / 32];
#pragma unroll
    for (int u = 0; u < kSelBuf / 32; ++u) {
      const int i = u * 32 + lane;
      const int2 e = i < n_buf ? buf[i] : make_int2(0, 0);
      cb[u] = e.y;
      key[u] = i < n_buf ? keys[e.x] : 0ull;
    }
#pragma unroll
    for (int u = 0; u < kSelBuf / 32; ++u) {
      const bool has = u * 32 + lane < n_buf && (uint32_t)cb[u] >= top.bar;
      fit &= !has || O::fits(key[u]);
      top.offer(has, O::pack(cb[u], key[u]));
    }
    n_buf = 0;
    __syncwarp();
  };
  for (int b = b0; b < n4; b += step * kSelVec) {
    int cn[kN];
    load_chunk(cn, cnts, cap, b + step * kSelVec, step);
    unsigned pend = 0;
#pragma unroll
    for (int i = 0; i < kN; ++i) pend |= (unsigned)(c[i] > 0 && (uint32_t)c[i] >= top.bar) << i;
    // this lane's place among the warp's passing slots
    const int mine = __popc(pend);
    int off = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFullMask, off, o);
      if (lane >= o) off += u;
    }
    const int total = __shfl_sync(kFullMask, off, 31);
    off -= mine;
    if (total > kSelBuf) {  // a dense chunk: every passing key in flight, offered at once
      unsigned long long key[kN];
#pragma unroll
      for (int i = 0; i < kN; ++i)
        key[i] = (pend >> i) & 1u ? keys[4 * (b + (i >> 2) * step + lane) + (i & 3)] : 0ull;
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const bool has = ((pend >> i) & 1u) && (uint32_t)c[i] >= top.bar;
        fit &= !has || O::fits(key[i]);
        top.offer(has, O::pack(c[i], key[i]));
      }
    } else if (total > 0) {
      if (n_buf + total > kSelBuf) flush();
      int at = n_buf + off;
#pragma unroll
      for (int i = 0; i < kN; ++i)
        if ((pend >> i) & 1u) buf[at++] = make_int2(4 * (b + (i >> 2) * step + lane) + (i & 3), c[i]);
      n_buf += total;
      __syncwarp();
    }
#pragma unroll
    for (int i = 0; i < kN; ++i) c[i] = cn[i];
  }
  if (__any_sync(kFullMask, n_buf > 0)) flush();
  return fit;
}

// The block's best K of its warps' words, wide, to out[0, K) (shared).
// Every thread calls it.
template <class O, int K>
__device__ void block_top(const WarpTop<O, K> &top, Wide *out) {
  if constexpr (K == 1) {
    const typename O::W v = block_max<O>(top.q);
    if (threadIdx.x == 0) out[0] = O::widen(v);
  } else {
    __shared__ typename O::W buf[kSelWarps][kK];
    merge_warp_lists<O>(top.q, buf);
    if (threadIdx.x < K) out[threadIdx.x] = O::widen(buf[0][threadIdx.x]);
  }
  __syncthreads();
}

// A round's top K of the table keys/cnts [cap] over the whole grid: each
// block ranks its share (narrow order unless `wide` or an id above 65535)
// and writes its K wide words to blk_hi/blk_lo + blockIdx.x * K; the last
// block to take a ticket (*ticket, 0 before the launch and after it)
// merges the gridDim.x lists into top_c/top_k (shared, K entries, count 0
// past the live slots) and returns true; every other block returns false.
// Every thread calls it.
template <int K>
__device__ bool grid_topk(const unsigned long long *keys, const int32_t *cnts, int cap, bool wide,
                          unsigned long long *blk_hi, uint32_t *blk_lo, unsigned *ticket,
                          int *top_c, unsigned long long *top_k) {
  __shared__ Wide list[K];
  __shared__ bool last;
  const int warp = blockIdx.x * kSelWarps + (threadIdx.x >> 5), n_warps = gridDim.x * kSelWarps;
  bool fit = false;
  if (!wide) {
    WarpTop<NarrowOrder, K> top;
    fit = __syncthreads_and(scan_share(keys, cnts, cap, warp, n_warps, top));
    if (fit) block_top(top, list);
  }
  if (!fit) {
    WarpTop<WideOrder, K> top;
    scan_share(keys, cnts, cap, warp, n_warps, top);
    block_top(top, list);
  }
  if (threadIdx.x < K) {
    blk_hi[blockIdx.x * K + threadIdx.x] = list[threadIdx.x].hi;
    blk_lo[blockIdx.x * K + threadIdx.x] = list[threadIdx.x].lo;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return false;
  // the last block: every list through L2.  The K-th largest count of the
  // threads' best list heads is a bar (K lists reach it with their first
  // word); only the lists whose head reaches it are read whole, 32 / K
  // lists a warp at a time.
  __shared__ int lists[kSelMaxBlocks];
  __shared__ int n_lists;
  const int lane = threadIdx.x & 31, n_blk = gridDim.x;
  constexpr int kR = kSelMaxBlocks / kSelThreads;  // lists a thread heads
  uint32_t h[kR], head = 0;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int b = threadIdx.x + r * kSelThreads;
    h[r] = b < n_blk ? (uint32_t)(__ldcg(blk_hi + b * K) >> 31) : 0u;
    head = h[r] > head ? h[r] : head;
  }
  if (threadIdx.x == 0) n_lists = 0;
  const uint32_t bar = block_kth<CountOrder, K>(head);  // (its barriers order n_lists)
#pragma unroll
  for (int r = 0; r < kR; ++r)
    if (h[r] > 0 && h[r] >= bar) lists[atomicAdd(&n_lists, 1)] = threadIdx.x + r * kSelThreads;
  __syncthreads();
  WarpTop<WideOrder, K> top;
  top.clear(bar);
  for (int p = (threadIdx.x >> 5) * (32 / K); p < n_lists; p += kSelWarps * (32 / K)) {
    const int li = p + lane / K;
    const int i = li < n_lists ? lists[li] * K + lane % K : -1;
    const Wide w = i >= 0 ? Wide{__ldcg(blk_hi + i), __ldcg(blk_lo + i)} : WideOrder::zero();
    top.offer(w.hi != 0ull && WideOrder::count(w) >= bar, w);
  }
  block_top(top, list);
  if (threadIdx.x < K) top_c[threadIdx.x] = unpack_wide(list[threadIdx.x], top_k + threadIdx.x);
  if (threadIdx.x == 0) *ticket = 0u;
  __syncthreads();
  return true;
}

// accept_prefix (train_stream.py:120) and store_rules on one warp: the
// longest prefix of the candidates top_c/top_k (shared, sorted) with no
// failure (a count at or below `floor`, the id budget, an intersection with
// an earlier candidate, the equal-pair guard: an earlier equal pair of a
// larger count).  Lane j tests candidate j against every earlier one (a
// failure past the prefix does not matter); the first failing lane ends it.
// Writes the accepted [x, y, z, count] rows to cand and rules; returns
// their number.  Every lane of the calling warp calls it (k <= 16).
__device__ int accept_prefix_warp(const int *top_c, const unsigned long long *top_k, int k,
                                  int used, int vocab, int floor, int32_t *cand, int32_t *rules,
                                  int used_ids0) {
  const int j = threadIdx.x & 31;
  bool fail = true;
  int c = 0;
  int32_t x = 0, y = 0;
  if (j < k) {
    c = top_c[j];
    x = (int32_t)(top_k[j] >> 32);
    y = (int32_t)(uint32_t)top_k[j];
    fail = c <= floor || c <= 0 || j >= vocab - used;
    for (int i = 0; i < j; ++i) {
      const int32_t xi = (int32_t)(top_k[i] >> 32), yi = (int32_t)(uint32_t)top_k[i];
      fail |= yi == x || xi == y || (xi == yi && top_c[i] > c);
    }
  }
  const int n_acc = __ffs(__ballot_sync(kFullMask, fail)) - 1;  // lane k fails
  if (j < n_acc) {
    const int z = used + j;
    int32_t *row = rules + (size_t)(z - used_ids0) * 4;
    cand[j * 4] = row[0] = x;
    cand[j * 4 + 1] = row[1] = y;
    cand[j * 4 + 2] = row[2] = z;
    cand[j * 4 + 3] = row[3] = c;
  }
  return n_acc;
}

inline int grid_for_warps(long long n_warps) {
  const long long blocks = (n_warps + 7) / 8;  // 8 warps a block
  const long long most = 132 * 16;
  return (int)(blocks < 1 ? 1 : (blocks < most ? blocks : most));
}

}  // namespace yttm
