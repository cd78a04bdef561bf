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
constexpr int kTopThreads = 128;  // threads of a top-k block
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

// a before b in the reference order; dead entries (count <= 0) last
__device__ __forceinline__ bool better(int ca, unsigned long long ka, int cb,
                                       unsigned long long kb) {
  if (cb <= 0) return ca > 0;
  if (ca <= 0) return false;
  if (ca != cb) return ca > cb;
  const uint32_t xa = (uint32_t)(ka >> 32), ya = (uint32_t)ka;
  const uint32_t xb = (uint32_t)(kb >> 32), yb = (uint32_t)kb;
  const uint32_t mxa = xa > ya ? xa : ya, mxb = xb > yb ? xb : yb;
  if (mxa != mxb) return mxa < mxb;
  const uint32_t mna = xa < ya ? xa : ya, mnb = xb < yb ? xb : yb;
  if (mna != mnb) return mna < mnb;
  return xa > xb;
}

// A thread's best K entries in the reference order (K = kK, or 1 for a
// top-1: the same first entry, without the list's upkeep).
template <int K = kK>
struct TopList {
  int c[K];
  unsigned long long k[K];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      c[j] = 0;
      k[j] = kEmpty;
    }
  }

  // Inserts (cv, kv) in order, dropping the last entry.  The position
  // comes from K independent comparisons and the shift is predicated, so
  // an insert is a short dependency chain (a bubble pass is K long).
  __device__ __forceinline__ void offer(int cv, unsigned long long kv) {
    if (!better(cv, kv, c[K - 1], k[K - 1])) return;
    int pos = 0;
#pragma unroll
    for (int j = 0; j < K - 1; ++j) pos += better(c[j], k[j], cv, kv);
#pragma unroll
    for (int j = K - 1; j > 0; --j) {
      if (j > pos) {
        c[j] = c[j - 1];
        k[j] = k[j - 1];
      }
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j == pos) {
        c[j] = cv;
        k[j] = kv;
      }
    }
  }
};

// Merges the sorted lists of the block's threads into the block's top K,
// written to out_c/out_k (shared or global).  Every thread must call it.
template <int K>
__device__ void block_merge(const TopList<K> &lst, int *out_c, unsigned long long *out_k) {
  __shared__ int sc[kTopThreads * K];
  __shared__ unsigned long long sk[kTopThreads * K];
  __shared__ int wc[kTopThreads / 32];
  __shared__ unsigned long long wk[kTopThreads / 32];
  __shared__ int wt[kTopThreads / 32];
  __shared__ int winner;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    sc[t * K + j] = lst.c[j];
    sk[t * K + j] = lst.k[j];
  }
  int head = 0;
  __syncthreads();
  for (int r = 0; r < K; ++r) {
    int c = head < K ? sc[t * K + head] : 0;
    unsigned long long k = head < K ? sk[t * K + head] : kEmpty;
    int who = t;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const int c2 = __shfl_down_sync(0xFFFFFFFFu, c, o);
      const unsigned long long k2 = __shfl_down_sync(0xFFFFFFFFu, k, o);
      const int w2 = __shfl_down_sync(0xFFFFFFFFu, who, o);
      if (better(c2, k2, c, k)) {
        c = c2;
        k = k2;
        who = w2;
      }
    }
    if (lane == 0) {
      wc[warp] = c;
      wk[warp] = k;
      wt[warp] = who;
    }
    __syncthreads();
    if (t == 0) {
      int bc = wc[0], bw = wt[0];
      unsigned long long bk = wk[0];
      for (int w = 1; w < kTopThreads / 32; ++w)
        if (better(wc[w], wk[w], bc, bk)) {
          bc = wc[w];
          bk = wk[w];
          bw = wt[w];
        }
      out_c[r] = bc;
      out_k[r] = bk;
      winner = bc > 0 ? bw : -1;
    }
    __syncthreads();
    if (winner == t) ++head;
    __syncthreads();
  }
}

// Pass 1 of a top-k: the calling block's top K of its grid-stride share of
// the table, to blk_c/blk_k + blockIdx.x * K.  Every thread must call it.
template <int K = kK>
__device__ void topk_scan(const unsigned long long *keys, const int32_t *cnts, int cap,
                          unsigned long long *blk_k, int32_t *blk_c) {
  TopList<K> lst;
  lst.clear();
  // a block or two per SM: each thread keeps kUnroll loads in flight, or
  // the scan waits on one load's latency per slot
  constexpr int kUnroll = 8;
  const int stride = gridDim.x * blockDim.x;
  for (int s0 = blockIdx.x * blockDim.x + threadIdx.x; s0 < cap; s0 += kUnroll * stride) {
    int c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * stride;
      c[u] = s < cap ? cnts[s] : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (c[u] > 0) lst.offer(c[u], keys[s0 + u * stride]);
  }
  block_merge(lst, blk_c + blockIdx.x * K, blk_k + blockIdx.x * K);
}

// Pass 2: the top K of the n_blk block lists, to top_c/top_k (shared).
// Every thread must call it.
template <int K = kK>
__device__ void topk_merge(const unsigned long long *blk_k, const int32_t *blk_c, int n_blk,
                           int *top_c, unsigned long long *top_k) {
  TopList<K> lst;
  lst.clear();
  for (int s = threadIdx.x; s < n_blk * K; s += blockDim.x) lst.offer(blk_c[s], blk_k[s]);
  block_merge(lst, top_c, top_k);
}

// accept_prefix (train_stream.py:120) and store_rules on one thread: the
// longest prefix of the candidates with no failure (a count at or below
// `floor`, the id budget, an intersection with an earlier candidate, the
// equal-pair guard).  Writes the accepted [x, y, z, count] rows to cand and
// rules; returns their number.
__device__ int accept_prefix_dev(const int *top_c, const unsigned long long *top_k, int k,
                                 int used, int vocab, int floor, int32_t *cand, int32_t *rules,
                                 int used_ids0) {
  const int remaining = vocab - used;
  int prev_eq = -1, n_acc = 0;
  for (int j = 0; j < k; ++j) {
    const int c = top_c[j];
    if (c <= floor || c <= 0 || j >= remaining || c < prev_eq) break;
    const int32_t x = (int32_t)(top_k[j] >> 32), y = (int32_t)(uint32_t)top_k[j];
    bool inter = false;
    for (int i = 0; i < j; ++i) inter |= cand[i * 4 + 1] == x || cand[i * 4] == y;
    if (inter) break;
    const int z = used + j;
    int32_t *row = rules + (size_t)(z - used_ids0) * 4;
    cand[j * 4] = row[0] = x;
    cand[j * 4 + 1] = row[1] = y;
    cand[j * 4 + 2] = row[2] = z;
    cand[j * 4 + 3] = row[3] = c;
    if (x == y && c > prev_eq) prev_eq = c;
    ++n_acc;
  }
  return n_acc;
}

inline int grid_for_warps(long long n_warps) {
  const long long blocks = (n_warps + 7) / 8;  // 8 warps a block
  const long long most = 132 * 16;
  return (int)(blocks < 1 ? 1 : (blocks < most ? blocks : most));
}

}  // namespace yttm
