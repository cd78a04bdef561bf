// BPE-dropout merge of padded word rows, on Hopper.
//
// Replaces the JAX device program
//   youtokentome_tpu/ops/encode_kernel.py:160  _encode_dropout
// with what it fuses (hashmap.py:48 PairTable.lookup, segment.py:57
// compact_rows).  The plain torch version of the same function is
// youtokentome_tpu_torch/ops/encode_kernel.py:encode_dropout_plain.
//
// Contract.  `in` is [R, L] (L <= 512) int32 word rows, each front-packed:
// tokens first, then PAD (-1).  Every round of a row: rank each adjacent
// pair in the rule hash table; draw a coin for every pair with a rule (a
// candidate), which drops it with probability p; merge the surviving
// candidate of least (rank, position) once (write z, drop the right token,
// shift the tail left by one).  A row stops ("freezes") in the first round
// in which no candidate survives, whether it had candidates or none.  The
// JAX loop freezes a row on the same condition and stops when every row
// is frozen; frozen rows never change, so stopping each row alone gives
// the same result.  Every round that does not freeze shortens the row, so
// a row needs at most L rounds.
//
// Coins.  JAX draws jax.random bits from a key split every round; the
// port draws a counter-based hash of (seed, row0 + row, round, column)
// (encode_common.cuh:coin_hash) that its plain version computes bit for
// bit, so the kernel and the plain version agree exactly.  The global row
// index keeps the coins of every row of one encode call apart.  The column
// is the pair's position in the row as compacted in that round.
//
// Layout.  The rows of the 100 MB main path hold 3-15 tokens, so nearly
// every row lies in the 8- or 16-slot bucket: a block a row would leave
// most of its lanes idle and pay block-wide scans and __syncthreads every
// round.  As in the greedy kernel (greedy_group.cuh):
//   * rows of up to 32 slots get G = 8, 16 or 32 lanes of a warp, one
//     position a lane (encode_dropout_short_kernel).  The row stays in
//     registers and is never compacted until the store: a merge at lane q
//     writes z there and marks q's next live lane dead.  A lane's column is
//     the popcount of the group's live lanes below it.  A candidate lane
//     draws its coin; the least surviving rank is a butterfly of shuffles
//     within the group, and its leftmost lane the first set bit of a
//     ballot (lanes keep the row's order).  Ranks are kept across rounds,
//     each with its rule's z, loaded beside it (off the round's chain of
//     dependent loads); the two pairs that hold z (at q and at the live
//     lane before q) are looked up again, each on its own lane.  A group
//     freezes in the first round in which none of its candidates survives
//     and takes no later round: the warp's round count is each live
//     group's own round.
//   * rows of 33-512 slots get a warp each, P = 2..16 positions a lane
//     (encode_dropout_long_kernel; chunk k: slots 32k..32k+31), with the
//     live slots as one ballot a chunk; the merge's neighbours are found
//     from those masks, and the two new pairs are looked up on their own
//     lanes.
// No shared memory and no __syncthreads in either.
//
// Bound.  Per launch the kernel moves R*L*(4+4) bytes through DRAM; its
// table gathers hit L2; its time is set by the rounds of the row that
// needs the most (a coin a candidate, a few shuffles and up to two
// dependent lookups a round).  With `work` given, it adds what it did to
// work[0..2] (coins drawn, merges, pairs looked up at the start), so a
// bound can count the operations its data needs.

#include <cstdint>
#include <cuda_runtime.h>

#include "greedy_group.cuh"

namespace {

using namespace yttm_enc;

constexpr int kMaxLen = 512;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Coins {
  uint32_t seed_lo, seed_hi, row0, thr;
};

// What the warp's lanes did, added to work[0..2] once a warp.
__device__ __forceinline__ void add_work(unsigned long long *work, unsigned coins,
                                         unsigned merges, unsigned pairs) {
  if (!work) return;
  coins = __reduce_add_sync(kFull, coins);
  merges = __reduce_add_sync(kFull, merges);
  pairs = __reduce_add_sync(kFull, pairs);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(work, (unsigned long long)coins);
    atomicAdd(work + 1, (unsigned long long)merges);
    atomicAdd(work + 2, (unsigned long long)pairs);
  }
}

// Rows of up to G <= 32 slots, G lanes a row (see the layout note).
template <int G>
__global__ void __launch_bounds__(kThreads)
    encode_dropout_short_kernel(const int32_t *in, int32_t *out, int R, int L, Table t,
                                const int32_t *rules_z, int n_rules, Coins c,
                                unsigned long long *work) {
  const int lane = threadIdx.x & 31, pos = lane & (G - 1);
  const unsigned group = group_mask<G>();
  const unsigned below = (1u << lane) - 1u;
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const bool mine = row < R && pos < L;
  const size_t at = (size_t)row * (size_t)L + (size_t)pos;
  int32_t tok = mine ? in[at] : kPad;
  bool live = tok != kPad;
  unsigned lm = __ballot_sync(kFull, live) & group;
  unsigned coins = 0, merges = 0, pairs = 0;
  if (n_rules > 0) {
    int nl = next_lane(lm);
    int32_t nt = __shfl_sync(kFull, tok, nl < 0 ? lane : nl);
    pairs = live && nl >= 0;
    int32_t rk = pairs ? rank_of(t, tok, nt) : kMiss;
    // the token a merge at this lane writes, loaded with the rank, so that
    // no round waits on it
    int32_t zk = rk != kMiss ? __ldg(rules_z + rk) : kPad;
    const uint32_t h = coin_row(c.seed_lo, c.seed_hi, c.row0 + (uint32_t)row);
    bool frozen = false;  // the same on every lane of a group
    for (uint32_t round = 0;; ++round) {
      // every candidate draws its coin; the survivor of least rank, and
      // of those the leftmost
      bool surv = false;
      if (!frozen && rk != kMiss) {
        ++coins;
        surv = (coin_finish(h, round, __popc(lm & below)) >> 8) >= c.thr;
      }
      int32_t m = surv ? rk : kMiss;
#pragma unroll
      for (int o = 1; o < G; o <<= 1) m = min(m, __shfl_xor_sync(kFull, m, o));
      frozen = frozen || m == kMiss;
      if (__all_sync(kFull, frozen)) break;
      const unsigned hits = __ballot_sync(kFull, surv && rk == m) & group;
      const int q = hits ? __ffs(hits) - 1 : -1;
      const unsigned prev = lm & below;
      const bool dropped = q >= 0 && prev && 31 - __clz(prev) == q;
      const bool stale = lane == q || (q >= 0 && nl == q);
      if (lane == q) {
        tok = zk;
        ++merges;
      }
      if (dropped) {
        live = false;
        tok = kPad;
      }
      lm = __ballot_sync(kFull, live) & group;
      nl = next_lane(lm);
      nt = __shfl_sync(kFull, tok, nl < 0 ? lane : nl);
      if (!live) {
        rk = kMiss;
      } else if (stale) {
        rk = nl >= 0 ? rank_of(t, tok, nt) : kMiss;
        zk = rk != kMiss ? __ldg(rules_z + rk) : kPad;
      }
    }
  }
  add_work(work, coins, merges, pairs);
  if (!mine) return;
  if (live) out[(size_t)row * (size_t)L + __popc(lm & below)] = tok;
  if (pos >= __popc(lm)) out[at] = kPad;
}

// v[k] for a k that is the same on every lane, without indexing v by a
// runtime value (which would move v to local memory).
template <int P, class T>
__device__ __forceinline__ T pick(const T (&v)[P], int k) {
  T r = v[0];
#pragma unroll
  for (int j = 1; j < P; ++j)
    if (j == k) r = v[j];
  return r;
}

// The first live slot after slot s, -1 without one (lm[k]: the live lanes
// of chunk k).
template <int P>
__device__ __forceinline__ int live_after(const unsigned (&lm)[P], int s) {
  const int k = s >> 5;
  const unsigned up = ~((2u << (s & 31)) - 1u);
  int r = -1;
#pragma unroll
  for (int j = P - 1; j >= 0; --j) {
    const unsigned mm = j < k ? 0u : (j == k ? lm[j] & up : lm[j]);
    if (mm) r = 32 * j + __ffs(mm) - 1;
  }
  return r;
}

// The last live slot before slot s, -1 without one.
template <int P>
__device__ __forceinline__ int live_before(const unsigned (&lm)[P], int s) {
  const int k = s >> 5;
  const unsigned down = (1u << (s & 31)) - 1u;
  int r = -1;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const unsigned mm = j > k ? 0u : (j == k ? lm[j] & down : lm[j]);
    if (mm) r = 32 * j + 31 - __clz(mm);
  }
  return r;
}

// Rows of 33-512 slots, a warp a row, 32 * P slots (see the layout note).
template <int P>
__global__ void __launch_bounds__(kThreads)
    encode_dropout_long_kernel(const int32_t *in, int32_t *out, int R, int L, Table t,
                               const int32_t *rules_z, int n_rules, Coins c,
                               unsigned long long *work) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;
  const size_t r0 = (size_t)row * (size_t)L;
  int32_t tk[P], rk[P];
  unsigned lm[P];  // the live lanes of each chunk, the same on every lane
  int n = 0;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = 32 * k + lane;
    tk[k] = i < L ? in[r0 + i] : kPad;
    lm[k] = __ballot_sync(kFull, tk[k] != kPad);
    n += __popc(lm[k]);
  }
  unsigned coins = 0, merges = 0, pairs = 0;
  if (n_rules > 0) {
    // the row is front-packed: slot i's right neighbour is slot i + 1
#pragma unroll
    for (int k = 0; k < P; ++k) {
      rk[k] = rank_of(t, tk[k], next_slot<P>(tk, k, kPad));
      pairs += 32 * k + lane < n - 1;
    }
    const uint32_t h = coin_row(c.seed_lo, c.seed_hi, c.row0 + (uint32_t)row);
    for (uint32_t round = 0;; ++round) {
      bool surv[P];
      int32_t m = kMiss;
      int col = 0;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        surv[k] = false;
        if (rk[k] != kMiss) {  // a live slot with a ranked pair
          ++coins;
          surv[k] = (coin_finish(h, round, col + __popc(lm[k] & below)) >> 8) >= c.thr;
        }
        if (surv[k]) m = min(m, rk[k]);
        col += __popc(lm[k]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = min(m, __shfl_xor_sync(kFull, m, o));
      if (m == kMiss) break;  // no survivor: the row freezes
      int q = -1;
#pragma unroll
      for (int k = P - 1; k >= 0; --k) {
        const unsigned b = __ballot_sync(kFull, surv[k] && rk[k] == m);
        if (b) q = 32 * k + __ffs(b) - 1;
      }
      // merge at q: z there, its next live slot r leaves; the pairs at q
      // (z, the slot after r) and at p, the live slot before q, (p, z)
      const int r = live_after<P>(lm, q), p = live_before<P>(lm, q);
      const int after = live_after<P>(lm, r);
      const int32_t z = __ldg(rules_z + m);
      const int kq = q >> 5, lq = q & 31, kp = p >> 5, lp = p & 31;
      const int32_t ta = after >= 0 ? __shfl_sync(kFull, pick(tk, after >> 5), after & 31) : kPad;
      const int32_t tp = p >= 0 ? __shfl_sync(kFull, pick(tk, kp), lp) : kPad;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        if (k == (r >> 5)) {
          lm[k] &= ~(1u << (r & 31));
          if (lane == (r & 31)) {
            tk[k] = kPad;
            rk[k] = kMiss;
          }
        }
        if (k == kq && lane == lq) tk[k] = z;
      }
      // the two lookups on their own lanes, side by side (one after the
      // other when p and q share a lane)
      const bool same = p >= 0 && lp == lq;
      const bool on_q = lane == lq, on_p = p >= 0 && lane == lp && !same;
      int32_t rr = kMiss, rr2 = kMiss;
      if (on_q || on_p) rr = on_q ? rank_of(t, z, ta) : rank_of(t, tp, z);
      if (same && on_q) rr2 = rank_of(t, tp, z);
#pragma unroll
      for (int k = 0; k < P; ++k) {
        if (on_q && k == kq) rk[k] = rr;
        if (p >= 0 && lane == lp && k == kp) rk[k] = same ? rr2 : rr;
      }
      --n;
      merges += lane == 0;
    }
  }
  add_work(work, coins, merges, pairs);
  int col = 0;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = 32 * k + lane;
    if ((lm[k] >> lane) & 1u) out[r0 + col + __popc(lm[k] & below)] = tk[k];
    col += __popc(lm[k]);
    if (i >= n && i < L) out[r0 + i] = kPad;
  }
}

}  // namespace

extern "C" {

// int32 rows in and out ([R, L], PAD = -1, placeholders kept).  The coin
// of row r, round k, pair i is coin_hash(seed_lo, seed_hi, row0 + r, k,
// i); a candidate drops when (coin >> 8) < thr.  `work` (uint64 [3], or
// null) gets the coins, merges and initial lookups added.  Returns the
// cudaError_t of the launch (0 on success).
int yttm_encode_dropout(const void *in, void *out, int R, int L, const void *kx, const void *ky,
                        const void *val, int cap, int max_probes, const void *rules_z, int n_rules,
                        unsigned seed_lo, unsigned seed_hi, unsigned row0, unsigned thr,
                        void *work, void *stream) {
  if (R <= 0 || L <= 0 || L > kMaxLen || cap <= 0 || (cap & (cap - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  Table t{(const uint32_t *)kx, (const uint32_t *)ky, (const int32_t *)val,
          (uint32_t)(cap - 1), max_probes};
  const Coins c{seed_lo, seed_hi, row0, thr};
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t *x = (const int32_t *)in, *z = (const int32_t *)rules_z;
  int32_t *y = (int32_t *)out;
  unsigned long long *w = (unsigned long long *)work;
  // G lanes a short row, a warp a long one
  auto grid = [R](int lanes) { return (int)(((long long)R * lanes + kThreads - 1) / kThreads); };
  if (L <= 8)
    encode_dropout_short_kernel<8><<<grid(8), kThreads, 0, s>>>(x, y, R, L, t, z, n_rules, c, w);
  else if (L <= 16)
    encode_dropout_short_kernel<16><<<grid(16), kThreads, 0, s>>>(x, y, R, L, t, z, n_rules, c, w);
  else if (L <= 32)
    encode_dropout_short_kernel<32><<<grid(32), kThreads, 0, s>>>(x, y, R, L, t, z, n_rules, c, w);
  else if (L <= 64)
    encode_dropout_long_kernel<2><<<grid(32), kThreads, 0, s>>>(x, y, R, L, t, z, n_rules, c, w);
  else if (L <= 128)
    encode_dropout_long_kernel<4><<<grid(32), kThreads, 0, s>>>(x, y, R, L, t, z, n_rules, c, w);
  else if (L <= 256)
    encode_dropout_long_kernel<8><<<grid(32), kThreads, 0, s>>>(x, y, R, L, t, z, n_rules, c, w);
  else
    encode_dropout_long_kernel<16><<<grid(32), kThreads, 0, s>>>(x, y, R, L, t, z, n_rules, c, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
