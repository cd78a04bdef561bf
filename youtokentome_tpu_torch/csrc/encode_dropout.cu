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
// index keeps the coins of every row of one encode call apart.
//
// Layout.  One thread block per row, 32..128 threads, each owning up to 4
// consecutive positions, as in encode_greedy.cu.  The row and the ranks of
// its pairs live in shared memory, double buffered (2 x 2 x 512 x 4 B).
// Ranks are looked up once at the start; a merge at q changes only the
// pairs at q - 1 and q, so a round looks up at most two pairs, hashes one
// coin per candidate, takes one 64-bit block min-reduce of
// (rank << 32 | position), and shifts the row.
//
// Bound.  Per launch the kernel moves R*L*(4+4) bytes through DRAM; its
// table gathers hit L2; its time is set by up to L dependent rounds of one
// block reduction each.  With `work` given, it adds what it did to
// work[0..2] (coins drawn, merges, pairs looked up at the start), so a
// bound can count the operations its data needs.

#include <cstdint>
#include <cuda_runtime.h>

#include "encode_common.cuh"

namespace {

using namespace yttm_enc;

constexpr int kMaxLen = 512;
constexpr int kMaxThreads = 128;
constexpr int kMaxPerThread = kMaxLen / kMaxThreads;  // 4
constexpr long long kNone = 0x7FFFFFFFFFFFFFFFll;

__global__ void __launch_bounds__(kMaxThreads)
    encode_dropout_kernel(const int32_t *in, int32_t *out, int L, Table t, const int32_t *rules_z,
                          int n_rules, uint32_t seed_lo, uint32_t seed_hi, uint32_t row0,
                          uint32_t thr, unsigned long long *work) {
  __shared__ int32_t tok[2][kMaxLen];
  __shared__ int32_t rk[2][kMaxLen];
  __shared__ long long wbuf[kMaxThreads / 32];

  const size_t base = (size_t)blockIdx.x * (size_t)L;
  const uint32_t row = row0 + blockIdx.x;
  const int n_threads = blockDim.x;
  const int per = (L + n_threads - 1) / n_threads;  // positions per thread, <= 4
  const int p0 = threadIdx.x * per;

  long long live = 0;
  for (int i = threadIdx.x; i < L; i += n_threads) {
    const int32_t v = in[base + i];
    tok[0][i] = v;
    live += v != kPad;
  }
  long long n_live;
  block_exclusive_scan(live, 0ll, wbuf, &n_live, SumOp());  // syncs: tok[0] is complete
  int n = (int)n_live;  // rows are front-packed
  const int n0 = n;
  int cur = 0;
  unsigned long long coins = 0;

  if (n_rules > 0) {
    for (int i = threadIdx.x; i < n - 1; i += n_threads)
      rk[0][i] = lookup(t, tok[0][i], tok[0][i + 1]);
    __syncthreads();

    for (int round = 0; round < L && n > 1; ++round) {
      // 1. the surviving candidate of least (rank, position)
      long long best = kNone;
#pragma unroll
      for (int c = 0; c < kMaxPerThread; ++c) {
        const int i = p0 + c;
        if (c < per && i < n - 1) {
          const int32_t r = rk[cur][i];
          if (r != kMiss) {
            ++coins;
            if ((coin_hash(seed_lo, seed_hi, row, (uint32_t)round, (uint32_t)i) >> 8) >= thr) {
              const long long key = ((long long)r << 32) | (long long)i;
              best = key < best ? key : best;
            }
          }
        }
      }
      long long m;
      block_exclusive_scan(best, kNone, wbuf, &m, MinOp());
      if (m == kNone) break;  // no survivor: the row freezes

      // 2. merge at q: write z, drop the right token, shift the tail;
      //    the ranks of untouched pairs move with their tokens
      const int q = (int)(m & 0xFFFFFFFFll);
      const int32_t z = __ldg(rules_z + (int)(m >> 32));
      const int nxt = cur ^ 1;
#pragma unroll
      for (int c = 0; c < kMaxPerThread; ++c) {
        const int i = p0 + c;
        if (c < per && i < n) {
          if (i < q)
            tok[nxt][i] = tok[cur][i];
          else if (i == q)
            tok[nxt][i] = z;
          else if (i > q + 1)
            tok[nxt][i - 1] = tok[cur][i];
          if (i < n - 1) {
            if (i < q - 1)
              rk[nxt][i] = rk[cur][i];
            else if (i > q + 1)
              rk[nxt][i - 1] = rk[cur][i];
          }
        }
      }
      __syncthreads();
      // 3. the two pairs that hold z
      if (threadIdx.x == 0 && q >= 1) rk[nxt][q - 1] = lookup(t, tok[nxt][q - 1], z);
      if (threadIdx.x == (n_threads > 32 ? 32 : 0) && q < n - 2)
        rk[nxt][q] = lookup(t, z, tok[nxt][q + 1]);
      __syncthreads();
      cur = nxt;
      n -= 1;
    }
    if (work) {
      atomicAdd(work, coins);
      if (threadIdx.x == 0) {
        atomicAdd(work + 1, (unsigned long long)(n0 - n));
        atomicAdd(work + 2, (unsigned long long)(n0 > 1 ? n0 - 1 : 0));
      }
    }
  } else {
    n = L;  // no rules: the rows leave as they came
  }

  for (int i = threadIdx.x; i < L; i += n_threads)
    out[base + i] = i < n ? tok[cur][i] : kPad;
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
  int threads = ((L + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  Table t{(const uint32_t *)kx, (const uint32_t *)ky, (const int32_t *)val,
          (uint32_t)(cap - 1), max_probes};
  encode_dropout_kernel<<<R, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t *)in, (int32_t *)out, L, t, (const int32_t *)rules_z, n_rules, seed_lo,
      seed_hi, row0, thr, (unsigned long long *)work);
  return (int)cudaGetLastError();
}

}  // extern "C"
