// Greedy BPE merge of padded word rows to their fixed point, on Hopper.
//
// Replaces the JAX device programs
//   youtokentome_tpu/ops/encode_kernel.py:95  _encode_greedy      (int32 rows)
//   youtokentome_tpu/ops/encode_kernel.py:148 _encode_greedy_u16  (uint16 wire)
// together with what they fuse: hashmap.py:48 PairTable.lookup,
// segment.py:28 select_leftmost_nonoverlapping and segment.py:57
// compact_rows.  The plain torch version of the same function is
// youtokentome_tpu_torch/ops/encode_kernel.py:encode_greedy_plain.
//
// Contract.  `in` is [R, L] (L <= 512) of word rows, each front-packed:
// tokens first, then PAD (-1, or 0xFFFF on the uint16 wire).  Every round
// of a row: rank each adjacent pair in the rule hash table; take the row
// minimum m; merge the leftmost non-overlapping occurrences of rule m
// (even offsets inside runs of consecutive hits); drop each merged right
// token and front-compact.  A row stops when no pair has a rule.  The JAX
// loop stops when no row of the whole batch has a rule; a row with no
// rule is a fixed point, so stopping each row alone gives the same
// result.  Every merge shortens the row, so a row needs < L rounds.
//
// Layout.  One thread block per row, 32..128 threads, each owning up to
// 4 consecutive positions.  The row lives in shared memory, double
// buffered for the compaction (2 x 512 x 4 B).  The hash table (int32 x 3
// x cap; 786 KB at vocab 30k) stays in global memory, read with __ldg,
// and so sits in L2.  Per round: one block min-reduce (the row minimum),
// one block max-scan (last non-hit index, for the run parity), one block
// sum-scan (compaction offsets).
//
// Bound.  Per launch the kernel moves R*L*(4+4) bytes (int32) or
// R*L*(2+2) bytes (uint16) through DRAM; its table gathers hit L2; its
// time is set by up to L dependent rounds of three block-wide scans each.
//
// Placeholders (>= 1e9, unknown-character runs) and PAD never match a
// rule: stored keys are real token ids < 2**31 - 1, and pairs with PAD are
// masked before the lookup.  n_rules == 0 returns the rows unchanged.

#include <cstdint>
#include <cuda_runtime.h>

#include "encode_common.cuh"

namespace {

using namespace yttm_enc;

constexpr int kMaxLen = 512;
constexpr int kMaxThreads = 128;
constexpr int kMaxPerThread = kMaxLen / kMaxThreads;  // 4

constexpr uint32_t kU16Pad = 0xFFFFu;
constexpr uint32_t kU16PhTop = 0xFFFEu;
constexpr uint32_t kU16PhFloor = 0xF000u;

template <bool kU16>
__device__ __forceinline__ int32_t load_token(const void *in, size_t k) {
  if (kU16) {
    const uint32_t u = ((const uint16_t *)in)[k];
    if (u == kU16Pad) return kPad;
    if (u >= kU16PhFloor) return kPlaceholderStart + (int32_t)(kU16PhTop - u);
    return (int32_t)u;
  }
  return ((const int32_t *)in)[k];
}

template <bool kU16>
__device__ __forceinline__ void store_token(void *out, size_t k, int32_t v, int32_t unk_id) {
  if (kU16) {
    const int32_t o = v == kPad ? (int32_t)kU16Pad : (v >= kPlaceholderStart ? unk_id : v);
    ((uint16_t *)out)[k] = (uint16_t)o;
  } else {
    ((int32_t *)out)[k] = v;
  }
}

template <bool kU16>
__global__ void __launch_bounds__(kMaxThreads)
    encode_greedy_kernel(const void *in, void *out, int L, Table t, const int32_t *rules_z,
                         int n_rules, int32_t unk_id) {
  __shared__ int32_t buf[2][kMaxLen];
  __shared__ unsigned char sel_s[kMaxLen];
  __shared__ int wbuf[kMaxThreads / 32];

  const size_t row0 = (size_t)blockIdx.x * (size_t)L;
  const int n_threads = blockDim.x;
  const int per = (L + n_threads - 1) / n_threads;  // positions per thread, <= 4
  const int p0 = threadIdx.x * per;

  int32_t *cur = buf[0];
  int32_t *nxt = buf[1];
  for (int i = threadIdx.x; i < L; i += n_threads) cur[i] = load_token<kU16>(in, row0 + i);
  __syncthreads();

  int n = L;  // live prefix of cur; round 1 drops the PAD tail
  if (n_rules > 0) {
    for (int round = 0; round < L; ++round) {
      // 1. rank of every valid adjacent pair, and the row minimum
      int rk[kMaxPerThread];
      int local_min = kMiss;
#pragma unroll
      for (int c = 0; c < kMaxPerThread; ++c) {
        const int i = p0 + c;
        int r = kMiss;
        if (c < per && i < n - 1) {
          const int32_t a = cur[i], b = cur[i + 1];
          if (a != kPad && b != kPad) r = lookup(t, a, b);
        }
        rk[c] = r;
        local_min = local_min < r ? local_min : r;
      }
      int m;
      block_exclusive_scan(local_min, kMiss, wbuf, &m, MinOp());
      const bool active = m < kMiss;

      // 2. hits of rank m at even offsets inside each run of hits: a
      //    max-scan of the last non-hit index gives each run's start
      bool hit[kMaxPerThread];
      int local_last = -1;
#pragma unroll
      for (int c = 0; c < kMaxPerThread; ++c) {
        hit[c] = active && c < per && rk[c] == m;
        if (c < per && !hit[c]) local_last = p0 + c;
      }
      int unused;
      int last = block_exclusive_scan(local_last, -1, wbuf, &unused, MaxOp());
#pragma unroll
      for (int c = 0; c < kMaxPerThread; ++c) {
        const int i = p0 + c;
        if (c < per && i < L) {
          bool s = false;
          if (hit[c])
            s = ((i - last - 1) & 1) == 0;
          else
            last = i;
          sel_s[i] = s;
        }
      }
      __syncthreads();

      // 3. write z at each selected left token, drop its right token,
      //    front-compact into the other buffer
      const int32_t z = active ? __ldg(rules_z + m) : 0;
      int32_t v[kMaxPerThread];
      bool keep[kMaxPerThread];
      int kept = 0;
#pragma unroll
      for (int c = 0; c < kMaxPerThread; ++c) {
        const int i = p0 + c;
        keep[c] = false;
        v[c] = kPad;
        if (c < per && i < n) {
          const int32_t tok = cur[i];
          const bool dropped = i > 0 && sel_s[i - 1];
          keep[c] = !dropped && tok != kPad;
          v[c] = sel_s[i] ? z : tok;
          kept += keep[c];
        }
      }
      int total;
      int dst = block_exclusive_scan(kept, 0, wbuf, &total, SumOp());
#pragma unroll
      for (int c = 0; c < kMaxPerThread; ++c)
        if (keep[c]) nxt[dst++] = v[c];
      __syncthreads();
      int32_t *tmp = cur;
      cur = nxt;
      nxt = tmp;
      n = total;
      if (!active) break;
    }
  }

  for (int i = threadIdx.x; i < L; i += n_threads)
    store_token<kU16>(out, row0 + i, i < n ? cur[i] : kPad, unk_id);
}

template <bool kU16>
int launch(const void *in, void *out, int R, int L, const void *kx, const void *ky,
           const void *val, int cap, int max_probes, const void *rules_z, int n_rules,
           int unk_id, void *stream) {
  if (R <= 0 || L <= 0 || L > kMaxLen || cap <= 0 || (cap & (cap - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  int threads = ((L + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  Table t{(const uint32_t *)kx, (const uint32_t *)ky, (const int32_t *)val,
          (uint32_t)(cap - 1), max_probes};
  encode_greedy_kernel<kU16><<<R, threads, 0, (cudaStream_t)stream>>>(
      in, out, L, t, (const int32_t *)rules_z, n_rules, (int32_t)unk_id);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// int32 rows in and out ([R, L], PAD = -1, placeholders kept).  Returns
// the cudaError_t of the launch (0 on success).
int yttm_encode_greedy_i32(const void *in, void *out, int R, int L, const void *kx,
                           const void *ky, const void *val, int cap, int max_probes,
                           const void *rules_z, int n_rules, void *stream) {
  return launch<false>(in, out, R, L, kx, ky, val, cap, max_probes, rules_z, n_rules, 0,
                       stream);
}

// uint16 wire rows in and out: PAD 0xFFFF, placeholder ph as 0xFFFE - ph;
// placeholders leave as unk_id.
int yttm_encode_greedy_u16(const void *in, void *out, int R, int L, const void *kx,
                           const void *ky, const void *val, int cap, int max_probes,
                           const void *rules_z, int n_rules, int unk_id, void *stream) {
  return launch<true>(in, out, R, L, kx, ky, val, cap, max_probes, rules_z, n_rules, unk_id,
                      stream);
}

}  // extern "C"
