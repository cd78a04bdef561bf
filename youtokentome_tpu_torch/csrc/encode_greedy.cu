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
// Layout.  The rows of the 100 MB main path hold 3-15 tokens (a space and
// a word of 2-14 letters), so nearly every row lies in the 8- or 16-slot
// bucket; the old design gave every row a block of 32-128 threads (16-24
// lanes idle on such a row, and a block for each PAD filler row of the
// bucket), kept it in shared memory and ran three block-wide scans with
// __syncthreads and a lookup of every pair each round: ~36 us a launch of
// 8192 rows against a bound of a few us (H100 80GB HBM3, 700 W).  Now:
//   * rows of up to 32 slots get G = 8, 16 or 32 lanes of a warp, one
//     position a lane, so 4, 2 or 1 rows a warp (greedy_group.cuh
//     greedy_group: the row stays in registers, a merge only marks its
//     right token dead, ranks are kept across rounds and looked up again
//     only where a pair changed, the minimum and the run parity are
//     shuffles and ballots; no shared memory, no __syncthreads).  The store
//     writes each live token to its compacted place and PAD after them;
//   * rows of 33-512 slots get a warp each, up to 16 positions a lane
//     (greedy_group.cuh greedy_warp: the scans as warp shuffles carried
//     across chunks, the compaction through the warp's own shared memory).
// stream_encode.cu runs the same two routines on the unique words of a
// chunk.
// A probe loads its slot's key halves and rank together (encode_common.cuh
// lookup), one L2 round trip a probe.  A group with no rule (or no live token, as a
// PAD filler row) is done after its first pass; the warp runs until all its
// groups are done.
//
// Bound.  Per launch the kernel moves R*L*(4+4) bytes (int32) or
// R*L*(2+2) bytes (uint16) through DRAM; its table gathers hit L2.  Its
// time is set by the rounds of the row that needs the most (each round one
// dependent lookup where a pair changed, and a few shuffles), not by bytes.
//
// Placeholders (>= 1e9, unknown-character runs) and PAD never match a
// rule: stored keys are real token ids below 1e9, so no pair holding one is
// looked up.  n_rules == 0 returns the rows unchanged.

#include <cstdint>
#include <cuda_runtime.h>

#include "greedy_group.cuh"

namespace {

using namespace yttm_enc;

constexpr int kMaxLen = 512;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// Rows of up to G <= 32 slots, G lanes a row (greedy_group.cuh).
template <bool kU16, int G>
__global__ void __launch_bounds__(kThreads)
    encode_short_kernel(const void *in, void *out, int R, int L, Table t, const int32_t *rules_z,
                        int n_rules, int32_t unk_id) {
  const int lane = threadIdx.x & 31, pos = lane & (G - 1);
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const bool mine = row < R && pos < L;
  const size_t at = (size_t)row * (size_t)L + (size_t)pos;
  int32_t tok = mine ? load_token<kU16>(in, at) : kPad;
  bool live = tok != kPad;
  const unsigned lm = greedy_group<G>(tok, live, t, rules_z, n_rules);
  if (!mine) return;
  const unsigned below = (1u << lane) - 1u;
  if (live) store_token<kU16>(out, (size_t)row * (size_t)L + __popc(lm & below), tok, unk_id);
  if (pos >= __popc(lm)) store_token<kU16>(out, at, kPad, unk_id);
}

// Rows of 33-512 slots, a warp a row, 32 * P slots (greedy_group.cuh).
template <bool kU16, int P>
__global__ void __launch_bounds__(kThreads)
    encode_long_kernel(const void *in, void *out, int R, int L, Table t, const int32_t *rules_z,
                       int n_rules, int32_t unk_id) {
  __shared__ int32_t buf[kWarps][2][32 * P];  // a warp's compacted tokens and ranks
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kWarps + w;
  if (row >= R) return;
  const size_t r0 = (size_t)row * (size_t)L;
  int32_t tk[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = 32 * k + lane;
    tk[k] = i < L ? load_token<kU16>(in, r0 + i) : kPad;
  }
  greedy_warp<P>(tk, buf[w][0], buf[w][1], t, rules_z, n_rules);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = 32 * k + lane;
    if (i < L) store_token<kU16>(out, r0 + i, tk[k], unk_id);
  }
}

template <bool kU16>
int launch(const void *in, void *out, int R, int L, const void *kx, const void *ky,
           const void *val, int cap, int max_probes, const void *rules_z, int n_rules,
           int unk_id, void *stream) {
  if (R <= 0 || L <= 0 || L > kMaxLen || cap <= 0 || (cap & (cap - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  Table t{(const uint32_t *)kx, (const uint32_t *)ky, (const int32_t *)val,
          (uint32_t)(cap - 1), max_probes};
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t *z = (const int32_t *)rules_z;
  // G lanes a short row, a warp a long one
  auto grid = [R](int lanes) { return (int)(((long long)R * lanes + kThreads - 1) / kThreads); };
  if (L <= 8)
    encode_short_kernel<kU16, 8><<<grid(8), kThreads, 0, s>>>(in, out, R, L, t, z, n_rules, unk_id);
  else if (L <= 16)
    encode_short_kernel<kU16, 16><<<grid(16), kThreads, 0, s>>>(in, out, R, L, t, z, n_rules, unk_id);
  else if (L <= 32)
    encode_short_kernel<kU16, 32><<<grid(32), kThreads, 0, s>>>(in, out, R, L, t, z, n_rules, unk_id);
  else if (L <= 64)
    encode_long_kernel<kU16, 2><<<grid(32), kThreads, 0, s>>>(in, out, R, L, t, z, n_rules, unk_id);
  else if (L <= 128)
    encode_long_kernel<kU16, 4><<<grid(32), kThreads, 0, s>>>(in, out, R, L, t, z, n_rules, unk_id);
  else if (L <= 256)
    encode_long_kernel<kU16, 8><<<grid(32), kThreads, 0, s>>>(in, out, R, L, t, z, n_rules, unk_id);
  else
    encode_long_kernel<kU16, 16><<<grid(32), kThreads, 0, s>>>(in, out, R, L, t, z, n_rules, unk_id);
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
