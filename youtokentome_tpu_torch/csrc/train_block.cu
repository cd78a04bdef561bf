// The v4 block trainer's merge round, on Hopper: two kernels here and the
// shared top-k of train_topk.cu.
//
// Replaces the JAX device program
//   youtokentome_tpu/ops/train_block.py:130 train_rounds_block
// and what it runs each round: pair_hits and the per-block flags,
// block_path (:171: the [KB, B] gather, _mini_contribs, _apply_rowwise with
// its per-row sort, _reduce_by_key, the row scatter) and full_path (:213:
// every row applied, the table counted again), with the shared
// _topk_candidates, accept_prefix and store_rules.  The plain torch versions
// of the kernels are in youtokentome_tpu_torch/ops/block_kernels.py.
//
// State (all on the card; the host reads `ctl` once per batch of rounds):
//   tok, wid [NB*B] int32  the JAX program's rows: row r is [r*B, (r+1)*B),
//                          whole words (B <= 512), PAD (-1, word id -1)
//                          between and after them; a row the round merges is
//                          front-packed, as the JAX per-row compaction leaves it
//   freq [W] int32         the word frequencies
//   keys [cap] u64, cnts [cap] int32
//                          the exact pair-count table, open addressing, key
//                          x << 32 | y, atomic counts, a key keeps its slot at
//                          count 0 until the next rebuild
//   rows [NB] int32        this round's rows with a hit
//   ctl [12] int32         used, done, overflow, round, n_acc, occupied,
//                          error (train_common.cuh), n_rows, recount
//   work [8] int64         rounds, occupied slots, table slots scanned (the
//                          top-k's), rows applied on the block path,
//                          full-path rounds (summed over the rounds)
//
// Kernels:
//   block_count   one warp a row counts the row's pairs (run parity) into an
//                 empty table (start, and rebuild after an overflow)
//   topk_accept   (train_topk.cu) the top 16 in the reference order and
//                 accept_prefix; writes cand, rules, ctl, work (and zeroes
//                 n_rows and recount every round)
//   block_apply   flag: one warp a row looks for a hit of an accepted pair
//                 (pairs never cross a word: word-id equality guards each)
//                 and lists the row; then, with at most KB rows listed (the
//                 block path), one warp a listed row takes the row's pairs
//                 out of the table, merges (even offsets inside runs of hits),
//                 front-packs the row in place in shared memory, puts the new
//                 pairs in and writes the row back; with more (the full path)
//                 every row is merged and front-packed, the table emptied and
//                 every row counted again.
//
// Every kernel does nothing once `done` or `overflow` is set or `used`
// reached min(vocab, limit), so the host enqueues rounds in batches; an insert
// that finds the table more than half full sets `overflow`, the round still
// completes exactly, and the host rebuilds the table from the rows.
//
// Bound.  A round reads every slot's count in the top-k (4 B a slot) and the
// live keys, every row in the flag pass (tok and wid, 8 B a slot), and on the
// block path the listed rows twice (read and written back) with the table
// entries their pairs touch; a full-path round reads and writes every row
// and refills the table.  What the design does about it: no sort and no
// gather or scatter copy (the JAX program sorts the mini stream's rows and
// the table each round); rows are applied where they lie.

#include <cstdint>
#include <cuda_runtime.h>

#include "train_common.cuh"

namespace {

using namespace yttm;

enum { NROWS = CTL_OWN, RECOUNT };  // zeroed by the top-k every round
enum { W_ROWS = W_OWN, W_FULL };

constexpr int kMaxB = 512;
constexpr int kRowWarps = 4;  // warps (rows at a time) of a block

// A warp's row in shared memory.
struct RowBuf {
  int32_t t[kMaxB];
  int32_t w[kMaxB];
};

__device__ __forceinline__ void load_row(RowBuf &rb, const int32_t *trow, const int32_t *wrow,
                                         int B) {
  for (int i = threadIdx.x & 31; i < B; i += 32) {
    rb.t[i] = trow[i];
    rb.w[i] = wrow[i];
  }
  __syncwarp();
}

__device__ __forceinline__ void store_row(const RowBuf &rb, int32_t *trow, int32_t *wrow, int B) {
  __syncwarp();
  for (int i = threadIdx.x & 31; i < B; i += 32) {
    trow[i] = rb.t[i];
    wrow[i] = rb.w[i];
  }
  __syncwarp();
}

// The token after position i within its word (PAD at a word's end).
__device__ __forceinline__ int32_t next_in_word(const RowBuf &rb, int i, int B, int32_t w) {
  return (i + 1 < B && rb.w[i + 1] == w) ? rb.t[i + 1] : kPad;
}

// Adds sign * freq for every counted pair of the row (run parity inside runs
// of equal tokens).  All 32 lanes.
__device__ void add_row(const RowBuf &rb, int B, const int32_t *freq, int sign, Mode mode,
                        unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl) {
  const int lane = threadIdx.x & 31;
  int carry = -1;
  for (int b = 0; b < B; b += 32) {
    const int i = b + lane;
    const int32_t a = i < B ? rb.t[i] : kPad;
    const int32_t w = i < B ? rb.w[i] : -1;
    const int32_t nb = i < B ? next_in_word(rb, i, B, w) : kPad;
    const bool pairv = a >= 0 && nb >= 0;
    const bool eq = pairv && a == nb;
    int lne = warp_max_scan(eq ? -1 : i);
    lne = lne > carry ? lne : carry;
    if (pairv && (!eq || ((i - lne - 1) & 1) == 0))
      table_add<OCC, OVERFLOW, ERROR>(keys, cnts, cap, ctl, pair_key(a, nb), sign * freq[w], mode);
    carry = __shfl_sync(0xFFFFFFFFu, lne, 31);
  }
  __syncwarp();
}

// Merges the accepted pairs in the row (even offsets inside runs of hits take
// z, their right neighbours drop) and front-packs it, as the JAX per-row
// compaction does.  All lanes read a chunk (and the next chunk's first slot)
// before any lane writes, and writes land at or before the slots read.
__device__ void merge_row(RowBuf &rb, int B, const Cands &c, int n) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  int carry_hit = -1, out = 0;
  bool carry_sel = false;
  for (int b = 0; b < B; b += 32) {
    const int i = b + lane;
    const int32_t a = i < B ? rb.t[i] : kPad;
    const int32_t w = i < B ? rb.w[i] : -1;
    const int32_t nb = i < B ? next_in_word(rb, i, B, w) : kPad;
    int rix = -1;
    if (a >= 0 && nb >= 0)
      for (int j = 0; j < n; ++j)
        if (rix < 0 && a == c.x[j] && nb == c.y[j]) rix = j;
    const bool hit = rix >= 0;
    int lnh = warp_max_scan(hit ? -1 : i);
    lnh = lnh > carry_hit ? lnh : carry_hit;
    const bool sel = hit && ((i - lnh - 1) & 1) == 0;
    bool prev_sel = __shfl_up_sync(0xFFFFFFFFu, sel, 1);
    if (lane == 0) prev_sel = carry_sel;
    const bool keep = a >= 0 && !prev_sel;
    const unsigned kmask = __ballot_sync(0xFFFFFFFFu, keep);
    __syncwarp();
    if (keep) {
      const int o = out + __popc(kmask & lt);
      rb.t[o] = sel ? c.z[rix] : a;
      rb.w[o] = w;
    }
    __syncwarp();
    out += __popc(kmask);
    carry_hit = __shfl_sync(0xFFFFFFFFu, lnh, 31);
    carry_sel = __shfl_sync(0xFFFFFFFFu, sel, 31);
  }
  for (int i = out + lane; i < B; i += 32) {
    rb.t[i] = kPad;
    rb.w[i] = -1;
  }
  __syncwarp();
}

// -- count ---------------------------------------------------------------------

// Every row's pairs into the table (all 32 lanes of each warp).
__device__ void count_rows(RowBuf *bufs, const int32_t *tok, const int32_t *wid,
                           const int32_t *freq, int B, int NB, unsigned long long *keys,
                           int32_t *cnts, int cap, int32_t *ctl) {
  RowBuf &rb = bufs[threadIdx.x >> 5];
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  for (int r = warp; r < NB; r += n_warps) {
    load_row(rb, tok + (size_t)r * B, wid + (size_t)r * B, B);
    add_row(rb, B, freq, 1, kCount, keys, cnts, cap, ctl);
  }
}

// block_count: into a table the host emptied
__global__ void __launch_bounds__(32 * kRowWarps)
    count_all_rows_kernel(const int32_t *tok, const int32_t *wid, const int32_t *freq, int B,
                          int NB, unsigned long long *keys, int32_t *cnts, int cap,
                          int32_t *ctl) {
  __shared__ RowBuf bufs[kRowWarps];
  count_rows(bufs, tok, wid, freq, B, NB, keys, cnts, cap, ctl);
}

// block_apply's full path: after the round's rows were merged (ctl[RECOUNT])
__global__ void __launch_bounds__(32 * kRowWarps)
    full_recount_kernel(const int32_t *tok, const int32_t *wid, const int32_t *freq, int B,
                        int NB, unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl) {
  __shared__ RowBuf bufs[kRowWarps];
  if (!ctl[RECOUNT]) return;
  count_rows(bufs, tok, wid, freq, B, NB, keys, cnts, cap, ctl);
}

__global__ void __launch_bounds__(256)
    full_clear_kernel(unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl) {
  if (!ctl[RECOUNT]) return;
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < cap; s += gridDim.x * blockDim.x) {
    keys[s] = kEmpty;
    cnts[s] = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) ctl[OCC] = 0;
}

// -- apply ---------------------------------------------------------------------

__global__ void __launch_bounds__(256)
    flag_rows_kernel(const int32_t *tok, const int32_t *wid, int B, int NB, int32_t *ctl,
                     const int32_t *cand, int32_t *rows) {
  __shared__ Cands c;
  const int n = load_cands(c, ctl, cand);
  if (n == 0) return;
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  for (int r = warp; r < NB; r += n_warps) {
    const int32_t *trow = tok + (size_t)r * B;
    const int32_t *wrow = wid + (size_t)r * B;
    bool hit = false;
    for (int i = lane; i < B; i += 32) {
      const int32_t a = trow[i];
      if (a < 0 || i + 1 >= B || wrow[i + 1] != wrow[i]) continue;
      const int32_t nb = trow[i + 1];
      for (int j = 0; j < n; ++j) hit |= a == c.x[j] && nb == c.y[j];
    }
    if (__any_sync(0xFFFFFFFFu, hit) && lane == 0) rows[atomicAdd(ctl + NROWS, 1)] = r;
  }
}

__global__ void __launch_bounds__(32 * kRowWarps)
    apply_rows_kernel(int32_t *tok, int32_t *wid, const int32_t *freq, int B, int NB,
                      const int32_t *rows, int KB, unsigned long long *keys, int32_t *cnts,
                      int cap, int32_t *ctl, const int32_t *cand, long long *work) {
  __shared__ Cands c;
  __shared__ RowBuf bufs[kRowWarps];
  const int n = load_cands(c, ctl, cand);
  if (n == 0) return;
  const int n_rows = ctl[NROWS];
  const bool full = n_rows > KB;
  RowBuf &rb = bufs[threadIdx.x >> 5];
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  if (full && warp == 0 && (threadIdx.x & 31) == 0) {
    ctl[RECOUNT] = 1;  // read by the clear and count launches that follow
    work[W_FULL] += 1;
  }
  for (int li = warp; li < (full ? NB : n_rows); li += n_warps) {
    const int r = full ? li : rows[li];
    int32_t *trow = tok + (size_t)r * B;
    int32_t *wrow = wid + (size_t)r * B;
    load_row(rb, trow, wrow, B);
    if (!full) add_row(rb, B, freq, -1, kSub, keys, cnts, cap, ctl);
    merge_row(rb, B, c, n);
    if (!full) add_row(rb, B, freq, 1, kAdd, keys, cnts, cap, ctl);
    store_row(rb, trow, wrow, B);
  }
  if (!full && blockIdx.x == 0 && threadIdx.x == 0) work[W_ROWS] += n_rows;
}

}  // namespace

extern "C" {

// Count every row's pairs into an empty table (keys all EMPTY, counts 0,
// ctl[OCC] = ctl[OVERFLOW] = 0, set by the caller).
int yttm_block_count(const void *tok, const void *wid, const void *freq, int B, int NB,
                     void *keys, void *cnts, int cap, void *ctl, void *stream) {
  if (B <= 0 || B > kMaxB || NB <= 0 || cap <= 0 || (cap & (cap - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  count_all_rows_kernel<<<grid_for(NB, kRowWarps, 16), 32 * kRowWarps, 0, (cudaStream_t)stream>>>(
      (const int32_t *)tok, (const int32_t *)wid, (const int32_t *)freq, B, NB,
      (unsigned long long *)keys, (int32_t *)cnts, cap, (int32_t *)ctl);
  return (int)cudaGetLastError();
}

// One round's merge of the accepted candidates: the rows with a hit flagged,
// then the block path (at most KB rows, table deltas) or the full path (every
// row, the table counted again).
int yttm_block_apply(void *tok, void *wid, const void *freq, int B, int NB, void *rows, int KB,
                     void *keys, void *cnts, int cap, void *ctl, const void *cand, void *work,
                     void *stream) {
  if (B <= 0 || B > kMaxB || NB <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  flag_rows_kernel<<<grid_for_warps(NB), 256, 0, s>>>(
      (const int32_t *)tok, (const int32_t *)wid, B, NB, (int32_t *)ctl, (const int32_t *)cand,
      (int32_t *)rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  apply_rows_kernel<<<grid_for(NB, kRowWarps, 16), 32 * kRowWarps, 0, s>>>(
      (int32_t *)tok, (int32_t *)wid, (const int32_t *)freq, B, NB, (const int32_t *)rows, KB,
      (unsigned long long *)keys, (int32_t *)cnts, cap, (int32_t *)ctl, (const int32_t *)cand,
      (long long *)work);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  full_clear_kernel<<<grid_for(cap, 256), 256, 0, s>>>((unsigned long long *)keys,
                                                       (int32_t *)cnts, cap, (int32_t *)ctl);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  full_recount_kernel<<<grid_for(NB, kRowWarps, 16), 32 * kRowWarps, 0, s>>>(
      (const int32_t *)tok, (const int32_t *)wid, (const int32_t *)freq, B, NB,
      (unsigned long long *)keys, (int32_t *)cnts, cap, (int32_t *)ctl);
  return (int)cudaGetLastError();
}

}  // extern "C"
