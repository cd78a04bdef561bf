// The v4 block trainer's merge round, on Hopper: three kernels here and the
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
//                          whole words (B 128, 256 or 512),
//                          PAD (-1, word id -1) between and after them; a row
//                          the round merges is front-packed, as the JAX
//                          per-row compaction leaves it
//   ext [NB] int32         each row's live extent: its last live slot + 1
//                          (0 for a row of PAD); only rows below NL (1 + the
//                          last row that holds a token at the start) are ever
//                          other than PAD, and the rows lose tokens only
//   freq [W] int32         the word frequencies
//   keys [cap] u64, cnts [cap] int32
//                          the exact pair-count table, open addressing, key
//                          x << 32 | y, atomic counts, a key keeps its slot at
//                          count 0 until the next rebuild
//   rows [NB] int32        this round's rows with a hit
//   ctl [10] int32         used, done, overflow, round, n_acc, occupied,
//                          error (train_common.cuh), n_rows, and the full
//                          path's grid barrier (0 between launches)
//   work [8] int64         rounds, occupied slots, table slots scanned (the
//                          top-k's), rows applied on the block path,
//                          full-path rounds, the bytes the flag walk and the
//                          apply must move (summed over the rounds)
//
// Kernels:
//   block_count   one warp a row counts the row's pairs (run parity) into an
//                 empty table (start, and rebuild after an overflow)
//   topk_accept   (train_topk.cu) the top 16 in the reference order and
//                 accept_prefix; writes cand, rules, ctl, work (and zeroes
//                 n_rows every round)
//   block_apply   two launches a round (its section below): the flag walk
//                 lists the rows with a hit; then the apply takes the block
//                 path (at most KB rows listed: one warp a listed row takes
//                 the row's pairs out of the table, merges, front-packs the
//                 row and puts its pairs back) or the full path (more: every
//                 row merged, front-packed and counted into the emptied
//                 table).
//
// Every kernel does nothing once `done` or `overflow` is set or `used`
// reached min(vocab, limit), so the host enqueues rounds in batches; an insert
// that finds the table more than half full sets `overflow`, the round still
// completes exactly, and the host rebuilds the table from the rows.
//
// Bound.  A round reads every slot's count in the top-k (4 B a slot) and the
// live keys; block_apply's flag walk reads each row's extent and the tokens
// below it (4 B each) and two word ids where a pair of tokens is a
// candidate; the block path reads and writes the listed rows below their
// extents (tok and wid, 16 B a slot) and touches a table entry for each of
// their old and new counted pairs (12 B); a full-path round does so for
// every row and writes the whole table (12 B a slot).  The kernels add these
// bytes to work[W_READ] and work[W_APPLY].  What the design does about it:
// no sort and no gather or scatter copy (the JAX program sorts the mini
// stream's rows and the table each round); rows are applied where they lie.

#include <cstdint>
#include <cuda_runtime.h>

#include "train_common.cuh"
#include "word_apply.cuh"

namespace {

using namespace yttm;

// NROWS is zeroed by the top-k every round; ARRIVED and LEFT (the full
// path's grid barrier) are 0 between launches
enum { NROWS = CTL_OWN, ARRIVED, LEFT };
enum { W_ROWS = W_OWN, W_FULL, W_READ, W_APPLY };

constexpr int kMaxB = 512;
constexpr int kRowWarps = 4;  // warps (rows at a time) of a block

// A warp's row in shared memory.
struct RowBuf {
  int32_t t[kMaxB];
  int32_t w[kMaxB];
};

// The row's first n slots into the warp's buffer.
__device__ __forceinline__ void load_row(RowBuf &rb, const int32_t *trow, const int32_t *wrow,
                                         int n) {
  for (int i = threadIdx.x & 31; i < n; i += 32) {
    rb.t[i] = trow[i];
    rb.w[i] = wrow[i];
  }
  __syncwarp();
}

__device__ __forceinline__ void store_row(const RowBuf &rb, int32_t *trow, int32_t *wrow, int n) {
  __syncwarp();
  for (int i = threadIdx.x & 31; i < n; i += 32) {
    trow[i] = rb.t[i];
    wrow[i] = rb.w[i];
  }
  __syncwarp();
}

// The token after slot i within its word (PAD at a word's end), of a row
// whose slots from n on are PAD.
__device__ __forceinline__ int32_t next_in_word(const RowBuf &rb, int i, int n, int32_t w) {
  return (i + 1 < n && rb.w[i + 1] == w) ? rb.t[i + 1] : kPad;
}

// Adds sign * freq for every counted pair of weight > 0 in the row's first n
// slots (run parity inside runs of equal tokens); returns the table updates.
// 128 slots at a time, their keys' first probes loaded together
// (probe_first).  All 32 lanes.
__device__ int add_row(const RowBuf &rb, int n, const int32_t *freq, int sign, Mode mode,
                       unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl) {
  const int lane = threadIdx.x & 31;
  int carry = -1, updates = 0;
  for (int g = 0; g < n; g += 128) {
    unsigned long long key[4];
    int32_t f[4];
    bool on[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = g + 32 * q + lane;
      const int32_t a = i < n ? rb.t[i] : kPad;
      const int32_t w = i < n ? rb.w[i] : -1;
      const int32_t nb = i < n ? next_in_word(rb, i, n, w) : kPad;
      const bool pairv = a >= 0 && nb >= 0;
      const bool eq = pairv && a == nb;
      int lne = warp_max_scan(eq ? -1 : i);
      lne = lne > carry ? lne : carry;
      f[q] = pairv ? freq[w] : 0;
      on[q] = pairv && (!eq || ((i - lne - 1) & 1) == 0) && f[q] > 0;
      key[q] = pair_key(a, nb);
      updates += __popc(__ballot_sync(kFullMask, on[q]));
      carry = __shfl_sync(kFullMask, lne, 31);
    }
    Probe pr[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (on[q]) pr[q] = probe_first(keys, cap, key[q]);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (on[q])
        table_add_from<OCC, OVERFLOW, ERROR>(keys, cnts, cap, ctl, key[q], sign * f[q], mode,
                                             pr[q]);
  }
  __syncwarp();
  return updates;
}

// Merges the accepted pairs in the row's first n slots (even offsets inside
// runs of hits take z, their right neighbours drop) and front-packs them, as
// the JAX per-row compaction does; returns the tokens kept.  All lanes read a
// chunk (and the next chunk's first slot) before any lane writes, and writes
// land at or before the slots read.
__device__ int merge_row(RowBuf &rb, int n, const CandSet &c, int nc) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  int carry_hit = -1, out = 0;
  bool carry_sel = false;
  for (int b = 0; b < n; b += 32) {
    const int i = b + lane;
    const int32_t a = i < n ? rb.t[i] : kPad;
    const int32_t w = i < n ? rb.w[i] : -1;
    const int32_t nb = i < n ? next_in_word(rb, i, n, w) : kPad;
    const int rix = cand_of(c, nc, a, nb);
    const bool hit = rix >= 0;
    int lnh = warp_max_scan(hit ? -1 : i);
    lnh = lnh > carry_hit ? lnh : carry_hit;
    const bool sel = hit && ((i - lnh - 1) & 1) == 0;
    bool prev_sel = __shfl_up_sync(kFullMask, sel, 1);
    if (lane == 0) prev_sel = carry_sel;
    const bool keep = a >= 0 && !prev_sel;
    const unsigned kmask = __ballot_sync(kFullMask, keep);
    __syncwarp();
    if (keep) {
      const int o = out + __popc(kmask & lt);
      rb.t[o] = sel ? c.z[rix] : a;
      rb.w[o] = w;
    }
    __syncwarp();
    out += __popc(kmask);
    carry_hit = __shfl_sync(kFullMask, lnh, 31);
    carry_sel = __shfl_sync(kFullMask, sel, 31);
  }
  for (int i = out + lane; i < n; i += 32) {
    rb.t[i] = kPad;
    rb.w[i] = -1;
  }
  __syncwarp();
  return out;
}

// -- count ---------------------------------------------------------------------

// block_count: every row's pairs into a table the host emptied
__global__ void __launch_bounds__(32 * kRowWarps)
    count_all_rows_kernel(const int32_t *tok, const int32_t *wid, const int32_t *freq, int B,
                          int NB, unsigned long long *keys, int32_t *cnts, int cap,
                          int32_t *ctl) {
  __shared__ RowBuf bufs[kRowWarps];
  RowBuf &rb = bufs[threadIdx.x >> 5];
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  for (int r = warp; r < NB; r += n_warps) {
    load_row(rb, tok + (size_t)r * B, wid + (size_t)r * B, B);
    add_row(rb, B, freq, 1, kCount, keys, cnts, cap, ctl);
  }
}

// -- apply -----------------------------------------------------------------------
//
// Two launches a round.  The old apply made four, each over every row or the
// table: a warp a row flagged the NB rows, reading tok and wid of every slot
// (twice, at i and i + 1) with up to 16 compares a live slot; then a grid
// sized to NB applied the listed rows; then a clear and a recount sized to
// the table and to NB ran every round, most returning at once: 302.7 ms over
// 3,316 rounds of the 100 MB run against a bound of 146.6, most of that bound
// the flag pass's read (H100 80GB HBM3, 700 W).  The design:
//  * flag_rows_kernel, a grid of one wave: a warp takes 32 rows at a time of
//    the NL rows that can hold tokens (the rows past them are PAD from the
//    start: NB is a power of two), a lane a row: its extent, then its tokens
//    below it, 16-byte loads 8 at a time in flight; a pair of tokens is
//    tested with the candidates' bitmap (word_apply.cuh cand_of), and the
//    two word ids are read only for a pair it takes, until one holds; the
//    batch's rows are listed with one atomicAdd (a full-path round lists
//    nearly every row).  A warp a row, 4 slots a lane, idled most lanes past
//    the row's extent (~40 slots of 128 late in the 100 MB run) and ran
//    slower; a lane a 16-byte group of the batch's rows walked flat ran no
//    faster (PERF.md, §6);
//  * apply_rows_kernel, one cooperative launch of one wave: on a round of
//    the block path (at most KB rows listed) a warp a listed row takes its
//    slots below the extent into shared memory, takes its pairs out of the
//    table, merges, front-packs, puts its pairs back and writes the row and
//    its extent; on a full-path round the blocks empty the table, meet at a
//    grid barrier, then merge, front-pack and count every row below NL in
//    one pass.  No launch of a round only reads ctl and returns.

// The 4 tokens of a 16-byte group.
__device__ __forceinline__ int32_t lane_tok(const int4 &v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

constexpr int kFlagLoads = 8;  // 16-byte groups of its row a lane has in flight

// Rows of B slots with a hit of an accepted pair, listed in rows
// (ctl[NROWS] counts them).
__global__ void __launch_bounds__(256)
    flag_rows_kernel(const int32_t *tok, const int32_t *wid, int B, int NL, const int32_t *ext,
                     int32_t *ctl, const int32_t *cand, int32_t *rows, long long *work) {
  __shared__ CandSet c;
  __shared__ unsigned long long bytes;
  if (threadIdx.x == 0) bytes = 0;
  const int n = load_cand_set(c, ctl, cand);  // its barriers order `bytes`
  if (n == 0) return;
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  unsigned read = 0;   // the lane's bytes of extents and tokens
  unsigned pairs = 0;  // the lane's candidate pairs of tokens
  for (int rb = 32 * warp; rb < NL; rb += 32 * n_warps) {
    const int r = rb + lane;
    const int e = r < NL ? ext[r] : 0;
    read += r < NL ? 4 + 4 * e : 0;
    const int ng = (e + 3) >> 2;
    const int most = (int)__reduce_max_sync(kFullMask, (unsigned)ng);
    const int32_t *row = tok + (size_t)r * B;
    bool hit = false;
    int32_t prev = kPad;  // the token before the slot
    for (int g0 = 0; g0 < most; g0 += kFlagLoads) {
      int4 v[kFlagLoads];
#pragma unroll
      for (int q = 0; q < kFlagLoads; ++q)
        v[q] = g0 + q < ng ? *reinterpret_cast<const int4 *>(row + 4 * (g0 + q))
                           : make_int4(kPad, kPad, kPad, kPad);
#pragma unroll
      for (int q = 0; q < kFlagLoads; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int32_t a = lane_tok(v[q], j);
          const bool pair = cand_of(c, n, prev, a) >= 0;
          if (pair && !hit) {  // the row's first pair of tokens that holds
            const int32_t *wrow = wid + (size_t)r * B + 4 * (g0 + q) + j;
            hit = wrow[-1] == wrow[0];
          }
          pairs += pair;
          prev = a;
        }
    }
    const unsigned hits = __ballot_sync(kFullMask, hit);
    if (hits) {  // the batch's rows listed with one atomicAdd
      int at = 0;
      if (lane == 0) at = atomicAdd(ctl + NROWS, __popc(hits));
      at = __shfl_sync(kFullMask, at, 0);
      if (hit) rows[at + __popc(hits & ((1u << lane) - 1u))] = r;
    }
  }
  // two word ids a candidate pair of tokens
  const unsigned long long warp_read = __reduce_add_sync(kFullMask, read) +
                                       8ull * __reduce_add_sync(kFullMask, pairs);
  if (lane == 0 && warp_read) atomicAdd(&bytes, warp_read);
  __syncthreads();
  if (threadIdx.x == 0 && bytes) atomicAdd((unsigned long long *)(work + W_READ), bytes);
}

// Every block of the (co-resident) grid waits here for the others; once a
// launch (grid_leave leaves the counters 0).
__device__ __forceinline__ void grid_wait(int32_t *ctl) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(ctl + ARRIVED, 1);
    while (*(volatile int32_t *)(ctl + ARRIVED) < (int)gridDim.x) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

// The last block to leave zeroes the barrier's counters: every block has
// passed its wait by then.
__device__ __forceinline__ void grid_leave(int32_t *ctl) {
  if (threadIdx.x == 0 && atomicAdd(ctl + LEFT, 1) == (int)gridDim.x - 1) {
    ctl[ARRIVED] = 0;
    ctl[LEFT] = 0;
  }
}

// Row r merged in place below its extent and its extent updated: on the
// block path its pairs taken out of the table first and put back after, on
// the full path counted into it.  Returns the bytes moved (lane 0).
__device__ unsigned long long apply_row(RowBuf &rb, int32_t *tok, int32_t *wid,
                                        const int32_t *freq, int B, int r, int32_t *ext,
                                        const CandSet &c, int n, bool full,
                                        unsigned long long *keys, int32_t *cnts, int cap,
                                        int32_t *ctl) {
  const int e = ext[r];
  if (e == 0) return 0;
  int32_t *trow = tok + (size_t)r * B;
  int32_t *wrow = wid + (size_t)r * B;
  load_row(rb, trow, wrow, e);
  int updates = 0;
  if (!full) updates += add_row(rb, e, freq, -1, kSub, keys, cnts, cap, ctl);
  const int out = merge_row(rb, e, c, n);
  updates += add_row(rb, out, freq, 1, full ? kCount : kAdd, keys, cnts, cap, ctl);
  store_row(rb, trow, wrow, e);
  if ((threadIdx.x & 31) == 0) ext[r] = out;
  return 16ull * e + 12ull * updates;
}

__global__ void __launch_bounds__(32 * kRowWarps)
    apply_rows_kernel(int32_t *tok, int32_t *wid, const int32_t *freq, int B, int NL,
                      int32_t *ext, const int32_t *rows, int KB, unsigned long long *keys,
                      int32_t *cnts, int cap, int32_t *ctl, const int32_t *cand,
                      long long *work) {
  __shared__ CandSet c;
  __shared__ RowBuf bufs[kRowWarps];
  __shared__ unsigned long long bytes;
  if (threadIdx.x == 0) bytes = 0;
  const int n = load_cand_set(c, ctl, cand);  // its barriers order `bytes`
  if (n == 0) return;
  const int n_rows = ctl[NROWS];
  const bool full = n_rows > KB;
  RowBuf &rb = bufs[threadIdx.x >> 5];
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  unsigned long long moved = 0;
  if (!full) {
    for (int li = warp; li < n_rows; li += n_warps)
      moved += apply_row(rb, tok, wid, freq, B, rows[li], ext, c, n, false, keys, cnts, cap, ctl);
    if (blockIdx.x == 0 && threadIdx.x == 0) work[W_ROWS] += n_rows;
  } else {
    for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < cap; s += gridDim.x * blockDim.x) {
      keys[s] = kEmpty;
      cnts[s] = 0;
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      ctl[OCC] = 0;
      work[W_FULL] += 1;
      moved = 12ull * cap;
    }
    grid_wait(ctl);
    for (int r = warp; r < NL; r += n_warps)
      moved += apply_row(rb, tok, wid, freq, B, r, ext, c, n, true, keys, cnts, cap, ctl);
  }
  if ((threadIdx.x & 31) == 0 && moved) atomicAdd(&bytes, moved);
  __syncthreads();
  if (threadIdx.x == 0 && bytes) atomicAdd((unsigned long long *)(work + W_APPLY), bytes);
  if (full) grid_leave(ctl);
}

// Blocks of apply_rows_kernel that the card holds at once.
int apply_grid() {
  static int blocks = 0;
  if (!blocks) blocks = wave_blocks(apply_rows_kernel, 32 * kRowWarps);
  return blocks;
}

// Blocks of flag_rows_kernel that the card holds at once.
int flag_grid() {
  static int blocks = 0;
  if (!blocks) blocks = wave_blocks(flag_rows_kernel, 256);
  return blocks;
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

// One round's merge of the accepted candidates: the rows below NL with a hit
// flagged (flag_rows_kernel), then the block path (at most KB rows, table
// deltas) or the full path (every row, the table counted again) in one
// cooperative launch (apply_rows_kernel).  tok 16-byte aligned, B 128, 256
// or 512; ext the rows' extents; ctl's barrier slots 0.
int yttm_block_apply(void *tok, void *wid, const void *freq, int B, int NL, void *ext,
                     void *rows, int KB, void *keys, void *cnts, int cap, void *ctl,
                     const void *cand, void *work, void *stream) {
  if ((B != 128 && B != 256 && B != 512) || NL < 0 || cap <= 0 || (cap & (cap - 1)) != 0 ||
      ((uintptr_t)tok & 15u))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  flag_rows_kernel<<<flag_grid(), 256, 0, s>>>(
      (const int32_t *)tok, (const int32_t *)wid, B, NL, (const int32_t *)ext, (int32_t *)ctl,
      (const int32_t *)cand, (int32_t *)rows, (long long *)work);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  void *args[] = {&tok, &wid, &freq, &B, &NL, &ext, &rows, &KB, &keys, &cnts, &cap, &ctl,
                  &cand, &work};
  return (int)cudaLaunchCooperativeKernel((const void *)apply_rows_kernel, dim3(apply_grid()),
                                          dim3(32 * kRowWarps), args, 0, s);
}

}  // extern "C"
