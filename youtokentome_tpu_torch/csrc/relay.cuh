// The relay of the word-laid stream (train_delta.cu's layout: word w owns
// tok[off[w], off[w+1]-1), live tokens first, PAD after them, one PAD
// separator): the stream laid out again over its live tokens, every kept
// word its live tokens and a separator.  The v2 trainer (train_delta.cu
// relay) keeps every word; its sharded engine (train_delta_sharded.cu
// shard_relay) drops the words with fewer than two live tokens.  A plan (each
// word's new slot count and keep flag, their scans: scan.cuh), the host's
// read of the new sizes, then the scatter.
//
// Replaces the JAX host loop's re-pack (youtokentome_tpu/ops/train_delta.py:473)
// and youtokentome_tpu/parallel/train_delta_sharded.py:212 _repack_sharded,
// which slice a front-compacted stream; a word-laid stream has no slice.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "pair_count.cuh"
#include "scan.cuh"
#include "train_common.cuh"
#include "word_apply.cuh"

namespace yttm {

// Both kernels walk the stream flat: a thread takes four slots, one 16-byte
// load of tok and one of pwid (both 16-byte aligned), and the token after
// them.  A word's live tokens are front-packed, so a live slot followed by
// PAD ends its word's live run: that one slot knows the word's live count,
// i + 1 - off[w], and writes the word's entries: no loop over a word (a
// thread's walk of a word is a chain of dependent loads), no warp a word
// (~3/4 of its lanes idle).  Bound: the stream read once, the new one
// written once (rows 5d and 12b of PERF.md).

// Per word with a live token: its new slot count lens[w] (live + 1, or 0
// when it holds fewer than min_live live tokens) and keep[w] (keep may be
// null: every word kept); the caller zeroes both, so a word without a live
// token keeps 0 (the v2 trainer's words always hold one: a merge leaves a
// token).
__global__ void __launch_bounds__(256)
    relay_len_kernel(const int32_t *tok, const int32_t *pwid, const int32_t *off, int Mw,
                     int32_t *lens, int32_t *keep, int min_live) {
  const int n_grp = (Mw + 3) >> 2;
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < n_grp; g += gridDim.x * blockDim.x) {
    int32_t t[5], p[4];
    load_group(tok, Mw, g, t);
    load4(pwid, 4 * g, Mw, -1, p);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (t[k] >= 0 && t[k + 1] < 0) {
        const int w = p[k];
        const int live = 4 * g + k + 1 - off[w];
        lens[w] = live >= min_live ? live + 1 : 0;
        if (keep) keep[w] = live >= min_live;
      }
  }
}

// The scatter: each live slot of a kept word (lens[w] > 0) writes its token
// to new_off[w] + (i - off[w]) and the word's new index (new_idx[w], or w
// when new_idx is null: every word kept) to pwid2; the slot that ends the
// word's live run also writes its separator, off2, fw2 and wids2 (wids and
// wids2 may be null).  So every slot of the new stream's
// Mw2 is written, and slots [Mw2, n2) of a longer allocation are set to PAD.
__global__ void __launch_bounds__(256)
    relay_write_kernel(const int32_t *tok, const int32_t *pwid, int Mw, const int32_t *off,
                       const int32_t *fw, const int32_t *wids, const int32_t *lens,
                       const int32_t *new_off, const int32_t *new_idx, int32_t *tok2,
                       int32_t *pwid2, int32_t *off2, int32_t *fw2, int32_t *wids2, int W2,
                       int Mw2, int n2) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    off2[W2] = Mw2;
    for (int i = Mw2; i < n2; ++i) tok2[i] = pwid2[i] = kPad;
  }
  const int n_grp = (Mw + 3) >> 2;
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < n_grp; g += gridDim.x * blockDim.x) {
    int32_t t[5], p[4];
    load_group(tok, Mw, g, t);
    load4(pwid, 4 * g, Mw, -1, p);
    // the word of the last live slot: kept, its first slot, its new
    // first slot and index
    int last = -1, o = 0, no = 0, k2 = 0;
    bool kept = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (t[k] < 0) continue;
      const int w = p[k];
      if (w != last) {
        last = w;
        kept = lens[w] > 0;
        if (kept) {
          o = off[w];
          no = new_off[w];
          k2 = new_idx ? new_idx[w] : w;
        }
      }
      if (!kept) continue;
      const int d = no + 4 * g + k - o;
      tok2[d] = t[k];
      pwid2[d] = k2;
      if (t[k + 1] < 0) {
        tok2[d + 1] = kPad;
        pwid2[d + 1] = kPad;
        off2[k2] = no;
        fw2[k2] = fw[w];
        if (wids2) wids2[k2] = wids[w];
      }
    }
  }
}

// The relay's launches: the plan (lens and keep zeroed, relay_len_kernel,
// then the scans of lens into new_off and totals[0], of keep into new_idx
// and totals[1]; keep and new_idx null: every word kept, no second scan)
// and the scatter; tok and pwid (Mw slots) 16-byte aligned (the caller
// checks).
inline cudaError_t launch_relay_plan(const int32_t *tok, const int32_t *pwid, const int32_t *off,
                                     int Mw, int W, int32_t *lens, int32_t *keep,
                                     int32_t *new_off, int32_t *new_idx, int32_t *scratch,
                                     int32_t *totals, int min_live, cudaStream_t s) {
  cudaError_t e = cudaMemsetAsync(lens, 0, sizeof(int32_t) * W, s);
  if (e == cudaSuccess && keep) e = cudaMemsetAsync(keep, 0, sizeof(int32_t) * W, s);
  if (e != cudaSuccess) return e;
  relay_len_kernel<<<grid_for((Mw + 3) / 4, 256), 256, 0, s>>>(tok, pwid, off, Mw, lens, keep,
                                                               min_live);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = yttm_scan::exclusive_scan(lens, new_off, W, scratch, totals, s);
  if (e != cudaSuccess || !keep) return e;
  return yttm_scan::exclusive_scan(keep, new_idx, W, scratch, totals + 1, s);
}

inline cudaError_t launch_relay_write(const int32_t *tok, const int32_t *pwid, int Mw,
                                      const int32_t *off, const int32_t *fw, const int32_t *wids,
                                      const int32_t *lens, const int32_t *new_off,
                                      const int32_t *new_idx, int32_t *tok2, int32_t *pwid2,
                                      int32_t *off2, int32_t *fw2, int32_t *wids2, int W2,
                                      int Mw2, int n2, cudaStream_t s) {
  relay_write_kernel<<<grid_for((Mw + 3) / 4, 256), 256, 0, s>>>(
      tok, pwid, Mw, off, fw, wids, lens, new_off, new_idx, tok2, pwid2, off2, fw2, wids2, W2,
      Mw2, n2);
  return cudaGetLastError();
}

}  // namespace yttm
