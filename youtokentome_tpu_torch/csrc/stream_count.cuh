// The count of every pair of the v1 stream into an empty table, on Hopper:
// the v1 trainer's recount (train_stream.cu, into the table: OCC, OVERFLOW)
// and the sharded v1 trainer's stream_shard_count (into a shard's scratch
// table: ROCC, ROVF, its claims listed by part for shard_part_fold) run
// this kernel, templated on the ctl slots it writes and on the listing.
//
// Replaces what the JAX program counts every round:
//   youtokentome_tpu/ops/train_stream.py:96 pair_keys_and_weights and
//   :65 _segment_counts_flat (and the sharded program's, at
//   youtokentome_tpu/parallel/train_stream_sharded.py:42):
// the stream t / wid holds the live tokens front-compacted (t[0, live),
// PAD after them) and no separator, in the one of its two buffers that the
// round reads (StreamCtl below: the apply writes the other); (t[i],
// t[i+1]) is a pair when
// wid[i] == wid[i+1] and i + 1 < live, it weighs freq[wid[i]] (not counted
// at 0), and a run of r equal tokens inside a word counts floor(r/2).
//
// The old design was three launches a round: a clear, a pass that found
// each 8192-position tile's run carry, and a count of 8 positions a thread
// that sent every counted pair to the global table with its own table_add
// (a CAS or an atomicAdd on the key's slot, and an atomicAdd on ctl[OCC]
// for every claim).  The first count puts 8.4 M live tokens on 702 keys:
// the same-address contention that v2's pair_count gave up (2.312 s over
// the 100 MB run's 3,321 rounds, 48x its bound; H100 80GB HBM3, 700 W).
// This kernel takes over pair_count.cuh's design, with v1's walk:
//  * the stream is walked flat: a warp takes a contiguous run of 128-slot
//    chunks of the live prefix, a lane 4 slots by one 16-byte load of t and
//    one of wid.  A pair needs two live slots of one word id.
//  * run parity comes from a warp max scan of the slots that start no
//    equal pair, carried from chunk to chunk.  A warp's first chunk finds
//    its carry by walking back, a warp 32 slots a step, over the run that
//    crosses into it (stream_unequal_before).  The walk stops at the run's
//    word's first token, and in the common case reads one step; the old
//    tile pre-pass read t and wid of every live slot once more, and cost a
//    launch a round.
//  * the counted pairs go to the block's table in shared memory, flushed
//    once a key a block; the claims are counted once a block; a grid of one
//    wave (pair_count.cuh).  The table's contract holds: at the end it is
//    exact, or OVF is set and the host counts again at twice the size.
//  * the sharded count lists every slot it claims in its key's part
//    (part_list.cuh): a claim is staged in the block's shared memory
//    (BlockList, kListStage slots; past them a claim is listed at once),
//    and at the block's end the block reserves its entries in each part's
//    list with one atomic a part, so that shard_part_fold reads only the
//    entries of its part.
//
// Bound: the live tokens (t and wid, 8 B each), the word weights, and the
// filled slots (key and count, 12 B each).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "pair_count.cuh"
#include "part_list.cuh"
#include "train_common.cuh"

namespace yttm {

// v1's slots of ctl past the shared ones (train_common.cuh Ctl): the live
// tokens of the buffer the round reads (the count sets it from the next
// one, which the apply writes), and past the sharded exchange's slots
// (ops/delta_sharded_kernels.py CTL_N = 16) the stream's two buffers: the
// one the round reads, the one the apply wrote (the count's clear makes it
// the read one), and the live end that the other buffer still holds (its
// slots past it are PAD).
enum StreamCtl { kLive = CTL_OWN, kNextLive, kBuf = 16, kNextBuf, kPrevEnd, kStreamCtlN };

// The stream's two buffers: tokens and word ids.
struct StreamBufs {
  int32_t *t[2];
  int32_t *w[2];
};

// The last slot before p0 (0 < p0 < live) that starts no equal pair (-1:
// none), by the whole warp, 32 slots a step back.  Every slot before p0 is
// live and pairs with the next one when both hold one word id, so the walk
// ends at the latest at the first token of p0's word.
__device__ inline int stream_unequal_before(const int32_t *t, const int32_t *wid, int p0) {
  const int lane = threadIdx.x & 31;
  for (int b = p0 - 32;; b -= 32) {
    const int i = b + lane;
    bool ne = false;
    if (i >= 0) ne = !(wid[i] == wid[i + 1] && t[i] == t[i + 1]);
    const unsigned m = __ballot_sync(kFullMask, ne);
    if (m) return b + 31 - __clz(m);
    if (b <= 0) return -1;
  }
}

// The walk of one block: every pair of the live prefix of t / wid (n
// slots) counted through the block's table bt, each global claim handed to
// `list` (NoList, or the block's BlockList).
template <int OCC, int OVF, class List>
__device__ __forceinline__ void stream_count_block(const int32_t *t, const int32_t *wid,
                                                   const int32_t *freq, int n,
                                                   unsigned long long *keys, int32_t *cnts,
                                                   int cap, int32_t *ctl, BlockTable &bt,
                                                   const List &list) {
  block_table_open(bt);  // its barrier covers the list's stage too
  const int lane = threadIdx.x & 31;
  int c0, c1;
  warp_chunks(n, c0, c1);
  int claims = 0;  // global slots this lane claimed
  if (c0 < c1) {
    int carry = c0 ? stream_unequal_before(t, wid, c0 * 128) : -1;
    for (int c = c0; c < c1; ++c) {
      const int p = c * 128 + 4 * lane;
      int32_t a[4], w[4];
      load4(t, p, n, kPad, a);
      load4(wid, p, n, -1, w);
      int32_t after = __shfl_down_sync(kFullMask, a[0], 1);
      int32_t after_w = __shfl_down_sync(kFullMask, w[0], 1);
      if (lane == 31) {
        const int q = c * 128 + 128;
        after = q < n ? __ldg(t + q) : kPad;
        after_w = q < n ? __ldg(wid + q) : -1;
      }
      const int32_t nb[4] = {a[1], a[2], a[3], after};
      const int32_t nw[4] = {w[1], w[2], w[3], after_w};
      bool pv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) pv[j] = a[j] >= 0 && nb[j] >= 0 && w[j] == nw[j];
      const unsigned counted = chunk_counted(p, a, nb, pv, carry);
      unsigned long long key[4];
      int32_t f[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        key[j] = kEmpty;
        if (!((counted >> j) & 1u)) continue;
        f[j] = __ldg(freq + w[j]);
        if (f[j] > 0) key[j] = pair_key(a[j], nb[j]);
      }
      claims += block_table_put<OVF>(bt, key, f, keys, cnts, cap, ctl, list);
    }
  }
  block_table_close<OCC, OVF>(bt, claims, keys, cnts, cap, ctl, list);
}

// Counts every pair of the live prefix of the buffer the round reads
// (ctl[kBuf]; ctl[kLive] slots, 16-byte aligned) into keys / cnts, claims
// in ctl[OCC], a table more than half full in ctl[OVF], and with kLists
// every claim listed in pl; a no-op unless the round loop runs
// (block_active).  The table is empty and ctl[OCC] = ctl[OVF] = 0 (the
// clear before it).  The BlockList is built here, in the kernel, from its
// stage's address: returned by a function (a factory, a lambda), the same
// list made the listed count fault on the card (an illegal instruction and
// stray global writes; cause not found), built in place it did not.  The
// count without lists takes 40 registers a thread: 6 blocks an SM.
template <int OCC, int OVF, bool kLists>
__global__ void
__launch_bounds__(kCountThreads, kLists ? kCountBlocksSM : kCountBlocksSM + 1)
    stream_count_kernel(StreamBufs bufs, const int32_t *freq, unsigned long long *keys,
                        int32_t *cnts, int cap, int32_t *ctl, PartLists pl, int limit,
                        int vocab) {
  if (!block_active(ctl, limit, vocab)) return;
  const int n = ctl[kLive];
  const bool b = ctl[kBuf];  // picked without indexing: no local copy of bufs
  const int32_t *t = b ? bufs.t[1] : bufs.t[0], *wid = b ? bufs.w[1] : bufs.w[0];
  __shared__ BlockTable bt;
  if constexpr (kLists) {
    __shared__ ListStage<kListStage> stage;
    const BlockList<kListStage, kCountThreads> list{pl, &stage};
    list.open();
    stream_count_block<OCC, OVF>(t, wid, freq, n, keys, cnts, cap, ctl, bt, list);
    list.close(keys);
  } else {
    stream_count_block<OCC, OVF>(t, wid, freq, n, keys, cnts, cap, ctl, bt, NoList{});
  }
}

// The count's launch over a stream of M slots a buffer (the live prefix
// read from ctl[kLive] on the card), at most max_blocks blocks when that is
// > 0 (else one wave).
template <int OCC, int OVF, bool kLists>
cudaError_t launch_stream_count(const StreamBufs &bufs, const int32_t *freq, int M,
                                unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl,
                                const PartLists &pl, int limit, int vocab, int max_blocks,
                                cudaStream_t s) {
  stream_count_kernel<OCC, OVF, kLists>
      <<<count_grid<stream_count_kernel<OCC, OVF, kLists>>(M, max_blocks), kCountThreads, 0, s>>>(
          bufs, freq, keys, cnts, cap, ctl, pl, limit, vocab);
  return cudaGetLastError();
}

}  // namespace yttm
