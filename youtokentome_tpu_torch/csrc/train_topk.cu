// The trainers' shared round selection, on Hopper: the top-k with prefix
// acceptance that v2 (train_delta.cu), v1 (train_stream.cu), v3
// (train_sparse.cu), v4 (train_block.cu) and v0 (train_bucketed.cu, k = 1)
// run each round on their pair-count tables, as one launch a round.
//
// Replaces, in each JAX round loop, train_stream.py _topk_candidates,
// accept_prefix and store_rules (train_kernel.py _argmax_tiebreak for v0).
// The plain torch version is topk_accept_plain in
// youtokentome_tpu_torch/ops/train_kernels.py.
//
// State: the trainer's table (keys [cap] u64, cnts [cap] int32), its ctl
// (the common slots of train_common.cuh, then `n_own` slots of the
// trainer's that every round starts at 0), cand [16, 4], rules, work.
//
// Kernel:
//   topk_select  every block ranks its share of the table in the reference
//                order (count desc, max(x,y) asc, min(x,y) asc, x desc) and
//                keeps its top 16 (with k = 1 its top one); the last block
//                to finish merges the block lists (grid_topk,
//                train_common.cuh), and one of its warps runs
//                accept_prefix_warp (the equal-pair guard, count floor, id
//                budget, intersections; a lane a candidate), writes rules,
//                cand and ctl, and sums the round's work
//
// Bound.  A round reads every slot's count (4 B a slot) and the keys (8 B
// each) of the slots whose count reaches the round's 16th largest, since
// any other slot ranks below 16 others whatever its key: on v2's 100 MB /
// vocab-30000 table, 2^22 slots at the end, ~5 us a round at 3.35 TB/s
// (PERF.md row 5b sums it over the run's rounds).  The old design took ~200
// us a round (torch.profiler, H100 80GB HBM3, 700 W: pass 1 150 us, pass 2
// 53 us): two launches, a thread's list of 16 with a key loaded inside each
// insert, block merges of 16 argmax rounds, and a second pass on one
// block.  The new one is
// train_common.cuh's top-k section: one word a slot, warp queues behind a
// count bar, keys loaded in batches, bitonic merges, and the cross-block
// merge and a warp's acceptance in the last block of the same launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "train_common.cuh"

namespace {

using namespace yttm;

// K: the candidates the kernel keeps, kK (any k) or 1 (k = 1, v0's top
// pair, which the kK lists hold first too)
template <int K>
__global__ void __launch_bounds__(kSelThreads, 2)
    topk_select_kernel(const unsigned long long *keys, const int32_t *cnts, int cap,
                       unsigned long long *blk_hi, uint32_t *blk_lo, unsigned *ticket,
                       int32_t *ctl, int32_t *cand, int32_t *rules, int limit, int vocab,
                       int used_ids0, int k, int n_own, long long *work, bool wide) {
  __shared__ int top_c[K];
  __shared__ unsigned long long top_k[K];
  if (blockIdx.x == 0 && threadIdx.x < n_own) ctl[CTL_OWN + threadIdx.x] = 0;
  // every block reads the round control before it takes its ticket, and
  // only the last block writes it
  if (!round_active(ctl, limit, vocab)) {
    if (blockIdx.x == 0 && threadIdx.x == 0) ctl[NACC] = 0;
    return;
  }
  const int used = ctl[USED], occ = ctl[OCC];  // loaded now, used by the last block
  if (!grid_topk<K>(keys, cnts, cap, wide, blk_hi, blk_lo, ticket, top_c, top_k)) return;
  if (threadIdx.x >= 32) return;
  const int n_acc = accept_prefix_warp(top_c, top_k, k, used, vocab, 0, cand, rules, used_ids0);
  if (threadIdx.x != 0) return;
  ctl[USED] = used + n_acc;
  ctl[DONE] = n_acc == 0;
  ctl[NACC] = n_acc;
  // sums that no one waits on
  atomicAdd(ctl + ROUND, 1);
  unsigned long long *w = (unsigned long long *)work;
  atomicAdd(w + W_ROUNDS, 1ull);
  atomicAdd(w + W_OCC, (unsigned long long)(long long)occ);
  atomicAdd(w + W_SLOTS, (unsigned long long)cap);
}

}  // namespace

extern "C" {

// One round's candidate selection and acceptance, on n_blk blocks.  blk_hi
// and blk_lo hold n_blk * 16 entries of scratch; *ticket is 0 (each launch
// leaves it so).  cnts is 16-byte aligned.
int yttm_topk_accept(const void *keys, const void *cnts, int cap, void *blk_hi, void *blk_lo,
                     int n_blk, void *ticket, void *ctl, void *cand, void *rules, int limit,
                     int vocab, int used_ids0, int k, int n_own, void *work, void *stream) {
  if (cap <= 0 || n_blk <= 0 || n_blk > kSelMaxBlocks || k <= 0 || k > kK || n_own < 0 ||
      n_own > kSelThreads ||
      ((uintptr_t)cnts & 15u))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool wide = vocab > 65536;  // ids below vocab: narrow words hold them all
  if (k == 1)
    topk_select_kernel<1><<<n_blk, kSelThreads, 0, s>>>(
        (const unsigned long long *)keys, (const int32_t *)cnts, cap, (unsigned long long *)blk_hi,
        (uint32_t *)blk_lo, (unsigned *)ticket, (int32_t *)ctl, (int32_t *)cand, (int32_t *)rules,
        limit, vocab, used_ids0, k, n_own, (long long *)work, wide);
  else
    topk_select_kernel<kK><<<n_blk, kSelThreads, 0, s>>>(
        (const unsigned long long *)keys, (const int32_t *)cnts, cap, (unsigned long long *)blk_hi,
        (uint32_t *)blk_lo, (unsigned *)ticket, (int32_t *)ctl, (int32_t *)cand, (int32_t *)rules,
        limit, vocab, used_ids0, k, n_own, (long long *)work, wide);
  return (int)cudaGetLastError();
}

}  // extern "C"
