// The trainers' shared round selection, on Hopper: the top-k with prefix
// acceptance that v2 (train_delta.cu), v1 (train_stream.cu), v3
// (train_sparse.cu), v4 (train_block.cu) and v0 (train_bucketed.cu, k = 1)
// run each round on their pair-count tables.
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
// Kernels:
//   topk_blocks  every block keeps the top 16 live slots of its share of the
//                table in the reference order (count desc, max(x,y) asc,
//                min(x,y) asc, x desc); with k = 1 the top one (the same
//                first entry, without the upkeep of a list of 16)
//   topk_accept  one block merges them; one thread runs accept_prefix (the
//                equal-pair guard, count floor, id budget, intersections),
//                writes rules, cand and ctl, and sums the round's work
//
// Bound.  A round reads every slot's count (4 B a slot) and the keys of the
// live slots (8 B each); at the 100 MB / vocab-30000 point a table of
// 2^19-2^22 slots, ~1-10 us a round at 3.35 TB/s.  What the design does
// about it: one pass over the counts with kUnroll loads in flight a thread,
// a key read only for a count that beats the thread's 16th.

#include <cstdint>
#include <cuda_runtime.h>

#include "train_common.cuh"

namespace {

using namespace yttm;

// K: the candidates the kernels keep, kK (any k) or 1 (k = 1, v0's top
// pair, which the kK lists hold first too)
template <int K>
__global__ void __launch_bounds__(kTopThreads)
    topk_blocks_kernel(const unsigned long long *keys, const int32_t *cnts, int cap,
                       unsigned long long *blk_k, int32_t *blk_c, const int32_t *ctl, int limit,
                       int vocab) {
  if (!round_active(ctl, limit, vocab)) return;
  topk_scan<K>(keys, cnts, cap, blk_k, blk_c);
}

template <int K>
__global__ void __launch_bounds__(kTopThreads)
    topk_accept_kernel(const unsigned long long *blk_k, const int32_t *blk_c, int n_blk,
                       int32_t *ctl, int32_t *cand, int32_t *rules, int limit, int vocab,
                       int used_ids0, int k, int n_own, long long *work, int cap) {
  __shared__ int top_c[K];
  __shared__ unsigned long long top_k[K];
  if (threadIdx.x < n_own) ctl[CTL_OWN + threadIdx.x] = 0;
  if (!round_active(ctl, limit, vocab)) {
    if (threadIdx.x == 0) ctl[NACC] = 0;
    return;
  }
  topk_merge<K>(blk_k, blk_c, n_blk, top_c, top_k);
  if (threadIdx.x != 0) return;
  const int used = ctl[USED];
  const int n_acc = accept_prefix_dev(top_c, top_k, k, used, vocab, 0, cand, rules, used_ids0);
  ctl[USED] = used + n_acc;
  ctl[DONE] = n_acc == 0;
  ctl[NACC] = n_acc;
  ctl[ROUND] += 1;
  work[W_ROUNDS] += 1;
  work[W_OCC] += ctl[OCC];
  work[W_SLOTS] += cap;
}

template <int K>
int launch(const void *keys, const void *cnts, int cap, void *blk_k, void *blk_c, int n_blk,
           void *ctl, void *cand, void *rules, int limit, int vocab, int used_ids0, int k,
           int n_own, void *work, cudaStream_t s) {
  topk_blocks_kernel<K><<<n_blk, kTopThreads, 0, s>>>(
      (const unsigned long long *)keys, (const int32_t *)cnts, cap, (unsigned long long *)blk_k,
      (int32_t *)blk_c, (const int32_t *)ctl, limit, vocab);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  topk_accept_kernel<K><<<1, kTopThreads, 0, s>>>(
      (const unsigned long long *)blk_k, (const int32_t *)blk_c, n_blk, (int32_t *)ctl,
      (int32_t *)cand, (int32_t *)rules, limit, vocab, used_ids0, k, n_own, (long long *)work,
      cap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One round's candidate selection and acceptance.  blk_* hold n_blk * 16
// entries of scratch.
int yttm_topk_accept(const void *keys, const void *cnts, int cap, void *blk_k, void *blk_c,
                     int n_blk, void *ctl, void *cand, void *rules, int limit, int vocab,
                     int used_ids0, int k, int n_own, void *work, void *stream) {
  if (cap <= 0 || n_blk <= 0 || k <= 0 || k > kK || n_own < 0 || n_own > kTopThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return k == 1 ? launch<1>(keys, cnts, cap, blk_k, blk_c, n_blk, ctl, cand, rules, limit, vocab,
                            used_ids0, k, n_own, work, s)
                : launch<kK>(keys, cnts, cap, blk_k, blk_c, n_blk, ctl, cand, rules, limit,
                             vocab, used_ids0, k, n_own, work, s);
}

}  // extern "C"
