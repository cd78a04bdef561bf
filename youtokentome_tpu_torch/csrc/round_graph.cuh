// The round graph of the sharded trainers whose shards share one card: v2
// (train_delta_sharded.cu yttm_shard_graph) and v3 (train_sparse_sharded.cu
// yttm_sparse_shard_graph) build theirs with build_round_graph.
//
// A round is one CUDA graph that the host replays n times a batch: every
// shard's top-k and its shard-local half (the merge and its delta buffer),
// then a gate kernel (one warp, a lane a shard) that reads every shard's DOVF
// and sets two conditional handles (cudaGraphSetConditional): an IF node over
// the recount branch (every shard's recount, then the rebuild fold) and an
// IF node over the delta fold; this is the JAX programs' lax.cond on the
// card.  (An IF/ELSE node needs CUDA 12.8; two IF nodes run on every toolkit
// with conditional nodes.)  The graph is built by stream capture of the C
// entries; an entry of another library (the top-k of libtrain_topk.so, and
// for v3 the folds of libtrain_delta_sharded.so) is captured through its
// address, and launches on the stream it is given.  The IF bodies are
// captured into the conditional nodes' graphs
// (cudaStreamBeginCaptureToGraph).  A graph holds every shard's pointers and
// sizes and the segment's limit (the top-k's argument): the host builds
// another when any of them changes (a relay, a regrow, a new segment).
// runs[0] counts the gate's runs (the replays), runs[1] the recount
// branch's (the rebuild fold's last kernel).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <vector>

#include "shard_exchange.cuh"

namespace yttm {

// One shard's buffers and sizes for the round graph, as the host lays them
// out: an int64 a field (pointers as addresses), in this order.  v3 puts its
// tombstoned stream t, pw and its end off[W] in tok, pwid and Mw.
struct GraphShard {
  long long keys, cnts, cap, blk_hi, blk_lo, n_blk, ticket, ctl, cand, rules, work, tok, pwid, Mw,
      off, fw, W, rkeys, rcnts;
};
static_assert(sizeof(GraphShard) == 19 * 8, "the host lays a graph shard out as 19 int64");

// yttm_topk_accept's type (train_topk.cu)
typedef int (*TopkFn)(const void *, const void *, int, void *, void *, int, void *, void *, void *,
                      void *, int, int, int, int, int, void *, void *);
// yttm_shard_fold_delta's and yttm_shard_fold_rebuild's (train_delta_sharded.cu)
typedef int (*FoldDeltaFn)(const void *, int, int, const void *, const void *, const void *, int,
                           int, void *);
typedef int (*FoldRebuildFn)(const void *, int, int, const void *, const void *, const void *,
                             int, void *, void *);

__global__ void round_gate_kernel(const int32_t *const *ctls, int n_sh,
                                  cudaGraphConditionalHandle recount,
                                  cudaGraphConditionalHandle delta, long long *runs) {
  const bool any = warp_any_flag(ctls, n_sh, DOVF);  // one warp
  if (threadIdx.x != 0) return;
  cudaGraphSetConditional(recount, any ? 1u : 0u);
  cudaGraphSetConditional(delta, any ? 0u : 1u);
  runs[0] += 1;
}

struct ShardGraph {
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
};

inline cudaError_t capture_info(cudaStream_t s, cudaGraph_t *g, const cudaGraphNode_t **deps,
                                size_t *n) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, g, deps, nullptr, n);
#else
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, g, deps, n);
#endif
  if (e == cudaSuccess && status != cudaStreamCaptureStatusActive) e = cudaErrorStreamCaptureInvalidated;
  return e;
}

// An IF node on `handle` after the capture's current nodes; *body gets the
// graph that runs when the handle is set.
inline cudaError_t add_if(cudaGraph_t g, const cudaGraphNode_t *deps, size_t n,
                          cudaGraphConditionalHandle handle, cudaGraphNode_t *node,
                          cudaGraph_t *body) {
  cudaGraphNodeParams cp{};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeIf;
  cp.conditional.size = 1;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaGraphAddNode(node, g, deps, nullptr, n, &cp);
#else
  cudaError_t e = cudaGraphAddNode(node, g, deps, n, &cp);
#endif
  if (e == cudaSuccess) *body = cp.conditional.phGraph_out[0];
  return e;
}

// Frees a round graph (null: nothing).
inline int shard_graph_free(ShardGraph *sg) {
  if (!sg) return 0;
  cudaError_t e = sg->exec ? cudaGraphExecDestroy(sg->exec) : cudaSuccess;
  if (sg->graph) {
    const cudaError_t f = cudaGraphDestroy(sg->graph);
    if (e == cudaSuccess) e = f;
  }
  delete sg;
  return (int)e;
}

// n replays of a round graph on `stream`.
inline int shard_graph_launch(ShardGraph *sg, int n, cudaStream_t stream) {
  if (!sg || n < 0) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n; ++i) {
    const cudaError_t e = cudaGraphLaunch(sg->exec, stream);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// Builds the round graph of n_sh shards (ctls: the device array of their ctl
// pointers; runs: 2 int64 on the card): local(s) enqueues a round's
// shard-local half of every shard on the capture stream s, recount(b) the
// recount branch and delta(b) the delta fold on the stream b that captures
// each IF body; each returns a cudaError_t.  *out gets the instantiated
// graph; on an error everything made is freed and the error returned.
template <class Local, class Recount, class Delta>
int build_round_graph(void **out, const void *ctls, int n_sh, void *runs, Local local,
                      Recount recount, Delta delta) {
  *out = nullptr;
  ShardGraph *sg = new ShardGraph();
  cudaStream_t s = nullptr, b = nullptr;
  cudaError_t e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (e == cudaSuccess) e = cudaStreamCreateWithFlags(&b, cudaStreamNonBlocking);
  bool capturing = false;
  if (e == cudaSuccess) {
    e = cudaStreamBeginCapture(s, cudaStreamCaptureModeRelaxed);
    capturing = e == cudaSuccess;
  }
  cudaGraph_t g = nullptr;
  const cudaGraphNode_t *deps = nullptr;
  size_t n_deps = 0;
  cudaGraphConditionalHandle h_rec = 0, h_delta = 0;
  if (e == cudaSuccess) e = capture_info(s, &g, &deps, &n_deps);
  if (e == cudaSuccess) e = cudaGraphConditionalHandleCreate(&h_rec, g, 0, cudaGraphCondAssignDefault);
  if (e == cudaSuccess)
    e = cudaGraphConditionalHandleCreate(&h_delta, g, 0, cudaGraphCondAssignDefault);
  if (e == cudaSuccess) e = local(s);
  if (e == cudaSuccess) {
    round_gate_kernel<<<1, 32, 0, s>>>((const int32_t *const *)ctls, n_sh, h_rec, h_delta,
                                      (long long *)runs);
    e = cudaGetLastError();
  }
  cudaGraphNode_t conds[2];
  cudaGraph_t body[2];
  std::vector<cudaGraphNode_t> gate;  // the capture's last node, which both IF nodes follow
  if (e == cudaSuccess) e = capture_info(s, &g, &deps, &n_deps);
  if (e == cudaSuccess) gate.assign(deps, deps + n_deps);
  if (e == cudaSuccess) e = add_if(g, gate.data(), gate.size(), h_rec, &conds[0], &body[0]);
  if (e == cudaSuccess) e = add_if(g, gate.data(), gate.size(), h_delta, &conds[1], &body[1]);
  for (int i = 0; i < 2 && e == cudaSuccess; ++i) {
    e = cudaStreamBeginCaptureToGraph(b, body[i], nullptr, nullptr, 0, cudaStreamCaptureModeRelaxed);
    if (e != cudaSuccess) break;
    e = i == 0 ? recount(b) : delta(b);
    cudaGraph_t got = nullptr;
    const cudaError_t f = cudaStreamEndCapture(b, &got);
    if (e == cudaSuccess) e = f;
  }
  if (e == cudaSuccess) {
#if CUDART_VERSION >= 13000
    e = cudaStreamUpdateCaptureDependencies(s, conds, nullptr, 2, cudaStreamSetCaptureDependencies);
#else
    e = cudaStreamUpdateCaptureDependencies(s, conds, 2, cudaStreamSetCaptureDependencies);
#endif
  }
  if (capturing) {
    const cudaError_t f = cudaStreamEndCapture(s, &sg->graph);
    if (e == cudaSuccess) e = f;
  }
  if (e == cudaSuccess) e = cudaGraphInstantiate(&sg->exec, sg->graph, 0);
  if (b) cudaStreamDestroy(b);
  if (s) cudaStreamDestroy(s);
  if (e != cudaSuccess) {
    shard_graph_free(sg);
    return (int)e;
  }
  *out = sg;
  return 0;
}

}  // namespace yttm
