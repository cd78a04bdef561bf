// The parts of the partitioned fold (the sharded v1 and v0 trainers, which
// recount every round: shard_part_fold and shard_gather in
// train_delta_sharded.cu) and the part lists of a shard's scratch table,
// which its count (stream_count.cuh for v1, train_bucketed.cu's for v0)
// fills and the fold reads.
//
// A table of cap slots is cut into n parts: part p is the slots
// [part_lo(p), part_lo(p + 1)) of every replica and holds the keys with
// key_part(key) == p.  A shard's scratch table is laid out as one table
// (a key's probe runs over all its slots); beside it, part p's list,
// plist[part_lo(p), part_lo(p + 1)), holds the scratch slots that keys of
// part p claimed this round, and pcnt[p] counts those claims.  A list holds
// as many entries as the replica's part has slots: a shard with more keys
// of part p than that fills the part on every replica, so the claims past
// it are counted and dropped, and the fold then flags the part full (the
// host doubles the tables).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "train_common.cuh"

namespace yttm {

constexpr int kMaxParts = 64;  // parts of a table: the shards of a mesh
// claims a count block stages: beside its 24 KB table (pair_count.cuh
// BlockTable), 8 blocks of the count still fit an SM
constexpr int kListStage = 512;

// The first slot of part p of a table of cap slots cut in n.
__device__ __forceinline__ long long part_lo(int p, int cap, int n) {
  return (long long)p * cap / n;
}

// The part of a key among n: a multiplicative mix of its two ids, every
// product below 2^63 (the plain version computes it in int64).
__device__ __forceinline__ int key_part(unsigned long long key, int n) {
  const unsigned long long m32 = 0xFFFFFFFFull;
  unsigned long long h = (((key >> 32) * 0x9E3779B1ull) & m32) ^ (((key & m32) * 0x85EBCA77ull) & m32);
  h = ((h ^ (h >> 15)) * 0x2C1B3C6Dull) & m32;
  return (int)((h * (unsigned long long)n) >> 32);
}

// A shard's part lists (above) for its scratch table of cap slots.
struct PartLists {
  int32_t *plist;  // [cap]
  int32_t *pcnt;   // [n]
  int n;
  int cap;
};

// Puts scratch slot s at place `at` of part p's list (dropped past the
// part's size; pcnt counts it all the same).
__device__ __forceinline__ void part_list_put(const PartLists &pl, int p, int at, unsigned s) {
  const long long lo = part_lo(p, pl.cap, pl.n);
  if (at < part_lo(p + 1, pl.cap, pl.n) - lo) pl.plist[lo + at] = (int32_t)s;
}

// A claim listed at once, one global atomic on its part's count.
struct DirectList {
  PartLists pl;
  __device__ __forceinline__ void claim(unsigned s, unsigned long long key) const {
    const int p = key_part(key, pl.n);
    part_list_put(pl, p, atomicAdd(pl.pcnt + p, 1), s);
  }
};

// A block's staged claims (S of them) and, at its end, its entries of each
// part.
template <int S>
struct ListStage {
  int32_t slot[S];
  int32_t n;
  int32_t cnt[kMaxParts];
  int32_t base[kMaxParts];
};

// The listing of a count that stages its claims: each claim staged in the
// block's ListStage (past its S slots, listed at once), the block's entries
// reserved with one atomic a part at its end.  A count's claims land on n
// addresses, so a global atomic a claim serialises on them: v0's count,
// which listed that way at first, took 1626 ms in its count kernel alone
// against 986 ms for the whole count before it listed (15,380 counts of 4
// shards on the 100 MB corpus, H100 80GB HBM3, 700 W).  Build it in the
// kernel, from the stage's address (stream_count.cuh says why), for a block
// of kThreads threads.
template <int S, int kThreads>
struct BlockList {
  PartLists pl;
  ListStage<S> *st;

  // All threads, then a barrier before the first claim.
  __device__ __forceinline__ void open() const {
    for (int p = threadIdx.x; p < pl.n; p += kThreads) st->cnt[p] = 0;
    if (threadIdx.x == 0) st->n = 0;
  }

  __device__ __forceinline__ void claim(unsigned s, unsigned long long key) const {
    const int i = atomicAdd(&st->n, 1);
    if (i < S) st->slot[i] = (int32_t)s;
    else DirectList{pl}.claim(s, key);  // the stage is full
  }

  // All threads, after a barrier behind the block's last claim: each staged
  // slot's part (from the key it holds) and its place among the block's
  // entries of that part, one reservation a part, then the entries
  // written.
  __device__ __forceinline__ void close(const unsigned long long *keys) const {
    constexpr int kPer = S / kThreads;
    const int m = st->n < S ? st->n : S;
    int part[kPer], rank[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < m) {
        part[k] = key_part(__ldcg(keys + st->slot[i]), pl.n);
        rank[k] = atomicAdd(&st->cnt[part[k]], 1);
      }
    }
    __syncthreads();
    if (threadIdx.x < pl.n && st->cnt[threadIdx.x])
      st->base[threadIdx.x] = atomicAdd(pl.pcnt + threadIdx.x, st->cnt[threadIdx.x]);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < m) part_list_put(pl, part[k], st->base[part[k]] + rank[k], (unsigned)st->slot[i]);
    }
  }
};

// The count's reset of its lists (block 0 of the clear before it, which
// empties every slot of the scratch table: emptied through the lists, a
// slot is a scattered 12-byte write, and on the 100 MB sharded v1 run such
// a clear took 30.5 us a count against 7.5 for the whole table streamed,
// H100 80GB HBM3, 700 W).
__device__ __forceinline__ void part_lists_reset(const PartLists &pl) {
  if (blockIdx.x == 0 && threadIdx.x < pl.n) pl.pcnt[threadIdx.x] = 0;
}

}  // namespace yttm
