// Device code shared by the encode kernels (encode_greedy.cu,
// encode_dropout.cu, stream_encode.cu): the rule hash table's probe, the
// block scans and the counter-based coin of BPE-dropout.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace yttm_enc {

constexpr int32_t kPad = -1;
constexpr int32_t kMiss = 0x7FFFFFFF;
constexpr uint32_t kEmptyKey = 0xFFFFFFFFu;
constexpr int32_t kPlaceholderStart = 1000000000;

// The rule table of ops/hashmap.py: pair -> rank, open addressing.
struct Table {
  const uint32_t *kx;
  const uint32_t *ky;
  const int32_t *val;
  uint32_t mask;  // cap - 1, cap a power of two
  int max_probes;
};

// _mix of hashmap.py: murmur-style finalizer, modulo 2**32.
__device__ __forceinline__ uint32_t mix(uint32_t x, uint32_t y) {
  x *= 0x9E3779B1u;
  y *= 0x85EBCA77u;
  uint32_t h = (x ^ y) + 0x165667B1u;
  h ^= h >> 15;
  h *= 0x2545F491u;
  h ^= h >> 13;
  return h;
}

// Linear probe from the home slot.  The table is built wave by wave with
// no deletions, so every slot between a key's home slot and its own slot
// is occupied: the first empty slot proves the key absent.  Negative
// tokens (PAD, NEWLINE) and placeholders never match a stored key.  A
// probe loads the slot's key halves and rank together: one L2 round trip
// a probe, not three in a row on a hit.
__device__ __forceinline__ int32_t lookup(const Table &t, int32_t x, int32_t y) {
  const uint32_t ux = (uint32_t)x, uy = (uint32_t)y;
  const uint32_t h = mix(ux, uy);
  for (int p = 0; p < t.max_probes; ++p) {
    const uint32_t s = (h + (uint32_t)p) & t.mask;
    const uint32_t kx = __ldg(t.kx + s), ky = __ldg(t.ky + s);
    const int32_t v = __ldg(t.val + s);
    if (kx == kEmptyKey) return kMiss;
    if (kx == ux && ky == uy) return v;
  }
  return kMiss;
}

struct MinOp {
  template <class T>
  __device__ T operator()(T a, T b) const { return a < b ? a : b; }
};
struct MaxOp {
  template <class T>
  __device__ T operator()(T a, T b) const { return a > b ? a : b; }
};
struct SumOp {
  template <class T>
  __device__ T operator()(T a, T b) const { return a + b; }
};

template <class T, class Op>
__device__ __forceinline__ T warp_inclusive_scan(T v, Op op) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T u = __shfl_up_sync(0xFFFFFFFFu, v, o);
    if (lane >= o) v = op(v, u);
  }
  return v;
}

// Exclusive scan over the block's threads in thread order (blockDim.x a
// multiple of 32, at most 1024); `*total` gets the reduction of all
// threads.  Every thread must call it.  wbuf holds one T per warp.
template <class T, class Op>
__device__ __forceinline__ T block_exclusive_scan(T v, T identity, T *wbuf, T *total, Op op) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const T incl = warp_inclusive_scan(v, op);
  if (lane == 31) wbuf[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const T w = lane < n_warps ? wbuf[lane] : identity;
    const T wi = warp_inclusive_scan(w, op);
    if (lane < n_warps) wbuf[lane] = wi;
  }
  __syncthreads();
  T excl = __shfl_up_sync(0xFFFFFFFFu, incl, 1);
  if (lane == 0) excl = identity;
  const T result = op(warp ? wbuf[warp - 1] : identity, excl);
  *total = wbuf[n_warps - 1];
  __syncthreads();  // wbuf is reused by the next scan
  return result;
}

// The coin of BPE-dropout: a murmur3-style hash of (seed, global row,
// round, column).  ops/encode_kernel.py:coin_hash computes the same bits
// in int64 torch arithmetic; a candidate drops when (hash >> 8) < thr,
// thr = ceil(p * 2**24).
__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t coin_step(uint32_t h, uint32_t k) {
  k *= 0xCC9E2D51u;
  k = rotl32(k, 15);
  k *= 0x1B873593u;
  h ^= k;
  h = rotl32(h, 13);
  return h * 5u + 0xE6546B64u;
}

// The part of coin_hash that depends on the seed and the row only.
__device__ __forceinline__ uint32_t coin_row(uint32_t seed_lo, uint32_t seed_hi, uint32_t row) {
  return coin_step(coin_step(seed_lo, row), seed_hi);
}

// coin_hash from coin_row's h.
__device__ __forceinline__ uint32_t coin_finish(uint32_t h, uint32_t round, uint32_t col) {
  h = coin_step(h, (round << 16) | col);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t coin_hash(uint32_t seed_lo, uint32_t seed_hi, uint32_t row,
                                              uint32_t round, uint32_t col) {
  return coin_finish(coin_row(seed_lo, seed_hi, row), round, col);
}

}  // namespace yttm_enc
