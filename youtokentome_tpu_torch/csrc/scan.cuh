// Device-wide exclusive sum scan of int32 arrays, written by hand: a sum
// per tile of 8192 elements, one block that scans the tile sums, and a
// pass that scans each tile and adds its offset (three launches, in the
// caller's stream).  The stream encode kernels build every compaction on
// it: scan a keep flag (or a count), write each kept element at its
// scanned position.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "encode_common.cuh"

namespace yttm_scan {

using yttm_enc::SumOp;
using yttm_enc::block_exclusive_scan;

constexpr int kThreads = 1024;
constexpr int kItems = 8;  // consecutive elements a thread owns
constexpr int kTile = kThreads * kItems;

inline int n_tiles(long n) { return (int)((n + kTile - 1) / kTile); }

// int32 slots of scratch a scan of n elements needs
inline long scratch_ints(long n) { return n_tiles(n) + 1; }

__global__ void __launch_bounds__(kThreads) tile_sums_kernel(const int32_t *x, int n, int32_t *sums) {
  __shared__ int32_t wbuf[kThreads / 32];
  const long base = (long)blockIdx.x * kTile + (long)threadIdx.x * kItems;
  int32_t s = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (base + k < n) s += x[base + k];
  int32_t total;
  block_exclusive_scan(s, 0, wbuf, &total, SumOp());
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// sums[0, m) -> their exclusive scan; sums[m] and *total (when given) get
// the sum of all
__global__ void __launch_bounds__(kThreads) tile_offsets_kernel(int32_t *sums, int m, int32_t *total) {
  __shared__ int32_t wbuf[kThreads / 32];
  int32_t carry = 0;
  for (int b = 0; b < m; b += kThreads) {
    const int i = b + threadIdx.x;
    const int32_t v = i < m ? sums[i] : 0;
    int32_t t;
    const int32_t e = block_exclusive_scan(v, 0, wbuf, &t, SumOp());
    if (i < m) sums[i] = carry + e;
    carry += t;
  }
  if (threadIdx.x == 0) {
    sums[m] = carry;
    if (total) *total = carry;
  }
}

__global__ void __launch_bounds__(kThreads)
    scan_apply_kernel(const int32_t *x, int32_t *out, int n, const int32_t *sums) {
  __shared__ int32_t wbuf[kThreads / 32];
  const long base = (long)blockIdx.x * kTile + (long)threadIdx.x * kItems;
  int32_t v[kItems];
  int32_t s = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    v[k] = base + k < n ? x[base + k] : 0;
    s += v[k];
  }
  int32_t t;
  int32_t e = block_exclusive_scan(s, 0, wbuf, &t, SumOp()) + sums[blockIdx.x];
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (base + k < n) {
      out[base + k] = e;
      e += v[k];
    }
}

// Exclusive scan of x[0, n) into out (which may be x); *total (when
// given) gets the sum.  sums holds scratch_ints(n) slots.  n >= 1.
inline cudaError_t exclusive_scan(const int32_t *x, int32_t *out, int n, int32_t *sums,
                                  int32_t *total, cudaStream_t stream) {
  const int m = n_tiles(n);
  tile_sums_kernel<<<m, kThreads, 0, stream>>>(x, n, sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tile_offsets_kernel<<<1, kThreads, 0, stream>>>(sums, m, total);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_apply_kernel<<<m, kThreads, 0, stream>>>(x, out, n, sums);
  return cudaGetLastError();
}

}  // namespace yttm_scan
