// The count of every pair of a word-laid stream into an empty table, on
// Hopper: v2's pair_count (train_delta.cu, into the table: OCC, OVERFLOW)
// and the sharded v2 trainer's shard_recount (train_delta_sharded.cu, into
// a shard's scratch table: ROCC, ROVF) run this kernel, templated on the
// ctl slots it writes.
//
// The old design gave each word a warp (add_word: words hold ~8 slots, so
// ~3/4 of the lanes idled in every step), sent one global atomicAdd a
// counted pair (the first count puts 8.4 M live tokens on 702 keys:
// same-address contention) and one on ctl[OCC] a claimed key: 2.38 ms over
// the v2 run's 4 counts (torch.profiler, H100 80GB HBM3, 700 W), 56x its
// bound.
//
// The count has its own path (the applies and v5's and v4's counts keep
// add_word and table_add; v3's counts walk the tombstoned stream with this
// header's block table, tomb_count.cuh, v1's its flat stream,
// stream_count.cuh, and v0's its rows, train_bucketed.cu, whose sharded
// counts also list their claims by part; all share chunk_counted's run
// parity):
//  * the stream is walked flat, not a word a warp: a warp takes a
//    contiguous run of 128-slot chunks, a lane 4 slots by one 16-byte load
//    of the tokens and one of pwid; a pair's weight is fw[pwid].  Run parity
//    (floor(r/2) pairs in a run of r equal tokens) comes from a warp max
//    scan of the slots that start no equal pair, carried from chunk to
//    chunk; a warp's first chunk finds its carry by walking back over a run
//    that crosses into it.  Separators and PAD break pairs (a pair needs two
//    live tokens, and every word ends with a separator), so no word offset
//    is read.  (Packing short words over the lanes, as word_apply.cuh does
//    for the apply, would read each word's offsets and keep lanes idle at
//    a pack's end; the flat walk keeps every lane on a slot.)
//  * each block counts into a table of its own in shared memory (2048
//    slots of key and count): a counted pair takes its key's home slot
//    when that is free or holds its key (one shared atomic), else it goes
//    to the global table, the lane's pending pairs of a chunk with their
//    first probes loaded together.  At the block's end each live shared
//    slot is added to the global table once: at the first count ~8.4 M
//    global atomics become about (blocks x 702).  Variants timed on the
//    100 MB run's four counts while this was designed (H100 80GB HBM3,
//    700 W): one probe in the shared table beat two and eight (in a nearly
//    full table the lanes' probe loops diverge), and summing equal keys in
//    the warp first (__match_any_sync, __reduce_add_sync) cost more than
//    the shared atomics it saved.  The rebuilds (2.6 x 10^5 - 10^6 keys)
//    spend most of their time in the global table's atomics, which the
//    block tables cut only where keys repeat within a block.
//  * the global slots a block claims are counted once a block on ctl[OCC]
//    (as the resplit does), not once a claim.  The table's contract holds:
//    at the end it is exact, or OVF is set (a claim past half the slots,
//    counted at the block's end, or a full probe sequence) and the host
//    counts again at twice the size.  An overflow is seen later than a
//    claim at a time would see it, never missed; a probe still stops every
//    32 slots once it is seen.
//  * a grid of one wave, sized by occupancy.
//  * an optional gate: the shard's count runs only when some shard's
//    delta buffer overflowed (a slot of a list of ctl arrays), a test
//    every block makes before its first barrier.
//
// Bound: the live tokens (4 B each), the words' weights and offsets, and the
// filled slots (key and count, 12 B each).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "train_common.cuh"

namespace yttm {

constexpr int kCountThreads = 256;
constexpr int kCountSlots = 2048;  // a block's shared table
// blocks of a count an SM that its registers must allow (48 a thread): left
// to themselves the listed counts (v1's and v0's) took more, 4 blocks an
// SM, and the sharded v1 count took 2168-2172 ms over the 100 MB run
// against 1650-1688 at 5 (chip_smoke.compare_tree, H100 80GB HBM3, 700 W)
constexpr int kCountBlocksSM = 5;

// What a count does with a global slot it claims beyond counting it: nothing
// (the counts into a replica's own table), or list it by its key's part
// (the sharded v1 and v0 counts: part_list.cuh, stream_count.cuh).
struct NoList {
  __device__ __forceinline__ void claim(unsigned, unsigned long long) const {}
};

// table_add in count mode from the first slot h & (cap - 1), but a claim is
// returned (1), not counted in ctl[OCC], and handed to `list`; a full probe
// sequence sets OVF.
template <int OVF, class List = NoList>
__device__ int count_put(unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl,
                         unsigned long long key, int32_t delta, unsigned h,
                         const List &list = List()) {
  const unsigned mask = (unsigned)cap - 1u;
  for (int p = 0; p < cap; ++p) {
    if ((p & 31) == 31 && __ldcg(ctl + OVF)) return 0;
    const unsigned s = (h + (unsigned)p) & mask;
    unsigned long long k = __ldcg(keys + s);
    if (k == kEmpty) {
      k = atomicCAS(keys + s, kEmpty, key);
      if (k == kEmpty) {
        atomicAdd(cnts + s, delta);
        list.claim(s, key);
        return 1;
      }
    }
    if (k == key) {
      atomicAdd(cnts + s, delta);
      return 0;
    }
  }
  atomicExch(ctl + OVF, 1);
  return 0;
}

// The last slot before p0 that starts no equal pair (-1: none), by the
// whole warp, 32 slots a step back.
__device__ inline int last_unequal_before(const int32_t *tok, int p0) {
  const int lane = threadIdx.x & 31;
  for (int b = p0 - 32;; b -= 32) {
    const int i = b + lane;
    bool ne = false;
    if (i >= 0) {
      const int32_t a = tok[i], nb = tok[i + 1];
      ne = !(a >= 0 && a == nb);
    }
    const unsigned m = __ballot_sync(kFullMask, ne);
    if (m) return b + 31 - __clz(m);
    if (b <= 0) return -1;
  }
}

// Four slots from p (16-byte aligned), pad past n.
__device__ __forceinline__ void load4(const int32_t *v, int p, int n, int32_t pad,
                                      int32_t (&out)[4]) {
  if (p + 3 < n) {
    const int4 q = __ldg(reinterpret_cast<const int4 *>(v + p));
    out[0] = q.x;
    out[1] = q.y;
    out[2] = q.z;
    out[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = p + j < n ? __ldg(v + p + j) : pad;
  }
}

// The pairs a lane counts among its slots p .. p + 3 of a chunk of a flat
// walk (a: their tokens; nb: each one's right neighbour; pv: the two form a
// pair, two live tokens of one word or row), as bits 0-3: every pair but the
// odd ones of a run of equal pairs (floor(r/2) pairs in a run of r equal
// tokens).  carry: the last slot before the chunk that starts no equal pair
// (-1: none), carried on to the chunk's.  All 32 lanes call it.
__device__ __forceinline__ unsigned chunk_counted(int p, const int32_t (&a)[4],
                                                  const int32_t (&nb)[4], const bool (&pv)[4],
                                                  int &carry) {
  bool eq[4];
  int last_ne = -1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    eq[j] = pv[j] && a[j] == nb[j];
    if (!eq[j]) last_ne = p + j;
  }
  const int incl = warp_max_scan(last_ne);
  int lne = __shfl_up_sync(kFullMask, incl, 1);
  if ((threadIdx.x & 31) == 0) lne = -1;
  lne = lne > carry ? lne : carry;
  const int top = __shfl_sync(kFullMask, incl, 31);
  carry = top > carry ? top : carry;
  unsigned counted = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (!eq[j]) lne = p + j;
    if (pv[j] && (!eq[j] || ((p + j - lne - 1) & 1) == 0)) counted |= 1u << j;
  }
  return counted;
}

// The count's gate: open when gate is null, or when one of the n_gate ctl
// arrays has slot gate_slot set (a lane a ctl, so that the loads are in
// flight together).  Called by all 32 lanes of every warp, before the
// block's first barrier.
__device__ __forceinline__ bool count_gate_open(const int32_t *const *gate, int n_gate,
                                                int gate_slot) {
  if (!gate) return true;
  const int lane = threadIdx.x & 31;
  bool open = false;
  for (int b = 0; b < n_gate; b += 32)
    open |= __any_sync(kFullMask, b + lane < n_gate && __ldcg(gate[b + lane] + gate_slot) != 0);
  return open;
}

// A block's table in shared memory, and the global slots its lanes claimed.
struct BlockTable {
  unsigned long long key[kCountSlots];
  int32_t cnt[kCountSlots];
  int claimed;
};

// Empties the block's table (all threads, ending at a barrier).
__device__ __forceinline__ void block_table_open(BlockTable &bt) {
  for (int s = threadIdx.x; s < kCountSlots; s += blockDim.x) {
    bt.key[s] = kEmpty;
    bt.cnt[s] = 0;
  }
  if (threadIdx.x == 0) bt.claimed = 0;
  __syncthreads();
}

// A lane's counted pairs of a chunk (key kEmpty: none; f their weights), each
// into its key's home slot of the block's table when that is free or holds
// its key (one shared atomic), the others into the global table with their
// first probes loaded together.  Returns the global slots claimed (each
// handed to `list`).
template <int OVF, class List = NoList>
__device__ __forceinline__ int block_table_put(BlockTable &bt, unsigned long long (&key)[4],
                                               const int32_t (&f)[4], unsigned long long *keys,
                                               int32_t *cnts, int cap, int32_t *ctl,
                                               const List &list = List()) {
  volatile unsigned long long *vkey = bt.key;
  const unsigned mask = (unsigned)cap - 1u;
  unsigned h[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (key[j] == kEmpty) continue;
    h[j] = (unsigned)hash64(key[j]);
    const unsigned s = h[j] & (kCountSlots - 1u);
    unsigned long long k = vkey[s];
    if (k == kEmpty) k = atomicCAS(bt.key + s, kEmpty, key[j]);
    if (k == kEmpty || k == key[j]) {
      atomicAdd(bt.cnt + s, f[j]);
      key[j] = kEmpty;
    }
  }
  unsigned long long first[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) first[j] = key[j] != kEmpty ? __ldcg(keys + (h[j] & mask)) : kEmpty;
  int claims = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (key[j] == kEmpty) continue;
    if (first[j] == key[j]) atomicAdd(cnts + (h[j] & mask), f[j]);
    else claims += count_put<OVF>(keys, cnts, cap, ctl, key[j], f[j], h[j], list);
  }
  return claims;
}

// The block's end (all threads): each live slot of its table added to the
// global table once, and the block's claims (the lanes' `claims` with the
// flush's) added to ctl[OCC] once, OVF set past half the slots.  Every claim
// of the block was handed to `list` before its last barrier.
template <int OCC, int OVF, class List = NoList>
__device__ __forceinline__ void block_table_close(BlockTable &bt, int claims,
                                                  unsigned long long *keys, int32_t *cnts,
                                                  int cap, int32_t *ctl,
                                                  const List &list = List()) {
  __syncthreads();
  for (int s = threadIdx.x; s < kCountSlots; s += blockDim.x) {
    const unsigned long long k = bt.key[s];
    if (k != kEmpty)
      claims += count_put<OVF>(keys, cnts, cap, ctl, k, bt.cnt[s], (unsigned)hash64(k), list);
  }
  claims = __reduce_add_sync(kFullMask, claims);
  if ((threadIdx.x & 31) == 0 && claims) atomicAdd(&bt.claimed, claims);
  __syncthreads();
  if (threadIdx.x == 0 && bt.claimed) {
    const int occ = atomicAdd(ctl + OCC, bt.claimed) + bt.claimed;
    if (2ll * occ > (long long)cap) atomicExch(ctl + OVF, 1);
  }
}

// The contiguous run of 128-slot chunks [c0, c1) of a stream of n slots
// that the calling warp walks (a grid of whole warps).
__device__ __forceinline__ void warp_chunks(int n, int &c0, int &c1) {
  const long long warp = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = (gridDim.x * (long long)blockDim.x) >> 5;
  const long long chunks = (n + 127) / 128;
  c0 = (int)(chunks * warp / n_warps);
  c1 = (int)(chunks * (warp + 1) / n_warps);
}

// Counts every pair of tok / pwid (Mw slots) into keys / cnts, claims in
// ctl[OCC], a table more than half full in ctl[OVF].  gate: null, or a
// device array of n_gate ctl pointers, and the count runs only when one of
// them has slot gate_slot set.
template <int OCC, int OVF>
__global__ void __launch_bounds__(kCountThreads)
    pair_count_kernel(const int32_t *tok, const int32_t *pwid, const int32_t *fw, int Mw,
                      unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl,
                      const int32_t *const *gate, int n_gate, int gate_slot) {
  if (!count_gate_open(gate, n_gate, gate_slot)) return;
  __shared__ BlockTable bt;
  block_table_open(bt);
  const int lane = threadIdx.x & 31;
  int c0, c1;
  warp_chunks(Mw, c0, c1);
  int claims = 0;  // global slots this lane claimed
  if (c0 < c1) {
    int carry = c0 ? last_unequal_before(tok, c0 * 128) : -1;
    for (int c = c0; c < c1; ++c) {
      const int p = c * 128 + 4 * lane;
      int32_t a[4], w[4];
      load4(tok, p, Mw, kPad, a);
      load4(pwid, p, Mw, -1, w);
      int32_t after = __shfl_down_sync(kFullMask, a[0], 1);
      if (lane == 31) after = c * 128 + 128 < Mw ? __ldg(tok + c * 128 + 128) : kPad;
      const int32_t nb[4] = {a[1], a[2], a[3], after};
      bool pv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) pv[j] = a[j] >= 0 && nb[j] >= 0;
      const unsigned counted = chunk_counted(p, a, nb, pv, carry);
      unsigned long long key[4];
      int32_t f[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        key[j] = kEmpty;
        if (!((counted >> j) & 1u)) continue;
        key[j] = pair_key(a[j], nb[j]);
        f[j] = __ldg(fw + w[j]);
      }
      claims += block_table_put<OVF>(bt, key, f, keys, cnts, cap, ctl);
    }
  }
  block_table_close<OCC, OVF>(bt, claims, keys, cnts, cap, ctl);
}

// Blocks of `Kernel` (a count kernel of kCountThreads threads) for a stream
// of n slots: one wave at most, a warp at least a 128-slot chunk, and at
// most max_blocks when that is > 0.
template <auto Kernel>
int count_grid(long long n, int max_blocks) {
  static int wave = 0;
  if (!wave) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, kCountThreads, 0);
    wave = sms * (per_sm > 0 ? per_sm : 1);
  }
  long long need = ((n + 127) / 128 + kCountThreads / 32 - 1) / (kCountThreads / 32);
  if (need > wave) need = wave;
  if (max_blocks > 0 && need > max_blocks) need = max_blocks;
  return (int)(need < 1 ? 1 : need);
}

// The count's launch; tok and pwid 16-byte aligned, the table empty and
// ctl[OCC] = ctl[OVF] = 0 (set by the caller, or, behind a gate, by a
// launch before it).
template <int OCC, int OVF>
cudaError_t launch_pair_count(const int32_t *tok, const int32_t *pwid, const int32_t *fw, int Mw,
                              unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl,
                              const int32_t *const *gate, int n_gate, int gate_slot,
                              cudaStream_t s) {
  pair_count_kernel<OCC, OVF><<<count_grid<pair_count_kernel<OCC, OVF>>(Mw, 0), kCountThreads, 0,
                                s>>>(tok, pwid, fw, Mw, keys, cnts, cap, ctl, gate, n_gate,
                                     gate_slot);
  return cudaGetLastError();
}

}  // namespace yttm
