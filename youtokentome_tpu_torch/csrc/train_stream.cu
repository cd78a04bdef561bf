// The v1 stream trainer's merge round, on Hopper: its count (a clear here,
// then stream_count.cuh's flat count), its apply here, and the shared top-k
// of train_topk.cu.
//
// Replaces the JAX device program
//   youtokentome_tpu/ops/train_stream.py:251 train_rounds_resumable
// and what it runs each round: pair_keys_and_weights(_fw),
// _segment_counts_flat (a 3-array sort and a reduce-by-key), _topk_candidates,
// accept_prefix, store_rules, pair_hits, apply_accepted and sort_compact.
// The plain torch versions of the kernels are in
// youtokentome_tpu_torch/ops/stream_train_kernels.py.
//
// State (all on the card; the host reads `ctl` once per batch of rounds):
//   t0, w0, t1, w1 [M] int32
//                      the JAX program's flat stream in two buffers: a round
//                      reads one (ctl[kBuf]) and its apply writes the other.
//                      Each holds its live tokens front-compacted, PAD (-1)
//                      after them; a word is a run of one word id
//   tiles [3 + T] u64  the apply's scratch: a ticket and a count of finished
//                      blocks (the first shard's only), an epoch, and a
//                      descriptor a tile of 4096 slots for the look-back
//   keys [cap] u64, cnts [cap] int32
//                      open-addressing pair-count table, key x << 32 | y,
//                      emptied and counted again every round
//   ctl [19] int32     used, done, overflow, round, n_acc, occupied, error
//                      (train_common.cuh), then stream_count.cuh StreamCtl:
//                      live, next live, the read buffer, the written one, the
//                      other buffer's live end
//   work [8] int64     rounds, occupied slots, table slots scanned (the
//                      top-k's), live tokens and kept tokens of the applied
//                      rounds (summed over the rounds)
//
// Kernels:
//   recount        clear: every slot emptied, and the buffers turned (the
//                  one the last apply wrote is read from now on); count:
//                  stream_count.cuh's flat walk of the live prefix, a warp a
//                  run of 128-slot chunks (16-byte loads of t and wid), run
//                  parity from a warp max scan carried from chunk to chunk,
//                  each block counting into a table of its own in shared
//                  memory, flushed once a key a block, its claims counted
//                  once a block
//   topk_accept    (train_topk.cu) the top 16 in the reference order and
//                  accept_prefix; writes cand, rules, ctl, work
//   apply_compact  one launch a round (a card's shards in one launch): the
//                  merge and the compaction of the live prefix in one pass,
//                  read from one buffer and written into the other
//
// The apply.  The old one made three launches a round over a grid sized to
// the whole buffer (8192 slots a block of 1024 threads, each thread 8
// consecutive slots), rebuilt the tile carries in every block, read each
// live slot three times and wrote it twice (a killed-marked copy, then the
// compacted stream): 837.9 ms over the 100 MB run's 3,320 rounds against a
// bound of 61.2 (H100 80GB HBM3, 700 W).  This one:
//  * a grid of one wave, sized by occupancy (3 blocks of 256 threads an
//    SM, the registers held to 80 a thread); a block takes tiles of 4096
//    slots of the live prefix from a ticket counter, so it only ever waits
//    on tiles that running blocks hold.  A warp takes 4 chunks of 128
//    slots of a tile, a lane 4 slots of a chunk with one 16-byte load of t
//    and one of wid, all four chunks' loads in flight together;
//  * a hit is (t[i], t[i+1]) equal to an accepted candidate (a 1024-bit
//    filter of their first ids in shared memory, then the list), with
//    wid[i] == wid[i+1] and i + 1 < live.  Its parity along a run of hits
//    comes from a warp max scan of the last slot without a hit (the JAX
//    cummax(where(hit, -1, idx))), carried from chunk to chunk; a warp's
//    carry from the warps before it in the tile; the tile's from a walk
//    back over the run of hits that crosses into it (a hit needs one word
//    id, so the walk stops at that word's first token at the latest; the
//    first step's loads are in flight with the tile's).  A slot is
//    dropped when the one before it was selected;
//  * with the parity found locally, a tile's kept count needs no carry:
//    it publishes that count at once and resolves its offset by decoupled
//    look-back over the tiles before it (descriptors tagged with the
//    state's epoch, so that nothing clears them between rounds; published
//    with release and read with acquire semantics).  The kept tokens are
//    staged a warp's chunk in shared memory and written coalesced into the
//    other buffer.  The block that ends last resets the ticket and moves the
//    epochs on;
//  * the destination is PAD from the new live end to its own old live end
//    (the blocks that ran out of tiles write it once the last tile's offset
//    is known); nothing is read after it is written, no marker is written.
//
// The sharded v1 engine (ops/recount_sharded_kernels.py, replacing
// youtokentome_tpu/parallel/train_stream_sharded.py:42 _train_sharded) runs
// the same count on each shard into the shard's scratch table
// (stream_shard_count: its occupancy and overflow in ctl's scratch slots),
// with every claimed slot listed by its key's part (part_list.cuh, staged a
// block).
// train_delta_sharded.cu's shard_part_fold rebuilds each replica's own part
// from the N shards' lists of that part and shard_gather copies the other
// parts in; the top-k runs on every replica and apply_compact once a card
// over every shard's stream (a tile is one shard's; the shards' tiles are
// numbered one after the other).
//
// Every kernel does nothing once `done` or `overflow` is set or `used`
// reached min(vocab, limit), so the host enqueues rounds in batches.  A count
// that fills more than half the table sets `overflow` and stops probing;
// the host doubles the table and the round runs again (nothing was applied).
//
// Bound.  A round reads the live stream in the count (t, wid: 8 B a token)
// and the word frequencies (4 B a word, held in L2), fills the occupied
// slots (12 B) and empties the table (12 B a slot); the apply reads the
// live stream once (8 B a token) and writes the kept tokens once (8 B each).

#include <cstdint>
#include <cuda_runtime.h>

#include "part_list.cuh"
#include "stream_count.cuh"
#include "train_common.cuh"

namespace {

using namespace yttm;

enum { W_LIVE = W_OWN, W_KEEP };

// -- recount -------------------------------------------------------------------

// The clear before a count.  OCC_ and OVF_: the table's occupancy and
// overflow slots (the state's own table; a shard's scratch table in the
// sharded engine, whose overflow flag and part lists are cleared with it).
// Block 0 turns the buffers first, when the last apply wrote the other one.
template <int OCC_, int OVF_, bool kLists>
__global__ void __launch_bounds__(256)
    clear_kernel(unsigned long long *keys, int32_t *cnts, int cap, int32_t *ctl, PartLists pl,
                 int limit, int vocab) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (ctl[kNextBuf] != ctl[kBuf]) {
      ctl[kPrevEnd] = ctl[kLive];
      ctl[kBuf] = ctl[kNextBuf];
    }
    ctl[kLive] = ctl[kNextLive];
  }
  if (!round_active(ctl, limit, vocab)) return;
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < cap; s += gridDim.x * blockDim.x) {
    keys[s] = kEmpty;
    cnts[s] = 0;
  }
  if constexpr (kLists) part_lists_reset(pl);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    ctl[OCC_] = 0;
    if (OVF_ != OVERFLOW) ctl[OVF_] = 0;
  }
}

// -- apply ---------------------------------------------------------------------

constexpr int kApplyThreads = 256;
constexpr int kApplyWarps = kApplyThreads / 32;
constexpr int kWarpChunks = 4;  // 128-slot chunks a warp takes in a tile
constexpr int kWarpSlots = 128 * kWarpChunks;
constexpr int kTileSlots = kWarpSlots * kApplyWarps;
constexpr int kMaxShards = kMaxParts;  // shards of a card in one launch
// blocks an SM that the apply's registers must allow (80 a thread): with
// its registers unbounded (2 blocks an SM) it took 246-247 ms over the 100
// MB v1 run, at 3 blocks, with the walk back's loads in flight with the
// tile's, 201.9 (chip_smoke.compare_tree, H100 80GB HBM3, 700 W)
constexpr int kApplyBlocksSM = 3;
// tiles[]: the ticket and the finished blocks (the first shard's), the epoch,
// then the descriptors
enum { kTicket = 0, kDone, kEpoch, kDesc };

// One shard of an apply launch, as the host lays it out (8 int64).
struct ApplyShard {
  int32_t *t[2];
  int32_t *w[2];
  int32_t *ctl;
  const int32_t *cand;
  unsigned long long *tiles;
  long long *work;
};
static_assert(sizeof(ApplyShard) == 8 * 8, "the host lays an apply shard out as 8 int64");

// The shared state of an apply block.
struct ApplyBlock {
  int pre[kMaxShards + 1];  // each shard's first tile
  int live[kMaxShards], prev[kMaxShards], buf[kMaxShards];
  unsigned tag[kMaxShards];  // this launch's descriptor tag (the epoch + 1)
  Cands c;
  int n_cands;
  unsigned xmask[32];  // bit x & 1023: some candidate's first id
  int wlast[kApplyWarps];  // each warp's last slot without a hit (-1: none)
  int whit[kApplyWarps];   // its last slot holds a hit
  int wkeep[kApplyWarps];  // its kept tokens
  int carry;      // the tile's last slot before it without a hit
  int carry_hit;  // the slot before the tile holds a hit
  int ticket, excl, live2;
  int32_t st[kApplyWarps][128], sw[kApplyWarps][128];  // a warp's kept tokens of a chunk
};

__device__ __forceinline__ void publish(unsigned long long *d, unsigned tag, bool incl,
                                        int value) {
  const unsigned long long v =
      ((unsigned long long)(tag * 2u + (incl ? 1u : 0u)) << 32) | (uint32_t)value;
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(d), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long peek(const unsigned long long *d) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(d) : "memory");
  return v;
}

// The index of the accepted candidate (a, b) is, or -1 (the filter first).
__device__ __forceinline__ int match(const ApplyBlock &sb, int32_t a, int32_t b) {
  if (a < 0 || !((sb.xmask[(a >> 5) & 31] >> (a & 31)) & 1u)) return -1;
  for (int j = 0; j < sb.n_cands; ++j)
    if (a == sb.c.x[j] && b == sb.c.y[j]) return j;
  return -1;
}

// (t[i], t[i+1]) is a hit (i + 1 < n: the word ids differ past the live end).
__device__ __forceinline__ bool hit_at(const ApplyBlock &sb, const int32_t *t, const int32_t *w,
                                       int i) {
  return w[i] == w[i + 1] && match(sb, t[i], t[i + 1]) >= 0;
}

// The last slot before p0 (0 < p0 < n) without a hit (-1: none), by the
// whole warp, 32 slots a step back.  A hit needs one word id on both sides,
// so the walk ends at the latest at the first token of p0's word.
__device__ inline int last_miss_before(const ApplyBlock &sb, const int32_t *t, const int32_t *w,
                                       int p0) {
  const int lane = threadIdx.x & 31;
  for (int b = p0 - 32;; b -= 32) {
    const int i = b + lane;
    const unsigned m = __ballot_sync(kFullMask, i >= 0 && !hit_at(sb, t, w, i));
    if (m) return b + 31 - __clz(m);
    if (b <= 0) return -1;
  }
}

// The candidates of shard `row` (every thread calls it).
__device__ __forceinline__ void load_apply_cands(ApplyBlock &sb, const ApplyShard &row) {
  __syncthreads();
  const int n = row.ctl[NACC];
  if (threadIdx.x < n) {
    sb.c.x[threadIdx.x] = row.cand[threadIdx.x * 4];
    sb.c.y[threadIdx.x] = row.cand[threadIdx.x * 4 + 1];
    sb.c.z[threadIdx.x] = row.cand[threadIdx.x * 4 + 2];
  }
  if (threadIdx.x < 32) {
    unsigned m = 0;
    for (int j = 0; j < n; ++j) {
      const int32_t x = row.cand[j * 4];
      if (((x >> 5) & 31) == (int)threadIdx.x) m |= 1u << (x & 31);
    }
    sb.xmask[threadIdx.x] = m;
  }
  if (threadIdx.x == 0) sb.n_cands = n;
  __syncthreads();
}

// Tile k of shard s: merged, its kept count published, its offset resolved
// by look-back, its kept tokens written into the other buffer; the shard's
// last tile also writes the shard's next live count and buffer.
__device__ __forceinline__ void apply_tile(ApplyBlock &sb, const ApplyShard &row, int s, int k,
                                           int n_tiles) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = sb.live[s], b = sb.buf[s];
  // the buffers picked without indexing: no local copy of the row
  const int32_t *t = b ? row.t[1] : row.t[0], *w = b ? row.w[1] : row.w[0];
  int32_t *dt = b ? row.t[0] : row.t[1], *dw = b ? row.w[0] : row.w[1];
  const int s0 = k * kTileSlots;
  const int p0 = s0 + warp * kWarpSlots;
  int32_t a[kWarpChunks][4], wd[kWarpChunks][4];
#pragma unroll
  for (int c = 0; c < kWarpChunks; ++c) {
    load4(t, p0 + c * 128 + 4 * lane, n, kPad, a[c]);
    load4(w, p0 + c * 128 + 4 * lane, n, -1, wd[c]);
  }
  int32_t tail_t = kPad, tail_w = -1;  // the slot after the warp's (lane 31)
  if (lane == 31 && p0 + kWarpSlots < n) {
    tail_t = __ldg(t + p0 + kWarpSlots);
    tail_w = __ldg(w + p0 + kWarpSlots);
  }
  // warp 0: the first step of the walk back from the tile's start (the 32
  // slots before it and the pairs they start), in flight with the chunks
  const bool walk = warp == 0 && s0 > 0 && s0 < n;
  int32_t back_t[2] = {kPad, kPad}, back_w[2] = {-1, -2};
  if (walk) {
    const int i = s0 - 32 + lane;
    back_t[0] = __ldg(t + i);
    back_t[1] = __ldg(t + i + 1);
    back_w[0] = __ldg(w + i);
    back_w[1] = __ldg(w + i + 1);
  }
  // hits: bit 4c + j; rix: 4 bits a slot
  unsigned hits = 0;
  unsigned long long rix = 0;
  int miss = -1;  // the lane's last slot without a hit
#pragma unroll
  for (int c = 0; c < kWarpChunks; ++c) {
    int32_t nt = __shfl_down_sync(kFullMask, a[c][0], 1);
    int32_t nw = __shfl_down_sync(kFullMask, wd[c][0], 1);
    // the next chunk's first slot (lane 0's), for lane 31
    const int cn = (c + 1) % kWarpChunks;
    const int32_t ct = __shfl_sync(kFullMask, c + 1 < kWarpChunks ? a[cn][0] : 0, 0);
    const int32_t cw = __shfl_sync(kFullMask, c + 1 < kWarpChunks ? wd[cn][0] : 0, 0);
    if (lane == 31) {
      nt = c + 1 < kWarpChunks ? ct : tail_t;
      nw = c + 1 < kWarpChunks ? cw : tail_w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int32_t bt = j < 3 ? a[c][j + 1] : nt;
      const int32_t bw = j < 3 ? wd[c][j + 1] : nw;
      const int r = wd[c][j] == bw ? match(sb, a[c][j], bt) : -1;
      if (r >= 0) {
        hits |= 1u << (4 * c + j);
        rix |= (unsigned long long)r << (4 * (4 * c + j));
      } else {
        miss = p0 + c * 128 + 4 * lane + j;
      }
    }
  }
  // the warp's summary; warp 0 also walks back from the tile's start
  {
    int m = miss;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const int u = __shfl_xor_sync(kFullMask, m, o);
      m = u > m ? u : m;
    }
    if (lane == 0) sb.wlast[warp] = m;
    if (lane == 31) sb.whit[warp] = (hits >> (4 * kWarpChunks - 1)) & 1u;
    if (warp == 0) {
      int l = s0 - 1;
      if (walk) {
        const unsigned mb = __ballot_sync(
            kFullMask, !(back_w[0] == back_w[1] && match(sb, back_t[0], back_t[1]) >= 0));
        l = mb ? s0 - 32 + 31 - __clz(mb) : last_miss_before(sb, t, w, s0 - 32);
      }
      if (lane == 0) {
        sb.carry = l;
        sb.carry_hit = l != s0 - 1;
      }
    }
  }
  __syncthreads();
  int carry = sb.carry;
  for (int v = 0; v < warp; ++v) carry = sb.wlast[v] > carry ? sb.wlast[v] : carry;
  const bool prev_hit = warp == 0 ? sb.carry_hit : sb.whit[warp - 1];
  // the slot before the warp's selected: a hit at an even offset of its run
  bool psel = prev_hit && ((p0 - 2 - carry) & 1) == 0;
  unsigned keep = 0;  // bit 4c + j
  int lane_at[kWarpChunks], chunk_n[kWarpChunks];
  int kept = 0;
#pragma unroll
  for (int c = 0; c < kWarpChunks; ++c) {
    const int p = p0 + c * 128 + 4 * lane;
    int last = -1;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (!((hits >> (4 * c + j)) & 1u)) last = p + j;
    const int incl = warp_max_scan(last);
    int run = __shfl_up_sync(kFullMask, incl, 1);
    if (lane == 0) run = -1;
    run = run > carry ? run : carry;
    const int top = __shfl_sync(kFullMask, incl, 31);
    carry = top > carry ? top : carry;
    bool sel[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool h = (hits >> (4 * c + j)) & 1u;
      if (!h) run = p + j;
      sel[j] = h && ((p + j - run - 1) & 1) == 0;
    }
    bool before = __shfl_up_sync(kFullMask, sel[3], 1);
    if (lane == 0) before = psel;
    psel = __shfl_sync(kFullMask, sel[3], 31);
    unsigned km = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool dropped = j == 0 ? before : sel[j - 1];
      if (p + j < n && !dropped) km |= 1u << j;
      if (sel[j]) a[c][j] = sb.c.z[(rix >> (4 * (4 * c + j))) & 15u];
    }
    keep |= km << (4 * c);
    const int cnt = __popc(km);
    int at = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFullMask, at, o);
      if (lane >= o) at += u;
    }
    lane_at[c] = at - cnt;
    chunk_n[c] = __shfl_sync(kFullMask, at, 31);
    kept += chunk_n[c];
  }
  if (lane == 0) sb.wkeep[warp] = kept;
  __syncthreads();
  // the tile's kept count, published at once; its offset by look-back
  if (warp == 0) {
    int total = 0;
    for (int v = 0; v < kApplyWarps; ++v) total += sb.wkeep[v];
    unsigned long long *desc = row.tiles + kDesc;
    const unsigned tag = sb.tag[s];
    int excl = 0;
    if (k == 0) {
      if (lane == 0) publish(desc, tag, true, total);
    } else {
      if (lane == 0) publish(desc + k, tag, false, total);
      for (int j = k - 1;; j -= 32) {
        const int i = j - lane;
        unsigned long long v = 0;
        bool ok = i < 0;
        while (!__all_sync(kFullMask, ok)) {
          if (!ok) {
            v = peek(desc + i);
            ok = (unsigned)(v >> 33) == tag;
          }
        }
        const bool incl = i >= 0 && ((v >> 32) & 1u);
        const unsigned stop = __ballot_sync(kFullMask, incl);
        const int upto = stop ? __ffs(stop) - 1 : 31;
        int add = i >= 0 && lane <= upto ? (int)(uint32_t)v : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) add += __shfl_xor_sync(kFullMask, add, o);
        excl += add;
        if (stop) break;
      }
      if (lane == 0) publish(desc + k, tag, true, excl + total);
    }
    if (lane == 0) {
      sb.excl = excl;
      if (k == n_tiles - 1) {  // the shard's last tile: its next live count and buffer
        row.ctl[kNextLive] = excl + total;
        row.ctl[kNextBuf] = b ^ 1;
        row.work[W_LIVE] += n;
        row.work[W_KEEP] += excl + total;
      }
    }
  }
  __syncthreads();
  int out = sb.excl;
  for (int v = 0; v < warp; ++v) out += sb.wkeep[v];
  int32_t *stt = sb.st[warp], *stw = sb.sw[warp];
#pragma unroll
  for (int c = 0; c < kWarpChunks; ++c) {
    int at = lane_at[c];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if ((keep >> (4 * c + j)) & 1u) {
        stt[at] = a[c][j];
        stw[at] = wd[c][j];
        ++at;
      }
    __syncwarp();
    for (int q = lane; q < chunk_n[c]; q += 32) {
      dt[out + q] = stt[q];
      dw[out + q] = stw[q];
    }
    __syncwarp();
    out += chunk_n[c];
  }
}

// The round's merge of the accepted candidates into the streams of n_sh
// shards (one card's), each compacted into its other buffer (the module
// note).
__global__ void __launch_bounds__(kApplyThreads, kApplyBlocksSM)
    apply_compact_kernel(const ApplyShard *rows, int n_sh) {
  __shared__ ApplyBlock sb;
  if (threadIdx.x < n_sh) {
    const ApplyShard &r = rows[threadIdx.x];
    const int n = r.ctl[kLive];
    sb.live[threadIdx.x] = n;
    sb.prev[threadIdx.x] = r.ctl[kPrevEnd];
    sb.buf[threadIdx.x] = r.ctl[kBuf];
    sb.tag[threadIdx.x] = (unsigned)r.tiles[kEpoch] + 1u;
    // a tile at least for a shard without tokens: its count still turns
    sb.pre[threadIdx.x + 1] = r.ctl[NACC] ? (n + kTileSlots - 1) / kTileSlots + (n == 0) : 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sb.pre[0] = 0;
    for (int s = 0; s < n_sh; ++s) sb.pre[s + 1] += sb.pre[s];
  }
  __syncthreads();
  const int total = sb.pre[n_sh];
  if (total == 0) return;
  unsigned long long *ctr = rows[0].tiles;
  int cur = -1;  // the shard whose candidates are loaded
  for (;;) {
    __syncthreads();
    if (threadIdx.x == 0) sb.ticket = (int)atomicAdd(ctr + kTicket, 1ull);
    __syncthreads();
    const int g = sb.ticket;
    if (g >= total) break;
    int s = 0;
    while (sb.pre[s + 1] <= g) ++s;
    const ApplyShard row = rows[s];
    if (s != cur) {
      load_apply_cands(sb, row);
      cur = s;
    }
    apply_tile(sb, row, s, g - sb.pre[s], sb.pre[s + 1] - sb.pre[s]);
  }
  // out of tiles: PAD from each shard's new live end to its other buffer's
  // old one, once the shard's last tile has resolved its offset
  for (int s = 0; s < n_sh; ++s) {
    const int nt = sb.pre[s + 1] - sb.pre[s];
    if (nt == 0) continue;
    const ApplyShard row = rows[s];
    if (threadIdx.x == 0) {
      const unsigned long long *d = row.tiles + kDesc + nt - 1;
      unsigned long long v = peek(d);
      while ((unsigned)(v >> 32) != sb.tag[s] * 2u + 1u) v = peek(d);
      sb.live2 = (int)(uint32_t)v;
    }
    __syncthreads();
    const int l2 = sb.live2, end = sb.prev[s];
    int32_t *dt = sb.buf[s] ? row.t[0] : row.t[1], *dw = sb.buf[s] ? row.w[0] : row.w[1];
    for (int q = l2 + blockIdx.x * blockDim.x + threadIdx.x; q < end;
         q += gridDim.x * blockDim.x) {
      dt[q] = kPad;
      dw[q] = kPad;
    }
    __syncthreads();
  }
  // the last block to finish: every ticket is taken and every epoch read
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(ctr + kDone, 1ull) == gridDim.x - 1ull) {
      ctr[kTicket] = 0;
      ctr[kDone] = 0;
      for (int s = 0; s < n_sh; ++s) rows[s].tiles[kEpoch] += 1;
    }
  }
}

// Blocks of the apply: one wave, at most a block a tile of the shards'
// buffers.
int apply_grid(long long slots) {
  static int wave = 0;
  if (!wave) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, apply_compact_kernel, kApplyThreads,
                                                  0);
    wave = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long need = (slots + kTileSlots - 1) / kTileSlots;
  return (int)(need < 1 ? 1 : (need < wave ? need : wave));
}

template <int OCC_, int OVF_, bool kLists>
int recount(const StreamBufs &bufs, const void *freq, int M, void *keys, void *cnts, int cap,
            void *ctl, const PartLists &pl, int limit, int vocab, int max_blocks, void *stream) {
  if (M <= 0 || cap <= 0 || (cap & (cap - 1)) != 0) return (int)cudaErrorInvalidValue;
  for (int b = 0; b < 2; ++b)
    if (((uintptr_t)bufs.t[b] & 15u) || ((uintptr_t)bufs.w[b] & 15u))
      return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  clear_kernel<OCC_, OVF_, kLists><<<grid_for(cap, 256), 256, 0, s>>>(
      (unsigned long long *)keys, (int32_t *)cnts, cap, (int32_t *)ctl, pl, limit, vocab);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_stream_count<OCC_, OVF_, kLists>(
      bufs, (const int32_t *)freq, M, (unsigned long long *)keys, (int32_t *)cnts, cap,
      (int32_t *)ctl, pl, limit, vocab, max_blocks, s);
}

StreamBufs bufs_of(void *t0, void *w0, void *t1, void *w1) {
  return StreamBufs{{(int32_t *)t0, (int32_t *)t1}, {(int32_t *)w0, (int32_t *)w1}};
}

}  // namespace

extern "C" {

// One round's count: the buffers turned, the table emptied, every live pair
// of the read buffer counted into it (t0, w0, t1, w1 16-byte aligned; at
// most max_blocks blocks when > 0, else one wave).
int yttm_stream_recount(void *t0, void *w0, void *t1, void *w1, const void *freq, int M,
                        void *keys, void *cnts, int cap, void *ctl, int limit, int vocab,
                        int max_blocks, void *stream) {
  return recount<OCC, OVERFLOW, false>(bufs_of(t0, w0, t1, w1), freq, M, keys, cnts, cap, ctl,
                                       PartLists{nullptr, nullptr, 0, cap}, limit, vocab,
                                       max_blocks, stream);
}

// The sharded v1 engine's count of one shard: its buffers turned, its
// scratch table (rkeys, rcnts) emptied and its live pairs counted into it,
// the occupancy and overflow in ctl's scratch slots, every claimed slot
// listed in its key's part among n_parts (plist [cap], pcnt [n_parts]);
// shard_part_fold then rebuilds every replica.
int yttm_stream_shard_count(void *t0, void *w0, void *t1, void *w1, const void *freq, int M,
                            void *rkeys, void *rcnts, int cap, void *ctl, void *plist, void *pcnt,
                            int n_parts, int limit, int vocab, int max_blocks, void *stream) {
  if (n_parts <= 0 || n_parts > kMaxParts || cap < n_parts || !plist || !pcnt)
    return (int)cudaErrorInvalidValue;
  return recount<kShardRocc, kShardRovf, true>(
      bufs_of(t0, w0, t1, w1), freq, M, rkeys, rcnts, cap, ctl,
      PartLists{(int32_t *)plist, (int32_t *)pcnt, n_parts, cap}, limit, vocab, max_blocks,
      stream);
}

// One round's merge of the accepted candidates into the streams of n_sh
// shards of one card (rows: a device array of ApplyShard; the first one's
// tiles hold the ticket), each compacted into its other buffer; slots: the
// shards' buffer lengths summed.
int yttm_stream_apply(const void *rows, int n_sh, long long slots, void *stream) {
  if (n_sh <= 0 || n_sh > kMaxShards || slots <= 0) return (int)cudaErrorInvalidValue;
  apply_compact_kernel<<<apply_grid(slots), kApplyThreads, 0, (cudaStream_t)stream>>>(
      (const ApplyShard *)rows, n_sh);
  return (int)cudaGetLastError();
}

}  // extern "C"
