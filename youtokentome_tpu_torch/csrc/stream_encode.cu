// The flat-stream encode pipeline on Hopper: raw UTF-8 bytes of a chunk
// in, token ids out.
//
// Replaces the JAX device programs
//   youtokentome_tpu/ops/stream_kernel.py:410 encode_stream_device, with its
//     stages :91 _utf8_decode_device, :159 _build_stream, :240 _dedup_words,
//     :361 _merge_fixed_point, :317 _expand_occurrences
//   youtokentome_tpu/ops/stream_kernel.py:440 _pack_u16 (the merge's epilogue)
//   youtokentome_tpu/ops/stream_kernel.py:450 _slice_prefix (the host now
//     downloads n_ids entries; nothing runs on the card for it)
// The plain torch versions are youtokentome_tpu_torch/ops/stream_kernel.py:
// build_stream, dedup_words, stream_merge_plain.  Three entry points, each
// a short sequence of launches in the caller's stream:
//
//   yttm_stream_build  bytes [N] -> t, wid [M], n_tokens      (M = 1.5 N + 4)
//   yttm_stream_dedup  t, wid -> unique stream ut, uwid, occ_uid, ustart, ulen
//   yttm_stream_merge  unique stream -> ids [M] in occurrence order, n_ids
//
// The JAX program compacts with a sort every time (_compact) and merges
// the whole stream in rounds, compacting it after each.  Here every
// compaction is a scan of keep flags (scan.cuh) and a scatter; words are
// deduplicated in an open-addressing table keyed by (length, h1, h2); each
// unique word merges to its fixed point in its own slot range, so no round
// touches the whole stream.
//
// The merge runs the greedy encode kernel's routines (greedy_group.cuh) on
// the words' spans.  The 100 MB main path's words hold 3-15 tokens, so a
// block a word would leave most of its lanes idle and pay block scans
// every round.  The words are binned by length on the card, in two
// kernels.  merge_words_kernel gives a warp two consecutive unique words:
// both of up to 16 tokens, a 16-lane group each (one position a lane,
// dead tokens marked and never compacted until the store, ranks kept
// across rounds); else one after the other on the whole warp.  It skips
// longer words, so that it needs no shared memory and few registers and
// runs at a full SM of warps.  merge_long_words_kernel takes the words of
// 33-512 tokens on the warp routine (up to 16 positions a lane, the
// compaction through the warp's shared memory) and the rare words past
// 512 tokens (none on the main path) a block each in global memory
// (merge_span).  The merge reads the unique stream and writes the merged
// words into its scratch, so the stream is not copied first.
//
// Bound.  Each stage reads its inputs and writes its outputs once: bytes
// (N + 8 n_tokens for the build; 8 n_tokens + 8 n_unique_tokens + ... for
// dedup; 4 n_unique_tokens + 4 n_words + 4 n_ids for the merge), against
// the extra passes its scans make (each scanned array is read twice and
// written once).  The merge is set by its dependent rounds (a few
// shuffles and a lookup where a pair changed), as in encode_greedy.cu.

#include <cstdint>
#include <cuda_runtime.h>

#include "greedy_group.cuh"
#include "scan.cuh"

namespace {

using namespace yttm_enc;
using yttm_scan::exclusive_scan;
using yttm_scan::scratch_ints;

constexpr uint32_t kInvalid = 0x0FFFFFFFu;  // INVALID_UNICODE
constexpr int32_t kNewline = -2;
constexpr uint32_t kSpaceToken = 9601;      // U+2581
constexpr int kEw = 256;                    // threads of an elementwise kernel
constexpr int kMergeShared = 512;           // longest word merged on a warp
constexpr int kWordThreads = 256;           // a block of either words kernel
constexpr int kWordWarps = kWordThreads / 32;
constexpr int kWordBlocks = 2048;           // blocks of the short words' grid-stride loop
constexpr int kLongBlocks = 264;            // blocks of the long words' grid-stride loop
constexpr uint32_t kU16Newline = 0xFFFFu;
constexpr uint32_t kU16Pad = 0xFFFEu;

#define CHECK_LAUNCH()                              \
  do {                                              \
    const cudaError_t e_ = cudaGetLastError();      \
    if (e_ != cudaSuccess) return (int)e_;          \
  } while (0)

#define CHECK(call)                                 \
  do {                                              \
    const cudaError_t e_ = (call);                  \
    if (e_ != cudaSuccess) return (int)e_;          \
  } while (0)

inline int blocks_for(long n) { return (int)((n + kEw - 1) / kEw); }

inline long table_slots(long m) {
  long t = 1;
  while (t < 2 * m) t <<= 1;
  return t;
}

// -- build: UTF-8 decode ------------------------------------------------------

__device__ __forceinline__ bool ok_cp(uint32_t cp) {
  return cp < 0xD800u || (0xDFFFu < cp && cp < 0x110000u);
}

// Length (2-4) of the valid multi-byte char starting at j, else 0; its
// code point in *cp.  Bytes past n read as 0 (not a continuation).
__device__ int multi_len(const uint8_t *b, int n, int j, uint32_t *cp) {
  const uint32_t b0 = b[j];
  const uint32_t b1 = j + 1 < n ? b[j + 1] : 0u;
  const uint32_t b2 = j + 2 < n ? b[j + 2] : 0u;
  const uint32_t b3 = j + 3 < n ? b[j + 3] : 0u;
  const bool c1 = (b1 & 0xC0u) == 0x80u, c2 = (b2 & 0xC0u) == 0x80u, c3 = (b3 & 0xC0u) == 0x80u;
  if ((b0 & 0xE0u) == 0xC0u) {
    const uint32_t v = ((b0 & 0x1Fu) << 6) | (b1 & 0x3Fu);
    if (c1 && v >= 0x80u && ok_cp(v)) return *cp = v, 2;
  } else if ((b0 & 0xF0u) == 0xE0u) {
    const uint32_t v = ((b0 & 0x0Fu) << 12) | ((b1 & 0x3Fu) << 6) | (b2 & 0x3Fu);
    if (c1 && c2 && v >= 0x800u && ok_cp(v)) return *cp = v, 3;
  } else if ((b0 & 0xF8u) == 0xF0u) {
    const uint32_t v = ((b0 & 0x07u) << 18) | ((b1 & 0x3Fu) << 12) | ((b2 & 0x3Fu) << 6) |
                       (b3 & 0x3Fu);
    if (c1 && c2 && c3 && v >= 0x10000u && ok_cp(v)) return *cp = v, 4;
  }
  return 0;
}

// cpv[i] = the code point of the char starting at byte i, or -1 where no
// valid char starts (a continuation byte of a valid char, an invalid
// byte); flag[i] = 1 where one does.  A byte is covered when the most
// recent valid multi-byte start before it reaches it.
__global__ void decode_kernel(const uint8_t *b, int n, int32_t *cpv, int32_t *flag) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t cp = kInvalid, unused;
  const int len = multi_len(b, n, i, &cp);
  bool covered = false;
  if (len == 0) {
    for (int d = 1; d <= 3 && i - d >= 0; ++d) {
      const int l = multi_len(b, n, i - d, &unused);
      if (l > 0) {
        covered = i < i - d + l;
        break;
      }
    }
    cp = b[i] < 0x80u ? (uint32_t)b[i] : kInvalid;
  }
  const bool ok = !covered && cp != kInvalid;
  cpv[i] = ok ? (int32_t)cp : -1;
  flag[i] = ok;
}

__global__ void gather_chars_kernel(const int32_t *cpv, const int32_t *pos, int n, int32_t *chars) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n && cpv[i] >= 0) chars[pos[i]] = cpv[i];
}

// -- build: classes and emission -----------------------------------------------

struct CharClass {
  bool is_nl, regular, word_start, seg_start, run_start;
  int32_t id;  // char id, -1 when unknown (or not regular)
  int emit;    // tokens the char emits: 0, 1 or 2
};

__device__ __forceinline__ bool is_space_cp(uint32_t c) {
  return c == 32u || (c >= 9u && c <= 13u) || c == kSpaceToken;
}

// id of code point c in the sorted alphabet, else -1 (searchsorted left)
__device__ int32_t char_id(const int32_t *cps, const int32_t *ids, int a, int32_t c) {
  int lo = 0, hi = a;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(cps + mid) < c)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo < a && __ldg(cps + lo) == c ? __ldg(ids + lo) : -1;
}

// The JAX _build_stream's per-char flags of char c of the decoded stream.
__device__ CharClass classify(const int32_t *chars, int c, const int32_t *cps, const int32_t *ids,
                              int a) {
  CharClass k;
  const uint32_t cur = (uint32_t)chars[c];
  k.is_nl = cur == 10u;
  k.regular = !k.is_nl && !is_space_cp(cur);
  k.id = k.regular ? char_id(cps, ids, a, (int32_t)cur) : -1;
  bool prev_regular = false, prev_unknown = false;
  if (c > 0) {
    const uint32_t pv = (uint32_t)chars[c - 1];
    prev_regular = pv != 10u && !is_space_cp(pv);
    prev_unknown = prev_regular && char_id(cps, ids, a, (int32_t)pv) < 0;
  }
  k.word_start = k.regular && !prev_regular;
  k.seg_start = k.word_start || k.is_nl;
  const bool unknown = k.regular && k.id < 0;
  k.run_start = unknown && (!prev_unknown || k.word_start);
  const bool emit_char = k.id >= 0 || k.run_start;
  k.emit = (k.word_start || emit_char || k.is_nl) + k.word_start;
  return k;
}

__global__ void classify_kernel(const int32_t *chars, const int32_t *n_chars, int cap,
                                const int32_t *cps, const int32_t *ids, int a, int32_t *seg,
                                int32_t *run, int32_t *emit) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cap) return;
  if (c >= *n_chars) {
    seg[c] = run[c] = emit[c] = 0;
    return;
  }
  const CharClass k = classify(chars, c, cps, ids, a);
  seg[c] = k.seg_start;
  run[c] = k.run_start;
  emit[c] = k.emit;
}

// base[w] = placeholder runs started before segment w (exclusive scan of
// run starts at the segment's first char)
__global__ void segment_base_kernel(const int32_t *chars, const int32_t *n_chars, const int32_t *cps,
                                    const int32_t *ids, int a, const int32_t *seg_x,
                                    const int32_t *run_x, int32_t *base) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= *n_chars) return;
  if (classify(chars, c, cps, ids, a).seg_start) base[seg_x[c]] = run_x[c];
}

// word starts emit [space_id, tok], other kept chars [tok], newlines
// [NEWLINE]; a placeholder is PLACEHOLDER_START + its run's ordinal in the
// word
__global__ void emit_kernel(const int32_t *chars, const int32_t *n_chars, const int32_t *cps,
                            const int32_t *ids, int a, const int32_t *seg_x, const int32_t *run_x,
                            const int32_t *emit_x, const int32_t *base, int32_t space_id, int m,
                            int32_t *t, int32_t *wid) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= *n_chars) return;
  const CharClass k = classify(chars, c, cps, ids, a);
  if (k.emit == 0) return;
  const int32_t w = seg_x[c] + k.seg_start - 1;
  int32_t tok = k.id;
  if (tok < 0) {
    const int32_t ordinal = run_x[c] + k.run_start - base[w] - 1;
    tok = kPlaceholderStart + (ordinal > 0 ? ordinal : 0);
  }
  const int o = emit_x[c];
  if (o >= m) return;  // never: M bounds the tokens of N bytes
  t[o] = k.word_start ? space_id : (k.is_nl ? kNewline : tok);
  wid[o] = w;
  if (k.word_start && o + 1 < m) {
    t[o + 1] = tok;
    wid[o + 1] = w;
  }
}

// -- dedup ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t mix32(uint32_t x, uint32_t c1, uint32_t c2) {
  uint32_t h = x * c1;
  h ^= h >> 15;
  h *= c2;
  h ^= h >> 13;
  return h;
}

__device__ __forceinline__ int word_len(const int32_t *wstart, int w, int n_words, int n) {
  return (w + 1 < n_words ? wstart[w + 1] : n) - wstart[w];
}

__global__ void word_starts_kernel(const int32_t *wid, const int32_t *n_tokens, int32_t *wstart,
                                   int32_t *ctl) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = *n_tokens;
  if (i == 0 && n == 0) ctl[0] = 0;
  if (i >= n) return;
  const int32_t w = wid[i];
  if (i == 0 || wid[i - 1] != w) wstart[w] = i;
  if (i == n - 1) ctl[0] = w + 1;  // n_words
}

// the two 32-bit sums of _dedup_words (the JAX constants; wrapping sums)
__global__ void word_hash_kernel(const int32_t *t, const int32_t *wid, const int32_t *n_tokens,
                                 const int32_t *wstart, uint32_t *h1, uint32_t *h2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= *n_tokens) return;
  const int32_t w = wid[i];
  const uint32_t tok = (uint32_t)t[i], pos = (uint32_t)(i - wstart[w]);
  atomicAdd(h1 + w, mix32(tok ^ (pos << 16), 0x9E3779B1u, 0x85EBCA77u));
  atomicAdd(h2 + w, mix32(tok + pos * 0x27D4EB2Fu, 0xC2B2AE3Du, 0x165667B1u));
}

// Each word claims (or finds) the slot of its key (length, h1, h2) in an
// open-addressing table of word indices; atomicMin leaves the first
// occurrence in the slot.  A slot only ever holds members of one key, so
// comparing against whichever member it holds is exact.
__global__ void word_insert_kernel(const int32_t *wstart, const uint32_t *h1, const uint32_t *h2,
                                   const int32_t *n_tokens, const int32_t *n_words_p,
                                   int32_t *table, uint32_t mask, int32_t *slot) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_words = *n_words_p;
  if (w >= n_words) return;
  const int n = *n_tokens;
  const int len = word_len(wstart, w, n_words, n);
  const uint32_t k1 = h1[w], k2 = h2[w];
  uint32_t s = mix(mix((uint32_t)len, k1), k2) & mask;
  for (;;) {
    const int32_t old = atomicCAS(table + s, -1, w);
    if (old == -1 ||
        (word_len(wstart, old, n_words, n) == len && h1[old] == k1 && h2[old] == k2)) {
      if (old != -1) atomicMin(table + s, w);
      slot[w] = (int32_t)s;
      return;
    }
    s = (s + 1) & mask;
  }
}

__global__ void word_rep_kernel(const int32_t *slot, const int32_t *table, const int32_t *wstart,
                                const int32_t *n_tokens, const int32_t *n_words_p, int m,
                                int32_t *rep, int32_t *is_rep, int32_t *rep_len) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= m) return;
  const int n_words = *n_words_p;
  if (w >= n_words) {
    is_rep[w] = rep_len[w] = 0;
    return;
  }
  const int32_t r = table[slot[w]];
  rep[w] = r;
  is_rep[w] = r == w;
  rep_len[w] = r == w ? word_len(wstart, w, n_words, *n_tokens) : 0;
}

__global__ void words_out_kernel(const int32_t *rep, const int32_t *uid, const int32_t *uoff,
                                 const int32_t *wstart, const int32_t *n_tokens,
                                 const int32_t *n_words_p, int32_t *occ_uid, int32_t *ustart,
                                 int32_t *ulen) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_words = *n_words_p;
  if (w >= n_words) return;
  const int32_t r = rep[w];
  const int32_t u = uid[r];
  occ_uid[w] = u;
  if (r == w) {
    ustart[u] = uoff[w];
    ulen[u] = word_len(wstart, w, n_words, *n_tokens);
  }
}

__global__ void tokens_out_kernel(const int32_t *t, const int32_t *wid, const int32_t *n_tokens,
                                  const int32_t *rep, const int32_t *uid, const int32_t *uoff,
                                  const int32_t *wstart, int32_t *ut, int32_t *uwid) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= *n_tokens) return;
  const int32_t w = wid[i];
  if (rep[w] != w) return;
  const int dst = uoff[w] + (i - wstart[w]);
  ut[dst] = t[i];
  uwid[dst] = uid[w];
}

// -- merge ---------------------------------------------------------------------

// Greedy merge of one word of n tokens to its fixed point by the calling
// block (_merge_fixed_point's semantics on one word: the least rank, its
// leftmost non-overlapping occurrences with parity restarting at each run
// of hits, then compaction).  buf0 holds the word; buf1 and sel are
// scratch of n slots, all three in global memory.  Each
// thread owns a contiguous range of positions.  Returns the merged length;
// *which says whether the result is in buf0 (0) or buf1 (1).
__device__ int merge_span(int32_t *buf0, int32_t *buf1, int32_t *sel, int n, const Table &t,
                          const int32_t *rules_z, int32_t *wbuf, int *which) {
  int32_t *cur = buf0, *nxt = buf1;
  int w = 0;
  const int nt = blockDim.x;
  for (;;) {
    const int per = (n + nt - 1) / nt;
    const int p0 = threadIdx.x * per;
    const int p1 = p0 + per < n ? p0 + per : n;
    // 1. rank of every valid pair, and the word's least rank
    int32_t lmin = kMiss;
    for (int i = p0; i < p1; ++i) {
      int32_t r = kMiss;
      if (i < n - 1) {
        const int32_t a = cur[i], b = cur[i + 1];
        if (a >= 0 && b >= 0) r = lookup(t, a, b);
      }
      sel[i] = r;
      lmin = r < lmin ? r : lmin;
    }
    int32_t m;
    block_exclusive_scan(lmin, kMiss, wbuf, &m, MinOp());
    if (m == kMiss) break;
    // 2. hits of rank m at even offsets inside each run of hits: the last
    //    non-hit before each range comes from a block max-scan
    int32_t llast = -1;
    for (int i = p0; i < p1; ++i)
      if (sel[i] != m) llast = i;
    int32_t unused;
    int32_t last = block_exclusive_scan(llast, (int32_t)-1, wbuf, &unused, MaxOp());
    for (int i = p0; i < p1; ++i) {
      int32_t s = 0;
      if (sel[i] == m)
        s = ((i - last - 1) & 1) == 0;
      else
        last = i;
      sel[i] = s;
    }
    __syncthreads();
    // 3. write z at each selected left token, drop its right token,
    //    compact into the other buffer
    const int32_t z = __ldg(rules_z + m);
    int32_t kept = 0;
    for (int i = p0; i < p1; ++i) kept += !(i > 0 && sel[i - 1]);
    int32_t total;
    int32_t dst = block_exclusive_scan(kept, 0, wbuf, &total, SumOp());
    for (int i = p0; i < p1; ++i)
      if (!(i > 0 && sel[i - 1])) nxt[dst++] = sel[i] ? z : cur[i];
    __syncthreads();
    int32_t *tmp = cur;
    cur = nxt;
    nxt = tmp;
    w ^= 1;
    n = total;
  }
  *which = w;
  return n;
}

// One lane a position of a word of up to G tokens (u < 0: none on this
// lane's group); the merged word goes front-packed to its span of work,
// its length to mlen.
template <int G>
__device__ __forceinline__ void merge_short_word(const int32_t *ut, int32_t *work, int32_t *mlen,
                                                 int u, int s, int len, const Table &t,
                                                 const int32_t *rules_z, int n_rules) {
  const int lane = threadIdx.x & 31, pos = lane & (G - 1);
  const bool mine = u >= 0 && pos < len;
  int32_t tok = mine ? ut[s + pos] : kPad;
  bool live = mine;
  const unsigned lm = greedy_group<G>(tok, live, t, rules_z, n_rules);
  if (live) work[s + __popc(lm & ((1u << lane) - 1u))] = tok;
  if (mine && pos == 0) mlen[u] = __popc(lm);
}

// A word of 33 to 32 * P tokens on the warp (greedy_warp), scratch the
// warp's stok and srk.
template <int P>
__device__ __forceinline__ void merge_warp_word(const int32_t *ut, int32_t *work, int32_t *mlen,
                                                int u, int s, int len, int32_t *stok,
                                                int32_t *srk, const Table &t,
                                                const int32_t *rules_z, int n_rules) {
  const int lane = threadIdx.x & 31;
  int32_t tk[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = 32 * k + lane;
    tk[k] = i < len ? ut[s + i] : kPad;
  }
  const int n = greedy_warp<P>(tk, stok, srk, t, rules_z, n_rules);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = 32 * k + lane;
    if (i < n) work[s + i] = tk[k];
  }
  if (lane == 0) mlen[u] = n;
}

// The unique words of up to 32 tokens, read from ut and left merged in
// their slot ranges of work (greedy_group.cuh).  Each warp takes two
// consecutive words (grid-stride): both of up to 16 tokens, a 16-lane
// group each; else one after the other on the whole warp.  Longer words
// are merge_long_words_kernel's, so this kernel needs no shared memory and
// few registers, and a full SM of warps hides the lookups' latency.
__global__ void __launch_bounds__(kWordThreads)
    merge_words_kernel(const int32_t *ut, int32_t *work, const int32_t *ustart,
                       const int32_t *ulen, const int32_t *n_unique, Table t,
                       const int32_t *rules_z, int n_rules, int32_t *mlen) {
  const int lane = threadIdx.x & 31;
  const int nu = *n_unique;
  const int stride = 2 * gridDim.x * kWordWarps;
  for (int u0 = 2 * (blockIdx.x * kWordWarps + (threadIdx.x >> 5)); u0 < nu; u0 += stride) {
    const int n_pair = u0 + 1 < nu ? 2 : 1;
    const int len0 = ulen[u0], len1 = n_pair == 2 ? ulen[u0 + 1] : 0;
    if (len0 <= 16 && len1 <= 16) {
      const bool hi = lane >= 16;
      const int u = hi ? (n_pair == 2 ? u0 + 1 : -1) : u0;
      merge_short_word<16>(ut, work, mlen, u, u >= 0 ? ustart[u] : 0, hi ? len1 : len0, t,
                           rules_z, n_rules);
      continue;
    }
    for (int j = 0; j < n_pair; ++j) {
      const int u = u0 + j, len = j ? len1 : len0;
      if (len <= 32) merge_short_word<32>(ut, work, mlen, u, ustart[u], len, t, rules_z, n_rules);
    }
  }
}

// The unique words of more than 32 tokens.  Each block reads the lengths
// of its stride of words (grid-stride) and lists its longer ones in shared
// memory; its warps take the words of 33-512 tokens in turn, each on the
// warp's routine (greedy_warp, P = 2..16 positions a lane; no
// __syncthreads in its rounds), then the whole block takes the words past
// 512 tokens one after the other, in global memory (merge_span over work,
// work2 and rk: their own slot ranges).  On the main path it finds no
// such word and only reads the lengths.
__global__ void __launch_bounds__(kWordThreads)
    merge_long_words_kernel(const int32_t *ut, int32_t *work, int32_t *work2, int32_t *rk,
                            const int32_t *ustart, const int32_t *ulen, const int32_t *n_unique,
                            Table t, const int32_t *rules_z, int n_rules, int32_t *mlen) {
  __shared__ int32_t buf[kWordWarps][2][kMergeShared];  // a warp's compaction scratch
  __shared__ int32_t wbuf[kWordWarps];
  __shared__ int32_t list[kWordThreads];
  __shared__ int n_list;
  const int w = threadIdx.x >> 5;
  int32_t *stok = buf[w][0], *srk = buf[w][1];
  const int nu = *n_unique;
  for (int base = blockIdx.x * blockDim.x; base < nu; base += gridDim.x * blockDim.x) {
    if (threadIdx.x == 0) n_list = 0;
    __syncthreads();
    const int u = base + threadIdx.x;
    if (u < nu && ulen[u] > 32) list[atomicAdd(&n_list, 1)] = u;
    __syncthreads();
    const int n_long = n_list;
    for (int k = w; k < n_long; k += kWordWarps) {
      const int v = list[k], s = ustart[v], len = ulen[v];
      if (len <= 64)
        merge_warp_word<2>(ut, work, mlen, v, s, len, stok, srk, t, rules_z, n_rules);
      else if (len <= 128)
        merge_warp_word<4>(ut, work, mlen, v, s, len, stok, srk, t, rules_z, n_rules);
      else if (len <= 256)
        merge_warp_word<8>(ut, work, mlen, v, s, len, stok, srk, t, rules_z, n_rules);
      else if (len <= kMergeShared)
        merge_warp_word<16>(ut, work, mlen, v, s, len, stok, srk, t, rules_z, n_rules);
    }
    for (int k = 0; k < n_long; ++k) {
      const int v = list[k], s = ustart[v], len = ulen[v];
      if (len <= kMergeShared) continue;
      for (int i = threadIdx.x; i < len; i += blockDim.x) work[s + i] = ut[s + i];
      __syncthreads();
      int n = len, which = 0;
      if (n_rules > 0) n = merge_span(work + s, work2 + s, rk + s, len, t, rules_z, wbuf, &which);
      if (which)
        for (int i = threadIdx.x; i < n; i += blockDim.x) work[s + i] = work2[s + i];
      if (threadIdx.x == 0) mlen[v] = n;
      __syncthreads();
    }
    __syncthreads();  // every thread has read n_list before the next stride resets it
  }
}

__global__ void occ_len_kernel(const int32_t *occ_uid, const int32_t *mlen,
                               const int32_t *n_words, int m, int32_t *occ_off) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w < m) occ_off[w] = w < *n_words ? mlen[occ_uid[w]] : 0;
}

__device__ __forceinline__ void store_id(void *out, bool pack, int i, int32_t v, int32_t unk) {
  if (pack) {
    const uint32_t o = v >= kPlaceholderStart ? (uint32_t)unk
                       : v == kNewline        ? kU16Newline
                       : v == kPad            ? kU16Pad
                                              : (uint32_t)v;
    ((uint16_t *)out)[i] = (uint16_t)o;
  } else {
    ((int32_t *)out)[i] = v;
  }
}

__global__ void fill_tail_kernel(void *out, bool pack, int m, const int32_t *total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < m && i >= *total) store_id(out, pack, i, kPad, 0);
}

// one warp a word of the chunk: copy its unique word's merged tokens to
// the word's place in occurrence order
__global__ void expand_kernel(const int32_t *work, const int32_t *ustart, const int32_t *occ_uid,
                              const int32_t *occ_off, const int32_t *mlen, const int32_t *n_words,
                              void *out, bool pack, int32_t unk) {
  const int lane = threadIdx.x & 31;
  const int nw = *n_words;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  for (int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; w < nw; w += n_warps) {
    const int32_t u = occ_uid[w];
    const int len = mlen[u], src = ustart[u], dst = occ_off[w];
    for (int j = lane; j < len; j += 32) store_id(out, pack, dst + j, work[src + j], unk);
  }
}

}  // namespace

extern "C" {

// int32 scratch slots of yttm_stream_build for n bytes
long yttm_stream_build_scratch(int n) { return 7L * n + scratch_ints(n) + 2; }

// bytes [n] -> t, wid [m] (m = 1.5 n + 4; PAD past n_tokens); ctl[0] gets
// the decoded chars, ctl[1] n_tokens.  Returns a cudaError_t (0: success).
int yttm_stream_build(const void *bytes, int n, const void *alpha_cps, const void *alpha_ids,
                      int a, int space_id, void *t, void *wid, int m, void *ctl_, void *scratch,
                      void *stream_) {
  if (n <= 0 || m < n) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream_;
  int32_t *ctl = (int32_t *)ctl_;
  int32_t *p = (int32_t *)scratch;
  int32_t *cpv = p, *pos = p + n, *chars = p + 2L * n, *seg = p + 3L * n, *run = p + 4L * n,
          *emit = p + 5L * n, *base = p + 6L * n, *sums = p + 7L * n;
  int32_t *spare = sums + scratch_ints(n);
  const int32_t *cps = (const int32_t *)alpha_cps, *ids = (const int32_t *)alpha_ids;
  const int g = blocks_for(n);
  decode_kernel<<<g, kEw, 0, st>>>((const uint8_t *)bytes, n, cpv, pos);
  CHECK_LAUNCH();
  CHECK(exclusive_scan(pos, pos, n, sums, ctl + 0, st));
  gather_chars_kernel<<<g, kEw, 0, st>>>(cpv, pos, n, chars);
  CHECK_LAUNCH();
  classify_kernel<<<g, kEw, 0, st>>>(chars, ctl + 0, n, cps, ids, a, seg, run, emit);
  CHECK_LAUNCH();
  CHECK(exclusive_scan(seg, seg, n, sums, spare, st));
  CHECK(exclusive_scan(run, run, n, sums, spare + 1, st));
  CHECK(exclusive_scan(emit, emit, n, sums, ctl + 1, st));
  segment_base_kernel<<<g, kEw, 0, st>>>(chars, ctl + 0, cps, ids, a, seg, run, base);
  CHECK_LAUNCH();
  CHECK(cudaMemsetAsync(t, 0xFF, (size_t)m * 4, st));
  CHECK(cudaMemsetAsync(wid, 0xFF, (size_t)m * 4, st));
  emit_kernel<<<g, kEw, 0, st>>>(chars, ctl + 0, cps, ids, a, seg, run, emit, base, space_id, m,
                                 (int32_t *)t, (int32_t *)wid);
  CHECK_LAUNCH();
  return 0;
}

// int32 scratch slots of yttm_stream_dedup for m token slots
long yttm_stream_dedup_scratch(int m) { return 7L * m + table_slots(m) + scratch_ints(m); }

// t, wid [m] (n_tokens on the card) -> the unique stream ut, uwid [m] (PAD
// past its tokens), occ_uid [m] (first n_words valid), ustart, ulen [m]
// (first n_unique valid); ctl[0] n_words, ctl[1] n_unique, ctl[2] its
// tokens.
int yttm_stream_dedup(const void *t_, const void *wid_, int m, const void *n_tokens_, void *ut,
                      void *uwid, void *occ_uid, void *ustart, void *ulen, void *ctl_,
                      void *scratch, void *stream_) {
  if (m <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream_;
  const int32_t *t = (const int32_t *)t_, *wid = (const int32_t *)wid_;
  const int32_t *n_tokens = (const int32_t *)n_tokens_;
  int32_t *ctl = (int32_t *)ctl_;
  const long slots = table_slots(m);
  int32_t *p = (int32_t *)scratch;
  int32_t *wstart = p, *slot = p + 2L * m + 0, *rep = p + 4L * m, *flag = p + 5L * m,
          *flen = p + 6L * m, *table = p + 7L * m, *sums = p + 7L * m + slots;
  uint32_t *h1 = (uint32_t *)(p + m), *h2 = (uint32_t *)(p + 3L * m);
  const int g = blocks_for(m);
  CHECK(cudaMemsetAsync(h1, 0, (size_t)m * 4, st));
  CHECK(cudaMemsetAsync(h2, 0, (size_t)m * 4, st));
  CHECK(cudaMemsetAsync(table, 0xFF, (size_t)slots * 4, st));
  word_starts_kernel<<<g, kEw, 0, st>>>(wid, n_tokens, wstart, ctl);
  CHECK_LAUNCH();
  word_hash_kernel<<<g, kEw, 0, st>>>(t, wid, n_tokens, wstart, h1, h2);
  CHECK_LAUNCH();
  word_insert_kernel<<<g, kEw, 0, st>>>(wstart, h1, h2, n_tokens, ctl, table,
                                        (uint32_t)(slots - 1), slot);
  CHECK_LAUNCH();
  word_rep_kernel<<<g, kEw, 0, st>>>(slot, table, wstart, n_tokens, ctl, m, rep, flag, flen);
  CHECK_LAUNCH();
  CHECK(exclusive_scan(flag, flag, m, sums, ctl + 1, st));  // -> unique ids
  CHECK(exclusive_scan(flen, flen, m, sums, ctl + 2, st));  // -> unique offsets
  words_out_kernel<<<g, kEw, 0, st>>>(rep, flag, flen, wstart, n_tokens, ctl,
                                      (int32_t *)occ_uid, (int32_t *)ustart, (int32_t *)ulen);
  CHECK_LAUNCH();
  CHECK(cudaMemsetAsync(ut, 0xFF, (size_t)m * 4, st));
  CHECK(cudaMemsetAsync(uwid, 0xFF, (size_t)m * 4, st));
  tokens_out_kernel<<<g, kEw, 0, st>>>(t, wid, n_tokens, rep, flag, flen, wstart, (int32_t *)ut,
                                       (int32_t *)uwid);
  CHECK_LAUNCH();
  return 0;
}

// int32 scratch slots of yttm_stream_merge for m token slots
long yttm_stream_merge_scratch(int m) { return 5L * m + scratch_ints(m); }

// The unique stream (ut [m]; ustart, ulen of n_unique words; occ_uid of
// n_words words) -> out [m] (int32, or the uint16 wire format when pack:
// placeholders -> unk, NEWLINE -> 0xFFFF, PAD -> 0xFFFE): every word of the
// chunk's merged tokens in order, PAD past ctl[0] = n_ids.
int yttm_stream_merge(const void *ut, int m, const void *ustart_, const void *ulen_,
                      const void *n_unique, const void *occ_uid_, const void *n_words,
                      const void *kx, const void *ky, const void *val, int cap, int max_probes,
                      const void *rules_z, int n_rules, void *out, int pack, int unk, void *ctl_,
                      void *scratch, void *stream_) {
  if (m <= 0 || cap <= 0 || (cap & (cap - 1)) != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream_;
  int32_t *ctl = (int32_t *)ctl_;
  int32_t *p = (int32_t *)scratch;
  int32_t *work = p, *work2 = p + m, *rk = p + 2L * m, *mlen = p + 3L * m, *occ_off = p + 4L * m,
          *sums = p + 5L * m;
  const int32_t *ustart = (const int32_t *)ustart_, *ulen = (const int32_t *)ulen_;
  const int32_t *occ_uid = (const int32_t *)occ_uid_;
  Table t{(const uint32_t *)kx, (const uint32_t *)ky, (const int32_t *)val, (uint32_t)(cap - 1),
          max_probes};
  const int g = blocks_for(m);
  merge_words_kernel<<<kWordBlocks, kWordThreads, 0, st>>>(
      (const int32_t *)ut, work, ustart, ulen, (const int32_t *)n_unique, t,
      (const int32_t *)rules_z, n_rules, mlen);
  CHECK_LAUNCH();
  merge_long_words_kernel<<<kLongBlocks, kWordThreads, 0, st>>>(
      (const int32_t *)ut, work, work2, rk, ustart, ulen, (const int32_t *)n_unique, t,
      (const int32_t *)rules_z, n_rules, mlen);
  CHECK_LAUNCH();
  occ_len_kernel<<<g, kEw, 0, st>>>(occ_uid, mlen, (const int32_t *)n_words, m, occ_off);
  CHECK_LAUNCH();
  CHECK(exclusive_scan(occ_off, occ_off, m, sums, ctl + 0, st));
  fill_tail_kernel<<<g, kEw, 0, st>>>(out, pack != 0, m, ctl + 0);
  CHECK_LAUNCH();
  expand_kernel<<<g, kEw, 0, st>>>(work, ustart, occ_uid, occ_off, mlen, (const int32_t *)n_words,
                                   out, pack != 0, (int32_t)unk);
  CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
