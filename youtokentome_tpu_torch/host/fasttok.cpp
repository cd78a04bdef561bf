// Native host corpus preprocessing for encoding/training.
//
// TPU-native equivalent of the reference's C++ host loops (UTF-8 decode
// utf8.cpp:37-128, word counting/dedup bpe.cpp:388-418, unknown-run
// collapse bpe.cpp:1503-1527) — written fresh for this framework's
// pipeline: the host extracts *unique* words once, the device merges
// them, and the host expands results back to the occurrence stream.
//
// Word spans are found directly on the raw bytes: ASCII whitespace bytes
// never occur inside multi-byte UTF-8 chars, and U+2581's encoding
// (E2 96 81) cannot start inside another char's tail (tail bytes are
// 80..BF), so byte-level splitting agrees with codepoint-level
// splitting.  Dedup keys are raw byte spans (equal bytes => equal ids),
// with exact comparison on hash hits.
//
// All functions return -1 on insufficient capacity (caller grows and
// retries) and are exposed via ctypes (see fasttok.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

namespace {

const uint32_t INVALID_CP = 0x0FFFFFFF;
const int32_t PLACEHOLDER_START = 1000000000;

inline bool is_space_byte(uint8_t b) {
  return b == 0x20 || (b >= 0x09 && b <= 0x0D);
}

inline bool is_meta_space(const uint8_t *p, long remaining) {
  return remaining >= 3 && p[0] == 0xE2 && p[1] == 0x96 && p[2] == 0x81;
}

inline bool check_cp(uint32_t x) {
  return x < 0xD800 || (0xDFFF < x && x < 0x110000);
}

inline bool cont(uint8_t x) { return (x & 0xC0) == 0x80; }

// Decode one char; returns codepoint (INVALID_CP on bad input) and
// advances *len (1 on bad input) — reference semantics utf8.cpp:37-74.
inline uint32_t decode_char(const uint8_t *p, long remaining, int *len) {
  uint8_t b0 = p[0];
  if (b0 < 0x80) {
    *len = 1;
    return b0;
  }
  if ((b0 & 0xE0) == 0xC0 && remaining >= 2 && cont(p[1])) {
    uint32_t v = ((b0 & 0x1Fu) << 6) | (p[1] & 0x3Fu);
    if (v >= 0x80 && check_cp(v)) {
      *len = 2;
      return v;
    }
  } else if ((b0 & 0xF0) == 0xE0 && remaining >= 3 && cont(p[1]) && cont(p[2])) {
    uint32_t v = ((b0 & 0x0Fu) << 12) | ((p[1] & 0x3Fu) << 6) | (p[2] & 0x3Fu);
    if (v >= 0x800 && check_cp(v)) {
      *len = 3;
      return v;
    }
  } else if ((b0 & 0xF8) == 0xF0 && remaining >= 4 && cont(p[1]) && cont(p[2]) &&
             cont(p[3])) {
    uint32_t v = ((b0 & 0x07u) << 18) | ((p[1] & 0x3Fu) << 12) |
                 ((p[2] & 0x3Fu) << 6) | (p[3] & 0x3Fu);
    if (v >= 0x10000 && check_cp(v)) {
      *len = 4;
      return v;
    }
  }
  *len = 1;
  return INVALID_CP;
}

inline uint64_t hash_bytes(const uint8_t *p, long n) {
  uint64_t h = 1469598103934665603ull;  // FNV-1a 64
  for (long i = 0; i < n; i++) {
    h ^= p[i];
    h *= 1099511628211ull;
  }
  return h;
}

// Open-addressing map codepoint -> id.
struct CharMap {
  std::vector<uint32_t> keys;
  std::vector<int32_t> vals;
  uint64_t mask;

  void build(const uint32_t *cps, const int32_t *ids, long n) {
    uint64_t cap = 16;
    while (cap < (uint64_t)n * 2) cap <<= 1;
    mask = cap - 1;
    keys.assign(cap, 0xFFFFFFFFu);
    vals.assign(cap, -1);
    for (long i = 0; i < n; i++) {
      uint64_t h = (cps[i] * 0x9E3779B97F4A7C15ull) >> 32;
      uint64_t s = h & mask;
      while (keys[s] != 0xFFFFFFFFu) s = (s + 1) & mask;
      keys[s] = cps[i];
      vals[s] = ids[i];
    }
  }

  inline int32_t get(uint32_t cp) const {
    uint64_t h = (cp * 0x9E3779B97F4A7C15ull) >> 32;
    uint64_t s = h & mask;
    while (true) {
      if (keys[s] == cp) return vals[s];
      if (keys[s] == 0xFFFFFFFFu) return -1;
      s = (s + 1) & mask;
    }
  }
};

// Open-addressing map over raw byte spans -> uid, exact compare.
struct WordMap {
  struct Slot {
    const uint8_t *ptr;
    int32_t len;
    int32_t uid;
  };
  std::vector<Slot> slots;
  uint64_t mask;
  long count = 0;
  Slot *last_inserted = nullptr;

  void init(long expect) {
    uint64_t cap = 1024;
    while (cap < (uint64_t)expect * 2) cap <<= 1;
    mask = cap - 1;
    slots.assign(cap, {nullptr, 0, -1});
    count = 0;
    last_inserted = nullptr;
  }

  // Returns uid; sets *fresh when newly inserted.
  inline int32_t get_or_add(const uint8_t *p, long n, bool *fresh) {
    if ((uint64_t)(count * 2) >= mask + 1) grow();
    uint64_t s = hash_bytes(p, n) & mask;
    while (true) {
      Slot &sl = slots[s];
      if (sl.ptr == nullptr) {
        sl.ptr = p;
        sl.len = (int32_t)n;
        sl.uid = (int32_t)count;
        count++;
        *fresh = true;
        last_inserted = &sl;
        return sl.uid;
      }
      if (sl.len == (int32_t)n && memcmp(sl.ptr, p, n) == 0) {
        *fresh = false;
        return sl.uid;
      }
      s = (s + 1) & mask;
    }
  }

  // Re-point the most recently inserted key at stable storage (the
  // caller's input buffer dies after the call; the arena does not).
  void repoint_last(const uint8_t *stable) {
    if (last_inserted) last_inserted->ptr = stable;
  }

  void grow() {
    std::vector<Slot> old = std::move(slots);
    uint64_t cap = (mask + 1) * 2;
    mask = cap - 1;
    slots.assign(cap, {nullptr, 0, -1});
    for (auto &sl : old) {
      if (sl.ptr == nullptr) continue;
      uint64_t s = hash_bytes(sl.ptr, sl.len) & mask;
      while (slots[s].ptr != nullptr) s = (s + 1) & mask;
      slots[s] = sl;
    }
  }
};

// Chunked byte arena: pointer-stable appends (chunks never move).
struct Arena {
  std::vector<std::unique_ptr<std::vector<uint8_t>>> chunks;
  size_t used = 0;
  static const size_t CH = 1 << 20;

  const uint8_t *put(const void *p, size_t n) {
    if (chunks.empty() || used + n > chunks.back()->size()) {
      chunks.emplace_back(new std::vector<uint8_t>(n > CH ? n : CH));
      used = 0;
    }
    uint8_t *dst = chunks.back()->data() + used;
    memcpy(dst, p, n);
    used += n;
    return dst;
  }

  void clear() {
    chunks.clear();
    used = 0;
  }
};

// Decimal LUT: "NNNNN " 8-byte strided for single-store copies.
struct DecLut {
  std::vector<char> buf;
  std::vector<uint8_t> len;

  DecLut() {
    buf.resize(65536 * 8);
    len.resize(65536);
    for (int v = 0; v < 65536; v++) {
      char *q = &buf[(size_t)v * 8];
      int k = 0, x = v;
      char tmp[8];
      do {
        tmp[k++] = '0' + (x % 10);
        x /= 10;
      } while (x);
      int l = 0;
      while (k) q[l++] = tmp[--k];
      q[l++] = ' ';
      len[v] = (uint8_t)l;
    }
  }

  // Append "v " to p (p must have >= 12 bytes of slack); returns new p.
  inline char *emit(char *p, int32_t v) const {
    if ((uint32_t)v < 65536u) {
      memcpy(p, &buf[(size_t)v * 8], 8);
      return p + len[v];
    }
    char tmp[12];
    int k = 0;
    uint32_t x;
    if (v < 0) { *p++ = '-'; x = (uint32_t)(-(int64_t)v); }
    else x = (uint32_t)v;
    do {
      tmp[k++] = '0' + (x % 10);
      x /= 10;
    } while (x);
    while (k) *p++ = tmp[--k];
    *p++ = ' ';
    return p;
  }
};

const DecLut &dec_lut() {
  static DecLut lut;
  return lut;
}

// Persistent word-cache context: stable uids across batches, cached
// merge results (ids + pre-formatted text) per unique word.  The
// tensor-era analog of keeping the reference's word hash map alive
// across stdin batches (the reference re-dedups per batch,
// bpe.cpp:1976-1983) — on natural text later batches contain almost no
// novel words, so the device only ever sees fresh ones.
struct Ctx {
  WordMap wmap;
  Arena word_bytes;   // raw bytes of unique words (hash-map keys)
  Arena result_data;  // cached ids + formatted text
  std::vector<const int32_t *> ids_ptr;
  std::vector<int32_t> ids_len;
  std::vector<const char *> fmt_ptr;
  std::vector<int32_t> fmt_len;
  long n_results = 0;  // uids with registered results

  Ctx() { wmap.init(1 << 15); }

  void reset() {
    wmap.init(1 << 15);
    word_bytes.clear();
    result_data.clear();
    ids_ptr.clear();
    ids_len.clear();
    fmt_ptr.clear();
    fmt_len.clear();
    n_results = 0;
  }
};

// Host-side greedy merge: rank-ordered rule table + per-word merge
// loop.  This is the latency path of the encode crossover: novel-word
// batches small enough that a remote device dispatch would be
// round-trip-bound (PROFILE.md §1) merge here instead; large cold
// batches still go to the device.  Semantics match the reference's
// per-word priority-queue merge (bpe.cpp:1560-1589): repeatedly apply
// the lowest-rank applicable rule, occurrences left to right — a
// created pair always contains the new id z, and every rule containing
// z has a higher rank (z must exist when learned), so applying ALL
// occurrences of the current minimum-rank rule in one pass is exact.
struct RuleTab {
  // open addressing, (x << 32 | y) keys, empty = all-ones (ids < 2^31)
  std::vector<uint64_t> key;
  std::vector<int32_t> rank;
  std::vector<int32_t> z;
  uint64_t mask = 0;

  static uint64_t mix(uint64_t k) {
    k ^= k >> 33;
    k *= 0xff51afd7ed558ccdULL;
    k ^= k >> 33;
    return k;
  }

  void init(const int32_t *rules, long n) {
    size_t cap = 16;
    while ((long)cap < 2 * n) cap <<= 1;
    mask = cap - 1;
    key.assign(cap, ~0ULL);
    rank.assign(cap, -1);
    z.assign(cap, -1);
    for (long i = 0; i < n; i++) {
      uint64_t k = ((uint64_t)(uint32_t)rules[3 * i] << 32) |
                   (uint32_t)rules[3 * i + 1];
      size_t s = mix(k) & mask;
      while (key[s] != ~0ULL) {
        if (key[s] == k) { s = ~(size_t)0; break; }  // keep lowest rank
        s = (s + 1) & mask;
      }
      if (s == ~(size_t)0) continue;
      key[s] = k;
      rank[s] = (int32_t)i;
      z[s] = rules[3 * i + 2];
    }
  }

  // rank of rule (x, y), or INT32_MAX
  inline int32_t find(int32_t x, int32_t y, int32_t *zz) const {
    uint64_t k = ((uint64_t)(uint32_t)x << 32) | (uint32_t)y;
    size_t s = mix(k) & mask;
    while (key[s] != ~0ULL) {
      if (key[s] == k) {
        *zz = z[s];
        return rank[s];
      }
      s = (s + 1) & mask;
    }
    return INT32_MAX;
  }
};

// splitmix64: small deterministic rng for the dropout merge
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed) {}
  uint64_t next() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  double uniform() {  // [0, 1)
    return (double)(next() >> 11) * (1.0 / 9007199254740992.0);
  }
};

// BPE-dropout merge of one occurrence, in place; returns new length.
//
// Mirror of the reference's DropoutQueue semantics (bpe.cpp:1415-1453):
// candidates are considered in (rank, pos) order; each considered
// candidate is independently skipped with probability p; the first
// survivor is applied (that single occurrence); skipped candidates are
// reconsidered with fresh coins after every applied merge; a full pass
// with no survivor ends the word.  Unlike the reference's shared
// unseeded mt19937 (a data race under threads), the seed is explicit.
static long merge_word_dropout(const RuleTab &tab, int32_t *buf, long len,
                               double p, Rng &rng) {
  std::vector<std::pair<uint64_t, int32_t>> cands;  // (rank<<32|pos, z)
  while (len > 1) {
    cands.clear();
    for (long i = 0; i + 1 < len; i++) {
      int32_t zz;
      int32_t r = tab.find(buf[i], buf[i + 1], &zz);
      if (r != INT32_MAX)
        cands.emplace_back(((uint64_t)(uint32_t)r << 32) | (uint32_t)i, zz);
    }
    if (cands.empty()) break;
    std::sort(cands.begin(), cands.end());
    long pos = -1;
    int32_t z = 0;
    for (auto &c : cands) {
      if (rng.uniform() >= p) {
        pos = (long)(uint32_t)(c.first & 0xFFFFFFFFULL);
        z = c.second;
        break;
      }
    }
    if (pos < 0) break;  // every candidate dropped: word is done
    buf[pos] = z;
    for (long i = pos + 1; i + 1 < len; i++) buf[i] = buf[i + 1];
    len--;
  }
  return len;
}

// merge one word in place; returns the new length
static long merge_word(const RuleTab &tab, int32_t *buf, long len) {
  while (len > 1) {
    int32_t best_rank = INT32_MAX, bx = 0, by = 0, bz = 0;
    for (long i = 0; i + 1 < len; i++) {
      int32_t zz;
      int32_t r = tab.find(buf[i], buf[i + 1], &zz);
      if (r < best_rank) {
        best_rank = r;
        bx = buf[i];
        by = buf[i + 1];
        bz = zz;
      }
    }
    if (best_rank == INT32_MAX) break;
    long w = 0, i = 0;
    while (i < len) {
      if (i + 1 < len && buf[i] == bx && buf[i + 1] == by) {
        buf[w++] = bz;
        i += 2;
      } else {
        buf[w++] = buf[i++];
      }
    }
    len = w;
  }
  return len;
}

}  // namespace

extern "C" {

void *yttm_ctx_new() { return new Ctx(); }
void yttm_ctx_free(void *c) { delete (Ctx *)c; }
void yttm_ctx_reset(void *c) { ((Ctx *)c)->reset(); }
long yttm_ctx_n_words(void *c) { return ((Ctx *)c)->wmap.count; }

// Tokenize one batch against the persistent word cache.
//
//   occ_stream [occ_cap]   per item: GLOBAL uid >= 0, or -1 for '\n'
//   words_flat/word_off    id sequences of the batch's NEW unique words
//                          (word_off[k] for local k in [0, n_new])
//   out[0..4] = n_flat, n_new, n_occ, error, base_uid
//
// New words get uids base_uid, base_uid+1, ... in discovery order.
void yttm_ctx_tokenize(void *cptr, const uint8_t *data, long n,
                       const uint32_t *alpha_cps, const int32_t *alpha_ids,
                       long n_alpha, int32_t space_id, int32_t *words_flat,
                       long words_cap, int32_t *word_off, long uniq_cap,
                       int32_t *occ_stream, long occ_cap, int64_t *out) {
  Ctx &ctx = *(Ctx *)cptr;
  CharMap cmap;
  cmap.build(alpha_cps, alpha_ids, n_alpha);
  long base_uid = ctx.wmap.count;

  long flat = 0;
  long occ = 0;
  long n_new = 0;
  word_off[0] = 0;

  long i = 0;
  while (i < n) {
    uint8_t b = data[i];
    if (b == 0x0A) {
      if (occ >= occ_cap) { out[3] = -1; return; }
      occ_stream[occ++] = -1;
      i++;
      continue;
    }
    if (is_space_byte(b)) { i++; continue; }
    if (is_meta_space(data + i, n - i)) { i += 3; continue; }
    long ws = i;
    while (i < n) {
      uint8_t c = data[i];
      if (is_space_byte(c) || is_meta_space(data + i, n - i)) break;
      i++;
    }
    long we = i;
    bool fresh = false;
    int32_t uid = ctx.wmap.get_or_add(data + ws, we - ws, &fresh);
    if (fresh) {
      if (n_new >= uniq_cap) { out[3] = -1; return; }
      // re-point the just-inserted slot at arena-owned bytes (the batch
      // buffer dies after this call)
      const uint8_t *stable = ctx.word_bytes.put(data + ws, we - ws);
      ctx.wmap.repoint_last(stable);
      if (flat >= words_cap) { out[3] = -1; return; }
      words_flat[flat++] = space_id;
      long j = ws;
      bool in_unknown = false;
      int32_t next_ph = PLACEHOLDER_START;
      while (j < we) {
        int len;
        uint32_t cp = decode_char(data + j, we - j, &len);
        j += len;
        if (cp == INVALID_CP) continue;
        int32_t id = cmap.get(cp);
        if (id >= 0) {
          if (flat >= words_cap) { out[3] = -1; return; }
          words_flat[flat++] = id;
          in_unknown = false;
        } else {
          if (!in_unknown) {
            if (flat >= words_cap) { out[3] = -1; return; }
            words_flat[flat++] = next_ph++;
            in_unknown = true;
          }
        }
      }
      n_new++;
      word_off[n_new] = (int32_t)flat;
    }
    if (occ >= occ_cap) { out[3] = -1; return; }
    occ_stream[occ++] = uid;
  }
  out[0] = flat;
  out[1] = n_new;
  out[2] = occ;
  out[3] = 0;
  out[4] = base_uid;
}

// Register merge results for uids [base_uid, base_uid + n_new): cache
// the ids and their pre-formatted "id id ... " text.
void yttm_ctx_add_results(void *cptr, const int32_t *results_flat,
                          const int32_t *res_off, long base_uid, long n_new) {
  Ctx &ctx = *(Ctx *)cptr;
  const DecLut &lut = dec_lut();
  if ((long)ctx.ids_ptr.size() < base_uid + n_new) {
    ctx.ids_ptr.resize(base_uid + n_new);
    ctx.ids_len.resize(base_uid + n_new);
    ctx.fmt_ptr.resize(base_uid + n_new);
    ctx.fmt_len.resize(base_uid + n_new);
  }
  std::vector<char> scratch;
  for (long k = 0; k < n_new; k++) {
    int32_t a = res_off[k], b = res_off[k + 1];
    long uid = base_uid + k;
    ctx.ids_ptr[uid] = (const int32_t *)ctx.result_data.put(
        results_flat + a, (size_t)(b - a) * 4);
    ctx.ids_len[uid] = b - a;
    scratch.resize((size_t)(b - a) * 12 + 16);
    char *p = scratch.data();
    for (int32_t j = a; j < b; j++) p = lut.emit(p, results_flat[j]);
    ctx.fmt_ptr[uid] =
        (const char *)ctx.result_data.put(scratch.data(), p - scratch.data());
    ctx.fmt_len[uid] = (int32_t)(p - scratch.data());
  }
  ctx.n_results = base_uid + n_new;
}

// Expand an occurrence stream (global uids) to formatted CLI text.
long yttm_ctx_format(void *cptr, const int32_t *occ_stream, long n_occ,
                     char *out_text, long out_cap) {
  Ctx &ctx = *(Ctx *)cptr;
  char *p = out_text;
  char *end = out_text + out_cap - 16;
  for (long i = 0; i < n_occ; i++) {
    int32_t u = occ_stream[i];
    if (u < 0) {
      if (p >= end) return -1;
      *p++ = '\n';
      continue;
    }
    int32_t l = ctx.fmt_len[u];
    if (p + l >= end) return -1;
    memcpy(p, ctx.fmt_ptr[u], l);
    p += l;
  }
  return p - out_text;
}

// Expand an occurrence stream to a flat id array (-1 at '\n').
long yttm_ctx_expand_ids(void *cptr, const int32_t *occ_stream, long n_occ,
                         int32_t *out_ids, long out_cap) {
  Ctx &ctx = *(Ctx *)cptr;
  long m = 0;
  for (long i = 0; i < n_occ; i++) {
    int32_t u = occ_stream[i];
    if (u < 0) {
      if (m >= out_cap) return -1;
      out_ids[m++] = -1;
      continue;
    }
    int32_t l = ctx.ids_len[u];
    if (m + l > out_cap) return -1;
    memcpy(out_ids + m, ctx.ids_ptr[u], (size_t)l * 4);
    m += l;
  }
  return m;
}

// Total byte length of the ids of an occurrence stream (for sizing).
long yttm_ctx_out_bound(void *cptr, const int32_t *occ_stream, long n_occ,
                        long *n_ids, long *n_text) {
  Ctx &ctx = *(Ctx *)cptr;
  long ids = 0, text = 0;
  for (long i = 0; i < n_occ; i++) {
    int32_t u = occ_stream[i];
    if (u < 0) { ids += 1; text += 1; continue; }
    ids += ctx.ids_len[u];
    text += ctx.fmt_len[u];
  }
  *n_ids = ids;
  *n_text = text;
  return 0;
}

// Tokenize a newline-separated byte stream into a unique-word table and
// an occurrence stream.
//
// Outputs:
//   words_flat [words_cap]  unique words as id sequences, space-prefixed
//   word_off   [uniq_cap+1] offsets into words_flat
//   occ_stream [occ_cap]    per item: uid >= 0, or -1 for '\n'
//   uid_counts [uniq_cap]   occurrence count per unique word
//   out[0..3] = n_words_flat, n_unique, n_occ, error(0 ok, -1 capacity)
void yttm_tokenize(const uint8_t *data, long n, const uint32_t *alpha_cps,
                   const int32_t *alpha_ids, long n_alpha, int32_t space_id,
                   int32_t *words_flat, long words_cap, int32_t *word_off,
                   long uniq_cap, int32_t *occ_stream, long occ_cap,
                   int64_t *uid_counts, int64_t *out) {
  CharMap cmap;
  cmap.build(alpha_cps, alpha_ids, n_alpha);
  WordMap wmap;
  wmap.init(1024);

  long flat = 0;
  long occ = 0;
  word_off[0] = 0;

  long i = 0;
  while (i < n) {
    uint8_t b = data[i];
    if (b == 0x0A) {
      if (occ >= occ_cap) { out[3] = -1; return; }
      occ_stream[occ++] = -1;
      i++;
      continue;
    }
    if (is_space_byte(b)) {
      i++;
      continue;
    }
    if (is_meta_space(data + i, n - i)) {
      i += 3;
      continue;
    }
    // word span over raw bytes
    long ws = i;
    while (i < n) {
      uint8_t c = data[i];
      if (is_space_byte(c) || is_meta_space(data + i, n - i)) break;
      i++;
    }
    long we = i;
    bool fresh = false;
    int32_t uid = wmap.get_or_add(data + ws, we - ws, &fresh);
    if (fresh) {
      if ((long)wmap.count >= uniq_cap) { out[3] = -1; return; }
      uid_counts[uid] = 0;
      // decode + id-ify with unknown-run collapse
      if (flat >= words_cap) { out[3] = -1; return; }
      words_flat[flat++] = space_id;
      long j = ws;
      bool in_unknown = false;
      int32_t next_ph = PLACEHOLDER_START;
      while (j < we) {
        int len;
        uint32_t cp = decode_char(data + j, we - j, &len);
        j += len;
        if (cp == INVALID_CP) continue;  // dropped (decode_utf8 skips)
        int32_t id = cmap.get(cp);
        if (id >= 0) {
          if (flat >= words_cap) { out[3] = -1; return; }
          words_flat[flat++] = id;
          in_unknown = false;
        } else {
          if (!in_unknown) {
            if (flat >= words_cap) { out[3] = -1; return; }
            words_flat[flat++] = next_ph++;
            in_unknown = true;
          }
        }
      }
      word_off[uid + 1] = (int32_t)flat;
    }
    uid_counts[uid]++;
    if (occ >= occ_cap) { out[3] = -1; return; }
    occ_stream[occ++] = uid;
  }
  out[0] = flat;
  out[1] = (long)wmap.count;
  out[2] = occ;
  out[3] = 0;
}

// Expand device results back to the occurrence stream and format as
// reference CLI text ("id id \n" per sentence).  results_flat/res_off
// describe the merged token ids of each unique word.  Returns bytes
// written, or -1 if out_cap is too small.
//
// Two-pass: (1) format every *unique* word once into a scratch arena
// using a decimal LUT ("id " for all ids < 65536, 8-byte strided so the
// copy is a single unconditional 8-byte store), (2) memcpy each
// occurrence's pre-formatted span.  The naive per-occurrence digit loop
// was the CLI encode bottleneck (~22 MB/s); this runs at memcpy speed.
long yttm_expand_format(const int32_t *occ_stream, long n_occ,
                        const int32_t *results_flat, const int32_t *res_off,
                        char *out_text, long out_cap) {
  const DecLut &lut = dec_lut();

  // pass 1: format unique words into a scratch arena
  long n_uniq = 0;
  for (long i = 0; i < n_occ; i++)
    if (occ_stream[i] >= n_uniq) n_uniq = occ_stream[i] + 1;
  std::vector<long> warena_off(n_uniq + 1, 0);
  long flat_total = n_uniq ? res_off[n_uniq] : 0;
  std::vector<char> arena((size_t)flat_total * 12 + 16);
  char *ap = arena.data();
  for (long u = 0; u < n_uniq; u++) {
    warena_off[u] = ap - arena.data();
    for (int32_t j = res_off[u]; j < res_off[u + 1]; j++)
      ap = lut.emit(ap, results_flat[j]);
  }
  warena_off[n_uniq] = ap - arena.data();

  // pass 2: memcpy per occurrence
  char *p = out_text;
  char *end = out_text + out_cap - 16;
  const char *ab = arena.data();
  for (long i = 0; i < n_occ; i++) {
    int32_t u = occ_stream[i];
    if (u < 0) {
      if (p >= end) return -1;
      *p++ = '\n';
      continue;
    }
    long a = warena_off[u], b = warena_off[u + 1];
    if (p + (b - a) >= end) return -1;
    memcpy(p, ab + a, b - a);
    p += b - a;
  }
  return p - out_text;
}

// Expand device results into a flat id array with -1 sentinels at
// sentence boundaries.  Returns token count, or -1 on capacity.
long yttm_expand_ids(const int32_t *occ_stream, long n_occ,
                     const int32_t *results_flat, const int32_t *res_off,
                     int32_t *out_ids, long out_cap) {
  long m = 0;
  for (long i = 0; i < n_occ; i++) {
    int32_t u = occ_stream[i];
    if (u < 0) {
      if (m >= out_cap) return -1;
      out_ids[m++] = -1;
      continue;
    }
    int32_t a = res_off[u], b = res_off[u + 1];
    if (m + (b - a) > out_cap) return -1;
    for (int32_t j = a; j < b; j++) out_ids[m++] = results_flat[j];
  }
  return m;
}

// -- host greedy merge ------------------------------------------------

void *yttm_ruletab_new(const int32_t *rules, long n_rules) {
  RuleTab *t = new RuleTab();
  t->init(rules, n_rules);
  return t;
}

void yttm_ruletab_free(void *t) { delete (RuleTab *)t; }

// Merge every word of the ragged (flat, off[n_words+1]) batch.  Output
// never exceeds input (merging shrinks), so out_flat is caller-sized to
// off[n_words]; out_off gets n_words+1 entries.
// Dropout-merge every OCCURRENCE of the ragged word batch: occ holds
// uids >= 0 (each sampled independently with fresh coins) or -1 line
// sentinels (emitted as a single -1).  Returns the emitted length, or
// -1 on capacity overflow.
long yttm_merge_occurrences_dropout(const void *tab, const int32_t *flat,
                                    const int64_t *off, const int32_t *occ,
                                    long n_occ, double p, uint64_t seed,
                                    int32_t *out_flat, long out_cap) {
  const RuleTab &t = *(const RuleTab *)tab;
  Rng rng(seed);
  std::vector<int32_t> buf;
  long w = 0;
  for (long i = 0; i < n_occ; i++) {
    int32_t u = occ[i];
    if (u < 0) {
      if (w + 1 > out_cap) return -1;
      out_flat[w++] = -1;
      continue;
    }
    int64_t a = off[u], b = off[u + 1];
    long len = (long)(b - a);
    buf.assign(flat + a, flat + b);
    len = merge_word_dropout(t, buf.data(), len, p, rng);
    if (w + len > out_cap) return -1;
    for (long j = 0; j < len; j++) out_flat[w++] = buf[j];
  }
  return w;
}

void yttm_merge_words(const void *tab, const int32_t *flat,
                      const int64_t *off, long n_words, int32_t *out_flat,
                      int64_t *out_off) {
  const RuleTab &t = *(const RuleTab *)tab;
  int64_t w = 0;
  out_off[0] = 0;
  for (long u = 0; u < n_words; u++) {
    int64_t a = off[u], b = off[u + 1];
    long len = (long)(b - a);
    int32_t *dst = out_flat + w;
    for (long i = 0; i < len; i++) dst[i] = flat[a + i];
    w += merge_word(t, dst, len);
    out_off[u + 1] = w;
  }
}

}  // extern "C"
