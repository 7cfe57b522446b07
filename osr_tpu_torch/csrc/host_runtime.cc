// The host runtime of osr_tpu_torch: the C++ stages of the sparse search
// path and of index building, bound with ctypes by osr_tpu_torch/native.py
// and built at first use by osr_tpu_torch/ops/_build.py (g++ -O3
// -march=native -ffp-contract=off; no -lz).
//
//   - tf_build:       corpus tokenization + per-document term-frequency
//                     counting (the NumPy twin is the Counter loop of
//                     osr_tpu_torch/index/builder.py)
//   - tokenize_ascii: query/document tokenization (runs of [a-z0-9_] after
//                     ASCII lowercasing: the tokens of
//                     re.findall(r"\b\w+\b", text.lower()) on ASCII input)
//   - vocab_* / encode_queries: batch query encoding against a fixed
//                     vocabulary (tid, count), the per-batch host hot path
//   - tail_candidates / cand_head_dot / merge_topk: the term-at-a-time tail
//                     scorer + exact head/tail top-k merge
//                     (osr_tpu_torch/index/postings.py documents the
//                     algorithm; its NumPy bodies are the reference)
//   - pack_hybrid_*:  fused weight + quantized-head + postings pack
//   - henc_*:         the HashingEncoder's featurize/hash/scatter core
//
// Every entry point carries the osrh_ prefix and the library's own helpers
// are hidden (-fvisibility=hidden), so a process that also loads another
// build of these loops binds each name to one library. Nothing here
// changes the process's allocator: the tail walker keeps its scratch in a
// pool of its own (WalkScratchPool below). Results are bit-identical to
// the NumPy twins: -ffp-contract=off, the same summation orders, the same
// tie rules.
//
// Exposed via a plain C ABI for ctypes (no pybind11 dependency).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <memory>
#include <mutex>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

#define OSRH_API __attribute__((visibility("default")))

namespace {

inline bool is_word_byte(unsigned char c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
         (c >= '0' && c <= '9') || c == '_';
}

inline char lower_byte(unsigned char c) {
  return (c >= 'A' && c <= 'Z') ? static_cast<char>(c + 32)
                                : static_cast<char>(c);
}

// Stable-address string interning: views handed out never move because each
// chunk's capacity is fixed up front and never exceeded.
struct Arena {
  std::vector<std::string> chunks;
  static constexpr size_t kChunk = 1 << 20;

  std::string_view intern(const std::string& s) {
    size_t need = s.size();
    if (chunks.empty() ||
        chunks.back().size() + need > chunks.back().capacity()) {
      chunks.emplace_back();
      chunks.back().reserve(need > kChunk ? need : kChunk);
    }
    std::string& c = chunks.back();
    size_t off = c.size();
    c.append(s);
    return std::string_view(c.data() + off, need);
  }
};

struct TfResult {
  std::vector<int64_t> indptr;     // (ndocs+1) into term_ids/counts
  std::vector<int32_t> term_ids;   // temp ids, first-seen order
  std::vector<float> counts;       // per-(doc, term) tf
  std::vector<float> doc_lengths;  // total tokens per doc
  std::vector<int64_t> df;         // per temp id
  std::string term_buf;            // concatenated term bytes
  std::vector<int64_t> term_offs;  // (nterms+1) into term_buf
};

struct TfState {
  TfResult result;
  std::string lowered;                  // lowercased copy of the corpus
  std::vector<std::string_view> terms;  // temp id -> bytes (into `lowered`)
};

// Open-addressing term table: power-of-two capacity, linear probing,
// FNV-1a hashes computed inline during the token scan. ~3x faster than
// unordered_map<string_view,...> for the tf_build workload (no node
// allocations, no bucket pointer chase).
struct TermTable {
  struct Slot {
    const char* p = nullptr;  // nullptr = empty
    uint32_t len = 0;
    uint64_t h = 0;
    int32_t id = 0;
  };
  std::vector<Slot> slots;
  size_t mask = 0;
  size_t count = 0;

  void init(size_t expect) {
    size_t cap = 1 << 10;
    while (cap < expect * 2) cap <<= 1;
    slots.assign(cap, Slot{});
    mask = cap - 1;
  }

  void grow() {
    std::vector<Slot> old = std::move(slots);
    slots.assign(old.size() * 2, Slot{});
    mask = slots.size() - 1;
    for (const Slot& s : old) {
      if (!s.p) continue;
      size_t i = static_cast<size_t>(s.h) & mask;
      while (slots[i].p) i = (i + 1) & mask;
      slots[i] = s;
    }
  }

  // Returns the existing id, or assigns `next_id` and returns -1 (caller
  // registers the new term).
  int32_t find_or_insert(const char* p, uint32_t len, uint64_t h,
                         int32_t next_id) {
    if ((count + 1) * 10 > slots.size() * 7) grow();
    size_t i = static_cast<size_t>(h) & mask;
    while (slots[i].p) {
      if (slots[i].h == h && slots[i].len == len &&
          std::memcmp(slots[i].p, p, len) == 0) {
        return slots[i].id;
      }
      i = (i + 1) & mask;
    }
    slots[i] = Slot{p, len, h, next_id};
    ++count;
    return -1;
  }
};

}  // namespace

namespace {

struct VocabState {
  Arena arena;
  std::unordered_map<std::string_view, int32_t> map;
};

// Thread-count override (0 = auto from hardware_concurrency + work size).
// Every parallel_ranges partition is deterministic given the thread count,
// and each thread owns a disjoint output range with per-item/per-query
// accumulation order independent of the partition — so results are
// bit-identical across thread counts (tests/test_torch_native.py
// proves it).
std::atomic<int> g_thread_override{0};

inline int n_threads_for(int64_t work, int64_t min_per_thread) {
  int forced = g_thread_override.load(std::memory_order_relaxed);
  if (forced > 0) return forced > 64 ? 64 : forced;
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (hw <= 0) hw = 4;
  int64_t by_work = work / (min_per_thread > 0 ? min_per_thread : 1);
  int n = static_cast<int>(std::min<int64_t>(hw, by_work));
  return n < 1 ? 1 : (n > 16 ? 16 : n);
}

// ---------------------------------------------------------------------------
// BLAKE2b (RFC 7693), keyless — the feature-hashing encoder's hash.
// Only the 64-bit (digest_size=8) truncation is exposed; hash64() returns
// exactly int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
// "little") so the native encoder's vectors are bit-identical to the
// Python HashingEncoder's (osr_tpu_torch/encoders.py).
// ---------------------------------------------------------------------------

namespace blake2b {

constexpr uint64_t kIV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

constexpr uint8_t kSigma[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};

inline uint64_t rotr64(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

inline void g(uint64_t* v, int a, int b, int c, int d, uint64_t x,
              uint64_t y) {
  v[a] = v[a] + v[b] + x;
  v[d] = rotr64(v[d] ^ v[a], 32);
  v[c] = v[c] + v[d];
  v[b] = rotr64(v[b] ^ v[c], 24);
  v[a] = v[a] + v[b] + y;
  v[d] = rotr64(v[d] ^ v[a], 16);
  v[c] = v[c] + v[d];
  v[b] = rotr64(v[b] ^ v[c], 63);
}

// One compression of a 128-byte block; t = total bytes hashed so far
// INCLUDING this block (inputs stay < 2^64 bytes, so the high counter
// word is always zero).
inline void compress(uint64_t h[8], const uint8_t block[128], uint64_t t,
                     bool last) {
  uint64_t m[16];
  std::memcpy(m, block, 128);  // little-endian host (x86-64 / aarch64)
  uint64_t v[16];
  for (int i = 0; i < 8; ++i) v[i] = h[i];
  for (int i = 0; i < 8; ++i) v[i + 8] = kIV[i];
  v[12] ^= t;
  if (last) v[14] = ~v[14];
  for (int r = 0; r < 12; ++r) {
    const uint8_t* s = kSigma[r];
    g(v, 0, 4, 8, 12, m[s[0]], m[s[1]]);
    g(v, 1, 5, 9, 13, m[s[2]], m[s[3]]);
    g(v, 2, 6, 10, 14, m[s[4]], m[s[5]]);
    g(v, 3, 7, 11, 15, m[s[6]], m[s[7]]);
    g(v, 0, 5, 10, 15, m[s[8]], m[s[9]]);
    g(v, 1, 6, 11, 12, m[s[10]], m[s[11]]);
    g(v, 2, 7, 8, 13, m[s[12]], m[s[13]]);
    g(v, 3, 4, 9, 14, m[s[14]], m[s[15]]);
  }
  for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
}

// Keyless blake2b with digest_size=8, returned as the little-endian
// uint64 the 8-byte digest spells (= h[0] on a little-endian host).
inline uint64_t hash64(const uint8_t* data, size_t len) {
  uint64_t h[8];
  std::memcpy(h, kIV, sizeof h);
  h[0] ^= 0x01010000ULL ^ 8ULL;  // digest_length=8, fanout=1, depth=1
  size_t off = 0;
  while (len - off > 128) {  // the final block (even a full one) is below
    compress(h, data + off, static_cast<uint64_t>(off) + 128, false);
    off += 128;
  }
  uint8_t block[128] = {0};
  std::memcpy(block, data + off, len - off);
  compress(h, block, static_cast<uint64_t>(len), true);
  return h[0];
}

}  // namespace blake2b

// ---------------------------------------------------------------------------
// Feature-hashing encoder state (native fast path of
// osr_tpu_torch/encoders.py:HashingEncoder — signed feature hashing of word
// unigrams+ngrams, sublinear TF, optional corpus-fitted smooth IDF).
// Tokenization stays in Python (re.findall keeps exact unicode
// semantics); documents arrive as '\0'-joined utf-8 token buffers.
// ---------------------------------------------------------------------------

struct HashEncState {
  int64_t dim = 0;
  int64_t ngrams = 1;
  bool use_idf = false;
  int64_t n_docs = 0;
  // Document frequencies keyed by the 64-bit feature hash — the SAME
  // keying the Python fit() uses for its df dict, so IDF values match
  // exactly. (The per-doc TF counter below also keys by this hash where
  // Python's Counter keys by the feature string; a within-document
  // 64-bit collision — probability ~1e-15 per document — is the only
  // divergence, and it perturbs one sublinear-TF term.)
  std::unordered_map<uint64_t, int32_t> df;
};

// Scratch reused across documents by one thread.
struct HashEncScratch {
  std::vector<std::pair<const char*, int64_t>> toks;
  std::unordered_map<uint64_t, int32_t> idx;            // h -> uniq pos
  std::vector<std::pair<uint64_t, int32_t>> uniq;       // insertion order
  std::string ngram;
};

// Split a '\0'-joined token buffer (no empty tokens are produced by the
// Python side; an empty buffer means zero tokens).
inline void split_tokens(const char* data, int64_t len,
                         std::vector<std::pair<const char*, int64_t>>* out) {
  out->clear();
  if (len <= 0) return;
  const char* p = data;
  const char* end = data + len;
  while (p < end) {
    const char* nul =
        static_cast<const char*>(std::memchr(p, '\0', end - p));
    const char* stop = nul ? nul : end;
    if (stop > p) out->emplace_back(p, stop - p);
    p = stop + 1;
  }
}

// Count features of one document in first-occurrence order: unigrams in
// token order, then every n-gram window for n = 2..ngrams — the exact
// feature order of HashingEncoder._features, so the scatter-add below
// replays the Python accumulation order bit-for-bit.
inline void count_features(const HashEncState& st, const char* data,
                           int64_t len, HashEncScratch* sc) {
  split_tokens(data, len, &sc->toks);
  sc->idx.clear();
  sc->uniq.clear();
  auto add = [&](const uint8_t* p, size_t n) {
    uint64_t h = blake2b::hash64(p, n);
    auto it = sc->idx.find(h);
    if (it == sc->idx.end()) {
      sc->idx.emplace(h, static_cast<int32_t>(sc->uniq.size()));
      sc->uniq.emplace_back(h, 1);
    } else {
      sc->uniq[it->second].second += 1;
    }
  };
  const auto& toks = sc->toks;
  int64_t m = static_cast<int64_t>(toks.size());
  for (const auto& t : toks) {
    add(reinterpret_cast<const uint8_t*>(t.first),
        static_cast<size_t>(t.second));
  }
  for (int64_t n = 2; n <= st.ngrams; ++n) {
    for (int64_t i = 0; i + n <= m; ++i) {
      sc->ngram.assign(toks[i].first, toks[i].second);
      for (int64_t j = 1; j < n; ++j) {
        sc->ngram.push_back(' ');
        sc->ngram.append(toks[i + j].first, toks[i + j].second);
      }
      add(reinterpret_cast<const uint8_t*>(sc->ngram.data()),
          sc->ngram.size());
    }
  }
}

inline double henc_idf_value(const HashEncState& st, uint64_t h) {
  if (!st.use_idf) return 1.0;
  auto it = st.df.find(h);
  double d = it == st.df.end() ? 0.0 : static_cast<double>(it->second);
  return std::log((1.0 + static_cast<double>(st.n_docs)) / (1.0 + d)) + 1.0;
}

template <typename Fn>
void parallel_ranges(int64_t n, int threads, Fn fn) {
  if (threads <= 1 || n <= 1) {
    fn(0, n, 0);
    return;
  }
  std::vector<std::thread> pool;
  int64_t per = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * per;
    int64_t hi = std::min<int64_t>(n, lo + per);
    if (lo >= hi) break;
    pool.emplace_back([=] { fn(lo, hi, t); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// ABI version of this library's C surface. Bump whenever an EXISTING
// exported function's signature changes; osr_tpu_torch/native.py refuses a
// library whose number differs from the one it was written for.
OSRH_API
int64_t osrh_abi_version(void) { return 1; }

// ---------------------------------------------------------------------------
// Host thread-count control
// ---------------------------------------------------------------------------

// n <= 0 restores auto (hardware_concurrency, work-size-bounded).
OSRH_API
void osrh_set_num_threads(int n) {
  g_thread_override.store(n > 0 ? n : 0, std::memory_order_relaxed);
}

// The thread count a large-work parallel section would use right now.
OSRH_API
int osrh_get_num_threads(void) {
  return n_threads_for(std::numeric_limits<int64_t>::max() / 2, 1);
}

// ---------------------------------------------------------------------------
// Corpus term-frequency builder
// ---------------------------------------------------------------------------

OSRH_API
void* osrh_tf_build(const char* buf, int64_t nbytes, const int64_t* doc_offs,
                    int64_t ndocs) {
  auto* st = new TfState();
  TfResult& r = st->result;

  // Lowercase the whole corpus once; tokens are then zero-copy views into
  // this buffer (token boundaries are unchanged by lowering — A-Z and a-z
  // are both word bytes).
  st->lowered.resize(static_cast<size_t>(nbytes));
  char* low = st->lowered.data();
  for (int64_t i = 0; i < nbytes; ++i) {
    low[i] = lower_byte(static_cast<unsigned char>(buf[i]));
  }

  TermTable table;
  table.init(1 << 15);

  r.indptr.reserve(ndocs + 1);
  r.indptr.push_back(0);
  r.doc_lengths.reserve(ndocs);

  // Per-doc dedup without clearing: term id -> (last doc, slot in its row).
  std::vector<int64_t> epoch_of;
  std::vector<int64_t> slot_of;

  constexpr uint64_t kFnvOffset = 1469598103934665603ULL;
  constexpr uint64_t kFnvPrime = 1099511628211ULL;

  for (int64_t d = 0; d < ndocs; ++d) {
    const char* p = low + doc_offs[d];
    const char* end = low + doc_offs[d + 1];
    int64_t n_tokens = 0;
    while (p < end) {
      while (p < end && !is_word_byte(static_cast<unsigned char>(*p))) ++p;
      if (p >= end) break;
      const char* tok = p;
      uint64_t h = kFnvOffset;
      while (p < end && is_word_byte(static_cast<unsigned char>(*p))) {
        h = (h ^ static_cast<unsigned char>(*p)) * kFnvPrime;
        ++p;
      }
      uint32_t tlen = static_cast<uint32_t>(p - tok);
      ++n_tokens;
      int32_t next_id = static_cast<int32_t>(st->terms.size());
      int32_t id = table.find_or_insert(tok, tlen, h, next_id);
      if (id < 0) {
        id = next_id;
        st->terms.emplace_back(tok, tlen);
        epoch_of.push_back(-1);
        slot_of.push_back(0);
        r.df.push_back(0);
      }
      if (epoch_of[id] != d) {
        epoch_of[id] = d;
        slot_of[id] = static_cast<int64_t>(r.term_ids.size());
        r.term_ids.push_back(id);
        r.counts.push_back(1.0f);
        r.df[id] += 1;
      } else {
        r.counts[slot_of[id]] += 1.0f;
      }
    }
    r.indptr.push_back(static_cast<int64_t>(r.term_ids.size()));
    r.doc_lengths.push_back(static_cast<float>(n_tokens));
  }

  // Flatten the term table for the ctypes copy-out, then release the
  // lowercased corpus copy: only the (few) unique term bytes survive in
  // term_buf, so peak RSS between tf_build and tf_free stays ~O(vocab)
  // instead of ~O(corpus) (GBs at the 1M-doc scale).
  r.term_offs.reserve(st->terms.size() + 1);
  r.term_offs.push_back(0);
  size_t total = 0;
  for (const auto& t : st->terms) total += t.size();
  r.term_buf.reserve(total);
  for (const auto& t : st->terms) {
    r.term_buf.append(t.data(), t.size());
    r.term_offs.push_back(static_cast<int64_t>(r.term_buf.size()));
  }
  st->terms.clear();
  st->terms.shrink_to_fit();
  st->lowered.clear();
  st->lowered.shrink_to_fit();
  return st;
}

OSRH_API
int64_t osrh_tf_num_terms(void* h) {
  return static_cast<int64_t>(
      static_cast<TfState*>(h)->result.term_offs.size() - 1);
}
OSRH_API
int64_t osrh_tf_nnz(void* h) {
  return static_cast<int64_t>(
      static_cast<TfState*>(h)->result.term_ids.size());
}
OSRH_API
int64_t osrh_tf_term_bytes(void* h) {
  return static_cast<int64_t>(
      static_cast<TfState*>(h)->result.term_buf.size());
}

OSRH_API
void osrh_tf_copy(void* h, int64_t* indptr, int32_t* term_ids, float* counts,
                  float* doc_lengths, int64_t* df, char* term_buf,
                  int64_t* term_offs) {
  TfResult& r = static_cast<TfState*>(h)->result;
  std::memcpy(indptr, r.indptr.data(), r.indptr.size() * sizeof(int64_t));
  std::memcpy(term_ids, r.term_ids.data(),
              r.term_ids.size() * sizeof(int32_t));
  std::memcpy(counts, r.counts.data(), r.counts.size() * sizeof(float));
  std::memcpy(doc_lengths, r.doc_lengths.data(),
              r.doc_lengths.size() * sizeof(float));
  std::memcpy(df, r.df.data(), r.df.size() * sizeof(int64_t));
  std::memcpy(term_buf, r.term_buf.data(), r.term_buf.size());
  std::memcpy(term_offs, r.term_offs.data(),
              r.term_offs.size() * sizeof(int64_t));
}

OSRH_API
void osrh_tf_free(void* h) { delete static_cast<TfState*>(h); }

// ---------------------------------------------------------------------------
// ASCII tokenizer (query path)
// ---------------------------------------------------------------------------

// Lowercase `text` into `out` (same length) and record token [start, end)
// byte offsets. Returns the token count (clipped at max_tokens).
OSRH_API
int64_t osrh_tokenize_ascii(const char* text, int64_t len, char* out,
                            int64_t* starts, int64_t* ends,
                            int64_t max_tokens) {
  for (int64_t i = 0; i < len; ++i) {
    out[i] = lower_byte(static_cast<unsigned char>(text[i]));
  }
  int64_t n = 0;
  int64_t i = 0;
  while (i < len && n < max_tokens) {
    while (i < len && !is_word_byte(static_cast<unsigned char>(text[i]))) ++i;
    if (i >= len) break;
    starts[n] = i;
    while (i < len && is_word_byte(static_cast<unsigned char>(text[i]))) ++i;
    ends[n] = i;
    ++n;
  }
  return n;
}

// ---------------------------------------------------------------------------
// Query encoding against a fixed vocabulary
// ---------------------------------------------------------------------------

// terms: concatenated bytes of every vocabulary term, ids implicit by order.
OSRH_API
void* osrh_vocab_build(const char* term_buf, const int64_t* term_offs,
                       int64_t n_terms) {
  auto* st = new VocabState();
  st->map.reserve(static_cast<size_t>(n_terms) * 2);
  for (int64_t i = 0; i < n_terms; ++i) {
    std::string term(term_buf + term_offs[i],
                     static_cast<size_t>(term_offs[i + 1] - term_offs[i]));
    std::string_view interned = st->arena.intern(term);
    st->map.emplace(interned, static_cast<int32_t>(i));
  }
  return st;
}

OSRH_API
void osrh_vocab_free(void* h) { delete static_cast<VocabState*>(h); }

// Encode a batch of ASCII queries: per query, sorted unique (term id, count)
// pairs against the vocabulary (OOV terms dropped). Outputs are flat with
// out_ptr segments. Returns total pairs, or -1 if `cap` is too small.
OSRH_API
int64_t osrh_encode_queries(void* vocab_h, const char* buf,
                            const int64_t* q_offs, int64_t nq,
                            int32_t* out_tids,
                            float* out_counts, int64_t* out_ptr, int64_t cap) {
  auto* vocab = static_cast<VocabState*>(vocab_h);
  // Pass 1 (parallel): per-query encode into thread-local buffers.
  std::vector<std::vector<std::pair<int32_t, float>>> rows(
      static_cast<size_t>(nq));
  int threads = n_threads_for(nq, 64);
  parallel_ranges(nq, threads, [&](int64_t lo, int64_t hi, int) {
    std::string token;
    token.reserve(64);
    std::vector<std::pair<int32_t, float>> pairs;
    for (int64_t q = lo; q < hi; ++q) {
      pairs.clear();
      const char* p = buf + q_offs[q];
      const char* end = buf + q_offs[q + 1];
      while (p < end) {
        while (p < end && !is_word_byte(static_cast<unsigned char>(*p))) ++p;
        if (p >= end) break;
        token.clear();
        while (p < end && is_word_byte(static_cast<unsigned char>(*p))) {
          token.push_back(lower_byte(static_cast<unsigned char>(*p)));
          ++p;
        }
        auto it = vocab->map.find(std::string_view(token));
        if (it != vocab->map.end()) pairs.emplace_back(it->second, 1.0f);
      }
      std::sort(pairs.begin(), pairs.end());
      auto& out = rows[static_cast<size_t>(q)];
      for (auto& pr : pairs) {
        if (!out.empty() && out.back().first == pr.first) {
          out.back().second += 1.0f;
        } else {
          out.push_back(pr);
        }
      }
    }
  });
  // Pass 2: flatten.
  int64_t total = 0;
  out_ptr[0] = 0;
  for (int64_t q = 0; q < nq; ++q) {
    total += static_cast<int64_t>(rows[static_cast<size_t>(q)].size());
    out_ptr[q + 1] = total;
  }
  if (total > cap) return -1;
  parallel_ranges(nq, threads, [&](int64_t lo, int64_t hi, int) {
    for (int64_t q = lo; q < hi; ++q) {
      int64_t off = out_ptr[q];
      for (auto& pr : rows[static_cast<size_t>(q)]) {
        out_tids[off] = pr.first;
        out_counts[off] = pr.second;
        ++off;
      }
    }
  });
  return total;
}

// ---------------------------------------------------------------------------
// Term-at-a-time tail scorer (see osr_tpu_torch/index/postings.py)
// ---------------------------------------------------------------------------

}  // extern "C" — the walker's scratch pool below is C++

namespace {

// One walker thread's scratch: its candidate arena and its radix buffers.
// Each set starts on a cache line of its own. The hot loop pushes into
// the arena, writing its vectors' end pointers; per-thread vectors that
// sit side by side (elements of one std::vector) share cache lines across
// threads, which ping-pong between cores and at 8 threads cost more than
// the walk itself.
struct alignas(64) WalkScratch {
  std::vector<int32_t> arena_rows;
  std::vector<float> arena_vals;
  std::vector<int32_t> br, br2;
  std::vector<float> bv, bv2;

  size_t bytes() const {
    return (arena_rows.capacity() + br.capacity() + br2.capacity()) *
               sizeof(int32_t) +
           (arena_vals.capacity() + bv.capacity() + bv2.capacity()) *
               sizeof(float);
  }
};

// Scratch that outlives a call. At 1M+ docs a call's arenas run to
// hundreds of MB; allocated fresh per call they come from mmap, page-fault
// on first touch and are unmapped on free (102 ns/posting against 23 once
// the memory is reused). The pool keeps the sets a call returns and hands
// them to the next call, so only the first call at a new size pays for
// the pages, and glibc's allocator settings stay the process's own.
//
// A call checks out one set per walker thread and returns each with its
// capacity. Callers on several Python threads at once (ctypes releases the
// GIL) each check out their own sets under the mutex. The pool keeps at
// most kMaxSets sets (the most threads one call uses) and at most
// kMaxBytes of capacity in all; a set returned beyond either cap is freed.
class WalkScratchPool {
 public:
  static constexpr size_t kMaxBytes = size_t{1} << 30;  // 1 GiB
  static constexpr size_t kMaxSets = 64;

  std::unique_ptr<WalkScratch> take() {
    std::lock_guard<std::mutex> guard(mu_);
    if (free_.empty()) return std::make_unique<WalkScratch>();
    std::unique_ptr<WalkScratch> s = std::move(free_.back());
    free_.pop_back();
    kept_bytes_ -= s->bytes();
    return s;
  }

  void give(std::unique_ptr<WalkScratch> s) {
    size_t b = s->bytes();
    std::lock_guard<std::mutex> guard(mu_);
    if (free_.size() < kMaxSets && kept_bytes_ + b <= kMaxBytes) {
      kept_bytes_ += b;
      free_.push_back(std::move(s));
    }
  }  // a set the pool does not keep is freed here, after the unlock

 private:
  std::mutex mu_;
  std::vector<std::unique_ptr<WalkScratch>> free_;
  size_t kept_bytes_ = 0;
};

WalkScratchPool& walk_pool() {
  static WalkScratchPool pool;  // built at first use, not at load
  return pool;
}

// The sets one call holds, returned to the pool however the call ends.
struct WalkLease {
  std::vector<std::unique_ptr<WalkScratch>> sets;
  explicit WalkLease(int n) : sets(static_cast<size_t>(n)) {
    for (auto& s : sets) s = walk_pool().take();
  }
  ~WalkLease() {
    for (auto& s : sets) walk_pool().give(std::move(s));
  }
  WalkScratch& operator[](int t) { return *sets[static_cast<size_t>(t)]; }
};

}  // namespace

extern "C" {

// For each query, walk its tail terms' postings, sum duplicate rows, emit a
// flat query-major candidate list (rows ascending per query). Returns total
// candidates, or -1 if `cap` is too small. Rows are non-negative int32s;
// any row count below 2^31 is taken.
//
// Algorithm: structure-of-arrays segment copies (memcpy rows, SIMD-able
// weight*count multiply), STABLE LSD radix sort by row (12-bit digits: two
// passes below 2^24 rows, three at most), one adjacent-duplicate summing
// scan into the thread's arena, then one parallel copy out. The arenas are
// one per thread, not one per query: a per-query vector at 10M docs is a
// ~340 KB reserve PER QUERY, past glibc's mmap threshold. Stability makes
// duplicate summation order = segment (term) order, the NumPy body's
// order.
OSRH_API
int64_t osrh_tail_candidates(const int64_t* post_ptr, const int32_t* post_rows,
                             const float* post_w, const int32_t* q_tids,
                             const float* q_counts, const int64_t* q_ptr,
                             int64_t nq, int32_t* out_rows, int32_t* out_cols,
                             float* out_tail, int64_t* out_qptr, int64_t cap) {
  int threads = n_threads_for(q_ptr[nq] + nq, 256);
  WalkLease scratch(threads);
  std::vector<int64_t> qcount(static_cast<size_t>(nq), 0);
  std::vector<int64_t> qoff(static_cast<size_t>(nq), 0);
  std::vector<int> qthread(static_cast<size_t>(nq), 0);
  parallel_ranges(nq, threads, [&](int64_t lo, int64_t hi, int t) {
    constexpr int kBits = 12;
    constexpr int kBuckets = 1 << kBits;  // 4096
    constexpr uint32_t kMask = kBuckets - 1;
    // int64 histogram: a query whose terms' postings total >= 2^31 would
    // overflow int32 offsets (unreachable at 1-10M docs, but the layout
    // imposes no such cap).
    std::vector<int64_t> hist(kBuckets);
    WalkScratch& sc = scratch[t];
    auto& br = sc.br;
    auto& br2 = sc.br2;
    auto& bv = sc.bv;
    auto& bv2 = sc.bv2;
    auto& ar = sc.arena_rows;
    auto& av = sc.arena_vals;
    // One arena reserve per call: the range's total postings bound the
    // range's total candidates.
    int64_t range_post = 0;
    for (int64_t j = q_ptr[lo]; j < q_ptr[hi]; ++j) {
      int32_t tt = q_tids[j];
      range_post += post_ptr[tt + 1] - post_ptr[tt];
    }
    ar.clear();
    av.clear();
    ar.reserve(static_cast<size_t>(range_post));
    av.reserve(static_cast<size_t>(range_post));
    for (int64_t q = lo; q < hi; ++q) {
      int64_t total_post = 0;
      for (int64_t j = q_ptr[q]; j < q_ptr[q + 1]; ++j) {
        int32_t tt = q_tids[j];
        total_post += post_ptr[tt + 1] - post_ptr[tt];
      }
      qthread[static_cast<size_t>(q)] = t;
      qoff[static_cast<size_t>(q)] = static_cast<int64_t>(ar.size());
      if (total_post == 0) continue;
      if (static_cast<int64_t>(br.size()) < total_post) {
        br.resize(static_cast<size_t>(total_post));
        bv.resize(static_cast<size_t>(total_post));
        br2.resize(static_cast<size_t>(total_post));
        bv2.resize(static_cast<size_t>(total_post));
      }
      int64_t n = 0;
      uint32_t max_row = 0;
      for (int64_t j = q_ptr[q]; j < q_ptr[q + 1]; ++j) {
        int32_t tt = q_tids[j];
        float cnt = q_counts[j];
        int64_t a = post_ptr[tt], z = post_ptr[tt + 1];
        int64_t len = z - a;
        if (len == 0) continue;
        std::memcpy(br.data() + n, post_rows + a,
                    static_cast<size_t>(len) * sizeof(int32_t));
        const float* w = post_w + a;
        float* dst = bv.data() + n;
        for (int64_t i = 0; i < len; ++i) dst[i] = w[i] * cnt;
        uint32_t last = static_cast<uint32_t>(post_rows[z - 1]);
        if (last > max_row) max_row = last;
        n += len;
      }
      // LSD radix passes over 12-bit digits of the unsigned 32-bit key,
      // skipping digits above the max row. The shift stays below the key
      // width: shifts 0, 12 and 24 cover every row below 2^31.
      for (int shift = 0; shift < 32 && (shift == 0 || (max_row >> shift) != 0);
           shift += kBits) {
        std::fill(hist.begin(), hist.end(), 0);
        for (int64_t i = 0; i < n; ++i) {
          ++hist[(static_cast<uint32_t>(br[i]) >> shift) & kMask];
        }
        int64_t run = 0;
        for (int bkt = 0; bkt < kBuckets; ++bkt) {
          int64_t c = hist[bkt];
          hist[bkt] = run;
          run += c;
        }
        for (int64_t i = 0; i < n; ++i) {
          int64_t dst = hist[(static_cast<uint32_t>(br[i]) >> shift) & kMask]++;
          br2[static_cast<size_t>(dst)] = br[i];
          bv2[static_cast<size_t>(dst)] = bv[i];
        }
        br.swap(br2);
        bv.swap(bv2);
      }
      // Adjacent-duplicate sum into the arena.
      int64_t start = static_cast<int64_t>(ar.size());
      for (int64_t i = 0; i < n; ++i) {
        if (static_cast<int64_t>(ar.size()) > start &&
            ar.back() == br[i]) {
          av.back() += bv[i];
        } else {
          ar.push_back(br[i]);
          av.push_back(bv[i]);
        }
      }
      qcount[static_cast<size_t>(q)] =
          static_cast<int64_t>(ar.size()) - start;
    }
  });
  int64_t total = 0;
  out_qptr[0] = 0;
  for (int64_t q = 0; q < nq; ++q) {
    total += qcount[static_cast<size_t>(q)];
    out_qptr[q + 1] = total;
  }
  if (total > cap) return -1;
  parallel_ranges(nq, threads, [&](int64_t lo, int64_t hi, int) {
    for (int64_t q = lo; q < hi; ++q) {
      const WalkScratch& sc = scratch[qthread[static_cast<size_t>(q)]];
      int64_t off = out_qptr[q];
      int64_t src = qoff[static_cast<size_t>(q)];
      int64_t cnt = qcount[static_cast<size_t>(q)];
      std::memcpy(out_rows + off, sc.arena_rows.data() + src,
                  static_cast<size_t>(cnt) * sizeof(int32_t));
      std::memcpy(out_tail + off, sc.arena_vals.data() + src,
                  static_cast<size_t>(cnt) * sizeof(float));
      for (int64_t i = 0; i < cnt; ++i) {
        out_cols[off + i] = static_cast<int32_t>(q);
      }
    }
  });
  return total;
}

// Head scores of flat candidates, computed host-side from the resident head
// matrix: out[m] = sum_j head[rows[m], qh_tids[j]] * (scale) * qh_counts[j]
// over the owning query's head terms. head_kind: 0 = int8 (per-column
// `scales`), 1 = float32, 2 = bfloat16 (raw uint16), 3 = int8 with the
// column scales already folded into qh_counts (the fast path — one fewer
// gather per element; the Python wrapper folds).
//
// The workload is memory-latency bound (each candidate touches ~|q| head
// bytes scattered across a matrix far larger than LLC), so rows a fixed
// distance ahead are software-prefetched.
OSRH_API
void osrh_cand_head_dot(const void* head, int64_t head_kind,
                        const float* scales,
                        int64_t f, const int32_t* rows, const int32_t* cols,
                        int64_t m, const int32_t* qh_tids,
                        const float* qh_counts,
                        const int64_t* qh_ptr, float* out) {
  const int8_t* h8 = static_cast<const int8_t*>(head);
  const float* h32 = static_cast<const float*>(head);
  const uint16_t* h16 = static_cast<const uint16_t*>(head);
  constexpr int64_t kAhead = 16;  // prefetch distance (candidates)
  int threads = n_threads_for(m, 4096);
  parallel_ranges(m, threads, [&](int64_t lo, int64_t hi, int) {
    for (int64_t i = lo; i < hi; ++i) {
      if ((head_kind == 0 || head_kind == 3) && i + kAhead < hi) {
        const int8_t* pbase =
            h8 + static_cast<int64_t>(rows[i + kAhead]) * f;
        int64_t pq = cols[i + kAhead];
        for (int64_t j = qh_ptr[pq]; j < qh_ptr[pq + 1]; ++j) {
          __builtin_prefetch(pbase + qh_tids[j], 0, 0);
        }
      }
      int64_t row = rows[i];
      int64_t q = cols[i];
      float acc = 0.0f;
      if (head_kind == 3) {
        const int8_t* base = h8 + row * f;
        for (int64_t j = qh_ptr[q]; j < qh_ptr[q + 1]; ++j) {
          acc += static_cast<float>(base[qh_tids[j]]) * qh_counts[j];
        }
      } else {
        for (int64_t j = qh_ptr[q]; j < qh_ptr[q + 1]; ++j) {
          int64_t t = qh_tids[j];
          float w;
          if (head_kind == 0) {
            w = static_cast<float>(h8[row * f + t]) * scales[t];
          } else if (head_kind == 1) {
            w = h32[row * f + t];
          } else {
            uint32_t bits = static_cast<uint32_t>(h16[row * f + t]) << 16;
            std::memcpy(&w, &bits, sizeof(w));
          }
          acc += w * qh_counts[j];
        }
      }
      out[i] = acc;
    }
  });
}

// Blocked int8 transpose: dst(F, R) from src(R, F). 64x64 tiles keep both
// sides cache-resident (a naive strided copy is ~10x slower at GB scale).
OSRH_API
void osrh_transpose_i8(const int8_t* src, int64_t r, int64_t f, int8_t* dst) {
  constexpr int64_t T = 64;
  int threads = n_threads_for(r * f, 1 << 22);
  parallel_ranges((r + T - 1) / T, threads, [&](int64_t blo, int64_t bhi,
                                                int) {
    for (int64_t bi = blo; bi < bhi; ++bi) {
      int64_t i0 = bi * T;
      int64_t i1 = std::min<int64_t>(r, i0 + T);
      for (int64_t j0 = 0; j0 < f; j0 += T) {
        int64_t j1 = std::min<int64_t>(f, j0 + T);
        for (int64_t i = i0; i < i1; ++i) {
          const int8_t* s = src + i * f;
          for (int64_t j = j0; j < j1; ++j) {
            dst[j * r + i] = s[j];
          }
        }
      }
    }
  });
}

// Candidate head scores from a TERM-MAJOR (F, R) int8 head copy. Per
// (query, term) the candidate rows are ascending, so the inner loop walks
// one head column forward — hardware-prefetchable streaming instead of the
// row-major variant's random gathers. Column scales must be pre-folded
// into qh_counts (the Python wrapper folds). out must be zeroed.
//
// Pass order (v2): each thread owns a QUERY range (disjoint out slices —
// deterministic under any thread count) and processes its (term, query)
// pairs sorted by term id, so one head column is touched by ALL of the
// thread's queries consecutively while it is cache-hot — at 1M docs,
// B=2048 the query-major order re-faulted every ~1 MB column from DRAM
// per (query, term) pass. Per query the terms still accumulate in
// ascending-id order (qh_tids are sorted and the pass sorts by term),
// so float summation order — and therefore every output bit — is
// unchanged from the query-major order and from the NumPy reference.
OSRH_API
void osrh_cand_head_dot_t(const int8_t* head_t, int64_t r, const int32_t* rows,
                          const int64_t* c_ptr, int64_t nq,
                          const int32_t* qh_tids, const float* qh_counts,
                          const int64_t* qh_ptr, float* out) {
  constexpr int64_t kAhead = 16;  // outstanding-miss depth for sparse rows
  int threads = n_threads_for(c_ptr[nq] + nq, 4096);
  parallel_ranges(nq, threads, [&](int64_t lo, int64_t hi, int) {
    struct Pass {
      int32_t t;
      int32_t q;
      float w;
    };
    std::vector<Pass> passes;
    for (int64_t q = lo; q < hi; ++q) {
      for (int64_t j = qh_ptr[q]; j < qh_ptr[q + 1]; ++j) {
        passes.push_back(
            {qh_tids[j], static_cast<int32_t>(q), qh_counts[j]});
      }
    }
    std::stable_sort(
        passes.begin(), passes.end(),
        [](const Pass& a, const Pass& b) { return a.t < b.t; });
    for (const Pass& p : passes) {
      const int8_t* col = head_t + static_cast<int64_t>(p.t) * r;
      int64_t a = c_ptr[p.q], z = c_ptr[p.q + 1];
      // When candidate rows are sparser than a cache line the walk is
      // latency-bound (one miss per element at corpus scale); issuing
      // prefetches kAhead elements ahead keeps ~16 misses in flight.
      for (int64_t i = a; i < z; ++i) {
        if (i + kAhead < z) __builtin_prefetch(col + rows[i + kAhead], 0, 0);
        out[i] += static_cast<float>(col[rows[i]]) * p.w;
      }
    }
  });
}

// Exact final top-k per query: (device head top-k) UNION (candidate totals),
// masking head entries that are tail-touched (their exact totals are in the
// candidate channel). cand rows are ascending per query.
//
// Candidate prefilter: the final k-th TOTAL is >= tau0 = the k-th head-only
// score (the k head-top docs all have totals >= their head scores >= tau0),
// so candidates with total < tau0 cannot enter the top-k and are skipped
// before the pool sort — at 1M docs this drops most of the ~3,900-wide
// per-query pools. `tau_slack[q]` is a PER-QUERY upper bound on the
// device(bf16)/host(f32) head-score discrepancy, computed by the caller
// from the query's absolute head contributions (head terms can mix signs,
// so under cancellation the rounding band scales with sum(|terms|), not
// with |tau0| — a |tau0|-relative slack is NOT sound; see
// postings.merge_tau_slack). +inf slack disables the prefilter for that
// query (the isfinite guard below), so a masked head-top's candidate can
// never be wrongly dropped.
OSRH_API
void osrh_merge_topk(const float* head_s, const int32_t* head_r, int64_t b,
                     int64_t kh, const int32_t* c_rows, const float* c_tot,
                     const int64_t* c_ptr, int64_t k, const float* tau_slack,
                     float* out_s, int32_t* out_r) {
  int threads = n_threads_for(b, 16);
  parallel_ranges(b, threads, [&](int64_t lo, int64_t hi, int) {
    std::vector<std::pair<float, int32_t>> pool;
    for (int64_t q = lo; q < hi; ++q) {
      pool.clear();
      const int32_t* crow = c_rows + c_ptr[q];
      int64_t nc = c_ptr[q + 1] - c_ptr[q];
      // The bound needs k head-top docs: with kh < k it doesn't hold.
      float tau = -std::numeric_limits<float>::infinity();
      if (kh >= k) {
        float tau0 = head_s[q * kh + k - 1];  // k-th head-only score
        float cand_tau = tau0 - tau_slack[q] - 1e-6f;
        if (std::isfinite(cand_tau)) tau = cand_tau;
      }
      for (int64_t i = 0; i < kh; ++i) {
        int32_t r = head_r[q * kh + i];
        bool touched =
            std::binary_search(crow, crow + nc, r);
        if (!touched) pool.emplace_back(head_s[q * kh + i], r);
      }
      const float* ctot = c_tot + c_ptr[q];
      for (int64_t i = 0; i < nc; ++i) {
        if (ctot[i] >= tau) pool.emplace_back(ctot[i], crow[i]);
      }
      int64_t kk = std::min<int64_t>(k, static_cast<int64_t>(pool.size()));
      std::partial_sort(
          pool.begin(), pool.begin() + kk, pool.end(),
          [](const auto& a, const auto& b2) { return a.first > b2.first; });
      for (int64_t i = 0; i < k; ++i) {
        if (i < kk) {
          out_s[q * k + i] = pool[static_cast<size_t>(i)].first;
          out_r[q * k + i] = pool[static_cast<size_t>(i)].second;
        } else {
          out_s[q * k + i] = -std::numeric_limits<float>::infinity();
          out_r[q * k + i] = 0;
        }
      }
    }
  });
}

// ---------------------------------------------------------------------------
// Fused weight + hybrid-layout pack (see
// osr_tpu_torch/index/layout.py:pack_flat — the NumPy implementation is the
// reference; this is the same computation in two O(nnz) passes with no
// intermediate weight array, no argsort)
// ---------------------------------------------------------------------------

namespace {

// Per-(doc, term) score weight, float32 op-for-op identical to
// builder.compute_weights_flat (NumPy weak-scalar promotion => f32 math;
// scalars pre-reduced in double exactly like `1.0 - b` in Python).
struct WeightFn {
  int method;  // 0 = bm25, 1 = tfidf
  float k1, b, one_minus_b, k1p1, avgdl;
  inline float operator()(float tf, float dl, float idf) const {
    if (method == 1) return idf * tf;
    float norm = k1 * (one_minus_b + b * dl / avgdl);
    float sat = tf * k1p1 / (tf + norm);
    return idf * sat;
  }
};

}  // namespace

}  // extern "C" — the pack core below is a C++ template

// Shared two-pass pack core: pass 1 gathers per-column quantizer stats +
// per-term tail counts; pass 2 quantize-scatters the head and counting-sort
// fills the postings (doc-major input order keeps each term's postings
// sorted by row, matching the NumPy path's stable argsort). The Quantizer
// policy supplies the dtype-specific pieces (stats, scale formula, store).
namespace {

template <typename Quantizer>
int64_t pack_hybrid_impl(const int64_t* indptr, int64_t ndocs,
                         const int32_t* term_ids, const float* tfs,
                         const float* doc_lengths, const float* idf,
                         int64_t f, int64_t v, int method, double k1,
                         double b, double avgdl, float* scales,
                         int64_t* post_ptr, int32_t* post_rows, float* post_w,
                         int64_t tail_cap, Quantizer& qz) {
  WeightFn wf{method,
              static_cast<float>(k1),
              static_cast<float>(b),
              static_cast<float>(1.0 - b),
              static_cast<float>(k1 + 1.0),
              static_cast<float>(avgdl)};
  int64_t n_tail_terms = v - f;
  std::vector<int64_t> tail_counts(
      static_cast<size_t>(n_tail_terms > 0 ? n_tail_terms : 0), 0);

  for (int64_t d = 0; d < ndocs; ++d) {
    float dl = doc_lengths[d];
    for (int64_t j = indptr[d]; j < indptr[d + 1]; ++j) {
      int64_t t = term_ids[j];
      if (t < f) {
        qz.observe(t, wf(tfs[j], dl, idf[t]));
      } else {
        ++tail_counts[static_cast<size_t>(t - f)];
      }
    }
  }
  for (int64_t t = 0; t < f; ++t) scales[t] = qz.scale(t);
  post_ptr[0] = 0;
  for (int64_t t = 0; t < n_tail_terms; ++t) {
    post_ptr[t + 1] = post_ptr[t] + tail_counts[static_cast<size_t>(t)];
  }
  if (n_tail_terms > 0 && post_ptr[n_tail_terms] > tail_cap) return -1;

  std::vector<int64_t> cursor(tail_counts.size());
  if (n_tail_terms > 0)
    std::memcpy(cursor.data(), post_ptr, tail_counts.size() * sizeof(int64_t));
  for (int64_t d = 0; d < ndocs; ++d) {
    float dl = doc_lengths[d];
    for (int64_t j = indptr[d]; j < indptr[d + 1]; ++j) {
      int64_t t = term_ids[j];
      float w = wf(tfs[j], dl, idf[t]);
      if (t < f) {
        qz.store(d, t, w, scales[t]);
      } else {
        int64_t pos = cursor[static_cast<size_t>(t - f)]++;
        post_rows[pos] = static_cast<int32_t>(d);
        post_w[pos] = w;
      }
    }
  }
  return n_tail_terms > 0 ? post_ptr[n_tail_terms] : 0;
}

// int8: symmetric per-column absmax / 127, signed values.
struct Int8Quantizer {
  int8_t* head;
  int64_t f;
  std::vector<float> colmax;
  Int8Quantizer(int8_t* h, int64_t rows, int64_t f_)
      : head(h), f(f_), colmax(static_cast<size_t>(f_), 0.0f) {
    std::memset(head, 0, static_cast<size_t>(rows) * static_cast<size_t>(f_));
  }
  inline void observe(int64_t t, float w) {
    float a = std::fabs(w);
    if (a > colmax[static_cast<size_t>(t)]) colmax[static_cast<size_t>(t)] = a;
  }
  inline float scale(int64_t t) const {
    float m = colmax[static_cast<size_t>(t)];
    return m > 0.0f ? m / 127.0f : 1.0f;
  }
  inline void store(int64_t d, int64_t t, float w, float s) {
    float q = std::nearbyintf(w / s);  // rint: half-to-even
    if (q > 127.0f) q = 127.0f;
    if (q < -127.0f) q = -127.0f;
    head[d * f + t] = static_cast<int8_t>(q);
  }
};

// int4: UNSIGNED [0, 15] codes against per-column SIGNED scales, two per
// byte, block-packed (low nibbles = columns [0, F/2), high = [F/2, F);
// see osr_tpu_torch/index/layout.py:unpack_int4).
struct Int4Quantizer {
  uint8_t* head;
  int64_t fp;
  std::vector<float> colmax, colmin;
  Int4Quantizer(uint8_t* h, int64_t rows, int64_t f_)
      : head(h),
        fp((f_ + 1) / 2),
        colmax(static_cast<size_t>(f_), 0.0f),
        colmin(static_cast<size_t>(f_), 0.0f) {
    std::memset(head, 0, static_cast<size_t>(rows) * static_cast<size_t>(fp));
  }
  inline void observe(int64_t t, float w) {
    if (w > colmax[static_cast<size_t>(t)]) colmax[static_cast<size_t>(t)] = w;
    if (w < colmin[static_cast<size_t>(t)]) colmin[static_cast<size_t>(t)] = w;
  }
  inline float scale(int64_t t) const {
    float mx = colmax[static_cast<size_t>(t)];
    float mn = colmin[static_cast<size_t>(t)];
    return mx > 0.0f ? mx / 15.0f : (mn < 0.0f ? mn / 15.0f : 1.0f);
  }
  inline void store(int64_t d, int64_t t, float w, float s) {
    float q = std::nearbyintf(w / s);  // rint: half-to-even
    if (q > 15.0f) q = 15.0f;
    if (q < 0.0f) q = 0.0f;
    uint8_t code = static_cast<uint8_t>(q);
    uint8_t* byte = head + d * fp + (t < fp ? t : t - fp);
    *byte = t < fp ? static_cast<uint8_t>((*byte & 0xF0) | code)
                   : static_cast<uint8_t>((*byte & 0x0F) | (code << 4));
  }
};

}  // namespace

extern "C" {

// Packs the flat doc-major term matrix into the quantized-head + postings-
// tail layout. Returns tail_nnz (must equal the caller-computed capacity),
// or -1 if the tail overflows `tail_cap`. `head` is fully written (zeros
// included); `post_ptr` is (v - f + 1). Bit-identical to the NumPy
// pack_flat paths (tests/test_torch_native.py, tests/test_torch_index.py).
OSRH_API
int64_t osrh_pack_hybrid_int8(
    const int64_t* indptr, int64_t ndocs, int64_t rows,
    const int32_t* term_ids, const float* tfs, const float* doc_lengths,
    const float* idf, int64_t f, int64_t v, int method, double k1, double b,
    double avgdl, int8_t* head, float* scales, int64_t* post_ptr,
    int32_t* post_rows, float* post_w, int64_t tail_cap) {
  Int8Quantizer qz(head, rows, f);
  return pack_hybrid_impl(indptr, ndocs, term_ids, tfs, doc_lengths, idf, f,
                          v, method, k1, b, avgdl, scales, post_ptr,
                          post_rows, post_w, tail_cap, qz);
}

OSRH_API
int64_t osrh_pack_hybrid_int4(
    const int64_t* indptr, int64_t ndocs, int64_t rows,
    const int32_t* term_ids, const float* tfs, const float* doc_lengths,
    const float* idf, int64_t f, int64_t v, int method, double k1, double b,
    double avgdl, uint8_t* head, float* scales, int64_t* post_ptr,
    int32_t* post_rows, float* post_w, int64_t tail_cap) {
  Int4Quantizer qz(head, rows, f);
  return pack_hybrid_impl(indptr, ndocs, term_ids, tfs, doc_lengths, idf, f,
                          v, method, k1, b, avgdl, scales, post_ptr,
                          post_rows, post_w, tail_cap, qz);
}

// ---------------------------------------------------------------------------
// Feature-hashing text encoder (native fast path of
// osr_tpu_torch/encoders.py:HashingEncoder; bindings in
// osr_tpu_torch/native.py)
// ---------------------------------------------------------------------------

OSRH_API
void* osrh_henc_create(int64_t dim, int64_t ngrams, int use_idf) {
  if (dim <= 0 || ngrams < 1) return nullptr;
  auto* st = new HashEncState();
  st->dim = dim;
  st->ngrams = ngrams;
  st->use_idf = use_idf != 0;
  return st;
}

OSRH_API
void osrh_henc_free(void* h) { delete static_cast<HashEncState*>(h); }

// blake2b-64 of one buffer — exposed so tests can prove hash identity
// with hashlib.blake2b(digest_size=8).
OSRH_API
uint64_t osrh_henc_hash(const char* data, int64_t len) {
  return blake2b::hash64(reinterpret_cast<const uint8_t*>(data),
                         static_cast<size_t>(len));
}

OSRH_API
int64_t osrh_henc_df_size(void* h) {
  return static_cast<int64_t>(static_cast<HashEncState*>(h)->df.size());
}

// Smooth IDF of one feature hash under the fitted state (1.0 when the
// encoder was created with use_idf=0) — mirrors HashingEncoder._idf.
OSRH_API
double osrh_henc_idf(void* h, uint64_t feat_hash) {
  return henc_idf_value(*static_cast<HashEncState*>(h), feat_hash);
}

// (Re)fit document frequencies over a corpus of '\0'-joined token
// buffers. Replaces any previous fit (same semantics as Python fit()).
// Single-threaded: one pass over the corpus counting set-of-features per
// doc; encode() is where the per-query hot path lives.
OSRH_API
void osrh_henc_fit(void* h, const char* const* docs, const int64_t* lens,
                   int64_t n_docs) {
  auto* st = static_cast<HashEncState*>(h);
  st->df.clear();
  HashEncScratch sc;
  for (int64_t i = 0; i < n_docs; ++i) {
    count_features(*st, docs[i], lens[i], &sc);
    for (const auto& hc : sc.uniq) st->df[hc.first] += 1;
  }
  st->n_docs = n_docs;
}

// Export the fitted document-frequency table (keys/vals must have
// henc_df_size() capacity). Order is unspecified — consumers sort.
OSRH_API
void osrh_henc_export_df(void* h, uint64_t* keys, int32_t* vals) {
  auto* st = static_cast<HashEncState*>(h);
  int64_t i = 0;
  for (const auto& kv : st->df) {
    keys[i] = kv.first;
    vals[i] = kv.second;
    ++i;
  }
}

// Replace the fitted state with an externally saved df table (the
// load half of HashingEncoder.save/load — keeps query vectors
// consistent with doc embeddings encoded in another process).
OSRH_API
void osrh_henc_import_df(void* h, const uint64_t* keys, const int32_t* vals,
                         int64_t n, int64_t n_docs) {
  auto* st = static_cast<HashEncState*>(h);
  st->df.clear();
  st->df.reserve(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) st->df[keys[i]] = vals[i];
  st->n_docs = n_docs;
}

// Encode a batch of '\0'-joined token documents into out (n_docs, dim)
// float32 (pre-zeroed by the caller). Rows are UNNORMALIZED — the Python
// wrapper applies the same per-row np.linalg.norm it always did, keeping
// normalization numerics byte-identical to the pure-Python path.
// Threaded over documents: rows are disjoint and df is read-only, so
// results are bit-identical across thread counts.
OSRH_API
void osrh_henc_encode(void* h, const char* const* docs, const int64_t* lens,
                      int64_t n_docs, float* out) {
  auto* st = static_cast<HashEncState*>(h);
  int threads = n_threads_for(n_docs, 256);
  parallel_ranges(n_docs, threads, [&](int64_t lo, int64_t hi, int) {
    HashEncScratch sc;
    for (int64_t i = lo; i < hi; ++i) {
      count_features(*st, docs[i], lens[i], &sc);
      float* row = out + i * st->dim;
      for (const auto& hc : sc.uniq) {
        uint64_t fh = hc.first;
        int64_t col =
            static_cast<int64_t>((fh >> 1) % static_cast<uint64_t>(st->dim));
        double sign = (fh & 1) ? 1.0 : -1.0;
        double signed_idf = sign * henc_idf_value(*st, fh);
        double tf = 1.0 + std::log(static_cast<double>(hc.second));
        // f64 accumulate, f32 store: exactly np.add.at(f32_row, col, f64)
        row[col] = static_cast<float>(static_cast<double>(row[col]) +
                                      signed_idf * tf);
      }
    }
  });
}

}  // extern "C"
