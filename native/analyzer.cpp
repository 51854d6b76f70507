// Native host analyzer: tokenize + FNV-1a64 hash, batch API.
//
// Implements exactly the AnalyzerConfig-default contract of
// document_search_engine_tpu/analyze (tokenizer.py / hashing.py):
// lowercase, tokens = maximal runs of [0-9a-z] after ASCII lowering,
// length-filtered, 64-bit FNV-1a over the token bytes. Only ASCII input
// is handled here — the Python wrapper routes non-ASCII docs to the
// reference Python path, so results are bit-identical overall (tested in
// tests/test_native_analyzer.py).
//
// Build: make -C native   (g++ -O3 -shared; zero dependencies)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstddef>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t kFnvOffset = 14695981039346656037ULL;
constexpr uint64_t kFnvPrime = 1099511628211ULL;

inline bool is_alnum_lower(unsigned char c, unsigned char &lowered) {
  if (c >= '0' && c <= '9') { lowered = c; return true; }
  if (c >= 'a' && c <= 'z') { lowered = c; return true; }
  if (c >= 'A' && c <= 'Z') { lowered = static_cast<unsigned char>(c + 32); return true; }
  return false;
}

// Worker-thread count for the batch entry points: DSE_NATIVE_THREADS
// env override, else std::thread::hardware_concurrency(), capped at 16.
// 1 disables threading (serving hosts have dozens of cores and the
// analysis phases are embarrassingly parallel
// over docs/queries). ctypes releases the GIL around these calls, so
// the workers run truly concurrent with the Python caller.
int native_threads() {
  const char *env = std::getenv("DSE_NATIVE_THREADS");
  if (env && *env) {
    int v = std::atoi(env);
    if (v >= 1) return v > 16 ? 16 : v;
  }
  unsigned hc = std::thread::hardware_concurrency();
  if (hc == 0) hc = 1;
  return hc > 16 ? 16 : static_cast<int>(hc);
}

}  // namespace

extern "C" {

// Pass 1: count tokens per doc (fills dl[n_docs]); returns total tokens.
// buf: concatenated UTF-8/ASCII text; offs: n_docs+1 byte offsets.
int64_t dse_count_tokens(const char *buf, const int64_t *offs,
                         int32_t n_docs, int32_t min_len, int32_t max_len,
                         int64_t *dl) {
  int64_t total = 0;
  for (int32_t d = 0; d < n_docs; ++d) {
    const char *p = buf + offs[d];
    const char *end = buf + offs[d + 1];
    int64_t count = 0;
    int64_t run = 0;
    unsigned char lowered;
    for (; p < end; ++p) {
      if (is_alnum_lower(static_cast<unsigned char>(*p), lowered)) {
        ++run;
      } else if (run) {
        if (run >= min_len && run <= max_len) ++count;
        run = 0;
      }
    }
    if (run && run >= min_len && run <= max_len) ++count;
    dl[d] = count;
    total += count;
  }
  return total;
}

// Pass 2: emit (hash, doc) per token, in document order.
// out_hash/out_doc must hold the total from pass 1.
void dse_hash_tokens(const char *buf, const int64_t *offs, int32_t n_docs,
                     int32_t min_len, int32_t max_len, uint64_t *out_hash,
                     int32_t *out_doc) {
  int64_t w = 0;
  for (int32_t d = 0; d < n_docs; ++d) {
    const char *p = buf + offs[d];
    const char *end = buf + offs[d + 1];
    uint64_t h = kFnvOffset;
    int64_t run = 0;
    unsigned char lowered;
    for (; p < end; ++p) {
      if (is_alnum_lower(static_cast<unsigned char>(*p), lowered)) {
        h = (h ^ lowered) * kFnvPrime;
        ++run;
      } else if (run) {
        if (run >= min_len && run <= max_len) {
          out_hash[w] = h;
          out_doc[w] = d;
          ++w;
        }
        h = kFnvOffset;
        run = 0;
      }
    }
    if (run && run >= min_len && run <= max_len) {
      out_hash[w] = h;
      out_doc[w] = d;
      ++w;
    }
  }
}

// Pass 2 (preferred): per doc, emit hash-ascending unique (hash, tf) runs
// — exactly the AnalyzedDocs layout (builder.analyze_texts). out_hash /
// out_tf must hold >= total tokens (pass 1's return); n_terms[d] receives
// the doc's unique-term count. Returns total unique terms written.
int64_t dse_analyze_docs(const char *buf, const int64_t *offs,
                         int32_t n_docs, int32_t min_len, int32_t max_len,
                         uint64_t *out_hash, int32_t *out_tf,
                         int64_t *n_terms, int64_t *dl) {
  std::vector<uint64_t> scratch;
  int64_t w = 0;
  for (int32_t d = 0; d < n_docs; ++d) {
    const char *p = buf + offs[d];
    const char *end = buf + offs[d + 1];
    scratch.clear();
    uint64_t h = kFnvOffset;
    int64_t run = 0;
    unsigned char lowered;
    for (; p < end; ++p) {
      if (is_alnum_lower(static_cast<unsigned char>(*p), lowered)) {
        h = (h ^ lowered) * kFnvPrime;
        ++run;
      } else if (run) {
        if (run >= min_len && run <= max_len) scratch.push_back(h);
        h = kFnvOffset;
        run = 0;
      }
    }
    if (run && run >= min_len && run <= max_len) scratch.push_back(h);
    dl[d] = static_cast<int64_t>(scratch.size());
    std::sort(scratch.begin(), scratch.end());
    int64_t uniq = 0;
    size_t i = 0;
    while (i < scratch.size()) {
      size_t j = i + 1;
      while (j < scratch.size() && scratch[j] == scratch[i]) ++j;
      out_hash[w] = scratch[i];
      out_tf[w] = static_cast<int32_t>(j - i);
      ++w;
      ++uniq;
      i = j;
    }
    n_terms[d] = uniq;
  }
  return w;
}

// dse_analyze_docs parallelized over doc ranges. tok_ptr is the
// cumulative per-doc TOKEN count (from dse_count_tokens) — each range's
// packed (hash, tf) runs are emitted at its token-offset (an upper
// bound on its unique count, so ranges never collide), then compacted
// left with T-1 memmoves. Identical output to dse_analyze_docs
// (tested); ranges are balanced by token count, not doc count.
int64_t dse_analyze_docs_mt(const char *buf, const int64_t *offs,
                            int32_t n_docs, int32_t min_len,
                            int32_t max_len, const int64_t *tok_ptr,
                            uint64_t *out_hash, int32_t *out_tf,
                            int64_t *n_terms, int64_t *dl) {
  const int want = native_threads();
  if (want <= 1 || n_docs < 256) {
    return dse_analyze_docs(buf, offs, n_docs, min_len, max_len,
                            out_hash, out_tf, n_terms, dl);
  }
  const int64_t total_tok = tok_ptr[n_docs];
  const int t_n = want;
  std::vector<int32_t> d0(t_n + 1);
  for (int t = 0; t <= t_n; ++t) {
    // balance by tokens: first doc whose cumulative tokens reach the
    // t-th share (lower_bound over tok_ptr)
    const int64_t target = total_tok * t / t_n;
    d0[t] = static_cast<int32_t>(
        std::lower_bound(tok_ptr, tok_ptr + n_docs + 1, target) - tok_ptr
    );
  }
  d0[0] = 0;
  d0[t_n] = n_docs;
  std::vector<int64_t> uniq(t_n, 0);
  auto work = [&](int t) {
    std::vector<uint64_t> scratch;
    int64_t w = tok_ptr[d0[t]];
    const int64_t w_base = w;
    for (int32_t d = d0[t]; d < d0[t + 1]; ++d) {
      const char *p = buf + offs[d];
      const char *end = buf + offs[d + 1];
      scratch.clear();
      uint64_t h = kFnvOffset;
      int64_t run = 0;
      unsigned char lowered;
      for (; p < end; ++p) {
        if (is_alnum_lower(static_cast<unsigned char>(*p), lowered)) {
          h = (h ^ lowered) * kFnvPrime;
          ++run;
        } else if (run) {
          if (run >= min_len && run <= max_len) scratch.push_back(h);
          h = kFnvOffset;
          run = 0;
        }
      }
      if (run && run >= min_len && run <= max_len) scratch.push_back(h);
      dl[d] = static_cast<int64_t>(scratch.size());
      std::sort(scratch.begin(), scratch.end());
      int64_t u = 0;
      size_t i = 0;
      while (i < scratch.size()) {
        size_t j = i + 1;
        while (j < scratch.size() && scratch[j] == scratch[i]) ++j;
        out_hash[w] = scratch[i];
        out_tf[w] = static_cast<int32_t>(j - i);
        ++w;
        ++u;
        i = j;
      }
      n_terms[d] = u;
    }
    uniq[t] = w - w_base;
  };
  std::vector<std::thread> threads;
  threads.reserve(t_n - 1);
  for (int t = 1; t < t_n; ++t) threads.emplace_back(work, t);
  work(0);
  for (auto &th : threads) th.join();
  // compact ranges left (dest <= src always: unique <= tokens)
  int64_t w = uniq[0];
  for (int t = 1; t < t_n; ++t) {
    const int64_t src = tok_ptr[d0[t]];
    if (src != w && uniq[t]) {
      std::memmove(out_hash + w, out_hash + src,
                   sizeof(uint64_t) * uniq[t]);
      std::memmove(out_tf + w, out_tf + src, sizeof(int32_t) * uniq[t]);
    }
    w += uniq[t];
  }
  return w;
}

// np.searchsorted(vocab, needles, side="left"), accelerated by a
// prefix table: prefix_start[p] = first vocab index whose top
// `prefix_bits` hash bits are >= p (built once per stats refresh with
// one numpy searchsorted over the 2^prefix_bits boundaries, plus the
// terminating n_vocab entry). FNV hashes are uniform, so each prefix
// bucket holds ~n_vocab / 2^prefix_bits entries and the binary search
// collapses to a couple of probes — ~10x over numpy's full-range
// search on the query-serving hot path.
void dse_lookup_sorted(const uint64_t *vocab, int64_t n_vocab,
                       const int64_t *prefix_start, int32_t prefix_bits,
                       const uint64_t *needles, int64_t n,
                       int64_t *out_idx) {
  (void)n_vocab;
  const int shift = 64 - prefix_bits;
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t x = needles[i];
    const uint64_t p = x >> shift;
    int64_t lo = prefix_start[p];
    int64_t hi = prefix_start[p + 1];
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (vocab[mid] < x) lo = mid + 1; else hi = mid;
    }
    out_idx[i] = lo;
  }
}

// Serving-frontend slot assembly: one pass over the per-query
// (hash, tf) spans of an AnalyzedDocs batch doing the vocab lookup
// (same prefix-table binary search as dse_lookup_sorted), the idf
// gather, and the query-side f32 coefficients of oracle/spec.py.
// The idf values themselves come from a numpy-precomputed per-row
// table (np.log's float32 SIMD need not match libm logf bit-for-bit,
// so the transcendental never runs here); everything in this function
// is IEEE single-precision mul/div/sqrt in spec.py's operation order,
// with contraction disabled via -ffp-contract=off (Makefile) so
// acc + w*w cannot become fmaf. Queries with more unique terms than
// `s` slots are flagged in overflow[] and left untouched for the
// caller's per-query slot-selection path; out arrays arrive zeroed.
// kind: 0 = bm25 (a = f32(tf) * idf), 1 = tfidf
// (qw = f32(tf)*idf; qnorm = sqrt(seq sum qw^2); a = (qw/qnorm)*idf).
void dse_query_slots(const uint64_t *hashes, const int32_t *tfs,
                     const int64_t *doc_ptr, int64_t nq,
                     const uint64_t *vocab, int64_t n_vocab,
                     const int64_t *prefix_start, int32_t prefix_bits,
                     const float *idf_by_row, int32_t s, int32_t kind,
                     uint64_t *out_h, float *out_a, int32_t *out_r,
                     uint8_t *out_f, uint8_t *overflow) {
  const int shift = 64 - prefix_bits;
  std::vector<float> qw(static_cast<size_t>(s));
  std::vector<float> idfs(static_cast<size_t>(s));
  for (int64_t q = 0; q < nq; ++q) {
    const int64_t b = doc_ptr[q];
    const int64_t len = doc_ptr[q + 1] - b;
    if (len > s) {
      overflow[q] = 1;
      continue;
    }
    uint64_t *oh = out_h + q * s;
    float *oa = out_a + q * s;
    int32_t *orow = out_r + q * s;
    uint8_t *of = out_f + q * s;
    for (int64_t i = 0; i < len; ++i) {
      const uint64_t x = hashes[b + i];
      const uint64_t p = x >> shift;
      int64_t lo = prefix_start[p];
      int64_t hi = prefix_start[p + 1];
      while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (vocab[mid] < x) lo = mid + 1; else hi = mid;
      }
      const bool found = lo < n_vocab && vocab[lo] == x;
      const float idf = found ? idf_by_row[lo] : 0.0f;
      oh[i] = x;
      orow[i] = found ? static_cast<int32_t>(lo) : 0;
      of[i] = found ? 1 : 0;
      const float tf_f = static_cast<float>(tfs[b + i]);
      if (kind == 0) {
        const float a = tf_f * idf;
        oa[i] = (idf == 0.0f) ? 0.0f : a;
      } else {
        qw[i] = tf_f * idf;
        idfs[i] = idf;
      }
    }
    if (kind != 0 && len > 0) {
      float acc = 0.0f;
      for (int64_t i = 0; i < len; ++i) {
        const float w = qw[i];
        acc = acc + w * w;
      }
      const float qnorm = std::sqrt(acc);
      for (int64_t i = 0; i < len; ++i) {
        float a =
            (qnorm == 0.0f) ? 0.0f : (qw[i] / qnorm) * idfs[i];
        oa[i] = (idfs[i] == 0.0f) ? 0.0f : a;
      }
    }
  }
}

// ---------------------------------------------------------------------
// Flat open-addressing vocab table: one 16-byte entry holds the term
// hash, its vocab row, and its (numpy-precomputed) f32 idf, so the
// serving frontend's lookup+gather is ONE expected cache miss per
// token instead of the prefix-table path's ~3 dependent ones
// (prefix_start line, 1-2 vocab probes, idf_by_row line) — the lookup
// is memory-latency-bound at production vocab sizes. Linear probing at
// load factor <= 0.5; slot index from a multiplicative mix of the FNV
// hash (FNV-1a's high bits avalanche weakly); row == -1 marks empty.
// Built once per stats refresh (GlobalStats.hash_table).

struct VocabEntry {
  uint64_t key;
  int32_t row;
  float idf;
};
static_assert(sizeof(VocabEntry) == 16, "VocabEntry must be 16 bytes");

namespace {

constexpr uint64_t kMix = 0x9E3779B97F4A7C15ULL;

inline uint64_t slot_of(uint64_t x, int log2n) {
  return (x * kMix) >> (64 - log2n);
}

}  // namespace

extern "C" void dse_hash_build(const uint64_t *vocab, int64_t n_vocab,
                               const float *idf_by_row, int32_t log2n,
                               VocabEntry *table) {
  const int64_t n = int64_t{1} << log2n;
  const uint64_t mask = static_cast<uint64_t>(n - 1);
  for (int64_t i = 0; i < n; ++i) table[i].row = -1;
  for (int64_t r = 0; r < n_vocab; ++r) {
    const uint64_t x = vocab[r];
    uint64_t i = slot_of(x, log2n);
    while (table[i].row != -1) i = (i + 1) & mask;
    table[i].key = x;
    table[i].row = static_cast<int32_t>(r);
    table[i].idf = idf_by_row[r];
  }
}

// dse_query_slots with the flat hash-table lookup (dse_hash_build)
// instead of the prefix-table binary search — the two-call path's twin
// of dse_analyze_queries_hash (mixed/non-ASCII batches analyze first,
// then assemble slots here). Identical output bits.
void dse_query_slots_hash(const uint64_t *hashes, const int32_t *tfs,
                          const int64_t *doc_ptr, int64_t nq,
                          const VocabEntry *table, int32_t log2n,
                          int32_t s, int32_t kind, uint64_t *out_h,
                          float *out_a, int32_t *out_r, uint8_t *out_f,
                          uint8_t *overflow) {
  const uint64_t mask = (uint64_t{1} << log2n) - 1;
  std::vector<float> qw(static_cast<size_t>(s));
  std::vector<float> idfs(static_cast<size_t>(s));
  for (int64_t q = 0; q < nq; ++q) {
    const int64_t b = doc_ptr[q];
    const int64_t len = doc_ptr[q + 1] - b;
    if (len > s) {
      overflow[q] = 1;
      continue;
    }
    for (int64_t i = 0; i < len; ++i)
      __builtin_prefetch(&table[slot_of(hashes[b + i], log2n)], 0, 1);
    uint64_t *oh = out_h + q * s;
    float *oa = out_a + q * s;
    int32_t *orow = out_r + q * s;
    uint8_t *of = out_f + q * s;
    for (int64_t i = 0; i < len; ++i) {
      const uint64_t x = hashes[b + i];
      uint64_t ix = slot_of(x, log2n);
      int32_t row = -1;
      float idf = 0.0f;
      while (table[ix].row != -1) {
        if (table[ix].key == x) {
          row = table[ix].row;
          idf = table[ix].idf;
          break;
        }
        ix = (ix + 1) & mask;
      }
      const bool found = row >= 0;
      oh[i] = x;
      orow[i] = found ? row : 0;
      of[i] = found ? 1 : 0;
      const float tf_f = static_cast<float>(tfs[b + i]);
      if (kind == 0) {
        const float a = tf_f * idf;
        oa[i] = (idf == 0.0f) ? 0.0f : a;
      } else {
        qw[i] = tf_f * idf;
        idfs[i] = idf;
      }
    }
    if (kind != 0 && len > 0) {
      float acc = 0.0f;
      for (int64_t i = 0; i < len; ++i) {
        const float w = qw[i];
        acc = acc + w * w;
      }
      const float qnorm = std::sqrt(acc);
      for (int64_t i = 0; i < len; ++i) {
        float a = (qnorm == 0.0f) ? 0.0f : (qw[i] / qnorm) * idfs[i];
        oa[i] = (idfs[i] == 0.0f) ? 0.0f : a;
      }
    }
  }
}

// Fully-fused serving frontend: raw ASCII query text -> slot arrays in
// ONE pass (tokenize + FNV-1a64 + per-query sort/uniq + prefix-table
// vocab lookup + idf gather + f32 query coefficients). Combines
// dse_analyze_docs and dse_query_slots without materializing the
// intermediate (hash, tf, doc_ptr) batch arrays or running the
// separate token-count pass. Same float contract as dse_query_slots
// (numpy-precomputed idf table; spec.py operation order; contraction
// off). Slot-overflow queries (> s unique terms) are flagged and left
// zeroed for the caller's per-query slot-selection path.
void dse_analyze_queries(const char *buf, const int64_t *offs, int64_t nq,
                         int32_t min_len, int32_t max_len,
                         const uint64_t *vocab, int64_t n_vocab,
                         const int64_t *prefix_start, int32_t prefix_bits,
                         const float *idf_by_row, int32_t s, int32_t kind,
                         uint64_t *out_h, float *out_a, int32_t *out_r,
                         uint8_t *out_f, uint8_t *overflow) {
  const int shift = 64 - prefix_bits;
  std::vector<uint64_t> scratch;
  std::vector<float> qw(static_cast<size_t>(s));
  std::vector<float> idfs(static_cast<size_t>(s));
  for (int64_t q = 0; q < nq; ++q) {
    const char *p = buf + offs[q];
    const char *end = buf + offs[q + 1];
    scratch.clear();
    uint64_t h = kFnvOffset;
    int64_t run = 0;
    unsigned char lowered;
    for (; p < end; ++p) {
      if (is_alnum_lower(static_cast<unsigned char>(*p), lowered)) {
        h = (h ^ lowered) * kFnvPrime;
        ++run;
      } else if (run) {
        if (run >= min_len && run <= max_len) scratch.push_back(h);
        h = kFnvOffset;
        run = 0;
      }
    }
    if (run && run >= min_len && run <= max_len) scratch.push_back(h);
    if (scratch.empty()) continue;
    std::sort(scratch.begin(), scratch.end());
    // unique-count gate before any writes (overflow rows stay zeroed)
    int64_t uniq = 1;
    for (size_t i = 1; i < scratch.size(); ++i)
      uniq += scratch[i] != scratch[i - 1];
    if (uniq > s) {
      overflow[q] = 1;
      continue;
    }
    uint64_t *oh = out_h + q * s;
    float *oa = out_a + q * s;
    int32_t *orow = out_r + q * s;
    uint8_t *of = out_f + q * s;
    int64_t w = 0;
    size_t i = 0;
    while (i < scratch.size()) {
      const uint64_t x = scratch[i];
      size_t j = i + 1;
      while (j < scratch.size() && scratch[j] == x) ++j;
      const uint64_t pb = x >> shift;
      int64_t lo = prefix_start[pb];
      int64_t hi = prefix_start[pb + 1];
      while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (vocab[mid] < x) lo = mid + 1; else hi = mid;
      }
      const bool found = lo < n_vocab && vocab[lo] == x;
      const float idf = found ? idf_by_row[lo] : 0.0f;
      oh[w] = x;
      orow[w] = found ? static_cast<int32_t>(lo) : 0;
      of[w] = found ? 1 : 0;
      const float tf_f = static_cast<float>(j - i);
      if (kind == 0) {
        const float a = tf_f * idf;
        oa[w] = (idf == 0.0f) ? 0.0f : a;
      } else {
        qw[w] = tf_f * idf;
        idfs[w] = idf;
      }
      ++w;
      i = j;
    }
    if (kind != 0 && w > 0) {
      float acc = 0.0f;
      for (int64_t t = 0; t < w; ++t) {
        const float v = qw[t];
        acc = acc + v * v;
      }
      const float qnorm = std::sqrt(acc);
      for (int64_t t = 0; t < w; ++t) {
        float a = (qnorm == 0.0f) ? 0.0f : (qw[t] / qnorm) * idfs[t];
        oa[t] = (idfs[t] == 0.0f) ? 0.0f : a;
      }
    }
  }
}

// Hash-set unique for the index-build path: insert every value into
// `table` (entries reused as {key, row=1} presence markers), emitting
// first occurrences to out_uniq unsorted. Returns the unique count, or
// -1 if it would exceed half the table capacity (caller retries with a
// bigger log2n). Replaces np.unique's O(n log n) argsort over the
// segment's postings hashes with one O(n) pass (~1 expected cache miss
// per value) — the vocab itself (the unique keys) is tiny and sorts in
// microseconds host-side afterwards.
int64_t dse_hash_unique(const uint64_t *vals, int64_t n, int32_t log2n,
                        VocabEntry *table, uint64_t *out_uniq) {
  const int64_t cap = int64_t{1} << log2n;
  const uint64_t mask = static_cast<uint64_t>(cap - 1);
  const int64_t limit = cap >> 1;
  for (int64_t i = 0; i < cap; ++i) table[i].row = -1;
  int64_t cnt = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t x = vals[i];
    uint64_t ix = slot_of(x, log2n);
    while (true) {
      if (table[ix].row == -1) {
        if (cnt >= limit) return -1;
        table[ix].key = x;
        table[ix].row = 1;
        out_uniq[cnt++] = x;
        break;
      }
      if (table[ix].key == x) break;
      ix = (ix + 1) & mask;
    }
  }
  return cnt;
}

// Bulk row lookup against a dse_hash_build table: out_rows[i] = vocab
// row of needles[i], or -1 if absent. A software-pipelined prefetch
// window keeps ~8 probes in flight (the probe stream is
// memory-latency-bound). If out_df is non-null it accumulates
// occurrence counts per row in the same pass (numpy's bincount pays an
// int32->intp copy of the whole rows array otherwise).
void dse_hash_lookup(const VocabEntry *table, int32_t log2n,
                     const uint64_t *needles, int64_t n,
                     int32_t *out_rows, int32_t *out_df) {
  const uint64_t mask = (uint64_t{1} << log2n) - 1;
  constexpr int64_t W = 8;
  for (int64_t i = 0; i < n && i < W; ++i)
    __builtin_prefetch(&table[slot_of(needles[i], log2n)], 0, 1);
  for (int64_t i = 0; i < n; ++i) {
    if (i + W < n)
      __builtin_prefetch(&table[slot_of(needles[i + W], log2n)], 0, 1);
    const uint64_t x = needles[i];
    uint64_t ix = slot_of(x, log2n);
    int32_t row = -1;
    while (table[ix].row != -1) {
      if (table[ix].key == x) {
        row = table[ix].row;
        break;
      }
      ix = (ix + 1) & mask;
    }
    out_rows[i] = row;
    if (out_df && row >= 0) ++out_df[row];
  }
}

// dse_analyze_queries with the flat hash-table lookup (dse_hash_build)
// instead of the prefix-table binary search. Identical output bits:
// same tokenizer, same sort/uniq slot order, idf gathered from the
// same numpy-precomputed values (stored in the table), same f32
// operation order (contraction off). A first pass over each query's
// unique terms computes + prefetches every term's table line, so the
// per-token misses overlap instead of serializing.
void dse_analyze_queries_hash(const char *buf, const int64_t *offs,
                              int64_t nq, int32_t min_len, int32_t max_len,
                              const VocabEntry *table, int32_t log2n,
                              int32_t s,
                              int32_t kind, uint64_t *out_h, float *out_a,
                              int32_t *out_r, uint8_t *out_f,
                              uint8_t *overflow) {
  const uint64_t mask = (uint64_t{1} << log2n) - 1;
  // embarrassingly parallel over queries (disjoint output rows); the
  // serial path below is the t_n == 1 case of the same worker
  const int t_n =
      nq >= 512 ? native_threads() : 1;
  auto work = [&](int64_t q_lo, int64_t q_hi) {
  std::vector<uint64_t> scratch;
  std::vector<uint64_t> keys(static_cast<size_t>(s));
  std::vector<int32_t> tfs(static_cast<size_t>(s));
  std::vector<uint64_t> idx(static_cast<size_t>(s));
  std::vector<float> qw(static_cast<size_t>(s));
  std::vector<float> idfs(static_cast<size_t>(s));
  for (int64_t q = q_lo; q < q_hi; ++q) {
    const char *p = buf + offs[q];
    const char *end = buf + offs[q + 1];
    scratch.clear();
    uint64_t h = kFnvOffset;
    int64_t run = 0;
    unsigned char lowered;
    for (; p < end; ++p) {
      if (is_alnum_lower(static_cast<unsigned char>(*p), lowered)) {
        h = (h ^ lowered) * kFnvPrime;
        ++run;
      } else if (run) {
        if (run >= min_len && run <= max_len) scratch.push_back(h);
        h = kFnvOffset;
        run = 0;
      }
    }
    if (run && run >= min_len && run <= max_len) scratch.push_back(h);
    if (scratch.empty()) continue;
    std::sort(scratch.begin(), scratch.end());
    int64_t uniq = 1;
    for (size_t i = 1; i < scratch.size(); ++i)
      uniq += scratch[i] != scratch[i - 1];
    if (uniq > s) {
      overflow[q] = 1;
      continue;
    }
    // uniq pass + prefetch every term's table line up front
    int64_t w = 0;
    size_t i = 0;
    while (i < scratch.size()) {
      const uint64_t x = scratch[i];
      size_t j = i + 1;
      while (j < scratch.size() && scratch[j] == x) ++j;
      keys[w] = x;
      tfs[w] = static_cast<int32_t>(j - i);
      const uint64_t ix = slot_of(x, log2n);
      idx[w] = ix;
      __builtin_prefetch(&table[ix], 0, 1);
      ++w;
      i = j;
    }
    uint64_t *oh = out_h + q * s;
    float *oa = out_a + q * s;
    int32_t *orow = out_r + q * s;
    uint8_t *of = out_f + q * s;
    for (int64_t t = 0; t < w; ++t) {
      const uint64_t x = keys[t];
      uint64_t ix = idx[t];
      int32_t row = -1;
      float idf = 0.0f;
      while (table[ix].row != -1) {
        if (table[ix].key == x) {
          row = table[ix].row;
          idf = table[ix].idf;
          break;
        }
        ix = (ix + 1) & mask;
      }
      const bool found = row >= 0;
      oh[t] = x;
      orow[t] = found ? row : 0;
      of[t] = found ? 1 : 0;
      const float tf_f = static_cast<float>(tfs[t]);
      if (kind == 0) {
        const float a = tf_f * idf;
        oa[t] = (idf == 0.0f) ? 0.0f : a;
      } else {
        qw[t] = tf_f * idf;
        idfs[t] = idf;
      }
    }
    if (kind != 0 && w > 0) {
      float acc = 0.0f;
      for (int64_t t = 0; t < w; ++t) {
        const float v = qw[t];
        acc = acc + v * v;
      }
      const float qnorm = std::sqrt(acc);
      for (int64_t t = 0; t < w; ++t) {
        float a = (qnorm == 0.0f) ? 0.0f : (qw[t] / qnorm) * idfs[t];
        oa[t] = (idfs[t] == 0.0f) ? 0.0f : a;
      }
    }
  }
  };
  if (t_n <= 1) {
    work(0, nq);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(t_n - 1);
  for (int t = 1; t < t_n; ++t)
    threads.emplace_back(work, nq * t / t_n, nq * (t + 1) / t_n);
  work(0, nq / t_n);
  for (auto &th : threads) th.join();
}

}  // extern "C"
