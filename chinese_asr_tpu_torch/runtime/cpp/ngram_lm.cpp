// First-party n-gram language model scorer (C ABI, ctypes-bound).
//
// TPU-native replacement for the kenlm C++ dependency the reference uses
// for second-pass rescoring (reference model.py:13, 755, 1107) and for the
// incremental BaseScore state machine of its first-pass-LM decode
// (model.py:1131-1180).  Scoring semantics match kenlm's Python API:
//   score(sentence, bos, eos)  -> sum of log10 conditional probabilities
//                                 with Katz backoff, <s> context if bos,
//                                 plus p(</s> | ...) if eos
//   base_score(state, word)    -> incremental single-word score + new state
// OOV words map to <unk>; with no <unk> in the model the unigram floor is
// -100 (kenlm's unknown_missing_logprob default), with context backoffs
// still applied.
//
// TWO on-disk formats load through the same handle:
//   * ARPA text  -> one exact-key hash table over all n-grams (correctness
//     first; host-side rescoring is not the bottleneck), a string->id
//     vocab hash, and batched scoring entry points so a whole n-best list
//     is scored in one FFI call.
//   * KenLM **binary** (.klm) -> scored directly from the memory image the
//     way kenlm does.  BOTH search families are implemented:
//       - PROBING: MurmurHash64A word hashes into the probing vocab table,
//         reversed-fold CombineWordHash n-gram keys into per-order
//         linear-probing tables.  This is the format of the reference's
//         shipped artifact zh_giga.no_cna_cmn.prune01244.klm (reference
//         gpd.py:121, main.py:126).
//       - TRIE / QUANT_TRIE / ARRAY_TRIE / QUANT_ARRAY_TRIE: sorted-hash
//         vocabulary, reversed (suffix-first) bit-packed trie levels with
//         inline or Bhiksha-array-compressed next pointers, and optional
//         separately-quantized prob/backoff bins (kenlm build_binary's
//         `trie [-q N -b M] [-a K]` family).  Layout per kenlm lm/trie.hh,
//         lm/quantize.hh, lm/bhiksha.hh, util/bit_packing.hh.
//       - REST_PROBING stores different (rest) values and stays rejected
//         with a convert hint.
//     lm_write_binary[_ex]() is the matching build_binary equivalent (both
//     families), used both as a converter and to validate the readers by
//     roundtrip + ARPA score differential (pruned-suffix "blank" entries
//     are materialized with their exactly backed-off probability, so trie
//     scores equal ARPA scores by construction).
//
// KenLM binary layout implemented (from kenlm lm/binary_format.hh/cc,
// lm/vocab.hh/cc, lm/search_hashed.hh, util/probing_hash_table.hh):
//   [Sanity 88B]                magic[56] "mmap lm http://kheafield.com/
//                               code format version 5\n\0" zero-padded,
//                               f32 {0,1,-0.5}, u32 {1, 0xffffffff},
//                               pad4, u64 1
//   [FixedWidthParameters 20B]  u8 order, pad3, f32 probing_multiplier,
//                               i32 model_type (0=PROBING), u8 bool
//                               has_vocabulary, pad3, u32 search_version
//   [counts]                    order x u64, then pad to 8
//   [vocab]                     header {u64 version=0, u64 bound}, then a
//                               probing table of 12B {u64 murmur, u32 id}
//                               entries; buckets = max(c1+1, 1.5*c1);
//                               <unk> is NOT stored (lookup miss -> 0)
//   [search]                    unigram array (c1+2) x {f32 prob, f32
//                               backoff} indexed by word id; for n in
//                               2..order-1 a probing table of 16B
//                               {u64 key, f32 prob, f32 backoff}; longest
//                               order a probing table of 12B {u64 key,
//                               f32 prob}; all bucket counts
//                               max(cn+1, 1.5*cn), invalid key 0
//   [vocab words]               optional trailing "<unk>\0word\0..."
//                               (ignored on read; reader auto-detects the
//                               unigram +2/+1 slack via this marker)
// N-gram keys fold REVERSED (last word first, matching kenlm's
// ScoreExceptBackoff walking history backwards):
//   h = w[n-1]; for i = n-2..0: h = (h * 8978948897894561157) ^
//                                   ((1 + w[i]) * 17894857484156487943)

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <memory>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr int kMaxOrder = 8;

// ---------------------------------------------------------------------------
// error reporting (ctypes has no exceptions)
// ---------------------------------------------------------------------------
thread_local std::string g_error;

void set_error(const std::string& e) { g_error = e; }

// ---------------------------------------------------------------------------
// ARPA model: exact-key hash table
// ---------------------------------------------------------------------------
struct NgramKey {
  uint8_t len = 0;
  uint32_t ids[kMaxOrder] = {0};

  bool operator==(const NgramKey& o) const {
    if (len != o.len) return false;
    return std::memcmp(ids, o.ids, len * sizeof(uint32_t)) == 0;
  }
};

struct NgramKeyHash {
  size_t operator()(const NgramKey& k) const {
    // FNV-1a over the used prefix
    uint64_t h = 1469598103934665603ull;
    const unsigned char* p = reinterpret_cast<const unsigned char*>(k.ids);
    for (size_t i = 0; i < k.len * sizeof(uint32_t); ++i) {
      h ^= p[i];
      h *= 1099511628211ull;
    }
    h ^= k.len;
    h *= 1099511628211ull;
    return static_cast<size_t>(h);
  }
};

struct Entry {
  float logp = 0.f;      // log10 probability
  float backoff = 0.f;   // log10 backoff weight (0 if none)
};

struct Model {
  int order = 0;
  std::unordered_map<std::string, uint32_t> vocab;
  std::unordered_map<NgramKey, Entry, NgramKeyHash> grams;
  uint32_t unk_id = 0, bos_id = 0, eos_id = 0;
  bool has_unk = false;
};

uint32_t intern(Model* m, const std::string& w) {
  auto it = m->vocab.find(w);
  if (it != m->vocab.end()) return it->second;
  uint32_t id = static_cast<uint32_t>(m->vocab.size());
  m->vocab.emplace(w, id);
  return id;
}

// p(w | ctx) with backoff; ctx is the most recent (left-to-right) history.
double score_one(const Model* m, const uint32_t* ctx, int ctx_len,
                 uint32_t w) {
  if (ctx_len > m->order - 1) {
    ctx += ctx_len - (m->order - 1);
    ctx_len = m->order - 1;
  }
  double backoff_sum = 0.0;
  for (int use = ctx_len; use >= 0; --use) {
    NgramKey k;
    k.len = static_cast<uint8_t>(use + 1);
    for (int i = 0; i < use; ++i) k.ids[i] = ctx[ctx_len - use + i];
    k.ids[use] = w;
    auto it = m->grams.find(k);
    if (it != m->grams.end()) {
      return backoff_sum + it->second.logp;
    }
    if (use > 0) {
      // add backoff weight of the context we are abandoning
      NgramKey c;
      c.len = static_cast<uint8_t>(use);
      for (int i = 0; i < use; ++i) c.ids[i] = ctx[ctx_len - use + i];
      auto cit = m->grams.find(c);
      if (cit != m->grams.end()) backoff_sum += cit->second.backoff;
    }
  }
  // even the unigram is missing (word outside ARPA): fall back to <unk>
  if (m->has_unk) {
    NgramKey k;
    k.len = 1;
    k.ids[0] = m->unk_id;
    auto it = m->grams.find(k);
    if (it != m->grams.end()) return backoff_sum + it->second.logp;
  }
  // kenlm synthesizes an <unk> unigram at unknown_missing_logprob (-100)
  // when the ARPA lacks one, so context backoffs still apply
  return backoff_sum - 100.0;
}

// next state = last min(order-1, ctx_len+1) words of (ctx + w)
void advance_state_impl(int order, const uint32_t* ctx, int ctx_len,
                        uint32_t w, uint32_t* out, int* out_len) {
  int keep = order - 1;
  std::vector<uint32_t> h(ctx, ctx + ctx_len);
  h.push_back(w);
  int start = static_cast<int>(h.size()) > keep
                  ? static_cast<int>(h.size()) - keep : 0;
  int n = static_cast<int>(h.size()) - start;
  for (int i = 0; i < n; ++i) out[i] = h[start + i];
  *out_len = n;
}

// ---------------------------------------------------------------------------
// ARPA parsing
// ---------------------------------------------------------------------------
bool parse_arpa(Model* m, FILE* f) {
  char buf[1 << 16];
  std::vector<uint64_t> counts;
  // header
  bool in_data = false;
  while (std::fgets(buf, sizeof(buf), f)) {
    std::string line(buf);
    while (!line.empty() && (line.back() == '\n' || line.back() == '\r'))
      line.pop_back();
    if (line == "\\data\\") { in_data = true; continue; }
    if (in_data) {
      if (line.rfind("ngram ", 0) == 0) {
        // "ngram N=count"
        const char* eq = std::strchr(line.c_str(), '=');
        if (eq) counts.push_back(std::strtoull(eq + 1, nullptr, 10));
        continue;
      }
      if (!line.empty() && line[0] == '\\') {
        // first "\N-grams:" section header
        break;
      }
    }
  }
  if (counts.empty()) return false;
  m->order = static_cast<int>(counts.size());
  if (m->order > kMaxOrder) return false;
  uint64_t total = 0;
  for (uint64_t c : counts) total += c;
  m->grams.reserve(total * 2);

  // we are positioned just after reading a section header line in buf
  int cur_order = 0;
  {
    std::string line(buf);
    if (line.size() > 2 && line[0] == '\\')
      cur_order = std::atoi(line.c_str() + 1);
  }
  std::vector<char*> toks;
  while (cur_order >= 1 && cur_order <= m->order) {
    if (!std::fgets(buf, sizeof(buf), f)) break;
    // strip newline
    size_t len = std::strlen(buf);
    while (len && (buf[len - 1] == '\n' || buf[len - 1] == '\r'))
      buf[--len] = 0;
    if (len == 0) continue;
    if (buf[0] == '\\') {
      if (std::strcmp(buf, "\\end\\") == 0) break;
      cur_order = std::atoi(buf + 1);
      continue;
    }
    // line: logp \t w1 [w2 ...] [\t backoff]
    toks.clear();
    for (char* p = std::strtok(buf, " \t"); p; p = std::strtok(nullptr, " \t"))
      toks.push_back(p);
    if (static_cast<int>(toks.size()) < cur_order + 1) continue;
    Entry e;
    e.logp = std::strtof(toks[0], nullptr);
    bool has_backoff =
        static_cast<int>(toks.size()) >= cur_order + 2;
    if (has_backoff) e.backoff = std::strtof(toks[cur_order + 1], nullptr);
    NgramKey k;
    k.len = static_cast<uint8_t>(cur_order);
    for (int i = 0; i < cur_order; ++i)
      k.ids[i] = intern(m, toks[1 + i]);
    m->grams[k] = e;
  }

  auto it = m->vocab.find("<unk>");
  if (it != m->vocab.end()) { m->unk_id = it->second; m->has_unk = true; }
  m->bos_id = intern(m, "<s>");
  m->eos_id = intern(m, "</s>");
  return true;
}

// ---------------------------------------------------------------------------
// KenLM binary (PROBING) format
// ---------------------------------------------------------------------------
const char kMagicBytes[] =
    "mmap lm http://kheafield.com/code format version 5\n";  // + implicit \0
constexpr size_t kMagicLen = sizeof(kMagicBytes);            // 52 incl. \0
constexpr size_t kMagicField = (kMagicLen + 7) & ~size_t(7); // ALIGN8 -> 56
constexpr size_t kSanitySize = kMagicField + 3 * 4 + 2 * 4 + 4 /*pad*/ + 8;
static_assert(kSanitySize == 88, "Sanity layout");
constexpr size_t kFixedParamsSize = 20;
constexpr float kProbingMultiplier = 1.5f;
constexpr int kVocabEntrySize = 12;    // {u64 murmur, u32 id}, pack(4)
constexpr int kMidEntrySize = 16;      // {u64 key, f32 prob, f32 backoff}
constexpr int kLongestEntrySize = 12;  // {u64 key, f32 prob}, pack(4)
constexpr size_t kVocabHeaderSize = 16;  // {u64 version=0, u64 bound}

inline size_t align8(size_t x) { return (x + 7) & ~size_t(7); }

inline size_t header_size(int order) {
  return align8(kSanitySize + kFixedParamsSize + 8 * size_t(order));
}

inline uint64_t probing_buckets(uint64_t entries) {
  // util::ProbingHashTable::Size: max(entries + 1, multiplier * entries)
  uint64_t mult = static_cast<uint64_t>(
      kProbingMultiplier * static_cast<float>(entries));
  return entries + 1 > mult ? entries + 1 : mult;
}

// util/murmur_hash.cc MurmurHash64A (Austin Appleby, public domain) —
// kenlm's HashForVocab is MurmurHash64A(word, len, 0)
uint64_t murmur64a(const void* key, size_t len, uint64_t seed) {
  const uint64_t m = 0xc6a4a7935bd1e995ull;
  const int r = 47;
  uint64_t h = seed ^ (len * m);
  const unsigned char* data = static_cast<const unsigned char*>(key);
  const unsigned char* end = data + (len / 8) * 8;
  while (data != end) {
    uint64_t k;
    std::memcpy(&k, data, 8);
    data += 8;
    k *= m; k ^= k >> r; k *= m;
    h ^= k; h *= m;
  }
  switch (len & 7) {
    case 7: h ^= uint64_t(data[6]) << 48; [[fallthrough]];
    case 6: h ^= uint64_t(data[5]) << 40; [[fallthrough]];
    case 5: h ^= uint64_t(data[4]) << 32; [[fallthrough]];
    case 4: h ^= uint64_t(data[3]) << 24; [[fallthrough]];
    case 3: h ^= uint64_t(data[2]) << 16; [[fallthrough]];
    case 2: h ^= uint64_t(data[1]) << 8;  [[fallthrough]];
    case 1: h ^= uint64_t(data[0]);
            h *= m;
  }
  h ^= h >> r; h *= m; h ^= h >> r;
  return h;
}

// lm/search_hashed.hh detail::CombineWordHash
inline uint64_t combine_word_hash(uint64_t current, uint32_t next) {
  return (current * 8978948897894561157ull) ^
         ((uint64_t(1) + next) * 17894857484156487943ull);
}

// reversed fold: last word is the hash seed (kenlm hashes from the
// predicted word backward through history)
uint64_t ngram_hash(const uint32_t* w, int n) {
  uint64_t h = w[n - 1];
  for (int i = n - 2; i >= 0; --i) h = combine_word_hash(h, w[i]);
  return h;
}

struct BinTable {
  const char* base = nullptr;
  uint64_t buckets = 0;
  int entry_size = 0;
};

struct BinModel {
  std::vector<char> data;            // whole file image
  int order = 0;
  uint64_t counts[kMaxOrder] = {0};
  BinTable vocab;                    // 12B entries
  const char* unigram = nullptr;     // (counts[0]+slack) x 8B prob/backoff
  BinTable mid[kMaxOrder];           // mid[n-2] for order n in 2..order-1
  BinTable longest;                  // 12B entries
  uint32_t bound = 0;                // 1 + highest assigned word id
  uint32_t bos_id = 0, eos_id = 0;
};

// probing find: bucket = key % buckets, linear probe, stop at key 0
bool probe_find(const BinTable& t, uint64_t key, float* prob,
                float* backoff) {
  if (!t.buckets) return false;
  uint64_t i = key % t.buckets;
  for (uint64_t n = 0; n <= t.buckets; ++n) {
    const char* e = t.base + i * t.entry_size;
    uint64_t k;
    std::memcpy(&k, e, 8);
    if (k == key) {
      if (prob) std::memcpy(prob, e + 8, 4);
      if (backoff) {
        if (t.entry_size >= 16) std::memcpy(backoff, e + 12, 4);
        else *backoff = 0.f;
      }
      return true;
    }
    if (k == 0) return false;
    if (++i == t.buckets) i = 0;
  }
  return false;  // table pathologically full
}

void probe_insert(char* base, uint64_t buckets, int entry_size,
                  uint64_t key, float prob, float backoff) {
  uint64_t i = key % buckets;
  for (;;) {
    char* e = base + i * entry_size;
    uint64_t k;
    std::memcpy(&k, e, 8);
    if (k == 0) {
      std::memcpy(e, &key, 8);
      std::memcpy(e + 8, &prob, 4);
      if (entry_size >= 16) std::memcpy(e + 12, &backoff, 4);
      return;
    }
    if (++i == buckets) i = 0;
  }
}

uint32_t bin_vocab_id(const BinModel* m, const char* word, size_t len) {
  uint64_t h = murmur64a(word, len, 0);
  uint64_t i = h % m->vocab.buckets;
  for (uint64_t n = 0; n <= m->vocab.buckets; ++n) {
    const char* e = m->vocab.base + i * kVocabEntrySize;
    uint64_t k;
    std::memcpy(&k, e, 8);
    if (k == h) {
      uint32_t id;
      std::memcpy(&id, e + 8, 4);
      return id;
    }
    if (k == 0) return 0;  // <unk>
    if (++i == m->vocab.buckets) i = 0;
  }
  return 0;
}

// p(w | ctx) with backoff over the probing tables (same walk as the ARPA
// score_one, hashed lookups instead of exact keys)
double bin_score_one(const BinModel* m, const uint32_t* ctx, int ctx_len,
                     uint32_t w) {
  if (ctx_len > m->order - 1) {
    ctx += ctx_len - (m->order - 1);
    ctx_len = m->order - 1;
  }
  uint64_t c1 = m->counts[0];
  double backoff_sum = 0.0;
  uint32_t key_buf[kMaxOrder];
  for (int use = ctx_len; use >= 0; --use) {
    const uint32_t* cctx = ctx + (ctx_len - use);
    int n = use + 1;
    bool found = false;
    float prob = 0.f;
    if (n == 1) {
      if (uint64_t(w) <= c1) {   // ids run 0..c1 (c1 when <unk> absent)
        std::memcpy(&prob, m->unigram + size_t(w) * 8, 4);
        found = true;            // every valid id has a unigram slot
      }
    } else {
      for (int i = 0; i < use; ++i) key_buf[i] = cctx[i];
      key_buf[use] = w;
      uint64_t h = ngram_hash(key_buf, n);
      const BinTable& t = (n == m->order) ? m->longest : m->mid[n - 2];
      found = probe_find(t, h, &prob, nullptr);
    }
    if (found) return backoff_sum + prob;
    if (use > 0) {
      // backoff weight of the abandoned context
      float bo = 0.f;
      if (use == 1) {
        uint32_t cw = cctx[0];
        if (uint64_t(cw) <= c1)
          std::memcpy(&bo, m->unigram + size_t(cw) * 8 + 4, 4);
      } else {
        uint64_t h = ngram_hash(cctx, use);
        probe_find(m->mid[use - 2], h, nullptr, &bo);
      }
      backoff_sum += bo;
    }
  }
  // unreachable for valid ids (unigram always hits); keep kenlm's floor
  return backoff_sum - 100.0;
}

struct HeaderInfo {
  int order = 0;
  int32_t model_type = 0;
  uint64_t counts[kMaxOrder] = {0};
};

bool parse_header(const std::vector<char>& data, HeaderInfo* hi) {
  const char* p = data.data();
  const size_t file_size = data.size();
  if (file_size < kSanitySize + kFixedParamsSize) {
    set_error("file too small for a kenlm binary header");
    return false;
  }
  if (std::memcmp(p, kMagicBytes, kMagicLen) != 0) {
    set_error("kenlm binary magic mismatch (unsupported format version; "
              "this reader implements 'format version 5')");
    return false;
  }
  // sanity reference values (endianness / type-width check)
  float f0, f1, fm;
  std::memcpy(&f0, p + kMagicField, 4);
  std::memcpy(&f1, p + kMagicField + 4, 4);
  std::memcpy(&fm, p + kMagicField + 8, 4);
  if (f0 != 0.f || f1 != 1.f || fm != -0.5f) {
    set_error("kenlm binary sanity floats mismatch (foreign endianness?)");
    return false;
  }
  const char* fp = p + kSanitySize;
  hi->order = static_cast<unsigned char>(fp[0]);
  std::memcpy(&hi->model_type, fp + 8, 4);
  if (hi->order < 1 || hi->order > kMaxOrder) {
    set_error("unsupported order " + std::to_string(hi->order));
    return false;
  }
  if (file_size < header_size(hi->order) + align8(kVocabHeaderSize)) {
    set_error("kenlm binary truncated inside the header");
    return false;
  }
  const char* cp = p + kSanitySize + kFixedParamsSize;
  for (int i = 0; i < hi->order; ++i) {
    std::memcpy(&hi->counts[i], cp + 8 * i, 8);
    // hard cap before any size arithmetic: a corrupt count must fail
    // cleanly, not overflow size_t into out-of-bounds table pointers.
    // 2^40 entries x <=2^7 bits each stays far inside 64-bit byte math,
    // and no real model approaches it.
    if (hi->counts[i] >> 40) {
      set_error("kenlm binary corrupt: ngram count " +
                std::to_string(hi->counts[i]) + " exceeds file capacity");
      return false;
    }
  }
  return true;
}

BinModel* load_probing(std::vector<char>&& image, const HeaderInfo& hi) {
  std::unique_ptr<BinModel> m(new BinModel());
  m->data = std::move(image);
  const char* p = m->data.data();
  const size_t file_size = m->data.size();
  const int order = hi.order;
  m->order = order;
  for (int i = 0; i < order; ++i) {
    m->counts[i] = hi.counts[i];
    // probing entries are >= 12 bytes each
    if (m->counts[i] > uint64_t(file_size) / 12 + 1) {
      set_error("kenlm binary corrupt: ngram count " +
                std::to_string(m->counts[i]) + " exceeds file capacity");
      return nullptr;
    }
  }

  size_t off = header_size(order);
  // vocab: {u64 version, u64 bound} header + probing table
  uint64_t version, bound;
  std::memcpy(&version, p + off, 8);
  std::memcpy(&bound, p + off + 8, 8);
  if (version != 0 && bound == 0 && version <= m->counts[0] + 1) {
    // defensive: tolerate {bound, version} field order
    bound = version;
  }
  m->bound = static_cast<uint32_t>(bound);
  m->vocab.base = p + off + align8(kVocabHeaderSize);
  m->vocab.buckets = probing_buckets(m->counts[0]);
  m->vocab.entry_size = kVocabEntrySize;
  off += align8(kVocabHeaderSize) + m->vocab.buckets * kVocabEntrySize;

  // search: unigram + middles + longest.  kenlm allocates counts[0]+2
  // unigram slots ("+1 in case unknown doesn't appear, +1 slack"); accept
  // +1 layouts too by checking where the section chain ends (the file
  // either ends at the last table or continues with the vocab-words
  // section, whose first bytes are "<unk>\0").
  for (int slack = 2; slack >= 1; --slack) {
    size_t o = off + (m->counts[0] + slack) * 8;
    for (int n = 2; n < order; ++n)
      o += probing_buckets(m->counts[n - 1]) * kMidEntrySize;
    if (order >= 2) o += probing_buckets(m->counts[order - 1]) *
                         kLongestEntrySize;
    bool fits = o <= size_t(file_size);
    bool exact = o == size_t(file_size);
    bool words = fits && size_t(file_size) - o >= 6 &&
                 std::memcmp(p + o, "<unk>", 6) == 0;
    if (exact || words || slack == 1) {
      if (!fits) {
        set_error("kenlm binary truncated: section chain exceeds file");
        return nullptr;
      }
      m->unigram = p + off;
      size_t o2 = off + (m->counts[0] + slack) * 8;
      for (int n = 2; n < order; ++n) {
        m->mid[n - 2] = {p + o2, probing_buckets(m->counts[n - 1]),
                         kMidEntrySize};
        o2 += m->mid[n - 2].buckets * kMidEntrySize;
      }
      if (order >= 2) {
        m->longest = {p + o2, probing_buckets(m->counts[order - 1]),
                      kLongestEntrySize};
      }
      break;
    }
  }
  m->bos_id = bin_vocab_id(m.get(), "<s>", 3);
  m->eos_id = bin_vocab_id(m.get(), "</s>", 4);
  return m.release();
}

// ---------------------------------------------------------------------------
// KenLM binary TRIE family (model_type 2..5)
//
// Layout (kenlm lm/trie.hh, lm/quantize.hh, lm/bhiksha.hh,
// util/bit_packing.hh), after the shared [Sanity][FixedWidthParameters]
// [counts] header:
//   [sorted vocab]   u64 stored-entry count, then counts[0] x u64 slots of
//                    sorted murmur hashes (<unk> is NOT stored; word id =
//                    sorted position + 1, misses -> 0)
//   [quant tables]   QUANT_* only: u8 prob_bits, u8 backoff_bits, 6 pad;
//                    per middle order: 2^pb f32 prob bins + 2^bb f32
//                    backoff bins (bins [0]=-0.0 "no extension",
//                    [1]=+0.0 "extension" are reserved); longest order:
//                    2^pb f32 prob bins
//   [unigram]        (counts[0]+2) x {f32 prob, f32 backoff, u64 next}
//                    indexed by word id; entry bound terminates ranges
//   [middles]        per order n in 2..order-1: a Bhiksha region (plain
//                    TRIE: one u64 of slack; ARRAY_*: u64 header whose
//                    byte 0 is the version and byte 1 the configured
//                    bhiksha bit budget, then (counts[n]>>inline_bits)+1
//                    u64 high-bit offsets) followed by a bit-packed array
//                    of (counts[n-1]+1) records [word|prob/backoff|next],
//                    8 slack bytes.  Non-quant prob is a 31-bit
//                    sign-dropped f32, backoff a full f32; quant packs
//                    (prob_idx << backoff_bits) | backoff_idx.  next
//                    pointers index the NEXT level's records; record i's
//                    child range is [next_i, next_{i+1}).
//   [longest]        bit-packed (counts[order-1]+1) x [word|prob]
//
// The trie is SUFFIX-FIRST: an n-gram (w1..wn) hangs off unigram[wn] ->
// middle entry storing w_{n-1} -> ... -> entry storing w1, and each
// level's records sort by (w_n, .., w_1).  Pruned models whose (w2..wn)
// suffix is absent get a "blank" placeholder; our writer materializes
// blanks with the exactly backed-off probability, making trie scores
// equal ARPA scores by construction (kenlm's own blank probabilities are
// the basis probability of the longest real suffix, the same value).
// ---------------------------------------------------------------------------

inline uint64_t read_bits(const char* base, uint64_t bit_off, uint8_t len) {
  uint64_t w;
  std::memcpy(&w, base + (bit_off >> 3), 8);
  w >>= (bit_off & 7);
  return len >= 64 ? w : (w & ((uint64_t(1) << len) - 1));
}

inline void write_bits(char* base, uint64_t bit_off, uint8_t len,
                       uint64_t v) {
  if (!len) return;
  if (len < 64) v &= (uint64_t(1) << len) - 1;
  uint64_t w;
  std::memcpy(&w, base + (bit_off >> 3), 8);
  w |= v << (bit_off & 7);
  std::memcpy(base + (bit_off >> 3), &w, 8);
}

constexpr uint32_t kF32SignBit = 0x80000000u;

inline float bits_to_f32(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline uint32_t f32_to_bits(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}

// kenlm stores non-positive (log10) probabilities in 31 bits by dropping
// the always-set sign bit (util::ReadNonPositiveFloat31)
inline float read_npf31(const char* base, uint64_t off) {
  return bits_to_f32(uint32_t(read_bits(base, off, 31)) | kF32SignBit);
}

inline void write_npf31(char* base, uint64_t off, float f) {
  write_bits(base, off, 31, f32_to_bits(f) & ~kF32SignBit);
}

inline float read_f32b(const char* base, uint64_t off) {
  return bits_to_f32(uint32_t(read_bits(base, off, 32)));
}

inline void write_f32b(char* base, uint64_t off, float f) {
  write_bits(base, off, 32, f32_to_bits(f));
}

// util::RequiredBits — bits to represent max_value itself
inline uint8_t required_bits(uint64_t max_value) {
  if (!max_value) return 0;
  uint8_t r = 1;
  while (max_value >>= 1) ++r;
  return r;
}

inline uint64_t u64_at(const char* base, uint64_t i) {
  uint64_t v;
  std::memcpy(&v, base + 8 * i, 8);
  return v;
}

inline float f32_at(const char* base, uint64_t i) {
  float v;
  std::memcpy(&v, base + 4 * i, 4);
  return v;
}

// lm/bhiksha.cc ChopBits: how many high bits of the next pointers move
// into the offsets array (minimizes table-bits minus inline-bit savings)
uint8_t chop_bits(uint64_t max_offset, uint64_t max_next,
                  uint8_t bhiksha_bits) {
  const uint8_t required = required_bits(max_next);
  uint8_t best = 0;
  int64_t lowest = std::numeric_limits<int64_t>::max();
  const uint8_t hi = required < bhiksha_bits ? required : bhiksha_bits;
  for (uint8_t chop = 0; chop <= hi; ++chop) {
    const int64_t change =
        int64_t(max_next >> (required - chop)) * 64 -
        int64_t(max_offset) * int64_t(chop);
    if (change < lowest) {
      lowest = change;
      best = chop;
    }
  }
  return best;
}

struct TrieLevel {
  const char* bits = nullptr;     // bit-packed records
  uint64_t entries = 0;
  uint8_t word_bits = 0, quant_bits = 0, next_bits = 0, total_bits = 0;
  const char* bh_offsets = nullptr;  // ArrayBhiksha high-bit index (u64s)
  uint64_t bh_count = 0;
  const char* prob_table = nullptr;     // quant bins (f32s)
  const char* backoff_table = nullptr;  // quant bins (f32s)
};

struct TrieModel {
  std::vector<char> data;  // whole file image
  int order = 0;
  int32_t model_type = 2;
  uint64_t counts[kMaxOrder] = {0};
  const char* vocab_hashes = nullptr;  // sorted u64 murmur hashes
  uint64_t vocab_entries = 0;          // excludes <unk>
  uint32_t bound = 0;                  // vocab_entries + 1
  const char* unigram = nullptr;       // (counts[0]+2) x 16B
  TrieLevel mid[kMaxOrder];            // mid[n-2] for order n in 2..order-1
  TrieLevel longest;
  uint8_t prob_bits = 0, backoff_bits = 0;  // 0 => not quantized
  const char* longest_table = nullptr;
  uint32_t bos_id = 0, eos_id = 0;
};

uint32_t trie_vocab_id(const TrieModel* m, const char* word, size_t len) {
  const uint64_t h = murmur64a(word, len, 0);
  uint64_t lo = 0, hi = m->vocab_entries;
  while (lo < hi) {
    const uint64_t mid = lo + (hi - lo) / 2;
    if (u64_at(m->vocab_hashes, mid) < h) lo = mid + 1;
    else hi = mid;
  }
  if (lo < m->vocab_entries && u64_at(m->vocab_hashes, lo) == h)
    return uint32_t(lo + 1);  // +1: <unk> is 0 and never stored
  return 0;
}

void trie_unigram_at(const TrieModel* m, uint32_t w, float* prob,
                     float* backoff, uint64_t* begin, uint64_t* end) {
  const char* u = m->unigram + size_t(w) * 16;
  if (prob) std::memcpy(prob, u, 4);
  if (backoff) std::memcpy(backoff, u + 4, 4);
  if (begin) {
    std::memcpy(begin, u + 8, 8);
    std::memcpy(end, u + 24, 8);
  }
}

// binary search for `word` among records [begin, end) of a level
bool trie_level_find(const TrieLevel& L, uint32_t word, uint64_t begin,
                     uint64_t end, uint64_t* at) {
  while (begin < end) {
    const uint64_t mid = begin + (end - begin) / 2;
    const uint64_t w = read_bits(L.bits, mid * L.total_bits, L.word_bits);
    if (w < word) begin = mid + 1;
    else if (w > word) end = mid;
    else { *at = mid; return true; }
  }
  return false;
}

// position of the last offsets-array entry <= index (ArrayBhiksha read);
// entry 0 is always 0, so the result is well-defined
uint64_t bh_high(const TrieLevel& L, uint64_t index) {
  uint64_t lo = 0, hi = L.bh_count;
  while (lo < hi) {
    const uint64_t mid = lo + (hi - lo) / 2;
    if (u64_at(L.bh_offsets, mid) <= index) lo = mid + 1;
    else hi = mid;
  }
  return lo - 1;
}

// decode record i of a middle level: prob/backoff and the child range
void trie_mid_read(const TrieModel* m, const TrieLevel& L, uint64_t i,
                   float* prob, float* backoff, uint64_t* begin,
                   uint64_t* end) {
  uint64_t bit = i * L.total_bits + L.word_bits;
  if (m->prob_bits) {
    const uint64_t enc = read_bits(L.bits, bit, L.quant_bits);
    if (prob) *prob = f32_at(L.prob_table, enc >> m->backoff_bits);
    if (backoff)
      *backoff = f32_at(L.backoff_table,
                        enc & ((uint64_t(1) << m->backoff_bits) - 1));
  } else {
    if (prob) *prob = read_npf31(L.bits, bit);
    if (backoff) *backoff = read_f32b(L.bits, bit + 31);
  }
  if (begin) {
    bit = (i + 1) * L.total_bits - L.next_bits;
    *begin = read_bits(L.bits, bit, L.next_bits);
    *end = read_bits(L.bits, bit + L.total_bits, L.next_bits);
    if (L.bh_offsets) {
      *begin |= bh_high(L, i) << L.next_bits;
      *end |= bh_high(L, i + 1) << L.next_bits;
    }
  }
}

float trie_longest_prob(const TrieModel* m, uint64_t i) {
  const uint64_t bit = i * m->longest.total_bits + m->longest.word_bits;
  if (m->prob_bits)
    return f32_at(m->longest_table,
                  read_bits(m->longest.bits, bit, m->prob_bits));
  return read_npf31(m->longest.bits, bit);
}

// p(w | ctx): walk unigram[w] backward through the context (suffix-first
// trie), then add the backoff weights of the context suffixes longer than
// the match — same Katz walk as score_one/bin_score_one
double trie_score_one(const TrieModel* m, const uint32_t* ctx, int ctx_len,
                      uint32_t w) {
  if (ctx_len > m->order - 1) {
    ctx += ctx_len - (m->order - 1);
    ctx_len = m->order - 1;
  }
  if (w >= m->bound) w = 0;
  float prob;
  uint64_t b, e;
  trie_unigram_at(m, w, &prob, nullptr, &b, &e);
  double ret = prob;
  int matched = 0;  // context words of the longest match
  for (int k = 1; k <= ctx_len && b < e; ++k) {
    uint32_t cw = ctx[ctx_len - k];
    if (cw >= m->bound) cw = 0;
    uint64_t at;
    if (k + 1 == m->order) {
      if (trie_level_find(m->longest, cw, b, e, &at)) {
        ret = trie_longest_prob(m, at);
        matched = k;
      }
      break;
    }
    const TrieLevel& L = m->mid[k - 1];  // order k+1 -> mid[(k+1)-2]
    if (!trie_level_find(L, cw, b, e, &at)) break;
    float p2;
    trie_mid_read(m, L, at, &p2, nullptr, &b, &e);
    ret = p2;
    matched = k;
  }
  if (matched < ctx_len) {
    double bo_sum = 0.0;
    uint32_t c0 = ctx[ctx_len - 1];
    if (c0 >= m->bound) c0 = 0;
    float bo;
    uint64_t cb, ce;
    trie_unigram_at(m, c0, nullptr, &bo, &cb, &ce);
    for (int j = 1; j <= ctx_len; ++j) {
      if (j > matched) bo_sum += bo;
      if (j == ctx_len || cb >= ce) break;
      uint32_t cw = ctx[ctx_len - 1 - j];
      if (cw >= m->bound) cw = 0;
      // the context suffix of length j+1 is an order-(j+1) n-gram and
      // j+1 <= order-1, so it always lives in a middle level
      const TrieLevel& L = m->mid[j - 1];
      uint64_t at;
      if (!trie_level_find(L, cw, cb, ce, &at)) break;
      float nb;
      trie_mid_read(m, L, at, nullptr, &nb, &cb, &ce);
      bo = nb;
    }
    ret += bo_sum;
  }
  return ret;
}

TrieModel* load_trie(std::vector<char>&& image, const HeaderInfo& hi) {
  std::unique_ptr<TrieModel> m(new TrieModel());
  m->data = std::move(image);
  const char* p = m->data.data();
  const size_t file_size = m->data.size();
  m->order = hi.order;
  m->model_type = hi.model_type;
  std::memcpy(m->counts, hi.counts, sizeof(m->counts));
  if (m->order < 2) {
    set_error("trie binaries need order >= 2");
    return nullptr;
  }
  const bool quant = (hi.model_type == 3 || hi.model_type == 5);
  const bool array = (hi.model_type >= 4);
  size_t off = header_size(m->order);
  auto need = [&](size_t end_off, const char* what) {
    if (end_off > file_size) {
      set_error(std::string("kenlm binary truncated inside ") + what);
      return false;
    }
    return true;
  };
  // sorted vocabulary: u64 stored count + counts[0] hash slots
  if (!need(off + 8 + 8 * m->counts[0], "the sorted vocabulary"))
    return nullptr;
  uint64_t stored;
  std::memcpy(&stored, p + off, 8);
  if (stored > m->counts[0]) {
    set_error("kenlm binary corrupt: vocab entry count exceeds unigrams");
    return nullptr;
  }
  m->vocab_hashes = p + off + 8;
  m->vocab_entries = stored;
  m->bound = uint32_t(stored + 1);
  off += 8 + 8 * m->counts[0];
  // quantization tables
  if (quant) {
    if (!need(off + 8, "the quantization header")) return nullptr;
    m->prob_bits = uint8_t(p[off]);
    m->backoff_bits = uint8_t(p[off + 1]);
    if (m->prob_bits < 1 || m->prob_bits > 25 || m->backoff_bits < 1 ||
        m->backoff_bits > 25) {
      set_error("kenlm binary corrupt: quantization bits out of range");
      return nullptr;
    }
    size_t toff = off + 8;
    for (int n = 2; n < m->order; ++n) {
      m->mid[n - 2].prob_table = p + toff;
      toff += (size_t(1) << m->prob_bits) * 4;
      m->mid[n - 2].backoff_table = p + toff;
      toff += (size_t(1) << m->backoff_bits) * 4;
    }
    m->longest_table = p + toff;
    toff += (size_t(1) << m->prob_bits) * 4;
    if (!need(toff, "the quantization tables")) return nullptr;
    off = toff;
  }
  // unigram array
  if (!need(off + (m->counts[0] + 2) * 16, "the unigram array"))
    return nullptr;
  m->unigram = p + off;
  off += (m->counts[0] + 2) * 16;
  // middles
  const uint8_t word_bits = required_bits(m->counts[0]);
  uint8_t bhiksha_cfg = 0;
  if (array && m->order > 2) {
    // the configured bit budget rides byte 1 of the FIRST middle's
    // Bhiksha header (kenlm ArrayBhiksha::UpdateConfigFromBinary)
    if (!need(off + 8, "the bhiksha header")) return nullptr;
    if (p[off] != 0) {
      set_error("unsupported ArrayBhiksha version " +
                std::to_string(int(p[off])));
      return nullptr;
    }
    bhiksha_cfg = uint8_t(p[off + 1]);
  }
  for (int n = 2; n < m->order; ++n) {
    TrieLevel& L = m->mid[n - 2];
    L.entries = m->counts[n - 1];
    L.word_bits = word_bits;
    L.quant_bits =
        quant ? uint8_t(m->prob_bits + m->backoff_bits) : uint8_t(63);
    const uint64_t max_next = m->counts[n];
    if (array) {
      const uint8_t chop = chop_bits(L.entries + 1, max_next, bhiksha_cfg);
      L.next_bits = uint8_t(required_bits(max_next) - chop);
      L.bh_count = (max_next >> L.next_bits) + 1;
      if (!need(off + 8 * (1 + L.bh_count), "a bhiksha offset array"))
        return nullptr;
      L.bh_offsets = p + off + 8;
      off += 8 * (1 + L.bh_count);
    } else {
      L.next_bits = required_bits(max_next);
      if (!need(off + 8, "a middle header")) return nullptr;
      off += 8;  // DontBhiksha slack word
    }
    L.total_bits = uint8_t(L.word_bits + L.quant_bits + L.next_bits);
    const size_t bits_size = ((L.entries + 1) * L.total_bits + 7) / 8 + 8;
    if (!need(off + bits_size, "a middle trie array")) return nullptr;
    L.bits = p + off;
    off += bits_size;
  }
  // longest
  {
    TrieLevel& L = m->longest;
    L.entries = m->counts[m->order - 1];
    L.word_bits = word_bits;
    L.quant_bits = quant ? m->prob_bits : uint8_t(31);
    L.next_bits = 0;
    L.total_bits = uint8_t(L.word_bits + L.quant_bits);
    const size_t bits_size = ((L.entries + 1) * L.total_bits + 7) / 8 + 8;
    if (!need(off + bits_size, "the longest trie array")) return nullptr;
    L.bits = p + off;
  }
  m->bos_id = trie_vocab_id(m.get(), "<s>", 3);
  m->eos_id = trie_vocab_id(m.get(), "</s>", 4);
  return m.release();
}

// ---------------------------------------------------------------------------
// binary writer (build_binary equivalent; also validates the reader)
// ---------------------------------------------------------------------------
bool write_binary(const Model* m, const char* path) {
  // kenlm-style word ids: <unk> -> 0, all other unigram-section words in
  // insertion order -> 1..  (intern order == unigram order: every word
  // appears in the ARPA unigram section first)
  std::vector<std::string> by_intern(m->vocab.size());
  for (const auto& kv : m->vocab) by_intern[kv.second] = kv.first;
  std::vector<uint32_t> remap(m->vocab.size(), 0);
  uint32_t next_id = 1;
  for (size_t i = 0; i < by_intern.size(); ++i) {
    if (m->has_unk && i == m->unk_id) { remap[i] = 0; continue; }
    remap[i] = next_id++;
  }
  uint64_t counts[kMaxOrder] = {0};
  for (const auto& kv : m->grams) counts[kv.first.len - 1]++;
  int order = m->order;

  size_t vocab_buckets = probing_buckets(counts[0]);
  size_t off_vocab = header_size(order);
  size_t off_search = off_vocab + align8(kVocabHeaderSize) +
                      vocab_buckets * kVocabEntrySize;
  size_t off_uni = off_search;
  size_t o = off_uni + (counts[0] + 2) * 8;
  size_t off_mid[kMaxOrder] = {0};
  uint64_t mid_buckets[kMaxOrder] = {0};
  for (int n = 2; n < order; ++n) {
    off_mid[n - 2] = o;
    mid_buckets[n - 2] = probing_buckets(counts[n - 1]);
    o += mid_buckets[n - 2] * kMidEntrySize;
  }
  size_t off_long = o;
  uint64_t long_buckets = order >= 2 ? probing_buckets(counts[order - 1]) : 0;
  o += long_buckets * kLongestEntrySize;

  std::vector<char> out(o, 0);
  char* p = out.data();
  // Sanity
  std::memcpy(p, kMagicBytes, kMagicLen);
  float f0 = 0.f, f1 = 1.f, fm = -0.5f;
  std::memcpy(p + kMagicField, &f0, 4);
  std::memcpy(p + kMagicField + 4, &f1, 4);
  std::memcpy(p + kMagicField + 8, &fm, 4);
  uint32_t one32 = 1, max32 = 0xffffffffu;
  std::memcpy(p + kMagicField + 12, &one32, 4);
  std::memcpy(p + kMagicField + 16, &max32, 4);
  uint64_t one64 = 1;
  std::memcpy(p + kSanitySize - 8, &one64, 8);
  // FixedWidthParameters
  char* fp = p + kSanitySize;
  fp[0] = static_cast<char>(order);
  std::memcpy(fp + 4, &kProbingMultiplier, 4);
  int32_t model_type = 0;  // PROBING
  std::memcpy(fp + 8, &model_type, 4);
  fp[12] = 0;  // has_vocabulary = false (reader side never needs strings)
  uint32_t search_version = 0;
  std::memcpy(fp + 16, &search_version, 4);
  for (int i = 0; i < order; ++i)
    std::memcpy(p + kSanitySize + kFixedParamsSize + 8 * i, &counts[i], 8);
  // vocab header + table
  uint64_t version = 0, bound = next_id;
  std::memcpy(p + off_vocab, &version, 8);
  std::memcpy(p + off_vocab + 8, &bound, 8);
  char* vtab = p + off_vocab + align8(kVocabHeaderSize);
  for (size_t i = 0; i < by_intern.size(); ++i) {
    if (m->has_unk && i == m->unk_id) continue;       // <unk> never stored
    // only unigram-section words are vocab entries
    NgramKey k;
    k.len = 1;
    k.ids[0] = static_cast<uint32_t>(i);
    if (m->grams.find(k) == m->grams.end()) continue;
    uint64_t h = murmur64a(by_intern[i].data(), by_intern[i].size(), 0);
    uint64_t b = h % vocab_buckets;
    for (;;) {
      char* e = vtab + b * kVocabEntrySize;
      uint64_t cur;
      std::memcpy(&cur, e, 8);
      if (cur == 0) {
        std::memcpy(e, &h, 8);
        std::memcpy(e + 8, &remap[i], 4);
        break;
      }
      if (++b == vocab_buckets) b = 0;
    }
  }
  // n-gram payloads
  uint32_t ids[kMaxOrder];
  for (const auto& kv : m->grams) {
    int n = kv.first.len;
    for (int i = 0; i < n; ++i) ids[i] = remap[kv.first.ids[i]];
    if (n == 1) {
      std::memcpy(p + off_uni + size_t(ids[0]) * 8, &kv.second.logp, 4);
      std::memcpy(p + off_uni + size_t(ids[0]) * 8 + 4, &kv.second.backoff,
                  4);
    } else if (n < order) {
      probe_insert(p + off_mid[n - 2], mid_buckets[n - 2], kMidEntrySize,
                   ngram_hash(ids, n), kv.second.logp, kv.second.backoff);
    } else {
      probe_insert(p + off_long, long_buckets, kLongestEntrySize,
                   ngram_hash(ids, n), kv.second.logp, 0.f);
    }
  }
  if (!m->has_unk) {
    // kenlm synthesizes <unk> at -100 when the ARPA lacks it
    float floor_p = -100.f, z = 0.f;
    std::memcpy(p + off_uni, &floor_p, 4);
    std::memcpy(p + off_uni + 4, &z, 4);
  }

  FILE* f = std::fopen(path, "wb");
  if (!f) { set_error(std::string("cannot open for write: ") + path);
            return false; }
  bool ok = std::fwrite(out.data(), 1, out.size(), f) == out.size();
  std::fclose(f);
  if (!ok) set_error("short write");
  return ok;
}

// ---------------------------------------------------------------------------
// TRIE-family writer
// ---------------------------------------------------------------------------

// lm/quantize.cc MakeBins: sort, split into equal-count chunks, center =
// chunk mean (float cast of the double quotient, matching kenlm)
void make_bins(std::vector<float>& vals, float* centers, uint64_t bins) {
  std::sort(vals.begin(), vals.end());
  size_t start = 0;
  for (uint64_t i = 0; i < bins; ++i) {
    const size_t finish = (vals.size() * (i + 1)) / bins;
    if (finish == start) {
      centers[i] = i ? centers[i - 1]
                     : -std::numeric_limits<float>::infinity();
    } else {
      double s = 0.0;
      for (size_t j = start; j < finish; ++j) s += vals[j];
      centers[i] = float(s / double(finish - start));
    }
    start = finish;
  }
}

// lm/quantize.hh Bins::Encode: nearest center at or after `reserved`
uint64_t bins_encode(const float* table, uint64_t n, float v,
                     uint64_t reserved) {
  const float* begin = table;
  const float* above = std::lower_bound(begin + reserved, begin + n, v);
  if (above == begin + reserved) return reserved < n ? reserved : n - 1;
  if (above == begin + n) return n - 1;
  return uint64_t(above - begin) -
         ((v - *(above - 1)) < (*above - v) ? 1 : 0);
}

uint64_t bins_encode_backoff(const float* table, uint64_t n, float v) {
  if (v == 0.0f) return 0;  // kNoExtensionQuant (sign-of-zero is cosmetic)
  return bins_encode(table, n, v, 2);
}

struct TEnt {
  uint32_t ids[kMaxOrder] = {0};
  float prob = 0.f, backoff = 0.f;
};

bool write_trie(const Model* m, const char* path, int32_t model_type,
                int prob_bits, int backoff_bits, int bhiksha_bits) {
  if (m->order < 2) {
    set_error("trie layouts need order >= 2; use the probing layout");
    return false;
  }
  const bool quant = (model_type == 3 || model_type == 5);
  const bool array = (model_type >= 4);
  if (quant && (prob_bits < 2 || prob_bits > 25 || backoff_bits < 2 ||
                backoff_bits > 25)) {
    set_error("quantization bits must be in [2, 25]");
    return false;
  }
  if (array && (bhiksha_bits < 0 || bhiksha_bits > 57)) {
    set_error("bhiksha bits must be in [0, 57]");
    return false;
  }
  const int order = m->order;

  // ---- sorted vocabulary (kenlm SortedVocabulary: ids follow hash order)
  std::vector<std::string> by_intern(m->vocab.size());
  for (const auto& kv : m->vocab) by_intern[kv.second] = kv.first;
  const uint64_t unk_hash = murmur64a("<unk>", 5, 0);
  const uint64_t unk_cap = murmur64a("<UNK>", 5, 0);
  std::vector<std::pair<uint64_t, uint32_t>> hashed;  // (hash, old id)
  for (size_t i = 0; i < by_intern.size(); ++i) {
    NgramKey k;
    k.len = 1;
    k.ids[0] = uint32_t(i);
    if (m->grams.find(k) == m->grams.end()) continue;  // unigram words only
    const uint64_t h =
        murmur64a(by_intern[i].data(), by_intern[i].size(), 0);
    if (h == unk_hash || h == unk_cap) continue;  // <unk> is always id 0
    hashed.emplace_back(h, uint32_t(i));
  }
  std::sort(hashed.begin(), hashed.end());
  std::vector<uint32_t> remap(m->vocab.size(), 0);  // default: <unk>
  for (size_t j = 0; j < hashed.size(); ++j)
    remap[hashed[j].second] = uint32_t(j + 1);
  const uint64_t bound = hashed.size() + 1;

  // every word of every n-gram must have a unigram entry (kenlm requires
  // this too); otherwise distinct words would silently alias id 0
  for (const auto& kv : m->grams) {
    if (kv.first.len < 2) continue;
    for (int i = 0; i < kv.first.len; ++i) {
      NgramKey k;
      k.len = 1;
      k.ids[0] = kv.first.ids[i];
      if (m->grams.find(k) == m->grams.end()) {
        set_error("trie write: n-gram word '" + by_intern[kv.first.ids[i]] +
                  "' has no unigram entry");
        return false;
      }
    }
  }

  // ---- per-order entries (old id space) + pruned-suffix blanks
  std::vector<std::vector<TEnt>> levels(order + 1);
  std::vector<std::unordered_set<NgramKey, NgramKeyHash>> have(order + 1);
  for (const auto& kv : m->grams) {
    const int n = kv.first.len;
    TEnt e;
    std::memcpy(e.ids, kv.first.ids, sizeof(e.ids));
    e.prob = kv.second.logp;
    e.backoff = kv.second.backoff;
    levels[n].push_back(e);
    have[n].insert(kv.first);
  }
  for (int n = order; n >= 3; --n) {
    for (size_t idx = 0; idx < levels[n].size(); ++idx) {
      NgramKey s;
      s.len = uint8_t(n - 1);
      for (int i = 0; i < n - 1; ++i) s.ids[i] = levels[n][idx].ids[i + 1];
      if (have[n - 1].count(s)) continue;
      // blank: placeholder on the trie path with the exactly backed-off
      // probability, so a lookup that stops here returns the ARPA value
      TEnt blank;
      std::memcpy(blank.ids, s.ids, sizeof(blank.ids));
      blank.prob = float(score_one(m, s.ids, n - 2, s.ids[n - 2]));
      blank.backoff = 0.f;
      levels[n - 1].push_back(blank);
      have[n - 1].insert(s);
    }
  }
  if (!quant) {
    // the 31-bit layout drops the sign bit; probabilities must be <= 0
    for (int n = 2; n <= order; ++n)
      for (const TEnt& e : levels[n])
        if (e.prob > 0.f) {
          set_error("trie layouts store log-probs in sign-dropped 31-bit "
                    "floats and this model has a positive one; use the "
                    "probing layout");
          return false;
        }
  }

  // counts INCLUDING blanks (kenlm BuildTrie: counts = fixed_counts)
  uint64_t counts[kMaxOrder] = {0};
  for (int n = 1; n <= order; ++n) counts[n - 1] = levels[n].size();

  // ---- remap to sorted-vocab ids; sort levels in suffix-first order
  for (int n = 2; n <= order; ++n) {
    for (TEnt& e : levels[n])
      for (int i = 0; i < n; ++i) e.ids[i] = remap[e.ids[i]];
    std::sort(levels[n].begin(), levels[n].end(),
              [n](const TEnt& a, const TEnt& b) {
                for (int i = n - 1; i >= 0; --i)
                  if (a.ids[i] != b.ids[i]) return a.ids[i] < b.ids[i];
                return false;
              });
  }

  // ---- next pointers (record i's children = [next[i], next[i+1]))
  std::vector<uint64_t> uni_next(bound + 1, 0);
  {
    const auto& kids = levels[2];
    size_t ci = 0;
    for (uint64_t wid = 0; wid < bound; ++wid) {
      uni_next[wid] = ci;
      while (ci < kids.size() && kids[ci].ids[1] == wid) ++ci;
    }
    uni_next[bound] = kids.size();
    if (ci != kids.size()) {
      set_error("internal: bigram with out-of-range newest word");
      return false;
    }
  }
  std::vector<std::vector<uint64_t>> nexts(order);
  for (int n = 2; n < order; ++n) {
    const auto& par = levels[n];
    const auto& kids = levels[n + 1];
    auto& nx = nexts[n];
    nx.assign(par.size() + 1, 0);
    size_t ci = 0;
    for (size_t pi = 0; pi < par.size(); ++pi) {
      nx[pi] = ci;
      while (ci < kids.size()) {
        bool eq = true;  // child's parent = its suffix (drop oldest word)
        for (int i = 0; i < n; ++i)
          if (kids[ci].ids[i + 1] != par[pi].ids[i]) { eq = false; break; }
        if (!eq) break;
        ++ci;
      }
    }
    nx[par.size()] = kids.size();
    if (ci != kids.size()) {
      set_error("internal: orphan n-gram after blank insertion");
      return false;
    }
  }

  // ---- quantization bins
  std::vector<std::vector<float>> mid_ptabs, mid_btabs;
  std::vector<float> long_tab;
  if (quant) {
    for (int n = 2; n < order; ++n) {
      std::vector<float> probs, bos;
      for (const TEnt& e : levels[n]) {
        probs.push_back(e.prob);
        if (e.backoff != 0.f) bos.push_back(e.backoff);
      }
      std::vector<float> pt(size_t(1) << prob_bits),
          bt(size_t(1) << backoff_bits);
      make_bins(probs, pt.data(), pt.size());
      bt[0] = -0.f;  // kNoExtensionBackoff
      bt[1] = 0.f;   // kExtensionBackoff
      make_bins(bos, bt.data() + 2, bt.size() - 2);
      mid_ptabs.push_back(std::move(pt));
      mid_btabs.push_back(std::move(bt));
    }
    std::vector<float> probs;
    for (const TEnt& e : levels[order]) probs.push_back(e.prob);
    long_tab.resize(size_t(1) << prob_bits);
    make_bins(probs, long_tab.data(), long_tab.size());
  }

  // ---- layout
  const uint8_t word_bits = required_bits(counts[0]);
  const uint8_t mid_qbits = quant ? uint8_t(prob_bits + backoff_bits)
                                  : uint8_t(63);
  size_t off = header_size(order);
  const size_t off_vocab = off;
  off += 8 + 8 * counts[0];
  const size_t off_quant = off;
  if (quant)
    off += 8 +
           (size_t(order) - 2) * (((size_t(1) << prob_bits) +
                                   (size_t(1) << backoff_bits)) * 4) +
           (size_t(1) << prob_bits) * 4;
  const size_t off_uni = off;
  off += (counts[0] + 2) * 16;
  struct MidPlan {
    size_t bh_off = 0, bits_off = 0;
    uint8_t next_bits = 0, total_bits = 0;
    uint64_t bh_count = 0;
  };
  std::vector<MidPlan> plan(order > 2 ? order - 2 : 0);
  for (int n = 2; n < order; ++n) {
    MidPlan& mp = plan[n - 2];
    const uint64_t max_next = counts[n];
    mp.bh_off = off;
    if (array) {
      const uint8_t chop =
          chop_bits(counts[n - 1] + 1, max_next, uint8_t(bhiksha_bits));
      mp.next_bits = uint8_t(required_bits(max_next) - chop);
      mp.bh_count = (max_next >> mp.next_bits) + 1;
      off += 8 * (1 + mp.bh_count);
    } else {
      mp.next_bits = required_bits(max_next);
      off += 8;  // DontBhiksha slack word
    }
    mp.total_bits = uint8_t(word_bits + mid_qbits + mp.next_bits);
    mp.bits_off = off;
    off += (size_t(counts[n - 1] + 1) * mp.total_bits + 7) / 8 + 8;
  }
  const uint8_t long_qbits = quant ? uint8_t(prob_bits) : 31;
  const uint8_t long_total = uint8_t(word_bits + long_qbits);
  const size_t off_long = off;
  off += (size_t(counts[order - 1] + 1) * long_total + 7) / 8 + 8;

  std::vector<char> out(off, 0);
  char* p = out.data();
  // header (Sanity + FixedWidthParameters + counts)
  std::memcpy(p, kMagicBytes, kMagicLen);
  const float f0 = 0.f, f1 = 1.f, fm = -0.5f;
  std::memcpy(p + kMagicField, &f0, 4);
  std::memcpy(p + kMagicField + 4, &f1, 4);
  std::memcpy(p + kMagicField + 8, &fm, 4);
  const uint32_t one32 = 1, max32 = 0xffffffffu;
  std::memcpy(p + kMagicField + 12, &one32, 4);
  std::memcpy(p + kMagicField + 16, &max32, 4);
  const uint64_t one64 = 1;
  std::memcpy(p + kSanitySize - 8, &one64, 8);
  char* fp = p + kSanitySize;
  fp[0] = char(order);
  std::memcpy(fp + 4, &kProbingMultiplier, 4);
  std::memcpy(fp + 8, &model_type, 4);
  fp[12] = 0;  // has_vocabulary = false
  const uint32_t search_version = 1;  // TrieSearch::kVersion
  std::memcpy(fp + 16, &search_version, 4);
  for (int i = 0; i < order; ++i)
    std::memcpy(p + kSanitySize + kFixedParamsSize + 8 * i, &counts[i], 8);
  // sorted vocab
  {
    const uint64_t stored = hashed.size();
    std::memcpy(p + off_vocab, &stored, 8);
    for (size_t j = 0; j < hashed.size(); ++j)
      std::memcpy(p + off_vocab + 8 + 8 * j, &hashed[j].first, 8);
  }
  // quant tables
  if (quant) {
    p[off_quant] = char(prob_bits);
    p[off_quant + 1] = char(backoff_bits);
    size_t toff = off_quant + 8;
    for (int n = 2; n < order; ++n) {
      std::memcpy(p + toff, mid_ptabs[n - 2].data(),
                  mid_ptabs[n - 2].size() * 4);
      toff += mid_ptabs[n - 2].size() * 4;
      std::memcpy(p + toff, mid_btabs[n - 2].data(),
                  mid_btabs[n - 2].size() * 4);
      toff += mid_btabs[n - 2].size() * 4;
    }
    std::memcpy(p + toff, long_tab.data(), long_tab.size() * 4);
  }
  // unigram: prob/backoff reordered to sorted-vocab ids + next pointers
  {
    std::vector<Entry> uni(bound);
    if (m->has_unk) {
      NgramKey k;
      k.len = 1;
      k.ids[0] = m->unk_id;
      uni[0] = m->grams.at(k);
    } else {
      uni[0].logp = -100.f;  // kenlm's unknown_missing_logprob
    }
    for (size_t j = 0; j < hashed.size(); ++j) {
      NgramKey k;
      k.len = 1;
      k.ids[0] = hashed[j].second;
      uni[j + 1] = m->grams.at(k);
    }
    for (uint64_t wid = 0; wid <= bound; ++wid) {
      char* u = p + off_uni + wid * 16;
      if (wid < bound) {
        std::memcpy(u, &uni[wid].logp, 4);
        std::memcpy(u + 4, &uni[wid].backoff, 4);
      }
      std::memcpy(u + 8, &uni_next[wid], 8);
    }
  }
  // middles
  for (int n = 2; n < order; ++n) {
    const MidPlan& mp = plan[n - 2];
    char* bits = p + mp.bits_off;
    const auto& ents = levels[n];
    const auto& nx = nexts[n];
    uint64_t bh_filled = 1;  // offsets[0] stays 0
    if (array) {
      p[mp.bh_off] = 0;  // kArrayBhikshaVersion
      p[mp.bh_off + 1] = char(bhiksha_bits);
    }
    auto write_next = [&](uint64_t i, uint64_t value) {
      write_bits(bits, (i + 1) * mp.total_bits - mp.next_bits,
                 mp.next_bits, value);
      if (array) {
        const uint64_t high =
            mp.next_bits >= 64 ? 0 : (value >> mp.next_bits);
        while (bh_filled <= high) {
          std::memcpy(p + mp.bh_off + 8 + 8 * bh_filled, &i, 8);
          ++bh_filled;
        }
      }
    };
    for (size_t i = 0; i < ents.size(); ++i) {
      const uint64_t bit = i * mp.total_bits;
      write_bits(bits, bit, word_bits, ents[i].ids[0]);
      if (quant) {
        const uint64_t pq = bins_encode(mid_ptabs[n - 2].data(),
                                        mid_ptabs[n - 2].size(),
                                        ents[i].prob, 0);
        const uint64_t bq = bins_encode_backoff(mid_btabs[n - 2].data(),
                                                mid_btabs[n - 2].size(),
                                                ents[i].backoff);
        write_bits(bits, bit + word_bits, mid_qbits,
                   (pq << backoff_bits) | bq);
      } else {
        write_npf31(bits, bit + word_bits, ents[i].prob);
        write_f32b(bits, bit + word_bits + 31, ents[i].backoff);
      }
      write_next(i, nx[i]);
    }
    write_next(ents.size(), nx[ents.size()]);  // terminator
    if (array) {
      const uint64_t tail = ents.size() + 1;  // > any queried index
      while (bh_filled <= mp.bh_count - 1) {
        std::memcpy(p + mp.bh_off + 8 + 8 * bh_filled, &tail, 8);
        ++bh_filled;
      }
    }
  }
  // longest
  {
    char* bits = p + off_long;
    const auto& ents = levels[order];
    for (size_t i = 0; i < ents.size(); ++i) {
      const uint64_t bit = i * long_total;
      write_bits(bits, bit, word_bits, ents[i].ids[0]);
      if (quant)
        write_bits(bits, bit + word_bits, long_qbits,
                   bins_encode(long_tab.data(), long_tab.size(),
                               ents[i].prob, 0));
      else
        write_npf31(bits, bit + word_bits, ents[i].prob);
    }
  }

  FILE* f = std::fopen(path, "wb");
  if (!f) {
    set_error(std::string("cannot open for write: ") + path);
    return false;
  }
  const bool ok = std::fwrite(out.data(), 1, out.size(), f) == out.size();
  std::fclose(f);
  if (!ok) set_error("short write");
  return ok;
}

// ---------------------------------------------------------------------------
// tagged handle: every C ABI entry point dispatches ARPA vs binary
// ---------------------------------------------------------------------------
struct Handle {
  Model* arpa = nullptr;
  BinModel* bin = nullptr;
  TrieModel* trie = nullptr;

  int order() const {
    return arpa ? arpa->order : (bin ? bin->order : trie->order);
  }
  uint32_t bos() const {
    return arpa ? arpa->bos_id : (bin ? bin->bos_id : trie->bos_id);
  }
  uint32_t eos() const {
    return arpa ? arpa->eos_id : (bin ? bin->eos_id : trie->eos_id);
  }
  double one(const uint32_t* ctx, int len, uint32_t w) const {
    if (arpa) return score_one(arpa, ctx, len, w);
    if (bin) return bin_score_one(bin, ctx, len, w);
    return trie_score_one(trie, ctx, len, w);
  }
};

// ---------------------------------------------------------------------------
// n-gram enumeration (the on-device LM build, lm/device_ngram.py): every
// order-k entry as (ngram_hash key, prob, backoff) in the MODEL'S id
// space — uniform across the text/probing/trie backends.  k==1 keys are
// the word id itself (the device keeps unigrams as a plain id-keyed
// table; bin/trie store them as id-indexed arrays anyway).
// ---------------------------------------------------------------------------
struct DumpSink {
  uint32_t* hi;
  uint32_t* lo;
  float* prob;
  float* backoff;
  int64_t cap;      // buffer capacity; emit() keeps counting past it
  int64_t n = 0;

  void emit(uint64_t key, float p, float b) {
    if (n < cap) {
      hi[n] = uint32_t(key >> 32);
      lo[n] = uint32_t(key);
      prob[n] = p;
      backoff[n] = b;
    }
    ++n;
  }
};

void dump_text(const Model* m, int k, DumpSink* s) {
  for (const auto& kv : m->grams) {
    if (kv.first.len != k) continue;
    const uint64_t key = (k == 1) ? kv.first.ids[0]
                                  : ngram_hash(kv.first.ids, k);
    s->emit(key, kv.second.logp, kv.second.backoff);
  }
}

void dump_bin(const BinModel* m, int k, DumpSink* s) {
  if (k == 1) {
    // ids run 0..counts[0] (bin_score_one's bound); 8B prob/backoff pairs
    for (uint64_t w = 0; w <= m->counts[0]; ++w) {
      float p, b;
      std::memcpy(&p, m->unigram + size_t(w) * 8, 4);
      std::memcpy(&b, m->unigram + size_t(w) * 8 + 4, 4);
      s->emit(w, p, b);
    }
    return;
  }
  const BinTable& t = (k == m->order) ? m->longest : m->mid[k - 2];
  for (uint64_t i = 0; i < t.buckets; ++i) {
    const char* e = t.base + i * t.entry_size;
    uint64_t key;
    std::memcpy(&key, e, 8);
    if (key == 0) continue;                       // empty bucket
    float p, b = 0.f;
    std::memcpy(&p, e + 8, 4);
    if (t.entry_size >= 16) std::memcpy(&b, e + 12, 4);
    s->emit(key, p, b);
  }
}

// suffix-first DFS: depth d's record stores word w_{k-d}; the final
// record (depth k-1) carries the k-gram's prob/backoff
void dump_trie_rec(const TrieModel* m, int k, int depth, uint64_t b,
                   uint64_t e, uint32_t* words, DumpSink* s) {
  const bool last = depth == k - 1;
  if (k == m->order && last) {
    for (uint64_t i = b; i < e; ++i) {
      words[0] = uint32_t(read_bits(m->longest.bits,
                                    i * m->longest.total_bits,
                                    m->longest.word_bits));
      s->emit(ngram_hash(words, k), trie_longest_prob(m, i), 0.f);
    }
    return;
  }
  const TrieLevel& L = m->mid[depth - 1];
  for (uint64_t i = b; i < e; ++i) {
    words[k - 1 - depth] = uint32_t(read_bits(L.bits, i * L.total_bits,
                                              L.word_bits));
    float p, bo;
    uint64_t cb, ce;
    trie_mid_read(m, L, i, &p, &bo, &cb, &ce);
    if (last) s->emit(ngram_hash(words, k), p, bo);
    else if (cb < ce) dump_trie_rec(m, k, depth + 1, cb, ce, words, s);
  }
}

void dump_trie(const TrieModel* m, int k, DumpSink* s) {
  if (k == 1) {
    for (uint32_t w = 0; w < m->bound; ++w) {
      float p, bo;
      trie_unigram_at(m, w, &p, &bo, nullptr, nullptr);
      s->emit(w, p, bo);
    }
    return;
  }
  uint32_t words[kMaxOrder];
  for (uint32_t w = 0; w < m->bound; ++w) {
    uint64_t b, e;
    trie_unigram_at(m, w, nullptr, nullptr, &b, &e);
    if (b >= e) continue;
    words[k - 1] = w;
    dump_trie_rec(m, k, 1, b, e, words, s);
  }
}

double score_ids_h(const Handle* h, const uint32_t* ids, int n, int bos,
                   int eos) {
  uint32_t ctx[2 * kMaxOrder];
  int ctx_len = 0;
  if (bos) ctx[ctx_len++] = h->bos();
  double total = 0.0;
  for (int i = 0; i < n; ++i) {
    total += h->one(ctx, ctx_len, ids[i]);
    uint32_t nxt[kMaxOrder];
    int nlen = 0;
    advance_state_impl(h->order(), ctx, ctx_len, ids[i], nxt, &nlen);
    std::memcpy(ctx, nxt, nlen * sizeof(uint32_t));
    ctx_len = nlen;
  }
  if (eos) total += h->one(ctx, ctx_len, h->eos());
  return total;
}

}  // namespace

extern "C" {

const char* lm_last_error() { return g_error.c_str(); }

void* lm_load_arpa(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) { set_error(std::string("cannot open: ") + path); return nullptr; }
  // auto-detect: kenlm binaries start with the mmap magic
  char magic[8] = {0};
  size_t got = std::fread(magic, 1, 7, f);
  std::rewind(f);
  if (got == 7 && std::memcmp(magic, "mmap lm", 7) == 0) {
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::rewind(f);
    std::vector<char> image(static_cast<size_t>(size), 0);
    if (std::fread(image.data(), 1, image.size(), f) != image.size()) {
      std::fclose(f);
      set_error("short read");
      return nullptr;
    }
    std::fclose(f);
    HeaderInfo hi;
    if (!parse_header(image, &hi)) return nullptr;
    Handle* h = new Handle();
    if (hi.model_type == 0) {
      h->bin = load_probing(std::move(image), hi);
      if (h->bin) return h;
    } else if (hi.model_type >= 2 && hi.model_type <= 5) {
      h->trie = load_trie(std::move(image), hi);
      if (h->trie) return h;
    } else {
      set_error("kenlm binary model_type " + std::to_string(hi.model_type) +
                " (REST_PROBING) stores rest costs, not conditional "
                "probabilities, and is not supported; rebuild with "
                "`build_binary probing|trie in.arpa out.klm` or load the "
                "ARPA directly.");
    }
    delete h;
    return nullptr;
  }
  Model* m = new Model();
  bool ok = parse_arpa(m, f);
  std::fclose(f);
  if (!ok) { delete m; set_error("ARPA parse failed"); return nullptr; }
  Handle* h = new Handle();
  h->arpa = m;
  return h;
}

// write an ARPA-loaded model as a kenlm PROBING binary (.klm)
int32_t lm_write_binary(void* hv, const char* path) {
  Handle* h = static_cast<Handle*>(hv);
  if (!h->arpa) { set_error("write_binary needs an ARPA-loaded model");
                  return 0; }
  return write_binary(h->arpa, path) ? 1 : 0;
}

// write an ARPA-loaded model as any supported kenlm layout:
//   model_type 0 = PROBING (prob/backoff/bhiksha params ignored),
//   2 = TRIE, 3 = QUANT_TRIE, 4 = ARRAY_TRIE, 5 = QUANT_ARRAY_TRIE
int32_t lm_write_binary_ex(void* hv, const char* path, int32_t model_type,
                           int32_t prob_bits, int32_t backoff_bits,
                           int32_t bhiksha_bits) {
  Handle* h = static_cast<Handle*>(hv);
  if (!h->arpa) { set_error("write_binary needs an ARPA-loaded model");
                  return 0; }
  if (model_type == 0) return write_binary(h->arpa, path) ? 1 : 0;
  if (model_type < 2 || model_type > 5) {
    set_error("unsupported model_type " + std::to_string(model_type));
    return 0;
  }
  return write_trie(h->arpa, path, model_type, prob_bits, backoff_bits,
                    bhiksha_bits) ? 1 : 0;
}

// -1 = ARPA-loaded; otherwise the kenlm binary model_type (0 PROBING,
// 2 TRIE, 3 QUANT_TRIE, 4 ARRAY_TRIE, 5 QUANT_ARRAY_TRIE)
int32_t lm_model_type(void* hv) {
  Handle* h = static_cast<Handle*>(hv);
  if (h->arpa) return -1;
  if (h->bin) return 0;
  return h->trie->model_type;
}

void lm_free(void* hv) {
  Handle* h = static_cast<Handle*>(hv);
  delete h->arpa;
  delete h->bin;
  delete h->trie;
  delete h;
}

int32_t lm_order(void* h) { return static_cast<Handle*>(h)->order(); }

int64_t lm_num_ngrams(void* hv) {
  Handle* h = static_cast<Handle*>(hv);
  if (h->arpa) return static_cast<int64_t>(h->arpa->grams.size());
  const uint64_t* counts = h->bin ? h->bin->counts : h->trie->counts;
  const int order = h->bin ? h->bin->order : h->trie->order;
  int64_t total = 0;
  for (int i = 0; i < order; ++i) total += static_cast<int64_t>(counts[i]);
  return total;
}

// enumerate every order-k entry as (ngram_hash key hi/lo, prob, backoff)
// in the model's id space (k==1 keys are the word id itself); fills the
// caller's buffers up to `cap` rows and returns the TOTAL entry count,
// so a cap=0 call sizes the buffers.  Uniform across text/probing/trie —
// the on-device LM build (lm/device_ngram.py) consumes this.
int64_t lm_dump_order(void* hv, int32_t k, uint32_t* hi, uint32_t* lo,
                      float* prob, float* backoff, int64_t cap) {
  Handle* h = static_cast<Handle*>(hv);
  if (k < 1 || k > h->order()) { set_error("dump: order out of range");
                                 return -1; }
  DumpSink s{hi, lo, prob, backoff, cap};
  if (h->arpa) dump_text(h->arpa, k, &s);
  else if (h->bin) dump_bin(h->bin, k, &s);
  else dump_trie(h->trie, k, &s);
  return s.n;
}

// 1 iff every n-gram's (n-1)-word PREFIX context is itself an entry —
// the ARPA "context property" kenlm's own builder/loader enforce (a
// retained n-gram's context is never pruned away), which
// lm/device_ngram.py uses to gate its high-order probe gathers
// (reference model.py:1182-1194 scores through kenlm, whose lookups
// assume exactly this).  ARPA-loaded models are checked exactly over
// the id-tuple table; kenlm binaries return 1 (probing binaries store
// only 64-bit hashes, so the check is impossible there — and
// unnecessary: a kenlm-built binary violating the property cannot be
// produced).
int32_t lm_context_property(void* hv) {
  Handle* h = static_cast<Handle*>(hv);
  if (!h->arpa) return 1;
  const Model* m = h->arpa;
  for (const auto& kv : m->grams) {
    const int n = kv.first.len;
    if (n < 2) continue;
    NgramKey ctx;
    ctx.len = static_cast<uint8_t>(n - 1);
    std::memcpy(ctx.ids, kv.first.ids, (n - 1) * sizeof(uint32_t));
    if (m->grams.find(ctx) == m->grams.end()) return 0;
  }
  return 1;
}

// returns id, or the <unk> id for OOV (-1 if no <unk> in an ARPA model;
// binary models always resolve misses to 0 like kenlm)
int64_t lm_vocab_id(void* hv, const char* word) {
  Handle* h = static_cast<Handle*>(hv);
  if (h->bin)
    return bin_vocab_id(h->bin, word, std::strlen(word));
  if (h->trie)
    return trie_vocab_id(h->trie, word, std::strlen(word));
  Model* m = h->arpa;
  auto it = m->vocab.find(word);
  if (it != m->vocab.end()) return it->second;
  return m->has_unk ? static_cast<int64_t>(m->unk_id) : -1;
}

double lm_score_ids(void* h, const uint32_t* ids, int32_t n, int32_t bos,
                    int32_t eos) {
  return score_ids_h(static_cast<Handle*>(h), ids, n, bos, eos);
}

// Batched scoring: sentences given as a flat id array + offsets[n+1].
void lm_score_batch(void* hv, const uint32_t* flat, const int64_t* offsets,
                    int32_t n_sents, int32_t bos, int32_t eos, double* out) {
  Handle* h = static_cast<Handle*>(hv);
  for (int32_t i = 0; i < n_sents; ++i) {
    out[i] = score_ids_h(h, flat + offsets[i],
                         static_cast<int>(offsets[i + 1] - offsets[i]), bos,
                         eos);
  }
}

int32_t lm_state_capacity(void* h) {
  return static_cast<Handle*>(h)->order() - 1;
}

// Incremental API (kenlm BaseScore parity, reference model.py:1131-1180).
// in_state/out_state are caller-owned uint32 buffers of lm_state_capacity.
double lm_base_score(void* hv, const uint32_t* in_state, int32_t in_len,
                     uint32_t word, uint32_t* out_state, int32_t* out_len) {
  Handle* h = static_cast<Handle*>(hv);
  double s = h->one(in_state, in_len, word);
  advance_state_impl(h->order(), in_state, in_len, word, out_state, out_len);
  return s;
}

uint32_t lm_bos_id(void* h) { return static_cast<Handle*>(h)->bos(); }
uint32_t lm_eos_id(void* h) { return static_cast<Handle*>(h)->eos(); }

// Batched incremental scoring: n independent (state, word) pairs in one
// FFI crossing (for first-pass-LM beam decode, where every beam scores
// topn candidate continuations per step).
//   states:  [n, cap] uint32, lengths in state_lens
//   words:   [n]
//   out:     [n] log10 scores
// States are NOT advanced (candidates are hypothetical); use
// lm_advance_batch for the chosen survivors.
void lm_base_score_batch(void* hv, const uint32_t* states,
                         const int32_t* state_lens, int32_t cap,
                         const uint32_t* words, int32_t n, double* out) {
  Handle* h = static_cast<Handle*>(hv);
  for (int32_t i = 0; i < n; ++i) {
    out[i] = h->one(states + static_cast<int64_t>(i) * cap,
                    state_lens[i], words[i]);
  }
}

// Advance n states by one word each, in place.
void lm_advance_batch(void* hv, uint32_t* states, int32_t* state_lens,
                      int32_t cap, const uint32_t* words, int32_t n) {
  Handle* h = static_cast<Handle*>(hv);
  int order = h->order();
  for (int32_t i = 0; i < n; ++i) {
    uint32_t nxt[kMaxOrder];
    int nlen = 0;
    uint32_t* s = states + static_cast<int64_t>(i) * cap;
    advance_state_impl(order, s, state_lens[i], words[i], nxt, &nlen);
    std::memcpy(s, nxt, nlen * sizeof(uint32_t));
    state_lens[i] = nlen;
  }
}

}  // extern "C"
