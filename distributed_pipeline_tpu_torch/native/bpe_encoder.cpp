// Native BPE encoder: the host-side tokenization loop in C++, a copy of the
// JAX package's native/bpe_encoder.cpp (the port builds its own copy and
// imports nothing of that package).
//
// The jsonl data path tokenizes with a BPE (data/tokenizer.py) whose
// per-word merge loop is the slowest host-side code of the input pipeline;
// this file runs the same greedy lowest-rank merge procedure behind a C ABI
// read through ctypes.
//
// Parity contract with data/tokenizer.py:BPEVocab:
//   * the caller (Python) performs the Unicode whitespace split
//     (str.split()) and sends words joined by '\n' — C++ never re-implements
//     Python's whitespace semantics;
//   * a word is split into Unicode code points (not bytes) + the "</w>"
//     end-of-word marker, then adjacent pairs merge greedily by lowest
//     merge-table rank, ties broken by leftmost position — identical to
//     BPEVocab._bpe_word;
//   * symbols found in the vocab map to their id; out-of-alphabet symbols
//     are reported as -(k+1) sentinels referencing a persistent OOV table
//     the caller resolves with its own stable hash (blake2s) — so the
//     fallback contract stays byte-identical with the Python path.
//
// Table wire format (built by native/__init__.py, little-endian):
//   u32 magic 0x45504254 ("TBPE")  u32 version=1
//   u32 n_merges  then per merge:  u32 len_a, bytes a, u32 len_b, bytes b
//   u32 n_vocab   then per entry:  u32 len_s, bytes s, i32 id
//
// Build: g++ -O2 -std=c++17 -shared -fPIC, at first use by
// native/__init__.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x45504254u;  // "TBPE"
constexpr uint32_t kVersion = 1u;
const std::string kEOW = "</w>";

// Open-vocabulary corpora (IDs, numbers, typos) produce unbounded distinct
// words; the memo tables are flushed past this size so a multi-day run's
// host memory stays bounded (the flush happens between encode calls, when
// no OOV sentinel is outstanding — see dpt_bpe_encode).
constexpr size_t kWordCacheCap = 1u << 16;

struct Encoder {
  std::unordered_map<std::string, int32_t> ranks;  // key: len(a)|a|b
  std::unordered_map<std::string, int32_t> vocab;
  // word -> encoded ids (OOV entries already as -(k+1) sentinels into
  // oov_symbols; flushed together with the OOV tables).
  std::unordered_map<std::string, std::vector<int32_t>> word_cache;
  std::vector<std::string> oov_symbols;
  std::unordered_map<std::string, int64_t> oov_index;
  std::mutex mu;  // encode() may be called from several loader threads
};

// Unambiguous pair key: 4-byte little-endian length of `a`, then a, then b
// (symbols may in principle contain any byte, so a separator would be
// ambiguous).
std::string PairKey(const std::string& a, const std::string& b) {
  uint32_t la = static_cast<uint32_t>(a.size());
  std::string k;
  k.reserve(4 + a.size() + b.size());
  k.append(reinterpret_cast<const char*>(&la), 4);
  k += a;
  k += b;
  return k;
}

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  template <typename T>
  T Get() {
    T v{};
    if (p + sizeof(T) > end) {
      ok = false;
      return v;
    }
    std::memcpy(&v, p, sizeof(T));
    p += sizeof(T);
    return v;
  }

  std::string GetStr() {
    uint32_t n = Get<uint32_t>();
    if (!ok || p + n > end) {
      ok = false;
      return {};
    }
    std::string s(reinterpret_cast<const char*>(p), n);
    p += n;
    return s;
  }
};

// Split a UTF-8 word into code-point symbols (mirrors Python's list(word)).
// Input comes UTF-8-encoded from a valid Python str; a malformed lead byte
// is still handled (consumed as a single-byte symbol) so we can never run
// off the buffer.
void SplitCodepoints(const char* s, size_t n, std::vector<std::string>* out) {
  size_t i = 0;
  while (i < n) {
    unsigned char c = static_cast<unsigned char>(s[i]);
    size_t len = 1;
    if (c >= 0xF0) {
      len = 4;
    } else if (c >= 0xE0) {
      len = 3;
    } else if (c >= 0xC0) {
      len = 2;
    }
    if (i + len > n) len = 1;
    out->emplace_back(s + i, len);
    i += len;
  }
}

// Greedy merge identical to BPEVocab._bpe_word: repeatedly merge the
// adjacent pair with the lowest rank (leftmost on ties) until none remains.
void BpeWord(const Encoder& enc, std::vector<std::string>* seq) {
  while (seq->size() > 1) {
    int best = -1;
    int32_t best_rank = 0;
    for (size_t i = 0; i + 1 < seq->size(); ++i) {
      auto it = enc.ranks.find(PairKey((*seq)[i], (*seq)[i + 1]));
      if (it != enc.ranks.end() &&
          (best < 0 || it->second < best_rank)) {
        best = static_cast<int>(i);
        best_rank = it->second;
      }
    }
    if (best < 0) break;
    (*seq)[best] += (*seq)[best + 1];
    seq->erase(seq->begin() + best + 1);
  }
}

void EncodeWord(Encoder* enc, const char* s, size_t n,
                std::vector<int32_t>* out) {
  std::string word(s, n);
  auto cached = enc->word_cache.find(word);
  if (cached != enc->word_cache.end()) {
    out->insert(out->end(), cached->second.begin(), cached->second.end());
    return;
  }
  std::vector<std::string> seq;
  SplitCodepoints(s, n, &seq);
  seq.push_back(kEOW);
  BpeWord(*enc, &seq);
  std::vector<int32_t> ids;
  ids.reserve(seq.size());
  for (const auto& sym : seq) {
    auto it = enc->vocab.find(sym);
    if (it != enc->vocab.end()) {
      ids.push_back(it->second);
    } else {
      auto [oit, inserted] = enc->oov_index.try_emplace(
          sym, static_cast<int64_t>(enc->oov_symbols.size()));
      if (inserted) enc->oov_symbols.push_back(sym);
      ids.push_back(static_cast<int32_t>(-(oit->second + 1)));
    }
  }
  out->insert(out->end(), ids.begin(), ids.end());
  enc->word_cache.emplace(std::move(word), std::move(ids));
}

}  // namespace

extern "C" {

// Parse the wire-format table; returns nullptr on malformed input.
void* dpt_bpe_create(const uint8_t* blob, uint64_t len) {
  Reader r{blob, blob + len};
  if (r.Get<uint32_t>() != kMagic || r.Get<uint32_t>() != kVersion ||
      !r.ok) {
    return nullptr;
  }
  auto enc = new Encoder();
  uint32_t n_merges = r.Get<uint32_t>();
  for (uint32_t i = 0; i < n_merges && r.ok; ++i) {
    std::string a = r.GetStr();
    std::string b = r.GetStr();
    if (r.ok) enc->ranks.emplace(PairKey(a, b), static_cast<int32_t>(i));
  }
  uint32_t n_vocab = r.Get<uint32_t>();
  for (uint32_t i = 0; i < n_vocab && r.ok; ++i) {
    std::string s = r.GetStr();
    int32_t id = r.Get<int32_t>();
    if (r.ok) enc->vocab.emplace(std::move(s), id);
  }
  if (!r.ok || r.p != r.end) {
    delete enc;
    return nullptr;
  }
  return enc;
}

void dpt_bpe_destroy(void* h) { delete static_cast<Encoder*>(h); }

// Encode '\n'-separated words (already whitespace-split by the caller).
// Writes up to `cap` ids into `out`; RETURNS the total id count, which may
// exceed `cap` (caller retries with a larger buffer — nothing past `cap`
// is written). Ids >= 0 are vocab ids; id == -(k+1) refers to OOV symbol k
// (dpt_bpe_oov_get). Sentinels are only guaranteed resolvable until the
// NEXT encode call (which may flush the memo tables) — the caller must
// resolve them immediately, before encoding anything else on this handle.
int64_t dpt_bpe_encode(void* h, const uint8_t* text, uint64_t text_len,
                       int32_t* out, int64_t cap) {
  auto enc = static_cast<Encoder*>(h);
  std::lock_guard<std::mutex> lock(enc->mu);
  if (enc->word_cache.size() > kWordCacheCap) {
    enc->word_cache.clear();
    enc->oov_symbols.clear();
    enc->oov_index.clear();
  }
  std::vector<int32_t> ids;
  ids.reserve(text_len / 2 + 8);
  const char* s = reinterpret_cast<const char*>(text);
  size_t start = 0;
  size_t words = 0;
  for (size_t i = 0; i <= text_len; ++i) {
    if (i == text_len || s[i] == '\n') {
      if (i > start) {
        EncodeWord(enc, s + start, i - start, &ids);
        // Re-check the memo cap inside huge single-call texts too. Only
        // word_cache may flush mid-call: OOV sentinels already emitted
        // into `ids` THIS call reference oov_symbols, so those tables
        // flush only between calls (entry check above) — one call's OOV
        // growth is bounded by its distinct unknown words.
        if ((++words & 0xfff) == 0 &&
            enc->word_cache.size() > kWordCacheCap) {
          enc->word_cache.clear();
        }
      }
      start = i + 1;
    }
  }
  int64_t n = static_cast<int64_t>(ids.size());
  if (n > 0 && cap > 0) {
    std::memcpy(out, ids.data(),
                static_cast<size_t>(std::min(n, cap)) * sizeof(int32_t));
  }
  return n;
}

int64_t dpt_bpe_oov_count(void* h) {
  auto enc = static_cast<Encoder*>(h);
  std::lock_guard<std::mutex> lock(enc->mu);
  return static_cast<int64_t>(enc->oov_symbols.size());
}

// Copy OOV symbol k (UTF-8) into buf; returns its byte length (call with
// cap=0 to size the buffer), or -1 if k is out of range.
int64_t dpt_bpe_oov_get(void* h, int64_t k, uint8_t* buf, int64_t cap) {
  auto enc = static_cast<Encoder*>(h);
  std::lock_guard<std::mutex> lock(enc->mu);
  if (k < 0 || k >= static_cast<int64_t>(enc->oov_symbols.size())) {
    return -1;
  }
  const std::string& s = enc->oov_symbols[static_cast<size_t>(k)];
  int64_t n = static_cast<int64_t>(s.size());
  if (cap > 0) {
    std::memcpy(buf, s.data(),
                static_cast<size_t>(std::min(n, cap)));
  }
  return n;
}

}  // extern "C"
