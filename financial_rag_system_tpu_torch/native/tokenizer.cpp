// Fast host-side tokenizer — native counterpart of models/tokenizer.py.
//
// Tokenization is the serving shell's hottest host path (every query and
// every reranked pair crosses it); the reference outsourced it to HF's
// Rust tokenizers inside sentence-transformers.  This library implements
// the same two vocab modes as the Python tokenizer with exact output
// parity on ASCII text (the Python side falls back for non-ASCII):
//
//  - hash vocab: crc32("w:"+word) whole-word id + crc32("##"+4-char-piece)
//    ids, matching zlib.crc32 (models/tokenizer.py HashVocab)
//  - wordpiece vocab: greedy longest-match against a vocab.txt table
//    (models/tokenizer.py WordPieceVocab)
//
// C ABI for ctypes; no external dependencies.
//
// Build: g++ -O3 -shared -fPIC -o libfrs_tokenizer.so tokenizer.cpp

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr int UNK_ID = 100;

// --- crc32 (zlib polynomial, matches Python's zlib.crc32) -----------------

uint32_t crc_table[256];
bool crc_init_done = false;

void crc_init() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++)
      c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
  crc_init_done = true;
}

uint32_t crc32(const char* data, size_t len) {
  if (!crc_init_done) crc_init();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; i++)
    c = crc_table[(c ^ (uint8_t)data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// --- character classes (ASCII; mirrors models/tokenizer.py exactly) --------

inline bool is_space(unsigned char c) {
  // Python str.isspace() for ASCII: \t\n\v\f\r, space, \x1c-\x1f
  return c == ' ' || (c >= 0x09 && c <= 0x0d) || (c >= 0x1c && c <= 0x1f);
}

inline bool is_punct(unsigned char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

inline bool is_control(unsigned char c) { return c < 0x20 || c == 0x7f; }

struct Tokenizer {
  // hash-vocab parameters (vocab_size <= 0 => wordpiece mode)
  int vocab_size = 0;
  int piece_len = 4;
  // wordpiece table
  std::unordered_map<std::string, int32_t> vocab;
  int max_chars_per_word = 100;

  int32_t hash_id(const std::string& tag) const {
    return 1000 + (int32_t)(crc32(tag.data(), tag.size()) %
                            (uint32_t)(vocab_size - 1000));
  }

  // append ids for one lowercase word; returns count appended
  int word_ids(const std::string& w, std::vector<int32_t>& out) const {
    if (vocab_size > 0) {  // hash mode
      size_t before = out.size();
      std::string tag = "w:" + w;
      out.push_back(hash_id(tag));
      if ((int)w.size() > piece_len) {
        for (size_t i = 0; i < w.size(); i += piece_len) {
          std::string piece = "##" + w.substr(i, piece_len);
          out.push_back(hash_id(piece));
        }
      }
      return (int)(out.size() - before);
    }
    // wordpiece greedy longest-match
    if ((int)w.size() > max_chars_per_word) {
      out.push_back(UNK_ID);
      return 1;
    }
    size_t before = out.size();
    size_t start = 0;
    while (start < w.size()) {
      size_t end = w.size();
      int32_t cur = -1;
      while (start < end) {
        std::string sub = w.substr(start, end - start);
        if (start > 0) sub = "##" + sub;
        auto it = vocab.find(sub);
        if (it != vocab.end()) { cur = it->second; break; }
        end--;
      }
      if (cur < 0) {
        out.resize(before);
        out.push_back(UNK_ID);
        return 1;
      }
      out.push_back(cur);
      start = end;
    }
    return (int)(out.size() - before);
  }

  // basic tokenize + id mapping over ASCII text
  void tokenize(const char* text, size_t len, std::vector<int32_t>& out) const {
    std::string word;
    auto flush = [&]() {
      if (!word.empty()) { word_ids(word, out); word.clear(); }
    };
    for (size_t i = 0; i < len; i++) {
      unsigned char c = (unsigned char)text[i];
      if (is_space(c)) {
        flush();
      } else if (is_punct(c)) {
        flush();
        std::string p(1, (char)c);
        word_ids(p, out);
      } else if (is_control(c)) {
        // skipped (category C), same as the Python basic tokenizer
      } else {
        word.push_back((char)((c >= 'A' && c <= 'Z') ? c + 32 : c));
      }
    }
    flush();
  }
};

}  // namespace

extern "C" {

void* frs_tokenizer_create_hash(int vocab_size, int piece_len) {
  auto* t = new Tokenizer();
  t->vocab_size = vocab_size;
  t->piece_len = piece_len;
  return t;
}

// vocab_blob: the full contents of a vocab.txt ('\n'-separated)
void* frs_tokenizer_create_wordpiece(const char* vocab_blob) {
  auto* t = new Tokenizer();
  t->vocab_size = 0;
  const char* p = vocab_blob;
  int32_t idx = 0;
  while (*p) {
    const char* nl = strchr(p, '\n');
    size_t len = nl ? (size_t)(nl - p) : strlen(p);
    t->vocab.emplace(std::string(p, len), idx++);
    if (!nl) break;
    p = nl + 1;
  }
  return t;
}

// Tokenize one text; writes up to max_out ids; returns the number written
// (the id stream is truncated, not failed, when max_out is hit).
int frs_tokenize(void* handle, const char* text, int text_len,
                 int32_t* out, int max_out) {
  auto* t = (Tokenizer*)handle;
  std::vector<int32_t> ids;
  ids.reserve(256);
  t->tokenize(text, (size_t)text_len, ids);
  int n = (int)ids.size() < max_out ? (int)ids.size() : max_out;
  memcpy(out, ids.data(), (size_t)n * sizeof(int32_t));
  return n;
}

void frs_tokenizer_destroy(void* handle) { delete (Tokenizer*)handle; }

}  // extern "C"
