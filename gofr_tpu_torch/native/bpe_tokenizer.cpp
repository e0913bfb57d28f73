// Byte-level BPE tokenizer with a C ABI, for the serving runtime's ingress
// path (tokenization runs off the GIL). The port's copy of the reference's
// native/bpe_tokenizer.cpp; the Python binding is
// gofr_tpu_torch/serving/native_tokenizer.py, which also carries the
// pure-Python oracle the tests compare against.
//
// File formats (written by the Python side, see write_bpe_files):
//   vocab:  one token per line, hex-encoded bytes; line number = token id.
//   merges: "hexA hexB" per line; line number = merge rank (lower = earlier).
//
// Build: g++ -O2 -shared -fPIC -o libbpe.so bpe_tokenizer.cpp

#include <cstdint>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

std::string hex_decode(const std::string& hex) {
  std::string out;
  out.reserve(hex.size() / 2);
  for (size_t i = 0; i + 1 < hex.size(); i += 2) {
    auto nib = [](char c) -> int {
      if (c >= '0' && c <= '9') return c - '0';
      if (c >= 'a' && c <= 'f') return c - 'a' + 10;
      if (c >= 'A' && c <= 'F') return c - 'A' + 10;
      return -1;
    };
    int hi = nib(hex[i]), lo = nib(hex[i + 1]);
    if (hi < 0 || lo < 0) break;
    out.push_back(static_cast<char>((hi << 4) | lo));
  }
  return out;
}

struct PairHash {
  size_t operator()(const std::pair<std::string, std::string>& p) const {
    return std::hash<std::string>()(p.first) * 1000003u ^
           std::hash<std::string>()(p.second);
  }
};

struct Tokenizer {
  std::unordered_map<std::string, int32_t> vocab;
  std::vector<std::string> id_to_token;
  std::unordered_map<std::pair<std::string, std::string>, int32_t, PairHash>
      merge_rank;
};

}  // namespace

extern "C" {

void* bpe_create(const char* vocab_path, const char* merges_path) {
  auto* t = new Tokenizer();
  std::ifstream vf(vocab_path);
  if (!vf) {
    delete t;
    return nullptr;
  }
  std::string line;
  int32_t id = 0;
  while (std::getline(vf, line)) {
    std::string tok = hex_decode(line);
    t->vocab.emplace(tok, id);
    t->id_to_token.push_back(tok);
    ++id;
  }
  std::ifstream mf(merges_path);
  if (mf) {
    int32_t rank = 0;
    while (std::getline(mf, line)) {
      auto sp = line.find(' ');
      if (sp == std::string::npos) continue;
      t->merge_rank.emplace(
          std::make_pair(hex_decode(line.substr(0, sp)),
                         hex_decode(line.substr(sp + 1))),
          rank++);
    }
  }
  return t;
}

void bpe_free(void* h) { delete static_cast<Tokenizer*>(h); }

int32_t bpe_vocab_size(void* h) {
  return static_cast<int32_t>(static_cast<Tokenizer*>(h)->id_to_token.size());
}

// Greedy lowest-rank-first BPE over raw bytes. Returns the number of ids
// written, or -needed if out_cap is too small, or -1 on error.
int32_t bpe_encode(void* h, const char* text, int32_t text_len, int32_t* out,
                   int32_t out_cap) {
  auto* t = static_cast<Tokenizer*>(h);
  if (t == nullptr || text == nullptr) return -1;

  std::vector<std::string> symbols;
  symbols.reserve(text_len);
  for (int32_t i = 0; i < text_len; ++i) symbols.emplace_back(1, text[i]);

  while (symbols.size() > 1) {
    int32_t best_rank = INT32_MAX;
    size_t best_i = 0;
    for (size_t i = 0; i + 1 < symbols.size(); ++i) {
      auto it = t->merge_rank.find({symbols[i], symbols[i + 1]});
      if (it != t->merge_rank.end() && it->second < best_rank) {
        best_rank = it->second;
        best_i = i;
      }
    }
    if (best_rank == INT32_MAX) break;
    symbols[best_i] += symbols[best_i + 1];
    symbols.erase(symbols.begin() + best_i + 1);
  }

  // Map to ids; symbols missing from the vocab fall back to per-byte ids
  // (byte-level BPE vocabs always contain every single byte).
  std::vector<int32_t> ids;
  ids.reserve(symbols.size());
  for (const auto& s : symbols) {
    auto it = t->vocab.find(s);
    if (it != t->vocab.end()) {
      ids.push_back(it->second);
    } else {
      for (char c : s) {
        auto bt = t->vocab.find(std::string(1, c));
        ids.push_back(bt != t->vocab.end() ? bt->second : 0);
      }
    }
  }
  if (static_cast<int32_t>(ids.size()) > out_cap)
    return -static_cast<int32_t>(ids.size());
  std::memcpy(out, ids.data(), ids.size() * sizeof(int32_t));
  return static_cast<int32_t>(ids.size());
}

// Concatenate token byte-strings. Returns bytes written, -needed if the
// buffer is too small, or -1 on error.
int32_t bpe_decode(void* h, const int32_t* ids, int32_t n, char* out,
                   int32_t out_cap) {
  auto* t = static_cast<Tokenizer*>(h);
  if (t == nullptr || ids == nullptr) return -1;
  std::string buf;
  for (int32_t i = 0; i < n; ++i) {
    if (ids[i] >= 0 && ids[i] < static_cast<int32_t>(t->id_to_token.size()))
      buf += t->id_to_token[ids[i]];
  }
  if (static_cast<int32_t>(buf.size()) > out_cap)
    return -static_cast<int32_t>(buf.size());
  std::memcpy(out, buf.data(), buf.size());
  return static_cast<int32_t>(buf.size());
}

}  // extern "C"
