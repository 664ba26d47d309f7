// Native byte-level BPE tokenizer core of the port (olmoasr_tpu_torch).
//
// A C++ counterpart of tiktoken's Rust core: tiktoken-format mergeable
// ranks, GPT-2-style pre-tokenization, lowest-rank-first merge loop. Exposed
// through a C ABI for ctypes (olmoasr_tpu_torch/tokenizer_native.py); the
// pure-Python engine in olmoasr_tpu_torch/tokenizer.py is the
// exact-semantics reference implementation.
//
// Unicode: the GPT-2 pattern's \p{L}/\p{N}/\s classes are evaluated on
// decoded UTF-8 codepoints against range tables generated from the same
// Python `regex` module the Python engine uses (unicode_tables.inc, emitted
// by build.py), so the two agree on all of unicode by construction
// (tests/test_torch_entry_extras.py).
//
// Build: olmoasr_tpu_torch/cpp/build.py (the host's g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Encoder {
  std::unordered_map<std::string, int> ranks;
  bool byte_fallback = false;  // ids 0..255 = raw bytes
};

// ---- base64 ---------------------------------------------------------------

int b64_val(char c) {
  if (c >= 'A' && c <= 'Z') return c - 'A';
  if (c >= 'a' && c <= 'z') return c - 'a' + 26;
  if (c >= '0' && c <= '9') return c - '0' + 52;
  if (c == '+') return 62;
  if (c == '/') return 63;
  return -1;
}

std::string b64_decode(const std::string& in) {
  std::string out;
  int val = 0, bits = 0;
  for (char c : in) {
    if (c == '=') break;
    int d = b64_val(c);
    if (d < 0) continue;
    val = (val << 6) | d;
    bits += 6;
    if (bits >= 8) {
      bits -= 8;
      out.push_back(static_cast<char>((val >> bits) & 0xFF));
    }
  }
  return out;
}

// ---- pre-tokenization (GPT-2 pattern, unicode-exact) ------------------------

#include "unicode_tables.inc"

bool in_ranges(uint32_t cp, const uint32_t ranges[][2], int count) {
  int lo = 0, hi = count - 1;
  while (lo <= hi) {
    int mid = (lo + hi) / 2;
    if (cp < ranges[mid][0]) hi = mid - 1;
    else if (cp > ranges[mid][1]) lo = mid + 1;
    else return true;
  }
  return false;
}

inline bool cp_is_letter(uint32_t cp) { return in_ranges(cp, kLetter, kLetterCount); }
inline bool cp_is_number(uint32_t cp) { return in_ranges(cp, kNumber, kNumberCount); }
inline bool cp_is_space(uint32_t cp) { return in_ranges(cp, kSpace, kSpaceCount); }

// Decode one UTF-8 codepoint at s[i]; advances len. Invalid sequences decode
// byte-by-byte as class "other" (mirrors Python: invalid bytes never appear —
// the input is a valid str encoded to UTF-8).
uint32_t decode_cp(const std::string& s, size_t i, size_t* len) {
  unsigned char c = s[i];
  size_t n = s.size();
  if (c < 0x80) { *len = 1; return c; }
  if ((c >> 5) == 0x6 && i + 1 < n) {
    *len = 2;
    return ((c & 0x1F) << 6) | (s[i + 1] & 0x3F);
  }
  if ((c >> 4) == 0xE && i + 2 < n) {
    *len = 3;
    return ((c & 0x0F) << 12) | ((s[i + 1] & 0x3F) << 6) | (s[i + 2] & 0x3F);
  }
  if ((c >> 3) == 0x1E && i + 3 < n) {
    *len = 4;
    return ((c & 0x07) << 18) | ((s[i + 1] & 0x3F) << 12) |
           ((s[i + 2] & 0x3F) << 6) | (s[i + 3] & 0x3F);
  }
  *len = 1;
  return 0xFFFD;  // lone continuation/truncated: class "other"
}

enum CpClass { CP_LETTER, CP_NUMBER, CP_SPACE, CP_OTHER };

CpClass classify(uint32_t cp) {
  if (cp_is_space(cp)) return CP_SPACE;    // \s first: matches Python regex \s
  if (cp_is_letter(cp)) return CP_LETTER;
  if (cp_is_number(cp)) return CP_NUMBER;
  return CP_OTHER;
}

// Split text into GPT-2 pre-tokens:
//   's|'t|'re|'ve|'m|'ll|'d | ?\p{L}+ | ?\p{N}+ | ?[^\s\p{L}\p{N}]+ |
//   \s+(?!\S) | \s+
std::vector<std::string> pretokenize(const std::string& s) {
  std::vector<std::string> out;
  size_t i = 0, n = s.size();
  size_t cl;  // codepoint byte length scratch
  while (i < n) {
    // contractions (ASCII, case-sensitive: GPT-2 pattern literals)
    if (s[i] == '\'' && i + 1 < n) {
      static const char* contractions[] = {"'s", "'t", "'re", "'ve", "'m", "'ll", "'d"};
      bool matched = false;
      for (const char* c : contractions) {
        size_t len = std::strlen(c);
        if (i + len <= n && s.compare(i, len, c) == 0) {
          out.emplace_back(s.substr(i, len));
          i += len;
          matched = true;
          break;
        }
      }
      if (matched) continue;
    }
    uint32_t cp = decode_cp(s, i, &cl);
    if (classify(cp) == CP_SPACE) {
      // whitespace run: find its byte extent
      size_t j = i, last_start = i, last_len = cl;
      while (j < n) {
        size_t l;
        uint32_t c2 = decode_cp(s, j, &l);
        if (classify(c2) != CP_SPACE) break;
        last_start = j;
        last_len = l;
        j += l;
      }
      bool run_is_multi = (last_start > i);
      bool followed_by_nonspace = (j < n);
      if (followed_by_nonspace && s[last_start] == ' ' && last_len == 1) {
        // \s+(?!\S) leaves the final ' ' to prefix the next token
        if (run_is_multi) out.emplace_back(s.substr(i, last_start - i));
        i = last_start;
      } else if (followed_by_nonspace && run_is_multi) {
        out.emplace_back(s.substr(i, last_start - i));
        i = last_start;
        continue;  // final non-' ' space emitted as its own \s+ piece next pass
      } else {
        out.emplace_back(s.substr(i, j - i));
        i = j;
        continue;
      }
    }
    // optional single leading ' ' + class run
    size_t j = i;
    if (s[j] == ' ') j++;
    if (j >= n) {
      out.emplace_back(s.substr(i));
      break;
    }
    uint32_t d = decode_cp(s, j, &cl);
    CpClass cls = classify(d);
    if (cls == CP_SPACE) {
      // ' ' followed by more space: emit the single space alone
      out.emplace_back(s.substr(i, 1));
      i++;
      continue;
    }
    size_t k = j;
    while (k < n) {
      size_t l;
      uint32_t e = decode_cp(s, k, &l);
      if (classify(e) != cls) break;
      k += l;
    }
    out.emplace_back(s.substr(i, k - i));
    i = k;
  }
  return out;
}

// ---- merge loop -------------------------------------------------------------

void bpe_merge(const Encoder& enc, const std::string& piece, std::vector<int>& out) {
  auto whole = enc.ranks.find(piece);
  if (whole != enc.ranks.end()) {
    out.push_back(whole->second);
    return;
  }
  // parts[i] = (start offset); merge lowest-rank adjacent pair first
  std::vector<size_t> starts;
  starts.reserve(piece.size() + 1);
  for (size_t i = 0; i <= piece.size(); i++) starts.push_back(i);

  auto rank_of = [&](size_t a, size_t b, size_t c) -> int64_t {
    auto it = enc.ranks.find(piece.substr(starts[a], starts[c] - starts[a]));
    (void)b;
    return it == enc.ranks.end() ? INT64_MAX : it->second;
  };

  while (starts.size() > 2) {
    int64_t best_rank = INT64_MAX;
    size_t best_i = SIZE_MAX;
    for (size_t i = 0; i + 2 < starts.size(); i++) {
      int64_t r = rank_of(i, i + 1, i + 2);
      if (r < best_rank) {
        best_rank = r;
        best_i = i;
      }
    }
    if (best_rank == INT64_MAX) break;
    starts.erase(starts.begin() + best_i + 1);
  }
  for (size_t i = 0; i + 1 < starts.size(); i++) {
    const std::string sub = piece.substr(starts[i], starts[i + 1] - starts[i]);
    auto it = enc.ranks.find(sub);
    if (it != enc.ranks.end()) {
      out.push_back(it->second);
    } else if (enc.byte_fallback) {
      for (unsigned char b : sub) out.push_back(static_cast<int>(b));
    }
  }
}

}  // namespace

extern "C" {

void* bpe_create(const char* rank_file_path) {
  auto* enc = new Encoder();
  std::ifstream f(rank_file_path);
  if (!f.good()) {
    delete enc;
    return nullptr;
  }
  std::string line;
  while (std::getline(f, line)) {
    if (line.empty()) continue;
    auto sp = line.find(' ');
    if (sp == std::string::npos) continue;
    enc->ranks.emplace(b64_decode(line.substr(0, sp)),
                       std::stoi(line.substr(sp + 1)));
  }
  return enc;
}

void* bpe_create_byte_fallback() {
  auto* enc = new Encoder();
  enc->byte_fallback = true;
  for (int b = 0; b < 256; b++) {
    enc->ranks.emplace(std::string(1, static_cast<char>(b)), b);
  }
  return enc;
}

int bpe_n_vocab(void* handle) {
  return static_cast<int>(static_cast<Encoder*>(handle)->ranks.size());
}

// Encode text -> ids. Returns the number of ids (may exceed max_out; only
// max_out are written).
int bpe_encode(void* handle, const char* text, int text_len, int* out_ids,
               int max_out) {
  auto* enc = static_cast<Encoder*>(handle);
  std::string s(text, text_len);
  std::vector<int> ids;
  ids.reserve(text_len / 3 + 8);
  if (enc->byte_fallback) {
    for (unsigned char b : s) ids.push_back(static_cast<int>(b));
  } else {
    for (const std::string& piece : pretokenize(s)) {
      bpe_merge(*enc, piece, ids);
    }
  }
  int n = static_cast<int>(ids.size());
  for (int i = 0; i < n && i < max_out; i++) out_ids[i] = ids[i];
  return n;
}

void bpe_free(void* handle) { delete static_cast<Encoder*>(handle); }

}  // extern "C"
