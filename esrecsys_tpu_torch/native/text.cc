// Native tokenizer of the Wikipedia ETL of esrecsys_tpu_torch (a copy of
// esrecsys_tpu/native/text.cc).
//
// wiki_tokenize: the hot loop of tokenize (the reference's regex split,
// data/vocab.py simple_tokenize). Splits on the reference's single-byte separator class (all ASCII,
// so the scan is UTF-8 safe: multi-byte sequences never contain ASCII
// bytes), lowercases ASCII in place, and flags tokens containing non-ASCII
// bytes so the Python wrapper can apply str.lower() to exactly those —
// byte-for-byte parity with [t.lower() for t in re.split(...) if t].
//
// Output: tokens '\n'-joined in `out`, one flag byte per token in `flags`.
// Returns the token count, or -1 if either buffer is too small (caller
// resizes; out never needs more than n bytes, flags never more than
// n/2 + 1 entries).

#include <cstdint>

namespace {

bool kSep[256];
bool kSepInit = []() {
  const char seps[] = " !@#$%^&*()_+\t\n\",.:;\\/?><|{}'[]";
  for (const char* p = seps; *p; ++p) kSep[(unsigned char)*p] = true;
  return true;
}();

}  // namespace

extern "C" {

int64_t wiki_tokenize(const char* in, int64_t n, char* out, int64_t out_cap,
                      uint8_t* flags, int64_t flags_cap, int64_t* out_len) {
  int64_t o = 0;       // bytes written to out
  int64_t ntok = 0;    // tokens emitted
  int64_t i = 0;
  while (i < n) {
    // skip separators
    while (i < n && kSep[(unsigned char)in[i]]) ++i;
    if (i >= n) break;
    if (ntok >= flags_cap) return -1;
    uint8_t non_ascii = 0;
    if (ntok > 0) {
      if (o + 1 > out_cap) return -1;
      out[o++] = '\n';
    }
    while (i < n && !kSep[(unsigned char)in[i]]) {
      unsigned char c = (unsigned char)in[i++];
      if (c >= 'A' && c <= 'Z') c += 32;
      else if (c >= 0x80) non_ascii = 1;
      if (o + 1 > out_cap) return -1;
      out[o++] = (char)c;
    }
    flags[ntok++] = non_ascii;
  }
  *out_len = o;
  return ntok;
}

}  // extern "C"
