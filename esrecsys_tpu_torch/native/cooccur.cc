// Host-side ETL code of esrecsys_tpu_torch (a copy of
// esrecsys_tpu/native/cooccur.cc, so the port imports nothing of the JAX
// package): the co-occurrence accumulator of etl/cooccurrence.py (window
// and pair modes, hash maps of doubles driven through ctypes) and a
// batched base64 line decoder for data/recordio.py.
//
// Build: esrecsys_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC, at
// first use, into esrecsys_tpu_torch/_build/).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Accumulator {
  // row index -> (other index -> weight)
  std::unordered_map<int64_t, std::unordered_map<int64_t, double>> rows;
};

}  // namespace

extern "C" {

void* cooc_new() { return new Accumulator(); }

void cooc_free(void* h) { delete static_cast<Accumulator*>(h); }

// Sliding context window with 1/distance weighting; stores only
// my_idx > other_idx (symmetric matrix, lower triangle), skips equal ids.
// Exact semantics of make_cooccurrence.py:33-55.
void cooc_add_window(void* h, const int64_t* ids, int64_t n, int64_t window) {
  auto* acc = static_cast<Accumulator*>(h);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t my = ids[i];
    const int64_t start = std::max<int64_t>(0, i - window);
    const int64_t end = std::min<int64_t>(n, i + window);
    auto& row = acc->rows[my];
    for (int64_t j = start; j < end; ++j) {
      const int64_t other = ids[j];
      if (my <= other) continue;
      row[other] += 1.0 / static_cast<double>(i > j ? i - j : j - i);
    }
    if (row.empty()) acc->rows.erase(my);
  }
}

// All unordered pairs of a (deduplicated) id set, +1 each, stored on the
// larger id's row. Exact semantics of make_dice.py:41-54.
void cooc_add_pairs(void* h, const int64_t* ids, int64_t n) {
  auto* acc = static_cast<Accumulator*>(h);
  std::vector<int64_t> uniq(ids, ids + n);
  std::sort(uniq.begin(), uniq.end());
  uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
  for (size_t i = 0; i < uniq.size(); ++i) {
    auto& row = acc->rows[uniq[i]];
    for (size_t j = 0; j < i; ++j) {
      row[uniq[j]] += 1.0;
    }
    if (row.empty()) acc->rows.erase(uniq[i]);
  }
}

int64_t cooc_num_entries(void* h) {
  auto* acc = static_cast<Accumulator*>(h);
  int64_t total = 0;
  for (const auto& kv : acc->rows) total += kv.second.size();
  return total;
}

// Export all (row, other, count) triples sorted by (row, other).
// Buffers must hold cooc_num_entries() elements.
void cooc_export(void* h, int64_t* row_out, int64_t* other_out, double* count_out) {
  auto* acc = static_cast<Accumulator*>(h);
  std::vector<int64_t> row_keys;
  row_keys.reserve(acc->rows.size());
  for (const auto& kv : acc->rows) row_keys.push_back(kv.first);
  std::sort(row_keys.begin(), row_keys.end());
  int64_t pos = 0;
  std::vector<std::pair<int64_t, double>> entries;
  for (const int64_t r : row_keys) {
    const auto& row = acc->rows[r];
    entries.assign(row.begin(), row.end());
    std::sort(entries.begin(), entries.end());
    for (const auto& e : entries) {
      row_out[pos] = r;
      other_out[pos] = e.first;
      count_out[pos] = e.second;
      ++pos;
    }
  }
}

// ---- batched base64 line decoding -------------------------------------

static const int8_t kB64Inv[256] = {
    // -1 = invalid, -2 = padding '='
#define X -1
    X, X, X, X, X, X, X, X, X, X, X, X, X, X, X, X,
    X, X, X, X, X, X, X, X, X, X, X, X, X, X, X, X,
    X, X, X, X, X, X, X, X, X, X, X, 62, X, X, X, 63,
    52, 53, 54, 55, 56, 57, 58, 59, 60, 61, X, X, X, -2, X, X,
    X, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
    15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, X, X, X, X, X,
    X, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
    41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, X, X, X, X, X,
    X, X, X, X, X, X, X, X, X, X, X, X, X, X, X, X,
    X, X, X, X, X, X, X, X, X, X, X, X, X, X, X, X,
    X, X, X, X, X, X, X, X, X, X, X, X, X, X, X, X,
    X, X, X, X, X, X, X, X, X, X, X, X, X, X, X, X,
    X, X, X, X, X, X, X, X, X, X, X, X, X, X, X, X,
    X, X, X, X, X, X, X, X, X, X, X, X, X, X, X, X,
    X, X, X, X, X, X, X, X, X, X, X, X, X, X, X, X,
    X, X, X, X, X, X, X, X, X, X, X, X, X, X, X, X
#undef X
};

// Decode newline-separated base64 lines from `data` (len bytes) into `out`.
// Writes record end-offsets into `offsets` (one per line). Returns the
// number of lines decoded, or -(line_index+1) on a malformed line.
// `out` must be at least len*3/4 bytes; `offsets` at least the line count.
int64_t b64_decode_lines(const char* data, int64_t len, char* out,
                         int64_t* offsets, int64_t max_lines) {
  int64_t out_pos = 0;
  int64_t line = 0;
  int64_t i = 0;
  while (i < len && line < max_lines) {
    // find line end
    int64_t j = i;
    while (j < len && data[j] != '\n') ++j;
    // decode [i, j): base64 characters, then at most two '=' of padding
    int bits = 0, acc = 0;
    int64_t p = i;
    for (; p < j; ++p) {
      const int8_t v = kB64Inv[static_cast<uint8_t>(data[p])];
      if (v == -2) break;  // padding: done with this line's payload
      if (v < 0) return -(line + 1);
      acc = (acc << 6) | v;
      bits += 6;
      if (bits >= 8) {
        bits -= 8;
        out[out_pos++] = static_cast<char>((acc >> bits) & 0xFF);
      }
    }
    const int64_t chars = p - i;
    int64_t pad = 0;
    for (; p < j; ++p, ++pad) {
      if (data[p] != '=') return -(line + 1);
    }
    // a lone sixth of a byte, or padding past the last group, is no base64
    if (chars % 4 == 1 || pad > 2 || (pad && (chars + pad) % 4)) {
      return -(line + 1);
    }
    offsets[line++] = out_pos;
    i = j + 1;
  }
  return line;
}

}  // extern "C"
