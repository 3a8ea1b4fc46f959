// Baseline JPEG decoder and writer for the Shop-the-Look image pipeline
// (counterpart of the reference's tf.io.decode_jpeg(raw, channels=3) at
// TensorFlow's defaults, which run libjpeg-turbo).
//
// The decoder reads Huffman-coded sequential files (SOF0, SOF1) of 8-bit
// samples with 1 or 3 components, any integer sampling ratio, restart
// intervals, byte stuffing and any number of scans, and skips APPn and COM
// segments. It reproduces libjpeg-turbo's output at TF's settings:
//   * the "fast integer" IDCT (jidctfst.c, the AA&N butterfly with 8-bit
//     constants and PASS1_BITS 2) in the arithmetic of its SSE2 version,
//     which x86-64 builds run: 16-bit lanes that wrap, products taken as
//     the high half of (x << 2) * (c << 6), and a final saturation to
//     [0, 255];
//   * fancy upsampling (jdsample.c): the h2v1 and h2v2 triangle filters
//     where the chroma plane is wider than 2 samples, libjpeg-turbo's h1v2
//     filter, box replication otherwise, the first and last rows
//     replicated as context;
//   * the integer YCbCr -> RGB tables of jdcolor.c; a grayscale file comes
//     out as three equal channels.
// Progressive, lossless, hierarchical and arithmetic-coded files, samples
// of other than 8 bits, and files of 2 or 4 components (CMYK, YCCK) are
// refused with a message naming the marker or the property. A file whose
// entropy-coded data ends early, or that holds a bad Huffman code, is
// refused too; nothing is filled in.
//
// The writer is a small baseline encoder (Annex K tables scaled by quality
// as jcparam.c scales them, 4:4:4, 4:2:0, 4:2:2, 4:4:0 or grayscale, an
// optional restart interval) for writing synthetic corpora; it is no part of the training
// or serving path.
//
// Every entry point returns a negative number and writes a message into
// `err` on failure. The functions keep no global state, so they may run
// on several threads at once.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct JpegError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError{msg}; }

void set_error(char* err, int64_t errlen, const std::string& msg) {
  if (err == nullptr || errlen <= 0) return;
  std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
}

// zigzag position -> natural (row-major) index; the 16 trailing entries
// catch a run that overflows the block, as libjpeg's table does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// jddctmgr.c's AA&N scale factors for the fast IDCT, scaled by 2^14
const int kAanScales[64] = {
    16384, 22725, 21407, 19266, 16384, 12873, 8867,  4520,
    22725, 31521, 29692, 26722, 22725, 17855, 12299, 6270,
    21407, 29692, 27969, 25172, 21407, 16819, 11585, 5906,
    19266, 26722, 25172, 22654, 19266, 15137, 10426, 5315,
    16384, 22725, 21407, 19266, 16384, 12873, 8867,  4520,
    12873, 17855, 16819, 15137, 12873, 10114, 6967,  3552,
    8867,  12299, 11585, 10426, 8867,  6967,  4799,  2446,
    4520,  6270,  5906,  5315,  4520,  3552,  2446,  1247};

// ------------------------------------------------------------ fast IDCT

// jidctfst-sse2.asm: CONST_BITS 8, PRE_MULTIPLY_SCALE_BITS 2, constants
// shifted left by 16 - 2 - 8 = 6 for pmulhw
const int kF1414 = 362 << 6;
const int kF1847 = 473 << 6;
const int kMF1613 = -((669 - 256) << 6);
const int kF1082 = 277 << 6;

inline int16_t wrap16(int x) { return static_cast<int16_t>(x); }

// pmulhw of (v << 2) by a shifted constant: (v * c) >> 8 unless v << 2
// leaves 16 bits
inline int16_t mulh(int16_t v, int c) {
  return wrap16((static_cast<int>(wrap16(v * 4)) * c) >> 16);
}

// One 8-point pass of the butterfly over in[0..7] (stride s), results into
// out[0..7] (stride s), all in wrapping 16-bit arithmetic.
inline void idct_pass(const int16_t* in, int16_t* out, int s) {
  int16_t tmp10 = wrap16(in[0] + in[4 * s]);
  int16_t tmp11 = wrap16(in[0] - in[4 * s]);
  int16_t tmp13 = wrap16(in[2 * s] + in[6 * s]);
  int16_t tmp12 = wrap16(mulh(wrap16(in[2 * s] - in[6 * s]), kF1414) - tmp13);
  int16_t tmp0 = wrap16(tmp10 + tmp13);
  int16_t tmp3 = wrap16(tmp10 - tmp13);
  int16_t tmp1 = wrap16(tmp11 + tmp12);
  int16_t tmp2 = wrap16(tmp11 - tmp12);

  int16_t z13 = wrap16(in[5 * s] + in[3 * s]);
  int16_t z10 = wrap16(in[5 * s] - in[3 * s]);
  int16_t z11 = wrap16(in[1 * s] + in[7 * s]);
  int16_t z12 = wrap16(in[1 * s] - in[7 * s]);
  int16_t tmp7 = wrap16(z11 + z13);
  int16_t t11 = mulh(wrap16(z11 - z13), kF1414);
  int16_t z5 = mulh(wrap16(z10 + z12), kF1847);
  int16_t t10 = wrap16(mulh(z12, kF1082) - z5);
  // MULTIPLY(z10, -FIX(2.613125930)) + z5 as -1.613 z10 - z10 + z5
  int16_t t12 = wrap16(mulh(z10, kMF1613) - z10 + z5);
  int16_t tmp6 = wrap16(t12 - tmp7);
  int16_t tmp5 = wrap16(t11 - tmp6);
  int16_t tmp4 = wrap16(t10 + tmp5);

  out[0] = wrap16(tmp0 + tmp7);
  out[7 * s] = wrap16(tmp0 - tmp7);
  out[1 * s] = wrap16(tmp1 + tmp6);
  out[6 * s] = wrap16(tmp1 - tmp6);
  out[2 * s] = wrap16(tmp2 + tmp5);
  out[5 * s] = wrap16(tmp2 - tmp5);
  out[4 * s] = wrap16(tmp3 + tmp4);
  out[3 * s] = wrap16(tmp3 - tmp4);
}

// coef: 64 quantized coefficients in natural order; qmul: the IFAST
// multipliers; writes an 8x8 block of samples at dst (row stride).
void idct_ifast(const int16_t* coef, const int16_t* qmul, uint8_t* dst,
                int stride) {
  int16_t ws[64];
  int16_t deq[64];
  for (int i = 0; i < 64; ++i) deq[i] = wrap16(coef[i] * qmul[i]);  // pmullw
  for (int c = 0; c < 8; ++c) idct_pass(deq + c, ws + c, 8);       // columns
  int16_t row[8];
  for (int r = 0; r < 8; ++r) {
    idct_pass(ws + 8 * r, row, 1);
    uint8_t* o = dst + static_cast<size_t>(r) * stride;
    for (int c = 0; c < 8; ++c) {
      int v = row[c] >> 5;  // psraw PASS1_BITS + 3
      v = std::min(127, std::max(-128, v)) + 128;  // packsswb, + 128
      o[c] = static_cast<uint8_t>(v);
    }
  }
}

// --------------------------------------------------------------- Huffman

struct Huffman {
  bool defined = false;
  uint8_t look_len[512];
  uint8_t look_val[512];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];

  void build(const uint8_t* bits, const uint8_t* v, int nvals) {
    std::memset(look_len, 0, sizeof(look_len));
    std::memcpy(vals, v, nvals);
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valoffset[l] = k - code;
      for (int i = 0; i < bits[l]; ++i) {
        if (code >= (1 << l)) fail("bad Huffman table (DHT): overfull code");
        if (l <= 9) {
          int shift = 9 - l;
          for (int j = 0; j < (1 << shift); ++j) {
            look_len[(code << shift) | j] = static_cast<uint8_t>(l);
            look_val[(code << shift) | j] = v[k];
          }
        }
        ++code;
        ++k;
      }
      maxcode[l] = bits[l] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

// ------------------------------------------------------------ bit reader

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int nbits = 0;
  int pad = 0;  // zero bits appended past the data (or a marker)
  bool at_marker = false;

  BitReader(const uint8_t* p_, const uint8_t* e_) : p(p_), end(e_) {}

  void fill() {
    while (nbits <= 56) {
      unsigned byte = 0;
      if (at_marker || p >= end) {
        pad += 8;
      } else if (*p != 0xFF) {
        byte = *p++;
      } else if (p + 1 < end && p[1] == 0x00) {
        byte = 0xFF;
        p += 2;
      } else if (p + 1 < end && p[1] == 0xFF) {
        ++p;  // fill byte before a marker
        continue;
      } else {
        at_marker = true;  // p stays on the marker's 0xFF
        pad += 8;
      }
      buf |= static_cast<uint64_t>(byte) << (56 - nbits);
      nbits += 8;
    }
  }

  void consume(int n) {
    buf <<= n;
    nbits -= n;
    if (nbits < pad)
      fail(p >= end ? "truncated JPEG: the entropy-coded data ends early"
                    : "corrupt JPEG: the entropy-coded data runs into a "
                      "marker");
  }

  int bits(int n) {
    if (n == 0) return 0;
    if (nbits < n) fill();
    int v = static_cast<int>(buf >> (64 - n));
    consume(n);
    return v;
  }

  int decode(const Huffman& h) {
    if (nbits < 16) fill();
    int look = static_cast<int>(buf >> 55);
    int len = h.look_len[look];
    if (len) {
      int v = h.look_val[look];
      consume(len);
      return v;
    }
    for (int l = 10; l <= 16; ++l) {
      int code = static_cast<int>(buf >> (64 - l));
      if (code <= h.maxcode[l]) {
        int v = h.vals[code + h.valoffset[l]];
        consume(l);
        return v;
      }
    }
    fail("corrupt JPEG: bad Huffman code");
  }

  // Drop the buffered bits and step over the restart marker RSTn.
  void restart(int n) {
    buf = 0;
    nbits = 0;
    pad = 0;
    at_marker = false;
    while (p + 1 < end && p[0] == 0xFF && p[1] == 0xFF) ++p;
    if (p + 1 >= end || p[0] != 0xFF || p[1] != 0xD0 + n)
      fail("corrupt JPEG: missing restart marker RST" + std::to_string(n));
    p += 2;
  }
};

inline int extend(int v, int n) {
  return (n && v < (1 << (n - 1))) ? v - (1 << n) + 1 : v;
}

// ---------------------------------------------------------------- decoder

struct Component {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int dw = 0, dh = 0;         // downsampled width and height
  int stride = 0, rows = 0;   // the plane, padded to whole MCUs
  std::vector<uint8_t> plane;
  bool scanned = false;
  int pred = 0;
};

struct Decoder {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Component comp[4];
  bool frame = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  bool header_only = false;

  Decoder(const uint8_t* d, size_t len) : data(d), n(len) {}

  int u8() {
    if (pos >= n) fail("truncated JPEG: the file ends inside a header");
    return data[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  int next_marker() {
    if (pos >= n) fail("truncated JPEG: no EOI marker");
    if (data[pos] != 0xFF)
      fail("corrupt JPEG: expected a marker at byte " + std::to_string(pos));
    while (pos < n && data[pos] == 0xFF) ++pos;
    return u8();
  }

  // The payload bounds [pos, end) of a segment with a length field.
  size_t segment_end() {
    int len = u16();
    if (len < 2 || pos - 2 + len > n)
      fail("truncated JPEG: a segment runs past the end of the file");
    return pos - 2 + len;
  }

  void parse_app(int marker) {
    size_t end = segment_end();
    size_t len = end - pos;
    if (marker == 0xE0 && len >= 5 && std::memcmp(data + pos, "JFIF\0", 5) == 0)
      jfif = true;
    if (marker == 0xEE && len >= 12 &&
        std::memcmp(data + pos, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = data[pos + 11];
    }
    pos = end;
  }

  void parse_dqt() {
    size_t end = segment_end();
    while (pos < end) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail("corrupt JPEG: bad quantization table (DQT)");
      for (int k = 0; k < 64; ++k)
        qt[tq][kNatural[k]] = static_cast<uint16_t>(pq ? u16() : u8());
      qt_defined[tq] = true;
    }
    if (pos != end) fail("corrupt JPEG: bad DQT length");
  }

  void parse_dht() {
    size_t end = segment_end();
    while (pos < end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("corrupt JPEG: bad Huffman table (DHT)");
      uint8_t bits[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; ++l) {
        bits[l] = static_cast<uint8_t>(u8());
        total += bits[l];
      }
      if (total > 256) fail("corrupt JPEG: bad Huffman table (DHT)");
      uint8_t vals[256];
      for (int i = 0; i < total; ++i) vals[i] = static_cast<uint8_t>(u8());
      (tc ? ac[th] : dc[th]).build(bits, vals, total);
    }
    if (pos != end) fail("corrupt JPEG: bad DHT length");
  }

  void parse_sof(int marker) {
    size_t end = segment_end();
    if (frame) fail("corrupt JPEG: a second frame header (SOF)");
    int precision = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (precision != 8)
      fail(std::to_string(precision) +
           "-bit samples are not supported (SOF" +
           std::to_string(marker - 0xC0) + " precision " +
           std::to_string(precision) + "); only 8-bit JPEGs decode");
    if (height == 0)
      fail("JPEG with its height in a DNL marker is not supported");
    if (width == 0) fail("corrupt JPEG: width 0 in SOF");
    if (ncomp == 4)
      fail("CMYK/YCCK JPEG (4 components) is not supported");
    if (ncomp != 1 && ncomp != 3)
      fail(std::to_string(ncomp) + "-component JPEG is not supported");
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("corrupt JPEG: bad sampling factors or table in SOF");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    if (pos != end) fail("corrupt JPEG: bad SOF length");
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (hmax % c.h || vmax % c.v)
        fail("JPEG sampling ratios that are not whole multiples are not "
             "supported");
      c.dw = static_cast<int>((static_cast<int64_t>(width) * c.h + hmax - 1) / hmax);
      c.dh = static_cast<int>((static_cast<int64_t>(height) * c.v + vmax - 1) / vmax);
      c.stride = mcux * c.h * 8;
      c.rows = mcuy * c.v * 8;
    }
    frame = true;
  }

  void decode_block(BitReader& br, Component& c, const int16_t* qmul,
                    uint8_t* dst) {
    int16_t coef[64];
    std::memset(coef, 0, sizeof(coef));
    const Huffman& hd = dc[c.td];
    const Huffman& ha = ac[c.ta];
    int s = br.decode(hd);
    if (s > 11) fail("corrupt JPEG: bad DC difference category");
    c.pred += extend(br.bits(s), s);
    coef[0] = static_cast<int16_t>(c.pred);
    for (int k = 1; k < 64; ++k) {
      int rs = br.decode(ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s == 0) {
        if (r != 15) break;
        k += 15;
        continue;
      }
      k += r;
      coef[kNatural[k]] = static_cast<int16_t>(extend(br.bits(s), s));
    }
    idct_ifast(coef, qmul, dst, c.stride);
  }

  void parse_sos() {
    size_t end = segment_end();
    if (!frame) fail("corrupt JPEG: a scan (SOS) before the frame (SOF)");
    int ns = u8();
    if (ns < 1 || ns > ncomp) fail("corrupt JPEG: bad SOS component count");
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      int id = u8();
      int t = u8();
      Component* found = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == id) found = &comp[j];
      if (!found) fail("corrupt JPEG: SOS names an unknown component");
      found->td = t >> 4;
      found->ta = t & 15;
      if (found->td > 3 || found->ta > 3)
        fail("corrupt JPEG: bad Huffman table number in SOS");
      sc[i] = found;
    }
    int ss = u8(), se = u8(), ahl = u8();
    if (ss != 0 || se != 63 || ahl != 0)
      fail("progressive scan parameters (Ss=" + std::to_string(ss) +
           ", Se=" + std::to_string(se) + ") in a sequential JPEG");
    if (pos != end) fail("corrupt JPEG: bad SOS length");
    int16_t qmul[4][64];
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      if (!qt_defined[c.tq]) fail("corrupt JPEG: undefined quantization table");
      if (!dc[c.td].defined || !ac[c.ta].defined)
        fail("corrupt JPEG: undefined Huffman table");
      for (int k = 0; k < 64; ++k)  // DESCALE(q * aanscale, 14 - 2)
        qmul[i][k] = wrap16((static_cast<int>(qt[c.tq][k]) * kAanScales[k] +
                             (1 << 11)) >> 12);
      if (c.plane.empty())
        c.plane.assign(static_cast<size_t>(c.stride) * c.rows, 0);
      c.pred = 0;
      c.scanned = true;
    }
    BitReader br(data + pos, data + n);
    int64_t total;
    int bw = 0;
    if (ns == 1) {
      bw = (sc[0]->dw + 7) / 8;
      total = static_cast<int64_t>(bw) * ((sc[0]->dh + 7) / 8);
    } else {
      total = static_cast<int64_t>(mcux) * mcuy;
    }
    int rst = 0;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval && m > 0 && m % restart_interval == 0) {
        br.restart(rst);
        rst = (rst + 1) & 7;
        for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
      }
      if (ns == 1) {
        Component& c = *sc[0];
        int bx = static_cast<int>(m % bw), by = static_cast<int>(m / bw);
        decode_block(br, c, qmul[0],
                     c.plane.data() + static_cast<size_t>(by) * 8 * c.stride +
                         bx * 8);
      } else {
        int mx = static_cast<int>(m % mcux), my = static_cast<int>(m / mcux);
        for (int i = 0; i < ns; ++i) {
          Component& c = *sc[i];
          for (int yy = 0; yy < c.v; ++yy)
            for (int xx = 0; xx < c.h; ++xx) {
              size_t row = static_cast<size_t>(my * c.v + yy) * 8;
              size_t col = static_cast<size_t>(mx * c.h + xx) * 8;
              decode_block(br, c, qmul[i],
                           c.plane.data() + row * c.stride + col);
            }
        }
      }
    }
    // step to the marker after the scan's data
    const uint8_t* p = br.p;
    while (p + 1 < data + n && !(p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF &&
                                 !(p[1] >= 0xD0 && p[1] <= 0xD7)))
      ++p;
    if (p + 1 >= data + n) fail("truncated JPEG: no marker after the scan");
    pos = static_cast<size_t>(p - data);
  }

  // Parse to the end (or, with header_only, to the frame header).
  void run() {
    if (n < 2 || data[0] != 0xFF || data[1] != 0xD8)
      fail("not a JPEG file (no SOI marker)");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xC0 || m == 0xC1) {
        parse_sof(m);
        if (header_only) return;
      } else if (m == 0xC2) {
        fail("progressive JPEG (SOF2) is not supported");
      } else if (m == 0xC3) {
        fail("lossless JPEG (SOF3) is not supported");
      } else if (m >= 0xC5 && m <= 0xC7) {
        fail("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) +
             ") is not supported");
      } else if ((m >= 0xC9 && m <= 0xCB) || (m >= 0xCD && m <= 0xCF)) {
        fail("arithmetic-coded JPEG (SOF" + std::to_string(m - 0xC0) +
             ") is not supported");
      } else if (m == 0xCC) {
        fail("arithmetic-coded JPEG (DAC marker) is not supported");
      } else if (m == 0xC4) {
        parse_dht();
      } else if (m == 0xDB) {
        parse_dqt();
      } else if (m == 0xDD) {
        size_t end = segment_end();
        restart_interval = u16();
        pos = end;
      } else if (m == 0xDA) {
        parse_sos();
      } else if (m == 0xD9) {
        break;
      } else if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) {
        parse_app(m);
      } else if (m >= 0xD0 && m <= 0xD7) {
        continue;  // a stray restart marker
      } else if (m == 0xD8) {
        fail("corrupt JPEG: a second SOI marker");
      } else {
        fail("JPEG marker 0xFF" + std::string(1, "0123456789ABCDEF"[m >> 4]) +
             std::string(1, "0123456789ABCDEF"[m & 15]) + " is not supported");
      }
    }
    if (!frame) fail("JPEG without a frame header (SOF)");
    for (int i = 0; i < ncomp; ++i)
      if (!comp[i].scanned) fail("truncated JPEG: a component has no scan");
  }

  bool is_rgb() const {
    if (ncomp != 3) return false;
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
  }

  // Component c upsampled to the full image, height x width, into out.
  void upsample(const Component& c, uint8_t* out) const {
    int rh = hmax / c.h, rv = vmax / c.v;
    const uint8_t* P = c.plane.data();
    int s = c.stride, dw = c.dw, dh = c.dh;
    auto row_of = [&](int i) { return P + static_cast<size_t>(std::min(std::max(i, 0), dh - 1)) * s; };
    for (int y = 0; y < height; ++y) {
      uint8_t* o = out + static_cast<size_t>(y) * width;
      if (rh == 1 && rv == 1) {
        std::memcpy(o, P + static_cast<size_t>(y) * s, width);
      } else if (rh == 2 && rv == 1 && dw > 2) {  // h2v1 fancy
        const uint8_t* in = P + static_cast<size_t>(y) * s;
        for (int x = 0; x < width; ++x) {
          int j = x >> 1;
          int v;
          if (!(x & 1))
            v = j == 0 ? in[0] : (in[j] * 3 + in[j - 1] + 1) >> 2;
          else
            v = j == dw - 1 ? in[j] : (in[j] * 3 + in[j + 1] + 2) >> 2;
          o[x] = static_cast<uint8_t>(v);
        }
      } else if (rh == 1 && rv == 2) {  // h1v2 fancy
        int i = y >> 1;
        bool upper = !(y & 1);
        const uint8_t* near = row_of(i);
        const uint8_t* far = row_of(upper ? i - 1 : i + 1);
        int bias = upper ? 1 : 2;
        for (int x = 0; x < width; ++x)
          o[x] = static_cast<uint8_t>((near[x] * 3 + far[x] + bias) >> 2);
      } else if (rh == 2 && rv == 2 && dw > 2) {  // h2v2 fancy
        int i = y >> 1;
        const uint8_t* near = row_of(i);
        const uint8_t* far = row_of((y & 1) ? i + 1 : i - 1);
        auto colsum = [&](int j) { return near[j] * 3 + far[j]; };
        for (int x = 0; x < width; ++x) {
          int j = x >> 1;
          int v;
          if (!(x & 1))
            v = j == 0 ? (colsum(0) * 4 + 8) >> 4
                       : (colsum(j) * 3 + colsum(j - 1) + 8) >> 4;
          else
            v = j == dw - 1 ? (colsum(j) * 4 + 7) >> 4
                            : (colsum(j) * 3 + colsum(j + 1) + 7) >> 4;
          o[x] = static_cast<uint8_t>(v);
        }
      } else {  // box replication
        const uint8_t* in = P + static_cast<size_t>(y / rv) * s;
        for (int x = 0; x < width; ++x) o[x] = in[x / rh];
      }
    }
  }

  // The decoded image as height x width x 3 RGB.
  void to_rgb(uint8_t* rgb) const {
    size_t npix = static_cast<size_t>(width) * height;
    if (ncomp == 1) {
      std::vector<uint8_t> g(npix);
      upsample(comp[0], g.data());
      for (size_t i = 0; i < npix; ++i)
        rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = g[i];
      return;
    }
    std::vector<uint8_t> planes[3];
    for (int k = 0; k < 3; ++k) {
      planes[k].resize(npix);
      upsample(comp[k], planes[k].data());
    }
    if (is_rgb()) {
      for (size_t i = 0; i < npix; ++i)
        for (int k = 0; k < 3; ++k) rgb[3 * i + k] = planes[k][i];
      return;
    }
    // jdcolor.c build_ycc_rgb_table: SCALEBITS 16
    int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
    const int one_half = 1 << 15;
    auto fix = [](double x) { return static_cast<int>(x * 65536.0 + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (fix(1.40200) * x + one_half) >> 16;
      cb_b[i] = (fix(1.77200) * x + one_half) >> 16;
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
    auto clamp = [](int v) {
      return static_cast<uint8_t>(std::min(255, std::max(0, v)));
    };
    const uint8_t* Y = planes[0].data();
    const uint8_t* Cb = planes[1].data();
    const uint8_t* Cr = planes[2].data();
    for (size_t i = 0; i < npix; ++i) {
      int y = Y[i], cb = Cb[i], cr = Cr[i];
      rgb[3 * i] = clamp(y + cr_r[cr]);
      rgb[3 * i + 1] = clamp(y + ((cb_g[cb] + cr_g[cr]) >> 16));
      rgb[3 * i + 2] = clamp(y + cb_b[cb]);
    }
  }
};

// ----------------------------------------------------------------- writer

const uint8_t kLumQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kChromQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffEnc {
  uint16_t code[256];
  uint8_t size[256];
  HuffEnc(const uint8_t* bits, const uint8_t* vals) {
    std::memset(size, 0, sizeof(size));
    int c = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++k, ++c) {
        code[vals[k]] = static_cast<uint16_t>(c);
        size[vals[k]] = static_cast<uint8_t>(l);
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;  // the pending bits, right-aligned
  int n = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t v, int len) {  // len <= 32
    acc = (acc << len) | (v & ((1ull << len) - 1));
    n += len;
    while (n >= 8) {
      n -= 8;
      uint8_t byte = static_cast<uint8_t>(acc >> n);
      out.push_back(byte);
      if (byte == 0xFF) out.push_back(0x00);
    }
  }
  void flush() {  // pad the last byte with one bits
    if (n) put((1u << (8 - n)) - 1, 8 - n);
  }
};

int quality_scale(int quality) {  // jcparam.c jpeg_quality_scaling
  quality = std::min(100, std::max(1, quality));
  return quality < 50 ? 5000 / quality : 200 - quality * 2;
}

void scaled_table(const uint8_t* base, int scale, uint8_t* out) {
  for (int i = 0; i < 64; ++i) {
    long t = (static_cast<long>(base[i]) * scale + 50L) / 100L;
    out[i] = static_cast<uint8_t>(std::min(255L, std::max(1L, t)));
  }
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v & 255));
}

void put_dht(std::vector<uint8_t>& o, int tc_th, const uint8_t* bits,
             const uint8_t* vals, int nvals) {
  o.push_back(0xFF);
  o.push_back(0xC4);
  put16(o, 2 + 1 + 16 + nvals);
  o.push_back(static_cast<uint8_t>(tc_th));
  for (int l = 1; l <= 16; ++l) o.push_back(bits[l]);
  for (int i = 0; i < nvals; ++i) o.push_back(vals[i]);
}

const double kPi = 3.14159265358979323846;

struct Plane {
  int w, h;
  std::vector<float> px;  // level-shifted samples, padded to whole blocks
};

void encode_block(BitWriter& bw, const Plane& pl, int bx, int by,
                  const uint8_t* q, const HuffEnc& dc, const HuffEnc& ac,
                  int& pred) {
  // the DCT-II basis with C(0) = sqrt(1/2), built once
  static const std::vector<float> basis = [] {
    std::vector<float> c(64);
    for (int x = 0; x < 8; ++x)
      for (int u = 0; u < 8; ++u)
        c[x * 8 + u] = static_cast<float>(
            std::cos((2 * x + 1) * u * kPi / 16.0) *
            (u == 0 ? std::sqrt(0.5) : 1.0));
    return c;
  }();
  float tmp[8][8];
  const float* base = pl.px.data() + static_cast<size_t>(by) * 8 * pl.w + bx * 8;
  for (int y = 0; y < 8; ++y) {
    const float* row = base + static_cast<size_t>(y) * pl.w;
    for (int u = 0; u < 8; ++u) {
      float s = 0;
      for (int x = 0; x < 8; ++x) s += row[x] * basis[x * 8 + u];
      tmp[y][u] = s;
    }
  }
  int coef[64];
  for (int v = 0; v < 8; ++v)
    for (int u = 0; u < 8; ++u) {
      float s = 0;
      for (int y = 0; y < 8; ++y) s += tmp[y][u] * basis[y * 8 + v];
      int idx = v * 8 + u;
      float t = s * 0.25f / q[idx];
      int c = static_cast<int>(t + (t >= 0 ? 0.5f : -0.5f));
      coef[idx] = std::min(1023, std::max(-1023, c));
    }
  auto category = [](int v) {
    int a = v < 0 ? -v : v, s = 0;
    while (a) {
      ++s;
      a >>= 1;
    }
    return s;
  };
  auto emit = [&](const HuffEnc& h, int sym, int v, int s) {
    bw.put(h.code[sym], h.size[sym]);
    if (s) bw.put(static_cast<uint32_t>(v < 0 ? v - 1 : v) & ((1u << s) - 1), s);
  };
  int diff = coef[0] - pred;
  pred = coef[0];
  emit(dc, category(diff), diff, category(diff));
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = coef[kNatural[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    int s = category(v);
    emit(ac, (run << 4) | s, v, s);
    run = 0;
  }
  if (run) bw.put(ac.code[0x00], ac.size[0x00]);
}

// pixels: h x w x nc (1 or 3) uint8; subsample: 0 = 4:4:4, 1 = 4:2:0,
// 2 = 4:2:2, 3 = 4:4:0 (the luma sampling factors over chroma's 1x1).
std::vector<uint8_t> encode(const uint8_t* pixels, int h, int w, int nc,
                            int quality, int subsample, int restart) {
  if (h < 1 || w < 1 || h > 65535 || w > 65535)
    fail("image size out of range for JPEG");
  if (nc != 1 && nc != 3) fail("the writer takes 1 or 3 channels");
  if (subsample < 0 || subsample > 3) fail("unknown chroma subsampling");
  const int kFactors[4][2] = {{1, 1}, {2, 2}, {2, 1}, {1, 2}};
  int hs = nc == 3 ? kFactors[subsample][0] : 1;  // luma sampling factors
  int vs = nc == 3 ? kFactors[subsample][1] : 1;
  int mcuw = 8 * hs, mcuh = 8 * vs;
  int mcux = (w + mcuw - 1) / mcuw, mcuy = (h + mcuh - 1) / mcuh;
  std::vector<Plane> planes(nc);
  auto sample = [&](int y, int x, int k) {
    y = std::min(y, h - 1);
    x = std::min(x, w - 1);
    return pixels[(static_cast<size_t>(y) * w + x) * nc + k];
  };
  // full-resolution components (YCbCr for color), edge-replicated
  std::vector<std::vector<int>> full(nc);
  int fw = mcux * mcuw, fh = mcuy * mcuh;
  for (int k = 0; k < nc; ++k) full[k].resize(static_cast<size_t>(fw) * fh);
  for (int y = 0; y < fh; ++y)
    for (int x = 0; x < fw; ++x) {
      size_t i = static_cast<size_t>(y) * fw + x;
      if (nc == 1) {
        full[0][i] = sample(y, x, 0);
        continue;
      }
      int r = sample(y, x, 0), g = sample(y, x, 1), b = sample(y, x, 2);
      full[0][i] = (19595 * r + 38470 * g + 7471 * b + 32768) >> 16;
      full[1][i] = (-11059 * r - 21709 * g + 32768 * b + (128 << 16) + 32767) >> 16;
      full[2][i] = (32768 * r - 27439 * g - 5329 * b + (128 << 16) + 32767) >> 16;
    }
  for (int k = 0; k < nc; ++k) {
    Plane& p = planes[k];
    int fx = k > 0 ? hs : 1, fy = k > 0 ? vs : 1;
    p.w = fw / fx;
    p.h = fh / fy;
    p.px.resize(static_cast<size_t>(p.w) * p.h);
    const std::vector<int>& f = full[k];
    for (int y = 0; y < p.h; ++y)
      for (int x = 0; x < p.w; ++x) {
        int sum = 0;  // the box mean, the bias alternating as jcsample.c's
        for (int dy = 0; dy < fy; ++dy)
          for (int dx = 0; dx < fx; ++dx)
            sum += f[static_cast<size_t>(fy * y + dy) * fw + fx * x + dx];
        int n = fx * fy;
        int v = n == 1 ? sum : (sum + n / 2 - 1 + (x & 1)) / n;
        p.px[static_cast<size_t>(y) * p.w + x] = static_cast<float>(v - 128);
      }
  }
  int scale = quality_scale(quality);
  uint8_t qlum[64], qchr[64];
  scaled_table(kLumQuant, scale, qlum);
  scaled_table(kChromQuant, scale, qchr);

  std::vector<uint8_t> o;
  o.reserve(static_cast<size_t>(w) * h);
  o.insert(o.end(), {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F',
                     0x00, 0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00,
                     0x00});
  for (int t = 0; t < (nc == 3 ? 2 : 1); ++t) {
    const uint8_t* q = t ? qchr : qlum;
    o.insert(o.end(), {0xFF, 0xDB, 0x00, 67, static_cast<uint8_t>(t)});
    for (int k = 0; k < 64; ++k) o.push_back(q[kNatural[k]]);
  }
  o.insert(o.end(), {0xFF, 0xC0});
  put16(o, 8 + 3 * nc);
  o.push_back(8);
  put16(o, h);
  put16(o, w);
  o.push_back(static_cast<uint8_t>(nc));
  for (int k = 0; k < nc; ++k) {
    o.push_back(static_cast<uint8_t>(k + 1));
    o.push_back(static_cast<uint8_t>(k == 0 ? (hs << 4) | vs : 0x11));
    o.push_back(static_cast<uint8_t>(k == 0 ? 0 : 1));
  }
  put_dht(o, 0x00, kDcLumBits, kDcVals, 12);
  put_dht(o, 0x10, kAcLumBits, kAcLumVals, 162);
  if (nc == 3) {
    put_dht(o, 0x01, kDcChromBits, kDcVals, 12);
    put_dht(o, 0x11, kAcChromBits, kAcChromVals, 162);
  }
  if (restart > 0) {
    o.insert(o.end(), {0xFF, 0xDD, 0x00, 0x04});
    put16(o, restart);
  }
  o.insert(o.end(), {0xFF, 0xDA});
  put16(o, 6 + 2 * nc);
  o.push_back(static_cast<uint8_t>(nc));
  for (int k = 0; k < nc; ++k) {
    o.push_back(static_cast<uint8_t>(k + 1));
    o.push_back(static_cast<uint8_t>(k == 0 ? 0x00 : 0x11));
  }
  o.insert(o.end(), {0x00, 0x3F, 0x00});

  HuffEnc dcl(kDcLumBits, kDcVals), acl(kAcLumBits, kAcLumVals);
  HuffEnc dcc(kDcChromBits, kDcVals), acc(kAcChromBits, kAcChromVals);
  BitWriter bw(o);
  int pred[3] = {0, 0, 0};
  int64_t total = static_cast<int64_t>(mcux) * mcuy;
  int rst = 0;
  for (int64_t m = 0; m < total; ++m) {
    if (restart > 0 && m > 0 && m % restart == 0) {
      bw.flush();
      o.push_back(0xFF);
      o.push_back(static_cast<uint8_t>(0xD0 + rst));
      rst = (rst + 1) & 7;
      pred[0] = pred[1] = pred[2] = 0;
    }
    int mx = static_cast<int>(m % mcux), my = static_cast<int>(m / mcux);
    for (int yy = 0; yy < vs; ++yy)
      for (int xx = 0; xx < hs; ++xx)
        encode_block(bw, planes[0], mx * hs + xx, my * vs + yy, qlum, dcl,
                     acl, pred[0]);
    for (int k = 1; k < nc; ++k)
      encode_block(bw, planes[k], mx, my, qchr, dcc, acc, pred[k]);
  }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  return o;
}

}  // namespace

extern "C" {

// info = (height, width, components); 0 on success.
int jpeg_header(const uint8_t* data, int64_t n, int64_t* info, char* err,
                int64_t errlen) {
  try {
    Decoder d(data, static_cast<size_t>(n));
    d.header_only = true;
    d.run();
    if (!d.frame) fail("JPEG without a frame header (SOF)");
    info[0] = d.height;
    info[1] = d.width;
    info[2] = d.ncomp;
    return 0;
  } catch (const JpegError& e) {
    set_error(err, errlen, e.msg);
    return -1;
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory decoding a JPEG");
    return -1;
  }
}

// The whole image as height x width x 3 RGB into `out` (cap bytes).
int jpeg_decode_rgb(const uint8_t* data, int64_t n, uint8_t* out, int64_t cap,
                    char* err, int64_t errlen) {
  try {
    Decoder d(data, static_cast<size_t>(n));
    d.run();
    if (static_cast<int64_t>(d.width) * d.height * 3 > cap)
      fail("output buffer too small for the decoded JPEG");
    d.to_rgb(out);
    return 0;
  } catch (const JpegError& e) {
    set_error(err, errlen, e.msg);
    return -1;
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory decoding a JPEG");
    return -1;
  }
}

// Decode, then crop or pad to size x size as tf.image.resize_with_crop_or_pad
// does (crop at (n - size) // 2, zero padding at (size - n) // 2 before the
// image), and map each byte through `lut` (256 floats) into `out` (size x
// size x 3 float32; padding takes lut[0]).
int jpeg_decode_fit(const uint8_t* data, int64_t n, int64_t size,
                    const float* lut, float* out, char* err, int64_t errlen) {
  try {
    Decoder d(data, static_cast<size_t>(n));
    d.run();
    std::vector<uint8_t> rgb(static_cast<size_t>(d.width) * d.height * 3);
    d.to_rgb(rgb.data());
    int64_t t = size;
    int64_t crop_y = std::max<int64_t>((d.height - t) / 2, 0);
    int64_t crop_x = std::max<int64_t>((d.width - t) / 2, 0);
    int64_t pad_y = std::max<int64_t>((t - d.height) / 2, 0);
    int64_t pad_x = std::max<int64_t>((t - d.width) / 2, 0);
    int64_t h = std::min<int64_t>(t, d.height), w = std::min<int64_t>(t, d.width);
    float zero = lut[0];
    std::fill(out, out + t * t * 3, zero);
    for (int64_t y = 0; y < h; ++y) {
      const uint8_t* src = rgb.data() + ((y + crop_y) * d.width + crop_x) * 3;
      float* dst = out + ((y + pad_y) * t + pad_x) * 3;
      for (int64_t i = 0; i < w * 3; ++i) dst[i] = lut[src[i]];
    }
    return 0;
  } catch (const JpegError& e) {
    set_error(err, errlen, e.msg);
    return -1;
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory decoding a JPEG");
    return -1;
  }
}

// Writes a baseline JPEG of `pixels` into out (cap bytes); returns its
// length, or -1 (message in err), or -(needed) when cap is too small.
int64_t jpeg_encode(const uint8_t* pixels, int64_t h, int64_t w, int64_t nc,
                    int64_t quality, int64_t subsample, int64_t restart,
                    uint8_t* out, int64_t cap, char* err, int64_t errlen) {
  try {
    std::vector<uint8_t> o =
        encode(pixels, static_cast<int>(h), static_cast<int>(w),
               static_cast<int>(nc), static_cast<int>(quality),
               static_cast<int>(subsample), static_cast<int>(restart));
    if (static_cast<int64_t>(o.size()) > cap)
      return -static_cast<int64_t>(o.size()) - 1;
    std::memcpy(out, o.data(), o.size());
    return static_cast<int64_t>(o.size());
  } catch (const JpegError& e) {
    set_error(err, errlen, e.msg);
    return -1;
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory encoding a JPEG");
    return -1;
  }
}

}  // extern "C"
