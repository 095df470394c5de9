// WEBP decoders' sequential loops: host code, no device kernel.
//
// The JAX package opens WEBP files through PIL's libwebp. The port
// (pdfio/vp8l.py, pdfio/vp8.py) replays libwebp 1.6 in Python; its
// per-pixel and per-token loops run at microseconds a step there, and a
// page-sized image holds millions of pixels. This file is the same loops
// compiled, built by nvcc like the kernels (ops/build.py, plain C entry
// points, no PyTorch header) and loaded with ctypes; the Python modules
// are its plain versions, bit for bit.
//
// - webp_vp8l_decode: a VP8L level-0 image stream (prefix codes, meta
//   codes, colour cache, LZ77, the four inverse transforms) to ARGB.
// - webp_alpha_unfilter: the ALPH chunk's horizontal, vertical and
//   gradient unfilters, in place.
// - webp_vp8_decode: a VP8 key frame (header, modes, tokens,
//   reconstruction, loop filter) to its Y, U and V planes at macroblock
//   size.
// - webp_yuv_to_rgb: libwebp's fancy upsampling and YUV to RGB of those
//   planes (pdfio/vp8.py: yuv_to_rgb).
//
// Each returns 0, or a positive code where libwebp fails the image.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "webp_tables.cuh"

namespace {

using webp_tables::kAcTable;
using webp_tables::kBModesProba;
using webp_tables::kCodeToPlane;
using webp_tables::kCoeffsProba0;
using webp_tables::kCoeffsUpdateProba;
using webp_tables::kDcTable;

// ------------------------------------------------------------------ VP8L

struct LBits {
  const uint8_t* data;
  int64_t len;
  uint64_t pos, nbits;
  bool eos;
  uint64_t peek64() const {
    int64_t byte = static_cast<int64_t>(pos >> 3);
    uint64_t v = 0;
    for (int i = 0; i < 8; ++i) {
      if (byte + i < len) v |= static_cast<uint64_t>(data[byte + i]) << (8 * i);
    }
    return v >> (pos & 7);
  }
  uint32_t read(int n) {
    if (n == 0) return 0;
    uint32_t v = static_cast<uint32_t>(peek64() & ((1ull << n) - 1));
    pos += n;
    if (pos > nbits) eos = true;
    return v;
  }
  int bit() {
    int v = static_cast<int>((pos >> 3) < static_cast<uint64_t>(len)
                                 ? (data[pos >> 3] >> (pos & 7)) & 1
                                 : 0);
    ++pos;
    if (pos > nbits) eos = true;
    return v;
  }
};

struct Code {
  int single = -1;  // the symbol of a one-symbol code (no bits)
  int count[16] = {0};
  std::vector<int> symbol;
  int16_t fast_sym[256];
  uint8_t fast_len[256];  // 0: longer than 8 bits
};

// Canonical code from lengths; false where libwebp refuses it.
bool build_code(const std::vector<int>& lengths, Code& c) {
  int used = 0, last = -1;
  for (size_t s = 0; s < lengths.size(); ++s) {
    if (lengths[s]) {
      ++used;
      last = static_cast<int>(s);
      if (lengths[s] > 15) return false;
      c.count[lengths[s]]++;
    }
  }
  if (used == 0) return false;
  if (used == 1) {
    c.single = last;
    return true;
  }
  int64_t kraft = 0;
  for (int n = 1; n <= 15; ++n) kraft += static_cast<int64_t>(c.count[n]) << (15 - n);
  if (kraft != (1 << 15)) return false;
  for (int n = 1; n <= 15; ++n) {
    for (size_t s = 0; s < lengths.size(); ++s) {
      if (lengths[s] == n) c.symbol.push_back(static_cast<int>(s));
    }
  }
  std::memset(c.fast_len, 0, sizeof(c.fast_len));
  int code = 0, idx = 0;
  for (int n = 1; n <= 8; ++n) {
    for (int k = 0; k < c.count[n]; ++k, ++code, ++idx) {
      int rev = 0;
      for (int b = 0; b < n; ++b) rev |= ((code >> b) & 1) << (n - 1 - b);
      for (int r = rev; r < 256; r += 1 << n) {
        c.fast_sym[r] = static_cast<int16_t>(c.symbol[idx]);
        c.fast_len[r] = static_cast<uint8_t>(n);
      }
    }
    code <<= 1;
  }
  return true;
}

int read_symbol(const Code& c, LBits& br) {
  if (c.single >= 0) return c.single;
  int f = static_cast<int>(br.peek64() & 255);
  if (c.fast_len[f]) {
    br.pos += c.fast_len[f];
    if (br.pos > br.nbits) br.eos = true;
    return c.fast_sym[f];
  }
  int code = 0, first = 0, index = 0;
  for (int n = 1; n <= 15; ++n) {
    code |= br.bit();
    int cnt = c.count[n];
    if (code - cnt < first) return c.symbol[index + (code - first)];
    index += cnt;
    first = (first + cnt) << 1;
    code <<= 1;
  }
  br.eos = true;
  return 0;
}

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

bool read_code(LBits& br, int alphabet, Code& out) {
  std::vector<int> lengths(alphabet > 256 ? alphabet : 256, 0);
  if (br.read(1)) {
    int n = static_cast<int>(br.read(1)) + 1;
    int first = static_cast<int>(br.read(br.read(1) ? 8 : 1));
    lengths[first] = 1;
    if (n == 2) lengths[br.read(8)] = 1;
    lengths.resize(alphabet);
    return !br.eos && build_code(lengths, out);
  }
  int ncl = static_cast<int>(br.read(4)) + 4;
  std::vector<int> cl(19, 0);
  for (int i = 0; i < ncl; ++i) cl[kCodeLengthOrder[i]] = static_cast<int>(br.read(3));
  Code clc;
  if (br.eos || !build_code(cl, clc)) return false;
  int max_symbol;
  if (br.read(1)) {
    int nbits = 2 + 2 * static_cast<int>(br.read(3));
    max_symbol = 2 + static_cast<int>(br.read(nbits));
    if (max_symbol > alphabet) return false;
  } else {
    max_symbol = alphabet;
  }
  int sym = 0, prev = 8;
  while (sym < alphabet) {
    if (max_symbol-- == 0) break;
    if (br.eos) return false;
    int c = read_symbol(clc, br);
    if (c < 16) {
      lengths[sym++] = c;
      if (c) prev = c;
    } else {
      static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
      int rep = static_cast<int>(br.read(extra[c - 16])) + offset[c - 16];
      if (sym + rep > alphabet) return false;
      int val = c == 16 ? prev : 0;
      for (int k = 0; k < rep; ++k) lengths[sym++] = val;
    }
  }
  lengths.resize(alphabet);
  return !br.eos && build_code(lengths, out);
}

inline int sub_size(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline int copy_length(int sym, LBits& br) {
  if (sym < 4) return sym + 1;
  int extra = (sym - 2) >> 1;
  return ((2 + (sym & 1)) << extra) + static_cast<int>(br.read(extra)) + 1;
}

inline int plane_distance(int xsize, int code) {
  if (code > 120) return code - 120;
  int c = kCodeToPlane[code - 1];
  int d = (c >> 4) * xsize + 8 - (c & 15);
  return d >= 1 ? d : 1;
}

inline uint32_t add_px(uint32_t a, uint32_t b) {
  return (((a & 0xFF00FF00u) + (b & 0xFF00FF00u)) & 0xFF00FF00u) |
         (((a & 0x00FF00FFu) + (b & 0x00FF00FFu)) & 0x00FF00FFu);
}
inline uint32_t avg2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xFEFEFEFEu) >> 1) + (a & b); }
inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

uint32_t select_px(uint32_t t, uint32_t l, uint32_t tl) {
  int s = 0;
  for (int sh = 24; sh >= 0; sh -= 8) {
    int a = (t >> sh) & 255, b = (l >> sh) & 255, c = (tl >> sh) & 255;
    s += std::abs(b - c) - std::abs(a - c);
  }
  return s <= 0 ? t : l;
}

uint32_t full_px(uint32_t l, uint32_t t, uint32_t tl) {
  uint32_t o = 0;
  for (int sh = 24; sh >= 0; sh -= 8) {
    o |= static_cast<uint32_t>(
             clip255(static_cast<int>((l >> sh) & 255) + static_cast<int>((t >> sh) & 255) -
                     static_cast<int>((tl >> sh) & 255)))
         << sh;
  }
  return o;
}

uint32_t half_px(uint32_t l, uint32_t t, uint32_t tl) {
  uint32_t ave = avg2(l, t), o = 0;
  for (int sh = 24; sh >= 0; sh -= 8) {
    int a = (ave >> sh) & 255, b = (tl >> sh) & 255;
    o |= static_cast<uint32_t>(clip255(a + (a - b) / 2)) << sh;
  }
  return o;
}

uint32_t predict(int mode, uint32_t l, uint32_t t, uint32_t tr, uint32_t tl) {
  switch (mode) {
    case 1: return l;
    case 2: return t;
    case 3: return tr;
    case 4: return tl;
    case 5: return avg2(avg2(l, tr), t);
    case 6: return avg2(l, tl);
    case 7: return avg2(l, t);
    case 8: return avg2(tl, t);
    case 9: return avg2(t, tr);
    case 10: return avg2(avg2(l, tl), avg2(t, tr));
    case 11: return select_px(t, l, tl);
    case 12: return full_px(l, t, tl);
    case 13: return half_px(l, t, tl);
    default: return 0xFF000000u;
  }
}

struct Transform {
  int kind, bits, xsize;
  std::vector<uint32_t> data;
};

void inverse(const Transform& tf, int rows, std::vector<uint32_t>& px) {
  const int width = tf.xsize, bits = tf.bits;
  if (tf.kind == 2) {
    for (auto& a : px) {
      uint32_t g = (a >> 8) & 0xFF;
      a = (a & 0xFF00FF00u) | (((a & 0x00FF00FFu) + ((g << 16) | g)) & 0x00FF00FFu);
    }
    return;
  }
  if (tf.kind == 3) {
    const int pw = sub_size(width, bits);
    std::vector<uint32_t> out(static_cast<size_t>(rows) * width);
    for (int y = 0; y < rows; ++y) {
      for (int x = 0; x < width; ++x) {
        uint32_t g = (px[static_cast<size_t>(y) * pw + (x >> bits)] >> 8) & 0xFF;
        int idx;
        if (bits == 0) {
          idx = static_cast<int>(g);
        } else {
          int bpp = 8 >> bits;
          idx = static_cast<int>((g >> ((x & ((1 << bits) - 1)) * bpp)) & ((1u << bpp) - 1));
        }
        out[static_cast<size_t>(y) * width + x] = tf.data[idx];
      }
    }
    px.swap(out);
    return;
  }
  const int tw = sub_size(width, bits);
  if (tf.kind == 1) {
    for (int y = 0; y < rows; ++y) {
      for (int x = 0; x < width; ++x) {
        uint32_t t = tf.data[static_cast<size_t>(y >> bits) * tw + (x >> bits)];
        int g2r = static_cast<int8_t>(t & 0xFF), g2b = static_cast<int8_t>((t >> 8) & 0xFF);
        int r2b = static_cast<int8_t>((t >> 16) & 0xFF);
        uint32_t& a = px[static_cast<size_t>(y) * width + x];
        int green = static_cast<int8_t>((a >> 8) & 0xFF);
        int red = static_cast<int>((a >> 16) & 0xFF), blue = static_cast<int>(a & 0xFF);
        red = (red + ((g2r * green) >> 5)) & 0xFF;
        blue = (blue + ((g2b * green) >> 5) + ((r2b * static_cast<int8_t>(red)) >> 5)) & 0xFF;
        a = (a & 0xFF00FF00u) | (static_cast<uint32_t>(red) << 16) | static_cast<uint32_t>(blue);
      }
    }
    return;
  }
  px[0] = add_px(px[0], 0xFF000000u);
  for (int x = 1; x < width; ++x) px[x] = add_px(px[x], px[x - 1]);
  for (int y = 1; y < rows; ++y) {
    const size_t base = static_cast<size_t>(y) * width, up = base - width;
    px[base] = add_px(px[base], px[up]);
    const uint32_t* trow = tf.data.data() + static_cast<size_t>(y >> bits) * tw;
    for (int x = 1; x < width; ++x) {
      int mode = (trow[x >> bits] >> 8) & 0xF;
      px[base + x] = add_px(px[base + x],
                            predict(mode, px[base + x - 1], px[up + x], px[up + x + 1], px[up + x - 1]));
    }
  }
}

// One image stream; level 0 reads transforms and meta codes and undoes
// the transforms. Returns 0 or an error code; pixels in `out`.
int decode_stream(LBits& br, int xsize, int ysize, bool level0, int max_rows,
                  std::vector<uint32_t>& out) {
  std::vector<Transform> transforms;
  if (level0) {
    int seen = 0;
    while (br.read(1)) {
      int kind = static_cast<int>(br.read(2));
      if (seen & (1 << kind)) return 2;
      seen |= 1 << kind;
      Transform tf{kind, 0, xsize, {}};
      if (kind == 0 || kind == 1) {
        tf.bits = static_cast<int>(br.read(3)) + 2;
        int rc = decode_stream(br, sub_size(xsize, tf.bits), sub_size(ysize, tf.bits), false, -1,
                               tf.data);
        if (rc) return rc;
      } else if (kind == 3) {
        int ncolors = static_cast<int>(br.read(8)) + 1;
        tf.bits = ncolors > 16 ? 0 : ncolors > 4 ? 1 : ncolors > 2 ? 2 : 3;
        std::vector<uint32_t> pal;
        int rc = decode_stream(br, ncolors, 1, false, -1, pal);
        if (rc) return rc;
        tf.data.assign(static_cast<size_t>(1) << (8 >> tf.bits), 0);
        uint32_t prev = 0;
        for (int i = 0; i < ncolors; ++i) {
          prev = add_px(prev, pal[i]);
          tf.data[i] = prev;
        }
        xsize = sub_size(xsize, tf.bits);
      }
      if (br.eos) return 1;
      transforms.push_back(std::move(tf));
    }
  }
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = static_cast<int>(br.read(4));
    if (cache_bits < 1 || cache_bits > 11) return 3;
  }
  int meta_bits = 0, mw = 0, ngroups = 1;
  std::vector<uint32_t> meta;
  if (level0 && br.read(1)) {
    meta_bits = static_cast<int>(br.read(3)) + 2;
    mw = sub_size(xsize, meta_bits);
    int rc = decode_stream(br, mw, sub_size(ysize, meta_bits), false, -1, meta);
    if (rc) return rc;
    int mx = 0;
    for (auto& m : meta) {
      m = (m >> 8) & 0xFFFF;
      if (static_cast<int>(m) > mx) mx = static_cast<int>(m);
    }
    ngroups = mx + 1;
  }
  if (br.eos) return 1;
  const int cache_size = cache_bits ? 1 << cache_bits : 0;
  std::vector<Code> codes(static_cast<size_t>(ngroups) * 5);
  const int alphabets[5] = {256 + 24 + cache_size, 256, 256, 256, 40};
  for (int g = 0; g < ngroups; ++g) {
    for (int k = 0; k < 5; ++k) {
      if (!read_code(br, alphabets[k], codes[static_cast<size_t>(g) * 5 + k])) return 4;
    }
  }
  const int rows = (max_rows < 0 || max_rows > ysize) ? ysize : max_rows;
  const int64_t total = static_cast<int64_t>(xsize) * rows;
  const int64_t full = static_cast<int64_t>(xsize) * ysize;
  out.assign(static_cast<size_t>(total), 0);
  std::vector<uint32_t> cache(cache_size, 0);
  const int shift = 32 - cache_bits;
  int64_t pos = 0, cached = 0;
  int col = 0, row = 0;
  while (pos < total) {
    if (br.eos) return 1;
    const Code* g = codes.data() +
                    5 * (meta.empty() ? 0 : meta[static_cast<size_t>(row >> meta_bits) * mw + (col >> meta_bits)]);
    int code = read_symbol(g[0], br);
    int64_t n;
    if (code < 256) {
      uint32_t red = read_symbol(g[1], br), blue = read_symbol(g[2], br);
      uint32_t alpha = read_symbol(g[3], br);
      out[pos] = (alpha << 24) | (red << 16) | (static_cast<uint32_t>(code) << 8) | blue;
      n = 1;
    } else if (code < 256 + 24) {
      int length = copy_length(code - 256, br);
      int dist = plane_distance(xsize, copy_length(read_symbol(g[4], br), br));
      if (br.eos) return 1;
      if (dist > pos || length > full - pos) return 5;
      n = length < total - pos ? length : total - pos;
      for (int64_t i = pos; i < pos + n; ++i) out[i] = out[i - dist];
      if (length > n) {
        pos += n;
        break;
      }
    } else if (code < 256 + 24 + cache_size) {
      while (cached < pos) {
        cache[(out[cached] * 0x1E35A7BDu) >> shift] = out[cached];
        ++cached;
      }
      out[pos] = cache[code - 256 - 24];
      n = 1;
    } else {
      return 6;
    }
    pos += n;
    col += static_cast<int>(n % xsize);
    row += static_cast<int>(n / xsize);
    while (col >= xsize) {
      col -= xsize;
      ++row;
    }
    if (cache_size) {
      while (cached < pos) {
        cache[(out[cached] * 0x1E35A7BDu) >> shift] = out[cached];
        ++cached;
      }
    }
  }
  if (br.eos) return 1;
  if (!level0) return 0;
  for (int i = static_cast<int>(transforms.size()) - 1; i >= 0; --i) inverse(transforms[i], rows, out);
  return 0;
}

// ------------------------------------------------------------------- VP8

struct BoolDec {
  const uint8_t* data;
  int64_t pos, end;
  uint64_t value;
  int bits;
  uint32_t range;
  bool eof;
  void init(const uint8_t* d, int64_t start, int64_t stop) {
    data = d;
    pos = start;
    end = stop;
    value = 0;
    bits = -8;
    range = 254;
    eof = false;
    load();
  }
  void load() {
    if (pos < end) {
      bits += 8;
      value = data[pos++] | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int get(int prob) {
    if (bits < 0) load();
    const int p = bits;
    uint32_t rng = range;
    const uint32_t split = (rng * static_cast<uint32_t>(prob)) >> 8;
    int bit;
    if ((value >> p) > split) {
      rng -= split;
      value -= static_cast<uint64_t>(split + 1) << p;
      bit = 1;
    } else {
      rng = split + 1;
      bit = 0;
    }
    int len = 0;
    for (uint32_t r = rng; r; r >>= 1) ++len;
    const int shift = 8 - len;
    bits -= shift;
    range = (rng << shift) - 1;
    return bit;
  }
  int get_signed(int v) {
    if (bits < 0) load();
    const int p = bits;
    const uint32_t split = range >> 1;
    bits -= 1;
    if ((value >> p) > split) {
      range = (range - 1) | 1;
      value -= static_cast<uint64_t>(split + 1) << p;
      return -v;
    }
    range |= 1;
    return v;
  }
  int value_bits(int n) {
    int v = 0;
    while (n-- > 0) v |= get(0x80) << n;
    return v;
  }
  int signed_value(int n) {
    int v = value_bits(n);
    return get(0x80) ? -v : v;
  }
};

const int kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const int kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};
const int kYModesIntra4[18] = {0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9};

inline int clipq(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }
inline int16_t wrap16(int v) { return static_cast<int16_t>(static_cast<uint16_t>(v)); }
inline uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

struct Frame {
  int width, height, mb_w, mb_h;
  BoolDec br;
  std::vector<BoolDec> parts;
  int use_segment = 0, update_map = 0, absolute = 1;
  int quantizer[4] = {0}, filter_strength[4] = {0};
  int seg_proba[3] = {255, 255, 255};
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0, filter_type = 0;
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  int dq[4][3][2];  // segment, (y1, y2, uv), (dc, ac)
  uint8_t proba[4][8][3][11];
  int use_skip = 0, skip_p = 0;
  int fstrength[4][2][3];  // limit, ilevel, hev
};

int parse_header(const uint8_t* data, int64_t len, Frame& f) {
  if (len < 10 || data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return 10;
  const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  if ((bits & 1) || ((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) || (bits >> 5) >= len) return 10;
  f.width = (data[6] | (data[7] << 8)) & 0x3FFF;
  f.height = (data[8] | (data[9] << 8)) & 0x3FFF;
  if (!f.width || !f.height) return 10;
  f.mb_w = (f.width + 15) >> 4;
  f.mb_h = (f.height + 15) >> 4;
  const int64_t part0 = bits >> 5, start = 10;
  if (part0 > len - start) return 11;
  BoolDec& br = f.br;
  br.init(data, start, start + part0);
  br.get(0x80);
  br.get(0x80);
  f.use_segment = br.get(0x80);
  if (f.use_segment) {
    f.update_map = br.get(0x80);
    if (br.get(0x80)) {
      f.absolute = br.get(0x80);
      for (int s = 0; s < 4; ++s) f.quantizer[s] = br.get(0x80) ? br.signed_value(7) : 0;
      for (int s = 0; s < 4; ++s) f.filter_strength[s] = br.get(0x80) ? br.signed_value(6) : 0;
    }
    if (f.update_map) {
      for (int s = 0; s < 3; ++s) f.seg_proba[s] = br.get(0x80) ? br.value_bits(8) : 255;
    }
  }
  if (br.eof) return 12;
  f.simple = br.get(0x80);
  f.level = br.value_bits(6);
  f.sharpness = br.value_bits(3);
  f.use_lf_delta = br.get(0x80);
  if (f.use_lf_delta && br.get(0x80)) {
    for (int i = 0; i < 4; ++i) {
      if (br.get(0x80)) f.ref_lf_delta[i] = br.signed_value(6);
    }
    for (int i = 0; i < 4; ++i) {
      if (br.get(0x80)) f.mode_lf_delta[i] = br.signed_value(6);
    }
  }
  f.filter_type = f.level == 0 ? 0 : f.simple ? 1 : 2;
  if (br.eof) return 13;
  const int nparts = 1 << br.value_bits(2);
  const int64_t sizes = start + part0;
  int64_t part_start = sizes + 3 * (nparts - 1);
  if (part_start > len) return 14;
  int64_t left = len - part_start;
  f.parts.resize(nparts);
  for (int p = 0; p < nparts - 1; ++p) {
    int64_t psize = data[sizes + 3 * p] | (data[sizes + 3 * p + 1] << 8) | (data[sizes + 3 * p + 2] << 16);
    if (psize > left) psize = left;
    f.parts[p].init(data, part_start, part_start + psize);
    part_start += psize;
    left -= psize;
  }
  f.parts[nparts - 1].init(data, part_start, len);
  if (part_start >= len) return 14;
  const int base_q0 = br.value_bits(7);
  int d[5];
  for (int i = 0; i < 5; ++i) d[i] = br.get(0x80) ? br.signed_value(4) : 0;
  for (int i = 0; i < 4; ++i) {
    int q;
    if (f.use_segment) {
      q = f.quantizer[i] + (f.absolute ? 0 : base_q0);
    } else if (i > 0) {
      std::memcpy(f.dq[i], f.dq[0], sizeof(f.dq[0]));
      continue;
    } else {
      q = base_q0;
    }
    f.dq[i][0][0] = kDcTable[clipq(q + d[0], 127)];
    f.dq[i][0][1] = kAcTable[clipq(q, 127)];
    f.dq[i][1][0] = kDcTable[clipq(q + d[1], 127)] * 2;
    int y2ac = (kAcTable[clipq(q + d[2], 127)] * 101581) >> 16;
    f.dq[i][1][1] = y2ac < 8 ? 8 : y2ac;
    f.dq[i][2][0] = kDcTable[clipq(q + d[3], 117)];
    f.dq[i][2][1] = kAcTable[clipq(q + d[4], 127)];
  }
  br.get(0x80);
  int k = 0;
  for (int t = 0; t < 4; ++t) {
    for (int b = 0; b < 8; ++b) {
      for (int c = 0; c < 3; ++c) {
        for (int p = 0; p < 11; ++p, ++k) {
          f.proba[t][b][c][p] = static_cast<uint8_t>(
              br.get(kCoeffsUpdateProba[k]) ? br.value_bits(8) : kCoeffsProba0[k]);
        }
      }
    }
  }
  f.use_skip = br.get(0x80);
  f.skip_p = f.use_skip ? br.value_bits(8) : 0;
  for (int s = 0; s < 4; ++s) {
    int base = f.use_segment ? f.filter_strength[s] + (f.absolute ? 0 : f.level) : f.level;
    for (int i4 = 0; i4 < 2; ++i4) {
      int level = base;
      if (f.use_lf_delta) {
        level += f.ref_lf_delta[0];
        if (i4) level += f.mode_lf_delta[0];
      }
      level = clipq(level, 63);
      if (level > 0) {
        int il = level;
        if (f.sharpness > 0) {
          il >>= f.sharpness > 4 ? 2 : 1;
          if (il > 9 - f.sharpness) il = 9 - f.sharpness;
        }
        if (il < 1) il = 1;
        f.fstrength[s][i4][0] = 2 * level + il;
        f.fstrength[s][i4][1] = il;
        f.fstrength[s][i4][2] = level >= 40 ? 2 : level >= 15 ? 1 : 0;
      } else {
        f.fstrength[s][i4][0] = f.fstrength[s][i4][1] = f.fstrength[s][i4][2] = 0;
      }
    }
  }
  return 0;
}

struct MB {
  int seg, skip, i4, uv;
  int modes[16];
};

void parse_modes(Frame& f, uint8_t* intra_t, uint8_t* intra_l, int mb_x, MB& mb) {
  BoolDec& br = f.br;
  if (f.update_map) {
    mb.seg = !br.get(f.seg_proba[0]) ? br.get(f.seg_proba[1]) : br.get(f.seg_proba[2]) + 2;
  } else {
    mb.seg = 0;
  }
  mb.skip = f.use_skip ? br.get(f.skip_p) : 0;
  mb.i4 = !br.get(145);
  uint8_t* top = intra_t + 4 * mb_x;
  if (!mb.i4) {
    int ymode = br.get(156) ? (br.get(128) ? 1 : 3) : (br.get(163) ? 2 : 0);
    mb.modes[0] = ymode;
    std::memset(top, ymode, 4);
    std::memset(intra_l, ymode, 4);
  } else {
    for (int y = 0; y < 4; ++y) {
      int ymode = intra_l[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* prob = kBModesProba + 90 * top[x] + 9 * ymode;
        int i = kYModesIntra4[br.get(prob[0])];
        while (i > 0) i = kYModesIntra4[2 * i + br.get(prob[i])];
        ymode = -i;
        top[x] = static_cast<uint8_t>(ymode);
      }
      for (int x = 0; x < 4; ++x) mb.modes[4 * y + x] = top[x];
      intra_l[y] = static_cast<uint8_t>(ymode);
    }
  }
  mb.uv = !br.get(142) ? 0 : !br.get(114) ? 2 : br.get(183) ? 1 : 3;
}

int large_value(BoolDec& br, const uint8_t* p) {
  if (!br.get(p[3])) {
    if (!br.get(p[4])) return 2;
    return 3 + br.get(p[5]);
  }
  if (!br.get(p[6])) {
    if (!br.get(p[7])) return 5 + br.get(159);
    int v = 7 + 2 * br.get(165);
    return v + br.get(145);
  }
  const int bit1 = br.get(p[8]);
  const int bit0 = br.get(p[9 + bit1]);
  const int cat = 2 * bit1 + bit0;
  int v = 0;
  for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get(*tab);
  return v + 3 + (8 << cat);
}

int get_coeffs(BoolDec& br, const uint8_t (*band)[3][11], int ctx, const int* dq, int n, int16_t* out) {
  const uint8_t* p = band[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.get(p[0])) return n;
    while (!br.get(p[1])) {
      ++n;
      if (n == 16) return 16;
      p = band[kBands[n]][0];
    }
    int v;
    const int nb = kBands[n + 1];
    if (!br.get(p[2])) {
      v = 1;
      p = band[nb][1];
    } else {
      v = large_value(br, p);
      p = band[nb][2];
    }
    out[kZigzag[n]] = wrap16(br.get_signed(v) * dq[n > 0]);
  }
  return 16;
}

void wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[i] - in[12 + i];
    tmp[i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[4 * i] + 3;
    const int a0 = dc + tmp[4 * i + 3], a1 = tmp[4 * i + 1] + tmp[4 * i + 2];
    const int a2 = tmp[4 * i + 1] - tmp[4 * i + 2], a3 = dc - tmp[4 * i + 3];
    int16_t* o = out + 64 * i;
    o[0] = wrap16((a0 + a1) >> 3);
    o[16] = wrap16((a3 + a2) >> 3);
    o[32] = wrap16((a0 - a1) >> 3);
    o[48] = wrap16((a3 - a2) >> 3);
  }
}

inline int nz_code(int nz, int dc) { return nz > 3 ? 3 : nz > 1 ? 2 : dc != 0; }

// Coefficients of one macroblock and each block's nz code (libwebp's
// NzCodeBits: 16 luma, 4 U, 4 V).
void residuals(Frame& f, BoolDec& br, const MB& mb, uint8_t* tnz, uint8_t* lnz, int16_t* c,
               int* codes) {
  const int (*q)[2] = f.dq[mb.seg];
  std::memset(c, 0, 384 * sizeof(int16_t));
  int first;
  const uint8_t(*ac)[3][11];
  if (!mb.i4) {
    int16_t dc[16] = {0};
    const int nz = get_coeffs(br, f.proba[1], tnz[8] + lnz[8], q[1], 0, dc);
    tnz[8] = lnz[8] = nz > 0;
    if (nz > 1) {
      wht(dc, c);
    } else {
      const int16_t dc0 = wrap16((dc[0] + 3) >> 3);
      for (int i = 0; i < 16; ++i) c[16 * i] = dc0;
    }
    first = 1;
    ac = f.proba[0];
  } else {
    first = 0;
    ac = f.proba[3];
  }
  for (int y = 0; y < 4; ++y) {
    int l = lnz[y];
    for (int x = 0; x < 4; ++x) {
      int16_t* b = c + 16 * (4 * y + x);
      const int nz = get_coeffs(br, ac, l + tnz[x], q[0], first, b);
      l = nz > first;
      tnz[x] = static_cast<uint8_t>(l);
      codes[4 * y + x] = nz_code(nz, b[0]);
    }
    lnz[y] = static_cast<uint8_t>(l);
  }
  for (int ch = 0; ch < 2; ++ch) {
    for (int y = 0; y < 2; ++y) {
      int l = lnz[4 + 2 * ch + y];
      for (int x = 0; x < 2; ++x) {
        int16_t* b = c + 256 + 64 * ch + 16 * (2 * y + x);
        const int nz = get_coeffs(br, f.proba[2], l + tnz[4 + 2 * ch + x], q[2], 0, b);
        l = nz > 0;
        tnz[4 + 2 * ch + x] = static_cast<uint8_t>(l);
        codes[16 + 4 * ch + 2 * y + x] = nz_code(nz, b[0]);
      }
      lnz[4 + 2 * ch + y] = static_cast<uint8_t>(l);
    }
  }
}

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }
// libwebp's SSE2 transform: the same steps in 16-bit lanes that wrap.
inline int w16(int v) { return static_cast<int16_t>(static_cast<uint16_t>(v)); }
inline int mul1_simd(int a) { return w16(((a * 20091) >> 16) + a); }
inline int mul2_simd(int a) { return w16(((a * -30068) >> 16) + a); }

constexpr int WS = 21;  // work buffer stride: left column, 16 pixels, 4 top-right

// The inverse DCT of one block added with clipping: libwebp's C transform
// in ints, or (simd) its SSE2 one.
template <bool kSimd>
void idct_add(const int16_t* in, int* ws, int y0, int x0) {
  auto w = [](int v) { return kSimd ? w16(v) : v; };
  auto m1 = [](int v) { return kSimd ? mul1_simd(v) : mul1(v); };
  auto m2 = [](int v) { return kSimd ? mul2_simd(v) : mul2(v); };
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a = w(in[i] + in[8 + i]), b = w(in[i] - in[8 + i]);
    const int c = w(m2(in[4 + i]) - m1(in[12 + i]));
    const int d = w(m1(in[4 + i]) + m2(in[12 + i]));
    tmp[4 * i] = w(a + d);
    tmp[4 * i + 1] = w(b + c);
    tmp[4 * i + 2] = w(b - c);
    tmp[4 * i + 3] = w(a - d);
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = w(tmp[i] + 4);
    const int a = w(dc + tmp[8 + i]), b = w(dc - tmp[8 + i]);
    const int c = w(m2(tmp[4 + i]) - m1(tmp[12 + i]));
    const int d = w(m1(tmp[4 + i]) + m2(tmp[12 + i]));
    int* row = ws + (y0 + i) * WS + x0;
    const int v[4] = {a + d, b + c, b - c, a - d};
    for (int x = 0; x < 4; ++x) row[x] = clip8(row[x] + (w(v[x]) >> 3));
  }
}

void transform(const int16_t* in, int* ws, int y0, int x0, bool simd) {
  if (simd) idct_add<true>(in, ws, y0, x0);
  else idct_add<false>(in, ws, y0, x0);
}

inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2i(int a, int b) { return (a + b + 1) >> 1; }

void pred4(int mode, int* ws, int y, int x) {
  const int* top = ws + (y - 1) * WS + x;
  const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5], G = top[6],
            H = top[7], X = top[-1];
  const int I = ws[y * WS + x - 1], J = ws[(y + 1) * WS + x - 1], K = ws[(y + 2) * WS + x - 1],
            L = ws[(y + 3) * WS + x - 1];
  int blk[4][4];
#define P(px, py) blk[py][px]
  switch (mode) {
    case 0: {
      const int v = (A + B + C + D + I + J + K + L + 4) >> 3;
      for (auto& r : blk) for (int& e : r) e = v;
      break;
    }
    case 1: {
      const int t[4] = {A, B, C, D}, l[4] = {I, J, K, L};
      for (int r = 0; r < 4; ++r) for (int q = 0; q < 4; ++q) blk[r][q] = clip8(t[q] + l[r] - X);
      break;
    }
    case 2: {
      const int r0[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (auto& r : blk) for (int q = 0; q < 4; ++q) r[q] = r0[q];
      break;
    }
    case 3: {
      const int v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
      for (int r = 0; r < 4; ++r) for (int q = 0; q < 4; ++q) blk[r][q] = v[r];
      break;
    }
    case 4:
      P(0, 3) = avg3(J, K, L);
      P(1, 3) = P(0, 2) = avg3(I, J, K);
      P(2, 3) = P(1, 2) = P(0, 1) = avg3(X, I, J);
      P(3, 3) = P(2, 2) = P(1, 1) = P(0, 0) = avg3(A, X, I);
      P(3, 2) = P(2, 1) = P(1, 0) = avg3(B, A, X);
      P(3, 1) = P(2, 0) = avg3(C, B, A);
      P(3, 0) = avg3(D, C, B);
      break;
    case 5:
      P(0, 0) = P(1, 2) = avg2i(X, A);
      P(1, 0) = P(2, 2) = avg2i(A, B);
      P(2, 0) = P(3, 2) = avg2i(B, C);
      P(3, 0) = avg2i(C, D);
      P(0, 3) = avg3(K, J, I);
      P(0, 2) = avg3(J, I, X);
      P(0, 1) = P(1, 3) = avg3(I, X, A);
      P(1, 1) = P(2, 3) = avg3(X, A, B);
      P(2, 1) = P(3, 3) = avg3(A, B, C);
      P(3, 1) = avg3(B, C, D);
      break;
    case 6:
      P(0, 0) = avg3(A, B, C);
      P(1, 0) = P(0, 1) = avg3(B, C, D);
      P(2, 0) = P(1, 1) = P(0, 2) = avg3(C, D, E);
      P(3, 0) = P(2, 1) = P(1, 2) = P(0, 3) = avg3(D, E, F);
      P(3, 1) = P(2, 2) = P(1, 3) = avg3(E, F, G);
      P(3, 2) = P(2, 3) = avg3(F, G, H);
      P(3, 3) = avg3(G, H, H);
      break;
    case 7:
      P(0, 0) = avg2i(A, B);
      P(1, 0) = P(0, 2) = avg2i(B, C);
      P(2, 0) = P(1, 2) = avg2i(C, D);
      P(3, 0) = P(2, 2) = avg2i(D, E);
      P(0, 1) = avg3(A, B, C);
      P(1, 1) = P(0, 3) = avg3(B, C, D);
      P(2, 1) = P(1, 3) = avg3(C, D, E);
      P(3, 1) = P(2, 3) = avg3(D, E, F);
      P(3, 2) = avg3(E, F, G);
      P(3, 3) = avg3(F, G, H);
      break;
    case 8:
      P(0, 0) = P(2, 1) = avg2i(I, X);
      P(0, 1) = P(2, 2) = avg2i(J, I);
      P(0, 2) = P(2, 3) = avg2i(K, J);
      P(0, 3) = avg2i(L, K);
      P(3, 0) = avg3(A, B, C);
      P(2, 0) = avg3(X, A, B);
      P(1, 0) = P(3, 1) = avg3(I, X, A);
      P(1, 1) = P(3, 2) = avg3(J, I, X);
      P(1, 2) = P(3, 3) = avg3(K, J, I);
      P(1, 3) = avg3(L, K, J);
      break;
    default:
      P(0, 0) = avg2i(I, J);
      P(2, 0) = P(0, 1) = avg2i(J, K);
      P(2, 1) = P(0, 2) = avg2i(K, L);
      P(1, 0) = avg3(I, J, K);
      P(3, 0) = P(1, 1) = avg3(J, K, L);
      P(3, 1) = P(1, 2) = avg3(K, L, L);
      P(3, 2) = P(2, 2) = P(0, 3) = P(1, 3) = P(2, 3) = P(3, 3) = L;
      break;
  }
#undef P
  for (int r = 0; r < 4; ++r) for (int q = 0; q < 4; ++q) ws[(y + r) * WS + x + q] = blk[r][q];
}

void pred_block(int mode, int* ws, int size, bool has_top, bool has_left) {
  const int shift = size == 16 ? 5 : 4;
  int st = 0, sl = 0;
  for (int i = 0; i < size; ++i) {
    st += ws[1 + i];
    sl += ws[(1 + i) * WS];
  }
  for (int r = 0; r < size; ++r) {
    int* row = ws + (1 + r) * WS + 1;
    for (int q = 0; q < size; ++q) {
      int v;
      if (mode == 0) {
        if (has_top && has_left) v = (st + sl + size) >> shift;
        else if (has_left) v = (sl + (size >> 1)) >> (shift - 1);
        else if (has_top) v = (st + (size >> 1)) >> (shift - 1);
        else v = 0x80;
      } else if (mode == 1) {
        v = clip8(ws[1 + q] + ws[(1 + r) * WS] - ws[0]);
      } else if (mode == 2) {
        v = ws[1 + q];
      } else {
        v = ws[(1 + r) * WS];
      }
      row[q] = v;
    }
  }
}

void workspace(const uint8_t* plane, int stride, int size, int mb_x, int mb_y, int extra, int* ws) {
  const int y0 = size * mb_y, x0 = size * mb_x;
  if (mb_y == 0) {
    for (int i = 0; i < size + 1 + extra; ++i) ws[i] = 127;
  } else {
    const uint8_t* above = plane + static_cast<int64_t>(y0 - 1) * stride;
    for (int i = 0; i < size; ++i) ws[1 + i] = above[x0 + i];
    ws[0] = mb_x > 0 ? above[x0 - 1] : 129;
    if (extra) {
      for (int i = 0; i < extra; ++i) {
        ws[size + 1 + i] = x0 + size >= stride ? above[x0 + size - 1] : above[x0 + size + i];
      }
    }
  }
  for (int i = 0; i < size; ++i) {
    ws[(1 + i) * WS] = mb_x > 0 ? plane[static_cast<int64_t>(y0 + i) * stride + x0 - 1] : 129;
  }
}

// Prediction and residuals of one macroblock; each block's transform is
// picked as libwebp's DoTransform / DoUVTransform pick it.
void reconstruct(const MB& mb, const int16_t* c, const int* codes, uint8_t* ys, uint8_t* us,
                 uint8_t* vs, int mb_w, int mb_x, int mb_y) {
  int ws[17 * WS];
  const int ystride = 16 * mb_w, cstride = 8 * mb_w;
  workspace(ys, ystride, 16, mb_x, mb_y, 4, ws);
  if (mb.i4) {
    int tr[4];
    for (int i = 0; i < 4; ++i) tr[i] = ws[17 + i];
    for (int n = 0; n < 16; ++n) {
      const int by = n >> 2, bx = n & 3;
      if (bx == 3 && by > 0) {
        for (int i = 0; i < 4; ++i) ws[4 * by * WS + 17 + i] = tr[i];
      }
      pred4(mb.modes[n], ws, 1 + 4 * by, 1 + 4 * bx);
      if (codes[n]) transform(c + 16 * n, ws, 1 + 4 * by, 1 + 4 * bx, codes[n] == 3);
    }
  } else {
    pred_block(mb.modes[0], ws, 16, mb_y > 0, mb_x > 0);
    for (int n = 0; n < 16; ++n) {
      if (codes[n]) transform(c + 16 * n, ws, 1 + 4 * (n >> 2), 1 + 4 * (n & 3), codes[n] == 3);
    }
  }
  for (int r = 0; r < 16; ++r) {
    uint8_t* dst = ys + static_cast<int64_t>(16 * mb_y + r) * ystride + 16 * mb_x;
    for (int q = 0; q < 16; ++q) dst[q] = static_cast<uint8_t>(ws[(1 + r) * WS + 1 + q]);
  }
  for (int ch = 0; ch < 2; ++ch) {
    uint8_t* plane = ch ? vs : us;
    workspace(plane, cstride, 8, mb_x, mb_y, 0, ws);
    pred_block(mb.uv, ws, 8, mb_y > 0, mb_x > 0);
    const int* pc = codes + 16 + 4 * ch;
    const int top = std::max(std::max(pc[0], pc[1]), std::max(pc[2], pc[3]));
    if (top) {
      for (int n = 0; n < 4; ++n) {
        transform(c + 256 + 64 * ch + 16 * n, ws, 1 + 4 * (n >> 1), 1 + 4 * (n & 1), top >= 2);
      }
    }
    for (int r = 0; r < 8; ++r) {
      uint8_t* dst = plane + static_cast<int64_t>(8 * mb_y + r) * cstride + 8 * mb_x;
      for (int q = 0; q < 8; ++q) dst[q] = static_cast<uint8_t>(ws[(1 + r) * WS + 1 + q]);
    }
  }
}

// ----------------------------------------------------------- loop filter

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

enum { SIMPLE = 0, MBEDGE = 1, INNER = 2 };

// One position across an edge: p points at q0, step between taps.
inline void filter_at(uint8_t* p, int64_t step, int t2, int ithresh, int hev_t, int mode) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t2) return;
  bool hev = true;
  if (mode != SIMPLE) {
    if (std::abs(p3 - p2) > ithresh || std::abs(p2 - p1) > ithresh || std::abs(p1 - p0) > ithresh ||
        std::abs(q3 - q2) > ithresh || std::abs(q2 - q1) > ithresh || std::abs(q1 - q0) > ithresh) {
      return;
    }
    hev = std::abs(p1 - p0) > hev_t || std::abs(q1 - q0) > hev_t;
  }
  if (hev) {
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
  } else if (mode == MBEDGE) {
    const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
    p[-3 * step] = clip8(p2 + a3);
    p[-2 * step] = clip8(p1 + a2);
    p[-step] = clip8(p0 + a1);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a2);
    p[2 * step] = clip8(q2 - a3);
  } else {
    const int a = 3 * (q0 - p0);
    const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
    p[-2 * step] = clip8(p1 + a3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a3);
  }
}

// The edge left of column x (rows y0..y0+n), or above row y (columns x0..x0+n).
void v_edge(uint8_t* plane, int64_t stride, int y0, int n, int x, int thresh, int it, int hev, int mode) {
  for (int i = 0; i < n; ++i) filter_at(plane + (y0 + i) * stride + x, 1, 2 * thresh + 1, it, hev, mode);
}
void h_edge(uint8_t* plane, int64_t stride, int x0, int n, int y, int thresh, int it, int hev, int mode) {
  for (int i = 0; i < n; ++i) filter_at(plane + y * stride + x0 + i, stride, 2 * thresh + 1, it, hev, mode);
}

void filter_mb(const Frame& f, const int* fi, uint8_t* ys, uint8_t* us, uint8_t* vs, int mb_x, int mb_y) {
  const int limit = fi[0], il = fi[1], hev = fi[2], inner = fi[3];
  if (limit == 0) return;
  const int64_t ystride = 16 * f.mb_w, cstride = 8 * f.mb_w;
  const int x0 = 16 * mb_x, y0 = 16 * mb_y, cx = 8 * mb_x, cy = 8 * mb_y;
  if (f.filter_type == 1) {
    if (mb_x > 0) v_edge(ys, ystride, y0, 16, x0, limit + 4, 0, 0, SIMPLE);
    if (inner) for (int k = 4; k < 16; k += 4) v_edge(ys, ystride, y0, 16, x0 + k, limit, 0, 0, SIMPLE);
    if (mb_y > 0) h_edge(ys, ystride, x0, 16, y0, limit + 4, 0, 0, SIMPLE);
    if (inner) for (int k = 4; k < 16; k += 4) h_edge(ys, ystride, x0, 16, y0 + k, limit, 0, 0, SIMPLE);
    return;
  }
  if (mb_x > 0) {
    v_edge(ys, ystride, y0, 16, x0, limit + 4, il, hev, MBEDGE);
    v_edge(us, cstride, cy, 8, cx, limit + 4, il, hev, MBEDGE);
    v_edge(vs, cstride, cy, 8, cx, limit + 4, il, hev, MBEDGE);
  }
  if (inner) {
    for (int k = 4; k < 16; k += 4) v_edge(ys, ystride, y0, 16, x0 + k, limit, il, hev, INNER);
    v_edge(us, cstride, cy, 8, cx + 4, limit, il, hev, INNER);
    v_edge(vs, cstride, cy, 8, cx + 4, limit, il, hev, INNER);
  }
  if (mb_y > 0) {
    h_edge(ys, ystride, x0, 16, y0, limit + 4, il, hev, MBEDGE);
    h_edge(us, cstride, cx, 8, cy, limit + 4, il, hev, MBEDGE);
    h_edge(vs, cstride, cx, 8, cy, limit + 4, il, hev, MBEDGE);
  }
  if (inner) {
    for (int k = 4; k < 16; k += 4) h_edge(ys, ystride, x0, 16, y0 + k, limit, il, hev, INNER);
    h_edge(us, cstride, cx, 8, cy + 4, limit, il, hev, INNER);
    h_edge(vs, cstride, cx, 8, cy + 4, limit, il, hev, INNER);
  }
}

// ------------------------------------------------------------- YUV->RGB

inline int yuv_clip(int v) { return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255; }

inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  const int yy = (y * 19077) >> 8;
  rgb[0] = static_cast<uint8_t>(yuv_clip(yy + ((v * 26149) >> 8) - 14234));
  rgb[1] = static_cast<uint8_t>(yuv_clip(yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708));
  rgb[2] = static_cast<uint8_t>(yuv_clip(yy + ((u * 33050) >> 8) - 17685));
}

// libwebp's UPSAMPLE_FUNC: a row pair (bottom optional) from the chroma
// rows above (tu, tv) and below (cu, cv), both lanes at once.
void upsample_pair(const uint8_t* ty, const uint8_t* by, const uint8_t* tu, const uint8_t* tv,
                   const uint8_t* cu, const uint8_t* cv, uint8_t* tdst, uint8_t* bdst, int len) {
  auto load = [](uint8_t u, uint8_t v) { return static_cast<uint32_t>(u) | (static_cast<uint32_t>(v) << 16); };
  const int last_pair = (len - 1) >> 1;
  uint32_t tl = load(tu[0], tv[0]), l = load(cu[0], cv[0]);
  {
    const uint32_t uv0 = (3 * tl + l + 0x00020002u) >> 2;
    yuv_to_rgb(ty[0], uv0 & 0xff, uv0 >> 16, tdst);
  }
  if (by) {
    const uint32_t uv0 = (3 * l + tl + 0x00020002u) >> 2;
    yuv_to_rgb(by[0], uv0 & 0xff, uv0 >> 16, bdst);
  }
  for (int x = 1; x <= last_pair; ++x) {
    const uint32_t t = load(tu[x], tv[x]), c = load(cu[x], cv[x]);
    const uint32_t avg = tl + t + l + c + 0x00080008u;
    const uint32_t d12 = (avg + 2 * (t + l)) >> 3, d03 = (avg + 2 * (tl + c)) >> 3;
    uint32_t uv0 = (d12 + tl) >> 1, uv1 = (d03 + t) >> 1;
    yuv_to_rgb(ty[2 * x - 1], uv0 & 0xff, uv0 >> 16, tdst + 3 * (2 * x - 1));
    yuv_to_rgb(ty[2 * x], uv1 & 0xff, uv1 >> 16, tdst + 3 * (2 * x));
    if (by) {
      uv0 = (d03 + l) >> 1;
      uv1 = (d12 + c) >> 1;
      yuv_to_rgb(by[2 * x - 1], uv0 & 0xff, uv0 >> 16, bdst + 3 * (2 * x - 1));
      yuv_to_rgb(by[2 * x], uv1 & 0xff, uv1 >> 16, bdst + 3 * (2 * x));
    }
    tl = t;
    l = c;
  }
  if (!(len & 1)) {
    uint32_t uv0 = (3 * tl + l + 0x00020002u) >> 2;
    yuv_to_rgb(ty[len - 1], uv0 & 0xff, uv0 >> 16, tdst + 3 * (len - 1));
    if (by) {
      uv0 = (3 * l + tl + 0x00020002u) >> 2;
      yuv_to_rgb(by[len - 1], uv0 & 0xff, uv0 >> 16, bdst + 3 * (len - 1));
    }
  }
}

}  // namespace

extern "C" {

int webp_vp8l_decode(const uint8_t* data, int64_t len, int64_t start, int width, int height,
                     int max_rows, uint32_t* out) {
  LBits br{data, len, static_cast<uint64_t>(8 * start), static_cast<uint64_t>(8 * len), false};
  std::vector<uint32_t> px;
  int rc = decode_stream(br, width, height, true, max_rows, px);
  if (rc) return rc;
  std::memcpy(out, px.data(), px.size() * sizeof(uint32_t));
  return 0;
}

void webp_alpha_unfilter(int kind, uint8_t* a, int w, int h) {
  if (kind == 0) return;
  for (int x = 1; x < w; ++x) a[x] = static_cast<uint8_t>(a[x] + a[x - 1]);
  for (int y = 1; y < h; ++y) {
    uint8_t* row = a + static_cast<int64_t>(y) * w;
    const uint8_t* prev = row - w;
    if (kind == 1) {
      uint8_t pred = prev[0];
      for (int x = 0; x < w; ++x) pred = row[x] = static_cast<uint8_t>(pred + row[x]);
    } else if (kind == 2) {
      for (int x = 0; x < w; ++x) row[x] = static_cast<uint8_t>(row[x] + prev[x]);
    } else {
      int left = prev[0], top_left = prev[0];
      for (int x = 0; x < w; ++x) {
        const int top = prev[x];
        const int g = clip8(left + top - top_left);
        left = (row[x] + g) & 0xFF;
        top_left = top;
        row[x] = static_cast<uint8_t>(left);
      }
    }
  }
}

int webp_vp8_decode(const uint8_t* data, int64_t len, int max_mb_rows, uint8_t* ys, uint8_t* us,
                    uint8_t* vs) {
  Frame f;
  int rc = parse_header(data, len, f);
  if (rc) return rc;
  const int rows = max_mb_rows < f.mb_h ? max_mb_rows : f.mb_h;
  std::vector<uint8_t> intra_t(4 * f.mb_w, 0);
  std::vector<uint8_t> tnz(9 * f.mb_w, 0);
  std::vector<int> finfo(4 * static_cast<size_t>(f.mb_w) * rows, 0);
  std::vector<MB> mbs(f.mb_w);
  int16_t coeffs[384];
  int codes[24];
  for (int mb_y = 0; mb_y < rows; ++mb_y) {
    uint8_t intra_l[4] = {0, 0, 0, 0};
    uint8_t lnz[9] = {0};
    for (int x = 0; x < f.mb_w; ++x) parse_modes(f, intra_t.data(), intra_l, x, mbs[x]);
    if (f.br.eof) return 20;
    BoolDec& br = f.parts[mb_y & (f.parts.size() - 1)];
    for (int mb_x = 0; mb_x < f.mb_w; ++mb_x) {
      const MB& mb = mbs[mb_x];
      uint8_t* t = tnz.data() + 9 * mb_x;
      bool skip;
      if (!mb.skip) {
        residuals(f, br, mb, t, lnz, coeffs, codes);
        skip = true;
        for (int k = 0; k < 24; ++k) skip = skip && !codes[k];
      } else {
        std::memset(coeffs, 0, sizeof(coeffs));
        std::memset(codes, 0, sizeof(codes));
        std::memset(lnz, 0, 8);
        std::memset(t, 0, 8);
        if (!mb.i4) lnz[8] = t[8] = 0;
        skip = true;
      }
      if (br.eof) return 21;
      reconstruct(mb, coeffs, codes, ys, us, vs, f.mb_w, mb_x, mb_y);
      if (f.filter_type) {
        int* fi = finfo.data() + 4 * (static_cast<size_t>(mb_y) * f.mb_w + mb_x);
        const int* s = f.fstrength[mb.seg][mb.i4 ? 1 : 0];
        fi[0] = s[0];
        fi[1] = s[1];
        fi[2] = s[2];
        fi[3] = mb.i4 || !skip;
      }
    }
  }
  if (f.filter_type) {
    for (int mb_y = 0; mb_y < rows; ++mb_y) {
      for (int mb_x = 0; mb_x < f.mb_w; ++mb_x) {
        filter_mb(f, finfo.data() + 4 * (static_cast<size_t>(mb_y) * f.mb_w + mb_x), ys, us, vs, mb_x, mb_y);
      }
    }
  }
  return 0;
}

// libwebp's EmitFancyRGB over whole planes (strides ys, uvs) to w x h RGB.
void webp_yuv_to_rgb(const uint8_t* y, const uint8_t* u, const uint8_t* v, int ys, int uvs, int w,
                     int h, uint8_t* rgb) {
  const int64_t rs = 3 * static_cast<int64_t>(w);
  upsample_pair(y, nullptr, u, v, u, v, rgb, nullptr, w);
  for (int k = 1; 2 * k - 1 < h; ++k) {
    const uint8_t* bottom = 2 * k < h ? y + static_cast<int64_t>(2 * k) * ys : nullptr;
    const uint8_t* cu = 2 * k < h ? u + static_cast<int64_t>(k) * uvs : u + static_cast<int64_t>(k - 1) * uvs;
    const uint8_t* cv = 2 * k < h ? v + static_cast<int64_t>(k) * uvs : v + static_cast<int64_t>(k - 1) * uvs;
    upsample_pair(y + static_cast<int64_t>(2 * k - 1) * ys, bottom, u + static_cast<int64_t>(k - 1) * uvs,
                  v + static_cast<int64_t>(k - 1) * uvs, cu, cv, rgb + (2 * k - 1) * rs,
                  bottom ? rgb + 2 * k * rs : nullptr, w);
  }
}

}  // extern "C"
