// Entropy decoder of JPEG scans: host code, no device kernel.
//
// The JAX package decodes a PDF's DCTDecode streams with PIL
// (rapiddoc_tpu/pdfio/images.py), where libjpeg-turbo's Huffman decoder
// runs in C. The port's decoder (pdfio/jpeg.py) replays libjpeg-turbo's
// arithmetic in numpy everywhere but here: the entropy decode is one
// sequential pass over the bits, a symbol at a time, which Python runs at
// about a microsecond a symbol. This file is that pass compiled. It is
// built by nvcc like the kernels (ops/build.py, one plain C entry point,
// no PyTorch header) and loaded with ctypes; pdfio/jpeg.py's
// decode_coefficients_plain is its plain version, bit for bit.
//
// One call of jpeg_entropy_decode decodes one sequential scan, one of
// jpeg_progressive_decode one progressive scan (jdphuff.c: DC first and
// refinement, AC first with end-of-band runs, AC refinement with its
// correction bits), reading and refining the coefficients in `out`.
// Both take Huffman symbols through 16-bit lookahead
// tables built in Python (entry = length << 8 | symbol, 0 for no code),
// DC prediction, byte unstuffing and restart markers. It writes each
// block's 64 coefficients in natural order into `out` and returns 0, or
// a negative code for corrupt data (the wrapper raises): -1 a bad Huffman
// code, -2 a coefficient index past 63, -3 more bits consumed than the
// segment holds, -4 a missing or misplaced restart marker, -5 a scan of
// no components or of more than 4 (JPEG's most; the parser raises first).

#include <cstdint>

namespace {

// jpeg_natural_order with libjpeg's 16 guard entries (a corrupt run past
// coefficient 63 lands on 63)
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63,
};

// MSB-first bit buffer over one restart segment. Past the segment's end
// (a marker or the end of the scan) it appends zero bits and counts them
// in `fill`, so that consuming any of them is detected.
struct Bits {
  const uint8_t* data;
  long long pos, end;
  uint64_t acc = 0;
  int nbits = 0, fill = 0;
  bool stopped = false;

  void refill() {
    while (nbits <= 56) {
      uint64_t byte = 0;
      if (!stopped && pos < end) {
        uint8_t c = data[pos];
        if (c != 0xFF) {
          byte = c;
          ++pos;
        } else if (pos + 1 < end && data[pos + 1] == 0x00) {
          byte = 0xFF;
          pos += 2;
        } else {
          stopped = true;  // a marker: the segment ends here
          fill += 8;
        }
      } else {
        fill += 8;
      }
      acc |= byte << (56 - nbits);
      nbits += 8;
    }
  }

  // false when fewer than n real bits are left
  bool consume(int n) {
    if (n > nbits - fill) return false;
    acc <<= n;
    nbits -= n;
    return true;
  }

  void restart() {
    acc = 0;
    nbits = fill = 0;
    stopped = false;
  }
};

// The code of the next marker at or after `pos`, skipping stray bytes,
// stuffed 0xFF 0x00 pairs and fill bytes as libjpeg's next_marker does,
// with *after set past it; -1 when the scan holds none.
int next_marker(const uint8_t* data, long long pos, long long end, long long* after) {
  while (pos < end) {
    if (data[pos] != 0xFF) {
      ++pos;
      continue;
    }
    long long q = pos + 1;
    while (q < end && data[q] == 0xFF) ++q;
    if (q >= end) return -1;
    if (data[q] != 0x00) {
      *after = q + 1;
      return data[q];
    }
    pos = q + 1;
  }
  return -1;
}

// Huffman symbol through a 16-bit lookahead table; -1 for no code.
inline int symbol(Bits& b, const uint16_t* lut) {
  if (b.nbits < 32) b.refill();
  uint16_t e = lut[b.acc >> 48];
  if (e == 0 || !b.consume(e >> 8)) return e == 0 ? -1 : -3;
  return e & 0xFF;
}

// s extra bits as a signed value (libjpeg's HUFF_EXTEND); INT32_MIN when
// the segment runs out.
inline int receive(Bits& b, int s) {
  int r = static_cast<int>(b.acc >> (64 - s));
  if (!b.consume(s)) return INT32_MIN;
  return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
}

}  // namespace

// One scan. luts: 2 * n_comps tables of 65536 entries (dc, ac for each
// scan component); comp: 4 ints per scan component (h, v, blocks_w,
// first block in `out`); an MCU holds h x v blocks of each component,
// row-major. restart_interval 0: no restart markers.
extern "C" int jpeg_entropy_decode(const uint8_t* data, long long begin, long long end,
                                   const uint16_t* luts, int n_comps, const int* comp,
                                   int mcus_x, int mcus_y, int restart_interval,
                                   int16_t* out) {
  if (n_comps < 1 || n_comps > 4) return -5;
  Bits b{data, begin, end};
  int pred[4] = {0, 0, 0, 0};
  const long long total = static_cast<long long>(mcus_x) * mcus_y;
  int restarts = 0;
  for (long long mcu = 0; mcu < total; ++mcu) {
    if (restart_interval && mcu && mcu % restart_interval == 0) {
      long long at = 0;
      if (next_marker(data, b.pos, end, &at) != 0xD0 + restarts % 8) return -4;
      ++restarts;
      b.pos = at;
      b.restart();
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
    }
    const long long my = mcu / mcus_x, mx = mcu % mcus_x;
    for (int k = 0; k < n_comps; ++k) {
      const int h = comp[4 * k], v = comp[4 * k + 1], bw = comp[4 * k + 2];
      const long long off = comp[4 * k + 3];
      const uint16_t* dc = luts + (2 * k) * 65536LL;
      const uint16_t* ac = luts + (2 * k + 1) * 65536LL;
      for (int by = 0; by < v; ++by) {
        for (int bx = 0; bx < h; ++bx) {
          int16_t* blk = out + (off + (my * v + by) * bw + mx * h + bx) * 64;
          int s = symbol(b, dc);
          if (s < 0) return s;
          if (s) {
            int r = receive(b, s);
            if (r == INT32_MIN) return -3;
            pred[k] += r;
          }
          blk[0] = static_cast<int16_t>(pred[k]);
          for (int z = 1; z < 64;) {
            int rs = symbol(b, ac);
            if (rs < 0) return rs;
            s = rs & 15;
            if (s) {
              z += rs >> 4;
              if (z > 63) return -2;
              int r = receive(b, s);
              if (r == INT32_MIN) return -3;
              blk[kNatural[z]] = static_cast<int16_t>(r);
              ++z;
            } else if (rs == 0xF0) {
              z += 16;
            } else {
              break;
            }
          }
        }
      }
    }
  }
  // a restart marker after the last MCU means the scan held more MCUs
  long long at = 0;
  const int m = next_marker(data, b.pos, end, &at);
  if (m >= 0xD0 && m <= 0xD7) return -4;
  return 0;
}

// n raw bits (n <= 16); -1 when the segment runs out
inline int raw_bits(Bits& b, int n) {
  if (b.nbits < 32) b.refill();
  int r = static_cast<int>(b.acc >> (64 - n));
  if (!b.consume(n)) return -1;
  return r;
}

// One progressive scan (ss, se, ah, al as in its SOS), over the same
// arguments as jpeg_entropy_decode; an AC scan has one component. The
// blocks it touches are refined in place in `out`.
extern "C" int jpeg_progressive_decode(const uint8_t* data, long long begin, long long end,
                                       const uint16_t* luts, int n_comps, const int* comp,
                                       int mcus_x, int mcus_y, int restart_interval, int ss,
                                       int se, int ah, int al, int16_t* out) {
  if (n_comps < 1 || n_comps > 4) return -5;
  Bits b{data, begin, end};
  int pred[4] = {0, 0, 0, 0};
  unsigned eobrun = 0;
  const int p1 = 1 << al, m1 = -(1 << al);
  const long long total = static_cast<long long>(mcus_x) * mcus_y;
  int restarts = 0;
  for (long long mcu = 0; mcu < total; ++mcu) {
    if (restart_interval && mcu && mcu % restart_interval == 0) {
      long long at = 0;
      if (next_marker(data, b.pos, end, &at) != 0xD0 + restarts % 8) return -4;
      ++restarts;
      b.pos = at;
      b.restart();
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
      eobrun = 0;
    }
    const long long my = mcu / mcus_x, mx = mcu % mcus_x;
    for (int c = 0; c < n_comps; ++c) {
      const int h = comp[4 * c], v = comp[4 * c + 1], bw = comp[4 * c + 2];
      const long long off = comp[4 * c + 3];
      const uint16_t* dc = luts + (2 * c) * 65536LL;
      const uint16_t* ac = luts + (2 * c + 1) * 65536LL;
      for (int by = 0; by < v; ++by) {
        for (int bx = 0; bx < h; ++bx) {
          int16_t* blk = out + (off + (my * v + by) * bw + mx * h + bx) * 64;
          if (ss == 0) {
            if (ah == 0) {  // DC first
              int s = symbol(b, dc);
              if (s < 0) return s;
              if (s) {
                int r = receive(b, s);
                if (r == INT32_MIN) return -3;
                pred[c] += r;
              }
              blk[0] = static_cast<int16_t>(pred[c] * p1);
            } else {  // DC refinement
              int bit = raw_bits(b, 1);
              if (bit < 0) return -3;
              if (bit) blk[0] = static_cast<int16_t>(blk[0] | p1);
            }
          } else if (ah == 0) {  // AC first
            if (eobrun) {
              --eobrun;
              continue;
            }
            for (int k = ss; k <= se; ++k) {
              int rs = symbol(b, ac);
              if (rs < 0) return rs;
              int r = rs >> 4, s = rs & 15;
              if (s) {
                k += r;
                int val = receive(b, s);
                if (val == INT32_MIN) return -3;
                blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(val) << al);
              } else if (r == 15) {
                k += 15;
              } else {
                eobrun = 1u << r;
                if (r) {
                  int extra = raw_bits(b, r);
                  if (extra < 0) return -3;
                  eobrun += extra;
                }
                --eobrun;
                break;
              }
            }
          } else {  // AC refinement
            int k = ss;
            if (eobrun == 0) {
              for (; k <= se; ++k) {
                int rs = symbol(b, ac);
                if (rs < 0) return rs;
                int r = rs >> 4, s = rs & 15;
                if (s) {
                  int bit = raw_bits(b, 1);
                  if (bit < 0) return -3;
                  s = bit ? p1 : m1;
                } else if (r != 15) {
                  eobrun = 1u << r;
                  if (r) {
                    int extra = raw_bits(b, r);
                    if (extra < 0) return -3;
                    eobrun += extra;
                  }
                  break;
                }
                do {
                  int16_t* coef = blk + kNatural[k];
                  if (*coef != 0) {
                    int bit = raw_bits(b, 1);
                    if (bit < 0) return -3;
                    if (bit && (*coef & p1) == 0)
                      *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
                  } else if (--r < 0) {
                    break;
                  }
                  ++k;
                } while (k <= se);
                if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
              }
            }
            if (eobrun > 0) {
              for (; k <= se; ++k) {
                int16_t* coef = blk + kNatural[k];
                if (*coef != 0) {
                  int bit = raw_bits(b, 1);
                  if (bit < 0) return -3;
                  if (bit && (*coef & p1) == 0)
                    *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
                }
              }
              --eobrun;
            }
          }
        }
      }
    }
  }
  long long at = 0;
  const int m = next_marker(data, b.pos, end, &at);
  if (m >= 0xD0 && m <= 0xD7) return -4;
  return 0;
}
