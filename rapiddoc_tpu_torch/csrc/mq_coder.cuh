// The MQ arithmetic decoder shared by the host decoders: T.88 Annex E
// (JBIG2, csrc/bilevel.cu) and T.800 Annex C (JPEG 2000 tier 1,
// csrc/jpx.cu) are the same coder. The software-conventions decoder
// (T.88 E.3.2) with its Qe table; a byte after the data reads as 0xFF,
// as OpenJPEG's artificial 0xFF 0xFF marker does. pdfio/jbig2.py's
// PyMQDecoder is its plain version.
#pragma once
#include <cstdint>

namespace mq {

struct QeEntry { uint16_t qe; uint8_t nmps, nlps, sw; };
static const QeEntry kQe[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

// Context byte layout: (state_index << 1) | mps.
struct MQ {
  const uint8_t* data;
  int64_t len, bp;
  uint32_t chigh, clow, a;
  int ct;

  void bytein() {
    if (bp < len && data[bp] == 0xFF) {
      if (bp + 1 >= len || data[bp + 1] > 0x8F) {
        clow += 0xFF00;
        ct = 8;
      } else {
        bp++;
        clow += static_cast<uint32_t>(data[bp]) << 9;
        ct = 7;
      }
    } else {
      bp++;
      clow += bp < len ? static_cast<uint32_t>(data[bp]) << 8 : 0xFF00;
      ct = 8;
    }
    if (clow > 0xFFFF) {
      chigh += clow >> 16;
      clow &= 0xFFFF;
    }
  }

  void init(const uint8_t* d, int64_t n) {
    data = d;
    len = n;
    bp = 0;
    chigh = n > 0 ? d[0] : 0xFF;
    clow = 0;
    bytein();
    chigh = ((chigh << 7) & 0xFFFF) | ((clow >> 9) & 0x7F);
    clow = (clow << 7) & 0xFFFF;
    ct -= 7;
    a = 0x8000;
  }

  int decode(uint8_t* cx) {
    int icx = *cx >> 1;
    int mps = *cx & 1;
    const QeEntry& q = kQe[icx];
    const uint32_t qe = q.qe;
    int d;
    a -= qe;
    if (chigh < qe) {
      if (a < qe) {
        a = qe;
        d = mps;
        icx = q.nmps;
      } else {
        a = qe;
        d = 1 ^ mps;
        if (q.sw) mps = d;
        icx = q.nlps;
      }
    } else {
      chigh -= qe;
      if (a & 0x8000) return mps;
      if (a < qe) {
        d = 1 ^ mps;
        if (q.sw) mps = d;
        icx = q.nlps;
      } else {
        d = mps;
        icx = q.nmps;
      }
    }
    do {
      if (ct == 0) bytein();
      a <<= 1;
      chigh = ((chigh << 1) & 0xFFFF) | ((clow >> 15) & 1);
      clow = (clow << 1) & 0xFFFF;
      ct--;
    } while (!(a & 0x8000));
    *cx = static_cast<uint8_t>((icx << 1) | mps);
    return d;
  }
};

}  // namespace mq
