// Bilevel decoders of PDF images: host code, no device kernel.
//
// The JAX package decodes /JBIG2Decode streams with its own Python
// module whose per-pixel loops run natively (rapiddoc_tpu/pdfio/jbig2.py
// over native/hostops.cpp), and /CCITTFaxDecode streams (and JBIG2's MMR
// regions) through PIL's libtiff. The port (pdfio/jbig2.py,
// pdfio/ccitt.py) replays both in Python; those loops run at about a
// microsecond a pixel or a code there, and a 300 dpi Letter page holds
// 8.4 M pixels. This file is the same loops compiled. It is built by
// nvcc like the kernels (ops/build.py, plain C entry points, no PyTorch
// header) and loaded with ctypes; the Python versions are its plain
// versions, bit for bit.
//
// - JBIG2 (T.88): the MQ arithmetic decoder (Annex E), integer (A.2)
//   and symbol-ID (A.3) decoding, generic regions (6.2, templates 0-3,
//   AT pixels, TPGDON) and generic refinement (6.3, TPGRON): the JAX
//   package's native/hostops.cpp loops, unchanged.
// - ccitt_decode: libtiff 4.7's G3/G4 strip decoder as pdfio/ccitt.py
//   replays it (lookahead tables, bit accumulator, run bookkeeping,
//   EOL handling found by experiment), one strip into one byte a pixel.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include "mq_coder.cuh"

namespace jbig2 {

using mq::MQ;
using mq::QeEntry;
using mq::kQe;

struct Pt { int x, y; };

// Coding templates (T.88 6.2.5.3 figures, nominal layouts sans AT).
static const Pt kT0[] = {{-1, -2}, {0, -2}, {1, -2}, {-2, -1}, {-1, -1},
                         {0, -1},  {1, -1}, {2, -1}, {-4, 0},  {-3, 0},
                         {-2, 0},  {-1, 0}};
static const Pt kT1[] = {{-1, -2}, {0, -2}, {1, -2}, {2, -2}, {-2, -1},
                         {-1, -1}, {0, -1}, {1, -1}, {2, -1}, {-3, 0},
                         {-2, 0},  {-1, 0}};
static const Pt kT2[] = {{-1, -2}, {0, -2}, {1, -2}, {-2, -1}, {-1, -1},
                         {0, -1},  {1, -1}, {-2, 0}, {-1, 0}};
static const Pt kT3[] = {{-3, -1}, {-2, -1}, {-1, -1}, {0, -1}, {1, -1},
                         {-4, 0},  {-3, 0},  {-2, 0},  {-1, 0}};

static const uint32_t kReusedCtx[4] = {0x9B25, 0x0795, 0x00E5, 0x0195};

static inline int px(const uint8_t* bmp, int w, int h, int x, int y) {
  if (x < 0 || x >= w || y < 0 || y >= h) return 0;
  return bmp[static_cast<int64_t>(y) * w + x];
}

}  // namespace jbig2

extern "C" {

void* jbig2_mq_new(const uint8_t* data, int64_t len) {
  auto* m = new jbig2::MQ();
  m->init(data, len);
  return m;
}

void jbig2_mq_free(void* mq) { delete static_cast<jbig2::MQ*>(mq); }

int jbig2_mq_decode_bit(void* mq, uint8_t* cx, int64_t idx) {
  return static_cast<jbig2::MQ*>(mq)->decode(cx + idx);
}

// Integer arithmetic decoding (T.88 Annex A.2). cx: 512 bytes.
// Returns 1 on value (stored in *out), 0 on OOB.
int jbig2_decode_int(void* mq_, uint8_t* cx, int32_t* out) {
  auto* mq = static_cast<jbig2::MQ*>(mq_);
  uint32_t prev = 1;
  auto bit = [&]() {
    int b = mq->decode(cx + prev);
    prev = prev < 256 ? (prev << 1) | b : ((((prev << 1) | b) & 511) | 256);
    return b;
  };
  auto bits = [&](int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | bit();
    return v;
  };
  const int s = bit();
  int64_t v;
  if (!bit()) v = bits(2);
  else if (!bit()) v = bits(4) + 4;
  else if (!bit()) v = bits(6) + 20;
  else if (!bit()) v = bits(8) + 84;
  else if (!bit()) v = bits(12) + 340;
  else v = static_cast<int64_t>(bits(32)) + 4436;
  if (s && v == 0) return 0;  // OOB
  *out = static_cast<int32_t>(s ? -v : v);
  return 1;
}

// Symbol ID decoding (T.88 A.3). cx: 1 << (code_len + 1) bytes.
int jbig2_decode_iaid(void* mq_, uint8_t* cx, int code_len) {
  auto* mq = static_cast<jbig2::MQ*>(mq_);
  uint32_t prev = 1;
  for (int i = 0; i < code_len; ++i) {
    int b = mq->decode(cx + prev);
    prev = (prev << 1) | b;
  }
  return static_cast<int>(prev - (1u << code_len));
}

// Generic region decoding (T.88 6.2). out: w*h bytes (0/1).
// at: 8 ints (4 x,y pairs; templates 1-3 use only the first pair).
// cx: 1 << 16 bytes, shared across calls for one segment.
void jbig2_generic_decode(void* mq_, uint8_t* cx, int tmpl, int tpgdon,
                          const int32_t* at, uint8_t* out, int w, int h) {
  auto* mq = static_cast<jbig2::MQ*>(mq_);
  jbig2::Pt tpl[16];
  int n = 0;
  const jbig2::Pt* base;
  int nbase, nat;
  switch (tmpl) {
    case 0: base = jbig2::kT0; nbase = 12; nat = 4; break;
    case 1: base = jbig2::kT1; nbase = 12; nat = 1; break;
    case 2: base = jbig2::kT2; nbase = 9; nat = 1; break;
    default: base = jbig2::kT3; nbase = 9; nat = 1; break;
  }
  for (int i = 0; i < nbase; ++i) tpl[n++] = base[i];
  for (int i = 0; i < nat; ++i)
    tpl[n++] = {static_cast<int>(at[2 * i]), static_cast<int>(at[2 * i + 1])};
  // context bit order: (y, x)-sorted — with nominal AT this equals the
  // spec layout, which the kReusedCtx TPGDON constants assume; any
  // consistent order mirrors the encoder's adaptive stats either way
  std::sort(tpl, tpl + n, [](const jbig2::Pt& a, const jbig2::Pt& b) {
    return a.y != b.y ? a.y < b.y : a.x < b.x;
  });
  int ltp = 0;
  for (int y = 0; y < h; ++y) {
    if (tpgdon) {
      ltp ^= mq->decode(cx + jbig2::kReusedCtx[tmpl]);
      if (ltp) {  // typical row: copy the row above
        uint8_t* row = out + static_cast<int64_t>(y) * w;
        if (y > 0) std::memcpy(row, row - w, w);
        else std::memset(row, 0, w);
        continue;
      }
    }
    for (int x = 0; x < w; ++x) {
      uint32_t ctx = 0;
      for (int i = 0; i < n; ++i)
        ctx = (ctx << 1) | jbig2::px(out, w, h, x + tpl[i].x, y + tpl[i].y);
      out[static_cast<int64_t>(y) * w + x] =
          static_cast<uint8_t>(mq->decode(cx + ctx));
    }
  }
}

// Generic refinement decoding (T.88 6.3). ref: rw*rh reference bitmap;
// (dx, dy) = GRREFERENCEDX/DY. cx: 1 << 13 bytes. at: 4 ints
// (2 pairs, template 0 only). Returns 0 on success.
int jbig2_refine_decode(void* mq_, uint8_t* cx, int tmpl, int tpgron,
                        const int32_t* at, const uint8_t* ref, int rw,
                        int rh, int dx, int dy, uint8_t* out, int w, int h) {
  auto* mq = static_cast<jbig2::MQ*>(mq_);
  using jbig2::Pt;
  // coding = this bitmap; reference = ref bitmap at (x-dx, y-dy) offsets
  Pt cod[8], rf[16];
  int nc = 0, nr = 0;
  if (tmpl == 0) {
    const Pt c[] = {{0, -1}, {1, -1}, {-1, 0}};
    const Pt r[] = {{0, -1}, {1, -1}, {-1, 0}, {0, 0},
                    {1, 0},  {-1, 1}, {0, 1},  {1, 1}};
    for (auto& p : c) cod[nc++] = p;
    cod[nc++] = {static_cast<int>(at[0]), static_cast<int>(at[1])};
    for (auto& p : r) rf[nr++] = p;
    rf[nr++] = {static_cast<int>(at[2]), static_cast<int>(at[3])};
  } else {
    const Pt c[] = {{-1, -1}, {0, -1}, {1, -1}, {-1, 0}};
    const Pt r[] = {{0, -1}, {-1, 0}, {0, 0}, {1, 0}, {0, 1}, {1, 1}};
    for (auto& p : c) cod[nc++] = p;
    for (auto& p : r) rf[nr++] = p;
  }
  const uint32_t pseudo = tmpl == 0 ? 0x0020 : 0x0008;
  int ltp = 0;
  for (int y = 0; y < h; ++y) {
    if (tpgron) ltp ^= mq->decode(cx + pseudo);
    for (int x = 0; x < w; ++x) {
      const int rx = x - dx, ry = y - dy;
      if (ltp) {  // typical prediction: uniform 3x3 ref neighborhood
        int sum = 0;
        for (int yy = -1; yy <= 1; ++yy)
          for (int xx = -1; xx <= 1; ++xx)
            sum += jbig2::px(ref, rw, rh, rx + xx, ry + yy);
        if (sum == 0 || sum == 9) {
          out[static_cast<int64_t>(y) * w + x] = sum ? 1 : 0;
          continue;
        }
      }
      uint32_t ctx = 0;
      for (int i = 0; i < nc; ++i)
        ctx = (ctx << 1) | jbig2::px(out, w, h, x + cod[i].x, y + cod[i].y);
      for (int i = 0; i < nr; ++i)
        ctx = (ctx << 1) |
              jbig2::px(ref, rw, rh, rx + rf[i].x, ry + rf[i].y);
      out[static_cast<int64_t>(y) * w + x] =
          static_cast<uint8_t>(mq->decode(cx + ctx));
    }
  }
  return 0;
}

}  // extern "C"

namespace ccitt {

enum State { S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB,
             S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL };

struct Ent { uint8_t state, width; uint16_t param; };

// libtiff's lookahead tables, filled from the code lists of pdfio/ccitt.py
// by ccitt_set_tables before the first decode.
Ent g_main[1 << 7], g_white[1 << 12], g_black[1 << 13];
bool g_ready = false;

struct Eof {};
struct Fail { int code; };

struct Decoder {
  const uint8_t* data;
  int64_t len, cp = 0;
  uint64_t acc = 0;
  int avail = 0;
  int lastx;
  int64_t nruns;
  std::vector<uint32_t> runs;
  int64_t cur = 0, ref = -1;
  int eol = 0;
  bool first = true, noeol = false;

  static uint8_t rev(uint8_t b) {
    b = static_cast<uint8_t>((b & 0xF0) >> 4 | (b & 0x0F) << 4);
    b = static_cast<uint8_t>((b & 0xCC) >> 2 | (b & 0x33) << 2);
    return static_cast<uint8_t>((b & 0xAA) >> 1 | (b & 0x55) << 1);
  }
  void need8(int n) {
    if (avail < n) {
      if (cp >= len) {
        if (avail == 0) throw Eof();
        avail = n;
      } else {
        acc |= static_cast<uint64_t>(rev(data[cp++])) << avail;
        avail += 8;
      }
    }
  }
  void need16(int n) {
    if (avail < n) {
      if (cp >= len) {
        if (avail == 0) throw Eof();
        avail = n;
      } else {
        acc |= static_cast<uint64_t>(rev(data[cp++])) << avail;
        avail += 8;
        if (avail < n) {
          if (cp >= len) {
            avail = n;
          } else {
            acc |= static_cast<uint64_t>(rev(data[cp++])) << avail;
            avail += 8;
          }
        }
      }
    }
  }
  // ClrBits: a negative count of bits left is kept, as libtiff keeps it
  void clr(int n) {
    avail -= n;
    acc = n >= 64 ? 0 : acc >> n;
  }
  const Ent& lookup(const Ent* table, int width, bool wide) {
    if (wide) need16(width); else need8(width);
    const Ent& e = table[acc & ((1u << width) - 1)];
    clr(e.width);
    return e;
  }
};

inline int32_t s32(int64_t v) { return static_cast<int32_t>(static_cast<uint32_t>(v)); }

// one row into d.runs[d.cur..]: returns the end index; *eof set when the
// data ended inside the row (after CLEANUP_RUNS)
int64_t row_runs(Decoder& d, bool two_d_row, bool* eof) {
  std::vector<uint32_t>& runs = d.runs;
  const int64_t thisrun = d.cur, nruns = d.nruns;
  const int lastx = d.lastx;
  int64_t a0 = 0, rl = 0, pa = thisrun;
  auto setvalue = [&](int64_t x) {
    if (pa >= thisrun + nruns) throw Fail{-1};
    runs[pa++] = static_cast<uint32_t>(rl + x);
    a0 += x;
    rl = 0;
  };
  auto cleanup = [&]() {
    if (rl) setvalue(0);
    if (a0 != lastx) {
      while (a0 > lastx && pa > thisrun) a0 -= s32(runs[--pa]);
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if ((pa - thisrun) & 1) setvalue(0);
        setvalue(lastx - a0);
      } else if (a0 > lastx) {
        setvalue(lastx);
        setvalue(0);
      }
    }
  };
  *eof = false;
  if (!two_d_row) {
    try {
      for (;;) {
        bool done = false;
        for (;;) {
          const Ent& e = d.lookup(g_white, 12, true);
          if (e.state == S_EOL) { d.eol = 1; done = true; break; }
          if (e.state == S_TermW) { setvalue(e.param); break; }
          if (e.state == S_MakeUpW || e.state == S_MakeUp) { a0 += e.param; rl += e.param; continue; }
          done = true;
          break;
        }
        if (done || a0 >= lastx) break;
        for (;;) {
          const Ent& e = d.lookup(g_black, 13, true);
          if (e.state == S_EOL) { d.eol = 1; done = true; break; }
          if (e.state == S_TermB) { setvalue(e.param); break; }
          if (e.state == S_MakeUpB || e.state == S_MakeUp) { a0 += e.param; rl += e.param; continue; }
          done = true;
          break;
        }
        if (done || a0 >= lastx) break;
        if (runs[pa - 1] == 0 && runs[pa - 2] == 0) pa -= 2;
      }
    } catch (const Eof&) {
      cleanup();
      *eof = true;
      return pa;
    }
    cleanup();
    return pa;
  }
  const int64_t ref = d.ref;
  int64_t pb = ref;
  int64_t b1 = s32(runs[pb++]);
  auto check_b1 = [&]() {
    if (pa != thisrun) {
      while (b1 <= a0 && b1 < lastx) {
        if (pb + 1 >= ref + nruns) throw Fail{-1};
        b1 = s32(b1 + runs[pb] + runs[pb + 1]);
        pb += 2;
      }
    }
  };
  auto horiz_run = [&](const Ent* table, int width, int s_term, int s_makeup) {
    for (;;) {
      const Ent& e = d.lookup(table, width, true);
      if (e.state == s_term) { setvalue(e.param); return true; }
      if (e.state == s_makeup || e.state == S_MakeUp) { a0 += e.param; rl += e.param; continue; }
      return false;
    }
  };
  try {
    bool bad = false;
    while (a0 < lastx) {
      if (pa >= thisrun + nruns) throw Fail{-1};
      const Ent& e = d.lookup(g_main, 7, false);
      const int s = e.state;
      if (s == S_Pass) {
        check_b1();
        if (pb + 1 >= ref + nruns) throw Fail{-1};
        b1 = s32(b1 + runs[pb++]);
        rl += b1 - a0;
        a0 = b1;
        b1 = s32(b1 + runs[pb++]);
      } else if (s == S_Horiz) {
        bool ok;
        if ((pa - thisrun) & 1)
          ok = horiz_run(g_black, 13, S_TermB, S_MakeUpB) && horiz_run(g_white, 12, S_TermW, S_MakeUpW);
        else
          ok = horiz_run(g_white, 12, S_TermW, S_MakeUpW) && horiz_run(g_black, 13, S_TermB, S_MakeUpB);
        if (!ok) { bad = true; break; }
        check_b1();
      } else if (s == S_V0 || s == S_VR) {
        check_b1();
        setvalue(b1 - a0 + (s == S_VR ? e.param : 0));
        if (pb >= ref + nruns) throw Fail{-1};
        b1 = s32(b1 + runs[pb++]);
      } else if (s == S_VL) {
        check_b1();
        if (b1 < a0 + e.param) { bad = true; break; }
        setvalue(b1 - a0 - e.param);
        b1 = s32(b1 - runs[--pb]);
      } else if (s == S_Ext) {
        runs[pa++] = static_cast<uint32_t>(lastx - a0);
        bad = true;
        break;
      } else if (s == S_EOL) {
        runs[pa++] = static_cast<uint32_t>(lastx - a0);
        d.need8(4);
        d.clr(4);
        d.eol = 1;
        bad = true;
        break;
      } else {
        bad = true;
        break;
      }
    }
    if (!bad && rl) {
      if (rl + a0 < lastx) {
        d.need8(1);
        if (!(d.acc & 1)) bad = true;
        else d.clr(1);
      }
      if (!bad) setvalue(0);
    }
  } catch (const Eof&) {
    cleanup();
    *eof = true;
    return pa;
  }
  cleanup();
  return pa;
}

void fill_row(uint8_t* bits, std::vector<uint32_t>& runs, int64_t start, int64_t end, int lastx) {
  if ((end - start) & 1) runs[end++] = 0;
  uint32_t x = 0;
  for (int64_t i = start; i < end; i += 2) {
    uint32_t run = runs[i];
    if (x + run > static_cast<uint32_t>(lastx) || run > static_cast<uint32_t>(lastx))
      run = runs[i] = lastx - x;
    x += run;
    run = runs[i + 1];
    if (x + run > static_cast<uint32_t>(lastx) || run > static_cast<uint32_t>(lastx))
      run = runs[i + 1] = lastx - x;
    if (run) std::memset(bits + x, 1, run);
    x += run;
  }
}

void sync_eol(Decoder& d) {
  if (d.noeol) return;
  if (d.eol == 0) {
    if (d.first) {
      d.need16(11);
      if (d.acc & 0x7FF) {
        d.noeol = true;
        return;
      }
    }
    for (;;) {
      d.need16(11);
      if ((d.acc & 0x7FF) == 0) break;
      d.clr(1);
    }
  }
  const uint64_t acc = d.acc;
  const int avail = d.avail;
  const int64_t cp = d.cp;
  try {
    for (;;) {
      d.need8(8);
      if (d.acc & 0xFF) break;
      d.clr(8);
    }
  } catch (const Eof&) {
    if (d.ref < 0) throw;
    d.acc = acc;
    d.avail = avail;
    d.cp = cp;
    return;
  }
  while ((d.acc & 1) == 0) d.clr(1);
  d.clr(1);
  d.eol = 0;
}

}  // namespace ccitt

extern "C" {

// The lookahead tables: 3 ints (state, width, param) per entry, 128 main,
// 4096 white and 8192 black entries, in that order.
void ccitt_set_tables(const int32_t* t) {
  ccitt::Ent* dst[3] = {ccitt::g_main, ccitt::g_white, ccitt::g_black};
  const int n[3] = {1 << 7, 1 << 12, 1 << 13};
  for (int k = 0; k < 3; ++k) {
    for (int i = 0; i < n[k]; ++i, t += 3)
      dst[k][i] = {static_cast<uint8_t>(t[0]), static_cast<uint8_t>(t[1]),
                   static_cast<uint16_t>(t[2])};
  }
  ccitt::g_ready = true;
}

// One strip of `height` rows of `width` pixels; k < 0 is T.6, 0 T.4 1-D,
// > 0 T.4 2-D. bits: height * width bytes, zeroed by the caller; 1 where
// libtiff sets a bit. Returns the rows written, or -1 (run buffer
// overflow), -2 (a T.6 strip with no row), -3 (a 2-D T.4 strip that ends
// inside a row), -4 (tables not set).
int ccitt_decode(const uint8_t* data, long long len, int width, int height, int k,
                 uint8_t* bits) {
  using namespace ccitt;
  if (!g_ready) return -4;
  const bool g4 = k < 0, two_d = g4 || k > 0;
  Decoder d;
  d.data = data;
  d.len = len;
  d.lastx = width;
  d.nruns = ((static_cast<int64_t>(width) + 1 + 31) / 32) * 32 * (two_d ? 2 : 1);
  d.runs.assign(2 * d.nruns, 0);
  if (two_d) {
    d.ref = d.nruns;
    d.runs[d.ref] = width;
    d.runs[d.ref + 1] = 0;
  }
  try {
    for (int y = 0; y < height; ++y) {
      uint8_t* row = bits + static_cast<int64_t>(y) * width;
      bool eof = false;
      if (g4) {
        const int64_t pa = row_runs(d, true, &eof);
        if (!eof && !d.eol) {
          fill_row(row, d.runs, d.cur, pa, width);
          if (pa >= d.cur + d.nruns) return -1;
          d.runs[pa] = 0;
          std::swap(d.cur, d.ref);
          continue;
        }
        try {
          d.need16(13);
        } catch (const Eof&) {
        }
        d.clr(13);
        fill_row(row, d.runs, d.cur, pa, width);
        return y == 0 ? -2 : y + 1;
      }
      bool row_1d = true;
      try {
        sync_eol(d);
        d.first = false;
        if (two_d) {
          d.need8(1);
          row_1d = d.acc & 1;
          d.clr(1);
        }
      } catch (const Eof&) {
        fill_row(row, d.runs, d.cur, d.cur, width);
        return two_d ? -3 : y + 1;
      }
      const int64_t pa = row_runs(d, !row_1d, &eof);
      fill_row(row, d.runs, d.cur, pa, width);
      if (eof) return two_d ? -3 : y + 1;
      if (two_d) {
        if (pa < d.cur + d.nruns) d.runs[pa] = 0;
        std::swap(d.cur, d.ref);
      }
    }
  } catch (const Fail& f) {
    return f.code;
  }
  return height;
}

}  // extern "C"
