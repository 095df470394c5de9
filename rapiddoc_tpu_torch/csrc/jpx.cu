// JPEG 2000 tier 1 (EBCOT, T.800 Annex D) of one code-block: host code,
// no device kernel.
//
// The JAX package opens JPXDecode streams through PIL's OpenJPEG. The
// port (pdfio/jpx.py, pdfio/jpx_t1.py) replays OpenJPEG 2.5 in Python;
// its tier-1 loops run at microseconds a coefficient and a bit-plane
// there, and a 300 dpi page holds millions of coefficients. This file is
// the same loop compiled, built by nvcc like the kernels (ops/build.py,
// a plain C entry point, no PyTorch header) and loaded with ctypes;
// pdfio/jpx_t1.py is its plain version, bit for bit.
//
// jpx_t1_decode: the MQ decoder (mq_coder.cuh, shared with bilevel.cu)
// restarted on each segment, 19 contexts, cleanup / significance / refinement passes in stripes of
// four rows with run-length coding, zero-coding contexts by band
// orientation (0 LL, 1 HL, 2 LH, 3 HH), sign contexts; values keep one
// extra fractional bit (twice the coefficient, midpoint reconstruction).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include "mq_coder.cuh"

namespace {

constexpr int kCtxRl = 17, kCtxUni = 18;

// Zero-coding context by orientation and (h * 3 + v) * 5 + d.
struct ZcLut {
  int t[4][45];
  ZcLut() {
  for (int orient = 0; orient < 4; ++orient) {
    for (int h0 = 0; h0 < 3; ++h0) {
      for (int v0 = 0; v0 < 3; ++v0) {
        for (int d = 0; d < 5; ++d) {
          int h = orient == 1 ? v0 : h0, v = orient == 1 ? h0 : v0, n;
          if (orient == 3) {
            const int hv = h + v;
            if (d == 0) n = hv == 0 ? 0 : hv == 1 ? 1 : 2;
            else if (d == 1) n = hv == 0 ? 3 : hv == 1 ? 4 : 5;
            else if (d == 2) n = hv == 0 ? 6 : 7;
            else n = 8;
          } else if (h == 0) {
            n = v == 0 ? (d == 0 ? 0 : d == 1 ? 1 : 2) : v == 1 ? 3 : 4;
          } else if (h == 1) {
            n = v == 0 ? (d == 0 ? 5 : 6) : 7;
          } else {
            n = 8;
          }
          t[orient][(h0 * 3 + v0) * 5 + d] = n;
        }
      }
    }
  }
  }
};

const ZcLut& zc_luts() {
  static const ZcLut lut;  // initialised once, thread-safe
  return lut;
}

const int kScCtx[9] = {13, 12, 11, 10, 9, 10, 11, 12, 13};
const int kScXor[9] = {1, 1, 1, 1, 0, 0, 0, 0, 0};

struct Block {
  int w, h, W;
  const int* zc;
  std::vector<uint8_t> sig, neg, visited, refined;
  std::vector<int32_t> val;
  mq::MQ mq;
  uint8_t cx[19];

  int zc_ctx(int i) const {
    const int hh = sig[i - 1] + sig[i + 1];
    const int vv = sig[i - W] + sig[i + W];
    const int dd = sig[i - W - 1] + sig[i - W + 1] + sig[i + W - 1] + sig[i + W + 1];
    return zc[(hh * 3 + vv) * 5 + dd];
  }
  static int contrib(uint8_t s, uint8_t n) { return s ? (n ? -1 : 1) : 0; }
  void set_sig(int i, int p) {
    int hc = contrib(sig[i - 1], neg[i - 1]) + contrib(sig[i + 1], neg[i + 1]);
    int vc = contrib(sig[i - W], neg[i - W]) + contrib(sig[i + W], neg[i + W]);
    hc = hc < -1 ? -1 : hc > 1 ? 1 : hc;
    vc = vc < -1 ? -1 : vc > 1 ? 1 : vc;
    const int k = (hc + 1) * 3 + vc + 1;
    const int s = mq.decode(&cx[kScCtx[k]]) ^ kScXor[k];
    sig[i] = 1;
    neg[i] = static_cast<uint8_t>(s);
    const int32_t v = 3 << p;
    val[i] = s ? -v : v;
  }
  void sig_pass(int p) {
    for (int y0 = 0; y0 < h; y0 += 4) {
      for (int x = 0; x < w; ++x) {
        for (int y = y0; y < y0 + 4 && y < h; ++y) {
          const int i = (y + 1) * W + x + 1;
          if (sig[i]) continue;
          const int ctx = zc_ctx(i);
          if (ctx == 0) continue;
          visited[i] = 1;
          if (mq.decode(&cx[ctx])) set_sig(i, p);
        }
      }
    }
  }
  void ref_pass(int p) {
    const int32_t half = 1 << p;
    for (int y0 = 0; y0 < h; y0 += 4) {
      for (int x = 0; x < w; ++x) {
        for (int y = y0; y < y0 + 4 && y < h; ++y) {
          const int i = (y + 1) * W + x + 1;
          if (!sig[i] || visited[i]) continue;
          int ctx;
          if (refined[i]) {
            ctx = 16;
          } else {
            const int nb = sig[i - 1] + sig[i + 1] + sig[i - W] + sig[i + W] + sig[i - W - 1] +
                           sig[i - W + 1] + sig[i + W - 1] + sig[i + W + 1];
            ctx = nb ? 15 : 14;
            refined[i] = 1;
          }
          const int bit = mq.decode(&cx[ctx]);
          if (val[i] < 0) val[i] += bit ? -half : half;
          else val[i] += bit ? half : -half;
        }
      }
    }
  }
  void cln_pass(int p) {
    for (int y0 = 0; y0 < h; y0 += 4) {
      const bool full = y0 + 4 <= h;
      for (int x = 0; x < w; ++x) {
        int start = y0;
        if (full) {
          bool run = true;
          for (int y = y0; y < y0 + 4; ++y) {
            const int i = (y + 1) * W + x + 1;
            if (sig[i] || visited[i] || zc_ctx(i)) {
              run = false;
              break;
            }
          }
          if (run) {
            if (!mq.decode(&cx[kCtxRl])) continue;
            int r = mq.decode(&cx[kCtxUni]) << 1;
            r |= mq.decode(&cx[kCtxUni]);
            set_sig((y0 + r + 1) * W + x + 1, p);
            start = y0 + r + 1;
          }
        }
        for (int y = start; y < y0 + 4 && y < h; ++y) {
          const int i = (y + 1) * W + x + 1;
          if (sig[i] || visited[i]) continue;
          if (mq.decode(&cx[zc_ctx(i)])) set_sig(i, p);
        }
      }
    }
    std::fill(visited.begin(), visited.end(), 0);
  }
};

}  // namespace

extern "C" {

// Decodes one code-block (w x h, band orientation `orient`, first cleanup
// at bit-plane `first_plane`) from `data`, cut into `nsegs` segments of
// passes[i] passes and lengths[i] bytes, each read by an MQ decoder of its
// own over the same contexts, into `out` (h x w int32, twice the
// coefficients).
void jpx_t1_decode(const uint8_t* data, int w, int h, int orient, int first_plane, int nsegs,
                   const int32_t* passes, const int64_t* lengths, int32_t* out) {
  std::memset(out, 0, sizeof(int32_t) * static_cast<size_t>(w) * h);
  if (nsegs <= 0 || first_plane < 0 || w <= 0 || h <= 0) return;
  Block b;
  b.w = w;
  b.h = h;
  b.W = w + 2;
  b.zc = zc_luts().t[orient];
  const size_t n = static_cast<size_t>(b.W) * (h + 2);
  b.sig.assign(n, 0);
  b.neg.assign(n, 0);
  b.visited.assign(n, 0);
  b.refined.assign(n, 0);
  b.val.assign(n, 0);
  std::memset(b.cx, 0, sizeof(b.cx));
  b.cx[0] = 4 << 1;
  b.cx[kCtxRl] = 3 << 1;
  b.cx[kCtxUni] = 46 << 1;
  int p = first_plane, kind = 2;
  int64_t start = 0;
  for (int seg = 0; seg < nsegs; ++seg) {
    b.mq.init(data + start, lengths[seg]);
    start += lengths[seg];
    for (int k = 0; k < passes[seg] && p >= 0; ++k) {
      if (kind == 0) b.sig_pass(p);
      else if (kind == 1) b.ref_pass(p);
      else b.cln_pass(p);
      if (++kind == 3) {
        kind = 0;
        --p;
      }
    }
  }
  for (int y = 0; y < h; ++y) {
    std::memcpy(out + static_cast<size_t>(y) * w, b.val.data() + (y + 1) * b.W + 1, sizeof(int32_t) * w);
  }
}

}  // extern "C"
