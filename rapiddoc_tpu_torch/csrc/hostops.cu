// The JAX package's compiled host loops: host code, no device kernel.
//
// The JAX package runs these loops from its own C++ library through
// ctypes (its utils/native.py); this file is the port's copy of those
// five functions, built by nvcc like the kernels (ops/build.py, plain C
// entry points, no PyTorch header) and loaded by utils/native.py. The
// Python and numpy loops they replace are their plain versions
// (pdfio/filters.py png_defilter_plain and tiff_defilter_plain,
// utils/boxes.py iou_matrix_plain and nms, utils/teds.py
// levenshtein), equal result for result. The wrappers refuse a row
// length, pixel width or box count above INT_MAX before calling; these
// loops also return at once on a row length or width below their least.
//
// - png_defilter: the PNG predictors of a Flate stream (PDF 1.7
//   7.4.4.4): rows of one filter byte and row_len bytes in, rows of
//   row_len bytes out. An unknown filter byte leaves its row as it is;
//   a trailing partial row is dropped.
// - tiff_defilter: TIFF predictor 2 on 8-bit components, in place.
// - iou_matrix: pairwise IoU of xyxy boxes, 0 where the union is not
//   positive.
// - nms: greedy NMS in descending score order, ties in index order (a
//   stable sort: the JAX package's std::sort leaves ties unspecified).
// - levenshtein_u32: edit distance over UTF-32 code units.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Returns the number of rows written.
int64_t png_defilter(const uint8_t* data, int64_t data_len, int row_len, int bpp,
                     uint8_t* out) {
  if (row_len < 0 || bpp < 1 || data_len < 0) return 0;
  const int64_t stride = static_cast<int64_t>(row_len) + 1;
  const int64_t nrows = data_len / stride;
  if (nrows == 0) return 0;
  std::vector<uint8_t> prev(row_len, 0);
  for (int64_t r = 0; r < nrows; ++r) {
    const uint8_t* src = data + r * stride;
    const uint8_t ftype = src[0];
    uint8_t* row = out + r * row_len;
    std::memcpy(row, src + 1, row_len);
    switch (ftype) {
      case 1:  // Sub
        for (int i = bpp; i < row_len; ++i) row[i] += row[i - bpp];
        break;
      case 2:  // Up
        for (int i = 0; i < row_len; ++i) row[i] += prev[i];
        break;
      case 3:  // Average
        for (int i = 0; i < row_len; ++i) {
          const int left = i >= bpp ? row[i - bpp] : 0;
          row[i] += static_cast<uint8_t>((left + prev[i]) >> 1);
        }
        break;
      case 4:  // Paeth
        for (int i = 0; i < row_len; ++i) {
          const int a = i >= bpp ? row[i - bpp] : 0;
          const int b = prev[i];
          const int c = i >= bpp ? prev[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          row[i] += static_cast<uint8_t>(pred);
        }
        break;
      default:  // None, or a filter byte PNG does not define
        break;
    }
    std::memcpy(prev.data(), row, row_len);
  }
  return nrows;
}

void tiff_defilter(uint8_t* data, int64_t data_len, int row_len, int bpp) {
  if (row_len < 1 || bpp < 1) return;
  for (int64_t r = 0; r + row_len <= data_len; r += row_len) {
    uint8_t* row = data + r;
    for (int i = bpp; i < row_len; ++i) row[i] += row[i - bpp];
  }
}

// a (n x 4), b (m x 4) -> out (n x m)
void iou_matrix(const double* a, int n, const double* b, int m, double* out) {
  for (int64_t i = 0; i < n; ++i) {
    const double ax0 = a[i * 4], ay0 = a[i * 4 + 1];
    const double ax1 = a[i * 4 + 2], ay1 = a[i * 4 + 3];
    const double area_a = std::max(0.0, ax1 - ax0) * std::max(0.0, ay1 - ay0);
    for (int64_t j = 0; j < m; ++j) {
      const double bx0 = b[j * 4], by0 = b[j * 4 + 1];
      const double bx1 = b[j * 4 + 2], by1 = b[j * 4 + 3];
      const double ix = std::min(ax1, bx1) - std::max(ax0, bx0);
      const double iy = std::min(ay1, by1) - std::max(ay0, by0);
      const double inter = std::max(0.0, ix) * std::max(0.0, iy);
      const double area_b = std::max(0.0, bx1 - bx0) * std::max(0.0, by1 - by0);
      const double uni = area_a + area_b - inter;
      out[i * m + j] = uni > 0 ? inter / uni : 0.0;
    }
  }
}

// boxes (n x 4), scores (n); keep: n ints (caller's). Returns the count
// kept.
int nms(const double* boxes, const double* scores, int n, double iou_threshold,
        int* keep) {
  std::vector<int> order(n);
  for (int i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](int x, int y) { return scores[x] > scores[y]; });
  std::vector<char> suppressed(n, 0);
  int kept = 0;
  for (int oi = 0; oi < n; ++oi) {
    const int64_t i = order[oi];
    if (suppressed[i]) continue;
    keep[kept++] = static_cast<int>(i);
    const double ax0 = boxes[i * 4], ay0 = boxes[i * 4 + 1];
    const double ax1 = boxes[i * 4 + 2], ay1 = boxes[i * 4 + 3];
    const double area_a = std::max(0.0, ax1 - ax0) * std::max(0.0, ay1 - ay0);
    for (int oj = oi + 1; oj < n; ++oj) {
      const int64_t j = order[oj];
      if (suppressed[j]) continue;
      const double bx0 = boxes[j * 4], by0 = boxes[j * 4 + 1];
      const double bx1 = boxes[j * 4 + 2], by1 = boxes[j * 4 + 3];
      const double ix = std::min(ax1, bx1) - std::max(ax0, bx0);
      const double iy = std::min(ay1, by1) - std::max(ay0, by0);
      const double inter = std::max(0.0, ix) * std::max(0.0, iy);
      const double area_b = std::max(0.0, bx1 - bx0) * std::max(0.0, by1 - by0);
      const double uni = area_a + area_b - inter;
      if (uni > 0 && inter / uni > iou_threshold) suppressed[j] = 1;
    }
  }
  return kept;
}

int64_t levenshtein_u32(const uint32_t* a, int64_t na, const uint32_t* b, int64_t nb) {
  if (na == 0) return nb;
  if (nb == 0) return na;
  std::vector<int64_t> prev(nb + 1), cur(nb + 1);
  for (int64_t j = 0; j <= nb; ++j) prev[j] = j;
  for (int64_t i = 1; i <= na; ++i) {
    cur[0] = i;
    const uint32_t ca = a[i - 1];
    for (int64_t j = 1; j <= nb; ++j) {
      const int64_t sub = prev[j - 1] + (ca != b[j - 1] ? 1 : 0);
      cur[j] = std::min({prev[j] + 1, cur[j - 1] + 1, sub});
    }
    std::swap(prev, cur);
  }
  return prev[nb];
}

}  // extern "C"
