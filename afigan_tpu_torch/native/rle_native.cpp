// The port's native host library for COCO evaluation and the pseudo labels:
// the RLE mask codec and the IoU entries (counterpart of
// afigan_tpu/native/rle_native.cpp, the same six entries and the same
// outputs on every valid input). Compiled with g++ at first use by
// afigan_tpu_torch/native/__init__.py and bound through ctypes;
// afigan_tpu_torch/evaluation/rle.py falls back to numpy where it cannot be
// built.
//
// Format (pycocotools' RLE): column-major runs starting with zeros; the
// string form delta-codes each count against count[i-2] (from i = 3) into
// base-32 varints offset by '0' (48).
//
// Beyond the reference's copy, inputs it leaves undefined are guarded: an
// empty side in rle_decode, runs that would land before the mask's start,
// and rle_iou_single on an empty counts list (returns -1, which the loader
// turns into the numpy path's IndexError).

#include <cstdint>
#include <cstring>

extern "C" {

// Binary mask (row-major in memory, walked column-major; any non-zero byte
// is foreground) -> counts. Returns the number written, -1 if out_cap is too
// small.
int rle_encode(const uint8_t* mask, int h, int w, int64_t* counts_out, int out_cap) {
  int n = 0;
  int64_t run = 0;
  uint8_t cur = 0;
  for (int x = 0; x < w; ++x) {
    for (int y = 0; y < h; ++y) {
      uint8_t v = mask[(int64_t)y * w + x] ? 1 : 0;
      if (v != cur) {
        if (n >= out_cap) return -1;
        counts_out[n++] = run;
        run = 0;
        cur = v;
      }
      ++run;
    }
  }
  if (n >= out_cap) return -1;
  counts_out[n++] = run;
  return n;
}

// Counts -> row-major uint8 mask (runs past the end are cut off).
void rle_decode(const int64_t* counts, int n, int h, int w, uint8_t* out) {
  memset(out, 0, (size_t)h * w);
  if (h <= 0 || w <= 0) return;
  int64_t pos = 0;
  uint8_t val = 0;
  for (int i = 0; i < n; ++i) {
    if (val) {
      for (int64_t k = 0; k < counts[i]; ++k) {
        int64_t p = pos + k;
        if (p < 0) continue;
        int64_t x = p / h;
        int64_t y = p % h;
        if (x < w) out[y * w + x] = 1;
      }
    }
    pos += counts[i];
    val ^= 1;
  }
}

// Counts -> pycocotools' string (rleToString). Returns its length, -1 if cap
// is too small.
int rle_counts_to_string(const int64_t* counts, int n, char* out, int cap) {
  int m = 0;
  for (int i = 0; i < n; ++i) {
    int64_t x = counts[i];
    if (i > 2) x -= counts[i - 2];
    bool more = true;
    while (more) {
      int c = (int)(x & 0x1f);
      x >>= 5;
      more = (c & 0x10) ? (x != -1) : (x != 0);
      if (more) c |= 0x20;
      if (m >= cap) return -1;
      out[m++] = (char)(c + 48);
    }
  }
  return m;
}

// pycocotools' string -> counts. Returns the number written, -1 if cap is too
// small or the last varint is cut off (its continuation bit set).
int rle_string_to_counts(const char* s, int len, int64_t* out, int cap) {
  int n = 0;
  int i = 0;
  while (i < len) {
    int64_t x = 0;
    int k = 0;
    bool more = true;
    while (more) {
      if (i >= len) return -1;
      int c = s[i] - 48;
      // bits past the 64th are dropped, and so is a sign extension there
      if (5 * k < 64) x |= (int64_t)((uint64_t)(c & 0x1f) << (5 * k));
      more = (c & 0x20) != 0;
      ++i;
      ++k;
      if (!more && (c & 0x10) && 5 * k < 64) x |= (int64_t)(~(uint64_t)0 << (5 * k));
    }
    if (n > 2) x += out[n - 2];
    if (n >= cap) return -1;
    out[n++] = x;
  }
  return n;
}

// Pairwise IoU of xywh boxes, crowd-aware (COCOeval): out[i * ng + j].
void bbox_iou_matrix(const double* dt, int nd, const double* gt, int ng,
                     const uint8_t* iscrowd, double* out) {
  for (int j = 0; j < ng; ++j) {
    double gx1 = gt[j * 4], gy1 = gt[j * 4 + 1];
    double gx2 = gx1 + gt[j * 4 + 2], gy2 = gy1 + gt[j * 4 + 3];
    double ga = gt[j * 4 + 2] * gt[j * 4 + 3];
    for (int i = 0; i < nd; ++i) {
      double dx1 = dt[i * 4], dy1 = dt[i * 4 + 1];
      double dx2 = dx1 + dt[i * 4 + 2], dy2 = dy1 + dt[i * 4 + 3];
      double da = dt[i * 4 + 2] * dt[i * 4 + 3];
      double iw = (dx2 < gx2 ? dx2 : gx2) - (dx1 > gx1 ? dx1 : gx1);
      double ih = (dy2 < gy2 ? dy2 : gy2) - (dy1 > gy1 ? dy1 : gy1);
      double inter = (iw > 0 && ih > 0) ? iw * ih : 0.0;
      double uni = iscrowd[j] ? da : da + ga - inter;
      out[(int64_t)i * ng + j] = uni > 0 ? inter / uni : 0.0;
    }
  }
}

// IoU of two RLE masks given as counts, crowd-aware, by a merge walk over
// the runs (no decode). -1 if either list is empty.
double rle_iou_single(const int64_t* a, int na, const int64_t* b, int nb, int iscrowd) {
  if (na <= 0 || nb <= 0) return -1.0;
  int64_t area_a = 0, area_b = 0;
  for (int i = 1; i < na; i += 2) area_a += a[i];
  for (int i = 1; i < nb; i += 2) area_b += b[i];
  int64_t inter = 0;
  int ia = 0, ib = 0;
  int64_t pa = a[0], pb = b[0];  // where the current runs end
  uint8_t va = 0, vb = 0;
  int64_t pos = 0;
  while (ia < na && ib < nb) {
    int64_t next = pa < pb ? pa : pb;
    if (va && vb) inter += next - pos;
    pos = next;
    if (pa == next) {
      ++ia;
      va ^= 1;
      if (ia < na) pa += a[ia];
    }
    if (pb == next) {
      ++ib;
      vb ^= 1;
      if (ib < nb) pb += b[ib];
    }
  }
  double uni = iscrowd ? (double)area_a : (double)(area_a + area_b - inter);
  return uni > 0 ? (double)inter / uni : 0.0;
}

}  // extern "C"
