// Host helpers of r3det_tpu_torch, bound with ctypes (a plain C ABI):
//
//   png_unfilter(in, out, height, stride, bpp) -> 0, or 1 + the row whose
//       filter type is not one of PNG's five
//   min_area_rect(points, out, n)  (n, 4, 2) f32 quads -> (n, 5) f32
//       (cx, cy, w, h, angle in degrees)
//   transform_points(points, m, out, n)  (n, 2) f64 points through the
//       2x3 f64 affine m -> (n, 2) f64, as cv2.transform computes it
//
// min_area_rect returns what OpenCV 5.0's cv::minAreaRect returns for the
// four points: the convex hull by Sklansky's scan (cv::convexHull,
// counter-clockwise in OpenCV's sense), rotating calipers that keep the last
// rectangle of least area, and the box read off the first caliper side with
// its angle folded into [-90, 0) by quarter turns that swap w and h (an
// axis-aligned rectangle gives -90). The precision of each step is the one
// that reproduces OpenCV 5.0's results (edge lengths and the caliper
// cosines in double, the rest in float), found by comparison with
// cv2.minAreaRect: bit-equal on random quads, within a few float ulps on
// float32 rotated rectangles. Build without FMA
// contraction (-ffp-contract=off): OpenCV's SSE build rounds every float
// product and sum.
#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdlib>

namespace {

// ---------------------------------------------------------------- PNG

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// ---------------------------------------------------- minimum-area rect

struct P2 { float x, y; };

template <typename T>
inline int sign(T v) { return (v > 0) - (v < 0); }

// cv::Sklansky_ on sorted point pointers: a monotone chain from start to
// end (either direction); returns the chain's length in stack.
int sklansky(const P2** array, int start, int end, int* stack, int nsign,
             int sign2) {
  int incr = end > start ? 1 : -1;
  int pprev = start, pcur = pprev + incr, pnext = pcur + incr;
  int stacksize = 3;
  if (start == end || (array[start]->x == array[end]->x &&
                       array[start]->y == array[end]->y)) {
    stack[0] = start;
    return 1;
  }
  stack[0] = pprev;
  stack[1] = pcur;
  stack[2] = pnext;
  end += incr;
  while (pnext != end) {
    float cury = array[pcur]->y;
    float nexty = array[pnext]->y;
    float by = nexty - cury;
    if (sign(by) != nsign) {
      float ax = array[pcur]->x - array[pprev]->x;
      float bx = array[pnext]->x - array[pcur]->x;
      float ay = cury - array[pprev]->y;
      double convexity = (double)ay * bx - (double)ax * by;
      if (sign(convexity) == sign2 && (ax != 0 || ay != 0)) {
        pprev = pcur;
        pcur = pnext;
        pnext += incr;
        stack[stacksize] = pnext;
        stacksize++;
      } else if (pprev == start) {
        pcur = pnext;
        stack[1] = pcur;
        pnext += incr;
        stack[2] = pnext;
      } else {
        stack[stacksize - 2] = pnext;
        pcur = pprev;
        pprev = stack[stacksize - 4];
        stacksize--;
      }
    } else {
      pnext += incr;
      stack[stacksize - 1] = pnext;
    }
  }
  return --stacksize;
}

// cv::convexHull(points, hull, clockwise=false, returnPoints=true) of
// total <= 4 points; returns the hull's size.
int convex_hull(const P2* data0, int total, P2* hull) {
  const P2* pointer[4];
  int stack[4 + 2];
  int hullbuf[4];
  int nout = 0, miny_ind = 0, maxy_ind = 0;
  for (int i = 0; i < total; ++i) pointer[i] = &data0[i];
  std::sort(pointer, pointer + total, [](const P2* p1, const P2* p2) {
    if (p1->x != p2->x) return p1->x < p2->x;
    if (p1->y != p2->y) return p1->y < p2->y;
    return p1 < p2;
  });
  for (int i = 1; i < total; ++i) {
    float y = pointer[i]->y;
    if (pointer[miny_ind]->y > y) miny_ind = i;
    if (pointer[maxy_ind]->y < y) maxy_ind = i;
  }
  if (pointer[0]->x == pointer[total - 1]->x &&
      pointer[0]->y == pointer[total - 1]->y) {
    hullbuf[nout++] = 0;
  } else {
    // upper half
    int* tl_stack = stack;
    int tl_count = sklansky(pointer, 0, maxy_ind, tl_stack, -1, 1);
    int* tr_stack = stack + tl_count;
    int tr_count = sklansky(pointer, total - 1, maxy_ind, tr_stack, -1, -1);
    // counter-clockwise
    std::swap(tl_stack, tr_stack);
    std::swap(tl_count, tr_count);
    for (int i = 0; i < tl_count - 1; ++i)
      hullbuf[nout++] = int(pointer[tl_stack[i]] - data0);
    for (int i = tr_count - 1; i > 0; --i)
      hullbuf[nout++] = int(pointer[tr_stack[i]] - data0);
    int stop_idx = tr_count > 2   ? tr_stack[1]
                   : tl_count > 2 ? tl_stack[tl_count - 2]
                                  : -1;
    // lower half
    int* bl_stack = stack;
    int bl_count = sklansky(pointer, 0, miny_ind, bl_stack, 1, -1);
    int* br_stack = stack + bl_count;
    int br_count = sklansky(pointer, total - 1, miny_ind, br_stack, 1, 1);
    if (stop_idx >= 0) {
      int check_idx = bl_count > 2              ? bl_stack[1]
                      : bl_count + br_count > 2 ? br_stack[2 - bl_count]
                                                : -1;
      if (check_idx == stop_idx ||
          (check_idx >= 0 && pointer[check_idx]->x == pointer[stop_idx]->x &&
           pointer[check_idx]->y == pointer[stop_idx]->y)) {
        // all points on one line: the lower chain mirrors the upper one
        bl_count = std::min(bl_count, 2);
        br_count = std::min(br_count, 2);
      }
    }
    for (int i = 0; i < bl_count - 1; ++i)
      hullbuf[nout++] = int(pointer[bl_stack[i]] - data0);
    for (int i = br_count - 1; i > 0; --i)
      hullbuf[nout++] = int(pointer[br_stack[i]] - data0);
    // cyclic shift toward an ascending or descending index sequence
    if (nout >= 3) {
      int min_idx = 0, max_idx = 0, lt = 0;
      for (int i = 1; i < nout; ++i) {
        int idx = hullbuf[i];
        lt += hullbuf[i - 1] < idx;
        if (lt > 1 && lt <= i - 2) break;
        if (idx < hullbuf[min_idx]) min_idx = i;
        if (idx > hullbuf[max_idx]) max_idx = i;
      }
      int mmdist = std::abs(max_idx - min_idx);
      if ((mmdist == 1 || mmdist == nout - 1) &&
          (lt <= 1 || lt >= nout - 2)) {
        int ascending = (max_idx + 1) % nout == min_idx;
        int i0 = ascending ? min_idx : max_idx, j = i0;
        if (i0 > 0) {
          int shifted[4];
          int i = 0;
          for (; i < nout; ++i) {
            int curr_idx = shifted[i] = hullbuf[j];
            int next_j = j + 1 < nout ? j + 1 : 0;
            int next_idx = hullbuf[next_j];
            if (i < nout - 1 && (ascending != (curr_idx < next_idx))) break;
            j = next_j;
          }
          if (i == nout) std::copy(shifted, shifted + nout, hullbuf);
        }
      }
    }
  }
  for (int i = 0; i < nout; ++i) hull[i] = data0[hullbuf[i]];
  return nout;
}

// cv::rotatingCalipers in CALIPERS_MINAREARECT mode: out[0] the corner,
// out[1], out[2] the two sides.
void rotating_calipers(const P2* points, int n, P2* out) {
  float minarea = FLT_MAX;
  double inv_vect_length[4];
  P2 vect[4];
  int left = 0, bottom = 0, right = 0, top = 0;
  int seq[4];
  float orientation = 0, base_a, base_b = 0;
  P2 pt0 = points[0];
  float left_x = pt0.x, right_x = pt0.x, top_y = pt0.y, bottom_y = pt0.y;
  for (int i = 0; i < n; ++i) {
    if (pt0.x < left_x) left_x = pt0.x, left = i;
    if (pt0.x > right_x) right_x = pt0.x, right = i;
    if (pt0.y > top_y) top_y = pt0.y, top = i;
    if (pt0.y < bottom_y) bottom_y = pt0.y, bottom = i;
    P2 pt = points[i + 1 < n ? i + 1 : 0];
    double dx = pt.x - pt0.x;
    double dy = pt.y - pt0.y;
    vect[i].x = (float)dx;
    vect[i].y = (float)dy;
    inv_vect_length[i] = 1. / std::sqrt(dx * dx + dy * dy);
    pt0 = pt;
  }
  {
    double ax = vect[n - 1].x, ay = vect[n - 1].y;
    for (int i = 0; i < n; ++i) {
      double bx = vect[i].x, by = vect[i].y;
      double convexity = ax * by - ay * bx;
      if (convexity != 0) {
        orientation = convexity > 0 ? 1.f : -1.f;
        break;
      }
      ax = bx;
      ay = by;
    }
  }
  base_a = orientation;
  seq[0] = bottom;
  seq[1] = right;
  seq[2] = top;
  seq[3] = left;
  int best_left = 0, best_bottom = 0;
  float best_a = 0, best_b = 0, best_w = 0, best_h = 0;
  for (int k = 0; k < n; ++k) {
    double a = base_a, b = base_b;
    double dp[4] = {
        +a * vect[seq[0]].x + b * vect[seq[0]].y,
        -b * vect[seq[1]].x + a * vect[seq[1]].y,
        -a * vect[seq[2]].x - b * vect[seq[2]].y,
        +b * vect[seq[3]].x - a * vect[seq[3]].y,
    };
    double maxcos = dp[0] * inv_vect_length[seq[0]];
    int main_element = 0;
    for (int i = 1; i < 4; ++i) {
      double cosalpha = dp[i] * inv_vect_length[seq[i]];
      if (cosalpha > maxcos) {
        main_element = i;
        maxcos = cosalpha;
      }
    }
    int pindex = seq[main_element];
    float inv = (float)inv_vect_length[pindex];
    float lead_x = vect[pindex].x * inv;
    float lead_y = vect[pindex].y * inv;
    switch (main_element) {
      case 0: base_a = lead_x; base_b = lead_y; break;
      case 1: base_a = lead_y; base_b = -lead_x; break;
      case 2: base_a = -lead_x; base_b = -lead_y; break;
      default: base_a = -lead_y; base_b = lead_x; break;
    }
    seq[main_element] += 1;
    seq[main_element] = seq[main_element] == n ? 0 : seq[main_element];
    float dx = points[seq[1]].x - points[seq[3]].x;
    float dy = points[seq[1]].y - points[seq[3]].y;
    float width = dx * base_a + dy * base_b;
    dx = points[seq[2]].x - points[seq[0]].x;
    dy = points[seq[2]].y - points[seq[0]].y;
    float height = -dx * base_b + dy * base_a;
    float area = width * height;
    if (area <= minarea) {
      minarea = area;
      best_left = seq[3];
      best_a = base_a;
      best_w = width;
      best_b = base_b;
      best_h = height;
      best_bottom = seq[0];
    }
  }
  float A1 = best_a, B1 = best_b, A2 = -best_b, B2 = best_a;
  float C1 = A1 * points[best_left].x + points[best_left].y * B1;
  float C2 = A2 * points[best_bottom].x + points[best_bottom].y * B2;
  float idet = 1.f / (A1 * B2 - A2 * B1);
  out[0].x = (C1 * B2 - C2 * B1) * idet;
  out[0].y = (A1 * C2 - A2 * C1) * idet;
  out[1].x = A1 * best_w;
  out[1].y = B1 * best_w;
  out[2].x = A2 * best_h;
  out[2].y = B2 * best_h;
}

void min_area_rect_one(const float* q, float* res) {
  P2 pts[4], hull[4], out[3];
  for (int i = 0; i < 4; ++i) pts[i] = {q[2 * i], q[2 * i + 1]};
  int n = convex_hull(pts, 4, hull);
  float cx = 0, cy = 0, w = 0, h = 0;
  double angle = 0;
  if (n > 2) {
    rotating_calipers(hull, n, out);
    cx = out[0].x + (out[1].x + out[2].x) * 0.5f;
    cy = out[0].y + (out[1].y + out[2].y) * 0.5f;
    w = (float)std::sqrt((double)out[1].x * out[1].x +
                         (double)out[1].y * out[1].y);
    h = (float)std::sqrt((double)out[2].x * out[2].x +
                         (double)out[2].y * out[2].y);
    angle = std::atan2((double)out[1].y, (double)out[1].x);
  } else if (n == 2) {
    cx = (hull[0].x + hull[1].x) * 0.5f;
    cy = (hull[0].y + hull[1].y) * 0.5f;
    double dx = hull[1].x - hull[0].x, dy = hull[1].y - hull[0].y;
    w = (float)std::sqrt(dx * dx + dy * dy);
    angle = std::atan2(dy, dx);
  } else {
    cx = hull[0].x;
    cy = hull[0].y;
  }
  angle = angle * 180 / M_PI;
  while (angle >= 0) {
    angle -= 90;
    std::swap(w, h);
  }
  while (angle < -90) {
    angle += 90;
    std::swap(w, h);
  }
  res[0] = cx;
  res[1] = cy;
  res[2] = w;
  res[3] = h;
  res[4] = (float)angle;
}

}  // namespace

extern "C" {

// in: height rows of (filter byte, stride bytes); out: height x stride.
int64_t png_unfilter(const uint8_t* in, uint8_t* out, int64_t height,
                     int64_t stride, int64_t bpp) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* src = in + y * (stride + 1);
    uint8_t ft = *src++;
    uint8_t* dst = out + y * stride;
    const uint8_t* up = y > 0 ? dst - stride : nullptr;
    switch (ft) {
      case 0:
        std::copy(src, src + stride, dst);
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i)
          dst[i] = uint8_t(src[i] + (i >= bpp ? dst[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i)
          dst[i] = uint8_t(src[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? dst[i - bpp] : 0, b = up ? up[i] : 0;
          dst[i] = uint8_t(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? dst[i - bpp] : 0, b = up ? up[i] : 0;
          int c = (i >= bpp && up) ? up[i - bpp] : 0;
          dst[i] = uint8_t(src[i] + paeth(a, b, c));
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

void min_area_rect(const float* points, float* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    min_area_rect_one(points + 8 * i, out + 5 * i);
}

// cv::transform of OpenCV 5.0 (x86-64 build) as found by comparison with
// cv2.transform, bit-equal: a matrix whose off-diagonal entries are both
// within DBL_EPSILON of 0 takes its diagonal path, fma(m0, x, m2); any
// other computes m0*x + m1*y + m2 contracted as fma(m0, x, m1*y) + m2
// (the unfused sum and fma(m1, y, m0*x) + m2 differ from it).
void transform_points(const double* points, const double* m, double* out,
                      int64_t n) {
  bool diag = std::fabs(m[1]) <= DBL_EPSILON && std::fabs(m[3]) <= DBL_EPSILON;
  for (int64_t i = 0; i < n; ++i) {
    double x = points[2 * i], y = points[2 * i + 1];
    if (diag) {
      out[2 * i] = std::fma(m[0], x, m[2]);
      out[2 * i + 1] = std::fma(m[4], y, m[5]);
    } else {
      out[2 * i] = std::fma(m[0], x, m[1] * y) + m[2];
      out[2 * i + 1] = std::fma(m[3], x, m[4] * y) + m[5];
    }
  }
}

}  // extern "C"
