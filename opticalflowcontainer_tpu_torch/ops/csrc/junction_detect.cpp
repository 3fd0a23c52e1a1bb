// Fishnet junction-point detector: host C++ with no OpenCV, the compiled
// form of opticalflowcontainer_tpu_torch/native (whose docstring states the
// pipeline).  It runs the same steps, in the same arithmetic, as the plain
// version on core/contours.py, which holds each step against cv2:
//
// - the 3x3 blur in OpenCV's 8-bit fixed point: 8-fraction-bit taps, one
//   rounding (+2^15) >> 16 after both passes, BORDER_REFLECT_101;
// - the adaptive threshold's 11x11 mean in float32 as OpenCV's vectorized
//   float filter forms it (a row pass of multiply-adds left to right, a
//   column pass from the centre row adding symmetric pairs, each
//   multiply-add formed in double and rounded once), rounded half to even,
//   BORDER_REPLICATE;
// - Suzuki-Abe border following with OpenCV's chain codes and marks on the
//   image padded with a ring of zeros (RETR_TREE: outer and hole borders);
// - the shoelace area and the box in double; for rotated cells OpenCV's
//   convex hull order and rotating calipers in float32;
// - the clusters as connected components of the candidates' eps-graph
//   (squared float32 distances), found through a uniform grid of eps cells,
//   numbered by their lowest member and averaged in member order.
//
// Built with -ffp-contract=off (ops/_build.py), so the compiler fuses no
// multiply-add the plain version does not.  Exposed as one extern "C"
// function for ctypes.
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <map>
#include <new>
#include <utility>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

// OpenCV's getGaussianKernelBitExact in double (sigma from the size when
// sigma <= 0; the fixed kernels of sizes 1-7).
std::vector<double> gaussian_kernel(int ksize, double sigma) {
  if (sigma <= 0 && ksize <= 7) {
    static const double k1[] = {1.0};
    static const double k3[] = {0.25, 0.5, 0.25};
    static const double k5[] = {0.0625, 0.25, 0.375, 0.25, 0.0625};
    static const double k7[] = {0.03125, 0.109375, 0.21875, 0.28125,
                                0.21875, 0.109375, 0.03125};
    const double* k = ksize == 1 ? k1 : ksize == 3 ? k3 : ksize == 5 ? k5 : k7;
    return std::vector<double>(k, k + ksize);
  }
  const double s = sigma > 0 ? sigma : ksize * 0.15 + 0.35;
  const double scale2 = -0.125 / (s * s);
  const int half = ksize / 2;
  std::vector<double> vals;
  double sum = 0;
  for (int x = 1 - ksize; x < 0; x += 2) {
    vals.push_back(std::exp(double(x * x) * scale2));
    sum += vals.back();
  }
  const double mul = 1.0 / (2.0 * sum + 1.0);
  std::vector<double> k(ksize);
  for (int i = 0; i < half; ++i) k[i] = k[ksize - 1 - i] = vals[i] * mul;
  k[half] = mul;
  return k;
}

// The kernel for 8-bit images: 8 fraction bits by error diffusion, the
// centre tap taking the remainder so the taps sum to 256.
std::vector<int64_t> gaussian_kernel_fixed(int ksize, double sigma) {
  const std::vector<double> k = gaussian_kernel(ksize, sigma);
  std::vector<int64_t> out(ksize);
  const int n2 = ksize / 2;
  double err = 0;
  int64_t sum = 0;
  for (int i = 0; i < n2; ++i) {
    const double adj = k[i] * 256.0 + err;
    const int64_t v = static_cast<int64_t>(std::nearbyint(adj));
    err = adj - double(v);
    out[i] = out[ksize - 1 - i] = v;
    sum += v;
  }
  out[n2] = 256 - 2 * sum;
  return out;
}

inline int reflect101(int i, int n) {
  if (n == 1) return 0;
  while (i < 0 || i >= n) i = i < 0 ? -i : 2 * n - 2 - i;
  return i;
}

inline int clampi(int i, int n) { return i < 0 ? 0 : i >= n ? n - 1 : i; }

// cv2.GaussianBlur(src, (ksize, ksize), 0) of an 8-bit image, reflect-101:
// exact integer sums (at most 255 * 256 * 256), one rounding.
void blur_fixed(const uint8_t* src, uint8_t* dst, int H, int W, int ksize) {
  const std::vector<int64_t> k64 = gaussian_kernel_fixed(ksize, 0.0);
  const std::vector<int32_t> k(k64.begin(), k64.end());
  const int r = ksize / 2;
  std::vector<int32_t> rows(size_t(H) * W), pad(W + 2 * r);
  for (int y = 0; y < H; ++y) {
    const uint8_t* s = src + size_t(y) * W;
    for (int x = 0; x < W + 2 * r; ++x) pad[x] = s[reflect101(x - r, W)];
    int32_t* out = &rows[size_t(y) * W];
    for (int x = 0; x < W; ++x) out[x] = 0;
    for (int j = 0; j < ksize; ++j)
      for (int x = 0; x < W; ++x) out[x] += k[j] * pad[x + j];
  }
  std::vector<int32_t> acc(W);
  for (int y = 0; y < H; ++y) {
    for (int x = 0; x < W; ++x) acc[x] = 1 << 15;
    for (int i = 0; i < ksize; ++i) {
      const int32_t* row = &rows[size_t(reflect101(y + i - r, H)) * W];
      for (int x = 0; x < W; ++x) acc[x] += k[i] * row[x];
    }
    uint8_t* out = dst + size_t(y) * W;
    for (int x = 0; x < W; ++x) out[x] = static_cast<uint8_t>(acc[x] >> 16);
  }
}

// float32 fma(a, b, c) formed in double and rounded once, as the plain
// version forms it (exact where the double sum is, as in the row pass).
inline float fma32(float a, float b, float c) {
  return float(double(a) * double(b) + double(c));
}

// cv2.adaptiveThreshold(src, 255, GAUSSIAN_C, THRESH_BINARY_INV, ksize, c):
// 1 where src - mean <= -floor(c), else 0.
void adaptive_threshold_inv(const uint8_t* src, uint8_t* dst, int H, int W,
                            int ksize, double c) {
  const std::vector<double> kd = gaussian_kernel(ksize, 0.0);
  const std::vector<float> k(kd.begin(), kd.end());
  const int r = ksize / 2;
  // the row pass over each image row (the column pass replicates rows)
  std::vector<float> rows(size_t(H) * W), pad(W + 2 * r);
  for (int y = 0; y < H; ++y) {
    const uint8_t* s = src + size_t(y) * W;
    for (int x = 0; x < W + 2 * r; ++x) pad[x] = float(s[clampi(x - r, W)]);
    float* out = &rows[size_t(y) * W];
    for (int x = 0; x < W; ++x) out[x] = k[0] * pad[x];
    for (int j = 1; j < ksize; ++j)
      for (int x = 0; x < W; ++x) out[x] = fma32(k[j], pad[x + j], out[x]);
  }
  const int idelta = static_cast<int>(std::floor(c));
  std::vector<float> acc(W);
  for (int y = 0; y < H; ++y) {
    const float* mid = &rows[size_t(y) * W];
    for (int x = 0; x < W; ++x) acc[x] = k[r] * mid[x];
    for (int j = 1; j <= r; ++j) {
      const float* lo = &rows[size_t(clampi(y + j, H)) * W];
      const float* hi = &rows[size_t(clampi(y - j, H)) * W];
      for (int x = 0; x < W; ++x) acc[x] = fma32(k[r + j], lo[x] + hi[x], acc[x]);
    }
    const uint8_t* s = src + size_t(y) * W;
    uint8_t* out = dst + size_t(y) * W;
    for (int x = 0; x < W; ++x)
      out[x] = int(s[x]) - static_cast<int>(std::nearbyint(acc[x])) <= -idelta;
  }
}

// Labels of the padded image: 0 background, then the foreground's marks.
enum : int8_t { kUnseen = 1, kSeen = 2, kRightZero = 3 };

// One border from i0 (OpenCV's icvFetchContourEx), as flat positions of
// the padded image.
void trace(std::vector<int8_t>& lab, const int* delta, int i0, bool hole,
           std::vector<int>& chain) {
  chain.clear();
  int s = hole ? 0 : 4;
  int s_end = s;
  int i1;
  do {
    s = (s - 1) & 7;
    i1 = i0 + delta[s];
  } while (lab[i1] == 0 && s != s_end);
  if (s == s_end) {  // an isolated pixel
    lab[i0] = kRightZero;
    chain.push_back(i0);
    return;
  }
  int i3 = i0;
  for (;;) {
    s_end = s;
    int i4 = i3;
    while (s < 15) {
      i4 = i3 + delta[++s];
      if (lab[i4] != 0) break;
    }
    s &= 7;
    if (unsigned(s - 1) < unsigned(s_end))
      lab[i3] = kRightZero;
    else if (lab[i3] == kUnseen)
      lab[i3] = kSeen;
    chain.push_back(i3);
    if (i4 == i0 && i3 == i1) return;
    i3 = i4;
    s = (s + 4) & 7;
  }
}

struct Pt {
  int x, y;
};

double shoelace(const std::vector<Pt>& p) {
  if (p.size() < 3) return 0.0;
  double a = 0;
  Pt prev = p.back();
  for (const Pt& q : p) {
    a += double(prev.x) * q.y - double(prev.y) * q.x;
    prev = q;
  }
  return std::fabs(a * 0.5);
}

// CHAIN_APPROX_SIMPLE of a chain: the pixels where it turns.
std::vector<Pt> approx_simple(const std::vector<Pt>& c) {
  const size_t n = c.size();
  if (n < 3) return c;
  std::vector<Pt> out;
  for (size_t i = 0; i < n; ++i) {
    const Pt& prev = c[(i + n - 1) % n];
    const Pt& next = c[(i + 1) % n];
    const int ix = c[i].x - prev.x, iy = c[i].y - prev.y;
    const int ox = next.x - c[i].x, oy = next.y - c[i].y;
    if (ix != ox || iy != oy) out.push_back(c[i]);
  }
  return out;
}

inline int64_t cross(const Pt& o, const Pt& a, const Pt& b) {
  return int64_t(a.x - o.x) * (b.y - o.y) - int64_t(a.y - o.y) * (b.x - o.x);
}

// cv2.convexHull(points) in OpenCV's order (core/contours.py convex_hull):
// strictly convex, positive signed area, shifted to start the cyclic run of
// the vertices' first indices in `c` where that run is monotone, else at
// the largest point.
std::vector<Pt> convex_hull(const std::vector<Pt>& c) {
  struct Q {
    int x, y, idx;
  };
  std::vector<Q> q(c.size());
  for (size_t i = 0; i < c.size(); ++i) q[i] = {c[i].x, c[i].y, int(i)};
  std::sort(q.begin(), q.end(), [](const Q& a, const Q& b) {
    return a.x != b.x ? a.x < b.x : a.y != b.y ? a.y < b.y : a.idx < b.idx;
  });
  std::vector<Q> u;
  for (const Q& e : q)
    if (u.empty() || u.back().x != e.x || u.back().y != e.y) u.push_back(e);
  const int n = int(u.size());
  if (n <= 2) {
    std::vector<Pt> out;
    for (int i = n - 1; i >= 0; --i) out.push_back({u[i].x, u[i].y});
    return out;
  }
  auto half = [&](int from, int to, int step) {
    std::vector<int> h;
    for (int i = from;; i += step) {
      while (h.size() >= 2 &&
             cross({u[h[h.size() - 2]].x, u[h[h.size() - 2]].y},
                   {u[h.back()].x, u[h.back()].y}, {u[i].x, u[i].y}) <= 0)
        h.pop_back();
      h.push_back(i);
      if (i == to) break;
    }
    h.pop_back();
    return h;
  };
  std::vector<int> ring = half(0, n - 1, 1);
  const std::vector<int> upper = half(n - 1, 0, -1);
  ring.insert(ring.end(), upper.begin(), upper.end());
  const int m = int(ring.size());
  int start = int(std::find(ring.begin(), ring.end(), n - 1) - ring.begin());
  std::rotate(ring.begin(), ring.begin() + start, ring.end());
  int lo = 0, hi = 0;
  for (int i = 1; i < m; ++i) {
    if (u[ring[i]].idx < u[ring[lo]].idx) lo = i;
    if (u[ring[i]].idx > u[ring[hi]].idx) hi = i;
  }
  for (int pass = 0; pass < 2; ++pass) {
    const int i0 = pass == 0 ? lo : hi;
    bool monotone = true;
    for (int k = 0; k + 1 < m && monotone; ++k) {
      const int a = u[ring[(i0 + k) % m]].idx, b = u[ring[(i0 + k + 1) % m]].idx;
      monotone = (a < b) == (pass == 0);
    }
    if (monotone) {
      std::rotate(ring.begin(), ring.begin() + i0, ring.end());
      break;
    }
  }
  std::vector<Pt> out(m);
  for (int i = 0; i < m; ++i) out[i] = {u[ring[i]].x, u[ring[i]].y};
  return out;
}

struct RotRect {
  float cx, cy, w, h, angle;  // angle in degrees, [-90, 0)
};

// cv2.minAreaRect of a convex polygon of >= 3 vertices: OpenCV's
// rotatingCalipers (CALIPERS_MINAREARECT) in float32.
RotRect min_area_rect(const std::vector<Pt>& hull) {
  const int n = int(hull.size());
  std::vector<float> px(n), py(n), vx(n), vy(n), inv_len(n);
  for (int i = 0; i < n; ++i) px[i] = float(hull[i].x), py[i] = float(hull[i].y);
  int left = 0, bottom = 0, right = 0, top = 0;
  float lx = px[0], rx = px[0], ty = py[0], by = py[0];
  for (int i = 0; i < n; ++i) {
    if (px[i] < lx) lx = px[i], left = i;
    if (px[i] > rx) rx = px[i], right = i;
    if (py[i] > ty) ty = py[i], top = i;
    if (py[i] < by) by = py[i], bottom = i;
    const int j = (i + 1) % n;
    const double dx = double(px[j]) - px[i], dy = double(py[j]) - py[i];
    vx[i] = float(dx);
    vy[i] = float(dy);
    inv_len[i] = float(1.0 / std::sqrt(dx * dx + dy * dy));
  }
  float orientation = 0;
  {
    double ax = vx[n - 1], ay = vy[n - 1];
    for (int i = 0; i < n; ++i) {
      const double conv = ax * vy[i] - ay * vx[i];
      if (conv != 0) {
        orientation = conv > 0 ? 1.f : -1.f;
        break;
      }
      ax = vx[i];
      ay = vy[i];
    }
  }
  float base_a = orientation, base_b = 0;
  int seq[4] = {bottom, right, top, left};
  float minarea = 3.402823466e+38f;
  int b_left = 0, b_bottom = 0;
  float b_a = 0, b_b = 0, b_w = 0, b_h = 0;
  for (int k = 0; k < n; ++k) {
    const float dp[4] = {
        base_a * vx[seq[0]] + base_b * vy[seq[0]],
        -base_b * vx[seq[1]] + base_a * vy[seq[1]],
        -base_a * vx[seq[2]] - base_b * vy[seq[2]],
        base_b * vx[seq[3]] - base_a * vy[seq[3]],
    };
    float maxcos = dp[0] * inv_len[seq[0]];
    int main_element = 0;
    for (int i = 1; i < 4; ++i) {
      const float c = dp[i] * inv_len[seq[i]];
      if (c > maxcos) main_element = i, maxcos = c;
    }
    const int pi = seq[main_element];
    const float lead_x = vx[pi] * inv_len[pi], lead_y = vy[pi] * inv_len[pi];
    switch (main_element) {
      case 0: base_a = lead_x, base_b = lead_y; break;
      case 1: base_a = lead_y, base_b = -lead_x; break;
      case 2: base_a = -lead_x, base_b = -lead_y; break;
      default: base_a = -lead_y, base_b = lead_x; break;
    }
    seq[main_element] = (seq[main_element] + 1) % n;
    float dx = px[seq[1]] - px[seq[3]], dy = py[seq[1]] - py[seq[3]];
    const float width = dx * base_a + dy * base_b;
    dx = px[seq[2]] - px[seq[0]];
    dy = py[seq[2]] - py[seq[0]];
    const float height = -dx * base_b + dy * base_a;
    const float area = width * height;
    if (area <= minarea) {
      minarea = area;
      b_left = seq[3], b_a = base_a, b_w = width, b_b = base_b, b_h = height;
      b_bottom = seq[0];
    }
  }
  const float a1 = b_a, b1 = b_b, a2 = -b_b, b2 = b_a;
  const float c1 = a1 * px[b_left] + py[b_left] * b1;
  const float c2 = a2 * px[b_bottom] + py[b_bottom] * b2;
  const float idet = 1.f / (a1 * b2 - a2 * b1);
  const float ox = (c1 * b2 - c2 * b1) * idet;
  const float oy = (a1 * c2 - a2 * c1) * idet;
  const float o1x = a1 * b_w, o1y = b1 * b_w, o2x = a2 * b_h, o2y = b2 * b_h;
  RotRect r;
  r.cx = ox + (o1x + o2x) * 0.5f;
  r.cy = oy + (o1y + o2y) * 0.5f;
  r.w = float(std::sqrt(double(o1x) * o1x + double(o1y) * o1y));
  r.h = float(std::sqrt(double(o2x) * o2x + double(o2y) * o2y));
  const float rad = float(std::atan2(double(o1y), double(o1x)));
  r.angle = float(double(rad) * 180.0 / kPi);
  while (r.angle >= 0) r.angle -= 90.f, std::swap(r.w, r.h);
  while (r.angle < -90) r.angle += 90.f, std::swap(r.w, r.h);
  return r;
}

// cv2.boxPoints: the four corners in OpenCV's order.
void box_points(const RotRect& r, float* out) {
  const double rad = double(r.angle) * kPi / 180.0;
  const float b = float(std::cos(rad)) * 0.5f;
  const float a = float(std::sin(rad)) * 0.5f;
  out[0] = r.cx - a * r.h - b * r.w;
  out[1] = r.cy + b * r.h - a * r.w;
  out[2] = r.cx + a * r.h - b * r.w;
  out[3] = r.cy - b * r.h - a * r.w;
  out[4] = 2 * r.cx - out[0];
  out[5] = 2 * r.cy - out[1];
  out[6] = 2 * r.cx - out[2];
  out[7] = 2 * r.cy - out[3];
}

// Appends the four corner candidates of a contour that passes the cell
// filters (native/__init__.py _cell_corners).
void cell_corners(const std::vector<Pt>& chain, double amin, double amax,
                  bool rotated, std::vector<float>& cands) {
  const double area = shoelace(chain);
  if (area < amin || area > amax) return;
  if (rotated) {
    const std::vector<Pt> hull = convex_hull(approx_simple(chain));
    if (hull.size() < 3) return;  // a side of 0: the filter below drops it
    const RotRect r = min_area_rect(hull);
    double rw = r.w, rh = r.h;
    if (r.angle < -45) std::swap(rw, rh);  // the reference's swap, as written
    if (rw <= 0 || rh <= 0) return;
    const double aspect = rw / rh;
    if (area / (rw * rh) < 0.4 || aspect < 0.5 || aspect > 2.0) return;
    float v[8];
    box_points(r, v);
    cands.insert(cands.end(), v, v + 8);
    return;
  }
  int x0 = chain[0].x, x1 = x0, y0 = chain[0].y, y1 = y0;
  for (const Pt& p : chain) {
    x0 = std::min(x0, p.x), x1 = std::max(x1, p.x);
    y0 = std::min(y0, p.y), y1 = std::max(y1, p.y);
  }
  const int bw = x1 - x0 + 1, bh = y1 - y0 + 1;
  const double aspect = double(bw) / bh;
  if (area / (double(bw) * bh) < 0.4 || aspect < 0.5 || aspect > 2.0) return;
  const float c[8] = {float(x0), float(y0), float(x0 + bw), float(y0),
                      float(x0), float(y0 + bh), float(x0 + bw), float(y0 + bh)};
  cands.insert(cands.end(), c, c + 8);
}

// Centroids of the connected components of the eps-graph with at least
// min_pts members, numbered by their lowest member.
int cluster(const std::vector<float>& c, double eps, int min_pts, float* out,
            int max_out) {
  const int n = int(c.size() / 2);
  const float eps2 = float(eps * eps);
  const double cell = eps > 0 ? eps : 1.0;
  auto key = [&](int i) {
    return std::make_pair(int64_t(std::floor(c[2 * i] / cell)),
                          int64_t(std::floor(c[2 * i + 1] / cell)));
  };
  std::map<std::pair<int64_t, int64_t>, std::vector<int>> grid;
  for (int i = 0; i < n; ++i) grid[key(i)].push_back(i);
  std::vector<int> label(n, -1), stack;
  int nc = 0;
  for (int seed = 0; seed < n; ++seed) {
    if (label[seed] != -1) continue;
    label[seed] = nc;
    stack.assign(1, seed);
    while (!stack.empty()) {
      const int i = stack.back();
      stack.pop_back();
      const auto k = key(i);
      for (int64_t dy = -1; dy <= 1; ++dy)
        for (int64_t dx = -1; dx <= 1; ++dx) {
          const auto it = grid.find({k.first + dx, k.second + dy});
          if (it == grid.end()) continue;
          for (int j : it->second) {
            if (label[j] != -1) continue;
            const float ddx = c[2 * j] - c[2 * i], ddy = c[2 * j + 1] - c[2 * i + 1];
            if (ddx * ddx + ddy * ddy <= eps2) {
              label[j] = nc;
              stack.push_back(j);
            }
          }
        }
    }
    ++nc;
  }
  std::vector<int> count(nc, 0);
  std::vector<float> sx(nc, 0.f), sy(nc, 0.f);
  for (int i = 0; i < n; ++i) {
    ++count[label[i]];
    sx[label[i]] += c[2 * i];
    sy[label[i]] += c[2 * i + 1];
  }
  int m = 0;
  for (int k = 0; k < nc && m < max_out; ++k)
    if (count[k] >= min_pts) {
      out[2 * m] = sx[k] / float(count[k]);
      out[2 * m + 1] = sy[k] / float(count[k]);
      ++m;
    }
  return m;
}

}  // namespace

extern "C" {

// Junction points of a bgr8 image [height, width, 3]: writes up to max_out
// (x, y) pairs into out_xy and returns their count, or -1 on a bad argument
// or when memory runs out.
int ofc_detect_junctions(const uint8_t* bgr, int height, int width,
                         double grid_area, double area_tol, double cluster_eps,
                         int min_cluster_pts, double rb_lo, double rb_hi,
                         int rotated, float* out_xy, int max_out) {
  if (!bgr || !out_xy || height < 1 || width < 1 || max_out < 0) return -1;
  try {
    const int H = height, W = width;
    const size_t N = size_t(H) * W;
    std::vector<uint8_t> gray(N), blurred(N), binary(N);
    const float lo = float(rb_lo);
    const float span = float(std::max(rb_hi - rb_lo, 1.0));
    for (size_t i = 0; i < N; ++i) {
      const float b = bgr[3 * i], g = bgr[3 * i + 1], r = bgr[3 * i + 2];
      const float rb = r - b;
      float w = 1.f;
      if (rb < lo) w = std::max(0.f, 1.f + (rb - lo) / span);
      const float lum = 0.114f * b + 0.587f * g + 0.299f * r;
      gray[i] = static_cast<uint8_t>(std::min(255.f, lum * w));
    }
    blur_fixed(gray.data(), blurred.data(), H, W, 3);
    adaptive_threshold_inv(blurred.data(), binary.data(), H, W, 11, 2.0);

    const int Wp = W + 2;
    std::vector<int8_t> lab(size_t(H + 2) * Wp, 0);
    for (int y = 0; y < H; ++y)
      for (int x = 0; x < W; ++x)
        lab[size_t(y + 1) * Wp + x + 1] = binary[size_t(y) * W + x] ? kUnseen : 0;
    int delta[16];
    const int dxs[8] = {1, 1, 0, -1, -1, -1, 0, 1};
    const int dys[8] = {0, -1, -1, -1, 0, 1, 1, 1};
    for (int s = 0; s < 16; ++s) delta[s] = dxs[s & 7] + dys[s & 7] * Wp;

    const double amin = grid_area / area_tol, amax = grid_area * area_tol;
    std::vector<float> cands;
    std::vector<int> flat;
    std::vector<Pt> chain;
    for (int y = 1; y <= H; ++y) {
      const size_t row = size_t(y) * Wp;
      for (int x = 1; x <= W + 1; ++x) {
        const int pos = int(row + x);
        const bool here = lab[pos] != 0, before = lab[pos - 1] != 0;
        if (here == before) continue;
        if (here) {
          if (lab[pos] != kUnseen) continue;
          trace(lab, delta, pos, false, flat);
        } else {
          if (lab[pos - 1] != kUnseen && lab[pos - 1] != kSeen) continue;
          trace(lab, delta, pos - 1, true, flat);
        }
        chain.resize(flat.size());
        for (size_t i = 0; i < flat.size(); ++i)
          chain[i] = {flat[i] % Wp - 1, flat[i] / Wp - 1};
        cell_corners(chain, amin, amax, rotated != 0, cands);
      }
    }
    if (cands.empty()) return 0;
    return cluster(cands, cluster_eps, min_cluster_pts, out_xy, max_out);
  } catch (const std::bad_alloc&) {
    return -1;
  }
}

}  // extern "C"
