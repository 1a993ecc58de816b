// Native host-side components for stereo_match_tpu.
//
// The TPU handles all dense per-pixel compute; these are the genuinely
// irregular host-side algorithms the reference delegates to native code:
//  * Delaunay triangulation (Bowyer-Watson) + slanted-plane rasterization —
//    the host half of the ELAS-style pipeline (SURVEY.md §2 N7; libelas is
//    C++ in the reference, libelas/script.py:9),
//  * union-find speckle component filter — the exact CPU counterpart of
//    OpenCV's filterSpeckles (used when disparity maps live on host).
//
// Built as a plain shared library, bound via ctypes (no pybind11 in the
// image). All matrices are row-major C floats/doubles.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// ----------------------------------------------------------------------
// Bowyer-Watson Delaunay triangulation.
// pts: n * 2 doubles (x, y). tri_out: capacity 3 * max_tris ints.
// Returns the number of triangles, or -1 on overflow/degeneracy.
// ----------------------------------------------------------------------
struct Tri { int a, b, c; double cx, cy, r2; bool alive; };

// Robust-ish in-circle predicate: q strictly-or-on the circumcircle of
// (a, b, c). Translated-coordinate 3x3 determinant — no circumcenter /
// radius cancellation, which matters because the x-sorted insertion
// order below constantly creates near-collinear frontier slivers whose
// computed circumradius is off by orders of magnitude.
static inline bool in_circle(const double* p, int a, int b, int c, double qx,
                             double qy) {
  const double adx = p[2 * a] - qx, ady = p[2 * a + 1] - qy;
  const double bdx = p[2 * b] - qx, bdy = p[2 * b + 1] - qy;
  const double cdx = p[2 * c] - qx, cdy = p[2 * c + 1] - qy;
  const double ad = adx * adx + ady * ady;
  const double bd = bdx * bdx + bdy * bdy;
  const double cd = cdx * cdx + cdy * cdy;
  const double det = adx * (bdy * cd - bd * cdy)
                   - ady * (bdx * cd - bd * cdx)
                   + ad * (bdx * cdy - bdy * cdx);
  const double orient = (p[2 * b] - p[2 * a]) * (p[2 * c + 1] - p[2 * a + 1])
                      - (p[2 * b + 1] - p[2 * a + 1]) * (p[2 * c] - p[2 * a]);
  // boundary (cocircular) counts as inside, matching the legacy <= test
  return orient >= 0 ? det >= 0 : det <= 0;
}

static void circumcircle(const double* p, int a, int b, int c,
                         double& cx, double& cy, double& r2) {
  const double ax = p[2 * a], ay = p[2 * a + 1];
  const double bx = p[2 * b], by = p[2 * b + 1];
  const double cxx = p[2 * c], cyy = p[2 * c + 1];
  const double d = 2.0 * (ax * (by - cyy) + bx * (cyy - ay) + cxx * (ay - by));
  // conditioning gate: a sliver's circumradius is numerically garbage;
  // r2 = -1 marks "unknown circle" (such triangles are never retired by
  // the sweep — containment always uses the determinant predicate)
  const double scale2 = ax * ax + ay * ay + bx * bx + by * by
                      + cxx * cxx + cyy * cyy + 1.0;
  if (std::fabs(d) < 1e-9 * scale2) { cx = cy = 0; r2 = -1; return; }
  const double a2 = ax * ax + ay * ay;
  const double b2 = bx * bx + by * by;
  const double c2 = cxx * cxx + cyy * cyy;
  cx = (a2 * (by - cyy) + b2 * (cyy - ay) + c2 * (ay - by)) / d;
  cy = (a2 * (cxx - bx) + b2 * (ax - cxx) + c2 * (bx - ax)) / d;
  const double dx = ax - cx, dy = ay - cy;
  r2 = dx * dx + dy * dy;
}

int smt_delaunay(const double* pts, int n, int* tri_out, int max_tris) {
  if (n < 3) return 0;
  // bounding super-triangle
  double minx = 1e30, miny = 1e30, maxx = -1e30, maxy = -1e30;
  for (int i = 0; i < n; i++) {
    minx = std::fmin(minx, pts[2 * i]);
    maxx = std::fmax(maxx, pts[2 * i]);
    miny = std::fmin(miny, pts[2 * i + 1]);
    maxy = std::fmax(maxy, pts[2 * i + 1]);
  }
  const double dx = maxx - minx + 1, dy = maxy - miny + 1;
  const double mid_x = (minx + maxx) / 2, mid_y = (miny + maxy) / 2;
  const double M = 20.0 * std::fmax(dx, dy);

  std::vector<double> p(pts, pts + 2 * n);
  p.push_back(mid_x - M); p.push_back(mid_y - M);   // n
  p.push_back(mid_x + M); p.push_back(mid_y - M);   // n+1
  p.push_back(mid_x);     p.push_back(mid_y + M);   // n+2

  // Sweep order: insert points sorted by x (then y). A triangle whose
  // circumcircle lies strictly left of the sweep front (cx + r < px) can
  // never be invalidated by any later point, so it retires permanently —
  // the per-insertion scan touches only the O(frontier) active set
  // instead of every triangle (14k KITTI support points: 2.6 s -> ~40 ms).
  std::vector<int> order(n);
  for (int i = 0; i < n; i++) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int a, int b) {
    if (p[2 * a] != p[2 * b]) return p[2 * a] < p[2 * b];
    return p[2 * a + 1] < p[2 * b + 1];
  });

  std::vector<Tri> active, next_active, done;
  Tri super{n, n + 1, n + 2, 0, 0, 0, true};
  circumcircle(p.data(), super.a, super.b, super.c, super.cx, super.cy, super.r2);
  active.push_back(super);

  std::vector<std::pair<int, int>> edges;
  for (int k = 0; k < n; k++) {
    const int i = order[k];
    const double px = p[2 * i], py = p[2 * i + 1];
    edges.clear();
    next_active.clear();
    // find bad triangles (circumcircle contains point), collect boundary;
    // retire triangles the sweep front has passed
    for (auto& t : active) {
      const double ddx = px - t.cx;
      if (in_circle(p.data(), t.a, t.b, t.c, px, py)) {
        const int e[3][2] = {{t.a, t.b}, {t.b, t.c}, {t.c, t.a}};
        for (auto& ee : e) {
          bool dup = false;
          for (auto& ex : edges) {
            if ((ex.first == ee[1] && ex.second == ee[0]) ||
                (ex.first == ee[0] && ex.second == ee[1])) {
              ex.first = -1;  // shared edge: interior, drop
              dup = true;
              break;
            }
          }
          if (!dup) edges.push_back({ee[0], ee[1]});
        }
      } else if (t.r2 >= 0 && ddx > 0 && ddx * ddx > 1.05 * t.r2) {
        // circle entirely left of the front (5% slack absorbs the
        // relative error of sliver circumradii — an eager retirement
        // here can leave a hole in the triangulation)
        done.push_back(t);
      } else {
        next_active.push_back(t);
      }
    }
    active.swap(next_active);
    for (auto& ex : edges) {
      if (ex.first < 0) continue;
      Tri t{ex.first, ex.second, i, 0, 0, 0, true};
      circumcircle(p.data(), t.a, t.b, t.c, t.cx, t.cy, t.r2);
      active.push_back(t);
    }
  }

  done.insert(done.end(), active.begin(), active.end());
  int count = 0;
  for (auto& t : done) {
    if (t.a >= n || t.b >= n || t.c >= n) continue;  // touches super-tri
    if (count >= max_tris) return -1;
    tri_out[3 * count] = t.a;
    tri_out[3 * count + 1] = t.b;
    tri_out[3 * count + 2] = t.c;
    count++;
  }
  return count;
}

// ----------------------------------------------------------------------
// Rasterize per-triangle disparity planes: for each pixel inside a
// triangle, mu = barycentric interpolation of the vertices' disparities.
// support: n * 3 doubles (x, y, d). mu_out: H * W floats, NaN outside.
// ----------------------------------------------------------------------
void smt_rasterize_planes(const int* tris, int n_tris,
                          const double* support, int n_pts,
                          int height, int width, float* mu_out) {
  (void)n_pts;
  const float nanv = std::nanf("");
  for (int i = 0; i < height * width; i++) mu_out[i] = nanv;
  for (int t = 0; t < n_tris; t++) {
    const int ia = tris[3 * t], ib = tris[3 * t + 1], ic = tris[3 * t + 2];
    const double ax = support[3 * ia], ay = support[3 * ia + 1], ad = support[3 * ia + 2];
    const double bx = support[3 * ib], by = support[3 * ib + 1], bd = support[3 * ib + 2];
    const double cx = support[3 * ic], cy = support[3 * ic + 1], cd = support[3 * ic + 2];
    const double den = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy);
    if (std::fabs(den) < 1e-12) continue;
    int x0 = (int)std::floor(std::fmin(ax, std::fmin(bx, cx)));
    int x1 = (int)std::ceil(std::fmax(ax, std::fmax(bx, cx)));
    int y0 = (int)std::floor(std::fmin(ay, std::fmin(by, cy)));
    int y1 = (int)std::ceil(std::fmax(ay, std::fmax(by, cy)));
    x0 = x0 < 0 ? 0 : x0; y0 = y0 < 0 ? 0 : y0;
    x1 = x1 >= width ? width - 1 : x1;
    y1 = y1 >= height ? height - 1 : y1;
    for (int y = y0; y <= y1; y++) {
      for (int x = x0; x <= x1; x++) {
        const double l1 = ((by - cy) * (x - cx) + (cx - bx) * (y - cy)) / den;
        const double l2 = ((cy - ay) * (x - cx) + (ax - cx) * (y - cy)) / den;
        const double l3 = 1.0 - l1 - l2;
        if (l1 < -1e-9 || l2 < -1e-9 || l3 < -1e-9) continue;
        mu_out[y * width + x] = (float)(l1 * ad + l2 * bd + l3 * cd);
      }
    }
  }
}

// ----------------------------------------------------------------------
// Union-find speckle filter (cv::filterSpeckles semantics).
// disp: H * W floats, NaN = invalid; components of 4-connected pixels with
// |d_a - d_b| <= max_diff smaller than min_size are set to NaN.
// Returns the number of pixels invalidated.
// ----------------------------------------------------------------------
static int uf_find(std::vector<int>& up, int x) {
  while (up[x] != x) { up[x] = up[up[x]]; x = up[x]; }
  return x;
}

int smt_speckle_filter(float* disp, int height, int width,
                       float max_diff, int min_size) {
  const int n = height * width;
  std::vector<int> up(n);
  for (int i = 0; i < n; i++) up[i] = i;
  auto valid = [&](int i) { return !std::isnan(disp[i]); };
  auto join = [&](int a, int b) {
    int ra = uf_find(up, a), rb = uf_find(up, b);
    if (ra != rb) up[ra] = rb;
  };
  for (int y = 0; y < height; y++) {
    for (int x = 0; x < width; x++) {
      const int i = y * width + x;
      if (!valid(i)) continue;
      if (x + 1 < width && valid(i + 1) &&
          std::fabs(disp[i] - disp[i + 1]) <= max_diff) join(i, i + 1);
      if (y + 1 < height && valid(i + width) &&
          std::fabs(disp[i] - disp[i + width]) <= max_diff) join(i, i + width);
    }
  }
  std::vector<int> size(n, 0);
  for (int i = 0; i < n; i++) if (valid(i)) size[uf_find(up, i)]++;
  int removed = 0;
  const float nanv = std::nanf("");
  for (int i = 0; i < n; i++) {
    if (valid(i) && size[uf_find(up, i)] < min_size) {
      disp[i] = nanv;
      removed++;
    }
  }
  return removed;
}

}  // extern "C"
