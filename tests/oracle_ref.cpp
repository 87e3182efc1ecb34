// Independent scalar oracle of the ViennaRay CPU disk trace loop.
//
// This file is the *referee*: a from-scratch, per-ray scalar implementation
// of the reference trace semantics (rayTraceKernel.hpp:118-341 bounce loop,
// checkLocalIntersection :462-507, rejectionControl :435-460,
// raySourceRandom.hpp:50-116 power-cosine source, rayReflection.hpp:13-50,
// rayBoundary.hpp:29-127 wall handling, rayUtil.hpp:104-143 bbox adjust,
// rayPointNeighborhood checkDistance :286-297). It shares NO code with
// viennaray_tpu — different language, per-ray control flow like the
// reference (not a wavefront), its own RNG, its own brute-force nearest-hit.
// Parity tests compare its flux statistically against the JAX tracer so a
// shared misreading of the semantics in the wavefront + kernel paths
// becomes visible.
//
// Built on demand by tests/oracle_ref.py with g++; no dependencies.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <random>
#include <vector>

namespace {

struct V3 {
  double x, y, z;
};

inline double dot(const V3 &a, const V3 &b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

inline V3 sub(const V3 &a, const V3 &b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }

inline V3 scale_add(const V3 &base, const V3 &d, double t) {
  return {base.x + d.x * t, base.y + d.y * t, base.z + d.z * t};
}

inline double norm(const V3 &a) { return std::sqrt(dot(a, a)); }

inline void normalize(V3 &a) {
  double n = norm(a);
  if (n > 0) {
    a.x /= n;
    a.y /= n;
    a.z /= n;
  }
}

inline double &comp(V3 &a, int i) { return i == 0 ? a.x : (i == 1 ? a.y : a.z); }
inline double comp(const V3 &a, int i) {
  return i == 0 ? a.x : (i == 1 ? a.y : a.z);
}

using Rng = std::mt19937_64;

// Marsaglia unit-sphere point (ref: rayUtil.hpp:266-283).
V3 unit_sphere(Rng &rng) {
  std::uniform_real_distribution<double> d11(-1.0, 1.0);
  double x, y, x2py2;
  do {
    x = d11(rng);
    y = d11(rng);
    x2py2 = x * x + y * y;
  } while (x2py2 >= 1.0);
  double tmp = 2.0 * std::sqrt(1.0 - x2py2);
  return {x * tmp, y * tmp, 1.0 - 2.0 * x2py2};
}

// Cosine-weighted diffuse direction (ref: rayReflection.hpp:32-50): sphere
// point plus the surface normal; in 2D the z component is zeroed.
V3 diffuse_dir(const V3 &n, int dim, Rng &rng) {
  V3 r = unit_sphere(rng);
  r.x += n.x;
  r.y += n.y;
  if (dim == 3)
    r.z += n.z;
  else
    r.z = 0.0;
  normalize(r);
  return r;
}

// Specular direction d' = 2 (n . -d) n + d (ref: rayReflection.hpp:13-29).
V3 specular_dir(const V3 &d, const V3 &n) {
  double dp = -dot(d, n);
  return {2.0 * dp * n.x + d.x, 2.0 * dp * n.y + d.y, 2.0 * dp * n.z + d.z};
}

// fillRayDirection<2> analog: 2D rays live in the z=0 plane
// (ref: rayUtil.hpp:210-215).
void flatten_2d(V3 &d, int dim) {
  if (dim == 2) {
    d.z = 0.0;
    normalize(d);
  }
}

// Coned-cosine specular lobe (ref: rayReflection.hpp:54-122): Frisvad ONB
// around the specular direction, accept-reject polar angle
// (u = sqrt(r1), s = sqrt(1-u), theta = maxAngle*s, accept when
// r2*theta*u <= cos(pi/2*s)*sin(theta)), hemisphere fix-up by reflection.
V3 coned_dir(const V3 &d, const V3 &n, double max_angle, int dim, Rng &rng) {
  std::uniform_real_distribution<double> uni(0.0, 1.0);
  V3 w = specular_dir(d, n);
  normalize(w);
  V3 t, b;
  if (w.z < -0.999999) {
    t = {0.0, -1.0, 0.0};
    b = {-1.0, 0.0, 0.0};
  } else {
    double a = 1.0 / (1.0 + w.z);
    double bx = -w.x * w.y * a;
    t = {1.0 - w.x * w.x * a, bx, -w.x};
    b = {bx, 1.0 - w.y * w.y * a, -w.y};
  }
  double theta;
  for (;;) {
    double u = std::sqrt(uni(rng));
    double s = std::sqrt(std::max(1.0 - u, 0.0));
    theta = max_angle * s;
    if (uni(rng) * theta * u <= std::cos(M_PI_2 * s) * std::sin(theta))
      break;
  }
  double sinT = std::sin(theta), cosT = std::cos(theta);
  double phi = 2.0 * M_PI * uni(rng);
  double sinP = std::sin(phi), cosP = std::cos(phi);
  V3 out{sinT * (cosP * t.x + sinP * b.x) + cosT * w.x,
         sinT * (cosP * t.y + sinP * b.y) + cosT * w.y,
         sinT * (cosP * t.z + sinP * b.z) + cosT * w.z};
  double dp = dot(out, n);
  if (dp <= 0.0) {
    out.x -= 2.0 * dp * n.x;
    out.y -= 2.0 * dp * n.y;
    out.z -= 2.0 * dp * n.z;
  }
  flatten_2d(out, dim);
  normalize(out);
  return out;
}

// Reflection dispatch shared by the disk and triangle loops: 0 = diffuse,
// 1 = specular, 2 = coned-cosine (with the reference's <=0 / >=pi/2 limit
// resolution, rayReflection.hpp:59-63).
V3 reflect_dir(int refl_kind, const V3 &d, const V3 &n, double cone_angle,
               int dim, Rng &rng) {
  if (refl_kind == 1)
    return specular_dir(d, n);
  if (refl_kind == 2) {
    if (cone_angle <= 0.0)
      return specular_dir(d, n);
    if (cone_angle >= M_PI_2)
      return diffuse_dir(n, dim, rng);
    return coned_dir(d, n, cone_angle, dim, rng);
  }
  return diffuse_dir(n, dim, rng);
}

struct Counters {
  int64_t total_traces = 0;
  int64_t non_geo = 0;
  int64_t geo = 0;
  int64_t boundary = 0;
  int64_t reflections = 0;
  int64_t terminated = 0;
  int64_t scattered = 0;
};

} // namespace

extern "C" {

// Trace `num_rays` rays over an oriented-disk cloud; accumulates raw flux
// (pre-normalization deposit weights) per prim into flux_out. Returns 0.
//
// bbox_raw is the UNadjusted geometry bounding box (2x3 row-major); the
// source-side extension by 2*disk_radius and the 2D z-pad happen here
// (ref: rayUtil.hpp:104-143).
int64_t vro_trace_disks(
    const double *points, const double *normals, const double *radii,
    const double *sticking_per_prim, int64_t n, int32_t dim,
    const double *bbox_raw, int32_t ray_axis, int32_t first_dir,
    int32_t second_dir, int32_t min_max, double pos_neg, int32_t bc1,
    int32_t bc2, int64_t num_rays, double cosine_exponent, int32_t refl_kind,
    double cone_angle, double disk_radius, uint64_t seed,
    int64_t max_boundary_hits, int64_t max_reflections, double tnear,
    int32_t use_wdist, double mean_free_path, double *flux_out,
    int64_t *counters_out) {
  // ---- adjusted bounding box (ref: rayUtil.hpp:104-143) ----
  double lo[3] = {bbox_raw[0], bbox_raw[1], bbox_raw[2]};
  double hi[3] = {bbox_raw[3], bbox_raw[4], bbox_raw[5]};
  if (dim == 2) {
    lo[2] -= disk_radius;
    hi[2] += disk_radius;
  }
  if (min_max == 1)
    hi[ray_axis] += 2.0 * disk_radius;
  else
    lo[ray_axis] -= 2.0 * disk_radius;

  // ---- neighborhood: all pairs with ||ci-cj|| <= 2*disk_radius ----
  // (ref: rayGeometryDisk.hpp:97-98 radius, rayPointNeighborhood.hpp:286-297
  // inclusive predicate). Brute force with an axis prefilter.
  const double nb_r = 2.0 * disk_radius;
  const double nb_r2 = nb_r * nb_r;
  std::vector<std::vector<uint32_t>> neighbors(n);
  {
    std::vector<uint32_t> order(n);
    for (int64_t i = 0; i < n; ++i)
      order[i] = (uint32_t)i;
    std::sort(order.begin(), order.end(), [&](uint32_t a, uint32_t b) {
      return points[3 * a] < points[3 * b];
    });
    for (int64_t oi = 0; oi < n; ++oi) {
      uint32_t i = order[oi];
      for (int64_t oj = oi + 1; oj < n; ++oj) {
        uint32_t j = order[oj];
        if (points[3 * j] - points[3 * i] > nb_r)
          break;
        double dx = points[3 * i] - points[3 * j];
        double dy = points[3 * i + 1] - points[3 * j + 1];
        double dz = points[3 * i + 2] - points[3 * j + 2];
        if (std::abs(dy) > nb_r || std::abs(dz) > nb_r)
          continue;
        if (dx * dx + dy * dy + dz * dz <= nb_r2) {
          neighbors[i].push_back(j);
          neighbors[j].push_back(i);
        }
      }
    }
  }

  Counters C;
  std::uniform_real_distribution<double> uni(0.0, 1.0);
  const double ee = 1.0 / (cosine_exponent + 1.0);
  const double lo1 = lo[first_dir], hi1 = hi[first_dir];
  const double lo2 = lo[second_dir], hi2 = hi[second_dir];
  const double lo_r = lo[ray_axis], hi_r = hi[ray_axis];

  std::vector<double> flux(n, 0.0);
  std::vector<uint32_t> hit_ids;
  std::vector<double> hit_dists;

  for (int64_t idx = 0; idx < num_rays; ++idx) {
    // independent per-ray stream (tea<3>(idx, seed) analog,
    // rayTraceKernel.hpp:120-121) — splitmix-style mix of (idx, seed)
    uint64_t s = (uint64_t)idx * 0x9E3779B97F4A7C15ull + seed;
    Rng rng(s ^ (s >> 31));

    double w0 = 1.0;
    double w = w0;
    int64_t n_refl = 0;
    int64_t n_bdry = 0;
    bool hit_from_back = false;

    // ---- source sample (ref: raySourceRandom.hpp:50-86) ----
    V3 org{0, 0, 0};
    comp(org, ray_axis) = (min_max == 1) ? hi[ray_axis] : lo[ray_axis];
    comp(org, first_dir) = lo1 + (hi1 - lo1) * uni(rng);
    if (dim == 3)
      comp(org, second_dir) = lo2 + (hi2 - lo2) * uni(rng);

    double r1 = uni(rng);
    double r2 = uni(rng);
    double cos_t = std::pow(r2, ee);
    double sin_t = std::sqrt(1.0 - cos_t * cos_t);
    V3 dir{0, 0, 0};
    comp(dir, ray_axis) = pos_neg * cos_t;
    comp(dir, first_dir) = std::cos(2.0 * M_PI * r1) * sin_t;
    comp(dir, second_dir) = std::sin(2.0 * M_PI * r1) * sin_t;
    flatten_2d(dir, dim);

    // ---- bounce loop (ref: rayTraceKernel.hpp:155-341) ----
    bool reflect = true;
    while (reflect) {
      ++C.total_traces;

      // nearest disk hit, brute force over all prims (the Embree
      // rtcIntersect1 contract: closest hit, either facing, t >= tnear)
      double t_best = 1e300;
      int64_t prim_best = -1;
      for (int64_t p = 0; p < n; ++p) {
        V3 c{points[3 * p], points[3 * p + 1], points[3 * p + 2]};
        V3 nn{normals[3 * p], normals[3 * p + 1], normals[3 * p + 2]};
        double denom = dot(dir, nn);
        if (denom == 0.0)
          continue;
        double t = (dot(c, nn) - dot(org, nn)) / denom;
        if (t < tnear || t >= t_best)
          continue;
        V3 h = scale_add(org, dir, t);
        V3 dvec = sub(h, c);
        if (dot(dvec, dvec) < radii[p] * radii[p]) {
          t_best = t;
          prim_best = p;
        }
      }

      // wall crossings: finite rectangles on the lateral axes
      // (ref: rayBoundary.hpp:164-245 builds them over the adjusted bbox)
      double t_wall = 1e300;
      int wall_axis = -1;
      int lat_axes[2] = {first_dir, second_dir};
      int n_lat = (dim == 3) ? 2 : 1;
      for (int a = 0; a < n_lat; ++a) {
        int axis = lat_axes[a];
        double d_ax = comp(dir, axis);
        if (d_ax == 0.0)
          continue;
        double face = d_ax > 0.0 ? hi[axis] : lo[axis];
        double t = (face - comp(org, axis)) / d_ax;
        if (t < tnear || t >= t_wall)
          continue;
        double hp_r = comp(org, ray_axis) + comp(dir, ray_axis) * t;
        if (hp_r < lo_r || hp_r > hi_r)
          continue;
        if (dim == 3) {
          int other = lat_axes[1 - a];
          double hp_o = comp(org, other) + comp(dir, other) * t;
          if (hp_o < lo[other] || hp_o > hi[other])
            continue;
        }
        t_wall = t;
        wall_axis = axis;
      }

      bool wall_event = wall_axis >= 0 && t_wall < t_best;
      double t_ev = wall_event ? t_wall : t_best;

      // ---- miss: escape through the source-axis faces ----
      if (prim_best < 0 && wall_axis < 0) {
        ++C.non_geo;
        break;
      }

      // ---- gas-phase scattering (ref: rayTraceKernel.hpp:179-203) ----
      if (mean_free_path > 0.0) {
        double p_scat = 1.0 - std::exp(-t_ev / mean_free_path);
        double rnd = uni(rng);
        if (rnd < p_scat) {
          // the reference advances the origin by the DRAW itself
          org = scale_add(org, dir, rnd);
          dir = unit_sphere(rng);
          flatten_2d(dir, dim);
          ++C.scattered;
          continue;
        }
      }

      if (wall_event) {
        // ---- boundary hit (ref: rayBoundary.hpp:29-127) ----
        if (++n_bdry > max_boundary_hits) {
          ++C.terminated;
          break;
        }
        int bc = (wall_axis == first_dir) ? bc1 : bc2;
        V3 hp = scale_add(org, dir, t_wall);
        if (bc == 0) { // reflective: specular flip of that axis
          org = hp;
          comp(dir, wall_axis) = -comp(dir, wall_axis);
        } else if (bc == 1) { // periodic: teleport to the opposite face
          comp(hp, wall_axis) =
              comp(dir, wall_axis) > 0.0 ? lo[wall_axis] : hi[wall_axis];
          org = hp;
        } else { // ignore: terminate
          break;
        }
        continue;
      }

      // ---- disk hit ----
      V3 hp = scale_add(org, dir, t_best);
      V3 n_hit{normals[3 * prim_best], normals[3 * prim_best + 1],
               normals[3 * prim_best + 2]};
      bool backface = dot(dir, n_hit) > 0.0;
      if (backface) {
        // first back hit passes through, second kills
        // (ref: rayTraceKernel.hpp:225-241)
        if (hit_from_back) {
          ++C.terminated;
          break;
        }
        hit_from_back = true;
        org = hp;
        continue;
      }

      ++C.geo;

      // ---- neighbor multi-hit (ref: rayTraceKernel.hpp:255-300) ----
      hit_ids.clear();
      hit_dists.clear();
      hit_ids.push_back((uint32_t)prim_best);
      if (use_wdist) {
        V3 c0{points[3 * prim_best], points[3 * prim_best + 1],
              points[3 * prim_best + 2]};
        hit_dists.push_back(norm(sub(hp, c0)) + 1e-6);
      }
      for (uint32_t j : neighbors[prim_best]) {
        // checkLocalIntersection (ref: rayTraceKernel.hpp:462-507)
        V3 nn{normals[3 * j], normals[3 * j + 1], normals[3 * j + 2]};
        double prod = dot(nn, dir);
        if (prod > 0.0 || std::abs(prod) < 1e-6)
          continue;
        V3 c{points[3 * j], points[3 * j + 1], points[3 * j + 2]};
        double tt = (dot(c, nn) - dot(org, nn)) / prod;
        if (tt <= 0.0)
          continue;
        V3 h = scale_add(org, dir, tt);
        double dist = norm(sub(h, c));
        if (dist < radii[j]) {
          hit_ids.push_back(j);
          if (use_wdist)
            hit_dists.push_back(dist + 1e-6);
        }
      }
      if (use_wdist) {
        double inv_sum = 0.0;
        for (double d : hit_dists)
          inv_sum += 1.0 / d;
        for (size_t k = 0; k < hit_ids.size(); ++k)
          flux[hit_ids[k]] +=
              w / hit_dists[k] / inv_sum * (double)hit_ids.size();
      } else {
        for (uint32_t id : hit_ids)
          flux[id] += w;
      }

      // ---- sticking + reflection (ref: rayTraceKernel.hpp:309-335) ----
      double s_p = sticking_per_prim[prim_best];
      w -= w * s_p;
      if (w <= 0.0)
        break;
      if (++n_refl > max_reflections) {
        ++C.terminated;
        break;
      }
      // rejectionControl (ref: rayTraceKernel.hpp:435-460)
      if (w < 0.1 * w0) {
        double kill_p = 1.0 - w / (0.3 * w0);
        if (uni(rng) < kill_p)
          break;
        w = 0.3 * w0;
      }

      dir = reflect_dir(refl_kind, dir, n_hit, cone_angle, dim, rng);
      flatten_2d(dir, dim);
      org = hp;
    }
    C.boundary += n_bdry;
    C.reflections += n_refl;
  }

  for (int64_t i = 0; i < n; ++i)
    flux_out[i] = flux[i];
  counters_out[0] = C.total_traces;
  counters_out[1] = C.non_geo;
  counters_out[2] = C.geo;
  counters_out[3] = C.boundary;
  counters_out[4] = C.reflections;
  counters_out[5] = C.terminated;
  counters_out[6] = C.scattered;
  counters_out[7] = 0;
  return 0;
}

// Trace `num_rays` rays over a triangle mesh: the triangle-kernel semantics
// (single closest-hit deposit, rayTraceKernel.hpp:301-307; backface hits
// KILL the ray, :243-248; Moller-Trumbore double-sided nearest hit like
// Embree's built-in triangle test). Normals follow the mesh convention
// normalize(cross(v1-v0, v2-v0)) (rayGeometryTriangle.hpp:57-75). The
// source-axis bbox extension uses 2*grid_delta (the triangle tracer's
// discWidth analog, rayUtil.hpp:104-143 with gridDelta).
int64_t vro_trace_tris(
    const double *vertices, const int64_t *tris, int64_t n_tris,
    const double *sticking_per_prim, int32_t dim, const double *bbox_raw,
    int32_t ray_axis, int32_t first_dir, int32_t second_dir, int32_t min_max,
    double pos_neg, int32_t bc1, int32_t bc2, int64_t num_rays,
    double cosine_exponent, int32_t refl_kind, double cone_angle,
    double grid_delta, uint64_t seed, int64_t max_boundary_hits,
    int64_t max_reflections, double tnear, double mean_free_path,
    double *flux_out, int64_t *counters_out) {
  double lo[3] = {bbox_raw[0], bbox_raw[1], bbox_raw[2]};
  double hi[3] = {bbox_raw[3], bbox_raw[4], bbox_raw[5]};
  if (dim == 2) {
    lo[2] -= grid_delta;
    hi[2] += grid_delta;
  }
  if (min_max == 1)
    hi[ray_axis] += 2.0 * grid_delta;
  else
    lo[ray_axis] -= 2.0 * grid_delta;

  // precompute v0 / edges / stored normals per triangle
  std::vector<V3> tv0(n_tris), te1(n_tris), te2(n_tris), tnrm(n_tris);
  for (int64_t p = 0; p < n_tris; ++p) {
    const double *a = vertices + 3 * tris[3 * p];
    const double *b = vertices + 3 * tris[3 * p + 1];
    const double *c = vertices + 3 * tris[3 * p + 2];
    V3 v0{a[0], a[1], a[2]};
    V3 e1{b[0] - a[0], b[1] - a[1], b[2] - a[2]};
    V3 e2{c[0] - a[0], c[1] - a[1], c[2] - a[2]};
    V3 nn{e1.y * e2.z - e1.z * e2.y, e1.z * e2.x - e1.x * e2.z,
          e1.x * e2.y - e1.y * e2.x};
    normalize(nn);
    tv0[p] = v0;
    te1[p] = e1;
    te2[p] = e2;
    tnrm[p] = nn;
  }

  Counters C;
  std::uniform_real_distribution<double> uni(0.0, 1.0);
  const double ee = 1.0 / (cosine_exponent + 1.0);
  const double lo1 = lo[first_dir], hi1 = hi[first_dir];
  const double lo2 = lo[second_dir], hi2 = hi[second_dir];
  const double lo_r = lo[ray_axis], hi_r = hi[ray_axis];
  std::vector<double> flux(n_tris, 0.0);

  for (int64_t idx = 0; idx < num_rays; ++idx) {
    uint64_t s = (uint64_t)idx * 0x9E3779B97F4A7C15ull + seed;
    Rng rng(s ^ (s >> 31));

    double w0 = 1.0;
    double w = w0;
    int64_t n_refl = 0;
    int64_t n_bdry = 0;

    V3 org{0, 0, 0};
    comp(org, ray_axis) = (min_max == 1) ? hi[ray_axis] : lo[ray_axis];
    comp(org, first_dir) = lo1 + (hi1 - lo1) * uni(rng);
    if (dim == 3)
      comp(org, second_dir) = lo2 + (hi2 - lo2) * uni(rng);

    double r1 = uni(rng);
    double r2 = uni(rng);
    double cos_t = std::pow(r2, ee);
    double sin_t = std::sqrt(1.0 - cos_t * cos_t);
    V3 dir{0, 0, 0};
    comp(dir, ray_axis) = pos_neg * cos_t;
    comp(dir, first_dir) = std::cos(2.0 * M_PI * r1) * sin_t;
    comp(dir, second_dir) = std::sin(2.0 * M_PI * r1) * sin_t;
    flatten_2d(dir, dim);

    bool reflect = true;
    while (reflect) {
      ++C.total_traces;

      // nearest triangle hit (Moller-Trumbore, double-sided)
      double t_best = 1e300;
      int64_t prim_best = -1;
      for (int64_t p = 0; p < n_tris; ++p) {
        const V3 &e1 = te1[p], &e2 = te2[p];
        V3 h{dir.y * e2.z - dir.z * e2.y, dir.z * e2.x - dir.x * e2.z,
             dir.x * e2.y - dir.y * e2.x};
        double det = dot(h, e1);
        if (std::abs(det) < 1e-12)
          continue;
        V3 sv = sub(org, tv0[p]);
        double u = dot(sv, h) / det;
        if (u < 0.0 || u > 1.0)
          continue;
        V3 q{sv.y * e1.z - sv.z * e1.y, sv.z * e1.x - sv.x * e1.z,
             sv.x * e1.y - sv.y * e1.x};
        double v = dot(q, dir) / det;
        if (v < 0.0 || u + v > 1.0)
          continue;
        double t = dot(q, e2) / det;
        if (t < tnear || t >= t_best)
          continue;
        t_best = t;
        prim_best = p;
      }

      // wall crossings (identical to the disk loop)
      double t_wall = 1e300;
      int wall_axis = -1;
      int lat_axes[2] = {first_dir, second_dir};
      int n_lat = (dim == 3) ? 2 : 1;
      for (int a = 0; a < n_lat; ++a) {
        int axis = lat_axes[a];
        double d_ax = comp(dir, axis);
        if (d_ax == 0.0)
          continue;
        double face = d_ax > 0.0 ? hi[axis] : lo[axis];
        double t = (face - comp(org, axis)) / d_ax;
        if (t < tnear || t >= t_wall)
          continue;
        double hp_r = comp(org, ray_axis) + comp(dir, ray_axis) * t;
        if (hp_r < lo_r || hp_r > hi_r)
          continue;
        if (dim == 3) {
          int other = lat_axes[1 - a];
          double hp_o = comp(org, other) + comp(dir, other) * t;
          if (hp_o < lo[other] || hp_o > hi[other])
            continue;
        }
        t_wall = t;
        wall_axis = axis;
      }

      bool wall_event = wall_axis >= 0 && t_wall < t_best;
      double t_ev = wall_event ? t_wall : t_best;

      if (prim_best < 0 && wall_axis < 0) {
        ++C.non_geo;
        break;
      }

      if (mean_free_path > 0.0) {
        double p_scat = 1.0 - std::exp(-t_ev / mean_free_path);
        double rnd = uni(rng);
        if (rnd < p_scat) {
          org = scale_add(org, dir, rnd);
          dir = unit_sphere(rng);
          flatten_2d(dir, dim);
          ++C.scattered;
          continue;
        }
      }

      if (wall_event) {
        if (++n_bdry > max_boundary_hits) {
          ++C.terminated;
          break;
        }
        int bc = (wall_axis == first_dir) ? bc1 : bc2;
        V3 hp = scale_add(org, dir, t_wall);
        if (bc == 0) {
          org = hp;
          comp(dir, wall_axis) = -comp(dir, wall_axis);
        } else if (bc == 1) {
          comp(hp, wall_axis) =
              comp(dir, wall_axis) > 0.0 ? lo[wall_axis] : hi[wall_axis];
          org = hp;
        } else {
          break;
        }
        continue;
      }

      // ---- triangle hit: backface KILLS (rayTraceKernel.hpp:243-248) ----
      V3 hp = scale_add(org, dir, t_best);
      const V3 &n_hit = tnrm[prim_best];
      if (dot(dir, n_hit) > 0.0) {
        ++C.terminated;
        break;
      }

      ++C.geo;
      flux[prim_best] += w; // single surfaceCollision (:301-307)

      double s_p = sticking_per_prim[prim_best];
      w -= w * s_p;
      if (w <= 0.0)
        break;
      if (++n_refl > max_reflections) {
        ++C.terminated;
        break;
      }
      if (w < 0.1 * w0) {
        double kill_p = 1.0 - w / (0.3 * w0);
        if (uni(rng) < kill_p)
          break;
        w = 0.3 * w0;
      }

      dir = reflect_dir(refl_kind, dir, n_hit, cone_angle, dim, rng);
      flatten_2d(dir, dim);
      org = hp;
    }
    C.boundary += n_bdry;
    C.reflections += n_refl;
  }

  for (int64_t i = 0; i < n_tris; ++i)
    flux_out[i] = flux[i];
  counters_out[0] = C.total_traces;
  counters_out[1] = C.non_geo;
  counters_out[2] = C.geo;
  counters_out[3] = C.boundary;
  counters_out[4] = C.reflections;
  counters_out[5] = C.terminated;
  counters_out[6] = C.scattered;
  counters_out[7] = 0;
  return 0;
}

} // extern "C"
