// Native BVH construction — the host-side "compiler" hot loop.
//
// The reference builds its BVH in browser JavaScript (lib/BVH/bvhNode.js:
// recursive median split :28-73, iterative binned SAH :108-283) and logs
// 438-4483 ms for 69k-298k triangle meshes (benchmarks.txt).  This is the
// native equivalent: same tree semantics, C++ speed.  Host code, built with
// g++; the same source as tpu_path_tracer/accel/bvh_native.cpp.
// Exposed via a C ABI consumed with ctypes (accel/native.py) — no pybind11
// dependency.
//
// Output layout matches accel/bvh.py's FlatBVHArrays: DFS-preorder nodes
// (left child == i+1), skip pointers miss[i] = i + subtree_size (sentinel =
// node_count), and a primitive permutation `order`.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Out {
  float* node_mins;       // [cap*3]
  float* node_maxs;       // [cap*3]
  int32_t* right;         // [cap]
  int32_t* prim_start;    // [cap]
  int32_t* prim_count;    // [cap]
  int32_t* miss;          // [cap] (filled at the end)
  int32_t* axis;          // [cap]
  int64_t* subtree;       // scratch [cap]
  int64_t count = 0;
};

struct Prims {
  const float* mins;  // [n*3]
  const float* maxs;  // [n*3]
  std::vector<double> cent;  // [n*3]
  int64_t* order;            // [n], permuted in place
};

inline void box_reset(double lo[3], double hi[3]) {
  for (int k = 0; k < 3; ++k) { lo[k] = 1e30; hi[k] = -1e30; }
}

inline void box_grow(double lo[3], double hi[3], const float* pmin,
                     const float* pmax, int64_t i) {
  for (int k = 0; k < 3; ++k) {
    lo[k] = std::min(lo[k], (double)pmin[i * 3 + k]);
    hi[k] = std::max(hi[k], (double)pmax[i * 3 + k]);
  }
}

inline double surface_area(const double lo[3], const double hi[3]) {
  double e0 = hi[0] - lo[0], e1 = hi[1] - lo[1], e2 = hi[2] - lo[2];
  if (e0 < 0 || e1 < 0 || e2 < 0) return 0.0;
  return 2.0 * (e0 * e1 + e1 * e2 + e2 * e0);
}

int64_t emit(Out& out) { return out.count++; }

void fill_leaf(Out& out, const Prims& p, int64_t node, int64_t start,
               int64_t end) {
  double lo[3], hi[3];
  box_reset(lo, hi);
  for (int64_t i = start; i <= end; ++i) box_grow(lo, hi, p.mins, p.maxs, p.order[i]);
  for (int k = 0; k < 3; ++k) {
    out.node_mins[node * 3 + k] = (float)lo[k];
    out.node_maxs[node * 3 + k] = (float)hi[k];
  }
  out.right[node] = -1;
  out.prim_start[node] = (int32_t)start;
  out.prim_count[node] = (int32_t)(end - start + 1);
  out.axis[node] = 0;
  out.subtree[node] = 1;
}

void fill_interior(Out& out, int64_t node, int64_t right_id, int ax,
                   int64_t left_size, int64_t right_size) {
  for (int k = 0; k < 3; ++k) {
    out.node_mins[node * 3 + k] = std::min(out.node_mins[(node + 1) * 3 + k],
                                           out.node_mins[right_id * 3 + k]);
    out.node_maxs[node * 3 + k] = std::max(out.node_maxs[(node + 1) * 3 + k],
                                           out.node_maxs[right_id * 3 + k]);
  }
  out.right[node] = (int32_t)right_id;
  out.prim_start[node] = -1;
  out.prim_count[node] = 0;
  out.axis[node] = ax;
  out.subtree[node] = 1 + left_size + right_size;
}

// ---------------- median (longest axis, sort by aabb-min) ----------------

int64_t build_median_rec(Out& out, Prims& p, int64_t start, int64_t end,
                         int64_t leaf_size) {
  int64_t node = emit(out);
  if (end - start + 1 <= leaf_size) {
    fill_leaf(out, p, node, start, end);
    return 1;
  }
  double lo[3], hi[3];
  box_reset(lo, hi);
  for (int64_t i = start; i <= end; ++i) box_grow(lo, hi, p.mins, p.maxs, p.order[i]);
  int ax = 0;
  if (hi[1] - lo[1] > hi[0] - lo[0]) ax = 1;
  if (hi[2] - lo[2] > hi[ax] - lo[ax]) ax = 2;
  // The reference fully sorts the subrange (bvhNode.js:57-60); a median
  // split only needs nth_element — same resulting partition semantics
  // (bbox-min key), O(n) per level.
  int64_t mid = start + (end - start) / 2;
  const float* key = p.mins;
  std::nth_element(p.order + start, p.order + mid, p.order + end + 1,
                   [key, ax](int64_t a, int64_t b) {
                     return key[a * 3 + ax] < key[b * 3 + ax];
                   });
  int64_t left = build_median_rec(out, p, start, mid, leaf_size);
  int64_t right_id = node + 1 + left;
  int64_t right = build_median_rec(out, p, mid + 1, end, leaf_size);
  fill_interior(out, node, right_id, ax, left, right);
  return 1 + left + right;
}

// ---------------- binned SAH (8 bins, 7 planes) ----------------

constexpr int kBins = 8;

int64_t build_sah_rec(Out& out, Prims& p, int64_t start, int64_t end,
                      int64_t max_leaf) {
  int64_t node = emit(out);
  int64_t count = end - start + 1;
  double lo[3], hi[3];
  box_reset(lo, hi);
  for (int64_t i = start; i <= end; ++i) box_grow(lo, hi, p.mins, p.maxs, p.order[i]);
  double parent_cost = (double)count * surface_area(lo, hi);

  // FindBestSplitPlane (bvhNode.js:222-283).
  double best_cost = 1e30, best_pos = 0.0;
  int best_axis = -1;
  if (count > 1) {
    for (int a = 0; a < 3; ++a) {
      double cmin = 1e30, cmax = -1e30;
      for (int64_t i = start; i <= end; ++i) {
        double c = p.cent[p.order[i] * 3 + a];
        cmin = std::min(cmin, c);
        cmax = std::max(cmax, c);
      }
      if (cmin == cmax) continue;
      double blo[kBins][3], bhi[kBins][3];
      int64_t bcount[kBins] = {0};
      for (int b = 0; b < kBins; ++b) box_reset(blo[b], bhi[b]);
      double scale = kBins / (cmax - cmin);
      for (int64_t i = start; i <= end; ++i) {
        int64_t idx = p.order[i];
        int b = std::min((int64_t)(kBins - 1),
                         (int64_t)((p.cent[idx * 3 + a] - cmin) * scale));
        bcount[b]++;
        box_grow(blo[b], bhi[b], p.mins, p.maxs, idx);
      }
      double llo[3], lhi[3], rlo[3], rhi[3];
      double larea[kBins - 1], rarea[kBins - 1];
      int64_t lcnt[kBins - 1], rcnt[kBins - 1];
      box_reset(llo, lhi);
      box_reset(rlo, rhi);
      int64_t lsum = 0, rsum = 0;
      for (int b = 0; b < kBins - 1; ++b) {
        lsum += bcount[b];
        lcnt[b] = lsum;
        for (int k = 0; k < 3; ++k) {
          llo[k] = std::min(llo[k], blo[b][k]);
          lhi[k] = std::max(lhi[k], bhi[b][k]);
        }
        larea[b] = lsum ? surface_area(llo, lhi) : 0.0;
        int rb = kBins - 1 - b;
        rsum += bcount[rb];
        rcnt[kBins - 2 - b] = rsum;
        for (int k = 0; k < 3; ++k) {
          rlo[k] = std::min(rlo[k], blo[rb][k]);
          rhi[k] = std::max(rhi[k], bhi[rb][k]);
        }
        rarea[kBins - 2 - b] = rsum ? surface_area(rlo, rhi) : 0.0;
      }
      double step = (cmax - cmin) / kBins;
      for (int b = 0; b < kBins - 1; ++b) {
        double cost = (double)lcnt[b] * larea[b] + (double)rcnt[b] * rarea[b];
        if (cost > 0 && cost < best_cost) {
          best_cost = cost;
          best_axis = a;
          best_pos = cmin + step * (b + 1);
        }
      }
    }
  }

  // Leaf when splitting stops paying (bvhNode.js:145-152), unless the leaf
  // would exceed the traversal's static bound.
  if (best_axis < 0 || (best_cost >= parent_cost && count <= max_leaf) ||
      count == 1) {
    fill_leaf(out, p, node, start, end);
    return 1;
  }

  const double* cent = p.cent.data();
  int ba = best_axis;
  int64_t* split_it = std::partition(
      p.order + start, p.order + end + 1,
      [cent, ba, best_pos](int64_t i) { return cent[i * 3 + ba] <= best_pos; });
  int64_t split = split_it - (p.order + start);
  if (split < 1) split = 1;
  if (split > count - 1) split = count - 1;
  int64_t mid = start + split - 1;

  int64_t left = build_sah_rec(out, p, start, mid, max_leaf);
  int64_t right_id = node + 1 + left;
  int64_t right = build_sah_rec(out, p, mid + 1, end, max_leaf);
  fill_interior(out, node, right_id, ba, left, right);
  return 1 + left + right;
}

// ---------------- LBVH (Morton order + range median) ----------------

inline uint64_t expand10(uint64_t v) {
  v = (v | (v << 16)) & 0x030000FFull;
  v = (v | (v << 8)) & 0x0300F00Full;
  v = (v | (v << 4)) & 0x030C30C3ull;
  v = (v | (v << 2)) & 0x09249249ull;
  return v;
}

int64_t build_lbvh_rec(Out& out, Prims& p, int64_t start, int64_t end,
                       int64_t leaf_size) {
  int64_t node = emit(out);
  int64_t count = end - start + 1;
  if (count <= leaf_size) {
    fill_leaf(out, p, node, start, end);
    return 1;
  }
  double lo[3], hi[3];
  box_reset(lo, hi);
  for (int64_t i = start; i <= end; ++i) box_grow(lo, hi, p.mins, p.maxs, p.order[i]);
  int ax = 0;
  if (hi[1] - lo[1] > hi[0] - lo[0]) ax = 1;
  if (hi[2] - lo[2] > hi[ax] - lo[ax]) ax = 2;
  int64_t mid = start + count / 2 - 1;
  int64_t left = build_lbvh_rec(out, p, start, mid, leaf_size);
  int64_t right_id = node + 1 + left;
  int64_t right = build_lbvh_rec(out, p, mid + 1, end, leaf_size);
  fill_interior(out, node, right_id, ax, left, right);
  return 1 + left + right;
}

void finish(Out& out) {
  for (int64_t i = 0; i < out.count; ++i) {
    int64_t m = i + out.subtree[i];
    out.miss[i] = (int32_t)std::min(m, out.count);
  }
}

Prims make_prims(int64_t n, const float* mins, const float* maxs,
                 int64_t* order) {
  Prims p{mins, maxs, {}, order};
  p.cent.resize(n * 3);
  for (int64_t i = 0; i < n; ++i)
    for (int k = 0; k < 3; ++k)
      p.cent[i * 3 + k] = 0.5 * ((double)mins[i * 3 + k] + maxs[i * 3 + k]);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  return p;
}

}  // namespace

extern "C" {

int64_t tpt_bvh_build(const char* method, int64_t n, const float* mins,
                      const float* maxs, int64_t leaf_param,
                      float* node_mins, float* node_maxs, int32_t* right,
                      int32_t* prim_start, int32_t* prim_count, int32_t* miss,
                      int32_t* axis, int64_t* order, int64_t* scratch) {
  if (n <= 0) return 0;
  Prims p = make_prims(n, mins, maxs, order);
  Out out{node_mins, node_maxs, right, prim_start, prim_count, miss, axis,
          scratch, 0};
  if (std::strcmp(method, "median") == 0) {
    build_median_rec(out, p, 0, n - 1, std::max<int64_t>(leaf_param, 1));
  } else if (std::strcmp(method, "sah") == 0) {
    build_sah_rec(out, p, 0, n - 1, std::max<int64_t>(leaf_param, 1));
  } else if (std::strcmp(method, "lbvh") == 0) {
    // Morton sort once, then range-median recursion.
    double lo[3] = {1e30, 1e30, 1e30}, hi[3] = {-1e30, -1e30, -1e30};
    for (int64_t i = 0; i < n; ++i)
      for (int k = 0; k < 3; ++k) {
        lo[k] = std::min(lo[k], p.cent[i * 3 + k]);
        hi[k] = std::max(hi[k], p.cent[i * 3 + k]);
      }
    std::vector<uint64_t> code(n);
    for (int64_t i = 0; i < n; ++i) {
      uint64_t q[3];
      for (int k = 0; k < 3; ++k) {
        double ext = hi[k] - lo[k];
        double t = ext > 0 ? (p.cent[i * 3 + k] - lo[k]) / ext : 0.0;
        q[k] = (uint64_t)std::min(1023.0, std::max(0.0, t * 1023.0));
      }
      code[i] = (expand10(q[0]) << 2) | (expand10(q[1]) << 1) | expand10(q[2]);
    }
    std::sort(order, order + n,
              [&code](int64_t a, int64_t b) { return code[a] < code[b]; });
    build_lbvh_rec(out, p, 0, n - 1, std::max<int64_t>(leaf_param, 1));
  } else {
    return -1;
  }
  finish(out);
  return out.count;
}

// Minimal OBJ de-indexer for big meshes (objReader.js:21-68 semantics,
// v/vn/f with v//vn and v/vt/vn encodings, n-gon fan triangulation).
// Two-pass: call with counts_only=1 to size buffers, then fill.
int64_t tpt_obj_parse(const char* text, int64_t len, int counts_only,
                      float* out_verts, float* out_norms) {
  std::vector<float> vx, vy, vz, nx, ny, nz;
  int64_t tri_corners = 0;
  const char* s = text;
  const char* end = text + len;

  auto skip_ws = [&](const char*& c) {
    while (c < end && (*c == ' ' || *c == '\t' || *c == '\r')) ++c;
  };
  auto parse_float = [&](const char*& c) {
    char* e;
    float v = std::strtof(c, &e);
    c = e;
    return v;
  };

  std::vector<int64_t> fv, fn;
  while (s < end) {
    skip_ws(s);
    if (s + 1 < end && s[0] == 'v' && s[1] == ' ') {
      s += 2;
      float a = parse_float(s), b = parse_float(s), c = parse_float(s);
      vx.push_back(a); vy.push_back(b); vz.push_back(c);
    } else if (s + 2 < end && s[0] == 'v' && s[1] == 'n' && s[2] == ' ') {
      s += 3;
      float a = parse_float(s), b = parse_float(s), c = parse_float(s);
      nx.push_back(a); ny.push_back(b); nz.push_back(c);
    } else if (s + 1 < end && s[0] == 'f' && (s[1] == ' ' || s[1] == '\t')) {
      s += 2;
      fv.clear();
      fn.clear();
      while (s < end && *s != '\n') {
        skip_ws(s);
        if (s >= end || *s == '\n') break;
        char* e;
        long vi = std::strtol(s, &e, 10);
        if (e == s) break;
        s = e;
        long ni = 0;
        if (s < end && *s == '/') {
          ++s;
          if (s < end && *s != '/') { ni = std::strtol(s, &e, 10); s = e; ni = 0; }
          if (s < end && *s == '/') {
            ++s;
            ni = std::strtol(s, &e, 10);
            s = e;
          }
        }
        fv.push_back(vi);
        fn.push_back(ni);
      }
      for (size_t k = 1; k + 1 < fv.size(); ++k) {
        int64_t tri_v[3] = {fv[0], fv[k], fv[k + 1]};
        int64_t tri_n[3] = {fn[0], fn[k], fn[k + 1]};
        float px[3], py[3], pz[3];
        for (int c3 = 0; c3 < 3; ++c3) {
          int64_t vi = tri_v[c3] > 0 ? tri_v[c3] - 1
                                     : (int64_t)vx.size() + tri_v[c3];
          px[c3] = vx[vi]; py[c3] = vy[vi]; pz[c3] = vz[vi];
        }
        // Geometric normal fallback for corners without vn.
        float ux = px[1] - px[0], uy = py[1] - py[0], uz = pz[1] - pz[0];
        float wx = px[2] - px[0], wy = py[2] - py[0], wz = pz[2] - pz[0];
        float gx = uy * wz - uz * wy, gy = uz * wx - ux * wz,
              gz = ux * wy - uy * wx;
        float gl = std::sqrt(gx * gx + gy * gy + gz * gz);
        if (gl > 0) { gx /= gl; gy /= gl; gz /= gl; }
        for (int c3 = 0; c3 < 3; ++c3) {
          if (!counts_only) {
            out_verts[tri_corners * 3 + 0] = px[c3];
            out_verts[tri_corners * 3 + 1] = py[c3];
            out_verts[tri_corners * 3 + 2] = pz[c3];
            if (tri_n[c3] != 0) {
              int64_t ni2 = tri_n[c3] > 0 ? tri_n[c3] - 1
                                          : (int64_t)nx.size() + tri_n[c3];
              out_norms[tri_corners * 3 + 0] = nx[ni2];
              out_norms[tri_corners * 3 + 1] = ny[ni2];
              out_norms[tri_corners * 3 + 2] = nz[ni2];
            } else {
              out_norms[tri_corners * 3 + 0] = gx;
              out_norms[tri_corners * 3 + 1] = gy;
              out_norms[tri_corners * 3 + 2] = gz;
            }
          }
          ++tri_corners;
        }
      }
    }
    while (s < end && *s != '\n') ++s;
    ++s;
  }
  return tri_corners;
}

}  // extern "C"
