// The BVH walk: one ray's closest triangle hit through the packed BVH.
//
// Shared by the traversal kernel (traversal.cu bvh_stack_walk_kernel, the
// wavefront's triangle search) and the forward megakernel's hit search
// over a BVH scene (megakernel_fwd.cu megakernel_fwd_bvh_kernel, through
// BvhTris below).  The contract is the plain version's
// (kernels/traversal.py bvh_closest_hit), a skip-link walk over the
// flattened DFS-preorder BVH, to the bit: the same triangle index on every
// lane and the same t.
//
// The walk is an ordered stack walk: at an interior node both children's
// boxes are tested, the nearer is visited and the farther pushed (the left
// child first when the entries are equal).  Front to back, a ray that hits
// finds its hit early and its running best then culls the boxes behind
// it, where the skip-link walk visits, in preorder, every node whose box
// the ray enters below the best so far.  A popped child's children are
// tested at the running best when its row is read, so the entry is not
// tested again.  The stack is a fixed array of references in the thread
// (local memory, cached in L1), STACK_DEPTH entries; the packer refuses a
// deeper tree.
//
// Ties.  The DFS-preorder leaves hold ascending, contiguous triangle ranges
// (accel/bvh.py finish), so the skip-link walk meets triangles in index
// order and its strict `<` keeps the least index among equal t.  Call a
// box entered at bound T when its slab interval [lo, far] has far > lo and
// min(T, far) > lo (no NaN slab).  Suppose, as holds unless rounding puts a
// box's entry behind a hit inside it, that every box holding a triangle
// hit at t has lo <= t.  Let t* be the least hit t among triangles whose
// boxes all have far > lo, and k* the least index with t*.  The skip-link
// walk reaches k* with a bound above t* (every triangle before k* in index
// order hits later or not at all), enters its boxes and keeps it; nothing
// after beats it.  The stack walk's bound never drops below t*, and
// reaches t* only through a tie k > k*.  So it enters each box of k* unless
// that box's entry is exactly t_best = t*, a tie on the box's face, and
// there the strict test would cull k*.  Hence the rule of box_enter: a box
// whose entry equals t_best is entered when its subtree's first triangle
// index is below the best index so far (the strict test is kept
// otherwise), and a triangle is accepted when tt < t_best or tt == t_best
// with a lower index.  Entering more boxes than needed never changes the
// answer (a popped leaf is tested without its box).  Both walks then
// return (t*, k*).  tests/test_torch_traversal.py holds this
// on meshes whose hits all tie (an icosphere and an axis-aligned cube, each
// added twice) for every builder.
//
// Rounding follows the references: 1/d and every product IEEE-rounded
// (built without --use_fast_math, with --fmad=false), and the slab test
// lets NaN (0 * inf with the origin on a box plane) reject the box.

#pragma once

#include <string.h>

#include "tracer.cuh"

namespace tpt {

// The packed tables (kernels/traversal.py pack_bvh).  A node row: the left
// child's box (min xyz, max xyz), the right child's box, then four ints:
// left first triangle, left reference, right first triangle, right
// reference.  A reference >= 0 is the row of an interior child; a leaf's is
// ~(first << LEAF_BITS | count - 1).  A triangle row: a xyz, then
// triangle_edges (ab, ac, nt), the operands of triangle_mt_pre.
constexpr int NODE_ROW = 16;
constexpr int NODE_REFS = 12;
constexpr int TRI_ROW = 12;  // a xyz, then triangle_edges: ab, ac, nt
constexpr int LEAF_BITS = 5;
constexpr int LEAF_MAX = 1 << LEAF_BITS;
constexpr int STACK_DEPTH = 64;
constexpr int QUIET_NAN = 0x7fc00000;

struct F4 {
  float x, y, z, w;
};

// 16 bytes at p (16-byte aligned) through the read-only cache.
TPT_HD F4 load4(const float* p) {
#ifdef __CUDA_ARCH__
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  const F4 r = {v.x, v.y, v.z, v.w};
#else
  const F4 r = {p[0], p[1], p[2], p[3]};
#endif
  return r;
}

TPT_HD int as_int(float x) {
#ifdef __CUDA_ARCH__
  return __float_as_int(x);
#else
  int i;
  memcpy(&i, &x, sizeof i);
  return i;
#endif
}

TPT_HD float as_float(int i) {
#ifdef __CUDA_ARCH__
  return __int_as_float(i);
#else
  float x;
  memcpy(&x, &i, sizeof x);
  return x;
#endif
}

TPT_HD bool is_nan(float x) { return x != x; }

// The slab test of kernels/intersect.py aabb_hit on a box (min xyz, max
// xyz) at the running best, with the tie rule of the note above: entered
// when far > lo and t_best > lo, or t_best == lo and the subtree's first
// triangle is below the best index.  torch.minimum and amax propagate NaN,
// so there a NaN slab makes the box miss; fminf/fmaxf would drop the NaN,
// hence the explicit check.  lo receives the box's entry.
TPT_HD bool box_enter(float x0, float y0, float z0, float x1, float y1,
                      float z1, V3 o, V3 inv, float t_min, float t_best,
                      int first, int idx, float& lo) {
  const float t0x = (x0 - o.x) * inv.x;
  const float t0y = (y0 - o.y) * inv.y;
  const float t0z = (z0 - o.z) * inv.z;
  const float t1x = (x1 - o.x) * inv.x;
  const float t1y = (y1 - o.y) * inv.y;
  const float t1z = (z1 - o.z) * inv.z;
  if (is_nan(t0x) || is_nan(t0y) || is_nan(t0z) || is_nan(t1x) ||
      is_nan(t1y) || is_nan(t1z)) {
    return false;
  }
  lo = fmaxf(t_min, fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                          fminf(t0z, t1z)));
  const float far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                          fmaxf(t0z, t1z));
  return far > lo && (t_best > lo || (t_best == lo && first < idx));
}

// What a walk does, for the bound's count: node rows fetched (two slab
// tests each) and triangle tests.  The kernels count nothing.
struct NoWork {
  TPT_HD void row() {}
  TPT_HD void tri() {}
};

struct Work {
  long long rows, tris;
  TPT_HD void row() { ++rows; }
  TPT_HD void tri() { ++tris; }
};

// One ray's walk over node rows [R, NODE_ROW] and triangle rows
// [T, TRI_ROW].  Writes t (inf on a miss) and the triangle index (-1).
template <class W>
TPT_HD void stack_walk(const float* rows, const float* tris, V3 o, V3 d,
                       float t_min, float t_best0, float inf, float& t_out,
                       int& idx_out, W& work) {
  const V3 inv = v3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
  float t_best = t_best0;
  int idx = -1;
  int stack[STACK_DEPTH];
  int sp = 0;
  int ref = 0;
  for (;;) {
    if (ref >= 0) {
      const float* R = rows + NODE_ROW * ref;
      const F4 p = load4(R), q = load4(R + 4), r = load4(R + 8),
               s = load4(R + NODE_REFS);
      work.row();
      float lo_l, lo_r;
      const bool hit_l = box_enter(p.x, p.y, p.z, p.w, q.x, q.y, o, inv,
                                   t_min, t_best, as_int(s.x), idx, lo_l);
      const bool hit_r = box_enter(q.z, q.w, r.x, r.y, r.z, r.w, o, inv,
                                   t_min, t_best, as_int(s.z), idx, lo_r);
      const int ref_l = as_int(s.y), ref_r = as_int(s.w);
      if (hit_l && hit_r) {
        const bool right_first = lo_r < lo_l;
        stack[sp++] = right_first ? ref_l : ref_r;
        ref = right_first ? ref_r : ref_l;
        continue;
      }
      if (hit_l || hit_r) {
        ref = hit_l ? ref_l : ref_r;
        continue;
      }
    } else {
      const int leaf = ~ref;
      const int first = leaf >> LEAF_BITS;
      const int end = first + (leaf & (LEAF_MAX - 1)) + 1;
      for (int k = first; k < end; ++k) {
        const float* T = tris + TRI_ROW * k;
        const F4 p = load4(T), q = load4(T + 4), r = load4(T + 8);
        const float E[TRI_PRE] = {p.w, q.x, q.y, q.z, q.w,
                                  r.x, r.y, r.z, r.w};
        work.tri();
        float tt, uu, vv, ww;
        if (triangle_mt_pre(v3(p.x, p.y, p.z), E, o, d, t_min, t_best, tt,
                            uu, vv, ww) &&
            (tt < t_best || (tt == t_best && k < idx))) {
          t_best = tt;
          idx = k;
        }
      }
    }
    if (sp == 0) break;
    ref = stack[--sp];
  }
  t_out = idx >= 0 ? t_best : inf;
  idx_out = idx;
}

// find_hit's triangle search over a scene's BVH (the forward megakernel's
// BVH variant), for scenes above MAX_MEGAKERNEL_TRIS triangles: the walk
// over the packed node and triangle rows, from global memory (L2-resident:
// 5.2 MB and 3.9 MB at 81,920 triangles), bounded by the running best of
// the spheres and quads, as kernels/hit.py find_hit calls
// traversal.closest_hit; its hit is merged with the same strict `<`.  The
// tables' triangle rows (corners, normals, material) stay in global memory
// too, at Tables::tri, and shading reads the winner's row there.
struct BvhTris {
  static constexpr bool kGlobalRows = true;
  const float* rows;
  const float* tris;

  TPT_HD void closest(const Params& p, const Tables<const float>& S, V3 o,
                      V3 d, Hit& h) const {
    NoWork w;
    float t;
    int k;
    // Before any hit the wavefront's running best is t_max, not inf.
    stack_walk(rows, tris, o, d, p.t_min, fminf(h.t, p.t_max), p.inf, t, k,
               w);
    if (k >= 0 && t < h.t) {
      h.t = t;
      h.kind = K_TRI;
      h.idx = k;
    }
  }

  // Triangle k's test from its packed row (a, then triangle_edges): the
  // operands and rounding of SharedTris::test.
  TPT_HD bool test(const Params& p, const Tables<const float>& S, int k, V3 o,
                   V3 d, float& tt, float& uu, float& vv, float& ww) const {
    const float* T = tris + TRI_ROW * k;
    return triangle_mt_pre(load3(T), T + 3, o, d, p.t_min, p.t_max, tt, uu,
                           vv, ww);
  }
};

// What the BVH variant keeps in shared memory: the tables without their
// triangles (spheres, quads, the light, the camera) and their invariants.
// Its Params with no triangles lays them out (tables_at, prepare_scene).
TPT_HD Params bvh_shared_params(const Params& p) {
  Params s = p;
  s.n_tri = 0;
  return s;
}

// Float k of a forward block's shared tables (k < table_floats(p), or of
// bvh_shared_params(p) where the block walks the BVH): from the flat tables
// sph | quad | tri | light in global memory, the triangles left out when
// walk is set, and the view matrix (16 floats), which the caller passes
// apart so that no frame copies the cached tables.
TPT_HD float fwd_shared_float(const Params& p, bool walk, const float* tables,
                              const float* view, int k) {
  const int sq = p.n_sph * SPH_COLS + p.n_quad * QUAD_COLS;
  const int tri = p.n_tri * TRI_COLS;
  const int head = walk ? sq : sq + tri;
  if (k < head) return tables[k];
  k -= head;
  if (k < LIGHT_COLS) return tables[sq + tri + k];
  return view[k - LIGHT_COLS];
}

// The tables the BVH variant traces with: the shared ones at base, the
// triangle rows in the flat tables in global memory (no invariants: the
// BVH's triangle rows carry them).
TPT_HD Tables<const float> bvh_tables_at(const float* base, const Params& p,
                                         const float* tables) {
  Tables<const float> S = tables_at<const float>(base, bvh_shared_params(p));
  S.tri = tables + p.n_sph * SPH_COLS + p.n_quad * QUAD_COLS;
  S.tri_pre = nullptr;
  return S;
}

}  // namespace tpt
