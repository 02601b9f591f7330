// Closest triangle hit per ray through the BVH, for Hopper (sm_90a).
//
// Replaces the TPU kernels tpu_path_tracer/kernels/pallas/traversal.py:752
// _sweep_round_resident (kernel :623, meshes up to 640 chunks of 128
// triangles) and :865 _sweep_round (kernel :797, larger meshes), both driven
// by tile_closest_hit (:918-1070).  They compute, per ray, the closest
// triangle hit below a running bound t_best0: t, and the triangle's index
// or -1.  A negative t_best0 marks a retired lane (kernels/hit.py), which
// does no work and reports a miss.  What the TPU design adds around them
// exists only for the TPU and is left out: the Morton sort of the rays, the
// two-level chunk cull, the compacted queue and its prefix tiers, and the
// Plücker MXU tables.
//
// The contract is the plain version's (kernels/traversal.py
// bvh_closest_hit), a skip-link walk over the flattened DFS-preorder BVH,
// to the bit: the same triangle index on every lane and the same t.
//
// What bounds it on this card: the latency of dependent loads.  A ray's
// next fetch depends on the box tests of the last one, the tables (5.2 MB
// of node rows and 3.9 MB of triangle rows at 81,920 triangles, 21 MB and
// 15.7 MB at 327,680) live in the 50 MB L2, and the FP32 work per fetch is
// small (two slab tests, 62 operations; a triangle test, 45).  Walks of
// different length in one warp diverge.  The design cuts the number of
// dependent fetches and the work per fetch:
//
//   * an ordered stack walk: at an interior node both children's boxes are
//     tested, the nearer is visited and the farther pushed (the left child
//     first when the entries are equal).  Front to back, a ray that hits
//     finds its hit early and its running best then culls the boxes behind
//     it, where the skip-link walk visits, in preorder, every node whose
//     box the ray enters below the best so far.  A popped child's children
//     are tested at the running best when its row is read, so the entry is
//     not tested again (keeping the entry distances on the stack to drop
//     entries on pop measured slower, PERF.md).  The stack is a fixed
//     array of references in the thread (local memory, cached in L1),
//     STACK_DEPTH entries; the packer refuses a deeper tree;
//   * child-pair node rows: the row of an interior node holds both
//     children's boxes and references, 64 bytes read as four 16-byte loads,
//     so one dependent fetch feeds two slab tests.  Row 0 holds the root as
//     its left child beside an empty (NaN) box, so the root's box is tested
//     like any other;
//   * precomputed triangle rows: a and the edges ab, ac and normal ab x ac
//     (tracer.cuh triangle_edges), 48 bytes read as three 16-byte loads and
//     tested with triangle_mt_pre, which rounds as triangle_mt does.  The
//     rows are written by bvh_pack_kernel on every call (the refit moves the
//     bounds every training step) with the same expressions.
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
//
// Built without nvcc (a plain C++ compiler), this file compiles the walk
// and the packing for the CPU, with host entry points that drive them (the
// CPU tests, and the work counts of chip_smoke.py's bound), and leaves out
// the kernels and their entry points.

#include "tracer.cuh"

#include <string.h>

namespace tpt {

// The packed tables (kernels/traversal.py pack_bvh).  A node row: the left
// child's box (min xyz, max xyz), the right child's box, then four ints:
// left first triangle, left reference, right first triangle, right
// reference.  A reference >= 0 is the row of an interior child; a leaf's is
// ~(first << LEAF_BITS | count - 1).
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
// tests each) and triangle tests.  The kernel counts nothing.
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

// The FlatBVH fields the packing reads (core/types.py), int64 as torch
// keeps them; row_of[n] is the row of interior node n.
struct BvhFields {
  const float* mins;
  const float* maxs;
  const long long* right;
  const long long* prim_start;
  const long long* prim_count;
  const long long* prim_lo;
  const long long* row_of;
  int n_nodes;
};

TPT_HD int leaf_ref(int first, int count) {
  return ~((first << LEAF_BITS) | (count - 1));
}

// Child c of a row into side 0 (left) or 1 (right) of row R.
TPT_HD void put_child(const BvhFields& f, long long c, int side, float* R) {
  for (int j = 0; j < 3; ++j) {
    R[6 * side + j] = f.mins[3 * c + j];
    R[6 * side + 3 + j] = f.maxs[3 * c + j];
  }
  const int ref = f.right[c] >= 0
                      ? (int)f.row_of[c]
                      : leaf_ref((int)f.prim_start[c], (int)f.prim_count[c]);
  R[NODE_REFS + 2 * side] = as_float((int)f.prim_lo[c]);
  R[NODE_REFS + 2 * side + 1] = as_float(ref);
}

// An empty side: a NaN box, which every slab test rejects.
TPT_HD void put_empty(int side, float* R) {
  for (int j = 0; j < 6; ++j) R[6 * side + j] = as_float(QUIET_NAN);
  R[NODE_REFS + 2 * side] = as_float(0);
  R[NODE_REFS + 2 * side + 1] = as_float(0);
}

// Node n's share of the node rows: the row of its children if it is
// interior; node 0 also writes row 0 (the root beside an empty box), as
// does n = 0 of an empty tree.
TPT_HD void pack_node(const BvhFields& f, int n, float* rows) {
  if (n == 0) {
    if (f.n_nodes > 0) {
      put_child(f, 0, 0, rows);
    } else {
      put_empty(0, rows);
    }
    put_empty(1, rows);
  }
  if (n < f.n_nodes && f.right[n] >= 0) {
    float* R = rows + NODE_ROW * f.row_of[n];
    put_child(f, n + 1, 0, R);
    put_child(f, f.right[n], 1, R);
  }
}

// Triangle k's row: a, then triangle_edges of (a, b, c).
TPT_HD void pack_tri(const float* a, const float* b, const float* c, int k,
                     float* tris) {
  const float T[9] = {a[3 * k], a[3 * k + 1], a[3 * k + 2],
                      b[3 * k], b[3 * k + 1], b[3 * k + 2],
                      c[3 * k], c[3 * k + 1], c[3 * k + 2]};
  float* out = tris + TRI_ROW * (long long)k;
  for (int j = 0; j < 3; ++j) out[j] = T[j];
  triangle_edges(T, out + 3);
}

}  // namespace tpt

// Host entry points, bound with ctypes: the same packing and walk on the
// CPU.  tpt_bvh_walk_host adds to work[0] the node rows fetched and to
// work[1] the triangle tests (work may be null).
extern "C" void tpt_bvh_pack_host(const float* mins, const float* maxs,
                                  const long long* right,
                                  const long long* prim_start,
                                  const long long* prim_count,
                                  const long long* prim_lo,
                                  const long long* row_of, int n_nodes,
                                  const float* a, const float* b,
                                  const float* c, int n_tris, float* rows,
                                  float* tris) {
  const tpt::BvhFields f = {mins,     maxs,    right,  prim_start,
                            prim_count, prim_lo, row_of, n_nodes};
  for (int n = 0; n < (n_nodes > 0 ? n_nodes : 1); ++n) {
    tpt::pack_node(f, n, rows);
  }
  for (int k = 0; k < n_tris; ++k) tpt::pack_tri(a, b, c, k, tris);
}

extern "C" void tpt_bvh_walk_host(const float* origin, const float* direction,
                                  const float* t_best0, const float* rows,
                                  const float* tris, int n, float t_min,
                                  float inf, float* t_out, int* idx_out,
                                  long long* work) {
  tpt::Work w = {0, 0};
  for (int i = 0; i < n; ++i) {
    const tpt::V3 o = tpt::v3(origin[3 * i], origin[3 * i + 1],
                              origin[3 * i + 2]);
    const tpt::V3 d = tpt::v3(direction[3 * i], direction[3 * i + 1],
                              direction[3 * i + 2]);
    tpt::stack_walk(rows, tris, o, d, t_min, t_best0[i], inf, t_out[i],
                    idx_out[i], w);
  }
  if (work) {
    work[0] += w.rows;
    work[1] += w.tris;
  }
}

// The limits the packer checks: the stack's depth and a leaf's most
// triangles.
extern "C" void tpt_bvh_limits(int* out) {
  out[0] = tpt::STACK_DEPTH;
  out[1] = tpt::LEAF_MAX;
}

#ifdef __CUDACC__

namespace {

using namespace tpt;

constexpr int WALK_THREADS = 128;
constexpr int PACK_THREADS = 256;

__global__ void __launch_bounds__(WALK_THREADS)
bvh_stack_walk_kernel(const float* __restrict__ origin,
                      const float* __restrict__ direction,
                      const float* __restrict__ t_best0,
                      const float* __restrict__ rows,
                      const float* __restrict__ tris, int n, float t_min,
                      float inf, float* __restrict__ t_out,
                      int* __restrict__ idx_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const V3 o = v3(origin[3 * i], origin[3 * i + 1], origin[3 * i + 2]);
  const V3 d = v3(direction[3 * i], direction[3 * i + 1],
                  direction[3 * i + 2]);
  NoWork w;
  float t;
  int idx;
  stack_walk(rows, tris, o, d, t_min, t_best0[i], inf, t, idx, w);
  t_out[i] = t;
  idx_out[i] = idx;
}

__global__ void __launch_bounds__(PACK_THREADS)
bvh_pack_kernel(BvhFields f, const float* __restrict__ a,
                const float* __restrict__ b, const float* __restrict__ c,
                int n_tris, float* __restrict__ rows,
                float* __restrict__ tris) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0 || i < f.n_nodes) pack_node(f, i, rows);
  if (i < n_tris) pack_tri(a, b, c, i, tris);
}

}  // namespace

// C entry points, bound with ctypes (kernels/traversal.py).  Each returns
// cudaGetLastError() of its launch.
//
// origin and direction [n, 3], t_best0 [n], outputs t [n] and idx [n]; the
// tables as tpt_bvh_pack lays them out.
extern "C" int tpt_bvh_closest_hit(const float* origin,
                                   const float* direction,
                                   const float* t_best0, const float* rows,
                                   const float* tris, int n, float t_min,
                                   float inf, float* t_out, int* idx_out,
                                   void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int blocks = (n + WALK_THREADS - 1) / WALK_THREADS;
  bvh_stack_walk_kernel<<<blocks, WALK_THREADS, 0, (cudaStream_t)stream>>>(
      origin, direction, t_best0, rows, tris, n, t_min, inf, t_out, idx_out);
  return (int)cudaGetLastError();
}

// The FlatBVH fields (mins, maxs [B, 3] f32; the int64 fields [B]), row_of
// [B] int64, and the triangles' corners a, b, c [T, 3] into node rows
// [R, NODE_ROW] and triangle rows [T, TRI_ROW].
extern "C" int tpt_bvh_pack(const float* mins, const float* maxs,
                            const long long* right,
                            const long long* prim_start,
                            const long long* prim_count,
                            const long long* prim_lo, const long long* row_of,
                            int n_nodes, const float* a, const float* b,
                            const float* c, int n_tris, float* rows,
                            float* tris, void* stream) {
  const tpt::BvhFields f = {mins,       maxs,    right,  prim_start,
                            prim_count, prim_lo, row_of, n_nodes};
  const int n = n_nodes > n_tris ? n_nodes : (n_tris > 0 ? n_tris : 1);
  const int blocks = (n + PACK_THREADS - 1) / PACK_THREADS;
  bvh_pack_kernel<<<blocks, PACK_THREADS, 0, (cudaStream_t)stream>>>(
      f, a, b, c, n_tris, rows, tris);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
