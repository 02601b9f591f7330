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
// to the bit: the same triangle index on every lane and the same t.  The
// walk itself (stack_walk, its tables' layout and its tie rule) is in
// bvh_walk.cuh, which the forward megakernel's hit search over a BVH scene
// calls too (megakernel_fwd.cu).
//
// What bounds it on this card: the latency of dependent loads.  A ray's
// next fetch depends on the box tests of the last one, the tables (5.2 MB
// of node rows and 3.9 MB of triangle rows at 81,920 triangles, 21 MB and
// 15.7 MB at 327,680) live in the 50 MB L2, and the FP32 work per fetch is
// small (two slab tests, 62 operations; a triangle test, 45).  Walks of
// different length in one warp diverge.  The design cuts the number of
// dependent fetches and the work per fetch:
//
//   * an ordered stack walk, front to back (bvh_walk.cuh): a ray that hits
//     finds its hit early and its running best then culls the boxes behind
//     it (keeping the entry distances on the stack to drop entries on pop
//     measured slower, PERF.md);
//   * child-pair node rows: the row of an interior node holds both
//     children's boxes and references, 64 bytes read as four 16-byte loads,
//     so one dependent fetch feeds two slab tests.  Row 0 holds the root as
//     its left child beside an empty (NaN) box, so the root's box is tested
//     like any other;
//   * precomputed triangle rows: a and the edges ab, ac and normal ab x ac
//     (tracer.cuh triangle_edges), 48 bytes read as three 16-byte loads and
//     tested with triangle_mt_pre, which rounds as triangle_mt does.  The
//     rows are written by bvh_pack_kernel (the refit moves the bounds every
//     training step) with the same expressions.
//
// Built without nvcc (a plain C++ compiler), this file compiles the walk
// and the packing for the CPU, with host entry points that drive them (the
// CPU tests, and the work counts of chip_smoke.py's bound), and leaves out
// the kernels and their entry points.

#include <vector>

#include "bvh_walk.cuh"

namespace tpt {

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

// The forward megakernel on the CPU (megakernel_fwd.cu, with the arguments
// of its entry point tpt_megakernel_fwd but the stream): what each block
// does to its shared memory, then trace_pixel for every pixel, through the
// walk where rows are given (megakernel_fwd_bvh_kernel), else through the
// triangle loop over shared memory (megakernel_fwd_kernel).
extern "C" void tpt_megakernel_fwd_host(
    const float* tables, int n_sph, int n_quad, int n_tri, const int* state,
    const int* px, const int* py, float* out, int n, int spp,
    int max_bounces, int grid_n, int use_nee, int has_volumes,
    int rr_start_bounce, float t_min, float t_max, float inf, float p_light,
    float bg_r, float bg_g, float bg_b, float aspect, float fov_factor,
    float w, float h, float sub_scale, float inv_spp, const float* view,
    const float* rows, const float* tris) {
  const tpt::Params p = {n_sph,   n_quad,     n_tri,   n,       spp,
                         max_bounces, grid_n, use_nee, has_volumes,
                         rr_start_bounce,     t_min,   t_max,   inf,
                         p_light, bg_r,       bg_g,    bg_b,    aspect,
                         fov_factor,          w,       h,       sub_scale,
                         inv_spp};
  const bool walk = rows != nullptr;
  const tpt::Params ps = walk ? tpt::bvh_shared_params(p) : p;
  std::vector<float> shared(tpt::scene_floats(ps));
  for (int k = 0; k < tpt::table_floats(ps); ++k) {
    shared[k] = tpt::fwd_shared_float(p, walk, tables, view, k);
  }
  for (int k = 0; k < tpt::scene_invariants(ps); ++k) {
    tpt::prepare_scene(ps, shared.data(), k);
  }
  if (walk) {
    const tpt::Tables<const float> S =
        tpt::bvh_tables_at(shared.data(), p, tables);
    const tpt::BvhTris bvh = {rows, tris};
    for (int i = 0; i < n; ++i) {
      tpt::trace_pixel(p, S, (uint32_t)state[i], (float)px[i], (float)py[i],
                       out + 3 * i, bvh);
    }
    return;
  }
  const tpt::Tables<const float> S =
      tpt::tables_at<const float>(shared.data(), p);
  for (int i = 0; i < n; ++i) {
    tpt::trace_pixel(p, S, (uint32_t)state[i], (float)px[i], (float)py[i],
                     out + 3 * i);
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
