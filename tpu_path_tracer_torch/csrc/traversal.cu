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
// Design: one thread per ray walks the flattened DFS-preorder BVH with skip
// links (kernels/traversal.py bvh_closest_hit, the plain version): node + 1
// when the ray hits the node's box, miss[node] otherwise; a leaf tests its
// triangles prim_start .. prim_start + prim_count in order against the
// running best, with the megakernel's Möller-Trumbore (tracer.cuh
// triangle_mt).  The walk visits the same nodes in the same order as the
// plain version, so equal t on a shared edge resolves to the same index.
// Rounding follows the references: 1/d and every product IEEE-rounded
// (built without --use_fast_math, with --fmad=false), and the slab test
// lets NaN (0 * inf with the origin on a box plane) reject the box.
//
// What bounds it on this card: the latency of dependent loads.  Each node
// visit reads 24 bytes of bounds and 12 of links from tables that live in
// L2 (5.9 MB of nodes and 2.9 MB of triangles at 81,920 triangles, about
// 35 MB at 327,680, within the 50 MB L2), and the next address depends on
// the test.  The FP32 work per visit is small (about 30 operations for a
// box, 60 for a triangle), and walks of different length in one warp
// diverge.  The design keeps the whole ray state in registers, reads the
// tables through the read-only cache (__ldg), packs each node's bounds in
// one row and its links in another, and lets a retired lane leave at the
// root.  Front-to-back traversal with a stack (the reference's
// hitRay.wgsl:42-110) would visit fewer nodes but change which index wins a
// tie; it is later work.
//
// Built without nvcc (a plain C++ compiler), this file compiles the per-ray
// walk for the CPU and leaves out the kernel and its entry point.

#include "tracer.cuh"

namespace tpt {

#ifdef __CUDA_ARCH__
#define TPT_LDG(p) __ldg(p)
#else
#define TPT_LDG(p) (*(p))
#endif

TPT_HD bool is_nan(float x) { return x != x; }

// Slab test of kernels/intersect.py aabb_hit on one node's bounds
// (min xyz, max xyz).  torch.minimum and amax propagate NaN, so there a NaN
// slab makes the box miss; fminf/fmaxf would drop the NaN and report a hit.
TPT_HD bool slab_hit(const float* B, V3 o, V3 inv, float t_min,
                     float t_max) {
  const float t0x = (TPT_LDG(B + 0) - o.x) * inv.x;
  const float t0y = (TPT_LDG(B + 1) - o.y) * inv.y;
  const float t0z = (TPT_LDG(B + 2) - o.z) * inv.z;
  const float t1x = (TPT_LDG(B + 3) - o.x) * inv.x;
  const float t1y = (TPT_LDG(B + 4) - o.y) * inv.y;
  const float t1z = (TPT_LDG(B + 5) - o.z) * inv.z;
  if (is_nan(t0x) || is_nan(t0y) || is_nan(t0z) || is_nan(t1x) ||
      is_nan(t1y) || is_nan(t1z)) {
    return false;
  }
  const float lo = fmaxf(t_min, fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                      fminf(t0z, t1z)));
  const float hi = fminf(t_max, fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                      fmaxf(t0z, t1z)));
  return hi > lo;
}

// One ray's walk.  bounds [B, 6] f32, links [B, 3] int32 (miss, prim_start,
// prim_count), tris [T, 9] f32 (corners a, b, c).  Writes t (inf on a miss)
// and the triangle index (-1 on a miss).
TPT_HD void bvh_walk(const float* bounds, const int* links, const float* tris,
                     int n_nodes, V3 o, V3 d, float t_min, float t_best0,
                     float inf, float& t_out, int& idx_out) {
  const V3 inv = v3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
  float t_best = t_best0;
  int idx = -1;
  int node = 0;
  while (node < n_nodes) {
    const int* L = links + 3 * node;
    if (slab_hit(bounds + 6 * node, o, inv, t_min, t_best)) {
      const int start = TPT_LDG(L + 1);
      const int end = start + TPT_LDG(L + 2);  // interior nodes hold none
      for (int k = start; k < end; ++k) {
        float tt, uu, vv, ww;
        const float* T = tris + 9 * k;
        const float c[9] = {TPT_LDG(T + 0), TPT_LDG(T + 1), TPT_LDG(T + 2),
                            TPT_LDG(T + 3), TPT_LDG(T + 4), TPT_LDG(T + 5),
                            TPT_LDG(T + 6), TPT_LDG(T + 7), TPT_LDG(T + 8)};
        if (triangle_mt(c, o, d, t_min, t_best, tt, uu, vv, ww) &&
            tt < t_best) {
          t_best = tt;
          idx = k;
        }
      }
      node += 1;
    } else {
      node = TPT_LDG(L);
    }
  }
  t_out = idx >= 0 ? t_best : inf;
  idx_out = idx;
}

}  // namespace tpt

#ifdef __CUDACC__

namespace {

using namespace tpt;

__global__ void __launch_bounds__(128)
bvh_closest_hit_kernel(const float* __restrict__ origin,
                       const float* __restrict__ direction,
                       const float* __restrict__ t_best0,
                       const float* __restrict__ bounds,
                       const int* __restrict__ links,
                       const float* __restrict__ tris, int n, int n_nodes,
                       float t_min, float inf, float* __restrict__ t_out,
                       int* __restrict__ idx_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const V3 o = v3(origin[3 * i], origin[3 * i + 1], origin[3 * i + 2]);
  const V3 d = v3(direction[3 * i], direction[3 * i + 1],
                  direction[3 * i + 2]);
  float t;
  int idx;
  bvh_walk(bounds, links, tris, n_nodes, o, d, t_min, t_best0[i], inf, t,
           idx);
  t_out[i] = t;
  idx_out[i] = idx;
}

}  // namespace

// C entry point, bound with ctypes (kernels/traversal.py).  origin and
// direction [n, 3], t_best0 [n], outputs t [n] and idx [n]; the tables as
// pack_bvh lays them out.  Returns cudaGetLastError() of the launch.
extern "C" int tpt_bvh_closest_hit(const float* origin,
                                   const float* direction,
                                   const float* t_best0, const float* bounds,
                                   const int* links, const float* tris, int n,
                                   int n_nodes, float t_min, float inf,
                                   float* t_out, int* idx_out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  bvh_closest_hit_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      origin, direction, t_best0, bounds, links, tris, n, n_nodes, t_min, inf,
      t_out, idx_out);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
