// Fused forward path-tracing megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_path_tracer/kernels/pallas/megakernel.py::
// _fwd_call.  One thread traces one pixel (tracer.cuh trace_pixel): camera
// ray, the spp x max_bounces loop, the hit search over spheres, quads and up
// to MAX_MEGAKERNEL_TRIS triangles, per-sphere volume free flight, front-face
// emission, the four BSDFs, NEE/MIS on the light quad and Russian roulette.
//
// What bounds it on this card: FP32 ALU work and branch divergence.  Global
// memory traffic is 12 bytes in (PCG state, px, py) and 12 bytes out (rgb)
// per pixel; everything else lives in registers.  The design answers that:
//   * the scene tables (about 3.8 KB for the full reference scene) are
//     copied once per block into dynamic shared memory, followed by what
//     every test would otherwise derive again (tracer.cuh prepare_scene:
//     triangle edges and normal, R * R, the light plane); every thread of
//     a warp reads the same primitive in step, so the reads broadcast;
//   * the hit search derives a = d . d and 1 / a once per ray for all its
//     sphere tests; the volume pass tests only ISOTROPIC spheres (each
//     sphere still draws its uniform), and a quad or volume test that has
//     failed skips its division and logarithm;
//   * a lane whose path ends leaves the bounce loop at once instead of
//     idling through masked work, and jumps its PCG state ahead by the
//     draws it would have made (LCG jump-ahead, O(log k));
//   * only the BSDF of the hit material is evaluated; the other branches'
//     uniforms are still drawn, so the stream stays the wavefront's.
// Each of these runs the same operations on the same operands as the
// kernel of commit ae782d5 did, so the radiance is equal to its bit for
// bit (PERF.md).
//
// Two instantiations of the tracer behind one entry point, which launches
// the second when it is given the BVH's rows (the wrapper,
// kernels/megakernel.py route, decides):
//   * megakernel_fwd_kernel: at most MAX_MEGAKERNEL_TRIS (64) triangles,
//     tested one by one from shared memory (tracer.cuh SharedTris);
//   * megakernel_fwd_bvh_kernel: a scene with a BVH above that, for frames
//     without gradients (the backward covers the first kind only).  Its hit
//     search walks the BVH for the triangles after the spheres and quads
//     (bvh_walk.cuh BvhTris: the traversal kernel's stack walk, to the bit
//     its (t, index)), so a mesh frame is this one launch instead of the
//     eager wavefront's thousands.  The node and triangle rows (9.1 MB at
//     81,920 triangles) and the triangles' 31-float rows (10.2 MB) stay in
//     global memory, L2-resident; shading reads the winner's row there.
//     Shared memory holds the spheres, quads, light and camera.  What
//     bounds it: the walk's dependent loads, as in traversal.cu, now with
//     the shading's registers live around them.
// Both take the view matrix apart from the flat tables, which the wrapper
// packs once per scene, so no frame copies them (fwd_shared_float).

#include "bvh_walk.cuh"

namespace {

using namespace tpt;

// ptxas fits the kernel in 64 registers (8 blocks of 128 threads an SM);
// budgets for 6 blocks (80 registers) or 4 (89) measured slower (PERF.md).
__global__ void __launch_bounds__(128)
megakernel_fwd_kernel(const float* __restrict__ tables,
                      const float* __restrict__ view,
                      const int* __restrict__ state_in,
                      const int* __restrict__ px_in,
                      const int* __restrict__ py_in,
                      float* __restrict__ out, Params p) {
  extern __shared__ float smem[];
  const int n_floats = table_floats(p);
  for (int k = threadIdx.x; k < n_floats; k += blockDim.x) {
    smem[k] = fwd_shared_float(p, false, tables, view, k);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < scene_invariants(p); k += blockDim.x) {
    prepare_scene(p, smem, k);
  }
  __syncthreads();
  const Tables<const float> S = tables_at<const float>(smem, p);

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  float rgb[3];
  trace_pixel(p, S, (uint32_t)state_in[i], (float)px_in[i], (float)py_in[i],
              rgb);
  out[3 * i + 0] = rgb[0];
  out[3 * i + 1] = rgb[1];
  out[3 * i + 2] = rgb[2];
}

// The BVH variant: shared memory takes the tables without their triangles,
// which it reads from the flat tables in global memory.  Left
// to its own budget ptxas fits it in 72 registers with 8 bytes of spills
// (7 blocks of 128 threads an SM); on the 81,920-triangle icosphere at
// 512x512 that measured 0.644 ms a frame, a budget of 8 blocks (64
// registers, 40 bytes of spills) 0.641, of 6 (76) 0.657, of 4 (84) 0.705,
// blocks of 256 threads 0.657 and of 64 0.681, all within one run in turns
// (PERF.md), so the budget stays ptxas' own.
__global__ void __launch_bounds__(128)
megakernel_fwd_bvh_kernel(const float* __restrict__ tables,
                          const float* __restrict__ view,
                          const float* __restrict__ rows,
                          const float* __restrict__ tris,
                          const int* __restrict__ state_in,
                          const int* __restrict__ px_in,
                          const int* __restrict__ py_in,
                          float* __restrict__ out, Params p) {
  extern __shared__ float smem[];
  const Params ps = bvh_shared_params(p);
  const int n_floats = table_floats(ps);
  for (int k = threadIdx.x; k < n_floats; k += blockDim.x) {
    smem[k] = fwd_shared_float(p, true, tables, view, k);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < scene_invariants(ps); k += blockDim.x) {
    prepare_scene(ps, smem, k);
  }
  __syncthreads();
  const Tables<const float> S = bvh_tables_at(smem, p, tables);
  const BvhTris walk = {rows, tris};

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  float rgb[3];
  trace_pixel(p, S, (uint32_t)state_in[i], (float)px_in[i], (float)py_in[i],
              rgb, walk);
  out[3 * i + 0] = rgb[0];
  out[3 * i + 1] = rgb[1];
  out[3 * i + 2] = rgb[2];
}

}  // namespace

// C entry point, bound with ctypes (kernels/megakernel.py).  ``tables`` is
// the concatenation sph [n_sph, 17] | quad [n_quad, 29] | tri [n_tri, 31] |
// light [9], all float32, and ``view`` the row-major 4x4 view matrix.
// ``grid_n`` is the stratified grid side, or 0 for plain jitter.  With the
// BVH's node rows [R, 16] and triangle rows [n_tri, 12] (kernels/
// traversal.py pack_bvh) it launches megakernel_fwd_bvh_kernel, with null
// ones megakernel_fwd_kernel.  Returns cudaGetLastError() of the launch.
extern "C" int tpt_megakernel_fwd(
    const float* tables, int n_sph, int n_quad, int n_tri,
    const int* state, const int* px, const int* py, float* out, int n,
    int spp, int max_bounces, int grid_n, int use_nee, int has_volumes,
    int rr_start_bounce, float t_min, float t_max, float inf, float p_light,
    float bg_r, float bg_g, float bg_b, float aspect, float fov_factor,
    float w, float h, float sub_scale, float inv_spp, const float* view,
    const float* rows, const float* tris, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const Params p = {n_sph,   n_quad,     n_tri,   n,       spp,
                    max_bounces, grid_n, use_nee, has_volumes,
                    rr_start_bounce,     t_min,   t_max,   inf,
                    p_light, bg_r,       bg_g,    bg_b,    aspect,
                    fov_factor,          w,       h,       sub_scale,
                    inv_spp};
  const bool walk = rows != nullptr;
  const void* kernel = walk ? (const void*)megakernel_fwd_bvh_kernel
                            : (const void*)megakernel_fwd_kernel;
  const size_t smem_bytes =
      sizeof(float) * (size_t)scene_floats(walk ? bvh_shared_params(p) : p);
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  if (walk) {
    megakernel_fwd_bvh_kernel<<<blocks, threads, smem_bytes,
                                (cudaStream_t)stream>>>(
        tables, view, rows, tris, state, px, py, out, p);
  } else {
    megakernel_fwd_kernel<<<blocks, threads, smem_bytes,
                            (cudaStream_t)stream>>>(tables, view, state, px,
                                                    py, out, p);
  }
  return (int)cudaGetLastError();
}
