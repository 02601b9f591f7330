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

#include "tracer.cuh"

namespace {

using namespace tpt;

// ptxas fits the kernel in 64 registers (8 blocks of 128 threads an SM);
// budgets for 6 blocks (80 registers) or 4 (89) measured slower (PERF.md).
__global__ void __launch_bounds__(128)
megakernel_fwd_kernel(const float* __restrict__ tables,
                      const int* __restrict__ state_in,
                      const int* __restrict__ px_in,
                      const int* __restrict__ py_in,
                      float* __restrict__ out, Params p) {
  extern __shared__ float smem[];
  const int n_floats = table_floats(p);
  for (int k = threadIdx.x; k < n_floats; k += blockDim.x) {
    smem[k] = tables[k];
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

}  // namespace

// C entry point, bound with ctypes (kernels/megakernel.py).  ``tables`` is
// the concatenation sph [n_sph, 17] | quad [n_quad, 29] | tri [n_tri, 31] |
// light [9] | cam [16], all float32.  ``grid_n`` is the stratified grid
// side, or 0 for plain jitter.  Returns cudaGetLastError() of the launch.
extern "C" int tpt_megakernel_fwd(
    const float* tables, int n_sph, int n_quad, int n_tri,
    const int* state, const int* px, const int* py, float* out, int n,
    int spp, int max_bounces, int grid_n, int use_nee, int has_volumes,
    int rr_start_bounce, float t_min, float t_max, float inf, float p_light,
    float bg_r, float bg_g, float bg_b, float aspect, float fov_factor,
    float w, float h, float sub_scale, float inv_spp, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const Params p = {n_sph,   n_quad,     n_tri,   n,       spp,
                    max_bounces, grid_n, use_nee, has_volumes,
                    rr_start_bounce,     t_min,   t_max,   inf,
                    p_light, bg_r,       bg_g,    bg_b,    aspect,
                    fov_factor,          w,       h,       sub_scale,
                    inv_spp};
  const size_t smem_bytes = sizeof(float) * (size_t)scene_floats(p);
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        megakernel_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  megakernel_fwd_kernel<<<blocks, threads, smem_bytes,
                          (cudaStream_t)stream>>>(tables, state, px, py, out,
                                                  p);
  return (int)cudaGetLastError();
}
