// Fused forward path-tracing megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_path_tracer/kernels/pallas/megakernel.py::
// _fwd_call (tracer body _make_tracer).  One thread traces one pixel: camera
// ray, the spp x max_bounces loop, the hit search over spheres, quads and up
// to MAX_MEGAKERNEL_TRIS triangles, per-sphere volume free flight, front-face
// emission, the four BSDFs, NEE/MIS on the light quad and Russian roulette.
//
// What bounds it on this card: FP32 ALU work and branch divergence.  Global
// memory traffic is 12 bytes in (PCG state, px, py) and 12 bytes out (rgb)
// per pixel; everything else lives in registers.  The design answers that:
//   * the scene tables (about 3.7 KB for the full reference scene) are
//     copied once per block into dynamic shared memory; every thread of a
//     warp reads the same primitive in step, so the reads broadcast;
//   * a lane whose path ends leaves the bounce loop at once instead of
//     idling through masked work, and jumps its PCG state ahead by the
//     draws it would have made (LCG jump-ahead, O(log k));
//   * only the BSDF of the hit material is evaluated; the other branches'
//     uniforms are still drawn, so the stream stays the wavefront's.
//
// Semantics contract (megakernel.py:23-28): draw for draw the same PCG
// stream as the wavefront integrator.  Per bounce: one volume draw per
// sphere when the scene has volumes; 8 material_scatter draws (r1, r2,
// u_spec, f1, f2, u_refl, u_hg, u_phi); 3 NEE draws (lr1, lr2, u_mix) when
// NEE is on; 1 Russian-roulette draw.  Each sample first draws 2 camera
// uniforms.  A retired lane of the wavefront keeps drawing through every
// remaining bounce, so the next sample's camera jitter starts from that
// advanced state: the jump-ahead reproduces it.
//
// Bit-level choices, kept so branch decisions (glass, fog, roulette) agree
// with the JAX kernel and the plain torch version:
//   * built without --use_fast_math and with --fmad=false: neither
//     reference fuses a*b+c, and a different rounding flips branches.  A
//     later change may turn FMA contraction back on with a measured
//     tolerance;
//   * 1.0f / sqrtf(x), never rsqrtf (megakernel.py:100-104);
//   * the u32 -> f32 conversion is __uint2float_rn (round to nearest even,
//     like astype(float32));
//   * the literal constants of the JAX kernel are kept as they are.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SPH_COLS = 17;    // cx cy cz r | mat13
constexpr int QUAD_COLS = 29;   // q3 u3 v3 n3 d w3 | mat13
constexpr int TRI_COLS = 31;    // a3 b3 c3 na3 nb3 nc3 | mat13
constexpr int LIGHT_COLS = 9;   // q3 u3 v3
constexpr int CAM_COLS = 16;    // row-major 4x4 view matrix
// Material row: col3 spec3 emi3 sstr rough eta mtype.
constexpr int M_EMI = 6, M_SSTR = 9, M_ROUGH = 10, M_ETA = 11, M_TYPE = 12;

constexpr float LAMBERTIAN = 0.0f, MIRROR = 1.0f, GLASS = 2.0f,
                ISOTROPIC = 3.0f;
constexpr float INV_PI = (float)(1.0 / 3.1415926535897932385);
constexpr float TWO_PI = (float)(2.0 * 3.1415926535897932385);
constexpr float DET_EPS = 1e-12f;

constexpr uint32_t PCG_MULT = 747796405u;
constexpr uint32_t PCG_INC = 2891336453u;
constexpr uint32_t PCG_XSH = 277803737u;
constexpr float INV_U32 = (float)(1.0 / 4294967295.0);

enum Kind { K_MISS = 0, K_SPHERE = 1, K_QUAD = 2, K_VOLUME = 3, K_TRI = 4 };

struct Params {
  int n_sph, n_quad, n_tri, n;
  int spp, max_bounces, grid_n, use_nee, has_volumes, rr_start_bounce;
  float t_min, t_max, inf, p_light, bg_r, bg_g, bg_b;
  float aspect, fov_factor, w, h, sub_scale, inv_spp;
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}

__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}

__device__ __forceinline__ V3 norm3(V3 v) {
  float inv = 1.0f / sqrtf(fmaxf(dot3(v, v), 1e-20f));
  return v3(v.x * inv, v.y * inv, v.z * inv);
}

__device__ __forceinline__ V3 reflect3(V3 d, V3 n) {
  float k = 2.0f * dot3(d, n);
  return v3(d.x - k * n.x, d.y - k * n.y, d.z - k * n.z);
}

__device__ __forceinline__ float mixf(float a, float b, float t) {
  return a + (b - a) * t;
}

__device__ __forceinline__ V3 mix3(V3 a, V3 b, float t) {
  return v3(mixf(a.x, b.x, t), mixf(a.y, b.y, t), mixf(a.z, b.z, t));
}

__device__ __forceinline__ float safe_sqrt(float x) {
  return x > 0.0f ? sqrtf(x) : 0.0f;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ V3 load3(const float* p) {
  return v3(p[0], p[1], p[2]);
}

// One PCG step: advance, then hash the new state (core/rng.py:43-51).
__device__ __forceinline__ float pcg(uint32_t& s) {
  s = s * PCG_MULT + PCG_INC;
  uint32_t word = ((s >> ((s >> 28) + 4u)) ^ s) * PCG_XSH;
  return __uint2float_rn((word >> 22) ^ word) * INV_U32;
}

// Advance the LCG by k steps in O(log k) (Brown, "Random number generation
// with arbitrary strides").
__device__ __forceinline__ uint32_t pcg_skip(uint32_t s, uint32_t k) {
  uint32_t acc_mult = 1u, acc_plus = 0u;
  uint32_t cur_mult = PCG_MULT, cur_plus = PCG_INC;
  while (k) {
    if (k & 1u) {
      acc_mult *= cur_mult;
      acc_plus = acc_plus * cur_mult + cur_plus;
    }
    cur_plus = (cur_mult + 1u) * cur_plus;
    cur_mult *= cur_mult;
    k >>= 1;
  }
  return acc_mult * s + acc_plus;
}

// Both roots of ray/sphere and the discriminant (intersect.sphere_roots).
__device__ __forceinline__ void sphere_roots(V3 o, V3 d, const float* S,
                                             float& r0, float& r1,
                                             float& disc) {
  V3 oc = v3(o.x - S[0], o.y - S[1], o.z - S[2]);
  float a = dot3(d, d);
  float half_b = dot3(d, oc);
  float c = dot3(oc, oc) - S[3] * S[3];
  disc = half_b * half_b - a * c;
  float sq = safe_sqrt(disc);
  float inv_a = 1.0f / a;
  r0 = (-half_b - sq) * inv_a;
  r1 = (-half_b + sq) * inv_a;
}

__global__ void __launch_bounds__(128)
megakernel_fwd_kernel(const float* __restrict__ tables,
                      const int* __restrict__ state_in,
                      const int* __restrict__ px_in,
                      const int* __restrict__ py_in,
                      float* __restrict__ out, Params p) {
  extern __shared__ float smem[];
  const int n_floats = p.n_sph * SPH_COLS + p.n_quad * QUAD_COLS +
                       p.n_tri * TRI_COLS + LIGHT_COLS + CAM_COLS;
  for (int k = threadIdx.x; k < n_floats; k += blockDim.x) {
    smem[k] = tables[k];
  }
  __syncthreads();
  const float* sph = smem;
  const float* quad = sph + p.n_sph * SPH_COLS;
  const float* tri = quad + p.n_quad * QUAD_COLS;
  const float* light = tri + p.n_tri * TRI_COLS;
  const float* cam = light + LIGHT_COLS;

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;

  // Camera basis columns and eye (shootRay.wgsl:54-60).
  const V3 b0 = v3(cam[0], cam[4], cam[8]);
  const V3 b1 = v3(cam[1], cam[5], cam[9]);
  const V3 b2 = v3(cam[2], cam[6], cam[10]);
  const V3 eye = v3(cam[3], cam[7], cam[11]);

  const int vol_draws = p.has_volumes ? p.n_sph : 0;
  const int tail_draws = 8 + (p.use_nee ? 3 : 0) + 1;  // after the hit pass
  const int draws_per_bounce = vol_draws + tail_draws;
  const float t_min = p.t_min, t_max = p.t_max, inf = p.inf;

  uint32_t state = (uint32_t)state_in[i];
  const float pxf = (float)px_in[i];
  const float pyf = (float)py_in[i];
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;

  for (int smp = 0; smp < p.spp; ++smp) {
    // ---- camera ray (integrator.render.camera_rays).
    const float u1 = pcg(state);
    const float u2 = pcg(state);
    float jx = u1, jy = u2;
    if (p.grid_n > 0) {  // stratified sub-pixel grid
      jx = p.sub_scale * ((float)(smp / p.grid_n) + u1);
      jy = p.sub_scale * ((float)(smp % p.grid_n) + u2);
    }
    const float s = p.aspect * (2.0f * ((pxf - 0.5f + jx) / p.w) - 1.0f);
    const float t = -(2.0f * ((pyf - 0.5f + jy) / p.h) - 1.0f);
    V3 d = norm3(v3(s * b0.x + t * b1.x - p.fov_factor * b2.x,
                    s * b0.y + t * b1.y - p.fov_factor * b2.y,
                    s * b0.z + t * b1.z - p.fov_factor * b2.z));
    V3 o = eye;
    float rad_r = 0.0f, rad_g = 0.0f, rad_b = 0.0f;
    float thr_r = 1.0f, thr_g = 1.0f, thr_b = 1.0f;

    for (int bounce = 0; bounce < p.max_bounces; ++bounce) {
      const uint32_t later_draws =
          (uint32_t)(p.max_bounces - bounce - 1) * (uint32_t)draws_per_bounce;

      // ---- hit pass: strict < keeps the earlier primitive on ties.
      float t_best = inf;
      int kind = K_MISS;
      V3 sc = v3(0.0f, 0.0f, 0.0f);   // winning sphere center
      V3 qn = v3(0.0f, 0.0f, 0.0f);   // winning quad normal
      V3 tn = v3(0.0f, 0.0f, 1.0f);   // winning triangle blended normal
      const float* mat = nullptr;     // winning material row (set on a hit)

      for (int k = 0; k < p.n_sph; ++k) {
        const float* S = sph + k * SPH_COLS;
        // Solid pass skips ISOTROPIC spheres (hitRay.wgsl:8-24).
        if (p.has_volumes && S[4 + M_TYPE] == ISOTROPIC) continue;
        float r0, r1, disc;
        sphere_roots(o, d, S, r0, r1, disc);
        const bool near_ok = (r0 > t_min) && (r0 < t_max);
        const float root = near_ok ? r0 : r1;
        const bool ok = (disc >= 0.0f) && (root > t_min) && (root < t_max);
        const float ts = ok ? root : inf;
        if (ts < t_best) {
          t_best = ts;
          kind = K_SPHERE;
          sc = load3(S);
          mat = S + 4;
        }
      }

      for (int k = 0; k < p.n_quad; ++k) {
        // One-sided quad test (common.wgsl:148-187).
        const float* Q = quad + k * QUAD_COLS;
        const V3 q = load3(Q), u = load3(Q + 3), v = load3(Q + 6);
        const V3 n = load3(Q + 9), wv = load3(Q + 13);
        const float denom = n.x * d.x + n.y * d.y + n.z * d.z;
        const float tq = (Q[12] - (n.x * o.x + n.y * o.y + n.z * o.z)) / denom;
        const V3 rel = v3(o.x + tq * d.x - q.x, o.y + tq * d.y - q.y,
                          o.z + tq * d.z - q.z);
        const float alpha = dot3(wv, cross3(rel, v));
        const float beta = dot3(wv, cross3(u, rel));
        const bool ok = (denom <= 0.0f) && (fabsf(denom) >= 1e-8f) &&
                        (tq > t_min) && (tq < t_max) && (alpha >= 0.0f) &&
                        (alpha <= 1.0f) && (beta >= 0.0f) && (beta <= 1.0f);
        const float tqq = ok ? tq : inf;
        if (tqq < t_best) {
          t_best = tqq;
          kind = K_QUAD;
          qn = n;
          mat = Q + 16;
        }
      }

      for (int k = 0; k < p.n_tri; ++k) {
        // Möller-Trumbore with the reference's t_min barycentric guards
        // and the absolute DET_EPS parallel cull (kernels/intersect.py).
        const float* T = tri + k * TRI_COLS;
        const V3 a = load3(T), b = load3(T + 3), c = load3(T + 6);
        const V3 ab = v3(b.x - a.x, b.y - a.y, b.z - a.z);
        const V3 ac = v3(c.x - a.x, c.y - a.y, c.z - a.z);
        const V3 nt = v3(ab.y * ac.z - ab.z * ac.y, ab.z * ac.x - ab.x * ac.z,
                         ab.x * ac.y - ab.y * ac.x);
        const float det = -(d.x * nt.x + d.y * nt.y + d.z * nt.z);
        const V3 ao = v3(o.x - a.x, o.y - a.y, o.z - a.z);
        const V3 dao = cross3(ao, d);
        const bool det_ok = fabsf(det) >= DET_EPS;
        const float invd = 1.0f / (det_ok ? det : 1.0f);
        const float tt = (ao.x * nt.x + ao.y * nt.y + ao.z * nt.z) * invd;
        const float uu = (ac.x * dao.x + ac.y * dao.y + ac.z * dao.z) * invd;
        const float vv = -(ab.x * dao.x + ab.y * dao.y + ab.z * dao.z) * invd;
        const float ww = 1.0f - uu - vv;
        const bool okt = det_ok && (tt >= t_min) && (tt <= t_max) &&
                         (uu >= t_min) && (vv >= t_min) && (ww >= t_min);
        const float ttt = okt ? tt : inf;
        if (ttt < t_best) {
          t_best = ttt;
          kind = K_TRI;
          // Smooth barycentric shading normal (common.wgsl:230).
          tn = v3(T[9] * ww + T[12] * uu + T[15] * vv,
                  T[10] * ww + T[13] * uu + T[16] * vv,
                  T[11] * ww + T[14] * uu + T[17] * vv);
          mat = T + 18;
        }
      }

      if (p.has_volumes) {
        // Volumetric pass clipped by the running closest distance; one
        // uniform per sphere, in sphere order (kernels/hit.py find_hit).
        const float ray_len = sqrtf(fmaxf(dot3(d, d), 1e-20f));
        for (int k = 0; k < p.n_sph; ++k) {
          const float uv = pcg(state);
          const float* S = sph + k * SPH_COLS;
          float r0, r1, disc;
          sphere_roots(o, d, S, r0, r1, disc);
          bool ok = (disc >= 0.0f) && (r1 > r0 + 0.0001f);
          float rec1 = fmaxf(r0, t_min);
          const float rec2 = fminf(r1, t_best);
          ok = ok && (rec1 < rec2);
          rec1 = fmaxf(rec1, 0.0f);
          const float dist_inside = (rec2 - rec1) * ray_len;
          // neg_inv_density rides the roughness channel.
          const float hit_dist = S[4 + M_ROUGH] * logf(fmaxf(uv, 1e-12f));
          ok = ok && (hit_dist <= dist_inside);
          float tv = rec1 + hit_dist / ray_len;
          tv = ok ? tv : inf;
          if (S[4 + M_TYPE] != ISOTROPIC) tv = inf;
          if (tv < t_best) {
            t_best = tv;
            kind = K_VOLUME;
            sc = load3(S);
            mat = S + 4;
          }
        }
      }

      if (kind == K_MISS) {
        // Miss: background * throughput, the path ends
        // (traceRay.wgsl:12-16).
        rad_r = rad_r + p.bg_r * thr_r;
        rad_g = rad_g + p.bg_g * thr_g;
        rad_b = rad_b + p.bg_b * thr_b;
        state = pcg_skip(state, (uint32_t)tail_draws + later_draws);
        break;
      }

      // ---- shading frame (kernels/hit.py shade_hit).
      const V3 hp = v3(o.x + t_best * d.x, o.y + t_best * d.y,
                       o.z + t_best * d.z);
      V3 n;
      if (kind == K_QUAD) {
        n = qn;
      } else if (kind == K_TRI) {
        n = norm3(tn);
      } else {
        n = norm3(v3(hp.x - sc.x, hp.y - sc.y, hp.z - sc.z));
      }
      const bool front = (dot3(d, n) < 0.0f) || (kind == K_VOLUME);
      if (!front) n = v3(-n.x, -n.y, -n.z);

      // Front-face emission only (traceRay.wgsl:18-22).
      if (front) {
        rad_r = rad_r + mat[M_EMI + 0] * thr_r;
        rad_g = rad_g + mat[M_EMI + 1] * thr_g;
        rad_b = rad_b + mat[M_EMI + 2] * thr_b;
      }

      // ---- material_scatter: all 8 uniforms are drawn in order, only
      // the hit material's sampler is evaluated.
      const float r1 = pcg(state);
      const float r2 = pcg(state);
      const float u_spec = pcg(state);
      const float f1 = pcg(state);
      const float f2 = pcg(state);
      const float u_refl = pcg(state);
      const float u_hg = pcg(state);
      const float u_phi = pcg(state);
      const float sstr = mat[M_SSTR], rough = mat[M_ROUGH],
                  eta = mat[M_ETA], mtype = mat[M_TYPE];

      // Cosine-weighted diffuse direction in the normal's ONB
      // (importanceSampling.wgsl:35-67); NEE needs it for every lane.
      const bool big_x = fabsf(n.x) > 0.9f;
      const V3 ov = norm3(cross3(n, v3(big_x ? 0.0f : 1.0f,
                                       big_x ? 1.0f : 0.0f, 0.0f)));
      const V3 ou = cross3(n, ov);
      const float phi = TWO_PI * r1;
      const float sq = sqrtf(r2);
      const float lx = cosf(phi) * sq;
      const float ly = sinf(phi) * sq;
      const float lz = sqrtf(fmaxf(1.0f - r2, 0.0f));
      const V3 dd = norm3(v3(ou.x * lx + ov.x * ly + n.x * lz,
                             ou.y * lx + ov.y * ly + n.y * lz,
                             ou.z * lx + ov.z * ly + n.z * lz));

      V3 sd;
      bool skip_pdf = true;  // non-lambertian lanes always skip MIS
      float dsf = 0.0f;
      if (mtype == LAMBERTIAN) {
        const float do_spec = u_spec < sstr ? 1.0f : 0.0f;
        const V3 sp = norm3(mix3(reflect3(d, n), dd, rough));
        sd = norm3(mix3(dd, sp, do_spec));
        skip_pdf = do_spec > 0.5f;
        dsf = do_spec;
      } else if (mtype == MIRROR) {
        // Reflection plus roughness * a uniform direction on the sphere.
        const float fphi = f1 * TWO_PI;
        const float fcos = clampf(2.0f * f2 - 1.0f, -1.0f, 1.0f);
        const float fsin = sqrtf(fmaxf(1.0f - fcos * fcos, 0.0f));
        const V3 rf = reflect3(d, n);
        sd = norm3(v3(rf.x + rough * (fsin * cosf(fphi)),
                      rf.y + rough * (fsin * sinf(fphi)),
                      rf.z + rough * fcos));
      } else if (mtype == GLASS) {
        // Schlick / total internal reflection (scatterRay.wgsl:44-71).
        const float ir = front ? 1.0f / fmaxf(eta, 1e-8f) : eta;
        const V3 ud = norm3(d);
        const float cos_t = fminf(-dot3(ud, n), 1.0f);
        const float sin_t = safe_sqrt(1.0f - cos_t * cos_t);
        float r0s = (1.0f - ir) / (1.0f + ir);
        r0s = r0s * r0s;
        const float one_m = 1.0f - cos_t;
        const float schlick =
            r0s + (1.0f - r0s) * (one_m * one_m) * (one_m * one_m) * one_m;
        const bool must_reflect = (ir * sin_t > 1.0f) || (schlick > u_refl);
        if (must_reflect) {
          sd = norm3(reflect3(ud, n));
        } else {
          const V3 rp = v3(ir * (ud.x + cos_t * n.x),
                           ir * (ud.y + cos_t * n.y),
                           ir * (ud.z + cos_t * n.z));
          const float par = -safe_sqrt(1.0f - dot3(rp, rp));
          sd = norm3(v3(rp.x + par * n.x, rp.y + par * n.y,
                        rp.z + par * n.z));
        }
      } else {
        // ISOTROPIC: Henyey-Greenstein about the incident direction.
        const float g = sstr;
        const bool small_g = fabsf(g) < 1e-4f;
        const float safe_g = small_g ? 1.0f : g;
        const float frac = (1.0f - g * g) / (1.0f - g + 2.0f * g * u_hg);
        const float hg_gen = (1.0f + g * g - frac * frac) / (2.0f * safe_g);
        const float cos_hg =
            clampf(small_g ? 1.0f - 2.0f * u_hg : hg_gen, -1.0f, 1.0f);
        const float sin_hg = safe_sqrt(1.0f - cos_hg * cos_hg);
        const float hphi = TWO_PI * u_phi;
        const float hlx = sin_hg * cosf(hphi);
        const float hly = sin_hg * sinf(hphi);
        const V3 wu = norm3(d);
        const bool big_wx = fabsf(wu.x) > 0.9f;
        const V3 wv = norm3(cross3(wu, v3(big_wx ? 0.0f : 1.0f,
                                          big_wx ? 1.0f : 0.0f, 0.0f)));
        const V3 wx = cross3(wu, wv);
        sd = norm3(v3(wx.x * hlx + wv.x * hly + wu.x * cos_hg,
                      wx.y * hlx + wv.y * hly + wu.y * cos_hg,
                      wx.z * hlx + wv.z * hly + wu.z * cos_hg));
      }
      const float att_r = mixf(mat[0], mat[3], dsf);
      const float att_g = mixf(mat[1], mat[4], dsf);
      const float att_b = mixf(mat[2], mat[5], dsf);

      bool live = true;
      V3 nd = sd;
      float nthr_r = thr_r * att_r, nthr_g = thr_g * att_g,
            nthr_b = thr_b * att_b;
      if (p.use_nee) {
        // NEE/MIS mixing for diffuse lanes (traceRay.wgsl:26-57).
        const V3 lq = load3(light), lu = load3(light + 3),
                 lv = load3(light + 6);
        const float lr1 = pcg(state);
        const float lr2 = pcg(state);
        const V3 ld = norm3(v3(lq.x + lr1 * lu.x + lr2 * lv.x - hp.x,
                               lq.y + lr1 * lu.y + lr2 * lv.y - hp.y,
                               lq.z + lr1 * lu.z + lr2 * lv.z - hp.z));
        const float u_mix = pcg(state);
        if (!skip_pdf) {
          const V3 ch = u_mix > p.p_light ? dd : ld;
          const float lam_pdf = fmaxf(0.0f, dot3(ch, n) * INV_PI);
          // quad_light_pdf (importanceSampling.wgsl:88-125).
          const V3 nr = cross3(lu, lv);
          const float nn = nr.x * nr.x + nr.y * nr.y + nr.z * nr.z;
          const float n_len = sqrtf(fmaxf(nn, 1e-20f));
          const V3 ln = v3(nr.x / n_len, nr.y / n_len, nr.z / n_len);
          const float d_plane = ln.x * lq.x + ln.y * lq.y + ln.z * lq.z;
          const float inv_nn = 1.0f / fmaxf(nn, 1e-12f);
          const V3 lw = v3(nr.x * inv_nn, nr.y * inv_nn, nr.z * inv_nn);
          const float denom = ln.x * ch.x + ln.y * ch.y + ln.z * ch.z;
          const bool grazing = fabsf(denom) < 1e-8f;
          const float tl = (d_plane - (ln.x * hp.x + ln.y * hp.y +
                                       ln.z * hp.z)) /
                           (grazing ? 1.0f : denom);
          const V3 pr = v3(hp.x + tl * ch.x - lq.x, hp.y + tl * ch.y - lq.y,
                           hp.z + tl * ch.z - lq.z);
          const float alpha = dot3(lw, cross3(pr, lv));
          const float beta = dot3(lw, cross3(lu, pr));
          const bool valid = (denom <= 0.0f) && (fabsf(denom) >= 1e-8f) &&
                             (tl > 0.001f) && (tl < t_max) &&
                             (alpha >= 0.0f) && (alpha <= 1.0f) &&
                             (beta >= 0.0f) && (beta <= 1.0f);
          const float l_pdf =
              valid ? (tl * tl) / fmaxf(fabsf(denom) * n_len, 1e-12f)
                    : 0.0001f;
          const float pdf = p.p_light * l_pdf + (1.0f - p.p_light) * lam_pdf;
          const float mis_w = lam_pdf * (1.0f / fmaxf(pdf, 1e-12f));
          nd = ch;
          nthr_r = thr_r * mis_w * att_r;
          nthr_g = thr_g * mis_w * att_g;
          nthr_b = thr_b * mis_w * att_b;
          live = !(pdf <= 1e-5f);  // a degenerate pdf ends the path
        }
      }

      if (live) {
        thr_r = nthr_r;
        thr_g = nthr_g;
        thr_b = nthr_b;
        o = hp;
        d = nd;
      }

      // ---- Russian roulette (traceRay.wgsl:70-79).
      const float u_rr = pcg(state);
      if (live && bounce >= p.rr_start_bounce) {
        const float p_surv = fmaxf(fmaxf(thr_r, thr_g), thr_b);
        if (u_rr > p_surv) {
          live = false;
        } else {
          const float inv_p = 1.0f / fmaxf(p_surv, 1e-12f);
          thr_r = thr_r * inv_p;
          thr_g = thr_g * inv_p;
          thr_b = thr_b * inv_p;
        }
      }
      if (!live) {
        state = pcg_skip(state, later_draws);
        break;
      }
    }
    acc_r = acc_r + rad_r;
    acc_g = acc_g + rad_g;
    acc_b = acc_b + rad_b;
  }
  out[3 * i + 0] = acc_r * p.inv_spp;
  out[3 * i + 1] = acc_g * p.inv_spp;
  out[3 * i + 2] = acc_b * p.inv_spp;
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
  Params p;
  p.n_sph = n_sph;
  p.n_quad = n_quad;
  p.n_tri = n_tri;
  p.n = n;
  p.spp = spp;
  p.max_bounces = max_bounces;
  p.grid_n = grid_n;
  p.use_nee = use_nee;
  p.has_volumes = has_volumes;
  p.rr_start_bounce = rr_start_bounce;
  p.t_min = t_min;
  p.t_max = t_max;
  p.inf = inf;
  p.p_light = p_light;
  p.bg_r = bg_r;
  p.bg_g = bg_g;
  p.bg_b = bg_b;
  p.aspect = aspect;
  p.fov_factor = fov_factor;
  p.w = w;
  p.h = h;
  p.sub_scale = sub_scale;
  p.inv_spp = inv_spp;
  const size_t smem_bytes =
      sizeof(float) * (size_t)(n_sph * SPH_COLS + n_quad * QUAD_COLS +
                               n_tri * TRI_COLS + LIGHT_COLS + CAM_COLS);
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
