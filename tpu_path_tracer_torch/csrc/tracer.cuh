// The path tracer shared by the forward and backward megakernels.
//
// Counterpart of tpu_path_tracer/kernels/pallas/megakernel.py::_make_tracer,
// the one tracer body that the JAX package's two kernels share.  Everything
// here is a __host__ __device__ function of one pixel's state, so both
// kernels (megakernel_fwd.cu, megakernel_bwd.cu) run the same arithmetic and
// take the same branch decisions.  Without nvcc (a plain C++ compiler) the
// same code builds for the CPU, which lets the arithmetic be checked there.
//
// Semantics contract (megakernel.py:23-28): draw for draw the same PCG
// stream as the wavefront integrator.  Per bounce: one volume draw per
// sphere when the scene has volumes; 8 material_scatter draws (r1, r2,
// u_spec, f1, f2, u_refl, u_hg, u_phi); 3 NEE draws (lr1, lr2, u_mix) when
// NEE is on; 1 Russian-roulette draw.  Each sample first draws 2 camera
// uniforms.  A retired lane of the wavefront keeps drawing through every
// remaining bounce, so the next sample's camera jitter starts from that
// advanced state: pcg_skip reproduces it.
//
// Bit-level choices, kept so branch decisions (glass, fog, roulette) agree
// with the JAX kernel and the plain torch version:
//   * built without --use_fast_math and with --fmad=false: neither
//     reference fuses a*b+c, and a different rounding flips branches;
//   * 1.0f / sqrtf(x), never rsqrtf (megakernel.py:100-104);
//   * the u32 -> f32 conversion rounds to nearest even, like
//     astype(float32);
//   * the literal constants of the JAX kernel are kept as they are.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define TPT_HD __host__ __device__ __forceinline__
#else
#include <math.h>
#define TPT_HD inline
#endif

namespace tpt {

constexpr int SPH_COLS = 17;    // cx cy cz r | mat13
constexpr int QUAD_COLS = 29;   // q3 u3 v3 n3 d w3 | mat13
constexpr int TRI_COLS = 31;    // a3 b3 c3 na3 nb3 nc3 | mat13
constexpr int LIGHT_COLS = 9;   // q3 u3 v3
constexpr int CAM_COLS = 16;    // row-major 4x4 view matrix
// Where the 13-column material row starts in each family's row.
constexpr int SPH_MAT = 4, QUAD_MAT = 16, TRI_MAT = 18;
// Material row: col3 spec3 emi3 sstr rough eta mtype.
constexpr int M_SPEC = 3, M_EMI = 6, M_SSTR = 9, M_ROUGH = 10, M_ETA = 11,
              M_TYPE = 12;

constexpr float LAMBERTIAN = 0.0f, MIRROR = 1.0f, GLASS = 2.0f,
                ISOTROPIC = 3.0f;
constexpr float PI_F = (float)3.1415926535897932385;
constexpr float INV_PI = (float)(1.0 / 3.1415926535897932385);
constexpr float TWO_PI = (float)(2.0 * 3.1415926535897932385);
constexpr float DET_EPS = 1e-12f;
constexpr float MIN_FLOAT = 0.0001f;

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

// The packed scene tables, in the order of the flat buffer, and the
// invariants the kernels derive from them once per block (prepare_scene):
// each triangle's edges ab, ac and normal ab x ac, each sphere's R * R and
// the light quad's plane (light_pre), with the expressions the tests had
// when they computed them per ray, so every result keeps its bits.  Only a
// scene's tables carry invariants; a gradient buffer of the tables' layout
// leaves those pointers unused.
template <typename T>
struct Tables {
  T* sph;
  T* quad;
  T* tri;
  T* light;
  T* cam;
  T* tri_pre;    // [n_tri, TRI_PRE]: ab3 ac3 nt3
  T* sph_rr;     // [n_sph]: R * R
  T* light_pre;  // [LIGHT_PRE]
};

constexpr int TRI_PRE = 9;
// Light plane: nr = u x v (3), ln = normalize(nr) (3), ln . q,
// nr / (nr . nr) (3), |nr|.
constexpr int LIGHT_PRE = 11;
constexpr int L_NR = 0, L_LN = 3, L_DPLANE = 6, L_W = 7, L_AREA = 10;

TPT_HD int table_floats(const Params& p) {
  return p.n_sph * SPH_COLS + p.n_quad * QUAD_COLS + p.n_tri * TRI_COLS +
         LIGHT_COLS + CAM_COLS;
}

// Floats of the tables followed by their invariants.
TPT_HD int scene_floats(const Params& p) {
  return table_floats(p) + p.n_tri * TRI_PRE + p.n_sph + LIGHT_PRE;
}

template <typename T>
TPT_HD Tables<T> tables_at(T* base, const Params& p) {
  Tables<T> t;
  t.sph = base;
  t.quad = t.sph + p.n_sph * SPH_COLS;
  t.tri = t.quad + p.n_quad * QUAD_COLS;
  t.light = t.tri + p.n_tri * TRI_COLS;
  t.cam = t.light + LIGHT_COLS;
  t.tri_pre = t.cam + CAM_COLS;
  t.sph_rr = t.tri_pre + p.n_tri * TRI_PRE;
  t.light_pre = t.sph_rr + p.n_sph;
  return t;
}

struct V3 {
  float x, y, z;
};

TPT_HD V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}

TPT_HD V3 add3(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
TPT_HD V3 sub3(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
TPT_HD V3 scale3(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }

TPT_HD float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

TPT_HD V3 cross3(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}

TPT_HD V3 norm3(V3 v) {
  float inv = 1.0f / sqrtf(fmaxf(dot3(v, v), 1e-20f));
  return v3(v.x * inv, v.y * inv, v.z * inv);
}

TPT_HD V3 reflect3(V3 d, V3 n) {
  float k = 2.0f * dot3(d, n);
  return v3(d.x - k * n.x, d.y - k * n.y, d.z - k * n.z);
}

TPT_HD float mixf(float a, float b, float t) { return a + (b - a) * t; }

TPT_HD V3 mix3(V3 a, V3 b, float t) {
  return v3(mixf(a.x, b.x, t), mixf(a.y, b.y, t), mixf(a.z, b.z, t));
}

TPT_HD float safe_sqrt(float x) { return x > 0.0f ? sqrtf(x) : 0.0f; }

TPT_HD float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

TPT_HD V3 load3(const float* p) { return v3(p[0], p[1], p[2]); }

TPT_HD float u32_to_f32(uint32_t w) {
#ifdef __CUDA_ARCH__
  return __uint2float_rn(w);
#else
  return (float)w;  // round to nearest even, the default rounding mode
#endif
}

// One PCG step: advance, then hash the new state (core/rng.py:43-51).
TPT_HD float pcg(uint32_t& s) {
  s = s * PCG_MULT + PCG_INC;
  uint32_t word = ((s >> ((s >> 28) + 4u)) ^ s) * PCG_XSH;
  return u32_to_f32((word >> 22) ^ word) * INV_U32;
}

// Advance the LCG by k steps in O(log k) (Brown, "Random number generation
// with arbitrary strides").
TPT_HD uint32_t pcg_skip(uint32_t s, uint32_t k) {
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

// PCG draws a bounce makes after its hit search.
TPT_HD int tail_draws(const Params& p) { return 8 + (p.use_nee ? 3 : 0) + 1; }

TPT_HD int draws_per_bounce(const Params& p) {
  return (p.has_volumes ? p.n_sph : 0) + tail_draws(p);
}

// Both roots of ray/sphere and the discriminant (intersect.sphere_roots),
// from the ray's a = d . d and 1 / a and the sphere's R * R: the hit search
// derives the first two once per ray, the tables the third once per block.
TPT_HD void sphere_roots_pre(V3 o, V3 d, float a, float inv_a, const float* S,
                             float rr, float& r0, float& r1, float& disc) {
  V3 oc = v3(o.x - S[0], o.y - S[1], o.z - S[2]);
  float half_b = dot3(d, oc);
  float c = dot3(oc, oc) - rr;
  disc = half_b * half_b - a * c;
  float sq = safe_sqrt(disc);
  r0 = (-half_b - sq) * inv_a;
  r1 = (-half_b + sq) * inv_a;
}

TPT_HD void sphere_roots(V3 o, V3 d, const float* S, float& r0, float& r1,
                         float& disc) {
  const float a = dot3(d, d);
  sphere_roots_pre(o, d, a, 1.0f / a, S, S[3] * S[3], r0, r1, disc);
}

// The edges ab, ac and the normal ab x ac of the triangle whose corners
// a, b, c (9 floats) T points at, into E (TRI_PRE floats).
TPT_HD void triangle_edges(const float* T, float* E) {
  const V3 a = load3(T), b = load3(T + 3), c = load3(T + 6);
  const V3 ab = v3(b.x - a.x, b.y - a.y, b.z - a.z);
  const V3 ac = v3(c.x - a.x, c.y - a.y, c.z - a.z);
  const V3 nt = v3(ab.y * ac.z - ab.z * ac.y, ab.z * ac.x - ab.x * ac.z,
                   ab.x * ac.y - ab.y * ac.x);
  const float e[TRI_PRE] = {ab.x, ab.y, ab.z, ac.x, ac.y, ac.z,
                            nt.x, nt.y, nt.z};
  for (int k = 0; k < TRI_PRE; ++k) E[k] = e[k];
}

// Möller-Trumbore with the reference's t_min barycentric guards and the
// absolute DET_EPS parallel cull (kernels/intersect.py triangle_t), the
// hit accepted for t in [t_min, t_max], from the first corner a and the
// triangle's triangle_edges E.  Returns whether the ray hits; tt, uu, vv,
// ww are the distance and barycentrics.
TPT_HD bool triangle_mt_pre(V3 a, const float* E, V3 o, V3 d, float t_min,
                            float t_max, float& tt, float& uu, float& vv,
                            float& ww) {
  const V3 ab = load3(E), ac = load3(E + 3), nt = load3(E + 6);
  const float det = -(d.x * nt.x + d.y * nt.y + d.z * nt.z);
  const V3 ao = v3(o.x - a.x, o.y - a.y, o.z - a.z);
  const V3 dao = cross3(ao, d);
  const bool det_ok = fabsf(det) >= DET_EPS;
  const float invd = 1.0f / (det_ok ? det : 1.0f);
  tt = (ao.x * nt.x + ao.y * nt.y + ao.z * nt.z) * invd;
  uu = (ac.x * dao.x + ac.y * dao.y + ac.z * dao.z) * invd;
  vv = -(ab.x * dao.x + ab.y * dao.y + ab.z * dao.z) * invd;
  ww = 1.0f - uu - vv;
  return det_ok && (tt >= t_min) && (tt <= t_max) && (uu >= t_min) &&
         (vv >= t_min) && (ww >= t_min);
}

// The same from the corners alone (the traversal kernel's test).
TPT_HD bool triangle_mt(const float* T, V3 o, V3 d, float t_min, float t_max,
                        float& tt, float& uu, float& vv, float& ww) {
  float E[TRI_PRE];
  triangle_edges(T, E);
  return triangle_mt_pre(load3(T), E, o, d, t_min, t_max, tt, uu, vv, ww);
}

// The megakernel's test of triangle k of the packed table, bounded by the
// scene's t range.
TPT_HD bool triangle_test(const Params& p, const Tables<const float>& S,
                          int k, V3 o, V3 d, float& tt, float& uu, float& vv,
                          float& ww) {
  return triangle_mt_pre(load3(S.tri + k * TRI_COLS), S.tri_pre + k * TRI_PRE,
                         o, d, p.t_min, p.t_max, tt, uu, vv, ww);
}

// Invariant k of prepare_scene's list: triangles, spheres, then the light.
TPT_HD int scene_invariants(const Params& p) {
  return p.n_tri + p.n_sph + 1;
}

// Writes invariant k (k < scene_invariants(p)) of the tables at base into
// the space after them.  The kernels split k over a block's threads.
TPT_HD void prepare_scene(const Params& p, float* base, int k) {
  const Tables<float> S = tables_at<float>(base, p);
  if (k < p.n_tri) {
    triangle_edges(S.tri + k * TRI_COLS, S.tri_pre + k * TRI_PRE);
    return;
  }
  k -= p.n_tri;
  if (k < p.n_sph) {
    const float R = S.sph[k * SPH_COLS + 3];
    S.sph_rr[k] = R * R;
    return;
  }
  // quad_light_pdf's plane (importanceSampling.wgsl:88-125, lights.py).
  const V3 lq = load3(S.light), lu = load3(S.light + 3),
           lv = load3(S.light + 6);
  const V3 nr = cross3(lu, lv);
  const V3 ln = norm3(nr);
  const float nn = dot3(nr, nr);
  const float L[LIGHT_PRE] = {nr.x, nr.y, nr.z, ln.x, ln.y, ln.z,
                              dot3(ln, lq), nr.x / nn, nr.y / nn, nr.z / nn,
                              sqrtf(fmaxf(nn, 0.0f))};
  for (int j = 0; j < LIGHT_PRE; ++j) S.light_pre[j] = L[j];
}

// The winner of one hit search.
struct Hit {
  int kind;     // Kind
  int idx;      // row of the winner in its family's table
  float t;      // distance along the ray
  float vol_u;  // the uniform that placed a volume event
};

// Closest hit (kernels/hit.py find_hit): solid spheres, one-sided quads,
// triangles, then the volumetric pass clipped by the running closest
// distance, drawing one uniform per sphere in sphere order.  Strict <
// keeps the earlier primitive on ties.
TPT_HD Hit find_hit(const Params& p, const Tables<const float>& S, V3 o, V3 d,
                    uint32_t& state) {
  const float t_min = p.t_min, t_max = p.t_max, inf = p.inf;
  Hit h;
  h.t = inf;
  h.kind = K_MISS;
  h.idx = 0;
  h.vol_u = 0.0f;
  const float a = dot3(d, d), inv_a = 1.0f / a;

  for (int k = 0; k < p.n_sph; ++k) {
    const float* Sr = S.sph + k * SPH_COLS;
    // Solid pass skips ISOTROPIC spheres (hitRay.wgsl:8-24).
    if (p.has_volumes && Sr[SPH_MAT + M_TYPE] == ISOTROPIC) continue;
    float r0, r1, disc;
    sphere_roots_pre(o, d, a, inv_a, Sr, S.sph_rr[k], r0, r1, disc);
    const bool near_ok = (r0 > t_min) && (r0 < t_max);
    const float root = near_ok ? r0 : r1;
    const bool ok = (disc >= 0.0f) && (root > t_min) && (root < t_max);
    const float ts = ok ? root : inf;
    if (ts < h.t) {
      h.t = ts;
      h.kind = K_SPHERE;
      h.idx = k;
    }
  }

  for (int k = 0; k < p.n_quad; ++k) {
    // One-sided quad test (common.wgsl:148-187).
    const float* Q = S.quad + k * QUAD_COLS;
    const V3 q = load3(Q), u = load3(Q + 3), v = load3(Q + 6);
    const V3 n = load3(Q + 9), wv = load3(Q + 13);
    const float denom = n.x * d.x + n.y * d.y + n.z * d.z;
    // A back face or a parallel ray misses: no division for it.
    if (!((denom <= 0.0f) && (fabsf(denom) >= 1e-8f))) continue;
    const float tq = (Q[12] - (n.x * o.x + n.y * o.y + n.z * o.z)) / denom;
    const V3 rel = v3(o.x + tq * d.x - q.x, o.y + tq * d.y - q.y,
                      o.z + tq * d.z - q.z);
    const float alpha = dot3(wv, cross3(rel, v));
    const float beta = dot3(wv, cross3(u, rel));
    const bool ok = (tq > t_min) && (tq < t_max) && (alpha >= 0.0f) &&
                    (alpha <= 1.0f) && (beta >= 0.0f) && (beta <= 1.0f);
    const float tqq = ok ? tq : inf;
    if (tqq < h.t) {
      h.t = tqq;
      h.kind = K_QUAD;
      h.idx = k;
    }
  }

  for (int k = 0; k < p.n_tri; ++k) {
    float tt, uu, vv, ww;
    const bool okt = triangle_test(p, S, k, o, d, tt, uu, vv, ww);
    const float ttt = okt ? tt : inf;
    if (ttt < h.t) {
      h.t = ttt;
      h.kind = K_TRI;
      h.idx = k;
    }
  }

  if (p.has_volumes) {
    const float ray_len = sqrtf(fmaxf(a, 1e-20f));
    for (int k = 0; k < p.n_sph; ++k) {
      // Every sphere draws its uniform, in sphere order; only an
      // ISOTROPIC one can place an event, so only those test the ray.
      const float uv = pcg(state);
      const float* Sr = S.sph + k * SPH_COLS;
      if (Sr[SPH_MAT + M_TYPE] != ISOTROPIC) continue;
      float r0, r1, disc;
      sphere_roots_pre(o, d, a, inv_a, Sr, S.sph_rr[k], r0, r1, disc);
      bool ok = (disc >= 0.0f) && (r1 > r0 + 0.0001f);
      float rec1 = fmaxf(r0, t_min);
      const float rec2 = fminf(r1, h.t);
      ok = ok && (rec1 < rec2);
      if (!ok) continue;  // no span of the sphere before the closest hit
      rec1 = fmaxf(rec1, 0.0f);
      const float dist_inside = (rec2 - rec1) * ray_len;
      // neg_inv_density rides the roughness channel.
      const float hit_dist = Sr[SPH_MAT + M_ROUGH] * logf(fmaxf(uv, 1e-12f));
      if (!(hit_dist <= dist_inside)) continue;
      const float tv = rec1 + hit_dist / ray_len;
      if (tv < h.t) {
        h.t = tv;
        h.kind = K_VOLUME;
        h.idx = k;
        h.vol_u = uv;
      }
    }
  }
  return h;
}

// Row of the winner and the offset of its material row, in floats from
// the start of the packed tables.
TPT_HD int hit_row_offset(const Params& p, const Hit& h) {
  switch (h.kind) {
    case K_SPHERE:
    case K_VOLUME:
      return h.idx * SPH_COLS;
    case K_QUAD:
      return p.n_sph * SPH_COLS + h.idx * QUAD_COLS;
    default:
      return p.n_sph * SPH_COLS + p.n_quad * QUAD_COLS + h.idx * TRI_COLS;
  }
}

// Where the material starts in the winner's row, and the row's width.
TPT_HD int hit_mat_col(const Hit& h) {
  return (h.kind == K_QUAD) ? QUAD_MAT : (h.kind == K_TRI) ? TRI_MAT : SPH_MAT;
}

TPT_HD int hit_cols(const Hit& h) {
  return (h.kind == K_QUAD) ? QUAD_COLS : (h.kind == K_TRI) ? TRI_COLS
                                                            : SPH_COLS;
}

TPT_HD int hit_mat_offset(const Params& p, const Hit& h) {
  return hit_row_offset(p, h) + hit_mat_col(h);
}

// Everything one bounce of a hit lane computes after its hit search
// (kernels/hit.py shade_hit, integrator/bsdf.py material_scatter, the NEE
// block of integrator/path_tracer.py and Russian roulette).  The forward
// kernel uses the outputs; the backward kernel also reads the
// intermediates and decisions.
struct Shade {
  V3 hp;        // hit point o + t d
  V3 n;         // shading normal, flipped to face the ray
  bool front;   // front face (always for a volume event)
  const float* mat;
  // Henyey-Greenstein draws and the cosine-weighted sample in the
  // normal's frame.
  float u_hg, u_phi;
  float lx, ly, lz;
  V3 fz;        // mirror fuzz direction
  V3 dd;        // diffuse direction (NEE mixes it in)
  V3 sd;        // sampled direction of the hit material
  float dsf;    // 1 when a lambertian lane took its specular lobe
  bool must_reflect;  // glass: reflect rather than refract
  // NEE (when p.use_nee).
  float lr1, lr2, u_mix;
  V3 ld;        // direction to the light sample
  V3 ch;        // chosen direction (dd or ld)
  float lam_pdf, pdf;
  bool valid;   // the chosen direction reaches the light quad
  bool use_mis;
  // Outputs.
  bool live;    // the path goes on (before roulette)
  V3 nd;        // new direction
  float nthr[3];  // new throughput (before roulette)
  float u_rr;
};

TPT_HD V3 hit_point(V3 o, V3 d, float t) {
  return v3(o.x + t * d.x, o.y + t * d.y, o.z + t * d.z);
}

// Unflipped shading normal of the winner at hit point hp.
TPT_HD V3 hit_normal(const Params& p, const Tables<const float>& S,
                     const Hit& h, V3 o, V3 d, V3 hp) {
  if (h.kind == K_QUAD) return load3(S.quad + h.idx * QUAD_COLS + 9);
  if (h.kind == K_TRI) {
    // Smooth barycentric shading normal (common.wgsl:230).
    const float* T = S.tri + h.idx * TRI_COLS;
    float tt, uu, vv, ww;
    triangle_test(p, S, h.idx, o, d, tt, uu, vv, ww);
    return norm3(v3(T[9] * ww + T[12] * uu + T[15] * vv,
                    T[10] * ww + T[13] * uu + T[16] * vv,
                    T[11] * ww + T[14] * uu + T[17] * vv));
  }
  const float* Sr = S.sph + h.idx * SPH_COLS;
  if (h.kind == K_VOLUME) {
    return norm3(v3(hp.x - Sr[0], hp.y - Sr[1], hp.z - Sr[2]));
  }
  const float R = Sr[3];  // common.wgsl:60
  return norm3(v3((hp.x - Sr[0]) / R, (hp.y - Sr[1]) / R, (hp.z - Sr[2]) / R));
}

// The bounce of a lane whose hit search found h, from ray (o, d) with
// throughput thr; draws the bounce's tail from state.
TPT_HD void shade(const Params& p, const Tables<const float>& S, const Hit& h,
                  V3 o, V3 d, const float thr[3], uint32_t& state, Shade& s) {
  s.hp = hit_point(o, d, h.t);
  V3 n = hit_normal(p, S, h, o, d, s.hp);
  s.front = (dot3(d, n) < 0.0f) || (h.kind == K_VOLUME);
  if (!s.front) n = v3(-n.x, -n.y, -n.z);
  s.n = n;
  const float* mat = S.sph + hit_mat_offset(p, h);
  s.mat = mat;

  // ---- material_scatter: all 8 uniforms are drawn in order, only the
  // hit material's sampler is evaluated.
  const float r1 = pcg(state);
  const float r2 = pcg(state);
  const float u_spec = pcg(state);
  const float f1 = pcg(state);
  const float f2 = pcg(state);
  const float u_refl = pcg(state);
  s.u_hg = pcg(state);
  s.u_phi = pcg(state);
  const float sstr = mat[M_SSTR], rough = mat[M_ROUGH], eta = mat[M_ETA],
              mtype = mat[M_TYPE];

  // Cosine-weighted diffuse direction in the normal's ONB
  // (importanceSampling.wgsl:35-67, vecmath.onb_from_w); NEE needs it for
  // every lane.
  const V3 wn = norm3(n);
  const bool big_x = fabsf(wn.x) > 0.9f;
  const V3 ov = norm3(cross3(wn, v3(big_x ? 0.0f : 1.0f,
                                    big_x ? 1.0f : 0.0f, 0.0f)));
  const V3 ou = cross3(wn, ov);
  const float phi = TWO_PI * r1;
  const float sq = sqrtf(r2);
  s.lx = cosf(phi) * sq;
  s.ly = sinf(phi) * sq;
  s.lz = sqrtf(fmaxf(1.0f - r2, 0.0f));
  const V3 dd = norm3(v3(ou.x * s.lx + ov.x * s.ly + wn.x * s.lz,
                         ou.y * s.lx + ov.y * s.ly + wn.y * s.lz,
                         ou.z * s.lx + ov.z * s.ly + wn.z * s.lz));
  s.dd = dd;

  V3 sd;
  bool skip_pdf = true;  // non-lambertian lanes always skip MIS
  float dsf = 0.0f;
  s.must_reflect = false;
  if (mtype == LAMBERTIAN) {
    const float do_spec = u_spec < sstr ? 1.0f : 0.0f;
    const V3 sp = norm3(mix3(reflect3(d, n), dd, rough));
    sd = norm3(mix3(dd, sp, do_spec));
    skip_pdf = do_spec > 0.5f;
    dsf = do_spec;
  } else if (mtype == MIRROR) {
    // Reflection plus roughness * a uniform direction on the sphere
    // (rng.uniform_in_unit_sphere).
    const float fphi = f1 * TWO_PI;
    const float theta = acosf(clampf(2.0f * f2 - 1.0f, -1.0f, 1.0f));
    const float fsin = sinf(theta);
    s.fz = norm3(v3(fsin * cosf(fphi), fsin * sinf(fphi), cosf(theta)));
    const V3 rf = reflect3(d, n);
    sd = norm3(v3(rf.x + rough * s.fz.x, rf.y + rough * s.fz.y,
                  rf.z + rough * s.fz.z));
  } else if (mtype == GLASS) {
    // Schlick / total internal reflection (scatterRay.wgsl:44-71).
    const float ir = s.front ? 1.0f / fmaxf(eta, 1e-8f) : eta;
    const V3 ud = norm3(d);
    const float cos_t = fminf(-dot3(ud, n), 1.0f);
    const float sin_t = safe_sqrt(1.0f - cos_t * cos_t);
    float r0s = (1.0f - ir) / (1.0f + ir);
    r0s = r0s * r0s;
    const float one_m = 1.0f - cos_t;
    const float schlick =
        r0s + (1.0f - r0s) * (one_m * one_m) * (one_m * one_m) * one_m;
    s.must_reflect = (ir * sin_t > 1.0f) || (schlick > u_refl);
    if (s.must_reflect) {
      sd = norm3(reflect3(ud, n));
    } else {
      const V3 rp = v3(ir * (ud.x + cos_t * n.x), ir * (ud.y + cos_t * n.y),
                       ir * (ud.z + cos_t * n.z));
      const float par = -safe_sqrt(1.0f - dot3(rp, rp));
      sd = norm3(v3(rp.x + par * n.x, rp.y + par * n.y, rp.z + par * n.z));
    }
  } else {
    // ISOTROPIC: Henyey-Greenstein about the incident direction.
    const float g = sstr;
    const bool small_g = fabsf(g) < 1e-4f;
    const float safe_g = small_g ? 1.0f : g;
    const float frac = (1.0f - g * g) / (1.0f - g + 2.0f * g * s.u_hg);
    const float hg_gen = (1.0f + g * g - frac * frac) / (2.0f * safe_g);
    const float cos_hg =
        clampf(small_g ? 1.0f - 2.0f * s.u_hg : hg_gen, -1.0f, 1.0f);
    const float sin_hg = safe_sqrt(1.0f - cos_hg * cos_hg);
    const float hphi = TWO_PI * s.u_phi;
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
  s.sd = sd;
  s.dsf = dsf;
  const float att_r = mixf(mat[0], mat[3], dsf);
  const float att_g = mixf(mat[1], mat[4], dsf);
  const float att_b = mixf(mat[2], mat[5], dsf);

  s.live = true;
  s.use_mis = false;
  s.nd = sd;
  s.nthr[0] = thr[0] * att_r;
  s.nthr[1] = thr[1] * att_g;
  s.nthr[2] = thr[2] * att_b;
  if (p.use_nee) {
    // NEE/MIS mixing for diffuse lanes (traceRay.wgsl:26-57).
    const V3 lq = load3(S.light), lu = load3(S.light + 3),
             lv = load3(S.light + 6);
    const V3 hp = s.hp;
    s.lr1 = pcg(state);
    s.lr2 = pcg(state);
    s.ld = norm3(v3(lq.x + s.lr1 * lu.x + s.lr2 * lv.x - hp.x,
                    lq.y + s.lr1 * lu.y + s.lr2 * lv.y - hp.y,
                    lq.z + s.lr1 * lu.z + s.lr2 * lv.z - hp.z));
    s.u_mix = pcg(state);
    if (!skip_pdf) {
      s.use_mis = true;
      const V3 ch = s.u_mix > p.p_light ? dd : s.ld;
      s.ch = ch;
      // lambertian_pdf against the shading normal (bsdf.py).
      const float lam_pdf = fmaxf(dot3(norm3(ch), norm3(n)) / PI_F, 0.0f);
      // quad_light_pdf, on the plane prepare_scene derived.
      const float* L = S.light_pre;
      const V3 ln = load3(L + L_LN);
      const float d_plane = L[L_DPLANE];
      const V3 lw = load3(L + L_W);
      const float denom = dot3(ln, ch);
      const bool grazing = fabsf(denom) < 1e-8f;
      const float tl = (d_plane - dot3(ln, hp)) / (grazing ? 1.0f : denom);
      const V3 pr = v3(hp.x + tl * ch.x - lq.x, hp.y + tl * ch.y - lq.y,
                       hp.z + tl * ch.z - lq.z);
      const float alpha = dot3(lw, cross3(pr, lv));
      const float beta = dot3(lw, cross3(lu, pr));
      s.valid = (dot3(ch, ln) <= 0.0f) && (fabsf(denom) >= 1e-8f) &&
                (tl > 0.001f) && (tl < p.t_max) && (alpha >= 0.0f) &&
                (alpha <= 1.0f) && (beta >= 0.0f) && (beta <= 1.0f);
      const float dist_sq = tl * tl * dot3(ch, ch);
      const float cosine =
          fabsf(denom) / fmaxf(sqrtf(fmaxf(dot3(ch, ch), 0.0f)), 1e-12f);
      const float area = L[L_AREA];
      const float l_pdf =
          s.valid ? dist_sq / fmaxf(cosine * area, 1e-12f) : MIN_FLOAT;
      const float pdf = p.p_light * l_pdf + (1.0f - p.p_light) * lam_pdf;
      const float pdf_c = fmaxf(pdf, 1e-12f);
      s.lam_pdf = lam_pdf;
      s.pdf = pdf;
      s.nd = ch;
      s.nthr[0] = thr[0] * ((lam_pdf * att_r) / pdf_c);
      s.nthr[1] = thr[1] * ((lam_pdf * att_g) / pdf_c);
      s.nthr[2] = thr[2] * ((lam_pdf * att_b) / pdf_c);
      s.live = !(pdf <= 1e-5f);  // a degenerate pdf ends the path
    }
  }
  // ---- Russian roulette draw (traceRay.wgsl:70-79).
  s.u_rr = pcg(state);
}

// Russian roulette on the throughput after the bounce: returns whether
// the path survives and compensates the survivor's throughput by 1/p.
TPT_HD bool roulette(const Params& p, int bounce, float u_rr, float thr[3]) {
  if (bounce < p.rr_start_bounce) return true;
  const float p_surv = fmaxf(fmaxf(thr[0], thr[1]), thr[2]);
  if (u_rr > p_surv) return false;
  const float p_c = fmaxf(p_surv, 1e-12f);
  thr[0] = thr[0] / p_c;
  thr[1] = thr[1] / p_c;
  thr[2] = thr[2] / p_c;
  return true;
}

// Camera ray of sample smp (integrator.render.camera_rays); s and t are the
// screen coordinates, x the unnormalized direction.
TPT_HD void camera_ray(const Params& p, const float* cam, int smp,
                       uint32_t& state, float pxf, float pyf, float& s,
                       float& t, V3& x) {
  const float u1 = pcg(state);
  const float u2 = pcg(state);
  float jx = u1, jy = u2;
  if (p.grid_n > 0) {  // stratified sub-pixel grid
    jx = p.sub_scale * ((float)(smp / p.grid_n) + u1);
    jy = p.sub_scale * ((float)(smp % p.grid_n) + u2);
  }
  s = p.aspect * (2.0f * ((pxf - 0.5f + jx) / p.w) - 1.0f);
  t = -(2.0f * ((pyf - 0.5f + jy) / p.h) - 1.0f);
  // Camera basis columns (shootRay.wgsl:54-60).
  x = v3(s * cam[0] + t * cam[1] - p.fov_factor * cam[2],
         s * cam[4] + t * cam[5] - p.fov_factor * cam[6],
         s * cam[8] + t * cam[9] - p.fov_factor * cam[10]);
}

// The forward trace of one pixel: radiance averaged over its samples.
TPT_HD void trace_pixel(const Params& p, const Tables<const float>& S,
                        uint32_t state, float pxf, float pyf, float out[3]) {
  const V3 eye = v3(S.cam[3], S.cam[7], S.cam[11]);
  const int dpb = draws_per_bounce(p);
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int smp = 0; smp < p.spp; ++smp) {
    float cs, ct;
    V3 x;
    camera_ray(p, S.cam, smp, state, pxf, pyf, cs, ct, x);
    V3 d = norm3(x);
    V3 o = eye;
    float rad[3] = {0.0f, 0.0f, 0.0f};
    float thr[3] = {1.0f, 1.0f, 1.0f};
    for (int bounce = 0; bounce < p.max_bounces; ++bounce) {
      const uint32_t later_draws =
          (uint32_t)(p.max_bounces - bounce - 1) * (uint32_t)dpb;
      const Hit h = find_hit(p, S, o, d, state);
      if (h.kind == K_MISS) {
        // Miss: background * throughput, the path ends
        // (traceRay.wgsl:12-16).
        rad[0] = rad[0] + p.bg_r * thr[0];
        rad[1] = rad[1] + p.bg_g * thr[1];
        rad[2] = rad[2] + p.bg_b * thr[2];
        state = pcg_skip(state, (uint32_t)tail_draws(p) + later_draws);
        break;
      }
      Shade s;
      shade(p, S, h, o, d, thr, state, s);
      // Front-face emission only (traceRay.wgsl:18-22).
      if (s.front) {
        for (int k = 0; k < 3; ++k) rad[k] = rad[k] + s.mat[M_EMI + k] * thr[k];
      }
      bool live = s.live;
      if (live) {
        for (int k = 0; k < 3; ++k) thr[k] = s.nthr[k];
        o = s.hp;
        d = s.nd;
        live = roulette(p, bounce, s.u_rr, thr);
      }
      if (!live) {
        state = pcg_skip(state, later_draws);
        break;
      }
    }
    for (int k = 0; k < 3; ++k) acc[k] = acc[k] + rad[k];
  }
  out[0] = acc[0] * p.inv_spp;
  out[1] = acc[1] * p.inv_spp;
  out[2] = acc[2] * p.inv_spp;
}

}  // namespace tpt
