// Backward path-tracing megakernel for Hopper (sm_90a): a hand-written
// adjoint of the forward megakernel.
//
// Replaces the TPU kernel tpu_path_tracer/kernels/pallas/megakernel.py::
// _bwd_call, which differentiates the unrolled tracer with jax.grad inside
// the kernel.  Hopper has no in-kernel autodiff, so the adjoint is written
// out here.  Given the radiance cotangent g [N, 3], it returns the
// gradient of sum(radiance * g) with respect to the five packed tables
// (sph, quad, tri, light, cam), summed over pixels.
//
// Gradient semantics are those of autograd through the wavefront
// integrator (integrator/path_tracer.py), the plain version: the hit search
// and every PCG draw are detached, every torch.where follows the branch it
// took, Russian-roulette compensation and the NEE pdf chain are attached,
// torch.clamp passes the whole gradient at its bound, and torch.amax splits
// it evenly between tied channels.  Where the wavefront recomputes a value
// with another formula than the forward kernel (normalize(n) in the ONB,
// the sphere normal over its radius, |chosen| in the light pdf) the adjoint
// follows the wavefront's formula, evaluated at the kernel's values.
//
// Design: one thread per pixel.  For each sample the thread replays the
// forward (tracer.cuh, the same code as the forward kernel, so the same
// branches) and stores a 14-word record per bounce in a global scratch
// buffer [max_bounces, REC_FIELDS, N]: the PCG state after the hit search,
// the ray, the throughput and the winner (kind, index, t, volume
// uniform).  It then sweeps the bounces in reverse, recomputes each
// bounce's intermediates from its record and propagates the adjoints of
// (origin, direction, throughput), then of the camera ray.  The block
// holds the scene tables, their invariants (tracer.cuh prepare_scene) and
// one gradient table per warp in shared memory.
//
// Reproducible sums: the TPU kernel adds each grid step's cotangents to
// revisited output blocks in grid order, so a step gives the same bits
// every run.  Here every sum has a fixed order too, whatever the order in
// which warps and blocks run: a warp adds its lanes' gradients to a table
// of its own (lanes in order, below); at the end the block folds its
// warps' tables in warp order into its own row of a [blocks, table]
// scratch in global memory, and a second kernel (megakernel_bwd_fold_kernel)
// folds the rows in a fixed tree.  No float atomic is left.
//
// What bounds it on this card, and what the design does about it (each
// measured; PERF.md):
//   * many lanes adding to one row: in a room most lanes of a warp hit the
//     same wall and sample the same light.  Each thread adds its bounce's
//     row gradients with plain stores into slots of its own in shared
//     memory; after the bounce the warp's lanes that hit the same row sum
//     each column in lane order (__match_any_sync), and one lane a column
//     adds the sum to the warp's table.  The light's entries stay in the
//     thread's slots over the whole pixel and are summed once a block, in
//     thread order; the camera's go through the row slot once a sample.
//   * occupancy: the adjoint keeps many values live.  At least 5 blocks of
//     128 threads an SM (96 registers, some spilled) hides more latency
//     than 166 registers at 3.  The warps' tables cost 3 tables more shared
//     memory than one; the camera's entries leaving the slots give 12
//     floats a thread back.
//   * the records: 56 bytes per bounce per pixel, written and read once,
//     coalesced; they cost about 3% of the kernel's time and stay in
//     global memory, where they leave shared memory to the slots.
//
// Built without nvcc (a plain C++ compiler), this file compiles the adjoint
// and the folds for the CPU and leaves out the kernels and their entry
// points; a test emulates the kernel's blocks there with the same folds.

#include "tracer.cuh"

#ifndef __CUDACC__
#include <string.h>
#endif

namespace tpt {

// Words of a bounce record: state, o3, d3, thr3, kind, idx, t, vol_u.
constexpr int REC_FIELDS = 14;

TPT_HD float bits_to_float(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
#endif
}

TPT_HD uint32_t float_to_bits(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(f);
#else
  uint32_t u;
  memcpy(&u, &f, sizeof u);
  return u;
#endif
}

// Column col of a gradient row whose columns lie stride floats apart.
TPT_HD void add_grad(float* g, int stride, int col, float v) {
  g[col * stride] += v;
}

TPT_HD void add_grad3(float* g, int stride, int col, V3 v) {
  add_grad(g, stride, col, v.x);
  add_grad(g, stride, col + 1, v.y);
  add_grad(g, stride, col + 2, v.z);
}

TPT_HD void acc3(V3& a, V3 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
}

// Adjoint of vecmath.normalize: y = x / sqrt(max(x.x, eps)).
TPT_HD V3 normalize_bwd(V3 x, V3 yb) {
  const float sq = dot3(x, x);
  const float r = 1.0f / sqrtf(fmaxf(sq, 1e-20f));
  if (sq < 1e-20f) return scale3(yb, r);
  const float k = r * r * r * dot3(x, yb);
  return v3(r * yb.x - k * x.x, r * yb.y - k * x.y, r * yb.z - k * x.z);
}

// Adjoint of reflect(x, n) = x - 2 (x.n) n.
TPT_HD void reflect_bwd(V3 x, V3 n, V3 rb, V3& xb, V3& nb) {
  const float rn = dot3(rb, n), k = dot3(x, n);
  acc3(xb, v3(rb.x - 2.0f * rn * n.x, rb.y - 2.0f * rn * n.y,
              rb.z - 2.0f * rn * n.z));
  acc3(nb, v3(-2.0f * (rn * x.x + k * rb.x), -2.0f * (rn * x.y + k * rb.y),
              -2.0f * (rn * x.z + k * rb.z)));
}

// Adjoint of normalize(onb_local(onb_from_w(win), l)) (vecmath.onb_from_w):
// w = normalize(win), v = normalize(w x a), u = w x v, out =
// normalize(u l0 + v l1 + w l2).  big picks the helper axis a.  Returns the
// adjoint of win; lb, if given, receives the adjoint of l.
TPT_HD V3 onb_dir_bwd(V3 win, bool big, float l0, float l1, float l2,
                      V3 outb, float* lb) {
  const V3 w = norm3(win);
  const V3 a = v3(big ? 0.0f : 1.0f, big ? 1.0f : 0.0f, 0.0f);
  const V3 c = cross3(w, a);
  const V3 vv = norm3(c);
  const V3 uu = cross3(w, vv);
  const V3 y = v3(uu.x * l0 + vv.x * l1 + w.x * l2,
                  uu.y * l0 + vv.y * l1 + w.y * l2,
                  uu.z * l0 + vv.z * l1 + w.z * l2);
  const V3 yb = normalize_bwd(y, outb);
  if (lb) {
    lb[0] = dot3(yb, uu);
    lb[1] = dot3(yb, vv);
    lb[2] = dot3(yb, w);
  }
  const V3 ub = scale3(yb, l0);
  V3 vb = scale3(yb, l1);
  V3 wb = scale3(yb, l2);
  acc3(wb, cross3(vv, ub));
  acc3(vb, cross3(ub, w));
  acc3(wb, cross3(a, normalize_bwd(c, vb)));
  return normalize_bwd(win, wb);
}

// Adjoint of one root (-half_b + sgn sqrt(disc)) / a of ray/sphere
// (intersect.sphere_roots) with respect to o, d, the center and radius.
TPT_HD void root_bwd(V3 o, V3 d, const float* Sr, float sgn, float tb, V3& ob,
                     V3& db, V3& cb, float& rb) {
  const V3 c = load3(Sr);
  const float R = Sr[3];
  const V3 oc = sub3(o, c);
  const float a = dot3(d, d), hb = dot3(d, oc), cc = dot3(oc, oc) - R * R;
  const float disc = hb * hb - a * cc;
  const float sq = safe_sqrt(disc);
  const float ia = 1.0f / a;
  float hbb = -tb * ia;
  const float sqb = sgn * tb * ia;
  const float iab = tb * (-hb + sgn * sq);
  float ab = -iab * ia * ia;
  V3 ocb = v3(0.0f, 0.0f, 0.0f);
  if (disc > 0.0f) {  // safe_sqrt passes no gradient at disc <= 0
    const float discb = sqb * 0.5f / sq;
    hbb += 2.0f * hb * discb;
    ab += -cc * discb;
    const float ccb = -a * discb;
    ocb = scale3(oc, 2.0f * ccb);
    rb += -2.0f * R * ccb;
  }
  acc3(db, add3(scale3(oc, hbb), scale3(d, 2.0f * ab)));
  acc3(ocb, scale3(d, hbb));
  acc3(ob, ocb);
  cb = sub3(cb, ocb);
}

// Adjoint of lights.quad_light_pdf on a lane whose direction ch reaches
// the light: pdf = t^2 |ch|^2 / max(|den| / max(|ch|, 1e-12) * |u x v|,
// 1e-12), t = (normal.q - normal.p) / den, den = normal.ch.  L is the
// plane prepare_scene derived from lq, lu, lv.
TPT_HD void light_pdf_bwd(V3 hp, V3 ch, V3 lq, V3 lu, V3 lv, const float* L,
                          float pdfb, V3& hpb, V3& chb, V3& lqb, V3& lub,
                          V3& lvb) {
  const V3 nr = load3(L + L_NR);
  const V3 ln = load3(L + L_LN);
  const float dpl = L[L_DPLANE];
  const float den = dot3(ln, ch);
  const float num = dpl - dot3(ln, hp);
  const float tl = num / den;
  const float q = dot3(ch, ch);
  const float ds = tl * tl * q;
  const float lc = sqrtf(fmaxf(q, 0.0f));
  const float lcc = fmaxf(lc, 1e-12f);
  const float cosv = fabsf(den) / lcc;
  const float area = L[L_AREA];
  const float ca = cosv * area;
  const float cc = fmaxf(ca, 1e-12f);
  const float dsb = pdfb / cc;
  const float ccb = -pdfb * ds / (cc * cc);
  float cosb = 0.0f, areab = 0.0f;
  if (ca >= 1e-12f) {
    cosb = ccb * area;
    areab = ccb * cosv;
  }
  const float tlb = dsb * 2.0f * tl * q;
  float qb = dsb * tl * tl;
  const float sgn_den = den > 0.0f ? 1.0f : (den < 0.0f ? -1.0f : 0.0f);
  float denb = cosb * sgn_den / lcc;
  const float lccb = -cosb * fabsf(den) / (lcc * lcc);
  if (lc >= 1e-12f) qb += lccb * 0.5f / lc;
  acc3(chb, scale3(ch, 2.0f * qb));
  V3 nrb = v3(0.0f, 0.0f, 0.0f);
  if (area > 0.0f) nrb = scale3(nr, 2.0f * (areab * 0.5f / area));
  const float numb = tlb / den;
  denb += -tlb * tl / den;
  V3 lnb = add3(scale3(hp, -numb), scale3(ch, denb));
  acc3(hpb, scale3(ln, -numb));
  acc3(chb, scale3(ln, denb));
  acc3(lnb, scale3(lq, numb));  // d(dpl) = numb
  acc3(lqb, scale3(ln, numb));
  acc3(nrb, normalize_bwd(nr, lnb));
  acc3(lub, cross3(lv, nrb));
  acc3(lvb, cross3(nrb, lu));
}

// Adjoints carried between bounces: of the ray and of the throughput.
struct Adj {
  V3 o, d;
  float thr[3];
};

// The adjoint of one bounce of the forward (tracer.cuh find_hit + shade +
// roulette).  On entry a holds the adjoints of the bounce's outputs (the
// next ray and the throughput after roulette; zero when the path ends in
// this bounce); on return, those of its inputs (o, d, thr).  g is the
// radiance cotangent of this sample.  The gradients of the winner's row go
// to grow, column c at grow[c * st], those of the light to glight.
TPT_HD void bounce_bwd(const Params& p, const Tables<const float>& S,
                       const Hit& h, V3 o, V3 d, const float thr[3],
                       uint32_t state_h, int bounce, const float g[3],
                       float* grow, float* glight, int st, Adj& a) {
  const V3 zero = v3(0.0f, 0.0f, 0.0f);
  if (h.kind == K_MISS) {
    // radiance += background * throughput.
    a.thr[0] = p.bg_r * g[0];
    a.thr[1] = p.bg_g * g[1];
    a.thr[2] = p.bg_b * g[2];
    a.o = zero;
    a.d = zero;
    return;
  }
  uint32_t state = state_h;
  Shade s;
  shade(p, S, h, o, d, thr, state, s);
  const float* mat = s.mat;
  const int mc = hit_mat_col(h);

  // ---- roulette: thr'' = thr' / max(amax(thr'), 1e-12) for a survivor.
  float tpb[3] = {a.thr[0], a.thr[1], a.thr[2]};
  if (s.live && bounce >= p.rr_start_bounce) {
    const float* tp = s.nthr;
    const float P = fmaxf(fmaxf(tp[0], tp[1]), tp[2]);
    const float pc = fmaxf(P, 1e-12f);
    const float dotv = a.thr[0] * tp[0] + a.thr[1] * tp[1] + a.thr[2] * tp[2];
    for (int k = 0; k < 3; ++k) tpb[k] = a.thr[k] / pc;
    if (P >= 1e-12f) {
      const float ties = (float)((tp[0] == P) + (tp[1] == P) + (tp[2] == P));
      const float pb = -dotv / (pc * pc) / ties;
      for (int k = 0; k < 3; ++k) {
        if (tp[k] == P) tpb[k] += pb;
      }
    }
  }

  // ---- ray and throughput update (a path that ends here has no
  // downstream adjoint).
  V3 pb = zero, ndb = zero;
  float nthrb[3] = {0.0f, 0.0f, 0.0f};
  if (s.live) {
    pb = a.o;
    ndb = a.d;
    for (int k = 0; k < 3; ++k) nthrb[k] = tpb[k];
  }
  float thrb[3] = {0.0f, 0.0f, 0.0f};
  float attb[3] = {0.0f, 0.0f, 0.0f};
  V3 nb = zero, ddb = zero, sdb = zero, db = zero, ob = zero;
  V3 lqb = zero, lub = zero, lvb = zero;
  float att[3];
  for (int k = 0; k < 3; ++k) att[k] = mixf(mat[k], mat[M_SPEC + k], s.dsf);

  if (s.use_mis) {
    // nthr = thr * lam_pdf * att / max(pdf, 1e-12), nd = chosen.
    const float pd = fmaxf(s.pdf, 1e-12f);
    float sum = 0.0f;
    for (int k = 0; k < 3; ++k) {
      sum += nthrb[k] * thr[k] * att[k];
      thrb[k] += nthrb[k] * s.lam_pdf * att[k] / pd;
      attb[k] += nthrb[k] * thr[k] * s.lam_pdf / pd;
    }
    float lamb = sum / pd;
    const float pdfb = (s.pdf >= 1e-12f) ? -sum * s.lam_pdf / (pd * pd) : 0.0f;
    lamb += (1.0f - p.p_light) * pdfb;
    const float lpdfb = p.p_light * pdfb;
    V3 chb = ndb;
    // lam_pdf = max(normalize(ch) . normalize(n) / pi, 0).
    const V3 cn = norm3(s.ch), nn = norm3(s.n);
    if (dot3(cn, nn) / PI_F >= 0.0f) {
      const float cb = lamb / PI_F;
      acc3(chb, normalize_bwd(s.ch, scale3(nn, cb)));
      acc3(nb, normalize_bwd(s.n, scale3(cn, cb)));
    }
    const V3 lq = load3(S.light), lu = load3(S.light + 3),
             lv = load3(S.light + 6);
    if (s.valid) light_pdf_bwd(s.hp, s.ch, lq, lu, lv, S.light_pre, lpdfb, pb,
                               chb, lqb, lub, lvb);
    if (s.u_mix > p.p_light) {
      acc3(ddb, chb);
    } else {
      // ld = normalize(lq + lr1 lu + lr2 lv - hp).
      const V3 x = v3(lq.x + s.lr1 * lu.x + s.lr2 * lv.x - s.hp.x,
                      lq.y + s.lr1 * lu.y + s.lr2 * lv.y - s.hp.y,
                      lq.z + s.lr1 * lu.z + s.lr2 * lv.z - s.hp.z);
      const V3 xb = normalize_bwd(x, chb);
      acc3(lqb, xb);
      acc3(lub, scale3(xb, s.lr1));
      acc3(lvb, scale3(xb, s.lr2));
      pb = sub3(pb, xb);
    }
  } else {
    for (int k = 0; k < 3; ++k) {
      thrb[k] += nthrb[k] * att[k];
      attb[k] += nthrb[k] * thr[k];
    }
    sdb = ndb;
  }
  add_grad3(glight, st, 0, lqb);
  add_grad3(glight, st, 3, lub);
  add_grad3(glight, st, 6, lvb);

  // ---- attenuation = mix(color, specular color, dsf).
  for (int k = 0; k < 3; ++k) {
    add_grad(grow, st, mc + k, attb[k] * (1.0f - s.dsf));
    add_grad(grow, st, mc + M_SPEC + k, attb[k] * s.dsf);
  }

  // ---- the sampled direction of the hit material.
  const float sstr = mat[M_SSTR], rough = mat[M_ROUGH], eta = mat[M_ETA],
              mtype = mat[M_TYPE];
  const V3 n = s.n;
  float roughb = 0.0f, etab = 0.0f, sstrb = 0.0f;
  if (mtype == LAMBERTIAN) {
    // sd = normalize(mix(dd, normalize(mix(reflect(d, n), dd, rough)),
    // dsf)).
    const V3 refl = reflect3(d, n);
    const V3 m1 = mix3(refl, s.dd, rough);
    const V3 sp = norm3(m1);
    const V3 m2 = mix3(s.dd, sp, s.dsf);
    const V3 m2b = normalize_bwd(m2, sdb);
    acc3(ddb, scale3(m2b, 1.0f - s.dsf));
    if (s.dsf > 0.0f) {
      const V3 m1b = normalize_bwd(m1, scale3(m2b, s.dsf));
      acc3(ddb, scale3(m1b, rough));
      roughb += dot3(m1b, sub3(s.dd, refl));
      reflect_bwd(d, n, scale3(m1b, 1.0f - rough), db, nb);
    }
  } else if (mtype == MIRROR) {
    // sd = normalize(reflect(d, n) + rough * fuzz).
    const V3 m = add3(reflect3(d, n), scale3(s.fz, rough));
    const V3 mb = normalize_bwd(m, sdb);
    roughb += dot3(mb, s.fz);
    reflect_bwd(d, n, mb, db, nb);
  } else if (mtype == GLASS) {
    const float ce = fmaxf(eta, 1e-8f);
    const float ir = s.front ? 1.0f / ce : eta;
    const V3 ud = norm3(d);
    V3 udb = zero;
    float irb = 0.0f;
    if (s.must_reflect) {
      const V3 gd = reflect3(ud, n);
      reflect_bwd(ud, n, normalize_bwd(gd, sdb), udb, nb);
    } else {
      // refract: rp = ir (u + ct n), ct = min(-u.n, 1),
      // gd = rp - safe_sqrt(1 - rp.rp) n.
      const float dn = dot3(v3(-ud.x, -ud.y, -ud.z), n);
      const float ct = fminf(dn, 1.0f);
      const V3 rp = scale3(add3(ud, scale3(n, ct)), ir);
      const float x = 1.0f - dot3(rp, rp);
      const float par = -safe_sqrt(x);
      const V3 gd = add3(rp, scale3(n, par));
      const V3 gb = normalize_bwd(gd, sdb);
      V3 rpb = gb;
      const float parb = dot3(gb, n);
      acc3(nb, scale3(gb, par));
      if (x > 0.0f) {
        const float xb = -parb * 0.5f / sqrtf(x);
        acc3(rpb, scale3(rp, -2.0f * xb));
      }
      irb = dot3(rpb, add3(ud, scale3(n, ct)));
      acc3(udb, scale3(rpb, ir));
      const float ctb = ir * dot3(rpb, n);
      acc3(nb, scale3(rpb, ir * ct));
      if (dn <= 1.0f) {
        acc3(udb, scale3(n, -ctb));
        acc3(nb, scale3(ud, -ctb));
      }
    }
    if (s.front) {
      if (eta >= 1e-8f) etab += -irb / (ce * ce);
    } else {
      etab += irb;
    }
    acc3(db, normalize_bwd(d, udb));
  } else {
    // ISOTROPIC: sd = normalize(onb(d) . (sin_hg cos, sin_hg sin, cos_hg)).
    const float gg = sstr;
    const bool small_g = fabsf(gg) < 1e-4f;
    const float safe_g = small_g ? 1.0f : gg;
    const float bden = 1.0f - gg + 2.0f * gg * s.u_hg;
    const float frac = (1.0f - gg * gg) / bden;
    const float hg_gen = (1.0f + gg * gg - frac * frac) / (2.0f * safe_g);
    const float xhg = small_g ? 1.0f - 2.0f * s.u_hg : hg_gen;
    const float cos_hg = clampf(xhg, -1.0f, 1.0f);
    const float yv = 1.0f - cos_hg * cos_hg;
    const float sin_hg = safe_sqrt(yv);
    const float hphi = TWO_PI * s.u_phi;
    const float ch = cosf(hphi), sh = sinf(hphi);
    const V3 wu = norm3(d);
    float lb[3];
    acc3(db, onb_dir_bwd(d, fabsf(wu.x) > 0.9f, sin_hg * ch, sin_hg * sh,
                         cos_hg, sdb, lb));
    const float shb = lb[0] * ch + lb[1] * sh;
    float chgb = lb[2];
    if (yv > 0.0f) chgb += -2.0f * cos_hg * (shb * 0.5f / sin_hg);
    if (!small_g && xhg >= -1.0f && xhg <= 1.0f) {
      const float dfr = (-2.0f * gg - frac * (2.0f * s.u_hg - 1.0f)) / bden;
      const float dgen =
          (2.0f * gg - 2.0f * frac * dfr) / (2.0f * gg) - hg_gen / gg;
      sstrb += chgb * dgen;
    }
  }

  // ---- the diffuse direction dd = normalize(onb(n) . cosine sample).
  if (ddb.x != 0.0f || ddb.y != 0.0f || ddb.z != 0.0f) {
    acc3(nb, onb_dir_bwd(n, fabsf(norm3(n).x) > 0.9f, s.lx, s.ly, s.lz, ddb,
                         nullptr));
  }

  // ---- front-face emission: radiance += emission * thr.
  if (s.front) {
    for (int k = 0; k < 3; ++k) {
      add_grad(grow, st, mc + M_EMI + k, thr[k] * g[k]);
      thrb[k] += mat[M_EMI + k] * g[k];
    }
  }
  add_grad(grow, st, mc + M_ROUGH, roughb);
  add_grad(grow, st, mc + M_ETA, etab);
  add_grad(grow, st, mc + M_SSTR, sstrb);

  // ---- shading normal of the winner (kernels/hit.py shade_hit).
  const V3 n0b = s.front ? nb : v3(-nb.x, -nb.y, -nb.z);
  const V3 hp = s.hp;
  const float* row = S.sph + hit_row_offset(p, h);
  // Adjoints of the winner's geometry columns: sphere or volume center
  // (geo0) and radius (geo_s); quad normal (geo1); triangle corner
  // normals (geo3-5).
  V3 geo0 = zero, geo1 = zero, geo3 = zero, geo4 = zero, geo5 = zero;
  float geo_s = 0.0f;
  if (h.kind == K_SPHERE) {
    // normalize((p - c) / r).
    const float R = row[3];
    const V3 pc = sub3(hp, load3(row));
    const V3 xb = normalize_bwd(v3(pc.x / R, pc.y / R, pc.z / R), n0b);
    acc3(pb, scale3(xb, 1.0f / R));
    geo0 = scale3(xb, -1.0f / R);
    geo_s += -dot3(xb, pc) / (R * R);
  } else if (h.kind == K_VOLUME) {
    // normalize(p - c).
    const V3 xb = normalize_bwd(sub3(hp, load3(row)), n0b);
    acc3(pb, xb);
    geo0 = scale3(xb, -1.0f);
  } else if (h.kind == K_QUAD) {
    geo1 = n0b;  // the stored normal
  }
  float tt = 0.0f, uu = 0.0f, vv = 0.0f, ww = 0.0f;
  if (h.kind == K_TRI) {
    triangle_test(p, S, h.idx, o, d, tt, uu, vv, ww);
    const V3 na = load3(row + 9), nbv = load3(row + 12),
             nc = load3(row + 15);
    const V3 x = v3(na.x * ww + nbv.x * uu + nc.x * vv,
                    na.y * ww + nbv.y * uu + nc.y * vv,
                    na.z * ww + nbv.z * uu + nc.z * vv);
    const V3 xb = normalize_bwd(x, n0b);
    geo3 = scale3(xb, ww);
    geo4 = scale3(xb, uu);
    geo5 = scale3(xb, vv);
    // Barycentric adjoints, with w = 1 - u - v folded in.
    const float bwb = dot3(xb, na), bub = dot3(xb, nbv), bvb = dot3(xb, nc);
    uu = bub - bwb;  // reuse as the adjoints of u and v
    vv = bvb - bwb;
  }

  // ---- p = o + t d.
  acc3(ob, pb);
  acc3(db, scale3(pb, h.t));
  const float tb = dot3(pb, d);

  if (h.kind == K_SPHERE) {
    float r0, r1, disc;
    sphere_roots(o, d, row, r0, r1, disc);
    const bool near_ok = (r0 > p.t_min) && (r0 < p.t_max);
    root_bwd(o, d, row, near_ok ? -1.0f : 1.0f, tb, ob, db, geo0, geo_s);
    add_grad3(grow, st, 0, geo0);
    add_grad(grow, st, 3, geo_s);
  } else if (h.kind == K_VOLUME) {
    // t = max(max(r0, t_min), 0) + nid log(max(u, 1e-12)) / |d|.
    float r0, r1, disc;
    sphere_roots(o, d, row, r0, r1, disc);
    const float q = dot3(d, d);
    const float len = sqrtf(fmaxf(q, 0.0f));
    const float lg = logf(fmaxf(h.vol_u, 1e-12f));
    const float hd = row[SPH_MAT + M_ROUGH] * lg;
    add_grad(grow, st, mc + M_ROUGH, tb / len * lg);
    if (len > 0.0f) acc3(db, scale3(d, -tb * hd / (len * len) / len));
    if (r0 >= p.t_min) root_bwd(o, d, row, -1.0f, tb, ob, db, geo0, geo_s);
    add_grad3(grow, st, 0, geo0);
    add_grad(grow, st, 3, geo_s);
  } else if (h.kind == K_QUAD) {
    // t = (d_plane - n.o) / (n.d) with the stored plane columns.
    const V3 nq = load3(row + 9);
    const float den = dot3(nq, d);
    const float num = row[12] - dot3(nq, o);
    const float tq = num / den;
    const float numb = tb / den;
    const float denb = -tb * tq / den;
    acc3(geo1, add3(scale3(o, -numb), scale3(d, denb)));
    acc3(ob, scale3(nq, -numb));
    acc3(db, scale3(nq, denb));
    add_grad3(grow, st, 9, geo1);
    add_grad(grow, st, 12, numb);
  } else {
    // Möller-Trumbore (intersect.triangle_t): t, u, v all carry gradient.
    const V3 A = load3(row);
    const float* E = S.tri_pre + h.idx * TRI_PRE;  // b - a, c - a, ab x ac
    const V3 ab = load3(E), ac = load3(E + 3), nt = load3(E + 6);
    const float det = -dot3(d, nt);
    const V3 ao = sub3(o, A);
    const V3 dao = cross3(ao, d);
    const float inv = 1.0f / det;
    const float ub = uu, vb = vv;
    const float invb = tb * dot3(ao, nt) + ub * dot3(ac, dao) -
                       vb * dot3(ab, dao);
    V3 aob = scale3(nt, tb * inv);
    V3 ntb = scale3(ao, tb * inv);
    V3 acb = scale3(dao, ub * inv);
    V3 daob = add3(scale3(ac, ub * inv), scale3(ab, -vb * inv));
    V3 abb = scale3(dao, -vb * inv);
    const float detb = -invb * inv * inv;
    acc3(db, scale3(nt, -detb));
    acc3(ntb, scale3(d, -detb));
    acc3(aob, cross3(d, daob));
    acc3(db, cross3(daob, ao));
    acc3(abb, cross3(ac, ntb));
    acc3(acb, cross3(ntb, ab));
    acc3(ob, aob);
    add_grad3(grow, st, 0, v3(-aob.x - abb.x - acb.x, -aob.y - abb.y - acb.y,
                              -aob.z - abb.z - acb.z));
    add_grad3(grow, st, 3, abb);
    add_grad3(grow, st, 6, acb);
    add_grad3(grow, st, 9, geo3);
    add_grad3(grow, st, 12, geo4);
    add_grad3(grow, st, 15, geo5);
  }
  a.o = ob;
  a.d = db;
  for (int k = 0; k < 3; ++k) a.thr[k] = thrb[k];
}

TPT_HD void store_record(float* rec, int b, int n, int i, uint32_t state,
                         V3 o, V3 d, const float thr[3], const Hit& h) {
  float* r = rec + (size_t)b * REC_FIELDS * n + i;
  const float f[REC_FIELDS] = {bits_to_float(state), o.x, o.y, o.z, d.x, d.y,
                               d.z, thr[0], thr[1], thr[2],
                               bits_to_float((uint32_t)h.kind),
                               bits_to_float((uint32_t)h.idx), h.t, h.vol_u};
  for (int k = 0; k < REC_FIELDS; ++k) r[(size_t)k * n] = f[k];
}

TPT_HD void load_record(const float* rec, int b, int n, int i,
                        uint32_t& state, V3& o, V3& d, float thr[3], Hit& h) {
  const float* r = rec + (size_t)b * REC_FIELDS * n + i;
  float f[REC_FIELDS];
  for (int k = 0; k < REC_FIELDS; ++k) f[k] = r[(size_t)k * n];
  state = float_to_bits(f[0]);
  o = v3(f[1], f[2], f[3]);
  d = v3(f[4], f[5], f[6]);
  thr[0] = f[7];
  thr[1] = f[8];
  thr[2] = f[9];
  h.kind = (int)float_to_bits(f[10]);
  h.idx = (int)float_to_bits(f[11]);
  h.t = f[12];
  h.vol_u = f[13];
}

// Camera gradient entries: the view matrix's first three rows.
constexpr int CAM_GRADS = 12;

// Offset of the camera's entries in the tables (after the light's).
TPT_HD int cam_offset(const Params& p) { return table_floats(p) - CAM_COLS; }

// The backward kernel's block of BWD_WARPS warps, and the slots each of its
// threads has in shared memory: the widest row (which takes the camera's
// entries at the end of a sample) and the light.
constexpr int WARP = 32;
constexpr int BWD_THREADS = 128;
constexpr int BWD_WARPS = BWD_THREADS / WARP;
constexpr int SLOT_FLOATS = TRI_COLS + LIGHT_COLS;
static_assert(TRI_COLS <= WARP && QUAD_COLS <= WARP && SPH_COLS <= WARP,
              "flush_rows gives each column of a row one lane of the warp");
static_assert(CAM_GRADS <= TRI_COLS, "the camera's entries use the row slot");

// Dynamic shared memory of the backward kernel's block: the scene (tables
// and invariants), one gradient table per warp and the threads' slots at a
// stride of the block's size plus one.  The wrapper's check
// (kernels/megakernel.py bwd_smem_bytes) counts the same, and a test built
// for the CPU holds the two together.
TPT_HD size_t bwd_smem_bytes(const Params& p) {
  return sizeof(float) *
         ((size_t)scene_floats(p) + (size_t)BWD_WARPS * table_floats(p) +
          (size_t)SLOT_FLOATS * (BWD_THREADS + 1));
}

// The block's shared memory, in this order.  Slot entry k of thread t lies
// at slots[k * (nt + 1) + t]: the odd stride puts the entries flush_rows
// reads at once (lanes on columns) in distinct banks.
struct BwdBlock {
  float* scene;  // scene_floats: the tables, then their invariants
  float* warps;  // BWD_WARPS gradient tables of table_floats each
  float* slots;  // SLOT_FLOATS entries a thread
};

TPT_HD BwdBlock bwd_block(float* smem, const Params& p) {
  BwdBlock b;
  b.scene = smem;
  b.warps = smem + scene_floats(p);
  b.slots = b.warps + BWD_WARPS * table_floats(p);
  return b;
}

// Warp w's gradient table: no two warps add to one float, so each table's
// sums come in the warp's own order.
TPT_HD float* warp_table(const BwdBlock& b, const Params& p, int w) {
  return b.warps + w * table_floats(p);
}

// Thread t's part of a block's set-up: the tables, zeroed gradient tables
// and zeroed slots.  The invariants follow once every thread has done it.
TPT_HD void init_block(const BwdBlock& b, const Params& p,
                       const float* tables, int nt, int t) {
  const int n = table_floats(p);
  for (int k = t; k < n; k += nt) b.scene[k] = tables[k];
  for (int k = t; k < BWD_WARPS * n; k += nt) b.warps[k] = 0.0f;
  for (int k = 0; k < SLOT_FLOATS; ++k) b.slots[k * (nt + 1) + t] = 0.0f;
}

// Where one thread's table gradients go.  Built by a plain C++ compiler
// (row == nullptr, stride 1) they go straight to the gradient tables G: the
// winner's row of G, G.light and G.cam.  The kernel gives each thread slots
// of its own in shared memory, entry k at [k * stride]: the winner row's
// columns, summed over the warp after each bounce (flush_rows), the
// camera's in the same slot after each sample, and the light's, summed
// over the block at the end.  Either way one thread adds with a plain +=.
struct Sink {
  float* row;    // the winner row's slot; nullptr: the winner's row of G
  float* light;  // LIGHT_COLS entries
  float* cam;    // CAM_GRADS entries
  int stride;
};

// Thread t's slots in a block of nt threads.
TPT_HD Sink thread_sink(const BwdBlock& b, int nt, int t) {
  Sink s;
  s.stride = nt + 1;
  s.row = b.slots + t;
  s.light = b.slots + TRI_COLS * s.stride + t;
  s.cam = s.row;
  return s;
}

// The lowest set bit of a lane mask, as a lane.
TPT_HD int lowest_lane(unsigned m) {
#ifdef __CUDA_ARCH__
  return __ffs(m) - 1;
#else
  return __builtin_ffs((int)m) - 1;
#endif
}

// Adds the row slots of a warp's lanes to the warp's gradient table and
// zeroes them.  Lane j's slot holds column c at slots[c * stride + j]; its
// key is its row's offset in the tables (-1: none) and cols the row's
// width.  The lanes whose keys are equal form a group; groups go in the
// order of their lowest lanes, and in a group lane c sums column c over the
// members in lane order and adds the sum to the table.  So every sum has
// one order, and the lanes of a group's pass add to different columns.
// W holds the warp's primitives (CudaWarp on the card, LaneWarp on the
// host); lane is the calling lane, and every lane of the warp calls it.
template <class W>
TPT_HD void flush_rows(const W& w, int lane, float* slots, int stride,
                       float* table) {
  unsigned leaders = w.leaders();
  while (leaders) {
    const int l = lowest_lane(leaders);
    leaders &= leaders - 1;
    const int gkey = w.key_of(l);
    const unsigned members = w.group_of(l);
    const int gcols = w.cols_of(l);
    if (lane < gcols) {
      float sum = 0.0f;
      for (unsigned m = members; m; m &= m - 1) {
        float* e = slots + lane * stride + lowest_lane(m);
        sum += *e;
        *e = 0.0f;
      }
      table[gkey + lane] += sum;
    }
  }
}

#ifdef __CUDA_ARCH__
// The warp primitives flush_rows uses, for the calling lane's key and
// width: its group (the lanes with its key), the groups' lowest lanes, and
// another lane's values.
struct CudaWarp {
  static constexpr unsigned FULL = 0xffffffffu;
  int key, cols;
  unsigned group, lead;
  __device__ CudaWarp(int k, int c) : key(k), cols(c) {
    group = __match_any_sync(FULL, k);
    lead = __ballot_sync(
        FULL, k >= 0 && (int)(threadIdx.x & 31) == __ffs(group) - 1);
  }
  __device__ unsigned leaders() const { return lead; }
  __device__ int key_of(int l) const { return __shfl_sync(FULL, key, l); }
  __device__ int cols_of(int l) const { return __shfl_sync(FULL, cols, l); }
  __device__ unsigned group_of(int l) const {
    return __shfl_sync(FULL, group, l);
  }
};
#endif

#ifdef __CUDACC__
// The kernel's flush after each bounce and sample: the warp's lanes hand
// their keys and widths to flush_rows, adding to the warp's table.
struct WarpFlush {
  float* slots;  // the slots of the warp's lane 0
  int stride;
  float* table;
  TPT_HD void operator()(int key, int cols) const {
#ifdef __CUDA_ARCH__
    __syncwarp();
    flush_rows(CudaWarp(key, cols), (int)(threadIdx.x & 31), slots, stride,
               table);
    __syncwarp();
#endif
  }
};
#else
// The host's stand-in for the warp primitives: all 32 lanes' keys and
// widths at once, so each lane's flush_rows can run on its own.  Lanes
// write disjoint floats in a flush, so the lanes may run in any order.
struct LaneWarp {
  const int* key;   // [WARP]
  const int* cols;  // [WARP]
  unsigned group_of(int l) const {  // __match_any_sync
    unsigned g = 0;
    for (int j = 0; j < WARP; ++j) g |= (key[j] == key[l]) ? 1u << j : 0u;
    return g;
  }
  unsigned leaders() const {  // __ballot_sync
    unsigned m = 0;
    for (int j = 0; j < WARP; ++j) {
      m |= (key[j] >= 0 && j == lowest_lane(group_of(j))) ? 1u << j : 0u;
    }
    return m;
  }
  int key_of(int l) const { return key[l]; }  // __shfl_sync
  int cols_of(int l) const { return cols[l]; }
};
#endif

// No flush: a plain C++ build's Sink adds straight to G.
struct NoFlush {
  TPT_HD void operator()(int, int) const {}
};

// Entry k of a block's table gradients: the warps' tables in warp order,
// then for the light's entries the threads' slots in thread order.
TPT_HD float fold_block_entry(const BwdBlock& b, const Params& p, int nt,
                              int k) {
  const int n = table_floats(p);
  float v = 0.0f;
  for (int w = 0; w < BWD_WARPS; ++w) v += b.warps[w * n + k];
  const int e = k - (cam_offset(p) - LIGHT_COLS);
  if (e >= 0 && e < LIGHT_COLS) {
    const float* src = b.slots + (TRI_COLS + e) * (nt + 1);
    for (int j = 0; j < nt; ++j) v += src[j];
  }
  return v;
}

// Thread t's part of a block's end: its entries of the block's row
// rows[block] of the [blocks, table_floats] scratch.
TPT_HD void store_block(const BwdBlock& b, const Params& p, int nt, int t,
                        int block, float* rows) {
  const int n = table_floats(p);
  for (int k = t; k < n; k += nt) {
    rows[(size_t)block * n + k] = fold_block_entry(b, p, nt, k);
  }
}

// The fold of the blocks' rows (megakernel_bwd_fold_kernel): column col of
// a [blocks, n] scratch is summed in FOLD_PARTS parts, part j over rows j,
// j + FOLD_PARTS, ... in order, then the parts in order.  A fold block
// takes FOLD_COLS columns.
constexpr int FOLD_COLS = 32;
constexpr int FOLD_PARTS = 32;

TPT_HD float fold_part(const float* rows, int blocks, int n, int col,
                       int part) {
  float s = 0.0f;
#ifdef __CUDA_ARCH__
#pragma unroll 8
#endif
  for (int r = part; r < blocks; r += FOLD_PARTS) {
    s += rows[(size_t)r * n + col];
  }
  return s;
}

TPT_HD float fold_parts(const float* parts, int stride) {
  float s = 0.0f;
  for (int j = 0; j < FOLD_PARTS; ++j) s += parts[j * stride];
  return s;
}

// The backward trace of pixel i: replays each sample's forward into the
// records, then sweeps them in reverse.  gout is the pixel's radiance
// cotangent; table gradients go to sink (and G).  flush(key, cols) follows
// each bounce of the sweep and each sample's camera entries: the row slot's
// offset in the tables (-1: nothing there) and width.  The reverse sweep
// runs max_bounces steps on every lane, live (i < p.n) or not, so the
// kernel's warps meet in step at each flush.
template <class Flush>
TPT_HD void trace_pixel_bwd(const Params& p, const Tables<const float>& S,
                            const Tables<float>& G, const Sink& sink,
                            bool live, uint32_t state, float pxf, float pyf,
                            const float gout[3], float* rec, int i,
                            const Flush& flush) {
  const V3 eye = v3(S.cam[3], S.cam[7], S.cam[11]);
  const int dpb = draws_per_bounce(p);
  const int st = sink.stride;
  const float g[3] = {gout[0] * p.inv_spp, gout[1] * p.inv_spp,
                      gout[2] * p.inv_spp};
  for (int smp = 0; smp < p.spp; ++smp) {
    float cs = 0.0f, ct = 0.0f;
    V3 x = v3(0.0f, 0.0f, 0.0f);
    int n_rec = 0;
    if (live) {
      camera_ray(p, S.cam, smp, state, pxf, pyf, cs, ct, x);
      V3 d = norm3(x);
      V3 o = eye;
      float thr[3] = {1.0f, 1.0f, 1.0f};
      for (int bounce = 0; bounce < p.max_bounces; ++bounce) {
        const uint32_t later_draws =
            (uint32_t)(p.max_bounces - bounce - 1) * (uint32_t)dpb;
        const Hit h = find_hit(p, S, o, d, state);
        store_record(rec, bounce, p.n, i, state, o, d, thr, h);
        n_rec = bounce + 1;
        if (h.kind == K_MISS) {
          state = pcg_skip(state, (uint32_t)tail_draws(p) + later_draws);
          break;
        }
        Shade s;
        shade(p, S, h, o, d, thr, state, s);
        bool alive = s.live;
        if (alive) {
          for (int k = 0; k < 3; ++k) thr[k] = s.nthr[k];
          o = s.hp;
          d = s.nd;
          alive = roulette(p, bounce, s.u_rr, thr);
        }
        if (!alive) {
          state = pcg_skip(state, later_draws);
          break;
        }
      }
    }

    Adj a;
    a.o = v3(0.0f, 0.0f, 0.0f);
    a.d = a.o;
    a.thr[0] = a.thr[1] = a.thr[2] = 0.0f;
    for (int b = p.max_bounces - 1; b >= 0; --b) {
      int key = -1, cols = 0;
      if (b < n_rec) {
        uint32_t sh;
        V3 ob, db;
        float tb[3];
        Hit h;
        load_record(rec, b, p.n, i, sh, ob, db, tb, h);
        float* grow = sink.row ? sink.row : G.sph + hit_row_offset(p, h);
        bounce_bwd(p, S, h, ob, db, tb, sh, b, g, grow, sink.light, st, a);
        if (h.kind != K_MISS) {
          key = hit_row_offset(p, h);
          cols = hit_cols(h);
        }
      }
      flush(key, cols);
    }

    if (live) {
      // Camera ray: o = eye, d = normalize(s B0 + t B1 - f B2).
      const V3 xb = normalize_bwd(x, a.d);
      const float xbs[3] = {xb.x, xb.y, xb.z};
      const float obs[3] = {a.o.x, a.o.y, a.o.z};
      for (int r = 0; r < 3; ++r) {
        add_grad(sink.cam, st, 4 * r + 0, cs * xbs[r]);
        add_grad(sink.cam, st, 4 * r + 1, ct * xbs[r]);
        add_grad(sink.cam, st, 4 * r + 2, -p.fov_factor * xbs[r]);
        add_grad(sink.cam, st, 4 * r + 3, obs[r]);
      }
    }
    flush(live ? cam_offset(p) : -1, CAM_GRADS);
  }
}

// The same with no flush, for a Sink that adds straight to G.
TPT_HD void trace_pixel_bwd(const Params& p, const Tables<const float>& S,
                            const Tables<float>& G, const Sink& sink,
                            bool live, uint32_t state, float pxf, float pyf,
                            const float gout[3], float* rec, int i) {
  trace_pixel_bwd(p, S, G, sink, live, state, pxf, pyf, gout, rec, i,
                  NoFlush());
}

}  // namespace tpt

#ifdef __CUDACC__

namespace {

using namespace tpt;

// At least 5 blocks an SM: 96 registers, and ptxas spills some of the
// adjoint's state; measured faster than 166 registers at 3 blocks, 128 at
// 4 or 80 at 6 (PERF.md).
__global__ void __launch_bounds__(BWD_THREADS, 5)
megakernel_bwd_kernel(const float* __restrict__ tables,
                      const int* __restrict__ state_in,
                      const int* __restrict__ px_in,
                      const int* __restrict__ py_in,
                      const float* __restrict__ gout,
                      float* __restrict__ rec, float* __restrict__ rows,
                      Params p) {
  extern __shared__ float smem[];
  const BwdBlock blk = bwd_block(smem, p);
  const int nt = blockDim.x, tid = threadIdx.x;
  init_block(blk, p, tables, nt, tid);
  __syncthreads();
  for (int k = tid; k < scene_invariants(p); k += nt) {
    prepare_scene(p, blk.scene, k);
  }
  __syncthreads();
  const Tables<const float> S = tables_at<const float>(blk.scene, p);
  float* table = warp_table(blk, p, tid / WARP);
  const Sink sink = thread_sink(blk, nt, tid);
  const WarpFlush flush = {blk.slots + (tid & ~(WARP - 1)), sink.stride,
                           table};

  const int i = blockIdx.x * nt + tid;
  const bool live = i < p.n;
  float g[3] = {0.0f, 0.0f, 0.0f};
  uint32_t state = 0u;
  float pxf = 0.0f, pyf = 0.0f;
  if (live) {
    for (int k = 0; k < 3; ++k) g[k] = gout[3 * i + k];
    state = (uint32_t)state_in[i];
    pxf = (float)px_in[i];
    pyf = (float)py_in[i];
  }
  trace_pixel_bwd(p, S, tables_at<float>(table, p), sink, live, state, pxf,
                  pyf, g, rec, i, flush);
  __syncthreads();
  store_block(blk, p, nt, tid, blockIdx.x, rows);
}

// Sums the backward's block rows [blocks, n] into grad [n], FOLD_COLS
// columns a block, each in FOLD_PARTS parts (fold_part, fold_parts): the
// same tree whatever the order of the blocks.  Memory-bound: it reads the
// rows once, 128 bytes a warp per row.
__global__ void __launch_bounds__(FOLD_COLS * FOLD_PARTS)
megakernel_bwd_fold_kernel(const float* __restrict__ rows, int blocks, int n,
                           float* __restrict__ grad) {
  __shared__ float parts[FOLD_PARTS * FOLD_COLS];
  const int c = threadIdx.x % FOLD_COLS, j = threadIdx.x / FOLD_COLS;
  const int col = blockIdx.x * FOLD_COLS + c;
  parts[j * FOLD_COLS + c] =
      col < n ? fold_part(rows, blocks, n, col, j) : 0.0f;
  __syncthreads();
  if (j == 0 && col < n) grad[col] = fold_parts(parts + c, FOLD_COLS);
}

}  // namespace

// C entry points, bound with ctypes (kernels/megakernel.py).  Each returns
// cudaGetLastError() of its launch.
//
// tpt_megakernel_bwd: ``tables`` is the flat table buffer of the forward;
// ``gout`` the radiance cotangent [n, 3]; ``rec`` scratch of max_bounces *
// REC_FIELDS * n floats; ``rows`` scratch of [ceil(n / BWD_THREADS),
// table_floats] floats, each block's table gradients, which the kernel
// writes in full.
extern "C" int tpt_megakernel_bwd(
    const float* tables, int n_sph, int n_quad, int n_tri,
    const int* state, const int* px, const int* py, const float* gout,
    float* rec, float* rows, int n, int spp, int max_bounces, int grid_n,
    int use_nee, int has_volumes, int rr_start_bounce, float t_min,
    float t_max, float inf, float p_light, float bg_r, float bg_g,
    float bg_b, float aspect, float fov_factor, float w, float h,
    float sub_scale, float inv_spp, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const Params p = {n_sph,   n_quad,     n_tri,   n,       spp,
                    max_bounces, grid_n, use_nee, has_volumes,
                    rr_start_bounce,     t_min,   t_max,   inf,
                    p_light, bg_r,       bg_g,    bg_b,    aspect,
                    fov_factor,          w,       h,       sub_scale,
                    inv_spp};
  const size_t smem_bytes = bwd_smem_bytes(p);
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        megakernel_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n + BWD_THREADS - 1) / BWD_THREADS;
  megakernel_bwd_kernel<<<blocks, BWD_THREADS, smem_bytes,
                          (cudaStream_t)stream>>>(tables, state, px, py, gout,
                                                  rec, rows, p);
  return (int)cudaGetLastError();
}

// tpt_megakernel_bwd_fold: ``rows`` [blocks, n] as tpt_megakernel_bwd
// wrote them; ``grad`` [n] receives their sum.
extern "C" int tpt_megakernel_bwd_fold(const float* rows, int blocks, int n,
                                       float* grad, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int grid = (n + FOLD_COLS - 1) / FOLD_COLS;
  megakernel_bwd_fold_kernel<<<grid, FOLD_COLS * FOLD_PARTS, 0,
                               (cudaStream_t)stream>>>(rows, blocks, n, grad);
  return (int)cudaGetLastError();
}

// tpt_megakernel_bwd_blocks_per_sm: the backward kernel's blocks an SM
// holds for a scene of these counts (its registers and shared memory), or
// -1 if the runtime refuses to say.
extern "C" int tpt_megakernel_bwd_blocks_per_sm(int n_sph, int n_quad,
                                                int n_tri) {
  Params p = {};
  p.n_sph = n_sph;
  p.n_quad = n_quad;
  p.n_tri = n_tri;
  const size_t smem_bytes = bwd_smem_bytes(p);
  if (smem_bytes > 48 * 1024 &&
      cudaFuncSetAttribute(megakernel_bwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_bytes) != cudaSuccess) {
    return -1;
  }
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, megakernel_bwd_kernel, BWD_THREADS, smem_bytes) !=
      cudaSuccess) {
    return -1;
  }
  return blocks;
}

#endif  // __CUDACC__
